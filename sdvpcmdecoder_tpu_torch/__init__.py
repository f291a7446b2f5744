"""sdvpcmdecoder_tpu_torch — the PyTorch/CUDA port of sdvpcmdecoder_tpu.

The JAX package `sdvpcmdecoder_tpu` is the reference; this package mirrors
its layout and function names so each counterpart is easy to find, and
imports torch and numpy, never JAX.

Layer map:
  formats/   - bit layouts, CRC, GF(2) algebra, sample expansion
  ops/       - binarizer trial grid (plain torch + hand-written CUDA
               kernel), deinterleave + P/Q erasure correction, the seam
               sweep and the steady round, the native stitcher core's
               loader (g++ on first use), host AGC and marker search
  pipeline/  - the STC-007 decode chain, the host stitcher, V2D, the
               chip-resident driver (DeviceBatchDecoder), ingest, audio
               masking, WAV writer
  utils/     - stats, checkpoints, the numpy-in/numpy-out adapter
  synth/     - synthetic STC-007 encoder (numpy) for conformance checks
  csrc/      - CUDA C++ sources, built with nvcc on first use

Device selection is explicit: every function runs on the device of the
tensors it is given. On a CPU tensor a kernel wrapper runs the kernel's
plain torch version; on a CUDA tensor it launches the kernel or raises.
"""

__version__ = "0.1.0"
