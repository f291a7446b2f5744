"""The benchmark of sdvpcmdecoder_tpu_torch (the PyTorch/CUDA port).

`python bench_port/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of BENCHMARK.json once on one CUDA card and
prints one JSON line. Everything that defines the yardstick lives here:
the capture generators, the plain reference decoders, the comparison
that decides `correct`, the metric arithmetic and the trace reduction.
The program is imported only to be driven.
"""
