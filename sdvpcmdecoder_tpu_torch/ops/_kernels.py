"""Build and load the hand-written CUDA kernels of `csrc/`.

Each source is compiled on first use with nvcc into a shared library with
a plain C interface (no PyTorch headers, so a build takes seconds), under
`build/kernels/` at the checkout root, and loaded with ctypes. The library
name carries a hash of the source and flags, so an edited source is
rebuilt. A failed build raises. Nothing here runs at import time: a
machine without nvcc imports this module and never calls `load`.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import NamedTuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Serialises builds and loads: threads of one process (the shards of
# parallel/multichip.py) share a pid, so an unserialised second build
# would write the first one's temporary file.
_LOCK = threading.RLock()
_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_OUTS = [_P] * 6   # words, crc_read, crc_calc, valid, hyst, shift
# C signatures: library -> function -> (restype, argtypes).
SIGNATURES = {
    "stc007_binarize": {
        # pixels; coords, coords64, cs0, cs1; (level, sf, sl) x 3;
        # synd_rows, synd_const, crc_const; F, L, W, n_h, n_s, tile;
        # outputs; stream.
        "stc007_binarize_frames": (_I, [_P, _P, _I, _L, _L, _P, _L, _L,
                                        _P, _L, _L, _P, _L, _L, _P, _I, _I,
                                        _I, _I, _I, _I, _I, _I, *_OUTS,
                                        _P]),
        # pixels; start, stop; (level, sl) x 3; synd_rows, synd_const,
        # crc_const; L, W, n_h, n_s, tile; outputs; stream.
        "stc007_binarize_group": (_I, [_P, _I, _I, _P, _L, _P, _L, _P, _L,
                                       _P, _I, _I, _I, _I, _I, _I, _I,
                                       *_OUTS, _P]),
        "stc007_error_string": (ctypes.c_char_p, [_I]),
    },
}


class Build(NamedTuple):
    path: Path
    seconds: float   # compile time; 0.0 when an existing library was reused
    log: str         # nvcc output (register and shared-memory use per kernel)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME:
        nvcc = Path(CUDA_HOME) / "bin" / "nvcc"
        if nvcc.exists():
            return str(nvcc)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


@functools.lru_cache(maxsize=None)
def build(name: str) -> Build:
    """Compile csrc/<name>.cu into build/kernels/ (once per source hash)."""
    with _LOCK:
        return _build(name)


def _build(name: str) -> Build:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"lib{name}-{digest}.so"
    if out.exists():
        return Build(out, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}) for {src}:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return Build(out, seconds, proc.stdout + proc.stderr)


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The built library of csrc/<name>.cu with its C signatures declared."""
    with _LOCK:
        lib = ctypes.CDLL(str(build(name).path))
        for fn, (restype, argtypes) in SIGNATURES[name].items():
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
        return lib
