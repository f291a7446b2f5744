"""ctypes bridge to the native stitcher core (native/stitchcore.cpp).

Port of sdvpcmdecoder_tpu/ops/stitch_native.py: the same C functions with
the same Python signatures and constants, and a loader that imports
nothing of the JAX package.

The host stitcher evaluates the block-correction decision tree thousands
of times per frame (every padding trial of every seam, findPadding
stc007datastitcher.cpp:1743); the numpy expression of that tree costs
~10us/block in vector-op dispatch, the native core ~100ns/block.  The
numpy/torch path (ops/deinterleave.py) remains the reference
implementation; tests assert bit-identity.  Set SDV_NO_NATIVE=1 to
disable.

The core is the port's own native/stitchcore.cpp (beside native/
loader.cpp, which pipeline/ingest.py builds through `build`), copied from
sdvpcmdecoder_tpu/native/ and edited only in the port from then on;
nothing is read from the JAX package.  The sources are compiled where
they lie and never written to.  The library goes to build/native/ at the
checkout root under a name that carries a hash of the source, the
compiler flags and the host CPU (the flags include -march=native), so an
edited source is rebuilt and a library built for another machine is
never loaded.  A failed build raises: there is no stale-library fallback.

GF(2) tables are pushed from formats/gf2.py at load time (one source of
truth for the Q-code matrices, stc007deinterleaver.cpp:4-75).
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import platform
import subprocess
import threading
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np

from ..formats import gf2

NATIVE_SRC = Path(__file__).resolve().parent.parent / "native"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX = "g++"
# The core is integer-only, so -march=native is bit-safe.  Each step of
# the chain drops one flag the compiler may refuse: -march, then -fopenmp
# (the pragmas are no-ops without it).
FLAG_CHAIN = (("-O3", "-march=native", "-fopenmp"), ("-O3", "-fopenmp"),
              ("-O3",))

_LIB = None
_LOAD_LOCK = threading.Lock()


class Build(NamedTuple):
    path: Path
    seconds: float      # compile time; 0.0 when an existing library was reused
    flags: tuple        # the flags of the chain that compiled it; () if reused


def _host_tag() -> str:
    """The CPU a -march=native library is built for: its architecture
    and feature flags."""
    try:
        with open("/proc/cpuinfo") as fh:
            flags = next((ln for ln in fh if ln.startswith("flags")), "")
    except OSError:
        flags = ""
    return platform.machine() + " " + flags


def build(source: str, flag_chain=FLAG_CHAIN, libs=()) -> Build:
    """Compile the port's native/<source> with g++ into build/native/
    (once per digest; concurrent processes wait on one lock).  Raises when
    every flag set of the chain fails."""
    src = NATIVE_SRC / source
    digest = hashlib.sha256(
        src.read_bytes() + repr((CXX, flag_chain, libs)).encode()
        + _host_tag().encode()).hexdigest()[:16]
    out = BUILD_DIR / f"lib{src.stem}-{digest}.so"
    if out.exists():
        return Build(out, 0.0, ())
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():
            return Build(out, 0.0, ())
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        errors = []
        t0 = time.perf_counter()
        for flags in flag_chain:
            proc = subprocess.run(
                [CXX, *flags, "-shared", "-fPIC", "-o", str(tmp), str(src),
                 *libs], capture_output=True, text=True)
            if proc.returncode == 0:
                os.replace(tmp, out)
                return Build(out, time.perf_counter() - t0, tuple(flags))
            errors.append(f"{' '.join(flags)}: {proc.stderr[-2000:]}")
        raise RuntimeError(f"{CXX} failed to build {src}:\n"
                           + "\n".join(errors))


def _as_u8(a):
    """Bool/uint8 array as contiguous uint8 without copying when the
    input is already a contiguous bool/uint8 buffer (ctypes hot path)."""
    if isinstance(a, np.ndarray) and a.flags.c_contiguous \
            and a.dtype in (np.bool_, np.uint8):
        return a.view(np.uint8)
    return np.ascontiguousarray(a, dtype=np.uint8)


def _matrix_to_rows(m: np.ndarray) -> list[int]:
    """bool [14,14] matrix -> 14 row masks (row r: bit c set iff M[r,c])."""
    return [int(sum(int(m[r, c]) << c for c in range(gf2.BITS)))
            for r in range(gf2.BITS)]


def _load():
    """The loaded core, or None under SDV_NO_NATIVE=1.  Builds on first
    use; a failed build raises.  Concurrent callers (the shards of
    parallel/multichip.py) load it once."""
    if _LIB is not None:
        return _LIB
    if os.environ.get("SDV_NO_NATIVE"):
        return None
    with _LOAD_LOCK:
        return _LIB if _LIB is not None else _load_locked()


def _load_locked():
    global _LIB
    L = ctypes.CDLL(str(build("stitchcore.cpp").path))
    L.stc007_set_q_tables.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    L.stc007_correct_blocks.restype = ctypes.c_int
    L.stc007_correct_blocks.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p]
    L.stc007_eval_rows.restype = ctypes.c_int
    L.stc007_eval_rows.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p]
    L.stc007_burst_stats.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p]
    L.stc007_field_res_counts.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int32, ctypes.c_void_p,
        ctypes.c_void_p]
    L.stc007_crc_row.restype = ctypes.c_uint16
    L.stc007_crc_row.argtypes = [ctypes.c_void_p]
    L.stc007_crc_rows.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
    L.agc_peak_scan.argtypes = [
        ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_void_p]
    L.stc007_ref_sweep_lines.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p]
    L.stc007_binarize_frames.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int32, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p]
    L.stc007_padding_sweep.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_void_p]
    L.stc007_steady_round.restype = ctypes.c_int64
    L.stc007_steady_round.argtypes = [
        ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32,                                  # en_cwd
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p,                # carry ext in
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # carry out
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p]
    L.stc007_spec_round.restype = ctypes.c_int64
    L.stc007_spec_round.argtypes = [
        ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int32, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p]
    L.stc007_steady_tail.restype = ctypes.c_int64
    L.stc007_steady_tail.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p]
    L.stc007_deint_finalize.restype = ctypes.c_int64
    L.stc007_deint_finalize.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p]
    L.agc_region_hist.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p]
    L.stc007_find_dup_lines.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p]
    L.stc007_eval_seam.restype = ctypes.c_int
    L.stc007_eval_seam.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p]
    L.stc007_trim_scan.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_void_p]
    L.stc007_split_scan.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p]
    L.stc007_marker_search.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p]
    # PCM-1 / PCM-16x0 bindings.
    L.pcm16x0_decode_blocks.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p]
    L.pcm16x0_decode_blocks_rows.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p]
    L.pcm_crc_rows.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p]
    L.linegrid_coord_sweep.restype = ctypes.c_int
    L.linegrid_coord_sweep.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_void_p,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_void_p]
    _frame_dec = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    L.pcm1_binarize_frames.argtypes = list(_frame_dec)
    L.pcm16x0_binarize_frames.argtypes = list(_frame_dec) + \
        [ctypes.c_void_p]
    L.pcm_pick_cut_line.restype = ctypes.c_int
    L.pcm_pick_cut_line.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_void_p]
    L.pcm_search_coordinates.restype = ctypes.c_int
    L.pcm_search_coordinates.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p]
    L.pcm1_field_deint.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p]
    L.pcm1_steady_frame.restype = ctypes.c_int32
    L.pcm1_steady_frame.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p]
    L.pcm16x0_steady_frame.restype = ctypes.c_int32
    L.pcm16x0_steady_frame.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p]
    L.pcm16x0_block_flags.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p]
    L.pcm16x0_burst_stats.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p]
    # Capture codecs (pipeline/huffyuv.py, lagarith.py, utvideo.py,
    # ffv1.py and the batch paths of pipeline/avi.py).
    L.hfyu_decode_yuy2.restype = ctypes.c_int
    L.hfyu_decode_yuy2.argtypes = [
        ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]
    L.uly_decode_plane.restype = ctypes.c_int
    L.uly_decode_plane.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p]
    L.lags_decode_plane.restype = ctypes.c_int
    L.lags_decode_plane.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]
    L.uly_decode_frames_gray.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_void_p]
    L.lags_decode_frames_gray.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p]
    L.hfyu_decode_frames.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p]
    L.ffv1_decode_frame_gray_v2.restype = ctypes.c_int
    L.ffv1_decode_frame_gray_v2.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int32, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p]
    tpow_rows = np.zeros((13, gf2.BITS), dtype=np.uint16)
    for k in range(-6, 7):
        tpow_rows[k + 6] = _matrix_to_rows(gf2.tpow(k))
    inv_rows = np.zeros((5, gf2.BITS), dtype=np.uint16)
    for d in range(1, 6):
        inv_rows[d - 1] = _matrix_to_rows(gf2.tk_plus_i_inv(d))
    L.stc007_set_q_tables(tpow_rows.ctypes.data, inv_rows.ctypes.data)
    # Keep the tables alive (memcpy'd in C++, but be safe anyway).
    L._tables = (tpow_rows, inv_rows)
    _LIB = L
    return _LIB


def available() -> bool:
    return _load() is not None


def correct_blocks_arrays(words, crc_ok, resolution, en_p, en_q, force_ecc):
    """Native correct_blocks: returns the BlockBatch field arrays
    (words, valid, line_crc, audio_state, stage) as numpy; resolution is
    di.RES_14BIT/RES_16BIT."""
    L = _load()
    B = words.shape[0]
    w_in = np.ascontiguousarray(words, dtype=np.int32)
    c_in = np.ascontiguousarray(crc_ok, dtype=np.uint8)
    w_out = np.empty((B, 8), dtype=np.int32)
    v_out = np.empty((B, 8), dtype=np.uint8)
    l_out = np.empty((B, 8), dtype=np.uint8)
    a_out = np.empty(B, dtype=np.int32)
    s_out = np.empty(B, dtype=np.int32)
    rc = L.stc007_correct_blocks(
        w_in.ctypes.data, c_in.ctypes.data, B, int(resolution),
        int(bool(en_p)), int(bool(en_q)), int(bool(force_ecc)),
        w_out.ctypes.data, v_out.ctypes.data, l_out.ctypes.data,
        a_out.ctypes.data, s_out.ctypes.data)
    if rc != 0:
        raise RuntimeError("stc007_correct_blocks failed")
    return (w_out.astype(np.int64), v_out.astype(bool), l_out.astype(bool),
            a_out, s_out)


# Packed flag bits of stc007_eval_rows' flags output.
FLAG_BROKEN, FLAG_BLOCK_VALID, FLAG_CAN_FORCE, FLAG_SILENT, FLAG_FIX_P, \
    FLAG_FIX_Q, FLAG_CWD_APP = 1, 2, 4, 8, 16, 32, 64


def eval_rows_arrays(line_words, line_crc, cwd_line, rows, start, n_blocks,
                     res_mode, en_p, en_q, force_ecc, en_cwd, m2):
    """Native whole-seam eval.

    line_words [L,8] int, line_crc [L,8] bool, cwd_line [L] bool or None,
    rows [B,8] int or None (None -> contiguous shifts from `start`).
    Returns (words[B,8] i64, valid[B,8], line_crc[B,8], state[B], stage[B],
    resolution[B], flags[B] u8, samples[B,6] i16).
    """
    L = _load()
    B = int(n_blocks)
    w_in = np.ascontiguousarray(line_words, dtype=np.int32)
    c_in = _as_u8(line_crc)
    cwd_ptr = 0
    cwd_arr = None
    if cwd_line is not None:
        cwd_arr = _as_u8(cwd_line)
        cwd_ptr = cwd_arr.ctypes.data
    rows_ptr = 0
    rows_arr = None
    if rows is not None:
        rows_arr = np.ascontiguousarray(rows, dtype=np.int64)
        rows_ptr = rows_arr.ctypes.data
    # Outputs are written in their final dtypes (i64 words, bool flags —
    # bool shares uint8's layout), so no post-call astype copies.
    w_out = np.empty((B, 8), dtype=np.int64)
    v_out = np.empty((B, 8), dtype=bool)
    l_out = np.empty((B, 8), dtype=bool)
    a_out = np.empty(B, dtype=np.int32)
    s_out = np.empty(B, dtype=np.int32)
    r_out = np.empty(B, dtype=np.int32)
    f_out = np.empty(B, dtype=np.uint8)
    smp_out = np.empty((B, 6), dtype=np.int16)
    rc = L.stc007_eval_rows(
        w_in.ctypes.data, c_in.ctypes.data, cwd_ptr, rows_ptr, int(start),
        B, int(res_mode), int(bool(en_p)), int(bool(en_q)),
        int(bool(force_ecc)), int(bool(en_cwd)), int(bool(m2)),
        w_out.ctypes.data, v_out.ctypes.data, l_out.ctypes.data,
        a_out.ctypes.data, s_out.ctypes.data, r_out.ctypes.data,
        f_out.ctypes.data, smp_out.ctypes.data)
    if rc != 0:
        raise RuntimeError("stc007_eval_rows failed")
    return (w_out, v_out, l_out, a_out, s_out, r_out, f_out, smp_out)


def deint_finalize(line_words, line_crc, cwd_line, start, n_blocks,
                   res_mode, en_p, en_q, force_ecc, en_cwd, m2,
                   line_number, frame_number, inner_gate, outer_gate,
                   fa_frame, f0_frame, fb_frame, broken_mask_dur,
                   countdown, file_start, file_end):
    """Fused performDeinterleave (eval + finalize in one C call over
    contiguous shifts) -> (samples [B,6] i16, wvalid [B,6], wfixed
    [B,6], bvalid [B], counters [6] i64, new_countdown).  Bit-identical
    to the numpy perform_deinterleave tail (differential-tested)."""
    L = _load()
    B = int(n_blocks)
    w_in = np.ascontiguousarray(line_words, dtype=np.int32)
    c_in = _as_u8(line_crc)
    cwd_ptr = 0
    cwd_arr = None
    if cwd_line is not None:
        cwd_arr = _as_u8(cwd_line)
        cwd_ptr = cwd_arr.ctypes.data
    ln = np.ascontiguousarray(line_number, np.int64)
    fn = np.ascontiguousarray(frame_number, np.int64)
    samples = np.empty((B, 6), np.int16)
    wvalid = np.empty((B, 6), bool)
    wfixed = np.empty((B, 6), bool)
    bvalid = np.empty(B, bool)
    counters = np.empty(6, np.int64)
    cd = L.stc007_deint_finalize(
        w_in.ctypes.data, c_in.ctypes.data, cwd_ptr, int(start), B,
        int(res_mode), int(bool(en_p)), int(bool(en_q)),
        int(bool(force_ecc)), int(bool(en_cwd)), int(bool(m2)),
        ln.ctypes.data, fn.ctypes.data,
        int(bool(inner_gate)), int(bool(outer_gate)),
        int(fa_frame), int(f0_frame), int(fb_frame),
        int(broken_mask_dur), int(countdown),
        int(bool(file_start)), int(bool(file_end)),
        samples.ctypes.data, wvalid.ctypes.data, wfixed.ctypes.data,
        bvalid.ctypes.data, counters.ctypes.data)
    if cd < 0:
        raise RuntimeError("stc007_deint_finalize failed")
    return samples, wvalid, wfixed, bvalid, counters, int(cd)


# stc007_steady_round per-pair record layout (int64[REC_N]); mirrors the
# C enum in stitchcore.cpp.
REC_N = 48
REC_STATUS, REC_NEW, REC_END, REC_CB, REC_TRIM = 0, 1, 2, 3, 4
REC_SPLIT, REC_OREF, REC_EREF, REC_RES = 18, 31, 32, 33
REC_VSTD, REC_TARGET, REC_CNT, REC_CD, REC_NBLK, REC_OFS = (
    37, 38, 39, 45, 46, 47)
_ROUND_FP_N = 14
MDD_ROWS = 112


def _fill_fp(fp, i, fno, s, keep, lazy_words_null=False):
    """One per-frame pointer-table row (shared by steady/spec rounds)."""
    crcv = s.crc_valid_ignore_forced()
    if crcv.dtype != np.bool_ or not crcv.flags.c_contiguous:
        crcv = np.ascontiguousarray(crcv, bool)
        keep.append(crcv)
    fp[i, 0] = 0 if (lazy_words_null and not s.words_materialized()) \
        else s.words.ctypes.data
    fp[i, 1] = s.word_crc.ctypes.data
    fp[i, 2] = s.forced_bad.ctypes.data
    fp[i, 3] = s.line_number.ctypes.data
    fp[i, 4] = s.frame_number.ctypes.data
    fp[i, 5] = s.service.ctypes.data
    fp[i, 6] = crcv.ctypes.data
    fp[i, 7] = s.ref_level.ctypes.data
    fp[i, 8] = s.has_markers.ctypes.data
    fp[i, 9] = len(s)
    fp[i, 10] = fno
    fp[i, 11] = s.source_crc.ctypes.data
    fp[i, 12] = s.word_valid.ctypes.data
    fp[i, 13] = s.coords_valid.ctypes.data


def steady_round(stores, carry_w32, carry_crc8, carry_ln, carry_fn,
                 silent_w32, en_p, en_q, unch_lim, max_burst_silence,
                 max_burst_broken, broken_mask_dur, auto_m2, m2,
                 fixed_mode, preset_order, preset_vid, fa_order_preset,
                 state, en_cwd=False, conv_store=None):
    """Run stc007_steady_round over the pending frame stores.

    stores: list of (frame_no, LineStore); state: int64[23] rolling
    state vector (mutated in place).  Returns (n_done, records
    [n_pairs, 48] i64, samples, wvalid, wfixed, bvalid, carry) where
    the big output arrays are offset-packed per REC_OFS/REC_NBLK.

    With en_cwd (conv_store = the live conv LineStore), the C side runs
    the performCWD write-back fixpoint per pair and `carry` returns the
    post-round conv state as a dict of arrays (words i64 [n,8], src,
    word_crc/word_valid [n,9], forced, coords, ln, fn) — the caller
    MUST rebuild conv_queue from it (the segments no longer carry the
    CWD mutations); None otherwise."""
    L = _load()
    M = len(stores)
    n_pairs = M - 1
    fp = np.empty((M, _ROUND_FP_N), np.int64)
    keep = []  # keepalive for arrays materialized here
    for i, (fno, s) in enumerate(stores):
        _fill_fp(fp, i, fno, s, keep)
    cap = n_pairs * 2 * 294 + 8
    records = np.zeros((n_pairs, REC_N), np.int64)
    # Rows the C side never reaches keep the no-trim sentinel, so a
    # guard-path return can never be mistaken for a cached trim scan.
    records[:, REC_CB] = -2
    samples = np.empty((cap, 6), np.int16)
    wvalid = np.empty((cap, 6), bool)
    wfixed = np.empty((cap, 6), bool)
    bvalid = np.empty(cap, bool)
    if en_cwd:
        cs = conv_store
        ci_src = np.ascontiguousarray(cs.source_crc, np.int64)
        ci_wc = _as_u8(cs.word_crc)
        ci_wv = _as_u8(cs.word_valid)
        ci_fb = _as_u8(cs.forced_bad)
        ci_cv = _as_u8(cs.coords_valid)
        co_w = np.empty((MDD_ROWS, 8), np.int32)
        co_src = np.empty(MDD_ROWS, np.int64)
        co_wc = np.empty((MDD_ROWS, 9), np.uint8)
        co_wv = np.empty((MDD_ROWS, 9), np.uint8)
        co_fb = np.empty(MDD_ROWS, np.uint8)
        co_cv = np.empty(MDD_ROWS, np.uint8)
        co_ln = np.empty(MDD_ROWS, np.int64)
        co_fn = np.empty(MDD_ROWS, np.int64)
        co_n = np.zeros(1, np.int64)
        ext_in = (ci_src.ctypes.data, ci_wc.ctypes.data,
                  ci_wv.ctypes.data, ci_fb.ctypes.data,
                  ci_cv.ctypes.data)
        ext_out = (co_w.ctypes.data, co_src.ctypes.data,
                   co_wc.ctypes.data, co_wv.ctypes.data,
                   co_fb.ctypes.data, co_cv.ctypes.data,
                   co_ln.ctypes.data, co_fn.ctypes.data,
                   co_n.ctypes.data)
    else:
        ext_in = (0, 0, 0, 0, 0)
        ext_out = (0, 0, 0, 0, 0, 0, 0, 0, 0)
    n_done = L.stc007_steady_round(
        fp.ctypes.data, M,
        carry_w32.ctypes.data, carry_crc8.ctypes.data,
        carry_ln.ctypes.data, carry_fn.ctypes.data, carry_w32.shape[0],
        silent_w32.ctypes.data,
        int(bool(en_p)), int(bool(en_q)), int(unch_lim),
        int(max_burst_silence), int(max_burst_broken),
        int(broken_mask_dur), int(bool(auto_m2)), int(bool(m2)),
        int(fixed_mode),
        int(preset_order), int(preset_vid), int(bool(fa_order_preset)),
        int(bool(en_cwd)), *ext_in, *ext_out,
        state.ctypes.data, records.ctypes.data,
        samples.ctypes.data, wvalid.ctypes.data, wfixed.ctypes.data,
        bvalid.ctypes.data)
    carry = None
    if en_cwd:
        n = int(co_n[0])
        carry = dict(words=co_w[:n].astype(np.int64),
                     src=co_src[:n], word_crc=co_wc[:n].astype(bool),
                     word_valid=co_wv[:n].astype(bool),
                     forced=co_fb[:n].astype(bool),
                     coords=co_cv[:n].astype(bool),
                     ln=co_ln[:n], fn=co_fn[:n])
    return int(n_done), records, samples, wvalid, wfixed, bvalid, carry


BS_SPEC = 11   # spec_round bail: device-round speculation did not match


# -- capture codecs ---------------------------------------------------------
# Each returns None only under SDV_NO_NATIVE=1, where the codec modules run
# their Python decoders; a failed build raises from _load().

def _bytes_u8(data):
    """A bytes-like object (bytes, mmap, memoryview) or array as a
    contiguous uint8 array, without a copy where the buffer allows."""
    if isinstance(data, np.ndarray):
        return np.ascontiguousarray(data, np.uint8)
    return np.frombuffer(data, np.uint8)


def hfyu_decode_yuy2(data, W, H, lens_y, lens_u, lens_v):
    """HuffYUV YUY2 left-predictor frame -> luma [H, W] u8.  Raises
    ValueError on malformed bitstreams."""
    L = _load()
    if L is None:
        return None
    data = _bytes_u8(data)
    out = np.empty((int(H), int(W)), np.uint8)
    rc = L.hfyu_decode_yuy2(
        data.ctypes.data, data.size,
        _as_u8(lens_y).ctypes.data, _as_u8(lens_u).ctypes.data,
        _as_u8(lens_v).ctypes.data, int(W), int(H), out.ctypes.data)
    if rc != 0:
        raise ValueError(f"HFYU: malformed frame bitstream (rc={rc})")
    return out


def uly_decode_plane(data, pos, W, H, slices, pred, even_mask):
    """Ut Video plane -> (rc, [H, W] u8).  rc: 0 ok, -1 truncated,
    -2 invalid code, -3 bad slice offsets, -4 empty code-length table."""
    L = _load()
    if L is None:
        return None
    data = _bytes_u8(data)
    out = np.empty((int(H), int(W)), np.uint8)
    rc = L.uly_decode_plane(data.ctypes.data, data.size, int(pos),
                            int(W), int(H), int(slices), int(pred),
                            int(bool(even_mask)), out.ctypes.data)
    return int(rc), out


def _batch_args(data, entries):
    offs = np.array([e[0] for e in entries], np.int64)
    sizes = np.array([e[1] for e in entries], np.int64)
    return _bytes_u8(data), offs, sizes


def uly_decode_frames_gray(data, entries, W, H, slices, even_mask):
    """Frame-parallel Ut Video batch decode (OMP across frames).
    entries: [(offset, size)]; offset < 0 = dropped slot (black).
    -> (rcs [F] i32, out [F, H, W] u8)."""
    L = _load()
    if L is None:
        return None
    data, offs, sizes = _batch_args(data, entries)
    F = len(entries)
    out = np.empty((F, int(H), int(W)), np.uint8)
    rcs = np.empty(F, np.int32)
    L.uly_decode_frames_gray(
        data.ctypes.data, offs.ctypes.data, sizes.ctypes.data, F,
        int(W), int(H), int(slices), int(bool(even_mask)),
        out.ctypes.data, rcs.ctypes.data)
    return rcs, out


def lags_decode_frames_gray(data, entries, W, H):
    """Frame-parallel Lagarith batch decode -> (rcs, out); rc -5 is an
    unsupported frame type (the caller decodes that frame alone)."""
    L = _load()
    if L is None:
        return None
    data, offs, sizes = _batch_args(data, entries)
    F = len(entries)
    out = np.empty((F, int(H), int(W)), np.uint8)
    rcs = np.empty(F, np.int32)
    L.lags_decode_frames_gray(
        data.ctypes.data, offs.ctypes.data, sizes.ctypes.data, F,
        int(W), int(H), out.ctypes.data, rcs.ctypes.data)
    return rcs, out


def hfyu_decode_frames(data, entries, W, H, lens_y, lens_u, lens_v):
    """Frame-parallel HuffYUV batch decode -> (rcs, out)."""
    L = _load()
    if L is None:
        return None
    ly, lu, lv = (_as_u8(t) for t in (lens_y, lens_u, lens_v))
    data, offs, sizes = _batch_args(data, entries)
    F = len(entries)
    out = np.empty((F, int(H), int(W)), np.uint8)
    rcs = np.empty(F, np.int32)
    L.hfyu_decode_frames(
        data.ctypes.data, offs.ctypes.data, sizes.ctypes.data, F,
        ly.ctypes.data, lu.ctypes.data, lv.ctypes.data,
        int(W), int(H), out.ctypes.data, rcs.ctypes.data)
    return rcs, out


def ffv1_decode_frame_gray(data, W, H, cfg_args, state_arrays):
    """FFV1 v3 gray frame decode with Python-owned persistent slice
    contexts.  cfg_args: (ac, ec, version, micro_version, num_h, num_v,
    quant_tables [qt,5,256] i16, context_counts [qt] i32, max_cc,
    one_state [256] u8).  state_arrays: (slice_qidx i32 [ns], vlc_states
    i32 [ns*max_cc*4], rac_states u8 [ns*max_cc*32], seen_keyframe bool);
    the three arrays are updated in place.  -> (rc, keyframe, out [H, W])."""
    L = _load()
    if L is None:
        return None
    (ac, ec, version, micro, num_h, num_v, qts, ccounts, max_cc,
     one_state) = cfg_args
    slice_qidx, vlc_states, rac_states, seen_keyframe = state_arrays
    data = _bytes_u8(data)
    out = np.empty((int(H), int(W)), np.uint8)
    key = np.zeros(1, np.int32)
    rc = L.ffv1_decode_frame_gray_v2(
        data.ctypes.data, data.size, int(W), int(H),
        int(ac), int(ec), int(version), int(micro), int(num_h), int(num_v),
        qts.ctypes.data, ccounts.ctypes.data, int(len(ccounts)),
        int(max_cc), one_state.ctypes.data, int(bool(seen_keyframe)),
        slice_qidx.ctypes.data, vlc_states.ctypes.data,
        rac_states.ctypes.data, key.ctypes.data, out.ctypes.data)
    return int(rc), bool(key[0]), out


def lags_decode_plane(src, spos, W, H):
    """Lagarith plane (rac/raw/solid) -> (rc, luma [H, W] u8).  rc: 0 ok,
    -1 malformed, -2 bitstream overrun, -3 zero-run-line coding
    (unsupported), -4 bad escape; the caller maps codes to its messages."""
    L = _load()
    if L is None:
        return None
    src = _bytes_u8(src)
    out = np.empty((int(H), int(W)), np.uint8)
    rc = L.lags_decode_plane(src.ctypes.data, src.size, int(spos),
                             int(W), int(H), out.ctypes.data)
    return int(rc), out


def spec_round(stores, carry_w32, carry_crc8, carry_ln, carry_fn,
               silent_w32, en_q, unch_lim, max_burst_silence,
               max_burst_broken, broken_mask_dur, auto_m2, m2,
               fixed_mode, preset_order, preset_vid, fa_order_preset,
               packed1, conv_samples, res_counts, seam_stats, seam_meta,
               dev_plain, spec_geom, lpf, pred_mode, spec_carry_w,
               spec_carry_ok, spec_n0, state):
    """stc007_spec_round: the steady-round state machine consuming the
    DEVICE round dispatch's packed dual-resolution evals (ops/
    device_stitch.steady_round_packed) — trim/split/state in C, signal
    math from the chip.  Record/output contract identical to
    steady_round; a pair whose geometry, carry, or store provenance
    differs from what the device speculated bails with BS_SPEC and the
    per-pair Python path decides.  spec_geom = (c1, c2, padI, padO,
    tff, target)."""
    L = _load()
    M = len(stores)
    n_pairs = M - 1
    fp = np.empty((M, _ROUND_FP_N), np.int64)
    keep = []
    # stc007_spec_round never reads FP_WORDS (its evals come from the
    # device's packed buffers) — keep lazy stores lazy instead of
    # materializing a full device readback for an unused pointer.
    for i, (fno, s) in enumerate(stores):
        _fill_fp(fp, i, fno, s, keep, lazy_words_null=True)
    cap = n_pairs * 2 * 294 + 8
    records = np.zeros((n_pairs, REC_N), np.int64)
    records[:, REC_CB] = -2
    samples = np.empty((cap, 6), np.int16)
    wvalid = np.empty((cap, 6), bool)
    wfixed = np.empty((cap, 6), bool)
    bvalid = np.empty(cap, bool)
    c1, c2, padI, padO, tff, target = spec_geom
    packed1 = np.ascontiguousarray(packed1, np.uint32)
    conv_samples = np.ascontiguousarray(conv_samples, np.int16)
    res_counts = np.ascontiguousarray(res_counts, np.int64)
    seam_stats = np.ascontiguousarray(seam_stats, np.int32)
    seam_meta = np.ascontiguousarray(seam_meta, np.int64)
    dev_plain = _as_u8(dev_plain)
    spec_carry_w = np.ascontiguousarray(spec_carry_w, np.int32)
    spec_carry_ok = _as_u8(spec_carry_ok)
    n_done = L.stc007_spec_round(
        fp.ctypes.data, M,
        carry_w32.ctypes.data, carry_crc8.ctypes.data,
        carry_ln.ctypes.data, carry_fn.ctypes.data, carry_w32.shape[0],
        silent_w32.ctypes.data,
        int(bool(en_q)), int(unch_lim),
        int(max_burst_silence), int(max_burst_broken),
        int(broken_mask_dur), int(bool(auto_m2)), int(bool(m2)),
        int(fixed_mode),
        int(preset_order), int(preset_vid), int(bool(fa_order_preset)),
        packed1.ctypes.data, conv_samples.ctypes.data,
        res_counts.ctypes.data, seam_stats.ctypes.data,
        seam_meta.ctypes.data, dev_plain.ctypes.data,
        int(c1), int(c2), int(padI), int(padO), int(bool(tff)),
        int(target), int(lpf), int(pred_mode),
        spec_carry_w.ctypes.data, spec_carry_ok.ctypes.data,
        int(spec_n0),
        state.ctypes.data, records.ctypes.data,
        samples.ctypes.data, wvalid.ctypes.data, wfixed.ctypes.data,
        bvalid.ctypes.data)
    return int(n_done), records, samples, wvalid, wfixed, bvalid


def steady_tail(carry_w32, carry_crc8, f1a_w32, f1a_crc8, c1,
                f1b_w32, f1b_crc8, c2, f2f_w32, f2f_crc8,
                ra_w32, ra_crc8, rb_w32, rb_crc8, silent_w32,
                pad_inner, pad_outer, inner_res_mode, outer_first_mode,
                outer_full_mode, outer_last_is_even, fb_unk_mode,
                en_p, en_q, m2, unch_lim, max_burst_silence,
                max_burst_broken, conv_res_mode, broken_mask_dur,
                countdown, n_blocks):
    """One-call steady-state frame tail (stc007_steady_tail): fresh-field
    resolution counts + both TRY_PREVIOUS seam evals + conv assembly +
    the fused deinterleave.  Returns (rc, res_counts [4] i64,
    seam_stats [8] i32, samples, wvalid, wfixed, bvalid, counters);
    rc >= 0 is the new BROKEN countdown (steady frame complete), -2/-3
    mean the inner/outer seam verdict was not OK (deint outputs are
    untouched; res counts are still valid).  Bit-identity with the
    Python stage machine is pinned by tests/test_steady_pair.py."""
    L = _load()
    B = int(n_blocks)
    res_counts = np.empty(4, np.int64)
    seam_stats = np.empty(8, np.int32)
    samples = np.empty((B, 6), np.int16)
    wvalid = np.empty((B, 6), bool)
    wfixed = np.empty((B, 6), bool)
    bvalid = np.empty(B, bool)
    counters = np.empty(6, np.int64)
    rc = L.stc007_steady_tail(
        carry_w32.ctypes.data, carry_crc8.ctypes.data, carry_w32.shape[0],
        f1a_w32.ctypes.data, f1a_crc8.ctypes.data, f1a_w32.shape[0],
        int(c1),
        f1b_w32.ctypes.data, f1b_crc8.ctypes.data, f1b_w32.shape[0],
        int(c2),
        f2f_w32.ctypes.data, f2f_crc8.ctypes.data, f2f_w32.shape[0],
        ra_w32.ctypes.data, ra_crc8.ctypes.data, ra_w32.shape[0],
        rb_w32.ctypes.data, rb_crc8.ctypes.data, rb_w32.shape[0],
        silent_w32.ctypes.data, int(pad_inner), int(pad_outer),
        int(inner_res_mode), int(outer_first_mode), int(outer_full_mode),
        int(bool(outer_last_is_even)), int(fb_unk_mode),
        int(bool(en_p)), int(bool(en_q)), int(bool(m2)),
        int(unch_lim), int(max_burst_silence), int(max_burst_broken),
        int(conv_res_mode), int(broken_mask_dur), int(countdown),
        res_counts.ctypes.data, seam_stats.ctypes.data,
        samples.ctypes.data, wvalid.ctypes.data, wfixed.ctypes.data,
        bvalid.ctypes.data, counters.ctypes.data)
    return (int(rc), res_counts, seam_stats, samples, wvalid, wfixed,
            bvalid, counters)


def padding_sweep(f1_w32, f1_crc8, f2_w32, f2_crc8, silent_w32,
                  max_padding, modes, en_p, en_q, m2, unch_lim,
                  max_burst_silence, max_burst_broken):
    """All-paddings seam sweep in one call -> (stats [P,4] i32,
    has_stats [P] bool); per-padding semantics identical to eval_seam
    (== try_padding, differential-tested)."""
    L = _load()
    P = int(max_padding)
    md = np.ascontiguousarray(modes, np.int32)
    stats = np.zeros((P, 4), np.int32)
    has = np.empty(P, bool)
    L.stc007_padding_sweep(
        f1_w32.ctypes.data, f1_crc8.ctypes.data, f1_w32.shape[0],
        f2_w32.ctypes.data, f2_crc8.ctypes.data, f2_w32.shape[0],
        silent_w32.ctypes.data, P, md.ctypes.data,
        int(bool(en_p)), int(bool(en_q)), int(bool(m2)), int(unch_lim),
        int(max_burst_silence), int(max_burst_broken),
        stats.ctypes.data, has.ctypes.data)
    return stats, has


def eval_seam(a_words32, a_crc8, pad_n, pad_words32, c_words32, c_crc8,
              res_mode, en_p, en_q, force_ecc, m2, unch_lim,
              max_burst_silence, max_burst_broken):
    """Single-call tryPadding seam eval: gathers [field1 tail | silent
    pad | field2 head] natively and returns burst stats
    (valid_max, silent_max, unch_max, broken_count), or None when the
    queue is shorter than MIN_DEINT_DATA.  Inputs must be C-contiguous
    int32 [n,8] words and uint8/bool [n,8] crc-ok arrays."""
    L = _load()
    out = np.empty(4, np.int32)
    rc = L.stc007_eval_seam(
        a_words32.ctypes.data, a_crc8.ctypes.data, a_words32.shape[0],
        int(pad_n), pad_words32.ctypes.data,
        c_words32.ctypes.data, c_crc8.ctypes.data, c_words32.shape[0],
        int(res_mode), int(bool(en_p)), int(bool(en_q)),
        int(bool(force_ecc)), int(bool(m2)), int(unch_lim),
        int(max_burst_silence), int(max_burst_broken), out.ctypes.data)
    if rc == 1:
        return None
    if rc != 0:
        raise RuntimeError("stc007_eval_seam failed")
    return out


def trim_scan(line_number, frame_number, service, crcv, forced_bad,
              rule_b_aux, frame_no, rule_b_or_crc=True):
    """Native findFramesTrim scan over one frame store.

    Returns the raw int64[14] output of stc007_trim_scan: per-parity
    (first, last) row indices for the CRC-only rule and for rule B
    (rule_b_aux | crc when rule_b_or_crc, else rule_b_aux alone),
    service facts and per-parity good-line counts (see stitchcore.cpp)."""
    L = _load()
    ln = np.ascontiguousarray(line_number, np.int64)
    fn = np.ascontiguousarray(frame_number, np.int64)
    sv = np.ascontiguousarray(service, np.int8)
    out = np.empty(14, np.int64)
    L.stc007_trim_scan(
        ln.ctypes.data, fn.ctypes.data, sv.ctypes.data,
        _as_u8(crcv).ctypes.data, _as_u8(forced_bad).ctypes.data,
        _as_u8(rule_b_aux).ctypes.data, len(ln), int(frame_no),
        int(bool(rule_b_or_crc)), out.ctypes.data)
    return out


def split_scan(line_number, frame_number, service, crcv, forced_bad,
               frame_no, even_top, even_bottom, even_enable,
               odd_top, odd_bottom, odd_enable, cap, want_idx=False):
    """Native splitFramesToFields row scan -> int64[13], or
    (out, idx_even, idx_odd) row-index arrays when want_idx
    (see stitchcore.cpp stc007_split_scan)."""
    L = _load()
    ln = np.ascontiguousarray(line_number, np.int64)
    fn = np.ascontiguousarray(frame_number, np.int64)
    sv = np.ascontiguousarray(service, np.int8)
    out = np.empty(13, np.int64)
    ie = io_ = None
    pe = po = 0
    if want_idx:
        ie = np.empty(int(cap), np.int64)
        io_ = np.empty(int(cap), np.int64)
        pe, po = ie.ctypes.data, io_.ctypes.data
    L.stc007_split_scan(
        ln.ctypes.data, fn.ctypes.data, sv.ctypes.data,
        _as_u8(crcv).ctypes.data, _as_u8(forced_bad).ctypes.data,
        len(ln), int(frame_no),
        int(even_top), int(even_bottom), int(bool(even_enable)),
        int(odd_top), int(odd_bottom), int(bool(odd_enable)),
        int(cap), out.ctypes.data, pe, po)
    if want_idx:
        return out, ie[:out[3]], io_[:out[9]]
    return out


def find_dup_lines(words, crc_read, valid, bounds, thres, m2):
    """Native duplicate-line scan; bit-identical to the numpy twin in
    pipeline.v2d.find_duplicate_lines (differential-tested)."""
    L = _load()
    w = np.ascontiguousarray(words, np.int64)
    c = np.ascontiguousarray(crc_read, np.int64)
    v = _as_u8(valid)
    b = np.ascontiguousarray(bounds, np.int64).reshape(-1, 2)
    out = np.zeros(len(v), bool)
    L.stc007_find_dup_lines(
        w.ctypes.data, c.ctypes.data, v.ctypes.data, b.ctypes.data,
        len(b), len(v), int(thres), int(bool(m2)), out.ctypes.data)
    return out


def crc_row(words8) -> int:
    """Native CRC-16 of one line's 8 data words."""
    L = _load()
    w = np.ascontiguousarray(words8[:8], np.int32)
    return int(L.stc007_crc_row(w.ctypes.data))


def crc_rows(words):
    """Native CRC-16 of [N, 8] data words -> uint16 [N]."""
    L = _load()
    w = np.ascontiguousarray(words, np.int32)
    out = np.empty(w.shape[0], np.uint16)
    L.stc007_crc_rows(w.ctypes.data, w.shape[0], out.ctypes.data)
    return out


def region_hist(pixels, spans):
    """Native region_histograms twin: per-line histograms over masked
    pixel spans (overlaps count once) -> [N, 256] i64."""
    L = _load()
    N, W = pixels.shape
    ns = len(spans)
    lo = np.empty((ns, N), np.int64)
    hi = np.empty((ns, N), np.int64)
    for s, (a, b) in enumerate(spans):
        lo[s] = np.broadcast_to(np.asarray(a, np.int64), (N,))
        hi[s] = np.broadcast_to(np.asarray(b, np.int64), (N,))
    out = np.empty((N, 256), np.int64)
    L.agc_region_hist(pixels.ctypes.data, N, W, lo.ctypes.data,
                      hi.ctypes.data, ns, out.ctypes.data)
    return out


def field_res_counts(line_words, line_crc, test_size, m2):
    """Native getFieldResolution counters -> (count14, count16)."""
    L = _load()
    w = np.ascontiguousarray(line_words, np.int32)
    c = np.ascontiguousarray(line_crc, np.uint8)
    c14 = np.zeros(1, np.int64)
    c16 = np.zeros(1, np.int64)
    L.stc007_field_res_counts(w.ctypes.data, c.ctypes.data,
                              w.shape[0], int(test_size), int(bool(m2)),
                              c14.ctypes.data, c16.ctypes.data)
    return int(c14[0]), int(c16[0])


def peak_scan(hist, start, stop_limit, min_count, delta, upward):
    """Native histogram peak scan (findBlackWhite :3235-3330 twin)."""
    L = _load()
    N = hist.shape[0]
    h = np.ascontiguousarray(hist, np.int64)
    args = [np.ascontiguousarray(np.broadcast_to(a, (N,)), np.int64)
            for a in (start, stop_limit, min_count, delta)]
    best = np.empty(N, np.int64)
    found = np.empty(N, np.uint8)
    L.agc_peak_scan(h.ctypes.data, N, args[0].ctypes.data,
                    args[1].ctypes.data, args[2].ctypes.data,
                    args[3].ctypes.data, int(bool(upward)),
                    best.ctypes.data, found.ctypes.data)
    return best, found.astype(bool)


def ref_sweep_lines(pixels, coords, black, white, levels, hyst_limit,
                    shift_limit):
    """Native per-line reference-level sweep (twin of
    binarize.stc007_ref_sweep_decode for a flat line batch).

    pixels [N, W] uint8 (contiguous rows); coords [N,2];
    black/white [N]; levels [R].  Returns dict(valid [R,N], crc [R,N],
    hyst, shift, words [R,N,8]) ready for binarize.pick_ref_sweep."""
    L = _load()
    N, W = pixels.shape
    if pixels.strides[1] != 1:
        pixels = np.ascontiguousarray(pixels)
    cds = np.ascontiguousarray(coords, np.int32)
    bk = np.ascontiguousarray(np.broadcast_to(black, (N,)), np.int32)
    wt = np.ascontiguousarray(np.broadcast_to(white, (N,)), np.int32)
    lv = np.ascontiguousarray(levels, np.int32)
    R = len(lv)
    valid = np.empty((R, N), np.uint8)
    crc = np.empty((R, N), np.int32)
    hyst = np.empty((R, N), np.int8)
    shift = np.empty((R, N), np.int8)
    words = np.empty((R, N, 8), np.int16)
    L.stc007_ref_sweep_lines(
        pixels.ctypes.data, N, W, pixels.strides[0], cds.ctypes.data,
        bk.ctypes.data, wt.ctypes.data, lv.ctypes.data, R,
        int(hyst_limit), int(shift_limit), valid.ctypes.data,
        crc.ctypes.data, hyst.ctypes.data, shift.ctypes.data,
        words.ctypes.data)
    # int64 up-casts: pick_ref_sweep compares against wide sentinels
    # (0x7FFF), which int8 outputs would wrap.
    return dict(valid=valid.astype(bool), crc=crc.astype(np.int64),
                hyst=hyst.astype(np.int64), shift=shift.astype(np.int64),
                words=words)


def binarize_frames(pixels, coords, ref, black, white, hyst_limit,
                    shift_limit, row_map=None):
    """Native STC-007 trial-grid frame decode (host twin of
    binarize.stc007_frame_decode; bit-identical, early-exit serial).

    pixels: [F, L, W] uint8 — ANY strides accepted (zero-copy views off
    the capture mmap are the point).  coords [F,2]; ref/black/white [F]
    or [F,L] for per-line AGC (in pixels-row order).  row_map [L]
    permutes INPUT rows: output line l decodes pixels row row_map[l]
    (field-sequential outputs straight off the raw capture view, no
    post-hoc gathers).  Returns (words [F,L,8] i64, crc [F,L] i64,
    valid [F,L] bool, hyst [F,L] i8, shift [F,L] i8).
    """
    L = _load()
    F, Ln, W = pixels.shape
    if pixels.strides[2] != 1:
        pixels = np.ascontiguousarray(pixels)
    cds = np.ascontiguousarray(coords, np.int32)
    per_line = np.asarray(ref).ndim == 2
    rf = np.ascontiguousarray(ref, np.int32)
    bk = np.ascontiguousarray(np.broadcast_to(black, rf.shape), np.int32)
    wt = np.ascontiguousarray(np.broadcast_to(white, rf.shape), np.int32)
    rm_ptr = 0
    rm = None
    if row_map is not None:
        rm = np.ascontiguousarray(row_map, np.int64)
        rm_ptr = rm.ctypes.data
    words = np.empty((F, Ln, 8), np.int16)
    crc = np.empty((F, Ln), np.uint16)
    valid = np.empty((F, Ln), np.uint8)
    hyst = np.empty((F, Ln), np.int8)
    shift = np.empty((F, Ln), np.int8)
    L.stc007_binarize_frames(
        pixels.ctypes.data, F, Ln, W,
        pixels.strides[0], pixels.strides[1], rm_ptr,
        cds.ctypes.data, rf.ctypes.data, int(per_line),
        bk.ctypes.data, wt.ctypes.data, int(hyst_limit), int(shift_limit),
        words.ctypes.data, crc.ctypes.data, valid.ctypes.data,
        hyst.ctypes.data, shift.ctypes.data)
    return (words.astype(np.int64), crc.astype(np.int64),
            valid.view(bool), hyst, shift)


def marker_search(pixels, bin_low, bin_high, mark_start_max, mark_end_min,
                  ppb, limit):
    """Native STC-007 marker search (searchSTC007Markers port).

    pixels [N, W] uint8, bin_low/high [N]. Returns the MarkerResult field
    arrays (st_found, ed_found, dstart, dstop, sbg, sed, eed)."""
    L = _load()
    N, W = pixels.shape
    px = np.ascontiguousarray(pixels, dtype=np.uint8)
    lo = np.ascontiguousarray(bin_low, dtype=np.int32)
    hi = np.ascontiguousarray(bin_high, dtype=np.int32)
    st = np.empty(N, np.uint8)
    ed = np.empty(N, np.uint8)
    outs = [np.empty(N, np.int64) for _ in range(5)]
    L.stc007_marker_search(
        px.ctypes.data, N, W, lo.ctypes.data, hi.ctypes.data,
        int(mark_start_max), int(mark_end_min), int(ppb), int(limit),
        st.ctypes.data, ed.ctypes.data, outs[0].ctypes.data,
        outs[1].ctypes.data, outs[2].ctypes.data, outs[3].ctypes.data,
        outs[4].ctypes.data)
    return (st.astype(bool), ed.astype(bool), *outs)


def burst_stats(flags, unch_lim, en_q, max_burst_silence, max_burst_broken):
    """Native tryPadding burst counters over packed eval flags."""
    L = _load()
    f = np.ascontiguousarray(flags, dtype=np.uint8)
    out = np.empty(4, dtype=np.int32)
    L.stc007_burst_stats(f.ctypes.data, len(f), int(unch_lim),
                         int(bool(en_q)), int(max_burst_silence),
                         int(max_burst_broken), out.ctypes.data)
    return int(out[0]), int(out[1]), int(out[2]), int(out[3])


# ---- PCM-1 / PCM-16x0 ----------------------------------------------------

def pcm16x0_decode_blocks(sub_words, sub_crc, shifts, even_order, ofs,
                          en_p, force_ecc):
    """Native PCM-16x0 block decode (P-parity-only correction).

    Returns (words[B,3,3] i64, valid[B,3,3], wcrc[B,3,3], state[B,3],
    stage[B,3], samples[B,3,2] i16, block_valid[B])."""
    L = _load()
    B = len(shifts)
    w = np.ascontiguousarray(sub_words, np.int32)
    c = _as_u8(sub_crc)
    sh = np.ascontiguousarray(shifts, np.int64)
    if B and (int(sh.min()) < 0
              or int(sh.max()) + 2 * int(ofs) >= w.shape[0]):
        # Keep the numpy path's loud failure instead of native UB reads.
        raise IndexError(
            f"block shifts out of range for {w.shape[0]} sublines")
    eo = _as_u8(even_order)
    # Outputs in their consumed dtypes (bool shares uint8's layout;
    # int32 words/state/stage compare fine) — no post-call astype.
    words = np.empty((B, 3, 3), np.int32)
    valid = np.empty((B, 3, 3), bool)
    wcrc = np.empty((B, 3, 3), bool)
    state = np.empty((B, 3), np.int32)
    stage = np.empty((B, 3), np.int32)
    samples = np.empty((B, 3, 2), np.int16)
    bval = np.empty(B, bool)
    L.pcm16x0_decode_blocks(
        w.ctypes.data, c.ctypes.data, sh.ctypes.data, eo.ctypes.data, B,
        int(ofs), int(bool(en_p)), int(bool(force_ecc)),
        words.ctypes.data, valid.ctypes.data, wcrc.ctypes.data,
        state.ctypes.data, stage.ctypes.data, samples.ctypes.data,
        bval.ctypes.data)
    return (words, valid, wcrc, state, stage, samples, bval)


def pcm16x0_decode_blocks_rows(sub_words, sub_crc, rows, even_order,
                               en_p, force_ecc):
    """Row-mapped native PCM-16x0 block decode: rows [B, 3] explicit
    subline indices (one call covers every padding of an EI sweep)."""
    L = _load()
    B = len(rows)
    w = np.ascontiguousarray(sub_words, np.int32)
    c = np.ascontiguousarray(sub_crc, np.uint8)
    r = np.ascontiguousarray(rows, np.int64)
    if B and (int(r.min()) < 0 or int(r.max()) >= w.shape[0]):
        raise IndexError(
            f"block rows out of range for {w.shape[0]} sublines")
    eo = np.ascontiguousarray(even_order, np.uint8)
    words = np.empty((B, 3, 3), np.int32)
    valid = np.empty((B, 3, 3), np.uint8)
    wcrc = np.empty((B, 3, 3), np.uint8)
    state = np.empty((B, 3), np.int32)
    stage = np.empty((B, 3), np.int32)
    samples = np.empty((B, 3, 2), np.int16)
    bval = np.empty(B, np.uint8)
    L.pcm16x0_decode_blocks_rows(
        w.ctypes.data, c.ctypes.data, r.ctypes.data, eo.ctypes.data, B,
        int(bool(en_p)), int(bool(force_ecc)),
        words.ctypes.data, valid.ctypes.data, wcrc.ctypes.data,
        state.ctypes.data, stage.ctypes.data, samples.ctypes.data,
        bval.ctypes.data)
    return (words, valid, wcrc, state, stage, samples, bval)


def linegrid_coord_sweep(pixels_line, ds, de, ref, black, white, fmt,
                         part, d1s, d2s, hyst_limit, shift_limit):
    """Native coordinate-delta sweep through the readPCMdata grid.

    fmt: "pcm1" or "pcm16x0" (with part 0..2). Returns None or
    (words list incl. read CRC, (d1, d2, depth, shift))."""
    L = _load()
    px = np.ascontiguousarray(pixels_line, np.uint8)
    a1 = np.ascontiguousarray(d1s, np.int32)
    a2 = np.ascontiguousarray(d2s, np.int32)
    words = np.zeros(8, np.int32)
    sel = np.zeros(4, np.int32)
    found = L.linegrid_coord_sweep(
        px.ctypes.data, len(px), int(ds), int(de), int(ref), int(black),
        int(white), 0 if fmt == "pcm1" else 1, int(part),
        a1.ctypes.data, len(a1), a2.ctypes.data, len(a2),
        int(hyst_limit), int(shift_limit), words.ctypes.data,
        sel.ctypes.data)
    if not found:
        return None
    n = 7 if fmt == "pcm1" else 4
    return [int(w) for w in words[:n]], tuple(int(x) for x in sel)



def pcm_crc_rows(words, fmt):
    """Native batch row CRC for PCM-1 / PCM-16x0 stores -> uint16 [N]."""
    L = _load()
    n_words, word_bits, inv = (6, 13, 1) if fmt == "pcm1" else (3, 16, 0)
    w = np.ascontiguousarray(words, np.int32)
    out = np.empty(w.shape[0], np.uint16)
    L.pcm_crc_rows(w.ctypes.data, w.shape[0], n_words, word_bits, inv,
                   out.ctypes.data)
    return out


# pcm16x0_steady_frame record indices (mirror of the C layout).
P16_REC_N = 48
(P16_STATUS, P16_TRIM, P16_SPLIT, P16_CTRL, P16_QLEN, P16_BTOTAL,
 P16_CNT, P16_OUT, P16_PAD) = 0, 1, 15, 28, 36, 38, 39, 43, 45


def pcm16x0_steady_frame(store, frame_no, order_tff, en_p):
    """One-call steady SI frame (pcm16x0_steady_frame): trim, split,
    false-positive prescan, the zero-padding fast path, queue assembly,
    control-bit tally and the output block stream.  Returns (rc, rec,
    samples [N,2] i16, wvalid [N,2], wfixed [N,2], bok [N]) — rc != 0
    means a bail (file tag or the pad-0 fast path failed) and the caller
    runs the unchanged frame logic."""
    L = _load()
    crcv = store.crc_valid_ignore_forced()
    cap = 2 * (735 + 105)
    rec = np.zeros(P16_REC_N, np.int64)
    samples = np.empty((cap, 2), np.int16)
    wv = np.empty((cap, 2), bool)
    wf = np.empty((cap, 2), bool)
    bok = np.empty(cap, bool)
    rc = L.pcm16x0_steady_frame(
        store.words.ctypes.data, _as_u8(crcv).ctypes.data,
        _as_u8(store.forced_bad).ctypes.data,
        store.frame_number.ctypes.data, store.line_number.ctypes.data,
        store.line_part.ctypes.data, store.service.ctypes.data,
        _as_u8(store.control_bit).ctypes.data,
        _as_u8(store.bw_set).ctypes.data,
        store.picked_left.ctypes.data, store.picked_right.ctypes.data,
        len(store), int(frame_no), int(bool(order_tff)), int(bool(en_p)),
        rec.ctypes.data, samples.ctypes.data, wv.ctypes.data,
        wf.ctypes.data, bok.ctypes.data)
    return int(rc), rec, samples, wv, wf, bok



P1_REC_N = 32
P1_TRIM, P1_DATA, P1_REFS, P1_CNT = 1, 15, 19, 21


def pcm1_steady_frame(store, frame_no, order_tff, auto_offset,
                      preset_odd, preset_even):
    """One-call steady PCM-1 frame (pcm1_steady_frame): trim scan,
    field split, padding math and both field deinterleaves; outputs two
    735-row fields in emission order.  rc != 0 = bail (file tags); the
    caller excludes header frames before calling."""
    L = _load()
    rec = np.zeros(P1_REC_N, np.int64)
    N = 2 * 735
    samples = np.empty((N, 2), np.int16)
    wv = np.empty((N, 2), bool)
    bok = np.empty(N, bool)
    rc = L.pcm1_steady_frame(
        store.words.ctypes.data,
        _as_u8(store.crc_valid_ignore_forced()).ctypes.data,
        _as_u8(store.forced_bad).ctypes.data,
        store.frame_number.ctypes.data, store.line_number.ctypes.data,
        store.service.ctypes.data, _as_u8(store.bw_set).ctypes.data,
        store.ref_level.ctypes.data,
        len(store), int(frame_no), int(bool(order_tff)),
        int(bool(auto_offset)), int(preset_odd), int(preset_even),
        samples.ctypes.data, wv.ctypes.data, bok.ctypes.data,
        rec.ctypes.data)
    return int(rc), rec, samples, wv, bok


def pcm1_field_deint(sub_left, sub_right, sub_valid):
    """One-pass PCM-1 field deinterleave + companding + stats ->
    (samples [735,2] i16, valid [735,2], block_ok [735],
    bad_blocks, samples_drop); twin of pcm1_deint.deinterleave_field +
    expand_sample (differential-tested)."""
    L = _load()
    N = 735
    sl = np.ascontiguousarray(sub_left, np.int64)
    sr = np.ascontiguousarray(sub_right, np.int64)
    sv = _as_u8(sub_valid)
    samples = np.empty((N, 2), np.int16)
    valid2 = np.empty((N, 2), bool)
    bok = np.empty(N, bool)
    counters = np.empty(2, np.int64)
    L.pcm1_field_deint(sl.ctypes.data, sr.ctypes.data, sv.ctypes.data,
                       samples.ctypes.data, valid2.ctypes.data,
                       bok.ctypes.data, counters.ctypes.data)
    return samples, valid2, bok, int(counters[0]), int(counters[1])


def pcm16x0_block_flags(valid, state, stage, samples, bval):
    """Packed per-block flags + output-pass counters from a decode's
    results -> (flags [B] u8, counters [4] i64); numpy twins:
    _si_seam_flags / _stream_blocks reduces (differential-tested)."""
    L = _load()
    B = len(bval)
    flags = np.empty(B, np.uint8)
    counters = np.empty(4, np.int64)
    L.pcm16x0_block_flags(
        _as_u8(valid).ctypes.data,
        np.ascontiguousarray(state, np.int32).ctypes.data,
        np.ascontiguousarray(stage, np.int32).ctypes.data,
        np.ascontiguousarray(samples, np.int16).ctypes.data,
        _as_u8(bval).ctypes.data, B,
        flags.ctypes.data, counters.ctypes.data)
    return flags, counters


def pcm16x0_burst(flags, max_silence, max_unch, broken_as_run):
    """Native _burst_core twin -> (vmax, smax, umax, brk)."""
    L = _load()
    f = _as_u8(flags)
    out = np.empty(4, np.int32)
    L.pcm16x0_burst_stats(f.ctypes.data, len(f), int(max_silence),
                          int(max_unch), int(bool(broken_as_run)),
                          out.ctypes.data)
    return int(out[0]), int(out[1]), int(out[2]), int(out[3])



def pcm_pick_cut_line(words, crc_read, start, stop, width, fmt, part,
                      left_pick, right_pick):
    """Native Bit Picker on one read line.  Returns None or
    (words, crc, (picked_l, picked_r))."""
    L = _load()
    n = 6 if fmt == "pcm1" else 3
    w_in = np.zeros(8, np.int32)
    w_in[:n] = np.asarray(words[:n], np.int32)
    w_in[n] = int(crc_read)
    w_out = np.zeros(8, np.int32)
    picked = np.zeros(2, np.int32)
    ok = L.pcm_pick_cut_line(
        w_in.ctypes.data, int(width), int(start), int(stop),
        0 if fmt == "pcm1" else 1, int(part), int(left_pick),
        int(right_pick), w_out.ctypes.data, picked.ctypes.data)
    if not ok:
        return None
    return ([int(x) for x in w_out[:n]], int(w_out[n]),
            (int(picked[0]), int(picked[1])))


def pcm_search_coordinates(pixels_line, ds, de, ref, black, white, fmt,
                           part, step, max_ofs, shift_limit, left_pick,
                           right_pick):
    """Native coordinate SEARCH (searchPCM1Data :4123 twin of
    line_decode_np.search_coordinates's grid): returns the picked entry
    dict (result/crc/hyst/shift/start/stop/words/picked) or None."""
    L = _load()
    px = np.ascontiguousarray(pixels_line, np.uint8)
    out = np.zeros(16, np.int64)
    found = L.pcm_search_coordinates(
        px.ctypes.data, len(px), int(ds), int(de), int(ref), int(black),
        int(white), 0 if fmt == "pcm1" else 1, int(part), int(step),
        int(max_ofs), int(shift_limit), int(left_pick), int(right_pick),
        out.ctypes.data)
    if not found:
        return None
    n = 6 if fmt == "pcm1" else 3
    return dict(result=True, crc=int(out[3]), hyst=int(out[4]),
                shift=int(out[5]), start=int(out[1]), stop=int(out[2]),
                words=[int(w) for w in out[8:8 + n]],
                picked=(int(out[6]), int(out[7])))



def pcm1_binarize_frames(pixels, coords, ref, black, white, shift_limit,
                         hyst_limit=0):
    """Native PCM-1 frame decode (twin of binarize.pcm1_frame_decode).

    pixels [F, L, W] uint8 (any strides, contiguous rows); coords [F,2];
    ref/black/white [F].  Returns (words [F,L,6] i64, crc [F,L] i64,
    valid [F,L] bool)."""
    L = _load()
    F, Ln, W = pixels.shape
    if pixels.strides[2] != 1:
        pixels = np.ascontiguousarray(pixels)
    cds = np.ascontiguousarray(coords, np.int32)
    rf = np.ascontiguousarray(np.broadcast_to(ref, (F,)), np.int32)
    bk = np.ascontiguousarray(np.broadcast_to(black, (F,)), np.int32)
    wt = np.ascontiguousarray(np.broadcast_to(white, (F,)), np.int32)
    words = np.empty((F, Ln, 6), np.int32)
    crc = np.empty((F, Ln), np.int32)
    valid = np.empty((F, Ln), np.uint8)
    L.pcm1_binarize_frames(
        pixels.ctypes.data, F, Ln, W, pixels.strides[0],
        pixels.strides[1], cds.ctypes.data, rf.ctypes.data,
        bk.ctypes.data, wt.ctypes.data, int(hyst_limit),
        int(shift_limit),
        words.ctypes.data, crc.ctypes.data, valid.ctypes.data)
    return (words.astype(np.int64), crc.astype(np.int64),
            valid.astype(bool))


def pcm16x0_binarize_frames(pixels, coords, ref, black, white,
                            shift_limit, hyst_limit=0):
    """Native PCM-16x0 frame decode (twin of
    binarize.pcm16x0_frame_decode).  Returns (words [F,L,3,3] i64,
    crc [F,L,3] i64, valid [F,L,3] bool, ctrl [F,L] bool)."""
    L = _load()
    F, Ln, W = pixels.shape
    if pixels.strides[2] != 1:
        pixels = np.ascontiguousarray(pixels)
    cds = np.ascontiguousarray(coords, np.int32)
    rf = np.ascontiguousarray(np.broadcast_to(ref, (F,)), np.int32)
    bk = np.ascontiguousarray(np.broadcast_to(black, (F,)), np.int32)
    wt = np.ascontiguousarray(np.broadcast_to(white, (F,)), np.int32)
    words = np.empty((F, Ln, 3, 3), np.int32)
    crc = np.empty((F, Ln, 3), np.int32)
    valid = np.empty((F, Ln, 3), np.uint8)
    ctrl = np.empty((F, Ln), np.uint8)
    L.pcm16x0_binarize_frames(
        pixels.ctypes.data, F, Ln, W, pixels.strides[0],
        pixels.strides[1], cds.ctypes.data, rf.ctypes.data,
        bk.ctypes.data, wt.ctypes.data, int(hyst_limit),
        int(shift_limit),
        words.ctypes.data, crc.ctypes.data, valid.ctypes.data,
        ctrl.ctypes.data)
    return (words.astype(np.int64), crc.astype(np.int64),
            valid.astype(bool), ctrl.astype(bool))
