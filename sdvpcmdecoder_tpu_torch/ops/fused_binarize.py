"""Fused STC-007 trial-grid binarize: the hand-written CUDA kernel's wrappers.

Counterparts of the two Pallas kernels of
sdvpcmdecoder_tpu/ops/pallas_binarize.py: `stc007_fused_decode_frames`
(K1, frames [F, L, W] with per-frame coordinates) and
`stc007_fused_decode` (K2, one group of lines sharing coordinates). On a
CUDA tensor a wrapper checks its inputs, allocates the outputs and launches
the kernel in csrc/stc007_binarize.cu once: the bit coordinates, the
per-line levels and crc_calc are computed in the kernel, and nothing is
copied between host and device. On a CPU tensor it runs the plain torch
version, binarize.stc007_frame_decode. A kernel that fails to build or
launch raises; there is no fallback to the plain version.
`stc007_ref_sweep_decode` is the reference-level sweep on K1: one launch
per level (the sweep is no kernel of its own in the JAX package either,
but a `lax.scan` inside one compiled program). Given tensors on the
pixels' device it neither copies nor synchronizes, so a CUDA graph can
capture the whole sweep (pipeline/v2d.V2DDriver replays its 64 launches
as one graph launch; ops/round_graph).
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import threading

import torch

from ..formats import stc007
from . import _kernels
from . import binarize as bz

NBITS = stc007.BITS_PCM_DATA  # 128
DEFAULT_TILE_LINES = 32
MAX_TILE_LINES = 32   # one warp per item, one line per lane
# Guards the launch counters: threads on one card (the shards of
# parallel/multichip.py) launch concurrently, and `+=` is not atomic.
_COUNT_LOCK = threading.Lock()
# This thread's CUDA graph capture in progress, if any: its tally.
_DEFERRED = threading.local()


def _count(wrapper):
    tally = getattr(_DEFERRED, "tally", None)
    if tally is not None:
        tally[wrapper] = tally.get(wrapper, 0) + 1
        return
    with _COUNT_LOCK:
        wrapper.launches += 1


@contextlib.contextmanager
def launches_deferred(tally):
    """Inside, this thread's wrapper calls add to `tally` (wrapper ->
    launches) instead of their counters: under a CUDA graph capture a
    wrapper runs but its kernel does not launch. `count_launches` adds
    the tally once per replay of the graph (ops/round_graph.py)."""
    prev = getattr(_DEFERRED, "tally", None)
    _DEFERRED.tally = tally
    try:
        yield tally
    finally:
        _DEFERRED.tally = prev


def count_launches(tally):
    """One replay of a graph whose capture recorded `tally`: each of its
    kernels launched that many times."""
    with _COUNT_LOCK:
        for wrapper, n in tally.items():
            wrapper.launches += n


def _check(cond: bool, msg: str):
    if not cond:
        raise ValueError(msg)


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


@functools.lru_cache(maxsize=None)
def _syndrome_args():
    """binarize.kernel_syndrome_rows as the C call takes them: a pointer to
    the 128 packed rows (held alive by that function's cache) and the two
    constants."""
    rows, synd_const, crc_const = bz.kernel_syndrome_rows()
    return rows.ctypes.data_as(ctypes.c_void_p), synd_const, crc_const


def _levels(t: torch.Tensor, F: int, L: int, device) -> torch.Tensor:
    """Per-frame [F] or per-line [F, L] levels as int32 on `device`: the
    tensor itself (any strides) when it is already that, else a copy."""
    _check(t.shape in ((F,), (F, L)),
           f"levels must be [F] or [F, L], got {tuple(t.shape)}")
    return t.to(device=device, dtype=torch.int32)


def _alloc_outputs(shape, device) -> bz.LineBatch:
    """Uninitialised kernel outputs with leading shape `shape`."""
    words = torch.empty(shape + (stc007.N_WORDS,), dtype=torch.int32,
                        device=device)
    crc_read, crc_calc, hyst, shift = (
        torch.empty(shape, dtype=torch.int32, device=device)
        for _ in range(4))
    valid = torch.empty(shape, dtype=torch.bool, device=device)
    return bz.LineBatch(words=words, crc_read=crc_read, crc_calc=crc_calc,
                        valid=valid, hyst=hyst, shift=shift)


def _launch(entry, pixels, args, hyst_limit, shift_limit, tile_lines,
            synd_table, out=None):
    """Check the inputs of a CUDA call, allocate the outputs and launch the
    kernel once through the C entry point `entry` on pixels [F, L, W]
    (F == 1 for the group entry). `args` are the entry's coordinate and
    level arguments; the caller holds the tensors they point into. `out`
    is a LineBatch of contiguous tensors of leading shape [F, L] to write
    into (the sweep's slice of its [R, ...] outputs) instead of new ones.
    Returns a LineBatch with leading shape [F, L]."""
    device = pixels.device
    _check(pixels.dtype == torch.uint8 and pixels.dim() == 3,
           "pixels must be uint8 [F, L, W]")
    _check(pixels.is_contiguous(), "pixels must be contiguous")
    F, L, W = pixels.shape
    n_h, n_s = hyst_limit + 1, shift_limit + 1
    _check(n_h >= 1 and 1 <= n_s <= len(bz.PIX_SH_BG),
           f"hyst_limit >= 0 and 0 <= shift_limit < {len(bz.PIX_SH_BG)}")
    _check(1 <= tile_lines <= MAX_TILE_LINES,
           f"tile_lines must be in [1, {MAX_TILE_LINES}], got {tile_lines}")
    # The kernel takes the format's syndrome rows by value (ops/binarize.
    # kernel_syndrome_rows); a table handed in is checked, not read.
    _check(synd_table is None or (
        synd_table.dtype == torch.int32 and synd_table.device == device
        and tuple(synd_table.shape) == (NBITS, 16)),
        "synd_table must be int32 [128, 16] on the pixels' device")
    rows, synd_const, crc_const = _syndrome_args()

    if out is None:
        out = _alloc_outputs((F, L), device)
    words, crc_read, crc_calc, valid, hyst, shift = out

    lib = _kernels.load("stc007_binarize")
    frame_args = () if entry == "stc007_binarize_group" else (F,)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, entry)(
            _ptr(pixels), *args, rows, synd_const, crc_const, *frame_args, L, W, n_h, n_s, tile_lines,
            _ptr(words), _ptr(crc_read), _ptr(crc_calc), _ptr(valid),
            _ptr(hyst), _ptr(shift), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(
            f"{entry} launch failed: CUDA error {rc} "
            f"({lib.stc007_error_string(rc).decode()}); F={F} L={L} W={W} "
            f"n_h={n_h} n_s={n_s} tile_lines={tile_lines}")
    return out


def _launch_frames(pixels, coords, ref_level, black, white, hyst_limit,
                   shift_limit, tile_lines, synd_table, out=None):
    """One launch of K1 on CUDA pixels [F, L, W]; counts it."""
    F, L, _ = pixels.shape
    device = pixels.device
    levels = [_levels(t, F, L, device) for t in (ref_level, black, white)]
    args = [_ptr(coords), int(coords.dtype == torch.int64), *coords.stride()]
    for t in levels:   # element (f, l) at f * stride(0) + l * line stride
        args += [_ptr(t), t.stride(0), t.stride(1) if t.dim() == 2 else 0]
    batch = _launch("stc007_binarize_frames", pixels, args, hyst_limit,
                    shift_limit, tile_lines, synd_table, out)
    _count(stc007_fused_decode_frames)
    return batch


def _frames_inputs(pixels, coords):
    """Shape checks shared by K1's callers; coords on the pixels' device
    as int32 or int64."""
    _check(pixels.device.type == "cuda",
           f"unsupported device {pixels.device}")
    _check(pixels.dim() == 3, "pixels must be uint8 [F, L, W]")
    _check(tuple(coords.shape) == (pixels.shape[0], 2),
           "coords must be [F, 2]")
    coords = coords.to(pixels.device)
    if coords.dtype not in (torch.int32, torch.int64):
        coords = coords.to(torch.int32)
    return coords


def stc007_fused_decode_frames(pixels, coords, ref_level, black, white,
                               hyst_limit=4, shift_limit=2,
                               tile_lines=DEFAULT_TILE_LINES, *,
                               synd_table=None, pack_weights=None):
    """Per-frame fused decode (K1): pixels [F, L, W] uint8, coords [F, 2],
    ref/black/white [F] (or per line, [F, L]). `tile_lines` is the number
    of lines (at most 32) a warp stages and reads per item. synd_table and
    pack_weights are the [128, 16] int32 tables of the binarizer on the
    pixels' device (StreamDecoder's buffers), used by the plain version.

    Returns a LineBatch with leading shape [F, L] (mirrors
    bz.stc007_frame_decode, which it calls for a CPU tensor).
    """
    if pixels.device.type == "cpu":
        return bz.stc007_frame_decode(
            pixels, coords, ref_level, black, white, hyst_limit,
            shift_limit, synd_table=synd_table, pack_weights=pack_weights)
    coords = _frames_inputs(pixels, coords)
    return _launch_frames(pixels, coords, ref_level, black, white,
                          hyst_limit, shift_limit, tile_lines, synd_table)


def stc007_ref_sweep_decode(pixels, coords, black, white, ref_levels,
                            hyst_limit=bz.HYST_DEPTH_MAX,
                            shift_limit=bz.SHIFT_STAGES_MAX,
                            tile_lines=DEFAULT_TILE_LINES):
    """Reference-level sweep through K1: one launch per level, each with
    that level as every frame's reference (a stride-0 view of the level
    tensor), written into slice r of the [R, ...] outputs. Nothing is
    copied between host and device and nothing synchronizes when the
    arguments are tensors on the pixels' device (ref_levels given as a
    host array is uploaded once, before the first launch): the checks
    read shapes only and the outputs come from the caching allocator, so
    the call can be captured whole into a CUDA graph, whose replay counts
    R launches (launches_deferred / count_launches).

    Arguments and result as binarize.stc007_ref_sweep_decode, the plain
    version, which runs for a CPU tensor.
    """
    if pixels.device.type == "cpu":
        return bz.stc007_ref_sweep_decode(pixels, coords, black, white,
                                          ref_levels, hyst_limit,
                                          shift_limit)
    coords = _frames_inputs(pixels, coords)
    F, L, _ = pixels.shape
    device = pixels.device
    levels = torch.as_tensor(ref_levels).to(device=device,
                                            dtype=torch.int32)
    _check(levels.dim() == 1, "ref_levels must be [R]")
    _check(tuple(black.shape) == (F,) and tuple(white.shape) == (F,),
           "black and white must be [F]")
    black, white = (t.to(device=device, dtype=torch.int32)
                    for t in (black, white))   # once, not per launch
    R = levels.shape[0]
    # K1 also writes crc_calc [R, F, L], which the sweep's result drops.
    out = _alloc_outputs((R, F, L), device)
    for r in range(R):
        _launch_frames(
            pixels, coords, levels[r].expand(F), black, white, hyst_limit,
            shift_limit, tile_lines, None,
            out=bz.LineBatch(*(t[r] for t in out)))
    return dict(valid=out.valid, crc=out.crc_read, hyst=out.hyst,
                shift=out.shift, words=out.words)


def stc007_fused_decode(pixels, coords, ref_level, black, white,
                        hyst_limit=4, shift_limit=2,
                        tile_lines=DEFAULT_TILE_LINES, *, synd_table=None,
                        pack_weights=None):
    """Fused decode of one group of lines sharing coordinates (K2):
    pixels [L, W] uint8, coords (start, stop) as Python ints or 0-d
    tensors, ref/black/white [L] int32 per line. The tables are as for
    stc007_fused_decode_frames.

    Returns a LineBatch with leading shape [L]. Its plain version, run for a
    CPU tensor, is bz.stc007_frame_decode over one frame.
    """
    _check(pixels.dim() == 2, "pixels must be [L, W]")
    L = pixels.shape[0]
    start, stop = int(coords[0]), int(coords[1])
    for t in (ref_level, black, white):
        _check(tuple(t.shape) == (L,), f"levels must be [L], got "
               f"{tuple(t.shape)}")
    if pixels.device.type == "cpu":
        cd = torch.tensor([[start, stop]], dtype=torch.int32)
        batch = bz.stc007_frame_decode(
            pixels[None], cd, ref_level[None], black[None], white[None],
            hyst_limit, shift_limit, synd_table=synd_table,
            pack_weights=pack_weights)
        return bz.LineBatch(*(t[0] for t in batch))
    _check(pixels.device.type == "cuda",
           f"unsupported device {pixels.device}")
    levels = [t.to(device=pixels.device, dtype=torch.int32)
              for t in (ref_level, black, white)]
    args = [start, stop]
    for t in levels:
        args += [_ptr(t), t.stride(0)]
    batch = _launch("stc007_binarize_group", pixels[None], args,
                    hyst_limit, shift_limit, tile_lines, synd_table)
    _count(stc007_fused_decode)
    return bz.LineBatch(*(t[0] for t in batch))


# Kernel launches so far (a run resets them to 0 and reads them after).
stc007_fused_decode_frames.launches = 0
stc007_fused_decode.launches = 0
