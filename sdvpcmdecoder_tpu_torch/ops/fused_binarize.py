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
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..formats import stc007
from . import _kernels
from . import binarize as bz

NBITS = stc007.BITS_PCM_DATA  # 128
DEFAULT_TILE_LINES = 32
MAX_TILE_LINES = 32   # one warp per item, one line per lane


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


def _launch(entry, pixels, args, hyst_limit, shift_limit, tile_lines,
            synd_table):
    """Check the inputs of a CUDA call, allocate the outputs and launch the
    kernel once through the C entry point `entry` on pixels [F, L, W]
    (F == 1 for the group entry). `args` are the entry's coordinate and
    level arguments; the caller holds the tensors they point into.
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

    shape = (F, L)
    words = torch.empty(shape + (stc007.N_WORDS,), dtype=torch.int32,
                        device=device)
    crc_read, crc_calc, hyst, shift = (
        torch.empty(shape, dtype=torch.int32, device=device)
        for _ in range(4))
    valid = torch.empty(shape, dtype=torch.bool, device=device)

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
    return bz.LineBatch(words=words, crc_read=crc_read, crc_calc=crc_calc,
                        valid=valid, hyst=hyst, shift=shift)


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
    _check(pixels.device.type == "cuda",
           f"unsupported device {pixels.device}")
    _check(pixels.dim() == 3, "pixels must be uint8 [F, L, W]")
    F, L, _ = pixels.shape
    device = pixels.device
    _check(tuple(coords.shape) == (F, 2), "coords must be [F, 2]")
    coords = coords.to(device)
    if coords.dtype not in (torch.int32, torch.int64):
        coords = coords.to(torch.int32)
    levels = [_levels(t, F, L, device) for t in (ref_level, black, white)]
    args = [_ptr(coords), int(coords.dtype == torch.int64), *coords.stride()]
    for t in levels:   # element (f, l) at f * stride(0) + l * line stride
        args += [_ptr(t), t.stride(0), t.stride(1) if t.dim() == 2 else 0]
    batch = _launch("stc007_binarize_frames", pixels, args, hyst_limit,
                    shift_limit, tile_lines, synd_table)
    stc007_fused_decode_frames.launches += 1
    return batch


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
    stc007_fused_decode.launches += 1
    return bz.LineBatch(*(t[0] for t in batch))


# Kernel launches so far (a run resets them to 0 and reads them after).
stc007_fused_decode_frames.launches = 0
stc007_fused_decode.launches = 0
