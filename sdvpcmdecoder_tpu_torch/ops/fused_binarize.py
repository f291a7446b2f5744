"""Fused STC-007 trial-grid binarize: the hand-written CUDA kernel's wrappers.

Counterparts of the two Pallas kernels of
sdvpcmdecoder_tpu/ops/pallas_binarize.py: `stc007_fused_decode_frames`
(K1, frames [F, L, W] with per-frame coordinates) and
`stc007_fused_decode` (K2, one group of lines sharing coordinates). On a
CUDA tensor a wrapper launches the kernel in csrc/stc007_binarize.cu; on a
CPU tensor it runs the plain torch version, binarize.stc007_frame_decode.
A kernel that fails to build or launch raises; there is no fallback to the
plain version.
"""
from __future__ import annotations

import ctypes

import torch

from ..formats import stc007
from . import _kernels
from . import binarize as bz

NBITS = stc007.BITS_PCM_DATA  # 128
DEFAULT_TILE_LINES = 32


def _check(cond: bool, msg: str):
    if not cond:
        raise ValueError(msg)


def _levels(t: torch.Tensor, F: int, L: int, device) -> torch.Tensor:
    """Per-frame [F] or per-line [F, L] levels -> contiguous [F, L] int32."""
    _check(t.shape in ((F,), (F, L)),
           f"levels must be [F] or [F, L], got {tuple(t.shape)}")
    t = t.to(device=device, dtype=torch.int32)
    return (t[:, None].expand(F, L) if t.dim() == 1 else t).contiguous()


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _launch(entry, pixels, coords, ref_level, black, white, hyst_limit,
            shift_limit, tile_lines, synd_table):
    """Check the inputs of a CUDA call and launch the kernel through the C
    entry point `entry` on pixels [F, L, W] (F == 1 for the group entry).
    Returns a LineBatch with leading shape [F, L]."""
    device = pixels.device
    _check(device.type == "cuda", f"unsupported device {device}")
    _check(pixels.dtype == torch.uint8 and pixels.dim() == 3,
           "pixels must be uint8 [F, L, W]")
    _check(pixels.is_contiguous(), "pixels must be contiguous")
    F, L, W = pixels.shape
    _check(tuple(coords.shape) == (F, 2), "coords must be [F, 2]")
    n_h, n_s = hyst_limit + 1, shift_limit + 1
    _check(n_h >= 1 and 1 <= n_s <= len(bz.PIX_SH_BG),
           f"hyst_limit >= 0 and 0 <= shift_limit < {len(bz.PIX_SH_BG)}")
    table_np, const = bz._syndrome_const()
    if synd_table is None:
        synd_table = torch.as_tensor(table_np, device=device)
    _check(synd_table.dtype == torch.int32 and synd_table.device == device
           and tuple(synd_table.shape) == (NBITS, 16)
           and synd_table.is_contiguous(),
           "synd_table must be contiguous int32 [128, 16] on the pixels' "
           "device")
    pos = bz.stc007_frame_bit_coords(coords.to(device), n_s, W).contiguous()
    ref_l = _levels(ref_level, F, L, device)
    black_l = _levels(black, F, L, device)
    white_l = _levels(white, F, L, device)

    words = torch.empty((F, L, stc007.N_WORDS), dtype=torch.int32,
                        device=device)
    crc_read = torch.empty((F, L), dtype=torch.int32, device=device)
    valid = torch.empty((F, L), dtype=torch.bool, device=device)
    hyst = torch.empty((F, L), dtype=torch.int32, device=device)
    shift = torch.empty((F, L), dtype=torch.int32, device=device)

    lib = _kernels.load("stc007_binarize")
    frame_args = () if entry == "stc007_binarize_group" else (F,)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, entry)(
            _ptr(pixels), _ptr(pos), _ptr(ref_l), _ptr(black_l),
            _ptr(white_l), _ptr(synd_table), const, *frame_args, L, W, n_h,
            n_s, tile_lines, _ptr(words), _ptr(crc_read), _ptr(valid),
            _ptr(hyst), _ptr(shift), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(
            f"{entry} launch failed: CUDA error {rc} "
            f"({lib.stc007_error_string(rc).decode()}); F={F} L={L} W={W} "
            f"n_h={n_h} n_s={n_s} tile_lines={tile_lines}")
    return bz.LineBatch(words=words, crc_read=crc_read,
                        crc_calc=stc007.calc_crc(words), valid=valid,
                        hyst=hyst, shift=shift)


def stc007_fused_decode_frames(pixels, coords, ref_level, black, white,
                               hyst_limit=4, shift_limit=2,
                               tile_lines=DEFAULT_TILE_LINES, *,
                               synd_table=None, pack_weights=None):
    """Per-frame fused decode (K1): pixels [F, L, W] uint8, coords [F, 2],
    ref/black/white [F] (or per line, [F, L]). `tile_lines` is the number
    of lines a CUDA block stages in shared memory. synd_table and
    pack_weights are the [128, 16] int32 tables of the binarizer on the
    pixels' device (StreamDecoder's buffers; built when not given).

    Returns a LineBatch with leading shape [F, L] (mirrors
    bz.stc007_frame_decode, which it calls for a CPU tensor).
    """
    if pixels.device.type == "cpu":
        return bz.stc007_frame_decode(
            pixels, coords, ref_level, black, white, hyst_limit,
            shift_limit, synd_table=synd_table, pack_weights=pack_weights)
    batch = _launch("stc007_binarize_frames", pixels, coords, ref_level,
                    black, white, hyst_limit, shift_limit, tile_lines,
                    synd_table)
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
    cd = torch.tensor([[int(coords[0]), int(coords[1])]], dtype=torch.int32,
                      device=pixels.device)
    levels = []
    for t in (ref_level, black, white):
        _check(tuple(t.shape) == (L,), f"levels must be [L], got "
               f"{tuple(t.shape)}")
        levels.append(t[None])
    if pixels.device.type == "cpu":
        batch = bz.stc007_frame_decode(
            pixels[None], cd, *levels, hyst_limit, shift_limit,
            synd_table=synd_table, pack_weights=pack_weights)
    else:
        batch = _launch("stc007_binarize_group", pixels[None], cd, *levels,
                        hyst_limit, shift_limit, tile_lines, synd_table)
        stc007_fused_decode.launches += 1
    return bz.LineBatch(*(t[0] for t in batch))


# Kernel launches so far (a run resets them to 0 and reads them after).
stc007_fused_decode_frames.launches = 0
stc007_fused_decode.launches = 0
