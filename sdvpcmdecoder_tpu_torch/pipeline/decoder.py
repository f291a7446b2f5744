"""End-to-end STC-007 stream decoder: pixels -> stereo int16 samples.

Port of sdvpcmdecoder_tpu/pipeline/decoder.py. The chain is the
reference's VideoToDigital -> Binarizer -> STC007Deinterleaver for a
continuous line stream with known coordinates and levels:

  pixels [F, L, W] -> trial-grid binarize (CUDA kernel on a GPU)
                   -> 16-line deinterleave -> P/Q erasure ECC -> samples

`StreamDecoder` holds the chain's constant tables (the CRC syndrome table,
the bit-pack weights and the stacked Q-solve banks) as buffers, so
`.to(device)` moves them once; `decode_frames` builds one on the pixels'
device for a single call.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from ..formats import stc007
from ..ops import binarize as bz
from ..ops import deinterleave as di
from ..ops import fused_binarize as fb


class DecodeResult(NamedTuple):
    samples: torch.Tensor       # [n_samples, 2] int16 stereo
    sample_valid: torch.Tensor  # [n_samples, 2] bool (word valid after ECC)
    line_valid: torch.Tensor    # [L] bool CRC per line
    block_state: torch.Tensor   # [B] int32 AUD_* per block


def _stereo(blocks: di.BlockBatch, n_blocks: int, m2: bool):
    """Block b yields stereo pairs (3b, 3b+1, 3b+2): (L0,R0),(L1,R1),(L2,R2)."""
    samples6 = di.block_samples(blocks, m2=m2)               # [B, 6]
    return (samples6.reshape(n_blocks * 3, 2),
            blocks.valid[:, :6].reshape(n_blocks * 3, 2))


def decode_stream(pixels, coords, ref_level, black, white,
                  hyst_limit=4, shift_limit=2,
                  res_mode=di.RES_MODE_14BIT, m2=False, use_kernel=None):
    """Per-line decode: lines -> samples.

    pixels [L, W] uint8, coords [L, 2] int32, ref/black/white [L] int32.
    Number of blocks = L - 112.

    use_kernel (default: True on a CUDA tensor) binarizes through K1
    (ops/fused_binarize) with every line a frame of its own, [L, 1, W]
    with per-line coordinates and levels; False runs the plain per-line
    grid, bz.stc007_read_pcm_grid, as the JAX package does.
    """
    if use_kernel is None:
        use_kernel = pixels.device.type == "cuda"
    if use_kernel:
        batch = bz.LineBatch(*(t[:, 0] for t in fb.stc007_fused_decode_frames(
            pixels[:, None], coords, ref_level, black, white,
            hyst_limit=hyst_limit, shift_limit=shift_limit)))
    else:
        batch = bz.stc007_read_pcm_grid(pixels, coords, ref_level, black,
                                        white, hyst_limit=hyst_limit,
                                        shift_limit=shift_limit)
    crc_ok = batch.valid[:, None].expand(-1, stc007.N_WORDS)
    n_blocks = pixels.shape[0] - stc007.MIN_DEINT_DATA
    shifts = torch.arange(n_blocks, dtype=torch.int32, device=pixels.device)
    blocks = di.deinterleave(batch.words, crc_ok, shifts, res_mode=res_mode)
    stereo, svalid = _stereo(blocks, n_blocks, m2)
    return DecodeResult(stereo, svalid, batch.valid, blocks.audio_state)


class StreamDecoder(nn.Module):
    """Frame-grouped production path with its constant tables as buffers.

    forward(pixels [F, Lf, W] uint8, coords [F, 2], ref/black/white [F] or
    [F, Lf]) -> DecodeResult. Lines are temporally contiguous across
    frames; the deinterleaver runs over the flattened stream.

    use_kernel=True binarizes with ops.fused_binarize (the CUDA kernel for
    a CUDA tensor, its plain torch version for a CPU tensor);
    use_kernel=False calls the plain version directly.
    """

    def __init__(self, hyst_limit=4, shift_limit=2,
                 res_mode=di.RES_MODE_14BIT, m2=False, use_kernel=True):
        super().__init__()
        self.hyst_limit = hyst_limit
        self.shift_limit = shift_limit
        self.res_mode = res_mode
        self.m2 = m2
        self.use_kernel = use_kernel
        synd_table, _ = bz._syndrome_const()
        q_a, q_b = di._q_solve_banks_stacked()
        self.register_buffer("synd_table", torch.as_tensor(synd_table))
        self.register_buffer("pack_weights",
                             torch.as_tensor(bz._pack_weights()))
        self.register_buffer("q_bank_a",
                             torch.as_tensor(q_a, dtype=torch.int32))
        self.register_buffer("q_bank_b",
                             torch.as_tensor(q_b, dtype=torch.int32))

    def forward(self, pixels, coords, ref_level, black, white):
        binarize = fb.stc007_fused_decode_frames if self.use_kernel \
            else bz.stc007_frame_decode
        batch = binarize(pixels, coords, ref_level, black, white,
                         self.hyst_limit, self.shift_limit,
                         synd_table=self.synd_table,
                         pack_weights=self.pack_weights)
        F, Lf, _ = pixels.shape
        L = F * Lf
        words = batch.words.reshape(L, stc007.N_WORDS)
        valid = batch.valid.reshape(L)
        crc_ok = valid[:, None].expand(-1, stc007.N_WORDS)
        n_blocks = L - stc007.MIN_DEINT_DATA
        q_banks = (self.q_bank_a, self.q_bank_b)

        def run(res):
            # Consecutive shifts -> contiguous-slice assembly.
            w, c = di.assemble_blocks_contiguous(words, crc_ok, n_blocks, res)
            return di.correct_blocks(w, c, res, q_banks=q_banks)

        if self.res_mode == di.RES_MODE_14BIT:
            blocks = run(di.RES_14BIT)
        elif self.res_mode == di.RES_MODE_16BIT:
            blocks = run(di.RES_16BIT)
        else:
            first = di.RES_14BIT if self.res_mode == di.RES_MODE_14BIT_AUTO \
                else di.RES_16BIT
            blocks = di.select_auto(run(first), run(1 - first))
        stereo, svalid = _stereo(blocks, n_blocks, self.m2)
        return DecodeResult(stereo, svalid, valid, blocks.audio_state)


def decode_frames(pixels, coords, ref_level, black, white,
                  hyst_limit=4, shift_limit=2,
                  res_mode=di.RES_MODE_14BIT, m2=False, use_kernel=True):
    """One call of the frame-grouped path (see StreamDecoder): pixels
    [F, Lf, W], coords [F, 2], ref/black/white [F], on the pixels'
    device."""
    dec = StreamDecoder(hyst_limit, shift_limit, res_mode, m2, use_kernel)
    return dec.to(pixels.device)(pixels, coords, ref_level, black, white)


def decode_to_numpy(pixels, coords, black=20, white=200, ref_level=None,
                    device="cuda", **kw):
    """Host convenience wrapper around decode_stream on `device` (auto
    centre reference level). Returns numpy arrays."""
    L = pixels.shape[0]
    blk = torch.full((L,), black, dtype=torch.int32, device=device)
    wht = torch.full((L,), white, dtype=torch.int32, device=device)
    if ref_level is None:
        ref, _ = bz.pick_center_ref_level(blk, wht)
    else:
        ref = torch.full((L,), ref_level, dtype=torch.int32, device=device)
    res = decode_stream(torch.as_tensor(np.asarray(pixels), device=device),
                        torch.as_tensor(np.asarray(coords),
                                        dtype=torch.int32, device=device),
                        ref, blk, wht, **kw)
    return tuple(t.cpu().numpy() for t in res)
