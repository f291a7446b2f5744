"""End-to-end STC-007 stream decoder: pixels -> stereo int16 samples.

Port of sdvpcmdecoder_tpu/pipeline/decoder.py. The chain is the
reference's VideoToDigital -> Binarizer -> STC007Deinterleaver for a
continuous line stream with known coordinates and levels:

  pixels [F, L, W] -> trial-grid binarize (CUDA kernel on a GPU)
                   -> 16-line deinterleave -> P/Q erasure ECC -> samples

`StreamDecoder` holds the chain's constant tables (the CRC syndrome table,
the bit-pack weights and the stacked Q-solve banks) as buffers, so
`.to(device)` moves them once.

The JAX package jits both entry points (`decode_stream`, `decode_frames`)
with their limits, resolution mode and M2 flag static. Here each call
replays as a CUDA graph (ops/round_graph.RoundGraphs; the CPU's stand-in
on the CPU) keyed by those static arguments and the input shapes: a
key's first call runs eagerly, its second captures, later calls replay.
Both replay from the calling thread's holder on the pixels' device
(round_graph.thread_graphs), and `decode_frames` keeps one StreamDecoder
per device and static arguments, so repeated calls replay; graphs=False
runs eagerly.
"""
from __future__ import annotations

import functools
import threading
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from ..formats import stc007
from ..ops import binarize as bz
from ..ops import deinterleave as di
from ..ops import fused_binarize as fb
from ..ops.round_graph import call, thread_graphs

# The decoders decode_frames keeps in this thread: (device, static
# arguments) -> StreamDecoder.
_HELD = threading.local()


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


def _decode_stream(pixels, coords, ref_level, black, white, hyst_limit,
                   shift_limit, res_mode, m2, use_kernel):
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


def decode_stream(pixels, coords, ref_level, black, white,
                  hyst_limit=4, shift_limit=2,
                  res_mode=di.RES_MODE_14BIT, m2=False, use_kernel=None,
                  graphs=True):
    """Per-line decode: lines -> samples.

    pixels [L, W] uint8, coords [L, 2] int32, ref/black/white [L] int32.
    Number of blocks = L - 112.

    use_kernel (default: True on a CUDA tensor) binarizes through K1
    (ops/fused_binarize) with every line a frame of its own, [L, 1, W]
    with per-line coordinates and levels; False runs the plain per-line
    grid, bz.stc007_read_pcm_grid, as the JAX package does. With graphs
    the call replays from thread_graphs(pixels.device) and the result's
    tensors are copies that later calls do not touch.
    """
    if use_kernel is None:
        use_kernel = pixels.device.type == "cuda"
    static = (hyst_limit, shift_limit, res_mode, m2, use_kernel)
    body = functools.partial(_decode_stream, hyst_limit=hyst_limit,
                             shift_limit=shift_limit, res_mode=res_mode,
                             m2=m2, use_kernel=use_kernel)
    return DecodeResult(*call(
        thread_graphs(pixels.device) if graphs else None,
        ("decode_stream",) + static, body,
        (pixels, coords, ref_level, black, white), pixels.device,
        clone=range(4)))


class StreamDecoder(nn.Module):
    """Frame-grouped production path with its constant tables as buffers.

    forward(pixels [F, Lf, W] uint8, coords [F, 2], ref/black/white [F] or
    [F, Lf]) -> DecodeResult. Lines are temporally contiguous across
    frames; the deinterleaver runs over the flattened stream.

    use_kernel=True binarizes with ops.fused_binarize (the CUDA kernel for
    a CUDA tensor, its plain torch version for a CPU tensor);
    use_kernel=False calls the plain version directly.

    graphs=True replays forward as a CUDA graph from the calling thread's
    RoundGraphs on the pixels' device (round_graph.thread_graphs), keyed
    by the static arguments, the input shapes and the addresses of the
    buffers the graph reads; the result's tensors are copies that later
    calls do not touch. graphs=False runs the ops eagerly.
    """

    def __init__(self, hyst_limit=4, shift_limit=2,
                 res_mode=di.RES_MODE_14BIT, m2=False, use_kernel=True,
                 graphs=True):
        super().__init__()
        self.hyst_limit = hyst_limit
        self.shift_limit = shift_limit
        self.res_mode = res_mode
        self.m2 = m2
        self.use_kernel = use_kernel
        self.graphs = graphs
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
        key = ("StreamDecoder.forward", self.hyst_limit, self.shift_limit,
               self.res_mode, self.m2, self.use_kernel,
               tuple(b.data_ptr() for b in self.buffers()))
        return DecodeResult(*call(
            thread_graphs(pixels.device) if self.graphs else None, key,
            self._forward, (pixels, coords, ref_level, black, white),
            pixels.device, clone=range(4)))

    def _forward(self, pixels, coords, ref_level, black, white):
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
                  res_mode=di.RES_MODE_14BIT, m2=False, use_kernel=True,
                  graphs=True):
    """One call of the frame-grouped path (see StreamDecoder): pixels
    [F, Lf, W], coords [F, 2], ref/black/white [F], on the pixels'
    device. With graphs, through this thread's StreamDecoder for these
    static arguments on that device, replaying from
    thread_graphs(pixels.device)."""
    static = (hyst_limit, shift_limit, res_mode, m2, use_kernel)
    if not graphs:
        dec = StreamDecoder(*static, graphs=False).to(pixels.device)
        return dec(pixels, coords, ref_level, black, white)
    if not hasattr(_HELD, "decoders"):
        _HELD.decoders = {}
    key = (pixels.device,) + static
    if key not in _HELD.decoders:
        _HELD.decoders[key] = StreamDecoder(*static).to(pixels.device)
    return _HELD.decoders[key](pixels, coords, ref_level, black, white)


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
