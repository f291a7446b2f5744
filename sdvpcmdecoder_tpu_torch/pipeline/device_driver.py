"""Chip-resident STC-007 round: its row-map geometry and its carried state.

Port of the round-level part of sdvpcmdecoder_tpu/pipeline/device_driver.py:
`_RoundRows` (numpy geometry of one round, its tensors on an explicit
device) and `run_round`, which issues one ops.device_stitch.
steady_round_packed call and hands on the state the next round needs (the
driver's `_dispatch`, device_driver.py:358-473 in the JAX package, without
the host stitcher around it). The driver classes that stage captures and
replay rounds through the stitcher come with the stitcher's port.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..formats import stc007
from ..ops import device_stitch as ds

KEEP = ds.KEEP          # 120
MDD = stc007.MIN_DEINT_DATA


class _RoundRows:
    """Row maps for one round geometry, put on `device` once.

    Layout of the combined words buffer (steady_round_dispatch):
    [prev frame (Ls rows) | round frames (F*Ls) | carry (112) | silent].
    """

    def __init__(self, F, lpf, n0, padI, padO, target, tff, *, device):
        Ls = 2 * lpf
        carry_ofs = (F + 1) * Ls
        sil = carry_ofs + MDD
        c1 = min(lpf, target)
        c2 = min(lpf, target)
        # n0 only shapes pair 0's carry rows; pairs >= 1 assume the
        # steady 112-row carry (verified per pair at replay).
        self.geom = (c1, c2, padI, padO, tff, target)
        self.lpf = lpf

        def fields(j):
            o = (j + 1) * Ls
            odd = np.arange(o, o + lpf, dtype=np.int64)
            even = np.arange(o + lpf, o + Ls, dtype=np.int64)
            return (odd, even) if tff else (even, odd)

        def blocks(queue):
            B = len(queue) - MDD
            pos = (np.arange(B, dtype=np.int64)[:, None]
                   + stc007.INTERLEAVE_OFS
                   * np.arange(8, dtype=np.int64)[None, :])
            return queue[pos]

        pad_i = np.full(padI, sil, np.int64)
        pad_o = np.full(padO, sil, np.int64)
        # g1 layout: ALL conv blocks first (their packed evals and
        # selected samples are read back), then the seam queues (inner,
        # outer per pair) padded to B_MAX blocks -- their burst stats are
        # reduced on the device, only [F, 2, 4] counters return.
        g_conv, g_seam, meta1, ofs = [], [], [], 0
        nb_seam = np.zeros(2 * F, np.int32)
        head = min(lpf, KEEP)
        len1 = min(lpf, KEEP - padI)
        len1o = min(lpf, KEEP - padO)

        def seam_blocks(queue):
            b = blocks(queue) if len(queue) > MDD \
                else np.zeros((0, 8), np.int64)
            full = np.full((ds.B_MAX, 8), sil, np.int64)
            full[:min(b.shape[0], ds.B_MAX)] = b[:ds.B_MAX]
            return full, b.shape[0]

        for i in range(F):
            f1, f2 = fields(i - 1)
            fb1 = fields(i)[0]
            inner = np.concatenate([f1[lpf - len1:], pad_i, f2[:head]])
            outer = np.concatenate([f2[lpf - len1o:], pad_o, fb1[:head]])
            bi, nbi = seam_blocks(inner)
            bo, nbo = seam_blocks(outer)
            g_seam += [bi, bo]
            nb_seam[2 * i], nb_seam[2 * i + 1] = nbi, nbo
            tail = np.concatenate([f1[:c1], pad_i, f2[:c2], pad_o])
            if i == 0:
                carry = np.arange(carry_ofs, carry_ofs + n0,
                                  dtype=np.int64)
            else:
                p1, p2 = fields(i - 2)
                prev_tail = np.concatenate(
                    [p1[:c1], pad_i, p2[:c2], pad_o])
                carry = prev_tail[-MDD:]
            conv = np.concatenate([carry, tail])
            b = blocks(conv)
            meta1.append({"conv": (ofs, b.shape[0]),
                          "inner_nb": nbi, "outer_nb": nbo})
            g_conv.append(b)
            ofs += b.shape[0]
        g1 = g_conv + g_seam
        self.nb_seam = torch.as_tensor(nb_seam, device=device)
        self.B_conv = ofs
        # The NEXT round's chained pair-0 carry rows: the carry formula
        # at "pair F" (fields(F-2); fields(-1) = this round's prev slot
        # when F == 1) -- lets steady chains skip the carry upload.
        np1, np2 = fields(F - 2) if F >= 2 else fields(-1)
        next_tail = np.concatenate([np1[:c1], pad_i, np2[:c2], pad_o])
        self.can_chain = len(next_tail) >= MDD
        self.carry_next_rows = torch.as_tensor(
            (next_tail[-MDD:] if self.can_chain
             else np.zeros(MDD, np.int64)).astype(np.int32), device=device)
        g2, meta2, ofs2 = [], [], 0
        for i in range(F):
            o = (i + 1) * Ls
            m = {}
            for key, lo in (("res_odd", 0), ("res_even", lpf)):
                if lpf > MDD:
                    q = np.arange(o + lo, o + lo + lpf, dtype=np.int64)
                    b = blocks(q)
                    m[key] = (ofs2, b.shape[0])
                    g2.append(b)
                    ofs2 += b.shape[0]
                else:
                    m[key] = (ofs2, 0)
            meta2.append(m)
        self.meta1, self.meta2 = meta1, meta2
        self.g1 = torch.as_tensor(np.concatenate(g1).astype(np.int32),
                                  device=device)
        # A round with lpf <= 112 has no resolution queue: a one-block
        # placeholder keeps the round's shapes non-empty.
        self.g2 = torch.as_tensor(
            np.concatenate(g2).astype(np.int32) if g2
            else np.zeros((1, 8), np.int32), device=device)
        # conv blocks lead the g1 layout, so the packed round's samples
        # section is just packed1[:B_conv]'s blocks in order.
        self.meta_conv = [m["conv"] for m in meta1]
        self.B1 = int(self.g1.shape[0])
        self.Bc = self.B_conv
        self.B2 = int(self.g2.shape[0])


class RoundState(NamedTuple):
    """What one round hands to the next, on the device: the last frame's
    words and line-ok flags (the next round's prev slot) and the chained
    pair-0 carry."""
    prev_words: torch.Tensor   # [Ls, 8] int32
    prev_ok8: torch.Tensor     # [Ls, 8] bool
    carry_w: torch.Tensor      # [112, 8] int32
    carry_ok: torch.Tensor     # [112, 8] bool

    @classmethod
    def from_numpy(cls, prev_words, prev_ok8, carry_w, carry_ok, device):
        """State from host arrays (a JAX round's inputs, or zeros for a
        capture's first round)."""
        return cls(*(torch.as_tensor(np.asarray(a, dt), device=device)
                     for a, dt in ((prev_words, np.int32),
                                   (prev_ok8, bool), (carry_w, np.int32),
                                   (carry_ok, bool))))

    @classmethod
    def zeros(cls, Ls, device):
        return cls.from_numpy(np.zeros((Ls, 8)), np.zeros((Ls, 8)),
                              np.zeros((MDD, 8)), np.zeros((MDD, 8)),
                              device)


def run_round(pixels, params, state: RoundState, rows: _RoundRows, *,
              en_p, en_q, m2, hyst_limit, shift_limit, use_kernel,
              chained, tables):
    """One steady round on the pixels' device: params is the round's int32
    parameter vector (ds.round_param_layout; numpy or a tensor), tables a
    ds.RoundTables on that device. Returns (out [N] int32 buffer,
    words_flat [F*Ls, 8], the next round's RoundState)."""
    params = torch.as_tensor(params, dtype=torch.int32, device=pixels.device)
    out, wflat, wtail, oktail, cn_w, cn_ok = ds.steady_round_packed(
        pixels, params, state.prev_words, state.prev_ok8, state.carry_w,
        state.carry_ok, rows.carry_next_rows, rows.g1, rows.g2,
        rows.nb_seam, tables.silent(m2), B_conv=rows.B_conv, en_p=en_p,
        en_q=en_q, m2=m2, hyst_limit=hyst_limit, shift_limit=shift_limit,
        use_kernel=use_kernel, chained=chained, tables=tables)
    return out, wflat, RoundState(wtail, oktail, cn_w, cn_ok)
