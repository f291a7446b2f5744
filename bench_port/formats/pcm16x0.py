"""PCM-16x0 SI (Sony PCM-1600/1610) captures: the generator and the plain
reference decoder.

Generator, a frozen copy of chip_smoke.write_pcm16x0_capture with the
tables it takes from formats/pcm16x0 and ops/pcm16x0_deint: each field of
an NTSC frame carries its own 16-bit samples, 735 pairs, interleaved SI
(a block takes the sublines i, i + 35, i + 70 of a 105-subline group,
its three sub-blocks' L, R and P = L ^ R spread over them in an order
that alternates from block to block); three sublines of 3 words and a
CRC-16 make a 193-bit line (control bit 1 between the second and third),
rendered at `ppb` pixels a bit, field 1 on the even rows.

Reference: each bit cell's inner pixels averaged and cut at the middle of
black and white, the sublines' CRCs checked, the blocks gathered, one
erased word of a sub-block restored by P, a sub-block whose parity fails
with no word erased marked broken, and the samples of every word read or
restored marked valid. Nothing here is imported from the port.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import media as sg

BITS = 16
N_BITS = 193
PARTS = (0, 64, 129)        # first line bit of the three sublines
OFS = 35                    # SI interleave offset in sublines
GROUP = 3 * OFS
# The subline (0..2 of a block) that carries L, R of sub-block k in a
# block of odd order; P always rides on the middle one; even order swaps.
_ODD = {(0, 0): 2, (0, 1): 0, (1, 0): 0, (1, 1): 2, (2, 0): 2, (2, 1): 0}


def _line(even: bool, blk: int, word: int) -> int:
    if word == 2:
        return 1
    return 2 - _ODD[(blk, word)] if even else _ODD[(blk, word)]


def _layout(n_sub: int):
    """For every pair of a field: (subline, column) of its L, R and P words,
    [n_pairs, 3] each, in the pairs' order."""
    rows, cols = [], []
    for g in range(n_sub // GROUP):
        for i in range(OFS):
            even = i % 2 == 1
            sub = [g * GROUP + i + k * OFS for k in range(3)]
            for blk in range(3):
                rows.append([sub[_line(even, blk, w)] for w in range(3)])
                cols.append([blk] * 3)
    return np.array(rows, np.int64), np.array(cols, np.int64)


def field_pairs(lines_per_field: int) -> int:
    return (3 * lines_per_field // GROUP) * GROUP


# -- generator --------------------------------------------------------------
def encode_field(left, right, lines_per_field: int):
    """One field's pairs -> its line bits [lines, 193]."""
    n_sub = 3 * lines_per_field
    sub = np.zeros((n_sub, 3), np.int64)
    rows, cols = _layout(n_sub)
    for w, val in enumerate((left, right, left ^ right)):
        sub[rows[:, w], cols[:, w]] = val
    crc = sg.crc16(sg.to_bits(sub, BITS).reshape(n_sub, 3 * BITS))
    part = np.concatenate([sg.to_bits(sub, BITS).reshape(n_sub, -1),
                           sg.to_bits(crc, 16)], 1).reshape(
        lines_per_field, 3, 64)
    ctrl = np.ones((lines_per_field, 1), np.uint8)
    return np.concatenate([part[:, 0], part[:, 1], ctrl, part[:, 2]], 1)


def make_capture(cfg, n_frames: int, rng, gen, device, noise=0.0,
                 bursts=(), burst_levels=(5, 60)):
    """One capture: (frames [F, 2 lpf, W] u8 on the host, truth dict)."""
    sig = cfg["signal"]
    lpf, W = sig["lines_per_field"], sig["width"]
    L = 2 * lpf
    n = field_pairs(lpf)
    left = rng.integers(1, 1 << BITS, (n_frames, 2, n))
    right = rng.integers(1, 1 << BITS, (n_frames, 2, n))
    bits = np.stack([encode_field(left[f, h], right[f, h], lpf)
                     for f in range(n_frames) for h in range(2)])
    bits = torch.from_numpy(bits.reshape(-1, N_BITS)).to(device)
    vals = sg.render(bits, W, sig["ppb"], sig["start_px"], sig["black"],
                     sig["white"])
    for f, s0, cnt in bursts:
        a = f * L + s0
        vals[a:a + cnt] = sg.dim(vals[a:a + cnt], sig["black"],
                                 sig["white"], *burst_levels)
    px = sg.noise_and_quantize(vals, noise, gen).reshape(n_frames, 2, lpf, W)
    frames = px.permute(0, 2, 1, 3).reshape(n_frames, L, W)
    return frames.cpu().numpy(), dict(left=left.reshape(-1),
                                      right=right.reshape(-1))


# -- reference --------------------------------------------------------------
def _cells(cfg):
    sig = cfg["signal"]
    ppb, x0 = sig["ppb"], sig["start_px"]
    lo = np.ceil(x0 + np.arange(N_BITS) * ppb + ppb / 4)
    k = max(1, int(ppb / 2))
    return (lo[:, None] + np.arange(k)[None, :]).astype(np.int64)


def read_sublines(cfg, rows):
    """Pixel rows [N, W] u8 -> (subline words [3N, 3], crc_ok [3N])."""
    sig = cfg["signal"]
    cut = (sig["black"] + sig["white"]) / 2
    bits = (rows[:, _cells(cfg)].mean(-1) > cut).astype(np.uint8)
    parts = np.stack([bits[:, p:p + 64] for p in PARTS], 1).reshape(-1, 64)
    words = sg.from_bits(parts[:, :48].reshape(-1, 3, BITS))
    ok = sg.crc16(parts[:, :48]) == sg.from_bits(parts[:, 48:])
    return words, ok


def to_int16(words):
    v = np.asarray(words, np.int64) & 0xFFFF
    return np.where(v >= 0x8000, v - 0x10000, v).astype(np.int16)


def reference(cfg, frames, bits=BITS):
    """Capture frames [F, 2 lpf, W] u8 -> (samples [N, 2] int16, valid
    [N, 2], intact [N, 2]): field 1 then field 2 of each frame, pairs in
    block order; intact marks the pairs of sub-blocks read with no word
    erased. `bits` below 16 keeps only that many high bits (the
    control)."""
    F, L, W = frames.shape
    lpf = L // 2
    fields = np.stack([frames[:, 0::2], frames[:, 1::2]], 1)
    words, ok = read_sublines(cfg, fields.reshape(-1, W))
    n_sub = 3 * lpf
    words = words.reshape(F * 2, n_sub, 3)
    ok = ok.reshape(F * 2, n_sub)
    rows, cols = _layout(n_sub)
    w = words[:, rows, cols]                        # [F2, pairs, 3]
    good = ok[:, rows]
    n_bad = (~good).sum(-1)
    syn = w[..., 0] ^ w[..., 1] ^ w[..., 2]
    valid = good[..., :2].copy()
    one = n_bad == 1
    for k in range(2):
        m = one & ~good[..., k]
        w[..., k] = np.where(m, w[..., k] ^ syn, w[..., k])
        valid[..., k] |= m
    broken = (n_bad == 0) & (syn != 0)
    valid &= ~broken[..., None]
    audio = w[..., :2]
    if bits < BITS:
        audio = audio & ~((1 << (BITS - bits)) - 1)
    intact = (n_bad == 0)[..., None] & valid
    return (to_int16(audio).reshape(-1, 2), valid.reshape(-1, 2),
            intact.reshape(-1, 2))


def truth(t):
    return np.stack([to_int16(t["left"]), to_int16(t["right"])], 1)
