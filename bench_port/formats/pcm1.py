"""Sony PCM-1 captures: the generator and the plain reference decoder.

Both follow the upstream description (Fagear/SDVPCMdecoder):

- A line (pcm1line.h:59-149) is 94 bits and carries no sync marker: six
  13-bit words, L2 R2 L4 R4 L6 R6, most significant bit first, then a
  CRC-16 (CCITT, polynomial 0x1021, register preset to 0xFFFF) fed the
  complement of each word, the result complemented (pcm1line.cpp:158-171).
- A field of 245 lines is 735 sublines of one word pair (L, R) each; line
  l carries sublines 3l, 3l + 1, 3l + 2 as its pairs (L2, R2), (L4, R4),
  (L6, R6) (pcm1subline.h:22-36). The field interleaves by word pairs
  (pcm1datablock.h:37-59, pcm1deinterleaver.cpp:120-370): 8 blocks of 92
  pairs, block n over sublines 92n .. 92n + 91 as two stripes of 46 pairs
  at subline offsets 0 and 46, one stripe for the block's even pairs and
  one for its odd pairs; which stripe carries the even pairs alternates
  from block to block (the zig-zag). Pair k of block n is subline
  92n + 46 ((k + n + 1) mod 2) + k // 2, and block 7 is one pair short
  (735 = 8 x 92 - 1).
- A word expands to 16 bits (pcm1line.cpp:196-233): bits 11..0 are a
  two's complement value v, bit 12 the range: 16 v with the bit clear,
  4 v (the finer step) with it set.

Generator: seeded 13-bit words for every pair of every field, the
interleave, the CRC, rendered at `ppb` pixels a bit from `start_px`,
field 1 on the even rows.

Reference: each bit cell's inner pixels averaged and cut at the middle of
black and white, each line's CRC checked, every field de-interleaved, the
words expanded; a pair is valid, and intact, where the line that carries
it reads with a good CRC (PCM-1 has no parity: nothing is restored).

Departures: the reference reads at the coordinates the generator used
(no search for them, no Bit Picker for bits cut off the frame); it does
not read the header/footer service lines (pcm1line.cpp:314-323) or the
emphasis they carry, and takes the fields in the order top field first
with no vertical padding (pcm1datastitcher.h:143-152). Nothing here is
imported from the port.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import media as sg

BITS = 13
WORDS = 6                   # a line's audio words
N_BITS = WORDS * BITS + 16  # 94
PAIRS = 735                 # word pairs (sublines) of a field
BLOCK = 92                  # pairs a block
STRIPE = 46
ROWS_AT_ONCE = 16384        # pixel rows the reference reads at once


def pair_sublines() -> np.ndarray:
    """The subline of each of a field's 735 pairs, in the pairs' order."""
    j = np.arange(PAIRS)
    n, k = j // BLOCK, j % BLOCK
    return BLOCK * n + STRIPE * ((k + n + 1) % 2) + k // 2


def crc(words: np.ndarray) -> np.ndarray:
    """The CRC of lines of words [..., 6] -> int64 [...]."""
    inv = ~np.asarray(words, np.int64) & ((1 << BITS) - 1)
    bits = sg.to_bits(inv, BITS).reshape(*inv.shape[:-1], WORDS * BITS)
    return ~sg.crc16(bits) & 0xFFFF


def expand(words) -> np.ndarray:
    """13-bit words -> int16 samples."""
    w = np.asarray(words, np.int64)
    v = (w & 0x7FF) - (w & 0x800)
    return np.where(w & 0x1000, 4 * v, 16 * v).astype(np.int16)


# -- generator --------------------------------------------------------------
def encode_field(left, right) -> np.ndarray:
    """One field's pairs [735] each -> its line bits [245, 94]."""
    sub = np.empty((PAIRS, 2), np.int64)
    sub[pair_sublines()] = np.stack([left, right], 1)
    words = sub.reshape(-1, WORDS)                   # L2 R2 L4 R4 L6 R6
    return np.concatenate([sg.to_bits(words, BITS).reshape(-1, WORDS * BITS),
                           sg.to_bits(crc(words), 16)], 1)


def make_capture(cfg, n_frames: int, rng, gen, device, noise=0.0,
                 bursts=(), burst_levels=(5, 60)):
    """One capture: (frames [F, 2 lpf, W] u8 on the host, truth dict).

    `bursts` ((frame, first stream line of the frame, count), ...) dims
    those lines to `burst_levels` (black, white) before the noise."""
    sig = cfg["signal"]
    lpf, W = sig["lines_per_field"], sig["width"]
    if 3 * lpf != PAIRS:
        raise ValueError(f"PCM-1 fields hold {PAIRS // 3} lines, not {lpf}")
    L = 2 * lpf
    left = rng.integers(0, 1 << BITS, (n_frames, 2, PAIRS))
    right = rng.integers(0, 1 << BITS, (n_frames, 2, PAIRS))
    bits = np.stack([encode_field(left[f, h], right[f, h])
                     for f in range(n_frames) for h in range(2)])
    bits = torch.from_numpy(bits.reshape(-1, N_BITS)).to(device)
    vals = sg.render(bits, W, sig["ppb"], sig["start_px"], sig["black"],
                     sig["white"])
    for f, s0, cnt in bursts:
        a = f * L + s0
        vals[a:a + cnt] = sg.dim(vals[a:a + cnt], sig["black"],
                                 sig["white"], *burst_levels)
    px = sg.noise_and_quantize(vals, noise, gen).reshape(n_frames, 2, lpf, W)
    # Field 1 then field 2 of each frame; field 1 lies on the even rows.
    frames = px.permute(0, 2, 1, 3).reshape(n_frames, L, W)
    return frames.cpu().numpy(), dict(left=left.reshape(-1),
                                      right=right.reshape(-1))


# -- reference --------------------------------------------------------------
def _cells(cfg):
    """Pixel columns of each bit cell's inner half [94, k]."""
    sig = cfg["signal"]
    ppb, x0 = sig["ppb"], sig["start_px"]
    lo = np.ceil(x0 + np.arange(N_BITS) * ppb + ppb / 4)
    k = max(1, int(ppb / 2))
    return (lo[:, None] + np.arange(k)[None, :]).astype(np.int64)


def read_lines(cfg, rows):
    """Pixel rows [N, W] u8 -> (words [N, 6], crc_ok [N]): a cell reads 1
    where its pixels' mean is above the middle of black and white."""
    sig = cfg["signal"]
    cols = _cells(cfg)
    words = np.empty((len(rows), WORDS), np.int64)
    ok = np.empty(len(rows), bool)
    for a in range(0, len(rows), ROWS_AT_ONCE):
        px = np.asarray(rows[a:a + ROWS_AT_ONCE])
        total = px[:, cols].sum(-1, dtype=np.int64)
        bits = (2 * total > (sig["black"] + sig["white"]) * cols.shape[1])
        w = sg.from_bits(bits[:, :WORDS * BITS].reshape(-1, WORDS, BITS))
        words[a:a + len(w)] = w
        ok[a:a + len(w)] = crc(w) == sg.from_bits(bits[:, WORDS * BITS:])
    return words, ok


def reference(cfg, frames, bits=BITS):
    """Capture frames [F, 2 lpf, W] u8 -> (samples [N, 2] int16, valid
    [N, 2], intact [N, 2]): field 1 then field 2 of each frame, 735 pairs
    a field in the pairs' order; valid (and intact: no parity restores a
    word) where the line carrying the pair read with a good CRC. `bits`
    below 13 keeps only that many high bits of each word before the
    expansion (the control)."""
    F, L, W = frames.shape
    lpf = L // 2
    fields = np.empty((F, 2, lpf, W), np.uint8)
    fields[:, 0] = frames[:, 0::2]
    fields[:, 1] = frames[:, 1::2]
    words, ok = read_lines(cfg, fields.reshape(F * L, W))
    sub = words.reshape(F * 2, lpf * 3, 2)           # [fields, sublines, LR]
    s = pair_sublines()
    audio = sub[:, s]                                # [fields, 735, 2]
    good = ok.reshape(F * 2, lpf)[:, s // 3]
    if bits < BITS:
        audio = audio & ~((1 << (BITS - bits)) - 1)
    valid = np.repeat(good.reshape(-1, 1), 2, 1)
    return expand(audio).reshape(-1, 2), valid, valid.copy()


def truth(t):
    """The samples a capture was made from [N, 2] int16."""
    return np.stack([expand(t["left"]), expand(t["right"])], 1)
