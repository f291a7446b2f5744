"""STC-007 (Sony PCM-F1/701, EIAJ) captures: the generator and the plain
reference decoder.

Generator, a frozen copy of the port's recipe (synth/encoder and
chip_smoke.capture_frames): 14-bit samples -> blocks of six audio words
with P (XOR) and Q (GF(2^14), x^14 + x^8 + 1) -> the diagonal interleave
(word w of block b on stream line b + 16 w) -> per-line CRC-16 -> 137-bit
lines (START 1010, 128 data bits, STOP 01111) -> pixels at `ppb` per bit,
the two fields of a frame interleaved row by row (field 1 on even rows).

Reference: the same semantics decoded plainly with the layout the
generator used (no search): each bit cell's inner pixels averaged and
cut at the middle of black and white, words and CRC read, the CRC checked,
blocks gathered from the stream lines, one erased word restored by P, two
by P and Q, and the samples of every word that is read or restored marked
valid. Nothing here is imported from the port.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .. import media as sg

BITS = 14
MASK = (1 << BITS) - 1
POLY_FOLD = 0x0101          # x^14 = x^8 + 1
INTERLEAVE = 16             # lines between the words of a block
START = (1, 0, 1, 0)
STOP = (0, 1, 1, 1, 1)
N_BITS = 137
DATA_BIT0 = 4               # data bits 4 .. 131


# -- GF(2^14) ---------------------------------------------------------------
def mul_x(w):
    w = np.asarray(w, np.int64)
    return ((w << 1) & MASK) ^ np.where(w & 0x2000, POLY_FOLD, 0)


def mul_xinv(w):
    w = np.asarray(w, np.int64)
    odd = (w & 1) != 0
    t = np.where(odd, w ^ POLY_FOLD, w)
    return (t >> 1) | np.where(odd, 0x2000, 0)


def mul_xk(w, k: int):
    for _ in range(abs(k)):
        w = mul_x(w) if k > 0 else mul_xinv(w)
    return np.asarray(w, np.int64)


@functools.lru_cache(maxsize=None)
def _inv_xk_plus_1(k: int) -> np.ndarray:
    """Lookup table of (x^k + 1)^-1 over all 14-bit words."""
    w = np.arange(1 << BITS, dtype=np.int64)
    img = mul_xk(w, k) ^ w
    inv = np.empty_like(img)
    inv[img] = w
    if not np.array_equal(img[inv], w):
        raise ValueError(f"x^{k} + 1 is not invertible")
    return inv


def q_code(audio):
    """Q of audio words [..., 6]: XOR of x^(6-k) w_k."""
    q = np.zeros(audio.shape[:-1], np.int64)
    for k in range(6):
        q ^= mul_xk(audio[..., k], 6 - k)
    return q


# -- generator --------------------------------------------------------------
def encode_lines(left, right, n_lines: int):
    """Samples (14-bit words) -> stream line words [n_lines, 8] and CRCs."""
    nb = (len(left) + 2) // 3
    blocks = np.zeros((nb, 8), np.int64)
    for i in range(3):
        blocks[:len(left[i::3]), 2 * i] = left[i::3]
        blocks[:len(right[i::3]), 2 * i + 1] = right[i::3]
    blocks[:, 6] = np.bitwise_xor.reduce(blocks[:, :6], axis=1)
    blocks[:, 7] = q_code(blocks[:, :6])
    s = np.arange(n_lines)[:, None] - INTERLEAVE * np.arange(8)[None, :]
    ok = (s >= 0) & (s < nb)        # silent blocks outside the audio
    words = np.where(ok, blocks[np.clip(s, 0, nb - 1), np.arange(8)], 0)
    crcs = sg.crc16(sg.to_bits(words, BITS).reshape(n_lines, 8 * BITS))
    return words, crcs


def line_bits(words, crcs):
    data = np.concatenate([sg.to_bits(words, BITS).reshape(len(words), -1),
                           sg.to_bits(crcs, 16)], axis=1)
    n = len(words)
    return np.concatenate([np.tile(START, (n, 1)), data,
                           np.tile(STOP, (n, 1))], axis=1).astype(np.uint8)


def make_capture(cfg, n_frames: int, rng, gen, device, noise=0.0,
                 bursts=(), burst_levels=(5, 60)):
    """One capture: (frames [F, 2 lpf, W] u8 on the host, truth dict).

    `bursts` ((frame, first stream line of the frame, count), ...) dims
    those lines to `burst_levels` (black, white) before the noise."""
    sig = cfg["signal"]
    lpf, W = sig["lines_per_field"], sig["width"]
    L = 2 * lpf
    n_lines = n_frames * L
    n = 3 * n_lines
    left = rng.integers(1, 1 << BITS, n)
    right = rng.integers(1, 1 << BITS, n)
    words, crcs = encode_lines(left, right, n_lines)
    bits = torch.from_numpy(line_bits(words, crcs)).to(device)
    vals = sg.render(bits, W, sig["ppb"], sig["start_px"], sig["black"],
                     sig["white"])
    for f, s0, cnt in bursts:
        a = f * L + s0
        vals[a:a + cnt] = sg.dim(vals[a:a + cnt], sig["black"],
                                 sig["white"], *burst_levels)
    px = sg.noise_and_quantize(vals, noise, gen).reshape(n_frames, 2, lpf, W)
    # Stream order is field 1 then field 2; field 1 lies on the even rows.
    frames = px.permute(0, 2, 1, 3).reshape(n_frames, L, W)
    return frames.cpu().numpy(), dict(left=left, right=right)


# -- reference --------------------------------------------------------------
def _cells(cfg, n_bits):
    """Pixel columns of each bit cell's inner half [n_bits, k]."""
    sig = cfg["signal"]
    ppb, x0 = sig["ppb"], sig["start_px"]
    lo = np.ceil(x0 + np.arange(n_bits) * ppb + ppb / 4)
    k = max(1, int(ppb / 2))
    return (lo[:, None] + np.arange(k)[None, :]).astype(np.int64)


def read_lines(cfg, rows):
    """Pixel rows [N, W] u8 -> (words [N, 8], crc_ok [N])."""
    sig = cfg["signal"]
    cut = (sig["black"] + sig["white"]) / 2
    cols = _cells(cfg, N_BITS)
    bits = (rows[:, cols].mean(-1) > cut).astype(np.uint8)
    data = bits[:, DATA_BIT0:DATA_BIT0 + 8 * BITS + 16]
    words = sg.from_bits(data[:, :8 * BITS].reshape(-1, 8, BITS))
    crc_ok = sg.crc16(data[:, :8 * BITS]) == sg.from_bits(data[:, 8 * BITS:])
    marks = (bits[:, :4] == START).all(1) & (bits[:, -5:] == STOP).all(1)
    return words, crc_ok & marks


def correct_blocks(blocks, ok):
    """Blocks [B, 8] with word flags [B, 8] -> (audio [B, 6], valid [B, 6])
    after P/Q correction of one or two erased words."""
    w = blocks.copy()
    bad = ~ok
    n_bad = bad.sum(1)
    valid = ok[:, :6].copy()
    aud_bad = bad[:, :6]
    n_aud = aud_bad.sum(1)
    wz = np.where(ok, w, 0)
    sp = np.bitwise_xor.reduce(wz[:, :7], axis=1)        # P ^ good audio
    sq = q_code(wz[:, :6]) ^ wz[:, 7]                     # Q ^ good audio
    first = np.argmax(aud_bad, 1)
    last = 5 - np.argmax(aud_bad[:, ::-1], 1)
    # One audio word lost, P present (Q may be lost too): P restores it.
    by_p = (n_aud == 1) & ok[:, 6] & (n_bad <= 2)
    # One audio word and P lost: Q restores it.
    by_q = (n_aud == 1) & bad[:, 6] & ok[:, 7] & (n_bad == 2)
    # Two audio words lost, P and Q present: both restored.
    by_pq = (n_aud == 2) & (n_bad == 2)
    for a in range(6):
        m = by_p & (first == a)
        w[m, a] = sp[m]
        m = by_q & (first == a)
        w[m, a] = mul_xk(sq[m], -(6 - a))
    for a in range(6):
        for b in range(a + 1, 6):
            m = by_pq & (first == a) & (last == b)
            if not m.any():
                continue
            t = mul_xk(sq[m] ^ mul_xk(sp[m], 6 - a), -(6 - b))
            wb = _inv_xk_plus_1(b - a)[t]
            w[m, b] = wb
            w[m, a] = sp[m] ^ wb
    fixed = by_p | by_q | by_pq
    valid |= fixed[:, None] & aud_bad
    return w[:, :6], valid


def to_int16(words):
    v = (np.asarray(words, np.int64) << 2) & 0xFFFF
    return np.where(v >= 0x8000, v - 0x10000, v).astype(np.int16)


def reference(cfg, frames, bits=BITS):
    """Capture frames [F, 2 lpf, W] u8 -> (samples [N, 2] int16, valid
    [N, 2], intact [N, 2]) for every block of the capture, in stream
    order; intact marks the samples of blocks read with no word erased.
    `bits` below 14 keeps only that many high bits of each word (the
    control)."""
    F, L, W = frames.shape
    lpf = L // 2
    stream = np.empty((F, 2, lpf, W), np.uint8)
    stream[:, 0] = frames[:, 0::2]
    stream[:, 1] = frames[:, 1::2]
    words, ok = read_lines(cfg, stream.reshape(F * L, W))
    n = F * L
    s = np.arange(n)[:, None] + INTERLEAVE * np.arange(8)[None, :]
    have = s < n
    blocks = words[np.minimum(s, n - 1), np.arange(8)]
    flags = ok[np.minimum(s, n - 1)] & have
    audio, valid = correct_blocks(blocks, flags)
    if bits < BITS:
        audio = audio & ~((1 << (BITS - bits)) - 1)
    intact = np.repeat(flags.all(1), 6).reshape(-1, 2)
    return (to_int16(audio).reshape(-1, 2), valid.reshape(-1, 2),
            intact & valid.reshape(-1, 2))


def truth(t):
    """The samples a capture was made from [N, 2] int16."""
    return np.stack([to_int16(t["left"]), to_int16(t["right"])], 1)


# -- the K1 bound -------------------------------------------------------------
K1_OUT_BYTES_PER_LINE = 49   # words 32, crc_read/crc_calc/hyst/shift 16,
#                              valid 1 (chip_smoke.OUT_BYTES_PER_LINE)
SECTOR = 32


def k1_round_bytes(cfg, n_frames: int) -> int:
    """Bytes one K1 launch over n_frames frames needs at least
    (chip_smoke.k1_bound, every line read at its first trial): of each row
    the 32-byte sectors from the first to the last sampled data column,
    the per-frame coordinates and three levels read once, 49 B a line
    written. Rows start on a sector (W is a multiple of 32)."""
    sig = cfg["signal"]
    W, L = sig["width"], 2 * sig["lines_per_field"]
    if W % SECTOR:
        raise ValueError("k1_round_bytes assumes rows aligned to 32 B")
    start = round(sig["start_px"] + 1 * sig["ppb"])      # the coordinates
    stop = round(sig["start_px"] + 133 * sig["ppb"])     # of the program
    cols = k1_columns(start, stop, W)
    sectors = cols.max() // SECTOR - cols.min() // SECTOR + 1
    per_frame = 2 * 4 + 3 * 4                            # coords, levels
    return n_frames * (L * (sectors * SECTOR + K1_OUT_BYTES_PER_LINE)
                       + per_frame)


def k1_columns(start: int, stop: int, W: int) -> np.ndarray:
    """The 128 data bits' sampling columns at shift stage 0
    (binarize.stc007_frame_bit_coords: integer PPB over 132 bit cells from
    the START marker's bit 3, at 128 x fixed point)."""
    mult = 128
    psm = ((stop - start) * mult + 132 // 2) // 132
    half = (psm + 1) // 2
    bit = np.minimum(np.arange(128) + 3, N_BITS - 1)
    return np.clip((bit * psm + half) // mult + start, 0, W - 1)
