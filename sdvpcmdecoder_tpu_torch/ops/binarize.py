"""Batched STC-007 binarizer: video lines -> PCM words (plain torch).

Port of the STC-007 part of sdvpcmdecoder_tpu/ops/binarize.py. The
reference binarizer (binarizer.cpp readPCMdata :7695-8090) reads one line
at a time, iterating hysteresis depth x pixel shift with early exit. Here
the full trial grid for a batch of lines is evaluated at once:

  * integer PPB / bit-centre pixel coordinates (pcmline.cpp:249-311,
    :504-519, INT_CALC_MULT=128 fixed point);
  * the hysteresis read (fillSTC007, binarizer.cpp:7322+:
    out = prev ? px >= ref_high : px > ref_low) as an inclusive scan over
    the monoid of maps {0,1}->{0,1};
  * CRC validity of every trial from the 128-bit syndrome table;
  * the reference's early-exit selection as "first valid trial in
    lexicographic (hyst, shift) order".

`stc007_frame_decode` is the plain torch version of the CUDA kernel in
csrc/stc007_binarize.cu (ops/fused_binarize.py). It samples pixels with a
direct gather; the JAX package's one-hot bf16 sampling matmul was a TPU
workaround and has no counterpart here.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..formats import gf2, stc007
from ..formats import crc as crc_mod

# Pixel-shift tables (pcmline.h:63-71).
PIX_SH_BG = np.array([0, 1, -1, 2, -2], dtype=np.int32)
PIX_SH_ED = np.array([0, 1, -1, 2, -2], dtype=np.int32)
SHIFT_STAGES_MAX = 4   # 5 stages (PCM_LINE_MAX_PS_STAGES)
HYST_DEPTH_MAX = 10    # binarizer.h:235-241
INT_CALC_MULT = 128


class LineBatch(NamedTuple):
    """Binarized lines [N, ...] (or [F, L, ...])."""
    words: torch.Tensor       # [N, 8] int32 data words
    crc_read: torch.Tensor    # [N] int32 CRC read from the line
    crc_calc: torch.Tensor    # [N] int32 recalculated CRC
    valid: torch.Tensor       # [N] bool CRC match
    hyst: torch.Tensor        # [N] int32 chosen hysteresis depth
    shift: torch.Tensor       # [N] int32 chosen pixel-shift stage


def calc_ppb(data_start, data_stop, bit_count):
    """Integer PPB math (pcmline.cpp:504-519). Returns (psm, half)."""
    pixels = data_stop - data_start
    psm = (pixels * INT_CALC_MULT + bit_count // 2) // bit_count
    half = (psm + 1) // 2
    return psm, half


@functools.lru_cache(maxsize=None)
def _pix_shifts(device):
    """PIX_SH_BG and PIX_SH_ED on `device`, uploaded once: an upload from
    pageable memory waits for the device's queue."""
    return (torch.as_tensor(PIX_SH_BG, device=device),
            torch.as_tensor(PIX_SH_ED, device=device))


def bit_pixel_coords(data_start, psm, half, shift_stage, n_bits, bit_ofs,
                     bits_per_line, left_zone, right_zone, pixel_stop,
                     pixel_start=0):
    """Bit-centre pixel coordinates [..., n_bits] int32 (pcmline.cpp:249-311).

    data_start/psm/half are int32 tensors [...]; shift_stage is an int or
    an int tensor broadcastable against them.
    """
    device = data_start.device
    bit = torch.arange(n_bits, dtype=torch.int32, device=device) + bit_ofs
    bit = torch.clamp(bit, max=bits_per_line - 1)
    base = (bit * psm[..., None] + half[..., None]) \
        // INT_CALC_MULT + data_start[..., None]
    # An int stage indexes the tables on the device: torch.as_tensor of a
    # Python int on a GPU would be an upload.
    stage = shift_stage if isinstance(shift_stage, int) \
        else torch.as_tensor(shift_stage, device=device).long()
    sh_bg, sh_ed = _pix_shifts(device)
    bg, ed = sh_bg[stage], sh_ed[stage]
    uniform = bg == ed
    zone = torch.where(bit < left_zone, bg[..., None],
                       torch.where(bit > right_zone, ed[..., None], 0))
    shift = torch.where(uniform[..., None], bg[..., None], zone)
    return torch.clamp(base + shift, pixel_start, pixel_stop - 1)


def stc007_frame_bit_coords(coords: torch.Tensor, n_s: int,
                            width: int) -> torch.Tensor:
    """Per-frame bit-centre coordinates [F, S, 128] int32 for shift stages
    0..n_s-1 (the sampling positions of every trial of a frame)."""
    start = coords[:, 0].to(torch.int32)
    stop = coords[:, 1].to(torch.int32)
    psm, half = calc_ppb(start, stop, stc007.BITS_BETWEEN_COORDS)
    stages = torch.arange(n_s, dtype=torch.int32, device=coords.device)
    return bit_pixel_coords(
        start[:, None], psm[:, None], half[:, None], stages[None, :],
        stc007.BITS_PCM_DATA, stc007.COORD_BIT_OFS, stc007.BITS_IN_LINE,
        stc007.BITS_LEFT_SHIFT, stc007.BITS_RIGHT_SHIFT, pixel_stop=width)


def hysteresis_read(pixels_at_bits, ref_low, ref_high):
    """Schmitt-trigger bit read over the last axis -> int32 bits.

    out[i] = prev ? (px[i] >= ref_high) : (px[i] > ref_low), prev = out[i-1],
    initial prev = 0 (fillSTC007 binarizer.cpp:7365-7395).

    Each step is a map {0,1}->{0,1} held as (value_if_prev0,
    value_if_prev1); composition is associative, so an inclusive
    Hillis-Steele scan resolves the line in ceil(log2(n)) passes.
    """
    a = pixels_at_bits > ref_low[..., None]     # prev == 0 branch
    b = pixels_at_bits >= ref_high[..., None]   # prev == 1 branch
    n = a.shape[-1]
    d = 1
    while d < n:
        # Element i composes its prefix ending at i-d (l) with itself (r):
        # x -> r(l(x)) = (where(la, rb, ra), where(lb, rb, ra)).
        la, lb = a[..., :n - d], b[..., :n - d]
        ra, rb = a[..., d:], b[..., d:]
        a = torch.cat([a[..., :d], torch.where(la, rb, ra)], dim=-1)
        b = torch.cat([b[..., :d], torch.where(lb, rb, ra)], dim=-1)
        d *= 2
    return a.to(torch.int32)


def hysteresis_read_np(pixels_at_bits, ref_low, ref_high):
    """Serial numpy twin of hysteresis_read (the host search paths of
    ops/line_decode_np)."""
    out = np.zeros(pixels_at_bits.shape, dtype=np.int32)
    prev = np.zeros(pixels_at_bits.shape[:-1], dtype=bool)
    for i in range(pixels_at_bits.shape[-1]):
        px = pixels_at_bits[..., i]
        bit = np.where(prev, px >= ref_high, px > ref_low)
        out[..., i] = bit
        prev = bit
    return out


@functools.lru_cache(maxsize=None)
def _syndrome_const():
    table, const = stc007.crc_syndrome_table()
    return table.astype(np.int32), const


@functools.lru_cache(maxsize=None)
def _pack_weights():
    """[128, 16] int32 weights packing the 128 data bits into the eight
    14-bit words (columns 0..7) and the 16-bit read CRC (column 8)."""
    wmat = np.zeros((stc007.BITS_PCM_DATA, 16), dtype=np.int32)
    pos = 0
    for w in range(stc007.N_WORDS):
        for b in range(stc007.BITS_PER_WORD):
            wmat[pos, w] = 1 << (stc007.BITS_PER_WORD - 1 - b)
            pos += 1
    for b in range(stc007.BITS_PER_CRC):
        wmat[pos, stc007.WORD_CRCC] = 1 << (stc007.BITS_PER_CRC - 1 - b)
        pos += 1
    return wmat


@functools.lru_cache(maxsize=None)
def kernel_syndrome_rows():
    """The constants the CUDA kernel takes by value: the 128 rows of the
    syndrome table packed into uint32 (bit j of row i = table[i, j]), the
    syndrome constant, and the CONST of crc16_linear_table(112). A read's
    syndrome is the XOR of the rows of its set bits (valid when it equals
    the syndrome constant), and its calc_crc is syndrome ^ crc_read ^ CONST:
    rows 0..111 are the CRC rows of the word bits, rows 112..127 map the
    read CRC onto itself."""
    table, synd_const = _syndrome_const()
    rows = (table.astype(np.uint32)
            << np.arange(16, dtype=np.uint32)).sum(1, dtype=np.uint32)
    _, crc_const = crc_mod.crc16_linear_table(stc007.N_WORDS
                                              * stc007.BITS_PER_WORD)
    return np.ascontiguousarray(rows), int(synd_const), int(crc_const)


@functools.lru_cache(maxsize=None)
def _tables_on(device):
    """The syndrome table and the pack weights on `device`, uploaded once:
    a CUDA graph capture refuses an upload."""
    return (torch.as_tensor(_syndrome_const()[0], device=device),
            torch.as_tensor(_pack_weights(), device=device))


def _syndrome(bits, synd_table, const=None):
    """Packed CRC syndrome of [..., n] bits (0 for a valid line); const is
    the table's constant, STC-007's when None."""
    if const is None:
        _, const = _syndrome_const()
    return crc_mod.pack_bits_to_u16(gf2.matmul_bits(bits, synd_table)) ^ const


def stc007_line_decode(pixel_lines, coords, ref_level, black, white,
                       hyst_depth, shift_stage):
    """Decode one (hyst, shift) trial for a batch of lines.

    pixel_lines [N, W] uint8; coords [N, 2]; ref_level/black/white [N].
    Returns (words [N,8], crc_read, crc_calc, syndrome, valid).
    valid is False when the hysteresis refs clip into the black/white
    levels (fillDataWords binarizer.cpp:7590-7625 -> forced invalid CRC).
    """
    N, W = pixel_lines.shape
    data_start = coords[:, 0].to(torch.int32)
    data_stop = coords[:, 1].to(torch.int32)
    psm, half = calc_ppb(data_start, data_stop, stc007.BITS_BETWEEN_COORDS)
    px_coords = bit_pixel_coords(
        data_start, psm, half, shift_stage, stc007.BITS_PCM_DATA,
        stc007.COORD_BIT_OFS, stc007.BITS_IN_LINE, stc007.BITS_LEFT_SHIFT,
        stc007.BITS_RIGHT_SHIFT, pixel_stop=W)
    px = torch.gather(pixel_lines, -1, px_coords.long())
    # Hysteresis levels (binarizer getLowLevel/getHighLevel).
    rl = torch.clamp(ref_level - hyst_depth, min=1)
    rh = torch.clamp(ref_level + hyst_depth, max=254)
    read_ok = (rl > black) & (rh < white)
    bits = hysteresis_read(px, rl, rh)
    words, crc_read = stc007.data_bits_to_words(bits)
    table, _ = _syndrome_const()
    syndrome = _syndrome(bits, table)
    crc_calc = stc007.calc_crc(words)
    valid = (syndrome == 0) & read_ok
    return words, crc_read, crc_calc, syndrome, valid


def stc007_read_pcm_grid(pixel_lines, coords, ref_level, black, white,
                         hyst_limit=HYST_DEPTH_MAX,
                         shift_limit=SHIFT_STAGES_MAX):
    """Full readPCMdata trial grid + reference-faithful selection.

    Evaluates (hyst_limit+1) x (shift_limit+1) trials for every line and
    picks the lexicographically-first valid (hyst, shift). Falls back to
    (0, 0) when no trial is valid (readPCMdata :7957-8010).
    """
    n_h, n_s = hyst_limit + 1, shift_limit + 1
    hh, ss = np.meshgrid(np.arange(n_h), np.arange(n_s), indexing="ij")
    trials = [stc007_line_decode(pixel_lines, coords, ref_level, black,
                                 white, int(h), int(s))
              for h, s in zip(hh.ravel(), ss.ravel())]
    words_t, crc_read_t, crc_calc_t, _, valid_t = (
        torch.stack(field) for field in zip(*trials))      # [T, N, ...]
    T = n_h * n_s
    device = pixel_lines.device
    prio = torch.arange(T, dtype=torch.int32, device=device)[:, None]
    order = torch.where(valid_t, prio, T)
    # Valid trials have distinct priorities, so the minimum is unique.
    pick = torch.argmin(order, dim=0)                        # [N]
    any_valid = valid_t.any(dim=0)
    pick = torch.where(any_valid, pick, 0)
    sel = lambda arr: torch.take_along_dim(arr, pick[None, :], dim=0)[0]
    # Trial t is (hyst, shift) = (t // n_s, t % n_s), as hh, ss ravel.
    pick32 = pick.to(torch.int32)
    return LineBatch(
        words=torch.take_along_dim(words_t, pick[None, :, None], dim=0)[0],
        crc_read=sel(crc_read_t),
        crc_calc=sel(crc_calc_t),
        valid=any_valid,
        hyst=pick32 // n_s,
        shift=pick32 % n_s,
    )


def _frame_samples(pixels, coords, n_s):
    """Pixel samples at every bit centre of every shift stage:
    [F, S, L, 128] uint8 (they do not depend on the levels)."""
    F, L, W = pixels.shape
    pc = stc007_frame_bit_coords(coords, n_s, W).long()      # [F, S, 128]
    return torch.stack([
        torch.gather(pixels, 2, pc[:, s, None, :].expand(F, L, -1))
        for s in range(n_s)], dim=1)


def _trial_grid(px, ref_level, black, white, n_h, n_s, synd_table,
                synd_const=None):
    """The (hyst, shift) trial grid on samples px [F, S, L, n] at the
    levels ref/black/white ([F] or [F, L]): the bits [F, L, n] of the
    lexicographically first valid trial of every line (trial (0, 0) where
    none is valid), its index pick [F, L] (0 there) and any_valid [F, L].
    synd_table/synd_const are the format's syndrome map (STC-007's
    constant when synd_const is None)."""
    F, _, L, _ = px.shape
    # Levels broadcast against [F, S, L]: per frame or per line.
    if ref_level.dim() == 2:
        lvl = lambda t: t[:, None, :]
    else:
        lvl = lambda t: t[:, None, None]
    T = n_h * n_s
    pick = torch.full((F, L), T, dtype=torch.int32, device=px.device)
    chosen = None
    for h in range(n_h):
        rl = torch.clamp(ref_level - h, min=1)
        rh = torch.clamp(ref_level + h, max=254)
        read_ok = lvl((rl > black) & (rh < white))
        bits = hysteresis_read(px, lvl(rl), lvl(rh))         # [F,S,L,128]
        valid = (_syndrome(bits, synd_table, synd_const) == 0) \
            & read_ok                                          # [F,S,L]
        if h == 0:
            chosen = bits[:, 0]
        for s in range(n_s):
            take = valid[:, s] & (pick == T)
            pick = torch.where(take, h * n_s + s, pick)
            chosen = torch.where(take[..., None], bits[:, s], chosen)
    any_valid = pick < T
    return chosen, torch.where(any_valid, pick, 0), any_valid


def _pack_words(chosen, pack_weights):
    """[..., 128] bits -> ([..., 8] int32 words, [...] int32 read CRC)."""
    words16 = torch.stack(
        [(chosen * pack_weights[:, c]).sum(-1, dtype=torch.int32)
         for c in range(stc007.N_WORDS + 1)], dim=-1)        # [..., 9]
    return words16[..., :stc007.N_WORDS], words16[..., stc007.WORD_CRCC]


def stc007_frame_decode(pixels, coords, ref_level, black, white,
                        hyst_limit=HYST_DEPTH_MAX,
                        shift_limit=SHIFT_STAGES_MAX, *,
                        synd_table=None, pack_weights=None):
    """Frame-grouped trial-grid decode (plain version of the CUDA kernel).

    pixels [F, L, W] uint8, coords [F, 2]; ref/black/white int32, either
    per frame [F] or per line [F, L] (per-line AGC). synd_table and
    pack_weights are the [128, 16] int32 tables of `_syndrome_const` and
    `_pack_weights` on the pixels' device (built when not given).

    Returns a LineBatch with leading shape [F, L]. Lines with no valid
    trial carry the words, read CRC, hyst and shift of trial (0, 0).
    """
    n_h, n_s = hyst_limit + 1, shift_limit + 1
    device = pixels.device
    if synd_table is None:
        synd_table = _tables_on(device)[0]
    if pack_weights is None:
        pack_weights = _tables_on(device)[1]
    px = _frame_samples(pixels, coords, n_s)                 # [F,S,L,128] u8
    chosen, pick, any_valid = _trial_grid(px, ref_level, black, white,
                                          n_h, n_s, synd_table)
    words, crc_read = _pack_words(chosen, pack_weights)
    return LineBatch(words=words, crc_read=crc_read,
                     crc_calc=stc007.calc_crc(words), valid=any_valid,
                     hyst=pick // n_s, shift=pick % n_s)


def stc007_ref_sweep_decode(pixels, coords, black, white, ref_levels,
                            hyst_limit=HYST_DEPTH_MAX,
                            shift_limit=SHIFT_STAGES_MAX):
    """Full reference-level sweep, plain torch (sweepRefLevel
    binarizer.cpp:3551 / calcRefLevelBySweep :3821).

    The reference walks every brightness in [black+1, white-1] per line,
    re-running its serial trial loops at each level.  Here the per-shift
    pixel samples are computed ONCE (they don't depend on the reference
    level), then a loop walks a shared ref-level grid, each step reducing
    the (hyst, shift) grid to the lexicographically-first valid result
    for that level — stc007_frame_decode's grid with that level for every
    frame, the early-exit readPCMdata call inside the reference's sweep
    loop.  Only one level's trial bits exist at a time.

    pixels [F, L, W] uint8; coords [F, 2]; black/white [F];
    ref_levels [R] int32 (descending, white -> black scan order).
    Returns per-level tensors with leading axis R: valid (bool) and
    crc/hyst/shift (int32) [R, F, L] and words (int32) [R, F, L, 8].
    Levels outside a frame's (black, white) open interval are masked
    invalid (they carry trial (0, 0)'s words), which realises the
    per-line sweep span without dynamic shapes.
    """
    F, L, W = pixels.shape
    n_h, n_s = hyst_limit + 1, shift_limit + 1
    device = pixels.device
    synd_table, pack_weights = _tables_on(device)
    black = black.to(torch.int32)
    white = white.to(torch.int32)
    levels = torch.as_tensor(ref_levels, device=device).to(torch.int32)
    R = levels.shape[0]
    px = _frame_samples(pixels, coords, n_s)                 # [F,S,L,128] u8
    valid = torch.empty((R, F, L), dtype=torch.bool, device=device)
    crc, hyst, shift = (torch.empty((R, F, L), dtype=torch.int32,
                                    device=device) for _ in range(3))
    words = torch.empty((R, F, L, stc007.N_WORDS), dtype=torch.int32,
                        device=device)
    for r in range(R):
        chosen, pick, valid[r] = _trial_grid(
            px, levels[r].expand(F), black, white, n_h, n_s, synd_table)
        words[r], crc[r] = _pack_words(chosen, pack_weights)
        hyst[r] = pick // n_s
        shift[r] = pick % n_s
    return dict(valid=valid, crc=crc, hyst=hyst, shift=shift, words=words)


def pick_center_ref_level(black, white, min_contrast=8, min_ref_lvl=1,
                          max_ref_lvl=254):
    """Mid-point reference pick (binarizer.cpp pickCenterRefLevel).

    Returns (ref_level, contrast_ok). Takes tensors or numpy arrays (the
    V2D prescan's host path) and returns the same kind.
    """
    delta = white - black
    ok = delta >= min_contrast
    clip = np.clip if isinstance(delta, np.ndarray) else torch.clamp
    ref = clip(black + delta // 2, min_ref_lvl, max_ref_lvl)
    return ref, ok


def pick_ref_sweep(valid, crc, hyst, shift, min_valid_crcs=5):
    """CRC-statistics selection over a ref-level sweep (host numpy).

    Port of calcRefLevelBySweep :3821 selection: find the most frequent
    CRC across levels (findMostFrequentCRC :1829), drop collisions
    (invalidateNonFrequentCRCs :1931), require a span of at least
    `min_valid_crcs` levels (digi_set default, binarizer.cpp:55), then
    pick the middle of the longest contiguous run at the lowest
    (hysteresis, shift) combo (pickLevelByCRCStats :1985).  A span that
    exists but is too narrow still yields a pick, flagged forced-bad
    (SPAN_TOO_NARROW -> pickLevelByCRCStatsOpt + setForcedBad :3997).

    Arrays are [R, N] (levels descending, lines flattened).
    Returns (pick_idx [N], good [N], forced_bad [N]); pick_idx is -1
    where no level produced a valid CRC.
    """
    R, N = valid.shape
    crc = np.where(valid, crc, -1)
    # Count, for each level r, how many valid levels of the same line
    # share its CRC — sort-grouped, O(RN log R) instead of an [R,R,N]
    # equality tensor.
    counts = np.zeros((R, N), dtype=np.int64)
    if valid.any():
        rr, nn = np.nonzero(valid)
        ids = nn.astype(np.int64) * (1 << 17) + crc[rr, nn] + 1
        _, inverse, grp_counts = np.unique(ids, return_inverse=True,
                                           return_counts=True)
        counts[rr, nn] = grp_counts[inverse]
    best = counts.argmax(axis=0)                          # first max:
    span = counts[best, np.arange(N)]                     # highest level
    modal_crc = crc[best, np.arange(N)]
    target = valid & (crc == modal_crc[None, :]) & (span[None, :] > 0)
    h_m = np.where(target, hyst, 0x7FFF)
    low_d = h_m.min(axis=0)
    s_m = np.where(target & (hyst == low_d[None, :]), shift, 0x7FFF)
    low_s = s_m.min(axis=0)
    region = target & (hyst == low_d[None, :]) & (shift == low_s[None, :])
    # Longest contiguous run per line; ties go to the LATER (lower-level)
    # run (pickLevelByCRCStats :2105 uses >=) — run extraction over all
    # lines at once via transitions, best run by an encoded score.
    pick_idx = np.full(N, -1, dtype=np.int64)
    padded = np.zeros((R + 2, N), np.int8)
    padded[1:-1] = region
    d = np.diff(padded, axis=0)
    ln_s, r_s = np.nonzero(d.T == 1)   # run starts, line-major order
    ln_e, r_e = np.nonzero(d.T == -1)  # run ends (exclusive), aligned
    if len(ln_s):
        length = r_e - r_s
        pick = r_s + (r_e - 1 - r_s) // 2
        score = (length * (R + 2) + r_s) * 512 + pick
        best_score = np.full(N, -1, dtype=np.int64)
        np.maximum.at(best_score, ln_s, score)
        found = best_score >= 0
        pick_idx[found] = best_score[found] % 512
    good = span >= min_valid_crcs
    forced_bad = (span > 0) & ~good
    return pick_idx, good, forced_bad


# ---- PCM-1 / PCM-16x0 ---------------------------------------------------

@functools.lru_cache(maxsize=None)
def format_syndrome_table(fmt: str):
    """Affine syndrome map (TABLE [n,16] int32, CONST) for any format's
    line bits: syndrome(bits) == 0 iff calculated CRC equals the read CRC.

    Built numerically from the format's numpy CRC (linearity over GF(2)
    makes n+1 evaluations sufficient); covers the PCM-1 complemented CRC
    scheme transparently.
    """
    from ..formats import pcm1 as _p1, pcm16x0 as _p16

    if fmt == "stc007":
        table, const = stc007.crc_syndrome_table()
        return table.astype(np.int32), const

    if fmt == "pcm1":
        nb = _p1.BITS_PCM_DATA

        def synd(bits):
            words, crc_read = _p1.data_bits_to_words(bits[None], xp=np)
            return int(_p1.calc_crc(words, xp=np)[0]) ^ int(crc_read[0])
    elif fmt == "pcm16x0":
        nb = _p16.BITS_PCM_DATA

        def synd(bits):
            words, crc_read = _p16.data_bits_to_words(bits[None], xp=np)
            return int(_p16.calc_crc(words, xp=np)[0]) ^ int(crc_read[0])
    else:
        raise ValueError(fmt)
    zero = np.zeros(nb, dtype=np.int64)
    const = synd(zero)
    table = np.zeros((nb, 16), dtype=np.int32)
    for i in range(nb):
        e = zero.copy()
        e[i] = 1
        v = synd(e) ^ const
        table[i] = [(v >> j) & 1 for j in range(16)]
    return table, const


@functools.lru_cache(maxsize=None)
def _format_table_on(fmt, device):
    """format_syndrome_table(fmt) with its TABLE on `device`, uploaded
    once."""
    table, const = format_syndrome_table(fmt)
    return torch.as_tensor(table, device=device), const


FORMAT_GEOM = {
    # n_bits, bit_ofs(part-adjusted at call), bits_between, bits_per_line,
    # left_zone, right_zone
    "stc007": (stc007.BITS_PCM_DATA, stc007.COORD_BIT_OFS,
               stc007.BITS_BETWEEN_COORDS, stc007.BITS_IN_LINE,
               stc007.BITS_LEFT_SHIFT, stc007.BITS_RIGHT_SHIFT),
    "pcm1": (94, 0, 94, 94, 16, 52),
    "pcm16x0": (64, 0, 193, 193, 34, 107),
}

PCM16X0_PART_STARTS = (0, 64, 129)
PCM16X0_CTRL_BIT = 128


def _format_coords(coords, fmt, stages, n_bits, bit_ofs, width):
    """Bit-centre columns [F, len(stages), n_bits] of `fmt`'s geometry
    for bits bit_ofs.. at the given shift stages (an int32 tensor)."""
    _, _, between, per_line, lz, rz = FORMAT_GEOM[fmt]
    start = coords[:, 0].to(torch.int32)
    stop = coords[:, 1].to(torch.int32)
    psm, half = calc_ppb(start, stop, between)
    return bit_pixel_coords(start[:, None], psm[:, None], half[:, None],
                            stages[None, :], n_bits, bit_ofs, per_line,
                            lz, rz, pixel_stop=width)


def _pcm_grid(pixels, coords, ref_level, black, white, fmt, n_h, n_s,
              part_starts):
    """The trial grid of every part of every line in one pass: the parts
    (PCM-16x0's three sublines, or PCM-1's one line) are independent lines
    of the same geometry, so their samples stack on the line axis and
    share one grid.  Returns (bits [F, L, P, n] int32, valid [F, L, P],
    pick [F, L, P] int32)."""
    F, L, W = pixels.shape
    P = len(part_starts)
    n_bits, bit_ofs = FORMAT_GEOM[fmt][:2]
    stages = torch.arange(n_s, dtype=torch.int32, device=pixels.device)
    pc = torch.stack([_format_coords(coords, fmt, stages, n_bits,
                                     bit_ofs + p, W)
                      for p in part_starts], dim=2)          # [F,S,P,n]
    # One gather for every stage and part: [F, L, S*P*n] -> [F,S,P*L,n].
    idx = pc.reshape(F, 1, n_s * P * n_bits).long().expand(F, L, -1)
    px = torch.gather(pixels, 2, idx).view(F, L, n_s, P, n_bits) \
        .permute(0, 2, 3, 1, 4).reshape(F, n_s, P * L, n_bits)
    table, const = _format_table_on(fmt, pixels.device)
    chosen, pick, any_valid = _trial_grid(px, ref_level, black, white,
                                          n_h, n_s, table, const)
    return (chosen.view(F, P, L, n_bits).transpose(1, 2),
            any_valid.view(F, P, L).transpose(1, 2),
            pick.view(F, P, L).transpose(1, 2))


def generic_frame_decode(pixels, coords, ref_level, black, white, fmt,
                         hyst_limit=0, shift_limit=2, part_start=0):
    """Format-parameterized frame-grouped trial-grid decode.

    The trial grid of stc007_frame_decode for PCM-1 (94-bit lines) and
    PCM-16x0 (64-bit sublines; part_start in {0, 64, 129}). pixels
    [F, L, W] uint8, coords [F, 2], ref/black/white [F] int32. Returns
    (bits [F, L, n_bits] int32, valid [F, L], hyst, shift int32); lines
    with no valid trial carry trial (0, 0).
    """
    n_h, n_s = hyst_limit + 1, shift_limit + 1
    bits, valid, pick = _pcm_grid(pixels, coords, ref_level, black, white,
                                  fmt, n_h, n_s, (part_start,))
    pick = pick[..., 0]
    return bits[:, :, 0], valid[..., 0], pick // n_s, pick % n_s


def pcm1_frame_decode(pixels, coords, ref_level, black, white,
                      shift_limit=2, hyst_limit=0):
    """PCM-1 frame decode -> (words [F,L,6], crc_read [F,L], valid).

    The hysteresis depth sweep applies to every format in the reference
    (readPCMdata binarizer.cpp:7695 is the shared path; limits
    binarizer.h:235-241) — hyst_limit adds that trial axis here too."""
    from ..formats import pcm1 as _p1
    bits, valid, _hyst, _shift = generic_frame_decode(
        pixels, coords, ref_level, black, white, "pcm1",
        hyst_limit=hyst_limit, shift_limit=shift_limit)
    words, crc_read = _p1.data_bits_to_words(bits)
    return words, crc_read, valid


def pcm16x0_frame_decode(pixels, coords, ref_level, black, white,
                         shift_limit=2, hyst_limit=0):
    """PCM-16x0 frame decode: 3 sublines per line + control bit.

    Returns (words [F, L, 3, 3], crc_read [F, L, 3], valid [F, L, 3],
    ctrl_bit [F, L]).  The three parts share one trial grid (_pcm_grid);
    the control bit is line bit 128 sampled at shift stage 0 with a plain
    threshold.
    """
    from ..formats import pcm16x0 as _p16
    n_h, n_s = hyst_limit + 1, shift_limit + 1
    bits, valid, _pick = _pcm_grid(pixels, coords, ref_level, black, white,
                                   "pcm16x0", n_h, n_s, PCM16X0_PART_STARTS)
    words, crc_read = _p16.data_bits_to_words(bits)
    F, L, W = pixels.shape
    stage0 = torch.zeros(1, dtype=torch.int32, device=pixels.device)
    cpx = _format_coords(coords, "pcm16x0", stage0, 1, PCM16X0_CTRL_BIT,
                         W)                                    # [F, 1, 1]
    cval = torch.gather(pixels, 2, cpx[:, 0].long().expand(F, L)[..., None])
    ctrl = cval[..., 0].to(torch.int32) > ref_level[:, None]
    return words, crc_read, valid, ctrl

