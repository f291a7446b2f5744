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
    stage = torch.as_tensor(shift_stage, device=device).long()
    bg = torch.as_tensor(PIX_SH_BG, device=device)[stage]
    ed = torch.as_tensor(PIX_SH_ED, device=device)[stage]
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


def _table(table, host_table, device):
    if table is None:
        return torch.as_tensor(host_table, device=device)
    return table


def _syndrome(bits, synd_table):
    """Packed CRC syndrome of [..., 128] bits (0 for a valid line)."""
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
    return LineBatch(
        words=torch.take_along_dim(words_t, pick[None, :, None], dim=0)[0],
        crc_read=sel(crc_read_t),
        crc_calc=sel(crc_calc_t),
        valid=any_valid,
        hyst=torch.as_tensor(hh.ravel(), dtype=torch.int32,
                             device=device)[pick],
        shift=torch.as_tensor(ss.ravel(), dtype=torch.int32,
                              device=device)[pick],
    )


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
    F, L, W = pixels.shape
    n_h, n_s = hyst_limit + 1, shift_limit + 1
    device = pixels.device
    synd_table = _table(synd_table, _syndrome_const()[0], device)
    pack_weights = _table(pack_weights, _pack_weights(), device)
    pc = stc007_frame_bit_coords(coords, n_s, W).long()      # [F, S, 128]
    px = torch.stack([
        torch.gather(pixels, 2, pc[:, s, None, :].expand(F, L, -1))
        for s in range(n_s)], dim=1)                         # [F,S,L,128] u8
    # Levels broadcast against [F, S, L]: per frame or per line.
    if ref_level.dim() == 2:
        lvl = lambda t: t[:, None, :]
    else:
        lvl = lambda t: t[:, None, None]
    T = n_h * n_s
    pick = torch.full((F, L), T, dtype=torch.int32, device=device)
    chosen = fallback = None
    for h in range(n_h):
        rl = torch.clamp(ref_level - h, min=1)
        rh = torch.clamp(ref_level + h, max=254)
        read_ok = lvl((rl > black) & (rh < white))
        bits = hysteresis_read(px, lvl(rl), lvl(rh))         # [F,S,L,128]
        valid = (_syndrome(bits, synd_table) == 0) & read_ok  # [F,S,L]
        if h == 0:
            fallback = bits[:, 0]
            chosen = fallback
        for s in range(n_s):
            take = valid[:, s] & (pick == T)
            pick = torch.where(take, h * n_s + s, pick)
            chosen = torch.where(take[..., None], bits[:, s], chosen)
    any_valid = pick < T
    pick = torch.where(any_valid, pick, 0)
    words16 = torch.stack(
        [(chosen * pack_weights[:, c]).sum(-1, dtype=torch.int32)
         for c in range(stc007.N_WORDS + 1)], dim=-1)        # [F, L, 9]
    words = words16[..., :stc007.N_WORDS]
    return LineBatch(words=words, crc_read=words16[..., stc007.WORD_CRCC],
                     crc_calc=stc007.calc_crc(words), valid=any_valid,
                     hyst=pick // n_s, shift=pick % n_s)


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
