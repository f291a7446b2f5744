"""Histogram AGC: per-line BLACK/WHITE level detection.

Port of Binarizer::findBlackWhite and its helpers (binarizer.cpp:
2450-3551): brightness histogram, noise-filtered useful span, peak search
with early-stop distance windows, contrast/validity checks — plus the
format-specific scan-region selection (findPCM1BW :2560, findPCM16X0BW
:2602, findSTC007BW :2683, findArVidBW :3074): each format feeds the
histogram from regions guaranteed to contain both black and white pixels
(marker zones, CRC areas), so per-line brightness drift (head switching,
AGC pumping) doesn't skew the levels.

Host formulation: per-line histograms are one flattened bincount over
(line_id * 256 + pixel) ids — a single C pass, no Python loop; the
256-step peak scans vectorize across lines.  `line_histograms_device`
is the torch twin for on-device use.

Carried over from sdvpcmdecoder_tpu/ops/agc.py; `line_histograms_device`
is an int32 scatter-add on the tensors' device where the JAX package
contracts a bf16 one-hot (both exact).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# bin_preset_t defaults (binarizer.h:163-186, fine_bin_set defaults).
MAX_BLACK_LVL = 118
MIN_WHITE_LVL = 132
MIN_CONTRAST = 8
MIN_REF_LVL = 2
MAX_REF_LVL = 254
MIN_VALID_CRCS = 3
MARK_MAX_DIST = 15  # percent of line width for marker zones


@dataclass
class BinPreset:
    """Binarizer fine settings (bin_preset_t, binarizer.h:163-186)."""
    max_black_lvl: int = MAX_BLACK_LVL
    min_white_lvl: int = MIN_WHITE_LVL
    min_contrast: int = MIN_CONTRAST
    min_ref_lvl: int = MIN_REF_LVL
    max_ref_lvl: int = MAX_REF_LVL
    min_valid_crcs: int = MIN_VALID_CRCS
    mark_max_dist: int = MARK_MAX_DIST
    en_good_no_marker: bool = False
    en_force_coords: bool = False
    left_bit_pick: int = 6
    right_bit_pick: int = 6


def line_histograms(pixels: np.ndarray, lo: np.ndarray, hi: np.ndarray):
    """Per-line histogram of pixels[i, lo[i]:hi[i]] -> [N, 256].

    One flattened bincount over (line_id*256 + value) ids — no Python
    per-line loop."""
    return region_histograms(pixels, [(lo, hi)])


def region_histograms(pixels: np.ndarray, spans):
    """Accumulated per-line histogram over several pixel spans.

    spans: list of (lo [N] or scalar, hi [N] or scalar); each line i
    accumulates pixels[i, lo[i]:hi[i]) across all spans -> [N, 256].
    """
    N, W = pixels.shape
    from . import stitch_native as _sn
    if (_sn.available() and isinstance(pixels, np.ndarray)
            and pixels.dtype == np.uint8 and pixels.flags.c_contiguous):
        return _sn.region_hist(pixels, spans)
    idx = np.arange(W)[None, :]
    mask = np.zeros((N, W), dtype=bool)
    for lo, hi in spans:
        lo = np.broadcast_to(np.asarray(lo, np.int64), (N,))
        hi = np.broadcast_to(np.asarray(hi, np.int64), (N,))
        mask |= (idx >= lo[:, None]) & (idx < hi[:, None])
    line_id = np.broadcast_to(np.arange(N)[:, None] << 8, (N, W))
    ids = (line_id | pixels)[mask]
    return np.bincount(ids, minlength=N * 256).reshape(N, 256)


def line_histograms_device(pixels, mask):
    """Device twin: per-line masked histogram.

    pixels [N, W] uint8/int tensor, mask [N, W] bool tensor -> hist
    [N, 256] int32 on their device, hist[n, v] = #{w : mask[n, w] and
    pixels[n, w] == v} (values outside 0..255 count nowhere).  An int32
    scatter-add, exact at any width, in place of the JAX package's bf16
    one-hot contraction: CUDA has no integer matmul."""
    import torch
    px = pixels.to(torch.int64)
    counted = mask & (px >= 0) & (px < 256)
    hist = torch.zeros((px.shape[0], 256), dtype=torch.int32,
                       device=pixels.device)
    return hist.scatter_add_(1, px.clamp(0, 255), counted.to(torch.int32))


def _useful_levels(hist: np.ndarray, preset: BinPreset):
    """getUsefullLowLevel / getUsefullHighLevel (binarizer.cpp:2471-2560)."""
    N = hist.shape[0]
    peak = hist.max(axis=-1)
    min_freq = peak // 64
    lv = np.arange(256)[None, :]
    # low: first level < max_black_lvl with count > min_freq (fallback > 0)
    in_lo = lv < preset.max_black_lvl
    cand = (hist > min_freq[:, None]) & in_lo
    cand_fb = (hist > 0) & in_lo
    low = np.where(cand.any(-1), cand.argmax(-1),
                   np.where(cand_fb.any(-1), cand_fb.argmax(-1), 0))
    # high: last level >= min_white_lvl with count > min_freq
    in_hi = lv >= preset.min_white_lvl
    candh = (hist > min_freq[:, None]) & in_hi
    candh_fb = (hist > 0) & in_hi
    rev = lambda m: 255 - m[:, ::-1].argmax(-1)
    high = np.where(candh.any(-1), rev(candh),
                    np.where(candh_fb.any(-1), rev(candh_fb), 255))
    return low.astype(np.int64), high.astype(np.int64)


def _peak_scan(hist, start, stop_limit, min_count, delta, upward=True):
    """Peak search with early-stop window (findBlackWhite :3235-3330).

    Scans from `start` toward `stop_limit` (inclusive), tracking the max
    count; once a qualifying peak is found, stops when the scan moves
    `delta` past it. Native walk when available (the 256-step vector
    loop below stays as the tested reference implementation).
    """
    from . import stitch_native as _sn
    if _sn.available():
        return _sn.peak_scan(hist, start, stop_limit, min_count, delta,
                             upward)
    N = len(start)
    best = np.full(N, -1, dtype=np.int64)
    best_cnt = np.zeros(N, dtype=np.int64)
    found = np.zeros(N, dtype=bool)
    stopped = np.zeros(N, dtype=bool)
    pos = start.copy()
    for _ in range(256):
        active = ~stopped & (pos <= stop_limit if upward
                             else pos >= stop_limit)
        if not active.any():
            break
        cnt = hist[np.arange(N), np.clip(pos, 0, 255)]
        better = active & (cnt > best_cnt)
        best_cnt = np.where(better, cnt, best_cnt)
        qualifies = better & (cnt > min_count)
        best = np.where(qualifies, pos, best)
        found = found | qualifies
        dist = np.abs(pos - best)
        stopped = stopped | (active & found & (dist >= delta))
        pos = pos + (1 if upward else -1)
    return best, found


def _stc007_hist(pixels: np.ndarray, preset: BinPreset, ppb: int):
    """findSTC007BW (binarizer.cpp:2683-3074): marker-aware histogram
    region selection, vectorized across lines.

    1. Edge histogram (START zone 10ppb + STOP zone 20ppb) -> useful span
       and a WHITE peak for the STOP marker.
    2. Central /8-margin histogram as the default.
    3. Backward STOP-marker search at the rough center reference; when a
       marker of >= 2ppb white is found, the histogram is re-filled from
       the 64ppb CRC region left of it (fallback to central when < 32 px).
    """
    N, W = pixels.shape
    end = W - 1
    length = end
    ppb = max(int(ppb), 1)
    eh = region_histograms(
        pixels, [(0, min(10 * ppb, W)), (max(0, end - 20 * ppb), W)])
    ul, uh = _useful_levels(eh, preset)
    rng = uh - ul
    # WHITE peak for the STOP marker: downward scan, early stop range/8.
    white_mark, white_det = _peak_scan(
        eh, uh, uh - rng // 4, np.zeros(N, np.int64),
        np.maximum(rng // 8, 1), upward=False)
    central = region_histograms(pixels, [(length // 8, end - length // 8)])

    # Backward STOP-marker search at the rough center reference.
    mark_dist = (length * preset.mark_max_dist) // 100
    mark_end_min = end - mark_dist
    pixel_limit = max(0, mark_end_min - 6 * ppb)
    ref = ul + (white_mark - ul) // 2
    contrast_ok = white_det & ((white_mark - ul) >= preset.min_contrast)

    above = pixels >= np.clip(ref, 1, 255)[:, None]
    above &= contrast_ok[:, None]
    # Run extraction: starts/ends of maximal True runs per line.
    padded = np.zeros((N, W + 2), dtype=np.int8)
    padded[:, 1:-1] = above
    d = np.diff(padded, axis=1)
    sl, sp = np.nonzero(d == 1)    # run starts (line, pos)
    el, ep = np.nonzero(d == -1)   # run ends (exclusive)
    # sl == el elementwise (same number of transitions per line).
    run_len = ep - sp
    entered = (ep - 1) >= mark_end_min     # right edge within marker zone
    success = entered & (sp > pixel_limit + 1) & (run_len >= 2 * ppb)
    aborted = entered & (sp <= pixel_limit + 1)
    # Right-to-left: an aborted run to the right of a success kills it.
    s_succ = np.full(N, -1, np.int64)
    np.maximum.at(s_succ, sl[success], sp[success])
    s_abort = np.full(N, -1, np.int64)
    np.maximum.at(s_abort, sl[aborted], sp[aborted])
    has_marker = (s_succ >= 0) & (s_succ > s_abort)
    # mark_ed_bit_start = run start; CRC region = 64ppb left of it.
    mark_start = np.where(has_marker, s_succ, 0)
    reg_lo = np.where(mark_start >= 64 * ppb, mark_start - 64 * ppb,
                      (length * preset.mark_max_dist) // 100) + 1
    reg_hi = mark_start
    cnt = reg_hi - 1 - (reg_lo - 1)
    use_marker = has_marker & (cnt >= 32)
    mh = region_histograms(pixels, [(np.where(use_marker, reg_lo, 0),
                                     np.where(use_marker, reg_hi, 0))])
    return np.where(use_marker[:, None], mh, central)


def _format_hist(pixels: np.ndarray, preset: BinPreset, fmt: str,
                 ppb: int | None):
    """Histogram scan-region selection per format (findPCM1BW :2560,
    findPCM16X0BW :2602, findSTC007BW :2683, findArVidBW :3074,
    generic :3149-3166)."""
    N, W = pixels.shape
    end = W - 1
    ln = end
    if fmt == "pcm1":
        spans = [(ln // 8, end - ln // 32)]
    elif fmt == "pcm16x0":
        a = ln // 8
        spans = [(ln // 5, ln // 5 + a),
                 (a * 4 + a // 2, a * 4 + a // 2 + a),
                 (end - ln // 64 - a, end - ln // 64)]
    elif fmt == "arvid":
        spans = [(ln // 32, ln // 4)]
    elif fmt == "stc007":
        return _stc007_hist(pixels, preset, ppb or max(W // 160, 1))
    else:
        spans = [(ln // 16, end - ln // 16)]
    return region_histograms(pixels, spans)


def find_black_white(pixels: np.ndarray, preset: BinPreset | None = None,
                     do_sweep=False, fmt: str = "generic",
                     ppb: int | None = None):
    """findBlackWhite: returns (black [N], white [N], ok [N]).

    fmt selects the histogram scan region ("pcm1", "pcm16x0", "stc007",
    "arvid", "generic"); the peak-search logic below is common
    (binarizer.cpp:3116-3500). ppb (pixels per bit, int) feeds the
    STC-007 marker-zone refinement.
    """
    preset = preset or BinPreset()
    N, W = pixels.shape
    hist = _format_hist(pixels, preset, fmt, ppb)
    useful_low, useful_high = _useful_levels(hist, preset)
    rng = useful_high - useful_low
    low_limit = useful_low + rng // 3
    high_limit = useful_high - rng // 3
    d_black = (rng * 10) // 100
    d_white = (rng * 12) // 100
    min_count = hist.max(axis=-1) // 64

    black, black_ok = _peak_scan(hist, useful_low, low_limit, min_count,
                                 np.maximum(d_black, 1), upward=True)
    black = np.where(black_ok, black, useful_low)
    white, white_ok = _peak_scan(hist, useful_high,
                                 np.maximum(high_limit,
                                            black + preset.min_contrast),
                                 min_count, np.maximum(d_white, 1),
                                 upward=False)
    white = np.where(white_ok, white, useful_high)
    ok = black_ok & white_ok
    # Validity checks (findBlackWhite :3345-3420).
    bad = ((white < black)
           | ((white - black) < preset.min_contrast)
           | (black > preset.max_black_lvl)
           | (white < preset.min_white_lvl))
    if do_sweep:
        bad |= (white - black) < preset.min_valid_crcs
    ok = ok & ~bad
    black = np.where(ok, black, useful_low)
    white = np.where(ok, white, useful_high)
    return black, white, ok
