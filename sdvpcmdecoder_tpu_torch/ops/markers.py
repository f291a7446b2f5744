"""STC-007 START/STOP marker search -> data coordinates.

Port of Binarizer::searchSTC007Markers (binarizer.cpp:5275-5601) and
findSTC007Coordinates (:6047-6116): forward edge-walk for the "1010"
START marker with bit-length sanity resets, backward walk for the "01111"
STOP marker, optional hysteresis sweep picking the best coordinate pair.

Production path: the per-line walks run in the native core
(stitchcore.cpp stc007_marker_search, ~0.2 ms for a 588-line frame);
the Python loops below are the bit-identical reference implementation
(tests/test_marker_native.py).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from . import agc

# Marker stages (stc007line.h:124-140).
MARK_ST_START, MARK_ST_TOP_1, MARK_ST_BOT_1, MARK_ST_TOP_2, MARK_ST_BOT_2 \
    = range(5)
MARK_ED_START, MARK_ED_TOP, MARK_ED_BOT, MARK_ED_LEN_OK = range(4)


@dataclass
class MarkerResult:
    start_found: np.ndarray    # [N] bool
    stop_found: np.ndarray     # [N] bool
    data_start: np.ndarray     # [N] int: coord of START bit 2 start
    data_stop: np.ndarray      # [N] int: coord of STOP marker start
    start_bg: np.ndarray       # [N] marker_start_bg_coord
    start_ed: np.ndarray       # [N] marker_start_ed_coord
    stop_ed: np.ndarray        # [N] marker_stop_ed_coord


def _search_start_line(px, bin_low, bin_high, mark_start_max, ppb, limit):
    """Forward START search for one line (searchSTC007Markers :5310-5420).

    Returns (stage, bit1_start, bit1_end, bit3_end)."""
    W = len(px)
    limit = min(limit, W)
    stage = MARK_ST_START
    b1s = b1e = b3s = b3e = 0
    i = 0
    while i < limit:
        v = px[i]
        if stage == MARK_ST_START:
            if i > mark_start_max:
                break
            if v >= bin_low:
                b1s = i
                stage = MARK_ST_TOP_1
        elif stage == MARK_ST_TOP_1:
            if v < bin_low:
                b1e = i
                stage = MARK_ST_BOT_1
        elif stage == MARK_ST_BOT_1:
            if v >= bin_high:
                b3s = i
                zero_len = b3s - b1e
                if zero_len > 2 * ppb or zero_len < ppb // 2:
                    stage = MARK_ST_START
                    continue  # re-examine this pixel as a new 1st bit
                stage = MARK_ST_TOP_2
        elif stage == MARK_ST_TOP_2:
            if v < bin_high:
                b3e = i
                one_len = b3e - b3s
                if one_len > 2 * ppb or one_len < ppb // 2:
                    stage = MARK_ST_START
                    continue
                stage = MARK_ST_BOT_2
                break
        i += 1
    return stage, b1s, b1e, b3e


def _search_stop_line(px, bin_level, mark_end_min, ppb, scan_end):
    """Backward STOP search (:5440-5590). Returns (stage, start, end)."""
    stage = MARK_ED_START
    ed_start = ed_end = 0
    lo_limit = mark_end_min - ppb * 6 if mark_end_min > ppb * 6 else 0
    i = scan_end
    while i > lo_limit:
        v = px[i]
        if stage == MARK_ED_START:
            if i < mark_end_min:
                break
            if v >= bin_level:
                ed_end = i + 1
                stage = MARK_ED_TOP
        elif stage == MARK_ED_TOP:
            if v < bin_level:
                ed_start = i + 1
                if (ed_end - ed_start) >= 2 * ppb:
                    stage = MARK_ED_LEN_OK
                    break
                stage = MARK_ED_START
        i -= 1
    return stage, ed_start, ed_end


def search_markers(pixels: np.ndarray, ref_level: np.ndarray,
                   hyst_lvl: int = 0,
                   preset: agc.BinPreset | None = None):
    """Marker search for a batch of lines [N, W]. Returns MarkerResult.

    data_start = end coordinate of START marker (start of bit 2 of the
    marker = coords.data_start, searchSTC007Markers stores marker
    coords into the line's data coordinates); data_stop = first pixel of
    the STOP marker "1111" run.
    """
    preset = preset or agc.BinPreset()
    N, W = pixels.shape
    ppb = max(1, round(W * 1.0 / 137))
    mark_start_max = W * preset.mark_max_dist // 100
    mark_end_min = (W - 1) - mark_start_max
    limit = min(W, mark_start_max + ppb * 5)

    from . import stitch_native as _sn
    if _sn.available():
        # Native walk (~100x the Python loop); the loops below stay as
        # the reference implementation, tests assert bit-identity.
        ref = np.asarray(ref_level, np.int64)
        bin_low = np.maximum(ref - hyst_lvl, preset.min_ref_lvl)
        st, ed, dstart, dstop, sbg, sed, eed = _sn.marker_search(
            pixels, bin_low, ref, mark_start_max, mark_end_min, ppb,
            limit)
        # Python semantics: the stop search only runs for start-found
        # lines (outputs already zeroed otherwise in the native core).
        return MarkerResult(st, ed, dstart, dstop, sbg, sed, eed)

    st_found = np.zeros(N, bool)
    ed_found = np.zeros(N, bool)
    dstart = np.zeros(N, np.int64)
    dstop = np.zeros(N, np.int64)
    sbg = np.zeros(N, np.int64)
    sed = np.zeros(N, np.int64)
    eed = np.zeros(N, np.int64)
    for n in range(N):
        ref = int(ref_level[n])
        bin_low = max(ref - hyst_lvl, preset.min_ref_lvl)
        bin_high = ref
        stage, b1s, b1e, b3e = _search_start_line(
            pixels[n], bin_low, bin_high, mark_start_max, ppb, limit)
        st_found[n] = stage == MARK_ST_BOT_2
        sbg[n] = b1s
        sed[n] = b3e
        if st_found[n]:
            # coords = (mark_st_1bit_end, mark_ed_bit_start)
            # (searchSTC007Markers binarizer.cpp:5590).
            dstart[n] = b1e
            stage_e, ed_s, ed_e = _search_stop_line(
                pixels[n], bin_high, mark_end_min, ppb, W - 1)
            ed_found[n] = stage_e == MARK_ED_LEN_OK
            dstop[n] = ed_s
            eed[n] = ed_e
    return MarkerResult(st_found, ed_found, dstart, dstop, sbg, sed, eed)


def coords_from_markers(res: MarkerResult):
    """(data_start, data_stop, valid) from a MarkerResult."""
    ok = res.start_found & res.stop_found
    return res.data_start, res.data_stop, ok
