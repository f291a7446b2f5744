"""Automatic PCM format detection (BASELINE config 5 "auto format
search").

The reference routes a USER-SET pcm_type (videotodigital.h:125-126) and
never guesses; batch jobs over unlabeled captures need the guess.  Each
format family carries its own cheap, high-confidence signature on a few
spread lines:

  * STC-007 — START/STOP marker pairs (searchSTC007Markers semantics,
    ops/markers.py): white 1-0-1 start + "1111" stop marks;
  * PCM-1 / PCM-16x0 — the CRC-statistics coordinate search
    (searchPCM1Data semantics, ops/line_decode_np.search_coordinates):
    a hit requires CRC-consistent reads across an offset grid, which is
    vanishingly unlikely on the wrong format.

Scores are hit RATES over the probed lines; the best rate above a floor
wins, ties prefer STC-007 (the common case).

Carried over from sdvpcmdecoder_tpu/pipeline/probe.py (numpy).
"""
from __future__ import annotations

import numpy as np

from ..ops import agc, line_decode_np as ld, markers
from . import ingest

PROBE_MARKER_LINES = 24   # lines given to the marker scan
PROBE_SEARCH_LINES = 6    # lines given to each coordinate search
MIN_SCORE = 0.25          # below this rate nothing is trusted


def probe_format(frames: np.ndarray, preset: agc.BinPreset | None = None):
    """Guess the PCM format of raw frames [F, H, W].

    Returns (fmt, scores): fmt in {"stc007", "pcm1", "pcm16x0", None};
    scores = per-family hit rates."""
    preset = preset or agc.BinPreset()
    lines, _ = ingest.split_fields_batch(frames)
    FL = lines.reshape(-1, lines.shape[-1])
    N, W = FL.shape
    if N == 0:
        return None, {}
    idx = np.unique(np.linspace(0, N - 1, PROBE_MARKER_LINES,
                                dtype=np.int64))
    sample = np.ascontiguousarray(FL[idx])
    blk, wht, ok = agc.find_black_white(sample, preset)
    refs = np.clip((blk + wht) // 2, preset.min_ref_lvl, 254)
    scores = {}
    res = markers.search_markers(sample, refs)
    scores["stc007"] = float((np.asarray(res.start_found)
                              & np.asarray(res.stop_found)).mean())
    sub = np.unique(np.linspace(0, len(idx) - 1, PROBE_SEARCH_LINES,
                                dtype=np.int64))
    for fmt in ("pcm1", "pcm16x0"):
        hits = 0
        for k in sub:
            sw = ld.search_coordinates(
                sample[k], int(refs[k]), int(blk[k]), int(wht[k]), W,
                fmt=fmt, preset=preset)
            hits += sw is not None
        scores[fmt] = hits / len(sub)
    best = max(scores, key=lambda f: (scores[f],
                                      f == "stc007"))  # tie -> stc007
    if scores[best] < MIN_SCORE:
        return None, scores
    return best, scores


def probe_capture(path, raw_size=None, n_frames=2,
                  preset: agc.BinPreset | None = None):
    """probe_format over the first frames of a capture file."""
    with ingest.open_capture(path, raw_size=raw_size) as rd:
        frames = rd.read_frames(0, n_frames)
    if frames.shape[0] == 0:
        return None, {}
    return probe_format(frames, preset=preset)
