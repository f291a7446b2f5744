"""The comparison that decides `correct`: a capture's WAV from the window
against the plain reference's decode of the same capture.

The WAV may open with samples the reference does not number (the
stitcher emits the silent blocks before the first audio block), so it is
first aligned: the offset at which the most reference-valid samples of
the capture's head match. Then every reference-valid word (one channel of
one sample) is looked up in the WAV at that offset; a word that is absent
or differs is wrong. So is each word the reference leaves invalid in a
short dropout (at most 16 words of one channel, between runs of at least
28 valid words) where the WAV holds neither its true sample nor the
word-scope linear interpolation of the reference's two anchors: the
masking that `--mask interpolate --mask-scope word` states (upstream
AudioProcessor, rangeLinearInterpolation, audioprocessor.cpp:635-737, in
x16 fixed point). Longer dropouts take the ramp and stray rules
(:268-495, :740-1200), which this does not model: their words are not
compared. Counted per WAV: the reference's valid words and the wrong
ones among them, the same over the words of blocks the reference read
with no word erased, which no masking rule touches, and the masked words
compared and the wrong ones among them.
"""
from __future__ import annotations

import numpy as np

HEAD = 4096          # reference samples the alignment looks at
PROBES = 256         # of which this many valid ones are tried
MAX_SHIFT = 2048     # |offset| searched, in samples
MAX_GAP = 16         # audioprocessor.h:70: a longer invalid run is long
ANCHOR = 28          # :71, the stray window: a valid run this long stays
MULT = 16            # :79-83, the fixed point of the interpolation


def _round_div(num, den):
    """num / den rounded half away from zero (integers)."""
    q = (np.abs(num) + den // 2) // den
    return np.where(num >= 0, q, -q)


def interpolated(ref: np.ndarray, valid: np.ndarray):
    """(expected [N, 2] int64, masked [N, 2] bool): each channel's invalid
    runs of at most MAX_GAP words between valid runs of at least ANCHOR
    words, filled by linear interpolation of their two anchors."""
    expected = ref.astype(np.int64)
    masked = np.zeros(valid.shape, bool)
    for ch in range(valid.shape[1]):
        v = valid[:, ch].astype(np.int8)
        edges = np.flatnonzero(np.diff(np.concatenate([[1], v, [1]])))
        starts, stops = edges[0::2], edges[1::2]    # invalid [start, stop)
        if len(starts) == 0:
            continue
        prev_valid = starts - np.concatenate([[0], stops[:-1]])
        next_valid = np.append(starts[1:], len(v)) - stops
        keep = (starts > 0) & (stops < len(v)) \
            & (stops - starts <= MAX_GAP) \
            & (prev_valid >= ANCHOR) & (next_valid >= ANCHOR)
        for a0, b0 in zip(starts[keep], stops[keep]):
            a, b = a0 - 1, b0                      # the anchors
            la, lb = int(ref[a, ch]), int(ref[b, ch])
            k = np.arange(1, b - a)
            if la == lb:
                expected[a0:b0, ch] = la
            else:
                step = _round_div(lb * MULT - la * MULT, b - a)
                expected[a0:b0, ch] = _round_div(step * k + la * MULT, MULT)
            masked[a0:b0, ch] = True
    return expected, masked


def align(wav: np.ndarray, ref: np.ndarray, valid: np.ndarray):
    """Offset of the WAV against the reference (WAV sample i is reference
    sample i - offset), or None where no probe matches."""
    both = np.nonzero(valid[:HEAD].all(1))[0]
    if len(both) == 0 or len(wav) == 0:
        return None
    probes = both[np.linspace(0, len(both) - 1, min(PROBES, len(both)))
                  .astype(np.int64)]
    shifts = np.arange(-MAX_SHIFT, MAX_SHIFT + 1)
    idx = probes[None, :] + shifts[:, None]             # [S, P] WAV rows
    inside = (idx >= 0) & (idx < len(wav))
    got = wav[np.clip(idx, 0, len(wav) - 1)]            # [S, P, 2]
    hit = inside & (got == ref[probes][None]).all(-1)
    score = hit.sum(1)
    best = int(np.argmax(score))
    return int(shifts[best]) if score[best] else None


def judge(wav, ref, valid, intact, true):
    """dict(wrong, valid, wrong_intact, intact, wrong_masked, masked,
    offset) of one WAV (samples [M, 2] int16, or None for a missing or
    unreadable file) against the reference's decode (ref, valid, intact)
    and the samples the capture was made from (true): counts of words."""
    expected, masked = interpolated(ref, valid)
    n = dict(valid=int(valid.sum()), intact=int(intact.sum()),
             masked=int(masked.sum()))
    off = None if wav is None else align(wav, ref, valid)
    if off is None:
        return dict(n, wrong=n["valid"], wrong_intact=n["intact"],
                    wrong_masked=n["masked"], offset=None)
    j = np.arange(len(ref)) + off
    have = (j >= 0) & (j < len(wav))
    got = np.zeros_like(ref)
    got[have] = wav[j[have]]
    bad = ~(have[:, None] & (got == ref))
    m = min(len(true), len(ref))
    fine = np.zeros(ref.shape, bool)
    fine[:m] = got[:m] == true[:m]
    fine |= got == expected
    bad_masked = ~(have[:, None] & fine) & masked
    return dict(n, wrong=int((bad & valid).sum()),
                wrong_intact=int((bad & intact).sum()),
                wrong_masked=int(bad_masked.sum()), offset=off)
