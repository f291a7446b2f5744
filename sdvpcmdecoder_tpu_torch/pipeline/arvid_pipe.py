"""ArVid Audio prototype decode pipeline.

The reference's ArVid support is a prototype reachable only through the
debug path (videotodigital.cpp:857-858, 963-964): per-line binarization
via fillArVidAudio (binarizer.cpp:7448, hysteresis read of 144 data
bits into 18 x 8-bit words) with findArVidBW AGC (:3072, START-marker
region histogram), then word dumps (arvidline dumpWordsString) — its CRC
and sample conversion are TODO stubs (arvidline.cpp:127-150).

This pipeline covers the same surface batch-style: whole-frame
vectorized binarization with the format's AGC region, plus the dump
writer.  No audio is produced, faithfully to the prototype.

Port of sdvpcmdecoder_tpu/pipeline/arvid_pipe.py.  The ArVid path is
host numpy in the JAX package too (hysteresis_read_np, find_black_white),
and stays on the host here by that design, not as a fallback from the
card: it has no trial grid, and the prototype's dump is the whole output.
"""
from __future__ import annotations

import numpy as np

from ..formats import arvid
from ..ops import agc, binarize as bz
from ..ops import line_decode_np as ld
from .v2d import _imed

SAMPLE_LINES = 4  # AGC sample spread, the V2D prescan convention


def decode_frames(frames: np.ndarray, coords=None, depth=0,
                  preset: agc.BinPreset | None = None):
    """Binarize ArVid frames [F, L, W] -> (words [F, L, 18] uint8,
    refs [F]).

    coords: (start, stop) data coordinates; defaults to the full line
    (the debug path binarizes at the configured scan window).  depth:
    hysteresis depth (fillArVidAudio ref_delta)."""
    preset = preset or agc.BinPreset()
    F, L, W = frames.shape
    if coords is None:
        coords = (0, W - 1)
    start, stop = coords
    gap = max(L // (SAMPLE_LINES + 1), 1)
    idx = np.arange(1, SAMPLE_LINES + 1) * gap
    idx = idx[idx < L]
    sample = np.ascontiguousarray(frames[:, idx, :]).reshape(-1, W)
    blk, wht, ok = agc.find_black_white(sample, preset, fmt="arvid")
    blk = blk.reshape(F, -1)
    wht = wht.reshape(F, -1)
    ok = ok.reshape(F, -1)
    refs = np.empty(F, np.int64)
    for f in range(F):
        sel = ok[f] if ok[f].any() else np.ones(blk.shape[1], bool)
        refs[f] = (_imed(blk[f][sel]) + _imed(wht[f][sel])) // 2
    cpx, _ = ld.bit_coords(ld.SPEC_ARVID, start, stop, 0, W)
    px = frames[:, :, cpx].reshape(F * L, arvid.BITS_PCM_DATA)
    rl = np.maximum(refs - depth, 1).repeat(L)
    rh = np.minimum(refs + depth, 254).repeat(L)
    bits = bz.hysteresis_read_np(px, rl, rh)
    weights = (1 << np.arange(arvid.BITS_PER_WORD - 1, -1,
                              -1)).astype(np.int32)
    words = bits.reshape(F, L, arvid.WORD_CNT,
                         arvid.BITS_PER_WORD) @ weights
    return words.astype(np.uint8), refs


def dump_words_lines(words_frame: np.ndarray, frame_number: int):
    """dumpWordsString analog for one frame -> list of text lines."""
    out = []
    for li, row in enumerate(words_frame):
        hexs = " ".join(f"{int(w):02X}" for w in row)
        out.append(f"F[{frame_number:05d}] L[{li:03d}] {hexs}")
    return out


def decode_to_dump(frames, path, first_frame_number=1, coords=None,
                   depth=0, bin_path=None):
    """Decode frames and append the word dump to `path` (text) and
    optionally the raw words to `bin_path`.  Returns frames decoded."""
    words, _refs = decode_frames(frames, coords=coords, depth=depth)
    with open(path, "a") as fh:
        for f in range(words.shape[0]):
            for line in dump_words_lines(words[f],
                                         first_frame_number + f):
                fh.write(line + "\n")
    if bin_path is not None:
        with open(bin_path, "ab") as fh:
            fh.write(words.tobytes())
    return words.shape[0]
