"""ASCII line dumps with CRC-annotated bit characters.

Port of the reference's debug observability surface (dumpWordsString,
pcmline.h DUMP_* legend: '#'/'-' = 1/0 under a valid CRC, '1'/'0'
under an invalid one; '['']' bracket a word whose CRC state is good,
'@' a bad one; STC-007 lines carry their "1010" START marker header,
stc007line.cpp:683-760).  Works on decoded word arrays, so any layer
(binarizer output, stores, assembled frames) can be dumped.
"""
from __future__ import annotations

import numpy as np

_FMT = {
    "stc007": (8, 14, True),
    "pcm1": (6, 13, False),
    "pcm16x0": (3, 16, False),
}


def dump_line(words, valid, fmt="stc007", crc=None, word_ok=None,
              has_marker=None):
    """One line's words -> the reference's dump string.

    words: per-word ints; valid: line CRC verdict (selects the bit
    charset); word_ok: optional per-word flags for the brackets
    (defaults to the line verdict); crc: the read CRC word, appended
    in its own bracket; has_marker: STC-007 START marker presence."""
    n_words, bits, marker = _FMT[fmt]
    one, zero = ("#", "-") if valid else ("1", "0")
    out = []
    if marker:
        out.append(f"{one}{zero}{one}{zero}" if (has_marker is None
                                                 or has_marker)
                   else zero * 4)
    if word_ok is None:
        word_ok = [valid] * n_words
    for w, ok in zip(list(words)[:n_words], word_ok):
        lb, rb = ("[", "]") if ok else ("@", "@")
        bits_s = "".join(one if (int(w) >> (bits - 1 - b)) & 1 else zero
                         for b in range(bits))
        out.append(f"{lb}{bits_s}{rb}")
    if crc is not None:
        lb, rb = ("[", "]") if valid else ("@", "@")
        bits_s = "".join(one if (int(crc) >> (15 - b)) & 1 else zero
                         for b in range(16))
        out.append(f"{lb}{bits_s}{rb}")
    return "".join(out)


def dump_lines(words, crc_read, valid, fmt="stc007", line_numbers=None,
               limit=None):
    """Batch dump: [L, n_words] + per-line CRC/validity -> list[str]
    (one work-log style row per line)."""
    L = len(valid)
    if limit is not None:
        L = min(L, limit)
    out = []
    for i in range(L):
        num = int(line_numbers[i]) if line_numbers is not None else i
        out.append(f"L[{num:04d}] "
                   + dump_line(np.asarray(words[i]).ravel(),
                               bool(valid[i]), fmt=fmt,
                               crc=int(crc_read[i]))
                   + (" OK" if valid[i] else " --"))
    return out
