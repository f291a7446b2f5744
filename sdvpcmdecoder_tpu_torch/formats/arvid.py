"""ArVid Audio prototype line format (data model).

Mirror of the reference's ArVidLine (arvidline.{h,cpp}): a debug-only
prototype reachable through hidden paths (videotodigital.cpp:857-858).
12-bit START marker + 144 data bits as 18 x 8-bit words; the reference's
CRC and sample conversion are unimplemented TODOs (arvidline.cpp:127-150),
so this model carries layout only.

Carried over from sdvpcmdecoder_tpu/formats/arvid.py (numpy).
"""
from __future__ import annotations

import numpy as np

BITS_PER_WORD = 8
WORD_MASK = (1 << BITS_PER_WORD) - 1
BITS_START = 12
BITS_PCM_DATA = 144
BITS_IN_LINE = BITS_START + BITS_PCM_DATA  # 156
BITS_LEFT_SHIFT = 24
BITS_RIGHT_SHIFT = 96
WORD_CNT = 18


def words_to_data_bits(words, xp=np):
    """[..., 18] 8-bit words -> [..., 144] bits MSB-first."""
    shifts = np.arange(BITS_PER_WORD - 1, -1, -1)
    bits = (words[..., :, None].astype(xp.int32) >> shifts) & 1
    return bits.reshape(bits.shape[:-2] + (BITS_PCM_DATA,))


def data_bits_to_words(bits, xp=np):
    b = bits.reshape(bits.shape[:-1] + (WORD_CNT, BITS_PER_WORD))
    weights = (1 << np.arange(BITS_PER_WORD - 1, -1, -1)).astype(np.int32)
    return xp.sum(b.astype(xp.int32) * weights, axis=-1)


def silent_words(xp=np):
    return xp.zeros((WORD_CNT,), dtype=xp.int32)
