"""Sony PCM-1 line format (13-bit companded, data model layer).

Port of sdvpcmdecoder_tpu/formats/pcm1.py. From the reference's PCM1Line
(pcm1line.h:59-149, pcm1line.cpp):

  line layout : 94 bits = 6 x 13-bit audio words + 16-bit CRC, no markers
  word order  : L2, R2, L4, R4, L6, R6, CRCC (pcm1line.h:83-93)
  CRC         : CRC-16/CCITT-FALSE fed the BITWISE COMPLEMENT of each 13-bit
                word, final value complemented (pcm1line.cpp:158-171)
  samples     : ranged/companded 13->16: range bit (1<<12) clear -> word<<4;
                set -> sign bit (1<<11), low range word<<2 with sign-extended
                MSBs (pcm1line.cpp:196-233)

The functions take `xp=torch` (tensors, on their own device; words and
CRCs int32) or `xp=np` (host arrays, with numpy's dtypes), as the JAX
package's take `xp=jnp` or `xp=np`.
"""
from __future__ import annotations

import numpy as np
import torch

from . import _xp
from . import crc as crc_mod

BITS_PER_WORD = 13
DATA_WORD_MASK = (1 << BITS_PER_WORD) - 1
BITS_PER_CRC = 16
CRC_WORD_MASK = (1 << BITS_PER_CRC) - 1
BITS_PCM_DATA = BITS_PER_WORD * 6 + BITS_PER_CRC  # 94
BITS_IN_LINE = BITS_PCM_DATA
BITS_LEFT_SHIFT = 16
BITS_RIGHT_SHIFT = 52
BIT_RANGE_POS = 1 << 12
BIT_SIGN_POS = 1 << 11
SUBLINES_PER_LINE = 3

WORD_L2, WORD_R2, WORD_L4, WORD_R4, WORD_L6, WORD_R6 = range(6)
WORD_CRCC = 6
N_WORDS = 6

CRC_SILENT = 0xECBF  # silent line (all words = BIT_RANGE_POS), pcm1line.h:98

# Interleave (pcm1datablock.h:37-59): word-pair interleave, 8 blocks/field.
INT_BLK_PER_FIELD = 8
MIN_DEINT_DATA = 735
WORDP_STRIPE_ONE_OFS = 0
WORDP_STRIPE_TWO_OFS = 46
WORDP_STRIPE_LEN = 46
WORDP_STRIPE_SHORT = 45
BLOCK_WORD_CNT = WORDP_STRIPE_LEN * 4        # 184
BLOCK_WORD_CNT_SHORT = BLOCK_WORD_CNT - 2    # 182

_WORD_BIT_COUNTS = [BITS_PER_WORD] * N_WORDS + [BITS_PER_CRC]


# Header/footer service line pattern (pcm1line.cpp:314-323): fixed words
# with source CRC 0xCCCC (the calculated CRC does NOT match — header lines
# are special-cased as valid).
HEADER_WORDS = (0x0666, 0x0CCC, 0x1999, 0x1333, 0x0666, 0x0CCC)
HEADER_CRC = 0xCCCC


def is_header(words, source_crc, xp=np):
    """PCM1Line::hasHeader (pcm1line.cpp:314-323)."""
    m = source_crc == HEADER_CRC
    for i, w in enumerate(HEADER_WORDS):
        m = m & (words[..., i] == w)
    return m


def calc_crc(words, xp=torch):
    """CRC-16 with complemented input words and complemented result
    (pcm1line.cpp:158-171)."""
    inv = (~words[..., :N_WORDS]) & DATA_WORD_MASK
    if xp is np:
        bits = crc_mod.words_to_bits_np(inv, BITS_PER_WORD)
        c = crc_mod.crc16_batch_np(bits, N_WORDS * BITS_PER_WORD)
    else:
        bits = crc_mod.words_to_bits(inv, BITS_PER_WORD)
        c = crc_mod.crc16_batch(bits, N_WORDS * BITS_PER_WORD)
    return (~c) & CRC_WORD_MASK


def words_to_data_bits(words, crc, xp=torch):
    """[..., 6] words + crc -> [..., 94] line bits (MSB-first per word).

    NOTE: the line carries the words as recorded (NOT complemented); only the
    CRC computation complements them internally.
    """
    if xp is np:
        allw = np.concatenate([words[..., :N_WORDS],
                               crc[..., None].astype(words.dtype)], axis=-1)
        return crc_mod.words_to_bits_np(allw, _WORD_BIT_COUNTS)
    allw = torch.cat([words[..., :N_WORDS],
                      crc[..., None].to(words.dtype)], dim=-1)
    return crc_mod.words_to_bits(allw, _WORD_BIT_COUNTS)


def data_bits_to_words(bits, xp=torch):
    words = []
    pos = 0
    for nb in _WORD_BIT_COUNTS:
        words.append(_xp.bits_to_int(xp, bits[..., pos:pos + nb]))
        pos += nb
    return _xp.stack(xp, words[:N_WORDS]), words[N_WORDS]


def expand_sample(words, xp=torch):
    """13-bit companded words -> int16 samples (pcm1line.cpp:196-233)."""
    w = _xp.int32(xp, words) & DATA_WORD_MASK
    hi = (w << 4) & 0xFFFF
    neg = (w & BIT_SIGN_POS) != 0
    lo = (w & ~BIT_RANGE_POS) << 2
    lo = _xp.where(xp, neg, lo | ((1 << 15) | (1 << 14)), lo) & 0xFFFF
    out = _xp.where(xp, (w & BIT_RANGE_POS) == 0, hi, lo)
    out = _xp.where(xp, out >= 0x8000, out - 0x10000, out)
    return out.astype(np.int16) if xp is np else out.to(torch.int16)


def silent_words(xp=np, device=None):
    if xp is np:
        return np.full((N_WORDS,), BIT_RANGE_POS, dtype=np.int32)
    return torch.full((N_WORDS,), BIT_RANGE_POS, dtype=torch.int32,
                      device=device)
