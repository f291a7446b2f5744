"""Sony PCM-1600/1610/1630 (EIAJ "PCM-16x0") subline format (data model).

Port of sdvpcmdecoder_tpu/formats/pcm16x0.py. From the reference's
PCM16X0SubLine (pcm16x0subline.h:73-125) and Binarizer::fillPCM16X0
(binarizer.cpp):

  line layout : 193 bits = 3 independent 64-bit sublines + 1 control/skew bit
                at line-bit 128 (between middle and right part):
                  LEFT   bits   0..63
                  MIDDLE bits  64..127
                  CTRL   bit   128
                  RIGHT  bits 129..192
  subline     : 3 x 16-bit words + 16-bit CRC, MSB-first
                (word order R1P1L1, L2P2R2, R3P3L3, CRCC)
  CRC         : CRC-16/CCITT-FALSE over the 3 words (pcm16x0subline.cpp)
  samples     : raw int16 (pcm16x0subline getSample)

Interleave (pcm16x0datablock.h:38-60): SI format offset 35 sublines,
EI (PCM-1630) offset 490 sublines; per-sub-block P parity only.

The functions take `xp=torch` (tensors) or `xp=np` (host arrays), as the
JAX package's take `xp=jnp` or `xp=np`.
"""
from __future__ import annotations

import numpy as np
import torch

from . import _xp
from . import crc as crc_mod

BITS_PER_WORD = 16
DATA_WORD_MASK = (1 << BITS_PER_WORD) - 1
BITS_PER_CRC = 16
CRC_WORD_MASK = (1 << BITS_PER_CRC) - 1
BITS_PCM_DATA = BITS_PER_WORD * 3 + BITS_PER_CRC  # 64 per subline
SUBLINES_PER_LINE = 3
BITS_IN_LINE = BITS_PCM_DATA * SUBLINES_PER_LINE + 1  # 193
BITS_LEFT_SHIFT = 34
BITS_RIGHT_SHIFT = 107
CTRL_BIT_INDEX = 2 * BITS_PCM_DATA  # 128: the service/control bit

PART_LEFT, PART_MIDDLE, PART_RIGHT = range(3)
# First line-bit of each part (right part skips the control bit).
PART_START_BIT = (0, BITS_PCM_DATA, 2 * BITS_PCM_DATA + 1)

WORD_R1P1L1, WORD_L2P2R2, WORD_R3P3L3 = range(3)
WORD_CRCC = 3
N_WORDS = 3

CRC_SILENT = 0x0E10  # silent (all-zero) subline CRC (pcm16x0subline.h:104)

# Interleave parameters (pcm16x0datablock.h:38-60).
SI_INTERLEAVE_OFS = 35
EI_INTERLEAVE_OFS = 490
INT_BLK_PER_FIELD = 7
MIN_DEINT_DATA_SI = SI_INTERLEAVE_OFS * 2
MIN_DEINT_DATA_EI = EI_INTERLEAVE_OFS * 2

_WORD_BIT_COUNTS = [BITS_PER_WORD] * N_WORDS + [BITS_PER_CRC]


def calc_crc(words, xp=torch):
    """CRC-16 over the 3 data words [..., >=3] (16 bits, MSB-first)."""
    if xp is np:
        bits = crc_mod.words_to_bits_np(words[..., :N_WORDS], BITS_PER_WORD)
        return crc_mod.crc16_batch_np(bits, N_WORDS * BITS_PER_WORD)
    bits = crc_mod.words_to_bits(words[..., :N_WORDS], BITS_PER_WORD)
    return crc_mod.crc16_batch(bits, N_WORDS * BITS_PER_WORD)


def words_to_data_bits(words, crc, xp=torch):
    """[..., 3] words + crc -> [..., 64] subline bits."""
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


def line_bits(subline_words, subline_crcs, ctrl_bit=0, xp=torch):
    """3 sublines -> full 193-bit video line.

    subline_words [..., 3, 3], subline_crcs [..., 3], ctrl_bit scalar/array.
    """
    parts = [words_to_data_bits(subline_words[..., p, :],
                                subline_crcs[..., p], xp=xp)
             for p in range(SUBLINES_PER_LINE)]
    shape = parts[0].shape[:-1]
    if xp is np:
        ctrl = np.broadcast_to(np.asarray(ctrl_bit, dtype=parts[0].dtype),
                               shape)[..., None]
    else:
        ctrl = torch.as_tensor(ctrl_bit, dtype=parts[0].dtype,
                               device=parts[0].device).expand(shape)[..., None]
    return _xp.cat(xp, [parts[0], parts[1], ctrl, parts[2]])


def expand_sample(words, xp=torch):
    """16-bit words are already int16 samples (pcm16x0subline.cpp)."""
    w = _xp.int32(xp, words) & DATA_WORD_MASK
    out = _xp.where(xp, w >= 0x8000, w - 0x10000, w)
    return out.astype(np.int16) if xp is np else out.to(torch.int16)


def silent_words(xp=np, device=None):
    if xp is np:
        return np.zeros((N_WORDS,), dtype=np.int32)
    return torch.zeros((N_WORDS,), dtype=torch.int32, device=device)
