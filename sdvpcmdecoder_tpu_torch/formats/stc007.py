"""STC-007 / STC-008 / PCM-F1 / M2 line format (data model layer).

Port of sdvpcmdecoder_tpu/formats/stc007.py: bit-exact constants and
conversions from the reference's STC007Line (stc007line.h:68-227,
stc007line.cpp) as torch tensor ops.

  line layout : START "1010" (4b) + 128 data bits + STOP "01111" (5b) = 137
  data bits   : 8 x 14-bit words (6 audio + P + Q) MSB-first, then 16-bit CRC
  CRC         : CRC-16/CCITT-FALSE over the 8 words, 14 bits each
  samples     : 14->16 bit left-shift; M2 mode uses range bit (1<<13) and
                sign bit (1<<12) companding (stc007line.cpp:282-326)

Words, CRCs and flags are int32 as in the JAX package; samples are int16.
"""
from __future__ import annotations

import numpy as np
import torch

from . import crc as crc_mod

# --- bit counts (stc007line.h:72-87) ---
BITS_PER_WORD = 14
DATA_WORD_MASK = (1 << BITS_PER_WORD) - 1
BITS_PER_F1_WORD = 16
BITS_PER_CRC = 16
CRC_WORD_MASK = (1 << BITS_PER_CRC) - 1
BITS_START = 4
BITS_PCM_DATA = 128
BITS_STOP = 5
BITS_IN_LINE = BITS_START + BITS_PCM_DATA + BITS_STOP  # 137
BITS_LEFT_SHIFT = 24    # highest bit number (line-indexed) for left shift zone
BITS_RIGHT_SHIFT = 76   # lowest bit number for right shift zone
BIT_M2_RANGE_POS = 1 << 13
BIT_M2_SIGN_POS = 1 << 12
# Data coordinates capture START bits 2-4 and 1 empty bit before STOP
# (stc007line.cpp:219-223); first data bit sits 3 bit-cells after data_start.
BITS_BETWEEN_COORDS = 3 + BITS_PCM_DATA + 1  # 132
COORD_BIT_OFS = BITS_START - 1               # 3

# --- word indices (stc007line.h:89-102) ---
WORD_L0, WORD_R0, WORD_L1, WORD_R1, WORD_L2, WORD_R2, WORD_P, WORD_Q = range(8)
WORD_CRCC = 8
N_WORDS = 8          # data words per line (audio + P + Q)
N_AUDIO_WORDS = 6

CRC_SILENT = 0xA96A  # CRC of the all-zero (silent) line (stc007line.h:120)

# Interleave parameters (stc007datablock.h:38-59).
INTERLEAVE_OFS = 16
LINE_OFFSETS = tuple(INTERLEAVE_OFS * i for i in range(8))  # L0..Q0
MIN_DEINT_DATA = LINE_OFFSETS[-1]  # 112

# PCM-F1 16-bit reconstruction from S-word (stc007datablock.h:80-92).
F1_S_MASK = 0x0003
F1_S_OFFSETS = (12, 10, 8, 6, 4, 2, 0)  # L0,R0,L1,R1,L2,R2,P0
F1_WORD_OFS = 2

# Control Block constants (stc007line.h:104-152, stc007line.cpp:359-504).
CTRL_FMT_ID = 0x3000
CTRL_FMT_M2 = 0x1000
CTRL_COPY_MASK = 0x0008
CTRL_EN_P_MASK = 0x0004
CTRL_EN_Q_MASK = 0x0002
CTRL_EMPH_MASK = 0x0001
CTRL_ZERO_MASK = 0x0FF0
CB_CUE1 = 0x3333
CB_CUE2 = 0x0CCC

START_MARKER_BITS = np.array([1, 0, 1, 0], dtype=np.int32)
STOP_MARKER_BITS = np.array([0, 1, 1, 1, 1], dtype=np.int32)

_WORD_BIT_COUNTS = [BITS_PER_WORD] * N_WORDS + [BITS_PER_CRC]


def calc_crc(words: torch.Tensor) -> torch.Tensor:
    """CRC-16 over the 8 data words [..., >=8] (14 bits each, MSB-first)."""
    bits = crc_mod.words_to_bits(words[..., :N_WORDS], BITS_PER_WORD)
    return crc_mod.crc16_batch(bits, N_WORDS * BITS_PER_WORD)


def crc_syndrome_table():
    """Linear map: 128 data bits -> 16 syndrome bits (calc_crc ^ read_crc).

    syndrome == 0  <=>  line CRC valid. Returns (TABLE [128,16] uint8, CONST).
    """
    table, const = crc_mod.crc16_linear_table(N_WORDS * BITS_PER_WORD)
    # Append the 16 read-CRC bits: they XOR straight into the syndrome.
    read = np.zeros((BITS_PER_CRC, 16), dtype=np.uint8)
    for i in range(BITS_PER_CRC):       # stream order: CRC MSB first
        read[i, BITS_PER_CRC - 1 - i] = 1
    return np.concatenate([table, read], axis=0), const


def words_to_data_bits(words: torch.Tensor,
                       crc: torch.Tensor) -> torch.Tensor:
    """[..., 8] words + [...] crc -> [..., 128] data-bit matrix (MSB-first)."""
    allw = torch.cat([words[..., :N_WORDS],
                      crc[..., None].to(words.dtype)], dim=-1)
    return crc_mod.words_to_bits(allw, _WORD_BIT_COUNTS)


def data_bits_to_words(bits: torch.Tensor):
    """[..., 128] bits -> ([..., 8] words, [...] crc). Inverse of the above."""
    words = []
    pos = 0
    for nb in _WORD_BIT_COUNTS:
        chunk = bits[..., pos:pos + nb].to(torch.int32)
        weights = 1 << torch.arange(nb - 1, -1, -1, dtype=torch.int32,
                                    device=bits.device)
        words.append((chunk * weights).sum(-1, dtype=torch.int32))
        pos += nb
    return torch.stack(words[:N_WORDS], dim=-1), words[N_WORDS]


def line_bits(words: torch.Tensor, crc: torch.Tensor) -> torch.Tensor:
    """Full 137-bit line: START + 128 data bits + STOP."""
    data = words_to_data_bits(words, crc)
    shape = data.shape[:-1]
    start = torch.as_tensor(START_MARKER_BITS, device=data.device)
    stop = torch.as_tensor(STOP_MARKER_BITS, device=data.device)
    return torch.cat([start.expand(shape + (BITS_START,)), data,
                      stop.expand(shape + (BITS_STOP,))], dim=-1)


def expand_sample(words: torch.Tensor, m2: bool = False) -> torch.Tensor:
    """14-bit words -> int16 samples (stc007line.cpp:282-326)."""
    w = words.to(torch.int32) & DATA_WORD_MASK
    if not m2:
        out = (w << 2) & 0xFFFF
    else:
        hi = (w << 3) & 0xFFFF
        neg = (w & BIT_M2_SIGN_POS) != 0
        lo = w & ~BIT_M2_RANGE_POS
        lo = torch.where(
            neg, lo | ((1 << 15) | (1 << 14) | BIT_M2_RANGE_POS), lo)
        out = torch.where((w & BIT_M2_RANGE_POS) == 0, hi, lo)
    return torch.where(out >= 0x8000, out - 0x10000, out).to(torch.int16)


def silent_words(m2: bool = False, device=None) -> torch.Tensor:
    fill = BIT_M2_RANGE_POS if m2 else 0
    return torch.full((N_WORDS,), fill, dtype=torch.int32, device=device)


def is_control_block(words: torch.Tensor) -> torch.Tensor:
    """Control Block detection (stc007line.cpp:493-504)."""
    return ((words[..., WORD_L0] == CB_CUE1) & (words[..., WORD_R0] == CB_CUE2)
            & (words[..., WORD_L1] == CB_CUE1)
            & (words[..., WORD_R1] == CB_CUE2)
            & (words[..., WORD_L2] == 0)
            & ((words[..., WORD_Q] & CTRL_ZERO_MASK) == 0))


def control_block_fields(words):
    """Decode Control Block payload -> dict (host-side, numpy scalars)."""
    addr1 = int(words[..., WORD_R2])
    addr2 = int(words[..., WORD_P])
    ctrl = int(words[..., WORD_Q])
    return {
        "ctrl_id": int(words[..., WORD_L2]) & DATA_WORD_MASK,
        "index": (addr1 >> 8) & 0x3F,
        "hour": (addr1 >> 4) & 0x0F,
        "minute": ((addr2 >> 12) & 0x03) + ((addr1 & 0x0F) << 2),
        "second": (addr2 >> 6) & 0x3F,
        "field": addr2 & 0x3F,
        "m2": (ctrl & CTRL_FMT_ID) == CTRL_FMT_M2,
        "copy_prohibited": (ctrl & CTRL_COPY_MASK) != 0,
        "p_enabled": (ctrl & CTRL_EN_P_MASK) == 0,
        "q_enabled": (ctrl & CTRL_EN_Q_MASK) == 0,
        "emphasis": (ctrl & CTRL_EMPH_MASK) == 0,
    }
