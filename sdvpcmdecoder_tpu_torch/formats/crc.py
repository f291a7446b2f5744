"""CRC-16/CCITT-FALSE as GF(2)-linear algebra.

Port of sdvpcmdecoder_tpu/formats/crc.py. The reference decoder
(pcmline.cpp:461-487 `PCMLine::getCalcCRC16`) runs a bit-serial CRC-16
shift register: poly 0x1021, init 0xFFFF, data fed MSB-first. For a fixed
message length the final CRC is an affine function of the message bits:

    crc(bits) = CONST  ^  XOR_{i : bits[i]=1} MASK[i]

The table builders and the scalar register stay numpy/Python (golden
tests, pcmtester.cpp:9-99); the batched CRC runs on torch tensors.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .gf2 import matmul_bits

CRC_POLY = 0x1021
CRC_INIT = 0xFFFF
CRC_MAX_BIT = 0x8000


def crc16_update_scalar(crc: int, data: int, bit_cnt: int = 16) -> int:
    """Bit-exact port of the reference shift register (pcmline.cpp:461).

    Feeds `bit_cnt` bits of `data` MSB-first (bit bit_cnt-1 down to bit 0).
    """
    for _ in range(bit_cnt):
        msb = (crc >> 15) & 1
        in_bit = (data >> (bit_cnt - 1)) & 1
        crc = (crc << 1) & 0xFFFF
        if msb != in_bit:
            crc ^= CRC_POLY
        data = (data << 1) & 0xFFFF
    return crc


def crc16_words_scalar(words, bits_per_word: int, init: int = CRC_INIT) -> int:
    """CRC over a sequence of words, each contributing bits_per_word bits."""
    crc = init
    for w in words:
        crc = crc16_update_scalar(crc, int(w) & ((1 << bits_per_word) - 1),
                                  bits_per_word)
    return crc


@functools.lru_cache(maxsize=None)
def crc16_linear_table(n_bits: int, init: int = CRC_INIT):
    """Build (TABLE [n_bits,16] uint8, CONST) for an n_bits message.

    TABLE[i, j] = bit j (LSB=0) of the CRC contribution of message bit i
    (message bit 0 is the FIRST bit fed, i.e. the stream MSB).
    """
    # Constant term: all-zero message with the real init.
    c = init
    for _ in range(n_bits):
        msb = (c >> 15) & 1
        c = (c << 1) & 0xFFFF
        if msb:
            c ^= CRC_POLY
    const = c
    # Contribution masks: an impulse at step i (state becomes the poly),
    # then zeros for the remaining steps.
    table = np.zeros((n_bits, 16), dtype=np.uint8)
    for i in range(n_bits):
        c = CRC_POLY
        for _ in range(i + 1, n_bits):
            msb = (c >> 15) & 1
            c = (c << 1) & 0xFFFF
            if msb:
                c ^= CRC_POLY
        table[i] = [(c >> j) & 1 for j in range(16)]
    return table, const


def words_to_bits(words: torch.Tensor, bits_per_word) -> torch.Tensor:
    """Unpack words [..., n_words] into an int32 bit matrix [..., total_bits].

    bits_per_word: int (uniform) or sequence per word. MSB-first per word,
    matching the reference feed order.
    """
    n_words = words.shape[-1]
    if isinstance(bits_per_word, int):
        bits_per_word = [bits_per_word] * n_words
    cols = []
    for w, nb in enumerate(bits_per_word):
        shifts = torch.arange(nb - 1, -1, -1, dtype=torch.int32,
                              device=words.device)
        cols.append((words[..., w, None].to(torch.int32) >> shifts) & 1)
    return torch.cat(cols, dim=-1)


def pack_bits_to_u16(bits: torch.Tensor) -> torch.Tensor:
    """Pack [..., 16] bit matrix (LSB at index 0) into uint16-valued int32."""
    weights = 1 << torch.arange(16, dtype=torch.int32, device=bits.device)
    return (bits.to(torch.int32) * weights).sum(-1, dtype=torch.int32)


def crc16_batch(bits: torch.Tensor, n_bits: int,
                init: int = CRC_INIT) -> torch.Tensor:
    """Batched CRC over bit matrices [..., n_bits] -> int32 CRC values."""
    table, const = crc16_linear_table(n_bits, init)
    return pack_bits_to_u16(matmul_bits(bits, table)) ^ const


def words_to_bits_np(words: np.ndarray, bits_per_word) -> np.ndarray:
    """Numpy twin of words_to_bits for host-side callers (int32 bits)."""
    n_words = words.shape[-1]
    if isinstance(bits_per_word, int):
        bits_per_word = [bits_per_word] * n_words
    cols = []
    for w, nb in enumerate(bits_per_word):
        shifts = np.arange(nb - 1, -1, -1)
        cols.append((words[..., w][..., None].astype(np.int32) >> shifts) & 1)
    return np.concatenate(cols, axis=-1)


@functools.lru_cache(maxsize=None)
def _table_f32(n_bits: int, init: int):
    table, const = crc16_linear_table(n_bits, init)
    return np.ascontiguousarray(table, dtype=np.float32), const


def crc16_batch_np(bits: np.ndarray, n_bits: int,
                   init: int = CRC_INIT) -> np.ndarray:
    """Numpy twin of crc16_batch for host-side checks -> int64 CRCs.

    float32 BLAS matmul: 0/1 inputs, sums <= n_bits < 2^24 so exact."""
    table, const = _table_f32(n_bits, init)
    crc_bits = (bits.astype(np.float32) @ table).astype(np.int64) & 1
    weights = (1 << np.arange(16)).astype(np.int64)
    return ((crc_bits * weights).sum(axis=-1) ^ const).astype(np.int64)
