"""Capture building blocks shared by the formats: CRC-16, bit packing,
seeded draws, pixel rendering on the device, y4m writing, WAV reading.

Frozen for the benchmark: the port's encoder (synth/encoder.render_bits)
and its y4m writer (pipeline/ingest.write_y4m) produce the same bytes
from the same bits and levels; this file imports nothing of the port.
"""
from __future__ import annotations

import functools
import struct
from pathlib import Path

import numpy as np
import torch

CRC_POLY = 0x1021   # CRC-16/CCITT-FALSE, init 0xFFFF, MSB first
CRC_INIT = 0xFFFF


@functools.lru_cache(maxsize=None)
def crc16_table(n_bits: int):
    """(masks [n_bits] int64, const): the CRC of an n_bits message is const
    XOR the masks of its set bits (the register is linear in the bits)."""
    def run(state, bits):
        for b in bits:
            msb = (state >> 15) & 1
            state = (state << 1) & 0xFFFF
            if msb != b:
                state ^= CRC_POLY
        return state
    const = run(CRC_INIT, [0] * n_bits)
    masks = np.array([run(0, [1] + [0] * (n_bits - 1 - i))
                      for i in range(n_bits)], np.int64)
    return masks, const


def crc16(bits: np.ndarray) -> np.ndarray:
    """CRC-16 of bit rows [..., n] (first bit fed first) -> int64 [...]."""
    masks, const = crc16_table(bits.shape[-1])
    # One 0/1 column per CRC bit: the parity of the set bits' masks.
    mbits = (masks[:, None] >> np.arange(16)) & 1            # [n, 16]
    par = (bits.astype(np.float32) @ mbits.astype(np.float32))
    par = par.astype(np.int64) & 1
    return (par << np.arange(16)).sum(-1) ^ const


def to_bits(words: np.ndarray, n: int) -> np.ndarray:
    """[...] ints -> [..., n] bits, most significant first."""
    return ((np.asarray(words, np.int64)[..., None]
             >> np.arange(n - 1, -1, -1)) & 1).astype(np.uint8)


def from_bits(bits: np.ndarray) -> np.ndarray:
    """[..., n] bits, most significant first -> int64 [...]."""
    n = bits.shape[-1]
    return (bits.astype(np.int64) << np.arange(n - 1, -1, -1)).sum(-1)


def rng_for(seed: int, *tags: int) -> np.random.Generator:
    """A numpy generator for one part of a run, from the run's seed."""
    return np.random.default_rng([int(seed) & (2 ** 63 - 1), *tags])


def render(bits: torch.Tensor, width: int, ppb: float, start_px: int,
           black: int, white: int) -> torch.Tensor:
    """Bit rows [N, nb] (on the device) -> pixel rows [N, width] float32:
    bit cell i spans [start_px + i*ppb, start_px + (i+1)*ppb), black
    outside the cells (synth/encoder.render_bits)."""
    nb = bits.shape[1]
    px = torch.arange(width, device=bits.device, dtype=torch.float64)
    cell = torch.floor((px - start_px) / ppb).long()
    inside = (cell >= 0) & (cell < nb)
    lit = bits[:, cell.clamp(0, nb - 1)] != 0
    vals = torch.where(lit, float(white), float(black)).float()
    return torch.where(inside[None, :], vals, float(black))


def noise_and_quantize(vals: torch.Tensor, sigma: float,
                       gen: torch.Generator | None) -> torch.Tensor:
    """float pixels + N(0, sigma) from `gen` -> uint8, rounded and clipped."""
    if sigma > 0:
        vals = vals + sigma * torch.randn(vals.shape, generator=gen,
                                          device=vals.device)
    return vals.round().clamp(0, 255).to(torch.uint8)


def dim(rows: torch.Tensor, black: int, white: int, lo: int,
        hi: int) -> torch.Tensor:
    """float pixel rows rescaled from black..white to lo..hi: lines too dim
    for the frame's level (chip_smoke.dim_lines' recipe)."""
    return lo + (rows - black) * (hi - lo) / (white - black)


def y4m_header(width: int, height: int) -> bytes:
    return f"YUV4MPEG2 W{width} H{height} F25:1 Ip A1:1 Cmono\n".encode()


def write_y4m(path, frames: np.ndarray):
    """Grayscale frames [F, H, W] u8 as one mono y4m file, in one write."""
    F, H, W = frames.shape
    tag = np.frombuffer(b"FRAME\n", np.uint8)
    buf = np.empty((F, len(tag) + H * W), np.uint8)
    buf[:, :len(tag)] = tag
    buf[:, len(tag):] = frames.reshape(F, H * W)
    with open(path, "wb") as fh:
        fh.write(y4m_header(W, H))
        fh.write(buf.tobytes())


def read_y4m(path) -> np.ndarray:
    """Frames [F, H, W] u8 of a mono y4m file written by write_y4m (a
    read-only map of the file)."""
    raw = np.memmap(path, np.uint8, mode="r")
    head = bytes(raw[:128]).split(b"\n", 1)[0]
    fields = {t[:1]: t[1:] for t in head.split(b" ")[1:]}
    W, H = int(fields[b"W"]), int(fields[b"H"])
    body = raw[len(head) + 1:]
    rec = 6 + H * W
    F = len(body) // rec
    return body[:F * rec].reshape(F, rec)[:, 6:].reshape(F, H, W)


def read_wav(path):
    """(samples [N, 2] int16, rate, channels, bits) of a PCM WAV file, or
    None where the file is missing or is no 16-bit stereo PCM WAV."""
    try:
        raw = Path(path).read_bytes()
    except OSError:
        return None
    if len(raw) < 44 or raw[:4] != b"RIFF" or raw[8:12] != b"WAVE" \
            or raw[12:16] != b"fmt " or raw[36:40] != b"data":
        return None
    fmt, ch, rate, _, _, bits = struct.unpack_from("<HHIIHH", raw, 20)
    (n_bytes,) = struct.unpack_from("<I", raw, 40)
    if fmt != 1 or ch != 2 or bits != 16 or 44 + n_bytes > len(raw) \
            or n_bytes % 4:
        return None
    body = np.frombuffer(raw, "<i2", count=n_bytes // 2, offset=44)
    return body.reshape(-1, 2), rate, ch, bits
