"""Data model layer: format constants, CRC, GF(2) algebra, sample expansion."""
from . import crc, gf2, stc007, pcm1, pcm16x0  # noqa: F401
