"""Visualization renderer: lines/blocks -> RGB images (diagnostic surface).

Port of RenderPCM (renderpcm.{h,cpp}) for the batch decoder: instead of a
live QGraphicsScene, frames render to numpy RGB arrays (writable as PPM)
with the reference's color coding (palette renderpcm.h:49-67):
  gray   = bits of CRC-valid lines
  yellow = CRC-valid but bit-picked / fixed words
  green  = words fixed by P-code
  blue   = words fixed by Q-code
  red    = invalid CRC
  magenta= BROKEN blocks
  white  = STC-007 markers / block boundaries

Port of sdvpcmdecoder_tpu/pipeline/render.py (numpy only).
"""
from __future__ import annotations

import numpy as np

from ..formats import pcm1, pcm16x0, stc007
from ..utils.host import host_call

# Palette (renderpcm.h:49-67), (bit0, bit1) RGB pairs.
PAL_GRAY = ((45, 45, 45), (150, 150, 150))
PAL_YELLOW = ((127, 110, 0), (255, 220, 0))
PAL_GREEN = ((0, 95, 30), (0, 225, 70))
PAL_RED = ((140, 0, 0), (255, 70, 43))
PAL_BLUE = ((0, 95, 127), (0, 191, 255))
PAL_MAGENTA = ((140, 0, 140), (255, 0, 255))
MARKER_WHITE = (255, 255, 255)

PPB_STC007LINE = 5   # renderpcm.h:84-92


def _word_bits(words, crc):
    return host_call(stc007.words_to_data_bits, words, crc)


def render_stc007_lines(words, crcs, valid, fixed_p=None, fixed_q=None,
                        broken=None, ppb=PPB_STC007LINE):
    """Render binarized STC-007 lines [N, 8]+[N] -> RGB [N, W, 3] uint8.

    Color per line by state: valid=gray, invalid=red, P-fix=green,
    Q-fix=blue, broken=magenta; markers drawn white.
    """
    N = len(crcs)
    bits = np.asarray(_word_bits(np.asarray(words), np.asarray(crcs)))
    full = np.concatenate([
        np.tile(stc007.START_MARKER_BITS, (N, 1)), bits,
        np.tile(stc007.STOP_MARKER_BITS, (N, 1))], axis=1)
    Wb = full.shape[1]
    img = np.zeros((N, Wb * ppb, 3), dtype=np.uint8)
    pal0 = np.zeros((N, 3), np.uint8)
    pal1 = np.zeros((N, 3), np.uint8)

    def apply(mask, pal):
        pal0[mask] = pal[0]
        pal1[mask] = pal[1]

    valid = np.asarray(valid, bool)
    apply(~valid, PAL_RED)
    apply(valid, PAL_GRAY)
    if fixed_p is not None:
        apply(np.asarray(fixed_p, bool), PAL_GREEN)
    if fixed_q is not None:
        apply(np.asarray(fixed_q, bool), PAL_BLUE)
    if broken is not None:
        apply(np.asarray(broken, bool), PAL_MAGENTA)

    cells = np.where(full[..., None].astype(bool), pal1[:, None, :],
                     pal0[:, None, :])
    # Markers always white when lit.
    mark = np.zeros(Wb, bool)
    mark[:4] = True
    mark[-5:] = True
    lit = full.astype(bool) & mark[None, :]
    cells = np.where(lit[..., None], np.asarray(MARKER_WHITE, np.uint8),
                     cells)
    img = np.repeat(cells, ppb, axis=1)
    return img


def render_source_lines(pixels, max_width=None):
    """Source view (the reference's first frame_vis window): grayscale
    capture lines -> RGB."""
    px = np.asarray(pixels)
    if max_width is not None and px.shape[1] > max_width:
        step = px.shape[1] // max_width
        px = px[:, ::step]
    return np.repeat(px[..., None], 3, axis=-1).astype(np.uint8)


def render_stc007_blocks(words, valid, line_crc, fixed_p=None,
                         fixed_q=None, broken=None, masked=None, ppb=2):
    """Data-block view (renderNewBlock(STC007DataBlock),
    renderpcm.h:123-150): one row per block, 8 x 14-bit words with white
    boundary columns; per-WORD coloring — valid gray, P-corrected green,
    Q-corrected blue, invalid red; BROKEN blocks magenta; seam/post-
    BROKEN masked boundaries in the VIS_LIM_MARK pink.

    words [B, 8], valid/line_crc [B, >=8] bool; fixed_p/q/broken/masked
    [B] bool.
    """
    words = np.asarray(words)[:, :8]
    valid = np.asarray(valid, bool)[:, :8]
    line_crc = np.asarray(line_crc, bool)[:, :8]
    B = words.shape[0]
    nb = stc007.BITS_PER_WORD
    # word bits [B, 8, 14]
    shifts = np.arange(nb - 1, -1, -1)
    bits = (words[..., None] >> shifts) & 1
    pal0 = np.zeros((B, 8, 3), np.uint8)
    pal1 = np.zeros((B, 8, 3), np.uint8)

    def apply(mask, pal):
        pal0[mask] = pal[0]
        pal1[mask] = pal[1]

    apply(~valid, PAL_RED)
    apply(valid, PAL_GRAY)
    # Corrected words: valid now but the source line CRC was bad.
    fix = valid & ~line_crc
    if fixed_p is not None:
        apply(fix & np.asarray(fixed_p, bool)[:, None], PAL_GREEN)
    if fixed_q is not None:
        apply(fix & np.asarray(fixed_q, bool)[:, None], PAL_BLUE)
    if broken is not None:
        b = np.asarray(broken, bool)[:, None] & np.ones((1, 8), bool)
        apply(b, PAL_MAGENTA)
    cells = np.where(bits[..., None].astype(bool), pal1[:, :, None, :],
                     pal0[:, :, None, :])          # [B, 8, 14, 3]
    # Boundary column per word (VIS_LIM_OK white / VIS_LIM_MARK pink).
    lim = np.full((B, 8, 1, 3), 255, np.uint8)
    if masked is not None:
        lim[np.asarray(masked, bool)] = (224, 170, 170)
    cells = np.concatenate([lim, cells], axis=2)   # [B, 8, 15, 3]
    img = cells.reshape(B, 8 * (nb + 1), 3)
    return np.repeat(img, ppb, axis=1)


def render_block_states(audio_state, ppb=6, height=4):
    """Render per-block audio state [B] as a strip [height, B*ppb, 3]."""
    colors = np.array([PAL_GRAY[1], PAL_GREEN[1], PAL_BLUE[1],
                       PAL_MAGENTA[1]], dtype=np.uint8)
    strip = colors[np.clip(np.asarray(audio_state), 0, 3)]
    strip = np.repeat(strip[None, :, :], height, axis=0)
    return np.repeat(strip, ppb, axis=1)


def write_ppm(path, img: np.ndarray):
    """Write an RGB uint8 image as binary PPM (no external deps)."""
    H, W, _ = img.shape
    with open(path, "wb") as fh:
        fh.write(f"P6\n{W} {H}\n255\n".encode())
        fh.write(np.ascontiguousarray(img).tobytes())


def read_ppm(path):
    with open(path, "rb") as fh:
        assert fh.readline().strip() == b"P6"
        dims = fh.readline().split()
        W, H = int(dims[0]), int(dims[1])
        fh.readline()
        data = np.frombuffer(fh.read(W * H * 3), np.uint8)
    return data.reshape(H, W, 3)


PPB_PCM1LINE = 7      # renderpcm.h:84-92 (RENDER_PPB_PCM1)
PPB_PCM16X0LINE = 3   # (RENDER_PPB_PCM16X0: 193 bits/line)


def _render_bit_lines(full, valid, fixed=None, ppb=4, marker_mask=None):
    """Shared bit-matrix renderer: full [N, Wb] bits -> RGB image."""
    N, Wb = full.shape
    pal0 = np.zeros((N, 3), np.uint8)
    pal1 = np.zeros((N, 3), np.uint8)
    valid = np.asarray(valid, bool)
    pal0[~valid], pal1[~valid] = PAL_RED
    pal0[valid], pal1[valid] = PAL_GRAY
    if fixed is not None:
        f = np.asarray(fixed, bool)
        pal0[f], pal1[f] = PAL_YELLOW
    cells = np.where(full[..., None].astype(bool), pal1[:, None, :],
                     pal0[:, None, :])
    if marker_mask is not None:
        lit = full.astype(bool) & marker_mask[None, :]
        cells = np.where(lit[..., None],
                         np.asarray(MARKER_WHITE, np.uint8), cells)
    return np.repeat(cells, ppb, axis=1)


def render_pcm1_lines(words, crcs, valid, fixed=None, ppb=PPB_PCM1LINE):
    """Render binarized PCM-1 lines [N, 6]+[N] -> RGB (94-bit layout).

    valid=gray, invalid=red, bit-picked/refined=yellow (renderpcm
    palette); PCM-1 has no markers."""
    bits = np.asarray(pcm1.words_to_data_bits(np.asarray(words),
                                              np.asarray(crcs), xp=np))
    return _render_bit_lines(bits, valid, fixed, ppb)


def render_pcm16x0_sublines(words, crcs, valid, control_bit=None,
                            fixed=None, ppb=PPB_PCM16X0LINE):
    """Render PCM-16x0 SUBLINES [S, 3]+[S] -> RGB (64 bits + the control
    bit column drawn white when set)."""
    bits = np.asarray(pcm16x0.words_to_data_bits(np.asarray(words),
                                                 np.asarray(crcs), xp=np))
    if control_bit is not None:
        cb = np.asarray(control_bit, bool)[:, None].astype(bits.dtype)
        bits = np.concatenate([bits, cb], axis=1)
        mark = np.zeros(bits.shape[1], bool)
        mark[-1] = True
    else:
        mark = None
    return _render_bit_lines(bits, valid, fixed, ppb, marker_mask=mark)
