"""PCM-1 deinterleaver: word-pair zig-zag interleave, no ECC (CRC only).

Port of PCM1Deinterleaver (pcm1deinterleaver.cpp:120-370) vectorized over
all 8 interleave blocks of a field at once.

Geometry (pcm1datablock.h:37-59): a field of 735 sublines (245 lines x 3)
holds 8 interleave blocks of 92 sublines (block 7 one short). Each block
has two stripes of 46 word pairs at subline offsets 0 and 46; which stripe
supplies the even-indexed pairs alternates with block parity
(pcm1deinterleaver.cpp:205-215).

Carried over from sdvpcmdecoder_tpu/ops/pcm1_deint.py (numpy).
"""
from __future__ import annotations

import functools

import numpy as np

from ..formats import pcm1

INT_BLK_PER_FIELD = 8
STRIPE_LEN = 46
BLOCK_PAIRS = 2 * STRIPE_LEN            # 92 pairs per block
FIELD_SUBLINES = INT_BLK_PER_FIELD * BLOCK_PAIRS - 1  # 735
LINES_PF_NTSC = 245


@functools.lru_cache(maxsize=None)
def pair_to_subline_map():
    """[8, 92] map: (block, pair) -> subline index in the field (or -1).

    pair p of block n comes from the odd stripe (p even) or even stripe
    (p odd); stripe_one (offset 0) holds the stripe whose parity matches
    the block's (even_itl_block == even_stripe), stripe_two sits at +46.
    Block 7's even stripe is short (45 pairs): its last pair is absent.
    """
    m = np.full((INT_BLK_PER_FIELD, BLOCK_PAIRS), -1, dtype=np.int64)
    for n in range(INT_BLK_PER_FIELD):
        for p in range(BLOCK_PAIRS):
            even_stripe = (p % 2) == 1  # even-sample stripe fills odd pairs
            wp = p // 2
            if n == INT_BLK_PER_FIELD - 1 and even_stripe and wp >= 45:
                continue  # short block: missing last even-stripe pair
            if ((n % 2) == 0) == even_stripe:
                ofs = 0
            else:
                ofs = STRIPE_LEN
            m[n, p] = n * BLOCK_PAIRS + ofs + wp
    return m


def deinterleave_field(sub_left, sub_right, sub_crc_ok, picked_left=None,
                       picked_crc=None):
    """Deinterleave one field of sublines into sample-pair order.

    sub_left/right [S>=735] int words, sub_crc_ok [S] bool.
    Returns dict with left/right [735] int words, valid [735] bool,
    block_valid [735] bool (per-pair broadcast of its block validity),
    picked [735] bool.
    """
    m = pair_to_subline_map()
    flat = m.reshape(-1)
    ok_idx = flat >= 0
    idx = np.where(ok_idx, flat, 0)
    left = np.where(ok_idx, sub_left[idx], 0)
    right = np.where(ok_idx, sub_right[idx], 0)
    valid = np.where(ok_idx, sub_crc_ok[idx], True)
    picked = np.zeros_like(valid)
    if picked_left is not None:
        picked = np.where(ok_idx, picked_left[idx] | picked_crc[idx], False)
    # Block validity: all pairs in the block valid (getErrorsAudio==0).
    vb = valid.reshape(INT_BLK_PER_FIELD, BLOCK_PAIRS)
    block_valid = np.repeat(vb.all(axis=1), BLOCK_PAIRS)
    # Flatten to the 736-pair grid then drop the absent short-block pair.
    present = ok_idx
    return dict(left=left[present], right=right[present],
                valid=valid[present], block_valid=block_valid[present],
                picked=picked[present])


def interleave_field(left_words, right_words):
    """Encoder inverse: 735 sample pairs -> (sub_left, sub_right) [735]."""
    m = pair_to_subline_map()
    sub_left = np.zeros(FIELD_SUBLINES, dtype=np.int64)
    sub_right = np.zeros(FIELD_SUBLINES, dtype=np.int64)
    flat = m.reshape(-1)
    pair_ids = np.arange(flat.size)
    ok = flat >= 0
    sub_left[flat[ok]] = left_words[pair_ids[ok]]
    sub_right[flat[ok]] = right_words[pair_ids[ok]]
    return sub_left, sub_right
