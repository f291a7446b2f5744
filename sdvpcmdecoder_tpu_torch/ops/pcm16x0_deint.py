"""PCM-16x0 deinterleaver: SI/EI formats, per-sub-block P parity.

Port of PCM16X0Deinterleaver (pcm16x0deinterleaver.cpp) vectorized over
block shifts. A data block takes 3 sublines at offsets {0, OFS, 2*OFS}
(OFS = 35 sublines for SI, 490 for EI; pcm16x0datablock.h:38-60); each of
its 3 sub-blocks holds (L, R, P) words whose subline assignment depends on
the block's odd/even order (getWordToLine, pcm16x0datablock.cpp): parity
always sits on LINE_2, and the L/R channel lines swap between orders.
Correction is P-parity only: one erased word per sub-block.

Carried over from sdvpcmdecoder_tpu/ops/pcm16x0_deint.py (numpy); its native
calls go to the port's ops/stitch_native.
"""
from __future__ import annotations

import numpy as np

from ..formats import pcm16x0

SUBBLK_CNT = 3
LINE_CNT = 3
AUD_ORIG, AUD_FIX_P, AUD_BROKEN = 0, 1, 2
STG_DATA_OK, STG_NO_CHECK, STG_BAD_BLOCK = 0, 1, 2

SI_OFS = pcm16x0.SI_INTERLEAVE_OFS     # 35 sublines
EI_OFS = pcm16x0.EI_INTERLEAVE_OFS     # 490 sublines


def _line_of_word(order_even, blk, word):
    """getWordToLine: word (0=L,1=R,2=P) -> line index (0..2)."""
    if word == 2:
        return 1
    # odd order: SUBBLK_1 L<-LINE_3 R<-LINE_1; SUBBLK_2 L<-LINE_1 R<-LINE_3;
    # SUBBLK_3 L<-LINE_3 R<-LINE_1. Even order mirrors L and R.
    odd_map = {(0, 0): 2, (0, 1): 0, (1, 0): 0, (1, 1): 2,
               (2, 0): 2, (2, 1): 0}
    line = odd_map[(blk, word)]
    if order_even:
        line = 2 - line
    return line


def decode_blocks(sub_words, sub_crc_ok, shifts, even_order, ei=False,
                  en_p=True, force_ecc=True, rows=None):
    """Vectorized block decode.

    sub_words [S, 3] int words per subline, sub_crc_ok [S] bool,
    shifts [B] int block start sublines, even_order [B] bool.
    rows [B, 3] overrides the contiguous shift+k*ofs line map with
    explicit subline indices (one call covers every padding of an EI
    sweep, batched_ei_padding_stats).

    Returns dict of:
      samples [B, 3, 2] int16 (sub-block x L/R)
      word_valid [B, 3, 3] bool (sub-block x L/R/P, after correction)
      word_crc [B, 3, 3] bool (source CRC flags, word-mapped)
      state [B, 3] int (AUD_*)
      stage [B, 3] int (STG_*)
      block_valid [B] bool (all audio words of all sub-blocks valid)
    """
    ofs = EI_OFS if ei else SI_OFS
    from . import stitch_native as _sn
    if _sn.available():
        # Native twin (~20x): the numpy path below stays the tested
        # reference implementation.
        if rows is not None:
            w, v, wc, state, stage, samples, bval = \
                _sn.pcm16x0_decode_blocks_rows(
                    sub_words, sub_crc_ok, rows, even_order, en_p,
                    force_ecc)
        else:
            w, v, wc, state, stage, samples, bval = \
                _sn.pcm16x0_decode_blocks(sub_words, sub_crc_ok, shifts,
                                          even_order, ofs, en_p,
                                          force_ecc)
        # Packed flags + output-pass counters ride along natively so
        # the burst/stat consumers skip their numpy reductions.
        flags, counters = _sn.pcm16x0_block_flags(v, state, stage,
                                                  samples, bval)
        return dict(samples=samples, word_valid=v, word_crc=wc,
                    state=state, stage=stage, block_valid=bval, words=w,
                    flags=flags, counters=counters)
    if rows is None:
        rows = shifts[:, None] + np.arange(LINE_CNT) * ofs  # [B, 3]
    else:
        rows = np.asarray(rows)
        shifts = rows[:, 0]
    lw = sub_words[rows]                                    # [B, 3, 3]
    lok = sub_crc_ok[rows]                                  # [B, 3] per line
    B = len(shifts)

    # Map words (L,R,P) per sub-block to source lines for both orders.
    words = np.zeros((B, SUBBLK_CNT, 3), dtype=np.int64)
    wcrc = np.zeros((B, SUBBLK_CNT, 3), dtype=bool)
    eo = np.asarray(even_order, bool)
    for blk in range(SUBBLK_CNT):
        for word in range(3):
            lo = _line_of_word(False, blk, word)
            le = _line_of_word(True, blk, word)
            line = np.where(eo, le, lo)
            words[:, blk, word] = lw[np.arange(B), line, blk]
            wcrc[:, blk, word] = lok[np.arange(B), line]

    valid = wcrc.copy()
    state = np.zeros((B, SUBBLK_CNT), dtype=np.int64)
    stage = np.full((B, SUBBLK_CNT), STG_BAD_BLOCK, dtype=np.int64)

    err_total = np.sum(~wcrc, axis=-1)                      # [B, 3]
    err_audio = np.sum(~wcrc[..., :2], axis=-1)

    sp = words[..., 0] ^ words[..., 1] ^ words[..., 2]      # [B, 3]
    # bad_ptr priority L -> R -> P (pcm16x0deinterleaver.cpp:433-445).
    bad_ptr = np.where(~wcrc[..., 0], 0,
                       np.where(~wcrc[..., 1], 1,
                                np.where(~wcrc[..., 2], 2, 64)))

    over = err_total > 1
    stage = np.where(over, STG_BAD_BLOCK, stage)
    m = ~over
    if en_p and force_ecc:
        # P word itself bad -> NO_CHECK.
        p_bad = m & (bad_ptr == 2)
        stage = np.where(p_bad, STG_NO_CHECK, stage)
        mc = m & ~p_bad
        sp_zero = sp == 0
        ok = mc & sp_zero
        # FIX_NOT_NEED: set flagged word valid.
        for w in range(3):
            fixm = ok & (bad_ptr == w)
            valid[..., w] = valid[..., w] | fixm
        stage = np.where(ok, STG_DATA_OK, stage)
        # syndrome nonzero, no pointer -> BROKEN.
        brk = mc & ~sp_zero & (bad_ptr == 64)
        state = np.where(brk, AUD_BROKEN, state)
        stage = np.where(brk, STG_BAD_BLOCK, stage)
        # fix the flagged word.
        fx = mc & ~sp_zero & (bad_ptr < 2)
        for w in range(2):
            fixm = fx & (bad_ptr == w)
            words[..., w] = np.where(fixm, words[..., w] ^ sp,
                                     words[..., w])
            valid[..., w] = valid[..., w] | fixm
        state = np.where(fx, AUD_FIX_P, state)
        stage = np.where(fx, STG_DATA_OK, stage)
    elif en_p:
        need = m & (err_audio > 0)
        stage = np.where(m & ~need, STG_DATA_OK, stage)
        # (non-forced path rarely used; same fix flow)
        sp_zero = sp == 0
        fx = need & ~sp_zero & (bad_ptr < 2)
        for w in range(2):
            fixm = fx & (bad_ptr == w)
            words[..., w] = np.where(fixm, words[..., w] ^ sp,
                                     words[..., w])
            valid[..., w] = valid[..., w] | fixm
        stage = np.where(fx | (need & sp_zero), STG_DATA_OK, stage)
        state = np.where(fx, AUD_FIX_P, state)
    else:
        bad = m & (err_audio > 0)
        stage = np.where(m & ~bad,
                         STG_NO_CHECK if force_ecc else STG_DATA_OK, stage)

    # markAsBroken wipes validity of the sub-block words.
    brk_mask = state == AUD_BROKEN
    valid = np.where(brk_mask[..., None], False, valid)

    samples = np.asarray(pcm16x0.expand_sample(words[..., :2], xp=np))
    block_valid = valid[..., :2].all(axis=(-1, -2))
    return dict(samples=samples, word_valid=valid, word_crc=wcrc,
                state=state, stage=stage, block_valid=block_valid,
                words=words)


def interleave_field(left, right, n_lines, ei=False, even_first=False):
    """Encoder inverse for tests: sample pairs -> subline words [S, 3].

    SI: super-blocks of 105 sublines yield 35 blocks x 3 pairs; block i of
    a super-block uses sublines (i, i+35, i+70) with order alternating
    odd/even starting odd (performDeinterleave :5209-5418).
    """
    S = n_lines * 3
    sub = np.zeros((S, 3), dtype=np.int64)
    ofs = EI_OFS if ei else SI_OFS
    group = 3 * ofs
    n_groups = S // group if not ei else 1
    pair = 0
    for g in range(n_groups):
        base = g * group
        for i in range(ofs):
            eo = (i % 2 == 1) ^ even_first
            rows = [base + i, base + i + ofs, base + i + 2 * ofs]
            for blk in range(SUBBLK_CNT):
                lval = left[pair]
                rval = right[pair]
                pval = lval ^ rval
                sub[rows[_line_of_word(eo, blk, 0)], blk] = lval
                sub[rows[_line_of_word(eo, blk, 1)], blk] = rval
                sub[rows[_line_of_word(eo, blk, 2)], blk] = pval
                pair += 1
    return sub, pair
