"""STC-007 deinterleave + P/Q erasure correction, vectorized over blocks.

Port of sdvpcmdecoder_tpu/ops/deinterleave.py (the jnp branch). The
reference processes one data block at a time through a serial state
machine (stc007deinterleaver.cpp:286-1123 `processBlock`) with 21 explicit
Q-code solve branches (:1627-1977). Here all blocks are deinterleaved and
corrected at once:

  * block assembly is a gather: word w of the block at line shift s comes
    from line s + 16*w (stc007datablock.h:38-59);
  * the decision tree is evaluated branch-free with masks; the Q-solve
    branches collapse to  e1 = A[pair] @ sq  ^  B[pair] @ sp,  e2 = e1 ^ sp
    with per-pair GF(2) matrices taken from stacked banks;
  * auto resolution (14<->16 refill passes, :349-377, :1039-1056) becomes
    "decode both resolutions, select".

GF(2) products run as AND + parity in int32 (formats/gf2.matmul_bits):
torch has no integer matmul on CUDA. Words are int32, flags bool.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..formats import gf2, stc007

NO_ERR_INDEX = 64  # stc007deinterleaver.h:117

# Audio data state (stc007datablock.h:104-111).
AUD_ORIG, AUD_FIX_P, AUD_FIX_Q, AUD_BROKEN = range(4)
# Exit stage (subset of stc007deinterleaver.h:126-138 that survives a pass).
STG_DATA_OK, STG_NO_CHECK, STG_BAD_BLOCK = range(3)
# Resolution.
RES_14BIT, RES_16BIT = 0, 1
# Resolution modes (stc007deinterleaver.h:105-113).
RES_MODE_14BIT, RES_MODE_14BIT_AUTO, RES_MODE_16BIT_AUTO, RES_MODE_16BIT = (
    range(4))

N_WORDS = 8
N_AUDIO = 6
WORD_P0, WORD_Q0 = 6, 7
N_PAIRS = 49  # pair id = i*7 + j for erasures 0 <= i < j <= 6


class BlockBatch(NamedTuple):
    """Decoded data blocks [B, ...]."""
    words: torch.Tensor        # [B, 8] int32
    valid: torch.Tensor        # [B, 8] bool  (word_valid after correction)
    line_crc: torch.Tensor     # [B, 8] bool  (source CRC state per word)
    audio_state: torch.Tensor  # [B] int32    (AUD_*)
    stage: torch.Tensor        # [B] int32    (STG_*)
    resolution: torch.Tensor   # [B] int32    (RES_14BIT / RES_16BIT)


@functools.lru_cache(maxsize=None)
def _q_solve_banks():
    """A/B matrix banks indexed by pair id = i*7 + j.

    Pair (i, j) with 0 <= i < j <= 6 (j==6 means the P word).
    Returns (A [49,14,14], B [49,14,14]) numpy arrays; unused slots zero.
    """
    A = np.zeros((N_PAIRS, 14, 14), dtype=np.uint8)
    B = np.zeros((N_PAIRS, 14, 14), dtype=np.uint8)
    for i in range(6):
        for j in range(i + 1, 7):
            k = i * 7 + j
            if j <= 5:
                d = j - i
                inv = gf2.tk_plus_i_inv(d)
                A[k] = gf2.matmul_gf2(inv, gf2.tpow(-(6 - j)))
                B[k] = inv
            else:  # second erasure is P0
                A[k] = gf2.tpow(-(6 - i))
                # B stays zero
    return A, B


@functools.lru_cache(maxsize=None)
def _q_solve_banks_stacked():
    """Stacked transposed banks [14, 49*14]: column k*14 + o of A holds
    output bit o of pair k's matrix A[k], over its 14 input bits."""
    A, B = _q_solve_banks()
    Astack = np.concatenate([A[k].T for k in range(N_PAIRS)], axis=1)
    Bstack = np.concatenate([B[k].T for k in range(N_PAIRS)], axis=1)
    return Astack.astype(np.int64), Bstack.astype(np.int64)


@functools.lru_cache(maxsize=None)
def _q_matrix_stacked():
    """[84, 14] stacked GF(2) matrix: concat of T^(6-k).T for k=0..5, so
    the Q code is one GF(2) product over the 6 words' 84 bits."""
    return np.concatenate([gf2.tpow(6 - k).T for k in range(6)],
                          axis=0).astype(np.int64)


def _calc_p(words):
    """P parity (stc007deinterleaver.cpp:1296-1304): XOR of audio words."""
    return (words[..., 0] ^ words[..., 1] ^ words[..., 2]
            ^ words[..., 3] ^ words[..., 4] ^ words[..., 5])


def _calc_q(words):
    """Q code (stc007deinterleaver.cpp:1306-1317): sum T^(6-k) w_k."""
    shifts = torch.arange(gf2.BITS, dtype=torch.int32, device=words.device)
    bits = (words[..., :6, None].to(torch.int32) >> shifts) & 1
    flat = bits.reshape(bits.shape[:-2] + (6 * gf2.BITS,))
    return gf2.bits_to_word(gf2.matmul_bits(flat, _q_matrix_stacked()))


def _taps(device):
    return torch.arange(N_WORDS, dtype=torch.int64,
                        device=device) * stc007.INTERLEAVE_OFS


@functools.lru_cache(maxsize=None)
def _q_banks_on(device):
    # Uploaded once per device, as _f1_shifts_on.
    return tuple(torch.as_tensor(m, dtype=torch.int32, device=device)
                 for m in _q_solve_banks_stacked())


@functools.lru_cache(maxsize=None)
def _f1_shifts_on(device):
    # Uploaded once per device: a CUDA graph capture refuses an upload.
    return torch.as_tensor(stc007.F1_S_OFFSETS, dtype=torch.int32,
                           device=device)


def _to16(w, c, s_words, s_crc):
    """16-bit PCM-F1: 14-bit word<<2 + 2 LSBs from the same line's S-word
    (stc007deinterleaver.cpp:1195-1274); Q slot zeroed and valid."""
    shifts = _f1_shifts_on(w.device)
    w16 = ((w[..., :7] << stc007.F1_WORD_OFS)
           + ((s_words >> shifts) & stc007.F1_S_MASK))
    c16 = c[..., :7] & s_crc
    return (torch.cat([w16, torch.zeros_like(w[..., :1])], dim=-1),
            torch.cat([c16, torch.ones_like(c[..., :1])], dim=-1))


def clamp_rows(rows: torch.Tensor, n: int) -> torch.Tensor:
    """Row indices into an n-row buffer as XLA's gather reads them in the
    JAX package: a negative index counts from the end, then every index is
    clamped to [0, n-1]. torch raises on an out-of-range index (a device
    assert on CUDA), so every gather the JAX package leaves to XLA's
    clamping goes through here."""
    return torch.where(rows < 0, rows + n, rows).clamp(0, n - 1)


def assemble_blocks(line_words, line_crc_ok, line_shifts, resolution):
    """Gather block words from the interleaved line buffer.

    line_words [L, 8] int32, line_crc_ok [L, 8] bool, line_shifts [B]
    block start lines, resolution RES_14BIT or RES_16BIT. Rows past either
    end of the buffer read clamped rows, as in the JAX package.
    Returns (words [B,8] int32, crc_ok [B,8] bool).
    """
    device = line_words.device
    shifts = torch.as_tensor(line_shifts, device=device).long()
    rows = clamp_rows(shifts[:, None] + _taps(device)[None, :],
                      line_words.shape[0])                       # [B, 8]
    widx = torch.arange(N_WORDS, device=device)[None, :]
    w = line_words[rows, widx]
    c = line_crc_ok[rows, widx]
    if resolution == RES_14BIT:
        return w, c
    return _to16(w, c, line_words[rows[:, :7], WORD_Q0],
                 line_crc_ok[rows[:, :7], WORD_Q0])


def assemble_blocks_contiguous(line_words, line_crc_ok, n_blocks,
                               resolution):
    """assemble_blocks for consecutive shifts 0..n_blocks-1: tap w of
    block b reads line b + 16w, so each tap column is one slice."""
    ofs = stc007.INTERLEAVE_OFS
    w = torch.stack([line_words[k * ofs:k * ofs + n_blocks, k]
                     for k in range(N_WORDS)], dim=-1)
    c = torch.stack([line_crc_ok[k * ofs:k * ofs + n_blocks, k]
                     for k in range(N_WORDS)], dim=-1)
    if resolution == RES_14BIT:
        return w, c
    s_words = torch.stack([line_words[k * ofs:k * ofs + n_blocks, WORD_Q0]
                           for k in range(7)], dim=-1)
    s_crc = torch.stack([line_crc_ok[k * ofs:k * ofs + n_blocks, WORD_Q0]
                         for k in range(7)], dim=-1)
    return _to16(w, c, s_words, s_crc)


def _first_two_bad(crc_ok):
    """Indices of first/second invalid audio word (or NO_ERR_INDEX)."""
    bad = ~crc_ok[..., :N_AUDIO]
    idx = torch.arange(N_AUDIO, dtype=torch.int32, device=crc_ok.device)
    first = torch.where(bad, idx, NO_ERR_INDEX).amin(dim=-1)
    second = torch.where(bad & (idx != first[..., None]), idx,
                         NO_ERR_INDEX).amin(dim=-1)
    return first, second


def _count_bad(crc_ok, n):
    return (~crc_ok[:, :n]).sum(-1, dtype=torch.int32)


def correct_blocks(words, crc_ok, resolution, en_p=True, en_q=True,
                   force_ecc=True, *, q_banks=None):
    """Branch-free port of the decision tree of processBlock (single fill).

    words [B,8] int32, crc_ok [B,8] bool. resolution/en_*/force_ecc are
    python values. q_banks: the stacked (A, B) banks of
    `_q_solve_banks_stacked` as int32 [14, 686] tensors on the words'
    device (StreamDecoder's buffers; when not given, the copies that
    `_q_banks_on` uploads once per device). Returns a BlockBatch.
    """
    device = words.device
    B = words.shape[0]
    is14 = resolution == RES_14BIT
    q_active = is14 and en_q

    line_crc = crc_ok
    valid = crc_ok
    first, second = _first_two_bad(crc_ok)
    aud_errs = _count_bad(crc_ok, N_AUDIO)
    tot_errs = _count_bad(crc_ok, N_WORDS if is14 else 7)

    p_ok = crc_ok[:, WORD_P0]
    q_ok = crc_ok[:, WORD_Q0]

    sp = _calc_p(words) ^ words[:, WORD_P0]
    sq = (_calc_q(words) ^ words[:, WORD_Q0]) if is14 \
        else torch.zeros_like(sp)

    # ---- P-path quantities (aud_errs <= 1, P word usable) ----------------
    p_fix_mask = sp  # xor mask applied to `first` when needed

    # ---- Q-path quantities (erasure pair solve) --------------------------
    # Effective pair: (first, second) with second -> P0 when only one audio
    # erasure and P word bad (fixByQ:1480-1488).
    eff_second = torch.where((second == NO_ERR_INDEX) & ~p_ok,
                             WORD_P0, second)
    pair_valid = (first != NO_ERR_INDEX) & (eff_second != NO_ERR_INDEX) \
        & (eff_second <= WORD_P0)
    pair_k = torch.where(pair_valid,
                         first * 7 + torch.clamp(eff_second, max=6), 0)
    if q_active:
        # e1 = A[k] @ sq ^ B[k] @ sp for the block's pair k: take pair k's
        # 14x14 slice of each stacked bank (a gather; the TPU needed a
        # one-hot selection here) and do the GF(2) product as AND + parity.
        if q_banks is None:
            q_banks = _q_banks_on(device)
        a3, b3 = (m.view(gf2.BITS, N_PAIRS, gf2.BITS) for m in q_banks)
        k = pair_k.long()
        sel_a = a3[:, k, :].permute(1, 0, 2)                 # [B, in, out]
        sel_b = b3[:, k, :].permute(1, 0, 2)
        sq_bits = gf2.word_to_bits(sq)[:, :, None]
        sp_bits = gf2.word_to_bits(sp)[:, :, None]
        e1_bits = ((sq_bits & sel_a).sum(1, dtype=torch.int32)
                   ^ (sp_bits & sel_b).sum(1, dtype=torch.int32)) & 1
        e1 = gf2.bits_to_word(e1_bits)
        e2 = e1 ^ sp
    else:
        e1 = e2 = torch.zeros_like(sp)

    # ======================================================================
    # Decision masks (mirror processBlock's reachable terminal states).
    # ======================================================================
    onehot = torch.arange(N_WORDS, dtype=torch.int32, device=device)[None, :]

    def at(index):
        """One-hot [B,8] mask for a per-block word index."""
        return onehot == index[:, None]

    # Default outcome: untouched.
    out_words = words
    out_valid = valid
    out_line_crc = line_crc
    audio_state = torch.zeros((B,), dtype=torch.int32, device=device)
    stage = torch.full((B,), STG_BAD_BLOCK, dtype=torch.int32, device=device)

    le2 = tot_errs <= 2                     # > 2 errors: BAD, ORIG

    # ---- aud_errs == 0 ---------------------------------------------------
    m_a0 = le2 & (aud_errs == 0)
    if not force_ecc:
        stage = torch.where(m_a0, STG_DATA_OK, stage)
    elif not en_p:
        stage = torch.where(m_a0, STG_NO_CHECK, stage)
    else:
        # Forced P check with no CRC marks.
        m = m_a0 & p_ok
        sp_zero = sp == 0
        # sp==0 -> DATA_OK (Q phase below); sp!=0 -> BROKEN.
        stage = torch.where(m & sp_zero, STG_DATA_OK, stage)
        broken0 = m & ~sp_zero
        # P word bad:
        m = m_a0 & ~p_ok
        if q_active:
            # Q_CORR with no marks:
            #  Q bad -> NO_CHECK + patch P and Q to recalculated values.
            mq = m & ~q_ok
            stage = torch.where(mq, STG_NO_CHECK, stage)
            new_p = _calc_p(words)
            new_q = _calc_q(words)
            patch = mq[:, None] & (onehot >= WORD_P0)
            out_words = torch.where(
                patch, torch.where(onehot == WORD_P0, new_p[:, None],
                                   new_q[:, None]), out_words)
            out_valid = out_valid | patch
            out_line_crc = torch.where(patch, False, out_line_crc)
            #  Q ok: second->P0; sq==0 -> recalcP + DATA_OK; else BROKEN.
            mq = m & q_ok
            sq_zero = sq == 0
            stage = torch.where(mq & sq_zero, STG_DATA_OK, stage)
            rp = mq & sq_zero
            new_p_now = _calc_p(out_words)
            ppatch = rp[:, None] & (onehot == WORD_P0)
            p_changed = new_p_now != out_words[:, WORD_P0]
            out_words = torch.where(ppatch, new_p_now[:, None], out_words)
            out_valid = out_valid | ppatch
            out_line_crc = torch.where(ppatch & p_changed[:, None], False,
                                       out_line_crc)
            broken0 = broken0 | (mq & ~sq_zero)
        else:
            stage = torch.where(m, STG_NO_CHECK, stage)
        # Apply BROKEN for forced-check failures.
        audio_state = torch.where(broken0, AUD_BROKEN, audio_state)

    # ---- aud_errs == 1 ---------------------------------------------------
    m_a1 = le2 & (aud_errs == 1)
    broken1 = torch.zeros((B,), dtype=torch.bool, device=device)
    fixp1 = torch.zeros((B,), dtype=torch.bool, device=device)
    fixq1 = torch.zeros((B,), dtype=torch.bool, device=device)
    if en_p:
        m = m_a1 & p_ok
        sp_zero = sp == 0
        # sp==0: the marked word was actually fine -> setValid + FIX_P mark.
        ok1 = m & sp_zero
        out_valid = out_valid | (ok1[:, None] & at(first))
        fixp1 = fixp1 | ok1
        # sp!=0: fix word `first` with parity.
        fx = m & ~sp_zero
        fmask = fx[:, None] & at(first)
        out_words = torch.where(fmask, out_words ^ p_fix_mask[:, None],
                                out_words)
        out_valid = out_valid | fmask
        out_line_crc = torch.where(fmask, False, out_line_crc)
        fixp1 = fixp1 | fx
        stage = torch.where(m, STG_DATA_OK, stage)
        # P word bad -> Q route.
        if q_active:
            m = m_a1 & ~p_ok
            # Q bad -> BAD_BLOCK (ORIG). Q ok -> pair (first, P0).
            mq = m & q_ok
            sq_zero = sq == 0
            # sq==0: audio word fine; recalc P; FIX_NOT_NEED -> FIX_Q mark.
            ok2 = mq & sq_zero
            out_valid = out_valid | (ok2[:, None] & at(first))
            new_p_now = _calc_p(out_words)
            ppatch = ok2[:, None] & (onehot == WORD_P0)
            p_changed = new_p_now != out_words[:, WORD_P0]
            out_words = torch.where(ppatch, new_p_now[:, None], out_words)
            out_valid = out_valid | ppatch
            out_line_crc = torch.where(ppatch & p_changed[:, None], False,
                                       out_line_crc)
            stage = torch.where(ok2, STG_DATA_OK, stage)
            fixq1 = fixq1 | ok2
            # sq!=0: solve pair (first, P0): e1 on first, e2 on P0.
            fx2 = mq & ~sq_zero
            f1mask = fx2[:, None] & at(first)
            e1nz = e1 != 0
            out_words = torch.where(f1mask & e1nz[:, None],
                                    out_words ^ e1[:, None], out_words)
            out_valid = out_valid | f1mask
            out_line_crc = torch.where(f1mask & e1nz[:, None], False,
                                       out_line_crc)
            pmask = fx2[:, None] & (onehot == WORD_P0)
            e2nz = e2 != 0
            out_words = torch.where(pmask & e2nz[:, None],
                                    out_words ^ e2[:, None], out_words)
            out_valid = out_valid | pmask
            out_line_crc = torch.where(pmask & e2nz[:, None], False,
                                       out_line_crc)
            stage = torch.where(fx2, STG_DATA_OK, stage)
            fixq1 = fixq1 | fx2
    # 14-bit Q post-check after successful P path (forced check / patch).
    if en_p and q_active:
        m = m_a1 & p_ok  # blocks that went through the P route above
        # Q valid + forced check: recompute Q syndrome on FIXED words.
        if force_ecc:
            sq_fixed = _calc_q(out_words) ^ out_words[:, WORD_Q0]
            bq = m & q_ok & (sq_fixed != 0)
            broken1 = broken1 | bq
            stage = torch.where(bq, STG_BAD_BLOCK, stage)
        # Q invalid: patch it from fixed words.
        mqp = m & ~q_ok
        new_q_now = _calc_q(out_words)
        qpatch = mqp[:, None] & (onehot == WORD_Q0)
        q_changed = new_q_now != out_words[:, WORD_Q0]
        out_words = torch.where(qpatch, new_q_now[:, None], out_words)
        out_valid = out_valid | qpatch
        out_line_crc = torch.where(qpatch & q_changed[:, None], False,
                                   out_line_crc)
    audio_state = torch.where(fixp1 & ~broken1, AUD_FIX_P, audio_state)
    audio_state = torch.where(fixq1, AUD_FIX_Q, audio_state)
    audio_state = torch.where(broken1, AUD_BROKEN, audio_state)

    # Same Q post-check applies to the aud_errs==0 forced-P success path.
    if force_ecc and en_p and q_active:
        m = m_a0 & p_ok & (sp == 0)
        sq_fixed = _calc_q(out_words) ^ out_words[:, WORD_Q0]
        bq = m & q_ok & (sq_fixed != 0)
        audio_state = torch.where(bq, AUD_BROKEN, audio_state)
        stage = torch.where(bq, STG_BAD_BLOCK, stage)
        mqp = m & ~q_ok
        new_q_now = _calc_q(out_words)
        qpatch = mqp[:, None] & (onehot == WORD_Q0)
        q_changed = new_q_now != out_words[:, WORD_Q0]
        out_words = torch.where(qpatch, new_q_now[:, None], out_words)
        out_valid = out_valid | qpatch
        out_line_crc = torch.where(qpatch & q_changed[:, None], False,
                                   out_line_crc)

    # ---- aud_errs == 2 ---------------------------------------------------
    m_a2 = le2 & (aud_errs == 2)
    if q_active:
        mq = m_a2 & q_ok
        # 3-erasure guard: two audio marks + bad P -> FIX_NA (BAD, ORIG).
        solvable = mq & p_ok
        both_zero = (sp == 0) & (sq == 0)
        ok3 = solvable & both_zero
        out_valid = out_valid | (ok3[:, None] & (at(first) | at(second)))
        stage = torch.where(ok3, STG_DATA_OK, stage)
        fx3 = solvable & ~both_zero
        f1mask = fx3[:, None] & at(first)
        s1mask = fx3[:, None] & at(second)
        e1nz, e2nz = e1 != 0, e2 != 0
        out_words = torch.where(f1mask & e1nz[:, None],
                                out_words ^ e1[:, None], out_words)
        out_line_crc = torch.where(f1mask & e1nz[:, None], False,
                                   out_line_crc)
        out_words = torch.where(s1mask & e2nz[:, None],
                                out_words ^ e2[:, None], out_words)
        out_line_crc = torch.where(s1mask & e2nz[:, None], False,
                                   out_line_crc)
        out_valid = out_valid | f1mask | s1mask
        stage = torch.where(fx3, STG_DATA_OK, stage)
        audio_state = torch.where(fx3 | ok3, AUD_FIX_Q, audio_state)
    # 16-bit mode / q disabled: two audio errors cannot be fixed (BAD, ORIG).

    # ---- markAsBroken flag wipe (stc007datablock.cpp) --------------------
    brk = audio_state == AUD_BROKEN
    wipe = brk[:, None] & (onehot < (N_WORDS if is14 else 7))
    out_valid = torch.where(wipe, False, out_valid)
    out_line_crc = torch.where(wipe, False, out_line_crc)

    res_arr = torch.full((B,), resolution, dtype=torch.int32, device=device)
    # Overflow blocks stay BAD/ORIG with untouched words (already default).
    return BlockBatch(out_words, out_valid, out_line_crc, audio_state,
                      stage, res_arr)


def correct_blocks_cwd(words, crc_ok, cwd_fixed, resolution, en_p=True,
                       en_q=True, force_ecc=True, *, q_banks=None):
    """correct_blocks with Cross-Word-Decoding assist.

    The reference enters STG_CWD_CORR only from failure paths (>2 total
    errors, or 2 audio errors in 16-bit mode; stc007deinterleaver.cpp:
    586-635) and then re-runs selection with pre-fixed words counted valid.
    Vectorized: run the tree on raw CRC flags and on (crc | cwd_fixed);
    select the CWD result exactly for blocks that would have entered
    STG_CWD_CORR with at least one applicable pre-fixed word.

    Returns (BlockBatch, cwd_applied [B] bool).
    """
    r_raw = correct_blocks(words, crc_ok, resolution, en_p=en_p, en_q=en_q,
                           force_ecc=force_ecc, q_banks=q_banks)
    eff_ok = crc_ok | cwd_fixed
    r_eff = correct_blocks(words, eff_ok, resolution, en_p=en_p, en_q=en_q,
                           force_ecc=force_ecc, q_banks=q_banks)
    is14 = resolution == RES_14BIT
    tot_limit = N_WORDS if is14 else 7
    raw_tot = _count_bad(crc_ok, tot_limit)
    raw_aud = _count_bad(crc_ok, N_AUDIO)
    enters_cwd = (raw_tot > 2) | ((raw_aud == 2) & (not is14))
    helpful = (cwd_fixed[:, :tot_limit] & ~crc_ok[:, :tot_limit]).any(-1)
    use_eff = enters_cwd & helpful
    sel = lambda a, b: torch.where(
        use_eff.reshape(use_eff.shape + (1,) * (a.dim() - 1)), b, a)
    out = BlockBatch(*(sel(a, b) for a, b in zip(r_raw, r_eff)))
    # line_crc keeps RAW source CRC state even for CWD blocks (setWord in
    # STG_CWD_CORR does not touch line_crc).
    out = out._replace(line_crc=torch.where(use_eff[:, None], crc_ok,
                                            out.line_crc))
    return out, use_eff


def select_auto(r1: BlockBatch, r2: BlockBatch) -> BlockBatch:
    """Auto resolution: keep r1 unless it fails and r2 succeeds."""
    use2 = (r1.stage == STG_BAD_BLOCK) & (r2.stage != STG_BAD_BLOCK)
    return BlockBatch(*(
        torch.where(use2.reshape(use2.shape + (1,) * (a.dim() - 1)), b, a)
        for a, b in zip(r1, r2)))


def deinterleave(line_words, line_crc_ok, line_shifts,
                 res_mode=RES_MODE_14BIT_AUTO, en_p=True, en_q=True,
                 force_ecc=True, *, q_banks=None):
    """Full processBlock equivalent incl. auto-resolution refill passes.

    The reference refills up to 3 times, toggling resolution on BAD_BLOCK
    (stc007deinterleaver.cpp:349-377, 1039-1056); pass 3 repeats pass 1, so
    auto mode == "use first resolution unless it fails and the other
    succeeds".
    """
    contiguous = (isinstance(line_shifts, np.ndarray)
                  and len(line_shifts) > 0
                  and line_shifts[0] == 0
                  and np.array_equal(line_shifts,
                                     np.arange(len(line_shifts))))

    def run(res):
        if contiguous:
            w, c = assemble_blocks_contiguous(
                line_words, line_crc_ok, len(line_shifts), res)
        else:
            w, c = assemble_blocks(line_words, line_crc_ok, line_shifts,
                                   res)
        return correct_blocks(w, c, res, en_p=en_p, en_q=en_q,
                              force_ecc=force_ecc, q_banks=q_banks)

    if res_mode == RES_MODE_14BIT:
        return run(RES_14BIT)
    if res_mode == RES_MODE_16BIT:
        return run(RES_16BIT)
    first_res = RES_14BIT if res_mode == RES_MODE_14BIT_AUTO else RES_16BIT
    other_res = RES_16BIT if first_res == RES_14BIT else RES_14BIT
    return select_auto(run(first_res), run(other_res))


def block_samples(batch: BlockBatch, m2=False):
    """Audio samples [B, 6] int16 from a BlockBatch (res-aware)."""
    w14 = stc007.expand_sample(batch.words[:, :N_AUDIO], m2=m2)
    w16 = batch.words[:, :N_AUDIO].to(torch.int32) & 0xFFFF
    w16 = torch.where(w16 >= 0x8000, w16 - 0x10000, w16).to(torch.int16)
    is16 = (batch.resolution == RES_16BIT)[:, None]
    return torch.where(is16, w16, w14)
