"""Device twins of the stitcher's seam-scoring primitives, and the
chip-resident STC-007 round.

Port of sdvpcmdecoder_tpu/ops/device_stitch.py. Two users:

  * the per-call seam backend (`seam_sweep`, `eval_rows_arrays`): the
    stitcher's padding search (reference tryPadding
    stc007datastitcher.cpp:1417, findPadding :1743) scores every padding
    0..P_MAX-1 of a seam in one call -- each padding is a different row map
    into a master [field-1 tail | silent row | field-2 head] buffer;
  * the steady round (`steady_round_packed`): binarize a round of frames,
    flag duplicate lines, evaluate every guessed conv/seam/resolution block
    queue at 14 and 16 bit, reduce the seam queues to burst counters and
    the resolution queues to counts, and return one int32 buffer.

Every function equals its JAX original exactly (values and dtypes) on the
same inputs; tests/test_torch_device_stitch.py pins them. Differences of
form, none of value:
  * torch runs eagerly, so the JAX package's jit wrappers and static
    arguments are plain calls and Python arguments; the per-call seam
    backend's two programs (_eval_rows_jit, _seam_sweep) replay as CUDA
    graphs from the thread's round_graph holder instead, keyed by their
    static arguments and bucketed shapes as jax.jit keys them
    (graphs=False: eager); the round's graph is its driver's;
  * torch has almost no uint32 arithmetic: packed block words are int64
    here (every packed value is below 2**24) and the round writes them
    into its int32 buffer unchanged, as the JAX package's u32 -> i32
    bitcast does;
  * torch raises on an out-of-range gather where XLA clamps: row maps go
    through deinterleave.clamp_rows, and every take_along_axis index is
    clamped below at 0 as in the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..formats import stc007
from . import binarize as bz
from . import deinterleave as di
from . import fused_binarize as fb
from ..utils.host import HostCopy
from .round_graph import call, thread_graphs

KEEP = stc007.MIN_DEINT_DATA + stc007.INTERLEAVE_OFS // 2   # 120
P_MAX = stc007.INTERLEAVE_OFS * 2                           # 32 paddings
# Longest queue: len1 <= KEEP - pad, so L = len1+pad+count2 <= 2*KEEP.
B_MAX = 2 * KEEP - stc007.MIN_DEINT_DATA                    # 128 blocks

# Flag bits (stitchcore.cpp stc007_eval_rows flags contract).
FLAG_BROKEN, FLAG_BLOCK_VALID, FLAG_CAN_FORCE, FLAG_SILENT = 1, 2, 4, 8
FLAG_FIX_P, FLAG_FIX_Q, FLAG_CWD_APP = 16, 32, 64

MAX_BURST_SILENCE = stc007.INTERLEAVE_OFS // 2  # 8
MAX_BURST_BROKEN = 1

# packed block word: valid[0:8] | line_crc[8:16] | flags[16:22]
# (FLAG_* order) | stage==BAD_BLOCK at bit 22.
PACK_BAD_BIT = 22
PACK_U16_BIT = 23   # selected-pack readback: 1 = 16-bit eval chosen
# Every packed word stays below 2**(PACK_U16_BIT + 1) <= 2**31, so writing
# it into the round's int32 buffer keeps its bits (the JAX package's
# u32 -> i32 bitcast is the identity on it).
assert PACK_U16_BIT < 31

MDD_ = stc007.MIN_DEINT_DATA


class RoundTables(nn.Module):
    """The round's constant tables as buffers, so `.to(device)` moves them
    once: the binarizer's CRC syndrome table and bit-pack weights, the
    stacked Q-solve banks of the ECC, and the silent-line words (plain and
    M2)."""

    def __init__(self):
        super().__init__()
        synd_table, _ = bz._syndrome_const()
        q_a, q_b = di._q_solve_banks_stacked()
        self.register_buffer("synd_table", torch.as_tensor(synd_table))
        self.register_buffer("pack_weights",
                             torch.as_tensor(bz._pack_weights()))
        self.register_buffer("q_bank_a",
                             torch.as_tensor(q_a, dtype=torch.int32))
        self.register_buffer("q_bank_b",
                             torch.as_tensor(q_b, dtype=torch.int32))
        self.register_buffer("silent_w", stc007.silent_words(m2=False))
        self.register_buffer("silent_w_m2", stc007.silent_words(m2=True))

    def silent(self, m2: bool) -> torch.Tensor:
        return self.silent_w_m2 if m2 else self.silent_w

    @property
    def q_banks(self):
        return self.q_bank_a, self.q_bank_b


def blocks_flags_samples(batch: di.BlockBatch, cwd_in, m2: bool):
    """Per-block packed flags u8 + samples [B, 6] i16 from a corrected
    BlockBatch (the aux quantities of stitcher_stc007.eval_rows)."""
    is16 = batch.resolution == di.RES_16BIT
    lim = torch.where(is16, 7, 8)
    widx = torch.arange(8, device=is16.device)[None, :]
    in_lim = widx < lim[:, None]
    broken = batch.audio_state == di.AUD_BROKEN
    block_valid = batch.valid[:, :6].all(dim=-1)
    raw_errs = (((~batch.line_crc) & in_lim) & ~(cwd_in & in_lim)).sum(-1)
    can_force = ~broken & torch.where(is16, raw_errs == 0, raw_errs <= 1)
    samples = di.block_samples(batch, m2=m2)
    silent = (samples == 0).all(dim=-1)
    u8 = lambda m: m.to(torch.uint8)
    flags = (u8(broken) * FLAG_BROKEN
             | u8(block_valid) * FLAG_BLOCK_VALID
             | u8(can_force) * FLAG_CAN_FORCE
             | u8(silent) * FLAG_SILENT
             | u8(batch.audio_state == di.AUD_FIX_P) * FLAG_FIX_P
             | u8(batch.audio_state == di.AUD_FIX_Q) * FLAG_FIX_Q)
    return flags, samples


def select_by_mode(r14: di.BlockBatch, r16: di.BlockBatch, mode):
    """Per-block resolution-mode select: M14/M16 fixed, M14A/M16A fall
    back to the other resolution on STG_BAD_BLOCK (processBlock's
    refill passes, stc007deinterleaver.cpp:349-377). mode is an int or a
    per-block tensor [B]."""
    mode = torch.as_tensor(mode, device=r14.stage.device)
    bad14 = r14.stage == di.STG_BAD_BLOCK
    bad16 = r16.stage == di.STG_BAD_BLOCK
    use16 = ((mode == di.RES_MODE_16BIT)
             | ((mode == di.RES_MODE_16BIT_AUTO) & ~(bad16 & ~bad14))
             | ((mode == di.RES_MODE_14BIT_AUTO) & bad14 & ~bad16))
    sel = lambda a, b: torch.where(
        use16.reshape(use16.shape + (1,) * (a.dim() - 1)), b, a)
    return di.BlockBatch(*(sel(a, b) for a, b in zip(r14, r16)))


def assemble_rows_16(line_words, line_crc, rows):
    """16-bit (PCM-F1) block assembly over explicit row maps [.., 8]:
    14-bit word << 2 + 2 LSBs from the S-word of the SAME line
    (stc007deinterleaver.cpp:1195-1274). Returns (w16, c16, w14, c14);
    rows outside the buffer read clamped rows, as in the JAX package."""
    rows = di.clamp_rows(rows.long(), line_words.shape[0])
    widx = torch.arange(8, device=line_words.device)
    w = line_words[rows, widx]
    c = line_crc[rows, widx]
    w16, c16 = di._to16(w, c, line_words[rows[..., :7], di.WORD_Q0],
                        line_crc[rows[..., :7], di.WORD_Q0])
    return w16, c16, w, c


def eval_rows_device(line_words, line_crc, rows, mode, en_p, en_q,
                     force_ecc, m2, *, q_banks=None):
    """stitcher eval_rows compute core on device: rows [B, 8] absolute
    line indices, mode [B] i32 res mode per block (data, not a Python
    value). Returns (flags [B] u8, samples [B, 6] i16, batch BlockBatch)."""
    w16, c16, w14, c14 = assemble_rows_16(line_words, line_crc, rows)
    r14 = di.correct_blocks(w14, c14, di.RES_14BIT, en_p=en_p, en_q=en_q,
                            force_ecc=force_ecc, q_banks=q_banks)
    r16 = di.correct_blocks(w16, c16, di.RES_16BIT, en_p=en_p, en_q=en_q,
                            force_ecc=force_ecc, q_banks=q_banks)
    batch = select_by_mode(r14, r16, mode)
    cwd_in = torch.zeros(rows.shape[:-1] + (8,), dtype=torch.bool,
                         device=line_words.device)
    flags, samples = blocks_flags_samples(batch, cwd_in, m2)
    return flags, samples, batch


def _runs(mask, idx):
    """Length of the run of True ending at each position (0 where False)."""
    last_false = torch.cummax(torch.where(~mask, idx, -1), dim=1).values
    return torch.where(mask, idx - last_false, 0)


def burst_stats_batch(flags, nb, unch_lim, en_q: bool,
                      max_burst_silence: int, max_burst_broken: int):
    """Vectorized tryPadding burst counters over a batch of seams.

    flags [P, B] u8 (zeroed beyond each seam's nb blocks), nb [P] i32,
    unch_lim [P] i32. Serial semantics of stc007datastitcher.cpp:1623-1720,
    cumulative-sum formulation (twin of stitcher_stc007._burst_stats;
    zero-padding the tail is safe: resets never fire there and the valid
    run freezes, so the trailing candidates equal the final run).
    Returns stats [P, 4] i32 = (valid_max, silent_max, unch_max, broken).
    """
    P, B = flags.shape
    i32 = torch.int32
    idx = torch.arange(B, dtype=i32, device=flags.device)[None, :]
    live = idx < nb[:, None]
    flags = torch.where(live, flags, 0)
    broken = (flags & FLAG_BROKEN) != 0
    block_valid = (flags & FLAG_BLOCK_VALID) != 0
    can_force = (flags & FLAG_CAN_FORCE) != 0
    silent = (flags & FLAG_SILENT) != 0
    valid_b = block_valid & ~silent & can_force
    if en_q:
        unch = (~can_force | ((flags & FLAG_FIX_Q) != 0)) & live
    else:
        unch = (flags & FLAG_FIX_P) != 0

    sil_run = _runs(silent, idx)
    unch_run = _runs(unch, idx)
    sil_max = sil_run.amax(dim=1)
    unch_max = unch_run.amax(dim=1)
    broken_count = broken.sum(dim=1, dtype=i32)

    reset = ((silent & (sil_run >= max_burst_silence))
             | (unch & (unch_run >= unch_lim[:, None]))
             | (broken & (torch.cumsum(broken, dim=1, dtype=i32)
                          >= max_burst_broken)))
    cumv = torch.cumsum(valid_b, dim=1, dtype=i32)
    last_reset = torch.cummax(torch.where(reset, idx, -1), dim=1).values
    base = torch.gather(cumv, 1, last_reset.clamp(min=0).long())
    run_after = cumv - torch.where(last_reset >= 0, base, 0)
    prev_run = torch.cat([torch.zeros((P, 1), dtype=i32,
                                      device=flags.device),
                          run_after[:, :-1]], dim=1)
    final = torch.gather(run_after, 1,
                         (nb[:, None].long() - 1).clamp(min=0))[:, 0]
    final = torch.where(nb > 0, final, 0)
    cand = torch.where(~valid_b, prev_run, 0).amax(dim=1)
    valid_max = torch.maximum(cand, final)
    return torch.stack([valid_max, sil_max, unch_max, broken_count],
                       dim=1).to(i32)


def _bucket(n, step=128):
    return max(step, -(-n // step) * step)


def _on_device(name, body, inputs, static, device, graphs):
    """body(*inputs) on `device`, inputs host tensors, each output copied
    to the host (numpy) before this returns: with `graphs` a replay of the
    key (name, the static arguments) from the thread's holder
    (round_graph.thread_graphs), as jax.jit compiles the JAX package's
    programs once per shape and static arguments; else eagerly on the
    inputs uploaded. Each output is copied (HostCopy) before the thread's
    next call can replay into it, and one wait covers them all."""
    outs = call(thread_graphs(device) if graphs else None,
                (name,) + static, body, inputs, device)
    return [c.numpy() for c in [HostCopy(o) for o in outs]]


def _eval_rows_body(en_p, en_q, force_ecc, m2):
    """The JAX package's _eval_rows_jit: its static arguments bound, the
    row maps and the per-block modes inputs."""
    def body(line_words, line_crc, rows, modes):
        flags, samples, batch = eval_rows_device(
            line_words, line_crc, rows, modes, en_p, en_q, force_ecc, m2)
        return tuple(t.contiguous() for t in (*batch, flags, samples))
    return body


def eval_rows_arrays(line_words_i32, line_crc8, rows, start, n_blocks,
                     res_mode, en_p, en_q, force_ecc, m2, *, device="cuda",
                     graphs=True):
    """Device twin of stitch_native.eval_rows_arrays: one call on
    `device`, with `graphs` one CUDA graph launch (_on_device). rows=None
    means contiguous shifts from `start`. L and B are padded to 128-line
    buckets, as in the JAX package, so a capture's whole decode replays a
    handful of graphs, and rows past the buffer's end read the same (zero
    or clamped) lines there.

    Returns numpy (words i64 [B,8], valid, line_crc, state, stage, res,
    flags, samples) -- the exact native-core output contract."""
    B = int(n_blocks)
    if rows is None:
        taps = np.arange(8, dtype=np.int64) * stc007.INTERLEAVE_OFS
        rows = (np.arange(start, start + B, dtype=np.int64)[:, None]
                + taps[None, :])
    L = line_words_i32.shape[0]
    Lp, Bp = _bucket(L), _bucket(B)
    w = np.zeros((Lp, 8), np.int32)
    c = np.zeros((Lp, 8), bool)
    w[:L] = line_words_i32
    c[:L] = line_crc8
    r = np.zeros((Bp, 8), np.int32)
    r[:B] = rows
    modes = np.full(Bp, res_mode, np.int32)
    static = (bool(en_p), bool(en_q), bool(force_ecc), bool(m2))
    words, valid, lcrc, state, stage, res, flags, samples = _on_device(
        "eval_rows", _eval_rows_body(*static),
        tuple(torch.from_numpy(a) for a in (w, c, r, modes)), static,
        device, graphs)
    return (words[:B].astype(np.int64), valid[:B], lcrc[:B], state[:B],
            stage[:B], res[:B], flags[:B], samples[:B])


def _seam_sweep(f1_words, f1_crc, f1_len, f2_words, f2_crc, f2_len,
                silent_w, modes, unch_lim, en_p, en_q, m2):
    """Score P_MAX paddings of one seam in one call.

    f1_words [KEEP, 8] i32: field-1 tail, RIGHT-aligned (row KEEP-1 is
    the field's last line; unused leading rows are never referenced).
    f2_words [KEEP, 8]: field-2 head, top-aligned. f1_len/f2_len the full
    field lengths (int32 tensors, as the JAX package traces them: one
    graph serves every seam). modes [P_MAX] i32 res mode per padding
    (-1 = skip). unch_lim [P_MAX] i32 per pad.
    Returns (stats [P_MAX, 4] i32, nb [P_MAX] i32).
    """
    device = f1_words.device
    i32 = torch.int32
    master_w = torch.cat([f1_words, silent_w[None, :], f2_words])
    master_c = torch.cat([f1_crc, torch.zeros((1, 8), dtype=torch.bool,
                                              device=device), f2_crc])
    pads = torch.arange(P_MAX, dtype=i32, device=device)
    len1 = torch.minimum(KEEP - pads, f1_len)                # [P]
    count2 = torch.clamp(f2_len, max=KEEP)
    nb = len1 + pads + count2 - stc007.MIN_DEINT_DATA        # [P]
    taps = torch.arange(8, dtype=i32, device=device) * stc007.INTERLEAVE_OFS
    r = (torch.arange(B_MAX, dtype=i32, device=device)[None, :, None]
         + taps[None, None, :])                              # [1, B, 8]
    l1 = len1[:, None, None]
    p = pads[:, None, None]
    rows = torch.where(
        r < l1, KEEP - l1 + r,
        torch.where(r < l1 + p, KEEP, KEEP + 1 + r - l1 - p))
    rows = torch.clamp(rows, 0, master_w.shape[0] - 1)
    mode_b = modes[:, None].expand(P_MAX, B_MAX)
    flags, _, _ = eval_rows_device(
        master_w, master_c, rows.reshape(P_MAX * B_MAX, 8),
        mode_b.reshape(-1), en_p, en_q, True, m2)
    nb = torch.where(modes >= 0, nb.clamp(min=0), 0)
    stats = burst_stats_batch(flags.reshape(P_MAX, B_MAX), nb, unch_lim,
                              en_q, MAX_BURST_SILENCE, MAX_BURST_BROKEN)
    return stats, nb


def _right_aligned_tail(words, crc8, cap=KEEP):
    """Last <= cap rows placed at the END of a [cap, 8] buffer."""
    n = min(len(words), cap)
    w = np.zeros((cap, 8), np.int32)
    c = np.zeros((cap, 8), bool)
    if n:
        w[cap - n:] = words[len(words) - n:]
        c[cap - n:] = crc8[len(words) - n:]
    return w, c, n


def _top_aligned_head(words, crc8, cap=KEEP):
    n = min(len(words), cap)
    w = np.zeros((cap, 8), np.int32)
    c = np.zeros((cap, 8), bool)
    if n:
        w[:n] = words[:n]
        c[:n] = crc8[:n]
    return w, c, n


def seam_sweep(f1_words, f1_crc8, f2_words, f2_crc8, silent_w32, modes,
               en_p, en_q, m2, unch_lim, *, device="cuda", graphs=True):
    """Host wrapper: all-paddings seam stats on `device`, with `graphs`
    one CUDA graph launch (_on_device; one key serves every seam).

    f1/f2 words [n,8] i32 + crc8 [n,8] bool (full fields; only the
    KEEP-row tail/head is shipped), modes len<=P_MAX ints (-1 skip),
    unch_lim int or per-pad array. Returns numpy (stats [len(modes),4]
    i32, has [len(modes)] bool) matching stitch_native.padding_sweep.
    """
    P = len(modes)
    md = np.full(P_MAX, -1, np.int32)
    md[:P] = np.asarray(modes, np.int32)[:P_MAX]
    ul = np.broadcast_to(np.asarray(unch_lim, np.int32), (P,))
    ulf = np.zeros(P_MAX, np.int32)
    ulf[:P] = ul[:P_MAX]
    w1, c1, _ = _right_aligned_tail(np.asarray(f1_words, np.int32),
                                    np.asarray(f1_crc8, bool))
    w2, c2, _ = _top_aligned_head(np.asarray(f2_words, np.int32),
                                  np.asarray(f2_crc8, bool))
    static = (bool(en_p), bool(en_q), bool(m2))
    stats, nb = _on_device(
        "seam_sweep", lambda *a: _seam_sweep(*a, *static),
        tuple(torch.from_numpy(np.asarray(a)) for a in (
            w1, c1, np.int32(len(f1_words)), w2, c2,
            np.int32(len(f2_words)),
            np.ascontiguousarray(silent_w32, np.int32), md, ulf)),
        static, device, graphs)
    stats, nb = stats[:P], nb[:P]
    has = (nb > 0) & (md[:P] >= 0)
    return stats, has


# ---------------------------------------------------------------------------
# Device-resident steady round: binarize + duplicate detection + DUAL
# (14- and 16-bit) block eval of every pair's seam/res/conv queues in
# ONE call per round of frames. No resolution-mode logic, burst
# counters or finalize masking run on device -- the host selects per
# block by the ACTUAL stage-machine mode at replay time and verifies
# the speculated geometry, so results are bit-identical by
# construction or discarded (docs/STEADY.md contract).
# ---------------------------------------------------------------------------

def _dual_eval(words_all, crc_all, rows, en_p, en_q, m2, *, q_banks=None):
    """Both-resolutions eval over explicit rows: returns
    (packed [B, 2] int64 holding the JAX package's u32 packs,
    samples [B, 2, 6] i16), index 0 = 14-bit."""
    w16, c16, w14, c14 = assemble_rows_16(words_all, crc_all, rows)
    bits = torch.arange(8, dtype=torch.int64, device=words_all.device)
    packs, samps = [], []
    for res, (w, c) in ((di.RES_14BIT, (w14, c14)),
                        (di.RES_16BIT, (w16, c16))):
        r = di.correct_blocks(w, c, res, en_p=en_p, en_q=en_q,
                              force_ecc=True, q_banks=q_banks)
        cwd = torch.zeros(rows.shape[:-1] + (8,), dtype=torch.bool,
                          device=words_all.device)
        flags, samples = blocks_flags_samples(r, cwd, m2)
        vbits = (r.valid.long() << bits).sum(-1)
        lbits = (r.line_crc.long() << bits).sum(-1)
        bad = (r.stage == di.STG_BAD_BLOCK).long()
        packs.append(vbits | (lbits << 8) | (flags.long() << 16)
                     | (bad << PACK_BAD_BIT))
        samps.append(samples)
    return torch.stack(packs, dim=1), torch.stack(samps, dim=1)


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of the low 32 bits of each int64 (SWAR; torch has no
    popcount op): lax.population_count of the value as uint32."""
    x = x & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def _dup_device(words, crc_read, valid, m2):
    """find_duplicate_lines twin on device: words [F, L, 8] i32,
    crc_read [F, L] i32, valid [F, L] bool; field bounds (0, ceil(L/2)),
    (ceil(L/2), L) -- the batch driver's field-sequential layout."""
    F, L, _ = words.shape
    device = words.device
    half = (L + 1) // 2
    thres = stc007.BITS_PCM_DATA // 4  # BIT_DIFF_THRES_DIV = 4
    samples = stc007.expand_sample(words[..., :6], m2=m2)
    almost_silent = (samples.to(torch.int32).abs() < 16).sum(-1) >= 2
    idx = torch.arange(L, dtype=torch.int32, device=device)
    fld = (idx >= half).to(torch.int32)           # field id per row
    # previous valid row WITHIN the same field (cummax resets at the
    # boundary by keying on field id).
    cand = torch.where(valid, idx[None, :], -1)
    prev_incl = torch.cummax(torch.where(fld[None, :] == 0, cand, -1),
                             dim=1).values
    prev_incl2 = torch.cummax(torch.where(fld[None, :] == 1, cand, -1),
                              dim=1).values
    prev_incl = torch.where(fld[None, :] == 0, prev_incl, prev_incl2)
    prev = torch.cat([torch.full((F, 1), -1, dtype=torch.int32,
                                 device=device), prev_incl[:, :-1]], dim=1)
    # A row with no previous row (prev = -1) reads row 0's field, masked.
    prev_fld = torch.where(prev >= 0, fld[prev.clamp(min=0).long()], -1)
    prev = torch.where(fld[None, :] == prev_fld, prev, -1)
    prev0 = prev.clamp(min=0).long()
    pw = torch.gather(words, 1, prev0[..., None].expand(F, L, 8))
    pc = torch.gather(crc_read, 1, prev0)
    diff = (popcount32((words ^ pw).long()).sum(-1)
            + popcount32((crc_read ^ pc).long()))
    return valid & (prev >= 0) & (diff <= thres) & ~almost_silent


def _steady_round_core(pixels, coords, refs, blacks, whites, usable,
                       prev_words, prev_ok8, carry_w, carry_ok8,
                       rows_g1, rows_g2, silent_w,
                       en_p, en_q, m2, hyst_limit, shift_limit,
                       use_kernel, *, tables=None):
    """The chip-resident round: binarize a round of frames from resident
    pixels, run duplicate detection, and dual-eval every speculated
    seam/res/conv queue.

    pixels [F, Ls, W] u8, prep arrays [F], prev_* [Ls, 8] (previous
    round's last frame), carry [112, 8], rows_g1/g2 [B, 8] i32 row maps
    into [prev | round | carry | silent]. use_kernel binarizes through
    fused_binarize (the CUDA kernel K1 on a CUDA tensor); otherwise the
    plain version. tables: RoundTables on the pixels' device (built per
    call when not given).
    Returns (words, crc_read, valid, dup, packed1, samples1, packed2,
    words_flat, lineok8)."""
    F, Ls, W = pixels.shape
    binarize = fb.stc007_fused_decode_frames if use_kernel \
        else bz.stc007_frame_decode
    kw = {} if tables is None else dict(synd_table=tables.synd_table,
                                        pack_weights=tables.pack_weights)
    batch = binarize(pixels, coords, refs, blacks, whites,
                     hyst_limit=hyst_limit, shift_limit=shift_limit, **kw)
    words = torch.where(usable[:, None, None], batch.words.to(torch.int32),
                        0)
    crc_read = torch.where(usable[:, None], batch.crc_read.to(torch.int32),
                           0)
    valid = batch.valid & usable[:, None]
    dup = _dup_device(words, crc_read, valid, m2)
    lineok = (valid & ~dup).reshape(F * Ls)
    ok8 = lineok[:, None].expand(F * Ls, 8).contiguous()
    wflat = words.reshape(F * Ls, 8)
    no_ok = torch.zeros((1, 8), dtype=torch.bool, device=pixels.device)
    words_all = torch.cat([prev_words, wflat, carry_w, silent_w[None, :]])
    ok_all = torch.cat([prev_ok8, ok8, carry_ok8, no_ok])
    q_banks = None if tables is None else tables.q_banks
    packed1, samples1 = _dual_eval(words_all, ok_all, rows_g1, en_p, en_q,
                                   m2, q_banks=q_banks)
    # The resolution queues are always scored with P on and Q off.
    packed2, _ = _dual_eval(words_all, ok_all, rows_g2, True, False, m2,
                            q_banks=q_banks)
    return (words, crc_read, valid, dup, packed1, samples1, packed2,
            wflat, ok8)


# The JAX package's jitted core; torch runs it eagerly under the same name.
steady_round_dispatch = _steady_round_core


def round_param_layout(F):
    """Offsets into the packed per-round i32 parameter vector (one
    host->device upload per round)."""
    o, n = {}, 0
    for key, sz in (("coords", 2 * F), ("refs", F), ("blacks", F),
                    ("whites", F), ("usable", F),
                    ("carry_w", MDD_ * 8), ("carry_ok", MDD_ * 8),
                    ("pred_mode", 1), ("unch_lim", 1)):
        o[key] = n
        n += sz
    return o, n


def steady_round_packed(pixels, params, prev_words, prev_ok8,
                        carry_w_dev, carry_ok_dev, carry_next_rows,
                        rows_g1, rows_g2, nb_seam, silent_w, B_conv,
                        en_p, en_q, m2, hyst_limit, shift_limit,
                        use_kernel, chained=False, *, tables=None):
    """One-upload / one-read steady round.

    Same compute as steady_round_dispatch, but every per-round scalar
    input arrives in ONE i32 vector (round_param_layout) and every
    host-bound output leaves in ONE i32 buffer: crc|valid|dup|cb|crcm as
    one word per line (the word VALUES stay on the device), the conv
    queues' pred-mode-selected pack + samples, the fresh-field resolution
    counts, and the inner/outer seam queues reduced to their 4 burst
    counters each. rows_g1 lays out ALL conv blocks first (B_conv of
    them), then per pair the inner and outer seam queues padded to B_MAX
    blocks (nb_seam [2F] i32 real lengths). With chained=True the pair-0
    carry is carry_w_dev/carry_ok_dev (the previous round's carry_next_*
    outputs) instead of the params' carry. tables: RoundTables on the
    pixels' device (built per call when not given).

    Returns (out i32 [N], words_flat [F*Ls, 8] CB-rewritten words,
    words_tail [Ls, 8], ok8_tail [Ls, 8], carry_next_w [112, 8],
    carry_next_ok [112, 8]) -- all but `out` stay on the device as the
    next round's inputs."""
    F, Ls, _ = pixels.shape
    device = pixels.device
    o, _n = round_param_layout(F)

    def cut(key, sz):
        return params[o[key]:o[key] + sz]

    coords = cut("coords", 2 * F).reshape(F, 2)
    refs = cut("refs", F)
    blacks = cut("blacks", F)
    whites = cut("whites", F)
    usable = cut("usable", F).to(torch.bool)
    if chained:
        # The pair-0 carry is the PREVIOUS round's device-computed
        # chain carry (carry_next_* outputs): nothing is uploaded.
        carry_w = carry_w_dev
        carry_ok = carry_ok_dev
    else:
        carry_w = cut("carry_w", MDD_ * 8).reshape(MDD_, 8)
        carry_ok = cut("carry_ok", MDD_ * 8).reshape(MDD_, 8).to(torch.bool)
    pred_mode = cut("pred_mode", 1)[0]
    unch_lim = cut("unch_lim", 1)[0]
    (words, crc_read, valid, dup, packed1, samples1, packed2,
     wflat, ok8) = _steady_round_core(
        pixels, coords, refs, blacks, whites, usable,
        prev_words, prev_ok8, carry_w, carry_ok, rows_g1, rows_g2,
        silent_w, en_p, en_q, m2, hyst_limit, shift_limit, use_kernel,
        tables=tables)
    # One i32 of per-line facts: the source CRC -- REWRITTEN for
    # Control-Block lines exactly as LineStore.from_decoded would (zero
    # the cue words, re-CRC; stc007line.cpp:101-129) -- plus
    # valid/dup/cb/crc-match bits.
    cb = valid & stc007.is_control_block(words)                # [F, Ls]
    cue = torch.arange(8, device=device) < 4
    words_rw = torch.where(cb[..., None] & cue, 0, words)
    crc_calc = stc007.calc_crc(words_rw).to(torch.int32)
    crc_out = torch.where(cb, crc_calc, crc_read)
    crcm = crc_calc == crc_out
    i32 = lambda m: m.to(torch.int32)
    meta = ((crc_out & 0xFFFF)
            | (i32(valid) << 16)
            | (i32(dup) << 17)
            | (i32(cb) << 18)
            | (i32(crcm) << 19)).reshape(-1)
    wflat_rw = words_rw.reshape(-1, 8)

    def use16_of(pk):
        """spec_use16's exact math over the dual-eval bad bits."""
        bad14 = (pk[:, 0] >> PACK_BAD_BIT) & 1
        bad16 = (pk[:, 1] >> PACK_BAD_BIT) & 1
        return ((pred_mode == di.RES_MODE_16BIT)
                | ((pred_mode == di.RES_MODE_16BIT_AUTO)
                   & ~((bad16 == 1) & (bad14 == 0)))
                | ((pred_mode == di.RES_MODE_14BIT_AUTO)
                   & (bad14 == 1) & (bad16 == 0)))

    # Conv queues: pack AND samples selected by the predicted resolution
    # mode; the chosen resolution is recorded at PACK_U16_BIT.
    pk_conv = packed1[:B_conv]
    u16c = use16_of(pk_conv).long()
    sel_c = torch.gather(pk_conv, 1, u16c[:, None])[:, 0]
    p1 = (sel_c | (u16c << PACK_U16_BIT)).to(torch.int32)
    # torch.gather does not broadcast the index's size-1 axes.
    cs_sel = torch.gather(samples1[:B_conv], 1,
                          u16c[:, None, None].expand(-1, 1, 6))[:, 0]
    # Sample pairs as one int32 each, low half first (the bitcast).
    cs = cs_sel.reshape(-1, 2).contiguous().view(torch.int32).reshape(-1)
    # Inner/outer seam queues: burst counters under the same predicted
    # mode (burst_stats_batch).
    pk_seam = packed1[B_conv:]                               # [2F*B_MAX, 2]
    u16s = use16_of(pk_seam).long()
    sel = torch.gather(pk_seam, 1, u16s[:, None])[:, 0]
    sflags = ((sel >> 16) & 0x3F).to(torch.uint8).reshape(-1, B_MAX)
    seam_stats = burst_stats_batch(
        sflags, nb_seam, unch_lim.expand(nb_seam.shape), en_q,
        MAX_BURST_SILENCE, MAX_BURST_BROKEN).reshape(-1)
    # Fresh-field resolution counts: the floored-decrement block counter
    # (getFieldResolution :1090-1140) as a cumsum/cummin scan, [F, 2
    # fields, 2 resolutions].
    n_res = Ls // 2 - MDD_
    if n_res > 0:
        flags2 = (packed2 >> 16).to(torch.int32)
        good = ((flags2 & 2) != 0) & ((flags2 & 4) != 0) \
            & ((flags2 & 8) == 0)
        broken = (flags2 & 1) != 0
        x = i32(good) - i32(~good & broken)
        x = x.reshape(F, 2, n_res, 2)
        cum = torch.cumsum(x, dim=2, dtype=torch.int32)
        mn = cum.amin(dim=2).clamp(max=0)
        counts = (cum[:, :, -1, :] - mn).reshape(-1)
    else:
        counts = torch.zeros(F * 4, dtype=torch.int32, device=device)
    out = torch.cat([meta, p1, cs, counts, seam_stats])
    # The NEXT round's chained pair-0 carry: the end-of-round conv tail
    # rows gathered over the CB-REWRITTEN buffer.
    no_ok = torch.zeros((1, 8), dtype=torch.bool, device=device)
    words_all_rw = torch.cat([prev_words, wflat_rw, carry_w,
                              silent_w[None, :]])
    ok_all = torch.cat([prev_ok8, ok8, carry_ok, no_ok])
    rows_next = di.clamp_rows(carry_next_rows.long(), words_all_rw.shape[0])
    carry_next_w = words_all_rw[rows_next]
    carry_next_ok = ok_all[rows_next]
    return (out, wflat_rw, wflat_rw[-Ls:], ok8[-Ls:],
            carry_next_w, carry_next_ok)


def unpack_round(buf, F, Ls, Bc):
    """Host-side split of steady_round_packed's output buffer.  Returns
    (crc_read [F,Ls] i32 (CB-rewritten), valid, dup, cb, crcm [F,Ls]
    bool, packed_conv [Bc] u32 (pred_mode-selected, chosen resolution
    at PACK_U16_BIT), samples_conv [Bc,6] i16 (pred_mode-selected),
    res_counts [F,2,2] i32 — per frame (odd, even) x (count14,
    count16), seam_stats [F,2,4] i32 — per pair (inner, outer) x
    (valid_max, silent_max, unch_max, broken)).  The word values do
    NOT cross: they stay in the round's resident words_flat array."""
    n_m = F * Ls
    pos = 0
    meta = buf[pos:pos + n_m].reshape(F, Ls)
    pos += n_m
    crc_read = meta & 0xFFFF
    valid = (meta & (1 << 16)) != 0
    dup = (meta & (1 << 17)) != 0
    cb = (meta & (1 << 18)) != 0
    crcm = (meta & (1 << 19)) != 0
    packed_conv = buf[pos:pos + Bc].view(np.uint32)
    pos += Bc
    samples_conv = buf[pos:pos + 3 * Bc].view(np.int16) \
        .reshape(Bc, 6)
    pos += 3 * Bc
    res_counts = buf[pos:pos + 4 * F].reshape(F, 2, 2)
    pos += 4 * F
    seam_stats = buf[pos:pos + 8 * F].reshape(F, 2, 4)
    return (crc_read, valid, dup, cb, crcm, packed_conv, samples_conv,
            res_counts, seam_stats)


def unpack_eval_host(sel):
    """Decode device-selected single-pack evals (steady_round_packed's
    conv section): sel [B] u32 with valid[0:8] | line_crc[8:16] |
    flags[16:22] | bad at 22 | chosen-res at PACK_U16_BIT.  Returns
    (flags u8 [B], valid [B,8] bool, lcrc [B,8] bool)."""
    flags = ((sel >> 16) & 0x3F).astype(np.uint8)
    bits = np.arange(8, dtype=np.uint32)
    valid = ((sel[:, None] >> bits) & 1).astype(bool)
    lcrc = ((sel[:, None] >> (8 + bits)) & 1).astype(bool)
    return flags, valid, lcrc


def select_dual_host(packed, mode, samples=None):
    """Host-side resolution-mode select over dual-eval outputs:
    packed [B, 2] u32, mode scalar int or [B].  Returns
    (flags u8 [B], valid [B,8] bool, lcrc [B,8] bool, samples [B,6])."""
    bad14 = (packed[:, 0] >> PACK_BAD_BIT) & 1
    bad16 = (packed[:, 1] >> PACK_BAD_BIT) & 1
    mode = np.broadcast_to(np.asarray(mode), (packed.shape[0],))
    use16 = ((mode == di.RES_MODE_16BIT)
             | ((mode == di.RES_MODE_16BIT_AUTO)
                & ~((bad16 == 1) & (bad14 == 0)))
             | ((mode == di.RES_MODE_14BIT_AUTO)
                & (bad14 == 1) & (bad16 == 0)))
    sel = packed[np.arange(packed.shape[0]), use16.astype(np.int64)]
    flags = ((sel >> 16) & 0x3F).astype(np.uint8)
    bits = np.arange(8, dtype=np.uint32)
    valid = ((sel[:, None] >> bits) & 1).astype(bool)
    lcrc = ((sel[:, None] >> (8 + bits)) & 1).astype(bool)
    out_samples = None
    if samples is not None:
        out_samples = samples[np.arange(samples.shape[0]),
                              use16.astype(np.int64)]
    return flags, valid, lcrc, out_samples
