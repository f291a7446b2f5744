"""Chip-resident STC-007 batch decoder: pixels live in device memory, one
fused round decodes a whole round of frames, samples/stats come back in KB.

Port of sdvpcmdecoder_tpu/pipeline/device_driver.py:

  stage:   each capture's frames are split to fields and uploaded to the
           explicit `device` ONCE per bounded chunk.
  round:   ops.device_stitch.steady_round_packed (through `run_round`) =
           binarize (the CUDA kernel K1 on a GPU) + duplicate detection +
           DUAL-resolution eval of every speculated seam/res/conv queue
           for all frame pairs of the round, in one call on resident
           data, replayed as one CUDA graph (ops/round_graph) where the
           JAX package calls its jitted round.  Its output buffer is
           copied back asynchronously (a non_blocking copy into pinned
           memory and a CUDA event) while other captures compute.
  replay:  the unchanged host stage machine (pipeline/stitcher_stc007)
           consumes the speculative results with seam_backend="tpu-spec"
           -- every geometry fact is verified, so output is bit-identical
           to the host backends or the pair falls back.

The JAX package's device plumbing maps as: device_put + block_until_ready
-> an upload to `device` and a recorded event that _await_staging waits
on; copy_to_host_async -> `HostCopy`; the jitted prescan gather ->
`px[:, idx, :]` with idx on the device; jnp.take -> index_select; the
round call -> `run_round` over `RoundState`, the state one round hands
the next.  The PCM-1/16x0 driver (pipeline/device_pcm) shares the
staging skeleton, StagedDeviceDecoder.

Reference scope: the full doFrameReassemble chain
(stc007datastitcher.cpp:7250) with findPadding/tryPadding seam scoring
(:1417/:1743) and performDeinterleave (:6675) on device.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..formats import stc007
from ..ops import device_stitch as ds
from ..ops.round_graph import RoundGraphs
from ..utils.host import HostCopy, host_call, upload
from . import batch_driver, ingest, v2d
from . import stitcher_stc007 as st

KEEP = ds.KEEP          # 120
MDD = stc007.MIN_DEINT_DATA


def _gather_sample(px, idx):
    return px[:, idx, :]


@functools.lru_cache(maxsize=None)
def _prescan_idx(prescan_rows, L, device):
    """prescan_rows(L) on `device`, uploaded once: an upload from pageable
    memory waits for the rounds in the device's queue."""
    return torch.as_tensor(prescan_rows(L), device=device)


class StagedDeviceDecoder(batch_driver.BatchDecoder):
    """Shared skeleton of the chip-resident drivers (STC-007, PCM-1/16x0):
    bounded-chunk device staging, the capture round-robin visit loop
    (complete pending round → restage at the chunk edge → dispatch the
    next round), and the rounds-never-straddle-a-chunk rounding of
    `hbm_frames`.  Subclasses provide _dispatch/_complete."""

    def _round_hbm_frames(self, frames_per_round, hbm_frames):
        self.hbm_frames = max(frames_per_round,
                              -(-hbm_frames // frames_per_round)
                              * frames_per_round)

    def _init_job_staging(self, j):
        # A checkpoint resume (batch_driver._try_resume, applied before
        # this runs) sets frames_read past 0: stage from there, not
        # from the capture start — otherwise a resume past the first
        # chunk would hit the EOF branch and truncate the WAV.
        j.chunk_base = int(getattr(j, "frames_read", 0) or 0)
        j.chunk_len = 0
        j.stage_next = j.chunk_base
        j.exhausted = False
        j.px_dev = None
        j.px_ready = None
        j.nums = None
        j.Ls = j.W = 0
        self._stage_chunk(j, block=False)

    def _await_staging(self):
        """Staging is part of setup, not decode: wait for the uploads so
        the first round's reads don't absorb the staging transfers
        (staging seconds are reported separately)."""
        for j in self.jobs:
            if j.px_ready is not None:
                j.px_ready.synchronize()

    def _stage_chunk(self, j, block=True):
        """Stage the next bounded chunk of frames on the device.  Returns
        False at EOF (j.exhausted set)."""
        with self._stage("stage_hbm"):
            batch = j.reader.read_frames(j.stage_next, self.hbm_frames)
            if batch.shape[0] == 0:
                j.exhausted = True
                return False
            lines_b, nums = ingest.split_fields_batch(batch)
            j.px_dev = torch.from_numpy(lines_b).to(self.device,
                                                    non_blocking=True)
            j.px_ready = None
            if self.device.type == "cuda":
                j.px_ready = torch.cuda.Event()
                j.px_ready.record(torch.cuda.current_stream(self.device))
            j.chunk_base = j.stage_next
            j.chunk_len = lines_b.shape[0]
            j.stage_next += j.chunk_len
            j.nums = nums
            j.Ls = lines_b.shape[1]
            j.W = lines_b.shape[2]
            if block and j.px_ready is not None:
                j.px_ready.synchronize()
        return True

    def run(self):
        while True:
            live = [j for j in self.jobs if not j.done]
            if not live:
                break
            for j in live:
                self._visit(j)
        return {j.path: j.stats for j in self.jobs}

    def _visit(self, j):
        if j.pending is not None:
            self._complete(j)
        if j.done:
            return
        while j.frames_read >= j.chunk_base + j.chunk_len \
                and not j.exhausted:
            self._stage_chunk(j)
        if j.frames_read >= j.chunk_base + j.chunk_len:
            if j.pending is None:
                self._stitch_and_write(j, [], finish=True)
                self._drain_final(j)
                j.done = True
            return
        self._dispatch(j)


class _RoundRows:
    """Row maps for one round geometry, put on `device` once.

    Layout of the combined words buffer (steady_round_dispatch):
    [prev frame (Ls rows) | round frames (F*Ls) | carry (112) | silent].
    """

    def __init__(self, F, lpf, n0, padI, padO, target, tff, *, device):
        Ls = 2 * lpf
        carry_ofs = (F + 1) * Ls
        sil = carry_ofs + MDD
        c1 = min(lpf, target)
        c2 = min(lpf, target)
        # n0 only shapes pair 0's carry rows; pairs >= 1 assume the
        # steady 112-row carry (verified per pair at replay).
        self.geom = (c1, c2, padI, padO, tff, target)
        self.lpf = lpf

        def fields(j):
            o = (j + 1) * Ls
            odd = np.arange(o, o + lpf, dtype=np.int64)
            even = np.arange(o + lpf, o + Ls, dtype=np.int64)
            return (odd, even) if tff else (even, odd)

        def blocks(queue):
            B = len(queue) - MDD
            pos = (np.arange(B, dtype=np.int64)[:, None]
                   + stc007.INTERLEAVE_OFS
                   * np.arange(8, dtype=np.int64)[None, :])
            return queue[pos]

        pad_i = np.full(padI, sil, np.int64)
        pad_o = np.full(padO, sil, np.int64)
        # g1 layout: ALL conv blocks first (their packed evals and
        # selected samples are read back), then the seam queues (inner,
        # outer per pair) padded to B_MAX blocks -- their burst stats are
        # reduced on the device, only [F, 2, 4] counters return.
        g_conv, g_seam, meta1, ofs = [], [], [], 0
        nb_seam = np.zeros(2 * F, np.int32)
        head = min(lpf, KEEP)
        len1 = min(lpf, KEEP - padI)
        len1o = min(lpf, KEEP - padO)

        def seam_blocks(queue):
            b = blocks(queue) if len(queue) > MDD \
                else np.zeros((0, 8), np.int64)
            full = np.full((ds.B_MAX, 8), sil, np.int64)
            full[:min(b.shape[0], ds.B_MAX)] = b[:ds.B_MAX]
            return full, b.shape[0]

        for i in range(F):
            f1, f2 = fields(i - 1)
            fb1 = fields(i)[0]
            inner = np.concatenate([f1[lpf - len1:], pad_i, f2[:head]])
            outer = np.concatenate([f2[lpf - len1o:], pad_o, fb1[:head]])
            bi, nbi = seam_blocks(inner)
            bo, nbo = seam_blocks(outer)
            g_seam += [bi, bo]
            nb_seam[2 * i], nb_seam[2 * i + 1] = nbi, nbo
            tail = np.concatenate([f1[:c1], pad_i, f2[:c2], pad_o])
            if i == 0:
                carry = np.arange(carry_ofs, carry_ofs + n0,
                                  dtype=np.int64)
            else:
                p1, p2 = fields(i - 2)
                prev_tail = np.concatenate(
                    [p1[:c1], pad_i, p2[:c2], pad_o])
                carry = prev_tail[-MDD:]
            conv = np.concatenate([carry, tail])
            b = blocks(conv)
            meta1.append({"conv": (ofs, b.shape[0]),
                          "inner_nb": nbi, "outer_nb": nbo})
            g_conv.append(b)
            ofs += b.shape[0]
        g1 = g_conv + g_seam
        self.nb_seam = torch.as_tensor(nb_seam, device=device)
        self.B_conv = ofs
        # The NEXT round's chained pair-0 carry rows: the carry formula
        # at "pair F" (fields(F-2); fields(-1) = this round's prev slot
        # when F == 1) -- lets steady chains skip the carry upload.
        np1, np2 = fields(F - 2) if F >= 2 else fields(-1)
        next_tail = np.concatenate([np1[:c1], pad_i, np2[:c2], pad_o])
        self.can_chain = len(next_tail) >= MDD
        self.carry_next_rows = torch.as_tensor(
            (next_tail[-MDD:] if self.can_chain
             else np.zeros(MDD, np.int64)).astype(np.int32), device=device)
        g2, meta2, ofs2 = [], [], 0
        for i in range(F):
            o = (i + 1) * Ls
            m = {}
            for key, lo in (("res_odd", 0), ("res_even", lpf)):
                if lpf > MDD:
                    q = np.arange(o + lo, o + lo + lpf, dtype=np.int64)
                    b = blocks(q)
                    m[key] = (ofs2, b.shape[0])
                    g2.append(b)
                    ofs2 += b.shape[0]
                else:
                    m[key] = (ofs2, 0)
            meta2.append(m)
        self.meta1, self.meta2 = meta1, meta2
        self.g1 = torch.as_tensor(np.concatenate(g1).astype(np.int32),
                                  device=device)
        # A round with lpf <= 112 has no resolution queue: a one-block
        # placeholder keeps the round's shapes non-empty.
        self.g2 = torch.as_tensor(
            np.concatenate(g2).astype(np.int32) if g2
            else np.zeros((1, 8), np.int32), device=device)
        # conv blocks lead the g1 layout, so the packed round's samples
        # section is just packed1[:B_conv]'s blocks in order.
        self.meta_conv = [m["conv"] for m in meta1]
        self.B1 = int(self.g1.shape[0])
        self.Bc = self.B_conv
        self.B2 = int(self.g2.shape[0])


class RoundState(NamedTuple):
    """What one round hands to the next, on the device: the last frame's
    words and line-ok flags (the next round's prev slot) and the chained
    pair-0 carry."""
    prev_words: torch.Tensor   # [Ls, 8] int32
    prev_ok8: torch.Tensor     # [Ls, 8] bool
    carry_w: torch.Tensor      # [112, 8] int32
    carry_ok: torch.Tensor     # [112, 8] bool

    @classmethod
    def from_numpy(cls, prev_words, prev_ok8, carry_w, carry_ok, device):
        """State from host arrays (a JAX round's inputs, or zeros for a
        capture's first round)."""
        return cls(*(torch.as_tensor(np.asarray(a, dt), device=device)
                     for a, dt in ((prev_words, np.int32),
                                   (prev_ok8, bool), (carry_w, np.int32),
                                   (carry_ok, bool))))

    @classmethod
    def zeros(cls, Ls, device):
        return cls.from_numpy(np.zeros((Ls, 8)), np.zeros((Ls, 8)),
                              np.zeros((MDD, 8)), np.zeros((MDD, 8)),
                              device)


# run_round's outputs that outlive a graph replay, cloned after it:
# words_flat (the lazy stores and the fallback read it rounds later) and
# the next round's state. `out` is copied to the host before the next
# replay.
KEPT_OUTPUTS = (1, 2, 3, 4, 5)


def run_round(pixels, params, state: RoundState, rows: _RoundRows, *,
              en_p, en_q, m2, hyst_limit, shift_limit, use_kernel,
              chained, tables, graphs=None):
    """One steady round on the pixels' device: params is the round's int32
    parameter vector (ds.round_param_layout; numpy or a tensor), tables a
    ds.RoundTables on that device, graphs a RoundGraphs that replays the
    round (None: run it eagerly). Returns (out [N] int32 buffer,
    words_flat [F*Ls, 8], the next round's RoundState); under `graphs`,
    `out` is the graph's buffer, which the next replay writes over."""
    def body(pixels, params, prev_words, prev_ok8, carry_w, carry_ok):
        return ds.steady_round_packed(
            pixels, params, prev_words, prev_ok8, carry_w, carry_ok,
            rows.carry_next_rows, rows.g1, rows.g2, rows.nb_seam,
            tables.silent(m2), B_conv=rows.B_conv, en_p=en_p, en_q=en_q,
            m2=m2, hyst_limit=hyst_limit, shift_limit=shift_limit,
            use_kernel=use_kernel, chained=chained, tables=tables)

    params = torch.as_tensor(params, dtype=torch.int32)
    if graphs is None:
        res = body(pixels, upload(params, pixels.device), *state)
    else:
        # jax.jit's static arguments, and the tables the body closes over.
        key = ("steady_round_packed", en_p, en_q, m2, hyst_limit,
               shift_limit, use_kernel, chained, id(rows), id(tables))
        res = graphs.run(key, body, (pixels, params, *state),
                         clone=KEPT_OUTPUTS)
    out, wflat, wtail, oktail, cn_w, cn_ok = res
    return out, wflat, RoundState(wtail, oktail, cn_w, cn_ok)


class DeviceBatchDecoder(StagedDeviceDecoder):
    """BatchDecoder with the decode chain resident on the device.

    STC-007 only.  Pixels are staged on `device` in bounded chunks of
    `hbm_frames` frames (capture length is unbounded; decode state
    crosses chunk boundaries through the device-resident prev/carry
    tensors, so no pixel halo is needed).  Host work per round: prescan
    medians, store assembly from the read-back facts, stage-machine
    replay, audio masking, WAV.

    `device` is required: there is no "cuda when available" default.
    `use_kernel` (default: True on a CUDA device) routes the round's
    binarize and the marker-fallback re-decode through the CUDA kernel
    K1 (ops/fused_binarize) instead of the plain torch grid. With
    `graphs` (the default) each round replays as a CUDA graph
    (`self.graphs`, an ops.round_graph.RoundGraphs; its CPU stand-in on
    the CPU), and so do the V2D drivers' finalize sweeps and marker
    re-decodes (`self.stream_graphs`, the thread's holder that the
    streaming drivers share); graphs=False runs both eagerly. The two
    holders keep two memory pools: a round's graph and a finalize graph
    never share memory, so neither replay can touch a buffer of the
    other's that is still to be read.
    """

    def __init__(self, jobs, lines_per_field=294, hyst_limit=2,
                 shift_limit=1, frames_per_round=16, use_kernel=None,
                 hbm_frames=256, *, device, graphs=True, **kw):
        from ..ops import stitch_native as _sn
        self.device = torch.device(device)
        if use_kernel is None:
            use_kernel = self.device.type == "cuda"
        # tpu-spec: steady pairs replay the round dispatch's device
        # results; transition pairs (a handful per capture) use the
        # bit-identical native tail.  Pure "tpu" (the device backend)
        # when the C core is switched off.
        super().__init__(jobs, lines_per_field=lines_per_field,
                         hyst_limit=hyst_limit, shift_limit=shift_limit,
                         frames_per_round=frames_per_round,
                         seam_backend="tpu-spec" if _sn.available()
                         else "tpu", device=self.device,
                         use_kernel=use_kernel, graphs=graphs, **kw)
        self.hyst_limit = hyst_limit
        self.shift_limit = shift_limit
        self._round_hbm_frames(frames_per_round, hbm_frames)
        self.use_kernel = use_kernel
        self.graphs = RoundGraphs(self.device) if graphs else None
        self.tables = ds.RoundTables().to(self.device)
        self._rows_cache = {}
        self._zero_carry = (
            torch.zeros((MDD, 8), dtype=torch.int32, device=self.device),
            torch.zeros((MDD, 8), dtype=torch.bool, device=self.device))
        for j in self.jobs:
            self._init_job_staging(j)
            Ls = j.Ls
            j.prev_words = torch.zeros((Ls, 8), dtype=torch.int32,
                                       device=self.device)
            j.prev_ok8 = torch.zeros((Ls, 8), dtype=torch.bool,
                                     device=self.device)
            j.carry_dev = None
            j.carry_key = None
            j.pending = None
            j.round_id = 0
            j.round_chained = []   # per dispatched round: chained or not
            j.next_sample = None
            j.next_sample_host = None
            if j.chunk_len:
                # Pre-gather round 0's prescan rows now; the async
                # copies complete while the other captures stage.
                F0 = min(frames_per_round, j.chunk_len)
                s0 = _gather_sample(j.px_dev[:F0], _prescan_idx(
                    v2d.prescan_rows, Ls, self.device))
                j.next_sample = (0, HostCopy(s0))
        self._await_staging()

    def _rows(self, F, lpf, n0, padI, padO, target, tff):
        key = (F, lpf, n0, padI, padO, target, tff)
        r = self._rows_cache.get(key)
        if r is None:
            r = self._rows_cache[key] = _RoundRows(
                F, lpf, n0, padI, padO, target, tff, device=self.device)
        return r

    # -- round pipeline (run/_visit inherited from StagedDeviceDecoder) -----
    def _predict_geometry(self, j, lpf):
        sti = j.stitcher
        f0 = sti.frasm_f0
        tff = not f0.is_order_bff()   # TFF unless settled BFF
        if f0.video_standard == st.VID_PAL:
            target = st.LINES_PF_PAL
        elif f0.video_standard == st.VID_NTSC:
            target = st.LINES_PF_NTSC
        else:
            target = lpf
        padI = int(f0.inner_padding) if f0.inner_padding_ok else 0
        padO = int(f0.outer_padding) if f0.outer_padding_ok else 0
        c1 = min(lpf, target)
        c2 = min(lpf, target)
        if not (0 <= padI and 0 <= padO
                and c1 + c2 + padI + padO == 2 * target
                and padI < KEEP and padO < KEEP):
            padI = padO = 0
            target = lpf
        n0 = len(sti.conv_queue)
        if n0 > MDD:
            n0 = 0
        return padI, padO, target, tff, n0

    def _predict_conv_mode(self, sti):
        """The conv resolution mode the steady replay will compute —
        fixed under M2/preset, else the settled majority resolution
        (res_mode_combine of two equal plain modes is that mode).  A
        wrong prediction only costs the speculation: the replay bails
        the pair (BS_SPEC) and the native tail decodes it."""
        from ..ops import deinterleave as di
        fixed = sti._fixed_res_mode()
        if fixed is not None:
            return fixed
        return (di.RES_MODE_16BIT
                if sti.get_probable_resolution() == st.SAMPLE_RES_16BIT
                else di.RES_MODE_14BIT)

    def _dispatch(self, j):
        with self._stage("dispatch"):
            chunk_end = j.chunk_base + j.chunk_len
            F = min(self.frames_per_round, chunk_end - j.frames_read)
            Ls, W = j.Ls, j.W
            lpf = Ls // 2
            lo = j.frames_read - j.chunk_base
            px = j.px_dev[lo:lo + F]
            idx = _prescan_idx(v2d.prescan_rows, Ls, self.device)
            with self._stage("prescan"):
                if not j.driver.search_needed():
                    # Good-params skip: no sample gather, no read-back,
                    # no host AGC/marker/sweep this round.
                    prep = j.driver.prepare_frames(None,
                                                   shape=(F, Ls, W))
                else:
                    if j.next_sample_host is not None \
                            and j.next_sample_host[0] == j.frames_read:
                        sample = j.next_sample_host[1]
                    elif j.next_sample is not None \
                            and j.next_sample[0] == j.frames_read:
                        sample = j.next_sample[1].numpy()
                    else:
                        sample = _gather_sample(px, idx).cpu().numpy()
                    sample = sample.reshape(F * len(idx), W)
                    prep = j.driver.prepare_frames(None, sample=sample,
                                                   shape=(F, Ls, W))
            sti = j.stitcher
            padI, padO, target, tff, n0 = self._predict_geometry(j, lpf)
            rows = self._rows(F, lpf, n0, padI, padO, target, tff)
            conv = sti.conv_queue
            # Steady chain: the previous round ended on the steady path
            # with this exact geometry, so the device's own carry_next
            # output IS the live conv content — skip the carry upload
            # AND the host-side conv word materialization (the words
            # never leave the device).  Verified at replay via carry_n =
            # -1 (_spec_round_meta / _match_spec_entry chain rule).
            chained = (n0 == MDD and rows.can_chain
                       and j.carry_dev is not None
                       and j.carry_key == (lpf, rows.geom)
                       and getattr(sti, "_steady_chain", None)
                       == (j.frame_no, lpf, rows.geom))
            carry_w = np.zeros((MDD, 8), np.int32)
            carry_ok = np.zeros((MDD, 8), bool)
            if n0 and not chained:
                carry_w[:n0] = conv.words_i32()
                carry_ok[:n0] = conv.crc_ok8()
            layout, n_par = ds.round_param_layout(F)
            params = np.empty(n_par, np.int32)

            def put(key, arr):
                a = np.asarray(arr).ravel()
                params[layout[key]:layout[key] + a.size] = a

            put("coords", prep["coords"])
            put("refs", np.maximum(prep["refs"], 1))
            put("blacks", np.clip(prep["blacks"], 0, 254))
            put("whites", np.clip(prep["whites"], 1, 255))
            put("usable", prep["usable"])
            put("carry_w", carry_w)
            put("carry_ok", carry_ok)
            pred_mode = self._predict_conv_mode(sti)
            put("pred_mode", pred_mode)
            unch_lim = sti.max_unch_14 if sti.en_q else sti.max_unch_16
            put("unch_lim", unch_lim)
            # Frames whose stores the host WILL read words from — the
            # settle-in pairs' head frames (full stage machine, round 0)
            # and the capture's finish tail — get their word rows
            # prefetched asynchronously; a synchronous lazy fetch later
            # pays a full round trip per store.
            n_total = getattr(j.reader, "n_frames", None)
            chunk_final = (j.frames_read + F >= chunk_end
                           and (j.exhausted
                                or j.chunk_len < self.hbm_frames
                                # exact-multiple captures: EOF hasn't
                                # been read yet but the frame count
                                # says this chunk is the last one
                                or (n_total is not None
                                    and j.stage_next >= n_total)))
            n_head = min(6, F) if j.round_id == 0 else 0
            n_tail = min(2, F) if chunk_final else 0
            cd_w, cd_ok = j.carry_dev if j.carry_dev is not None \
                else self._zero_carry
            out, wflat, nxt_state = run_round(
                px, params, RoundState(j.prev_words, j.prev_ok8, cd_w,
                                       cd_ok), rows,
                en_p=sti.en_p, en_q=sti.en_q, m2=sti.mode_m2,
                hyst_limit=self.hyst_limit, shift_limit=self.shift_limit,
                use_kernel=self.use_kernel, chained=chained,
                tables=self.tables, graphs=self.graphs)
            out = HostCopy(out)   # before any other round replays
            prefetch = []
            if n_head:
                prefetch.append((0, n_head, HostCopy(wflat[:n_head * Ls])))
            if n_tail:
                prefetch.append((F - n_tail, F, HostCopy(
                    wflat[(F - n_tail) * Ls:F * Ls])))
            j.prev_words = nxt_state.prev_words
            j.prev_ok8 = nxt_state.prev_ok8
            j.carry_dev = (nxt_state.carry_w, nxt_state.carry_ok)
            j.carry_key = (lpf, rows.geom)
            j.round_chained.append(bool(chained))
            j.pending = dict(F=F, px=px, prep=prep,
                             out=out, wflat=wflat, rows=rows,
                             round_id=j.round_id, prefetch=prefetch,
                             carry_w=carry_w, carry_ok=carry_ok,
                             n0=-1 if chained else n0,
                             pred_mode=pred_mode)
            j.round_id += 1
            j.frames_read += F
            nxt = j.frames_read
            d = j.driver
            search_next = (d.search_needed()
                           or d._frames_prepared + self.frames_per_round
                           >= d._next_search)
            # Prefetch stops at the staging chunk's edge — the next
            # chunk isn't resident yet; its round gathers at dispatch.
            if nxt < chunk_end and search_next:
                F2 = min(self.frames_per_round, chunk_end - nxt)
                px2 = j.px_dev[nxt - j.chunk_base:nxt - j.chunk_base + F2]
                j.next_sample = (nxt, HostCopy(_gather_sample(px2, idx)))
            else:
                j.next_sample = None

    def _build_stores_device(self, j, F, Ls, usable, fb_res, crc_read,
                             valid, dup, cb, crcm, wflat, prep,
                             w_pre=None):
        """_build_stores_stc007 for the packed round: steady frames
        become LAZY stores (from_decoded_spec over the resident words;
        nothing is copied back unless a fallback materializes),
        fallback/unusable frames take the eager paths.  Frames in
        `w_pre` ({frame -> prefetched [Ls, 8] host words}) come out
        eager — the settle-in/finish frames the stage machine reads."""
        stores = []
        w_pre = w_pre or {}
        nums64 = np.asarray(j.nums, np.int64)
        for f in range(F):
            j.frame_no += 1
            if not usable[f]:
                j.stats.frames_no_pcm += 1
                store = st.LineStore(Ls)
                store.frame_number[:] = j.frame_no
                store.line_number = nums64.copy()
                j.stats.lines_total += Ls
            elif f in fb_res:
                res = fb_res[f]
                store = st.LineStore.from_decoded(
                    res.words, res.crc_read, res.valid,
                    np.full(Ls, j.frame_no), j.nums,
                    ref_level=np.full(Ls, res.ref_level),
                    forced_bad=res.forced_bad)
                j.stats.lines_total += Ls
                j.stats.lines_valid += int(res.valid.sum())
                j.stats.lines_dup += int(res.duplicates.sum())
            else:
                a = f * Ls
                store = st.LineStore.from_decoded_spec(
                    (lambda dev=wflat, a=a, b=a + Ls:
                     dev[a:b].cpu().numpy()),
                    crc_read[f], valid[f], cb[f], crcm[f],
                    np.full(Ls, j.frame_no), j.nums,
                    ref_level=np.full(Ls, int(prep["refs"][f])),
                    forced_bad=dup[f])
                if f in w_pre:
                    store.words = w_pre[f]
                j.stats.lines_total += Ls
                j.stats.lines_valid += int(valid[f].sum())
                j.stats.lines_dup += int(dup[f].sum())
            if j.first:
                tag = st.LineStore(1)
                tag.service[0] = st.SRV_NEW_FILE
                tag.frame_number[0] = j.frame_no
                # Prime the 1-row CRC cache so the concat's composed
                # _crcv survives — else the first frame's lazy store
                # materializes just to re-CRC the tag row.
                tag._crcv = tag.calc_crc() == tag.source_crc
                store = st.LineStore.concat([tag, store])
                j.first = False
            stores.append(store)
        return stores

    def _complete(self, j):
        p = j.pending
        j.pending = None
        with self._stage("materialize"):
            rows_ = p["rows"]
            (crc_read, valid, dup, cb, crcm, packed1, samples_conv,
             res_counts, seam_stats) = ds.unpack_round(
                p["out"].numpy(), p["F"], j.Ls, rows_.Bc)
            # Read the next round's prescan sample HERE: its copy was
            # requested a full cycle ago (right after this round's
            # outputs), so it is local by now.
            if j.next_sample is not None:
                j.next_sample_host = (j.next_sample[0],
                                      j.next_sample[1].numpy())
                j.next_sample = None
        F, Ls = p["F"], j.Ls
        wflat = p["wflat"]   # resident [F*Ls, 8] i32, CB-rewritten
        prep, usable = p["prep"], p["prep"]["usable"]
        j.driver.note_feedback(bool((~valid[usable]).any())
                               if usable.any() else True)
        with self._stage("finalize"):
            # INSANE quality (full ref-level sweep): every usable frame
            # takes the host finalize path, whose _ref_sweep_merge runs
            # the sweep grid on the device — --quality insane composes
            # with the chip-resident driver instead of excluding it
            # (sweepRefLevel scope, binarizer.cpp:3551).
            insane = getattr(j.driver, "ref_sweep", False)
            fb_frames = [f for f in range(F)
                         if usable[f]
                         and (insane or 0 < int((~valid[f]).sum()) < Ls)]
            fb_res = {}
            if fb_frames:
                # Some lines failed: fetch those frames' pixels AND
                # words, and run the host finalize path (marker fallback
                # + dup rebuild) exactly as the streaming driver would.
                sel = torch.as_tensor(fb_frames, device=self.device)
                px_host = p["px"].index_select(0, sel).cpu().numpy()
                w_fb = wflat.reshape(F, Ls, 8).index_select(0, sel) \
                    .cpu().numpy().astype(np.int64)
                crc_fb = crc_read[fb_frames].astype(np.int64)
                cb_fb = cb[fb_frames]
                if cb_fb.any():
                    # The resident words are CB-rewritten; the finalize
                    # path (and from_decoded after it) expects the RAW
                    # read.  Exact reconstruction: the cue words are
                    # format constants and the raw source CRC of a
                    # valid line is its calc CRC.
                    w_fb[cb_fb, 0] = stc007.CB_CUE1
                    w_fb[cb_fb, 1] = stc007.CB_CUE2
                    w_fb[cb_fb, 2] = stc007.CB_CUE1
                    w_fb[cb_fb, 3] = stc007.CB_CUE2
                    crc_fb[cb_fb] = host_call(stc007.calc_crc, w_fb[cb_fb],
                                              out_dtype=np.int64)
                sub_prep = {k: prep[k][np.asarray(fb_frames)]
                            for k in ("coords", "refs", "blacks",
                                      "whites", "usable")}
                v_fb = valid[fb_frames]
                forced = np.zeros((len(fb_frames), Ls), bool)
                if insane:
                    w_fb, crc_fb, v_fb, forced = j.driver._ref_sweep_merge(
                        px_host, sub_prep["coords"], sub_prep["blacks"],
                        sub_prep["whites"], w_fb, crc_fb, v_fb)
                sub = j.driver.finalize_frames(
                    px_host, sub_prep, w_fb, crc_fb, v_fb, forced)
                fb_res = dict(zip(fb_frames, sub))
        with self._stage("assemble"):
            fno_before = j.frame_no
            w_pre = {}
            for a, b, arr in p.get("prefetch", ()):
                # Copied at dispatch: this reads local data.
                host = arr.numpy().astype(np.int64)
                for f in range(a, b):
                    w_pre[f] = host[(f - a) * Ls:(f - a + 1) * Ls]
            stores = self._build_stores_device(
                j, F, Ls, usable, fb_res, crc_read, valid, dup, cb,
                crcm, wflat, prep, w_pre=w_pre)
            for k, store in enumerate(stores):
                if len(store) == Ls and usable[k] and k not in fb_res:
                    store._dev_gid = fno_before + 1 + k
            spec = {}
            rows = p["rows"]
            for i in range(F):
                m1 = rows.meta1[i]
                oc, nc = m1["conv"]
                spec[(fno_before + i, fno_before + 1 + i)] = dict(
                    round_id=p["round_id"], pair_idx=i, lpf=rows.lpf,
                    geom=rows.geom, pred_mode=p["pred_mode"],
                    carry_n=p["n0"], carry_w=p["carry_w"],
                    carry_ok=p["carry_ok"],
                    seam_stats=seam_stats[i],
                    seam_nb=(m1["inner_nb"], m1["outer_nb"]),
                    conv=packed1[oc:oc + nc],
                    conv_samples=samples_conv[oc:oc + nc],
                    res_counts=res_counts[i])
            j.stitcher._steady_spec = spec
            # Round context for the C-side spec replay (ONE
            # stc007_spec_round call per round instead of per-pair
            # Python replays; stitcher_stc007._try_steady_run).
            j.stitcher._steady_round_ctx = dict(
                pairs={k: i for i, k in enumerate(spec)},
                meta1=rows.meta1, meta_conv=rows.meta_conv,
                packed1=packed1, samples_conv=samples_conv,
                res_counts=res_counts, seam_stats=seam_stats,
                geom=rows.geom, lpf=rows.lpf,
                pred_mode=p["pred_mode"],
                carry_n=p["n0"], carry_w=p["carry_w"],
                carry_ok=p["carry_ok"])
        self._stitch_and_write(j, stores)
