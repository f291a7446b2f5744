"""Chip-resident STC-007 batch decoder: pixels live in device memory, one
fused round decodes a whole round of frames, samples/stats come back in KB.

Port of sdvpcmdecoder_tpu/pipeline/device_driver.py:

  stage:   each capture's frames are uploaded to the explicit `device`
           ONCE per bounded chunk and split to fields there.
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
round skeleton, StagedDeviceDecoder; chip_resident_decoder picks the
driver by format.

Reference scope: the full doFrameReassemble chain
(stc007datastitcher.cpp:7250) with findPadding/tryPadding seam scoring
(:1417/:1743) and performDeinterleave (:6675) on device.
"""
from __future__ import annotations

import functools
import inspect
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple

import numpy as np
import torch

from ..formats import stc007
from ..ops import device_stitch as ds
from ..ops.round_graph import RoundGraphs, call
from ..utils.host import HostCopy, StagingBuffer, host_call
from ..utils.trace import Tracer
from . import batch_driver, ingest, v2d
from . import stitcher_stc007 as st

KEEP = ds.KEEP          # 120
MDD = stc007.MIN_DEINT_DATA


def _gather_sample(px, idx):
    return px[:, idx, :]


def _fetch_words(trace, wflat, a, b):
    """A lazy store's words, rows a:b of the resident round words: a
    `wait` span of the decoder's tracer. The stores hold the tracer, not
    the decoder, so they keep no decoder alive."""
    with trace.span("wait"):
        return wflat[a:b].cpu().numpy()


@functools.lru_cache(maxsize=None)
def _rows_on(prescan_rows, L, device):
    """prescan_rows(L) on `device`, uploaded once: an upload from pageable
    memory waits for the rounds in the device's queue."""
    return torch.as_tensor(prescan_rows(L), device=device)


@functools.lru_cache(maxsize=None)
def _field_rows(H, device):
    """ingest.field_perm(H): the rows on `device` (uploaded once, as
    _rows_on) and the line numbers, read-only as every chunk of
    every job shares them."""
    perm, nums = ingest.field_perm(H)
    nums.flags.writeable = False
    return torch.as_tensor(perm, device=device), nums


def _split_fields(raw):
    """ingest.split_fields_batch on the device: raw frames [F, H, W]
    uint8 -> (lines [F, H, W'] on raw's device, line numbers [H]), the
    same bytes in one gather.  A narrow frame's pixels repeat along the
    width (W' = 2W) through a broadcast view, so the upload carries
    half the bytes."""
    F, H, W = raw.shape
    rep = 2 if W < ingest.MIN_WIDTH_FOR_SINGLE else 1
    rows, nums = _field_rows(H, raw.device)
    lines = raw.unsqueeze(3).expand(F, H, W, rep).index_select(1, rows)
    return lines.view(F, H, W * rep), nums


def _read_after(event, trace, reader, first, out, read_into):
    """A read ahead, on a read pool thread: wait for the staging buffer's
    last upload (`event`; None where none is pending), then, under the
    `stage_readahead` span of `trace`, the reader's frames from `first`,
    as many as `out` holds (fewer at the end), in `out`
    (read_frames(..., out=) where `read_into`, else read, then copied):
    out's first frames."""
    if event is not None:
        event.synchronize()
    with trace.span("stage_readahead"):
        if read_into:
            return reader.read_frames(first, len(out), out=out)
        batch = reader.read_frames(first, len(out))
        out = out[:len(batch)]
        np.copyto(out, batch)
        return out


class StagedDeviceDecoder(batch_driver.BatchDecoder):
    """Shared skeleton of the chip-resident drivers (STC-007, PCM-1/16x0):
    the constructor, bounded-chunk device staging, the capture
    round-robin visit loop (complete pending round → restage at the
    chunk edge → dispatch the next round), the rounds-never-straddle-a-
    chunk rounding of `hbm_frames`, the prescan sample a round ahead, the
    round's parameter vector, its read-back and the fetch of frames to
    finalize on the host.  Subclasses name `prescan_rows` and
    `round_param_layout`, provide _dispatch/_complete, and may add to the
    device state (_init_device_state, _init_job_round).

    The constructor runs under a `construct` span, with parts `open`
    (BatchDecoder's readers, drivers and stitchers), `setup` (the device
    state), the first chunks' `stage_hbm` and the `wait` for them; every
    place the host blocks on the card is a `wait` span (`_wait`).

    Each job reads its next chunk ahead on a thread of the decoder's
    read pool (`_read_ahead`, at most one read a job in flight) while the
    chunk staged before it decodes; the constructor starts every job's
    first read at once. A read's error comes out at its job's next chunk
    edge. The threads have stopped when `run` returns; when it raises,
    each ends with its read (`_stop_reads`)."""

    prescan_rows = None         # L -> the prescan rows of an L-line frame
    round_param_layout = None   # F -> (offsets by key, length)

    def __init__(self, jobs, hyst_limit, shift_limit, frames_per_round,
                 hbm_frames, *, device, graphs, **kw):
        self.trace = Tracer()
        with self.trace.span("construct"):
            self.device = torch.device(device)
            with self.trace.span("open"):
                super().__init__(jobs, hyst_limit=hyst_limit,
                                 shift_limit=shift_limit,
                                 frames_per_round=frames_per_round,
                                 device=self.device, graphs=graphs, **kw)
            with self.trace.span("setup"):
                self.hyst_limit = hyst_limit
                self.shift_limit = shift_limit
                self._round_hbm_frames(frames_per_round, hbm_frames)
                self.graphs = RoundGraphs(self.device) if graphs else None
                self._init_device_state()
                # The reads ahead, a thread a job at most: a read holds
                # no GIL (it waits on the card or copies in C).
                self._reads = ThreadPoolExecutor(max(1, len(self.jobs)))
            try:
                # Every job's first read starts before any job stages.
                for j in self.jobs:
                    self._init_job_staging(j)
                for j in self.jobs:
                    self._stage_chunk(j, block=False)
                    with self.trace.span("setup"):
                        j.pending = None
                        j.next_sample = j.next_sample_host = None
                        self._init_job_round(j)
                        if j.chunk_len:
                            # Round 0's prescan rows: the copies complete
                            # while the other captures stage.
                            self._prefetch_sample(j, j.chunk_base)
                self._await_staging()
            except BaseException:
                self._stop_reads(wait=False)
                raise

    def _init_device_state(self):
        """The driver's state for every job, under `setup`."""

    def _init_job_round(self, j):
        """The driver's state for job `j`, under `setup`."""

    def _wait(self):
        """A span where the host waits for the card."""
        return self.trace.span("wait")

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
        j.stage_read = None
        self._take_stage_buffer(j)
        self._read_ahead(j)

    def _read_ahead(self, j):
        """Start the read of the job's next chunk (from j.stage_next) into
        its staging buffer on the read pool, as j.stage_read. The buffer's
        event goes with the read: the thread waits for the buffer's last
        upload, then reads under a `stage_readahead` span. With no buffer
        (a job with no frame to read) nothing starts."""
        buf = j.stage_buf
        if buf is None:
            return
        event, buf.event = buf.event, None
        j.stage_read = self._reads.submit(
            _read_after, event, self.trace, j.reader, j.stage_next,
            buf.array(j.stage_shape), j.read_into)

    def _stop_reads(self, wait=True):
        """Stop the read pool and drop every job's read. With `wait` the
        reads in flight end first and the threads have stopped; without
        (on an error) they are left to end on their own, so a read that
        blocks on a stalled stream does not hold the error back."""
        self._reads.shutdown(wait=wait, cancel_futures=True)
        for j in self.jobs:
            j.stage_read = None

    def _take_stage_buffer(self, j):
        """The job's staging buffer (utils/host.StagingBuffer): one chunk
        of frames, or what is left of a shorter capture. It goes when the
        job is done, and its pinned block to the next buffer."""
        rd = j.reader
        n = getattr(rd, "n_frames", None)
        frames = self.hbm_frames if n is None \
            else min(self.hbm_frames, n - j.chunk_base)
        j.stage_shape = (frames, rd.height, rd.width)
        j.read_into = "out" in inspect.signature(rd.read_frames).parameters
        j.stage_buf = None
        if frames <= 0:
            return
        j.stage_buf = StagingBuffer(frames * rd.height * rd.width,
                                    self.device)
        if j.stage_buf.new:
            self.trace.count("count_stage_pin_allocs")

    def _await_staging(self):
        """Staging is part of setup, not decode: wait for the uploads so
        the first round's reads don't absorb the staging transfers
        (staging seconds are reported separately)."""
        with self._wait():
            for j in self.jobs:
                if j.px_ready is not None:
                    j.px_ready.synchronize()

    def _stage_chunk(self, j, block=True):
        """Stage the next bounded chunk of frames on the device: take
        them in the job's staging buffer (its read ahead), upload them,
        split them into fields there (`_split_fields`), then start the
        next chunk's read (`_read_ahead`).  Returns False at EOF
        (j.exhausted set).  On CUDA the buffer is pinned: the upload
        does not wait for the rounds queued before it, and the read
        waits for the buffer's last upload, a chunk back.  `stage_read`
        is the host's wait for the read ahead's frames;
        `count_stage_readahead_chunks` counts the chunks whose read had
        ended when the host asked.  With `block` the host then waits for
        the split, and so for every round queued before it (a `wait`
        span)."""
        buf = j.stage_buf
        with self._stage("stage_hbm"):
            read, j.stage_read = j.stage_read, None
            if read is None:       # the job started with no frame to read
                j.exhausted = True
                return False
            with self.trace.span("stage_read"):
                ahead = read.done()
                batch = read.result()
            if batch.shape[0] == 0:
                j.exhausted = True
                return False
            if ahead:
                self.trace.count("count_stage_readahead_chunks")
            # Every round of the previous chunk is queued: drop it, so the
            # raw upload can take its block (the allocator orders reuse
            # on the stream) and staging needs no more device memory
            # than a host split did.
            j.px_dev = None
            with self.trace.span("stage_upload"):
                raw = buf.upload(batch.shape)
            self.trace.count("count_stage_chunks")
            if buf.pinned:
                self.trace.count("count_stage_pinned_chunks")
            with self.trace.span("stage_split"):
                j.px_dev, j.nums = _split_fields(raw)
                j.px_ready = None
                if self.device.type == "cuda":
                    j.px_ready = torch.cuda.Event()
                    j.px_ready.record(
                        torch.cuda.current_stream(self.device))
            j.chunk_base = j.stage_next
            j.chunk_len, j.Ls, j.W = j.px_dev.shape
            j.stage_next += j.chunk_len
            self._read_ahead(j)
            if block and j.px_ready is not None:
                with self._wait():
                    j.px_ready.synchronize()
        return True

    def _prescan_idx(self, j):
        return _rows_on(self.prescan_rows, j.Ls, self.device)

    def _prefetch_sample(self, j, start):
        """Gather the prescan rows of the round from frame `start` and
        start their copy to the host (j.next_sample), which _materialize
        takes a round later. Stops at the staging chunk's edge: the next
        chunk is not resident yet, and its round gathers at dispatch."""
        F = min(self.frames_per_round, j.chunk_base + j.chunk_len - start)
        if F <= 0:
            j.next_sample = None
            return
        lo = start - j.chunk_base
        j.next_sample = (start, HostCopy(_gather_sample(
            j.px_dev[lo:lo + F], self._prescan_idx(j))))

    def _take_sample(self, j, px):
        """The prescan rows [F * rows, W] of the round of pixels `px`
        from j.frames_read, on the host: as _materialize took them, from
        their copy in flight (round 0), or gathered now."""
        if j.next_sample_host is not None \
                and j.next_sample_host[0] == j.frames_read:
            sample = j.next_sample_host[1]
        elif j.next_sample is not None \
                and j.next_sample[0] == j.frames_read:
            with self._wait():
                sample = j.next_sample[1].numpy()
        else:
            with self._wait():
                sample = _gather_sample(
                    px, self._prescan_idx(j)).cpu().numpy()
        return sample.reshape(-1, j.W)

    def _round_params(self, F, prep, **extra):
        """The round's int32 parameter vector (round_param_layout(F)):
        the prescan's coordinates and levels, clipped to what the round
        reads, then the driver's `extra` keys."""
        layout, n_par = self.round_param_layout(F)
        params = np.empty(n_par, np.int32)
        for key, arr in (("coords", prep["coords"]),
                         ("refs", np.maximum(prep["refs"], 1)),
                         ("blacks", np.clip(prep["blacks"], 0, 254)),
                         ("whites", np.clip(prep["whites"], 1, 255)),
                         ("usable", prep["usable"]), *extra.items()):
            a = np.asarray(arr).ravel()
            params[layout[key]:layout[key] + a.size] = a
        return params

    def _materialize(self, j, out, unpack, *args):
        """unpack(the round's buffer on the host, *args), under
        `materialize`: the host waits for the buffer's copy. Then the
        next round's prescan rows come to the host (j.next_sample_host):
        their copy was asked for a full cycle ago, right after this
        round's, so it is local by now."""
        with self._stage("materialize"):
            with self._wait():
                host = out.numpy()
            res = unpack(host, *args)
            if j.next_sample is not None:
                with self._wait():
                    sample = j.next_sample[1].numpy()
                j.next_sample_host = (j.next_sample[0], sample)
                j.next_sample = None
        return res

    def _fetch_frames(self, frames, *tensors):
        """Rows `frames` of each tensor (the round's pixels, words) on
        the host: one index_select each, and the host waits once."""
        sel = torch.as_tensor(frames, device=self.device)
        with self._wait():
            return [t.index_select(0, sel).cpu().numpy() for t in tensors]

    def run(self):
        try:
            while True:
                live = [j for j in self.jobs if not j.done]
                if not live:
                    break
                for j in live:
                    self._visit(j)
        except BaseException:
            self._stop_reads(wait=False)
            raise
        self._stop_reads()
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
                j.stage_buf = None    # no read in flight holds it now
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

    # jax.jit's static arguments, and the tables the body closes over.
    key = ("steady_round_packed", en_p, en_q, m2, hyst_limit, shift_limit,
           use_kernel, chained, id(rows), id(tables))
    out, wflat, wtail, oktail, cn_w, cn_ok = call(
        graphs, key, body,
        (pixels, torch.as_tensor(params, dtype=torch.int32), *state),
        pixels.device, clone=KEPT_OUTPUTS)
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

    prescan_rows = staticmethod(v2d.prescan_rows)
    round_param_layout = staticmethod(ds.round_param_layout)

    def __init__(self, jobs, lines_per_field=294, hyst_limit=2,
                 shift_limit=1, frames_per_round=16, use_kernel=None,
                 hbm_frames=256, *, device, graphs=True, **kw):
        from ..ops import stitch_native as _sn
        if use_kernel is None:
            use_kernel = torch.device(device).type == "cuda"
        self.use_kernel = use_kernel
        # tpu-spec: steady pairs replay the round dispatch's device
        # results; transition pairs (a handful per capture) use the
        # bit-identical native tail.  Pure "tpu" (the device backend)
        # when the C core is switched off.
        super().__init__(jobs, hyst_limit, shift_limit, frames_per_round,
                         hbm_frames, device=device, graphs=graphs,
                         lines_per_field=lines_per_field,
                         seam_backend="tpu-spec" if _sn.available()
                         else "tpu", use_kernel=use_kernel, **kw)

    def _init_device_state(self):
        self.tables = ds.RoundTables().to(self.device)
        self._rows_cache = {}
        self._zero_carry = (
            torch.zeros((MDD, 8), dtype=torch.int32, device=self.device),
            torch.zeros((MDD, 8), dtype=torch.bool, device=self.device))

    def _init_job_round(self, j):
        Ls = j.Ls
        j.prev_words = torch.zeros((Ls, 8), dtype=torch.int32,
                                   device=self.device)
        j.prev_ok8 = torch.zeros((Ls, 8), dtype=torch.bool,
                                 device=self.device)
        j.carry_dev = None
        j.carry_key = None
        j.round_id = 0
        j.round_chained = []   # per dispatched round: chained or not

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
            with self._stage("prescan"):
                # Good-params skip: no sample gather, no read-back, no
                # host AGC/marker/sweep this round.
                sample = self._take_sample(j, px) \
                    if j.driver.search_needed() else None
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
            pred_mode = self._predict_conv_mode(sti)
            params = self._round_params(
                F, prep, carry_w=carry_w, carry_ok=carry_ok,
                pred_mode=pred_mode,
                unch_lim=sti.max_unch_14 if sti.en_q else sti.max_unch_16)
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
            d = j.driver
            if (d.search_needed()
                    or d._frames_prepared + self.frames_per_round
                    >= d._next_search):
                self._prefetch_sample(j, j.frames_read)
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
                    functools.partial(_fetch_words, self.trace, wflat, a,
                                      a + Ls),
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
        F, Ls = p["F"], j.Ls
        (crc_read, valid, dup, cb, crcm, packed1, samples_conv, res_counts,
         seam_stats) = self._materialize(j, p["out"], ds.unpack_round, F,
                                         Ls, p["rows"].Bc)
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
                px_host, w_fb = self._fetch_frames(
                    fb_frames, p["px"], wflat.reshape(F, Ls, 8))
                w_fb = w_fb.astype(np.int64)
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
                with self._wait():
                    host = arr.numpy()
                host = host.astype(np.int64)
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


def chip_resident_decoder(jobs, fmt, **kw):
    """The chip-resident driver of format `fmt`: DeviceBatchDecoder for
    "stc007", DevicePCMBatchDecoder for "pcm1", "pcm16x0" and "pcm1630"
    (it refuses any other format)."""
    if fmt == "stc007":
        return DeviceBatchDecoder(jobs, **kw)
    from .device_pcm import DevicePCMBatchDecoder
    return DevicePCMBatchDecoder(jobs, fmt, **kw)
