"""Multi-capture batch driver: N concurrent tapes through one chip.

BASELINE config 5: "Batched multi-tape pipeline: 8 concurrent
dropout-heavy captures, auto format/level search, streaming WAV out."

Design: the device decodes interleaved frame batches from all captures
(one dispatch covers every capture's next frame chunk — the device never
idles while hosts stitch); each capture owns its stitcher + audio chain +
WAV writer, run on a thread pool since the host stitcher is the per-core
bottleneck.

Backends: "tpu" (the JAX package's name, kept) ships pixel batches to the
driver's `device` for the all-trials grid decode; "native" decodes in
place on the host with the bit-identical early-exit C++ grid, touching
pixels straight off the capture mmap (no copies, no transfers).  "auto"
is "tpu" on a CUDA device; for device="cpu" it picks native when the C++
core is available (the JAX package's rule).  Level sweeps run on the
device under every backend (V2DDriver.ref_sweep uses it either way).
Per-stage wall time is accumulated in `stage_t`.

Port of sdvpcmdecoder_tpu/pipeline/batch_driver.py: STC-007 (M2
through mode_m2), PCM-1, PCM-16x0 (SI, EI as "pcm1630") and fmt="auto".
The driver's `device` and `use_kernel` reach the V2D driver and the
stitcher's device backend; PCM-1/16x0 jobs run the host round loop and
their PCMFrameDriver the trial grid on `device` ("auto" = "tpu" on a
CUDA device, as for STC-007).  With `graphs` (the default) every device
call of the drivers (the batch's trial grid, the marker fallback's
re-decode, the level sweeps, the PCM grid) replays as a CUDA graph from
the thread's ops/round_graph.RoundGraphs on `device`, `stream_graphs`
(round_graph.thread_graphs), which all the jobs' drivers share with any
other decoder of the thread; graphs=False runs them eagerly.  The flag
reaches the STC-007 stitchers too: under seam_backend="tpu" their device
calls replay from the holder of the thread that stitches (a stitch-pool
thread, or this one for a job's last stitch).
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch

from ..utils.stats import DecodeStats
from . import audio as ap
from . import ingest, v2d, wav
from . import stitcher_stc007 as st


def resolve_auto_backend(device) -> str:
    """What backend "auto" names for the torch device `device`: "tpu" (the
    batch grid on the card) when it is a CUDA device; on the CPU the
    host's native grid when its C++ core is available, else "tpu"."""
    from ..ops import stitch_native as sn
    if torch.device(device).type == "cuda":
        return "tpu"
    return "native" if sn.available() else "tpu"


class _InlineFuture:
    def __init__(self, value=None):
        self._value = value

    def result(self):
        return self._value


class _InlineExecutor:
    """Same-thread executor for single-core hosts."""

    def submit(self, fn, *args, **kw):
        return _InlineFuture(fn(*args, **kw))


@dataclass
class CaptureJob:
    path: str
    out_path: str
    reader: object = None
    driver: object = None
    stitcher: object = None
    audio: object = None
    writer: object = None
    stats: DecodeStats = dataclasses.field(default_factory=DecodeStats)
    frame_no: int = 0
    frames_read: int = 0
    logged: int = 0
    first: bool = True
    eof: bool = False
    done: bool = False


class BatchDecoder:
    """Decode several captures concurrently.

    fmt selects the decode family per run ("stc007", "pcm1", "pcm16x0",
    "pcm1630") — the reference routes one user-set pcm_type the same way
    (videotodigital.h:125-126).  fmt="auto" probes every capture's format
    signature (pipeline/probe.py, BASELINE config 5 "auto format
    search") and requires consensus, since one run drives one decode
    family.  PCM-1/16x0 jobs run the host round loop; their
    PCMFrameDriver runs the trial grid on the backend resolved here
    (on `device` unless it is "native")."""

    def __init__(self, jobs, lines_per_field=294, hyst_limit=2,
                 shift_limit=1, mask_mode=ap.DROP_INTER_LIN_WORD,
                 frames_per_round=4, workers=None, ref_sweep=False,
                 ref_sweep_fallback=False, checkpoint=False,
                 backend="auto", per_line_agc=False, fmt="stc007",
                 normal_sweep_prescan=False, seam_backend="auto",
                 refine=True, mode_m2=False, preset_video=None,
                 preset_order=None, preset_resolution=None,
                 preset_sample_rate=None, device="cuda", use_kernel=None,
                 graphs=True):
        self.jobs = [CaptureJob(path=p, out_path=o) for p, o in jobs]
        self.frames_per_round = frames_per_round
        self.checkpoint = checkpoint
        if fmt == "auto":
            from . import probe
            guesses = {j.path: probe.probe_capture(j.path)[0]
                       for j in self.jobs}
            kinds = set(guesses.values())
            if len(kinds) != 1 or None in kinds:
                raise ValueError(
                    f"format probe disagrees across captures: {guesses}; "
                    "pass fmt explicitly or split the batch")
            fmt = kinds.pop()
        self.fmt = fmt
        if backend == "auto":
            import os
            backend = os.environ.get("SDV_BACKEND", "auto")
        from ..ops import stitch_native as sn
        if backend == "auto":
            # On a CUDA device the trial grid runs on the card; the host's
            # native grid is what "auto" means only for device="cpu" (and
            # an explicit choice everywhere).
            backend = resolve_auto_backend(device)
        elif backend == "native" and not sn.available():
            # Explicit native without the C++ core: degrade to the device
            # backend instead of failing mid-decode.
            backend = "tpu"
        line_backend = backend   # what the per-frame binarizer runs on
        if fmt != "stc007":
            backend = "native"  # round loop; the driver splits internally
        self.backend = backend
        self.stage_t = defaultdict(float)
        # The drivers' graph holder, the thread's: a capture made for one
        # job's shape serves every job, and later decoders.
        from ..ops.round_graph import thread_graphs
        self.stream_graphs = thread_graphs(device) if graphs else None
        for j in self.jobs:
            j.reader = ingest.open_capture(j.path)
            j.stats.frames_dropped = getattr(j.reader, "dropped_frames", 0)
        if lines_per_field is None:
            # Derive from the already-open readers: a second transient
            # open_capture just to read the height would consume a
            # FIFO/stream input's header (or block on a second opener).
            lines_per_field = (self.jobs[0].reader.height // 2
                               if self.jobs else st.LINES_PF_PAL)
        if preset_video is None:
            # detectVideoStandard's field-height rule (>260 lines =
            # PAL), NOT an exact-294 match: 576-line captures are PAL
            # too (stc007datastitcher.cpp:2773)
            preset_video = st.VID_PAL if lines_per_field > 260 \
                else st.VID_NTSC
        for j in self.jobs:
            if fmt == "stc007":
                j.driver = v2d.V2DDriver(
                    hyst_limit=hyst_limit, shift_limit=shift_limit,
                    ref_sweep=ref_sweep,
                    ref_sweep_fallback=ref_sweep_fallback,
                    normal_sweep_prescan=normal_sweep_prescan,
                    per_line_agc=per_line_agc, m2=mode_m2, device=device,
                    use_kernel=use_kernel, graphs=graphs)
                j.stitcher = st.STC007Stitcher(
                    preset_video=preset_video,
                    mode_m2=mode_m2, auto_m2=not mode_m2,
                    preset_order=(st.ORDER_UNK if preset_order is None
                                  else preset_order),
                    preset_resolution=preset_resolution,
                    preset_sample_rate=preset_sample_rate or 0,
                    seam_backend=seam_backend, device=device,
                    graphs=graphs)
            elif fmt == "pcm1":
                from . import stitcher_pcm1 as sp1
                from . import v2d_other
                j.driver = v2d_other.PCMFrameDriver(
                    "pcm1", shift_limit=shift_limit,
                    hyst_limit=hyst_limit, backend=line_backend,
                    refine=refine, device=device,
                    graphs=graphs)
                j.stitcher = sp1.PCM1Stitcher()
            elif fmt in ("pcm16x0", "pcm1630"):
                from . import stitcher_pcm16x0 as sp16
                from . import v2d_other
                j.driver = v2d_other.PCMFrameDriver(
                    "pcm16x0", shift_limit=shift_limit,
                    hyst_limit=hyst_limit, backend=line_backend,
                    refine=refine, device=device,
                    graphs=graphs)
                j.stitcher = sp16.PCM16X0Stitcher(
                    fmt=sp16.FORMAT_EI if fmt == "pcm1630"
                    else sp16.FORMAT_SI,
                    auto_fmt=fmt == "pcm16x0")
            else:
                raise ValueError(f"unknown fmt {fmt!r}")
            j.audio = ap.AudioProcessor(mask_mode=mask_mode)
            if checkpoint:
                self._try_resume(j)
        import os
        n_workers = workers or min(8, len(self.jobs))
        if n_workers <= 1 or (os.cpu_count() or 1) <= 1:
            # Single host core: the pool only adds GIL churn.
            self.pool = _InlineExecutor()
        else:
            self.pool = ThreadPoolExecutor(n_workers)

    @contextlib.contextmanager
    def _stage(self, name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.stage_t[name] += time.perf_counter() - t0

    @staticmethod
    def _ckpt_path(job):
        return job.out_path + ".ckpt"

    def _try_resume(self, job):
        import os
        from ..utils import resume as ckpt
        p = self._ckpt_path(job)
        if not os.path.exists(p + ".json"):
            return
        frame_no, audio_out, rate = ckpt.load_checkpoint(
            p, job.stitcher, audio=job.audio, driver=job.driver)
        job.frame_no = job.frames_read = frame_no
        job.first = False
        job.logged = len(job.stitcher.frame_log)
        job.writer = wav.WavWriter(job.out_path, rate, resume_at=audio_out)

    def _save_checkpoint(self, job):
        from ..utils import resume as ckpt
        ckpt.save_checkpoint(
            self._ckpt_path(job), job.frame_no, job.stitcher,
            job.writer.samples_written if job.writer else 0,
            job.writer.sample_rate if job.writer else 44100,
            audio=job.audio, driver=job.driver)

    def _stitch_and_write(self, job: CaptureJob, stores, finish=False):
        t0 = time.perf_counter()
        if hasattr(job.stitcher, "push_frames"):
            # Whole-round queue: consecutive steady STC-007 pairs run
            # through one stc007_steady_round call.
            job.stitcher.push_frames(stores)
        else:
            for store in stores:
                job.stitcher.push_frame(store)
        if finish:
            job.stitcher.finish()
        t1 = time.perf_counter()
        self.stage_t["stitch"] += t1 - t0
        if stores:
            job.stats.add_di_time(int((t1 - t0) * 1e6), len(stores))
        for fr in job.stitcher.frame_log[job.logged:]:
            job.stats.add_frame(fr)
        # Drain consumed entries: the log otherwise grows without bound
        # over archive-length tapes (~1 KB/frame).
        del job.stitcher.frame_log[:]
        job.logged = 0
        arrs = st.chunks_to_arrays(job.stitcher.pop_sample_chunks())
        if arrs is None:
            return
        with self._stage("audio"):
            samples, valid, blk, rate = arrs
            out = job.audio.process(samples, valid, blk, file_end=False)
            job.stats.add_audio(out, job.audio.total_masked)
        with self._stage("wav"):
            if job.writer is None:
                job.writer = wav.WavWriter(job.out_path, rate)
            job.writer.write(out)
            job.writer.flush()
        if self.checkpoint:
            with self._stage("ckpt"):
                self._save_checkpoint(job)

    def _build_stores(self, j: CaptureJob, results, nums):
        if self.fmt != "stc007":
            return self._build_stores_other(j, results, nums)
        return self._build_stores_stc007(j, results, nums)

    def _build_stores_other(self, j: CaptureJob, results, nums):
        """PCM-1 / PCM-16x0 stores (None frames are skipped — the
        single-frame stitchers carry no cross-frame interleave, matching
        the CLI path)."""
        stores = []
        L = len(nums)
        for res in results:
            j.frame_no += 1
            if res is None:
                j.stats.frames_no_pcm += 1
                continue
            if self.fmt == "pcm1":
                from . import stitcher_pcm1 as sp1
                store = sp1.PCM1LineStore.from_decoded(
                    res.words, res.crc_read, np.full(L, j.frame_no),
                    nums, ref_level=np.full(L, res.ref_level),
                    valid=res.valid)
                tag_cls = sp1.PCM1LineStore
                srv_new = sp1.SRV_NEW_FILE
            else:
                from . import stitcher_pcm16x0 as sp16
                store = sp16.PCM16X0LineStore.from_decoded(
                    res.words, res.crc_read, np.full(L * 3, j.frame_no),
                    np.repeat(nums, 3), np.tile(np.arange(3), L),
                    control_bit=np.repeat(res.ctrl, 3),
                    picked_left=res.picked_left,
                    picked_right=res.picked_right, valid=res.valid)
                tag_cls = sp16.PCM16X0LineStore
                srv_new = sp16.SRV_NEW_FILE
            j.stats.lines_total += len(res.valid)
            j.stats.lines_valid += int(np.asarray(res.valid).sum())
            if j.first:
                tag = tag_cls(1)
                tag.service[0] = srv_new
                tag.frame_number[0] = j.frame_no
                store = tag_cls.concat([tag, store])
                j.first = False
            stores.append(store)
        return stores

    def _build_stores_stc007(self, j: CaptureJob, results, nums):
        """FrameDecodeResults (or Nones) -> per-frame LineStores."""
        stores = []
        for res in results:
            j.frame_no += 1
            if res is None:
                # Dropped/no-PCM frame: all-invalid dummy frame keeps
                # interleave timing (the reference inserts dummies for
                # drops, ffmpegwrapper.cpp:898-907).
                j.stats.frames_no_pcm += 1
                store = st.LineStore(len(nums))
                store.frame_number[:] = j.frame_no
                store.line_number = np.asarray(nums, np.int64).copy()
                j.stats.lines_total += len(nums)
            else:
                store = st.LineStore.from_decoded(
                    res.words, res.crc_read, res.valid,
                    np.full(len(nums), j.frame_no), nums,
                    ref_level=np.full(len(nums), res.ref_level),
                    forced_bad=res.forced_bad)
                j.stats.lines_total += len(nums)
                j.stats.lines_valid += int(res.valid.sum())
                j.stats.lines_dup += int(res.duplicates.sum())
            if j.first:
                tag = st.LineStore(1)
                tag.service[0] = st.SRV_NEW_FILE
                tag.frame_number[0] = j.frame_no
                store = st.LineStore.concat([tag, store])
                j.first = False
            stores.append(store)
        return stores

    def run(self):
        if self.backend == "native":
            return self.run_native()
        return self.run_tpu()

    def step_native(self):
        """One host-backend round over all live jobs; returns True while
        any job made progress (separate from run_native so tests can
        kill between rounds)."""
        progressed = False
        for j in self.jobs:
            if j.done:
                continue
            if not j.eof:
                with self._stage("read"):
                    batch = j.reader.read_frames_view(
                        j.frames_read, self.frames_per_round)
                    if batch.shape[0] and batch.shape[2] < \
                            ingest.MIN_WIDTH_FOR_SINGLE:
                        # narrow capture: width-doubling needs the
                        # copying field splitter
                        lines_b, nums = ingest.split_fields_batch(
                            np.ascontiguousarray(batch))
                        perm = None
                    else:
                        perm, nums = ingest.field_perm(batch.shape[1])
                        lines_b = batch
                if batch.shape[0] == 0:
                    j.eof = True
                else:
                    progressed = True
                    j.frames_read += batch.shape[0]
                    with self._stage("prescan"):
                        prep = j.driver.prepare_frames(lines_b, perm=perm)
                    with self._stage("binarize"):
                        if self.fmt == "stc007":
                            results = j.driver.decode_prepared_host(
                                lines_b, prep, perm=perm)
                        elif prep["usable"].any():
                            results = j.driver.decode_prepared(
                                lines_b, prep, perm=perm)
                        else:
                            results = [None] * lines_b.shape[0]
                    with self._stage("assemble"):
                        stores = self._build_stores(j, results, nums)
                    self._stitch_and_write(j, stores)
            if j.eof and not j.done:
                self._stitch_and_write(j, [], finish=True)
                self._drain_final(j)
                j.done = True
        return progressed or not all(j.done for j in self.jobs)

    def run_native(self):
        """Host-backend loop: zero-copy mmap views through the native
        early-exit trial grid; no device round-trips on the fast path.
        Captures still interleave round-robin so streaming WAV output
        advances evenly across jobs."""
        while self.step_native():
            pass
        return {j.path: j.stats for j in self.jobs}

    def run_tpu(self):
        """Round-robin with one round in flight: while the device chews
        on round k+1's fused dispatch, the host stitches round k (the
        software-pipelined analog of the reference's VIN/V2D queue pair,
        config.h:76-77).

        All live captures' frames are fused into ONE device dispatch per
        round when their geometries match (prepare/dispatch/finalize
        split of V2DDriver); per-capture prescan state and stitching
        stay independent.
        """
        pending = None   # (round_work, fused_ctx)
        while True:
            round_work = self._read_round()
            ctx = self._dispatch_round(round_work)
            if pending is not None:
                self._complete_round(*pending)
            pending = (round_work, ctx) if round_work else None
            if not round_work:
                for j in self.jobs:
                    if j.eof and not j.done:
                        self._stitch_and_write(j, [], finish=True)
                        self._drain_final(j)
                        j.done = True
                if all(j.done for j in self.jobs):
                    break
        return {j.path: j.stats for j in self.jobs}

    def _read_round(self):
        round_work = []   # (job, split, lines_b, prep)
        for j in self.jobs:
            if j.done or j.eof:
                continue
            with self._stage("read"):
                batch = j.reader.read_frames(j.frames_read,
                                             self.frames_per_round)
                if batch.shape[0] == 0:
                    j.eof = True
                    continue
                j.frames_read += batch.shape[0]
                lines_b, nums = ingest.split_fields_batch(batch)
            split = [(lines_b[f], nums) for f in range(batch.shape[0])]
            with self._stage("prescan"):
                prep = j.driver.prepare_frames(lines_b)
            round_work.append((j, split, lines_b, prep))
        return round_work

    def _dispatch_round(self, round_work):
        """Enqueue the round's device work; returns a context for
        _complete_round (non-blocking)."""
        if not round_work:
            return None
        t0 = time.perf_counter()
        try:
            return self._dispatch_round_inner(round_work)
        finally:
            self.stage_t["dispatch"] += time.perf_counter() - t0

    def _dispatch_round_inner(self, round_work):
        fused = len(round_work) > 1 and len(
            {w[2].shape[1:] for w in round_work}) == 1
        if fused:
            px = np.concatenate([w[2] for w in round_work])
            prep = {k: np.concatenate([w[3][k] for w in round_work])
                    for k in ("coords", "refs", "blacks", "whites",
                              "usable")}
            drv0 = round_work[0][0].driver
            dev = drv0.dispatch_frames_async(px, prep)
            return ("fused", px, prep, dev)
        devs = []
        for (j, split, lines_b, jprep) in round_work:
            if not jprep["usable"].any():
                devs.append(None)
            else:
                devs.append(j.driver.dispatch_frames_async(lines_b, jprep))
        return ("per_job", devs)

    def _complete_round(self, round_work, ctx):
        if ctx is None:
            return
        if ctx[0] == "fused":
            _, px, prep, dev = ctx
            drv0 = round_work[0][0].driver
            with self._stage("materialize"):
                dw, dc, dv, df = drv0.materialize_frames(px, prep, dev)
            ofs = 0
            per_job = []
            with self._stage("finalize"):
                for (j, split, lines_b, jprep) in round_work:
                    n = lines_b.shape[0]
                    per_job.append(j.driver.finalize_frames(
                        lines_b, jprep, dw[ofs:ofs + n], dc[ofs:ofs + n],
                        dv[ofs:ofs + n], df[ofs:ofs + n]))
                    ofs += n
        else:
            per_job = []
            for (j, split, lines_b, jprep), dev in zip(round_work, ctx[1]):
                if dev is None:
                    per_job.append([None] * lines_b.shape[0])
                    continue
                with self._stage("materialize"):
                    w_, c_, v_, f_ = j.driver.materialize_frames(
                        lines_b, jprep, dev)
                with self._stage("finalize"):
                    per_job.append(j.driver.finalize_frames(
                        lines_b, jprep, w_, c_, v_, f_))
        futures = []
        for (j, split, lines_b, _), results in zip(round_work, per_job):
            nums = split[0][1]
            with self._stage("assemble"):
                stores = self._build_stores(j, results, nums)
            futures.append(self.pool.submit(self._stitch_and_write, j,
                                            stores))
        for f in futures:
            f.result()

    def _drain_final(self, job):
        arrs = st.chunks_to_arrays(job.stitcher.pop_sample_chunks())
        if arrs is not None:
            samples, valid, blk, rate = arrs
            out = job.audio.process(samples, valid, blk, file_end=True)
        else:
            out, rate = job.audio.flush(), 44100
        if len(out):
            job.stats.add_audio(out, job.audio.total_masked)
            if job.writer is None:
                job.writer = wav.WavWriter(job.out_path, rate)
            job.writer.write(out)
        if job.writer is not None:
            job.writer.close()
        job.reader.close()
        if self.checkpoint:
            import os
            for suf in (".json", ".npz"):
                try:
                    os.remove(self._ckpt_path(job) + suf)
                except FileNotFoundError:
                    pass
