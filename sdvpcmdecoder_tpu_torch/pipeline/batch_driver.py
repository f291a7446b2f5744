"""Multi-capture batch driver: N concurrent tapes through one chip.

BASELINE config 5: "Batched multi-tape pipeline: 8 concurrent
dropout-heavy captures, auto format/level search, streaming WAV out."

Each capture owns its V2D driver, stitcher, audio chain and WAV writer.
Per-stage wall time is accumulated in `stage_t`.

Port of the parts of sdvpcmdecoder_tpu/pipeline/batch_driver.py that the
chip-resident driver (pipeline/device_driver.DeviceBatchDecoder) inherits:
CaptureJob, the STC-007 constructor, checkpoints, store assembly, the
stitch/audio/WAV tail and the final drain.  The driver's `device` and
`use_kernel` reach the V2D driver and the stitcher's device backend.  The
streaming loops (run_native, run_tpu), with their backend choice and
thread pool, wait for the streaming backend (ROADMAP Queue 1 item 4);
fmt="auto", PCM-1 and PCM-16x0 for the PCM slice (item 6).
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import defaultdict
from dataclasses import dataclass

import numpy as np

from ..utils.stats import DecodeStats
from . import audio as ap
from . import ingest, v2d, wav
from . import stitcher_stc007 as st


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
    """Decode several STC-007 captures.

    The JAX package's fmt selects the decode family per run; here only
    "stc007" is ported (M2 through mode_m2)."""

    def __init__(self, jobs, lines_per_field=294, hyst_limit=2,
                 shift_limit=1, mask_mode=ap.DROP_INTER_LIN_WORD,
                 frames_per_round=4, ref_sweep=False,
                 ref_sweep_fallback=False, checkpoint=False,
                 per_line_agc=False, fmt="stc007",
                 normal_sweep_prescan=False, seam_backend="auto",
                 mode_m2=False, preset_video=None,
                 preset_order=None, preset_resolution=None,
                 preset_sample_rate=None, device="cuda", use_kernel=None):
        self.jobs = [CaptureJob(path=p, out_path=o) for p, o in jobs]
        self.frames_per_round = frames_per_round
        self.checkpoint = checkpoint
        if fmt != "stc007":
            raise NotImplementedError(
                f"fmt={fmt!r}: the format probe, PCM-1 and PCM-16x0 are not "
                "ported yet (ROADMAP Queue 1 item 6)")
        self.fmt = fmt
        self.stage_t = defaultdict(float)
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
            j.driver = v2d.V2DDriver(
                hyst_limit=hyst_limit, shift_limit=shift_limit,
                ref_sweep=ref_sweep,
                ref_sweep_fallback=ref_sweep_fallback,
                normal_sweep_prescan=normal_sweep_prescan,
                per_line_agc=per_line_agc, m2=mode_m2, device=device,
                use_kernel=use_kernel)
            j.stitcher = st.STC007Stitcher(
                preset_video=preset_video,
                mode_m2=mode_m2, auto_m2=not mode_m2,
                preset_order=(st.ORDER_UNK if preset_order is None
                              else preset_order),
                preset_resolution=preset_resolution,
                preset_sample_rate=preset_sample_rate or 0,
                seam_backend=seam_backend, device=device)
            j.audio = ap.AudioProcessor(mask_mode=mask_mode)
            if checkpoint:
                self._try_resume(j)

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
        raise NotImplementedError(
            "the streaming BatchDecoder loops (run_native, run_tpu) are not "
            "ported yet (ROADMAP Queue 1 item 4); use "
            "device_driver.DeviceBatchDecoder")

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
