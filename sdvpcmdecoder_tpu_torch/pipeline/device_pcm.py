"""Chip-resident PCM-1 / PCM-16x0 batch decoder.

Port of sdvpcmdecoder_tpu/pipeline/device_pcm.py, the PCM formats'
counterpart of pipeline/device_driver.DeviceBatchDecoder: each capture's
pixels are split to fields and put on `device` once per bounded chunk,
every round of frames decodes with ONE call
(ops/device_pcm.pcm_round_packed — the trial-grid binarize + packing —
replayed as one CUDA graph, ops/round_graph, where the JAX package calls
its jitted round), and ONE asynchronous int32 copy (utils.host.HostCopy)
carries words/CRCs/validity/control bits back.  These formats stitch per frame
(no cross-frame interleave), so the host replay is simply the existing
stitchers — their native steady-frame calls (pcm1_steady_frame /
pcm16x0_steady_frame, stitchcore.cpp) consume the device words and emit
samples, bit-identical to the streaming backends by construction.

Host work per round: AGC + coordinate search over the prescan rows
(4 a frame, gathered on the device and copied back asynchronously a
round ahead), per-line refinement / Bit Picker for failed lines, store
assembly, steady-frame replay, audio masking, WAV.  Where the JAX driver
fetches each failed frame's pixels synchronously, here the frames with
failed lines are gathered in one index_select and one copy per round
(as the STC-007 driver's _complete does); `fetched_frames` and
`fetch_copies` count them.

Spans of the decoder's tracer (`trace`, besides the shared stages):
`pcm_agc` (the frame driver's AGC and coordinate search, inside
`prescan`), `pcm_round` (the round's parameter packing and its launch,
inside `dispatch`) and `pcm_refine` (the fetch of the frames to refine
here, and the frame driver's refinement, Bit Picker and CRC re-check,
inside `finalize`); counters `count_pcm_refined_frames` (the frame
driver) and `count_pcm_native_frames` (the stitchers).

Reference scope: the V2D loop feeding the per-format stitcher threads
(videotodigital.cpp:698 routing, pcm1datastitcher.cpp:1578,
pcm16x0datastitcher.cpp:5652 doFrameReassemble).
"""
from __future__ import annotations

import torch

from ..ops import device_pcm as dp
from ..ops.round_graph import call
from ..utils.host import HostCopy
from .device_driver import StagedDeviceDecoder
from .v2d_other import PCMFrameDriver


def run_round(pixels, params, *, fmt, shift_limit, hyst_limit,
              graphs=None):
    """One pcm_round_packed round on the pixels' device: params its int32
    vector (dp.round_param_layout; numpy or a tensor), graphs a
    RoundGraphs that replays it (None: run it eagerly). Returns the
    round's int32 buffer; under `graphs` it is the graph's buffer, which
    the next replay writes over."""
    def body(pixels, params):
        return (dp.pcm_round_packed(pixels, params, fmt=fmt,
                                    shift_limit=shift_limit,
                                    hyst_limit=hyst_limit),)

    return call(graphs, ("pcm_round_packed", fmt, shift_limit, hyst_limit),
                body, (pixels, torch.as_tensor(params, dtype=torch.int32)),
                pixels.device)[0]


class DevicePCMBatchDecoder(StagedDeviceDecoder):
    """BatchDecoder with the PCM-1/16x0 binarize resident on `device`.

    fmt in ("pcm1", "pcm16x0", "pcm1630"); pixels are staged on the
    device in bounded chunks of `hbm_frames` frames, so capture length
    is unbounded (these formats stitch per frame — no cross-chunk state
    beyond the stitcher's own host-side histories). With `graphs` (the
    default) each round replays as a CUDA graph (`self.graphs`, an
    ops.round_graph.RoundGraphs; its CPU stand-in on the CPU);
    graphs=False runs the round's ops eagerly. The frame drivers'
    refinement runs on the host here, so BatchDecoder's `stream_graphs`
    (a pool of its own) stays unused.
    """

    prescan_rows = staticmethod(PCMFrameDriver.prescan_rows)
    round_param_layout = staticmethod(dp.round_param_layout)

    def __init__(self, jobs, fmt, hyst_limit=0, shift_limit=2,
                 frames_per_round=16, hbm_frames=256, *, device="cuda",
                 graphs=True, **kw):
        if fmt not in ("pcm1", "pcm16x0", "pcm1630"):
            raise ValueError(f"DevicePCMBatchDecoder: unsupported {fmt!r}")
        super().__init__(jobs, hyst_limit, shift_limit, frames_per_round,
                         hbm_frames, device=device, graphs=graphs, fmt=fmt,
                         **kw)

    def _init_device_state(self):
        self.dec_fmt = "pcm1" if self.fmt == "pcm1" else "pcm16x0"
        # Frames copied back for refinement, and the copies.
        self.fetched_frames = 0
        self.fetch_copies = 0

    # run/_visit/_stage_chunk inherited from StagedDeviceDecoder.
    def _dispatch(self, j):
        with self._stage("dispatch"):
            F = min(self.frames_per_round,
                    j.chunk_base + j.chunk_len - j.frames_read)
            Ls, W = j.Ls, j.W
            lo = j.frames_read - j.chunk_base
            px = j.px_dev[lo:lo + F]
            with self._stage("prescan"):
                sample = self._take_sample(j, px)
                with self.trace.span("pcm_agc"):
                    prep = j.driver.prepare_frames(None, sample=sample,
                                                   shape=(F, Ls, W))
            with self.trace.span("pcm_round"):
                out = run_round(px, self._round_params(F, prep),
                                fmt=self.dec_fmt,
                                shift_limit=self.shift_limit,
                                hyst_limit=self.hyst_limit,
                                graphs=self.graphs)
            # Copied before any other round replays.
            j.pending = dict(F=F, px=px, prep=prep, out=HostCopy(out))
            j.frames_read += F
            self._prefetch_sample(j, j.frames_read)

    def _complete(self, j):
        p = j.pending
        j.pending = None
        F, Ls = p["F"], j.Ls
        prep = p["prep"]
        words, crc, valid, ctrl = self._materialize(
            j, p["out"], dp.unpack_round, F, Ls, self.dec_fmt)
        with self._stage("finalize"):
            # The frames finalize_decoded refines (usable, some line
            # failed): their pixels come back in one gather and one copy.
            fetch = [f for f in range(F)
                     if j.driver.refine and prep["usable"][f]
                     and not valid[f].all()]
            rows = {}
            if fetch:
                with self.trace.span("pcm_refine"):
                    host, = self._fetch_frames(fetch, p["px"])
                rows = dict(zip(fetch, host))
                self.fetched_frames += len(fetch)
                self.fetch_copies += 1
            results = j.driver.finalize_decoded(
                prep, words, crc, valid, ctrl, rows.__getitem__, j.W)
        with self._stage("assemble"):
            stores = self._build_stores_other(j, results, j.nums)
        self._stitch_and_write(j, stores)
