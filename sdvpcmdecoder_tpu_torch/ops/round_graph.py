"""The JAX package's compiled programs replayed as CUDA graphs.

The port's counterpart of the JAX package's jitted programs: one
executable, one dispatch per call. torch runs the same bodies eagerly,
one launch per op (about 1,650 for a 16-frame STC-007 round).
`RoundGraphs` captures a call (a "round") into a CUDA graph and replays
it, one graph launch per call. Its callers:

  * the chip-resident rounds, `jax.jit(steady_round_packed)`
    (sdvpcmdecoder_tpu/ops/device_stitch.py; pipeline/device_driver.py)
    and `jax.jit(pcm_round_packed)` (ops/device_pcm.py;
    pipeline/device_pcm.py);
  * the streaming backend's device calls (pipeline/v2d.V2DDriver): the
    batch's trial grid with its casts (`stc007_frame_decode`, or K1), the
    marker fallback's 64 x 1 re-decode, and the reference-level sweep
    (the JAX package's `lax.scan`: 64 K1 launches, one graph launch);
  * the PCM-1 / PCM-16x0 grid, `jax.jit(pcm1_frame_decode)` and
    `jax.jit(pcm16x0_frame_decode)` (pipeline/v2d_other.PCMFrameDriver);
  * the stream chain, `jax.jit(decode_stream)` and `jax.jit(
    decode_frames)` (pipeline/decoder.py; parallel/mesh.py's step);
  * the STC-007 stitcher's device seam route (seam_backend="tpu"), the
    JAX package's `_eval_rows_jit` and `_seam_sweep`
    (ops/device_stitch.eval_rows_arrays, seam_sweep): each block eval of
    the resolution counts, the seams, the conv queue and the final
    deinterleave, and each padding search, one graph launch. They run on
    the thread that stitches, a pipeline/batch_driver.BatchDecoder
    stitch-pool thread or the caller's own. Each such thread's holder
    pays a key's eager use and its capture once, so a pool of N threads
    may capture a key N times, and a new pool (each BatchDecoder makes
    its own) captures its keys again.

The rules:

  * key: what the caller names (the round's static arguments, as jax.jit
    takes them, and the identity of the cached tables the round reads)
    and every input's shape and dtype;
  * the first round of a key runs eagerly and its result is used: it is
    also the warm-up (K1's C entry sets its shared-memory attribute and
    caches its grid on a first call, which a capture must not do); the
    second captures the key into a memory pool that all of this object's
    graphs share, then replays it; every later round replays it;
  * before a replay the inputs are copied into the graph's static
    buffers, host tensors from pinned memory by a non_blocking copy;
  * outputs that outlive the round are cloned after the replay: the next
    replay of the key, or of another key of the shared pool, writes over
    the static ones. The caller copies the others (through
    utils.host.HostCopy, enqueued on the replay's stream) before it
    starts another round of this object;
  * the kernel wrappers' launch counters (ops/fused_binarize) count a
    captured kernel once per replay, not at the capture;
  * every caller goes through `call`, which runs the body eagerly where
    the caller holds no RoundGraphs (its graphs=False);
  * captures hold a process-wide lock and run in thread-local capture
    mode, so decoder threads on one card (parallel/multichip.py) never
    capture at once and no other thread's call breaks a capture. One
    thread uses an object (a memory pool each): `thread_graphs(device)`
    is the calling thread's, which the streaming drivers and the stream
    chain share; the chip-resident drivers hold one each for their
    rounds.

A failed capture or replay raises; nothing carries on eagerly or on the
CPU. On a CPU device a stand-in takes the graph's place: it records the
callable and calls it again at each replay on the same static inputs,
writing the results into the same static outputs, so the CPU tests go
through the keying, the copies in and the clones out.
"""
from __future__ import annotations

import contextlib
import threading

import torch

from ..utils.host import upload
from . import fused_binarize as fb

_CAPTURE_LOCK = threading.Lock()
_THREAD = threading.local()   # this thread's holders: device -> RoundGraphs


def call(graphs, key, body, inputs, device, clone=()):
    """body(*inputs) on `device`, as a tuple: with `graphs` (a
    RoundGraphs) through its graph of `key` (RoundGraphs.run), with None
    eagerly on the inputs uploaded (utils.host.upload; a tensor already
    on `device` is passed as it is). Every caller that may replay takes
    this one route, so none decides graph or eager itself."""
    if graphs is None:
        return tuple(body(*(upload(t, device) for t in inputs)))
    return graphs.run(key, body, inputs, clone=clone)


def thread_graphs(device) -> "RoundGraphs":
    """The calling thread's RoundGraphs on `device`, made on its first use.

    As the JAX package's jit cache serves every caller in a process, this
    holder serves every streaming driver (pipeline/v2d, v2d_other,
    batch_driver) and the stream chain (pipeline/decoder) of the thread:
    a key captured by one decoder replays for the next, and only the
    thread's first use of a shape pays its eager run and its capture.
    Their keys name every static argument a body reads, and each caller
    copies what it keeps of a replay's buffers before its next call, so
    callers never read each other's results."""
    held = getattr(_THREAD, "by_device", None)
    if held is None:
        held = _THREAD.by_device = {}
    device = torch.device(device)
    if device not in held:
        held[device] = RoundGraphs(device)
    return held[device]


class _StandIn:
    """A captured graph's CPU stand-in: `fn` on `inputs`, called again at
    each replay, its results written into the outputs of the first call."""

    def __init__(self, fn, inputs):
        self.fn, self.inputs = fn, inputs
        self.outputs = tuple(fn(*inputs))

    def replay(self):
        for static, new in zip(self.outputs, self.fn(*self.inputs)):
            static.copy_(new)


class _Captured:
    """One key's graph, its static inputs and outputs, and the kernel
    launches its capture recorded."""

    def __init__(self, graph, inputs, outputs, tally):
        self.graph, self.inputs = graph, inputs
        self.outputs, self.tally = outputs, tally


class RoundGraphs:
    """The round graphs of one decoder on one device (CUDA, or the CPU's
    stand-in). `captures`, `replays` and `eager_rounds` count its rounds:
    every round is an eager first use of its key or a replay."""

    def __init__(self, device):
        self.device = torch.device(device)
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"RoundGraphs: unsupported device "
                             f"{self.device}")
        self.captures = 0
        self.replays = 0
        self.eager_rounds = 0
        self._graphs = {}   # key -> None once seen, then its _Captured
        self._pool = None
        self._stream = None

    def run(self, key, fn, inputs, clone=()):
        """fn(*inputs) -> a tuple of tensors on this device, through this
        key's graph. `inputs` are tensors on the device or on the host;
        the outputs at the positions in `clone` are copies the next replay
        does not touch, the others the graph's own buffers."""
        key = (key, tuple((tuple(t.shape), t.dtype) for t in inputs))
        if key not in self._graphs:
            self._graphs[key] = None
            self.eager_rounds += 1
            return tuple(fn(*(upload(t, self.device) for t in inputs)))
        with (torch.cuda.device(self.device) if self.device.type == "cuda"
              else contextlib.nullcontext()):
            outputs = self._replay(key, fn, inputs)
        return tuple(o.clone() if i in clone else o
                     for i, o in enumerate(outputs))

    def _replay(self, key, fn, inputs):
        entry = self._graphs[key]
        if entry is None:
            entry = self._graphs[key] = self._capture(fn, inputs)
            self.captures += 1
        else:
            self._copy_in(entry.inputs, inputs)
            with fb.launches_deferred({}):   # the stand-in's second call
                entry.graph.replay()
        self.replays += 1
        fb.count_launches(entry.tally)
        return entry.outputs

    def _copy_in(self, static, inputs):
        for s, t in zip(static, inputs):
            if self.device.type == "cuda" and t.device.type == "cpu":
                t = t.pin_memory()   # as utils.host.upload
            s.copy_(t, non_blocking=True)

    def _capture(self, fn, inputs):
        """The key's capture, and this round's result: on CUDA the
        capture and one replay, on the CPU the stand-in's first call."""
        static = [torch.empty(t.shape, dtype=t.dtype, device=self.device)
                  for t in inputs]
        self._copy_in(static, inputs)
        tally = {}
        if self.device.type == "cpu":
            with fb.launches_deferred(tally):
                graph = _StandIn(fn, static)
            return _Captured(graph, static, graph.outputs, tally)
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        with _CAPTURE_LOCK, fb.launches_deferred(tally), \
                torch.cuda.stream(self._stream):
            graph.capture_begin(pool=self._pool,
                                capture_error_mode="thread_local")
            try:
                outputs = tuple(fn(*static))
            except BaseException:
                self._end_failed_capture(graph)
                raise
            graph.capture_end()
        graph.replay()
        return _Captured(graph, static, outputs, tally)

    def _end_failed_capture(self, graph):
        """End a capture that a call inside it invalidated (capture_end
        raises for it; the caller raises the call's error) and capture
        into a new pool from now on: the allocator goes on counting the
        failed capture's pool as being recorded to."""
        try:
            graph.capture_end()
        except RuntimeError:
            pass
        self._pool = torch.cuda.graph_pool_handle()
