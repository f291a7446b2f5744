"""The stitcher's device seam route (seam_backend="tpu") with its two
programs replayed through ops/round_graph.RoundGraphs, on the CPU.

The JAX package compiles `_eval_rows_jit` (J9) and `_seam_sweep` (J10)
once per bucketed shape and static arguments. The port replays each as a
CUDA graph from the calling thread's holder (round_graph.thread_graphs);
on the CPU the graph's stand-in re-calls the recorded body on the same
static buffers, so these tests go through the keying, the copies in and
the copies out. Every comparison is exact, dtypes included (every output
is an integer or a bool): the port's eval_rows_arrays and seam_sweep
through the stand-in (graphs=True) and eagerly (graphs=False) against the
JAX package's, across buckets and with different seam lengths and modes
replayed on one key; BatchDecoder(seam_backend="tpu") WAVs against the
JAX package's; the holders' counters.
"""
import collections
import os
import threading

import numpy as np
import pytest
import torch

import chip_smoke
from test_torch_device_stitch import MODES, assert_same, line_buffer
from sdvpcmdecoder_tpu.formats import stc007 as jst
from sdvpcmdecoder_tpu.ops import device_stitch as jds
from sdvpcmdecoder_tpu.pipeline import batch_driver as jbd
from sdvpcmdecoder_tpu_torch.ops import device_stitch as ds
from sdvpcmdecoder_tpu_torch.ops import round_graph
from sdvpcmdecoder_tpu_torch.pipeline import batch_driver as tbd

torch.set_num_threads(1)

LPF = 294


@pytest.fixture(autouse=True)
def fresh_holders(monkeypatch):
    """Each test starts with no holder in any thread, so its first call
    of a key is the eager one."""
    monkeypatch.setattr(round_graph, "_THREAD", type(round_graph._THREAD)())


def counts(g):
    return g.eager_rounds, g.captures, g.replays


EVAL_CASES = [   # (L, B, explicit rows, en_p, en_q, force_ecc, m2)
    (60, 1, False, True, True, True, False),
    (300, 127, True, True, False, False, True),
    (250, 128, False, True, True, True, True),
    (130, 129, True, False, True, True, False),
    (700, 300, False, True, True, False, False),
    (300, 300, True, True, False, True, False),
]


@pytest.mark.parametrize("L,B,explicit,en_p,en_q,force_ecc,m2", EVAL_CASES)
def test_eval_rows_graph_and_eager_match_jax(L, B, explicit, en_p, en_q,
                                             force_ecc, m2):
    """B in the buckets 128, 256 and 384 and at their edges; contiguous
    shifts and explicit rows reaching past the line buffer (into the
    128-line bucket and beyond it, where the gather clamps); the four
    resolution modes as four calls on one key (its eager use, its
    capture, two replays), m2 on and off."""
    words, ok = line_buffer(L, seed=L + B, bad=0.2)
    rows = None
    if explicit:
        rng = np.random.default_rng(B)
        rows = rng.integers(0, L + 200, (B, 8)).astype(np.int64)
    g = round_graph.thread_graphs("cpu")
    for res_mode in MODES:
        args = (words, ok, rows, 3, B, res_mode, en_p, en_q, force_ecc, m2)
        expect = jds.eval_rows_arrays(*args)
        for graphs in (True, False):
            got = ds.eval_rows_arrays(*args, device="cpu", graphs=graphs)
            assert len(got) == len(expect) == 8
            for k, (a, e) in enumerate(zip(got, expect)):
                assert_same(a, e, f"mode {res_mode} graphs={graphs} "
                            f"output {k}")
    assert counts(g) == (1, 1, 3) and len(g._graphs) == 1
    (key, shapes), = g._graphs
    assert key == ("eval_rows", en_p, en_q, force_ecc, m2)
    assert [s for s, _ in shapes] == [(ds._bucket(L), 8), (ds._bucket(L), 8),
                                      (ds._bucket(B), 8), (ds._bucket(B),)]


@pytest.mark.parametrize("en_p,en_q,m2", [(True, True, False),
                                          (True, False, True)])
def test_seam_sweep_lengths_replay_on_one_key(en_p, en_q, m2):
    """Field lengths below, at and above KEEP (and 0) on ONE key: the
    lengths are inputs of the graph, not constants of its capture. Modes
    with -1 entries, fewer modes than P_MAX, per-pad and scalar unchecked
    limits."""
    seams = [(294, 294), (50, 80), (0, 150), (119, 121), (130, 0),
             (121, 119), (294, 30)]
    g = round_graph.thread_graphs("cpu")
    silent = np.asarray(jst.silent_words(m2=m2), np.int32)
    for k, (n1, n2) in enumerate(seams):
        rng = np.random.default_rng(100 + k)
        w1, c1 = line_buffer(max(n1, 1), seed=n1 + 7, bad=0.3)
        w2, c2 = line_buffer(max(n2, 1), seed=n2 + 9, bad=0.3)
        w1, c1, w2, c2 = w1[:n1], c1[:n1], w2[:n2], c2[:n2]
        n_modes = (32, 20, 32)[k % 3]
        modes = rng.integers(-1, 4, n_modes).astype(np.int32)
        unch = rng.integers(1, 10, n_modes).astype(np.int32) if k % 2 \
            else 4
        args = (w1, c1, w2, c2, silent, modes, en_p, en_q, m2, unch)
        jstats, jhas = jds.seam_sweep(*args)
        for graphs in (True, False):
            stats, has = ds.seam_sweep(*args, device="cpu", graphs=graphs)
            assert_same(stats, jstats, f"seam {n1}/{n2} graphs={graphs}")
            assert_same(has, jhas, f"seam {n1}/{n2} graphs={graphs} has")
        if n1 + n2 > ds.stc007.MIN_DEINT_DATA:
            assert jhas.any()
    assert counts(g) == (1, 1, len(seams) - 1) and len(g._graphs) == 1


Q3_KW = dict(chip_smoke.Q3_MULTI_KW)
CAPTURES = {   # name: (write_capture arguments, BatchDecoder arguments)
    "clean": (dict(n_frames=4, lpf=LPF, seed=1), {}),
    "noisy": (dict(n_frames=6, lpf=LPF, seed=2, noise=26.0), {}),
    "m2": (chip_smoke.Q3, dict(mode_m2=True)),
    "16bit": (chip_smoke.Q3, dict(preset_resolution=2)),
}


class SeamSpy:
    """Counts, per thread, the stitcher's J9 and J10 calls and the keys
    they use, and keeps each thread's holder."""

    def __init__(self, monkeypatch):
        self.calls = collections.Counter()
        self.keys = collections.defaultdict(collections.Counter)
        self.holders = {}
        for name in ("eval_rows_arrays", "seam_sweep"):
            monkeypatch.setattr(ds, name, self._wrap(name, getattr(ds, name)))

    def _wrap(self, name, fn):
        def spy(*a, **k):
            tid = threading.get_ident()
            self.calls[name] += 1
            key = (name, ds._bucket(len(a[0])), ds._bucket(a[4])) \
                if name == "eval_rows_arrays" else (name, a[6:9])
            self.keys[tid][key] += 1
            if k.get("graphs", True):
                self.holders[tid] = round_graph.thread_graphs(k["device"])
            return fn(*a, **k)
        return spy


def run_port(jobs, tmp, tag, **kw):
    dec = tbd.BatchDecoder([(c, os.path.join(tmp, f"{tag}_{k}.wav"))
                            for k, c in enumerate(jobs)],
                           seam_backend="tpu", device="cpu", **kw)
    dec.run()
    return [open(j.out_path, "rb").read() for j in dec.jobs], dec


@pytest.mark.parametrize("name", list(CAPTURES))
def test_batch_decoder_seam_tpu_wavs_match_jax(tmp_path, monkeypatch, name):
    """A clean capture, a noisy one (sigma 26: the padding search and the
    marker re-decode), an M2 capture and a 16-bit preset, full PAL width:
    the port's BatchDecoder(seam_backend="tpu") writes the JAX package's
    WAV under graphs=True and graphs=False, and the same WAV as the
    default route (the native core); every device call of the stitcher
    goes through the thread's holder under graphs and none under
    graphs=False."""
    tmp = str(tmp_path)
    cap_kw, kw = CAPTURES[name]
    cap = chip_smoke.write_capture(os.path.join(tmp, "c.y4m"), **cap_kw)
    kw = dict(Q3_KW, **kw)
    jdec = jbd.BatchDecoder([(cap, os.path.join(tmp, "jax.wav"))],
                            seam_backend="tpu", **kw)
    jdec.run()
    expect = open(os.path.join(tmp, "jax.wav"), "rb").read()
    assert len(expect) > 1000
    spy = SeamSpy(monkeypatch)
    got = {}
    for graphs in (True, False):
        n0 = sum(spy.calls.values())
        got[graphs], dec = run_port([cap], tmp, f"g{int(graphs)}",
                                    graphs=graphs, **kw)
        assert dec.jobs[0].stitcher.graphs is graphs
        assert sum(spy.calls.values()) > n0
        if graphs:
            g, = spy.holders.values()
            eager, captures, replays = counts(g)
            assert eager == len(g._graphs) and replays \
                == sum(spy.calls.values()) - eager
            holder_state = counts(g)
    assert counts(g) == holder_state   # graphs=False used no holder
    dflt = tbd.BatchDecoder([(cap, os.path.join(tmp, "auto.wav"))],
                            device="cpu", **kw)
    dflt.run()
    assert got[True] == got[False] == [expect]
    assert open(os.path.join(tmp, "auto.wav"), "rb").read() == expect
    if name == "m2":
        import hashlib
        assert hashlib.sha256(expect).hexdigest() \
            == chip_smoke.GOLDEN_Q3_DRIVER_SHA256["m2"]


def test_holders_capture_each_key_once_a_thread(tmp_path, monkeypatch):
    """Two runs on one thread: the first makes each key's eager use and
    (for a key used again) its capture, the second only replays. Then two
    captures at once through run_tpu: the stitch pool's threads each hold
    their own keys, one eager use and at most one capture a key, replays
    after."""
    tmp = str(tmp_path)
    caps = [chip_smoke.write_capture(os.path.join(tmp, f"c{i}.y4m"), 4,
                                     LPF, seed=30 + i) for i in range(2)]
    spy = SeamSpy(monkeypatch)
    first, _ = run_port(caps[:1], tmp, "r1", **Q3_KW)
    g, = spy.holders.values()
    tid, = spy.keys
    after1 = counts(g)
    used = spy.keys[tid]
    assert after1 == (len(used), sum(n >= 2 for n in used.values()),
                      sum(used.values()) - len(used))
    assert len(g._graphs) == len(used)
    second, _ = run_port(caps[:1], tmp, "r2", **Q3_KW)
    assert second == first
    eager, captures, replays = counts(g)
    assert eager == after1[0] and captures <= len(used)
    assert replays == sum(spy.keys[tid].values()) - eager

    monkeypatch.setattr(round_graph, "_THREAD", type(round_graph._THREAD)())
    spy = SeamSpy(monkeypatch)
    wavs, dec = run_port(caps, tmp, "two", workers=2, backend="tpu",
                         **Q3_KW)
    assert wavs[:1] == first
    # This thread's holder also serves the V2D dispatch; the pool's
    # threads stitch and nothing else.
    pool = {t: h for t, h in spy.holders.items()
            if h is not dec.stream_graphs}
    assert pool and dec.stream_graphs.replays > 0
    for t, h in pool.items():
        used = spy.keys[t]
        assert counts(h) == (len(used), sum(n >= 2 for n in used.values()),
                             sum(used.values()) - len(used)), t
