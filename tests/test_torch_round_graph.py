"""Rounds replayed through ops/round_graph.RoundGraphs, on the CPU.

DeviceBatchDecoder and DevicePCMBatchDecoder replay every round through
RoundGraphs by default. On the CPU its stand-in records the round's
callable and calls it again at each replay on the same static buffers,
writing into the same static outputs, so these tests go through the
keying, the copies into the static inputs and the clones out of the
static outputs. Against the JAX package's drivers (their jitted rounds):
the WAVs byte for byte; against the eager route (graphs=False): every
round's buffer, words, tails and carries. Also: which outputs must be
copies (words_flat, read by a lazy store rounds later; `out`, copied to
the host before the next replay), the keying, K1's launch counter under
capture and replay, and that a round uploads nothing.
"""
import os

import numpy as np
import pytest
import torch

import chip_smoke
from sdvpcmdecoder_tpu.pipeline import device_driver as jdd
from sdvpcmdecoder_tpu.pipeline import device_pcm as jdp
from sdvpcmdecoder_tpu_torch.ops import device_pcm as tdpo
from sdvpcmdecoder_tpu_torch.ops import device_stitch as ds
from sdvpcmdecoder_tpu_torch.ops import fused_binarize as fb
from sdvpcmdecoder_tpu_torch.ops.round_graph import RoundGraphs
from sdvpcmdecoder_tpu_torch.pipeline import device_driver as tdd
from sdvpcmdecoder_tpu_torch.pipeline import device_pcm as tdp
from sdvpcmdecoder_tpu_torch.pipeline import stitcher_stc007 as tst
from sdvpcmdecoder_tpu_torch.synth import encoder as enc
from sdvpcmdecoder_tpu_torch.utils import host

torch.set_num_threads(1)

STC_KW = dict(lines_per_field=294, hyst_limit=2, shift_limit=1,
              frames_per_round=5)


def run(cls, caps, tmp, tag, **kw):
    dec = cls([(c, os.path.join(tmp, f"{tag}_{k}.wav"))
               for k, c in enumerate(caps)], **kw)
    dec.run()
    return [open(j.out_path, "rb").read() for j in dec.jobs], dec


def record_rounds(monkeypatch, module):
    """Copies of what every module.run_round returns, taken as it returns
    (under a graph, `out` is the graph's own buffer)."""
    rounds = []
    orig = module.run_round

    def spy(*a, **k):
        res = orig(*a, **k)
        ts = [res] if isinstance(res, torch.Tensor) \
            else [res[0], res[1], *res[2]]
        rounds.append([t.clone() for t in ts])
        return res

    monkeypatch.setattr(module, "run_round", spy)
    return rounds


def assert_rounds_equal(got, expect):
    assert len(got) == len(expect)
    for r, (g, e) in enumerate(zip(got, expect)):
        for k, (a, b) in enumerate(zip(g, e)):
            assert a.dtype == b.dtype and torch.equal(a, b), (r, k)


def assert_counts(graphs, n_rounds):
    """Every round is its key's eager first use or a replay; every key
    used twice was captured once."""
    keys = graphs._graphs
    assert graphs.eager_rounds == len(keys)
    assert graphs.replays == n_rounds - graphs.eager_rounds
    assert graphs.captures == sum(v is not None for v in keys.values())


def test_stc007_driver_through_graphs_writes_jax_wav(tmp_path, monkeypatch):
    """Two noisy PAL captures (sigma 24) x 22 frames, 5 a round: 5 rounds
    each, chained, the last one short (2 frames), the two captures' rounds
    replaying the same graphs in turns, fallback frames re-decoded. A
    fallback pair materializes a lazy store after two later rounds have
    replayed: with words_flat not cloned it reads another round's words;
    with `out` taken by reference instead of by HostCopy's copy the
    round's facts are another round's."""
    tmp = str(tmp_path)
    caps = [chip_smoke.write_capture(os.path.join(tmp, f"c{i}.y4m"), 22,
                                     294, seed=3 + 10 * i, noise=24.0)
            for i in range(2)]
    ref, _ = run(jdd.DeviceBatchDecoder, caps, tmp, "jax", **STC_KW)

    rounds = record_rounds(monkeypatch, tdd)
    later = []
    orig_lazy = tst.LineStore._set_lazy_words

    def lazy(self, fetch):
        n0 = len(rounds)

        def counted():
            later.append(len(rounds) - n0)
            return fetch()
        orig_lazy(self, counted)

    monkeypatch.setattr(tst.LineStore, "_set_lazy_words", lazy)
    got, dec = run(tdd.DeviceBatchDecoder, caps, tmp, "graph", device="cpu",
                   **STC_KW)
    graph_rounds = list(rounds)
    rounds.clear()
    eager, dec_e = run(tdd.DeviceBatchDecoder, caps, tmp, "eager",
                       device="cpu", graphs=False, **STC_KW)
    assert got == ref and eager == ref
    assert dec_e.graphs is None
    assert_rounds_equal(graph_rounds, rounds)
    assert_counts(dec.graphs, 10)
    assert dec.graphs.captures >= 2 and dec.graphs.replays >= 5
    assert [r[1].shape[0] for r in graph_rounds[-2:]] == [2 * 588] * 2
    assert sum(sum(j.round_chained) for j in dec.jobs) >= 4
    assert all(j.driver.fallback_batches > 0 for j in dec.jobs)
    assert max(later) >= 2, later

    monkeypatch.setattr(tdd, "KEPT_OUTPUTS",
                        tuple(k for k in tdd.KEPT_OUTPUTS if k != 1))
    stale, _ = run(tdd.DeviceBatchDecoder, caps, tmp, "stale", device="cpu",
                   **STC_KW)
    assert stale != ref
    monkeypatch.undo()

    def by_reference(self, t):
        self._event, self._host = None, t

    monkeypatch.setattr(host.HostCopy, "__init__", by_reference)
    shared, _ = run(tdd.DeviceBatchDecoder, caps, tmp, "shared",
                    device="cpu", **STC_KW)
    assert shared != ref


@pytest.mark.parametrize("fmt,noise", [("pcm1", 30.0), ("pcm16x0", 26.0)])
def test_pcm_driver_through_graphs_writes_jax_wav(tmp_path, monkeypatch,
                                                  fmt, noise):
    """Two noisy captures x 7 frames, 3 a round, whose failed lines are
    refined on the host: the JAX package's WAVs, and every round's buffer
    equal to the eager route's. Each capture's short last round (1 frame)
    is a key of its own, captured when the second capture repeats it."""
    caps = [chip_smoke.write_pcm_noisy(str(tmp_path / f"{fmt}{i}.y4m"), fmt,
                                       7, 40 + i, noise) for i in range(2)]
    kw = dict(fmt=fmt, shift_limit=1, frames_per_round=3)
    tmp = str(tmp_path)
    ref, _ = run(jdp.DevicePCMBatchDecoder, caps, tmp, "jax", **kw)
    rounds = record_rounds(monkeypatch, tdp)
    got, dec = run(tdp.DevicePCMBatchDecoder, caps, tmp, "graph",
                   device="cpu", **kw)
    graph_rounds = list(rounds)
    rounds.clear()
    eager, dec_e = run(tdp.DevicePCMBatchDecoder, caps, tmp, "eager",
                       device="cpu", graphs=False, **kw)
    assert got == ref and eager == ref
    assert dec_e.graphs is None and dec.fetch_copies > 0
    assert_rounds_equal(graph_rounds, rounds)
    assert_counts(dec.graphs, 6)
    assert (dec.graphs.eager_rounds, dec.graphs.captures,
            dec.graphs.replays) == (2, 2, 4)


# -- run_round itself: small PAL-width rounds ---------------------------------
F, LF, W = 2, 120, 1152


def small_rounds(n_frames, seed=0):
    """Frames of LF lines (two 60-line fields) and their coordinates."""
    rng = np.random.default_rng(seed)
    n = 3 * n_frames * LF
    left, right = rng.integers(0, 1 << 14, (2, n))
    pixels, coords, *_ = enc.encode_stream(
        left, right, width=W, ppb=8.0, n_lines=n_frames * LF,
        noise_sigma=10.0, rng=rng)
    return (torch.from_numpy(pixels.reshape(n_frames, LF, W)),
            coords[::LF])


def params_for(coords):
    n_f = coords.shape[0]
    o, n_par = ds.round_param_layout(n_f)
    params = np.zeros(n_par, np.int32)
    params[o["coords"]:o["coords"] + 2 * n_f] = coords.ravel()
    for key, v in (("refs", 110), ("blacks", 20), ("whites", 200),
                   ("usable", 1)):
        params[o[key]:o[key] + n_f] = v
    params[o["pred_mode"]] = 1
    params[o["unch_lim"]] = 3
    return params


class Rounds:
    """run_round over consecutive slices of one capture, eagerly and
    through `graphs`, with each route's state carried."""

    def __init__(self, graphs, use_kernel=False):
        self.px, self.cd = small_rounds(8)
        self.tables = ds.RoundTables()
        self.rows = {}
        self.graphs = graphs
        self.use_kernel = use_kernel
        self.state = {r: tdd.RoundState.zeros(LF, "cpu")
                      for r in ("graph", "eager")}

    def __call__(self, lo, n_f, chained, route="graph"):
        key = (n_f, chained)
        if key not in self.rows:
            self.rows[key] = tdd._RoundRows(
                n_f, LF // 2, 112 if chained else 0, 0, 0, LF // 2, True,
                device="cpu")
        out, wflat, self.state[route] = tdd.run_round(
            self.px[lo:lo + n_f], params_for(self.cd[lo:lo + n_f]),
            self.state[route], self.rows[key], en_p=True, en_q=True,
            m2=False, hyst_limit=4, shift_limit=2,
            use_kernel=self.use_kernel, chained=chained, tables=self.tables,
            graphs=self.graphs if route == "graph" else None)
        return [out, wflat, *self.state[route]]

    def both(self, lo, n_f, chained):
        """The graph route's outputs, checked against the eager route's."""
        got = self(lo, n_f, chained)
        expect = self(lo, n_f, chained, route="eager")
        for a, b in zip(got, expect):
            assert a.dtype == b.dtype and torch.equal(a, b)
        return got


def counts(g):
    return g.eager_rounds, g.captures, g.replays


def test_graph_keys_and_outputs():
    """A repeated key is captured once, on its second use; a chained
    round and a short round are keys of their own, each eager on its
    first use; the kept outputs are copies and `out` is the graph's
    buffer, which the next replay of the key writes over."""
    g = RoundGraphs("cpu")
    rr = Rounds(g)
    rr.both(0, F, chained=False)
    assert counts(g) == (1, 0, 0)
    first = rr.both(2, F, chained=False)
    assert counts(g) == (1, 1, 1)
    kept = [t.clone() for t in first]
    rr.both(4, F, chained=False)
    assert counts(g) == (1, 1, 2)
    assert not torch.equal(first[0], kept[0])   # out: overwritten
    for a, b in zip(first[1:], kept[1:]):       # words_flat, state: copies
        assert torch.equal(a, b)
    rr.both(6, F, chained=True)
    assert counts(g) == (2, 1, 2)
    rr.both(6, 1, chained=True)                 # a short last round
    assert counts(g) == (3, 1, 2)
    rr.both(4, F, chained=True)
    assert counts(g) == (3, 2, 3)


def test_k1_counts_replays_not_captures(monkeypatch):
    """K1's counter through a graph: one launch per round, eager, captured
    or replayed, and none for the capture itself."""
    wrapper = fb.stc007_fused_decode_frames

    def counting(*a, **k):   # the wrapper on CPU tensors counts nothing
        res = wrapper(*a, **k)
        fb._count(wrapper)
        return res

    monkeypatch.setattr(fb, "stc007_fused_decode_frames", counting)
    monkeypatch.setattr(wrapper, "launches", 0)
    g = RoundGraphs("cpu")
    rr = Rounds(g, use_kernel=True)
    for r in range(4):
        rr(2 * r, F, chained=False)
        assert wrapper.launches == r + 1, (r, counts(g))
    assert counts(g) == (1, 1, 3)
    (captured,) = [v for v in g._graphs.values() if v is not None]
    assert captured.tally == {wrapper: 1}


def test_rounds_upload_nothing(tmp_path, monkeypatch):
    """Once a round's tables are on the device, its body turns no host
    data into a tensor: a capture would refuse the upload, and an eager
    upload from pageable memory waits for the device."""
    rr = Rounds(RoundGraphs("cpu"))
    cap = chip_smoke.write_pcm1_capture(str(tmp_path / "p1.y4m"),
                                        n_frames=3)
    px, *levels = chip_smoke.pcm_grid_inputs(cap, "pcm1", "cpu")
    params = chip_smoke.pcm_round_params(*levels).numpy()

    def pcm_round(graphs=None):
        return tdp.run_round(px, params, fmt="pcm1", shift_limit=2,
                             hyst_limit=0, graphs=graphs)

    # The first rounds on a device put its tables there, once.
    warm = Rounds(None)
    warm(0, F, False, route="eager")
    warm(2, F, True, route="eager")
    expect = pcm_round()

    made = []
    active = [False]
    for name in ("as_tensor", "tensor", "from_numpy"):
        orig = getattr(torch, name)

        def spy(data, *a, _orig=orig, _name=name, **k):
            if active[0] and not isinstance(data, torch.Tensor):
                made.append((_name, type(data).__name__))
            return _orig(data, *a, **k)
        monkeypatch.setattr(torch, name, spy)
    for mod, name in ((ds, "steady_round_packed"),
                      (tdpo, "pcm_round_packed")):
        body = getattr(mod, name)

        def watched(*a, _body=body, **k):
            active[0] = True
            try:
                return _body(*a, **k)
            finally:
                active[0] = False
        monkeypatch.setattr(mod, name, watched)

    for r in range(4):
        rr.both(2 * r, F, chained=r > 0)
    g = RoundGraphs("cpu")
    for _ in range(3):
        assert torch.equal(pcm_round(g), expect)
    assert counts(rr.graphs) == (2, 1, 2) and counts(g) == (1, 1, 2)
    assert made == []


def test_failed_capture_raises_and_nothing_runs_eagerly():
    """A round that raises while its key is captured: the error reaches
    the caller, nothing is counted as captured or replayed, and the next
    use of the key tries the capture again."""
    g = RoundGraphs("cpu")
    calls = []

    def body(x):
        calls.append(len(calls))
        if len(calls) >= 2:
            raise RuntimeError("refused in capture")
        return (x + 1,)

    x = torch.zeros(3)
    assert torch.equal(g.run("k", body, (x,))[0], x + 1)
    for _ in range(2):
        with pytest.raises(RuntimeError, match="refused in capture"):
            g.run("k", body, (x,))
        assert counts(g) == (1, 0, 0)
    with pytest.raises(ValueError, match="unsupported"):
        RoundGraphs("meta")
