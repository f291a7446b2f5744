"""The streaming backend's device calls and the stream chain replayed
through ops/round_graph.RoundGraphs, on the CPU.

The JAX package compiles each of these once per shape with jax.jit: the
STC-007 batch grid (J1, with the marker fallback's 64 x 1 batches), the
PCM-1 and PCM-16x0 grids (J2, J3), decode_stream (J4), decode_frames
(J5) and the reference-level sweep (its lax.scan). The port replays each
as a CUDA graph; on the CPU the graph's stand-in re-calls the recorded
body on the same static buffers, so these tests go through the keying,
the copies in and the clones out. Each site's graph route
(graphs=True) equals its eager route (graphs=False) and the JAX
function, values and dtypes; also: two calls before the first read,
the keying of a padded tail batch and of a new shape, K1's counter under
replay (64 a sweep), the batch driver's WAVs and the chip-resident
driver's two graph holders.
"""
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import chip_smoke
from test_torch_sweep import dimmed
from sdvpcmdecoder_tpu.ops import binarize as jbz
from sdvpcmdecoder_tpu.pipeline import batch_driver as jbd
from sdvpcmdecoder_tpu.pipeline import decoder as jdecoder
from sdvpcmdecoder_tpu.pipeline import device_driver as jdd
from sdvpcmdecoder_tpu.pipeline import v2d as jv2d
from sdvpcmdecoder_tpu.pipeline import v2d_other as jv2o
from sdvpcmdecoder_tpu_torch.ops import binarize as tbz
from sdvpcmdecoder_tpu_torch.ops import deinterleave as di
from sdvpcmdecoder_tpu_torch.ops import fused_binarize as fb
from sdvpcmdecoder_tpu_torch.ops import round_graph
from sdvpcmdecoder_tpu_torch.ops.round_graph import RoundGraphs
from sdvpcmdecoder_tpu_torch.parallel import mesh as pm
from sdvpcmdecoder_tpu_torch.pipeline import batch_driver as tbd
from sdvpcmdecoder_tpu_torch.pipeline import decoder
from sdvpcmdecoder_tpu_torch.pipeline import device_driver as tdd
from sdvpcmdecoder_tpu_torch.pipeline import v2d as tv2d
from sdvpcmdecoder_tpu_torch.pipeline import v2d_other as tv2o
from sdvpcmdecoder_tpu_torch.synth import encoder as enc
from sdvpcmdecoder_tpu_torch.utils import host

torch.set_num_threads(1)

W = 1152
F, L = 3, 64          # 3 frames x 32 lines a field


def frames(seed, n_frames=F, sigma=24.0, coords=False):
    """[n_frames, L, W] noisy frames with a few lines shifted sideways
    (the marker fallback re-finds them) and a few dimmed (the sweep's
    case); with `coords`, also each frame's coordinates [n_frames, 2]."""
    rng = np.random.default_rng(seed)
    n = 3 * n_frames * L
    px, cd, *_ = enc.encode_stream(
        rng.integers(1, 1 << 14, n), rng.integers(1, 1 << 14, n), width=W,
        ppb=8.0, n_lines=n_frames * L, noise_sigma=sigma, rng=rng)
    px = px.reshape(n_frames, L, W).copy()
    for f in range(n_frames):
        px[f, 3 + f] = np.roll(px[f, 3 + f], 9)
        px[f] = dimmed(px[f], [7, L - 4], lo=12, hi=110)
    return (px, cd[::L].astype(np.int32)) if coords else px


@pytest.fixture(autouse=True)
def fresh_holders(monkeypatch):
    """The streaming drivers and the stream chain replay from the
    thread's holder (round_graph.thread_graphs): each test starts with
    none, so its first call of a key is the eager one."""
    monkeypatch.setattr(round_graph, "_THREAD", type(round_graph._THREAD)())
    monkeypatch.setattr(decoder, "_HELD", type(decoder._HELD)())


def counts(g):
    return g.eager_rounds, g.captures, g.replays


def assert_arrays_equal(got, expect):
    assert len(got) == len(expect)
    for k, (a, b) in enumerate(zip(got, expect)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (k, a.dtype,
                                                           b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=str(k))


def v2d_pair(**kw):
    """The same V2DDriver through graphs and eagerly, and the JAX one."""
    kw.setdefault("hyst_limit", 2)
    kw.setdefault("shift_limit", 1)
    return (tv2d.V2DDriver(device="cpu", **kw),
            tv2d.V2DDriver(device="cpu", graphs=False, **kw),
            jv2d.V2DDriver(**{k: v for k, v in kw.items()
                              if k != "use_kernel"}))


def dispatched(drv, px):
    """prepare + dispatch + materialize, the batch driver's split."""
    prep = drv.prepare_frames(px)
    return drv.materialize_frames(px, prep,
                                  drv.dispatch_frames_async(px, prep))


# -- J1: the batch's trial grid ----------------------------------------------

@pytest.mark.parametrize("per_line", [False, True])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_dispatch_graph_equals_eager_and_jax(use_kernel, per_line):
    """Three batches of one shape: the key's eager first use, its capture
    and a replay, each equal to the eager route's and the JAX driver's
    materialized words (int16), CRCs (uint16) and flags."""
    g, e, j = v2d_pair(use_kernel=use_kernel, per_line_agc=per_line)
    for seed in (1, 2, 3):
        px = frames(seed)
        got = dispatched(g, px)
        assert_arrays_equal(got, dispatched(e, px))
        assert_arrays_equal(got, dispatched(j, px))
    assert got[0].dtype == np.int16 and got[1].dtype == np.uint16
    assert counts(g.graphs) == (1, 1, 2) and e.graphs is None


def test_two_dispatches_before_the_first_materialize(monkeypatch):
    """The batch driver dispatches round k+1 before it materializes round
    k: both replays of one key give the eager results, because words, CRC
    and flags leave by HostCopy at dispatch and crc_calc, hyst and shift
    are copies. Taken by reference instead, round k reads round k+1's."""
    g, e, _ = v2d_pair()
    warm = frames(9)
    for drv in (g, e):
        dispatched(drv, warm), dispatched(drv, warm)   # eager, capture
    pxs = [frames(s) for s in (4, 5)]
    preps = [g.prepare_frames(px) for px in pxs]
    batches = [g.dispatch_frames_async(px, p) for px, p in zip(pxs, preps)]
    words = []
    for px, p, b in zip(pxs, preps, batches):
        got = g.materialize_frames(px, p, b)
        ep = e.prepare_frames(px)
        eb = e.dispatch_frames_async(px, ep)
        assert_arrays_equal(got, e.materialize_frames(px, ep, eb))
        words.append(got[0])
        for name in ("crc_calc", "hyst", "shift"):
            assert torch.equal(getattr(b, name), getattr(eb, name)), name
    assert counts(g.graphs) == (1, 1, 3)

    def by_reference(self, t):
        self._event, self._host = None, t

    monkeypatch.setattr(host.HostCopy, "__init__", by_reference)
    batches = [g.dispatch_frames_async(px, p) for px, p in zip(pxs, preps)]
    stale = g.materialize_frames(pxs[0], preps[0], batches[0])
    assert not np.array_equal(stale[0], words[0])
    assert np.array_equal(stale[0], words[1])   # round k+1's words


def test_padded_tail_replays_and_a_new_shape_runs_eagerly_first():
    """The CLI pads its tail batch to --batch, as the JAX package does
    for its one compiled shape: the padded tail replays the batch's
    graph. A shape seen for the first time runs eagerly; its second use
    captures."""
    g, e, _ = v2d_pair()
    px = frames(6)
    for drv in (g, e):
        dispatched(drv, px), dispatched(drv, px)
    assert counts(g.graphs) == (1, 1, 1)
    tail = frames(7, n_frames=2)
    padded = np.concatenate([tail, np.zeros((1, L, W), np.uint8)])
    assert_arrays_equal(dispatched(g, padded), dispatched(e, padded))
    assert counts(g.graphs) == (1, 1, 2)
    for k in range(2):
        assert_arrays_equal(dispatched(g, tail), dispatched(e, tail))
    assert counts(g.graphs) == (2, 2, 3)


def test_marker_fallback_and_decode_frame_through_graphs():
    """The marker fallback's FALLBACK_BUCKET x 1 batches and the single
    frame decode share the grid's graph body ("grid" keys): the graph
    route's FrameDecodeResults equal the eager route's and the JAX
    driver's, and the bucket's key replays."""
    from test_torch_sweep import assert_result_equal
    g, e, j = v2d_pair(hyst_limit=4, shift_limit=2)
    for seed in (11, 12, 13):
        px = frames(seed)
        got = g.decode_frames(px)
        for a, b, c in zip(got, e.decode_frames(px), j.decode_frames(px)):
            assert_result_equal(a, b)
            assert_result_equal(a, c)
        one = g.decode_frame(px[0])
        assert_result_equal(one, e.decode_frame(px[0]))
        assert_result_equal(one, j.decode_frame(px[0]))
    assert g.fallback_batches == e.fallback_batches > 3
    keys = [k for k in g.graphs._graphs if k[0][0] == "grid"]
    assert {k[1][0][0][0] for k in keys} == {1, g.FALLBACK_BUCKET}
    assert g.graphs.replays >= g.fallback_batches - 1


def test_failed_capture_raises_and_nothing_runs_eagerly(monkeypatch):
    """A dispatch whose capture raises reaches the caller; the driver
    does not carry on eagerly and counts no capture."""
    g, _, _ = v2d_pair()
    px = frames(8)
    dispatched(g, px)
    orig = g._dispatch_body

    def refused(*a):
        raise RuntimeError("refused in capture")

    monkeypatch.setattr(g, "_dispatch_body", refused)
    with pytest.raises(RuntimeError, match="refused in capture"):
        dispatched(g, px)
    assert counts(g.graphs) == (1, 0, 0)
    monkeypatch.setattr(g, "_dispatch_body", orig)
    dispatched(g, px)
    assert counts(g.graphs) == (1, 1, 1)


# -- the sweep ---------------------------------------------------------------

def sweep_inputs(seed, n_frames=F):
    px, cd = frames(seed, n_frames=n_frames, sigma=30.0, coords=True)
    return px, cd, np.full(n_frames, 20), np.full(n_frames, 200)


def sweep_arrays(sw):
    return [sw.valid, sw.crc, sw.hyst, sw.shift, sw.words.numpy()]


@pytest.mark.parametrize("limits,n_frames", [((2, 1), F), ((10, 4), 1)])
def test_sweep_graph_equals_eager_and_jax(limits, n_frames):
    """V2DDriver._sweep_decode (64 levels) through its graph: the key's
    eager use, capture and replay equal the eager route and the JAX
    package's sweep (its lax.scan) on every field; INSANE's limits on
    one frame."""
    g, e, _ = v2d_pair(hyst_limit=limits[0], shift_limit=limits[1],
                       use_kernel=True)
    levels = np.arange(254, 1, -4, dtype=np.int32)
    for seed in (21, 22, 23):
        px, cd, bk, wt = sweep_inputs(seed, n_frames)
        got = sweep_arrays(g._sweep_decode(px, cd, bk, wt))
        assert_arrays_equal(got, sweep_arrays(e._sweep_decode(px, cd, bk,
                                                              wt)))
        ref = jbz.stc007_ref_sweep_decode(
            jnp.asarray(px), jnp.asarray(cd, jnp.int32),
            jnp.asarray(bk, jnp.int32), jnp.asarray(wt, jnp.int32),
            jnp.asarray(levels), hyst_limit=limits[0],
            shift_limit=limits[1])
        R, N = len(levels), px.shape[0] * L
        assert_arrays_equal(got, [np.asarray(ref[k]).reshape(R, N, -1)
                                  .squeeze(-1) if k != "words"
                                  else np.asarray(ref[k]).reshape(R, N, 8)
                                  for k in ("valid", "crc", "hyst", "shift",
                                            "words")])
    assert counts(g.graphs) == (1, 1, 2) and g.sweep_calls == 3


def test_two_sweeps_before_the_first_words_read(monkeypatch):
    """A sweep's words stay on the device until the caller picks a level
    per line; they are a copy, so a second sweep's replay before the
    read leaves them as they were. Left as the graph's buffer, the first
    sweep's words read the second's."""
    g, e, _ = v2d_pair(hyst_limit=1, shift_limit=0)
    warm = sweep_inputs(30, n_frames=1)
    g._sweep_decode(*warm), g._sweep_decode(*warm)
    ins = [sweep_inputs(s, n_frames=1) for s in (31, 32)]
    sws = [g._sweep_decode(*a) for a in ins]
    for sw, a in zip(sws, ins):
        assert_arrays_equal(sweep_arrays(sw), sweep_arrays(
            e._sweep_decode(*a)))
    orig = RoundGraphs.run

    def no_clone(self, key, fn, inputs, clone=()):
        return orig(self, key, fn, inputs)

    monkeypatch.setattr(RoundGraphs, "run", no_clone)
    sws = [g._sweep_decode(*a) for a in ins]
    assert not torch.equal(sws[0].words, e._sweep_decode(*ins[0]).words)


def test_sweep_counts_64_k1_launches_per_replay(monkeypatch):
    """K1's counter through the sweep's graph: 64 launches a call, eager,
    captured or replayed, and none for the capture itself. (On the CPU
    the sweep's wrapper runs the plain sweep; here it also counts the
    launches K1 would make.)"""
    wrapper = fb.stc007_fused_decode_frames
    plain = tbz.stc007_ref_sweep_decode

    def counting(*a, **k):
        res = plain(*a, **k)
        for _ in range(res["valid"].shape[0]):
            fb._count(wrapper)
        return res

    monkeypatch.setattr(tbz, "stc007_ref_sweep_decode", counting)
    monkeypatch.setattr(wrapper, "launches", 0)
    g, _, _ = v2d_pair(use_kernel=True)
    for r in range(4):
        g._sweep_decode(*sweep_inputs(40 + r, n_frames=1))
        assert wrapper.launches == 64 * (r + 1), (r, counts(g.graphs))
    assert counts(g.graphs) == (1, 1, 3)
    (captured,) = [v for v in g.graphs._graphs.values() if v is not None]
    assert captured.tally == {wrapper: 64}


# -- J2, J3: the PCM grids ---------------------------------------------------

@pytest.mark.parametrize("fmt", ["pcm1", "pcm16x0"])
def test_pcm_grid_graph_equals_eager_and_jax(tmp_path, fmt):
    """PCMFrameDriver's "tpu" grid: three batches of one shape (eager,
    capture, replay) and a shorter one (a key of its own, eager) equal
    the eager route and the JAX driver's jitted grid, dtypes included."""
    writer = {"pcm1": chip_smoke.write_pcm1_capture,
              "pcm16x0": chip_smoke.write_pcm16x0_capture}[fmt]
    from sdvpcmdecoder_tpu_torch.pipeline import ingest
    cap = writer(str(tmp_path / f"{fmt}.y4m"), n_frames=6, seed=7)
    with ingest.open_capture(cap) as rd:
        lines, _ = ingest.split_fields_batch(rd.read_frames(0, 6))
    lines = np.ascontiguousarray(lines[:, :L])
    kw = dict(shift_limit=1, hyst_limit=1, backend="tpu")
    g = tv2o.PCMFrameDriver(fmt, device="cpu", **kw)
    e = tv2o.PCMFrameDriver(fmt, device="cpu", graphs=False, **kw)
    j = jv2o.PCMFrameDriver(fmt, **kw)
    prep = g.prepare_frames(lines)
    assert prep["usable"].all()
    for sl in (slice(0, 3), slice(3, 6), slice(0, 3), slice(1, 3)):
        px = lines[sl]
        sub = {k: v[sl] for k, v in prep.items()}
        got = [a for a in g._decode_batch(px, sub) if a is not None]
        assert_arrays_equal(got, [a for a in e._decode_batch(px, sub)
                                  if a is not None])
        assert_arrays_equal(got, [a for a in j._decode_batch(px, sub)
                                  if a is not None])
    assert counts(g.graphs) == (2, 1, 2)


# -- J4, J5: the stream chain ------------------------------------------------

def stream_lines(seed, n_lines=176):
    """Per-line inputs of decode_stream: noisy lines, jittered coordinates
    and per-line levels."""
    rng = np.random.default_rng(seed)
    n = 3 * n_lines
    pixels, coords, _, _ = enc.encode_stream(
        rng.integers(1, 1 << 14, n), rng.integers(1, 1 << 14, n), width=W,
        ppb=8.0, n_lines=n_lines, noise_sigma=34.0, rng=rng)
    coords = (coords + rng.integers(-2, 3, coords.shape)).astype(np.int32)
    levels = [rng.integers(lo, hi, n_lines).astype(np.int32)
              for lo, hi in ((95, 125), (10, 30), (185, 215))]
    return [pixels, coords] + levels


@pytest.mark.parametrize("use_kernel", [False, True])
def test_decode_stream_graph_equals_eager_and_jax(use_kernel):
    """decode_stream through this thread's holder on the CPU: the key's
    eager use, capture and replays equal the eager route and the JAX
    package's jitted decode_stream (its per-line grid), dtypes included;
    two calls before the first read keep their own results."""
    g = round_graph.thread_graphs("cpu")
    before = counts(g)
    ins = [stream_lines(s) for s in (1, 2, 3, 4)]
    kw = dict(hyst_limit=2, shift_limit=1, use_kernel=use_kernel)
    got = [decoder.decode_stream(*map(torch.from_numpy, a), **kw)
           for a in ins]
    for a, r in zip(ins, got):
        e = decoder.decode_stream(*map(torch.from_numpy, a), graphs=False,
                                  **kw)
        j = jdecoder.decode_stream(*map(jnp.asarray, a), hyst_limit=2,
                                   shift_limit=1)
        assert_arrays_equal([t.numpy() for t in r], [t.numpy() for t in e])
        assert_arrays_equal([t.numpy() for t in r], list(j))
    assert 0 < int(got[0].line_valid.sum()) < 176
    assert tuple(x - y for x, y in zip(counts(g), before)) == (1, 1, 3)


@pytest.mark.parametrize("res_mode", [di.RES_MODE_14BIT,
                                      di.RES_MODE_16BIT_AUTO])
def test_decode_frames_graph_equals_eager_and_jax(res_mode):
    """decode_frames keeps one StreamDecoder per static arguments: its
    replays equal the eager route and the JAX package's jitted
    decode_frames (use_pallas=False, its plain grid)."""
    g = round_graph.thread_graphs("cpu")
    before = counts(g)
    lv = [torch.tensor([110, 104], dtype=torch.int32),
          torch.tensor([5, 20], dtype=torch.int32),
          torch.tensor([250, 200], dtype=torch.int32)]
    ins = []
    for seed in (5, 6, 7):
        px, cd = frames(seed, n_frames=2, sigma=36.0, coords=True)
        ins.append((torch.from_numpy(px), torch.from_numpy(cd), *lv))
    got = [decoder.decode_frames(*a, res_mode=res_mode) for a in ins]
    for a, r in zip(ins, got):
        e = decoder.decode_frames(*a, res_mode=res_mode, graphs=False)
        j = jdecoder.decode_frames(*(jnp.asarray(t.numpy()) for t in a),
                                   res_mode=res_mode, use_pallas=False)
        assert_arrays_equal([t.numpy() for t in r], [t.numpy() for t in e])
        assert_arrays_equal([t.numpy() for t in r], list(j))
    assert not bool(got[0].line_valid.all())
    assert tuple(x - y for x, y in zip(counts(g), before)) == (1, 1, 2)


def test_stream_decoder_module_graphs():
    """StreamDecoder(graphs=True) replays from the thread's holder on the
    pixels' device; graphs=False runs eagerly."""
    a = decoder.StreamDecoder(2, 1)
    b = decoder.StreamDecoder(2, 1, graphs=False)
    px, cd = frames(8, n_frames=2, coords=True)
    args = (torch.from_numpy(px), torch.from_numpy(cd),
            *(torch.full((2,), v, dtype=torch.int32) for v in (110, 20, 200)))
    for _ in range(3):
        for x, y in zip(a(*args), b(*args)):
            assert x.dtype == y.dtype and torch.equal(x, y)
    assert counts(round_graph.thread_graphs("cpu")) == (1, 1, 2)
    assert a.graphs is True and b.graphs is False


def test_mesh_step_replays_decode_stream():
    """The mesh step's chunks on one device share decode_stream's graph:
    two steps, graph route == eager route."""
    n_lines = 2 * pm.HALO + 112
    px, cd, *lv = stream_lines(9, n_lines)
    S = 2
    chunks, _ = pm.chunk_lines_with_halo(px, S)
    cds, _ = pm.chunk_lines_with_halo(cd, S)
    Lc = chunks.shape[1]
    per = [chunks[None], cds[None]] + [np.full((1, S, Lc), v, np.int32)
                                      for v in (110, 20, 200)]
    grid = pm.decode_mesh(S, seq=S, devices=["cpu"])
    g = round_graph.thread_graphs("cpu")
    before = counts(g)
    outs = {}
    for graphs in (True, False):
        step = pm.multichip_decode_step(grid, 1, 1, graphs=graphs)
        for _ in range(2):
            outs[graphs] = step(*(pm.shard_captures(a, grid) for a in per))
    for a, b in zip(outs[True][0][0], outs[False][0][0]):
        assert torch.equal(a, b)
    assert int(outs[True][1][0][0]) == int(outs[False][1][0][0]) > 0
    assert tuple(x - y for x, y in zip(counts(g), before)) == (1, 1, 3)


# -- the drivers -------------------------------------------------------------

def run_decoder(cls, caps, tmp, tag, **kw):
    dec = cls([(c, os.path.join(tmp, f"{tag}_{k}.wav"))
               for k, c in enumerate(caps)], **kw)
    dec.run()
    return [open(j.out_path, "rb").read() for j in dec.jobs], dec


QUALITIES = {
    "fast": dict(hyst_limit=1, shift_limit=1),
    "normal": dict(hyst_limit=4, shift_limit=2, ref_sweep_fallback=True,
                   normal_sweep_prescan=True),
    "insane": dict(hyst_limit=2, shift_limit=1, ref_sweep=True,
                   normal_sweep_prescan=True),
}


@pytest.mark.parametrize("quality", list(QUALITIES))
def test_run_tpu_wavs_equal_jax_under_both_routes(tmp_path, quality):
    """BatchDecoder.run_tpu over two captures (3 and 2 frames of 48 lines
    a field, 1 a round: two fused rounds, then one capture's tail alone),
    round k+1 dispatched before round k is read: graphs=True and False
    write the JAX package's WAVs. Every driver replays from the thread's
    holder, the decoder's stream_graphs, where the fused round replays;
    a second decoder of the thread runs no key eagerly."""
    tmp = str(tmp_path)
    caps = [chip_smoke.write_capture(os.path.join(tmp, f"c{i}.y4m"), n,
                                     48, seed=60 + i, noise=30.0)
            for i, n in enumerate((3, 2))]
    kw = dict(QUALITIES[quality], frames_per_round=1, lines_per_field=None,
              backend="tpu")
    ref, _ = run_decoder(jbd.BatchDecoder, caps, tmp, "jax", **kw)
    got, dec = run_decoder(tbd.BatchDecoder, caps, tmp, "graph",
                           device="cpu", **kw)
    eager, dec_e = run_decoder(tbd.BatchDecoder, caps, tmp, "eager",
                               device="cpu", graphs=False, **kw)
    assert got == ref and eager == ref and len(ref[0]) > 44
    g = dec.stream_graphs
    assert dec_e.stream_graphs is None and g is round_graph.thread_graphs(
        "cpu")
    assert all(j.driver.graphs is g for j in dec.jobs)
    assert g.replays > 0 and g.eager_rounds == len(g._graphs)
    seen = counts(g)
    again, _ = run_decoder(tbd.BatchDecoder, caps, tmp, "again",
                           device="cpu", **kw)
    assert again == ref and counts(g)[0] == seen[0]   # no eager call
    if quality != "fast":
        assert sum(j.driver.sweep_calls for j in dec.jobs) > 0


@pytest.mark.parametrize("fmt", ["pcm1", "pcm16x0"])
def test_pcm_batch_decoder_wavs_equal_jax_under_both_routes(tmp_path, fmt):
    """The PCM round loop with its grid on the device ("tpu"): both
    routes write the JAX package's WAV; the grid's key replays."""
    tmp = str(tmp_path)
    cap = chip_smoke.write_pcm_noisy(os.path.join(tmp, f"{fmt}.y4m"), fmt,
                                     5, 41, {"pcm1": 30.0,
                                             "pcm16x0": 26.0}[fmt])
    kw = dict(fmt=fmt, hyst_limit=0, shift_limit=1, frames_per_round=2,
              backend="tpu")
    ref, _ = run_decoder(jbd.BatchDecoder, [cap], tmp, "jax", **kw)
    got, dec = run_decoder(tbd.BatchDecoder, [cap], tmp, "graph",
                           device="cpu", **kw)
    eager, _ = run_decoder(tbd.BatchDecoder, [cap], tmp, "eager",
                           device="cpu", graphs=False, **kw)
    assert got == ref and eager == ref and len(ref[0]) > 1000
    assert counts(dec.stream_graphs) == (2, 1, 1)


def test_device_driver_keeps_two_graph_holders(tmp_path):
    """The chip-resident driver replays its rounds from `graphs` and its
    finalize (the marker re-decode, the sweep of failed lines) from the
    batch driver's `stream_graphs`: two holders, two pools; the WAV
    equals the JAX package's and the eager route's."""
    tmp = str(tmp_path)
    cap = chip_smoke.write_capture(os.path.join(tmp, "n.y4m"), 6, 294,
                                   seed=5, noise=26.0)
    kw = dict(lines_per_field=294, hyst_limit=2, shift_limit=1,
              frames_per_round=2, ref_sweep_fallback=True)
    ref, _ = run_decoder(jdd.DeviceBatchDecoder, [cap], tmp, "jax", **kw)
    got, dec = run_decoder(tdd.DeviceBatchDecoder, [cap], tmp, "graph",
                           device="cpu", **kw)
    eager, dec_e = run_decoder(tdd.DeviceBatchDecoder, [cap], tmp, "eager",
                               device="cpu", graphs=False, **kw)
    assert got == ref and eager == ref
    assert dec.graphs is not dec.stream_graphs
    assert dec.jobs[0].driver.graphs is dec.stream_graphs
    assert dec.graphs.replays > 0 and dec.stream_graphs.replays > 0
    assert dec_e.graphs is None and dec_e.stream_graphs is None
