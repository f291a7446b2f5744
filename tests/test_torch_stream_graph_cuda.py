"""The streaming backend's device calls and the stream chain replayed as
CUDA graphs, against the same calls eager, on an NVIDIA GPU. Marked
`cuda`: every test skips where torch.cuda.is_available() is false. On a
GPU machine run them with

    python -m pytest --noconftest -m cuda tests/test_torch_stream_graph_cuda.py

Each site (V2DDriver's dispatch, marker fallback and sweep; the PCM-1 and
PCM-16x0 grids; decode_stream; decode_frames) is one cudaGraphLaunch per
replayed call and gives the eager route's outputs byte for byte; a
capture that meets a host sync raises and nothing runs eagerly in its
place; the batch driver writes the same WAVs under both routes.
"""
import os

import numpy as np
import pytest
import torch

import chip_smoke
from sdvpcmdecoder_tpu_torch.ops import fused_binarize as fb
from sdvpcmdecoder_tpu_torch.ops import round_graph
from sdvpcmdecoder_tpu_torch.ops.round_graph import thread_graphs
from sdvpcmdecoder_tpu_torch.pipeline import batch_driver as bd
from sdvpcmdecoder_tpu_torch.pipeline import decoder
from sdvpcmdecoder_tpu_torch.pipeline import v2d
from sdvpcmdecoder_tpu_torch.pipeline import v2d_other
from sdvpcmdecoder_tpu_torch.synth import encoder as enc

pytestmark = pytest.mark.cuda

W, LPF, F = 1152, 294, 8


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda")


def pal_frames(seed, n_frames=F, sigma=26.0):
    """Noisy PAL frames [n_frames, 588, W] (host) and their coordinates."""
    rng = np.random.default_rng(seed)
    n = 3 * n_frames * 2 * LPF
    px, cd, *_ = enc.encode_stream(
        rng.integers(1, 1 << 14, n), rng.integers(1, 1 << 14, n), width=W,
        ppb=8.0, n_lines=n_frames * 2 * LPF, noise_sigma=sigma, rng=rng)
    px = px.reshape(n_frames, 2 * LPF, W).copy()
    for f in range(n_frames):   # lines the marker fallback re-finds
        px[f, 10 + f] = np.roll(px[f, 10 + f], 9)
    return px, cd[::2 * LPF].astype(np.int32)


def replay_once(call, graphs):
    """call() three times (the key's eager use, its capture, a replay),
    then once under the profiler: its result and its runtime calls; the
    traced call must be one replay and one cudaGraphLaunch."""
    for _ in range(3):
        call()
    before = graphs.replays
    tr = chip_smoke.traced(call)
    assert graphs.replays == before + 1
    assert tr["graph_launches"] == 1, tr["host_calls"]
    assert tr["host_calls"].get("cudaLaunchKernel", 0) == 0, tr["host_calls"]
    return tr["result"]


def assert_equal(got, expect):
    assert len(got) == len(expect)
    for a, b in zip(got, expect):
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b)
        else:
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype and np.array_equal(a, b)


def drivers(cuda, **kw):
    return (v2d.V2DDriver(device=cuda, **kw),
            v2d.V2DDriver(device=cuda, graphs=False, **kw))


def test_dispatch_is_one_graph_launch(cuda):
    g, e = drivers(cuda, hyst_limit=4, shift_limit=2)
    px, _ = pal_frames(1)
    prep = e.prepare_frames(px)

    def call(drv):
        return drv.materialize_frames(px, prep,
                                      drv.dispatch_frames_async(px, prep))
    got = replay_once(lambda: call(g), g.graphs)
    assert_equal(got, call(e))


def test_marker_fallback_bucket_is_one_graph_launch(cuda):
    g, e = drivers(cuda, hyst_limit=2, shift_limit=1)
    px, _ = pal_frames(2, n_frames=1)
    prep = e.prepare_frames(px)
    w, c, v, _ = e.dispatch_frames(px, prep)
    assert 0 < int((~v).sum()) < v.size
    args = (px[0], w[0], c[0], v[0], int(prep["refs"][0]),
            int(prep["blacks"][0]), int(prep["whites"][0]))
    got = replay_once(lambda: g._marker_fallback(*args), g.graphs)
    assert_equal(got, e._marker_fallback(*args))
    assert g.fallback_batches >= 4


@pytest.mark.parametrize("limits", [(4, 2), (10, 4)])
def test_sweep_is_one_graph_launch_of_64_k1_launches(cuda, limits):
    g, e = drivers(cuda, hyst_limit=limits[0], shift_limit=limits[1],
                   use_kernel=True)
    px, cd = pal_frames(3, n_frames=4, sigma=30.0)
    args = (px, cd, np.full(4, 20), np.full(4, 200))
    n0 = fb.stc007_fused_decode_frames.launches
    got = replay_once(lambda: g._sweep_decode(*args), g.graphs)
    assert fb.stc007_fused_decode_frames.launches == n0 + 4 * 64
    expect = e._sweep_decode(*args)
    assert_equal(got[:4], expect[:4])
    assert torch.equal(got.words, expect.words)


@pytest.mark.parametrize("fmt", ["pcm1", "pcm16x0"])
def test_pcm_grid_is_one_graph_launch(cuda, tmp_path, fmt):
    write = {"pcm1": chip_smoke.write_pcm1_capture,
             "pcm16x0": chip_smoke.write_pcm16x0_capture}[fmt]
    from sdvpcmdecoder_tpu_torch.pipeline import ingest
    cap = write(str(tmp_path / f"{fmt}.y4m"), n_frames=8, seed=5)
    with ingest.open_capture(cap) as rd:
        lines, _ = ingest.split_fields_batch(rd.read_frames(0, 8))
    kw = dict(shift_limit=1, hyst_limit=2, backend="tpu", device=cuda)
    g = v2d_other.PCMFrameDriver(fmt, **kw)
    e = v2d_other.PCMFrameDriver(fmt, graphs=False, **kw)
    prep = e.prepare_frames(lines)
    got = replay_once(lambda: g._decode_batch(lines, prep), g.graphs)
    assert_equal([a for a in got if a is not None],
                 [a for a in e._decode_batch(lines, prep) if a is not None])


def test_decode_stream_and_decode_frames_are_one_graph_launch(cuda):
    px, cd = pal_frames(4, n_frames=2, sigma=20.0)
    lv = [torch.full((2,), v, dtype=torch.int32, device=cuda)
          for v in (110, 20, 200)]
    frames = (torch.from_numpy(px).to(cuda), torch.from_numpy(cd).to(cuda),
              *lv)
    graphs = thread_graphs(frames[0].device)
    got = replay_once(lambda: decoder.decode_frames(*frames), graphs)
    assert_equal(got, decoder.decode_frames(*frames, graphs=False))
    lines = px.reshape(-1, W)
    n = lines.shape[0]
    stream = (torch.from_numpy(lines).to(cuda),
              torch.from_numpy(np.repeat(cd, 2 * LPF, axis=0)).to(cuda),
              *(torch.full((n,), v, dtype=torch.int32, device=cuda)
                for v in (110, 20, 200)))
    for use_kernel in (True, False):
        kw = dict(hyst_limit=2, shift_limit=1, use_kernel=use_kernel)
        got = replay_once(lambda: decoder.decode_stream(*stream, **kw),
                          graphs)
        assert_equal(got, decoder.decode_stream(*stream, graphs=False, **kw))


def test_capture_that_syncs_raises_and_never_falls_back(cuda, monkeypatch):
    """A sweep body that reads a value back to the host cannot be
    captured: the driver's second call raises, no capture is counted and
    nothing runs eagerly in its place; graphs=False still runs it."""
    monkeypatch.setattr(round_graph, "_THREAD", type(round_graph._THREAD)())
    g, e = drivers(cuda, hyst_limit=2, shift_limit=1, use_kernel=True)
    px, cd = pal_frames(5, n_frames=1)
    args = (px, cd, np.full(1, 20), np.full(1, 200))
    sweep = fb.stc007_ref_sweep_decode

    def syncs(*a, **k):
        out = sweep(*a, **k)
        int(out["valid"].sum())   # a host sync
        return out

    monkeypatch.setattr(fb, "stc007_ref_sweep_decode", syncs)
    g._sweep_decode(*args)
    n0 = fb.stc007_fused_decode_frames.launches
    with pytest.raises(RuntimeError):
        g._sweep_decode(*args)
    assert (g.graphs.eager_rounds, g.graphs.captures, g.graphs.replays) \
        == (1, 0, 0)
    assert g.sweep_calls == 1
    assert fb.stc007_fused_decode_frames.launches == n0
    e._sweep_decode(*args)
    assert e.sweep_calls == 1


def test_run_tpu_wavs_equal_under_both_routes(cuda, tmp_path):
    """Two noisy captures through BatchDecoder.run_tpu (fused rounds, the
    marker fallback, the sweeps of the CLI's default quality): the graph
    route's WAVs equal the eager route's, and its keys replay."""
    tmp = str(tmp_path)
    caps = [chip_smoke.write_capture(os.path.join(tmp, f"c{i}.y4m"), 12,
                                     LPF, seed=20 + i, noise=30.0)
            for i in range(2)]
    kw = dict(lines_per_field=LPF, hyst_limit=4, shift_limit=2,
              frames_per_round=4, backend="tpu", device=cuda,
              ref_sweep_fallback=True, normal_sweep_prescan=True)
    wavs = {}
    for graphs in (True, False):
        dec = bd.BatchDecoder([(c, os.path.join(tmp, f"{graphs}_{k}.wav"))
                               for k, c in enumerate(caps)], graphs=graphs,
                              **kw)
        dec.run()
        wavs[graphs] = [open(j.out_path, "rb").read() for j in dec.jobs]
        if graphs:
            sg = dec.stream_graphs
            assert sg.replays > 0 and sg.eager_rounds == len(sg._graphs)
    assert wavs[True] == wavs[False] and len(wavs[True][0]) > 1000
