"""Rounds replayed as CUDA graphs (ops/round_graph.RoundGraphs) against
the same rounds run eagerly, on an NVIDIA GPU. Marked `cuda`: every test
skips where torch.cuda.is_available() is false. On a GPU machine run them
with

    python -m pytest --noconftest -m cuda tests/test_torch_round_graph_cuda.py
"""
import threading

import numpy as np
import pytest
import torch

import chip_smoke
from sdvpcmdecoder_tpu_torch.ops import device_stitch as ds
from sdvpcmdecoder_tpu_torch.ops import fused_binarize as fb
from sdvpcmdecoder_tpu_torch.ops.round_graph import RoundGraphs
from sdvpcmdecoder_tpu_torch.pipeline import device_driver as dd
from sdvpcmdecoder_tpu_torch.pipeline import device_pcm as dpcm
from sdvpcmdecoder_tpu_torch.synth import encoder as enc

pytestmark = pytest.mark.cuda

W, LPF, F = 1152, 294, 8


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda")


def stc007_rounds(sigma, seed, device, n_rounds=5):
    """n_rounds rounds of F PAL frames: pixels, and each round's params
    (numpy, as the driver hands them over)."""
    rng = np.random.default_rng(seed)
    n_frames = n_rounds * F
    n = 3 * n_frames * 2 * LPF
    pixels, coords, *_ = enc.encode_stream(
        rng.integers(0, 1 << 14, n), rng.integers(0, 1 << 14, n), width=W,
        ppb=8.0, n_lines=n_frames * 2 * LPF, noise_sigma=sigma, rng=rng)
    px = torch.from_numpy(np.ascontiguousarray(
        pixels.reshape(n_frames, 2 * LPF, W))).to(device)
    o, n_par = ds.round_param_layout(F)
    params = []
    for r in range(n_rounds):
        p = np.zeros(n_par, np.int32)
        p[o["coords"]:o["coords"] + 2 * F] = \
            coords[::2 * LPF][r * F:(r + 1) * F].ravel()
        for key, v in (("refs", 110), ("blacks", 20), ("whites", 200),
                       ("usable", 1)):
            p[o[key]:o[key] + F] = v
        p[o["pred_mode"]] = 1
        p[o["unch_lim"]] = 3
        params.append(p)
    return px, params


def run_stc007(px, params, device, graphs, count=True):
    """Round 0 unchained, the others chained, as the driver runs them;
    every round's six outputs copied as they return. With `count`, K1's
    counter must move by one per round (no other thread launching)."""
    tables = ds.RoundTables().to(device)
    rows = [dd._RoundRows(F, LPF, n0, 0, 0, LPF, True, device=device)
            for n0 in (0, 112)]
    state = dd.RoundState.zeros(2 * LPF, device)
    res = []
    for r, p in enumerate(params):
        before = fb.stc007_fused_decode_frames.launches
        out, wflat, state = dd.run_round(
            px[r * F:(r + 1) * F], p, state, rows[r > 0], en_p=True,
            en_q=True, m2=False, hyst_limit=4, shift_limit=2,
            use_kernel=True, chained=r > 0, tables=tables, graphs=graphs)
        res.append([t.clone() for t in (out, wflat, *state)])
        # The stream, not the device: another thread may be capturing.
        torch.cuda.current_stream(device).synchronize()
        if count:
            assert fb.stc007_fused_decode_frames.launches == before + 1
    return res


def assert_rounds_equal(got, expect):
    assert len(got) == len(expect)
    for r, (g, e) in enumerate(zip(got, expect)):
        for k, (a, b) in enumerate(zip(g, e)):
            assert a.dtype == b.dtype and torch.equal(a, b), (r, k)


@pytest.mark.parametrize("sigma", [0.0, 30.0])
def test_stc007_graph_replay_equals_eager_round(cuda, sigma):
    """One unchained and four chained rounds of 8 PAL frames: the chained
    key runs eagerly, is captured, then replays twice; every output of
    every round equals the eager round's, K1 counted once per round."""
    px, params = stc007_rounds(sigma, seed=int(sigma) + 1, device=cuda)
    graphs = RoundGraphs(cuda)
    got = run_stc007(px, params, cuda, graphs)
    assert (graphs.eager_rounds, graphs.captures, graphs.replays) \
        == (2, 1, 3)
    assert_rounds_equal(got, run_stc007(px, params, cuda, None))


@pytest.mark.parametrize("fmt", ["pcm1", "pcm16x0"])
def test_pcm_graph_replay_equals_eager_round(cuda, tmp_path, fmt):
    write = {"pcm1": chip_smoke.write_pcm1_capture,
             "pcm16x0": chip_smoke.write_pcm16x0_capture}[fmt]
    cap = write(str(tmp_path / f"{fmt}.y4m"), n_frames=9, seed=5)
    px, *levels = chip_smoke.pcm_grid_inputs(cap, fmt, cuda)
    graphs = RoundGraphs(cuda)
    for r in range(3):
        sl = slice(3 * r, 3 * r + 3)
        params = chip_smoke.pcm_round_params(*(t[sl] for t in levels))
        kw = dict(fmt=fmt, shift_limit=1, hyst_limit=2)
        got = dpcm.run_round(px[sl], params.cpu().numpy(), graphs=graphs,
                             **kw).clone()
        expect = dpcm.run_round(px[sl], params, **kw)
        assert torch.equal(got, expect), r
    assert (graphs.eager_rounds, graphs.captures, graphs.replays) \
        == (1, 1, 2)


def test_failed_capture_raises(cuda):
    """A round that reads a value back to the host cannot be captured: the
    capture raises, nothing is counted and nothing runs eagerly in its
    place; the card then captures another key as before."""
    graphs = RoundGraphs(cuda)

    def reads_back(x):
        return (x * int(x.sum().item()),)

    x = torch.ones(4, device=cuda)
    graphs.run("reads_back", reads_back, (x,))
    with pytest.raises(RuntimeError):
        graphs.run("reads_back", reads_back, (x,))
    assert (graphs.eager_rounds, graphs.captures, graphs.replays) \
        == (1, 0, 0)
    for _ in range(3):
        y = graphs.run("adds", lambda t: (t + 1,), (x,))[0]
    assert torch.equal(y, x + 1) and graphs.captures == 1


def test_two_threads_capture_on_one_card(cuda):
    """Two decoder threads on one card, each with its own RoundGraphs,
    capture and replay at once (as two ShardedBatchDecoder shards do):
    each thread's rounds equal the eager ones."""
    inputs = [stc007_rounds(30.0, seed=s, device=cuda) for s in (3, 4)]
    expect = [run_stc007(px, params, cuda, None) for px, params in inputs]
    got, errors = [None, None], []
    start = threading.Barrier(2)

    def shard(i):
        try:
            start.wait(timeout=60)
            graphs = RoundGraphs(cuda)
            got[i] = [run_stc007(*inputs[i], cuda, graphs, count=False)]
            got[i].append(graphs.captures)
        except BaseException as e:   # noqa: BLE001 — reported below
            errors.append(e)

    before = fb.stc007_fused_decode_frames.launches
    threads = [threading.Thread(target=shard, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive()
    assert not errors, errors
    for i in range(2):
        assert got[i][1] == 1
        assert_rounds_equal(got[i][0], expect[i])
    assert fb.stc007_fused_decode_frames.launches == before + 10
