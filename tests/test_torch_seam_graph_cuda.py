"""The stitcher's device seam route (seam_backend="tpu") with its two
programs, eval_rows_arrays (the JAX package's _eval_rows_jit) and
seam_sweep (_seam_sweep), replayed as CUDA graphs, on an NVIDIA GPU.
Marked `cuda`: every test skips where torch.cuda.is_available() is false.
On a GPU machine run them with

    python -m pytest --noconftest -m cuda tests/test_torch_seam_graph_cuda.py

The graph route, the eager route and the CPU route write the same WAV;
a replayed call is one cudaGraphLaunch; a capture that fails raises, and
nothing runs eagerly, on the host or through the native core in its place.
"""
import os

import numpy as np
import pytest
import torch

import chip_smoke
from sdvpcmdecoder_tpu_torch.ops import device_stitch as ds
from sdvpcmdecoder_tpu_torch.ops import fused_binarize as fb
from sdvpcmdecoder_tpu_torch.ops import round_graph
from sdvpcmdecoder_tpu_torch.ops import stitch_native as sn
from sdvpcmdecoder_tpu_torch.pipeline import batch_driver as bd
from sdvpcmdecoder_tpu_torch.synth import encoder as enc

pytestmark = pytest.mark.cuda

KW = dict(chip_smoke.Q3_MULTI_KW)
# The native core's seam and block evals: what the stitcher runs in place
# of the device route under seam_backend="auto".
SEAM_NATIVE = ("eval_rows_arrays", "padding_sweep", "eval_seam",
               "field_res_counts", "steady_tail", "steady_round",
               "spec_round", "deint_finalize")


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    monkeypatch.setattr(round_graph, "_THREAD", type(round_graph._THREAD)())
    return torch.device("cuda")


def line_buffer(n_lines, seed, bad=0.2):
    """Encoded line words [L, 8] int32 and their CRC flags, some lines
    corrupted and flagged."""
    rng = np.random.default_rng(seed)
    left, right = rng.integers(0, 1 << 14, (2, 3 * n_lines))
    words, _ = enc.blocks_to_lines(enc.samples_to_blocks(left, right),
                                   n_lines)
    words = words.astype(np.int32)
    ok = np.repeat(rng.random((n_lines, 1)) > bad, 8, axis=1)
    words[~ok] ^= rng.integers(1, 1 << 14, words.shape, dtype=np.int32)[~ok]
    return words, ok


def decode(cap, tmp, tag, **kw):
    dec = bd.BatchDecoder([(cap, os.path.join(tmp, f"{tag}.wav"))],
                          **dict(KW, **kw))
    dec.run()
    return open(dec.jobs[0].out_path, "rb").read(), dec


def test_graph_route_equals_eager_and_cpu_routes(cuda, tmp_path):
    """A noisy capture (sigma 26: the padding search, the marker
    re-decode) through BatchDecoder(backend="tpu", seam_backend="tpu"):
    the graph route's WAV equals the eager route's, the CPU route's and
    the default route's (the native core), K1 launched on both card
    routes alike."""
    tmp = str(tmp_path)
    cap = chip_smoke.write_capture(os.path.join(tmp, "n.y4m"), 6, 294,
                                   seed=2, noise=26.0)
    wav, k1 = {}, {}
    for name, kw in (("graph", dict(device=cuda)),
                     ("eager", dict(device=cuda, graphs=False)),
                     ("cpu", dict(device="cpu"))):
        n0 = fb.stc007_fused_decode_frames.launches
        wav[name], dec = decode(cap, tmp, name, backend="tpu",
                                seam_backend="tpu", **kw)
        k1[name] = fb.stc007_fused_decode_frames.launches - n0
        assert dec.jobs[0].stitcher.seam_backend == "tpu"
    wav["auto"], _ = decode(cap, tmp, "auto", backend="tpu", device=cuda)
    assert wav["graph"] == wav["eager"] == wav["cpu"] == wav["auto"]
    assert len(wav["graph"]) > 1000
    assert k1["graph"] == k1["eager"] > 0 and k1["cpu"] == 0
    g = round_graph.thread_graphs(cuda)
    assert g.replays > 0 and g.eager_rounds == len(g._graphs)


def replayed_call(call, graphs):
    """call() twice (the key's eager use and its capture), then once
    under the profiler: its result; the traced call must be one replay,
    one cudaGraphLaunch and no kernel launch."""
    for _ in range(2):
        call()
    before = graphs.replays
    tr = chip_smoke.traced(call)
    assert graphs.replays == before + 1
    assert tr["graph_launches"] == 1, tr["host_calls"]
    assert tr["host_calls"].get("cudaLaunchKernel", 0) == 0, tr["host_calls"]
    return tr["result"]


def assert_arrays(got, expect):
    assert len(got) == len(expect)
    for a, b in zip(got, expect):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_eval_rows_and_seam_sweep_replay_as_one_graph_launch(cuda):
    """A replayed J9 call and a replayed J10 call are one graph launch
    each; their outputs equal the eager call's and the CPU's."""
    words, ok = line_buffer(700, seed=3)
    args = (words, ok, None, 0, 700 - 112, 2, True, True, True, False)
    g = round_graph.thread_graphs(cuda)
    got = replayed_call(lambda: ds.eval_rows_arrays(*args, device=cuda), g)
    assert_arrays(got, ds.eval_rows_arrays(*args, device=cuda,
                                           graphs=False))
    assert_arrays(got, ds.eval_rows_arrays(*args, device="cpu",
                                           graphs=False))
    from sdvpcmdecoder_tpu_torch.formats import stc007
    silent = np.asarray(stc007.silent_words(m2=False), np.int32)
    modes = np.array([0, 1, -1, 3] * 8, np.int32)
    for n1, n2 in ((294, 294), (60, 200)):
        w1, c1 = line_buffer(n1, seed=n1)
        w2, c2 = line_buffer(n2, seed=n2 + 1)
        sargs = (w1, c1, w2, c2, silent, modes, True, True, False, 4)
        got = replayed_call(lambda: ds.seam_sweep(*sargs, device=cuda), g)
        assert_arrays(got, ds.seam_sweep(*sargs, device=cuda, graphs=False))
        assert_arrays(got, ds.seam_sweep(*sargs, device="cpu",
                                         graphs=False))


def test_failed_capture_raises_and_never_falls_back(cuda, tmp_path,
                                                    monkeypatch):
    """A J9 body that reads a value back to the host cannot be captured:
    the key's second call raises, no capture is counted and nothing runs
    eagerly in its place; the stitcher's route raises with it, and does
    not give way to the native core; graphs=False still runs it."""
    eval_rows_device = ds.eval_rows_device

    def syncs(*a, **k):
        flags, samples, batch = eval_rows_device(*a, **k)
        int(flags.sum())   # a host sync
        return flags, samples, batch

    monkeypatch.setattr(ds, "eval_rows_device", syncs)
    words, ok = line_buffer(300, seed=4)
    args = (words, ok, None, 0, 188, 0, True, True, True, False)
    g = round_graph.thread_graphs(cuda)
    expect = ds.eval_rows_arrays(*args, device=cuda)
    with pytest.raises(RuntimeError):
        ds.eval_rows_arrays(*args, device=cuda)
    assert (g.eager_rounds, g.captures, g.replays) == (1, 0, 0)
    assert_arrays(ds.eval_rows_arrays(*args, device=cuda, graphs=False),
                  expect)

    tmp = str(tmp_path)
    cap = chip_smoke.write_capture(os.path.join(tmp, "c.y4m"), 4, 294,
                                   seed=1)
    native = []
    for name in SEAM_NATIVE:
        fn = getattr(sn, name)
        monkeypatch.setattr(sn, name, lambda *a, _fn=fn, _n=name, **k: (
            native.append(_n), _fn(*a, **k))[1])
    with pytest.raises(RuntimeError):
        decode(cap, tmp, "fails", seam_backend="tpu", device=cuda)
    wav, _ = decode(cap, tmp, "eager", seam_backend="tpu", device=cuda,
                    graphs=False)
    assert len(wav) > 1000 and native == []
