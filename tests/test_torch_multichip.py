"""The port's multi-GPU layer (parallel/multichip.ShardedBatchDecoder,
parallel/mesh) and ops/agc.line_histograms_device against the JAX
package's, on the CPU.

Mirrors tests/test_multichip_driver.py with devices=[cpu, cpu] (sharded
WAVs equal the one-way run's and the JAX package's, stats equal the sum
over shards; streaming, chip-resident STC-007 and PCM-1) and
tests/test_mesh.py (the sharded step's gathered samples and grid-wide
valid-line count equal JAX's shard_map on its 8 virtual CPU devices, and
decode_stream on the whole capture). Also the port's own rules: no CUDA
device means an error, not the CPU, and the state that concurrent shards
share (the kernels' build and launch counters) survives threads.
"""
import os
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdvpcmdecoder_tpu.ops import agc as jagc
from sdvpcmdecoder_tpu.parallel import mesh as jpm
from sdvpcmdecoder_tpu.pipeline import batch_driver as jbd
from sdvpcmdecoder_tpu.pipeline import decoder as jdec
from sdvpcmdecoder_tpu_torch.ops import _kernels
from sdvpcmdecoder_tpu_torch.ops import agc
from sdvpcmdecoder_tpu_torch.ops import fused_binarize as fb
from sdvpcmdecoder_tpu_torch.parallel import mesh as pm
from sdvpcmdecoder_tpu_torch.parallel.multichip import ShardedBatchDecoder
from sdvpcmdecoder_tpu_torch.pipeline import decoder
from sdvpcmdecoder_tpu_torch.synth import encoder as enc

import chip_smoke

torch.set_num_threads(1)

CPU2 = [torch.device("cpu"), torch.device("cpu")]


def _captures(tmp, n_caps, n_frames, seed0=40):
    jobs = []
    for c in range(n_caps):
        p = os.path.join(tmp, f"mc{c}.y4m")
        chip_smoke.write_capture(p, n_frames, 294, seed=seed0 + c)
        jobs.append((p, os.path.join(tmp, f"mc{c}.wav")))
    return jobs


def _wavs(jobs, suffix=""):
    return [open(o + suffix, "rb").read() for _, o in jobs]


@pytest.mark.parametrize("resident", [False, True],
                         ids=["streaming", "device_resident"])
def test_sharded_wavs_match_single_device_and_jax(tmp_path, resident):
    jobs = _captures(str(tmp_path), n_caps=3, n_frames=3)
    kw = dict(hyst_limit=1, shift_limit=1, frames_per_round=2)
    sharded = ShardedBatchDecoder(jobs, devices=CPU2,
                                  device_resident=resident, **kw)
    sharded.run()
    got = _wavs(jobs)
    assert sharded.stats[0] == 3 * 3
    np.testing.assert_array_equal(sharded.stats,
                                  sharded.shard_stats.sum(axis=0))
    assert sharded.shard_stats.shape == (2, 3)
    one = ShardedBatchDecoder([(p, o + ".one") for p, o in jobs],
                              devices=CPU2[:1], device_resident=resident,
                              **kw)
    one.run()
    np.testing.assert_array_equal(one.stats, sharded.stats)
    assert _wavs(jobs, ".one") == got
    jbd.BatchDecoder([(p, o + ".jax") for p, o in jobs], backend="native",
                     **kw).run()
    assert _wavs(jobs, ".jax") == got and all(len(w) > 44 for w in got)


def test_sharded_device_resident_pcm(tmp_path):
    from test_batch_driver_formats import _pcm1_capture
    jobs = []
    for c in range(2):
        p = str(tmp_path / f"p{c}.y4m")
        _pcm1_capture(p, n_frames=3, seed=60 + c)
        jobs.append((p, str(tmp_path / f"p{c}.wav")))
    kw = dict(shift_limit=1, frames_per_round=2)
    ShardedBatchDecoder(jobs, devices=CPU2, fmt="pcm1", device_resident=True,
                        **kw).run()
    jbd.BatchDecoder([(p, o + ".jax") for p, o in jobs], fmt="pcm1",
                     backend="native", **kw).run()
    assert _wavs(jobs) == _wavs(jobs, ".jax")


def test_shards_get_their_device_and_decoder(monkeypatch, tmp_path):
    """Each shard's decoder is built with device=its device: the streaming
    BatchDecoder on the "tpu" backend, or the chip-resident driver."""
    seen = []
    from sdvpcmdecoder_tpu_torch.pipeline import batch_driver as tbd
    from sdvpcmdecoder_tpu_torch.pipeline import device_driver as tdd

    class Stop(Exception):
        pass

    def spy(name):
        def init(self, jobs, *a, device=None, **kw):
            seen.append((name, str(device), len(jobs), kw.get("backend")))
            raise Stop
        return init

    monkeypatch.setattr(tbd.BatchDecoder, "__init__", spy("batch"))
    monkeypatch.setattr(tdd.DeviceBatchDecoder, "__init__", spy("device"))
    jobs = [(f"c{k}.y4m", f"c{k}.wav") for k in range(3)]
    for resident in (False, True):
        with pytest.raises(RuntimeError, match="shard 0") as e:
            ShardedBatchDecoder(jobs, devices=["cpu", "meta"],
                                device_resident=resident).run()
        assert isinstance(e.value.__cause__, Stop)
    assert sorted(seen) == sorted([
        ("batch", "cpu", 2, "tpu"), ("batch", "meta", 1, "tpu"),
        ("device", "cpu", 2, None), ("device", "meta", 1, None)])


def test_no_cuda_device_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ShardedBatchDecoder([("a.y4m", "a.wav")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pm.decode_mesh()


def test_reduce_stats_is_the_host_sum():
    per = np.arange(12, dtype=np.int64).reshape(4, 3)
    np.testing.assert_array_equal(ShardedBatchDecoder._reduce_stats(per),
                                  per.sum(axis=0))


# -- mesh -------------------------------------------------------------------

def _stream(n_lines, seed=42, noise=0.0):
    rng = np.random.default_rng(seed)
    n = 3 * n_lines
    kw = dict(noise_sigma=noise, rng=rng) if noise else {}
    return enc.encode_stream(rng.integers(1, 1 << 14, n),
                             rng.integers(1, 1 << 14, n), width=1152,
                             ppb=8.0, n_lines=n_lines, **kw)


def test_chunk_lines_with_halo_and_grid_like_jax():
    lines = np.arange(2 * 300).reshape(300, 2)
    for k in (1, 2, 3):
        got, chunk = pm.chunk_lines_with_halo(lines, k)
        jgot, jchunk = jpm.chunk_lines_with_halo(lines, k)
        assert chunk == jchunk
        np.testing.assert_array_equal(got, jgot)
    assert pm.HALO == jpm.HALO
    grid = pm.decode_mesh(8, seq=4, devices=["cpu"])
    jgrid = jpm.decode_mesh(8, seq=4)
    assert grid.shape == jgrid.devices.shape == (2, 4)
    assert all(d == torch.device("cpu") for d in grid.ravel())
    assert pm.decode_mesh(devices=CPU2).shape == (1, 2)
    assert pm.decode_mesh(3, devices=CPU2).shape == (3, 1)
    with pytest.raises(ValueError, match="grid"):
        pm.shard_captures(np.zeros((1, 4, 3)), grid)


@pytest.mark.parametrize("noise", [0.0, 30.0])
def test_sharded_decode_matches_jax_and_single_device(noise):
    assert len(jax.devices()) >= 8
    n_lines = 4 * pm.HALO + 112
    pixels, coords, _, _ = _stream(n_lines, noise=noise)
    lv = [np.full(n_lines, v, np.int32) for v in (110, 20, 200)]
    ref = decoder.decode_stream(*(torch.from_numpy(a) for a in
                                  (pixels, coords.astype(np.int32), *lv)),
                                hyst_limit=1, shift_limit=1)
    jref = jdec.decode_stream(jnp.asarray(pixels), jnp.asarray(
        coords, jnp.int32), *(jnp.asarray(a) for a in lv), hyst_limit=1,
        shift_limit=1)
    np.testing.assert_array_equal(ref.samples.numpy(),
                                  np.asarray(jref.samples))
    D, S = 2, 4
    chunks, chunk = pm.chunk_lines_with_halo(pixels, S)
    cds, _ = pm.chunk_lines_with_halo(coords.astype(np.int32), S)
    Lc = chunks.shape[1]
    per = [np.broadcast_to(a[None], (D,) + a.shape).copy()
           for a in (chunks, cds)]
    per += [np.full((D, S, Lc), v, np.int32) for v in (110, 20, 200)]
    grid = pm.decode_mesh(D * S, seq=S, devices=["cpu"])
    gathered, n_valid = pm.multichip_decode_step(grid, 1, 1)(
        *(pm.shard_captures(a, grid) for a in per))
    jm = jpm.decode_mesh(8, seq=4)
    jg, jn = jpm.multichip_decode_step(jm, hyst_limit=1, shift_limit=1)(
        *(jpm.shard_captures(a, jm) for a in per))
    got = np.stack([np.stack([g.numpy() for g in row]) for row in gathered])
    np.testing.assert_array_equal(got, np.asarray(jg))
    nv = np.array([[int(v) for v in row] for row in n_valid])
    np.testing.assert_array_equal(nv, np.asarray(jn))
    stitched = np.concatenate([got[0, 0, k, :3 * chunk] for k in range(S)])
    n_cmp = min(len(stitched), len(ref.samples))
    np.testing.assert_array_equal(stitched[:n_cmp],
                                  ref.samples.numpy()[:n_cmp])


def test_decode_stream_kernel_route_equals_plain_route():
    """decode_stream's K1 route ([L, 1, W] frames of one line with their
    own coordinates and levels; on the CPU the wrapper's plain version)
    equals the per-line grid the JAX package runs, on noisy lines with
    jittered coordinates and per-line levels."""
    n_lines = 240
    rng = np.random.default_rng(4)
    pixels, coords, _, _ = _stream(n_lines, seed=4, noise=35.0)
    coords = coords + rng.integers(-2, 3, coords.shape)
    args = [torch.from_numpy(pixels), torch.from_numpy(coords.astype(
        np.int32))] + [torch.from_numpy(rng.integers(lo, hi, n_lines).astype(
            np.int32)) for lo, hi in ((95, 125), (10, 30), (185, 215))]
    a = decoder.decode_stream(*args, hyst_limit=3, shift_limit=2,
                              use_kernel=False)
    b = decoder.decode_stream(*args, hyst_limit=3, shift_limit=2,
                              use_kernel=True)
    assert 0 < int(a.line_valid.sum()) < n_lines
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)


# -- line_histograms_device -------------------------------------------------

@pytest.mark.parametrize("dtype", [np.uint8, np.int32])
def test_line_histograms_device_equals_jax(dtype):
    rng = np.random.default_rng(7)
    lo, hi = (0, 256) if dtype == np.uint8 else (-40, 300)
    pixels = rng.integers(lo, hi, (37, 1152)).astype(dtype)
    mask = rng.random((37, 1152)) > 0.3
    got = agc.line_histograms_device(torch.from_numpy(pixels),
                                     torch.from_numpy(mask))
    ref = np.asarray(jagc.line_histograms_device(jnp.asarray(pixels),
                                                 jnp.asarray(mask)))
    assert got.dtype == torch.int32 and got.shape == (37, 256)
    np.testing.assert_array_equal(got.numpy(), ref)
    if dtype == np.uint8:   # and the host histogram of the same spans
        full = agc.region_histograms(pixels, [(0, 1152)])
        np.testing.assert_array_equal(agc.line_histograms_device(
            torch.from_numpy(pixels), torch.ones(37, 1152, dtype=bool)),
            full)


# -- state the shards share ---------------------------------------------------

def test_launch_counter_survives_threads():
    """K1's counter under more threads than cores and a short switch
    interval: no increment is lost."""
    def wrapper():
        pass
    wrapper.launches = 0
    n_threads, per = 4 * (os.cpu_count() or 1), 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [fb._count(wrapper) for _ in range(per)])
            for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert wrapper.launches == n_threads * per


def test_concurrent_kernel_builds_run_nvcc_once(monkeypatch, tmp_path):
    """Threads of one process share a pid, so an unserialised build would
    write one temporary file twice: the shards' first launches build the
    kernel library once."""
    calls = tmp_path / "calls"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(
        f"#!{sys.executable}\nimport sys, time\n"
        f"open({str(calls)!r}, 'a').write('x')\ntime.sleep(0.2)\n"
        "open(sys.argv[sys.argv.index('-o') + 1], 'wb').write(b'lib')\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(_kernels, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_kernels, "BUILD_DIR", tmp_path / "kernels")
    _kernels.build.cache_clear()
    try:
        out = []
        threads = [threading.Thread(target=lambda: out.append(
            _kernels.build("stc007_binarize").path)) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        _kernels.build.cache_clear()
    assert calls.read_text() == "x" and len(set(out)) == 1 and len(out) == 8
    assert out[0].read_bytes() == b"lib"
