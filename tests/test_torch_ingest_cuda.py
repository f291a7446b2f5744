"""This slice's card paths against their plain or CPU versions, on an
NVIDIA GPU: decode_stream's K1 route, the mesh step, concurrent shards on
one card, the device histogram and a container through the CLI. Marked
`cuda`: every test skips where torch.cuda.is_available() is false. On a
GPU machine (no JAX there) run them with

    python -m pytest --noconftest -m cuda tests/test_torch_ingest_cuda.py
"""
import hashlib

import numpy as np
import pytest
import torch

import chip_smoke
from sdvpcmdecoder_tpu_torch.ops import agc
from sdvpcmdecoder_tpu_torch.ops import fused_binarize as fb
from sdvpcmdecoder_tpu_torch.parallel import mesh as pm
from sdvpcmdecoder_tpu_torch.parallel.multichip import ShardedBatchDecoder
from sdvpcmdecoder_tpu_torch.pipeline import decoder
from sdvpcmdecoder_tpu_torch.synth import encoder as enc

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda")


def _stream(n_lines, seed=42, noise=25.0):
    rng = np.random.default_rng(seed)
    n = 3 * n_lines
    pixels, coords, _, _ = enc.encode_stream(
        rng.integers(1, 1 << 14, n), rng.integers(1, 1 << 14, n),
        width=1152, ppb=8.0, n_lines=n_lines, noise_sigma=noise, rng=rng)
    lv = [np.full(n_lines, v, np.int32) for v in (110, 20, 200)]
    return [pixels, coords.astype(np.int32), *lv]


def test_decode_stream_launches_k1_and_equals_plain(cuda):
    arrays = _stream(400)
    dev = [torch.from_numpy(a).to(cuda) for a in arrays]
    before = fb.stc007_fused_decode_frames.launches
    got = decoder.decode_stream(*dev, hyst_limit=2, shift_limit=1)
    assert fb.stc007_fused_decode_frames.launches == before + 1
    plain = decoder.decode_stream(*dev, hyst_limit=2, shift_limit=1,
                                  use_kernel=False)
    host = decoder.decode_stream(*(torch.from_numpy(a) for a in arrays),
                                 hyst_limit=2, shift_limit=1)
    for g, p, h in zip(got, plain, host):
        assert torch.equal(g, p) and torch.equal(g.cpu(), h)


def test_mesh_step_on_the_card_equals_the_cpu_grid(cuda):
    arrays = _stream(4 * pm.HALO + 112)
    S = 2
    per = [pm.chunk_lines_with_halo(a, S)[0][None] for a in arrays]
    outs = []
    for devices in ([cuda], ["cpu"]):
        grid = pm.decode_mesh(S, seq=S, devices=devices)
        gathered, n_valid = pm.multichip_decode_step(grid, 1, 1)(
            *(pm.shard_captures(a, grid) for a in per))
        outs.append(([g.cpu() for g in gathered[0]],
                     [int(v) for v in n_valid[0]]))
    assert outs[0][1] == outs[1][1]
    for a, b in zip(outs[0][0], outs[1][0]):
        assert torch.equal(a, b)


def test_line_histograms_device_on_the_card(cuda):
    rng = np.random.default_rng(5)
    px = torch.from_numpy(rng.integers(0, 256, (64, 1152), np.uint8))
    mask = torch.from_numpy(rng.random((64, 1152)) > 0.5)
    got = agc.line_histograms_device(px.to(cuda), mask.to(cuda))
    assert got.device.type == "cuda" and got.dtype == torch.int32
    assert torch.equal(got.cpu(), agc.line_histograms_device(px, mask))


@pytest.mark.parametrize("resident", [False, True])
def test_two_shards_on_one_card_equal_one(cuda, tmp_path, resident):
    jobs = []
    for k in range(3):
        cap = chip_smoke.write_capture(str(tmp_path / f"c{k}.y4m"), 3, 294,
                                       seed=50 + k)
        jobs.append((cap, str(tmp_path / f"c{k}.wav")))
    kw = dict(hyst_limit=2, shift_limit=1, frames_per_round=2)
    wavs = []
    for devices, suffix in (([cuda, cuda], ""), ([cuda], ".one")):
        fb.stc007_fused_decode_frames.launches = 0
        sh = ShardedBatchDecoder([(p, o + suffix) for p, o in jobs],
                                 devices=devices, device_resident=resident,
                                 **kw)
        sh.run()
        assert fb.stc007_fused_decode_frames.launches > 0
        assert np.array_equal(sh.stats, sh.shard_stats.sum(axis=0))
        wavs.append([open(o + suffix, "rb").read() for _, o in jobs])
    assert wavs[0] == wavs[1]


def test_hfyu_avi_through_the_cli_on_the_card(cuda, tmp_path):
    from sdvpcmdecoder_tpu_torch.__main__ import main
    frames = chip_smoke.capture_frames(12, 294, seed=1)
    cap = chip_smoke.write_container(str(tmp_path / "c.avi"), frames, "HFYU")
    out = tmp_path / "c.wav"
    before = fb.stc007_fused_decode_frames.launches
    assert main([cap, "-o", str(out)]) == 0
    assert fb.stc007_fused_decode_frames.launches > before
    assert hashlib.sha256(out.read_bytes()).hexdigest() == \
        chip_smoke.GOLDEN_CLI_SHA256["pal"]
