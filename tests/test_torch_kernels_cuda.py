"""The hand-written CUDA kernels against their plain torch versions, on an
NVIDIA GPU. Marked `cuda`: every test skips where torch.cuda.is_available()
is false. On a GPU machine run them with

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda
"""
import numpy as np
import pytest
import torch

from sdvpcmdecoder_tpu_torch.ops import binarize as bz
from sdvpcmdecoder_tpu_torch.ops import deinterleave as di
from sdvpcmdecoder_tpu_torch.ops import fused_binarize as fb
from sdvpcmdecoder_tpu_torch.pipeline import decoder
from sdvpcmdecoder_tpu_torch.synth import encoder as enc

pytestmark = pytest.mark.cuda

W = 1152


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda")


def noisy_frames(n_frames, lines_pf, sigma, seed, device):
    rng = np.random.default_rng(seed)
    n = 3 * n_frames * lines_pf
    pixels, coords, *_ = enc.encode_stream(
        rng.integers(0, 1 << 14, n), rng.integers(0, 1 << 14, n), width=W,
        ppb=8.0, n_lines=n_frames * lines_pf, noise_sigma=sigma, rng=rng)
    return (torch.from_numpy(pixels.reshape(n_frames, lines_pf, W)).to(device),
            torch.from_numpy(coords[::lines_pf]).to(device))


def assert_batches_equal(got, expect):
    for name in got._fields:
        g, e = getattr(got, name), getattr(expect, name)
        assert g.dtype == e.dtype and g.shape == e.shape, name
        assert torch.equal(g, e), name


@pytest.mark.parametrize("n_frames,lines_pf,limits,per_line", [
    (4, 588, (4, 2), False),     # NORMAL, PAL frames
    (2, 588, (10, 4), False),    # INSANE
    (2, 300, (4, 2), True),      # per-line levels, ragged last tile
    (1, 37, (2, 1), False),      # fewer lines than one tile
])
def test_binarize_kernel_matches_plain(cuda, n_frames, lines_pf, limits,
                                       per_line):
    px, cd = noisy_frames(n_frames, lines_pf, 30.0, seed=lines_pf,
                          device=cuda)
    shape = (n_frames, lines_pf) if per_line else (n_frames,)
    gen = torch.Generator().manual_seed(1)
    ref = torch.randint(100, 121, shape, generator=gen,
                        dtype=torch.int32).to(cuda)
    black = torch.full(shape, 20, dtype=torch.int32, device=cuda)
    white = torch.full(shape, 200, dtype=torch.int32, device=cuda)
    before = fb.stc007_fused_decode_frames.launches
    got = fb.stc007_fused_decode_frames(px, cd, ref, black, white, *limits)
    torch.cuda.synchronize()
    assert fb.stc007_fused_decode_frames.launches == before + 1
    expect = bz.stc007_frame_decode(px, cd, ref, black, white, *limits)
    assert_batches_equal(got, expect)


@pytest.mark.parametrize("lines,limits", [
    (588, (4, 2)),      # one PAL frame, NORMAL
    (588, (10, 4)),     # INSANE
    (300, (4, 2)),      # ragged last tile
])
def test_group_kernel_matches_plain(cuda, lines, limits):
    """K2 (stc007_fused_decode: one group of lines, per-line levels)
    against its plain version on every field of every line."""
    px, cd = noisy_frames(1, lines, 30.0, seed=lines, device=cuda)
    gen = torch.Generator().manual_seed(3)
    ref = torch.randint(100, 121, (lines,), generator=gen,
                        dtype=torch.int32).to(cuda)
    black = torch.full((lines,), 20, dtype=torch.int32, device=cuda)
    white = torch.full((lines,), 200, dtype=torch.int32, device=cuda)
    coords = (int(cd[0, 0]), int(cd[0, 1]))
    before = fb.stc007_fused_decode.launches
    got = fb.stc007_fused_decode(px[0], coords, ref, black, white, *limits)
    torch.cuda.synchronize()
    assert fb.stc007_fused_decode.launches == before + 1
    expect = bz.stc007_frame_decode(px, cd, ref[None], black[None],
                                    white[None], *limits)
    assert_batches_equal(got, bz.LineBatch(*(t[0] for t in expect)))


def test_steady_round_kernel_matches_plain(cuda):
    """One unchained and one chained PAL round of 4 frames: the six
    outputs with the K1 kernel equal those of the plain binarize."""
    from sdvpcmdecoder_tpu_torch.ops import device_stitch as ds
    from sdvpcmdecoder_tpu_torch.pipeline import device_driver as dd
    F, lpf = 4, 294
    px, cd = noisy_frames(2 * F, 2 * lpf, 30.0, seed=5, device=cuda)
    tables = ds.RoundTables().to(cuda)
    o, n = ds.round_param_layout(F)
    states = {True: dd.RoundState.zeros(2 * lpf, cuda)}
    states[False] = states[True]
    for r in range(2):
        rows = dd._RoundRows(F, lpf, 112 if r else 0, 0, 0, lpf, True,
                             device=cuda)
        params = torch.zeros(n, dtype=torch.int32)
        params[o["coords"]:o["coords"] + 2 * F] = \
            cd[r * F:(r + 1) * F].reshape(-1).cpu()
        params[o["refs"]:o["refs"] + F] = 110
        params[o["blacks"]:o["blacks"] + F] = 20
        params[o["whites"]:o["whites"] + F] = 200
        params[o["usable"]:o["usable"] + F] = 1
        params[o["pred_mode"]] = 1
        params[o["unch_lim"]] = 3
        outs = {}
        for use_kernel in (True, False):
            before = fb.stc007_fused_decode_frames.launches
            out, wflat, states[use_kernel] = dd.run_round(
                px[r * F:(r + 1) * F].contiguous(), params,
                states[use_kernel], rows, en_p=True, en_q=True, m2=False,
                hyst_limit=4, shift_limit=2, use_kernel=use_kernel,
                chained=r > 0, tables=tables)
            torch.cuda.synchronize()
            assert fb.stc007_fused_decode_frames.launches \
                == before + use_kernel
            outs[use_kernel] = (out, wflat, *states[use_kernel])
        for g, e in zip(outs[True], outs[False]):
            assert g.dtype == e.dtype and torch.equal(g, e)


def test_decode_frames_kernel_matches_plain(cuda):
    px, cd = noisy_frames(4, 588, 30.0, seed=2, device=cuda)
    lv = [torch.full((4,), v, dtype=torch.int32, device=cuda)
          for v in (110, 20, 200)]
    for res_mode in (di.RES_MODE_14BIT, di.RES_MODE_14BIT_AUTO):
        got = decoder.decode_frames(px, cd, *lv, res_mode=res_mode)
        expect = decoder.decode_frames(px, cd, *lv, res_mode=res_mode,
                                       use_kernel=False)
        for g, e in zip(got, expect):
            assert g.dtype == e.dtype and torch.equal(g, e)


@pytest.mark.parametrize("noise", [0.0, 26.0])
def test_driver_kernel_path_matches_plain(cuda, tmp_path, noise):
    """The chip-resident driver on a 12-frame PAL capture: the WAV with
    K1 (in every round and in the marker-fallback re-decode) equals the
    WAV of the plain binarize, byte for byte; the clean one equals the
    golden hash of the JAX package's WAV."""
    import hashlib

    import chip_smoke
    from sdvpcmdecoder_tpu_torch.pipeline import device_driver as dd
    cap = chip_smoke.write_capture(str(tmp_path / "c.y4m"), 12, 294,
                                   seed=1, noise=noise)
    wavs = {}
    for use_kernel in (True, False):
        out = str(tmp_path / f"o{int(use_kernel)}.wav")
        before = fb.stc007_fused_decode_frames.launches
        dec = dd.DeviceBatchDecoder([(cap, out)], hyst_limit=2,
                                    shift_limit=1, frames_per_round=5,
                                    device=cuda, use_kernel=use_kernel)
        dec.run()
        j = dec.jobs[0]
        assert fb.stc007_fused_decode_frames.launches - before == (
            len(j.round_chained) + j.driver.fallback_batches
            if use_kernel else 0)
        wavs[use_kernel] = open(out, "rb").read()
    assert wavs[True] == wavs[False]
    if noise == 0.0:
        assert hashlib.sha256(wavs[True]).hexdigest() == \
            chip_smoke.GOLDEN_SHA256["pal"]
    else:
        assert j.driver.fallback_batches > 0
