"""The hand-written CUDA kernels against their plain torch versions, on an
NVIDIA GPU. Marked `cuda`: every test skips where torch.cuda.is_available()
is false. On a GPU machine run them with

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda
"""
import json

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
        bad = (g != e).reshape(g.shape[0], -1).any(-1).nonzero()
        assert torch.equal(g, e), (name, len(bad), bad[:4].tolist())


@pytest.mark.parametrize("n_frames,lines_pf,limits,per_line", [
    (4, 588, (4, 2), False),     # NORMAL, PAL frames
    (2, 588, (10, 4), False),    # INSANE
    (2, 300, (4, 2), True),      # per-line levels, ragged last tile
    (1, 37, (2, 1), False),      # fewer lines than one tile
    (16, 588, (4, 2), False),    # the round's shape
    (64, 1, (4, 2), False),      # the marker fallback's batches
    (2, 490, (4, 2), True),      # NTSC frames
    (2, 100, (10, 4), True),     # n_h 11, n_s 5, per-line levels
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


def reversed_coords(n_frames, seed, device):
    """Coordinates with stop < start (negative pixels per bit: C's `/`
    truncates where torch's `//` floors), some near the edges, as int64
    [F, 2] on `device`."""
    rng = np.random.default_rng(seed)
    start = rng.integers(200, W + 40, n_frames)
    stop = start - rng.integers(1, 900, n_frames)
    stop[::3] = rng.integers(-300, 40, len(stop[::3]))
    return torch.from_numpy(np.stack([start, stop], 1)).to(device)


@pytest.mark.parametrize("dtype", [torch.int64, torch.int32])
def test_binarize_kernel_reversed_coords(cuda, dtype):
    """stop < start (and coordinates past both edges) on every field of
    every line; int64 and int32 coordinates, given as a strided view."""
    px, _ = noisy_frames(6, 64, 30.0, seed=9, device=cuda)
    cd = reversed_coords(6, seed=10, device=cuda).to(dtype)
    cd_view = torch.stack([cd, cd], 2)[..., 0]    # strides (4, 2)
    assert not cd_view.is_contiguous()
    gen = torch.Generator().manual_seed(4)
    ref = torch.randint(60, 160, (6, 64), generator=gen,
                        dtype=torch.int32).to(cuda)
    black = torch.full((6, 64), 20, dtype=torch.int32, device=cuda)
    white = torch.full((6,), 200, dtype=torch.int32, device=cuda)
    white = white[:, None].expand(6, 64)          # line stride 0
    got = fb.stc007_fused_decode_frames(px, cd_view, ref, black, white,
                                        4, 2)
    torch.cuda.synchronize()
    expect = bz.stc007_frame_decode(px, cd, ref, black, white, 4, 2)
    assert_batches_equal(got, expect)
    cd0 = (int(cd[0, 0]), int(cd[0, 1]))
    got = fb.stc007_fused_decode(px[0], cd0, ref[0], black[0], white[0],
                                 4, 2)
    expect = bz.stc007_frame_decode(px[:1], cd[:1], ref[:1], black[:1],
                                    white[:1], 4, 2)
    assert_batches_equal(got, bz.LineBatch(*(t[0] for t in expect)))


@pytest.mark.parametrize("layout", ["width", "offset"])
def test_binarize_kernel_plain_staging(cuda, layout):
    """Rows the TMA cannot copy, staged by the kernel with plain loads:
    a width that is not a multiple of 16 bytes, or pixels 1 byte past a
    16-byte boundary. Both wrappers, on every field of every line."""
    import chip_smoke
    px, cd = noisy_frames(3, 100, 30.0, seed=12, device=cuda)
    x = list(chip_smoke.plain_staged(px).values())[layout == "offset"]
    gen = torch.Generator().manual_seed(5)
    ref = torch.randint(100, 121, (3, 100), generator=gen,
                        dtype=torch.int32).to(cuda)
    black = torch.full((3, 100), 20, dtype=torch.int32, device=cuda)
    white = torch.full((3, 100), 200, dtype=torch.int32, device=cuda)
    got = fb.stc007_fused_decode_frames(x, cd, ref, black, white, 10, 4)
    torch.cuda.synchronize()
    expect = bz.stc007_frame_decode(x, cd, ref, black, white, 10, 4)
    assert_batches_equal(got, expect)
    got = fb.stc007_fused_decode(x[1], (int(cd[1, 0]), int(cd[1, 1])),
                                 ref[1], black[1], white[1], 4, 2)
    expect = bz.stc007_frame_decode(x[1:2], cd[1:2], ref[1:2], black[1:2],
                                    white[1:2], 4, 2)
    assert_batches_equal(got, bz.LineBatch(*(t[0] for t in expect)))


def wrapper_rows():
    """torch.profiler's CUDA rows of one call of each wrapper on CUDA
    tensors (chip_smoke.cuda_rows), by wrapper."""
    import chip_smoke
    cuda = torch.device("cuda")
    px, cd = noisy_frames(16, 588, 10.0, seed=11, device=cuda)
    lv = [torch.full((16,), v, dtype=torch.int32, device=cuda)
          for v in (110, 20, 200)]
    glv = [t[0].expand(588) for t in lv]
    coords = (int(cd[0, 0]), int(cd[0, 1]))
    calls = {
        "frames": lambda: fb.stc007_fused_decode_frames(px, cd, *lv),
        "group": lambda: fb.stc007_fused_decode(px[0], coords, *glv)}
    return {name: chip_smoke.cuda_rows(fn) for name, fn in calls.items()}


# Runs wrapper_rows in a process of its own. In a process where
# torch.profiler has traced the card and two threads have then captured
# CUDA graphs (test_torch_round_graph_cuda.py's
# test_two_threads_capture_on_one_card after the traced tests of the
# graph files), every later trace holds no CUDA row at all, for any
# kernel: CUPTI's state, not the wrapper's.
WRAPPER_ROWS = """
import json, sys
sys.path[:0] = [sys.argv[1], sys.argv[2]]
import test_torch_kernels_cuda
print("ROWS " + json.dumps(test_torch_kernels_cuda.wrapper_rows()))
"""


def test_wrappers_launch_one_kernel_and_copy_nothing(cuda):
    """On CUDA tensors each wrapper call is one kernel launch and no
    host-to-device copy (torch.profiler's CUDA rows of one call, taken in
    a fresh process so that no earlier test's tracing bears on it)."""
    import subprocess
    import sys
    from pathlib import Path
    tests = Path(__file__).resolve().parent
    proc = subprocess.run(
        [sys.executable, "-c", WRAPPER_ROWS, str(tests.parent), str(tests)],
        cwd=tests.parent, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    rows = json.loads(proc.stdout.split("ROWS ", 1)[1])
    assert set(rows) == {"frames", "group"}
    for name, r in rows.items():
        assert r["kernels"] == ["stc007_binarize_frames_kernel"], \
            (name, r)
        assert r["copies"] == [], (name, r)


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


LEVELS = np.arange(254, 1, -4, dtype=np.int32)


@pytest.mark.parametrize("n_frames,lines_pf,limits", [
    (4, 588, (4, 2)),      # NORMAL, PAL frames
    (2, 588, (10, 4)),     # INSANE
    (64, 1, (4, 2)),       # the sweep fallback's bucket
    (64, 1, (10, 4)),
])
def test_sweep_kernel_route_matches_plain(cuda, n_frames, lines_pf, limits):
    """The level sweep through K1 (one launch per level) against the
    plain sweep: every field at every level, with black/white that leave
    levels outside the open interval; R launches and no copy per call."""
    import chip_smoke
    px, cd = noisy_frames(n_frames, lines_pf, 30.0, seed=lines_pf,
                          device=cuda)
    gen = torch.Generator().manual_seed(7)
    black = torch.randint(0, 90, (n_frames,), generator=gen,
                          dtype=torch.int32).to(cuda)
    white = torch.randint(130, 256, (n_frames,), generator=gen,
                          dtype=torch.int32).to(cuda)
    levels = torch.from_numpy(LEVELS).to(cuda)
    before = fb.stc007_fused_decode_frames.launches
    got = fb.stc007_ref_sweep_decode(px, cd, black, white, levels, *limits)
    torch.cuda.synchronize()
    assert fb.stc007_fused_decode_frames.launches == before + len(LEVELS)
    expect = bz.stc007_ref_sweep_decode(px, cd, black, white, levels,
                                        *limits)
    assert set(got) == set(expect)
    for name, e in expect.items():
        g = got[name]
        assert g.dtype == e.dtype and g.shape == e.shape, name
        assert torch.equal(g, e), name
    outside = (levels[:, None] <= black[None]) \
        | (levels[:, None] >= white[None])
    assert bool(outside.any()) and not bool(got["valid"][outside].any())
    rows = chip_smoke.cuda_rows(lambda: fb.stc007_ref_sweep_decode(
        px, cd, black, white, levels, *limits), launches=len(LEVELS))
    # The exact count is the wrapper's (above); a trace may lack a few of
    # the 64 rows, but holds nothing but K1 and no copy.
    assert set(rows["kernels"]) == {"stc007_binarize_frames_kernel"}, rows
    assert 0 < len(rows["kernels"]) <= len(LEVELS), rows
    assert rows["copies"] == [], rows


def test_sweep_refuses_what_the_kernel_cannot_take(cuda):
    """On CUDA tensors the sweep launches K1 or raises: it never runs the
    plain sweep instead."""
    px, cd = noisy_frames(2, 40, 10.0, seed=1, device=cuda)
    lv = torch.full((2,), 20, dtype=torch.int32, device=cuda)
    levels = torch.from_numpy(LEVELS).to(cuda)
    with pytest.raises(ValueError):
        fb.stc007_ref_sweep_decode(px[:, :, ::2], cd, lv, lv + 180, levels)
    with pytest.raises(ValueError):
        fb.stc007_ref_sweep_decode(px, cd, lv[:1], lv + 180, levels)


@pytest.mark.parametrize("quality", ["normal", "insane"])
def test_driver_sweep_kernel_route_matches_plain(cuda, tmp_path, quality):
    """The chip-resident driver at the CLI's NORMAL and INSANE settings on
    a noisy 8-frame PAL capture: the WAV with the sweeps through K1 equals
    the WAV with the plain sweeps, and the sweeps ran."""
    import chip_smoke
    from sdvpcmdecoder_tpu_torch.pipeline import device_driver as dd
    cap = chip_smoke.write_capture(str(tmp_path / "c.y4m"), 8, 294, seed=3,
                                   noise=34.0)
    hyst, shift = (4, 2) if quality == "normal" else (10, 4)
    wavs, sweeps = {}, {}
    for use_kernel in (True, False):
        out = str(tmp_path / f"o{int(use_kernel)}.wav")
        before = fb.stc007_fused_decode_frames.launches
        dec = dd.DeviceBatchDecoder(
            [(cap, out)], hyst_limit=hyst, shift_limit=shift,
            frames_per_round=4, device=cuda, use_kernel=use_kernel,
            ref_sweep=quality == "insane",
            ref_sweep_fallback=quality == "normal",
            normal_sweep_prescan=True)
        dec.run()
        j = dec.jobs[0]
        sweeps[use_kernel] = j.driver.sweep_calls
        launched = fb.stc007_fused_decode_frames.launches - before
        if use_kernel:
            assert launched == len(j.round_chained) \
                + j.driver.fallback_batches \
                + len(LEVELS) * j.driver.sweep_calls
        else:
            assert launched == 0
        wavs[use_kernel] = open(out, "rb").read()
    assert wavs[True] == wavs[False]
    assert sweeps[True] == sweeps[False] > 0


def test_v2d_per_line_agc_goes_through_k1(cuda):
    """per_line_agc hands the streamed dispatch levels [F, L]: with
    use_kernel it launches K1 on them (one launch a dispatch) and decodes
    as the plain grid does."""
    from sdvpcmdecoder_tpu_torch.pipeline import v2d
    px, _ = noisy_frames(4, 588, 26.0, seed=5, device="cpu")
    px = px.numpy()
    res = {}
    for use_kernel in (True, False):
        drv = v2d.V2DDriver(hyst_limit=4, shift_limit=2, per_line_agc=True,
                            device=cuda, use_kernel=use_kernel)
        prep = drv.prepare_frames(px)
        assert prep["refs"].ndim == 2
        before = fb.stc007_fused_decode_frames.launches
        res[use_kernel] = drv.dispatch_frames(px, prep)
        assert fb.stc007_fused_decode_frames.launches - before \
            == int(use_kernel)
    for a, b in zip(res[True], res[False]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert res[True][2].any()


def test_cli_default_backend_runs_the_grid_on_the_card(cuda, tmp_path):
    """The CLI with no --backend and no --device: every batch's trial grid
    is a K1 launch, and the WAV is the explicit native backend's."""
    import chip_smoke
    from sdvpcmdecoder_tpu_torch.__main__ import main
    cap = chip_smoke.write_capture(str(tmp_path / "c.y4m"), 12, 294, seed=1)
    outs = [str(tmp_path / f"o{k}.wav") for k in range(2)]
    before = fb.stc007_fused_decode_frames.launches
    assert main([cap, "-o", outs[0], "--batch", "4"]) == 0
    assert fb.stc007_fused_decode_frames.launches - before >= 3
    before = fb.stc007_fused_decode_frames.launches
    assert main([cap, "-o", outs[1], "--batch", "4", "--backend",
                 "native"]) == 0
    assert fb.stc007_fused_decode_frames.launches == before
    assert open(outs[0], "rb").read() == open(outs[1], "rb").read()


def test_cli_on_the_card_matches_the_golden_hash(cuda, tmp_path):
    """python -m sdvpcmdecoder_tpu_torch at its defaults (device cuda) on
    the noisy golden capture, under every backend."""
    import hashlib

    import chip_smoke
    from sdvpcmdecoder_tpu_torch.__main__ import main
    cap = chip_smoke.write_capture(str(tmp_path / "n.y4m"),
                                   **chip_smoke.CLI_NOISY)
    out = str(tmp_path / "o.wav")
    for quality, backend, extra in chip_smoke.CLI_GOLDEN_RUNS:
        assert main([cap, "-o", out, "--quality", quality, "--backend",
                     backend] + extra) == 0
        assert hashlib.sha256(open(out, "rb").read()).hexdigest() == \
            chip_smoke.GOLDEN_CLI_SHA256["noisy"], (quality, backend)


@pytest.mark.parametrize("fmt,sigma", [("pcm1", 0.0), ("pcm1", 14.0),
                                       ("pcm16x0", 0.0), ("pcm16x0", 10.0)])
@pytest.mark.parametrize("hl,sl", [(2, 1), (4, 2)])
def test_pcm_grid_on_the_card_equals_the_cpu(cuda, tmp_path, fmt, sigma, hl,
                                             sl):
    """pcm1_frame_decode / pcm16x0_frame_decode (plain torch, no hand
    kernel) on CUDA tensors give the CPU's outputs, dtypes included, and
    launch no K1."""
    import chip_smoke
    path = str(tmp_path / "c.y4m")
    if sigma:
        chip_smoke.write_pcm_noisy(path, fmt, 4, 3, sigma)
    elif fmt == "pcm1":
        chip_smoke.write_pcm1_capture(path, n_frames=4, seed=3)
    else:
        chip_smoke.write_pcm16x0_capture(path, n_frames=4, seed=3)
    inputs = chip_smoke.pcm_grid_inputs(path, fmt, cuda)
    fn = chip_smoke.pcm_frame_decode(fmt)
    before = fb.stc007_fused_decode_frames.launches
    got = fn(*inputs, shift_limit=sl, hyst_limit=hl)
    want = fn(*(t.cpu() for t in inputs), shift_limit=sl, hyst_limit=hl)
    assert fb.stc007_fused_decode_frames.launches == before
    assert len(got) == len(want)
    for g, e in zip(got, want):
        assert g.device.type == "cuda"
        assert g.dtype == e.dtype and torch.equal(g.cpu(), e)
    assert want[2].any()


@pytest.mark.parametrize("fmt,sigma", [("pcm1", 0.0), ("pcm1", 30.0),
                                       ("pcm16x0", 26.0), ("pcm1630", 0.0)])
def test_device_pcm_driver_on_the_card_matches_native(cuda, tmp_path, fmt,
                                                      sigma):
    """DevicePCMBatchDecoder on the card writes the WAVs of the native
    BatchDecoder; the noisy captures send frames back for refinement."""
    import chip_smoke
    from sdvpcmdecoder_tpu_torch.pipeline import batch_driver as bd
    from sdvpcmdecoder_tpu_torch.pipeline import device_pcm
    writers = {"pcm1": chip_smoke.write_pcm1_capture,
               "pcm16x0": chip_smoke.write_pcm16x0_capture,
               "pcm1630": chip_smoke.write_pcm1630_capture}
    caps = []
    for i in range(2):
        path = str(tmp_path / f"c{i}.y4m")
        if sigma:
            chip_smoke.write_pcm_noisy(path, fmt, 6, 40 + i, sigma)
        else:
            writers[fmt](path, n_frames=4, seed=40 + i)
        caps.append(path)
    kw = dict(fmt=fmt, hyst_limit=0, shift_limit=1, frames_per_round=3)
    wavs = {}
    for name, cls, extra in (
            ("device", device_pcm.DevicePCMBatchDecoder, dict(device=cuda)),
            ("native", bd.BatchDecoder, dict(backend="native",
                                             device=cuda))):
        outs = [str(tmp_path / f"{name}{i}.wav") for i in range(2)]
        dec = cls(list(zip(caps, outs)), **kw, **extra)
        dec.run()
        wavs[name] = [open(o, "rb").read() for o in outs]
        if name == "device" and sigma:
            assert dec.fetched_frames > 0
    assert wavs["device"] == wavs["native"]
    assert all(len(w) > 1000 for w in wavs["device"])
