"""Port checks: V2DDriver's streaming methods and FullDecoder against the
JAX package's, on the CPU (device="cpu": the frame grid runs its plain
torch version).

dispatch_frames_async + materialize_frames, decode_frames,
decode_frames_host (also with a row map), decode_prepared_host with the
native core switched off, decode_frame, per-line AGC and forced
coordinates: every field of every FrameDecodeResult equals the JAX
driver's, values and dtypes, on the same numpy-seeded frames. The drivers
are fed several batches so the damped histories and the good-params skip
take part.
"""
import numpy as np
import pytest
import torch

from test_torch_sweep import assert_result_equal, dimmed, drivers
from sdvpcmdecoder_tpu.ops import stitch_native as jsn
from sdvpcmdecoder_tpu.pipeline import full_decoder as jfd
from sdvpcmdecoder_tpu.pipeline import ingest as jingest
from sdvpcmdecoder_tpu.synth import encoder as jenc
from sdvpcmdecoder_tpu_torch.ops import stitch_native as tsn
from sdvpcmdecoder_tpu_torch.pipeline import full_decoder as tfd
from sdvpcmdecoder_tpu_torch.utils.host import HostCopy

torch.set_num_threads(1)

W = 1152


def frames(F, L, seed, sigma=24.0, knock=True):
    """[F, L, W] noisy frames of field-sequential lines; with `knock`, a
    few lines shifted sideways (the marker fallback re-finds them), a few
    dimmed (the NORMAL sweep fallback's case) and one blanked."""
    rng = np.random.default_rng(seed)
    n = 3 * F * L
    px, coords, *_ = jenc.encode_stream(
        rng.integers(1, 1 << 14, n), rng.integers(1, 1 << 14, n), width=W,
        ppb=8.0, n_lines=F * L, noise_sigma=sigma, rng=rng)
    px = px.reshape(F, L, W).copy()
    if knock:
        for f in range(F):
            px[f, 3 + f] = np.roll(px[f, 3 + f], 9)
            px[f] = dimmed(px[f], [7, L - 4], lo=12, hi=110)
            px[f, L - 2] = 16
    return px


def assert_results_equal(got, expect):
    assert len(got) == len(expect)
    for g, e in zip(got, expect):
        assert_result_equal(g, e)


CONFIGS = {
    "fast": dict(),
    "normal": dict(hyst_limit=4, shift_limit=2, ref_sweep_fallback=True,
                   normal_sweep_prescan=True),
    "insane": dict(hyst_limit=4, shift_limit=2, ref_sweep=True,
                   normal_sweep_prescan=True),
    "agc": dict(per_line_agc=True),
    "m2": dict(m2=True, dup_detect=True),
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_decode_frames_matches_jax(name):
    jd, td = drivers(**CONFIGS[name])
    for seed in (1, 2, 3):
        px = frames(2, 40, seed)
        got = td.decode_frames(px)
        assert_results_equal(got, jd.decode_frames(px))
    assert any(r is not None and not r.valid.all() for r in got)
    assert td.fallback_batches > 0
    if name in ("normal", "insane"):
        assert td.sweep_calls > 0


def test_dispatch_async_then_materialize_matches_jax():
    """The split the batch driver uses: the async dispatch hands back
    copies in flight, materialize reads them in the transfer dtypes
    (int16 words, uint16 CRC) that the JAX package's returns."""
    jd, td = drivers(hyst_limit=4, shift_limit=2)
    px = frames(3, 32, seed=5)
    jp, tp = jd.prepare_frames(px), td.prepare_frames(px)
    batch = td.dispatch_frames_async(px, tp)
    assert isinstance(batch.words, HostCopy)
    assert batch.words.numpy().shape == (3, 32 * 8)
    got = td.materialize_frames(px, tp, batch)
    expect = jd.materialize_frames(px, jp, jd.dispatch_frames_async(px, jp))
    for a, b in zip(got, expect):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert got[0].dtype == np.int16 and got[1].dtype == np.uint16
    assert_results_equal(td.finalize_frames(px, tp, *got),
                         jd.finalize_frames(px, jp, *expect))
    # A concatenation of two drivers' prepared batches in one dispatch.
    jd2, td2 = drivers(hyst_limit=4, shift_limit=2)
    px2 = frames(2, 32, seed=6)
    tp2 = td2.prepare_frames(px2)
    cat = {k: np.concatenate([tp[k], tp2[k]]) for k in tp}
    both = td.dispatch_frames(np.concatenate([px, px2]), cat)
    for a, b in zip(both, got):
        np.testing.assert_array_equal(a[:3], b)


@pytest.mark.parametrize("name", ["fast", "normal", "insane", "agc"])
def test_decode_frames_host_with_perm_matches_jax(name):
    """The native backend on the raw frame-row view: rows interleaved as
    in a capture, `perm` mapping field-sequential lines onto them."""
    assert tsn.available()
    jd, td = drivers(**CONFIGS[name])
    L = 40
    perm, _ = jingest.field_perm(L)
    inv = np.argsort(perm)
    for seed in (7, 8):
        px = frames(2, L, seed)
        raw = np.ascontiguousarray(px[:, inv])   # raw[perm] == px
        got = td.decode_frames_host(raw, perm=perm)
        assert_results_equal(got, jd.decode_frames_host(raw, perm=perm))
    # and without a row map
    px = frames(2, L, seed=9)
    assert_results_equal(td.decode_frames_host(px),
                         jd.decode_frames_host(px))


@pytest.mark.parametrize("name", ["fast", "normal", "agc"])
def test_decode_prepared_host_without_native(name, monkeypatch):
    """SDV_NO_NATIVE=1 (here: both loaders report the core unavailable):
    the host backend runs through the device dispatch, the documented
    route of the JAX package."""
    monkeypatch.setenv("SDV_NO_NATIVE", "1")
    monkeypatch.setattr(jsn, "available", lambda: False)
    monkeypatch.setattr(tsn, "available", lambda: False)
    jd, td = drivers(**CONFIGS[name])
    L = 32
    perm, _ = jingest.field_perm(L)
    inv = np.argsort(perm)
    px = frames(2, L, seed=11)
    raw = np.ascontiguousarray(px[:, inv])
    jp = jd.prepare_frames(raw, perm=perm)
    tp = td.prepare_frames(raw, perm=perm)
    assert_results_equal(td.decode_prepared_host(raw, tp, perm=perm),
                         jd.decode_prepared_host(raw, jp, perm=perm))


@pytest.mark.parametrize("name", ["fast", "normal", "insane"])
def test_decode_frame_matches_jax(name):
    jd, td = drivers(**CONFIGS[name])
    px = frames(3, 36, seed=13)
    for f in range(3):
        assert_result_equal(td.decode_frame(px[f]), jd.decode_frame(px[f]))
    # no PCM at all, then history carries a blank frame
    blank = np.full((36, W), 16, np.uint8)
    assert_result_equal(td.decode_frame(blank), jd.decode_frame(blank))
    jd0, td0 = drivers()
    assert td0.decode_frame(blank) is None and jd0.decode_frame(blank) is None


def test_forced_coords_and_unusable_frames_match_jax():
    px = frames(3, 32, seed=15, knock=False)
    px[1] = 16                       # a frame with no PCM
    jd, td = drivers(forced_coords=(40, 1096))
    assert_results_equal(td.decode_frames(px), jd.decode_frames(px))
    jd, td = drivers()
    got = td.decode_frames(px[1:2])
    assert got == [None] and jd.decode_frames(px[1:2]) == [None]
    assert_results_equal(td.decode_frames(px), jd.decode_frames(px))
    assert_results_equal(td.decode_frames_host(px),
                         jd.decode_frames_host(px))


def test_use_kernel_on_cpu_tensors_runs_the_plain_grid():
    """use_kernel=True routes through the kernel's wrappers; on the CPU
    they run the plain versions, so the results do not change."""
    from sdvpcmdecoder_tpu_torch.pipeline import v2d as tv2d
    kw = CONFIGS["normal"]
    a = tv2d.V2DDriver(device="cpu", use_kernel=True, **kw)
    b = tv2d.V2DDriver(device="cpu", use_kernel=False, **kw)
    px = frames(2, 32, seed=17)
    assert_results_equal(a.decode_frames(px), b.decode_frames(px))
    assert a.sweep_calls == b.sweep_calls > 0


@pytest.mark.parametrize("per_line", [False, True])
def test_use_kernel_dispatch_goes_through_the_kernel_wrapper(per_line,
                                                             monkeypatch):
    """With use_kernel the streamed dispatch calls K1's wrapper for
    per-frame and per-line (per_line_agc) levels alike, never the plain
    grid directly: on a CUDA tensor the wrapper launches or raises."""
    from sdvpcmdecoder_tpu_torch.ops import binarize as tbz
    from sdvpcmdecoder_tpu_torch.ops import fused_binarize as tfb
    from sdvpcmdecoder_tpu_torch.pipeline import v2d as tv2d
    seen = []
    wrapper, plain = tfb.stc007_fused_decode_frames, tbz.stc007_frame_decode
    monkeypatch.setattr(
        tfb, "stc007_fused_decode_frames",
        lambda px, cd, ref, *a, **kw: (seen.append(("k1", ref.dim())),
                                       wrapper(px, cd, ref, *a, **kw))[1])
    monkeypatch.setattr(
        tbz, "stc007_frame_decode",
        lambda *a, **kw: (seen.append(("plain",)), plain(*a, **kw))[1])
    td = tv2d.V2DDriver(device="cpu", use_kernel=True,
                        per_line_agc=per_line)
    px = frames(2, 32, seed=19, knock=False)
    td.dispatch_frames(px, td.prepare_frames(px))
    assert seen[0] == ("k1", 2 if per_line else 1)
    seen.clear()
    td = tv2d.V2DDriver(device="cpu", use_kernel=False,
                        per_line_agc=per_line)
    td.dispatch_frames(px, td.prepare_frames(px))
    assert seen == [("plain",)]


def test_full_decoder_matches_jax(tmp_path):
    """FullDecoder: frames in, WAV out, byte-equal to the JAX package's."""
    rng = np.random.default_rng(19)
    lpf, nf = 294, 3
    n = 3 * nf * 2 * lpf
    fr = jenc.encode_fields(rng.integers(1, 1 << 14, n),
                            rng.integers(1, 1 << 14, n), nf, lines_pf=lpf)
    pix = []
    for f in fr:
        px, coords = jenc.render_lines(f["line_words"], f["crcs"], width=W,
                                       ppb=8.0, noise_sigma=12.0, rng=rng)
        pix.append(px)
    cd = (int(coords[0, 0]), int(coords[0, 1]))
    jdec = jfd.FullDecoder(lines_per_field=lpf, hyst_limit=2, shift_limit=1)
    tdec = tfd.FullDecoder(lines_per_field=lpf, hyst_limit=2, shift_limit=1,
                           device="cpu")
    js = jdec.decode_to_wav(iter(pix), str(tmp_path / "j.wav"), cd)
    ts = tdec.decode_to_wav(iter(pix), str(tmp_path / "t.wav"), cd)
    assert ts.dtype == js.dtype and len(ts) > 1000
    np.testing.assert_array_equal(ts, js)
    assert (tmp_path / "t.wav").read_bytes() == \
        (tmp_path / "j.wav").read_bytes()
    # the per-frame store of one more frame
    a = jdec.decode_frame_fields(pix[0], cd, 20, 200, np.arange(2 * lpf))
    b = tdec.decode_frame_fields(pix[0], cd, 20, 200, np.arange(2 * lpf))
    np.testing.assert_array_equal(a.words, b.words)
    np.testing.assert_array_equal(a.source_crc, b.source_crc)
    np.testing.assert_array_equal(a.crc_valid(), b.crc_valid())
