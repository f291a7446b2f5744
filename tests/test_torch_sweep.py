"""Port checks: the reference-level sweeps against the JAX package.

ops/binarize.stc007_ref_sweep_decode (the plain torch sweep) and
ops/fused_binarize.stc007_ref_sweep_decode (the sweep through the CUDA
kernel K1; on CPU tensors it runs the plain sweep) against the JAX
package's sweep, and the three V2DDriver methods that call them
(_sweep_sample_refs, _sweep_failed_lines, _ref_sweep_merge) against the
JAX driver's, with mirrors of tests/test_ref_sweep.py and
tests/test_normal_sweep.py. Inputs come from a numpy seed; every output is
an integer or a bool, so every comparison is exact and checks the dtype.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from test_normal_sweep import _render_collision_frame
from sdvpcmdecoder_tpu.ops import agc as jagc
from sdvpcmdecoder_tpu.ops import binarize as jbz
from sdvpcmdecoder_tpu.ops import stitch_native as jsn
from sdvpcmdecoder_tpu.pipeline import v2d as jv2d
from sdvpcmdecoder_tpu.synth import encoder as jenc
from sdvpcmdecoder_tpu_torch.ops import agc as tagc
from sdvpcmdecoder_tpu_torch.ops import binarize as bz
from sdvpcmdecoder_tpu_torch.ops import fused_binarize as fb
from sdvpcmdecoder_tpu_torch.ops import stitch_native as tsn
from sdvpcmdecoder_tpu_torch.pipeline import v2d as tv2d

torch.set_num_threads(1)

LEVELS = np.arange(254, 1, -4, dtype=np.int32)
W = 1152


def noisy(F, L, seed, sigma=25.0):
    """[F, L, W] noisy encoder lines, per-frame coords, the true words."""
    rng = np.random.default_rng(seed)
    n = 3 * F * L
    px, coords, words, _ = jenc.encode_stream(
        rng.integers(1, 1 << 14, n), rng.integers(1, 1 << 14, n), width=W,
        ppb=8.0, n_lines=F * L, noise_sigma=sigma, rng=rng)
    return px.reshape(F, L, W), coords[::L].astype(np.int32), words


def dimmed(px, rows, lo=5, hi=60):
    """Lines `rows` of [L, W] pixels rescaled from 20..200 to lo..hi (the
    recipe of tests/test_ref_sweep.py)."""
    out = px.astype(np.float64)
    out[rows] = lo + (out[rows] - 20) * (hi - lo) / (200 - 20)
    return np.clip(out, 0, 255).astype(np.uint8)


def jax_sweep(px, cd, bk, wt, limits):
    out = jbz.stc007_ref_sweep_decode(
        jnp.asarray(px), jnp.asarray(cd), jnp.asarray(bk), jnp.asarray(wt),
        jnp.asarray(LEVELS), hyst_limit=limits[0], shift_limit=limits[1])
    return {k: np.asarray(v) for k, v in out.items()}


def torch_sweep(fn, px, cd, bk, wt, limits):
    out = fn(torch.from_numpy(px), torch.from_numpy(cd),
             torch.from_numpy(bk), torch.from_numpy(wt),
             torch.from_numpy(LEVELS), hyst_limit=limits[0],
             shift_limit=limits[1])
    return {k: v.numpy() for k, v in out.items()}


def assert_sweeps_equal(got, expect):
    assert set(got) == set(expect) == {"valid", "crc", "hyst", "shift",
                                       "words"}
    for k in expect:
        assert got[k].dtype == expect[k].dtype, (k, got[k].dtype)
        np.testing.assert_array_equal(got[k], expect[k], err_msg=k)


@pytest.mark.parametrize("limits", [(2, 1), (4, 2), (10, 4)])
@pytest.mark.parametrize("F,L", [(1, 16), (3, 24), (64, 1)])
def test_sweep_matches_jax(F, L, limits):
    """Every field at every level, with black/white that leave many
    levels outside the open interval (those lines are invalid and carry
    trial (0, 0)'s words, as in the scan)."""
    px, cd, _ = noisy(F, L, seed=F + 7 * L + limits[0])
    rng = np.random.default_rng(F)
    bk = rng.integers(0, 90, F).astype(np.int32)
    wt = rng.integers(130, 256, F).astype(np.int32)
    expect = jax_sweep(px, cd, bk, wt, limits)
    got = torch_sweep(bz.stc007_ref_sweep_decode, px, cd, bk, wt, limits)
    assert_sweeps_equal(got, expect)
    assert tuple(got["valid"].shape) == (len(LEVELS), F, L)
    assert tuple(got["words"].shape) == (len(LEVELS), F, L, 8)
    outside = (LEVELS[:, None] <= bk[None]) | (LEVELS[:, None] >= wt[None])
    assert outside.any() and not got["valid"][outside].any()
    assert got["valid"].any()


@pytest.mark.parametrize("F,L,limits", [(1, 16, (2, 1)), (3, 24, (4, 2)),
                                        (64, 1, (10, 4))])
def test_fused_sweep_on_cpu_is_the_plain_sweep(F, L, limits):
    """The kernel route's wrapper given CPU tensors runs the plain sweep
    and counts no kernel launch."""
    px, cd, _ = noisy(F, L, seed=3)
    bk = np.full(F, 30, np.int32)
    wt = np.full(F, 180, np.int32)
    before = fb.stc007_fused_decode_frames.launches
    got = torch_sweep(fb.stc007_ref_sweep_decode, px, cd, bk, wt, limits)
    plain = torch_sweep(bz.stc007_ref_sweep_decode, px, cd, bk, wt, limits)
    assert_sweeps_equal(got, plain)
    assert before == fb.stc007_fused_decode_frames.launches


def test_sweep_level_is_one_frame_decode():
    """One level of the sweep is stc007_frame_decode at that level for
    every frame (what the kernel route launches per level)."""
    px, cd, _ = noisy(2, 20, seed=9)
    bk = np.array([20, 60], np.int32)
    wt = np.array([200, 150], np.int32)
    sw = torch_sweep(bz.stc007_ref_sweep_decode, px, cd, bk, wt, (4, 2))
    for r in (0, 20, 31, 47, 63):
        one = bz.stc007_frame_decode(
            torch.from_numpy(px), torch.from_numpy(cd),
            torch.full((2,), int(LEVELS[r]), dtype=torch.int32),
            torch.from_numpy(bk), torch.from_numpy(wt), 4, 2)
        np.testing.assert_array_equal(sw["valid"][r], one.valid.numpy())
        np.testing.assert_array_equal(sw["crc"][r], one.crc_read.numpy())
        np.testing.assert_array_equal(sw["words"][r], one.words.numpy())
        np.testing.assert_array_equal(sw["hyst"][r], one.hyst.numpy())
        np.testing.assert_array_equal(sw["shift"][r], one.shift.numpy())


def test_pick_ref_sweep_matches_jax_on_a_real_sweep():
    px, cd, _ = noisy(2, 24, seed=4, sigma=30.0)
    bk = np.full(2, 20, np.int32)
    wt = np.full(2, 200, np.int32)
    sw = torch_sweep(bz.stc007_ref_sweep_decode, px, cd, bk, wt, (4, 2))
    flat = [sw[k].reshape(len(LEVELS), -1)
            for k in ("valid", "crc", "hyst", "shift")]
    for got, expect in zip(bz.pick_ref_sweep(*flat),
                           jbz.pick_ref_sweep(*flat)):
        assert got.dtype == expect.dtype
        np.testing.assert_array_equal(got, expect)


# -- V2DDriver's sweep methods ------------------------------------------------

def drivers(**kw):
    kw.setdefault("hyst_limit", 2)
    kw.setdefault("shift_limit", 1)
    tkw = dict(kw)
    if "preset" in kw:
        tkw["preset"] = tagc.BinPreset(**kw["preset"])
        kw["preset"] = jagc.BinPreset(**kw["preset"])
    return jv2d.V2DDriver(**kw), tv2d.V2DDriver(device="cpu", **tkw)


def assert_result_equal(got, expect):
    """FrameDecodeResult of the port vs the JAX package's."""
    if expect is None:
        assert got is None
        return
    for name in ("words", "crc_read", "valid", "duplicates", "forced_bad"):
        a, b = np.asarray(getattr(got, name)), np.asarray(getattr(expect,
                                                                  name))
        assert a.dtype == b.dtype, (name, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert (got.ref_level, got.black, got.white) == \
        (expect.ref_level, expect.black, expect.white)
    assert tuple(got.coords) == tuple(expect.coords)


@pytest.mark.parametrize("native", [True, False])
def test_sweep_sample_refs_matches_jax(native, monkeypatch):
    """The NORMAL prescan sweep, through the native core and (with the
    core switched off in both packages) through the device sweep: frames
    of one line [N, 1, W]."""
    if not native:
        monkeypatch.setattr(jsn, "available", lambda: False)
        monkeypatch.setattr(tsn, "available", lambda: False)
    F, L = 3, 40
    px, _, _ = noisy(F, L, seed=21, sigma=12.0)
    px[1] = dimmed(px[1], np.arange(L), lo=10, hi=150)
    jd, td = drivers(normal_sweep_prescan=True)
    ja, ta = jd.prepare_frames(px), td.prepare_frames(px)
    assert td.sweep_calls == (0 if native else 1)
    for k in ("coords", "refs", "blacks", "whites", "usable"):
        assert ta[k].dtype == ja[k].dtype, k
        np.testing.assert_array_equal(ta[k], ja[k], err_msg=k)
    # The swept level differs from the bare centre level somewhere.
    plain = drivers()[1].prepare_frames(px)
    assert not np.array_equal(plain["refs"], ta["refs"])


def test_sweep_failed_lines_matches_jax_agc_gate_and_buckets():
    """70 dim lines (two buckets of 64) recovered by the per-line sweep;
    blank lines fail the AGC gate and never reach it."""
    L = 96
    px, cd, words = noisy(1, L, seed=23, sigma=0.0)
    dim = np.arange(4, 74)
    blank = np.array([80, 85])
    px = dimmed(px[0], dim)
    px[blank] = 16
    preset = dict(min_white_lvl=40, max_black_lvl=30)
    jd, td = drivers(ref_sweep_fallback=True, preset=preset)
    coords = (int(cd[0, 0]), int(cd[0, 1]))
    w0 = np.zeros((L, 8), np.int32)
    c0 = np.zeros(L, np.int32)
    v0 = np.ones(L, bool)
    v0[dim] = v0[blank] = False
    f0 = np.zeros(L, bool)
    expect = jd._sweep_failed_lines(px, coords, 0, 255, w0, c0, v0, f0)
    got = td._sweep_failed_lines(px, coords, 0, 255, w0, c0, v0, f0)
    assert td.sweep_calls == 2
    for a, b in zip(got, expect):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert got[2][dim].all() and not got[2][blank].any()
    np.testing.assert_array_equal(got[0][dim], words[dim])
    # with a row map: the same lines through perm
    perm = np.random.default_rng(0).permutation(L)
    inv = np.argsort(perm)
    got_p = td._sweep_failed_lines(px[inv], coords, 0, 255, w0, c0, v0, f0,
                                   perm=perm)
    for a, b in zip(got_p, expect):
        np.testing.assert_array_equal(a, b)


def test_ref_sweep_merge_matches_jax():
    F, L = 2, 30
    px, cd, _ = noisy(F, L, seed=31, sigma=28.0)
    px[0, 3] = px[1, 8] = 16      # blank lines: no level reads them
    jd, td = drivers(ref_sweep=True, hyst_limit=4, shift_limit=2)
    bk = np.array([-3, 40])      # the merge clips to 0..254 / 1..255
    wt = np.array([260, 190])
    w0 = np.full((F, L, 8), 7, np.int16)
    c0 = np.full((F, L), 9, np.uint16)
    v0 = np.zeros((F, L), bool)
    expect = jd._ref_sweep_merge(px, cd, bk, wt, w0, c0, v0)
    got = td._ref_sweep_merge(px, cd, bk, wt, w0, c0, v0)
    for a, b in zip(got, expect):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert got[2].sum() == F * L - 2 and not got[2][0, 3]
    assert (got[0][0, 3] == 7).all() and got[1][0, 3] == 9


# -- mirrors of tests/test_ref_sweep.py ---------------------------------------

def _dim_lines(n_lines, black=5, white=60, seed=3):
    rng = np.random.default_rng(seed)
    left = rng.integers(1, 1 << 14, size=3 * n_lines)
    right = rng.integers(1, 1 << 14, size=3 * n_lines)
    px, coords, words, _ = jenc.encode_stream(
        left, right, width=W, ppb=8.0, n_lines=n_lines, black=black,
        white=white)
    return px, coords, words


def test_sweep_recovers_dim_signal():
    L = 16
    px, coords, words = _dim_lines(L)
    sw = torch_sweep(bz.stc007_ref_sweep_decode, px[None],
                     coords[:1].astype(np.int32), np.array([0], np.int32),
                     np.array([255], np.int32), (2, 1))
    R = len(LEVELS)
    sv = sw["valid"].reshape(R, L)
    pick, good, fbad = bz.pick_ref_sweep(
        sv, sw["crc"].reshape(R, L), sw["hyst"].reshape(R, L),
        sw["shift"].reshape(R, L))
    assert (pick >= 0).all() and good.all() and not fbad.any()
    assert ((LEVELS[pick] > 5) & (LEVELS[pick] < 60)).all()
    np.testing.assert_array_equal(
        sw["words"].reshape(R, L, 8)[pick, np.arange(L)], words)
    assert not sv[int(np.argmin(np.abs(LEVELS - 127)))].any()


def test_v2d_insane_frame():
    L = 32
    px, coords, words = _dim_lines(L, black=20, white=200, seed=7)
    jd, td = drivers(ref_sweep=True)
    res = td.decode_frame(px)
    assert res.valid.all() and not res.forced_bad.any()
    np.testing.assert_array_equal(res.words, words)
    assert_result_equal(res, jd.decode_frame(px))


def test_forced_coordinates():
    L = 16
    px, coords, words = _dim_lines(L, black=20, white=200, seed=12)
    px = px.copy()
    px[:, :60] = 20
    px[:, 1100:] = 20
    ds, de = int(coords[0, 0]), int(coords[0, 1])
    jd, td = drivers(forced_coords=(ds, de))
    res = td.decode_frame(px)
    assert res.valid.all()
    np.testing.assert_array_equal(res.words, words)
    assert_result_equal(res, jd.decode_frame(px))
    res2 = drivers()[1].decode_frame(px)
    assert res2 is None or not res2.valid.any()


def test_sweep_fallback_recovers_dim_lines():
    L = 24
    px, coords, words = _dim_lines(L, black=20, white=200, seed=23)
    dim = [5, 11, 17]
    pxd = dimmed(px, dim)
    preset = dict(min_white_lvl=40, max_black_lvl=30)
    jd, td = drivers(ref_sweep_fallback=True, preset=preset)
    res = td.decode_frame(pxd)
    assert res.valid.all(), np.nonzero(~res.valid)[0]
    np.testing.assert_array_equal(res.words, words)
    assert td.sweep_calls == 1
    assert_result_equal(res, jd.decode_frame(pxd))
    # the default preset gates the dim lines out of the sweep
    jd1, td1 = drivers(ref_sweep_fallback=True)
    res1 = td1.decode_frame(pxd)
    assert not res1.valid[dim].any() and td1.sweep_calls == 0
    assert_result_equal(res1, jd1.decode_frame(pxd))
    # without the fallback they stay invalid
    res2 = drivers(preset=preset)[1].decode_frame(pxd)
    assert not res2.valid[dim].any()


# -- mirrors of tests/test_normal_sweep.py ------------------------------------

def test_native_ref_sweep_lines_matches_the_torch_sweep():
    assert tsn.available()
    rng = np.random.default_rng(4)
    N, width = 16, 768
    n = 3 * N
    pixels, coords, *_ = jenc.encode_stream(
        rng.integers(0, 1 << 14, n), rng.integers(0, 1 << 14, n),
        width=width, ppb=5.0, n_lines=N, noise_sigma=18.0, rng=rng)
    cds = coords.astype(np.int32)
    bk = np.full(N, 20, np.int32)
    wt = np.full(N, 200, np.int32)
    nat = tsn.ref_sweep_lines(pixels, cds, bk, wt, LEVELS, 4, 2)
    sw = torch_sweep(bz.stc007_ref_sweep_decode, pixels[:, None, :], cds,
                     bk, wt, (4, 2))
    R = len(LEVELS)
    for k in ("valid", "crc", "hyst", "shift"):
        np.testing.assert_array_equal(sw[k].reshape(R, N),
                                      nat[k].astype(sw[k].dtype), err_msg=k)
    np.testing.assert_array_equal(sw["words"].reshape(R, N, 8),
                                  nat["words"].astype(np.int32))


@pytest.mark.parametrize("native", [True, False])
def test_center_ref_reads_collision_but_sweep_reads_truth(native,
                                                          monkeypatch):
    if not native:
        monkeypatch.setattr(jsn, "available", lambda: False)
        monkeypatch.setattr(tsn, "available", lambda: False)
    frame, true_words, S, bits = _render_collision_frame()
    F = frame[None]
    jb, tb = drivers(dup_detect=False)
    res_c = tb.decode_frames(F)[0]
    assert res_c is not None and res_c.valid.all()
    assert not np.array_equal(res_c.words[0], true_words)
    assert_result_equal(res_c, jb.decode_frames(F)[0])
    js, ts = drivers(dup_detect=False, normal_sweep_prescan=True)
    res_s = ts.decode_frames(F)[0]
    assert res_s is not None and res_s.valid.all()
    np.testing.assert_array_equal(
        np.broadcast_to(true_words, res_s.words.shape), res_s.words)
    assert_result_equal(res_s, js.decode_frames(F)[0])


def test_normal_sweep_noop_on_clean_capture():
    rng = np.random.default_rng(11)
    L, width = 48, 1024
    n = 3 * L
    pixels, coords, *_ = jenc.encode_stream(
        rng.integers(0, 1 << 14, n), rng.integers(0, 1 << 14, n),
        width=width, ppb=7.0, n_lines=L, noise_sigma=8.0, rng=rng)
    F = pixels.reshape(1, L, width)
    a = drivers()[1].decode_frames(F)[0]
    js, ts = drivers(normal_sweep_prescan=True)
    b = ts.decode_frames(F)[0]
    assert np.array_equal(a.words, b.words)
    assert np.array_equal(a.valid, b.valid)
    assert_result_equal(b, js.decode_frames(F)[0])
