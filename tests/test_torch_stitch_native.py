"""The port's JAX-free loader of the native core, against the JAX loader.

ops/stitch_native.py of the port compiles its own native/stitchcore.cpp
where it lies into build/native/, never into either package. Both
libraries, built from two source files, are loaded in this one process:
they are distinct files, so each holds its own GF(2) tables, and every
binding must return the JAX loader's arrays (values and dtypes). Also here: the port's
correct_blocks_cwd, control_block_fields and pick_ref_sweep against JAX's.
"""
import hashlib
import shutil
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdvpcmdecoder_tpu.formats import stc007 as jstc
from sdvpcmdecoder_tpu.ops import binarize as jbz
from sdvpcmdecoder_tpu.ops import deinterleave as jdi
from sdvpcmdecoder_tpu.ops import stitch_native as jsn
from sdvpcmdecoder_tpu.pipeline import ingest as jingest
from sdvpcmdecoder_tpu_torch.formats import stc007 as tstc
from sdvpcmdecoder_tpu_torch.ops import binarize as tbz
from sdvpcmdecoder_tpu_torch.ops import deinterleave as tdi
from sdvpcmdecoder_tpu_torch.ops import stitch_native as tsn
from sdvpcmdecoder_tpu_torch.pipeline import ingest as tingest
from sdvpcmdecoder_tpu_torch.synth import encoder as enc


def _tree_digest(path):
    h = hashlib.sha256()
    for p in sorted(path.iterdir()):
        h.update(p.name.encode() + p.read_bytes())
    return h.hexdigest()


def assert_same(a, b):
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_same(x, y)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            assert_same(a[k], b[k])
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, \
            (a.dtype, getattr(b, "dtype", None))
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


def test_build_goes_to_build_dir_and_leaves_the_jax_package(monkeypatch,
                                                            tmp_path):
    # The JAX loaders build next to their sources when their libraries
    # are missing or stale; let them settle first, then hash.
    assert jsn.available()
    jingest._native_lib()
    trees = (tsn.NATIVE_SRC, Path(jsn.__file__).resolve().parents[1]
             / "native")
    assert trees[0] != trees[1]
    before = [_tree_digest(t) for t in trees]
    # The shipped library of the JAX package is never what the port loads:
    # its core comes from the checkout's build/native/.
    assert tsn.available()
    assert Path(tsn._load()._name).parent \
        == Path(tsn.__file__).resolve().parents[2] / "build" / "native"
    monkeypatch.setattr(tsn, "BUILD_DIR", tmp_path / "native")
    core = tsn.build("stitchcore.cpp")
    loader = tingest.build_loader()
    assert [_tree_digest(t) for t in trees] == before
    for b in (core, loader):
        assert b.path.parent == tmp_path / "native" and b.seconds > 0
        assert b.flags and b.path.name.endswith(".so")
    assert core.path.name.startswith("libstitchcore-")
    # Once built, the same digest is reused without compiling.
    assert tsn.build("stitchcore.cpp") == (core.path, 0.0, ())


@pytest.mark.parametrize("cxx", ["/nonexistent/g++", "false"])
def test_failed_build_raises(monkeypatch, tmp_path, cxx):
    """No stale-library fallback: a library already in build/native/ from
    another source digest is not loaded when the compiler fails."""
    build = tmp_path / "native"
    build.mkdir()
    shutil.copy(tsn.build("stitchcore.cpp").path,
                build / "libstitchcore-0123456789abcdef.so")
    monkeypatch.setattr(tsn, "BUILD_DIR", build)
    monkeypatch.setattr(tsn, "CXX", cxx)
    monkeypatch.setattr(tsn, "_LIB", None)
    monkeypatch.delenv("SDV_NO_NATIVE", raising=False)
    with pytest.raises((RuntimeError, OSError)):
        tsn.build("stitchcore.cpp")
    with pytest.raises((RuntimeError, OSError)):
        tsn.available()
    assert tsn._LIB is None


def test_no_native_switch(monkeypatch):
    monkeypatch.setattr(tsn, "_LIB", None)
    monkeypatch.setenv("SDV_NO_NATIVE", "1")
    assert not tsn.available()


def _lines(rng, n, bad=0.2):
    left = rng.integers(0, 1 << 14, size=3 * n)
    right = rng.integers(0, 1 << 14, size=3 * n)
    left[:60] = 0
    right[:60] = 0
    words, crcs = enc.blocks_to_lines(enc.samples_to_blocks(left, right), n)
    words = np.asarray(words, np.int64)
    ok = rng.random(n) > bad
    words[~ok & (rng.random(n) < 0.7), rng.integers(0, 8)] ^= 0x1234
    crc8 = np.repeat(ok[:, None], 8, axis=1) ^ (rng.random((n, 8)) < 0.05)
    return words, np.asarray(crcs, np.int64), ok, crc8


@pytest.mark.parametrize("mode", [0, 1, 2, 3])
@pytest.mark.parametrize("m2,cwd", [(False, False), (True, True)])
def test_eval_rows_arrays_matches_jax(mode, m2, cwd):
    rng = np.random.default_rng(10 + mode)
    words, _, _, crc8 = _lines(rng, 400)
    cwd_line = rng.random(400) < 0.1 if cwd else None
    rows = np.sort(rng.integers(0, 400, (150, 8)), axis=1)
    for r, start, nb in ((None, 3, 200), (rows, 0, 150)):
        args = (words.astype(np.int32), crc8, cwd_line, r, start, nb, mode,
                True, True, True, cwd, m2)
        assert_same(jsn.eval_rows_arrays(*args), tsn.eval_rows_arrays(*args))


@pytest.mark.parametrize("resolution,en_q,force", [(0, True, True),
                                                   (1, True, False),
                                                   (0, False, True)])
def test_correct_blocks_arrays_matches_jax(resolution, en_q, force):
    rng = np.random.default_rng(resolution + 2 * en_q + 4 * force)
    words = rng.integers(0, 1 << 14, (300, 8)).astype(np.int32)
    crc_ok = rng.random((300, 8)) > 0.25
    args = (words, crc_ok, resolution, True, en_q, force)
    assert_same(jsn.correct_blocks_arrays(*args),
                tsn.correct_blocks_arrays(*args))


def test_burst_stats_and_dup_lines_match_jax():
    rng = np.random.default_rng(5)
    for _ in range(20):
        flags = rng.integers(0, 64, rng.integers(1, 300)).astype(np.uint8)
        args = (flags, int(rng.integers(1, 64)), bool(rng.integers(2)), 8, 1)
        assert jsn.burst_stats(*args) == tsn.burst_stats(*args)
    words, crcs, ok, _ = _lines(rng, 300, bad=0.1)
    words[101] = words[100]
    crcs[101] = crcs[100]
    words[201] = words[200] ^ 1
    crcs[201] = crcs[200]
    ok[[100, 101, 200, 201]] = True
    for m2 in (False, True):
        args = (words, crcs, ok, [(0, 150), (150, 300)], 32, m2)
        got = tsn.find_dup_lines(*args)
        assert_same(jsn.find_dup_lines(*args), got)
        assert got[101] and got[201]


@pytest.mark.parametrize("hl,sl,per_line", [(0, 0, False), (4, 2, False),
                                            (2, 1, True)])
def test_binarize_frames_matches_jax(hl, sl, per_line):
    rng = np.random.default_rng(7)
    F, Lf, W = 3, 24, 512
    pixels, coords, *_ = enc.encode_stream(
        rng.integers(0, 1 << 14, 3 * F * Lf),
        rng.integers(0, 1 << 14, 3 * F * Lf), width=W, ppb=3.5,
        n_lines=F * Lf, noise_sigma=25.0, rng=rng)
    px = pixels.reshape(F, Lf, W)
    cd = coords[::Lf].astype(np.int32)
    shape = (F, Lf) if per_line else (F,)
    ref = rng.integers(80, 140, shape).astype(np.int32)
    row_map = rng.permutation(Lf)
    args = (px, cd, ref, np.full(shape, 20, np.int32),
            np.full(shape, 200, np.int32), hl, sl)
    got = tsn.binarize_frames(*args, row_map=row_map)
    assert_same(jsn.binarize_frames(*args, row_map=row_map), got)
    assert got[2].any()


def test_crc_field_res_and_ref_sweep_match_jax():
    rng = np.random.default_rng(9)
    words, _, _, crc8 = _lines(rng, 300)
    assert_same(jsn.crc_rows(words), tsn.crc_rows(words))
    assert jsn.crc_row(words[5]) == tsn.crc_row(words[5])
    for m2 in (False, True):
        assert jsn.field_res_counts(words, crc8, 150, m2) == \
            tsn.field_res_counts(words, crc8, 150, m2)
    pixels, coords, *_ = enc.encode_stream(
        rng.integers(0, 1 << 14, 3 * 40), rng.integers(0, 1 << 14, 3 * 40),
        width=512, ppb=3.5, n_lines=40, noise_sigma=20.0, rng=rng)
    levels = np.arange(254, 1, -8, dtype=np.int32)
    args = (pixels, coords, np.full(40, 20), np.full(40, 200), levels, 2, 1)
    assert_same(jsn.ref_sweep_lines(*args), tsn.ref_sweep_lines(*args))


@pytest.mark.parametrize("resolution", [0, 1])
def test_correct_blocks_cwd_matches_jax(resolution):
    rng = np.random.default_rng(20 + resolution)
    words = rng.integers(0, 1 << 14, (400, 8)).astype(np.int32)
    crc_ok = rng.random((400, 8)) > 0.35
    cwd = rng.random((400, 8)) < 0.3
    ref, ref_app = jdi.correct_blocks_cwd(
        jnp.asarray(words), jnp.asarray(crc_ok), jnp.asarray(cwd),
        resolution)
    got, got_app = tdi.correct_blocks_cwd(
        torch.from_numpy(words), torch.from_numpy(crc_ok),
        torch.from_numpy(cwd), resolution)
    assert bool(np.asarray(ref_app).any())
    np.testing.assert_array_equal(np.asarray(ref_app), got_app.numpy())
    for name in ref._fields:
        r, g = np.asarray(getattr(ref, name)), getattr(got, name).numpy()
        assert r.dtype == g.dtype, name
        np.testing.assert_array_equal(r, g, err_msg=name)


def test_control_block_fields_and_ref_picks_match_jax():
    cbw, _ = enc.control_block_line(index=5, hour=3, minute=41, second=17,
                                    field=9, emphasis=True, m2=True)
    assert jstc.control_block_fields(cbw) == tstc.control_block_fields(cbw)
    rng = np.random.default_rng(3)
    R, N = 40, 64
    valid = rng.random((R, N)) < 0.4
    crc = rng.integers(0, 4, (R, N)) * 0x1111
    hyst = rng.integers(0, 3, (R, N))
    shift = rng.integers(0, 2, (R, N))
    for mv in (1, 5):
        assert_same(jbz.pick_ref_sweep(valid, crc, hyst, shift, mv),
                    tbz.pick_ref_sweep(valid, crc, hyst, shift, mv))
    black = rng.integers(0, 120, 50)
    white = rng.integers(100, 256, 50)
    assert_same(jbz.pick_center_ref_level(black, white, 8, xp=np),
                tbz.pick_center_ref_level(black, white, 8))


def test_ingest_loader_reads_like_jax(tmp_path):
    frames = np.random.default_rng(1).integers(0, 256, (3, 10, 16),
                                               dtype=np.uint8)
    path = str(tmp_path / "c.y4m")
    tingest.write_y4m(path, frames)
    with tingest.VideoReader(path) as r, jingest.VideoReader(path) as j:
        assert r._h and (r.width, r.height, r.n_frames) == (16, 10, 3)
        np.testing.assert_array_equal(r.read_frames(1, 5), j.read_frames(1, 5))
    path = str(tmp_path / "c.avi")   # containers open in-process now
    from sdvpcmdecoder_tpu_torch.pipeline import avi as tavi
    tavi.write_avi(path, frames, codec="Y800")
    with tingest.open_capture(path) as r, jingest.open_capture(path) as j:
        assert type(r) is tavi.AVIReader
        np.testing.assert_array_equal(r.read_frames(0, 3), j.read_frames(0, 3))
