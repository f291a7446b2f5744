"""Port checks for the PCM-1 / PCM-16x0 host side against the JAX package,
exactly (values and dtypes): formats/pcm1 and formats/pcm16x0 (torch and
numpy entries), both deinterleavers and their encoders, ops/line_decode_np
(trial decodes, coordinate search, Bit Picker, refine_failed_lines) with
and without the native core, and every PCM binding of the port's native
loader against the JAX loader's.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdvpcmdecoder_tpu.formats import pcm1 as jp1
from sdvpcmdecoder_tpu.formats import pcm16x0 as jp16
from sdvpcmdecoder_tpu.ops import line_decode_np as jld
from sdvpcmdecoder_tpu.ops import pcm1_deint as jdi1
from sdvpcmdecoder_tpu.ops import pcm16x0_deint as jdi16
from sdvpcmdecoder_tpu.ops import stitch_native as jsn
from sdvpcmdecoder_tpu.pipeline import stitcher_pcm1 as jsp1
from sdvpcmdecoder_tpu.pipeline import stitcher_pcm16x0 as jsp16
from sdvpcmdecoder_tpu_torch.formats import pcm1 as tp1
from sdvpcmdecoder_tpu_torch.formats import pcm16x0 as tp16
from sdvpcmdecoder_tpu_torch.ops import line_decode_np as tld
from sdvpcmdecoder_tpu_torch.ops import pcm1_deint as tdi1
from sdvpcmdecoder_tpu_torch.ops import pcm16x0_deint as tdi16
from sdvpcmdecoder_tpu_torch.ops import stitch_native as tsn
from sdvpcmdecoder_tpu_torch.pipeline import stitcher_pcm1 as tsp1
from sdvpcmdecoder_tpu_torch.pipeline import stitcher_pcm16x0 as tsp16
from sdvpcmdecoder_tpu_torch.synth import encoder as enc

torch.set_num_threads(1)

FORMATS = [(jp1, tp1, 13), (jp16, tp16, 16)]
FMT_IDS = ["pcm1", "pcm16x0"]


def assert_same(a, b, what=""):
    """b (the port's) equals a (JAX's): values and dtypes, through tuples,
    lists and dicts; tensors compare as numpy."""
    if isinstance(b, torch.Tensor):
        b = b.numpy()
    if isinstance(a, jnp.ndarray) and not isinstance(a, np.ndarray):
        a = np.asarray(a)
    if isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b), what
        for k, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{what}[{k}]")
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for k in a:
            assert_same(a[k], b[k], f"{what}.{k}")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), (what, type(b))
        assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=what)
    else:
        assert type(a) is type(b) and a == b, (what, a, b)


def words(seed, shape, bits):
    return np.random.default_rng(seed).integers(0, 1 << bits, shape) \
        .astype(np.int32)


# ---- formats ---------------------------------------------------------------

@pytest.mark.parametrize("j,t,_bits", FORMATS, ids=FMT_IDS)
def test_constants_match(j, t, _bits):
    names = [n for n in dir(j) if n.isupper() and not n.startswith("_")]
    assert len(names) > 15
    for n in names:
        assert getattr(t, n) == getattr(j, n), n


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("j,t,bits", FORMATS, ids=FMT_IDS)
def test_calc_crc_torch_and_numpy_match_jax(j, t, bits, seed):
    w = words(seed, (40, j.N_WORDS), bits)
    assert_same(np.asarray(j.calc_crc(jnp.asarray(w))),
                t.calc_crc(torch.from_numpy(w)), "torch")
    assert_same(j.calc_crc(w, xp=np), t.calc_crc(w, xp=np), "numpy")
    w64 = w.astype(np.int64)
    assert_same(j.calc_crc(w64, xp=np), t.calc_crc(w64, xp=np), "int64")


def test_crc_golden_values():
    """tests/test_crc.py's vectors through the port."""
    assert int(tp1.calc_crc(tp1.silent_words(xp=torch)[None])[0]) \
        == tp1.CRC_SILENT
    assert int(tp16.calc_crc(torch.tensor(
        [[0xD527, 0x9C36, 0x02A5]], dtype=torch.int32))[0]) == 0xFB40
    assert int(tp16.calc_crc(tp16.silent_words(xp=torch)[None])[0]) \
        == tp16.CRC_SILENT
    for t in (tp1, tp16):
        dev = t.silent_words(xp=torch)
        assert dev.dtype == torch.int32
        np.testing.assert_array_equal(dev.numpy(), t.silent_words())


@pytest.mark.parametrize("j,t,bits", FORMATS, ids=FMT_IDS)
def test_bits_roundtrip_match_jax(j, t, bits):
    w = words(2, (3, 5, j.N_WORDS), bits)
    c = np.asarray(j.calc_crc(w, xp=np))
    jb = j.words_to_data_bits(w, c, xp=np)
    assert_same(jb, t.words_to_data_bits(w, c, xp=np), "np bits")
    assert_same(np.asarray(j.words_to_data_bits(jnp.asarray(w),
                                                jnp.asarray(c.astype(
                                                    np.int32)))),
                t.words_to_data_bits(torch.from_numpy(w),
                                     torch.from_numpy(c.astype(np.int32))),
                "torch bits")
    assert_same(j.data_bits_to_words(jb, xp=np),
                t.data_bits_to_words(jb, xp=np), "np words")
    jb32 = jb.astype(np.int32)
    assert_same(tuple(np.asarray(a) for a in
                      j.data_bits_to_words(jnp.asarray(jb32))),
                t.data_bits_to_words(torch.from_numpy(jb32)), "torch words")


@pytest.mark.parametrize("j,t,bits", FORMATS, ids=FMT_IDS)
def test_expand_sample_match_jax(j, t, bits):
    w = np.arange(1 << bits, dtype=np.int32)
    assert_same(j.expand_sample(w, xp=np), t.expand_sample(w, xp=np))
    assert_same(np.asarray(j.expand_sample(jnp.asarray(w))),
                t.expand_sample(torch.from_numpy(w)))


@pytest.mark.parametrize("ctrl", [0, 1, "array"])
def test_pcm16x0_line_bits_match_jax(ctrl):
    sub = words(3, (4, 3, 3), 16)
    crcs = np.asarray(jp16.calc_crc(sub, xp=np))
    cb = np.array([0, 1, 1, 0]) if ctrl == "array" else ctrl
    a = jp16.line_bits(sub, crcs, cb, xp=np)
    assert a.shape == (4, 193)
    assert_same(a, tp16.line_bits(sub, crcs, cb, xp=np))
    sub32, c32 = torch.from_numpy(sub), torch.from_numpy(
        crcs.astype(np.int32))
    tb = torch.as_tensor(cb) if ctrl == "array" else cb
    assert_same(np.asarray(jp16.line_bits(jnp.asarray(sub),
                                          jnp.asarray(c32.numpy()),
                                          jnp.asarray(cb))),
                tp16.line_bits(sub32, c32, tb))


def test_pcm1_is_header_matches_jax():
    w = words(4, (6, 6), 13).astype(np.int64)
    crc = np.full(6, tp1.HEADER_CRC, np.int64)
    w[1::2] = tp1.HEADER_WORDS
    crc[3] = 0
    assert_same(jp1.is_header(w, crc), tp1.is_header(w, crc))
    assert tp1.is_header(w, crc).tolist() == [False, True, False, False,
                                              False, True]
    assert_same(tp1.is_header(torch.from_numpy(w), torch.from_numpy(crc),
                              xp=torch).numpy(), tp1.is_header(w, crc))


# ---- deinterleavers --------------------------------------------------------

def test_pcm1_deint_matches_jax():
    assert_same(jdi1.pair_to_subline_map(), tdi1.pair_to_subline_map())
    rng = np.random.default_rng(5)
    left = rng.integers(0, 1 << 13, tdi1.FIELD_SUBLINES)
    right = rng.integers(0, 1 << 13, tdi1.FIELD_SUBLINES)
    assert_same(jdi1.interleave_field(left, right),
                tdi1.interleave_field(left, right))
    sl, sr = tdi1.interleave_field(left, right)
    ok = rng.random(tdi1.FIELD_SUBLINES) > 0.05
    pl = rng.random(tdi1.FIELD_SUBLINES) > 0.9
    pc = rng.random(tdi1.FIELD_SUBLINES) > 0.9
    assert_same(jdi1.deinterleave_field(sl, sr, ok),
                tdi1.deinterleave_field(sl, sr, ok))
    assert_same(jdi1.deinterleave_field(sl, sr, ok, pl, pc),
                tdi1.deinterleave_field(sl, sr, ok, pl, pc))


@pytest.mark.parametrize("ei,even_first", [(False, False), (False, True),
                                           (True, False)])
def test_pcm16x0_interleave_matches_jax(ei, even_first):
    rng = np.random.default_rng(6)
    n = 3 * tdi16.EI_OFS if ei else 7 * 3 * tdi16.SI_OFS
    left = rng.integers(1, 1 << 16, n)
    right = rng.integers(1, 1 << 16, n)
    assert_same(jdi16.interleave_field(left, right, 490 if ei else 245, ei,
                                       even_first),
                tdi16.interleave_field(left, right, 490 if ei else 245, ei,
                                       even_first))


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("ei", [False, True])
def test_pcm16x0_decode_blocks_match_jax(monkeypatch, native, ei):
    """Both routes of decode_blocks (the native core and the numpy
    reference), on sublines with knocked-out CRCs, and the row-mapped
    form."""
    rng = np.random.default_rng(7 + ei)
    S = 1470 if ei else 735
    left = rng.integers(1, 1 << 16, 3 * tdi16.EI_OFS if ei else 735)
    right = rng.integers(1, 1 << 16, left.size)
    sub, _ = tdi16.interleave_field(left, right, S // 3, ei)
    crc_ok = rng.random(S) > 0.1
    ofs = tdi16.EI_OFS if ei else tdi16.SI_OFS
    shifts = np.arange(0, S - 2 * ofs, 3 if ei else 1)[:120]
    even = (np.arange(len(shifts)) % 2).astype(bool)
    rows = shifts[:, None] + ofs * np.arange(3)[None, :]
    if not native:
        monkeypatch.setattr(jsn, "available", lambda: False)
        monkeypatch.setattr(tsn, "available", lambda: False)
    for kw in (dict(), dict(en_p=False), dict(force_ecc=False),
               dict(rows=rows)):
        assert_same(jdi16.decode_blocks(sub, crc_ok, shifts, even, ei=ei,
                                        **kw),
                    tdi16.decode_blocks(sub, crc_ok, shifts, even, ei=ei,
                                        **kw), str(kw))


# ---- line_decode_np --------------------------------------------------------

def pcm1_line(rng, W=900, margin=40, noise=20.0, ppb=8.0):
    """tests/test_search_native.py's PCM-1 line: (pixels [W], coords)."""
    w = rng.integers(0, 1 << 13, (1, 6)).astype(np.int64)
    bits = tp1.words_to_data_bits(w, tp1.calc_crc(w, xp=np), xp=np)
    px, (ds, de) = enc.render_bits(bits, width=W - 2 * margin, ppb=ppb)
    line = np.zeros(W, np.uint8)
    line[margin:W - margin] = px[0]
    line = np.clip(line.astype(np.float64) + rng.normal(0, noise, W), 0,
                   255).astype(np.uint8)
    return line, (margin + ds, margin + de)


def pcm16x0_line(rng, W=1500, margin=30, noise=15.0):
    sub = rng.integers(0, 1 << 16, (3, 3)).astype(np.int64)
    crcs = np.asarray(tp16.calc_crc(sub, xp=np))
    bits = np.asarray(tp16.line_bits(sub, crcs, xp=np))[None]
    px, (ds, de) = enc.render_bits(bits, width=W - 2 * margin, ppb=7.0)
    line = np.zeros(W, np.uint8)
    line[margin:W - margin] = px[0]
    line = np.clip(line.astype(np.float64) + rng.normal(0, noise, W), 0,
                   255).astype(np.uint8)
    return line, (margin + ds, margin + de)


def test_format_specs_match():
    for name in ("SPEC_STC007", "SPEC_PCM1", "SPEC_PCM16X0_FULL",
                 "SPEC_ARVID"):
        assert vars(getattr(jld, name)) == vars(getattr(tld, name))
    for name in ("PCM16X0_PART_START", "SHIFT_STAGES_SAFE", "HYST_DEPTH_MAX",
                 "PCM1_SEARCH_STEP_DIV", "PCM1_SEARCH_MAX_OFS",
                 "PCM16X0_SEARCH_STEP_DIV", "PCM16X0_SEARCH_MAX_OFS"):
        assert getattr(jld, name) == getattr(tld, name), name


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_trial_decodes_and_grid_match_jax(seed):
    rng = np.random.default_rng(seed)
    line, (ds, de) = pcm1_line(rng, noise=25.0)
    for d in (0, 3):
        for s in (0, 1, 2):
            assert_same(jld.decode_trial_pcm1(line, ds, de, 110, d, s, 900),
                        tld.decode_trial_pcm1(line, ds, de, 110, d, s, 900))
    assert_same(jld.read_pcm_grid(jld.decode_trial_pcm1, line, ds, de, 110,
                                  20, 200, 900, 4, 2),
                tld.read_pcm_grid(tld.decode_trial_pcm1, line, ds, de, 110,
                                  20, 200, 900, 4, 2))
    line, (ds, de) = pcm16x0_line(rng, noise=25.0)
    for part in range(3):
        assert_same(jld.decode_trial_pcm16x0(line, ds, de, 110, 2, 1, 1500,
                                             part),
                    tld.decode_trial_pcm16x0(line, ds, de, 110, 2, 1, 1500,
                                             part))
        assert_same(jld.read_pcm_grid(jld.decode_trial_pcm16x0, line, ds,
                                      de, 110, 20, 200, 1500, 4, 2,
                                      part=part),
                    tld.read_pcm_grid(tld.decode_trial_pcm16x0, line, ds,
                                      de, 110, 20, 200, 1500, 4, 2,
                                      part=part))
    px = rng.integers(0, 256, 1152).astype(np.uint8)
    assert_same(jld.decode_trial_stc007(px, 40, 1100, 110, 1, 1, 1152),
                tld.decode_trial_stc007(px, 40, 1100, 110, 1, 1, 1152))


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("seed", [0, 3])
def test_search_coordinates_match_jax(monkeypatch, native, seed):
    if not native:
        monkeypatch.setattr(jsn, "available", lambda: False)
        monkeypatch.setattr(tsn, "available", lambda: False)
    rng = np.random.default_rng(seed)
    line, (ds, de) = pcm1_line(rng)
    for kw in (dict(), dict(history=(ds + 3, de - 2)), dict(max_ofs=4)):
        assert_same(jld.search_coordinates(line, 110, 20, 200, 900,
                                           fmt="pcm1", **kw),
                    tld.search_coordinates(line, 110, 20, 200, 900,
                                           fmt="pcm1", **kw), str(kw))
    line, _ = pcm16x0_line(rng)
    assert_same(jld.search_coordinates(line, 110, 20, 200, 1500,
                                       fmt="pcm16x0"),
                tld.search_coordinates(line, 110, 20, 200, 1500,
                                       fmt="pcm16x0"))


def test_bit_picker_and_cut_bits_match_jax():
    """Edge-cut lines: count_cut_bits and the Bit Picker of both formats
    (tests/test_line_decode_np.py's cases)."""
    rng = np.random.default_rng(9)
    w = rng.integers(0, 1 << 13, (1, 6)).astype(np.int64)
    crc = tp1.calc_crc(w, xp=np)
    W = 600
    px, (ds, de) = enc.render_bits(
        tp1.words_to_data_bits(w, crc, xp=np), width=W + 40, ppb=6.0,
        start_px=-12)
    px = np.ascontiguousarray(px[:, :W])
    for spec, fmt in ((jld.SPEC_PCM1, "pcm1"),
                      (jld.SPEC_PCM16X0_FULL, "pcm16x0")):
        tspec = getattr(tld, "SPEC_PCM1" if fmt == "pcm1"
                        else "SPEC_PCM16X0_FULL")
        for a, b in ((-12, 552), (5, 600), (-30, 700)):
            assert jld.count_cut_bits(spec, a, b, W, 3, 3) == \
                tld.count_cut_bits(tspec, a, b, W, 3, 3)
    dec = tld.decode_trial_pcm1(px[0], ds, de, 110, 0, 0, W)
    assert_same(jld.pick_cut_bits_pcm1(list(dec[0]), dec[1], ds, de, W),
                tld.pick_cut_bits_pcm1(list(dec[0]), dec[1], ds, de, W))
    sub = rng.integers(0, 1 << 16, (1, 3, 3)).astype(np.int64)
    crcs = np.asarray(tp16.calc_crc(sub, xp=np))
    bits = tp16.line_bits(sub, crcs, 0, xp=np)
    px, (ds, de) = enc.render_bits(bits, width=1400, ppb=7.0, start_px=-10)
    for part in (0, 2):
        d = tld.decode_trial_pcm16x0(px[0], ds, de, 110, 0, 0, 1400, part)
        assert_same(jld.pick_cut_bits_pcm16x0(list(d[0]), d[1], ds, de,
                                              1400, part),
                    tld.pick_cut_bits_pcm16x0(list(d[0]), d[1], ds, de,
                                              1400, part))


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("fmt", ["pcm1", "pcm16x0"])
def test_refine_failed_lines_match_jax(monkeypatch, native, fmt):
    """tests/test_linegrid_native.py's jittered lines through both
    packages' refine_failed_lines, native and Python routes."""
    rng = np.random.default_rng(11)
    make = pcm1_line if fmt == "pcm1" else pcm16x0_line
    lines, cds = [], None
    for i in range(4):
        px, c = make(rng, noise=6.0)
        cds = cds or c
        if i % 2 == 0:
            px = np.roll(px, int(rng.integers(-4, 5)))
        lines.append(px)
    lines = np.stack(lines)
    valid = np.zeros(4, bool) if fmt == "pcm1" else np.zeros((4, 3), bool)
    if not native:
        monkeypatch.setattr(jsn, "available", lambda: False)
        monkeypatch.setattr(tsn, "available", lambda: False)
    for hl, sl in ((0, 2), (2, 1)):
        got = tld.refine_failed_lines(lines, valid, cds, 110, 20, 200, fmt,
                                      shift_limit=sl, hyst_limit=hl)
        assert got == jld.refine_failed_lines(lines, valid, cds, 110, 20,
                                              200, fmt, shift_limit=sl,
                                              hyst_limit=hl)
        assert got


# ---- native bindings -------------------------------------------------------

def test_pcm_bindings_are_declared():
    lib = tsn._load()
    for name in ("pcm16x0_decode_blocks", "pcm16x0_decode_blocks_rows",
                 "pcm_crc_rows", "linegrid_coord_sweep",
                 "pcm1_binarize_frames", "pcm16x0_binarize_frames",
                 "pcm_pick_cut_line", "pcm_search_coordinates",
                 "pcm1_field_deint", "pcm1_steady_frame",
                 "pcm16x0_steady_frame", "pcm16x0_block_flags",
                 "pcm16x0_burst_stats"):
        assert getattr(lib, name).argtypes, name
    assert (tsn.P16_REC_N, tsn.P1_REC_N) == (jsn.P16_REC_N, jsn.P1_REC_N)
    assert (tsn.P16_STATUS, tsn.P16_TRIM, tsn.P16_SPLIT, tsn.P16_CTRL,
            tsn.P16_QLEN, tsn.P16_BTOTAL, tsn.P16_CNT, tsn.P16_OUT,
            tsn.P16_PAD) == (jsn.P16_STATUS, jsn.P16_TRIM, jsn.P16_SPLIT,
                             jsn.P16_CTRL, jsn.P16_QLEN, jsn.P16_BTOTAL,
                             jsn.P16_CNT, jsn.P16_OUT, jsn.P16_PAD)
    assert (tsn.P1_TRIM, tsn.P1_DATA, tsn.P1_REFS, tsn.P1_CNT) == \
        (jsn.P1_TRIM, jsn.P1_DATA, jsn.P1_REFS, jsn.P1_CNT)


def test_crc_rows_field_deint_flags_burst_match_jax():
    rng = np.random.default_rng(12)
    for fmt, n, b in (("pcm1", 6, 13), ("pcm16x0", 3, 16)):
        w = rng.integers(0, 1 << b, (50, n))
        assert_same(jsn.pcm_crc_rows(w, fmt), tsn.pcm_crc_rows(w, fmt))
    sl = rng.integers(0, 1 << 13, 735)
    sr = rng.integers(0, 1 << 13, 735)
    sv = rng.random(735) > 0.05
    assert_same(jsn.pcm1_field_deint(sl, sr, sv),
                tsn.pcm1_field_deint(sl, sr, sv))
    sub = rng.integers(0, 1 << 16, (735, 3))
    ok = rng.random(735) > 0.1
    shifts = np.arange(600)
    even = (shifts % 2).astype(bool)
    dec = jsn.pcm16x0_decode_blocks(sub, ok, shifts, even, 35, True, True)
    assert_same(dec, tsn.pcm16x0_decode_blocks(sub, ok, shifts, even, 35,
                                               True, True))
    rows = shifts[:, None] + 35 * np.arange(3)
    assert_same(jsn.pcm16x0_decode_blocks_rows(sub, ok, rows, even, True,
                                               False),
                tsn.pcm16x0_decode_blocks_rows(sub, ok, rows, even, True,
                                               False))
    _w, v, _wc, state, stage, samples, bval = dec
    flags = jsn.pcm16x0_block_flags(v, state, stage, samples, bval)
    assert_same(flags, tsn.pcm16x0_block_flags(v, state, stage, samples,
                                               bval))
    for args in ((8, 3, True), (2, 1, False)):
        assert jsn.pcm16x0_burst(flags[0], *args) == \
            tsn.pcm16x0_burst(flags[0], *args)
    with pytest.raises(IndexError):
        tsn.pcm16x0_decode_blocks(sub, ok, np.array([700]), even[:1], 35,
                                  True, True)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_line_search_bindings_match_jax(seed):
    rng = np.random.default_rng(seed)
    deltas = sorted(range(-8, 9, 2), key=abs)
    line, (ds, de) = pcm1_line(rng, noise=8.0)
    for ref, bk, wt in ((110, 20, 200), (10, 20, 200)):
        assert jsn.linegrid_coord_sweep(line, ds + 3, de, ref, bk, wt,
                                        "pcm1", 0, deltas, deltas, 0, 2) == \
            tsn.linegrid_coord_sweep(line, ds + 3, de, ref, bk, wt, "pcm1",
                                     0, deltas, deltas, 0, 2)
    assert jsn.pcm_search_coordinates(line, ds, de, 110, 20, 200, "pcm1", 0,
                                      2, 12, 2, 3, 3) == \
        tsn.pcm_search_coordinates(line, ds, de, 110, 20, 200, "pcm1", 0, 2,
                                   12, 2, 3, 3)
    line16, (ds, de) = pcm16x0_line(rng, noise=8.0)
    for part in range(3):
        assert jsn.linegrid_coord_sweep(line16, ds, de - 2, 110, 20, 200,
                                        "pcm16x0", part, deltas, deltas, 2,
                                        1) == \
            tsn.linegrid_coord_sweep(line16, ds, de - 2, 110, 20, 200,
                                     "pcm16x0", part, deltas, deltas, 2, 1)
        assert jsn.pcm_search_coordinates(line16, ds, de, 110, 20, 200,
                                          "pcm16x0", part, 3, 10, 2, 3,
                                          3) == \
            tsn.pcm_search_coordinates(line16, ds, de, 110, 20, 200,
                                       "pcm16x0", part, 3, 10, 2, 3, 3)
    w = rng.integers(0, 1 << 13, 6)
    crc = int(tp1.calc_crc(w[None], xp=np)[0]) ^ 0x5
    for a, b in ((-12, 552), (2, 700)):
        assert jsn.pcm_pick_cut_line(w, crc, a, b, 600, "pcm1", 0, 3, 3) == \
            tsn.pcm_pick_cut_line(w, crc, a, b, 600, "pcm1", 0, 3, 3)


@pytest.mark.parametrize("hl,sl", [(0, 2), (2, 1), (4, 2)])
def test_binarize_frame_bindings_match_jax(hl, sl):
    rng = np.random.default_rng(hl)
    for fmt, W, ppb in (("pcm1", 1024, 10.0), ("pcm16x0", 1600, 7.0)):
        if fmt == "pcm1":
            w = rng.integers(0, 1 << 13, (2 * 20, 6))
            bits = tp1.words_to_data_bits(w, tp1.calc_crc(w, xp=np), xp=np)
        else:
            w = rng.integers(0, 1 << 16, (2 * 20, 3, 3))
            bits = tp16.line_bits(w, tp16.calc_crc(w, xp=np), 1, xp=np)
        px, (ds, de) = enc.render_bits(bits, width=W, ppb=ppb,
                                       noise_sigma=30.0, rng=rng)
        px = px.reshape(2, 20, W)
        coords = np.array([[ds, de], [ds + 2, de - 1]])
        args = (px, coords, np.array([110, 100]), np.array([20, 25]),
                np.array([200, 190]), sl)
        fn = f"{fmt}_binarize_frames"
        assert_same(getattr(jsn, fn)(*args, hyst_limit=hl),
                    getattr(tsn, fn)(*args, hyst_limit=hl), fn)
        # Strided rows (a field view of the frame) go through as they are.
        assert_same(getattr(jsn, fn)(px[:, ::2], *args[1:], hyst_limit=hl),
                    getattr(tsn, fn)(px[:, ::2], *args[1:], hyst_limit=hl))


def _pcm1_store(mod, rng, frame_no, bad=0.05):
    """A PCM-1 frame store (245 x 2 lines) of mod's stitcher, from words
    interleaved as the JAX package's tests interleave them."""
    di1 = tdi1
    L = mod.LINES_PF
    ws = []
    for _half in range(2):
        sl, sr = di1.interleave_field(rng.integers(0, 1 << 13, 735),
                                      rng.integers(0, 1 << 13, 735))
        w = np.zeros((L, 6), np.int64)
        w[:, 0::2] = np.stack([sl[0::3], sl[1::3], sl[2::3]], 1)
        w[:, 1::2] = np.stack([sr[0::3], sr[1::3], sr[2::3]], 1)
        ws.append(w)
    w = np.empty((2 * L, 6), np.int64)
    w[0::2], w[1::2] = ws
    crc = tp1.calc_crc(w, xp=np)
    crc[rng.random(2 * L) < bad] ^= 0x11
    nums = np.concatenate([np.arange(1, 2 * L, 2), np.arange(2, 2 * L + 1,
                                                             2)])
    order = np.argsort(np.r_[np.arange(0, 2 * L, 2), np.arange(1, 2 * L, 2)])
    return w, crc, nums, order


def test_pcm1_steady_frame_binding_matches_jax():
    rng = np.random.default_rng(13)
    w, crc, nums, _ = _pcm1_store(tsp1, rng, 1)
    L = len(w)
    outs = []
    for mod in (jsp1, tsp1):
        s = mod.PCM1LineStore.from_decoded(
            w, crc, np.full(L, 3), nums, ref_level=np.full(L, 110))
        sn = jsn if mod is jsp1 else tsn
        outs.append(sn.pcm1_steady_frame(s, 3, True, True, 0, 0))
    assert outs[0][0] == 0
    assert_same(*outs)


def test_pcm16x0_steady_frame_binding_matches_jax():
    rng = np.random.default_rng(14)
    L = 245
    sub = []
    for _half in range(2):
        s, _ = tdi16.interleave_field(rng.integers(1, 1 << 16, 735),
                                      rng.integers(1, 1 << 16, 735), L)
        sub.append(s.reshape(L, 3, 3))
    w = np.empty((2 * L, 3, 3), np.int64)
    w[0::2], w[1::2] = sub
    w = w.reshape(-1, 3)
    crc = tp16.calc_crc(w, xp=np)
    crc[rng.random(len(crc)) < 0.03] ^= 0x40
    nums = np.arange(1, 2 * L + 1)
    outs = []
    for mod, sn in ((jsp16, jsn), (tsp16, tsn)):
        st = mod.PCM16X0LineStore.from_decoded(
            w, crc, np.full(6 * L, 2), np.repeat(nums, 3),
            np.tile(np.arange(3), 2 * L),
            control_bit=np.ones(6 * L, bool))
        outs.append(sn.pcm16x0_steady_frame(st, 2, True, True))
    (rc, rec, *arrays), (trc, trec, *tarrays) = outs
    assert rc == trc == 0
    assert_same(rec, trec)
    # Only the rows the record says were written hold data.
    n = int(rec[tsn.P16_OUT]) + int(rec[tsn.P16_OUT + 1])
    assert n > 0
    assert_same([a[:n] for a in arrays], [a[:n] for a in tarrays])
