"""The port's capture codecs (pipeline/ffv1.py, lagarith.py, utvideo.py,
huffyuv.py) against the JAX package's, on the CPU.

Mirrors tests/test_ffv1.py, test_lagarith.py and test_utvideo.py (their
cases that need no FFmpeg/libav): each encoder writes the JAX encoder's
bytes, each decoder returns the source pixels and the JAX decoder's
output, the native core and the Python spec agree, and malformed streams
raise the same error with the same message.
"""
import struct

import numpy as np
import pytest
import torch

from sdvpcmdecoder_tpu.pipeline import ffv1 as jfv
from sdvpcmdecoder_tpu.pipeline import huffyuv as jhf
from sdvpcmdecoder_tpu.pipeline import lagarith as jlg
from sdvpcmdecoder_tpu.pipeline import utvideo as jutv
from sdvpcmdecoder_tpu_torch.ops import stitch_native as tsn
from sdvpcmdecoder_tpu_torch.pipeline import ffv1 as fv
from sdvpcmdecoder_tpu_torch.pipeline import huffyuv as hf
from sdvpcmdecoder_tpu_torch.pipeline import lagarith as lg
from sdvpcmdecoder_tpu_torch.pipeline import utvideo as utv

torch.set_num_threads(1)

PREDS = ["none", "left", "gradient", "median"]


def _mixed_frames(rng, F=3, H=64, W=96):
    """Raster + gradient + flat band (tests/test_ffv1.py's frames)."""
    out = []
    yy, xx = np.mgrid[0:H, 0:W]
    for i in range(F):
        f = (rng.random((H, W)) > 0.7).astype(np.uint8) * 200
        f = np.where(xx < W // 3,
                     ((yy * 3 + xx * 2 + i * 17) % 256).astype(np.uint8), f)
        f[:4] = 0
        out.append(f)
    return np.stack(out)


def _pcm_raster(rng, H=64, W=128, band=60):
    """Mostly dark with bright bit stripes, like a PCM capture."""
    f = (rng.random((H, W)) > 0.7).astype(np.uint8) * 200
    f[5:9] = 0
    f[:, band:band + 4] = 230
    return f


def _raises_alike(fn_port, fn_jax, port_exc, jax_exc):
    """Both raise their package's error class with the same message."""
    with pytest.raises(port_exc) as pe:
        fn_port()
    with pytest.raises(jax_exc) as je:
        fn_jax()
    assert str(pe.value) == str(je.value)


def test_native_core_is_the_ports_build():
    assert tsn.available()
    assert tsn.build("stitchcore.cpp").path.parent == tsn.BUILD_DIR


# -- FFV1 -------------------------------------------------------------------

def test_ffv1_crc32_ieee_known_vector():
    data = b"123456789"
    crc = fv.crc32_ieee(data)
    assert crc == jfv.crc32_ieee(data)
    assert fv.crc32_ieee(data + struct.pack(">I", crc)) == 0


def test_ffv1_range_coder_round_trip():
    rng = np.random.default_rng(0)
    vals = [int(v) for v in rng.integers(-255, 256, 500)]
    bufs = []
    for mod in (fv, jfv):
        enc = mod.RangeEncoder()
        st = np.full(32, 128, np.uint8)
        for v in vals:
            enc.put_symbol(st, v, 1)
        bufs.append(enc.finish())
    assert bufs[0] == bufs[1]
    dec = fv.RangeDecoder(bufs[0] + b"\x00\x00")
    st2 = np.full(32, 128, np.uint8)
    assert [dec.get_symbol(st2, 1) for _ in vals] == vals


def test_ffv1_golomb_reader_escape():
    bw = bytearray()
    bits = "0" * 12 + format(200, "08b") + "00000000"
    for i in range(0, len(bits), 8):
        bw.append(int(bits[i:i + 8], 2))
    assert fv.get_ur_golomb(fv.BitReader(bytes(bw)), 0, 12, 8) == 200 + 11


@pytest.mark.parametrize("kind", ["mixed", "noise", "solid"])
def test_ffv1_encode_decode_equal_jax(kind):
    rng = np.random.default_rng(1)
    frames = {"mixed": _mixed_frames(rng),
              "noise": rng.integers(0, 256, (1, 48, 64), np.uint8),
              "solid": np.full((1, 32, 48), 123, np.uint8)}[kind]
    extra, chunks = fv.encode(frames)
    assert (extra, chunks) == jfv.encode(frames)
    assert fv.crc32_ieee(extra) == 0
    H, W = frames.shape[1:]
    dec, jdec = fv.Decoder(extra, W, H), jfv.Decoder(extra, W, H)
    for c, f in zip(chunks, frames):
        y, key = dec.decode_frame_gray(c)
        jy, jkey = jdec.decode_frame_gray(c)
        assert key and jkey
        np.testing.assert_array_equal(y, f)
        np.testing.assert_array_equal(y, jy)


def test_ffv1_extradata_crc_rejected():
    extra = bytearray(fv.build_extradata())
    assert bytes(extra) == jfv.build_extradata()
    extra[len(extra) // 2] ^= 0xFF
    _raises_alike(lambda: fv.StreamConfig(bytes(extra)),
                  lambda: jfv.StreamConfig(bytes(extra)),
                  fv.FFV1Error, jfv.FFV1Error)


@pytest.mark.parametrize("native", [True, False])
def test_ffv1_slice_crc_and_missing_keyframe_rejected(native):
    f = _mixed_frames(np.random.default_rng(3), F=1)
    extra, chunks = fv.encode(f)
    H, W = f.shape[1:]
    bad = bytearray(chunks[0])
    bad[len(bad) // 2] ^= 0xFF
    nokey = bytes([chunks[0][0] ^ 0x80]) + chunks[0][1:]
    for data in (bytes(bad), nokey):
        _raises_alike(
            lambda: fv.Decoder(extra, W, H, native=native)
            .decode_frame_gray(data),
            lambda: jfv.Decoder(extra, W, H, native=native)
            .decode_frame_gray(data), fv.FFV1Error, jfv.FFV1Error)


def test_ffv1_initial_states_parse():
    """Initial states, one rac state array per context byte, then ec and
    intra (tests/test_ffv1.py's stream), parse as in JAX."""
    enc = fv.RangeEncoder()
    state = [128] * fv.CONTEXT_SIZE
    for v in (3, 4, 1, 0, 8):
        enc.put_symbol(state, v, 0)
    enc.put_rac(state, 0, 0)
    enc.put_symbol(state, 0, 0)
    enc.put_symbol(state, 0, 0)
    enc.put_rac(state, 0, 0)
    for v in (0, 0, 1):
        enc.put_symbol(state, v, 0)
    for _ in range(3):
        fv._write_quant_table(enc, fv._ENC_LEVELS)
    for _ in range(2):
        fv._write_quant_table(enc, [0] * 128)
    enc.put_rac(state, 0, 1)
    cc = fv._enc_quant_table()[1]
    ini = np.random.default_rng(0).integers(
        0, 256, (cc, fv.CONTEXT_SIZE)).astype(np.int64)
    st2 = [[128] * fv.CONTEXT_SIZE for _ in range(fv.CONTEXT_SIZE)]
    pred = [128] * fv.CONTEXT_SIZE
    for j in range(cc):
        for k in range(fv.CONTEXT_SIZE):
            delta = (int(ini[j, k]) - pred[k] + 128) % 256 - 128
            enc.put_symbol(st2[k], delta, 1)
            pred[k] = int(ini[j, k])
    enc.put_symbol(state, 1, 0)
    enc.put_symbol(state, 1, 0)
    body = enc.finish()
    extra = body + struct.pack(">I", fv.crc32_ieee(body))
    cfg, jcfg = fv.StreamConfig(extra), jfv.StreamConfig(extra)
    assert (cfg.ec, cfg.intra) == (jcfg.ec, jcfg.intra) == (1, 1)
    np.testing.assert_array_equal(cfg.initial_states[0],
                                  (ini & 0xFF).astype(np.uint8))
    np.testing.assert_array_equal(cfg.initial_states[0],
                                  jcfg.initial_states[0])


def test_ffv1_chroma_stream_luma_decodes():
    rng = np.random.default_rng(11)
    H, W = 48, 64
    frames = _mixed_frames(rng, F=2, H=H, W=W)
    cb = rng.integers(100, 160, (H // 2, W // 2), np.uint8)
    cr = rng.integers(100, 160, (H // 2, W // 2), np.uint8)
    enc, jenc = fv.Encoder(W, H, chroma_planes=True), \
        jfv.Encoder(W, H, chroma_planes=True)
    chunks = [enc.encode_frame(f, chroma=(cb, cr)) for f in frames]
    assert chunks == [jenc.encode_frame(f, chroma=(cb, cr)) for f in frames]
    assert enc.extradata == jenc.extradata
    for native in (True, False):
        dec = fv.Decoder(enc.extradata, W, H, native=native)
        for c, f in zip(chunks, frames):
            np.testing.assert_array_equal(dec.decode_frame_gray(c)[0], f)


def test_ffv1_native_decode_bit_identical():
    frames = _mixed_frames(np.random.default_rng(9), F=4)
    extra, chunks = fv.encode(frames)
    H, W = frames.shape[1:]
    dn = fv.Decoder(extra, W, H, native=True)
    dp = fv.Decoder(extra, W, H, native=False)
    for c, f in zip(chunks, frames):
        (a, ka), (b, kb) = dn.decode_frame_gray(c), dp.decode_frame_gray(c)
        assert ka == kb
        np.testing.assert_array_equal(a, f)
        np.testing.assert_array_equal(b, f)


# -- Lagarith ---------------------------------------------------------------

def _lags_planes(rng):
    p = [_pcm_raster(rng, H=48, W=96),                   # rac
         rng.integers(0, 256, (24, 24), np.uint8),       # raw fallback
         np.full((16, 16), 9, np.uint8),                 # solid
         np.zeros((32, 48), np.uint8)]                   # long zero runs
    p[3][3, 5] = 77
    return p


@pytest.mark.parametrize("esc", [1, 2, 3])
def test_lagarith_planes_encode_and_decode_like_jax(esc):
    for p in _lags_planes(np.random.default_rng(9)):
        enc = lg.encode_plane(p, esc_num=esc)
        assert enc == jlg.encode_plane(p, esc_num=esc)
        H, W = p.shape
        for native in (True, False):
            np.testing.assert_array_equal(
                lg.decode_plane(enc + b"\x00\x00", 0, W, H, native=native),
                p)


def test_lagarith_plane_solid_fill_and_zero_runs():
    p = np.full((20, 30), 123, np.uint8)
    assert lg.encode_plane(p) == bytes([0xFF, 123])
    np.testing.assert_array_equal(lg.decode_plane(bytes([0xFF, 123]), 0, 30,
                                                  20), p)
    z = np.zeros((40, 64), np.uint8)
    z[0, 0], z[13, 7], z[39, 63] = 200, 90, 45
    enc = lg.encode_plane(z)
    assert enc == jlg.encode_plane(z)
    np.testing.assert_array_equal(lg.decode_plane(enc + b"\x00\x00", 0, 64,
                                                  40), z)


def test_lagarith_softfloat_table_native_and_python():
    """A non-power-of-two probability table (the softfloat rescale):
    native and Python decoders of the port agree with the source."""
    rng = np.random.default_rng(9)
    y = _pcm_raster(rng, H=24, W=64)
    syms = lg._symbolize(lg._residual_plane(y), 2)
    probs = lg._norm_probs(syms, 15)
    probs[int(np.argmax(probs))] -= 1
    assert lg.scale_prob_table(probs) == jlg.scale_prob_table(probs)
    cum, scale = lg.scale_prob_table(probs)
    enc = lg._RacEncoder(cum, scale)
    for s in syms:
        enc.put(s)
    rac_bytes, nbytes = enc.finish()
    bw = lg._BitWriter()
    lg._write_probs(bw, probs)
    plane = (bytes([2]) + struct.pack("<I", max(nbytes + 2, len(syms)))
             + bw.align_byte() + rac_bytes + b"\x00\x00")
    for native in (True, False):
        np.testing.assert_array_equal(
            lg.decode_plane(plane, 0, 64, 24, native=native), y)


def test_lagarith_frames_like_jax():
    rng = np.random.default_rng(3)
    f = _pcm_raster(rng, H=48, W=96)
    chunk = lg.encode_frame(f)
    assert chunk == jlg.encode_frame(f)
    np.testing.assert_array_equal(lg.decode_frame_gray(chunk, 96, 48), f)
    solid = np.full((24, 32), 17, np.uint8)
    assert lg.encode_frame(solid)[0] == lg.FRAME_SOLID_GRAY
    y = _pcm_raster(rng, H=32, W=64)
    v = rng.integers(100, 160, (16, 32), np.uint8)
    u = rng.integers(100, 160, (16, 32), np.uint8)
    chunk = lg.encode_frame(y, chroma=(v, u))
    assert chunk == jlg.encode_frame(y, chroma=(v, u))
    for a, b in zip(lg.decode_frame_planes(chunk, 64, 32), (y, v, u)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("src", [
    bytes([5, 0, 0, 0, 0]), bytes([0, 0, 0, 0, 0]), bytes([9, 0, 0, 0, 0]),
    bytes([4, 1, 2])], ids=["zero-run-line", "zero-rle", "escape", "short"])
def test_lagarith_plane_errors_like_jax(native, src):
    _raises_alike(lambda: lg.decode_plane(src, 0, 8, 8, native=native),
                  lambda: jlg.decode_plane(src, 0, 8, 8, native=native),
                  lg.LagarithError, jlg.LagarithError)


@pytest.mark.parametrize("data", [
    bytes([2]) + b"\x00" * 20, b"", bytes([lg.FRAME_ARITH_YV12, 0, 0])],
    ids=["frame-type", "empty", "truncated"])
def test_lagarith_frame_errors_like_jax(data):
    _raises_alike(lambda: lg.decode_frame_gray(data, 8, 8),
                  lambda: jlg.decode_frame_gray(data, 8, 8),
                  lg.LagarithError, jlg.LagarithError)


def test_lagarith_tables_and_vlc_like_jax():
    probs = [0] * 256
    probs[0], probs[1], probs[200] = 100, 50, 30
    cum, scale = lg.scale_prob_table(probs)
    assert (cum[1] - cum[0], cum[2] - cum[1], cum[201] - cum[200]) == \
        (143, 71, 42) and scale == 8
    assert (cum, scale) == jlg.scale_prob_table(probs)
    assert all(lg._calc_zero_run(lg._zero_run_byte(r)) == r
               for r in range(256))
    vals = [0, 1, 2, 3, 7, 12, 100, 255, 1 << 14, (1 << 20) - 3]
    bw = lg._BitWriter()
    for v in vals:
        lg._write_prob_vlc(bw, v)
    br = lg._BitReader(bw.align_byte())
    assert [lg._read_prob_vlc(br) for _ in vals] == vals


# -- Ut Video ---------------------------------------------------------------

@pytest.mark.parametrize("pred", PREDS)
@pytest.mark.parametrize("fourcc", ["ULY0", "ULY2"])
def test_utvideo_frames_like_jax(pred, fourcc):
    f = _pcm_raster(np.random.default_rng(PREDS.index(pred)), H=48, W=64,
                    band=40)
    extra, chunks = utv.encode(f[None], fourcc, pred=pred)
    assert (extra, chunks) == jutv.encode(f[None], fourcc, pred=pred)
    info = utv.StreamInfo(fourcc.encode(), extra)
    for native in (True, False):
        np.testing.assert_array_equal(
            utv.decode_frame_gray(chunks[0], 64, 48, info, native=native), f)


@pytest.mark.parametrize("slices", [1, 2, 5])
def test_utvideo_multi_slice_and_solid(slices):
    f = _pcm_raster(np.random.default_rng(slices), H=50, W=32, band=20)
    for frame in (f, np.full((50, 32), 99, np.uint8)):
        extra, chunks = utv.encode(frame[None], "ULY0", pred="median",
                                   slices=slices)
        assert chunks == jutv.encode(frame[None], "ULY0", pred="median",
                                     slices=slices)[1]
        info = utv.StreamInfo(b"ULY0", extra)
        assert info.slices == slices
        np.testing.assert_array_equal(
            utv.decode_frame_gray(chunks[0], 32, 50, info), frame)


def test_utvideo_planes_like_jax():
    rng = np.random.default_rng(8)
    y = _pcm_raster(rng, H=32, W=64, band=40)
    u = rng.integers(100, 160, (16, 32), np.uint8)
    v = rng.integers(100, 160, (16, 32), np.uint8)
    info = utv.StreamInfo(b"ULY0", utv.build_extradata("ULY0"))
    chunk = utv.encode_frame(y, info, utv.PRED_MEDIAN, chroma=(u, v))
    jinfo = jutv.StreamInfo(b"ULY0", jutv.build_extradata("ULY0"))
    assert chunk == jutv.encode_frame(y, jinfo, jutv.PRED_MEDIAN,
                                      chroma=(u, v))
    for a, b in zip(utv.decode_frame_planes(chunk, 64, 32, info), (y, u, v)):
        np.testing.assert_array_equal(a, b)


def test_utvideo_stream_errors_like_jax():
    extra = bytearray(utv.build_extradata("ULY0"))
    extra[13] |= 0x08
    _raises_alike(lambda: utv.StreamInfo(b"ULY0", bytes(extra)),
                  lambda: jutv.StreamInfo(b"ULY0", bytes(extra)),
                  utv.UtVideoError, jutv.UtVideoError)
    _raises_alike(lambda: utv.StreamInfo(b"ULRA", utv.build_extradata("ULY0")),
                  lambda: jutv.StreamInfo(b"ULRA",
                                          jutv.build_extradata("ULY0")),
                  utv.UtVideoError, jutv.UtVideoError)


@pytest.mark.parametrize("native", [True, False])
def test_utvideo_plane_errors_like_jax(native):
    info = utv.StreamInfo(b"ULY0", utv.build_extradata("ULY0"))
    jinfo = jutv.StreamInfo(b"ULY0", jutv.build_extradata("ULY0"))
    f = _pcm_raster(np.random.default_rng(0), H=24, W=32, band=20)
    chunk = bytearray(utv.encode_frame(f, info, utv.PRED_LEFT))
    struct.pack_into("<I", chunk, 256, 1 << 30)
    for data in (b"\x00" * 64, bytes(chunk)):
        _raises_alike(
            lambda: utv.decode_frame_gray(data, 32, 24, info, native=native),
            lambda: jutv.decode_frame_gray(data, 32, 24, jinfo,
                                           native=native),
            utv.UtVideoError, jutv.UtVideoError)


@pytest.mark.parametrize("pred", PREDS)
def test_utvideo_native_decode_bit_identical(pred):
    rng = np.random.default_rng(11)
    for p in (_pcm_raster(rng, H=50, W=64, band=40),
              rng.integers(0, 256, (24, 24), np.uint8),
              np.full((20, 16), 7, np.uint8)):
        for slices in (1, 3):
            H, W = p.shape
            extra, chunks = utv.encode(p[None], "ULY0", pred=pred,
                                       slices=slices)
            info = utv.StreamInfo(b"ULY0", extra)
            for native in (True, False):
                np.testing.assert_array_equal(utv.decode_frame_gray(
                    chunks[0], W, H, info, native=native), p)


# -- HuffYUV ----------------------------------------------------------------

def test_huffyuv_encode_and_both_decoders_like_jax():
    rng = np.random.default_rng(5)
    frames = np.clip(rng.normal(60, 25, (3, 24, 64)), 0, 255).astype(np.uint8)
    frames[:, :, 30:50] = 190
    extra, payloads = hf.encode(frames)
    assert (extra, payloads) == jhf.encode(frames)
    lens3 = hf.parse_extradata(extra)
    for f, data in zip(frames, payloads):
        np.testing.assert_array_equal(hf.decode_frame(data, 64, 24, lens3), f)
        np.testing.assert_array_equal(
            hf.decode_frame(data, 64, 24, lens3, native=False), f)


def test_huffyuv_malformed_extradata_like_jax():
    extra, _ = hf.encode(np.zeros((1, 8, 16), np.uint8))
    bad = bytes([2]) + extra[1:]          # "median" predictor: out of scope
    with pytest.raises(ValueError) as pe:
        hf.parse_extradata(bad)
    with pytest.raises(ValueError) as je:
        jhf.parse_extradata(bad)
    assert str(pe.value) == str(je.value)


# -- the bindings against the JAX loader's, on the same bytes ---------------

def _jsn():
    from sdvpcmdecoder_tpu.ops import stitch_native as jsn
    assert jsn.available()
    return jsn


def _same(a, b):
    if isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


def test_binding_hfyu_decode_yuy2_and_frames():
    jsn = _jsn()
    rng = np.random.default_rng(21)
    frames = rng.integers(0, 256, (3, 16, 32), np.uint8)
    extra, payloads = hf.encode(frames)
    ly, lu, lv = hf.parse_extradata(extra)
    data = np.frombuffer(payloads[1], np.uint8)
    _same(tsn.hfyu_decode_yuy2(data, 32, 16, ly, lu, lv),
          jsn.hfyu_decode_yuy2(data, 32, 16, ly, lu, lv))
    blob = b"".join(payloads)
    offs = np.cumsum([0] + [len(p) for p in payloads])
    entries = [(int(offs[0]), len(payloads[0])), (-1, 0),
               (int(offs[2]), len(payloads[2]))]
    got = tsn.hfyu_decode_frames(blob, entries, 32, 16, ly, lu, lv)
    _same(got, jsn.hfyu_decode_frames(blob, entries, 32, 16, ly, lu, lv))
    assert not got[1][1].any() and (got[0] == 0).all()
    with pytest.raises(ValueError, match="HFYU"):
        tsn.hfyu_decode_yuy2(data[:8], 32, 16, ly, lu, lv)


def test_binding_uly_plane_and_frames():
    jsn = _jsn()
    rng = np.random.default_rng(22)
    frames = np.stack([_pcm_raster(rng, H=30, W=40, band=20)
                       for _ in range(3)])
    extra, chunks = utv.encode(frames, "ULY0", pred="median", slices=3)
    data = chunks[0]
    for pos in (0, 5):   # a bad position reports its rc like JAX's
        _same(tsn.uly_decode_plane(data, pos, 40, 30, 3, utv.PRED_MEDIAN,
                                   False),
              jsn.uly_decode_plane(data, pos, 40, 30, 3, utv.PRED_MEDIAN,
                                   False))
    blob = b"".join(chunks)
    offs = np.cumsum([0] + [len(c) for c in chunks])
    entries = [(int(offs[k]), len(chunks[k])) for k in range(3)] + [(-1, 0)]
    _same(tsn.uly_decode_frames_gray(blob, entries, 40, 30, 3, False),
          jsn.uly_decode_frames_gray(blob, entries, 40, 30, 3, False))


def test_binding_lags_plane_and_frames():
    jsn = _jsn()
    rng = np.random.default_rng(23)
    frames = np.stack([_pcm_raster(rng, H=16, W=40, band=20)
                       for _ in range(2)])
    chunks = lg.encode(frames)
    plane = lg.encode_plane(frames[0]) + b"\x00\x00"
    for src in (plane, bytes([9, 0, 0, 0, 0])):
        _same(tsn.lags_decode_plane(src, 0, 40, 16),
              jsn.lags_decode_plane(src, 0, 40, 16))
    chunks[1] = bytes([lg.FRAME_ARITH_YUY2]) + chunks[1][1:]   # rc -5
    blob = b"".join(chunks)
    entries = [(0, len(chunks[0])), (len(chunks[0]), len(chunks[1]))]
    rcs, out = tsn.lags_decode_frames_gray(blob, entries, 40, 16)
    jrcs, jout = jsn.lags_decode_frames_gray(blob, entries, 40, 16)
    _same((rcs, out[0]), (jrcs, jout[0]))   # a failed frame's slot is unset
    assert rcs[0] == 0 and rcs[1] != 0


def test_binding_ffv1_decode_frame_gray():
    """The native FFV1 call with Python-owned contexts: two decoders
    (the port's binding and the JAX loader's) fed the same configuration
    and state arrays step through a stream identically."""
    jsn = _jsn()
    frames = _mixed_frames(np.random.default_rng(24), F=3, H=32, W=48)
    extra, chunks = fv.encode(frames)
    dec = fv.Decoder(extra, 48, 32)
    assert dec._native_decode(chunks[0]) is not None   # builds the config
    cfg = dec._native_cfg
    states = {}
    for name, mod in (("port", tsn), ("jax", jsn)):
        st = tuple(np.zeros_like(a) for a in dec._native_state)
        st[0][:] = -1
        outs, seen = [], False
        for c in chunks:
            rc, key, out = mod.ffv1_decode_frame_gray(c, 48, 32, cfg,
                                                      (*st, seen))
            seen = seen or key
            outs.append((rc, key, out))
        states[name] = (outs, st)
    (po, pst), (jo, jst) = states["port"], states["jax"]
    for (rc, key, out), f, j in zip(po, frames, jo):
        assert rc == 0 and key
        np.testing.assert_array_equal(out, f)
        _same((rc, key, out), j)
    _same(pst, jst)


def test_bindings_return_none_only_without_the_core(monkeypatch):
    """SDV_NO_NATIVE=1 is the one way to the Python decoders: the bindings
    return None and the codecs decode in Python."""
    monkeypatch.setattr(tsn, "_LIB", None)
    monkeypatch.setenv("SDV_NO_NATIVE", "1")
    assert tsn.lags_decode_plane(b"\xff\x07", 0, 4, 4) is None
    assert tsn.uly_decode_frames_gray(b"", [], 4, 4, 1, False) is None
    f = np.full((8, 8), 7, np.uint8)
    np.testing.assert_array_equal(
        lg.decode_plane(lg.encode_plane(f), 0, 8, 8), f)


def test_failed_build_raises_not_python(monkeypatch, tmp_path):
    """A core that does not build raises from the codec call: there is no
    silent fall back to the Python decoders (the JAX reader's)."""
    monkeypatch.setattr(tsn, "_LIB", None)
    monkeypatch.delenv("SDV_NO_NATIVE", raising=False)
    monkeypatch.setattr(tsn, "BUILD_DIR", tmp_path / "b")
    monkeypatch.setattr(tsn, "CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises((RuntimeError, OSError)):
        lg.decode_plane(bytes([0xFF, 7]), 0, 4, 4)
