"""The port's AVI and Matroska readers and writers (pipeline/avi.py,
mkv.py) and its ingest routing against the JAX package's, on the CPU.

Mirrors tests/test_avi.py, test_mkv.py and test_dropped_frames.py (their
cases that need no FFmpeg/libav): the writers write the JAX writers'
bytes, the readers return the source frames and the JAX readers' frames
(dropped slots black, OpenDML segments, every codec), ingest.open_capture
routes by extension, the batch drivers take containers with the
reader's dropped-frame count, and damaged files fail as in JAX.
"""
import json
import struct

import numpy as np
import pytest
import torch

from sdvpcmdecoder_tpu.pipeline import avi as javi
from sdvpcmdecoder_tpu.pipeline import batch_driver as jbd
from sdvpcmdecoder_tpu.pipeline import ingest as jingest
from sdvpcmdecoder_tpu.pipeline import mkv as jmkv
from sdvpcmdecoder_tpu_torch.pipeline import avi
from sdvpcmdecoder_tpu_torch.pipeline import batch_driver as tbd
from sdvpcmdecoder_tpu_torch.pipeline import device_driver as tdd
from sdvpcmdecoder_tpu_torch.pipeline import ingest, mkv

import chip_smoke
from test_torch_batch_driver import STAT_FIELDS

torch.set_num_threads(1)

AVI_CODECS = ["Y800", "YUY2", "UYVY", "DIB", "HFYU", "LAGS", "ULY0", "ULY2",
              "FFV1"]
MKV_CODECS = ["FFV1", "HFYU", "ULY0", "LAGS", "Y800"]


def _frames(F=5, H=32, W=48, seed=3):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 255, size=(F, H, W)).astype(np.uint8)


def _raster(F=3, H=48, W=64, seed=1):
    rng = np.random.default_rng(seed)
    return np.stack([(rng.random((H, W)) > 0.7).astype(np.uint8) * 200
                     for _ in range(F)])


def _both_read(path, first=0, count=None, view=False):
    """(port frames, JAX frames, port reader attrs, JAX reader attrs)."""
    out = []
    for mod in (ingest, jingest):
        with mod.open_capture(str(path)) as rd:
            n = rd.n_frames if count is None else count
            fn = rd.read_frames_view if view else rd.read_frames
            out.append((fn(first, n), (rd.width, rd.height, rd.n_frames,
                                       rd.dropped_frames, type(rd).__name__)))
    (t, ta), (j, ja) = out
    return t, j, ta, ja


@pytest.mark.parametrize("codec", AVI_CODECS)
def test_avi_writer_and_reader_like_jax(tmp_path, codec):
    frames = _raster(seed=AVI_CODECS.index(codec)) if codec in (
        "LAGS", "FFV1") else _frames()
    p, jp = tmp_path / "t.avi", tmp_path / "j.avi"
    avi.write_avi(p, frames, codec=codec)
    javi.write_avi(jp, frames, codec=codec)
    assert p.read_bytes() == jp.read_bytes()
    got, jgot, ta, ja = _both_read(p)
    assert ta == ja and ta[:4] == (frames.shape[2], frames.shape[1],
                                   len(frames), 0)
    np.testing.assert_array_equal(got, frames)
    np.testing.assert_array_equal(got, jgot)


def test_avi_mjpeg_like_jax(tmp_path):
    """MJPG is gated on Pillow in both packages (as in tests/test_avi.py):
    the port decodes the JAX reader's luma."""
    pytest.importorskip("PIL")
    frames = np.zeros((3, 32, 48), np.uint8) + np.array(
        [30, 128, 220], np.uint8)[:, None, None]
    p = tmp_path / "m.avi"
    javi.write_avi(p, frames, codec="MJPG", quality=95)
    got, jgot, ta, ja = _both_read(p)
    assert ta == ja
    np.testing.assert_array_equal(got, jgot)
    assert np.abs(got.astype(int) - frames.astype(int)).max() <= 4


@pytest.mark.parametrize("codec", ["Y800", "HFYU", "ULY0"])
def test_avi_dropped_slots_like_jax(tmp_path, codec):
    frames = _frames(F=4)
    p = tmp_path / "drops.avi"
    avi.write_avi(p, frames, codec=codec, drops=[1, 4])
    got, jgot, ta, ja = _both_read(p)
    assert ta == ja and ta[2:4] == (6, 2)
    np.testing.assert_array_equal(got, jgot)
    for slot, src in ((0, 0), (2, 1), (3, 2), (5, 3)):
        np.testing.assert_array_equal(got[slot], frames[src])
    assert not got[1].any() and not got[4].any()


def test_avi_partial_reads_and_view(tmp_path):
    frames = _frames(F=6)
    p = tmp_path / "part.avi"
    avi.write_avi(p, frames, codec="Y800")
    with avi.AVIReader(p) as rd:
        np.testing.assert_array_equal(rd.read_frames(2, 3), frames[2:5])
        view = rd.read_frames_view(4, 10)
        np.testing.assert_array_equal(view, frames[4:6])
        assert rd.read_frames(6, 4).shape == (0, 32, 48)
    got, jgot, _, _ = _both_read(p, 1, 4, view=True)
    np.testing.assert_array_equal(got, jgot)


def test_open_capture_routes_containers(tmp_path):
    frames = _frames(F=2)
    pa, pm = tmp_path / "r.avi", tmp_path / "r.mkv"
    avi.write_avi(pa, frames, codec="Y800")
    mkv.write_mkv(pm, frames, codec="FFV1")
    with ingest.open_capture(pa) as a, ingest.open_capture(pm) as m:
        assert type(a) is avi.AVIReader and type(m) is mkv.MKVReader
        assert isinstance(m, avi.AVIReader)
        np.testing.assert_array_equal(a.read_frames(0, 2), frames)
        np.testing.assert_array_equal(m.read_frames(0, 2), frames)
    for ext in (".mka", ".webm"):
        q = tmp_path / f"r{ext}"
        q.write_bytes(pm.read_bytes())
        with ingest.open_capture(q) as rd:
            assert type(rd) is mkv.MKVReader


def _patched(tmp_path, name, find, repl, nth=(0,)):
    frames = _frames(F=2)
    p = tmp_path / name
    (mkv.write_mkv if name.endswith(".mkv") else avi.write_avi)(
        p, frames, codec="FFV1" if name.endswith(".mkv") else "Y800")
    raw = bytearray(p.read_bytes())
    pos = -1
    for _ in range(max(nth) + 1):
        pos = raw.find(find, pos + 1)
        if _ in nth:
            raw[pos:pos + len(repl)] = repl
    p.write_bytes(bytes(raw))
    return p


@pytest.mark.parametrize("case", ["cvid", "hfyu-median", "not-avi",
                                  "mkv-av1", "not-mkv"])
def test_unreadable_containers_raise_like_jax(tmp_path, case):
    if case == "cvid":
        p = _patched(tmp_path, "x.avi", b"Y800", b"CVID", nth=(0, 1))
    elif case == "hfyu-median":
        p = tmp_path / "m.avi"
        avi.write_avi(p, _frames(F=2), codec="HFYU")
        raw = bytearray(p.read_bytes())
        raw[raw.find(b"strf") + 8 + 40] = 2
        p.write_bytes(bytes(raw))
    elif case == "not-avi":
        p = tmp_path / "bogus.avi"
        p.write_bytes(b"not a riff file at all")
    elif case == "mkv-av1":
        p = _patched(tmp_path, "x.mkv", b"V_FFV1", b"V_AV1\x00")
    else:
        p = tmp_path / "n.mkv"
        p.write_bytes(b"RIFF\x00\x00\x00\x00AVI LIST")
    with pytest.raises(avi.AVIError) as pe:
        ingest.open_capture(p)
    with pytest.raises(javi.AVIError) as je:
        jingest.open_capture(p)
    assert str(pe.value) == str(je.value)


def test_opendml_avix_segments(tmp_path):
    """An OpenDML file whose indx covers frames in the 'AVI ' segment and
    an 'AVIX' extension, beside a legacy idx1 of segment 1 only
    (tests/test_avi.py's file): the indx wins in both readers."""
    H = W = 8
    frames = _frames(F=4, H=H, W=W, seed=5)
    payloads = [frames[i].tobytes() for i in range(4)]

    def chunk(ckid, body):
        return ckid + struct.pack("<I", len(body)) + body + (
            b"\x00" if len(body) & 1 else b"")

    def lst(ltype, body):
        return chunk(b"LIST", ltype + body)

    strh = (b"vids" + b"Y800" + b"\x00" * 12 + struct.pack("<II", 1, 25)
            + struct.pack("<III", 0, 4, 0) + struct.pack("<i", -1)
            + struct.pack("<I", 0) + struct.pack("<4H", 0, 0, W, H))
    strf = struct.pack("<IiiHH4sIiiII", 40, W, H, 1, 8, b"Y800", W * H,
                       0, 0, 0, 0)
    avih = struct.pack("<14I", 40000, 0, 0, 0x10, 4, 0, 1, 0, W, H,
                       0, 0, 0, 0)
    indx = (struct.pack("<HBB", 2, 0, 0x01) + struct.pack("<I", 4) + b"00dc"
            + struct.pack("<Q", 0) + struct.pack("<I", 0) + b"\x00" * 32)
    hdrl = lst(b"hdrl", chunk(b"avih", avih) + lst(
        b"strl", chunk(b"strh", strh) + chunk(b"strf", strf)
        + chunk(b"indx", indx)))
    movi1 = chunk(b"00dc", payloads[0]) + chunk(b"00dc", payloads[1])
    movi2 = chunk(b"00dc", payloads[2]) + chunk(b"00dc", payloads[3])
    idx1 = (b"00dc" + struct.pack("<III", 0x10, 4, len(payloads[0]))
            + b"00dc" + struct.pack("<III", 0x10, 4 + 8 + len(payloads[0]),
                                    len(payloads[1])))
    seg1 = hdrl + lst(b"movi", movi1) + chunk(b"idx1", idx1)
    seg2 = lst(b"movi", movi2)
    raw = bytearray(b"RIFF" + struct.pack("<I", 4 + len(seg1)) + b"AVI "
                    + seg1 + b"RIFF" + struct.pack("<I", 4 + len(seg2))
                    + b"AVIX" + seg2)
    offsets, pos = [], 0
    while (pos := raw.find(b"00dc", pos)) >= 0 and pos + 8 <= len(raw):
        if struct.unpack_from("<I", raw, pos + 4)[0] == W * H:
            offsets.append(pos + 8)
        pos += 4
    assert len(offsets) == 4
    at = raw.find(b"indx") + 8 + 24
    for k, o in enumerate(offsets):
        struct.pack_into("<II", raw, at + 8 * k, o, W * H)
    p = tmp_path / "odml.avi"
    p.write_bytes(bytes(raw))
    got, jgot, ta, ja = _both_read(p)
    assert ta == ja and ta[2] == 4
    np.testing.assert_array_equal(got, frames)
    np.testing.assert_array_equal(got, jgot)


def test_truncation_and_corruption_fuzz_like_jax(tmp_path):
    """Cut or bit-flipped AVIs: each reader refuses cleanly or decodes
    what remains, and the port does exactly what the JAX reader does."""
    p = tmp_path / "whole.avi"
    avi.write_avi(str(p), _frames(F=6), codec="Y800")
    blob = p.read_bytes()
    rng = np.random.default_rng(8)
    for trial in range(12):
        bad = bytearray(blob[:int(rng.integers(4, len(blob)))])
        if trial % 2 and len(bad) > 64:
            for _ in range(4):
                bad[int(rng.integers(0, min(len(bad), 256)))] ^= 0xFF
        q = tmp_path / f"bad_{trial}.avi"
        q.write_bytes(bytes(bad))
        results = []
        for mod in (avi, javi):
            try:
                with mod.AVIReader(str(q)) as rd:
                    results.append(rd.read_frames(0, rd.n_frames))
            except (ValueError, OSError, EOFError) as e:
                results.append(type(e).__name__ + str(e))
        if isinstance(results[0], np.ndarray):
            assert results[0].ndim == 3
            np.testing.assert_array_equal(results[0], results[1])
        else:
            assert results[0] == results[1]


@pytest.mark.parametrize("codec", MKV_CODECS)
def test_mkv_writer_and_reader_like_jax(tmp_path, codec):
    frames = _raster()
    p, jp = tmp_path / "t.mkv", tmp_path / "j.mkv"
    mkv.write_mkv(p, frames, codec=codec)
    jmkv.write_mkv(jp, frames, codec=codec)
    assert p.read_bytes() == jp.read_bytes()
    got, jgot, ta, ja = _both_read(p)
    assert ta == ja and ta[:3] == (64, 48, 3)
    np.testing.assert_array_equal(got, frames)
    np.testing.assert_array_equal(got, jgot)


@pytest.mark.parametrize("codec", ["FFV1", "HFYU"])
def test_mkv_dropped_frames_like_jax(tmp_path, codec):
    frames = _raster(seed=2)
    p = tmp_path / "d.mkv"
    mkv.write_mkv(p, frames, codec=codec, drops=[1, 3])
    got, jgot, ta, ja = _both_read(p)
    assert ta == ja and ta[2:4] == (5, 2)
    np.testing.assert_array_equal(got, jgot)
    for slot, src in ((0, 0), (2, 1), (4, 2)):
        np.testing.assert_array_equal(got[slot], frames[src])
    assert not got[1].any() and not got[3].any()


def test_mkv_truncated_raises_at_open(tmp_path):
    p = tmp_path / "t.mkv"
    mkv.write_mkv(p, _raster(seed=8), codec="FFV1")
    raw = p.read_bytes()
    for cut in (1, 37, 200):
        q = tmp_path / f"cut{cut}.mkv"
        q.write_bytes(raw[:-cut])
        with pytest.raises(avi.AVIError):
            mkv.MKVReader(q)
        with pytest.raises(javi.AVIError):
            jmkv.MKVReader(q)


def test_mkv_payloads_build_extradata_and_match_avi(tmp_path):
    from sdvpcmdecoder_tpu_torch.pipeline import ffv1 as fv
    frames = _raster(seed=9, H=32, W=96)
    _, chunks = fv.encode(frames)
    pm, pa = tmp_path / "p.mkv", tmp_path / "p.avi"
    mkv.write_mkv(pm, frames, codec="FFV1", payloads=chunks)
    avi.write_avi(pa, frames, codec="FFV1")
    assert avi.resolve_payloads(frames, "FFV1", payloads=chunks) == \
        javi.resolve_payloads(frames, "FFV1", payloads=chunks)
    with ingest.open_capture(pm) as a, ingest.open_capture(pa) as b:
        np.testing.assert_array_equal(a.read_frames(0, 3), frames)
        np.testing.assert_array_equal(b.read_frames(0, 3), frames)


def test_ffv1_reads_in_order_and_rewinds(tmp_path):
    """FFV1 contexts carry across frames: a backward read rewinds to
    frame 0 and rolls forward, a forward read decodes each frame once."""
    frames = _raster(F=4, seed=5)
    p = tmp_path / "f.avi"
    avi.write_avi(p, frames, codec="FFV1")
    with avi.AVIReader(p) as rd:
        calls = []
        orig = rd._ffv1.decode_frame_gray
        rd._ffv1.decode_frame_gray = lambda d: calls.append(1) or orig(d)
        for k in range(4):
            np.testing.assert_array_equal(rd.read_frames(k, 1)[0], frames[k])
        assert len(calls) == 4
        np.testing.assert_array_equal(rd.read_frames(2, 1)[0], frames[2])
        assert len(calls) == 4 + 3


def test_batch_decode_matches_per_frame(tmp_path):
    """The frame-parallel native batch path equals per-frame decode for
    ULY/LAGS/HFYU, dropped slot included; a frame the batch decoder
    rejects re-decodes alone and raises the codec's own error."""
    frames = _raster(F=5, H=32, W=64, seed=20)
    for codec in ("ULY0", "LAGS", "HFYU"):
        p = tmp_path / f"b_{codec}.avi"
        avi.write_avi(p, frames, codec=codec, drops=[2])
        with avi.AVIReader(p) as rd:
            assert rd._batch is not None
            batch = rd.read_frames(0, 6)
            rd._batch = None
            np.testing.assert_array_equal(batch, rd.read_frames(0, 6))
        assert not batch[2].any()
    from sdvpcmdecoder_tpu_torch.pipeline import lagarith as lg
    chunks = lg.encode(frames[:3])
    chunks[1] = bytes([lg.FRAME_ARITH_YUY2]) + chunks[1][1:]
    p = tmp_path / "bad.avi"
    avi.write_avi(p, frames[:3], codec="LAGS", payloads=chunks)
    with avi.AVIReader(p) as rd, pytest.raises(avi.AVIError,
                                               match="frame type"):
        rd.read_frames(0, 3)


def _pal_frames(n_frames=4, seed=11):
    return chip_smoke.capture_frames(n_frames, 294, seed)


@pytest.mark.parametrize("backend", ["native", "tpu"])
def test_batch_decoder_takes_containers_like_jax(tmp_path, backend):
    """BatchDecoder on HFYU AVI and FFV1 MKV captures (a dropped slot in
    the MKV): WAVs and stats equal the JAX driver's, frames_dropped is the
    reader's, and the HFYU WAV equals the Y800 one (codec transparency)."""
    vids = _pal_frames()
    caps = {"y800": tmp_path / "c.avi", "hfyu": tmp_path / "h.avi",
            "ffv1": tmp_path / "f.mkv"}
    avi.write_avi(caps["y800"], vids, codec="Y800")
    avi.write_avi(caps["hfyu"], vids, codec="HFYU")
    mkv.write_mkv(caps["ffv1"], vids, codec="FFV1", drops=[2])
    kw = dict(lines_per_field=294, hyst_limit=2, shift_limit=1,
              frames_per_round=2, backend=backend)
    wavs = {}
    for name, cap in caps.items():
        out, jout = tmp_path / f"{name}.wav", tmp_path / f"{name}.j.wav"
        t = tbd.BatchDecoder([(str(cap), str(out))], device="cpu", **kw)
        st = t.run()[str(cap)]
        jst = jbd.BatchDecoder([(str(cap), str(jout))], **kw).run()[str(cap)]
        assert out.read_bytes() == jout.read_bytes()
        assert all(getattr(st, f) == getattr(jst, f) for f in STAT_FIELDS)
        assert st.frames_dropped == (1 if name == "ffv1" else 0)
        wavs[name] = out.read_bytes()
    assert wavs["hfyu"] == wavs["y800"] and len(wavs["y800"]) > 1000


def test_device_batch_decoder_takes_containers(tmp_path):
    """DeviceBatchDecoder stages AVI frames (decoded copies, not mmap
    views) chunk by chunk, front to back: its WAV equals the y4m's and
    the JAX native driver's, with the reader's dropped-frame count."""
    vids = _pal_frames(6)
    cap, y4m = tmp_path / "c.avi", tmp_path / "c.y4m"
    avi.write_avi(cap, vids, codec="ULY0", drops=[3])
    with avi.AVIReader(cap) as rd:
        ingest.write_y4m(y4m, rd.read_frames(0, rd.n_frames))
    kw = dict(lines_per_field=294, hyst_limit=2, shift_limit=1,
              frames_per_round=2, hbm_frames=4)
    reads = []
    orig = avi.AVIReader.read_frames

    def spy(self, first, count):
        reads.append(first)
        return orig(self, first, count)

    avi.AVIReader.read_frames = spy
    try:
        dec = tdd.DeviceBatchDecoder([(str(cap), str(tmp_path / "a.wav"))],
                                     device="cpu", **kw)
        dec.run()
    finally:
        avi.AVIReader.read_frames = orig
    assert reads == sorted(reads) and reads[0] == 0
    assert dec.jobs[0].stats.frames_dropped == 1
    tdd.DeviceBatchDecoder([(str(y4m), str(tmp_path / "y.wav"))],
                           device="cpu", **kw).run()
    jbd.BatchDecoder([(str(cap), str(tmp_path / "j.wav"))],
                     backend="native", **{k: v for k, v in kw.items()
                                          if k != "hbm_frames"}).run()
    wav = (tmp_path / "a.wav").read_bytes()
    assert wav == (tmp_path / "y.wav").read_bytes() == \
        (tmp_path / "j.wav").read_bytes()


def test_narrow_avi_doubles_width_like_y4m(tmp_path):
    """read_frames_view on an AVI returns decoded copies; the host
    backend's width-doubling path (captures under 960 px) takes them as
    it takes a y4m's views."""
    vids = chip_smoke.wide_frames(3, 288, seed=6)
    cap, y4m = tmp_path / "w.avi", tmp_path / "w.y4m"
    avi.write_avi(cap, vids, codec="HFYU")
    ingest.write_y4m(y4m, vids)
    kw = dict(lines_per_field=None, hyst_limit=2, shift_limit=1,
              frames_per_round=2, backend="native", device="cpu")
    for c, o in ((cap, "a.wav"), (y4m, "y.wav")):
        tbd.BatchDecoder([(str(c), str(tmp_path / o))], **kw).run()
    assert (tmp_path / "a.wav").read_bytes() == \
        (tmp_path / "y.wav").read_bytes()
    assert len((tmp_path / "a.wav").read_bytes()) > 1000


def test_pts_sidecar_timeline_like_jax(tmp_path):
    """tests/test_dropped_frames.py's removed-frame captures: the `.pts`
    sidecar's gap reads back black in both readers, and a sidecar of the
    wrong length is refused by both."""
    vids = _pal_frames(5, seed=21)
    drop = 2
    cap = tmp_path / "c.y4m"
    ingest.write_y4m(cap, np.delete(vids, drop, axis=0))
    timeline = [i for i in range(len(vids)) if i != drop]
    (tmp_path / "c.y4m.pts").write_text(json.dumps({"timeline": timeline}))
    got, jgot, ta, ja = _both_read(cap)
    assert ta == ja and ta[2:4] == (5, 1)
    np.testing.assert_array_equal(got, jgot)
    assert not got[drop].any()
    np.testing.assert_array_equal(got[drop + 1], vids[drop + 1])
    (tmp_path / "c.y4m.pts").write_text(json.dumps([0, 1]))
    with pytest.raises(AssertionError):
        ingest.VideoReader(cap)
    with pytest.raises(AssertionError):
        jingest.VideoReader(cap)


def test_removed_frame_decodes_like_jax(tmp_path):
    """A capture with a physically removed frame and its `.pts` sidecar
    decodes to the JAX driver's WAV (the gap becomes a dummy frame that
    keeps the interleave phase)."""
    vids = _pal_frames(5, seed=21)
    cap = tmp_path / "c.y4m"
    ingest.write_y4m(cap, np.delete(vids, 2, axis=0))
    (tmp_path / "c.y4m.pts").write_text(json.dumps([0, 1, 3, 4]))
    kw = dict(hyst_limit=1, shift_limit=1, frames_per_round=2)
    st = tbd.BatchDecoder([(str(cap), str(tmp_path / "t.wav"))],
                          device="cpu", **kw).run()[str(cap)]
    jst = jbd.BatchDecoder([(str(cap), str(tmp_path / "j.wav"))],
                           **kw).run()[str(cap)]
    assert (tmp_path / "t.wav").read_bytes() == \
        (tmp_path / "j.wav").read_bytes()
    assert all(getattr(st, f) == getattr(jst, f) for f in STAT_FIELDS)
    assert st.frames_dropped == 1
