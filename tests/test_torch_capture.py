"""The port's capture device layer (pipeline/capture.py: V4L2 mmap
streaming through ctypes, the capture selector) against the JAX
package's, on the CPU.

Mirrors tests/test_v4l2.py (the injected fake ioctl surface: format
negotiation, the GREY fast path, sequence-gap dummies, open_stream's
routing, preview snapshots, reader-fed decode equals the file's) and the
capture half of tests/test_live_capture.py (enumeration, the selector's
state machine, a host without V4L2). Each scenario runs through both
packages; frames, ioctl sequences and state must agree.
"""
import os

import numpy as np
import pytest
import torch

from sdvpcmdecoder_tpu.pipeline import batch_driver as jbd
from sdvpcmdecoder_tpu.pipeline import capture as jcap
from sdvpcmdecoder_tpu_torch.pipeline import batch_driver as tbd
from sdvpcmdecoder_tpu_torch.pipeline import capture as cap
from sdvpcmdecoder_tpu_torch.pipeline import ingest, render

import chip_smoke
from test_v4l2 import FakeV4L2IO, _frames

torch.set_num_threads(1)

PACKAGES = {"port": cap, "jax": jcap}


def test_constants_and_presets_equal_jax():
    names = [n for n in dir(jcap) if n.isupper() and not n.startswith("_")]
    assert names and all(getattr(cap, n) == getattr(jcap, n) for n in names)
    for name in ("_V4L2Capability", "_V4L2Format", "_V4L2RequestBuffers",
                 "_V4L2Buffer"):
        assert ctypes_layout(getattr(cap, name)) == \
            ctypes_layout(getattr(jcap, name))


def ctypes_layout(struct_type):
    import ctypes
    return ctypes.sizeof(struct_type), [
        (f[0], ctypes.sizeof(f[1])) for f in struct_type._fields_]


@pytest.mark.parametrize("scenario", ["yuyv", "gap", "adjust"])
def test_v4l2_reader_like_jax(scenario):
    """YUYV negotiation (GREY refused), a sequence gap of two frames
    (black dummies), and a driver that forces another size."""
    kw = {"yuyv": {}, "gap": dict(drop_after=2, drop_n=2),
          "adjust": dict(adjust=(40, 24))}[scenario]
    n = 4 if scenario == "gap" else 5
    H, W = kw.get("adjust", (48, 32))[::-1] if scenario == "adjust" \
        else (32, 48)
    results = {}
    for name, mod in PACKAGES.items():
        io = FakeV4L2IO(_frames(n, H=H, W=W, seed=3), **kw)
        rd = mod.V4L2Reader("/dev/video9", 48, 32, io=io)
        got = rd.read_frames(0, n + 2)
        rest = rd.read_frames(got.shape[0], 2).shape[0]   # EOF
        state = (rd.width, rd.height, rd.pixelformat, rd.dropped_frames)
        rd.close()
        results[name] = (got, rest, state, io.log,
                         all(m.closed for m in io.maps.values()))
    (got, rest, state, log, closed), (jgot, jrest, jstate, jlog, jclosed) = \
        results["port"], results["jax"]
    np.testing.assert_array_equal(got, jgot)
    assert (rest, state, log, closed) == (jrest, jstate, jlog, jclosed)
    assert state[2] == cap.V4L2_PIX_FMT_YUYV and closed
    assert cap.VIDIOC_STREAMON in log and cap.VIDIOC_STREAMOFF in log
    src = _frames(n, H=H, W=W, seed=3)
    if scenario == "gap":
        assert state[3] == 2 and got.shape[0] == 6
        assert not got[2].any() and not got[3].any()
        np.testing.assert_array_equal(got[4], src[2])
    else:
        for a, b in zip(got, src):
            np.testing.assert_array_equal(a, b)


def test_v4l2_reader_grey_fast_path():
    frames = _frames(3, seed=2)

    class GreyIO(FakeV4L2IO):
        def ioctl(self, fd, req, arg):
            if req == cap.VIDIOC_DQBUF and self.frames and self.queued:
                idx = self.queued.pop(0)
                m = self.maps[idx * self.sizeimage]
                m.buf[:] = self.frames.pop(0).tobytes()
                arg.index, arg.bytesused = idx, self.sizeimage
                arg.sequence = self.seq
                self.seq += 1
                self.log.append(req)
                return 0
            return super().ioctl(fd, req, arg)

    got = {}
    for name, mod in PACKAGES.items():
        rd = mod.V4L2Reader("/dev/video9", 48, 32,
                            io=GreyIO(list(frames), grey_ok=True))
        assert rd.pixelformat == cap.V4L2_PIX_FMT_GREY
        got[name] = rd.read_frames(0, 3)
        rd.close()
    np.testing.assert_array_equal(got["port"], np.stack(frames))
    np.testing.assert_array_equal(got["port"], got["jax"])


def _fake_probe_for(mod):
    def probe(path):
        return mod.CaptureDevice(
            path=path, card="loopback", driver="fake",
            capabilities=mod._CAP_VIDEO_CAPTURE | mod._CAP_STREAMING)
    return probe


def test_open_stream_routes_streaming_device(monkeypatch):
    frames = _frames(2, seed=4)
    monkeypatch.setattr(cap, "_probe_v4l2", _fake_probe_for(cap))
    sel = cap.CaptureSelector(
        enumerate_fn=lambda: [cap._probe_v4l2("/dev/video7")])
    sel.refresh()
    sel.select("/dev/video7")
    sel.config.width, sel.config.height = 48, 32
    rd = sel.open_stream(io=FakeV4L2IO(list(frames)))
    assert isinstance(rd, cap.V4L2Reader)
    np.testing.assert_array_equal(rd.read_frames(0, 2), np.stack(frames))
    rd.close()


def test_open_stream_gives_the_ports_stream_reader(tmp_path):
    """A path that is no streaming V4L2 node (here a y4m file standing in
    for a producer's FIFO) opens as the port's ingest.StreamReader."""
    frames = np.stack(_frames(2, seed=5))
    p = str(tmp_path / "live.y4m")
    ingest.write_y4m(p, frames)
    sel = cap.CaptureSelector(enumerate_fn=lambda: [])
    sel.config.device = p
    rd = sel.open_stream()
    try:
        assert type(rd) is ingest.StreamReader
        np.testing.assert_array_equal(rd.read_frames(0, 2), frames)
    finally:
        rd.close()


def test_capture_preview_snapshots(monkeypatch, tmp_path):
    frames = _frames(2, seed=9)
    images = {}
    for name, mod in PACKAGES.items():
        monkeypatch.setattr(mod, "_probe_v4l2", _fake_probe_for(mod))
        sel = mod.CaptureSelector(
            enumerate_fn=lambda mod=mod: [mod._probe_v4l2("/dev/video7")])
        sel.refresh()
        sel.select("/dev/video7")
        sel.config.width, sel.config.height = 48, 32
        p = str(tmp_path / f"{name}.ppm")
        assert sel.preview(p, n_frames=2,
                           io=FakeV4L2IO(list(frames))) == [p, p + ".1"]
        images[name] = [open(q, "rb").read() for q in (p, p + ".1")]
    assert images["port"] == images["jax"]
    np.testing.assert_array_equal(
        render.read_ppm(str(tmp_path / "port.ppm"))[:, :, 0], frames[0])


def test_v4l2_fed_decode_equals_file_decode(tmp_path):
    """Frames pulled through the V4L2 transport decode to the WAV of the
    same frames from a file, and to the JAX driver's."""
    p = chip_smoke.write_capture(str(tmp_path / "c.y4m"), 3, 294, seed=11)
    with ingest.open_capture(p) as fr:
        frames = list(fr.read_frames(0, 3))
    H, W = frames[0].shape
    rd = cap.V4L2Reader("/dev/video9", W, H, io=FakeV4L2IO(list(frames)))
    got = rd.read_frames(0, 3)
    rd.close()
    p2 = str(tmp_path / "v4l2.y4m")
    ingest.write_y4m(p2, got)
    kw = dict(lines_per_field=294, hyst_limit=1, shift_limit=1,
              backend="native")
    outs = []
    for src, tag in ((p, "file"), (p2, "v4l2")):
        o = str(tmp_path / f"{tag}.wav")
        tbd.BatchDecoder([(src, o)], device="cpu", **kw).run()
        outs.append(open(o, "rb").read())
    jbd.BatchDecoder([(p, str(tmp_path / "j.wav"))], **kw).run()
    assert outs[0] == outs[1] == open(tmp_path / "j.wav", "rb").read()


def _probe_table(mod, devs):
    def probe(path):
        if path in devs:
            name, caps = devs[path]
            return mod.CaptureDevice(path=path, card=name, driver="fake",
                                     capabilities=caps)
        return None
    return probe


def test_enumerate_filters_capture_capable(tmp_path):
    for k in range(2):
        (tmp_path / f"video{k}").touch()
    devs = {str(tmp_path / "video0"): ("capA", 0x1),
            str(tmp_path / "video1"): ("out-only", 0x0)}
    got = [[d.card for d in mod.enumerate_devices(
        str(tmp_path / "video*"), probe=_probe_table(mod, devs))]
        for mod in (cap, jcap)]
    assert got == [["capA"], ["capA"]]


def test_selector_flow_like_jax(tmp_path):
    d = tmp_path / "video0"
    d.touch()
    configs = []
    for mod in (cap, jcap):
        devs = {str(d): ("capA", 0x1)}
        sel = mod.CaptureSelector(lambda mod=mod, devs=devs: (
            mod.enumerate_devices(str(tmp_path / "video*"),
                                  probe=_probe_table(mod, devs))))
        with pytest.raises(ValueError):
            sel.save()
        sel.refresh()
        sel.select(0)
        sel.set_ntsc()
        sel.set_color(mod.COLOR_G)
        sel.set_offset(8, 4)
        cfg = sel.save()
        configs.append((cfg.device, cfg.width, cfg.height, cfg.fps,
                        cfg.color, cfg.offset))
        sel.set_pal()
        assert (sel.config.width, sel.config.height) == (720, 576)
        devs.clear()
        sel.refresh()
        with pytest.raises(ValueError):
            sel.save()
    assert configs[0] == configs[1] == (str(d), 720, 480, 30, cap.COLOR_G,
                                        (8, 4))


def test_selector_select_missing_and_host_without_v4l2():
    sel = cap.CaptureSelector(lambda: [])
    sel.refresh()
    with pytest.raises(ValueError, match="no capture device"):
        sel.select("/dev/video9")
    assert cap._probe_v4l2("/nonexistent/video0") is None
    assert cap.enumerate_devices() == jcap.enumerate_devices()
    assert os.path.exists("/dev/video0") or cap.enumerate_devices() == []
