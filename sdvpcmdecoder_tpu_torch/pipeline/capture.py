"""Capture device selection — the capt_sel analog (capt_sel.{h,cpp}).

The reference's capture dialog lists video capture devices (through its
FFmpeg wrapper), lets the user pick one plus a video preset (PAL/NTSC
dimensions, frame rate, color channel for luma extraction, dropped-frame
detection) and hands the resulting configuration to the ingest layer
(capt_sel.h:118-126 request* signals).  Headless analog:

  * `enumerate_devices()` — V4L2 capture devices via ctypes ioctl
    VIDIOC_QUERYCAP on /dev/video* (no Qt, no FFmpeg); returns [] on
    hosts without V4L2 (this bench box).
  * `CaptureConfig` — the saved selection: device, dimensions, fps,
    color channel, drop detection, capture offset.
  * `CaptureSelector` — refresh/select/preset/save state machine
    mirroring the dialog's slots (usrRefresh/selectDevice/usrSetPAL/
    usrSetNTSC/usrSave).

Probing is injectable so selection logic is testable without hardware.

Carried over from sdvpcmdecoder_tpu/pipeline/capture.py (ctypes, no
torch); `CaptureSelector.open_stream` returns the port's readers.
"""
from __future__ import annotations

import ctypes
import fcntl
import glob
import os
from dataclasses import dataclass, field

# Video presets (capt_sel.cpp usrSetPAL/usrSetNTSC; the reference
# captures full-frame interlaced video for the PCM decoder).
PAL_PRESET = dict(width=720, height=576, fps=25)
NTSC_PRESET = dict(width=720, height=480, fps=30)

# Color channel for luma extraction (LIST_COLORS_ALL..LIST_COLOR_B,
# capt_sel.h:66-72): PCM bits ride the luma, but some capture chains
# carry cleaner data in one RGB channel.
COLORS_ALL, COLOR_R, COLOR_G, COLOR_B = range(4)

_CAP_VIDEO_CAPTURE = 0x00000001

# Linux _IOC encoding (include/uapi/asm-generic/ioctl.h): computing the
# numbers from the live ctypes struct sizes keeps them correct on any
# ABI (32-bit hosts have 4-byte c_long, shrinking v4l2_buffer) instead
# of hard-coding the x86-64 values.
_IOC_WRITE, _IOC_READ = 1, 2


def _ioc(direction, nr, arg_type):
    return ((direction << 30) | (ctypes.sizeof(arg_type) << 16)
            | (ord("V") << 8) | nr)


class _V4L2Capability(ctypes.Structure):
    _fields_ = [("driver", ctypes.c_char * 16),
                ("card", ctypes.c_char * 32),
                ("bus_info", ctypes.c_char * 32),
                ("version", ctypes.c_uint32),
                ("capabilities", ctypes.c_uint32),
                ("device_caps", ctypes.c_uint32),
                ("reserved", ctypes.c_uint32 * 3)]


_VIDIOC_QUERYCAP = _ioc(_IOC_READ, 0, _V4L2Capability)


@dataclass
class CaptureDevice:
    path: str
    card: str = ""
    driver: str = ""
    capabilities: int = 0

    @property
    def can_capture(self):
        return bool(self.capabilities & _CAP_VIDEO_CAPTURE)

    @property
    def can_stream(self):
        return self.can_capture and bool(self.capabilities
                                         & _CAP_STREAMING)


@dataclass
class CaptureConfig:
    """The saved selection handed to the ingest layer (the dialog's
    request* signal payloads)."""
    device: str = ""
    width: int = PAL_PRESET["width"]
    height: int = PAL_PRESET["height"]
    fps: int = PAL_PRESET["fps"]
    color: int = COLORS_ALL
    drop_detect: bool = True
    offset: tuple = (0, 0)


def _is_chardev_or_unknown(path):
    """True when `path` is a character device (the only thing V4L2
    nodes ever are) or cannot be stat'ed; False for FIFOs/regular
    files, which must never be transiently opened by a probe."""
    import stat
    try:
        st = os.stat(path)
    except OSError:
        return True
    return stat.S_ISCHR(st.st_mode)


def _probe_v4l2(path):
    """VIDIOC_QUERYCAP one device node; None when not a V4L2 device."""
    cap = _V4L2Capability()
    try:
        fd = os.open(path, os.O_RDWR | os.O_NONBLOCK)
    except OSError:
        return None
    try:
        fcntl.ioctl(fd, _VIDIOC_QUERYCAP, cap)
    except OSError:
        return None
    finally:
        os.close(fd)
    return CaptureDevice(path=path,
                         card=cap.card.decode(errors="replace"),
                         driver=cap.driver.decode(errors="replace"),
                         capabilities=int(cap.device_caps
                                          or cap.capabilities))


def enumerate_devices(dev_glob="/dev/video*", probe=_probe_v4l2):
    """List V4L2 capture-capable devices (requestDeviceList analog).

    `probe` is injectable for tests; returns CaptureDevice list sorted
    by node path, capture-capable nodes only."""
    out = []
    for path in sorted(glob.glob(dev_glob)):
        dev = probe(path)
        if dev is not None and dev.can_capture:
            out.append(dev)
    return out


class CaptureSelector:
    """The dialog's selection state machine, headless."""

    def __init__(self, enumerate_fn=enumerate_devices):
        self._enumerate = enumerate_fn
        self.devices: list[CaptureDevice] = []
        self.config = CaptureConfig()

    def refresh(self):
        """usrRefresh: re-list devices; keeps the selection when the
        device is still present, else clears it."""
        self.devices = self._enumerate()
        if self.config.device and not any(
                d.path == self.config.device for d in self.devices):
            self.config.device = ""
        return self.devices

    def select(self, path_or_index):
        """selectDevice by node path or list index."""
        if isinstance(path_or_index, int):
            dev = self.devices[path_or_index]
        else:
            matches = [d for d in self.devices
                       if d.path == path_or_index]
            if not matches:
                raise ValueError(
                    f"no capture device {path_or_index!r} "
                    f"(have {[d.path for d in self.devices]})")
            dev = matches[0]
        self.config.device = dev.path
        return dev

    def set_pal(self):
        self.config.width = PAL_PRESET["width"]
        self.config.height = PAL_PRESET["height"]
        self.config.fps = PAL_PRESET["fps"]

    def set_ntsc(self):
        self.config.width = NTSC_PRESET["width"]
        self.config.height = NTSC_PRESET["height"]
        self.config.fps = NTSC_PRESET["fps"]

    def set_color(self, channel):
        assert channel in (COLORS_ALL, COLOR_R, COLOR_G, COLOR_B)
        self.config.color = channel

    def set_drop_detect(self, enabled):
        self.config.drop_detect = bool(enabled)

    def set_offset(self, x, y):
        self.config.offset = (int(x), int(y))

    def save(self):
        """usrSave: validate and return the selection."""
        if not self.config.device:
            raise ValueError("no capture device selected")
        return self.config

    def preview(self, path, n_frames=1, io=None):
        """Headless analog of the dialog's live preview pane
        (capt_sel.h:46): pull `n_frames` frames from the saved selection
        and write them as PPM snapshots next to `path` (frame 0 at
        `path`, further frames suffixed).  Returns the written paths."""
        from . import render
        import numpy as np
        rd = self.open_stream(io=io)
        try:
            frames = rd.read_frames(0, n_frames)
        finally:
            rd.close()
        out = []
        for k, f in enumerate(frames):
            p = path if k == 0 else f"{path}.{k}"
            render.write_ppm(p, np.repeat(f[:, :, None], 3, axis=2))
            out.append(p)
        return out

    def open_stream(self, io=None):
        """Open the saved selection as a live frame stream feeding the
        decode pipeline (the reference's capture start: capt_sel accept
        -> VIP runFrameDecode capture events, vin_ffmpeg.cpp:817).

        A V4L2 device node that advertises mmap streaming gets the real
        REQBUFS/QBUF/STREAMON transport (V4L2Reader — what actual
        UVC/capture hardware requires); everything else (FIFOs, Y4M
        producers, read()-mode chardevs) streams sequentially through
        ingest.StreamReader."""
        from . import ingest
        cfg = self.save()
        # Probe only character devices: a QUERYCAP probe transiently
        # opens/closes the path, and on a FIFO that wakes the producer
        # blocked in open(O_WRONLY) into a zero-reader window (its next
        # write would SIGPIPE).  Missing/unstatable paths stay
        # probe-eligible for injected test probes.
        dev = None
        if _is_chardev_or_unknown(cfg.device):
            dev = _probe_v4l2(cfg.device)
        if dev is not None and dev.can_stream:
            return V4L2Reader(cfg.device, cfg.width, cfg.height, io=io)
        is_y4m = cfg.device.endswith((".y4m", ".Y4M"))
        # Opening a FIFO for read blocks until the producer connects —
        # that IS live behavior (the reference's VIP waits in LOADING
        # until frames arrive, vin_ffmpeg.h:92-103).
        return ingest.StreamReader(
            cfg.device,
            raw_size=None if is_y4m else (cfg.width, cfg.height))


# ---------------------------------------------------------------------------
# V4L2 mmap streaming (VIDIOC_REQBUFS/QBUF/STREAMON) — the transport
# virtually all real UVC/capture hardware requires (the reference opens
# devices through FFmpeg's v4l2 input, ffmpegwrapper.h:48-55; this is
# the in-process equivalent).  ioctl numbers are computed from the live
# struct sizes via _ioc (x86-64: v4l2_format=208, v4l2_buffer=88,
# v4l2_requestbuffers=20).
# ---------------------------------------------------------------------------
_CAP_STREAMING = 0x04000000
V4L2_BUF_TYPE_VIDEO_CAPTURE = 1
V4L2_MEMORY_MMAP = 1
V4L2_PIX_FMT_GREY = 0x59455247   # 'GREY' 8-bit luma
V4L2_PIX_FMT_YUYV = 0x56595559   # 'YUYV' packed 4:2:2

_u8, _u32 = ctypes.c_uint8, ctypes.c_uint32


class _V4L2PixFormat(ctypes.Structure):
    _fields_ = [("width", _u32), ("height", _u32),
                ("pixelformat", _u32), ("field", _u32),
                ("bytesperline", _u32), ("sizeimage", _u32),
                ("colorspace", _u32), ("priv", _u32), ("flags", _u32),
                ("ycbcr_enc", _u32), ("quantization", _u32),
                ("xfer_func", _u32)]


class _V4L2FmtUnion(ctypes.Union):
    _fields_ = [("pix", _V4L2PixFormat), ("raw", _u8 * 200)]


# The kernel's v4l2_format union contains pointers (v4l2_window), so
# its offset is pointer-aligned: 8 on 64-bit (one u32 pad after
# `type`), 4 on 32-bit (no pad) — sizeof then matches the kernel's and
# the computed VIDIOC_S_FMT ioctl number is right on both ABIs.
if ctypes.sizeof(ctypes.c_void_p) == 8:
    class _V4L2Format(ctypes.Structure):
        _fields_ = [("type", _u32), ("_pad", _u32),
                    ("fmt", _V4L2FmtUnion)]
else:
    class _V4L2Format(ctypes.Structure):
        _fields_ = [("type", _u32), ("fmt", _V4L2FmtUnion)]


class _V4L2RequestBuffers(ctypes.Structure):
    _fields_ = [("count", _u32), ("type", _u32), ("memory", _u32),
                ("capabilities", _u32), ("reserved", _u32)]


class _V4L2Timecode(ctypes.Structure):
    _fields_ = [("type", _u32), ("flags", _u32), ("frames", _u8),
                ("seconds", _u8), ("minutes", _u8), ("hours", _u8),
                ("userbits", _u8 * 4)]


class _V4L2BufM(ctypes.Union):
    _fields_ = [("offset", _u32), ("userptr", ctypes.c_ulong),
                ("fd", ctypes.c_int32)]


class _V4L2Buffer(ctypes.Structure):
    # c_long timestamp members force the same 8-byte alignment the
    # kernel's struct timeval gives (sizeof == 88 on x86-64).
    _fields_ = [("index", _u32), ("type", _u32), ("bytesused", _u32),
                ("flags", _u32), ("field", _u32),
                ("tv_sec", ctypes.c_long), ("tv_usec", ctypes.c_long),
                ("timecode", _V4L2Timecode), ("sequence", _u32),
                ("memory", _u32), ("m", _V4L2BufM), ("length", _u32),
                ("reserved2", _u32), ("request_fd", _u32)]


VIDIOC_S_FMT = _ioc(_IOC_READ | _IOC_WRITE, 5, _V4L2Format)
VIDIOC_REQBUFS = _ioc(_IOC_READ | _IOC_WRITE, 8, _V4L2RequestBuffers)
VIDIOC_QUERYBUF = _ioc(_IOC_READ | _IOC_WRITE, 9, _V4L2Buffer)
VIDIOC_QBUF = _ioc(_IOC_READ | _IOC_WRITE, 15, _V4L2Buffer)
VIDIOC_DQBUF = _ioc(_IOC_READ | _IOC_WRITE, 17, _V4L2Buffer)
VIDIOC_STREAMON = _ioc(_IOC_WRITE, 18, ctypes.c_int)
VIDIOC_STREAMOFF = _ioc(_IOC_WRITE, 19, ctypes.c_int)


class _RealV4L2IO:
    """The syscall surface V4L2Reader drives — injectable so the
    streaming state machine is testable without /dev/video hardware."""

    def open(self, path):
        return os.open(path, os.O_RDWR)

    def ioctl(self, fd, req, arg):
        return fcntl.ioctl(fd, req, arg)

    def mmap(self, fd, length, offset):
        import mmap
        return mmap.mmap(fd, length, flags=mmap.MAP_SHARED,
                         prot=mmap.PROT_READ, offset=offset)

    def wait_readable(self, fd, timeout):
        import select
        r, _, _ = select.select([fd], [], [], timeout)
        return bool(r)

    def close(self, fd):
        os.close(fd)


class V4L2Reader:
    """mmap-streaming V4L2 capture reader (ingest reader contract:
    `width`/`height`, `n_frames` None, sequential `read_frames`,
    `dropped_frames`, `close`).

    Negotiates GREY (8-bit luma straight off the wire) and falls back
    to YUYV (every UVC device; luma = even bytes); REQBUFS `n_buffers`
    mmap buffers, queues them all, STREAMON, then DQBUF -> copy luma ->
    re-QBUF per frame.  Driver `sequence` gaps insert black dummy
    frames so the PCM interleave phase survives capture drops (the
    reference's insertDummyFrame, vin_ffmpeg.cpp:367)."""

    def __init__(self, path, width, height, n_buffers=4, io=None,
                 timeout=10.0):
        import numpy as np
        self._np = np
        self._io = io or _RealV4L2IO()
        self.path = path
        self.n_frames = None
        self.dropped_frames = 0
        self._timeout = timeout
        self._pos = 0
        self._eof = False
        self._last_seq = None
        self._pending_dups = 0
        self._held = None
        self.fd = self._io.open(path)
        self._maps = []
        # Any failure past the open must release the fd and partial
        # mmaps — __init__ raising leaves no object for close() to run
        # on, and repeated open retries would otherwise pile up held
        # /dev/video fds (e.g. EBUSY from REQBUFS while another process
        # streams).
        try:
            self._negotiate_and_stream(path, width, height, n_buffers)
        except BaseException:
            for m in self._maps:
                try:
                    m.close()
                except (OSError, ValueError):
                    pass
            self._io.close(self.fd)
            self.fd = None
            raise

    def _negotiate_and_stream(self, path, width, height, n_buffers):
        fmt = _V4L2Format()
        negotiated = None
        for pf in (V4L2_PIX_FMT_GREY, V4L2_PIX_FMT_YUYV):
            ctypes.memset(ctypes.byref(fmt), 0, ctypes.sizeof(fmt))
            fmt.type = V4L2_BUF_TYPE_VIDEO_CAPTURE
            fmt.fmt.pix.width = width
            fmt.fmt.pix.height = height
            fmt.fmt.pix.pixelformat = pf
            try:
                self._io.ioctl(self.fd, VIDIOC_S_FMT, fmt)
            except OSError:
                continue
            if fmt.fmt.pix.pixelformat == pf:
                negotiated = pf
                break
        if negotiated is None:
            raise OSError(f"{path}: no GREY/YUYV format accepted")
        self.pixelformat = negotiated
        # The driver may adjust dimensions; believe what it returns.
        self.width = int(fmt.fmt.pix.width)
        self.height = int(fmt.fmt.pix.height)
        self._bpl = int(fmt.fmt.pix.bytesperline) or (
            self.width * (1 if negotiated == V4L2_PIX_FMT_GREY else 2))
        req = _V4L2RequestBuffers()
        req.count = n_buffers
        req.type = V4L2_BUF_TYPE_VIDEO_CAPTURE
        req.memory = V4L2_MEMORY_MMAP
        self._io.ioctl(self.fd, VIDIOC_REQBUFS, req)
        if req.count < 1:
            raise OSError(f"{path}: REQBUFS granted no buffers")
        for i in range(int(req.count)):
            buf = _V4L2Buffer()
            buf.index = i
            buf.type = V4L2_BUF_TYPE_VIDEO_CAPTURE
            buf.memory = V4L2_MEMORY_MMAP
            self._io.ioctl(self.fd, VIDIOC_QUERYBUF, buf)
            self._maps.append(self._io.mmap(self.fd, int(buf.length),
                                            int(buf.m.offset)))
            self._io.ioctl(self.fd, VIDIOC_QBUF, buf)
        self._io.ioctl(self.fd, VIDIOC_STREAMON,
                       ctypes.c_int(V4L2_BUF_TYPE_VIDEO_CAPTURE))

    def _to_luma(self, raw):
        np = self._np
        H, W, bpl = self.height, self.width, self._bpl
        if self.pixelformat == V4L2_PIX_FMT_GREY:
            rows = np.frombuffer(raw, np.uint8,
                                 count=bpl * H).reshape(H, bpl)
            return np.ascontiguousarray(rows[:, :W])
        rows = np.frombuffer(raw, np.uint8,
                             count=bpl * H).reshape(H, bpl)
        return np.ascontiguousarray(rows[:, 0:2 * W:2])

    def _next_frame(self):
        """One frame of luma, or None at EOF/timeout; black dummies
        stand in for driver-reported drops (sequence gaps), BEFORE the
        frame that followed the gap."""
        np = self._np
        if self._pending_dups > 0:
            self._pending_dups -= 1
            self.dropped_frames += 1
            return np.zeros((self.height, self.width), np.uint8)
        if self._held is not None:
            frame, self._held = self._held, None
            return frame
        if self._eof:
            return None
        if not self._io.wait_readable(self.fd, self._timeout):
            self._eof = True
            return None
        buf = _V4L2Buffer()
        buf.type = V4L2_BUF_TYPE_VIDEO_CAPTURE
        buf.memory = V4L2_MEMORY_MMAP
        try:
            self._io.ioctl(self.fd, VIDIOC_DQBUF, buf)
        except OSError:
            self._eof = True
            return None
        seq = int(buf.sequence)
        gap = seq - self._last_seq - 1 if self._last_seq is not None \
            else 0
        self._last_seq = seq
        m = self._maps[int(buf.index)]
        m.seek(0)
        frame = self._to_luma(m.read(int(buf.bytesused) or len(m)))
        self._io.ioctl(self.fd, VIDIOC_QBUF, buf)
        if gap > 0:
            # The dropped frames precede this one in the timeline.
            self._pending_dups = gap - 1
            self._held = frame
            self.dropped_frames += 1
            return np.zeros((self.height, self.width), np.uint8)
        return frame

    def read_frames(self, first, count):
        np = self._np
        assert first == self._pos, \
            f"stream reader is sequential (at {self._pos}, asked {first})"
        out = []
        for _ in range(count):
            f = self._next_frame()
            if f is None:
                break
            out.append(f)
        self._pos += len(out)
        if not out:
            return np.zeros((0, self.height, self.width), np.uint8)
        return np.stack(out)

    def read_frames_view(self, first, count):
        return self.read_frames(first, count)

    def close(self):
        if self.fd is None:
            return
        try:
            self._io.ioctl(self.fd, VIDIOC_STREAMOFF,
                           ctypes.c_int(V4L2_BUF_TYPE_VIDEO_CAPTURE))
        except OSError:
            pass
        for m in self._maps:
            try:
                m.close()
            except (OSError, ValueError):
                pass
        self._io.close(self.fd)
        self.fd = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
