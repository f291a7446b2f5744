"""Video ingest: Y4M / raw-gray readers + field splitting (VIP layer).

Replaces the reference's FFmpeg wrapper + VideoInFFMPEG
(ffmpegwrapper.{cpp,h}, vin_ffmpeg.{cpp,h}) with a TPU-batch design:
frames arrive as whole uint8 luma batches rather than per-line queue
pushes. The native C++ loader (native/loader.cpp, built on first use)
mmaps the capture and prefetches upcoming frames on a background thread —
the VIN read-ahead analog (FRAMES_READ_AHEAD_MAX=3, config.h:76-77);
`use_native=False` reads through a pure-python mmap instead.

Field splitting follows VideoInFFMPEG::spliceFrame (vin_ffmpeg.cpp:213):
field 0 = frame rows 0,2,4.. (display lines 1,3,..), field 1 = rows
1,3,5.. (lines 2,4,..); the decoder consumes frames field-sequentially.
Double-width upscaling of narrow captures (<960 px,
ffmpegwrapper.h:128-132) duplicates each pixel horizontally.

Port of sdvpcmdecoder_tpu/pipeline/ingest.py.  The native loader is the
port's own native/loader.cpp (copied from the JAX package's), built by
ops/stitch_native.build into build/native/ (a failed build raises).
"""
from __future__ import annotations

import ctypes
import mmap
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

MIN_WIDTH_FOR_SINGLE = 960  # ffmpegwrapper.h:128-132 double-width rule

_NATIVE = None
_NATIVE_LOCK = threading.Lock()


def _native_lib():
    """Build (once) and load the native loader; a failed build raises.
    Concurrent callers (the shards of parallel/multichip.py) load it
    once."""
    if _NATIVE is not None:
        return _NATIVE
    with _NATIVE_LOCK:
        return _NATIVE if _NATIVE is not None else _native_lib_locked()


def build_loader():
    """Compile native/loader.cpp (ops/stitch_native.build: once per digest,
    raises on failure); returns its Build."""
    from ..ops import stitch_native
    return stitch_native.build("loader.cpp", flag_chain=(("-O3",),),
                               libs=("-lpthread",))


def _native_lib_locked():
    global _NATIVE
    L = ctypes.CDLL(str(build_loader().path))
    L.sdv_open.restype = ctypes.c_void_p
    L.sdv_open.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
                           ctypes.c_int]
    L.sdv_width.argtypes = [ctypes.c_void_p]
    L.sdv_height.argtypes = [ctypes.c_void_p]
    L.sdv_frames.restype = ctypes.c_int64
    L.sdv_frames.argtypes = [ctypes.c_void_p]
    L.sdv_copy_frames.restype = ctypes.c_int64
    L.sdv_copy_frames.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                  ctypes.c_int64, ctypes.c_void_p]
    L.sdv_close.argtypes = [ctypes.c_void_p]
    _NATIVE = L
    return _NATIVE


class VideoReader:
    """Frame batch reader for Y4M or raw-gray captures.

    Dropped-frame handling (the DTS drop detection + dummy-frame insert
    of the reference, ffmpegwrapper.h:172-174, vin_ffmpeg.cpp:367-523):
    a `<capture>.pts` sidecar maps each STORED frame to its TIMELINE
    index (JSON list, or {"timeline": [...]}); gaps in the timeline read
    back as all-black frames, which the V2D prescan rejects so the
    decoder inserts interleave-preserving dummy frames downstream.
    Capture tools (or the FFmpegReader below) emit the sidecar from
    container timestamps.
    """

    def __init__(self, path, fmt=None, raw_size=None, use_native=True,
                 timeline=None):
        self.path = str(path)
        if fmt is None:
            fmt = "y4m" if self.path.endswith((".y4m", ".Y4M")) else "raw"
        self.fmt = fmt
        self._raw_size = raw_size
        self._h = None
        self._lib = _native_lib() if use_native else None
        if self._lib is not None:
            w, hgt = (raw_size or (0, 0))
            self._h = self._lib.sdv_open(self.path.encode(),
                                         0 if fmt == "y4m" else 1, w, hgt)
        if self._h:
            self.width = self._lib.sdv_width(self._h)
            self.height = self._lib.sdv_height(self._h)
            self.n_frames = int(self._lib.sdv_frames(self._h))
        else:
            self._open_python(raw_size)
        self._init_timeline(timeline)

    def _init_timeline(self, timeline):
        """timeline[k] = timeline index of stored frame k (sorted); None
        loads the `<path>.pts` sidecar when present."""
        self._stored_frames = self.n_frames
        self._timeline_map = None
        if timeline is None:
            sidecar = Path(self.path + ".pts")
            if sidecar.exists():
                import json
                data = json.loads(sidecar.read_text())
                timeline = data["timeline"] if isinstance(data, dict) \
                    else data
        if timeline is None:
            return
        tl = np.asarray(timeline, np.int64)
        assert len(tl) == self._stored_frames, \
            f"sidecar maps {len(tl)} frames, capture has " \
            f"{self._stored_frames}"
        if len(tl) and (tl[0] < 0 or (np.diff(tl) <= 0).any()):
            raise ValueError(
                "timeline sidecar must be non-negative and strictly "
                "increasing")
        n_timeline = int(tl[-1]) + 1 if len(tl) else 0
        # timeline position -> stored index, -1 = dropped frame
        inv = np.full(n_timeline, -1, np.int64)
        inv[tl] = np.arange(self._stored_frames)
        self._timeline_map = inv
        self.n_frames = n_timeline
        self.dropped_frames = int(n_timeline - self._stored_frames)

    # -- python fallback --------------------------------------------------
    def _open_python(self, raw_size):
        self._file = open(self.path, "rb")
        self._mm = mmap.mmap(self._file.fileno(), 0, access=mmap.ACCESS_READ)
        if self.fmt == "y4m":
            nl = self._mm.find(b"\n")
            header = self._mm[:nl].decode()
            assert header.startswith("YUV4MPEG2"), "not a Y4M file"
            w = h = 0
            cw, ch = 2, 2
            for tok in header.split()[1:]:
                if tok[0] == "W":
                    w = int(tok[1:])
                elif tok[0] == "H":
                    h = int(tok[1:])
                elif tok[0] == "C":
                    v = tok[1:]
                    if v.startswith("444"):
                        cw, ch = 1, 1
                    elif v.startswith("422"):
                        cw, ch = 2, 1
                    elif v.startswith("mono"):
                        cw, ch = 0, 0
            f0 = nl + 1
            fnl = self._mm.find(b"\n", f0)
            assert self._mm[f0:f0 + 5] == b"FRAME"
            marker = fnl - f0 + 1
            ysz = w * h
            csz = (w // cw) * (h // ch) if cw and ch else 0
            self.width, self.height = w, h
            self._data_start = f0
            self._y_offset = marker
            self._stride = marker + ysz + 2 * csz
            self.n_frames = (len(self._mm) - f0) // self._stride
        else:
            w, h = raw_size
            self.width, self.height = w, h
            self._data_start = 0
            self._y_offset = 0
            self._stride = w * h
            self.n_frames = len(self._mm) // self._stride

    def read_frames(self, first, count, out=None):
        """-> uint8 [count, H, W] luma batch (timeline view: dropped
        frames read as all-black). With `out`, a C-contiguous uint8
        [>= count, H, W] array, the frames are read into it and its
        first frames are returned (a reused buffer: every frame returned
        is written, the dropped ones black)."""
        if self._timeline_map is None:
            return self._read_stored(first, count, out)
        count = max(0, min(count, self.n_frames - first))
        out = np.zeros((count, self.height, self.width), np.uint8) \
            if out is None else self._check_out(out, count)
        if count == 0:
            return out
        stored = self._timeline_map[first:first + count]
        present = stored >= 0
        out[~present] = 0
        # contiguous runs of present frames read in one go
        k = 0
        while k < count:
            if not present[k]:
                k += 1
                continue
            j = k
            while j + 1 < count and present[j + 1] \
                    and stored[j + 1] == stored[j] + 1:
                j += 1
            self._read_stored(int(stored[k]), j - k + 1, out[k:j + 1])
            k = j + 1
        return out

    def read_frames_view(self, first, count):
        """Zero-copy [count, H, W] strided view straight off the capture
        mmap when possible, else a copy via read_frames.

        The host-backend decode path never materializes pixel batches:
        the native binarizer walks the view in place (this box copies
        memory at ~130 MB/s — one avoided 43 MB round copy is ~0.3 s).
        View rows include the Y4M FRAME marker stride; the last axis is
        contiguous, which is all stitch_native.binarize_frames needs.
        """
        if self._timeline_map is not None:
            return self.read_frames(first, count)
        count = max(0, min(count, self.n_frames - first))
        if count == 0:
            return np.zeros((0, self.height, self.width), np.uint8)
        if not hasattr(self, "_mm"):
            try:  # native prefetch loader open: mmap + header alongside
                self._open_python(self._raw_size)
            except Exception:
                return self.read_frames(first, count)
        base = np.frombuffer(self._mm, np.uint8)
        off = self._data_start + first * self._stride + self._y_offset
        return np.lib.stride_tricks.as_strided(
            base[off:], shape=(count, self.height, self.width),
            strides=(self._stride, self.width, 1), writeable=False)

    def _check_out(self, out, count):
        """out[:count], after the checks that passing its pointer to
        the native loader needs."""
        if out.dtype != np.uint8 or not out.flags.c_contiguous \
                or not out.flags.writeable \
                or out.shape[1:] != (self.height, self.width) \
                or out.shape[0] < count:
            raise ValueError(
                f"out: want a writable C-contiguous uint8 array of at least "
                f"[{count}, {self.height}, {self.width}], got "
                f"{out.dtype} {out.shape}")
        return out[:count]

    def _read_stored(self, first, count, out=None):
        count = max(0, min(count, self._stored_frames - first))
        out = np.empty((count, self.height, self.width), np.uint8) \
            if out is None else self._check_out(out, count)
        if count == 0:
            return out
        if self._h:
            got = self._lib.sdv_copy_frames(
                self._h, first, count,
                out.ctypes.data_as(ctypes.c_void_p))
            return out[:got]
        ysz = self.width * self.height
        rows = out.reshape(count, ysz)
        for i in range(count):
            off = self._data_start + (first + i) * self._stride \
                + self._y_offset
            rows[i] = np.frombuffer(self._mm, np.uint8, ysz, off)
        return out

    def close(self):
        if self._h:
            self._lib.sdv_close(self._h)
            self._h = None
        elif hasattr(self, "_mm"):
            self._mm.close()
            self._file.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


class StreamReader:
    """Sequential frame reader over a NON-SEEKABLE byte stream — FIFO,
    pipe, stdin, or a streaming capture device.  The live-ingest analog
    of the reference's capture-device path (runFrameDecode capture
    events vin_ffmpeg.cpp:817, device classes ffmpegwrapper.h:48-55):
    frames arrive as they are produced; the decoder pulls them in order
    and stops at EOF.  Y4M (header + FRAME markers) or raw gray8 with a
    known `raw_size`.

    read_frames(first, count) requires `first` to be the next unread
    timeline position (streams cannot seek); n_frames is None (unknown
    until the producer closes the stream).
    """

    dropped_frames = 0

    def __init__(self, path_or_file, fmt=None, raw_size=None):
        if hasattr(path_or_file, "read"):
            self._fh = path_or_file
            self.path = getattr(path_or_file, "name", "<stream>")
        else:
            self.path = str(path_or_file)
            self._fh = open(self.path, "rb", buffering=1 << 16)
        if fmt is None:
            fmt = "raw" if raw_size else "y4m"
        self.fmt = fmt
        self.n_frames = None
        self._pos = 0
        self._eof = False
        if fmt == "y4m":
            header = self._read_line()
            assert header.startswith(b"YUV4MPEG2"), "not a Y4M stream"
            w = h = 0
            cw, ch = 2, 2
            for tok in header.decode().split()[1:]:
                if tok[0] == "W":
                    w = int(tok[1:])
                elif tok[0] == "H":
                    h = int(tok[1:])
                elif tok[0] == "C":
                    v = tok[1:]
                    if v.startswith("444"):
                        cw, ch = 1, 1
                    elif v.startswith("422"):
                        cw, ch = 2, 1
                    elif v.startswith("mono"):
                        cw, ch = 0, 0
            self.width, self.height = w, h
            self._chroma = (w // cw) * (h // ch) if cw and ch else 0
        else:
            self.width, self.height = raw_size
            self._chroma = 0

    def _read_line(self):
        buf = bytearray()
        while True:
            b = self._fh.read(1)
            if not b:
                return bytes(buf)
            if b == b"\n":
                return bytes(buf)
            buf += b

    def _read_exact(self, n):
        buf = bytearray()
        while len(buf) < n:
            chunk = self._fh.read(n - len(buf))
            if not chunk:
                return None  # producer closed mid-frame: drop the tail
            buf += chunk
        return bytes(buf)

    def _next_frame(self):
        if self._eof:
            return None
        if self.fmt == "y4m":
            mark = self._read_line()
            if not mark.startswith(b"FRAME"):
                self._eof = True
                return None
        y = self._read_exact(self.width * self.height)
        if y is None:
            self._eof = True
            return None
        if self._chroma and self._read_exact(2 * self._chroma) is None:
            self._eof = True  # luma still usable; next read ends
        return np.frombuffer(y, np.uint8).reshape(self.height, self.width)

    def read_frames(self, first, count):
        if first != self._pos:
            raise ValueError(
                f"stream reader is at frame {self._pos}, cannot seek to "
                f"{first} (non-seekable live input)")
        frames = []
        for _ in range(count):
            f = self._next_frame()
            if f is None:
                break
            frames.append(f)
        self._pos += len(frames)
        if not frames:
            return np.zeros((0, self.height, self.width), np.uint8)
        return np.stack(frames)

    read_frames_view = read_frames

    def close(self):
        try:
            self._fh.close()
        except Exception:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def _is_stream(p):
    import stat
    if p in ("-", "pipe:", "pipe:0"):
        return True
    try:
        mode = os.stat(p).st_mode
    except OSError:
        return False
    return stat.S_ISFIFO(mode) or stat.S_ISCHR(mode)


def open_capture(path, raw_size=None, **kw):
    """Reader factory: AVI and Matroska containers decode in-process
    (pipeline/avi.py, pipeline/mkv.py — no FFmpeg needed); FIFOs /
    character devices / "-" stream through StreamReader (live ingest);
    everything else goes through VideoReader (Y4M / raw gray8 + `.pts`
    sidecar)."""
    p = str(path)
    if p.lower().endswith(".avi"):
        from .avi import AVIReader
        return AVIReader(p, raw_size=raw_size, **kw)
    if p.lower().endswith((".mkv", ".mka", ".webm")):
        from .mkv import MKVReader
        return MKVReader(p, raw_size=raw_size, **kw)
    if _is_stream(p):
        import sys
        src = sys.stdin.buffer if p in ("-", "pipe:", "pipe:0") else p
        return StreamReader(src, raw_size=raw_size)
    return VideoReader(p, raw_size=raw_size, **kw)


def split_fields(frame: np.ndarray, double_narrow=True):
    """One frame [H, W] -> field-sequential lines + display line numbers.

    Returns (lines [H, W'], line_numbers [H]); W' doubled when the source
    is narrower than 960 px (ffmpegwrapper.h:128-132).
    """
    H, W = frame.shape
    if double_narrow and W < MIN_WIDTH_FOR_SINGLE:
        frame = np.repeat(frame, 2, axis=1)
    field0 = frame[0::2]
    field1 = frame[1::2]
    lines = np.concatenate([field0, field1], axis=0)
    nums = np.concatenate([1 + 2 * np.arange(len(field0)),
                           2 + 2 * np.arange(len(field1))])
    return lines, nums


def transcode_with_ffmpeg(src, dst_y4m, ffmpeg="ffmpeg"):
    """Any FFmpeg-decodable capture -> gray Y4M + `.pts` drop sidecar.

    The reference opens arbitrary containers and detects dropped frames
    by DTS deltas (ffmpegwrapper.cpp:543 slotOpenInput, drop check
    ffmpegwrapper.h:172-174).  Without libav bindings in-process, this
    spawns the ffmpeg binary twice: once with `showinfo` to harvest per-
    frame PTS (drop detection), once to transcode luma to Y4M.  Writes
    `<dst>.pts` mapping stored frames to timeline indices so VideoReader
    re-inserts dummy frames at the gaps.

    Returns the number of detected drops. Raises FileNotFoundError when
    no ffmpeg binary is available (offline pre-transcode then applies).
    """
    import json
    import re
    import shutil
    if shutil.which(ffmpeg) is None:
        raise FileNotFoundError(
            f"{ffmpeg} not found: pre-transcode to Y4M offline or provide "
            "a .pts sidecar for drop handling")
    probe = subprocess.run(
        [ffmpeg, "-hide_banner", "-i", str(src), "-map", "0:v:0",
         "-vf", "showinfo", "-f", "null", "-"],
        capture_output=True, text=True)
    pts = [float(m.group(1)) for m in
           re.finditer(r"pts_time:\s*(-?[0-9.]+)", probe.stderr)]
    subprocess.run(
        [ffmpeg, "-hide_banner", "-y", "-i", str(src), "-map", "0:v:0",
         "-pix_fmt", "gray", "-f", "yuv4mpegpipe", str(dst_y4m)],
        check=True, capture_output=True)
    drops = 0
    if len(pts) > 2:
        deltas = np.diff(pts)
        step = float(np.median(deltas))
        if step > 0:
            # timeline index of each stored frame by rounded PTS/step
            timeline = np.round((np.asarray(pts) - pts[0]) / step)
            timeline = np.maximum.accumulate(
                timeline.astype(np.int64))  # monotonic guard
            # ensure strictly increasing (duplicate PTS collapse to +1)
            for i in range(1, len(timeline)):
                if timeline[i] <= timeline[i - 1]:
                    timeline[i] = timeline[i - 1] + 1
            drops = int(timeline[-1] + 1 - len(timeline))
            if drops > 0:
                Path(str(dst_y4m) + ".pts").write_text(
                    json.dumps({"timeline": timeline.tolist()}))
    return drops


def split_fields_batch(frames: np.ndarray, double_narrow=True):
    """split_fields over a whole frame batch [F, H, W] in one pass.

    Returns (lines [F, H, W'], line_numbers [H])."""
    F, H, W = frames.shape
    if double_narrow and W < MIN_WIDTH_FOR_SINGLE:
        frames = np.repeat(frames, 2, axis=2)
    lines = np.concatenate([frames[:, 0::2], frames[:, 1::2]], axis=1)
    nums = np.concatenate([1 + 2 * np.arange((H + 1) // 2),
                           2 + 2 * np.arange(H // 2)])
    return lines, nums


def field_perm(H: int):
    """Field-sequential order as a ROW PERMUTATION of a raw frame.

    split_fields_batch materializes lines[F, H, W] = frames[:, perm, :];
    the host decode path instead keeps the raw mmap view and reorders the
    (small) decoded outputs with this map.  Returns (perm [H], display
    line numbers [H]) matching split_fields exactly.
    """
    perm = np.concatenate([np.arange(0, H, 2), np.arange(1, H, 2)])
    nums = np.concatenate([1 + 2 * np.arange((H + 1) // 2),
                           2 + 2 * np.arange(H // 2)])
    return perm, nums


def write_y4m(path, frames: np.ndarray, chroma="mono"):
    """Test helper: write grayscale frames [F, H, W] as Y4M."""
    F, H, W = frames.shape
    with open(path, "wb") as fh:
        fh.write(f"YUV4MPEG2 W{W} H{H} F25:1 Ip A1:1 C{chroma}\n"
                 .encode())
        if chroma == "mono":
            for f in range(F):
                fh.write(b"FRAME\n")
                fh.write(frames[f].tobytes())
        else:
            cw = 2
            u = np.full((H // 2, W // 2), 128, np.uint8)
            for f in range(F):
                fh.write(b"FRAME\n")
                fh.write(frames[f].tobytes())
                fh.write(u.tobytes())
                fh.write(u.tobytes())
