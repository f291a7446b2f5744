"""In-process Matroska (MKV) container ingest — no FFmpeg required.

FFV1 archival captures overwhelmingly ship in Matroska (the
preservation community's standard pairing), and VirtualDub2-era
lossless captures appear as VfW codecs in MKV too.  The reference
opens them through libav (ffmpegwrapper.cpp:543 slotOpenInput); this
module parses EBML directly and reuses `pipeline/avi.py`'s codec
dispatch, so every in-process codec (FFV1, HuffYUV, Lagarith, Ut
Video, MJPG, raw) decodes from MKV exactly as from AVI:

  * `V_FFV1`            — CodecPrivate is the FFV1 extradata verbatim
  * `V_MS/VFW/FOURCC`   — CodecPrivate is a BITMAPINFOHEADER (+codec
                          extradata), i.e. the AVI strf payload: the
                          fourcc routes through the same decoders
  * `V_UNCOMPRESSED`    — raw luma (Y800-style)

Block timestamps map to timeline slots via TrackEntry's
DefaultDuration (falling back to the median block delta), so dropped
frames — missing timestamps — surface as black timeline slots exactly
like zero-length AVI idx1 entries and the `.pts` sidecar gaps
(ffmpegwrapper.h:172-174 DTS drop detection).

Scope: one video track (the first), no lacing (lossless video blocks
are never laced in practice), SimpleBlock/BlockGroup clusters,
unknown-size Segment/Cluster elements (live-remuxed files).
`MKVReader` subclasses `AVIReader`, overriding only the container
parse — the decode methods, frame-parallel native batch paths and the
FFV1 sequential-rewind logic are shared.

Carried over from sdvpcmdecoder_tpu/pipeline/mkv.py (numpy).
"""
from __future__ import annotations

import struct

import numpy as np

from .avi import AVIError, AVIReader

# EBML element IDs (with their length-descriptor bytes included)
_EBML_HEADER = 0x1A45DFA3
_SEGMENT = 0x18538067
_INFO = 0x1549A966
_TIMESTAMP_SCALE = 0x2AD7B1
_TRACKS = 0x1654AE6B
_TRACK_ENTRY = 0xAE
_TRACK_NUMBER = 0xD7
_TRACK_TYPE = 0x83
_CODEC_ID = 0x86
_CODEC_PRIVATE = 0x63A2
_DEFAULT_DURATION = 0x23E383
_VIDEO = 0xE0
_PIXEL_WIDTH = 0xB0
_PIXEL_HEIGHT = 0xBA
_CLUSTER = 0x1F43B675
_CLUSTER_TS = 0xE7
_SIMPLE_BLOCK = 0xA3
_BLOCK_GROUP = 0xA0
_BLOCK = 0xA1
_LEVEL1 = {_INFO, _TRACKS, _CLUSTER, 0x114D9B74, 0x1C53BB6B, 0x1941A469,
           0x1043A770, 0x1254C367}   # SeekHead, Cues, Attachments, ...


class MKVError(AVIError):
    pass


def _read_id(mm, off, end):
    """EBML ID: leading-zero count of the first byte gives the length;
    the ID value keeps the marker bits (matroska convention)."""
    if off >= end:
        return None, off
    b0 = mm[off]
    if b0 == 0:
        raise MKVError("MKV: invalid EBML ID")
    n = 8 - b0.bit_length() + 1
    if n > 4 or off + n > end:
        raise MKVError("MKV: truncated EBML ID")
    v = 0
    for i in range(n):
        v = (v << 8) | mm[off + i]
    return v, off + n


def _read_size(mm, off, end):
    """EBML size varint -> (value or None for unknown-size, next off)."""
    if off >= end:
        raise MKVError("MKV: truncated EBML size")
    b0 = mm[off]
    if b0 == 0:
        raise MKVError("MKV: invalid EBML size")
    n = 8 - b0.bit_length() + 1
    if off + n > end:
        raise MKVError("MKV: truncated EBML size")
    v = b0 & (0xFF >> n)
    all_ones = v == (0xFF >> n)
    for i in range(1, n):
        v = (v << 8) | mm[off + i]
        all_ones = all_ones and mm[off + i] == 0xFF
    return (None if all_ones else v), off + n


def _uint(mm, off, size):
    v = 0
    for i in range(size):
        v = (v << 8) | mm[off + i]
    return v


def _ebml_id(eid):
    n = (eid.bit_length() + 7) // 8
    return eid.to_bytes(n, "big")


def _ebml_size(v):
    for n in range(1, 9):
        if v < (1 << (7 * n)) - 1:
            return ((1 << (7 * n)) | v).to_bytes(n, "big")
    raise MKVError("MKV: size too large")


def _el(eid, payload):
    return _ebml_id(eid) + _ebml_size(len(payload)) + payload


def _el_uint(eid, v):
    n = max(1, (v.bit_length() + 7) // 8)
    return _el(eid, v.to_bytes(n, "big"))


def write_mkv(path, frames, codec="FFV1", fps=25, drops=None,
              payloads=None, extradata=None):
    """Test/debug Matroska writer (the MKV twin of avi.write_avi).

    codec: FFV1 (CodecPrivate = extradata) or any of write_avi's VfW
    codecs wrapped as V_MS/VFW/FOURCC.  drops: timeline slot indices
    that get NO block (a timestamp gap — the MKV expression of a
    dropped frame)."""
    from .avi import resolve_payloads
    frames = np.asarray(frames, np.uint8)
    F, H, W = frames.shape
    drops = sorted(set(drops or []))
    if payloads is None and codec == "Y800":
        payloads = [f.tobytes() for f in frames]
    elif codec != "Y800":
        payloads, extradata = resolve_payloads(frames, codec, payloads,
                                               extradata)
    extradata = extradata or b""
    if codec == "FFV1":
        codec_id = b"V_FFV1"
        private = extradata
    elif codec == "Y800":
        codec_id = b"V_UNCOMPRESSED"
        private = b""
    else:
        codec_id = b"V_MS/VFW/FOURCC"
        bitcount = {"HFYU": 16, "ULY0": 12, "ULY2": 16, "LAGS": 12}[codec]
        private = struct.pack("<IiiHH4sIiiII", 40 + len(extradata), W, H,
                              1, bitcount, codec.encode(), W * H,
                              0, 0, 0, 0) + extradata
    ns_per_frame = int(round(1e9 / fps))
    ts_scale = 1_000_000
    track = (_el_uint(_TRACK_NUMBER, 1)
             + _el_uint(_TRACK_TYPE, 1)
             + _el(_CODEC_ID, codec_id)
             + (_el(_CODEC_PRIVATE, private) if private else b"")
             + _el_uint(_DEFAULT_DURATION, ns_per_frame)
             + _el(_VIDEO, _el_uint(_PIXEL_WIDTH, W)
                   + _el_uint(_PIXEL_HEIGHT, H)))
    body = (_el(_INFO, _el_uint(_TIMESTAMP_SCALE, ts_scale))
            + _el(_TRACKS, _el(_TRACK_ENTRY, track)))
    di = set(drops)
    stored = 0
    slot = 0
    blocks = b""
    n_slots = F + len(drops)
    for slot in range(n_slots):
        if slot in di:
            continue
        ts = slot * ns_per_frame // ts_scale
        sb = bytes([0x81]) + struct.pack(">h", 0) + bytes([0x80]) \
            + bytes(payloads[stored])
        blocks += _el(_CLUSTER,
                      _el_uint(_CLUSTER_TS, ts) + _el(_SIMPLE_BLOCK, sb))
        stored += 1
    body += blocks
    ebml = _el(_EBML_HEADER,
               _el_uint(0x4286, 1) + _el_uint(0x42F7, 1)
               + _el_uint(0x42F2, 4) + _el_uint(0x42F3, 8)
               + _el(0x4282, b"matroska")
               + _el_uint(0x4287, 4) + _el_uint(0x4285, 2))
    with open(path, "wb") as f:
        f.write(ebml + _el(_SEGMENT, body))


class MKVReader(AVIReader):
    """Frame batch reader for Matroska captures (VideoReader
    interface; codec dispatch shared with AVIReader)."""

    # -- container parse ----------------------------------------------------
    def _parse(self):
        mm = self._mm
        n = len(mm)
        eid, off = _read_id(mm, 0, n)
        if eid != _EBML_HEADER:
            raise MKVError(f"{self.path!r} is not a Matroska file")
        size, off = _read_size(mm, off, n)
        off += size if size is not None else 0
        self._entries = []
        self._timeline = []
        self.width = self.height = 0
        self._compression = b"\x00\x00\x00\x00"
        self._bitcount = 8
        self._extradata = b""
        self._ts_scale = 1_000_000          # ns per timestamp unit
        self._default_dur = 0               # ns per frame (0 = unknown)
        self._track_no = None
        self._block_ts = []                 # abs ts (scale units)
        while off < n:
            eid, off2 = _read_id(mm, off, n)
            if eid is None:
                break
            size, body = _read_size(mm, off2, n)
            end = n if size is None else min(body + size, n)
            if eid == _SEGMENT:
                self._walk_segment(body, end)
            off = end if eid == _SEGMENT else \
                (body + size if size is not None else n)
        if self.width == 0 or self.height == 0 or self._track_no is None:
            raise MKVError(f"{self.path!r}: no video track found")
        self._build_timeline()           # also runs _finish_timeline
        self._init_codec()

    def _walk_segment(self, start, end):
        mm = self._mm
        off = start
        while off < end:
            eid, off2 = _read_id(mm, off, end)
            if eid is None:
                break
            size, body = _read_size(mm, off2, end)
            if size is None:                # unknown-size cluster etc.
                nxt = self._walk_unknown(eid, body, end)
                off = nxt
                continue
            if eid == _INFO:
                self._walk_info(body, body + size)
            elif eid == _TRACKS:
                self._walk_tracks(body, body + size)
            elif eid == _CLUSTER:
                self._walk_cluster(body, body + size)
            off = body + size

    def _walk_unknown(self, eid, body, end):
        """Unknown-size element: children parse until a level-1 ID."""
        if eid == _CLUSTER:
            return self._walk_cluster(body, end, stop_level1=True)
        if eid == _SEGMENT:
            self._walk_segment(body, end)
            return end
        return end

    def _walk_info(self, start, end):
        mm = self._mm
        off = start
        while off < end:
            eid, off2 = _read_id(mm, off, end)
            if eid is None:
                break
            size, body = _read_size(mm, off2, end)
            if size is None:
                break
            if eid == _TIMESTAMP_SCALE:
                self._ts_scale = _uint(mm, body, size)
            off = body + size

    def _walk_tracks(self, start, end):
        mm = self._mm
        off = start
        while off < end:
            eid, off2 = _read_id(mm, off, end)
            if eid is None:
                break
            size, body = _read_size(mm, off2, end)
            if size is None:
                break
            if eid == _TRACK_ENTRY:
                self._parse_track(body, body + size)
            off = body + size

    def _parse_track(self, start, end):
        if self._track_no is not None:      # first video track only
            return
        mm = self._mm
        off = start
        num = None
        ttype = None
        codec_id = b""
        codec_priv = b""
        default_dur = 0
        W = H = 0
        while off < end:
            eid, off2 = _read_id(mm, off, end)
            if eid is None:
                break
            size, body = _read_size(mm, off2, end)
            if size is None:
                break
            if eid == _TRACK_NUMBER:
                num = _uint(mm, body, size)
            elif eid == _TRACK_TYPE:
                ttype = _uint(mm, body, size)
            elif eid == _CODEC_ID:
                codec_id = bytes(mm[body:body + size]).rstrip(b"\x00")
            elif eid == _CODEC_PRIVATE:
                codec_priv = bytes(mm[body:body + size])
            elif eid == _DEFAULT_DURATION:
                default_dur = _uint(mm, body, size)
            elif eid == _VIDEO:
                o = body
                vend = body + size
                while o < vend:
                    vid, o2 = _read_id(mm, o, vend)
                    if vid is None:
                        break
                    vsize, vbody = _read_size(mm, o2, vend)
                    if vsize is None:
                        break
                    if vid == _PIXEL_WIDTH:
                        W = _uint(mm, vbody, vsize)
                    elif vid == _PIXEL_HEIGHT:
                        H = _uint(mm, vbody, vsize)
                    o = vbody + vsize
            off = body + size
        if ttype != 1 or num is None:       # not a video track
            return
        self._track_no = num
        self.width, self.height = W, H
        self._default_dur = default_dur
        self._bmp_height = -abs(H)          # top-down (no DIB flip)
        if codec_id == b"V_FFV1":
            self._compression = b"FFV1"
            self._extradata = codec_priv
        elif codec_id == b"V_MS/VFW/FOURCC":
            if len(codec_priv) < 40:
                raise MKVError("MKV: truncated VfW codec private")
            # CodecPrivate IS the AVI strf BITMAPINFOHEADER payload
            self._bitcount = struct.unpack_from("<H", codec_priv, 14)[0]
            comp = struct.unpack_from("<I", codec_priv, 16)[0]
            self._compression = codec_priv[16:20] if comp \
                else b"\x00\x00\x00\x00"
            self._bmp_height = struct.unpack_from("<i", codec_priv, 8)[0]
            self._extradata = codec_priv[40:]
        elif codec_id in (b"V_UNCOMPRESSED", b"V_GRAY8"):
            self._compression = b"Y800"
        else:
            raise MKVError(
                f"unsupported MKV codec {codec_id!r}: pre-transcode "
                "with `ffmpeg -i cap.mkv -pix_fmt gray out.y4m` or "
                "remux to a supported codec")

    def _walk_cluster(self, start, end, stop_level1=False):
        mm = self._mm
        off = start
        cluster_ts = 0
        while off < end:
            eid, off2 = _read_id(mm, off, end)
            if eid is None:
                break
            if stop_level1 and eid in _LEVEL1:
                return off
            size, body = _read_size(mm, off2, end)
            if size is None:
                break
            if eid == _CLUSTER_TS:
                cluster_ts = _uint(mm, body, size)
            elif eid == _SIMPLE_BLOCK:
                self._on_block(body, size, cluster_ts)
            elif eid == _BLOCK_GROUP:
                o = body
                gend = body + size
                while o < gend:
                    gid, o2 = _read_id(mm, o, gend)
                    if gid is None:
                        break
                    gsize, gbody = _read_size(mm, o2, gend)
                    if gsize is None:
                        break
                    if gid == _BLOCK:
                        self._on_block(gbody, gsize, cluster_ts)
                    o = gbody + gsize
            off = body + size
        return end

    def _on_block(self, body, size, cluster_ts):
        mm = self._mm
        end = body + size
        # track number varint (value WITHOUT the marker bit)
        b0 = mm[body]
        if b0 == 0:
            raise MKVError("MKV: invalid block track varint")
        nlen = 8 - b0.bit_length() + 1
        track = b0 & (0xFF >> nlen)
        for i in range(1, nlen):
            track = (track << 8) | mm[body + i]
        if track != self._track_no:
            return
        p = body + nlen
        rel_ts = struct.unpack_from(">h", mm, p)[0]
        flags = mm[p + 2]
        lacing = (flags >> 1) & 3
        if lacing:
            raise MKVError("MKV: laced video blocks are unsupported; "
                           "remux with ffmpeg")
        data = p + 3
        if end > len(mm) or data > end:
            raise MKVError(f"{self.path!r}: truncated MKV block")
        self._entries.append((data, end - data))
        self._block_ts.append(cluster_ts + rel_ts)

    def _build_timeline(self):
        """Timestamps -> timeline slots; gaps become dropped slots
        (black frames), mirroring the `.pts` sidecar semantics."""
        ts = np.asarray(self._block_ts, np.int64)
        n = len(ts)
        if n == 0:
            raise MKVError(f"{self.path!r}: no video blocks")
        order = np.argsort(ts, kind="stable")
        ts = ts[order]
        self._entries = [self._entries[i] for i in order]
        # frame period in timestamp units
        if self._default_dur and self._ts_scale:
            period = self._default_dur / self._ts_scale
        elif n > 1:
            period = float(np.median(np.diff(ts)))
        else:
            period = 1.0
        if period <= 0:
            period = 1.0
        base = int(ts[0])
        slots = np.rint((ts - base) / period).astype(np.int64)
        # collapse any duplicate slots (jittery timestamps)
        for i in range(1, n):
            if slots[i] <= slots[i - 1]:
                slots[i] = slots[i - 1] + 1
        timeline = [-1] * (int(slots[-1]) + 1)
        for stored, slot in enumerate(slots):
            timeline[int(slot)] = stored
        self._timeline = timeline
        self._have_idx = True
        self._finish_timeline()
