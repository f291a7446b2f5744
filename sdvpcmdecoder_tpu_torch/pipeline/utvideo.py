"""In-process Ut Video (ULY0/ULY2/ULH0/ULH2) codec — with HuffYUV and
Lagarith the third common lossless VfW capture codec on tape-archival
AVIs (the reference decodes it through libav, ffmpegwrapper.cpp:543;
this module removes the external-binary dependency — which matters
doubly here because the execution image carries no ffmpeg binary).

Scope: the planar 8-bit YUV frame types ULY0/ULH0 (4:2:0) and
ULY2/ULH2 (4:2:2) — the capture configurations the luma-only PCM
raster path meets (ULH* is the BT.709-flagged variant: identical
bitstream, the flag only matters for RGB conversion which the gray
path never does).  Progressive only; the interlaced extradata flag
raises with a transcode hint.  Bitstream layout (pinned empirically
against libavcodec: OpenCV's bundled ffmpeg both encodes and decodes
Ut Video, giving reference streams in BOTH directions):

  * extradata (16 bytes): le32 encoder version, le32 original-format
    fourcc, le32 frame_info_size (always 4), le32 flags —
    slices = (flags >> 24) + 1, bit 0 = huffman compression,
    bit 11 = interlaced.
  * each frame: per plane (Y, U, V in order) a 256-byte code-length
    table (255 = symbol unused; a plane whose FIRST sorted entry has
    length 0 is a single-symbol "fsym" plane with no data), then
    `slices` le32 cumulative slice-end byte offsets, then the slice
    bitstreams; after the last plane a le32 frame_info whose bits 8-9
    select the predictor (0 none, 1 left, 2 gradient, 3 median).
  * slice rows: slice s covers [H*s//slices, H*(s+1)//slices), the
    end rounded down to even for the LUMA plane of 4:2:0 frames.
  * bit order: MSB-first within 32-bit LITTLE-ENDIAN words (libav
    byte-swaps each word then reads MSB-first — same convention as
    HuffYUV).
  * canonical codes: symbols sorted by (length, symbol) ascending;
    codes assigned from the LAST used entry upward with
    code_i = C >> (32 - len_i); C += 1 << (32 - len_i), C starting
    at 1 — so within one length, ascending codes map to DESCENDING
    symbol values.
  * prediction: "left" applies during symbol decode (prev starts at
    0x80 per slice and carries across rows); "gradient" and "median"
    store raw residuals and run a per-slice restore pass afterwards
    (median's left/top-left seeds cross row boundaries like
    Lagarith's, but with the uint8-wrapped third median argument).

The encoder is the authoring/test path (write_avi(codec="ULY0"))
supporting all three predictors, so the cv2 anchor tests pin every
restore path against libavcodec pixel-for-pixel.

Reference scope: ffmpegwrapper.cpp:543 (slotOpenInput accepts any
libav-decodable capture); frame/plane layout per the public Ut Video
format as implemented by libavcodec's utvideo decoder.

Carried over from sdvpcmdecoder_tpu/pipeline/utvideo.py (numpy).  The
native decode is the port's ops/stitch_native binding; the Python decoder
runs only under SDV_NO_NATIVE=1 (a failed build of the core raises).
"""
from __future__ import annotations

import heapq
import struct

import numpy as np

PRED_NONE = 0
PRED_LEFT = 1
PRED_GRADIENT = 2
PRED_MEDIAN = 3

_PRED_NAMES = {"none": PRED_NONE, "left": PRED_LEFT,
               "gradient": PRED_GRADIENT, "median": PRED_MEDIAN}

MAX_LEN = 24  # encoder cap (format allows 32)


class UtVideoError(ValueError):
    pass


class StreamInfo:
    """Parsed extradata."""

    def __init__(self, fourcc, extra):
        if len(extra) < 16:
            raise UtVideoError("ULY: extradata too short")
        self.fourcc = fourcc
        (self.version, self.orig_format, self.frame_info_size,
         self.flags) = struct.unpack_from("<IIII", extra, 0)
        if self.frame_info_size != 4:
            raise UtVideoError(
                f"ULY: unsupported frame_info_size {self.frame_info_size}")
        if self.flags & 0x800:
            raise UtVideoError(
                "ULY: interlaced Ut Video is unsupported in-process; "
                "pre-transcode with ffmpeg")
        self.slices = (self.flags >> 24) + 1
        if fourcc in (b"ULY0", b"ULH0"):
            self.subsampled_h = True     # 4:2:0
        elif fourcc in (b"ULY2", b"ULH2"):
            self.subsampled_h = False    # 4:2:2
        else:
            raise UtVideoError(
                f"ULY: unsupported Ut Video variant {fourcc!r} (only "
                "planar 8-bit YUV decodes in-process; pre-transcode "
                "with ffmpeg)")


# -- canonical code tables ----------------------------------------------------

def _sorted_entries(lens):
    """(len, sym) ascending over used symbols (len != 255)."""
    ent = [(int(lens[s]), s) for s in range(256) if lens[s] != 255]
    ent.sort()
    return ent


def build_decode_table(lens):
    """lens[256] -> (fsym, {length: (lo_code, syms_by_code)}).

    syms_by_code[code - lo_code] = symbol (descending symbol values,
    see module docstring)."""
    ent = _sorted_entries(lens)
    if not ent:
        raise UtVideoError("ULY: empty code-length table")
    if ent[0][0] == 0:
        return ent[0][1], None
    if ent[-1][0] > 32:
        raise UtVideoError("ULY: code length > 32")
    # uint32 wrapping arithmetic, exactly as libavcodec assigns codes
    # (a Kraft-complete table wraps to its start value on the last add)
    code = 1
    by_len = {}
    for ln, sym in reversed(ent):
        c = code >> (32 - ln)
        lo, syms = by_len.setdefault(ln, [c, []])
        by_len[ln][0] = min(lo, c)
        syms.append(sym)
        code = (code + (1 << (32 - ln))) & 0xFFFFFFFF
    return -1, {ln: (lo, syms) for ln, (lo, syms) in by_len.items()}


def gen_codes(lens):
    """Encoder mirror of build_decode_table: code per used symbol."""
    ent = _sorted_entries(lens)
    codes = {}
    code = 1
    for ln, sym in reversed(ent):
        codes[sym] = code >> (32 - ln)
        code = (code + (1 << (32 - ln))) & 0xFFFFFFFF
    return codes


def huff_lengths(hist):
    """Code lengths for used symbols (unused -> 255), capped at
    MAX_LEN with a Kraft repair pass.  Single used symbol -> length 0
    (the fsym convention)."""
    hist = np.asarray(hist, np.int64)
    used = np.nonzero(hist)[0]
    lens = np.full(256, 255, np.uint8)
    if len(used) == 0:
        raise UtVideoError("ULY: empty plane histogram")
    if len(used) == 1:
        lens[used[0]] = 0
        return lens
    heap = [(int(hist[s]), int(s), None) for s in used]
    heapq.heapify(heap)
    nodes = []
    while len(heap) > 1:
        a = heapq.heappop(heap)
        b = heapq.heappop(heap)
        nodes.append((a, b))
        heapq.heappush(heap, (a[0] + b[0], 256 + len(nodes) - 1,
                              len(nodes) - 1))
    stack = [(heap[0], 0)]
    while stack:
        (f, idx, node), d = stack.pop()
        if node is None:
            lens[idx] = max(min(d, MAX_LEN), 1)
        else:
            a, b = nodes[node]
            stack.append((a, d + 1))
            stack.append((b, d + 1))
    kraft = np.sum(2.0 ** (-lens[used].astype(np.float64)))
    order = used[np.argsort(lens[used])]
    k = 0
    while kraft > 1.0 + 1e-12:
        i = order[k % len(used)]
        if lens[i] < MAX_LEN:
            kraft -= 2.0 ** (-float(lens[i])) / 2
            lens[i] += 1
        k += 1
    return lens


# -- geometry ------------------------------------------------------------------

def slice_rows(height, slices, even_mask):
    """[(sstart, send)] per slice; send rounded down to even when
    even_mask (the 4:2:0 luma rule)."""
    mask = ~1 if even_mask else ~0
    out = []
    send = 0
    for s in range(slices):
        sstart = send
        send = (height * (s + 1) // slices) & mask
        out.append((sstart, send))
    return out


def _plane_dims(W, H, info):
    if W % 2:
        raise UtVideoError("ULY: odd width unsupported")
    if info.subsampled_h:
        if H % 2:
            raise UtVideoError("ULY: odd height unsupported for 4:2:0")
        return [(W, H, True), (W // 2, H // 2, False),
                (W // 2, H // 2, False)]
    return [(W, H, False), (W // 2, H, False), (W // 2, H, False)]


# -- decode ---------------------------------------------------------------------

def decode_plane(data, pos, W, H, info, pred, even_mask, native=True):
    """One plane at data[pos] -> (uint8 [H, W], next_pos).  Decode runs
    in the native core (uly_decode_plane in native/stitchcore.cpp) when
    available; the Python body is the spec and the fallback."""
    slices = info.slices
    if len(data) - pos < 256 + 4 * slices:
        raise UtVideoError("ULY: truncated plane header")
    ends = struct.unpack_from(f"<{slices}I", data, pos + 256)
    plane_size = ends[-1] if slices else 0
    next_pos = pos + 256 + 4 * slices + plane_size
    if next_pos > len(data):
        raise UtVideoError("ULY: truncated plane data")
    if native:
        from ..ops import stitch_native as sn
        got = sn.uly_decode_plane(data, pos, W, H, slices, pred,
                                  even_mask) if sn.available() else None
        if got is not None:
            rc, arr = got
            if rc != 0:
                raise UtVideoError(_NATIVE_MSG.get(rc, f"ULY: error {rc}"))
            return arr, next_pos
    lens = np.frombuffer(data, np.uint8, 256, pos)
    fsym, table = build_decode_table(lens)
    dstart = pos + 256 + 4 * slices
    out = np.empty((H, W), np.uint8)
    rows = slice_rows(H, slices, even_mask)
    if fsym >= 0:
        for sstart, send in rows:
            if pred == PRED_LEFT:
                prev = 0x80
                for r in range(sstart, send):
                    row = out[r]
                    for i in range(W):
                        prev = (prev + fsym) & 0xFF
                        row[i] = prev
            else:
                out[sstart:send] = fsym
        if pred == PRED_GRADIENT:
            _restore_gradient(out, rows)
        elif pred == PRED_MEDIAN:
            _restore_median(out, rows)
        return out, next_pos
    start = 0
    for s, (sstart, send) in enumerate(rows):
        end = ends[s]
        if end < start or dstart + end > len(data):
            raise UtVideoError("ULY: bad slice offsets")
        if send > sstart and end == start:
            raise UtVideoError("ULY: empty slice with data rows")
        _decode_slice(data, dstart + start, end - start, out, sstart,
                      send, table, pred == PRED_LEFT)
        start = end
    if pred == PRED_GRADIENT:
        _restore_gradient(out, rows)
    elif pred == PRED_MEDIAN:
        _restore_median(out, rows)
    return out, next_pos


_NATIVE_MSG = {
    -1: "ULY: truncated plane",
    -2: "ULY: invalid code",
    -3: "ULY: bad slice offsets",
    -4: "ULY: empty code-length table",
}


def _decode_slice(data, dpos, size, out, sstart, send, table, left):
    """Huffman-decode one slice's rows (bit order: MSB-first within
    32-bit LE words)."""
    W = out.shape[1]
    n_words = (size + 3) // 4
    # libavcodec copies exactly `size` bytes and ZERO-pads the last
    # word — bits past the slice's own bytes must read as 0, not as the
    # next slice's data.
    raw = np.frombuffer(data, np.uint8, min(size, len(data) - dpos), dpos)
    if len(raw) < n_words * 4:
        raw = np.concatenate([raw, np.zeros(n_words * 4 - len(raw),
                                            np.uint8)])
    words = raw.view("<u4")
    n_bits = n_words * 32
    bitpos = 0
    prev = 0x80
    max_len = max(table)
    for r in range(sstart, send):
        row = out[r]
        for i in range(W):
            v = 0
            sym = -1
            for ln in range(1, max_len + 1):
                if bitpos >= n_bits:
                    raise UtVideoError("ULY: bitstream overrun")
                w = int(words[bitpos >> 5])
                v = (v << 1) | ((w >> (31 - (bitpos & 31))) & 1)
                bitpos += 1
                ent = table.get(ln)
                if ent is not None:
                    rel = v - ent[0]
                    if 0 <= rel < len(ent[1]):
                        sym = ent[1][rel]
                        break
            if sym < 0:
                raise UtVideoError("ULY: invalid code")
            if left:
                prev = (prev + sym) & 0xFF
                row[i] = prev
            else:
                row[i] = sym


def _mid_pred(a, b, c):
    if a > b:
        a, b = b, a
    return min(b, max(a, c))


def _restore_gradient(plane, rows):
    W = plane.shape[1]
    for sstart, send in rows:
        if send <= sstart:
            continue
        row = plane[sstart]
        acc = (int(row[0]) + 0x80) & 0xFF
        row[0] = acc
        for i in range(1, W):
            acc = (acc + int(row[i])) & 0xFF
            row[i] = acc
        for r in range(sstart + 1, send):
            row, top = plane[r], plane[r - 1]
            row[0] = (int(row[0]) + int(top[0])) & 0xFF
            for i in range(1, W):
                grad = (int(top[i]) - int(top[i - 1])
                        + int(row[i - 1]) + int(row[i])) & 0xFF
                row[i] = grad


def _restore_median(plane, rows):
    W = plane.shape[1]
    for sstart, send in rows:
        if send <= sstart:
            continue
        row = plane[sstart]
        acc = (int(row[0]) + 0x80) & 0xFF
        row[0] = acc
        for i in range(1, W):
            acc = (acc + int(row[i])) & 0xFF
            row[i] = acc
        if send - sstart <= 1:
            continue
        # second row: first element top-predicted, then median with the
        # uint8-wrapped third argument (libavcodec restore_median_planar)
        row, top = plane[sstart + 1], plane[sstart]
        c = int(top[0])
        a = (int(row[0]) + c) & 0xFF
        row[0] = a
        for i in range(1, W):
            b = int(top[i])
            a = (int(row[i]) + _mid_pred(a, b, (a + b - c) & 0xFF)) & 0xFF
            row[i] = a
            c = b
        # remaining rows: left/top-left carry across row boundaries
        lt = int(top[W - 1])
        for r in range(sstart + 2, send):
            row, top = plane[r], plane[r - 1]
            for i in range(W):
                t = int(top[i])
                a = (int(row[i]) + _mid_pred(a, t, (a + t - lt) & 0xFF)) \
                    & 0xFF
                row[i] = a
                lt = t


def decode_frame_gray(data, W, H, info, native=True):
    """One Ut Video frame -> luma [H, W] (the luma plane comes first,
    so chroma is never parsed — the reference's GRAY8 swscale path
    does the same reduction)."""
    data = bytes(data)
    if len(data) < 4:
        raise UtVideoError("ULY: truncated frame")
    frame_info = struct.unpack_from("<I", data, len(data) - 4)[0]
    pred = (frame_info >> 8) & 3
    plane, _ = decode_plane(data, 0, W, H, info, pred,
                            even_mask=info.subsampled_h, native=native)
    return plane


def decode_frame_planes(data, W, H, info, native=True):
    """Full decode -> (y, u, v) planes.  Anchor-test surface."""
    data = bytes(data)
    frame_info = struct.unpack_from("<I", data, len(data) - 4)[0]
    pred = (frame_info >> 8) & 3
    out = []
    pos = 0
    for k, (w, h, even_mask) in enumerate(_plane_dims(W, H, info)):
        plane, pos = decode_plane(data, pos, w, h, info, pred,
                                  even_mask=even_mask, native=native)
        out.append(plane)
    return tuple(out)


# -- encoder (authoring/test path) ----------------------------------------------

def _residual_left(plane, rows):
    """pixels -> left-predicted deltas (prev = 0x80 per slice, carried
    across rows; inverse of the decoder's PRED_LEFT path)."""
    H, W = plane.shape
    res = np.empty_like(plane)
    for sstart, send in rows:
        flat = plane[sstart:send].reshape(-1).astype(np.int16)
        d = np.empty_like(flat)
        d[0] = flat[0] - 0x80
        d[1:] = flat[1:] - flat[:-1]
        res[sstart:send] = (d % 256).astype(np.uint8).reshape(
            send - sstart, W)
    return res


def _residual_gradient(plane, rows):
    res = plane.copy()
    for sstart, send in reversed(rows):
        for r in range(send - 1, sstart, -1):
            row, top = plane[r].astype(np.int16), plane[r - 1].astype(
                np.int16)
            out = res[r]
            out[0] = (row[0] - top[0]) % 256
            out[1:] = (row[1:] - (top[1:] - top[:-1] + row[:-1])) % 256
        row0 = plane[sstart].astype(np.int16)
        out = res[sstart]
        out[0] = (row0[0] - 0x80) % 256
        out[1:] = (row0[1:] - row0[:-1]) % 256
    return res


def _residual_median(plane, rows):
    H, W = plane.shape
    res = plane.copy()
    for sstart, send in rows:
        # invert in forward order into a separate buffer
        row0 = plane[sstart].astype(np.int16)
        res[sstart, 0] = (row0[0] - 0x80) % 256
        res[sstart, 1:] = (row0[1:] - row0[:-1]) % 256
        if send - sstart <= 1:
            continue
        top = plane[sstart]
        row = plane[sstart + 1]
        c = int(top[0])
        res[sstart + 1, 0] = (int(row[0]) - c) % 256
        a = int(row[0])
        for i in range(1, W):
            b = int(top[i])
            res[sstart + 1, i] = (int(row[i])
                                  - _mid_pred(a, b, (a + b - c) & 0xFF)) \
                % 256
            c = b
            a = int(row[i])
        lt = int(top[W - 1])
        for r in range(sstart + 2, send):
            row, top = plane[r], plane[r - 1]
            for i in range(W):
                t = int(top[i])
                res[r, i] = (int(row[i])
                             - _mid_pred(a, t, (a + t - lt) & 0xFF)) % 256
                a = int(row[i])
                lt = t
    return res


def encode_plane(plane, pred, slices=1, even_mask=False):
    """One plane -> Ut Video plane bytes."""
    plane = np.asarray(plane, np.uint8)
    H, W = plane.shape
    rows = slice_rows(H, slices, even_mask)
    if pred == PRED_LEFT:
        res = _residual_left(plane, rows)
    elif pred == PRED_GRADIENT:
        res = _residual_gradient(plane, rows)
    elif pred == PRED_MEDIAN:
        res = _residual_median(plane, rows)
    else:
        res = plane
    hist = np.bincount(res.reshape(-1), minlength=256)
    lens = huff_lengths(hist)
    ent = _sorted_entries(lens)
    if ent[0][0] == 0:      # single-symbol plane: no slice data
        return bytes(lens) + b"\x00\x00\x00\x00" * slices
    codes = gen_codes(lens)
    code_arr = np.zeros(256, np.uint64)
    len_arr = np.zeros(256, np.int64)
    for sym, c in codes.items():
        code_arr[sym] = c
        len_arr[sym] = lens[sym]
    payload = bytearray()
    ends = []
    for sstart, send in rows:
        syms = res[sstart:send].reshape(-1)
        payload += _pack_bits(code_arr[syms], len_arr[syms])
        ends.append(len(payload))
    return bytes(lens) + struct.pack(f"<{slices}I", *ends) \
        + bytes(payload)


def _pack_bits(codes, lens):
    """MSB-first bit packing into 32-bit LE words, padded to 4 bytes
    (the vectorized scheme shared with pipeline/huffyuv.py)."""
    if len(codes) == 0:
        return b""
    lens = lens.astype(np.int64)
    codes = codes.astype(np.uint64)
    ends = np.cumsum(lens)
    total = int(ends[-1])
    n_words = (total + 31) // 32
    starts = ends - lens
    word_idx = starts >> 5
    bit_in = starts & 31
    shifted = (codes << (64 - bit_in - lens).astype(np.uint64)) \
        .astype(np.uint64)
    hi = (shifted >> np.uint64(32)).astype(np.uint64)
    lo = (shifted & np.uint64(0xFFFFFFFF)).astype(np.uint64)
    words = np.zeros(n_words + 1, np.uint64)
    np.add.at(words, word_idx, hi)
    np.add.at(words, word_idx + 1, lo)
    return (words[:n_words] & np.uint64(0xFFFFFFFF)) \
        .astype("<u4").tobytes()


def build_extradata(fourcc, slices=1):
    orig = b"YV12" if fourcc in ("ULY0", "ULH0") else b"YUY2"
    flags = ((slices - 1) << 24) | 1
    return struct.pack("<I4sII", 0x010000F0, orig, 4, flags)


def encode_frame(luma, info, pred=PRED_LEFT, chroma=None):
    """Gray frame [H, W] -> one Ut Video frame (flat chroma by
    default; pass chroma=(u, v) planes to exercise full planar YUV)."""
    luma = np.asarray(luma, np.uint8)
    H, W = luma.shape
    dims = _plane_dims(W, H, info)
    if chroma is None:
        planes = [luma] + [np.full((h, w), 128, np.uint8)
                           for w, h, _ in dims[1:]]
    else:
        planes = [luma] + [np.asarray(c, np.uint8) for c in chroma]
    out = bytearray()
    for plane, (w, h, even_mask) in zip(planes, dims):
        if plane.shape != (h, w):
            raise UtVideoError(f"ULY: plane shape {plane.shape} != "
                               f"({h}, {w})")
        out += encode_plane(plane, pred, info.slices, even_mask)
    out += struct.pack("<I", pred << 8)
    return bytes(out)


def encode(frames, fourcc="ULY0", pred="left", slices=1):
    """frames [N, H, W] gray -> (extradata, [frame chunks])."""
    extra = build_extradata(fourcc, slices)
    info = StreamInfo(fourcc.encode(), extra)
    p = _PRED_NAMES[pred] if isinstance(pred, str) else int(pred)
    return extra, [encode_frame(np.asarray(f, np.uint8), info, p)
                   for f in frames]
