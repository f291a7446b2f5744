"""In-process HuffYUV (HFYU) codec — the dominant VirtualDub lossless
capture codec (the reference decodes it through libav,
ffmpegwrapper.cpp:543; this module removes the external-binary
dependency for the common capture configuration).

Scope: YUY2 (packed 4:2:2) HuffYUV with the LEFT predictor and the
Huffman code-length tables carried in the stream header's extradata —
the VirtualDub default ("Predict left/Huffman-only" with adaptive
tables).  The bitstream model:

  * extradata = method byte (0 = left predictor), bits-per-sample
    byte (8), two reserved bytes, then THREE run-coded code-length
    tables (Y, U, V; 256 symbols each).  Run coding per byte:
    high 3 bits = repeat (0 -> the repeat count is the next byte),
    low 5 bits = code length.
  * per frame: the first 4:2:2 group (Y0 U0 Y1 V0) is stored raw in
    the first 4 bytes; every following sample is the Huffman code of
    (sample - previous same-channel sample) mod 256 (left prediction
    runs across row boundaries).  Groups are interleaved Y U Y V.
  * the bit reader consumes 32-bit LITTLE-ENDIAN words MSB-first
    (the classic HuffYUV word order).
  * canonical code assignment: codes[32] = 0,
    codes[len-1] = (codes[len] + count[len]) >> 1, then symbols of
    each length take ascending codes in symbol order.

Variants outside this scope (RGB HuffYUV, median/gradient predictors,
built-in "classic" tables with no extradata) raise AVIError with a
transcode hint — exactly the contract avi.py documents for codecs it
cannot parse.  Decode runs in the native core (hfyu_decode_yuy2 in
native/stitchcore.cpp) with a pure-Python fallback; the encoder here
is the test-fixture/authoring path (write_avi(codec="HFYU")), and
encode->decode round trips are pinned by tests/test_avi.py.

Carried over from sdvpcmdecoder_tpu/pipeline/huffyuv.py (numpy).  The
native decode is the port's ops/stitch_native binding; the Python decoder
runs only under SDV_NO_NATIVE=1 (a failed build of the core raises).
"""
from __future__ import annotations

import heapq

import numpy as np

METHOD_LEFT = 0
MAX_LEN = 24  # <= 31 so the run-coded length always fits 5 bits


# -- code-length tables ----------------------------------------------------

def huff_lengths(hist: np.ndarray) -> np.ndarray:
    """Huffman code lengths for a 256-symbol histogram (every symbol
    gets a code — real HuffYUV also codes unseen values), clamped to
    MAX_LEN with a Kraft repair pass so the canonical assignment stays
    prefix-free."""
    freq = np.asarray(hist, np.int64) + 1
    heap = [(int(f), i, None) for i, f in enumerate(freq)]
    heapq.heapify(heap)
    nodes = []
    while len(heap) > 1:
        a = heapq.heappop(heap)
        b = heapq.heappop(heap)
        nodes.append((a, b))
        heapq.heappush(heap, (a[0] + b[0], 256 + len(nodes) - 1,
                              len(nodes) - 1))
    lens = np.zeros(256, np.uint8)

    def walk(entry, depth):
        stack = [(entry, depth)]
        while stack:
            (f, idx, node), d = stack.pop()
            if node is None:
                lens[idx] = max(d, 1)
            else:
                a, b = nodes[node]
                stack.append((a, d + 1))
                stack.append((b, d + 1))

    walk(heap[0], 0)
    # clamp + Kraft repair: K = sum 2^-len must stay <= 1
    lens = np.minimum(lens, MAX_LEN)
    kraft = np.sum(2.0 ** (-lens.astype(np.float64)))
    order = np.argsort(lens)  # lengthen the shortest codes first
    k = 0
    while kraft > 1.0 + 1e-12:
        i = order[k % 256]
        if lens[i] < MAX_LEN:
            kraft -= 2.0 ** (-float(lens[i])) / 2
            lens[i] += 1
        k += 1
    return lens


def gen_codes(lens: np.ndarray) -> np.ndarray:
    """Canonical code per symbol (see module docstring)."""
    lens = np.asarray(lens, np.int64)
    count = np.bincount(lens, minlength=33)
    codes = np.zeros(34, np.int64)
    for ln in range(32, 0, -1):
        codes[ln - 1] = (codes[ln] + count[ln]) >> 1
    base = codes.copy()
    out = np.zeros(256, np.uint32)
    for i in range(256):
        ln = lens[i]
        out[i] = base[ln]
        base[ln] += 1
    return out


def write_len_table(lens: np.ndarray) -> bytes:
    out = bytearray()
    i = 0
    lens = np.asarray(lens, np.int64)
    while i < 256:
        v = int(lens[i])
        run = 1
        while i + run < 256 and int(lens[i + run]) == v:
            run += 1
        i += run
        while run > 0:
            r = min(run, 255)
            if r < 8:
                out.append((r << 5) | v)
            else:
                out.append(v)          # repeat field 0 -> count follows
                out.append(r)
            run -= r
    return bytes(out)


def read_len_table(data: bytes, pos: int):
    lens = np.zeros(256, np.uint8)
    i = 0
    while i < 256:
        if pos >= len(data):
            raise ValueError("HFYU: truncated length table")
        b = data[pos]
        pos += 1
        rep, val = b >> 5, b & 31
        if rep == 0:
            if pos >= len(data):
                raise ValueError("HFYU: truncated length table")
            rep = data[pos]
            pos += 1
        if rep == 0 or i + rep > 256:
            raise ValueError("HFYU: bad length-table run")
        lens[i:i + rep] = val
        i += rep
    return lens, pos


def build_extradata(lens_y, lens_u, lens_v) -> bytes:
    # byte 1 = bitstream bpp: 16 for YUY2 (libavcodec validates this
    # when the container carries no separate bit count, e.g. MKV)
    return bytes([METHOD_LEFT, 16, 0, 0]) \
        + write_len_table(lens_y) + write_len_table(lens_u) \
        + write_len_table(lens_v)


def parse_extradata(extra: bytes):
    if len(extra) < 4:
        raise ValueError("HFYU: missing extradata tables")
    # byte 0: predictor in the low 6 bits (0 = left); bit 6 is the RGB
    # decorrelate flag, meaningless for YUY2 streams
    method = extra[0] & 63
    if method != METHOD_LEFT:
        raise ValueError(f"HFYU: unsupported predictor method {method} "
                         "(only left prediction is supported in-process;"
                         " pre-transcode with ffmpeg)")
    # byte 1: bitstream bpp — 16 = YUY2 (what libavcodec writes), 8 is
    # this module's legacy value for the same streams, 0 = unset
    if extra[1] not in (0, 8, 16):
        raise ValueError(f"HFYU: unsupported bit depth {extra[1]} "
                         "(only YUY2 streams decode in-process)")
    pos = 4
    lens_y, pos = read_len_table(extra, pos)
    lens_u, pos = read_len_table(extra, pos)
    lens_v, pos = read_len_table(extra, pos)
    return lens_y, lens_u, lens_v


# -- encode (authoring/test path) ------------------------------------------

def _yuy2_samples(luma: np.ndarray):
    """Gray frame [H, W] -> (y, u, v) sample streams of a YUY2 raster
    (U = V = 128: the capture chain this library serves is luma-only)."""
    H, W = luma.shape
    y = np.asarray(luma, np.uint8).reshape(-1)
    u = np.full(H * W // 2, 128, np.uint8)
    return y, u, u


def _deltas(s: np.ndarray) -> np.ndarray:
    d = np.empty(len(s), np.uint8)
    d[0] = s[0]
    d[1:] = (s[1:].astype(np.int16) - s[:-1].astype(np.int16)) % 256
    return d


def encode_frame(luma: np.ndarray, lens3, codes3) -> bytes:
    """One HFYU frame for a gray raster (YUY2 with flat chroma)."""
    H, W = luma.shape
    if W % 2:
        raise ValueError("HFYU needs even width")
    y, u, v = _yuy2_samples(luma)
    dy, du, dv = _deltas(y), _deltas(u), _deltas(v)
    # interleave deltas Y U Y V per 4:2:2 group, skip the raw group 0
    n_grp = H * W // 2
    syms = np.empty(n_grp * 4, np.uint8)
    syms[0::4] = dy[0::2]
    syms[1::4] = du
    syms[2::4] = dy[1::2]
    syms[3::4] = dv
    syms = syms[4:]
    chan = np.tile(np.array([0, 1, 0, 2], np.uint8), n_grp)[4:]
    lens = np.choose(chan, [lens3[0][syms], lens3[1][syms],
                            lens3[2][syms]]).astype(np.int64)
    codes = np.choose(chan, [codes3[0][syms], codes3[1][syms],
                             codes3[2][syms]]).astype(np.uint64)
    # vectorized MSB-first bit packing into 32-bit LE words
    ends = np.cumsum(lens)
    total = int(ends[-1])
    n_words = (total + 31) // 32
    # place each code's bits into a u64 window starting at its offset
    starts = ends - lens
    word_idx = starts >> 5
    bit_in = starts & 31
    # a code may straddle two words: write via u64 accumulation
    shifted = codes << (64 - bit_in - lens).astype(np.uint64, copy=False)
    shifted = shifted.astype(np.uint64)
    hi = (shifted >> np.uint64(32)).astype(np.uint32)
    lo = (shifted & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    words = np.zeros(n_words + 1, np.uint64)
    np.add.at(words, word_idx, hi.astype(np.uint64))
    np.add.at(words, word_idx + 1, lo.astype(np.uint64))
    # canonical codes never overlap, so plain adds cannot carry
    out_words = (words[:n_words] & np.uint64(0xFFFFFFFF)) \
        .astype(np.uint32)
    head = bytes([int(y[0]), int(u[0]), int(y[1]), int(v[0])])
    return head + out_words.astype("<u4").tobytes()


def encode(frames: np.ndarray):
    """frames [N, H, W] gray -> (extradata, [frame bytes]).  Tables are
    computed from the first frame (the adaptive-table capture mode)."""
    f0 = np.asarray(frames[0], np.uint8)
    y, u, v = _yuy2_samples(f0)
    lens_y = huff_lengths(np.bincount(_deltas(y), minlength=256))
    lens_u = huff_lengths(np.bincount(_deltas(u), minlength=256))
    lens_v = huff_lengths(np.bincount(_deltas(v), minlength=256))
    lens3 = (lens_y, lens_u, lens_v)
    codes3 = tuple(gen_codes(ln) for ln in lens3)
    extra = build_extradata(*lens3)
    return extra, [encode_frame(np.asarray(f, np.uint8), lens3, codes3)
                   for f in frames]


# -- decode ----------------------------------------------------------------

def decode_frame(data, W, H, lens3, native=True) -> np.ndarray:
    """One HFYU frame -> luma [H, W] (chroma is decoded and discarded,
    as the reference's GRAY8 swscale path does)."""
    from ..ops import stitch_native as sn
    if native and sn.available():
        out = sn.hfyu_decode_yuy2(np.frombuffer(data, np.uint8), W, H,
                                  lens3[0], lens3[1], lens3[2])
        if out is not None:
            return out
    return _decode_frame_py(data, W, H, lens3)


def _decode_frame_py(data, W, H, lens3):
    """Reference-pace Python fallback (native core unavailable)."""
    tabs = []
    for lens in lens3:
        lens = np.asarray(lens, np.int64)
        count = np.bincount(lens, minlength=33)
        codes = np.zeros(34, np.int64)
        for ln in range(32, 0, -1):
            codes[ln - 1] = (codes[ln] + count[ln]) >> 1
        sym_by_len = {ln: np.nonzero(lens == ln)[0]
                      for ln in range(1, 33) if count[ln]}
        tabs.append((codes, sym_by_len))
    n_samples = W * H * 2
    out = np.empty(n_samples, np.uint8)
    out[0], out[1], out[2], out[3] = data[0], data[1], data[2], data[3]
    words = np.frombuffer(data[4:len(data) - ((len(data) - 4) % 4)],
                          "<u4").astype(np.uint64)
    bitpos = 0

    def read_sym(tab):
        nonlocal bitpos
        codes, sym_by_len = tab
        v = 0
        for ln in range(1, 33):
            w = words[bitpos >> 5]
            bit = 31 - (bitpos & 31)
            v = (v << 1) | ((int(w) >> bit) & 1)
            bitpos += 1
            syms = sym_by_len.get(ln)
            if syms is not None:
                rel = v - int(codes[ln])
                if 0 <= rel < len(syms):
                    return int(syms[rel])
        raise ValueError("HFYU: invalid code")

    chan_tab = (tabs[0], tabs[1], tabs[0], tabs[2])
    preds = [int(out[2]), int(out[1]), int(out[3])]  # y, u, v left preds
    chan_of = (0, 1, 0, 2)
    for i in range(4, n_samples):
        c = chan_of[i & 3]
        d = read_sym(chan_tab[i & 3])
        preds[c] = (preds[c] + d) & 0xFF
        out[i] = preds[c]
    yuyv = out.reshape(H, 2 * W)
    return np.ascontiguousarray(yuyv[:, 0::2])
