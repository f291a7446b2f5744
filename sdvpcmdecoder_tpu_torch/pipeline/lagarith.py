"""In-process Lagarith (LAGS) codec — after HuffYUV the most common
lossless VfW capture codec on tape-archival AVIs (the reference decodes
it through libav, ffmpegwrapper.cpp:543; this module removes the
external-binary dependency, which matters doubly here because the
execution image carries no ffmpeg binary at all).

Scope: the YV12 (planar 4:2:0) and solid-gray Lagarith frame types,
which cover the archival capture configuration this library serves
(luma-only PCM rasters; chroma is flat).  Per plane the bitstream has
three supported modes:

  * range-coded residuals (esc_count 1..3): a 256-symbol static-model
    carry-less range coder whose cumulative probability table is
    transmitted per plane as a Zeckendorf-style VLC (two consecutive
    1-bits terminate; Fibonacci weights 1,2,3,5,8,13,21), plus a
    zero-run escape — after `esc_count` consecutive zero residuals the
    next symbol is a zigzag-coded extra-run length.
  * raw residuals (esc_count 4): the prediction residue stored
    uncompressed.
  * solid fill (esc_count 0xff).

Zero-run-line coding (esc_count 5..7) raises: no encoder in the wild
emits it and there is no way to pin a correct reconstruction
(libavcodec marks its own "request sample").

Residuals are medians: row 0 is left-predicted, later rows use the
median predictor with the left/top-left seeds reaching across row
boundaries (L = previous row's last pixel).  When a transmitted
probability table does not sum to a power of two, the decoder rescales
it with the same fixed-point "softfloat" arithmetic libavcodec
reverse-engineered from the reference Lagarith decoder, so both sides
derive one table.

The encoder here is the authoring/test path (write_avi(codec="LAGS"))
and intentionally emits streams libavcodec can decode: conformance is
pinned by tests/test_lagarith.py round trips plus an external anchor —
OpenCV's bundled libavcodec decodes this encoder's AVIs and must match
pixel-for-pixel.

Reference scope: ffmpegwrapper.cpp:543 (slotOpenInput accepts any
libav-decodable capture); frame/plane layout per the public Lagarith
format as implemented by libavcodec's lagarith decoder.

Carried over from sdvpcmdecoder_tpu/pipeline/lagarith.py (numpy).  The
native decode is the port's ops/stitch_native binding; the Python decoder
runs only under SDV_NO_NATIVE=1 (a failed build of the core raises).
"""
from __future__ import annotations

import struct

import numpy as np

# Frame type byte (first byte of every Lagarith frame).  The YUV/solid
# values are pinned empirically against libavcodec (tests/test_lagarith
# anchor): 3 decodes as yuv422p (YUY2), 5 as solid gray, 10 as yuv420p
# (YV12); 2/4 are planar-RGB arith frames.
FRAME_ARITH_YUY2 = 3
FRAME_SOLID_GRAY = 5
FRAME_ARITH_YV12 = 10

_SERIES = (1, 2, 3, 5, 8, 13, 21)   # Fibonacci VLC weights
_TOP = 0x800000                     # range renormalization threshold


class LagarithError(ValueError):
    pass


# -- bit I/O (MSB-first, as libavcodec's get_bits consumes) ------------------

class _BitReader:
    def __init__(self, data, pos_bytes=0):
        self.d = data
        self.pos = pos_bytes * 8

    def bit(self):
        p = self.pos
        if (p >> 3) >= len(self.d):
            raise LagarithError("LAGS: bitstream overrun")
        self.pos = p + 1
        return (self.d[p >> 3] >> (7 - (p & 7))) & 1

    def bits(self, n):
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit()
        return v

    def align_byte(self):
        self.pos = (self.pos + 7) & ~7
        return self.pos >> 3


class _BitWriter:
    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.n = 0

    def bit(self, b):
        self.acc = (self.acc << 1) | (b & 1)
        self.n += 1
        if self.n == 8:
            self.out.append(self.acc)
            self.acc = 0
            self.n = 0

    def bits(self, v, n):
        for i in range(n - 1, -1, -1):
            self.bit((v >> i) & 1)

    def align_byte(self):
        while self.n:
            self.bit(0)
        return bytes(self.out)


# -- probability-table VLC ---------------------------------------------------

def _read_prob_vlc(br):
    """One transmitted probability: Zeckendorf prefix (sum of Fibonacci
    weights at 0->1 transitions, two consecutive 1s terminate) encodes
    bit-count+1, then that many literal bits."""
    bit = 0
    prevbit = 0
    nbits = 0
    for i in range(7):
        if prevbit and bit:
            break
        prevbit = bit
        bit = br.bit()
        if bit and not prevbit:
            nbits += _SERIES[i]
    nbits -= 1
    if nbits < 0 or nbits > 31:
        raise LagarithError("LAGS: invalid probability code")
    if nbits == 0:
        return 0
    val = br.bits(nbits) | (1 << nbits)
    return val - 1


def _write_prob_vlc(bw, value):
    """Inverse of _read_prob_vlc."""
    val = value + 1
    nbits = val.bit_length() - 1
    target = nbits + 1
    # Zeckendorf decomposition over _SERIES (greedy high-to-low always
    # yields non-adjacent terms).
    pos = []
    rem = target
    for i in range(6, -1, -1):
        if _SERIES[i] <= rem:
            pos.append(i)
            rem -= _SERIES[i]
    if rem:
        raise LagarithError(f"LAGS: prob prefix {target} not encodable")
    pattern = [0] * 7
    for i in pos:
        pattern[i] = 1
    last = max(pos)
    # terminator: a second consecutive 1 right after the last weight bit
    # (omitted when the prefix already fills all 7 positions).
    if last + 1 < 7:
        pattern[last + 1] = 1
        plen = last + 2
    else:
        plen = 7
    for i in range(plen):
        bw.bit(pattern[i])
    if nbits:
        bw.bits(val - (1 << nbits), nbits)


# -- softfloat rescale (non-power-of-two cumulative probabilities) -----------

def _av_log2(x):
    return max(int(x).bit_length() - 1, 0)


def scale_prob_table(probs):
    """Raw transmitted per-symbol probabilities [256] -> (cumulative
    table [257], scale).  Identity apart from the cumsum when the sum is
    already a power of two; otherwise both sides rescale to the next
    power of two the same way — pinned against libavcodec empirically
    (tests/test_lagarith.py softfloat anchors): scaled = floor(p*T/cumul)
    (libavcodec computes this through a 52-bit fixed-point reciprocal
    whose error is far below one ULP for any realistic table), then the
    rounding deficit is distributed +1 per nonzero symbol cycling
    ascending over symbols 0..127 until the sum is exactly T."""
    probs = [int(p) for p in probs]
    cumul = sum(probs)
    if cumul <= 0:
        raise LagarithError("LAGS: empty probability table")
    scale = _av_log2(cumul)
    if cumul & (cumul - 1):
        scale += 1
        if scale >= 32:
            raise LagarithError("LAGS: probability scale overflow")
        target = 1 << scale
        scaled = [(p * target) // cumul for p in probs]
        deficit = target - sum(scaled)
        if deficit < 0:
            raise LagarithError("LAGS: scaled probabilities overflow")
        cycle = [i for i in range(128) if scaled[i]] \
            or [i for i in range(256) if scaled[i]]
        k = 0
        while deficit > 0:
            scaled[cycle[k % len(cycle)]] += 1
            deficit -= 1
            k += 1
        probs = scaled
    cum = [0] * 257
    for i in range(256):
        cum[i + 1] = cum[i] + probs[i]
    return cum, scale


# -- range decoder ------------------------------------------------------------

def _calc_zero_run(x):
    """Zigzag byte -> run length (lag_calc_zero_run)."""
    x &= 0xFF
    if x & 0x80:
        x -= 256
    return ((x * 2) ^ (x >> 7)) & 0xFF


def _zero_run_byte(run):
    """Inverse zigzag: run length 0..255 -> escape symbol byte."""
    if run & 1:
        return (-(run + 1) // 2) & 0xFF
    return run >> 1


class _RacDecoder:
    """Carry-less static-model range decoder (libavcodec lag_rac).

    The bytestream is globally shifted right one bit: init consumes the
    top 7 bits of byte 0, each refill consumes the next 8 bits spanning
    a byte boundary.
    """

    def __init__(self, data, start, end, cum, scale):
        self.d = data
        self.pos = start
        self.end = end
        self.cum = cum
        self.scale = scale
        self.range = 0x80
        self.low = (data[start] >> 1) if start < len(data) else 0
        self.overread = 0

    def _refill(self):
        d, n = self.d, len(self.d)
        while self.range <= _TOP:
            self.low = (self.low << 8) & 0xFFFFFFFFFF
            self.range <<= 8
            b0 = d[self.pos] if self.pos < n else 0
            b1 = d[self.pos + 1] if self.pos + 1 < n else 0
            self.low |= 0xFF & (((b0 << 8) | b1) >> 1)
            if self.pos < self.end:
                self.pos += 1
            else:
                self.overread += 1
                if self.overread > 16:
                    raise LagarithError("LAGS: range coder overread")

    def get(self):
        self._refill()
        cum = self.cum
        rs = self.range >> self.scale
        if self.low < rs * cum[255]:
            low_scaled = self.low // rs
            # binary search the cumulative table (libavcodec uses a
            # radix hash + linear scan; same result)
            lo, hi = 0, 255
            while lo < hi:
                mid = (lo + hi + 1) >> 1
                if cum[mid] <= low_scaled:
                    lo = mid
                else:
                    hi = mid - 1
            val = lo
        else:
            val = 255
        self.low -= rs * cum[val]
        if val != 255:
            self.range = rs * (cum[val + 1] - cum[val])
        else:
            self.range -= rs * cum[255]
        return val


class _RacEncoder:
    """Exact mirror of _RacDecoder: simulates its (range, refill)
    schedule and accumulates the interval lows into one big integer,
    which IS the byte stream (choosing remainder 0), with the global
    1-bit shift applied at the end."""

    def __init__(self, cum, scale):
        self.cum = cum
        self.scale = scale
        self.range = 0x80
        self.acc = 0          # bignum: sum of sub_j << bits-after-j
        self.refills = 0

    def _refill(self):
        while self.range <= _TOP:
            self.range <<= 8
            self.acc <<= 8
            self.refills += 1

    def put(self, val):
        self._refill()
        cum = self.cum
        rs = self.range >> self.scale
        self.acc += rs * cum[val]
        if val != 255:
            self.range = rs * (cum[val + 1] - cum[val])
        else:
            self.range -= rs * cum[255]

    def finish(self):
        """Byte stream the decoder consumes (first bit is the global
        shift pad)."""
        nbytes = self.refills + 1
        total_bits = 7 + 8 * self.refills
        if self.acc >= (1 << total_bits):
            raise LagarithError("LAGS: rac accumulator overflow")
        v = self.acc << (8 * nbytes - total_bits)   # 1 pad bit (MSB)
        return v.to_bytes(nbytes, "big"), nbytes


# -- per-plane decode ---------------------------------------------------------

class _PlaneState:
    """zeros / zeros_rem counters persist across rows within a plane."""

    def __init__(self):
        self.zeros = 0
        self.zeros_rem = 0


def _decode_rac_line(rac, dst, width, esc_num, st):
    i = 0
    read = 0
    while True:
        if st.zeros_rem:
            count = min(st.zeros_rem, width - i)
            dst[i:i + count] = 0
            i += count
            st.zeros_rem -= count
        while i < width:
            v = rac.get()
            dst[i] = v
            read += 1
            st.zeros = 0 if v else st.zeros + 1
            i += 1
            if st.zeros == esc_num:
                idx = rac.get()
                read += 1
                st.zeros = 0
                st.zeros_rem = _calc_zero_run(idx)
                break
        else:
            return read
        if i >= width and not st.zeros_rem:
            return read


def _pred_line(row, prev, prev2, line):
    """Apply median prediction in place (lag_pred_line, planar path)."""
    W = len(row)
    if line == 0:
        acc = int(row[0])
        for i in range(1, W):
            acc = (acc + int(row[i])) & 0xFF
            row[i] = acc
        return
    L = int(prev[W - 1])
    if line == 1:
        TL = int(prev[0])
    else:
        TL = int(prev2[W - 1])
    _add_median_pred(row, prev, L, TL)


def _add_median_pred(row, top, L, TL):
    W = len(row)
    for i in range(W):
        T = int(top[i])
        pred = _mid_pred(L, T, L + T - TL)
        L = (int(row[i]) + pred) & 0xFF
        row[i] = L
        TL = T


def _mid_pred(a, b, c):
    if a > b:
        a, b = b, a
    return min(b, max(a, c))


_RC_MSG = {
    -1: "LAGS: malformed plane",
    -2: "LAGS: range coder overread",
    -3: "LAGS: zero-run-line plane coding is unsupported; "
        "pre-transcode with ffmpeg",
    -4: "LAGS: invalid escape code",
}


def decode_plane(src, spos, width, height, out=None, native=True):
    """One Lagarith plane starting at src[spos] -> uint8 [height, width].

    src is the whole frame buffer (planes may legally over-read into
    trailing bytes, as libavcodec allows).  Decode runs in the native
    core (lags_decode_plane in native/stitchcore.cpp) when available;
    the Python body below is the spec and the fallback
    (tests/test_lagarith.py asserts bit-identity between the two)."""
    if native:
        from ..ops import stitch_native as sn
        got = sn.lags_decode_plane(src, spos, width, height) \
            if sn.available() else None
        if got is not None:
            rc, arr = got
            if rc != 0:
                raise LagarithError(_RC_MSG.get(rc, f"LAGS: error {rc}"))
            if out is None:
                return arr
            out[:] = arr
            return out
    if out is None:
        out = np.empty((height, width), np.uint8)
    if len(src) - spos < 2:
        raise LagarithError("LAGS: truncated plane")
    esc = src[spos]
    st = _PlaneState()
    if esc < 4:
        if esc == 0:
            raise LagarithError("LAGS: invalid zero rle code")
        length = width * height
        offset = spos + 1
        hdr_len = struct.unpack_from("<I", src, offset)[0] \
            if len(src) - offset >= 4 else length
        if hdr_len < length:
            length = hdr_len
            offset += 4
        br = _BitReader(src, offset)
        probs = _read_probs(br)
        cum, scale = scale_prob_table(probs)
        rac_start = br.align_byte()
        rac = _RacDecoder(src, rac_start,
                          min(rac_start + length, len(src)), cum, scale)
        for r in range(height):
            _decode_rac_line(rac, out[r], width, esc, st)
        _apply_pred(out)
    elif esc == 4:
        spos += 1
        need = width * height
        if len(src) - spos < need:
            raise LagarithError("LAGS: truncated raw plane")
        out[:] = np.frombuffer(src, np.uint8, need,
                               spos).reshape(height, width)
        _apply_pred(out)
    elif esc < 8:
        # Zero-run-line coding: no encoder in the wild emits it and
        # libavcodec itself only carries an untestable reconstruction
        # ("request sample"), so scope it out explicitly rather than
        # decode it wrong.
        raise LagarithError(
            "LAGS: zero-run-line plane coding is unsupported; "
            "pre-transcode with ffmpeg")
    elif esc == 0xFF:
        out[:] = src[spos + 1] if spos + 1 < len(src) else 0
        return out
    else:
        raise LagarithError(f"LAGS: invalid escape code {esc:#x}")
    return out


def _apply_pred(plane):
    H, W = plane.shape
    for r in range(H):
        _pred_line(plane[r], plane[r - 1] if r else None,
                   plane[r - 2] if r >= 2 else None, r)


def _read_probs(br):
    probs = [0] * 256
    i = 0
    while i < 256:
        p = _read_prob_vlc(br)
        probs[i] = p
        if p == 0:
            run = _read_prob_vlc(br)
            run = min(run, 255 - i)
            i += run
        i += 1
    return probs


# -- frame-level API ----------------------------------------------------------

def decode_frame_gray(data, W, H, native=True):
    """One LAGS frame -> luma [H, W] (chroma planes are skipped — each
    plane is independently offset, the gray capture path never needs
    them; the reference's GRAY8 swscale does the same reduction)."""
    data = bytes(data)
    if not data:
        raise LagarithError("LAGS: empty frame")
    t = data[0]
    if t == FRAME_SOLID_GRAY:
        fill = data[1] if len(data) > 1 else 0
        return np.full((H, W), fill, np.uint8)
    if t == FRAME_ARITH_YV12:
        # [type][u32 chroma2 offset][u32 chroma3 offset], luma at byte 9
        if len(data) < 11:
            raise LagarithError("LAGS: truncated YV12 header")
        return decode_plane(data, 9, W, H, native=native)
    raise LagarithError(
        f"LAGS: unsupported frame type {t} (only YV12/solid-gray "
        "captures decode in-process; pre-transcode with ffmpeg)")


def decode_frame_planes(data, W, H):
    """Full YV12 decode -> (y [H,W], v [H/2,W/2], u [H/2,W/2]) in
    stream order (YV12 carries V before U).  Anchor-test surface."""
    data = bytes(data)
    t = data[0]
    cw, ch = (W + 1) // 2, (H + 1) // 2
    if t == FRAME_SOLID_GRAY:
        return (np.full((H, W), data[1], np.uint8),
                np.full((ch, cw), 128, np.uint8),
                np.full((ch, cw), 128, np.uint8))
    if t != FRAME_ARITH_YV12:
        raise LagarithError(f"LAGS: unsupported frame type {t}")
    off_2, off_3 = struct.unpack_from("<II", data, 1)
    y = decode_plane(data, 9, W, H)
    v = decode_plane(data, off_2, cw, ch)
    u = decode_plane(data, off_3, cw, ch)
    return y, v, u


# -- encoder (authoring/test path) --------------------------------------------

def _residual_plane(plane):
    """Inverse of _apply_pred: pixels -> median-prediction residuals."""
    plane = np.asarray(plane, np.uint8)
    H, W = plane.shape
    res = np.empty_like(plane)
    res[0, 0] = plane[0, 0]
    res[0, 1:] = plane[0, 1:] - plane[0, :-1]
    for r in range(1, H):
        row, prev = plane[r], plane[r - 1]
        L = int(prev[W - 1])
        TL = int(prev[0]) if r == 1 else int(plane[r - 2][W - 1])
        for i in range(W):
            T = int(prev[i])
            pred = _mid_pred(L, T, L + T - TL)
            res[r, i] = (int(row[i]) - pred) & 0xFF
            L = int(row[i])
            TL = T
    return res


def _symbolize(res, esc_num):
    """Residual plane -> rac symbol stream mirroring _decode_rac_line
    exactly (zero-run escapes after esc_num consecutive zeros)."""
    H, W = res.shape
    flat_rows = [res[r] for r in range(H)]
    syms = []
    st_zeros = 0
    zeros_rem = 0
    for r in range(H):
        row = flat_rows[r]
        i = 0
        while True:
            if zeros_rem:
                count = min(zeros_rem, W - i)
                if np.any(row[i:i + count]):
                    raise LagarithError("LAGS: internal run mismatch")
                i += count
                zeros_rem -= count
            while i < W:
                v = int(row[i])
                syms.append(v)
                st_zeros = 0 if v else st_zeros + 1
                i += 1
                if st_zeros == esc_num:
                    # count the zeros that follow (across rows), cap 255
                    run = 0
                    rr, ii = r, i
                    while run < 255:
                        if ii >= W:
                            rr += 1
                            ii = 0
                            if rr >= H:
                                break
                        if flat_rows[rr][ii] != 0:
                            break
                        run += 1
                        ii += 1
                    syms.append(_zero_run_byte(run))
                    st_zeros = 0
                    zeros_rem = run
                    break
            else:
                break
            if i >= W and not zeros_rem:
                break
    return syms


def _norm_probs(syms, scale=15):
    """Histogram -> probability table summing exactly to 2^scale (the
    decoder's softfloat branch then stays dormant), every used symbol
    >= 1."""
    hist = np.bincount(np.asarray(syms, np.int64), minlength=256)
    used = hist > 0
    total = int(hist.sum())
    tgt = 1 << scale
    raw = hist.astype(np.float64) * (tgt - int(used.sum())) / max(total, 1)
    probs = np.floor(raw).astype(np.int64)
    probs[used] += 1                      # every used symbol nonzero
    deficit = tgt - int(probs.sum())
    if deficit < 0:
        order = np.argsort(-probs)
        k = 0
        while deficit < 0:
            i = order[k % 256]
            if probs[i] > 1:
                probs[i] -= 1
                deficit += 1
            k += 1
    elif deficit > 0:
        order = np.argsort(-hist)
        for k in range(deficit):
            probs[order[k % int(max(used.sum(), 1))]] += 1
    assert int(probs.sum()) == tgt
    return [int(p) for p in probs]


def _write_probs(bw, probs):
    i = 0
    while i < 256:
        _write_prob_vlc(bw, probs[i])
        if probs[i] == 0:
            run = 0
            while i + 1 + run < 256 and probs[i + 1 + run] == 0:
                run += 1
            _write_prob_vlc(bw, run)
            i += run
        i += 1


def encode_plane(plane, esc_num=2, scale=15):
    """One plane -> Lagarith plane bytes (rac mode, falling back to raw
    residuals when the compressed form wouldn't fit the format's length
    constraints, and to solid fill for constant planes)."""
    plane = np.asarray(plane, np.uint8)
    H, W = plane.shape
    if plane.max(initial=0) == plane.min(initial=255):
        return bytes([0xFF, int(plane[0, 0]) if plane.size else 0])
    res = _residual_plane(plane)
    syms = _symbolize(res, esc_num)
    probs = _norm_probs(syms, scale)
    cum, sc = scale_prob_table(probs)
    assert sc == scale
    enc = _RacEncoder(cum, sc)
    for s in syms:
        enc.put(s)
    rac_bytes, nbytes = enc.finish()
    bw = _BitWriter()
    _write_probs(bw, probs)
    hdr = bw.align_byte()
    # The u32 length field doubles as the decoder's input-byte bound —
    # libavcodec sizes the rac window from it.  It must stay < W*H to
    # be recognized, and must cover the actual compressed bytes.
    length = max(nbytes + 2, len(syms))
    if length >= W * H:
        return bytes([4]) + res.tobytes()          # raw residuals
    out = bytes([esc_num]) + struct.pack("<I", length) + hdr + rac_bytes
    if len(out) >= W * H + 5:
        return bytes([4]) + res.tobytes()
    return out


def encode_frame(luma, esc_num=2, scale=15, chroma=None):
    """Gray frame [H, W] -> one FRAME_ARITH_YV12 Lagarith frame (flat
    chroma by default; pass chroma=(v, u) planes to exercise full YV12).
    Constant frames become FRAME_SOLID_GRAY."""
    luma = np.asarray(luma, np.uint8)
    H, W = luma.shape
    if chroma is None and luma.size and luma.max() == luma.min():
        return bytes([FRAME_SOLID_GRAY, int(luma[0, 0]), 0, 0])
    cw, ch = (W + 1) // 2, (H + 1) // 2
    if chroma is None:
        v = u = np.full((ch, cw), 128, np.uint8)
    else:
        v, u = (np.asarray(c, np.uint8) for c in chroma)
    py = encode_plane(luma, esc_num, scale)
    pv = encode_plane(v, esc_num, scale)
    pu = encode_plane(u, esc_num, scale)
    off_v = 9 + len(py)
    off_u = off_v + len(pv)
    head = bytes([FRAME_ARITH_YV12]) + struct.pack("<II", off_v, off_u)
    # trailing slack: libavcodec's refill may peek 1-2 bytes past the
    # final plane's rac window
    return head + py + pv + pu + b"\x00\x00"


def encode(frames, esc_num=2, scale=15):
    """frames [N, H, W] gray -> list of LAGS frame chunks."""
    return [encode_frame(np.asarray(f, np.uint8), esc_num, scale)
            for f in frames]
