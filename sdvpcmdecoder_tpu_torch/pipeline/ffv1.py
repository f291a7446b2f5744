"""In-process FFV1 (version 3) codec — the archival lossless codec
(FFmpeg's own, RFC 9043) that tape-digitization workflows use when they
are not using the VfW trio (HuffYUV/Lagarith/Ut Video).  The reference
decodes it through libav (ffmpegwrapper.cpp:543); this module removes
the external-binary dependency.

Scope: FFV1 version 3, 8-bit, colorspace 0 (YCbCr/gray), progressive.
Both slice content coders decode:

  * Golomb-Rice (coder_type 0, what FFmpeg emits by default): adaptive
    per-context k via (count, drift, bias, error_sum) state machines,
    JPEG-LS-style run mode in context 0, MSB-first bit reader;
  * the binary adaptive range coder (coder_type 1/2): 8-bit states per
    context bit with the transmitted (or derived) state-transition
    table.

Layout follows the spec exactly: range-coded extradata (quant tables as
run-coded symbol streams, CRC-32/IEEE over the whole record == 0), the
per-frame keyframe bit, range-coded slice headers, per-slice trailers
(24-bit BE size + optional CRC), and context carry-over on
non-keyframes (FFmpeg's default GOP > 1 means frames after the first
reuse every slice's adapted contexts — `Decoder` is therefore stateful
and decodes sequentially; `reset()` rewinds to the stream start).

The encoder is the authoring/test path (write_avi(codec="FFV1")): it
emits version 3 with the range coder, one slice, intra-only keyframes.
Conformance is pinned empirically in BOTH directions against
libavcodec (OpenCV's bundled ffmpeg encodes AND decodes FFV1 —
tests/test_ffv1.py): their default Golomb streams decode bit-exact
here, and our range-coder streams decode bit-exact there.

Reference scope: ffmpegwrapper.cpp:543 (slotOpenInput accepts any
libav-decodable capture); bitstream per RFC 9043 as implemented by
libavcodec's ffv1 decoder.

Carried over from sdvpcmdecoder_tpu/pipeline/ffv1.py (numpy).  The
native decode is the port's ops/stitch_native binding; the Python decoder
runs only under SDV_NO_NATIVE=1 (a failed build of the core raises).
"""
from __future__ import annotations

import struct

import numpy as np


class FFV1Error(ValueError):
    pass


# run-length code table (ff_log2_run)
LOG2_RUN = (0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3,
            4, 4, 5, 5, 6, 6, 7, 7, 8, 9, 10, 11, 12, 13, 14, 15,
            16, 17, 18, 19, 20, 21, 22, 23, 24)

CONTEXT_SIZE = 32          # rac state bytes per context
GOLOMB_LIMIT = 12          # ur-golomb escape threshold


# -- CRC-32/IEEE (MSB-first, poly 0x04C11DB7, init 0) -------------------------

_CRC_TAB = None


def _crc_table():
    global _CRC_TAB
    if _CRC_TAB is None:
        tab = np.zeros(256, np.uint32)
        for i in range(256):
            c = i << 24
            for _ in range(8):
                c = ((c << 1) ^ 0x04C11DB7) if c & 0x80000000 else (c << 1)
                c &= 0xFFFFFFFF
            tab[i] = c
        _CRC_TAB = tab
    return _CRC_TAB


def crc32_ieee(data, crc=0):
    tab = _crc_table()
    for b in bytes(data):
        crc = ((crc << 8) & 0xFFFFFFFF) ^ int(tab[((crc >> 24) ^ b) & 0xFF])
    return crc


# -- range coder ---------------------------------------------------------------

def _build_rac_states():
    """Default state-transition tables (factor 0.05, max_p 248)."""
    one = 1 << 32
    factor = int(0.05 * one)
    max_p = 256 - 8
    one_state = [0] * 256
    last_p8 = 0
    p = one // 2
    for _ in range(128):
        p8 = (256 * p + one // 2) >> 32
        if p8 <= last_p8:
            p8 = last_p8 + 1
        if last_p8 and last_p8 < 256 and p8 <= max_p:
            one_state[last_p8] = p8
        p += ((one - p) * factor + one // 2) >> 32
        last_p8 = p8
    for i in range(256 - max_p, max_p + 1):
        if one_state[i]:
            continue
        p = (i * one + 128) >> 8
        p += ((one - p) * factor + one // 2) >> 32
        p8 = (256 * p + one // 2) >> 32
        if p8 <= i:
            p8 = i + 1
        if p8 > max_p:
            p8 = max_p
        one_state[i] = p8
    zero_state = [0] * 256
    for i in range(1, 255):
        zero_state[i] = 256 - one_state[256 - i]
    return tuple(zero_state), tuple(one_state)


_ZERO_STATE, _ONE_STATE = _build_rac_states()


class RangeDecoder:
    """libavcodec RangeCoder, decode side."""

    def __init__(self, buf, one_state=None):
        self.buf = buf
        self.pos = 2
        self.low = ((buf[0] << 8) | buf[1]) if len(buf) >= 2 else 0
        self.range = 0xFF00
        self.overread = 0
        if one_state is None:
            self.one = _ONE_STATE
            self.zero = _ZERO_STATE
        else:
            self.one = tuple(one_state)
            zero = [0] * 256
            for i in range(1, 255):
                zero[i] = 256 - self.one[256 - i]
            self.zero = tuple(zero)

    def get_rac(self, state, i):
        s = int(state[i])
        r1 = (self.range * s) >> 8
        self.range -= r1
        if self.low < self.range:
            state[i] = self.zero[s]
            bit = 0
        else:
            self.low -= self.range
            self.range = r1
            state[i] = self.one[s]
            bit = 1
        if self.range < 0x100:
            self.range <<= 8
            self.low = (self.low << 8) & 0xFFFFFFFF
            if self.pos < len(self.buf):
                self.low += self.buf[self.pos]
                self.pos += 1
            else:
                self.overread += 1
                if self.overread > 64:
                    raise FFV1Error("FFV1: range coder overread")
        return bit

    def get_symbol(self, state, signed):
        if self.get_rac(state, 0):
            return 0
        e = 0
        while self.get_rac(state, 1 + min(e, 9)):
            e += 1
            if e > 31:
                raise FFV1Error("FFV1: corrupt symbol")
        a = 1
        for i in range(e - 1, -1, -1):
            a += a + self.get_rac(state, 22 + min(i, 9))
        if signed and self.get_rac(state, 11 + min(e, 10)):
            return -a
        return a


class RangeEncoder:
    """libavcodec RangeCoder, encode side (carry via outstanding
    bytes), with the default state-transition tables."""

    def __init__(self):
        self.out = bytearray()
        self.low = 0
        self.range = 0xFF00
        self.outstanding_count = 0
        self.outstanding_byte = -1
        self.one = _ONE_STATE
        self.zero = _ZERO_STATE

    def _renorm(self):
        while self.range < 0x100:
            if self.outstanding_byte < 0:
                self.outstanding_byte = self.low >> 8
            elif self.low <= 0xFF00:
                self.out.append(self.outstanding_byte)
                self.out.extend(b"\xFF" * self.outstanding_count)
                self.outstanding_count = 0
                self.outstanding_byte = self.low >> 8
            elif self.low >= 0x10000:
                self.out.append(self.outstanding_byte + 1)
                self.out.extend(b"\x00" * self.outstanding_count)
                self.outstanding_count = 0
                self.outstanding_byte = (self.low >> 8) & 0xFF
            else:
                self.outstanding_count += 1
            self.low = (self.low & 0xFF) << 8
            self.range <<= 8

    def put_rac(self, state, i, bit):
        s = int(state[i])
        r1 = (self.range * s) >> 8
        if bit:
            self.low += self.range - r1
            self.range = r1
            state[i] = self.one[s]
        else:
            self.range -= r1
            state[i] = self.zero[s]
        self._renorm()

    def put_symbol(self, state, v, signed):
        if v:
            a = abs(v)
            e = a.bit_length() - 1
            self.put_rac(state, 0, 0)
            if e <= 9:
                for i in range(e):
                    self.put_rac(state, 1 + i, 1)
                self.put_rac(state, 1 + e, 0)
                for i in range(e - 1, -1, -1):
                    self.put_rac(state, 22 + i, (a >> i) & 1)
                if signed:
                    self.put_rac(state, 11 + e, int(v < 0))
            else:
                for i in range(e):
                    self.put_rac(state, 1 + min(i, 9), 1)
                self.put_rac(state, 1 + 9, 0)
                for i in range(e - 1, -1, -1):
                    self.put_rac(state, 22 + min(i, 9), (a >> i) & 1)
                if signed:
                    self.put_rac(state, 11 + 10, int(v < 0))
        else:
            self.put_rac(state, 0, 1)

    def finish(self, version=0):
        """ff_rac_terminate: version 1 (FFV1 v3 slice content) first
        writes one zero bit with throwaway state 129 — the decoder
        reads it back and checks the consumed-byte count; then two
        forced renorm rounds flush every decided bit."""
        if version == 1:
            self.put_rac([129], 0, 0)
        self.range = 0xFF
        self.low += 0xFF
        self._renorm()
        self.range = 0xFF
        self._renorm()
        return bytes(self.out)


# -- MSB-first bit reader (golomb content) --------------------------------------

class BitReader:
    __slots__ = ("d", "pos", "n")

    def __init__(self, data):
        self.d = data
        self.pos = 0
        self.n = len(data) * 8

    def get_bits1(self):
        p = self.pos
        if p >= self.n:
            raise FFV1Error("FFV1: bitstream overrun")
        self.pos = p + 1
        return (self.d[p >> 3] >> (7 - (p & 7))) & 1

    def get_bits(self, k):
        v = 0
        for _ in range(k):
            v = (v << 1) | self.get_bits1()
        return v


def get_ur_golomb(gb, k, limit, esc_len):
    lz = 0
    while not gb.get_bits1():
        lz += 1
        if lz == limit:
            # escape: exactly `limit` zero bits consumed, then esc_len
            # raw payload bits (libavcodec LAST_SKIP_BITS(limit))
            return gb.get_bits(esc_len) + limit - 1
    return (lz << k) | gb.get_bits(k)


def get_sr_golomb(gb, k, limit, esc_len):
    v = get_ur_golomb(gb, k, limit, esc_len)
    return (v >> 1) ^ -(v & 1)


# -- adaptive golomb per-context state -------------------------------------------

def new_vlc_states(n):
    """[n, 4] int32: drift, error_sum, bias, count."""
    st = np.zeros((n, 4), np.int32)
    st[:, 1] = 4   # error_sum
    st[:, 3] = 1   # count
    return st


def _fold(diff, bits):
    diff &= (1 << bits) - 1
    if diff >= 1 << (bits - 1):
        diff -= 1 << bits
    return diff


def get_vlc_symbol(gb, st, ctx, bits):
    drift, error_sum, bias, count = (int(st[ctx, 0]), int(st[ctx, 1]),
                                     int(st[ctx, 2]), int(st[ctx, 3]))
    i = count
    k = 0
    while i < error_sum:
        k += 1
        i += i
    v = get_sr_golomb(gb, k, GOLOMB_LIMIT, bits)
    if (2 * drift + count) < 0:     # sign-flip bias (v ^= x >> 31)
        v = ~v
    ret = _fold(v + bias, bits)
    # update_vlc_state
    error_sum += abs(v)
    drift += v
    if count == 128:
        count >>= 1
        drift >>= 1
        error_sum >>= 1
    count += 1
    if drift <= -count:
        bias = max(bias - 1, -128)
        drift = max(drift + count, -count + 1)
    elif drift > 0:
        bias = min(bias + 1, 127)
        drift = min(drift - count, 0)
    st[ctx, 0] = drift
    st[ctx, 1] = error_sum
    st[ctx, 2] = bias
    st[ctx, 3] = count
    return ret


# -- stream configuration ---------------------------------------------------------

class StreamConfig:
    """Parsed FFV1 v3 extradata."""

    def __init__(self, extra):
        extra = bytes(extra)
        if len(extra) < 4:
            raise FFV1Error("FFV1: missing extradata")
        c = RangeDecoder(extra)
        state = [128] * CONTEXT_SIZE
        self.version = c.get_symbol(state, 0)
        if self.version != 3:
            raise FFV1Error(
                f"FFV1: unsupported version {self.version} (only v3 "
                "decodes in-process; pre-transcode with ffmpeg)")
        # the CRC footer exists for version > 2 only
        if crc32_ieee(extra) != 0:
            raise FFV1Error("FFV1: extradata CRC mismatch")
        self.micro_version = c.get_symbol(state, 0)
        self.ac = c.get_symbol(state, 0)
        self.state_transition = None
        if self.ac == 2:           # custom rac transition table
            tr = [0] * 256
            for i in range(1, 256):
                tr[i] = (c.get_symbol(state, 1) + _ONE_STATE[i]) & 0xFF
            self.state_transition = tr
        self.colorspace = c.get_symbol(state, 0)
        self.bits = c.get_symbol(state, 0)
        if self.colorspace != 0 or self.bits != 8:
            raise FFV1Error(
                "FFV1: only 8-bit YCbCr/gray decodes in-process; "
                "pre-transcode with ffmpeg")
        self.chroma_planes = c.get_rac(state, 0)
        self.chroma_h_shift = c.get_symbol(state, 0)
        self.chroma_v_shift = c.get_symbol(state, 0)
        self.transparency = c.get_rac(state, 0)
        if self.transparency:
            raise FFV1Error("FFV1: alpha plane unsupported in-process")
        self.plane_count = 2       # v<4 keeps 2 plane contexts for gray
        self.num_h_slices = 1 + c.get_symbol(state, 0)
        self.num_v_slices = 1 + c.get_symbol(state, 0)
        if self.num_h_slices * self.num_v_slices > 256:
            raise FFV1Error("FFV1: bad slice grid")
        self.quant_table_count = c.get_symbol(state, 0)
        if not 0 < self.quant_table_count <= 8:
            raise FFV1Error("FFV1: bad quant table count")
        self.quant_tables = []
        self.context_counts = []
        for _ in range(self.quant_table_count):
            qt, cc = _read_quant_tables(c)
            self.quant_tables.append(qt)
            self.context_counts.append(cc)
        self.initial_states = [None] * self.quant_table_count
        for t in range(self.quant_table_count):
            if c.get_rac(state, 0):
                # one SEPARATE 32-byte rac state array per context byte
                # k (libavcodec state2[k]), not a shared one
                st2 = [[128] * CONTEXT_SIZE
                       for _ in range(CONTEXT_SIZE)]
                cc = self.context_counts[t]
                ini = np.empty((cc, CONTEXT_SIZE), np.uint8)
                pred = [128] * CONTEXT_SIZE
                for j in range(cc):
                    for k in range(CONTEXT_SIZE):
                        pred[k] = (pred[k]
                                   + c.get_symbol(st2[k], 1)) & 0xFF
                        ini[j, k] = pred[k]
                self.initial_states[t] = ini
        if self.version > 2:
            self.ec = c.get_symbol(state, 0)
            self.intra = c.get_symbol(state, 0) \
                if self.micro_version > 2 else 0
        else:
            self.ec = 0
            self.intra = 0


def _read_quant_tables(c):
    """-> (quant_table [5, 256] int16, context_count)."""
    qt = np.zeros((5, 256), np.int16)
    context_count = 1
    for dim in range(5):
        state = [128] * CONTEXT_SIZE
        i = 0
        v = 0
        while i < 128:
            ln = c.get_symbol(state, 0) + 1
            if ln > 128 - i:
                raise FFV1Error("FFV1: corrupt quant table")
            for _ in range(ln):
                qt[dim, i] = v * context_count
                i += 1
            v += 1
        for i in range(1, 128):
            qt[dim, 256 - i] = -qt[dim, i]
        qt[dim, 128] = -int(qt[dim, 127])
        context_count *= 2 * v - 1
        if context_count > 32768:
            raise FFV1Error("FFV1: too many contexts")
    return qt, (context_count + 1) // 2


# -- slice geometry ---------------------------------------------------------------

def slice_bounds(cfg, W, H, sx, sy, sw, sh):
    x0 = sx * W // cfg.num_h_slices
    y0 = sy * H // cfg.num_v_slices
    x1 = (sx + sw) * W // cfg.num_h_slices
    y1 = (sy + sh) * H // cfg.num_v_slices
    return x0, y0, x1 - x0, y1 - y0


# -- decoder -----------------------------------------------------------------------

class _SliceState:
    """Per-slice adaptive contexts (persist across non-keyframes)."""

    def __init__(self):
        self.plane_qidx = None         # [plane_count]
        self.vlc = None                # golomb: list per plane
        self.rac_states = None         # rac: list per plane [cc, 32] u8


class Decoder:
    """Stateful sequential FFV1 decoder for one stream (context
    carry-over across non-keyframes requires in-order decode)."""

    def __init__(self, extra, W, H, native=True):
        self.cfg = StreamConfig(extra)
        self.W, self.H = W, H
        ns = self.cfg.num_h_slices * self.cfg.num_v_slices
        self.slices = [_SliceState() for _ in range(ns)]
        self.seen_keyframe = False
        self._native_ok = native and all(
            ini is None for ini in self.cfg.initial_states)
        self._native_state = None

    def reset(self):
        for s in self.slices:
            s.vlc = None
            s.rac_states = None
        self.seen_keyframe = False
        if self._native_state is not None:
            self._native_state[0][:] = -1

    def _native_decode(self, data):
        """Production path: ffv1_decode_frame_gray in the native core
        (this Python class is the spec; tests pin bit-identity).
        Returns None when the native core is unavailable."""
        from ..ops import stitch_native as sn
        if not sn.available():
            return None
        cfg = self.cfg
        if self._native_state is None:
            ns = cfg.num_h_slices * cfg.num_v_slices
            max_cc = max(cfg.context_counts)
            self._native_cfg = (
                cfg.ac, cfg.ec, cfg.version, cfg.micro_version,
                cfg.num_h_slices, cfg.num_v_slices,
                np.ascontiguousarray(np.stack(cfg.quant_tables),
                                     np.int16),
                np.asarray(cfg.context_counts, np.int32), max_cc,
                np.asarray(cfg.state_transition if cfg.ac == 2
                           else _ONE_STATE, np.uint8))
            self._native_state = (
                np.full(ns, -1, np.int32),
                np.zeros(ns * max_cc * 4, np.int32),
                np.zeros(ns * max_cc * 32, np.uint8))
        got = sn.ffv1_decode_frame_gray(
            data, self.W, self.H, self._native_cfg,
            (*self._native_state, self.seen_keyframe))
        if got is None:
            return None
        rc, keyframe, out = got
        if rc == -3:
            raise FFV1Error("FFV1: slice CRC mismatch")
        if rc == -2 and not keyframe and not self.seen_keyframe:
            raise FFV1Error("FFV1: stream does not start on a keyframe")
        if rc != 0:
            raise FFV1Error(f"FFV1: corrupt frame (rc={rc})")
        if keyframe:
            self.seen_keyframe = True
        return out, keyframe

    def decode_frame_gray(self, data):
        """-> (luma [H, W] u8, keyframe flag)."""
        if self._native_ok:
            got = self._native_decode(bytes(data))
            if got is not None:
                return got
            self._native_ok = False   # stay on one path per stream
        cfg = self.cfg
        data = bytes(data)
        if len(data) < 4:
            raise FFV1Error("FFV1: truncated frame")
        c = RangeDecoder(data, cfg.state_transition)
        keystate = [128]
        keyframe = c.get_rac(keystate, 0)
        if not keyframe and not self.seen_keyframe:
            raise FFV1Error("FFV1: stream does not start on a keyframe")
        if keyframe:
            self.seen_keyframe = True
        out = np.empty((self.H, self.W), np.uint8)
        # walk slice trailers from the end
        ns = cfg.num_h_slices * cfg.num_v_slices
        trailer = 3 + 5 * (1 if cfg.ec else 0) if cfg.version > 2 else 0
        pos_end = len(data)
        starts = []
        for i in range(ns - 1, -1, -1):
            if cfg.version > 2:
                if pos_end - trailer < 0:
                    raise FFV1Error("FFV1: truncated slice table")
                v = int.from_bytes(data[pos_end - trailer:
                                        pos_end - trailer + 3],
                                   "big") + trailer
            else:
                v = pos_end
            start = pos_end - v
            if start < 0:
                raise FFV1Error("FFV1: bad slice sizes")
            if cfg.ec and crc32_ieee(data[start:pos_end]) != 0:
                raise FFV1Error("FFV1: slice CRC mismatch")
            starts.append((start, pos_end))
            pos_end = start
        starts.reverse()
        for i, (start, end) in enumerate(starts):
            if i == 0:
                sc = c            # continues after the keyframe bit
                sc.buf = data[:end]   # refills stop at the slice end
            else:
                sc = RangeDecoder(data[start:end], cfg.state_transition)
            self._decode_slice(sc, data, start, end, i == 0, keyframe,
                               out)
        return out, bool(keyframe)

    def _decode_slice(self, c, data, start, end, is_first, keyframe,
                      out):
        cfg = self.cfg
        state = [128] * CONTEXT_SIZE
        sx = c.get_symbol(state, 0)
        sy = c.get_symbol(state, 0)
        sw = c.get_symbol(state, 0) + 1
        sh = c.get_symbol(state, 0) + 1
        if sx < 0 or sy < 0 or sx + sw > cfg.num_h_slices \
                or sy + sh > cfg.num_v_slices:
            raise FFV1Error("FFV1: bad slice position")
        x0, y0, w, h = slice_bounds(cfg, self.W, self.H, sx, sy, sw, sh)
        sl = self.slices[sy * cfg.num_h_slices + sx]
        qidx = []
        for _ in range(cfg.plane_count):
            idx = c.get_symbol(state, 0)
            if idx >= cfg.quant_table_count:
                raise FFV1Error("FFV1: bad quant table index")
            qidx.append(idx)
        c.get_symbol(state, 0)     # picture structure
        c.get_symbol(state, 0)     # sar num
        c.get_symbol(state, 0)     # sar den
        if keyframe or sl.plane_qidx != qidx:
            sl.plane_qidx = list(qidx)
            sl.vlc = [new_vlc_states(cfg.context_counts[i])
                      for i in qidx]
            sl.rac_states = []
            for i in qidx:
                ini = cfg.initial_states[i]
                cc = cfg.context_counts[i]
                if ini is not None:
                    sl.rac_states.append(ini.copy())
                else:
                    sl.rac_states.append(
                        np.full((cc, CONTEXT_SIZE), 128, np.uint8))
        # Luma is the FIRST plane of every slice, so the gray decode
        # path never needs to parse the chroma planes that may follow
        # it in the bitstream — it simply stops after plane 0 (the
        # reference's GRAY8 swscale does the same reduction).
        if cfg.ac:
            self._decode_plane_rac(c, sl, 0, out, x0, y0, w, h)
        else:
            # v3.2+ terminates the header rac with one flush bit
            # (state 129, ff_rac_terminate(c, 1)); the golomb content
            # starts right after the rac's consumed bytes
            if cfg.micro_version > 1:
                c.get_rac([129], 0)
            off = start + (c.pos - 1)
            gb = BitReader(data[off:end])
            self._decode_plane_golomb(gb, sl, 0, out, x0, y0, w, h)

    # -- plane decode (golomb) --------------------------------------------
    def _decode_plane_golomb(self, gb, sl, plane, out, x0, y0, w, h):
        cfg = self.cfg
        qt = cfg.quant_tables[sl.plane_qidx[plane]]
        st = sl.vlc[plane]
        bits = 8
        above = np.zeros(w + 6, np.int32)     # index 3 = x 0
        cur = np.zeros(w + 6, np.int32)
        run_index = 0
        q0, q1, q2, q3, q4 = (qt[0], qt[1], qt[2], qt[3], qt[4])
        five = bool(q3[127] or q4[127])
        for y in range(h):
            above, cur = cur, above
            cur[2] = above[3]                  # sample[1][-1] = last[0]
            above[w + 3] = above[w + 2]        # last[w] = last[w-1]
            run_mode = 0
            run_count = 0
            x = 0
            while x < w:
                L = int(cur[x + 2])
                LT = int(above[x + 2])
                T = int(above[x + 3])
                RT = int(above[x + 4])
                if five:
                    LL = int(cur[x + 1])
                    TT = int(cur[x + 3])       # two rows up (buffer reuse)
                    context = (int(q0[(L - LT) & 0xFF])
                               + int(q1[(LT - T) & 0xFF])
                               + int(q2[(T - RT) & 0xFF])
                               + int(q3[(LL - L) & 0xFF])
                               + int(q4[(TT - T) & 0xFF]))
                else:
                    context = (int(q0[(L - LT) & 0xFF])
                               + int(q1[(LT - T) & 0xFF])
                               + int(q2[(T - RT) & 0xFF]))
                sign = context < 0
                if sign:
                    context = -context
                if context == 0 and run_mode == 0:
                    run_mode = 1
                if run_mode:
                    if run_count == 0 and run_mode == 1:
                        if gb.get_bits1():
                            run_count = 1 << LOG2_RUN[run_index]
                            if x + run_count <= w:
                                run_index += 1
                        else:
                            if LOG2_RUN[run_index]:
                                run_count = gb.get_bits(
                                    LOG2_RUN[run_index])
                            else:
                                run_count = 0
                            if run_index:
                                run_index -= 1
                            run_mode = 2
                    run_count -= 1
                    if run_count < 0:
                        run_mode = 0
                        run_count = 0
                        diff = get_vlc_symbol(gb, st, context, bits)
                        if diff >= 0:
                            diff += 1
                    else:
                        diff = 0
                else:
                    diff = get_vlc_symbol(gb, st, context, bits)
                if sign:
                    diff = -diff
                a, b2 = (L, T) if L <= T else (T, L)
                pred = min(b2, max(a, L + T - LT))
                cur[x + 3] = (pred + diff) & 0xFF
                x += 1
            out[y0 + y, x0:x0 + w] = cur[3:w + 3]
        return

    # -- plane decode (range coder) -----------------------------------------
    def _decode_plane_rac(self, c, sl, plane, out, x0, y0, w, h):
        cfg = self.cfg
        qt = cfg.quant_tables[sl.plane_qidx[plane]]
        states = sl.rac_states[plane]
        above = np.zeros(w + 6, np.int32)
        cur = np.zeros(w + 6, np.int32)
        q0, q1, q2, q3, q4 = (qt[0], qt[1], qt[2], qt[3], qt[4])
        five = bool(q3[127] or q4[127])
        for y in range(h):
            above, cur = cur, above
            cur[2] = above[3]
            above[w + 3] = above[w + 2]
            for x in range(w):
                L = int(cur[x + 2])
                LT = int(above[x + 2])
                T = int(above[x + 3])
                RT = int(above[x + 4])
                if five:
                    LL = int(cur[x + 1])
                    TT = int(cur[x + 3])
                    context = (int(q0[(L - LT) & 0xFF])
                               + int(q1[(LT - T) & 0xFF])
                               + int(q2[(T - RT) & 0xFF])
                               + int(q3[(LL - L) & 0xFF])
                               + int(q4[(TT - T) & 0xFF]))
                else:
                    context = (int(q0[(L - LT) & 0xFF])
                               + int(q1[(LT - T) & 0xFF])
                               + int(q2[(T - RT) & 0xFF]))
                sign = context < 0
                if sign:
                    context = -context
                diff = c.get_symbol(states[context], 1)
                if sign:
                    diff = -diff
                a, b2 = (L, T) if L <= T else (T, L)
                pred = min(b2, max(a, L + T - LT))
                cur[x + 3] = (pred + diff) & 0xFF
            out[y0 + y, x0:x0 + w] = cur[3:w + 3]
        return


# -- encoder (authoring/test path: v3, range coder, 1 slice, intra) -------------

def _write_quant_table(enc, levels):
    """levels: the per-|difference| quantizer level list lev[0..127]
    (ascending).  Written as run lengths of constant value."""
    state = [128] * CONTEXT_SIZE
    i = 0
    v = 0
    while i < 128:
        ln = 0
        while i + ln < 128 and levels[i + ln] == v:
            ln += 1
        if ln == 0:
            raise FFV1Error("FFV1: quant levels must be ascending runs")
        enc.put_symbol(state, ln - 1, 0)
        i += ln
        v += 1


_ENC_LEVELS = [0] + [1, 2] + [3] * 4 + [4] * 8 + [5] * 113


def build_extradata(chroma_planes=False):
    """v3 extradata for the encoder's fixed configuration: 8-bit
    YCbCr (gray by default; chroma_planes adds 4:2:0 Cb/Cr), range
    coder, one slice, one 3-gradient quant table, ec=1, intra=1."""
    enc = RangeEncoder()
    state = [128] * CONTEXT_SIZE
    enc.put_symbol(state, 3, 0)       # version
    enc.put_symbol(state, 4, 0)       # micro_version
    enc.put_symbol(state, 1, 0)       # coder: range, default table
    enc.put_symbol(state, 0, 0)       # colorspace
    enc.put_symbol(state, 8, 0)       # bits
    enc.put_rac(state, 0, int(bool(chroma_planes)))
    enc.put_symbol(state, 1 if chroma_planes else 0, 0)  # h shift
    enc.put_symbol(state, 1 if chroma_planes else 0, 0)  # v shift
    enc.put_rac(state, 0, 0)          # transparency = 0
    enc.put_symbol(state, 0, 0)       # num_h_slices - 1
    enc.put_symbol(state, 0, 0)       # num_v_slices - 1
    enc.put_symbol(state, 1, 0)       # quant_table_count
    for dim in range(3):
        _write_quant_table(enc, _ENC_LEVELS)
    for dim in range(2):
        _write_quant_table(enc, [0] * 128)
    enc.put_rac(state, 0, 0)          # no initial states
    enc.put_symbol(state, 1, 0)       # ec = 1
    enc.put_symbol(state, 1, 0)       # intra = 1
    body = enc.finish()
    crc = crc32_ieee(body)
    return body + struct.pack(">I", crc)


def _enc_quant_table():
    qt = np.zeros((5, 256), np.int16)
    context_count = 1
    for dim in range(3):
        lev = _ENC_LEVELS
        for d in range(128):
            qt[dim, d] = lev[d] * context_count
        for d in range(1, 128):
            qt[dim, 256 - d] = -qt[dim, d]
        qt[dim, 128] = -int(qt[dim, 127])
        context_count *= 2 * lev[127] + 1
    return qt, (context_count + 1) // 2


class Encoder:
    """FFV1 v3 intra-only encoder (range coder, single slice; gray by
    default, chroma_planes adds 4:2:0 Cb/Cr — both chroma planes share
    the plane-1 context states, as the format requires)."""

    def __init__(self, W, H, chroma_planes=False):
        self.W, self.H = W, H
        self.chroma_planes = bool(chroma_planes)
        self.extradata = build_extradata(self.chroma_planes)
        self.qt, self.context_count = _enc_quant_table()

    def _encode_plane(self, enc, states, plane):
        H, W = plane.shape
        qt = self.qt
        q0, q1, q2 = qt[0], qt[1], qt[2]
        above = np.zeros(W + 6, np.int32)
        cur = np.zeros(W + 6, np.int32)
        for y in range(H):
            above, cur = cur, above
            cur[2] = above[3]
            above[W + 3] = above[W + 2]
            row = plane[y]
            for x in range(W):
                L = int(cur[x + 2])
                LT = int(above[x + 2])
                T = int(above[x + 3])
                RT = int(above[x + 4])
                context = (int(q0[(L - LT) & 0xFF])
                           + int(q1[(LT - T) & 0xFF])
                           + int(q2[(T - RT) & 0xFF]))
                sign = context < 0
                if sign:
                    context = -context
                a, b2 = (L, T) if L <= T else (T, L)
                pred = min(b2, max(a, L + T - LT))
                pix = int(row[x])
                diff = _fold(pix - pred, 8)
                if sign:
                    diff = -diff
                diff = _fold(diff, 8)
                enc.put_symbol(states[context], diff, 1)
                cur[x + 3] = pix

    def encode_frame(self, luma, chroma=None):
        luma = np.asarray(luma, np.uint8)
        H, W = luma.shape
        if (H, W) != (self.H, self.W):
            raise FFV1Error("FFV1: frame dims mismatch")
        enc = RangeEncoder()
        keystate = [128]
        enc.put_rac(keystate, 0, 1)        # keyframe (intra-only)
        state = [128] * CONTEXT_SIZE
        for _ in range(4):                 # sx, sy, sw-1, sh-1
            enc.put_symbol(state, 0, 0)
        enc.put_symbol(state, 0, 0)        # plane 0 quant idx
        enc.put_symbol(state, 0, 0)        # plane 1 quant idx
        enc.put_symbol(state, 0, 0)        # picture structure
        enc.put_symbol(state, 0, 0)        # sar num
        enc.put_symbol(state, 0, 0)        # sar den
        states = np.full((self.context_count, CONTEXT_SIZE), 128,
                         np.uint8)
        self._encode_plane(enc, states, luma)
        if self.chroma_planes:
            cw, ch = (W + 1) // 2, (H + 1) // 2
            if chroma is None:
                cb = cr = np.full((ch, cw), 128, np.uint8)
            else:
                cb, cr = (np.asarray(c, np.uint8) for c in chroma)
            cstates = np.full((self.context_count, CONTEXT_SIZE), 128,
                              np.uint8)
            self._encode_plane(enc, cstates, cb)
            self._encode_plane(enc, cstates, cr)
        body = enc.finish(version=1)
        size = len(body)
        trailer = struct.pack(">I", size)[1:]  # 24-bit BE size
        body += trailer + b"\x00"              # + status byte
        crc = crc32_ieee(body)
        return body + struct.pack(">I", crc)


def encode(frames):
    """frames [N, H, W] gray -> (extradata, [frame chunks])."""
    frames = np.asarray(frames, np.uint8)
    enc = Encoder(frames.shape[2], frames.shape[1])
    return enc.extradata, [enc.encode_frame(f) for f in frames]
