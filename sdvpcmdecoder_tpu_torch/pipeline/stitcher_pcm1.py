"""PCM-1 data stitcher: single-frame NTSC reassembly.

Port of PCM1DataStitcher (pcm1datastitcher.{h,cpp}): rudimentary vertical
alignment via header service lines or manual per-field offsets, frame
trimming, line -> 3 sublines split, per-field deinterleave with the
zig-zag word-pair interleave, emphasis from header lines.

Port of sdvpcmdecoder_tpu/pipeline/stitcher_pcm1.py, line for line (numpy on the
host; the native calls go to the port's ops/stitch_native).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np

from ..formats import pcm1
from ..ops import pcm1_deint as di1
from .stitcher_stc007 import (SRV_NO, SRV_NEW_FILE, SRV_END_FILE,
                              SRV_FILLER, ORDER_TFF, ORDER_BFF,
                              SAMPLE_RATE_44100, SampleChunk)

SRV_HEADER = 6  # PCMLine SRVLINE_HEADER_LINE
LINES_PF = di1.LINES_PF_NTSC
SUBLINES_PF = LINES_PF * 3
MIN_GOOD_LINES_PF = LINES_PF * 4 // 5


class PCM1LineStore:
    """Struct-of-arrays for binarized PCM-1 lines (6 words + CRC)."""

    FIELDS = ("words", "source_crc", "frame_number", "line_number",
              "ref_level", "service", "bw_set", "forced_bad",
              "picked_left", "picked_right")

    def __init__(self, n):
        self.words = np.zeros((n, 6), dtype=np.int64)
        self.source_crc = np.zeros(n, dtype=np.int64)
        self.frame_number = np.zeros(n, dtype=np.int64)
        self.line_number = np.zeros(n, dtype=np.int64)
        self.ref_level = np.zeros(n, dtype=np.int64)
        self.service = np.zeros(n, dtype=np.int8)
        self.bw_set = np.zeros(n, dtype=bool)
        self.forced_bad = np.zeros(n, dtype=bool)
        self.picked_left = np.zeros(n, dtype=np.int64)
        self.picked_right = np.zeros(n, dtype=np.int64)
        self.words[:] = pcm1.BIT_RANGE_POS  # silent default
        self.source_crc[:] = (~pcm1.CRC_SILENT) & 0xFFFF

    def __len__(self):
        return len(self.source_crc)

    def take(self, idx):
        out = PCM1LineStore(0)
        for f in self.FIELDS:
            a = getattr(self, f)[idx]
            # Fancy indexing already copied; only slices are views.
            setattr(out, f, a.copy() if a.base is not None else a)
        # words/source_crc are copied unchanged -> the cached CRC
        # validity slices along with them.
        cv = getattr(self, "_crcv", None)
        if cv is not None:
            c = cv[idx]
            out._crcv = c.copy() if c.base is not None else c
        return out

    @staticmethod
    def concat(stores):
        out = PCM1LineStore(0)
        for f in PCM1LineStore.FIELDS:
            setattr(out, f, np.concatenate([getattr(s, f) for s in stores]))
        cvs = [getattr(s, "_crcv", None) for s in stores]
        if all(c is not None for c in cvs):
            out._crcv = np.concatenate(cvs)
        return out

    def crc_valid_ignore_forced(self):
        cached = getattr(self, "_crcv", None)
        if cached is None:
            from ..ops import stitch_native as _sn
            if _sn.available():
                calc = _sn.pcm_crc_rows(self.words, "pcm1").astype(np.int64)
            else:
                calc = np.asarray(pcm1.calc_crc(self.words, xp=np))
            cached = calc == self.source_crc
            self._crcv = cached
        return cached

    def invalidate_crc(self):
        self._crcv = None

    def crc_valid(self):
        return ~self.forced_bad & self.crc_valid_ignore_forced()

    @staticmethod
    def from_decoded(words, crc_read, frame_number, line_number,
                     ref_level=None, valid=None):
        n = len(crc_read)
        out = PCM1LineStore(n)
        out.words = np.asarray(words, np.int64).copy()
        out.source_crc = np.asarray(crc_read, np.int64).copy()
        out.frame_number = np.asarray(frame_number, np.int64).copy()
        out.line_number = np.asarray(line_number, np.int64).copy()
        out.bw_set[:] = True
        if ref_level is not None:
            out.ref_level = np.asarray(ref_level, np.int64).copy()
        if valid is not None:
            # Binarizer-verdict CRC cache priming (valid => CRC match
            # by construction; only invalid rows re-CRC).
            from .stitcher_pcm16x0 import _prime_crcv
            out._crcv = _prime_crcv(out.words, out.source_crc,
                                    np.asarray(valid, bool).reshape(-1),
                                    "pcm1")
        # Header/footer service lines (binarizer.cpp:1562-1566 ->
        # setServHeader): the fixed pattern with source CRC 0xCCCC anchors
        # vertical alignment and flags emphasis.
        hdr = np.asarray(pcm1.is_header(out.words, out.source_crc, xp=np))
        if hdr.any():
            out.service[hdr] = SRV_HEADER
        return out


@dataclass
class FrameAsmPCM1:
    frame_number: int = 0
    field_order: int = ORDER_TFF
    odd_top_data: int = 0
    odd_bottom_data: int = 0
    even_top_data: int = 0
    even_bottom_data: int = 0
    odd_data_lines: int = 0       # sublines
    even_data_lines: int = 0
    odd_valid_lines: int = 0
    even_valid_lines: int = 0
    odd_top_padding: int = 0
    odd_bottom_padding: int = 0
    even_top_padding: int = 0
    even_bottom_padding: int = 0
    odd_ref: int = 0
    even_ref: int = 0
    blocks_total: int = 0
    blocks_drop: int = 0
    samples_drop: int = 0
    blocks_fix_bp: int = 0
    emphasis: bool = False


class PCM1Stitcher:
    """Single-frame PCM-1 reassembler (doFrameReassemble equivalent)."""

    def __init__(self, field_order=ORDER_TFF, auto_offset=True,
                 odd_offset=0, even_offset=0):
        self.preset_field_order = field_order
        self.auto_offset = auto_offset
        self.preset_odd_offset = odd_offset
        self.preset_even_offset = even_offset
        self.out_chunks: list[SampleChunk] = []
        self.frame_log: list[FrameAsmPCM1] = []
        self.file_started = False

    def pop_samples(self):
        out = []
        for c in self.pop_sample_chunks():
            out.extend(c.to_pairs())
        return out

    def pop_sample_chunks(self):
        out = self.out_chunks
        self.out_chunks = []
        return out

    # -- trimming (findFrameTrim :202-571) --------------------------------
    def _find_trim(self, buf: PCM1LineStore, fr: FrameAsmPCM1):
        svc = buf.service
        from ..ops import stitch_native as _sn
        if _sn.available() and not (svc == SRV_HEADER).any():
            # Native one-pass scan (the PCM-16x0 pattern: rule B is
            # bw_set alone).  Header/emphasis service lines need the
            # per-parity good-row positions, so frames carrying them
            # (file boundaries) take the numpy path below.
            r = _sn.trim_scan(buf.line_number, buf.frame_number, svc,
                              buf.crc_valid_ignore_forced(),
                              buf.forced_bad, buf.bw_set,
                              fr.frame_number, rule_b_or_crc=False)
            self.file_start = bool(r[8])
            self.file_end = bool(r[9])
            self.header_present = False
            self.emphasis_set = False
            fr.even_top_data = fr.even_bottom_data = 0
            fr.odd_top_data = fr.odd_bottom_data = 0
            manual = not self.auto_offset
            if manual:
                fr.odd_top_data = 2 * self.preset_odd_offset + 1 \
                    if self.preset_odd_offset > 0 else 1
                fr.even_top_data = 2 * self.preset_even_offset + 2 \
                    if self.preset_even_offset > 0 else 2
            for name, base, good in (("even", 0, 12), ("odd", 4, 13)):
                skip_bad = int(r[good]) > MIN_GOOD_LINES_PF
                o = base if skip_bad else base + 2
                first, last = int(r[o]), int(r[o + 1])
                if first >= 0:
                    if not manual:
                        setattr(fr, f"{name}_top_data",
                                int(buf.line_number[first]))
                    setattr(fr, f"{name}_bottom_data",
                            int(buf.line_number[last]))
            return
        is_data = svc == SRV_NO
        crc_ok = buf.crc_valid()
        odd = (buf.line_number % 2) != 0
        mask = buf.frame_number == fr.frame_number
        self.file_start = bool(np.any((svc == SRV_NEW_FILE) & mask))
        self.file_end = bool(np.any((svc == SRV_END_FILE) & mask))
        # Header before first good data line in either field.
        self.header_present = False
        self.emphasis_set = False
        hdr = np.nonzero((svc == SRV_HEADER) & mask)[0]
        for parity in (False, True):
            good = np.nonzero(mask & is_data & crc_ok & (odd == parity))[0]
            h = hdr[(buf.line_number[hdr] % 2 != 0) == parity] \
                if len(hdr) else hdr
            if len(h) and (len(good) == 0 or h[0] < good[0]):
                self.header_present = True
            # Emphasis: header AFTER the last good data line (backwards
            # search :300-370 finds trailing header = emphasis marker).
            if len(h) and (len(good) == 0 or h[-1] > good[-1]):
                self.emphasis_set = True

        fr.even_top_data = fr.even_bottom_data = 0
        fr.odd_top_data = fr.odd_bottom_data = 0
        manual = not self.auto_offset
        if manual:
            fr.odd_top_data = 2 * self.preset_odd_offset + 1 \
                if self.preset_odd_offset > 0 else 1
            fr.even_top_data = 2 * self.preset_even_offset + 2 \
                if self.preset_even_offset > 0 else 2
        for parity, name in ((True, "odd"), (False, "even")):
            pm = mask & is_data & (odd == parity)
            good_cnt = int(np.sum(pm & crc_ok))
            skip_bad = good_cnt > MIN_GOOD_LINES_PF
            if skip_bad:
                pcm = pm & buf.crc_valid_ignore_forced()
            else:
                pcm = pm & buf.bw_set
            hits = np.nonzero(pcm)[0]
            if len(hits):
                if not manual:
                    setattr(fr, f"{name}_top_data",
                            int(buf.line_number[hits[0]]))
                setattr(fr, f"{name}_bottom_data",
                        int(buf.line_number[hits[-1]]))

    # -- field split (splitFrameToFields :609-809) ------------------------
    def _split_fields(self, buf: PCM1LineStore, fr: FrameAsmPCM1):
        svc_keep = (buf.service == SRV_NO) | (buf.service == SRV_FILLER)
        crc_ok = buf.crc_valid()
        odd = (buf.line_number % 2) != 0
        mask = (buf.frame_number == fr.frame_number) & svc_keep
        fields = {}
        for parity, name in ((True, "odd"), (False, "even")):
            top = getattr(fr, f"{name}_top_data")
            bottom = getattr(fr, f"{name}_bottom_data")
            pm = mask & (odd == parity)
            if not parity and top == bottom and top == 0:
                pm = pm & False
            else:
                pm = pm & (buf.line_number >= top) \
                    & (buf.line_number <= bottom)
            idx = np.nonzero(pm)[0][:LINES_PF]
            lines = buf.take(idx)
            # line -> 3 sublines (splitLineToSubline :571-607):
            # L,R pairs (L2,R2),(L4,R4),(L6,R6) share the line's CRC flag.
            n = len(idx)
            sub_left = lines.words[:, 0::2].reshape(-1)   # L2,L4,L6 per line
            sub_right = lines.words[:, 1::2].reshape(-1)
            sub_ok = np.repeat(crc_ok[idx], 3)
            sub_lines = np.repeat(lines.line_number, 3)
            fields[name] = dict(left=sub_left, right=sub_right,
                                valid=sub_ok, line_number=sub_lines)
            setattr(fr, f"{name}_data_lines", 3 * n)
            setattr(fr, f"{name}_valid_lines", int(np.sum(sub_ok)))
            ref = lines.ref_level
            v = crc_ok[idx]
            if v.any():
                setattr(fr, f"{name}_ref", int(ref[v].sum() // v.sum()))
            elif n:
                setattr(fr, f"{name}_ref", int(ref.sum() // n))
        return fields

    # -- padding (findFramePadding :809-926) ------------------------------
    def _find_padding(self, fr: FrameAsmPCM1):
        if self.auto_offset:
            if not self.header_present:
                fr.odd_bottom_padding = fr.even_bottom_padding = 0
                fr.odd_top_padding = (SUBLINES_PF - fr.odd_data_lines) // 3
                fr.even_top_padding = (SUBLINES_PF - fr.even_data_lines) // 3
            else:
                fr.odd_top_padding = fr.even_top_padding = 0
                fr.odd_bottom_padding = \
                    (SUBLINES_PF - fr.odd_data_lines) // 3
                fr.even_bottom_padding = \
                    (SUBLINES_PF - fr.even_data_lines) // 3
        else:
            fr.odd_top_padding = max(0, -self.preset_odd_offset)
            fr.even_top_padding = max(0, -self.preset_even_offset)
            fr.odd_bottom_padding = (SUBLINES_PF - fr.odd_data_lines) // 3 \
                - fr.odd_top_padding
            fr.even_bottom_padding = (SUBLINES_PF - fr.even_data_lines) \
                // 3 - fr.even_top_padding
        fr.field_order = self.preset_field_order

    # -- one frame --------------------------------------------------------
    def _try_steady_frame(self, buf: PCM1LineStore, fr: FrameAsmPCM1):
        """One native call for the steady PCM-1 frame
        (pcm1_steady_frame: trim scan, field split, the auto/manual
        padding math, both field deinterleaves with companding); the
        frame descriptor, stats and chunks are replayed HERE.  Frames
        with header/emphasis service lines or file tags defer to the
        unchanged path (bit-identity pinned by tests)."""
        from ..ops import stitch_native as _sn
        svc = buf.service
        if (not _sn.available() or not len(buf)
                or (svc == SRV_HEADER).any()):
            return False
        rc, rec, samples, wv, bok = _sn.pcm1_steady_frame(
            buf, fr.frame_number,
            self.preset_field_order == ORDER_TFF, self.auto_offset,
            self.preset_odd_offset, self.preset_even_offset)
        if rc != 0:
            return False
        self.file_start = False
        self.file_end = False
        self.header_present = False
        self.emphasis_set = False
        # _find_trim replay (the native branch's exact rules)
        fr.even_top_data = fr.even_bottom_data = 0
        fr.odd_top_data = fr.odd_bottom_data = 0
        manual = not self.auto_offset
        if manual:
            fr.odd_top_data = 2 * self.preset_odd_offset + 1 \
                if self.preset_odd_offset > 0 else 1
            fr.even_top_data = 2 * self.preset_even_offset + 2 \
                if self.preset_even_offset > 0 else 2
        trim = rec[_sn.P1_TRIM:_sn.P1_TRIM + 14]
        for name, base, good in (("even", 0, 12), ("odd", 4, 13)):
            skip_bad = int(trim[good]) > MIN_GOOD_LINES_PF
            o = base if skip_bad else base + 2
            first, last = int(trim[o]), int(trim[o + 1])
            if first >= 0:
                if not manual:
                    setattr(fr, f"{name}_top_data",
                            int(buf.line_number[first]))
                setattr(fr, f"{name}_bottom_data",
                        int(buf.line_number[last]))
        # _split_fields replay (counts + refs)
        fr.odd_data_lines = int(rec[_sn.P1_DATA])
        fr.odd_valid_lines = int(rec[_sn.P1_DATA + 1])
        fr.even_data_lines = int(rec[_sn.P1_DATA + 2])
        fr.even_valid_lines = int(rec[_sn.P1_DATA + 3])
        fr.odd_ref = int(rec[_sn.P1_REFS])
        fr.even_ref = int(rec[_sn.P1_REFS + 1])
        self._find_padding(fr)
        fr.emphasis = self.emphasis_set
        # chunks in emission order (735 pair rows per field)
        for qi in range(2):
            a = qi * 735
            fr.blocks_total += di1.INT_BLK_PER_FIELD
            fr.blocks_drop += int(rec[_sn.P1_CNT + 2 * qi])
            fr.samples_drop += int(rec[_sn.P1_CNT + 2 * qi + 1])
            v2 = wv[a:a + 735]
            self.out_chunks.append(SampleChunk(
                samples=samples[a:a + 735], valid=v2,
                fixed=np.zeros_like(v2), block_ok=bok[a:a + 735],
                sample_rate=SAMPLE_RATE_44100, emphasis=fr.emphasis))
        self.frame_log.append(dataclasses.replace(fr))
        return True

    def push_frame(self, buf: PCM1LineStore):
        data = buf.service == SRV_NO
        frames = buf.frame_number[data]
        fr = FrameAsmPCM1()
        fr.frame_number = int(frames[0]) if len(frames) else 0
        if self._try_steady_frame(buf, fr):
            return
        self._find_trim(buf, fr)
        fields = self._split_fields(buf, fr)
        self._find_padding(fr)
        fr.emphasis = self.emphasis_set
        if self.file_start and not self.file_started:
            self.out_chunks.append(SampleChunk.tag(SRV_NEW_FILE))
            self.file_started = True
        order = ("odd", "even") if fr.field_order == ORDER_TFF \
            else ("even", "odd")
        for name in order:
            self._deinterleave_field(fields[name], fr,
                                     getattr(fr, f"{name}_top_padding"),
                                     getattr(fr, f"{name}_bottom_padding"))
        self.frame_log.append(dataclasses.replace(fr))
        if self.file_end:
            self.out_chunks.append(SampleChunk.tag(SRV_END_FILE))
            self.file_started = False

    def _deinterleave_field(self, field, fr: FrameAsmPCM1, top_pad,
                            bottom_pad):
        n_data = len(field["left"])
        top = 3 * max(0, top_pad)
        # Assemble exactly SUBLINES_PF sublines: pad + data + pad.
        sl = np.zeros(SUBLINES_PF, dtype=np.int64)
        sr = np.zeros(SUBLINES_PF, dtype=np.int64)
        sv = np.zeros(SUBLINES_PF, dtype=bool)
        sl[:] = pcm1.BIT_RANGE_POS
        sr[:] = pcm1.BIT_RANGE_POS
        n_copy = min(n_data, SUBLINES_PF - top)
        sl[top:top + n_copy] = field["left"][:n_copy]
        sr[top:top + n_copy] = field["right"][:n_copy]
        sv[top:top + n_copy] = field["valid"][:n_copy]
        from ..ops import stitch_native as _sn
        fr.blocks_total += di1.INT_BLK_PER_FIELD
        if _sn.available():
            # One-pass native deinterleave + companding + stats (twin of
            # the numpy tail below, differential-tested).
            samples, v2, bok, bad, sdrop = _sn.pcm1_field_deint(sl, sr, sv)
            fr.blocks_drop += bad
            fr.samples_drop += sdrop
            self.out_chunks.append(SampleChunk(
                samples=samples, valid=v2, fixed=np.zeros_like(v2),
                block_ok=bok, sample_rate=SAMPLE_RATE_44100,
                emphasis=fr.emphasis))
            return
        out = di1.deinterleave_field(sl, sr, sv)
        left = np.asarray(pcm1.expand_sample(out["left"], xp=np))
        right = np.asarray(pcm1.expand_sample(out["right"], xp=np))
        v2 = np.repeat(out["valid"][:, None], 2, axis=1)
        self.out_chunks.append(SampleChunk(
            samples=np.stack([left, right], axis=1),
            valid=v2, fixed=np.zeros_like(v2),
            block_ok=np.asarray(out["block_valid"], bool),
            sample_rate=SAMPLE_RATE_44100, emphasis=fr.emphasis))
        bad_blocks = np.unique(
            np.nonzero(~out["block_valid"])[0] // di1.BLOCK_PAIRS)
        fr.blocks_drop += len(bad_blocks)
        fr.samples_drop += int(np.sum(~out["valid"]))

    def finish(self):
        pass
