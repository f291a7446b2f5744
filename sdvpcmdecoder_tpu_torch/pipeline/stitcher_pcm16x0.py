"""PCM-16x0 data stitcher: SI/EI reassembly with padding auto-detection.

Port of PCM16X0DataStitcher (pcm16x0datastitcher.{h,cpp}), re-architected
around the vectorized deinterleaver: the SI padding sweep (trySIPadding
:1129-1557 / findSIPadding :1557-2246) scores all interleave blocks of a
padded field in one batched call; burst counters, the stats sort and the
control-bit stream decode (BIT_*_OFS :159-167, collectCtrlBitStats
:4745-4915) stay as host logic.

Scope notes vs the reference: EI (PCM-1630) decode is supported through
the same block op with the 490-subline offset and whole-frame interleave;
the inter-field padding search (findEIPadding :2649 / tryEIPadding :2379,
driven from findEIFrameStitching :3588) sweeps line paddings between the
two fields scoring blocks at every subline offset; the per-field
top-alignment redistribution (conditionEIFramePadding :2996 /
findEIDataAlignment :3467) is folded into the inter-field sweep since
the EI pairing only depends on relative field placement — pinned by a
differential test on asymmetric per-field top crops (the case the
reference's redistribution exists for): tests/test_ei_crop.py
test_ei_asymmetric_field_crops recovers bit-exact alignment.

Port of sdvpcmdecoder_tpu/pipeline/stitcher_pcm16x0.py, line for line (numpy on the
host; the native calls go to the port's ops/stitch_native).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np

from ..formats import pcm16x0
from ..ops import pcm16x0_deint as di16
from .stitcher_stc007 import (SRV_NO, SRV_NEW_FILE, SRV_END_FILE,
                              SRV_FILLER, ORDER_UNK, ORDER_TFF, ORDER_BFF,
                              SAMPLE_RATE_44100, SAMPLE_RATE_44056,
                              StitchStats, SampleChunk)

def _prime_crcv(words, source_crc, valid, fmt):
    """CRC-validity cache from the binarizer verdict: valid rows match
    by construction, invalid rows get the (rare) re-CRC for the
    collision-filter rejections whose read still matches."""
    crcv = valid.copy()
    inv = np.nonzero(~valid)[0]
    if len(inv):
        from ..ops import stitch_native as _sn
        w_inv = words[inv]
        if _sn.available():
            calc = _sn.pcm_crc_rows(w_inv, fmt).astype(np.int64)
        elif fmt == "pcm1":
            from ..formats import pcm1 as _p1
            calc = np.asarray(_p1.calc_crc(w_inv, xp=np))
        else:
            calc = np.asarray(pcm16x0.calc_crc(w_inv, xp=np))
        crcv[inv] = calc == source_crc[inv]
    return crcv


LINES_PF = 245                      # NTSC field (SI and EI use NTSC gear)
SUBLINES_PF = LINES_PF * 3
SI_TRUE_INTERLEAVE = di16.SI_OFS * 3        # 105 sublines per super-block
EI_TRUE_INTERLEAVE = (SUBLINES_PF * 2) // 3  # 490
MAX_PADDING_SI = di16.SI_OFS        # line padding sweep limit
MAX_BURST_SILENCE_SI = di16.SI_OFS - 1
MAX_BURST_UNCH_SI = di16.SI_OFS - 1
MAX_BURST_BROKEN = 1
# EI inter-field padding sweep (pcm16x0datastitcher.h:146-154).
MAX_PADDING_EI = 81                 # line padding sweep limit
MAX_BURST_SILENCE_EI = MAX_PADDING_EI * 3
MAX_BURST_UNCH_EI = MAX_PADDING_EI * 3
MIN_VALID_EI = EI_TRUE_INTERLEAVE // 3
MIN_GOOD_LINES_PF = LINES_PF * 4 // 5
STATS_DEPTH = 65
# Control-bit offsets within an interleave block (:159-167).
BIT_EMPHASIS_OFS, BIT_SAMPLERATE_OFS, BIT_MODE_OFS, BIT_CODE_OFS = 0, 3, 6, 9

FORMAT_SI, FORMAT_EI = 0, 1


class PCM16X0LineStore:
    """Struct-of-arrays of binarized PCM-16x0 SUBLINES."""

    FIELDS = ("words", "source_crc", "frame_number", "line_number",
              "line_part", "control_bit", "ref_level", "service", "bw_set",
              "forced_bad", "picked_left", "picked_right")

    def __init__(self, n):
        self.words = np.zeros((n, 3), dtype=np.int64)
        self.source_crc = np.zeros(n, dtype=np.int64)
        self.frame_number = np.zeros(n, dtype=np.int64)
        self.line_number = np.zeros(n, dtype=np.int64)
        self.line_part = np.zeros(n, dtype=np.int8)
        self.control_bit = np.zeros(n, dtype=bool)
        self.ref_level = np.zeros(n, dtype=np.int64)
        self.service = np.zeros(n, dtype=np.int8)
        self.bw_set = np.zeros(n, dtype=bool)
        self.forced_bad = np.zeros(n, dtype=bool)
        # Bit Picker edge-bit counts (hasPickedLeft/Right,
        # pcm16x0subline.h): the false-positive prescan's evidence.
        self.picked_left = np.zeros(n, dtype=np.int8)
        self.picked_right = np.zeros(n, dtype=np.int8)
        self.source_crc[:] = (~pcm16x0.CRC_SILENT) & 0xFFFF

    def __len__(self):
        return len(self.source_crc)

    @classmethod
    def silent_filler(cls, n):
        """Padding store whose rows read CRC-invalid by construction
        (source CRC is the deliberately mismatching ~CRC_SILENT), so the
        validity cache is primed without a native sweep."""
        out = cls(n)
        out._crcv = np.zeros(n, bool)
        return out

    def take(self, idx):
        out = PCM16X0LineStore(0)
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
        out = PCM16X0LineStore(0)
        for f in PCM16X0LineStore.FIELDS:
            setattr(out, f, np.concatenate([getattr(s, f) for s in stores]))
        cvs = [getattr(s, "_crcv", None) for s in stores]
        if all(c is not None for c in cvs):
            out._crcv = np.concatenate(cvs)
        return out

    def crc_valid_ignore_forced(self):
        # The trim/split/padding machinery asks many times per frame;
        # native batch CRC + cache (the LineStore pattern).
        cached = getattr(self, "_crcv", None)
        if cached is None:
            from ..ops import stitch_native as _sn
            if _sn.available():
                calc = _sn.pcm_crc_rows(self.words, "pcm16x0").astype(np.int64)
            else:
                calc = np.asarray(pcm16x0.calc_crc(self.words, xp=np))
            cached = calc == self.source_crc
            self._crcv = cached
        return cached

    def invalidate_crc(self):
        self._crcv = None

    def crc_valid(self):
        return ~self.forced_bad & self.crc_valid_ignore_forced()

    @staticmethod
    def from_decoded(words, crc_read, frame_number, line_number, line_part,
                     control_bit=None, picked_left=None,
                     picked_right=None, valid=None):
        n = len(crc_read)
        out = PCM16X0LineStore(n)
        out.words = np.asarray(words, np.int64).copy()
        out.source_crc = np.asarray(crc_read, np.int64).copy()
        out.frame_number = np.asarray(frame_number, np.int64).copy()
        out.line_number = np.asarray(line_number, np.int64).copy()
        out.line_part = np.asarray(line_part, np.int8).copy()
        if control_bit is not None:
            out.control_bit = np.asarray(control_bit, bool).copy()
        if picked_left is not None:
            out.picked_left = np.asarray(picked_left, np.int8).copy()
        if picked_right is not None:
            out.picked_right = np.asarray(picked_right, np.int8).copy()
        out.bw_set[:] = True
        if valid is not None:
            # Prime the CRC-validity cache from the binarizer verdict
            # (valid = syndrome==0 & read_ok: a valid subline IS a CRC
            # match); only the invalid rows need the re-CRC.
            out._crcv = _prime_crcv(out.words, out.source_crc,
                                    np.asarray(valid, bool).reshape(-1),
                                    "pcm16x0")
        return out


@dataclass
class FrameAsmPCM16X0:
    frame_number: int = 0
    field_order: int = ORDER_TFF
    ei_format: bool = False
    ei_detected: bool = False
    odd_top_data: int = 0
    odd_bottom_data: int = 0
    even_top_data: int = 0
    even_bottom_data: int = 0
    odd_data_lines: int = 0
    even_data_lines: int = 0
    odd_valid_lines: int = 0
    even_valid_lines: int = 0
    odd_padding: int = 0
    even_padding: int = 0
    inner_padding: int = 0          # EI inter-field padding (lines)
    padding_ok: bool = False
    silence: bool = False
    emphasis: bool = False
    code: bool = False
    sample_rate: int = SAMPLE_RATE_44100
    blocks_total: int = 0
    blocks_drop: int = 0
    blocks_broken: int = 0
    blocks_fix_p: int = 0
    samples_drop: int = 0


class PCM16X0Stitcher:
    """Single-frame PCM-16x0 reassembler with SI padding auto-detection."""

    def __init__(self, field_order=ORDER_TFF, fmt=FORMAT_SI, en_p=True,
                 mask_seams=True, preset_sample_rate=0, auto_fmt=False):
        self.preset_field_order = field_order
        self.fmt = fmt
        self.en_p = en_p
        self.mask_seams = mask_seams
        self.preset_sample_rate = preset_sample_rate
        # SI<->EI auto-switch from the control-bit MODE stream (the
        # reference exposes SI/EI as an auto/preset user mode).
        self.auto_fmt = auto_fmt
        self.out_chunks: list[SampleChunk] = []
        self.frame_log: list[FrameAsmPCM16X0] = []
        self.stats_padding: list[int] = []
        self.stats_order: list[int] = []
        # 65-deep control-bit histories (:240-243).
        self.stats_emph: list[bool] = []
        self.stats_rate: list[int] = []
        self.stats_code: list[bool] = []
        self.stats_mode: list[bool] = []
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

    # -- trim / split (mirrors PCM-1 flow with 16x0 specifics) ------------
    def _find_trim(self, buf, fr):
        from ..ops import stitch_native as _sn
        if _sn.available():
            # One native pass (service facts + per-parity trim rules);
            # rule B is bw_set ALONE here — lines that saw the data
            # window but failed CRC still bound the trim (vs STC-007's
            # markers|CRC rule).
            r = _sn.trim_scan(buf.line_number, buf.frame_number,
                              buf.service, buf.crc_valid_ignore_forced(),
                              buf.forced_bad, buf.bw_set,
                              fr.frame_number, rule_b_or_crc=False)
            self.file_start = bool(r[8])
            self.file_end = bool(r[9])
            for name, base, good in (("even", 0, 12), ("odd", 4, 13)):
                skip_bad = int(r[good]) > MIN_GOOD_LINES_PF * 3
                o = base if skip_bad else base + 2
                first, last = int(r[o]), int(r[o + 1])
                if first >= 0:
                    setattr(fr, f"{name}_top_data",
                            int(buf.line_number[first]))
                    setattr(fr, f"{name}_bottom_data",
                            int(buf.line_number[last]))
            return
        svc = buf.service
        mask = buf.frame_number == fr.frame_number
        self.file_start = bool(np.any((svc == SRV_NEW_FILE) & mask))
        self.file_end = bool(np.any((svc == SRV_END_FILE) & mask))
        is_data = svc == SRV_NO
        crc_ok = buf.crc_valid()
        odd = (buf.line_number % 2) != 0
        for parity, name in ((True, "odd"), (False, "even")):
            pm = mask & is_data & (odd == parity)
            good_cnt = int(np.sum(pm & crc_ok))
            skip_bad = good_cnt > MIN_GOOD_LINES_PF * 3
            pcm = pm & (buf.crc_valid_ignore_forced() if skip_bad
                        else buf.bw_set)
            hits = np.nonzero(pcm)[0]
            if len(hits):
                setattr(fr, f"{name}_top_data",
                        int(buf.line_number[hits[0]]))
                setattr(fr, f"{name}_bottom_data",
                        int(buf.line_number[hits[-1]]))

    def _split_fields(self, buf, fr):
        from ..ops import stitch_native as _sn
        if _sn.available():
            et, eb = fr.even_top_data, fr.even_bottom_data
            ot, ob = fr.odd_top_data, fr.odd_bottom_data
            r, ie, io_ = _sn.split_scan(
                buf.line_number, buf.frame_number, buf.service,
                buf.crc_valid_ignore_forced(), buf.forced_bad,
                fr.frame_number, et, eb, not (et == 0 and eb == 0),
                ot, ob, not (ot == 0 and ob == 0), SUBLINES_PF,
                want_idx=True)
            fields = {}
            for name, idx, base in (("even", ie, 1), ("odd", io_, 7)):
                fields[name] = buf.take(idx)
                setattr(fr, f"{name}_data_lines", int(r[base + 2]))
                setattr(fr, f"{name}_valid_lines", int(r[base + 5]))
            return fields
        svc_keep = (buf.service == SRV_NO) | (buf.service == SRV_FILLER)
        crc_ok = buf.crc_valid()
        odd = (buf.line_number % 2) != 0
        mask = (buf.frame_number == fr.frame_number) & svc_keep
        fields = {}
        for parity, name in ((True, "odd"), (False, "even")):
            top = getattr(fr, f"{name}_top_data")
            bottom = getattr(fr, f"{name}_bottom_data")
            pm = mask & (odd == parity)
            if top == bottom and top == 0:
                pm = pm & False
            else:
                pm = pm & (buf.line_number >= top) \
                    & (buf.line_number <= bottom)
            idx = np.nonzero(pm)[0][:SUBLINES_PF]
            fields[name] = buf.take(idx)
            setattr(fr, f"{name}_data_lines", len(idx))
            setattr(fr, f"{name}_valid_lines", int(np.sum(crc_ok[idx])))
        return fields

    # -- false-positive CRC prescan (:753-836) ----------------------------
    def prescan_false_pos(self, field: PCM16X0LineStore):
        """Faithful port of prescanForFalsePosCRCs
        (pcm16x0datastitcher.cpp:753-836): a video line whose ONLY valid
        subline is the LEFT part with picked-left bits (or only the
        RIGHT part with picked-right bits) probably read at wrong data
        coordinates with a false-positive CRC from the Bit Picker — the
        whole line is forced bad."""
        n = len(field)
        if n < 3:
            return field
        valid = field.crc_valid()
        # Part-triples sharing frame and line number, walked in part
        # sequence exactly like the reference (buffer integrity check).
        i0 = np.nonzero((field.line_part[:-2] == 0)
                        & (field.line_part[1:-1] == 1)
                        & (field.line_part[2:] == 2))[0]
        if len(i0) == 0:
            return field
        same = ((field.frame_number[i0] == field.frame_number[i0 + 1])
                & (field.frame_number[i0] == field.frame_number[i0 + 2])
                & (field.line_number[i0] == field.line_number[i0 + 1])
                & (field.line_number[i0] == field.line_number[i0 + 2]))
        i0 = i0[same]
        left_only = (valid[i0] & ~valid[i0 + 1] & ~valid[i0 + 2]
                     & (field.picked_left[i0] > 0))
        right_only = (~valid[i0] & ~valid[i0 + 1] & valid[i0 + 2]
                      & (field.picked_right[i0 + 2] > 0))
        hit = i0[left_only | right_only]
        for d in range(3):
            field.forced_bad[hit + d] = True
        return field

    # -- SI padding sweep (trySIPadding / findSIPadding) ------------------
    def _padded_field(self, field: PCM16X0LineStore, padding: int):
        if padding == 0:
            return field
        pad = PCM16X0LineStore.silent_filler(3 * padding)
        pad.frame_number[:] = field.frame_number[0] if len(field) else 0
        return PCM16X0LineStore.concat([pad, field])

    def try_si_padding(self, field: PCM16X0LineStore, padding: int):
        """Score one padding: returns (ok, StitchStats)."""
        q = self._padded_field(field, padding)
        S = len(q)
        n_groups = S // SI_TRUE_INTERLEAVE
        if n_groups == 0:
            return False, StitchStats(index=padding)
        i = np.arange(di16.SI_OFS)
        shifts = (np.arange(n_groups)[:, None] * SI_TRUE_INTERLEAVE
                  + i[None, :]).reshape(-1)
        orders = np.tile((i % 2) == 1, n_groups)
        res = di16.decode_blocks(q.words, q.crc_valid(), shifts, orders,
                                 ei=False, en_p=self.en_p, force_ecc=True)
        vmax, smax, umax, brk_total = _burst16_from_res(res)
        st = StitchStats(index=padding, valid=vmax, silent=smax,
                         unchecked=umax, broken=brk_total)
        ok = (brk_total < MAX_BURST_BROKEN and smax <= MAX_BURST_SILENCE_SI
              and umax <= MAX_BURST_UNCH_SI and vmax > 0)
        return ok, st

    def batched_si_padding_stats(self, field: PCM16X0LineStore,
                                 max_padding: int):
        """Score ALL SI paddings in one deinterleaver call: every padded
        queue is the master [max_padding*3 empties | field] viewed from a
        different start offset (the STC-007 batched_padding_stats trick,
        trySIPadding :1129/findSIPadding :1557).  Bit-identical to
        calling try_si_padding per pad."""
        pre = PCM16X0LineStore.silent_filler(3 * max_padding)
        if len(field):
            pre.frame_number[:] = field.frame_number[0]
        master = PCM16X0LineStore.concat([pre, field])
        mcrc = master.crc_valid()
        i = np.arange(di16.SI_OFS)
        shifts_all, orders_all, counts = [], [], []
        for p in range(max_padding):
            base = 3 * (max_padding - p)
            S = 3 * p + len(field)
            n_groups = S // SI_TRUE_INTERLEAVE
            counts.append(n_groups * di16.SI_OFS)
            if n_groups == 0:
                continue
            g = np.arange(n_groups)
            sh = (g[:, None] * SI_TRUE_INTERLEAVE + i[None, :]).ravel()
            shifts_all.append(base + sh)
            orders_all.append(np.tile(i % 2 == 1, n_groups))
        if not shifts_all:
            return [(False, StitchStats(index=p))
                    for p in range(max_padding)]
        res = di16.decode_blocks(
            master.words, mcrc, np.concatenate(shifts_all),
            np.concatenate(orders_all), ei=False, en_p=self.en_p,
            force_ecc=True)
        out = []
        ofs = 0
        for p, n in enumerate(counts):
            if n == 0:
                out.append((False, StitchStats(index=p)))
                continue
            sl = slice(ofs, ofs + n)
            vmax, smax, umax, bt = _burst16_from_res(res, sl)
            st = StitchStats(index=p, valid=vmax, silent=smax,
                             unchecked=umax, broken=bt)
            ok = (bt < MAX_BURST_BROKEN and smax <= MAX_BURST_SILENCE_SI
                  and umax <= MAX_BURST_UNCH_SI and vmax > 0)
            out.append((ok, st))
            ofs += n
        return out

    def find_zero_control_bit_offset(self, field: PCM16X0LineStore,
                                     from_top=True):
        """findZeroControlBitOffset (:868-1058): locate the interleave
        grid by the zeroed control bit repeating every 105 sublines.

        Returns the PART_LEFT subline offset of the best grid anchor, or
        -1. Vectorized: counts CRC-valid middle sublines with a zero
        control bit across all 7 interleave blocks for every candidate
        line offset.
        """
        S = len(field)
        if S < 3:
            return -1
        valid = field.crc_valid()
        n_lines = S // 3
        limit = min(n_lines, di16.SI_OFS * 3 // 2)
        mids = np.arange(n_lines) * 3 + 1  # PART_MIDDLE offsets
        if not from_top:
            mids = mids[::-1]
        best_cnt, best_ofs = 0, -1
        for k in range(limit):
            base = mids[k]
            cnt = 0
            for iblk in range(7):
                ofs = base + iblk * SI_TRUE_INTERLEAVE if from_top \
                    else base - iblk * SI_TRUE_INTERLEAVE
                if 0 <= ofs < S and valid[ofs] \
                        and not field.control_bit[ofs]:
                    cnt += 1
            if cnt > best_cnt:
                best_cnt, best_ofs = cnt, base - 1  # back to PART_LEFT
        return best_ofs if best_cnt > 0 else -1

    def padding_from_zero_offset(self, zero_ofs):
        """Interleave-grid padding (in lines) implied by a zero-bit
        anchor at PART_LEFT subline `zero_ofs`."""
        if zero_ofs < 0:
            return None
        rem = zero_ofs % SI_TRUE_INTERLEAVE
        return ((SI_TRUE_INTERLEAVE - rem) // 3) % di16.SI_OFS

    def find_si_padding(self, field: PCM16X0LineStore):
        """Sweep paddings, reference-style stats sort + accept rules."""
        # Clean zero-padding fast path first; otherwise score the whole
        # sweep in one batched call.
        ok0, st0 = self.try_si_padding(field, 0)
        if ok0 and st0.broken == 0:
            stats = [st0]
        else:
            stats = [st for _, st
                     in self.batched_si_padding_stats(field,
                                                      MAX_PADDING_SI)]
        order = sorted(stats, key=StitchStats.sort_key)
        best = order[0]
        if best.silent >= MAX_BURST_SILENCE_SI:
            return None, 0
        ambiguous = (best.unchecked > MAX_BURST_UNCH_SI
                     or best.valid == 0
                     or (len(order) > 1 and best.broken > 0
                         and not (best.broken < order[1].broken
                                  or best.valid > order[1].valid)))
        if ambiguous:
            # Zero-control-bit grid anchor as the alignment fallback
            # (findZeroControlBitOffset / estimateBlockNumber).
            z = self.find_zero_control_bit_offset(field)
            pad = self.padding_from_zero_offset(z)
            if pad is not None:
                _, st2 = self.try_si_padding(field, pad)
                if st2 is not None and st2.broken == 0 and st2.valid > 0:
                    return True, pad
            return False, 0
        return True, best.index

    # -- control-bit stream (collectCtrlBitStats :4745-4915) --------------
    def collect_ctrl_bit_stats(self, queues):
        """Decode the 129th-bit stream over the frame's assembled field
        queues: the control bit of the CRC-valid PART_MIDDLE subline at
        BIT_*_OFS of every interleave block, majority-voted across the
        frame (a zero bit votes "enabled"/44100/EI/code).

        Returns dict(emphasis, sample_rate, ei_format, code, valid) or
        None when the frame holds too few sublines."""
        if sum(len(q) for q in queues) < SUBLINES_PF:
            return None
        # Interleave-block bases are PER QUEUE (each padded field starts
        # its own block grid); fields longer than SUBLINES_PF contribute
        # extra blocks instead of shifting the second field's grid.  The
        # sampled bits sit at base+1+ofs with ofs <= 9 < 105, always
        # inside the base's own queue, so the queues are tallied in
        # place — no whole-frame concat.
        counts = {"emphasis": 0, "rate": 0, "mode": 0, "code": 0}
        votes = dict(counts)
        for q in queues:
            n_blk = len(q) // SI_TRUE_INTERLEAVE
            if n_blk == 0:
                continue
            bases = np.arange(n_blk) * SI_TRUE_INTERLEAVE
            valid = q.crc_valid()
            cb = q.control_bit
            for name, ofs in (("emphasis", BIT_EMPHASIS_OFS),
                              ("rate", BIT_SAMPLERATE_OFS),
                              ("mode", BIT_MODE_OFS),
                              ("code", BIT_CODE_OFS)):
                idx = bases + 1 + ofs
                v = valid[idx]
                counts[name] += int(v.sum())
                votes[name] += int((v & ~cb[idx]).sum())
        return dict(
            emphasis=votes["emphasis"] > counts["emphasis"] // 2,
            sample_rate=SAMPLE_RATE_44100
            if votes["rate"] > counts["rate"] // 2 else SAMPLE_RATE_44056,
            ei_format=votes["mode"] > counts["mode"] // 2,
            code=votes["code"] > counts["code"] // 2,
            valid=(counts["emphasis"] >= 2 and counts["rate"] >= 2
                   and counts["code"] >= 2))

    def update_ctrl_bit_stats(self, det):
        """updateCtrlBitStats: push detected flags into 65-deep history."""
        if det is None or not det["valid"]:
            return
        for key, hist in (("emphasis", self.stats_emph),
                          ("sample_rate", self.stats_rate),
                          ("code", self.stats_code),
                          ("ei_format", self.stats_mode)):
            hist.append(det[key])
            del hist[:-STATS_DEPTH]

    @staticmethod
    def _probable(hist, default):
        if not hist:
            return default
        return max(set(hist), key=hist.count)

    # -- frame processing -------------------------------------------------
    def _try_steady_frame(self, buf: PCM16X0LineStore):
        """One native call for the whole steady SI frame
        (pcm16x0_steady_frame: trim, split, false-positive prescan, the
        zero-padding fast path of findSIPadding, queue assembly,
        control-bit tally and the output stream); every frame-descriptor
        and stats transition is replayed HERE from the returned record.
        Returns False — mutating nothing — whenever the C side bails
        (file tags, pad-0 fast path fails) or the mode is EI, and the
        unchanged frame logic runs.  Bit-identity is pinned by
        tests/test_steady16.py."""
        from ..ops import stitch_native as _sn
        if self.fmt != FORMAT_SI or not _sn.available() or not len(buf):
            return False
        fr = FrameAsmPCM16X0()
        data = buf.service == SRV_NO
        frames = buf.frame_number[data]
        fr.frame_number = int(frames[0]) if len(frames) else 0
        fr.field_order = self.preset_field_order \
            if self.preset_field_order != ORDER_UNK else \
            (self.stats_order[-1] if self.stats_order else ORDER_TFF)
        rc, rec, samples, wv, wf, bok = _sn.pcm16x0_steady_frame(
            buf, fr.frame_number, fr.field_order == ORDER_TFF, self.en_p)
        if rc != 0:
            return False
        self.file_start = False
        self.file_end = False
        # _find_trim replay
        trim = rec[_sn.P16_TRIM:_sn.P16_TRIM + 14]
        for name, base, good in (("even", 0, 12), ("odd", 4, 13)):
            skip_bad = int(trim[good]) > MIN_GOOD_LINES_PF * 3
            o = base if skip_bad else base + 2
            first, last = int(trim[o]), int(trim[o + 1])
            if first >= 0:
                setattr(fr, f"{name}_top_data",
                        int(buf.line_number[first]))
                setattr(fr, f"{name}_bottom_data",
                        int(buf.line_number[last]))
        # _split_fields replay
        sp = rec[_sn.P16_SPLIT:_sn.P16_SPLIT + 13]
        fr.even_data_lines = int(sp[3])
        fr.even_valid_lines = int(sp[6])
        fr.odd_data_lines = int(sp[9])
        fr.odd_valid_lines = int(sp[12])
        # collect_ctrl_bit_stats replay (queues are always full fields
        # here, so the too-few-sublines None case cannot occur)
        c = rec[_sn.P16_CTRL:_sn.P16_CTRL + 8]
        det = dict(
            emphasis=int(c[1]) > int(c[0]) // 2,
            sample_rate=SAMPLE_RATE_44100
            if int(c[3]) > int(c[2]) // 2 else SAMPLE_RATE_44056,
            ei_format=int(c[5]) > int(c[4]) // 2,
            code=int(c[7]) > int(c[6]) // 2,
            valid=(int(c[0]) >= 2 and int(c[2]) >= 2 and int(c[6]) >= 2))
        self.update_ctrl_bit_stats(det)
        if det["valid"]:
            fr.emphasis = det["emphasis"]
            fr.code = det["code"]
            rate = det["sample_rate"]
            ei = det["ei_format"]
        else:
            fr.emphasis = self._probable(self.stats_emph, False)
            fr.code = self._probable(self.stats_code, False)
            rate = self._probable(self.stats_rate, SAMPLE_RATE_44100)
            ei = self._probable(self.stats_mode, False)
        fr.sample_rate = self.preset_sample_rate or rate
        fr.ei_detected = bool(ei)
        if self.auto_fmt and det["valid"] and ei:
            self.fmt = FORMAT_EI  # switch from the next frame
        # _si_field_queue bookkeeping (accepted paddings, both fields;
        # the C side swept findSIPadding's grid when pad-0 failed)
        fr.padding_ok = True
        for qi in range(2):
            self.stats_padding.append(int(rec[_sn.P16_PAD + qi]))
            self.stats_padding = self.stats_padding[-STATS_DEPTH:]
        # _stream_blocks bookkeeping + chunks
        fr.blocks_total += int(rec[_sn.P16_BTOTAL])
        fr.blocks_drop += int(rec[_sn.P16_CNT])
        fr.blocks_broken += int(rec[_sn.P16_CNT + 1])
        fr.blocks_fix_p += int(rec[_sn.P16_CNT + 2])
        fr.samples_drop += int(rec[_sn.P16_CNT + 3])
        b1, b2 = int(rec[_sn.P16_OUT]), int(rec[_sn.P16_OUT + 1])
        for a, b in ((0, b1), (b1, b1 + b2)):
            self.out_chunks.append(SampleChunk(
                samples=samples[a:b], valid=wv[a:b], fixed=wf[a:b],
                block_ok=bok[a:b], sample_rate=fr.sample_rate,
                emphasis=fr.emphasis))
        self.frame_log.append(dataclasses.replace(fr))
        return True

    def push_frame(self, buf: PCM16X0LineStore):
        if self._try_steady_frame(buf):
            return
        fr = FrameAsmPCM16X0()
        data = buf.service == SRV_NO
        frames = buf.frame_number[data]
        fr.frame_number = int(frames[0]) if len(frames) else 0
        fr.field_order = self.preset_field_order \
            if self.preset_field_order != ORDER_UNK else \
            (self.stats_order[-1] if self.stats_order else ORDER_TFF)
        fr.ei_format = self.fmt == FORMAT_EI
        self._find_trim(buf, fr)
        fields = self._split_fields(buf, fr)
        for name in ("odd", "even"):
            fields[name] = self.prescan_false_pos(fields[name])
        if self.file_start and not self.file_started:
            self.out_chunks.append(SampleChunk.tag(SRV_NEW_FILE))
            self.file_started = True
        order = ("odd", "even") if fr.field_order == ORDER_TFF \
            else ("even", "odd")
        if self.fmt == FORMAT_SI:
            # Assemble both padded field queues first, then decode the
            # frame's control-bit stream over them (the reference fills
            # the whole-frame conv_queue before collectCtrlBitStats).
            queues = [self._si_field_queue(fields[name], fr)
                      for name in order]
            det = self.collect_ctrl_bit_stats(queues)
            self.update_ctrl_bit_stats(det)
            if det is not None and det["valid"]:
                fr.emphasis = det["emphasis"]
                fr.code = det["code"]
                rate = det["sample_rate"]
                ei = det["ei_format"]
            else:
                fr.emphasis = self._probable(self.stats_emph, False)
                fr.code = self._probable(self.stats_code, False)
                rate = self._probable(self.stats_rate, SAMPLE_RATE_44100)
                ei = self._probable(self.stats_mode, False)
            fr.sample_rate = self.preset_sample_rate or rate
            fr.ei_detected = bool(ei)
            if self.auto_fmt and det is not None and det["valid"] and ei:
                # EI tape under an SI decode: switch from the next frame.
                self.fmt = FORMAT_EI
            for q in queues:
                self._stream_blocks(q, fr, ei=False)
        else:
            self._process_frame_ei(fields, order, fr)
        self.frame_log.append(dataclasses.replace(fr))
        if self.file_end:
            self.out_chunks.append(SampleChunk.tag(SRV_END_FILE))
            self.file_started = False

    def _si_field_queue(self, field: PCM16X0LineStore,
                        fr: FrameAsmPCM16X0) -> PCM16X0LineStore:
        """Padding detection + queue assembly for one SI field."""
        ok, padding = self.find_si_padding(field)
        if ok is None:
            fr.silence = True
            padding = 0
        else:
            fr.padding_ok = fr.padding_ok or bool(ok)
        if ok:
            self.stats_padding.append(padding)
            self.stats_padding = self.stats_padding[-STATS_DEPTH:]
        elif self.stats_padding:
            padding = max(set(self.stats_padding),
                          key=self.stats_padding.count)
        q = self._padded_field(field, padding)
        # Assemble a full field (fillFrameForOutput pads every field to
        # SUBLINES_PF; performDeinterleave consumes whole super-blocks).
        S = len(q)
        target = max(SUBLINES_PF, S + ((-S) % SI_TRUE_INTERLEAVE))
        target += (-target) % SI_TRUE_INTERLEAVE
        if target > S:
            q = PCM16X0LineStore.concat(
                [q, PCM16X0LineStore.silent_filler(target - S)])
        return q

    # -- EI inter-field padding (tryEIPadding :2379 / findEIPadding :2649)
    def _ei_queue(self, f1, f2, padding):
        """field1 + `padding` empty lines + field2, as padding_queue."""
        pad = PCM16X0LineStore.silent_filler(3 * padding)
        if len(f1):
            pad.frame_number[:] = f1.frame_number[-1] if len(f1) else 0
        return PCM16X0LineStore.concat([f1, pad, f2])

    def try_ei_padding(self, f1, f2, padding):
        """Score one inter-field padding: blocks at EVERY subline offset
        (the EI pairing i, i+490, i+980 has no modular grid), burst
        counters as tryEIPadding :2420-2610."""
        q = self._ei_queue(f1, f2, padding)
        S = len(q)
        n = S - 2 * di16.EI_OFS - 1
        if n <= 0:
            return StitchStats(index=padding)
        shifts = np.arange(n)
        orders = (shifts % 2) == 1
        res = di16.decode_blocks(q.words, q.crc_valid(), shifts, orders,
                                 ei=True, en_p=self.en_p, force_ecc=True)
        vmax, smax, umax, bmax = _burst_ei_from_res(res)
        return StitchStats(index=padding, valid=vmax, silent=smax,
                           unchecked=umax, broken=bmax)

    def batched_ei_padding_stats(self, f1, f2, paddings):
        """ALL inter-field paddings through ONE row-mapped decode call
        (the batching trick of batched_si_padding_stats applied to the
        EI sweep): each padding's blocks read the shared master buffer
        f1 + MAX empties + f2 via explicit row indices, so nothing is
        re-concatenated or re-CRC'd per padding.  Bit-identical to the
        serial try_ei_padding loop (tests/test_pcm16x0.py)."""
        paddings = list(paddings)
        if not paddings:
            return []
        maxpad = max(paddings)
        n1 = len(f1)
        master = PCM16X0LineStore.concat(
            [f1, PCM16X0LineStore.silent_filler(3 * maxpad), f2])
        crc = master.crc_valid()
        base = np.arange(3) * di16.EI_OFS
        row_chunks, eo_chunks, counts = [], [], []
        for pad in paddings:
            S = n1 + 3 * pad + len(f2)
            n = S - 2 * di16.EI_OFS - 1
            counts.append(max(n, 0))
            if n <= 0:
                continue
            qrows = np.arange(n)[:, None] + base[None, :]
            row_chunks.append(np.where(qrows < n1 + 3 * pad, qrows,
                                       qrows + 3 * (maxpad - pad)))
            eo_chunks.append((np.arange(n) % 2) == 1)
        if not row_chunks:
            return [StitchStats(index=p) for p in paddings]
        rows = np.concatenate(row_chunks)
        eo = np.concatenate(eo_chunks)
        res = di16.decode_blocks(master.words, crc, None, eo, ei=True,
                                 en_p=self.en_p, force_ecc=True,
                                 rows=rows)
        out = []
        ofs = 0
        for pad, n in zip(paddings, counts):
            if n == 0:
                out.append(StitchStats(index=pad))
                continue
            sl = slice(ofs, ofs + n)
            vmax, smax, umax, bmax = _burst_ei_from_res(res, sl)
            out.append(StitchStats(index=pad, valid=vmax, silent=smax,
                                   unchecked=umax, broken=bmax))
            ofs += n
        return out

    @staticmethod
    def _ei_accept(st):
        """findEIPadding accept rule for one padding's stats."""
        if st.unchecked > MAX_BURST_UNCH_EI \
                or st.silent >= MAX_BURST_SILENCE_EI:
            return False
        return st.broken == 0 and st.valid > MIN_VALID_EI

    def find_ei_padding(self, f1, f2, try_previous=True):
        """Sweep inter-field paddings; min-broken filter, then the stats
        sort and accept rules of findEIPadding :2793-2920.  A padding
        that already worked is re-tried FIRST and accepted without the
        81-wide sweep (STG_TRY_PREVIOUS of findEIFrameStitching :3610).
        Returns (ok, padding, stats)."""
        if not self.en_p:
            return False, 0, StitchStats()
        if try_previous and self.stats_padding:
            prev = max(set(self.stats_padding),
                       key=self.stats_padding.count)
            if 0 <= prev < MAX_PADDING_EI:
                st = self.try_ei_padding(f1, f2, prev)
                if self._ei_accept(st):
                    return True, prev, st
        stats = self.batched_ei_padding_stats(f1, f2,
                                              range(MAX_PADDING_EI))
        min_broken = min(st.broken for st in stats)
        cand = [st for st in stats
                if st.broken == min_broken and st.valid > 0]
        if not cand:
            return False, 0, StitchStats()
        cand.sort(key=StitchStats.sort_key)
        best = cand[0]
        if best.unchecked > MAX_BURST_UNCH_EI \
                or best.silent >= MAX_BURST_SILENCE_EI:
            return False, 0, best
        ok = min_broken == 0 and best.valid > MIN_VALID_EI
        return ok, best.index, best

    def _process_frame_ei(self, fields, order, fr):
        # Frame-border conditioning (conditionEIFramePadding :2996,
        # findEIDataAlignment :3467): the EI block grid — including its
        # even/odd pairing parity — anchors to the FRAME border.  A
        # capture cropped at the top of a field would otherwise shift the
        # grid by an odd number of sublines and silently flip the order;
        # restore each field's leading lines as empty padding derived
        # from the absolute line numbers.  The empties decode as erasures
        # and P-correction recovers the affected blocks.
        fields = dict(fields)
        for name, base in (("odd", 1), ("even", 2)):
            fld = fields[name]
            if not len(fld):
                continue
            top = int(fld.line_number[0])
            missing = (top - base) // 2
            if 0 < missing <= MAX_PADDING_EI:
                pre = PCM16X0LineStore(3 * missing)
                pre.frame_number[:] = fld.frame_number[0]
                pre.line_number = base + 2 * np.repeat(
                    np.arange(missing), 3)
                pre.line_part = np.tile(np.arange(3, dtype=np.int8),
                                        missing)
                fields[name] = PCM16X0LineStore.concat([pre, fld])
        f1, f2 = fields[order[0]], fields[order[1]]
        ok, pad, st1 = self.find_ei_padding(f1, f2)
        if self.preset_field_order == ORDER_UNK and not ok:
            # Field-order auto-detection: the reference's EI stage
            # machine falls through findEIPadding(TFF) to
            # findEIPadding(BFF) (:3813/:3884).
            ok2, pad2, st2 = self.find_ei_padding(f2, f1)
            if ok2:
                f1, f2 = f2, f1
                ok, pad = ok2, pad2
                fr.field_order = ORDER_BFF if fr.field_order == ORDER_TFF \
                    else ORDER_TFF
        if ok and self.preset_field_order == ORDER_UNK:
            self.stats_order.append(fr.field_order)
            self.stats_order = self.stats_order[-STATS_DEPTH:]
        if ok:
            fr.padding_ok = True
            self.stats_padding.append(pad)
            self.stats_padding = self.stats_padding[-STATS_DEPTH:]
        elif self.stats_padding:
            # STG_TRY_PREVIOUS: fall back to the most frequent padding
            # seen so far (getProbablePadding analog).
            pad = max(set(self.stats_padding), key=self.stats_padding.count)
        else:
            pad = 0
        fr.inner_padding = pad
        q = self._ei_queue(f1, f2, pad)
        S = len(q)
        need = EI_TRUE_INTERLEAVE * 3
        if S < need:
            q = PCM16X0LineStore.concat(
                [q, PCM16X0LineStore.silent_filler(need - S)])
        self._stream_blocks(q, fr, ei=True)

    def _stream_blocks(self, q, fr, ei):
        ofs = di16.EI_OFS if ei else di16.SI_OFS
        group = 3 * ofs
        n_groups = max(1, len(q) // group) if not ei else 1
        i = np.arange(ofs)
        shifts = (np.arange(n_groups)[:, None] * group
                  + i[None, :]).reshape(-1)
        orders = np.tile((i % 2) == 1, n_groups)
        res = di16.decode_blocks(q.words, q.crc_valid(), shifts, orders,
                                 ei=ei, en_p=self.en_p, force_ecc=True)
        B = len(shifts)
        fr.blocks_total += B * 3
        bv = res["block_valid"]
        broken = res["state"] == di16.AUD_BROKEN
        if "counters" in res:
            drop, brk, fixp, sdrop = (int(x) for x in res["counters"])
        else:
            drop = int(np.sum(~res["word_valid"][..., :2].all(axis=-1)))
            brk = int(np.sum(broken))
            fixp = int(np.sum(res["state"] == di16.AUD_FIX_P))
            sdrop = int(np.sum(~res["word_valid"][..., :2]))
        fr.blocks_drop += drop
        fr.blocks_broken += brk
        fr.blocks_fix_p += fixp
        fr.samples_drop += sdrop
        B3 = B * 3
        brk = broken.reshape(B3)
        wv = res["word_valid"][..., :2].reshape(B3, 2) & ~brk[:, None]
        bok = np.repeat(np.asarray(bv, bool), 3) & ~brk
        wf = res["word_crc"][..., :2].reshape(B3, 2) & bok[:, None]
        self.out_chunks.append(SampleChunk(
            samples=res["samples"].reshape(B3, 2), valid=wv, fixed=wf,
            block_ok=bok, sample_rate=fr.sample_rate,
            emphasis=fr.emphasis))

    def finish(self):
        pass


def _si_seam_flags(res):
    """Per-block flags for the SI burst counters (trySIPadding
    :1150-1420)."""
    silent = (res["samples"] == 0).all(axis=(-1, -2))
    bv = res["block_valid"]
    fixed_p = (res["state"] == di16.AUD_FIX_P).any(axis=-1)
    broken = (res["state"] == di16.AUD_BROKEN).any(axis=-1)
    no_check = (res["stage"] == di16.STG_NO_CHECK).any(axis=-1)
    valid_b = bv & ~silent & ~no_check
    unch = no_check | fixed_p
    return valid_b, silent, unch, broken


def _burst16_from_res(res, sl=slice(None)):
    """SI burst stats from a decode result — native packed-flag walk
    when the decode rode the native core, numpy twin otherwise."""
    if "flags" in res:
        from ..ops import stitch_native as _sn
        return _sn.pcm16x0_burst(res["flags"][sl], MAX_BURST_SILENCE_SI,
                                 MAX_BURST_UNCH_SI, False)
    valid_b, silent, unch, broken = _si_seam_flags(res)
    return _burst_stats16(valid_b[sl], silent[sl], unch[sl], broken[sl])


def _burst_ei_from_res(res, sl=slice(None)):
    """EI burst stats from a decode result (broken scores as max run)."""
    if "flags" in res:
        from ..ops import stitch_native as _sn
        return _sn.pcm16x0_burst(res["flags"][sl], MAX_BURST_SILENCE_EI,
                                 MAX_BURST_UNCH_EI, True)
    valid_b, silent, unch, broken = _si_seam_flags(res)
    return _burst_stats_ei(valid_b[sl], silent[sl], unch[sl], broken[sl])


def _burst_core(valid_b, silent, unch, broken, max_silence, max_unch,
                broken_as_run):
    """Shared 16x0 burst-counter core (cumsum formulation, verified
    against the serial transcriptions in tests/test_stitcher_vec.py):
    valid-run resets on silence run >= max_silence, unchecked run >
    max_unch, and every BROKEN block; `broken` scores as a total (SI,
    trySIPadding) or as its max run (EI, tryEIPadding)."""
    n = len(valid_b)
    if n == 0:
        return 0, 0, 0, 0
    idx = np.arange(n)

    def runs(mask):
        last_false = np.maximum.accumulate(np.where(~mask, idx, -1))
        return np.where(mask, idx - last_false, 0)

    sil_run = runs(silent)
    unch_run = runs(unch)
    reset = ((silent & (sil_run >= max_silence))
             | (unch & (unch_run > max_unch)) | broken)
    cumv = np.cumsum(valid_b.astype(np.int64))
    last_reset = np.maximum.accumulate(np.where(reset, idx, -1))
    base = np.where(last_reset >= 0, cumv[np.maximum(last_reset, 0)], 0)
    run_after = cumv - base
    prev_run = np.concatenate([[0], run_after[:-1]])
    cand = prev_run[~valid_b]
    vmax = int(max(cand.max() if len(cand) else 0, run_after[-1]))
    brk = int(runs(broken).max()) if broken_as_run else int(broken.sum())
    return vmax, int(sil_run.max()), int(unch_run.max()), brk


def _burst_stats16(valid_b, silent, unch, broken):
    return _burst_core(valid_b, silent, unch, broken,
                       MAX_BURST_SILENCE_SI, MAX_BURST_UNCH_SI, False)


def _burst_stats_ei(valid_b, silent, unch, broken):
    return _burst_core(valid_b, silent, unch, broken,
                       MAX_BURST_SILENCE_EI, MAX_BURST_UNCH_EI, True)
