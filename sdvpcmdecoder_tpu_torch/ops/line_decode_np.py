"""Host-side generic line decoder: the binarizer's search fallbacks.

Implements, in vectorized numpy, the reference search paths that only run
for lines the device fast path could not validate (a few per frame at
most — the inverse of the reference, which runs these serially per line):

  * readPCMdata trial grid for any format (hyst x shift, lex-first valid;
    binarizer.cpp:7695-8090);
  * PCM-1 / PCM-16x0 coordinate sweep (findPCM1Coordinates :5601,
    searchPCM1Data :4123, findPCM16X0Coordinates :5819): left x right
    coordinate grid at PPB/4 (PPB/2) steps, CRC-collision filtering,
    pickLevelByCRCStats region selection;
  * Bit Picker (pickCutBitsUpPCM1 :6116, ...PCM16X0 :6599): brute-force of
    edge bits cut off-frame, rejecting CRC collisions;
  * reference-level sweep (sweepRefLevel :3551, calcRefLevelBySweep :3821,
    pickLevelByCRCStats :1985): all levels [black+1, white-1], most
    frequent CRC with 2x dominance, longest constant-(hyst,shift) region.

Port of sdvpcmdecoder_tpu/ops/line_decode_np.py, numpy as there. The one
STC-007 CRC it computes goes through the port's torch calc_crc on a CPU
tensor (utils.host.host_call).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..formats import stc007, pcm1, pcm16x0
from . import binarize as bz
from .agc import BinPreset
from ..utils.host import host_call

SHIFT_STAGES_SAFE = 2
HYST_DEPTH_MAX = 10

PCM1_SEARCH_STEP_DIV, PCM1_SEARCH_MAX_OFS = 4, 12
PCM16X0_SEARCH_STEP_DIV, PCM16X0_SEARCH_MAX_OFS = 2, 10


@dataclass
class FormatSpec:
    name: str
    n_bits: int              # data bits read per object
    bit_ofs: int             # constant bit offset into the line bit space
    bits_between: int        # bits between data coordinates (PPB basis)
    bits_per_line: int       # clamp for bit index
    left_zone: int
    right_zone: int
    word_bit_counts: tuple   # per-word widths incl. CRC


SPEC_STC007 = FormatSpec("stc007", 128, 3, 132, 137, 24, 76,
                         (14,) * 8 + (16,))
SPEC_PCM1 = FormatSpec("pcm1", 94, 0, 94, 94, 16, 52, (13,) * 6 + (16,))
SPEC_PCM16X0_FULL = FormatSpec("pcm16x0", 193, 0, 193, 193, 34, 107,
                               ())  # coordinates cover the whole line
# Per-part start bits within the 193-bit line (pcm16x0 fillPCM16X0).
PCM16X0_PART_START = (0, 64, 129)
# search_coordinates' `part` that reads all three PCM-16x0 sublines.
ALL_PARTS = 3
# ArVid Audio prototype (arvidline.h:36-51): 144 data bits, 18 x 8-bit
# words, no CRC (the reference's CRC/sample paths are TODO stubs).
SPEC_ARVID = FormatSpec("arvid", 144, 0, 144, 144, 24, 96, (8,) * 18)


def bit_coords(spec: FormatSpec, start, stop, shift_stage, width,
               part_start=0, n_bits=None):
    """Pixel coordinates for `n_bits` bits starting at line bit
    part_start (integer PPB math, pcmline.cpp:249-311)."""
    n_bits = n_bits or spec.n_bits
    psm, half = bz.calc_ppb(np.asarray([start]), np.asarray([stop]),
                            spec.bits_between)
    bit = np.minimum(np.arange(n_bits) + part_start + spec.bit_ofs,
                     spec.bits_per_line - 1)
    base = (bit * psm[0] + half[0]) // bz.INT_CALC_MULT + start
    bg = bz.PIX_SH_BG[shift_stage]
    ed = bz.PIX_SH_ED[shift_stage]
    if bg == ed:
        px = base + bg
    else:
        px = base + np.where(bit < spec.left_zone, bg,
                             np.where(bit > spec.right_zone, ed, 0))
    return np.clip(px, 0, width - 1), int(psm[0] // bz.INT_CALC_MULT)


def read_bits(pixels_line, coords_px, ref_low, ref_high):
    """Schmitt read of one line at given pixel coordinates (serial)."""
    px = pixels_line[coords_px]
    return bz.hysteresis_read_np(px[None, :], np.asarray([ref_low]),
                                 np.asarray([ref_high]))[0]


def bits_to_words(bits, word_bit_counts):
    words = []
    pos = 0
    for nb in word_bit_counts:
        w = 0
        for b in bits[pos:pos + nb]:
            w = (w << 1) | int(b)
        words.append(w)
        pos += nb
    return words


# ---------------------------------------------------------------------------
# Per-format single-trial decode
# ---------------------------------------------------------------------------
def decode_trial_stc007(pixels_line, start, stop, ref, depth, shift, width):
    cpx, ppb = bit_coords(SPEC_STC007, start, stop, shift, width)
    rl, rh = max(ref - depth, 1), min(ref + depth, 254)
    bits = read_bits(pixels_line, cpx, rl, rh)
    words = bits_to_words(bits, SPEC_STC007.word_bit_counts)
    calc = int(host_call(stc007.calc_crc,
                         np.asarray([words[:8]], np.int32))[0])
    return words[:8], words[8], calc, ppb


def decode_trial_pcm1(pixels_line, start, stop, ref, depth, shift, width):
    cpx, ppb = bit_coords(SPEC_PCM1, start, stop, shift, width)
    rl, rh = max(ref - depth, 1), min(ref + depth, 254)
    bits = read_bits(pixels_line, cpx, rl, rh)
    words = bits_to_words(bits, SPEC_PCM1.word_bit_counts)
    calc = int(pcm1.calc_crc(np.asarray([words[:6]]), xp=np)[0])
    return words[:6], words[6], calc, ppb


def decode_trial_pcm16x0(pixels_line, start, stop, ref, depth, shift,
                         width, part):
    cpx, ppb = bit_coords(SPEC_PCM16X0_FULL, start, stop, shift, width,
                          part_start=PCM16X0_PART_START[part], n_bits=64)
    rl, rh = max(ref - depth, 1), min(ref + depth, 254)
    bits = read_bits(pixels_line, cpx, rl, rh)
    words = bits_to_words(bits, (16, 16, 16, 16))
    calc = int(pcm16x0.calc_crc(np.asarray([words[:3]]), xp=np)[0])
    return words[:3], words[3], calc, ppb


def decode_trial_arvid(pixels_line, start, stop, ref, depth, shift, width):
    """ArVid Audio read (fillArVidAudio binarizer.cpp:7448): hysteresis
    bit read -> 18 x 8-bit words.  The format has no CRC (reference
    TODO), so `calc` mirrors the read-back marker of an always-accepted
    trial."""
    cpx, ppb = bit_coords(SPEC_ARVID, start, stop, shift, width)
    rl, rh = max(ref - depth, 1), min(ref + depth, 254)
    bits = read_bits(pixels_line, cpx, rl, rh)
    words = bits_to_words(bits, SPEC_ARVID.word_bit_counts)
    return words, 0, 0, ppb


def arvid_read_line(pixels_line, start, stop, ref, width=None):
    """Binarize one ArVid line -> words [18] uint8 (no validation, as in
    the reference's debug-only path, videotodigital.cpp:857-858)."""
    width = width or len(pixels_line)
    words, _, _, _ = decode_trial_arvid(pixels_line, start, stop, ref,
                                        0, 0, width)
    return np.asarray(words[:18], dtype=np.int64)


def read_control_bit(pixels_line, start, stop, ref, width):
    """PCM-16x0 control/skew bit at line bit 128."""
    cpx, _ = bit_coords(SPEC_PCM16X0_FULL, start, stop, 0, width,
                        part_start=pcm16x0.CTRL_BIT_INDEX, n_bits=1)
    return bool(pixels_line[cpx[0]] > ref)


# ---------------------------------------------------------------------------
# readPCMdata grid (lex-first valid trial)
# ---------------------------------------------------------------------------
def read_pcm_grid(decode_trial, pixels_line, start, stop, ref, black,
                  white, width, hyst_limit, shift_limit, **kw):
    """Returns (words, crc_read, calc, valid, depth, shift, picked)."""
    for depth in range(hyst_limit + 1):
        rl, rh = max(ref - depth, 1), min(ref + depth, 254)
        if rl <= black or rh >= white:
            break  # ref clipping: invalid_hyst stops the outer loop
        for shift in range(shift_limit + 1):
            words, crc_read, calc, ppb = decode_trial(
                pixels_line, start, stop, ref, depth, shift, width, **kw)
            if calc == crc_read:
                return words, crc_read, calc, True, depth, shift
    words, crc_read, calc, ppb = decode_trial(
        pixels_line, start, stop, ref, 0, 0, width, **kw)
    return words, crc_read, calc, calc == crc_read, 0, 0


# ---------------------------------------------------------------------------
# Bit Picker (pickCutBitsUpPCM1 :6116)
# ---------------------------------------------------------------------------
def count_cut_bits(spec, start, stop, width, max_left, max_right):
    """How many edge bits collapse onto the line boundary (cut off)."""
    cpx, ppb = bit_coords(spec, start, stop, 0, width)
    half = (ppb + 1) // 2
    left = 0
    first = 0  # scan_start
    for i in range(max_left):
        cur = cpx[i]
        if (cur - first) >= half:
            break
        if i == 0:
            first = cur
        left = i + 1
    right = 0
    first = width - 1  # scan_end
    for i in range(max_right):
        cur = cpx[spec.bits_between - 1 - i]
        if (first - cur) >= half:
            break
        if i == 0:
            first = cur
        right = i + 1
    return left, right


def pick_cut_bits_pcm1(words, crc_read, start, stop, width,
                       preset: BinPreset | None = None):
    """Brute-force edge bits for a CRC-failed PCM-1 line.

    Returns (words, crc_read, valid, picked_left, picked_right,
    forced_bad). Unique-solution requirement per the reference: two valid
    patches = collision = forced bad.
    """
    preset = preset or BinPreset()
    left_n, right_n = count_cut_bits(SPEC_PCM1, start, stop, width,
                                     preset.left_bit_pick,
                                     preset.right_bit_pick)
    if left_n == 0 and right_n == 0:
        return words, crc_read, False, 0, 0, False
    lw_clean = words[0] & ((1 << (13 - left_n)) - 1)
    rc_clean = crc_read & ~((1 << right_n) - 1) if right_n else crc_read
    rc_clean &= 0xFFFF
    found = None
    for li in range(1 << left_n):
        lpatch = li << (13 - left_n)
        test = list(words)
        test[0] = lw_clean | lpatch
        calc = int(pcm1.calc_crc(np.asarray([test]), xp=np)[0])
        for ri in range(1 << right_n):
            rpatch = ri
            if calc == (rc_clean | rpatch):
                if found is not None:
                    return words, crc_read, False, 0, 0, True  # collision
                found = (test[0], rc_clean | rpatch)
    if found is None:
        return words, crc_read, False, 0, 0, False
    new_words = list(words)
    new_words[0] = found[0]
    return new_words, found[1], True, left_n, right_n, False


def pick_cut_bits_pcm16x0(words, crc_read, start, stop, width, part,
                          preset: BinPreset | None = None):
    """pickCutBitsUpPCM16X0 (:6599): brute-force frame-edge bits for the
    sub-line that owns them — PART_LEFT patches its first word's MSBs
    with the unique-solution rule (two valid patches = collision =
    forced bad); PART_RIGHT re-derives its CRC's cut LSBs from the
    calculated CRC (single candidate by construction).

    Returns (words, crc_read, valid, picked_left, picked_right,
    forced_bad).
    """
    preset = preset or BinPreset()
    left_n, right_n = count_cut_bits(SPEC_PCM16X0_FULL, start, stop,
                                     width, preset.left_bit_pick,
                                     preset.right_bit_pick)
    if part == 0 and left_n:
        clean = int(words[0]) & ((1 << (16 - left_n)) - 1)
        found = None
        for li in range(1 << left_n):
            test = list(words)
            test[0] = clean | (li << (16 - left_n))
            calc = int(pcm16x0.calc_crc(np.asarray([test]), xp=np)[0])
            if calc == crc_read:
                if found is not None:
                    return words, crc_read, False, left_n, 0, True
                found = test[0]
        if found is None:
            return words, crc_read, False, 0, 0, False
        nw = list(words)
        nw[0] = found
        return nw, crc_read, True, left_n, 0, False
    if part == 2 and right_n:
        mask = ~((1 << right_n) - 1) & 0xFFFF
        calc = int(pcm16x0.calc_crc(np.asarray([list(words)]), xp=np)[0])
        if (calc & mask) == (crc_read & mask):
            return list(words), calc, True, 0, right_n, False
        return words, crc_read, False, 0, 0, False
    return words, crc_read, False, 0, 0, False


# ---------------------------------------------------------------------------
# Coordinate sweep (searchPCM1Data :4123 / PCM-16x0 :4514)
# ---------------------------------------------------------------------------
def _pick_by_stats(entries, max_hyst=0x0F, max_shift=255):
    """pickLevelByCRCStats (:1985-2143) over an index axis.

    entries: list of dicts with keys result, crc, hyst, shift (index
    order = scan order high->low in the original; here list order).
    Returns chosen index or None.
    """
    lowd, lows = 0xFF, 0xFF
    high_idx = None
    for i, e in enumerate(entries):
        if not e["result"] or e["hyst"] > max_hyst or e["shift"] > max_shift:
            continue
        if e["hyst"] < lowd or (e["hyst"] == lowd and e["shift"] < lows):
            lowd, lows = e["hyst"], e["shift"]
            high_idx = i
    if high_idx is None:
        return None
    # Longest contiguous run of exactly (lowd, lows) from high_idx on.
    lo = hi = high_idx
    best_lo, best_hi = high_idx, high_idx
    run_open = False
    cur_lo = cur_hi = high_idx
    for i in range(high_idx, len(entries)):
        e = entries[i]
        match = (e["result"] and e["hyst"] == lowd and e["shift"] == lows)
        if match:
            if not run_open:
                cur_hi = i
                run_open = True
            cur_lo = i
        else:
            if run_open and (cur_lo - cur_hi) >= (best_lo - best_hi):
                best_lo, best_hi = cur_lo, cur_hi
            run_open = False
    if run_open and (cur_lo - cur_hi) >= (best_lo - best_hi):
        best_lo, best_hi = cur_lo, cur_hi
    return best_hi + (best_lo - best_hi) // 2


def _crc_stats_filter(trials):
    """updateCRCStats + findMostFrequentCRC + invalidate (skip_equal).

    trials: list of dicts with 'result' (bool) and 'crc'. Mutates result
    flags; returns surviving count."""
    counts = {}
    order = []
    for t in trials:
        if t["result"]:
            if t["crc"] not in counts:
                order.append(t["crc"])
            counts[t["crc"]] = counts.get(t["crc"], 0) + 1
    if not counts:
        return 0
    best = max(order, key=lambda c: counts[c])
    bestc = counts[best]
    for c in order:
        if c != best and bestc <= 2 * counts[c]:
            for t in trials:
                t["result"] = False
            return 0
    alive = 0
    for t in trials:
        if t["result"] and t["crc"] != best:
            t["result"] = False
        elif t["result"]:
            alive += 1
    return alive


def refine_failed_lines(lines, valid, coords, ref, black, white, fmt,
                        shift_limit=SHIFT_STAGES_SAFE, hyst_limit=0,
                        span=8, step=2, max_lines=256):
    """Per-line coordinate refinement for lines that failed the shared
    frame coordinates — the batch analog of the reference's per-line
    findPCM1Coordinates/findPCM16X0Coordinates (binarizer.cpp:5601/:5819)
    handling tape jitter beyond the pixel-shift stages.

    lines [L, W] uint8; valid: [L] bool (PCM-1) or [L, 3] bool (16x0
    per subline part); coords (start, stop).  Mutates nothing; returns
    (words, crc, fixed_mask) for the refined lines only, as a dict
    {line_index: (words, crc)} (PCM-1) or {(line, part): ...} (16x0).
    """
    W = lines.shape[1]
    ds, de = coords
    deltas = sorted(range(-span, span + 1, step), key=abs)
    out = {}

    def cap(idx, what):
        # Default cap of 256 lines bounds the per-line host refinement on
        # pure-noise frames (81 coordinate trials per line); the cap LOGS
        # what it drops instead of silently leaving lines invalid
        # (max_lines=None refines everything).
        if max_lines is not None and len(idx) > max_lines:
            import logging
            logging.getLogger(__name__).warning(
                "refine_failed_lines: capping %s from %d to %d lines",
                what, len(idx), max_lines)
            return idx[:max_lines]
        return idx

    from . import stitch_native as _nat
    use_native = _nat.available()
    if use_native and max_lines == 256:
        # The default cap exists to bound the serial-Python fallback
        # (~225 ms/line on pure noise); the native sweep is ~0.4 ms/line,
        # so the cap is effectively lifted when the C++ core is loaded.
        max_lines = 8192

    def sweep(px, part):
        # Native C++ twin of the d1 x d2 x read_pcm_grid scan below
        # (~81 trials/line); bit-identical by randomized equivalence
        # test (tests/test_linegrid_native.py).
        if use_native:
            got = _nat.linegrid_coord_sweep(
                px, ds, de, ref, black, white, fmt, part,
                deltas, deltas, hyst_limit, shift_limit)
            if got is None:
                return None
            words, _sel = got
            return tuple(words[:-1]), words[-1]
        for d1 in deltas:
            for d2 in deltas:
                if fmt == "pcm1":
                    w, cr, calc, ok, d, s = read_pcm_grid(
                        decode_trial_pcm1, px, ds + d1, de + d2,
                        ref, black, white, W, hyst_limit, shift_limit)
                else:
                    w, cr, calc, ok, d, s = read_pcm_grid(
                        decode_trial_pcm16x0, px, ds + d1, de + d2,
                        ref, black, white, W, hyst_limit, shift_limit,
                        part=part)
                if ok:
                    return tuple(int(x) for x in w), int(cr)
        return None

    if fmt == "pcm1":
        bad = cap(np.nonzero(~valid)[0], "pcm1 failed lines")
        for li in bad:
            got = sweep(lines[li], 0)
            if got is not None:
                out[int(li)] = got
    else:
        bad_rows = cap(np.nonzero(~valid.all(axis=-1))[0],
                       "pcm16x0 failed lines")
        for li in bad_rows:
            for part in range(3):
                if valid[li, part]:
                    continue
                got = sweep(lines[li], part)
                if got is not None:
                    out[(int(li), part)] = got
    return out


def _trial_pcm16x0(pixels_line, start, stop, ref, black, white, width,
                   shifts, part, preset):
    """One sweep trial of PCM-16x0 subline `part`: the first valid shift
    at depth 0, else the Bit Picker. -> (words, crc, valid, shift,
    picked_l, picked_r). With ALL_PARTS, valid only where all three
    sublines are: part 0's words and CRC, the largest of the three
    shifts, part 0's left and part 2's right picked bits (part 2 read
    first: its band of readable stops is the narrowest)."""
    if part == ALL_PARTS:
        args = (pixels_line, start, stop, ref, black, white, width, shifts)
        far = _trial_pcm16x0(*args, 2, preset)
        if not far[2]:
            return far
        words, crc_read, valid, s, picked_l, _ = _trial_pcm16x0(
            *args, 0, preset)
        if valid:
            mid = _trial_pcm16x0(*args, 1, preset)
            valid, s = mid[2], max(s, mid[3], far[3])
        return words, crc_read, valid, s, picked_l, far[5]
    words, crc_read, _calc, valid, _d, s = read_pcm_grid(
        decode_trial_pcm16x0, pixels_line, start, stop, ref, black, white,
        width, 0, shifts, part=part)
    picked_l = picked_r = 0
    if not valid:
        words, crc_read, valid, picked_l, picked_r, _forced = \
            pick_cut_bits_pcm16x0(words, crc_read, start, stop, width,
                                  part, preset)
    return words, crc_read, valid, s, picked_l, picked_r


def search_coordinates(pixels_line, ref, black, white, width, fmt="pcm1",
                       history=None, part=0, bin_mode_shifts=SHIFT_STAGES_SAFE,
                       preset: BinPreset | None = None, max_ofs=None):
    """Coordinate sweep for PCM-1 / PCM-16x0. Returns dict or None.

    Follows searchPCM1Data: left x right offset grid at PPB/step_div
    steps, per-left CRC stats on the right axis, then stats + region pick
    on the left axis.  max_ofs overrides the grid half-width (the
    periodic refresh sweeps a narrow window around the locked
    coordinates; callers fall back to the full width on a miss).

    PCM-16x0 reads subline `part` (0..2) at each trial, or, with
    part=ALL_PARTS, all three: a trial whose other sublines do not read
    with a good CRC is a miss, as a failed part 0 is.  Part 0 (bits 0-63)
    alone reads over a band of stop edges some 23 px wide (part 2's is
    6-8 px), and the pick takes the band's middle, which moves 2 px later
    for each px the start is early: at 7 px a bit, a start 2 px early
    locks a stop 4-6 px late, where bits 129-192 are read nearly a bit
    off.  The grid's PPB/2 steps still leave an ALL_PARTS pick 1-2 px
    off, so it is swept again a pixel apart, two steps each way, unless
    it lands on `history` (a lock such a pass found: a periodic refresh
    that confirms it costs no second pass).  ALL_PARTS is the port's own;
    the JAX package reads part 0.
    """
    preset = preset or BinPreset()
    spec = SPEC_PCM1 if fmt == "pcm1" else SPEC_PCM16X0_FULL
    step_div = PCM1_SEARCH_STEP_DIV if fmt == "pcm1" \
        else PCM16X0_SEARCH_STEP_DIV
    if max_ofs is None:
        max_ofs = PCM1_SEARCH_MAX_OFS if fmt == "pcm1" \
            else PCM16X0_SEARCH_MAX_OFS
    if history is not None:
        ds, de = history
    else:
        # First transition from each edge (findPCM1Coordinates :5620-5700).
        # The reference uses width/16; with no history at all we widen the
        # seed search so captures with large borders still bootstrap.
        margin = width // 4
        line = pixels_line
        state = line[0] > ref
        ds = 0
        for p in range(0, margin):
            if (line[p] > ref) != state:
                ds = p - 1
                break
        state = line[width - 1] > ref
        de = width - 1
        for p in range(width - 1, width - 1 - margin, -1):
            if (line[p] > ref) != state:
                de = p + 1
                break
    ppb0 = max((de - ds) * bz.INT_CALC_MULT // spec.bits_between
               // bz.INT_CALC_MULT, 1)
    step = max(ppb0 // step_div, 1)
    args = (pixels_line, ref, black, white, width, fmt, part,
            bin_mode_shifts, preset)
    found = _search_grid(*args, ds, de, step, max_ofs)
    if (found is not None and fmt == "pcm16x0" and part == ALL_PARTS
            and (history is None
                 or (found["start"], found["stop"]) != tuple(history))):
        # The grid's steps are PPB/2 apart: sweep again a pixel apart,
        # two steps each way of its pick.
        found = _search_grid(*args, found["start"], found["stop"], 1,
                             2 * step) or found
    return found


def _search_grid(pixels_line, ref, black, white, width, fmt, part,
                 bin_mode_shifts, preset, ds, de, step, max_ofs):
    """search_coordinates' grid about (ds, de), `max_ofs` steps of
    `step` pixels each way: the picked entry, or None."""
    span = step * max_ofs
    from . import stitch_native as _nat
    if _nat.available():
        # Native grid (~100x the Python loops below, which remain the
        # bit-identical reference — tests/test_search_native.py).
        return _nat.pcm_search_coordinates(
            pixels_line, ds, de, ref, black, white, fmt, part,
            step, max_ofs, bin_mode_shifts, preset.left_bit_pick,
            preset.right_bit_pick)
    left_entries = []
    for start_ofs in range(ds - span, ds + span + 1, step):
        right_trials = []
        for stop_ofs in range(de + span, de - span - 1, -step):
            if fmt == "pcm1":
                words, crc_read, calc, valid, d, s = read_pcm_grid(
                    decode_trial_pcm1, pixels_line, start_ofs, stop_ofs,
                    ref, black, white, width, 0, bin_mode_shifts)
                picked_l = picked_r = 0
                forced = False
                if not valid:
                    words, crc_read, valid, picked_l, picked_r, forced = \
                        pick_cut_bits_pcm1(words, crc_read, start_ofs,
                                           stop_ofs, width, preset)
                hyst_rank = d
                if picked_l and picked_r:
                    hyst_rank = 0x0E
                elif picked_r:
                    hyst_rank = 0x0D
                elif picked_l:
                    hyst_rank = 0x0C
            else:
                words, crc_read, valid, s, picked_l, picked_r = \
                    _trial_pcm16x0(pixels_line, start_ofs, stop_ofs, ref,
                                   black, white, width, bin_mode_shifts,
                                   part, preset)
                hyst_rank = 0   # one part picks one edge, ALL_PARTS both
                if picked_l and picked_r:
                    hyst_rank = 0x0E
                elif picked_r:
                    hyst_rank = 0x0D
                elif picked_l:
                    hyst_rank = 0x0C
            right_trials.append(dict(
                result=bool(valid), crc=crc_read, hyst=hyst_rank,
                shift=s, start=start_ofs, stop=stop_ofs, words=words,
                picked=(picked_l, picked_r)))
        alive = _crc_stats_filter(right_trials)
        if alive:
            ridx = _pick_by_stats(right_trials)
            e = right_trials[ridx]
            left_entries.append(dict(result=True, crc=e["crc"],
                                     hyst=e["hyst"], shift=e["shift"],
                                     entry=e))
        else:
            left_entries.append(dict(result=False, crc=0,
                                     hyst=HYST_DEPTH_MAX, shift=4,
                                     entry=None))
    if not _crc_stats_filter(left_entries):
        return None
    lidx = _pick_by_stats(left_entries)
    if lidx is None or left_entries[lidx]["entry"] is None:
        return None
    return left_entries[lidx]["entry"]
