"""V2D-analog frame driver for PCM-1 / PCM-16x0.

The reference drives these formats through the same VideoToDigital loop
as STC-007, with per-line brute-force coordinate sweeps instead of
marker search (findPCM1Coordinates binarizer.cpp:5601,
findPCM16X0Coordinates :5819, searchPCM1Data :4123).  Batch design here
mirrors V2DDriver:

  * prescan: format-aware histogram AGC (findPCM1BW :2560 /
    findPCM16X0BW :2602) + the native coordinate SEARCH on
    COORD_CHECK_LINES spread sample lines, damped by a frame-level
    median history (prescanCoordinates / medianCoordinates analog);
  * decode: the whole frame batch through ONE native early-exit trial
    grid call (host backend) or one torch trial grid on the driver's
    `device` (the "tpu" backend, the JAX package's name kept);
  * fallback: per-line native coordinate refinement for lines the
    shared frame coordinates cannot decode (refine_failed_lines).

Port of sdvpcmdecoder_tpu/pipeline/v2d_other.py.  The difference:
`device` (default "cuda") says where the "tpu" backend's grid runs, and
"auto" resolves as batch_driver.resolve_auto_backend does — the grid on
the card for a CUDA device, the JAX package's rule (native when the C++
core is built) only for device="cpu".  The JAX package's grid is one
compiled program a shape (`jax.jit` pcm1_frame_decode /
pcm16x0_frame_decode); with `graphs` (the default) the port replays it
as a CUDA graph from the thread's ops/round_graph.RoundGraphs
(thread_graphs; the CPU's stand-in on the CPU), keyed by the format,
the trial limits and the input shapes; graphs=False runs its ops
eagerly.  One departure in the coordinate search: a first hit that no
other sample line confirms is not kept where the lines swept from their
own edges find hits (_unseeded_hits).  `trace` is the utils.trace.Tracer its post-decode work adds to
(a BatchDecoder passes its own): span `pcm_refine` (per-line refinement,
the Bit Picker and the CRC re-check of each frame) and counter
`count_pcm_refined_frames` (frames whose failed lines were refined).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops import agc, line_decode_np as ld
from ..ops.round_graph import call, thread_graphs
from ..utils.host import HostCopy
from ..utils.trace import Tracer
from .v2d import _imed

COORD_CHECK_LINES = 4      # videotodigital.h:98-105
COORD_CHECK_PARTS = COORD_CHECK_LINES + 1
COORD_LONG_HISTORY = 16
# Good-params fast path: while decodes stay this clean, reuse the damped
# coordinate history instead of re-sweeping sample lines every frame
# (the binarizer's "good parameters from the previous line" skip,
# binarizer.cpp:1105-1141, lifted to frame scope).  A periodic refresh
# keeps tracking slow geometry drift.
GOOD_SKIP_VALID = 0.98
SEARCH_REFRESH = 8


@dataclass
class OtherFrameResult:
    words: np.ndarray        # pcm1 [L, 6] / pcm16x0 [L*3, 3]
    crc_read: np.ndarray     # pcm1 [L]    / pcm16x0 [L*3]
    valid: np.ndarray        # same leading shape as crc_read
    ctrl: np.ndarray | None  # pcm16x0 [L] control bits
    ref_level: int
    coords: tuple
    picked_left: np.ndarray | None = None   # Bit Picker edge-bit counts
    picked_right: np.ndarray | None = None


class PCMFrameDriver:
    """Batched PCM-1/16x0 frame decoder with prescan + damping +
    per-line refinement (V2DDriver counterpart)."""

    def __init__(self, fmt: str, shift_limit=2, hyst_limit=0, refine=True,
                 preset: agc.BinPreset | None = None, backend="auto",
                 device="cuda", graphs=True, trace=None):
        assert fmt in ("pcm1", "pcm16x0")
        self.fmt = fmt
        self.trace = trace if trace is not None else Tracer()
        self.shift_limit = shift_limit
        self.hyst_limit = hyst_limit   # binarizer.h:235-241 depth sweep
        self.refine = refine            # normal/insane per-line sweep
        self.preset = preset or agc.BinPreset()
        if backend == "auto":
            from .batch_driver import resolve_auto_backend
            backend = resolve_auto_backend(device)
        self.backend = backend
        self.device = torch.device(device)
        # The "tpu" grid as a CUDA graph from the thread's holder on
        # `device` (the CPU's stand-in on the CPU), or eagerly.
        self.graphs = thread_graphs(self.device) if graphs else None
        self.coord_history: list[tuple[int, int]] = []
        self._frames_since_search = 0
        self._last_good = False
        self._force_search = False

    # -- prescan ----------------------------------------------------------
    def _hist_coords(self):
        if not self.coord_history:
            return None
        hs = np.array(self.coord_history)
        return (_imed(hs[:, 0]), _imed(hs[:, 1]))

    def _coords_stable(self):
        """Two consecutive agreeing CRC-validated search results lock the
        coordinates without waiting for decode feedback (the searches only
        report hits on CRC-valid reads, so agreement is strong evidence)."""
        if len(self.coord_history) < 2:
            return False
        (a0, a1), (b0, b1) = self.coord_history[-1], self.coord_history[-2]
        return abs(a0 - b0) <= 1 and abs(a1 - b1) <= 1

    @staticmethod
    def prescan_rows(L, n_chk=COORD_CHECK_LINES):
        """Prescan sample-row indices for an L-line frame (shared with
        the chip-resident driver's device-side gather; delegates to the
        single COORD_CHECK-spread implementation in v2d)."""
        from . import v2d
        return v2d.prescan_rows(L, n_chk)

    def prepare_frames(self, pixels: np.ndarray, perm=None, sample=None,
                       shape=None):
        """Batched AGC + per-frame sample-line coordinate search.

        pixels [F, L, W] (any strides); perm: field-seq -> row map.
        With `sample` given ([F*COORD_CHECK_LINES, W] pre-gathered rows,
        e.g. read back from device-resident pixels), the gather is
        skipped and `pixels` may be None (`shape` supplies (F, L, W)).
        Returns dict(coords [F,2], refs/blacks/whites [F], usable [F]).
        """
        F, L, W = pixels.shape if pixels is not None else shape
        coords = np.zeros((F, 2), np.int64)
        refs = np.zeros(F, np.int64)
        blacks = np.zeros(F, np.int64)
        whites = np.full(F, 255, np.int64)
        usable = np.zeros(F, bool)
        n_chk = COORD_CHECK_LINES
        if L <= COORD_CHECK_PARTS:
            return dict(coords=coords, refs=refs, blacks=blacks,
                        whites=whites, usable=usable)
        if sample is not None:
            sample = np.asarray(sample).reshape(F, n_chk, W)
        else:
            idx = self.prescan_rows(L)
            if perm is not None:
                idx = np.asarray(perm)[idx]
            sample = np.ascontiguousarray(pixels[:, idx, :])
        blk, wht, ok = agc.find_black_white(
            sample.reshape(F * n_chk, W), self.preset, fmt=self.fmt)
        blk = blk.reshape(F, n_chk)
        wht = wht.reshape(F, n_chk)
        ok = ok.reshape(F, n_chk)
        for f in range(F):
            sel = ok[f] if ok[f].any() else np.ones(n_chk, bool)
            black = _imed(blk[f][sel])
            white = _imed(wht[f][sel])
            ref = (black + white) // 2
            if (not self._force_search and self.coord_history
                    and (self._last_good or self._coords_stable())
                    and self._frames_since_search < SEARCH_REFRESH):
                self._frames_since_search += 1
                coords[f] = self._hist_coords()
                refs[f], blacks[f], whites[f] = ref, black, white
                usable[f] = True
                continue
            # Periodic refresh with locked coordinates sweeps a NARROW
            # window around them — drift tracking costs a fraction of
            # the bootstrap sweep; a refresh that finds nothing retries
            # at full width below, so robustness is unchanged.
            narrow = None
            if (not self._force_search and self.coord_history
                    and (self._last_good or self._coords_stable())):
                full = ld.PCM1_SEARCH_MAX_OFS if self.fmt == "pcm1" \
                    else ld.PCM16X0_SEARCH_MAX_OFS
                narrow = max(2, full // 3)
            self._frames_since_search = 0
            hist = self._hist_coords()
            hits = []
            passes = (narrow, None) if narrow is not None else (None,)
            seeded_from = None
            for retry_ofs in passes:
                for k in range(n_chk):
                    sw = ld.search_coordinates(
                        sample[f, k], ref, black, white, W, fmt=self.fmt,
                        history=hist, preset=self.preset,
                        bin_mode_shifts=self.shift_limit,
                        max_ofs=retry_ofs)
                    if sw is not None:
                        hits.append((sw["start"], sw["stop"]))
                        if hist is None and len(hits) == 1:
                            # Seed further sample lines with the first
                            # hit so their sweeps stay narrow.
                            hist = hits[0]
                            seeded_from = k
                if hits or retry_ofs is None:
                    break
            if (seeded_from is not None and len(hits) == 1
                    and seeded_from < n_chk - 1):
                hits = self._unseeded_hits(sample[f], seeded_from, ref,
                                           black, white, W) or hits
            if hits:
                hs = np.array(hits)
                c = (_imed(hs[:, 0]), _imed(hs[:, 1]))
                self.coord_history.append(c)
                self.coord_history = \
                    self.coord_history[-COORD_LONG_HISTORY:]
            c = self._hist_coords()
            if c is None:
                continue
            coords[f] = c
            refs[f], blacks[f], whites[f] = ref, black, white
            usable[f] = True
        return dict(coords=coords, refs=refs, blacks=blacks,
                    whites=whites, usable=usable)

    def _unseeded_hits(self, lines, first, ref, black, white, W):
        """The hits of sample lines `first + 1`.. swept from their own
        edges, as a first line is.

        A departure from the JAX package: with no history, the first hit
        seeds the other sample lines' sweeps, and where none of them
        confirms it, it may be a CRC collision (a line whose last bits are
        0 puts its right edge out of the sweep's reach, so only a false
        match is left). The JAX package keeps such a hit, and every later
        sweep is seeded from the history it starts: the coordinates stay
        wrong for the whole capture. Here the lines are swept again
        unseeded, and their hits, if any, take the lone hit's place."""
        hits = []
        for k in range(first + 1, len(lines)):
            sw = ld.search_coordinates(
                lines[k], ref, black, white, W, fmt=self.fmt, history=None,
                preset=self.preset, bin_mode_shifts=self.shift_limit)
            if sw is not None:
                hits.append((sw["start"], sw["stop"]))
        return hits

    # -- decode -----------------------------------------------------------
    def _decode_batch(self, pixels, prep):
        coords = prep["coords"].astype(np.int32)
        refs = np.maximum(prep["refs"], 1).astype(np.int32)
        blacks = np.clip(prep["blacks"], 0, 254).astype(np.int32)
        whites = np.clip(prep["whites"], 1, 255).astype(np.int32)
        if self.backend == "native":
            from ..ops import stitch_native as sn
            if self.fmt == "pcm1":
                w, c, v = sn.pcm1_binarize_frames(
                    pixels, coords, refs, blacks, whites,
                    self.shift_limit, hyst_limit=self.hyst_limit)
                return w, c, v, None
            return sn.pcm16x0_binarize_frames(
                pixels, coords, refs, blacks, whites, self.shift_limit,
                hyst_limit=self.hyst_limit)
        from ..ops import binarize as bz
        decode = bz.pcm1_frame_decode if self.fmt == "pcm1" \
            else bz.pcm16x0_frame_decode

        def body(*args):   # contiguous: copied out as they are
            return tuple(t.contiguous() for t in decode(
                *args, shift_limit=self.shift_limit,
                hyst_limit=self.hyst_limit))

        inputs = (torch.from_numpy(np.require(pixels,
                                              requirements=("C", "W"))),) \
            + tuple(torch.from_numpy(a)
                    for a in (coords, refs, blacks, whites))
        out = call(self.graphs, ("frame_decode", self.fmt,
                                 self.shift_limit, self.hyst_limit),
                   body, inputs, self.device)
        copies = [HostCopy(t) for t in out]   # before the next replay
        host = tuple(c.numpy() for c in copies)
        return host + (None,) if self.fmt == "pcm1" else host

    def decode_prepared(self, pixels, prep, perm=None):
        """-> list of OtherFrameResult (None for unusable frames).

        Outputs are in field-sequential line order; `pixels` may be the
        raw-row view with `perm` mapping (decode is row-independent, so
        only the small output arrays reorder)."""
        words, crc, valid, ctrl = self._decode_batch(pixels, prep)
        if perm is not None:
            p = np.asarray(perm)

            def px_fetch(f, pixels=pixels, p=p):
                return np.ascontiguousarray(pixels[f][p])

            words, crc, valid = words[:, p], crc[:, p], valid[:, p]
            if ctrl is not None:
                ctrl = ctrl[:, p]
        else:
            def px_fetch(f, pixels=pixels):
                return pixels[f]
        return self.finalize_decoded(prep, words, crc, valid, ctrl,
                                     px_fetch, pixels.shape[2])

    def finalize_decoded(self, prep, words, crc, valid, ctrl, px_fetch,
                         W):
        """Host post-decode phase: good-params feedback, per-line
        refinement of failed lines (frame pixels fetched lazily via
        `px_fetch` — a host row or a device readback), Bit Picker,
        result assembly.  Arrays arrive field-sequential."""
        F, L = words.shape[:2]
        use = np.asarray(prep["usable"])
        if use.any():
            # Pre-refine validity gates the good-params skip: drop back
            # to the full sweep as soon as shared coordinates degrade.
            frac = float(np.asarray(valid)[use].mean())
            self._last_good = frac >= GOOD_SKIP_VALID
        else:
            self._last_good = False
        # Degraded decodes force the full per-frame sweep until quality
        # recovers — stable-but-wrong history must not keep skipping.
        self._force_search = not self._last_good
        out = []
        for f in range(F):
            if not prep["usable"][f]:
                out.append(None)
                continue
            cds = (int(prep["coords"][f, 0]), int(prep["coords"][f, 1]))
            ref = int(prep["refs"][f])
            black, white = int(prep["blacks"][f]), int(prep["whites"][f])
            if self.fmt == "pcm1":
                wl = words[f].copy()
                cl = crc[f].copy()
                vl = valid[f].copy()
                cb = None
            else:
                wl = words[f].reshape(L * 3, 3).copy()
                cl = crc[f].reshape(L * 3).copy()
                vl = valid[f].copy()         # [L, 3] for refine
                cb = ctrl[f].copy()
            with self.trace.span("pcm_refine"):
                if self.refine and not np.asarray(valid[f]).all():
                    self.trace.count("count_pcm_refined_frames")
                    rows = px_fetch(f)
                    fixed = ld.refine_failed_lines(
                        rows, valid[f], cds, ref, black, white, self.fmt,
                        shift_limit=self.shift_limit,
                        hyst_limit=self.hyst_limit)
                    if self.fmt == "pcm1":
                        for li, (fw, fc) in fixed.items():
                            wl[li] = fw
                            cl[li] = fc
                    else:
                        for (li, part), (fw, fc) in fixed.items():
                            wl[3 * li + part] = fw
                            cl[3 * li + part] = fc
                if self.fmt == "pcm16x0":
                    vl = vl.reshape(L * 3)
                pl, pr = self._pick_edge_bits(wl, cl, cds, W)
                vl = vl | self._crc_ok(wl, cl)  # refined/picked lines count
            out.append(OtherFrameResult(wl, cl, vl, cb, ref, cds,
                                        picked_left=pl, picked_right=pr))
        return out

    def _crc_ok(self, wl, cl):
        from ..ops import stitch_native as sn
        if sn.available():
            return sn.pcm_crc_rows(wl, self.fmt).astype(np.int64) == cl
        from ..formats import pcm1, pcm16x0
        mod = pcm1 if self.fmt == "pcm1" else pcm16x0
        return np.asarray(mod.calc_crc(wl, xp=np)) == cl

    def _pick_edge_bits(self, wl, cl, cds, W):
        """Bit Picker pass for edge-cut lines (pickCutBitsUpPCM1
        binarizer.cpp:6116 / pickCutBitsUpPCM16X0 :6599): lines whose
        coordinates place edge bits off-frame brute-force those bits
        after a failed CRC read.  Mutates wl/cl in place; returns the
        picked-bit count arrays (the false-positive prescan's inputs,
        prescanForFalsePosCRCs :753-836)."""
        n_rows = len(cl)
        pl = np.zeros(n_rows, np.int8)
        pr = np.zeros(n_rows, np.int8)
        from ..ops import stitch_native as sn
        use_native = sn.available()
        spec = ld.SPEC_PCM1 if self.fmt == "pcm1" \
            else ld.SPEC_PCM16X0_FULL
        lcut, rcut = ld.count_cut_bits(
            spec, cds[0], cds[1], W, self.preset.left_bit_pick,
            self.preset.right_bit_pick)
        if lcut == 0 and rcut == 0:
            return pl, pr
        bad = np.nonzero(~self._crc_ok(wl, cl))[0]
        for row in bad:
            part = 0 if self.fmt == "pcm1" else int(row % 3)
            if self.fmt == "pcm16x0" and part == 1:
                continue        # middle part owns no frame edge
            if use_native:
                got = sn.pcm_pick_cut_line(
                    wl[row], cl[row], cds[0], cds[1], W, self.fmt, part,
                    self.preset.left_bit_pick, self.preset.right_bit_pick)
                if got is None:
                    continue
                wl[row] = got[0]
                cl[row] = got[1]
                pl[row], pr[row] = got[2]
                continue
            # Pure-Python twin (the false-positive prescan depends on
            # these picked counts — they must exist without the C core).
            if self.fmt == "pcm1":
                nw, nc, ok, pln, prn, _fb = ld.pick_cut_bits_pcm1(
                    list(wl[row]), int(cl[row]), cds[0], cds[1], W,
                    preset=self.preset)
            else:
                nw, nc, ok, pln, prn, _fb = ld.pick_cut_bits_pcm16x0(
                    list(wl[row]), int(cl[row]), cds[0], cds[1], W,
                    part, preset=self.preset)
            if not ok:
                continue
            wl[row] = nw
            cl[row] = nc
            pl[row], pr[row] = pln, prn
        return pl, pr

    def decode_frames(self, pixels, perm=None):
        prep = self.prepare_frames(pixels, perm=perm)
        if not prep["usable"].any():
            return [None] * pixels.shape[0]
        return self.decode_prepared(pixels, prep, perm=perm)
