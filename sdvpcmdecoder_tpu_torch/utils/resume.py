"""Checkpoint/resume for long batch decodes — all three format paths.

The reference streams one-pass with no resume (SURVEY.md section 5); its
only mid-run durability is the WAV header patch-on-flush. Batch jobs over
hours of tape need real resume: frame index, stitcher carry state and the
output sample count, snapshotted as a JSON + npz pair next to the WAV.

Carry state per stitcher kind:
  * STC007Stitcher — two-frame sliding window: frame descriptors, 65-deep
    stats, BROKEN countdown, conv-queue tail, unpaired pending frames;
  * PCM16X0Stitcher — single-frame, but 65-deep padding/order and
    control-bit histories plus the (possibly auto-switched) SI/EI format;
  * PCM1Stitcher — single-frame, only the file-started flag.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np

FORMAT_VERSION = 4


def _kind(stitcher):
    return type(stitcher).__name__


def save_checkpoint(path, frame_index: int, stitcher,
                    samples_written: int, sample_rate: int = 44100,
                    audio=None, driver=None):
    """`audio`: AudioProcessor whose withheld drain-boundary carry must
    survive the restart (a dropout spanning the kill point would
    otherwise re-emit differently); `driver`: V2DDriver whose coordinate
    /reference damping histories feed the next frame's prescan."""
    from ..pipeline import stitcher_stc007 as st
    path = Path(path)
    kind = _kind(stitcher)
    meta = dict(
        version=FORMAT_VERSION,
        kind=kind,
        frame_index=frame_index,
        samples_written=samples_written,
        sample_rate=sample_rate,
    )
    arrays = {}
    if audio is not None:
        carry = audio.carry_state()
        meta["audio_carry"] = carry is not None
        meta["audio_total_masked"] = int(audio.total_masked)
        if carry is not None:
            arrays["audio_carry_samples"] = carry[0]
            arrays["audio_carry_valid"] = carry[1]
    if driver is not None:
        hist = getattr(driver, "state", driver)
        meta["v2d_coord_history"] = \
            [[int(a), int(b)] for a, b in hist.coord_history]
        meta["v2d_ref_history"] = \
            [int(r) for r in getattr(hist, "ref_history", [])]
        if hasattr(driver, "_frames_since_search"):
            # PCMFrameDriver good-params skip: a resumed run must make
            # the same search-vs-reuse decision as an uninterrupted one.
            meta["v2d_search_state"] = [int(driver._frames_since_search),
                                        bool(driver._last_good),
                                        bool(driver._force_search)]
    if kind == "STC007Stitcher":
        meta.update(
            frasm_f0=dataclasses.asdict(stitcher.frasm_f0),
            frasm_f1=dataclasses.asdict(stitcher.frasm_f1),
            stats_field_order=stitcher.stats_field_order,
            stats_resolution=stitcher.stats_resolution,
            broken_countdown=stitcher.broken_countdown,
            mode_m2=stitcher.mode_m2,
            pending_nos=[fno for fno, _ in stitcher.pending_frames],
        )
        conv = stitcher.conv_queue
        arrays.update({f: getattr(conv, f) for f in st.LineStore.FIELDS})
        # The sliding window's unpaired frames must survive the restart
        # or the first resumed frame would never be seam-stitched.
        for i, (_, store) in enumerate(stitcher.pending_frames):
            for f in st.LineStore.FIELDS:
                arrays[f"pend{i}_{f}"] = getattr(store, f)
    elif kind == "PCM16X0Stitcher":
        meta.update(
            stats_padding=stitcher.stats_padding,
            stats_order=stitcher.stats_order,
            stats_emph=[bool(x) for x in stitcher.stats_emph],
            stats_rate=[int(x) for x in stitcher.stats_rate],
            stats_code=[bool(x) for x in stitcher.stats_code],
            stats_mode=[bool(x) for x in stitcher.stats_mode],
            fmt=stitcher.fmt,
            file_started=stitcher.file_started,
        )
    elif kind == "PCM1Stitcher":
        meta.update(file_started=stitcher.file_started)
    else:
        raise TypeError(f"unknown stitcher kind {kind}")
    Path(str(path) + ".json").write_text(json.dumps(meta))
    np.savez_compressed(Path(str(path) + ".npz"), **arrays)


def load_checkpoint(path, stitcher, audio=None, driver=None):
    """Restore stitcher (+ audio carry + V2D history) state; returns
    (frame_index, samples_written, sample_rate)."""
    from ..pipeline import stitcher_stc007 as st
    path = Path(path)
    meta = json.loads(Path(str(path) + ".json").read_text())
    assert meta["version"] in (2, 3, FORMAT_VERSION)
    if audio is not None and "audio_carry" in meta:
        audio.total_masked = int(meta.get("audio_total_masked", 0))
        if meta["audio_carry"]:
            data = np.load(Path(str(path) + ".npz"))
            audio.set_carry_state((data["audio_carry_samples"],
                                   data["audio_carry_valid"]))
        else:
            audio.set_carry_state(None)
    if driver is not None and "v2d_coord_history" in meta:
        hist = getattr(driver, "state", driver)
        hist.coord_history = \
            [(int(a), int(b)) for a, b in meta["v2d_coord_history"]]
        if hasattr(hist, "ref_history"):
            hist.ref_history = [int(r) for r in meta["v2d_ref_history"]]
        if hasattr(driver, "_frames_since_search") \
                and "v2d_search_state" in meta:
            st = meta["v2d_search_state"]
            driver._frames_since_search = int(st[0])
            driver._last_good = bool(st[1])
            driver._force_search = bool(st[2]) if len(st) > 2 \
                else not driver._last_good
    kind = meta.get("kind", "STC007Stitcher")
    assert kind == _kind(stitcher), \
        f"checkpoint is for {kind}, not {_kind(stitcher)}"
    if kind == "STC007Stitcher":
        for name in ("frasm_f0", "frasm_f1"):
            setattr(stitcher, name, st.FrameAsm(**meta[name]))
        stitcher.frasm_f2 = st.FrameAsm()
        stitcher.stats_field_order = list(meta["stats_field_order"])
        stitcher.stats_resolution = list(meta["stats_resolution"])
        stitcher.broken_countdown = int(meta["broken_countdown"])
        stitcher.mode_m2 = bool(meta.get("mode_m2", stitcher.mode_m2))
        data = np.load(Path(str(path) + ".npz"))
        conv = st.LineStore(0)
        for f in st.LineStore.FIELDS:
            setattr(conv, f, data[f])
        stitcher.conv_queue = conv
        stitcher.pending_frames = []
        for i, fno in enumerate(meta.get("pending_nos", [])):
            store = st.LineStore(0)
            for f in st.LineStore.FIELDS:
                setattr(store, f, data[f"pend{i}_{f}"])
            stitcher.pending_frames.append((int(fno), store))
    elif kind == "PCM16X0Stitcher":
        stitcher.stats_padding = list(meta["stats_padding"])
        stitcher.stats_order = list(meta["stats_order"])
        stitcher.stats_emph = [bool(x) for x in meta["stats_emph"]]
        stitcher.stats_rate = [int(x) for x in meta["stats_rate"]]
        stitcher.stats_code = [bool(x) for x in meta["stats_code"]]
        stitcher.stats_mode = [bool(x) for x in meta["stats_mode"]]
        stitcher.fmt = int(meta["fmt"])
        stitcher.file_started = bool(meta["file_started"])
    elif kind == "PCM1Stitcher":
        stitcher.file_started = bool(meta["file_started"])
    return (int(meta["frame_index"]), int(meta["samples_written"]),
            int(meta.get("sample_rate", 44100)))
