"""The benchmark's PCM-1 configuration on the CPU (bench_port/configs/
pcm1_ntsc_normal.json): DevicePCMBatchDecoder built from the
configuration's `decoder` against the plain reference
(bench_port/formats/pcm1), a line read with a bad CRC, the control, the
harness's faults under the timed path, the PCM path's spans and counters
and the readers of its per-layer metrics, `Tracer.count` under threads;
and two sweeps where the port departs from the JAX package: the PCM-16x0
lock a step off, and a PCM-1 first sweep whose lone hit is a CRC
collision.
"""
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from bench_port import cells, compare, harness, media as sg
from bench_port.tests import test_bench_port_runs as runs
from bench_port.tests.helpers import cpu_run, small_cell
from sdvpcmdecoder_tpu.pipeline import device_pcm as jdp
from sdvpcmdecoder_tpu_torch.pipeline import device_pcm as tdp
from sdvpcmdecoder_tpu_torch.utils.trace import Tracer

torch.set_num_threads(1)

CELL = "pcm1_ntsc_normal.tapes8"
CFG = cells.load_json(cells.HERE / "configs" / "pcm1_ntsc_normal.json")
FMT = cells.format_module("pcm1")
CFG16 = cells.load_json(cells.HERE / "configs" / "pcm16x0_si_normal.json")
FMT16 = cells.format_module("pcm16x0")
# The benchmark's PCM cells: (configuration, format module, control bits,
# one below the configuration's).
PCM_CELLS = {CELL: (CFG, FMT, 12),
             "pcm16x0_si_normal.tapes8": (CFG16, FMT16, 15)}
PCM_SPANS = {"pcm_agc", "pcm_round", "pcm_refine"}
METRICS = ("pcm_agc_ms_per_frame", "pcm_round_ms_per_frame",
           "pcm_refine_ms_per_frame", "pcm_refined_frame_share",
           "pcm_native_frame_share", "pcm_coord_search_ms_per_frame",
           "pcm_coord_search_share", "pcm_refined_line_share")


def write(tmp_path, name, frames):
    path = str(tmp_path / f"{name}.y4m")
    sg.write_y4m(path, frames)
    return path


def clean_capture(n_frames, seed, cfg=CFG, fmt=FMT):
    return fmt.make_capture(cfg, n_frames, np.random.default_rng(seed), None,
                            "cpu")


def decode(paths, cfg=CFG, **over):
    """The configuration's decoder, as the harness builds it, on the CPU;
    returns (the WAVs' samples, the decoder)."""
    cls, kw = harness.driver(cfg, "cpu")
    dec = cls([(p, p + ".wav") for p in paths], **dict(kw, **over))
    dec.run()
    return [sg.read_wav(p + ".wav") for p in paths], dec


def test_reference_reads_a_clean_capture_as_its_samples():
    frames, t = clean_capture(3, 5)
    ref, valid, intact = FMT.reference(CFG, frames)
    assert ref.shape == (3 * 2 * 735, 2)
    assert valid.all() and (intact == valid).all()
    np.testing.assert_array_equal(ref, FMT.truth(t))


def test_interleave_and_expansion_as_the_upstream_describes():
    """The 735 pairs of a field take 735 distinct sublines, block n
    within sublines 92n .. 92n + 91, consecutive pairs of one stripe one
    subline apart, the stripes swapping from block to block; the
    expansion's two ranges and their signs."""
    s = FMT.pair_sublines()
    assert sorted(s) == list(range(735))
    n = np.arange(735) // 92
    assert ((s // 92) == n).all()
    assert s[0] == 46 and s[1] == 0 and s[92] == 92 and s[93] == 138
    assert (np.diff(s[0:92:2]) == 1).all()
    w = np.array([0x0001, 0x07FF, 0x0800, 0x0FFF, 0x1001, 0x17FF,
                  0x1800, 0x1FFF])
    np.testing.assert_array_equal(
        FMT.expand(w), [16, 32752, -32768, -16, 4, 8188, -8192, -4])


@pytest.mark.parametrize("cell", sorted(PCM_CELLS))
def test_device_pcm_decoder_writes_the_reference_samples(cell, tmp_path):
    """Two clean captures through the configuration's decoder: every
    word the reference reads is in the WAV at offset 0, none wrong, and
    it is the sample the capture was made from."""
    cfg, fmt, _ = PCM_CELLS[cell]
    caps = [clean_capture(6, 10 + k, cfg, fmt) for k in range(2)]
    paths = [write(tmp_path, f"c{k}", f) for k, (f, _) in enumerate(caps)]
    wavs, dec = decode(paths, cfg)
    assert isinstance(dec, tdp.DevicePCMBatchDecoder)
    for (frames, t), (samples, rate, _, _) in zip(caps, wavs):
        assert rate in cfg["rates"]
        ref, valid, intact = fmt.reference(cfg, frames)
        v = compare.judge(samples, ref, valid, intact, fmt.truth(t))
        assert v["valid"] == ref.size and v["offset"] == 0
        assert v["wrong"] == v["wrong_intact"] == v["wrong_masked"] == 0
        np.testing.assert_array_equal(ref, fmt.truth(t))


def test_a_line_with_flipped_bits_is_invalid_and_interpolated(tmp_path):
    """Three bit cells of one line inverted: the reference marks that
    line's three pairs (spread by the interleave) invalid and nothing else;
    the WAV holds the reference's words elsewhere and, in each of the
    three, the mean of its two neighbours (word-scope interpolation)."""
    frames, t = clean_capture(4, 3)
    frames = frames.copy()
    x0 = CFG["signal"]["start_px"] + 10 * 20
    row = frames[1, 200]                 # frame 1, field 1, line 100
    row[x0:x0 + 30] = 220 - row[x0:x0 + 30]
    (samples, _, _, _), = decode([write(tmp_path, "flip", frames)])[0]
    ref, valid, intact = FMT.reference(CFG, frames)
    bad = np.nonzero(~valid.all(1))[0]
    assert len(bad) == 3 and (~valid).sum() == 6
    assert (bad // 1470 == 1).all() and ((bad % 1470) < 735).all()
    ok = valid.all(1)
    np.testing.assert_array_equal(samples[ok], ref[ok])
    assert (samples[bad] != ref[bad]).any()
    for b in bad:
        mid = (samples[b - 1].astype(np.int64) + samples[b + 1]) / 2
        assert (np.abs(samples[b] - mid) <= 1).all(), samples[b - 1:b + 2]
    v = compare.judge(samples, ref, valid, intact, FMT.truth(t))
    assert v["wrong"] == 0


@pytest.mark.parametrize("cell", sorted(PCM_CELLS))
def test_a_sound_run_is_correct(cell, tmp_path):
    """The cell at a small size through the harness."""
    out = cpu_run(small_cell(cell), tmp_path)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 2 and out["failed"] == 0
    assert set(out["metrics"]) == {"frames_per_s", "setup_s"}


@pytest.mark.parametrize("name", sorted(PCM_CELLS))
def test_a_traced_run_reads_every_metric_the_cell_lists(name, tmp_path):
    """Every per-layer metric BENCHMARK.json lists for the cell, the shared
    layers' and the PCM path's, reads a value from the program; only the
    device trace's need a card."""
    torch.set_num_threads(2)
    cell = small_cell(name)
    out = harness.run_cell(cell, 11, 0.5, True, "cpu", 0.0, tmp_path)
    assert out["correct"], out["checks"]
    want = {m["name"] for m in cell.per_layer
            if m["source"] != "device_trace"}
    assert set(METRICS) <= want and len(want) == 22
    assert want <= set(out["metrics"])


@pytest.mark.parametrize("cell", sorted(PCM_CELLS))
def test_the_control_is_not_correct(cell, tmp_path):
    """The reference one bit below the configuration's (PCM-1 12 of 13,
    PCM-16x0 15 of 16) in the program's place."""
    out = cpu_run(small_cell(cell), tmp_path,
                  control_bits=PCM_CELLS[cell][2])
    assert not out["correct"]
    assert out["checks"]["wrong_share"]["value"] > 0.25


@pytest.mark.parametrize("fault", sorted(runs.FAULTS))
def test_a_fault_under_the_timed_path_is_not_correct(fault, tmp_path,
                                                     monkeypatch):
    runs.FAULTS[fault](monkeypatch)
    frames = (16, 20) if fault == "state_unchanged" else (6, 10)
    out = cpu_run(small_cell(CELL, frames=frames), tmp_path)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell", sorted(PCM_CELLS))
def test_the_run_loads_neither_jax_nor_the_jax_package(cell):
    r = subprocess.run([sys.executable, "-c", runs.BLOCKED_RUN, cell],
                       cwd=cells.ROOT, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().endswith("correct True")


def record(dec, frames):
    rec = harness.Record(cell=small_cell(CELL))
    rec.stage_t = dict(dec.stage_t)
    rec.frames = frames
    return rec


def test_spans_and_counters_on_a_clean_capture(tmp_path):
    """The PCM spans are in stage_t, no frame is refined, and the native
    steady call takes every frame but each capture's first (its new-file
    tag leaves that one to the frame-by-frame path)."""
    paths = [write(tmp_path, f"c{k}", clean_capture(5, 20 + k)[0])
             for k in range(2)]
    _, dec = decode(paths)
    t = dec.stage_t
    assert PCM_SPANS <= set(t) and all(t[k] > 0 for k in PCM_SPANS)
    assert t["pcm_agc"] <= t["prescan"] and t["pcm_round"] <= t["dispatch"]
    assert t["pcm_refine"] <= t["finalize"]
    assert "count_pcm_refined_frames" not in t and dec.fetched_frames == 0
    assert "count_pcm_refined_lines" not in t
    assert t["count_pcm_native_frames"] == 10 - 2
    assert 0 < t["pcm_coord_search"] <= t["pcm_agc"]
    assert 1 <= t["count_pcm_coord_searches"] <= 10
    rec = record(dec, 10)
    got = {m: cells.metric_reader(m)(rec) for m in METRICS}
    assert got["pcm_refined_frame_share"] == 0.0
    assert got["pcm_refined_line_share"] == 0.0
    assert got["pcm_native_frame_share"] == 0.8
    assert got["pcm_coord_search_share"] == \
        t["count_pcm_coord_searches"] / 10
    for m in METRICS[:3]:
        assert got[m] == pytest.approx(1e3 * t[m[:-len("_ms_per_frame")]]
                                       / 10)


def test_a_noisy_capture_refines_frames(tmp_path):
    frames, _ = FMT.make_capture(CFG, 4, np.random.default_rng(7),
                                 torch.Generator().manual_seed(7), "cpu",
                                 noise=30.0)
    _, dec = decode([write(tmp_path, "noisy", frames)])
    t = dec.stage_t
    assert t["count_pcm_refined_frames"] == dec.fetched_frames > 0
    assert t["count_pcm_refined_lines"] >= t["count_pcm_refined_frames"]
    rec = record(dec, 4)
    share = cells.metric_reader("pcm_refined_frame_share")(rec)
    assert 0 < share <= 1
    assert cells.metric_reader("pcm_refined_line_share")(rec) == \
        t["count_pcm_refined_lines"] / (4 * 490)


def test_the_readers_read_nothing_from_a_program_without_them():
    """A program without the PCM path's spans and counters: every reader
    gives None; one without the sweep's span: its three give None."""
    rec = harness.Record(cell=small_cell(CELL))
    rec.stage_t = {"dispatch": 1.0, "prescan": 0.5, "finalize": 0.1}
    rec.frames = 100
    assert all(cells.metric_reader(m)(rec) is None for m in METRICS)
    # One with the PCM spans and counters but not the sweep's own.
    rec.stage_t.update(pcm_agc=0.2, pcm_round=0.1, pcm_refine=0.05,
                       count_pcm_refined_frames=3.0)
    assert [cells.metric_reader(m)(rec) for m in METRICS[5:]] == [None] * 3


def test_tracer_counts_lose_no_update_under_two_threads():
    tr = Tracer()
    n = 200_000
    start = threading.Barrier(2)

    def work(step):
        start.wait()
        for _ in range(n):
            tr.count("count_x", step)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k + 1,))
                   for k in range(2)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(interval)
    assert tr.stage_t["count_x"] == 3 * n


def lock_departure(tmp_path, tag):
    """A bench_port PCM-16x0 capture (seed 2, pool tag `tag`, 16 clean
    frames) through the JAX package's driver and the port's, at the
    configuration's settings: (the JAX package's coordinate history, the
    port's decoder, the port's samples, the capture, its truth)."""
    frames, t = FMT16.make_capture(CFG16, 16, sg.rng_for(2, 2, tag), None,
                                   "cpu")
    path = write(tmp_path, "pcm16x0", frames)
    kw = dict(fmt="pcm16x0", hyst_limit=4, shift_limit=2,
              frames_per_round=16, refine=True)
    jdec = jdp.DevicePCMBatchDecoder([(path, path + ".jax.wav")], **kw)
    jdec.run()
    cls, tkw = harness.driver(CFG16, "cpu")
    dec = cls([(path, path + ".wav")], **tkw)
    dec.run()
    got = sg.read_wav(path + ".wav")[0]
    return ([tuple(c) for c in jdec.jobs[0].driver.coord_history], dec, got,
            frames, t)


def assert_port_locks_true(dec, got, frames, t):
    """Every lock of the port's driver within a pixel of the encoder's
    (32, 1383), no frame refined, the reference's samples written."""
    start = CFG16["signal"]["start_px"]
    stop = start + 193 * int(CFG16["signal"]["ppb"])
    history = dec.jobs[0].driver.coord_history
    assert history and all(abs(a - start) <= 1 and abs(b - stop) <= 1
                           for a, b in history), history
    assert dec.fetched_frames == 0
    assert dec.stage_t.get("count_pcm_refined_frames", 0) == 0
    v = compare.judge(got, *FMT16.reference(CFG16, frames), FMT16.truth(t))
    assert v["valid"] == 16 * 2 * 735 * 2 and v["offset"] == 0
    assert v["wrong"] + v["wrong_masked"] == 0


def test_pcm16x0_lock_a_step_off_is_the_jax_packages(tmp_path):
    """A bench_port PCM-16x0 capture (seed 2, pool tag 2, 16 clean frames)
    whose sample lines' subline-0 sweeps lock the JAX package's driver a
    step off, at (30, 1389), so every frame there has failed lines; the
    port's sweep reads all three sublines (a departure), locks within a
    pixel of the encoder's (32, 1383), refines no frame and writes the
    reference's samples."""
    jax_history, dec, got, frames, t = lock_departure(tmp_path, 2)
    assert jax_history[-1] == (30, 1389)
    assert_port_locks_true(dec, got, frames, t)


def test_pcm16x0_lock_a_step_off_on_tag_6_is_the_jax_packages(tmp_path):
    """As above on pool tag 6, where the JAX package ends at (30, 1388)."""
    jax_history, dec, got, frames, t = lock_departure(tmp_path, 6)
    assert jax_history[-1] == (30, 1388)
    assert_port_locks_true(dec, got, frames, t)


def test_pcm1_collision_in_the_first_sweep_does_not_lock(tmp_path):
    """A bench_port PCM-1 capture (seed 4403225545, pool tag 1, 32 clean
    frames) whose first sample line's sweep finds a CRC collision at
    (7, 908): the JAX package's frame driver seeds the other lines with
    it, keeps it, and every later sweep misses the true (31, 972); the
    port sweeps the other lines again from their own edges, locks at
    (31, 972), refines no frame and writes the reference's samples."""
    from sdvpcmdecoder_tpu.pipeline import v2d_other as jv
    from sdvpcmdecoder_tpu_torch.pipeline import ingest
    from sdvpcmdecoder_tpu_torch.pipeline import v2d_other as tv
    frames, t = FMT.make_capture(CFG, 32, sg.rng_for(4403225545, 2, 1),
                                 None, "cpu")
    perm, _ = ingest.field_perm(frames.shape[1])
    coords = {}
    for name, cls in (("jax", jv.PCMFrameDriver),
                      ("port", tv.PCMFrameDriver)):
        drv = cls("pcm1", shift_limit=2, hyst_limit=4, backend="native",
                  **(dict(device="cpu") if cls is tv.PCMFrameDriver
                     else {}))
        prep = drv.prepare_frames(frames, perm=perm)
        coords[name] = [(int(a), int(b))
                        for a, b in prep["coords"][prep["usable"]]]
    assert coords["jax"][0] == (7, 908) and (31, 972) not in coords["jax"]
    assert coords["port"] == [(31, 972)] * 32
    (got,), dec = decode([write(tmp_path, "c", frames)])
    assert dec.fetched_frames == 0
    assert dec.stage_t["count_pcm_refined_frames"] == 0
    v = compare.judge(got[0], *FMT.reference(CFG, frames), FMT.truth(t))
    assert v["wrong"] + v["wrong_masked"] == 0 and v["valid"] > 0
