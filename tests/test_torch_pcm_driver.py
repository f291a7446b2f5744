"""The port's PCM drivers against the JAX package's, exactly:
PCMFrameDriver over several batches in a row (results, dtypes and the
coordinate history, good-params skip and forced search it carries),
probe_format, BatchDecoder in every PCM format and in "auto" under both
backends, a JAX checkpoint resumed by the port's BatchDecoder, and
DevicePCMBatchDecoder on the CPU (its prefetched and its gathered
prescan rows, one copy per round of the frames it refines).
"""
import dataclasses
import inspect
import os

import numpy as np
import pytest
import torch

import chip_smoke
from sdvpcmdecoder_tpu.pipeline import batch_driver as jbd
from sdvpcmdecoder_tpu.pipeline import device_pcm as jdp
from sdvpcmdecoder_tpu.pipeline import ingest as jingest
from sdvpcmdecoder_tpu.pipeline import probe as jprobe
from sdvpcmdecoder_tpu.pipeline import v2d_other as jvo
from sdvpcmdecoder_tpu_torch.pipeline import batch_driver as tbd
from sdvpcmdecoder_tpu_torch.pipeline import device_pcm as tdp
from sdvpcmdecoder_tpu_torch.pipeline import ingest
from sdvpcmdecoder_tpu_torch.pipeline import probe as tprobe
from sdvpcmdecoder_tpu_torch.pipeline import v2d_other as tvo

torch.set_num_threads(1)

WRITERS = {"pcm1": chip_smoke.write_pcm1_capture,
           "pcm16x0": chip_smoke.write_pcm16x0_capture,
           "pcm1630": chip_smoke.write_pcm1630_capture}


def capture(tmp_path, fmt, n_frames=4, seed=40, noise=0.0):
    path = str(tmp_path / f"{fmt}_{seed}_{noise}.y4m")
    if noise:
        return chip_smoke.write_pcm_noisy(path, fmt, n_frames, seed, noise)
    return WRITERS[fmt](path, n_frames=n_frames, seed=seed)


def fields(path):
    with ingest.open_capture(path) as rd:
        return ingest.split_fields_batch(rd.read_frames(0, rd.n_frames))[0]


def driver_state(d):
    return (list(map(tuple, d.coord_history)), d._frames_since_search,
            d._last_good, d._force_search)


def assert_results_equal(jres, tres):
    assert len(jres) == len(tres)
    for a, b in zip(jres, tres):
        assert (a is None) == (b is None)
        if a is None:
            continue
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
                assert x.dtype == y.dtype, (f.name, x.dtype, y.dtype)
                np.testing.assert_array_equal(x, y, err_msg=f.name)
            else:
                assert x == y, f.name


@pytest.mark.parametrize("backend", ["tpu", "native"])
@pytest.mark.parametrize("fmt,noise", [("pcm1", 0.0), ("pcm1", 30.0),
                                       ("pcm16x0", 26.0)])
def test_pcm_frame_driver_batches_match_jax(tmp_path, fmt, noise, backend):
    """Three batches of two frames in a row through one driver of each
    package: equal results and equal carried state after every batch
    (noise 30 / 26: lines fail and refine_failed_lines runs)."""
    lines = fields(capture(tmp_path, fmt, n_frames=6, noise=noise))
    kw = dict(shift_limit=1, hyst_limit=2, refine=True, backend=backend)
    jd = jvo.PCMFrameDriver(fmt, **kw)
    td = tvo.PCMFrameDriver(fmt, device="cpu", **kw)
    assert td.backend == backend
    for b in range(3):
        batch = lines[2 * b:2 * b + 2]
        assert_results_equal(jd.decode_frames(batch),
                             td.decode_frames(batch))
        assert driver_state(jd) == driver_state(td)


def test_pcm_frame_driver_prepare_from_sample_rows(tmp_path):
    """prepare_frames on [F * 4, W] pre-gathered rows (the device
    driver's read-back) equals the gather from the frames."""
    lines = fields(capture(tmp_path, "pcm1", n_frames=3))
    F, L, W = lines.shape
    rows = tvo.PCMFrameDriver.prescan_rows(L)
    assert list(rows) == list(jvo.PCMFrameDriver.prescan_rows(L))
    sample = lines[:, rows, :].reshape(F * len(rows), W)
    a = tvo.PCMFrameDriver("pcm1", device="cpu").prepare_frames(lines)
    b = tvo.PCMFrameDriver("pcm1", device="cpu").prepare_frames(
        None, sample=sample, shape=(F, L, W))
    j = jvo.PCMFrameDriver("pcm1").prepare_frames(lines)
    for k in a:
        assert a[k].dtype == b[k].dtype == j[k].dtype
        np.testing.assert_array_equal(a[k], b[k])
        np.testing.assert_array_equal(a[k], j[k])


def test_probe_format_matches_jax(tmp_path):
    caps = {"pcm1": capture(tmp_path, "pcm1", n_frames=2),
            "pcm16x0": capture(tmp_path, "pcm16x0", n_frames=2),
            "stc007": chip_smoke.write_capture(str(tmp_path / "s.y4m"), 2,
                                               294, seed=1)}
    for want, cap in caps.items():
        got = tprobe.probe_capture(cap)
        assert got == jprobe.probe_capture(cap)
        assert got[0] == want, got
    noise = np.random.default_rng(0).integers(0, 256, (2, 490, 1024),
                                              dtype=np.uint8)
    assert tprobe.probe_format(noise) == jprobe.probe_format(noise)
    assert tprobe.probe_format(noise)[0] is None


def run_bd(mod, jobs, tmp_path, tag, **kw):
    outs = [str(tmp_path / f"{tag}_{k}.wav") for k in range(len(jobs))]
    dec = mod.BatchDecoder(list(zip(jobs, outs)), **kw)
    dec.run()
    return [open(o, "rb").read() for o in outs], dec


@pytest.mark.parametrize("fmt", ["pcm1", "pcm16x0", "pcm1630"])
def test_batch_decoder_formats_match_jax(tmp_path, fmt):
    jobs = [capture(tmp_path, fmt, n_frames=3, seed=40 + k)
            for k in range(2 if fmt == "pcm1" else 1)]
    kw = dict(shift_limit=1, frames_per_round=2, fmt=fmt)
    ref, _ = run_bd(jbd, jobs, tmp_path, "j", **kw)
    assert all(len(w) > 1000 for w in ref)
    for backend in ("tpu", "native"):
        got, dec = run_bd(tbd, jobs, tmp_path, backend, backend=backend,
                          device="cpu", **kw)
        assert got == ref, backend
        assert dec.jobs[0].driver.backend == backend
        assert dec.jobs[0].stats.lines_valid > 0


def test_batch_decoder_auto_probes_and_matches_jax(tmp_path):
    jobs = [capture(tmp_path, "pcm16x0", n_frames=3, seed=50 + k)
            for k in range(2)]
    ref, jdec = run_bd(jbd, jobs, tmp_path, "j", shift_limit=1, fmt="auto")
    got, tdec = run_bd(tbd, jobs, tmp_path, "t", shift_limit=1, fmt="auto",
                       device="cpu")
    assert got == ref and tdec.fmt == jdec.fmt == "pcm16x0"
    mixed = [jobs[0], capture(tmp_path, "pcm1", n_frames=2)]
    with pytest.raises(ValueError, match="probe disagrees"):
        tbd.BatchDecoder([(c, str(tmp_path / "m.wav")) for c in mixed],
                         fmt="auto", device="cpu")


@pytest.mark.parametrize("fmt", ["pcm1", "pcm16x0"])
def test_jax_checkpoint_resumes_in_the_port(tmp_path, fmt):
    """A JAX BatchDecoder killed after two rounds leaves its checkpoint;
    the port's BatchDecoder resumes it into the WAV of an uninterrupted
    JAX run."""
    cap = capture(tmp_path, fmt, n_frames=6, seed=61)
    kw = dict(shift_limit=1, frames_per_round=2, fmt=fmt, backend="native")
    ref, _ = run_bd(jbd, [cap], tmp_path, "ref", **kw)
    out = str(tmp_path / "out.wav")
    dec1 = jbd.BatchDecoder([(cap, out)], checkpoint=True, **kw)
    dec1.step_native()
    dec1.step_native()
    assert os.path.exists(out + ".ckpt.json")
    dec2 = tbd.BatchDecoder([(cap, out)], checkpoint=True, device="cpu",
                            **kw)
    assert dec2.jobs[0].frame_no == 4
    dec2.run()
    assert open(out, "rb").read() == ref[0]
    assert not os.path.exists(out + ".ckpt.json")


def run_device(mod, jobs, tmp_path, tag, **kw):
    outs = [str(tmp_path / f"{tag}_{k}.wav") for k in range(len(jobs))]
    if mod is tdp:
        kw["device"] = "cpu"
    dec = mod.DevicePCMBatchDecoder(list(zip(jobs, outs)), **kw)
    dec.run()
    return [open(o, "rb").read() for o in outs], dec


@pytest.mark.parametrize("fmt,noise", [("pcm1", 0.0), ("pcm1", 14.0),
                                       ("pcm1", 30.0), ("pcm16x0", 0.0),
                                       ("pcm16x0", 26.0), ("pcm1630", 0.0)])
def test_device_pcm_matches_jax_and_native(tmp_path, fmt, noise):
    """tests/test_device_pcm.py's comparison (the device driver's WAVs
    equal the native BatchDecoder's), and the JAX device driver's WAVs,
    with noise that fails lines (30 / 26) so frames are refined."""
    n = 4 if fmt == "pcm1630" else 6
    jobs = [capture(tmp_path, fmt, n_frames=n, seed=40 + i, noise=noise)
            for i in range(2)]
    kw = dict(fmt=fmt, shift_limit=1, frames_per_round=3)
    got, dec = run_device(tdp, jobs, tmp_path, "t", **kw)
    assert got == run_device(jdp, jobs, tmp_path, "j", **kw)[0]
    ref, _ = run_bd(tbd, jobs, tmp_path, "n", backend="native",
                    device="cpu", **kw)
    assert got == ref
    rounds = 2 * -(-n // 3)
    if noise in (30.0, 26.0):
        assert 0 < dec.fetch_copies <= rounds
        assert dec.fetched_frames >= dec.fetch_copies
    elif fmt != "pcm1630":   # the clean SI / PCM-1 captures: no failed line
        assert dec.fetched_frames == dec.fetch_copies == 0


@pytest.mark.parametrize("hbm", [256, 3])
def test_device_pcm_prefetched_and_gathered_prescan_rows(tmp_path,
                                                         monkeypatch, hbm):
    """With the capture in one staging chunk every round's prescan rows
    were prefetched a round ahead; with a chunk per round they are
    gathered at dispatch (the prefetch stops at the chunk's edge). Both
    write the native BatchDecoder's WAV."""
    cap = capture(tmp_path, "pcm16x0", n_frames=6, seed=5)
    callers = []
    gather = tdp._gather_sample

    def spy(px, idx):
        callers.append(inspect.stack()[1].function)
        return gather(px, idx)
    monkeypatch.setattr(tdp, "_gather_sample", spy)
    got, dec = run_device(tdp, [cap], tmp_path, "t", fmt="pcm16x0",
                          shift_limit=1, frames_per_round=3,
                          hbm_frames=hbm)
    ref, _ = run_bd(tbd, [cap], tmp_path, "n", fmt="pcm16x0",
                    shift_limit=1, frames_per_round=3, backend="native",
                    device="cpu")
    assert got == ref
    assert dec.jobs[0].stage_next == 6
    if hbm == 3:
        assert callers == ["_prefetch_sample", "_dispatch"]
    else:
        assert callers == ["_prefetch_sample", "_prefetch_sample"]


def test_device_pcm_refuses_other_formats_and_defaults_to_the_card(
        tmp_path):
    cap = capture(tmp_path, "pcm1", n_frames=1)
    with pytest.raises(ValueError, match="unsupported"):
        tdp.DevicePCMBatchDecoder([(cap, "o.wav")], fmt="stc007",
                                  device="cpu")
    sig = inspect.signature(tdp.DevicePCMBatchDecoder.__init__)
    assert sig.parameters["device"].default == "cuda"


def test_jax_capture_reader_reads_the_writers_bytes(tmp_path):
    """The chip_smoke writers' captures read back the same through both
    packages' readers."""
    cap = capture(tmp_path, "pcm16x0", n_frames=2)
    with ingest.open_capture(cap) as a, jingest.open_capture(cap) as b:
        np.testing.assert_array_equal(a.read_frames(0, 2),
                                      b.read_frames(0, 2))
