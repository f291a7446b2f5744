"""The port's streaming BatchDecoder writes the JAX package's WAVs, byte for
byte, on the CPU (device="cpu").

Mirrors tests/test_batch_driver.py for
sdvpcmdecoder_tpu_torch.pipeline.batch_driver.BatchDecoder: run_native
(the native grid on the capture's raw rows) and run_tpu (the batch grid
on `device`, three captures fused in one dispatch) against the JAX
package's BatchDecoder under the same backend: three concurrent captures
with a dropout, whole dropped frames, a tail round shorter than the
others, captures of two geometries (no fusing), the sweeps of the CLI's
NORMAL and INSANE qualities, the backend selection rules and a killed and
resumed run.
"""
import os

import numpy as np
import pytest
import torch

from test_batch_driver import _make_capture
from sdvpcmdecoder_tpu.pipeline import batch_driver as jbd
from sdvpcmdecoder_tpu.pipeline import ingest as jingest
from sdvpcmdecoder_tpu.synth import encoder as jenc
from sdvpcmdecoder_tpu_torch.formats import stc007
from sdvpcmdecoder_tpu_torch.ops import stitch_native as tsn
from sdvpcmdecoder_tpu_torch.pipeline import batch_driver as tbd
from sdvpcmdecoder_tpu_torch.pipeline import wav
from sdvpcmdecoder_tpu_torch.utils.host import host_call

torch.set_num_threads(1)

BACKENDS = ["native", "tpu"]
STAT_FIELDS = ("frames_total", "frames_no_pcm", "lines_total",
               "lines_valid", "lines_dup", "blocks_total", "blocks_fix_p",
               "blocks_fix_q", "blocks_broken", "samples_out",
               "samples_masked")


def run_both(jobs, tmp, backend, **kw):
    """The JAX decoder and the port's on the same jobs; returns
    (jax WAVs, port WAVs, jax stats, port stats, port decoder)."""
    kw.setdefault("hyst_limit", 1)
    kw.setdefault("shift_limit", 1)
    kw.setdefault("frames_per_round", 2)
    out = {}
    for tag, cls, extra in (("j", jbd.BatchDecoder, {}),
                            ("t", tbd.BatchDecoder, {"device": "cpu"})):
        dec = cls(jobs, backend=backend, **kw, **extra)
        assert dec.backend == backend
        for k, j in enumerate(dec.jobs):
            j.out_path = os.path.join(str(tmp), f"{tag}_{backend}_{k}.wav")
        stats = dec.run()
        out[tag] = ([open(j.out_path, "rb").read() for j in dec.jobs],
                    stats, dec)
    return out["j"][0], out["t"][0], out["j"][1], out["t"][1], out["t"][2]


def assert_stats_equal(ts, js):
    assert list(ts) == list(js)
    for path in js:
        for name in STAT_FIELDS:
            assert getattr(ts[path], name) == getattr(js[path], name), name


@pytest.mark.parametrize("backend", BACKENDS)
def test_three_concurrent_captures(tmp_path, backend):
    jobs, truths = [], {}
    for i in range(3):
        cap = tmp_path / f"cap{i}.y4m"
        truths[str(cap)] = _make_capture(cap, seed=100 + i,
                                         dropout=(i == 1))
        jobs.append((str(cap), str(tmp_path / f"cap{i}.wav")))
    jw, tw, js, ts, dec = run_both(jobs, tmp_path, backend)
    assert tw == jw
    assert_stats_equal(ts, js)
    for i, (cap, _) in enumerate(jobs):
        samples, rate = wav.read_wav(dec.jobs[i].out_path)
        assert rate == 44100
        el = host_call(stc007.expand_sample, np.asarray(truths[cap]))
        out_l = samples[:, 0].astype(np.int64)
        st0 = int(np.nonzero(out_l == el[0])[0][0])
        n_check = min(3 * (3 * 2 * 294 - 160), len(out_l) - st0)
        assert np.mean(out_l[st0:st0 + n_check] != el[:n_check]) < 0.01
    s = ts[jobs[1][0]]
    assert s.lines_valid < s.lines_total
    assert s.blocks_fix_p + s.blocks_fix_q > 0
    if backend == "tpu":
        # three captures of one geometry: one fused dispatch per round
        assert dec.stage_t["dispatch"] > 0 and dec.stage_t["materialize"] > 0
    else:
        assert dec.stage_t["binarize"] > 0


def test_run_tpu_fuses_three_captures_in_one_dispatch(tmp_path,
                                                      monkeypatch):
    jobs = []
    for i in range(3):
        cap = tmp_path / f"cap{i}.y4m"
        _make_capture(cap, seed=7 + i, n_frames=2 + (i == 0))
        jobs.append((str(cap), str(tmp_path / f"cap{i}.wav")))
    from sdvpcmdecoder_tpu_torch.pipeline import v2d as tv2d
    shapes = []
    orig = tv2d.V2DDriver.dispatch_frames_async

    def spy(self, pixels, prep):
        shapes.append(pixels.shape[0])
        return orig(self, pixels, prep)

    monkeypatch.setattr(tv2d.V2DDriver, "dispatch_frames_async", spy)
    jw, tw, js, ts, _ = run_both(jobs, tmp_path, "tpu")
    assert tw == jw
    # round 0: 3 captures x 2 frames fused; round 1: capture 0's tail alone
    assert shapes == [6, 1]


@pytest.mark.parametrize("backend", BACKENDS)
def test_dropped_frame_keeps_timing(tmp_path, backend):
    rng = np.random.default_rng(55)
    n_frames, lpf = 5, 294
    n = 3 * n_frames * 2 * lpf
    left = rng.integers(1, 1 << 14, size=n)
    right = rng.integers(1, 1 << 14, size=n)
    vids = []
    for k, fr in enumerate(jenc.encode_fields(left, right, n_frames,
                                              lines_pf=lpf)):
        pixels, _ = jenc.render_lines(fr["line_words"], fr["crcs"],
                                      width=1152, ppb=8.0)
        img = np.zeros((2 * lpf, 1152), np.uint8)
        if k not in (0, 2):
            img[0::2] = pixels[:lpf]
            img[1::2] = pixels[lpf:]
        vids.append(img)
    cap = tmp_path / "drop.y4m"
    jingest.write_y4m(cap, np.stack(vids))
    jobs = [(str(cap), str(tmp_path / "drop.wav"))]
    jw, tw, js, ts, _ = run_both(jobs, tmp_path, backend)
    assert tw == jw
    assert_stats_equal(ts, js)
    s = ts[str(cap)]
    assert s.frames_no_pcm == 1 and s.lines_total == 5 * 2 * lpf


@pytest.mark.parametrize("backend", BACKENDS)
def test_two_geometries_and_the_tail_round(tmp_path, backend):
    """A PAL and an NTSC capture never fuse; 5 frames at 2 per round end
    on a one-frame tail round."""
    jobs = []
    for i, lpf in enumerate((294, 245)):
        cap = tmp_path / f"g{i}.y4m"
        _make_capture(cap, seed=40 + i, n_frames=5 - i, lpf=lpf)
        jobs.append((str(cap), str(tmp_path / f"g{i}.wav")))
    jw, tw, js, ts, _ = run_both(jobs, tmp_path, backend,
                                 lines_per_field=None)
    assert tw == jw
    assert_stats_equal(ts, js)


def _noisy_capture(path, seed, n_frames, lpf, sigma):
    rng = np.random.default_rng(seed)
    n = 3 * n_frames * 2 * lpf
    vids = []
    for fr in jenc.encode_fields(rng.integers(1, 1 << 14, n),
                                 rng.integers(1, 1 << 14, n), n_frames,
                                 lines_pf=lpf):
        pixels, _ = jenc.render_lines(fr["line_words"], fr["crcs"],
                                      width=1152, ppb=8.0,
                                      noise_sigma=sigma, rng=rng)
        img = np.zeros((2 * lpf, 1152), np.uint8)
        img[0::2] = pixels[:lpf]
        img[1::2] = pixels[lpf:]
        vids.append(img)
    jingest.write_y4m(path, np.stack(vids))
    return str(path)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("quality", ["normal", "insane"])
def test_sweep_qualities_match_jax(tmp_path, backend, quality):
    """The CLI's NORMAL (prescan sweep + per-line sweep fallback) and
    INSANE (full sweep) settings on noisy captures of 48 lines a field."""
    jobs = [(_noisy_capture(tmp_path / f"n{i}.y4m", 60 + i, 4, 48, 36.0),
             str(tmp_path / f"n{i}.wav")) for i in range(2)]
    kw = dict(hyst_limit=4, shift_limit=2, normal_sweep_prescan=True,
              ref_sweep=quality == "insane",
              ref_sweep_fallback=quality == "normal",
              lines_per_field=None)
    jw, tw, js, ts, dec = run_both(jobs, tmp_path, backend, **kw)
    assert tw == jw
    assert_stats_equal(ts, js)
    assert sum(j.driver.sweep_calls for j in dec.jobs) > 0
    assert all(len(w) > 2000 for w in tw)


def test_backend_selection_rules(tmp_path, monkeypatch):
    """On the CPU JAX's rules: auto -> SDV_BACKEND -> native when the core
    is there, else "tpu"; an explicit native without the core degrades to
    "tpu". On a CUDA device auto is "tpu", the grid on the card, and
    native an explicit choice."""
    cap = tmp_path / "c.y4m"
    _make_capture(cap, seed=1, n_frames=1)
    jobs = [(str(cap), str(tmp_path / "c.wav"))]

    def backend_of(cls, **kw):
        dec = cls(jobs, **kw)
        for j in dec.jobs:
            j.reader.close()
        return dec.backend, type(dec.pool).__name__

    assert tsn.available()
    for be in ("auto", "native", "tpu"):
        assert backend_of(tbd.BatchDecoder, backend=be, device="cpu") == \
            backend_of(jbd.BatchDecoder, backend=be)
    assert tbd.resolve_auto_backend("cpu") == "native"
    for dev in ("cuda", "cuda:0"):   # constructing allocates nothing
        assert tbd.resolve_auto_backend(dev) == "tpu"
        assert backend_of(tbd.BatchDecoder, device=dev)[0] == "tpu"
        assert backend_of(tbd.BatchDecoder, backend="native",
                          device=dev)[0] == "native"
    assert backend_of(tbd.BatchDecoder)[0] == "tpu"   # device="cuda"
    monkeypatch.setenv("SDV_BACKEND", "native")
    assert backend_of(tbd.BatchDecoder, device="cuda")[0] == "native"
    monkeypatch.setenv("SDV_BACKEND", "tpu")
    assert backend_of(tbd.BatchDecoder, device="cpu")[0] == "tpu" == \
        backend_of(jbd.BatchDecoder)[0]
    monkeypatch.delenv("SDV_BACKEND")
    monkeypatch.setattr(tsn, "available", lambda: False)
    assert backend_of(tbd.BatchDecoder, device="cpu")[0] == "tpu"
    assert backend_of(tbd.BatchDecoder, backend="native",
                      device="cpu")[0] == "tpu"
    assert backend_of(tbd.BatchDecoder, device="cpu", workers=1)[1] == \
        "_InlineExecutor"
    # PCM-1/16x0: the round loop is the host's (as in JAX); "auto" puts
    # the PCMFrameDriver's trial grid on a CUDA device, and JAX's rule
    # (native when the core is there) holds only for device="cpu".
    monkeypatch.undo()
    from sdvpcmdecoder_tpu_torch.pipeline import v2d_other
    for fmt in ("pcm1", "pcm16x0", "pcm1630"):
        for dev, want in (("cuda", "tpu"), ("cuda:0", "tpu"),
                          ("cpu", "native")):
            dec = tbd.BatchDecoder(jobs, fmt=fmt, device=dev)
            for j in dec.jobs:
                j.reader.close()
            assert dec.backend == "native"
            assert dec.jobs[0].driver.backend == want, (fmt, dev)
            assert dec.jobs[0].driver.device == torch.device(dev)
        dec = tbd.BatchDecoder(jobs, fmt=fmt, backend="native",
                               device="cuda")
        dec.jobs[0].reader.close()
        assert dec.jobs[0].driver.backend == "native"
    for fmt in ("pcm1", "pcm16x0"):
        assert v2d_other.PCMFrameDriver(fmt).backend == "tpu"
        assert v2d_other.PCMFrameDriver(fmt, device="cuda:0").backend \
            == "tpu"
        assert v2d_other.PCMFrameDriver(fmt, device="cpu").backend \
            == "native"
        assert v2d_other.PCMFrameDriver(fmt, backend="native").backend \
            == "native"


def test_run_dispatches_on_backend(tmp_path, monkeypatch):
    cap = tmp_path / "c.y4m"
    _make_capture(cap, seed=2, n_frames=2)
    called = []
    monkeypatch.setattr(tbd.BatchDecoder, "run_native",
                        lambda self: called.append("native"))
    monkeypatch.setattr(tbd.BatchDecoder, "run_tpu",
                        lambda self: called.append("tpu"))
    for be in ("native", "tpu"):
        tbd.BatchDecoder([(str(cap), str(tmp_path / "o.wav"))], backend=be,
                         device="cpu").run()
    assert called == ["native", "tpu"]


def test_step_native_kill_and_resume(tmp_path):
    """Killed between rounds with checkpoints on, a second decoder resumes
    and the WAV equals the uninterrupted one (and the JAX package's)."""
    cap = tmp_path / "c.y4m"
    _make_capture(cap, seed=9, n_frames=6)
    ref_job = [(str(cap), str(tmp_path / "ref.wav"))]
    jbd.BatchDecoder(ref_job, hyst_limit=1, shift_limit=1,
                     frames_per_round=2, backend="native").run()
    job = [(str(cap), str(tmp_path / "out.wav"))]
    kw = dict(hyst_limit=1, shift_limit=1, frames_per_round=2,
              backend="native", checkpoint=True, device="cpu")
    dec = tbd.BatchDecoder(job, **kw)
    assert dec.step_native() and dec.step_native()
    assert os.path.exists(str(tmp_path / "out.wav.ckpt.json"))
    del dec
    dec2 = tbd.BatchDecoder(job, **kw)
    assert dec2.jobs[0].frames_read == 4
    dec2.run()
    assert (tmp_path / "out.wav").read_bytes() == \
        (tmp_path / "ref.wav").read_bytes()
    assert not os.path.exists(str(tmp_path / "out.wav.ckpt.json"))
