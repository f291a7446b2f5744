"""The port's chip-resident driver: how it gets its WAVs.

Mirrors tests/test_device_driver.py for
sdvpcmdecoder_tpu_torch.pipeline.device_driver.DeviceBatchDecoder on the
CPU: the speculative round replay engages (the spies sit on the port's
modules), rounds chain their carry on the device, steady rounds never
materialize words on the host, staging in chunks and resuming from a
checkpoint give the uninterrupted WAV, and the presets reach the stitcher.
Every WAV is compared with the JAX package's.
"""
import os

import pytest

import chip_smoke
from sdvpcmdecoder_tpu.pipeline import batch_driver as jbd
from sdvpcmdecoder_tpu.pipeline import device_driver as jdd
from sdvpcmdecoder_tpu_torch.ops import stitch_native as tsn
from sdvpcmdecoder_tpu_torch.pipeline import batch_driver as tbd
from sdvpcmdecoder_tpu_torch.pipeline import device_driver as tdd
from sdvpcmdecoder_tpu_torch.pipeline import stitcher_stc007 as tst

PAL, NTSC = 294, 245


def capture(tmp, name, nf, lpf=PAL, seed=1, noise=0.0):
    return chip_smoke.write_capture(os.path.join(str(tmp), f"{name}.y4m"),
                                    nf, lpf, seed=seed, noise=noise)


def run(cls, jobs, tmp, tag, lpf=PAL, **kw):
    kw.setdefault("frames_per_round", 5)
    kw.setdefault("hyst_limit", 2)
    kw.setdefault("shift_limit", 1)
    dec = cls(jobs, lines_per_field=lpf, **kw)
    for k, j in enumerate(dec.jobs):
        j.out_path = os.path.join(str(tmp), f"{tag}_{k}.wav")
    dec.run()
    return [open(j.out_path, "rb").read() for j in dec.jobs], dec


def native_wav(jobs, tmp, **kw):
    return run(jbd.BatchDecoder, jobs, tmp, "ref", backend="native",
               **kw)[0]


def test_spec_engagement_counts(tmp_path, monkeypatch):
    """On a clean capture nearly every pair replays from the round's
    speculative results: the C spec_round consumes whole rounds, and the
    per-pair device tail stays exceptional."""
    jobs = [(capture(tmp_path, "c", 14, seed=3), str(tmp_path / "o.wav"))]
    hits = [0, 0, 0]   # [round pairs via spec_round, pair replays, tails]
    orig_round = tsn.spec_round
    orig_replay = tst.STC007Stitcher._replay_spec_tail
    orig_tail = tst.STC007Stitcher._steady_tail_tpu

    def spy_round(*a, **k):
        out = orig_round(*a, **k)
        hits[0] += out[0]
        return out

    def spy_replay(self, *a, **k):
        hits[1] += 1
        return orig_replay(self, *a, **k)

    def spy_tail(self, *a, **k):
        hits[2] += 1
        return orig_tail(self, *a, **k)

    monkeypatch.setattr(tsn, "spec_round", spy_round)
    monkeypatch.setattr(tst.STC007Stitcher, "_replay_spec_tail", spy_replay)
    monkeypatch.setattr(tst.STC007Stitcher, "_steady_tail_tpu", spy_tail)
    got, _ = run(tdd.DeviceBatchDecoder, jobs, tmp_path, "dev",
                 device="cpu")
    assert hits[0] + hits[1] >= 10, hits
    assert hits[0] >= 5, hits
    assert hits[2] <= 2, hits
    assert got == native_wav(jobs, tmp_path)


def test_chained_carry(tmp_path, monkeypatch):
    """Every round after the first dispatches CHAINED (the pair-0 carry is
    the device's own carry_next output) and the WAV equals native."""
    jobs = [(capture(tmp_path, "c", 12), str(tmp_path / "o.wav"))]
    calls = {"chained": 0, "uploaded": 0}
    orig = tdd.ds.steady_round_packed

    def spy(*a, **k):
        calls["chained" if k.get("chained") else "uploaded"] += 1
        return orig(*a, **k)

    monkeypatch.setattr(tdd.ds, "steady_round_packed", spy)
    got, dec = run(tdd.DeviceBatchDecoder, jobs, tmp_path, "dev",
                   device="cpu")
    assert got == native_wav(jobs, tmp_path)
    # 12 frames / 5 per round = 3 rounds; only round 0 may upload.
    assert calls == {"chained": 2, "uploaded": 1}, calls
    assert dec.jobs[0].round_chained == [False, True, True]


def test_steady_rounds_never_materialize(tmp_path, monkeypatch):
    """Word materializations are a per-capture constant (settle-in pairs
    + the finish tail): doubling the frame count does not change them."""
    orig_get = tst.LineStore.words.fget
    n = [0]

    def spy_get(self):
        if self._words is None:
            n[0] += 1
        return orig_get(self)

    monkeypatch.setattr(tst.LineStore, "words",
                        property(spy_get, tst.LineStore.words.fset))
    counts = {}
    for nf in (10, 20):
        n[0] = 0
        jobs = [(capture(tmp_path, f"c{nf}", nf), str(tmp_path / "o.wav"))]
        run(tdd.DeviceBatchDecoder, jobs, tmp_path, f"dev{nf}",
            device="cpu")
        counts[nf] = n[0]
    assert counts[20] == counts[10], counts


def test_chunked_staging_matches(tmp_path):
    """A capture longer than one staging chunk decodes byte-identical to
    native; the steady chain survives every chunk boundary."""
    jobs = [(capture(tmp_path, "c", 14, seed=9), str(tmp_path / "o.wav"))]
    got, dec = run(tdd.DeviceBatchDecoder, jobs, tmp_path, "dev",
                   device="cpu", frames_per_round=4, hbm_frames=4)
    assert dec.jobs[0].stage_next == 14
    assert got == native_wav(jobs, tmp_path)
    assert all(dec.jobs[0].round_chained[1:])


def test_checkpoint_resume(tmp_path):
    """Killed mid-capture and resumed from the checkpoint, the driver
    writes the uninterrupted WAV byte for byte."""
    cap = capture(tmp_path, "c", 12, seed=17)
    kw = dict(lines_per_field=PAL, hyst_limit=2, shift_limit=1,
              frames_per_round=3, device="cpu")
    ref_out = str(tmp_path / "ref.wav")
    tdd.DeviceBatchDecoder([(cap, ref_out)], **kw).run()
    ref = open(ref_out, "rb").read()
    jout = str(tmp_path / "jax.wav")
    jdd.DeviceBatchDecoder([(cap, jout)], lines_per_field=PAL, hyst_limit=2,
                           shift_limit=1, frames_per_round=3).run()
    assert open(jout, "rb").read() == ref

    out = str(tmp_path / "ck.wav")
    dec1 = tdd.DeviceBatchDecoder([(cap, out)], checkpoint=True, **kw)
    j = dec1.jobs[0]
    for _ in range(4):          # a few rounds, then "killed" mid-flight
        dec1._visit(j)
    assert 0 < j.frame_no < 12
    assert os.path.exists(out + ".ckpt.json")
    dec2 = tdd.DeviceBatchDecoder([(cap, out)], checkpoint=True, **kw)
    assert dec2.jobs[0].frames_read > 0
    dec2.run()
    assert open(out, "rb").read() == ref


def test_resume_past_chunk_boundary(tmp_path):
    """Resuming beyond the first staging chunk stages from the resume
    frame and decodes to the end."""
    cap = capture(tmp_path, "c", 14, seed=23)
    kw = dict(lines_per_field=PAL, hyst_limit=2, shift_limit=1,
              frames_per_round=2, hbm_frames=4, device="cpu")
    ref_out = str(tmp_path / "ref.wav")
    tdd.DeviceBatchDecoder([(cap, ref_out)], **kw).run()
    ref = open(ref_out, "rb").read()
    assert ref == native_wav([(cap, ref_out)], tmp_path,
                             frames_per_round=2)[0]

    out = str(tmp_path / "ck.wav")
    dec1 = tdd.DeviceBatchDecoder([(cap, out)], checkpoint=True, **kw)
    j = dec1.jobs[0]
    while j.frame_no <= 6:      # run past the first 4-frame chunk
        dec1._visit(j)
    assert 4 < j.frame_no < 14
    dec2 = tdd.DeviceBatchDecoder([(cap, out)], checkpoint=True, **kw)
    j2 = dec2.jobs[0]
    assert j2.frames_read > 4
    assert j2.chunk_base == j2.frames_read
    dec2.run()
    assert j2.frames_read == 14
    assert open(out, "rb").read() == ref


def test_pal_576_line_capture_presets_pal(tmp_path):
    """A 576-line capture (288 lines per field) is PAL: the preset follows
    the field-height rule, not an exact-294 match."""
    cap = capture(tmp_path, "p576", 2, lpf=288, seed=3)
    d = tbd.BatchDecoder([(cap, str(tmp_path / "o.wav"))],
                         lines_per_field=None, device="cpu")
    assert d.jobs[0].stitcher.preset_video == tst.VID_PAL
    cap = capture(tmp_path, "n", 2, lpf=NTSC, seed=3)
    d = tbd.BatchDecoder([(cap, str(tmp_path / "o.wav"))],
                         lines_per_field=None, device="cpu")
    assert d.jobs[0].stitcher.preset_video == tst.VID_NTSC


def test_preset_wiring(tmp_path):
    """M2, field order, resolution and sample rate reach the stitcher and
    the V2D driver; device and use_kernel reach both as well."""
    cap = capture(tmp_path, "m", 2, seed=5)
    d = tbd.BatchDecoder(
        [(cap, str(tmp_path / "o.wav"))], mode_m2=True,
        preset_order=tst.ORDER_BFF, preset_resolution=2,
        preset_sample_rate=44100, device="cpu", use_kernel=False)
    j = d.jobs[0]
    assert j.stitcher.mode_m2 and not j.stitcher.auto_m2
    assert j.stitcher.preset_order == tst.ORDER_BFF
    assert j.stitcher.preset_resolution == 2
    assert j.stitcher.preset_sample_rate == 44100
    assert j.driver.m2 and j.driver.use_kernel is False
    assert str(j.stitcher.device) == "cpu" and j.driver.device.type == "cpu"


def test_build_stores_matches_jax(tmp_path):
    """_build_stores_stc007 (frame results -> LineStores, the new-file tag,
    the dummy store of a frame without PCM) equals the JAX package's."""
    import numpy as np
    from sdvpcmdecoder_tpu.pipeline import v2d as jv2d
    from sdvpcmdecoder_tpu_torch.pipeline import v2d as tv2d
    cap = capture(tmp_path, "c", 2)
    rng = np.random.default_rng(4)
    L = 2 * PAL
    nums = np.arange(1, L + 1)
    words = rng.integers(0, 1 << 14, (L, 8))
    crc = rng.integers(0, 1 << 16, L)
    valid = rng.random(L) < 0.9
    forced = rng.random(L) < 0.05
    stores = []
    for bd, v2d in ((jbd, jv2d), (tbd, tv2d)):
        kw = {} if bd is jbd else {"device": "cpu"}
        dec = bd.BatchDecoder([(cap, str(tmp_path / "o.wav"))], **kw)
        res = v2d.FrameDecodeResult(words, crc, valid, 110, 20, 200,
                                    (40, 1100), np.zeros(L, bool), forced)
        stores.append((dec._build_stores_stc007(dec.jobs[0], [res, None],
                                                nums), dec.jobs[0].stats))
    (js, jstats), (ts, tstats) = stores
    assert vars(jstats) == vars(tstats)
    for a, b in zip(js, ts):
        for f in a.FIELDS:
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype and np.array_equal(x, y), f


@pytest.mark.parametrize("preset", ["m2", "bff_16bit_44100"])
def test_presets_decode_like_jax(tmp_path, preset):
    kw = dict(mode_m2=True) if preset == "m2" else dict(
        preset_order=tst.ORDER_BFF, preset_resolution=2,
        preset_sample_rate=44100)
    jobs = [(capture(tmp_path, "c", 8, seed=31), str(tmp_path / "o.wav"))]
    got, _ = run(tdd.DeviceBatchDecoder, jobs, tmp_path, "dev",
                 device="cpu", **kw)
    jax_wav, _ = run(jdd.DeviceBatchDecoder, jobs, tmp_path, "jdev", **kw)
    assert got == jax_wav


def test_normal_sweep_prescan_matches_jax(tmp_path):
    """normal_sweep_prescan (the native core's prescan level sweep) at
    NORMAL limits (4, 2) on a noisy capture: the port's WAV equals the JAX
    driver's and the native decoder's in the same configuration."""
    jobs = [(capture(tmp_path, "c", 6, seed=21, noise=30.0),
             str(tmp_path / "o.wav"))]
    kw = dict(normal_sweep_prescan=True, hyst_limit=4, shift_limit=2,
              frames_per_round=3)
    got, _ = run(tdd.DeviceBatchDecoder, jobs, tmp_path, "dev",
                 device="cpu", **kw)
    jax_wav, _ = run(jdd.DeviceBatchDecoder, jobs, tmp_path, "jdev", **kw)
    assert got == jax_wav
    assert got == run(jbd.BatchDecoder, jobs, tmp_path, "ref",
                      backend="native", **kw)[0]


@pytest.mark.parametrize("kw", [dict(ref_sweep=True),
                                dict(ref_sweep_fallback=True)])
def test_level_sweeps_are_not_ported_yet(tmp_path, kw):
    """The level sweeps are ported (the test keeps the name it had while
    they raised): --quality insane / normal semantics on the
    chip-resident path, the full sweep or the failed-lines sweep, give the
    JAX driver's WAV and the native backend's on a noisy capture (mirror
    of test_device_driver.test_device_driver_quality_sweeps_match_native)."""
    kw = dict(kw, hyst_limit=4, shift_limit=2, frames_per_round=3,
              normal_sweep_prescan="ref_sweep_fallback" in kw)
    jobs = [(capture(tmp_path, "c", 4, seed=21, noise=30.0),
             str(tmp_path / "o.wav"))]
    got, dec = run(tdd.DeviceBatchDecoder, jobs, tmp_path, "dev",
                   device="cpu", **kw)
    assert dec.jobs[0].driver.sweep_calls > 0
    assert got == run(jdd.DeviceBatchDecoder, jobs, tmp_path, "jdev",
                      **kw)[0]
    assert got == native_wav(jobs, tmp_path, **kw)


def test_device_is_required_and_streaming_loops_wait(tmp_path):
    cap = capture(tmp_path, "c", 2)
    jobs = [(cap, str(tmp_path / "o.wav"))]
    with pytest.raises(TypeError):
        tdd.DeviceBatchDecoder(jobs)
    stats = tbd.BatchDecoder(jobs, device="cpu").run()   # streams now
    assert stats[cap].lines_valid == 2 * 2 * PAL
    with pytest.raises(ValueError, match="unknown fmt"):
        tbd.BatchDecoder(jobs, fmt="arvid", device="cpu")
    dec = tdd.DeviceBatchDecoder(jobs, device="cpu")
    assert tuple(dec.jobs[0].px_dev.shape) == (2, 2 * PAL, chip_smoke.WIDTH)
    assert dec.use_kernel is False and dec.tables.synd_table.device.type \
        == "cpu"


def test_entry_points_default_to_the_card(tmp_path):
    """The port runs on the card unless the caller asks for the CPU:
    BatchDecoder, V2DDriver, STC007Stitcher, decode_to_numpy and the
    stitcher's and device_stitch's host-array helpers default to "cuda".
    Constructing them allocates nothing on the device, so this runs
    without a GPU."""
    import inspect

    from sdvpcmdecoder_tpu_torch.ops import device_stitch as tds
    from sdvpcmdecoder_tpu_torch.pipeline import decoder as tdec
    from sdvpcmdecoder_tpu_torch.pipeline import v2d as tv2d
    cap = capture(tmp_path, "c", 2)
    j = tbd.BatchDecoder([(cap, str(tmp_path / "o.wav"))]).jobs[0]
    assert j.driver.device.type == "cuda" and j.driver.use_kernel
    assert j.stitcher.device.type == "cuda"
    assert tv2d.V2DDriver().device.type == "cuda"
    assert tst.STC007Stitcher().device.type == "cuda"
    for fn in (tdec.decode_to_numpy, tst.eval_blocks, tst.eval_rows,
               tst._eval_rows_tpu, tds.eval_rows_arrays, tds.seam_sweep):
        assert inspect.signature(fn).parameters["device"].default \
            == "cuda", fn.__name__
