"""The port's chip-resident driver writes the JAX package's WAVs, byte for
byte.

sdvpcmdecoder_tpu_torch.pipeline.device_driver.DeviceBatchDecoder, run on
the CPU (device="cpu": the round's binarize runs the kernel's plain torch
version), against the JAX package's DeviceBatchDecoder and its native
BatchDecoder on the same y4m captures: clean PAL, noisy PAL (marker-
fallback frames) and clean NTSC, two captures each. The captures come from
chip_smoke.write_capture, so the same recipe feeds the card check; the
golden WAV hashes that chip_smoke.py holds the card to are recomputed here
with the JAX package's native decoder.
"""
import hashlib
import os

import pytest

import chip_smoke
from sdvpcmdecoder_tpu.pipeline import batch_driver as jbd
from sdvpcmdecoder_tpu.pipeline import device_driver as jdd
from sdvpcmdecoder_tpu_torch.pipeline import device_driver as tdd

PAL, NTSC = 294, 245


def run(cls, jobs, tmp, tag, lpf, **kw):
    dec = cls(jobs, lines_per_field=lpf, hyst_limit=2, shift_limit=1,
              frames_per_round=5, **kw)
    for k, j in enumerate(dec.jobs):
        j.out_path = os.path.join(tmp, f"{tag}_{k}.wav")
    dec.run()
    return [open(j.out_path, "rb").read() for j in dec.jobs], dec


@pytest.mark.parametrize("lpf,noise,nf", [
    (PAL, 0.0, 12), (PAL, 26.0, 12), (NTSC, 0.0, 10)])
def test_driver_matches_jax_device_and_native(tmp_path, lpf, noise, nf):
    tmp = str(tmp_path)
    jobs = [(chip_smoke.write_capture(os.path.join(tmp, f"c{i}.y4m"), nf,
                                      lpf, seed=10 * i + 1, noise=noise),
             os.path.join(tmp, f"o{i}.wav")) for i in range(2)]
    ref, _ = run(jbd.BatchDecoder, jobs, tmp, "ref", lpf, backend="native")
    jdev, _ = run(jdd.DeviceBatchDecoder, jobs, tmp, "jdev", lpf)
    got, dec = run(tdd.DeviceBatchDecoder, jobs, tmp, "dev", lpf,
                   device="cpu")
    for k in range(2):
        assert got[k] == ref[k], f"WAV {k} differs from native"
        assert got[k] == jdev[k], f"WAV {k} differs from JAX's driver"
    for j in dec.jobs:
        if noise == 0.0:
            # The speculative round path engages on clean tape, and
            # every round after the first is chained.
            assert getattr(j.stitcher, "_steady_chain", None) is not None
            assert j.round_chained[0] is False and all(j.round_chained[1:])
            assert j.driver.fallback_batches == 0
        else:
            assert j.driver.fallback_batches > 0


@pytest.mark.parametrize("lpf,nf", [(PAL, 12), (NTSC, 10)])
def test_golden_wav_hashes(tmp_path, lpf, nf):
    """chip_smoke.GOLDEN_SHA256 is the sha256 of the JAX package's native
    WAV of each golden capture; the port's driver reproduces it here on
    the CPU, and chip_smoke.py on the card."""
    name = "pal" if lpf == PAL else "ntsc"
    cap = chip_smoke.write_capture(str(tmp_path / f"{name}.y4m"), nf, lpf,
                                   seed=1)
    jobs = [(cap, str(tmp_path / "o.wav"))]
    ref, _ = run(jbd.BatchDecoder, jobs, str(tmp_path), "ref", lpf,
                 backend="native")
    assert hashlib.sha256(ref[0]).hexdigest() == \
        chip_smoke.GOLDEN_SHA256[name]
    got, _ = run(tdd.DeviceBatchDecoder, jobs, str(tmp_path), "dev", lpf,
                 device="cpu")
    assert got[0] == ref[0]
