"""The golden hashes chip_smoke.py holds this slice's paths to on the card
are the JAX package's, and the port reproduces them on the CPU.

Recomputed here from the JAX package on chip_smoke's own captures:
GOLDEN_AVI_SHA256 (the JAX CLI on the golden PAL capture in a Y800 AVI
with dropped slots), GOLDEN_WIDE_SHA256 (a 720 x 576 capture, every
backend), GOLDEN_ARVID_SHA256 (--format arvid), the Queue 3 hashes (CLI
flags, driver presets, three captures in one BatchDecoder), and the
containers' claim that the golden PAL capture in any lossless container
writes GOLDEN_CLI_SHA256["pal"].
"""
import hashlib

import pytest
import torch

import chip_smoke
from sdvpcmdecoder_tpu import __main__ as jcli
from sdvpcmdecoder_tpu.pipeline import batch_driver as jbd
from sdvpcmdecoder_tpu.pipeline import ingest as jingest
from sdvpcmdecoder_tpu_torch import __main__ as tcli
from sdvpcmdecoder_tpu_torch.pipeline import batch_driver as tbd
from sdvpcmdecoder_tpu_torch.pipeline import device_driver as tdd

torch.set_num_threads(1)


def sha(path):
    return hashlib.sha256(open(path, "rb").read()).hexdigest()


def test_golden_avi_hash_is_the_jax_clis_and_the_ports(tmp_path):
    pal = chip_smoke.capture_frames(12, 294, seed=1)
    cap = chip_smoke.write_container(str(tmp_path / "drops.avi"), pal,
                                     "Y800", drops=chip_smoke.AVI_DROPS)
    assert jcli.main([cap, "-o", str(tmp_path / "j.wav")]) == 0
    assert sha(tmp_path / "j.wav") == chip_smoke.GOLDEN_AVI_SHA256
    assert tcli.main([cap, "-o", str(tmp_path / "t.wav"), "--device", "cpu",
                      "--backend", "native"]) == 0
    assert sha(tmp_path / "t.wav") == chip_smoke.GOLDEN_AVI_SHA256


@pytest.mark.parametrize("kind,codec", chip_smoke.CONTAINERS)
def test_containers_write_the_y4m_golden(tmp_path, kind, codec):
    """The lossless containers of phase C1 decode to the golden PAL
    capture's pixels, so the JAX CLI writes GOLDEN_CLI_SHA256["pal"]."""
    pal = chip_smoke.capture_frames(12, 294, seed=1)
    cap = chip_smoke.write_container(str(tmp_path / f"c.{kind}"), pal, codec)
    assert jcli.main([cap, "-o", str(tmp_path / "j.wav"), "--backend",
                      "native"]) == 0
    assert sha(tmp_path / "j.wav") == chip_smoke.GOLDEN_CLI_SHA256["pal"]


def test_golden_wide_hash_is_the_jax_clis_and_the_ports(tmp_path):
    path = str(tmp_path / "wide.y4m")
    jingest.write_y4m(path, chip_smoke.wide_frames(**chip_smoke.WIDE))
    for backend in ("native", "tpu"):
        assert jcli.main([path, "-o", str(tmp_path / "j.wav"), "--backend",
                          backend]) == 0
        assert sha(tmp_path / "j.wav") == chip_smoke.GOLDEN_WIDE_SHA256
    assert tcli.main([path, "-o", str(tmp_path / "t.wav"), "--device",
                      "cpu", "--backend", "tpu"]) == 0
    assert sha(tmp_path / "t.wav") == chip_smoke.GOLDEN_WIDE_SHA256


def test_golden_arvid_hashes_are_the_jax_clis_and_the_ports(tmp_path):
    cap, cd = chip_smoke.write_arvid_capture(str(tmp_path / "a.y4m"),
                                             **chip_smoke.ARVID)
    for tag, main, extra in (("j", jcli.main, []),
                             ("t", tcli.main, ["--device", "cpu"])):
        out = tmp_path / f"{tag}.txt"
        assert main([cap, "-o", str(out), "--format", "arvid",
                     "--force-coords", f"{cd[0]}:{cd[1]}"] + extra) == 0
        assert {"txt": sha(out), "bin": sha(tmp_path / f"{tag}.bin")} == \
            chip_smoke.GOLDEN_ARVID_SHA256


@pytest.mark.parametrize("name", list(chip_smoke.Q3_CLI))
def test_golden_queue3_cli_hashes(tmp_path, name):
    """The JAX CLI's WAV for each flag set (native backend; its other
    backends write the same bytes) and the port's on the CPU under tpu."""
    cap = chip_smoke.write_capture(str(tmp_path / "q3.y4m"), **chip_smoke.Q3)
    flags = chip_smoke.Q3_CLI[name]
    assert jcli.main([cap, "-o", str(tmp_path / "j.wav"), "--backend",
                      "native"] + flags) == 0
    assert sha(tmp_path / "j.wav") == chip_smoke.GOLDEN_Q3_CLI_SHA256[name]
    assert tcli.main([cap, "-o", str(tmp_path / "t.wav"), "--backend", "tpu",
                      "--device", "cpu"] + flags) == 0
    assert sha(tmp_path / "t.wav") == chip_smoke.GOLDEN_Q3_CLI_SHA256[name]


@pytest.mark.parametrize("name", list(chip_smoke.Q3_DRIVER))
def test_golden_queue3_driver_hashes(tmp_path, name):
    cap = chip_smoke.write_capture(str(tmp_path / "q3.y4m"), **chip_smoke.Q3)
    kw = dict(chip_smoke.Q3_MULTI_KW, **chip_smoke.Q3_DRIVER[name])
    jbd.BatchDecoder([(cap, str(tmp_path / "j.wav"))], backend="native",
                     **kw).run()
    assert sha(tmp_path / "j.wav") == chip_smoke.GOLDEN_Q3_DRIVER_SHA256[name]
    tdd.DeviceBatchDecoder([(cap, str(tmp_path / "t.wav"))], device="cpu",
                           **kw).run()
    assert sha(tmp_path / "t.wav") == chip_smoke.GOLDEN_Q3_DRIVER_SHA256[name]


def test_golden_queue3_multi_capture_hashes(tmp_path):
    caps = {"pal": chip_smoke.write_capture(str(tmp_path / "pal.y4m"), 12,
                                            294, seed=1),
            "noisy": chip_smoke.write_capture(str(tmp_path / "noisy.y4m"),
                                              **chip_smoke.CLI_NOISY),
            "q3": chip_smoke.write_capture(str(tmp_path / "q3.y4m"),
                                           **chip_smoke.Q3)}
    for tag, run in (("j", lambda jobs: jbd.BatchDecoder(
            jobs, backend="native", **chip_smoke.Q3_MULTI_KW).run()),
            ("t", lambda jobs: tbd.BatchDecoder(
                jobs, backend="tpu", device="cpu",
                **chip_smoke.Q3_MULTI_KW).run())):
        jobs = [(c, str(tmp_path / f"{tag}_{k}.wav")) for k, c in caps.items()]
        run(jobs)
        assert {k: sha(o) for (_, o), k in zip(jobs, caps)} == \
            chip_smoke.GOLDEN_Q3_MULTI_SHA256
