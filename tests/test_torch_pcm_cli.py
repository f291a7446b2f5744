"""The port's CLI on PCM-1, PCM-16x0 (SI) and PCM-1630 (EI) captures
against the JAX package's CLI: the same WAV under every backend and with
--format auto, the same --dump-lines / --stats work log, render files and
live-audio stream; a checkpoint the JAX CLI wrote resumes in the port's
CLI into the uninterrupted JAX run's WAV; --backend device refuses the
flags its PCM driver cannot honour (exit 2); the PCM renderers equal
JAX's.
"""
import hashlib

import numpy as np
import pytest
import torch

import chip_smoke
from sdvpcmdecoder_tpu import __main__ as jcli
from sdvpcmdecoder_tpu.formats import pcm1 as jp1
from sdvpcmdecoder_tpu.pipeline import render as jrn
from sdvpcmdecoder_tpu_torch import __main__ as tcli
from sdvpcmdecoder_tpu_torch.formats import pcm1, pcm16x0
from sdvpcmdecoder_tpu_torch.pipeline import render as trn

torch.set_num_threads(1)

FORMATS = {"pcm1": chip_smoke.write_pcm1_capture,
           "pcm16x0": chip_smoke.write_pcm16x0_capture,
           "pcm1630": chip_smoke.write_pcm1630_capture}
BACKENDS = ["native", "tpu", "device", "auto"]


def capture(tmp_path, fmt, n_frames=3, seed=40):
    return FORMATS[fmt](str(tmp_path / f"{fmt}_{seed}.y4m"),
                        n_frames=n_frames, seed=seed)


def sha(path):
    return hashlib.sha256(open(path, "rb").read()).hexdigest()


@pytest.mark.parametrize("fmt", list(FORMATS))
def test_cli_formats_match_jax_under_every_backend(tmp_path, fmt):
    cap = capture(tmp_path, fmt, n_frames=2 if fmt == "pcm1630" else 3)
    ref = str(tmp_path / "j.wav")
    common = ["--format", fmt, "--quality", "fast", "--batch", "2"]
    assert jcli.main([cap, "-o", ref] + common) == 0
    for backend in BACKENDS:
        out = str(tmp_path / f"{backend}.wav")
        assert tcli.main([cap, "-o", out, "--backend", backend,
                          "--device", "cpu"] + common) == 0
        assert sha(out) == sha(ref), backend


def test_cli_format_auto_probes_and_matches_jax(tmp_path, capsys):
    cap = capture(tmp_path, "pcm16x0", n_frames=2)
    ref, out = str(tmp_path / "j.wav"), str(tmp_path / "t.wav")
    assert jcli.main([cap, "-o", ref, "--format", "auto", "--quality",
                      "fast"]) == 0
    jprobe = [ln for ln in capsys.readouterr().out.splitlines()
              if ln.startswith("format probe:")]
    assert tcli.main([cap, "-o", out, "--format", "auto", "--quality",
                      "fast", "--device", "cpu"]) == 0
    tprobe = [ln for ln in capsys.readouterr().out.splitlines()
              if ln.startswith("format probe:")]
    assert tprobe == jprobe and tprobe[0].startswith("format probe: pcm16x0")
    assert sha(out) == sha(ref)


@pytest.mark.parametrize("fmt", ["pcm1", "pcm16x0"])
def test_cli_work_log_dump_and_live_audio_match_jax(tmp_path, capsys, fmt):
    """--dump-lines and --stats print the JAX CLI's lines; --live-audio to
    a file writes its stream; --render-dir its PPMs."""
    cap = capture(tmp_path, fmt, n_frames=2)
    runs = {}
    for name, main in (("jax", jcli.main), ("port", tcli.main)):
        d = tmp_path / name
        d.mkdir()
        argv = [cap, "-o", str(d / "o.wav"), "--format", fmt, "--quality",
                "fast", "--dump-lines", "3", "--stats", "--live-audio",
                str(d / "live.raw"), "--render-dir", str(d / "ppm")]
        if name == "port":
            argv += ["--device", "cpu"]
        assert main(argv) == 0
        log = [ln for ln in capsys.readouterr().out.splitlines()
               if ln.startswith("F[")]
        ppm = {p.name: p.read_bytes() for p in (d / "ppm").iterdir()}
        runs[name] = (log, (d / "live.raw").read_bytes(), ppm,
                      (d / "o.wav").read_bytes())
    assert len(runs["port"][0]) > 6 and len(runs["port"][2]) == 4
    assert runs["port"] == runs["jax"]


@pytest.mark.parametrize("fmt", ["pcm1", "pcm16x0"])
def test_jax_cli_checkpoint_resumes_in_the_port_cli(tmp_path, fmt):
    """tests/test_resume_formats.py's kill/resume, across packages: the
    JAX CLI stops after 2 frames with a checkpoint, the port's CLI
    resumes it, and the WAV equals one uninterrupted JAX run's."""
    cap = capture(tmp_path, fmt, n_frames=4, seed=55)
    common = ["--format", fmt, "--quality", "fast", "--batch", "2"]
    ref = str(tmp_path / "ref.wav")
    assert jcli.main([cap, "-o", ref] + common) == 0
    out, ck = str(tmp_path / "out.wav"), str(tmp_path / "ck")
    assert jcli.main([cap, "-o", out, "--frames", "2", "--checkpoint", ck]
                     + common) == 0
    assert tcli.main([cap, "-o", out, "--checkpoint", ck, "--device",
                      "cpu"] + common) == 0
    assert sha(out) == sha(ref)
    # The port's own checkpoint resumes the same way.
    out2, ck2 = str(tmp_path / "out2.wav"), str(tmp_path / "ck2")
    for extra in (["--frames", "2"], []):
        assert tcli.main([cap, "-o", out2, "--checkpoint", ck2, "--device",
                          "cpu"] + common + extra) == 0
    assert sha(out2) == sha(ref)


@pytest.mark.parametrize("flag", [["--standard", "pal"],
                                  ["--field-order", "bff"],
                                  ["--resolution", "16bit"],
                                  ["--sample-rate", "44100"],
                                  ["--per-line-agc"], ["--stats"],
                                  ["--no-ecc"]])
def test_cli_device_backend_refuses_pcm_flags(tmp_path, capsys, flag):
    cap = capture(tmp_path, "pcm1", n_frames=1)
    out = tmp_path / "o.wav"
    rc = tcli.main([cap, "-o", str(out), "--format", "pcm1", "--backend",
                    "device", "--device", "cpu"] + flag)
    err = capsys.readouterr().err
    assert rc == 2 and not out.exists()
    assert "--backend device does not support" in err and flag[0] in err
    assert jcli.main([cap, "-o", str(out), "--format", "pcm1", "--backend",
                      "device"] + flag) == 2


def test_cli_pcm_needs_a_card_by_default(tmp_path, capsys):
    """No --device: the card, and without one exit 2 (no host fallback)."""
    cap = capture(tmp_path, "pcm1", n_frames=1)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert tcli.main([cap, "-o", str(tmp_path / "o.wav"), "--format",
                      "pcm1"]) == 2
    assert "no CUDA device" in capsys.readouterr().err


def test_pcm_renderers_match_jax():
    rng = np.random.default_rng(0)
    w = rng.integers(0, 1 << 13, size=(4, 6))
    c = np.asarray(pcm1.calc_crc(w, xp=np))
    valid = np.array([True, False, True, True])
    fixed = np.array([False, False, True, False])
    assert trn.PPB_PCM1LINE == jrn.PPB_PCM1LINE
    assert trn.PPB_PCM16X0LINE == jrn.PPB_PCM16X0LINE
    for kw in (dict(), dict(fixed=fixed)):
        a = jrn.render_pcm1_lines(w, c, valid, **kw)
        b = trn.render_pcm1_lines(w, c, valid, **kw)
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert np.array_equal(jrn.render_pcm1_lines(w, jp1.calc_crc(w, xp=np),
                                                valid),
                          trn.render_pcm1_lines(w, c, valid))
    w = rng.integers(0, 1 << 16, size=(6, 3))
    c = np.asarray(pcm16x0.calc_crc(w, xp=np))
    cb = np.array([True, False, True, False, True, False])
    for kw in (dict(), dict(control_bit=cb), dict(control_bit=cb,
                                                  fixed=cb)):
        a = jrn.render_pcm16x0_sublines(w, c, np.ones(6, bool), **kw)
        b = trn.render_pcm16x0_sublines(w, c, np.ones(6, bool), **kw)
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert (b[:, -1, :][cb] == 255).all()
