"""The golden PCM WAV hashes chip_smoke.py holds the port's CLI to on the
card are the JAX package's CLI's, and chip_smoke's PCM capture writers
write the bytes of the JAX package's test captures.

chip_smoke.GOLDEN_PCM_SHA256 is recomputed here from
sdvpcmdecoder_tpu.__main__.main on the captures of chip_smoke.PCM_GOLDEN
at the CLI's defaults under every backend of chip_smoke.PCM_CLI_BACKENDS
(and --format auto on the PCM-1 capture); the port's CLI reproduces each
on the CPU.
"""
import hashlib

import numpy as np
import pytest
import torch

import chip_smoke
from sdvpcmdecoder_tpu import __main__ as jcli
from sdvpcmdecoder_tpu.formats import pcm16x0 as jp16
from sdvpcmdecoder_tpu.ops import pcm16x0_deint as jdi16
from sdvpcmdecoder_tpu.pipeline import ingest as jingest
from sdvpcmdecoder_tpu.synth import encoder as jenc
from sdvpcmdecoder_tpu_torch import __main__ as tcli

from test_batch_driver_formats import _pcm1_capture, _pcm16x0_capture
from test_device_pcm import _noisy

torch.set_num_threads(1)


def sha(path):
    return hashlib.sha256(open(path, "rb").read()).hexdigest()


def golden_capture(tmp_path, name):
    fmt, writer, kw = chip_smoke.PCM_GOLDEN[name]
    return fmt, getattr(chip_smoke, writer)(str(tmp_path / f"{name}.y4m"),
                                            **kw)


def backend_args(backend):
    return ["--backend", backend] if backend else []


@pytest.mark.parametrize("name", list(chip_smoke.PCM_GOLDEN))
def test_golden_pcm_hashes_are_the_jax_clis(tmp_path, name):
    fmt, cap = golden_capture(tmp_path, name)
    out = str(tmp_path / "j.wav")
    for backend in chip_smoke.PCM_CLI_BACKENDS:
        assert jcli.main([cap, "-o", out, "--format", fmt]
                         + backend_args(backend)) == 0
        assert sha(out) == chip_smoke.GOLDEN_PCM_SHA256[name], backend
    if name == "pcm1":
        assert jcli.main([cap, "-o", out, "--format", "auto"]) == 0
        assert sha(out) == chip_smoke.GOLDEN_PCM_SHA256[name]


@pytest.mark.parametrize("name", list(chip_smoke.PCM_GOLDEN))
def test_port_cli_reproduces_the_golden_pcm_hashes(tmp_path, name):
    fmt, cap = golden_capture(tmp_path, name)
    out = str(tmp_path / "t.wav")
    for backend in chip_smoke.PCM_CLI_BACKENDS:
        assert tcli.main([cap, "-o", out, "--format", fmt, "--device",
                          "cpu"] + backend_args(backend)) == 0
        assert sha(out) == chip_smoke.GOLDEN_PCM_SHA256[name], backend
    assert len(set(chip_smoke.GOLDEN_PCM_SHA256.values())) == 3


@pytest.mark.parametrize("fmt", ["pcm1", "pcm16x0"])
def test_writers_write_the_jax_tests_captures(tmp_path, fmt):
    """chip_smoke's writers against tests/test_batch_driver_formats.py's
    makers and tests/test_device_pcm.py's noisy wrapper, byte for byte."""
    ours = getattr(chip_smoke, f"write_{fmt}_capture")
    theirs = _pcm1_capture if fmt == "pcm1" else _pcm16x0_capture
    a, b = tmp_path / "a.y4m", tmp_path / "b.y4m"
    for kw in (dict(), dict(n_frames=2, seed=7)):
        ours(str(a), **kw)
        theirs(b, **kw)
        assert a.read_bytes() == b.read_bytes(), kw
    noise = chip_smoke.PCM_NOISE[fmt]
    chip_smoke.write_pcm_noisy(str(a), fmt, 3, 40, noise)
    _noisy(theirs, str(b), 40, noise)   # its clean capture has 6 frames
    with jingest.open_capture(str(b)) as rd:
        six = rd.read_frames(0, 6)
    ours(str(a) + ".clean", n_frames=6, seed=40)
    chip_smoke.write_pcm_noisy(str(a), fmt, 6, 40, noise)
    assert a.read_bytes() == b.read_bytes()
    assert six.shape[0] == 6


def test_ei_writer_writes_the_jax_tests_capture(tmp_path):
    """write_pcm1630_capture against tests/test_cli_formats.py's
    test_cli_pcm1630 recipe, run with the JAX package's modules."""
    rng = np.random.default_rng(102)
    LPF, W = 245, 1600
    vids = []
    for _ in range(2):
        left = rng.integers(1, 1 << 16, size=jdi16.EI_OFS * 3)
        right = rng.integers(1, 1 << 16, size=jdi16.EI_OFS * 3)
        sub, _ = jdi16.interleave_field(left, right, 2 * LPF, ei=True)
        crcs = jp16.calc_crc(sub, xp=np)
        bits = jp16.line_bits(sub.reshape(2 * LPF, 3, 3),
                              crcs.reshape(2 * LPF, 3), 0, xp=np)
        px, _ = jenc.render_bits(bits, width=W, ppb=7.0)
        img = np.zeros((2 * LPF, W), np.uint8)
        img[0::2] = px[:LPF]
        img[1::2] = px[LPF:]
        vids.append(img)
    ref = tmp_path / "j.y4m"
    jingest.write_y4m(ref, np.stack(vids), chroma="mono")
    got = chip_smoke.write_pcm1630_capture(str(tmp_path / "t.y4m"))
    assert open(got, "rb").read() == ref.read_bytes()
