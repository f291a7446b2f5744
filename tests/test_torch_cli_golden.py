"""The golden WAV hashes chip_smoke.py holds the port's CLI to on the card
are the JAX package's CLI's.

chip_smoke.GOLDEN_CLI_SHA256 is recomputed here from
sdvpcmdecoder_tpu.__main__.main on the captures chip_smoke.py writes (the
golden PAL capture and CLI_NOISY), under every run of
chip_smoke.CLI_GOLDEN_RUNS; the port's CLI reproduces it on the CPU at
NORMAL under every backend (its INSANE runs at this size belong to the
card; tests/test_torch_cli.py compares INSANE at a small size).
"""
import hashlib

import pytest
import torch

import chip_smoke
from sdvpcmdecoder_tpu import __main__ as jcli
from sdvpcmdecoder_tpu_torch import __main__ as tcli

torch.set_num_threads(1)


def capture(tmp_path, name):
    path = str(tmp_path / f"{name}.y4m")
    if name == "pal":
        return chip_smoke.write_capture(path, 12, 294, seed=1)
    return chip_smoke.write_capture(path, **chip_smoke.CLI_NOISY)


def sha(path):
    return hashlib.sha256(open(path, "rb").read()).hexdigest()


@pytest.mark.parametrize("name", ["pal", "noisy"])
def test_golden_cli_hashes_are_the_jax_clis(tmp_path, name):
    cap = capture(tmp_path, name)
    out = str(tmp_path / "j.wav")
    for quality, backend, extra in chip_smoke.CLI_GOLDEN_RUNS:
        rc = jcli.main([cap, "-o", out, "--quality", quality, "--backend",
                        backend] + extra)
        assert rc == 0
        assert sha(out) == chip_smoke.GOLDEN_CLI_SHA256[name], \
            (quality, backend)


@pytest.mark.parametrize("name", ["pal", "noisy"])
def test_port_cli_reproduces_the_golden_hashes_at_normal(tmp_path, name):
    cap = capture(tmp_path, name)
    out = str(tmp_path / "t.wav")
    for quality, backend, extra in chip_smoke.CLI_GOLDEN_RUNS:
        if quality != "normal":
            continue
        rc = tcli.main([cap, "-o", out, "--quality", quality, "--backend",
                        backend, "--device", "cpu"] + extra)
        assert rc == 0
        assert sha(out) == chip_smoke.GOLDEN_CLI_SHA256[name], backend


def test_golden_hashes_differ_by_capture_and_from_fast(tmp_path):
    """The noisy capture's hash is no constant: FAST leaves lines invalid
    that NORMAL's sweep recovers, and writes another WAV."""
    assert chip_smoke.GOLDEN_CLI_SHA256["pal"] != \
        chip_smoke.GOLDEN_CLI_SHA256["noisy"]
    cap = capture(tmp_path, "noisy")
    out = str(tmp_path / "t.wav")
    assert tcli.main([cap, "-o", out, "--quality", "fast", "--backend",
                      "native", "--device", "cpu"]) == 0
    assert sha(out) != chip_smoke.GOLDEN_CLI_SHA256["noisy"]
