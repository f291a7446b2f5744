"""The port's CLI on AVI and Matroska captures against the JAX CLI's, on
the CPU (--device cpu).

Mirrors the CLI cases of tests/test_avi.py and test_mkv.py: Y800 and
HFYU AVIs and an FFV1 MKV with a dropped slot under every backend write
the JAX CLI's WAV bytes and print the same dropped-frame count; the FFV1
MKV writes the Y800 AVI's WAV (container transparency); PCM-1 in a Y800
AVI with a dropped slot decodes like the JAX CLI.
"""
import numpy as np
import pytest
import torch

import chip_smoke
from sdvpcmdecoder_tpu import __main__ as jcli
from sdvpcmdecoder_tpu_torch import __main__ as tcli
from sdvpcmdecoder_tpu_torch.pipeline import avi, mkv

torch.set_num_threads(1)

CAPTURES = {"y800_avi": ("avi", "Y800", []), "hfyu_avi": ("avi", "HFYU", []),
            "ffv1_mkv_drop": ("mkv", "FFV1", [2])}


def _both(tmp_path, capsys, cap, *flags):
    outs = []
    for tag, main, extra in (("j", jcli.main, []),
                             ("t", tcli.main, ["--device", "cpu"])):
        out = tmp_path / f"{tag}.wav"
        rc = main([str(cap), "-o", str(out), *flags] + extra)
        text = capsys.readouterr().out
        drops = [ln for ln in text.splitlines() if "dropped frames" in ln]
        outs.append((rc, out.read_bytes() if out.exists() else None, drops))
    return outs


@pytest.fixture(scope="module")
def containers(tmp_path_factory):
    """Each capture of CAPTURES written once (the FFV1 encoder takes
    seconds a frame): 4 noisy frames of 2 x 48 lines x 1152 px."""
    tmp = tmp_path_factory.mktemp("containers")
    frames = chip_smoke.capture_frames(4, 48, seed=30, noise=18.0)
    return {name: chip_smoke.write_container(str(tmp / f"{name}.{kind}"),
                                             frames, codec, drops=drops)
            for name, (kind, codec, drops) in CAPTURES.items()}


@pytest.mark.parametrize("backend", ["native", "tpu", "device"])
@pytest.mark.parametrize("name", list(CAPTURES))
def test_cli_container_wav_like_jax(tmp_path, capsys, containers, name,
                                    backend):
    cap, drops = containers[name], CAPTURES[name][2]
    (jrc, jw, jd), (trc, tw, td) = _both(tmp_path, capsys, cap, "--quality",
                                         "fast", "--backend", backend,
                                         "--batch", "2")
    assert jrc == trc == 0 and tw == jw and len(tw) > 200
    assert td == jd and bool(td) == bool(drops)


def test_mkv_cli_writes_the_avi_wav(tmp_path):
    vids = chip_smoke.capture_frames(3, 48, seed=30)
    pm, pa = tmp_path / "c.mkv", tmp_path / "c.avi"
    mkv.write_mkv(pm, vids, codec="FFV1")
    avi.write_avi(pa, vids, codec="Y800")
    for src, out in ((pm, "m.wav"), (pa, "a.wav")):
        assert tcli.main([str(src), "-o", str(tmp_path / out), "--quality",
                          "fast", "--device", "cpu"]) == 0
    wav = (tmp_path / "m.wav").read_bytes()
    assert wav == (tmp_path / "a.wav").read_bytes() and len(wav) > 200


def test_cli_decodes_pcm1_from_avi_like_jax(tmp_path, capsys):
    """PCM-1 in a Y800 AVI with one dropped slot (tests/test_avi.py's
    case through chip_smoke's PCM-1 writer): the JAX CLI's WAV."""
    from sdvpcmdecoder_tpu_torch.pipeline import ingest
    y4m = chip_smoke.write_pcm1_capture(str(tmp_path / "p1.y4m"),
                                        n_frames=3, seed=77)
    with ingest.open_capture(y4m) as rd:
        frames = rd.read_frames(0, 3)
    cap = tmp_path / "p1.avi"
    avi.write_avi(cap, frames, codec="Y800", drops=[1])
    (jrc, jw, _), (trc, tw, _) = _both(tmp_path, capsys, cap, "--format",
                                       "pcm1", "--quality", "fast")
    assert jrc == trc == 0 and tw == jw and len(tw) > 1000
    assert np.frombuffer(tw[44:], np.int16).any()
