"""The port's CLI (python -m sdvpcmdecoder_tpu_torch) against the JAX
package's, on the CPU (--device cpu).

Mirrors tests/test_cli_wiring.py and tests/test_ingest_cli.py as far as
STC-007 goes: the parser's flags and defaults, every backend's WAV
byte-equal to the JAX CLI's at fast, normal and insane, the flags that
reach the drivers (--per-line-agc, --force-coords, --format m2, --frames,
--no-ecc, --cwd, --stats, --dump-lines, --render-dir, --checkpoint), and
ArVid's dump and the container fall-through equal to the JAX CLI's, exit
code 2 for --backend device with a flag it does not take, and for
--device cuda on a machine without a card.
"""
import os
import re

import numpy as np
import pytest
import torch

from test_torch_batch_driver import _noisy_capture
from sdvpcmdecoder_tpu import __main__ as jcli
from sdvpcmdecoder_tpu.formats import stc007 as jstc
from sdvpcmdecoder_tpu.pipeline import ingest as jingest
from sdvpcmdecoder_tpu.pipeline import render as jrender
from sdvpcmdecoder_tpu.synth import encoder as jenc
from sdvpcmdecoder_tpu_torch import __main__ as tcli
from sdvpcmdecoder_tpu_torch.pipeline import device_driver as tdd
from sdvpcmdecoder_tpu_torch.pipeline import live_audio as tla
from sdvpcmdecoder_tpu_torch.pipeline import render as trender
from sdvpcmdecoder_tpu_torch.pipeline import v2d as tv2d
from sdvpcmdecoder_tpu_torch.pipeline import wav
from sdvpcmdecoder_tpu_torch.utils import dump as tdump

torch.set_num_threads(1)

BACKENDS = ["native", "tpu", "device", "auto"]


def both(tmp, cap, *flags, capsys=None):
    """The JAX CLI and the port's on one capture with the same flags:
    (jax rc, port rc, jax WAV bytes, port WAV bytes, jax stdout, port
    stdout)."""
    outs = []
    for tag, main, extra in (("j", jcli.main, []),
                             ("t", tcli.main, ["--device", "cpu"])):
        out = os.path.join(str(tmp), f"{tag}.wav")
        if os.path.exists(out):
            os.remove(out)
        rc = main([str(cap), "-o", out, *flags, *extra])
        data = open(out, "rb").read() if os.path.exists(out) else None
        text = capsys.readouterr().out if capsys is not None else ""
        outs.append((rc, data, text))
    (jrc, jw, jt), (trc, tw, tt) = outs
    return jrc, trc, jw, tw, jt, tt


def small_capture(tmp, sigma=36.0, n_frames=4, lpf=48, seed=70):
    return _noisy_capture(tmp / "small.y4m", seed, n_frames, lpf, sigma)


def test_parser_flags_and_defaults_equal_jax():
    def spec(parser):
        return {a.dest: (tuple(a.option_strings), a.default, a.choices
                         and tuple(a.choices), a.type, a.nargs, a.metavar,
                         type(a).__name__)
                for a in parser._actions}
    j, t = spec(jcli.build_parser()), spec(tcli.build_parser())
    device = t.pop("device")
    assert device[:3] == (("--device",), "cuda", ("cuda", "cpu"))
    assert t == j
    assert tcli.QUALITY_LIMITS == jcli.QUALITY_LIMITS
    assert tcli.build_parser().prog == "sdvpcmdecoder_tpu_torch"
    helps = {a.dest: a.help for a in tcli.build_parser()._actions}
    assert "use_kernel=True" in helps["pallas"]
    for text in helps.values():   # no speed claims carried over
        assert not re.search(r"\bwins\b|\bfaster\b|\d\s*(ms|fps)\b|TPU",
                             text or ""), text


@pytest.mark.parametrize("quality", ["fast", "normal", "insane"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_every_backend_matches_the_jax_cli(tmp_path, backend, quality):
    """A noisy 4-frame capture of 48 lines a field (3 frames of 32 at
    INSANE): the marker fallback, the NORMAL sweep fallback and the INSANE
    sweep all have work."""
    cap = small_capture(tmp_path) if quality != "insane" \
        else small_capture(tmp_path, n_frames=3, lpf=32)
    jrc, trc, jw, tw, _, _ = both(tmp_path, cap, "--quality", quality,
                                  "--backend", backend, "--batch", "4")
    assert jrc == trc == 0
    assert tw == jw and len(tw) > 1000


def test_tail_batch_padding_matches_jax(tmp_path):
    """5 frames at --batch 4: the device backend pads the tail batch."""
    cap = small_capture(tmp_path, n_frames=5, lpf=32)
    for backend in ("tpu", "device"):
        jrc, trc, jw, tw, _, _ = both(tmp_path, cap, "--quality", "normal",
                                      "--backend", backend, "--batch", "4")
        assert jrc == trc == 0 and tw == jw


def _stc_capture(path, n_frames=2, seed=5):
    rng = np.random.default_rng(seed)
    lpf = 294
    n = 3 * n_frames * 2 * lpf
    left = rng.integers(1, 1 << 14, n)
    frames = jenc.encode_fields(left, rng.integers(1, 1 << 14, n), n_frames,
                                lines_pf=lpf)
    vids = []
    for fr in frames:
        px, _ = jenc.render_lines(fr["line_words"], fr["crcs"], width=1152,
                                  ppb=8.0)
        img = np.zeros((2 * lpf, 1152), np.uint8)
        img[0::2] = px[:lpf]
        img[1::2] = px[lpf:]
        vids.append(img)
    jingest.write_y4m(path, np.stack(vids))
    return left


def test_cli_per_line_agc_flag(tmp_path, monkeypatch):
    captured = {}
    orig = tv2d.V2DDriver

    class Spy(orig):
        def __init__(self, **kw):
            captured.update(kw)
            super().__init__(**kw)

    monkeypatch.setattr(tv2d, "V2DDriver", Spy)
    cap = tmp_path / "c.y4m"
    _stc_capture(cap)
    jrc, trc, jw, tw, _, _ = both(tmp_path, cap, "--quality", "fast",
                                  "--per-line-agc", "--backend", "tpu")
    assert jrc == trc == 0 and tw == jw
    assert captured["per_line_agc"] is True
    assert str(captured["device"]) == "cpu"
    assert captured["use_kernel"] is None
    data, _ = wav.read_wav(tmp_path / "t.wav")
    assert len(data) > 1000
    rc = tcli.main([str(cap), "-o", str(tmp_path / "t.wav"), "--quality",
                    "fast", "--device", "cpu", "--pallas"])
    assert rc == 0 and captured["per_line_agc"] is False
    assert captured["use_kernel"] is True


def test_cli_end_to_end(tmp_path):
    """The decoded samples are the encoder's input (test_ingest_cli)."""
    cap = tmp_path / "cap.y4m"
    left = _stc_capture(cap, n_frames=3, seed=7)
    out = tmp_path / "out.wav"
    rc = tcli.main([str(cap), "-o", str(out), "--quality", "fast",
                    "--standard", "pal", "--device", "cpu"])
    assert rc == 0
    samples, rate = wav.read_wav(out)
    assert rate == 44100
    el = np.asarray(jstc.expand_sample(left, xp=np))
    out_l = samples[:, 0].astype(np.int64)
    st0 = int(np.nonzero(out_l == el[0])[0][0])
    n_check = min(3 * (3 * 2 * 294 - 144), len(out_l) - st0)
    np.testing.assert_array_equal(out_l[st0:st0 + n_check], el[:n_check])


@pytest.mark.parametrize("flags", [
    ("--format", "m2"), ("--no-ecc",), ("--cwd",), ("--frames", "3"),
    ("--mask", "hold", "--mask-scope", "block"), ("--sample-rate", "44056"),
    ("--standard", "ntsc", "--field-order", "bff", "--resolution", "16bit"),
    ("--force-coords", "40:1096")])
def test_cli_flags_match_jax(tmp_path, flags):
    cap = small_capture(tmp_path, sigma=30.0)
    for backend in ("native", "tpu"):
        jrc, trc, jw, tw, _, _ = both(tmp_path, cap, "--quality", "fast",
                                      "--backend", backend, "--batch", "3",
                                      *flags)
        assert jrc == trc == 0 and tw == jw and len(tw) > 44


def test_cli_device_backend_presets_match_jax(tmp_path):
    cap = small_capture(tmp_path, sigma=30.0)
    jrc, trc, jw, tw, _, _ = both(
        tmp_path, cap, "--quality", "normal", "--backend", "device",
        "--batch", "3", "--format", "m2", "--standard", "pal",
        "--field-order", "tff", "--resolution", "14bit", "--mask", "mute")
    assert jrc == trc == 0 and tw == jw


def test_cli_stats_dump_and_render_match_jax(tmp_path, capsys):
    """--stats, --dump-lines and --render-dir: the same work-log rows, bit
    dumps and PPM images as the JAX CLI."""
    cap = small_capture(tmp_path, sigma=32.0)
    texts, images = [], []
    for tag, main, extra in (("j", jcli.main, []),
                             ("t", tcli.main, ["--device", "cpu"])):
        rdir = tmp_path / f"render_{tag}"
        rc = main([str(cap), "-o", str(tmp_path / f"{tag}.wav"),
                   "--quality", "fast", "--batch", "2", "--stats",
                   "--dump-lines", "3", "--render-dir", str(rdir), *extra])
        assert rc == 0
        text = capsys.readouterr().out
        texts.append([ln for ln in text.splitlines()
                      if ln.startswith(("F[", "input:", "frames", "lines:",
                                        "blocks:", "dup", "samples:"))])
        images.append({p.name: p.read_bytes()
                       for p in sorted(rdir.iterdir())})
    assert texts[0] == texts[1]
    assert sum(ln.startswith("F[") and "L[" in ln for ln in texts[1]) == 12
    assert sum("blk[" in ln for ln in texts[1]) >= 3
    assert images[0] == images[1]
    assert {n.split("_")[0] for n in images[1]} >= {"frame", "source",
                                                    "assembled", "blocks"}
    assert (tmp_path / "t.wav").read_bytes() == \
        (tmp_path / "j.wav").read_bytes()


def test_render_and_dump_functions_match_jax():
    rng = np.random.default_rng(3)
    words = rng.integers(0, 1 << 14, (12, 8))
    crcs = rng.integers(0, 1 << 16, 12)
    valid = rng.random(12) < 0.6
    fp, fq, br = (rng.random(12) < 0.2 for _ in range(3))
    np.testing.assert_array_equal(
        trender.render_stc007_lines(words, crcs, valid, fp, fq, br),
        jrender.render_stc007_lines(words, crcs, valid, fp, fq, br))
    ok = rng.random((12, 8)) < 0.7
    np.testing.assert_array_equal(
        trender.render_stc007_blocks(words, ok, ok & valid[:, None], fp, fq,
                                     br, fp),
        jrender.render_stc007_blocks(words, ok, ok & valid[:, None], fp, fq,
                                     br, fp))
    px = rng.integers(0, 256, (5, 40)).astype(np.uint8)
    np.testing.assert_array_equal(trender.render_source_lines(px, 16),
                                  jrender.render_source_lines(px, 16))
    np.testing.assert_array_equal(trender.render_block_states([0, 3, 1, 9]),
                                  jrender.render_block_states([0, 3, 1, 9]))
    from sdvpcmdecoder_tpu.utils import dump as jdump
    assert tdump.dump_lines(words, crcs, valid, limit=5) == \
        jdump.dump_lines(words, crcs, valid, limit=5)


def test_live_audio_sink_receives_the_wav(tmp_path):
    """--live-audio to a file sink: the pump drains what the WAV holds."""
    cap = small_capture(tmp_path, sigma=0.0)
    sink = tmp_path / "live.raw"
    rc = tcli.main([str(cap), "-o", str(tmp_path / "o.wav"), "--quality",
                    "fast", "--device", "cpu", "--live-audio", str(sink)])
    assert rc == 0
    data, _ = wav.read_wav(tmp_path / "o.wav")
    raw = np.frombuffer(sink.read_bytes(), "<i2").reshape(-1, 2)
    assert len(raw) > 0 and len(raw) <= len(data)
    assert isinstance(tla.make_sink(str(tmp_path / "x.raw")), tla.FDSink)


def test_cli_checkpoint_resume_matches_uninterrupted(tmp_path):
    cap = small_capture(tmp_path, sigma=30.0, n_frames=6)
    ref = tmp_path / "ref.wav"
    assert jcli.main([str(cap), "-o", str(ref), "--quality", "fast",
                      "--batch", "2"]) == 0
    out, ck = tmp_path / "o.wav", str(tmp_path / "ck")
    common = [str(cap), "-o", str(out), "--quality", "fast", "--batch", "2",
              "--device", "cpu", "--checkpoint", ck]
    assert tcli.main(common + ["--frames", "4"]) == 0
    assert os.path.exists(ck + ".json")
    assert tcli.main(common) == 0
    assert out.read_bytes() == ref.read_bytes()


@pytest.mark.parametrize("fmt", ["arvid"])
def test_unported_formats_exit_2(tmp_path, capsys, fmt):
    """--format arvid is ported now: on an STC-007 capture it dumps what
    the JAX CLI dumps (the prototype's words, no WAV)."""
    cap = small_capture(tmp_path, sigma=0.0, n_frames=1)
    dumps = []
    for tag, main, extra in (("j", jcli.main, []),
                             ("t", tcli.main, ["--device", "cpu"])):
        out = tmp_path / f"{tag}.txt"
        assert main([cap, "-o", str(out), "--format", fmt] + extra) == 0
        dumps.append((out.read_bytes(), (tmp_path / f"{tag}.bin")
                      .read_bytes()))
    assert dumps[0] == dumps[1] and len(dumps[1][0]) > 0
    assert "not ported" not in capsys.readouterr().err


@pytest.mark.parametrize("ext", [".avi", ".mkv"])
def test_unported_containers_exit_2(tmp_path, capsys, ext):
    """AVI/Matroska decode in-process now; a file that is no container
    falls through to the FFmpeg transcode as in the JAX CLI, and without
    ffmpeg both CLIs return 2 with the same message."""
    src = tmp_path / f"cap{ext}"
    src.write_bytes(b"RIFFfake")
    import shutil
    rcs, errs = [], []
    for main, extra in ((jcli.main, []), (tcli.main, ["--device", "cpu"])):
        from unittest import mock
        with mock.patch.object(shutil, "which", lambda name: None):
            rcs.append(main([str(src), "-o", str(tmp_path / "o.wav")]
                            + extra))
        errs.append(capsys.readouterr().err)
    assert rcs == [2, 2] and errs[0] == errs[1]
    assert "in-process container decode unavailable" in errs[1]
    assert "not ported" not in errs[1]


def test_cli_transcode_invoked_and_graceful_without_ffmpeg(tmp_path,
                                                           monkeypatch):
    """Other containers go through the FFmpeg helper, as in the JAX CLI;
    without an ffmpeg binary the CLI returns 2."""
    from sdvpcmdecoder_tpu_torch.pipeline import ingest as tingest
    y4m = small_capture(tmp_path, sigma=0.0)
    src = tmp_path / "cap.mov"
    src.write_bytes(b"fake")
    import shutil
    calls = {}

    def fake_transcode(s, dst, ffmpeg="ffmpeg"):
        calls["src"] = str(s)
        shutil.copy(y4m, dst)
        return 0

    monkeypatch.setattr(tingest, "transcode_with_ffmpeg", fake_transcode)
    out = tmp_path / "o.wav"
    assert tcli.main([str(src), "-o", str(out), "--quality", "fast",
                      "--device", "cpu"]) == 0
    assert calls["src"] == str(src) and out.stat().st_size > 1000
    monkeypatch.undo()
    monkeypatch.setattr(shutil, "which", lambda name: None)
    assert tcli.main([str(src), "-o", str(out), "--device", "cpu"]) == 2


def test_cli_backend_device_rejects_unsupported(tmp_path, capsys):
    cap = small_capture(tmp_path, sigma=0.0, n_frames=1)
    rc = tcli.main([cap, "-o", str(tmp_path / "o.wav"), "--backend",
                    "device", "--cwd", "--device", "cpu"])
    assert rc == 2
    err = capsys.readouterr().err
    assert "--cwd" in err and "--backend device" in err


def test_cli_default_device_is_cuda_and_refuses_without_one(tmp_path,
                                                            capsys,
                                                            monkeypatch):
    """No "cuda if available": the default device is cuda, and on a
    machine without a card the CLI says so and returns 2."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cap = small_capture(tmp_path, sigma=0.0, n_frames=1)
    out = tmp_path / "o.wav"
    for backend in BACKENDS:
        rc = tcli.main([cap, "-o", str(out), "--backend", backend])
        assert rc == 2 and not out.exists()
        assert "no CUDA device" in capsys.readouterr().err


def test_cli_device_backend_passes_quality_to_the_driver(tmp_path,
                                                         monkeypatch):
    seen = {}
    orig = tdd.DeviceBatchDecoder

    class Spy(orig):
        def __init__(self, jobs, **kw):
            seen.update(kw)
            super().__init__(jobs, **kw)

    monkeypatch.setattr(tdd, "DeviceBatchDecoder", Spy)
    cap = small_capture(tmp_path, sigma=0.0, n_frames=2)
    for quality, expect in (("normal", (False, True, True)),
                            ("insane", (True, False, True)),
                            ("fast", (False, False, False))):
        assert tcli.main([cap, "-o", str(tmp_path / "o.wav"), "--backend",
                          "device", "--quality", quality, "--device",
                          "cpu"]) == 0
        assert (seen["ref_sweep"], seen["ref_sweep_fallback"],
                seen["normal_sweep_prescan"]) == expect
        assert (seen["hyst_limit"], seen["shift_limit"]) == \
            tcli.QUALITY_LIMITS[quality]
        assert seen["device"] == "cpu" and seen["use_kernel"] is None
