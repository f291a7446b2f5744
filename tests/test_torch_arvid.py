"""The port's ArVid prototype path (formats/arvid.py, pipeline/arvid_pipe.py,
--format arvid) against the JAX package's, on the CPU.

Mirrors tests/test_arvid.py: rendered word rows round-trip, the batch
decode equals the serial per-line reference, the dump format, and the
CLI's text and raw dumps equal the JAX CLI's byte for byte.
"""
import numpy as np
import pytest
import torch

from sdvpcmdecoder_tpu import __main__ as jcli
from sdvpcmdecoder_tpu.formats import arvid as jarvid
from sdvpcmdecoder_tpu.pipeline import arvid_pipe as jpipe
from sdvpcmdecoder_tpu_torch import __main__ as tcli
from sdvpcmdecoder_tpu_torch.formats import arvid
from sdvpcmdecoder_tpu_torch.ops import line_decode_np as ld
from sdvpcmdecoder_tpu_torch.pipeline import arvid_pipe, avi
from sdvpcmdecoder_tpu_torch.synth import encoder as enc

import chip_smoke

torch.set_num_threads(1)


def _render_frames(rng, F=2, L=64, W=1024, noise=0.0):
    words = rng.integers(0, 256, size=(F, L, arvid.WORD_CNT))
    frames = np.zeros((F, L, W), np.uint8) + 20
    coords = (0, W - 1)
    for f in range(F):
        px, coords = enc.render_bits(arvid.words_to_data_bits(words[f]),
                                     width=W, ppb=5.5)
        frames[f] = px
    if noise:
        frames = np.clip(frames + rng.normal(0, noise, frames.shape), 0,
                         255).astype(np.uint8)
    return words, frames, coords


def test_format_model_equals_jax():
    for name in ("BITS_PER_WORD", "WORD_MASK", "BITS_START", "BITS_PCM_DATA",
                 "BITS_IN_LINE", "BITS_LEFT_SHIFT", "BITS_RIGHT_SHIFT",
                 "WORD_CNT"):
        assert getattr(arvid, name) == getattr(jarvid, name)
    w = np.random.default_rng(0).integers(0, 256, (5, arvid.WORD_CNT))
    bits = arvid.words_to_data_bits(w)
    np.testing.assert_array_equal(bits, jarvid.words_to_data_bits(w))
    np.testing.assert_array_equal(arvid.data_bits_to_words(bits), w)
    np.testing.assert_array_equal(arvid.silent_words(), jarvid.silent_words())


@pytest.mark.parametrize("noise", [0.0, 40.0])
@pytest.mark.parametrize("depth", [0, 3])
def test_decode_frames_like_jax(noise, depth):
    rng = np.random.default_rng(12)
    words, frames, coords = _render_frames(rng, noise=noise)
    got, refs = arvid_pipe.decode_frames(frames, coords=coords, depth=depth)
    jgot, jrefs = jpipe.decode_frames(frames, coords=coords, depth=depth)
    assert got.dtype == jgot.dtype and refs.dtype == jrefs.dtype
    np.testing.assert_array_equal(got, jgot)
    np.testing.assert_array_equal(refs, jrefs)
    if not noise:
        np.testing.assert_array_equal(got.astype(np.int64), words)
        assert (refs > 0).all()


def test_decode_matches_serial_reference():
    rng = np.random.default_rng(13)
    _, frames, coords = _render_frames(rng, F=1, L=8)
    got, refs = arvid_pipe.decode_frames(frames, coords=coords)
    for li in range(8):
        ser, _, _, _ = ld.decode_trial_arvid(
            frames[0, li], coords[0], coords[1], int(refs[0]), 0, 0,
            frames.shape[2])
        np.testing.assert_array_equal(got[0, li].astype(int),
                                      np.asarray(ser[:18]))


def test_dump_format_and_files_like_jax(tmp_path):
    w = np.arange(18, dtype=np.uint8)[None, :].repeat(2, axis=0)
    lines = arvid_pipe.dump_words_lines(w, 7)
    assert lines == jpipe.dump_words_lines(w, 7)
    assert lines[0].startswith("F[00007] L[000] 00 01 02")
    rng = np.random.default_rng(3)
    _, frames, coords = _render_frames(rng, F=2, L=16)
    for mod, tag in ((arvid_pipe, "t"), (jpipe, "j")):
        assert mod.decode_to_dump(frames, str(tmp_path / f"{tag}.txt"), 5,
                                  coords=coords,
                                  bin_path=str(tmp_path / f"{tag}.bin")) == 2
    for ext in ("txt", "bin"):
        assert (tmp_path / f"t.{ext}").read_bytes() == \
            (tmp_path / f"j.{ext}").read_bytes()


@pytest.mark.parametrize("container", ["y4m", "avi"])
def test_cli_arvid_dump_like_jax(tmp_path, container):
    """The CLI on an ArVid capture (y4m, or HFYU AVI) writes the JAX
    CLI's text and raw dumps, and the raw words are the rendered ones."""
    cap, coords = chip_smoke.write_arvid_capture(str(tmp_path / "ar.y4m"),
                                                 n_frames=2, seed=14)
    if container == "avi":
        from sdvpcmdecoder_tpu_torch.pipeline import ingest
        with ingest.open_capture(cap) as rd:
            frames = rd.read_frames(0, 2)
        cap = str(tmp_path / "ar.avi")
        avi.write_avi(cap, frames, codec="HFYU")
    fc = ["--force-coords", f"{coords[0]}:{coords[1]}"]
    dumps = []
    for tag, main, extra in (("j", jcli.main, []),
                             ("t", tcli.main, ["--device", "cpu"])):
        out = tmp_path / f"{tag}.txt"
        assert main([cap, "-o", str(out), "--format", "arvid"] + fc
                    + extra) == 0
        dumps.append((out.read_bytes(), (tmp_path / f"{tag}.bin")
                      .read_bytes()))
    assert dumps[0] == dumps[1]
    assert len(dumps[1][0].decode().splitlines()) == 2 * chip_smoke.PAL_LINES
    rng = np.random.default_rng(14)
    words = rng.integers(0, 256, (2, chip_smoke.PAL_LINES, arvid.WORD_CNT))
    raw = np.frombuffer(dumps[1][1], np.uint8).reshape(words.shape)
    # the dump is field-sequential: even frame rows, then odd
    np.testing.assert_array_equal(raw.astype(np.int64), words)


def test_cli_arvid_under_device_backend_like_jax(tmp_path):
    """--format arvid dispatches before --backend device, as in the JAX
    CLI: both dump the words."""
    cap, coords = chip_smoke.write_arvid_capture(str(tmp_path / "a.y4m"),
                                                 n_frames=1)
    rcs = []
    for tag, main, extra in (("j", jcli.main, []),
                             ("t", tcli.main, ["--device", "cpu"])):
        rcs.append(main([cap, "-o", str(tmp_path / f"{tag}.txt"),
                         "--format", "arvid", "--backend", "device"] + extra))
    assert rcs == [0, 0]
    assert (tmp_path / "t.txt").read_bytes() == \
        (tmp_path / "j.txt").read_bytes()
