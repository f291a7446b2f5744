"""Port checks: the STC-007 decode chain of sdvpcmdecoder_tpu_torch
(pipeline/decoder.py) against the JAX package's, exactly, in every
resolution mode, plus the chain's tail through the audio masker and WAV
writer.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from sdvpcmdecoder_tpu.pipeline import audio as jaudio
from sdvpcmdecoder_tpu.pipeline import decoder as jdecoder
from sdvpcmdecoder_tpu.pipeline import wav as jwav
from sdvpcmdecoder_tpu_torch.formats import stc007
from sdvpcmdecoder_tpu_torch.ops import deinterleave as di
from sdvpcmdecoder_tpu_torch.pipeline import audio, decoder, wav
from sdvpcmdecoder_tpu_torch.synth import encoder as enc

torch.set_num_threads(1)

F, LF, W = 2, 150, 1152


def assert_same(got, expect, what=""):
    expect = np.asarray(expect)
    got = got.cpu().numpy()
    assert got.dtype == expect.dtype, f"{what}: {got.dtype} != {expect.dtype}"
    np.testing.assert_array_equal(got, expect, err_msg=what)


def assert_result(got, expect):
    for name in got._fields:
        assert_same(getattr(got, name), getattr(expect, name), name)


def stream(resolution, sigma, seed):
    """[F, LF, W] pixels of an encoded stream + per-frame coords and the
    encoder's samples (14- or 16-bit words)."""
    rng = np.random.default_rng(seed)
    n_lines = F * LF
    left, right = rng.integers(0, 1 << resolution, (2, 3 * n_lines))
    if resolution == 14:
        blocks = enc.samples_to_blocks(left, right)
    else:
        blocks = enc.samples_to_blocks16(left, right)
    line_words, crcs = enc.blocks_to_lines(blocks, n_lines,
                                           resolution=resolution)
    pixels, coords = enc.render_lines(line_words, crcs, width=W, ppb=8.0,
                                      noise_sigma=sigma, rng=rng)
    return (pixels.reshape(F, LF, W), coords[::LF].astype(np.int32),
            left, right)


def frame_levels():
    return (np.array([110, 104], np.int32), np.array([5, 20], np.int32),
            np.array([250, 200], np.int32))


@pytest.mark.parametrize("res_mode", [di.RES_MODE_14BIT,
                                      di.RES_MODE_16BIT,
                                      di.RES_MODE_14BIT_AUTO,
                                      di.RES_MODE_16BIT_AUTO])
@pytest.mark.parametrize("resolution", [14, 16])
def test_decode_frames_matches_jax(resolution, res_mode):
    """Noisy streams (some lines fail CRC, ECC engaged) through both
    chains; the JAX side runs its plain binarize (use_pallas=False)."""
    pixels, coords, _, _ = stream(resolution, sigma=38.0, seed=resolution)
    ref, black, white = frame_levels()
    args = (pixels, coords, ref, black, white)
    expect = jdecoder.decode_frames(*map(jnp.asarray, args),
                                    res_mode=res_mode, use_pallas=False)
    got = decoder.decode_frames(*map(torch.from_numpy, args),
                                res_mode=res_mode)
    assert_result(got, expect)
    assert not bool(got.line_valid.all())


def test_decode_frames_recovers_encoder_samples():
    pixels, coords, left, right = stream(14, sigma=10.0, seed=3)
    ref, black, white = frame_levels()
    got = decoder.decode_frames(*map(torch.from_numpy,
                                     (pixels, coords, ref, black, white)))
    n = 3 * (F * LF - stc007.MIN_DEINT_DATA)
    assert bool(got.line_valid.all()) and bool(got.sample_valid.all())
    assert_same(got.samples[:, 0], stc007.expand_sample(
        torch.from_numpy(left[:n])).numpy())
    assert_same(got.samples[:, 1], stc007.expand_sample(
        torch.from_numpy(right[:n])).numpy())


def test_kernel_and_plain_paths_agree_on_cpu():
    pixels, coords, _, _ = stream(14, sigma=38.0, seed=4)
    args = tuple(map(torch.from_numpy, (pixels, coords) + frame_levels()))
    assert_result(decoder.decode_frames(*args, use_kernel=True),
                  decoder.decode_frames(*args, use_kernel=False))


def test_chain_uses_no_matmul(monkeypatch):
    """torch has no integer matmul on CUDA and a float one depends on the
    TF32 setting: the chain's GF(2) algebra must not call either."""
    def refuse(*args, **kwargs):
        raise AssertionError("matmul called")
    for name in ("matmul", "mm", "bmm", "einsum", "tensordot"):
        monkeypatch.setattr(torch, name, refuse)
    monkeypatch.setattr(torch.Tensor, "__matmul__", refuse)
    pixels, coords, _, _ = stream(14, sigma=38.0, seed=7)
    args = tuple(map(torch.from_numpy, (pixels, coords) + frame_levels()))
    for res_mode in (di.RES_MODE_14BIT, di.RES_MODE_16BIT):
        res = decoder.decode_frames(*args, res_mode=res_mode)
        assert res.samples.dtype == torch.int16
    px, cd = args[0][0], args[1][:1].expand(LF, 2)
    lv = [torch.full((LF,), v, dtype=torch.int32) for v in (110, 5, 250)]
    res = decoder.decode_stream(px, cd, *lv, hyst_limit=1, shift_limit=1)
    assert res.samples.dtype == torch.int16


def test_stream_decoder_buffers():
    dec = decoder.StreamDecoder()
    names = {n for n, _ in dec.named_buffers()}
    assert names == {"synd_table", "pack_weights", "q_bank_a", "q_bank_b"}
    assert all(b.dtype == torch.int32 for b in dec.buffers())
    assert tuple(dec.q_bank_a.shape) == (14, 49 * 14)
    dec = dec.to("meta")
    assert all(b.device.type == "meta" for b in dec.buffers())


@pytest.mark.parametrize("res_mode", [di.RES_MODE_14BIT,
                                      di.RES_MODE_14BIT_AUTO])
def test_decode_stream_matches_jax(res_mode):
    rng = np.random.default_rng(5)
    n = 3 * 60
    pixels, coords, *_ = enc.encode_stream(
        rng.integers(0, 1 << 14, n), rng.integers(0, 1 << 14, n),
        width=W, ppb=8.0, noise_sigma=38.0, rng=rng)
    L = pixels.shape[0]
    lv = [np.full(L, v, np.int32) for v in (110, 5, 250)]
    kw = dict(hyst_limit=2, shift_limit=1, res_mode=res_mode)
    expect = jdecoder.decode_stream(jnp.asarray(pixels), jnp.asarray(coords),
                                    *map(jnp.asarray, lv), **kw)
    got = decoder.decode_stream(torch.from_numpy(pixels),
                                torch.from_numpy(coords),
                                *map(torch.from_numpy, lv), **kw)
    assert_result(got, expect)


def test_decode_to_numpy_and_wav_match_jax(tmp_path):
    """decode_to_numpy -> AudioProcessor -> WavWriter, both packages: the
    WAV files are byte-identical."""
    rng = np.random.default_rng(6)
    n = 3 * 50
    pixels, coords, *_ = enc.encode_stream(
        rng.integers(0, 1 << 14, n), rng.integers(0, 1 << 14, n),
        width=W, ppb=8.0, noise_sigma=35.0, rng=rng)
    pixels[60:64] = 0                                  # a short dropout
    got = decoder.decode_to_numpy(pixels, coords, hyst_limit=1,
                                  shift_limit=1, device="cpu")
    expect = jdecoder.decode_to_numpy(pixels, coords, hyst_limit=1,
                                      shift_limit=1)
    for g, e in zip(got, expect):
        assert g.dtype == e.dtype
        np.testing.assert_array_equal(g, e)
    paths = []
    for amod, wmod, (samples, svalid, *_), tag in (
            (audio, wav, got, "port"), (jaudio, jwav, expect, "jax")):
        out = amod.AudioProcessor().process(samples, svalid)
        path = tmp_path / f"{tag}.wav"
        wmod.write_wav(path, out, sample_rate=44056)
        paths.append(path)
    back, rate = wav.read_wav(paths[0])
    assert rate == 44056 and back.shape == got[0].shape
    assert paths[0].read_bytes() == paths[1].read_bytes()
