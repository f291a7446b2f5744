"""The port's PCM trial grid (ops/binarize: format_syndrome_table,
generic_frame_decode, pcm1_frame_decode, pcm16x0_frame_decode) and the
packed device round (ops/device_pcm) against the JAX package's, exactly:
every output on every line, dtypes included, clean and noisy, at
hyst_limit 0 / 2 / 4, with coordinates near the right edge and frames
whose levels clip every trial.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdvpcmdecoder_tpu.ops import binarize as jbz
from sdvpcmdecoder_tpu.ops import device_pcm as jdp
from sdvpcmdecoder_tpu.ops import stitch_native as jsn
from sdvpcmdecoder_tpu_torch.formats import pcm1, pcm16x0
from sdvpcmdecoder_tpu_torch.ops import binarize as tbz
from sdvpcmdecoder_tpu_torch.ops import device_pcm as tdp
from sdvpcmdecoder_tpu_torch.synth import encoder as enc

torch.set_num_threads(1)

W1, W16 = 1024, 1600


def pcm1_frames(F=2, L=24, sigma=0.0, seed=5):
    """tests/test_pcm_hyst.py's PCM-1 frames at L lines a frame."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 13, (F * L, 6))
    bits = pcm1.words_to_data_bits(words, pcm1.calc_crc(words, xp=np),
                                   xp=np)
    px, (ds, de) = enc.render_bits(np.asarray(bits), width=W1, ppb=10.0,
                                   noise_sigma=sigma, rng=rng)
    return px.reshape(F, L, W1), np.tile([[ds, de]], (F, 1))


def pcm16x0_frames(F=2, L=24, sigma=0.0, seed=6, ppb=7.0, start_px=32):
    rng = np.random.default_rng(seed)
    sub = rng.integers(1, 1 << 16, (F * L * 3, 3))
    crcs = np.asarray(pcm16x0.calc_crc(sub, xp=np))
    ctrl = rng.integers(0, 2, F * L)
    bits = pcm16x0.line_bits(sub.reshape(F * L, 3, 3),
                             crcs.reshape(F * L, 3), ctrl, xp=np)
    px, (ds, de) = enc.render_bits(np.asarray(bits), width=W16, ppb=ppb,
                                   noise_sigma=sigma, rng=rng,
                                   start_px=start_px)
    return px.reshape(F, L, W16), np.tile([[ds, de]], (F, 1))


def levels(F, ref=110, black=20, white=200):
    out = [np.full(F, v, np.int32) for v in (ref, black, white)]
    out[0][-1] = ref - 7      # one frame at other levels
    return out


def both(px, cd, lv):
    """(JAX arguments, torch arguments) of one call."""
    host = (px, cd.astype(np.int32), *lv)
    return ([jnp.asarray(a) for a in host],
            [torch.from_numpy(np.ascontiguousarray(a)) for a in host])


def assert_outputs(jout, tout):
    assert len(jout) == len(tout)
    for k, (a, b) in enumerate(zip(jout, tout)):
        a = np.asarray(a)
        b = b.numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, (k, a.dtype,
                                                           b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=str(k))


@pytest.mark.parametrize("fmt", ["stc007", "pcm1", "pcm16x0"])
def test_format_syndrome_table_matches_jax(fmt):
    jt, jc = jbz.format_syndrome_table(fmt)
    tt, tc = tbz.format_syndrome_table(fmt)
    assert jt.dtype == tt.dtype and np.array_equal(jt, tt) and jc == tc
    assert tbz.FORMAT_GEOM[fmt] == jbz.FORMAT_GEOM[fmt]


@pytest.mark.parametrize("fmt", ["pcm1", "pcm16x0"])
def test_syndrome_zero_iff_crc_matches(fmt):
    """The table (built from the complemented PCM-1 CRC too) gives a zero
    syndrome exactly on lines whose read CRC is their calc CRC."""
    mod = pcm1 if fmt == "pcm1" else pcm16x0
    rng = np.random.default_rng(1)
    w = rng.integers(0, 1 << mod.BITS_PER_WORD, (64, mod.N_WORDS))
    crc = mod.calc_crc(w, xp=np)
    crc[::3] ^= 1 << rng.integers(0, 16, crc[::3].shape)
    bits = torch.from_numpy(mod.words_to_data_bits(w, crc, xp=np)
                            .astype(np.int32))
    table, const = tbz.format_syndrome_table(fmt)
    synd = tbz._syndrome(bits, torch.from_numpy(table), const)
    assert ((synd == 0).numpy() == (mod.calc_crc(w, xp=np) == crc)).all()


@pytest.mark.parametrize("hl,sl", [(0, 2), (2, 1), (4, 2)])
@pytest.mark.parametrize("part_start", [0, 64, 129])
def test_generic_frame_decode_matches_jax(part_start, hl, sl):
    px, cd = pcm16x0_frames(sigma=30.0, seed=part_start)
    j, t = both(px, cd, levels(2))
    assert_outputs(jbz.generic_frame_decode(*j, "pcm16x0", hyst_limit=hl,
                                            shift_limit=sl,
                                            part_start=part_start),
                   tbz.generic_frame_decode(*t, "pcm16x0", hyst_limit=hl,
                                            shift_limit=sl,
                                            part_start=part_start))


@pytest.mark.parametrize("hl", [0, 2, 4])
@pytest.mark.parametrize("sigma", [0.0, 34.0])
def test_pcm1_frame_decode_matches_jax(hl, sigma):
    px, cd = pcm1_frames(sigma=sigma)
    j, t = both(px, cd, levels(2))
    jout = jbz.pcm1_frame_decode(*j, shift_limit=2, hyst_limit=hl)
    tout = tbz.pcm1_frame_decode(*t, shift_limit=2, hyst_limit=hl)
    assert_outputs(jout, tout)
    if sigma:   # noisy: some lines fail, and fall back to trial (0, 0)
        assert 0 < int(tout[2].sum()) < tout[2].numel()
    else:
        assert bool(tout[2].all())
    nat = jsn.pcm1_binarize_frames(px, cd, *levels(2), 2, hyst_limit=hl)
    np.testing.assert_array_equal(tout[2].numpy(), nat[2])


@pytest.mark.parametrize("hl", [0, 2, 4])
@pytest.mark.parametrize("sigma", [0.0, 44.0])
def test_pcm16x0_frame_decode_matches_jax(hl, sigma):
    px, cd = pcm16x0_frames(sigma=sigma)
    j, t = both(px, cd, levels(2))
    tout = tbz.pcm16x0_frame_decode(*t, shift_limit=2, hyst_limit=hl)
    assert_outputs(jbz.pcm16x0_frame_decode(*j, shift_limit=2,
                                            hyst_limit=hl), tout)
    if sigma:
        assert 0 < int(tout[2].sum()) < tout[2].numel()


def test_right_edge_and_clipped_levels_match_jax():
    """Lines whose right part runs past the last column (the gathers clip
    to W - 1 as JAX's one-hot product does) and frames whose levels rule
    out every trial (read_ok false: all lines fall back to (0, 0))."""
    px, cd = pcm16x0_frames(F=3, sigma=10.0, ppb=8.2, start_px=40)
    assert cd[0, 1] > W16
    for lv in (levels(3), [np.full(3, 110, np.int32),
                           np.array([20, 108, 20], np.int32),
                           np.array([200, 200, 111], np.int32)]):
        j, t = both(px, cd, lv)
        for hl, sl in ((0, 4), (2, 1)):
            assert_outputs(jbz.pcm16x0_frame_decode(*j, shift_limit=sl,
                                                    hyst_limit=hl),
                           tbz.pcm16x0_frame_decode(*t, shift_limit=sl,
                                                    hyst_limit=hl))
    p1, c1 = pcm1_frames(F=2, sigma=10.0)
    c1 = c1 + [[60, 90]]
    j, t = both(p1, c1, levels(2))
    assert_outputs(jbz.pcm1_frame_decode(*j, shift_limit=4, hyst_limit=1),
                   tbz.pcm1_frame_decode(*t, shift_limit=4, hyst_limit=1))


def test_frame_decode_recovers_the_encoded_words():
    """tests/test_line_decode_np.py's generic decodes: every line valid,
    words, read CRCs and control bits equal the encoder's."""
    rng = np.random.default_rng(8)
    sub = rng.integers(0, 1 << 16, size=(15, 3, 3))
    crcs = pcm16x0.calc_crc(sub, xp=np)
    ctrl = rng.integers(0, 2, size=15)
    bits = np.stack([pcm16x0.line_bits(sub[i:i + 1], crcs[i:i + 1],
                                       int(ctrl[i]), xp=np)[0]
                     for i in range(15)])
    pixels, (ds, de) = enc.render_bits(bits, width=W16, ppb=7.0)
    lv = [torch.tensor([v], dtype=torch.int32) for v in (110, 20, 200)]
    w, cr, valid, cb = tbz.pcm16x0_frame_decode(
        torch.from_numpy(pixels[None]),
        torch.tensor([[ds, de]], dtype=torch.int32), *lv)
    assert bool(valid.all())
    np.testing.assert_array_equal(w[0].numpy(), sub)
    np.testing.assert_array_equal(cr[0].numpy(), crcs)
    np.testing.assert_array_equal(cb[0].numpy(), ctrl.astype(bool))


def round_params(cd, lv, usable):
    o, n = tdp.round_param_layout(len(cd))
    assert (o, n) == jdp.round_param_layout(len(cd))
    p = np.zeros(n, np.int32)
    for key, a in (("coords", cd), ("refs", lv[0]), ("blacks", lv[1]),
                   ("whites", lv[2]), ("usable", usable)):
        a = np.asarray(a).ravel()
        p[o[key]:o[key] + a.size] = a
    return p


@pytest.mark.parametrize("fmt", ["pcm1", "pcm16x0"])
def test_pcm_round_packed_and_unpack_match_jax(fmt):
    """One packed round, byte for byte, with an unusable frame (zeroed),
    and the host split of it (int64 words, CRCs and control bits)."""
    F, L = 3, 20
    make = pcm1_frames if fmt == "pcm1" else pcm16x0_frames
    px, cd = make(F=F, L=L, sigma=28.0, seed=9)
    usable = np.array([1, 0, 1])
    params = round_params(cd, levels(F), usable)
    for hl, sl in ((0, 2), (2, 1)):
        jbuf = np.asarray(jdp.pcm_round_packed(
            jnp.asarray(px), jnp.asarray(params), fmt=fmt, shift_limit=sl,
            hyst_limit=hl))
        tbuf = tdp.pcm_round_packed(torch.from_numpy(px),
                                    torch.from_numpy(params), fmt, sl, hl)
        assert tbuf.dtype == torch.int32 and jbuf.dtype == np.int32
        np.testing.assert_array_equal(jbuf, tbuf.numpy())
        jun = jdp.unpack_round(jbuf, F, L, fmt)
        tun = tdp.unpack_round(tbuf.numpy(), F, L, fmt)
        for a, b in zip(jun, tun):
            if a is None:
                assert b is None
                continue
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        assert not tun[0][1].any() and not tun[2][1].any()
        assert tun[2][0].any()
