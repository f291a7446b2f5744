"""Port checks: the torch binarizer (ops/binarize.py, and the CUDA kernel's
wrapper on CPU tensors) against the JAX package, exactly, on all lines.

Inputs are noisy encoder streams made from a seed with numpy; both sides
get the same arrays. Every output is an integer or a bool, so every
comparison is exact and checks the dtype too.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from sdvpcmdecoder_tpu.ops import binarize as jbz
from sdvpcmdecoder_tpu.ops import pallas_binarize as jpb
from sdvpcmdecoder_tpu.synth import encoder as jenc
from sdvpcmdecoder_tpu_torch.ops import binarize as bz
from sdvpcmdecoder_tpu_torch.ops import fused_binarize as fb

torch.set_num_threads(1)


def assert_same(got, expect, what=""):
    """torch tensor vs JAX/numpy array: same dtype, shape and values."""
    expect = np.asarray(expect)
    got = got.cpu().numpy()
    assert got.dtype == expect.dtype, f"{what}: {got.dtype} != {expect.dtype}"
    np.testing.assert_array_equal(got, expect, err_msg=what)


def assert_batch(got, expect):
    for name in got._fields:
        assert_same(getattr(got, name), getattr(expect, name), name)


def noisy_frames(n_frames, lines_pf, seed, sigma=30.0, width=1152):
    """Encoder stream reshaped to [F, Lf, W] + per-frame coords [F, 2]."""
    rng = np.random.default_rng(seed)
    n = 3 * n_frames * lines_pf
    pixels, coords, *_ = jenc.encode_stream(
        rng.integers(0, 1 << 14, n), rng.integers(0, 1 << 14, n),
        width=width, ppb=8.0, n_lines=n_frames * lines_pf,
        noise_sigma=sigma, rng=rng)
    return (pixels.reshape(n_frames, lines_pf, width),
            coords[::lines_pf].astype(np.int32))


def levels(n_frames, lines_pf, per_line, seed):
    """(ref, black, white) int32 per frame [F] or per line [F, Lf]."""
    rng = np.random.default_rng(seed)
    shape = (n_frames, lines_pf) if per_line else (n_frames,)
    ref = rng.integers(100, 121, shape).astype(np.int32)
    black = rng.integers(2, 12, shape).astype(np.int32)
    white = rng.integers(244, 254, shape).astype(np.int32)
    # A few lines/frames whose deep trials clip into black/white.
    black.reshape(-1)[::7] = 104
    return ref, black, white


def test_calc_ppb_and_coords():
    rng = np.random.default_rng(0)
    start = rng.integers(20, 60, 16).astype(np.int32)
    stop = start + rng.integers(900, 1100, 16).astype(np.int32)
    psm, half = jbz.calc_ppb(jnp.asarray(start), jnp.asarray(stop), 132)
    tpsm, thalf = bz.calc_ppb(torch.from_numpy(start),
                              torch.from_numpy(stop), 132)
    assert_same(tpsm, psm, "psm")
    assert_same(thalf, half, "half")
    stage = rng.integers(0, 5, 16).astype(np.int32)
    expect = jbz.bit_pixel_coords(jnp.asarray(start), psm, half,
                                  jnp.asarray(stage), 128, 3, 137, 24, 76,
                                  pixel_stop=1000)
    got = bz.bit_pixel_coords(torch.from_numpy(start), tpsm, thalf,
                              torch.from_numpy(stage), 128, 3, 137, 24, 76,
                              pixel_stop=1000)
    assert_same(got, expect, "coords")


def test_frame_bit_coords_match_selection():
    """The kernel's [F, S, 128] coordinates are the one-hot columns of the
    TPU kernel's selection matrices."""
    _, coords = noisy_frames(2, 40, seed=1)
    sel = np.asarray(jpb.build_selection(jnp.asarray(coords), 3, 1152))
    pc = bz.stc007_frame_bit_coords(torch.from_numpy(coords), 3, 1152)
    assert pc.dtype == torch.int32 and tuple(pc.shape) == (2, 3, 128)
    np.testing.assert_array_equal(sel.argmax(-1), pc.numpy())
    assert (sel.sum(-1) == 1).all()


def test_hysteresis_read_matches_jax_and_serial():
    rng = np.random.default_rng(1)
    px = rng.integers(0, 256, size=(4, 32, 128)).astype(np.int32)
    rl = rng.integers(80, 128, size=(4, 32)).astype(np.int32)
    rh = rl + rng.integers(0, 40, size=(4, 32)).astype(np.int32)
    got = bz.hysteresis_read(torch.from_numpy(px), torch.from_numpy(rl),
                             torch.from_numpy(rh))
    assert_same(got, jbz.hysteresis_read(jnp.asarray(px), jnp.asarray(rl),
                                         jnp.asarray(rh)))
    assert_same(got, jbz.hysteresis_read_np(px, rl, rh))


@pytest.mark.parametrize("hyst,shift", [(0, 0), (6, 4)])
def test_line_decode_matches_jax(hyst, shift):
    pixels, coords = noisy_frames(1, 150, seed=2)
    pixels, coords = pixels[0], np.repeat(coords, 150, axis=0)
    ref, black, white = levels(1, 150, True, seed=3)
    ref, black, white = ref[0], black[0], white[0]
    expect = jbz.stc007_line_decode(
        jnp.asarray(pixels), jnp.asarray(coords), jnp.asarray(ref),
        jnp.asarray(black), jnp.asarray(white), hyst, shift)
    got = bz.stc007_line_decode(
        torch.from_numpy(pixels), torch.from_numpy(coords),
        torch.from_numpy(ref), torch.from_numpy(black),
        torch.from_numpy(white), hyst, shift)
    for name, g, e in zip(("words", "crc_read", "crc_calc", "syndrome",
                           "valid"), got, expect):
        assert_same(g, e, name)


def test_read_pcm_grid_matches_jax():
    pixels, coords = noisy_frames(1, 130, seed=4, sigma=40.0)
    pixels, coords = pixels[0], np.repeat(coords, 130, axis=0)
    ref, black, white = levels(1, 130, True, seed=5)
    ref, black, white = ref[0], black[0], white[0]
    expect = jbz.stc007_read_pcm_grid(
        jnp.asarray(pixels), jnp.asarray(coords), jnp.asarray(ref),
        jnp.asarray(black), jnp.asarray(white), hyst_limit=2,
        shift_limit=1)
    got = bz.stc007_read_pcm_grid(
        torch.from_numpy(pixels), torch.from_numpy(coords),
        torch.from_numpy(ref), torch.from_numpy(black),
        torch.from_numpy(white), hyst_limit=2, shift_limit=1)
    assert_batch(got, expect)
    valid = got.valid.numpy()
    assert 0 < valid.sum() < len(valid)


@pytest.mark.parametrize("per_line", [False, True])
@pytest.mark.parametrize("limits", [(4, 2), (10, 4)])
def test_frame_decode_matches_jax_all_lines(limits, per_line):
    """The plain version of K1 equals JAX bz.stc007_frame_decode on every
    field of every line, invalid (fallback) lines included."""
    hyst_limit, shift_limit = limits
    F, Lf = 2, 64
    pixels, coords = noisy_frames(F, Lf, seed=6, sigma=45.0)
    ref, black, white = levels(F, Lf, per_line, seed=7)
    expect = jbz.stc007_frame_decode(
        jnp.asarray(pixels), jnp.asarray(coords), jnp.asarray(ref),
        jnp.asarray(black), jnp.asarray(white), hyst_limit, shift_limit)
    got = bz.stc007_frame_decode(
        torch.from_numpy(pixels), torch.from_numpy(coords),
        torch.from_numpy(ref), torch.from_numpy(black),
        torch.from_numpy(white), hyst_limit, shift_limit)
    assert_batch(got, expect)
    valid = got.valid.numpy()
    assert 0 < valid.sum() < valid.size        # fallback lines are covered
    assert got.hyst.max() > 0 or got.shift.max() > 0


def test_fused_wrapper_matches_pallas_interpret():
    """On a CPU tensor the kernel wrapper runs the plain version; it equals
    the Pallas kernel (interpreter on CPU) on all lines, as run by
    tests/test_binarize.py (2 frames, tile 32, limits (2, 1))."""
    rng = np.random.default_rng(11)
    pixels, coords, *_ = jenc.encode_stream(
        rng.integers(0, 1 << 14, 60), rng.integers(0, 1 << 14, 60),
        width=1152, ppb=8.0, noise_sigma=30.0,
        rng=np.random.default_rng(12))
    F, Lf = 2, pixels.shape[0] // 2
    px = pixels[:F * Lf].reshape(F, Lf, -1)
    cd = coords[:F * Lf:Lf].astype(np.int32)
    ref = np.full(F, 110, np.int32)
    blk = np.full(F, 5, np.int32)
    wht = np.full(F, 250, np.int32)
    expect = jpb.stc007_fused_decode_frames(
        jnp.asarray(px), jnp.asarray(cd), jnp.asarray(ref), jnp.asarray(blk),
        jnp.asarray(wht), 2, 1, tile_lines=32)
    before = fb.stc007_fused_decode_frames.launches
    got = fb.stc007_fused_decode_frames(
        torch.from_numpy(px), torch.from_numpy(cd), torch.from_numpy(ref),
        torch.from_numpy(blk), torch.from_numpy(wht), 2, 1, tile_lines=32)
    assert fb.stc007_fused_decode_frames.launches == before  # no kernel
    assert_batch(got, expect)


@pytest.mark.parametrize("case", ["fallback_64x1", "stop_before_start"])
def test_fused_wrapper_matches_pallas_interpret_shapes(case):
    """As above, at the marker fallback's [64, 1, W] batches (64 single
    lines, each with its own coordinates) and on coordinates with
    stop < start (a negative pitch: torch's `//` floors), on every field
    of every line."""
    if case == "fallback_64x1":
        pixels, coords = noisy_frames(1, 64, seed=15, sigma=30.0)
        px = pixels.reshape(64, 1, -1)
        cd = (coords + np.arange(-32, 32)[:, None]).astype(np.int32)
        F = 64
    else:
        px, _ = noisy_frames(3, 40, seed=16, sigma=30.0)
        cd = np.array([[900, 100], [1100, 1050], [300, -200]], np.int32)
        F = 3
    ref = np.full(F, 110, np.int32)
    blk = np.full(F, 5, np.int32)
    wht = np.full(F, 250, np.int32)
    expect = jpb.stc007_fused_decode_frames(
        jnp.asarray(px), jnp.asarray(cd), jnp.asarray(ref), jnp.asarray(blk),
        jnp.asarray(wht), 2, 1, tile_lines=8)
    got = fb.stc007_fused_decode_frames(
        torch.from_numpy(px), torch.from_numpy(cd), torch.from_numpy(ref),
        torch.from_numpy(blk), torch.from_numpy(wht), 2, 1, tile_lines=8)
    assert_batch(got, expect)
    if case == "fallback_64x1":
        assert 0 < got.valid.numpy().sum() < F


def kernel_read(bits):
    """What the CUDA kernel computes from a read's bits [N, 128] with the
    constants the wrapper hands it: the syndrome (XOR of the packed rows of
    the set bits), the read CRC and crc_calc = syndrome ^ crc_read ^
    CONST. numpy, uint32."""
    rows, _, crc_const = bz.kernel_syndrome_rows()
    synd = np.bitwise_xor.reduce(np.where(bits.astype(bool), rows, 0),
                                 axis=1).astype(np.uint32)
    crc_read = (bits[:, 112:].astype(np.uint32)
                << np.arange(15, -1, -1, dtype=np.uint32)).sum(1)
    return synd, crc_read, (synd ^ crc_read ^ crc_const) & 0xFFFF


def test_kernel_syndrome_rows_reproduce_calc_crc_and_syndrome():
    """The packed rows and constants the wrapper hands the kernel give the
    syndrome of bz._syndrome (valid iff it equals the syndrome constant)
    and crc_calc equal to stc007.calc_crc over the words, of both
    packages, on seeded random reads and on all-zero and all-one lines."""
    from sdvpcmdecoder_tpu.formats import crc as jcrc
    from sdvpcmdecoder_tpu.formats import stc007 as jstc
    from sdvpcmdecoder_tpu_torch.formats import stc007
    rows, synd_const, crc_const = bz.kernel_syndrome_rows()
    assert rows.dtype == np.uint32 and rows.shape == (128,)
    assert synd_const == crc_const == stc007.CRC_SILENT
    rng = np.random.default_rng(17)
    bits = rng.integers(0, 2, (500, 128)).astype(np.int32)
    bits[0], bits[1] = 0, 1
    # Valid lines too: the encoder's words with their own CRC.
    words = rng.integers(0, 1 << 14, (20, 8)).astype(np.int32)
    crc = np.asarray(jstc.calc_crc(jnp.asarray(words)), np.int32)
    bits[2:22] = np.asarray(jstc.words_to_data_bits(jnp.asarray(words),
                                                    jnp.asarray(crc)))
    synd, crc_read, crc_calc = kernel_read(bits)
    table, const = bz._syndrome_const()
    tbits = torch.from_numpy(bits)
    expect_synd = bz._syndrome(tbits, torch.from_numpy(table)).numpy()
    np.testing.assert_array_equal(synd ^ synd_const, expect_synd)
    jsynd = jcrc.pack_bits_to_u16(jnp.matmul(
        jnp.asarray(bits), jnp.asarray(table),
        preferred_element_type=jnp.int32) & 1) ^ const   # as jbz's trials
    np.testing.assert_array_equal(synd ^ synd_const, np.asarray(jsynd))
    assert (expect_synd[2:22] == 0).all() and (expect_synd != 0).sum() > 400
    twords, tcrc = stc007.data_bits_to_words(tbits)
    np.testing.assert_array_equal(crc_read, tcrc.numpy())
    np.testing.assert_array_equal(crc_calc, stc007.calc_crc(twords).numpy())
    np.testing.assert_array_equal(
        crc_calc, np.asarray(jstc.calc_crc(jnp.asarray(twords.numpy()))))
    # The kernel's stage shifts are uniform: the two tables are equal.
    np.testing.assert_array_equal(bz.PIX_SH_BG, bz.PIX_SH_ED)


def test_k1_bound_counts_what_the_data_needs():
    """chip_smoke.k1_bound against the serial trial loop walked line by
    line: its bytes are, of each row, the 32-byte sectors between the
    least and the largest bit-centre column of the shift stages the line
    reads, plus coordinates, levels and 49 output bytes a line; its ops
    are 128 Schmitt steps of 8 ops per trial read."""
    import chip_smoke
    F, L, (n_h, n_s) = 2, 40, chip_smoke.INSANE
    n_h, n_s = n_h + 1, n_s + 1
    px, cd = (torch.from_numpy(a) for a in noisy_frames(F, L, seed=21))
    ref, blk, wht = (torch.from_numpy(a)
                     for a in levels(F, L, per_line=True, seed=22))
    batch = bz.stc007_frame_decode(px, cd, ref, blk, wht, n_h - 1, n_s - 1)
    cols = bz.stc007_frame_bit_coords(cd, n_s, px.shape[2]).numpy()
    n_bytes, reads = 0, 0
    for f in range(F):
        for l in range(L):
            r, b, w = int(ref[f, l]), int(blk[f, l]), int(wht[f, l])
            pick = ((int(batch.hyst[f, l]), int(batch.shift[f, l]))
                    if batch.valid[f, l] else None)
            stages, n = {0}, 1                   # trial (0, 0), read once
            for h in range(n_h):
                if not (max(r - h, 1) > b and min(r + h, 254) < w):
                    continue
                for s in range(n_s):
                    n += (h, s) != (0, 0)
                    stages.add(s)
                    if (h, s) == pick:
                        break
                if pick is not None and h == pick[0]:
                    break
            reads += n
            span = cols[f, sorted(stages)]
            row = px.data_ptr() % 32 + (f * L + l) * px.shape[2]
            n_bytes += 32 * ((row + span.max()) // 32
                             - (row + span.min()) // 32 + 1)
    n_bytes += cd.numel() * 4 + 3 * F * L * 4 + F * L * 49
    _, by, got_bytes, got_ops = chip_smoke.k1_bound(
        px, cd, batch, (ref, blk, wht), (n_h - 1, n_s - 1))
    assert (got_bytes, got_ops) == (n_bytes, reads * 128 * 8)
    assert by == "bytes" and reads > F * L    # some lines ran more trials
    assert n_bytes < px.numel() + F * L * 49  # less than every whole row


def test_group_wrapper_matches_pallas_interpret():
    """K2's wrapper (one group of lines sharing coordinates, per-line
    levels) on a CPU tensor runs its plain version; it equals the Pallas
    kernel K2 (interpreter on CPU) on every field of all 300 lines at
    NORMAL, the ragged last tile and clipping levels included."""
    L, W = 300, 1152
    rng = np.random.default_rng(13)
    pixels, coords, *_ = jenc.encode_stream(
        rng.integers(0, 1 << 14, 3 * L), rng.integers(0, 1 << 14, 3 * L),
        width=W, ppb=8.0, n_lines=L, noise_sigma=30.0, rng=rng)
    ref, black, white = (a[0] for a in levels(1, L, True, seed=14))
    cd = (int(coords[0, 0]), int(coords[0, 1]))
    expect = jpb.stc007_fused_decode(
        jnp.asarray(pixels), cd, jnp.asarray(ref), jnp.asarray(black),
        jnp.asarray(white), 4, 2, tile_lines=32)
    before = fb.stc007_fused_decode.launches
    got = fb.stc007_fused_decode(
        torch.from_numpy(pixels), (torch.tensor(cd[0]), torch.tensor(cd[1])),
        torch.from_numpy(ref), torch.from_numpy(black),
        torch.from_numpy(white), 4, 2, tile_lines=32)
    assert fb.stc007_fused_decode.launches == before  # no kernel
    assert_batch(got, expect)
    valid = got.valid.numpy()
    assert 0 < valid.sum() < L
    assert got.hyst.max() > 0 or got.shift.max() > 0


def test_fused_wrapper_refuses_other_devices():
    """No quiet fallback: a tensor that is neither on the CPU nor on a
    CUDA device is refused, not decoded by the plain version."""
    px = torch.zeros((1, 4, 1152), dtype=torch.uint8, device="meta")
    lv = torch.zeros((1,), dtype=torch.int32)
    with pytest.raises(ValueError, match="unsupported device"):
        fb.stc007_fused_decode_frames(px, torch.zeros((1, 2)), lv, lv, lv)
    lv4 = torch.zeros((4,), dtype=torch.int32)
    with pytest.raises(ValueError, match="unsupported device"):
        fb.stc007_fused_decode(px[0], (40, 1100), lv4, lv4, lv4)


def test_tables_equal_jax():
    """The binarizer's constant tables equal the JAX package's arrays."""
    table, const = bz._syndrome_const()
    jtable, jconst = jbz._syndrome_const()
    assert const == jconst
    np.testing.assert_array_equal(table, jtable)
    assert table.dtype == np.int32
    ptable, pconst = jpb._synd_table()
    assert pconst == const
    np.testing.assert_array_equal(table, ptable.astype(np.int32))
    np.testing.assert_array_equal(bz._pack_weights(),
                                  jpb._pack_weights().astype(np.int32))
