"""Port checks: deinterleave + P/Q erasure correction of
sdvpcmdecoder_tpu_torch against the JAX package's jnp branch, exactly, and
a reduced rerun of the reference's randomized ECC property test
(tests/test_ecc_stc007.py, pcmtester.cpp:110-371) through the port.
"""
import itertools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from sdvpcmdecoder_tpu.ops import deinterleave as jdi
from sdvpcmdecoder_tpu_torch.formats import stc007
from sdvpcmdecoder_tpu_torch.ops import deinterleave as di
from sdvpcmdecoder_tpu_torch.synth import encoder as enc

torch.set_num_threads(1)


def assert_same(got, expect, what=""):
    expect = np.asarray(expect)
    got = got.cpu().numpy()
    assert got.dtype == expect.dtype, f"{what}: {got.dtype} != {expect.dtype}"
    np.testing.assert_array_equal(got, expect, err_msg=what)


def assert_blocks(got, expect):
    for name in got._fields:
        assert_same(getattr(got, name), getattr(expect, name), name)


def damaged_blocks(n_blocks, resolution, seed):
    """Coded blocks with 0..3 corrupted words, most of them CRC-marked and
    some corrupted silently (the BROKEN path). Returns (words [B,8] int32,
    crc_ok [B,8] bool)."""
    rng = np.random.default_rng(seed)
    if resolution == di.RES_14BIT:
        left, right = rng.integers(0, 1 << 14, (2, 3 * n_blocks))
        words = enc.samples_to_blocks(left, right)
        mask = stc007.DATA_WORD_MASK
    else:
        left, right = rng.integers(0, 1 << 16, (2, 3 * n_blocks))
        words = enc.samples_to_blocks16(left, right)
        mask = 0xFFFF
    crc_ok = np.ones((n_blocks, 8), dtype=bool)
    for b in range(n_blocks):
        k = rng.integers(0, 4)
        for w in rng.permutation(8)[:k]:
            words[b, w] ^= int(rng.integers(1, mask + 1))
            crc_ok[b, w] = rng.random() < 0.1          # silent corruption
        if rng.random() < 0.05:                        # false CRC alarm
            crc_ok[b, rng.integers(0, 8)] = False
    return words.astype(np.int32), crc_ok


def both(fn_port, fn_jax, words, crc_ok, *args, **kw):
    return (fn_port(torch.from_numpy(words), torch.from_numpy(crc_ok),
                    *args, **kw),
            fn_jax(jnp.asarray(words), jnp.asarray(crc_ok), *args, **kw))


@pytest.mark.parametrize("en_p,en_q", list(itertools.product([True, False],
                                                              repeat=2)))
@pytest.mark.parametrize("resolution", [di.RES_14BIT, di.RES_16BIT])
def test_correct_blocks_matches_jax(resolution, en_p, en_q):
    words, crc_ok = damaged_blocks(600, resolution, seed=resolution)
    got, expect = both(di.correct_blocks, jdi.correct_blocks, words, crc_ok,
                       resolution, en_p, en_q)
    assert_blocks(got, expect)
    states = set(got.audio_state.tolist())
    if resolution == di.RES_14BIT and en_p and en_q:
        assert states == {di.AUD_ORIG, di.AUD_FIX_P, di.AUD_FIX_Q,
                          di.AUD_BROKEN}


def test_correct_blocks_no_forced_check_matches_jax():
    words, crc_ok = damaged_blocks(300, di.RES_14BIT, seed=5)
    got, expect = both(di.correct_blocks, jdi.correct_blocks, words, crc_ok,
                       di.RES_14BIT, force_ecc=False)
    assert_blocks(got, expect)


def test_correct_blocks_with_module_banks():
    """Passing the stacked Q banks as int32 tensors (StreamDecoder's
    buffers) gives the same result as building them per call."""
    words, crc_ok = damaged_blocks(200, di.RES_14BIT, seed=6)
    banks = tuple(torch.as_tensor(m, dtype=torch.int32)
                  for m in di._q_solve_banks_stacked())
    w, c = torch.from_numpy(words), torch.from_numpy(crc_ok)
    assert_blocks(di.correct_blocks(w, c, di.RES_14BIT, q_banks=banks),
                  di.correct_blocks(w, c, di.RES_14BIT))


def test_parity_helpers_match_jax():
    words, crc_ok = damaged_blocks(100, di.RES_14BIT, seed=7)
    w, jw = torch.from_numpy(words), jnp.asarray(words)
    assert_same(di._calc_p(w), jdi._calc_p(jw), "P")
    assert_same(di._calc_q(w), jdi._calc_q(jw), "Q")
    for g, e in zip(di._first_two_bad(torch.from_numpy(crc_ok)),
                    jdi._first_two_bad(jnp.asarray(crc_ok))):
        assert_same(g, e, "first/second bad")


def line_buffer(n_lines, seed):
    rng = np.random.default_rng(seed)
    left, right = rng.integers(0, 1 << 14, (2, 3 * n_lines))
    line_words, _ = enc.blocks_to_lines(enc.samples_to_blocks(left, right),
                                        n_lines)
    crc_ok = np.repeat(rng.random((n_lines, 1)) > 0.08, 8, axis=1)
    return line_words.astype(np.int32), crc_ok


@pytest.mark.parametrize("resolution", [di.RES_14BIT, di.RES_16BIT])
def test_assemble_blocks_match_jax(resolution):
    lw, ck = line_buffer(300, seed=8)
    shifts = np.arange(0, 300 - 112, 2, dtype=np.int32)
    got, expect = both(di.assemble_blocks, jdi.assemble_blocks, lw, ck,
                       shifts, resolution)
    for g, e in zip(got, expect):
        assert_same(g, e)
    got, expect = both(di.assemble_blocks_contiguous,
                       jdi.assemble_blocks_contiguous, lw, ck, 188,
                       resolution)
    for g, e in zip(got, expect):
        assert_same(g, e)


@pytest.mark.parametrize("resolution", [di.RES_14BIT, di.RES_16BIT])
def test_assemble_blocks_past_the_buffer_match_jax(resolution):
    """Shifts whose taps run past either end of the buffer read the rows
    XLA's gather clamps to (a negative index counts from the end first);
    torch would raise, or assert on the device, without the clamp."""
    lw, ck = line_buffer(200, seed=10)
    shifts = np.array([0, 60, 87, 88, 120, 199, 200, 260, 5000, -1, -17,
                       -300], dtype=np.int32)
    got, expect = both(di.assemble_blocks, jdi.assemble_blocks, lw, ck,
                       shifts, resolution)
    for g, e in zip(got, expect):
        assert_same(g, e)


@pytest.mark.parametrize("res_mode", [di.RES_MODE_14BIT,
                                      di.RES_MODE_14BIT_AUTO,
                                      di.RES_MODE_16BIT_AUTO,
                                      di.RES_MODE_16BIT])
def test_deinterleave_and_samples_match_jax(res_mode):
    lw, ck = line_buffer(260, seed=9)
    for shifts in (np.arange(148, dtype=np.int32),      # contiguous slices
                   np.arange(1, 148, dtype=np.int32)):  # gather
        got, expect = both(di.deinterleave, jdi.deinterleave, lw, ck, shifts,
                           res_mode=res_mode)
        assert_blocks(got, expect)
        for m2 in (False, True):
            assert_same(di.block_samples(got, m2=m2),
                        jdi.block_samples(expect, m2=m2), f"m2={m2}")


# ---- reduced rerun of the reference's ECC property test -------------------

GOLD_WORDS = np.array([0x3B43, 0x3FDB, 0x3B52, 0x3FDA, 0x3B5F, 0x3FDA,
                       0x0495, 0x1DB7], dtype=np.int64)  # pcmtester.cpp:119
LINES_PER_TRIAL = stc007.MIN_DEINT_DATA + 1  # 113


@pytest.mark.parametrize("kill_mode", ["one", "two", "any"])
def test_stc007_ecc_randomized(kill_mode):
    rng = np.random.default_rng({"one": 1, "two": 2, "any": 3}[kill_mode])
    T = 256
    n_corrupt = {"one": np.ones(T, np.int64), "two": np.full(T, 2),
                 "any": rng.integers(0, 9, T)}[kill_mode]
    line_words = np.tile(GOLD_WORDS, (T * LINES_PER_TRIAL, 1))
    crc_ok = np.ones((T * LINES_PER_TRIAL, 8), dtype=bool)
    masks = np.zeros((T, 8), dtype=np.int64)
    for t in range(T):
        for w in rng.permutation(8)[:n_corrupt[t]]:
            masks[t, w] = int(rng.integers(1, stc007.DATA_WORD_MASK + 1))
            row = t * LINES_PER_TRIAL + w * stc007.INTERLEAVE_OFS
            line_words[row, w] ^= masks[t, w]
            crc_ok[row, w] = False
    batch = di.deinterleave(
        torch.from_numpy(line_words.astype(np.int32)),
        torch.from_numpy(crc_ok),
        torch.arange(T, dtype=torch.int32) * LINES_PER_TRIAL,
        res_mode=di.RES_MODE_14BIT)
    words = batch.words.numpy()
    block_valid = batch.valid[:, :6].all(dim=1).numpy()
    state = batch.audio_state.numpy()
    fixed = (state == di.AUD_FIX_P) | (state == di.AUD_FIX_Q)
    for t in range(T):
        k = int(n_corrupt[t])
        tag = f"trial {t} k={k} masks={masks[t]}"
        if k == 0:
            assert block_valid[t] and not fixed[t], tag
            assert state[t] != di.AUD_BROKEN, tag
            np.testing.assert_array_equal(words[t], GOLD_WORDS, tag)
        elif k <= 2:
            assert block_valid[t], tag
            for w in np.nonzero(masks[t])[0]:
                assert words[t, w] == GOLD_WORDS[w], tag
        else:
            assert not block_valid[t], tag
