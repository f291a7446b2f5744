"""The capture generators repeat by seed, and the plain references
decode a clean capture to the samples it was made from."""
import filecmp

import numpy as np
import pytest
import torch

from bench_port import cells, media as sg, pool

CONFIGS = ("stc007_pal_normal", "pcm16x0_si_normal")


def config(name):
    return cells.load_json(cells.HERE / "configs" / f"{name}.json")


@pytest.mark.parametrize("name", CONFIGS)
def test_pool_repeats_byte_for_byte_by_seed(name, tmp_path):
    cfg = config(name)
    fmt = cells.format_module(cfg["format"])
    traffic = dict(pool=2, captures_per_run=2, frames=[2, 3],
                   warm_frames=1, noise_sigma=10.0, burst_every=2,
                   burst_lines=[4, 8], burst_levels=[5, 60])
    made = []
    for k, seed in enumerate((2 ** 31 + 11, 2 ** 31 + 11, 2 ** 31 + 12)):
        d = tmp_path / str(k)
        d.mkdir()
        caps, warm = pool.make_pool(cfg, traffic, fmt, seed, "cpu", d)
        made.append(caps + [warm])
    for a, b in zip(made[0], made[1]):
        assert filecmp.cmp(a.path, b.path, shallow=False)
        assert a.bursts == b.bursts
    assert not all(filecmp.cmp(a.path, c.path, shallow=False)
                   for a, c in zip(made[0], made[2]))


def test_sizes_are_the_same_for_every_seed():
    lens = pool.sizes(32, 256, 8)
    assert lens.min() >= 32 and lens.max() <= 256
    assert np.all(np.diff(lens) > 0)
    # Log-uniform: the strata's lengths grow by a near-constant factor.
    ratio = lens[1:] / lens[:-1]
    assert ratio.max() / ratio.min() < 1.2


@pytest.mark.parametrize("seed", [1, 2 ** 31 + 7])
def test_every_run_takes_one_capture_of_each_stratum(seed):
    runs = pool.runs(seed, 16, 8)
    seen = []
    for _ in range(6):
        run = next(runs)
        assert sorted(i % 8 for i in run) == list(range(8))
        seen += run
    assert set(seen) == set(range(16))


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 9])
def test_a_pool_smaller_than_a_run_is_read_by_equal_numbers_of_jobs(seed):
    """tapes8's shape: 8 jobs a run over a pool of 2 captures of one
    length, each capture 4 times in every run."""
    assert list(pool.sizes(800, 800, 2)) == [800, 800]
    runs = pool.runs(seed, 2, 8)
    orders = set()
    for _ in range(5):
        run = next(runs)
        assert sorted(run) == [0] * 4 + [1] * 4
        orders.add(tuple(run))
    assert len(orders) > 1
    with pytest.raises(ValueError):
        next(pool.runs(seed, 3, 8))


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_decodes_a_clean_capture_to_its_samples(name):
    cfg = config(name)
    fmt = cells.format_module(cfg["format"])
    rng = np.random.default_rng(5)
    frames, truth = fmt.make_capture(cfg, 2, rng,
                                     torch.Generator().manual_seed(5), "cpu")
    ref, valid, intact = fmt.reference(cfg, frames)
    want = fmt.truth(truth)
    assert ref.shape == want.shape
    assert valid.mean() > 0.95     # the last 112 lines hold partial blocks
    np.testing.assert_array_equal(ref[valid.all(1)], want[valid.all(1)])
    assert (intact <= valid).all()


def test_reference_restores_erased_stc007_words_by_p_and_q():
    cfg = config("stc007_pal_normal")
    fmt = cells.format_module("stc007")
    rng = np.random.default_rng(9)
    frames, truth = fmt.make_capture(cfg, 2, rng,
                                     torch.Generator().manual_seed(9), "cpu")
    # Blank stream lines 300 and 316 (field 2 of frame 0: rows 13, 45):
    # blocks with words on both lose two, P and Q restore them.
    frames = frames.copy()
    frames[0, 13] = 20
    frames[0, 45] = 20
    ref, valid, intact = fmt.reference(cfg, frames)
    want = fmt.truth(truth)
    n = len(want) - 3 * 112            # the blocks the capture holds whole
    assert valid[:n].all()
    assert not intact[:n].all()
    np.testing.assert_array_equal(ref[:n], want[:n])


def test_reference_restores_an_erased_pcm16x0_word_by_p():
    cfg = config("pcm16x0_si_normal")
    fmt = cells.format_module("pcm16x0")
    rng = np.random.default_rng(3)
    frames, truth = fmt.make_capture(cfg, 1, rng,
                                     torch.Generator().manual_seed(3), "cpu")
    frames = frames.copy()
    frames[0, 10] = 20                 # field 1, line 5: three sublines
    ref, valid, intact = fmt.reference(cfg, frames)
    assert valid.all() and not intact.all()
    np.testing.assert_array_equal(ref, fmt.truth(truth))


def test_y4m_and_wav_round_trip(tmp_path):
    from bench_port import harness
    frames = np.arange(2 * 4 * 32, dtype=np.uint8).reshape(2, 4, 32)
    sg.write_y4m(tmp_path / "a.y4m", frames)
    np.testing.assert_array_equal(sg.read_y4m(tmp_path / "a.y4m"), frames)
    s = np.array([[1, -2], [32767, -32768]], np.int16)
    harness.write_wav(tmp_path / "a.wav", s, 44056)
    got, rate, ch, bits = sg.read_wav(tmp_path / "a.wav")
    assert (rate, ch, bits) == (44056, 2, 16)
    np.testing.assert_array_equal(got, s)
    assert sg.read_wav(tmp_path / "missing.wav") is None


def test_crc16_matches_a_bit_serial_register():
    rng = np.random.default_rng(1)
    bits = rng.integers(0, 2, (20, 112)).astype(np.uint8)
    for row, got in zip(bits, sg.crc16(bits)):
        c = 0xFFFF
        for b in row:
            msb = (c >> 15) & 1
            c = (c << 1) & 0xFFFF
            if msb != b:
                c ^= 0x1021
        assert got == c
