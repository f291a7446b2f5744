"""The benchmark's PCM-16x0 configuration on the CPU (bench_port/configs/
pcm16x0_si_normal.json): DevicePCMBatchDecoder built from the
configuration's `decoder` against the plain reference
(bench_port/formats/pcm16x0) on small seeded captures: a subline read
with a bad CRC restored by P, a sub-block with two erasures interpolated,
the sweep's span and counters and the refined-line counter against what
they count, the coordinate sweep that reads all three sublines (its
locks on clean captures, its native grid against the Python one, PCM-1's
locks unchanged). The cases PCM-16x0 shares with PCM-1 (a clean capture
bit-exact, a sound and a traced run, the control, a run without JAX) are
tests/test_torch_pcm1_bench.py's, parametrised over both cells.
"""
import numpy as np
import pytest
import torch

from bench_port import cells, compare, harness, media as sg
from bench_port.tests.helpers import small_cell
from sdvpcmdecoder_tpu_torch.ops import line_decode_np as ld
from sdvpcmdecoder_tpu_torch.ops import stitch_native as sn
from sdvpcmdecoder_tpu_torch.pipeline import ingest
from sdvpcmdecoder_tpu_torch.pipeline import v2d_other as tv

torch.set_num_threads(1)

CELL = "pcm16x0_si_normal.tapes8"
CFG = cells.load_json(cells.HERE / "configs" / "pcm16x0_si_normal.json")
FMT = cells.format_module("pcm16x0")
SIG = CFG["signal"]
# The encoder's coordinates: data from start_px, 193 bits of ppb pixels.
TRUE = (SIG["start_px"], SIG["start_px"] + 193 * int(SIG["ppb"]))
PAIRS = 2 * 735           # a frame's pairs, both fields


def capture(n_frames, seed, tag=None, noise=0.0):
    rng = sg.rng_for(seed, 2, tag) if tag is not None \
        else np.random.default_rng(seed)
    gen = torch.Generator().manual_seed(seed) if noise else None
    return FMT.make_capture(CFG, n_frames, rng, gen, "cpu", noise=noise)


def decode(tmp_path, frames, **over):
    """The configuration's decoder, as the harness builds it, on the CPU
    over one capture: (its WAV's samples, the decoder)."""
    path = str(tmp_path / "c.y4m")
    sg.write_y4m(path, frames)
    cls, kw = harness.driver(CFG, "cpu")
    dec = cls([(path, path + ".wav")], **dict(kw, **over))
    dec.run()
    return sg.read_wav(path + ".wav")[0], dec


def flip_subline(frames, frame, sub, bits=range(5, 10)):
    """Invert some bit cells of field 1's subline `sub` of `frame` (line
    sub // 3, part sub % 3; field 1 on the even rows)."""
    line, part = divmod(sub, 3)
    first = ld.PCM16X0_PART_START[part]
    row = frames[frame, 2 * line]
    ppb = int(SIG["ppb"])
    for b in bits:
        x = SIG["start_px"] + (first + b) * ppb
        row[x:x + ppb] = SIG["black"] + SIG["white"] - row[x:x + ppb]


# An SI block of group 2, order 4: sublines 214, 249, 284 (the first and
# last carry L and R, the middle one P).
BLOCK = (214, 249, 284)


def test_a_subline_with_flipped_bits_is_restored_by_p(tmp_path):
    """One subline read with a bad CRC: the three words it carries, one in
    each sub-block of its block, are restored by P; the WAV is the
    capture's samples throughout."""
    frames, t = capture(3, 31)
    frames = frames.copy()
    flip_subline(frames, 1, BLOCK[0])
    _, ok = FMT.read_sublines(CFG, np.concatenate([frames[:, 0::2],
                                                   frames[:, 1::2]], 1)
                              .reshape(-1, frames.shape[2]))
    assert (~ok).sum() == 1
    ref, valid, intact = FMT.reference(CFG, frames)
    assert valid.all() and (~intact.all(1)).sum() == 3
    got, _ = decode(tmp_path, frames)
    np.testing.assert_array_equal(got, FMT.truth(t))


def test_a_sub_block_with_two_erasures_is_interpolated(tmp_path):
    """The block's L and R sublines both read with a bad CRC: each of its
    three sub-blocks has two words erased, which P cannot restore; the
    reference leaves those three pairs invalid and the WAV holds, in
    each, its word-scope interpolation, and the capture's samples
    elsewhere."""
    frames, t = capture(3, 32)
    frames = frames.copy()
    flip_subline(frames, 1, BLOCK[0])
    flip_subline(frames, 1, BLOCK[2])
    ref, valid, intact = FMT.reference(CFG, frames)
    bad = np.nonzero(~valid.all(1))[0]
    assert len(bad) == 3 and (~valid).sum() == 6
    assert (bad // PAIRS == 1).all() and np.ptp(bad) == 2
    got, _ = decode(tmp_path, frames)
    ok = valid.all(1)
    np.testing.assert_array_equal(got[ok], FMT.truth(t)[ok])
    v = compare.judge(got, ref, valid, intact, FMT.truth(t))
    assert v["masked"] == 6 and v["wrong_masked"] == 0 and v["wrong"] == 0
    assert (got[bad] != FMT.truth(t)[bad]).any()


def record(dec, frames):
    rec = harness.Record(cell=small_cell(CELL))
    rec.stage_t = dict(dec.stage_t)
    rec.frames = frames
    return rec


@pytest.mark.parametrize("noise", [0.0, 30.0], ids=["clean", "noisy"])
def test_the_counters_count_what_they_name(noise, tmp_path, monkeypatch):
    """`count_pcm_coord_searches` is the frames whose coordinates came
    from a sweep (PCMFrameDriver._sweep's calls), `pcm_coord_search` lies
    inside `pcm_agc`, and `count_pcm_refined_lines` is the sublines passed
    to the refinement (what ld.refine_failed_lines was handed); the
    readers divide them by the frames and the sublines decoded."""
    swept, handed = [], []
    sweep, refine = tv.PCMFrameDriver._sweep, ld.refine_failed_lines

    def spy_sweep(self, *a, **kw):
        swept.append(1)
        return sweep(self, *a, **kw)

    def spy_refine(lines, valid, *a, **kw):
        handed.append(int((~np.asarray(valid, bool)).sum()))
        return refine(lines, valid, *a, **kw)

    monkeypatch.setattr(tv.PCMFrameDriver, "_sweep", spy_sweep)
    monkeypatch.setattr(ld, "refine_failed_lines", spy_refine)
    frames, _ = capture(4, 33, noise=noise)
    _, dec = decode(tmp_path, frames)
    t = dec.stage_t
    assert t["count_pcm_coord_searches"] == len(swept) >= 1
    assert 0 < t["pcm_coord_search"] <= t["pcm_agc"]
    assert t.get("count_pcm_refined_lines", 0) == sum(handed)
    assert (sum(handed) > 0) == (noise > 0)
    rec = record(dec, 4)
    read = {m: cells.metric_reader(m)(rec) for m in (
        "pcm_coord_search_share", "pcm_coord_search_ms_per_frame",
        "pcm_refined_line_share")}
    assert read == pytest.approx(dict(
        pcm_coord_search_share=len(swept) / 4,
        pcm_coord_search_ms_per_frame=1e3 * t["pcm_coord_search"] / 4,
        pcm_refined_line_share=sum(handed) / (4 * 490 * 3)))


@pytest.mark.parametrize("tag", range(8))
def test_clean_captures_lock_at_the_encoders_coordinates(tag):
    """The sample lines of bench_port's seed 2, pool tags 0-7 (16 clean
    frames each), lock within a pixel of the encoder's (32, 1383): the
    sweep reads all three sublines, then a pixel apart about its pick."""
    frames, _ = capture(16, 2, tag)
    perm, _ = ingest.field_perm(frames.shape[1])
    drv = tv.PCMFrameDriver("pcm16x0", shift_limit=2, hyst_limit=4,
                            backend="native", device="cpu")
    prep = drv.prepare_frames(frames, perm=perm)
    assert prep["usable"].all()
    off = np.abs(prep["coords"] - np.array(TRUE)).max()
    assert off <= 1, prep["coords"]


@pytest.mark.parametrize("tag", range(4))
def test_pcm1_locks_are_the_jax_packages(tag):
    """PCM-1 reads one part: its sweep, and so its locks, stay the JAX
    package's on bench_port's PCM-1 captures (seed 2, tags 0-3)."""
    from sdvpcmdecoder_tpu.pipeline import v2d_other as jv
    cfg = cells.load_json(cells.HERE / "configs" / "pcm1_ntsc_normal.json")
    frames, _ = cells.format_module("pcm1").make_capture(
        cfg, 16, sg.rng_for(2, 2, tag), None, "cpu")
    perm, _ = ingest.field_perm(frames.shape[1])
    got = []
    for cls, extra in ((jv.PCMFrameDriver, {}),
                       (tv.PCMFrameDriver, dict(device="cpu"))):
        drv = cls("pcm1", shift_limit=2, hyst_limit=4, backend="native",
                  **extra)
        prep = drv.prepare_frames(frames, perm=perm)
        got.append((prep["coords"].tolist(), prep["usable"].tolist(),
                    [tuple(c) for c in drv.coord_history]))
    assert got[0] == got[1]


def test_the_all_parts_sweep_natively_is_the_python_grid(monkeypatch):
    """ld.search_coordinates(part=ALL_PARTS) through the native core and
    through its Python grid: the same entry, on a clean line, a noisy one,
    and a narrow sweep about a history."""
    frames, _ = capture(1, 34)
    noisy, _ = capture(1, 35, noise=20.0)
    cases = [(frames[0, 40], {}), (noisy[0, 41], {}),
             (frames[0, 300], dict(history=(35, 1380), max_ofs=3))]
    for line, kw in cases:
        args = (line, 110, SIG["black"], SIG["white"], SIG["width"])
        kw = dict(kw, fmt="pcm16x0", part=ld.ALL_PARTS)
        with monkeypatch.context() as m:
            nat = ld.search_coordinates(*args, **kw)
            m.setattr(sn, "available", lambda: False)
            py = ld.search_coordinates(*args, **kw)
        assert nat == py, kw
    assert ld.search_coordinates(frames[0, 40], 110, SIG["black"],
                                 SIG["white"], SIG["width"], fmt="pcm16x0",
                                 part=ld.ALL_PARTS)["stop"] == TRUE[1]


def test_the_jax_packages_wrong_words_are_erasures_of_a_lock_off(tmp_path):
    """bench_port's PCM-16x0 seed 2, pool tag 2 at the `tapes8_short`
    length (12 clean frames): the JAX package's driver locks a step off,
    at (30, 1389), and 6 words of its WAV are not the capture's samples.
    Each is the mean of its neighbours in the WAV: a word the decoder
    could not read and interpolated, not one read wrong under a matching
    CRC-16. The port's sweep locks true and its WAV is the capture's
    samples."""
    from sdvpcmdecoder_tpu.pipeline import device_pcm as jdp
    frames, t = capture(12, 2, 2)
    path = str(tmp_path / "c.y4m")
    sg.write_y4m(path, frames)
    jdec = jdp.DevicePCMBatchDecoder(
        [(path, path + ".jax.wav")], fmt="pcm16x0", hyst_limit=4,
        shift_limit=2, frames_per_round=16, refine=True)
    jdec.run()
    assert tuple(jdec.jobs[0].driver.coord_history[-1]) == (30, 1389)
    jax = sg.read_wav(path + ".jax.wav")[0].astype(np.int64)
    true = FMT.truth(t)
    bad = np.argwhere(jax != true)
    assert len(bad) == 6
    for i, c in bad:
        assert abs(2 * jax[i, c] - jax[i - 1, c] - jax[i + 1, c]) <= 2
    got, dec = decode(tmp_path, frames)
    np.testing.assert_array_equal(got, true)
    assert dec.fetched_frames == 0
