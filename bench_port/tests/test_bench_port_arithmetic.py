"""The metric arithmetic the benchmark freezes: rate over the window,
the K1 byte count, the busy union and the comparison."""
import numpy as np

import pytest

from bench_port import cells, harness, stats, tracing
from bench_port.formats import stc007


class Rec(harness.Record):
    pass


def test_rate_over_a_window_with_a_stalled_run():
    # Three driver runs of 6,400 frames: the second stalls 4 s; the rate
    # is over the whole window, the stall included.
    rec = Rec(frames=3 * 6400, window_s=7.0 + 11.0 + 7.0)
    assert cells.metric_reader("frames_per_s")(rec) == 19200 / 25.0
    assert stats.rate(19200, 25.0) == 768.0


def test_k1_bytes_of_a_16_frame_round_by_hand():
    cfg = cells.load_json(cells.HERE / "configs" / "stc007_pal_normal.json")
    # Coordinates 40..1096, 1024 / 128 px a bit: bit b (3..130) sampled
    # at 8 b + 44, columns 68..1084, sectors 2..33: 32 sectors = 1024 B a
    # line, + 49 B written; + 20 B of coordinates and levels a frame.
    assert stc007.k1_columns(40, 1096, 1152).min() == 68
    assert stc007.k1_columns(40, 1096, 1152).max() == 1084
    assert stc007.k1_round_bytes(cfg, 16) == 16 * (588 * (1024 + 49) + 20)
    assert stc007.k1_round_bytes(cfg, 16) == 10_095_104


def test_round_frames_follow_the_rounds_of_each_capture():
    assert harness.round_frames([32, 37, 5], 16) == [16, 16, 16, 16, 5, 5]


def test_busy_union_and_gaps_on_synthetic_rows():
    iv = [(10, 20), (15, 30), (40, 50), (45, 46), (95, 120)]
    assert stats.union_seconds(iv, 0, 100) == 20 + 10 + 5
    assert stats.gaps(iv, 0, 100) == [(0, 10), (30, 40), (50, 95)]
    assert stats.union_seconds([], 0, 100) == 0
    assert stats.gaps([], 0, 100) == [(0, 100)]


def test_trace_reduction_counts_k1_and_labels_idle_gaps():
    t0 = 1_000
    off = 5_000_000           # profiler clock minus host clock
    rows = [("cudaDeviceSynchronize", "runtime", t0 + off, t0 + off + 10),
            ("stc007_binarize_frames_kernel", "kernel", t0 + off + 100,
             t0 + off + 300),
            ("Memcpy DtoH", "copy", t0 + off + 250, t0 + off + 400),
            ("stc007_binarize_frames_kernel", "kernel", t0 + off + 700,
             t0 + off + 800),
            ("other", "kernel", t0 + off + 900, t0 + off + 1000)]
    spans = [("visit", t0 + 0, t0 + 1000), ("dispatch", t0 + 50, t0 + 450),
             ("prescan", t0 + 60, t0 + 80), ("stitch", t0 + 450, t0 + 890)]
    r = tracing.reduce(rows, t0, t0 + 1000, spans)
    assert r["aligned"]
    assert r["window_s"] == 1000 / 1e9
    assert r["busy_s"] == (300 + 100 + 100) / 1e9
    assert r["k1_rows"] == 2 and r["k1_s"] == 300 / 1e9
    assert r["ops"][0] == ["stc007_binarize_frames_kernel", 300 / 1e9]
    gaps = dict(r["gaps"])
    # 0..100 opens in no stage but the visit; 400..700 in the stitch (it
    # starts at 450, the gap at 400 is the dispatch's); 800..900 stitch.
    assert gaps == {"visit": 100 / 1e9, "dispatch": 300 / 1e9,
                    "stitch": 100 / 1e9}


def test_labels_pick_the_innermost_open_span():
    spans = [("run", 0, 100), ("a", 10, 50), ("b", 20, 30), ("c", 60, 70)]
    assert tracing.labels_at(spans, [5, 15, 25, 35, 65, 80, 150]) == [
        "run", "a", "b", "a", "c", "run", "harness"]


def test_a_lost_trace_leaves_the_device_metrics_out():
    rec = Rec(trace=dict(lost=True, window_s=1.0, busy_s=0.5, k1_s=0.1,
                         k1_launches=3, rounds=3, round_frames=[16] * 3))
    assert cells.metric_reader("device_idle_share")(rec) is None
    assert cells.metric_reader("k1_roofline")(rec) is None
    rec.trace["lost"] = False
    assert cells.metric_reader("device_idle_share")(rec) == 0.5


@pytest.mark.parametrize("launches", [3, 4])
def test_k1_roofline_needs_one_launch_a_round(launches):
    cell = cells.Cell(cells.benchmark(), "stc007_pal_normal.tapes8")
    rec = Rec(cell=cell, trace=dict(
        lost=False, window_s=1.0, busy_s=0.5, k1_s=3 * 0.01e-3,
        k1_launches=launches, rounds=3, round_frames=[16] * 3))
    got = cells.metric_reader("k1_roofline")(rec)
    if launches != 3:
        assert got is None
    else:
        want = 100 * 3 * 10_095_104 / 3.35e12 / (3 * 0.01e-3)
        assert got == pytest.approx(want)


def test_judge_aligns_and_counts_wrong_and_missing_words():
    from bench_port import compare
    rng = np.random.default_rng(0)
    ref = rng.integers(-2 ** 15, 2 ** 15, (5000, 2)).astype(np.int16)
    valid = np.ones_like(ref, bool)
    valid[100:110, 1] = False
    intact = valid.copy()
    intact[200:300] = False
    wav = np.concatenate([np.zeros((15, 2), np.int16), ref[:4990]])
    wav[15 + 250, 0] += 1                      # one word wrong, not intact
    wav[15 + 4000, 1] += 1                     # one word wrong, intact
    v = compare.judge(wav, ref, valid, intact, ref)
    assert v["offset"] == 15
    assert v["valid"] == 10000 - 10 and v["intact"] == 10000 - 10 - 200
    # 2 altered + the 10 samples (20 words) past the WAV's end.
    assert v["wrong"] == 22 and v["wrong_intact"] == 21
    # The short dropout holds its true samples: masked, not wrong.
    assert v["masked"] == 10 and v["wrong_masked"] == 0
    none = compare.judge(None, ref, valid, intact, ref)
    assert none["wrong"] == none["valid"] and none["offset"] is None
    assert none["wrong_masked"] == 10


def test_judge_takes_the_interpolation_or_the_true_sample_in_a_dropout():
    from bench_port import compare
    ref = (np.arange(400, dtype=np.int16) * 10)[:, None].repeat(2, 1)
    valid = np.ones_like(ref, bool)
    valid[100:104, 0] = False
    true = ref.copy()
    true[100:104, 0] = 7
    intact = valid.copy()
    wav = ref.copy()                           # interpolated: 990 .. 1030
    assert compare.judge(wav, ref, valid, intact, true)["wrong_masked"] == 0
    wav[100:104, 0] = 7                        # the true samples
    assert compare.judge(wav, ref, valid, intact, true)["wrong_masked"] == 0
    wav[101, 0] = 0                            # neither
    assert compare.judge(wav, ref, valid, intact, true)["wrong_masked"] == 1


def test_interpolation_by_hand_and_what_it_leaves_out():
    from bench_port import compare
    ref = np.zeros((200, 2), np.int16)
    ref[39, 0], ref[43, 0] = 100, -101         # anchors of [40, 43)
    valid = np.ones_like(ref, bool)
    valid[40:43, 0] = False
    valid[0:5, 1] = False                      # leading: muted, not here
    valid[100:117, 1] = False                  # 17 words: a long dropout
    valid[130:132, 1] = False                  # short, but 28 > 130 - 117
    exp, masked = compare.interpolated(ref, valid)
    # step = round(-201 * 16 / 4) = -804; 1600 + k step = 796, -8, -812,
    # / 16 rounded half away from zero.
    assert list(exp[40:43, 0]) == [50, -1, -51]
    assert masked.sum() == 3 and masked[40:43, 0].all()


@pytest.mark.parametrize("seed", range(4))
def test_interpolation_agrees_with_the_ports_word_masking(seed):
    """The plain interpolation against the port's AudioProcessor on the
    dropouts it compares (the test may import the port; the reference
    does not)."""
    from bench_port import compare
    from sdvpcmdecoder_tpu_torch.pipeline import audio
    rng = np.random.default_rng(seed)
    n = 4000
    ref = rng.integers(-2 ** 15, 2 ** 15, (n, 2)).astype(np.int16)
    valid = np.ones_like(ref, bool)
    for _ in range(60):
        a = int(rng.integers(0, n - 40))
        valid[a:a + int(rng.integers(1, 40)), int(rng.integers(2))] = False
    exp, masked = compare.interpolated(ref, valid)
    got = audio.AudioProcessor(audio.DROP_INTER_LIN_WORD).process(
        ref, valid.copy(), file_end=True)
    assert masked.sum() > 50
    np.testing.assert_array_equal(got[masked], exp[masked])
