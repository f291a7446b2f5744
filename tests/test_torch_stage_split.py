"""The chip-resident drivers split each staged chunk into fields on the
device: StagedDeviceDecoder._stage_chunk reads the frames into the job's
staging buffer, uploads them as read and gathers the field-sequential
rows there. On the CPU, every chunk's `px_dev` and `nums` must equal
ingest.split_fields_batch of the same frames, byte for byte and dtype for
dtype (even and odd heights, a narrow frame doubled, a short last chunk
after full ones, a timeline with a dropped frame in the first chunk and
in a later one, where the reused buffer held a frame), and a driver run
never calls split_fields_batch and writes the same WAV. The readers fill
a caller's buffer as they fill a fresh one, and a job's staging buffer
goes when the job is done or its decoder goes.
"""
import gc
import json
import os
import weakref

import numpy as np
import pytest
import torch

import chip_smoke
from sdvpcmdecoder_tpu_torch.pipeline import batch_driver as tbd
from sdvpcmdecoder_tpu_torch.pipeline import device_driver as tdd
from sdvpcmdecoder_tpu_torch.pipeline import device_pcm as tdp
from sdvpcmdecoder_tpu_torch.pipeline import ingest
from sdvpcmdecoder_tpu_torch.utils import host

torch.set_num_threads(1)

HBM = 4          # frames a chunk (frames_per_round 2)

# name -> (frames, height, width, timeline of the stored frames or None)
CASES = {
    "even_h": (8, 588, 1152, None),
    "odd_h": (8, 589, 1152, None),
    "narrow": (8, 588, 720, None),
    "short_last_chunk": (10, 588, 1152, None),
    "one_frame_after_full": (5, 589, 1152, None),
    "dropped_frame": (7, 588, 1152, [0, 1, 3, 4, 5, 6, 7]),
    "dropped_in_later_chunk": (10, 588, 1152,
                               [0, 1, 2, 3, 4, 6, 7, 8, 9, 10]),
}
# the chunks a case stages, where they are not all HBM frames
CHUNKS = {"short_last_chunk": [HBM, HBM, 2],
          "one_frame_after_full": [HBM, 1],
          "dropped_in_later_chunk": [HBM, HBM, 3]}

DECODERS = {
    "stc007": lambda jobs: tdd.DeviceBatchDecoder(
        jobs, frames_per_round=2, hbm_frames=HBM, device="cpu"),
    "pcm1": lambda jobs: tdp.DevicePCMBatchDecoder(
        jobs, "pcm1", frames_per_round=2, hbm_frames=HBM, device="cpu"),
}


def write_frames(tmp_path, case):
    n, H, W, timeline = CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    path = str(tmp_path / f"{case}.y4m")
    ingest.write_y4m(path, rng.integers(0, 256, (n, H, W), np.uint8))
    if timeline is not None:
        with open(path + ".pts", "w") as fh:
            json.dump({"timeline": timeline}, fh)
    return path


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("decoder", sorted(DECODERS))
def test_staged_chunks_equal_the_host_split(tmp_path, decoder, case):
    path = write_frames(tmp_path, case)
    dec = DECODERS[decoder]([(path, str(tmp_path / "o.wav"))])
    j = dec.jobs[0]
    chunks = []
    n, H, W, timeline = CASES[case]
    dropped = 0 if timeline is None else timeline[-1] + 1 - len(timeline)
    with ingest.open_capture(path) as rd:
        if timeline is not None:
            assert rd.dropped_frames == dropped == 1
        while True:
            want, nums = ingest.split_fields_batch(
                rd.read_frames(j.chunk_base, HBM))
            want = torch.from_numpy(want)
            assert j.px_dev.dtype == want.dtype
            assert j.px_dev.shape == want.shape
            assert torch.equal(j.px_dev, want)
            assert j.nums.dtype == nums.dtype
            assert np.array_equal(j.nums, nums)
            assert (j.chunk_len, j.Ls, j.W) == tuple(want.shape)
            chunks.append(j.chunk_len)
            if not dec._stage_chunk(j):
                break
    assert sum(chunks) == rd.n_frames == n + dropped
    assert j.stage_next == rd.n_frames
    assert chunks == CHUNKS.get(case, [HBM] * ((n + dropped) // HBM))
    assert dec.stage_t["count_stage_chunks"] == len(chunks)
    assert "count_stage_pinned_chunks" not in dec.stage_t
    if case == "narrow":
        assert j.W == 2 * W


def test_driver_never_calls_the_host_split(tmp_path, monkeypatch):
    """A DeviceBatchDecoder run stages every chunk without
    split_fields_batch and writes the WAV it wrote before the patch, the
    native backend's."""
    cap = chip_smoke.write_capture(str(tmp_path / "c.y4m"), 10, 294,
                                   seed=7)
    kw = dict(frames_per_round=3, hyst_limit=2, shift_limit=1)

    def wav(cls, tag, **more):
        out = str(tmp_path / f"{tag}.wav")
        cls([(cap, out)], **kw, **more).run()
        return open(out, "rb").read()

    before = wav(tdd.DeviceBatchDecoder, "before", hbm_frames=6,
                 device="cpu")
    assert before == wav(tbd.BatchDecoder, "native", backend="native",
                         device="cpu")

    def refuse(*a, **k):
        raise AssertionError("split_fields_batch called while staging")

    monkeypatch.setattr(ingest, "split_fields_batch", refuse)
    assert wav(tdd.DeviceBatchDecoder, "after", hbm_frames=6,
               device="cpu") == before
    assert os.path.getsize(tmp_path / "after.wav") > 44


@pytest.mark.parametrize("timeline", [None, [0, 2, 3, 4, 7]],
                         ids=["stored", "timeline"])
@pytest.mark.parametrize("native", [True, False], ids=["native", "mmap"])
def test_read_frames_into_out_equals_a_fresh_read(tmp_path, native,
                                                  timeline):
    """VideoReader.read_frames(first, count, out=buf) returns buf's first
    frames, equal to a fresh read's, through the native loader, the
    python mmap and a timeline with dropped frames; buf starts 0xFF, so
    a dropped frame left unwritten shows, and nothing past the frames
    read is written."""
    frames = np.random.default_rng(5).integers(0, 256, (5, 6, 16), np.uint8)
    path = str(tmp_path / "c.y4m")
    ingest.write_y4m(path, frames)
    if timeline is not None:
        with open(path + ".pts", "w") as fh:
            json.dump(timeline, fh)
    rd = ingest.VideoReader(path, use_native=native)
    assert bool(rd._h) == native
    n = rd.n_frames
    assert n == (5 if timeline is None else 8)
    for first, count in ((0, n), (1, 3), (n - 2, 5), (n, 2)):
        buf = np.full((n + 1, 6, 16), 0xFF, np.uint8)
        got = rd.read_frames(first, count, out=buf)
        want = rd.read_frames(first, count)
        assert got.dtype == want.dtype and np.array_equal(got, want)
        assert got.shape[0] == min(count, n - first)
        assert got.ctypes.data == buf.ctypes.data
        assert (buf[got.shape[0]:] == 0xFF).all()
    rd.close()


def test_read_frames_refuses_an_out_it_cannot_fill(tmp_path):
    path = str(tmp_path / "c.y4m")
    ingest.write_y4m(path, np.zeros((3, 6, 16), np.uint8))
    with ingest.VideoReader(path) as rd:
        for bad in (np.zeros((2, 6, 16), np.uint8),      # too few frames
                    np.zeros((3, 6, 8), np.uint8),       # another width
                    np.zeros((3, 6, 16), np.int16),
                    np.zeros((3, 6, 32), np.uint8)[:, :, ::2]):
            with pytest.raises(ValueError):
                rd.read_frames(0, 3, out=bad)


def test_staging_buffer_on_the_cpu():
    """On the CPU a staging buffer is plain memory: nothing pinned, no
    event, and its upload is the buffer's own bytes."""
    buf = host.StagingBuffer(100, "cpu")
    assert not buf.pinned and not buf.new and buf.event is None
    assert not buf._host.is_pinned() and buf._host.numel() == 100
    arr = buf.array((2, 3, 5))
    arr[:] = np.arange(30).reshape(2, 3, 5)
    assert torch.equal(buf.upload((2, 3, 5)), torch.from_numpy(arr))
    assert buf.event is None
    buf.wait()


def write_capture(tmp_path, decoder, name, seed):
    path = str(tmp_path / f"{name}.y4m")
    if decoder == "stc007":
        return chip_smoke.write_capture(path, 10, 294, seed=seed)
    return chip_smoke.write_pcm1_capture(path, n_frames=6, seed=seed)


@pytest.mark.parametrize("first", ["run", "dropped"])
@pytest.mark.parametrize("decoder", sorted(DECODERS))
def test_staging_buffers_go_with_their_jobs(tmp_path, decoder, first):
    """Each job holds a staging buffer of its own, one chunk of frames,
    from construction until the job is done (`run`) or its decoder goes
    (`dropped`); then nothing holds the buffer (after `run` no read ahead
    either: no future, no thread), so its block goes back to torch's
    caching host allocator for the next decoder. That decoder
    writes the WAVs the first one wrote."""
    caps = [write_capture(tmp_path, decoder, f"c{k}", 7 + k)
            for k in range(2)]

    def build(tag):
        return DECODERS[decoder]([(c, f"{c}.{tag}.wav") for c in caps])

    dec = build("a")
    bufs = [weakref.ref(j.stage_buf) for j in dec.jobs]
    assert bufs[0]() is not bufs[1]()
    assert [b()._host.numel() for b in bufs] == [
        HBM * j.reader.height * j.reader.width for j in dec.jobs]
    if first == "run":
        dec.run()
        assert all(j.stage_buf is None for j in dec.jobs)
        assert all(b() is None for b in bufs)
        # No read ahead is left to hold a buffer: no future, no thread.
        assert all(j.stage_read is None for j in dec.jobs)
        assert not any(t.is_alive() for t in dec._reads._threads)
        t = dec.stage_t
        assert t["count_stage_chunks"] == 2 * -(-dec.jobs[0].stage_next
                                                // HBM)
        assert "count_stage_pin_allocs" not in t
    del dec
    gc.collect()
    assert all(b() is None for b in bufs)
    dec = build("b")
    assert "count_stage_pin_allocs" not in dec.stage_t
    dec.run()
    if first == "run":
        for c in caps:
            assert open(f"{c}.a.wav", "rb").read() == \
                open(f"{c}.b.wav", "rb").read()


@pytest.mark.parametrize("stage_t, share", [
    ({"count_stage_chunks": 32.0, "count_stage_pinned_chunks": 32.0}, 1.0),
    ({"count_stage_chunks": 32.0, "count_stage_pinned_chunks": 8.0}, 0.25),
    ({"count_stage_chunks": 4.0}, 0.0),       # the CPU: no pinned chunk
    ({"stage_hbm": 1.0, "stage_upload": 0.1}, None),   # no such counter
], ids=["pinned", "some", "cpu", "parent"])
def test_stage_pinned_share_reads_the_counters(stage_t, share):
    from bench_port import cells, harness
    rec = harness.Record(frames=6400, stage_t=dict(stage_t))
    assert cells.metric_reader("stage_pinned_share")(rec) == share


@pytest.mark.parametrize("stage_t, share", [
    ({"count_stage_chunks": 32.0, "count_stage_readahead_chunks": 32.0,
      "stage_readahead": 0.5}, 1.0),
    ({"count_stage_chunks": 32.0, "count_stage_readahead_chunks": 24.0,
      "stage_readahead": 0.5}, 0.75),
    ({"count_stage_chunks": 4.0, "stage_readahead": 0.1}, 0.0),  # no hit
    ({"count_stage_chunks": 4.0}, None),   # a program with no read ahead
    ({"stage_hbm": 1.0, "stage_read": 0.1}, None),     # no such counter
], ids=["all", "some", "none", "edge", "no_chunks"])
def test_stage_readahead_share_reads_the_counters(stage_t, share):
    from bench_port import cells, harness
    rec = harness.Record(frames=6400, stage_t=dict(stage_t))
    assert cells.metric_reader("stage_readahead_share")(rec) == share


@pytest.mark.parametrize("stage_t, ms", [
    ({"stage_readahead": 0.64, "stage_read": 0.032}, 0.1),
    ({"stage_readahead": 0.0}, 0.0),
    ({"stage_hbm": 1.0, "stage_read": 0.1}, None),     # no read ahead
], ids=["reads", "zero", "no_span"])
def test_stage_readahead_ms_per_frame_reads_the_span(stage_t, ms):
    from bench_port import cells, harness
    rec = harness.Record(frames=6400, stage_t=dict(stage_t))
    got = cells.metric_reader("stage_readahead_ms_per_frame")(rec)
    assert got == (None if ms is None else pytest.approx(ms))
