"""The chip-resident drivers read each job's next staging chunk ahead:
as soon as chunk k is uploaded and split, a thread of the decoder's read
pool reads chunk k+1 into the job's staging buffer
(StagedDeviceDecoder._read_ahead), and the chunk edge only takes that
read. On the CPU: the WAVs of three jobs of several chunks each equal
the JAX package's device driver's; every chunk after a job's first was
read ahead (`count_stage_readahead_chunks`); the reads run on a pool of
the decoder's own, a thread a job, and leave BatchDecoder's pool alone;
a reader's error comes out of `run`, and an error in `run` comes out at
once while a read blocks on a stalled live stream.
"""
import os
import threading
import time

import pytest
import torch

import chip_smoke
from sdvpcmdecoder_tpu.pipeline import device_pcm as jdp
from sdvpcmdecoder_tpu_torch.pipeline import batch_driver as tbd
from sdvpcmdecoder_tpu_torch.pipeline import device_driver as tdd
from sdvpcmdecoder_tpu_torch.pipeline import device_pcm as tdp
from sdvpcmdecoder_tpu_torch.pipeline import ingest

torch.set_num_threads(1)

FRAMES = (70, 45, 33)      # chunks of 32: 32 32 6, 32 13, 32 1
HBM = 32


def small(decoder, jobs):
    if decoder == "stc007":
        return tdd.DeviceBatchDecoder(jobs, frames_per_round=2,
                                      hbm_frames=4, device="cpu")
    return tdp.DevicePCMBatchDecoder(jobs, "pcm1", frames_per_round=2,
                                     hbm_frames=4, device="cpu")


def small_capture(tmp_path, decoder, name="c", seed=7):
    path = str(tmp_path / f"{name}.y4m")
    if decoder == "stc007":
        return chip_smoke.write_capture(path, 10, 294, seed=seed)
    return chip_smoke.write_pcm1_capture(path, n_frames=10, seed=seed)


@pytest.fixture(scope="module")
def three_jobs(tmp_path_factory):
    """Three PCM-1 jobs of different lengths, decoded by the port's
    device driver, its reads ahead, and by the JAX package's: for each,
    the WAVs, and the port's stage_t."""
    tmp = tmp_path_factory.mktemp("readahead")
    caps = [chip_smoke.write_pcm1_capture(str(tmp / f"c{k}.y4m"),
                                          n_frames=n, seed=11 + k)
            for k, n in enumerate(FRAMES)]
    kw = dict(frames_per_round=8, hbm_frames=HBM)
    dec = tdp.DevicePCMBatchDecoder([(c, c + ".t.wav") for c in caps],
                                    "pcm1", device="cpu", **kw)
    dec.run()
    jdp.DevicePCMBatchDecoder([(c, c + ".j.wav") for c in caps], "pcm1",
                              **kw).run()
    return dict(
        wavs={s: [open(f"{c}.{s}.wav", "rb").read() for c in caps]
              for s in "tj"},
        stage_t=dict(dec.stage_t))


def test_wavs_equal_the_jax_driver(three_jobs):
    wavs = three_jobs["wavs"]
    assert wavs["t"] == wavs["j"]
    assert all(len(w) > 44 for w in wavs["t"])
    assert three_jobs["stage_t"]["count_stage_chunks"] == 7


def test_every_chunk_after_a_jobs_first_is_read_ahead(three_jobs):
    t = three_jobs["stage_t"]
    n = t["count_stage_chunks"]
    assert n - len(FRAMES) <= t["count_stage_readahead_chunks"] <= n
    assert t["stage_readahead"] > 0


@pytest.mark.parametrize("jobs", [1, 3])
def test_reads_run_on_the_decoders_own_threads(tmp_path, monkeypatch, jobs):
    """The reads run on a pool of the decoder's own, a thread a job, and
    never on the caller's thread; BatchDecoder's pool (the stitch's) is
    left as it was, still open after `run`. Each job has one read in
    flight, from the frame after its staged chunk."""
    threads = []
    orig = ingest.VideoReader.read_frames

    def spy(self, first, count, out=None):
        threads.append(threading.current_thread())
        return orig(self, first, count, out=out)

    monkeypatch.setattr(ingest.VideoReader, "read_frames", spy)
    caps = [small_capture(tmp_path, "pcm1", f"c{k}", 7 + k)
            for k in range(jobs)]
    dec = small("pcm1", [(c, c + ".wav") for c in caps])
    assert dec._reads is not dec.pool and dec._reads._max_workers == jobs
    assert isinstance(dec.pool, tbd._InlineExecutor) == (jobs == 1)
    for j in dec.jobs:
        assert j.stage_read is not None
        assert j.stage_next == j.chunk_base + j.chunk_len == 4
    dec.run()
    assert threads and threading.main_thread() not in threads
    assert len(set(threads)) <= jobs
    assert all(j.stage_read is None for j in dec.jobs)
    assert not any(t.is_alive() for t in dec._reads._threads)
    assert dec.pool.submit(int, 7).result() == 7


@pytest.mark.parametrize("decoder", ["stc007", "pcm1"])
def test_a_reader_error_comes_out_of_run(tmp_path, monkeypatch, decoder):
    """A reader that raises on its second chunk, read ahead on a pool
    thread: `run` raises that error at the job's next chunk edge, does
    not hang, and no thread of the decoder's is left running (on an
    error they end on their own, not joined by `run`)."""
    orig = ingest.VideoReader.read_frames
    calls = []

    def second_fails(self, first, count, out=None):
        calls.append(first)
        if len(calls) == 2:
            raise OSError(f"capture unreadable at frame {first}")
        return orig(self, first, count, out=out)

    monkeypatch.setattr(ingest.VideoReader, "read_frames", second_fails)
    before = set(threading.enumerate())
    cap = small_capture(tmp_path, decoder)
    dec = small(decoder, [(cap, cap + ".wav")])
    failed = []

    def run():
        try:
            dec.run()
        except OSError as e:
            failed.append(e)

    t = threading.Thread(target=run)
    t.start()
    t.join(timeout=120)
    assert not t.is_alive()
    assert [str(e) for e in failed] == ["capture unreadable at frame 4"]
    assert calls == [0, 4]
    for th in dec._reads._threads:
        th.join(30)
    assert set(threading.enumerate()) - before == set()
    assert dec.jobs[0].stage_read is None


def test_the_read_ahead_fills_the_buffer_the_edge_uploads(tmp_path,
                                                          monkeypatch):
    """Each chunk's read ahead writes the job's own staging buffer, from
    the frame after the chunk staged before it; the chunk staged is the
    host split of those frames."""
    outs = []
    orig = ingest.VideoReader.read_frames

    def spy(self, first, count, out=None):
        if out is not None:      # the driver's, not the check's, reads
            outs.append((first, out.ctypes.data))
        return orig(self, first, count, out=out)

    monkeypatch.setattr(ingest.VideoReader, "read_frames", spy)
    cap = small_capture(tmp_path, "stc007")
    dec = small("stc007", [(cap, cap + ".wav")])
    j = dec.jobs[0]
    host = j.stage_buf._host.data_ptr()
    with ingest.open_capture(cap) as rd:
        while True:
            want, _ = ingest.split_fields_batch(rd.read_frames(j.chunk_base,
                                                               4))
            assert torch.equal(j.px_dev, torch.from_numpy(want))
            if not dec._stage_chunk(j):
                break
    assert outs == [(f, host) for f in (0, 4, 8, 10)]
    assert dec.stage_t["count_stage_readahead_chunks"] <= 3
    dec._stop_reads()
    assert not any(t.is_alive() for t in dec._reads._threads)


def test_an_error_leaves_run_while_a_live_stream_stalls(tmp_path):
    """A live capture through a FIFO (ingest.StreamReader) whose producer
    stalls after the first chunk: the read ahead of the second blocks on
    the producer. An error in `run` comes out at once all the same; the
    blocked read ends, and its thread with it, when the producer sends
    the second chunk."""
    cap = small_capture(tmp_path, "stc007")
    data = open(cap, "rb").read()
    head = data.index(b"\n") + 1
    frame = (len(data) - head) // 10
    fifo = str(tmp_path / "live.fifo")
    os.mkfifo(fifo)
    resume = threading.Event()

    def produce():
        with open(fifo, "wb") as fh:
            fh.write(data[:head + 4 * frame])     # the first chunk
            fh.flush()
            resume.wait(60)
            fh.write(data[head + 4 * frame:head + 8 * frame])  # the 2nd

    producer = threading.Thread(target=produce)
    producer.start()
    try:
        dec = small("stc007", [(fifo, str(tmp_path / "live.wav"))])
        j = dec.jobs[0]
        assert isinstance(j.reader, ingest.StreamReader)
        assert j.chunk_len == 4
        for _ in range(500):     # the read of the second chunk has begun
            if j.stage_read.running():
                break
            time.sleep(0.01)
        assert j.stage_read.running()

        def fail(job):
            raise KeyboardInterrupt

        dec._visit = fail
        t0 = time.perf_counter()
        with pytest.raises(KeyboardInterrupt):
            dec.run()
        assert time.perf_counter() - t0 < 5
        assert j.stage_read is None
        assert any(t.is_alive() for t in dec._reads._threads)
    finally:
        resume.set()
        producer.join(60)
    assert not producer.is_alive()
    for t in dec._reads._threads:
        t.join(60)
        assert not t.is_alive()
    j.reader.close()
