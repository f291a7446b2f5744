"""This slice's card paths against their plain or CPU versions, on an
NVIDIA GPU: decode_stream's K1 route, the mesh step, concurrent shards on
one card, the device histogram, a container through the CLI and the
chip-resident driver's staging split into fields on the card, through
pinned buffers that a second decoder takes from the pool. Marked
`cuda`: every test skips where torch.cuda.is_available() is false. On a
GPU machine (no JAX there) run them with

    python -m pytest --noconftest -m cuda tests/test_torch_ingest_cuda.py
"""
import gc
import hashlib

import numpy as np
import pytest
import torch

import chip_smoke
from sdvpcmdecoder_tpu_torch.ops import agc
from sdvpcmdecoder_tpu_torch.ops import fused_binarize as fb
from sdvpcmdecoder_tpu_torch.parallel import mesh as pm
from sdvpcmdecoder_tpu_torch.parallel.multichip import ShardedBatchDecoder
from sdvpcmdecoder_tpu_torch.pipeline import decoder, ingest
from sdvpcmdecoder_tpu_torch.synth import encoder as enc

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda")


def _stream(n_lines, seed=42, noise=25.0):
    rng = np.random.default_rng(seed)
    n = 3 * n_lines
    pixels, coords, _, _ = enc.encode_stream(
        rng.integers(1, 1 << 14, n), rng.integers(1, 1 << 14, n),
        width=1152, ppb=8.0, n_lines=n_lines, noise_sigma=noise, rng=rng)
    lv = [np.full(n_lines, v, np.int32) for v in (110, 20, 200)]
    return [pixels, coords.astype(np.int32), *lv]


def test_decode_stream_launches_k1_and_equals_plain(cuda):
    arrays = _stream(400)
    dev = [torch.from_numpy(a).to(cuda) for a in arrays]
    before = fb.stc007_fused_decode_frames.launches
    got = decoder.decode_stream(*dev, hyst_limit=2, shift_limit=1)
    assert fb.stc007_fused_decode_frames.launches == before + 1
    plain = decoder.decode_stream(*dev, hyst_limit=2, shift_limit=1,
                                  use_kernel=False)
    host = decoder.decode_stream(*(torch.from_numpy(a) for a in arrays),
                                 hyst_limit=2, shift_limit=1)
    for g, p, h in zip(got, plain, host):
        assert torch.equal(g, p) and torch.equal(g.cpu(), h)


def test_mesh_step_on_the_card_equals_the_cpu_grid(cuda):
    arrays = _stream(4 * pm.HALO + 112)
    S = 2
    per = [pm.chunk_lines_with_halo(a, S)[0][None] for a in arrays]
    outs = []
    for devices in ([cuda], ["cpu"]):
        grid = pm.decode_mesh(S, seq=S, devices=devices)
        gathered, n_valid = pm.multichip_decode_step(grid, 1, 1)(
            *(pm.shard_captures(a, grid) for a in per))
        outs.append(([g.cpu() for g in gathered[0]],
                     [int(v) for v in n_valid[0]]))
    assert outs[0][1] == outs[1][1]
    for a, b in zip(outs[0][0], outs[1][0]):
        assert torch.equal(a, b)


def test_line_histograms_device_on_the_card(cuda):
    rng = np.random.default_rng(5)
    px = torch.from_numpy(rng.integers(0, 256, (64, 1152), np.uint8))
    mask = torch.from_numpy(rng.random((64, 1152)) > 0.5)
    got = agc.line_histograms_device(px.to(cuda), mask.to(cuda))
    assert got.device.type == "cuda" and got.dtype == torch.int32
    assert torch.equal(got.cpu(), agc.line_histograms_device(px, mask))


@pytest.mark.parametrize("resident", [False, True])
def test_two_shards_on_one_card_equal_one(cuda, tmp_path, resident):
    jobs = []
    for k in range(3):
        cap = chip_smoke.write_capture(str(tmp_path / f"c{k}.y4m"), 3, 294,
                                       seed=50 + k)
        jobs.append((cap, str(tmp_path / f"c{k}.wav")))
    kw = dict(hyst_limit=2, shift_limit=1, frames_per_round=2)
    wavs = []
    for devices, suffix in (([cuda, cuda], ""), ([cuda], ".one")):
        fb.stc007_fused_decode_frames.launches = 0
        sh = ShardedBatchDecoder([(p, o + suffix) for p, o in jobs],
                                 devices=devices, device_resident=resident,
                                 **kw)
        sh.run()
        assert fb.stc007_fused_decode_frames.launches > 0
        assert np.array_equal(sh.stats, sh.shard_stats.sum(axis=0))
        wavs.append([open(o + suffix, "rb").read() for _, o in jobs])
    assert wavs[0] == wavs[1]


def test_hfyu_avi_through_the_cli_on_the_card(cuda, tmp_path):
    from sdvpcmdecoder_tpu_torch.__main__ import main
    frames = chip_smoke.capture_frames(12, 294, seed=1)
    cap = chip_smoke.write_container(str(tmp_path / "c.avi"), frames, "HFYU")
    out = tmp_path / "c.wav"
    before = fb.stc007_fused_decode_frames.launches
    assert main([cap, "-o", str(out)]) == 0
    assert fb.stc007_fused_decode_frames.launches > before
    assert hashlib.sha256(out.read_bytes()).hexdigest() == \
        chip_smoke.GOLDEN_CLI_SHA256["pal"]


@pytest.mark.parametrize("capture", ["full_width", "narrow"])
def test_chunks_split_on_the_card_equal_the_host_split(cuda, tmp_path,
                                                       capture):
    """DeviceBatchDecoder's staging: each chunk uploaded as read and split
    into fields on the card is ingest.split_fields_batch's array moved
    there, byte for byte; the 720-px capture is doubled on the card."""
    path = str(tmp_path / f"{capture}.y4m")
    if capture == "full_width":
        chip_smoke.write_capture(path, 10, 294, seed=9)
        lpf = 294
    else:
        lpf = chip_smoke.WIDE["lpf"]
        ingest.write_y4m(path, chip_smoke.wide_frames(10, lpf, seed=9))
    chunks, nbytes = chip_smoke.staged_chunks_match(
        path, cuda, 4, lines_per_field=lpf, frames_per_round=4)
    width = chip_smoke.WIDTH if capture == "full_width" else 2 * 720
    assert chunks == 3 and nbytes == 10 * 2 * lpf * width


@pytest.mark.parametrize("fmt", ["stc007", "pcm1"])
def test_chunks_staged_through_pinned_buffers(cuda, tmp_path, fmt):
    """Every chunk goes to the card from the job's pinned staging buffer
    (count_stage_pinned_chunks == count_stage_chunks) and equals the host
    split byte for byte, the short last chunk too; a second decoder, once
    the first is gone, pins no new buffer (count_stage_pin_allocs 0)."""
    from sdvpcmdecoder_tpu_torch.pipeline import device_driver as dd
    from sdvpcmdecoder_tpu_torch.pipeline import device_pcm as dp
    path = str(tmp_path / f"{fmt}.y4m")
    if fmt == "stc007":
        chip_smoke.write_capture(path, 10, 294, seed=9)

        def build():
            return dd.DeviceBatchDecoder([(path, path + ".wav")],
                                         device=cuda, hbm_frames=4,
                                         frames_per_round=4)
    else:
        chip_smoke.write_pcm1_capture(path, n_frames=10, seed=9)

        def build():
            return dp.DevicePCMBatchDecoder([(path, path + ".wav")], "pcm1",
                                            device=cuda, hbm_frames=4,
                                            frames_per_round=4)
    dec = build()
    j = dec.jobs[0]
    assert j.stage_buf.pinned and j.stage_buf._host.is_pinned()
    chunks = []
    with ingest.open_capture(path) as rd:
        while True:
            want, nums = ingest.split_fields_batch(
                rd.read_frames(j.chunk_base, dec.hbm_frames))
            want = torch.from_numpy(want).to(cuda)
            assert j.px_dev.dtype == want.dtype
            assert torch.equal(j.px_dev, want)
            assert np.array_equal(j.nums, nums)
            chunks.append(j.chunk_len)
            if not dec._stage_chunk(j):
                break
    assert chunks == [4, 4, 2]
    t = dec.stage_t
    assert t["count_stage_pinned_chunks"] == t["count_stage_chunks"] == 3
    del dec, j
    gc.collect()
    dec = build()
    assert "count_stage_pin_allocs" not in dec.stage_t
    dec.run()
    t = dec.stage_t
    assert t["count_stage_pinned_chunks"] == t["count_stage_chunks"] == 3
    assert "count_stage_pin_allocs" not in t


@pytest.mark.parametrize("fmt", ["stc007", "pcm1"])
def test_reads_ahead_wait_for_the_buffers_last_upload(cuda, tmp_path,
                                                      monkeypatch, fmt):
    """No read ahead writes a job's pinned staging buffer before the
    buffer's last upload has run: the event StagingBuffer.upload recorded
    for it has completed whenever the reader is asked to fill it, as the
    chunks are staged one by one and through a whole run. Every chunk
    staged on the card is `_split_fields` of the frames as read."""
    from sdvpcmdecoder_tpu_torch.pipeline import device_driver as dd
    from sdvpcmdecoder_tpu_torch.pipeline import device_pcm as dp
    from sdvpcmdecoder_tpu_torch.utils import host
    last_upload = {}     # the buffer's address -> its last upload's event
    upload = host.StagingBuffer.upload

    def recorded_upload(self, shape):
        t = upload(self, shape)
        last_upload[self._host.data_ptr()] = self.event
        return t

    read_frames = ingest.VideoReader.read_frames
    frames_read = {}     # first frame -> a copy of the frames read

    def checked_read(self, first, count, out=None):
        if out is not None:
            ev = last_upload.get(out.ctypes.data)
            assert ev is None or ev.query(), \
                f"frame {first} read into a buffer whose upload is queued"
        got = read_frames(self, first, count, out=out)
        frames_read[first] = got.copy()
        return got

    monkeypatch.setattr(host.StagingBuffer, "upload", recorded_upload)
    monkeypatch.setattr(ingest.VideoReader, "read_frames", checked_read)
    path = str(tmp_path / f"{fmt}.y4m")
    if fmt == "stc007":
        chip_smoke.write_capture(path, 10, 294, seed=9)

        def build(out):
            return dd.DeviceBatchDecoder([(path, out)], device=cuda,
                                         hbm_frames=4, frames_per_round=4)
    else:
        chip_smoke.write_pcm1_capture(path, n_frames=10, seed=9)

        def build(out):
            return dp.DevicePCMBatchDecoder([(path, out)], "pcm1",
                                            device=cuda, hbm_frames=4,
                                            frames_per_round=4)
    dec = build(path + ".a.wav")
    j = dec.jobs[0]
    assert j.stage_read is not None
    chunks = []
    while True:
        want, nums = dd._split_fields(
            torch.from_numpy(frames_read[j.chunk_base]).to(cuda))
        assert torch.equal(j.px_dev, want)
        assert np.array_equal(j.nums, nums)
        chunks.append(j.chunk_len)
        if not dec._stage_chunk(j):
            break
    dec._stop_reads()
    assert chunks == [4, 4, 2] and sorted(frames_read) == [0, 4, 8, 10]
    dec = build(path + ".b.wav")
    dec.run()
    t = dec.stage_t
    assert t["count_stage_chunks"] == 3
    assert t["count_stage_readahead_chunks"] <= 3
    assert not any(th.is_alive() for th in dec._reads._threads)
