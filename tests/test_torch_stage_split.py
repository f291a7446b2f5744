"""The chip-resident drivers split each staged chunk into fields on the
device: StagedDeviceDecoder._stage_chunk uploads the frames as read and
gathers the field-sequential rows there. On the CPU, every chunk's
`px_dev` and `nums` must equal ingest.split_fields_batch of the same
frames, byte for byte and dtype for dtype (even and odd heights, a narrow
frame doubled, a short last chunk, a timeline with a dropped frame), and
a driver run never calls split_fields_batch and writes the same WAV.
"""
import json
import os

import numpy as np
import pytest
import torch

import chip_smoke
from sdvpcmdecoder_tpu_torch.pipeline import batch_driver as tbd
from sdvpcmdecoder_tpu_torch.pipeline import device_driver as tdd
from sdvpcmdecoder_tpu_torch.pipeline import device_pcm as tdp
from sdvpcmdecoder_tpu_torch.pipeline import ingest

torch.set_num_threads(1)

HBM = 4          # frames a chunk (frames_per_round 2)

# name -> (frames, height, width, timeline of the stored frames or None)
CASES = {
    "even_h": (8, 588, 1152, None),
    "odd_h": (8, 589, 1152, None),
    "narrow": (8, 588, 720, None),
    "short_last_chunk": (10, 588, 1152, None),
    "dropped_frame": (7, 588, 1152, [0, 1, 3, 4, 5, 6, 7]),
}

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
    with ingest.open_capture(path) as rd:
        if CASES[case][3] is not None:
            assert rd.dropped_frames == 1
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
    n, H, W, _ = CASES[case]
    assert sum(chunks) == rd.n_frames == n + (case == "dropped_frame")
    assert j.stage_next == rd.n_frames
    if case == "short_last_chunk":
        assert chunks == [HBM, HBM, 2]
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
