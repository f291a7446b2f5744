"""The port's STC-007 stitcher against the JAX package's, exactly.

The same encoder frames become LineStores in each package and go through
each package's STC007Stitcher under one seam backend: the native core,
the device backend ("tpu": ops.device_stitch, the port's on CPU tensors),
or the numpy/torch branches with the native core switched off in both
packages. The sample chunks (samples, valid, block_ok, rate) and the frame
log must be equal.
"""
import dataclasses

import numpy as np
import pytest

from sdvpcmdecoder_tpu.ops import stitch_native as jsn
from sdvpcmdecoder_tpu.pipeline import stitcher_stc007 as jst
from sdvpcmdecoder_tpu_torch.ops import stitch_native as tsn
from sdvpcmdecoder_tpu_torch.pipeline import stitcher_stc007 as tst
from sdvpcmdecoder_tpu_torch.synth import encoder as enc


def _frames(n_frames, lpf=294, resolution=14, order="tff", seed=1):
    rng = np.random.default_rng(seed)
    n = 3 * n_frames * 2 * lpf
    return enc.encode_fields(rng.integers(1, 1 << 14, n),
                             rng.integers(1, 1 << 14, n), n_frames,
                             lines_pf=lpf, resolution=resolution,
                             order=order)


def _inputs(case):
    """Per-frame (words, crcs, valid, frame numbers, line numbers) and the
    stitcher's keyword arguments for one case."""
    kw = {}
    knock = None
    if case == "clean":
        frames = _frames(6)
    elif case in ("knocked_out", "cwd"):
        frames = _frames(6, seed=7)
        knock = np.random.default_rng(3)
        if case == "cwd":
            kw = dict(en_cwd=True)
    elif case == "control_block":
        frames = _frames(6, seed=12)
    elif case == "bff":
        frames = _frames(6, seed=4, order="bff")
    elif case == "16bit":
        frames = _frames(6, seed=5, resolution=16)
    elif case == "m2":
        frames = _frames(6, seed=11)
        kw = dict(mode_m2=True)
    out = []
    cbw, cbc = enc.control_block_line(index=1, hour=12, minute=34,
                                      second=56, field=2, emphasis=True)
    for k, fr in enumerate(frames):
        words, crcs, nums = fr["line_words"], fr["crcs"], fr["line_numbers"]
        if case == "control_block":
            words = np.concatenate([cbw[None, :], words])
            crcs = np.concatenate([[cbc], crcs])
            nums = np.concatenate([[nums[0]], nums])
        valid = np.ones(len(crcs), bool)
        if knock is not None:
            valid[knock.integers(0, len(valid), 40)] = False
            if k == 3:
                valid[knock.integers(0, len(valid), 300)] = False
        out.append((words, crcs, valid, np.full(len(crcs),
                                                fr["frame_number"]), nums))
    return out, kw


def _run(st, inputs, kw, backend):
    stores = []
    for i, (w, c, v, fn, ln) in enumerate(inputs):
        s = st.LineStore.from_decoded(w, c, v, fn, ln)
        if i == 0:
            tag = st.LineStore(1)
            tag.service[0] = st.SRV_NEW_FILE
            tag.frame_number[0] = fn[0]
            s = st.LineStore.concat([tag, s])
        stores.append(s)
    if st is tst:
        kw = dict(kw, device="cpu")
    s = st.STC007Stitcher(
        seam_backend="tpu" if backend == "tpu" else "auto", **kw)
    s.push_frames(stores[:3])
    chunks = s.pop_sample_chunks()
    s.push_frames(stores[3:])
    s.finish()
    chunks += s.pop_sample_chunks()
    return (st.chunks_to_arrays(chunks),
            [dataclasses.asdict(f) for f in s.frame_log],
            s.broken_countdown, s.stats_field_order, s.stats_resolution)


@pytest.mark.parametrize("backend", ["native", "tpu", "numpy"])
@pytest.mark.parametrize("case", ["clean", "knocked_out", "cwd",
                                  "control_block", "bff", "16bit", "m2"])
def test_stitcher_matches_jax(monkeypatch, case, backend):
    if backend == "numpy":
        monkeypatch.setattr(jsn, "available", lambda: False)
        monkeypatch.setattr(tsn, "available", lambda: False)
    inputs, kw = _inputs(case)
    ref = _run(jst, inputs, kw, backend)
    got = _run(tst, inputs, kw, backend)
    assert ref[0] is not None and got[0] is not None
    for a, b in zip(ref[0][:3], got[0][:3]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert ref[0][3] == got[0][3]
    assert ref[1] == got[1]
    assert ref[2:] == got[2:]
