"""The port's PCM-1 and PCM-16x0 stitchers against the JAX package's: the
same line stores, pushed frame by frame into both over several frames,
give the same sample chunks (samples, validity, block flags, rate), the
same frame logs and the same carried statistics — with the native
steady-frame fast paths on and off, and without the native core; SI, EI,
the SI->EI auto-switch, both field orders, corrupted and cropped fields,
header lines and manual offsets (the cases of tests/test_steady_pcm1.py,
tests/test_steady16.py and tests/test_ei_crop.py).
"""
import dataclasses

import numpy as np
import pytest
import torch

from sdvpcmdecoder_tpu.ops import stitch_native as jsn
from sdvpcmdecoder_tpu.pipeline import stitcher_pcm1 as jsp1
from sdvpcmdecoder_tpu.pipeline import stitcher_pcm16x0 as jsp16
from sdvpcmdecoder_tpu.pipeline import stitcher_stc007 as jst
from sdvpcmdecoder_tpu_torch.formats import pcm1, pcm16x0
from sdvpcmdecoder_tpu_torch.ops import pcm1_deint as di1
from sdvpcmdecoder_tpu_torch.ops import pcm16x0_deint as di16
from sdvpcmdecoder_tpu_torch.ops import stitch_native as tsn
from sdvpcmdecoder_tpu_torch.pipeline import stitcher_pcm1 as tsp1
from sdvpcmdecoder_tpu_torch.pipeline import stitcher_pcm16x0 as tsp16
from sdvpcmdecoder_tpu_torch.pipeline import stitcher_stc007 as tst

torch.set_num_threads(1)

LPF = 245
PACKAGES = {"jax": (jsp1, jsp16, jst), "port": (tsp1, tsp16, tst)}


# ---- frame inputs (numpy, shared by both packages) -------------------------

def pcm1_frame(fno, seed, bad_frac=0.0, crop=0, header=False):
    """tests/test_steady_pcm1.py's frame: two fields of 245 lines."""
    rng = np.random.default_rng(seed)
    parts = []
    for parity_base in (1, 2):
        sl, sr = di1.interleave_field(rng.integers(0, 1 << 13, 735),
                                      rng.integers(0, 1 << 13, 735))
        words = np.zeros((LPF, 6), np.int64)
        words[:, 0::2] = np.stack([sl[0::3], sl[1::3], sl[2::3]], 1)
        words[:, 1::2] = np.stack([sr[0::3], sr[1::3], sr[2::3]], 1)
        crcs = np.asarray(pcm1.calc_crc(words, xp=np))
        if bad_frac:
            bad = rng.random(LPF) < bad_frac
            crcs = np.where(bad, crcs ^ 0x3C3C, crcs)
        lines = parity_base + 2 * np.arange(LPF)
        if crop:
            words, crcs, lines = words[crop:], crcs[crop:], lines[crop:]
        parts.append(dict(words=words, crc=crcs, lines=lines))
    return dict(fno=fno, parts=parts, header=header)


def pcm1_store(mod, fr):
    stores = [mod.PCM1LineStore.from_decoded(
        p["words"], p["crc"], np.full(len(p["crc"]), fr["fno"]), p["lines"],
        ref_level=np.full(len(p["crc"]), 110)) for p in fr["parts"]]
    out = mod.PCM1LineStore.concat(stores)
    if fr["header"]:
        h = mod.PCM1LineStore(1)
        h.service[0] = mod.SRV_HEADER
        h.frame_number[0] = fr["fno"]
        h.line_number[0] = 1
        out = mod.PCM1LineStore.concat([h, out])
    return out


USABLE = (LPF * 3 // (3 * di16.SI_OFS)) * (3 * di16.SI_OFS)


def pcm16x0_si_frame(fno, seed, bad_frac=0.0, picked=False, ctrl=True,
                     first=False):
    """tests/test_steady16.py's SI frame (control bits ctrl)."""
    rng = np.random.default_rng(seed)
    parts = []
    for parity_base, s in ((1, seed * 2), (2, seed * 2 + 1)):
        r2 = np.random.default_rng(s)
        sub, _ = di16.interleave_field(r2.integers(1, 1 << 16, USABLE),
                                       r2.integers(1, 1 << 16, USABLE), LPF)
        S = len(sub)
        crcs = np.asarray(pcm16x0.calc_crc(sub, xp=np))
        if bad_frac:
            crcs = np.where(rng.random(S) < bad_frac, crcs ^ 0xFFFF, crcs)
        pl = pr = None
        if picked:
            pl = (rng.random(S) < 0.1).astype(np.int8)
            pr = (rng.random(S) < 0.1).astype(np.int8)
        parts.append(dict(words=sub, crc=crcs,
                          lines=parity_base + 2 * (np.arange(S) // 3),
                          line_parts=np.arange(S) % 3,
                          control_bit=np.full(S, ctrl), pl=pl, pr=pr))
    return dict(fno=fno, parts=parts, first=first)


def pcm16x0_ei_frame(fno, seed, crop_odd=0, crop_even=0, first=False):
    """tests/test_ei_crop.py's EI frame (whole-frame interleave) with
    lines cropped from the top of each field."""
    rng = np.random.default_rng(seed)
    usable = di16.EI_OFS * 3
    sub, _ = di16.interleave_field(rng.integers(1, 1 << 16, usable),
                                   rng.integers(1, 1 << 16, usable),
                                   2 * LPF, ei=True)
    crcs = np.asarray(pcm16x0.calc_crc(sub, xp=np))
    half = LPF * 3
    parts = []
    for base, lo, crop in ((1, 0, crop_odd), (2, half, crop_even)):
        w = sub[lo + 3 * crop:lo + half]
        parts.append(dict(words=w, crc=crcs[lo + 3 * crop:lo + half],
                          lines=base + 2 * (crop + np.arange(len(w)) // 3),
                          line_parts=np.arange(len(w)) % 3,
                          control_bit=np.zeros(len(w), bool), pl=None,
                          pr=None))
    return dict(fno=fno, parts=parts, first=first)


def pcm16x0_store(mod, fr):
    stores = [mod.PCM16X0LineStore.from_decoded(
        p["words"], p["crc"], np.full(len(p["crc"]), fr["fno"]), p["lines"],
        p["line_parts"], control_bit=p["control_bit"], picked_left=p["pl"],
        picked_right=p["pr"]) for p in fr["parts"]]
    out = mod.PCM16X0LineStore.concat(stores)
    if fr["first"]:
        tag = mod.PCM16X0LineStore(1)
        tag.service[0] = mod.SRV_NEW_FILE
        tag.frame_number[0] = fr["fno"]
        out = mod.PCM16X0LineStore.concat([tag, out])
    return out


# ---- running both packages -------------------------------------------------

def run(pkg, family, frames, steady=True, **kw):
    """Push `frames` into `pkg`'s stitcher of `family` one by one; returns
    (sample arrays, frame log, carried state)."""
    p1, p16, st = PACKAGES[pkg]
    if family == "pcm1":
        s = p1.PCM1Stitcher(**kw)
        make = pcm1_store
        mod = p1
    else:
        s = p16.PCM16X0Stitcher(**kw)
        make = pcm16x0_store
        mod = p16
    if not steady:
        s._try_steady_frame = lambda *a: False
    arrays = []
    for fr in frames:
        s.push_frame(make(mod, fr))
        # Drain every frame, as the drivers do.
        arrays.append(st.chunks_to_arrays(s.pop_sample_chunks()))
    s.finish()
    arrays.append(st.chunks_to_arrays(s.pop_sample_chunks()))
    log = [dataclasses.asdict(f) for f in s.frame_log]
    state = {k: v for k, v in vars(s).items()
             if k.startswith("stats_") or k in ("fmt", "file_started")}
    return arrays, log, state


def assert_runs_equal(a, b):
    (arr_a, log_a, st_a), (arr_b, log_b, st_b) = a, b
    assert len(arr_a) == len(arr_b)
    for k, (x, y) in enumerate(zip(arr_a, arr_b)):
        assert (x is None) == (y is None), k
        if x is None:
            continue
        for u, v in zip(x[:3], y[:3]):
            assert u.dtype == v.dtype, (k, u.dtype, v.dtype)
            np.testing.assert_array_equal(u, v, err_msg=str(k))
        assert x[3] == y[3]
    assert log_a == log_b
    assert st_a == st_b


def both(family, frames, native=True, monkeypatch=None, **kw):
    if not native:
        for sn in (jsn, tsn):
            monkeypatch.setattr(sn, "available", lambda: False)
    a = run("jax", family, frames, **kw)
    b = run("port", family, frames, **kw)
    assert_runs_equal(a, b)
    assert any(x is not None for x in a[0]), "no samples came out"
    return b


# ---- PCM-1 -----------------------------------------------------------------

@pytest.mark.parametrize("steady", [True, False])
@pytest.mark.parametrize("bad,crop", [(0.0, 0), (0.08, 0), (0.15, 9)])
def test_pcm1_stitcher_matches_jax(bad, crop, steady):
    frames = [pcm1_frame(f + 1, 1 + f, bad_frac=bad, crop=crop)
              for f in range(4)]
    both("pcm1", frames, steady=steady)


@pytest.mark.parametrize("kw", [
    dict(auto_offset=False, odd_offset=2, even_offset=-1),
    dict(field_order=jst.ORDER_BFF)], ids=["offsets", "bff"])
def test_pcm1_stitcher_options_match_jax(kw):
    frames = [pcm1_frame(f + 1, 7 + f, bad_frac=0.03) for f in range(3)]
    both("pcm1", frames, **kw)


def test_pcm1_header_frames_and_no_native_match_jax(monkeypatch):
    frames = [pcm1_frame(f + 1, 3 + f, header=f == 1) for f in range(4)]
    both("pcm1", frames)
    both("pcm1", frames, native=False, monkeypatch=monkeypatch)


# ---- PCM-16x0 --------------------------------------------------------------

@pytest.mark.parametrize("steady", [True, False])
@pytest.mark.parametrize("bad,picked", [(0.0, False), (0.05, True)])
def test_pcm16x0_si_stitcher_matches_jax(bad, picked, steady):
    frames = [pcm16x0_si_frame(f + 1, 1 + f, bad_frac=bad, picked=picked,
                               first=f == 0) for f in range(4)]
    both("pcm16x0", frames, steady=steady)


def test_pcm16x0_si_bff_knockout_and_no_native_match_jax(monkeypatch):
    frames = [pcm16x0_si_frame(f + 1, 20 + f, bad_frac=0.6 if f == 2
                               else 0.0, first=f == 0) for f in range(4)]
    both("pcm16x0", frames, field_order=jst.ORDER_BFF)
    both("pcm16x0", frames[:3], native=False, monkeypatch=monkeypatch)


def test_pcm16x0_auto_switch_to_ei_matches_jax():
    """An all-zero control-bit stream under auto_fmt: the MODE vote
    switches SI -> EI identically in both packages."""
    frames = [pcm16x0_si_frame(f + 1, 70 + f, ctrl=False)
              for f in range(4)]
    out = both("pcm16x0", frames, auto_fmt=True)
    assert out[2]["fmt"] == tsp16.FORMAT_EI


@pytest.mark.parametrize("crops", [(0, 0), (3, 3), (0, 4), (6, 1)])
def test_pcm16x0_ei_stitcher_matches_jax(crops):
    frames = [pcm16x0_ei_frame(f + 1, 7 + f, *crops, first=f == 0)
              for f in range(3)]
    both("pcm16x0", frames, fmt=tsp16.FORMAT_EI)


def test_pcm16x0_ei_field_orders_match_jax():
    frames = [pcm16x0_ei_frame(f + 1, 30 + f) for f in range(2)]
    for order in (jst.ORDER_UNK, jst.ORDER_BFF):
        both("pcm16x0", frames, fmt=tsp16.FORMAT_EI, field_order=order)
