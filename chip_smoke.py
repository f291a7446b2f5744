#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (sdvpcmdecoder_tpu_torch).

Builds the CUDA kernels of the STC-007 decode chain from csrc/ (K1, the
per-frame binarize, and K2, the per-group binarize: two entry points of one
source) and, with g++ at the same time, the native stitcher core from
sdvpcmdecoder_tpu/native/stitchcore.cpp; checks each kernel against its
plain torch version on the card (also at the round's shape, NTSC lines,
the marker fallback's 64 x 1 batches, coordinates with stop < start, and
rows too narrow or misaligned for the TMA), checks with torch.profiler
that a wrapper call is one kernel launch and no copy, times K1 at 16 and
128 frames, NORMAL and INSANE, beside its bound and with its wrapper's
host time, and drives four paths at full PAL size
(588 lines x 1152 px): decode_frames on 128 frames through the audio
masker and the WAV writer; K2 on single-frame groups; the chip-resident
round (steady_round_packed), 4 chained rounds of 16 frames on a staged
64-frame capture, once clean and once noisy with knocked-out lines; and
the chip-resident driver (DeviceBatchDecoder), y4m captures in and WAVs
out: two golden captures whose WAVs must hash as the JAX package's do,
2 x 128 frames timed with K1 and with the plain binarize, and a noisy
capture that takes the marker-fallback re-decode. Times the kernels, their
plain versions, the chain, the round and the driver. Needs one NVIDIA
GPU; from the repository root:

    python3 chip_smoke.py

Prints one line per phase, then a JSON line describing the kernels, then
{"ok": true, "device": {...}} as the last line. Exits non-zero, without
that last line, on any failure or when no CUDA device is present.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

PAL_LINES = 588       # lines per PAL frame (2 x 294)
WIDTH = 1152
FRAMES = 128          # the slice's batch (bench.py device_only_fps)
CHECK_FRAMES = 32     # K1-vs-plain checks at NORMAL
INSANE_FRAMES = 8     # ... and at INSANE
MODE_FRAMES = 8       # 16-bit and auto resolution runs
GROUP_FRAMES = 4      # K2's path: this many frames, one group each
ROUND_FRAMES = 16     # frames per round (the driver's --batch default)
ROUNDS = 4            # chained rounds over one staged capture
DRIVER_FRAMES = 128   # frames per capture of the timed driver run
DRIVER_SEEDS = (1, 11)
DRIVER_HBM = 64       # staging chunk: every capture crosses chunks
NOISY_FRAMES = 32     # the noisy driver capture (sigma 26)
DEVICE = "cuda:0"
NORMAL = (4, 2)       # (hyst_limit, shift_limit), __main__.py:238-240
INSANE = (10, 4)
SOURCE = "sdvpcmdecoder_tpu_torch/csrc/stc007_binarize.cu"
KERNEL = dict(name="stc007_binarize_frames", route="cuda", source=SOURCE,
              replaces="sdvpcmdecoder_tpu/ops/pallas_binarize.py:182")
KERNEL2 = dict(name="stc007_binarize_group", route="cuda", source=SOURCE,
               replaces="sdvpcmdecoder_tpu/ops/pallas_binarize.py:262")


# sha256 of the JAX package's WAV for each golden capture
# (write_capture(path, 12, 294, seed=1) and write_capture(path, 10, 245,
# seed=1), decoded at hyst 2, shift 1, 5 frames per round), made with
#     batch_driver.BatchDecoder([(capture, wav)], lines_per_field=lpf,
#         hyst_limit=2, shift_limit=1, frames_per_round=5,
#         backend="native").run()
# from sdvpcmdecoder_tpu.pipeline; tests/test_torch_driver.py recomputes
# them from the JAX package.
GOLDEN_SHA256 = {
    "pal": "d78d00beb3096964a5e05e16c581878b09549535cb25d6f151ba40f6bafa7b9f",
    "ntsc": "40f2e8b6582372cea5b3a40224ff326e3d4db0076971b27bab25c186269e35ed",
}


def write_capture(path, n_frames, lpf, seed, noise=0.0):
    """A y4m STC-007 capture of n_frames frames, 2 * lpf lines x WIDTH px,
    written with the port's encoder (8 px per bit, the fields of a frame
    interleaved): the recipe of the JAX package's driver tests. Returns
    the path."""
    from sdvpcmdecoder_tpu_torch.pipeline import ingest
    from sdvpcmdecoder_tpu_torch.synth import encoder as enc
    rng = np.random.default_rng(seed)
    n = 3 * n_frames * 2 * lpf
    frames = enc.encode_fields(rng.integers(1, 1 << 14, n),
                               rng.integers(1, 1 << 14, n), n_frames,
                               lines_pf=lpf)
    vids = np.zeros((n_frames, 2 * lpf, WIDTH), np.uint8)
    for f, fr in enumerate(frames):
        pixels, _ = enc.render_lines(fr["line_words"], fr["crcs"],
                                     width=WIDTH, ppb=8.0)
        L = pixels.shape[0]
        if noise:
            pixels = np.clip(pixels.astype(np.int16)
                             + rng.normal(0, noise, pixels.shape), 0, 255) \
                .astype(np.uint8)
        vids[f, 0::2] = pixels[:L // 2]
        vids[f, 1::2] = pixels[L // 2:]
    ingest.write_y4m(path, vids)
    return path


def check(cond, msg):
    if not cond:
        raise SystemExit(f"chip_smoke FAILED: {msg}")


def encode_frames(n_frames, sigma, seed, device, resolution=14):
    """Synthetic capture [F, 588, 1152] u8 on `device` from the port's
    encoder (bench.py's recipe for 14 bit), per-frame coords [F, 2], and
    the encoded left/right words."""
    from sdvpcmdecoder_tpu_torch.synth import encoder as enc
    rng = np.random.default_rng(seed)
    n_lines = n_frames * PAL_LINES
    left = rng.integers(0, 1 << resolution, size=3 * n_lines)
    right = rng.integers(0, 1 << resolution, size=3 * n_lines)
    if resolution == 14:
        pixels, coords, *_ = enc.encode_stream(
            left, right, width=WIDTH, ppb=8.0, n_lines=n_lines,
            noise_sigma=sigma, rng=rng)
    else:
        line_words, crcs = enc.blocks_to_lines(
            enc.samples_to_blocks16(left, right), n_lines, resolution=16)
        pixels, coords = enc.render_lines(line_words, crcs, width=WIDTH,
                                          ppb=8.0, noise_sigma=sigma, rng=rng)
    px = torch.from_numpy(pixels.reshape(n_frames, PAL_LINES, WIDTH))
    cd = torch.from_numpy(coords[::PAL_LINES].copy())
    return px.to(device), cd.to(device), left, right


def frame_levels(n_frames, device, ref=110, black=20, white=200):
    return tuple(torch.full((n_frames,), v, dtype=torch.int32, device=device)
                 for v in (ref, black, white))


def as_int16(words):
    w = np.asarray(words, np.int64) & 0xFFFF
    return np.where(w >= 0x8000, w - 0x10000, w).astype(np.int16)


def compare_k1(tag, px, cd, levels, limits):
    """K1 against its plain version on the same inputs: every LineBatch
    field, every line. Returns the max abs difference (0 when equal)."""
    from sdvpcmdecoder_tpu_torch.ops import binarize as bz
    from sdvpcmdecoder_tpu_torch.ops import fused_binarize as fb
    got = fb.stc007_fused_decode_frames(px, cd, *levels, *limits)
    expect = bz.stc007_frame_decode(px, cd, *levels, *limits)
    torch.cuda.synchronize()
    err = max_batch_err(f"K1 {tag}", got, expect)
    F, L = got.valid.shape
    print(f"[k1] {tag}: F={F} L={L} hyst/shift limits={limits} "
          f"valid={int(got.valid.sum())}/{F * L} max_abs_err={err} "
          f"(words, crc_read, crc_calc, valid, hyst, shift on all lines)")
    check(err == 0, f"K1 {tag} disagrees with its plain version")
    return err


def plain_staged(px):
    """Copies of pixels [..., W] that the kernel must stage with plain
    loads, keyed by a tag: two columns narrower (W - 2 is not a multiple
    of 16), and a contiguous tensor 1 byte past a 16-byte boundary."""
    narrow = px[..., :-2].contiguous()
    buf = torch.empty(px.numel() + 16, dtype=torch.uint8, device=px.device)
    ofs = (1 - buf.data_ptr()) % 16
    shifted = buf[ofs:ofs + px.numel()].view(px.shape)
    shifted.copy_(px)
    check(narrow.shape[-1] % 16 != 0 and shifted.data_ptr() % 16 == 1
          and shifted.is_contiguous(), "plain-staging inputs")
    return {f"width {narrow.shape[-1]}": narrow, "1-byte offset": shifted}


def max_batch_err(tag, got, expect):
    """Max abs difference over every LineBatch field (dtypes and shapes
    must agree)."""
    err = 0
    for name in got._fields:
        g, e = getattr(got, name), getattr(expect, name)
        check(g.dtype == e.dtype and g.shape == e.shape,
              f"{tag}: {name} {g.dtype}{tuple(g.shape)} vs plain "
              f"{e.dtype}{tuple(e.shape)}")
        err = max(err, int((g.long() - e.long()).abs().max()))
    return err


def compare_k2(tag, px, cd, levels, limits):
    """K2 (one group of lines, per-line levels [L]) against its plain
    version, stc007_frame_decode over one frame, on every line."""
    from sdvpcmdecoder_tpu_torch.ops import binarize as bz
    from sdvpcmdecoder_tpu_torch.ops import fused_binarize as fb
    coords = (int(cd[0]), int(cd[1]))
    got = fb.stc007_fused_decode(px, coords, *levels, *limits)
    plain = bz.stc007_frame_decode(px[None], cd[None],
                                   *(t[None] for t in levels), *limits)
    torch.cuda.synchronize()
    err = max_batch_err(f"K2 {tag}", got,
                        bz.LineBatch(*(t[0] for t in plain)))
    print(f"[k2] {tag}: L={px.shape[0]} hyst/shift limits={limits} "
          f"valid={int(got.valid.sum())}/{px.shape[0]} max_abs_err={err} "
          f"(every LineBatch field on all lines)")
    check(err == 0, f"K2 {tag} disagrees with its plain version")
    return err


def round_params(cd, pred_mode, device):
    """The round's int32 parameter vector (ds.round_param_layout): coords,
    ref 110 / black 20 / white 200 per frame, every frame usable, no
    uploaded carry, the predicted conv mode and unchecked limit 3."""
    from sdvpcmdecoder_tpu_torch.ops import device_stitch as ds
    F = cd.shape[0]
    o, n = ds.round_param_layout(F)
    p = torch.zeros(n, dtype=torch.int32, device=device)
    p[o["coords"]:o["coords"] + 2 * F] = cd.reshape(-1)
    for key, v in (("refs", 110), ("blacks", 20), ("whites", 200),
                   ("usable", 1)):
        p[o[key]:o[key] + F] = v
    p[o["pred_mode"]] = pred_mode
    p[o["unch_lim"]] = 3
    return p


def run_rounds(px, cd, rows0, rows, tables, use_kernel):
    """ROUNDS rounds of ROUND_FRAMES frames over the staged capture: round
    0 unchained from a zero state, the others chained on the state the
    round before handed on (the driver's _dispatch). Returns per round
    (out, words_flat, tails, carry_next) as tensors on the card."""
    from sdvpcmdecoder_tpu_torch.ops import deinterleave as di
    from sdvpcmdecoder_tpu_torch.pipeline import device_driver as dd
    F = ROUND_FRAMES
    state = dd.RoundState.zeros(PAL_LINES, px.device)
    results = []
    for r in range(ROUNDS):
        sl = slice(r * F, (r + 1) * F)
        out, wflat, state = dd.run_round(
            px[sl], round_params(cd[sl], di.RES_MODE_14BIT, px.device),
            state, rows if r else rows0, en_p=True, en_q=True, m2=False,
            hyst_limit=NORMAL[0], shift_limit=NORMAL[1],
            use_kernel=use_kernel, chained=r > 0, tables=tables)
        results.append((out, wflat, *state))
    return results


def median_ms_abab(fn_a, fn_b, rounds=5):
    """Median CUDA-event ms of fn_a and fn_b over `rounds` each, taken in
    alternating order (a b, b a, ...) after one warm-up call each."""
    fn_a(), fn_b()
    times = ([], [])
    for r in range(rounds):
        order = (0, 1) if r % 2 == 0 else (1, 0)
        for k in order:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            (fn_a, fn_b)[k]()
            end.record()
            end.synchronize()
            times[k].append(start.elapsed_time(end))
    return statistics.median(times[0]), statistics.median(times[1])


def k1_host_ms(fn, calls=50):
    """Host-clock ms of one call of fn, a call of the K1 wrapper, and of
    the two spans inside it: fused_binarize._launch (output allocation and
    the C call) and the C entry point alone (launch geometry and the
    launch). Medians over `calls` calls after one warm-up, with no
    synchronize between calls (the kernel is shorter than a call)."""
    from sdvpcmdecoder_tpu_torch.ops import _kernels
    from sdvpcmdecoder_tpu_torch.ops import fused_binarize as fb
    lib = _kernels.load("stc007_binarize")
    spans = {"wrapper": [], "launch": [], "c_entry": []}

    def timed(f, key):
        def call(*args, **kw):
            t0 = time.perf_counter()
            out = f(*args, **kw)
            spans[key].append(time.perf_counter() - t0)
            return out
        return call
    launch, entry = fb._launch, lib.stc007_binarize_frames
    fb._launch = timed(launch, "launch")
    lib.stc007_binarize_frames = timed(entry, "c_entry")
    try:
        whole = timed(fn, "wrapper")
        whole()
        torch.cuda.synchronize()
        for s in spans.values():
            s.clear()
        for _ in range(calls):
            whole()
        torch.cuda.synchronize()
    finally:
        fb._launch, lib.stc007_binarize_frames = launch, entry
    return {k: statistics.median(s) * 1e3 for k, s in spans.items()}


def cuda_profile(fn, calls, done):
    """torch.profiler's CUDA rows (key_averages) over `calls` calls of fn,
    after one warm-up call. CUPTI now and then hands back a trace without
    some of the launches it saw; a trace for which done(rows) is false is
    taken again, up to three times in all."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
        if done(rows):
            break
    return rows


def kernel_device_ms(fn, kernel_name, calls=5):
    """Mean device time of one CUDA kernel per call of fn, from
    torch.profiler's CUPTI trace of `calls` calls after one warm-up."""
    def kernel(rows):
        return [e for e in rows if kernel_name in e.key]
    rows = kernel(cuda_profile(
        fn, calls, lambda r: [e.count for e in kernel(r)] == [calls]))
    check(len(rows) == 1 and rows[0].count == calls,
          f"profiler saw {[(e.key, e.count) for e in rows]} for "
          f"{kernel_name}")
    return rows[0].self_device_time_total / calls / 1e3


def cuda_rows(fn):
    """What one call of fn puts on the card, after one warm-up call: the
    kernel names and the memory copies/sets among torch.profiler's CUDA
    rows, one entry per launch."""
    rows = {"kernels": [], "copies": []}
    for e in cuda_profile(fn, 1, bool):
        copy = "Memcpy" in e.key or "Memset" in e.key
        name = e.key if copy else e.key.removeprefix("void ") \
            .removeprefix("(anonymous namespace)::").split("(")[0]
        rows["copies" if copy else "kernels"] += [name] * e.count
    return rows


HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 peak rate
# The INT32 issue rate: 64 INT32 lanes per SM against the 128 FP32 lanes
# behind the 67 TFLOP/s float32 peak (which counts an FMA as 2), a quarter.
INT_OPS_PER_S = 67e12 / 4
OPS_PER_STEP = 8            # load, 2 compares, select, shift, or, and, xor
OUT_BYTES_PER_LINE = 49     # words 32, crc_read/crc_calc/hyst/shift 16,
#                             valid 1
SECTOR = 32                 # bytes: the memory's least transfer


def k1_bound(pixels, coords, batch, levels, limits):
    """(bound ms, "bytes" or "operations", bytes, ops) of one K1 call on
    pixels [F, L, W] and coords [F, 2].

    Bytes: of each row, the 32-byte sectors from the least to the largest
    bit-centre column of the shift stages its line reads (a line's result
    depends on no other pixel), plus the coordinates and levels read once
    and the outputs written once, over the memory rate. Ops: the Schmitt
    steps this data needs (the reads of the serial trial loop with early
    exit, counted from the plain version's picks) at OPS_PER_STEP over
    INT_OPS_PER_S. levels are [F] or [F, L]."""
    from sdvpcmdecoder_tpu_torch.formats import stc007
    from sdvpcmdecoder_tpu_torch.ops import binarize as bz
    F, L, W = pixels.shape
    n_h, n_s = limits[0] + 1, limits[1] + 1
    ref, black, white = (t[:, None].expand(F, L) if t.dim() == 1 else t
                         for t in levels)
    hs = torch.arange(n_h, device=pixels.device)
    ok = ((ref[..., None] - hs).clamp(min=1) > black[..., None]) \
        & ((ref[..., None] + hs).clamp(max=254) < white[..., None])
    h_pick = torch.where(batch.valid, batch.hyst, n_h)[..., None]
    full = (ok & (hs < h_pick)).sum(-1) * n_s       # every stage of h < h*
    last = torch.where(batch.valid, batch.shift + 1, 0)
    reads = 1 + full + last - ok[..., 0].long()     # (0, 0) read once
    # The last stage a line reads: all after a whole hysteresis row, else
    # those up to its pick, else only trial (0, 0)'s.
    top = torch.where(full > 0, n_s - 1,
                      torch.where(batch.valid, batch.shift, 0)).long()
    cols = bz.stc007_frame_bit_coords(coords, n_s, W).long()   # [F, S, 128]
    lo = cols.amin(-1).cummin(-1).values.gather(1, top)        # [F, L]
    hi = cols.amax(-1).cummax(-1).values.gather(1, top)
    row = pixels.data_ptr() % SECTOR + W * torch.arange(
        F * L, device=pixels.device).reshape(F, L)
    sectors = (row + hi) // SECTOR - (row + lo) // SECTOR + 1
    in_bytes = int(sectors.sum()) * SECTOR + sum(
        t.numel() * t.element_size() for t in (coords, *levels))
    n_bytes = in_bytes + F * L * OUT_BYTES_PER_LINE
    ops = int(reads.sum()) * stc007.BITS_PCM_DATA * OPS_PER_STEP
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, ops / INT_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", n_bytes, ops)


def tree_digest(path):
    """sha256 over the names and bytes of the files in a directory."""
    import hashlib
    h = hashlib.sha256()
    for p in sorted(Path(path).iterdir()):
        if p.is_file():
            h.update(p.name.encode() + p.read_bytes())
    return h.hexdigest()


def driver_run(jobs, tmp, tag, use_kernel, **kw):
    """DeviceBatchDecoder over `jobs` on the card. Returns (WAV bytes per
    job, the decoder, staging seconds, decode wall seconds), staging being
    the constructor (the first chunks, awaited as _await_staging does) plus
    the later chunks' stage_hbm time inside run(), and the decode wall the
    rest of run() up to a synchronize. The decoder's stage_t keeps only
    run()'s share of stage_hbm."""
    import os

    from sdvpcmdecoder_tpu_torch.pipeline import device_driver as dd
    t0 = time.perf_counter()
    dec = dd.DeviceBatchDecoder(
        [(cap, os.path.join(tmp, f"{tag}_{k}.wav"))
         for k, cap in enumerate(jobs)], device=DEVICE,
        use_kernel=use_kernel, **kw)
    t1 = time.perf_counter()
    dec.stage_t["stage_hbm"] = 0.0   # the constructor's share is t1 - t0
    dec.run()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    stage = t1 - t0 + dec.stage_t["stage_hbm"]
    wall = t2 - t1 - dec.stage_t["stage_hbm"]
    return ([open(j.out_path, "rb").read() for j in dec.jobs], dec, stage,
            wall)


def driver_device_busy(jobs, tmp, **kw):
    """(device busy ms, CUDA kernel and copy events, wall ms) of one
    kernel-path driver run under torch.profiler: the sum of the CUDA rows'
    self device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, _, _, wall = driver_run(jobs, tmp, "prof", True, **kw)
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    return (sum(e.self_device_time_total for e in rows) / 1e3,
            sum(e.count for e in rows), wall * 1e3)


def main():
    check(torch.cuda.is_available(), "no CUDA device "
          "(torch.cuda.is_available() is false)")
    from sdvpcmdecoder_tpu_torch.formats import stc007
    from sdvpcmdecoder_tpu_torch.ops import _kernels
    from sdvpcmdecoder_tpu_torch.ops import binarize as bz
    from sdvpcmdecoder_tpu_torch.ops import deinterleave as di
    from sdvpcmdecoder_tpu_torch.ops import device_stitch as ds
    from sdvpcmdecoder_tpu_torch.ops import fused_binarize as fb
    from sdvpcmdecoder_tpu_torch.pipeline import audio, decoder, wav
    from sdvpcmdecoder_tpu_torch.pipeline import device_driver as dd
    from sdvpcmdecoder_tpu_torch.synth import encoder as enc

    dev = torch.device(DEVICE)
    torch.cuda.set_device(dev)

    # -- phase 1: card and build -------------------------------------------
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card)   # as nvidia-smi gives it: name, power limit
    from concurrent.futures import ThreadPoolExecutor

    from sdvpcmdecoder_tpu_torch.ops import stitch_native as sn
    native_before = tree_digest(sn.NATIVE_SRC)
    pool = ThreadPoolExecutor(1)   # g++ for the native core beside nvcc
    native_build = pool.submit(sn.build, "stitchcore.cpp")
    build = _kernels.build("stc007_binarize")
    _kernels.load("stc007_binarize")
    usage = [ln.strip() for ln in build.log.splitlines()
             if "registers" in ln or "bytes stack" in ln]
    print(f"[build] stc007_binarize: {build.seconds} s nvcc "
          f"({build.path.name}); {' | '.join(usage)}")

    # -- phase 2: K1 against its plain version on the card -----------------
    errs = []
    nf, ni = CHECK_FRAMES, INSANE_FRAMES
    px, cd, _, _ = encode_frames(nf, 30.0, seed=1, device=dev)
    errs.append(compare_k1(f"NORMAL {nf} frames sigma=30", px, cd,
                           frame_levels(nf, dev), NORMAL))
    gen = torch.Generator().manual_seed(2)
    per_line = (torch.randint(100, 121, (nf, PAL_LINES), generator=gen,
                              dtype=torch.int32).to(dev),
                torch.full((nf, PAL_LINES), 20, dtype=torch.int32,
                           device=dev),
                torch.full((nf, PAL_LINES), 200, dtype=torch.int32,
                           device=dev))
    errs.append(compare_k1(f"NORMAL {nf} frames per-line levels", px, cd,
                           per_line, NORMAL))
    errs.append(compare_k1(f"INSANE {ni} frames sigma=30", px[:ni], cd[:ni],
                           frame_levels(ni, dev), INSANE))
    ragged = 300   # not a multiple of the 32-line tile
    errs.append(compare_k1(f"ragged 1 frame x {ragged} lines",
                           px[:1, :ragged].contiguous(), cd[:1],
                           frame_levels(1, dev), NORMAL))
    nr = ROUND_FRAMES
    errs.append(compare_k1(f"round shape {nr} frames sigma=30", px[:nr],
                           cd[:nr], frame_levels(nr, dev), NORMAL))
    errs.append(compare_k1("NTSC 4 frames x 490 lines",
                           px[:4, :490].contiguous(), cd[:4],
                           frame_levels(4, dev), NORMAL))
    # The marker fallback's batches: 64 single lines, each with its own
    # coordinates (v2d._marker_fallback).
    fb_px = px[0, :64].reshape(64, 1, WIDTH).contiguous()
    fb_cd = cd[:1].expand(64, 2) \
        + (torch.arange(64, device=dev) % 9 - 4)[:, None]
    errs.append(compare_k1("fallback shape 64 x 1 line", fb_px,
                           fb_cd.contiguous(), frame_levels(64, dev),
                           NORMAL))
    # stop < start: a negative pixel pitch, where C's `/` truncates and
    # torch's `//` floors; some coordinates past both edges.
    rng = np.random.default_rng(3)
    start = rng.integers(200, WIDTH + 40, 8)
    stop = start - rng.integers(1, 900, 8)
    stop[::3] = rng.integers(-300, 40, 3)
    rev = torch.from_numpy(np.stack([start, stop], 1)).to(dev)
    errs.append(compare_k1("stop < start, 8 frames INSANE", px[:8], rev,
                           frame_levels(8, dev), INSANE))
    # Rows the TMA cannot copy (a width or an address that is not a
    # multiple of 16 bytes): the kernel stages them with plain loads.
    for tag, x in plain_staged(px[:4, :300]).items():
        errs.append(compare_k1(f"{tag}, 4 frames x 300 lines INSANE", x,
                               cd[:4], frame_levels(4, dev), INSANE))
    del px, cd, per_line, fb_px

    # -- phase 3: the slice at full size -----------------------------------
    n_frames = FRAMES
    px, cd, left, right = encode_frames(n_frames, 10.0, seed=0, device=dev)
    levels = frame_levels(n_frames, dev)
    fb.stc007_fused_decode_frames.launches = 0
    res = decoder.decode_frames(px, cd, *levels, *NORMAL)
    torch.cuda.synchronize()
    launches = fb.stc007_fused_decode_frames.launches
    check(launches > 0, "decode_frames did not launch the K1 kernel")
    n_lines = n_frames * PAL_LINES
    n_pairs = 3 * (n_lines - stc007.MIN_DEINT_DATA)
    check(res.samples.dtype == torch.int16
          and tuple(res.samples.shape) == (n_pairs, 2),
          f"samples {res.samples.dtype}{tuple(res.samples.shape)}")
    check(bool(res.line_valid.all()), f"only {int(res.line_valid.sum())}/"
          f"{n_lines} lines valid")
    check(bool(res.sample_valid.all()), "invalid samples after ECC")
    samples = res.samples.cpu().numpy()
    expect = np.stack([stc007.expand_sample(torch.from_numpy(
        ch[:n_pairs])).numpy() for ch in (left, right)], axis=1)
    check(np.array_equal(samples, expect),
          "decoded samples differ from the encoder's input")
    out = audio.AudioProcessor().process(samples,
                                         res.sample_valid.cpu().numpy())
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "slice.wav"
        with wav.WavWriter(path, 44056) as w:
            w.write(out)
        back, rate = wav.read_wav(path)
    check(rate == 44056 and np.array_equal(back, samples),
          "WAV read back differs from the decoded samples")
    print(f"[slice] decode_frames 14-bit NORMAL {n_frames}x{PAL_LINES}x"
          f"{WIDTH}: K1 launches={launches}, lines valid "
          f"{n_lines}/{n_lines}, {n_pairs} stereo pairs equal the encoder's "
          f"input; AudioProcessor -> WavWriter -> read_wav equal")

    nm = MODE_FRAMES
    m = 3 * (nm * PAL_LINES - stc007.MIN_DEINT_DATA)
    for resolution, res_mode, name in (
            (16, di.RES_MODE_16BIT, "16-bit"),
            (16, di.RES_MODE_16BIT_AUTO, "16-bit-auto"),
            (14, di.RES_MODE_14BIT_AUTO, "14-bit-auto")):
        p8, c8, l8, r8 = encode_frames(nm, 10.0, seed=3, device=dev,
                                       resolution=resolution)
        lv8 = frame_levels(nm, dev)
        got = decoder.decode_frames(p8, c8, *lv8, *NORMAL, res_mode=res_mode)
        plain = decoder.decode_frames(p8, c8, *lv8, *NORMAL,
                                      res_mode=res_mode, use_kernel=False)
        for g, e in zip(got, plain):
            check(g.dtype == e.dtype and torch.equal(g, e),
                  f"{name}: kernel path differs from the plain path")
        if resolution == 16:
            want = np.stack([as_int16(l8[:m]), as_int16(r8[:m])], axis=1)
        else:
            want = np.stack([stc007.expand_sample(torch.from_numpy(
                ch[:m])).numpy() for ch in (l8, r8)], axis=1)
        check(np.array_equal(got.samples.cpu().numpy(), want)
              and bool(got.sample_valid.all()),
              f"{name}: samples differ from the {resolution}-bit input")
        print(f"[slice] decode_frames {name} on a {resolution}-bit stream, "
              f"{nm} frames: samples equal the input; kernel path == plain")

    # -- phase 4: one launch per call, and the timing of K1 ----------------
    glv = [t[0].expand(PAL_LINES) for t in levels]
    gcoords = (int(cd[0, 0]), int(cd[0, 1]))
    r = ROUND_FRAMES
    calls = {
        "stc007_fused_decode_frames": lambda: fb.stc007_fused_decode_frames(
            px[:r], cd[:r], *(t[:r] for t in levels), *NORMAL),
        "stc007_fused_decode": lambda: fb.stc007_fused_decode(
            px[0], gcoords, *glv, *NORMAL)}
    for name, fn in calls.items():
        rows = cuda_rows(fn)
        print(f"[launch] {name}: one call puts {len(rows['kernels'])} "
              f"kernel(s) {sorted(set(rows['kernels']))} and "
              f"{len(rows['copies'])} copies {rows['copies']} on the card "
              f"(torch.profiler CUDA rows)")
        check(rows["kernels"] == ["stc007_binarize_frames_kernel"]
              and not rows["copies"],
              f"{name}: not one kernel launch without copies: {rows}")

    # sigma ~30: the clean capture plus noise made on the card.
    gen = torch.Generator(device=dev).manual_seed(5)
    noisy_px = (px.float() + 28.3 * torch.randn(
        px.shape, generator=gen, device=dev)).round().clamp(0, 255) \
        .to(torch.uint8)
    k1_times = []
    for nf in (ROUND_FRAMES, n_frames):
        for mode, limits, frames in (("NORMAL sigma=10", NORMAL, px),
                                     ("INSANE sigma=30", INSANE, noisy_px)):
            x, c, lv = frames[:nf], cd[:nf], [t[:nf] for t in levels]
            w_ms, p_ms = median_ms_abab(
                lambda: fb.stc007_fused_decode_frames(x, c, *lv, *limits),
                lambda: bz.stc007_frame_decode(x, c, *lv, *limits))
            kern_ms = kernel_device_ms(
                lambda: fb.stc007_fused_decode_frames(x, c, *lv, *limits),
                "stc007_binarize_frames_kernel")
            host = k1_host_ms(
                lambda: fb.stc007_fused_decode_frames(x, c, *lv, *limits))
            batch = bz.stc007_frame_decode(x, c, *lv, *limits)
            bound_ms, bound_by, n_bytes, ops = k1_bound(x, c, batch, lv,
                                                        limits)
            t = dict(frames=nf, mode=mode, kernel_ms=kern_ms,
                     wrapper_ms=w_ms, plain_ms=p_ms, bound_ms=bound_ms,
                     bound_by=bound_by, bound_share=bound_ms / kern_ms,
                     bytes=n_bytes, ops=ops, host_ms=host,
                     valid=int(batch.valid.sum()))
            k1_times.append(t)
            print(f"[time] K1 {nf}x{PAL_LINES}x{WIDTH} {mode}: kernel "
                  f"{kern_ms} ms (torch.profiler, mean of 5); wrapper "
                  f"{w_ms} ms, plain {p_ms} ms (CUDA events, median of 5, "
                  f"alternating); wrapper host ms {host} (host clock, "
                  f"median of 50); bound {bound_ms} ms by {bound_by} "
                  f"({n_bytes} B at 3.35 TB/s, {ops} int ops at "
                  f"{INT_OPS_PER_S / 1e12} T/s); share of the bound "
                  f"{bound_ms / kern_ms}; valid {t['valid']}/"
                  f"{nf * PAL_LINES} on {card}")
    del noisy_px
    k_main = k1_times[0]   # the round's shape at NORMAL: the main path
    secs = []
    for _ in range(6):
        t0 = time.perf_counter()
        decoder.decode_frames(px, cd, *levels, *NORMAL)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    fps = n_frames / statistics.median(secs[1:])
    print(f"[time] decode_frames {n_frames}x{PAL_LINES}x{WIDTH} NORMAL: "
          f"{fps} frames/s (host clock to synchronize, median of 5 after "
          f"one warm-up) on {card}")

    # -- phase 5: K2 against its plain version on the card -----------------
    gen = torch.Generator().manual_seed(4)
    p1, c1, _, _ = encode_frames(1, 30.0, seed=5, device=dev)
    group, gcd = p1[0], c1[0]
    glev = (torch.randint(100, 121, (PAL_LINES,), generator=gen,
                          dtype=torch.int32).to(dev),
            torch.full((PAL_LINES,), 20, dtype=torch.int32, device=dev),
            torch.full((PAL_LINES,), 200, dtype=torch.int32, device=dev))
    errs2 = [compare_k2("NORMAL 588 lines sigma=30 per-line levels", group,
                        gcd, glev, NORMAL),
             compare_k2("INSANE 588 lines sigma=30 per-line levels", group,
                        gcd, glev, INSANE),
             compare_k2(f"ragged {ragged} lines", group[:ragged].contiguous(),
                        gcd, tuple(t[:ragged].contiguous() for t in glev),
                        NORMAL)]
    errs2 += [compare_k2(f"{tag}, {ragged} lines", x, gcd,
                         tuple(t[:ragged].contiguous() for t in glev), INSANE)
              for tag, x in plain_staged(group[:ragged]).items()]

    # -- phase 6: K2's path -- single-frame groups of the clean capture -----
    ng = GROUP_FRAMES
    want_words, want_crc = enc.blocks_to_lines(
        enc.samples_to_blocks(left, right), ng * PAL_LINES)
    lv1 = [t.expand(PAL_LINES).contiguous() for t in
           frame_levels(1, dev)]
    fb.stc007_fused_decode.launches = 0
    groups = [fb.stc007_fused_decode(px[f], (int(cd[f, 0]), int(cd[f, 1])),
                                     *lv1, *NORMAL) for f in range(ng)]
    torch.cuda.synchronize()
    launches2 = fb.stc007_fused_decode.launches
    check(launches2 == ng, f"K2 path launched {launches2} times, not {ng}")
    for f, g in enumerate(groups):
        lines = slice(f * PAL_LINES, (f + 1) * PAL_LINES)
        check(bool(g.valid.all())
              and np.array_equal(g.words.cpu().numpy(), want_words[lines])
              and np.array_equal(g.crc_read.cpu().numpy(), want_crc[lines]),
              f"K2 group {f}: lines invalid or words differ from the "
              f"encoder's line words")
    print(f"[k2-path] stc007_fused_decode on {ng} single-frame groups of "
          f"588x{WIDTH}: K2 launches={launches2}; every line valid, words "
          f"and read CRC equal the encoder's")

    # -- phase 7: the chip-resident round at full width ---------------------
    F, nr = ROUND_FRAMES, ROUNDS
    n_round_frames = F * nr
    lpf = PAL_LINES // 2
    tables = ds.RoundTables().to(dev)
    rows0 = dd._RoundRows(F, lpf, 0, 0, 0, lpf, True, device=dev)
    rows = dd._RoundRows(F, lpf, stc007.MIN_DEINT_DATA, 0, 0, lpf, True,
                         device=dev)
    check(rows.can_chain, "round geometry cannot chain")
    clean = encode_frames(n_round_frames, 10.0, seed=6, device=dev)
    noisy = encode_frames(n_round_frames, 30.0, seed=7, device=dev)
    knock = np.random.default_rng(8).choice(n_round_frames * PAL_LINES, 300,
                                            replace=False)
    noisy[0].view(-1, WIDTH)[torch.from_numpy(knock).to(dev)] = 0
    staged = [("clean sigma=10", clean), ("sigma=30, 300 lines zeroed", noisy)]
    fb.stc007_fused_decode_frames.launches = 0
    kern =[run_rounds(cap[0], cap[1], rows0, rows, tables, True)
            for _, cap in staged]
    torch.cuda.synchronize()
    launches_round = fb.stc007_fused_decode_frames.launches
    check(launches_round == len(staged) * nr,
          f"K1 launched {launches_round} times in {len(staged) * nr} rounds")
    names = ("out", "wflat_rw", "words_tail", "ok8_tail", "carry_next_w",
             "carry_next_ok")
    for (name, cap), k_res in zip(staged, kern):
        p_res = run_rounds(cap[0], cap[1], rows0, rows, tables, False)
        for r in range(nr):
            for what, g, e in zip(names, k_res[r], p_res[r]):
                check(g.dtype == e.dtype and torch.equal(g, e),
                      f"round {r} ({name}): {what} with the kernel differs "
                      f"from the plain round")
        print(f"[round] {name}: {nr} rounds x {F} frames, all six outputs "
              f"with K1 equal the plain round byte for byte")
    # The clean capture decodes exactly. Conv block b of pair i in chained
    # round r (n0 = 112) reads the buffer rows from i*Ls - 112 + b on (the
    # carry rows for i = 0 hold the last 112 lines of the frame before the
    # prev slot, as carry_next_rows gathers them), and buffer row R of
    # round r is stream line (r*F - 1)*Ls + R: so it is the encoder's
    # block k = (r*F + i - 1)*Ls - 112 + b, whose six samples are
    # left/right[3k], [3k+1], [3k+2].
    Ls = PAL_LINES
    _, _, c_left, c_right = clean
    for r, res in enumerate(kern[0]):
        (crc_read, valid, dup, cb, crcm, packed_conv, samples_conv,
         _, _) = ds.unpack_round(res[0].cpu().numpy(), F, Ls,
                                 (rows if r else rows0).Bc)
        check(valid.all() and not dup.any() and crcm.all(),
              f"clean round {r}: valid {int(valid.sum())}, dup "
              f"{int(dup.sum())}, crcm {int(crcm.sum())} of {F * Ls}")
        if r == 0:
            continue
        for i, (ofs, nb) in enumerate(rows.meta_conv):
            k = (r * F + i - 1) * Ls - stc007.MIN_DEINT_DATA + np.arange(nb)
            want = np.stack([ch[3 * k + j] for j in range(3)
                             for ch in (c_left, c_right)], axis=1)
            want = stc007.expand_sample(torch.from_numpy(want)).numpy()
            check(np.array_equal(samples_conv[ofs:ofs + nb], want)
                  and ((packed_conv[ofs:ofs + nb] & 0xFF) == 0xFF).all(),
                  f"clean round {r} pair {i}: conv samples differ from the "
                  f"encoder's input")
    print(f"[round] clean: every line valid, no dup, every crcm set; the "
          f"conv samples of rounds 1-{nr - 1} ({(nr - 1) * rows.Bc} blocks) "
          f"equal the encoder's input; K1 launches={launches_round} in "
          f"{len(staged) * nr} rounds")

    # -- phase 8: timing of the round and of K2 -----------------------------
    cpx, ccd = clean[0], clean[1]
    state1 = dd.RoundState(*kern[0][0][2:])
    par1 = round_params(ccd[F:2 * F], di.RES_MODE_14BIT, dev)

    def one_round(use_kernel):
        return lambda: dd.run_round(
            cpx[F:2 * F], par1, state1, rows, en_p=True, en_q=True,
            m2=False, hyst_limit=NORMAL[0], shift_limit=NORMAL[1],
            use_kernel=use_kernel, chained=True, tables=tables)

    rk_ms, rp_ms = median_ms_abab(one_round(True), one_round(False))
    print(f"[time] steady_round_packed chained round {F}x{PAL_LINES}x"
          f"{WIDTH} NORMAL: kernel path {rk_ms} ms = {F / rk_ms * 1e3} "
          f"frames/s; plain path {rp_ms} ms = {F / rp_ms * 1e3} frames/s "
          f"(CUDA events, median of 5, alternating) on {card}")
    gc = (int(gcd[0]), int(gcd[1]))
    k2_call = (lambda: fb.stc007_fused_decode(group, gc, *glev, *NORMAL))
    k2w_ms, k2p_ms = median_ms_abab(
        k2_call,
        lambda: bz.stc007_frame_decode(group[None], gcd[None],
                                       *(t[None] for t in glev), *NORMAL))
    k2_ms = kernel_device_ms(k2_call, "stc007_binarize_frames_kernel")
    k2_batch = bz.stc007_frame_decode(group[None], gcd[None],
                                      *(t[None] for t in glev), *NORMAL)
    k2_bound, k2_by, k2_bytes, k2_ops = k1_bound(
        group[None], gcd[None], k2_batch, [t[None] for t in glev], NORMAL)
    print(f"[time] K2 stc007_fused_decode {PAL_LINES}x{WIDTH} NORMAL "
          f"sigma=30 per-line levels: kernel {k2_ms} ms (torch.profiler, "
          f"mean of 5); wrapper {k2w_ms} ms, plain stc007_frame_decode "
          f"{k2p_ms} ms (CUDA events, median of 5, alternating); bound "
          f"{k2_bound} ms by {k2_by} ({k2_bytes} B, {k2_ops} int ops); "
          f"share of the bound {k2_bound / k2_ms} on {card}")

    # -- phase 9: the native stitcher core (built beside nvcc in phase 1) --
    nb = native_build.result()
    pool.shutdown()
    print(f"[native] stitchcore.cpp: {nb.seconds} s g++ {' '.join(nb.flags)}"
          f" -> {nb.path}; available={sn.available()}")
    check(sn.available(), "the native core did not load")

    # -- phase 10: captures (y4m, the JAX driver tests' recipe) -------------
    import hashlib
    import os
    tmpdir = tempfile.TemporaryDirectory()
    tmp = tmpdir.name
    t0 = time.perf_counter()
    golden = {"pal": write_capture(os.path.join(tmp, "pal.y4m"), 12, 294,
                                   seed=1),
              "ntsc": write_capture(os.path.join(tmp, "ntsc.y4m"), 10, 245,
                                    seed=1)}
    big = [write_capture(os.path.join(tmp, f"big{s}.y4m"), DRIVER_FRAMES,
                         294, seed=s) for s in DRIVER_SEEDS]
    noisy_cap = write_capture(os.path.join(tmp, "noisy.y4m"), NOISY_FRAMES,
                              294, seed=2, noise=26.0)
    print(f"[captures] golden PAL 12 and NTSC 10 frames, 2 x "
          f"{DRIVER_FRAMES} PAL frames (seeds {DRIVER_SEEDS}), noisy "
          f"{NOISY_FRAMES} PAL frames sigma=26: written in "
          f"{time.perf_counter() - t0:.2f} s")

    # -- phase 11: golden WAVs, byte-identical to the JAX package's --------
    launches_golden = 0
    for name, cap in golden.items():
        lpf = 294 if name == "pal" else 245
        fb.stc007_fused_decode_frames.launches = 0
        wavs, dec, _, _ = driver_run([cap], tmp, f"golden_{name}", True,
                                     lines_per_field=lpf, hyst_limit=2,
                                     shift_limit=1, frames_per_round=5)
        n = fb.stc007_fused_decode_frames.launches
        launches_golden += n
        j = dec.jobs[0]
        digest = hashlib.sha256(wavs[0]).hexdigest()
        check(digest == GOLDEN_SHA256[name],
              f"golden {name}: WAV sha256 {digest} is not the JAX "
              f"package's {GOLDEN_SHA256[name]}")
        check(n == len(j.round_chained) + j.driver.fallback_batches,
              f"golden {name}: K1 launched {n} times")
        print(f"[golden] {name}: WAV sha256 {digest} equals the JAX "
              f"package's; rounds {len(j.round_chained)}, K1 launches {n}")

    # -- phase 12: the driver at full width, timed -------------------------
    dkw = dict(lines_per_field=294, hyst_limit=NORMAL[0],
               shift_limit=NORMAL[1], frames_per_round=ROUND_FRAMES,
               hbm_frames=DRIVER_HBM)
    runs = {}
    for use_kernel in (True, False):
        fb.stc007_fused_decode_frames.launches = 0
        res = driver_run(big, tmp, f"big{int(use_kernel)}", use_kernel,
                         **dkw)
        runs[use_kernel] = res + (fb.stc007_fused_decode_frames.launches,)
    wk, deck, stage_k, wall_k, launches_driver = runs[True]
    wp, decp, stage_p, wall_p, launches_plain = runs[False]
    check(wk == wp, "driver: the kernel path's WAVs differ from the plain "
          "path's")
    n_rounds = sum(len(j.round_chained) for j in deck.jobs)
    n_fb = sum(j.driver.fallback_batches for j in deck.jobs)
    check(launches_driver == n_rounds + n_fb and launches_plain == 0,
          f"driver: K1 launched {launches_driver} times for {n_rounds} "
          f"rounds + {n_fb} fallback batches (plain path: {launches_plain})")
    for j in deck.jobs + decp.jobs:
        check(not j.round_chained[0] and all(j.round_chained[1:]),
              f"driver: rounds chained {j.round_chained}")
        check(j.stats.lines_valid == j.stats.lines_total
              == DRIVER_FRAMES * PAL_LINES,
              f"driver: {j.stats.lines_valid}/{j.stats.lines_total} lines "
              f"valid")
    audio_s = 0.0
    for k in range(len(big)):
        back, rate = wav.read_wav(deck.jobs[k].out_path)
        audio_s += len(back) / rate
    n_fr = DRIVER_FRAMES * len(big)
    for tag, dec, stage, wall in (("kernel", deck, stage_k, wall_k),
                                  ("plain", decp, stage_p, wall_p)):
        st = {k: round(dec.stage_t[k], 4) for k in (
            "dispatch", "prescan", "materialize", "finalize", "assemble",
            "stitch", "audio", "wav", "stage_hbm")}
        print(f"[driver] {tag} path, {len(big)} x {DRIVER_FRAMES} PAL frames "
              f"NORMAL, {ROUND_FRAMES} frames per round, {DRIVER_HBM}-frame "
              f"staging chunks: decode wall {wall} s (staging {stage} s "
              f"excluded) = {n_fr / wall} frames/s = {audio_s / wall} s of "
              f"audio per s; rounds {n_rounds}; stage_t {st} on {card}")
    busy_ms, n_dev, prof_ms = driver_device_busy(big, tmp, **dkw)
    print(f"[driver] kernel path under torch.profiler: device busy "
          f"{busy_ms} ms over {n_dev} CUDA events (profiled wall {prof_ms} "
          f"ms); device idle share of the timed run "
          f"{1 - busy_ms / (wall_k * 1e3)} on {card}")
    print(f"[driver] WAVs of both paths byte-equal ({audio_s} s of audio); "
          f"every round after each capture's first chained; every line "
          f"valid; K1 launches {launches_driver} = {n_rounds} rounds + "
          f"{n_fb} fallback batches")

    # -- phase 13: a noisy capture (fallback frames, marker re-decode) -----
    nkw = dict(lines_per_field=294, hyst_limit=2, shift_limit=1,
               frames_per_round=5)
    fb.stc007_fused_decode_frames.launches = 0
    wn, decn, _, wall_n = driver_run([noisy_cap], tmp, "noisy1", True, **nkw)
    launches_noisy = fb.stc007_fused_decode_frames.launches
    wnp, _, _, _ = driver_run([noisy_cap], tmp, "noisy0", False, **nkw)
    jn = decn.jobs[0]
    check(wn == wnp, "noisy: the kernel path's WAV differs from the plain "
          "path's")
    check(jn.driver.fallback_batches >= 1 and launches_noisy
          == len(jn.round_chained) + jn.driver.fallback_batches,
          f"noisy: {launches_noisy} K1 launches, {len(jn.round_chained)} "
          f"rounds, {jn.driver.fallback_batches} fallback batches")
    print(f"[noisy] {NOISY_FRAMES} PAL frames sigma=26: kernel and plain WAVs "
          f"byte-equal; lines valid {jn.stats.lines_valid}/"
          f"{jn.stats.lines_total}; K1 launches {launches_noisy} = "
          f"{len(jn.round_chained)} rounds + {jn.driver.fallback_batches} "
          f"fallback re-decode batches; wall {wall_n} s")
    tmpdir.cleanup()
    check(tree_digest(sn.NATIVE_SRC) == native_before,
          "sdvpcmdecoder_tpu/native/ changed during the run")
    print("[native] sdvpcmdecoder_tpu/native/ unchanged by the run")

    launches_k1 = {"decode_frames": launches,
                   "steady_round_packed": launches_round,
                   "driver_golden": launches_golden,
                   "driver_full_width": launches_driver,
                   "driver_noisy": launches_noisy}
    # ms: the kernel's device time at the main path's shape (the round's
    # 16 x 588 x 1152, NORMAL); the other shapes and modes in "timings".
    # No single PyTorch call computes the trial grid: library_ms is null.
    print(json.dumps({"kernels": [
        dict(KERNEL, launches=sum(launches_k1.values()),
             max_abs_err=max(errs), ms=k_main["kernel_ms"],
             plain_ms=k_main["plain_ms"], bound_ms=k_main["bound_ms"],
             bound_by=k_main["bound_by"], library_ms=None,
             bound_share=k_main["bound_share"],
             wrapper_ms=k_main["wrapper_ms"], launches_by_path=launches_k1,
             timings=k1_times),
        dict(KERNEL2, launches=launches2, max_abs_err=max(errs2),
             ms=k2_ms, plain_ms=k2p_ms, bound_ms=k2_bound, bound_by=k2_by,
             library_ms=None, bound_share=k2_bound / k2_ms,
             wrapper_ms=k2w_ms)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
