#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (sdvpcmdecoder_tpu_torch).

Builds the CUDA kernels of the STC-007 decode chain from csrc/ (K1, the
per-frame binarize, and K2, the per-group binarize: two entry points of one
source) and, with g++ at the same time, the native stitcher core from
the port's own native/stitchcore.cpp; checks each kernel against its
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
capture that takes the marker-fallback re-decode. The drivers replay each
round as a CUDA graph (ops/round_graph), as every phase runs them; G1 holds
the STC-007 driver's graph route against its eager route (graphs=False):
every round's outputs byte-equal, 5 timed pairs, launches, device idle
share and the host's time per round, and the chained round alone; G2 does
the same for the PCM-1 and PCM-16x0 driver. Then the reference-level
sweep, K1 launched once per level against the plain sweep (every field at
every level, 64 launches and no copy per call, both routes timed); the
driver at the CLI's default quality (the prescan sweep and the sweep of
failed lines) and at INSANE (the full sweep), kernel route against plain
route; and the CLI (sdvpcmdecoder_tpu_torch.__main__) under every backend,
its WAVs held to the hashes of the JAX package's CLI, once as a
`python -m` subprocess; PCM-1 and PCM-16x0 (P1-P5); G3, the streaming
backend and the stream chain with their device calls replayed as CUDA
graphs against the same calls eager (BatchDecoder.run_tpu on the timed
frames, the PCM-1/16x0 round loop, the 64-level sweep at NORMAL and
INSANE, the 128-frame decode_frames and the mesh step; 5 alternating
pairs a cell, results byte-equal, one graph launch a replay); G4, the
stitcher's device seam route (BatchDecoder(seam_backend="tpu").run_tpu:
every block eval and padding search of the stitch a J9 or J10 call on the
card, replayed as CUDA graphs and eager) on the timed frames, the noisy
capture and an M2 capture, its WAVs equal to the default route's; then
the ingest surface and multi-GPU (C1-C9): the golden PAL capture in AVI and
Matroska files of each lossless codec through the CLI and the driver,
each codec's read time, dropped slots, 1 and 2 concurrent
ShardedBatchDecoder shards on one card, the mesh step, a 720-px capture,
the ArVid dump and Queue 3's paths (M2, BFF, 16-bit, forced coordinates,
several captures at once), all held to the JAX package's hashes; and
(S1) a copy of sdvpcmdecoder_tpu_torch/ and this script alone, run in a
subprocess with JAX and the JAX package blocked, which builds K1, the
native core and the loader into its own build/, holds K1 against plain
and decodes golden captures through the CLI, the driver, PCM-1 and a
ULY0 AVI. Times the kernels, their plain versions, the sweep, the chain,
the round, the driver, the codecs, the CLI and S1's builds. Needs one
NVIDIA GPU; from the repository root:

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
SWEEP_FRAMES = 4      # sweep-vs-plain checks on noisy frames
SWEEP_CAP_FRAMES = 16  # the capture whose failed lines take the NORMAL sweep
SWEEP_CAP_SIGMA = 34.0
SWEEP_LEVELS = np.arange(254, 1, -4, dtype=np.int32)   # V2DDriver's grid
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
# sha256 of the WAV the JAX package's CLI writes,
#     python -m sdvpcmdecoder_tpu cap.y4m -o out.wav --quality normal
# under every --backend (native, tpu, device and auto write the same
# bytes) and with --quality insane --backend tpu --batch 4 (the P/Q codes
# repair what NORMAL leaves invalid, so both qualities end in one WAV),
# for the golden PAL capture and for CLI_NOISY, a capture whose failed
# lines take the level sweep; tests/test_torch_cli.py recomputes them from
# the JAX package's CLI.
CLI_NOISY = dict(n_frames=6, lpf=294, seed=4, noise=34.0)
GOLDEN_CLI_SHA256 = {
    "pal": GOLDEN_SHA256["pal"],
    "noisy": "75a9cfe7dfdc282d973fb0950160b03d76791be0dbc28fb63b8f1ae0a6471c97",
}
CLI_GOLDEN_RUNS = (   # (quality, backend, extra arguments)
    ("normal", "device", []), ("normal", "tpu", []),
    ("normal", "native", []), ("normal", "auto", []),
    ("insane", "tpu", ["--batch", "4"]))


def capture_frames(n_frames, lpf, seed, noise=0.0, width=WIDTH, ppb=8.0):
    """STC-007 frames [n_frames, 2 * lpf, width] u8 from the port's encoder
    (ppb px per bit, the fields of a frame interleaved): the recipe of the
    JAX package's driver tests."""
    from sdvpcmdecoder_tpu_torch.synth import encoder as enc
    rng = np.random.default_rng(seed)
    n = 3 * n_frames * 2 * lpf
    frames = enc.encode_fields(rng.integers(1, 1 << 14, n),
                               rng.integers(1, 1 << 14, n), n_frames,
                               lines_pf=lpf)
    vids = np.zeros((n_frames, 2 * lpf, width), np.uint8)
    for f, fr in enumerate(frames):
        pixels, _ = enc.render_lines(fr["line_words"], fr["crcs"],
                                     width=width, ppb=ppb)
        L = pixels.shape[0]
        if noise:
            pixels = np.clip(pixels.astype(np.int16)
                             + rng.normal(0, noise, pixels.shape), 0, 255) \
                .astype(np.uint8)
        vids[f, 0::2] = pixels[:L // 2]
        vids[f, 1::2] = pixels[L // 2:]
    return vids


def write_capture(path, n_frames, lpf, seed, noise=0.0):
    """A y4m STC-007 capture of n_frames frames, 2 * lpf lines x WIDTH px
    (capture_frames at 8 px per bit). Returns the path."""
    from sdvpcmdecoder_tpu_torch.pipeline import ingest
    ingest.write_y4m(path, capture_frames(n_frames, lpf, seed, noise))
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


def compare_sweep(tag, px, cd, black, white, limits):
    """The level sweep through K1 against the plain sweep on the same
    inputs: every field at every level, and pick_ref_sweep's picks of
    both. Returns the max abs difference (0 when equal)."""
    from sdvpcmdecoder_tpu_torch.ops import binarize as bz
    from sdvpcmdecoder_tpu_torch.ops import fused_binarize as fb
    levels = torch.from_numpy(SWEEP_LEVELS).to(px.device)
    got = fb.stc007_ref_sweep_decode(px, cd, black, white, levels, *limits)
    expect = bz.stc007_ref_sweep_decode(px, cd, black, white, levels,
                                        *limits)
    return sweeps_equal(tag, got, expect, px.shape[:2], black, white, limits)


def sweeps_equal(tag, got, expect, shape, black, white, limits):
    """compare_sweep's checks on the results `got` (K1 route) and `expect`
    (plain route) of one sweep of F x L = `shape` lines."""
    from sdvpcmdecoder_tpu_torch.ops import binarize as bz
    torch.cuda.synchronize()
    levels = torch.from_numpy(SWEEP_LEVELS).to(black.device)
    R, (F, L) = len(SWEEP_LEVELS), shape
    err = 0
    for name, e in expect.items():
        g = got[name]
        check(g.dtype == e.dtype and g.shape == e.shape
              and g.shape[:3] == (R, F, L),
              f"sweep {tag}: {name} {g.dtype}{tuple(g.shape)} vs plain "
              f"{e.dtype}{tuple(e.shape)}")
        err = max(err, int((g.long() - e.long()).abs().max()))
    picks = [bz.pick_ref_sweep(*(sw[k].reshape(R, F * L).cpu().numpy()
                                 for k in ("valid", "crc", "hyst", "shift")))
             for sw in (got, expect)]
    check(all(np.array_equal(a, b) for a, b in zip(*picks)),
          f"sweep {tag}: pick_ref_sweep differs between the routes")
    lv = levels[:, None]
    outside = ((lv <= black[None]) | (lv >= white[None]))[..., None] \
        .expand(R, F, L)
    check(not bool(got["valid"][outside].any()),
          f"sweep {tag}: a level outside (black, white) read valid")
    print(f"[sweep] {tag}: F={F} L={L} limits={limits} levels={R} "
          f"({int(outside[:, :, 0].sum())} frame-levels outside (black, "
          f"white), none valid) valid={int(got['valid'].sum())}/{R * F * L} "
          f"lines picked={int((picks[0][0] >= 0).sum())}/{F * L} "
          f"max_abs_err={err} (valid, crc, hyst, shift, words at every "
          f"level; equal picks)")
    check(err == 0, f"sweep {tag}: K1 route disagrees with the plain sweep")
    return err


def dim_lines(frame, rows, lo=5, hi=60):
    """frame [L, W] u8 with lines `rows` rescaled from 20..200 to lo..hi
    (lines too dim for the frame's reference level)."""
    out = frame.float()
    out[rows] = lo + (out[rows] - 20) * (hi - lo) / (200 - 20)
    return out.round().clamp(0, 255).to(torch.uint8)


def cli_run(argv):
    """The port's CLI in this process: (exit code, wall seconds)."""
    from sdvpcmdecoder_tpu_torch.__main__ import main as cli_main
    t0 = time.perf_counter()
    rc = cli_main(argv)
    torch.cuda.synchronize()
    return rc, time.perf_counter() - t0


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
    taken again, up to five times in all."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()   # the tracer is up before a launch
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
        if done(rows):
            break
    return rows


def kernel_device_ms(fn, kernel_name, calls=5):
    """Mean device time of one launch of a CUDA kernel, from
    torch.profiler's CUPTI trace of `calls` calls of fn (one launch each)
    after one warm-up. A trace that still lacks some of the launches after
    cuda_profile's retakes gives the mean over the launches it holds."""
    def kernel(rows):
        return [e for e in rows if kernel_name in e.key]
    rows = kernel(cuda_profile(
        fn, calls, lambda r: [e.count for e in kernel(r)] == [calls]))
    check(len(rows) == 1 and 0 < rows[0].count <= calls,
          f"profiler saw {[(e.key, e.count) for e in rows]} for "
          f"{kernel_name} in {calls} calls")
    if rows[0].count < calls:
        print(f"[profile] {kernel_name}: the trace holds {rows[0].count} of "
              f"{calls} launches; mean over those")
    return rows[0].self_device_time_total / rows[0].count / 1e3


def cuda_rows(fn, launches=1):
    """What one call of fn puts on the card, after one warm-up call: the
    kernel names and the memory copies/sets among torch.profiler's CUDA
    rows, one entry per launch. A trace with fewer than `launches` rows is
    taken again (cuda_profile)."""
    rows = {"kernels": [], "copies": []}
    for e in cuda_profile(
            fn, 1, lambda r: sum(e.count for e in r) >= launches):
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
    tr = traced(lambda: driver_run(jobs, tmp, "prof", True, **kw))
    return tr["busy_ms"], tr["kernel_rows"] + tr["copy_rows"], \
        tr["result"][3] * 1e3


def traced(fn):
    """One call of fn under torch.profiler (CPU and CUDA activity): its
    result; the device's busy ms (the CUDA rows' self device time); the
    CUDA kernel rows and copy/set rows; and the host's calls into the CUDA
    runtime that put work on the card (kernel and graph launches, copies
    and sets), by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()   # the tracer is up before a launch
        result = fn()
        torch.cuda.synchronize()
    rows = prof.key_averages()
    dev_rows = [e for e in rows if e.device_type == DeviceType.CUDA]
    copies = [e for e in dev_rows if "Memcpy" in e.key or "Memset" in e.key]
    host = {e.key: e.count for e in rows
            if e.device_type == DeviceType.CPU and e.key.startswith("cu")
            and any(w in e.key for w in ("Launch", "Memcpy", "Memset"))}
    return dict(result=result,
                busy_ms=sum(e.self_device_time_total for e in dev_rows)
                / 1e3,
                kernel_rows=sum(e.count for e in dev_rows)
                - sum(e.count for e in copies),
                copy_rows=sum(e.count for e in copies), host_calls=host,
                graph_launches=host.get("cudaGraphLaunch", 0))


GRAPH_PAIRS = 5   # G1/G2: graphs=True and graphs=False, alternating


def graph_round_stats(graph_round, eager_round):
    """One round as a replay of its graph (graph_round: run_round through
    a RoundGraphs, its key already captured) against the eager round: the
    outputs equal, CUDA-event ms of each (median of 5, alternating) and
    one call of each under torch.profiler, the replay one graph
    launch."""
    flat = lambda r: [r] if isinstance(r, torch.Tensor) \
        else [r[0], r[1], *r[2]]
    check(all(torch.equal(a, b) for a, b in zip(flat(graph_round()),
                                                flat(eager_round()))),
          "the replayed round differs from the eager round")
    graph_ms, eager_ms = median_ms_abab(graph_round, eager_round)
    tr_g, tr_e = traced(graph_round), traced(eager_round)
    check(tr_g["graph_launches"] == 1,
          f"{tr_g['graph_launches']} graph launches in one replay")
    return dict(graph_ms=graph_ms, eager_ms=eager_ms,
                graph_kernel_rows=tr_g["kernel_rows"],
                eager_kernel_rows=tr_e["kernel_rows"],
                graph_host_calls=tr_g["host_calls"],
                eager_host_calls=tr_e["host_calls"],
                graph_busy_ms=tr_g["busy_ms"], eager_busy_ms=tr_e["busy_ms"])


def round_graph_phase(tag, module, cls, caps, tmp, card, n_frames, **kw):
    """Phases G1 (STC-007) and G2 (PCM): the driver `cls` over `caps`
    with each round a CUDA graph replay (graphs=True) and with its ops
    eager (graphs=False). One recorded run per route: every round's
    outputs (`module.run_round`'s, copied as they return) byte-equal;
    then GRAPH_PAIRS timed pairs in alternating order (WAVs equal, K1
    launches per run, the host ms of each run_round call by kind: a key's
    eager first use, its capture (with the replay that follows it) or a
    replay), one profiled run per route (device busy ms and idle share,
    CUDA kernel rows, host runtime calls per round), the graph counters.
    Returns the measurements and the WAVs."""
    from sdvpcmdecoder_tpu_torch.ops import fused_binarize as fb
    k1 = lambda: fb.stc007_fused_decode_frames.launches
    run = lambda g, name: timed_driver_run(cls, caps, tmp, f"{tag}_{name}",
                                         graphs=g, **kw)
    recorded, wav = {}, {}
    orig = module.run_round

    def recording(*a, **k):
        res = orig(*a, **k)
        ts = [res] if isinstance(res, torch.Tensor) \
            else [res[0], res[1], *res[2]]
        recorded[k["graphs"] is not None].append([t.clone() for t in ts])
        return res

    module.run_round = recording
    try:
        for g in (True, False):
            recorded[g] = []
            wav[g], dec, _, _ = run(g, f"rec{int(g)}")
    finally:
        module.run_round = orig
    check(wav[True] == wav[False], f"{tag}: the graph route's WAVs differ "
          f"from the eager route's")
    check(len(recorded[True]) == len(recorded[False]) > 0,
          f"{tag}: {len(recorded[True])} rounds under graphs, "
          f"{len(recorded[False])} eager")
    for r, (a, b) in enumerate(zip(recorded[True], recorded[False])):
        for i, (x, y) in enumerate(zip(a, b)):
            check(x.dtype == y.dtype and torch.equal(x, y),
                  f"{tag}: round {r} output {i} differs between the graph "
                  f"and the eager route")
    n_rounds = len(recorded[True])
    del recorded
    call_ms = {True: {}, False: {}}

    def timed(*a, **k):
        g = k["graphs"]
        seen = (g.eager_rounds, g.captures) if g is not None else None
        t0 = time.perf_counter()
        res = orig(*a, **k)
        ms = (time.perf_counter() - t0) * 1e3
        kind = "eager" if g is None or g.eager_rounds > seen[0] \
            else "capture" if g.captures > seen[1] else "replay"
        call_ms[g is not None].setdefault(kind, []).append(ms)
        return res

    fps = {True: [], False: []}
    walls = {True: [], False: []}
    launches = {True: set(), False: set()}
    counters = set()
    module.run_round = timed
    try:
        for pair in range(GRAPH_PAIRS):
            for g in ((True, False) if pair % 2 == 0 else (False, True)):
                n0 = k1()
                wavs, dec, _, wall = run(g, f"t{int(g)}")
                launches[g].add(k1() - n0)
                check(wavs == wav[True], f"{tag}: timed run's WAVs differ "
                      f"(graphs={g})")
                fps[g].append(n_frames / wall)
                walls[g].append(wall)
                if g:
                    gr = dec.graphs
                    counters.add((gr.eager_rounds, gr.captures, gr.replays))
                    check(gr.eager_rounds == len(gr._graphs)
                          and gr.replays == n_rounds - gr.eager_rounds,
                          f"{tag}: {n_rounds} rounds, eager_rounds "
                          f"{gr.eager_rounds} over {len(gr._graphs)} keys,"
                          f" replays {gr.replays}")
    finally:
        module.run_round = orig
    check(len(launches[True]) == 1 and launches[True] == launches[False],
          f"{tag}: K1 launches per run {launches}")
    prof = {}
    for g in (True, False):
        tr = traced(lambda: run(g, f"p{int(g)}"))
        dec = tr["result"][1]
        replays = dec.graphs.replays if g else 0
        check(tr["graph_launches"] == replays,
              f"{tag}: {tr['graph_launches']} graph launches for "
              f"{replays} replayed rounds")
        med = statistics.median(walls[g]) * 1e3
        prof[g] = dict(busy_ms=tr["busy_ms"], idle_share=1 - tr["busy_ms"]
                       / med, kernel_rows_per_round=tr["kernel_rows"]
                       / n_rounds, copy_rows=tr["copy_rows"],
                       host_calls_per_round={
                           k: v / n_rounds
                           for k, v in sorted(tr["host_calls"].items())},
                       graph_launches=tr["graph_launches"])
    res = {}
    for g, route in ((True, "graph"), (False, "eager")):
        q1, med, q3 = quartiles(fps[g])
        res[route] = dict(fps_median=med, fps_q1=q1, fps_q3=q3,
                          fps_runs=fps[g], k1_launches=min(launches[g]),
                          round_host_ms={
                              kind: dict(calls=len(v),
                                         median=statistics.median(v),
                                         total=sum(v) / GRAPH_PAIRS)
                              for kind, v in call_ms[g].items()},
                          **prof[g])
    (eager_rounds, captures, replays), = counters
    res.update(rounds=n_rounds, eager_rounds=eager_rounds,
               captures=captures, replays=replays, card=card)
    for route in ("graph", "eager"):
        r = res[route]
        print(f"[{tag}] {route} route, {len(caps)} x {n_frames // len(caps)}"
              f" frames: {r['fps_median']} frames/s (median of "
              f"{GRAPH_PAIRS}, quartiles {r['fps_q1']}, {r['fps_q3']}; "
              f"decode wall, staging apart); K1 launches {r['k1_launches']}"
              f" a run; device busy {r['busy_ms']} ms = idle share "
              f"{r['idle_share']} of the median wall; per round "
              f"{r['kernel_rows_per_round']} CUDA kernel rows and host "
              f"calls {r['host_calls_per_round']} (torch.profiler); host ms "
              f"of run_round by kind (calls over the {GRAPH_PAIRS} runs, "
              f"median, total a run) {r['round_host_ms']} on {card}")
    print(f"[{tag}] {n_rounds} rounds a run: eager_rounds {eager_rounds}, "
          f"captures {captures}, replays {replays} (= rounds less the "
          f"eager first use of each key); every round's outputs and the "
          f"WAVs byte-equal between the routes; one cudaGraphLaunch per "
          f"replayed round")
    return res, wav[True]


# ---- G3: the streaming backend and the stream chain as CUDA graphs ---------
MESH_GRID = (2, 4)   # G3's mesh step: D x S cells, all on the one card


def graph_cell(tag, run, same, card, holder, frames=None):
    """One cell of phase G3. run(graphs) is one call of the cell's path
    with graphs on or off: (result, its decode wall in s, or None for
    CUDA events around the call); same(a, b) compares two results;
    `holder` is the RoundGraphs that serves the graph route (the
    thread's). A warm-up call of the eager route and two of the graph
    route (timed too: the first use of a key in the process pays its
    eager run and its capture), then GRAPH_PAIRS pairs in alternating
    order, every result equal to the eager warm-up's and K1 launches
    equal between the routes; the graph route's eager calls, captures
    and replays; one traced call per route (kernel rows, host runtime
    calls, graph launches, device busy ms), its graph launches equal to
    its replays. Returns the measurements."""
    from sdvpcmdecoder_tpu_torch.ops import fused_binarize as fb
    k1 = lambda: fb.stc007_fused_decode_frames.launches
    counts = lambda: (holder.eager_rounds, holder.captures, holder.replays)

    def counted(g):
        """run(g), its wall ms and its (eager calls, captures, replays)."""
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        before = counts()
        torch.cuda.synchronize()
        start.record()
        res, wall = run(g)
        end.record()
        end.synchronize()
        ms = wall * 1e3 if wall is not None else start.elapsed_time(end)
        return res, ms, tuple(a - b for a, b in zip(counts(), before))

    n0 = k1()
    ref, _, _ = counted(False)
    warm_k1 = k1() - n0
    warm, warm_ms = (0, 0, 0), []
    for _ in range(2):
        got, t, delta = counted(True)
        warm = tuple(a + b for a, b in zip(warm, delta))
        warm_ms.append(t)
        check(same(got, ref), f"{tag}: the graph route's result differs "
              f"from the eager route's")
    ms = {True: [], False: []}
    launches = {True: set(), False: set()}
    calls = [0, 0, 0]
    for pair in range(GRAPH_PAIRS):
        for g in ((True, False) if pair % 2 == 0 else (False, True)):
            n0 = k1()
            res, t, delta = counted(g)
            launches[g].add(k1() - n0)
            ms[g].append(t)
            check(same(res, ref), f"{tag}: timed call's result differs "
                  f"(graphs={g})")
            calls = [a + b for a, b in zip(calls, delta)]
    check(launches[True] == launches[False] == {warm_k1},
          f"{tag}: K1 launches per call {launches}, warm-up {warm_k1}")
    prof = {}
    for g in (True, False):
        box = {}
        tr = traced(lambda: box.setdefault("r", counted(g)))
        replays = box["r"][2][2]
        check(tr["graph_launches"] == replays,
              f"{tag}: {tr['graph_launches']} graph launches for {replays} "
              f"replays (graphs={g})")
        med = statistics.median(ms[g])
        prof[g] = dict(busy_ms=tr["busy_ms"], idle_share=1 - tr["busy_ms"]
                       / med, kernel_rows=tr["kernel_rows"],
                       copy_rows=tr["copy_rows"], host_calls=dict(sorted(
                           tr["host_calls"].items())),
                       graph_launches=tr["graph_launches"])
    res = dict(card=card, k1_launches=warm_k1, warm_up=dict(
        zip(("eager_calls", "captures", "replays"), warm), ms=warm_ms),
        timed=dict(zip(("eager_calls", "captures", "replays"), calls)))
    for g, route in ((True, "graph"), (False, "eager")):
        q1, med, q3 = quartiles(ms[g])
        r = res[route] = dict(ms_median=med, ms_q1=q1, ms_q3=q3,
                              ms_runs=ms[g], **prof[g])
        if frames:
            r["fps_median"] = frames / med * 1e3
        print(f"[{tag}] {route} route: {med} ms a call (median of "
              f"{GRAPH_PAIRS}, quartiles {q1}, {q3}; "
              f"{'decode wall' if frames else 'CUDA events'})"
              + (f" = {r['fps_median']} frames/s" if frames else "")
              + f"; traced call: {r['kernel_rows']} CUDA kernel rows, "
              f"{r['copy_rows']} copy rows, host calls {r['host_calls']}, "
              f"device busy {r['busy_ms']} ms = idle share "
              f"{r['idle_share']} of the median call; K1 launches "
              f"{warm_k1} a call on {card}")
    print(f"[{tag}] graph route: 2 warm-up calls {res['warm_up']}, the "
          f"{GRAPH_PAIRS} timed calls {res['timed']} (eager calls, "
          f"captures, replays); every result byte-equal to the eager "
          f"route's; one cudaGraphLaunch per replay")
    return res


def stream_graph_phase(dev, card, tmp, big, px, cd, levels):
    """Phase G3: the streaming ("tpu") backend and the stream chain with
    their device calls replayed as CUDA graphs (graphs=True) against the
    same calls eager (graphs=False), in GRAPH_PAIRS alternating pairs a
    cell (graph_cell): BatchDecoder.run_tpu on the timed 2 x 128 PAL
    frames; the PCM-1 and PCM-16x0 round loop (grid on the card) on P5's
    48-frame captures; V2DDriver's 64-level sweep of 16 PAL frames
    sigma=30, NORMAL and INSANE; phase 4's 128-frame decode_frames; the
    mesh step (MESH_GRID cells on the card). Returns the measurements and
    the K1 launches of the phase."""
    import os

    from sdvpcmdecoder_tpu_torch.ops import fused_binarize as fb
    from sdvpcmdecoder_tpu_torch.parallel import mesh as pm
    from sdvpcmdecoder_tpu_torch.pipeline import batch_driver, decoder, v2d
    from sdvpcmdecoder_tpu_torch.synth import encoder as enc
    n0 = fb.stc007_fused_decode_frames.launches
    out = {}
    same_wavs = lambda a, b: a == b
    tkw = dict(lines_per_field=294, hyst_limit=NORMAL[0],
               shift_limit=NORMAL[1], frames_per_round=ROUND_FRAMES,
               backend="tpu", device=DEVICE)

    def driver(jobs, tag, **kw):
        def run(g):
            wavs, dec, _, wall = timed_driver_run(
                batch_driver.BatchDecoder, jobs, tmp, f"{tag}{int(g)}",
                graphs=g, **kw)
            check(dec.stream_graphs is (holder if g else None),
                  f"G3 {tag}: the decoder's graphs are not the thread's")
            return wavs, wall
        return run

    from sdvpcmdecoder_tpu_torch.ops.round_graph import thread_graphs
    holder = thread_graphs(dev)   # every graph call of the phase

    out["run_tpu"] = graph_cell(
        "G3-run_tpu", driver(big, "g3tpu", **tkw), same_wavs, card,
        frames=DRIVER_FRAMES * len(big), holder=holder)
    for fmt in PCM_FORMATS:
        cap = os.path.join(tmp, f"drv_{fmt}_0.y4m")
        out[fmt] = graph_cell(
            f"G3-{fmt}", driver([cap], f"g3{fmt}", fmt=fmt,
                                hyst_limit=FAST[0], shift_limit=FAST[1],
                                frames_per_round=PCM_ROUND_FRAMES,
                                backend="tpu", device=DEVICE),
            same_wavs, card, frames=PCM_DRIVER_FRAMES, holder=holder)

    spx, scd, _, _ = encode_frames(ROUND_FRAMES, 30.0, seed=9, device=dev)
    sweep_in = (spx.cpu().numpy(), scd.cpu().numpy(),
                np.full(ROUND_FRAMES, 20), np.full(ROUND_FRAMES, 200))
    del spx, scd

    def same_sweep(a, b):
        return all(np.array_equal(x, y) and x.dtype == y.dtype
                   for x, y in zip(a[:4], b[:4])) \
            and torch.equal(a.words, b.words)

    for mode, limits in (("NORMAL", NORMAL), ("INSANE", INSANE)):
        drv = {g: v2d.V2DDriver(hyst_limit=limits[0], shift_limit=limits[1],
                                device=dev, use_kernel=True, graphs=g)
               for g in (True, False)}
        check(drv[True].graphs is holder, "G3: the driver's graphs are not "
              "the thread's")
        out[f"sweep_{mode}"] = graph_cell(
            f"G3-sweep-{mode}",
            lambda g: (drv[g]._sweep_decode(*sweep_in), None),
            same_sweep, card, holder=holder)

    same_tensors = lambda a, b: all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))
    out["decode_frames"] = graph_cell(
        "G3-decode_frames",
        lambda g: (decoder.decode_frames(px, cd, *levels, *NORMAL,
                                         graphs=g), None),
        same_tensors, card, frames=px.shape[0], holder=holder)

    rng = np.random.default_rng(42)
    D, S = MESH_GRID
    n_lines = 4 * pm.HALO + 112
    pixels, coords, _, _ = enc.encode_stream(
        rng.integers(1, 1 << 14, 3 * n_lines),
        rng.integers(1, 1 << 14, 3 * n_lines), width=WIDTH, ppb=8.0,
        n_lines=n_lines, noise_sigma=20.0, rng=rng)
    grid = pm.decode_mesh(D * S, seq=S, devices=[dev])
    chunks, _ = pm.chunk_lines_with_halo(pixels, S)
    Lc = chunks.shape[1]
    per = [np.broadcast_to(a[None], (D,) + a.shape).copy() for a in (
        chunks, pm.chunk_lines_with_halo(coords, S)[0])]
    per += [np.full((D, S, Lc), v, np.int32) for v in (110, 20, 200)]
    sharded = [pm.shard_captures(a, grid) for a in per]
    steps = {g: pm.multichip_decode_step(grid, 1, 1, graphs=g)
             for g in (True, False)}

    def same_step(a, b):
        flat = lambda r: [t for rows in r for row in rows for t in row]
        return same_tensors(flat(a), flat(b))

    out["mesh_step"] = graph_cell(
        "G3-mesh", lambda g: (steps[g](*sharded), None), same_step, card,
        holder=holder)
    return out, fb.stc007_fused_decode_frames.launches - n0


# ---- G4: the stitcher's device seam route as CUDA graphs -------------------
SEAM_TIMED_RUNS = 5   # G4: graph-route runs a cell after its warm-up run
SEAM_EAGER_RUNS = {"full_width": 1, "noisy": SEAM_TIMED_RUNS, "m2": 1}


class SeamCalls:
    """The stitcher's device calls while it is entered: J9
    (ops/device_stitch.eval_rows_arrays) and J10 (seam_sweep), counted by
    a wrapper around each, with the eager calls, captures and replays each
    call made in the holder of the thread that made it
    (round_graph.thread_graphs; a thread's holder moves only in its own
    calls), and the calls of each (thread, key): the key as the holder
    forms it, the static arguments and the bucketed shapes. `last` keeps
    the arguments of each program's last call."""

    def __init__(self):
        import collections
        import threading
        self.calls = collections.Counter()
        self.moves = collections.Counter()
        self.by_key = collections.Counter()
        self.captured = collections.Counter()
        self.last = {}
        self._lock = threading.Lock()

    def __enter__(self):
        from sdvpcmdecoder_tpu_torch.ops import device_stitch as ds
        self._orig = {n: getattr(ds, n) for n in ("eval_rows_arrays",
                                                  "seam_sweep")}
        for name, fn in self._orig.items():
            setattr(ds, name, self._wrap(name, fn))
        return self

    def __exit__(self, *exc):
        from sdvpcmdecoder_tpu_torch.ops import device_stitch as ds
        for name, fn in self._orig.items():
            setattr(ds, name, fn)

    def _wrap(self, name, fn):
        import threading

        from sdvpcmdecoder_tpu_torch.ops import device_stitch as ds
        from sdvpcmdecoder_tpu_torch.ops.round_graph import thread_graphs
        prog = "J9" if name == "eval_rows_arrays" else "J10"

        def counted(*a, **k):
            g = thread_graphs(k["device"]) if k.get("graphs", True) \
                else None
            before = (g.eager_rounds, g.captures, g.replays) if g else None
            out = fn(*a, **k)
            key = ((prog, ds._bucket(len(a[0])), ds._bucket(int(a[4])),
                    *a[6:10]) if prog == "J9" else (prog, *a[6:9]))
            with self._lock:
                self.calls[prog] += 1
                self.last[prog] = (a, dict(k))
                self.by_key[threading.get_ident(), key] += 1
                if g is not None:
                    delta = [x - y for x, y in zip(
                        (g.eager_rounds, g.captures, g.replays), before)]
                    for what, d in zip(("eager", "captures", "replays"),
                                       delta):
                        self.moves[what] += d
                    self.captured[threading.get_ident(), key] += delta[1]
            return out
        return counted

    def summary(self):
        threads = {t for t, _ in self.by_key}
        return dict(J9=self.calls["J9"], J10=self.calls["J10"],
                    eager=self.moves["eager"],
                    captures=self.moves["captures"],
                    replays=self.moves["replays"], threads=len(threads),
                    thread_keys=len(self.by_key),
                    most_captures_a_thread_key=max(self.captured.values(),
                                                   default=0))


def seam_call_stats(prog, a, k):
    """One J9 or J10 call (`prog`, with the arguments a, k of a call the
    stitcher made) on this thread: its replay and its eager call each
    equal, one replay traced (one cudaGraphLaunch) and one eager call
    traced (kernel rows, host runtime calls), and the host ms of each
    (median of 20, alternating: the numpy results wait for the card)."""
    from sdvpcmdecoder_tpu_torch.ops import device_stitch as ds
    from sdvpcmdecoder_tpu_torch.ops.round_graph import thread_graphs
    fn = ds.eval_rows_arrays if prog == "J9" else ds.seam_sweep
    k = dict(k, device=DEVICE)
    calls = {True: lambda: fn(*a, **dict(k, graphs=True)),
             False: lambda: fn(*a, **dict(k, graphs=False))}
    ref = calls[False]()
    g = thread_graphs(DEVICE)
    for _ in range(2):   # the key's eager use and capture, if still due
        got = calls[True]()
    same = lambda x, y: all(np.array_equal(p, q) and p.dtype == q.dtype
                            for p, q in zip(x, y))
    check(same(got, ref), f"G4 {prog}: the replay differs from the eager "
          "call")
    ms = {True: [], False: []}
    for i in range(20):
        for gr in ((True, False) if i % 2 == 0 else (False, True)):
            t0 = time.perf_counter()
            calls[gr]()
            ms[gr].append((time.perf_counter() - t0) * 1e3)
    out = {}
    for gr, route in ((True, "graph"), (False, "eager")):
        replays = g.replays
        tr = traced(calls[gr])
        check(same(tr["result"], ref), f"G4 {prog}: traced {route} call "
              "differs")
        if gr:
            check(tr["graph_launches"] == 1 and g.replays == replays + 1,
                  f"G4 {prog}: {tr['graph_launches']} graph launches in "
                  f"one replayed call")
        out[route] = dict(host_ms=statistics.median(ms[gr]),
                          kernel_rows=tr["kernel_rows"],
                          copy_rows=tr["copy_rows"],
                          host_calls=dict(sorted(tr["host_calls"].items())),
                          busy_ms=tr["busy_ms"])
    return out


def seam_graph_phase(card, tmp, big, noisy_cap):
    """Phase G4: BatchDecoder(backend="tpu", seam_backend="tpu").run_tpu(),
    K1 binarizing each round and the stitcher's device seam route doing
    every resolution count, seam, conv and final deinterleave eval (J9)
    and padding search (J10) on the card, its calls replayed as CUDA
    graphs (graphs=True) and eager (graphs=False). Cells: the timed 2 x
    128 clean PAL frames (32 a fused round), the noisy 32-frame capture
    (sigma 26) and the M2 preset on Q3's capture. Each cell's WAVs equal
    the default route's (seam_backend="auto", the native core) of the same
    run under both routes, and the M2 WAV its pinned hash. The graph route
    runs once to warm up, then SEAM_TIMED_RUNS times; the eager route
    SEAM_EAGER_RUNS[cell] times; one traced run of each route on the M2
    capture gives the device's busy time (a trace of the noisy run holds
    ~120,000 kernel rows and takes most of a minute to read). Then one J9
    and one J10 call of the noisy run, replayed and eager, traced. Returns
    the measurements and the phase's K1 launches."""
    import hashlib
    import os

    from sdvpcmdecoder_tpu_torch.ops import fused_binarize as fb
    from sdvpcmdecoder_tpu_torch.pipeline import batch_driver
    q3 = write_capture(os.path.join(tmp, "g4_q3.y4m"), **Q3)
    tkw = dict(lines_per_field=294, hyst_limit=NORMAL[0],
               shift_limit=NORMAL[1], frames_per_round=ROUND_FRAMES,
               backend="tpu", device=DEVICE)
    cells = {   # name: (captures, BatchDecoder arguments, frames)
        "full_width": (big, tkw, DRIVER_FRAMES * len(big)),
        "noisy": ([noisy_cap], tkw, NOISY_FRAMES),
        "m2": ([q3], dict(Q3_MULTI_KW, mode_m2=True, backend="tpu",
                          device=DEVICE), Q3["n_frames"])}
    fb.stc007_fused_decode_frames.launches = 0

    def run(cell, tag, **kw):
        """One run of the cell: (WAVs, wall s, stage_t, J9/J10 calls and
        holder moves, K1 launches)."""
        jobs, ckw, _ = cells[cell]
        n0 = fb.stc007_fused_decode_frames.launches
        with SeamCalls() as sc:
            wavs, dec, _, wall = timed_driver_run(
                batch_driver.BatchDecoder, jobs, tmp, f"g4{cell}{tag}",
                **ckw, **kw)
        if kw.get("seam_backend") == "tpu":
            check(all(j.stitcher.seam_backend == "tpu"
                      and j.stitcher.graphs is kw.get("graphs", True)
                      for j in dec.jobs), f"G4 {cell}: stitcher settings")
        return (wavs, wall, dict(dec.stage_t), sc,
                fb.stc007_fused_decode_frames.launches - n0)

    out = dict(card=card)
    defaults = {}
    for cell, (_, _, frames) in cells.items():
        default, dwall, _, _, dk1 = run(cell, "auto", seam_backend="auto")
        defaults[cell] = default
        if cell == "m2":
            check(hashlib.sha256(default[0]).hexdigest()
                  == GOLDEN_Q3_DRIVER_SHA256["m2"], "G4 m2: the default "
                  "route's WAV is not the JAX package's")
        res = dict(default_wall_s=dwall, default_k1=dk1)
        for graphs, route in ((True, "graph"), (False, "eager")):
            n_runs = SEAM_TIMED_RUNS + 1 if graphs \
                else SEAM_EAGER_RUNS[cell]
            walls, stitch, runs, k1 = [], [], [], set()
            for i in range(n_runs):
                wavs, wall, stage_t, sc, launches = run(
                    cell, f"{route}{i}", seam_backend="tpu", graphs=graphs)
                check(wavs == default, f"G4 {cell}: the {route} route's "
                      f"WAV differs from the default route's (run {i})")
                summ = sc.summary()
                check(summ["J9"] > 0 and summ["most_captures_a_thread_key"]
                      <= 1, f"G4 {cell} {route}: {summ}")
                if not graphs:
                    check(summ["eager"] == summ["captures"]
                          == summ["replays"] == 0,
                          f"G4 {cell}: the eager route used a holder")
                k1.add(launches)
                runs.append(summ)
                if graphs and i == 0:
                    warm = dict(wall_s=wall, **summ)
                    continue
                walls.append(wall)
                stitch.append(stage_t.get("stitch", 0.0))
                last = stage_t
                if cell == "noisy" and graphs:
                    out["calls"] = sc.last
            check(len(k1) == 1 and k1 == {dk1}, f"G4 {cell}: K1 launches "
                  f"{k1} a {route} run, default route {dk1}")
            fps = [frames / w for w in walls]
            r = res[route] = dict(
                runs=len(walls), fps_runs=fps, wall_runs=walls,
                stitch_s_runs=stitch, k1_launches=min(k1),
                stage_t_last={k: round(v, 4) for k, v in last.items()},
                calls_a_run=runs[-1])
            if len(fps) >= 2:
                r["fps_q1"], r["fps_median"], r["fps_q3"] = quartiles(fps)
            else:
                r["fps_median"] = fps[0]
            if graphs:
                r["warm_up"] = warm
        for route in ("graph", "eager"):
            r = res[route]
            print(f"[G4-{cell}] {route} route: {r['fps_median']} frames/s"
                  f" (median of {r['runs']}"
                  + (f", quartiles {r['fps_q1']}, {r['fps_q3']}"
                     if r["runs"] >= 2 else "")
                  + f"; decode wall {statistics.median(r['wall_runs'])} s"
                  f", stitch {statistics.median(r['stitch_s_runs'])} s "
                  f"summed over the stitch threads); J9/J10 calls, holder "
                  f"moves and threads a run {r['calls_a_run']}"
                  + (f"; warm-up run {r['warm_up']}" if route == "graph"
                     else "")
                  + f"; stage_t {r['stage_t_last']}; K1 launches "
                  f"{r['k1_launches']} a run on {card}")
        print(f"[G4-{cell}] default route (seam_backend=\"auto\"): "
              f"{res['default_wall_s']} s; every WAV of both routes equals "
              f"its WAV" + (" and the pinned JAX hash" if cell == "m2"
                            else ""))
        out[cell] = res
    prof = {}
    for graphs, route in ((True, "graph"), (False, "eager")):
        tr = traced(lambda: run("m2", f"p{route}", seam_backend="tpu",
                                graphs=graphs))
        wavs, wall, _, sc, _ = tr["result"]
        check(wavs == defaults["m2"], f"G4 m2: the traced {route} "
              "run's WAV differs")
        summ = sc.summary()
        # The graph route's launches: the seam replays and V2D's.
        check(tr["graph_launches"] >= summ["replays"] > 0 if graphs
              else tr["graph_launches"] == 0,
              f"G4 m2 {route}: {tr['graph_launches']} graph launches, "
              f"{summ['replays']} seam replays")
        prof[route] = dict(busy_ms=tr["busy_ms"],
                           idle_share=1 - tr["busy_ms"] / (wall * 1e3),
                           kernel_rows=tr["kernel_rows"],
                           copy_rows=tr["copy_rows"],
                           graph_launches=tr["graph_launches"],
                           seam_replays=summ["replays"])
        print(f"[G4-m2] traced {route} run: device busy "
              f"{prof[route]['busy_ms']} ms of {wall * 1e3} ms = idle "
              f"share {prof[route]['idle_share']}; "
              f"{prof[route]['kernel_rows']} CUDA kernel rows, "
              f"{prof[route]['copy_rows']} copy rows, "
              f"{prof[route]['graph_launches']} graph launches "
              f"({summ['replays']} seam replays) on {card}")
    out["traced_runs"] = prof
    for prog in ("J9", "J10"):
        a, k = out["calls"][prog]
        st = out[prog] = seam_call_stats(prog, a, k)
        shape = (f"L {len(a[0])}, B {a[4]}" if prog == "J9"
                 else f"fields {len(a[0])} / {len(a[2])} lines")
        for route in ("graph", "eager"):
            print(f"[G4-{prog}] one {route} call ({shape}): "
                  f"{st[route]['host_ms']} ms host (median of 20); traced:"
                  f" {st[route]['kernel_rows']} CUDA kernel rows, "
                  f"{st[route]['copy_rows']} copy rows, host calls "
                  f"{st[route]['host_calls']}, device busy "
                  f"{st[route]['busy_ms']} ms on {card}")
    del out["calls"]
    return out, fb.stc007_fused_decode_frames.launches


# ---- PCM-1 / PCM-16x0 (phases P1-P5) ---------------------------------------
# The PCM path runs neither K1 nor K2: its trial grid is plain torch on the
# card (ops/binarize.generic_frame_decode), as it is XLA in the JAX package.
PCM_FORMATS = ("pcm1", "pcm16x0")
PCM_WIDTH = {"pcm1": 1024, "pcm16x0": 1600}
PCM_LPF = 245                  # NTSC fields: 490 lines a frame
PCM_GRID_FRAMES = 16           # P1: the plain grid, card against CPU
PCM_NOISE = {"pcm1": 14.0, "pcm16x0": 10.0}   # tests/test_device_pcm.py
FAST = (2, 1)                  # (hyst_limit, shift_limit), --quality fast
PCM_DRIVER_CAPS = 4            # P3: captures per format ...
PCM_DRIVER_FRAMES = 48         # ... of this many frames each
PCM_ROUND_FRAMES = 16
PCM_TIMED_RUNS = 5
PCM_NOISY_FRAMES = 6           # P4: tests/test_device_pcm.py's captures
PCM_NOISE_REFINE = {"pcm1": 30.0, "pcm16x0": 26.0}   # ... and noisier ones

# sha256 of the WAV the JAX package's CLI writes at its defaults,
#     python -m sdvpcmdecoder_tpu cap.y4m -o out.wav --format <fmt>
# under --backend native, tpu and device and with no --backend, for the
# captures of PCM_GOLDEN (--format auto on the PCM-1 capture probes pcm1
# and writes the same bytes); tests/test_torch_pcm_cli_golden.py
# recomputes them from the JAX package's CLI.
PCM_GOLDEN = {   # name: (--format, writer, writer arguments)
    "pcm1": ("pcm1", "write_pcm1_capture", dict(n_frames=3, seed=31)),
    "pcm16x0": ("pcm16x0", "write_pcm16x0_capture",
                dict(n_frames=3, seed=32)),
    "pcm1630": ("pcm1630", "write_pcm1630_capture",
                dict(n_frames=2, seed=102)),
}
GOLDEN_PCM_SHA256 = {
    "pcm1": "8a696a4d52e8b78f638b99f26ed6c4fe18ddeaad1b35e31d9163a7bcfa9d1196",
    "pcm16x0":
        "b7efa1266304d5cccb5f227c74178cf992fb4aef35a62763b51b08e6f0e6d538",
    "pcm1630":
        "4951c2b0ac764a0c98e50fa4ff58f81e590e116ccb7684f73f5b6e3e7701d6f9",
}
PCM_CLI_BACKENDS = ("device", "tpu", "native", None)


def _pcm1_field_bits(rng):
    """One PCM-1 field's 245 line bit rows from fresh random words (the
    recipe of the JAX package's tests)."""
    from sdvpcmdecoder_tpu_torch.formats import pcm1
    from sdvpcmdecoder_tpu_torch.ops import pcm1_deint as di1
    left = rng.integers(0, 1 << 13, di1.FIELD_SUBLINES)
    right = rng.integers(0, 1 << 13, di1.FIELD_SUBLINES)
    sl, sr = di1.interleave_field(left, right)
    words = np.zeros((PCM_LPF, 6), np.int64)
    words[:, 0::2] = np.stack([sl[0::3], sl[1::3], sl[2::3]], 1)
    words[:, 1::2] = np.stack([sr[0::3], sr[1::3], sr[2::3]], 1)
    crcs = pcm1.calc_crc(words, xp=np)
    return pcm1.words_to_data_bits(words, crcs, xp=np)


def write_pcm1_capture(path, n_frames=3, seed=31):
    """A y4m PCM-1 capture, 490 lines x 1024 px, 10 px a bit: the bytes
    of tests/test_batch_driver_formats.py's _pcm1_capture. Returns path."""
    from sdvpcmdecoder_tpu_torch.pipeline import ingest
    from sdvpcmdecoder_tpu_torch.synth import encoder as enc
    rng = np.random.default_rng(seed)
    W = PCM_WIDTH["pcm1"]
    vids = []
    for _ in range(n_frames):
        img = np.zeros((2 * PCM_LPF, W), np.uint8) + 20
        for half in range(2):
            px, _ = enc.render_bits(_pcm1_field_bits(rng), width=W,
                                    ppb=10.0)
            img[half::2] = px
        vids.append(img)
    ingest.write_y4m(path, np.stack(vids), chroma="mono")
    return path


def write_pcm16x0_capture(path, n_frames=3, seed=32):
    """A y4m PCM-16x0 SI capture (control bit 1), 490 lines x 1600 px,
    7 px a bit: the bytes of tests/test_batch_driver_formats.py's
    _pcm16x0_capture (and of tests/test_cli_formats.py's SI capture at
    its seed). Returns path."""
    from sdvpcmdecoder_tpu_torch.formats import pcm16x0
    from sdvpcmdecoder_tpu_torch.ops import pcm16x0_deint as di16
    from sdvpcmdecoder_tpu_torch.pipeline import ingest
    from sdvpcmdecoder_tpu_torch.synth import encoder as enc
    rng = np.random.default_rng(seed)
    W = PCM_WIDTH["pcm16x0"]
    usable = (PCM_LPF * 3 // (3 * di16.SI_OFS)) * (3 * di16.SI_OFS)
    vids = []
    for _ in range(n_frames):
        img = np.zeros((2 * PCM_LPF, W), np.uint8)
        for half in range(2):
            left = rng.integers(1, 1 << 16, usable)
            right = rng.integers(1, 1 << 16, usable)
            sub, _ = di16.interleave_field(left, right, PCM_LPF)
            crcs = np.asarray(pcm16x0.calc_crc(sub, xp=np))
            bits = pcm16x0.line_bits(sub.reshape(PCM_LPF, 3, 3),
                                     crcs.reshape(PCM_LPF, 3), 1, xp=np)
            px, _ = enc.render_bits(bits, width=W, ppb=7.0)
            img[half::2] = px
        vids.append(img)
    ingest.write_y4m(path, np.stack(vids), chroma="mono")
    return path


def write_pcm1630_capture(path, n_frames=2, seed=102):
    """A y4m PCM-1630 (EI) capture, 490 lines x 1600 px: the bytes of
    tests/test_cli_formats.py's test_cli_pcm1630 capture. Returns path."""
    from sdvpcmdecoder_tpu_torch.formats import pcm16x0
    from sdvpcmdecoder_tpu_torch.ops import pcm16x0_deint as di16
    from sdvpcmdecoder_tpu_torch.pipeline import ingest
    from sdvpcmdecoder_tpu_torch.synth import encoder as enc
    rng = np.random.default_rng(seed)
    W = PCM_WIDTH["pcm16x0"]
    L = 2 * PCM_LPF
    vids = []
    for _ in range(n_frames):
        left = rng.integers(1, 1 << 16, size=di16.EI_OFS * 3)
        right = rng.integers(1, 1 << 16, size=di16.EI_OFS * 3)
        sub, _ = di16.interleave_field(left, right, L, ei=True)
        crcs = pcm16x0.calc_crc(sub, xp=np)
        bits = pcm16x0.line_bits(sub.reshape(L, 3, 3), crcs.reshape(L, 3),
                                 0, xp=np)
        px, _ = enc.render_bits(bits, width=W, ppb=7.0)
        img = np.zeros((L, W), np.uint8)
        img[0::2] = px[:PCM_LPF]
        img[1::2] = px[PCM_LPF:]
        vids.append(img)
    ingest.write_y4m(path, np.stack(vids), chroma="mono")
    return path


def write_pcm_noisy(path, fmt, n_frames, seed, noise):
    """The capture of the format's writer at `seed` with gaussian noise
    from rng(seed + 1) on every pixel: tests/test_device_pcm.py's _noisy.
    Returns path."""
    from sdvpcmdecoder_tpu_torch.pipeline import ingest
    writer = write_pcm1_capture if fmt == "pcm1" else write_pcm16x0_capture
    with tempfile.TemporaryDirectory() as t2:
        clean = writer(str(Path(t2) / "clean.y4m"), n_frames=n_frames,
                       seed=seed)
        with ingest.open_capture(clean) as rd:
            frames = rd.read_frames(0, n_frames)
    rng = np.random.default_rng(seed + 1)
    frames = np.clip(frames.astype(np.int16)
                     + rng.normal(0, noise, frames.shape),
                     0, 255).astype(np.uint8)
    ingest.write_y4m(path, frames, chroma="mono")
    return path


def pcm_grid_inputs(path, fmt, device):
    """A PCM capture's fields [F, 490, W] u8 on `device` and the frame
    levels PCMFrameDriver.prepare_frames finds for them (coords [F, 2],
    ref/black/white [F] int32, clipped as _decode_batch clips them)."""
    from sdvpcmdecoder_tpu_torch.pipeline import ingest, v2d_other
    with ingest.open_capture(path) as rd:
        lines, _ = ingest.split_fields_batch(rd.read_frames(0, rd.n_frames))
    prep = v2d_other.PCMFrameDriver(fmt, backend="native",
                                    device="cpu").prepare_frames(lines)
    check(bool(prep["usable"].all()), f"{fmt}: frames without coordinates")
    host = (prep["coords"], np.maximum(prep["refs"], 1),
            np.clip(prep["blacks"], 0, 254), np.clip(prep["whites"], 1, 255))
    return (torch.from_numpy(lines).to(device),
            *(torch.from_numpy(a.astype(np.int32)).to(device) for a in host))


def pcm_frame_decode(fmt):
    from sdvpcmdecoder_tpu_torch.ops import binarize as bz
    return bz.pcm1_frame_decode if fmt == "pcm1" else bz.pcm16x0_frame_decode


def pcm_round_params(coords, refs, blacks, whites):
    """pcm_round_packed's int32 parameter vector, every frame usable."""
    from sdvpcmdecoder_tpu_torch.ops import device_pcm as dp
    F = coords.shape[0]
    o, n = dp.round_param_layout(F)
    p = torch.ones(n, dtype=torch.int32, device=coords.device)
    p[o["coords"]:o["coords"] + 2 * F] = coords.reshape(-1)
    for key, t in (("refs", refs), ("blacks", blacks), ("whites", whites)):
        p[o[key]:o[key] + F] = t
    return p


def timed_driver_run(cls, jobs, tmp, tag, **kw):
    """One run of a driver class (BatchDecoder, DeviceBatchDecoder or
    DevicePCMBatchDecoder) over `jobs` on the card: (WAV bytes per job,
    the decoder, staging seconds, decode wall seconds), split as
    driver_run splits them (BatchDecoder stages nothing)."""
    import os
    t0 = time.perf_counter()
    dec = cls([(cap, os.path.join(tmp, f"{tag}_{k}.wav"))
               for k, cap in enumerate(jobs)], **kw)
    t1 = time.perf_counter()
    dec.stage_t["stage_hbm"] = 0.0
    dec.run()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    stage = t1 - t0 + dec.stage_t["stage_hbm"]
    wall = t2 - t1 - dec.stage_t["stage_hbm"]
    return ([open(j.out_path, "rb").read() for j in dec.jobs], dec, stage,
            wall)


def cli_run_captured(argv):
    """cli_run with the CLI's standard output captured: (exit code, wall
    seconds, printed lines)."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc, secs = cli_run(argv)
    return rc, secs, buf.getvalue().splitlines()


def quartiles(xs):
    q = statistics.quantiles(xs, n=4)
    return q[0], statistics.median(xs), q[2]


def pcm_phases(dev, card, tmp):
    """Phases P1-P5; prints the timings as one "[pcm-json]" line. Returns
    the K1 launches counted on the PCM paths (the device driver's runs,
    the CLI's runs)."""
    import hashlib
    import os

    from sdvpcmdecoder_tpu_torch.ops import device_pcm as dp
    from sdvpcmdecoder_tpu_torch.ops import fused_binarize as fb
    from sdvpcmdecoder_tpu_torch.pipeline import batch_driver, device_pcm
    k1 = lambda: fb.stc007_fused_decode_frames.launches

    # -- P1: the plain PCM grid, card against CPU ---------------------------
    grid = {}
    for fmt in PCM_FORMATS:
        writer = write_pcm1_capture if fmt == "pcm1" \
            else write_pcm16x0_capture
        for noise in (0.0, PCM_NOISE[fmt]):
            path = os.path.join(tmp, f"grid_{fmt}_{noise}.y4m")
            if noise:
                write_pcm_noisy(path, fmt, PCM_GRID_FRAMES, 3, noise)
            else:
                writer(path, n_frames=PCM_GRID_FRAMES, seed=3)
            inputs = pcm_grid_inputs(path, fmt, dev)
            cpu_in = [t.cpu() for t in inputs]
            fn = pcm_frame_decode(fmt)
            for mode, (hl, sl) in (("fast", FAST), ("normal", NORMAL)):
                got = fn(*inputs, shift_limit=sl, hyst_limit=hl)
                want = fn(*cpu_in, shift_limit=sl, hyst_limit=hl)
                torch.cuda.synchronize()
                for name, g, e in zip(("words", "crc_read", "valid",
                                       "ctrl"), got, want):
                    check(g.dtype == e.dtype and g.shape == e.shape
                          and torch.equal(g.cpu(), e),
                          f"P1 {fmt} {mode} sigma={noise}: {name} differs "
                          f"between the card and the CPU")
                grid[(fmt, noise, mode)] = inputs
                F, L, W = inputs[0].shape
                print(f"[pcm-grid] {fmt}_frame_decode {F}x{L}x{W} {mode} "
                      f"(hyst {hl}, shift {sl}) sigma={noise}: card == CPU on "
                      f"every output and dtype; valid "
                      f"{int(got[2].sum())}/{got[2].numel()}")
    grid_ms = {}
    for fmt in PCM_FORMATS:
        inputs = grid[(fmt, 0.0, "fast")]
        fn = pcm_frame_decode(fmt)
        ms, _ = median_ms_abab(
            lambda: fn(*inputs, shift_limit=FAST[1], hyst_limit=FAST[0]),
            lambda: fn(*inputs, shift_limit=NORMAL[1],
                       hyst_limit=NORMAL[0]))
        grid_ms[fmt] = ms
    del grid

    # -- P2: golden WAVs ----------------------------------------------------
    n0 = k1()
    golden = {}
    for name, (fmt, writer, wkw) in PCM_GOLDEN.items():
        cap = globals()[writer](os.path.join(tmp, f"gold_{name}.y4m"), **wkw)
        golden[name] = cap
        for backend in PCM_CLI_BACKENDS:
            tag = backend or "default"
            out = os.path.join(tmp, f"gold_{name}_{tag}.wav")
            rc, secs, _ = cli_run_captured(
                [cap, "-o", out, "--format", fmt]
                + (["--backend", backend] if backend else []))
            check(rc == 0, f"P2 {name}/{tag}: exit code {rc}")
            digest = hashlib.sha256(open(out, "rb").read()).hexdigest()
            check(digest == GOLDEN_PCM_SHA256[name],
                  f"P2 {name}/{tag}: WAV sha256 {digest} is not the JAX "
                  f"CLI's {GOLDEN_PCM_SHA256[name]}")
        print(f"[pcm-cli] {name} capture ({wkw['n_frames']} frames) "
              f"--format {fmt} under --backend device, tpu, native and "
              f"none: WAV sha256 equals the JAX CLI's")
    out = os.path.join(tmp, "gold_auto.wav")
    rc, _, lines = cli_run_captured([golden["pcm1"], "-o", out, "--format",
                                     "auto"])
    probe = [ln for ln in lines if ln.startswith("format probe:")]
    check(rc == 0 and probe and probe[0].startswith("format probe: pcm1 ")
          and hashlib.sha256(open(out, "rb").read()).hexdigest()
          == GOLDEN_PCM_SHA256["pcm1"],
          f"P2 --format auto: exit {rc}, printed {probe}")
    print(f"[pcm-cli] --format auto on the PCM-1 capture: printed "
          f"{probe[0]!r}; WAV sha256 equals the JAX CLI's")
    cli_k1 = k1() - n0

    # -- P3: the chip-resident PCM driver at full width, timed --------------
    n0 = k1()
    timings = {}
    for fmt in PCM_FORMATS:
        writer = write_pcm1_capture if fmt == "pcm1" \
            else write_pcm16x0_capture
        caps = [writer(os.path.join(tmp, f"drv_{fmt}_{i}.y4m"),
                       n_frames=PCM_DRIVER_FRAMES, seed=60 + i)
                for i in range(PCM_DRIVER_CAPS)]
        kw = dict(fmt=fmt, hyst_limit=FAST[0], shift_limit=FAST[1],
                  frames_per_round=PCM_ROUND_FRAMES)
        ref, _, _, ref_wall = timed_driver_run(
            batch_driver.BatchDecoder, caps, tmp, f"ref_{fmt}",
            backend="native", device=dev, **kw)
        n_fr = PCM_DRIVER_CAPS * PCM_DRIVER_FRAMES
        fps, stages, stage_s = [], [], []
        for r in range(PCM_TIMED_RUNS + 1):      # run 0: the warm-up
            wavs, dec, stage, wall = timed_driver_run(
                device_pcm.DevicePCMBatchDecoder, caps, tmp,
                f"dev_{fmt}", device=dev, **kw)
            check(wavs == ref, f"P3 {fmt}: device driver WAVs differ "
                  f"from the native BatchDecoder's (run {r})")
            if r:
                fps.append(n_fr / wall)
                stage_s.append(stage)
                stages.append({k: round(v, 4)
                               for k, v in dec.stage_t.items()})
        busy_ms, events, prof_wall_ms = pcm_device_busy(
            device_pcm.DevicePCMBatchDecoder, caps, tmp, device=dev, **kw)
        # One round on the card: kernel rows, device ms, the grid's share.
        inputs = pcm_grid_inputs(caps[0], fmt, dev)
        px = inputs[0][:PCM_ROUND_FRAMES]
        lv = [t[:PCM_ROUND_FRAMES] for t in inputs[1:]]
        params = pcm_round_params(*lv)
        fn = pcm_frame_decode(fmt)
        round_rows = cuda_profile(
            lambda: dp.pcm_round_packed(px, params, fmt, FAST[1], FAST[0]),
            1, lambda r: True)
        grid_rows = cuda_profile(
            lambda: fn(px, *lv, shift_limit=FAST[1], hyst_limit=FAST[0]),
            1, lambda r: True)

        def kernels(rows):
            ks = [e for e in rows if "Memcpy" not in e.key
                  and "Memset" not in e.key]
            return (sum(e.count for e in ks),
                    sum(e.self_device_time_total for e in ks) / 1e3,
                    sum(e.count for e in rows) - sum(e.count for e in ks))
        r_n, r_ms, r_copies = kernels(round_rows)
        g_n, g_ms, _ = kernels(grid_rows)
        round_wall, _ = median_ms_abab(
            lambda: dp.pcm_round_packed(px, params, fmt, FAST[1], FAST[0]),
            lambda: fn(px, *lv, shift_limit=FAST[1], hyst_limit=FAST[0]))
        q1, med, q3 = quartiles(fps)
        timings[fmt] = dict(
            fps_median=med, fps_q1=q1, fps_q3=q3, fps_runs=fps,
            stage_s=statistics.median(stage_s), stage_t=stages[len(stages)
                                                               // 2],
            native_fps=n_fr / ref_wall, busy_ms=busy_ms,
            prof_wall_ms=prof_wall_ms, idle_share=1 - busy_ms / prof_wall_ms,
            cuda_events=events, round_kernel_rows=r_n,
            round_device_ms=r_ms, round_copies=r_copies,
            round_wall_ms=round_wall, grid_kernel_rows=g_n,
            grid_device_ms=g_ms, grid_share=g_ms / r_ms,
            grid_fast_ms=grid_ms[fmt])
        t = timings[fmt]
        print(f"[pcm-driver] DevicePCMBatchDecoder {fmt} "
              f"{PCM_DRIVER_CAPS} x {PCM_DRIVER_FRAMES} frames "
              f"{inputs[0].shape[1]}x{inputs[0].shape[2]}, fast, "
              f"{PCM_ROUND_FRAMES} frames a round: WAVs equal the native "
              f"BatchDecoder's in every run; {med} frames/s (median of "
              f"{PCM_TIMED_RUNS} after a warm-up; quartiles {q1}, {q3}; "
              f"decode wall, staging apart) against the native "
              f"BatchDecoder's {n_fr / ref_wall} frames/s (one run); "
              f"staging {t['stage_s']} s; stage_t {t['stage_t']}; device "
              f"busy {busy_ms} ms of {prof_wall_ms} ms wall under "
              f"torch.profiler = idle share {t['idle_share']} "
              f"({events} CUDA events) on {card}")
        print(f"[pcm-round] pcm_round_packed {fmt} {PCM_ROUND_FRAMES} "
              f"frames fast (torch.profiler, one call): {r_n} kernel rows, "
              f"{r_copies} copies, {r_ms} ms device time; the grid "
              f"({fmt}_frame_decode alone) {g_n} kernel rows, {g_ms} ms = "
              f"{g_ms / r_ms} of the round; round {round_wall} ms wall "
              f"(CUDA events, median of 5); plain grid {grid_ms[fmt]} ms at "
              f"fast on {PCM_GRID_FRAMES} frames on {card}")
    device_k1 = k1() - n0

    # -- G2: the PCM driver's rounds as CUDA graphs against eager -----------
    g2 = {}
    for fmt in PCM_FORMATS:
        caps = [os.path.join(tmp, f"drv_{fmt}_{i}.y4m")
                for i in range(PCM_DRIVER_CAPS)]
        g2[fmt], _ = round_graph_phase(
            f"G2-{fmt}", device_pcm, device_pcm.DevicePCMBatchDecoder, caps,
            tmp, card, PCM_DRIVER_CAPS * PCM_DRIVER_FRAMES, fmt=fmt,
            hyst_limit=FAST[0], shift_limit=FAST[1],
            frames_per_round=PCM_ROUND_FRAMES, device=dev)
        inputs = pcm_grid_inputs(caps[0], fmt, dev)
        px = inputs[0][:PCM_ROUND_FRAMES]
        params = pcm_round_params(*(t[:PCM_ROUND_FRAMES]
                                    for t in inputs[1:]))
        from sdvpcmdecoder_tpu_torch.ops.round_graph import RoundGraphs
        graphs = RoundGraphs(dev)
        kw = dict(fmt=fmt, shift_limit=FAST[1], hyst_limit=FAST[0])
        graph_round = lambda: device_pcm.run_round(px, params, graphs=graphs,
                                                   **kw)
        graph_round(), graph_round()   # the key's eager first use, capture
        g2[fmt]["round"] = graph_round_stats(
            graph_round, lambda: device_pcm.run_round(px, params, **kw))
        print(f"[G2-round] pcm_round_packed {fmt} {PCM_ROUND_FRAMES} frames "
              f"fast: {g2[fmt]['round']} (CUDA-event ms, median of 5, "
              f"alternating; kernel rows, host calls and device ms of one "
              f"call under torch.profiler) on {card}")
    device_k1 += k1() - n0

    # -- P4: noisy captures through the device driver -----------------------
    # The sigma 14 / 10 captures of tests/test_device_pcm.py decode with
    # every line valid at hyst 0 / shift 1; the PCM_NOISE_REFINE ones fail
    # lines, so that refine_failed_lines and the Bit Picker run.
    n0 = k1()
    for fmt in PCM_FORMATS:
        for noise in (PCM_NOISE[fmt], PCM_NOISE_REFINE[fmt]):
            caps = [write_pcm_noisy(
                os.path.join(tmp, f"noisy_{fmt}_{noise}_{i}.y4m"), fmt,
                PCM_NOISY_FRAMES, 40 + i, noise) for i in range(2)]
            kw = dict(fmt=fmt, hyst_limit=0, shift_limit=1,
                      frames_per_round=3, device=dev)
            ref, _, _, _ = timed_driver_run(
                batch_driver.BatchDecoder, caps, tmp, f"nref_{fmt}",
                backend="native", **kw)
            wavs, dec, _, _ = timed_driver_run(
                device_pcm.DevicePCMBatchDecoder, caps, tmp, f"ndev_{fmt}",
                **kw)
            check(wavs == ref, f"P4 {fmt} sigma={noise}: WAVs differ from "
                  f"the native BatchDecoder's")
            check(noise == PCM_NOISE[fmt] or dec.fetched_frames > 0,
                  f"P4 {fmt} sigma={noise}: no frame was refined")
            valid = sum(j.stats.lines_valid for j in dec.jobs)
            total = sum(j.stats.lines_total for j in dec.jobs)
            rounds = 2 * -(-PCM_NOISY_FRAMES // 3)
            print(f"[pcm-noisy] {fmt} sigma={noise}, 2 x {PCM_NOISY_FRAMES} "
                  f"frames, 3 a round, hyst 0 shift 1: WAVs equal the "
                  f"native BatchDecoder's; frames fetched for refinement "
                  f"{dec.fetched_frames} in {dec.fetch_copies} copies over "
                  f"{rounds} rounds ({dec.fetch_copies / rounds} copies a "
                  f"round); lines valid {valid}/{total}")
    device_k1 += k1() - n0

    # -- P5: the CLI at its defaults -----------------------------------------
    n0 = k1()
    cli_fps = {}
    for fmt in PCM_FORMATS:
        cap = os.path.join(tmp, f"drv_{fmt}_0.y4m")
        wavs = {}
        for backend in PCM_CLI_BACKENDS:
            tag = backend or "default"
            out = os.path.join(tmp, f"cli5_{fmt}_{tag}.wav")
            rc, secs, lines = cli_run_captured(
                [cap, "-o", out, "--format", fmt]
                + (["--backend", backend] if backend else []))
            check(rc == 0, f"P5 {fmt}/{tag}: exit code {rc}")
            wavs[tag] = open(out, "rb").read()
            cli_fps[(fmt, tag)] = PCM_DRIVER_FRAMES / secs
            shown = [ln for ln in lines if ln.startswith(("timings:",
                                                          "decoded"))]
            print(f"[pcm-cli] {fmt} {PCM_DRIVER_FRAMES} frames at the "
                  f"defaults --backend {tag}: {PCM_DRIVER_FRAMES / secs} "
                  f"frames/s (wall of main()); {' | '.join(shown)} on "
                  f"{card}")
        check(len(set(wavs.values())) == 1,
              f"P5 {fmt}: the backends' WAVs differ")
    cli_k1 += k1() - n0
    check(cli_k1 == 0 and device_k1 == 0,
          f"the PCM paths launched K1: CLI {cli_k1}, driver {device_k1}")
    print(f"[pcm] K1 launches on the PCM paths: driver {device_k1}, CLI "
          f"{cli_k1} (the PCM grid is plain torch)")
    print("[pcm-json] " + json.dumps(dict(
        card=card, driver=timings, graphs=g2,
        cli_fps={f"{f}/{b}": v for (f, b), v in cli_fps.items()})))
    return dict(pcm_device=device_k1, pcm_cli=cli_k1)


def pcm_device_busy(cls, jobs, tmp, **kw):
    """driver_device_busy for a PCM driver class: (device busy ms, CUDA
    events, decode wall ms) of one run under torch.profiler."""
    tr = traced(lambda: timed_driver_run(cls, jobs, tmp, "prof", **kw))
    return tr["busy_ms"], tr["kernel_rows"] + tr["copy_rows"], \
        tr["result"][3] * 1e3


# ---- Containers, ArVid, multi-GPU and Queue 3's paths (phases C1-C9) -------
# The codecs, the container parsers, ArVid and the shards' threads are host
# code, as in the JAX package. What these phases hold on the card is K1
# under new callers: AVI/MKV readers into the CLI and the chip-resident
# driver, concurrent shards on one card, the mesh step's per-line
# decode_stream ([L, 1, W]) and the 1440-px rows of a 720-px capture.
CONTAINERS = (("avi", "Y800"), ("avi", "HFYU"), ("avi", "ULY0"),
              ("mkv", "ULY0"))        # the golden PAL capture in each
CONTAINER_BACKENDS = ("tpu", "device", None)
CROP_CODECS = ("LAGS", "FFV1")        # pixels checked on a crop ...
CROP_LINES = 48
SLOW_FRAMES = 2                       # ... and timed on 2 PAL frames
BIG_AVI = (("Y800", DRIVER_FRAMES), ("ULY0", 64))   # the CLI under tpu
# sha256 of the WAV the JAX package's CLI writes at its defaults,
#     python -m sdvpcmdecoder_tpu drops.avi -o out.wav
# for the golden PAL capture (capture_frames(12, 294, seed=1)) in a Y800
# AVI with the timeline slots AVI_DROPS dropped (zero-length idx1 entries:
# 14 slots, two of them black); tests/test_torch_container_golden.py
# recomputes it from the JAX package's CLI.
AVI_DROPS = (3, 8)
GOLDEN_AVI_SHA256 = \
    "f955bb2c0d3a6c3e1436c063c1c9bb95b3de4db640583a3fd44b8f7e3d502fee"
# A capture card's PAL frame (pipeline/capture.py PAL_PRESET): 720 x 576,
# rendered at 1440 px and 10 px a bit, every other column kept; the CLI
# doubles it back to 1440-px rows (ingest.split_fields). sha256 of the JAX
# CLI's WAV at its defaults under every --backend.
WIDE = dict(n_frames=6, lpf=288, seed=6)
GOLDEN_WIDE_SHA256 = \
    "a86a3479c2c224ece7ad793a486bde7fa7eaa165adafa2558b8325d5547c45ed"
# ArVid (--format arvid, host numpy in both packages): sha256 of the word
# dump (.txt) and the raw words (.bin) the JAX CLI writes for
# write_arvid_capture(path, **ARVID) with --force-coords at its coords.
ARVID = dict(n_frames=4, seed=14)
GOLDEN_ARVID_SHA256 = {
    "txt": "1770f4d2a7d984fb769b84b929210dde7b175107c4ab845319e6121fd0b19840",
    "bin": "f7f2fa392b55b06f9b579565032f5b18fc2d14c9a498021d73951bf8095a87c9",
}
# Queue 3's card check: CLI flags and driver presets checked on the CPU
# only before. sha256 of the JAX package's WAVs for write_capture(path,
# **Q3): its CLI at the defaults plus each flag set (every backend writes
# the same bytes; --force-coords is not a --backend device flag), its
# DeviceBatchDecoder with each preset (hyst 2, shift 1, 5 frames a round),
# and its BatchDecoder on Q3_MULTI's three captures at once (the golden
# PAL, CLI_NOISY and Q3: run_tpu's fused dispatch and run_native).
Q3 = dict(n_frames=4, lpf=294, seed=5, noise=24.0)
Q3_CLI = {"m2": ["--format", "m2"], "bff": ["--field-order", "bff"],
          "16bit": ["--resolution", "16bit"],
          "force_coords": ["--force-coords", "40:1096"]}
GOLDEN_Q3_CLI_SHA256 = {
    "m2": "9f769956ad570514a0c0c7516355193131761c20e0d29d6c798232b1b6d87c67",
    "bff": "29a9c895653bffaacd86c07364c8e876cb509f4aae5d2b81951fc73f8e52ded4",
    "16bit":
        "d981f13345aab2f00ce8e92f41b66f6c669f82800bbe883a6789e2fd216538c8",
    "force_coords":
        "8388504374e3be21b37a32a42ab11e3d6db6779312f53e33cf430f8256119de9",
}
Q3_DRIVER = {"m2": dict(mode_m2=True),
             "bff_16bit": dict(preset_order=2, preset_resolution=2)}
GOLDEN_Q3_DRIVER_SHA256 = {
    "m2": "9f769956ad570514a0c0c7516355193131761c20e0d29d6c798232b1b6d87c67",
    "bff_16bit":
        "a7f4a5d35013438ce1a16913343fc3d77fe31c515eb2c304fcaa055e15fc16b2",
}
Q3_MULTI_KW = dict(lines_per_field=294, hyst_limit=2, shift_limit=1,
                   frames_per_round=5)
GOLDEN_Q3_MULTI_SHA256 = {
    "pal": GOLDEN_SHA256["pal"],
    "noisy":
        "1a00aea86593ab0ec3ee2c7f23ef45c621f88b1b3aaf93399bdd2c5d88d975c1",
    "q3": "8388504374e3be21b37a32a42ab11e3d6db6779312f53e33cf430f8256119de9",
}
SHARD_COPIES = 4        # the golden PAL capture, once per job


def write_container(path, frames, codec, drops=(), encoded=(None, None)):
    """frames in an AVI or (by the extension) Matroska file of `codec`,
    through the port's writers; `encoded` is (payloads, extradata) from
    encode_task, or None for the writer's own encode. Returns the path."""
    from sdvpcmdecoder_tpu_torch.pipeline import avi, mkv
    writer = mkv.write_mkv if str(path).endswith(".mkv") else avi.write_avi
    payloads, extradata = encoded
    writer(path, frames, codec=codec, drops=list(drops), payloads=payloads,
           extradata=extradata)
    return path


def wide_frames(n_frames, lpf, seed):
    """A 720-px PAL capture: capture_frames at 1440 px and 10 px a bit,
    every other column."""
    return np.ascontiguousarray(capture_frames(
        n_frames, lpf, seed, width=2 * 720, ppb=10.0)[:, :, ::2])


def write_arvid_capture(path, n_frames=4, seed=14, width=1024):
    """A y4m ArVid capture, PAL_LINES lines x `width` px of random 18 x
    8-bit word rows at 5.5 px a bit (the recipe of the JAX package's ArVid
    tests at full height). Returns (path, data coordinates)."""
    from sdvpcmdecoder_tpu_torch.formats import arvid
    from sdvpcmdecoder_tpu_torch.pipeline import ingest
    from sdvpcmdecoder_tpu_torch.synth import encoder as enc
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 256, size=(n_frames, PAL_LINES, arvid.WORD_CNT))
    vids = np.zeros((n_frames, PAL_LINES, width), np.uint8)
    for f in range(n_frames):
        px, coords = enc.render_bits(arvid.words_to_data_bits(words[f]),
                                     width=width, ppb=5.5)
        vids[f, 0::2] = px[:PAL_LINES // 2]
        vids[f, 1::2] = px[PAL_LINES // 2:]
    ingest.write_y4m(path, vids, chroma="mono")
    return path, coords


def encode_task(codec, recipe, count):
    """(payloads, extradata) of `codec` for the first `count` frames of
    capture_frames(*recipe): one task of the encoder pool (the frames are
    made in the worker, not pickled)."""
    from sdvpcmdecoder_tpu_torch.pipeline import avi
    return avi.resolve_payloads(capture_frames(*recipe)[:count], codec)


def _pin_to_last_cores():
    """Keep the encoder pool off the cores the timed phases run on."""
    import os
    n = os.cpu_count() or 1
    if n >= 6 and hasattr(os, "sched_setaffinity"):
        os.sched_setaffinity(0, range(n - 3, n))


def start_encodes():
    """The container phases' encodes, started in 3 spawned processes
    beside the builds (LAGS and FFV1 take seconds a PAL frame). Returns
    (pool, {name: future})."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    pool = ProcessPoolExecutor(3, mp_context=multiprocessing.get_context(
        "spawn"), initializer=_pin_to_last_cores)
    pal = (12, 294, 1)
    big = (DRIVER_FRAMES, 294, DRIVER_SEEDS[0])
    tasks = {"pal_HFYU": ("HFYU", pal, 12), "pal_ULY0": ("ULY0", pal, 12),
             "big_ULY0": ("ULY0", big, 64)}
    for codec in CROP_CODECS:
        tasks[f"slow_{codec}"] = (codec, pal, SLOW_FRAMES)
    return pool, {k: pool.submit(encode_task, *v) for k, v in tasks.items()}


def read_ms(path, n, first=1, batch=16, repeats=3):
    """A reader's cost on the card machine's host, in ms per PAL frame:
    (first call: open and read_frames(0, first); steady state: the other
    frames in batches of `batch`, median over `repeats` fresh readers)."""
    from sdvpcmdecoder_tpu_torch.pipeline import ingest
    firsts, steady = [], []
    for _ in range(repeats):
        t0 = time.perf_counter()
        with ingest.open_capture(path) as rd:
            rd.read_frames(0, first)
            t1 = time.perf_counter()
            for base in range(first, n, batch):
                rd.read_frames(base, min(batch, n - base))
            t2 = time.perf_counter()
        firsts.append((t1 - t0) * 1e3)
        steady.append((t2 - t1) * 1e3 / (n - first))
    return statistics.median(firsts), statistics.median(steady)


def sharded_run(jobs, devices, resident):
    """ShardedBatchDecoder over `jobs` on `devices`: (WAV bytes per job,
    the decoder, wall seconds, K1 launches)."""
    from sdvpcmdecoder_tpu_torch.ops import fused_binarize as fb
    from sdvpcmdecoder_tpu_torch.parallel.multichip import ShardedBatchDecoder
    fb.stc007_fused_decode_frames.launches = 0
    t0 = time.perf_counter()
    sh = ShardedBatchDecoder(jobs, devices=devices, device_resident=resident,
                             **Q3_MULTI_KW)
    sh.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return ([open(o, "rb").read() for _, o in jobs], sh, wall,
            fb.stc007_fused_decode_frames.launches)


def ingest_phases(dev, card, tmp, golden, big, cli_noisy, y4m_cli, encodes):
    """Phases C1-C9 (this slice): containers, their codecs' read times,
    the sharded drivers, the mesh step, the 720-px capture, ArVid and
    Queue 3's paths. y4m_cli: phase 17's CLI on big[0] under --backend tpu
    (frames/s, WAV bytes). Returns K1 launches per path."""
    import hashlib
    import os
    import shutil

    from sdvpcmdecoder_tpu_torch.ops import fused_binarize as fb
    from sdvpcmdecoder_tpu_torch.parallel import mesh as pm
    from sdvpcmdecoder_tpu_torch.pipeline import batch_driver as bd
    from sdvpcmdecoder_tpu_torch.pipeline import decoder
    from sdvpcmdecoder_tpu_torch.pipeline import ingest
    from sdvpcmdecoder_tpu_torch.synth import encoder as enc

    k1 = lambda: fb.stc007_fused_decode_frames.launches
    sha = lambda p: hashlib.sha256(open(p, "rb").read()).hexdigest()
    launches = {}
    pool, futures = encodes
    t0 = time.perf_counter()
    enc_out = {k: f.result() for k, f in futures.items()}
    pool.shutdown()
    print(f"[encode] LAGS/FFV1/HFYU/ULY0 payloads from the background pool "
          f"(3 spawned processes since phase 1): waited "
          f"{time.perf_counter() - t0:.2f} s here")

    # -- C1: the golden PAL capture in each container, through the CLI ---
    pal = capture_frames(12, 294, seed=1)
    fb.stc007_fused_decode_frames.launches = 0
    for kind, codec in CONTAINERS:
        path = write_container(os.path.join(tmp, f"pal_{codec}.{kind}"),
                               pal, codec, encoded=enc_out.get(
                                   f"pal_{codec}", (None, None)))
        for backend in CONTAINER_BACKENDS:
            out = os.path.join(tmp, f"pal_{codec}_{kind}_{backend}.wav")
            n0 = k1()
            rc, secs = cli_run([path, "-o", out]
                               + (["--backend", backend] if backend else []))
            check(rc == 0, f"CLI {kind}/{codec}/{backend}: exit {rc}")
            check(k1() > n0, f"CLI {kind}/{codec}/{backend}: no K1 launch")
            check(sha(out) == GOLDEN_CLI_SHA256["pal"],
                  f"CLI {kind}/{codec}/{backend}: WAV is not the JAX CLI's "
                  "of the same frames in y4m")
            print(f"[container] {codec} {kind.upper()}, --backend "
                  f"{backend or '(none)'}: WAV sha256 equals the JAX CLI's "
                  f"y4m golden ({secs:.2f} s, {k1() - n0} K1 launches)")

    # -- C2: the slow codecs' pixels, and every codec's read time ---------
    crop = np.ascontiguousarray(pal[:2, :CROP_LINES])
    for codec in CROP_CODECS:
        for kind in ("avi", "mkv"):
            path = write_container(os.path.join(tmp, f"crop_{codec}.{kind}"),
                                   crop, codec)
            with ingest.open_capture(path) as rd:
                got = rd.read_frames(0, 2)
            check(np.array_equal(got, crop),
                  f"{codec} {kind}: reader pixels differ from the source")
        print(f"[container] {codec} AVI and MKV, 2 frames x {CROP_LINES} "
              f"lines x {WIDTH} px: reader pixels == source pixels")
    timed = {}
    big_frames = capture_frames(DRIVER_FRAMES, 294, DRIVER_SEEDS[0])
    big_avi = {
        "Y800": write_container(os.path.join(tmp, "big_Y800.avi"),
                                big_frames, "Y800"),
        "ULY0": write_container(os.path.join(tmp, "big_ULY0.avi"),
                                big_frames[:64], "ULY0",
                                encoded=enc_out["big_ULY0"])}
    timed["Y800"] = (big_avi["Y800"], DRIVER_FRAMES)
    timed["ULY0"] = (big_avi["ULY0"], 64)
    timed["HFYU"] = (os.path.join(tmp, "pal_HFYU.avi"), 12)
    for codec in CROP_CODECS:
        path = write_container(os.path.join(tmp, f"slow_{codec}.avi"),
                               pal[:SLOW_FRAMES], codec,
                               encoded=enc_out[f"slow_{codec}"])
        with ingest.open_capture(path) as rd:
            check(np.array_equal(rd.read_frames(0, SLOW_FRAMES),
                                 pal[:SLOW_FRAMES]),
                  f"{codec} AVI: PAL-frame pixels differ from the source")
        timed[codec] = (path, SLOW_FRAMES)
    read_times = {}
    for codec, (path, n) in timed.items():
        first, steady = read_ms(path, n)
        read_times[codec] = dict(first_ms=first, ms_per_frame=steady,
                                 frames=n)
        print(f"[codec] {codec} AVI read, PAL 588 x {WIDTH}: first call "
              f"{first:.2f} ms (open + 1 frame), then {steady:.3f} ms a "
              f"frame ({1e3 / steady:.1f} frames/s; {n} frames, median of "
              f"3 readers, batches of 16) on the host of {card}")

    # -- C3: dropped slots, and the CLI on long AVIs beside the y4m ------
    drops = write_container(os.path.join(tmp, "drops.avi"), pal, "Y800",
                            drops=AVI_DROPS)
    out = os.path.join(tmp, "drops.wav")
    n0 = k1()
    rc, _ = cli_run([drops, "-o", out])
    check(rc == 0 and k1() > n0, f"CLI drops.avi: exit {rc}, "
          f"{k1() - n0} K1 launches")
    check(sha(out) == GOLDEN_AVI_SHA256,
          f"CLI drops.avi: WAV sha256 {sha(out)} is not the JAX CLI's")
    print(f"[container] Y800 AVI with slots {AVI_DROPS} dropped (14 "
          f"slots): WAV sha256 equals the JAX CLI's ({k1() - n0} K1 "
          "launches)")
    y4m_fps, y4m_wav = y4m_cli
    n0 = k1()
    out = os.path.join(tmp, "big_y4m_64.wav")
    rc, secs_y64 = cli_run([big[0], "-o", out, "--backend", "tpu",
                            "--frames", "64"])
    check(rc == 0, f"CLI big y4m --frames 64: exit {rc}")
    y4m_launches = k1() - n0   # not a container run: left out of the count
    y4m_64 = open(out, "rb").read()
    avi_fps = {}
    for codec, n in BIG_AVI:
        out = os.path.join(tmp, f"big_{codec}.wav")
        n0 = k1()
        rc, secs = cli_run([big_avi[codec], "-o", out, "--backend", "tpu"])
        check(rc == 0 and k1() > n0, f"CLI big {codec} AVI: exit {rc}")
        expect = y4m_wav if n == DRIVER_FRAMES else y4m_64
        check(open(out, "rb").read() == expect,
              f"CLI big {codec} AVI: WAV differs from the y4m's")
        avi_fps[codec] = n / secs
        print(f"[container] CLI --backend tpu on {n} PAL frames in a "
              f"{codec} AVI: {n / secs:.1f} frames/s ({k1() - n0} K1 "
              f"launches), WAV equals the y4m's; the y4m: "
              f"{y4m_fps if n == DRIVER_FRAMES else 64 / secs_y64:.1f} "
              f"frames/s (phase 17{'' if n == DRIVER_FRAMES else ', --frames 64'})"
              f" on {card}")
    launches["cli_containers"] = k1() - y4m_launches   # C1 and C3

    # -- C4: the chip-resident driver on a container ---------------------
    fb.stc007_fused_decode_frames.launches = 0
    wavs, dec, _, _ = driver_run([os.path.join(tmp, "pal_ULY0.mkv")], tmp,
                                 "mkv", True, **Q3_MULTI_KW)
    check(hashlib.sha256(wavs[0]).hexdigest() == GOLDEN_SHA256["pal"]
          and k1() > 0, "DeviceBatchDecoder on the ULY0 MKV: WAV is not "
          "the golden, or no K1 launch")
    wavs, dec, _, _ = driver_run([drops], tmp, "drops", True, **Q3_MULTI_KW)
    check(dec.jobs[0].stats.frames_dropped == len(AVI_DROPS),
          "DeviceBatchDecoder: frames_dropped not taken from the reader")
    launches["driver_containers"] = k1()
    print(f"[container] DeviceBatchDecoder on the ULY0 MKV: WAV equals "
          f"GOLDEN_SHA256['pal']; on drops.avi frames_dropped="
          f"{dec.jobs[0].stats.frames_dropped}; {k1()} K1 launches")

    # -- C5: ShardedBatchDecoder, 1 and 2 concurrent shards on one card --
    jobs = []
    for k in range(SHARD_COPIES):
        cap = os.path.join(tmp, f"shard{k}.y4m")
        shutil.copyfile(golden["pal"], cap)
        jobs.append((cap, os.path.join(tmp, f"shard{k}.wav")))
    launches["sharded"] = 0
    for resident in (False, True):
        ref = None
        for devices in ([dev], [dev, dev]):
            wavs, sh, wall, n = sharded_run(jobs, devices, resident)
            launches["sharded"] += n
            tag = (f"{len(devices)} shard(s), "
                   f"{'device_resident' if resident else 'streaming tpu'}")
            check(all(hashlib.sha256(w).hexdigest() == GOLDEN_SHA256["pal"]
                      for w in wavs), f"sharded {tag}: WAV not the golden")
            check(ref is None or wavs == ref, f"sharded {tag}: WAVs "
                  "differ from the 1-way run")
            check(np.array_equal(sh.stats, sh.shard_stats.sum(axis=0))
                  and sh.stats[0] == SHARD_COPIES * 12,
                  f"sharded {tag}: stats {sh.stats} vs {sh.shard_stats}")
            check(n > 0, f"sharded {tag}: no K1 launch")
            ref = wavs
            print(f"[sharded] {tag} on {[str(d) for d in devices]}: "
                  f"{SHARD_COPIES} x 12 PAL frames, every WAV equals "
                  f"GOLDEN_SHA256['pal'], stats {sh.stats.tolist()} == sum "
                  f"over shards; {n} K1 launches; {wall:.2f} s wall")

    # -- C6: the mesh step against decode_stream on the whole capture ----
    rng = np.random.default_rng(42)
    n_lines = 4 * pm.HALO + 112
    n = 3 * n_lines
    pixels, coords, _, _ = enc.encode_stream(
        rng.integers(1, 1 << 14, n), rng.integers(1, 1 << 14, n),
        width=WIDTH, ppb=8.0, n_lines=n_lines, noise_sigma=20.0, rng=rng)
    lv = [np.full(n_lines, v, np.int32) for v in (110, 20, 200)]
    whole = [torch.from_numpy(a).to(dev) for a in (pixels, coords, *lv)]
    fb.stc007_fused_decode_frames.launches = 0
    ref_k = decoder.decode_stream(*whole, hyst_limit=1, shift_limit=1)
    ref_p = decoder.decode_stream(*whole, hyst_limit=1, shift_limit=1,
                                  use_kernel=False)
    check(k1() == 1 and all(torch.equal(a, b) for a, b in zip(ref_k, ref_p)),
          "decode_stream: K1 route differs from the plain route")
    D, S = 2, 4
    grid = pm.decode_mesh(D * S, seq=S, devices=[dev])
    chunks, chunk = pm.chunk_lines_with_halo(pixels, S)
    Lc = chunks.shape[1]
    per = [np.broadcast_to(a[None], (D,) + a.shape).copy() for a in (
        chunks, pm.chunk_lines_with_halo(coords, S)[0])]
    per += [np.full((D, S, Lc), v, np.int32) for v in (110, 20, 200)]
    errs = [compare_k1(f"mesh chunk {Lc} lines x 1 (per-line coords)",
                       torch.from_numpy(chunks[0][:, None]).to(dev),
                       torch.from_numpy(per[1][0, 0]).to(dev),
                       tuple(torch.from_numpy(a[0, 0]).to(dev)
                             for a in per[2:]), (1, 1))]
    fb.stc007_fused_decode_frames.launches = 0
    step = pm.multichip_decode_step(grid, hyst_limit=1, shift_limit=1)
    gathered, n_valid = step(*(pm.shard_captures(a, grid) for a in per))
    torch.cuda.synchronize()
    launches["mesh_step"] = k1()
    check(k1() == D * S, f"mesh step: {k1()} K1 launches, not {D * S}")
    stitched = torch.cat([gathered[0][0][k, :3 * chunk] for k in range(S)])
    n_cmp = min(len(stitched), len(ref_k.samples))
    check(torch.equal(stitched[:n_cmp], ref_k.samples[:n_cmp])
          and int(n_valid[1][3]) > 0, "mesh step: samples differ from "
          "decode_stream on the whole capture")
    print(f"[mesh] multichip_decode_step on a {D} x {S} grid of {dev} "
          f"({n_lines} lines, chunks of {chunk} + {pm.HALO} halo): the "
          f"gathered samples equal decode_stream's on the whole capture "
          f"(K1 == plain there too); {D * S} K1 launches, grid-wide valid "
          f"lines {int(n_valid[0][0])}")

    # -- C7: a 720-px capture (1440-px rows on the card) -----------------
    wide = os.path.join(tmp, "wide.y4m")
    ingest.write_y4m(wide, wide_frames(**WIDE))
    fb.stc007_fused_decode_frames.launches = 0
    for backend in ("tpu", "device"):
        out = os.path.join(tmp, f"wide_{backend}.wav")
        n0 = k1()
        rc, _ = cli_run([wide, "-o", out, "--backend", backend])
        check(rc == 0 and k1() > n0, f"CLI 720-px/{backend}: exit {rc}")
        check(sha(out) == GOLDEN_WIDE_SHA256,
              f"CLI 720-px/{backend}: WAV is not the JAX CLI's")
    launches["cli_720px"] = k1()
    with ingest.open_capture(wide) as rd:
        lines_b, _ = ingest.split_fields_batch(rd.read_frames(0, 4))
    dbl = torch.from_numpy(lines_b).to(dev)
    _, wcd = enc.render_lines(np.zeros((4, 8), np.int64),
                              np.zeros(4, np.int64), width=2 * 720, ppb=10.0)
    wcd = torch.from_numpy(wcd).to(dev)   # the encoder's coords at 1440 px
    errs.append(compare_k1(f"720-px capture doubled, 4 x {dbl.shape[1]} x "
                           f"{dbl.shape[2]}", dbl, wcd, frame_levels(4, dev),
                           NORMAL))
    print(f"[wide] 720 x 576 capture, 1440-px rows on the card: CLI tpu "
          f"and device WAVs equal the JAX CLI's; "
          f"{launches['cli_720px']} K1 launches")

    # -- C8: ArVid (host numpy in both packages) -------------------------
    acap, acd = write_arvid_capture(os.path.join(tmp, "arvid.y4m"), **ARVID)
    out = os.path.join(tmp, "arvid.txt")
    n0 = k1()
    rc, secs = cli_run([acap, "-o", out, "--format", "arvid",
                        "--force-coords", f"{acd[0]}:{acd[1]}"])
    check(rc == 0, f"CLI --format arvid: exit {rc}")
    got = {"txt": sha(out), "bin": sha(os.path.join(tmp, "arvid.bin"))}
    check(got == GOLDEN_ARVID_SHA256, f"ArVid dump {got} is not the JAX "
          f"CLI's {GOLDEN_ARVID_SHA256}")
    launches["arvid"] = k1() - n0
    check(launches["arvid"] == 0, "ArVid launched K1")
    print(f"[arvid] --format arvid on {ARVID['n_frames']} frames x "
          f"{PAL_LINES} lines: dump and raw words equal the JAX CLI's "
          f"({secs:.2f} s, host numpy, 0 K1 launches)")

    # -- C9: Queue 3's paths on the card ----------------------------------
    q3 = write_capture(os.path.join(tmp, "q3.y4m"), **Q3)
    fb.stc007_fused_decode_frames.launches = 0
    for name, flags in Q3_CLI.items():
        for backend in ("tpu", "device"):
            if name == "force_coords" and backend == "device":
                continue
            out = os.path.join(tmp, f"q3_{name}_{backend}.wav")
            n0 = k1()
            rc, _ = cli_run([q3, "-o", out, "--backend", backend] + flags)
            check(rc == 0 and k1() > n0, f"CLI {name}/{backend}: exit {rc}")
            check(sha(out) == GOLDEN_Q3_CLI_SHA256[name],
                  f"CLI {name}/{backend}: WAV is not the JAX CLI's")
        print(f"[queue3] CLI {' '.join(flags)} under --backend tpu"
              f"{'' if name == 'force_coords' else ' and device'}: WAV "
              "equals the JAX CLI's")
    for name, kw in Q3_DRIVER.items():
        got = {}
        for use_kernel in (True, False):
            wavs, _, _, _ = driver_run([q3], tmp, f"q3{name}{use_kernel}",
                                       use_kernel, **Q3_MULTI_KW, **kw)
            got[use_kernel] = wavs[0]
        check(got[True] == got[False], f"driver {name}: K1 WAV differs "
              "from the plain binarize's")
        check(hashlib.sha256(got[True]).hexdigest()
              == GOLDEN_Q3_DRIVER_SHA256[name],
              f"driver {name}: WAV is not the JAX driver's")
        print(f"[queue3] DeviceBatchDecoder {kw}: K1 == plain, WAV equals "
              "the JAX driver's")
    multi = {"pal": golden["pal"], "noisy": cli_noisy, "q3": q3}
    for backend in ("tpu", "native"):
        jobs = [(cap, os.path.join(tmp, f"multi_{backend}_{k}.wav"))
                for k, cap in multi.items()]
        n0 = k1()
        bd.BatchDecoder(jobs, backend=backend, device=DEVICE,
                        **Q3_MULTI_KW).run()
        for (cap, out), name in zip(jobs, multi):
            check(sha(out) == GOLDEN_Q3_MULTI_SHA256[name],
                  f"BatchDecoder {backend}, 3 captures: {name}'s WAV is not "
                  "the JAX package's")
        check((k1() > n0) == (backend == "tpu"),
              f"BatchDecoder {backend}: {k1() - n0} K1 launches")
        print(f"[queue3] BatchDecoder --backend {backend} on 3 captures at "
              f"once (run_{backend}): each WAV equals the JAX package's "
              f"({k1() - n0} K1 launches)")
    launches["queue3"] = k1()
    return launches, errs, dict(read_ms=read_times, cli_avi_fps=avi_fps,
                                cli_y4m_fps=y4m_fps)


# ---- S1: a tree that holds only the port --------------------------------
# The child runs with JAX and the JAX package blocked: importing either
# raises ImportError.
PORT_ONLY_CHILD = ('import sys; sys.modules["jax"] = None; '
                   'sys.modules["sdvpcmdecoder_tpu"] = None; '
                   'import chip_smoke; chip_smoke.port_only_child()')


def port_only_tree(dst):
    """Copy sdvpcmdecoder_tpu_torch/ and this script, and nothing else of
    the repository (no JAX package, no build/), into the directory dst.
    Returns dst as a Path."""
    import shutil
    here, dst = Path(__file__).resolve().parent, Path(dst)
    shutil.copytree(here / "sdvpcmdecoder_tpu_torch",
                    dst / "sdvpcmdecoder_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(here / "chip_smoke.py", dst)
    return dst


def port_only_phase():
    """S1: run port_only_child in a subprocess whose working directory is
    a port_only_tree in a temporary directory, with no PYTHONPATH.
    Returns (the child's JSON result, the phase's wall seconds, copy and
    subprocess included)."""
    import os
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        tree = port_only_tree(tmp)
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        proc = subprocess.run([sys.executable, "-c", PORT_ONLY_CHILD],
                              cwd=tree, env=env, capture_output=True,
                              text=True, timeout=600)
    wall = time.perf_counter() - t0
    lines = proc.stdout.strip().splitlines()
    for ln in lines[:-1]:
        print(f"[S1] {ln}")
    check(proc.returncode == 0 and lines, f"S1 port-only tree: exit "
          f"{proc.returncode}: {proc.stderr[-3000:]}")
    return json.loads(lines[-1]), wall


def port_only_child():
    """S1's body, in a tree of sdvpcmdecoder_tpu_torch/ and chip_smoke.py
    alone: builds K1 with nvcc and, beside it, the native core and loader
    with g++ into the tree's own empty build/; holds K1 against its plain
    version on the round's shape; then, K1's launches counted from 0,
    decodes the golden PAL capture through the CLI under tpu and device
    and through DeviceBatchDecoder, the PCM-1 golden under --backend
    device, and the golden PAL frames as a ULY0 AVI under tpu (the native
    codec), each WAV held to the JAX package's hash. Prints its result as
    one JSON line, the last."""
    import hashlib
    import os
    from concurrent.futures import ThreadPoolExecutor

    import sdvpcmdecoder_tpu_torch
    from sdvpcmdecoder_tpu_torch.ops import _kernels
    from sdvpcmdecoder_tpu_torch.ops import fused_binarize as fb
    from sdvpcmdecoder_tpu_torch.ops import stitch_native as sn
    from sdvpcmdecoder_tpu_torch.pipeline import ingest

    here = Path.cwd().resolve()
    check(not (here / "sdvpcmdecoder_tpu").exists()
          and not any((Path(p or ".").resolve() / "sdvpcmdecoder_tpu")
                      .exists() for p in sys.path),
          "S1: the JAX package is reachable from the port-only tree")
    check(not (here / "build").exists(), "S1: the tree holds a build/")
    for what, path in (("the package", sdvpcmdecoder_tpu_torch.__file__),
                       ("chip_smoke.py", __file__),
                       ("native/", sn.NATIVE_SRC),
                       ("build/native/", sn.BUILD_DIR),
                       ("csrc/", _kernels.CSRC),
                       ("build/kernels/", _kernels.BUILD_DIR)):
        check(Path(path).resolve().is_relative_to(here),
              f"S1: {what} lies outside the tree: {path}")
    dev = torch.device(DEVICE)
    torch.cuda.set_device(dev)

    with ThreadPoolExecutor(2) as pool:   # g++ beside nvcc
        core = pool.submit(sn.build, "stitchcore.cpp")
        loader = pool.submit(ingest.build_loader)
        builds = {"nvcc_k1": _kernels.build("stc007_binarize"),
                  "gxx_core": core.result(), "gxx_loader": loader.result()}
    for name, b in builds.items():
        check(b.seconds > 0 and b.path.resolve().is_relative_to(
            here / "build"), f"S1: {name} was not built into the tree's "
              f"build/: {b.path}")
    check(sn.available() and Path(sn._load()._name) == builds["gxx_core"]
          .path, "S1: the native core loaded is not the tree's")

    nr = ROUND_FRAMES
    px, cd, _, _ = encode_frames(nr, 30.0, seed=1, device=dev)
    err = compare_k1(f"port-only tree, {nr} frames sigma=30", px, cd,
                     frame_levels(nr, dev), NORMAL)
    del px, cd

    k1 = lambda: fb.stc007_fused_decode_frames.launches
    hashes, launches = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        pal = write_capture(os.path.join(tmp, "pal.y4m"), 12, 294, seed=1)
        pcm1 = write_pcm1_capture(os.path.join(tmp, "pcm1.y4m"),
                                  **PCM_GOLDEN["pcm1"][2])
        uly0 = write_container(os.path.join(tmp, "pal_ULY0.avi"),
                               capture_frames(12, 294, seed=1), "ULY0")
        runs = {   # name: (CLI arguments or None for the driver, sha256)
            "cli_tpu": ([pal, "--backend", "tpu"], GOLDEN_CLI_SHA256["pal"]),
            "cli_device": ([pal, "--backend", "device"],
                           GOLDEN_CLI_SHA256["pal"]),
            "driver": (None, GOLDEN_SHA256["pal"]),
            "pcm1_device": ([pcm1, "--format", "pcm1", "--backend",
                             "device"], GOLDEN_PCM_SHA256["pcm1"]),
            "uly0_avi_tpu": ([uly0, "--backend", "tpu"],
                             GOLDEN_CLI_SHA256["pal"])}
        fb.stc007_fused_decode_frames.launches = 0
        for name, (argv, want) in runs.items():
            n0 = k1()
            if argv is None:
                wavs, _, _, _ = driver_run(
                    [pal], tmp, name, True, lines_per_field=294,
                    hyst_limit=2, shift_limit=1, frames_per_round=5)
                data = wavs[0]
            else:
                out = os.path.join(tmp, f"{name}.wav")
                rc, _ = cli_run(argv + ["-o", out])
                check(rc == 0, f"S1 {name}: exit code {rc}")
                data = open(out, "rb").read()
            digest = hashlib.sha256(data).hexdigest()
            launches[name] = k1() - n0
            hashes[name] = digest == want
            check(hashes[name], f"S1 {name}: WAV sha256 {digest} is not "
                  f"the JAX package's {want}")
            # The PCM grid is plain torch: no K1 there (as in P2).
            check((launches[name] > 0) == (name != "pcm1_device"),
                  f"S1 {name}: {launches[name]} K1 launches")
        total = k1()
    print(json.dumps(dict(
        builds={k: dict(seconds=b.seconds, path=str(b.path.relative_to(
            here))) for k, b in builds.items()},
        max_abs_err=err, hashes=hashes, launches=launches,
        k1_launches=total)))


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
    encodes = start_encodes()   # the container phases' payloads
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
    # The same chained round as a CUDA graph: warmed (eager first use,
    # capture), then each call one replay with its copies in and out.
    from sdvpcmdecoder_tpu_torch.ops.round_graph import RoundGraphs
    graphs = RoundGraphs(dev)

    def graph_round():
        return dd.run_round(
            cpx[F:2 * F], par1, state1, rows, en_p=True, en_q=True,
            m2=False, hyst_limit=NORMAL[0], shift_limit=NORMAL[1],
            use_kernel=True, chained=True, tables=tables, graphs=graphs)

    graph_round(), graph_round()   # the key's eager first use, capture
    n0 = fb.stc007_fused_decode_frames.launches
    g1_round = graph_round_stats(graph_round, one_round(True))
    n_k1 = fb.stc007_fused_decode_frames.launches - n0
    check(n_k1 == 16, f"G1 round: K1 counted {n_k1} times for 16 rounds")
    print(f"[G1-round] steady_round_packed chained round {F}x{PAL_LINES}x"
          f"{WIDTH} NORMAL with K1: {g1_round} (CUDA-event ms, median of "
          f"5, alternating; kernel rows, host calls and device ms of one "
          f"call under torch.profiler); K1 counted once a round either way"
          f" on {card}")
    del graphs
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
    sweep_cap = write_capture(os.path.join(tmp, "sweep.y4m"),
                              SWEEP_CAP_FRAMES, 294, seed=3,
                              noise=SWEEP_CAP_SIGMA)
    print(f"[captures] golden PAL 12 and NTSC 10 frames, 2 x "
          f"{DRIVER_FRAMES} PAL frames (seeds {DRIVER_SEEDS}), noisy "
          f"{NOISY_FRAMES} PAL frames sigma=26 and {SWEEP_CAP_FRAMES} "
          f"sigma={SWEEP_CAP_SIGMA}: written in "
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

    # -- phase G1: the driver's rounds as CUDA graphs against eager ---------
    g1, wg1 = round_graph_phase(
        "G1", dd, dd.DeviceBatchDecoder, big, tmp, card, n_fr,
        device=DEVICE, use_kernel=True, **dkw)
    check(wg1 == wk and g1["graph"]["k1_launches"] == launches_driver,
          f"G1: WAVs or K1 launches ({g1['graph']['k1_launches']}) differ "
          f"from phase 12's")
    g1["round"] = g1_round

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

    # -- phase 14: the level sweep, K1 route against the plain route --------
    errs_sweep = []
    ns = SWEEP_FRAMES
    spx, scd, _, _ = encode_frames(ROUND_FRAMES, 30.0, seed=9, device=dev)
    dim_frame = dim_lines(px[0], [5, 11, 17] + list(range(100, 140)))[None]
    i32 = lambda v, n: torch.full((n,), v, dtype=torch.int32, device=dev)
    bucket = dim_frame[0, :64].reshape(64, 1, WIDTH).contiguous()
    for mode, limits in (("NORMAL", NORMAL), ("INSANE", INSANE)):
        errs_sweep.append(compare_sweep(
            f"{mode} {ns} frames sigma=30", spx[:ns], scd[:ns], i32(20, ns),
            i32(200, ns), limits))
        errs_sweep.append(compare_sweep(
            f"{mode} 1 frame, 43 lines dimmed to 5..60, black 8 white 150",
            dim_frame, cd[:1], i32(8, 1), i32(150, 1), limits))
        errs_sweep.append(compare_sweep(
            f"{mode} bucket shape 64 x 1 line", bucket,
            cd[:1].expand(64, 2).contiguous(), i32(20, 64), i32(200, 64),
            limits))
    lv_dev = torch.from_numpy(SWEEP_LEVELS).to(dev)
    R = len(SWEEP_LEVELS)
    nr = ROUND_FRAMES
    bk16, wt16 = i32(20, nr), i32(200, nr)
    # The launch count is the wrapper's own; the trace shows that nothing
    # but K1 ran and nothing was copied (CUPTI has handed back traces of a
    # sweep that lack a few of its 64 rows, three times in a row).
    sweep_call = lambda: fb.stc007_ref_sweep_decode(
        spx, scd, bk16, wt16, lv_dev, *NORMAL)
    fb.stc007_fused_decode_frames.launches = 0
    sweep_call()
    counted = fb.stc007_fused_decode_frames.launches
    rows = cuda_rows(sweep_call, launches=R)
    sweep_trace = (len(rows["kernels"]), len(rows["copies"]))
    print(f"[launch] stc007_ref_sweep_decode: one call launches K1 "
          f"{counted} times (the wrapper's count); its trace holds "
          f"{len(rows['kernels'])} kernel row(s) "
          f"{sorted(set(rows['kernels']))} and {len(rows['copies'])} copies "
          f"{rows['copies']} (torch.profiler CUDA rows)")
    check(counted == R and 0 < len(rows["kernels"]) <= R
          and set(rows["kernels"]) == {"stc007_binarize_frames_kernel"}
          and not rows["copies"],
          f"sweep: not {R} K1 launches and nothing else: counted "
          f"{counted}, trace {rows}")
    sweep_times = []
    for mode, limits in (("NORMAL", NORMAL), ("INSANE", INSANE)):
        last = {}   # the timed calls' results: the round's shape is held
        # against the plain sweep too, at no further plain call

        def k_call():
            last["k1"] = fb.stc007_ref_sweep_decode(
                spx, scd, bk16, wt16, lv_dev, *limits)

        def p_call():
            last["plain"] = bz.stc007_ref_sweep_decode(
                spx, scd, bk16, wt16, lv_dev, *limits)
        sk_ms, sp_ms = median_ms_abab(k_call, p_call, rounds=3)
        torch.cuda.synchronize()
        errs_sweep.append(sweeps_equal(
            f"{mode} {nr} frames sigma=30 (the round's shape, as timed)",
            last["k1"], last["plain"], (nr, PAL_LINES), bk16, wt16, limits))
        last.clear()
        host = []
        for _ in range(5):
            t0 = time.perf_counter()
            k_call()
            host.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
        sweep_times.append(dict(frames=nr, mode=f"{mode} sigma=30",
                                levels=R, k1_route_ms=sk_ms,
                                plain_route_ms=sp_ms,
                                host_ms=statistics.median(host)))
        print(f"[time] ref sweep {nr}x{PAL_LINES}x{WIDTH} {mode} sigma=30, "
              f"{R} levels: K1 route {sk_ms} ms = {sk_ms / R} ms a level, "
              f"plain route {sp_ms} ms (CUDA events, median of 3, "
              f"alternating); K1 route host time {statistics.median(host)} "
              f"ms a call (host clock, median of 5) on {card}")

    # -- phase 14b: the streamed dispatch with per-line levels --------------
    # (--per-line-agc): levels [F, L] go through K1 as per-frame ones do.
    import dataclasses
    from sdvpcmdecoder_tpu_torch.pipeline import v2d
    agc_px = spx.cpu().numpy()
    agc_res, agc_count = {}, {}
    for use_kernel in (True, False):
        drv = v2d.V2DDriver(hyst_limit=NORMAL[0], shift_limit=NORMAL[1],
                            per_line_agc=True, device=dev,
                            use_kernel=use_kernel)
        check(drv.prepare_frames(agc_px[:1])["refs"].ndim == 2,
              "per-line AGC: the prepared levels are not [F, L]")
        fb.stc007_fused_decode_frames.launches = 0
        agc_res[use_kernel] = drv.decode_frames(agc_px)
        agc_count[use_kernel] = (fb.stc007_fused_decode_frames.launches,
                                 drv.fallback_batches)
    launches_agc, agc_fb = agc_count[True]
    check(launches_agc == 1 + agc_fb and agc_count[False][0] == 0,
          f"per-line AGC: K1 launches, fallback batches {agc_count}")
    for f, (a, b) in enumerate(zip(agc_res[True], agc_res[False])):
        check(a is not None and b is not None, f"per-line AGC: frame {f} "
              f"not decoded")
        for fld in dataclasses.fields(a):
            x, y = getattr(a, fld.name), getattr(b, fld.name)
            check(np.array_equal(x, y) and np.asarray(x).dtype
                  == np.asarray(y).dtype,
                  f"per-line AGC: frame {f} {fld.name} differs between the "
                  f"K1 route and the plain route")
    agc_valid = sum(int(r.valid.sum()) for r in agc_res[True])
    print(f"[agc] V2DDriver(per_line_agc=True).decode_frames, {nr} PAL frames "
          f"sigma=30 NORMAL, levels [F, L]: K1 route == plain route on every "
          f"FrameDecodeResult field; lines valid {agc_valid}/"
          f"{nr * PAL_LINES}; K1 launches {launches_agc} = 1 dispatch + "
          f"{agc_fb} fallback batches (plain route: 0)")
    del spx, dim_frame, bucket, agc_px, agc_res

    # -- phase 15: the driver at the CLI's default quality ------------------
    qkw = dict(dkw, ref_sweep_fallback=True, normal_sweep_prescan=True)
    fb.stc007_fused_decode_frames.launches = 0
    wq, decq, stage_q, wall_q = driver_run(big, tmp, "bigq", True, **qkw)
    launches_default = fb.stc007_fused_decode_frames.launches
    sweeps_q = sum(j.driver.sweep_calls for j in decq.jobs)
    rounds_q = sum(len(j.round_chained) for j in decq.jobs)
    fb_q = sum(j.driver.fallback_batches for j in decq.jobs)
    check(launches_default == rounds_q + fb_q + R * sweeps_q,
          f"default quality: K1 launched {launches_default} times for "
          f"{rounds_q} rounds, {fb_q} fallback batches, {sweeps_q} sweeps")
    for j in decq.jobs:
        check(j.stats.lines_valid == j.stats.lines_total
              == DRIVER_FRAMES * PAL_LINES, "default quality: invalid lines")
    stq = {k: round(decq.stage_t[k], 4) for k in (
        "dispatch", "prescan", "materialize", "finalize", "assemble",
        "stitch", "audio", "wav")}
    print(f"[driver] default quality (NORMAL + prescan sweep + sweep "
          f"fallback), {len(big)} x {DRIVER_FRAMES} PAL frames: decode wall "
          f"{wall_q} s = {n_fr / wall_q} frames/s (phase 12, no sweeps: "
          f"{n_fr / wall_k} frames/s); WAVs equal phase 12's: {wq == wk}; "
          f"sweeps on the card {sweeps_q}; K1 launches {launches_default}; "
          f"stage_t {stq} on {card}")
    fb.stc007_fused_decode_frames.launches = 0
    skw = dict(qkw, hbm_frames=SWEEP_CAP_FRAMES)
    ws, decs, _, wall_s = driver_run([sweep_cap], tmp, "sweep1", True, **skw)
    launches_sweepcap = fb.stc007_fused_decode_frames.launches
    wsp, decsp, _, wall_sp = driver_run([sweep_cap], tmp, "sweep0", False,
                                        **skw)
    js = decs.jobs[0]
    sweeps_k = js.driver.sweep_calls
    check(ws == wsp, "sweep capture: the kernel route's WAV differs from "
          "the plain route's")
    check(sweeps_k > 0 and sweeps_k == decsp.jobs[0].driver.sweep_calls,
          f"sweep capture: {sweeps_k} sweeps on the K1 route, "
          f"{decsp.jobs[0].driver.sweep_calls} on the plain route")
    check(launches_sweepcap == len(js.round_chained)
          + js.driver.fallback_batches + R * sweeps_k,
          f"sweep capture: {launches_sweepcap} K1 launches")
    print(f"[driver] default quality on {SWEEP_CAP_FRAMES} PAL frames "
          f"sigma={SWEEP_CAP_SIGMA}: kernel and plain WAVs byte-equal; "
          f"lines valid {js.stats.lines_valid}/{js.stats.lines_total}; "
          f"sweeps {sweeps_k} (x {R} levels), K1 launches "
          f"{launches_sweepcap} = {len(js.round_chained)} rounds + "
          f"{js.driver.fallback_batches} fallback batches + {R * sweeps_k}; "
          f"wall kernel {wall_s} s (finalize "
          f"{decs.stage_t['finalize']:.4f} s), plain {wall_sp} s (finalize "
          f"{decsp.stage_t['finalize']:.4f} s) on {card}")

    # -- phase 16: INSANE (the full sweep on every frame) --------------------
    ikw = dict(lines_per_field=294, hyst_limit=INSANE[0],
               shift_limit=INSANE[1], frames_per_round=ROUND_FRAMES,
               ref_sweep=True, normal_sweep_prescan=True)
    fb.stc007_fused_decode_frames.launches = 0
    wi, deci, _, wall_i = driver_run([noisy_cap], tmp, "insane1", True,
                                     **ikw)
    launches_insane = fb.stc007_fused_decode_frames.launches
    wip, decip, _, wall_ip = driver_run([noisy_cap], tmp, "insane0", False,
                                        **ikw)
    ji = deci.jobs[0]
    check(wi == wip, "INSANE: the kernel route's WAV differs from the plain "
          "route's")
    check(ji.driver.sweep_calls >= len(ji.round_chained)
          and launches_insane == len(ji.round_chained)
          + ji.driver.fallback_batches + R * ji.driver.sweep_calls,
          f"INSANE: {launches_insane} K1 launches, {ji.driver.sweep_calls} "
          f"sweeps, {len(ji.round_chained)} rounds")
    print(f"[insane] {NOISY_FRAMES} PAL frames sigma=26, ref_sweep: kernel "
          f"and plain WAVs byte-equal; lines valid {ji.stats.lines_valid}/"
          f"{ji.stats.lines_total}; sweeps {ji.driver.sweep_calls}; K1 "
          f"launches {launches_insane}; wall kernel route {wall_i} s "
          f"(finalize {deci.stage_t['finalize']:.4f} s), plain route "
          f"{wall_ip} s (finalize {decip.stage_t['finalize']:.4f} s) on "
          f"{card}")

    # -- phase 17: the CLI ----------------------------------------------------
    fb.stc007_fused_decode_frames.launches = 0
    cli_caps = {"pal": golden["pal"],
                "noisy": write_capture(os.path.join(tmp, "cli_noisy.y4m"),
                                       **CLI_NOISY)}
    cli_k1 = lambda: fb.stc007_fused_decode_frames.launches
    for name, cap in cli_caps.items():
        for quality, backend, extra in CLI_GOLDEN_RUNS:
            out = os.path.join(tmp, f"cli_{name}_{quality}_{backend}.wav")
            n0 = cli_k1()
            rc, secs = cli_run([cap, "-o", out, "--quality", quality,
                                "--backend", backend] + extra)
            check(rc == 0, f"CLI {name} {quality}/{backend}: exit {rc}")
            # Every backend but the explicit native one runs the trial
            # grid on the card: auto is the card's route on --device cuda.
            check(backend == "native" or cli_k1() > n0,
                  f"CLI {name} {quality}/{backend}: no K1 launch")
            digest = hashlib.sha256(open(out, "rb").read()).hexdigest()
            check(digest == GOLDEN_CLI_SHA256[name],
                  f"CLI {name} {quality}/{backend}: WAV sha256 {digest} is "
                  f"not the JAX CLI's {GOLDEN_CLI_SHA256[name]}")
            print(f"[cli] {name} capture --quality {quality} --backend "
                  f"{backend}: WAV sha256 equals the JAX CLI's "
                  f"({secs:.2f} s, {cli_k1() - n0} K1 launches)")
    cli_fps, cli_big_k1 = {}, {}
    for backend in ("device", "tpu", "native", None):
        tag = backend or "default"
        out = os.path.join(tmp, f"cli_big_{tag}.wav")
        n0 = cli_k1()
        rc, secs = cli_run([big[0], "-o", out]
                           + (["--backend", backend] if backend else []))
        check(rc == 0, f"CLI big/{tag}: exit code {rc}")
        cli_fps[tag] = DRIVER_FRAMES / secs
        cli_big_k1[tag] = cli_k1() - n0
        check(open(out, "rb").read() == wq[0],
              f"CLI big/{tag}: WAV differs from the driver's at the "
              f"same quality")
    # With no --backend and no --device the grid of every batch is a K1
    # launch; only the explicit native backend keeps it on the host.
    check(cli_big_k1["default"] == cli_big_k1["tpu"]
          >= DRIVER_FRAMES // ROUND_FRAMES and cli_big_k1["native"] == 0,
          f"CLI: K1 launches per backend on the clean capture {cli_big_k1}")
    agc_wavs = {}
    for backend in ("auto", "native"):
        out = os.path.join(tmp, f"cli_agc_{backend}.wav")
        n0 = cli_k1()
        rc, _ = cli_run([cli_caps["noisy"], "-o", out, "--per-line-agc",
                         "--backend", backend])
        check(rc == 0, f"CLI --per-line-agc/{backend}: exit code {rc}")
        check(backend == "native" or cli_k1() > n0,
              "CLI --per-line-agc: no K1 launch for the per-line grid")
        agc_wavs[backend] = open(out, "rb").read()
    check(agc_wavs["auto"] == agc_wavs["native"] and len(agc_wavs["auto"])
          > 2000, "CLI --per-line-agc: the card's WAV differs from the "
          "native backend's")
    print("[cli] --per-line-agc on the sigma=34 capture: --backend auto (K1 "
          "on levels [F, L]) and --backend native write the same WAV")
    print(f"[cli] {DRIVER_FRAMES} PAL frames at the defaults (--quality "
          f"normal, --batch 16), WAVs equal phase 15's: "
          + ", ".join(f"--backend {b} {f} frames/s ({cli_big_k1[b]} K1 "
                      f"launches)" for b, f in cli_fps.items())
          + f" (wall of main(), capture open to WAV close) on {card}")
    launches_cli = fb.stc007_fused_decode_frames.launches
    check(launches_cli > 0, "the CLI launched no K1 kernel")
    out = os.path.join(tmp, "cli_module.wav")
    proc = subprocess.run(
        [sys.executable, "-m", "sdvpcmdecoder_tpu_torch", golden["pal"],
         "-o", out, "--backend", "device"],
        cwd=str(Path(__file__).resolve().parent), capture_output=True,
        text=True, timeout=300)
    check(proc.returncode == 0, f"python -m sdvpcmdecoder_tpu_torch: exit "
          f"{proc.returncode}: {proc.stderr[-2000:]}")
    digest = hashlib.sha256(open(out, "rb").read()).hexdigest()
    check(digest == GOLDEN_CLI_SHA256["pal"],
          "python -m sdvpcmdecoder_tpu_torch: WAV differs from the JAX CLI's")
    print(f"[cli] python -m sdvpcmdecoder_tpu_torch pal.y4m --backend device "
          f"(a subprocess): WAV sha256 equals the JAX CLI's; it printed: "
          f"{proc.stdout.strip().splitlines()[-1]}")

    # -- phases P1-P5: PCM-1 and PCM-16x0 -----------------------------------
    launches_pcm = pcm_phases(dev, card, tmp)

    # -- phase G3: the streaming backend and the stream chain as graphs ----
    g3, launches_g3 = stream_graph_phase(dev, card, tmp, big, px, cd,
                                         levels)

    # -- phase G4: the stitcher's device seam route as graphs --------------
    g4, launches_g4 = seam_graph_phase(card, tmp, big, noisy_cap)

    # -- phases C1-C9: containers, multi-GPU, ArVid and Queue 3's paths --
    launches_ingest, errs_ingest, ingest_times = ingest_phases(
        dev, card, tmp, golden, big, cli_caps["noisy"],
        (cli_fps["tpu"], wq[0]), encodes)
    errs += errs_ingest
    tmpdir.cleanup()

    # -- phase S1: a tree that holds only the port ---------------------------
    s1, s1_wall = port_only_phase()
    errs.append(s1["max_abs_err"])
    b = s1["builds"]
    print(f"[S1] port-only tree (sdvpcmdecoder_tpu_torch/ and chip_smoke.py, "
          f"JAX and the JAX package blocked): builds nvcc K1 "
          f"{b['nvcc_k1']['seconds']} s, g++ core "
          f"{b['gxx_core']['seconds']} s, g++ loader "
          f"{b['gxx_loader']['seconds']} s (g++ beside nvcc, into the tree's "
          f"own build/); WAV hashes equal the JAX package's: {s1['hashes']}; "
          f"K1 == plain; K1 launches {s1['k1_launches']} "
          f"{s1['launches']}; phase wall {s1_wall} s on {card}")
    check(tree_digest(sn.NATIVE_SRC) == native_before,
          "the port's native/ changed during the run")
    print("[native] sdvpcmdecoder_tpu_torch/native/ unchanged by the run")

    launches_k1 = {"decode_frames": launches,
                   "steady_round_packed": launches_round,
                   "driver_golden": launches_golden,
                   "driver_full_width": launches_driver,
                   "driver_noisy": launches_noisy,
                   "driver_default_quality": launches_default,
                   "driver_sweep_fallback": launches_sweepcap,
                   "driver_insane": launches_insane,
                   "v2d_per_line_agc": launches_agc,
                   "cli": launches_cli,
                   # The PCM paths run the plain torch grid: 0 launches,
                   # counted (pcm_phases checks it).
                   "pcm_device": launches_pcm["pcm_device"],
                   "pcm_cli": launches_pcm["pcm_cli"],
                   "stream_graphs_G3": launches_g3,
                   "seam_tpu_G4": launches_g4,
                   **launches_ingest,
                   "port_only_tree": s1["k1_launches"]}
    print("[graphs-json] " + json.dumps(dict(G1=g1, G3=g3, G4=g4)))
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
             timings=k1_times, sweep_max_abs_err=max(errs_sweep),
             sweep_timings=sweep_times,
             # launches and launches_by_path are the wrapper's counter;
             # the profiler's trace of one sweep call is beside it.
             sweep_call=dict(launches_counted=counted,
                             trace_kernel_rows=sweep_trace[0],
                             trace_copies=sweep_trace[1]),
             ingest=ingest_times),
        dict(KERNEL2, launches=launches2, max_abs_err=max(errs2),
             ms=k2_ms, plain_ms=k2p_ms, bound_ms=k2_bound, bound_by=k2_by,
             library_ms=None, bound_share=k2_bound / k2_ms,
             wrapper_ms=k2w_ms)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
