"""One run of one cell: set-up, the measured window, the traced window,
the check against the plain reference, the result line.

Set-up: the pool of captures from the seed, then one warm-up driver run
of `captures_per_run` jobs over the mix's warm-up capture (builds K1 and
the native core on a checkout's first run, and meets the round shapes,
the staging chunks and the concurrency of the window). Window: a closed
loop of driver runs, each a new decoder over the next `captures_per_run`
captures, constructed as the configuration's `decoder` says, until
`seconds` have passed; the last run is let finish.
Every WAV of the window is kept and compared afterwards.
"""
from __future__ import annotations

import contextlib
import gc
import json
import os
import shutil
import sys
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path

from . import cells, compare, media as sg, pool, tracing

FORBIDDEN = ("jax", "jaxlib", "flax", "sdvpcmdecoder_tpu")
TRACE_RUNS = 1   # driver runs a traced window holds (~100,000 rows each)
def log(*a):
    print(*a, file=sys.stderr, flush=True)


# -- the program ---------------------------------------------------------------
def driver(cfg, device):
    """(decoder class, keyword arguments) as the configuration's `decoder`
    names them: `class`, a dotted name, and `kwargs`, passed as they are
    (a value {"symbol": dotted name} is that name's object), with the
    device. The class refuses a keyword it does not take."""
    import importlib
    d = cfg["decoder"]
    if set(d) != {"class", "kwargs"}:
        raise ValueError(f"decoder: keys {sorted(d)}, want class and kwargs")

    def obj(dotted):
        mod, _, name = dotted.rpartition(".")
        return getattr(importlib.import_module(mod), name)

    kw = {k: obj(v["symbol"]) if isinstance(v, dict) else v
          for k, v in d["kwargs"].items()}
    return obj(d["class"]), dict(kw, device=device)


@dataclass
class Record:
    """What a run measured; the metric readers read it."""
    cell: object = None
    setup_s: float = 0.0
    window_s: float = 0.0
    frames: int = 0
    runs: int = 0
    stage_t: dict = field(default_factory=dict)
    graphs: dict = field(default_factory=lambda: dict(
        eager_rounds=0, captures=0, replays=0))
    trace: dict = None
    spans: list = field(default_factory=list)
    wavs: list = field(default_factory=list)   # (pool index, path)
    walls: list = field(default_factory=list)  # each driver run's wall


def instrumented(base, rec: Record):
    """The decoder with the benchmark's hooks: a span around each of the
    program's `_stage` blocks, the stitch and each visit."""
    from time import perf_counter_ns

    class Bench(base):
        @contextlib.contextmanager
        def _stage(self, name):
            t0 = perf_counter_ns()
            try:
                with super()._stage(name):
                    yield
            finally:
                rec.spans.append((name, t0, perf_counter_ns()))

        def _stitch_and_write(self, job, stores, finish=False):
            t0 = perf_counter_ns()
            try:
                return super()._stitch_and_write(job, stores, finish)
            finally:
                rec.spans.append(("stitch", t0, perf_counter_ns()))

        def _visit(self, j):
            t0 = perf_counter_ns()
            try:
                super()._visit(j)
            finally:
                rec.spans.append(("visit", t0, perf_counter_ns()))

    return Bench


def driver_run(cls, kw, caps, out_dir, tag, rec: Record, keep: bool):
    """One driver run over `caps`; adds its counts to `rec` when `keep`.
    Returns the run's wall seconds."""
    from time import perf_counter, perf_counter_ns
    jobs = [(c.path, str(Path(out_dir) / f"{tag}_{k}.wav"))
            for k, c in enumerate(caps)]
    t0 = perf_counter()
    n0 = perf_counter_ns()
    dec = cls(jobs, **kw)
    rec.spans.append(("construct", n0, perf_counter_ns()))
    dec.run()
    t1 = perf_counter()
    if keep:
        for k, v in dec.stage_t.items():
            rec.stage_t[k] = rec.stage_t.get(k, 0.0) + v
        g = dec.graphs
        if g is not None:
            for k in rec.graphs:
                rec.graphs[k] += getattr(g, k)
        rec.frames += sum(c.frames for c in caps)
        rec.runs += 1
        rec.walls.append(t1 - t0)
        rec.wavs += [(c.index, o) for c, (_, o) in zip(caps, jobs)]
    return t1 - t0


def control_run(fmt, cfg, bits, caps, out_dir, tag, rec: Record):
    """The control in the program's place: the reference at `bits`, its
    valid samples written as a WAV and the others as 0."""
    import numpy as np
    t0 = time.perf_counter()
    for k, c in enumerate(caps):
        s, v, _ = fmt.reference(cfg, np.asarray(sg.read_y4m(c.path)), bits)
        path = str(Path(out_dir) / f"{tag}_{k}.wav")
        write_wav(path, np.where(v, s, 0), cfg["rates"][0])
        rec.wavs.append((c.index, path))
    rec.frames += sum(c.frames for c in caps)
    rec.runs += 1
    return time.perf_counter() - t0


def write_wav(path, samples, rate):
    import struct
    data = samples.astype("<i2").tobytes()
    with open(path, "wb") as fh:
        fh.write(struct.pack("<4sI4s4sIHHIIHH4sI", b"RIFF", 36 + len(data),
                             b"WAVE", b"fmt ", 16, 1, 2, rate, rate * 4, 4,
                             16, b"data", len(data)))
        fh.write(data)


# -- the check --------------------------------------------------------------------
def check(cell, fmt, caps, rec: Record):
    """Compare every WAV of the window with the reference's decode of its
    capture. Returns (attempted, failed, {number: (value, limit)}): the
    window's wrong words over the words compared (the reference's valid
    words and the masked words of its short dropouts), the same over the
    words of intact blocks, and the WAVs missing or unreadable. A capture
    fails where its WAV is missing or its own share of wrong words is over
    the limit."""
    import numpy as np
    cfg, limits = cell.config, cell.traffic["limits"]
    refs = {}
    tot = dict(wrong=0, valid=0, wrong_intact=0, intact=0, wrong_masked=0,
               masked=0)
    missing = failed = 0
    for idx, path in rec.wavs:
        if idx not in refs:
            refs[idx] = fmt.reference(cfg, np.asarray(
                sg.read_y4m(caps[idx].path)))
        got = sg.read_wav(path)
        if got is None or got[1] not in cfg["rates"]:
            missing += 1
            got = None
        v = compare.judge(None if got is None else got[0], *refs[idx],
                          caps[idx].true)
        for k in tot:
            tot[k] += v[k]
        wrong = v["wrong"] + v["wrong_masked"]
        failed += got is None \
            or wrong > limits["wrong_share"] * (v["valid"] + v["masked"])
    numbers = dict(
        wrong_share=((tot["wrong"] + tot["wrong_masked"])
                     / max(tot["valid"] + tot["masked"], 1),
                     limits["wrong_share"]),
        wrong_intact_share=(tot["wrong_intact"] / max(tot["intact"], 1),
                            limits["wrong_intact_share"]),
        missing_wavs=(missing, limits["missing_wavs"]))
    log(f"words compared: {tot}")
    return len(rec.wavs), failed, numbers


# -- the run ----------------------------------------------------------------------
def device_info(torch, device, chips):
    name = torch.cuda.get_device_name(device)
    return dict(platform="gpu", kind=name, count=chips,
                memory_peak_bytes=int(torch.cuda.max_memory_allocated(
                    device)))


def power_limit():
    import subprocess
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             t_process: float, tmp, control_bits=None):
    """Everything of one run after the chip check. Returns the result
    dict (without the import check). `device` is a torch device name;
    the benchmark's own runs pass a CUDA device, tests the CPU."""
    import torch
    on_cuda = torch.device(device).type == "cuda"
    cfg, traffic = cell.config, cell.traffic
    fmt = cells.format_module(cfg["format"])
    log(f"host speed before set-up: {host_speed_ms()} ms")
    rec = Record(cell=cell)
    cls, kw = driver(cfg, device)
    cls = instrumented(cls, rec)
    caps, warm = pool.make_pool(cfg, traffic, fmt, seed, device, tmp)
    per_run = traffic["captures_per_run"]
    draw = pool.runs(seed, len(caps), per_run)
    out_dir = Path(tmp) / "wav"
    out_dir.mkdir()

    def one(tag):
        run_caps = [caps[i] for i in next(draw)]
        if control_bits is not None:
            return control_run(fmt, cfg, control_bits, run_caps, out_dir,
                               tag, rec)
        return driver_run(cls, kw, run_caps, out_dir, tag, rec, keep=True)

    if control_bits is None:
        driver_run(cls, kw, [warm] * per_run, out_dir, "warm", rec,
                   keep=False)
    for p in out_dir.iterdir():
        p.unlink()
    rec.spans.clear()
    if on_cuda:
        torch.cuda.synchronize(device)
        # The device's peak over the window, not the pool's rendering.
        torch.cuda.reset_peak_memory_stats(device)
    t_win = time.perf_counter()
    rec.setup_s = time.time() - t_process
    cpu0, steal0 = os.times(), steal_s()
    tr = None
    n_trace = TRACE_RUNS if trace and on_cuda else 0
    if n_trace:
        launches0, rounds0 = k1_launches(), rounds(rec)
        tr = tracing.Trace(device)
        tr.start()
    while True:
        one(f"run{rec.runs}")
        if tr is not None and tr.t1 is None and rec.runs >= n_trace:
            t_stop = time.perf_counter()
            tr.stop()
            # Reading the profiler's rows takes seconds: not window time.
            t_win += time.perf_counter() - t_stop
            rec.trace = dict(
                k1_launches=k1_launches() - launches0,
                rounds=rounds(rec) - rounds0, runs=rec.runs,
                round_frames=round_frames(
                    [caps[i].frames for i, _ in rec.wavs],
                    kw["frames_per_round"]))
        if time.perf_counter() - t_win >= seconds:
            break
    rec.window_s = time.perf_counter() - t_win
    cpu1 = os.times()
    log(f"host speed after the window: {host_speed_ms()} ms")
    log(f"host over the window: user {cpu1.user - cpu0.user} s, system "
        f"{cpu1.system - cpu0.system} s, stolen {steal_s() - steal0} s "
        f"(all cores), wall {rec.window_s} s")
    result_device = None
    if on_cuda:
        torch.cuda.synchronize(device)
        result_device = device_info(torch, device, cell.chips)
    if tr is not None:
        reduce_trace(rec, tr)
        result_device.update(busy_s=rec.trace["busy_s"],
                             window_s=rec.trace["window_s"])
    del cls, kw
    gc.collect()
    if on_cuda:
        torch.cuda.empty_cache()
    attempted, failed, numbers = check(cell, fmt, caps, rec)
    metrics = {}
    for m in cell.metrics(trace):
        value = cells.metric_reader(m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = dict(value=value, unit=m["unit"])
    correct = failed == 0 and attempted > 0 and all(
        v <= lim for v, lim in numbers.values())
    out = dict(correct=correct, attempted=attempted, failed=failed,
               metrics=metrics, device=result_device)
    if rec.trace is not None and rec.trace.get("breakdown"):
        out["breakdown"] = rec.trace["breakdown"]
    log(f"captures compared: {attempted} in {rec.runs} driver runs, "
        f"{rec.frames} frames, window {rec.window_s} s")
    if rec.walls:
        w = sorted(rec.walls)
        log(f"driver run walls: min {w[0]} median {w[len(w) // 2]} "
            f"max {w[-1]} s")
    log("stage_t over the window: " + json.dumps(
        {k: round(v, 4) for k, v in sorted(rec.stage_t.items())}))
    out["checks"] = {k: dict(value=v, limit=lim)
                     for k, (v, lim) in numbers.items()}
    for k, (v, lim) in numbers.items():
        log(f"check {k} {v} limit {lim}")
    return out


def host_speed_ms() -> float:
    """Milliseconds a fixed piece of pure-Python and numpy work takes on
    this host now: logged before set-up and after the window, so a run's
    rate can be set beside the speed of the host it ran on."""
    import numpy as np
    t0 = time.perf_counter()
    x = 0
    for i in range(100_000):
        x += i & 7
    a = np.arange(1 << 20, dtype=np.int64)
    for _ in range(8):
        a = (a * 3 + 1) & 0xFFFF
    return 1e3 * (time.perf_counter() - t0)


def steal_s():
    """Seconds the hypervisor took from this machine's cores (/proc/stat),
    or 0 where it does not say."""
    try:
        with open("/proc/stat") as fh:
            cpu = fh.readline().split()
        return int(cpu[8]) / os.sysconf("SC_CLK_TCK")
    except (OSError, IndexError, ValueError):
        return 0.0


def k1_launches():
    from sdvpcmdecoder_tpu_torch.ops import fused_binarize as fb
    return fb.stc007_fused_decode_frames.launches


def rounds(rec):
    return rec.graphs["eager_rounds"] + rec.graphs["replays"]


def round_frames(lengths, per_round):
    """Frames of each round the drivers run over captures of `lengths`
    (full rounds, then the capture's short tail; the staging chunk is a
    multiple of a round, so no round straddles one)."""
    out = []
    for n in lengths:
        out += [per_round] * (n // per_round) + ([n % per_round]
                                                 if n % per_round else [])
    return out


def reduce_trace(rec: Record, tr):
    """Reduce the traced window; keeps the device numbers only where the
    trace holds every K1 launch the program counted."""
    t = rec.trace
    t.update(tracing.reduce(tr.rows(), tr.t0, tr.t1, rec.spans))
    t["lost"] = t["k1_rows"] != t["k1_launches"]
    if t["lost"]:
        log(f"trace lost: {t['k1_rows']} K1 rows in the trace against "
            f"{t['k1_launches']} launches counted; device metrics left out")
    if not t["aligned"]:
        log("trace: no synchronize row to tie the clocks; idle gaps "
            "unlabelled")
    t["breakdown"] = dict(device_ops=t["ops"], idle_gaps=t["gaps"])
    log(f"trace: window {t['window_s']} s, busy {t['busy_s']} s, K1 rows "
        f"{t['k1_rows']}, K1 launches {t['k1_launches']}, rounds "
        f"{t['rounds']} in {t['runs']} driver runs")


def main(argv, t_process):
    import argparse
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control-bits", type=int, default=None,
                    help="run the reference at this many bits in the "
                         "program's place (the control; not a benchmark run)")
    args = ap.parse_args(argv)
    cell = cells.Cell(cells.benchmark(), args.workload)
    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        log(f"error: {cell.chips} CUDA device(s) needed, "
            f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
            f"device_count {torch.cuda.device_count()}")
        return 2
    log(f"card: {power_limit()}")
    tmp = tempfile.mkdtemp(prefix="bench_port_")
    try:
        out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                       "cuda:0", t_process, tmp, args.control_bits)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    found = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if found:
        log(f"error: the process loaded {found}")
        return 3
    log(f"card: {power_limit()}")
    for k, v in out["checks"].items():
        log(f"check {k} {v['value']} limit {v['limit']}")
    print(json.dumps(out))
    return 0


def process_start() -> float:
    """This process's start on the time.time() clock (from /proc), or now
    where /proc says nothing."""
    try:
        ticks = os.sysconf("SC_CLK_TCK")
        with open("/proc/self/stat") as fh:
            start = int(fh.read().rsplit(")", 1)[1].split()[19]) / ticks
        with open("/proc/stat") as fh:
            boot = next(int(ln.split()[1]) for ln in fh
                        if ln.startswith("btime"))
        return boot + start
    except (OSError, ValueError, StopIteration):
        return time.time()
