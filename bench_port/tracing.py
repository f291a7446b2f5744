"""The device trace of a traced run and its reduction: the device's busy
time (the union of its kernel and copy rows), K1's rows and time, the
operations that took most time and the idle gaps labelled by the
program's `_stage` span that was open on the host.

The profiler records CUDA activity only. Its clock is tied to the host's
by the runtime row of a `torch.cuda.synchronize()` made at a known
`time.perf_counter_ns()` when the traced window opens."""
from __future__ import annotations

import time
from collections import defaultdict

from . import stats

K1_KERNEL = "stc007_binarize_frames"
SYNC_ROW = "cudaDeviceSynchronize"


class Trace:
    """torch.profiler over a window of the run (CUDA activity)."""

    def __init__(self, device):
        import torch
        from torch.profiler import ProfilerActivity, profile
        self.torch = torch
        self.device = device
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.t0 = self.t1 = None

    def start(self):
        self.prof.start()
        self.t0 = time.perf_counter_ns()
        self.torch.cuda.synchronize(self.device)

    def stop(self):
        self.torch.cuda.synchronize(self.device)
        self.t1 = time.perf_counter_ns()
        self.prof.stop()

    def rows(self):
        """[(name, kind, start_ns, end_ns)]: kind "kernel" or "copy" for
        device rows, "runtime" for the host's CUDA runtime calls."""
        from torch.autograd import DeviceType
        out = []
        for ev in self.prof.profiler.kineto_results.events():
            name = ev.name()
            if hasattr(ev, "start_ns"):
                a, d = ev.start_ns(), ev.duration_ns()
            else:
                a, d = ev.start_us() * 1000, ev.duration_us() * 1000
            if ev.device_type() == DeviceType.CUDA:
                kind = "copy" if ("Memcpy" in name or "Memset" in name) \
                    else "kernel"
            else:
                kind = "runtime"
            out.append((name, kind, a, a + d))
        return out


def host_offset(rows, t0_host: int):
    """Profiler time minus host perf_counter_ns, from the first
    synchronize row at or after the window's start; None if missing."""
    marks = [a for name, kind, a, _ in rows
             if kind == "runtime" and name == SYNC_ROW]
    if not marks:
        return None
    return min(marks) - t0_host


def reduce(rows, t0_host: int, t1_host: int, spans=()):
    """The traced window's numbers.

    rows: [(name, kind, start_ns, end_ns)] in the profiler's clock;
    t0_host, t1_host: the window in perf_counter_ns; spans: [(name,
    start_ns, end_ns)] host spans in perf_counter_ns. Returns dict(
    window_s, busy_s, k1_rows, k1_s, ops [(name, s)], gaps [(label, s)],
    aligned)."""
    off = host_offset(rows, t0_host)
    aligned = off is not None
    if not aligned:
        dev = [a for _, k, a, _ in rows if k != "runtime"]
        off = (min(dev) if dev else 0) - t0_host
    lo, hi = t0_host + off, t1_host + off
    dev = [(a, b) for _, k, a, b in rows if k != "runtime"]
    busy = stats.union_seconds(dev, lo, hi)
    k1 = [(a, b) for n, k, a, b in rows if k == "kernel" and K1_KERNEL in n]
    by_name = defaultdict(float)
    for n, k, a, b in rows:
        if k != "runtime":
            by_name[n] += max(0, min(b, hi) - max(a, lo))
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    idle = defaultdict(float)
    holes = stats.gaps(dev, lo, hi)
    names = labels_at([(n, a + off, b + off) for n, a, b in spans],
                      [a for a, _ in holes])
    for (a, b), name in zip(holes, names):
        idle[name if aligned else "unaligned"] += b - a
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return dict(window_s=(hi - lo) / 1e9, busy_s=busy / 1e9,
                k1_rows=len(k1), k1_s=sum(b - a for a, b in k1) / 1e9,
                ops=[[n, s / 1e9] for n, s in ops],
                gaps=[[n, s / 1e9] for n, s in gaps], aligned=aligned)


def labels_at(spans, times):
    """For each time (ascending), the innermost of the nested spans [(name,
    start, end)] open at it, or "harness" outside every span."""
    order = sorted(spans, key=lambda s: (s[1], -s[2]))
    out, stack, k = [], [], 0
    for t in times:
        while k < len(order) and order[k][1] <= t:
            while stack and stack[-1][2] <= order[k][1]:
                stack.pop()
            stack.append(order[k])
            k += 1
        while stack and stack[-1][2] <= t:
            stack.pop()
        out.append(stack[-1][0] if stack else "harness")
    return out
