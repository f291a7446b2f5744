"""Metric arithmetic over one run's window, frozen for the benchmark."""
from __future__ import annotations

def rate(count: float, seconds: float) -> float:
    """Work over the whole window's wall."""
    return count / seconds


def union_seconds(intervals, lo: float, hi: float) -> float:
    """Length of the union of [start, end) intervals clipped to [lo, hi)."""
    total, cur_a, cur_b = 0.0, None, None
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in intervals):
        if b <= a:
            continue
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                total += cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    if cur_b is not None:
        total += cur_b - cur_a
    return total


def gaps(intervals, lo: float, hi: float):
    """The idle gaps [(start, end)] of [lo, hi) between the intervals."""
    out, t = [], lo
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in intervals):
        if b <= a:
            continue
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if t < hi:
        out.append((t, hi))
    return out
