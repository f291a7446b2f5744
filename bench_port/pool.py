"""The captures of a run: a pool made in set-up, the capture the warm-up
decodes, and the order in which the window's driver runs draw from the
pool.

The mix's range of lengths is cut into S = min(pool, captures_per_run)
strata (the quantiles of a log-uniform draw; a range of one length gives
S captures of that length); the pool holds pool / S captures of each
stratum's length, and every driver run takes captures_per_run / S
captures of each stratum, in a seeded order. So every seed and every run
gets the same set of lengths, and the seed changes which captures meet
in a run, their order, and their content: samples, noise and bursts.
Where a run takes a capture more than once, its jobs read the same file:
the program keeps no cache keyed on pixels, so that is the same work."""
from __future__ import annotations

import math
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from . import media as sg


@dataclass
class Capture:
    index: int
    path: str
    frames: int
    bursts: tuple
    true: np.ndarray    # the samples it was made from [N, 2] int16


def sizes(lo: int, hi: int, n: int) -> np.ndarray:
    """n capture lengths in [lo, hi]: the midpoints of n equal steps of
    log length, so their spread is a log-uniform draw's."""
    q = (np.arange(n) + 0.5) / n
    x = np.exp(math.log(lo) + q * (math.log(hi + 1) - math.log(lo)))
    return np.clip(np.floor(x), lo, hi).astype(np.int64)


def bursts_for(traffic, n_frames: int, lines: int, rng):
    """(frame, first line, count) of each dimmed burst: one frame in
    `burst_every` from a seeded phase, 4-32 lines (the mix's range) at a
    seeded place."""
    every = traffic.get("burst_every", 0)
    if not every:
        return ()
    lo, hi = traffic["burst_lines"]
    out = []
    for f in range(int(rng.integers(every)), n_frames, every):
        cnt = int(rng.integers(lo, hi + 1))
        out.append((f, int(rng.integers(0, lines - cnt + 1)), cnt))
    return tuple(out)


def strata(n_pool: int, per_run: int) -> int:
    s = min(n_pool, per_run)
    if n_pool % s or per_run % s:
        raise ValueError("pool and captures_per_run must be multiples of "
                         "the smaller of the two")
    return s


def capture(cfg, traffic, fmt, seed: int, tag: int, n_frames: int, gen,
            device, path) -> Capture:
    """Write one capture of the mix (content from `seed` and `tag`)."""
    rng = sg.rng_for(seed, 2, tag)
    bursts = bursts_for(traffic, n_frames, 2 * cfg["signal"]
                        ["lines_per_field"], rng)
    frames, truth = fmt.make_capture(
        cfg, n_frames, rng, gen, device,
        noise=traffic.get("noise_sigma", 0.0), bursts=bursts,
        burst_levels=tuple(traffic.get("burst_levels", (5, 60))))
    sg.write_y4m(path, frames)
    return Capture(tag, str(path), n_frames, bursts, fmt.truth(truth))


def make_pool(cfg, traffic, fmt, seed: int, device, tmp):
    """Write the run's pool of captures and the warm-up's capture
    (`warm_frames` long) into `tmp`; returns ([Capture], warm Capture),
    pool capture k of stratum k mod S."""
    n = traffic["pool"]
    s = strata(n, traffic["captures_per_run"])
    lens = np.tile(sizes(*traffic["frames"], s), n // s)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % 2 ** 63)
    pool = [capture(cfg, traffic, fmt, seed, k, int(nf), gen, device,
                    Path(tmp) / f"capture_{k:02d}.y4m")
            for k, nf in enumerate(lens)]
    warm = capture(cfg, traffic, fmt, seed, n, int(traffic["warm_frames"]),
                   gen, device, Path(tmp) / "warm.y4m")
    return pool, warm


def runs(seed: int, n_pool: int, per_run: int):
    """Endless driver runs, each a list of pool indices: per_run / S
    captures of every stratum, the stratum's captures in turn from a
    seeded start, the jobs in a seeded order."""
    rng = sg.rng_for(seed, 3)
    s = strata(n_pool, per_run)
    copies, reps = n_pool // s, per_run // s
    start = rng.integers(copies, size=s)
    r = 0
    while True:
        idx = [int(st + s * ((start[st] + r * reps + k) % copies))
               for st in range(s) for k in range(reps)]
        yield [idx[j] for j in rng.permutation(per_run)]
        r += 1
