"""Small cells for CPU runs of the harness."""
import copy
import time

from bench_port import cells, harness

SMALL = dict(pool=4, captures_per_run=2, warm_frames=4)


# Mixes and a configuration BENCHMARK.json does not run (Open questions in
# PERF.md), kept runnable: their cells are added here as a later PR would
# add them.
EXTRA_CONFIGS = [dict(name="pcm16x0_si_normal", source="-",
                      file="bench_port/configs/pcm16x0_si_normal.json",
                      reduced=["tape_frames"], why="PCM-1610")]
EXTRA = [dict(name="stc007_pal_normal.dropouts8", config="stc007_pal_normal",
              traffic="dropouts8", chips=1, why="worn tapes"),
         dict(name="pcm16x0_si_normal.tapes8", config="pcm16x0_si_normal",
              traffic="tapes8_short", chips=1, why="PCM-1610")]


def bench_with_extras():
    bench = cells.benchmark()
    have = {c["name"] for c in bench["configs"]}
    bench["configs"] += [c for c in EXTRA_CONFIGS if c["name"] not in have]
    have = {w["name"] for w in bench["workloads"]}
    bench["workloads"] += [w for w in EXTRA if w["name"] not in have]
    return bench


def small_cell(name, frames=(4, 8)):
    cell = cells.Cell(bench_with_extras(), name)
    cell.traffic = copy.deepcopy(cell.traffic)
    cell.traffic.update(SMALL, frames=list(frames))
    return cell


def cpu_run(cell, tmp_path, seed=11, seconds=0.5, control_bits=None):
    """A run of `cell` on the CPU: everything but the look for a chip."""
    import torch
    torch.set_num_threads(2)   # test workers share the machine
    return harness.run_cell(cell, seed, seconds, False, "cpu", time.time(),
                            tmp_path, control_bits)
