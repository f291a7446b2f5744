"""Multi-GPU scale-out: captures x line-chunks over a 2D device grid.

Port of sdvpcmdecoder_tpu/parallel/mesh.py.  The reference's only
parallelism is a 6-thread pipeline (SURVEY.md section 2); the design
shards the *batch* instead:

  * "data" axis: independent captures / tapes (replaces running the app
    N times);
  * "seq" axis: line-chunks of one capture with a MIN_DEINT_DATA-line halo
    so the diagonal interleave crosses chunk boundaries intact — the
    context-parallel halo-exchange analog (SURVEY.md section 5);
  * the JAX package's collectives (psum of the valid-line count,
    all_gather of samples along "seq") become copies between the grid's
    devices: each chunk's samples go to every device of its "data" row.

The grid is a numpy object array [data, seq] of torch.devices; a sharded
array is a nested list [data][seq] of tensors, chunk [d][s] on grid[d, s].
A card may appear more than once (several chunks on one GPU).
"""
from __future__ import annotations

import numpy as np
import torch

from ..formats import stc007

HALO = stc007.MIN_DEINT_DATA  # 112 lines of interleave context


def _cuda_devices():
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("no CUDA device (torch.cuda.device_count() is "
                           "0); pass devices explicitly")
    return [torch.device("cuda", i) for i in range(n)]


def decode_mesh(n_devices=None, seq=None, devices=None):
    """Build a (data x seq) grid over `devices` (default: every CUDA
    device; none raises).  n_devices takes the first n of them, repeating
    the list when it is shorter (several grid cells on one card)."""
    devs = [torch.device(d) for d in devices] if devices is not None \
        else _cuda_devices()
    n = n_devices or len(devs)
    if seq is None:
        seq = 2 if n % 2 == 0 and n > 1 else 1
    data = n // seq
    cells = [devs[k % len(devs)] for k in range(data * seq)]
    grid = np.empty(data * seq, dtype=object)
    grid[:] = cells
    return grid.reshape(data, seq)


def chunk_lines_with_halo(lines: np.ndarray, n_chunks: int,
                          halo: int = HALO):
    """[L, ...] -> [n_chunks, chunk+halo, ...] with trailing overlap.

    Each chunk carries `halo` extra lines from the next chunk so every
    block whose taps straddle the boundary is complete.
    """
    L = lines.shape[0]
    chunk = (L - halo) // n_chunks
    out = np.stack([lines[k * chunk:k * chunk + chunk + halo]
                    for k in range(n_chunks)])
    return out, chunk


def shard_captures(arr: np.ndarray, mesh):
    """Place [captures, chunks, ...] onto the (data, seq) grid: chunk
    [d, s] on mesh[d, s]."""
    D, S = mesh.shape
    if tuple(arr.shape[:2]) != (D, S):
        raise ValueError(f"array leads with {tuple(arr.shape[:2])}, "
                         f"the grid is {(D, S)}")
    return [[torch.from_numpy(np.ascontiguousarray(arr[d, s])).to(
        mesh[d, s]) for s in range(S)] for d in range(D)]


def multichip_decode_step(mesh, hyst_limit=1, shift_limit=1, graphs=True):
    """Build the per-device decode step over the grid.

    The step takes sharded pixels [D][S] of [Lc, W] plus coords/levels
    (shard_captures of [D, S, Lc, ...]); each chunk decodes on its device
    (decoder.decode_stream: K1 on a CUDA device), the valid-line count is
    summed over the whole grid, and samples are gathered along "seq".
    The JAX package jits the whole step; here each chunk's decode_stream
    replays as a CUDA graph (graphs=True: the calling thread's holder per
    device, round_graph.thread_graphs, so chunks of one shape on one card
    share a graph) and the copies between devices stay eager.
    Returns (gathered, n_valid): gathered[d][s] is [S, 3*blocks_c, 2] on
    mesh[d, s], the samples of every chunk of capture d; n_valid[d][s] is
    the grid-wide count (int64, 0-d) on mesh[d, s].
    """
    from ..pipeline import decoder

    D, S = mesh.shape

    def step(px, cd, ref, blk, wht):
        samples = [[decoder.decode_stream(
            px[d][s], cd[d][s], ref[d][s], blk[d][s], wht[d][s],
            hyst_limit=hyst_limit, shift_limit=shift_limit, graphs=graphs)
            for s in range(S)] for d in range(D)]
        total = sum(r.line_valid.sum(dtype=torch.int64).cpu()
                    for row in samples for r in row)
        gathered = [[torch.stack([r.samples.to(mesh[d, s])
                                  for r in samples[d]])
                     for s in range(S)] for d in range(D)]
        n_valid = [[total.to(mesh[d, s]) for s in range(S)]
                   for d in range(D)]
        return gathered, n_valid

    return step
