"""Numpy in, numpy out: the port's torch functions on host arrays.

The JAX package's host code (the stitcher's no-native branches, the V2D
duplicate scan) calls its array functions with `xp=np`. The port has one
torch implementation of each, so those call sites go through `host_call`:
every numpy argument becomes a CPU tensor and every tensor result comes
back as a numpy array, through tuples and NamedTuples both ways.
"""
from __future__ import annotations

import numpy as np
import torch


def _map(x, leaf):
    if isinstance(x, tuple):
        items = [_map(v, leaf) for v in x]
        return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
    return leaf(x)


def _to_torch(x):
    if isinstance(x, np.ndarray):
        return torch.from_numpy(np.require(x, requirements=("C", "W")))
    return x


def host_call(fn, *args, out_dtype=None, **kw):
    """fn(*args, **kw) with numpy arrays passed as CPU tensors and tensor
    results returned as numpy; out_dtype casts every result (for the
    int64 CRCs the numpy branch of the JAX package returns)."""
    def to_numpy(x):
        if not isinstance(x, torch.Tensor):
            return x
        a = x.numpy()
        return a if out_dtype is None else a.astype(out_dtype, copy=False)
    return _map(fn(*(_map(a, _to_torch) for a in args), **kw), to_numpy)
