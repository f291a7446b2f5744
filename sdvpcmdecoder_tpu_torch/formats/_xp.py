"""The few array calls whose numpy and torch spellings differ, for the
format modules whose functions take `xp=torch` (tensors on the caller's
device) or `xp=np` (host arrays), as the JAX package's take `xp=jnp` or
`xp=np`."""
from __future__ import annotations

import functools

import numpy as np
import torch


def int32(xp, a):
    return a.astype(np.int32) if xp is np else a.to(torch.int32)


def cat(xp, arrays):
    return np.concatenate(arrays, axis=-1) if xp is np \
        else torch.cat(arrays, dim=-1)


def stack(xp, arrays):
    return np.stack(arrays, axis=-1) if xp is np \
        else torch.stack(arrays, dim=-1)


def where(xp, cond, a, b):
    return np.where(cond, a, b) if xp is np else torch.where(cond, a, b)


def _weights(nb):
    return (1 << np.arange(nb - 1, -1, -1)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _weights_on(nb, device):
    # Uploaded once per device: an upload from pageable memory waits for
    # the device's queue.
    return torch.as_tensor(_weights(nb), device=device)


def bits_to_int(xp, bits):
    """The bits of the last axis as one number, most significant first:
    int64 under numpy (its sum promotes int32), int32 under torch (as jnp
    keeps it)."""
    nb = bits.shape[-1]
    if xp is np:
        return np.sum(bits.astype(np.int32) * _weights(nb), axis=-1)
    return (bits.to(torch.int32) * _weights_on(nb, bits.device)).sum(
        -1, dtype=torch.int32)
