"""Numpy in, numpy out: the port's torch functions on host arrays.

The JAX package's host code (the stitcher's no-native branches, the V2D
duplicate scan) calls its array functions with `xp=np`. The port has one
torch implementation of each, so those call sites go through `host_call`:
every numpy argument becomes a CPU tensor and every tensor result comes
back as a numpy array, through tuples and NamedTuples both ways.
`HostCopy` is the other direction's helper on a GPU: a device tensor on
its way into pinned host memory; `upload` takes a host tensor to the
device through pinned memory, and `StagingBuffer` is host memory that
uploads again and again.
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


class HostCopy:
    """A device->host copy in flight (the JAX package's
    copy_to_host_async): on CUDA a non_blocking copy into pinned host
    memory and the event recorded after it; `numpy()` waits for that
    event only.  On the CPU a copy of the tensor, taken now: like the
    device's copy, it keeps the values the tensor has when the copy is
    asked for (a round graph's output buffer is written again by the
    next replay)."""

    def __init__(self, t: torch.Tensor):
        self._event = None
        if t.device.type == "cuda":
            self._host = torch.empty(t.shape, dtype=t.dtype,
                                     pin_memory=True)
            self._host.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(t.device))
        else:
            self._host = t.clone()

    def numpy(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()


def upload(t: torch.Tensor, device) -> torch.Tensor:
    """`t` on `device`: from the host to a CUDA device by a non_blocking
    copy from pinned memory, so the host does not wait for the device's
    queue as it does for a copy from pageable memory. The pinned block
    comes from torch's caching host allocator, which the copy tells not to
    hand it out again before the copy has run."""
    device = torch.device(device)
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _pinned_allocs():
    """Pinned blocks torch's caching host allocator has allocated so far
    in the process (not those it handed out again)."""
    return torch.cuda.host_memory_stats().get("num_host_alloc", 0)


class StagingBuffer:
    """`nbytes` of host memory that stages uploads to `device` again and
    again: pinned on CUDA, where `upload` is a non_blocking copy that does
    not wait for the device's queue, and plain memory on the CPU.

    The pinned block comes from torch's caching host allocator: a buffer
    dropped gives its block back, and the next buffer of the process in
    the block's size class takes it (not before the copies out of it have
    run). `new` says whether the allocator pinned a new block for this one
    (where other threads pin memory at the same time, theirs may count).

    `event` is recorded after the last upload out of the buffer (CUDA
    only): `wait` before the buffer is written again."""

    def __init__(self, nbytes, device):
        self.device = torch.device(device)
        self.pinned = self.device.type == "cuda"
        before = _pinned_allocs() if self.pinned else 0
        self._host = torch.empty(nbytes, dtype=torch.uint8,
                                 pin_memory=self.pinned)
        self.new = self.pinned and _pinned_allocs() > before
        self.event = None

    def wait(self):
        """Wait for the last upload out of the buffer to have run."""
        if self.event is not None:
            self.event.synchronize()
            self.event = None

    def array(self, shape) -> np.ndarray:
        """The buffer's first bytes as a writable uint8 array of `shape`."""
        return self._host[:int(np.prod(shape))].view(shape).numpy()

    def upload(self, shape) -> torch.Tensor:
        """The buffer's first bytes, as `array(shape)`, on the device
        (`upload`), the event recorded after the copy. On the CPU the
        result is the buffer's own memory: copy out of it before the
        buffer is written again."""
        t = upload(self._host[:int(np.prod(shape))].view(shape), self.device)
        if self.pinned:
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(self.device))
        return t
