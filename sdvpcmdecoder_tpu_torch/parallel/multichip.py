"""Batch parallelism across GPUs: the FULL pipeline, sharded by capture.

Port of sdvpcmdecoder_tpu/parallel/multichip.py.  SURVEY.md §2 "batch
parallelism across chips": multiple captures are sharded over the
devices and each shard runs the real batch decoder — ingest, prescan,
trial-grid binarize (device: K1 on a CUDA device), stitch stage machine
(host, embarrassingly parallel per capture), P/Q ECC, audio masking,
WAV — on its own device.  Host stitching needs no cross-capture state,
so the only reduction is the end-of-run stats sum (the analog of the
reference's GUI stat counters, mainwindow.h:434-467), taken on the host
where the JAX package takes a psum over its mesh, and ordered WAV
collection.

The decode math is deterministic, so sharded output is byte-identical
to a single-device run.  Shards are threads; several may share one card
(devices=[cuda:0, cuda:0]), each launching on its own device context.
Each shard's thread has its own graph holders (round_graph.thread_graphs,
the chip-resident drivers' round graphs), so two shards on one card never
replay or capture into each other's graphs; `graphs` in **kw reaches them.
"""
from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch


class ShardedBatchDecoder:
    """Run the production BatchDecoder with captures sharded over GPUs.

    jobs: [(in_path, out_path), ...]; devices: defaults to every CUDA
    device, and with none it raises (CPU devices run only when passed).
    Capture k runs on device k % n_devices; each shard is a real
    BatchDecoder on the device ("tpu") backend with device=its device,
    in a thread of its own, so shards run concurrently.
    """

    def __init__(self, jobs, devices=None, fmt="stc007",
                 device_resident=False, **kw):
        if devices is None:
            n = torch.cuda.device_count()
            if n == 0:
                raise RuntimeError(
                    "ShardedBatchDecoder: no CUDA device "
                    "(torch.cuda.device_count() is 0); pass devices "
                    "explicitly to run elsewhere")
            devices = [torch.device("cuda", i) for i in range(n)]
        self.devices = [torch.device(d) for d in devices]
        self.jobs = list(jobs)
        self.fmt = fmt
        # device_resident=True shards the CHIP-RESIDENT drivers
        # (pipeline/device_driver / device_pcm: device-staged pixels, one
        # fused round per dispatch) instead of the streaming backend.
        self.device_resident = device_resident
        self.kw = dict(kw)
        if not device_resident:
            self.kw.setdefault("backend", "tpu")
        self.stats = None
        self.shard_stats = None

    def _make_decoder(self, shard_jobs, dev):
        from ..pipeline import batch_driver, device_driver
        if not self.device_resident:
            return batch_driver.BatchDecoder(shard_jobs, fmt=self.fmt,
                                             device=dev, **self.kw)
        return device_driver.chip_resident_decoder(shard_jobs, self.fmt,
                                                   device=dev, **self.kw)

    def _run_shard(self, dev, shard_jobs, out, idx):
        try:
            ctx = torch.cuda.device(dev) if dev.type == "cuda" \
                else contextlib.nullcontext()
            with ctx:
                dec = self._make_decoder(shard_jobs, dev)
                res = dec.run()
            frames = sum(j.stats.frames_total for j in dec.jobs)
            samples = sum(j.stats.samples_out for j in dec.jobs)
            masked = sum(j.stats.samples_masked for j in dec.jobs)
            out[idx] = (res, np.array([frames, samples, masked],
                                      np.int64))
        except BaseException as e:   # noqa: BLE001 — re-raised in run()
            out[idx] = e

    def run(self):
        n = max(1, min(len(self.devices), len(self.jobs)))
        shards = [[] for _ in range(n)]
        for k, job in enumerate(self.jobs):
            shards[k % n].append(job)
        out = [None] * n
        threads = [threading.Thread(
            target=self._run_shard,
            args=(self.devices[i], shards[i], out, i))
            for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for i, o in enumerate(out):
            if isinstance(o, BaseException):
                raise RuntimeError(
                    f"shard {i} ({shards[i]}) failed: {o!r}") from o
            if o is None:
                raise RuntimeError(f"shard {i} produced no result")
        self.shard_stats = np.stack([o[1] for o in out])
        self.stats = self._reduce_stats(self.shard_stats)
        merged = {}
        for o in out:
            merged.update(o[0])
        return merged

    @staticmethod
    def _reduce_stats(per_shard):
        """The sum of the per-shard counters (the JAX package's psum over
        its mesh), taken on the host."""
        return per_shard.sum(axis=0)
