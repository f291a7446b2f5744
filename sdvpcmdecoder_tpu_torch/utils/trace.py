"""The port's tracer: the seconds of each named span, summed by the program.

One `Tracer` per decoder (pipeline/batch_driver.BatchDecoder.trace, whose
`_stage` goes through `span`); the CLI keeps one per decode.

Each span adds its seconds to `stage_t[name]`, a `defaultdict(float)` that
callers may read and write. The spans of a decoder run on its stitch-pool
threads as well as its own, so one lock guards every update: no update is
lost. A span costs two `time.perf_counter_ns` reads and a locked dict add,
and keeps no record.
"""
from __future__ import annotations

import contextlib
import threading
from collections import defaultdict
from time import perf_counter_ns


class Tracer:
    def __init__(self):
        self.stage_t = defaultdict(float)
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def span(self, name):
        """Time the block into stage_t[name]."""
        t0 = perf_counter_ns()
        try:
            yield
        finally:
            dt = (perf_counter_ns() - t0) / 1e9
            with self._lock:
                self.stage_t[name] += dt
