"""The port's tracer: the seconds of each named span, and counts, summed by
the program.

One `Tracer` per decoder (pipeline/batch_driver.BatchDecoder.trace, whose
`_stage` goes through `span`); the CLI keeps one per decode. The PCM
frame drivers and stitchers of a decoder add to the decoder's tracer.

Each span adds its seconds to `stage_t[name]`, a `defaultdict(float)` that
callers may read and write. Each `count` adds to `stage_t[name]` too: a
counter's name starts with `count_`, so a reader tells counts from seconds
by the name, and one dict carries both. The spans and counts of a decoder
run on its stitch-pool threads as well as its own, so one lock guards
every update: no update is lost. A span costs two `time.perf_counter_ns`
reads and a locked dict add, a count one locked add, and neither keeps a
record.
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

    def count(self, name, n=1):
        """Add `n` to stage_t[name], a counter (`count_...`)."""
        with self._lock:
            self.stage_t[name] += n
