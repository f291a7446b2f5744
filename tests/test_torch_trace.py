"""The port's tracer (utils/trace.Tracer) on the CPU: nested spans and their
sums, sums on perf_counter_ns, nothing kept beyond them, no update lost
across threads, where the chip-resident drivers put their staging,
constructor and wait spans, the streaming rounds' folded timers, the
benchmark's instrumented subclass over the traced decoder, and the CLI's
timings line.
"""
import contextlib
import gc
import os
import sys
import threading
import weakref
from collections import Counter

import pytest
import torch

import chip_smoke
from bench_port import harness
from sdvpcmdecoder_tpu_torch import __main__ as tcli
from sdvpcmdecoder_tpu_torch.pipeline import batch_driver as tbd
from sdvpcmdecoder_tpu_torch.pipeline import device_driver as tdd
from sdvpcmdecoder_tpu_torch.pipeline import device_pcm as tdp
from sdvpcmdecoder_tpu_torch.utils import trace
from sdvpcmdecoder_tpu_torch.utils.trace import Tracer

torch.set_num_threads(1)

STC_KW = dict(lines_per_field=294, hyst_limit=2, shift_limit=1,
              frames_per_round=5, hbm_frames=10, device="cpu")
HOOKED = {"stage_hbm", "dispatch", "prescan", "materialize", "finalize",
          "assemble", "stitch", "audio", "wav", "visit", "construct"}
PARTS = {"stage_read", "stage_split", "stage_upload", "open", "setup",
         "wait"}


def fake_clock(monkeypatch, step=1000):
    """perf_counter_ns advancing `step` ns at each read, per thread."""
    tls = threading.local()

    def clock():
        tls.t = getattr(tls, "t", 0) + step
        return tls.t
    monkeypatch.setattr(trace, "perf_counter_ns", clock)


class Nesting(Tracer):
    """The tracer, keeping besides each span's name and the name of the
    span open around it on the same thread: the tests' view of where the
    program puts its spans."""

    def __init__(self):
        super().__init__()
        self.pairs = []
        self._tls = threading.local()

    @contextlib.contextmanager
    def span(self, name):
        stack = self._tls.__dict__.setdefault("stack", [])
        with self._lock:
            self.pairs.append((name, stack[-1] if stack else None))
        stack.append(name)
        try:
            with super().span(name):
                yield
        finally:
            stack.pop()

    def parents(self, name):
        return Counter(p for n, p in self.pairs if n == name)


@pytest.fixture
def nesting(monkeypatch):
    for mod in (tbd, tdd):
        monkeypatch.setattr(mod, "Tracer", Nesting)


def test_nested_spans_sum_into_stage_t(monkeypatch):
    fake_clock(monkeypatch)
    tr = Tracer()
    with tr.span("a"):            # reads 1000 .. 8000
        with tr.span("b"):        # 2000 .. 5000
            with tr.span("c"):    # 3000 .. 4000
                pass
        with tr.span("b"):        # 6000 .. 7000
            pass
    assert tr.stage_t == pytest.approx({"a": 7e-6, "b": 4e-6, "c": 1e-6},
                                       abs=1e-15)


def test_span_seconds_lie_within_clock_reads_around_it():
    from time import perf_counter_ns
    tr = Tracer()
    before = perf_counter_ns()
    with tr.span("x"):
        pass
    after = perf_counter_ns()
    assert 0 < tr.stage_t["x"] <= (after - before) / 1e9
    tr.stage_t["x"] += 1.0      # callers may write it, as chip_smoke does
    with tr.span("x"):
        pass
    assert tr.stage_t["x"] > 1.0


def test_a_span_keeps_nothing_but_its_sum(monkeypatch, tmp_path):
    """A decoder's spans make no CUDA event, and its tracer holds its sums
    and its lock alone: no record, no stack."""
    def no_event(*a, **k):
        raise AssertionError("a CUDA event made by a span")
    monkeypatch.setattr(torch.cuda, "Event", no_event)
    cap = chip_smoke.write_capture(str(tmp_path / "c.y4m"), 6, 294, seed=5)
    dec = tdd.DeviceBatchDecoder([(cap, str(tmp_path / "o.wav"))], **STC_KW)
    dec.run()
    assert set(vars(dec.trace)) == {"stage_t", "_lock"}
    assert dec.stage_t is dec.trace.stage_t
    assert HOOKED - {"visit", "finalize"} | PARTS <= set(dec.stage_t)
    assert all(v > 0 for v in dec.stage_t.values())


@pytest.mark.parametrize("names", ["shared", "own_and_shared"])
def test_threads_lose_no_update(names, monkeypatch):
    """8 threads x 10,000 spans, each 1 us long: the sums are exact."""
    fake_clock(monkeypatch)
    tr = Tracer()
    n_threads, n_spans = 8, 10_000
    start = threading.Barrier(n_threads)

    def work(i):
        start.wait()
        for k in range(n_spans):
            name = "x" if names == "shared" or k % 2 else f"t{i}"
            with tr.span(name):
                pass

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)

    def total(n):
        s = 0.0
        for _ in range(n):
            s += 1000 / 1e9
        return s
    if names == "shared":
        assert dict(tr.stage_t) == {"x": total(n_threads * n_spans)}
    else:
        assert tr.stage_t["x"] == total(n_threads * n_spans // 2)
        for i in range(n_threads):
            assert tr.stage_t[f"t{i}"] == total(n_spans // 2)


@pytest.fixture(scope="module")
def nested_run(tmp_path_factory):
    """One DeviceBatchDecoder run on the CPU under the Nesting tracer: two
    captures of 20 frames, the second noisy (its failed lines take the
    finalize fallback and materialize lazy stores), 5 frames a round,
    chunks of 10."""
    tmp = tmp_path_factory.mktemp("nested")
    caps = [chip_smoke.write_capture(str(tmp / f"c{i}.y4m"), 20, 294,
                                     seed=3 + i, noise=24.0 * i)
            for i in range(2)]
    jobs = [(c, str(tmp / f"o{k}.wav")) for k, c in enumerate(caps)]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tdd, "Tracer", Nesting)
        dec = tdd.DeviceBatchDecoder(jobs, **STC_KW)
        dec.run()
    return dec


def test_staging_parts_inside_stage_hbm(nested_run):
    dec = nested_run
    tr = dec.trace
    # Two chunks a capture, then EOF: only the read runs at EOF.
    assert tr.parents("stage_hbm") == {"construct": 2, None: 4}
    assert tr.parents("stage_read") == {"stage_hbm": 6}
    assert tr.parents("stage_split") == {"stage_hbm": 4}
    assert tr.parents("stage_upload") == {"stage_hbm": 4}
    t = dec.stage_t
    assert t["stage_read"] + t["stage_split"] + t["stage_upload"] \
        <= t["stage_hbm"]


@pytest.fixture(scope="module")
def nested_pcm_run(tmp_path_factory):
    """One DevicePCMBatchDecoder run on the CPU under the Nesting tracer:
    two PCM-16x0 captures of 3 frames, 2 frames a round."""
    tmp = tmp_path_factory.mktemp("nested_pcm")
    caps = [chip_smoke.write_pcm16x0_capture(str(tmp / f"p{i}.y4m"),
                                             n_frames=3, seed=3 + i)
            for i in range(2)]
    jobs = [(c, str(tmp / f"p{k}.wav")) for k, c in enumerate(caps)]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tdd, "Tracer", Nesting)
        dec = tdp.DevicePCMBatchDecoder(jobs, fmt="pcm16x0",
                                        frames_per_round=2, device="cpu")
        dec.run()
    return dec


@pytest.mark.parametrize("run", ["nested_run", "nested_pcm_run"])
def test_construct_and_its_parts(run, request):
    dec = request.getfixturevalue(run)
    tr = dec.trace
    assert tr.parents("construct") == {None: 1}
    kids = Counter(n for n, p in tr.pairs if p == "construct")
    assert kids == {"open": 1, "setup": 3, "stage_hbm": 2, "wait": 1}
    t = dec.stage_t
    assert t["open"] + t["setup"] <= t["construct"]


def test_waits_at_the_listed_sites(nested_run):
    # _complete's round buffer and prefetched sample, the prescan, the
    # prefetched words, the finalize fallback, the lazy stores (fetched
    # by the stitcher) and _await_staging.
    assert set(nested_run.trace.parents("wait")) == {
        "materialize", "prescan", "assemble", "finalize", "stitch",
        "construct"}


def test_pcm_decoder_construct_and_waits(nesting, tmp_path):
    cap = chip_smoke.write_pcm16x0_capture(str(tmp_path / "p.y4m"),
                                           n_frames=3)
    dec = tdp.DevicePCMBatchDecoder([(cap, str(tmp_path / "p.wav"))],
                                    fmt="pcm16x0", frames_per_round=2,
                                    device="cpu")
    dec.run()
    tr = dec.trace
    assert {n for n, p in tr.pairs if p == "construct"} == {
        "open", "setup", "stage_hbm", "wait"}
    assert set(tr.parents("wait")) >= {"construct", "materialize",
                                       "prescan"}
    assert set(tr.parents("stage_upload")) == {"stage_hbm"}


def test_streaming_rounds_time_dispatch_and_stitch(nesting, tmp_path):
    """BatchDecoder's own round loop: the round dispatch and the stitch
    proper are spans of its tracer, the stitch inside no other span."""
    caps = [chip_smoke.write_capture(str(tmp_path / f"c{i}.y4m"), 4, 294,
                                     seed=12 + i) for i in range(2)]
    dec = tbd.BatchDecoder([(c, str(tmp_path / f"o{k}.wav"))
                            for k, c in enumerate(caps)],
                           lines_per_field=294, hyst_limit=2,
                           shift_limit=1, frames_per_round=2,
                           backend="tpu", device="cpu")
    stats = dec.run()
    tr = dec.trace
    assert tr.parents("dispatch")[None] > 0
    assert set(tr.parents("stitch")) == {None}
    assert dec.stage_t["stitch"] > 0 and dec.stage_t["dispatch"] > 0
    assert all(s.di_time_frames > 0 for s in stats.values())


def test_harness_instrumented_subclass_records_the_hooked_spans(tmp_path):
    """bench_port/harness.instrumented over the traced decoder: it records
    the hooked stages under their names and nothing else; the finer spans
    are in stage_t alone."""
    rec = harness.Record()
    cls = harness.instrumented(tdd.DeviceBatchDecoder, rec)
    caps = [chip_smoke.write_capture(str(tmp_path / f"c{i}.y4m"), 8, 294,
                                     seed=9 + i) for i in range(2)]
    dec = cls([(c, str(tmp_path / f"o{k}.wav")) for k, c in enumerate(caps)],
              **STC_KW)
    dec.run()
    names = Counter(n for n, _, _ in rec.spans)
    assert HOOKED - {"construct", "finalize"} <= set(names) <= HOOKED
    assert names["visit"] >= 2 * (8 // 5 + 1)
    assert all(a <= b for _, a, b in rec.spans)
    assert PARTS | {"construct"} <= set(dec.stage_t)


def test_cli_timings_line_keeps_its_keys(tmp_path, capsys):
    assert tcli._timings(Tracer()) == \
        "timings: read 0.00s, decode 0.00s, stitch 0.00s, audio 0.00s"
    cap = chip_smoke.write_capture(str(tmp_path / "c.y4m"), 4, 294, seed=4)
    assert tcli.main([cap, "-o", str(tmp_path / "o.wav"), "--device", "cpu",
                      "--backend", "native", "--quality", "fast"]) == 0
    pcm = chip_smoke.write_pcm16x0_capture(str(tmp_path / "p.y4m"),
                                           n_frames=2)
    assert tcli.main([pcm, "-o", str(tmp_path / "p.wav"), "--device", "cpu",
                      "--format", "pcm16x0", "--backend", "native",
                      "--quality", "fast"]) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("timings: ")]
    assert len(lines) == 2
    for ln in lines:
        keys = [kv.split()[0] for kv in ln[len("timings: "):].split(", ")]
        assert keys == ["read", "decode", "stitch", "audio"]
    assert os.path.getsize(tmp_path / "o.wav") > 44


@pytest.mark.parametrize("noise", [0.0, 24.0], ids=["clean", "noisy"])
def test_a_decoder_goes_with_its_last_reference(noise, nesting, tmp_path):
    """Nothing the tracer or the lazy stores (noisy lines, whose words the
    stitch fetches) hold keeps a run decoder, and its staged pixels on the
    device, alive until the cyclic collector runs."""
    cap = chip_smoke.write_capture(str(tmp_path / "c.y4m"), 12, 294, seed=6,
                                   noise=noise)
    gc.collect()
    gc.disable()
    try:
        dec = tdd.DeviceBatchDecoder([(cap, str(tmp_path / "o.wav"))],
                                     **STC_KW)
        dec.run()
        assert ("stitch" in dec.trace.parents("wait")) == (noise > 0)
        ref = weakref.ref(dec)
        del dec
        assert ref() is None
    finally:
        gc.enable()
