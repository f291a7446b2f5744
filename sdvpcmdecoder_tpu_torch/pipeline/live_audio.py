"""Live audio output — the SamplesToAudio analog (samples2audio.{h,cpp}).

The reference buffers decoded sample pairs in an 8192-pair circular
array and a timer dumps them into QAudioOutput (samples2audio.h:42
TA_AD_BUF_SIZE, the timDumpAudio pump).  This batch decoder is headless,
so the design splits the same mechanism into:

  * `SamplesToAudio` — ring buffer + wall-clock-paced pump with
    underrun silence fill (keeps a live sink in sync when the decoder
    momentarily starves, the QAudio idle-state analog);
  * pluggable sinks: `ALSASink` (ctypes libasound, gated on the library
    being present), `FDSink` (raw s16le to any file object/FIFO — pipe
    it to `aplay -f cd` or similar), `CaptureSink` (tests).

The pump is drivable two ways: `start()` spawns the timer thread
(20 ms period like a GUI pump), or call `pump_once(now)` directly with
an injected clock for deterministic use/tests.
"""
from __future__ import annotations

import threading
import time

import numpy as np

BUF_PAIRS = 8192        # TA_AD_BUF_SIZE (samples2audio.h:42)
PUMP_PERIOD_S = 0.02


class FDSink:
    """Raw interleaved s16le stereo to a file object or path (FIFO,
    stdout, a file for later `aplay`/`ffplay`)."""

    def __init__(self, fileobj_or_path):
        self._own = isinstance(fileobj_or_path, (str, bytes))
        self._fh = open(fileobj_or_path, "wb") if self._own \
            else fileobj_or_path

    def open(self, rate, channels=2):
        self.rate = rate

    def write(self, data: bytes) -> int:
        self._fh.write(data)
        return len(data)

    def close(self):
        try:
            self._fh.flush()
        except Exception:
            pass
        if self._own:
            self._fh.close()


class CaptureSink:
    """Test sink: records written bytes and open/close calls."""

    def __init__(self, accept=None):
        self.chunks = []
        self.opened = None
        self.closed = False
        self.accept = accept    # optional per-call byte cap

    def open(self, rate, channels=2):
        self.opened = (rate, channels)

    def write(self, data: bytes) -> int:
        n = len(data) if self.accept is None \
            else min(len(data), self.accept)
        self.chunks.append(bytes(data[:n]))
        return n

    def close(self):
        self.closed = True

    def data(self):
        return b"".join(self.chunks)


class ALSASink:
    """libasound PCM playback via ctypes; raises OSError when ALSA is
    not available on the host (the decoder then falls back to FDSink
    or file output)."""

    def __init__(self, device="default"):
        import ctypes
        import ctypes.util
        name = ctypes.util.find_library("asound")
        if not name:
            raise OSError("libasound not found: no ALSA on this host")
        self._a = ctypes.CDLL(name)
        self._pcm = ctypes.c_void_p()
        self._device = device.encode()
        self._ct = ctypes

    def open(self, rate, channels=2):
        ct = self._ct
        a = self._a
        # SND_PCM_STREAM_PLAYBACK=0, blocking mode
        if a.snd_pcm_open(ct.byref(self._pcm), self._device, 0, 0) < 0:
            raise OSError(f"cannot open ALSA device {self._device!r}")
        # SND_PCM_FORMAT_S16_LE=2, SND_PCM_ACCESS_RW_INTERLEAVED=3
        err = a.snd_pcm_set_params(self._pcm, 2, 3, channels, rate, 1,
                                   500000)
        if err < 0:
            raise OSError("snd_pcm_set_params failed")
        self._channels = channels

    def write(self, data: bytes) -> int:
        frames = len(data) // (2 * self._channels)
        got = self._a.snd_pcm_writei(self._pcm, data, frames)
        if got < 0:
            self._a.snd_pcm_recover(self._pcm, got, 1)
            return 0
        return int(got) * 2 * self._channels

    def close(self):
        if self._pcm:
            self._a.snd_pcm_drain(self._pcm)
            self._a.snd_pcm_close(self._pcm)
            self._pcm = self._ct.c_void_p()


class SamplesToAudio:
    """Ring buffer + paced pump (saveAudio/purgeBuffer/stopOutput
    analog, samples2audio.cpp)."""

    def __init__(self, sink, rate=44100, clock=time.monotonic,
                 buf_pairs=BUF_PAIRS):
        self.sink = sink
        self.rate = int(rate)
        self.clock = clock
        self.buf = np.zeros((buf_pairs, 2), np.int16)
        self.head = 0           # next write slot
        self.count = 0          # pairs buffered
        self.written_pairs = 0  # pairs pushed to the sink
        self.underrun_pairs = 0
        self.overrun_pairs = 0  # oldest pairs overwritten (buffer full)
        self._t0 = None
        self._lock = threading.Lock()
        self._thread = None
        self._stop = threading.Event()

    # -- producer side (saveAudio) ----------------------------------------
    def set_sample_rate(self, rate):
        """setSampleRate: takes effect on the next prepare/open."""
        self.rate = int(rate)

    def save_audio(self, samples):
        """Queue [N, 2] int16 pairs; a full ring drops the OLDEST pairs
        (live output must track the present, circbuffer semantics)."""
        samples = np.asarray(samples, np.int16).reshape(-1, 2)
        n = len(samples)
        cap = len(self.buf)
        with self._lock:
            if n >= cap:
                self.overrun_pairs += self.count + n - cap
                self.buf[:] = samples[-cap:].reshape(cap, 2)
                self.head = 0
                self.count = cap
                return
            if self.count + n > cap:
                k = self.count + n - cap
                self.overrun_pairs += k
                self.head = (self.head + k) % cap   # drop the oldest
                self.count -= k
            w = (self.head + self.count) % cap
            first = min(n, cap - w)
            self.buf[w:w + first] = samples[:first]
            if n > first:
                self.buf[:n - first] = samples[first:]
            self.count += n

    def purge_buffer(self):
        with self._lock:
            self.head = 0
            self.count = 0

    # -- pump side ---------------------------------------------------------
    def prepare(self):
        """prepareNewFile: (re)open the sink at the current rate and
        anchor the stream clock."""
        self.sink.open(self.rate, 2)
        self._t0 = self.clock()
        self.written_pairs = 0
        self.underrun_pairs = 0

    def pump_once(self, now=None):
        """Push due pairs to the sink; silence-fill underruns.

        Returns pairs written this call."""
        if now is None:
            now = self.clock()
        if self._t0 is None:
            self._t0 = now
        due = int((now - self._t0) * self.rate) - self.written_pairs \
            - self.underrun_pairs
        if due <= 0:
            return 0
        with self._lock:
            take = min(due, self.count)
            cap = len(self.buf)
            if take:
                idx = (self.head + np.arange(take)) % cap
                chunk = self.buf[idx]
                self.head = (self.head + take) % cap
                self.count -= take
            else:
                chunk = None
        wrote = 0
        if chunk is not None:
            data = chunk.astype("<i2").tobytes()
            acc = self.sink.write(data)
            wrote = acc // 4
            self.written_pairs += wrote
            if acc < len(data):   # sink backpressure: requeue the rest
                rest = np.frombuffer(data[acc:], "<i2").reshape(-1, 2)
                with self._lock:
                    # The producer may have filled the freed slots while
                    # the sink call ran; rewind only into genuinely free
                    # space and drop the (oldest) overflow as overrun —
                    # never overwrite unread samples.
                    rq = min(len(rest), cap - self.count)
                    if rq:
                        self.head = (self.head - rq) % cap
                        self.buf[(self.head + np.arange(rq)) % cap] = \
                            rest[-rq:]
                        self.count += rq
                    self.overrun_pairs += len(rest) - rq
                return wrote
        short = due - wrote
        if short > 0 and chunk is not None and wrote == len(chunk) \
                and self.count == 0:
            # Starved: keep the live clock honest with silence.
            self.sink.write(b"\x00" * (4 * short))
            self.underrun_pairs += short
        elif chunk is None:
            self.sink.write(b"\x00" * (4 * due))
            self.underrun_pairs += due
        return wrote

    # -- thread driver -----------------------------------------------------
    def start(self):
        self.prepare()
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while not self._stop.wait(PUMP_PERIOD_S):
            self.pump_once()

    def stop_output(self, drain=True):
        """stopOutput: flush what is buffered, then close the sink."""
        if self._thread is not None:
            self._stop.set()
            self._thread.join(timeout=2.0)
            self._thread = None
        if drain:
            with self._lock:
                take = self.count
                cap = len(self.buf)
                if take:
                    idx = (self.head + np.arange(take)) % cap
                    data = self.buf[idx].astype("<i2").tobytes()
                    self.head = 0
                    self.count = 0
                else:
                    data = b""
            while data:
                acc = self.sink.write(data)
                self.written_pairs += acc // 4
                if acc <= 0:
                    break
                data = data[acc:]
        self.sink.close()


def make_sink(spec):
    """CLI sink spec: 'alsa' / 'alsa:<device>' / '-' (stdout) / path."""
    if spec in ("alsa",) or spec.startswith("alsa:"):
        dev = spec.partition(":")[2] or "default"
        return ALSASink(dev)
    if spec == "-":
        import sys
        return FDSink(sys.stdout.buffer)
    return FDSink(spec)
