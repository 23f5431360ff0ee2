"""GIL-pressure sampler: measure interpreter scheduling delay directly.

A daemon thread repeatedly requests a short sleep and measures the
*overshoot* — actual wake minus requested wake. On an idle interpreter
the overshoot is the OS timer slack (tens of microseconds); when N
runnable threads contend for the GIL the sleeper must wait for a
GIL handoff after its timer fires, so the overshoot distribution IS
the interpreter scheduling delay every other thread experiences:
GIL queuing of 64 eval threads around the batch boundary becomes a
histogram instead of an inference from a percentile gap.

The sampler owns its histogram (single writer — the sampler thread;
readers snapshot monotonic counters, benign mid-update reads). The
sample loop is the only place in the profiler allowed to sleep; it is
NOT on the record-path manifest.

Complementing the sampler, per-worker *run-queue delay* is stamped at
the two points where ready work waits for a thread to actually run
(profile/__init__.py record_runq): broker drain (work announced to the
dispatch accumulator -> dispatcher wakes) and batch park (device
results published -> parked worker resumes).
"""

from __future__ import annotations

import threading
import time

from .locks import _WaitHist

# 5ms: long enough that the sleep itself is cheap (200 wakes/s), short
# enough that a batch-boundary stall (tens of ms) lands many samples.
SAMPLE_INTERVAL_S = 0.005


class GilSampler:
    def __init__(self, interval: float = SAMPLE_INTERVAL_S):
        self.interval = interval
        self.hist = _WaitHist()  # overshoot ms; sampler thread only
        self.samples = 0  # sampler thread only (mirrors hist.count)
        self._stop = threading.Event()
        self._thread = None
        self._lock = threading.Lock()  # start/stop serialization

    def start(self) -> None:
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name="gil-sampler", daemon=True)
            self._thread.start()

    def stop(self) -> None:
        with self._lock:
            self._stop.set()
            t = self._thread
            self._thread = None
        if t is not None:
            t.join(timeout=2.0)

    def running(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    def _run(self) -> None:
        stop = self._stop
        while True:
            # Re-read per tick: configure(sampler_interval=...) on a
            # RUNNING sampler must take effect without a restart
            # (start() is a no-op while the thread is alive).
            interval = self.interval
            t0 = time.monotonic()
            if stop.wait(interval):
                return
            overshoot_ms = (time.monotonic() - t0 - interval) * 1000.0
            if overshoot_ms < 0.0:
                overshoot_ms = 0.0  # clock granularity can undershoot
            self.hist.observe(overshoot_ms)
            self.samples += 1

    def stats(self) -> dict:
        out = self.hist.stats()
        out["running"] = self.running()
        out["interval_ms"] = self.interval * 1000.0
        return out

    def reset(self) -> None:
        # Single-writer hist: swap wholesale (the sampler thread will
        # write into the new one from its next tick).
        self.hist = _WaitHist()
        self.samples = 0
