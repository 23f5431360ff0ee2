"""Pipeline timeline ring + convoy detector.

The timeline is a bounded, preallocated ring of batch-lifecycle events
(accumulate open/close, launch, submit, ack, prefetch, park/unpark per
worker). Events are immutable tuples built fully BEFORE publication
into a ring slot — a reader can never observe a torn event — and the
slot index advances under a small leaf lock (constant work only, the
sanctioned record-path synchronization).

The convoy detector answers the batch boundary's question: how wide and how long do eval threads pile up at the batch
boundary? A *convoy* is a maximal interval during which the number of
threads simultaneously parked at one site is >= CONVOY_MIN_WIDTH; the
tracker maintains the live width online (O(1) at park/unpark) and
keeps the last CONVOY_KEEP completed convoys (start, duration, peak
width) in a drop-oldest ring.

Event tuple layout: ``(t_mono, wall, kind, thread, a, b)`` where `a`
and `b` are small kind-specific scalars (batch size, eval count, site
name...). Kept positional so the concurrent-writer stress test can
checksum them.
"""

from __future__ import annotations

import threading
import time
from typing import List, Optional

RING_CAP = 4096
CONVOY_KEEP = 64
# A pile-up only counts as a convoy once this many threads are parked
# at the same site at once: below it, parks are the pipeline breathing
# (one dispatcher + a straggler), not the batch-boundary pathology.
CONVOY_MIN_WIDTH = 4

# Event kinds (the timeline's closed vocabulary; the chrome exporter
# and the README table read off this tuple).
EVENT_KINDS = (
    "accumulate_open",   # a = pending at open
    "accumulate_close",  # a = batch size, b = batch ordinal
    "launch",            # a = batch size, b = route_host
    "submit",            # a = 1 (plan submit completed)
    "ack",               # a = 1 acked / 0 nacked
    "prefetch",          # a = bytes shipped
    "park",              # a = width after park,   b = site
    "unpark",            # a = width after unpark, b = site
)

# Record-path manifest, kept as data (the JAX package's linter walks
# the same names there): timeline and
# convoy updates run under the dispatcher thread and inside hot-lock
# critical sections — constant work under a leaf lock only.
NTA_RECORD_PATH = ("Timeline.push", "ConvoyTracker.park",
                   "ConvoyTracker.unpark")


class Timeline:
    def __init__(self, cap: int = RING_CAP):
        self.cap = cap
        self._lock = threading.Lock()
        self._ring: List[Optional[tuple]] = [None] * cap
        self._idx = 0  # guarded-by: _lock (monotonic; slot = idx % cap)

    def push(self, kind: str, thread: str = "", a=0, b=0) -> None:
        # Tuple fully built before publication; the critical section is
        # two subscript ops and an increment.
        evt = (time.monotonic(), time.time(), kind, thread, a, b)
        with self._lock:
            self._ring[self._idx % self.cap] = evt
            self._idx += 1

    def events(self, limit: int = 0) -> List[tuple]:
        """Stored events, oldest first. ``limit`` bounds to the newest
        N (0 = all stored)."""
        with self._lock:
            n = min(self._idx, self.cap)
            start = self._idx - n
            out = [self._ring[(start + k) % self.cap] for k in range(n)]
        out = [e for e in out if e is not None]
        if limit and len(out) > limit:
            out = out[-limit:]
        return out

    def stats(self) -> dict:
        with self._lock:
            return {"events": self._idx,
                    "stored": min(self._idx, self.cap),
                    "capacity": self.cap}

    def reset(self) -> None:
        with self._lock:
            self._ring = [None] * self.cap
            self._idx = 0


class ConvoyTracker:
    """Online width tracking for thread pile-ups at a park site.

    park()/unpark() are O(1) under a leaf lock; a convoy OPENS when the
    live width crosses CONVOY_MIN_WIDTH and CLOSES when it falls back
    below, recording ``(start_wall, duration_ms, peak_width)`` into a
    drop-oldest ring of CONVOY_KEEP slots.
    """

    def __init__(self, min_width: int = CONVOY_MIN_WIDTH,
                 keep: int = CONVOY_KEEP):
        self.min_width = min_width
        self.keep = keep
        self._lock = threading.Lock()
        self.width = 0  # guarded-by: _lock (live parked count)
        self.max_width = 0  # guarded-by: _lock (lifetime high-water)
        self.convoys = 0  # guarded-by: _lock (completed convoy count)
        self._open_at = 0.0  # guarded-by: _lock (monotonic; 0 = closed)
        self._open_wall = 0.0  # guarded-by: _lock
        self._open_peak = 0  # guarded-by: _lock
        self._ring: List[Optional[tuple]] = [None] * keep
        self._ring_idx = 0  # guarded-by: _lock

    def park(self) -> int:
        """A thread parked; returns the width AFTER the park."""
        now = time.monotonic()
        with self._lock:
            self.width += 1
            w = self.width
            if w > self.max_width:
                self.max_width = w
            if self._open_at == 0.0 and w >= self.min_width:
                self._open_at = now
                self._open_wall = time.time()
                self._open_peak = w
            elif self._open_at and w > self._open_peak:
                self._open_peak = w
            return w

    def unpark(self) -> int:
        """A thread resumed; returns the width AFTER the unpark."""
        now = time.monotonic()
        with self._lock:
            if self.width > 0:
                self.width -= 1
            w = self.width
            if self._open_at and w < self.min_width:
                done = (round(self._open_wall, 6),
                        round((now - self._open_at) * 1000.0, 3),
                        self._open_peak)
                self._ring[self._ring_idx % self.keep] = done
                self._ring_idx += 1
                self.convoys += 1
                self._open_at = 0.0
                self._open_peak = 0
            return w

    def recent(self) -> List[dict]:
        """Completed convoys, newest first."""
        with self._lock:
            n = min(self._ring_idx, self.keep)
            slots = [self._ring[(self._ring_idx - 1 - k) % self.keep]
                     for k in range(n)]
        return [{"start_unix": s[0], "duration_ms": s[1], "width": s[2]}
                for s in slots if s is not None]

    def stats(self) -> dict:
        with self._lock:
            open_width = self._open_peak if self._open_at else 0
            open_for = ((time.monotonic() - self._open_at) * 1000.0
                        if self._open_at else 0.0)
            return {
                "width": self.width,
                "max_width": self.max_width,
                "convoys": self.convoys,
                "min_width": self.min_width,
                "open_width": open_width,
                "open_for_ms": round(open_for, 3),
            }

    def reset(self) -> None:
        with self._lock:
            # The live width is real (threads are still parked); only
            # the history and high-water reset.
            self.max_width = self.width
            self.convoys = 0
            self._ring = [None] * self.keep
            self._ring_idx = 0
            if self._open_at == 0.0 and self.width >= self.min_width:
                self._open_at = time.monotonic()
                self._open_wall = time.time()
                self._open_peak = self.width
