"""Profiled synchronization primitives: drop-in ``threading.Lock`` /
``RLock`` / ``Condition`` replacements that record per-declaration-site
acquire-wait and hold-time into the shared log-bucket histograms
(utils/metrics.py bucket math — the same ladder the flight recorder
reads percentiles off).

Design constraints, in order:

- **The uncontended path must stay cheap.** ``acquire`` first tries a
  non-blocking grab of the raw primitive; on success it pays one
  counter bump and one clock read. Only a CONTENDED acquire measures
  its wait (two clock reads) — the common case never times a wait that
  was zero.
- **Stats are guarded by the profiled lock itself.** Wait is recorded
  *after* acquisition, hold *before* release — both while the lock is
  held, so the per-instance ``_SiteStats`` needs no lock of its own and
  can never tear under concurrent writers. Instances sharing a
  declaration site (e.g. the trace recorder's 8 stripes) each own
  their stats; the profiler aggregates per site at READ time.
- **The record path never parks and never grows** (the manifest in
  profile/__init__.py): observes are arithmetic + subscript writes into
  preallocated bucket arrays.
- **Drop-in shapes.** ``ProfiledCondition(self._lock, site)`` aliases
  its backing lock exactly as ``threading.Condition(self._lock)`` does,
  so ``# guarded-by:`` comments read the same over wrapped call sites.

A reader snapshotting stats without the lock sees monotonic counters
mid-update — worst case a percentile is off by the one in-flight
sample, the same benign tear the recorder's ``enabled`` flag accepts.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from ..utils.metrics import LatencyHist, hist_percentile

_monotonic = time.monotonic


class _WaitHist(LatencyHist):
    """The shared fixed-size log-bucket histogram (utils/metrics.py
    LatencyHist — one implementation for the recorder AND the
    profiler; its observe leaf carries the record-path manifest) plus
    the profiler's read-side merge/stats helpers. Single-writer by
    construction wherever it is used (see module docstring)."""

    __slots__ = ()

    def merge_into(self, count, total, mx, buckets):
        """Accumulate this hist into running aggregates (read side)."""
        for i, c in enumerate(self.buckets):
            if c:
                buckets[i] += c
        return (count + self.count, total + self.total,
                max(mx, self.max))

    def stats(self) -> dict:
        count = self.count
        if not count:
            return {"count": 0}
        return {
            "count": count,
            "total_ms": round(self.total, 3),
            "mean_ms": round(self.total / count, 4),
            "max_ms": round(self.max, 3),
            "p50_ms": round(hist_percentile(self.buckets, count, 0.50), 4),
            "p95_ms": round(hist_percentile(self.buckets, count, 0.95), 4),
            "p99_ms": round(hist_percentile(self.buckets, count, 0.99), 4),
        }


class _SiteStats:
    """Per-lock-instance counters + histograms. Mutated only while the
    owning profiled lock is held (never torn); aggregated across
    same-site instances by the profiler's read side."""

    __slots__ = ("site", "kind", "acquires", "contended", "wait",
                 "hold", "cond_waits", "cond_wait")

    def __init__(self, site: str, kind: str):
        self.site = site
        self.kind = kind
        self.acquires = 0
        self.contended = 0
        self.wait = _WaitHist()       # contended acquire-wait (ms)
        self.hold = _WaitHist()       # critical-section hold (ms)
        self.cond_waits = 0
        self.cond_wait = _WaitHist()  # Condition.wait park (ms)


class ProfiledLock:
    """Drop-in ``threading.Lock`` recording acquire-wait + hold time.

    ``site`` names the DECLARATION site (e.g. ``"server.broker"``);
    instances sharing a site aggregate in the profiler's read side.
    """

    __slots__ = ("_lock", "stats", "_acquired_at", "_profiler",
                 "__weakref__")

    _KIND = "lock"

    def __init__(self, site: str = ""):
        self._lock = self._make_raw()
        self._acquired_at = 0.0
        from . import get_profiler

        # Bound once: the profiler is a process-lifetime singleton,
        # and re-resolving it through the import machinery on every
        # acquire/release of the hottest locks is measurable overhead
        # on exactly the paths the 5% budget gates.
        self._profiler = get_profiler()
        self.stats = self._profiler._register_lock(
            self, site or "anonymous", self._KIND)

    @staticmethod
    def _make_raw():
        return threading.Lock()

    def _raw(self):
        """The raw threading primitive (ProfiledCondition backs its
        threading.Condition with this so wait/notify semantics are the
        interpreter's own)."""
        return self._lock

    # ------------------------------------------------------- lock API

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        prof = self._profiler
        if not prof.enabled:
            return self._lock.acquire(blocking, timeout)
        st = self.stats
        if self._lock.acquire(False):
            # Uncontended: one clock read (the hold stamp), no wait
            # measurement — recording a zero costs more than it tells.
            st.acquires += 1
            self._acquired_at = _monotonic()
            return True
        if not blocking:
            return False
        t0 = _monotonic()
        got = self._lock.acquire(True, timeout)
        if not got:
            return False
        now = _monotonic()
        st.acquires += 1
        st.contended += 1
        wait_ms = (now - t0) * 1000.0
        st.wait.observe(wait_ms)
        prof._note_thread_wait(st.site, wait_ms)
        self._acquired_at = now
        return True

    def release(self) -> None:
        if self._profiler.enabled and self._acquired_at:
            self.stats.hold.observe(
                (_monotonic() - self._acquired_at) * 1000.0)
        # Cleared UNCONDITIONALLY: a stamp surviving a
        # disabled-profiler release would be read by a later
        # enabled-again release as one giant hold spanning the whole
        # disabled window (an on/off A/B flips exactly this way).
        self._acquired_at = 0.0
        self._lock.release()

    def locked(self) -> bool:
        return self._lock.locked()

    def __enter__(self) -> "ProfiledLock":
        self.acquire()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.release()

    # ---------------------------------------- Condition.wait plumbing

    def _pause_hold(self):
        """Close the current hold interval (ProfiledCondition.wait is
        about to release the raw lock); returns opaque resume state."""
        if self._profiler.enabled and self._acquired_at:
            self.stats.hold.observe(
                (_monotonic() - self._acquired_at) * 1000.0)
        self._acquired_at = 0.0
        return None

    def _resume_hold(self, _state) -> None:
        """Reopen hold accounting after the raw lock was re-acquired
        inside Condition.wait."""
        self._acquired_at = _monotonic()


class ProfiledRLock(ProfiledLock):
    """Drop-in ``threading.RLock``: reentrant, hold time measured on
    the OUTERMOST hold. Owner/depth bookkeeping is wrapper-level (the
    raw RLock keeps its own) because ``Condition._release_save`` can
    release the raw lock underneath us — state is saved/restored around
    waits by ProfiledCondition via _pause_hold/_resume_hold."""

    __slots__ = ("_owner", "_depth")

    _KIND = "rlock"

    def __init__(self, site: str = ""):
        super().__init__(site)
        self._owner: Optional[int] = None
        self._depth = 0

    @staticmethod
    def _make_raw():
        return threading.RLock()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        prof = self._profiler
        if not prof.enabled:
            got = self._lock.acquire(blocking, timeout)
            if got:
                me = threading.get_ident()
                if self._owner == me:
                    self._depth += 1
                else:
                    self._owner = me
                    self._depth = 1
            return got
        me = threading.get_ident()
        st = self.stats
        if self._owner == me:
            # Reentrant: raw acquire cannot block for the owner.
            self._lock.acquire()
            self._depth += 1
            st.acquires += 1
            return True
        if self._lock.acquire(False):
            st.acquires += 1
            self._owner = me
            self._depth = 1
            self._acquired_at = _monotonic()
            return True
        if not blocking:
            return False
        t0 = _monotonic()
        got = self._lock.acquire(True, timeout)
        if not got:
            return False
        now = _monotonic()
        st.acquires += 1
        st.contended += 1
        wait_ms = (now - t0) * 1000.0
        st.wait.observe(wait_ms)
        prof._note_thread_wait(st.site, wait_ms)
        self._owner = me
        self._depth = 1
        self._acquired_at = now
        return True

    def release(self) -> None:
        self._depth -= 1
        if self._depth == 0:
            self._owner = None
            if self._profiler.enabled and self._acquired_at:
                self.stats.hold.observe(
                    (_monotonic() - self._acquired_at) * 1000.0)
            self._acquired_at = 0.0
        self._lock.release()

    def locked(self) -> bool:
        # _thread.RLock grew .locked() only in 3.14; the drop-in
        # contract needs it everywhere. Owned-by-me answers without
        # touching the raw lock (a reentrant probe would succeed and
        # lie); otherwise a non-blocking probe settles it.
        if self._owner == threading.get_ident():
            return True
        if self._lock.acquire(False):
            self._lock.release()
            return False
        return True

    def __enter__(self) -> "ProfiledRLock":
        self.acquire()
        return self

    def _pause_hold(self):
        state = (self._owner, self._depth)
        super()._pause_hold()
        self._owner = None
        self._depth = 0
        return state

    def _resume_hold(self, state) -> None:
        self._owner, self._depth = state
        self._acquired_at = _monotonic()


class ProfiledCondition:
    """Drop-in ``threading.Condition`` over a ProfiledLock/RLock.

    ``ProfiledCondition(self._lock, "site")`` aliases to its backing
    lock exactly like ``threading.Condition(self._lock)`` does (and
    a reader of ``# guarded-by:`` treats it the same way): entering the
    condition acquires — and profiles — the shared lock. ``wait``
    pauses the lock's hold accounting (the raw lock is released while
    parked), records the park duration into the site's cond-wait
    histogram, and resumes hold accounting on wake.
    """

    def __init__(self, lock=None, site: str = ""):
        if lock is None:
            lock = ProfiledLock(site or "anonymous.cond")
        if not isinstance(lock, ProfiledLock):
            raise TypeError(
                "ProfiledCondition requires a ProfiledLock/ProfiledRLock "
                "(wrap the backing lock too, or use threading.Condition)")
        self._plock = lock
        self._cond = threading.Condition(lock._raw())
        self.stats = lock.stats

    # Lock interface delegates to the profiled lock.
    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        return self._plock.acquire(blocking, timeout)

    def release(self) -> None:
        self._plock.release()

    def __enter__(self) -> "ProfiledCondition":
        self._plock.acquire()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self._plock.release()

    def wait(self, timeout: Optional[float] = None) -> bool:
        prof = self._plock._profiler
        if not prof.enabled:
            state = self._plock._pause_hold()
            try:
                return self._cond.wait(timeout)
            finally:
                self._plock._resume_hold(state)
        st = self.stats
        state = self._plock._pause_hold()
        t0 = _monotonic()
        try:
            got = self._cond.wait(timeout)
        finally:
            # Raw lock re-acquired by Condition.wait; restore wrapper
            # ownership before anything else can observe it.
            self._plock._resume_hold(state)
        st.cond_waits += 1
        st.cond_wait.observe((_monotonic() - t0) * 1000.0)
        return got

    # No-timeout wait_for parks in bounded slices (unbounded-wait
    # discipline: the primitive itself must not hide a forever-park;
    # Condition semantics permit spurious wakeups, so re-checking the
    # predicate each slice is contract-clean).
    WAIT_FOR_SLICE_S = 1.0

    def wait_for(self, predicate, timeout: Optional[float] = None):
        """threading.Condition.wait_for semantics over profiled
        waits."""
        endtime = None
        result = predicate()
        while not result:
            if timeout is not None:
                if endtime is None:
                    endtime = _monotonic() + timeout
                waittime = endtime - _monotonic()
                if waittime <= 0:
                    break
                self.wait(waittime)
            else:
                self.wait(self.WAIT_FOR_SLICE_S)
            result = predicate()
        return result

    def notify(self, n: int = 1) -> None:
        self._cond.notify(n)

    def notify_all(self) -> None:
        self._cond.notify_all()
