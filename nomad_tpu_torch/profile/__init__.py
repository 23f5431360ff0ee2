"""The contention observatory: always-on lock/GIL/pipeline profiler
(the port of the JAX package's profile/).

Always-on like the flight recorder (trace/): the observatory
turns thread/lock/GIL contention and device-pipeline convoys into
first-class telemetry instead of inferences from percentile gaps.
Three instruments, one process-global Profiler:

- **ProfiledLock / ProfiledRLock / ProfiledCondition** (locks.py):
  drop-in threading primitives recording per-declaration-site
  acquire-wait and hold time into the shared log-bucket histograms.
  Wired into the port's hot locks: the placement batcher
  (``scheduler.batcher``), the cluster-matrix position index
  (``models.matrix.positions``) and the trace recorder's stripes
  (``trace.recorder.*``). The broker's and the dispatch pipeline's
  sites come with those modules.
- **GIL-pressure sampler** (sampler.py): a thread measuring
  sleep-overshoot — requested vs actual wake, a direct proxy for
  interpreter scheduling delay — plus per-worker run-queue delay
  stamped at broker drain and batch-park points (record_runq; until
  the broker is ported only ``batch_park`` is stamped).
- **Pipeline timeline + convoy detector** (timeline.py): a bounded
  ring of batch-lifecycle events and an online tracker reporting the
  width and duration of thread pile-ups at the batch boundary.

Exposure: ``snapshot()`` (locks, gil, runq, convoys, timeline), the
Prometheus exposition (``format_prometheus``), and the Chrome
trace-event (Perfetto-loadable) export in export.py.

Overhead discipline: the uncontended lock path pays one counter bump
and one clock read; everything on the record path is arithmetic +
preallocated-slot writes under leaf locks (the ``NTA_RECORD_PATH``
manifests here and in locks.py/timeline.py name its entry points,
kept as data as in the JAX package). The budget is < 5% paired end to
end; chip_smoke.py's runtime phase prints the port's on/off ratio.
"""

from __future__ import annotations

import collections
import threading
import weakref
from typing import Dict, List, Optional

from ..utils.metrics import (
    HIST_BUCKETS,
    hist_bucket_upper,
    hist_percentile,
)
from .locks import (  # noqa: F401
    ProfiledCondition,
    ProfiledLock,
    ProfiledRLock,
    _SiteStats,
    _WaitHist,
)
from .sampler import GilSampler
from .timeline import ConvoyTracker, Timeline

# Bounds: everything the profiler stores is capped at registration
# time, so the record paths never grow anything.
MAX_LOCK_INSTANCES = 1024   # registered lock objects (per process)
MAX_THREADS = 256           # per-thread drill-down entries
MAX_PARK_SITES = 16         # convoy trackers
RUNQ_SITES = ("broker_drain", "batch_park")

# Record-path manifest, kept as data (the JAX package's linter walks
# the same names there): the profiler
# record entrypoints the hot locks, the broker, and the dispatcher
# thread run through. Everything reachable from these must never park
# (leaf `with lock:` around constant work only) and never grow a
# container (preallocated slots / capped subscript assignment only).
NTA_RECORD_PATH = (
    "Profiler.record_runq",
    "Profiler.park",
    "Profiler.unpark",
    "Profiler.event",
    "Profiler._note_thread_wait",
)


class _ThreadStats:
    """Per-thread contention totals. Each entry is written only by its
    own thread (registered via a threading.local), so plain attributes
    never tear."""

    __slots__ = ("name", "wait_ms", "waits", "runq_ms", "runqs",
                 "top_site", "top_site_ms")

    def __init__(self, name: str):
        self.name = name
        self.wait_ms = 0.0
        self.waits = 0
        self.runq_ms = 0.0
        self.runqs = 0
        self.top_site = ""
        self.top_site_ms = 0.0

    def to_dict(self) -> dict:
        return {
            "lock_wait_ms": round(self.wait_ms, 3),
            "lock_waits": self.waits,
            "runq_delay_ms": round(self.runq_ms, 3),
            "runq_samples": self.runqs,
            "hottest_site": self.top_site,
            "hottest_site_wait_ms": round(self.top_site_ms, 3),
        }


class Profiler:
    def __init__(self):
        # Plain attribute read on every record call (on/off A/B arms
        # and tests flip it); no lock — a racing
        # record lands or not, either is fine.
        self.enabled = True
        self._reg_lock = threading.Lock()
        # site -> list of LIVE _SiteStats (one per lock instance);
        # bounded by MAX_LOCK_INSTANCES total, and a dead lock's stats
        # RETIRE: a weakref.finalize on the lock folds its counts into
        # the site's retired aggregate and frees the live slot, so a
        # churny site (e.g. per-ClusterBase position locks, one per
        # snapshot) neither exhausts the cap nor accretes dead
        # histograms the read side must walk forever.
        self._lock_sites: Dict[str, List[_SiteStats]] = {}
        self._lock_retired: Dict[str, _SiteStats] = {}  # guarded-by: _reg_lock
        self._lock_instances = 0  # guarded-by: _reg_lock
        # Dead locks' stats land here from weakref finalizers, which
        # run DURING garbage collection — possibly on a thread that
        # already holds _reg_lock mid-allocation, so the callback must
        # be lock-free (deque.append is atomic). Registry mutation
        # happens at the next drain under the lock.
        self._retired_queue: collections.deque = collections.deque()
        self.timeline = Timeline()
        self._park_lock = threading.Lock()
        self._parks: Dict[str, ConvoyTracker] = {}  # guarded-by: _park_lock
        self.gil = GilSampler()
        self._runq_lock = threading.Lock()
        self._runq: Dict[str, _WaitHist] = {  # fixed keys, hists swap on reset
            site: _WaitHist() for site in RUNQ_SITES
        }
        self._tls = threading.local()
        self._threads_lock = threading.Lock()
        self._threads: Dict[str, _ThreadStats] = {}  # guarded-by: _threads_lock

    # ------------------------------------------------- registration

    def _register_lock(self, lock, site: str, kind: str) -> _SiteStats:
        """Called at lock CONSTRUCTION (never on the record path).
        Past the live-instance cap, stats still exist but are not
        exported — the lock keeps working, the table stays bounded.
        When the lock is garbage-collected its stats retire into the
        site's aggregate (no more writers can exist, so the merge
        cannot tear) and the live slot frees."""
        stats = _SiteStats(site, kind)
        self._drain_retired()
        with self._reg_lock:
            if self._lock_instances >= MAX_LOCK_INSTANCES:
                return stats
            self._lock_instances += 1
            self._lock_sites.setdefault(site, []).append(stats)
        weakref.finalize(lock, self._retired_queue.append, (site, stats))
        return stats

    def _drain_retired(self) -> None:
        """Fold queued dead-lock stats into their sites' retired
        aggregates. The dead stats have no writers left, so the merge
        cannot tear. Runs at registration and read time — never inside
        a GC finalizer (which may fire on a thread that already holds
        _reg_lock; the finalizer itself only appends to the lock-free
        queue)."""
        while True:
            try:
                site, stats = self._retired_queue.popleft()
            except IndexError:
                return
            with self._reg_lock:
                live = self._lock_sites.get(site)
                if live is None or stats not in live:
                    continue  # never exported (cap) or already reset
                live.remove(stats)
                self._lock_instances -= 1
                retired = self._lock_retired.get(site)
                if retired is None:
                    retired = self._lock_retired[site] = _SiteStats(
                        site, stats.kind)
                retired.acquires += stats.acquires
                retired.contended += stats.contended
                retired.cond_waits += stats.cond_waits
                for field in ("wait", "hold", "cond_wait"):
                    dst = getattr(retired, field)
                    src = getattr(stats, field)
                    dst.count += src.count
                    dst.total += src.total
                    if src.max > dst.max:
                        dst.max = src.max
                    for i, c in enumerate(src.buckets):
                        if c:
                            dst.buckets[i] += c

    def _register_thread(self) -> Optional[_ThreadStats]:
        name = threading.current_thread().name
        with self._threads_lock:
            st = self._threads.get(name)
            if st is None:
                if len(self._threads) >= MAX_THREADS:
                    return None
                st = _ThreadStats(name)
                self._threads[name] = st
            return st

    def _thread_stats(self) -> Optional[_ThreadStats]:
        tls = self._tls
        st = getattr(tls, "stats", None)
        if st is None:
            st = self._register_thread()
            if st is not None:
                tls.stats = st
        return st

    # -------------------------------------------------- record path

    def _note_thread_wait(self, site: str, wait_ms: float) -> None:
        """Contended lock wait attribution onto the waiting thread
        (called by ProfiledLock while the lock is held)."""
        st = self._thread_stats()
        if st is None:
            return
        st.wait_ms += wait_ms
        st.waits += 1
        if wait_ms > st.top_site_ms:
            st.top_site = site
            st.top_site_ms = wait_ms

    def record_runq(self, site: str, delay_ms: float) -> None:
        """Run-queue delay: ready-work-published -> worker actually
        running, stamped at broker drain and batch park points."""
        if not self.enabled or delay_ms < 0.0:
            return
        h = self._runq.get(site)
        if h is None:
            return  # fixed vocabulary; unknown sites don't grow it
        with self._runq_lock:
            h.observe(delay_ms)
        st = self._thread_stats()
        if st is not None:
            st.runq_ms += delay_ms
            st.runqs += 1

    def park(self, site: str, thread: str = "") -> bool:
        """A thread parked at a batch boundary; feeds the convoy
        tracker + timeline. Returns True when the park was COUNTED —
        the caller must unpark() exactly when it was (a park taken
        while enabled must decrement even if the profiler is disabled
        mid-park, or the width gauge leaks a phantom pile-up forever).
        Tracker registration is capped (a missing tracker past the cap
        means the park is counted nowhere — a bounded-memory tradeoff,
        same shape as the recorder's active-cap eviction)."""
        if not self.enabled:
            return False
        with self._park_lock:
            tracker = self._parks.get(site)
            if tracker is None:
                if len(self._parks) >= MAX_PARK_SITES:
                    return False
                tracker = ConvoyTracker()
                self._parks[site] = tracker
        w = tracker.park()
        self.timeline.push("park", thread, w, site)
        return True

    def unpark(self, site: str, thread: str = "") -> None:
        """Balance a COUNTED park(). Deliberately not gated on
        `enabled`: the width must come back down even when recording
        was switched off while the thread was parked."""
        with self._park_lock:
            tracker = self._parks.get(site)
        if tracker is None:
            return
        w = tracker.unpark()
        if self.enabled:
            self.timeline.push("unpark", thread, w, site)

    def event(self, kind: str, thread: str = "", a=0, b=0) -> None:
        """Publish one batch-lifecycle event into the timeline ring."""
        if not self.enabled:
            return
        self.timeline.push(kind, thread, a, b)

    # ----------------------------------------------------- read side

    def thread_wait_ms(self) -> float:
        """Cumulative contended lock-wait of the CALLING thread (ms) —
        call sites bracket a stage with two reads and annotate the
        delta onto its trace span."""
        st = getattr(self._tls, "stats", None)
        return st.wait_ms if st is not None else 0.0

    def _site_stats_lists(self) -> Dict[str, List[_SiteStats]]:
        """site -> live instances + the retired aggregate (read-side
        merge input; one consistent cut under the registry lock)."""
        self._drain_retired()
        with self._reg_lock:
            out = {site: list(instances)
                   for site, instances in self._lock_sites.items()
                   if instances}
            for site, retired in self._lock_retired.items():
                out.setdefault(site, []).append(retired)
        return out

    def _aggregate_site(self, instances: List[_SiteStats]) -> dict:
        out: dict = {
            "kind": instances[0].kind,
            "instances": len(instances),
            "acquires": sum(s.acquires for s in instances),
            "contended": sum(s.contended for s in instances),
            "cond_waits": sum(s.cond_waits for s in instances),
        }
        for field in ("wait", "hold", "cond_wait"):
            count, total, mx = 0, 0.0, 0.0
            buckets = [0] * HIST_BUCKETS
            for s in instances:
                count, total, mx = getattr(s, field).merge_into(
                    count, total, mx, buckets)
            if count:
                out[field] = {
                    "count": count,
                    "total_ms": round(total, 3),
                    "mean_ms": round(total / count, 4),
                    "max_ms": round(mx, 3),
                    "p50_ms": round(
                        hist_percentile(buckets, count, 0.50), 4),
                    "p95_ms": round(
                        hist_percentile(buckets, count, 0.95), 4),
                    "p99_ms": round(
                        hist_percentile(buckets, count, 0.99), 4),
                }
        return out

    def lock_table(self) -> Dict[str, dict]:
        """Per-declaration-site lock stats: live instances plus the
        site's retired (garbage-collected locks) aggregate."""
        return {site: self._aggregate_site(instances)
                for site, instances in self._site_stats_lists().items()}

    def lock_site_buckets(self, field: str = "wait"):
        """(site -> (count, dense buckets)) for one histogram family —
        the Prometheus exposition and the A/B aggregation read this
        so their percentiles come off the same ladder as snapshot()."""
        out = {}
        for site, instances in self._site_stats_lists().items():
            count, total, mx = 0, 0.0, 0.0
            buckets = [0] * HIST_BUCKETS
            for s in instances:
                count, total, mx = getattr(s, field).merge_into(
                    count, total, mx, buckets)
            if count:
                out[site] = (count, total, buckets)
        return out

    def runq_table(self) -> Dict[str, dict]:
        with self._runq_lock:
            return {site: h.stats() for site, h in self._runq.items()
                    if h.count}

    def convoy_table(self) -> dict:
        with self._park_lock:
            trackers = dict(self._parks)
        sites = {site: t.stats() for site, t in trackers.items()}
        max_width = max((s["max_width"] for s in sites.values()),
                        default=0)
        recent: List[dict] = []
        for site, t in trackers.items():
            for c in t.recent():
                recent.append(dict(c, site=site))
        recent.sort(key=lambda c: c["start_unix"], reverse=True)
        return {
            "max_width": max_width,
            "convoys": sum(s["convoys"] for s in sites.values()),
            "sites": sites,
            "recent": recent[:32],
        }

    def threads_table(self) -> Dict[str, dict]:
        with self._threads_lock:
            entries = list(self._threads.values())
        return {st.name: st.to_dict() for st in entries}

    def snapshot(self, threads: bool = False) -> dict:
        out = {
            "enabled": self.enabled,
            "locks": self.lock_table(),
            "gil": self.gil.stats(),
            "runq": self.runq_table(),
            "convoys": self.convoy_table(),
            "timeline": self.timeline.stats(),
        }
        if threads:
            out["threads"] = self.threads_table()
        return out

    def format_prometheus(self, prefix: str = "nomad_tpu_profile") -> str:
        """Prometheus text exposition (0.0.4) of the observatory:
        lock wait/hold/cond-wait and runq-delay histograms as labelled
        ``site=`` series over the shared log-bucket ladder, the GIL
        overshoot histogram, and the convoy gauges. Appended to the
        telemetry registry's exposition — conformance is
        covered by the same line-level parser test."""
        from ..utils.metrics import _prom_num, emit_histogram_family

        lines: List[str] = []

        def hist_family(name: str, help_text: str, series: dict) -> None:
            """series: site label (or "" for unlabelled) ->
            (count, total, dense bucket list); the shared registry
            emitter does the 0.0.4 encoding."""
            emit_histogram_family(lines, name, help_text, series)

        hist_family(f"{prefix}_lock_wait_ms",
                    "contended lock acquire-wait per site (milliseconds)",
                    self.lock_site_buckets("wait"))
        hist_family(f"{prefix}_lock_hold_ms",
                    "lock hold time per site (milliseconds)",
                    self.lock_site_buckets("hold"))
        hist_family(f"{prefix}_cond_wait_ms",
                    "condition wait park per site (milliseconds)",
                    self.lock_site_buckets("cond_wait"))
        gil = self.gil.hist
        if gil.count:
            hist_family(
                f"{prefix}_gil_overshoot_ms",
                "sleep overshoot: interpreter scheduling delay "
                "(milliseconds)",
                {"": (gil.count, gil.total, list(gil.buckets))})
        with self._runq_lock:
            runq = {site: (h.count, h.total, list(h.buckets))
                    for site, h in self._runq.items() if h.count}
        hist_family(f"{prefix}_runq_delay_ms",
                    "ready-work to thread-running delay per stamp site "
                    "(milliseconds)", runq)
        convoys = self.convoy_table()
        for name, help_text, value, kind in (
            ("convoy_width", "threads currently parked at the widest "
             "site", max((s["width"] for s in convoys["sites"].values()),
                         default=0), "gauge"),
            ("convoy_max_width", "high-water parked-thread pile-up "
             "width", convoys["max_width"], "gauge"),
            ("convoys_total", "completed convoys (width >= threshold)",
             convoys["convoys"], "counter"),
        ):
            p = f"{prefix}_{name}"
            lines.append(f"# HELP {p} {help_text}")
            lines.append(f"# TYPE {p} {kind}")
            lines.append(f"{p} {_prom_num(value)}")
        return "\n".join(lines) + "\n" if lines else ""

    # ------------------------------------------------------- control

    def set_enabled(self, enabled: bool) -> None:
        self.enabled = bool(enabled)

    def ensure_sampler(self) -> None:
        if self.enabled:
            self.gil.start()

    def configure(self, enabled: Optional[bool] = None,
                  sampler_interval: Optional[float] = None) -> None:
        if enabled is not None:
            self.set_enabled(enabled)
        if sampler_interval is not None and sampler_interval > 0:
            # <= 0 is ignored explicitly (a zero interval would spin);
            # disabling the sampler is `enabled=False`, not interval 0.
            self.gil.interval = sampler_interval
        if self.enabled:
            self.gil.start()
        else:
            self.gil.stop()

    def reset(self) -> None:
        """Drop accumulated stats (A/B arms and test isolation;
        not on the record path). Racing writers may lose a sample into
        a just-replaced histogram — benign for an A/B reset."""
        self._drain_retired()
        with self._reg_lock:
            instances = [s for lst in self._lock_sites.values()
                         for s in lst]
            self._lock_retired = {}
        for s in instances:
            s.acquires = 0
            s.contended = 0
            s.cond_waits = 0
            s.wait = _WaitHist()
            s.hold = _WaitHist()
            s.cond_wait = _WaitHist()
        self.timeline.reset()
        with self._park_lock:
            trackers = list(self._parks.values())
        for t in trackers:
            t.reset()
        self.gil.reset()
        with self._runq_lock:
            for site in list(self._runq):
                self._runq[site] = _WaitHist()
        with self._threads_lock:
            entries = list(self._threads.values())
        for st in entries:
            st.wait_ms = 0.0
            st.waits = 0
            st.runq_ms = 0.0
            st.runqs = 0
            st.top_site = ""
            st.top_site_ms = 0.0


# The process-wide profiler every instrumentation site uses; module
# level so the disabled check is two attribute loads + a branch (same
# shape as trace._recorder).
_profiler = Profiler()


def get_profiler() -> Profiler:
    return _profiler


def park(site: str, thread: str = "") -> bool:
    return _profiler.park(site, thread)


def unpark(site: str, thread: str = "") -> None:
    _profiler.unpark(site, thread)


def event(kind: str, thread: str = "", a=0, b=0) -> None:
    _profiler.event(kind, thread, a, b)


def record_runq(site: str, delay_ms: float) -> None:
    _profiler.record_runq(site, delay_ms)


def thread_wait_ms() -> float:
    return _profiler.thread_wait_ms()


def ensure_sampler() -> None:
    _profiler.ensure_sampler()
