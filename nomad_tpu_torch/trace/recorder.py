"""Flight recorder: bounded, lock-striped storage for eval span trees.

Always-on. The record path is called from the broker (under its lock),
from the dispatch pipeline's stage threads, and — via dequeue_many —
from the dispatcher thread itself, so it must NEVER block and NEVER
grow without bound:

- storage is striped: ``hash(eval_id) % N_STRIPES`` picks a stripe;
  each stripe has its own lock, so concurrent writers on different
  evals don't convoy, and every critical section is a handful of dict
  and slot operations (no I/O, no waits, no allocation proportional to
  anything unbounded).
- completed traces go into per-stripe RINGS of preallocated slots —
  drop-oldest by construction (slot index wraps), fixed memory.
- active (incomplete) traces live in a per-stripe dict capped at
  ``ACTIVE_PER_STRIPE``; admission past the cap evicts the oldest
  entry (insertion order) rather than blocking or growing.
- per-trace span storage is a PREALLOCATED slot list (``SPAN_CAP``);
  spans past the cap are counted, not stored.
- per-stage latency histograms are fixed log-bucket arrays
  (utils/metrics.py bucket math) so p50/p95/p99 are computable at any
  time from O(buckets) memory.

``NTA_RECORD_PATH`` names the record-path entrypoints, kept as data
as in the JAX package (whose linter walks everything reachable from
them for blocking calls and unbounded-growth container mutations).

Tail-keep: completed traces slower than the rolling p99 of end-to-end
duration (once ``TAIL_MIN_SAMPLES`` have been seen) are ALSO copied
into a dedicated tail ring, so the outliers that define the north-star
p99 survive long after the recent-ring has wrapped past them.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

from ..profile import ProfiledLock
from ..utils.metrics import (
    LatencyHist,
    hist_percentile,
)
from .span import make_span, span_to_dict

N_STRIPES = 8
RING_PER_STRIPE = 64     # completed traces kept per stripe (recent)
TAIL_KEEP = 32           # slow traces kept in the tail ring
SPAN_CAP = 32            # spans stored per trace (excess counted)
FAULT_CAP = 8            # fault annotations stored per trace
ACTIVE_PER_STRIPE = 256  # in-flight traces per stripe before eviction
TAIL_MIN_SAMPLES = 64    # e2e samples before tail-keep engages
MAX_STAGES = 64          # distinct stage histograms (instrumentation-bounded)

# Record-path manifest, kept as data: every function reachable from
# these (the paths the broker lock and the dispatcher thread run) must
# contain no blocking call and no unbounded container growth.
NTA_RECORD_PATH = (
    "FlightRecorder.mark",
    "FlightRecorder.record_span",
    "FlightRecorder.record_since_mark",
    "FlightRecorder.annotate_fault",
    "FlightRecorder.complete",
)


# The shared fixed-size log-bucket histogram (utils/metrics.py
# LatencyHist; one implementation for the recorder AND the profiler).
_Hist = LatencyHist


class _Trace:
    """One in-flight eval's trace. Span and fault storage are
    preallocated slot lists (fixed memory; see module docstring)."""

    __slots__ = ("eval_id", "trace_id", "origin", "wall_start", "spans",
                 "n_spans", "dropped_spans", "faults", "n_faults",
                 "enqueued_at")

    def __init__(self, eval_id: str, trace_id: str):
        self.eval_id = eval_id
        self.trace_id = trace_id or eval_id
        self.origin = time.monotonic()
        self.wall_start = time.time()
        self.spans = [None] * SPAN_CAP
        self.n_spans = 0
        self.dropped_spans = 0
        self.faults = [None] * FAULT_CAP
        self.n_faults = 0
        self.enqueued_at: Optional[float] = None


class _Stripe:
    __slots__ = ("lock", "active", "ring", "ring_idx", "evicted",
                 "dropped_spans")

    def __init__(self):
        # Profiled (profile/): the stripes are taken under the
        # broker lock and on every stage thread — their wait histogram
        # is the recorder's own contention self-check.
        self.lock = ProfiledLock("trace.recorder.stripe")
        self.active: Dict[str, _Trace] = {}  # guarded-by: lock
        self.ring: List[Optional[dict]] = [None] * RING_PER_STRIPE
        self.ring_idx = 0  # guarded-by: lock (monotonic; slot = idx % K)
        self.evicted = 0  # guarded-by: lock (active-cap evictions)
        self.dropped_spans = 0  # guarded-by: lock


class FlightRecorder:
    def __init__(self):
        # Plain attribute read on every record call (an on/off A/B
        # arm and tests flip it); no lock — a racing record lands or
        # not, either is fine.
        self.enabled = True
        self._stripes = [_Stripe() for _ in range(N_STRIPES)]
        self._hist_lock = ProfiledLock("trace.recorder.hist")
        self._hists: Dict[str, _Hist] = {}  # guarded-by: _hist_lock
        self._e2e = _Hist()  # guarded-by: _hist_lock
        self._tail_lock = ProfiledLock("trace.recorder.tail")
        self._tail: List[Optional[dict]] = [None] * TAIL_KEEP
        self._tail_idx = 0  # guarded-by: _tail_lock
        self._completed = 0  # guarded-by: _tail_lock (lifetime count)

    # ----------------------------------------------------- record path

    def _stripe_for(self, eval_id: str) -> _Stripe:
        return self._stripes[hash(eval_id) % N_STRIPES]

    def _entry_locked(self, stripe: _Stripe, eval_id: str,
                      trace_id: str = "") -> _Trace:
        entry = stripe.active.get(eval_id)
        if entry is None:
            if len(stripe.active) >= ACTIVE_PER_STRIPE:
                # Drop-oldest admission: dict preserves insertion
                # order, so the first key is the longest-inactive
                # trace. Never blocks, never grows.
                oldest = next(iter(stripe.active))
                del stripe.active[oldest]
                stripe.evicted += 1
            entry = _Trace(eval_id, trace_id)
            stripe.active[eval_id] = entry
        elif trace_id and entry.trace_id == entry.eval_id:
            entry.trace_id = trace_id
        return entry

    def mark(self, eval_id: str, trace_id: str = "") -> None:
        """Stamp the broker-enqueue instant (consumed by
        record_since_mark at dequeue). Creates the trace on first
        touch."""
        if not self.enabled or not eval_id:
            return
        stripe = self._stripe_for(eval_id)
        with stripe.lock:
            entry = self._entry_locked(stripe, eval_id, trace_id)
            entry.enqueued_at = time.monotonic()

    def record_since_mark(self, eval_id: str, stage: str,
                          ann: Optional[dict] = None) -> None:
        """Record `stage` spanning the last mark() to now. No-op when
        no mark is outstanding (e.g. an eval enqueued before arming)."""
        if not self.enabled or not eval_id:
            return
        now = time.monotonic()
        stripe = self._stripe_for(eval_id)
        dur_ms = None
        with stripe.lock:
            entry = stripe.active.get(eval_id)
            if entry is None or entry.enqueued_at is None:
                return
            t0 = entry.enqueued_at
            entry.enqueued_at = None
            self._store_span_locked(stripe, entry, stage, t0, now, ann)
            dur_ms = (now - t0) * 1000.0
        self._hist_add(stage, dur_ms)

    def record_span(self, eval_id: str, stage: str, t0: float,
                    t1: Optional[float] = None,
                    ann: Optional[dict] = None,
                    trace_id: str = "", create: bool = True) -> None:
        """Record one completed stage: `t0` (and `t1`, default now) are
        time.monotonic() values captured at the call site.

        ``create=False`` records only onto an ALREADY-ACTIVE trace —
        for call sites that also run outside a traced lifecycle (FSM
        applies replay on restart and replicate on followers, where no
        broker ever opened the trace and nothing would ever complete
        it; minting entries there churns the active cap forever and
        pollutes the stage histograms with historical work)."""
        if not self.enabled or not eval_id:
            return
        if t1 is None:
            t1 = time.monotonic()
        stripe = self._stripe_for(eval_id)
        with stripe.lock:
            if create:
                entry = self._entry_locked(stripe, eval_id, trace_id)
            else:
                entry = stripe.active.get(eval_id)
                if entry is None:
                    return
            self._store_span_locked(stripe, entry, stage, t0, t1, ann)
        self._hist_add(stage, (t1 - t0) * 1000.0)

    def _store_span_locked(self, stripe: _Stripe, entry: _Trace,
                           stage: str, t0: float, t1: float,
                           ann: Optional[dict]) -> None:
        if t0 < entry.origin:
            # A span captured before the trace's first touch (e.g. the
            # call site clocked t0, then created the trace): the trace
            # starts at its earliest evidence, so e2e covers stage one
            # and exported offsets stay non-negative.
            entry.wall_start -= entry.origin - t0
            entry.origin = t0
        n = entry.n_spans
        if n < SPAN_CAP:
            entry.spans[n] = make_span(stage, t0, t1, ann)
            entry.n_spans = n + 1
        else:
            entry.dropped_spans += 1
            stripe.dropped_spans += 1

    def annotate_fault(self, eval_id: str, site: str, seq: int,
                       kind: str) -> None:
        """Attach a fault firing (site, per-site call ordinal, kind) to
        the eval's trace; at completion it lands on the span whose
        interval covers the firing time."""
        if not self.enabled or not eval_id:
            return
        now = time.monotonic()
        stripe = self._stripe_for(eval_id)
        with stripe.lock:
            entry = stripe.active.get(eval_id)
            if entry is None:
                return
            n = entry.n_faults
            if n < FAULT_CAP:
                entry.faults[n] = (now, site, seq, kind)
                entry.n_faults = n + 1

    def observe_stage(self, stage: str, ms: float) -> None:
        """Public per-stage histogram feed for non-eval pipelines (the
        read plane's `read.park`/`read.serve` stages): lands in
        stage_stats() without opening a trace and without touching the
        e2e histogram — e2e_p99() feeds the admission pressure monitor
        and must keep measuring the eval lifecycle only."""
        if not self.enabled:
            return
        self._hist_add(stage, ms)

    def _hist_add(self, stage: str, ms: Optional[float]) -> None:
        if ms is None:
            return
        with self._hist_lock:
            h = self._hists.get(stage)
            if h is None:
                if len(self._hists) >= MAX_STAGES:
                    return
                h = _Hist()
                self._hists[stage] = h
            h.observe(ms)

    def complete(self, eval_id: str, status: str = "complete") -> None:
        """Close the eval's trace: finalize the span tree, fold its e2e
        duration into the rolling histogram, then publish into the
        stripe's recent ring (and the tail ring when it lands past the
        p99). The dict is fully built — tail_kept flag included —
        BEFORE it becomes reachable by readers, so a published trace is
        immutable (a reader serializing it can never race a late
        mutation)."""
        if not self.enabled or not eval_id:
            return
        now = time.monotonic()
        stripe = self._stripe_for(eval_id)
        with stripe.lock:
            entry = stripe.active.pop(eval_id, None)
            if entry is None:
                return
            done = self._finalize_locked(entry, now, status)
        dur_ms = done["duration_ms"]
        keep_tail = False
        with self._hist_lock:
            # p99 against the distribution SO FAR (excluding this
            # sample): an outlier compared against a p99 that already
            # contains it would sit inside its own bucket's bound and
            # never qualify.
            if self._e2e.count >= TAIL_MIN_SAMPLES:
                p99 = hist_percentile(
                    self._e2e.buckets, self._e2e.count, 0.99)
                keep_tail = dur_ms >= p99
            self._e2e.observe(dur_ms)
        if keep_tail:
            done["tail_kept"] = True
        with stripe.lock:
            stripe.ring[stripe.ring_idx % RING_PER_STRIPE] = done
            stripe.ring_idx += 1
        with self._tail_lock:
            self._completed += 1
            if keep_tail:
                self._tail[self._tail_idx % TAIL_KEEP] = done
                self._tail_idx += 1

    def _finalize_locked(self, entry: _Trace, now: float,
                         status: str) -> dict:
        """Materialize one immutable dict for the completed trace. Runs
        under the stripe lock but does bounded work only (SPAN_CAP x
        FAULT_CAP)."""
        spans = [entry.spans[i] for i in range(entry.n_spans)]
        spans.sort(key=lambda s: (s[1], -s[2]))
        faults = [entry.faults[i] for i in range(entry.n_faults)]
        origin = entry.origin
        end = now
        for s in spans:
            if s[2] > end:  # completion raced a span's tail
                end = s[2]
        # Each fault attaches to the SMALLEST covering span — the most
        # specific stage the fault fired inside (outer spans cover it
        # trivially and would smear the attribution).
        span_faults: List[list] = [[] for _ in spans]
        covered_flags = [False] * len(faults)
        for fi, f in enumerate(faults):
            best = None
            best_len = None
            for si, s in enumerate(spans):
                if s[1] <= f[0] <= s[2]:
                    slen = s[2] - s[1]
                    if best is None or slen < best_len:
                        best, best_len = si, slen
            if best is not None:
                span_faults[best].append(f)
                covered_flags[fi] = True
        dicts = [
            span_to_dict(s, origin, faults=span_faults[i])
            for i, s in enumerate(spans)
        ]
        # Parent = the smallest strictly-enclosing span: the flat list
        # reads back as a tree (scheduler.process contains
        # matrix.build / device.dispatch / plan.submit, which contains
        # plan.evaluate / plan.commit / fsm.alloc_upsert).
        for i, s in enumerate(spans):
            parent = None
            parent_len = None
            for j, p in enumerate(spans):
                if j == i:
                    continue
                if p[1] <= s[1] and s[2] <= p[2]:
                    plen = p[2] - p[1]
                    if (parent is None or plen < parent_len
                            or (plen == parent_len and j < i)):
                        parent, parent_len = j, plen
            dicts[i]["parent"] = (spans[parent][0]
                                  if parent is not None else None)
        uncovered = [f for fi, f in enumerate(faults)
                     if not covered_flags[fi]]
        out = {
            "eval_id": entry.eval_id,
            "trace_id": entry.trace_id,
            "status": status,
            "start_unix": round(entry.wall_start, 6),
            "duration_ms": round((end - origin) * 1000.0, 3),
            "spans": dicts,
            "dropped_spans": entry.dropped_spans,
        }
        if uncovered:
            out["unattributed_faults"] = [
                {"site": site, "ordinal": seq, "kind": kind}
                for (_t, site, seq, kind) in uncovered
            ]
        return out

    # ------------------------------------------------------ read side

    def traces(self, limit: int = 50) -> List[dict]:
        """Most recent completed traces, newest first."""
        out: List[dict] = []
        for stripe in self._stripes:
            with stripe.lock:
                n = min(stripe.ring_idx, RING_PER_STRIPE)
                for k in range(n):
                    slot = stripe.ring[(stripe.ring_idx - 1 - k)
                                       % RING_PER_STRIPE]
                    if slot is not None:
                        out.append(slot)
        out.sort(key=lambda t: t["start_unix"] + t["duration_ms"] / 1000.0,
                 reverse=True)
        return out[:max(0, limit)]

    def trace_for(self, eval_id: str) -> Optional[dict]:
        """The completed trace for one eval, if still in a ring."""
        stripe = self._stripe_for(eval_id)
        with stripe.lock:
            for slot in stripe.ring:
                if slot is not None and slot["eval_id"] == eval_id:
                    return slot
        return None

    def tail_traces(self) -> List[dict]:
        """Traces kept for landing past the rolling e2e p99, newest
        first."""
        with self._tail_lock:
            n = min(self._tail_idx, TAIL_KEEP)
            return [self._tail[(self._tail_idx - 1 - k) % TAIL_KEEP]
                    for k in range(n)]

    def e2e_p99(self) -> float:
        """Rolling end-to-end p99 in ms (0.0 before any completions).
        Cheap single-histogram read for the pressure monitor
        (admission/, not ported yet) — stage_stats() walks every stage."""
        with self._hist_lock:
            if not self._e2e.count:
                return 0.0
            return hist_percentile(
                self._e2e.buckets, self._e2e.count, 0.99)

    def stage_buckets(self, stage: str):
        """(count, bucket-list copy) of one stage's lifetime histogram,
        or None before any sample. The rolling-window consumers
        (kernels/quality.py's per-interval queueing gauge) snapshot
        this at window reset and percentile over the bucket DELTA —
        lifetime exposition stays monotonic for Prometheus while the
        window reads only what landed since the reset."""
        with self._hist_lock:
            h = self._hists.get(stage)
            if h is None or not h.count:
                return None
            return h.count, list(h.buckets)

    def stage_stats(self) -> Dict[str, dict]:
        """Per-stage latency table: count/mean/max and log-bucket
        p50/p95/p99, all in milliseconds."""
        with self._hist_lock:
            items = [(name, h.count, h.total, h.max, list(h.buckets))
                     for name, h in self._hists.items()]
            items.append(("e2e", self._e2e.count, self._e2e.total,
                          self._e2e.max, list(self._e2e.buckets)))
        out: Dict[str, dict] = {}
        for name, count, total, mx, buckets in items:
            if not count:
                continue
            out[name] = {
                "count": count,
                "mean_ms": round(total / count, 3),
                "max_ms": round(mx, 3),
                "p50_ms": round(hist_percentile(buckets, count, 0.50), 3),
                "p95_ms": round(hist_percentile(buckets, count, 0.95), 3),
                "p99_ms": round(hist_percentile(buckets, count, 0.99), 3),
            }
        return out

    def stats(self) -> dict:
        active = evicted = dropped = 0
        for stripe in self._stripes:
            with stripe.lock:
                active += len(stripe.active)
                evicted += stripe.evicted
                dropped += stripe.dropped_spans
        with self._tail_lock:
            completed = self._completed
            tail_kept = min(self._tail_idx, TAIL_KEEP)
        return {
            "enabled": self.enabled,
            "active": active,
            "completed": completed,
            "evicted_active": evicted,
            "dropped_spans": dropped,
            "tail_kept": tail_kept,
            "ring_capacity": N_STRIPES * RING_PER_STRIPE,
        }

    # -------------------------------------------------------- control

    def set_enabled(self, enabled: bool) -> None:
        self.enabled = bool(enabled)

    def reset(self) -> None:
        """Drop all stored traces and histograms (A/B arms and
        test isolation; not part of the record path)."""
        for stripe in self._stripes:
            with stripe.lock:
                stripe.active.clear()
                stripe.ring = [None] * RING_PER_STRIPE
                stripe.ring_idx = 0
                stripe.evicted = 0
                stripe.dropped_spans = 0
        with self._hist_lock:
            self._hists = {}
            self._e2e = _Hist()
        with self._tail_lock:
            self._tail = [None] * TAIL_KEEP
            self._tail_idx = 0
            self._completed = 0
