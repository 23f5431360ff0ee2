"""Parked-watcher long-poll multiplexer: blocking queries without
parked HTTP threads.

The thread-parking blocking query (api/http.py `_blocking`) holds one
HTTP handler thread per watcher for up to MAX_BLOCKING_WAIT — N
watchers cost N OS threads, and before scoped indexes every commit
woke all of them. The mux applies the executive's event-loop
discipline to the read side:

- A blocking query whose scope has not yet passed ``?index=N``
  registers a **continuation** — scope set, min index, deadline, and a
  serialized-response thunk that re-runs the query and writes the raw
  HTTP response straight to the (detached) client socket — in
  lock-striped parked rings keyed by watch scope. The handler thread
  then exits; the socket stays open, owned by the continuation.
- One **wake-owner thread** (`_wake_loop`, registered in
  ``NTA_DISPATCHER_ENTRYPOINTS`` — it is a never-blocking clock like
  the executive drain) drains scope notifications fed by the store's
  NotifyGroup sink, re-checks each candidate's scope index, and hands
  satisfied or expired continuations to a small bounded WorkPool that
  re-runs the query and streams the response.
- Parked continuations live in the MUX, not in the store's
  NotifyGroup, so an FSM snapshot-restore store swap never strands a
  watcher: the wake loop re-subscribes to the new store's notify feed
  on its next tick (detected via ``store_id``) and scope checks always
  read the current store.

Counters (parked/wakes/spurious/served/timeouts/write_errors) surface
as ``readplane.*`` gauges in /v1/metrics, and park→wake / serve
durations land in the flight recorder's stage table as ``read.park`` /
``read.serve``.

The port of the JAX package's readplane/mux.py, on the port's profiled
locks, flight recorder, metrics registry and work pool.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Dict, List, Optional, Set, Tuple

from ..profile import ProfiledCondition, ProfiledLock
from ..trace import get_recorder
from ..utils import metrics
from ..utils.pool import WorkPool

logger = logging.getLogger("nomad_tpu_torch.readplane")

Item = Tuple[str, str]

N_STRIPES = 8
# Wake-loop tick ceiling: the loop re-checks deadlines and store swaps
# at least this often even with no notifications in flight.
WAKE_SLICE = 0.25

# ntalint lock-discipline manifest (analysis/locks.py): the wake owner
# is the read plane's clock — everything reachable from it must never
# block (bounded cond-waits on the mux's own lock are the sanctioned
# scheduling primitive). Query RE-RUNS deliberately happen off-loop on
# the serve pool; the pool handoff is submit-only and never parks.
NTA_DISPATCHER_ENTRYPOINTS = ("ReadMux._wake_loop",)


class ParkedQuery:
    """One parked blocking query's continuation."""

    __slots__ = ("scopes", "min_index", "deadline", "serve", "parked_at",
                 "claimed", "seq")

    def __init__(self, scopes: List[Item], min_index: int, deadline: float,
                 serve: Callable[[str], None], seq: int = 0):
        self.scopes = list(scopes)
        self.min_index = min_index
        self.deadline = deadline
        self.serve = serve
        self.parked_at = time.monotonic()
        self.claimed = False  # guarded-by: primary stripe lock
        # Notify-batch sequence at registration: batches numbered below
        # this predate the park and are never weighed against it (the
        # park-time recheck covers that window), so a backlog of
        # pre-park notifications can't masquerade as spurious wakes.
        self.seq = seq


class _Stripe:
    __slots__ = ("lock", "by_scope")

    def __init__(self):
        self.lock = ProfiledLock("readplane.mux.stripe")
        # scope item -> set of parked continuations watching it
        self.by_scope: Dict[Item, Set[ParkedQuery]] = {}


class ReadMux:
    """Owns the parked rings, the wake-owner thread, and the bounded
    serve pool. ``store`` is a zero-arg callable returning the current
    StateStore (the FSM swaps stores on snapshot restore)."""

    def __init__(self, store: Callable[[], object], workers: int = 4,
                 max_parked: int = 4096):
        self._store = store
        self.max_parked = max_parked
        self._stripes = [_Stripe() for _ in range(N_STRIPES)]
        self._pool = WorkPool(max(1, workers), name="read-serve")
        self._lock = ProfiledLock("readplane.mux")
        self._cond = ProfiledCondition(self._lock)
        # (seq, items) notify batches awaiting the wake owner, plus the
        # next batch number; guarded-by: _lock
        self._pending: List[Tuple[int, List[Item]]] = []
        self._seq = 0
        self._next_deadline: Optional[float] = None  # guarded-by: _lock
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._subscribed_id = ""
        # counters, guarded-by: _lock
        self._parked = 0
        self._parked_total = 0
        self._wakes = 0
        self._spurious = 0
        self._served = 0
        self._timeouts = 0
        self._write_errors = 0

    # ------------------------------------------------------- lifecycle

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._wake_loop, name="read-mux", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        with self._cond:
            self._cond.notify()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
        self._thread = None
        # Flush every still-parked continuation so no client socket is
        # left dangling across a shutdown: serve current data inline.
        for rec in self._drain_all():
            self._run_serve(rec, "shutdown")
        self._pool.close()

    # ------------------------------------------------------- park side

    def park(self, scopes: List[Item], min_index: int, deadline: float,
             serve: Callable[[str], None]) -> bool:
        """Register a continuation. Returns False (caller must fall
        back to thread-parking) when the mux is stopped or full."""
        if self._thread is None:
            return False
        with self._cond:
            if self._parked >= self.max_parked:
                return False
            self._parked += 1
            self._parked_total += 1
            seq = self._seq
        rec = ParkedQuery(scopes, min_index, deadline, serve, seq)
        for scope in set(rec.scopes):
            stripe = self._stripe(scope)
            with stripe.lock:
                stripe.by_scope.setdefault(scope, set()).add(rec)
        with self._cond:
            if (self._next_deadline is None
                    or deadline < self._next_deadline):
                self._next_deadline = deadline
            self._cond.notify()
        # Close the check-then-park race: a commit that landed between
        # the caller's index check and the registration above fired its
        # notify before this continuation was findable.
        store = self._store()
        if store is not None and store.scope_index(rec.scopes) > min_index:
            if self._claim(rec):
                self._retire(rec)
                self._submit_serve(rec, "wake")
        return True

    def _stripe(self, scope: Item) -> _Stripe:
        return self._stripes[hash(scope) % N_STRIPES]

    def _claim(self, rec: ParkedQuery) -> bool:
        stripe = self._stripe(rec.scopes[0])
        with stripe.lock:
            if rec.claimed:
                return False
            rec.claimed = True
            return True

    def _retire(self, rec: ParkedQuery) -> None:
        """Remove a CLAIMED continuation from every scope ring and drop
        the parked count."""
        for scope in set(rec.scopes):
            stripe = self._stripe(scope)
            with stripe.lock:
                group = stripe.by_scope.get(scope)
                if group is not None:
                    group.discard(rec)
                    if not group:
                        del stripe.by_scope[scope]
        with self._cond:
            self._parked -= 1

    def _drain_all(self) -> List[ParkedQuery]:
        out = []
        for stripe in self._stripes:
            with stripe.lock:
                recs = set()
                for group in stripe.by_scope.values():
                    recs |= group
            for rec in recs:
                if self._claim(rec):
                    self._retire(rec)
                    out.append(rec)
        return out

    # ------------------------------------------------------- wake side

    def on_notify(self, items: List[Item]) -> None:
        """NotifyGroup sink: runs on the committing (FSM) thread, so it
        only queues and signals — the scope checks happen on the wake
        owner."""
        with self._cond:
            self._pending.append((self._seq, items))
            self._seq += 1
            self._cond.notify()

    def _wake_loop(self) -> None:
        while not self._stop.is_set():
            store = self._resubscribe_if_swapped()
            now = time.monotonic()
            with self._cond:
                timeout = WAKE_SLICE
                if self._next_deadline is not None:
                    timeout = min(timeout,
                                  max(self._next_deadline - now, 0.0))
                if not self._pending and timeout > 0:
                    self._cond.wait(timeout)
                batch = self._pending
                self._pending = []
                parked = self._parked
            metrics.set_gauge(("readplane", "parked"), parked)
            if store is None:
                continue
            woken: Dict[Item, int] = {}
            for seq, items in batch:
                for it in items:
                    if seq > woken.get(it, -1):
                        woken[it] = seq
            for scope, seq in woken.items():
                stripe = self._stripe(scope)
                with stripe.lock:
                    candidates = list(stripe.by_scope.get(scope, ()))
                for rec in candidates:
                    if seq < rec.seq:
                        # Every batch here predates this park: old news,
                        # not a wake signal for it (any index movement
                        # in that window was caught by park()'s
                        # post-registration recheck).
                        continue
                    self._note_wake()
                    if store.scope_index(rec.scopes) > rec.min_index:
                        if self._claim(rec):
                            self._retire(rec)
                            self._submit_serve(rec, "wake")
                    else:
                        with self._cond:
                            self._spurious += 1
                        metrics.incr_counter(("readplane", "spurious"))
            self._expire(time.monotonic())

    def _note_wake(self) -> None:
        with self._cond:
            self._wakes += 1

    def _resubscribe_if_swapped(self):
        store = self._store()
        if store is None:
            return None
        sid = getattr(store, "store_id", "")
        if sid and sid != self._subscribed_id:
            store.notify.subscribe(self.on_notify)
            self._subscribed_id = sid
        return store

    def _expire(self, now: float) -> None:
        with self._cond:
            nxt = self._next_deadline
        if nxt is None or now < nxt:
            return
        expired: List[ParkedQuery] = []
        soonest: Optional[float] = None
        for stripe in self._stripes:
            with stripe.lock:
                recs = set()
                for group in stripe.by_scope.values():
                    recs |= group
            for rec in recs:
                if rec.deadline <= now:
                    if self._claim(rec):
                        self._retire(rec)
                        expired.append(rec)
                elif soonest is None or rec.deadline < soonest:
                    soonest = rec.deadline
        with self._cond:
            self._next_deadline = soonest
        for rec in expired:
            with self._cond:
                self._timeouts += 1
            metrics.incr_counter(("readplane", "timeouts"))
            self._submit_serve(rec, "timeout")

    # ------------------------------------------------------ serve side

    def _submit_serve(self, rec: ParkedQuery, reason: str) -> None:
        get_recorder().observe_stage(
            "read.park", (time.monotonic() - rec.parked_at) * 1000.0)
        self._pool.submit(self._run_serve, rec, reason)

    def _run_serve(self, rec: ParkedQuery, reason: str) -> None:
        t0 = time.monotonic()
        try:
            rec.serve(reason)
            with self._cond:
                self._served += 1
            metrics.incr_counter(("readplane", "served"))
        except Exception:  # noqa: BLE001
            # The thunk writes to a client socket the client may have
            # abandoned mid-park — a write failure is the client's
            # hangup, not a server fault. Count it and move on.
            with self._cond:
                self._write_errors += 1
            metrics.incr_counter(("readplane", "write_errors"))
            logger.debug("parked-query serve failed", exc_info=True)
        finally:
            get_recorder().observe_stage(
                "read.serve", (time.monotonic() - t0) * 1000.0)

    # ---------------------------------------------------- observation

    def stats(self) -> dict:
        with self._cond:
            out = {
                "parked": self._parked,
                "parked_total": self._parked_total,
                "wakes": self._wakes,
                "spurious": self._spurious,
                "served": self._served,
                "timeouts": self._timeouts,
                "write_errors": self._write_errors,
            }
        out["serve_workers"] = self._pool.worker_count()
        out["serve_queued"] = self._pool.queued()
        return out
