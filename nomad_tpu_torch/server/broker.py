"""EvalBroker: leader-only, in-memory, at-least-once evaluation queue.

Reference: nomad/eval_broker.go:43 — per-scheduler-type priority heaps,
per-job serialization (a job is claimed at enqueue time; later evals
wait in a per-job blocked heap until the outstanding one is Acked),
unack tracking with Nack timers, a delivery limit routing poison evals
to the `_failed` queue, and wait-time evals.

Overload protection (admission/) extends the reference: ready
queues are optionally BOUNDED (per-scheduler-type depth caps) with
priority-aware shedding — lowest priority, newest first, stamped with a
structured `EVAL_TRIGGER_SHED` outcome exactly once and parked on the
failed queue for the reaper, never silently dropped — and evals carry a
creation-stamped deadline the dequeue path enforces, so stale work is
parked (`EVAL_TRIGGER_EXPIRED`) instead of burning a scheduler.
"""

from __future__ import annotations

import heapq
import itertools
import time
from typing import Dict, List, Optional, Tuple

from ..profile import ProfiledCondition, ProfiledRLock
from ..structs import Evaluation, consts
from ..utils import metrics
from ..utils.ids import generate_uuid
from ..utils.timer import default_wheel
from .. import trace

FAILED_QUEUE = "_failed"

# Triggers that mark an eval already parked for terminal processing on
# the failed queue: a copy carrying one of these is never re-stamped,
# re-counted, or dead-lettered again (shed/expired evals must reach
# exactly ONE structured terminal outcome).
_TERMINAL_PARK_TRIGGERS = (
    consts.EVAL_TRIGGER_DEAD_LETTER,
    consts.EVAL_TRIGGER_SHED,
    consts.EVAL_TRIGGER_EXPIRED,
)

# The failed-queue park is the broker's exactly-once terminal funnel. A shed/expired/
# dead-letter stamp is only legal on a copy that flows into it — the
# park feeds the leader reaper, which persists the terminal status
# through the log (server.py _reap_failed_evals -> eval_update). The
# _TERMINAL_PARK_TRIGGERS guard above is the dynamic half of the same
# exactly-once contract.
NTA_RAFT_FUNNELS = ("EvalBroker._park_failed_locked",)


class _Heap:
    """Max-priority, FIFO-within-priority eval heap."""

    def __init__(self):
        self._items: List[Tuple[int, int, Evaluation]] = []
        self._counter = itertools.count()

    def push(self, ev: Evaluation) -> None:
        heapq.heappush(self._items, (-ev.priority, next(self._counter), ev))

    def pop(self) -> Optional[Evaluation]:
        if not self._items:
            return None
        return heapq.heappop(self._items)[2]

    def peek_priority(self) -> Optional[int]:
        if not self._items:
            return None
        return -self._items[0][0]

    def worst_priority(self) -> Optional[int]:
        """Priority of the shed victim: the LOWEST priority resident
        (O(n) scan; only runs when a bounded queue is at capacity)."""
        if not self._items:
            return None
        return -max(item[0] for item in self._items)

    def pop_worst(self) -> Optional[Evaluation]:
        """Remove and return the shed victim: lowest priority, newest
        first (max insertion counter among the lowest priority)."""
        if not self._items:
            return None
        idx = max(range(len(self._items)),
                  key=lambda i: (self._items[i][0], self._items[i][1]))
        victim = self._items[idx][2]
        last = self._items.pop()
        if idx < len(self._items):
            self._items[idx] = last
            heapq.heapify(self._items)
        return victim

    def __len__(self):
        return len(self._items)

    def evals(self) -> List[Evaluation]:
        return [item[2] for item in self._items]


class _Unack:
    __slots__ = ("eval", "token", "timer", "nack_timer_paused")

    def __init__(self, ev: Evaluation, token: str, timer):
        self.eval = ev
        self.token = token
        self.timer = timer
        self.nack_timer_paused = False


class EvalBroker:
    def __init__(self, nack_timeout: float = 60.0, delivery_limit: int = 3,
                 ready_cap: int = 0,
                 ready_caps: Optional[Dict[str, int]] = None):
        self.nack_timeout = nack_timeout
        self.delivery_limit = delivery_limit
        # Bounded ready queues (nomad_tpu_torch/admission): per-scheduler-type
        # depth caps — `ready_caps` overrides per type, `ready_cap` is
        # the default for every other type; 0 = unbounded. The failed
        # queue is never capped (it holds the structured terminal parks
        # the caps produce — capping it would shed the shed records).
        self.ready_cap = max(0, ready_cap)
        self._ready_caps = {k: max(0, v)
                            for k, v in (ready_caps or {}).items()}

        # Profiled (nomad_tpu_torch/profile): every enqueue, dequeue, ack and
        # nack serializes here — under a drain storm this lock's
        # acquire-wait histogram is the broker's contention signature.
        self._lock = ProfiledRLock("server.broker")
        self._cond = ProfiledCondition(self._lock, "server.broker")
        self._enabled = False

        self._evals: Dict[str, int] = {}  # known eval id -> dequeue count
        self._ready: Dict[str, _Heap] = {}  # by scheduler type
        self._unack: Dict[str, _Unack] = {}
        self._job_evals: Dict[str, str] = {}  # job claim: job_id -> eval id
        self._blocked: Dict[str, _Heap] = {}  # per-job wait heaps
        self._wheel = default_wheel()  # shared timer thread (utils/timer.py)
        self._wait_timers: Dict[str, object] = {}
        # Evals the scheduler re-submitted (reblock) while outstanding;
        # processed on Ack (eval_broker.go:171-182 requeue).
        self._requeue: Dict[str, Evaluation] = {}
        # Evals routed to the failed queue on delivery-limit exhaustion
        # (dead-lettered); monotonic across flushes so server.stats()
        # reports lifetime poison-eval pressure.
        self.dead_lettered = 0  # guarded-by: _lock
        # Overload-protection counters, monotonic like dead_lettered:
        # evals shed from full bounded ready queues, and evals whose
        # deadline expired before a dequeuer reached them.
        self.shed = 0  # guarded-by: _lock
        self.expired = 0  # guarded-by: _lock

    # ------------------------------------------------------------------

    def enabled(self) -> bool:
        with self._lock:
            return self._enabled

    def set_enabled(self, enabled: bool) -> None:
        with self._lock:
            self._enabled = enabled
        if not enabled:
            self.flush()

    def flush(self) -> None:
        with self._lock:
            for unack in self._unack.values():
                unack.timer.cancel()
            for timer in self._wait_timers.values():
                timer.cancel()
            self._evals.clear()
            self._ready.clear()
            self._unack.clear()
            self._job_evals.clear()
            self._blocked.clear()
            self._wait_timers.clear()
            self._requeue.clear()
            self._cond.notify_all()

    # ------------------------------------------------------------------

    def enqueue(self, ev: Evaluation, token: str = "") -> None:
        with self._lock:
            self._process_enqueue(ev, token)

    def enqueue_all(self, evals: List[Evaluation]) -> None:
        # One critical section so unblocking dequeuers see the full,
        # highest-priority-first picture (eval_broker.go:155-163).
        with self._lock:
            for ev in evals:
                self._process_enqueue(ev, "")

    def _process_enqueue(self, ev: Evaluation, token: str) -> None:
        if ev.id in self._evals:
            if not token:
                return
            # Reblocked by its scheduler while outstanding: run again
            # after the Ack.
            unack = self._unack.get(ev.id)
            if unack is not None and unack.token == token:
                self._requeue[token] = ev
            return
        if self._enabled:
            self._evals[ev.id] = 0
        if ev.wait and ev.wait > 0:
            self._wait_timers[ev.id] = self._wheel.schedule(
                ev.wait, self._wait_done, ev)
            return
        self._enqueue_locked(ev, ev.type)

    def _wait_done(self, ev: Evaluation) -> None:
        with self._lock:
            self._wait_timers.pop(ev.id, None)
            self._enqueue_locked(ev, ev.type)

    def _enqueue_locked(self, ev: Evaluation, queue: str) -> None:
        if not self._enabled:
            return
        # Trace: stamp the enqueue instant (redeliveries re-stamp, so a
        # nacked eval's next broker.wait span measures ITS wait). The
        # recorder is a leaf lock and never blocks — safe under the
        # broker lock. The
        # failed queue is excluded: its trace was already completed as
        # 'dead-letter', and marking the dead copy would open a second
        # bogus trace that the reaper's dequeue+ack then publishes.
        if queue != FAILED_QUEUE:
            trace.mark(ev.id, ev.trace_id)
        # Per-job serialization: the job is claimed by the first eval;
        # later ones wait in the per-job blocked heap until Ack. The
        # blocked heaps ride the same bounded-queue discipline as the
        # ready queue they feed: without a cap, re-registering one job
        # at storm rate while its eval is outstanding grows the heap
        # without bound, invisibly to the ready cap AND the pressure
        # monitor — exactly the unbounded intake the caps close.
        claimed = self._job_evals.get(ev.job_id, "")
        if not claimed:
            self._job_evals[ev.job_id] = ev.id
        elif claimed != ev.id:
            blocked = self._blocked.setdefault(ev.job_id, _Heap())
            cap = self._ready_caps.get(queue, self.ready_cap)
            if cap and len(blocked) >= cap:
                worst = blocked.worst_priority()
                if worst is None or ev.priority <= worst:
                    self._shed_locked(ev, queue, cap, where="blocked")
                    return
                self._shed_locked(blocked.pop_worst(), queue, cap,
                                  where="blocked")
            blocked.push(ev)
            return
        heap = self._ready.setdefault(queue, _Heap())
        if queue != FAILED_QUEUE:
            cap = self._ready_caps.get(queue, self.ready_cap)
            if cap and len(heap) >= cap:
                # Priority-aware shed, never a silent drop: the victim
                # is the LOWEST-priority eval, newest first — and the
                # incoming eval is by definition the newest at its
                # priority, so it sheds itself whenever it does not
                # strictly outrank the worst resident.
                worst = heap.worst_priority()
                if worst is None or ev.priority <= worst:
                    self._shed_locked(ev, queue, cap)
                    return
                self._shed_locked(heap.pop_worst(), queue, cap)
        heap.push(ev)
        self._cond.notify_all()

    def _shed_locked(self, ev: Evaluation, queue: str, cap: int,
                     where: str = "ready") -> None:
        """Shed one eval from a full bounded ready (or per-job blocked)
        queue: complete its trace, stamp the structured outcome exactly
        ONCE, count it, and park the stamped copy on the failed queue —
        the leader reaper persists it as a terminal status exactly like
        a dead-letter. A ready-shed eval's job claim intentionally
        stays with the eval id; the reaper's ack releases it and
        promotes the job's blocked evals (the dead-letter protocol,
        server.py _reap_failed_evals). A blocked-shed eval never held
        the claim."""
        with self._lock:
            trace.complete(ev.id, "shed")
            shed = ev.copy()
            if shed.triggered_by not in _TERMINAL_PARK_TRIGGERS:
                shed.triggered_by = consts.EVAL_TRIGGER_SHED
                shed.status_description = (
                    f"shed: {where} queue {queue!r} at capacity ({cap}); "
                    f"lowest-priority ({ev.priority}) newest eval "
                    f"dropped under overload (originally triggered by "
                    f"{ev.triggered_by!r})")
                self.shed += 1
                metrics.incr_counter(("broker", "shed"))
            self._park_failed_locked(shed)

    def _expire_locked(self, ev: Evaluation, queue: str) -> None:
        """An eval whose creation-stamped deadline passed while queued:
        skipped at dequeue, parked on the failed queue with a
        structured reason (exactly once — see _TERMINAL_PARK_TRIGGERS),
        so stale work never reaches a scheduler or a device lane."""
        with self._lock:
            trace.complete(ev.id, "expired")
            dead = ev.copy()
            if dead.triggered_by not in _TERMINAL_PARK_TRIGGERS:
                dead.triggered_by = consts.EVAL_TRIGGER_EXPIRED
                dead.status_description = (
                    f"deadline expired before dispatch: deadline "
                    f"{ev.deadline:.3f} passed while queued on "
                    f"{queue!r} (originally triggered by "
                    f"{ev.triggered_by!r})")
                self.expired += 1
                metrics.incr_counter(("broker", "expired"))
            self._park_failed_locked(dead)

    def _park_failed_locked(self, ev: Evaluation) -> None:
        """Push a stamped terminal copy straight onto the failed queue.
        Deliberately NOT routed through ``_enqueue_locked``: its
        per-job claim check would divert a copy whose job is claimed
        by a DIFFERENT eval (a blocked-heap shed) into the blocked
        heap instead of the failed queue — a terminal park must always
        reach the reaper. The failed queue is never capped and its
        copies are never trace-marked (their trace was completed at
        the park site)."""
        if not self._enabled:
            return
        self._ready.setdefault(FAILED_QUEUE, _Heap()).push(ev)
        self._cond.notify_all()

    # ------------------------------------------------------------------

    def dequeue(
        self, schedulers: List[str], timeout: Optional[float] = None
    ) -> Tuple[Optional[Evaluation], str]:
        """Blocking dequeue of the highest-priority ready eval for any of
        the given scheduler types. Returns (eval, token) or (None, "")."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._lock:
            while True:
                if not self._enabled:
                    return None, ""
                ev = self._scan_for_schedulers(schedulers)
                if ev is not None:
                    out = self._dequeue_locked(ev)
                    break
                remaining = None
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return None, ""
                self._cond.wait(remaining if remaining is not None else 1.0)
        return out

    def dequeue_many(
        self, schedulers: List[str], max_n: int
    ) -> List[Tuple[Evaluation, str]]:
        """Non-blocking drain of up to max_n ready evals for the given
        scheduler types. Extension over the reference's single-dequeue
        (eval_broker.go:259) for the dispatch pipeline's central
        drain: per-job serialization still holds (a job's later evals
        stay in its blocked heap), so a drained batch is always over
        distinct jobs."""
        out: List[Tuple[Evaluation, str]] = []
        with self._lock:
            if not self._enabled:
                return out
            while len(out) < max_n:
                ev = self._scan_for_schedulers(schedulers)
                if ev is None:
                    break
                out.append(self._dequeue_locked(ev))
        return out

    def _scan_for_schedulers(self, schedulers: List[str]) -> Optional[Evaluation]:
        now = time.time()
        while True:
            best_queue = None
            best_priority = -1
            for sched in schedulers:
                heap = self._ready.get(sched)
                if heap is None:
                    continue
                prio = heap.peek_priority()
                if prio is not None and prio > best_priority:
                    best_priority = prio
                    best_queue = sched
            if best_queue is None:
                return None
            ev = self._ready[best_queue].pop()
            if ev is None:
                return None
            # Deadline enforcement at dequeue: an expired eval would
            # only burn a scheduler (or a device lane) producing a plan
            # the submitter no longer wants — park it structured and
            # keep scanning for live work. The failed queue is exempt:
            # its copies are terminal parks on their way to the reaper.
            if best_queue != FAILED_QUEUE and ev.expired(now):
                self._expire_locked(ev, best_queue)
                continue
            return ev

    def _dequeue_locked(self, ev: Evaluation) -> Tuple[Evaluation, str]:
        token = generate_uuid()
        deliveries = self._evals.get(ev.id, 0) + 1
        self._evals[ev.id] = deliveries
        timer = self._wheel.schedule(
            self.nack_timeout, self._nack_timeout, ev.id, token)
        self._unack[ev.id] = _Unack(ev, token, timer)
        trace.record_since_mark(
            ev.id, trace.STAGE_BROKER_WAIT,
            {"deliveries": deliveries, "type": ev.type})
        return ev, token

    def _nack_timeout(self, eval_id: str, token: str) -> None:
        """Nack timer fired: the worker died or stalled; redeliver."""
        try:
            self.nack(eval_id, token)
        except ValueError:
            pass  # already acked/nacked

    # ------------------------------------------------------------------

    def _check_token(self, eval_id: str, token: str) -> _Unack:
        unack = self._unack.get(eval_id)
        if unack is None or unack.token != token:
            raise ValueError(f"token does not match for eval {eval_id!r}")
        return unack

    def outstanding(self, eval_id: str) -> Optional[str]:
        with self._lock:
            unack = self._unack.get(eval_id)
            return unack.token if unack else None

    def ack(self, eval_id: str, token: str) -> None:
        with self._lock:
            unack = self._check_token(eval_id, token)
            unack.timer.cancel()
            del self._unack[eval_id]
            self._evals.pop(eval_id, None)
            job_id = unack.eval.job_id
            if self._job_evals.get(job_id) == eval_id:
                del self._job_evals[job_id]
            # Promote the next blocked eval for this job.
            blocked = self._blocked.get(job_id)
            if blocked:
                nxt = blocked.pop()
                if not len(blocked):
                    del self._blocked[job_id]
                if nxt is not None:
                    self._enqueue_locked(nxt, nxt.type)
            # Ack is the lifecycle's last breath: the plan (if any)
            # already committed before the worker acked, so the span
            # tree is whole. Completed BEFORE the reblock re-enqueue:
            # _process_enqueue marks the requeued run's enqueue instant
            # on what must be a FRESH trace — completing afterwards
            # would pop that mark and split the requeued lifecycle.
            # (Leaf locks only; same pattern as the dead-letter path.)
            trace.complete(eval_id, "acked")
            # Process a reblock submitted while this eval was outstanding.
            requeued = self._requeue.pop(token, None)
            if requeued is not None:
                self._process_enqueue(requeued, "")

    def nack(self, eval_id: str, token: str) -> None:
        with self._lock:
            unack = self._check_token(eval_id, token)
            unack.timer.cancel()
            del self._unack[eval_id]
            self._requeue.pop(token, None)
            ev = unack.eval
            # The job claim stays with this eval; redeliver it, or
            # dead-letter it past the delivery limit: the failed-queue
            # copy carries a structured trigger + reason (instead of
            # silently capping), the leader reaper persists them when it
            # marks the eval failed, and the counter surfaces poison
            # evals in server.stats().
            deliveries = self._evals.get(ev.id, 0)
            if deliveries >= self.delivery_limit:
                # A dead-lettered eval never acks: close its trace here
                # (the nacked-but-redelivering case below keeps the
                # trace open — its next delivery keeps appending spans).
                trace.complete(ev.id, "dead-letter")
                dead = ev.copy()
                # Idempotent: a reaper whose eval_update failed (leader
                # flap) lets the nack timer re-park the ALREADY
                # dead-lettered copy — re-stamping would clobber the
                # original trigger and double-count the eval. Shed and
                # expired parks are covered by the same guard: a shed
                # eval must never ALSO dead-letter (one structured
                # terminal outcome, exactly once).
                if dead.triggered_by not in _TERMINAL_PARK_TRIGGERS:
                    dead.triggered_by = consts.EVAL_TRIGGER_DEAD_LETTER
                    dead.status_description = (
                        f"dead-lettered: delivery limit "
                        f"({self.delivery_limit}) exhausted after "
                        f"{deliveries} deliveries "
                        f"(originally triggered by {ev.triggered_by!r})")
                    self.dead_lettered += 1
                    metrics.incr_counter(("broker", "dead_lettered"))
                self._park_failed_locked(dead)
            else:
                self._enqueue_locked(ev, ev.type)

    def pause_nack_timeout(self, eval_id: str, token: str) -> None:
        """Stop the redelivery clock while the plan sits in the plan
        queue (plan_endpoint.go:16)."""
        with self._lock:
            unack = self._check_token(eval_id, token)
            unack.timer.cancel()
            unack.nack_timer_paused = True

    def resume_nack_timeout(self, eval_id: str, token: str) -> None:
        with self._lock:
            unack = self._check_token(eval_id, token)
            if unack.nack_timer_paused:
                unack.timer = self._wheel.schedule(
                    self.nack_timeout, self._nack_timeout, eval_id, token)
                unack.nack_timer_paused = False

    # ------------------------------------------------------------------

    def ready_count(self) -> int:
        with self._lock:
            return sum(
                len(h) for q, h in self._ready.items() if q != FAILED_QUEUE
            )

    def unacked_count(self) -> int:
        with self._lock:
            return len(self._unack)

    def blocked_count(self) -> int:
        with self._lock:
            return sum(len(h) for h in self._blocked.values())

    def waiting_count(self) -> int:
        with self._lock:
            return len(self._wait_timers)

    def failed_evals(self) -> List[Evaluation]:
        """Evals past the delivery limit (reaped by the leader,
        leader.go:369)."""
        with self._lock:
            heap = self._ready.get(FAILED_QUEUE)
            return heap.evals() if heap else []

    def ready_by_queue(self) -> Dict[str, int]:
        """Per-scheduler-type ready depths (failed queue excluded) —
        the pressure monitor measures each CAPPED queue against its
        own budget; lumping uncapped queues into one total would read
        a deliberately-unbounded queue's backlog as cap pressure."""
        with self._lock:
            return {q: len(h) for q, h in self._ready.items()
                    if q != FAILED_QUEUE}

    def stats(self) -> Dict[str, object]:
        with self._lock:
            dead = self.dead_lettered
            shed = self.shed
            expired = self.expired
        return {
            "ready_by_queue": self.ready_by_queue(),
            "total_ready": self.ready_count(),
            "total_unacked": self.unacked_count(),
            "total_blocked": self.blocked_count(),
            "total_waiting": self.waiting_count(),
            "dead_lettered": dead,
            "shed": shed,
            "expired": expired,
        }
