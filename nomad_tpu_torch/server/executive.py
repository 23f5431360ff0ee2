"""Scheduler executive: the batched event-loop replacement for the
thread-per-eval dense worker model.

The executive inverts the worker's identity: an evaluation is a
**batch row, not a thread**.

- One drain-owner thread (`_run`) is seeded by worker handoff exactly
  like the dispatch pipeline, then tops the cohort up with bulk
  `eval_dequeue_many` drains — the broker's ready queue is emptied in
  one critical section per pass, not one dequeue per thread.
- The whole cohort reconciles host-side **as arrays**
  (scheduler/util.py `cohort_reconcile`): one pass over a stacked
  existing-allocs table classifies every member; evals whose diff has
  semantics beyond pure placement (stops, updates, migrations and
  their budget claims, preemption, batch-job history, sticky disks,
  gangs, defrag moves) route to the untouched per-eval scheduler on a
  small legacy lane — those code paths stay the single source of truth.
- Fast members build their matrices/asks fanned over a small
  (`executive_threads`) pool, and the complete batch goes to the device
  through the batcher's no-park cohort dispatch
  (`PlacementBatcher.place_cohort`): one inline `_run_batch` on the
  loop thread, zero events, zero parked threads.
- Results fan back out through per-eval plan-submit + ack on the same
  pool. Plan conflicts go to the per-eval scheduler on the refreshed
  snapshot (the committed allocs re-diff as existing state, so only the
  rejected remainder replans).

The Worker pool stays: behind ``scheduler_executive = false``, and
always as the host-path / system-scheduler engine. Broker backpressure
(`saturated()`), the storm-quiesce `set_pause()`/`parked()` contract,
deadline enforcement and the trace record points move with the drain.

The port of the JAX package's server/executive.py. What it leaves out:

- the circuit breaker and the host fallback. A cohort smaller than
  ``dense_min_batch`` still routes to the host factories (latency-aware
  routing, ``routed_host``), but a device fault in the cohort dispatch
  nacks every fast row of the cohort (counted in ``device_faults``,
  logged as a warning) and the broker redelivers them; no host factory
  ever places them because of the fault;
- the fault-injection sites (``dispatch.launch``, ``dispatch.submit``,
  ``dispatch.finish``, ``admission.slow_consumer``), and with them the
  reference's ExecutiveSession: the port's plain EvalSession serves;
- the stats ``host_fallbacks`` and ``finish_dropped``, which only those
  left-out paths counted.
"""

from __future__ import annotations

import logging
import os
import random
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from .. import profile, trace
from ..profile import ProfiledCondition, ProfiledLock
from ..scheduler import new_scheduler
from ..structs import AllocMetric, Evaluation, consts
from ..utils import metrics
from ..utils.backoff import poll_until
from ..utils.pool import WorkPool
from .worker import (
    EvalSession,
    factory_kernel,
    host_factory,
    is_dense_factory,
)

DEQUEUE_TOPUP_SLICE = 0.002  # cond-wait granularity while accumulating
SEED_WAIT_SLICE = 0.25  # cond-wait granularity while idle
WAIT_INDEX_TIMEOUT = 5.0

# Lock-discipline manifest (data): the drain owns the executive's
# clock — everything reachable from it runs on the event-loop thread
# between cohorts and must never block (bounded cond-waits on the
# executive's own lock are the sanctioned scheduling primitive). Cohort
# PROCESSING deliberately blocks (snapshotting, device sync, plan
# submits) — that work is the loop's payload, not its clock, and it is
# not reachable from this entrypoint.
NTA_DISPATCHER_ENTRYPOINTS = ("SchedulerExecutive._drain",)

# Record-path manifest (data): the drain's stats stamp runs on the
# event-loop thread between bulk broker drains; its closure must never
# park (leaf `with lock:` around constant work only) and never grow a
# container.
NTA_RECORD_PATH = ("SchedulerExecutive._note_drain",)


class _Entry:
    __slots__ = ("eval", "token", "enqueued_at")

    def __init__(self, ev: Evaluation, token: str):
        self.eval = ev
        self.token = token
        self.enqueued_at = time.monotonic()


class _Row:
    """One fast-path cohort member's in-flight state: the batch row."""

    __slots__ = ("entry", "member", "plan", "matrix", "tg_indices",
                 "bulk", "config", "asks", "key", "rng", "elig",
                 "failed", "queued", "choices", "scores", "ctx", "stack",
                 "t_start")

    def __init__(self, entry, member):
        self.entry = entry
        self.member = member
        self.failed: Dict[str, AllocMetric] = {}
        self.queued = dict(member.queued)
        self.ctx = None
        self.stack = None
        self.t_start = time.monotonic()


class SchedulerExecutive:
    def __init__(self, server):
        self.server = server
        cfg = server.config
        self.logger = logging.getLogger("nomad_tpu_torch.executive")
        self.max_batch = max(1, cfg.eval_batch_size)
        self.threads = max(1, cfg.executive_threads)
        self.window = cfg.dispatch_window
        self.idle_grace = cfg.dispatch_idle_grace

        self.types: List[str] = [
            t for t in cfg.enabled_schedulers
            if is_dense_factory(cfg.factory_for(t))
        ]
        self.enabled = bool(
            cfg.scheduler_executive and self.types and cfg.eval_batch_size > 1
        )

        # Profiled (nomad_tpu_torch/profile): the handoff/accumulator lock.
        self._lock = ProfiledLock("server.executive")
        self._cond = ProfiledCondition(self._lock, "server.executive")
        self._pending: List[_Entry] = []  # guarded-by: _lock
        self._notified_at = 0.0  # guarded-by: _lock
        self._drain_waiting = False  # guarded-by: _lock
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # Storm-quiesce contract (worker.py set_pause/parked): storms
        # park the drain to fill the broker, then release.
        self._paused = False  # guarded-by: _pause_lock
        self._pause_lock = threading.Lock()
        self._pause_cond = threading.Condition(self._pause_lock)
        self._parked = threading.Event()
        # Lock-free mirror of _paused for the drain's seed-wait bail
        # (an Event read takes no lock, so the seed wait never nests
        # _pause_lock inside the accumulator condition).
        self._pause_flag = threading.Event()
        # Host-side fan-out WITHIN a cohort: row builds, and plan
        # submits that wait on the plan queue — a handful of concurrent
        # submits keep the applier fed without re-creating the convoy.
        self._pool = WorkPool(self.threads, name="executive")

        # ---- stats ----
        self.evals_in = 0  # guarded-by: _lock (handoffs + bulk drains)
        self.cohorts = 0  # guarded-by: _lock (cohorts processed)
        self.cohort_evals = 0  # guarded-by: _lock (sum cohort sizes)
        self.largest_cohort = 0  # guarded-by: _lock
        self.fast_evals = 0  # guarded-by: _lock (array-path end to end)
        self.legacy_evals = 0  # guarded-by: _lock (per-eval scheduler)
        self.legacy_reasons: Dict[str, int] = {}  # guarded-by: _lock
        self.routed_host = 0  # guarded-by: _lock (sub-min cohorts)
        self.device_faults = 0  # guarded-by: _lock (rows nacked on a fault)
        self.plan_conflicts = 0  # guarded-by: _lock (refresh-index'd)
        self.expired_dropped = 0  # guarded-by: _lock
        self.acked = 0  # guarded-by: _lock
        self.nacked = 0  # guarded-by: _lock
        self.drained = 0  # guarded-by: _lock (leadership-loss requeues)
        self.t_drain = 0.0  # guarded-by: _lock (eval wait in accumulator)
        self.t_build = 0.0  # guarded-by: _lock (matrix/ask builds)
        self.t_dispatch = 0.0  # guarded-by: _lock (cohort device calls)
        self.t_finalize = 0.0  # guarded-by: _lock (submit/status/ack)

    # ------------------------------------------------------- lifecycle

    def start(self) -> None:
        if not self.enabled or self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="scheduler-executive", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        with self._cond:
            self._cond.notify_all()
        self.set_pause(False)
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        self.drain()
        self._pool.close()

    def drain(self) -> int:
        """Leadership loss (or shutdown): hand every accumulated eval's
        lease back to the broker (the dispatch pipeline's drain
        contract)."""
        with self._cond:
            pending, self._pending = self._pending, []
            self._cond.notify_all()
        for entry in pending:
            self._finish(entry, acked=False)
        if pending:
            with self._lock:
                self.drained += len(pending)
            self.logger.info(
                "drained %d accumulated evals back to the broker",
                len(pending))
        return len(pending)

    # ---------------------------------------------------- pause/parked

    def set_pause(self, paused: bool) -> None:
        """The worker-pool quiesce contract (worker.py): storms park
        the drain so the broker fills, then release it into a deep
        ready queue — the regime the cohort drain exists for."""
        with self._pause_lock:
            self._paused = paused
            if paused:
                self._pause_flag.set()
            else:
                self._pause_flag.clear()
            self._pause_cond.notify_all()
        with self._cond:
            self._cond.notify_all()

    def parked(self) -> bool:
        """True while the run loop waits inside the paused state — the
        drain is provably not mid-cohort and not holding broker
        leases (worker.py parked()). A disabled/never-started
        executive has no drain to park: trivially True, so quiesce
        helpers can pause workers+executive uniformly in both arms."""
        if not self.enabled or self._thread is None:
            return True
        return self._parked.is_set()

    def _check_paused(self) -> None:
        with self._pause_lock:
            if not (self._paused and not self._stop.is_set()):
                return
            self._parked.set()
            try:
                while self._paused and not self._stop.is_set():
                    self._pause_cond.wait(0.5)
            finally:
                self._parked.clear()

    # ------------------------------------------------------ admission

    def submit(self, ev: Evaluation, token: str) -> None:
        """Worker handoff: a worker that dequeued a dense-factory eval
        seeds the executive's cohort instead of processing it."""
        entry = _Entry(ev, token)
        with self._cond:
            self._pending.append(entry)
            self.evals_in += 1
            if self._drain_waiting and not self._notified_at:
                self._notified_at = time.monotonic()
            self._cond.notify_all()

    def pending_count(self) -> int:
        with self._lock:
            return len(self._pending)

    def saturated(self) -> bool:
        """Intake backpressure for the worker handoff: evals held here
        are invisible to the bounded broker queues, so an unbounded
        accumulation would reopen the intake the depth caps close."""
        with self._lock:
            return len(self._pending) >= 2 * self.max_batch

    # ------------------------------------------------------ event loop

    def _run(self) -> None:
        outstanding: List[object] = []
        while not self._stop.is_set():
            self._check_paused()
            # Prune settled finalize tails: the list is ONLY the
            # drain-window signal (work in flight -> accumulate the
            # full window to amortize it; idle -> the short grace).
            # The loop never blocks on these futures: the drain owns
            # the executive's clock, and one finalize wedged on a plan
            # timeout must not stall cohort cuts. Unbounded pile-up is
            # closed elsewhere: worker handoff naps on saturated(), and
            # the broker's bounded queues own the rest.
            outstanding = [f for f in outstanding if not f.done()]
            batch = []
            try:
                batch = self._drain(window=(
                    self.window if outstanding else self.idle_grace))
                if not batch:
                    continue
                outstanding.extend(self._process_cohort(batch))
            except Exception:
                # The drain thread is a singleton and the worker
                # handoff backpressures on saturated(): an escaped
                # exception here must never kill the loop, or every
                # worker eventually naps forever against a dead
                # executive. Nack whatever we held — the nack timer
                # reclaims anything mid-flight — and keep draining; the
                # pause slows a tight error loop.
                self.logger.exception(
                    "cohort processing failed; nacking %d evals and "
                    "continuing", len(batch))
                for entry in batch:
                    self._finish(entry, acked=False)
                self._stop.wait(0.05)

    def _drain(self, window: float) -> List[_Entry]:
        """Accumulate the next cohort: bounded seed wait, then bulk
        broker top-ups. This is the executive's never-blocking clock
        (NTA_DISPATCHER_ENTRYPOINTS)."""
        with self._cond:
            self._drain_waiting = True
            try:
                while (not self._pending and not self._stop.is_set()
                       and not self._pause_flag.is_set()):
                    self._cond.wait(SEED_WAIT_SLICE)
            finally:
                self._drain_waiting = False
            if not self._pending:
                self._notified_at = 0.0
                return []
            if self._notified_at:
                # Seed-wake run-queue delay: notify-while-parked ->
                # this thread actually running (the executive analog of
                # the pipeline's broker_drain stamp).
                profile.record_runq(
                    "broker_drain",
                    (time.monotonic() - self._notified_at) * 1000.0)
                self._notified_at = 0.0
            profile.event("accumulate_open", "executive",
                          a=len(self._pending))
        start = time.monotonic()
        # Empty-drain backoff: once a drain comes back empty, don't
        # re-issue it every 2ms slice for the rest of the window. A
        # handoff notify (new lease in hand) re-arms immediately; a
        # plain timeout re-arms at a 5x coarser cadence.
        next_drain = start
        # Dry-broker early cut: once a bulk drain comes back EMPTY with
        # a cohort in hand, holding that cohort for the rest of the
        # window buys nothing — there is no work left to pack. Under
        # churn the eval graph is a chain (drain eval -> migration
        # follow-up -> follow-up), so a full-window hold per hop
        # compounds; the pipeline's dispatch_idle_grace is the same
        # tradeoff, applied here mid-window. A handoff notify (fresh
        # lease in hand) re-opens the window.
        empty_since = 0.0
        while not self._stop.is_set():
            now = time.monotonic()
            with self._lock:
                room = self.max_batch - len(self._pending)
            if room > 0 and now >= next_drain:
                # The bulk drain: everything ready across the broker in
                # one visit — the cohort packs toward max_batch rows.
                got = self.server.eval_dequeue_many(self.types, room)
                if got:
                    now = time.monotonic()
                    empty_since = 0.0
                    with self._cond:
                        for ev, token in got:
                            entry = _Entry(ev, token)
                            entry.enqueued_at = now
                            self._pending.append(entry)
                            self.evals_in += 1
                else:
                    if not empty_since:
                        empty_since = now
                    next_drain = now + 5 * DEQUEUE_TOPUP_SLICE
            with self._cond:
                if len(self._pending) >= self.max_batch:
                    break
                now = time.monotonic()
                if now - start >= window:
                    break
                if (self._pending and empty_since
                        and now - empty_since >= self.idle_grace):
                    break
                if self._cond.wait(DEQUEUE_TOPUP_SLICE):
                    # Notified: a worker handed a fresh lease over —
                    # the broker plainly has work again.
                    next_drain = 0.0
                    empty_since = 0.0
        with self._cond:
            batch = self._pending[: self.max_batch]
            del self._pending[: len(batch)]
        if batch:
            self._note_drain(batch)
        return batch

    def _note_drain(self, batch: List[_Entry]) -> None:
        """Cohort-cut stats stamp (NTA_RECORD_PATH: leaf lock, constant
        work, no container growth)."""
        now = time.monotonic()
        with self._lock:
            self.cohorts += 1
            cohorts = self.cohorts
            self.cohort_evals += len(batch)
            if len(batch) > self.largest_cohort:
                self.largest_cohort = len(batch)
            for entry in batch:
                self.t_drain += now - entry.enqueued_at
        profile.event("accumulate_close", "executive",
                      a=len(batch), b=cohorts)

    # -------------------------------------------------------- cohorts

    def _process_cohort(self, batch: List[_Entry]) -> List[object]:
        """Run one cohort end to end on the loop thread; returns the
        finalize futures (submit/status/ack tails) still in flight."""
        t_launch = time.monotonic()
        cfg = self.server.config
        batch = self._drop_expired(batch, t_launch)
        if not batch:
            return []
        for entry in batch:
            trace.record_span(
                entry.eval.id, trace.STAGE_DISPATCH_ACCUMULATE,
                entry.enqueued_at, t_launch,
                ann={"batch": len(batch), "executive": True},
                trace_id=entry.eval.trace_id)
        # One MVCC snapshot for the whole cohort (same invariant as the
        # pipeline launch: shared base token, one device upload;
        # optimistic concurrency keeps it safe).
        max_index = max(max(e.eval.modify_index for e in batch),
                        self.server.snapshot_min_index())
        if not self._wait_for_index(max_index, WAIT_INDEX_TIMEOUT):
            for entry in batch:
                self._finish(entry, acked=False)
            return []
        snapshot = self.server.fsm.state.snapshot()

        if len(batch) < cfg.dense_min_batch:
            # Latency-aware routing: too few evals to amortize a device
            # dispatch — the host factories place them with identical
            # semantics.
            with self._lock:
                self.routed_host += len(batch)
            metrics.incr_counter(("executive", "route_host"), len(batch))
            return [self._pool.submit(
                self._process_legacy, entry, snapshot,
                host_factory(cfg.factory_for(entry.eval.type)))
                for entry in batch]

        # Cohort reconcile AS ARRAYS: one stacked-table pass classifies
        # every member (scheduler/util.py cohort_reconcile).
        from ..migrate import preemption_eligible
        from ..scheduler.util import cohort_reconcile

        members = cohort_reconcile(snapshot, [e.eval for e in batch])
        futs: List[object] = []
        fast: List[_Row] = []
        for entry, m in zip(batch, members):
            if m.fast and preemption_eligible(m.eval.priority):
                # The eviction leg belongs to the per-eval dense
                # scheduler (ops/preempt.py); rare by construction
                # (red pressure + outranking priority only).
                m.fast = False
                m.reason = "preemption-eligible"
            if not m.fast:
                self._note_legacy(m.reason)
                futs.append(self._pool.submit(
                    self._process_legacy, entry, snapshot, None))
            else:
                fast.append(_Row(entry, m))
        if not fast:
            return futs

        # ---- build: matrices + asks for every fast row, fanned over
        # the small executive pool; the cohort cut (and the single
        # dispatch below) stay on this loop thread.
        t0 = time.monotonic()
        build: List[tuple] = []
        for row in fast:
            if not row.member.place:
                # Pure no-op (all slots already placed): complete + ack.
                futs.append(self._pool.submit(self._finalize_noop, row))
                continue
            build.append((row, self._pool.submit(
                self._build_row, row, snapshot)))
        rows: List[_Row] = []
        for row, f in build:
            dead = False
            # Bounded with a shutdown re-check.
            while not f.wait(1.0):
                if self._stop.is_set():
                    dead = True
                    break
            try:
                if not dead:
                    f.result(0)
            except Exception:
                self.logger.exception(
                    "cohort row build for %s failed; nacking",
                    row.entry.eval.id)
                dead = True
            if dead:
                self._finish(row.entry, acked=False)
            else:
                rows.append(row)
        with self._lock:
            self.t_build += time.monotonic() - t0
        if not rows:
            return futs

        # ---- dispatch: ONE no-park device call for the whole cohort.
        from ..scheduler.batcher import get_batcher

        t1 = time.monotonic()
        try:
            results = get_batcher().place_cohort([
                (row.matrix, row.asks, row.key, row.config,
                 (row.entry.eval.id, row.entry.eval.trace_id))
                for row in rows])
        except Exception:
            # Device fault: no host re-route. Every fast row nacks and
            # the broker redelivers it to a later cohort.
            self.logger.warning(
                "cohort device dispatch failed; nacking %d evals for "
                "redelivery", len(rows), exc_info=True)
            with self._lock:
                self.device_faults += len(rows)
            metrics.incr_counter(("executive", "device_fault"), len(rows))
            for row in rows:
                self._note_process(row, failed=True)
                self._finish(row.entry, acked=False)
            return futs
        dt = time.monotonic() - t1
        with self._lock:
            self.t_dispatch += dt
        for row, (choices, scores) in zip(rows, results):
            row.choices = np.asarray(choices)
            row.scores = np.asarray(scores)
            trace.record_span(
                row.entry.eval.id, trace.STAGE_DEVICE_DISPATCH, t1,
                ann={"cohort": len(rows)},
                trace_id=row.entry.eval.trace_id)

        # ---- materialize + finalize, fanned per row on the pool:
        # exact ports + Allocation literals, then plan submit + status
        # + ack — each row waits on its OWN plan's commit (the plan
        # queue's natural shape, never one shared event). The loop
        # thread goes straight back to accumulating the next cohort.
        for row in rows:
            futs.append(self._pool.submit(
                self._finalize_fast, row, snapshot))
        return futs

    def _note_legacy(self, reason: str) -> None:
        with self._lock:
            self.legacy_evals += 1
            self.legacy_reasons[reason] = (
                self.legacy_reasons.get(reason, 0) + 1)

    # ------------------------------------------------------ fast path

    def _build_row(self, row: _Row, snapshot) -> None:
        from ..models.matrix import ClusterMatrix
        from ..ops.binpack import host_prng_key, make_asks
        from ..scheduler.context import EvalEligibility
        from ..scheduler.tpu import build_placement_config

        m = row.member
        ev, job = m.eval, m.job
        _t0 = time.monotonic()
        row.plan = ev.make_plan(job)
        row.matrix = ClusterMatrix(snapshot, job, row.plan)
        _t_base = time.monotonic()
        row.tg_indices = {tg.name: i
                          for i, tg in enumerate(job.task_groups)}
        row.bulk = list(m.place)
        placements = [row.tg_indices[t.task_group.name] for t in row.bulk]
        ask_arrays = row.matrix.build_asks(placements)
        row.asks = make_asks(*ask_arrays)
        trace.record_span(ev.id, trace.STAGE_MATRIX_BUILD, _t0,
                          ann={"placements": len(row.bulk),
                               "executive": True},
                          trace_id=ev.trace_id)
        trace.record_span(
            ev.id, trace.STAGE_MATRIX_UPDATE, _t0, _t_base,
            ann={"kind": row.matrix.build_kind,
                 "rows": row.matrix.delta_rows},
            trace_id=ev.trace_id)
        # Compression-plane marker, mirroring scheduler/tpu.py: the
        # executive's evals carry the same class-index annotation.
        trace.record_span(
            ev.id, trace.STAGE_MATRIX_COMPRESS, _t_base, _t_base,
            ann=row.matrix.class_index.stats(), trace_id=ev.trace_id)
        # The factory's kernel pin ("service-convex-gpu" -> convex)
        # rides into the config exactly as BatchedGPUScheduler.kernel
        # would — the fast path must run the SAME program the per-eval
        # scheduler (and this eval's own conflict re-run) runs.
        row.config = build_placement_config(
            job.type == consts.JOB_TYPE_BATCH,
            self.server.config.dense_pre_resolve,
            factory_kernel(self.server.config.factory_for(ev.type)),
            placements, ask_arrays)
        # Independent PRNG per eval (worker.py: correlated tie-break
        # streams spike plan conflicts).
        row.rng = random.Random(int.from_bytes(os.urandom(8), "little"))
        row.key = host_prng_key(row.rng.getrandbits(31))
        row.elig = EvalEligibility()
        row.elig.set_job(job)

    def _materialize(self, row: _Row, snapshot) -> None:
        """Choices -> exact per-task network offers -> Allocation
        literals on the plan. Mirrors scheduler/tpu.py's committed
        loop: failed TGs coalesce, the dense port-count approximation's
        misses go to the exact host selector for that one placement,
        and class eligibility feeds the blocked-eval machinery from the
        feasibility mask."""
        from ..scheduler.tpu import (
            _build_allocation,
            _offer_networks,
            note_quality,
        )

        matrix = row.matrix
        net_indexes: Dict[str, object] = {}
        committed = []
        for j, missing in enumerate(row.bulk):
            name = missing.task_group.name
            if name in row.failed:
                row.failed[name].coalesced_failures += 1
                continue
            choice = int(row.choices[j])
            node = (matrix.nodes[choice]
                    if 0 <= choice < matrix.n_real else None)
            m = AllocMetric()
            m.nodes_evaluated = matrix.n_real
            m.nodes_available = matrix.nodes_by_dc
            if node is None:
                self._record_failure(row, missing, m)
                continue
            m.score_node(node, "binpack", float(row.scores[j]))
            task_resources = _offer_networks(
                row.rng, missing, node, net_indexes, matrix)
            if task_resources is None:
                # Dense port approximation missed a real collision:
                # exact host selector for this one placement.
                if not self._stack_place(row, missing, snapshot, m):
                    self._record_failure(row, missing, m)
                continue
            row.plan.append_alloc(_build_allocation(
                _SchedStub(row.member.eval, row.member.job), missing,
                node, task_resources, m))
            committed.append((j, choice))
        note_quality(self.logger, row.member.job, row.config.kernel,
                     matrix, np.asarray(row.asks.resources), committed)

    def _stack_place(self, row: _Row, missing, snapshot, m) -> bool:
        """Exact host-path selection for one placement (the per-eval
        dense scheduler's port-collision path, generic.py
        _compute_placements shape)."""
        from ..scheduler.context import EvalContext
        from ..scheduler.stack import GenericStack
        from ..scheduler.util import ready_nodes_in_dcs
        from ..structs import Allocation, Resources
        from ..utils.ids import generate_uuid

        job = row.member.job
        if row.stack is None:
            row.ctx = EvalContext(snapshot, row.plan, self.logger,
                                  rng=row.rng)
            row.stack = GenericStack(
                job.type == consts.JOB_TYPE_BATCH, row.ctx)
            row.stack.set_job(job)
            nodes, _by_dc = ready_nodes_in_dcs(snapshot, job.datacenters)
            row.stack.set_nodes(nodes)
        option, _ = row.stack.select(missing.task_group)
        if option is None:
            return False
        alloc = Allocation(
            id=generate_uuid(),
            eval_id=row.member.eval.id,
            name=missing.name,
            job_id=job.id,
            task_group=missing.task_group.name,
            metrics=m,
            node_id=option.node.id,
            task_resources=option.task_resources,
            desired_status=consts.ALLOC_DESIRED_RUN,
            client_status=consts.ALLOC_CLIENT_PENDING,
            shared_resources=Resources(
                disk_mb=missing.task_group.ephemeral_disk.size_mb),
        )
        if missing.alloc is not None and missing.alloc.id:
            alloc.previous_allocation = missing.alloc.id
        row.plan.append_alloc(alloc)
        return True

    def _record_failure(self, row: _Row, missing, m) -> None:
        name = missing.task_group.name
        gi = row.tg_indices[name]
        matrix = row.matrix
        infeasible = int(
            matrix.n_real - matrix.feasible[: matrix.n_real, gi].sum())
        m.nodes_filtered = infeasible
        m.nodes_exhausted = matrix.n_real - infeasible
        row.failed[name] = m
        for i, node in enumerate(matrix.nodes):
            if node.computed_class:
                row.elig.set_task_group_eligibility(
                    bool(matrix.feasible[i, gi]), name,
                    node.computed_class)

    def _finalize_fast(self, row: _Row, snapshot) -> None:
        """Materialize the row's choices into its plan, submit it,
        persist the terminal status, release the broker lease. Runs on
        the executive pool; a plan conflict (RefreshIndex) hands the
        eval to the per-eval scheduler on the refreshed snapshot —
        committed allocs re-diff as existing state there, so only the
        rejected remainder replans."""
        from ..scheduler.generic import BLOCKED_EVAL_FAILED_PLACEMENTS
        from ..scheduler.util import adjust_queued_allocations, set_status

        entry = row.entry
        ev = entry.eval
        session = EvalSession(self, ev, entry.token)
        blocked = None
        try:
            self._materialize(row, snapshot)
            if row.failed:
                blocked = ev.create_blocked_eval(
                    row.elig.get_classes(), row.elig.has_escaped())
                blocked.status_description = (
                    BLOCKED_EVAL_FAILED_PLACEMENTS)
                session.create_eval(blocked)
            if row.plan.is_no_op():
                set_status(self.logger, session, ev, None, blocked,
                           row.failed or None,
                           consts.EVAL_STATUS_COMPLETE, "", row.queued)
                self._note_process(row, failed=False)
                self._finish(entry, acked=True)
                return
            result, new_state = session.submit_plan(row.plan)
            adjust_queued_allocations(self.logger, result, row.queued)
            if new_state is not None:
                # Partial commit: per-eval scheduler on the refreshed
                # snapshot owns the remainder (and the eval's status).
                with self._lock:
                    self.plan_conflicts += 1
                metrics.incr_counter(("executive", "plan_conflict"))
                self._note_process(row, failed=False, conflicted=True)
                self._process_legacy(entry, new_state, None)
                return
            full_commit, expected, actual = result.full_commit(row.plan)
            if not full_commit:
                raise RuntimeError(
                    f"missing state refresh after partial commit "
                    f"({actual}/{expected} placed)")
            set_status(self.logger, session, ev, None, blocked,
                       row.failed or None, consts.EVAL_STATUS_COMPLETE,
                       "", row.queued)
        except Exception:
            self.logger.exception("executive eval %s failed", ev.id)
            self._note_process(row, failed=True)
            self._finish(entry, acked=False)
            return
        self._note_process(row, failed=False)
        self._finish(entry, acked=True)

    def _note_process(self, row: _Row, failed: bool,
                      conflicted: bool = False) -> None:
        now = time.monotonic()
        with self._lock:
            if not failed and not conflicted:
                self.fast_evals += 1
            self.t_finalize += now - row.t_start
        trace.record_span(
            row.entry.eval.id, trace.STAGE_SCHED_PROCESS, row.t_start,
            now,
            ann={"path": "executive", "failed": failed,
                 "conflicted": conflicted},
            trace_id=row.entry.eval.trace_id)

    def _finalize_noop(self, row: _Row) -> None:
        """A fast member whose required slots are all placed already:
        complete + ack without touching the device."""
        from ..scheduler.util import set_status

        entry = row.entry
        session = EvalSession(self, entry.eval, entry.token)
        try:
            set_status(self.logger, session, entry.eval, None, None,
                       None, consts.EVAL_STATUS_COMPLETE, "", row.queued)
        except Exception:
            self.logger.exception(
                "executive no-op status for %s failed", entry.eval.id)
            self._note_process(row, failed=True)
            self._finish(entry, acked=False)
            return
        self._note_process(row, failed=False)
        self._finish(entry, acked=True)

    # ----------------------------------------------------- legacy lane

    def _process_legacy(self, entry: _Entry, snapshot,
                        factory: Optional[str]) -> None:
        """The per-eval scheduler, unchanged — the executive's lane for
        everything its array path does not own (stops, updates,
        migrations and their budget claims, preemption, gangs, defrag
        moves, conflicts, host routing)."""
        ev, token = entry.eval, entry.token
        start = time.monotonic()
        try:
            if snapshot is None:
                if not self._wait_for_index(
                        max(ev.modify_index,
                            self.server.snapshot_min_index()),
                        WAIT_INDEX_TIMEOUT):
                    self._finish(entry, acked=False)
                    return
                snapshot = self.server.fsm.state.snapshot()
            if factory is None:
                factory = self.server.config.factory_for(ev.type)
            session = EvalSession(self, ev, token)
            rng = random.Random(int.from_bytes(os.urandom(8), "little"))
            sched = new_scheduler(factory, self.logger, snapshot,
                                  session, rng=rng)
            sched.process_eval(ev)
        except Exception:
            self.logger.exception("executive legacy eval %s failed",
                                  ev.id)
            trace.record_span(ev.id, trace.STAGE_SCHED_PROCESS, start,
                              ann={"path": "executive-legacy",
                                   "failed": True},
                              trace_id=ev.trace_id)
            self._finish(entry, acked=False)
            return
        trace.record_span(ev.id, trace.STAGE_SCHED_PROCESS, start,
                          ann={"path": "executive-legacy"},
                          trace_id=ev.trace_id)
        self._finish(entry, acked=True)

    # ------------------------------------------------------- plumbing

    def _drop_expired(self, batch: List[_Entry],
                      t_launch: float) -> List[_Entry]:
        """Deadline enforcement before any matrix build: terminalize
        expired entries with the structured reason + ack (the broker
        enforces the same bound at dequeue; this covers accumulation
        time — dispatch/pipeline.py semantics)."""
        now = time.time()
        live: List[_Entry] = []
        expired: List[_Entry] = []
        for entry in batch:
            (expired if entry.eval.expired(now) else live).append(entry)
        if not expired:
            return batch
        with self._lock:
            self.expired_dropped += len(expired)
        metrics.incr_counter(("executive", "expired_dropped"),
                             len(expired))
        for entry in expired:
            trace.record_span(
                entry.eval.id, trace.STAGE_DISPATCH_ACCUMULATE,
                entry.enqueued_at, t_launch,
                ann={"expired": True, "deadline": entry.eval.deadline},
                trace_id=entry.eval.trace_id)
            self._finish_expired(entry)
        return live

    def _finish_expired(self, entry: _Entry) -> None:
        upd = entry.eval.copy()
        upd.status = consts.EVAL_STATUS_FAILED
        upd.status_description = (
            f"deadline expired before dispatch: deadline "
            f"{entry.eval.deadline:.3f} passed while accumulating "
            f"(originally triggered by {entry.eval.triggered_by!r})")
        try:
            self.server.eval_update([upd])
        except Exception:
            self.logger.warning(
                "expired-eval terminal write for %s failed; broker "
                "deadline check will re-park it", entry.eval.id,
                exc_info=True)
            self._finish(entry, acked=False)
            return
        self._finish(entry, acked=True)

    def _finish(self, entry: _Entry, acked: bool) -> None:
        try:
            if acked:
                self.server.eval_ack(entry.eval.id, entry.token)
            else:
                self.server.eval_nack(entry.eval.id, entry.token)
        except ValueError:
            pass  # nack timer fired concurrently
        except Exception:
            # The broker's nack timer reclaims the eval either way;
            # raising out of the loop/pool thread would wedge the
            # cohort instead.
            self.logger.warning(
                "eval %s %s failed; nack timer will reclaim",
                entry.eval.id, "ack" if acked else "nack",
                exc_info=True)
        with self._lock:
            if acked:
                self.acked += 1
            else:
                self.nacked += 1
        profile.event("ack", a=int(acked))

    def _wait_for_index(self, index: int, timeout: float) -> bool:
        return poll_until(
            lambda: self.server.fsm.state.latest_index() >= index,
            timeout, stop=self._stop, base=0.001, max_delay=0.1)

    # ----------------------------------------------------------- stats

    def stats(self) -> dict:
        with self._lock:
            cohorts = self.cohorts
            return {
                "enabled": self.enabled,
                "max_batch": self.max_batch,
                "executive_threads": self.threads,
                "cohorts": cohorts,
                "cohort_evals": self.cohort_evals,
                "occupancy": round(self.cohort_evals / cohorts, 2)
                if cohorts else 0.0,
                "largest_cohort": self.largest_cohort,
                "pending": len(self._pending),
                "evals_in": self.evals_in,
                "fast_evals": self.fast_evals,
                "legacy_evals": self.legacy_evals,
                "legacy_reasons": dict(self.legacy_reasons),
                "routed_host": self.routed_host,
                "device_faults": self.device_faults,
                "plan_conflicts": self.plan_conflicts,
                "expired_dropped": self.expired_dropped,
                "acked": self.acked,
                "nacked": self.nacked,
                "drained": self.drained,
                "drain_us": int(self.t_drain * 1e6),
                "build_us": int(self.t_build * 1e6),
                "dispatch_us": int(self.t_dispatch * 1e6),
                "finalize_us": int(self.t_finalize * 1e6),
            }


class _SchedStub:
    """The two attributes scheduler/tpu.py's _build_allocation reads
    off a scheduler (`eval`, `job`) — the executive has no scheduler
    instance on its fast path."""

    __slots__ = ("eval", "job")

    def __init__(self, ev, job):
        self.eval = ev
        self.job = job
