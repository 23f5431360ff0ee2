"""The central placement pipeline for dense-path evaluations.

Three stages, pipelined the way the plan applier pipelines verify and
commit (reference nomad/plan_apply.go:19-39), applied one layer up to
device dispatch:

- **central drain** — every worker that dequeues a dense-factory eval
  hands it here instead of draining its own slice of the broker; the
  dispatcher tops the accumulating batch up with ONE
  broker.dequeue_many across everything ready, so a storm packs toward
  MAX_BATCH lanes instead of fragmenting into per-worker groups.
- **pipelined launch** — a closed batch is fanned out to the stage
  pool and the dispatcher immediately resumes accumulating; up to
  `dispatch_max_inflight` batches run concurrently, so the next
  batch's evals build matrices and upload overlays WHILE the previous
  batch's device sync and plan submits are still in flight. Plan
  submission + ack runs on the stage/result threads, never on the
  dispatcher.
- **conflict requeue** — a plan the applier partially rejects
  (RefreshIndex) does not replan alone on a fresh snapshot (a 1-3
  alloc retry that pays a full round-trip); the eval
  is folded back into the ACCUMULATING batch and replans with the next
  full dispatch. In-batch collisions are already pre-resolved on
  device (ops/binpack.py PlacementConfig.pre_resolve), so requeues are
  the cross-batch residue only.

The pipeline preserves the worker path's contracts: per-job broker
serialization (a drained batch is always over distinct jobs), the
latency-aware host routing for sub-`dense_min_batch` batches, eval
ack/nack with the original broker token, and the nack-clock pause
while a plan waits in the plan queue.

The port of the JAX package's dispatch/pipeline.py. It carries no
circuit breaker and no fault-injection sites: a dense eval whose device
dispatch raises takes the pipeline's exception path (logged, nacked,
redelivered by the broker) and is never re-placed on the host factory in
the same attempt. Only batches smaller than ``dense_min_batch`` route to
the host factories (``routed_host`` counts them), as in the reference.
"""

from __future__ import annotations

import logging
import os
import random
import threading
import time
from typing import List, Optional, Tuple

from .. import profile, trace
from ..profile import ProfiledCondition, ProfiledLock
from ..scheduler import new_scheduler
from ..server.worker import EvalSession
from ..structs import Evaluation, Plan, PlanResult, consts
from ..utils import metrics
from ..utils.backoff import poll_until

DEQUEUE_TOPUP_SLICE = 0.002  # cond-wait granularity while accumulating
SLOT_WAIT_SLICE = 0.02  # cond-wait granularity while all slots busy
WAIT_INDEX_TIMEOUT = 5.0

# Lock-discipline manifest (data): functions reachable from these
# entrypoints run on the dispatcher thread and must never block (the
# accumulator IS the pipeline's clock — a blocked dispatcher stops
# batches from closing for every worker at once). Bounded cond-waits on
# the pipeline's own lock are the sanctioned scheduling primitive;
# everything slow (FSM catch-up, snapshotting, plan submit, device
# sync) belongs on the stage threads.
NTA_DISPATCHER_ENTRYPOINTS = ("DispatchPipeline._run",)


class _RequeueConflict(Exception):
    """Raised out of PipelineSession.submit_plan to abort the eval's
    current scheduling attempt: the plan was (partially) rejected and
    the eval should replan as part of the pipeline's accumulating
    batch instead of alone on a fresh snapshot."""


class _Pending:
    __slots__ = ("eval", "token", "requeues", "enqueued_at", "min_index")

    def __init__(self, ev: Evaluation, token: str, requeues: int = 0):
        self.eval = ev
        self.token = token
        self.requeues = requeues
        self.enqueued_at = time.monotonic()
        # Lowest FSM index this entry may replan against: a conflict
        # requeue records its plan's RefreshIndex here, so the relaunch
        # snapshot provably includes the eval's OWN partial commit (a
        # follower's FSM can lag the leader commit; replanning before
        # it replicates would double-place the committed allocs).
        self.min_index = 0


class PipelineSession(EvalSession):
    """Per-eval Planner for pipeline-processed evals. Inherits the
    whole Planner contract (pause-nack framing, eval updates, reblock,
    pre_resolve wiring) from server/worker.py EvalSession — one
    implementation to keep in sync — and overrides only the
    plan-conflict handling: refreshes raise _RequeueConflict (bounded,
    side-effect-guarded) so the retry rides the ACCUMULATING batch
    instead of replanning alone."""

    def __init__(self, pipeline: "DispatchPipeline", entry: _Pending,
                 announced: bool = False):
        # EvalSession only needs `.server` and `._wait_for_index` from
        # its worker — the pipeline provides both.
        super().__init__(pipeline, entry.eval, entry.token)
        self.pipeline = pipeline
        self.entry = entry
        # True while this eval is counted in the batcher's announced
        # cohort (add_cohort); consumed at place() time or repaid on
        # a host path (scheduler/tpu.py) / eval completion
        # (_repay_unconsumed).
        self.announced_cohort = announced
        # Evals created this attempt (blocked / rolling follow-ups):
        # once any exist, aborting the attempt would re-create them on
        # the requeued run — fall back to the inline retry instead.
        self.created_evals = 0

    def submit_plan(self, plan: Plan) -> Tuple[PlanResult, Optional[object]]:
        start = time.monotonic()
        plan.eval_token = self.token
        try:
            self.server.eval_pause_nack(self.eval.id, self.token)
        except ValueError:
            pass
        try:
            result = self.server.plan_submit(plan)
        finally:
            try:
                self.server.eval_resume_nack(self.eval.id, self.token)
            except ValueError:
                pass
        self.pipeline._note_submit(start)
        trace.record_span(self.eval.id, trace.STAGE_PLAN_SUBMIT, start,
                          trace_id=self.eval.trace_id)
        if result.refresh_index:
            self.pipeline._note_conflict()
            if (self.created_evals == 0
                    and self.entry.requeues < self.pipeline.max_requeues):
                # Replan as part of the next packed batch — which must
                # snapshot at or past this plan's partial commit.
                self.entry.min_index = max(self.entry.min_index,
                                           result.refresh_index)
                raise _RequeueConflict()
            # Bounded out (or side effects exist): classic inline
            # retry — catch local state up, hand back a fresh snapshot.
            self.pipeline._note_inline_retry()
            self.pipeline._wait_for_index(
                result.refresh_index, WAIT_INDEX_TIMEOUT)
            return result, self.server.fsm.state.snapshot()
        return result, None

    def create_eval(self, ev: Evaluation) -> None:
        self.created_evals += 1
        super().create_eval(ev)


class DispatchPipeline:
    def __init__(self, server):
        self.server = server
        cfg = server.config
        self.logger = logging.getLogger("nomad_tpu_torch.dispatch")
        self.max_batch = max(1, cfg.eval_batch_size)
        self.max_inflight = max(1, cfg.dispatch_max_inflight)
        self.window = cfg.dispatch_window
        self.idle_grace = cfg.dispatch_idle_grace
        self.max_requeues = cfg.dispatch_max_requeues
        # The eval types whose factories are dense — what the central
        # drain pulls from the broker.
        from ..server.worker import is_dense_factory

        self.types: List[str] = [
            t for t in cfg.enabled_schedulers
            if is_dense_factory(cfg.factory_for(t))
        ]
        # The scheduler executive is not ported (Server refuses
        # scheduler_executive=True), so the pipeline owns the central
        # dense drain whenever a dense type batches.
        self.enabled = bool(self.types and cfg.eval_batch_size > 1)

        # Profiled (nomad_tpu_torch/profile): the accumulator lock every
        # worker handoff and batch cut crosses.
        self._lock = ProfiledLock("dispatch.pipeline")
        self._cond = ProfiledCondition(self._lock, "dispatch.pipeline")
        self._pending: List[_Pending] = []  # guarded-by: _lock
        self._inflight = 0  # guarded-by: _lock
        # Run-queue delay measurement (work announced -> dispatcher
        # actually running): _admit stamps _notified_at ONLY while the
        # dispatcher is parked on the seed wait (_drain_waiting) — a
        # notify that lands mid-top-up wakes nothing, and timing it
        # would read the whole accumulation window as scheduling delay.
        self._notified_at = 0.0  # guarded-by: _lock
        self._drain_waiting = False  # guarded-by: _lock
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.drained = 0  # guarded-by: _lock (evals requeued by drain())
        self.expired_dropped = 0  # guarded-by: _lock (deadline at launch)

        # ---- stats ----
        self.evals_in = 0  # guarded-by: _lock (handed off / requeued)
        self.batches = 0  # guarded-by: _lock (batches launched)
        self.dispatched_evals = 0  # guarded-by: _lock (sum batch sizes)
        self.largest_batch = 0  # guarded-by: _lock
        self.routed_host = 0  # guarded-by: _lock (sent to host factory)
        self.acked = 0  # guarded-by: _lock
        self.nacked = 0  # guarded-by: _lock
        self.plan_conflicts = 0  # guarded-by: _lock (RefreshIndex'd)
        self.requeues = 0  # guarded-by: _lock (retries via accumulator)
        self.requeues_batched = 0  # guarded-by: _lock (joined a batch)
        self.inline_retries = 0  # guarded-by: _lock (classic retries)
        self.prefetches = 0  # guarded-by: _lock (base prefetch calls)
        self.prefetch_bytes = 0  # guarded-by: _lock (host->device bytes)
        self.t_drain = 0.0  # guarded-by: _lock (time in accumulator)
        self.t_process = 0.0  # guarded-by: _lock (scheduler invoke)
        self.t_submit = 0.0  # guarded-by: _lock (plan queue + commit)

    # ------------------------------------------------------- lifecycle

    def start(self) -> None:
        if not self.enabled or self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="dispatch-pipeline", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        with self._cond:
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        # Accumulated evals must not die with the pipeline: hand their
        # leases back so another server's workers redeliver them.
        self.drain()

    def drain(self) -> int:
        """Leadership loss (or shutdown): requeue every accumulated
        eval into the broker by nacking its outstanding token, so
        nothing a batch had in hand is lost and nothing double-places.

        Extends the requeue path one failure class further: a
        conflict requeue re-enters the ACCUMULATING batch with its
        token still outstanding; a drain gives the token BACK — on the
        (old) leader the nack re-readies the eval immediately, and when
        the broker is already disabled/flushed (a real flap) the nack
        fails cleanly and the new leader re-seeds the eval from raft
        state (_restore_evals), since an undelivered eval is still
        status=pending there. In-flight-but-unacked batch members need
        no sweep: their stage threads' acks fail against the flushed
        broker and the same restore covers them, while the plan-queue
        token guard (plan_submit checks the OUTSTANDING token) keeps a
        stale batch from committing a double placement."""
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

    # ------------------------------------------------------ admission

    def submit(self, ev: Evaluation, token: str) -> None:
        """Hand a dequeued dense-path eval to the pipeline (worker
        handoff, and the conflict-requeue re-entry)."""
        self._admit(_Pending(ev, token))

    def _admit(self, entry: _Pending) -> None:
        entry.enqueued_at = time.monotonic()
        with self._cond:
            self._pending.append(entry)
            self.evals_in += 1
            if self._drain_waiting and not self._notified_at:
                # Stamped HERE, lock held, right before the notify —
                # not entry.enqueued_at: the admitter's own wait for
                # this lock is already measured by the lock's wait
                # histogram, and folding it in would double-count
                # admit-side contention as dispatcher wake latency.
                self._notified_at = time.monotonic()
            self._cond.notify_all()

    def pending_count(self) -> int:
        with self._lock:
            return len(self._pending)

    def saturated(self) -> bool:
        """Intake-backpressure signal for the worker handoff
        (server/worker.py): True while the accumulator already holds
        two full batches' worth of evals. A saturated pipeline must not
        keep draining the broker — evals held here are invisible to the
        bounded ready queues (nomad_tpu_torch/admission), so an unbounded
        drain would reopen exactly the intake the depth caps close."""
        with self._lock:
            return len(self._pending) >= 2 * self.max_batch

    # ------------------------------------------------------ dispatcher

    def _run(self) -> None:
        while not self._stop.is_set():
            batch = self._accumulate()
            if batch:
                # The launch prologue BLOCKS — _wait_for_index
                # sleep-polls the FSM for up to WAIT_INDEX_TIMEOUT and
                # snapshotting walks every table — so it runs on a
                # stage thread. The dispatcher goes straight back to
                # accumulating: the next batch keeps filling while this
                # one catches up to its snapshot index (previously a
                # follower lagging the leader commit froze ALL lanes
                # for the duration, not just this batch's).
                # _accumulate already took the in-flight slot, so the
                # pipelining bound still holds while the launch is in
                # hand-off.
                self.server.eval_pool.submit(self._launch, batch)

    def _accumulate(self) -> List[_Pending]:
        """Pack the next batch: wait for a seed eval, then top up with
        one central broker drain per pass. Close rules: a FULL batch
        closes immediately; an idle pipeline closes after `idle_grace`
        (a lone interactive eval must not marinate); while batches are
        in flight the accumulator keeps filling for `window` — the
        in-flight round-trip is exactly the budget this wait amortizes
        — and when every slot is busy it simply keeps accumulating
        until one frees."""
        with self._cond:
            self._drain_waiting = True
            try:
                while not self._pending and not self._stop.is_set():
                    self._cond.wait(0.25)
            finally:
                self._drain_waiting = False
            if not self._pending:
                self._notified_at = 0.0
                return []
            # Run-queue delay at the broker-drain point: notify-while-
            # parked -> this thread actually running — the dispatcher's
            # wake latency under GIL pressure, nothing else (the top-up
            # window and slot waits are deliberate batching time and
            # are measured by t_drain, not here).
            if self._notified_at:
                profile.record_runq(
                    "broker_drain",
                    (time.monotonic() - self._notified_at) * 1000.0)
                self._notified_at = 0.0
            profile.event("accumulate_open", "dispatcher",
                          a=len(self._pending))
        start = time.monotonic()
        while not self._stop.is_set():
            with self._lock:
                room = self.max_batch - len(self._pending)
            if room > 0:
                # The central drain: everything ready across the
                # broker, not one worker's slice.
                got = self.server.eval_dequeue_many(self.types, room)
                if got:
                    now = time.monotonic()
                    with self._cond:
                        for ev, token in got:
                            entry = _Pending(ev, token)
                            entry.enqueued_at = now
                            self._pending.append(entry)
                            self.evals_in += 1
            with self._cond:
                elapsed = time.monotonic() - start
                if len(self._pending) >= self.max_batch:
                    break
                if self._inflight == 0:
                    if elapsed >= self.idle_grace:
                        break
                elif (self._inflight < self.max_inflight
                      and elapsed >= self.window):
                    break
                self._cond.wait(DEQUEUE_TOPUP_SLICE)
        # Wait for an in-flight slot; late arrivals keep joining the
        # pending list while we wait (that IS the adaptive window).
        with self._cond:
            while (self._inflight >= self.max_inflight
                   and not self._stop.is_set()):
                self._cond.wait(SLOT_WAIT_SLICE)
            batch = self._pending[: self.max_batch]
            del self._pending[: len(batch)]
            if not batch:
                return []
            self._inflight += 1
            self.batches += 1
            self.dispatched_evals += len(batch)
            self.largest_batch = max(self.largest_batch, len(batch))
            now = time.monotonic()
            for entry in batch:
                self.t_drain += now - entry.enqueued_at
                if entry.requeues and len(batch) > 1:
                    self.requeues_batched += 1
            profile.event("accumulate_close", "dispatcher",
                          a=len(batch), b=self.batches)
        metrics.add_sample(("dispatch", "batch_size"), len(batch))
        return batch

    def _launch(self, batch: List[_Pending]) -> None:
        # Trace: the accumulate stage closes when the batch is cut.
        # Recorded HERE (stage thread) rather than in _accumulate so
        # the dispatcher thread carries zero extra work per batch.
        t_launch = time.monotonic()
        # Deadline enforcement BEFORE any matrix build or cohort
        # announcement: an expired eval must not burn a device lane on
        # a plan its submitter already gave up on (nomad_tpu_torch/admission
        # deadline semantics; the broker enforces the same bound at
        # dequeue, this covers time spent accumulating).
        batch = self._drop_expired(batch, t_launch)
        if not batch:
            with self._cond:
                self._inflight -= 1
                self._cond.notify_all()
            return
        for entry in batch:
            trace.record_span(
                entry.eval.id, trace.STAGE_DISPATCH_ACCUMULATE,
                entry.enqueued_at, t_launch,
                ann={"batch": len(batch), "requeues": entry.requeues},
                trace_id=entry.eval.trace_id)
        # The whole prologue is guarded: it runs on a pool thread now,
        # where an escaped exception dies into an unread PoolFuture —
        # and the slot _accumulate took would leak, wedging the
        # accumulator once max_inflight failed launches pile up.
        try:
            prologue = self._launch_prologue(batch)
        except Exception:
            self.logger.exception(
                "batch launch failed; nacking %d evals", len(batch))
            prologue = None
        for entry in batch:
            trace.record_span(
                entry.eval.id, trace.STAGE_DISPATCH_LAUNCH, t_launch,
                ann=({"failed": True} if prologue is None else None),
                trace_id=entry.eval.trace_id)
        # Single abort call site: an abort raising INSIDE the try must
        # never be re-entered by the except path (double slot release).
        if prologue is None:
            self._abort_batch(batch)
            return
        # Fan-out needs no guard: WorkPool.submit enqueues then NEVER
        # raises (a failed worker spawn is swallowed and retried on the
        # next submit — utils/pool.py), so every entry is handed off
        # exactly once and releases the slot via `remaining`. A
        # partial-fan-out cleanup here would double-finish entries the
        # pool still runs.
        snapshot, route_host = prologue
        profile.event("launch", "stage", a=len(batch), b=int(route_host))
        remaining = [len(batch)]
        for entry in batch:
            self.server.eval_pool.submit(
                self._process_entry, entry, snapshot, route_host,
                remaining)

    def _drop_expired(self, batch: List[_Pending],
                      t_launch: float) -> List[_Pending]:
        """Split out entries whose deadline passed while accumulating,
        terminalize them (status=failed with a structured reason +
        ack), and return the live remainder. Runs on a stage thread."""
        now = time.time()
        live: List[_Pending] = []
        expired: List[_Pending] = []
        for entry in batch:
            if entry.eval.expired(now):
                expired.append(entry)
            else:
                live.append(entry)
        if not expired:
            return batch
        with self._lock:
            self.expired_dropped += len(expired)
        metrics.incr_counter(("dispatch", "expired_dropped"),
                             len(expired))
        for entry in expired:
            trace.record_span(
                entry.eval.id, trace.STAGE_DISPATCH_ACCUMULATE,
                entry.enqueued_at, t_launch,
                ann={"expired": True, "deadline": entry.eval.deadline},
                trace_id=entry.eval.trace_id)
            self._finish_expired(entry)
        return live

    def _finish_expired(self, entry: _Pending) -> None:
        """Persist the structured terminal outcome for one expired
        entry, then release its broker lease. On a leader flap either
        write can fail — the nack timer redelivers and the broker's
        dequeue-side deadline check parks it structured there instead,
        so the eval still reaches exactly one terminal outcome."""
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

    def _abort_batch(self, batch: List[_Pending]) -> None:
        """Nack every entry and release the in-flight slot
        _accumulate took for this batch. The release is in a finally:
        aborts run exactly when the leader is unreachable, so the
        nacks themselves may fail — a slot leak here would wedge the
        accumulator after max_inflight failed aborts."""
        try:
            for entry in batch:
                self._finish(entry, acked=False)
        finally:
            with self._cond:
                self._inflight -= 1
                self._cond.notify_all()

    def _launch_prologue(self, batch: List[_Pending]):
        """(snapshot, route_host) for a launchable batch, None when the
        FSM never caught up to the batch's snapshot index. Returned,
        not stored: concurrent launches each carry their own."""
        cfg = self.server.config
        # Latency-aware routing, centralized: a batch too small to
        # amortize the device dispatch runs on the host factories with
        # identical placement semantics (parity-tested).
        # Size is the only route to the host: no breaker reroutes a
        # batch whose device path failed.
        route_host = len(batch) < cfg.dense_min_batch
        if route_host:
            with self._lock:
                self.routed_host += len(batch)
            metrics.incr_counter(("dispatch", "route_host"), len(batch))
        # One MVCC snapshot for the whole batch: every member plans
        # against the same cluster state so their ClusterMatrix bases
        # share one token, one device upload, and (pre_resolve) one
        # serialized claim scan. Same invariant as the worker drain
        # path; optimistic concurrency keeps it safe.
        max_index = max(max(e.eval.modify_index, e.min_index)
                        for e in batch)
        if not self._wait_for_index(max_index, WAIT_INDEX_TIMEOUT):
            return None
        snapshot = self.server.fsm.state.snapshot()
        if not route_host:
            # Announce the fan-out to the batcher: its dispatch window
            # then waits for this whole batch's place() calls (their
            # matrix builds stagger under the GIL) instead of shipping
            # fragmented, third-full device dispatches. System-dense
            # evals are excluded — DenseSystemScheduler's vectorized
            # pass never touches the batcher, so announcing them would
            # only stretch the window (the hint self-heals either way,
            # COHORT_WAIT_MAX). Generic dense evals that take a host
            # path (a few asks, sticky disks) repay their announcement
            # in scheduler/tpu.py.
            announce = sum(
                1 for e in batch
                if e.eval.type != consts.JOB_TYPE_SYSTEM)
            if announce:
                from ..scheduler.batcher import get_batcher

                get_batcher().add_cohort(announce)
            self._prefetch_bases(batch, snapshot)
        return snapshot, route_host

    def _prefetch_bases(self, batch: List[_Pending], snapshot) -> None:
        """Async double-buffering, host side: make this batch's cluster
        base(s) device-resident NOW — on this stage thread, while the
        PREVIOUS batch's device compute and plan submits are still in
        flight (`dispatch_max_inflight` overlaps them) — so the batch's
        evals find their base token already cached at place() time and
        the (tiny) delta transfer hides under compute instead of
        serializing in front of its own dispatch. The base is
        job-independent; distinct datacenter sets across the batch's
        jobs each resolve one base. Failures are non-fatal: place()
        falls back to uploading synchronously, exactly as before."""
        from ..models.matrix import prefetch_cluster_base
        from ..models.resident import get_tracker
        from ..scheduler.batcher import get_batcher

        if not get_tracker().is_enabled():
            return
        dc_sets = {}
        for entry in batch:
            if entry.eval.type == consts.JOB_TYPE_SYSTEM:
                # DenseSystemScheduler builds its matrix over explicit
                # pinned nodes (a different cache family) and never
                # touches the batcher — same exclusion as the cohort
                # announce above.
                continue
            job = snapshot.job_by_id(entry.eval.job_id)
            if job is None:
                continue
            dc_sets.setdefault(
                tuple(sorted(job.datacenters or [])), []).append(entry)
        batcher = get_batcher()
        for dcs, entries in dc_sets.items():
            t0 = time.monotonic()
            try:
                view, kind = prefetch_cluster_base(snapshot, list(dcs))
                nbytes = batcher.prefetch_base(view) if view else 0
            except Exception:
                self.logger.warning(
                    "base prefetch failed; place() will upload "
                    "synchronously", exc_info=True)
                continue
            with self._lock:
                self.prefetches += 1
                self.prefetch_bytes += nbytes
            metrics.incr_counter(("dispatch", "prefetch_bytes"), nbytes)
            profile.event("prefetch", "stage", a=int(nbytes))
            # One span per eval riding this base: stage attribution for
            # the new path (the bytes shipped are the batch's WHOLE
            # host->device traffic when the delta path holds).
            for entry in entries:
                trace.record_span(
                    entry.eval.id, trace.STAGE_DEVICE_TRANSFER, t0,
                    ann={"bytes": nbytes, "kind": kind},
                    trace_id=entry.eval.trace_id)

    # ---------------------------------------------------------- stages

    def _process_entry(self, entry: _Pending, snapshot, route_host: bool,
                       remaining: List[int]) -> None:
        ev, token = entry.eval, entry.token
        start = time.monotonic()
        # Lock-wait attribution for this stage: the profiler keeps a
        # per-thread contended-wait total; the delta across the
        # scheduler invoke lands on the span so a slow scheduler.process
        # can be read as "blocked on locks" vs "actually computing".
        wait0 = profile.thread_wait_ms()
        session = PipelineSession(
            self, entry,
            announced=(not route_host
                       and ev.type != consts.JOB_TYPE_SYSTEM))
        try:
            factory = self.server.config.factory_for(ev.type)
            if route_host:
                from ..server.worker import host_factory

                factory = host_factory(factory)
            # Independent PRNG per eval (see worker.py: correlated
            # tie-break streams spike plan conflicts).
            rng = random.Random(int.from_bytes(os.urandom(8), "little"))
            sched = new_scheduler(
                factory, self.logger, snapshot, session, rng=rng)
            sched.process_eval(ev)
        except _RequeueConflict:
            with self._lock:
                self.requeues += 1
                self.t_process += time.monotonic() - start
            trace.record_span(ev.id, trace.STAGE_SCHED_PROCESS, start,
                              ann={"path": "pipeline", "requeued": True},
                              trace_id=ev.trace_id)
            metrics.incr_counter(("dispatch", "requeue"))
            self._repay_unconsumed(session)
            # Back into the ACCUMULATING batch; the broker token stays
            # outstanding, so per-job serialization still holds.
            entry.requeues += 1
            self._release_slot(remaining)
            self._admit(entry)
            return
        except Exception:
            # A device fault lands here too: the eval is nacked and the
            # broker redelivers it; nothing re-places it on the host.
            self.logger.exception("pipeline eval %s failed", ev.id)
            with self._lock:
                self.t_process += time.monotonic() - start
            trace.record_span(ev.id, trace.STAGE_SCHED_PROCESS, start,
                              ann={"path": "pipeline", "failed": True},
                              trace_id=ev.trace_id)
            self._repay_unconsumed(session)
            self._finish(entry, acked=False)
            self._release_slot(remaining)
            return
        with self._lock:
            self.t_process += time.monotonic() - start
        trace.record_span(
            ev.id, trace.STAGE_SCHED_PROCESS, start,
            ann={"path": "pipeline", "route_host": route_host,
                 "lock_wait_ms": round(
                     profile.thread_wait_ms() - wait0, 3)},
            trace_id=ev.trace_id)
        self._repay_unconsumed(session)
        self._finish(entry, acked=True)
        self._release_slot(remaining)

    def _repay_unconsumed(self, session: PipelineSession) -> None:
        """Repay a cohort unit this eval announced but never consumed:
        placement-less evals (job stop, scale-down, in-place-only
        update) and failed schedulers never reach the batcher, and an
        unrepaid announcement stretches every subsequent partial
        dispatch toward COHORT_WAIT_MAX. The dense scheduler flips
        announced_cohort off right before its place() call, so a
        consumed announcement is never repaid twice."""
        if session.announced_cohort:
            session.announced_cohort = False
            from ..scheduler.batcher import get_batcher

            get_batcher().cohort_cancel(1)

    def _finish(self, entry: _Pending, acked: bool) -> None:
        try:
            if acked:
                self.server.eval_ack(entry.eval.id, entry.token)
            else:
                self.server.eval_nack(entry.eval.id, entry.token)
        except ValueError:
            pass  # nack timer fired concurrently
        except Exception:
            # On a follower the ack/nack is an RPC to the leader and
            # fails exactly when aborts happen (leader flap). The
            # broker's nack timer reclaims the eval either way; raising
            # out of a stage thread would leak slot accounting instead.
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

    def _release_slot(self, remaining: List[int]) -> None:
        with self._cond:
            remaining[0] -= 1
            if remaining[0] == 0:
                self._inflight -= 1
                self._cond.notify_all()

    # ------------------------------------------------------- plumbing

    def _wait_for_index(self, index: int, timeout: float) -> bool:
        # Runs on stage threads only (never the dispatcher); the shared
        # jittered-backoff poll replaces the ad-hoc doubling loop.
        return poll_until(
            lambda: self.server.fsm.state.latest_index() >= index,
            timeout, stop=self._stop, base=0.001, max_delay=0.1)

    def _note_submit(self, start: float) -> None:
        dt = time.monotonic() - start
        with self._lock:
            self.t_submit += dt
        metrics.measure_since(("dispatch", "submit_plan"), start)
        profile.event("submit", a=round(dt * 1000.0, 3))

    def _note_conflict(self) -> None:
        with self._lock:
            self.plan_conflicts += 1
        metrics.incr_counter(("dispatch", "plan_conflict"))

    def _note_inline_retry(self) -> None:
        with self._lock:
            self.inline_retries += 1

    # ----------------------------------------------------------- stats

    def stats(self) -> dict:
        with self._lock:
            batches = self.batches
            dispatched = self.dispatched_evals
            done = self.acked + self.nacked
            retries = self.requeues + self.inline_retries
            return {
                "enabled": self.enabled,
                "max_batch": self.max_batch,
                "batches": batches,
                "dispatched_evals": dispatched,
                # Lanes filled per launched batch.
                "occupancy": round(dispatched / batches, 2) if batches else 0.0,
                "occupancy_frac": round(
                    dispatched / (batches * self.max_batch), 4
                ) if batches else 0.0,
                "largest_batch": self.largest_batch,
                "in_flight": self._inflight,
                "pending": len(self._pending),
                "evals_in": self.evals_in,
                "acked": self.acked,
                "nacked": self.nacked,
                "routed_host": self.routed_host,
                "plan_conflicts": self.plan_conflicts,
                "requeues": self.requeues,
                "requeues_batched": self.requeues_batched,
                "inline_retries": self.inline_retries,
                "drained": self.drained,
                "expired_dropped": self.expired_dropped,
                "prefetches": self.prefetches,
                "prefetch_bytes": self.prefetch_bytes,
                "retries_per_eval": round(retries / done, 4) if done else 0.0,
                # Cumulative stage latencies (divide by the matching
                # counters for per-unit): microseconds, like the
                # batcher's breakdown.
                "drain_us": int(self.t_drain * 1e6),
                "process_us": int(self.t_process * 1e6),
                "submit_us": int(self.t_submit * 1e6),
            }
