"""Scheduling worker: dequeue -> wait-for-index -> invoke scheduler ->
submit plan -> ack.

Reference: nomad/worker.go:50 — the worker implements the scheduler's
Planner interface (worker.go:285-483): plans go through the leader's
plan queue; a RefreshIndex response makes the worker catch its local
state up and hand the scheduler a fresh snapshot.

Extension over the reference: when an eval routes to a dense factory
(``-gpu``), the worker hands it to the scheduler executive
(server/executive.py) when ``scheduler_executive`` is on, else to the
central dispatch pipeline (dispatch/); either packs evals from every
worker into one batched device dispatch (scheduler/batcher.py) and
routes batches smaller than ``dense_min_batch`` to the host factory.
With ``eval_batch_size=1`` both are off and the worker runs each eval
alone on the factory it was configured with.

The port of the JAX package's server/worker.py. Not carried: the
per-worker drain-to-batch loop the reference runs with its pipeline
off.
"""

from __future__ import annotations

import logging
import os
import random
import threading
import time
from typing import Optional, Tuple

from ..scheduler import new_scheduler
from ..utils import metrics
from ..utils.backoff import poll_until
from ..structs import Evaluation, Plan, PlanResult, consts
from .. import trace

DEQUEUE_TIMEOUT = 0.5
BACKOFF_BASE = 0.02
BACKOFF_LIMIT = 2.0
# Nap between saturation re-checks when the executive's or the dispatch
# pipeline's accumulator is full (intake backpressure,
# nomad_tpu_torch/admission): bounded, and short enough that drain
# resumes within a batch launch.
BACKPRESSURE_NAP = 0.01


DENSE_SUFFIX = "-gpu"


def refresh_index(result: PlanResult) -> int:
    """The index a rejected plan's retry snapshots at: the applier's
    refresh index, and at least the index of whatever part of the plan
    committed, so that the retry sees those allocs as placed."""
    return max(result.refresh_index, result.alloc_index or 0)


def is_dense_factory(name: str) -> bool:
    """Dense factories (the port's registry: names ending in ``-gpu``)
    go through the dispatch pipeline's batched device dispatch."""
    return name.endswith(DENSE_SUFFIX)


def factory_kernel(name: str) -> Optional[str]:
    """The kernel a dense factory variant pins ("service-convex-gpu"
    -> "convex"; nomad_tpu_torch/kernels lazy registry), None for plain
    dense factories and host factories."""
    if not is_dense_factory(name):
        return None
    base = name[: -len(DENSE_SUFFIX)]
    from ..kernels import kernel_names

    for kernel in kernel_names():
        if base.endswith("-" + kernel):
            return kernel
    return None


def host_factory(name: str) -> str:
    """The host (CPU iterator) factory with identical placement
    semantics — where latency-aware routing sends lone evals. Kernel-
    pinned dense variants ("service-convex-gpu", nomad_tpu_torch/kernels)
    map to the same host factory as their plain siblings: the host
    path has no kernels, the infix strips with the suffix."""
    if not is_dense_factory(name):
        return name
    kernel = factory_kernel(name)
    base = name[: -len(DENSE_SUFFIX)]
    if kernel is not None:
        return base[: -(len(kernel) + 1)]
    return base


class EvalSession:
    """Per-eval Planner (worker.go:285-483). One session per in-flight
    eval so a worker can process a drained batch concurrently — the
    Planner callbacks need the eval's own token, not worker state."""

    def __init__(self, worker: "Worker", ev: Evaluation, token: str):
        self.worker = worker
        self.server = worker.server
        self.eval = ev
        self.token = token
        # The dense kernel's in-batch conflict pre-resolution flag
        # (scheduler/tpu.py reads it off its Planner).
        self.pre_resolve = worker.server.config.dense_pre_resolve

    def submit_plan(self, plan: Plan) -> Tuple[PlanResult, Optional[object]]:
        start = time.monotonic()
        plan.eval_token = self.token
        # The Nack clock stops while the plan waits in the queue
        # (plan_endpoint.go:16).
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
        metrics.measure_since(("worker", "submit_plan"), start)
        trace.record_span(self.eval.id, trace.STAGE_PLAN_SUBMIT, start,
                          trace_id=self.eval.trace_id)
        if result.refresh_index:
            # Stale snapshot: catch up and hand back fresh state, at or
            # past the plan's own partial commit (a raft follower's FSM
            # applies it after plan_submit returns).
            self.worker._wait_for_index(refresh_index(result), timeout=5.0)
            return result, self.server.fsm.state.snapshot()
        return result, None

    def update_eval(self, ev: Evaluation) -> None:
        self.server.eval_update([ev])

    def create_eval(self, ev: Evaluation) -> None:
        ev.snapshot_index = self.server.fsm.state.latest_index()
        self.server.eval_update([ev])

    def reblock_eval(self, ev: Evaluation) -> None:
        token = self.server.eval_outstanding(ev.id)
        if token != self.token:
            raise ValueError(f"eval {ev.id!r} is not outstanding")
        ev.snapshot_index = self.server.fsm.state.latest_index()
        self.server.eval_update([ev], token=self.token)


class Worker:
    def __init__(self, server, worker_id: int):
        self.server = server
        self.id = worker_id
        self.logger = logging.getLogger(f"nomad_tpu_torch.worker.{worker_id}")
        self._stop = threading.Event()
        self._paused = False  # guarded-by: _pause_lock
        self._pause_lock = threading.Lock()
        self._pause_cond = threading.Condition(self._pause_lock)
        self._parked = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.rng = random.Random()

    # ------------------------------------------------------------------

    def start(self) -> None:
        self._stop.clear()
        self._thread = threading.Thread(
            target=self.run, name=f"worker-{self.id}", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self.set_pause(False)
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    def set_pause(self, paused: bool) -> None:
        """Leader parks 3/4 of its workers to give CPU to the plan
        applier (leader.go:108-117, worker.go:82-98)."""
        with self._pause_lock:
            self._paused = paused
            self._pause_cond.notify_all()

    def parked(self) -> bool:
        """True while the run loop is waiting inside the paused state —
        i.e. this worker is provably NOT inside a broker dequeue. A
        sleep after ``set_pause(True)`` is not equivalent: an in-flight
        dequeue long-poll can outlive any fixed sleep on a loaded host
        and steal the next enqueued eval."""
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

    # ------------------------------------------------------------------

    def run(self) -> None:
        while not self._stop.is_set():
            self._check_paused()
            executive = getattr(self.server, "executive", None)
            if executive is not None and not executive.enabled:
                executive = None
            pipeline = getattr(self.server, "dispatch", None)
            if (executive is not None and executive.saturated()) or (
                    pipeline is not None and pipeline.enabled
                    and pipeline.saturated()):
                # Intake backpressure (nomad_tpu_torch/admission): the
                # central accumulator already holds two full batches.
                # Draining more would only move backlog out of the
                # BOUNDED broker ready queues into the pipeline's
                # unbounded pending list, hiding it from priority
                # shedding and deadline enforcement. Nap (bounded) and
                # re-check; the stop/pause paths stay responsive.
                metrics.incr_counter(("worker", "backpressure"))
                time.sleep(BACKPRESSURE_NAP)
                continue
            start = time.monotonic()
            ev, token = self.server.eval_dequeue(
                self.server.config.enabled_schedulers, DEQUEUE_TIMEOUT
            )
            if ev is None:
                continue
            metrics.measure_since(("worker", "dequeue_eval"), start)
            factory = self.server.config.factory_for(ev.type)
            if executive is not None and is_dense_factory(factory):
                # Scheduler executive (server/executive.py): the worker
                # is only the broker's long-poll seed — the executive
                # owns the drain from here (bulk top-ups, array-side
                # reconcile, one no-park cohort dispatch). The worker
                # immediately returns to the broker for host-path work.
                executive.submit(ev, token)
                metrics.incr_counter(("worker", "executive_handoff"))
                continue
            if (pipeline is not None and pipeline.enabled
                    and is_dense_factory(factory)):
                # Central dispatch pipeline (nomad_tpu_torch/dispatch): hand
                # the eval to the leader-side accumulator — ONE drain packs
                # full batches across all workers, submits run pipelined,
                # and conflict retries rejoin the accumulating batch.
                # This worker immediately returns to the broker for
                # more (host-path evals keep flowing meanwhile).
                pipeline.submit(ev, token)
                metrics.incr_counter(("worker", "pipeline_handoff"))
                continue
            self._process_eval(ev, token, factory)

    def _process_eval(self, ev: Evaluation, token: str,
                      factory: Optional[str] = None) -> None:
        start = time.monotonic()
        if not self._wait_for_index(
                max(ev.modify_index, self.server.snapshot_min_index()),
                timeout=5.0):
            self._safe_nack(ev.id, token)
            return
        metrics.measure_since(("worker", "wait_for_index"), start)
        start = time.monotonic()
        try:
            self._invoke_scheduler(ev, token, factory)
        except Exception:
            self.logger.exception("eval %s failed", ev.id)
            self._safe_nack(ev.id, token)
            return
        finally:
            metrics.measure_since(("worker", "invoke_scheduler", ev.type), start)
            trace.record_span(ev.id, trace.STAGE_SCHED_PROCESS, start,
                              ann={"path": "worker"},
                              trace_id=ev.trace_id)
        try:
            self.server.eval_ack(ev.id, token)
        except ValueError:
            pass  # nack timer fired concurrently

    def _safe_nack(self, eval_id: str, token: str) -> None:
        try:
            self.server.eval_nack(eval_id, token)
        except ValueError:
            pass

    def _wait_for_index(self, index: int, timeout: float) -> bool:
        """Local FSM catch-up with jittered exponential backoff
        (worker.go:214,503; policy in utils/backoff.py)."""
        return poll_until(
            lambda: self.server.fsm.state.latest_index() >= index,
            timeout, stop=self._stop,
            base=BACKOFF_BASE, max_delay=BACKOFF_LIMIT)

    def _invoke_scheduler(self, ev: Evaluation, token: str,
                          factory: Optional[str] = None) -> None:
        snapshot = self.server.fsm.state.snapshot()
        if factory is None:
            factory = self.server.config.factory_for(ev.type)
        session = EvalSession(self, ev, token)
        # Independent PRNG per eval: workers running concurrently must
        # not share tie-break streams (duplicate streams would correlate
        # their placements, spiking plan conflicts); seeding from the OS
        # keeps this race-free across the worker threads.
        rng = random.Random(int.from_bytes(os.urandom(8), "little"))
        sched = new_scheduler(factory, self.logger, snapshot, session, rng=rng)
        sched.process_eval(ev)
