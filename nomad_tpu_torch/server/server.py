"""Server: composition of the control plane + RPC-endpoint methods.

Reference: nomad/server.go:69 (Server, NewServer:169), leader-only
services (leader.go:108 establishLeadership), and the RPC endpoints
(job_endpoint.go, node_endpoint.go, eval_endpoint.go, plan_endpoint.go,
alloc_endpoint.go). In dev mode a single in-process server is its own
leader over a DevLog.

The port of the JAX package's server/server.py in dev mode: the broker,
blocked evals, plan queue and applier, workers, the dispatch pipeline,
admission, heartbeats, periodic dispatch, core GC and vault. Not carried
yet: the scheduler executive and the defrag loop (``ServerConfig(
scheduler_executive=True)`` and ``defrag_enabled=True`` raise), the read
plane (the HTTP API's), and the multi-server entry points (raft, serf,
leader forwarding): dev mode is the only mode, so every leader-only
operation runs on this server.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, List, Optional, Tuple

from ..scheduler import register_scheduler
from ..structs import (
    Allocation,
    Evaluation,
    Job,
    Node,
    Plan,
    PlanResult,
    consts,
    new_eval,
)
from ..utils.ids import generate_uuid
from ..utils.pool import WorkPool
from .. import trace
from . import fsm as fsm_msgs
from .blocked import BlockedEvals
from .broker import FAILED_QUEUE, EvalBroker
from ..gang import gang_stats as _gang_stats
from ..kernels.quality import get_board as _quality_board
from ..migrate import churn_stats as _churn_stats
from ..models.resident import device_state_stats as _device_state_stats
from ..profile import get_profiler as _get_profiler
from .config import ServerConfig
from .core_gc import CoreScheduler
from .fsm import FSM, DevLog
from .heartbeat import HeartbeatTimers
from .periodic import PeriodicDispatch
from .plan_apply import PlanApplier
from .plan_queue import PlanQueue
from .worker import Worker

# Options whose parts are still to be ported: each names its queued
# item, and a config that asks for one is refused, never ignored.
NOT_PORTED = (
    ("scheduler_executive",
     "the scheduler executive (server/executive.py) is not ported yet"),
    ("defrag_enabled",
     "the continuous defrag loop (defrag DefragLoop) is not ported yet"),
)


class Server:
    def __init__(self, config: Optional[ServerConfig] = None):
        self.config = config or ServerConfig()
        for option, reason in NOT_PORTED:
            if getattr(self.config, option):
                raise NotImplementedError(
                    f"ServerConfig({option}=True): {reason}")
        self.logger = logging.getLogger("nomad_tpu_torch.server")

        self.fsm = FSM()
        self.log = DevLog(self.fsm)
        self.broker = EvalBroker(
            self.config.eval_nack_timeout, self.config.eval_delivery_limit,
            ready_cap=self.config.eval_ready_cap,
            ready_caps=self.config.eval_ready_caps,
        )
        self.blocked_evals = BlockedEvals(self.broker.enqueue_all)
        self.plan_queue = PlanQueue()
        self.plan_applier = PlanApplier(
            self.plan_queue, self.fsm, self.log,
            pool_size=self.config.plan_verify_workers,
        )
        self.heartbeats = HeartbeatTimers(self)
        self.periodic = PeriodicDispatch(self)
        self.workers: List[Worker] = []
        # Shared pool for the dispatch pipeline's fan-out: batch members
        # must run concurrently (the batcher coalesces their blocked
        # place() calls into one device dispatch) but thread-per-eval at
        # storm rates is churn — a fixed ceiling of persistent daemon
        # workers serves every batch. The pipeline fans a full batch out
        # per in-flight slot; a pool smaller than that would strand
        # batch members behind their own batch's dispatch. +1 per slot
        # for the launch prologue itself — it runs on this pool too (the
        # dispatcher thread must never block), and its FSM catch-up may
        # stall the full wait-for-index timeout.
        self.eval_pool = WorkPool(
            max(2, min(192, (self.config.eval_batch_size + 1)
                       * max(1, self.config.dispatch_max_inflight))),
            name="eval-batch")
        # Central dispatch pipeline for dense-path evals (dispatch/):
        # workers hand dense evals here; the pipeline drains the rest
        # of the broker centrally, packs full device batches, and
        # folds plan-conflict retries back into the accumulating batch.
        from ..dispatch import DispatchPipeline

        self.dispatch = DispatchPipeline(self)
        # Overload protection (admission/): pressure monitor +
        # token-bucket intake control. There is no device-path breaker.
        from ..admission import AdmissionController

        self.admission = AdmissionController(self, self.config)
        # Contention observatory (profile/): process-global like the
        # recorder; configure() flips recording and the GIL sampler
        # without dropping lock registrations.
        _get_profiler().configure(
            enabled=self.config.profile_enabled,
            sampler_interval=self.config.gil_sampler_interval,
        )
        # Device-resident node state (models/resident.py): process-
        # global like the batcher's device cache it fronts; configure()
        # updates policy without dropping counters.
        from ..models.resident import configure as configure_resident

        configure_resident(
            enabled=self.config.device_resident,
            rebuild_rows=self.config.resident_rebuild_rows,
        )
        # Placement kernel (kernels/): validate HERE, not at first
        # eval — a typo'd placement_kernel fails server init loudly
        # with the registered-kernel list. Only an EXPLICIT choice
        # flips the process-global active kernel.
        from ..kernels import configure as configure_kernels

        configure_kernels(self.config.placement_kernel)
        # Churn control (migrate/): the migration budget and the
        # preemption policy are process-global; the pressure probe
        # points preemption eligibility at THIS server's admission
        # signal — preemption only ever fires on a red cluster.
        from ..migrate import configure as configure_migrate

        configure_migrate(
            migrate_max_parallel=self.config.migrate_max_parallel,
            preemption_enabled=self.config.preemption_enabled,
            preempt_priority_threshold=self.config.preempt_priority_threshold,
            pressure_probe=self.admission.level,
        )
        self._leader = False
        self._shutdown = False
        self._gc_threads: List[threading.Timer] = []
        self._telemetry_stop: Optional[threading.Event] = None
        # Vault token authority (vault.go): the HTTP provider when an
        # address is configured, else the in-process stub so the
        # derive→renew→revoke lifecycle works without an external
        # service.
        self.vault = None
        if self.config.vault_enabled:
            if self.config.vault_addr:
                from .vault import HTTPVaultProvider, VaultError

                provider = HTTPVaultProvider(
                    self.config.vault_addr, self.config.vault_token,
                    ttl=self.config.vault_token_ttl,
                    allowed_policies=self.config.vault_allowed_policies,
                )
                try:
                    # Startup check of our own token (vault.go
                    # establishConnection): surfaces a bad/revoked token
                    # now, not at the first task derive. Vault being
                    # temporarily down is not fatal — the renewal loop
                    # keeps retrying.
                    provider.validate()
                except VaultError as e:
                    self.logger.error("vault token validation failed: %s", e)
                provider.start_renewal()
                self.vault = provider
            else:
                from .vault import StubVault

                self.vault = StubVault(
                    ttl=self.config.vault_token_ttl,
                    allowed_policies=self.config.vault_allowed_policies,
                )

        self._register_core_scheduler()

    def _register_core_scheduler(self) -> None:
        server = self

        def factory(logger, state, planner, rng=None):
            return CoreScheduler(logger, state, planner, rng=rng, server=server)

        register_scheduler("_core", factory)

    # ------------------------------------------------------- lifecycle

    def start(self) -> None:
        """Dev mode: single server, immediately leader."""
        for i in range(self.config.num_schedulers):
            worker = Worker(self, i)
            self.workers.append(worker)
            worker.start()
        self.dispatch.start()
        self.establish_leadership()
        self._start_telemetry()

    def _start_telemetry(self) -> None:
        """Periodic broker/plan-queue/heartbeat gauges (the reference
        leader loops emit these via go-metrics, eval_broker.go:650,
        server.go:262-271)."""
        from ..utils import metrics

        if self.config.statsd_addr:
            metrics.get_metrics().add_statsd(self.config.statsd_addr)

        def emit():
            while not self._telemetry_stop.wait(self.config.telemetry_interval):
                try:
                    # Dispatch-pipeline gauges are per-server, so they
                    # emit before the leader-only gate below.
                    if self.dispatch.enabled:
                        d = self.dispatch.stats()
                        metrics.set_gauge(
                            ("dispatch", "occupancy"), d["occupancy"])
                        metrics.set_gauge(
                            ("dispatch", "retries_per_eval"),
                            d["retries_per_eval"])
                        metrics.set_gauge(
                            ("dispatch", "in_flight"), d["in_flight"])
                        metrics.set_gauge(
                            ("dispatch", "pending"), d["pending"])
                    # Pressure level is per-server too; snapshot()
                    # refreshes the cached level and emits the gauge
                    # itself.
                    self.admission.pressure.snapshot()
                    # Device-resident state is process-global (the
                    # batcher's device cache serves every server in
                    # this process): staleness rebuilds and upload
                    # traffic must be visible on a live server.
                    ds = _device_state_stats()
                    metrics.set_gauge(
                        ("device_state", "full_rebuilds"),
                        ds["full_rebuilds"])
                    metrics.set_gauge(
                        ("device_state", "stale_rebuilds"),
                        ds["stale_rebuilds"])
                    metrics.set_gauge(
                        ("device_state", "delta_updates"),
                        ds["delta_updates"])
                    metrics.set_gauge(
                        ("device_state", "upload_bytes"),
                        ds["upload_bytes"])
                    # Placement-quality gauges (kernels/quality.py):
                    # the active kernel's committed-plan medians plus
                    # the queueing p99, so a kernel rollout's quality
                    # shift shows up on a dashboard.
                    pq = _quality_board().snapshot()
                    metrics.set_gauge(
                        ("placement_quality", "queueing_delay_ms"),
                        pq["queueing_delay_ms"])
                    for kname, q in pq["kernels"].items():
                        metrics.set_gauge(
                            ("placement_quality", kname,
                             "fragmentation"), q["fragmentation"])
                        metrics.set_gauge(
                            ("placement_quality", kname,
                             "binpack_score"), q["binpack_score"])
                    # Per-interval quality window (kernels/quality.py
                    # window_snapshot): each emission publishes the
                    # medians of the samples since the LAST emission
                    # then re-marks, with no client-side delta math.
                    pw = _quality_board().window_snapshot(reset=True)
                    metrics.set_gauge(
                        ("placement_quality", "window",
                         "queueing_delay_ms"), pw["queueing_delay_ms"])
                    for kname, q in pw["kernels"].items():
                        metrics.set_gauge(
                            ("placement_quality", kname,
                             "window_fragmentation"),
                            q["fragmentation"])
                        metrics.set_gauge(
                            ("placement_quality", kname,
                             "window_binpack_score"),
                            q["binpack_score"])
                    if not self._leader:
                        # Broker/plan-queue/heartbeats are leader-only
                        # (eval_broker.go:650 runs in the leader loop).
                        continue
                    broker = self.broker.stats()
                    metrics.set_gauge(("broker", "shed"), broker["shed"])
                    metrics.set_gauge(("broker", "expired"), broker["expired"])
                    metrics.set_gauge(("broker", "total_ready"), broker["total_ready"])
                    metrics.set_gauge(("broker", "total_unacked"), broker["total_unacked"])
                    metrics.set_gauge(("broker", "total_blocked"), broker["total_blocked"])
                    metrics.set_gauge(
                        ("blocked_evals", "total_blocked"),
                        self.blocked_evals.stats()["total_blocked"],
                    )
                    metrics.set_gauge(("plan", "queue_depth"), self.plan_queue.depth())
                    metrics.set_gauge(("heartbeat", "active"), self.heartbeats.count())
                except Exception:  # noqa: BLE001 — telemetry must not die
                    self.logger.exception("telemetry emit failed")

        self._telemetry_stop = threading.Event()
        t = threading.Thread(target=emit, name="telemetry", daemon=True)
        t.start()
        self._telemetry_thread = t

    def _reset_heartbeat(self, node_id: str) -> float:
        return self.heartbeats.reset_timer(node_id)

    def _clear_heartbeat(self, node_id: str) -> None:
        self.heartbeats.clear_timer(node_id)

    def shutdown(self) -> None:
        self._shutdown = True
        if self._telemetry_stop is not None:
            self._telemetry_stop.set()
        self.revoke_leadership()
        self.dispatch.stop()
        for w in self.workers:
            w.stop()
        if self.vault is not None and hasattr(self.vault, "stop"):
            self.vault.stop()  # own-token renewal loop

    def is_leader(self) -> bool:
        return self._leader

    def establish_leadership(self) -> None:
        """Enable leader-only services and restore their state
        (leader.go:108)."""
        self._leader = True
        self.plan_queue.set_enabled(True)
        self.plan_applier.start()
        self.broker.set_enabled(True)
        self.blocked_evals.set_enabled(True)
        self.fsm.broker = self.broker
        self.fsm.blocked_evals = self.blocked_evals
        self.fsm.periodic = self.periodic
        self.periodic.set_enabled(True)
        self.heartbeats.set_enabled(True)
        self.heartbeats.initialize()
        self._restore_evals()
        self._restore_periodic()
        self._schedule_gc()
        self._start_eval_hygiene()
        # Pause 3/4 of the workers on the leader (leader.go:111-117).
        if len(self.workers) > 1:
            for w in self.workers[: len(self.workers) * 3 // 4]:
                w.set_pause(True)

    def revoke_leadership(self) -> None:
        self._leader = False
        # Drain FIRST, while the broker still accepts nacks: the
        # pipeline's accumulated evals go back to the ready queue (a
        # later establish_leadership re-seeds from state through
        # _restore_evals) — either way no eval is lost with the batch.
        self.dispatch.drain()
        self._stop_eval_hygiene()
        for timer in self._gc_threads:
            timer.cancel()
        self._gc_threads = []
        self.fsm.broker = None
        self.fsm.blocked_evals = None
        self.fsm.periodic = None
        self.broker.set_enabled(False)
        self.blocked_evals.set_enabled(False)
        self.plan_applier.stop()
        self.plan_queue.set_enabled(False)
        self.periodic.set_enabled(False)
        self.heartbeats.set_enabled(False)
        for w in self.workers:
            w.set_pause(False)

    def _restore_evals(self) -> None:
        """Re-seed broker/blocked-evals from state on failover
        (leader.go:192 restoreEvals)."""
        for ev in self.fsm.state.evals():
            if ev.should_enqueue():
                self.broker.enqueue(ev)
            elif ev.should_block():
                self.blocked_evals.block(ev)

    def _restore_periodic(self) -> None:
        for job in self.fsm.state.jobs_by_periodic(True):
            self.periodic.add(job)

    # ------------------------------------------------------ eval hygiene

    def _start_eval_hygiene(self) -> None:
        """Leader-only janitors (leader.go:369 reapFailedEvaluations,
        :407 reapDupBlockedEvaluations, :441 periodicUnblockFailedEvals):
        without them, delivery-limit evals sit in the broker's `_failed`
        queue forever and displaced duplicate blocked evals leak in the
        state store as pending-looking work."""
        # The epoch's stop event rides in as a thread ARG: reading
        # self._hygiene_stop from the thread body would race a fast
        # revoke->re-establish (the body could bind the NEW epoch's
        # event and never see its own stop, leaving duplicate janitors
        # racing on the failed queue).
        stop = threading.Event()
        self._hygiene_stop = stop
        self._hygiene_threads = [
            threading.Thread(target=self._reap_failed_evals, args=(stop,),
                             daemon=True, name="eval-reap-failed"),
            threading.Thread(target=self._blocked_evals_hygiene,
                             args=(stop,),
                             daemon=True, name="eval-reap-dup"),
        ]
        for t in self._hygiene_threads:
            t.start()

    def _stop_eval_hygiene(self) -> None:
        stop = getattr(self, "_hygiene_stop", None)
        if stop is not None:
            stop.set()

    def _reap_failed_evals(self, stop: threading.Event) -> None:
        """Mark delivery-limit evals status=failed through the log, then
        ack them out of the broker. On a log error the eval stays
        unacked — its nack timer re-parks it on the failed queue and a
        later pass retries."""
        while self._leader and not self._shutdown and not stop.is_set():
            ev, token = self.broker.dequeue([FAILED_QUEUE], timeout=0.5)
            if ev is None:
                continue
            updated = ev.copy()
            updated.status = consts.EVAL_STATUS_FAILED
            if not updated.status_description:
                # Dead-lettered evals arrive pre-stamped by the broker
                # (delivery count + original trigger); keep that richer
                # reason and only synthesize one for legacy parks.
                updated.status_description = (
                    "evaluation reached delivery limit "
                    f"({self.config.eval_delivery_limit})")
            try:
                self.eval_update([updated])
                self.broker.ack(ev.id, token)
            except Exception:  # noqa: BLE001 - leader flap mid-reap
                self.logger.exception("failed-eval reap of %s", ev.id)

    def _blocked_evals_hygiene(self, stop: threading.Event) -> None:
        """Cancel duplicate blocked evals (newer eval displaced them in
        BlockedEvals) and periodically release max-plan-failure evals
        back to the ready queue."""
        next_unblock = (
            time.monotonic() + self.config.failed_eval_unblock_interval)
        while self._leader and not self._shutdown and not stop.is_set():
            dups = self.blocked_evals.get_duplicates()
            if dups:
                cancelled = []
                for ev in dups:
                    upd = ev.copy()
                    upd.status = consts.EVAL_STATUS_CANCELLED
                    upd.status_description = (
                        "evaluation is outdated: duplicate blocked eval")
                    cancelled.append(upd)
                try:
                    self.eval_update(cancelled)
                except Exception:  # noqa: BLE001 - leader flap mid-reap
                    self.logger.exception("duplicate blocked-eval reap")
            if time.monotonic() >= next_unblock:
                next_unblock = (time.monotonic()
                                + self.config.failed_eval_unblock_interval)
                self.blocked_evals.unblock_failed()
            stop.wait(0.1)

    # ------------------------------------------------------------ jobs

    def job_register(
        self, job: Job, triggered_by: str = consts.EVAL_TRIGGER_JOB_REGISTER,
        enforce_index: bool = False, job_modify_index: int = 0,
    ) -> Tuple[str, int]:
        """Job.Register (job_endpoint.go:41): validate, optionally gate
        on the job-modify index (:60-79, the `plan`→`run -check-index`
        safe-deploy flow), commit the job, then commit its evaluation
        (periodic parents get no eval)."""
        job.canonicalize()
        errors = job.validate()
        if errors:
            raise ValueError("; ".join(errors))
        # Vault policy check at submit time (job_endpoint.go:84-120):
        # reject jobs asking for policies the authority won't grant, so
        # the failure surfaces at register instead of at task prestart.
        for tg in job.task_groups:
            for task in tg.tasks:
                if task.vault is None:
                    continue
                if self.vault is None:
                    raise ValueError(
                        f"task {task.name!r} has a vault block but vault "
                        "is not enabled"
                    )
                if not task.vault.policies:
                    raise ValueError(
                        f"task {task.name!r} vault block needs policies"
                    )
                if "root" in task.vault.policies:
                    raise ValueError("root policy is not allowed for tasks")
                allowed = getattr(self.vault, "allowed_policies", None)
                if allowed is not None:
                    bad = [p for p in task.vault.policies if p not in allowed]
                    if bad:
                        raise ValueError(f"vault policies not allowed: {bad}")
        # The enforce-index gate is decided inside the FSM apply (same
        # log position -> same verdict on every replica), which makes
        # check+commit atomic.
        payload = {"job": job}
        if enforce_index:
            payload["enforce_index"] = True
            payload["job_modify_index"] = job_modify_index
        index = self.log.apply(fsm_msgs.JOB_REGISTER, payload)
        if enforce_index:
            self._wait_applied(index)
            err = self.fsm.outcome(index)
            if err is not None:
                raise ValueError(str(err))

        if job.is_periodic():
            return "", index

        stored = self.fsm.state.job_by_id(job.id)
        ev = new_eval(stored, triggered_by)
        self.eval_update([ev])
        return ev.id, index

    def _wait_applied(self, index: int, timeout: float = 5.0) -> None:
        """Wait until the local FSM has applied `index`."""
        from ..utils.backoff import poll_until

        if not poll_until(lambda: self.fsm.last_applied_index >= index,
                          timeout, base=0.005, max_delay=0.1):
            raise TimeoutError(f"timed out waiting for index {index}")

    def job_deregister(self, job_id: str, create_eval: bool = True) -> Optional[str]:
        job = self.fsm.state.job_by_id(job_id)
        self.log.apply(fsm_msgs.JOB_DEREGISTER, {"job_id": job_id})
        if not create_eval or job is None or job.is_periodic():
            return None
        ev = Evaluation(
            id=generate_uuid(),
            priority=job.priority,
            type=job.type,
            triggered_by=consts.EVAL_TRIGGER_JOB_DEREGISTER,
            job_id=job_id,
            job_modify_index=job.job_modify_index,
            status=consts.EVAL_STATUS_PENDING,
        )
        self.eval_update([ev])
        return ev.id

    def job_evaluate(self, job_id: str) -> str:
        """Job.Evaluate: force a new evaluation (job_endpoint.go:236)."""
        job = self.fsm.state.job_by_id(job_id)
        if job is None:
            raise ValueError(f"job {job_id!r} not found")
        if job.is_periodic():
            raise ValueError("can't evaluate periodic job")
        ev = new_eval(job, consts.EVAL_TRIGGER_JOB_REGISTER)
        self.eval_update([ev])
        return ev.id

    def job_plan(self, job: Job, diff: bool = False, contextual: bool = False) -> dict:
        """Job.Plan dry-run (job_endpoint.go:545): run a real scheduler
        against a snapshot through the Harness; nothing commits."""
        from ..scheduler.testing import Harness

        job.canonicalize()
        errors = job.validate()
        if errors:
            raise ValueError("; ".join(errors))

        # Shadow copy of state with the updated job injected at index+1;
        # the real store is never written (job_endpoint.go:584).
        from ..state import StateStore

        snap_store = self.fsm.state
        shadow_store = StateStore.restore(snap_store.persist())
        # The shadow store is a private dry-run copy seeded from a
        # snapshot — nothing it absorbs is replicated state.
        shadow_store.upsert_job(snap_store.latest_index() + 1, job)
        harness = Harness(state=shadow_store)
        harness._next_index = shadow_store.latest_index() + 1

        ev = new_eval(shadow_store.job_by_id(job.id), consts.EVAL_TRIGGER_JOB_REGISTER)
        ev.annotate_plan = True

        factory = self.config.factory_for(job.type)
        from ..scheduler import new_scheduler

        sched = new_scheduler(factory, self.logger, shadow_store.snapshot(), harness)
        sched.process_eval(ev)

        annotations = None
        failed = {}
        if harness.plans:
            plan = harness.plans[-1]
            if plan.annotations is not None:
                annotations = plan.annotations
            failed = plan.failed_tg_allocs
        if harness.evals:
            failed = harness.evals[-1].failed_tg_allocs or failed

        old_job = snap_store.job_by_id(job.id)
        result = {
            "annotations": annotations,
            "failed_tg_allocs": failed,
            "next_periodic_launch": (
                job.periodic.next_launch(time.time()) if job.is_periodic() else None
            ),
            "index": snap_store.latest_index(),
            # Gate value for `run -check-index` (job_endpoint.go:626-630).
            "job_modify_index": old_job.job_modify_index if old_job is not None else 0,
        }
        if diff:
            from ..structs.diff import annotate as annotate_diff
            from ..structs.diff import job_diff

            jd = job_diff(old_job, job, contextual=contextual)
            annotate_diff(jd, annotations)
            result["diff"] = jd
        return result

    # ----------------------------------------------------------- nodes

    def node_register(self, node: Node) -> float:
        """Node.Register (node_endpoint.go:51). Returns the heartbeat
        TTL granted."""
        if not node.id:
            raise ValueError("missing node ID")
        if not node.datacenter:
            raise ValueError("missing datacenter")
        if not node.secret_id:
            node.secret_id = generate_uuid()
        existing = self.fsm.state.node_by_id(node.id)
        self.log.apply(fsm_msgs.NODE_REGISTER, {"node": node})
        # Transitioning to ready re-schedules its jobs.
        if existing is not None and existing.status != node.status:
            self._create_node_evals(node.id)
        return self._reset_heartbeat(node.id)

    def node_deregister(self, node_id: str) -> None:
        self.log.apply(fsm_msgs.NODE_DEREGISTER, {"node_id": node_id})
        self._clear_heartbeat(node_id)

    def node_update_status(self, node_id: str, status: str) -> float:
        """Node.UpdateStatus (node_endpoint.go:272): commit the status,
        fan out evals for every affected job."""
        node = self.fsm.state.node_by_id(node_id)
        if node is None:
            raise ValueError(f"node {node_id!r} not found")
        if node.status != status:
            self.log.apply(
                fsm_msgs.NODE_UPDATE_STATUS,
                {"node_id": node_id, "status": status},
            )
            self._create_node_evals(node_id)
        if status == consts.NODE_STATUS_DOWN:
            self._clear_heartbeat(node_id)
            return 0.0
        return self._reset_heartbeat(node_id)

    def node_heartbeat(self, node_id: str, secret_id: str = "") -> float:
        node = self.fsm.state.node_by_id(node_id)
        if node is None:
            raise ValueError(f"node {node_id!r} not found")
        if secret_id and node.secret_id != secret_id:
            raise PermissionError("node secret ID does not match")
        if node.status != consts.NODE_STATUS_READY:
            return self.node_update_status(node_id, consts.NODE_STATUS_READY)
        return self._reset_heartbeat(node_id)

    def node_update_drain(self, node_id: str, drain: bool) -> None:
        """Node.UpdateDrain (node_endpoint.go:374)."""
        node = self.fsm.state.node_by_id(node_id)
        if node is None:
            raise ValueError(f"node {node_id!r} not found")
        self.log.apply(
            fsm_msgs.NODE_UPDATE_DRAIN, {"node_id": node_id, "drain": drain}
        )
        if drain:
            self._create_node_evals(node_id)

    def derive_vault_token(
        self, node_id: str, secret_id: str, alloc_id: str, tasks: List[str]
    ) -> Tuple[Dict[str, str], float]:
        """Per-task vault token derivation (node_endpoint.go:940
        DeriveVaultToken): validate node secret + alloc placement + that
        each task declares a vault block, mint tokens, then commit the
        accessors through the log before handing tokens out. Returns
        ({task: token}, min ttl across minted tokens)."""
        from .vault import VaultAccessor, VaultError

        if self.vault is None:
            raise ValueError("vault is not enabled on this server")
        state = self.fsm.state
        node = state.node_by_id(node_id)
        if node is None:
            raise ValueError(f"node {node_id!r} not found")
        # A node with a secret always requires it — an empty caller
        # secret must NOT bypass authentication (minting tokens is the
        # most sensitive endpoint on the server).
        if node.secret_id and node.secret_id != secret_id:
            raise PermissionError("node secret ID does not match")
        alloc = state.alloc_by_id(alloc_id)
        if alloc is None:
            raise ValueError(f"alloc {alloc_id!r} not found")
        if alloc.node_id != node_id:
            raise PermissionError("allocation not placed on requesting node")
        if alloc.terminal_status():
            raise ValueError("cannot derive tokens for terminal allocation")
        group = alloc.job.lookup_task_group(alloc.task_group) if alloc.job else None
        by_name = {t.name: t for t in (group.tasks if group else [])}
        tokens: Dict[str, str] = {}
        accessors: List[VaultAccessor] = []
        min_ttl = float("inf")
        for task_name in tasks:
            task = by_name.get(task_name)
            if task is None or task.vault is None:
                self.vault.revoke_tokens([a.accessor for a in accessors])
                raise ValueError(
                    f"task {task_name!r} does not declare a vault block"
                )
            try:
                token, accessor, ttl = self.vault.create_token(task.vault.policies)
            except VaultError as e:
                # Revoke tokens already minted this request — a partial
                # failure must not leave live untracked credentials.
                self.vault.revoke_tokens([a.accessor for a in accessors])
                raise ValueError(str(e)) from e
            min_ttl = min(min_ttl, ttl)
            tokens[task_name] = token
            accessors.append(
                VaultAccessor(
                    accessor=accessor, alloc_id=alloc_id,
                    task=task_name, node_id=node_id,
                    policies=list(task.vault.policies),
                )
            )
        # Accessors are committed before tokens are returned, so a
        # crash can't leak untracked (unrevokable) tokens.
        self.log.apply(
            fsm_msgs.VAULT_ACCESSOR_REGISTER, {"accessors": accessors}
        )
        return tokens, (min_ttl if tokens else 0.0)

    def vault_renew(self, token: str) -> float:
        from .vault import VaultError

        if self.vault is None:
            raise ValueError("vault is not enabled on this server")
        try:
            return self.vault.renew_token(token)
        except VaultError as e:
            raise ValueError(str(e)) from e

    def revoke_vault_accessors(self, accessors: List[str]) -> None:
        """Revoke at the authority, then drop the tracking rows
        (vault.go RevokeTokens + fsm deregister)."""
        if not accessors:
            return
        if self.vault is not None:
            self.vault.revoke_tokens(accessors)
        self.log.apply(
            fsm_msgs.VAULT_ACCESSOR_DEREGISTER, {"accessors": accessors}
        )

    def node_update_allocs(self, allocs: List[Allocation]) -> int:
        """Node.UpdateAlloc: client-reported status sync
        (node_endpoint.go:664)."""
        return self.log.apply(fsm_msgs.ALLOC_CLIENT_UPDATE, {"allocs": allocs})

    def _create_node_evals(self, node_id: str) -> List[str]:
        """One eval per job with allocs on the node, plus every system
        job (node_endpoint.go:812 createNodeEvals)."""
        node = self.fsm.state.node_by_id(node_id)
        node_index = node.modify_index if node else 0
        evals: List[Evaluation] = []
        seen_jobs = set()
        for alloc in self.fsm.state.allocs_by_node(node_id):
            if alloc.job_id in seen_jobs or alloc.job is None:
                continue
            seen_jobs.add(alloc.job_id)
            evals.append(
                Evaluation(
                    id=generate_uuid(),
                    priority=alloc.job.priority,
                    type=alloc.job.type,
                    triggered_by=consts.EVAL_TRIGGER_NODE_UPDATE,
                    job_id=alloc.job_id,
                    job_modify_index=alloc.job.job_modify_index,
                    node_id=node_id,
                    node_modify_index=node_index,
                    status=consts.EVAL_STATUS_PENDING,
                )
            )
        for job in self.fsm.state.jobs_by_scheduler(consts.JOB_TYPE_SYSTEM):
            if job.id in seen_jobs:
                continue
            evals.append(
                Evaluation(
                    id=generate_uuid(),
                    priority=job.priority,
                    type=job.type,
                    triggered_by=consts.EVAL_TRIGGER_NODE_UPDATE,
                    job_id=job.id,
                    job_modify_index=job.job_modify_index,
                    node_id=node_id,
                    node_modify_index=node_index,
                    status=consts.EVAL_STATUS_PENDING,
                )
            )
        if evals:
            self.eval_update(evals)
        return [e.id for e in evals]

    # ----------------------------------------------------------- evals

    def eval_update(self, evals: List[Evaluation], token: str = "") -> int:
        # Deadline stamping at the creation funnel: every fresh pending
        # eval passes through here before the FSM commit that enqueues
        # it. stamp() is a no-op on terminal/already-stamped evals, so
        # status re-commits of existing evals pass through untouched.
        ttl = self.config.eval_deadline_ttl
        if ttl > 0:
            from ..admission import deadline as _deadline

            now = time.time()
            for ev in evals:
                _deadline.stamp(ev, ttl, now)
        return self.log.apply(
            fsm_msgs.EVAL_UPDATE, {"evals": evals, "token": token}
        )

    def eval_dequeue(
        self, schedulers: List[str], timeout: float
    ) -> Tuple[Optional[Evaluation], str]:
        return self.broker.dequeue(schedulers, timeout)

    def eval_dequeue_many(
        self, schedulers: List[str], max_n: int
    ) -> List[Tuple[Evaluation, str]]:
        """Non-blocking drain of additional ready evals (dense-backend
        batch path; see broker.dequeue_many)."""
        if max_n <= 0:
            return []
        return self.broker.dequeue_many(schedulers, max_n)

    def eval_ack(self, eval_id: str, token: str) -> None:
        self.broker.ack(eval_id, token)

    def eval_nack(self, eval_id: str, token: str) -> None:
        self.broker.nack(eval_id, token)

    def eval_pause_nack(self, eval_id: str, token: str) -> None:
        self.broker.pause_nack_timeout(eval_id, token)

    def eval_resume_nack(self, eval_id: str, token: str) -> None:
        self.broker.resume_nack_timeout(eval_id, token)

    def eval_outstanding(self, eval_id: str) -> Optional[str]:
        return self.broker.outstanding(eval_id)

    def eval_reap(self, eval_ids: List[str], alloc_ids: List[str]) -> int:
        # Reaped allocs take their derived vault tokens with them
        # (core_sched GC → vault.go RevokeTokens → accessor dereg).
        accessors = [
            a.accessor
            for alloc_id in alloc_ids
            for a in self.fsm.state.vault_accessors_by_alloc(alloc_id)
        ]
        self.revoke_vault_accessors(accessors)
        return self.log.apply(
            fsm_msgs.EVAL_DELETE, {"eval_ids": eval_ids, "alloc_ids": alloc_ids}
        )

    # ------------------------------------------------------------ plans

    def plan_submit(self, plan: Plan) -> PlanResult:
        """Plan.Submit (plan_endpoint.go:16). The eval token is the
        split-brain guard: it must still be the outstanding token."""
        token = self.broker.outstanding(plan.eval_id)
        if token != plan.eval_token:
            raise ValueError("plan's eval token does not match outstanding eval")
        pending = self.plan_queue.enqueue(plan)
        return pending.wait(timeout=30.0)

    # --------------------------------------------------------- periodic

    def periodic_launch_record(self, job_id: str, launch: float) -> None:
        self.log.apply(
            fsm_msgs.PERIODIC_LAUNCH, {"job_id": job_id, "launch": launch}
        )

    def periodic_force(self, job_id: str) -> Optional[str]:
        return self.periodic.force_run(job_id)

    # --------------------------------------------------------------- gc

    def _core_eval(self, core_job_id: str) -> Evaluation:
        return Evaluation(
            id=generate_uuid(),
            priority=consts.CORE_JOB_PRIORITY,
            type=consts.JOB_TYPE_CORE,
            triggered_by=consts.EVAL_TRIGGER_SCHEDULED,
            job_id=core_job_id,
            status=consts.EVAL_STATUS_PENDING,
        )

    def force_gc(self) -> None:
        """System.GC endpoint (system_endpoint.go:16)."""
        self.broker.enqueue(self._core_eval(consts.CORE_JOB_FORCE_GC))

    def _schedule_gc(self) -> None:
        """Leader GC timers enqueue core-job evals on their intervals
        (leader.go schedulePeriodic)."""

        def tick(core_job: str, interval: float):
            if not self._leader or self._shutdown:
                return
            self.broker.enqueue(self._core_eval(core_job))
            timer = threading.Timer(interval, tick, args=(core_job, interval))
            timer.daemon = True
            self._gc_threads.append(timer)
            timer.start()

        for core_job, interval in (
            (consts.CORE_JOB_EVAL_GC, self.config.eval_gc_interval),
            (consts.CORE_JOB_JOB_GC, self.config.job_gc_interval),
            (consts.CORE_JOB_NODE_GC, self.config.node_gc_interval),
        ):
            timer = threading.Timer(interval, tick, args=(core_job, interval))
            timer.daemon = True
            self._gc_threads.append(timer)
            timer.start()

    # ------------------------------------------------------------ stats

    def stats(self) -> Dict[str, object]:
        return {
            "leader": self._leader,
            "last_index": self.log.last_index(),
            "broker": self.broker.stats(),
            "blocked_evals": self.blocked_evals.stats(),
            "plan_queue_depth": self.plan_queue.depth(),
            "heartbeat_timers": self.heartbeats.count(),
            "num_workers": len(self.workers),
            "dispatch_pipeline": self.dispatch.stats(),
            "plan_applier": self.plan_applier.stats(),
            # Overload-protection surface (admission/): pressure level
            # + reasons and intake-bucket stats.
            "admission": self.admission.snapshot(),
            # Per-stage eval-lifecycle latency table (trace/):
            # count/mean/max + log-bucket p50/p95/p99 per stage, plus
            # the e2e row.
            "trace": trace.get_recorder().stage_stats(),
            # Contention observatory (profile/): per-site lock
            # wait/hold, GIL overshoot, run-queue delay, and the
            # batch-boundary convoy table.
            "profile": _get_profiler().snapshot(),
            # Device-resident node state (models/resident.py): delta/
            # rebuild counters and the batcher's upload tallies;
            # stale_rebuilds says how often plan-apply verification
            # had to re-anchor the delta chain.
            "device_state": _device_state_stats(),
            # Placement-quality scoreboard (kernels/quality.py):
            # per-kernel fragmentation / bin-pack medians from the
            # dense paths' committed plans + the broker-wait queueing
            # p99.
            "placement_quality": _quality_board().snapshot(),
            # Churn control (migrate/): migration-budget counters +
            # preemption staged/committed/placement tallies.
            "churn": _churn_stats(),
            # Gang scheduling (gang/): gangs placed/rejected per path;
            # the applier-side whole-gang rejections live in
            # plan_applier stats ("gangs_rejected").
            "gang": _gang_stats(),
        }
