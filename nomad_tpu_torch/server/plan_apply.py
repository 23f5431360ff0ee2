"""Plan applier: the leader's serialization point for optimistic
concurrency.

Reference: nomad/plan_apply.go:41 — a long-lived leader loop that
dequeues plans by priority, verifies each node's placements against the
latest state (fanned out over a worker pool, plan_apply_pool.go:18),
partially commits what fits, and hands workers a RefreshIndex when
their snapshot went stale. Pipelining: plan N+1 is evaluated against an
optimistic snapshot while plan N's commit is in flight
(plan_apply.go:19-39).

The port of the JAX package's server/plan_apply.py: the same per-node
checks (which the differential rig, kernels/differential.py, also
judges dense plans with) and the same applier loop.
"""

from __future__ import annotations

import logging
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

from .. import trace
from ..structs import Allocation, Plan, PlanResult, allocs_fit, consts, remove_allocs
from ..utils import metrics
from .fsm import ALLOC_UPDATE
from .plan_queue import PendingPlan, PlanQueue


def evaluate_node_preemptions(snapshot, plan: Plan, node_id: str) -> bool:
    """Per-victim verification of a preemption leg: every victim must
    still exist, be non-terminal, and be STRICTLY lower-priority than
    the plan. A victim that completed, died, or was replaced underneath
    the scheduler rejects the node — the freed-capacity discount the
    placement relied on is void, so the whole node replans on fresh
    state."""
    victims = plan.node_preemptions.get(node_id)
    if not victims:
        return True
    from ..migrate import victim_priority

    # The node's LIVE allocs through whichever view we were handed —
    # the optimistic overlay already hides in-flight evictions, so a
    # victim another pipelined plan is stopping verifies as lost here.
    live = {a.id: a
            for a in snapshot.allocs_by_node_terminal(node_id, False)}
    for victim in victims:
        stored = live.get(victim.id)
        if stored is None or stored.terminal_status():
            return False
        if victim_priority(stored) >= plan.priority:
            return False
    return True


def evaluate_node_plan(snapshot, plan: Plan, node_id: str) -> bool:
    """Whether the plan's changes to one node can be applied against the
    given state (plan_apply.go:318 evaluateNodePlan)."""
    if not evaluate_node_preemptions(snapshot, plan, node_id):
        return False
    if not plan.node_allocation.get(node_id):
        return True  # evictions only: always safe

    node = snapshot.node_by_id(node_id)
    if node is None:
        return False
    if node.status != consts.NODE_STATUS_READY or node.drain:
        return False

    from ..scheduler.util import proposed_allocs_for_node

    proposed = proposed_allocs_for_node(snapshot, plan, node_id)
    fit, _, _ = allocs_fit(node, proposed)
    return fit


class OptimisticSnapshot:
    """Base snapshot + accepted allocations of in-flight plans — the
    read view for verifying plan N+1 while plan N's commit is still in
    flight (plan_apply.go:155-161 optimistic snap.UpsertAllocs).
    Exposes exactly what evaluate_node_plan reads."""

    def __init__(self, base):
        self.base = base
        self._extra_by_node = {}  # node_id -> {alloc_id: alloc}
        self._evicted = set()  # alloc ids stopped by in-flight plans
        self._dirty = False

    def add_result(self, result: PlanResult) -> None:
        for node_id, allocs in result.node_allocation.items():
            d = self._extra_by_node.setdefault(node_id, {})
            for alloc in allocs:
                d[alloc.id] = alloc
        for allocs in result.node_update.values():
            for alloc in allocs:
                self._evicted.add(alloc.id)
        # In-flight preemption evictions hide from the next plan's
        # verification exactly like staged stops do.
        for allocs in result.node_preemptions.values():
            for alloc in allocs:
                self._evicted.add(alloc.id)
        self._dirty = True

    def node_by_id(self, node_id):
        return self.base.node_by_id(node_id)

    def latest_index(self) -> int:
        # With a commit in flight, a plan rejected off this view must
        # refresh PAST the in-flight commit — otherwise the worker's
        # "refresh" is a no-op against pre-commit state and it spins
        # resubmitting the same plan (the reference advances its
        # optimistic snapshot's index the same way).
        return self.base.latest_index() + (1 if self._dirty else 0)

    def allocs_by_node_terminal(self, node_id, terminal):
        live = {
            a.id: a
            for a in self.base.allocs_by_node_terminal(node_id, terminal)
            if a.id not in self._evicted
        }
        if not terminal:
            live.update(self._extra_by_node.get(node_id, {}))
        return list(live.values())


class PlanApplier:
    """Consumes the plan queue; runs as a leader-only thread.

    Pipelined like the reference (plan_apply.go:41-118): one raft
    commit is in flight at a time while the NEXT plan is verified
    against an optimistic snapshot that includes the in-flight plan's
    accepted allocations. A failed commit forces the following plan to
    re-verify on a fresh snapshot."""

    def __init__(self, plan_queue: PlanQueue, fsm, log, pool_size: int = 2,
                 logger: Optional[logging.Logger] = None):
        self.plan_queue = plan_queue
        self.fsm = fsm
        self.log = log
        self.logger = logger or logging.getLogger("nomad_tpu_torch.plan_apply")
        self.pool = ThreadPoolExecutor(
            max_workers=max(pool_size, 1), thread_name_prefix="plan-eval"
        )
        # Dedicated single-thread executor: commits stay ordered.
        self._commit_pool = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="plan-commit"
        )
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # The outgoing generation's thread, kept so start() can wait
        # out its final in-flight commit before spawning a successor.
        self._draining: Optional[threading.Thread] = None
        self._lifecycle = threading.Lock()  # start/stop can race on
        # leadership flaps (raft elections)
        # Conflict observability (feeds the dispatch pipeline's
        # retries-per-eval accounting and the bench's A/B column):
        # counters only ever touched on the applier thread.
        self.plans_evaluated = 0
        self.plans_rejected = 0  # plans that lost >= 1 node (refresh)
        self.nodes_rejected = 0  # node verifications that failed
        # Gang atomicity (nomad_tpu_torch/gang): whole gangs removed because
        # a member's node failed verification — every one of these is a
        # proven nothing-partial-committed event.
        self.gangs_rejected = 0

    def start(self) -> None:
        with self._lifecycle:
            # Idempotent: a re-confirmed leadership (start without an
            # intervening stop) must not spawn a second loop — with
            # per-generation stop events the first one would become
            # permanently unstoppable.
            if self._thread is not None and self._thread.is_alive():
                return
            draining, self._draining = self._draining, None
        if draining is not None and draining.is_alive():
            # Wait out the predecessor's final in-flight commit OUTSIDE
            # the lock: two live loops would verify plans against
            # snapshots that miss each other's commits — the serial
            # verification invariant the single applier exists for.
            draining.join(timeout=5.0)
            if draining.is_alive():
                # Still wedged past the bound: REFUSE to spawn a
                # concurrent successor. One missing applier stalls the
                # plan queue visibly; two live ones double-place
                # silently. The next leadership confirmation retries.
                with self._lifecycle:
                    self._draining = draining
                self.logger.error(
                    "plan applier predecessor still draining after "
                    "5s; refusing to start a concurrent loop")
                return
        with self._lifecycle:
            if self._thread is not None and self._thread.is_alive():
                return  # lost a start/start race while joining
            # Fresh Event PER thread generation: clearing a shared
            # event here could race a stop()'s set before the outgoing
            # thread observed it (stop joins OUTSIDE the lock), leaving
            # two _run loops alive after a leadership flap.
            stop = threading.Event()
            self._stop = stop
            thread = threading.Thread(
                target=self._run, args=(stop,), name="plan-applier",
                daemon=True
            )
            thread.start()
            self._thread = thread

    def stop(self) -> None:
        # Detach under the lock, join outside it: holding _lifecycle
        # across the join would block a concurrent start() for the
        # whole drain instead of serializing just the handoff. The
        # detached thread is remembered in _draining so a prompt
        # restart waits for its final commit.
        with self._lifecycle:
            self._stop.set()
            thread, self._thread = self._thread, None
            if thread is not None:
                self._draining = thread
        if thread is not None:
            thread.join(timeout=5.0)

    def _run(self, stop: Optional[threading.Event] = None) -> None:
        stop = stop if stop is not None else self._stop
        inflight = None  # (future, pending) of the in-flight commit
        optimistic: Optional[OptimisticSnapshot] = None
        while not stop.is_set():
            pending = self.plan_queue.dequeue(
                timeout=0.02 if inflight else 0.25)
            if pending is None:
                if inflight is not None:
                    self._wait_commit(inflight)
                    inflight = None
                optimistic = None  # queue drained: next gets fresh state
                continue
            if inflight is None:
                # Nothing outstanding: every plan verifies against
                # fresh state (the pre-pipelining invariant). The
                # optimistic overlay only ever spans ONE in-flight
                # commit — a rejected or no-op plan must not pin the
                # next one to a stale base.
                optimistic = OptimisticSnapshot(self.fsm.state.snapshot())
            try:
                start = time.monotonic()
                # Verified against the optimistic view WHILE the
                # previous plan's raft commit is still in flight — the
                # reference's verify-(N+1)-during-commit-(N) overlap.
                result = self._evaluate_plan(optimistic, pending.plan)
                metrics.measure_since(("plan", "evaluate"), start)
            except Exception as e:  # noqa: BLE001 - fail the one plan
                self.logger.exception("plan evaluate failed")
                pending.respond(None, e)
                continue
            if inflight is not None:
                ok = self._wait_commit(inflight)
                inflight = None
                # Rebase on committed state either way: staleness is
                # bounded to one commit's duration (the old per-plan
                # fresh snapshot invariant, now per-commit), and node
                # drains/client updates applied meanwhile are seen.
                optimistic = OptimisticSnapshot(self.fsm.state.snapshot())
                if not ok:
                    # The old view contained allocs that never landed:
                    # this plan's verification must be redone.
                    try:
                        result = self._evaluate_plan(optimistic,
                                                     pending.plan)
                    except Exception as e:  # noqa: BLE001
                        pending.respond(None, e)
                        continue
            if result.is_no_op():
                pending.respond(result, None)
                continue
            fut = self._commit_pool.submit(self._commit, pending.plan, result)
            # The waiter is answered the INSTANT the commit lands, not
            # when this loop next wakes: a worker ping-ponging plans
            # with an idle-queue applier would otherwise pay the full
            # dequeue timeout per plan in response latency (~20 ms,
            # which capped the whole control plane near 50 plans/s).
            fut.add_done_callback(self._make_responder(pending, result))
            optimistic.add_result(result)
            inflight = (fut, pending)
        if inflight is not None:
            self._wait_commit(inflight)

    @staticmethod
    def _make_responder(pending, result: PlanResult):
        def _respond(fut) -> None:
            try:
                result.alloc_index = fut.result()
                pending.respond(result, None)
            except Exception as e:  # noqa: BLE001 - fail the one plan
                pending.respond(None, e)

        return _respond

    def _wait_commit(self, inflight) -> bool:
        """Wait out an in-flight raft commit; False when it failed
        (asyncPlanWait, plan_apply.go:166). The waiter was already
        answered by the commit future's done-callback. No extra timeout
        here: log.apply has its own bounded timeouts, and abandoning a
        still-running commit would let it land after the pipeline moved
        on (double-commit on retry)."""
        fut, _pending = inflight
        try:
            fut.result()
            return True
        except Exception:  # noqa: BLE001 - logged; waiter already told
            self.logger.exception("plan commit failed")
            return False

    def _note_stale_state(self) -> None:
        """A node verification failed in a way ordinary optimistic
        concurrency cannot explain: the matrix claimed a fit that its
        OWN snapshot refutes. Mark the resident delta chain suspect so
        the next cacheable matrix build pays one full rebuild instead
        of trusting it (models/resident.py; the carve-over of the
        reference's plan_apply.go:318 exactness)."""
        from ..models.resident import note_rejection

        note_rejection()

    @staticmethod
    def _ordinary_conflict(snapshot, plan: Plan, node_id: str) -> bool:
        """Whether this node's rejection is explained by state the
        scheduler's matrix could not have seen: an in-flight pipelined
        plan's accepted allocs, or node/alloc changes committed after
        the plan's matrix watermark. True means a routine optimistic-
        concurrency loss (the replan refreshes past it) — purging the
        whole device-resident base cache for it would degenerate a
        conflict-heavy storm back into rebuild-per-snapshot. False (or
        no watermark) means the resident chain itself is suspect."""
        if plan.matrix_index < 0:
            return False
        extra = getattr(snapshot, "_extra_by_node", None)
        if extra and extra.get(node_id):
            return True
        base = getattr(snapshot, "base", snapshot)
        node = base.node_by_id(node_id)
        if node is not None and node.modify_index > plan.matrix_index:
            return True
        return any(a.modify_index > plan.matrix_index
                   for a in base.allocs_by_node(node_id))

    def _evaluate_plan(self, snapshot, plan: Plan) -> PlanResult:
        """Per-node verification with partial commit
        (plan_apply.go:194 evaluatePlan)."""
        _t0 = time.monotonic()
        result = PlanResult(
            node_update=dict(plan.node_update),
            node_allocation=dict(plan.node_allocation),
            node_preemptions=dict(plan.node_preemptions),
        )

        node_ids = (set(plan.node_update) | set(plan.node_allocation)
                    | set(plan.node_preemptions))
        futures = {
            node_id: self.pool.submit(evaluate_node_plan, snapshot, plan, node_id)
            for node_id in node_ids
        }
        self.plans_evaluated += 1
        rejected = 0
        suspect = False
        rejected_nodes = set()
        for node_id, fut in futures.items():
            if fut.result():
                continue
            # This node's changes don't fit anymore.
            rejected += 1
            metrics.incr_counter(("plan", "node_rejected"))
            if not self._ordinary_conflict(snapshot, plan, node_id):
                suspect = True
            if plan.all_at_once:
                # Whole-plan gang commit: reject everything, force a
                # refresh.
                result.node_update = {}
                result.node_allocation = {}
                result.node_preemptions = {}
                result.refresh_index = snapshot.latest_index()
                self.plans_rejected += 1
                self.nodes_rejected += rejected
                if suspect:
                    self._note_stale_state()
                trace.record_span(
                    plan.eval_id, trace.STAGE_PLAN_EVALUATE, _t0,
                    ann={"nodes_rejected": rejected, "gang": True},
                    create=False)
                return result
            rejected_nodes.add(node_id)
        # Gang atomicity leg (nomad_tpu_torch/gang): which nodes host which
        # gang's members — decided from the PLAN (gang_groups stages
        # alloc ids), applied to the RESULT below.
        gang_nodes: Dict[str, set] = {}
        if plan.gang_groups:
            id_to_gang = {aid: gk
                          for gk, ids in plan.gang_groups.items()
                          for aid in ids}
            for node_id, placed in plan.node_allocation.items():
                for alloc in placed:
                    gk = id_to_gang.get(alloc.id)
                    if gk is not None:
                        gang_nodes.setdefault(gk, set()).add(node_id)
        for node_id in rejected_nodes:
            result.node_update.pop(node_id, None)
            result.node_allocation.pop(node_id, None)
            result.node_preemptions.pop(node_id, None)
            result.refresh_index = snapshot.latest_index()
        # All-K-or-nothing: a gang with ANY member on a rejected node
        # loses EVERY member — filtered off accepted nodes too.
        # Removing allocs only frees capacity, so the surviving
        # placements that verified alongside them still fit.
        doomed = sorted(gk for gk, nodes in gang_nodes.items()
                        if nodes & rejected_nodes)
        for gk in doomed:
            ids = set(plan.gang_groups.get(gk, ()))
            for node_id in sorted(gang_nodes[gk] - rejected_nodes):
                placed = result.node_allocation.get(node_id)
                if not placed:
                    continue
                kept = [a for a in placed if a.id not in ids]
                if kept:
                    result.node_allocation[node_id] = kept
                else:
                    del result.node_allocation[node_id]
            result.refresh_index = snapshot.latest_index()
        if doomed:
            self.gangs_rejected += len(doomed)
            metrics.incr_counter(("plan", "gang_rejected"), len(doomed))
        if rejected:
            self.plans_rejected += 1
            self.nodes_rejected += rejected
            if suspect:
                self._note_stale_state()
        # create=False: the applier serves remote (follower-worker)
        # plans too — their lifecycle trace lives in the follower's
        # process, not this one.
        ann = None
        if rejected or doomed:
            ann = {"nodes_rejected": rejected}
            if doomed:
                ann["gangs_rejected"] = len(doomed)
        trace.record_span(
            plan.eval_id, trace.STAGE_PLAN_EVALUATE, _t0,
            ann=ann, create=False)
        return result

    def stats(self) -> dict:
        """Conflict counters: how often optimistic plans lost node
        verifications (each rejection is a replan round-trip somewhere
        upstream — the dispatch pipeline's A/B measures these)."""
        return {
            "plans_evaluated": self.plans_evaluated,
            "plans_rejected": self.plans_rejected,
            "nodes_rejected": self.nodes_rejected,
            "gangs_rejected": self.gangs_rejected,
        }

    def _commit(self, plan: Plan, result: PlanResult) -> int:
        start = time.monotonic()
        allocs: List[Allocation] = []
        for update_list in result.node_update.values():
            allocs.extend(update_list)
        n_preempted = 0
        for victim_list in result.node_preemptions.values():
            # Victims ride the SAME raft apply as the placements they
            # make room for: one log entry, one terminal stamp — the
            # exactly-once contract the preemption soak asserts.
            allocs.extend(victim_list)
            n_preempted += len(victim_list)
        for alloc_list in result.node_allocation.values():
            allocs.extend(alloc_list)
        index = self.log.apply(
            ALLOC_UPDATE, {"allocs": allocs, "job": plan.job}
        )
        if n_preempted:
            from ..migrate import note_preemption_committed

            note_preemption_committed(n_preempted)
        trace.record_span(plan.eval_id, trace.STAGE_PLAN_COMMIT, start,
                          ann={"allocs": len(allocs)}, create=False)
        # Stamp indexes onto the result's alloc objects the way the Go
        # store mutates shared pointers — workers count fresh placements
        # by create_index == alloc_index (scheduler/util.py).
        for alloc_list in result.node_allocation.values():
            for alloc in alloc_list:
                stored = self.fsm.state.alloc_by_id(alloc.id)
                if stored is not None:
                    alloc.create_index = stored.create_index
                    alloc.modify_index = stored.modify_index
        metrics.measure_since(("plan", "submit"), start)
        return index
