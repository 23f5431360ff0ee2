"""Scheduler test harness: a real state store + recording planner that
applies plans sequentially — the seam through which the port's
scheduler factories are driven end to end.

Reference: scheduler/testing.go:38 (Harness), :15 (RejectPlan).
"""

from __future__ import annotations

import logging
import random
import threading
from typing import List, Optional

from ..state import StateStore
from ..structs import Evaluation, Plan, PlanResult, consts
from . import new_scheduler


def seed_harness_cluster(harness: "Harness", nodes=(), allocs=(),
                         jobs=(), drained=()) -> None:
    """Seed a Harness's store for a parity case: nodes, pre-existing
    allocations, jobs, then drain transitions."""
    for node in nodes:
        harness.state.upsert_node(harness.next_index(), node)
    if allocs:
        harness.state.upsert_allocs(harness.next_index(), list(allocs))
    for job in jobs:
        harness.state.upsert_job(harness.next_index(), job)
    for node_id in drained:
        harness.state.update_node_drain(
            harness.next_index(), node_id, True)


def seed_consolidation_cluster(harness: "Harness", n_nodes: int,
                               factory: str = "service",
                               big_prefix: str = "cbig",
                               small_prefix: str = "csmall"):
    """The shared fragmentation fixture of the defrag rig: a fleet of
    1000/1000-capacity nodes running a mixed service workload — 600/600
    'big' jobs and 300/300 'small' jobs, placed through the real
    scheduler ``factory`` — whose churn-stopped smalls leave the
    sub-ask remainders consolidation exists for. Returns (nodes, jobs)."""
    from .. import mock
    from ..structs.eval import new_eval

    nodes = []
    for _ in range(n_nodes):
        node = mock.node()
        node.resources.cpu = 1000
        node.resources.memory_mb = 1000
        node.reserved = None
        node.compute_class()
        nodes.append(node)

    def mkjob(jid, count, cpu, mem):
        job = mock.job()
        job.id = jid
        job.task_groups[0].count = count
        task = job.task_groups[0].tasks[0]
        task.resources.cpu = cpu
        task.resources.memory_mb = mem
        task.resources.networks = []
        return job

    jobs = [mkjob(f"{big_prefix}{j}", 4, 600, 600)
            for j in range(n_nodes // 8)]
    jobs += [mkjob(f"{small_prefix}{j}", 6, 300, 300)
             for j in range(n_nodes // 5)]
    seed_harness_cluster(harness, nodes=nodes, jobs=jobs)
    for job in jobs:
        harness.process(factory, new_eval(
            harness.state.job_by_id(job.id),
            consts.EVAL_TRIGGER_JOB_REGISTER))
    return nodes, jobs


def churn_stop_small_allocs(harness: "Harness", rng, prob: float,
                            small_prefix: str = "csmall"):
    """One churn sweep over a seed_consolidation_cluster: each live
    small-job alloc stops with probability ``prob`` (seeded ``rng``:
    deterministic per seed), committed like a client update. Returns
    the stopped allocs."""
    stops = []
    for a in sorted((a for a in harness.state.allocs()
                     if not a.terminal_status()), key=lambda a: a.id):
        if a.job_id.startswith(small_prefix) and rng.random() < prob:
            upd = a.copy()
            upd.desired_status = consts.ALLOC_DESIRED_STOP
            upd.client_status = consts.ALLOC_CLIENT_COMPLETE
            stops.append(upd)
    seed_harness_cluster(harness, allocs=stops)
    return stops


class RejectPlan:
    """Planner that rejects every plan and forces a state refresh —
    exercises the refresh/retry loop."""

    def __init__(self, harness: "Harness"):
        self.harness = harness

    def submit_plan(self, plan: Plan):
        result = PlanResult()
        result.refresh_index = self.harness.next_index()
        return result, self.harness.state

    def update_eval(self, eval: Evaluation) -> None:
        pass

    def create_eval(self, eval: Evaluation) -> None:
        pass

    def reblock_eval(self, eval: Evaluation) -> None:
        pass


class Harness:
    def __init__(self, state: Optional[StateStore] = None,
                 seed: Optional[int] = None):
        self.state = state if state is not None else StateStore()
        self.planner = None  # optional custom planner
        self._plan_lock = threading.Lock()
        self._index_lock = threading.Lock()
        self._next_index = 1
        self.seed = seed

        self.plans: List[Plan] = []
        self.evals: List[Evaluation] = []
        self.create_evals: List[Evaluation] = []
        self.reblock_evals: List[Evaluation] = []

    def next_index(self) -> int:
        with self._index_lock:
            idx = self._next_index
            self._next_index += 1
            return idx

    # ------------------------------------------------------ Planner impl

    def submit_plan(self, plan: Plan):
        with self._plan_lock:
            self.plans.append(plan)
            delegate = self.planner
        if delegate is not None:
            # Delegate OUTSIDE the harness lock: a custom planner may
            # block (a real plan queue), and holding _plan_lock across
            # it would serialize every concurrent eval of the test
            # behind one submit instead of just the bookkeeping append.
            return delegate.submit_plan(plan)
        with self._plan_lock:
            index = self.next_index()
            result = PlanResult(
                node_update=plan.node_update,
                node_allocation=plan.node_allocation,
                node_preemptions=plan.node_preemptions,
                alloc_index=index,
            )

            allocs = []
            for update_list in plan.node_update.values():
                allocs.extend(update_list)
            for victim_list in plan.node_preemptions.values():
                allocs.extend(victim_list)
            for alloc_list in plan.node_allocation.values():
                allocs.extend(alloc_list)

            # Plans strip the job from allocs to avoid re-encoding it;
            # denormalize before inserting (other jobs' preemption
            # victims re-denormalize from their stored record, like
            # the FSM funnel does).
            for alloc in allocs:
                if alloc.job is None:
                    if plan.job is not None and alloc.job_id == plan.job.id:
                        alloc.job = plan.job
                    else:
                        stored = self.state.alloc_by_id(alloc.id)
                        if stored is not None:
                            alloc.job = stored.job
                # Stamp create/modify indexes on the result's allocs the way
                # the Go store mutates shared structs (state_store.go:922):
                # new allocs get this index, existing ones keep theirs —
                # adjust_queued_allocations relies on it.
                existing = self.state.alloc_by_id(alloc.id)
                alloc.create_index = existing.create_index if existing else index
                alloc.modify_index = index

            self.state.upsert_allocs(index, allocs)
            return result, None

    def update_eval(self, eval: Evaluation) -> None:
        with self._plan_lock:
            self.evals.append(eval)
            if self.planner is not None:
                self.planner.update_eval(eval)

    def create_eval(self, eval: Evaluation) -> None:
        with self._plan_lock:
            self.create_evals.append(eval)
            if self.planner is not None:
                self.planner.create_eval(eval)

    def reblock_eval(self, eval: Evaluation) -> None:
        with self._plan_lock:
            old = self.state.eval_by_id(eval.id)
            if old is None:
                raise ValueError("evaluation does not exist to be reblocked")
            if old.status != consts.EVAL_STATUS_BLOCKED:
                raise ValueError(
                    f"evaluation {old.id!r} is not already in a blocked state"
                )
            self.reblock_evals.append(eval)

    # ------------------------------------------------------ driving

    def snapshot(self):
        return self.state.snapshot()

    def process(self, scheduler_name: str, eval: Evaluation) -> None:
        logger = logging.getLogger("nomad_tpu_torch.scheduler.harness")
        rng = random.Random(self.seed) if self.seed is not None else None
        sched = new_scheduler(scheduler_name, logger, self.snapshot(), self, rng=rng)
        sched.process_eval(eval)

    def assert_eval_status(self, status: str) -> None:
        assert len(self.evals) == 1, f"expected 1 eval update, got {self.evals!r}"
        assert self.evals[0].status == status, f"bad status: {self.evals[0]!r}"
