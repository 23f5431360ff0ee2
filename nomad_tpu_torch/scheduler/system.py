"""SystemScheduler: run the job on every ready, feasible node.

Reference: scheduler/system_sched.go:23 (SystemScheduler), :55 (Process),
:87 (process), :179 (computeJobAllocs), :255 (computePlacements).

The port's host system scheduler ("system"): the JAX package's
scheduler/system.py on the port's own structs, stack and diff helpers.
It runs no device code; "system-gpu" (scheduler/tpu.py
DenseSystemScheduler) overrides its diff and placement hooks.
"""

from __future__ import annotations

import logging
import random
from typing import Dict, List, Optional

from ..structs import (
    AllocMetric,
    Allocation,
    Evaluation,
    Job,
    Plan,
    PlanAnnotations,
    PlanResult,
    Resources,
    consts,
    filter_terminal_allocs,
)
from ..utils.ids import generate_uuid
from .context import EvalContext
from .stack import SystemStack
from .util import (
    ALLOC_LOST,
    ALLOC_NOT_NEEDED,
    ALLOC_UPDATING,
    AllocTuple,
    SetStatusError,
    _append_update_with_client,
    adjust_queued_allocations,
    desired_updates,
    diff_system_allocs,
    evict_and_place,
    inplace_update,
    progress_made,
    ready_nodes_in_dcs,
    retry_max,
    set_status,
    tainted_nodes,
    update_non_terminal_allocs_to_lost,
)

MAX_SYSTEM_SCHEDULE_ATTEMPTS = 5


class SystemScheduler:
    def __init__(self, logger, state, planner, rng: Optional[random.Random] = None):
        self.logger = logger or logging.getLogger("nomad_tpu_torch.scheduler")
        self.state = state
        self.planner = planner
        self.rng = rng or random.Random()

        self.eval: Optional[Evaluation] = None
        self.job: Optional[Job] = None
        self.plan: Optional[Plan] = None
        self.plan_result: Optional[PlanResult] = None
        self.ctx: Optional[EvalContext] = None
        self.stack: Optional[SystemStack] = None
        self.nodes: List = []
        self.nodes_by_dc: Dict[str, int] = {}

        self.limit_reached = False
        self.next_eval: Optional[Evaluation] = None
        self.failed_tg_allocs: Optional[Dict[str, AllocMetric]] = None
        self.queued_allocs: Optional[Dict[str, int]] = None

    def process_eval(self, eval: Evaluation) -> None:
        self.eval = eval

        if eval.triggered_by not in (
            consts.EVAL_TRIGGER_JOB_REGISTER,
            consts.EVAL_TRIGGER_NODE_UPDATE,
            consts.EVAL_TRIGGER_JOB_DEREGISTER,
            consts.EVAL_TRIGGER_ROLLING_UPDATE,
        ):
            desc = f"scheduler cannot handle '{eval.triggered_by}' evaluation reason"
            set_status(
                self.logger, self.planner, self.eval, self.next_eval, None,
                self.failed_tg_allocs, consts.EVAL_STATUS_FAILED, desc,
                self.queued_allocs,
            )
            return

        try:
            retry_max(
                MAX_SYSTEM_SCHEDULE_ATTEMPTS,
                self._process,
                lambda: progress_made(self.plan_result),
            )
        except SetStatusError as err:
            set_status(
                self.logger, self.planner, self.eval, self.next_eval, None,
                self.failed_tg_allocs, err.eval_status, str(err),
                self.queued_allocs,
            )
            return

        set_status(
            self.logger, self.planner, self.eval, self.next_eval, None,
            self.failed_tg_allocs, consts.EVAL_STATUS_COMPLETE, "",
            self.queued_allocs,
        )

    def _process(self) -> bool:
        self.job = self.state.job_by_id(self.eval.job_id)
        self.queued_allocs = {}

        if self.job is not None:
            self.nodes, self.nodes_by_dc = ready_nodes_in_dcs(
                self.state, self.job.datacenters
            )

        self.plan = self.eval.make_plan(self.job)
        self.failed_tg_allocs = None
        self.ctx = EvalContext(self.state, self.plan, self.logger, rng=self.rng)
        self.stack = SystemStack(self.ctx)
        if self.job is not None:
            self.stack.set_job(self.job)

        self._compute_job_allocs()

        if self.plan.is_no_op() and not self.eval.annotate_plan:
            return True

        if self.limit_reached and self.next_eval is None:
            self.next_eval = self.eval.next_rolling_eval(self.job.update.stagger)
            self.planner.create_eval(self.next_eval)

        result, new_state = self.planner.submit_plan(self.plan)
        self.plan_result = result

        adjust_queued_allocations(self.logger, result, self.queued_allocs)

        if new_state is not None:
            self.state = new_state
            return False

        full_commit, expected, actual = result.full_commit(self.plan)
        if not full_commit:
            self.logger.debug(
                "eval %s: attempted %d placements, %d placed",
                self.eval.id, expected, actual,
            )
            return False

        return True

    def _diff_system(self, tainted, allocs, terminal_allocs):
        """Diff hook. Returns (DiffResult, prefiltered) where
        prefiltered maps tg name -> [count, first_node] of place
        candidates a subclass already ruled out by constraint (the
        dense scheduler gates the place set up front; here nothing is
        pre-filtered — the placement loop filters one at a time)."""
        return diff_system_allocs(
            self.job, self.nodes, tainted, allocs, terminal_allocs), {}

    def _compute_job_allocs(self) -> None:
        allocs = self.state.allocs_by_job(self.eval.job_id)
        tainted = tainted_nodes(self.state, allocs)

        update_non_terminal_allocs_to_lost(self.plan, tainted, allocs)

        allocs, terminal_allocs = filter_terminal_allocs(allocs)

        diff, prefiltered = self._diff_system(
            tainted, allocs, terminal_allocs)
        self.logger.debug("eval %s job %s: %s", self.eval.id, self.eval.job_id, diff)

        for e in diff.stop:
            self.plan.append_update(e.alloc, consts.ALLOC_DESIRED_STOP, ALLOC_NOT_NEEDED)

        for e in diff.lost:
            _append_update_with_client(
                self.plan, e.alloc, consts.ALLOC_DESIRED_STOP, ALLOC_LOST,
                consts.ALLOC_CLIENT_LOST,
            )

        destructive, inplace = inplace_update(
            self.ctx, self.eval, self.job, self.stack, diff.update
        )
        diff.update = destructive

        if self.eval.annotate_plan:
            self.plan.annotations = PlanAnnotations(
                desired_tg_updates=desired_updates(diff, inplace, destructive)
            )

        limit = [len(diff.update)]
        if self.job is not None and self.job.update is not None and self.job.update.rolling():
            limit = [self.job.update.max_parallel]

        self.limit_reached = evict_and_place(
            self.ctx, diff, diff.update, ALLOC_UPDATING, limit
        )

        # Zero every TG's queue only when there were NO candidates at
        # all: a fully-prefiltered eval must instead look like "every
        # placement was filtered" (same records the host loop leaves).
        if not diff.place and not prefiltered:
            if self.job is not None:
                for tg in self.job.task_groups:
                    self.queued_allocs[tg.name] = 0
            return

        for tup in diff.place:
            self.queued_allocs[tup.task_group.name] = (
                self.queued_allocs.get(tup.task_group.name, 0) + 1
            )

        if diff.place:
            self._compute_placements(diff.place)
        if prefiltered:
            self._merge_prefiltered(prefiltered)

    def _merge_prefiltered(self, prefiltered) -> None:
        """Fold diff-gated (constraint-infeasible) candidates into the
        same records the placement loop produces by filtering them one
        at a time: the queued key exists with its feasible-only net
        value, and failed_tg_allocs carries the filtered tally."""
        for name, (count, first_node) in prefiltered.items():
            if count <= 0:
                continue
            self.queued_allocs.setdefault(name, 0)
            if self.failed_tg_allocs is None:
                self.failed_tg_allocs = {}
            existing = self.failed_tg_allocs.get(name)
            if existing is not None:
                existing.coalesced_failures += count
                continue
            metrics = AllocMetric()
            metrics.nodes_available = self.nodes_by_dc
            metrics.evaluate_node()
            metrics.filter_node(first_node, "constraint")
            metrics.coalesced_failures = count - 1
            self.failed_tg_allocs[name] = metrics

    def _compute_placements(self, place: List[AllocTuple]) -> None:
        node_by_id = {n.id: n for n in self.nodes}

        for missing in place:
            node = node_by_id.get(missing.alloc.node_id)
            if node is None:
                raise RuntimeError(f"could not find node {missing.alloc.node_id!r}")

            self.stack.set_nodes([node])
            option, _ = self.stack.select(missing.task_group)

            if option is None:
                # A constraint mismatch on this node means the alloc was
                # never really "queued" there; undo the optimistic count.
                if self.ctx.metrics.nodes_filtered > 0:
                    self.queued_allocs[missing.task_group.name] -= 1
                    if (
                        self.eval.annotate_plan
                        and self.plan.annotations is not None
                        and missing.task_group.name
                        in self.plan.annotations.desired_tg_updates
                    ):
                        self.plan.annotations.desired_tg_updates[
                            missing.task_group.name
                        ].place -= 1

                if self.failed_tg_allocs and missing.task_group.name in self.failed_tg_allocs:
                    self.failed_tg_allocs[
                        missing.task_group.name
                    ].coalesced_failures += 1
                    continue

            self.ctx.metrics.nodes_available = self.nodes_by_dc

            if option is not None:
                alloc = Allocation(
                    id=generate_uuid(),
                    eval_id=self.eval.id,
                    name=missing.name,
                    job_id=self.job.id,
                    task_group=missing.task_group.name,
                    metrics=self.ctx.metrics,
                    node_id=option.node.id,
                    task_resources=option.task_resources,
                    desired_status=consts.ALLOC_DESIRED_RUN,
                    client_status=consts.ALLOC_CLIENT_PENDING,
                    shared_resources=Resources(
                        disk_mb=missing.task_group.ephemeral_disk.size_mb
                    ),
                )
                if missing.alloc is not None and missing.alloc.id:
                    alloc.previous_allocation = missing.alloc.id
                self.plan.append_alloc(alloc)
            else:
                if self.failed_tg_allocs is None:
                    self.failed_tg_allocs = {}
                self.failed_tg_allocs[missing.task_group.name] = self.ctx.metrics
