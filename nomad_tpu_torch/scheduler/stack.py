"""Placement stacks: the composed iterator pipelines.

Reference: scheduler/stack.go:37 (GenericStack), :189 (SystemStack).
"""

from __future__ import annotations

import math
import time
from typing import List, Optional, Tuple

from ..structs import Job, Node, Resources, TaskGroup
from .context import EvalContext
from .feasible import (
    ConstraintChecker,
    DriverChecker,
    FeasibilityWrapper,
    ProposedAllocConstraintIterator,
    StaticIterator,
    new_random_iterator,
)
from .rank import (
    BinPackIterator,
    FeasibleRankIterator,
    JobAntiAffinityIterator,
    RankedNode,
)
from .select import LimitIterator, MaxScoreIterator

SERVICE_JOB_ANTI_AFFINITY_PENALTY = 10.0
BATCH_JOB_ANTI_AFFINITY_PENALTY = 5.0


class _TGConstraints:
    """Aggregated constraints/drivers/size of a task group
    (scheduler/util.go:572 taskGroupConstraints)."""

    def __init__(self, tg: TaskGroup):
        self.constraints = list(tg.constraints)
        self.drivers = set()
        self.size = Resources(disk_mb=tg.ephemeral_disk.size_mb if tg.ephemeral_disk else 0)
        for task in tg.tasks:
            self.drivers.add(task.driver)
            self.constraints.extend(task.constraints)
            self.size.add(task.resources)


class GenericStack:
    """service/batch pipeline: shuffled source -> memoized job/TG
    feasibility -> distinct_hosts -> bin-pack -> anti-affinity ->
    limit(log2 N) -> max score."""

    def __init__(self, batch: bool, ctx: EvalContext):
        self.batch = batch
        self.ctx = ctx

        self.source = new_random_iterator(ctx, None)
        self.job_constraint = ConstraintChecker(ctx)
        self.task_group_drivers = DriverChecker(ctx)
        self.task_group_constraint = ConstraintChecker(ctx)
        self.wrapped_checks = FeasibilityWrapper(
            ctx,
            self.source,
            [self.job_constraint],
            [self.task_group_drivers, self.task_group_constraint],
        )
        self.proposed_alloc_constraint = ProposedAllocConstraintIterator(
            ctx, self.wrapped_checks
        )
        rank_source = FeasibleRankIterator(ctx, self.proposed_alloc_constraint)
        self.bin_pack = BinPackIterator(ctx, rank_source, evict=not batch, priority=0)
        penalty = (
            BATCH_JOB_ANTI_AFFINITY_PENALTY
            if batch
            else SERVICE_JOB_ANTI_AFFINITY_PENALTY
        )
        self.job_anti_aff = JobAntiAffinityIterator(ctx, self.bin_pack, penalty, "")
        self.limit = LimitIterator(ctx, self.job_anti_aff, 2)
        self.max_score = MaxScoreIterator(ctx, self.limit)

    def set_nodes(self, base_nodes: List[Node]) -> None:
        self.ctx.rng.shuffle(base_nodes)
        self.source.set_nodes(base_nodes)
        # Bounded search: batch relies on power-of-two choices; service
        # visits ceil(log2 N) with a floor of 2 (stack.go:120-132).
        limit = 2
        n = len(base_nodes)
        if not self.batch and n > 0:
            log_limit = int(math.ceil(math.log2(n))) if n > 1 else 1
            limit = max(limit, log_limit)
        self.limit.set_limit(limit)

    def set_job(self, job: Job) -> None:
        self.job_constraint.set_constraints(job.constraints)
        self.proposed_alloc_constraint.set_job(job)
        self.bin_pack.set_priority(job.priority)
        self.job_anti_aff.set_job(job.id)
        self.ctx.eligibility.set_job(job)

    def select(self, tg: TaskGroup) -> Tuple[Optional[RankedNode], Resources]:
        self.max_score.reset()
        self.ctx.reset()
        start = time.perf_counter()

        tg_constr = _TGConstraints(tg)
        self.task_group_drivers.set_drivers(tg_constr.drivers)
        self.task_group_constraint.set_constraints(tg_constr.constraints)
        self.proposed_alloc_constraint.set_task_group(tg)
        self.wrapped_checks.set_task_group(tg.name)
        self.bin_pack.set_task_group(tg)

        option = self.max_score.next()

        if option is not None and len(option.task_resources) != len(tg.tasks):
            for task in tg.tasks:
                option.set_task_resources(task, task.resources)

        self.ctx.metrics.allocation_time = time.perf_counter() - start
        return option, tg_constr.size

    def select_preferring_nodes(
        self, tg: TaskGroup, nodes: List[Node]
    ) -> Tuple[Optional[RankedNode], Resources]:
        """Try the preferred nodes first (sticky ephemeral disk), then
        fall back to the full node set."""
        original = self.source.nodes
        self.source.set_nodes(nodes)
        option, resources = self.select(tg)
        self.source.set_nodes(original)
        if option is not None:
            return option, resources
        return self.select(tg)


class SystemStack:
    """System pipeline: static source (must visit every node), memoized
    feasibility, bin-pack with eviction enabled; no anti-affinity/limit/
    max-score since each select targets exactly one node."""

    def __init__(self, ctx: EvalContext):
        self.ctx = ctx
        self.source = StaticIterator(ctx, None)
        self.job_constraint = ConstraintChecker(ctx)
        self.task_group_drivers = DriverChecker(ctx)
        self.task_group_constraint = ConstraintChecker(ctx)
        self.wrapped_checks = FeasibilityWrapper(
            ctx,
            self.source,
            [self.job_constraint],
            [self.task_group_drivers, self.task_group_constraint],
        )
        rank_source = FeasibleRankIterator(ctx, self.wrapped_checks)
        self.bin_pack = BinPackIterator(ctx, rank_source, evict=True, priority=0)

    def set_nodes(self, base_nodes: List[Node]) -> None:
        self.source.set_nodes(base_nodes)

    def set_job(self, job: Job) -> None:
        self.job_constraint.set_constraints(job.constraints)
        self.bin_pack.set_priority(job.priority)
        self.ctx.eligibility.set_job(job)

    def select(self, tg: TaskGroup) -> Tuple[Optional[RankedNode], Resources]:
        self.bin_pack.reset()
        self.ctx.reset()
        start = time.perf_counter()

        tg_constr = _TGConstraints(tg)
        self.task_group_drivers.set_drivers(tg_constr.drivers)
        self.task_group_constraint.set_constraints(tg_constr.constraints)
        self.bin_pack.set_task_group(tg)
        self.wrapped_checks.set_task_group(tg.name)

        option = self.bin_pack.next()

        if option is not None and len(option.task_resources) != len(tg.tasks):
            for task in tg.tasks:
                option.set_task_resources(task, task.resources)

        self.ctx.metrics.allocation_time = time.perf_counter() - start
        return option, tg_constr.size
