"""Ranking iterators: bin-packing score and job anti-affinity.

Reference: scheduler/rank.go — RankedNode:12, FeasibleRankIterator:61,
BinPackIterator:133 (the hot kernel), JobAntiAffinityIterator:247.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ..structs import (
    Allocation,
    NetworkIndex,
    Node,
    Resources,
    Task,
    TaskGroup,
    allocs_fit,
    score_fit,
)
from .context import EvalContext


class RankedNode:
    __slots__ = ("node", "score", "task_resources", "proposed")

    def __init__(self, node: Node):
        self.node = node
        self.score = 0.0
        self.task_resources: Dict[str, Resources] = {}
        self.proposed: Optional[List[Allocation]] = None

    def proposed_allocs(self, ctx: EvalContext) -> List[Allocation]:
        if self.proposed is None:
            self.proposed = ctx.proposed_allocs(self.node.id)
        return self.proposed

    def set_task_resources(self, task: Task, resources: Resources) -> None:
        self.task_resources[task.name] = resources

    def __repr__(self):
        return f"<Node: {self.node.id} Score: {self.score:.3f}>"


class FeasibleRankIterator:
    """Upgrades a feasible-node stream to ranked options."""

    def __init__(self, ctx: EvalContext, source):
        self.ctx = ctx
        self.source = source

    def next(self) -> Optional[RankedNode]:
        option = self.source.next()
        if option is None:
            return None
        return RankedNode(option)

    def reset(self) -> None:
        self.source.reset()


class StaticRankIterator:
    """Fixed list of ranked nodes; test utility (rank.go:93)."""

    def __init__(self, ctx: EvalContext, nodes: List[RankedNode]):
        self.ctx = ctx
        self.nodes = nodes
        self.offset = 0
        self.seen = 0

    def next(self) -> Optional[RankedNode]:
        n = len(self.nodes)
        if self.offset == n or self.seen == n:
            if self.seen != n:
                self.offset = 0
            else:
                return None
        option = self.nodes[self.offset]
        self.offset += 1
        self.seen += 1
        return option

    def reset(self) -> None:
        self.seen = 0


class BinPackIterator:
    """Scores nodes by bin-packing fit. For each candidate: build the
    proposed-alloc set, offer network resources per task, check AllocsFit,
    then score with BestFit-v3. Nodes that cannot hold the ask are
    skipped and recorded as exhausted."""

    def __init__(self, ctx: EvalContext, source, evict: bool, priority: int):
        self.ctx = ctx
        self.source = source
        self.evict = evict  # reserved: eviction search is intentionally not implemented (rank.go:227 XXX)
        self.priority = priority
        self.task_group: Optional[TaskGroup] = None

    def set_priority(self, priority: int) -> None:
        self.priority = priority

    def set_task_group(self, task_group: TaskGroup) -> None:
        self.task_group = task_group

    def next(self) -> Optional[RankedNode]:
        while True:
            option = self.source.next()
            if option is None:
                return None

            proposed = option.proposed_allocs(self.ctx)

            net_idx = NetworkIndex()
            net_idx.set_node(option.node)
            net_idx.add_allocs(proposed)

            total = Resources(disk_mb=self.task_group.ephemeral_disk.size_mb)
            exhausted = False
            for task in self.task_group.tasks:
                task_resources = task.resources.copy()
                if task_resources.networks:
                    ask = task_resources.networks[0]
                    offer, err = net_idx.assign_network(ask, self.ctx.rng)
                    if offer is None:
                        self.ctx.metrics.exhausted_node(
                            option.node, f"network: {err}"
                        )
                        exhausted = True
                        break
                    # Reserve so the next task in this group can't collide.
                    net_idx.add_reserved(offer)
                    task_resources.networks = [offer]
                option.set_task_resources(task, task_resources)
                total.add(task_resources)
            if exhausted:
                continue

            candidate = proposed + [Allocation(resources=total)]
            fit, dim, util = allocs_fit(option.node, candidate, net_idx)
            if not fit:
                self.ctx.metrics.exhausted_node(option.node, dim)
                continue

            fitness = score_fit(option.node, util)
            option.score += fitness
            self.ctx.metrics.score_node(option.node, "binpack", fitness)
            return option

    def reset(self) -> None:
        self.source.reset()


class JobAntiAffinityIterator:
    """Penalizes co-placement with existing allocs of the same job to
    spread load (penalty 10 service / 5 batch, stack.go:14-18)."""

    def __init__(self, ctx: EvalContext, source, penalty: float, job_id: str):
        self.ctx = ctx
        self.source = source
        self.penalty = penalty
        self.job_id = job_id

    def set_job(self, job_id: str) -> None:
        self.job_id = job_id

    def next(self) -> Optional[RankedNode]:
        option = self.source.next()
        if option is None:
            return None
        proposed = option.proposed_allocs(self.ctx)
        collisions = sum(1 for a in proposed if a.job_id == self.job_id)
        if collisions > 0:
            penalty = -1.0 * collisions * self.penalty
            option.score += penalty
            self.ctx.metrics.score_node(option.node, "job-anti-affinity", penalty)
        return option

    def reset(self) -> None:
        self.source.reset()
