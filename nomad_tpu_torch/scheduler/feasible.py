"""Feasibility iterators and checkers.

Reference: scheduler/feasible.go — StaticIterator:35, RandomIterator:83,
DriverChecker:93, ProposedAllocConstraintIterator:150,
ConstraintChecker:247, resolveConstraintTarget:291, checkConstraint:327,
FeasibilityWrapper:457.
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, List, Optional, Set

from ..structs import Constraint, Job, Node, TaskGroup, consts
from ..utils.version import parse_constraints, parse_version
from .context import (
    CLASS_ELIGIBLE,
    CLASS_ESCAPED,
    CLASS_INELIGIBLE,
    CLASS_UNKNOWN,
    EvalContext,
)


class StaticIterator:
    """Yields nodes in a fixed order with wrap-around: after a Reset the
    iterator continues from its offset, visiting each node at most once
    per pass (feasible.go:51-72)."""

    def __init__(self, ctx: EvalContext, nodes: Optional[List[Node]]):
        self.ctx = ctx
        self.nodes = nodes or []
        self.offset = 0
        self.seen = 0

    def next(self) -> Optional[Node]:
        n = len(self.nodes)
        if self.offset == n or self.seen == n:
            if self.seen != n:
                self.offset = 0
            else:
                return None
        option = self.nodes[self.offset]
        self.offset += 1
        self.seen += 1
        self.ctx.metrics.evaluate_node()
        return option

    def reset(self) -> None:
        self.seen = 0

    def set_nodes(self, nodes: List[Node]) -> None:
        self.nodes = nodes
        self.offset = 0
        self.seen = 0


def new_random_iterator(ctx: EvalContext, nodes: Optional[List[Node]]) -> StaticIterator:
    """Shuffled source: reduces collisions between concurrent schedulers
    and load-balances across eligible nodes."""
    nodes = list(nodes or [])
    ctx.rng.shuffle(nodes)
    return StaticIterator(ctx, nodes)


class DriverChecker:
    """Node must advertise every required driver as attribute
    'driver.<name>' parsing to a true boolean."""

    def __init__(self, ctx: EvalContext, drivers: Optional[Set[str]] = None):
        self.ctx = ctx
        self.drivers = drivers or set()

    def set_drivers(self, drivers: Set[str]) -> None:
        self.drivers = drivers

    def feasible(self, option: Node) -> bool:
        if self._has_drivers(option):
            return True
        self.ctx.metrics.filter_node(option, "missing drivers")
        return False

    def _has_drivers(self, option: Node) -> bool:
        for driver in self.drivers:
            value = option.attributes.get(f"driver.{driver}")
            if value is None:
                return False
            if str(value).strip().lower() not in ("1", "t", "true"):
                return False
        return True


class ConstraintChecker:
    def __init__(self, ctx: EvalContext, constraints: Optional[List[Constraint]] = None):
        self.ctx = ctx
        self.constraints = constraints or []

    def set_constraints(self, constraints: List[Constraint]) -> None:
        self.constraints = constraints

    def feasible(self, option: Node) -> bool:
        for constraint in self.constraints:
            if not self._meets(constraint, option):
                self.ctx.metrics.filter_node(option, str(constraint))
                return False
        return True

    def _meets(self, constraint: Constraint, option: Node) -> bool:
        lval, ok = resolve_constraint_target(constraint.ltarget, option)
        if not ok:
            return False
        rval, ok = resolve_constraint_target(constraint.rtarget, option)
        if not ok:
            return False
        return check_constraint(self.ctx, constraint.operand, lval, rval)


def resolve_constraint_target(target: str, node: Node):
    """Interpolate ${node.*}/${attr.*}/${meta.*} against the node;
    plain strings are literals. Returns (value, ok)."""
    if not target.startswith("${"):
        return target, True
    if target == "${node.unique.id}":
        return node.id, True
    if target == "${node.datacenter}":
        return node.datacenter, True
    if target == "${node.unique.name}":
        return node.name, True
    if target == "${node.class}":
        return node.node_class, True
    if target.startswith("${attr."):
        key = target[len("${attr.") : -1]
        if key in node.attributes:
            return node.attributes[key], True
        return None, False
    if target.startswith("${meta."):
        key = target[len("${meta.") : -1]
        if key in node.meta:
            return node.meta[key], True
        return None, False
    return None, False


def check_constraint(ctx: EvalContext, operand: str, lval, rval) -> bool:
    if operand == consts.CONSTRAINT_DISTINCT_HOSTS:
        # Handled by ProposedAllocConstraintIterator, pass here.
        return True
    if operand in ("=", "==", "is"):
        return lval == rval
    if operand in ("!=", "not"):
        return lval != rval
    if operand in ("<", "<=", ">", ">="):
        return _check_lexical(operand, lval, rval)
    if operand == consts.CONSTRAINT_VERSION:
        return _check_version(ctx, lval, rval)
    if operand == consts.CONSTRAINT_REGEX:
        return _check_regexp(ctx, lval, rval)
    return False


def _check_lexical(op: str, lval, rval) -> bool:
    if not isinstance(lval, str) or not isinstance(rval, str):
        return False
    if op == "<":
        return lval < rval
    if op == "<=":
        return lval <= rval
    if op == ">":
        return lval > rval
    return lval >= rval


def _check_version(ctx: EvalContext, lval, rval) -> bool:
    if isinstance(lval, int):
        lval = str(lval)
    if not isinstance(lval, str) or not isinstance(rval, str):
        return False
    version = parse_version(lval)
    if version is None:
        return False
    constraints = ctx.constraint_cache.get(rval)
    if constraints is None:
        constraints = parse_constraints(rval)
        if constraints is None:
            return False
        ctx.constraint_cache[rval] = constraints
    return constraints.check(version)


def _check_regexp(ctx: EvalContext, lval, rval) -> bool:
    if not isinstance(lval, str) or not isinstance(rval, str):
        return False
    compiled = ctx.regexp_cache.get(rval)
    if compiled is None:
        try:
            compiled = re.compile(rval)
        except re.error:
            return False
        ctx.regexp_cache[rval] = compiled
    return compiled.search(lval) is not None


class ProposedAllocConstraintIterator:
    """Applies constraints affected by proposed placements: currently
    distinct_hosts (feasible.go:150-242)."""

    def __init__(self, ctx: EvalContext, source):
        self.ctx = ctx
        self.source = source
        self.tg: Optional[TaskGroup] = None
        self.job: Optional[Job] = None
        self.tg_distinct_hosts = False
        self.job_distinct_hosts = False

    def set_task_group(self, tg: TaskGroup) -> None:
        self.tg = tg
        self.tg_distinct_hosts = self._has_distinct_hosts(tg.constraints)

    def set_job(self, job: Job) -> None:
        self.job = job
        self.job_distinct_hosts = self._has_distinct_hosts(job.constraints)

    @staticmethod
    def _has_distinct_hosts(constraints: List[Constraint]) -> bool:
        return any(c.operand == consts.CONSTRAINT_DISTINCT_HOSTS for c in constraints)

    def next(self) -> Optional[Node]:
        while True:
            option = self.source.next()
            if option is None or not (self.job_distinct_hosts or self.tg_distinct_hosts):
                return option
            if not self._satisfies_distinct_hosts(option):
                self.ctx.metrics.filter_node(option, consts.CONSTRAINT_DISTINCT_HOSTS)
                continue
            return option

    def _satisfies_distinct_hosts(self, option: Node) -> bool:
        proposed = self.ctx.proposed_allocs(option.id)
        for alloc in proposed:
            job_collision = alloc.job_id == self.job.id
            task_collision = alloc.task_group == self.tg.name
            if (self.job_distinct_hosts and job_collision) or (
                job_collision and task_collision
            ):
                return False
        return True

    def reset(self) -> None:
        self.source.reset()


class FeasibilityWrapper:
    """Runs job- and TG-level feasibility checks, memoized per computed
    node class via EvalEligibility (feasible.go:457-568)."""

    def __init__(self, ctx: EvalContext, source, job_checkers, tg_checkers):
        self.ctx = ctx
        self.source = source
        self.job_checkers = job_checkers
        self.tg_checkers = tg_checkers
        self.tg = ""

    def set_task_group(self, tg: str) -> None:
        self.tg = tg

    def reset(self) -> None:
        self.source.reset()

    def next(self) -> Optional[Node]:
        elig = self.ctx.eligibility
        metrics = self.ctx.metrics
        while True:
            option = self.source.next()
            if option is None:
                return None

            job_escaped = job_unknown = False
            status = elig.job_status(option.computed_class)
            if status == CLASS_INELIGIBLE:
                metrics.filter_node(option, "computed class ineligible")
                continue
            elif status == CLASS_ESCAPED:
                job_escaped = True
            elif status == CLASS_UNKNOWN:
                job_unknown = True

            failed = False
            for check in self.job_checkers:
                if not check.feasible(option):
                    if not job_escaped:
                        elig.set_job_eligibility(False, option.computed_class)
                    failed = True
                    break
            if failed:
                continue
            if not job_escaped and job_unknown:
                elig.set_job_eligibility(True, option.computed_class)

            tg_escaped = tg_unknown = False
            status = elig.task_group_status(self.tg, option.computed_class)
            if status == CLASS_INELIGIBLE:
                metrics.filter_node(option, "computed class ineligible")
                continue
            elif status == CLASS_ELIGIBLE:
                return option
            elif status == CLASS_ESCAPED:
                tg_escaped = True
            elif status == CLASS_UNKNOWN:
                tg_unknown = True

            failed = False
            for check in self.tg_checkers:
                if not check.feasible(option):
                    if not tg_escaped:
                        elig.set_task_group_eligibility(
                            False, self.tg, option.computed_class
                        )
                    failed = True
                    break
            if failed:
                continue
            if not tg_escaped and tg_unknown:
                elig.set_task_group_eligibility(True, self.tg, option.computed_class)

            return option
