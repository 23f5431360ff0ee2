"""Evaluation context: state access, plan, metrics, caches, and the
computed-class eligibility memo.

Reference: scheduler/context.go:12 (Context), :64 (EvalContext),
:108 (ProposedAllocs), :172 (EvalEligibility).
"""

from __future__ import annotations

import logging
import random
from typing import Dict, List, Optional

from ..structs import (
    AllocMetric,
    Allocation,
    Job,
    Plan,
    escaped_constraints,
    remove_allocs,
)

# Computed-class feasibility states (context.go:149-168)
CLASS_UNKNOWN = 0
CLASS_INELIGIBLE = 1
CLASS_ELIGIBLE = 2
CLASS_ESCAPED = 3


class EvalEligibility:
    """Per-evaluation memo of job/task-group feasibility per computed node
    class. Lets the feasibility wrapper skip constraint checks for every
    node in an already-decided class."""

    def __init__(self):
        self.job: Dict[str, int] = {}
        self.job_escaped = False
        self.task_groups: Dict[str, Dict[str, int]] = {}
        self.tg_escaped: Dict[str, bool] = {}

    def set_job(self, job: Job) -> None:
        self.job_escaped = len(escaped_constraints(job.constraints)) != 0
        for tg in job.task_groups:
            constraints = list(tg.constraints)
            for task in tg.tasks:
                constraints.extend(task.constraints)
            self.tg_escaped[tg.name] = len(escaped_constraints(constraints)) != 0

    def has_escaped(self) -> bool:
        return self.job_escaped or any(self.tg_escaped.values())

    def get_classes(self) -> Dict[str, bool]:
        elig: Dict[str, bool] = {}
        for cls, feas in self.job.items():
            if feas == CLASS_ELIGIBLE:
                elig[cls] = True
            elif feas == CLASS_INELIGIBLE:
                elig[cls] = False
        for classes in self.task_groups.values():
            for cls, feas in classes.items():
                if feas == CLASS_ELIGIBLE:
                    elig[cls] = True
                elif feas == CLASS_INELIGIBLE:
                    # Don't let one TG mark a class ineligible when another
                    # TG found it eligible.
                    elig.setdefault(cls, False)
        return elig

    def job_status(self, cls: str) -> int:
        if self.job_escaped or not cls:
            return CLASS_ESCAPED
        return self.job.get(cls, CLASS_UNKNOWN)

    def set_job_eligibility(self, eligible: bool, cls: str) -> None:
        self.job[cls] = CLASS_ELIGIBLE if eligible else CLASS_INELIGIBLE

    def task_group_status(self, tg: str, cls: str) -> int:
        if not cls:
            return CLASS_ESCAPED
        if self.tg_escaped.get(tg):
            return CLASS_ESCAPED
        return self.task_groups.get(tg, {}).get(cls, CLASS_UNKNOWN)

    def set_task_group_eligibility(self, eligible: bool, tg: str, cls: str) -> None:
        self.task_groups.setdefault(tg, {})[cls] = (
            CLASS_ELIGIBLE if eligible else CLASS_INELIGIBLE
        )


class EvalContext:
    """Context carried through one evaluation's placement pipeline."""

    def __init__(self, state, plan: Plan, logger: Optional[logging.Logger] = None,
                 rng: Optional[random.Random] = None):
        self.state = state
        self.plan = plan
        self.logger = logger or logging.getLogger("nomad_tpu_torch.scheduler")
        self.metrics = AllocMetric()
        self.eligibility = EvalEligibility()
        self.regexp_cache: Dict[str, object] = {}
        self.constraint_cache: Dict[str, object] = {}
        self.rng = rng or random.Random()

    def reset(self) -> None:
        """Called after each placement: metrics are per-selection."""
        self.metrics = AllocMetric()

    def proposed_allocs(self, node_id: str) -> List[Allocation]:
        """Allocations that would exist on the node if the current plan
        commits (shared semantics in util.proposed_allocs_for_node)."""
        from .util import proposed_allocs_for_node

        return proposed_allocs_for_node(self.state, self.plan, node_id)
