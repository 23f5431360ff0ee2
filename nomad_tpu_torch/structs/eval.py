"""Evaluation — the unit of scheduler work.

Reference: nomad/structs/structs.go:3219 (Evaluation), :3359
(ShouldEnqueue), :3372 (ShouldBlock), :3385 (MakePlan), :3400
(NextRollingEval), :3417 (CreateBlockedEval).
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..utils.ids import generate_uuid
from . import consts
from .alloc import AllocMetric
from .job import Job
from .plan import Plan


@dataclass
class Evaluation:
    id: str = ""
    priority: int = 0
    type: str = ""  # routes to a scheduler factory
    triggered_by: str = ""
    job_id: str = ""
    job_modify_index: int = 0
    node_id: str = ""
    node_modify_index: int = 0
    status: str = ""
    status_description: str = ""
    wait: float = 0.0  # seconds to delay before eligible (rolling updates)
    next_eval: str = ""
    previous_eval: str = ""
    blocked_eval: str = ""
    failed_tg_allocs: Dict[str, AllocMetric] = field(default_factory=dict)
    class_eligibility: Dict[str, bool] = field(default_factory=dict)
    escaped_computed_class: bool = False
    annotate_plan: bool = False
    queued_allocations: Dict[str, int] = field(default_factory=dict)  # tg -> queued count
    snapshot_index: int = 0
    create_index: int = 0
    modify_index: int = 0
    # Eval-lifecycle trace id (nomad_tpu/trace): stamped at creation,
    # carried through broker/dispatch/scheduler/plan so every layer's
    # spans land in one tree. Empty on evals minted by older callers —
    # the recorder falls back to the eval id.
    trace_id: str = ""
    # Overload protection (nomad_tpu/admission): absolute wall-clock
    # instant past which this eval is stale — the broker skips it at
    # dequeue and the dispatch pipeline drops it before matrix build.
    # 0.0 = no deadline. Stamped once at creation (priority-scaled,
    # admission/deadline.py) by the server's eval_update funnel.
    deadline: float = 0.0
    # Continuous defragmentation (nomad_tpu/defrag): on a
    # triggered_by=EVAL_TRIGGER_DEFRAG eval, the alloc ids of this job
    # the optimizer wants moved this wave (the scheduler promotes them
    # from the diff's ignore bucket to migrate — budget-exempt, the
    # loop already holds the governor slots) and the solver's target
    # node per alloc id (a placement PREFERENCE: the replacement still
    # runs the full feasibility stack and falls back to a free select).
    defrag_alloc_ids: List[str] = field(default_factory=list)
    defrag_targets: Dict[str, str] = field(default_factory=dict)
    # Wall-clock instant past which this wave's markers are VOID: the
    # loop abandons a wave (and releases its governor slots) after
    # WAVE_TIMEOUT, so an eval that surfaces later must not stage
    # budget-exempt evictions against slots nobody holds — and its
    # solve is stale anyway. The scheduler ignores expired markers
    # (the eval degrades to a no-op reconciliation); the next round
    # re-derives from fresh state. 0.0 = no deadline (tests).
    defrag_wave_expires: float = 0.0

    def copy(self) -> "Evaluation":
        return copy.deepcopy(self)

    def expired(self, now: Optional[float] = None) -> bool:
        """True when a deadline is set and has passed (wall clock)."""
        if not self.deadline:
            return False
        import time

        return (now if now is not None else time.time()) >= self.deadline

    def terminal_status(self) -> bool:
        return self.status in (
            consts.EVAL_STATUS_COMPLETE,
            consts.EVAL_STATUS_FAILED,
            consts.EVAL_STATUS_CANCELLED,
        )

    def should_enqueue(self) -> bool:
        """Whether the eval belongs in the broker's ready queues."""
        return self.status == consts.EVAL_STATUS_PENDING

    def should_block(self) -> bool:
        """Whether the eval belongs in the blocked-evals tracker."""
        return self.status == consts.EVAL_STATUS_BLOCKED

    def make_plan(self, job: Optional[Job]) -> Plan:
        plan = Plan(
            eval_id=self.id,
            priority=self.priority,
            job=job,
        )
        if job is not None:
            plan.all_at_once = job.all_at_once
        return plan

    def next_rolling_eval(self, wait: float) -> "Evaluation":
        """Follow-up eval for the next rolling-update batch."""
        return Evaluation(
            id=generate_uuid(),
            priority=self.priority,
            type=self.type,
            triggered_by=consts.EVAL_TRIGGER_ROLLING_UPDATE,
            job_id=self.job_id,
            job_modify_index=self.job_modify_index,
            status=consts.EVAL_STATUS_PENDING,
            wait=wait,
            previous_eval=self.id,
            trace_id=generate_uuid(),
        )

    def next_migration_eval(self, wait: float) -> "Evaluation":
        """Follow-up eval for displaced allocs deferred past the
        in-flight migration budget (nomad_tpu/migrate): the drain
        storm's next wave, the budget analog of next_rolling_eval."""
        return Evaluation(
            id=generate_uuid(),
            priority=self.priority,
            type=self.type,
            triggered_by=consts.EVAL_TRIGGER_MIGRATION,
            job_id=self.job_id,
            job_modify_index=self.job_modify_index,
            status=consts.EVAL_STATUS_PENDING,
            wait=wait,
            previous_eval=self.id,
            trace_id=generate_uuid(),
        )

    def create_blocked_eval(
        self,
        class_eligibility: Dict[str, bool],
        escaped: bool,
    ) -> "Evaluation":
        """Blocked eval re-enqueued when node capacity changes."""
        return Evaluation(
            id=generate_uuid(),
            priority=self.priority,
            type=self.type,
            triggered_by=self.triggered_by,
            job_id=self.job_id,
            job_modify_index=self.job_modify_index,
            status=consts.EVAL_STATUS_BLOCKED,
            previous_eval=self.id,
            class_eligibility=dict(class_eligibility),
            escaped_computed_class=escaped,
            trace_id=generate_uuid(),
        )


def new_eval(job: Job, triggered_by: str) -> Evaluation:
    return Evaluation(
        id=generate_uuid(),
        priority=job.priority,
        type=job.type,
        triggered_by=triggered_by,
        job_id=job.id,
        # The spec-change index, not modify_index: derived-status writes
        # bump the latter without changing the job spec.
        job_modify_index=job.job_modify_index,
        status=consts.EVAL_STATUS_PENDING,
        trace_id=generate_uuid(),
    )
