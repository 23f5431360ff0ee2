"""Plan and PlanResult — the scheduler's proposed state mutations.

Reference: nomad/structs/structs.go:3435 (Plan), :3528 (PlanResult),
:3475 (AppendUpdate), :3503 (PopUpdate), :3516 (AppendAlloc).
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from . import consts
from .alloc import Allocation, AllocMetric
from .job import Job


@dataclass
class Plan:
    eval_id: str = ""
    eval_token: str = ""  # split-brain guard: must match broker's token
    priority: int = 0
    all_at_once: bool = False  # gang commit: reject unless fully applicable
    job: Optional[Job] = None
    # node id -> allocs to update/evict on that node
    node_update: Dict[str, List[Allocation]] = field(default_factory=dict)
    # node id -> new allocations for that node
    node_allocation: Dict[str, List[Allocation]] = field(default_factory=dict)
    # node id -> lower-priority allocs this plan evicts to make room
    # for its placements (the dense preemption pass, ops/preempt.py).
    # A separate leg from node_update because the applier VERIFIES it
    # differently: each victim must still exist, be non-terminal, and
    # be strictly lower-priority than the plan — a victim that died or
    # changed underneath the scheduler rejects the node and forces a
    # replan, exactly like a placement that no longer fits.
    node_preemptions: Dict[str, List[Allocation]] = field(default_factory=dict)
    # Gang atomicity leg (nomad_tpu/gang): gang key ("job/<tg>") ->
    # alloc ids of the gang's members in node_allocation. The plan
    # applier treats each group as ALL-OR-NOTHING across nodes: any
    # member's node failing verification removes every member of that
    # gang from the result (on accepted nodes too) — partial-commit
    # granularity stays per node for ordinary placements and becomes
    # per GANG for these. All members still commit in the one raft
    # apply the accepted plan rides.
    gang_groups: Dict[str, List[str]] = field(default_factory=dict)
    annotations: Optional["PlanAnnotations"] = None
    failed_tg_allocs: Dict[str, AllocMetric] = field(default_factory=dict)
    # Raft watermark of the snapshot the dense node matrix serving this
    # plan was built from (-1 = unknown/host path). On rejection the
    # plan applier reads it to tell an ordinary optimistic-concurrency
    # loss (the node moved PAST this index before verification) from
    # resident-matrix staleness (it didn't — the matrix claimed a fit
    # its own snapshot refutes), which decides whether the device-
    # resident delta chain must be purged (models/resident.py).
    matrix_index: int = -1

    def append_update(
        self, alloc: Allocation, desired_status: str, description: str
    ) -> None:
        """Record an evict/stop of an existing alloc. The copied alloc is
        stripped of its embedded job to keep the plan small (the reference
        nulls Job on updates, structs.go:3475)."""
        new_alloc = alloc.copy()
        new_alloc.job = None
        new_alloc.desired_status = desired_status
        new_alloc.desired_description = description
        self.node_update.setdefault(alloc.node_id, []).append(new_alloc)

    def pop_update(self, alloc: Allocation) -> None:
        """Undo the most recent staged update for alloc (used by the
        in-place-update path when the re-selection fails)."""
        updates = self.node_update.get(alloc.node_id, [])
        if updates and updates[-1].id == alloc.id:
            updates.pop()
            if not updates:
                del self.node_update[alloc.node_id]

    def append_alloc(self, alloc: Allocation) -> None:
        self.node_allocation.setdefault(alloc.node_id, []).append(alloc)

    def append_gang_alloc(self, gang_key: str, alloc: Allocation) -> None:
        """Stage one gang member: an ordinary placement PLUS membership
        in the gang's atomicity group (see gang_groups)."""
        self.append_alloc(alloc)
        self.gang_groups.setdefault(gang_key, []).append(alloc.id)

    def pop_gang(self, gang_key: str) -> int:
        """Unstage every placement of one gang (the scheduler backs a
        gang out when a member's host-side port assignment fails — an
        incomplete gang must never reach the applier). Returns the
        number of members removed."""
        ids = set(self.gang_groups.pop(gang_key, ()))
        if not ids:
            return 0
        removed = 0
        for node_id in list(self.node_allocation):
            kept = [a for a in self.node_allocation[node_id]
                    if a.id not in ids]
            removed += len(self.node_allocation[node_id]) - len(kept)
            if kept:
                self.node_allocation[node_id] = kept
            else:
                del self.node_allocation[node_id]
        return removed

    def append_preemption(
        self, alloc: Allocation, desired_status: str, description: str
    ) -> None:
        """Stage a preemption eviction of a lower-priority alloc. The
        scheduler passes consts.ALLOC_DESIRED_EVICT; the stamp commits
        through the plan applier's raft apply after per-victim
        verification (server/plan_apply.py), never directly."""
        new_alloc = alloc.copy()
        new_alloc.job = None
        new_alloc.desired_status = desired_status
        new_alloc.desired_description = description
        self.node_preemptions.setdefault(alloc.node_id, []).append(new_alloc)

    def pop_preemptions(self, node_id: str, n: int) -> None:
        """Un-stage the last ``n`` preemptions for a node (the dense
        commit loop backs out victims when the placement they were
        freeing room for fails host-side port assignment)."""
        victims = self.node_preemptions.get(node_id, [])
        if n > 0:
            del victims[-n:]
        if not victims:
            self.node_preemptions.pop(node_id, None)

    def is_no_op(self) -> bool:
        return (not self.node_update and not self.node_allocation
                and not self.node_preemptions)

    def copy(self) -> "Plan":
        return copy.deepcopy(self)


@dataclass
class PlanResult:
    node_update: Dict[str, List[Allocation]] = field(default_factory=dict)
    node_allocation: Dict[str, List[Allocation]] = field(default_factory=dict)
    # Preemption evictions that passed per-victim verification and
    # committed with the plan (the scheduler mints the victims' jobs
    # replacement evals from this).
    node_preemptions: Dict[str, List[Allocation]] = field(default_factory=dict)
    refresh_index: int = 0  # worker must refresh its snapshot to this index
    alloc_index: int = 0  # raft index the accepted allocs committed at

    def is_no_op(self) -> bool:
        return (not self.node_update and not self.node_allocation
                and not self.node_preemptions)

    def full_commit(self, plan: Plan) -> tuple:
        """Compare attempted vs accepted placements: (full, expected, actual)."""
        expected = sum(len(v) for v in plan.node_allocation.values())
        actual = sum(len(v) for v in self.node_allocation.values())
        return expected == actual, expected, actual


@dataclass
class PlanAnnotations:
    desired_tg_updates: Dict[str, "DesiredUpdates"] = field(default_factory=dict)


@dataclass
class DesiredUpdates:
    ignore: int = 0
    place: int = 0
    migrate: int = 0
    stop: int = 0
    in_place_update: int = 0
    destructive_update: int = 0
