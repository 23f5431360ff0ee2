"""Allocation, AllocMetric, TaskState/TaskEvent.

Reference: nomad/structs/structs.go:2854 (Allocation), :3074 (AllocMetric),
:2317 (TaskState), :2434 (TaskEvent).
"""

from __future__ import annotations

import copy
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from . import consts
from .job import Job
from .resources import Resources


@dataclass
class TaskEvent:
    type: str = ""
    time: float = 0.0
    restart_reason: str = ""
    driver_error: str = ""
    exit_code: int = 0
    signal: int = 0
    message: str = ""
    kill_timeout: float = 0.0
    kill_error: str = ""
    start_delay: float = 0.0
    download_error: str = ""
    validation_error: str = ""


@dataclass
class TaskState:
    state: str = consts.TASK_STATE_PENDING
    failed: bool = False
    events: List[TaskEvent] = field(default_factory=list)

    def successful(self) -> bool:
        if self.state != consts.TASK_STATE_DEAD:
            return False
        return not self.failed


@dataclass
class AllocMetric:
    """The scheduler's explainability record attached to each placement
    attempt (structs.go:3074)."""

    nodes_evaluated: int = 0
    nodes_filtered: int = 0
    nodes_available: Dict[str, int] = field(default_factory=dict)  # by DC
    class_filtered: Dict[str, int] = field(default_factory=dict)
    constraint_filtered: Dict[str, int] = field(default_factory=dict)
    nodes_exhausted: int = 0
    class_exhausted: Dict[str, int] = field(default_factory=dict)
    dimension_exhausted: Dict[str, int] = field(default_factory=dict)
    scores: Dict[str, float] = field(default_factory=dict)  # "node.class" -> score
    allocation_time: float = 0.0  # seconds spent selecting
    coalesced_failures: int = 0

    def copy(self) -> "AllocMetric":
        # Field-wise (values are scalars/flat dicts): metrics are copied
        # once per upserted alloc, so the deepcopy machinery showed up
        # in the plan-apply profile. (__new__ + __dict__.update is ~4x
        # cheaper than copy.copy's reduce protocol.)
        new = AllocMetric.__new__(AllocMetric)
        new.__dict__.update(self.__dict__)
        new.nodes_available = dict(self.nodes_available)
        new.class_filtered = dict(self.class_filtered)
        new.constraint_filtered = dict(self.constraint_filtered)
        new.class_exhausted = dict(self.class_exhausted)
        new.dimension_exhausted = dict(self.dimension_exhausted)
        new.scores = dict(self.scores)
        return new

    def evaluate_node(self) -> None:
        self.nodes_evaluated += 1

    def filter_node(self, node, constraint: str) -> None:
        self.nodes_filtered += 1
        if node is not None and node.node_class:
            self.class_filtered[node.node_class] = self.class_filtered.get(node.node_class, 0) + 1
        if constraint:
            self.constraint_filtered[constraint] = self.constraint_filtered.get(constraint, 0) + 1

    def exhausted_node(self, node, dimension: str) -> None:
        self.nodes_exhausted += 1
        if node is not None and node.node_class:
            self.class_exhausted[node.node_class] = self.class_exhausted.get(node.node_class, 0) + 1
        if dimension:
            self.dimension_exhausted[dimension] = self.dimension_exhausted.get(dimension, 0) + 1

    def score_node(self, node, name: str, score: float) -> None:
        key = f"{node.id}.{name}"
        self.scores[key] = self.scores.get(key, 0.0) + score


@dataclass
class Allocation:
    id: str = ""
    eval_id: str = ""
    name: str = ""  # "<job>.<group>[<index>]"
    node_id: str = ""
    job_id: str = ""
    job: Optional[Job] = None
    task_group: str = ""
    resources: Optional[Resources] = None
    shared_resources: Optional[Resources] = None
    task_resources: Dict[str, Resources] = field(default_factory=dict)
    metrics: Optional[AllocMetric] = None
    desired_status: str = ""
    desired_description: str = ""
    client_status: str = ""
    client_description: str = ""
    task_states: Dict[str, TaskState] = field(default_factory=dict)
    previous_allocation: str = ""
    create_index: int = 0
    modify_index: int = 0
    alloc_modify_index: int = 0  # bumped only on scheduler-driven changes
    create_time: float = 0.0

    def copy(self) -> "Allocation":
        # Field-wise copy instead of copy.deepcopy: this is the plan
        # applier's hot path (a system job touching N nodes upserts N
        # allocs) and the deepcopy machinery dominated its profile. The
        # embedded job is immutable-by-convention (the store's MVCC
        # semantics: every job write stores a fresh object, readers
        # never mutate it in place) so the reference is shared.
        new = Allocation.__new__(Allocation)
        new.__dict__.update(self.__dict__)
        new.resources = self.resources.copy() if self.resources else None
        new.shared_resources = (
            self.shared_resources.copy() if self.shared_resources else None)
        new.task_resources = {
            k: r.copy() for k, r in self.task_resources.items()}
        new.metrics = self.metrics.copy() if self.metrics else None
        new.task_states = {
            k: TaskState(state=ts.state, failed=ts.failed,
                         events=[copy.copy(e) for e in ts.events])
            for k, ts in self.task_states.items()
        }
        # The dense matrix's usage memo must not survive into a copy
        # whose resources may be rewritten (in-place updates).
        new.__dict__.pop("_dense_usage", None)
        return new

    def index(self) -> int:
        """The per-group index parsed from the name suffix '[i]'."""
        lb = self.name.rfind("[")
        rb = self.name.rfind("]")
        if lb == -1 or rb == -1 or rb <= lb:
            return -1
        try:
            return int(self.name[lb + 1 : rb])
        except ValueError:
            return -1

    def terminal_status(self) -> bool:
        """Terminal from the scheduler's perspective (structs.go
        Allocation.TerminalStatus): desired stop/evict, or a terminal
        client status."""
        if self.desired_status in (consts.ALLOC_DESIRED_STOP, consts.ALLOC_DESIRED_EVICT):
            return True
        return self.client_status in (
            consts.ALLOC_CLIENT_COMPLETE,
            consts.ALLOC_CLIENT_FAILED,
            consts.ALLOC_CLIENT_LOST,
        )

    def ran_successfully(self) -> bool:
        """All task states dead and non-failed (used by batch filtering)."""
        if not self.task_states:
            return False
        return all(ts.successful() for ts in self.task_states.values())

    def stub(self) -> dict:
        return {
            "id": self.id,
            "eval_id": self.eval_id,
            "name": self.name,
            "node_id": self.node_id,
            "job_id": self.job_id,
            "task_group": self.task_group,
            "desired_status": self.desired_status,
            "desired_description": self.desired_description,
            "client_status": self.client_status,
            "client_description": self.client_description,
            "create_index": self.create_index,
            "modify_index": self.modify_index,
            "create_time": self.create_time,
        }


def remove_allocs(allocs: List[Allocation], remove: List[Allocation]) -> List[Allocation]:
    """allocs minus the ids of remove (structs/funcs.go:11)."""
    remove_ids = {a.id for a in remove}
    return [a for a in allocs if a.id not in remove_ids]


def filter_terminal_allocs(allocs: List[Allocation]):
    """Split allocs into (live, latest-terminal-by-name)
    (structs/funcs.go:33)."""
    live: List[Allocation] = []
    terminal: Dict[str, Allocation] = {}
    for a in allocs:
        if a.terminal_status():
            prev = terminal.get(a.name)
            if prev is None or prev.create_index < a.create_index:
                terminal[a.name] = a
        else:
            live.append(a)
    return live, terminal


def new_task_event(event_type: str) -> TaskEvent:
    return TaskEvent(type=event_type, time=time.time())


@dataclass
class VaultAccessor:
    """Tracking record for one derived vault token (reference
    structs.VaultAccessor, persisted in the vault_accessors table)."""

    accessor: str = ""
    alloc_id: str = ""
    task: str = ""
    node_id: str = ""
    policies: List[str] = field(default_factory=list)
    create_index: float = 0.0
