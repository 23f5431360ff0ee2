"""Reconciliation helpers: alloc diffing, in-place updates, rolling
limits.

Reference: scheduler/util.go — materializeTaskGroups:21, diffAllocs:69,
diffSystemAllocs:170, readyNodesInDCs:223, retryMax:263, taintedNodes:297,
tasksUpdated:332, inplaceUpdate:441, evictAndPlace:525,
markLostAndPlace:543, desiredUpdates:592, adjustQueuedAllocations:667,
updateNonTerminalAllocsToLost:688.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..structs import (
    Allocation,
    DesiredUpdates,
    Evaluation,
    Job,
    Node,
    Plan,
    PlanResult,
    TaskGroup,
    consts,
)

# Desired-status descriptions (generic_sched.go:20-34)
ALLOC_NOT_NEEDED = "alloc not needed due to job update"
ALLOC_MIGRATING = "alloc is being migrated"
ALLOC_UPDATING = "alloc is being updated due to job update"
ALLOC_LOST = "alloc is lost since its node is down"
ALLOC_IN_PLACE = "alloc updating in-place"
ALLOC_NODE_TAINTED = "system alloc not needed as node is tainted"
ALLOC_PREEMPTED = "alloc preempted by a higher-priority evaluation"
ALLOC_GANG_REPLACED = "alloc stopped for whole-gang replacement"


@dataclass
class AllocTuple:
    name: str
    task_group: Optional[TaskGroup]
    alloc: Optional[Allocation]


@dataclass
class DiffResult:
    place: List[AllocTuple] = field(default_factory=list)
    update: List[AllocTuple] = field(default_factory=list)
    migrate: List[AllocTuple] = field(default_factory=list)
    stop: List[AllocTuple] = field(default_factory=list)
    ignore: List[AllocTuple] = field(default_factory=list)
    lost: List[AllocTuple] = field(default_factory=list)

    def append(self, other: "DiffResult") -> None:
        self.place.extend(other.place)
        self.update.extend(other.update)
        self.migrate.extend(other.migrate)
        self.stop.extend(other.stop)
        self.ignore.extend(other.ignore)
        self.lost.extend(other.lost)

    def __str__(self):
        return (
            f"allocs: (place {len(self.place)}) (update {len(self.update)}) "
            f"(migrate {len(self.migrate)}) (stop {len(self.stop)}) "
            f"(ignore {len(self.ignore)}) (lost {len(self.lost)})"
        )


def proposed_allocs_for_node(state, plan: Optional[Plan], node_id: str) -> List[Allocation]:
    """Allocations that would exist on the node if the plan commits:
    live allocs minus planned evictions plus planned placements,
    placements overriding by alloc id (context.go:108 ProposedAllocs).
    Shared by the eval context, the dense matrix builder, and the plan
    applier's verification."""
    from ..structs import remove_allocs

    existing = state.allocs_by_node_terminal(node_id, False)
    proposed = existing
    if plan is not None:
        # Preemption victims free their capacity exactly like staged
        # stops — the plan applier re-verifies each victim separately
        # before trusting this discount (server/plan_apply.py).
        updates = (plan.node_update.get(node_id, [])
                   + plan.node_preemptions.get(node_id, []))
        if updates:
            proposed = remove_allocs(existing, updates)
        by_id = {a.id: a for a in proposed}
        for alloc in plan.node_allocation.get(node_id, []):
            by_id[alloc.id] = alloc
        proposed = list(by_id.values())
    return proposed


def materialize_task_groups(job: Optional[Job]) -> Dict[str, TaskGroup]:
    """Count-expand each task group to named slots '<job>.<tg>[<i>]'."""
    out: Dict[str, TaskGroup] = {}
    if job is None:
        return out
    for tg in job.task_groups:
        for i in range(tg.count):
            out[f"{job.name}.{tg.name}[{i}]"] = tg
    return out


def diff_allocs(
    job: Optional[Job],
    tainted_nodes: Dict[str, Optional[Node]],
    required: Dict[str, TaskGroup],
    allocs: List[Allocation],
    terminal_allocs: Dict[str, Allocation],
) -> DiffResult:
    """Set-difference between required slots and existing allocations.
    Buckets: place / update / migrate / stop / ignore / lost."""
    result = DiffResult()
    existing = set()
    for exist in allocs:
        name = exist.name
        existing.add(name)
        tg = required.get(name)

        if tg is None:
            result.stop.append(AllocTuple(name, tg, exist))
            continue

        if exist.node_id in tainted_nodes:
            # Batch work that already finished successfully stays done even
            # on a tainted node; services/system should never "complete".
            if (
                exist.job is not None
                and exist.job.type == consts.JOB_TYPE_BATCH
                and exist.ran_successfully()
            ):
                result.ignore.append(AllocTuple(name, tg, exist))
                continue
            node = tainted_nodes[exist.node_id]
            if node is None or node.terminal_status():
                result.lost.append(AllocTuple(name, tg, exist))
            else:
                result.migrate.append(AllocTuple(name, tg, exist))
            continue

        if job.job_modify_index != (
            exist.job.job_modify_index if exist.job else 0
        ):
            result.update.append(AllocTuple(name, tg, exist))
            continue

        result.ignore.append(AllocTuple(name, tg, exist))

    for name, tg in required.items():
        if name not in existing:
            result.place.append(AllocTuple(name, tg, terminal_allocs.get(name)))
    return result


def diff_system_allocs(
    job: Job,
    nodes: List[Node],
    tainted_nodes: Dict[str, Optional[Node]],
    allocs: List[Allocation],
    terminal_allocs: Dict[str, Allocation],
) -> DiffResult:
    """Like diff_allocs but per node: every ready node must run the job,
    and each placement is pinned to its node."""
    node_allocs: Dict[str, List[Allocation]] = {}
    for alloc in allocs:
        node_allocs.setdefault(alloc.node_id, []).append(alloc)
    for node in nodes:
        node_allocs.setdefault(node.id, [])

    required = materialize_task_groups(job)
    result = DiffResult()
    for node_id, nallocs in node_allocs.items():
        diff = diff_allocs(job, tainted_nodes, required, nallocs, terminal_allocs)
        if node_id in tainted_nodes:
            diff.place = []
        else:
            for tup in diff.place:
                if tup.alloc is None or tup.alloc.node_id != node_id:
                    tup.alloc = Allocation(node_id=node_id)
        # A tainted node invalidates the job there: migrations become stops.
        diff.stop.extend(diff.migrate)
        diff.migrate = []
        result.append(diff)
    return result


def ready_nodes_in_dcs(state, dcs: List[str]) -> Tuple[List[Node], Dict[str, int]]:
    dc_map = {dc: 0 for dc in dcs}
    out = []
    for node in state.nodes():
        if node.status != consts.NODE_STATUS_READY:
            continue
        if node.drain:
            continue
        if node.datacenter not in dc_map:
            continue
        out.append(node)
        dc_map[node.datacenter] += 1
    return out, dc_map


class SetStatusError(Exception):
    def __init__(self, message: str, eval_status: str):
        super().__init__(message)
        self.eval_status = eval_status


def retry_max(
    max_attempts: int,
    cb: Callable[[], bool],
    reset: Optional[Callable[[], bool]] = None,
) -> None:
    """Retry cb until it returns True; reset() returning True restores
    the attempt budget (progress was made)."""
    attempts = 0
    while attempts < max_attempts:
        if cb():
            return
        if reset is not None and reset():
            attempts = 0
        else:
            attempts += 1
    raise SetStatusError(
        f"maximum attempts reached ({max_attempts})", consts.EVAL_STATUS_FAILED
    )


def progress_made(result: Optional[PlanResult]) -> bool:
    return result is not None and (
        bool(result.node_update) or bool(result.node_allocation)
    )


def tainted_nodes(state, allocs: List[Allocation]) -> Dict[str, Optional[Node]]:
    """Nodes hosting the allocs that are down, draining, or gone. A gone
    node maps to None (treated as lost)."""
    out: Dict[str, Optional[Node]] = {}
    seen = set()
    for alloc in allocs:
        if alloc.node_id in seen:
            continue
        seen.add(alloc.node_id)
        node = state.node_by_id(alloc.node_id)
        if node is None:
            out[alloc.node_id] = None
            continue
        if node.status == consts.NODE_STATUS_DOWN or node.drain:
            out[alloc.node_id] = node
    return out


def tasks_updated(a: TaskGroup, b: TaskGroup) -> bool:
    """Whether the difference between two task groups requires a
    destructive update (new alloc) rather than in-place.

    In-place rules: env/meta-level tweaks are COMPATIBLE — the client
    re-renders the task environment from the updated alloc without the
    placement moving, so a routine spec tweak is not a churn event
    (README "Churn & migration"; the reference restarts the task but
    never re-places it, which is the half that matters to the
    scheduler). Anything that changes what runs (driver/config/
    artifacts/vault) or what it consumes (resources/networks/disk)
    stays destructive and routes to the placement path."""
    if len(a.tasks) != len(b.tasks):
        return True
    if a.ephemeral_disk != b.ephemeral_disk:
        return True
    for at in a.tasks:
        bt = b.lookup_task(at.name)
        if bt is None:
            return True
        if at.driver != bt.driver or at.user != bt.user:
            return True
        if at.config != bt.config:
            return True
        if at.artifacts != bt.artifacts or at.vault != bt.vault:
            return True
        if len(at.resources.networks) != len(bt.resources.networks):
            return True
        for an, bn in zip(at.resources.networks, bt.resources.networks):
            if an.mbits != bn.mbits:
                return True
            if _network_port_map(an) != _network_port_map(bn):
                return True
        ar, br = at.resources, bt.resources
        if ar.cpu != br.cpu or ar.memory_mb != br.memory_mb or ar.iops != br.iops:
            return True
        if ar.disk_mb != br.disk_mb:
            return True
    return False


def _network_port_map(n) -> Dict[str, int]:
    m = {p.label: p.value for p in n.reserved_ports}
    for p in n.dynamic_ports:
        m[p.label] = -1  # dynamic values don't matter for change detection
    return m


def set_status(
    logger,
    planner,
    eval: Evaluation,
    next_eval: Optional[Evaluation],
    spawned_blocked: Optional[Evaluation],
    tg_metrics: Optional[Dict],
    status: str,
    description: str,
    queued_allocs: Optional[Dict[str, int]],
) -> None:
    new_eval = eval.copy()
    new_eval.status = status
    new_eval.status_description = description
    new_eval.failed_tg_allocs = tg_metrics or {}
    if next_eval is not None:
        new_eval.next_eval = next_eval.id
    if spawned_blocked is not None:
        new_eval.blocked_eval = spawned_blocked.id
    if queued_allocs is not None:
        new_eval.queued_allocations = queued_allocs
    planner.update_eval(new_eval)


def inplace_update(
    ctx, eval: Evaluation, job: Job, stack, updates: List[AllocTuple]
) -> Tuple[List[AllocTuple], List[AllocTuple]]:
    """Try each update in place on its current node: stage an eviction of
    the old alloc so its resources are discounted, re-select pinned to
    that node, and pop the staged eviction. Returns
    (destructive, inplace)."""
    destructive: List[AllocTuple] = []
    inplace: List[AllocTuple] = []
    for update in updates:
        existing_tg = (
            update.alloc.job.lookup_task_group(update.task_group.name)
            if update.alloc.job
            else None
        )
        if existing_tg is None or tasks_updated(update.task_group, existing_tg):
            destructive.append(update)
            continue

        node = ctx.state.node_by_id(update.alloc.node_id)
        if node is None:
            destructive.append(update)
            continue

        stack.set_nodes([node])
        ctx.plan.append_update(
            update.alloc, consts.ALLOC_DESIRED_STOP, ALLOC_IN_PLACE
        )
        option, _ = stack.select(update.task_group)
        ctx.plan.pop_update(update.alloc)

        if option is None:
            destructive.append(update)
            continue

        _stage_inplace_alloc(ctx, eval, update, option.task_resources)
        inplace.append(update)
    return destructive, inplace


def _stage_inplace_alloc(ctx, eval: Evaluation, update: AllocTuple,
                         task_resources) -> None:
    """The one in-place alloc rewrite both paths (sequential +
    batched) stage: restore the existing network offers (networks
    cannot change in-place — guarded by tasks_updated), copy the
    alloc forward under this eval, and append it to the plan. Shared
    so the field set can never desync between the paths the parity
    tests compare."""
    for task_name, resources in task_resources.items():
        existing_res = update.alloc.task_resources.get(task_name)
        if existing_res is not None:
            resources.networks = existing_res.networks
    new_alloc = update.alloc.copy()
    new_alloc.eval_id = eval.id
    new_alloc.job = None  # plan carries the job
    new_alloc.resources = None  # computed at plan apply
    new_alloc.task_resources = task_resources
    new_alloc.metrics = ctx.metrics
    ctx.plan.append_alloc(new_alloc)


def inplace_update_batched(
    ctx, eval: Evaluation, job: Job, stack, updates: List[AllocTuple]
) -> Tuple[List[AllocTuple], List[AllocTuple]]:
    """The dense schedulers' batched equivalent of inplace_update: the
    compatibility check (tasks_updated) is pure host work against the
    MVCC snapshot, and a COMPATIBLE update by construction consumes
    exactly the resources its predecessor held (tasks_updated returns
    True for any cpu/memory/iops/disk/network change) — so the
    reference's stage-eviction-re-select-pop dance per alloc
    (scheduler/util.go:441, K sequential one-node iterator stacks)
    collapses to a node-liveness check plus a direct alloc rewrite.
    Only genuinely destructive updates flow on to the device placement
    path (SURVEY.md section 7: in-place checks host-side, bulk
    placements on device). Semantics match the sequential path
    placement-for-placement: parity-tested against it."""
    from .feasible import ConstraintChecker, DriverChecker

    # One checker pair per task group, built lazily: the NEW job's
    # constraints may have tightened, and an in-place rewrite must not
    # keep an alloc on a node the updated spec forbids (the sequential
    # path catches this inside stack.select's feasibility iterators).
    checkers: Dict[str, Tuple[ConstraintChecker, DriverChecker]] = {}

    def tg_feasible(tg: TaskGroup, node: Node) -> bool:
        pair = checkers.get(tg.name)
        if pair is None:
            cons = list(job.constraints) + list(tg.constraints)
            drivers = set()
            for task in tg.tasks:
                cons.extend(task.constraints)
                drivers.add(task.driver)
            pair = (ConstraintChecker(ctx, cons),
                    DriverChecker(ctx, drivers))
            checkers[tg.name] = pair
        cons_checker, driver_checker = pair
        return cons_checker.feasible(node) and driver_checker.feasible(node)

    destructive: List[AllocTuple] = []
    inplace: List[AllocTuple] = []
    for update in updates:
        existing_tg = (
            update.alloc.job.lookup_task_group(update.task_group.name)
            if update.alloc.job
            else None
        )
        if existing_tg is None or tasks_updated(update.task_group, existing_tg):
            destructive.append(update)
            continue
        node = ctx.state.node_by_id(update.alloc.node_id)
        if node is None or not node.ready():
            # The sequential path's pinned re-select fails on a dead or
            # draining node the same way.
            destructive.append(update)
            continue
        if not tg_feasible(update.task_group, node):
            destructive.append(update)
            continue

        # Same resources, same node: rebuild task_resources from the
        # NEW job's tasks (names/shape may differ even when amounts do
        # not); _stage_inplace_alloc carries the existing network
        # offers over, exactly as the sequential path restores them
        # post-select.
        task_resources = {
            task.name: task.resources.copy()
            for task in update.task_group.tasks
        }
        _stage_inplace_alloc(ctx, eval, update, task_resources)
        inplace.append(update)
    return destructive, inplace


def evict_and_place(
    ctx, diff: DiffResult, allocs: List[AllocTuple], desc: str, limit: List[int]
) -> bool:
    """Evict up to limit[0] allocs and queue replacements. limit is a
    one-element list (mutable int). Returns True if the rolling-update
    limit was hit."""
    n = len(allocs)
    for i in range(min(n, limit[0])):
        a = allocs[i]
        ctx.plan.append_update(a.alloc, consts.ALLOC_DESIRED_STOP, desc)
        diff.place.append(a)
    if n <= limit[0]:
        limit[0] -= n
        return False
    limit[0] = 0
    return True


def mark_lost_and_place(
    ctx, diff: DiffResult, allocs: List[AllocTuple], desc: str, limit: List[int]
) -> bool:
    """Like evict_and_place but the stop also records client status lost."""
    n = len(allocs)
    for i in range(min(n, limit[0])):
        a = allocs[i]
        _append_update_with_client(
            ctx.plan, a.alloc, consts.ALLOC_DESIRED_STOP, desc, consts.ALLOC_CLIENT_LOST
        )
        diff.place.append(a)
    if n <= limit[0]:
        limit[0] -= n
        return False
    limit[0] = 0
    return True


def _append_update_with_client(
    plan: Plan, alloc: Allocation, desired: str, desc: str, client_status: str
) -> None:
    plan.append_update(alloc, desired, desc)
    staged = plan.node_update[alloc.node_id][-1]
    staged.client_status = client_status


def update_non_terminal_allocs_to_lost(
    plan: Plan, tainted: Dict[str, Optional[Node]], allocs: List[Allocation]
) -> None:
    """Allocs already desired-stopped but still pending/running on a
    tainted node will never report in: mark them lost."""
    for alloc in allocs:
        if (
            alloc.node_id in tainted
            and alloc.desired_status == consts.ALLOC_DESIRED_STOP
            and alloc.client_status
            in (consts.ALLOC_CLIENT_RUNNING, consts.ALLOC_CLIENT_PENDING)
        ):
            _append_update_with_client(
                plan, alloc, consts.ALLOC_DESIRED_STOP, ALLOC_LOST,
                consts.ALLOC_CLIENT_LOST,
            )


def desired_updates(
    diff: DiffResult,
    inplace_updates: List[AllocTuple],
    destructive_updates: List[AllocTuple],
) -> Dict[str, DesiredUpdates]:
    """Per-task-group counts for plan annotations (`nomad plan` UX)."""
    out: Dict[str, DesiredUpdates] = {}

    def get(name: str) -> DesiredUpdates:
        if name not in out:
            out[name] = DesiredUpdates()
        return out[name]

    for tup in diff.place:
        get(tup.task_group.name).place += 1
    for tup in diff.stop:
        get(tup.alloc.task_group).stop += 1
    for tup in diff.ignore:
        get(tup.task_group.name).ignore += 1
    for tup in diff.migrate:
        get(tup.task_group.name).migrate += 1
    for tup in inplace_updates:
        get(tup.task_group.name).in_place_update += 1
    for tup in destructive_updates:
        get(tup.task_group.name).destructive_update += 1
    return out


# ---------------------------------------------------------------- cohort

# Per-alloc classification codes for the stacked cohort table
# (cohort_reconcile). IGNORE and PLACE_PREV keep an eval on the
# executive's array path; LEGACY routes the whole eval to the per-eval
# scheduler (its diff has buckets — stop/update/migrate/lost — the
# batched path does not reproduce).
_COHORT_IGNORE = 0
_COHORT_PLACE_PREV = 1
_COHORT_LEGACY = 2

# Triggers the executive's array path may take end to end; everything
# else carries semantics (deregister stops, migration budget claims,
# rolling follow-ups) the per-eval scheduler owns.
COHORT_FAST_TRIGGERS = (
    consts.EVAL_TRIGGER_JOB_REGISTER,
    consts.EVAL_TRIGGER_NODE_UPDATE,
    consts.EVAL_TRIGGER_PERIODIC_JOB,
    consts.EVAL_TRIGGER_MAX_PLANS,
)


@dataclass
class CohortMember:
    """One eval's reconcile verdict inside an executive cohort: either
    `fast` with its pure-placement diff attached (the array path owns
    it end to end), or legacy with the routing reason (the per-eval
    scheduler runs it unchanged)."""

    eval: Evaluation
    job: Optional[Job] = None
    fast: bool = False
    reason: str = ""
    place: List[AllocTuple] = field(default_factory=list)
    queued: Dict[str, int] = field(default_factory=dict)


def cohort_reconcile(state, evals: List[Evaluation]) -> List[CohortMember]:
    """Reconcile a whole cohort of evaluations in one pass over a
    stacked existing-allocs table (the scheduler executive's batched
    replacement for N GIL-interleaved diff_allocs loops).

    The cohort's existing allocations stack into parallel arrays —
    owning-eval index, job-modify index, terminal/tainted/required
    membership flags — classified with vectorized compares instead of
    per-eval Python branching, and the per-eval verdict is an
    aggregation (np.bincount over the eval axis). An eval is `fast`
    exactly when its diff would contain ONLY place/ignore buckets:
    stops, destructive/in-place updates, migrations (budget claims),
    lost allocs, tainted nodes, batch-job terminal semantics and
    sticky disks all route to the per-eval scheduler, whose code paths
    stay the single source of truth for those semantics. Parity with
    diff_allocs on the fast subset is a test invariant
    (tests/test_scheduler_util.py)."""
    members = [CohortMember(eval=ev) for ev in evals]
    node_tainted: Dict[str, bool] = {}  # cohort-level memo, one lookup/node

    def tainted(node_id: str) -> bool:
        hit = node_tainted.get(node_id)
        if hit is None:
            node = state.node_by_id(node_id)
            hit = (node is None or node.status == consts.NODE_STATUS_DOWN
                   or node.drain)
            node_tainted[node_id] = hit
        return hit

    # ---- gather: one pass stacking every member's existing allocs.
    per_eval_allocs: List[List[Allocation]] = []
    requireds: List[Dict[str, TaskGroup]] = []
    e_idx: List[int] = []
    a_jmi: List[int] = []  # alloc's job-modify index
    e_jmi: List[int] = []  # owning eval's job-modify index (repeated)
    a_term: List[bool] = []
    a_taint: List[bool] = []
    a_req: List[bool] = []
    a_lostable: List[bool] = []  # client running/pending (lost-markable)
    for i, m in enumerate(members):
        ev = m.eval
        m.job = state.job_by_id(ev.job_id)
        allocs = state.allocs_by_job(ev.job_id)
        per_eval_allocs.append(allocs)
        if ev.triggered_by not in COHORT_FAST_TRIGGERS:
            m.reason = f"trigger {ev.triggered_by!r}"
        elif ev.status != consts.EVAL_STATUS_PENDING:
            m.reason = f"status {ev.status!r}"
        elif ev.annotate_plan:
            m.reason = "annotated plan"
        elif m.job is None or getattr(m.job, "stop", False):
            m.reason = "job stopped/deregistered"
        elif m.job.type not in (consts.JOB_TYPE_SERVICE,
                                consts.JOB_TYPE_BATCH):
            m.reason = f"job type {m.job.type!r}"
        elif m.job.type == consts.JOB_TYPE_BATCH and allocs:
            # ran_successfully()/newest-per-slot filtering is batch-only
            # reconcile state the per-eval path owns.
            m.reason = "batch job with history"
        elif allocs and any(
                tg.ephemeral_disk is not None and tg.ephemeral_disk.sticky
                for tg in m.job.task_groups):
            m.reason = "sticky ephemeral disk"
        elif any(getattr(tg, "gang", None) is not None
                 for tg in m.job.task_groups):
            # Gang task groups (nomad_tpu/gang) carry all-or-nothing
            # semantics the array materialize path does not reproduce
            # (atomic gang-leg staging, pop_gang unwind, whole-gang
            # replacement). The per-eval DENSE scheduler is their
            # single source of truth; routing there keeps the gang ONE
            # eval with K asks — one dispatch of the all-K program —
            # never K batch rows.
            m.reason = "gang task group"
        required = materialize_task_groups(m.job) if not m.reason else {}
        requireds.append(required)
        if m.reason:
            continue
        jmi = m.job.job_modify_index
        for a in allocs:
            e_idx.append(i)
            a_jmi.append(a.job.job_modify_index if a.job else 0)
            e_jmi.append(jmi)
            a_term.append(a.terminal_status())
            a_taint.append(tainted(a.node_id))
            a_req.append(a.name in required)
            a_lostable.append(a.client_status in (
                consts.ALLOC_CLIENT_RUNNING, consts.ALLOC_CLIENT_PENDING))

    # ---- classify: vectorized over the stacked table.
    if e_idx:
        eidx = np.asarray(e_idx, np.int64)
        term = np.asarray(a_term, bool)
        taint = np.asarray(a_taint, bool)
        req = np.asarray(a_req, bool)
        updated = np.asarray(a_jmi, np.int64) != np.asarray(e_jmi, np.int64)
        lostable = np.asarray(a_lostable, bool)
        # Live alloc on a tainted node -> migrate/lost; name outside the
        # required set -> stop; stale job version -> update: all legacy.
        # A terminal-by-desired-status alloc whose client still runs on
        # a tainted node needs the lost-marking pass
        # (update_non_terminal_allocs_to_lost) — legacy too.
        legacy = (~term & (taint | ~req | updated)) | (taint & lostable)
        codes = np.where(legacy, _COHORT_LEGACY,
                         np.where(term & req, _COHORT_PLACE_PREV,
                                  _COHORT_IGNORE))
        legacy_counts = np.bincount(eidx[codes == _COHORT_LEGACY],
                                    minlength=len(members))
    else:
        codes = np.zeros(0, np.int64)
        legacy_counts = np.zeros(len(members), np.int64)

    # ---- assemble: place = required minus live names, prev-alloc from
    # the newest terminal holder of the slot (previous_allocation).
    flat = 0
    for i, m in enumerate(members):
        allocs = per_eval_allocs[i]
        n = len(allocs) if not m.reason else 0
        if m.reason:
            continue
        if legacy_counts[i]:
            m.reason = "diff has stop/update/migrate/lost buckets"
            flat += n
            continue
        live_names = set()
        terminal_prev: Dict[str, Allocation] = {}
        for k, a in enumerate(allocs):
            code = codes[flat + k]
            if code == _COHORT_PLACE_PREV:
                prev = terminal_prev.get(a.name)
                if prev is None or prev.create_index < a.create_index:
                    terminal_prev[a.name] = a
            elif not a.terminal_status():
                live_names.add(a.name)
        flat += n
        m.fast = True
        required = requireds[i]
        for name, tg in required.items():
            if name in live_names:
                continue
            m.place.append(AllocTuple(name, tg, terminal_prev.get(name)))
            m.queued[tg.name] = m.queued.get(tg.name, 0) + 1
        if not m.place:
            for tg in m.job.task_groups:
                m.queued.setdefault(tg.name, 0)
    return members


def adjust_queued_allocations(
    logger, result: Optional[PlanResult], queued_allocs: Dict[str, int]
) -> None:
    """Decrement per-TG queued counts by the placements the plan applier
    actually accepted."""
    if result is None:
        return
    for allocations in result.node_allocation.values():
        for allocation in allocations:
            if allocation.create_index != result.alloc_index:
                continue
            if allocation.task_group in queued_allocs:
                queued_allocs[allocation.task_group] -= 1
