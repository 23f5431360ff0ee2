"""GenericScheduler: service and batch jobs.

Reference: scheduler/generic_sched.go:59 (GenericScheduler),
:103 (Process), :183 (process), :281 (filterCompleteAllocs),
:349 (computeJobAllocs), :432 (computePlacements),
:507 (findPreferredNode).
"""

from __future__ import annotations

import logging
import random
import time
from typing import Dict, List, Optional

from ..structs import (
    AllocMetric,
    Allocation,
    Evaluation,
    Job,
    Plan,
    PlanResult,
    Resources,
    consts,
)
from ..utils.ids import generate_uuid
from .context import EvalContext
from .stack import GenericStack
from .util import (
    ALLOC_GANG_REPLACED,
    ALLOC_LOST,
    ALLOC_MIGRATING,
    ALLOC_NOT_NEEDED,
    ALLOC_UPDATING,
    AllocTuple,
    _append_update_with_client,
    SetStatusError,
    adjust_queued_allocations,
    desired_updates,
    diff_allocs,
    evict_and_place,
    inplace_update,
    mark_lost_and_place,
    materialize_task_groups,
    progress_made,
    ready_nodes_in_dcs,
    retry_max,
    set_status,
    tainted_nodes,
    update_non_terminal_allocs_to_lost,
)

MAX_SERVICE_SCHEDULE_ATTEMPTS = 5
MAX_BATCH_SCHEDULE_ATTEMPTS = 2

BLOCKED_EVAL_MAX_PLAN_DESC = "created due to placement conflicts"
BLOCKED_EVAL_FAILED_PLACEMENTS = "created to place remaining allocations"


class GenericScheduler:
    def __init__(self, logger, state, planner, batch: bool,
                 rng: Optional[random.Random] = None):
        self.logger = logger or logging.getLogger("nomad_tpu_torch.scheduler")
        self.state = state
        self.planner = planner
        self.batch = batch
        self.rng = rng or random.Random()

        self.eval: Optional[Evaluation] = None
        self.job: Optional[Job] = None
        self.plan: Optional[Plan] = None
        self.plan_result: Optional[PlanResult] = None
        self.ctx: Optional[EvalContext] = None
        self.stack: Optional[GenericStack] = None

        self.limit_reached = False
        self.next_eval: Optional[Evaluation] = None
        self.blocked: Optional[Evaluation] = None
        self.failed_tg_allocs: Optional[Dict[str, AllocMetric]] = None
        self.queued_allocs: Optional[Dict[str, int]] = None
        # Migration-budget bookkeeping (nomad_tpu/migrate): slots this
        # attempt holds (released when the attempt's submit finishes)
        # and the follow-up eval minted for deferred displaced allocs.
        self._migrate_permits = 0
        self._migration_eval: Optional[Evaluation] = None

    # ------------------------------------------------------------------

    def process_eval(self, eval: Evaluation) -> None:
        """Handle a single evaluation end to end."""
        self.eval = eval

        if eval.triggered_by not in (
            consts.EVAL_TRIGGER_JOB_REGISTER,
            consts.EVAL_TRIGGER_NODE_UPDATE,
            consts.EVAL_TRIGGER_JOB_DEREGISTER,
            consts.EVAL_TRIGGER_ROLLING_UPDATE,
            consts.EVAL_TRIGGER_PERIODIC_JOB,
            consts.EVAL_TRIGGER_MAX_PLANS,
            consts.EVAL_TRIGGER_MIGRATION,
            consts.EVAL_TRIGGER_PREEMPTION,
            consts.EVAL_TRIGGER_DEFRAG,
        ):
            desc = f"scheduler cannot handle '{eval.triggered_by}' evaluation reason"
            set_status(
                self.logger, self.planner, self.eval, self.next_eval, self.blocked,
                self.failed_tg_allocs, consts.EVAL_STATUS_FAILED, desc,
                self.queued_allocs,
            )
            return

        limit = MAX_BATCH_SCHEDULE_ATTEMPTS if self.batch else MAX_SERVICE_SCHEDULE_ATTEMPTS
        try:
            retry_max(limit, self._process, lambda: progress_made(self.plan_result))
        except SetStatusError as err:
            # No forward progress: leave a blocked eval to retry when
            # resources change, then record the failure.
            self._create_blocked_eval(plan_failure=True)
            set_status(
                self.logger, self.planner, self.eval, self.next_eval, self.blocked,
                self.failed_tg_allocs, err.eval_status, str(err), self.queued_allocs,
            )
            return

        # A blocked eval that still couldn't place everything goes back to
        # the blocked tracker with refreshed class eligibility.
        if (
            self.eval.status == consts.EVAL_STATUS_BLOCKED
            and self.failed_tg_allocs
        ):
            e = self.ctx.eligibility
            new_eval = self.eval.copy()
            new_eval.escaped_computed_class = e.has_escaped()
            new_eval.class_eligibility = e.get_classes()
            self.planner.reblock_eval(new_eval)
            return

        set_status(
            self.logger, self.planner, self.eval, self.next_eval, self.blocked,
            self.failed_tg_allocs, consts.EVAL_STATUS_COMPLETE, "",
            self.queued_allocs,
        )

    # ------------------------------------------------------------------

    def _create_blocked_eval(self, plan_failure: bool) -> None:
        e = self.ctx.eligibility
        escaped = e.has_escaped()
        class_eligibility = {} if escaped else e.get_classes()
        self.blocked = self.eval.create_blocked_eval(class_eligibility, escaped)
        if plan_failure:
            self.blocked.triggered_by = consts.EVAL_TRIGGER_MAX_PLANS
            self.blocked.status_description = BLOCKED_EVAL_MAX_PLAN_DESC
        else:
            self.blocked.status_description = BLOCKED_EVAL_FAILED_PLACEMENTS
        self.planner.create_eval(self.blocked)

    def _process(self) -> bool:
        """One scheduling attempt; returns True when done. Migration-
        budget slots claimed by the attempt (nomad_tpu/migrate) are
        held until its plan submit finishes — success or failure, the
        displaced allocs are no longer in flight HERE once the attempt
        ends, and a retry re-claims against fresh state."""
        self._migrate_permits = 0
        try:
            return self._process_attempt()
        finally:
            if self._migrate_permits:
                from ..migrate import get_governor

                get_governor().release(self._migrate_permits)
                self._migrate_permits = 0

    def _process_attempt(self) -> bool:
        self.job = self.state.job_by_id(self.eval.job_id)
        self.queued_allocs = {}

        self.plan = self.eval.make_plan(self.job)
        self.failed_tg_allocs = None
        self.ctx = EvalContext(self.state, self.plan, self.logger, rng=self.rng)
        self.stack = GenericStack(self.batch, self.ctx)
        if self.job is not None:
            self.stack.set_job(self.job)

        self._compute_job_allocs()

        # Unplaced allocations need a blocked eval to retry on capacity
        # changes; reuse the current one if we're already blocked.
        if (
            self.eval.status != consts.EVAL_STATUS_BLOCKED
            and self.failed_tg_allocs
            and self.blocked is None
        ):
            self._create_blocked_eval(plan_failure=False)

        if self.plan.is_no_op() and not self.eval.annotate_plan:
            return True

        # Rolling-update limit reached: schedule the next batch after the
        # stagger period.
        if self.limit_reached and self.next_eval is None:
            self.next_eval = self.eval.next_rolling_eval(self.job.update.stagger)
            self.planner.create_eval(self.next_eval)

        result, new_state = self.planner.submit_plan(self.plan)
        self.plan_result = result

        adjust_queued_allocations(self.logger, result, self.queued_allocs)

        if result is not None and result.node_preemptions:
            self._create_preemption_followups(result)

        if new_state is not None:
            self.state = new_state
            return False

        full_commit, expected, actual = result.full_commit(self.plan)
        if not full_commit:
            self.logger.debug(
                "eval %s: attempted %d placements, %d placed",
                self.eval.id, expected, actual,
            )
            raise RuntimeError("missing state refresh after partial commit")

        return True

    def _create_preemption_followups(self, result: PlanResult) -> None:
        """Every job whose alloc this plan's preemption leg evicted
        gets a replacement eval (triggered_by=preemption) — it usually
        blocks until capacity returns (the cluster was red), but the
        evicted work is never silently forgotten. One eval per job per
        process_eval, however many attempts commit victims."""
        followed = getattr(self, "_preempt_followed", None)
        if followed is None:
            followed = self._preempt_followed = set()
        from ..structs.eval import new_eval

        for victims in result.node_preemptions.values():
            for victim in victims:
                if victim.job_id in followed:
                    continue
                followed.add(victim.job_id)
                job = self.state.job_by_id(victim.job_id)
                if job is None:
                    continue
                self.planner.create_eval(
                    new_eval(job, consts.EVAL_TRIGGER_PREEMPTION))

    # ------------------------------------------------------------------

    def _inplace_update(self, updates: List[AllocTuple]):
        """In-place-vs-destructive routing hook: the host scheduler
        runs the reference's sequential stage-evict-select-pop pass;
        the dense subclass swaps in the batched host-side check
        (scheduler/util.py inplace_update_batched) so only genuinely
        destructive updates reach the device placement path."""
        return inplace_update(
            self.ctx, self.eval, self.job, self.stack, updates)

    def _live_defrag_marks(self) -> set:
        """The eval's defrag-marked alloc ids, IF the wave is still
        live. Expired markers (defrag_wave_expires passed — the loop
        abandoned the wave and released its governor slots) are void:
        staging budget-exempt evictions against slots nobody holds
        would silently exceed migrate_max_parallel, and the solve the
        markers came from is stale regardless. One gate feeds BOTH the
        ignore->migrate promotion and the budget exemption, so they
        can never disagree."""
        ids = self.eval.defrag_alloc_ids
        if not ids:
            return set()
        expires = self.eval.defrag_wave_expires
        if expires and time.time() >= expires:
            self.logger.info(
                "eval %s: defrag wave markers expired; ignoring %d "
                "marked allocs", self.eval.id, len(ids))
            return set()
        return set(ids)

    def _route_updates(self, updates: List[AllocTuple]):
        """In-place routing with GANG all-or-nothing semantics
        (gang/): a gang task group's updates go in-place only
        if EVERY member does. A mixed verdict — some members in-place,
        some destructive (a tightened constraint failing on one node,
        a dead node) — would hide the in-place members from
        _promote_gang_replacements, which only reads the diff buckets:
        the gang would re-place a PARTIAL member set, the exact state
        the all-K program exists to reject. On a mixed verdict the
        already-staged in-place rewrites unwind off the plan and every
        member routes destructive, so promotion rebuilds the whole
        gang."""
        from ..gang import gang_spec

        gang_updates: Dict[str, List[AllocTuple]] = {}
        rest: List[AllocTuple] = []
        for tup in updates:
            tg = tup.task_group
            if tg is not None and gang_spec(tg) is not None:
                gang_updates.setdefault(tg.name, []).append(tup)
            else:
                rest.append(tup)
        destructive, inplace = self._inplace_update(rest)
        for name, tuples in gang_updates.items():
            g_destr, g_inplace = self._inplace_update(tuples)
            if not g_destr:
                inplace.extend(g_inplace)
                continue
            # unwind the staged in-place rewrites (same alloc ids)
            staged = {t.alloc.id for t in g_inplace}
            if staged:
                for node_id in list(self.plan.node_allocation):
                    kept = [a for a in self.plan.node_allocation[node_id]
                            if a.id not in staged]
                    if kept:
                        self.plan.node_allocation[node_id] = kept
                    else:
                        del self.plan.node_allocation[node_id]
                self.logger.info(
                    "eval %s: gang %s/%s update split in-place/"
                    "destructive; routing all %d members destructive "
                    "for whole-gang replacement", self.eval.id,
                    self.eval.job_id, name, len(tuples))
            destructive.extend(g_destr)
            destructive.extend(g_inplace)
        return destructive, inplace

    def _promote_gang_replacements(self, diff) -> None:
        """Gang semantics for reconciliation (gang/): if ANY
        member of a gang task group is being replaced (lost node,
        drained node, destructive update, or a missing slot), the
        WHOLE gang replaces — survivors in the ignore bucket are
        stopped and every member joins diff.place so the gang's
        placement pass runs with the complete member set (the all-K
        program rejects partial sets by construction). Gang members
        are pulled OUT of the migrate/update/lost buckets: the
        migration budget and rolling limits batch work in partial
        waves, and a partially-deferred gang could never place."""
        from ..gang import gang_task_groups

        gangs = gang_task_groups(self.job)
        if not gangs:
            return

        def of(bucket, name):
            return [t for t in bucket
                    if t.task_group is not None
                    and t.task_group.name == name]

        for tg in gangs:
            ignored = of(diff.ignore, tg.name)
            lost = of(diff.lost, tg.name)
            moving = (of(diff.place, tg.name) + of(diff.migrate, tg.name)
                      + of(diff.update, tg.name))
            if not lost and not moving:
                continue  # gang untouched, or fully ignored
            if not ignored and not lost and not of(diff.migrate, tg.name) \
                    and not of(diff.update, tg.name):
                continue  # fresh placement: already the complete set
            self.logger.info(
                "eval %s: gang %s/%s member set disturbed; staging "
                "whole-gang replacement (%d survivors stopped)",
                self.eval.id, self.eval.job_id, tg.name, len(ignored))
            # Survivors + movers stop; every member re-places. Lost
            # members additionally record client LOST.
            for tup in of(diff.migrate, tg.name):
                diff.migrate.remove(tup)
                self.plan.append_update(
                    tup.alloc, consts.ALLOC_DESIRED_STOP,
                    ALLOC_GANG_REPLACED)
                diff.place.append(tup)
            for tup in of(diff.update, tg.name):
                diff.update.remove(tup)
                self.plan.append_update(
                    tup.alloc, consts.ALLOC_DESIRED_STOP,
                    ALLOC_GANG_REPLACED)
                diff.place.append(tup)
            for tup in of(diff.lost, tg.name):
                diff.lost.remove(tup)
                _append_update_with_client(
                    self.plan, tup.alloc, consts.ALLOC_DESIRED_STOP,
                    ALLOC_LOST, consts.ALLOC_CLIENT_LOST)
                diff.place.append(tup)
            for tup in ignored:
                diff.ignore.remove(tup)
                self.plan.append_update(
                    tup.alloc, consts.ALLOC_DESIRED_STOP,
                    ALLOC_GANG_REPLACED)
                diff.place.append(tup)

    def _defer_migrations(self) -> None:
        """Mint (once per eval) the follow-up migration eval that
        re-runs this job's reconciliation for the displaced allocs the
        budget deferred. Deliberately NOT placed in the next_eval slot:
        that seat belongs to the rolling-update stagger follow-up, and
        displacing it would collapse the operator's stagger pacing to
        MIGRATE_RETRY_WAIT whenever a drain coincides with a rolling
        deploy — the two follow-ups coexist (the broker dedups per-job
        delivery; a no-op re-reconciliation is cheap)."""
        if self._migration_eval is not None:
            return
        from ..migrate import MIGRATE_RETRY_WAIT

        ev = self.eval.next_migration_eval(MIGRATE_RETRY_WAIT)
        self._migration_eval = ev
        self.planner.create_eval(ev)

    def _filter_complete_allocs(self, allocs: List[Allocation]):
        """Drop terminal allocs; for batch, keep successfully-completed
        work done and replace only failures (generic_sched.go:281)."""

        def should_filter(a: Allocation) -> bool:
            if self.batch:
                if a.desired_status in (
                    consts.ALLOC_DESIRED_STOP,
                    consts.ALLOC_DESIRED_EVICT,
                ):
                    return not a.ran_successfully()
                return a.client_status == consts.ALLOC_CLIENT_FAILED
            return a.terminal_status()

        terminal: Dict[str, Allocation] = {}
        remaining: List[Allocation] = []
        for a in allocs:
            if should_filter(a):
                prev = terminal.get(a.name)
                if prev is None or prev.create_index < a.create_index:
                    terminal[a.name] = a
            else:
                remaining.append(a)

        if self.batch:
            # Keep only the newest alloc per slot name.
            by_name: Dict[str, Allocation] = {}
            for a in remaining:
                cur = by_name.get(a.name)
                if cur is None or cur.create_index < a.create_index:
                    by_name[a.name] = a
            remaining = list(by_name.values())

        return remaining, terminal

    def _compute_job_allocs(self) -> None:
        groups = materialize_task_groups(self.job)
        allocs = self.state.allocs_by_job(self.eval.job_id)
        tainted = tainted_nodes(self.state, allocs)

        update_non_terminal_allocs_to_lost(self.plan, tainted, allocs)

        allocs, terminal_allocs = self._filter_complete_allocs(allocs)

        diff = diff_allocs(self.job, tainted, groups, allocs, terminal_allocs)

        # Continuous defragmentation (nomad_tpu/defrag): a defrag eval
        # marks specific healthy allocs for migration — promote them
        # out of the ignore bucket so they ride the SAME evict-and-
        # place leg as drain migrations (applier-verified eviction +
        # replacement placement in one plan, exactly-once terminal).
        # Allocs the diff already routed elsewhere (update/stop/lost:
        # the cluster moved since the solve snapshot) keep their
        # routing — defrag never overrides reconciliation.
        marked = self._live_defrag_marks()
        if marked:
            keep: List[AllocTuple] = []
            for tup in diff.ignore:
                if (tup.alloc is not None and tup.alloc.id in marked
                        and not tup.alloc.terminal_status()):
                    diff.migrate.append(tup)
                else:
                    keep.append(tup)
            diff.ignore = keep

        self.logger.debug("eval %s job %s: %s", self.eval.id, self.eval.job_id, diff)

        for e in diff.stop:
            self.plan.append_update(e.alloc, consts.ALLOC_DESIRED_STOP, ALLOC_NOT_NEEDED)

        destructive, inplace = self._route_updates(diff.update)
        diff.update = destructive

        # Whole-gang replacement (gang/): a gang that loses or must move
        # ANY member cannot keep running at K-1 — survivors are stopped
        # and all K members re-place as one atomic unit. Runs AFTER
        # in-place routing (an env tweak keeps the gang in place) and
        # BEFORE the budget/limit legs (a gang must never be split
        # across migration waves or rolling batches).
        self._promote_gang_replacements(diff)

        if self.eval.annotate_plan:
            from ..structs import PlanAnnotations

            self.plan.annotations = PlanAnnotations(
                desired_tg_updates=desired_updates(diff, inplace, destructive)
            )

        limit = [len(diff.update) + len(diff.migrate) + len(diff.lost)]
        if self.job is not None and self.job.update is not None and self.job.update.rolling():
            limit = [self.job.update.max_parallel]

        # Drain-storm migration budget (nomad_tpu/migrate): claim
        # in-flight slots for the displaced allocs; whatever the
        # governor defers rides a follow-up migration eval instead of
        # joining this plan — a 100-node drain storm drains in bounded
        # waves instead of thundering-herding the plan queue.
        migrate_now = diff.migrate
        if migrate_now:
            from ..migrate import get_governor

            # Defrag-marked migrations are budget-EXEMPT here: the
            # defrag loop already claimed their governor slots when it
            # minted the wave (and releases them when this eval goes
            # terminal) — re-claiming would double-count the wave
            # against migrate_max_parallel. They sort first so a
            # partial grant never defers a pre-claimed move. The
            # exemption applies only while the wave's markers are LIVE
            # (_live_defrag_marks): past defrag_wave_expires the loop
            # has released those slots.
            pre_claimed = 0
            marked = self._live_defrag_marks()
            if marked:
                pre = [t for t in migrate_now
                       if t.alloc is not None and t.alloc.id in marked]
                rest = [t for t in migrate_now
                        if t.alloc is None or t.alloc.id not in marked]
                migrate_now = pre + rest
                pre_claimed = len(pre)
            granted = pre_claimed + get_governor().acquire(
                len(migrate_now) - pre_claimed)
            self._migrate_permits += granted - pre_claimed
            deferred = len(migrate_now) - granted
            if deferred:
                migrate_now = migrate_now[:granted]
                self._defer_migrations()
            self.limit_reached = evict_and_place(
                self.ctx, diff, migrate_now, ALLOC_MIGRATING, limit
            )
        else:
            self.limit_reached = False
        self.limit_reached = self.limit_reached or evict_and_place(
            self.ctx, diff, diff.update, ALLOC_UPDATING, limit
        )
        self.limit_reached = self.limit_reached or mark_lost_and_place(
            self.ctx, diff, diff.lost, ALLOC_LOST, limit
        )

        if not diff.place:
            if self.job is not None:
                for tg in self.job.task_groups:
                    self.queued_allocs[tg.name] = 0
            return

        for tup in diff.place:
            self.queued_allocs[tup.task_group.name] = (
                self.queued_allocs.get(tup.task_group.name, 0) + 1
            )

        self._compute_placements(diff.place)

    def _split_gang_placements(self, place: List[AllocTuple]):
        """(gang sets, rest): gang TGs' tuples grouped per task group
        for the all-or-nothing paths, everything else placed
        one-at-a-time as before."""
        from ..gang import gang_spec

        gang_sets: Dict[str, List[AllocTuple]] = {}
        gang_tgs = {}
        rest: List[AllocTuple] = []
        for missing in place:
            tg = missing.task_group
            if tg is not None and gang_spec(tg) is not None:
                gang_sets.setdefault(tg.name, []).append(missing)
                gang_tgs[tg.name] = tg
            else:
                rest.append(missing)
        return [(gang_tgs[name], tuples)
                for name, tuples in gang_sets.items()], rest

    def _place_gang_host(self, tg, tuples: List[AllocTuple]) -> None:
        """All-or-nothing gang placement through the host iterator
        stack (gang/host.py). Stages everything or records
        ONE whole-gang failure for the TG (which feeds the blocked-
        eval machinery like any other placement failure)."""
        from ..gang import note_gang_result
        from ..gang.host import place_gang_host
        from ..structs import AllocMetric

        if self.failed_tg_allocs and tg.name in self.failed_tg_allocs:
            self.failed_tg_allocs[tg.name].coalesced_failures += len(tuples)
            return
        ok = place_gang_host(self, tg, tuples)
        note_gang_result(ok, len(tuples), "host")
        if ok:
            return
        nodes, by_dc = ready_nodes_in_dcs(self.state, self.job.datacenters)
        metrics = AllocMetric()
        metrics.nodes_evaluated = len(nodes)
        metrics.nodes_available = by_dc
        if self.failed_tg_allocs is None:
            self.failed_tg_allocs = {}
        self.failed_tg_allocs[tg.name] = metrics
        # Gang-aware class eligibility: the member selects inside
        # place_gang_host ran the feasibility chain per class (the
        # FeasibilityWrapper populates ctx.eligibility), so infeasible
        # classes are already marked ineligible for the blocked eval;
        # classes it never visited stay unknown, which the blocked
        # tracker treats as eligible — capacity returning ANYWHERE a
        # gang might fit re-runs the all-K pass (unknown-is-eligible,
        # server/blocked.py), never the reverse.

    def _compute_placements(self, place: List[AllocTuple]) -> None:
        gang_sets, place = self._split_gang_placements(place)
        for tg, tuples in gang_sets:
            self._place_gang_host(tg, tuples)
        if not place:
            return
        nodes, by_dc = ready_nodes_in_dcs(self.state, self.job.datacenters)
        self.stack.set_nodes(nodes)

        for missing in place:
            if self.failed_tg_allocs and missing.task_group.name in self.failed_tg_allocs:
                self.failed_tg_allocs[missing.task_group.name].coalesced_failures += 1
                continue

            preferred = self._find_preferred_node(missing)
            if preferred is not None:
                option, _ = self.stack.select_preferring_nodes(
                    missing.task_group, [preferred]
                )
            else:
                option, _ = self.stack.select(missing.task_group)

            self.ctx.metrics.nodes_available = by_dc

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
                if missing.alloc is not None:
                    alloc.previous_allocation = missing.alloc.id
                self.plan.append_alloc(alloc)
            else:
                if self.failed_tg_allocs is None:
                    self.failed_tg_allocs = {}
                self.failed_tg_allocs[missing.task_group.name] = self.ctx.metrics

    def _find_preferred_node(self, missing: AllocTuple):
        """Sticky ephemeral disk pins the replacement to its old node;
        a defrag eval prefers the solver's target node for each marked
        alloc (a PREFERENCE: select_preferring_nodes falls back to the
        full node set, so an infeasible target costs nothing)."""
        if missing.alloc is not None and self.eval.defrag_targets:
            target_id = self.eval.defrag_targets.get(missing.alloc.id)
            if target_id:
                node = self.state.node_by_id(target_id)
                if node is not None and node.ready():
                    return node
        if missing.alloc is None or missing.alloc.job is None:
            return None
        tg = missing.alloc.job.lookup_task_group(missing.alloc.task_group)
        if tg is None or tg.ephemeral_disk is None or not tg.ephemeral_disk.sticky:
            return None
        node = self.state.node_by_id(missing.alloc.node_id)
        if node is not None and node.ready():
            return node
        return None
