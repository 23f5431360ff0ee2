"""The dense GPU scheduler factories ("service-gpu", "batch-gpu",
"system-gpu").

The counterpart of the JAX package's scheduler/tpu.py
BatchedTPUScheduler: the host scheduler's control flow — the same
reconciliation, blocked-eval and rolling semantics, the same plan
shape — with computePlacements run as one dense program on the device
(ops/binpack.py through scheduler/batcher.py, with the placement
kernel the instance pins or the active one, nomad_tpu_torch/kernels;
each committed plan scored on the quality board), gang task groups as
one all-K program each (ops/gang.py), and the asks a preemption-eligible
eval could not place as one place-or-preempt program
(ops/preempt.py). In-place updates and sticky-disk preferences stay
host-side; exact port numbers are assigned host-side on the chosen
nodes.

A device fault raises out of ``process_eval``: there is no host
fallback around the dispatch. The routing rules that are semantics
stay as in the JAX package: sticky placements, and evals with at most
3 asks, take the host path.

The flight recorder (trace/) gets the JAX package's stage spans under
each eval's id and trace id: matrix.build, matrix.update (the base's
build kind and delta rows), matrix.compress (a zero-length span
carrying the class index's stats), device.dispatch around the batcher
call (the batcher adds device.solve inside it), gang.select and
preempt.select, and matrix.build on the system path. The JAX
package's breaker and host-fallback variants of these spans, and
their counters (scheduler.breaker_rejected, host_fallback,
gang_breaker_rejected, gang_host_fallback, preempt_breaker_rejected,
preempt_dispatch_failed), have no path here: there is no breaker and
no fallback. A gang whose exact ports miss on a device-chosen node
counts scheduler.gang_port_fallback (utils/metrics.py), as there.

"system-gpu" (DenseSystemScheduler, the JAX package's DenseSystemScheduler
behind "system-tpu") is the system scheduler with its diff and its
pinned placements as vectorized numpy passes over a ClusterMatrix of
the pinned nodes. System placement pins every alloc to its node, so
there is nothing to search: like the reference, it runs on the host and
launches no kernel.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import trace
from ..structs import (
    Allocation,
    AllocMetric,
    NetworkIndex,
    Resources,
    consts,
)
from ..utils.ids import generate_uuid
from .generic import GenericScheduler
from .system import SystemScheduler
from .util import AllocTuple


def _offer_networks(rng, missing: AllocTuple, node, net_indexes, matrix):
    """Exact per-task network offers on a dense-path-chosen node.
    Returns {task: Resources} or None if a port can't be assigned."""
    idx = net_indexes.get(node.id)
    if idx is None:
        idx = NetworkIndex()
        idx.set_node(node)
        idx.add_allocs(matrix._proposed_allocs(node.id))
        net_indexes[node.id] = idx

    task_resources: Dict[str, Resources] = {}
    for task in missing.task_group.tasks:
        resources = task.resources.copy()
        if resources.networks:
            ask = resources.networks[0]
            offer, err = idx.assign_network(ask, rng)
            if offer is None:
                # Drop the partially-updated index; it is rebuilt
                # from the plan on next use.
                net_indexes.pop(node.id, None)
                return None
            idx.add_reserved(offer)
            resources.networks = [offer]
        task_resources[task.name] = resources
    return task_resources


def build_placement_config(batch: bool, pre_resolve: bool, kernel,
                           placements, ask_arrays):
    """The PlacementConfig the dense scheduler hands the batcher.
    ``kernel`` pins the placement kernel; None takes the process-global
    active one (kernels.configure)."""
    from ..kernels import active_kernel
    from ..ops.binpack import PlacementConfig, uniform_dh_flag
    from .stack import (
        BATCH_JOB_ANTI_AFFINITY_PENALTY,
        SERVICE_JOB_ANTI_AFFINITY_PENALTY,
    )

    kernel = kernel or active_kernel()
    return PlacementConfig(
        anti_affinity_penalty=(
            BATCH_JOB_ANTI_AFFINITY_PENALTY if batch
            else SERVICE_JOB_ANTI_AFFINITY_PENALTY),
        pre_resolve=pre_resolve,
        # Uniform distinct-hosts shape: one TG scaled to count=K under
        # distinct-hosts collapses the K-step scan to one scoring pass
        # + top-k (ops/binpack.py uniform_topk). Greedy only: another
        # kernel runs its own joint solve.
        uniform_dh=(kernel == "greedy" and uniform_dh_flag(
            placements, ask_arrays[5], ask_arrays[6])),
        kernel=kernel,
    )


def note_quality(logger, job, kernel, matrix, ask_res, committed) -> None:
    """Quality board entry (kernels/quality.py) for one dense plan's
    committed claims, (ask row, node row) pairs: the base utilization
    plus those claims, scored on the fragmentation and bin-pack axes
    under the kernel's name. Scoring never fails an eval."""
    from ..kernels.quality import (
        get_board,
        quality_from_arrays,
        reference_ask,
    )

    try:
        if not get_board().should_sample(kernel):
            return
        util = np.asarray(matrix.util).copy()
        if committed:
            js = np.asarray([j for j, _r in committed])
            rows = np.asarray([r for _j, r in committed])
            np.add.at(util, rows, np.asarray(ask_res)[js])
        q = quality_from_arrays(util, matrix.capacity, matrix.node_ok,
                                reference_ask(job))
        get_board().note_plan(kernel, q["fragmentation"],
                              q["binpack_score"])
    except Exception:  # noqa: BLE001 - scoring must never fail an eval
        logger.warning("placement-quality scoring failed", exc_info=True)


def _build_allocation(sched, missing: AllocTuple, node, task_resources,
                      metrics) -> Allocation:
    """The Allocation literal the dense scheduler appends to the plan."""
    alloc = Allocation(
        id=generate_uuid(),
        eval_id=sched.eval.id,
        name=missing.name,
        job_id=sched.job.id,
        task_group=missing.task_group.name,
        metrics=metrics,
        node_id=node.id,
        task_resources=task_resources,
        desired_status=consts.ALLOC_DESIRED_RUN,
        client_status=consts.ALLOC_CLIENT_PENDING,
        shared_resources=Resources(
            disk_mb=missing.task_group.ephemeral_disk.size_mb
        ),
    )
    if missing.alloc is not None and missing.alloc.id:
        alloc.previous_allocation = missing.alloc.id
    return alloc


class BatchedGPUScheduler(GenericScheduler):
    """GenericScheduler whose bulk placement loop runs on the device.

    The device is resolved when the scheduler is made
    (``device.default_device()``): CUDA, or the CPU only when asked
    for, else it raises. ``kernel`` pins the placement kernel
    (nomad_tpu_torch/kernels) for this instance, as the
    ``service-<kernel>-gpu`` factories do; None defers to the
    process-global active kernel."""

    def __init__(self, logger, state, planner, batch=False, rng=None,
                 device=None, kernel=None):
        from ..device import default_device

        super().__init__(logger, state, planner, batch=batch, rng=rng)
        self.device = device if device is not None else default_device()
        self.kernel = kernel

    def _inplace_update(self, updates):
        """Batched host-side in-place routing (scheduler/util.py
        inplace_update_batched): compatible tweaks rewrite allocs with
        zero evictions and zero device dispatches; only destructive
        updates flow on to the dense placement path."""
        from .util import inplace_update_batched

        return inplace_update_batched(
            self.ctx, self.eval, self.job, self.stack, updates)

    def _compute_placements(self, place: List[AllocTuple]) -> None:
        from ..migrate import preemption_eligible
        from ..models.matrix import ClusterMatrix
        from ..ops.binpack import host_prng_key, make_asks
        from .batcher import get_batcher

        # Gang task groups take the dense all-K pass: one gang = one
        # dispatch of ops/gang.py's program, staged on the plan's gang
        # leg.
        gang_sets, place = self._split_gang_placements(place)
        for tg, tuples in gang_sets:
            self._place_gang_dense(tg, tuples)
        if not place:
            if gang_sets:
                self._repay_cohort()
            return
        # Sticky-disk placements keep the host path (they pin to one node).
        sticky: List[AllocTuple] = []
        bulk: List[AllocTuple] = []
        for missing in place:
            if self._find_preferred_node(missing) is not None:
                sticky.append(missing)
            else:
                bulk.append(missing)
        if sticky:
            super()._compute_placements(sticky)
        # A TG that already failed (e.g. in the sticky host path) only
        # coalesces from here on (generic_sched.go:444-447).
        remaining: List[AllocTuple] = []
        for missing in bulk:
            if self.failed_tg_allocs and missing.task_group.name in self.failed_tg_allocs:
                self.failed_tg_allocs[missing.task_group.name].coalesced_failures += 1
            else:
                remaining.append(missing)
        bulk = remaining
        if not bulk:
            self._repay_cohort()
            return
        may_preempt = preemption_eligible(self.eval.priority)
        if len(bulk) <= 3 and not may_preempt:
            # Too few placements to amortize a dispatch: the host
            # iterators place a handful with identical semantics. A
            # preemption-eligible eval stays dense at any size: the host
            # iterators cannot evict.
            self._repay_cohort()
            super()._compute_placements(bulk)
            return

        _t0 = time.monotonic()
        matrix = ClusterMatrix(self.state, self.job, self.plan)
        _t_base = time.monotonic()
        tg_indices = {tg.name: i for i, tg in enumerate(self.job.task_groups)}
        placements = [tg_indices[m.task_group.name] for m in bulk]
        ask_arrays = matrix.build_asks(placements)
        asks = make_asks(*ask_arrays)
        trace.record_span(self.eval.id, trace.STAGE_MATRIX_BUILD, _t0,
                          ann={"placements": len(bulk)},
                          trace_id=self.eval.trace_id)
        # How this eval's base came to be (cache hit, incremental delta
        # or full rebuild) and how many node rows the delta touched.
        trace.record_span(
            self.eval.id, trace.STAGE_MATRIX_UPDATE, _t0, _t_base,
            ann={"kind": matrix.build_kind, "rows": matrix.delta_rows},
            trace_id=self.eval.trace_id)
        # How far the fleet interned (models/classes.py): a zero-length
        # marker whose value is its annotation.
        trace.record_span(
            self.eval.id, trace.STAGE_MATRIX_COMPRESS, _t_base, _t_base,
            ann=matrix.class_index.stats(), trace_id=self.eval.trace_id)
        config = build_placement_config(
            self.batch, bool(getattr(self.planner, "pre_resolve", False)),
            self.kernel, placements, ask_arrays)
        key = host_prng_key(self.rng.getrandbits(31))
        # The announced place() call is about to arrive: mark the
        # cohort unit consumed so the dispatch pipeline does not also
        # repay it (place() itself decrements the batcher's counter).
        if getattr(self.planner, "announced_cohort", False):
            self.planner.announced_cohort = False
        _t0 = time.monotonic()
        choices, scores = get_batcher(self.device).place(
            matrix, asks, key, config,
            span=(self.eval.id, self.eval.trace_id))
        trace.record_span(self.eval.id, trace.STAGE_DEVICE_DISPATCH, _t0,
                          trace_id=self.eval.trace_id)

        # Host-side exact port assignment per chosen node, incremental.
        net_indexes: Dict[str, NetworkIndex] = {}
        # Placements appended to the plan, (ask row, node row): the
        # quality board scores committed claims only.
        committed: List[Tuple[int, int]] = []
        # Asks the kernel could not place: candidates for the dense
        # preemption pass (eligible evals only) before they become
        # recorded failures.
        unplaced: List[AllocTuple] = []
        for j, missing in enumerate(bulk):
            # Coalesce once the TG has failed, even if the kernel found a
            # node for a later ask of that TG (host-loop invariant).
            if self.failed_tg_allocs and missing.task_group.name in self.failed_tg_allocs:
                self.failed_tg_allocs[missing.task_group.name].coalesced_failures += 1
                continue

            choice = int(choices[j])
            node = matrix.nodes[choice] if 0 <= choice < matrix.n_real else None

            metrics = AllocMetric()
            metrics.nodes_evaluated = matrix.n_real
            metrics.nodes_available = matrix.nodes_by_dc

            if node is None:
                if may_preempt:
                    unplaced.append(missing)
                else:
                    self._record_placement_failure(
                        missing, matrix, metrics, tg_indices)
                continue

            metrics.score_node(node, "binpack", float(scores[j]))
            task_resources = _offer_networks(
                self.rng, missing, node, net_indexes, matrix
            )
            if task_resources is None:
                # Dense port-count approximation missed a real collision:
                # the exact host path places this one.
                super()._compute_placements([missing])
                continue

            self.plan.append_alloc(_build_allocation(
                self, missing, node, task_resources, metrics))
            committed.append((j, choice))

        note_quality(self.logger, self.job, config.kernel, matrix,
                     ask_arrays[0], committed)
        if unplaced:
            self._preempt_placements(unplaced, tg_indices)

    def _repay_cohort(self) -> None:
        """Un-announce this eval's place() call: the dispatch pipeline
        told the batcher a dispatch was coming (add_cohort), but this
        eval took a host path instead — without the repayment the
        batcher's window would stretch COHORT_WAIT_MAX for a request
        that never arrives."""
        if getattr(self.planner, "announced_cohort", False):
            from .batcher import get_batcher

            self.planner.announced_cohort = False
            get_batcher(self.device).cohort_cancel(1)

    def _place_gang_dense(self, tg, tuples: List[AllocTuple]) -> None:
        """One gang's all-K dispatch (ops/gang.py, K7): per-node member
        capacity, topology-group capacity, slice selection and K-step
        member assignment in one program over the cluster matrix.
        Members stage through the plan's gang leg
        (Plan.append_gang_alloc). A device fault raises."""
        from ..gang import build_gang_state, gang_key, note_gang_result
        from ..models.matrix import ClusterMatrix
        from ..ops.binpack import host_prng_key
        from ..ops.gang import gang_placement
        from ..utils import metrics as _metrics

        name = tg.name
        if self.failed_tg_allocs and name in self.failed_tg_allocs:
            self.failed_tg_allocs[name].coalesced_failures += len(tuples)
            return

        _t0 = time.monotonic()
        # The matrix includes this plan's earlier staged legs (gang
        # replacement stops free their capacity through the proposed-
        # alloc overlay): the all-K pass must see the room the
        # survivors' stops open up.
        matrix = ClusterMatrix(self.state, self.job, self.plan)
        state, active, (ask_res, ask_bw, ask_ports), config = \
            build_gang_state(matrix, self.job, tg)
        key = host_prng_key(self.rng.getrandbits(31))
        choices, scores, slice_group = (
            x.cpu().numpy() for x in gang_placement(
                state, ask_res, ask_bw, ask_ports, active, key, config,
                self.device))
        trace.record_span(
            self.eval.id, trace.STAGE_GANG_SELECT, _t0,
            ann={"members": len(tuples), "mode": config.mode,
                 "slice_group": int(slice_group)},
            trace_id=self.eval.trace_id)

        if int(choices[0]) < 0:
            # Whole-gang reject on the device (no slice fits all K, or a
            # member found no node): ONE failure for the TG, with class
            # eligibility from the feasibility mask so the blocked eval
            # re-runs when capacity returns.
            note_gang_result(False, len(tuples), "device")
            m = AllocMetric()
            m.nodes_evaluated = matrix.n_real
            m.nodes_available = matrix.nodes_by_dc
            tg_indices = {g.name: i
                          for i, g in enumerate(self.job.task_groups)}
            self._record_placement_failure(tuples[0], matrix, m,
                                           tg_indices)
            if len(tuples) > 1:
                self.failed_tg_allocs[name].coalesced_failures += (
                    len(tuples) - 1)
            return

        # Materialize: exact host-side port offers per member, staged on
        # the gang leg. ANY member failing port assignment unwinds the
        # whole gang to the host gang stack (exact ports there): a
        # partial gang never survives this loop.
        gkey = gang_key(self.job.id, name)
        net_indexes: Dict[str, NetworkIndex] = {}
        for j, missing in enumerate(tuples):
            choice = int(choices[j])
            node = (matrix.nodes[choice]
                    if 0 <= choice < matrix.n_real else None)
            m = AllocMetric()
            m.nodes_evaluated = matrix.n_real
            m.nodes_available = matrix.nodes_by_dc
            task_resources = None
            if node is not None:
                m.score_node(node, "gang", float(scores[j]))
                task_resources = _offer_networks(
                    self.rng, missing, node, net_indexes, matrix)
            if task_resources is None:
                self.plan.pop_gang(gkey)
                _metrics.incr_counter(
                    ("scheduler", "gang_port_fallback"), len(tuples))
                self._place_gang_host(tg, tuples)
                return
            self.plan.append_gang_alloc(gkey, _build_allocation(
                self, missing, node, task_resources, m))
        note_gang_result(True, len(tuples), "device")

    def _preempt_placements(self, pending: List[AllocTuple],
                            tg_indices: Dict[str, int]) -> None:
        """The dense preemption pass (ops/preempt.py, K6): place the
        asks the normal pass could not, choosing lowest-priority victims
        and the placement in the same masked program. Runs only when
        migrate.preemption_eligible said yes. Victim evictions are
        staged on the plan's node_preemptions leg with the placements
        they make room for. A device fault raises."""
        from ..migrate import note_preemption
        from ..models.matrix import ClusterMatrix
        from ..ops.binpack import (
            PlacementConfig,
            host_prng_key,
            make_asks,
            make_node_state,
        )
        from ..ops.preempt import make_victim_state, preempt_placement
        from .stack import (
            BATCH_JOB_ANTI_AFFINITY_PENALTY,
            SERVICE_JOB_ANTI_AFFINITY_PENALTY,
        )
        from .util import ALLOC_PREEMPTED

        _t0 = time.monotonic()
        # A FRESH matrix including this very plan's placements and staged
        # stops: the preemption pass must not claim headroom an earlier
        # ask of this same eval just took, and its victim lists must
        # exclude allocs the plan already stops.
        pm = ClusterMatrix(self.state, self.job, self.plan)
        varrays, victim_lists, n_candidates = pm.build_victims(
            self.eval.priority)
        if n_candidates == 0:
            for missing in pending:
                name = missing.task_group.name
                if self.failed_tg_allocs and name in self.failed_tg_allocs:
                    self.failed_tg_allocs[name].coalesced_failures += 1
                    continue
                metrics = AllocMetric()
                metrics.nodes_evaluated = pm.n_real
                metrics.nodes_available = pm.nodes_by_dc
                self._record_placement_failure(missing, pm, metrics,
                                               tg_indices)
            return
        placements = [tg_indices[m.task_group.name] for m in pending]
        asks = make_asks(*pm.build_asks(placements))
        state = make_node_state(
            pm.capacity, pm.sched_capacity, pm.util, pm.bw_avail,
            pm.bw_used, pm.ports_free, pm.job_count, pm.tg_count,
            pm.feasible, pm.node_ok)
        victims = make_victim_state(*varrays)
        penalty = (BATCH_JOB_ANTI_AFFINITY_PENALTY if self.batch
                   else SERVICE_JOB_ANTI_AFFINITY_PENALTY)
        # Plain greedy config: the preemption program is its own entry
        # point.
        config = PlacementConfig(anti_affinity_penalty=penalty)
        key = host_prng_key(self.rng.getrandbits(31))
        choices, scores, counts = (
            x.cpu().numpy() for x in preempt_placement(
                state, victims, asks, key,
                np.float32(self.eval.priority), config, self.device))
        trace.record_span(
            self.eval.id, trace.STAGE_PREEMPT_SELECT, _t0,
            ann={"asks": len(pending), "candidates": n_candidates},
            trace_id=self.eval.trace_id)

        net_indexes: Dict[str, NetworkIndex] = {}
        consumed: Dict[int, int] = {}
        staged_total = 0
        placed_total = 0
        for j, missing in enumerate(pending):
            name = missing.task_group.name
            if self.failed_tg_allocs and name in self.failed_tg_allocs:
                self.failed_tg_allocs[name].coalesced_failures += 1
                continue
            choice = int(choices[j])
            node = pm.nodes[choice] if 0 <= choice < pm.n_real else None
            metrics = AllocMetric()
            metrics.nodes_evaluated = pm.n_real
            metrics.nodes_available = pm.nodes_by_dc
            if node is None:
                self._record_placement_failure(missing, pm, metrics,
                                               tg_indices)
                continue
            # The kernel returns a count: the victims are the node's next
            # unconsumed candidates, in the order build_victims sorted
            # them (the device's order).
            cnt = int(counts[j])
            taken = []
            if cnt > 0:
                lst = victim_lists.get(choice, [])
                start = consumed.get(choice, 0)
                taken = lst[start:start + cnt]
                consumed[choice] = start + len(taken)
            for victim in taken:
                self.plan.append_preemption(
                    victim, consts.ALLOC_DESIRED_EVICT, ALLOC_PREEMPTED)
            metrics.score_node(node, "preempt", float(scores[j]))
            task_resources = _offer_networks(
                self.rng, missing, node, net_indexes, pm)
            if task_resources is None:
                # Port collision on the chosen node: back the victims
                # out — an eviction must never commit without the
                # placement it was freeing room for.
                self.plan.pop_preemptions(node.id, len(taken))
                self._record_placement_failure(missing, pm, metrics,
                                               tg_indices)
                continue
            self.plan.append_alloc(_build_allocation(
                self, missing, node, task_resources, metrics))
            staged_total += len(taken)
            placed_total += 1
        note_preemption(staged_total, placed_total)

    def _record_placement_failure(
        self, missing: AllocTuple, matrix, metrics, tg_indices: Dict[str, int]
    ) -> None:
        name = missing.task_group.name
        gi = tg_indices[name]
        infeasible = int(matrix.n_real - matrix.feasible[: matrix.n_real, gi].sum())
        metrics.nodes_filtered = infeasible
        metrics.nodes_exhausted = matrix.n_real - infeasible
        if self.failed_tg_allocs is None:
            self.failed_tg_allocs = {}
        self.failed_tg_allocs[name] = metrics
        # Feed the blocked-eval machinery per-class eligibility from the mask.
        elig = self.ctx.eligibility
        for i, node in enumerate(matrix.nodes):
            if node.computed_class:
                elig.set_task_group_eligibility(
                    bool(matrix.feasible[i, gi]), name, node.computed_class
                )


def dense_diff_system_allocs(state, job, nodes, tainted, allocs,
                             terminal_allocs):
    """diff_system_allocs (scheduler/util.go:62) with the place set
    feasibility-gated up front: the host version materializes one
    AllocTuple (and a stub Allocation) per required slot on every ready
    node, then the placement loop filters the infeasible ones one
    Python iteration at a time; at 10k nodes with rack-scoped system
    jobs that is ~9k tuples built and discarded per eval. Here the
    class-vectorized constraint mask picks the candidate rows first and
    only those materialize; the infeasible remainder is returned as
    per-task-group counts for the caller's metric and queued
    bookkeeping (SystemScheduler._merge_prefiltered).

    Returns (DiffResult, prefiltered) where prefiltered maps
    tg name -> [count, first_infeasible_node]."""
    from ..models.matrix import node_feasibility, ready_class_index
    from .util import DiffResult, diff_allocs, materialize_task_groups

    groups = job.task_groups
    class_ids, class_reps = ready_class_index(state, nodes, job.datacenters)
    feasible = node_feasibility(state, job, groups, nodes,
                                class_ids, class_reps)
    gi_by_name = {tg.name: gi for gi, tg in enumerate(groups)}
    required = materialize_task_groups(job)
    result = DiffResult()
    prefiltered: Dict[str, list] = {}

    def gate_place(tuples, row):
        """Feasibility-gate one node's place tuples."""
        kept = []
        for tup in tuples:
            if feasible[row, gi_by_name[tup.task_group.name]]:
                kept.append(tup)
            else:
                ent = prefiltered.get(tup.task_group.name)
                if ent is None:
                    prefiltered[tup.task_group.name] = [1, nodes[row]]
                else:
                    ent[0] += 1
        return kept

    node_row = {n.id: i for i, n in enumerate(nodes)}
    # Nodes holding this job's allocs: the per-node diff (stop, lost,
    # update and ignore need the alloc-level comparisons).
    node_allocs: Dict[str, List[Allocation]] = {}
    for alloc in allocs:
        node_allocs.setdefault(alloc.node_id, []).append(alloc)
    for node_id, nallocs in node_allocs.items():
        diff = diff_allocs(job, tainted, required, nallocs, terminal_allocs)
        if node_id in tainted:
            diff.place = []
        else:
            row = node_row.get(node_id)
            for tup in diff.place:
                if tup.alloc is None or tup.alloc.node_id != node_id:
                    tup.alloc = Allocation(node_id=node_id)
            diff.place = (gate_place(diff.place, row)
                          if row is not None else diff.place)
        # A tainted node invalidates the job there: migrations -> stops.
        diff.stop.extend(diff.migrate)
        diff.migrate = []
        result.append(diff)

    # Nodes without allocs place every required slot; the candidates and
    # the infeasible tally come from array ops, Python only touches the
    # (usually few) feasible rows.
    has_alloc = np.zeros(len(nodes), bool)
    for node_id in node_allocs:
        row = node_row.get(node_id)
        if row is not None:
            has_alloc[row] = True
    candidates = ~has_alloc
    if tainted:
        for node_id in tainted:
            row = node_row.get(node_id)
            if row is not None:
                candidates[row] = False
    cand_feasible = candidates[:, None] & feasible
    any_rows = np.flatnonzero(cand_feasible.any(axis=1))
    for i in any_rows:
        node_id = nodes[i].id
        for name, tg in required.items():
            if not cand_feasible[i, gi_by_name[tg.name]]:
                continue
            talloc = terminal_allocs.get(name)
            if talloc is None or talloc.node_id != node_id:
                talloc = Allocation(node_id=node_id)
            result.place.append(AllocTuple(name, tg, talloc))
    # Infeasible tallies and the first offender per task group, without
    # materializing them.
    slots_per_tg = {tg.name: 0 for tg in groups}
    for _name, tg in required.items():
        slots_per_tg[tg.name] += 1
    for tg in groups:
        gi = gi_by_name[tg.name]
        bad = candidates & ~feasible[:, gi]
        n_bad = int(bad.sum()) * slots_per_tg[tg.name]
        if not n_bad:
            continue
        ent = prefiltered.get(tg.name)
        if ent is None:
            prefiltered[tg.name] = [n_bad, nodes[int(np.argmax(bad))]]
        else:
            ent[0] += n_bad
    return result, prefiltered


class DenseSystemScheduler(SystemScheduler):
    """SystemScheduler whose diff and placement loops are vectorized
    passes ("system-gpu").

    The host loop (system_sched.go:255) builds a one-node iterator
    stack per pinned placement; here the whole placement set is checked
    against a single ClusterMatrix of the pinned nodes: constraint
    feasibility comes from the [N, G] mask, resource fit is a
    vectorized AllocsFit over the pinned rows, and in-eval utilization
    accumulates per task group so multi-group system jobs see their own
    earlier placements. The diff is feasibility-gated up front
    (dense_diff_system_allocs), so the pinned matrix and the plan only
    ever see candidate nodes.

    Host numpy only, as in the JAX package: no device is resolved and
    no kernel launches. The pinned matrix build records matrix.build
    (``pinned: True``) on the eval's trace, as the JAX package's
    does."""

    def _diff_system(self, tainted, allocs, terminal_allocs):
        """Feasibility-gated diff (see dense_diff_system_allocs). A
        deregistered job (job=None: every alloc diffs into stop) takes
        the host diff: there is nothing to gate without constraints."""
        if self.job is None:
            return super()._diff_system(tainted, allocs, terminal_allocs)
        return dense_diff_system_allocs(
            self.state, self.job, self.nodes, tainted, allocs,
            terminal_allocs)

    def _compute_placements(self, place: List[AllocTuple]) -> None:
        from ..models.matrix import ClusterMatrix

        # Matrix only the pinned nodes: system placements are fixed to
        # their node up front (diff_system_allocs), so feasibility and
        # fit for the other N-P nodes would be wasted work; at 10k nodes
        # with rack-scoped jobs that is a 200x smaller matrix per eval.
        pinned_ids = []
        seen = set()
        for missing in place:
            nid = missing.alloc.node_id
            if nid not in seen:
                seen.add(nid)
                pinned_ids.append(nid)
        by_id = {n.id: n for n in self.nodes}
        pinned_nodes = [by_id[nid] for nid in pinned_ids if nid in by_id]
        _t0 = time.monotonic()
        matrix = ClusterMatrix(self.state, self.job, self.plan,
                               nodes=pinned_nodes)
        matrix.nodes_by_dc = self.nodes_by_dc
        node_index = {n.id: i for i, n in enumerate(matrix.nodes)}
        tg_by_name = {tg.name: i for i, tg in enumerate(self.job.task_groups)}

        placements = [tg_by_name[m.task_group.name] for m in place]
        resources, bw, ports, _tg_index, _active, _jdh, _tdh = \
            matrix.build_asks(placements)
        trace.record_span(self.eval.id, trace.STAGE_MATRIX_BUILD, _t0,
                          ann={"placements": len(place), "pinned": True},
                          trace_id=self.eval.trace_id)

        util = matrix.util.copy()
        bw_used = matrix.bw_used.copy()
        ports_free = matrix.ports_free.copy()

        rows = np.empty(len(place), np.int64)
        for j, missing in enumerate(place):
            row = node_index.get(missing.alloc.node_id)
            if row is None:
                raise RuntimeError(
                    f"could not find node {missing.alloc.node_id!r}")
            rows[j] = row

        gis = np.asarray(placements)
        feasible = matrix.feasible[rows, gis]
        # Vectorized AllocsFit per task group so same-node placements of
        # different groups accumulate (G passes, each all numpy). The
        # ask arrays from build_asks are per-placement rows; every row
        # of one group carries that group's ask.
        fits = np.zeros(len(place), bool)
        for gi in sorted(set(placements)):
            sel = gis == gi
            j0 = int(np.flatnonzero(sel)[0])
            ask_res, ask_bw, ask_ports = resources[j0], bw[j0], ports[j0]
            r = rows[sel]
            ok = (
                feasible[sel]
                & np.all(util[r] + ask_res <= matrix.capacity[r], axis=1)
                & (bw_used[r] + ask_bw <= matrix.bw_avail[r])
                & (ports_free[r] >= ask_ports)
            )
            fits[sel] = ok
            acc = r[ok]
            np.add.at(util, acc, ask_res)
            np.add.at(bw_used, acc, ask_bw)
            np.add.at(ports_free, acc, -ask_ports)

        net_indexes: Dict[str, NetworkIndex] = {}
        # Successful pinned placements all carry the identical metric
        # record (one node evaluated, same availability): one object is
        # shared across the plan. The store's upsert copies each alloc
        # and its metrics (state/store.py upsert_allocs,
        # Allocation.copy), so the sharing is invisible downstream.
        success_metrics: Optional[AllocMetric] = None

        for j, missing in enumerate(place):
            name = missing.task_group.name
            node = matrix.nodes[rows[j]]

            if not fits[j]:
                # Failure paths mutate their metric record, so those
                # stay per placement, like the host path where every
                # stack.select starts fresh; the pinned node is the one
                # node evaluated.
                metrics = AllocMetric()
                metrics.nodes_available = self.nodes_by_dc
                metrics.evaluate_node()
                if not feasible[j]:
                    # Constraint mismatch: the alloc was never really
                    # "queued" on this node (the host path's
                    # nodes_filtered branch undoes the count).
                    metrics.filter_node(node, "constraint")
                    self.queued_allocs[name] -= 1
                    if (
                        self.eval.annotate_plan
                        and self.plan.annotations is not None
                        and name in self.plan.annotations.desired_tg_updates
                    ):
                        self.plan.annotations.desired_tg_updates[name].place -= 1
                else:
                    metrics.exhausted_node(node, "resources")
                # Record the first failure per task group, coalesce the
                # rest, for filtered and exhausted alike
                # (system_sched.go:261).
                if self.failed_tg_allocs and name in self.failed_tg_allocs:
                    self.failed_tg_allocs[name].coalesced_failures += 1
                else:
                    if self.failed_tg_allocs is None:
                        self.failed_tg_allocs = {}
                    self.failed_tg_allocs[name] = metrics
                continue

            task_resources = self._offer_networks_on(
                missing, node, net_indexes, matrix)
            if task_resources is None:
                # The port-count approximation missed a collision: the
                # exact host path places this one alloc.
                super()._compute_placements([missing])
                continue

            if success_metrics is None:
                success_metrics = AllocMetric()
                success_metrics.nodes_available = self.nodes_by_dc
                success_metrics.evaluate_node()
            self.plan.append_alloc(_build_allocation(
                self, missing, node, task_resources, success_metrics))

    def _offer_networks_on(self, missing: AllocTuple, node, net_indexes,
                           matrix):
        """Exact per-task network offers on the pinned node (the same
        logic as the service path's)."""
        has_networks = any(
            t.resources is not None and t.resources.networks
            for t in missing.task_group.tasks
        )
        if not has_networks:
            return {
                t.name: t.resources.copy()
                for t in missing.task_group.tasks
            }
        return _offer_networks(self.rng, missing, node, net_indexes, matrix)
