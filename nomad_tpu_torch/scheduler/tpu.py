"""The dense GPU scheduler factories ("service-gpu", "batch-gpu").

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
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from ..structs import (
    Allocation,
    AllocMetric,
    NetworkIndex,
    Resources,
    consts,
)
from ..utils.ids import generate_uuid
from .generic import GenericScheduler
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
            return
        may_preempt = preemption_eligible(self.eval.priority)
        if len(bulk) <= 3 and not may_preempt:
            # Too few placements to amortize a dispatch: the host
            # iterators place a handful with identical semantics. A
            # preemption-eligible eval stays dense at any size: the host
            # iterators cannot evict.
            super()._compute_placements(bulk)
            return

        matrix = ClusterMatrix(self.state, self.job, self.plan)
        tg_indices = {tg.name: i for i, tg in enumerate(self.job.task_groups)}
        placements = [tg_indices[m.task_group.name] for m in bulk]
        ask_arrays = matrix.build_asks(placements)
        asks = make_asks(*ask_arrays)
        config = build_placement_config(
            self.batch, bool(getattr(self.planner, "pre_resolve", False)),
            self.kernel, placements, ask_arrays)
        key = host_prng_key(self.rng.getrandbits(31))
        choices, scores = get_batcher(self.device).place(
            matrix, asks, key, config)

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

        name = tg.name
        if self.failed_tg_allocs and name in self.failed_tg_allocs:
            self.failed_tg_allocs[name].coalesced_failures += len(tuples)
            return

        # The matrix includes this plan's earlier staged legs (gang
        # replacement stops free their capacity through the proposed-
        # alloc overlay): the all-K pass must see the room the
        # survivors' stops open up.
        matrix = ClusterMatrix(self.state, self.job, self.plan)
        state, active, (ask_res, ask_bw, ask_ports), config = \
            build_gang_state(matrix, self.job, tg)
        key = host_prng_key(self.rng.getrandbits(31))
        choices, scores, _slice_group = (
            x.cpu().numpy() for x in gang_placement(
                state, ask_res, ask_bw, ask_ports, active, key, config,
                self.device))

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
