"""The dense GPU scheduler factories ("service-gpu", "batch-gpu").

The counterpart of the JAX package's scheduler/tpu.py
BatchedTPUScheduler: the host scheduler's control flow — the same
reconciliation, blocked-eval and rolling semantics, the same plan
shape — with computePlacements run as one dense program on the device
(ops/binpack.py through scheduler/batcher.py). In-place updates and
sticky-disk preferences stay host-side; exact port numbers are
assigned host-side on the chosen nodes.

A device fault raises out of ``process_eval``: there is no host
fallback around the dispatch. The routing rules that are semantics
stay as in the JAX package: sticky placements, and evals with at most
3 asks, take the host path.
"""

from __future__ import annotations

from typing import Dict, List

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


def build_placement_config(batch: bool, pre_resolve: bool, placements,
                           ask_arrays):
    """The PlacementConfig the dense scheduler hands the batcher."""
    from ..ops.binpack import PlacementConfig, uniform_dh_flag
    from .stack import (
        BATCH_JOB_ANTI_AFFINITY_PENALTY,
        SERVICE_JOB_ANTI_AFFINITY_PENALTY,
    )

    return PlacementConfig(
        anti_affinity_penalty=(
            BATCH_JOB_ANTI_AFFINITY_PENALTY if batch
            else SERVICE_JOB_ANTI_AFFINITY_PENALTY),
        pre_resolve=pre_resolve,
        # Uniform distinct-hosts shape: one TG scaled to count=K under
        # distinct-hosts collapses the K-step scan to one scoring pass
        # + top-k (ops/binpack.py uniform_topk).
        uniform_dh=uniform_dh_flag(placements, ask_arrays[5],
                                   ask_arrays[6]),
    )


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
    for, else it raises."""

    def __init__(self, logger, state, planner, batch=False, rng=None,
                 device=None):
        from ..device import default_device

        super().__init__(logger, state, planner, batch=batch, rng=rng)
        self.device = device if device is not None else default_device()

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
        if preemption_eligible(self.eval.priority):
            raise NotImplementedError(
                "preemption-eligible eval: the dense preemption pass is "
                "ported in a later slice (ROADMAP Queue A, preemption)")
        if len(bulk) <= 3:
            # Too few placements to amortize a dispatch: the host
            # iterators place a handful with identical semantics.
            super()._compute_placements(bulk)
            return

        matrix = ClusterMatrix(self.state, self.job, self.plan)
        tg_indices = {tg.name: i for i, tg in enumerate(self.job.task_groups)}
        placements = [tg_indices[m.task_group.name] for m in bulk]
        ask_arrays = matrix.build_asks(placements)
        asks = make_asks(*ask_arrays)
        config = build_placement_config(
            self.batch, bool(getattr(self.planner, "pre_resolve", False)),
            placements, ask_arrays)
        key = host_prng_key(self.rng.getrandbits(31))
        choices, scores = get_batcher(self.device).place(
            matrix, asks, key, config)

        # Host-side exact port assignment per chosen node, incremental.
        net_indexes: Dict[str, NetworkIndex] = {}
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
