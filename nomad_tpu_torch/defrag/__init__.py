"""Continuous cluster defragmentation: the port of the JAX package's
defrag package, so far its solve and its wave evals.

- the **solve** is kernels/convex.py's mirror-descent program run
  globally over the cluster's node state (defrag/solver.py, K9),
  warm-started from the previous round's iterate;
- the **moves** become per-job ``triggered_by=defrag-migration`` evals
  (``build_wave_evals``) that the generic scheduler stages as
  migrations: an eviction leg plus a replacement placement that
  prefers the solver's target node, in one plan.

The JAX package's ``DefragLoop`` (the leader-side thread that gates on
admission pressure and leadership, and claims migration-governor slots
per wave) drives a server, which the port does not have yet.
"""

from __future__ import annotations

import time
from typing import Dict, List

from .solver import (  # noqa: F401 (re-exported rig surface)
    COLD_ITERS,
    MAX_SOLVE_ALLOCS,
    WARM_ITERS,
    DefragPlan,
    Move,
    WarmState,
    cluster_fragmentation,
    compute_defrag_plan,
    frag_score,
    reference_asks,
)

# How long a wave's markers stay valid (the JAX package's DefragLoop
# reclaims a wave's governor slots after it): an eval surfacing later
# stages no budget-exempt evictions.
WAVE_TIMEOUT = 60.0


def build_wave_evals(state, moves: List[Move]) -> List:
    """Per-job defrag evals for one wave's move set. Jobs deregistered
    since the solve snapshot drop out (their allocs are dying anyway);
    the eval carries the marked alloc ids and the solver's target per
    alloc (a preference, not a mandate — scheduler/generic.py)."""
    from ..structs import Evaluation, consts
    from ..utils.ids import generate_uuid

    by_job: Dict[str, List[Move]] = {}
    for mv in moves:
        by_job.setdefault(mv.job_id, []).append(mv)
    evals = []
    expires = time.time() + WAVE_TIMEOUT
    for job_id in sorted(by_job):
        job = state.job_by_id(job_id)
        if job is None or getattr(job, "stop", False):
            continue
        job_moves = by_job[job_id]
        evals.append(Evaluation(
            id=generate_uuid(),
            priority=job.priority,
            type=job.type,
            triggered_by=consts.EVAL_TRIGGER_DEFRAG,
            job_id=job_id,
            job_modify_index=job.job_modify_index,
            status=consts.EVAL_STATUS_PENDING,
            trace_id=generate_uuid(),
            defrag_alloc_ids=[mv.alloc_id for mv in job_moves],
            defrag_targets={mv.alloc_id: mv.to_node
                            for mv in job_moves},
            defrag_wave_expires=expires,
        ))
    return evals


__all__ = [
    "COLD_ITERS",
    "MAX_SOLVE_ALLOCS",
    "WARM_ITERS",
    "DefragPlan",
    "Move",
    "WarmState",
    "build_wave_evals",
    "cluster_fragmentation",
    "compute_defrag_plan",
    "frag_score",
    "reference_asks",
]
