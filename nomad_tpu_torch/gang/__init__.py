"""Gang scheduling: all-or-nothing multi-node placement on the
node-topology tensor — the port of the JAX package's gang/__init__.py.

A task group carrying a ``gang`` stanza (structs/job.py ``Gang``)
places its ``count`` members atomically, all K or none:

- the dense leg (ops/gang.py, kernel K7) runs the all-K pass over the
  cluster matrix: per-node member capacity, topology-group capacity,
  slice selection, K-step member assignment, all-K enforced on the
  device;
- the host leg (gang/host.py) gives the same semantics through the
  sequential iterator stack: the host ``service`` scheduler's gang
  path, and the dense path's unwind when a member's port offer
  collides;
- members stage through ``Plan.append_gang_alloc`` into the
  ``gang_groups`` leg, so a plan names every gang's members;
- losing one member replaces the whole gang (scheduler/generic.py
  ``_promote_gang_replacements``).

This module holds the spec and routing helpers both scheduler paths
use; it never touches the state store.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, List, Optional, Tuple

from ..structs import Job, TaskGroup, consts

from ..structs.job import Gang  # noqa: F401 (re-export)

__all__ = [
    "Gang",
    "gang_spec",
    "gang_task_groups",
    "is_gang_job",
    "gang_key",
    "gang_mode",
    "build_gang_config",
    "build_gang_state",
    "gang_distinct_hosts",
    "note_gang_result",
    "gang_stats",
    "reset_gang_stats",
    "spread_cap",
]


def gang_spec(tg: TaskGroup) -> Optional[Gang]:
    """The task group's gang stanza, or None. getattr-shielded so jobs
    decoded from pre-gang wire payloads (no field) behave as plain
    groups."""
    return getattr(tg, "gang", None)


def gang_task_groups(job: Optional[Job]) -> List[TaskGroup]:
    if job is None:
        return []
    return [tg for tg in job.task_groups if gang_spec(tg) is not None]


def is_gang_job(job: Optional[Job]) -> bool:
    return bool(gang_task_groups(job))


def gang_key(job_id: str, tg_name: str) -> str:
    """The Plan.gang_groups key for one gang: a (job, task group)
    pair — a gang is a TG-scoped unit."""
    return f"{job_id}/{tg_name}"


def gang_mode(gang: Gang) -> Tuple[str, str]:
    """(mode, topology level) for the dense/host programs. ``free``
    keeps atomicity with no topology policy; its level defaults to
    "rack" only so a column exists to thread (the program ignores
    it)."""
    from ..ops.gang import (
        GANG_MODE_AFFINITY,
        GANG_MODE_FREE,
        GANG_MODE_SLICE,
        GANG_MODE_SPREAD,
    )

    if gang.slice:
        return GANG_MODE_SLICE, gang.slice
    if gang.spread:
        return GANG_MODE_SPREAD, gang.spread
    if gang.affinity:
        return GANG_MODE_AFFINITY, gang.affinity
    return GANG_MODE_FREE, "rack"


def gang_distinct_hosts(job: Job, tg: TaskGroup) -> bool:
    dh = any(c.operand == consts.CONSTRAINT_DISTINCT_HOSTS
             for c in job.constraints)
    return dh or any(c.operand == consts.CONSTRAINT_DISTINCT_HOSTS
                     for c in tg.constraints)


def build_gang_config(job: Job, tg: TaskGroup, topo_groups: int):
    """The GangConfig for one (job, gang TG) against a topology column
    with ``topo_groups`` groups (g_pad on TOPO_GROUP_BUCKETS)."""
    from ..models.topology import topo_group_pad
    from ..ops.gang import GangConfig
    from ..scheduler.stack import (
        BATCH_JOB_ANTI_AFFINITY_PENALTY,
        SERVICE_JOB_ANTI_AFFINITY_PENALTY,
    )

    mode, _level = gang_mode(gang_spec(tg))
    return GangConfig(
        anti_affinity_penalty=(
            BATCH_JOB_ANTI_AFFINITY_PENALTY
            if job.type == consts.JOB_TYPE_BATCH
            else SERVICE_JOB_ANTI_AFFINITY_PENALTY),
        mode=mode,
        distinct_hosts=gang_distinct_hosts(job, tg),
        g_pad=topo_group_pad(topo_groups),
    )


def build_gang_state(matrix, job: Job, tg: TaskGroup):
    """(GangState, active [K_pad], ask (res, bw, ports), config) for
    one gang dispatch against a ClusterMatrix. Reuses the matrix's
    memoized feasibility mask and overlay counts — the gang pass adds
    no per-eval host recomputation beyond slicing them."""
    import numpy as np

    from ..models.matrix import ASK_BUCKETS, bucket_size
    from ..ops.gang import GANG_MODE_SLICE, make_gang_state

    gi = next(i for i, g in enumerate(job.task_groups)
              if g.name == tg.name)
    k = tg.count
    k_pad = bucket_size(max(k, 1), ASK_BUCKETS)
    active = np.zeros(k_pad, bool)
    active[:k] = True

    # Uniform member ask from the matrix's shared group-size pass
    # (one row; gang members are identical by construction).
    resources, bw, ports, _tgi, _act, _jdh, _tdh = \
        matrix.build_asks([gi])
    ask_res, ask_bw, ask_ports = resources[0], bw[0], ports[0]

    mode, level = gang_mode(gang_spec(tg))
    topo = matrix.topology
    if mode == GANG_MODE_SLICE:
        topo_ids = topo.column(level)
        topo_groups = topo.counts[level]
    else:
        topo_ids, topo_groups = topo.singleton_column(level)

    feas_row = matrix.feasible[:, gi] & matrix.node_ok
    dh = gang_distinct_hosts(job, tg)
    job_dh = any(c.operand == consts.CONSTRAINT_DISTINCT_HOSTS
                 for c in job.constraints)
    if dh:
        dh_presence = (matrix.job_count if job_dh
                       else matrix.tg_count[:, gi])
    else:
        dh_presence = np.zeros(matrix.n, np.int32)

    state = make_gang_state(
        matrix.capacity, matrix.sched_capacity, matrix.util,
        matrix.bw_avail, matrix.bw_used, matrix.ports_free,
        feas_row, matrix.job_count, dh_presence, topo_ids)
    config = build_gang_config(job, tg, topo_groups)
    return state, active, (ask_res, ask_bw, ask_ports), config


# ---------------------------------------------------------------- stats

_stats_lock = threading.Lock()
_stats: Dict[str, int] = {}


def note_gang_result(placed: bool, members: int, path: str) -> None:
    """Count one gang attempt's outcome (leaf lock, constant work).
    ``path`` is "device" | "host"."""
    with _stats_lock:
        _stats["gangs_placed" if placed else "gangs_rejected"] = (
            _stats.get("gangs_placed" if placed else "gangs_rejected", 0)
            + 1)
        if placed:
            _stats["members_placed"] = (
                _stats.get("members_placed", 0) + members)
        key = f"path_{path}"
        _stats[key] = _stats.get(key, 0) + 1


def gang_stats() -> Dict[str, int]:
    with _stats_lock:
        return dict(_stats)


def reset_gang_stats() -> None:
    with _stats_lock:
        _stats.clear()


def spread_cap(k: int, eligible_groups: int) -> int:
    """The spread mode's per-group member cap (the host leg's, the same
    formula as the device's)."""
    return int(math.ceil(k / max(eligible_groups, 1)))
