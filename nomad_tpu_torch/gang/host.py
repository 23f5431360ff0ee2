"""Host sequential gang placement: the CPU twin of ops/gang.py — the
port of the JAX package's gang/host.py.

Used two ways, both demanding the same semantics (not the same
scores) as the dense program:

- the host ``service`` scheduler's gang path, and so the parity target
  of the dense program's hard masks (slice contiguity, spread caps,
  distinct_hosts, all-K-or-nothing);
- the dense path's unwind when a member's exact port offer collides on
  the node the program chose (scheduler/tpu.py ``_place_gang_dense``).

Slice selection mirrors the device policy: the TIGHTEST topology group
whose estimated member capacity covers all K is tried first; the host
path then walks the remaining sufficient groups, which the one-shot
dense program does not.

Everything stages through ``Plan.append_gang_alloc`` and unwinds with
``Plan.pop_gang``: a partial gang never survives this module.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

from ..structs import Allocation, Node, Resources, TaskGroup, consts
from ..utils.ids import generate_uuid
from . import (
    gang_distinct_hosts,
    gang_key,
    gang_mode,
    gang_spec,
    spread_cap,
)

from ..models.topology import TOPOLOGY_META_KEYS


def _group_of(node: Node, level: str) -> Optional[str]:
    return node.meta.get(TOPOLOGY_META_KEYS[level]) or None


def _gang_ask(tg: TaskGroup) -> Tuple[float, float, float, float]:
    """(cpu, mem, disk, iops) of one gang member."""
    cpu = mem = iops = 0.0
    disk = float(tg.ephemeral_disk.size_mb if tg.ephemeral_disk else 0)
    for task in tg.tasks:
        r = task.resources
        cpu += r.cpu
        mem += r.memory_mb
        disk += r.disk_mb
        iops += r.iops
    return cpu, mem, disk, iops


def estimate_member_units(state, plan, node: Node, tg: TaskGroup,
                          distinct_hosts: bool = False) -> int:
    """How many gang members this node could hold from its proposed
    free capacity — the host analog of ops/gang.py's member units.
    Estimation only (ordering + sufficiency): the member placements
    themselves run the full iterator stack."""
    from ..scheduler.util import proposed_allocs_for_node
    from ..structs import allocs_fit

    proposed = proposed_allocs_for_node(state, plan, node.id)
    _fit, _dim, used = allocs_fit(node, proposed)
    r = node.resources
    free = (r.cpu - used.cpu, r.memory_mb - used.memory_mb,
            r.disk_mb - used.disk_mb, r.iops - used.iops)
    ask = _gang_ask(tg)
    units = None
    for have, want in zip(free, ask):
        if want <= 0:
            continue
        dim_units = int(math.floor(have / want))
        units = dim_units if units is None else min(units, dim_units)
    if units is None:
        units = len(proposed) + 1  # zero-ask gang: capacity-unbounded
    units = max(units, 0)
    if distinct_hosts:
        units = min(units, 1)
    return units


def place_gang_host(sched, tg: TaskGroup,
                    missing: List) -> bool:
    """Stage ALL of one gang's placements on sched.plan through the
    host iterator stack, or stage nothing. `sched` is a
    GenericScheduler mid-_compute_placements (ctx/stack/plan/job set);
    `missing` the gang's AllocTuples (the whole-gang promotion in
    scheduler/generic.py guarantees it is the complete member set).
    Returns True when the gang staged."""
    from ..ops.gang import (
        GANG_MODE_AFFINITY,
        GANG_MODE_SLICE,
        GANG_MODE_SPREAD,
    )

    spec = gang_spec(tg)
    mode, level = gang_mode(spec)
    k = len(missing)
    key = gang_key(sched.job.id, tg.name)
    dh = gang_distinct_hosts(sched.job, tg)

    nodes = [n for n in sched.state.nodes()
             if n.ready() and n.datacenter in sched.job.datacenters]

    if mode == GANG_MODE_SLICE:
        groups: Dict[str, List[Node]] = {}
        for node in nodes:
            g = _group_of(node, level)
            if g is not None:
                groups.setdefault(g, []).append(node)
        # Tightest sufficient slice first (device policy), group name
        # as the deterministic tie-break.
        sufficient = []
        for name, members in groups.items():
            units = sum(
                estimate_member_units(sched.state, sched.plan, n, tg, dh)
                for n in members)
            if units >= k:
                sufficient.append((units, name, members))
        sufficient.sort(key=lambda ent: (ent[0], ent[1]))
        for _units, _name, members in sufficient:
            if _stage_members(sched, tg, missing, key,
                             lambda placed, m=members: list(m)):
                return True
        return False

    if mode == GANG_MODE_SPREAD:
        groups = {}
        for node in nodes:
            g = _group_of(node, level) or f"__node__{node.id}"
            groups.setdefault(g, []).append(node)
        eligible = sum(
            1 for members in groups.values()
            if any(estimate_member_units(sched.state, sched.plan, n,
                                         tg, dh) >= 1 for n in members))
        cap = spread_cap(k, eligible)
        counts: Dict[str, int] = {}

        def allowed(placed):
            out = []
            for g, members in groups.items():
                if counts.get(g, 0) < cap:
                    out.extend(members)
            return out

        def note(node):
            g = _group_of(node, level) or f"__node__{node.id}"
            counts[g] = counts.get(g, 0) + 1

        return _stage_members(sched, tg, missing, key, allowed,
                              on_place=note)

    if mode == GANG_MODE_AFFINITY:
        used_groups: set = set()

        def allowed(placed):
            if not used_groups:
                return list(nodes)
            # Prefer co-located: nodes in groups already holding
            # members first; _stage_members falls back to the full
            # set when the preferred subset cannot place.
            pref = [n for n in nodes
                    if (_group_of(n, level) or f"__node__{n.id}")
                    in used_groups]
            return pref or list(nodes)

        def note(node):
            used_groups.add(_group_of(node, level) or f"__node__{node.id}")

        return _stage_members(sched, tg, missing, key, allowed,
                              on_place=note, fallback_nodes=nodes)

    # free mode: atomicity only.
    return _stage_members(sched, tg, missing, key,
                          lambda placed: list(nodes))


def _stage_members(sched, tg: TaskGroup, missing: List, key: str,
                   node_source, on_place=None,
                   fallback_nodes: Optional[List[Node]] = None) -> bool:
    """Place every member against node_source(placed_so_far) through
    the stack, staging each on the gang leg so later members see
    earlier claims; unwind the whole gang on any failure."""
    placed = 0
    for tup in missing:
        candidates = node_source(placed)
        option = None
        if candidates:
            sched.stack.set_nodes(list(candidates))
            option, _size = sched.stack.select(tg)
        if option is None and fallback_nodes:
            sched.stack.set_nodes(list(fallback_nodes))
            option, _size = sched.stack.select(tg)
        if option is None:
            sched.plan.pop_gang(key)
            return False
        alloc = Allocation(
            id=generate_uuid(),
            eval_id=sched.eval.id,
            name=tup.name,
            job_id=sched.job.id,
            task_group=tg.name,
            metrics=sched.ctx.metrics,
            node_id=option.node.id,
            task_resources=option.task_resources,
            desired_status=consts.ALLOC_DESIRED_RUN,
            client_status=consts.ALLOC_CLIENT_PENDING,
            shared_resources=Resources(
                disk_mb=tg.ephemeral_disk.size_mb
                if tg.ephemeral_disk else 0),
        )
        if tup.alloc is not None and tup.alloc.id:
            alloc.previous_allocation = tup.alloc.id
        sched.plan.append_gang_alloc(key, alloc)
        if on_place is not None:
            on_place(option.node)
        placed += 1
    return True
