"""K7: dense all-K gang placement over the node-topology tensor — the
port of the JAX package's ops/gang.py.

A gang is a task group of count K that places atomically: all K
members or none. One program over the cluster:

- **member units**: how many members each node could hold (the min
  over dimensions of floor(free / ask), bounded by bandwidth, ports and
  feasibility; at most 1 under distinct_hosts);
- **group capacity**: the units summed per topology group
  (models/topology.py columns);
- **slice choice** (``slice`` mode): the tightest group whose capacity
  covers all K, noise breaking exact ties; ``spread`` caps every group
  at ceil(K / eligible groups); ``affinity`` adds a bonus per member
  already in the node's group;
- **member assignment**: K masked-argmax steps carrying the claimed
  capacity, the members per node and per group;
- **all-K on the device**: unless every active member was placed,
  every choice is rewritten to -1.

``gang_scan`` is the kernel wrapper: csrc/gang_scan.cu for CUDA
tensors, ``gang_scan_plain`` for CPU ones. ``gang_placement`` is the
program the scheduler calls (upload, two K0 draws, K7);
``gang_placement_plain`` runs it through the plain versions only.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as _np
import torch

from . import cuda
from .binpack import NEG_INF, R_CPU, R_MEM, _check, device_resident, \
    keys_tensor
from .prng import fold_in, threefry_uniform, threefry_uniform_plain

GANG_MODE_SLICE = "slice"
GANG_MODE_SPREAD = "spread"
GANG_MODE_AFFINITY = "affinity"
GANG_MODE_FREE = "free"
# The kernel's mode numbers.
_MODE_IDS = {GANG_MODE_FREE: 0, GANG_MODE_SLICE: 1, GANG_MODE_SPREAD: 2,
             GANG_MODE_AFFINITY: 3}

# Soft co-location bonus per gang member already in the node's
# topology group (affinity mode).
GANG_AFFINITY_BONUS = 5.0

# Member units of a node when the ask is zero on a dimension.
_BIG = 1e9


class GangConfig(NamedTuple):
    """Gang-program knobs. ``g_pad`` is the bucketed topology-group
    axis size (models/topology.py TOPO_GROUP_BUCKETS)."""

    anti_affinity_penalty: float
    mode: str = GANG_MODE_FREE
    distinct_hosts: bool = False
    g_pad: int = 16
    noise_scale: float = 2.0


class GangState(NamedTuple):
    """Dense per-node inputs of one gang dispatch, all [N] unless
    noted."""

    capacity: torch.Tensor  # [N, 4] f32
    sched_capacity: torch.Tensor  # [N, 4] f32
    util: torch.Tensor  # [N, 4] f32 (carried by the scan)
    bw_avail: torch.Tensor  # [N] f32
    bw_used: torch.Tensor  # [N] f32 (carried)
    ports_free: torch.Tensor  # [N] f32 (carried)
    feas_row: torch.Tensor  # [N] bool: the gang TG's feasibility & node_ok
    job_count: torch.Tensor  # [N] i32 this job's allocs (anti-affinity)
    dh_presence: torch.Tensor  # [N] i32 same-host conflicts under
    #                            distinct_hosts (zeros when it is off)
    topo_ids: torch.Tensor  # [N] i32 topology group id (-1 = excluded)


def make_gang_state(capacity, sched_capacity, util, bw_avail, bw_used,
                    ports_free, feas_row, job_count, dh_presence,
                    topo_ids) -> GangState:
    """HOST-side (numpy) gang state; ``gang_placement`` uploads it."""
    f32 = functools.partial(_np.asarray, dtype=_np.float32)
    return GangState(
        capacity=f32(capacity), sched_capacity=f32(sched_capacity),
        util=f32(util), bw_avail=f32(bw_avail), bw_used=f32(bw_used),
        ports_free=f32(ports_free),
        feas_row=_np.asarray(feas_row, bool),
        job_count=_np.asarray(job_count, _np.int32),
        dh_presence=_np.asarray(dh_presence, _np.int32),
        topo_ids=_np.asarray(topo_ids, _np.int32),
    )


def _check_gang_args(state: GangState, ask_res, ask_bw, ask_ports, active,
                     noise, group_noise, placed, group_members, g_pad):
    n = state.util.shape[0]
    k = active.shape[0]
    dev = state.capacity.device
    f32, i32, u8 = torch.float32, torch.int32, torch.bool
    for name, t, dtype, shape in (
            ("capacity", state.capacity, f32, (n, 4)),
            ("sched_capacity", state.sched_capacity, f32, (n, 4)),
            ("util", state.util, f32, (n, 4)),
            ("bw_avail", state.bw_avail, f32, (n,)),
            ("bw_used", state.bw_used, f32, (n,)),
            ("ports_free", state.ports_free, f32, (n,)),
            ("feas_row", state.feas_row, u8, (n,)),
            ("job_count", state.job_count, i32, (n,)),
            ("dh_presence", state.dh_presence, i32, (n,)),
            ("topo_ids", state.topo_ids, i32, (n,)),
            ("ask_res", ask_res, f32, (4,)),
            ("ask_bw", ask_bw, f32, ()),
            ("ask_ports", ask_ports, f32, ()),
            ("active", active, u8, (k,)),
            ("noise", noise, f32, (k, n)),
            ("group_noise", group_noise, f32, (g_pad,)),
            ("placed", placed, i32, (n,)),
            ("group_members", group_members, f32, (g_pad,))):
        _check(name, t, dtype, shape, dev)
    return n, k


def member_units_plain(state: GangState, ask_res, ask_bw, ask_ports,
                       config: GangConfig):
    """[N] f32: how many gang members each node can hold from its free
    capacity (the JAX package's ``_member_units``); 0 on infeasible or
    excluded nodes."""
    big = torch.tensor(_BIG, dtype=torch.float32, device=ask_res.device)
    free = state.capacity - state.util
    per_dim = torch.where(
        ask_res[None, :] > 0,
        torch.floor(free / torch.clamp(ask_res[None, :], min=1e-9)), big)
    units = per_dim.min(dim=1).values
    units = torch.minimum(units, torch.where(
        ask_bw > 0,
        torch.floor((state.bw_avail - state.bw_used)
                    / torch.clamp(ask_bw, min=1e-9)), big))
    units = torch.minimum(units, torch.where(
        ask_ports > 0,
        torch.floor(state.ports_free / torch.clamp(ask_ports, min=1e-9)),
        big))
    zero = torch.zeros_like(units)
    units = torch.clamp(units, min=0.0)
    units = torch.where(state.feas_row, units, zero)
    if config.distinct_hosts:
        units = torch.clamp(units, max=1.0)
        units = torch.where(state.dh_presence > 0, zero, units)
    if config.mode == GANG_MODE_SLICE:
        units = torch.where(state.topo_ids >= 0, units, zero)
    return units


def group_capacity_plain(units, topo_ids, g_pad: int):
    """[g_pad] f32 member capacity per topology group; ids outside
    [0, g_pad) drop. On the CPU ``index_add_`` sums in node order. Units
    are whole numbers, and past 2^24 (a zero ask) every addend is the
    same 1e9, so the sums do not depend on the order either way."""
    keep = (topo_ids >= 0) & (topo_ids < g_pad)
    out = torch.zeros(g_pad, dtype=torch.float32, device=units.device)
    return out.index_add_(0, topo_ids[keep].long(), units[keep])


def gang_pick_plain(group_cap, group_noise, k_actual, k: int,
                    config: GangConfig):
    """The slice choice and the spread cap from the group capacities
    (None in free and affinity mode): (chosen group or -1, the ``match``
    id a node's topology id must equal in slice mode, g_pad + 1 when no
    group covers the gang and None in the other modes, the spread cap
    [] f32)."""
    dev = group_noise.device
    chosen, match = -1, None
    if config.mode == GANG_MODE_SLICE:
        covers = group_cap >= k_actual
        gscore = torch.where(covers, -group_cap + group_noise,
                             torch.full_like(group_cap, NEG_INF))
        best = int(torch.argmax(gscore))
        any_group = bool(gscore[best] > NEG_INF / 2)
        chosen = best if any_group else -1
        # No covering group: g_pad + 1 matches no node.
        match = best if any_group else config.g_pad + 1
    spread_cap = torch.tensor(float(k), dtype=torch.float32, device=dev)
    if config.mode == GANG_MODE_SPREAD:
        eligible = torch.clamp((group_cap >= 1.0).to(torch.float32).sum(),
                               min=1.0)
        spread_cap = torch.ceil(k_actual / eligible)
    return chosen, match, spread_cap


def gang_scores_plain(state: GangState, ask_res, ask_bw, ask_ports,
                      config: GangConfig, placed, group_members, match,
                      spread_cap, noise_row):
    """[N] f32: one member's gang score plus its noise on every node of
    ``state`` at the carried state, NEG_INF where it does not fit (the
    scan body of the JAX package's gang_placement_program)."""
    g_pad = config.g_pad
    has_topo = state.topo_ids >= 0
    gidx = torch.clamp(torch.where(has_topo, state.topo_ids,
                                   torch.full_like(state.topo_ids, g_pad)),
                       0, g_pad - 1).long()
    new_util = state.util + ask_res[None, :]
    fits = (new_util <= state.capacity).all(dim=1)
    fits &= state.bw_used + ask_bw <= state.bw_avail
    fits &= state.ports_free >= ask_ports
    fits &= state.feas_row
    if match is not None:
        fits &= state.topo_ids == match
    if config.distinct_hosts:
        fits &= (placed == 0) & (state.dh_presence == 0)
    gcount = group_members[gidx]
    if config.mode == GANG_MODE_SPREAD:
        fits &= ~has_topo | (gcount < spread_cap)
    denom = torch.clamp(state.sched_capacity, min=1.0)
    free_frac = 1.0 - new_util / denom
    fitness = 20.0 - (torch.pow(10.0, free_frac[:, R_CPU])
                      + torch.pow(10.0, free_frac[:, R_MEM]))
    fitness = torch.clamp(fitness, 0.0, 18.0)
    zero_cap = ((state.sched_capacity[:, R_CPU] <= 0)
                | (state.sched_capacity[:, R_MEM] <= 0))
    fitness = torch.where(zero_cap, torch.zeros_like(fitness), fitness)
    score = fitness - config.anti_affinity_penalty * (
        state.job_count + placed).to(torch.float32)
    if config.mode == GANG_MODE_AFFINITY:
        score = score + GANG_AFFINITY_BONUS * torch.where(
            has_topo, gcount, torch.zeros_like(gcount))
    score = score + noise_row
    return torch.where(fits, score, torch.full_like(score, NEG_INF))


def place_member_plain(state: GangState, ask_res, ask_bw, ask_ports, row,
                       placed):
    """Add the member's ask to ``row`` of the carried state."""
    state.util[row] += ask_res
    state.bw_used[row] += ask_bw
    state.ports_free[row] += -ask_ports
    placed[row] += 1


def gang_scan_plain(state: GangState, ask_res, ask_bw, ask_ports, active,
                    noise, group_noise, config: GangConfig, placed,
                    group_members):
    """The plain PyTorch version of K7: the JAX package's
    ``gang_placement_program`` after its noise draws, a Python loop over
    the K members. ``state``'s util/bw_used/ports_free, ``placed`` [N]
    i32 and ``group_members`` [g_pad] f32 are the carry, updated in
    place (pass zeros for the last two). Returns (choices [K] i32,
    scores [K] f32, slice_group [] i32)."""
    k = active.shape[0]
    g_pad = config.g_pad
    dev = state.capacity.device
    k_actual = active.to(torch.float32).sum()
    group_cap = None
    if config.mode in (GANG_MODE_SLICE, GANG_MODE_SPREAD):
        units = member_units_plain(state, ask_res, ask_bw, ask_ports,
                                   config)
        group_cap = group_capacity_plain(units, state.topo_ids, g_pad)
    chosen_group, match, spread_cap = gang_pick_plain(
        group_cap, group_noise, k_actual, k, config)
    choices = torch.full((k,), -1, dtype=torch.int32, device=dev)
    scores = torch.zeros((k,), dtype=torch.float32, device=dev)
    for j in range(k):
        if not bool(active[j]):
            continue
        score = gang_scores_plain(state, ask_res, ask_bw, ask_ports, config,
                                  placed, group_members, match, spread_cap,
                                  noise[j])
        choice = int(torch.argmax(score))
        if not bool(score[choice] > NEG_INF / 2):
            continue
        choices[j] = choice
        scores[j] = score[choice] - noise[j, choice]
        place_member_plain(state, ask_res, ask_bw, ask_ports, choice, placed)
        gid = int(state.topo_ids[choice])
        if 0 <= gid < g_pad:
            group_members[gid] += 1.0

    # All-K on the device: a partial gang never leaves the program.
    if bool((active & (choices < 0)).any()):
        choices.fill_(-1)
        scores.zero_()
        chosen_group = -1
    return (choices, scores,
            torch.tensor(chosen_group, dtype=torch.int32, device=dev))


def gang_scan(state: GangState, ask_res, ask_bw, ask_ports, active, noise,
              group_noise, config: GangConfig, placed, group_members):
    """K7: one gang's all-K placement over N nodes.

    Replaces ``_member_units``, ``_group_capacity`` and the member scan
    of ``gang_placement_program`` (ops/gang.py:108,139,150 of the JAX
    package). Arguments and results as ``gang_scan_plain``: ask_res
    [4], ask_bw/ask_ports [] f32, active [K] bool, noise [K, N],
    group_noise [g_pad]; the carry (util, bw_used, ports_free, placed,
    group_members) is updated in place.

    On the card (csrc/gang_scan.cu, one launch) the bound is the chain
    of K dependent argmaxes, as K1's: one thread-block cluster of up to
    16 CTAs splits the node axis, each keeping its slice's rows in
    shared memory where they fit (ops/scan.py gang_plan picks the
    cluster, the form and where the group counts live); in slice and
    spread mode the CTAs add their nodes' member units into rank 0's
    group sums (exact atomics while the sums stay whole and under 2^24,
    else rank 0 sums them again in node order, so the float sums round
    as the plain version's), and rank 0 picks the slice or the spread
    cap; each member step scores a slice from a cache of each node's
    score (recomputed at the node its owner updated), exchanges one key
    a CTA through distributed shared memory, and the owner updates the
    winner's row while every CTA adds the member to its own copy of the
    group counts; the all-K rewrite closes the launch. Group counts and
    sums stay in shared memory where the layout fits and go to global
    memory past that, so any g_pad is taken.
    """
    g_pad = config.g_pad
    n, k = _check_gang_args(state, ask_res, ask_bw, ask_ports, active,
                            noise, group_noise, placed, group_members,
                            g_pad)
    dev = state.capacity.device
    if dev.type == "cpu":
        return gang_scan_plain(state, ask_res, ask_bw, ask_ports, active,
                               noise, group_noise, config, placed,
                               group_members)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    from . import scan

    mode = _MODE_IDS[config.mode]
    plan = scan.gang_plan_for(dev, n, g_pad, mode)
    out = scan.launch_gang(plan, state, ask_res, ask_bw, ask_ports, active,
                           noise, group_noise, mode, config.distinct_hosts,
                           config.anti_affinity_penalty, placed,
                           group_members)
    cuda.count_launch("gang_scan")
    return out


def _program(state: GangState, ask_res, ask_bw, ask_ports, active, key,
             config: GangConfig, plain: bool):
    n = state.util.shape[0]
    k = active.shape[0]
    dev = state.capacity.device
    draw = threefry_uniform_plain if plain else threefry_uniform
    # One draw per (member, node), one per group from fold_in(key, 1).
    noise = draw(keys_tensor(key, dev), (k, n), 0.0, config.noise_scale)[0]
    group_noise = draw(keys_tensor(fold_in(key, 1), dev), (config.g_pad,),
                       0.0, 1.0)[0]
    carried = state._replace(util=state.util.clone(),
                             bw_used=state.bw_used.clone(),
                             ports_free=state.ports_free.clone())
    placed = torch.zeros(n, dtype=torch.int32, device=dev)
    members = torch.zeros(config.g_pad, dtype=torch.float32, device=dev)
    scan = gang_scan_plain if plain else gang_scan
    return scan(carried, ask_res, ask_bw, ask_ports, active, noise,
                group_noise, config, placed, members)


def gang_placement_plain(state: GangState, ask_res, ask_bw, ask_ports,
                         active, key, config: GangConfig):
    """The gang program through the plain versions alone (K0's and
    K7's), on tensors of any device: the yardstick the kernels are held
    against. Same arguments and results as ``gang_placement``, with the
    inputs already tensors."""
    return _program(state, ask_res, ask_bw, ask_ports, active, key, config,
                    plain=True)


def gang_placement(state: GangState, ask_res, ask_bw, ask_ports, active,
                   key, config: GangConfig, device=None):
    """Place one gang of K uniform members (the JAX package's
    ``gang_placement_program_jit``). ``state`` and the ask are host
    numpy (make_gang_state; ask_res [4], ask_bw and ask_ports scalars,
    active [K] bool); they cross to ``device`` in one copy, the member
    and group noise are drawn there (K0 twice) and K7 runs. A ``state``
    from parallel/mesh.py shard_gang_inputs (``Sharded`` fields) runs
    over its node shards instead (``device`` is not read): the member
    noise a shard over the global counters, the group noise on the
    first shard's device, and K10e (parallel/shard.py
    sharded_gang_scan). Returns (choices [K] i32, scores [K] f32,
    slice_group [] i32) on ``device`` (or the first shard's): every
    choice >= 0 (a whole gang) or every one -1."""
    from ..parallel.mesh import is_sharded

    f32 = _np.float32
    ask = (_np.asarray(ask_res, f32), _np.asarray(ask_bw, f32),
           _np.asarray(ask_ports, f32))
    if is_sharded(state.capacity):
        return _sharded_program(state, ask, _np.asarray(active, bool), key,
                                config)
    up = device_resident((*state, *ask, _np.asarray(active, bool)), device)
    ns = len(state)
    return _program(GangState(*up[:ns]), *up[ns:], key, config, plain=False)


def _sharded_program(state: GangState, ask, active, key, config: GangConfig):
    """The gang program over a GangState of ``Sharded`` fields (dp row
    0 of its mesh): the ask to each shard's device, the draws, fresh
    carries, then K10e."""
    from ..parallel.shard import GangShard, _on, sharded_gang_scan

    parts = [f.parts[0] for f in state]
    los = state.capacity.lo
    devices = [p.device for p in parts[0]]
    home = devices[0]
    n_total = sum(p.shape[0] for p in parts[0])
    k = active.shape[0]
    asks = {dev: device_resident(ask, dev) for dev in dict.fromkeys(devices)}
    (active_t,) = device_resident((active,), home)
    with _on(home):
        group_noise = threefry_uniform(
            keys_tensor(fold_in(key, 1), home), (config.g_pad,), 0.0, 1.0)[0]
    shards = []
    for s, dev in enumerate(devices):
        st = GangState(*(p[s] for p in parts))
        n = st.capacity.shape[0]
        with _on(dev):
            noise = threefry_uniform(
                keys_tensor(key, dev), (k, n), 0.0, config.noise_scale,
                window=(los[s], n_total))[0]
        carried = st._replace(util=st.util.clone(),
                              bw_used=st.bw_used.clone(),
                              ports_free=st.ports_free.clone())
        shards.append(GangShard(
            los[s], carried, *asks[dev], noise,
            torch.zeros(n, dtype=torch.int32, device=dev),
            torch.zeros(config.g_pad, dtype=torch.float32, device=dev)))
    return sharded_gang_scan(shards, active_t, group_noise, config)
