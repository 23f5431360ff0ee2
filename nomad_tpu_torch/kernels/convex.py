"""Convex-relaxation bin-packing placement kernel: the port of the JAX
package's kernels/convex.py.

The greedy kernel places an eval's K asks one after another, each
blind to the asks after it. This kernel solves the joint problem
first, then rounds (see the JAX module for the derivation):

1. **Relax** (K8a, ``relaxed_assignment``; the program calls
   ``relaxed_pref``): x[k, :] is a distribution over the N nodes for
   ask k; the objective trades the BestFit affinity at the initial
   state, a quadratic penalty on expected over-capacity, and a reward
   for concentrating load.
2. **Solve** with SOLVE_ITERS steps of entropic mirror descent
   (``mirror_descent``): logits += SOLVE_STEP * g, x = softmax(logits).
3. **Round** (K8b, ``convex_round``): K1's masked argmax scan at the
   carried state, biased by the relaxation's preference ``pref`` and a
   strand penalty. The mask is K1's, so validity is K1's.

The defrag loop's global solve (defrag/solver.py) runs the same
relaxation over the movable allocs in its own prologue
(``defrag_solve``, K9, the same CUDA source in its defrag mode).

Every kernel here is a wrapper that launches a hand-written CUDA kernel
(csrc/convex_relax.cu through ops/relax.py, csrc/convex_round.cu) for
CUDA tensors and runs its plain PyTorch version beside it for CPU
tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import cuda, relax, scan
from ..ops.binpack import (
    NEG_INF,
    NUM_RESOURCES,
    R_CPU,
    R_MEM,
    Asks,
    PlacementConfig,
    _check,
    _check_scan_args,
    _in_order,
    _launch_name,
    _score_plain,
    _update_rows,
    fresh_carry,
)
from ..ops.prng import threefry_uniform

# The JAX package's constants (kernels/convex.py:70-99), verbatim.
SOLVE_ITERS = 12
SOLVE_STEP = 0.35
OVER_PENALTY = 60.0
PACK_REWARD = 6.0
ROUND_BIAS = 8.0
STRAND_BIAS = 12.0


def _softmax(v):
    """Softmax over the last axis as jax.nn.softmax computes it."""
    e = torch.exp(v - v.amax(-1, keepdim=True))
    return e / e.sum(-1, keepdim=True)


def _fitness(util, ask_res, sched):
    """BestFit-v3 fitness of each ask on each node at ``util``:
    util/sched [..., N, 4] and ask_res [..., K, 4] -> [..., K, N]."""
    denom = torch.clamp(sched, min=1.0)[..., None, :, :]
    util = util[..., None, :, :]
    res = ask_res[..., :, None, :]
    free_cpu = 1.0 - (util[..., R_CPU] + res[..., R_CPU]) / denom[..., R_CPU]
    free_mem = 1.0 - (util[..., R_MEM] + res[..., R_MEM]) / denom[..., R_MEM]
    fitness = torch.clamp(20.0 - (torch.pow(10.0, free_cpu)
                                  + torch.pow(10.0, free_mem)), 0.0, 18.0)
    sched = sched[..., None, :, :]
    zero = (sched[..., R_CPU] <= 0) | (sched[..., R_MEM] <= 0)
    return torch.where(zero, torch.zeros_like(fitness), fitness)


# ------------------------------------------------------------ mirror descent


def _md_step(logits, x, lin, res_active, bw_active, ports_active,
             base_frac, base_bw_frac, denom_nr, bw_denom, ports_denom):
    """One mirror-descent step at x = softmax(logits + mask) * active:
    the node contractions of x, the closed-form gradient back on
    [..., K, N], and logits + SOLVE_STEP * g."""
    xt = x.transpose(-1, -2)
    exp_load = base_frac + (xt @ res_active) / denom_nr
    over = torch.clamp(exp_load - 1.0, min=0.0)
    over_bw = torch.clamp(
        base_bw_frac + (xt @ bw_active[..., None])[..., 0] / bw_denom
        - 1.0, min=0.0)
    over_ports = torch.clamp(
        (xt @ ports_active[..., None])[..., 0] / ports_denom - 1.0, min=0.0)
    tot = exp_load.sum(-1) / NUM_RESOURCES
    node_term = (PACK_REWARD / NUM_RESOURCES) * tot[..., None] \
        - 2.0 * OVER_PENALTY * over
    g = (lin
         + res_active @ (node_term / denom_nr).transpose(-1, -2)
         - 2.0 * OVER_PENALTY
         * (bw_active[..., :, None] * (over_bw / bw_denom)[..., None, :]
            + ports_active[..., :, None]
            * (over_ports / ports_denom)[..., None, :]))
    return logits + SOLVE_STEP * g


def mirror_descent_plain(logits, lin, mask, res_active, bw_active,
                         ports_active, base_frac, base_bw_frac, denom_nr,
                         bw_denom, ports_denom, active, iters: int):
    """The plain PyTorch version of the loop (the JAX package's
    mirror_descent, convex.py:102), over [..., K, N] with any leading
    batch axes: ``iters`` steps of logits += SOLVE_STEP * g."""
    for _ in range(iters):
        x = _softmax(logits + mask) * active
        logits = _md_step(logits, x, lin, res_active, bw_active,
                          ports_active, base_frac, base_bw_frac, denom_nr,
                          bw_denom, ports_denom)
    return logits


def mirror_descent(logits, lin, mask, res_active, bw_active, ports_active,
                   base_frac, base_bw_frac, denom_nr, bw_denom, ports_denom,
                   active, iters: int):
    """K8a's loop alone, with the JAX package's signature (one problem:
    logits / lin / mask [K,N], res_active [K,4], bw_active /
    ports_active [K], base_frac / denom_nr [N,4], base_bw_frac /
    bw_denom / ports_denom [N], active [K,1] or [K], all f32). Returns
    the final logits; the argument is not changed.

    On the card: csrc/relax.cuh's solve in its loop-only mode (the mask
    added as given), one launch (see ``relaxed_assignment``)."""
    k, n = logits.shape
    dev = logits.device
    f32 = torch.float32
    for name, t, shape in (
            ("logits", logits, (k, n)), ("lin", lin, (k, n)),
            ("mask", mask, (k, n)), ("res_active", res_active, (k, 4)),
            ("bw_active", bw_active, (k,)),
            ("ports_active", ports_active, (k,)),
            ("base_frac", base_frac, (n, 4)),
            ("base_bw_frac", base_bw_frac, (n,)),
            ("denom_nr", denom_nr, (n, 4)), ("bw_denom", bw_denom, (n,)),
            ("ports_denom", ports_denom, (n,)),
            ("active", active.reshape(-1), (k,))):
        _check(name, t, f32, shape, dev)
    if dev.type == "cpu":
        return mirror_descent_plain(
            logits, lin, mask, res_active, bw_active, ports_active,
            base_frac, base_bw_frac, denom_nr, bw_denom, ports_denom,
            active.reshape(k, 1), iters)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    out = logits.clone()
    seg = relax.Segment(dev, n, dict(
        logits=out.data_ptr(), mask=mask.data_ptr(), lin=lin.data_ptr(),
        denom=denom_nr.data_ptr(), base_frac=base_frac.data_ptr(),
        bw_denom=bw_denom.data_ptr(), base_bw_frac=base_bw_frac.data_ptr(),
        ports_denom=ports_denom.data_ptr()), dict(
        res_active=res_active.data_ptr(), bw_active=bw_active.data_ptr(),
        ports_active=ports_active.data_ptr(), act=active.data_ptr()))
    cuda.count_launch("mirror_descent", relax.solve(
        "loop", 1, k, 0, int(iters), 0.0, False, False, [seg]))
    return out


# ------------------------------------------------------------ K8a


def convex_pref(x):
    """The rounding preference (convex.py:253-255): each ask's own row
    over its max, plus the column sums y of x over ALL K rows over
    their max, halved. x [..., K, N] -> [..., K, N]."""
    y = x.sum(-2)
    return ((x / (x.amax(-1, keepdim=True) + 1e-9)
             + y[..., None, :] / (y.amax(-1, keepdim=True)[..., None] + 1e-9))
            * 0.5).contiguous()


class Terms(NamedTuple):
    """The loop's operands (mirror_descent's arguments after the
    logits): lin and mask [..., K, N], the asks scaled by activity
    [..., K, 4] / [..., K], the per-node fractions and denominators
    [..., N, 4] / [..., N], and active [..., K, 1]."""

    lin: torch.Tensor
    mask: torch.Tensor
    res_active: torch.Tensor
    bw_active: torch.Tensor
    ports_active: torch.Tensor
    base_frac: torch.Tensor
    base_bw_frac: torch.Tensor
    denom_nr: torch.Tensor
    bw_denom: torch.Tensor
    ports_denom: torch.Tensor
    active: torch.Tensor


def placement_terms(capacity, sched_capacity, bw_avail, node_ok, carry,
                    feasible, asks: Asks, penalty) -> Terms:
    """K8a's prologue (the JAX package's _relaxed_assignment up to the
    loop): the mask and linear term at the carry's state, per (eval,
    ask, node), over any slice of the node axis."""
    util, bw_used, ports_free, job_count, tg_count = carry
    b, n, _g = feasible.shape
    k = asks.resources.shape[1]
    if capacity.dim() == 2:
        capacity, sched_capacity = capacity[None], sched_capacity[None]
        bw_avail, node_ok = bw_avail[None], node_ok[None]
    if util.dim() == 2:
        util, bw_used, ports_free = util[None], bw_used[None], ports_free[None]
    tg = asks.tg_index.long()
    cols = tg[:, None, :].expand(b, n, k)
    feas = (torch.gather(feasible, 2, cols).transpose(1, 2)
            & node_ok[:, None, :])
    headroom = capacity - util
    res = asks.resources
    for r in range(NUM_RESOURCES):
        feas = feas & (res[:, :, None, r] <= headroom[:, None, :, r])
    feas = feas & (asks.bw[:, :, None] <= (bw_avail - bw_used)[:, None, :])
    feas = feas & (asks.ports[:, :, None] <= ports_free[:, None, :])
    tg_cnt = torch.gather(tg_count, 2, cols).transpose(1, 2)
    tg_dhs = torch.gather(asks.tg_distinct_hosts, 1, tg)
    feas = feas & (~asks.job_distinct_hosts[:, None, None]
                   | (job_count[:, None, :] == 0))
    feas = feas & (~tg_dhs[:, :, None] | (tg_cnt == 0))

    affinity = _fitness(util, res, sched_capacity) \
        - penalty * job_count.to(torch.float32)[:, None, :]
    active = asks.active.to(torch.float32)[:, :, None]
    denom_nr = torch.clamp(sched_capacity, min=1.0)
    bw_denom = torch.clamp(bw_avail, min=1.0)
    return Terms(
        torch.where(feas, affinity, torch.zeros_like(affinity)),
        torch.where(feas, 0.0, NEG_INF), res * active,
        asks.bw * active[..., 0], asks.ports * active[..., 0],
        util / denom_nr, bw_used / bw_denom, denom_nr, bw_denom,
        torch.clamp(ports_free, min=1.0), active)


def relaxed_assignment_plain(capacity, sched_capacity, bw_avail, node_ok,
                             carry, feasible, asks: Asks, penalty):
    """The plain PyTorch version of K8a (the JAX package's
    _relaxed_assignment, convex.py:136, plus the preference): the mask
    and linear term at the carry's state, SOLVE_ITERS mirror-descent
    steps from lin, x = softmax(logits + mask), pref. Returns (logits,
    x, pref), each [B, K, N]."""
    t = placement_terms(capacity, sched_capacity, bw_avail, node_ok, carry,
                        feasible, asks, penalty)
    logits = mirror_descent_plain(t.lin, *t, SOLVE_ITERS)
    x = _softmax(logits + t.mask)
    return logits, x, convex_pref(x)


def relaxed_assignment(capacity, sched_capacity, bw_avail, node_ok, carry,
                       feasible, asks: Asks, penalty):
    """K8a: the convex kernel's relaxation of B evals, through the
    preference the rounding scan reads.

    Replaces ``_relaxed_assignment`` and ``mirror_descent``
    (kernels/convex.py:136,102 of the JAX package) and the preference
    of ``convex_placement_program`` (:253). Arguments as
    ``ops.binpack.greedy_scan`` without the noise: the static rows
    shared [N,...] or stacked [B,N,...]; ``carry`` (read, not changed)
    with util/bw_used/ports_free per eval [B,N,...] or one shared
    [N,...] copy. Returns (logits, x, pref), each [B,K,N] f32;
    ``relaxed_pref`` is the same launch returning pref alone.

    On the card (csrc/relax.cuh, placement mode) the bound is bytes:
    one cooperative launch a call (ops/relax.py solve), its prologue
    writing the mask and lin, then per iteration a column phase (x and
    the contractions over K in float64, then the node terms) and a row
    phase (the gradient, the logits step and the softmax statistics),
    then x and pref, the phases separated by grid barriers; every sum
    in one fixed order, no atomics on values.
    """
    return _relax(capacity, sched_capacity, bw_avail, node_ok, carry,
                  feasible, asks, penalty, True)


def relaxed_pref(capacity, sched_capacity, bw_avail, node_ok, carry,
                 feasible, asks: Asks, penalty):
    """K8a as the placement program runs it: ``relaxed_assignment``'s
    launch, returning only pref [B,K,N] f32. The logits stay the
    kernel's scratch and x is staged in pref's buffer, so the solve
    holds no [B,K,N] output the rounding scan does not read."""
    return _relax(capacity, sched_capacity, bw_avail, node_ok, carry,
                  feasible, asks, penalty, False)


def _relax(capacity, sched_capacity, bw_avail, node_ok, carry, feasible,
           asks: Asks, penalty, iterate: bool):
    util = carry[0]
    shared = util.dim() == 2
    b, n, g, k, stacked = _check_scan_args(
        capacity, sched_capacity, bw_avail, node_ok, carry, feasible, asks,
        None, (), shared)
    dev = capacity.device
    if dev.type == "cpu":
        out = relaxed_assignment_plain(capacity, sched_capacity, bw_avail,
                                       node_ok, carry, feasible, asks,
                                       penalty)
        return out if iterate else out[2]
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    util, bw_used, ports_free, job_count, tg_count = carry
    logits = torch.empty((b, k, n), dtype=torch.float32, device=dev)
    pref = torch.empty_like(logits)
    x = torch.empty_like(logits) if iterate else None
    seg = relax.Segment(dev, n, dict(
        capacity=capacity.data_ptr(), sched=sched_capacity.data_ptr(),
        bw_avail=bw_avail.data_ptr(), node_ok=node_ok.data_ptr(),
        util=util.data_ptr(), bw_used=bw_used.data_ptr(),
        ports_free=ports_free.data_ptr(), job_count=job_count.data_ptr(),
        tg_count=tg_count.data_ptr(), feasible=feasible.data_ptr(),
        logits=logits.data_ptr(), x=x.data_ptr() if iterate else 0,
        pref=pref.data_ptr()), relax_asks(asks))
    cuda.count_launch("convex_relax", relax.solve(
        "place", b, k, g, SOLVE_ITERS, float(penalty), stacked, shared,
        [seg]))
    return (logits, x, pref) if iterate else pref


def relax_asks(asks: Asks) -> dict:
    """The asks' pointers as the solve takes them (ops/relax.py
    ASK_PTRS)."""
    return dict(ask_res=asks.resources.data_ptr(), ask_bw=asks.bw.data_ptr(),
                ask_ports=asks.ports.data_ptr(),
                tg_index=asks.tg_index.data_ptr(),
                active=asks.active.data_ptr(),
                job_dh=asks.job_distinct_hosts.data_ptr(),
                tg_dh=asks.tg_distinct_hosts.data_ptr())


# ------------------------------------------------------------ K9


def defrag_terms(base_util, capacity, sched_capacity, node_ok, bw_avail,
                 bw_used, ports_free, ask_res, ask_bw, ask_ports,
                 active) -> Terms:
    """K9's prologue (the JAX package's _solve_jit.solve up to the warm
    start): the residual state's mask and linear term per (alloc,
    node), over any slice of the node axis."""
    denom_nr = torch.clamp(sched_capacity, min=1.0)
    headroom = capacity - base_util
    feas = node_ok[None, :] & (capacity[None, :, 0] > 0)
    for r in range(NUM_RESOURCES):
        feas = feas & (ask_res[:, r, None] <= headroom[None, :, r])
    feas = feas & (ask_bw[:, None] <= (bw_avail - bw_used)[None, :])
    feas = feas & (ask_ports[:, None] <= ports_free[None, :])
    fitness = _fitness(base_util, ask_res, sched_capacity)
    active_col = active.to(torch.float32)[:, None]
    bw_denom = torch.clamp(bw_avail, min=1.0)
    return Terms(
        torch.where(feas, fitness, torch.zeros_like(fitness)),
        torch.where(feas, 0.0, NEG_INF), ask_res * active_col,
        ask_bw * active_col[:, 0], ask_ports * active_col[:, 0],
        base_util / denom_nr, bw_used / bw_denom, denom_nr, bw_denom,
        torch.clamp(ports_free, min=1.0), active_col)


def defrag_solve_plain(logits0, fresh, base_util, capacity, sched_capacity,
                       node_ok, bw_avail, bw_used, ports_free, ask_res,
                       ask_bw, ask_ports, active, iters: int):
    """The plain PyTorch version of K9 (the JAX package's
    defrag/solver.py _solve_jit.solve, :213): the residual-state
    prologue, the warm start, ``iters`` mirror-descent steps, and x =
    softmax(logits + mask) * active. Returns (logits, x), [K, N]."""
    t = defrag_terms(base_util, capacity, sched_capacity, node_ok, bw_avail,
                     bw_used, ports_free, ask_res, ask_bw, ask_ports, active)
    logits = torch.where(fresh[:, None], t.lin, logits0)
    logits = mirror_descent_plain(logits, *t, iters)
    return logits, _softmax(logits + t.mask) * t.active


def defrag_solve(logits0, fresh, base_util, capacity, sched_capacity,
                 node_ok, bw_avail, bw_used, ports_free, ask_res, ask_bw,
                 ask_ports, active, iters: int):
    """K9: the defrag loop's global relaxed re-placement solve.

    Replaces ``_solve_jit``'s ``solve`` (defrag/solver.py:213 of the
    JAX package), with its signature: logits0 [K,W] f32 (the carried
    iterate), fresh / active [K] bool, the residual state over W nodes
    or node classes (base_util / capacity / sched_capacity [W,4],
    bw_avail / bw_used / ports_free [W] f32, node_ok [W] bool) and the
    movable allocs' asks (ask_res [K,4], ask_bw / ask_ports [K] f32).
    Returns (logits, x), [K, W] f32.

    On the card: csrc/relax.cuh's solve in its defrag mode (K8a's loop
    behind the residual prologue and the warm start), one launch,
    bytes-bound as K8a.
    """
    k, w = logits0.shape
    dev = logits0.device
    f32, u8 = torch.float32, torch.bool
    for name, t, dtype, shape in (
            ("logits0", logits0, f32, (k, w)), ("fresh", fresh, u8, (k,)),
            ("base_util", base_util, f32, (w, 4)),
            ("capacity", capacity, f32, (w, 4)),
            ("sched_capacity", sched_capacity, f32, (w, 4)),
            ("node_ok", node_ok, u8, (w,)), ("bw_avail", bw_avail, f32, (w,)),
            ("bw_used", bw_used, f32, (w,)),
            ("ports_free", ports_free, f32, (w,)),
            ("ask_res", ask_res, f32, (k, 4)), ("ask_bw", ask_bw, f32, (k,)),
            ("ask_ports", ask_ports, f32, (k,)),
            ("active", active, u8, (k,))):
        _check(name, t, dtype, shape, dev)
    if dev.type == "cpu":
        return defrag_solve_plain(logits0, fresh, base_util, capacity,
                                  sched_capacity, node_ok, bw_avail, bw_used,
                                  ports_free, ask_res, ask_bw, ask_ports,
                                  active, iters)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    logits = logits0.clone()
    x = torch.empty_like(logits)
    seg = relax.Segment(dev, w, dict(
        capacity=capacity.data_ptr(), sched=sched_capacity.data_ptr(),
        bw_avail=bw_avail.data_ptr(), node_ok=node_ok.data_ptr(),
        util=base_util.data_ptr(), bw_used=bw_used.data_ptr(),
        ports_free=ports_free.data_ptr(), logits=logits.data_ptr(),
        x=x.data_ptr()), dict(
        ask_res=ask_res.data_ptr(), ask_bw=ask_bw.data_ptr(),
        ask_ports=ask_ports.data_ptr(), active=active.data_ptr(),
        fresh=fresh.data_ptr()))
    cuda.count_launch("defrag_solve", relax.solve(
        "defrag", 1, k, 0, int(iters), 0.0, False, False, [seg]))
    return logits, x


# ------------------------------------------------------------ K8b


def round_bias_plain(capacity, sched_capacity, util, ask_res, pref):
    """K8b's bias of one ask per eval on each node (convex.py:257-290):
    ROUND_BIAS x pref minus STRAND_BIAS x the strand penalty, the waste
    a placement leaves on a node that then cannot fit another such ask
    (its headroom over the dimensions the ask uses, normalized by
    schedulable capacity). util [B,N,4], ask_res [B,4], pref [B,N];
    capacity / sched_capacity shared [N,4] or stacked [B,N,4]."""
    head = capacity - util - ask_res[:, None, :]
    fits_another = (head >= ask_res[:, None, :]).all(-1)
    used = (ask_res > 0).to(torch.float32)[:, None, :]
    w = torch.clamp(head, min=0.0) / torch.clamp(sched_capacity, min=1.0) \
        * used
    waste = (((w[..., 0] + w[..., 1]) + w[..., 2]) + w[..., 3]) \
        / torch.clamp(used.sum(-1), min=1.0)
    strand = torch.where(fits_another, torch.zeros_like(waste), waste)
    return ROUND_BIAS * pref - STRAND_BIAS * strand


def convex_round_plain(capacity, sched_capacity, bw_avail, node_ok, carry,
                       feasible, asks: Asks, noise, penalty, pref,
                       seq=False):
    """The plain PyTorch version of K8b: ``greedy_scan_plain``'s loop
    with the relaxation's bias added to each step's score before the
    argmax (convex.py:257-299). The carry is updated in place; with
    ``seq`` the evals run one after another over the shared carry."""
    if seq:
        return _in_order(convex_round_plain, capacity, sched_capacity,
                         bw_avail, node_ok, carry, feasible, asks, noise,
                         penalty, pref)
    util, bw_used, ports_free, job_count, tg_count = carry
    b, n, _g = feasible.shape
    k = asks.resources.shape[1]
    dev = capacity.device
    ar = torch.arange(b, device=dev)
    choices = torch.empty((b, k), dtype=torch.int32, device=dev)
    scores = torch.empty((b, k), dtype=torch.float32, device=dev)
    for j in range(k):
        tg = asks.tg_index[:, j].long()
        feas_row = feasible[ar, :, tg] & node_ok
        tg_dh = asks.tg_distinct_hosts[ar, tg]
        nz = noise[:, j]
        ask_res = asks.resources[:, j]
        score = _score_plain(
            capacity, sched_capacity, bw_avail, util, bw_used, ports_free,
            job_count, tg_count[ar, :, tg], feas_row, ask_res, asks.bw[:, j],
            asks.ports[:, j], asks.job_distinct_hosts, tg_dh, penalty, nz)
        biased = score + round_bias_plain(capacity, sched_capacity, util,
                                          ask_res, pref[:, j])
        best = torch.argmax(biased, dim=1)
        valid = (biased[ar, best] > NEG_INF / 2) & asks.active[:, j]
        choices[:, j] = torch.where(valid, best, -1).to(torch.int32)
        scores[:, j] = torch.where(valid, score[ar, best] - nz[ar, best],
                                   torch.zeros_like(nz[:, 0]))
        vb = ar[valid]
        _update_rows(carry, vb, best[valid], asks.resources[vb, j],
                     asks.bw[vb, j], asks.ports[vb, j], tg[valid])
    return choices, scores


def convex_round(capacity, sched_capacity, bw_avail, node_ok, carry,
                 feasible, asks: Asks, noise, penalty, pref, seq=False):
    """K8b: the convex kernel's rounding scan of B evals.

    Replaces the body scan of ``convex_placement_program``
    (kernels/convex.py:257 of the JAX package), under K1's batch
    layouts: arguments as ``ops.binpack.greedy_scan`` (``carry``
    updated in place, noise [B,K,N]) plus ``pref`` [B,K,N] f32, the
    relaxation's preference. Returns (choices [B,K] i32, scores [B,K]
    f32, the BestFit score without noise or bias).

    On the card (csrc/convex_round.cu, one launch) the bound is K1's
    chain of K dependent argmaxes: K1's cluster scan itself
    (csrc/greedy_scan.cu, its bias case; ops/scan.py plans it with
    ``bias``), the bias and the strand term added to each node's score
    in the plain version's order of rounded operations, the pref row
    staged beside the noise row and the strand term cached beside the
    score.
    """
    b, n, g, k, stacked = _check_scan_args(
        capacity, sched_capacity, bw_avail, node_ok, carry, feasible, asks,
        noise, (asks.resources.shape[1], feasible.shape[1]), seq)
    dev = capacity.device
    _check("pref", pref, torch.float32, (b, k, n), dev)
    if dev.type == "cpu":
        return convex_round_plain(capacity, sched_capacity, bw_avail,
                                  node_ok, carry, feasible, asks, noise,
                                  penalty, pref, seq)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    out = scan.launch_round(
        scan.plan_for(dev, b, n, g, seq, bias=True),
        (capacity, sched_capacity, bw_avail, node_ok), carry, feasible,
        asks, noise, pref, penalty, seq)
    cuda.count_launch(_launch_name("convex_round", seq, stacked))
    return out


# ------------------------------------------------------------ program


def convex_placement_program(capacity, sched_capacity, util, bw_avail,
                             bw_used, ports_free, node_ok, job_count,
                             tg_count, feasible, asks: Asks, keys,
                             config: PlacementConfig, seq: bool = False):
    """The ``convex`` kernel over B evals, in the port's batched form
    (ops/binpack.py greedy_placement_program's arguments and result):
    the noise (K0, as greedy draws it), the relaxation (K8a), then the
    rounding scan (K8b). Under ``seq`` (pre_resolve) each eval's whole
    program, relaxation included, runs on the capacity earlier evals
    claimed (the JAX package's _overlay_seq scans placement_program):
    a host loop issues K8a(b) and K8b(b) in order on one stream."""
    b, n, _g = feasible.shape
    k = asks.resources.shape[1]
    carry = fresh_carry(util, bw_used, ports_free, job_count, tg_count, b,
                        seq)
    feasible = feasible.contiguous()
    noise = threefry_uniform(keys, (k, n), 0.0, config.noise_scale)
    penalty = config.anti_affinity_penalty
    static = (capacity, sched_capacity, bw_avail, node_ok)
    if not seq:
        pref = relaxed_pref(*static, carry, feasible, asks, penalty)
        choices, scores = convex_round(*static, carry, feasible, asks, noise,
                                       penalty, pref)
        return choices, scores, carry
    shared_util, shared_bw, shared_ports, job_count, tg_count = carry
    outs = []
    for i in range(b):
        one = slice(i, i + 1)
        own = (shared_util, shared_bw, shared_ports, job_count[one],
               tg_count[one])
        eval_asks = Asks(*(x[one] for x in asks))
        pref = relaxed_pref(*static, own, feasible[one], eval_asks, penalty)
        outs.append(convex_round(*static, own, feasible[one], eval_asks,
                                 noise[one], penalty, pref, True))
    return (torch.cat([o[0] for o in outs]),
            torch.cat([o[1] for o in outs]), carry)


def convex_shard_program(shards, config: PlacementConfig, seq: bool = False):
    """The ``convex`` kernel over B evals on node shards (K10g; the
    convex kernel over a node-sharded base, which GSPMD runs in the JAX
    package): the relaxation (K10g-a, parallel/shard.py sharded_relax:
    x from the cross-shard softmax, then pref from the cross-shard
    maxima of each row of x and of y = sum_k x), then the rounding scan
    (K10g-b, sharded_convex_round). ``shards`` are parallel/shard.py
    NodeShards with the noise drawn [B,K,N] and a fresh carry, updated
    in place. Under ``seq`` (pre_resolve) each eval's relaxation and
    rounding run on the capacity the earlier evals claimed, eval by
    eval, as ``convex_placement_program`` does. Returns (choices,
    scores) [B,K] on the first shard's device."""
    from ..parallel.shard import _by_eval, sharded_convex_round, \
        sharded_relax

    penalty = config.anti_affinity_penalty

    def run(group):
        prefs = sharded_relax(group, SOLVE_ITERS, penalty)
        return sharded_convex_round(
            [sh._replace(pref=out[2]) for sh, out in zip(group, prefs)],
            penalty)

    if not seq:
        return run(shards)
    outs = [run(_by_eval(shards, e))
            for e in range(shards[0].feasible.shape[0])]
    return (torch.cat([o[0] for o in outs]),
            torch.cat([o[1] for o in outs]))
