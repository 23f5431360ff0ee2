"""K6: dense priority preemption, victim choice and placement in one
masked pass over the cluster — the port of the JAX package's
ops/preempt.py.

A red-pressure cluster has no headroom for a high-priority eval. The
host builds a ``VictimState`` (models/matrix.py ``build_victims``): per
node, the V lowest-priority live allocations sorted priority-ascending,
with their footprints. For each ask the program computes, per node, the
capacity freed by evicting the first k victims (a prefix sum over the
sorted axis) and the smallest k that makes the ask fit, so a node's
victims are always a lowest-priority-first prefix. Nodes that fit
without eviction always win: while any node fits normally the eviction
branch is masked out. The scan carries the claimed capacity and the
consumed-victim mask, so later asks of the eval neither count a
victim's capacity twice nor evict it twice. It returns (choice, score,
n_victims) per ask; the host maps ``n_victims`` back to the next
unconsumed entries of the node's sorted candidate list.

``preempt_scan`` is the kernel wrapper: csrc/preempt_scan.cu for CUDA
tensors (one cluster launch, planned by ops/scan.py ``preempt_plan``),
``preempt_scan_plain`` for CPU ones. ``preempt_placement`` is
the program the scheduler calls (upload, K0 noise, K6);
``preempt_placement_plain`` runs the same program through the plain
versions only.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as _np
import torch

from . import cuda, scan
from .binpack import (
    NEG_INF,
    R_CPU,
    R_MEM,
    Asks,
    NodeState,
    _check,
    _score_plain,
    device_resident,
    keys_tensor,
)
from .prng import threefry_uniform, threefry_uniform_plain

# Per-node victim candidate ceiling. An ask that needs more evictions
# than this on one node finds no fit there.
PREEMPT_MAX_VICTIMS = 8

# Score penalty per evicted victim: the pass prefers the node that
# disrupts least (normal fits never pay it).
PREEMPT_VICTIM_PENALTY = 2.0


class VictimState(NamedTuple):
    """Per-node preemption candidates, priority-ascending along V.
    Padding slots: ok=False, prio=+inf, zero footprint."""

    res: torch.Tensor  # [N, V, 4] f32 victim resource footprints
    bw: torch.Tensor  # [N, V] f32
    ports: torch.Tensor  # [N, V] f32 dynamic-port counts held
    prio: torch.Tensor  # [N, V] f32 job priority (padding = +inf)
    ok: torch.Tensor  # [N, V] bool live candidate


def make_victim_state(res, bw, ports, prio, ok) -> VictimState:
    """HOST-side (numpy) victim state; ``preempt_placement`` uploads
    it with the rest of the inputs in one copy."""
    f32 = functools.partial(_np.asarray, dtype=_np.float32)
    return VictimState(res=f32(res), bw=f32(bw), ports=f32(ports),
                       prio=f32(prio), ok=_np.asarray(ok, bool))


def _check_preempt_args(state: NodeState, victims: VictimState, vok,
                        asks: Asks, noise):
    """Validate one eval's preemption-scan arguments; returns (N, G,
    K). The carry (util, bw_used, ports_free, job_count, tg_count) and
    ``vok`` are the ones the scan updates."""
    n, g = state.feasible.shape
    k = asks.resources.shape[0]
    v = PREEMPT_MAX_VICTIMS
    dev = state.capacity.device
    f32, i32, u8 = torch.float32, torch.int32, torch.bool
    for name, t, dtype, shape in (
            ("capacity", state.capacity, f32, (n, 4)),
            ("sched_capacity", state.sched_capacity, f32, (n, 4)),
            ("util", state.util, f32, (n, 4)),
            ("bw_avail", state.bw_avail, f32, (n,)),
            ("bw_used", state.bw_used, f32, (n,)),
            ("ports_free", state.ports_free, f32, (n,)),
            ("job_count", state.job_count, i32, (n,)),
            ("tg_count", state.tg_count, i32, (n, g)),
            ("feasible", state.feasible, u8, (n, g)),
            ("node_ok", state.node_ok, u8, (n,)),
            ("victims.res", victims.res, f32, (n, v, 4)),
            ("victims.bw", victims.bw, f32, (n, v)),
            ("victims.ports", victims.ports, f32, (n, v)),
            ("victims.prio", victims.prio, f32, (n, v)),
            ("vok", vok, u8, (n, v)),
            ("asks.resources", asks.resources, f32, (k, 4)),
            ("asks.bw", asks.bw, f32, (k,)),
            ("asks.ports", asks.ports, f32, (k,)),
            ("asks.tg_index", asks.tg_index, i32, (k,)),
            ("asks.active", asks.active, u8, (k,)),
            ("asks.job_distinct_hosts", asks.job_distinct_hosts, u8, ()),
            ("asks.tg_distinct_hosts", asks.tg_distinct_hosts, u8, (g,)),
            ("noise", noise, f32, (k, n))):
        _check(name, t, dtype, shape, dev)
    return n, g, k


def preempt_scan_plain(state: NodeState, victims: VictimState, vok,
                       asks: Asks, noise, eval_priority: float,
                       penalty: float):
    """The plain PyTorch version of K6: a Python loop over the K asks,
    each the JAX package's ``_preempt_step`` over all N nodes. The
    carried util/bw_used/ports_free/job_count/tg_count of ``state`` and
    the consumed-victim mask ``vok`` are updated in place."""
    n, _g = state.feasible.shape
    k = asks.resources.shape[0]
    dev = state.capacity.device
    util, bw_used, ports_free = state.util, state.bw_used, state.ports_free
    job_count, tg_count = state.job_count, state.tg_count
    prio = torch.tensor(eval_priority, dtype=torch.float32, device=dev)
    jdh = asks.job_distinct_hosts.reshape(1)
    choices = torch.full((k,), -1, dtype=torch.int32, device=dev)
    scores = torch.zeros((k,), dtype=torch.float32, device=dev)
    counts = torch.zeros((k,), dtype=torch.int32, device=dev)
    denom = torch.clamp(state.sched_capacity, min=1.0)
    for j in range(k):
        tg = int(asks.tg_index[j])
        ask_res, ask_bw, ask_ports = (asks.resources[j], asks.bw[j],
                                      asks.ports[j])
        feas_row = state.feasible[:, tg] & state.node_ok
        tg_cnt = tg_count[:, tg]
        tdh = asks.tg_distinct_hosts[tg].reshape(1)
        nz = noise[j]
        score = _score_plain(
            state.capacity, state.sched_capacity, state.bw_avail,
            util[None], bw_used[None], ports_free[None], job_count[None],
            tg_cnt[None], feas_row[None], ask_res[None], ask_bw[None],
            ask_ports[None], jdh, tdh, penalty, nz[None])[0]
        normal_fit = score > NEG_INF / 2
        elig_node = (feas_row & (~jdh | (job_count == 0))
                     & (~tdh | (tg_cnt == 0)))

        okf = vok.to(torch.float32)
        freed = torch.cumsum(victims.res * okf[:, :, None], dim=1)
        freed_bw = torch.cumsum(victims.bw * okf, dim=1)
        freed_ports = torch.cumsum(victims.ports * okf, dim=1)
        live = torch.cumsum(okf, dim=1)
        elig_prefix = torch.cumprod(
            (~vok | (victims.prio < prio)).to(torch.int32), dim=1).bool()

        new_util = util + ask_res[None, :]
        fits_k = ((new_util[:, None, :] - freed)
                  <= state.capacity[:, None, :]).all(dim=2)
        fits_k &= ((bw_used + ask_bw)[:, None] - freed_bw
                   <= state.bw_avail[:, None])
        fits_k &= ports_free[:, None] + freed_ports >= ask_ports
        # Slot k itself must be live and outranked.
        fits_k &= elig_prefix & vok
        # The first fitting prefix (argmax returns the first maximum).
        k_star = torch.argmax(fits_k.to(torch.int32), dim=1)
        can_preempt = fits_k.any(dim=1) & elig_node & ~normal_fit

        at = k_star[:, None]
        freed_star = torch.gather(
            freed, 1, at[:, :, None].expand(n, 1, 4))[:, 0]
        freed_bw_star = torch.gather(freed_bw, 1, at)[:, 0]
        freed_ports_star = torch.gather(freed_ports, 1, at)[:, 0]
        nv = torch.gather(live, 1, at)[:, 0]

        # Post-eviction BestFit-v3 with the per-victim penalty; no
        # zero-capacity guard here (the JAX program has none).
        free_frac = 1.0 - (new_util - freed_star) / denom
        fitness = 20.0 - (torch.pow(10.0, free_frac[:, R_CPU])
                          + torch.pow(10.0, free_frac[:, R_MEM]))
        fitness = torch.clamp(fitness, 0.0, 18.0)
        pscore = (fitness - penalty * job_count.to(torch.float32)
                  - PREEMPT_VICTIM_PENALTY * nv + nz)
        neg = torch.full_like(score, NEG_INF)
        total = torch.where(
            normal_fit, score,
            torch.where(can_preempt & ~normal_fit.any(), pscore, neg))

        choice = int(torch.argmax(total))
        valid = bool(total[choice] > NEG_INF / 2) and bool(asks.active[j])
        if not valid:
            continue
        preempted = not bool(normal_fit[choice])
        choices[j] = choice
        scores[j] = total[choice] - nz[choice]
        if preempted:
            util[choice] += ask_res - freed_star[choice]
            bw_used[choice] += ask_bw - freed_bw_star[choice]
            ports_free[choice] += freed_ports_star[choice] - ask_ports
            vok[choice, :int(k_star[choice]) + 1] = False
            counts[j] = nv[choice].to(torch.int32)
        else:
            util[choice] += ask_res
            bw_used[choice] += ask_bw
            ports_free[choice] += -ask_ports
        job_count[choice] += 1
        tg_count[choice, tg] += 1
    return choices, scores, counts


def preempt_scan(state: NodeState, victims: VictimState, vok, asks: Asks,
                 noise, eval_priority: float, penalty: float):
    """K6: one eval's K place-or-preempt decisions over N nodes.

    Replaces ``_preempt_step`` scanned by ``preempt_placement_program``
    (ops/preempt.py:85,186 of the JAX package). ``state`` holds one
    eval's tensors (no batch axis); its util, bw_used, ports_free,
    job_count and tg_count are the carry, updated in place, as is the
    consumed-victim mask ``vok`` [N, V]. ``asks`` is one eval's [K]
    asks, ``noise`` [K, N]. Returns (choices [K] i32, scores [K] f32
    without the noise, n_victims [K] i32).

    On the card (csrc/preempt_scan.cu) the bound is the chain of K
    dependent argmaxes over N nodes, as for K1. One launch of a
    thread-block cluster (``scan.preempt_plan_for``: up to 16 CTAs, the
    slices' rows and victim slots resident in shared memory where they
    fit): its threads keep two candidates, the best normal fit and the
    best preemption, so one key exchange a step decides both; each
    node's two scores before the noise are cached between alike asks
    and recomputed only for the row the last step updated.
    """
    n, g, k = _check_preempt_args(state, victims, vok, asks, noise)
    dev = state.capacity.device
    if dev.type == "cpu":
        return preempt_scan_plain(state, victims, vok, asks, noise,
                                  eval_priority, penalty)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    out = scan.launch_preempt(scan.preempt_plan_for(dev, n, g), state,
                              victims, vok, asks, noise,
                              float(_np.float32(eval_priority)), penalty)
    cuda.count_launch("preempt_scan")
    return out


def _fresh_carry(state: NodeState, victims: VictimState):
    """Private copies of the carried tensors: the scan updates them in
    place, and the caller's inputs stay as they were."""
    carried = state._replace(
        util=state.util.clone(), bw_used=state.bw_used.clone(),
        ports_free=state.ports_free.clone(),
        job_count=state.job_count.clone(), tg_count=state.tg_count.clone())
    return carried, victims.ok.clone()


def _program(state: NodeState, victims: VictimState, asks: Asks, key,
             eval_priority, config, plain: bool):
    n = state.util.shape[0]
    k = asks.resources.shape[0]
    keys = keys_tensor(key, state.capacity.device)
    draw = threefry_uniform_plain if plain else threefry_uniform
    noise = draw(keys, (k, n), 0.0, config.noise_scale)[0]
    carried, vok = _fresh_carry(state, victims)
    scan = preempt_scan_plain if plain else preempt_scan
    return scan(carried, victims, vok, asks, noise, float(eval_priority),
                config.anti_affinity_penalty)


def preempt_placement_plain(state: NodeState, victims: VictimState,
                            asks: Asks, key, eval_priority, config):
    """The preemption program through the plain versions alone (K0's
    and K6's), on tensors of any device: the yardstick the kernels are
    held against. Same arguments and results as
    ``preempt_placement``, with the inputs already tensors."""
    return _program(state, victims, asks, key, eval_priority, config,
                    plain=True)


def preempt_placement(state: NodeState, victims: VictimState, asks: Asks,
                      key, eval_priority, config, device):
    """K sequential place-or-preempt decisions for one eval (the JAX
    package's ``preempt_placement_program_jit``). ``state``,
    ``victims`` and ``asks`` are host numpy (make_node_state,
    make_victim_state, make_asks); they cross to ``device`` in one copy
    (``device_resident``), the noise is drawn there (K0) and K6 runs.
    ``eval_priority`` is the eval's priority as float32, ``config`` a
    PlacementConfig. Returns (choices [K] i32, scores [K] f32,
    n_victims [K] i32) on ``device``."""
    fields = (*state, *victims, *asks)
    up = device_resident(fields, device)
    ns, nv = len(state), len(victims)
    return _program(NodeState(*up[:ns]), VictimState(*up[ns:ns + nv]),
                    Asks(*up[ns + nv:]), key, eval_priority, config,
                    plain=False)
