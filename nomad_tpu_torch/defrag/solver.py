"""The defrag loop's relaxed global re-placement solve: the port of the
JAX package's defrag/solver.py.

The SAME mirror-descent program as the convex placement kernel
(kernels/convex.py), run over the WHOLE cluster instead of one eval's
asks: every movable allocation becomes a row of the relaxed assignment
x [K, N], solved against the residual (movable-set-removed) load of the
node matrix, or x [K, C] over node classes past
CLASS_COMPRESS_MIN_NODES. The solve is K9 (kernels/convex.py
``defrag_solve``: csrc/convex_relax.cu in its defrag mode on the card,
its plain PyTorch version on the CPU). The **warm start** carries the
previous round's final logits per alloc id, keyed on the node-set
signature and the problem shape, so a steady-state round pays
WARM_ITERS steps instead of COLD_ITERS.

Rounding and move extraction stay host numpy, as in the JAX package:
the rounded solution is diffed against current placements, candidate
moves are re-simulated against a copy of the utilization matrix, and
only the best-gain prefix that STRICTLY reduces the fragmentation score
(kernels/quality.py quality_from_arrays) survives, up to the wave cap.
A move is only a *preference* on a defrag eval; the replacement
placement runs the scheduler's full feasibility stack.

With a ``mesh`` (parallel/mesh.py) the uncompressed solve splits x's
node columns over the mesh's node shards (K10f, parallel/shard.py
``sharded_relax``), as the JAX package's GSPMD input shardings do.

The JAX package's jit accounting (``solve_cache_size``) has no
counterpart here: PyTorch runs eagerly, so there are no compiled
programs to count.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

# Cold-start iteration count: a from-scratch solve of the global
# program (the logits start diffuse).
COLD_ITERS = 24
# Warm-start iteration count: with the previous round's logits carried
# per alloc, steady state only absorbs the churn since last round.
WARM_ITERS = 5
# A round whose carried rows cover less than this fraction of the
# movable set solves cold.
WARM_MIN_CARRY = 0.5
# Movable-set cap: past it the round keeps the allocs on the
# LEAST-filled occupied nodes (the consolidation candidates).
MAX_SOLVE_ALLOCS = 512
# K-axis shape buckets (pad-to-bucket like the ask axis).
K_BUCKETS = [16, 32, 64, 128, 256, MAX_SOLVE_ALLOCS]
# Class-compressed solve (models/classes.py): past this fleet size,
# when the signature interning compresses at least this much, the
# relaxed program runs over x[K, C] instead of x[K, N] and expands
# back to nodes at the rounding step.
CLASS_COMPRESS_MIN_NODES = 2048
CLASS_COMPRESS_MIN_RATIO = 2.0


@dataclass
class Move:
    """One accepted defrag move: alloc -> target node, with the
    fragmentation delta its acceptance measured."""

    alloc_id: str
    job_id: str
    from_node: str
    to_node: str
    gain: float


@dataclass
class DefragPlan:
    """One round's outcome: the accepted move set + solve telemetry."""

    moves: List[Move] = field(default_factory=list)
    frag_before: float = 0.0
    frag_after: float = 0.0
    gain: float = 0.0
    movable: int = 0
    candidates: int = 0
    k: int = 0
    n: int = 0
    warm: bool = False
    carried: int = 0
    solve_ms: float = 0.0
    # Class-compression telemetry (models/classes.py): whether this
    # round solved over classes, and at what N/C ratio.
    compressed: bool = False
    classes: int = 0
    compression_ratio: float = 0.0


class WarmState:
    """Per-alloc carry of the previous round's solver iterate, keyed
    on the resident base family signature + problem shape — the
    node-set identity that keys the batcher's delta chain. A key
    mismatch (node register/deregister, K bucket move) drops the
    carry: those are exactly the transitions where the old iterate
    describes a different program."""

    def __init__(self):
        self.key: Optional[Tuple] = None
        self.logits: Dict[str, np.ndarray] = {}

    def take(self, key: Tuple) -> Dict[str, np.ndarray]:
        if key != self.key:
            self.key = key
            self.logits = {}
        return self.logits

    def store(self, key: Tuple, logits: Dict[str, np.ndarray]) -> None:
        self.key = key
        self.logits = logits

    def clear(self) -> None:
        self.key = None
        self.logits = {}


# Distinct reference asks the fragmentation objective scores against
# (frequency-weighted, most-common first): a single median ask is
# blind to a mixed workload — free space that fits the small ask but
# strands the big one (or vice versa) must move the score.
MAX_REF_ASKS = 4


def reference_asks(ask_res) -> List[Tuple[np.ndarray, float]]:
    """[(ask [R], weight)] over the movable set's distinct resource
    shapes, weight = frequency share, top MAX_REF_ASKS shapes."""
    ask_res = np.asarray(ask_res, np.float64)
    if not len(ask_res):
        return []
    shapes, counts = np.unique(ask_res, axis=0, return_counts=True)
    top = np.argsort(-counts)[:MAX_REF_ASKS]
    total = float(counts[top].sum())
    return [(shapes[i], counts[i] / total) for i in top]


def frag_score(util, capacity, node_ok, refs) -> float:
    """The defrag objective: frequency-weighted mean of the quality
    scoreboard's fragmentation over the workload's reference asks.
    One number both the solver's move acceptance and
    cluster_fragmentation read, so the loop can never 'improve' a
    score nobody measures."""
    from ..kernels.quality import quality_from_arrays

    if not refs:
        return 0.0
    return float(sum(
        w * quality_from_arrays(util, capacity, node_ok,
                                ask)["fragmentation"]
        for ask, w in refs))


def cluster_fragmentation(state, datacenters) -> float:
    """Measure the current cluster's defrag objective from a snapshot:
    the same resolve + movable-set + frag_score path the solver runs,
    without solving."""
    from ..models.matrix import (
        _alloc_usage,
        resolve_cluster_base,
        universe_nodes_cached,
    )

    base, _kind = resolve_cluster_base(state, datacenters)
    nodes, _by_dc, _usig = universe_nodes_cached(state, datacenters)
    row_of = {node.id: i for i, node in enumerate(nodes)}
    movable = movable_allocs(state, row_of, base.node_ok)
    if not movable:
        return 0.0
    refs = reference_asks(np.array(
        [_alloc_usage(a)[:4] for a in movable], np.float64))
    return frag_score(base.util, base.capacity,
                      np.asarray(base.node_ok, bool), refs)


# defrag_solve's boolean arguments: fresh, node_ok, active.
_BOOL_ARGS = (1, 5, 12)


def _typed(arrays):
    """The solve's host arrays as the kernels take them."""
    return [np.ascontiguousarray(a, bool if i in _BOOL_ARGS else np.float32)
            for i, a in enumerate(arrays)]


def _solve(iters, *arrays):
    """K9 on the port's default device over host arrays (the order of
    kernels/convex.py defrag_solve's arguments); returns (logits, x)
    as host float32 arrays."""
    import torch

    from ..device import default_device
    from ..kernels.convex import defrag_solve

    dev = default_device()
    tensors = [torch.from_numpy(a).to(dev) for a in _typed(arrays)]
    logits, x = defrag_solve(*tensors, iters)
    return logits.cpu().numpy(), x.cpu().numpy()


def _solve_sharded(mesh, iters, *arrays):
    """K10f: the solve with x's node columns split over the node shards
    of ``mesh``'s first dp row (parallel/mesh.py shard_defrag_inputs,
    parallel/shard.py sharded_relax). Returns (logits, x) as host
    float32 arrays in global node order, the columns gathered from the
    shards in order."""
    from ..parallel.mesh import Mesh, shard_defrag_inputs
    from ..parallel.shard import DefragShard, sharded_relax

    row = Mesh([mesh.row(0)])
    placed = shard_defrag_inputs(row, _typed(arrays))
    los = placed[0].lo
    shards = [DefragShard(lo, *(x.parts[0][s] for x in placed))
              for s, lo in enumerate(los)]
    out = sharded_relax(shards, iters)
    return tuple(np.concatenate([o[i].cpu().numpy() for o in out], axis=1)
                 for i in (0, 1))


def _k_bucket(k: int) -> int:
    from ..models.matrix import bucket_size

    return bucket_size(k, K_BUCKETS)


def movable_allocs(state, row_of: Dict[str, int], node_ok) -> List:
    """The allocations a defrag wave may move: live, desired-run,
    service-job allocs on healthy in-matrix nodes. System jobs are
    node-pinned, batch jobs lose completed work when restarted, and
    allocs on draining/down nodes already belong to the drain/lost
    machinery — all excluded."""
    from ..structs import consts

    out = []
    for a in state.allocs():
        if a.terminal_status():
            continue
        if a.desired_status != consts.ALLOC_DESIRED_RUN:
            continue
        if a.job is None or a.job.type != consts.JOB_TYPE_SERVICE:
            continue
        row = row_of.get(a.node_id)
        if row is None or not node_ok[row]:
            continue
        out.append(a)
    out.sort(key=lambda a: a.id)  # deterministic solve order
    return out


def compute_defrag_plan(state, datacenters, *, max_moves: int,
                        min_gain: float, warm: WarmState,
                        movable_cap: int = MAX_SOLVE_ALLOCS,
                        class_compress: Optional[bool] = None,
                        mesh=None) -> DefragPlan:
    """One defrag round against an MVCC snapshot: resolve the resident
    cluster base (the same cacheable path the schedulers ride — in
    steady state this is a cache hit, not a rebuild), solve the relaxed
    global re-placement warm-started from `warm`, and extract the
    gain-verified move set. Mutates `warm` with this round's iterate.

    ``class_compress`` forces (True) or forbids (False) the
    class-compressed solve; None auto-enables it past
    CLASS_COMPRESS_MIN_NODES when the fleet compresses at least
    CLASS_COMPRESS_MIN_RATIO. The compressed solve aggregates per-class
    capacity/residual over SCHEDULABLE members only; the aggregate
    relaxes feasibility (a class's pooled headroom can exceed any one
    member's), which is safe here because the rounding walk and the
    move simulation below both re-verify per-NODE headroom — a class
    choice that no member can absorb rounds to nothing.

    The solve (K9) runs on the port's default device: CUDA, or the CPU
    when asked for (device.set_default_device). ``mesh``
    (parallel/mesh.py) splits the uncompressed solve's node columns over
    its node shards (K10f), as the JAX package's GSPMD shardings do, when
    the node count divides over them; the compressed solve, and a node
    count that does not divide, solve on one device."""
    from ..models.matrix import (
        _alloc_usage,
        resolve_cluster_base,
        universe_nodes_cached,
    )

    t0 = time.perf_counter()
    plan = DefragPlan()
    base, _kind = resolve_cluster_base(state, datacenters)
    nodes, _by_dc, usig = universe_nodes_cached(state, datacenters)
    row_of = {node.id: i for i, node in enumerate(nodes)}
    movable = movable_allocs(state, row_of, base.node_ok)
    plan.movable = len(movable)
    plan.n = base.n
    if not movable:
        plan.solve_ms = (time.perf_counter() - t0) * 1000.0
        return plan

    if len(movable) > movable_cap:
        # Keep the consolidation candidates: allocs on the least-filled
        # occupied nodes (a full node's allocs have nowhere better to
        # be). Fill fraction is max(cpu, mem) like binpack_score.
        denom = np.maximum(base.capacity[:, :2], 1.0)
        fill = (base.util[:, :2] / denom).max(axis=1)
        movable.sort(key=lambda a: (fill[row_of[a.node_id]], a.id))
        movable = movable[:movable_cap]
        movable.sort(key=lambda a: a.id)

    k_real = len(movable)
    k = _k_bucket(k_real)
    plan.k = k

    ask_res = np.zeros((k, 4), np.float32)
    ask_bw = np.zeros(k, np.float32)
    ask_ports = np.zeros(k, np.float32)
    active = np.zeros(k, bool)
    cur_row = np.zeros(k_real, np.int64)
    for i, a in enumerate(movable):
        cpu, mem, disk, iops, mbits, ports = _alloc_usage(a)
        ask_res[i] = (cpu, mem, disk, iops)
        ask_bw[i] = mbits
        ask_ports[i] = ports
        active[i] = True
        cur_row[i] = row_of[a.node_id]

    # Residual state: the movable set's own load removed, so the solve
    # re-places it from scratch over what everything else occupies.
    base_util = base.util.copy()
    np.subtract.at(base_util, cur_row, ask_res[:k_real])
    np.maximum(base_util, 0.0, out=base_util)
    bw_used = base.bw_used.copy()
    np.subtract.at(bw_used, cur_row, ask_bw[:k_real])
    np.maximum(bw_used, 0.0, out=bw_used)
    ports_free = base.ports_free.copy()
    np.add.at(ports_free, cur_row, ask_ports[:k_real])
    node_ok = np.asarray(base.node_ok, bool)

    # ---- class compression (models/classes.py): solve over x[K, C]
    # instead of x[K, N] when the fleet is big and compresses. The
    # residual state above stays node-granular; only the solve's view
    # aggregates, and the expansion back happens before rounding.
    cidx = getattr(base, "class_index", None)
    compress = class_compress
    if compress is None:
        compress = (cidx is not None
                    and base.n_real >= CLASS_COMPRESS_MIN_NODES
                    and cidx.compression_ratio()
                    >= CLASS_COMPRESS_MIN_RATIO)
    compress = bool(compress) and cidx is not None
    if compress:
        from ..models.classes import class_any, class_sum
        from ..models.matrix import BUCKETS, bucket_size

        ids = cidx.ids[: cidx.n_real]
        c_pad = bucket_size(cidx.n_classes, BUCKETS)
        # Aggregate over SCHEDULABLE members only: a class's pooled
        # capacity is its LIVE capacity, and an all-down class zeroes
        # out (capacity 0 -> infeasible in the solve's mask).
        solve_util = class_sum(base_util, ids, c_pad, where=node_ok)
        solve_cap = class_sum(base.capacity, ids, c_pad, where=node_ok)
        solve_sched = class_sum(base.sched_capacity, ids, c_pad,
                                where=node_ok)
        solve_bw_avail = class_sum(base.bw_avail, ids, c_pad,
                                   where=node_ok)
        solve_bw_used = class_sum(bw_used, ids, c_pad, where=node_ok)
        solve_ports = class_sum(ports_free.astype(np.float32), ids,
                                c_pad, where=node_ok)
        solve_ok = class_any(node_ok, ids, c_pad)
        width = c_pad
        # A class move means a different warm-carry geometry: the
        # "class" marker keys the carry apart from node-granular
        # rounds so a mode flip drops the stale iterate.
        key = (usig, c_pad, k, "class")
        plan.compressed = True
        plan.classes = int(cidx.n_classes)
        plan.compression_ratio = round(cidx.compression_ratio(), 2)
    else:
        solve_util, solve_cap = base_util, base.capacity
        solve_sched = base.sched_capacity
        solve_bw_avail, solve_bw_used = base.bw_avail, bw_used
        solve_ports, solve_ok = ports_free, node_ok
        width = base.n
        key = (usig, base.n, k)

    # Warm-start carry, keyed on the family signature (node-set
    # identity) + shape: gather carried rows per alloc id.
    carried = warm.take(key)
    logits0 = np.zeros((k, width), np.float32)
    fresh = np.ones(k, bool)
    n_carried = 0
    for i, a in enumerate(movable):
        row = carried.get(a.id)
        if row is not None and row.shape == (width,):
            logits0[i] = row
            fresh[i] = False
            n_carried += 1
    plan.carried = n_carried
    plan.warm = n_carried >= max(1, int(k_real * WARM_MIN_CARRY))
    iters = WARM_ITERS if plan.warm else COLD_ITERS

    solve_args = (logits0, fresh, solve_util, solve_cap, solve_sched,
                  solve_ok, solve_bw_avail, solve_bw_used, solve_ports,
                  ask_res, ask_bw, ask_ports, active)
    if mesh is not None and not compress \
            and base.n % int(mesh.shape["nodes"]) == 0:
        logits, x = _solve_sharded(mesh, iters, *solve_args)
    else:
        logits, x = _solve(iters, *solve_args)
    warm.store(key, {a.id: logits[i] for i, a in enumerate(movable)})
    if compress:
        # Expand the class-granular solution back to node granularity
        # for the rounding walk: each class's mass splits evenly over
        # its members (a tie-break, not a feasibility claim — the walk
        # checks actual per-node headroom).
        from ..models.classes import expand_to_nodes

        x_nodes = np.zeros((k_real, base.n), np.float32)
        x_nodes[:, : cidx.n_real] = expand_to_nodes(
            x[:k_real], ids, cidx.counts)
        x = x_nodes

    # ---- rounding: the convex kernel's repair scan, on the host. A
    # per-row argmax is degenerate (symmetric asks get symmetric rows
    # and the pack reward piles them on one node); the convex kernel
    # rounds with a SEQUENTIAL feasibility-respecting scan biased by
    # the row preference + the aggregate node mass y — the same shape
    # here, in numpy (this path runs once per round, off the hot path).
    y = x[:k_real].sum(axis=0)
    pref = (x[:k_real] / (x[:k_real].max(axis=1, keepdims=True) + 1e-9)
            + y[None, :] / (y.max() + 1e-9))
    # Big-first rounding order (ties by id): large remainders are what
    # strands capacity, so they anchor the packing.
    size = ask_res[:k_real, :2].max(axis=1)
    order = sorted(range(k_real), key=lambda i: (-size[i], movable[i].id))
    headroom = base.capacity - base_util  # residual state, as solved
    assign = np.full(k_real, -1, np.int64)
    for i in order:
        feas = node_ok & np.all(headroom >= ask_res[i][None, :], axis=1)
        if not feas.any():
            continue
        scores = np.where(feas, pref[i], -np.inf)
        t = int(np.argmax(scores))
        assign[i] = t
        headroom[t] -= ask_res[i]

    # ---- move extraction: diff the rounded solution against current
    # placements, simulate the candidate moves CUMULATIVELY against
    # the real utilization (the rounded solution re-placed everything;
    # executing a subset must re-verify fit), and keep the best-gain
    # PREFIX — consolidation often walks through flat steps (swap one
    # remainder out before its node can absorb another), so per-move
    # strict improvement would refuse exactly the waves that matter.
    cand = [i for i in order
            if assign[i] >= 0 and assign[i] != cur_row[i]]
    plan.candidates = len(cand)

    refs = reference_asks(ask_res[:k_real])

    def frag(u):
        return frag_score(u, base.capacity, node_ok, refs)

    util_sim = base.util.copy()
    frag0 = frag(util_sim)
    plan.frag_before = frag0

    # Directly-consolidating moves first: score each candidate's SOLO
    # gain at the real state (a remainder-combining move — the only
    # single move that shifts the fragmentation score — shows it here)
    # and walk those before the plateau steps of the global re-layout,
    # so a bounded wave spends its moves where the gain is.
    def solo_gain(i):
        t = int(assign[i])
        res = ask_res[i]
        if np.any(base.capacity[t] - util_sim[t] < res):
            return None
        trial = util_sim.copy()
        trial[cur_row[i]] = np.maximum(trial[cur_row[i]] - res, 0.0)
        trial[t] += res
        return frag0 - frag(trial)

    solo = {i: solo_gain(i) for i in cand}
    rank = {i: r for r, i in enumerate(cand)}  # rounding order
    cand.sort(key=lambda i: (-(solo[i] or 0.0), rank[i]))
    trail: List[Tuple[int, int, float]] = []  # (k, target, frag after)
    for i in cand:
        if len(trail) >= max_moves:
            break
        t = int(assign[i])
        res = ask_res[i]
        if np.any(base.capacity[t] - util_sim[t] < res):
            continue  # occupied by movables that are NOT moving
        util_sim[cur_row[i]] = np.maximum(util_sim[cur_row[i]] - res, 0.0)
        util_sim[t] += res
        trail.append((i, t, frag(util_sim)))
    if trail:
        frags = [f for (_i, _t, f) in trail]
        best = int(np.argmin(frags))
        if frags[best] < frag0 - 1e-9:
            prev = frag0
            for (i, t, f) in trail[: best + 1]:
                a = movable[i]
                plan.moves.append(Move(
                    alloc_id=a.id, job_id=a.job_id, from_node=a.node_id,
                    to_node=nodes[t].id, gain=prev - f))
                prev = f
            plan.frag_after = frags[best]
        else:
            plan.frag_after = frag0
    else:
        plan.frag_after = frag0
    plan.gain = frag0 - plan.frag_after
    if plan.gain < min_gain:
        plan.moves = []
    plan.solve_ms = (time.perf_counter() - t0) * 1000.0
    return plan
