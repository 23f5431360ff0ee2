"""Node-sharded placement over a device mesh: the port of the JAX
package's parallel/mesh.py.

The cluster-scheduling analog of model parallelism: the *node axis* is
the model dimension (a 10k+-node matrix split over devices) and the
*eval batch* the data dimension (independent evals). A mesh is a
``dp`` x ``nodes`` grid of torch devices.

The JAX package is single-controller: one process owns the mesh, its
batcher issues every sharded program, and GSPMD inserts the
collectives. The port keeps that shape in one process. A mesh's
devices are torch devices, and repeats are allowed: W shards of
``cuda:0`` run a W-way mesh on one card, and W shards of ``cpu`` run
the plain versions in the tests. A sharded array is W per-shard slices,
each with its global row offset (``Sharded``). Every kernel works on
its local slice; the cross-shard step combines W small partial buffers
(packed candidate keys, group partial sums) on the combining device
(the first of the row), outside the kernels: on one card the partials
already share the device; on distinct cards they cross by a device to
device ``copy_``, which PyTorch orders against both devices' current
streams with CUDA events. The reduction itself, in fixed shard order,
runs in the next kernel's prologue (parallel/shard.py).

Layouts keep the JAX package's PartitionSpec form: a tuple naming, per
leading dimension, the mesh axis it splits over (``DP_AXIS``,
``NODE_AXIS``) or None; dimensions past the tuple are whole.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as _np
import torch

from ..ops.binpack import Asks, NodeState, device_resident

DP_AXIS = "dp"  # independent evals (data parallel)
NODE_AXIS = "nodes"  # cluster node matrix (model parallel)


class Mesh:
    """A ``dp`` x ``nodes`` grid of torch devices; ``devices[r][s]``
    holds dp row r's node shard s. ``shape`` maps each axis name to its
    size, as a JAX mesh's does."""

    def __init__(self, devices: Sequence[Sequence[torch.device]]):
        rows = tuple(tuple(torch.device(d) for d in row) for row in devices)
        if not rows or not rows[0] or len({len(r) for r in rows}) != 1:
            raise ValueError("a mesh is a non-empty rectangular grid")
        types = {d.type for row in rows for d in row}
        if len(types) != 1 or types - {"cpu", "cuda"}:
            raise ValueError(f"a mesh holds CPU or CUDA devices, not both: "
                             f"{sorted(types)}")
        self.devices = rows
        self.shape: Dict[str, int] = {DP_AXIS: len(rows),
                                      NODE_AXIS: len(rows[0])}

    def row(self, r: int = 0) -> Tuple[torch.device, ...]:
        return self.devices[r]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.devices[0]]})"


def make_mesh(n_devices: Optional[int] = None, dp: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """A dp x nodes mesh. Without ``devices``, over the visible CUDA
    cards (the first ``n_devices``, default all); it raises when there
    are fewer than asked and never moves to the CPU. An explicit
    ``devices`` list is used as given, repeats allowed: ``["cuda:0"] *
    4`` is a 4-shard mesh on one card, ``["cpu"] * 8`` the tests' mesh.
    When dp is not given, the whole grid shards the node axis."""
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        want = count if n_devices is None else n_devices
        if want <= 0 or count < want:
            raise ValueError(
                f"need {want or 1} CUDA devices, have {count}; pass "
                "devices=[...] for a mesh of device slices")
        pool = [torch.device("cuda", i) for i in range(want)]
    else:
        pool = [torch.device(d) for d in devices]
        want = len(pool) if n_devices is None else n_devices
        if want <= 0 or len(pool) < want:
            raise ValueError(f"need {want} devices, given {len(pool)}")
        pool = pool[:want]
    dp = 1 if dp is None else dp
    if dp <= 0 or want % dp:
        # A real error, not an assert: a ragged grid would shard the
        # node axis unevenly.
        raise ValueError(f"{want} devices not divisible by dp={dp}")
    w = want // dp
    return Mesh([pool[r * w:(r + 1) * w] for r in range(dp)])


class Sharded(NamedTuple):
    """One array on a mesh: ``parts[r][s]`` is dp row r's block of
    node shard s, on ``mesh.devices[r][s]``; ``lo[s]`` is the global
    row of shard s's first node (all 0 when the node axis is not split:
    each part then holds the whole node axis). ``spec`` is the layout
    (see the module docstring)."""

    parts: Tuple[Tuple[torch.Tensor, ...], ...]
    lo: Tuple[int, ...]
    spec: Tuple


def is_sharded(x) -> bool:
    return isinstance(x, Sharded)


def _axis(spec: Tuple, name: str) -> Optional[int]:
    return spec.index(name) if name in spec else None


def shard_bounds(n: int, w: int) -> List[Tuple[int, int]]:
    """[lo, hi) of each of w equal node shards; n must divide (callers
    bucket the node axis to multiples of 128, models/matrix.py)."""
    if n % w:
        raise ValueError(f"{n} nodes do not split over {w} shards")
    step = n // w
    return [(s * step, (s + 1) * step) for s in range(w)]


def _block(x: _np.ndarray, spec: Tuple, r: int, dp: int, bounds, s: int):
    """Host block of ``x`` for dp row r, node shard s."""
    idx = [slice(None)] * x.ndim
    d = _axis(spec, DP_AXIS)
    if d is not None:
        step = x.shape[d] // dp
        idx[d] = slice(r * step, (r + 1) * step)
    d = _axis(spec, NODE_AXIS)
    if d is not None:
        idx[d] = slice(*bounds[s])
    return _np.array(x[tuple(idx)], order="C")  # 0-d blocks stay 0-d


def place(mesh: Mesh, arrays: Sequence, specs: Sequence[Tuple]
          ) -> Tuple[Sharded, ...]:
    """Host arrays onto ``mesh`` with their layouts: ONE copy per
    distinct device (binpack.device_resident packs that device's blocks
    into one pinned buffer), and a block that is whole along the node
    axis is uploaded once per device, not once per shard."""
    arrays = [_np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)
              for x in arrays]
    dp, w = mesh.shape[DP_AXIS], mesh.shape[NODE_AXIS]
    bounds_of = []
    for x, spec in zip(arrays, specs):
        d = _axis(spec, NODE_AXIS)
        if _axis(spec, DP_AXIS) is not None and \
                x.shape[_axis(spec, DP_AXIS)] % dp:
            raise ValueError(f"batch {x.shape} does not split over dp={dp}")
        bounds_of.append(shard_bounds(x.shape[d], w) if d is not None
                         else [(0, 0)] * w)
    # (array, dp row, shard or None) -> position in its device's upload
    wanted: Dict[torch.device, list] = {}
    slot = {}
    for i, (x, spec) in enumerate(zip(arrays, specs)):
        split = _axis(spec, NODE_AXIS) is not None
        for r in range(dp):
            for s in range(w):
                dev = mesh.devices[r][s]
                key = (i, r, s if split else None, dev)
                if key in slot:
                    continue
                items = wanted.setdefault(dev, [])
                slot[key] = len(items)
                items.append(_block(x, spec, r, dp, bounds_of[i], s))
    on_dev = {dev: device_resident(items, dev)
              for dev, items in wanted.items()}
    out = []
    for i, spec in enumerate(specs):
        split = _axis(spec, NODE_AXIS) is not None
        parts = tuple(
            tuple(on_dev[mesh.devices[r][s]][
                slot[(i, r, s if split else None, mesh.devices[r][s])]]
                for s in range(w))
            for r in range(dp))
        out.append(Sharded(parts, tuple(b[0] for b in bounds_of[i]),
                           tuple(spec)))
    return tuple(out)


def gather(x: Sharded) -> torch.Tensor:
    """The whole array of ``x`` on the CPU (tests and results)."""
    d_node = _axis(x.spec, NODE_AXIS)
    d_dp = _axis(x.spec, DP_AXIS)
    rows = []
    for row in x.parts:
        if d_node is None:
            rows.append(row[0].cpu())
        else:
            rows.append(torch.cat([p.cpu() for p in row], dim=d_node))
    if d_dp is None:
        return rows[0]
    return torch.cat(rows, dim=d_dp)


# ------------------------------------------------------------ layouts


def _node_state_specs(batched: bool) -> NodeState:
    """Layouts of each NodeState field: the leading node dim (after the
    optional batch dim) splits over NODE_AXIS."""
    b = (DP_AXIS,) if batched else ()
    vec = (*b, NODE_AXIS)  # [.., N]
    mat = (*b, NODE_AXIS, None)  # [.., N, R]
    return NodeState(
        capacity=mat, sched_capacity=mat, util=mat, bw_avail=vec,
        bw_used=vec, ports_free=vec, job_count=vec, tg_count=mat,
        feasible=mat, node_ok=vec)


def base_specs() -> Tuple:
    """Layouts of the batcher's cluster-base tuple, IN ITS ORDER:
    (capacity, sched_capacity, util, bw_avail, bw_used, ports_free,
    node_ok, class_ids)."""
    s = _node_state_specs(batched=False)
    return (s.capacity, s.sched_capacity, s.util, s.bw_avail,
            s.bw_used, s.ports_free, s.node_ok, (NODE_AXIS,))


def delta_row_specs() -> Tuple:
    """Layouts of the base-delta payload, IN apply_base_delta's argument
    order after the four target arrays: (rows, util_rows, bw_rows,
    ports_rows, ok_rows). Replicated: a delta touches a handful of rows
    whose home shard the scatter resolves on the device
    (parallel/shard.py sharded_base_delta)."""
    return ((), (None, None), (), (), ())


def overlay_specs(compact: bool) -> Tuple:
    """Layouts of a shared-base batch's per-eval overlays: the compact
    form (CompactOverlay's fields) replicates, each shard expanding its
    own rows (K3 with a row offset); the dense (job_count, tg_count,
    feasible) splits over the nodes."""
    if compact:
        return ((), (), (), (), ())
    return ((None, NODE_AXIS), (None, NODE_AXIS, None),
            (None, NODE_AXIS, None))


def _asks_specs(batched: bool) -> Asks:
    b = (DP_AXIS,) if batched else ()
    return Asks(
        resources=(*b, None, None), bw=(*b, None), ports=(*b, None),
        tg_index=(*b, None), active=(*b, None), job_distinct_hosts=b,
        tg_distinct_hosts=(*b, None))


def shard_placement_inputs(mesh: Mesh, state: NodeState, asks: Asks, keys,
                           batched: bool = False):
    """Place host (numpy) inputs on the mesh with the canonical layouts:
    NodeState fields split over the nodes (and the batch over dp), asks
    and keys split over dp (replicated over the nodes). ``keys`` are
    host uint32 keys ([2], or [B, 2] batched). The node count must
    divide the nodes axis. One copy per distinct device."""
    specs = _node_state_specs(batched)
    ask_specs = _asks_specs(batched)
    karr = _np.asarray(keys, _np.uint32).astype(_np.int64)
    placed = place(mesh, [*state, *asks, karr],
                   [*specs, *ask_specs, (DP_AXIS,) if batched else ()])
    return (NodeState(*placed[:10]), Asks(*placed[10:17]), placed[17])


def gang_state_specs():
    """Layouts of ops/gang.py's GangState, IN FIELD ORDER: every field
    is per node and splits over NODE_AXIS. The group sums and each
    member's argmax cross shards in the program (parallel/shard.py
    sharded_gang_scan, K10e)."""
    from ..ops.gang import GangState

    vec = (NODE_AXIS,)
    mat = (NODE_AXIS, None)
    return GangState(
        capacity=mat, sched_capacity=mat, util=mat, bw_avail=vec,
        bw_used=vec, ports_free=vec, feas_row=vec, job_count=vec,
        dh_presence=vec, topo_ids=vec)


def shard_gang_inputs(mesh: Mesh, state):
    """A host GangState (ops/gang.py make_gang_state) onto the mesh,
    the node axis split: a GangState of ``Sharded`` fields, which
    ops/gang.py gang_placement takes. One copy per distinct device."""
    from ..ops.gang import GangState

    return GangState(*place(mesh, list(state), list(gang_state_specs())))


def defrag_solve_specs() -> Tuple:
    """Layouts of the defrag solve's arguments, IN kernels/convex.py
    defrag_solve's order: (logits0, fresh, base_util, capacity,
    sched_capacity, node_ok, bw_avail, bw_used, ports_free, ask_res,
    ask_bw, ask_ports, active). x[K, N] (logits0 and the solve's
    iterates) splits over its node columns, the node rows over the
    nodes; the ask-axis arrays replicate."""
    vec = (NODE_AXIS,)
    mat = (NODE_AXIS, None)
    return ((None, NODE_AXIS), (), mat, mat, mat, vec, vec, vec, vec,
            (None, None), (), (), ())


def shard_defrag_inputs(mesh: Mesh, args: Sequence) -> Tuple[Sharded, ...]:
    """The defrag solve's host arguments (defrag_solve_specs order) onto
    the mesh: one copy per distinct device."""
    return place(mesh, args, defrag_solve_specs())


# ------------------------------------------------------------ programs


def _shard_batch(static, overlays, asks_of, keys_of, config, seq: bool,
                 n_total: int):
    """B evals over node shards (the sharded ``_placement_batch``): per
    shard the noise window (K0) and a fresh carry, then the kernel that
    ``config.kernel`` names in its sharded form: the native greedy
    program (K10c, or K10d for a uniform distinct_hosts batch) or the
    convex kernel (K10g: kernels/convex.py convex_shard_program).
    ``static`` is one (lo, capacity, sched_capacity, util, bw_avail,
    bw_used, ports_free, node_ok) per shard, ``overlays`` one
    (job_count, tg_count, feasible) per shard, ``asks_of``/``keys_of``
    the batch's asks and int64 keys by device. Returns (choices [B,K],
    scores [B,K] on the first shard's device, [carry per shard])."""
    from ..ops.binpack import fresh_carry
    from ..ops.prng import threefry_uniform
    from .shard import NodeShard, _on, sharded_greedy_scan, \
        sharded_uniform_topk

    if config.kernel not in ("greedy", "convex"):
        raise ValueError(f"placement kernel {config.kernel!r} has no "
                         "node-sharded program: the greedy and convex "
                         "kernels do")
    uniform = config.kernel == "greedy" and config.uniform_dh
    shards = []
    for (lo, cap, sched, util, bw_avail, bw_used, ports, ok), \
            (jc, tgc, feas) in zip(static, overlays):
        dev = cap.device
        asks = asks_of[dev]
        b, n = feas.shape[0], feas.shape[1]
        k = asks.resources.shape[1]
        shape = (n,) if uniform else (k, n)
        with _on(dev):
            noise = threefry_uniform(keys_of[dev], shape, 0.0,
                                     config.noise_scale, window=(lo, n_total))
        carry = fresh_carry(util, bw_used, ports, jc, tgc, b, seq)
        shards.append(NodeShard(lo, cap, sched, bw_avail, ok, carry,
                                feas.contiguous(), asks, noise))
    if config.kernel == "convex":
        from ..kernels.convex import convex_shard_program

        choices, scores = convex_shard_program(shards, config, seq)
    else:
        scan = sharded_uniform_topk if uniform else sharded_greedy_scan
        choices, scores = scan(shards, config.anti_affinity_penalty, seq)
    return choices, scores, [sh.carry for sh in shards]


def sharded_placement(mesh: Mesh, state: NodeState, asks: Asks, keys,
                      config, batched: bool = False):
    """The placement program on mesh-sharded inputs (the JAX package's
    sharded_placement: placement_program_jit, or batched_placement_
    program over a [B] batch). Each dp row takes its own disjoint evals
    and runs them independently over its node shards (K0 windows, then
    K10c or K10d, or K10g for the convex kernel). Host inputs as
    shard_placement_inputs takes them.
    A batched state is stacked (a base per eval), as
    batched_placement_program takes it. ``config.kernel`` is the greedy
    or the convex kernel. Returns (choices, scores) on the mesh's first
    device ([K], or [B, K] batched) and the final NodeState as
    ``Sharded`` arrays."""
    state_sh, asks_sh, keys_sh = shard_placement_inputs(
        mesh, state, asks, keys, batched)
    n_total = int(_np.shape(state.node_ok)[-1])
    dp, w = mesh.shape[DP_AXIS], mesh.shape[NODE_AXIS]
    first = mesh.devices[0][0]
    lead = (lambda t: t) if batched else (lambda t: t.unsqueeze(0))
    choices, scores = [], []
    final = {f: [[None] * w for _ in range(dp)] for f in NodeState._fields}
    for r in range(dp):
        static, overlays = [], []
        asks_of, keys_of = {}, {}
        for s in range(w):
            dev = mesh.devices[r][s]
            p = NodeState(*(f.parts[r][s] for f in state_sh))
            static.append((state_sh.capacity.lo[s], p.capacity,
                           p.sched_capacity, p.util, p.bw_avail, p.bw_used,
                           p.ports_free, p.node_ok))
            overlays.append((lead(p.job_count).contiguous(),
                             lead(p.tg_count).contiguous(),
                             lead(p.feasible).contiguous()))
            asks_of[dev] = Asks(*(lead(a.parts[r][s]).contiguous()
                                  for a in asks_sh))
            keys_of[dev] = keys_sh.parts[r][s].reshape(-1, 2)
        c, sc, carries = _shard_batch(static, overlays, asks_of, keys_of,
                                      config, False, n_total)
        choices.append(c.to(first))
        scores.append(sc.to(first))
        for s, (util, bw, ports, jc, tgc) in enumerate(carries):
            got = dict(util=util, bw_used=bw, ports_free=ports,
                       job_count=jc, tg_count=tgc)
            for f in NodeState._fields:
                t = got.get(f)
                if t is None:
                    t = state_sh._asdict()[f].parts[r][s]
                elif not batched:
                    t = t[0]
                final[f][r][s] = t
    specs = _node_state_specs(batched)
    final_state = NodeState(*(
        Sharded(tuple(tuple(row) for row in final[f]),
                state_sh.capacity.lo, getattr(specs, f))
        for f in NodeState._fields))
    choices = torch.cat(choices)
    scores = torch.cat(scores)
    if not batched:
        choices, scores = choices[0], scores[0]
    return choices, scores, final_state


def upload_base(mesh: Mesh, base) -> Tuple[Sharded, ...]:
    """A host cluster base, in base_specs order, onto dp row 0 of the
    mesh: one copy per distinct device."""
    row = Mesh([mesh.row(0)])
    return place(row, base, base_specs())


def place_payload(base: Tuple[Sharded, ...], host: Sequence, compact: bool
                  ) -> Tuple[Tuple[Sharded, ...], int]:
    """A shared-base batch's host payload onto the shards of ``base``
    (the cached Sharded base tuple): int64 keys [B, 2] and the 7 Asks
    fields replicated, then the 5 CompactOverlay fields replicated
    (``compact``) or the dense (job_count, tg_count, feasible) split
    over the nodes. Returns the placed arrays and the bytes uploaded:
    one copy a distinct device."""
    row = base[0].parts[0]
    mesh = Mesh([tuple(p.device for p in row)])
    specs = [(), *((),) * 7, *overlay_specs(compact)]
    placed = place(mesh, host, specs)
    parts = {id(p): p for x in placed for p in x.parts[0]}
    return placed, sum(p.nbytes for p in parts.values())


def sharded_dispatch(base: Tuple[Sharded, ...], placed: Sequence[Sharded],
                     compact: bool, config):
    """A shared-base batch over a node-sharded cluster base (the
    batcher's overlay and compact dispatches over a sharded base, which
    GSPMD runs in the JAX package). ``base`` is the cached Sharded base
    tuple; ``placed`` the batch's payload as ``place_payload`` put it
    on the shards. With ``config.pre_resolve`` the evals run in order
    over one shared copy of the claimed capacity. Returns (choices,
    scores) [B, K] on the first shard's device."""
    from ..ops.binpack import CompactOverlay, expand_overlay
    from .shard import _on

    row = base[0].parts[0]
    n_total = sum(p.shape[0] for p in row)
    keys_sh, asks_sh, over_sh = placed[0], placed[1:8], placed[8:]
    static, overlays, asks_of, keys_of = [], [], {}, {}
    for s, p in enumerate(row):
        dev = p.device
        lo = base[0].lo[s]
        cap, sched, util, bw_avail, bw_used, ports, ok, class_ids = (
            f.parts[0][s] for f in base)
        static.append((lo, cap, sched, util, bw_avail, bw_used, ports, ok))
        asks_of[dev] = Asks(*(a.parts[0][s] for a in asks_sh))
        keys_of[dev] = keys_sh.parts[0][s]
        parts = [o.parts[0][s] for o in over_sh]
        if compact:
            with _on(dev):
                feas, jc, tgc = expand_overlay(
                    class_ids, CompactOverlay(*parts), cap.shape[0], lo)
        else:
            jc, tgc, feas = parts
        overlays.append((jc, tgc, feas))
    choices, scores, _ = _shard_batch(static, overlays, asks_of, keys_of,
                                      config, config.pre_resolve, n_total)
    return choices, scores
