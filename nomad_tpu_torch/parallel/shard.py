"""Programs over the node shards of a resident base: the port of the
JAX package's parallel/shard.py (its shard_map programs), plus the
node-sharded scans that GSPMD derives there from the placement program
(parallel/mesh.py).

Each kernel works on one shard's slice; the cross-shard step combines
W small partial buffers on the combining device (the first shard's),
outside the kernels (parallel/mesh.py's module docstring says how):

- ``sharded_base_delta`` (K10a): the resident-base row scatter with a
  replicated payload; each shard keeps the rows that land in its slice.
  One launch a card over that card's shards (csrc/base_delta.cu
  nt_base_delta_shards: copy and scatter fused, in gather form). Zero
  collectives.
- ``sharded_group_capacity`` (K10b): the gang program's topology-group
  scatter-add; each shard sums its members into a partial group vector
  in node order, and the W partials add up in shard order, in one
  launch a card (csrc/group_capacity.cu).
- ``sharded_greedy_scan`` (K10c), ``sharded_convex_round`` (K10g-b) and
  ``sharded_gang_scan`` (K10e): K1, K8b and K7 over node shards. On the
  shards of one card (at most a cluster's 16), one launch of K1's or
  K7's cluster kernel with each shard's rows its own segment
  (``scan_ctas``); otherwise a launch a shard a step and a winner
  launch on the combining device (csrc/sharded_scan.cu,
  csrc/sharded_gang.cu).
- ``sharded_uniform_topk`` (K10d): K2 over node shards: one launch of
  K2's cluster kernel for the shards of one card (csrc/uniform_topk.cu,
  which draws the noise in the kernel from the shards' ``Draw``), else
  a K0 window, a local top-K per shard and a merge
  (csrc/sharded_topk.cu).

Every wrapper runs its plain PyTorch version when its tensors lie on
the CPU, and launches its kernel (or raises) when they lie on CUDA
devices. There is no program cache: an eager port compiles nothing per
shape, so the JAX package's ``shard_cache_size`` has no counterpart.
"""

from __future__ import annotations

import functools
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..ops import cuda
from ..ops.cuda import on_device as _on
from ..ops.binpack import (
    NEG_INF,
    TOPK_CLUSTER,
    Asks,
    _check,
    _score_plain,
    _update_rows,
    apply_base_delta_plain,
    uniform_topk_cluster,
)
from ..ops.prng import Draw, threefry_uniform
from ..ops.scan import CLUSTER_MAX
from .mesh import NODE_AXIS, Mesh, Sharded, delta_row_specs, is_sharded, \
    place


def node_shard_count(mesh: Mesh) -> int:
    """Shards along the node axis of a parallel/mesh.py mesh."""
    return int(mesh.shape[NODE_AXIS])


def _kind(tensors) -> str:
    """'cpu' or 'cuda' for tensors all on one kind of device."""
    kinds = {t.device.type for t in tensors}
    if len(kinds) != 1 or kinds - {"cpu", "cuda"}:
        raise ValueError(f"shards on unsupported devices {sorted(kinds)}")
    return kinds.pop()


# --------------------------------------------- one launch a card

# Segments in the kernels' tables (csrc/base_delta.cu NT_DSEG_MAX,
# csrc/group_capacity.cu NT_GC_SEGS): shards of one card a launch.
SHARD_SEGS = 32


def card_segments(devices) -> List[Tuple[torch.device, List[int]]]:
    """The shards on each card, in shard order: [(device, [shard
    indices])], the cards in the order of their first shard. K10a and
    K10b launch once a card over that card's list (their segment
    tables hold at most SHARD_SEGS)."""
    cards: dict = {}
    for s, dev in enumerate(devices):
        cards.setdefault(torch.device(dev), []).append(s)
    for dev, idx in cards.items():
        if len(idx) > SHARD_SEGS:
            raise ValueError(f"{len(idx)} shards on {dev}: one launch "
                             f"takes at most {SHARD_SEGS}")
    return list(cards.items())


# ------------------------------------------------------------ K10a

# Bytes of K10a's (row, payload index) table a CTA keeps in shared
# memory (csrc/base_delta.cu NT_DSEG_SMEM_MAX); a larger table is
# searched in device memory.
DELTA_TABLE_SMEM = 227 * 1024
# Each shard's child arrays, in the kernel's pointer order: (dtype,
# columns).
_DELTA_COLS = ((torch.float32, 4), (torch.float32, 1), (torch.float32, 1),
               (torch.bool, 1))


def delta_row_table(rows):
    """K10a's row table: the payload's global rows [R] sorted ascending
    and, for each, its index in the payload (of equal rows the first
    comes first), both int32 host arrays: one sort of 64-bit (row,
    index) keys. The kernel finds a node's row in it by binary search;
    rows outside every shard are kept and match no node."""
    rows = np.asarray(rows, dtype=np.int32)
    keys = np.sort((rows.astype(np.int64) << 32)
                   | np.arange(rows.shape[0], dtype=np.int64))
    return ((keys >> 32).astype(np.int32),
            (keys & 0xFFFFFFFF).astype(np.int32))


def _upload(arrays, devices):
    """Host arrays packed once into one pinned buffer (16-byte aligned
    each) and copied once to each of ``devices`` on its current stream:
    {device: (buffer, [device pointer of each array])}. The kernels
    read the arrays by pointer; the buffers live until the launches
    that read them are queued (the caching allocator orders any reuse
    after them on the stream)."""
    arrays = [np.ascontiguousarray(x) for x in arrays]
    offsets, total = [], 0
    for x in arrays:
        offsets.append(total)
        total += -(-x.nbytes // 16) * 16
    host = torch.empty(max(total, 16), dtype=torch.uint8, pin_memory=any(
        torch.device(d).type == "cuda" for d in devices))
    flat = host.numpy()
    for x, at in zip(arrays, offsets):
        flat[at:at + x.nbytes] = x.reshape(-1).view(np.uint8)
    out = {}
    for dev in devices:
        buf = host.to(dev, non_blocking=True)
        base = buf.data_ptr()
        out[dev] = (buf, [base + at for at in offsets])
    return out


def _child_views(dev, ns):
    """The four child arrays of each of a card's shards (``ns`` rows
    each) as views of ONE float32 allocation on ``dev``: the card's util
    rows [sum(ns), 4], then its bw_used, ports_free and node_ok (bytes),
    split at the shards' rows (every util row 16-byte aligned). Returns
    [array j][shard i]."""
    total = sum(ns)
    buf = torch.empty(6 * total + -(-total // 4), dtype=torch.float32,
                      device=dev)
    return [buf.narrow(0, 0, 4 * total).view(total, 4).split_with_sizes(ns),
            buf.narrow(0, 4 * total, total).split_with_sizes(ns),
            buf.narrow(0, 5 * total, total).split_with_sizes(ns),
            buf.narrow(0, 6 * total, -(-total // 4)).view(torch.bool)
            .narrow(0, 0, total).split_with_sizes(ns)]


def _check_delta(targets, payload) -> int:
    """K10a's arguments, checked once a call: every shard's four arrays
    (util [n,4] f32, bw_used, ports_free [n] f32, node_ok [n] bool,
    contiguous, on the shard's device) and the host payload (rows [R]
    int, util_rows [R,4], bw_rows, ports_rows [R], ok_rows [R]).
    Returns R."""
    if len(payload) != 5:
        raise ValueError(f"a base delta's payload has 5 arrays, got "
                         f"{len(payload)}")
    r = int(np.shape(payload[0])[0])
    for name, x, shape in zip(
            ("rows", "util_rows", "bw_rows", "ports_rows", "ok_rows"),
            payload, ((r,), (r, 4), (r,), (r,), (r,))):
        if tuple(np.shape(x)) != shape:
            raise ValueError(f"{name}: shape {tuple(np.shape(x))}, "
                             f"expected {shape}")
    first = targets[0].parts[0]
    w, lo = len(first), targets[0].lo
    rows = [(x.shape[0], x.device) for x in first]
    for j, t in enumerate(targets):
        parts = t.parts[0]
        if len(parts) != w or t.lo != lo:
            raise ValueError("the four arrays are not split alike")
        dtype, width = _DELTA_COLS[j]
        for s, x in enumerate(parts):
            n, dev = rows[s]
            if (x.dtype != dtype or x.shape != ((n, width) if width > 1
                                                else (n,))
                    or x.device != dev or not x.is_contiguous()):
                raise ValueError(
                    f"base array {j} shard {s}: {x.dtype} {tuple(x.shape)} "
                    f"on {x.device}, expected {dtype} with {n} rows, "
                    "contiguous, on the shard's device")
    return r


def _base_delta_card(dev, idx, parents, lo, pay, r, table_smem):
    """One launch of K10a's fused kernel over the shards ``idx`` of
    card ``dev``: ``parents`` [array][shard] the four parent arrays,
    ``pay`` the device pointers of the card's (rows, order, util_rows,
    bw_rows, ports_rows, ok_rows). Returns the children [array][i] (one
    allocation)."""
    children = _child_views(dev, [parents[0][s].shape[0] for s in idx])
    dims, ptrs = [], []
    for i, s in enumerate(idx):
        dims += [lo[s], parents[0][s].shape[0]]
        ptrs += [parents[j][s].data_ptr() for j in range(4)]
        ptrs += [children[j][i].data_ptr() for j in range(4)]
    dims, ptrs = cuda.table(dims, ptrs)
    with _on(dev):
        cuda.launch("nt_base_delta_shards", len(idx), r, int(table_smem),
                    dims, ptrs, *pay, cuda.stream_ptr(dev))
    return children


def sharded_base_delta(mesh: Mesh):
    """The row scatter of ops/binpack.py apply_base_delta over a
    node-sharded resident base: the four mutable arrays arrive as
    ``Sharded`` (parallel/mesh.py base_specs; dp row 0), the payload
    (rows [R] i32 global, util_rows [R,4], bw_rows, ports_rows [R] f32,
    ok_rows [R] bool) as host arrays. Each shard's child takes the
    payload's values at the rows of its slice and the parent's
    elsewhere; rows outside every slice drop; padding rows repeat a real
    row (the batcher's ``_pad_rows``) with identical values. Returns the
    four child arrays as ``Sharded``; the parent stays as it was (it may
    still be cached and in use by a dispatch).

    On the card (K10a, csrc/base_delta.cu nt_base_delta_shards): the
    arguments checked once, the rows sorted on the host
    (``delta_row_table``), the payload packed once and copied once a
    card (``_upload``), then ONE launch a card over that card's shards,
    which writes every child in one pass (copy and scatter fused) into
    one allocation a card (``_child_views``)."""
    row = Mesh([mesh.row(0)])

    def run(util, bw_used, ports_free, node_ok, *payload):
        targets = [util, bw_used, ports_free, node_ok]
        if not all(is_sharded(t) for t in targets):
            from .mesh import base_specs

            specs = base_specs()
            targets = list(place(row, targets,
                                 [specs[2], specs[4], specs[5], specs[6]]))
        r = _check_delta(targets, payload)
        parents = [t.parts[0] for t in targets]
        lo = targets[0].lo
        w = len(parents[0])
        if _kind(parents[0]) == "cpu":
            pay = place(row, payload, delta_row_specs())
            out = [apply_base_delta_plain(
                *(p[s] for p in parents), *(x.parts[0][s] for x in pay),
                lo[s]) for s in range(w)]
            parts = list(zip(*out))
        else:
            rows, order = delta_row_table(payload[0])
            cards = card_segments(p.device for p in parents[0])
            pay = _upload((rows, order, *(np.asarray(
                x.cpu() if isinstance(x, torch.Tensor) else x)
                for x in payload[1:])), [dev for dev, _i in cards])
            parts = [[None] * w for _ in targets]
            for dev, idx in cards:
                children = _base_delta_card(dev, idx, parents, lo,
                                            pay[dev][1], r,
                                            r * 8 <= DELTA_TABLE_SMEM)
                for j in range(len(targets)):
                    for i, s in enumerate(idx):
                        parts[j][s] = children[j][i]
            cuda.count_launch("sharded_base_delta", len(cards))
        return tuple(Sharded((tuple(p),), t.lo, t.spec)
                     for p, t in zip(parts, targets))

    return run


# ------------------------------------------------------------ K10b

# csrc/group_capacity.cu: NT_GC_CHUNK nodes a staged chunk,
# NT_GC_SMEM_MAX bytes of dynamic shared memory a CTA (the kernel has no
# static shared memory).
GROUP_CHUNK = 4096
GROUP_SMEM_MAX = 227 * 1024
_GROUP_PATHS = {"combine": 0, "partials": 1}


class GroupLaunch(NamedTuple):
    """One launch of K10b's kernel: the card, its shards (indices in
    shard order), the path ("combine": the shards of one card, their
    partial rows added by the launch's last CTA; "partials": shards on
    distinct cards, each card's launch writing its shards' partial rows
    for the combining card's ``nt_group_combine``), the staged chunk's
    nodes and whether each CTA builds its partial in shared memory
    (else in its device-memory row)."""

    device: torch.device
    shards: List[int]
    path: str
    chunk: int
    smem_partial: bool


def group_capacity_plan(devices, rows, g_pad: int) -> List[GroupLaunch]:
    """K10b's launches for shards on ``devices`` with ``rows`` nodes
    each: one a card. The chunk is the smallest power of two that
    covers the card's largest shard, at most GROUP_CHUNK; a CTA's
    shared memory holds the chunk's ids and units (8 B a node) and,
    where it fits in GROUP_SMEM_MAX, the partial (4 B a group). One card
    takes the combine path, distinct cards the partials path."""
    rows = list(rows)
    cards = card_segments(devices)
    path = "partials" if len(cards) > 1 else "combine"
    out = []
    for dev, idx in cards:
        most = max(rows[s] for s in idx)
        chunk = min(GROUP_CHUNK, max(2, 1 << max(most - 1, 0).bit_length()))
        out.append(GroupLaunch(dev, idx, path, chunk,
                               chunk * 8 + 4 * g_pad <= GROUP_SMEM_MAX))
    return out


@functools.lru_cache(maxsize=64)
def _cached_plan(shape, g_pad: int) -> List[GroupLaunch]:
    """``group_capacity_plan`` of shards given as ((device, rows), ...),
    kept: the wrappers' calls repeat a few layouts."""
    return group_capacity_plan([d for d, _n in shape],
                               [n for _d, n in shape], g_pad)


def group_capacity_combine_plain(partials: torch.Tensor) -> torch.Tensor:
    """The plain version of K10b's combine: the [W, g_pad] partials
    added in shard order."""
    out = partials[0].clone()
    for s in range(1, partials.shape[0]):
        out = out + partials[s]
    return out


# The combine path's last-CTA counter a (device, stream): zeroed once,
# left zeroed by every launch.
_group_counters: dict = {}


def _group_counter(dev, stream: int) -> torch.Tensor:
    key = (dev, stream)
    c = _group_counters.get(key)
    if c is None:
        c = _group_counters[key] = torch.zeros(1, dtype=torch.int32,
                                               device=dev)
    return c


def _group_capacity_cards(u_parts, id_parts, g_pad: int,
                          plan: List[GroupLaunch]) -> torch.Tensor:
    """K10b's launches (``plan``) on the shards' units and ids: [g_pad]
    f32 on the first shard's device. The output and the W partial rows
    are one allocation there (rows addressed by pointer, no views); a
    card's launch writes its shards' rows there, or to rows of its own
    that are then copied there. Counts one launch a card, and one more
    for the distinct-card combine."""
    home = u_parts[0].device
    step = 4 * g_pad
    buf = torch.empty((len(u_parts) + 1) * g_pad, dtype=torch.float32,
                      device=home)
    out_ptr = buf.data_ptr()
    for ln in plan:
        dev, idx = ln.device, ln.shards
        local = None if dev == home else torch.empty(
            len(idx) * g_pad, dtype=torch.float32, device=dev)
        rows = [out_ptr + step * (1 + s) if local is None
                else local.data_ptr() + step * i for i, s in enumerate(idx)]
        dims, ptrs = cuda.table(
            [u_parts[s].shape[0] for s in idx],
            [x for s, r in zip(idx, rows) for x in (
                u_parts[s].data_ptr(), id_parts[s].data_ptr(), r)])
        with _on(dev):
            stream = cuda.stream_ptr(dev)
            combine = ln.path == "combine"
            cuda.launch("nt_group_capacity", len(idx), g_pad,
                        _GROUP_PATHS[ln.path], ln.chunk,
                        int(ln.smem_partial), dims, ptrs,
                        out_ptr if combine else None,
                        _group_counter(dev, stream).data_ptr()
                        if combine else None, stream)
            if local is not None:
                for i, s in enumerate(idx):
                    buf.narrow(0, (1 + s) * g_pad, g_pad).copy_(
                        local.narrow(0, i * g_pad, g_pad), non_blocking=True)
    if len(plan) > 1:
        with _on(home):
            cuda.launch("nt_group_combine", len(u_parts), g_pad,
                        out_ptr + step, out_ptr, cuda.stream_ptr(home))
    cuda.count_launch("group_capacity", len(plan) + (len(plan) > 1))
    return buf.narrow(0, 0, g_pad)


def sharded_group_capacity(mesh: Mesh, g_pad: int):
    """The gang program's topology-group scatter-add over node shards
    (the JAX package's shard_map of ``_group_capacity`` plus a psum):
    ``units`` [N] f32 and ``topo_ids`` [N] i32 (host arrays, or
    ``Sharded`` over the nodes) give each shard's partial [g_pad] (its
    nodes summed in node order; ids outside [0, g_pad) drop), and the W
    partials add up in shard order. Returns [g_pad] f32 on the first
    shard's device.

    On the card (K10b, csrc/group_capacity.cu): one launch a card over
    that card's shards (``group_capacity_plan`` picks the path), the
    partials combined in the same launch when every shard is on one
    card, else by ``nt_group_combine`` on the first shard's card. The
    kernel keeps the plain version's order, so the result is bit-equal
    to it, also past 2^24 (a zero ask gives a node 1e9 units), where
    every addition rounds. Equal to the one-device node-order sum while
    every partial is exact in float32 (whole numbers under 2^24), as
    JAX's psum is; past that the shard order and the node order each
    stay within m x 2^-24 of the exact sum of a group's m addends."""
    from ..ops.gang import group_capacity_plain

    row = Mesh([mesh.row(0)])

    def run(units, topo_ids):
        pair = [units, topo_ids]
        if not all(is_sharded(t) for t in pair):
            pair = list(place(row, pair, [(NODE_AXIS,), (NODE_AXIS,)]))
        u_parts, id_parts = pair[0].parts[0], pair[1].parts[0]
        shape = []
        for u, i in zip(u_parts, id_parts):
            n, dev = u.shape[0], u.device
            _check("units", u, torch.float32, (n,), dev)
            _check("topo_ids", i, torch.int32, (n,), dev)
            shape.append((dev, n))
        if _kind(u_parts) == "cpu":
            return group_capacity_combine_plain(torch.stack([
                group_capacity_plain(u, i, g_pad)
                for u, i in zip(u_parts, id_parts)]))
        return _group_capacity_cards(u_parts, id_parts, g_pad,
                                     _cached_plan(tuple(shape), g_pad))

    return run


def per_shard_occupancy(arrays) -> List[dict]:
    """[{shard, device, rows, bytes}] per node shard of a device base
    tuple (or one array): ``Sharded`` arrays report each shard, plain
    tensors one row. Reads layouts only."""
    if not isinstance(arrays, (tuple, list)) or is_sharded(arrays):
        arrays = (arrays,)
    per: dict = {}
    for j, arr in enumerate(arrays):
        if is_sharded(arr):
            pieces = list(enumerate(arr.parts[0]))
        elif isinstance(arr, torch.Tensor):
            pieces = [(0, arr)]
        else:
            continue
        for s, t in pieces:
            ent = per.setdefault(s, {"shard": s, "device": str(t.device),
                                     "rows": 0, "bytes": 0})
            ent["bytes"] += t.numel() * t.element_size()
            if j == 0:
                ent["rows"] += int(t.shape[0])
    return [per[s] for s in sorted(per)]


# ------------------------------------------------------------ K10c, K10d


class NodeShard(NamedTuple):
    """One node shard's arguments to a sharded scan, all on the shard's
    device: its N rows start at global row ``lo``. The static rows
    (capacity, sched_capacity, bw_avail, node_ok) are [N,...] shared by
    the batch or [B,N,...] per eval (stacked); ``carry`` = (util,
    bw_used, ports_free, job_count, tg_count) as binpack's scans take
    it, updated in place; ``feasible`` [B,N,G]; ``asks`` the batch's
    Asks ([B,K] leading); ``noise`` the shard's window of the batch's
    noise, [B,K,N] (greedy) or [B,N] (uniform); ``pref`` the shard's
    columns of the convex relaxation's preference [B,K,N], which only
    the convex rounding scan (K10g-b) reads. ``draw`` is the window's
    ``Draw`` (its keys on the shard's device, lo = its ``lo``, total =
    the node count), where the caller has it: a uniform shard may carry
    it instead of a drawn window (``noise`` None), since K10d's one-card
    route draws in its kernel; its other routes draw the window
    first."""

    lo: int
    capacity: torch.Tensor
    sched_capacity: torch.Tensor
    bw_avail: torch.Tensor
    node_ok: torch.Tensor
    carry: tuple
    feasible: torch.Tensor
    asks: Asks
    noise: Optional[torch.Tensor]
    pref: Optional[torch.Tensor] = None
    draw: Optional[Draw] = None


def _check_shards(shards: List[NodeShard], seq: bool, uniform: bool):
    """Validate a scan's shards against binpack's scan checks; returns
    (B, N_total, G, K, stacked)."""
    from ..ops.binpack import _check_draw, _check_scan_args

    b = g = k = None
    n_total = 0
    stacked = shards[0].capacity.dim() == 3
    for sh in shards:
        n = sh.feasible.shape[1]
        noise_shape = (n,) if uniform else (sh.asks.resources.shape[1], n)
        if sh.noise is None and not (uniform and sh.draw is not None):
            raise ValueError("a shard needs its noise window (or, for the "
                             "uniform top-K, its draw)")
        bb, _n, gg, kk, st = _check_scan_args(
            sh.capacity, sh.sched_capacity, sh.bw_avail, sh.node_ok,
            sh.carry, sh.feasible, sh.asks, sh.noise, noise_shape, seq)
        if b is not None and (bb, gg, kk, st) != (b, g, k, stacked):
            raise ValueError("shards disagree on B, G, K or the layout")
        b, g, k = bb, gg, kk
        if sh.lo != n_total:
            raise ValueError(f"shard rows start at {sh.lo}, expected "
                             f"{n_total}: shards cover the nodes in order")
        n_total += n
    for sh in shards:
        if sh.noise is None and (
                sh.draw.lo != sh.lo
                or _check_draw(sh.draw, b, sh.feasible.shape[1],
                               sh.feasible.device) != n_total):
            raise ValueError(f"the draw of the shard at {sh.lo} is the "
                             f"window ({sh.draw.lo}, {sh.draw.total}), not "
                             f"({sh.lo}, {n_total})")
    return b, n_total, g, k, stacked


def _drawn(shards: List[NodeShard]) -> List[NodeShard]:
    """Uniform shards with each ``draw`` drawn into its noise window (K0
    on the shard's card; its plain version on the CPU)."""
    out = []
    for sh in shards:
        if sh.noise is None:
            d = sh.draw
            sh = sh._replace(noise=threefry_uniform(
                d.keys, (sh.feasible.shape[1],), 0.0, d.scale,
                window=(d.lo, d.total)))
        out.append(sh)
    return out


def _by_eval(shards: List[NodeShard], e: int) -> List[NodeShard]:
    """Eval e of a sequential batch as a one-eval batch: [1, ...] views
    of the shared claimed capacity (its updates land in the shared
    tensors the next eval reads) and eval e's own rows of the rest."""
    one = slice(e, e + 1)
    out = []
    for sh in shards:
        util, bw, ports, jc, tgc = sh.carry
        out.append(sh._replace(
            carry=(util[None], bw[None], ports[None], jc[one], tgc[one]),
            feasible=sh.feasible[one], asks=Asks(*(x[one] for x in sh.asks)),
            noise=None if sh.noise is None else sh.noise[one],
            pref=None if sh.pref is None else sh.pref[one],
            draw=None if sh.draw is None else sh.draw._replace(
                keys=sh.draw.keys[one])))
    return out


def _in_order(fn, shards, penalty):
    b = shards[0].feasible.shape[0]
    outs = [fn(_by_eval(shards, e), penalty, False) for e in range(b)]
    return (torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs]))


def _shard_score(sh: NodeShard, j: int, penalty: float, noise):
    """[B, N] masked scores of ask j on shard ``sh`` (noise [B, N])."""
    util, bw, ports, jc, tgc = sh.carry
    b = sh.feasible.shape[0]
    ar = torch.arange(b, device=sh.feasible.device)
    tg = sh.asks.tg_index[:, j].long()
    return _score_plain(
        sh.capacity, sh.sched_capacity, sh.bw_avail, util, bw, ports, jc,
        tgc[ar, :, tg], sh.feasible[ar, :, tg] & sh.node_ok,
        sh.asks.resources[:, j], sh.asks.bw[:, j], sh.asks.ports[:, j],
        sh.asks.job_distinct_hosts, sh.asks.tg_distinct_hosts[ar, tg],
        penalty, noise)


def _steps_plain(shards: List[NodeShard], penalty: float, biased: bool):
    """The independent layout of the plain sharded scans: per step each
    shard's local argmax (torch.argmax: the first maximum, its lowest
    index) of the score, plus K8b's rounding bias when ``biased``; the
    best of the W in shard order (the first maximum again: the lowest
    global index on ties); the owning shard's one-row update. The
    reported score is the score at the winner without the noise (and
    the bias)."""
    from ..kernels.convex import round_bias_plain

    b, k = shards[0].asks.active.shape
    dev = shards[0].feasible.device
    ar = torch.arange(b, device=dev)
    choices = torch.empty((b, k), dtype=torch.int32, device=dev)
    scores = torch.empty((b, k), dtype=torch.float32, device=dev)
    for j in range(k):
        tops, bests, cleans = [], [], []
        for sh in shards:
            nz = sh.noise[:, j]
            score = _shard_score(sh, j, penalty, nz)
            value = score
            if biased:
                value = score + round_bias_plain(
                    sh.capacity, sh.sched_capacity, sh.carry[0],
                    sh.asks.resources[:, j], sh.pref[:, j])
            best = torch.argmax(value, dim=1)
            tops.append(value[ar, best])
            bests.append(best)
            cleans.append(score[ar, best] - nz[ar, best])
        tops = torch.stack(tops)
        owner = torch.argmax(tops, dim=0)
        top = tops[owner, ar]
        local = torch.stack(bests)[owner, ar]
        lo = torch.tensor([sh.lo for sh in shards], device=dev)[owner]
        valid = (top > NEG_INF / 2) & shards[0].asks.active[:, j]
        choices[:, j] = torch.where(valid, local + lo, -1).to(torch.int32)
        scores[:, j] = torch.where(valid, torch.stack(cleans)[owner, ar],
                                   torch.zeros_like(top))
        for s, sh in enumerate(shards):
            mine = valid & (owner == s)
            vb = ar[mine]
            _update_rows(sh.carry, vb, local[mine],
                         sh.asks.resources[vb, j], sh.asks.bw[vb, j],
                         sh.asks.ports[vb, j],
                         sh.asks.tg_index[vb, j].long())
    return choices, scores


def sharded_greedy_scan_plain(shards: List[NodeShard], penalty: float,
                              seq: bool = False):
    """The plain PyTorch version of K10c (``_steps_plain`` unbiased;
    under ``seq`` the evals one after another over the shared carry)."""
    if seq:
        return _in_order(sharded_greedy_scan_plain, shards, penalty)
    return _steps_plain(shards, penalty, False)


def sharded_convex_round_plain(shards: List[NodeShard], penalty: float,
                               seq: bool = False):
    """The plain PyTorch version of K10g-b: K10c's plain steps with K8b's
    rounding bias from each shard's ``pref`` (the strand penalty read
    from the shard's own carried rows)."""
    if seq:
        return _in_order(sharded_convex_round_plain, shards, penalty)
    return _steps_plain(shards, penalty, True)


def sharded_uniform_topk_plain(shards: List[NodeShard], penalty: float,
                               seq: bool = False):
    """The plain PyTorch version of K10d: each shard's top min(K, N) by
    a stable descending sort (ties: lower index first), the shards'
    lists concatenated in shard order and sorted stably again, so ties
    keep the lower global index first; the first min(K, N_total) are
    the choices, and their owning shards update their rows."""
    if seq:
        return _in_order(sharded_uniform_topk_plain, shards, penalty)
    b, k = shards[0].asks.active.shape
    dev = shards[0].feasible.device
    n_total = sum(sh.feasible.shape[1] for sh in shards)
    tops, gidx, owner, local, cleans = [], [], [], [], []
    for s, sh in enumerate(shards):
        score = _shard_score(sh, 0, penalty, sh.noise)
        kk = min(k, score.shape[1])
        top, idx = torch.sort(score, dim=1, descending=True, stable=True)
        top, idx = top[:, :kk], idx[:, :kk]
        tops.append(top)
        local.append(idx)
        gidx.append(idx + sh.lo)
        owner.append(torch.full_like(idx, s))
        cleans.append(top - torch.gather(sh.noise, 1, idx))
    top, order = torch.sort(torch.cat(tops, 1), dim=1, descending=True,
                            stable=True)
    k_eff = min(k, n_total)
    pick = lambda x: torch.gather(torch.cat(x, 1), 1, order)[:, :k_eff]  # noqa: E731
    top = top[:, :k_eff]
    gi, own, loc, clean = pick(gidx), pick(owner), pick(local), pick(cleans)
    valid = (top > NEG_INF / 2) & shards[0].asks.active[:, :k_eff]
    choices = torch.full((b, k), -1, dtype=torch.int32, device=dev)
    scores = torch.zeros((b, k), dtype=torch.float32, device=dev)
    choices[:, :k_eff] = torch.where(valid, gi, -1).to(torch.int32)
    scores[:, :k_eff] = torch.where(valid, clean, torch.zeros_like(clean))
    for s, sh in enumerate(shards):
        vb, vk = (valid & (own == s)).nonzero(as_tuple=True)
        _update_rows(sh.carry, vb, loc[vb, vk], sh.asks.resources[vb, 0],
                     sh.asks.bw[vb, 0], sh.asks.ports[vb, 0],
                     sh.asks.tg_index[vb, 0].long())
    return choices, scores


def _ptrs(sh: NodeShard):
    """The static, carried and ask pointers of one shard, in the order
    nt_shard_step and nt_shard_topk take them."""
    util, bw, ports, jc, tgc = sh.carry
    a = sh.asks
    return (sh.capacity.data_ptr(), sh.sched_capacity.data_ptr(),
            sh.bw_avail.data_ptr(), sh.node_ok.data_ptr(), util.data_ptr(),
            bw.data_ptr(), ports.data_ptr(), jc.data_ptr(), tgc.data_ptr(),
            sh.feasible.data_ptr(), a.resources.data_ptr(), a.bw.data_ptr(),
            a.ports.data_ptr(), a.tg_index.data_ptr(),
            a.job_distinct_hosts.data_ptr(), a.tg_distinct_hosts.data_ptr(),
            sh.noise.data_ptr())


class _Partials:
    """Where each shard writes its candidates and reads the winners: on
    the combining device, a shard there writes its row of the combining
    buffer and reads the winners in place; a shard on another card gets
    buffers of its own, whose candidates cross after its launch and the
    winners after the combine (device-to-device ``copy_``, ordered by
    PyTorch against both devices' current streams). A candidate is a
    packed key (int64) and a score (f32), with ``gid`` a topology group
    id (int32) too; ``local[s]`` is shard s's (key, score, win, gid)."""

    def __init__(self, devices, home, key_shape, win_shape, gid=False):
        w = len(devices)
        types = {"key": torch.int64, "score": torch.float32}
        if gid:
            types["gid"] = torch.int32
        self.home = home
        self.part = {name: torch.empty((w, *key_shape), dtype=t, device=home)
                     for name, t in types.items()}
        self.key, self.score = self.part["key"], self.part["score"]
        self.gid = self.part.get("gid")
        self.win = torch.full(win_shape, -1, dtype=torch.int32, device=home)
        self.local = []
        for s, dev in enumerate(devices):
            if dev == home:
                mine = {name: x[s] for name, x in self.part.items()}
                win = self.win
            else:
                mine = {name: torch.empty(key_shape, dtype=t, device=dev)
                        for name, t in types.items()}
                win = torch.full(win_shape, -1, dtype=torch.int32,
                                 device=dev)
            self.local.append((mine["key"], mine["score"], win,
                               mine.get("gid")))

    def gather(self, s):
        """Shard s's candidates onto the combining device."""
        key, score, _win, gid = self.local[s]
        if key.device != self.home:
            for mine, theirs in ((key, self.key), (score, self.score),
                                 (gid, self.gid)):
                if mine is not None:
                    theirs[s].copy_(mine, non_blocking=True)

    def spread(self):
        """The winners onto every other card."""
        for _key, _score, win, _gid in self.local:
            if win.device != self.home:
                win.copy_(self.win, non_blocking=True)


def scan_ctas(devices) -> int:
    """The CTAs a shard of the one-launch route of K10c, K10e and K10g-b
    for shards on ``devices`` (in shard order), or 0 for the per-shard
    route: shards that share one card, at most CLUSTER_MAX of them,
    split one thread-block cluster of K1's or K7's kernel,
    ``CLUSTER_MAX // W`` CTAs each (W = 4: 4 CTAs of 2,560 / 4 nodes
    at N = 10,240, K1's slices at B = 1); shards on distinct cards, or
    more shards than a cluster has CTAs, take the per-shard route."""
    devices = list(devices)
    if len(set(devices)) != 1 or len(devices) > CLUSTER_MAX:
        return 0
    return max(1, CLUSTER_MAX // len(devices))


def sharded_greedy_scan(shards: List[NodeShard], penalty: float,
                        seq: bool = False, force_shards: bool = False):
    """K10c: greedy scans of K asks for B evals over node shards (K1
    over the node axis split into ``shards``, in K1's independent,
    sequential ``seq`` and stacked layouts). Replaces the GSPMD form of
    ``placement_program`` over node-sharded inputs (parallel/mesh.py:212
    ``sharded_placement`` and the greedy dispatches over a sharded base
    in the JAX package). Returns (choices [B,K] i32 global node indices,
    scores [B,K] f32 without the noise) on the first shard's device;
    the shards' carries are updated in place.

    On the card the route is ``scan_ctas``' choice. Shards of one card
    (W <= 16): one launch of K1's cluster kernel (csrc/greedy_scan.cu,
    ``_scan_on_cluster``), its CTAs' slices at the shards' boundaries,
    each shard's rows and noise window its own segment; under ``seq``
    the B evals run inside that launch. Otherwise (csrc/sharded_scan.cu)
    each step is one nt_shard_step launch per shard (the last winner's
    update in its prologue, then the slice's packed best key) and one
    nt_shard_winner launch on the first shard's device (the max of the W
    keys, the owning shard's noise-free score); a last step launch per
    shard applies the last winner: K x (W + 1) + W launches an eval (B
    x that under ``seq``), which bound it. ``force_shards`` takes that
    route on one card (the tests' and the measurements' hook)."""
    dims = _check_shards(shards, seq, False)
    if _kind(sh.feasible for sh in shards) == "cpu":
        return sharded_greedy_scan_plain(shards, penalty, seq)
    cps = scan_ctas(sh.feasible.device for sh in shards)
    if cps and not force_shards:
        return _scan_on_cluster(shards, penalty, seq, dims, False, cps,
                                "sharded_greedy_scan")
    return _steps_on_card(shards, penalty, seq, dims, False,
                          "sharded_greedy_scan")


def _scan_on_cluster(shards: List[NodeShard], penalty: float, seq: bool,
                     dims, biased: bool, cps: int, name: str):
    """One launch of K1's cluster kernel over the shards of one card
    (K10c; with ``biased`` K8b's case, K10g-b), ``cps`` CTAs a shard,
    on ``scan.plan_for``'s plan over the shards' segments; counts one
    launch under ``name``. ``dims`` is _check_shards' result."""
    from ..ops import scan

    b, n_total, g, _k, stacked = dims
    dev = shards[0].feasible.device
    plan = scan.plan_for(dev, b, n_total, g, seq, ctas=cps * len(shards),
                         bias=biased, segments=[sh.feasible.shape[1]
                                                for sh in shards])
    segs = [(sh.lo, sh.feasible.shape[1],
             (sh.capacity, sh.sched_capacity, sh.bw_avail, sh.node_ok,
              *sh.carry, sh.feasible, sh.noise,
              sh.pref if biased else None)) for sh in shards]
    out = scan.launch_segments(plan, segs, shards[0].asks, penalty, seq,
                               stacked)
    cuda.count_launch(name)
    return out


def _steps_on_card(shards: List[NodeShard], penalty: float, seq: bool,
                   dims, biased: bool, name: str):
    """The host loop of K10c and K10g-b over csrc/sharded_scan.cu: per
    step one nt_shard_step a shard (with the shard's ``pref`` when
    ``biased``) and one nt_shard_winner; the launches count under
    ``name``. ``dims`` is _check_shards' result."""
    b, _n_total, g, k, stacked = dims
    home = shards[0].feasible.device
    active = shards[0].asks.active.to(home)
    choices = torch.empty((b, k), dtype=torch.int32, device=home)
    scores = torch.empty((b, k), dtype=torch.float32, device=home)
    part = _Partials([sh.feasible.device for sh in shards], home, (b,),
                     (b,))
    w = len(shards)
    fixed = [(sh.feasible.shape[1], sh.lo,
              (*_ptrs(sh), sh.pref.data_ptr() if biased else 0),
              part.local[s][0].data_ptr(), part.local[s][1].data_ptr(),
              part.local[s][2].data_ptr(), sh.feasible.device)
             for s, sh in enumerate(shards)]
    lib = cuda.library()
    step, winner = lib.nt_shard_step, lib.nt_shard_winner
    home_stream = cuda.stream_ptr(home)
    streams = [cuda.stream_ptr(dev) for *_x, dev in fixed]
    pk_ptr, ps_ptr, win_ptr = (part.key.data_ptr(), part.score.data_ptr(),
                               part.win.data_ptr())
    act_ptr, ch_ptr, sc_ptr = (active.data_ptr(), choices.data_ptr(),
                               scores.data_ptr())
    launches = 0

    def check(err, what):
        if err != 0:
            raise RuntimeError(f"{what}: CUDA error {err}")

    # (e, k) steps in order; (pe, pk) the step before (pk = -1: none).
    if seq:
        order = [(e, j) for e in range(b) for j in range(k)]
    else:
        order = [(0, j) for j in range(k)]
    prev = (0, -1)
    for e, j in order + [(0, -1)]:
        last = j < 0
        for s, (n, lo, ptrs, key_p, score_p, win_p, dev) in enumerate(fixed):
            with _on(dev):
                check(step(b, n, g, k, lo, float(penalty), int(seq),
                           int(stacked), e, j, prev[0], prev[1], *ptrs,
                           win_p, key_p, score_p, streams[s]),
                      "nt_shard_step")
            launches += 1
            if not last and w > 1:
                part.gather(s)
        if last:
            break
        with _on(home):
            check(winner(w, b, k, j, int(seq), e, pk_ptr, ps_ptr, act_ptr,
                         ch_ptr, sc_ptr, win_ptr, home_stream),
                  "nt_shard_winner")
        launches += 1
        part.spread()
        prev = (e, j)
    cuda.count_launch(name, launches)
    return choices, scores


def sharded_convex_round(shards: List[NodeShard], penalty: float,
                         seq: bool = False, force_shards: bool = False):
    """K10g-b: the convex kernel's rounding scan of B evals over node
    shards (K8b with the node axis split). Replaces the GSPMD form of
    the body scan of ``convex_placement_program`` (kernels/convex.py:224
    in the JAX package) over a node-sharded base. Arguments and results
    as ``sharded_greedy_scan``, with each shard's ``pref`` [B,K,N] set
    (its columns of the relaxation's preference, K10g-a).

    On the card the route is K10c's. Shards of one card: one launch of
    K8b's kernel (K1's cluster kernel with the rounding bias), each
    shard's rows, noise window and pref columns its own segment.
    Otherwise (csrc/sharded_scan.cu) each shard's step packs score +
    ROUND_BIAS x pref - STRAND_BIAS x strand penalty, its strand penalty
    read from its own carried rows, and reports the score without the
    noise and the bias, as K8b does: K x (W + 1) + W launches an eval.
    ``force_shards`` as ``sharded_greedy_scan``'s."""
    dims = _check_shards(shards, seq, False)
    b, _n_total, _g, k, _stacked = dims
    for sh in shards:
        if sh.pref is None:
            raise ValueError("the convex rounding scan needs each shard's "
                             "pref")
        _check("pref", sh.pref, torch.float32,
               (b, k, sh.feasible.shape[1]), sh.feasible.device)
    if _kind(sh.feasible for sh in shards) == "cpu":
        return sharded_convex_round_plain(shards, penalty, seq)
    cps = scan_ctas(sh.feasible.device for sh in shards)
    if cps and not force_shards:
        return _scan_on_cluster(shards, penalty, seq, dims, True, cps,
                                "sharded_convex_round")
    return _steps_on_card(shards, penalty, seq, dims, True,
                          "sharded_convex_round")


def uniform_topk_ctas(devices) -> int:
    """The CTAs a shard of K10d's one-launch path for shards on
    ``devices`` (in shard order), or 0 for the per-shard path: shards
    that share one card, at most TOPK_CLUSTER of them, split one
    thread-block cluster, ``TOPK_CLUSTER // W`` CTAs each (the kernel
    launches that many a shard); shards on distinct cards, or more
    shards than a cluster has CTAs, take a launch a shard."""
    devices = list(devices)
    if len(set(devices)) != 1 or len(devices) > TOPK_CLUSTER:
        return 0
    return max(1, TOPK_CLUSTER // len(devices))


def sharded_uniform_topk(shards: List[NodeShard], penalty: float,
                         seq: bool = False):
    """K10d: the uniform distinct-hosts placement of B evals over node
    shards (K2 over the node axis split into ``shards``, in K2's
    layouts). Replaces the GSPMD form of ``_uniform_topk_program``
    (ops/binpack.py:302 in the JAX package) over a node-sharded base.
    Arguments as ``sharded_greedy_scan`` except each shard's noise [B,
    N] (one draw a node) or its ``draw``. Returns (choices, scores)
    [B,K] on the first shard's device.

    On the card the path is ``uniform_topk_ctas``' choice. Shards of
    one card (W <= 8): one launch a call of K2's cluster kernel
    (csrc/uniform_topk.cu), its CTAs' slices at the shards' boundaries,
    each shard's rows its own segment, every node's noise drawn in the
    kernel (the shards carry their ``draw``); under ``seq`` the B evals
    run inside that launch. Otherwise (csrc/sharded_topk.cu), after a
    K0 window a shard that carries a draw, one nt_shard_topk launch per
    shard (the last eval's winners update
    their rows in its prologue; the slice's top K selected) and one
    nt_shard_merge on the first shard's device (the top K of the W x K
    candidates, K2's choices); W + 1 launches an eval under ``seq``
    (all evals at once otherwise) and W more to apply the last
    winners."""
    b, n_total, g, k, stacked = _check_shards(shards, seq, True)
    if _kind(sh.feasible for sh in shards) == "cpu":
        return sharded_uniform_topk_plain(_drawn(shards), penalty, seq)
    w = len(shards)
    cps = uniform_topk_ctas(sh.feasible.device for sh in shards)
    if cps:
        if any(sh.draw is None for sh in shards):
            raise ValueError("K10d's one-card route draws the noise in its "
                             "kernel: every shard needs its draw")
        segs = [(sh.lo, sh.feasible.shape[1],
                 (sh.capacity, sh.sched_capacity, sh.bw_avail, sh.node_ok,
                  *sh.carry, sh.feasible)) for sh in shards]
        d = shards[0].draw
        return uniform_topk_cluster(
            "sharded_uniform_topk", segs, shards[0].asks,
            Draw(d.keys, d.scale), g, n_total, penalty, seq, stacked, cps)
    shards = _drawn(shards)
    home = shards[0].feasible.device
    active = shards[0].asks.active.to(home)
    choices = torch.empty((b, k), dtype=torch.int32, device=home)
    scores = torch.empty((b, k), dtype=torch.float32, device=home)
    part = _Partials([sh.feasible.device for sh in shards], home, (b, k),
                     (b, k))
    fixed = [(sh.feasible.shape[1], sh.lo, _ptrs(sh),
              part.local[s][2].data_ptr(), part.local[s][0].data_ptr(),
              part.local[s][1].data_ptr(), sh.feasible.device)
             for s, sh in enumerate(shards)]
    lib = cuda.library()
    topk, merge = lib.nt_shard_topk, lib.nt_shard_merge
    home_stream = cuda.stream_ptr(home)
    streams = [cuda.stream_ptr(f[6]) for f in fixed]
    launches = 0

    def check(err, name):
        if err != 0:
            raise RuntimeError(f"{name}: CUDA error {err}")

    def shard_pass(e, pe, gather):
        nonlocal launches
        for s, (n, lo, ptrs, win_p, key_p, score_p, dev) in enumerate(fixed):
            with _on(dev):
                check(topk(b, n, g, k, lo, float(penalty), int(seq),
                           int(stacked), e, pe, *ptrs, win_p, key_p,
                           score_p, streams[s]), "nt_shard_topk")
            launches += 1
            if gather and w > 1:
                part.gather(s)

    def merge_pass(e):
        nonlocal launches
        with _on(home):
            check(merge(w, b, k, n_total, int(seq), e, part.key.data_ptr(),
                        part.score.data_ptr(), active.data_ptr(),
                        choices.data_ptr(), scores.data_ptr(),
                        part.win.data_ptr(), home_stream), "nt_shard_merge")
        launches += 1
        part.spread()

    if seq:
        for e in range(b):
            shard_pass(e, e - 1, True)
            merge_pass(e)
        shard_pass(-1, b - 1, False)
    else:
        shard_pass(0, -1, True)
        merge_pass(0)
        shard_pass(-1, 0, False)
    cuda.count_launch("sharded_uniform_topk", launches)
    return choices, scores


# ------------------------------------------------------------ K10f, K10g-a


class DefragShard(NamedTuple):
    """One node shard of the defrag solve (K10f), on the shard's device:
    kernels/convex.py ``defrag_solve``'s arguments with the node columns
    split (parallel/mesh.py defrag_solve_specs): the carried logits'
    columns [K,N] and the residual state's rows from global node
    ``lo``; fresh, the asks and active replicated."""

    lo: int
    logits0: torch.Tensor  # [K, N] f32
    fresh: torch.Tensor  # [K] bool
    base_util: torch.Tensor  # [N, 4] f32
    capacity: torch.Tensor  # [N, 4] f32
    sched_capacity: torch.Tensor  # [N, 4] f32
    node_ok: torch.Tensor  # [N] bool
    bw_avail: torch.Tensor  # [N] f32
    bw_used: torch.Tensor  # [N] f32
    ports_free: torch.Tensor  # [N] f32
    ask_res: torch.Tensor  # [K, 4] f32
    ask_bw: torch.Tensor  # [K] f32
    ask_ports: torch.Tensor  # [K] f32
    active: torch.Tensor  # [K] bool


def _check_defrag_shards(shards: List[DefragShard]):
    """Validate a defrag solve's shards against defrag_solve's checks;
    returns K."""
    k = shards[0].logits0.shape[0]
    n_total = 0
    for sh in shards:
        n = sh.logits0.shape[1]
        dev = sh.logits0.device
        f32, u8 = torch.float32, torch.bool
        for name, t, dtype, shape in (
                ("logits0", sh.logits0, f32, (k, n)),
                ("fresh", sh.fresh, u8, (k,)),
                ("base_util", sh.base_util, f32, (n, 4)),
                ("capacity", sh.capacity, f32, (n, 4)),
                ("sched_capacity", sh.sched_capacity, f32, (n, 4)),
                ("node_ok", sh.node_ok, u8, (n,)),
                ("bw_avail", sh.bw_avail, f32, (n,)),
                ("bw_used", sh.bw_used, f32, (n,)),
                ("ports_free", sh.ports_free, f32, (n,)),
                ("ask_res", sh.ask_res, f32, (k, 4)),
                ("ask_bw", sh.ask_bw, f32, (k,)),
                ("ask_ports", sh.ask_ports, f32, (k,)),
                ("active", sh.active, u8, (k,))):
            _check(name, t, dtype, shape, dev)
        if sh.lo != n_total:
            raise ValueError(f"shard columns start at {sh.lo}, expected "
                             f"{n_total}: shards cover the nodes in order")
        n_total += n
    return k


def _check_relax_shards(shards: List[NodeShard]):
    """Validate a placement relaxation's shards against K8a's checks
    (the noise is not read); returns (B, G, K)."""
    from ..ops.binpack import _check_scan_args

    dims = None
    n_total = 0
    for sh in shards:
        b, n, g, k, _stacked = _check_scan_args(
            sh.capacity, sh.sched_capacity, sh.bw_avail, sh.node_ok,
            sh.carry, sh.feasible, sh.asks, None, (),
            sh.carry[0].dim() == 2)
        if dims is not None and dims != (b, g, k):
            raise ValueError("shards disagree on B, G or K")
        dims = (b, g, k)
        if sh.lo != n_total:
            raise ValueError(f"shard rows start at {sh.lo}, expected "
                             f"{n_total}: shards cover the nodes in order")
        n_total += n
    return dims


def _softmax_over_shards(values):
    """The softmax over the last axis of [..., N] split into the shards'
    ``values``: each shard's max m_s and sum s_s of exp, combined in
    shard order as the kernels' combine does (m = max m_s, s = sum s_s
    exp(m_s - m)). One shard gives the one-device softmax bit for bit."""
    home = values[0].device
    ms = [v.amax(-1) for v in values]
    ss = [torch.exp(v - m[..., None]).sum(-1) for v, m in zip(values, ms)]
    m = torch.stack([x.to(home) for x in ms]).amax(0)
    total = torch.zeros_like(m)
    for m_s, s_s in zip(ms, ss):
        total = total + s_s.to(home) * torch.exp(m_s.to(home) - m)
    return [torch.exp(v - m.to(v.device)[..., None])
            / total.to(v.device)[..., None] for v in values]


def sharded_relax_plain(shards, iters: int, penalty: float = 0.0):
    """The plain PyTorch version of K10f / K10g-a: each shard's prologue
    on its columns (kernels/convex.py defrag_terms or placement_terms),
    then ``iters`` mirror-descent steps whose softmax crosses the
    shards (``_softmax_over_shards``) and whose gradient is node-local.
    Returns one tuple a shard: (logits, x) [K,N] for DefragShards;
    (logits, x, pref) [B,K,N] for NodeShards, pref from the cross-shard
    maxima of each row of x and of y = sum_k x."""
    from ..kernels.convex import _md_step, defrag_terms, placement_terms

    defrag = isinstance(shards[0], DefragShard)
    terms, logits = [], []
    for sh in shards:
        if defrag:
            t = defrag_terms(sh.base_util, sh.capacity, sh.sched_capacity,
                             sh.node_ok, sh.bw_avail, sh.bw_used,
                             sh.ports_free, sh.ask_res, sh.ask_bw,
                             sh.ask_ports, sh.active)
            logits.append(torch.where(sh.fresh[:, None], t.lin, sh.logits0))
        else:
            t = placement_terms(sh.capacity, sh.sched_capacity, sh.bw_avail,
                                sh.node_ok, sh.carry, sh.feasible, sh.asks,
                                penalty)
            logits.append(t.lin)
        terms.append(t)
    for _ in range(iters):
        xs = _softmax_over_shards([lg + t.mask
                                   for lg, t in zip(logits, terms)])
        logits = [_md_step(lg, x * t.active, t.lin, *t[2:10])
                  for lg, x, t in zip(logits, xs, terms)]
    xs = _softmax_over_shards([lg + t.mask for lg, t in zip(logits, terms)])
    if defrag:
        return [(lg, x * t.active) for lg, x, t in zip(logits, xs, terms)]
    home = xs[0].device
    ys = [x.sum(-2) for x in xs]
    rowmax = torch.stack([x.amax(-1).to(home) for x in xs]).amax(0)
    ymax = torch.stack([y.amax(-1).to(home) for y in ys]).amax(0)
    out = []
    for lg, x, y in zip(logits, xs, ys):
        rm, ym = rowmax.to(x.device), ymax.to(x.device)
        pref = ((x / (rm[..., None] + 1e-9)
                 + y[..., None, :] / (ym[..., None, None] + 1e-9))
                * 0.5).contiguous()
        out.append((lg, x, pref))
    return out


def sharded_relax(shards, iters: int, penalty: float = 0.0,
                  force_shards: bool = False):
    """K10f and K10g-a: the convex relaxation over node shards, in the
    mode its shards name. DefragShards (K10f) replace the defrag solve
    with x's node columns split (parallel/mesh.py:186,201 and
    defrag/solver.py:457-461 in the JAX package); NodeShards (K10g-a,
    their noise unread) replace the convex kernel's relaxation over a
    node-sharded base (kernels/convex.py:102,136 there, with the
    preference of :253). Returns one tuple a shard, on its device, as
    ``sharded_relax_plain``.

    On the card (csrc/relax.cuh through ops/relax.py solve): the shards
    of one card (up to ops/relax.py SEGS) are the segments of ONE
    cooperative launch, K8a's and K9's kernel: the softmax statistics
    of each row fold over a segment's pieces, then over the segments in
    shard order, inside the launch (one shard gives K8a's and K9's bits).
    Shards on distinct cards run the same phases a launch a phase a
    shard, the statistics folded in the same order on the first shard's
    card between phases (the same bits as one card).
    ``force_shards`` takes that route on one card (the tests' hook)."""
    from ..kernels.convex import relax_asks
    from ..ops import relax

    defrag = isinstance(shards[0], DefragShard)
    if defrag:
        k = _check_defrag_shards(shards)
        b, g = 1, 0
        devices = [sh.logits0.device for sh in shards]
    else:
        b, g, k = _check_relax_shards(shards)
        devices = [sh.feasible.device for sh in shards]
    if {d.type for d in devices} == {"cpu"}:
        return sharded_relax_plain(shards, iters, penalty)
    if {d.type for d in devices} != {"cuda"}:
        raise ValueError(f"shards on unsupported devices {devices}")
    segs, outs = [], []
    for sh, dev in zip(shards, devices):
        if defrag:
            n = sh.logits0.shape[1]
            logits = sh.logits0.clone()
            x = torch.empty_like(logits)
            ptrs = dict(
                capacity=sh.capacity.data_ptr(),
                sched=sh.sched_capacity.data_ptr(),
                bw_avail=sh.bw_avail.data_ptr(),
                node_ok=sh.node_ok.data_ptr(), util=sh.base_util.data_ptr(),
                bw_used=sh.bw_used.data_ptr(),
                ports_free=sh.ports_free.data_ptr())
            asks = dict(ask_res=sh.ask_res.data_ptr(),
                        ask_bw=sh.ask_bw.data_ptr(),
                        ask_ports=sh.ask_ports.data_ptr(),
                        active=sh.active.data_ptr(),
                        fresh=sh.fresh.data_ptr())
            outs.append((logits, x))
        else:
            n = sh.feasible.shape[1]
            util, bw_used, ports_free, job_count, tg_count = sh.carry
            logits = torch.empty((b, k, n), dtype=torch.float32, device=dev)
            x = torch.empty_like(logits)
            pref = torch.empty_like(logits)
            ptrs = dict(
                capacity=sh.capacity.data_ptr(),
                sched=sh.sched_capacity.data_ptr(),
                bw_avail=sh.bw_avail.data_ptr(),
                node_ok=sh.node_ok.data_ptr(), util=util.data_ptr(),
                bw_used=bw_used.data_ptr(), ports_free=ports_free.data_ptr(),
                job_count=job_count.data_ptr(), tg_count=tg_count.data_ptr(),
                feasible=sh.feasible.data_ptr(), pref=pref.data_ptr())
            asks = relax_asks(sh.asks)
            outs.append((logits, x, pref))
        ptrs.update(logits=logits.data_ptr(), x=x.data_ptr())
        segs.append(relax.Segment(dev, n, ptrs, asks))
    stacked = not defrag and shards[0].capacity.dim() == 3
    shared = not defrag and shards[0].carry[0].dim() == 2
    launches = relax.solve("defrag" if defrag else "place", b, k, g,
                           int(iters), float(penalty), stacked, shared, segs,
                           force_shards=force_shards)
    cuda.count_launch("sharded_defrag_solve" if defrag
                      else "sharded_convex_relax", launches)
    return outs


# ------------------------------------------------------------ K10e


class GangShard(NamedTuple):
    """One node shard of a gang dispatch (K10e), all on the shard's
    device: ``state`` the GangState's rows from global row ``lo`` (its
    util, bw_used and ports_free carried, updated in place); the ask
    (ask_res [4], ask_bw and ask_ports [] f32, replicated); ``noise``
    the shard's window of the member noise [K,N]; ``placed`` [N] i32
    and ``group_members`` [g_pad] f32, carried (zeros in), the member
    counts replicated on every shard."""

    lo: int
    state: tuple
    ask_res: torch.Tensor
    ask_bw: torch.Tensor
    ask_ports: torch.Tensor
    noise: torch.Tensor
    placed: torch.Tensor
    group_members: torch.Tensor


def _check_gang_shards(shards: List[GangShard], active, group_noise, config):
    """Validate a gang dispatch's shards against K7's checks."""
    from ..ops.gang import _check_gang_args

    n_total = 0
    home = shards[0].state.capacity.device
    for sh in shards:
        _check_gang_args(sh.state, sh.ask_res, sh.ask_bw, sh.ask_ports,
                         active.to(sh.state.capacity.device), sh.noise,
                         group_noise.to(sh.state.capacity.device), sh.placed,
                         sh.group_members, config.g_pad)
        if sh.lo != n_total:
            raise ValueError(f"shard rows start at {sh.lo}, expected "
                             f"{n_total}: shards cover the nodes in order")
        n_total += sh.state.capacity.shape[0]
    _check("active", active, torch.bool, active.shape, home)
    _check("group_noise", group_noise, torch.float32, (config.g_pad,), home)


def _shard_group_capacity(shards: List[GangShard], units, g_pad: int):
    """K10b over the shards' member units [N] (one a shard): the group
    capacities [g_pad] f32 on the first shard's device."""
    devices = tuple(sh.state.capacity.device for sh in shards)
    lo = tuple(sh.lo for sh in shards)
    return sharded_group_capacity(Mesh([devices]), g_pad)(
        Sharded((tuple(units),), lo, (NODE_AXIS,)),
        Sharded((tuple(sh.state.topo_ids for sh in shards),), lo,
                (NODE_AXIS,)))


def sharded_gang_scan_plain(shards: List[GangShard], active, group_noise,
                            config):
    """The plain PyTorch version of K10e: each shard's member units and
    partial group capacities (K10b's plain version), the slice or the
    spread cap on the first shard's device, then per member each
    shard's local argmax (the first maximum), the best of the W in
    shard order (the lowest global index on ties), the owning shard's
    row update and every shard's member count of the winner's group;
    the all-K rewrite last."""
    from ..ops.gang import (
        GANG_MODE_SLICE,
        GANG_MODE_SPREAD,
        gang_pick_plain,
        gang_scores_plain,
        group_capacity_plain,
        member_units_plain,
        place_member_plain,
    )

    home = shards[0].state.capacity.device
    k = active.shape[0]
    g_pad = config.g_pad
    group_cap = None
    if config.mode in (GANG_MODE_SLICE, GANG_MODE_SPREAD):
        group_cap = group_capacity_combine_plain(torch.stack([
            group_capacity_plain(member_units_plain(
                sh.state, sh.ask_res, sh.ask_bw, sh.ask_ports, config),
                sh.state.topo_ids, g_pad).to(home) for sh in shards]))
    chosen, match, spread_cap = gang_pick_plain(
        group_cap, group_noise, active.to(torch.float32).sum(), k, config)
    choices = torch.full((k,), -1, dtype=torch.int32, device=home)
    scores = torch.zeros((k,), dtype=torch.float32, device=home)
    for j in range(k):
        if not bool(active[j]):
            continue
        tops, bests = [], []
        for sh in shards:
            score = gang_scores_plain(
                sh.state, sh.ask_res, sh.ask_bw, sh.ask_ports, config,
                sh.placed, sh.group_members, match,
                spread_cap.to(sh.noise.device), sh.noise[j])
            best = int(torch.argmax(score))
            tops.append(score[best].to(home))
            bests.append(best)
        owner = int(torch.argmax(torch.stack(tops)))
        if not bool(tops[owner] > NEG_INF / 2):
            continue
        sh, row = shards[owner], bests[owner]
        choices[j] = sh.lo + row
        scores[j] = tops[owner] - sh.noise[j, row].to(home)
        place_member_plain(sh.state, sh.ask_res, sh.ask_bw, sh.ask_ports,
                           row, sh.placed)
        gid = int(sh.state.topo_ids[row])
        if 0 <= gid < g_pad:
            for other in shards:
                other.group_members[gid] += 1.0
    if bool((active & (choices < 0)).any()):
        choices.fill_(-1)
        scores.zero_()
        chosen = -1
    return (choices, scores,
            torch.tensor(chosen, dtype=torch.int32, device=home))


def sharded_gang_scan(shards: List[GangShard], active, group_noise, config,
                      force_shards: bool = False):
    """K10e: one gang's all-K placement over node shards (K7 with the
    node axis split). Replaces the GSPMD form of
    ``gang_placement_program_jit`` (ops/gang.py:264 in the JAX package)
    on a GangState from ``shard_gang_inputs`` (parallel/mesh.py:149,175
    there). ``active`` [K] bool and ``group_noise`` [g_pad] f32 lie on
    the first shard's device. Returns (choices [K] i32 global node
    indices, scores [K] f32, slice_group [] i32) there; each shard's
    carry (util, bw_used, ports_free, placed, group_members) is updated
    in place.

    On the card the route is ``scan_ctas``' choice. Shards of one card
    (W <= 16): one launch of K7's cluster kernel (csrc/gang_scan.cu,
    ``_gang_on_cluster``), each shard's rows, noise window, ``placed``
    and member counts its own segment: the member units and group sums
    (summed again a shard in node order, then in shard order, where
    they are not exact), the slice or spread cap, the K member steps
    and the all-K rewrite, every shard's counts written at the end.
    Otherwise (csrc/sharded_gang.cu): in slice and spread mode the
    member units a shard and K10b's group capacities; the slice or the
    spread cap on the first shard's device; K member steps of a step
    kernel a shard and a winner kernel that carries the winner's
    topology group id, read on its owning shard, so every shard adds
    the member to the same group; the all-K rewrite: K x (W + 1) + 2 W
    + 2 launches of its own, plus K10b's (one a card) in slice and
    spread mode. ``force_shards`` takes that route on one card (the
    tests' and the measurements' hook)."""
    from ..ops.gang import _MODE_IDS, GANG_MODE_SLICE, GANG_MODE_SPREAD

    _check_gang_shards(shards, active, group_noise, config)
    home = shards[0].state.capacity.device
    if _kind(sh.state.capacity for sh in shards) == "cpu":
        return sharded_gang_scan_plain(shards, active, group_noise, config)
    cps = scan_ctas(sh.state.capacity.device for sh in shards)
    if cps and not force_shards:
        return _gang_on_cluster(shards, active, group_noise, config, cps)
    k = active.shape[0]
    g_pad, mode = config.g_pad, _MODE_IDS[config.mode]
    dh = int(config.distinct_hosts)
    penalty = float(config.anti_affinity_penalty)
    w = len(shards)
    lib = cuda.library()
    devices = [sh.state.capacity.device for sh in shards]
    streams = [cuda.stream_ptr(d) for d in devices]
    launches = 0

    def run(fn, dev, stream, *args):
        nonlocal launches
        with _on(dev):
            err = getattr(lib, fn)(*args, stream)
        if err != 0:
            raise RuntimeError(f"{fn}: CUDA error {err}")
        launches += 1

    group_cap = None
    if config.mode in (GANG_MODE_SLICE, GANG_MODE_SPREAD):
        units = []
        for s, sh in enumerate(shards):
            st = sh.state
            u = torch.empty(st.capacity.shape[0], dtype=torch.float32,
                            device=devices[s])
            run("nt_gang_units", devices[s], streams[s], u.shape[0], mode,
                dh, st.capacity.data_ptr(), st.util.data_ptr(),
                st.bw_avail.data_ptr(), st.bw_used.data_ptr(),
                st.ports_free.data_ptr(), st.feas_row.data_ptr(),
                st.dh_presence.data_ptr(), st.topo_ids.data_ptr(),
                sh.ask_res.data_ptr(), sh.ask_bw.data_ptr(),
                sh.ask_ports.data_ptr(), u.data_ptr())
            units.append(u)
        group_cap = _shard_group_capacity(shards, units, g_pad)
    meta = torch.empty(4, dtype=torch.int32, device=home)
    run("nt_gang_pick", home, streams[0], k, g_pad, mode, active.data_ptr(),
        0 if group_cap is None else group_cap.data_ptr(),
        group_noise.data_ptr(), meta.data_ptr())
    metas = [meta if d == home else meta.to(d, non_blocking=True)
             for d in devices]
    part = _Partials(devices, home, (1,), (2,), gid=True)
    choices = torch.empty(k, dtype=torch.int32, device=home)
    scores = torch.empty(k, dtype=torch.float32, device=home)
    fixed = []
    for s, sh in enumerate(shards):
        st = sh.state
        fixed.append((st.capacity.shape[0], sh.lo, (
            st.capacity.data_ptr(), st.sched_capacity.data_ptr(),
            st.util.data_ptr(), st.bw_avail.data_ptr(),
            st.bw_used.data_ptr(), st.ports_free.data_ptr(),
            st.feas_row.data_ptr(), st.job_count.data_ptr(),
            st.dh_presence.data_ptr(), st.topo_ids.data_ptr(),
            sh.ask_res.data_ptr(), sh.ask_bw.data_ptr(),
            sh.ask_ports.data_ptr(), sh.noise.data_ptr(),
            metas[s].data_ptr(), part.local[s][2].data_ptr(),
            sh.placed.data_ptr(), sh.group_members.data_ptr(),
            part.local[s][0].data_ptr(), part.local[s][1].data_ptr(),
            part.local[s][3].data_ptr())))
    prev = -1
    for j in list(range(k)) + [-1]:
        for s, (n, lo, ptrs) in enumerate(fixed):
            run("nt_gang_step", devices[s], streams[s], n, k, g_pad, lo, mode,
                dh, penalty, j, prev, *ptrs)
            if j >= 0 and w > 1:
                part.gather(s)
        if j < 0:
            break
        run("nt_gang_winner", home, streams[0], w, j, part.key.data_ptr(),
            part.score.data_ptr(), part.gid.data_ptr(), active.data_ptr(),
            choices.data_ptr(), scores.data_ptr(), part.win.data_ptr())
        part.spread()
        prev = j
    slice_group = torch.empty((), dtype=torch.int32, device=home)
    run("nt_gang_finish", home, streams[0], k, active.data_ptr(),
        meta.data_ptr(), choices.data_ptr(), scores.data_ptr(),
        slice_group.data_ptr())
    cuda.count_launch("sharded_gang_scan", launches)
    return choices, scores, slice_group


def _gang_on_cluster(shards: List[GangShard], active, group_noise, config,
                     cps: int):
    """One launch of K7's cluster kernel over the shards of one card
    (K10e), ``cps`` CTAs a shard, on ``scan.gang_plan_for``'s plan over
    the shards' segments; counts one launch."""
    from ..ops import scan
    from ..ops.gang import _MODE_IDS

    mode = _MODE_IDS[config.mode]
    rows = [sh.state.capacity.shape[0] for sh in shards]
    plan = scan.gang_plan_for(shards[0].state.capacity.device, sum(rows),
                              config.g_pad, mode, ctas=cps * len(shards),
                              segments=rows)
    segs = [(sh.lo, n, (*sh.state, sh.noise, sh.placed, sh.group_members))
            for sh, n in zip(shards, rows)]
    first = shards[0]
    out = scan.launch_gang_segments(
        plan, segs, first.ask_res, first.ask_bw, first.ask_ports, active,
        group_noise, mode, config.distinct_hosts,
        config.anti_affinity_penalty)
    cuda.count_launch("sharded_gang_scan")
    return out
