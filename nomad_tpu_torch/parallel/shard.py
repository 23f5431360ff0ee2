"""Programs over the node shards of a resident base: the port of the
JAX package's parallel/shard.py (its shard_map programs), plus the
node-sharded scans that GSPMD derives there from the placement program
(parallel/mesh.py).

Each kernel works on one shard's slice; the cross-shard step combines
W small partial buffers on the combining device (the first shard's),
outside the kernels (parallel/mesh.py's module docstring says how):

- ``sharded_base_delta`` (K10a): the resident-base row scatter with a
  replicated payload; each shard keeps the rows that land in its slice
  (csrc/base_delta.cu with a row offset, once per shard). Zero
  collectives.
- ``sharded_group_capacity`` (K10b): the gang program's topology-group
  scatter-add; each shard sums its members into a partial group vector
  (csrc/group_capacity.cu), and the W partials add up in shard order.
- ``sharded_greedy_scan`` (K10c): K1 over node shards, two launches a
  step (csrc/sharded_scan.cu).
- ``sharded_uniform_topk`` (K10d): K2 over node shards, a local top-K
  per shard and a merge (csrc/sharded_topk.cu).

Every wrapper runs its plain PyTorch version when its tensors lie on
the CPU, and launches its kernel (or raises) when they lie on CUDA
devices. There is no program cache: an eager port compiles nothing per
shape, so the JAX package's ``shard_cache_size`` has no counterpart.
"""

from __future__ import annotations

import contextlib
from typing import List, NamedTuple

import torch

from ..ops import cuda
from ..ops.binpack import (
    NEG_INF,
    Asks,
    _score_plain,
    _update_rows,
    base_delta_rows,
)
from .mesh import NODE_AXIS, Mesh, Sharded, delta_row_specs, is_sharded, \
    place

# Shared memory a block of the shard kernels may take (227 KB on sm_90).
_SMEM_MAX = 227 * 1024


def node_shard_count(mesh: Mesh) -> int:
    """Shards along the node axis of a parallel/mesh.py mesh."""
    return int(mesh.shape[NODE_AXIS])


def _on(dev: torch.device):
    """The CUDA runtime's current device set to ``dev`` for a launch:
    a kernel launches on the current device's context, and the shards of
    a mesh of distinct cards each launch on their own."""
    if dev.type == "cuda" and dev.index is not None \
            and torch.cuda.current_device() != dev.index:
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def _kind(tensors) -> str:
    """'cpu' or 'cuda' for tensors all on one kind of device."""
    kinds = {t.device.type for t in tensors}
    if len(kinds) != 1 or kinds - {"cpu", "cuda"}:
        raise ValueError(f"shards on unsupported devices {sorted(kinds)}")
    return kinds.pop()


# ------------------------------------------------------------ K10a


def sharded_base_delta(mesh: Mesh):
    """The row scatter of ops/binpack.py apply_base_delta over a
    node-sharded resident base: the four mutable arrays arrive as
    ``Sharded`` (parallel/mesh.py base_specs; dp row 0), the payload
    (rows [R] i32 global, util_rows [R,4], bw_rows, ports_rows [R] f32,
    ok_rows [R] bool) as host arrays, replicated onto the mesh. Each
    shard rebases the rows into its slice and drops the rest (K10a,
    csrc/base_delta.cu launched once per shard); padding rows repeat a
    real row (the batcher's ``_pad_rows``) and write identical values.
    Returns the four child arrays as ``Sharded``; the parent stays as
    it was."""
    row = Mesh([mesh.row(0)])

    def run(util, bw_used, ports_free, node_ok, *payload):
        targets = [util, bw_used, ports_free, node_ok]
        if not all(is_sharded(t) for t in targets):
            from .mesh import base_specs

            specs = base_specs()
            targets = list(place(row, targets,
                                 [specs[2], specs[4], specs[5], specs[6]]))
        pay = place(row, payload, delta_row_specs())
        parts = [[] for _ in targets]
        for s, dev in enumerate(row.row(0)):
            with _on(dev):
                out = base_delta_rows(
                    *(t.parts[0][s] for t in targets),
                    *(p.parts[0][s] for p in pay), targets[0].lo[s],
                    "sharded_base_delta")
            for j, t in enumerate(out):
                parts[j].append(t)
        return tuple(Sharded((tuple(p),), t.lo, t.spec)
                     for p, t in zip(parts, targets))

    return run


# ------------------------------------------------------------ K10b


def group_capacity_combine_plain(partials: torch.Tensor) -> torch.Tensor:
    """The plain version of K10b's combine: the [W, g_pad] partials
    added in shard order."""
    out = partials[0].clone()
    for s in range(1, partials.shape[0]):
        out = out + partials[s]
    return out


def sharded_group_capacity(mesh: Mesh, g_pad: int):
    """The gang program's topology-group scatter-add over node shards
    (the JAX package's shard_map of ``_group_capacity`` plus a psum):
    ``units`` [N] f32 and ``topo_ids`` [N] i32 (host arrays, or
    ``Sharded`` over the nodes) give each shard's partial [g_pad]
    (ops/gang.py group_capacity, csrc/group_capacity.cu), and the W
    partials, brought to the first shard's device, add up in shard
    order (K10b's combine). Returns [g_pad] f32 there.

    Equal to the one-device node-order sum while every partial is exact
    in float32 (whole numbers under 2^24), as JAX's psum is. Past that
    (a zero ask gives a node 1e9 units) every addition rounds, and the
    shard order and the node order each stay within m x 2^-24 of the
    exact sum of a group's m addends, not equal to each other."""
    from ..ops.gang import group_capacity

    row = Mesh([mesh.row(0)])
    w = node_shard_count(mesh)

    def run(units, topo_ids):
        pair = [units, topo_ids]
        if not all(is_sharded(t) for t in pair):
            pair = list(place(row, pair, [(NODE_AXIS,), (NODE_AXIS,)]))
        u_parts, id_parts = pair[0].parts[0], pair[1].parts[0]
        home = u_parts[0].device
        partials = torch.empty((w, g_pad), dtype=torch.float32, device=home)
        for s in range(w):
            dev = u_parts[s].device
            with _on(dev):
                if dev == home:
                    group_capacity(u_parts[s], id_parts[s], g_pad,
                                   out=partials[s])
                else:
                    partials[s].copy_(group_capacity(
                        u_parts[s], id_parts[s], g_pad), non_blocking=True)
        if home.type == "cpu":
            return group_capacity_combine_plain(partials)
        out = torch.empty(g_pad, dtype=torch.float32, device=home)
        with _on(home):
            cuda.launch("nt_group_combine", w, g_pad, partials.data_ptr(),
                        out.data_ptr(), cuda.stream_ptr(home))
        cuda.count_launch("group_capacity")
        return out

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
    noise, [B,K,N] (greedy) or [B,N] (uniform)."""

    lo: int
    capacity: torch.Tensor
    sched_capacity: torch.Tensor
    bw_avail: torch.Tensor
    node_ok: torch.Tensor
    carry: tuple
    feasible: torch.Tensor
    asks: Asks
    noise: torch.Tensor


def _check_shards(shards: List[NodeShard], seq: bool, uniform: bool):
    """Validate a scan's shards against binpack's scan checks; returns
    (B, N_total, G, K, stacked)."""
    from ..ops.binpack import _check_scan_args

    b = g = k = None
    n_total = 0
    stacked = shards[0].capacity.dim() == 3
    for sh in shards:
        n = sh.feasible.shape[1]
        noise_shape = (n,) if uniform else (sh.asks.resources.shape[1], n)
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
    return b, n_total, g, k, stacked


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
            noise=sh.noise[one]))
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


def sharded_greedy_scan_plain(shards: List[NodeShard], penalty: float,
                              seq: bool = False):
    """The plain PyTorch version of K10c: per step, each shard's local
    argmax (torch.argmax: the first maximum, its lowest index), then the
    best of the W in shard order (the first maximum again: the lowest
    global index on ties), and the owning shard's one-row update."""
    if seq:
        return _in_order(sharded_greedy_scan_plain, shards, penalty)
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
            best = torch.argmax(score, dim=1)
            top = score[ar, best]
            tops.append(top)
            bests.append(best)
            cleans.append(top - nz[ar, best])
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
    PyTorch against both devices' current streams)."""

    def __init__(self, shards, home, key_shape, win_shape):
        w = len(shards)
        self.home = home
        self.key = torch.empty((w, *key_shape), dtype=torch.int64,
                               device=home)
        self.score = torch.empty((w, *key_shape), dtype=torch.float32,
                                 device=home)
        self.win = torch.full(win_shape, -1, dtype=torch.int32, device=home)
        self.local = []
        for s, sh in enumerate(shards):
            dev = sh.feasible.device
            if dev == home:
                self.local.append((self.key[s], self.score[s], self.win))
            else:
                self.local.append((
                    torch.empty(key_shape, dtype=torch.int64, device=dev),
                    torch.empty(key_shape, dtype=torch.float32, device=dev),
                    torch.full(win_shape, -1, dtype=torch.int32,
                               device=dev)))

    def gather(self, s):
        """Shard s's candidates onto the combining device."""
        key, score, _win = self.local[s]
        if key.device != self.home:
            self.key[s].copy_(key, non_blocking=True)
            self.score[s].copy_(score, non_blocking=True)

    def spread(self):
        """The winners onto every other card."""
        for _key, _score, win in self.local:
            if win.device != self.home:
                win.copy_(self.win, non_blocking=True)


def sharded_greedy_scan(shards: List[NodeShard], penalty: float,
                        seq: bool = False):
    """K10c: greedy scans of K asks for B evals over node shards (K1
    over the node axis split into ``shards``, in K1's independent,
    sequential ``seq`` and stacked layouts). Replaces the GSPMD form of
    ``placement_program`` over node-sharded inputs (parallel/mesh.py:212
    ``sharded_placement`` and the greedy dispatches over a sharded base
    in the JAX package). Returns (choices [B,K] i32 global node indices,
    scores [B,K] f32 without the noise) on the first shard's device;
    the shards' carries are updated in place.

    On the card (csrc/sharded_scan.cu) each step is one nt_shard_step
    launch per shard (the last winner's update in its prologue, then
    the slice's packed best key) and one nt_shard_winner launch on the
    first shard's device (the max of the W keys, the owning shard's
    noise-free score); a last step launch per shard applies the last
    winner. K x (W + 1) + W launches an eval (B x that under ``seq``),
    so launches bound it: the one-card form is slower than K1."""
    b, n_total, g, k, stacked = _check_shards(shards, seq, False)
    if _kind(sh.feasible for sh in shards) == "cpu":
        return sharded_greedy_scan_plain(shards, penalty, seq)
    home = shards[0].feasible.device
    active = shards[0].asks.active.to(home)
    choices = torch.empty((b, k), dtype=torch.int32, device=home)
    scores = torch.empty((b, k), dtype=torch.float32, device=home)
    part = _Partials(shards, home, (b,), (b,))
    w = len(shards)
    fixed = [(sh.feasible.shape[1], sh.lo, _ptrs(sh),
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

    def check(err, name):
        if err != 0:
            raise RuntimeError(f"{name}: CUDA error {err}")

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
    cuda.count_launch("sharded_greedy_scan", launches)
    return choices, scores


def sharded_uniform_topk(shards: List[NodeShard], penalty: float,
                         seq: bool = False):
    """K10d: the uniform distinct-hosts placement of B evals over node
    shards (K2 over the node axis split into ``shards``, in K2's
    layouts). Replaces the GSPMD form of ``_uniform_topk_program``
    (ops/binpack.py:302 in the JAX package) over a node-sharded base.
    Arguments as ``sharded_greedy_scan`` except each shard's noise [B,
    N] (one draw a node). Returns (choices, scores) [B,K] on the first
    shard's device.

    On the card (csrc/sharded_topk.cu): one nt_shard_topk launch per
    shard (the last eval's winners update their rows in its prologue;
    the slice's keys sorted, its top K kept) and one nt_shard_merge on
    the first shard's device (the W x K candidates sorted, the first
    min(K, N) K2's choices); W + 1 launches an eval under ``seq`` (all
    evals at once otherwise) and W more to apply the last winners."""
    b, n_total, g, k, stacked = _check_shards(shards, seq, True)
    if _kind(sh.feasible for sh in shards) == "cpu":
        return sharded_uniform_topk_plain(shards, penalty, seq)
    home = shards[0].feasible.device
    w = len(shards)
    active = shards[0].asks.active.to(home)
    choices = torch.empty((b, k), dtype=torch.int32, device=home)
    scores = torch.empty((b, k), dtype=torch.float32, device=home)
    part = _Partials(shards, home, (b, k), (b, k))
    m_pad = 1 << max(w * k - 1, 0).bit_length()
    merge_keys = merge_slot = None
    if m_pad * 12 > _SMEM_MAX:
        rows = 1 if seq else b
        merge_keys = torch.empty((rows, m_pad), dtype=torch.int64,
                                 device=home)
        merge_slot = torch.empty((rows, m_pad), dtype=torch.int32,
                                 device=home)
    fixed = []
    for s, sh in enumerate(shards):
        n = sh.feasible.shape[1]
        n_pad = 1 << max(n - 1, 0).bit_length()
        scratch = None
        if n_pad * 8 > _SMEM_MAX:
            scratch = torch.empty((1 if seq else b, n_pad),
                                  dtype=torch.int64, device=sh.feasible.device)
        fixed.append((n, n_pad, sh.lo, _ptrs(sh),
                      0 if scratch is None else scratch.data_ptr(),
                      part.local[s][2].data_ptr(),
                      part.local[s][0].data_ptr(),
                      part.local[s][1].data_ptr(), sh.feasible.device,
                      scratch))
    lib = cuda.library()
    topk, merge = lib.nt_shard_topk, lib.nt_shard_merge
    home_stream = cuda.stream_ptr(home)
    streams = [cuda.stream_ptr(f[8]) for f in fixed]
    launches = 0

    def check(err, name):
        if err != 0:
            raise RuntimeError(f"{name}: CUDA error {err}")

    def shard_pass(e, pe, gather):
        nonlocal launches
        for s, (n, n_pad, lo, ptrs, scr, win_p, key_p, score_p, dev,
                _keep) in enumerate(fixed):
            with _on(dev):
                check(topk(b, n, n_pad, g, k, lo, float(penalty), int(seq),
                           int(stacked), e, pe, *ptrs, scr, win_p, key_p,
                           score_p, streams[s]), "nt_shard_topk")
            launches += 1
            if gather and w > 1:
                part.gather(s)

    def merge_pass(e):
        nonlocal launches
        with _on(home):
            check(merge(w, b, k, n_total, m_pad, int(seq), e,
                        part.key.data_ptr(), part.score.data_ptr(),
                        active.data_ptr(),
                        0 if merge_keys is None else merge_keys.data_ptr(),
                        0 if merge_slot is None else merge_slot.data_ptr(),
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
