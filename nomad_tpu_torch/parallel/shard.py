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
from typing import List, NamedTuple, Optional

import torch

from ..ops import cuda
from ..ops.binpack import (
    NEG_INF,
    Asks,
    _check,
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
    noise, [B,K,N] (greedy) or [B,N] (uniform); ``pref`` the shard's
    columns of the convex relaxation's preference [B,K,N], which only
    the convex rounding scan (K10g-b) reads."""

    lo: int
    capacity: torch.Tensor
    sched_capacity: torch.Tensor
    bw_avail: torch.Tensor
    node_ok: torch.Tensor
    carry: tuple
    feasible: torch.Tensor
    asks: Asks
    noise: torch.Tensor
    pref: Optional[torch.Tensor] = None


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
            noise=sh.noise[one],
            pref=None if sh.pref is None else sh.pref[one]))
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
    dims = _check_shards(shards, seq, False)
    if _kind(sh.feasible for sh in shards) == "cpu":
        return sharded_greedy_scan_plain(shards, penalty, seq)
    return _steps_on_card(shards, penalty, seq, dims, False,
                          "sharded_greedy_scan")


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
                         seq: bool = False):
    """K10g-b: the convex kernel's rounding scan of B evals over node
    shards (K8b with the node axis split: K10c's step and winner
    kernels with the rounding bias). Replaces the GSPMD form of the
    body scan of ``convex_placement_program`` (kernels/convex.py:224 in
    the JAX package) over a node-sharded base. Arguments and results as
    ``sharded_greedy_scan``, with each shard's ``pref`` [B,K,N] set (its
    columns of the relaxation's preference, K10g-a).

    On the card (csrc/sharded_scan.cu) each shard's step packs score +
    ROUND_BIAS x pref - STRAND_BIAS x strand penalty, its strand penalty
    read from its own carried rows, and reports the score without the
    noise and the bias, as K8b does. K x (W + 1) + W launches an eval:
    launches bound it, as K10c."""
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
    return _steps_on_card(shards, penalty, seq, dims, True,
                          "sharded_convex_round")


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
    part = _Partials([sh.feasible.device for sh in shards], home, (b, k),
                     (b, k))
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


class _Exchange:
    """Float partial rows of the W shards gathered on the combining
    device, and the combined row sent back (the sharded relaxation's
    softmax statistics and pref maxima). As with ``_Partials``, a shard
    on the combining device writes its row of the combining buffer and
    reads the combined row in place; a shard on another card has
    buffers of its own, copied across outside the kernels."""

    def __init__(self, devices, home, part_len: int, out_len: int):
        f32 = torch.float32
        self.home = home
        self.part = torch.empty((len(devices), part_len), dtype=f32,
                                device=home)
        self.out = torch.empty(out_len, dtype=f32, device=home)
        self.local = [
            (self.part[s], self.out) if dev == home else
            (torch.empty(part_len, dtype=f32, device=dev),
             torch.empty(out_len, dtype=f32, device=dev))
            for s, dev in enumerate(devices)]

    def gather(self, s):
        part, _out = self.local[s]
        if part.device != self.home:
            self.part[s].copy_(part, non_blocking=True)

    def spread(self):
        for _part, out in self.local:
            if out.device != self.home:
                out.copy_(self.out, non_blocking=True)


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


def sharded_relax(shards, iters: int, penalty: float = 0.0):
    """K10f and K10g-a: the convex relaxation over node shards, in the
    mode its shards name. DefragShards (K10f) replace the defrag solve
    with x's node columns split (parallel/mesh.py:186,201 and
    defrag/solver.py:457-461 in the JAX package); NodeShards (K10g-a,
    their noise unread) replace the convex kernel's relaxation over a
    node-sharded base (kernels/convex.py:102,136 there, with the
    preference of :253). Returns one tuple a shard, on its device, as
    ``sharded_relax_plain``.

    On the card (csrc/sharded_relax.cu): the prologue a shard, then per
    iteration the row pass a shard (each row's softmax max and sum over
    the shard's columns), the combine on the first shard's device (m =
    max m_s, s = sum s_s exp(m_s - m) in shard order) and the
    node-local column pass a shard; then x, and in placement mode the
    cross-shard maxima and pref. 3 W + iters x (2 W + 1) + 2 W + 1
    launches (+ 2 W + 1 for pref); no kernel writes another shard's
    memory."""
    from ..kernels.convex import _relax_scratch

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
    home = devices[0]
    w = len(shards)
    bk = b * k
    lib = cuda.library()
    stats = _Exchange(devices, home, 2 * bk, 2 * bk)
    streams = [cuda.stream_ptr(d) for d in devices]
    launches = 0

    def run(fn, s, *args):
        nonlocal launches
        with _on(devices[s]):
            err = getattr(lib, fn)(*args, streams[s])
        if err != 0:
            raise RuntimeError(f"{fn}: CUDA error {err}")
        launches += 3 if fn == "nt_srelax_prologue" else 1

    outs = []
    for s, sh in enumerate(shards):
        dev = devices[s]
        if defrag:
            n = sh.logits0.shape[1]
            logits = sh.logits0.clone()
            state = (1, 1, n, 0, k, 0.0, 0, 0, sh.capacity.data_ptr(),
                     sh.sched_capacity.data_ptr(), sh.bw_avail.data_ptr(),
                     sh.node_ok.data_ptr(), sh.base_util.data_ptr(),
                     sh.bw_used.data_ptr(), sh.ports_free.data_ptr(), 0, 0,
                     0, sh.ask_res.data_ptr(), sh.ask_bw.data_ptr(),
                     sh.ask_ports.data_ptr(), 0, sh.active.data_ptr(), 0, 0,
                     sh.fresh.data_ptr())
        else:
            n = sh.feasible.shape[1]
            util, bw_used, ports_free, job_count, tg_count = sh.carry
            a = sh.asks
            logits = torch.empty((b, k, n), dtype=torch.float32, device=dev)
            state = (0, b, n, g, k, float(penalty),
                     int(sh.capacity.dim() == 3), int(util.dim() == 2),
                     sh.capacity.data_ptr(), sh.sched_capacity.data_ptr(),
                     sh.bw_avail.data_ptr(), sh.node_ok.data_ptr(),
                     util.data_ptr(), bw_used.data_ptr(),
                     ports_free.data_ptr(), job_count.data_ptr(),
                     tg_count.data_ptr(), sh.feasible.data_ptr(),
                     a.resources.data_ptr(), a.bw.data_ptr(),
                     a.ports.data_ptr(), a.tg_index.data_ptr(),
                     a.active.data_ptr(), a.job_distinct_hosts.data_ptr(),
                     a.tg_distinct_hosts.data_ptr(), 0)
        feas = torch.empty(logits.shape, dtype=torch.bool, device=dev)
        scratch = _relax_scratch(b, n, k, dev)
        x = torch.empty_like(logits)
        outs.append((n, logits, feas, scratch, x))
        run("nt_srelax_prologue", s, *state, logits.data_ptr(),
            feas.data_ptr(), *(t.data_ptr() for t in scratch[:5]))

    def combine(ex, count, mode):
        for s, (n, logits, feas, _scr, _x) in enumerate(outs):
            if mode == 0:
                run("nt_srelax_rows", s, b, n, k, logits.data_ptr(),
                    feas.data_ptr(), ex.local[s][0].data_ptr())
            else:
                run("nt_srelax_max", s, b, n, k, _x.data_ptr(),
                    _scr[2].data_ptr(), ex.local[s][0].data_ptr())
            ex.gather(s)
        run("nt_srelax_combine", 0, w, count, mode, ex.part.data_ptr(),
            ex.out.data_ptr())
        ex.spread()

    for _ in range(iters):
        combine(stats, bk, 0)
        for s, (n, logits, feas, scr, _x) in enumerate(outs):
            run("nt_srelax_cols", s, b, n, k, logits.data_ptr(),
                scr[0].data_ptr(), feas.data_ptr(), scr[1].data_ptr(),
                scr[2].data_ptr(), scr[3].data_ptr(), scr[4].data_ptr(),
                stats.local[s][1].data_ptr())
    combine(stats, bk, 0)
    for s, (n, logits, feas, scr, x) in enumerate(outs):
        run("nt_srelax_x", s, int(defrag), b, n, k, logits.data_ptr(),
            feas.data_ptr(), scr[2].data_ptr(), scr[4].data_ptr(),
            stats.local[s][1].data_ptr(), x.data_ptr())
    if defrag:
        cuda.count_launch("sharded_defrag_solve", launches)
        return [(logits, x) for _n, logits, _f, _s, x in outs]
    maxima = _Exchange(devices, home, bk + b, bk + b)
    combine(maxima, bk + b, 1)
    result = []
    for s, (n, logits, _f, scr, x) in enumerate(outs):
        pref = torch.empty_like(x)
        run("nt_srelax_pref", s, b, n, k, x.data_ptr(), scr[2].data_ptr(),
            maxima.local[s][1].data_ptr(), pref.data_ptr())
        result.append((logits, x, pref))
    cuda.count_launch("sharded_convex_relax", launches)
    return result


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


def sharded_gang_scan(shards: List[GangShard], active, group_noise, config):
    """K10e: one gang's all-K placement over node shards (K7 with the
    node axis split). Replaces the GSPMD form of
    ``gang_placement_program_jit`` (ops/gang.py:264 in the JAX package)
    on a GangState from ``shard_gang_inputs`` (parallel/mesh.py:149,175
    there). ``active`` [K] bool and ``group_noise`` [g_pad] f32 lie on
    the first shard's device. Returns (choices [K] i32 global node
    indices, scores [K] f32, slice_group [] i32) there; each shard's
    carry (util, bw_used, ports_free, placed, group_members) is updated
    in place.

    On the card (csrc/sharded_gang.cu): in slice and spread mode the
    member units a shard and K10b's group capacities; the slice or the
    spread cap on the first shard's device; K member steps of a step
    kernel a shard and a winner kernel that carries the winner's
    topology group id, read on its owning shard, so every shard adds
    the member to the same group; the all-K rewrite. K x (W + 1) + 2 W
    + 2 launches of its own, plus K10b's W + 1 in slice and spread
    mode."""
    from ..ops.gang import _MODE_IDS, GANG_MODE_SLICE, GANG_MODE_SPREAD

    _check_gang_shards(shards, active, group_noise, config)
    home = shards[0].state.capacity.device
    if _kind(sh.state.capacity for sh in shards) == "cpu":
        return sharded_gang_scan_plain(shards, active, group_noise, config)
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
