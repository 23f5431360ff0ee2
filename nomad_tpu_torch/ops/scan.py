"""The host side of the cluster scans' launches: the greedy scan (K1,
K5a-greedy and K5b-greedy: csrc/greedy_scan.cu), the convex kernel's
rounding scan (K8b: the same kernel with the rounding bias,
csrc/convex_round.cu), the gang scan (K7: csrc/gang_scan.cu) and the
preemption scan (K6: csrc/preempt_scan.cu).

One launch a call: a thread-block cluster of ``ctas`` CTAs an eval (one
cluster walking the B evals under ``seq``), the node axis split over
the cluster's CTAs. ``scan_plan`` picks, from the shapes and the card's
occupancy:

- the cluster: the largest (up to ``CLUSTER_MAX``) whose clusters the
  card holds at once for every eval of the call (one wave: B = 64 takes
  2 CTAs, 128 on the card; one eval or ``seq`` the largest), or, when
  none does, the smallest that fits at all;
- the slices: CTA r owns nodes [r N / c, (r + 1) N / c), none empty
  while N >= c; the threads: one node a thread up to 1,024 nodes a
  slice, else the fewest threads that give every thread the same count
  (a multiple of 32);
- the noise: drawn in the kernel (from the batch's keys, a
  ``prng.Draw``: each thread its nodes' values a step ahead in
  registers) or read from K0's [B, K, N] tensor, which K0 draws on
  every SM before the scan (``draws``; drawn, the hash's ~80 integer
  instructions a node a step run on the launch's own SMs);
- the form: "resident" (the slice's rows in shared memory for the
  launch, two sets of an eval's rows under ``seq``) where the layout
  fits in 227 KB, else "streamed" (the rows in global memory, the
  score cache and, read, the noise's four stages each kept where they
  fit).

K8b's plan (``bias``) is K1's with the noise read and two more rows a
node: its pref row staged beside each noise stage, and its strand term
beside each cached score. K7's (``gang_plan``: one gang, one cluster)
adds where the group member counts and sums live: shared memory where
the layout fits, else global memory (a row of counts a CTA). K6's
(``preempt_plan``: one eval, one cluster) keeps each node's victim
slots beside its rows in the resident form, and two cached scores a
node (the normal fit and the preemption).

``segments`` plans the same kernels over node shards of one card (K10c
and K10g-b on K1's kernel, K10e on K7's: parallel/shard.py): the
cluster is ``cps`` CTAs a shard, each shard's rows their own segment,
the slices the longest of the shards' parts, the noise always read
(the shards carry drawn windows). ``launch_segments`` and
``launch_gang_segments`` pass the kernels the segment table.

``layout``, ``gang_layout`` and ``preempt_layout`` are the kernels'
shared-memory layouts (nt_scan_layout, nt_gang_layout,
nt_preempt_layout); the C entries recompute them and refuse a plan
whose size differs.

Nothing here runs at import or on the CPU: the wrappers run the plain
versions for CPU tensors and call ``launch``, ``launch_round``,
``launch_gang`` or ``launch_preempt`` for CUDA ones.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, \
    Tuple

import torch

from . import cuda
from .prng import threefry_uniform

# csrc/greedy_scan.cu: threads a CTA (NT_SCAN_THREADS), CTAs a cluster
# (NT_SCAN_CLUSTER_MAX; above 8 a non-portable size, which beat 8 CTAs
# on the H100: PERF.md), shared memory a CTA (NT_SCAN_SMEM_MAX).
THREADS_MAX = 1024
CLUSTER_MAX = 16
SMEM_MAX = 227 * 1024
# Shared memory the segment forms keep from their dynamic budget: each
# CTA's static copy of its segment's row (NT_SCAN_SEG_SMEM).
SEGMENT_SMEM = 1024
# Bytes a node of the resident rows: static (capacity, sched, util,
# bw_avail, bw_used, ports_free, node_ok) and an eval's (job_count,
# tg_count, feasible: 4 + 5 G).
STATIC_ROWS = (16, 16, 16, 4, 4, 4, 1)
# Noise rows staged ahead (NT_SCAN_STAGES), read mode.
STAGES = 4
# Mbarriers (NT_B_COUNT: an eval's rows, the noise stages, the keys).
BARRIERS = 2 + STAGES + 2
# Parts of a step in the kernel's profile (NT_P_*).
PARTS = ("wait", "asks", "score", "block", "draw", "exchange", "winner")
# The noise is drawn in the kernel where the nodes one CTA hashes a
# step (its slice, on its own SM) come to at most DRAW_FACTOR times the
# nodes K0 hashes a step on each of the card's SMs (the launch's evals'
# N over the SMs): reading also loads those values back from device
# memory, and part of the draw hides in the exchange's wait. Both modes
# timed in turns on the H100 (PERF.md §6) break even near 1.9: at 2
# CTAs an eval between B = 33 (read 1% faster) and 64 (drawn 16%
# faster), at 4 between B = 16 and 17 (equal), and at 16 reading wins
# at B = 4 (by 4%), as at B = 1 and under seq.
DRAW_FACTOR = 1.9


def _up(x: int, m: int) -> int:
    return -(-x // m) * m


def slices(n: int, ctas: int) -> List[Tuple[int, int]]:
    """(first node, nodes) of each CTA's slice, in rank order."""
    return [(r * n // ctas, (r + 1) * n // ctas - r * n // ctas)
            for r in range(ctas)]


def slice_len(n: int, ctas: int) -> int:
    """The longest slice."""
    return -(-n // ctas)


def segment_len(segments: Sequence[int], ctas: int) -> int:
    """The longest slice of ``segments`` (each shard's node count) split
    over a cluster of ``ctas`` CTAs, an equal part of it a shard."""
    w = len(segments)
    if w < 1 or ctas % w:
        raise RuntimeError(f"no cluster of {ctas} CTAs over {w} segments "
                           "(CTAs a segment times segments)")
    return max(slice_len(n, ctas // w) for n in segments)


def threads_for(length: int) -> int:
    """Threads a CTA for a slice of ``length`` nodes: every thread the
    same number of nodes, the fewest threads that give it."""
    per = max(1, -(-length // THREADS_MAX))
    return max(32, _up(-(-length // per), 32))


def draws(n: int, ctas: int, clusters: int, sms: int) -> bool:
    """Whether a launch of ``clusters`` clusters of ``ctas`` CTAs over
    N nodes draws its noise in the kernel on a card of ``sms`` SMs
    (else K0 draws it first and the scan reads it); see DRAW_FACTOR."""
    return slice_len(n, ctas) * sms <= DRAW_FACTOR * clusters * n


def stage_len(nbytes: int) -> int:
    """A staging region for ``nbytes`` of rows: the 16-byte-aligned
    superset the bulk copy moves (nt_stage_len)."""
    return _up(nbytes, 16) + 32


def layout(ctas: int, warps: int, length: int, g: int, resident: bool,
           stage_noise: bool, eval_bufs: int, cache: bool,
           bias: bool = False) -> Tuple[Dict[str, int], int]:
    """The kernel's shared memory: ({region: byte offset}, total). With
    ``bias`` (K8b) the cache keeps a strand term beside each score and
    each noise stage has a pref stage."""
    # The mbarriers (eval rows, noise, keys) and the profile's counters.
    at = _up(8 * BARRIERS + 8 * len(PARTS), 16)
    off = {"slots": at}
    at += _up(16 * (ctas + warps), 16)  # a key a CTA, a key a warp; 2 steps
    if cache:
        off["cache"] = at
        at += _up((8 if bias else 4) * length, 16)
    if stage_noise:
        for x in range(STAGES):
            off[f"noise{x}"] = at
            at += stage_len(4 * length)
        for x in range(STAGES if bias else 0):
            off[f"pref{x}"] = at
            at += stage_len(4 * length)
    if resident:
        for r, per in enumerate(STATIC_ROWS):
            off[f"row{r}"] = at
            at += stage_len(per * length)
        for x in range(eval_bufs):
            for r, per in enumerate((4, 4 * g, g)):
                off[f"eval{x}.{r}"] = at
                at += stage_len(per * length)
    return off, at


class ScanPlan(NamedTuple):
    """One launch: ``clusters`` clusters of ``ctas`` CTAs of ``threads``
    threads, slices up to ``slice`` nodes, the form, whether the noise
    is drawn in the kernel (else read from K0's tensor, staged in shared
    memory where ``stage_noise``), whether the scores before the noise
    are cached in shared memory, and the shared memory a CTA.
    ``occupancy`` is the clusters the card holds at once (so ``waves`` =
    clusters over it, rounded up). ``bias``: K8b's plan (the noise
    read, its pref and strand rows in the layout). ``segments``: the
    node shards the cluster splits into, ``ctas // segments`` CTAs
    each (1: the whole node axis, K1 and K8b)."""

    ctas: int
    threads: int
    slice: int
    resident: bool
    drawn: bool
    stage_noise: bool
    eval_bufs: int
    cache: bool
    smem: int
    clusters: int
    occupancy: int
    bias: bool = False
    segments: int = 1

    @property
    def form(self) -> str:
        return "resident" if self.resident else "streamed"

    @property
    def waves(self) -> int:
        return -(-self.clusters // self.occupancy)

    @property
    def cps(self) -> int:
        """CTAs a segment."""
        return self.ctas // self.segments


def _shape(b: int, length: int, g: int, seq: bool, ctas: int,
           resident: Optional[bool], drawn: bool, bias: bool,
           budget: int = SMEM_MAX) -> Tuple:
    """(threads, slice, resident, drawn, stage_noise, eval_bufs, cache,
    smem) at ``ctas`` for slices up to ``length`` nodes, in ``budget``
    bytes of shared memory; ``resident`` None: resident where it fits.
    Streamed, the cache comes before the read noise's stages, and each
    only where it fits."""
    threads = threads_for(length)
    warps = threads // 32
    bufs = 2 if seq and b > 1 else 1
    staged = not drawn
    smem = layout(ctas, warps, length, g, True, staged, bufs, True, bias)[1]
    if resident is not False and smem <= budget:
        return threads, length, True, drawn, staged, bufs, True, smem
    if resident:
        raise RuntimeError(
            f"greedy scan: the resident rows of {length} nodes a CTA "
            f"(G = {g}) take {smem} bytes of shared memory, over {budget}")
    for staged, cache in ((not drawn, True), (False, True), (False, False)):
        smem = layout(ctas, warps, length, g, False, staged, 0, cache,
                      bias)[1]
        if smem <= budget or not cache:
            return threads, length, False, drawn, staged, 0, cache, smem


def scan_plan(b: int, n: int, g: int, seq: bool,
              occupancy: Callable[[int, int, int, bool], int],
              ctas: Optional[int] = None,
              resident: Optional[bool] = None, sms: int = 132,
              drawn: Optional[bool] = None, bias: bool = False,
              segments: Optional[Sequence[int]] = None) -> ScanPlan:
    """The launch for B evals over N nodes and G task groups on a card
    of ``sms`` SMs. ``occupancy(ctas, threads, smem, resident)`` is the
    clusters of that shape the card holds at once (0: refused).
    ``ctas``, ``resident`` and ``drawn`` force the cluster, the form and
    the noise's mode (the tests' and the measurements' hooks); ``bias``
    plans K8b, whose noise is read. ``segments`` (the node counts of
    the shards of one card, N in all) plans the scan over them: the
    cluster ``ctas`` (given: CTAs a shard times shards), the slices
    the longest of the shards' parts, the noise read."""
    if b < 1 or n < 0 or g < 1:
        raise ValueError(f"no greedy scan of B {b}, N {n}, G {g}")
    clusters = 1 if seq else b
    if segments is not None:
        if ctas is None or not 1 <= ctas <= CLUSTER_MAX \
                or sum(segments) != n:
            raise RuntimeError(f"greedy scan: no cluster of {ctas} CTAs "
                               f"over segments {tuple(segments)} of N {n}")
        shape = _shape(b, segment_len(segments, ctas), g, seq, ctas,
                       resident, False, bias, SMEM_MAX - SEGMENT_SMEM)
        occ = occupancy(ctas, shape[0], shape[-1], shape[2])
        if occ < 1:
            raise RuntimeError(
                f"greedy scan: the card holds no cluster of {ctas} CTAs "
                f"over segments {tuple(segments)}, G {g}")
        return ScanPlan(ctas, *shape, clusters, occ, bias, len(segments))
    if ctas is not None:
        if not 1 <= ctas <= CLUSTER_MAX:
            raise RuntimeError(f"greedy scan: no cluster of {ctas} CTAs "
                               f"(1 to {CLUSTER_MAX})")
        choices = [ctas]
    else:
        choices = [c for c in (16, 8, 4, 2, 1)
                   if c <= CLUSTER_MAX and (c == 1 or c <= n)]
    fits = []
    for c in choices:
        draw = False if bias else (
            drawn if drawn is not None else draws(n, c, clusters, sms))
        shape = _shape(b, slice_len(n, c), g, seq, c, resident, draw, bias)
        occ = occupancy(c, shape[0], shape[-1], shape[2])
        if occ >= clusters:
            return ScanPlan(c, *shape, clusters, occ, bias)
        if occ >= 1:
            fits.append(ScanPlan(c, *shape, clusters, occ, bias))
    if fits:
        return fits[-1]
    raise RuntimeError(
        f"greedy scan: the card holds no cluster of {choices} CTAs for B "
        f"{b}, N {n}, G {g}")


_occupancy: Dict[Tuple, int] = {}
_plans: Dict[Tuple, object] = {}


def occupancy_of(dev, entry: str = "nt_greedy_occupancy"
                 ) -> Callable[[int, int, int, bool], int]:
    """``scan_plan``'s occupancy on ``dev``, asked once a shape, of the
    kernel whose occupancy ``entry`` answers (``nt_gang_occupancy``:
    K7's)."""
    dev = torch.device(dev)
    index = dev.index if dev.index is not None else \
        torch.cuda.current_device()

    def occ(ctas: int, threads: int, smem: int, resident: bool) -> int:
        key = (entry, index, ctas, threads, smem, resident)
        got = _occupancy.get(key)
        if got is None:
            out = ctypes.c_int(0)
            with cuda.on_device(dev):
                cuda.launch(entry, ctas, threads, smem, int(resident),
                            ctypes.byref(out))
            got = _occupancy[key] = int(out.value)
        return got

    return occ


def plan_for(dev, b: int, n: int, g: int, seq: bool,
             ctas: Optional[int] = None, resident: Optional[bool] = None,
             drawn: Optional[bool] = None, bias: bool = False,
             segments: Optional[Sequence[int]] = None) -> ScanPlan:
    """``scan_plan`` on ``dev``'s occupancy and SMs, kept a shape."""
    dev = torch.device(dev)
    segments = None if segments is None else tuple(segments)
    key = (dev.index, b, n, g, bool(seq), ctas, resident, drawn, bias,
           segments)
    plan = _plans.get(key)
    if plan is None:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        plan = _plans[key] = scan_plan(b, n, g, seq, occupancy_of(dev),
                                       ctas, resident, sms, drawn, bias,
                                       segments)
    return plan


def launch(plan: ScanPlan, static, carry, feasible, asks, draw,
           penalty: float, seq: bool,
           prof: Optional[torch.Tensor] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of the kernel on ``plan``, arguments as
    ``binpack.greedy_scan`` (``static`` its four node rows, ``carry``
    updated in place, ``draw`` the noise's ``prng.Draw``); where the
    plan reads the noise, K0 draws it first. Returns (choices, scores).
    ``prof``: None, or an int64 [len(PARTS)] that takes the step parts'
    clock cycles."""
    b, n, g = feasible.shape
    k = asks.resources.shape[1]
    dev = feasible.device
    keys = draw.keys.contiguous()
    noise = None if plan.drawn else threefry_uniform(
        keys, (k, n), 0.0, draw.scale, window=(draw.lo, draw.columns(n)))
    choices = torch.empty((b, k), dtype=torch.int32, device=dev)
    scores = torch.empty((b, k), dtype=torch.float32, device=dev)
    with cuda.on_device(dev):  # the tensors' card, whichever is current
        cuda.launch(
            "nt_greedy_scan", b, n, g, k, float(penalty), int(seq),
            int(static[0].dim() == 3), plan.ctas, plan.threads,
            int(plan.resident), int(plan.drawn), int(plan.stage_noise),
            plan.eval_bufs, int(plan.cache), plan.smem,
            *(x.data_ptr() for x in static),
            *(x.data_ptr() for x in carry), feasible.data_ptr(),
            asks.resources.data_ptr(), asks.bw.data_ptr(),
            asks.ports.data_ptr(), asks.tg_index.data_ptr(),
            asks.active.data_ptr(), asks.job_distinct_hosts.data_ptr(),
            asks.tg_distinct_hosts.data_ptr(), keys.data_ptr(),
            draw.scale32, int(draw.columns(n)), int(draw.lo),
            None if noise is None else noise.data_ptr(),
            choices.data_ptr(), scores.data_ptr(),
            None if prof is None else prof.data_ptr(), cuda.stream_ptr(dev))
    return choices, scores


def launch_round(plan: ScanPlan, static, carry, feasible, asks, noise, pref,
                 penalty: float, seq: bool,
                 prof: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of K8b (the cluster scan with the rounding bias) on a
    plan with ``bias``, arguments as ``kernels.convex.convex_round``
    (``carry`` updated in place, ``noise`` and ``pref`` [B, K, N]).
    Returns (choices, scores); ``prof`` as ``launch``'s."""
    b, n, g = feasible.shape
    k = asks.resources.shape[1]
    dev = feasible.device
    choices = torch.empty((b, k), dtype=torch.int32, device=dev)
    scores = torch.empty((b, k), dtype=torch.float32, device=dev)
    with cuda.on_device(dev):  # the tensors' card, whichever is current
        cuda.launch(
            "nt_convex_round", b, n, g, k, float(penalty), int(seq),
            int(static[0].dim() == 3), plan.ctas, plan.threads,
            int(plan.resident), int(plan.stage_noise), plan.eval_bufs,
            int(plan.cache), plan.smem, *(x.data_ptr() for x in static),
            *(x.data_ptr() for x in carry), feasible.data_ptr(),
            asks.resources.data_ptr(), asks.bw.data_ptr(),
            asks.ports.data_ptr(), asks.tg_index.data_ptr(),
            asks.active.data_ptr(), asks.job_distinct_hosts.data_ptr(),
            asks.tg_distinct_hosts.data_ptr(), noise.data_ptr(),
            pref.data_ptr(), choices.data_ptr(), scores.data_ptr(),
            None if prof is None else prof.data_ptr(), cuda.stream_ptr(dev))
    return choices, scores


def launch_segments(plan: ScanPlan, segs, asks, penalty: float, seq: bool,
                    stacked: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of the cluster scan over node segments on a plan with
    ``segments`` (K10c; K10g-b where ``plan.bias``): ``segs`` one
    (global first row, rows, (capacity, sched_capacity, bw_avail,
    node_ok, util, bw_used, ports_free, job_count, tg_count, feasible,
    noise, pref)) a shard of one card, in node order, each shard's
    carry updated in place, pref None without the bias; ``asks`` the
    batch's. Returns (choices, scores) [B, K] with global node
    indices."""
    b, k = asks.active.shape
    g = segs[0][2][9].shape[2]
    dev = asks.active.device
    dims, ptrs = cuda.table(
        [x for lo, rows, _t in segs for x in (lo, rows)],
        [None if t is None else t.data_ptr()
         for _lo, _rows, ts in segs for t in ts])
    choices = torch.empty((b, k), dtype=torch.int32, device=dev)
    scores = torch.empty((b, k), dtype=torch.float32, device=dev)
    with cuda.on_device(dev):  # the tensors' card, whichever is current
        cuda.launch(
            "nt_scan_segments", b, g, k, len(segs), plan.cps, float(penalty),
            int(seq), int(stacked), int(plan.bias), plan.threads,
            int(plan.resident), int(plan.stage_noise), plan.eval_bufs,
            int(plan.cache), plan.smem, dims, ptrs, asks.resources.data_ptr(),
            asks.bw.data_ptr(), asks.ports.data_ptr(),
            asks.tg_index.data_ptr(), asks.active.data_ptr(),
            asks.job_distinct_hosts.data_ptr(),
            asks.tg_distinct_hosts.data_ptr(), choices.data_ptr(),
            scores.data_ptr(), cuda.stream_ptr(dev))
    return choices, scores


# ------------------------------------------------------------ K7

# csrc/gang_scan.cu: bytes a node of the resident rows (capacity,
# sched, util, bw_avail, bw_used, ports_free, feas_row, job_count,
# dh_presence, topo_ids, placed); the mbarriers (NT_G_COUNT: the rows,
# the noise stages, the keys) and rank 0's control words (NT_C_WORDS).
GANG_ROWS = (16, 16, 16, 4, 4, 4, 1, 4, 4, 4, 4)
GANG_BARRIERS = 1 + STAGES + 2
GANG_WORDS = 4


def sums_groups(mode: int) -> bool:
    """Whether K7 in kernel mode ``mode`` (0 free, 1 slice, 2 spread, 3
    affinity) sums its groups' capacities: slice and spread mode do."""
    return mode in (1, 2)


def gang_layout(ctas: int, warps: int, length: int, g_pad: int,
                resident: bool, stage_noise: bool, cache: bool,
                groups: bool, capg: bool) -> Tuple[Dict[str, int], int]:
    """K7's shared memory: ({region: byte offset}, total). ``groups``:
    the group member counts (and, ``capg``, slice and spread mode, rank
    0's group sums) in shared memory."""
    at = 8 * GANG_BARRIERS + 8 * len(PARTS)
    off = {"ctl": at}
    at = _up(at + 4 * GANG_WORDS, 16)
    off["slots"] = at
    at += _up(16 * (ctas + warps), 16)  # a key a CTA, a key a warp; 2 steps
    if cache:
        off["cache"] = at
        at += _up(4 * length, 16)
    if stage_noise:
        for x in range(STAGES):
            off[f"noise{x}"] = at
            at += stage_len(4 * length)
    if resident:
        for r, per in enumerate(GANG_ROWS):
            off[f"row{r}"] = at
            at += stage_len(per * length)
    if groups:
        off["members"] = at
        at += _up(4 * g_pad, 16)
        if capg:
            off["sums"] = at
            at += _up(4 * g_pad, 16)
    return off, at


class GangPlan(NamedTuple):
    """One K7 launch: a cluster of ``ctas`` CTAs of ``threads`` threads,
    slices up to ``slice`` nodes, the rows resident or streamed, the
    noise staged, the score cache, the group counts (and sums) in shared
    memory (``groups``) or global, the shared memory a CTA, and the
    clusters the card holds at once."""

    ctas: int
    threads: int
    slice: int
    resident: bool
    stage_noise: bool
    cache: bool
    groups: bool
    smem: int
    occupancy: int
    segments: int = 1

    @property
    def form(self) -> str:
        return "resident" if self.resident else "streamed"

    @property
    def cps(self) -> int:
        """CTAs a segment."""
        return self.ctas // self.segments


def _gang_shape(length: int, g_pad: int, capg: bool, ctas: int,
                resident: Optional[bool], groups: Optional[bool],
                budget: int = SMEM_MAX) -> Tuple:
    """(threads, slice, resident, stage_noise, cache, groups, smem) at
    ``ctas`` for slices up to ``length`` nodes: the rows resident and
    the groups in shared memory where the layout fits, then the groups
    global, then the rows streamed (with the noise's stages and the
    cache each kept where they fit); ``resident`` and ``groups`` force
    one side; in ``budget`` bytes of shared memory."""
    threads = threads_for(length)
    warps = threads // 32
    for res in (True, False):
        for grp in (True, False):
            if resident not in (None, res) or groups not in (None, grp):
                continue
            tries = ((True, True),) if res else ((True, True), (False, True),
                                                 (False, False))
            for staged, cache in tries:
                smem = gang_layout(ctas, warps, length, g_pad, res, staged,
                                   cache, grp, capg)[1]
                if smem <= budget:
                    return threads, length, res, staged, cache, grp, smem
    raise RuntimeError(
        f"gang scan: no layout of {length} nodes a CTA and {g_pad} groups "
        f"(resident {resident}, groups {groups}) fits in {budget} bytes")


def gang_plan(n: int, g_pad: int, capg: bool,
              occupancy: Callable[[int, int, int, bool], int],
              ctas: Optional[int] = None, resident: Optional[bool] = None,
              groups: Optional[bool] = None,
              segments: Optional[Sequence[int]] = None) -> GangPlan:
    """K7's launch for one gang over N nodes and ``g_pad`` groups
    (``capg``: slice or spread mode, which sum the groups' capacities):
    the largest cluster (up to ``CLUSTER_MAX``, at most N CTAs) the
    card holds; ``ctas``, ``resident`` and ``groups`` force the cluster,
    the form and where the group counts live (the tests' hooks).
    ``segments`` (the node counts of the shards of one card, N in all)
    plans K10e's launch over them: the cluster ``ctas`` (given: CTAs a
    shard times shards), the slices the longest of the shards' parts."""
    if n < 0 or g_pad < 1:
        raise ValueError(f"no gang scan of N {n}, g_pad {g_pad}")
    if segments is not None:
        if ctas is None or not 1 <= ctas <= CLUSTER_MAX \
                or sum(segments) != n:
            raise RuntimeError(f"gang scan: no cluster of {ctas} CTAs over "
                               f"segments {tuple(segments)} of N {n}")
        shape = _gang_shape(segment_len(segments, ctas), g_pad, capg, ctas,
                            resident, groups, SMEM_MAX - SEGMENT_SMEM)
        occ = occupancy(ctas, shape[0], shape[-1], shape[2])
        if occ < 1:
            raise RuntimeError(f"gang scan: the card holds no cluster of "
                               f"{ctas} CTAs over segments "
                               f"{tuple(segments)}, g_pad {g_pad}")
        return GangPlan(ctas, *shape, occ, len(segments))
    if ctas is not None:
        if not 1 <= ctas <= CLUSTER_MAX:
            raise RuntimeError(f"gang scan: no cluster of {ctas} CTAs "
                               f"(1 to {CLUSTER_MAX})")
        choices = [ctas]
    else:
        choices = [c for c in (16, 8, 4, 2, 1) if c == 1 or c <= n]
    for c in choices:
        shape = _gang_shape(slice_len(n, c), g_pad, capg, c, resident,
                            groups)
        occ = occupancy(c, shape[0], shape[-1], shape[2])
        if occ >= 1:
            return GangPlan(c, *shape, occ)
    raise RuntimeError(f"gang scan: the card holds no cluster of {choices} "
                       f"CTAs for N {n}, g_pad {g_pad}")


def gang_plan_for(dev, n: int, g_pad: int, mode: int,
                  ctas: Optional[int] = None,
                  resident: Optional[bool] = None,
                  groups: Optional[bool] = None,
                  segments: Optional[Sequence[int]] = None) -> GangPlan:
    """``gang_plan`` for K7 in kernel mode ``mode`` on ``dev``'s
    occupancy of its kernel, kept a shape."""
    dev = torch.device(dev)
    capg = sums_groups(mode)
    segments = None if segments is None else tuple(segments)
    key = ("gang", dev.index, n, g_pad, capg, ctas, resident, groups,
           segments)
    plan = _plans.get(key)
    if plan is None:
        plan = _plans[key] = gang_plan(
            n, g_pad, capg, occupancy_of(dev, "nt_gang_occupancy"), ctas,
            resident, groups, segments)
    return plan


def gang_scratch(plan: GangPlan, n: int, g_pad: int,
                 capg: bool) -> Tuple[int, int, int]:
    """Floats of K7's global scratch: the group sums (slice and spread
    mode, the groups global), the CTAs' rows of member counts (the
    groups global), the member units (slice and spread mode)."""
    return (g_pad if capg and not plan.groups else 0,
            0 if plan.groups else plan.ctas * g_pad, n if capg else 0)


def _carve(parts, dev) -> Tuple[torch.Tensor, List[Optional[int]]]:
    """One float32 allocation of ``parts`` floats in all on ``dev`` and
    the pointer of each part (None for an empty one); the allocation
    lives until the launch that reads it is queued."""
    scratch = torch.empty((sum(parts),), dtype=torch.float32, device=dev)
    ptrs, at = [], 0
    for size in parts:
        ptrs.append(scratch.data_ptr() + 4 * at if size else None)
        at += size
    return scratch, ptrs


def launch_gang(plan: GangPlan, state, ask_res, ask_bw, ask_ports, active,
                noise, group_noise, mode: int, distinct_hosts: bool,
                penalty: float, placed, group_members,
                prof: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One launch of K7 on ``plan``, arguments as ``gang.gang_scan``'s
    (``state`` a GangState, its carry, ``placed`` and ``group_members``
    updated in place), ``mode`` the kernel's mode number. Returns
    (choices, scores, slice_group); ``prof`` as ``launch``'s."""
    n, k, g_pad = state.util.shape[0], active.shape[0], group_noise.shape[0]
    dev = state.capacity.device
    capg = sums_groups(mode)
    choices = torch.empty((k,), dtype=torch.int32, device=dev)
    scores = torch.empty((k,), dtype=torch.float32, device=dev)
    slice_group = torch.empty((), dtype=torch.int32, device=dev)
    scratch, ptrs = _carve(gang_scratch(plan, n, g_pad, capg), dev)
    with cuda.on_device(dev):  # the tensors' card, whichever is current
        cuda.launch(
            "nt_gang_scan", n, k, g_pad, mode, int(distinct_hosts),
            float(penalty), plan.ctas, plan.threads, int(plan.resident),
            int(plan.stage_noise), int(plan.cache), int(plan.groups),
            plan.smem, *(x.data_ptr() for x in state), ask_res.data_ptr(),
            ask_bw.data_ptr(), ask_ports.data_ptr(), active.data_ptr(),
            noise.data_ptr(), group_noise.data_ptr(), placed.data_ptr(),
            group_members.data_ptr(), choices.data_ptr(), scores.data_ptr(),
            slice_group.data_ptr(), *ptrs,
            None if prof is None else prof.data_ptr(), cuda.stream_ptr(dev))
    return choices, scores, slice_group


def launch_gang_segments(plan: GangPlan, segs, ask_res, ask_bw, ask_ports,
                         active, group_noise, mode: int,
                         distinct_hosts: bool, penalty: float
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One launch of K7's kernel over node segments on a plan with
    ``segments`` (K10e): ``segs`` one (global first row, rows,
    (capacity, sched_capacity, util, bw_avail, bw_used, ports_free,
    feas_row, job_count, dh_presence, topo_ids, noise, placed,
    group_members)) a shard of one card, in node order, its carry
    updated in place and every shard's group_members given the gang's
    counts; the rest as ``launch_gang``'s. K7's scratch, and in slice
    and spread mode over several segments a segment's partial for the
    ordered walk of the group sums."""
    k, g_pad = active.shape[0], group_noise.shape[0]
    n = sum(rows for _lo, rows, _t in segs)
    dev = active.device
    capg = sums_groups(mode)
    choices = torch.empty((k,), dtype=torch.int32, device=dev)
    scores = torch.empty((k,), dtype=torch.float32, device=dev)
    slice_group = torch.empty((), dtype=torch.int32, device=dev)
    scratch, ptrs = _carve((*gang_scratch(plan, n, g_pad, capg),
                            g_pad if capg and len(segs) > 1 else 0), dev)
    dims, seg_ptrs = cuda.table(
        [x for lo, rows, _t in segs for x in (lo, rows)],
        [t.data_ptr() for _lo, _rows, ts in segs for t in ts])
    with cuda.on_device(dev):  # the tensors' card, whichever is current
        cuda.launch(
            "nt_gang_segments", k, g_pad, mode, int(distinct_hosts),
            float(penalty), len(segs), plan.cps, plan.threads,
            int(plan.resident), int(plan.stage_noise), int(plan.cache),
            int(plan.groups), plan.smem, dims, seg_ptrs, ask_res.data_ptr(),
            ask_bw.data_ptr(), ask_ports.data_ptr(), active.data_ptr(),
            group_noise.data_ptr(), choices.data_ptr(), scores.data_ptr(),
            slice_group.data_ptr(), *ptrs, cuda.stream_ptr(dev))
    return choices, scores, slice_group


# ------------------------------------------------------------ K6

# csrc/preempt_scan.cu: bytes a node of the resident rows staged by bulk
# copies, in the kernel's order: the node rows (capacity, sched, util,
# bw_avail, bw_used, ports_free, node_ok), job_count, then tg_count and
# feasible (4 and 1 bytes a node a task group), then the victim slots'
# footprints (res 8 x 16, bw 8 x 4, ports 8 x 4); beside them two bit
# masks a node, built at load time and not staged: the live slots
# (v_ok, 8 bytes a node in device memory) and the slots below the
# eval's priority (v_prio, 32 bytes a node there).
PREEMPT_ROWS = (16, 16, 16, 4, 4, 4, 1, 4)
PREEMPT_GROUP_ROWS = (4, 1)
PREEMPT_VICTIM_ROWS = (128, 32, 32)
PREEMPT_MASKS = 2
# The mbarriers (NT_PB_COUNT: the rows, the noise stages, the keys).
PREEMPT_BARRIERS = 1 + STAGES + 2


def preempt_rows(g: int) -> Tuple[int, ...]:
    """Bytes a node of each staged resident row of K6 at G task
    groups."""
    return (*PREEMPT_ROWS, *(per * g for per in PREEMPT_GROUP_ROWS),
            *PREEMPT_VICTIM_ROWS)


def preempt_layout(ctas: int, warps: int, length: int, g: int,
                   resident: bool, stage_noise: bool,
                   cache: bool) -> Tuple[Dict[str, int], int]:
    """K6's shared memory: ({region: byte offset}, total). Two keys a
    CTA and a warp a step (the best normal fit and the best
    preemption), two cached scores a node."""
    at = _up(8 * PREEMPT_BARRIERS + 8 * len(PARTS), 16)
    off = {"slots": at}
    at += _up(32 * (ctas + warps), 16)  # two keys a CTA and a warp; 2 steps
    if cache:
        off["cache"] = at
        at += _up(8 * length, 16)
    if stage_noise:
        for x in range(STAGES):
            off[f"noise{x}"] = at
            at += stage_len(4 * length)
    if resident:
        for r, per in enumerate(preempt_rows(g)):
            off[f"row{r}"] = at
            at += stage_len(per * length)
        off["masks"] = at
        at += _up(PREEMPT_MASKS * length, 16)
    return off, at


class PreemptPlan(NamedTuple):
    """One K6 launch: a cluster of ``ctas`` CTAs of ``threads`` threads,
    slices up to ``slice`` nodes, the rows and victim slots resident or
    streamed, the noise staged, the score cache, the shared memory a CTA
    and the clusters the card holds at once."""

    ctas: int
    threads: int
    slice: int
    resident: bool
    stage_noise: bool
    cache: bool
    smem: int
    occupancy: int

    @property
    def form(self) -> str:
        return "resident" if self.resident else "streamed"


def _preempt_shape(length: int, g: int, ctas: int,
                   resident: Optional[bool]) -> Tuple:
    """(threads, slice, resident, stage_noise, cache, smem) at ``ctas``
    for slices up to ``length`` nodes: resident where the layout fits,
    else streamed with the cache and then the noise's stages kept where
    they fit; ``resident`` forces the form."""
    threads = threads_for(length)
    warps = threads // 32
    for res in (True, False):
        if resident not in (None, res):
            continue
        tries = ((True, True),) if res else ((True, True), (False, True),
                                             (False, False))
        for staged, cache in tries:
            smem = preempt_layout(ctas, warps, length, g, res, staged,
                                  cache)[1]
            if smem <= SMEM_MAX:
                return threads, length, res, staged, cache, smem
    raise RuntimeError(
        f"preemption scan: no layout of {length} nodes a CTA at G = {g} "
        f"(resident {resident}) fits in {SMEM_MAX} bytes")


def preempt_plan(n: int, g: int,
                 occupancy: Callable[[int, int, int, bool], int],
                 ctas: Optional[int] = None,
                 resident: Optional[bool] = None) -> PreemptPlan:
    """K6's launch for one eval over N nodes and G task groups: the
    largest cluster (up to ``CLUSTER_MAX``, at most N CTAs) the card
    holds; ``ctas`` and ``resident`` force the cluster and the form (the
    tests' hooks)."""
    if n < 0 or g < 1:
        raise ValueError(f"no preemption scan of N {n}, G {g}")
    if ctas is not None:
        if not 1 <= ctas <= CLUSTER_MAX:
            raise RuntimeError(f"preemption scan: no cluster of {ctas} "
                               f"CTAs (1 to {CLUSTER_MAX})")
        choices = [ctas]
    else:
        choices = [c for c in (16, 8, 4, 2, 1) if c == 1 or c <= n]
    for c in choices:
        shape = _preempt_shape(slice_len(n, c), g, c, resident)
        occ = occupancy(c, shape[0], shape[-1], shape[2])
        if occ >= 1:
            return PreemptPlan(c, *shape, occ)
    raise RuntimeError(f"preemption scan: the card holds no cluster of "
                       f"{choices} CTAs for N {n}, G {g}")


def preempt_plan_for(dev, n: int, g: int, ctas: Optional[int] = None,
                     resident: Optional[bool] = None) -> PreemptPlan:
    """``preempt_plan`` on ``dev``'s occupancy of K6's kernel, kept a
    shape."""
    dev = torch.device(dev)
    key = ("preempt", dev.index, n, g, ctas, resident)
    plan = _plans.get(key)
    if plan is None:
        plan = _plans[key] = preempt_plan(
            n, g, occupancy_of(dev, "nt_preempt_occupancy"), ctas, resident)
    return plan


def launch_preempt(plan: PreemptPlan, state, victims, vok, asks, noise,
                   eval_priority: float, penalty: float,
                   prof: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One launch of K6 on ``plan``, arguments as
    ``preempt.preempt_scan``'s (``state``'s carry and ``vok`` updated in
    place). Returns (choices, scores, n_victims); ``prof`` as
    ``launch``'s."""
    n, g = state.feasible.shape
    k = asks.resources.shape[0]
    dev = state.capacity.device
    choices, scores, counts = torch.empty(  # one allocation
        (3, k), dtype=torch.int32, device=dev).unbind()
    scores = scores.view(torch.float32)
    with cuda.on_device(dev):  # the tensors' card, whichever is current
        cuda.launch(
            "nt_preempt_scan", n, g, k, float(penalty), float(eval_priority),
            plan.ctas, plan.threads, int(plan.resident),
            int(plan.stage_noise), int(plan.cache), plan.smem,
            *(x.data_ptr() for x in state),
            *(x.data_ptr() for x in victims[:4]), vok.data_ptr(),
            *(x.data_ptr() for x in asks), noise.data_ptr(),
            choices.data_ptr(), scores.data_ptr(), counts.data_ptr(),
            None if prof is None else prof.data_ptr(), cuda.stream_ptr(dev))
    return choices, scores, counts
