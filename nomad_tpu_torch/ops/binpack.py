"""Vectorized bin-packing placement over torch tensors: the port of the
JAX package's ops/binpack.py.

One evaluation's K placements are K dependent masked-argmax steps over
the whole cluster's node rows (feasibility mask, BestFit-v3 score,
anti-affinity penalty, tie-break noise), carrying the proposed usage so
placements within an eval see each other. The data contracts are the
JAX package's: ``PlacementConfig``, ``NodeState``, ``Asks`` and
``CompactOverlay`` keep its fields and dtypes (float32 resources, int32
counts and indices, bool masks).

The batch axis is written out: every program here takes a leading B
(the JAX package's ``vmap`` and ``scan`` forms). Three layouts:

- independent evals over one shared base (the vmap form), each with
  its own copy of the carried state;
- sequential evals (``PlacementConfig.pre_resolve``, the JAX package's
  ``_overlay_seq``): the B evals run in order over ONE shared copy of
  util/bw_used/ports_free, so each sees the capacity earlier evals
  claimed; job_count/tg_count/feasible stay per eval (its own job);
- stacked full states (``batched_placement_program``): a per-eval base.

Every layout dispatches on ``PlacementConfig.kernel`` through the
kernel registry (nomad_tpu_torch/kernels): ``greedy`` is the native
scan of this module (``greedy_placement_program``), any other name
resolves to its registered program (``convex``: kernels/convex.py) and
runs in the same place with the same arguments, as the JAX package's
``placement_program`` does. The scheduler factories ``service-<k>-gpu``
pin a kernel k per scheduler (scheduler/__init__.py).

Five kernels carry the greedy path, each a wrapper that launches a CUDA
kernel (csrc/) for CUDA tensors and runs its plain PyTorch version, in
this module or ops/prng.py, for CPU tensors:

- K0 ``prng.threefry_uniform``: the tie-break noise;
- K1 ``greedy_scan``: the K-step scan (``placement_program``), in
  every layout above;
- K2 ``uniform_topk``: one scoring pass + top-k for the uniform
  distinct-hosts shape (``_uniform_topk_program``), in every layout;
- K3 ``expand_overlay``: the compact overlay's device-side expansion
  (``_expand_overlay``);
- K4 ``apply_base_delta``: the base row scatter, alone and fused into
  the compact-delta program.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as _np
import torch

from . import cuda
from .prng import threefry_uniform

# Resource dims in the dense matrices.
R_CPU, R_MEM, R_DISK, R_IOPS = 0, 1, 2, 3
NUM_RESOURCES = 4

NEG_INF = -1e30
# Shared memory one block of the top-k kernel may take for its keys
# (csrc/uniform_topk.cu); a larger node bucket sorts in global scratch.
_TOPK_SMEM_MAX = 227 * 1024


class PlacementConfig(NamedTuple):
    """Placement knobs (the JAX package's static config)."""

    anti_affinity_penalty: float  # 10 service / 5 batch (stack.go:14-18)
    # In-batch conflict pre-resolution: the batch's evals run in order
    # over one shared copy of the claimed capacity (a sequential eval
    # axis). Programs of one eval ignore it.
    pre_resolve: bool = False
    # Per-eval tie-break noise, in fitness units (see the JAX package's
    # PlacementConfig.noise_scale for why 2.0).
    noise_scale: float = 2.0
    # Uniform distinct-hosts shape: every active ask is the same task
    # group under distinct-hosts, so the K steps collapse to one scoring
    # pass + top-k (uniform_dh_flag decides it host-side).
    uniform_dh: bool = False
    # Placement kernel: "greedy" is this module's native scan; any other
    # name resolves through the kernel registry (nomad_tpu_torch/kernels)
    # and joins the batcher's shape key with the rest of the config.
    kernel: str = "greedy"


class NodeState(NamedTuple):
    """Dense per-node cluster state. All tensors share leading dim N
    (or [B, N] where a program says so)."""

    capacity: torch.Tensor  # [N, 4] f32 total node resources
    sched_capacity: torch.Tensor  # [N, 4] f32 capacity - reserved
    util: torch.Tensor  # [N, 4] f32 reserved + existing usage (carried)
    bw_avail: torch.Tensor  # [N] f32 primary-device bandwidth
    bw_used: torch.Tensor  # [N] f32 (carried)
    ports_free: torch.Tensor  # [N] f32 free dynamic-port count (carried)
    job_count: torch.Tensor  # [N] i32 this job's allocs per node (carried)
    tg_count: torch.Tensor  # [N, G] i32 per-task-group counts (carried)
    feasible: torch.Tensor  # [N, G] bool constraint feasibility
    node_ok: torch.Tensor  # [N] bool ready & real (not padding)


class Asks(NamedTuple):
    """The K placements to make, in order. Leading dim K (or [B, K])."""

    resources: torch.Tensor  # [K, 4] f32
    bw: torch.Tensor  # [K] f32
    ports: torch.Tensor  # [K] f32 dynamic-port count
    tg_index: torch.Tensor  # [K] i32 index into the G axis
    active: torch.Tensor  # [K] bool (padding rows are inactive)
    job_distinct_hosts: torch.Tensor  # [] bool
    tg_distinct_hosts: torch.Tensor  # [G] bool


class CompactOverlay(NamedTuple):
    """Per-eval overlay in its pre-expansion form (see the JAX
    package's CompactOverlay). Row arrays pad with N (out of range);
    the expansion drops out-of-range rows."""

    verdicts: torch.Tensor  # [C, G] bool per-class feasibility
    patch_rows: torch.Tensor  # [P] i32 node rows (pad = N)
    patch_vals: torch.Tensor  # [P, G] bool row feasibility
    job_rows: torch.Tensor  # [J] i32 rows of this job's allocs (pad = N)
    job_tgs: torch.Tensor  # [J] i32 their task-group indices


def make_node_state(
    capacity, sched_capacity, util, bw_avail, bw_used, ports_free,
    job_count, tg_count, feasible, node_ok,
) -> NodeState:
    """HOST-side (numpy) state; the batcher moves it to the device in
    one place."""
    f32 = _np.float32
    return NodeState(
        capacity=_np.asarray(capacity, f32),
        sched_capacity=_np.asarray(sched_capacity, f32),
        util=_np.asarray(util, f32),
        bw_avail=_np.asarray(bw_avail, f32),
        bw_used=_np.asarray(bw_used, f32),
        ports_free=_np.asarray(ports_free, f32),
        job_count=_np.asarray(job_count, _np.int32),
        tg_count=_np.asarray(tg_count, _np.int32),
        feasible=_np.asarray(feasible, bool),
        node_ok=_np.asarray(node_ok, bool),
    )


def make_asks(
    resources, bw, ports, tg_index, active, job_distinct_hosts, tg_distinct_hosts
) -> Asks:
    """HOST-side (numpy) asks — see make_node_state."""
    return Asks(
        resources=_np.asarray(resources, _np.float32),
        bw=_np.asarray(bw, _np.float32),
        ports=_np.asarray(ports, _np.float32),
        tg_index=_np.asarray(tg_index, _np.int32),
        active=_np.asarray(active, bool),
        job_distinct_hosts=_np.asarray(job_distinct_hosts, bool),
        tg_distinct_hosts=_np.asarray(tg_distinct_hosts, bool),
    )


def host_prng_key(seed: int) -> _np.ndarray:
    """A threefry key as a HOST uint32[2], the layout
    jax.random.PRNGKey(seed) yields (ops/prng.py draws from it)."""
    return _np.array([0, _np.uint32(seed & 0xFFFFFFFF)], _np.uint32)


def keys_tensor(keys, device) -> torch.Tensor:
    """uint32[B, 2] (or [2]) host keys -> int64[B, 2] on ``device``."""
    arr = _np.asarray(keys, _np.uint32).astype(_np.int64).reshape(-1, 2)
    return torch.from_numpy(arr).to(device)


def uniform_dh_flag(placements, job_dh, tg_dh) -> bool:
    """Host-side eligibility check for PlacementConfig.uniform_dh: True
    when every placement asks for the SAME task group and
    distinct-hosts applies to it (job-level, or TG-level for that
    group)."""
    if not placements:
        return False
    gi = placements[0]
    if any(p != gi for p in placements):
        return False
    return bool(job_dh) or bool(_np.asarray(tg_dh).reshape(-1)[gi])


# ------------------------------------------------------------ K4


def apply_base_delta_plain(util, bw_used, ports_free, node_ok, rows,
                           util_rows, bw_rows, ports_rows, ok_rows, lo=0):
    """The plain PyTorch version of K4 (and of its shard form, K10a): a
    copy of each mutable base array with the changed rows set; rows
    outside [lo, lo + N) drop."""
    n = util.shape[0]
    local = rows.long() - lo
    keep = (local >= 0) & (local < n)
    local = local[keep]
    out = []
    for base, vals in ((util, util_rows), (bw_used, bw_rows),
                       (ports_free, ports_rows), (node_ok, ok_rows)):
        t = base.clone()
        t[local] = vals[keep]
        out.append(t)
    return tuple(out)


def apply_base_delta(util, bw_used, ports_free, node_ok, rows,
                     util_rows, bw_rows, ports_rows, ok_rows):
    """K4: row scatter-set of the mutable base arrays.

    Replaces ``apply_base_delta`` and the copy fused into
    ``batched_placement_program_compact_delta`` (ops/binpack.py:192,607
    of the JAX package). ``rows`` [R] i32, in range; padding rows
    repeat a real row with the same value, so the duplicate writes are
    benign. The row values: util_rows [R,4] f32, bw_rows/ports_rows [R]
    f32, ok_rows [R] bool. Returns new tensors; the parent base stays
    as it was (it may still be cached).

    On the card (csrc/base_delta.cu) the bound is bytes: the four
    arrays copied (``Tensor.clone``, a plain copy) and R rows written,
    a few hundred KB at N = 10,240. One thread per (row, column) sets
    the rows.
    """
    return base_delta_rows(util, bw_used, ports_free, node_ok, rows,
                           util_rows, bw_rows, ports_rows, ok_rows, 0,
                           "base_delta")


def base_delta_rows(util, bw_used, ports_free, node_ok, rows, util_rows,
                    bw_rows, ports_rows, ok_rows, lo: int, name: str):
    """The launch behind K4 and its shard form K10a
    (parallel/shard.py): the arrays are N rows from global row ``lo``,
    ``rows`` global indices (others drop); counts one ``name`` launch
    on the card."""
    n, r = util.shape[0], rows.shape[0]
    dev = util.device
    for label, t, dtype, shape in (
            ("util", util, torch.float32, (n, 4)),
            ("bw_used", bw_used, torch.float32, (n,)),
            ("ports_free", ports_free, torch.float32, (n,)),
            ("node_ok", node_ok, torch.bool, (n,)),
            ("rows", rows, torch.int32, (r,)),
            ("util_rows", util_rows, torch.float32, (r, 4)),
            ("bw_rows", bw_rows, torch.float32, (r,)),
            ("ports_rows", ports_rows, torch.float32, (r,)),
            ("ok_rows", ok_rows, torch.bool, (r,))):
        _check(label, t, dtype, shape, dev)
    if dev.type == "cpu":
        return apply_base_delta_plain(util, bw_used, ports_free, node_ok,
                                      rows, util_rows, bw_rows, ports_rows,
                                      ok_rows, lo)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    out = tuple(x.clone() for x in (util, bw_used, ports_free, node_ok))
    cuda.launch(
        "nt_base_delta", n, r, int(lo), rows.data_ptr(),
        util_rows.data_ptr(), bw_rows.data_ptr(), ports_rows.data_ptr(),
        ok_rows.data_ptr(), *(x.data_ptr() for x in out),
        cuda.stream_ptr(dev))
    cuda.count_launch(name)
    return out


_TORCH_DTYPES = {
    _np.dtype(_np.float32): torch.float32,
    _np.dtype(_np.int32): torch.int32,
    _np.dtype(_np.int64): torch.int64,
    _np.dtype(bool): torch.bool,
}
# Byte alignment of each array in device_resident's packed buffer.
_ALIGN = 16


def device_resident(arrays, device) -> tuple:
    """Host numpy arrays as tensors on ``device``, in ONE copy.

    The counterpart of the JAX package's ``device_resident`` identity
    program (ops/binpack.py:632), the one-call base upload: the arrays
    pack into one host buffer (pinned, for a CUDA device), which
    crosses in one ``non_blocking`` copy on the device's current
    stream, the stream the kernels launch on, so they run after it.
    The tensors returned are views of that one device buffer."""
    device = torch.device(device)
    arrays = [_np.asarray(x, order="C") for x in arrays]
    offsets, total = [], 0
    for x in arrays:
        if x.dtype not in _TORCH_DTYPES:
            raise ValueError(f"device_resident: unsupported dtype {x.dtype}")
        offsets.append(total)
        total += -(-x.nbytes // _ALIGN) * _ALIGN
    host = torch.empty(max(total, _ALIGN), dtype=torch.uint8,
                       pin_memory=device.type == "cuda")
    flat = host.numpy()
    for x, at in zip(arrays, offsets):
        flat[at:at + x.nbytes] = x.reshape(-1).view(_np.uint8)
    buf = host.to(device, non_blocking=True)
    return tuple(buf[at:at + x.nbytes].view(_TORCH_DTYPES[x.dtype])
                 .view(x.shape) for x, at in zip(arrays, offsets))


# ------------------------------------------------------------ scoring


def _score_plain(capacity, sched, bw_avail, util, bw_used, ports_free,
                 job_count, tg_cnt, feas_row, ask_res, ask_bw, ask_ports,
                 job_dh, tg_dh, penalty, noise):
    """Masked BestFit-v3 score of one ask per eval over all N nodes
    (the JAX package's _score_and_mask). Batched: util [B,N,4], the
    [B,N] vectors, ask_res [B,4], the [B] ask scalars and flags, noise
    [B,N]; capacity/sched/bw_avail are the shared [N,...] base or a
    stacked [B,N,...] one."""
    new_util = util + ask_res[:, None, :]
    fits = (new_util <= capacity).all(dim=-1)
    fits &= bw_used + ask_bw[:, None] <= bw_avail
    fits &= ports_free >= ask_ports[:, None]
    fits &= feas_row
    fits &= ~job_dh[:, None] | (job_count == 0)
    fits &= ~tg_dh[:, None] | (tg_cnt == 0)
    denom = torch.clamp(sched, min=1.0)
    free_frac = 1.0 - new_util / denom
    fitness = 20.0 - (torch.pow(10.0, free_frac[..., R_CPU])
                      + torch.pow(10.0, free_frac[..., R_MEM]))
    fitness = torch.clamp(fitness, 0.0, 18.0)
    zero_cap = (sched[..., R_CPU] <= 0) | (sched[..., R_MEM] <= 0)
    fitness = torch.where(zero_cap, torch.zeros_like(fitness), fitness)
    score = fitness - penalty * job_count.to(torch.float32)
    score = score + noise
    return torch.where(fits, score, torch.full_like(score, NEG_INF))


def _check(name, t, dtype, shape, device):
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _check_scan_args(capacity, sched_capacity, bw_avail, node_ok, carry,
                     feasible, asks, noise, noise_shape, seq):
    """Validate a scan's arguments; returns (B, N, G, K, stacked).

    The static node rows (capacity, sched_capacity, bw_avail, node_ok)
    are the shared [N,...] base or, stacked, a [B,N,...] base per eval.
    The carried util/bw_used/ports_free are [B,N,...] per-eval copies
    or, with ``seq``, one shared [N,...] copy. A ``noise`` of None is
    not checked (the relaxation takes none)."""
    util, bw_used, ports_free, job_count, tg_count = carry
    b, n, g = feasible.shape
    k = asks.resources.shape[1]
    stacked = capacity.dim() == 3
    if stacked and seq:
        raise ValueError("a sequential scan runs over one shared base")
    lead = (b, n) if stacked else (n,)
    own = (n,) if seq else (b, n)
    dev = capacity.device
    f32, i32, u8 = torch.float32, torch.int32, torch.bool
    for name, t, dtype, shape in (
            ("capacity", capacity, f32, (*lead, 4)),
            ("sched_capacity", sched_capacity, f32, (*lead, 4)),
            ("bw_avail", bw_avail, f32, lead),
            ("node_ok", node_ok, u8, lead),
            ("util", util, f32, (*own, 4)),
            ("bw_used", bw_used, f32, own),
            ("ports_free", ports_free, f32, own),
            ("job_count", job_count, i32, (b, n)),
            ("tg_count", tg_count, i32, (b, n, g)),
            ("feasible", feasible, u8, (b, n, g)),
            ("asks.resources", asks.resources, f32, (b, k, 4)),
            ("asks.bw", asks.bw, f32, (b, k)),
            ("asks.ports", asks.ports, f32, (b, k)),
            ("asks.tg_index", asks.tg_index, i32, (b, k)),
            ("asks.active", asks.active, u8, (b, k)),
            ("asks.job_distinct_hosts", asks.job_distinct_hosts, u8, (b,)),
            ("asks.tg_distinct_hosts", asks.tg_distinct_hosts, u8, (b, g)),
            ("noise", noise, f32, (b, *noise_shape))):
        if t is not None:
            _check(name, t, dtype, shape, dev)
    return b, n, g, k, stacked


def _launch_name(base, seq, stacked):
    """The launch-count name of a scan kernel in one layout."""
    return base + ("_seq" if seq else "_stacked" if stacked else "")


def _in_order(fn, capacity, sched_capacity, bw_avail, node_ok, carry,
              feasible, asks, noise, penalty, *per_eval):
    """Run the plain scan ``fn`` over the B evals one at a time, in
    order, on one shared copy of util/bw_used/ports_free: each eval
    gets [1, ...] views of it, so its row updates land in the shared
    tensors the next eval reads. ``per_eval`` tensors (a leading B) are
    sliced like the noise and passed after the penalty."""
    util, bw_used, ports_free, job_count, tg_count = carry
    outs = []
    for i in range(feasible.shape[0]):
        one = slice(i, i + 1)
        own = (util[None], bw_used[None], ports_free[None],
               job_count[one], tg_count[one])
        outs.append(fn(capacity, sched_capacity, bw_avail, node_ok, own,
                       feasible[one], Asks(*(x[one] for x in asks)),
                       noise[one], penalty, *(x[one] for x in per_eval)))
    return (torch.cat([o[0] for o in outs]),
            torch.cat([o[1] for o in outs]))


def _update_rows(carry, rows_b, rows_n, ask_res, ask_bw, ask_ports, tg):
    """Add one ask to row rows_n of eval rows_b (distinct pairs)."""
    util, bw_used, ports_free, job_count, tg_count = carry
    util[rows_b, rows_n] += ask_res
    bw_used[rows_b, rows_n] += ask_bw
    ports_free[rows_b, rows_n] += -ask_ports
    job_count[rows_b, rows_n] += 1
    tg_count[rows_b, rows_n, tg] += 1


# ------------------------------------------------------------ K1


def greedy_scan_plain(capacity, sched_capacity, bw_avail, node_ok, carry,
                      feasible, asks, noise, penalty, seq=False):
    """The plain PyTorch version of K1: a Python loop over the K asks,
    each a batched [B, N] score, argmax and one-row update of the
    carried tensors (updated in place). With ``seq`` the evals run one
    after another over the shared carry (``_in_order``)."""
    if seq:
        return _in_order(greedy_scan_plain, capacity, sched_capacity,
                         bw_avail, node_ok, carry, feasible, asks, noise,
                         penalty)
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
        tg_cnt = tg_count[ar, :, tg]
        tg_dh = asks.tg_distinct_hosts[ar, tg]
        nz = noise[:, j]
        score = _score_plain(
            capacity, sched_capacity, bw_avail, util, bw_used, ports_free,
            job_count, tg_cnt, feas_row, asks.resources[:, j], asks.bw[:, j],
            asks.ports[:, j], asks.job_distinct_hosts, tg_dh, penalty, nz)
        # torch.argmax returns the first maximal index, as jnp.argmax.
        best = torch.argmax(score, dim=1)
        top = score[ar, best]
        valid = (top > NEG_INF / 2) & asks.active[:, j]
        choices[:, j] = torch.where(valid, best, -1).to(torch.int32)
        scores[:, j] = torch.where(valid, top - nz[ar, best],
                                   torch.zeros_like(top))
        vb = ar[valid]
        _update_rows(carry, vb, best[valid], asks.resources[vb, j],
                     asks.bw[vb, j], asks.ports[vb, j], tg[valid])
    return choices, scores


def greedy_scan(capacity, sched_capacity, bw_avail, node_ok, carry,
                feasible, asks, noise, penalty, seq=False):
    """K1: greedy scans of K asks over N nodes for B evals.

    Replaces ``_score_and_mask`` + ``placement_step`` scanned by
    ``placement_program`` (ops/binpack.py:214,263,360 of the JAX
    package), under each batch layout: ``_overlay_seq`` and the
    ``pre_resolve`` branch of ``_compact_batch`` (:461,548) with
    ``seq``, and the stacked states of ``batched_placement_program``
    (:424) when the static rows carry the batch axis.
    ``carry`` = (util, bw_used, ports_free, job_count [B,N], tg_count
    [B,N,G]), updated in place: util [B,N,4], bw_used/ports_free
    [B,N], the evals' private copies, or with ``seq`` one shared [N,4]
    / [N] copy that the evals claim from in order. ``feasible``
    [B,N,G] bool; ``asks`` with a leading B; ``noise`` [B,K,N].
    Returns (choices [B,K] i32, scores [B,K] f32 without the noise).

    On the card (csrc/greedy_scan.cu) the bound is the chain of K
    dependent block-wide argmaxes, not bytes: one block per eval walks
    the K steps, its threads score strided nodes, a warp-shuffle and
    shared-memory reduction picks the lowest-index best, and thread 0
    updates the chosen row before the next step's barrier. With one SM
    per eval, that SM's bandwidth and issue rate bound each step (about
    14 us at N = 10,240 on an H100; PERF.md), while extra evals of a
    batch ride other SMs nearly for free. With ``seq`` one block walks
    all B x K steps in order (the next eval reads the rows the last
    one wrote, after the same barrier), so the chain is B times longer.
    """
    b, n, g, k, stacked = _check_scan_args(
        capacity, sched_capacity, bw_avail, node_ok, carry, feasible, asks,
        noise, (asks.resources.shape[1], feasible.shape[1]), seq)
    dev = capacity.device
    if dev.type == "cpu":
        return greedy_scan_plain(capacity, sched_capacity, bw_avail, node_ok,
                                 carry, feasible, asks, noise, penalty, seq)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    choices = torch.empty((b, k), dtype=torch.int32, device=dev)
    scores = torch.empty((b, k), dtype=torch.float32, device=dev)
    util, bw_used, ports_free, job_count, tg_count = carry
    cuda.launch(
        "nt_greedy_scan", b, n, g, k, float(penalty), int(seq), int(stacked),
        capacity.data_ptr(), sched_capacity.data_ptr(), bw_avail.data_ptr(),
        node_ok.data_ptr(), util.data_ptr(), bw_used.data_ptr(),
        ports_free.data_ptr(), job_count.data_ptr(), tg_count.data_ptr(),
        feasible.data_ptr(), asks.resources.data_ptr(), asks.bw.data_ptr(),
        asks.ports.data_ptr(), asks.tg_index.data_ptr(),
        asks.active.data_ptr(), asks.job_distinct_hosts.data_ptr(),
        asks.tg_distinct_hosts.data_ptr(), noise.data_ptr(),
        choices.data_ptr(), scores.data_ptr(), cuda.stream_ptr(dev))
    cuda.count_launch(_launch_name("greedy_scan", seq, stacked))
    return choices, scores


# ------------------------------------------------------------ K2


def uniform_topk_plain(capacity, sched_capacity, bw_avail, node_ok, carry,
                       feasible, asks, noise, penalty, seq=False):
    """The plain PyTorch version of K2: one [B, N] scoring pass of ask
    0, then the first min(K, N) of a stable descending sort (lowest
    index first on ties, as lax.top_k), padded to K as unplaceable.
    With ``seq`` the evals run one after another over the shared
    carry (``_in_order``)."""
    if seq:
        return _in_order(uniform_topk_plain, capacity, sched_capacity,
                         bw_avail, node_ok, carry, feasible, asks, noise,
                         penalty)
    util, bw_used, ports_free, job_count, tg_count = carry
    b, n, _g = feasible.shape
    k = asks.resources.shape[1]
    dev = capacity.device
    ar = torch.arange(b, device=dev)
    tg = asks.tg_index[:, 0].long()
    feas_row = feasible[ar, :, tg] & node_ok
    tg_dh = asks.tg_distinct_hosts[ar, tg]
    score = _score_plain(
        capacity, sched_capacity, bw_avail, util, bw_used, ports_free,
        job_count, tg_count[ar, :, tg], feas_row, asks.resources[:, 0],
        asks.bw[:, 0], asks.ports[:, 0], asks.job_distinct_hosts, tg_dh,
        penalty, noise)
    k_eff = min(k, n)
    top, idx = torch.sort(score, dim=1, descending=True, stable=True)
    top, idx = top[:, :k_eff], idx[:, :k_eff]
    if k_eff < k:
        top = torch.cat([top, torch.full((b, k - k_eff), NEG_INF,
                                         device=dev)], dim=1)
        idx = torch.cat([idx, torch.zeros((b, k - k_eff), dtype=idx.dtype,
                                          device=dev)], dim=1)
    valid = (top > NEG_INF / 2) & asks.active
    choices = torch.where(valid, idx, -1).to(torch.int32)
    scores = torch.where(valid, top - torch.gather(noise, 1, idx),
                         torch.zeros_like(top))
    vb, vk = valid.nonzero(as_tuple=True)
    _update_rows(carry, vb, idx[vb, vk], asks.resources[vb, 0],
                 asks.bw[vb, 0], asks.ports[vb, 0], tg[vb])
    return choices, scores


def uniform_topk(capacity, sched_capacity, bw_avail, node_ok, carry,
                 feasible, asks, noise, penalty, seq=False):
    """K2: the uniform distinct-hosts placement of B evals.

    Replaces ``_uniform_topk_program`` (ops/binpack.py:302 of the JAX
    package), under the batch layouts ``greedy_scan`` takes (``seq``
    for config 4's pre-resolved storm). Arguments as ``greedy_scan``
    except noise [B, N] (one draw per node). Every active ask must be
    ask 0's task group (uniform_dh_flag).

    On the card (csrc/uniform_topk.cu) the bound is the sort's
    dependent stages, not bytes: one block per eval packs each node's
    (score, index) into a 64-bit key ordered as lax.top_k orders,
    bitonic-sorts the keys in shared memory (global scratch past the
    shared-memory limit), and updates the chosen, distinct rows. With
    ``seq`` one block runs the B evals in order, a barrier after each
    eval's row updates.
    """
    b, n, g, k, stacked = _check_scan_args(
        capacity, sched_capacity, bw_avail, node_ok, carry, feasible, asks,
        noise, (feasible.shape[1],), seq)
    dev = capacity.device
    if dev.type == "cpu":
        return uniform_topk_plain(capacity, sched_capacity, bw_avail,
                                  node_ok, carry, feasible, asks, noise,
                                  penalty, seq)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    n_pad = 1 << max(n - 1, 0).bit_length()
    scratch = None
    if n_pad * 8 > _TOPK_SMEM_MAX:
        scratch = torch.empty((1 if seq else b, n_pad), dtype=torch.int64,
                              device=dev)
    choices = torch.empty((b, k), dtype=torch.int32, device=dev)
    scores = torch.empty((b, k), dtype=torch.float32, device=dev)
    util, bw_used, ports_free, job_count, tg_count = carry
    cuda.launch(
        "nt_uniform_topk", b, n, n_pad, g, k, float(penalty), int(seq),
        int(stacked), capacity.data_ptr(), sched_capacity.data_ptr(),
        bw_avail.data_ptr(), node_ok.data_ptr(), util.data_ptr(),
        bw_used.data_ptr(), ports_free.data_ptr(), job_count.data_ptr(),
        tg_count.data_ptr(), feasible.data_ptr(), asks.resources.data_ptr(),
        asks.bw.data_ptr(), asks.ports.data_ptr(), asks.tg_index.data_ptr(),
        asks.active.data_ptr(), asks.job_distinct_hosts.data_ptr(),
        asks.tg_distinct_hosts.data_ptr(), noise.data_ptr(),
        0 if scratch is None else scratch.data_ptr(),
        choices.data_ptr(), scores.data_ptr(), cuda.stream_ptr(dev))
    cuda.count_launch(_launch_name("uniform_topk", seq, stacked))
    return choices, scores


# ------------------------------------------------------------ K3


def expand_overlay_plain(class_ids, overlays: CompactOverlay, n: int,
                         lo: int = 0):
    """The plain PyTorch version of K3. Out-of-range rows are masked
    out before the indexed writes (torch's index_put_ raises on them
    where JAX's mode="drop" drops them)."""
    b, _c, g = overlays.verdicts.shape
    dev = class_ids.device
    classed = class_ids >= 0
    cid = torch.clamp(class_ids.long(), 0, overlays.verdicts.shape[1] - 1)
    feasible = overlays.verdicts[:, cid, :] & classed[None, :, None]
    pr = overlays.patch_rows.long() - lo
    pb, pp = ((pr >= 0) & (pr < n)).nonzero(as_tuple=True)
    feasible[pb, pr[pb, pp]] = overlays.patch_vals[pb, pp]
    jr = overlays.job_rows.long() - lo
    jt = overlays.job_tgs.long()
    jb, jj = ((jr >= 0) & (jr < n)).nonzero(as_tuple=True)
    job_count = torch.zeros((b, n), dtype=torch.int32, device=dev)
    job_count.index_put_((jb, jr[jb, jj]),
                         torch.ones_like(jb, dtype=torch.int32),
                         accumulate=True)
    ok_tg = (jt[jb, jj] >= 0) & (jt[jb, jj] < g)
    tb, tj = jb[ok_tg], jj[ok_tg]
    tg_count = torch.zeros((b, n, g), dtype=torch.int32, device=dev)
    tg_count.index_put_((tb, jr[tb, tj], jt[tb, tj]),
                        torch.ones_like(tb, dtype=torch.int32),
                        accumulate=True)
    return feasible.contiguous(), job_count, tg_count


def expand_overlay(class_ids, overlays: CompactOverlay, n: int,
                   lo: int = 0):
    """K3: rebuild B evals' dense overlays from their compact form.

    Replaces ``_expand_overlay`` (ops/binpack.py:533 of the JAX
    package): feasible [B,N,G] = verdicts[class_ids] where the class
    id is >= 0, then the patch rows set; job_count [B,N] and tg_count
    [B,N,G] are scatter-adds of one at the job's alloc rows. Row N
    (the padding) drops. ``class_ids`` is the shared [N] base array;
    the overlay fields carry a leading B. With ``lo`` the outputs are
    one node shard's N rows from global row ``lo`` (class_ids its
    slice): patch and job rows are global and rebase by -lo, and rows
    outside the shard drop (parallel/mesh.py's sharded dispatch).

    On the card (csrc/expand_overlay.cu) the bound is bytes (the N x G
    writes): one block per eval gathers every node's verdict row, then
    sets the patch rows and applies the job positions with atomicAdd.
    """
    b, c, g = overlays.verdicts.shape
    p = overlays.patch_rows.shape[1]
    j = overlays.job_rows.shape[1]
    dev = class_ids.device
    for name, t, dtype, shape in (
            ("class_ids", class_ids, torch.int32, (n,)),
            ("verdicts", overlays.verdicts, torch.bool, (b, c, g)),
            ("patch_rows", overlays.patch_rows, torch.int32, (b, p)),
            ("patch_vals", overlays.patch_vals, torch.bool, (b, p, g)),
            ("job_rows", overlays.job_rows, torch.int32, (b, j)),
            ("job_tgs", overlays.job_tgs, torch.int32, (b, j))):
        _check(name, t, dtype, shape, dev)
    if dev.type == "cpu":
        return expand_overlay_plain(class_ids, overlays, n, lo)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    feasible = torch.empty((b, n, g), dtype=torch.bool, device=dev)
    job_count = torch.empty((b, n), dtype=torch.int32, device=dev)
    tg_count = torch.empty((b, n, g), dtype=torch.int32, device=dev)
    cuda.launch(
        "nt_expand_overlay", b, n, g, c, p, j, int(lo),
        class_ids.data_ptr(),
        overlays.verdicts.data_ptr(), overlays.patch_rows.data_ptr(),
        overlays.patch_vals.data_ptr(), overlays.job_rows.data_ptr(),
        overlays.job_tgs.data_ptr(), feasible.data_ptr(),
        job_count.data_ptr(), tg_count.data_ptr(), cuda.stream_ptr(dev))
    cuda.count_launch("expand_overlay")
    return feasible, job_count, tg_count


# ------------------------------------------------------------ programs


def fresh_carry(util, bw_used, ports_free, job_count, tg_count, b: int,
                seq: bool):
    """The carry a batch's scans update in place: copies of the base's
    claimed capacity (one per eval, or with ``seq`` one shared copy the
    evals claim from in order) and of the per-eval counts. The inputs
    (a cached device base, the caller's state) stay as they were."""
    n = util.shape[-2]
    dense = torch.contiguous_format
    if seq:
        claimed = (util, bw_used, ports_free)
    else:
        claimed = (util.expand(b, n, 4), bw_used.expand(b, n),
                   ports_free.expand(b, n))
    return tuple(x.clone(memory_format=dense)
                 for x in (*claimed, job_count, tg_count))


def greedy_placement_program(capacity, sched_capacity, util, bw_avail,
                             bw_used, ports_free, node_ok, job_count,
                             tg_count, feasible, asks: Asks, keys,
                             config: PlacementConfig, seq: bool = False):
    """The native ``greedy`` kernel over B evals: the carry is copied
    (``fresh_carry``), the noise is drawn (K0), and K1 or K2 runs.
    Returns (choices [B,K], scores [B,K], carry), carry = (util,
    bw_used, ports_free, job_count, tg_count) as the scan left it."""
    b, n, _g = feasible.shape
    k = asks.resources.shape[1]
    carry = fresh_carry(util, bw_used, ports_free, job_count, tg_count, b,
                        seq)
    if config.uniform_dh:
        noise = threefry_uniform(keys, (n,), 0.0, config.noise_scale)
        scan = uniform_topk
    else:
        noise = threefry_uniform(keys, (k, n), 0.0, config.noise_scale)
        scan = greedy_scan
    choices, scores = scan(
        capacity, sched_capacity, bw_avail, node_ok, carry,
        feasible.contiguous(), asks, noise, config.anti_affinity_penalty,
        seq)
    return choices, scores, carry


def _placement_batch(capacity, sched_capacity, util, bw_avail, bw_used,
                     ports_free, node_ok, job_count, tg_count, feasible,
                     asks: Asks, keys, config: PlacementConfig,
                     seq: bool = False):
    """B evals through the kernel ``config.kernel`` names (the JAX
    package's registry dispatch in placement_program): the native
    greedy program, or the registered one. Every batch layout comes
    through here."""
    if config.kernel == "greedy":
        program = greedy_placement_program
    else:
        from ..kernels import kernel_program

        program = kernel_program(config.kernel)
    return program(capacity, sched_capacity, util, bw_avail, bw_used,
                   ports_free, node_ok, job_count, tg_count, feasible, asks,
                   keys, config, seq)


def _unsqueeze(t) -> torch.Tensor:
    return t.unsqueeze(0).contiguous()


def placement_program(state: NodeState, asks: Asks, key,
                      config: PlacementConfig):
    """One eval's K placements (the JAX package's placement_program /
    placement_program_jit; ``pre_resolve`` does not apply to one eval).
    ``state`` and ``asks`` are tensors on one device; ``key`` a host
    uint32[2]. Returns (choices [K] i32, scores [K] f32, final
    NodeState)."""
    batched = Asks(*(_unsqueeze(x) for x in asks))
    keys = keys_tensor(key, state.capacity.device)
    choices, scores, carry = _placement_batch(
        state.capacity, state.sched_capacity, state.util, state.bw_avail,
        state.bw_used, state.ports_free, state.node_ok,
        _unsqueeze(state.job_count), _unsqueeze(state.tg_count),
        _unsqueeze(state.feasible), batched, keys, config)
    util, bw_used, ports_free, job_count, tg_count = (x[0] for x in carry)
    final = state._replace(util=util, bw_used=bw_used,
                           ports_free=ports_free, job_count=job_count,
                           tg_count=tg_count)
    return choices[0], scores[0], final


def batched_placement_program(states: NodeState, asks: Asks, keys,
                              config: PlacementConfig):
    """B evals over stacked full states, each with its own base (the
    JAX package's batched_placement_program, a vmap of
    placement_program; ``pre_resolve`` does not apply: the evals share
    no base). Every field carries the batch axis."""
    return _placement_batch(
        states.capacity, states.sched_capacity, states.util,
        states.bw_avail, states.bw_used, states.ports_free, states.node_ok,
        states.job_count, states.tg_count, states.feasible, asks, keys,
        config)


def batched_placement_program_shared(state: NodeState, asks: Asks, keys,
                                     config: PlacementConfig):
    """B evals of one state and one ask list that differ only in their
    keys [B, 2] (the JAX package's batched_placement_program_shared;
    independent, as its vmap)."""
    b = keys.shape[0]

    def over(x):
        return x.expand(b, *x.shape).contiguous()

    return _placement_batch(
        state.capacity, state.sched_capacity, state.util, state.bw_avail,
        state.bw_used, state.ports_free, state.node_ok,
        over(state.job_count), over(state.tg_count), over(state.feasible),
        Asks(*(over(x) for x in asks)), keys, config)


def batched_placement_program_overlay(state: NodeState, asks: Asks, keys,
                                      config: PlacementConfig):
    """B evals of different jobs over one shared base with dense
    per-eval overlays: job_count [B,N], tg_count/feasible [B,N,G] and
    the asks carry the batch axis; the other NodeState fields are the
    shared [N,...] base. With ``config.pre_resolve`` the evals run in
    order over one copy of the claimed capacity (``_overlay_seq``), and
    the carry's util/bw_used/ports_free come back [N,...]."""
    return _placement_batch(
        state.capacity, state.sched_capacity, state.util, state.bw_avail,
        state.bw_used, state.ports_free, state.node_ok, state.job_count,
        state.tg_count, state.feasible, asks, keys, config,
        seq=config.pre_resolve)


def batched_placement_program_compact(
    capacity, sched_capacity, util, bw_avail, bw_used, ports_free,
    node_ok, class_ids, overlays: CompactOverlay, asks: Asks, keys,
    config: PlacementConfig
):
    """The overlay path with the overlays expanded on the device (K3):
    the base tensors and class_ids are the cached cluster base; every
    overlay field carries the batch axis. The expansion does not depend
    on the claimed capacity, so all B overlays expand before the scan,
    ``pre_resolve`` or not."""
    n = util.shape[0]
    feasible, job_count, tg_count = expand_overlay(class_ids, overlays, n)
    return _placement_batch(capacity, sched_capacity, util, bw_avail,
                            bw_used, ports_free, node_ok, job_count,
                            tg_count, feasible, asks, keys, config,
                            seq=config.pre_resolve)


def batched_placement_program_compact_delta(
    capacity, sched_capacity, util, bw_avail, bw_used, ports_free,
    node_ok, class_ids, rows, util_rows, bw_rows, ports_rows, ok_rows,
    overlays: CompactOverlay, asks: Asks, keys, config: PlacementConfig
) -> Tuple:
    """The compact dispatch with the base delta fused in: the mutable
    base arrays come from the cached PARENT snapshot and the changed
    rows are set first (K4). Returns the batch results plus the child's
    (util, bw_used, ports_free, node_ok) for the batcher to cache: the
    base after the delta and BEFORE any placement (the scan claims from
    its own copy, so the padding rows' and the evals' claims never leak
    into the next snapshot)."""
    util2, bw2, ports2, ok2 = apply_base_delta(
        util, bw_used, ports_free, node_ok, rows, util_rows, bw_rows,
        ports_rows, ok_rows)
    choices, scores, _carry = batched_placement_program_compact(
        capacity, sched_capacity, util2, bw_avail, bw2, ports2, ok2,
        class_ids, overlays, asks, keys, config)
    return choices, scores, util2, bw2, ports2, ok2
