#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (nomad_tpu_torch) on one NVIDIA
card: the port's main path end to end, and every kernel of that path
held against its plain PyTorch version.

    python3 chip_smoke.py [--seed N]

Phases (any failure exits non-zero and prints no result):

1. Card identity (``nvidia-smi`` name and power limit) and the kernels'
   build from the sources in nomad_tpu_torch/csrc.
2. The cluster of the north-star shape: 10,000 nodes over dc1/dc2 (node
   bucket 10,240), 5 filler allocs per node (50,000 allocs), built with
   the port's own mock from ``--seed``.
3. Evals through ``Harness.process("service-gpu", eval)``, the port's
   scheduler entry point: (a) the north-star job (dynamic ports,
   distinct_hosts, count 8); (b) a two-task-group job with 512 + 512
   asks; (c) job (b) scaled up after (a) and (b) commit. Each is
   checked against the port's host "service" scheduler on the same
   state (placed counts equal), every dense placement against the
   host's feasibility and AllocsFit checks, and the launch count of
   every kernel of the path against zero.
4. Each kernel against its plain PyTorch version on the card at
   N = 10,240, K = 1,024, G = 2, B in {1, 64}, with free ports and
   distinct_hosts that limit placement: noise bits equal; greedy and
   top-k choices and all five carried tensors equal, scores within
   1e-4; overlay outputs equal. With median CUDA-event times, the plain
   version's time, a library call's time where one PyTorch call
   computes the same function, and the least time the card could take:
   the larger of this run's bytes over the HBM rate and its operations
   over the peak rate, and for the greedy scan also the measured time
   of its chain of K block-wide argmax rounds alone.

The last two lines are the kernels' JSON record and
``{"ok": true, "device": {...}}``.

Imports nothing of JAX or of the JAX package. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import random
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet): HBM bytes/s and float32
# non-tensor FLOP/s (FMA counted as 2).
HBM_BYTES_S = 3.35e12
FP32_FLOPS = 67e12
# 32-bit integer operations: 64 INT32 lanes per SM plus the 64 lanes of
# the FMA pipe that also issue integer adds (IMAD), x 132 SMs x 1.98 GHz
# boost (Hopper architecture white paper).
INT32_OPS = 128 * 132 * 1.98e9

SCORE_TOL = 1e-4

# The north-star cluster and the kernels' widths on its main path.
N_NODES = 10_000
ALLOCS_PER_NODE = 5
BENCH_N = 10_240  # the node bucket of 10,000 nodes
BENCH_K = 1_024   # the ask bucket of eval (b)
RUNS = 20         # timed runs per kernel, after warm-up

# Bytes of one node's static row (capacity, sched_capacity, bw_avail,
# node_ok); of one carried row, read once or written back once (util,
# bw_used, ports_free, job_count; tg_count adds 4 a task group); of one
# ask (resources, bw, ports, tg_index, active).
NODE_BYTES = 16 + 16 + 4 + 1
CARRY_ROW_BYTES = 16 + 4 + 4 + 4
ASK_BYTES = 16 + 4 + 4 + 4 + 1


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def card_identity():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        timeout=60)
    line = out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""
    check(out.returncode == 0 and line, f"nvidia-smi failed: {out.stdout}")
    return line


# ---------------------------------------------------------------- cluster


def build_cluster(harness, n_nodes, allocs_per_node, seed):
    """The north-star cluster (the JAX package's bench config 4 shape):
    mock nodes over dc1/dc2, each carrying filler allocs of a modest
    seeded footprint."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.structs import consts

    rng = random.Random(seed)
    filler = mock.job()
    filler.id = "filler"
    filler.task_groups[0].tasks[0].resources.networks = []
    harness.state.upsert_job(harness.next_index(), filler)
    for i in range(n_nodes):
        node = mock.node()
        node.datacenter = ("dc1", "dc2")[i % 2]
        node.compute_class()
        harness.state.upsert_node(harness.next_index(), node)
        allocs = []
        for _ in range(allocs_per_node):
            alloc = mock.alloc()
            alloc.node_id = node.id
            alloc.job_id = filler.id
            alloc.job = filler
            alloc.desired_status = consts.ALLOC_DESIRED_RUN
            alloc.client_status = consts.ALLOC_CLIENT_RUNNING
            for tr in alloc.task_resources.values():
                tr.cpu = rng.choice((50, 100))
                tr.memory_mb = rng.choice((64, 128))
                tr.networks = []
            alloc.resources = None
            allocs.append(alloc)
        harness.state.upsert_allocs(harness.next_index(), allocs)


def north_star_job():
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.structs import Constraint, consts

    job = mock.job()
    job.id = "north-star"
    job.datacenters = ["dc1", "dc2"]
    tg = job.task_groups[0]
    tg.name = "g0"
    tg.count = 8
    tg.constraints.append(Constraint(operand=consts.CONSTRAINT_DISTINCT_HOSTS))
    return job


def two_group_job(count):
    from nomad_tpu_torch import mock

    job = mock.job()
    job.id = "two-groups"
    job.datacenters = ["dc1", "dc2"]
    tg0 = job.task_groups[0]
    tg0.count = count
    tg1 = tg0.copy()
    tg1.name = "api"
    tg1.tasks[0].resources.cpu = 250
    tg1.tasks[0].resources.memory_mb = 384
    job.task_groups = [tg0, tg1]
    return job


class _DryRunPlanner:
    """Planner for the host oracle: records the plan, commits nothing."""

    def __init__(self):
        self.plans = []

    def submit_plan(self, plan):
        from nomad_tpu_torch.structs import PlanResult

        self.plans.append(plan)
        return PlanResult(node_allocation=plan.node_allocation,
                          node_update=plan.node_update), None

    def update_eval(self, ev):
        pass

    def create_eval(self, ev):
        pass

    def reblock_eval(self, ev):
        pass


def host_oracle_count(state, ev, seed, existing):
    """Placements the port's host "service" scheduler makes for ``ev``
    on ``state`` (nothing is committed)."""
    from nomad_tpu_torch.scheduler import new_scheduler

    planner = _DryRunPlanner()
    sched = new_scheduler("service", logging.getLogger("smoke.host"),
                          state.snapshot(), planner,
                          rng=random.Random(seed))
    sched.process_eval(ev.copy())
    return sum(len(new_allocs(p, existing)) for p in planner.plans)


def new_allocs(plan, existing):
    """Allocs this plan creates: in-place updates keep their ids."""
    return [a for allocs in plan.node_allocation.values() for a in allocs
            if a.id not in existing]


def check_placements(state, job, plan):
    """Every dense placement passes the host's constraint/driver
    feasibility and AllocsFit on its node, with the plan committed."""
    from nomad_tpu_torch.scheduler.context import EvalContext
    from nomad_tpu_torch.scheduler.feasible import (
        ConstraintChecker,
        DriverChecker,
    )
    from nomad_tpu_torch.structs import Plan, allocs_fit

    snap = state.snapshot()
    ctx = EvalContext(snap, Plan())
    cons = ConstraintChecker(ctx)
    drivers = DriverChecker(ctx)
    groups = {tg.name: tg for tg in job.task_groups}
    for node_id, allocs in plan.node_allocation.items():
        node = snap.node_by_id(node_id)
        check(node is not None and node.ready(), f"node {node_id} not ready")
        for a in allocs:
            tg = groups[a.task_group]
            cs = list(job.constraints) + list(tg.constraints)
            for t in tg.tasks:
                cs.extend(t.constraints)
            cons.set_constraints([c for c in cs if c.operand != "distinct_hosts"])
            drivers.set_drivers({t.driver for t in tg.tasks})
            check(cons.feasible(node) and drivers.feasible(node),
                  f"{a.name} placed on infeasible node {node_id}")
        live = snap.allocs_by_node_terminal(node_id, False)
        fit, dim, _ = allocs_fit(node, live)
        check(fit, f"node {node_id} over capacity after the plan ({dim})")


def run_main_path(seed, torch):
    from nomad_tpu_torch.ops import cuda
    from nomad_tpu_torch.scheduler.batcher import get_batcher
    from nomad_tpu_torch.scheduler.testing import Harness
    from nomad_tpu_torch.structs import consts
    from nomad_tpu_torch.structs.eval import new_eval

    t0 = time.perf_counter()
    h = Harness(seed=seed)
    build_cluster(h, N_NODES, ALLOCS_PER_NODE, seed)
    n_allocs = len(h.state.allocs())
    print(f"cluster: {N_NODES} nodes, {n_allocs} allocs, built in "
          f"{time.perf_counter() - t0:.1f} s (host)")
    check(n_allocs == N_NODES * ALLOCS_PER_NODE, "cluster size")

    star = north_star_job()
    two = two_group_job(512)
    grown = two.copy()
    grown.task_groups[0].count = 768
    grown.task_groups[1].count = 768
    steps = [("a: north-star job (ports + distinct_hosts, count 8)", star, 8),
             ("b: two-group job, 512 + 512 asks", two, 1024),
             ("c: two-group job scaled to 768 + 768", grown, 512)]
    batcher = get_batcher()
    stats0 = batcher.stats()
    lat_ms = []
    place_us = stats0["place_us"]
    cuda.reset_launch_counts()
    for label, job, expect in steps:
        h.state.upsert_job(h.next_index(), job)
        ev = new_eval(h.state.job_by_id(job.id),
                      consts.EVAL_TRIGGER_JOB_REGISTER)
        existing = {a.id for a in h.state.allocs_by_job(job.id)}
        host_n = host_oracle_count(h.state, ev, seed, existing)
        n_plans = len(h.plans)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        h.process("service-gpu", ev)
        torch.cuda.synchronize()
        lat_ms.append((time.perf_counter() - t1) * 1000.0)
        place_ms = (batcher.stats()["place_us"] - place_us) / 1000.0
        place_us = batcher.stats()["place_us"]
        check(len(h.plans) == n_plans + 1, f"{label}: no plan submitted")
        plan = h.plans[-1]
        fresh = new_allocs(plan, existing)
        dense_n = len(fresh)
        print(f"eval {label}: placed {dense_n} (host oracle {host_n}), "
              f"{lat_ms[-1]:.1f} ms, of which {place_ms:.1f} ms in the "
              "batcher's place() (upload, kernels, copy back)")
        check(dense_n == host_n == expect,
              f"{label}: dense placed {dense_n}, host {host_n}, "
              f"expected {expect}")
        check(h.evals[-1].status == consts.EVAL_STATUS_COMPLETE,
              f"{label}: eval status {h.evals[-1].status}")
        check_placements(h.state, h.state.job_by_id(job.id), plan)
        if job is star:
            check(len({a.node_id for a in fresh}) == dense_n,
                  f"{label}: distinct_hosts violated")
    counts = cuda.launch_counts()
    stats = batcher.stats()
    delta = {k: stats[k] - stats0[k] for k in stats
             if isinstance(stats[k], int)}
    print(f"main path launches: {json.dumps(counts, sort_keys=True)}")
    print(f"batcher: {json.dumps(delta, sort_keys=True)}")
    for name in ("threefry_uniform", "greedy_scan", "uniform_topk",
                 "expand_overlay"):
        check(counts.get(name, 0) > 0, f"kernel {name} never launched on "
              "the main path")
    check(delta["fused_delta_updates"] > 0, "no fused base delta")
    total_s = sum(lat_ms) / 1000.0
    print(f"main path: {len(lat_ms)} evals, {len(lat_ms) / total_s:.2f} "
          f"evals/s, per-eval ms {[round(x, 3) for x in lat_ms]}")
    return counts, lat_ms


# ---------------------------------------------------------------- kernels


def time_cuda(torch, fn, runs, setup=None, warmup=2):
    """Median CUDA-event ms of ``fn`` over ``runs`` runs after warm-up;
    ``setup`` (not timed) runs before each."""
    for _ in range(warmup):
        if setup:
            setup()
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        if setup:
            setup()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_inputs(torch, np, n, k, g, b, seed, device):
    """A seeded state of the north-star widths, as tensors. Free ports
    (0 to 6 a node, against asks of 2) and distinct_hosts on task group
    0 (and on the whole job in every fourth eval) limit where the asks
    fit, so a wrong update of ports_free, job_count or tg_count changes
    the choices after it."""
    from nomad_tpu_torch.ops import binpack

    rng = np.random.default_rng(seed)
    cap = np.tile(np.array([[4000, 8192, 102400, 150]], np.float32), (n, 1))
    sched = cap - np.array([[100, 256, 4096, 0]], np.float32)
    util = (cap - sched) + np.stack(
        [rng.integers(0, 20, n) * 50, rng.integers(0, 20, n) * 64,
         np.zeros(n), np.zeros(n)], 1).astype(np.float32)
    ok = rng.random(n) < 0.98
    ok[N_NODES:] = False  # the bucket's padding rows
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device)
    base = dict(
        capacity=t(cap), sched_capacity=t(sched), util=t(util),
        bw_avail=t(np.full(n, 1000, np.float32)),
        bw_used=t(rng.integers(0, 10, n).astype(np.float32) * 50),
        ports_free=t(rng.integers(0, 7, n).astype(np.float32)),
        node_ok=t(ok))
    job_count = t(rng.integers(0, 2, (b, n)).astype(np.int32))
    tg_count = t(rng.integers(0, 2, (b, n, g)).astype(np.int32))
    feasible = t(rng.random((b, n, g)) < 0.9)
    res = np.array([500, 256, 300, 0], np.float32)
    asks = binpack.Asks(
        resources=t(np.tile(res, (b, k, 1))),
        bw=t(np.full((b, k), 50, np.float32)),
        ports=t(np.full((b, k), 2, np.float32)),
        tg_index=t(rng.integers(0, g, (b, k)).astype(np.int32)),
        active=t(np.ones((b, k), bool)),
        job_distinct_hosts=t(np.arange(b) % 4 == 3),
        tg_distinct_hosts=t(np.tile(np.arange(g) == 0, (b, 1))))
    uniform = asks._replace(
        tg_index=t(np.zeros((b, k), np.int32)),
        job_distinct_hosts=t(np.zeros(b, bool)),
        tg_distinct_hosts=t(np.ones((b, g), bool)))
    keys = t(rng.integers(0, 2**32, (b, 2), dtype=np.uint64)
             .astype(np.int64))
    return base, job_count, tg_count, feasible, asks, uniform, keys


CARRY_NAMES = ("util", "bw_used", "ports_free", "job_count", "tg_count")


def new_carry(torch, base, jc, tgc):
    """Per-eval copies of the shared base, as the batcher makes them."""
    b, n = jc.shape
    util = base["util"].expand(b, n, 4)
    bw, ports = (base[x].expand(b, n) for x in ("bw_used", "ports_free"))
    return tuple(x.clone(memory_format=torch.contiguous_format)
                 for x in (util, bw, ports, jc, tgc))


def check_scan(torch, label, kernel, plain):
    """A scan kernel's (choices, scores, carry) against its plain
    version's: choices and all five carried tensors equal, scores
    within SCORE_TOL. Returns the score error."""
    (ch, sc, c_k), (ch_p, sc_p, c_p) = kernel, plain
    check(torch.equal(ch, ch_p), f"{label}: choices differ")
    err = (sc - sc_p).abs().max().item()
    check(err <= SCORE_TOL, f"{label}: score error {err}")
    for name, x, y in zip(CARRY_NAMES, c_k, c_p):
        check(torch.equal(x, y), f"{label}: final {name} differs")
    return err


def rows_written(torch, choices, tg_index, n, g):
    """Distinct (eval, node) rows and (eval, node, task group) cells
    the placed asks update: what a scan must write back."""
    b, k = choices.shape
    valid = choices >= 0
    ev = torch.arange(b, device=choices.device).unsqueeze(1).expand(b, k)
    row = ev[valid].long() * n + choices[valid].long()
    cells = row * g + tg_index[valid].long()
    return torch.unique(row).numel(), torch.unique(cells).numel()


def chain_ms(torch, k, dev):
    """Median CUDA-event ms of k rounds of the greedy scan's block-wide
    argmax alone (csrc/greedy_scan.cu nt_argmax_chain): the dependent
    chain under K1's k steps, whatever its bytes and operations."""
    from nomad_tpu_torch.ops import cuda

    out = torch.empty(1, dtype=torch.int32, device=dev)
    stream = cuda.stream_ptr(dev)
    return time_cuda(torch, lambda: cuda.launch(
        "nt_argmax_chain", k, out.data_ptr(), stream), RUNS)


def bench_kernels(torch, np, seed):
    from nomad_tpu_torch.ops import binpack, prng

    dev = torch.device("cuda")
    n, k, g = BENCH_N, BENCH_K, 2
    chain = chain_ms(torch, k, dev)
    print(f"argmax chain alone, {k} rounds: {chain:.4f} ms")
    out = {}
    for b in (1, 64):
        base, jc, tgc, feas, asks, uasks, keys = kernel_inputs(
            torch, np, n, k, g, b, seed + b, dev)
        static = (base["capacity"], base["sched_capacity"], base["bw_avail"],
                  base["node_ok"])
        # ---- K0
        noise = prng.threefry_uniform(keys, (k, n), 0.0, 2.0)
        plain = prng.threefry_uniform_plain(keys, (k, n), 0.0, 2.0)
        check(torch.equal(noise.view(torch.int32), plain.view(torch.int32)),
              f"K0 bits differ from the plain version (B={b})")
        err = (noise - plain).abs().max().item()
        ms = time_cuda(torch, lambda: prng.threefry_uniform(
            keys, (k, n), 0.0, 2.0), RUNS)
        plain_ms = time_cuda(torch, lambda: prng.threefry_uniform_plain(
            keys, (k, n), 0.0, 2.0), 3, warmup=1)
        elems = b * k * n
        bytes_ = elems * 4 + b * 16
        # Instructions per element as the compiler fuses them: 20
        # rounds x (add, funnel-shift rotate, xor) + 5 key injections x 2
        # three-input adds + 2 initial adds + 6 to make the float.
        ops = elems * 78
        out.setdefault("threefry_uniform", {})[b] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms,
            **bound(bytes_, ops / INT32_OPS), library_ms=None)
        del plain
        # ---- K1
        c_k, c_p = (new_carry(torch, base, jc, tgc) for _ in range(2))
        ch, sc = binpack.greedy_scan(*static, c_k, feas, asks, noise, 10.0)
        err = check_scan(torch, f"K1 (B={b})", (ch, sc, c_k), (
            *binpack.greedy_scan_plain(*static, c_p, feas, asks, noise,
                                       10.0), c_p))
        full = ((base["ports_free"] >= 2) & (c_k[2] < 2)).sum().item()
        check(full > 0, f"K1 (B={b}): no node filled to its port limit")
        print(f"greedy_scan B={b}: {(ch >= 0).sum().item()} of {b * k} "
              f"asks placed, {full} rows filled to their port limit; "
              "choices, scores and all five carried tensors match")
        rows, cells = rows_written(torch, ch, asks.tg_index, n, g)
        box = {}
        fresh = lambda: box.__setitem__("c", new_carry(torch, base, jc, tgc))
        ms = time_cuda(torch, lambda: binpack.greedy_scan(
            *static, box["c"], feas, asks, noise, 10.0), RUNS, setup=fresh)
        plain_ms = time_cuda(torch, lambda: binpack.greedy_scan_plain(
            *static, box["c"], feas, asks, noise, 10.0), 3, warmup=1,
            setup=fresh)
        # Node rows, the carry and feasible read once, every ask and its
        # two outputs, the distinct_hosts flags, the noise, and the
        # chosen rows written back once.
        bytes_ = (n * NODE_BYTES + b * n * (CARRY_ROW_BYTES + 5 * g)
                  + b * k * (ASK_BYTES + 8) + b * (1 + g) + b * k * n * 4
                  + rows * CARRY_ROW_BYTES + cells * 4)
        flops = b * k * n * 60  # mask + BestFit-v3 (2 pow) + argmax
        out.setdefault("greedy_scan", {})[b] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms,
            **bound(bytes_, max(flops / FP32_FLOPS, chain / 1000.0)),
            library_ms=None, chain_ms=chain)
        del noise
        # ---- K2
        unoise = prng.threefry_uniform(keys, (n,), 0.0, 2.0)
        c_k, c_p = (new_carry(torch, base, jc, tgc) for _ in range(2))
        ch, sc = binpack.uniform_topk(*static, c_k, feas, uasks, unoise,
                                      10.0)
        err = check_scan(torch, f"K2 (B={b})", (ch, sc, c_k), (
            *binpack.uniform_topk_plain(*static, c_p, feas, uasks, unoise,
                                        10.0), c_p))
        rows, cells = rows_written(torch, ch, uasks.tg_index, n, g)
        ms = time_cuda(torch, lambda: binpack.uniform_topk(
            *static, box["c"], feas, uasks, unoise, 10.0), RUNS, setup=fresh)
        plain_ms = time_cuda(torch, lambda: binpack.uniform_topk_plain(
            *static, box["c"], feas, uasks, unoise, 10.0), RUNS, setup=fresh)
        score = torch.randn((b, n), device=dev)
        k_eff = min(k, n)
        lib_ms = time_cuda(torch, lambda: torch.topk(score, k_eff, dim=1),
                           RUNS)
        # Node rows; the carry with one task group's column of tg_count,
        # that column of feasible, and the noise, read once; ask 0 and
        # its two distinct_hosts flags; active and the two outputs of
        # every ask; the chosen rows written back once.
        bytes_ = (n * NODE_BYTES + b * n * (CARRY_ROW_BYTES + 4 + 1 + 4)
                  + b * (ASK_BYTES - 1 + 2) + b * k * (1 + 8)
                  + rows * CARRY_ROW_BYTES + cells * 4)
        ops = b * n * (60 + 10)  # one scoring pass + a k-selection
        out.setdefault("uniform_topk", {})[b] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms,
            **bound(bytes_, ops / FP32_FLOPS), library_ms=lib_ms)
        # ---- K3
        ov, class_ids = overlay_inputs(torch, np, n, g, b, seed, dev)
        got = binpack.expand_overlay(class_ids, ov, n)
        want = binpack.expand_overlay_plain(class_ids, ov, n)
        check(all(torch.equal(x, y) for x, y in zip(got, want)),
              f"K3 outputs differ (B={b})")
        err = max((x.long() - y.long()).abs().max().item()
                  for x, y in zip(got, want))
        ms = time_cuda(torch, lambda: binpack.expand_overlay(
            class_ids, ov, n), RUNS)
        plain_ms = time_cuda(torch, lambda: binpack.expand_overlay_plain(
            class_ids, ov, n), RUNS)
        c, p, j = ov.verdicts.shape[1], ov.patch_rows.shape[1], \
            ov.job_rows.shape[1]
        bytes_ = (n * 4 + b * (c * g + p * (4 + g) + j * 8)
                  + b * n * (g + 4 + 4 * g))
        out.setdefault("expand_overlay", {})[b] = dict(
            max_abs_err=float(err), ms=ms, plain_ms=plain_ms,
            **bound(bytes_, b * (n * g + j) / INT32_OPS), library_ms=None)
        torch.cuda.empty_cache()
    # K2 past the shared-memory limit (32,768 keys sort in global
    # scratch): the node bucket of a 20k-node cluster.
    n2 = 20_480
    base, jc, tgc, feas, _asks, uasks, keys = kernel_inputs(
        torch, np, n2, 64, g, 2, seed, dev)
    static = (base["capacity"], base["sched_capacity"], base["bw_avail"],
              base["node_ok"])
    unoise = prng.threefry_uniform(keys, (n2,), 0.0, 2.0)
    runs = []
    for fn in (binpack.uniform_topk, binpack.uniform_topk_plain):
        c = new_carry(torch, base, jc, tgc)
        runs.append((*fn(*static, c, feas, uasks, unoise, 10.0), c))
    check_scan(torch, f"K2 at N={n2} (global-scratch sort)", *runs)
    print(f"uniform_topk at N={n2} (global-scratch sort): matches")
    return out


def bound(bytes_, ops_s):
    bytes_s = bytes_ / HBM_BYTES_S
    return dict(bound_ms=max(bytes_s, ops_s) * 1000.0,
                bound_by="bytes" if bytes_s >= ops_s else "operations")


def overlay_inputs(torch, np, n, g, b, seed, device):
    """Compact overlays of the widths the main path uses: 128 classes,
    256 patch rows (padded with N), 1,024 job positions with duplicate
    rows (padded with N)."""
    from nomad_tpu_torch.ops import binpack

    rng = np.random.default_rng(seed)
    c, p, j = 128, 256, 1024
    class_ids = rng.integers(-1, 100, n).astype(np.int32)
    patch_rows = np.full((b, p), n, np.int32)
    patch_rows[:, :200] = np.stack([rng.choice(n, 200, replace=False)
                                    for _ in range(b)])
    job_rows = np.full((b, j), n, np.int32)
    job_rows[:, :900] = rng.integers(0, n, (b, 900))
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device)
    ov = binpack.CompactOverlay(
        verdicts=t(rng.random((b, c, g)) < 0.7),
        patch_rows=t(patch_rows),
        patch_vals=t(rng.random((b, p, g)) < 0.5),
        job_rows=t(job_rows),
        job_tgs=t(rng.integers(0, g, (b, j)).astype(np.int32)))
    return ov, t(class_ids)


REPLACES = {
    "threefry_uniform": ("nomad_tpu_torch/csrc/threefry.cu",
                         "nomad_tpu/ops/binpack.py:384"),
    "greedy_scan": ("nomad_tpu_torch/csrc/greedy_scan.cu",
                    "nomad_tpu/ops/binpack.py:360"),
    "uniform_topk": ("nomad_tpu_torch/csrc/uniform_topk.cu",
                     "nomad_tpu/ops/binpack.py:302"),
    "expand_overlay": ("nomad_tpu_torch/csrc/expand_overlay.cu",
                       "nomad_tpu/ops/binpack.py:533"),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    # Line-buffered: a run cut by its time limit still shows how far it got.
    sys.stdout.reconfigure(line_buffering=True)

    if not os.path.isdir(os.path.join(HERE, "nomad_tpu_torch")):
        print("chip_smoke: nomad_tpu_torch not found beside this script",
              file=sys.stderr)
        return 2
    try:
        import numpy as np
        import torch
    except ImportError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    logging.basicConfig(level=logging.WARNING)

    try:
        card = card_identity()
        kind = torch.cuda.get_device_name(0)
        print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
              f"cuda {torch.version.cuda}")

        from nomad_tpu_torch.ops import cuda

        t0 = time.perf_counter()
        cuda.library()
        info = dict(cuda.build_info)
        print(f"kernels: built in {time.perf_counter() - t0:.1f} s "
              f"(nvcc {info.get('build_s', 0.0):.1f} s, cached "
              f"{info.get('cached')})")
        log = os.path.join(os.path.dirname(info["path"]), "build.log")
        if os.path.exists(log):
            for line in open(log):
                if "registers" in line or line.startswith("=="):
                    print("  " + line.rstrip())

        counts, lat_ms = run_main_path(args.seed, torch)
        results = bench_kernels(torch, np, args.seed)
        torch.cuda.synchronize()
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1

    kernels = []
    for name, per_b in results.items():
        src, replaces = REPLACES[name]
        one = per_b[1]
        print(f"{name}: B=1 {one['ms']:.4f} ms (plain {one['plain_ms']:.4f}, "
              f"bound {one['bound_ms']:.4f} by {one['bound_by']}); B=64 "
              f"{per_b[64]['ms']:.4f} ms (plain {per_b[64]['plain_ms']:.4f}, "
              f"bound {per_b[64]['bound_ms']:.4f}); main-path launches "
              f"{counts.get(name, 0)} over {len(lat_ms)} evals")
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": counts.get(name, 0),
            **one, "b64": per_b[64],
        })
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
