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
4. The eval storm, the JAX package's bench config 4 driven the way
   its executive arm drives it (bench.py bench_tpu_e2e), on a fresh
   cluster of the same shape: 4 rounds x 64 evals of config 4's job
   (one job per eval) through ``PlacementBatcher.place_cohort`` with
   pre_resolve on (the server default): rows built on a 4-thread pool
   (ClusterMatrix + asks), one cohort dispatch, finalize (port offers,
   Allocation objects) on a 4-thread pool, and the round's plans
   committed, so each later round's base is a delta of the last (K4,
   fused into the dispatch). Prints evals/s, per-eval p50/p99, the
   batcher's dispatches, occupancy and stack/issue/sync times; checks
   with bench.py's applier-style replay that no eval conflicts, holds
   one round against the same cohort through a CPU batcher (the plain
   versions), and counts conflicts of one round with pre_resolve off.
   Then a greedy storm (16 evals of a 512 + 512 two-group job, K1 in
   sequential mode), a parked storm (64 threads calling ``place()``
   after ``add_cohort(64)``), and token-less cohorts that take the
   stacked-state path (K1 and K2 with a base per eval), each checked.
5. Preemption on a red cluster of the same size: four filler jobs at
   priorities 10-40 hold five allocs on each node (footprints from
   ``--seed``), leaving room for the high job's ask on 256 nodes only.
   A priority-70 job (config 4's task, distinct_hosts, count 1,024)
   runs through ``service-gpu`` with preemption on and a red pressure
   probe: all 1,024 placed, 256 by the main pass and 768 through K6;
   each victim staged once, below priority 70, and on every node the
   lowest-priority-first prefix the host oracle
   (``migrate.select_victims_host``) picks; the plan commits and the
   preempted filler jobs get follow-up evals. The same eval with
   preemption off leaves 768 unplaced. K6 is held against its plain
   version on the scheduler's own inputs, and ``build_victims``' host
   time is printed.
6. Gangs on the same size with node meta ``rack`` (250 racks of 40,
   g_pad 256) and ``ici`` (625 groups of 16, g_pad 1,024), through
   ``service-gpu``: a rack slice and an ici slice at K = 64, a rack
   spread at K = 512, ici affinity at K = 128, a free gang under
   distinct_hosts at K = 1,024, and a rack slice under distinct_hosts
   at K = 64 (larger than any rack); then, on a cluster of the same
   size without topology meta (every node its own group, g_pad
   10,240), a free gang and a rack spread at K = 512 and rack affinity
   at K = 128. Each gang is all K or none; a slice lies in the
   tightest covering group; the spread cap holds; distinct_hosts
   holds; the plan's gang leg lists every member; the rejected gang
   records one failure with K-1 coalesced. K7 is held against its
   plain version on each gang's own call (every output and the final
   carry).
7. Each kernel against its plain PyTorch version on the card at the
   main path's widths, with free ports and distinct_hosts that limit
   placement: noise bits equal; greedy and top-k choices and all five
   carried tensors equal, scores within 1e-4; overlay outputs and base
   deltas equal. K0-K3 at N = 10,240, K = 1,024, G = 2, B in {1, 64};
   the sequential scans at B = 4 x K = 1,024 and B = 64 x K = 64 (K1)
   and B = 64 x K = 8 (K2); the stacked scans at B = 4; K4 at R = 256
   and 4,096; K6 on phase 5's own call (K = 1,024) and its first 8
   asks (choices, victim counts, the carry and the victim mask equal);
   K7 on phase 6's own calls: the free gang (K = 1,024, g_pad = 256),
   the ici slice (K = 64, g_pad = 1,024) and the spread without meta
   (K = 512, g_pad = 10,240); K8a and K8b on phase 8's own calls (the
   512 + 512 eval, B = 1 x K = 1,024: the batcher pads no registered
   kernel's batch, and all 64 evals of the convex storm, K = 8 under
   seq; K8a's full launch gives the path's pref bit for bit; K8b fed
   the plain relaxation's pref: choices and carry equal) and K9 on the
   four defrag solves (K = 512 x N = 10,240 cold and warm, and over
   node classes). K8a and K9 outputs are held to RELAX_TOLS: logits
   within 1e-4 relative to max(1, |logit|), x within 1e-3 of its row's
   largest entry, pref within 1e-3; or, where float32 rounding moves
   the plain version itself (the relaxation can be chaotic), within
   10x the plain version's own distance from its float64 run, a bound
   that must stay under 0.1.
   With median CUDA-event times, the plain version's time (fewer runs
   for the slow plain scans: the count is in each record), a library
   call's time where one PyTorch call computes the same function, and
   the least time the card could take: the larger of this run's bytes
   over the HBM rate and its operations over the peak rate, and for
   the scans also the measured time of their chain of block-wide
   argmax rounds alone. On phase 9's calls: K10a-K10d, then K10e (the
   gang programs: outputs and every shard's carry), K10f (the defrag
   solves) and K10g-a (the 512 + 512 eval and all 64 storm evals) to
   RELAX_TOLS as K8a and K9, and K10g-b (choices and carry equal its
   plain version's, and K8b's on the whole node axis fed the same
   pref).

8. The convex kernel and the defrag solve (they run before phase 7's
   holds, which use their recorded calls): (a) config 4's job and the
   512 + 512 job through ``service-convex-gpu`` on phase 3's cluster,
   each placed as the host oracle places it and checked as phase 3's,
   with a greedy arm (``service-greedy-gpu``, nothing committed) on the
   same state; (e) the quality board's fragmentation and bin-pack
   medians of both arms; (b) a convex storm: 64 evals of config 4's job
   through ``place_cohort`` with pre_resolve on phase 4's cluster (K8
   eval by eval on one stream), 0 conflicts, all placed; (c) the oracle
   differential rig on the card: convex, greedy, gangs, defrag waves;
   (d) ``compute_defrag_plan`` at full width on a fragmented layout of
   10,000 nodes (phase 3's cluster has nothing to move): cold and warm
   at K = 512 x N = 10,240, then over node classes; fragmentation never
   rises; the moves become wave evals through ``service-gpu`` and every
   plan passes ``judge_migration_plan``.
9. The node-sharded mesh path on 4 shards (slices of cuda:0 on one
   card, the cards round-robin on two or more): after a warm-up round,
   2 rounds x 64 evals of config 4's job through a mesh batcher's
   ``place_cohort`` with pre_resolve on phase 4's cluster (K0 and K3 a
   shard, K10d; round 2's base a K10a delta child of round 1's), plans,
   choices and scores identical to the unsharded batcher's on the same
   rows; the 512 + 512 eval through K10c (B = 1: a sharded base runs
   the live rows only), equal to K1's; K10b over one-node groups
   (g_pad 10,240) and racks of 40 (g_pad 256), equal to the one-device
   node-order sum. Then the last three node-sharded programs on the
   same mesh: config 4's job and the 512 + 512 job through
   ``service-convex-gpu`` on a mesh batcher on phase 3's cluster (K0 and
   K3 a shard, K10g-a's relaxation with its cross-shard softmax and
   maxima, K10g-b's rounding over the shards), each placed as the host
   oracle places it and checked as phase 8's, its pref within 5e-3 of
   the unsharded convex eval's on the same state and key (or, where
   float32 drifts, held by the float64 run) and the number of
   placements that differ from that eval's printed; a 64-eval convex
   storm through the mesh batcher's ``place_cohort`` with pre_resolve
   (0 conflicts, all placed); ``compute_defrag_plan(..., mesh=)`` on
   phase 8's fragmented layout, cold then warm at K = 512 x N = 10,240
   (K10f; fragmentation never rises, the warm plan's moves pass
   ``judge_migration_plan``); and phase 6's free gang, ici slice and
   meta-less spread through ``shard_gang_inputs`` + ``gang_placement``
   (K10e, with K10b's group sums), equal to K7's choices, scores and
   slice group on the same call. Phase 7 holds K10a-K10g against their
   plain versions on these calls, with each record's launches a call
   read from the launch counts around one call.

Every path of phases 3 to 6, 8 and 9 runs with the launch counts set to 0
just before it and read just after, and fails if a kernel of that path
was never launched.

The last two lines are the kernels' JSON record and
``{"ok": true, "device": {...}}``.

Imports nothing of JAX or of the JAX package. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import logging
import os
import random
import statistics
import subprocess
import sys
import time
from collections import Counter
from typing import NamedTuple

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


def build_cluster(harness, n_nodes, allocs_per_node, seed, meta=None):
    """The north-star cluster (the JAX package's bench config 4 shape):
    mock nodes over dc1/dc2, each carrying filler allocs of a modest
    seeded footprint. ``meta(node, i)``, if given, sets node meta
    before the node's class is computed."""
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
        if meta is not None:
            meta(node, i)
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
    place_us = dispatch_us(stats0)
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
        place_ms = (dispatch_us(batcher.stats()) - place_us) / 1000.0
        place_us = dispatch_us(batcher.stats())
        check(len(h.plans) == n_plans + 1, f"{label}: no plan submitted")
        plan = h.plans[-1]
        fresh = new_allocs(plan, existing)
        dense_n = len(fresh)
        print(f"eval {label}: placed {dense_n} (host oracle {host_n}), "
              f"{lat_ms[-1]:.1f} ms, of which {place_ms:.1f} ms in the "
              "batcher's dispatch (uploads, kernels, copy back)")
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
    delta = stats_delta(stats0, stats)
    print(f"main path launches: {json.dumps(counts, sort_keys=True)}")
    print(f"batcher: {json.dumps(delta, sort_keys=True)}")
    require_launches(counts, "main path", (
        "threefry_uniform", "greedy_scan", "uniform_topk", "expand_overlay",
        "base_delta"))
    check(delta["fused_delta_updates"] > 0, "no fused base delta")
    total_s = sum(lat_ms) / 1000.0
    print(f"main path: {len(lat_ms)} evals, {len(lat_ms) / total_s:.2f} "
          f"evals/s, per-eval ms {[round(x, 3) for x in lat_ms]}")
    return counts, lat_ms, h


def dispatch_us(stats):
    """Batcher time in dispatches: base uploads, stacking and payload
    upload, kernel issue, and the copy back that waits for the card."""
    return sum(stats[k] for k in ("upload_us", "stack_us", "issue_us",
                                  "sync_us"))


def stats_delta(before, after):
    return {k: after[k] - before[k] for k in after
            if isinstance(after[k], int) and isinstance(before.get(k), int)}


def require_launches(counts, label, names):
    for name in names:
        check(counts.get(name, 0) > 0,
              f"kernel {name} never launched on {label}")


# ---------------------------------------------------------------- storm

STORM_ROUNDS = 4
STORM_BATCH = 64
STORM_THREADS = 4
GREEDY_STORM_BATCH = 16


def storm_job(job_id, count=8):
    """Config 4's job (bench.py service_job(networks=True,
    distinct_hosts=True), count 8) under its own id: a storm's evals are
    registrations of distinct jobs."""
    job = north_star_job()
    job.id = job_id
    job.task_groups[0].count = count
    return job


def tg_cycle_of(job):
    return [gi for gi, tg in enumerate(job.task_groups)
            for _ in range(tg.count)]


def placement_config(job, matrix, pre_resolve, kernel=None):
    """The config the dense scheduler builds for ``job``
    (scheduler/tpu.py build_placement_config)."""
    from nomad_tpu_torch.scheduler.tpu import build_placement_config

    tgs = tg_cycle_of(job)
    return build_placement_config(False, pre_resolve, kernel, tgs,
                                  matrix.build_asks(tgs))


class GcPauses:
    """Python's garbage-collector pauses while the block runs (a host
    cost on the storm path: the store holds ~10^5 objects)."""

    def __enter__(self):
        import gc

        self.pauses = []
        self._start = 0.0
        gc.callbacks.append(self._callback)
        return self

    def _callback(self, phase, info):
        if phase == "start":
            self._start = time.perf_counter()
        else:
            self.pauses.append((info["generation"],
                                time.perf_counter() - self._start))

    def __exit__(self, *exc):
        import gc

        gc.callbacks.remove(self._callback)

    def summary(self):
        gen2 = [t for g, t in self.pauses if g == 2]
        return dict(gc_collections=len(self.pauses),
                    gc_gen2_collections=len(gen2),
                    gc_total_ms=sum(t for _g, t in self.pauses) * 1000.0,
                    gc_max_pause_ms=max((t for _g, t in self.pauses),
                                        default=0.0) * 1000.0)


class Storm:
    """bench.py bench_tpu_e2e's executive arm on the port: rows built on
    a small pool, one cohort dispatch, finalize on a second pool."""

    def __init__(self, harness, batcher, threads=STORM_THREADS):
        from concurrent.futures import ThreadPoolExecutor

        self.h = harness
        self.batcher = batcher
        self.pool = ThreadPoolExecutor(max_workers=threads)
        self.finalize_pool = ThreadPoolExecutor(max_workers=threads)

    def close(self):
        self.pool.shutdown(wait=True)
        self.finalize_pool.shutdown(wait=True)

    def jobs(self, prefix, n, make):
        out = []
        for i in range(n):
            job = make(f"{prefix}-{i}")
            self.h.state.upsert_job(self.h.next_index(), job)
            out.append(self.h.state.job_by_id(job.id))
        return out

    def build_row(self, snap, job, seed):
        from nomad_tpu_torch.models.matrix import ClusterMatrix
        from nomad_tpu_torch.ops.binpack import host_prng_key, make_asks

        matrix = ClusterMatrix(snap, job)
        asks = make_asks(*matrix.build_asks(tg_cycle_of(job)))
        return job, seed, matrix, asks, host_prng_key(seed)

    def materialize(self, row, choices, scores):
        """Port offers and Allocation objects for one row's choices
        (bench.py's materialize). Returns the eval's plan."""
        from types import SimpleNamespace

        from nomad_tpu_torch.scheduler.tpu import (
            _build_allocation,
            _offer_networks,
        )
        from nomad_tpu_torch.scheduler.util import AllocTuple
        from nomad_tpu_torch.structs import AllocMetric, Plan

        job, seed, matrix, _asks, _key = row
        rng = random.Random(seed)
        stub = SimpleNamespace(eval=SimpleNamespace(id=f"storm-{seed}"),
                               job=job)
        plan = Plan(job=job)
        net_indexes = {}
        for j, gi in enumerate(tg_cycle_of(job)):
            tg = job.task_groups[gi]
            choice = int(choices[j])
            if not 0 <= choice < matrix.n_real:
                continue
            node = matrix.nodes[choice]
            metrics = AllocMetric()
            metrics.nodes_evaluated = matrix.n_real
            metrics.nodes_available = matrix.nodes_by_dc
            metrics.score_node(node, "binpack", float(scores[j]))
            missing = AllocTuple(name=f"{job.id}.{tg.name}[{j}]",
                                 task_group=tg, alloc=None)
            resources = _offer_networks(rng, missing, node, net_indexes,
                                        matrix)
            if resources is None:
                continue
            plan.append_alloc(_build_allocation(stub, missing, node,
                                                resources, metrics))
        return plan

    def round(self, jobs, seed, config_of):
        """One round: returns (rows, [(choices, scores)], [plan],
        [per-eval seconds from round open], round seconds)."""
        t0 = time.perf_counter()
        snap = self.h.state.snapshot()
        rows = [f.result() for f in [
            self.pool.submit(self.build_row, snap, job, seed + i)
            for i, job in enumerate(jobs)]]
        results = self.batcher.place_cohort([
            (m, a, k, config_of(job, m)) for job, _s, m, a, k in rows])

        def finalize(row, res):
            plan = self.materialize(row, *res)
            return plan, time.perf_counter() - t0

        done = [f.result() for f in [
            self.finalize_pool.submit(finalize, row, res)
            for row, res in zip(rows, results)]]
        return (rows, results, [p for p, _t in done], [t for _p, t in done],
                time.perf_counter() - t0)

    def commit(self, plans):
        """All of a round's allocations in one store write: the next
        snapshot's base is a delta child of this round's."""
        allocs = []
        for plan in plans:
            for per_node in plan.node_allocation.values():
                for a in per_node:
                    a.job = plan.job
                    allocs.append(a)
        self.h.state.upsert_allocs(self.h.next_index(), allocs)
        return len(allocs)


def conflicted_evals(rows, results):
    """bench.py's verify_round: the round's placements replayed in order
    against shared claimed capacity (AllocsFit, bandwidth, ports) on the
    round's own base; an eval with a rejected placement would replan.
    distinct_hosts is per eval (distinct jobs) and out of scope."""
    import numpy as np

    vm = rows[0][2]
    res, bw, ports = vm.build_asks(tg_cycle_of(rows[0][0]))[:3]
    claimed_util = np.zeros_like(vm.util)
    claimed_bw = np.zeros_like(vm.bw_used)
    claimed_ports = np.zeros_like(vm.ports_free)
    conflicted = 0
    for row, (choices, _scores) in zip(rows, results):
        bad = False
        for j in range(len(tg_cycle_of(row[0]))):
            c = int(choices[j])
            if not 0 <= c < vm.n_real:
                continue
            ok = (np.all(vm.util[c] + claimed_util[c] + res[j]
                         <= vm.capacity[c])
                  and vm.bw_used[c] + claimed_bw[c] + bw[j] <= vm.bw_avail[c]
                  and vm.ports_free[c] - claimed_ports[c] >= ports[j])
            if not ok:
                bad = True
                continue
            claimed_util[c] += res[j]
            claimed_bw[c] += bw[j]
            claimed_ports[c] += ports[j]
        conflicted += bad
    return conflicted


def hold_against_cpu(label, rows, results, config_of):
    """The same cohort through a CPU batcher (the plain versions):
    choices equal, scores within SCORE_TOL. Returns the score error."""
    import numpy as np

    from nomad_tpu_torch.scheduler.batcher import PlacementBatcher

    cpu = PlacementBatcher("cpu").place_cohort([
        (m, a, k, config_of(job, m)) for job, _s, m, a, k in rows])
    err = 0.0
    for (c, s), (c_cpu, s_cpu) in zip(results, cpu):
        check(np.array_equal(c, c_cpu), f"{label}: choices differ from "
              "the CPU batcher's")
        err = max(err, float(np.abs(s - s_cpu).max()))
    check(err <= SCORE_TOL, f"{label}: score error {err} against the CPU")
    return err


def counted(total, label, names, fn):
    """Run one path with the launch counts set to 0 just before it and
    read just after; fail if a kernel of the path never launched."""
    from nomad_tpu_torch.ops import cuda

    cuda.reset_launch_counts()
    out = fn()
    counts = cuda.launch_counts()
    print(f"{label} launches: {json.dumps(counts, sort_keys=True)}")
    require_launches(counts, label, names)
    total.update(counts)
    return out


def run_storm(seed, torch, total):
    """Phase 4 (see the module docstring). Adds each path's launch
    counts to ``total``; returns the storm's figures."""
    import numpy as np

    from nomad_tpu_torch.scheduler.batcher import get_batcher
    from nomad_tpu_torch.scheduler.testing import Harness

    t0 = time.perf_counter()
    h = Harness(seed=seed + 1)
    build_cluster(h, N_NODES, ALLOCS_PER_NODE, seed + 1)
    print(f"storm cluster: {N_NODES} nodes, {len(h.state.allocs())} allocs,"
          f" built in {time.perf_counter() - t0:.1f} s (host)")
    batcher = get_batcher()
    storm = Storm(h, batcher)
    on = lambda job, m: placement_config(job, m, True)  # noqa: E731
    off = lambda job, m: placement_config(job, m, False)  # noqa: E731
    figures = {}
    try:
        # Warm-up round on the first snapshot, not committed.
        storm.round(storm.jobs("warm", STORM_BATCH, storm_job), 50_000, on)
        rounds = [storm.jobs(f"storm{r}", STORM_BATCH, storm_job)
                  for r in range(STORM_ROUNDS)]
        stats0 = batcher.stats()

        def config4():
            out = []
            for r, jobs in enumerate(rounds):
                out.append(storm.round(jobs, 60_000 + r * STORM_BATCH, on))
                storm.commit(out[-1][2])
            return out

        with GcPauses() as gc_pauses:
            done = counted(total, "config 4 storm", (
                "threefry_uniform", "uniform_topk_seq", "expand_overlay",
                "base_delta"), config4)
        stats = stats_delta(stats0, batcher.stats())
        lat = [t for r in done for t in r[3]]
        wall = sum(r[4] for r in done)
        placed = sum(len(a) for r in done for p in r[2]
                     for a in p.node_allocation.values())
        conflicted = sum(conflicted_evals(r[0], r[1]) for r in done)
        n_evals = STORM_ROUNDS * STORM_BATCH
        figures.update(
            evals=n_evals, evals_per_s=n_evals / wall,
            p50_ms=float(np.percentile(lat, 50)) * 1000.0,
            p99_ms=float(np.percentile(lat, 99)) * 1000.0,
            dispatches=stats["dispatches"],
            occupancy=stats["batched_requests"] / max(stats["dispatches"], 1),
            stack_ms=stats["stack_us"] / 1000.0,
            issue_ms=stats["issue_us"] / 1000.0,
            sync_ms=stats["sync_us"] / 1000.0,
            upload_ms=stats["upload_us"] / 1000.0,
            fused_delta_updates=stats["fused_delta_updates"],
            placed=placed, conflicted_pre_resolve=conflicted)
        print(f"config 4 storm: {n_evals} evals in {wall:.3f} s = "
              f"{figures['evals_per_s']:.2f} evals/s; per-eval p50 "
              f"{figures['p50_ms']:.2f} ms, p99 {figures['p99_ms']:.2f} ms; "
              f"{stats['dispatches']} dispatches, occupancy "
              f"{figures['occupancy']:.1f}; stack {figures['stack_ms']:.1f} "
              f"ms, issue {figures['issue_ms']:.1f} ms, sync "
              f"{figures['sync_ms']:.1f} ms, base uploads "
              f"{figures['upload_ms']:.1f} ms over the {STORM_ROUNDS} rounds;"
              f" {placed} allocs placed; conflicted evals with pre_resolve "
              f"on: {conflicted}")
        figures.update(gc_pauses.summary())
        print(f"  garbage collection in those rounds: "
              f"{json.dumps(gc_pauses.summary(), sort_keys=True)}")
        for r, (_rows, _res, _plans, lat_r, wall_r) in enumerate(done):
            print(f"  round {r}: {wall_r * 1000:.1f} ms, per-eval p50 "
                  f"{np.percentile(lat_r, 50) * 1000:.1f} ms, max "
                  f"{max(lat_r) * 1000:.1f} ms")
        check_placed("config 4 storm", [x for r in done for x in r[1]],
                     placed, n_evals * 8)
        check(conflicted == 0, f"{conflicted} conflicted evals with "
              "pre_resolve on")
        check(stats["pre_resolve_dispatches"] == stats["dispatches"]
              == STORM_ROUNDS, f"storm dispatches: {stats}")
        check(stats["fused_delta_updates"] == STORM_ROUNDS - 1,
              "storm rounds after the first did not fuse their base delta")
        figures.update(device_share(
            torch, lambda: storm.round(
                storm.jobs("profiled", STORM_BATCH, storm_job), 75_000, on)))
        # Round 2 (a fused-delta round) against the plain versions.
        err = hold_against_cpu("config 4 round 2", done[1][0], done[1][1],
                               on)
        print(f"config 4 round 2 through a CPU batcher (plain versions): "
              f"choices equal, max score error {err:.3g}")
        figures["cpu_score_err"] = err

        def pre_resolve_off():
            rows, results, _p, _l, _w = storm.round(
                storm.jobs("off", STORM_BATCH, storm_job), 70_000, off)
            return conflicted_evals(rows, results)

        figures["conflicted_pre_resolve_off"] = counted(
            total, "config 4 round, pre_resolve off",
            ("threefry_uniform", "uniform_topk"), pre_resolve_off)
        print("config 4 round with pre_resolve off: conflicted evals "
              f"{figures['conflicted_pre_resolve_off']} of {STORM_BATCH}")

        def greedy():
            jobs = storm.jobs("greedy", GREEDY_STORM_BATCH,
                              lambda i: two_group_job_id(i, 512))
            s0 = batcher.stats()
            rows, results, plans, _lat, wall = storm.round(jobs, 80_000, on)
            return rows, results, plans, wall, stats_delta(
                s0, batcher.stats())

        rows, results, plans, wall, st = counted(
            total, "greedy storm",
            ("threefry_uniform", "greedy_scan_seq", "expand_overlay"), greedy)
        placed = sum(len(a) for p in plans for a in p.node_allocation.values())
        conflicted = conflicted_evals(rows, results)
        print(f"greedy storm: {GREEDY_STORM_BATCH} evals x 1,024 asks in "
              f"{wall:.3f} s, {st['dispatches']} dispatch(es), issue "
              f"{st['issue_us'] / 1000:.1f} ms, sync "
              f"{st['sync_us'] / 1000:.1f} ms; {placed} placed; "
              f"conflicted evals with pre_resolve on: {conflicted}")
        check_placed("greedy storm", results, placed,
                     GREEDY_STORM_BATCH * 1024)
        check(conflicted == 0, f"greedy storm: {conflicted} conflicted evals")
        figures.update(greedy_wall_s=wall, greedy_conflicted=conflicted)

        def parked():
            import threading

            jobs = storm.jobs("parked", STORM_BATCH, storm_job)
            snap = h.state.snapshot()
            s0 = batcher.stats()
            answers, errors = {}, []

            def worker(i):
                try:
                    job, _s, m, a, k = storm.build_row(snap, jobs[i],
                                                       90_000 + i)
                    answers[i] = batcher.place(m, a, k, on(job, m))
                except Exception as e:  # noqa: BLE001 - reported below
                    errors.append(e)

            batcher.add_cohort(STORM_BATCH)
            threads = [threading.Thread(target=worker, args=(i,))
                       for i in range(STORM_BATCH)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(120)
            check(not errors, f"parked storm: {errors[:1]}")
            check(len(answers) == STORM_BATCH and all(
                np.shape(c) == (8,) for c, _s in answers.values()),
                "parked storm: a request went unanswered")
            return stats_delta(s0, batcher.stats())

        st = counted(total, "parked storm",
                     ("threefry_uniform", "uniform_topk_seq"), parked)
        occupancy = st["batched_requests"] / max(st["dispatches"], 1)
        print(f"parked storm: {STORM_BATCH} place() calls answered in "
              f"{st['dispatches']} dispatch(es), occupancy {occupancy:.1f}")
        check(occupancy > 1, f"parked storm occupancy {occupancy}")
        figures["parked_occupancy"] = occupancy

        def stacked():
            # Token-less matrices: the batcher stacks full states, one
            # base per eval (batched_placement_program).
            out = []
            for label, make, pre in (
                    ("config 4 job", storm_job, 60),
                    ("two-group job", lambda i: two_group_job_id(i, 512),
                     61)):
                jobs = storm.jobs(f"stacked{pre}", 4, make)
                snap = h.state.snapshot()
                rows = []
                for i, job in enumerate(jobs):
                    row = storm.build_row(snap, job, pre * 1000 + i)
                    row[2].base_token = row[2].base_delta = None
                    row[2].compact_overlay = None
                    rows.append(row)
                results = batcher.place_cohort([
                    (m, a, k, on(job, m)) for job, _s, m, a, k in rows])
                out.append((label, rows, results))
            return out

        for label, rows, results in counted(
                total, "stacked cohorts",
                ("threefry_uniform", "uniform_topk_stacked",
                 "greedy_scan_stacked"), stacked):
            err = hold_against_cpu(f"stacked {label}", rows, results, on)
            placed = sum(int((c >= 0).sum()) for c, _s in results)
            print(f"stacked cohort of 4 evals, {label}: {placed} asks "
                  f"placed, equal to the CPU batcher's (score error "
                  f"{err:.3g})")
    finally:
        storm.close()
    return figures, h


def check_placed(label, results, placed, expect):
    """Every ask placed on the card, and every placement made into an
    allocation (exact port offers) on the host."""
    on_card = sum(int((c >= 0).sum()) for c, _s in results)
    check(on_card == expect, f"{label}: {on_card} of {expect} asks placed")
    check(placed == on_card, f"{label}: {on_card} placed on the card, "
          f"{placed} made into allocations")


def device_share(torch, fn, label="storm round (64 evals, pre_resolve on)"):
    """Device busy time of ``fn`` (one storm round by default) under
    torch.profiler: the sum of the card's kernel and copy times over
    the wall time (one stream, so they do not overlap). Prints "not
    measured" when the profiler records no device activity."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1000.0
    device = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in device) / 1000.0
    if busy_ms <= 0.0:
        print(f"profiled {label}: device time not measured (the "
              "profiler recorded no device activity)")
        return dict(profiled_wall_ms=wall_ms)
    top = sorted(device, key=lambda e: -e.self_device_time_total)[:6]
    print(f"profiled {label}: device busy "
          f"{busy_ms:.2f} ms of {wall_ms:.1f} ms wall "
          f"({100.0 * busy_ms / wall_ms:.2f}%, idle "
          f"{100.0 - 100.0 * busy_ms / wall_ms:.2f}%); by name: " + ", ".join(
              f"{e.key[:40]} {e.self_device_time_total / 1000.0:.3f} ms "
              f"x{e.count}" for e in top))
    return dict(profiled_wall_ms=wall_ms, profiled_device_ms=busy_ms,
                device_busy_share=busy_ms / wall_ms)


def two_group_job_id(job_id, count):
    job = two_group_job(count)
    job.id = job_id
    return job


# ---------------------------------------------------------------- preemption

PREEMPT_ROOM_NODES = 256   # nodes with room for the high job's ask
PREEMPT_COUNT = 1_024      # the high job's count
PREEMPT_PRIORITY = 70
FILLER_PRIORITIES = (10, 20, 30, 40)


def build_red_cluster(harness, n_nodes, seed):
    """A red cluster: four filler jobs at priorities 10-40 hold five
    allocs on each node, with footprints drawn from ``seed``; only
    PREEMPT_ROOM_NODES nodes keep room for the high job's ask (500 CPU):
    the rest have at most 400 CPU free. Returns the filler jobs."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.structs import consts

    rng = random.Random(seed)
    fillers = []
    for prio in FILLER_PRIORITIES:
        job = mock.job()
        job.id = f"filler-p{prio}"
        job.priority = prio
        job.task_groups[0].tasks[0].resources.networks = []
        harness.state.upsert_job(harness.next_index(), job)
        fillers.append(harness.state.job_by_id(job.id))
    room = set(rng.sample(range(n_nodes), PREEMPT_ROOM_NODES))
    for i in range(n_nodes):
        node = mock.node()
        node.datacenter = ("dc1", "dc2")[i % 2]
        node.compute_class()
        harness.state.upsert_node(harness.next_index(), node)
        cpus = (300, 350, 400, 450, 500) if i in room else \
            (700, 720, 740, 760, 780)
        allocs = []
        for _ in range(ALLOCS_PER_NODE):
            job = rng.choice(fillers)
            alloc = mock.alloc()
            alloc.node_id = node.id
            alloc.job_id = job.id
            alloc.job = job
            alloc.desired_status = consts.ALLOC_DESIRED_RUN
            alloc.client_status = consts.ALLOC_CLIENT_RUNNING
            for tr in alloc.task_resources.values():
                tr.cpu = rng.choice(cpus)
                tr.memory_mb = rng.choice((64, 128))
                tr.networks = []
            alloc.resources = None
            allocs.append(alloc)
        harness.state.upsert_allocs(harness.next_index(), allocs)
    return fillers


def urgent_job():
    """The high-priority job: config 4's task (500 CPU, 256 MB, 50
    Mbit/s, two dynamic ports) under task-group distinct_hosts."""
    job = north_star_job()
    job.id = "urgent"
    job.priority = PREEMPT_PRIORITY
    job.task_groups[0].count = PREEMPT_COUNT
    return job


class Call(NamedTuple):
    """One recorded kernel-wrapper call."""

    inputs: tuple  # the arguments, copied before the call
    after: tuple  # the arguments after it: the final carry
    out: tuple  # the result


def cloned(x):
    """Tensors, alone or in (named) tuples, copied; anything else as
    is."""
    if hasattr(x, "clone"):
        return x.clone()
    if isinstance(x, tuple):
        items = [cloned(i) for i in x]
        return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
    return x


class Recorder:
    """Wraps the kernel wrapper ``module.name`` while the block runs and
    keeps each call: its inputs (copied first, as the scans update
    their carry in place), its arguments after the call and its result.
    The smoke holds each kernel against its plain version, and times
    it, on exactly the inputs the scheduler gave it."""

    def __init__(self, module, name):
        self.module, self.name, self.calls = module, name, []

    def __enter__(self):
        self.orig = getattr(self.module, self.name)

        def wrapped(*args):
            inputs = cloned(args)
            out = self.orig(*args)
            self.calls.append(Call(inputs, args, out))
            return out

        setattr(self.module, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def run_preemption(seed, torch, total):
    """Phase 5 (see the module docstring). Returns K6's recorded call
    and its score error against the plain version, for the timings."""
    from nomad_tpu_torch import migrate
    from nomad_tpu_torch.models.matrix import ClusterMatrix
    from nomad_tpu_torch.ops import preempt
    from nomad_tpu_torch.scheduler import new_scheduler
    from nomad_tpu_torch.scheduler.testing import Harness
    from nomad_tpu_torch.structs import consts
    from nomad_tpu_torch.structs.eval import new_eval

    t0 = time.perf_counter()
    h = Harness(seed=seed + 5)
    fillers = build_red_cluster(h, N_NODES, seed + 5)
    n_allocs = len(h.state.allocs())
    print(f"red cluster: {N_NODES} nodes, {n_allocs} allocs, built in "
          f"{time.perf_counter() - t0:.1f} s (host)")
    check(n_allocs == N_NODES * ALLOCS_PER_NODE, "red cluster size")
    job = urgent_job()
    h.state.upsert_job(h.next_index(), job)
    job = h.state.job_by_id(job.id)
    ev = new_eval(job, consts.EVAL_TRIGGER_JOB_REGISTER)

    # Preemption off: the same eval leaves the surplus unplaced.
    migrate.configure(preemption_enabled=False,
                      pressure_probe=lambda: "red")
    planner = _DryRunPlanner()
    sched = new_scheduler("service-gpu", logging.getLogger("smoke.off"),
                          h.state.snapshot(), planner,
                          rng=random.Random(seed))
    sched.process_eval(ev.copy())
    off = sum(len(a) for p in planner.plans
              for a in p.node_allocation.values())
    unplaced = PREEMPT_COUNT - off
    print(f"preemption off: placed {off}, {unplaced} unplaced")
    check(off == PREEMPT_ROOM_NODES and unplaced == PREEMPT_COUNT - off,
          f"preemption off placed {off}, expected {PREEMPT_ROOM_NODES}")

    # build_victims alone on the same state (a Python loop per node).
    t1 = time.perf_counter()
    _arrays, _lists, n_cands = ClusterMatrix(h.state, job).build_victims(
        PREEMPT_PRIORITY)
    print(f"build_victims host time, {N_NODES} nodes ({n_cands} "
          f"candidates): {(time.perf_counter() - t1) * 1000.0:.1f} ms")

    migrate.configure(preemption_enabled=True,
                      preempt_priority_threshold=50,
                      pressure_probe=lambda: "red")
    snap0 = h.state.snapshot()
    try:
        with Recorder(preempt, "preempt_scan") as rec:
            share = device_share(torch, lambda: counted(
                total, "preemption eval", (
                    "threefry_uniform", "uniform_topk", "preempt_scan"),
                lambda: h.process("service-gpu", ev)),
                "preemption eval (1,024 asks, K6 for the surplus)")
            wall_ms = share.get("profiled_wall_ms", float("nan"))
    finally:
        migrate.configure(preemption_enabled=False,
                          pressure_probe=lambda: "green")
    check(len(rec.calls) == 1, f"{len(rec.calls)} preemption dispatches")
    plan = h.plans[-1]
    placed = [a for allocs in plan.node_allocation.values() for a in allocs]
    victims = {n: list(v) for n, v in plan.node_preemptions.items()}
    n_victims = sum(len(v) for v in victims.values())
    via_k6 = sum(1 for a in placed if a.node_id in victims)
    print(f"preemption eval: placed {len(placed)} of {PREEMPT_COUNT} "
          f"({len(placed) - via_k6} by the main pass, {via_k6} by K6), "
          f"{n_victims} victims on {len(victims)} nodes, {wall_ms:.1f} ms "
          f"(host clock under the profiler, matrix builds and plan "
          f"included)")
    check(len(placed) == PREEMPT_COUNT, "not every ask placed")
    check(len(placed) - via_k6 == PREEMPT_ROOM_NODES,
          f"{len(placed) - via_k6} placed by the main pass")
    check(len({a.node_id for a in placed}) == len(placed),
          "distinct_hosts violated")
    ids = [v.id for vs in victims.values() for v in vs]
    check(len(ids) == len(set(ids)), "a victim staged twice")
    # Each node's victims: below priority 70 and the lowest-priority-
    # first prefix the host oracle picks for that node.
    pre = ClusterMatrix(snap0, job)
    rows = {node.id: i for i, node in enumerate(pre.nodes)}
    ask = [float(x) for x in pre.build_asks([0])[0][0]]
    for node_id, vs in victims.items():
        check(all(migrate.victim_priority(v) < PREEMPT_PRIORITY for v in vs),
              f"node {node_id}: a victim at or above priority 70")
        i = rows[node_id]
        needed = [max(0.0, float(pre.util[i, d]) + ask[d]
                      - float(pre.capacity[i, d])) for d in range(4)]
        live = snap0.allocs_by_node_terminal(node_id, False)
        want = migrate.select_victims_host(live, needed, PREEMPT_PRIORITY)
        check(want is not None and [a.id for a in want] == [v.id for v in vs],
              f"node {node_id}: victims differ from the host oracle")
    for v in ids:
        stored = h.state.alloc_by_id(v)
        check(stored.desired_status == consts.ALLOC_DESIRED_EVICT,
              f"victim {v} not evicted after the commit")
    hit = {v.job_id for vs in victims.values() for v in vs}
    follow = {e.job_id for e in h.create_evals
              if e.triggered_by == consts.EVAL_TRIGGER_PREEMPTION}
    check(hit == follow and hit <= {f.id for f in fillers},
          f"follow-up evals for {sorted(follow)}, victims of {sorted(hit)}")
    print(f"victims match the host oracle on all {len(victims)} nodes; "
          f"follow-up evals for {sorted(follow)}")

    # K6 against its plain version on the scheduler's own call.
    call = rec.calls[0]
    n = call.inputs[0].util.shape[0]
    return call, hold_preempt(
        torch, f"K6 (N={n}, K={call.out[0].shape[0]})", call)


def hold_preempt(torch, label, call):
    """K6's outputs and final carry (five node tensors and the victim
    mask) on a recorded call, against its plain version on the call's
    inputs: choices, victim counts and carry equal, scores within
    SCORE_TOL. Returns the score error."""
    from nomad_tpu_torch.ops import preempt

    st, _vs, vok = call.after[:3]
    want_st, vs, want_vok, asks, noise, prio, penalty = cloned(call.inputs)
    ch_p, sc_p, nv_p = preempt.preempt_scan_plain(
        want_st, vs, want_vok, asks, noise, prio, penalty)
    ch, sc, nv = call.out
    check(torch.equal(ch, ch_p) and torch.equal(nv, nv_p),
          f"{label}: choices or victim counts differ from the plain version")
    err = (sc - sc_p).abs().max().item()
    check(err <= SCORE_TOL, f"{label}: score error {err}")
    for name in CARRY_NAMES:
        check(torch.equal(getattr(st, name), getattr(want_st, name)),
              f"{label}: final {name} differs")
    check(torch.equal(vok, want_vok), f"{label}: consumed slots differ")
    print(f"{label}: {int((ch >= 0).sum())} placed, {int((nv > 0).sum())} "
          f"by eviction; choices, victim counts and the final carry (five "
          f"tensors and the victim mask) equal to the plain version, score "
          f"error {err:.3g}")
    return err


# ---------------------------------------------------------------- gangs

RACK_SIZE = 40  # 250 racks: the rack level pads to g_pad = 256
ICI_SIZE = 16   # 625 groups: the ici level pads to g_pad = 1,024


def topology_meta(node, i):
    node.meta["rack"] = f"rack{i // RACK_SIZE}"
    node.meta["ici"] = f"ici{i // ICI_SIZE}"


def gang_job(job_id, count, dh=False, **gang):
    """Config 4's task (dynamic ports included) as a gang task group."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.structs import Constraint, Gang, consts

    job = mock.job()
    job.id = job_id
    job.datacenters = ["dc1", "dc2"]
    tg = job.task_groups[0]
    tg.count = count
    tg.gang = Gang(**gang)
    if dh:
        tg.constraints.append(
            Constraint(operand=consts.CONSTRAINT_DISTINCT_HOSTS))
    return job


GANGS = (  # (label, job id, count, distinct_hosts, gang stanza)
    ("slice rack, K=64", "g-slice", 64, False, dict(slice="rack")),
    ("slice ici, K=64", "g-slice-ici", 64, False, dict(slice="ici")),
    ("spread rack, K=512", "g-spread", 512, False, dict(spread="rack")),
    ("affinity ici, K=128", "g-affinity", 128, False, dict(affinity="ici")),
    ("free + distinct_hosts, K=1024", "g-free", 1024, True, {}),
    ("slice rack + distinct_hosts, K=64 (larger than any rack)",
     "g-reject", 64, True, dict(slice="rack")),
)
# On nodes without topology meta: free, spread and affinity make every
# node its own group (10,000 groups, g_pad 10,240).
BARE_GANGS = (
    ("free, K=512, no meta", "b-free", 512, False, {}),
    ("spread rack, K=512, no meta", "b-spread", 512, False,
     dict(spread="rack")),
    ("affinity rack, K=128, no meta", "b-affinity", 128, False,
     dict(affinity="rack")),
)


def run_gangs(seed, torch, total):
    """Phase 6 (see the module docstring). Returns K7's recorded call
    and its score error against the plain version for each gang, by
    job id, and each gang's recorded ``gang_placement`` call (phase 9
    runs it again over node shards)."""
    from nomad_tpu_torch.ops import gang as ops_gang
    from nomad_tpu_torch.scheduler.testing import Harness

    recorded, placements = {}, {}
    for meta, gangs, what in (
            (topology_meta, GANGS, f"{N_NODES // RACK_SIZE} racks, "
             f"{N_NODES // ICI_SIZE} ici groups"),
            (None, BARE_GANGS, "no topology meta")):
        t0 = time.perf_counter()
        h = Harness(seed=seed + 7)
        build_cluster(h, N_NODES, ALLOCS_PER_NODE, seed + 7, meta=meta)
        print(f"gang cluster: {N_NODES} nodes ({what}), "
              f"{len(h.state.allocs())} allocs, built in "
              f"{time.perf_counter() - t0:.1f} s (host)")
        with Recorder(ops_gang, "gang_scan") as rec, \
                Recorder(ops_gang, "gang_placement") as programs:
            device_share(torch, lambda: counted(
                total, f"gang evals ({what})",
                ("threefry_uniform", "gang_scan"),
                lambda: drive_gangs(h, gangs, rec, recorded)),
                f"gang evals ({len(gangs)}, {what})")
        check(len(programs.calls) == len(gangs),
              f"{len(programs.calls)} gang programs for {len(gangs)} gangs")
        placements.update((g[1], c) for g, c in zip(gangs, programs.calls))
    # K7 against its plain version on each gang's own call.
    return {jid: (recorded[jid], hold_gang(
        torch, f"K7 ({label}, g_pad={recorded[jid].inputs[7].g_pad})",
        recorded[jid])) for label, jid, _k, _dh, _s in GANGS + BARE_GANGS}, \
        placements


def drive_gangs(h, gangs, rec, recorded):
    """Each gang job through ``Harness.process("service-gpu", ...)``,
    checked; its K7 call is kept in ``recorded``."""
    from nomad_tpu_torch.structs import consts
    from nomad_tpu_torch.structs.eval import new_eval

    meta_of = {n.id: n.meta for n in h.state.nodes()}
    for label, jid, k, dh, stanza in gangs:
        job = gang_job(jid, k, dh, **stanza)
        h.state.upsert_job(h.next_index(), job)
        n_plans, n_calls = len(h.plans), len(rec.calls)
        t1 = time.perf_counter()
        h.process("service-gpu", new_eval(h.state.job_by_id(jid),
                                          consts.EVAL_TRIGGER_JOB_REGISTER))
        ms = (time.perf_counter() - t1) * 1000.0
        check(len(rec.calls) == n_calls + 1,
              f"{label}: {len(rec.calls) - n_calls} K7 calls")
        recorded[jid] = rec.calls[-1]
        check_gang(h, label, jid, k, dh, stanza, n_plans, meta_of,
                   recorded[jid], ms)


def check_gang(h, label, jid, k, dh, stanza, n_plans, meta_of, call, ms):
    """A gang is all K or none; a slice lies in the tightest covering
    group; the spread cap holds; distinct_hosts holds; the plan's gang
    leg names every member; a rejected gang records one failure with
    K-1 coalesced. A node without the level's meta is its own group."""
    from nomad_tpu_torch.gang import gang_key
    from nomad_tpu_torch.ops import gang as ops_gang

    live = [a for a in h.state.allocs_by_job(jid) if not a.terminal_status()]
    state, ask, abw, aports = (
        type(x)(*(f.cpu() for f in x)) if isinstance(x, tuple) else x.cpu()
        for x in call.inputs[:4])
    config = call.inputs[7]
    slice_group = int(call.out[2])
    # The program's own group capacities, from the same inputs.
    units = ops_gang.member_units_plain(state, ask, abw, aports, config)
    caps = ops_gang.group_capacity_plain(units, state.topo_ids, config.g_pad)
    if jid == "g-reject":
        check(live == [] and len(h.plans) == n_plans,
              f"{label}: a rejected gang staged allocs")
        failed = h.evals[-1].failed_tg_allocs or {}
        check(len(failed) == 1, f"{label}: {len(failed)} failures recorded")
        (m,) = failed.values()
        check(m.coalesced_failures == k - 1,
              f"{label}: {m.coalesced_failures} coalesced, expected {k - 1}")
        check(float(caps.max()) < k, f"{label}: a rack covers the gang")
        print(f"gang {label}: rejected whole, one failure, {k - 1} "
              f"coalesced, {ms:.1f} ms (host clock under the profiler)")
        return
    check(len(live) == k, f"{label}: {len(live)} of {k} members live")
    plan = h.plans[-1]
    members = plan.gang_groups.get(gang_key(jid, "web"), [])
    check(sorted(members) == sorted(a.id for a in live),
          f"{label}: the plan's gang leg does not list every member")
    level = next(iter(stanza.values()), "rack")
    groups = [meta_of[a.node_id].get(level) or a.node_id for a in live]
    most = max(groups.count(g) for g in set(groups))
    if dh:
        check(len({a.node_id for a in live}) == k,
              f"{label}: distinct_hosts violated")
    if stanza.get("slice"):
        check(len(set(groups)) == 1, f"{label}: members in "
              f"{len(set(groups))} {level} groups")
        tightest = float(caps[caps >= float(k)].min())
        check(slice_group >= 0 and float(caps[slice_group]) == tightest,
              f"{label}: group capacity {float(caps[slice_group])}, the "
              f"tightest covering one has {tightest}")
        detail = f"one {level} group, capacity {tightest:.0f} (the tightest " \
                 "cover)"
    elif stanza.get("spread"):
        eligible = max(int((caps >= 1.0).sum()), 1)
        cap = -(-k // eligible)
        check(most <= cap, f"{label}: {most} members in one group, cap {cap}")
        detail = f"at most {most} a group (cap {cap} over {eligible} groups)"
    else:
        detail = (f"{len(set(groups))} {level} group(s), at most {most} a "
                  f"group, on {len({a.node_id for a in live})} nodes")
    print(f"gang {label}: all {k} placed, {detail}, {ms:.1f} ms (host "
          "clock under the profiler)")


def hold_gang(torch, label, call):
    """K7's outputs and final carry (util, bw_used, ports_free, placed,
    group members) on a recorded call, against its plain version on the
    call's inputs: all equal but the scores, which agree within
    SCORE_TOL. Returns the score error."""
    from nomad_tpu_torch.ops import gang as ops_gang

    inputs = cloned(call.inputs)
    ch_p, sc_p, sg_p = ops_gang.gang_scan_plain(*inputs)
    ch, sc, sg = call.out
    check(torch.equal(ch, ch_p) and int(sg) == int(sg_p),
          f"{label}: choices or slice group differ from the plain version")
    err = (sc - sc_p).abs().max().item()
    check(err <= SCORE_TOL, f"{label}: score error {err}")
    st, st_p = call.after[0], inputs[0]
    for name in ("util", "bw_used", "ports_free"):
        check(torch.equal(getattr(st, name), getattr(st_p, name)),
              f"{label}: final {name} differs")
    check(torch.equal(call.after[8], inputs[8])
          and torch.equal(call.after[9], inputs[9]),
          f"{label}: placed or group members differ")
    print(f"{label}: {int((ch >= 0).sum())} placed; choices, slice group "
          f"and the final carry equal to the plain version, score error "
          f"{err:.3g}")
    return err


def bench_legs(torch, k6, gangs):
    """K6 and K7 timed on the phases' own recorded calls: K6 at K =
    1,024 (the preemption eval) and K = 8 (its first eight asks), K7 on
    the free gang (K = 1,024, g_pad = 256), the ici slice (K = 64,
    g_pad = 1,024) and the spread without meta (K = 512, g_pad =
    10,240)."""
    from nomad_tpu_torch.ops import gang as ops_gang
    from nomad_tpu_torch.ops import preempt

    dev = torch.device("cuda")
    out = {}
    # ---- K6
    st0, vs, vok0, asks0, noise0, prio, penalty = k6[0].inputs
    n, g = st0.feasible.shape
    v = preempt.PREEMPT_MAX_VICTIMS
    for k in (noise0.shape[0], 8):
        if k == noise0.shape[0]:
            call, err = k6
        else:  # the first k asks: a call of its own, held like the path's
            asks = type(asks0)(*(x[:k].contiguous() for x in asks0[:5]),
                               *asks0[5:])
            inputs = (st0, vs, vok0, asks, noise0[:k].contiguous(), prio,
                      penalty)
            args = cloned(inputs)
            call = Call(inputs, args, preempt.preempt_scan(*args))
            err = hold_preempt(torch, f"K6 (N={n}, K={k})", call)
        box = {}
        ms = time_cuda(torch, lambda: preempt.preempt_scan(*box["a"]), RUNS,
                       setup=lambda: box.update(a=cloned(call.inputs)))
        plain_runs = 1 if k > 8 else 3
        plain_ms = time_cuda(
            torch, lambda: preempt.preempt_scan_plain(*box["a"]), plain_runs,
            warmup=1, setup=lambda: box.update(a=cloned(call.inputs)))
        chain = chain_ms(torch, k, dev)
        ch = call.out[0]
        rows = torch.unique(ch[ch >= 0]).numel()
        slots = int((vs.ok & ~call.after[2]).sum())
        # Node rows, the carry and feasible, and every victim slot read
        # once; the asks, the noise and the three outputs; the chosen
        # rows (carry and one tg_count cell) and consumed slots written.
        bytes_ = (n * (NODE_BYTES + CARRY_ROW_BYTES + 5 * g)
                  + n * v * (16 + 4 + 4 + 4 + 1) + k * (ASK_BYTES + 12)
                  + 1 + g + k * n * 4 + rows * (CARRY_ROW_BYTES + 4) + slots)
        flops = k * n * (60 + v * 14)  # score + one walk over the slots
        out.setdefault("preempt_scan", {})[k] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms,
            plain_runs=plain_runs,
            **bound(bytes_, max(flops / FP32_FLOPS, chain / 1000.0)),
            library_ms=None, chain_ms=chain)
        torch.cuda.empty_cache()
    # ---- K7
    for jid in ("g-free", "g-slice-ici", "b-spread"):
        call, err = gangs[jid]
        st, _a, _b, _c, active, _nz, _gnz, cfg = call.inputs[:8]
        n, k = st.util.shape[0], active.shape[0]
        box = {}
        ms = time_cuda(torch, lambda: ops_gang.gang_scan(*box["a"]), RUNS,
                       setup=lambda: box.update(a=cloned(call.inputs)))
        plain_runs = 1 if k > 64 else 3
        plain_ms = time_cuda(
            torch, lambda: ops_gang.gang_scan_plain(*box["a"]), plain_runs,
            warmup=1, setup=lambda: box.update(a=cloned(call.inputs)))
        chain = chain_ms(torch, k, dev)
        ch = call.out[0]
        rows = torch.unique(ch[ch >= 0]).numel()
        # The gang state read once (73 B a node), the ask and member
        # mask, both noises, the outputs; the chosen rows (util,
        # bw_used, ports_free, placed) and the group counts written.
        bytes_ = (n * 73 + 24 + k + k * n * 4 + cfg.g_pad * 8 + k * 8 + 4
                  + rows * 28)
        flops = k * n * 60 + n * 20
        print(f"gang_scan timed on {jid} (K={k}, g_pad={cfg.g_pad}, "
              f"{cfg.mode})")
        out.setdefault("gang_scan", {})[(k, cfg.g_pad)] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms,
            plain_runs=plain_runs,
            **bound(bytes_, max(flops / FP32_FLOPS, chain / 1000.0)),
            library_ms=None, chain_ms=chain)
        torch.cuda.empty_cache()
    return out


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


def seq_carry(base, jc, tgc):
    """One shared copy of the claimed capacity (the pre_resolve
    layout) and per-eval counts."""
    return tuple(x.clone() for x in (base["util"], base["bw_used"],
                                      base["ports_free"], jc, tgc))


def stacked_static(torch, np, base, b, seed, device):
    """Static node rows per eval (the stacked-state layout): capacity
    scaled by 1 or 2 per node and eval, node_ok thinned per eval."""
    rng = np.random.default_rng(seed)
    n = base["capacity"].shape[0]
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device)
    cap = (base["capacity"] * t(rng.integers(1, 3, (b, n, 1))
                                .astype(np.float32))).contiguous()
    sched = (cap - (base["capacity"] - base["sched_capacity"])).contiguous()
    ok = (base["node_ok"] & t(rng.random((b, n)) < 0.95)).contiguous()
    return cap, sched, base["bw_avail"].expand(b, n).contiguous(), ok


def bench_new_kernels(torch, np, seed):
    """The kernels of the storm path: K4 and the sequential and stacked
    layouts of K1 and K2, each against its plain version."""
    from nomad_tpu_torch.ops import binpack, prng

    dev = torch.device("cuda")
    n, g = BENCH_N, 2
    out = {}
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    # ---- K4 at R = 256 and 4,096 changed rows (padding repeats row 0)
    for r in (256, 4096):
        rng = np.random.default_rng(seed + r)
        parent = (t(rng.integers(0, 40, (n, 4)).astype(np.float32) * 50),
                  t(rng.integers(0, 10, n).astype(np.float32) * 50),
                  t(rng.integers(0, 7, n).astype(np.float32)),
                  t(rng.random(n) < 0.98))
        real = r - r // 8
        rows = np.empty(r, np.int32)
        rows[:real] = rng.choice(n, real, replace=False)
        rows[real:] = rows[0]
        vals = [rng.integers(0, 40, (r, 4)).astype(np.float32) * 50,
                rng.integers(0, 10, r).astype(np.float32) * 50,
                rng.integers(0, 7, r).astype(np.float32),
                rng.random(r) < 0.5]
        for v in vals:
            v[real:] = v[0]
        payload = (t(rows), *(t(v) for v in vals))
        before = [x.clone() for x in parent]
        got = binpack.apply_base_delta(*parent, *payload)
        want = binpack.apply_base_delta_plain(*parent, *payload)
        for x, y, z, p0 in zip(got, want, parent, before):
            check(torch.equal(x, y), f"K4 (R={r}): differs from the plain "
                  "version")
            check(torch.equal(z, p0), f"K4 (R={r}): the parent changed")
        err = max((x.double() - y.double()).abs().max().item()
                  for x, y in zip(got, want))
        ms = time_cuda(torch, lambda: binpack.apply_base_delta(
            *parent, *payload), RUNS)
        plain_ms = time_cuda(torch, lambda: binpack.apply_base_delta_plain(
            *parent, *payload), RUNS)
        idx = (payload[0].long(),)
        lib_ms = time_cuda(torch, lambda: [
            torch.index_put(x, idx, v)
            for x, v in zip(parent, payload[1:])], RUNS)
        # The parent read and the child written once (util, bw_used,
        # ports_free, node_ok: 25 B a node), and the R rows of payload.
        bytes_ = 2 * n * 25 + r * (4 + 16 + 4 + 4 + 1)
        out.setdefault("base_delta", {})[r] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms,
            **bound(bytes_, 0.0), library_ms=lib_ms)
        print(f"base_delta R={r}: bit-equal to the plain version, parent "
              "unchanged")
    # ---- K1 sequential at B x K = 4 x 1,024 and 64 x 64
    for b, k in ((4, 1024), (64, 64)):
        base, jc, tgc, feas, asks, _u, keys = kernel_inputs(
            torch, np, n, k, g, b, seed + 3 * b, dev)
        static = (base["capacity"], base["sched_capacity"], base["bw_avail"],
                  base["node_ok"])
        noise = prng.threefry_uniform(keys, (k, n), 0.0, 2.0)
        c_k, c_p = seq_carry(base, jc, tgc), seq_carry(base, jc, tgc)
        ch, sc = binpack.greedy_scan(*static, c_k, feas, asks, noise, 10.0,
                                     True)
        err = check_scan(torch, f"K1-seq (B={b}, K={k})", (ch, sc, c_k), (
            *binpack.greedy_scan_plain(*static, c_p, feas, asks, noise, 10.0,
                                       True), c_p))
        full = ((base["ports_free"] >= 2) & (c_k[2] < 2)).sum().item()
        check(full > 0, f"K1-seq (B={b}): no node filled to its port limit")
        print(f"greedy_scan_seq B={b} K={k}: {(ch >= 0).sum().item()} of "
              f"{b * k} asks placed over one shared carry, {full} rows "
              "filled to their port limit; choices, scores and all five "
              "carried tensors match")
        box = {}
        fresh = lambda: box.__setitem__("c", seq_carry(base, jc, tgc))
        ms = time_cuda(torch, lambda: binpack.greedy_scan(
            *static, box["c"], feas, asks, noise, 10.0, True), RUNS,
            setup=fresh)
        plain_ms = time_cuda(torch, lambda: binpack.greedy_scan_plain(
            *static, box["c"], feas, asks, noise, 10.0, True), 3, warmup=1,
            setup=fresh)
        rows, cells = rows_written(torch, ch, asks.tg_index, n, g)
        nodes = torch.unique(ch[ch >= 0]).numel()
        chain = chain_ms(torch, b * k, dev)
        # Node rows and the shared carry read once; per eval its counts
        # and feasible; every ask and its two outputs; the flags; the
        # noise; the chosen shared rows and per-eval counts written once.
        bytes_ = (n * (NODE_BYTES + 24) + b * n * (4 + 5 * g)
                  + b * k * (ASK_BYTES + 8) + b * (1 + g) + b * k * n * 4
                  + nodes * 24 + rows * 4 + cells * 4)
        flops = b * k * n * 60
        out.setdefault("greedy_scan_seq", {})[(b, k)] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms,
            **bound(bytes_, max(flops / FP32_FLOPS, chain / 1000.0)),
            library_ms=None, chain_ms=chain)
        del noise
    # ---- K2 sequential at B x K = 64 x 8 (config 4's storm)
    b, k = 64, 8
    base, jc, tgc, feas, _a, uasks, keys = kernel_inputs(
        torch, np, n, k, g, b, seed + 11, dev)
    static = (base["capacity"], base["sched_capacity"], base["bw_avail"],
              base["node_ok"])
    unoise = prng.threefry_uniform(keys, (n,), 0.0, 2.0)
    c_k, c_p = seq_carry(base, jc, tgc), seq_carry(base, jc, tgc)
    ch, sc = binpack.uniform_topk(*static, c_k, feas, uasks, unoise, 10.0,
                                  True)
    err = check_scan(torch, f"K2-seq (B={b}, K={k})", (ch, sc, c_k), (
        *binpack.uniform_topk_plain(*static, c_p, feas, uasks, unoise, 10.0,
                                    True), c_p))
    full = ((base["ports_free"] >= 2) & (c_k[2] < 2)).sum().item()
    print(f"uniform_topk_seq B={b} K={k}: {(ch >= 0).sum().item()} of "
          f"{b * k} asks placed, {full} shared rows filled to their port "
          "limit; choices, scores and all five carried tensors match")
    box = {}
    fresh = lambda: box.__setitem__("c", seq_carry(base, jc, tgc))
    ms = time_cuda(torch, lambda: binpack.uniform_topk(
        *static, box["c"], feas, uasks, unoise, 10.0, True), RUNS,
        setup=fresh)
    plain_ms = time_cuda(torch, lambda: binpack.uniform_topk_plain(
        *static, box["c"], feas, uasks, unoise, 10.0, True), RUNS,
        setup=fresh)
    score = torch.randn((b, n), device=dev)
    lib_ms = time_cuda(torch, lambda: torch.topk(score, k, dim=1), RUNS)
    rows, cells = rows_written(torch, ch, uasks.tg_index, n, g)
    nodes = torch.unique(ch[ch >= 0]).numel()
    bytes_ = (n * (NODE_BYTES + 24) + b * n * (4 + 4 + 1 + 4)
              + b * (ASK_BYTES - 1 + 2) + b * k * (1 + 8)
              + nodes * 24 + rows * 4 + cells * 4)
    out["uniform_topk_seq"] = {b: dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms,
        **bound(bytes_, b * n * 70 / FP32_FLOPS), library_ms=lib_ms)}
    # ---- K5b: the stacked layouts at B = 4 (K1 at K = 1,024, K2 at 8)
    b = 4
    for name, k in (("greedy_scan_stacked", BENCH_K),
                    ("uniform_topk_stacked", 8)):
        base, jc, tgc, feas, asks, uasks, keys = kernel_inputs(
            torch, np, n, k, g, b, seed + 13 + k, dev)
        static = stacked_static(torch, np, base, b, seed + k, dev)
        greedy = name.startswith("greedy")
        fn, plain = ((binpack.greedy_scan, binpack.greedy_scan_plain)
                     if greedy else
                     (binpack.uniform_topk, binpack.uniform_topk_plain))
        a = asks if greedy else uasks
        noise = prng.threefry_uniform(keys, (k, n) if greedy else (n,),
                                      0.0, 2.0)
        c_k, c_p = (new_carry(torch, base, jc, tgc) for _ in range(2))
        ch, sc = fn(*static, c_k, feas, a, noise, 10.0)
        err = check_scan(torch, f"{name} (B={b})", (ch, sc, c_k), (
            *plain(*static, c_p, feas, a, noise, 10.0), c_p))
        print(f"{name} B={b} K={k}: {(ch >= 0).sum().item()} of {b * k} "
              "asks placed over a base per eval; choices, scores and all "
              "five carried tensors match")
        box = {}
        fresh = lambda: box.__setitem__("c", new_carry(torch, base, jc, tgc))
        ms = time_cuda(torch, lambda: fn(*static, box["c"], feas, a, noise,
                                         10.0), RUNS, setup=fresh)
        plain_ms = time_cuda(torch, lambda: plain(
            *static, box["c"], feas, a, noise, 10.0),
            3 if greedy else RUNS, warmup=1, setup=fresh)
        rows, cells = rows_written(torch, ch, a.tg_index, n, g)
        lib_ms = None
        if greedy:
            chain = chain_ms(torch, k, dev)
            bytes_ = (b * n * (NODE_BYTES + CARRY_ROW_BYTES + 5 * g)
                      + b * k * (ASK_BYTES + 8) + b * (1 + g)
                      + b * k * n * 4 + rows * CARRY_ROW_BYTES + cells * 4)
            ops_s = max(b * k * n * 60 / FP32_FLOPS, chain / 1000.0)
        else:
            score = torch.randn((b, n), device=dev)
            lib_ms = time_cuda(torch, lambda: torch.topk(score, k, dim=1),
                               RUNS)
            bytes_ = (b * n * (NODE_BYTES + CARRY_ROW_BYTES + 4 + 1 + 4)
                      + b * (ASK_BYTES - 1 + 2) + b * k * (1 + 8)
                      + rows * CARRY_ROW_BYTES + cells * 4)
            ops_s = b * n * 70 / FP32_FLOPS
        out[name] = {b: dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             **bound(bytes_, ops_s), library_ms=lib_ms)}
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------- mesh

MESH_SHARDS = 4
MESH_ROUNDS = 2
RACK_GROUP_PAD = 256


def mesh_devices(torch):
    """The mesh phase's four shards: over the cards round-robin where
    there are two or more (the distinct-card path), else four slices of
    the one card."""
    n = torch.cuda.device_count()
    return [f"cuda:{s % n if n >= 2 else 0}" for s in range(MESH_SHARDS)]


class ShardRecorder:
    """Wraps ``parallel.shard.<name>`` (a wrapper over node shards) while
    the block runs and keeps each call's shards and other arguments,
    copied before it, and its result, copied: (shards, args, out)."""

    def __init__(self, name):
        from nomad_tpu_torch.parallel import shard

        self.module, self.name, self.calls = shard, name, []

    def __enter__(self):
        self.orig = getattr(self.module, self.name)

        def wrapped(shards, *args):
            inputs = [cloned(sh) for sh in shards]
            kept = cloned(args)
            out = self.orig(shards, *args)
            self.calls.append((inputs, kept, cloned(
                tuple(out) if isinstance(out, list) else out)))
            return out

        setattr(self.module, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def run_mesh(seed, torch, total, storm_h):
    """Phase 9: the node-sharded mesh path on a 4-shard mesh. Returns
    the recorded calls for the holds (bench_mesh)."""
    import numpy as np

    from nomad_tpu_torch.parallel.mesh import make_mesh
    from nomad_tpu_torch.parallel.shard import sharded_group_capacity
    from nomad_tpu_torch.scheduler.batcher import (
        PlacementBatcher,
        _delta_payload,
    )

    devices = mesh_devices(torch)
    mesh = make_mesh(devices=devices)
    print(f"mesh: {mesh}")
    if torch.cuda.device_count() < 2:
        print("mesh: distinct-card path not run (one card): the four "
              "shards are slices of cuda:0")
    else:
        print(f"mesh: distinct-card path over {torch.cuda.device_count()} "
              "cards")
    mb = PlacementBatcher(mesh=mesh)
    ref = PlacementBatcher()
    storm = Storm(storm_h, mb)
    on = lambda job, m: placement_config(job, m, True)  # noqa: E731
    rec = {}
    figures = {}
    try:
        s0 = mb.stats()
        # Warm-up round on the first snapshot, not committed (phase 4's
        # warm-up): its host base build and sharded upload stay out of
        # the timed rounds, and round 1 finds the base cached.
        storm.round(storm.jobs("mesh-warm", STORM_BATCH, storm_job),
                    105_000, on)
        rounds = [storm.jobs(f"mesh{r}", STORM_BATCH, storm_job)
                  for r in range(MESH_ROUNDS)]
        spans = []

        def mesh_storm():
            out = []
            with ShardRecorder("sharded_uniform_topk") as topk:
                for r, jobs in enumerate(rounds):
                    before = mb.stats()
                    out.append(storm.round(jobs, 110_000 + r * STORM_BATCH,
                                           on))
                    spans.append(dispatch_us(stats_delta(
                        before, mb.stats())) / 1000.0)
                    storm.commit(out[-1][2])
            rec["topk"] = topk.calls
            return out

        with GcPauses() as gc_pauses:
            done = counted(total, "mesh storm", (
                "threefry_uniform", "expand_overlay", "sharded_uniform_topk",
                "sharded_base_delta"), mesh_storm)
        st = stats_delta(s0, mb.stats())
        lat = [t for r in done for t in r[3]]
        wall = sum(r[4] for r in done)
        n_evals = MESH_ROUNDS * STORM_BATCH
        placed = sum(len(a) for r in done for p in r[2]
                     for a in p.node_allocation.values())
        figures.update(
            evals=n_evals, evals_per_s=n_evals / wall,
            p50_ms=float(np.percentile(lat, 50)) * 1000.0,
            p99_ms=float(np.percentile(lat, 99)) * 1000.0,
            placed=placed, sync_ms=st["sync_us"] / 1000.0,
            issue_ms=st["issue_us"] / 1000.0,
            conflicted=sum(conflicted_evals(r[0], r[1]) for r in done))
        print(f"mesh storm ({MESH_SHARDS} shards): {n_evals} evals in "
              f"{wall:.3f} s = {figures['evals_per_s']:.2f} evals/s; "
              f"per-eval p50 {figures['p50_ms']:.2f} ms, p99 "
              f"{figures['p99_ms']:.2f} ms; issue {figures['issue_ms']:.1f}"
              f" ms, sync {figures['sync_ms']:.1f} ms; batcher, warm-up "
              f"round included: {json.dumps(st, sort_keys=True)}")
        check_placed("mesh storm", [x for r in done for x in r[1]], placed,
                     n_evals * 8)
        check(figures["conflicted"] == 0, "mesh storm: conflicted evals")
        check(st["sharded_bases"] == MESH_ROUNDS and st["base_uploads"] == 1
              and st["base_delta_updates"] == MESH_ROUNDS - 1
              and st["fused_delta_updates"] == 0,
              f"mesh storm: rounds after the first did not derive a "
              f"sharded base through K10a: {st}")
        occ = mb.shard_occupancy()
        print(f"mesh storm: per-shard occupancy {json.dumps(occ)}")
        print(f"  garbage collection in those rounds: "
              f"{json.dumps(gc_pauses.summary(), sort_keys=True)}")
        # The same rows through the unsharded batcher (K2-seq, K3, K4):
        # plans identical, choices and scores bit for bit; its dispatch
        # timed beside the mesh one.
        ref_ms = []
        for r, (rows, results, plans, _l, _w) in enumerate(done):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want = ref.place_cohort([(m, a, k, on(job, m))
                                     for job, _s, m, a, k in rows])
            ref_ms.append((time.perf_counter() - t0) * 1000.0)
            print(f"  round {r}: {done[r][4] * 1000:.1f} ms, of it the mesh "
                  f"dispatch {spans[r]:.1f} ms (batcher upload, stack, "
                  f"issue, sync); the unsharded dispatch of the same rows "
                  f"{ref_ms[r]:.1f} ms")
            for i, ((c, sc), (wc, ws)) in enumerate(zip(results, want)):
                check(np.array_equal(c, wc) and np.array_equal(
                    sc.view(np.int32), ws.view(np.int32)),
                    f"mesh storm round {r} eval {i}: differs from the "
                    "unsharded storm")
            for row, plan, (wc, ws) in zip(rows, plans, want):
                again = storm.materialize(row, wc, ws)
                check(plan_nodes(plan) == plan_nodes(again),
                      f"mesh storm round {r}: a plan differs")
        figures.update(dispatch_ms=spans, unsharded_dispatch_ms=ref_ms,
                       **gc_pauses.summary())
        print(f"mesh storm: {MESH_ROUNDS} rounds' plans identical to the "
              "unsharded storm's on the same state and keys")
        # The base delta of round 2, for K10a's hold.
        m2 = done[1][0][0][2]
        parent = mb._device_bases[m2.base_delta[0]]
        rec["delta"] = (mesh, parent, _delta_payload(
            (m2.capacity, m2.sched_capacity, m2.util, m2.bw_avail,
             m2.bw_used, m2.ports_free, m2.node_ok, m2.class_ids),
            m2.base_delta[1]))

        # ---- the 512 + 512 greedy eval through K10c, against K1
        job = storm.jobs("mesh-greedy", 1,
                         lambda i: two_group_job_id(i, 512))[0]
        row = storm.build_row(storm_h.state.snapshot(), job, 120_000)

        def greedy():
            with ShardRecorder("sharded_greedy_scan") as scan:
                got = mb.place_cohort([(row[2], row[3], row[4],
                                        on(job, row[2]))])
            rec["greedy"] = scan.calls
            return got

        t0 = time.perf_counter()
        got = counted(total, "mesh greedy eval", (
            "threefry_uniform", "expand_overlay", "sharded_greedy_scan"),
            greedy)
        wall = time.perf_counter() - t0
        want = ref.place_cohort([(row[2], row[3], row[4], on(job, row[2]))])
        (c, sc), (wc, ws) = got[0], want[0]
        check(np.array_equal(c, wc) and np.array_equal(
            sc.view(np.int32), ws.view(np.int32)),
            "mesh greedy eval: differs from K1's")
        figures["greedy_eval_ms"] = wall * 1000.0
        print(f"mesh greedy eval (512 + 512 asks, pre_resolve, live rows "
              f"only): {int((c >= 0).sum())} of 1024 placed in "
              f"{wall * 1000:.1f} ms, choices and scores equal to K1's")

        # ---- K10b on the mesh: member units of config 4's ask per node
        # over meta-less singletons (g_pad 10,240) and racks of 40
        m = row[2]
        ask = np.asarray(row[3].resources[0], np.float64)
        free = np.asarray(m.capacity, np.float64) - m.util
        per = np.where(ask[None, :] > 0,
                       np.floor(free / np.maximum(ask, 1e-9)[None, :]), 1e9)
        units = (np.clip(per.min(1), 0, None) * m.node_ok).astype(np.float32)
        n = units.shape[0]
        real = np.arange(n) < m.n_real
        groups = {
            n: np.where(real, np.arange(n), -1).astype(np.int32),
            RACK_GROUP_PAD: np.where(real, np.arange(n) // RACK_SIZE,
                                     -1).astype(np.int32)}

        def capacities():
            return {g_pad: sharded_group_capacity(mesh, g_pad)(units, ids)
                    for g_pad, ids in groups.items()}

        caps = counted(total, "mesh group capacity", ("group_capacity",),
                       capacities)
        for g_pad, ids in groups.items():
            want = np.zeros(g_pad, np.float32)
            np.add.at(want, ids[ids >= 0], units[ids >= 0])
            check(np.array_equal(caps[g_pad].cpu().numpy(), want),
                  f"K10b (g_pad {g_pad}): differs from the one-device sum")
        rec["groups"] = (mesh, units, groups)
        print(f"mesh group capacity: g_pad {n} (singletons) and "
              f"{RACK_GROUP_PAD} (racks of {RACK_SIZE}) equal the one-device "
              f"node-order sums (units under 2^24: max "
              f"{float(units.max()):.0f})")
    finally:
        storm.close()
    return figures, rec


def plan_nodes(plan):
    """{alloc name: node id} of a plan."""
    return {a.name: a.node_id for allocs in plan.node_allocation.values()
            for a in allocs}


def hold_shards(torch, label, call):
    """One recorded sharded-scan call (K10c, K10d or K10g-b) re-run
    through the kernel and the plain version on copies of its inputs:
    choices, scores and every shard's carry equal (scores within
    SCORE_TOL), and the kernel's re-run equal to the recorded result.
    Then the whole node axis through the unsharded K1 / K2 / K8b (fed
    the same pref): equal bit for bit. Returns the score error and the
    kernel re-run's launches."""
    from nomad_tpu_torch.ops import binpack
    from nomad_tpu_torch.parallel import shard

    from nomad_tpu_torch.kernels import convex

    inputs, (penalty, *rest), out = call
    seq = bool(rest and rest[0])
    uniform = inputs[0].noise.dim() == 2
    biased = inputs[0].pref is not None
    kern, plain, one = ((shard.sharded_uniform_topk,
                         shard.sharded_uniform_topk_plain,
                         binpack.uniform_topk) if uniform else
                        (shard.sharded_convex_round,
                         shard.sharded_convex_round_plain,
                         convex.convex_round) if biased else
                        (shard.sharded_greedy_scan,
                         shard.sharded_greedy_scan_plain,
                         binpack.greedy_scan))
    runs = []
    for fn in (kern, plain):
        shards = [cloned(sh) for sh in inputs]
        (ch, sc), n = launches_of(kern.__name__, lambda: fn(
            shards, penalty, seq))
        if fn is kern:
            launches = n
        runs.append((ch, sc, joined_carry(torch, shards, seq)))
    err = check_scan(torch, label, *runs)
    check(torch.equal(runs[0][0], out[0]) and torch.equal(runs[0][1], out[1]),
          f"{label}: the re-run differs from the recorded call")
    whole = [cloned(sh) for sh in inputs]
    cat = lambda xs, d: torch.cat(list(xs), dim=d)  # noqa: E731
    static = [cat((getattr(sh, f) for sh in whole), 0)
              for f in ("capacity", "sched_capacity", "bw_avail", "node_ok")]
    carry = list(joined_carry(torch, whole, seq))
    feas = cat((sh.feasible for sh in whole), 1)
    noise = cat((sh.noise for sh in whole), -1)
    pref = (cat((sh.pref for sh in whole), -1),) if biased else ()
    ch, sc = one(*static, carry, feas, whole[0].asks, noise, penalty, *pref,
                 seq)
    check(torch.equal(ch, out[0]) and torch.equal(sc, out[1]),
          f"{label}: differs from the unsharded kernel")
    return err, launches


def launches_of(name, fn):
    """``fn()`` with the launch counts set to 0 just before it: its
    result and the launches of kernel ``name`` it made."""
    from nomad_tpu_torch.ops import cuda

    cuda.reset_launch_counts()
    out = fn()
    return out, cuda.launch_counts().get(name, 0)


def joined_carry(torch, shards, seq):
    own = 0 if seq else 1
    return tuple(torch.cat([sh.carry[i] for sh in shards],
                           dim=own if i < 3 else 1) for i in range(5))


def bench_mesh(torch, np, rec):
    """Holds and times of K10a-K10d on the mesh phase's own inputs: the
    round-2 base delta, both group capacities, the 512 + 512 eval's
    K10c call (B = 1 under seq: the batcher pads no batch over a
    sharded base), and the storm's 64-eval K10d calls (K = 8 under seq:
    all held, the first timed)."""
    from nomad_tpu_torch.ops.binpack import apply_base_delta_plain
    from nomad_tpu_torch.parallel import shard
    from nomad_tpu_torch.parallel.mesh import gather, place

    out = {}
    # ---- K10a
    mesh, parent, payload = rec["delta"]
    targets = [parent[i] for i in (2, 4, 5, 6)]
    got, delta_launches = launches_of("sharded_base_delta", lambda: (
        shard.sharded_base_delta(mesh)(*targets, *payload)))
    pay = place(mesh, payload, ((), (None, None), (), (), ()))
    w = len(targets[0].parts[0])

    def plain_delta():
        return [apply_base_delta_plain(
            *(t.parts[0][s] for t in targets),
            *(p.parts[0][s] for p in pay), targets[0].lo[s])
            for s in range(w)]

    want = plain_delta()
    delta_err = 0.0
    for j, g in enumerate(got):
        for s in range(w):
            check(torch.equal(g.parts[0][s], want[s][j]),
                  f"K10a: shard {s} differs from the plain version")
            delta_err = max(delta_err, (g.parts[0][s].float() - want[s][j]
                                        .float()).abs().max().item())
    whole = [gather(t) for t in targets]
    rows = torch.from_numpy(payload[0]).long()
    for g, t, v in zip(got, whole, payload[1:]):
        t[rows] = torch.from_numpy(np.asarray(v))
        check(torch.equal(gather(g), t), "K10a: differs from the "
              "one-device scatter")
    n = sum(p.shape[0] for p in targets[0].parts[0])
    r = len(payload[0])
    ms = time_cuda(torch, lambda: shard.sharded_base_delta(mesh)(
        *targets, *payload), RUNS)
    plain_ms = time_cuda(torch, plain_delta, RUNS)
    flat = [gather(t).cuda() for t in targets]
    idx = (rows.cuda(),)
    vals = [torch.from_numpy(np.asarray(v)).cuda() for v in payload[1:]]
    lib_ms = time_cuda(torch, lambda: [
        torch.index_put(x, idx, v) for x, v in zip(flat, vals)], RUNS)
    out["sharded_base_delta"] = {r: dict(
        max_abs_err=delta_err, ms=ms, plain_ms=plain_ms,
        **bound(2 * n * 25 + r * 29, 0.0), library_ms=lib_ms,
        launches_per_call=delta_launches, shards=w)}
    print(f"K10a: {r} payload rows over {w} shards of {n // w} equal the "
          "plain version and the one-device scatter")
    # ---- K10b
    mesh, units, groups = rec["groups"]
    for g_pad, ids in groups.items():
        run = shard.sharded_group_capacity(mesh, g_pad)
        got, n_launch = launches_of("group_capacity",
                                    lambda: run(units, ids))
        u_sh, i_sh = place(mesh, (units, ids), (("nodes",), ("nodes",)))

        def plain_groups():
            from nomad_tpu_torch.ops.gang import group_capacity_plain

            return shard.group_capacity_combine_plain(torch.stack([
                group_capacity_plain(u, i, g_pad)
                for u, i in zip(u_sh.parts[0], i_sh.parts[0])]))

        want = plain_groups()
        check(torch.equal(got, want), f"K10b (g_pad {g_pad}): differs "
              "from the plain version")
        ms = time_cuda(torch, lambda: run(u_sh, i_sh), RUNS)
        plain_ms = time_cuda(torch, plain_groups, RUNS)
        tu = torch.from_numpy(units).cuda()
        ti = torch.from_numpy(ids).cuda()
        keep = ti >= 0
        tu, ti = tu[keep].contiguous(), ti[keep].long().contiguous()
        lib_ms = time_cuda(torch, lambda: torch.zeros(
            g_pad, device=tu.device).index_add_(0, ti, tu), RUNS)
        nn = units.shape[0]
        out.setdefault("group_capacity", {})[g_pad] = dict(
            max_abs_err=(got - want).abs().max().item(), ms=ms,
            plain_ms=plain_ms,
            **bound(nn * 8 + g_pad * 4, nn / INT32_OPS), library_ms=lib_ms,
            launches_per_call=n_launch, shards=len(u_sh.parts[0]))
    # ---- K10c on the 512 + 512 eval's call
    call = rec["greedy"][0]
    err, launches = hold_shards(torch, "K10c (512 + 512 eval)", call)
    inputs, (penalty, seq), res = call
    b, k = res[0].shape
    n = sum(sh.feasible.shape[1] for sh in inputs)
    g = inputs[0].feasible.shape[2]
    box = {}
    fresh = lambda: box.__setitem__(  # noqa: E731
        "s", [cloned(sh) for sh in inputs])
    ms = time_cuda(torch, lambda: shard.sharded_greedy_scan(
        box["s"], penalty, seq), 5, setup=fresh, warmup=1)
    plain_ms = time_cuda(torch, lambda: shard.sharded_greedy_scan_plain(
        box["s"], penalty, seq), 1, setup=fresh, warmup=0)
    chain = chain_ms(torch, b * k if seq else k, torch.device("cuda"))
    tg = inputs[0].asks.tg_index
    rows, cells = rows_written(torch, res[0], tg, n, g)
    bytes_ = (n * NODE_BYTES + b * n * (CARRY_ROW_BYTES + 5 * g)
              + b * k * (ASK_BYTES + 8) + b * (1 + g) + b * k * n * 4
              + rows * CARRY_ROW_BYTES + cells * 4)
    out["sharded_greedy_scan"] = {(b, k): dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms,
        **bound(bytes_, max(b * k * n * 60 / FP32_FLOPS, chain / 1000.0)),
        library_ms=None, chain_ms=chain, launches_per_call=launches,
        shards=w)}
    print(f"K10c (B x K = {b} x {k}, seq {seq}, {w} shards): held against "
          f"the plain version and K1; {launches} launches a call")
    # ---- K10d on the storm's calls
    held = [hold_shards(torch, f"K10d storm call {i}", c)
            for i, c in enumerate(rec["topk"])]
    errs = [e for e, _n in held]
    inputs, (penalty, seq), res = rec["topk"][0]
    b, k = res[0].shape
    n = sum(sh.feasible.shape[1] for sh in inputs)
    ms = time_cuda(torch, lambda: shard.sharded_uniform_topk(
        box["s"], penalty, seq), RUNS,
        setup=lambda: box.__setitem__("s", [cloned(sh) for sh in inputs]))
    plain_ms = time_cuda(torch, lambda: shard.sharded_uniform_topk_plain(
        box["s"], penalty, seq), 3, warmup=1,
        setup=lambda: box.__setitem__("s", [cloned(sh) for sh in inputs]))
    score = torch.randn((b, n), device="cuda")
    lib_ms = time_cuda(torch, lambda: torch.topk(score, k, dim=1), RUNS)
    tg = inputs[0].asks.tg_index
    rows, cells = rows_written(torch, res[0], tg, n, g)
    nodes = torch.unique(res[0][res[0] >= 0]).numel()
    bytes_ = (n * (NODE_BYTES + 24) + b * n * (4 + 4 + 1 + 4)
              + b * (ASK_BYTES - 1 + 2) + b * k * (1 + 8)
              + nodes * 24 + rows * 4 + cells * 4)
    out["sharded_uniform_topk"] = {b: dict(
        max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
        **bound(bytes_, b * n * 70 / FP32_FLOPS), library_ms=lib_ms,
        launches_per_call=held[0][1], shards=w, calls_held=len(errs))}
    print(f"K10d: {len(errs)} storm calls (B x K = {b} x {k}, seq {seq}) "
          "held against the plain version and K2")
    return out


# ------------------------------------------- mesh: gang, defrag, convex


@contextlib.contextmanager
def batcher_for_schedulers(batcher):
    """``batcher`` as the process batcher of the port's default device
    while the block runs, so the dense schedulers (``service-convex-gpu``)
    dispatch through it: the port shards a base only on a batcher given
    a mesh, and has no automatic mesh yet."""
    from nomad_tpu_torch.device import default_device
    from nomad_tpu_torch.scheduler import batcher as batcher_mod

    dev = default_device()
    with batcher_mod._batchers_lock:
        before = batcher_mod._batchers.get(dev)
        batcher_mod._batchers[dev] = batcher
    try:
        yield
    finally:
        with batcher_mod._batchers_lock:
            if before is None:
                batcher_mod._batchers.pop(dev, None)
            else:
                batcher_mod._batchers[dev] = before


def joined(torch, outs, i):
    """Output ``i`` of a per-shard output list, joined in node order."""
    return torch.cat([o[i] for o in outs], dim=-1)


def dry_plan(h, kind, ev, seed):
    """One eval through ``kind`` on ``h``'s state, nothing committed:
    its plan (the rng from ``seed``, so two arms draw the same keys)."""
    from nomad_tpu_torch.scheduler import new_scheduler

    planner = _DryRunPlanner()
    new_scheduler(kind, logging.getLogger("smoke.mesh"), h.state.snapshot(),
                  planner, rng=random.Random(seed)).process_eval(ev.copy())
    check(len(planner.plans) == 1, f"{kind}: {len(planner.plans)} plans")
    return planner.plans[0]


def run_mesh_programs(seed, torch, total, main_h, storm_h, frag_h,
                      gang_programs):
    """Phase 9, the last three node-sharded programs on the 4-shard
    mesh: (a) the convex kernel (K10g) through ``service-convex-gpu`` on
    a mesh batcher, then a convex storm through its ``place_cohort``;
    (b) ``compute_defrag_plan(..., mesh=)`` (K10f); (c) phase 6's gang
    programs on a node-sharded GangState (K10e). Returns figures and the
    recorded calls for phase 7's holds (bench_mesh_programs)."""
    import numpy as np

    from nomad_tpu_torch.defrag import (
        WarmState,
        build_wave_evals,
        compute_defrag_plan,
    )
    from nomad_tpu_torch.kernels import convex
    from nomad_tpu_torch.kernels.differential import judge_migration_plan
    from nomad_tpu_torch.ops.gang import GANG_MODE_FREE, \
        GANG_MODE_AFFINITY, gang_placement
    from nomad_tpu_torch.parallel.mesh import make_mesh, shard_gang_inputs
    from nomad_tpu_torch.scheduler.batcher import PlacementBatcher
    from nomad_tpu_torch.structs import consts
    from nomad_tpu_torch.structs.eval import new_eval

    mesh = make_mesh(devices=mesh_devices(torch))
    mb = PlacementBatcher(mesh=mesh)
    rec, figures = {}, {}
    relax_names = ("threefry_uniform", "expand_overlay",
                   "sharded_convex_relax", "sharded_convex_round")
    # ---- a. service-convex-gpu through the mesh batcher on phase 3's
    # cluster, beside the unsharded convex eval on the same state and key
    h = main_h
    steps = [("config 4 job (K = 8, ports + distinct_hosts)",
              storm_job("mesh-convex-star"), 8),
             ("512 + 512 two-group job (K = 1,024)",
              two_group_job_id("mesh-convex-two", 512), 1024)]
    for label, job, expect in steps:
        h.state.upsert_job(h.next_index(), job)
        job = h.state.job_by_id(job.id)
        ev = new_eval(job, consts.EVAL_TRIGGER_JOB_REGISTER)
        existing = {a.id for a in h.state.allocs_by_job(job.id)}
        host_n = host_oracle_count(h.state, ev, seed, existing)
        with Recorder(convex, "relaxed_pref") as one_rel:
            one_plan = dry_plan(h, "service-convex-gpu", ev, seed)
        with batcher_for_schedulers(mb), \
                ShardRecorder("sharded_relax") as rel, \
                ShardRecorder("sharded_convex_round") as rnd:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            plan = counted(total, f"mesh convex eval, {label}", relax_names,
                           lambda: dry_plan(h, "service-convex-gpu", ev,
                                            seed))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        check(mb.stats()["sharded_bases"] >= 1,
              "mesh convex eval: the base was not sharded")
        fresh = new_allocs(plan, existing)
        check(len(fresh) == host_n == expect,
              f"mesh convex {label}: placed {len(fresh)}, host {host_n}")
        if expect == 8:
            check(len({a.node_id for a in fresh}) == 8,
                  f"mesh convex {label}: distinct_hosts violated")
        check(len(one_rel.calls) == len(rel.calls) == len(rnd.calls) == 1,
              f"mesh convex {label}: {len(rel.calls)} relaxations")
        pref = joined(torch, rel.calls[0][2], 2)
        one = one_rel.calls[0].out
        err = (pref - one).abs().max().item()
        if err > X_TOL:  # float32 drift: held by the float64 run
            args = _double(one_rel.calls[0].inputs)
            p64 = convex.relaxed_assignment_plain(*args)[2]
            far = (pref.double() - p64).abs().max().item()
            bound = 10 * (one.double() - p64).abs().max().item() + 1e-5
            check(bound < CHAOS_CAP and far <= bound,
                  f"mesh convex {label}: pref error {err}, float64 "
                  f"distance {far}, bound {bound}")
        mine, theirs = plan_nodes(plan), plan_nodes(one_plan)
        differ = sum(mine[k] != theirs.get(k) for k in mine)
        # Commit the mesh plan, then hold it as phase 8 holds its evals.
        allocs = [a for per in plan.node_allocation.values() for a in per]
        for a in allocs:
            a.job = job
        h.state.upsert_allocs(h.next_index(), allocs)
        check_placements(h.state, job, plan)
        figures[f"mesh_convex_eval_ms_{expect}"] = wall * 1000.0
        print(f"mesh convex eval, {label}: placed {len(fresh)} (host oracle "
              f"{host_n}) in {wall * 1000:.1f} ms; pref within {err:.3g} of "
              f"the unsharded eval's; {differ} of {len(mine)} placements "
              "differ from the unsharded eval's on the same state and key")
        rec[("eval", expect)] = (rel.calls[0], rnd.calls[0])
    # ---- a'. a convex storm through the mesh batcher, pre_resolve on
    storm = Storm(storm_h, mb)
    conv = lambda job, m: placement_config(job, m, True, "convex")  # noqa
    try:
        jobs = storm.jobs("mesh-convex", CONVEX_STORM_BATCH, storm_job)
        with ShardRecorder("sharded_relax") as rel, \
                ShardRecorder("sharded_convex_round") as rnd:
            rows, results, plans, lat, wall = counted(
                total, "mesh convex storm", relax_names,
                lambda: storm.round(jobs, 150_000, conv))
    finally:
        storm.close()
    placed = sum(len(a) for p in plans for a in p.node_allocation.values())
    conflicted = conflicted_evals(rows, results)
    figures.update(mesh_convex_storm_evals_per_s=CONVEX_STORM_BATCH / wall,
                   mesh_convex_storm_p99_ms=float(
                       np.percentile(lat, 99)) * 1000.0)
    print(f"mesh convex storm: {CONVEX_STORM_BATCH} evals of config 4's job "
          f"(pre_resolve, {MESH_SHARDS} shards) in {wall:.3f} s = "
          f"{CONVEX_STORM_BATCH / wall:.2f} evals/s; per-eval p50 "
          f"{np.percentile(lat, 50) * 1000:.2f} ms, p99 "
          f"{np.percentile(lat, 99) * 1000:.2f} ms; {placed} placed; "
          f"conflicted evals: {conflicted}")
    check_placed("mesh convex storm", results, placed,
                 CONVEX_STORM_BATCH * 8)
    check(conflicted == 0, f"mesh convex storm: {conflicted} conflicted")
    check(len(rel.calls) == len(rnd.calls) == CONVEX_STORM_BATCH,
          f"mesh convex storm: {len(rel.calls)} relaxations")
    rec["storm"] = list(zip(rel.calls, rnd.calls))
    # ---- b. the defrag solve over the mesh on phase 8's fragmented layout
    warm = WarmState()
    plans = {}
    with ShardRecorder("sharded_relax") as sol:
        for label in ("cold", "warm"):
            plan = counted(
                total, f"mesh defrag solve, {label}",
                ("sharded_defrag_solve",),
                lambda: compute_defrag_plan(
                    frag_h.state.snapshot(), ["dc1", "dc2"],
                    max_moves=DEFRAG_MOVES, min_gain=0.0, warm=warm,
                    class_compress=False, mesh=mesh))
            plans[label] = plan
            print(f"mesh defrag {label}: K = {plan.k} over {plan.n} nodes "
                  f"({MESH_SHARDS} shards), {plan.movable} movable, warm "
                  f"{plan.warm} ({plan.carried} carried), {plan.candidates} "
                  f"candidates, {len(plan.moves)} moves, fragmentation "
                  f"{plan.frag_before:.6f} -> {plan.frag_after:.6f}, round "
                  f"{plan.solve_ms:.1f} ms (host)")
            check(plan.frag_after <= plan.frag_before,
                  f"mesh defrag {label}: fragmentation rose")
            check(plan.warm == (label == "warm") and not plan.compressed,
                  f"mesh defrag {label}: warm {plan.warm}")
            check(plan.k == 512 and plan.n == BENCH_N,
                  f"mesh defrag {label}: K = {plan.k}, N = {plan.n}")
    check(len(sol.calls) == 2, f"{len(sol.calls)} sharded defrag solves")
    rec["defrag"] = dict(zip(plans, sol.calls))
    moves = plans["warm"].moves
    check(moves, "mesh defrag found no move")
    judged = 0
    for ev in build_wave_evals(frag_h.state.snapshot(), moves):
        ev_snap = frag_h.state.snapshot()
        seen = len(frag_h.plans)
        frag_h.process("service-gpu", ev)
        for wave_plan in frag_h.plans[seen:]:
            bad = judge_migration_plan(ev_snap, wave_plan)
            check(not bad, f"mesh defrag wave plan: {bad[:3]}")
            judged += 1
    print(f"mesh defrag wave: {len(moves)} moves, {judged} plans judged by "
          "judge_migration_plan (clean)")
    # ---- c. phase 6's gang programs on a node-sharded GangState
    for jid in ("g-free", "g-slice-ici", "b-spread"):
        call = gang_programs[jid]
        state, ask_res, ask_bw, ask_ports, active, key, config, _d = \
            call.inputs
        names = ("threefry_uniform", "sharded_gang_scan")
        if config.mode not in (GANG_MODE_FREE, GANG_MODE_AFFINITY):
            names += ("group_capacity",)
        with ShardRecorder("sharded_gang_scan") as gs:
            got = counted(total, f"mesh gang {jid}", names, lambda: (
                gang_placement(shard_gang_inputs(mesh, state), ask_res,
                               ask_bw, ask_ports, active, key, config)))
        want = call.out
        check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
              and int(got[2]) == int(want[2]),
              f"mesh gang {jid}: differs from K7 on the same call")
        rec[("gang", jid)] = gs.calls[0]
        print(f"mesh gang {jid} ({config.mode}, K = {active.shape[0]}, "
              f"g_pad {config.g_pad}): {int((got[0] >= 0).sum())} placed; "
              "choices, scores and slice group equal to K7's")
    return figures, rec


def bench_mesh_programs(torch, np, rec):
    """Holds and times of K10e, K10f, K10g-a and K10g-b on phase 9's own
    calls: the gang programs, the defrag solves (cold, warm), the 512 +
    512 convex eval's relaxation and rounding (B = 1 x K = 1,024) and
    the mesh convex storm's 64 (K = 8, each eval alone: all held, the
    first timed)."""
    from nomad_tpu_torch.parallel import shard

    dev = torch.device("cuda")
    out = {}
    w = MESH_SHARDS

    def rerun(fn, call):
        shards, args, res = call
        return fn([cloned(sh) for sh in shards], *cloned(args))

    # ---- K10e
    for jid in ("g-free", "g-slice-ici", "b-spread"):
        call = rec[("gang", jid)]
        shards, (active, gnoise, cfg), res = call
        label = f"K10e ({jid}, g_pad={cfg.g_pad})"
        got, launches = launches_of("sharded_gang_scan", lambda: rerun(
            shard.sharded_gang_scan, call))
        check(all(torch.equal(a, b) for a, b in zip(got, res)),
              f"{label}: the re-run differs from the recorded call")
        kern = [cloned(sh) for sh in shards]
        plain = [cloned(sh) for sh in shards]
        ch, sc, sg = shard.sharded_gang_scan(kern, active, gnoise, cfg)
        ch_p, sc_p, sg_p = shard.sharded_gang_scan_plain(plain, active,
                                                         gnoise, cfg)
        err = (sc - sc_p).abs().max().item()
        check(torch.equal(ch, ch_p) and int(sg) == int(sg_p)
              and err <= SCORE_TOL,
              f"{label}: differs from the plain version (score error {err})")
        for a, b in zip(kern, plain):
            for name in ("util", "bw_used", "ports_free"):
                check(torch.equal(getattr(a.state, name),
                                  getattr(b.state, name)),
                      f"{label}: final {name} differs")
            check(torch.equal(a.placed, b.placed) and torch.equal(
                a.group_members, b.group_members),
                f"{label}: placed or group members differ")
        n = sum(sh.state.capacity.shape[0] for sh in shards)
        k = active.shape[0]
        box = {}
        setup = lambda: box.update(s=[cloned(sh) for sh in shards])  # noqa
        ms = time_cuda(torch, lambda: shard.sharded_gang_scan(
            box["s"], active, gnoise, cfg), 5 if k > 64 else RUNS,
            setup=setup, warmup=1)
        plain_ms = time_cuda(torch, lambda: shard.sharded_gang_scan_plain(
            box["s"], active, gnoise, cfg), 1, setup=setup, warmup=0)
        chain = chain_ms(torch, k, dev)
        rows = torch.unique(ch[ch >= 0]).numel()
        bytes_ = (n * 73 + 24 + k + k * n * 4 + cfg.g_pad * (4 + 4 * w)
                  + k * 8 + 4 + rows * 28)
        flops = k * n * 60 + n * 20
        print(f"{label}: {int((ch >= 0).sum())} placed; held against the "
              f"plain version (score error {err:.3g}); {launches} launches "
              "a call")
        out.setdefault("sharded_gang_scan", {})[(k, cfg.g_pad)] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms,
            **bound(bytes_, max(flops / FP32_FLOPS, chain / 1000.0)),
            library_ms=None, chain_ms=chain, launches_per_call=launches,
            shards=w)
        torch.cuda.empty_cache()
    # ---- K10f on the defrag rounds' own calls
    for label, call in rec["defrag"].items():
        shards, (iters,), res = call
        got, launches = launches_of("sharded_defrag_solve", lambda: rerun(
            shard.sharded_relax, call))
        check(all(torch.equal(a, b) for o, r in zip(got, res)
                  for a, b in zip(o, r)),
              f"K10f {label}: the re-run differs from the recorded call")
        plain = shard.sharded_relax_plain([cloned(sh) for sh in shards],
                                          iters)
        kinds = ("logits", "x")
        kind_errs, far = hold_outputs(
            f"K10f {label}", [joined(torch, res, i) for i in (0, 1)],
            [joined(torch, plain, i) for i in (0, 1)],
            lambda: [joined(torch, shard.sharded_relax_plain(
                [_double(sh) for sh in shards], iters), i) for i in (0, 1)],
            kinds)
        err = (joined(torch, res, 1) - joined(torch, plain, 1)).abs().max() \
            .item()
        k, n = res[0][0].shape[0], sum(r[0].shape[1] for r in res)
        print(f"K10f {label} (K={k}, N={n}, {iters} iterations, {w} shards): "
              f"x absolute error {err:.3g}; in RELAX_TOLS' terms {kind_errs};"
              f" held by the float64 run {far}; {launches} launches a call")
        box = {}
        setup = lambda: box.update(s=[cloned(sh) for sh in shards])  # noqa
        ms = time_cuda(torch, lambda: shard.sharded_relax(box["s"], iters),
                       RUNS, setup=setup)
        plain_ms = time_cuda(torch, lambda: shard.sharded_relax_plain(
            box["s"], iters), 3, warmup=1, setup=setup)
        bytes_ = k * n * 4 + n * (16 * 3 + 4 * 3 + 1) + k * 29 + 2 * k * n * 4
        out.setdefault("sharded_defrag_solve", {})[(label, k, n)] = dict(
            max_abs_err=err, errs=kind_errs, float64=far, ms=ms,
            plain_ms=plain_ms,
            **bound(bytes_, k * n * (40 + 55 * iters) / FP32_FLOPS),
            library_ms=None,
            pass_bound_ms=iters * 3 * k * n * 4 / HBM_BYTES_S * 1000.0,
            launches_per_call=launches, shards=w)
        torch.cuda.empty_cache()
    # ---- K10g-a and K10g-b on the 512 + 512 eval and the storm
    for key, calls in (("eval", [rec[("eval", 1024)]]),
                       ("storm", rec["storm"])):
        errs, kinds, far, rerrs = [], {}, {}, []
        for rel_call, rnd_call in calls:
            shards, (iters, penalty), res = rel_call
            got, rel_launches = launches_of(
                "sharded_convex_relax",
                lambda: rerun(shard.sharded_relax, rel_call))
            check(all(torch.equal(a, b) for o, r in zip(got, res)
                      for a, b in zip(o, r)),
                  f"K10g-a {key}: the re-run differs from the recorded call")
            plain = shard.sharded_relax_plain(
                [cloned(sh) for sh in shards], iters, penalty)
            kind_errs, kind_far = hold_outputs(
                f"K10g-a {key}", [joined(torch, res, i) for i in range(3)],
                [joined(torch, plain, i) for i in range(3)],
                lambda: [joined(torch, shard.sharded_relax_plain(
                    [_double(sh) for sh in shards], iters, penalty), i)
                    for i in range(3)], ("logits", "x", "pref"))
            errs.append(max((joined(torch, res, i) - joined(torch, plain, i))
                            .abs().max().item() for i in (1, 2)))
            for kind, e in kind_errs.items():
                kinds[kind] = max(kinds.get(kind, 0.0), e)
            for kind, pair in kind_far.items():
                far[kind] = max(far.get(kind, pair), pair)
            rerr, rnd_launches = hold_shards(torch, f"K10g-b {key}",
                                             rnd_call)
            rerrs.append(rerr)
        rel_call, rnd_call = calls[0]
        shards, (iters, penalty), res = rel_call
        b, k, _n = res[0][2].shape
        n = sum(r[2].shape[-1] for r in res)
        g = shards[0].feasible.shape[2]
        print(f"K10g-a ({key}, B={b}, K={k}, N={n}, {w} shards): "
              f"{len(calls)} call(s) held, max x / pref absolute error "
              f"{max(errs):.3g}, in RELAX_TOLS' terms {kinds}; held by the "
              f"float64 run {far}; {rel_launches} launches a call; K10g-b: "
              f"choices and carry equal the plain version's and K8b's, max "
              f"score error {max(rerrs):.3g}; {rnd_launches} launches a call")
        box = {}
        setup = lambda: box.update(s=[cloned(sh) for sh in shards])  # noqa
        ms = time_cuda(torch, lambda: shard.sharded_relax(
            box["s"], iters, penalty), RUNS, setup=setup)
        plain_ms = time_cuda(torch, lambda: shard.sharded_relax_plain(
            box["s"], iters, penalty), 3, warmup=1, setup=setup)
        out.setdefault("sharded_convex_relax", {})[(key, k)] = dict(
            max_abs_err=max(errs), errs=kinds, float64=far, ms=ms,
            plain_ms=plain_ms,
            **bound(relax_bytes(b, n, g, k, 1),
                    relax_flops(b, n, k, iters) / FP32_FLOPS),
            library_ms=None,
            pass_bound_ms=iters * 3 * b * k * n * 4 / HBM_BYTES_S * 1000.0,
            launches_per_call=rel_launches, shards=w, calls_held=len(calls))
        shards, (penalty, *_s), res = rnd_call
        setup = lambda: box.update(s=[cloned(sh) for sh in shards])  # noqa
        ms = time_cuda(torch, lambda: shard.sharded_convex_round(
            box["s"], penalty), 5 if k > 64 else RUNS, setup=setup, warmup=1)
        plain_ms = time_cuda(torch, lambda: shard.sharded_convex_round_plain(
            box["s"], penalty), 1 if k > 64 else 3, warmup=0, setup=setup)
        chain = chain_ms(torch, k, dev)
        rows, cells = rows_written(torch, res[0], shards[0].asks.tg_index, n,
                                   g)
        bytes_ = (n * NODE_BYTES + b * n * (CARRY_ROW_BYTES + 5 * g)
                  + b * k * (ASK_BYTES + 8) + b * (1 + g)
                  + 2 * b * k * n * 4 + rows * CARRY_ROW_BYTES + cells * 4)
        out.setdefault("sharded_convex_round", {})[(key, k)] = dict(
            max_abs_err=max(rerrs), ms=ms, plain_ms=plain_ms,
            **bound(bytes_, max(b * k * n * 85 / FP32_FLOPS,
                                chain / 1000.0)),
            library_ms=None, chain_ms=chain,
            launches_per_call=rnd_launches, shards=w, calls_held=len(calls))
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------- convex

CONVEX_STORM_BATCH = 64
DEFRAG_MOVES = 8
# K8a / K9 against their plain versions (tests/test_torch_cuda.py
# assert_relax_agrees): logits relative to max(1, |logit|), x relative
# to its row's largest entry (a row sums to 1 over N nodes, so at N =
# 10,240 an absolute tolerance would pass a zero), pref absolute (its
# terms are already over their maxima). Past CHAOS_CAP from float64 a
# comparison holds nothing.
RELAX_TOLS = {"logits": 1e-4, "x": 1e-3, "pref": 1e-3}
CHAOS_CAP = 0.1
# The mesh convex eval's pref against the unsharded eval's, both on the
# card (tests/test_torch_convex.py X_TOL): the cross-shard softmax sums
# in another order.
X_TOL = 5e-3


def build_fragmented_cluster(harness, n_nodes):
    """The defrag phase's cluster, tests/test_defrag.py's fragmented
    layout at full width: nodes of 1000 CPU / 1000 MB over dc1/dc2;
    two in five hold one 600/600 alloc of job "dfbig", two in five two
    300/300 allocs (jobs "dfs0", "dfs1"), one in five is empty. Every
    occupied node keeps 400 free, which fits a 300 but strands against
    a 600: consolidating the 300s is a strict fragmentation win. Job
    counts, alloc names and job references are the scheduler's, so a
    wave eval reconciles to the marked moves only."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.structs import Resources, consts

    shapes = {"dfbig": 600, "dfs0": 300, "dfs1": 300}
    jobs = {}
    for jid, size in shapes.items():
        job = mock.job()
        job.id = job.name = jid
        job.datacenters = ["dc1", "dc2"]
        job.task_groups[0].count = 2 * n_nodes // 5
        task = job.task_groups[0].tasks[0]
        task.resources.cpu = task.resources.memory_mb = size
        task.resources.networks = []
        harness.state.upsert_job(harness.next_index(), job)
        jobs[jid] = harness.state.job_by_id(jid)
    slot = Counter()
    allocs = []
    for i in range(n_nodes):
        node = mock.node()
        node.datacenter = ("dc1", "dc2")[i % 2]
        node.resources.cpu = node.resources.memory_mb = 1000
        node.reserved = None
        node.compute_class()
        harness.state.upsert_node(harness.next_index(), node)
        for jid in {0: ("dfbig",), 1: ("dfbig",), 2: ("dfs0", "dfs1"),
                    3: ("dfs0", "dfs1")}.get(i % 5, ()):
            job = jobs[jid]
            a = mock.alloc()
            a.job, a.job_id, a.node_id = job, jid, node.id
            a.name = f"{jid}.{job.task_groups[0].name}[{slot[jid]}]"
            a.task_group = job.task_groups[0].name
            slot[jid] += 1
            a.resources = None
            a.shared_resources = None
            a.task_resources = {job.task_groups[0].tasks[0].name: Resources(
                cpu=shapes[jid], memory_mb=shapes[jid])}
            a.desired_status = consts.ALLOC_DESIRED_RUN
            a.client_status = consts.ALLOC_CLIENT_RUNNING
            allocs.append(a)
    harness.state.upsert_allocs(harness.next_index(), allocs)


def run_convex(seed, torch, total, main_h, storm_h):
    """Phase 8 (see the module docstring). Returns the recorded K8a,
    K8b and K9 calls for phase 7's holds."""
    import numpy as np

    from nomad_tpu_torch.defrag import (
        WarmState,
        build_wave_evals,
        compute_defrag_plan,
    )
    from nomad_tpu_torch.kernels import convex, quality
    from nomad_tpu_torch.kernels.differential import (
        DEFAULT_SEEDS,
        judge_migration_plan,
        run_defrag_differential,
        run_differential,
        run_gang_differential,
    )
    from nomad_tpu_torch.scheduler import new_scheduler
    from nomad_tpu_torch.scheduler.batcher import get_batcher
    from nomad_tpu_torch.structs import consts
    from nomad_tpu_torch.structs.eval import new_eval

    rec = {}
    # ---- a. service-convex-gpu on the main path's cluster, beside a
    # greedy arm on the same state (dry run) for the quality board.
    h = main_h
    board = quality.get_board()
    board.reset()
    steps = [("config 4 job (K = 8, ports + distinct_hosts)",
              storm_job("convex-star"), 8),
             ("512 + 512 two-group job (K = 1,024)",
              two_group_job_id("convex-two", 512), 1024)]
    for label, job, expect in steps:
        h.state.upsert_job(h.next_index(), job)
        ev = new_eval(h.state.job_by_id(job.id),
                      consts.EVAL_TRIGGER_JOB_REGISTER)
        existing = {a.id for a in h.state.allocs_by_job(job.id)}
        host_n = host_oracle_count(h.state, ev, seed, existing)
        arms = {"greedy": [], "convex": []}
        # Dry runs on the same state, in turns (the first pays the base
        # build): greedy, convex, convex, greedy.
        for kernel in ("greedy", "convex", "convex", "greedy"):
            planner = _DryRunPlanner()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            new_scheduler(f"service-{kernel}-gpu",
                          logging.getLogger("smoke.ab"), h.state.snapshot(),
                          planner, rng=random.Random(seed)).process_eval(
                              ev.copy())
            torch.cuda.synchronize()
            placed = sum(len(new_allocs(p, existing)) for p in planner.plans)
            check(placed == host_n, f"{label}: {kernel} arm placed {placed}")
            arms[kernel].append(round((time.perf_counter() - t0) * 1000.0, 1))
        print(f"eval {label}, dry runs on the same state (ms, in turns): "
              f"greedy {arms['greedy']}, convex {arms['convex']}")
        n_plans = len(h.plans)
        with Recorder(convex, "relaxed_pref") as rel, \
                Recorder(convex, "convex_round") as rnd:
            share = device_share(torch, lambda: counted(
                total, f"convex eval, {label}",
                ("threefry_uniform", "convex_relax", "convex_round"),
                lambda: h.process("service-convex-gpu", ev)),
                f"convex eval, {label}")
        check(len(h.plans) == n_plans + 1, f"{label}: no plan submitted")
        plan = h.plans[-1]
        fresh = new_allocs(plan, existing)
        print(f"convex eval, {label}: placed {len(fresh)} (host oracle "
              f"{host_n}), {share['profiled_wall_ms']:.1f} ms under the "
              "profiler")
        check(len(fresh) == host_n == expect,
              f"{label}: convex placed {len(fresh)}, host {host_n}")
        check(h.evals[-1].status == consts.EVAL_STATUS_COMPLETE,
              f"{label}: eval status {h.evals[-1].status}")
        check_placements(h.state, h.state.job_by_id(job.id), plan)
        if expect == 8:
            check(len({a.node_id for a in fresh}) == 8,
                  f"{label}: distinct_hosts violated")
        check(len(rel.calls) == len(rnd.calls) == 1,
              f"{label}: {len(rel.calls)} relaxations")
        rec[("eval", expect)] = (rel.calls[0], rnd.calls[0])
    # ---- e. the quality board's medians, greedy and convex arms
    medians = board.snapshot()["kernels"]
    for kernel in ("greedy", "convex"):
        q = medians.get(kernel)
        check(q is not None and q["samples"] >= 4,
              f"quality board: {kernel} arm {q}")
        print(f"quality board, {kernel}: fragmentation median "
              f"{q['fragmentation']}, binpack_score median "
              f"{q['binpack_score']} ({q['samples']} evals)")
    # ---- b. a convex storm under pre_resolve on the storm's cluster
    storm = Storm(storm_h, get_batcher())
    conv = lambda job, m: placement_config(job, m, True, "convex")  # noqa
    try:
        jobs = storm.jobs("convex", CONVEX_STORM_BATCH, storm_job)
        with Recorder(convex, "relaxed_pref") as rel, \
                Recorder(convex, "convex_round") as rnd:
            rows, results, plans, lat, wall = counted(
                total, "convex storm", (
                    "threefry_uniform", "expand_overlay", "convex_relax",
                    "convex_round_seq"),
                lambda: storm.round(jobs, 130_000, conv))
    finally:
        storm.close()
    placed = sum(len(a) for p in plans for a in p.node_allocation.values())
    conflicted = conflicted_evals(rows, results)
    print(f"convex storm: {CONVEX_STORM_BATCH} evals of config 4's job "
          f"(pre_resolve) in {wall:.3f} s = "
          f"{CONVEX_STORM_BATCH / wall:.2f} evals/s; per-eval p50 "
          f"{np.percentile(lat, 50) * 1000:.2f} ms, p99 "
          f"{np.percentile(lat, 99) * 1000:.2f} ms; {placed} placed; "
          f"conflicted evals: {conflicted}")
    check_placed("convex storm", results, placed, CONVEX_STORM_BATCH * 8)
    check(conflicted == 0, f"convex storm: {conflicted} conflicted evals")
    check(len(rel.calls) == len(rnd.calls) == CONVEX_STORM_BATCH,
          f"convex storm: {len(rel.calls)} relaxations")
    rec["storm"] = list(zip(rel.calls, rnd.calls))
    storm = Storm(storm_h, get_batcher())
    try:
        more = storm.jobs("convex-p", CONVEX_STORM_BATCH, storm_job)
        device_share(torch, lambda: storm.round(more, 140_000, conv),
                     "convex storm round (64 evals, pre_resolve on)")
    finally:
        storm.close()
    # ---- c. the oracle differential rig on the card
    for label, fn, names in (
            ("convex", lambda: run_differential("convex"),
             ("convex_relax", "convex_round")),
            ("greedy", lambda: run_differential(
                "greedy", list(DEFAULT_SEEDS)[:3]), ("threefry_uniform",)),
            ("gangs", run_gang_differential, ("gang_scan",)),
            ("defrag waves", run_defrag_differential, ("defrag_solve",))):
        t0 = time.perf_counter()
        report = counted(total, f"rig: {label}", names, fn)
        print(f"rig, {label}: {report['cases']} cases, green "
              f"{report['green']} ({time.perf_counter() - t0:.1f} s)")
        check(report["green"], f"rig {label}: {report['violations'][:3]}")
    # ---- d. defrag at full width. The main path's cluster has nothing
    # to defragment (every node's free space fits every ask there), so
    # this phase builds its own fragmented layout at the same width.
    from nomad_tpu_torch.scheduler.testing import Harness

    t0 = time.perf_counter()
    frag_h = Harness(seed=seed + 8)
    build_fragmented_cluster(frag_h, N_NODES)
    print(f"defrag cluster: {N_NODES} nodes, {len(frag_h.state.allocs())} "
          f"allocs, built in {time.perf_counter() - t0:.1f} s (host)")
    warm = WarmState()
    dcs = ["dc1", "dc2"]
    plans = {}
    with Recorder(convex, "defrag_solve") as sol:
        for label, compress in (("cold", False), ("warm", False),
                                ("compressed cold", None),
                                ("compressed warm", None)):
            plan = counted(
                total, f"defrag solve, {label}", ("defrag_solve",),
                lambda: compute_defrag_plan(
                    frag_h.state.snapshot(), dcs, max_moves=DEFRAG_MOVES,
                    min_gain=0.0, warm=warm, class_compress=compress))
            plans[label] = plan
            width = (f"{plan.classes} classes" if plan.compressed
                     else f"{plan.n} nodes")
            print(f"defrag {label}: K = {plan.k} over {width}, "
                  f"{plan.movable} movable, warm {plan.warm} "
                  f"({plan.carried} carried), {plan.candidates} candidates, "
                  f"{len(plan.moves)} moves, fragmentation "
                  f"{plan.frag_before:.6f} -> {plan.frag_after:.6f}, "
                  f"round {plan.solve_ms:.1f} ms (host)")
            check(plan.frag_after <= plan.frag_before,
                  f"defrag {label}: fragmentation rose")
            check(plan.warm == label.endswith("warm"),
                  f"defrag {label}: warm {plan.warm}")
    check(plans["cold"].k == 512 and plans["cold"].n == BENCH_N,
          f"defrag cold: K = {plans['cold'].k}, N = {plans['cold'].n}")
    check(plans["compressed cold"].compressed, "no compressed solve")
    check(len(sol.calls) == 4, f"{len(sol.calls)} defrag solves")
    rec["defrag"] = dict(zip(plans, sol.calls))
    moves = plans["warm"].moves
    snap = frag_h.state.snapshot()
    evals = build_wave_evals(snap, moves)
    judged = 0

    def waves():
        nonlocal judged
        for ev in evals:
            ev_snap = frag_h.state.snapshot()
            seen = len(frag_h.plans)
            frag_h.process("service-gpu", ev)
            for wave_plan in frag_h.plans[seen:]:
                bad = judge_migration_plan(ev_snap, wave_plan)
                check(not bad, f"defrag wave plan: {bad[:3]}")
                judged += 1

    check(moves, "defrag found no move")
    t0 = time.perf_counter()
    # The wave evals' placements may take the host iterators (3 or fewer
    # a job): no kernel is required here.
    counted(total, "defrag waves", (), waves)
    for mv in moves:
        stored = frag_h.state.alloc_by_id(mv.alloc_id)
        check(stored.desired_status in (consts.ALLOC_DESIRED_STOP,
                                        consts.ALLOC_DESIRED_EVICT),
              f"moved alloc {mv.alloc_id} not stopped")
    print(f"defrag wave: {len(moves)} moves in {len(evals)} evals through "
          f"service-gpu, {judged} plans judged by judge_migration_plan "
          f"(clean) in {time.perf_counter() - t0:.1f} s")
    rec["frag_h"] = frag_h
    return rec


def relax_bytes(b, n, g, k, outputs):
    """Node rows, the carry, the counts and feasibility, every ask, read
    once; ``outputs`` [B,K,N] f32 arrays written once."""
    return (n * NODE_BYTES + b * n * (CARRY_ROW_BYTES + 5 * g)
            + b * k * ASK_BYTES + b * (1 + g) + outputs * b * k * n * 4)


def relax_flops(b, n, k, iters):
    """A prologue of ~40 flops a pair (two pow), then per iteration ~55
    a pair (two exp, the six contractions and the gradient)."""
    return b * k * n * (40 + 55 * iters)


def relax_err(got, want, kind):
    """The largest error of a K8a / K9 output in RELAX_TOLS' terms."""
    got, want = got.double(), want.double()
    err = (got - want).abs()
    if kind == "logits":
        err = err / want.abs().clamp(min=1.0)
    elif kind == "x":
        err = err / want.abs().amax(-1, keepdim=True).clamp(min=1e-30)
    return err.max().item()


def hold_outputs(label, got, plain, plain64, kinds):
    """Each output within RELAX_TOLS of the plain version, or, where
    float32 rounding moves the sums (a chaotic instance), no farther
    from the float64 run (``plain64()``) than 10x the plain version's
    own distance, a bound under CHAOS_CAP. Returns ({kind: error},
    {kind: (the kernel's, the plain version's distance from float64)}
    for the outputs held so)."""
    errs, far, p64 = {}, {}, None
    for g, p, kind in zip(got, plain, kinds):
        errs[kind] = err = relax_err(g, p, kind)
        if err <= RELAX_TOLS[kind]:
            continue
        p64 = p64 or plain64()
        q = p64[kinds.index(kind)]
        far[kind] = (relax_err(g, q, kind), relax_err(p, q, kind))
        bound = 10 * far[kind][1] + 1e-5
        check(bound < CHAOS_CAP and far[kind][0] <= bound,
              f"{label}: {kind} error {err}, float64 distance "
              f"{far[kind][0]}, bound {bound}")
    return errs, far


def _double(x):
    """Float tensors, alone or in (named) tuples, as float64."""
    if isinstance(x, tuple):
        items = [_double(i) for i in x]
        return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
    if hasattr(x, "dtype") and x.dtype.is_floating_point:
        return x.double()
    return x


def hold_relax(torch, label, call):
    """K8a on a recorded ``relaxed_pref`` call: the full launch on the
    call's inputs (logits, x and pref) gives the call's pref bit for
    bit and agrees with the plain version (hold_outputs). Returns
    (hold_outputs' two dicts, the largest absolute error of x and
    pref, the plain version's pref)."""
    from nomad_tpu_torch.kernels import convex

    args = cloned(call.inputs)
    got = convex.relaxed_assignment(*cloned(call.inputs))
    check(torch.equal(got[2], call.out),
          f"{label}: the full launch's pref differs from the path's")
    plain = convex.relaxed_assignment_plain(*args)
    errs, far = hold_outputs(
        label, got, plain,
        lambda: convex.relaxed_assignment_plain(*_double(args)),
        ("logits", "x", "pref"))
    abs_err = max((g - p).abs().max().item()
                  for g, p in zip(got[1:], plain[1:]))
    return (errs, far), abs_err, plain[2]


def hold_round(torch, label, call, pref):
    """K8b on a recorded call, fed the plain relaxation's pref, against
    its plain version fed the same: choices and carry equal, scores
    within SCORE_TOL. Returns (score error, the call's inputs with that
    pref)."""
    from nomad_tpu_torch.kernels import convex

    args = list(cloned(call.inputs))
    args[9] = pref
    k_args, p_args = cloned(tuple(args)), cloned(tuple(args))
    out_k = convex.convex_round(*k_args)
    out_p = convex.convex_round_plain(*p_args)
    err = check_scan(torch, label, (*out_k, k_args[4]), (*out_p, p_args[4]))
    return err, tuple(args)


def bench_convex(torch, np, rec):
    """Phase 7's holds and times for K8a, K8b and K9 on phase 8's own
    calls: the 512 + 512 eval (K = 1,024, N = 10,240), the convex storm
    (64 evals of K = 8 under seq, all held, the first timed), and the
    defrag solves (cold and warm at K = 512 x N = 10,240, and at the
    compressed width)."""
    from nomad_tpu_torch.kernels import convex

    dev = torch.device("cuda")
    out = {}

    # ---- K8a and K8b on the K = 1,024 eval and the storm
    for key, calls, name_round in (
            ("eval", [rec[("eval", 1024)]], "convex_round"),
            ("storm", rec["storm"], "convex_round_seq")):
        errs, kinds, far, rerrs = [], {}, {}, []
        held = []
        for rel_call, rnd_call in calls:
            (kind_errs, kind_far), err, pref = hold_relax(
                torch, f"K8a {key}", rel_call)
            rerr, args = hold_round(torch, f"K8b {key}", rnd_call, pref)
            errs.append(err)
            for kind, e in kind_errs.items():
                kinds[kind] = max(kinds.get(kind, 0.0), e)
            for kind, pair in kind_far.items():
                far[kind] = max(far.get(kind, pair), pair)
            rerrs.append(rerr)
            held.append(args)
        rel_call, rnd_call = calls[0]
        static = rel_call.inputs[:4]
        feas = rel_call.inputs[5]
        b, n, g = feas.shape
        k = rel_call.inputs[6].resources.shape[1]
        print(f"K8a ({key}, B={b}, K={k}, N={n}): {len(calls)} call(s) held, "
              f"max x / pref absolute error {max(errs):.3g}, in "
              f"RELAX_TOLS' terms {kinds}; held by the float64 run "
              f"(kernel's, plain's distance) {far}; K8b: choices and "
              f"carry equal, max score error {max(rerrs):.3g}")
        box = {}
        ms = time_cuda(torch, lambda: convex.relaxed_pref(*box["a"]),
                       RUNS, setup=lambda: box.update(
                           a=cloned(rel_call.inputs)))
        plain_ms = time_cuda(
            torch, lambda: convex.relaxed_assignment_plain(*box["a"]), 3,
            warmup=1, setup=lambda: box.update(a=cloned(rel_call.inputs)))
        it = convex.SOLVE_ITERS
        bytes_ = relax_bytes(b, n, g, k, 1)
        out.setdefault("convex_relax", {})[(key, k)] = dict(
            max_abs_err=max(errs), errs=kinds, float64=far, ms=ms,
            plain_ms=plain_ms,
            **bound(bytes_, relax_flops(b, n, k, it) / FP32_FLOPS),
            library_ms=None,
            pass_bound_ms=it * 3 * b * k * n * 4 / HBM_BYTES_S * 1000.0,
            calls_held=len(calls))
        args = held[0]
        ms = time_cuda(torch, lambda: convex.convex_round(*box["a"]), RUNS,
                       setup=lambda: box.update(a=cloned(args)))
        plain_ms = time_cuda(
            torch, lambda: convex.convex_round_plain(*box["a"]),
            1 if k > 64 else 3, warmup=1,
            setup=lambda: box.update(a=cloned(args)))
        chain = chain_ms(torch, k, dev)
        ch = rnd_call.out[0]
        rows, cells = rows_written(torch, ch, args[6].tg_index, n, g)
        bytes_ = (n * NODE_BYTES + b * n * (CARRY_ROW_BYTES + 5 * g)
                  + b * k * (ASK_BYTES + 8) + b * (1 + g)
                  + 2 * b * k * n * 4 + rows * CARRY_ROW_BYTES + cells * 4)
        flops = b * k * n * (60 + 25)  # K1's step + bias and strand term
        out.setdefault(name_round, {})[(key, k)] = dict(
            max_abs_err=max(rerrs), ms=ms, plain_ms=plain_ms,
            **bound(bytes_, max(flops / FP32_FLOPS, chain / 1000.0)),
            library_ms=None, chain_ms=chain, calls_held=len(calls))
        torch.cuda.empty_cache()
    # ---- K9 on the defrag rounds' own calls
    for label, call in rec["defrag"].items():
        args = cloned(call.inputs)
        plain = convex.defrag_solve_plain(*args)
        kind_errs, far = hold_outputs(
            f"K9 {label}", call.out, plain,
            lambda: convex.defrag_solve_plain(*_double(args)),
            ("logits", "x"))
        err = (call.out[1] - plain[1]).abs().max().item()
        k, w = args[0].shape
        iters = args[-1]
        print(f"K9 {label} (K={k}, W={w}, {iters} iterations): x absolute "
              f"error {err:.3g}; logits relative error "
              f"{kind_errs['logits']:.3g}, x over its row maximum "
              f"{kind_errs['x']:.3g}; held by the float64 run {far}")
        box = {}
        ms = time_cuda(torch, lambda: convex.defrag_solve(*box["a"]), RUNS,
                       setup=lambda: box.update(a=cloned(call.inputs)))
        plain_ms = time_cuda(
            torch, lambda: convex.defrag_solve_plain(*box["a"]), 3, warmup=1,
            setup=lambda: box.update(a=cloned(call.inputs)))
        # logits0 and the W rows and asks read once; logits and x out.
        bytes_ = k * w * 4 + w * (16 * 3 + 4 * 3 + 1) + k * 29 + 2 * k * w * 4
        out.setdefault("defrag_solve", {})[(label, k, w)] = dict(
            max_abs_err=err, errs=kind_errs, float64=far, ms=ms,
            plain_ms=plain_ms,
            **bound(bytes_, k * w * (40 + 55 * iters) / FP32_FLOPS),
            library_ms=None,
            pass_bound_ms=iters * 3 * k * w * 4 / HBM_BYTES_S * 1000.0)
        torch.cuda.empty_cache()
    return out


REPLACES = {
    "threefry_uniform": ("nomad_tpu_torch/csrc/threefry.cu",
                         "nomad_tpu/ops/binpack.py:384"),
    "greedy_scan": ("nomad_tpu_torch/csrc/greedy_scan.cu",
                    "nomad_tpu/ops/binpack.py:360"),
    "uniform_topk": ("nomad_tpu_torch/csrc/uniform_topk.cu",
                     "nomad_tpu/ops/binpack.py:302"),
    "expand_overlay": ("nomad_tpu_torch/csrc/expand_overlay.cu",
                       "nomad_tpu/ops/binpack.py:533"),
    "base_delta": ("nomad_tpu_torch/csrc/base_delta.cu",
                   "nomad_tpu/ops/binpack.py:192"),
    "greedy_scan_seq": ("nomad_tpu_torch/csrc/greedy_scan.cu",
                        "nomad_tpu/ops/binpack.py:461"),
    "uniform_topk_seq": ("nomad_tpu_torch/csrc/uniform_topk.cu",
                         "nomad_tpu/ops/binpack.py:548"),
    "greedy_scan_stacked": ("nomad_tpu_torch/csrc/greedy_scan.cu",
                            "nomad_tpu/ops/binpack.py:424"),
    "uniform_topk_stacked": ("nomad_tpu_torch/csrc/uniform_topk.cu",
                             "nomad_tpu/ops/binpack.py:424"),
    "preempt_scan": ("nomad_tpu_torch/csrc/preempt_scan.cu",
                     "nomad_tpu/ops/preempt.py:85"),
    "gang_scan": ("nomad_tpu_torch/csrc/gang_scan.cu",
                  "nomad_tpu/ops/gang.py:150"),
    "convex_relax": ("nomad_tpu_torch/csrc/convex_relax.cu",
                     "nomad_tpu/kernels/convex.py:136"),
    "convex_round": ("nomad_tpu_torch/csrc/convex_round.cu",
                     "nomad_tpu/kernels/convex.py:224"),
    "convex_round_seq": ("nomad_tpu_torch/csrc/convex_round.cu",
                         "nomad_tpu/ops/binpack.py:461"),
    "defrag_solve": ("nomad_tpu_torch/csrc/convex_relax.cu",
                     "nomad_tpu/defrag/solver.py:213"),
    "sharded_base_delta": ("nomad_tpu_torch/csrc/base_delta.cu",
                           "nomad_tpu/parallel/shard.py:72"),
    "group_capacity": ("nomad_tpu_torch/csrc/group_capacity.cu",
                       "nomad_tpu/parallel/shard.py:109"),
    "sharded_greedy_scan": ("nomad_tpu_torch/csrc/sharded_scan.cu",
                            "nomad_tpu/parallel/mesh.py:212"),
    "sharded_uniform_topk": ("nomad_tpu_torch/csrc/sharded_topk.cu",
                             "nomad_tpu/ops/binpack.py:302"),
    "sharded_gang_scan": ("nomad_tpu_torch/csrc/sharded_gang.cu",
                          "nomad_tpu/parallel/mesh.py:175"),
    "sharded_defrag_solve": ("nomad_tpu_torch/csrc/sharded_relax.cu",
                             "nomad_tpu/parallel/mesh.py:201"),
    "sharded_convex_relax": ("nomad_tpu_torch/csrc/sharded_relax.cu",
                             "nomad_tpu/kernels/convex.py:136"),
    "sharded_convex_round": ("nomad_tpu_torch/csrc/sharded_scan.cu",
                             "nomad_tpu/kernels/convex.py:224"),
}
# The shape each kernel's JSON record leads with (the others ride
# along under "shapes").
PRIMARY = {"threefry_uniform": 1, "greedy_scan": 1, "uniform_topk": 1,
           "expand_overlay": 1, "base_delta": 256,
           "greedy_scan_seq": (4, 1024), "uniform_topk_seq": 64,
           "greedy_scan_stacked": 4, "uniform_topk_stacked": 4,
           "preempt_scan": 1024, "gang_scan": (1024, 256),
           "convex_relax": ("eval", 1024), "convex_round": ("eval", 1024),
           "convex_round_seq": ("storm", 8),
           "defrag_solve": ("cold", 512, BENCH_N),
           "sharded_base_delta": 256, "group_capacity": BENCH_N,
           "sharded_greedy_scan": (1, BENCH_K), "sharded_uniform_topk": 64,
           "sharded_gang_scan": (1024, 256),
           "sharded_defrag_solve": ("cold", 512, BENCH_N),
           "sharded_convex_relax": ("eval", 1024),
           "sharded_convex_round": ("eval", 1024)}


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

        total = Counter()
        counts, _lat_ms, main_h = run_main_path(args.seed, torch)
        total.update(counts)
        storm, storm_h = run_storm(args.seed, torch, total)
        print(f"storm figures: {json.dumps(storm, sort_keys=True)}")
        k6 = run_preemption(args.seed, torch, total)
        gangs, gang_programs = run_gangs(args.seed, torch, total)
        convex_calls = run_convex(args.seed, torch, total, main_h, storm_h)
        mesh_figures, mesh_calls = run_mesh(args.seed, torch, total, storm_h)
        more, more_calls = run_mesh_programs(
            args.seed, torch, total, main_h, storm_h,
            convex_calls.pop("frag_h"), gang_programs)
        mesh_figures.update(more)
        print(f"mesh figures: {json.dumps(mesh_figures, sort_keys=True)}")
        del main_h, storm_h
        results = bench_kernels(torch, np, args.seed)
        results.update(bench_new_kernels(torch, np, args.seed))
        results.update(bench_legs(torch, k6, gangs))
        results.update(bench_convex(torch, np, convex_calls))
        results.update(bench_mesh(torch, np, mesh_calls))
        results.update(bench_mesh_programs(torch, np, more_calls))
        torch.cuda.synchronize()
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1

    print(f"launches on the main paths: {json.dumps(total, sort_keys=True)}")
    kernels = []
    for name, shapes in results.items():
        src, replaces = REPLACES[name]
        lead = shapes[PRIMARY[name]]
        for shape, r in shapes.items():
            print(f"{name} {shape}: {r['ms']:.4f} ms (plain "
                  f"{r['plain_ms']:.4f}, bound {r['bound_ms']:.6f} by "
                  f"{r['bound_by']}, library {r['library_ms']})")
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": total.get(name, 0),
            **lead, "shape": str(PRIMARY[name]),
            "shapes": {str(k): v for k, v in shapes.items()
                       if k != PRIMARY[name]},
        })
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
