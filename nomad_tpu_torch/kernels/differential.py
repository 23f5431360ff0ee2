"""Oracle differential rig: any registered placement kernel against
the sequential host oracle — the port of the JAX package's
kernels/differential.py.

The validity contract (kernels/__init__.py): a placement kernel may
trade placement QUALITY but never VALIDITY. For a spread of seeded
randomized clusters (mixed resource shapes, pre-existing load,
datacenter/rack constraints, distinct-hosts, drained nodes) the rig
runs one evaluation through the kernel-under-test's scheduler factory
(``service-<kernel>-gpu`` / ``batch-<kernel>-gpu`` — the registry seam
production selection uses) on the scheduler test Harness, then has the
ORACLE judge every placement the kernel emitted:

- **plan-apply accepted** — ``server.plan_apply.evaluate_node_plan``
  (the applier's per-node verification) must accept every node the
  plan touches against the pre-eval snapshot;
- **capacity never exceeded** — ``allocs_fit`` over each node's
  proposed set;
- **feasibility** — every chosen node individually passes the HOST
  iterator stack (``GenericStack.select`` pinned to that node);
- **distinct-hosts honored**, counting pre-existing live allocs;
- the eval itself completes.

Count parity with the oracle is deliberately NOT asserted: that is the
quality axis (kernels/quality.py), not validity. The rig also judges
migration plans (defrag waves: ``judge_migration_plan``,
``run_defrag_differential``) and gang plans (all-or-nothing:
``judge_gang_plan``, ``run_gang_differential``).
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional

DEFAULT_SEEDS = range(7000, 7012)


def build_scenario(seed: int):
    """(seed_state_fn, job) for one rig case. Counts stay >= 4 so the
    dense bulk path engages (the dense schedulers route <= 3
    placements to the host iterators — a rig case that never reached
    the kernel would vacuously pass)."""
    from .. import mock
    from ..structs import Constraint, consts

    rng = random.Random(seed)
    n_nodes = rng.choice([6, 9, 17, 33])
    dc_count = rng.choice([1, 2])
    use_networks = rng.random() < 0.4
    use_racks = rng.random() < 0.5
    distinct = rng.random() < 0.4
    preload = rng.random() < 0.5
    drain_frac = rng.choice([0.0, 0.0, 0.2, 0.4])
    job_type = rng.choice(["service", "batch"])
    count = rng.choice([4, 6, 11, 24])
    cpu = rng.choice([100, 333, 900])
    mem = rng.choice([64, 300, 700])

    nodes = []
    for i in range(n_nodes):
        node = mock.node()
        node.datacenter = f"dc{i % dc_count + 1}"
        if use_racks:
            node.meta["rack"] = f"r{i % 4}"
        if i % 3 == 0:  # heterogeneous capacity: some nodes half-size
            node.resources.cpu //= 2
            node.resources.memory_mb //= 2
        node.compute_class()
        nodes.append(node)
    drained = [n.id for n in nodes[: int(n_nodes * drain_frac)]]

    filler_allocs = []
    if preload:
        filler = mock.job()
        filler.id = "filler"
        for i, node in enumerate(nodes):
            if i % 2:
                continue
            a = mock.alloc()
            a.node_id, a.job_id, a.job = node.id, filler.id, filler
            a.desired_status = consts.ALLOC_DESIRED_RUN
            a.client_status = consts.ALLOC_CLIENT_RUNNING
            for tr in a.task_resources.values():
                tr.cpu = rng.choice([200, 700])
                tr.memory_mb = rng.choice([128, 512])
                tr.networks = []
            a.resources = None
            filler_allocs.append(a)

    def seed_state(h, job):
        # All store writes route through the fixture funnel
        # (scheduler/testing.py seed_harness_cluster): kernels/ never
        # touches the state store directly.
        from ..scheduler.testing import seed_harness_cluster

        seed_harness_cluster(h, nodes=nodes, allocs=filler_allocs,
                             jobs=[job.copy()], drained=drained)

    job = mock.job()
    job.type = job_type
    job.datacenters = [f"dc{d + 1}" for d in range(dc_count)]
    tg = job.task_groups[0]
    tg.count = count
    task = tg.tasks[0]
    task.resources.cpu = cpu
    task.resources.memory_mb = mem
    if not use_networks:
        task.resources.networks = []
    if use_racks and rng.random() < 0.5:
        job.constraints.append(Constraint(
            ltarget="${meta.rack}", operand="regexp", rtarget="^r[01]$"))
    if distinct:
        job.constraints.append(
            Constraint(operand=consts.CONSTRAINT_DISTINCT_HOSTS))
    return seed_state, job


def _oracle_feasible(snap, job, tg, node) -> bool:
    """The HOST feasibility chain's verdict on one node for one task
    group: a fresh single-node iterator stack must yield it."""
    from ..scheduler.context import EvalContext
    from ..scheduler.stack import GenericStack
    from ..structs import Plan

    ctx = EvalContext(snap, Plan(job=job), rng=random.Random(0))
    stack = GenericStack(job.type == "batch", ctx)
    stack.set_job(job)
    stack.set_nodes([node])
    option, _ = stack.select(tg)
    return option is not None


def _check_case(kernel: str, seed: int) -> List[str]:
    """Run one rig case; returns the list of violation strings."""
    from ..scheduler.testing import Harness
    from ..server.plan_apply import evaluate_node_plan
    from ..structs import allocs_fit, consts, new_eval, remove_allocs

    seed_state, job = build_scenario(seed)
    factory = f"{job.type}-{kernel}-gpu"

    h = Harness(seed=seed)
    seed_state(h, job)
    snap = h.state.snapshot()
    h.process(factory, new_eval(
        h.state.job_by_id(job.id), consts.EVAL_TRIGGER_JOB_REGISTER))

    bad: List[str] = []
    if not h.evals or h.evals[-1].status != consts.EVAL_STATUS_COMPLETE:
        status = h.evals[-1].status if h.evals else "<none>"
        bad.append(f"seed {seed}: eval did not complete ({status})")

    job_dh = any(c.operand == consts.CONSTRAINT_DISTINCT_HOSTS
                 for c in job.constraints)
    tg_by_name = {tg.name: tg for tg in job.task_groups}
    for plan in h.plans:
        for node_id, placed in plan.node_allocation.items():
            node = snap.node_by_id(node_id)
            if node is None:
                bad.append(f"seed {seed}: placed on unknown node "
                           f"{node_id}")
                continue
            # Plan-apply acceptance: the live applier's verification.
            if not evaluate_node_plan(snap, plan, node_id):
                bad.append(f"seed {seed}: plan-apply rejected node "
                           f"{node_id}")
            # Capacity: proposed set must fit (the applier's AllocsFit,
            # spelled out so the failing dimension is named).
            existing = snap.allocs_by_node_terminal(node_id, False)
            updates = plan.node_update.get(node_id, [])
            proposed = remove_allocs(existing, updates) + placed
            for a in proposed:
                if a.job is None:
                    a.job = plan.job
            fit, dim, _ = allocs_fit(node, proposed)
            if not fit:
                bad.append(f"seed {seed}: capacity exceeded on "
                           f"{node_id}: {dim}")
            # Oracle feasibility + distinct-hosts per placement.
            this_job_live = [
                a for a in existing
                if a.job_id == job.id and not a.terminal_status()]
            for alloc in placed:
                tg = tg_by_name.get(alloc.task_group)
                if tg is None:
                    bad.append(f"seed {seed}: alloc names unknown task "
                               f"group {alloc.task_group!r}")
                    continue
                if not _oracle_feasible(snap, job, tg, node):
                    bad.append(
                        f"seed {seed}: oracle rejects node {node_id} "
                        f"for tg {tg.name} (kernel placed there)")
                tg_dh = any(
                    c.operand == consts.CONSTRAINT_DISTINCT_HOSTS
                    for c in tg.constraints)
                if job_dh and (len(placed) + len(this_job_live)) > 1:
                    bad.append(f"seed {seed}: distinct_hosts (job) "
                               f"violated on {node_id}")
                    break
                if tg_dh:
                    same_tg = ([a for a in placed
                                if a.task_group == tg.name]
                               + [a for a in this_job_live
                                  if a.task_group == tg.name])
                    if len(same_tg) > 1:
                        bad.append(f"seed {seed}: distinct_hosts (tg "
                                   f"{tg.name}) violated on {node_id}")
                        break
    return bad


def _oracle_placed(seed: int) -> int:
    """The sequential oracle's placed count on the identical cluster
    (report context, not an assertion)."""
    from ..scheduler.testing import Harness
    from ..structs import consts, new_eval

    seed_state, job = build_scenario(seed)
    h = Harness(seed=seed)
    seed_state(h, job)
    h.process(job.type, new_eval(
        h.state.job_by_id(job.id), consts.EVAL_TRIGGER_JOB_REGISTER))
    return len(h.state.allocs_by_job(job.id))


def run_differential(kernel: str, seeds=DEFAULT_SEEDS,
                     with_oracle_counts: bool = False) -> Dict:
    """Run the rig for one kernel across `seeds`. Returns a report:
    {"kernel", "cases", "violations": [...], "green": bool,
     "placed": {seed: (kernel_placed, oracle_placed)}? }."""
    from ..scheduler.testing import Harness  # noqa: F401 (fail fast on import)

    violations: List[str] = []
    placed: Dict[int, tuple] = {}
    for seed in seeds:
        violations.extend(_check_case(kernel, seed))
        if with_oracle_counts:
            from ..structs import consts, new_eval

            seed_state, job = build_scenario(seed)
            h = Harness(seed=seed)
            seed_state(h, job)
            h.process(f"{job.type}-{kernel}-gpu", new_eval(
                h.state.job_by_id(job.id),
                consts.EVAL_TRIGGER_JOB_REGISTER))
            placed[seed] = (len(h.state.allocs_by_job(job.id)),
                            _oracle_placed(seed))
    report = {
        "kernel": kernel,
        "cases": len(list(seeds)),
        "violations": violations,
        "green": not violations,
    }
    if with_oracle_counts:
        report["placed"] = placed
    return report


def assert_differential(kernel: str, seeds=DEFAULT_SEEDS) -> None:
    report = run_differential(kernel, seeds)
    assert report["green"], (
        f"kernel {kernel!r} failed the oracle differential:\n"
        + "\n".join(report["violations"]))


# ------------------------------------------------- migration-plan judge
#
# The rig judges eviction + placement MIGRATION plans too — the legs a
# defrag wave (defrag/) or a drain storm stages. The CPU oracle
# re-verifies what the live plan applier verifies, spelled out so a
# failing wave names its sin.


def judge_migration_plan(snap, plan, seed=None) -> List[str]:
    """Violations in one migration plan's legs against the pre-eval
    snapshot: every eviction victim (node_update stops + the
    preemption leg) must EXIST, be NON-TERMINAL, and live on the node
    its leg names; evicting it must actually free its accounted
    capacity (the post-eviction used vector shrinks by exactly the
    victim's usage); and every placement must fit its node WITH the
    plan's own evictions discounted (allocs_fit over the proposed
    set) and pass plan-apply verification."""
    from ..models.matrix import _alloc_usage
    from ..server.plan_apply import evaluate_node_plan
    from ..structs import allocs_fit, remove_allocs

    tag = f"seed {seed}: " if seed is not None else ""
    bad: List[str] = []
    evict_nodes = set(plan.node_update) | set(plan.node_preemptions)
    for node_id in sorted(evict_nodes):
        node = snap.node_by_id(node_id)
        if node is None:
            bad.append(f"{tag}eviction leg names unknown node {node_id}")
            continue
        victims = (plan.node_update.get(node_id, [])
                   + plan.node_preemptions.get(node_id, []))
        existing = snap.allocs_by_node_terminal(node_id, False)
        by_id = {a.id: a for a in existing}
        freeable = []
        for victim in victims:
            stored = snap.alloc_by_id(victim.id)
            if stored is None:
                bad.append(f"{tag}victim {victim.id} does not exist")
                continue
            if stored.terminal_status():
                bad.append(f"{tag}victim {victim.id} already terminal "
                           f"({stored.desired_status}/"
                           f"{stored.client_status})")
                continue
            if stored.node_id != node_id:
                bad.append(f"{tag}victim {victim.id} is on node "
                           f"{stored.node_id}, leg claims {node_id}")
                continue
            if victim.id in by_id:
                freeable.append(by_id[victim.id])
        # Capacity actually freed: used(before) - used(after removal)
        # must equal the victims' accounted usage per dimension — a
        # victim whose eviction frees nothing (double-listed, already
        # gone) would let a placement ride phantom capacity.
        _f0, _d0, used_before = allocs_fit(node, existing)
        remaining = remove_allocs(existing, freeable)
        _f1, _d1, used_after = allocs_fit(node, remaining)
        want = [0.0] * 4
        for a in freeable:
            cpu, mem, disk, iops, _bw, _p = _alloc_usage(a)
            want[0] += cpu
            want[1] += mem
            want[2] += disk
            want[3] += iops
        got = (used_before.cpu - used_after.cpu,
               used_before.memory_mb - used_after.memory_mb,
               used_before.disk_mb - used_after.disk_mb,
               used_before.iops - used_after.iops)
        if any(abs(g - w) > 1e-6 for g, w in zip(got, want)):
            bad.append(f"{tag}node {node_id}: evictions freed {got}, "
                       f"accounting claims {tuple(want)}")
    for node_id, placed in plan.node_allocation.items():
        node = snap.node_by_id(node_id)
        if node is None:
            bad.append(f"{tag}placed on unknown node {node_id}")
            continue
        if not evaluate_node_plan(snap, plan, node_id):
            bad.append(f"{tag}plan-apply rejected node {node_id}")
        existing = snap.allocs_by_node_terminal(node_id, False)
        updates = (plan.node_update.get(node_id, [])
                   + plan.node_preemptions.get(node_id, []))
        proposed = remove_allocs(existing, updates) + placed
        for a in proposed:
            if a.job is None:
                a.job = plan.job
        fit, dim, _ = allocs_fit(node, proposed)
        if not fit:
            bad.append(f"{tag}capacity exceeded on {node_id}: {dim}")
    return bad


# ------------------------------------------------------ gang-plan judge
#
# Gang scheduling (gang/) extends the rig a third time: from
# placements and migration plans to ALL-OR-NOTHING gang plans. The CPU
# oracle re-verifies the atomicity contract itself, not just per-node
# validity — a partially-staged gang is a violation even if every
# member individually fits.


def judge_gang_plan(snap, plan, job, seed=None) -> List[str]:
    """Violations in one plan's gang legs against the pre-eval
    snapshot: per gang task group, the plan stages ALL count members
    or NONE (and the gang_groups leg names exactly the staged ids);
    slice gangs land inside ONE topology group; spread gangs respect
    the per-group cap; every member's node passes plan-apply
    verification and fits with its CO-SCHEDULED gang members (and the
    plan's evictions) discounted; every member's node passes the host
    oracle's feasibility chain."""
    from ..gang import (
        gang_distinct_hosts,
        gang_key,
        gang_mode,
        gang_task_groups,
        spread_cap,
    )
    from ..gang.host import estimate_member_units
    from ..models.topology import TOPOLOGY_META_KEYS
    from ..ops.gang import GANG_MODE_SLICE, GANG_MODE_SPREAD
    from ..server.plan_apply import evaluate_node_plan
    from ..structs import allocs_fit, remove_allocs

    tag = f"seed {seed}: " if seed is not None else ""
    bad: List[str] = []
    placed_by_node = plan.node_allocation
    for tg in gang_task_groups(job):
        k = tg.count
        key = gang_key(job.id, tg.name)
        members = [(node_id, a)
                   for node_id, placed in placed_by_node.items()
                   for a in placed
                   if a.job_id == job.id and a.task_group == tg.name]
        # All-K-or-none.
        if members and len(members) != k:
            bad.append(f"{tag}gang {key}: staged {len(members)} of {k} "
                       "members (partial gang)")
        # The atomicity leg must name exactly the staged members —
        # an unlisted member would silently escape whole-gang reject.
        leg = set(plan.gang_groups.get(key, ()))
        ids = {a.id for _n, a in members}
        if members and leg != ids:
            bad.append(f"{tag}gang {key}: gang_groups leg names "
                       f"{len(leg)} ids, plan stages {len(ids)}")
        if not members:
            continue
        mode, level = gang_mode(tg.gang)
        meta_key = TOPOLOGY_META_KEYS.get(level, "rack")
        if mode == GANG_MODE_SLICE:
            groups = set()
            for node_id, _a in members:
                node = snap.node_by_id(node_id)
                value = node.meta.get(meta_key) if node else None
                if not value:
                    bad.append(f"{tag}gang {key}: member on {node_id} "
                               f"which has no {meta_key!r} meta — "
                               "contiguity unprovable")
                else:
                    groups.add(value)
            if len(groups) > 1:
                bad.append(f"{tag}gang {key}: slice spans "
                           f"{sorted(groups)} — not contiguous")
        if mode == GANG_MODE_SPREAD:
            dh = gang_distinct_hosts(job, tg)
            groups_all: dict = {}
            for node in snap.nodes():
                # the same ready + datacenter filter BOTH scheduler
                # legs group by — counting foreign-DC groups as
                # eligible would shrink the cap below what the legs
                # lawfully used and convict a correct plan
                if not node.ready() \
                        or node.datacenter not in job.datacenters:
                    continue
                g = node.meta.get(meta_key) or f"__node__{node.id}"
                groups_all.setdefault(g, []).append(node)
            eligible = sum(
                1 for nodes in groups_all.values()
                if any(estimate_member_units(snap, None, n, tg, dh) >= 1
                       for n in nodes))
            cap = spread_cap(k, eligible)
            counts: dict = {}
            for node_id, _a in members:
                node = snap.node_by_id(node_id)
                g = ((node.meta.get(meta_key) if node else None)
                     or f"__node__{node_id}")
                counts[g] = counts.get(g, 0) + 1
            for g, got in counts.items():
                if got > cap:
                    bad.append(f"{tag}gang {key}: spread cap {cap} "
                               f"exceeded in group {g!r} ({got})")
        # Per-node: plan-apply acceptance + capacity with co-scheduled
        # members (they are all in node_allocation) and evictions
        # discounted + host-oracle feasibility.
        for node_id in sorted({n for n, _a in members}):
            node = snap.node_by_id(node_id)
            if node is None:
                bad.append(f"{tag}gang {key}: member on unknown node "
                           f"{node_id}")
                continue
            if not evaluate_node_plan(snap, plan, node_id):
                bad.append(f"{tag}gang {key}: plan-apply rejected "
                           f"node {node_id}")
            existing = snap.allocs_by_node_terminal(node_id, False)
            updates = (plan.node_update.get(node_id, [])
                       + plan.node_preemptions.get(node_id, []))
            proposed = (remove_allocs(existing, updates)
                        + placed_by_node.get(node_id, []))
            for a in proposed:
                if a.job is None:
                    a.job = plan.job
            fit, dim, _ = allocs_fit(node, proposed)
            if not fit:
                bad.append(f"{tag}gang {key}: capacity exceeded on "
                           f"{node_id}: {dim}")
            if not _oracle_feasible(snap, job, tg, node):
                bad.append(f"{tag}gang {key}: oracle rejects node "
                           f"{node_id}")
    return bad


def build_gang_scenario(seed: int):
    """(seed_state_fn, job) for one gang rig case: a topology cluster
    (racks of 4, ICI pairs inside racks) with optional preload/drains,
    and a gang job whose mode sweeps slice/spread/affinity/free."""
    from .. import mock
    from ..structs import Gang, consts

    rng = random.Random(seed)
    n_nodes = rng.choice([12, 16, 24])
    preload = rng.random() < 0.5
    drain_frac = rng.choice([0.0, 0.0, 0.15])
    mode = rng.choice(["slice", "slice", "spread", "affinity", "free"])
    k = rng.choice([3, 4, 6])
    cpu = rng.choice([400, 700])
    mem = rng.choice([256, 512])

    nodes = []
    for i in range(n_nodes):
        node = mock.node()
        node.resources.cpu = 3000
        node.resources.memory_mb = 3000
        node.meta["rack"] = f"r{i // 4}"
        node.meta["ici"] = f"r{i // 4}-ici{(i % 4) // 2}"
        node.compute_class()
        nodes.append(node)
    if mode == "slice" and rng.random() < 0.3:
        # Some topology-less nodes: slice gangs must never land there.
        for node in nodes[-2:]:
            node.meta.pop("rack", None)
            node.meta.pop("ici", None)
            node.compute_class()
    drained = [n.id for n in nodes[: int(n_nodes * drain_frac)]]

    filler_allocs = []
    if preload:
        filler = mock.job()
        filler.id = "gang-filler"
        for i, node in enumerate(nodes):
            if i % 3:
                continue
            a = mock.alloc()
            a.node_id, a.job_id, a.job = node.id, filler.id, filler
            a.desired_status = consts.ALLOC_DESIRED_RUN
            a.client_status = consts.ALLOC_CLIENT_RUNNING
            for tr in a.task_resources.values():
                tr.cpu = rng.choice([500, 1500])
                tr.memory_mb = rng.choice([400, 1200])
                tr.networks = []
            a.resources = None
            filler_allocs.append(a)

    def seed_state(h, job):
        from ..scheduler.testing import seed_harness_cluster

        seed_harness_cluster(h, nodes=nodes, allocs=filler_allocs,
                             jobs=[job.copy()], drained=drained)

    job = mock.job()
    job.id = f"gang-{seed}"
    job.datacenters = [nodes[0].datacenter]
    tg = job.task_groups[0]
    tg.count = k
    tg.gang = Gang(
        slice="rack" if mode == "slice" else "",
        spread="rack" if mode == "spread" else "",
        affinity="rack" if mode == "affinity" else "",
    )
    task = tg.tasks[0]
    task.resources.cpu = cpu
    task.resources.memory_mb = mem
    if rng.random() < 0.5:
        task.resources.networks = []
    if rng.random() < 0.3:
        from ..structs import Constraint

        tg.constraints.append(
            Constraint(operand=consts.CONSTRAINT_DISTINCT_HOSTS))
    return seed_state, job


GANG_SEEDS = range(9200, 9208)


def run_gang_differential(seeds=GANG_SEEDS,
                          factory_suffix: str = "-gpu") -> Dict:
    """Drive gang evals through the dense factory on seeded topology
    clusters and have the oracle judge EVERY plan with
    judge_gang_plan, plus the store-level invariant: a gang job's live
    member count is 0 or exactly K — a partially-committed gang in
    the store is the one thing this subsystem exists to prevent."""
    from ..scheduler.testing import Harness
    from ..structs import consts, new_eval

    violations: List[str] = []
    placed_gangs = 0
    for seed in seeds:
        seed_state, job = build_gang_scenario(seed)
        h = Harness(seed=seed)
        seed_state(h, job)
        snap = h.state.snapshot()
        h.process(f"{job.type}{factory_suffix}", new_eval(
            h.state.job_by_id(job.id), consts.EVAL_TRIGGER_JOB_REGISTER))
        for plan in h.plans:
            violations.extend(
                judge_gang_plan(snap, plan, job, seed=seed))
        live = [a for a in h.state.allocs_by_job(job.id)
                if not a.terminal_status()]
        k = job.task_groups[0].count
        if len(live) not in (0, k):
            violations.append(
                f"seed {seed}: store holds {len(live)} of {k} gang "
                "members (partial commit)")
        if len(live) == k:
            placed_gangs += 1
    return {"cases": len(list(seeds)), "placed_gangs": placed_gangs,
            "violations": violations, "green": not violations}


def _defrag_scenario(seed: int):
    """A fragmented service cluster for the defrag differential: mixed
    big/small asks packed tight, then churn-stopped smalls leave
    sub-ask remainders scattered across nodes — the consolidation
    shape the defrag solver exists for."""
    import random as _random

    from ..scheduler.testing import (
        Harness,
        churn_stop_small_allocs,
        seed_consolidation_cluster,
    )

    rng = _random.Random(seed)
    h = Harness(seed=seed)
    # The shared fragmentation fixture (scheduler/testing.py).
    seed_consolidation_cluster(h, rng.choice([24, 32]))
    churn_stop_small_allocs(h, rng, 0.35)
    return h


DEFRAG_SEEDS = range(8100, 8106)


def run_defrag_differential(seeds=DEFRAG_SEEDS,
                            factory: str = "service") -> Dict:
    """Drive full defrag waves (solve -> wave evals -> scheduler) on
    seeded fragmented clusters and have the oracle judge EVERY plan a
    wave produced with judge_migration_plan, plus the wave contracts:
    each marked alloc's eviction is exactly-once (one terminal stamp,
    never two), and job alloc counts are preserved (a defrag wave must
    never shrink a service)."""
    from ..defrag import WarmState, build_wave_evals, compute_defrag_plan
    from ..structs import consts

    violations: List[str] = []
    waves = 0
    for seed in seeds:
        h = _defrag_scenario(seed)
        want_live = {
            j.id: len([a for a in h.state.allocs_by_job(j.id)
                       if not a.terminal_status()])
            for j in h.state.jobs()}
        warm = WarmState()
        for _round in range(3):
            snap = h.state.snapshot()
            plan = compute_defrag_plan(
                snap, ["dc1"], max_moves=8, min_gain=0.001, warm=warm)
            if not plan.moves:
                break
            evals = build_wave_evals(snap, plan.moves)
            waves += 1
            for ev in evals:
                # Judge each plan against the snapshot ITS eval ran on:
                # an earlier wave eval's committed eviction legitimately
                # frees the room a later placement uses, and judging the
                # later plan against the wave-START snapshot would read
                # that as phantom overcommit.
                ev_snap = h.state.snapshot()
                seen_plans = len(h.plans)
                h.process(factory, ev)
                for wave_plan in h.plans[seen_plans:]:
                    violations.extend(judge_migration_plan(
                        ev_snap, wave_plan, seed=seed))
            for mv in plan.moves:
                stored = h.state.alloc_by_id(mv.alloc_id)
                if stored is None:
                    violations.append(
                        f"seed {seed}: moved alloc {mv.alloc_id} "
                        "vanished")
                elif stored.desired_status not in (
                        consts.ALLOC_DESIRED_STOP,
                        consts.ALLOC_DESIRED_EVICT):
                    violations.append(
                        f"seed {seed}: moved alloc {mv.alloc_id} "
                        "has no eviction terminal")
        for job_id, want in want_live.items():
            got = len([a for a in h.state.allocs_by_job(job_id)
                       if not a.terminal_status()])
            if got < want:
                violations.append(
                    f"seed {seed}: job {job_id} shrank {want}->{got} "
                    "across defrag waves")
    return {"cases": len(list(seeds)), "waves": waves,
            "violations": violations, "green": not violations}
