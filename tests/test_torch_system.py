"""The system scheduler: the same carried-across state, eval and Harness
seed go through the JAX package's "system" and "system-tpu" and the
port's "system" and "system-gpu" (the port on the CPU; neither system
factory runs device code in either package). Each pair must give the
same plans: per node, the same alloc names with the same scores and
port offers, the same stops, the same annotations, and the same
failed-task-group metrics, eval statuses and queued counts.

Every test of tests/test_scheduler_system.py and
tests/test_system_dense.py has a mirror here, run on both pairs, with
its own assertions held on the port's side; the seeds of
tests/test_parity_fuzz.py's system drain sweep; config 5's drain storm
(bench.py ``_system_drain_storm``) at 200 nodes x 20 rack-scoped jobs
through all four factories; and the dense path's exact-ports retry."""

from __future__ import annotations

import logging
import random
from types import SimpleNamespace

import pytest

from nomad_tpu import mock
from nomad_tpu.scheduler.testing import Harness
from nomad_tpu.structs import Constraint, NetworkResource, Port, consts, new_eval

from torch_parity import carry_over, failed_view, plan_view, port_eval

# (JAX package factory, port factory)
PAIRS = [("system", "system"), ("system-tpu", "system-gpu")]
PAIR_IDS = ["host", "dense"]
pairs = pytest.mark.parametrize("pair", PAIRS, ids=PAIR_IDS)


# ------------------------------------------------------------- views


def placed_view(plan):
    """{node id: plan_view of that node's new allocs}: a system job's
    allocs share their names across nodes, so plan_view is taken a
    node at a time."""
    return {node: plan_view(SimpleNamespace(node_allocation={node: allocs}))
            for node, allocs in plan.node_allocation.items()}


def stops_view(plan):
    """{node id: [(alloc id, desired status, description, client
    status)]} of the plan's stops (carried-over allocs: same ids)."""
    return {node: sorted((a.id, a.desired_status, a.desired_description,
                          a.client_status) for a in allocs)
            for node, allocs in plan.node_update.items()}


def annotations_view(plan):
    if plan.annotations is None:
        return None
    return {name: dict(vars(d))
            for name, d in plan.annotations.desired_tg_updates.items()}


def failed_detail(ev):
    """failed_view plus the per-constraint, per-class and per-dimension
    tallies of each failed task group."""
    return (failed_view(ev),
            {name: (dict(m.constraint_filtered), dict(m.class_filtered),
                    dict(m.dimension_exhausted), dict(m.class_exhausted))
             for name, m in (ev.failed_tg_allocs or {}).items()})


def assert_same(h, hp, plans0=0, evals0=0, created0=0):
    """The port's harness ``hp`` recorded what the JAX harness ``h``
    recorded from ``plans0``/``evals0``/``created0`` on."""
    ref_plans = h.plans[plans0:]
    assert len(ref_plans) == len(hp.plans)
    for pj, pt in zip(ref_plans, hp.plans):
        assert placed_view(pj) == placed_view(pt)
        assert stops_view(pj) == stops_view(pt)
        assert annotations_view(pj) == annotations_view(pt)
    ref_evals = h.evals[evals0:]
    assert [failed_detail(e) for e in ref_evals] == \
        [failed_detail(e) for e in hp.evals]
    assert [(e.status, e.status_description) for e in ref_evals] == \
        [(e.status, e.status_description) for e in hp.evals]
    assert [e.queued_allocations for e in ref_evals] == \
        [e.queued_allocations for e in hp.evals]
    assert [e.triggered_by for e in h.create_evals[created0:]] == \
        [e.triggered_by for e in hp.create_evals]


def run_both(pair, h, ev):
    """``ev`` through the JAX factory on ``h`` and through the port's on
    a carried-over copy of ``h``'s state taken just before; the two
    are held to the same records. Returns the port's harness."""
    ref_name, port_name = pair
    hp = carry_over(h)
    marks = len(h.plans), len(h.evals), len(h.create_evals)
    h.process(ref_name, ev)
    hp.process(port_name, port_eval(ev))
    assert_same(h, hp, *marks)
    return hp


def placed(h, plan_i=0):
    return [a for lst in h.plans[plan_i].node_allocation.values()
            for a in lst]


def stopped(h, plan_i=0):
    return [a for lst in h.plans[plan_i].node_update.values() for a in lst]


def seed_nodes(h, count):
    nodes = []
    for _ in range(count):
        n = mock.node()
        n.compute_class()
        h.state.upsert_node(h.next_index(), n)
        nodes.append(n)
    return nodes


def strip_net(job):
    for tg in job.task_groups:
        for t in tg.tasks:
            t.resources.networks = []
    return job


def next_harness(h, seed):
    """A fresh Harness over ``h``'s store and index clock (the JAX
    tests' second step)."""
    h2 = Harness(state=h.state, seed=seed)
    h2._next_index = h._next_index
    return h2


def registered(pair, seed, n_nodes, job):
    """``job`` registered on ``n_nodes`` fresh nodes and its first eval
    run through both packages. Returns (h, hp, nodes)."""
    h = Harness(seed=seed)
    nodes = seed_nodes(h, n_nodes)
    h.state.upsert_job(h.next_index(), job)
    hp = run_both(pair, h, new_eval(job, consts.EVAL_TRIGGER_JOB_REGISTER))
    return h, hp, nodes


# ------------------------------ mirrors of tests/test_scheduler_system.py


@pairs
def test_system_register_runs_everywhere(pair):
    _h, hp, nodes = registered(pair, 20, 10, mock.system_job())
    out = placed(hp)
    assert len(out) == 10
    assert {a.node_id for a in out} == {n.id for n in nodes}
    hp.assert_eval_status(consts.EVAL_STATUS_COMPLETE)


@pairs
def test_system_constraint_filters_nodes(pair):
    h = Harness(seed=21)
    nodes = seed_nodes(h, 4)
    for n in nodes[:2]:
        n2 = n.copy()
        n2.attributes["kernel.name"] = "windows"
        n2.computed_class = ""
        n2.compute_class()
        h.state.upsert_node(h.next_index(), n2)
    job = mock.system_job()
    h.state.upsert_job(h.next_index(), job)
    hp = run_both(pair, h, new_eval(job, consts.EVAL_TRIGGER_JOB_REGISTER))
    out = placed(hp)
    assert len(out) == 2
    assert {a.node_id for a in out} == {n.id for n in nodes[2:]}
    assert hp.evals[0].queued_allocations.get("web", 0) == 0


@pairs
def test_system_new_node_gets_alloc(pair):
    job = mock.system_job()
    h, hp, _nodes = registered(pair, 22, 2, job)
    assert len(placed(hp)) == 2
    h2 = next_harness(h, 23)
    new_node = mock.node()
    h2.state.upsert_node(h2.next_index(), new_node)
    hp2 = run_both(pair, h2, new_eval(job, consts.EVAL_TRIGGER_NODE_UPDATE))
    assert [a.node_id for a in placed(hp2)] == [new_node.id]
    assert len(hp2.state.allocs_by_job(job.id)) == 3


@pairs
def test_system_node_down_stops_alloc(pair):
    job = mock.system_job()
    h, _hp, nodes = registered(pair, 24, 3, job)
    h.state.update_node_status(h.next_index(), nodes[0].id,
                               consts.NODE_STATUS_DOWN)
    hp2 = run_both(pair, next_harness(h, 25),
                   new_eval(job, consts.EVAL_TRIGGER_NODE_UPDATE))
    stops = stopped(hp2)
    assert len(stops) >= 1
    assert all(a.client_status == consts.ALLOC_CLIENT_LOST for a in stops)
    assert all(a.node_id != nodes[0].id for a in placed(hp2))


@pairs
def test_system_deregister_stops_all(pair):
    job = mock.system_job()
    h, _hp, _nodes = registered(pair, 26, 3, job)
    h.state.delete_job(h.next_index(), job.id)
    hp2 = run_both(pair, next_harness(h, 27),
                   new_eval(job, consts.EVAL_TRIGGER_JOB_DEREGISTER))
    assert len(stopped(hp2)) == 3
    hp2.assert_eval_status(consts.EVAL_STATUS_COMPLETE)


@pairs
def test_system_exhaust_resources(pair):
    h = Harness(seed=70)
    node = mock.node()
    node.resources.cpu = 100
    node.resources.memory_mb = 64
    h.state.upsert_node(h.next_index(), node)
    job = strip_net(mock.system_job())
    job.task_groups[0].tasks[0].resources.cpu = 5000
    h.state.upsert_job(h.next_index(), job)
    hp = run_both(pair, h, new_eval(job, consts.EVAL_TRIGGER_JOB_REGISTER))
    assert hp.state.allocs_by_job(job.id) == []
    ev = hp.evals[0]
    assert ev.status == consts.EVAL_STATUS_COMPLETE
    assert ev.failed_tg_allocs["web"].nodes_exhausted >= 1


@pairs
def test_system_add_node_gets_new_alloc_only(pair):
    job = strip_net(mock.system_job())
    h, _hp, _nodes = registered(pair, 71, 3, job)
    n = mock.node()
    h.state.upsert_node(h.next_index(), n)
    hp2 = run_both(pair, next_harness(h, 72),
                   new_eval(job, consts.EVAL_TRIGGER_NODE_UPDATE))
    assert [a.node_id for a in placed(hp2)] == [n.id]
    assert stopped(hp2) == []


@pairs
def test_system_job_modify_destructive(pair):
    job = strip_net(mock.system_job())
    h, _hp, _nodes = registered(pair, 73, 4, job)
    first = h.state.allocs_by_job(job.id)
    job2 = job.copy()
    job2.task_groups[0].tasks[0].config = {"command": "/bin/other"}
    h.state.upsert_job(h.next_index(), job2)
    hp2 = run_both(pair, next_harness(h, 74),
                   new_eval(job2, consts.EVAL_TRIGGER_JOB_REGISTER))
    assert len(stopped(hp2)) == 4 and len(placed(hp2)) == 4
    assert {a.node_id for a in placed(hp2)} == {a.node_id for a in first}


@pairs
def test_system_job_modify_in_place(pair):
    job = strip_net(mock.system_job())
    h, _hp, _nodes = registered(pair, 75, 3, job)
    job2 = job.copy()
    job2.priority += 10
    h.state.upsert_job(h.next_index(), job2)
    hp2 = run_both(pair, next_harness(h, 76),
                   new_eval(job2, consts.EVAL_TRIGGER_JOB_REGISTER))
    assert stopped(hp2) == []
    assert len(placed(hp2)) == 3  # the in-place rewrites


@pairs
def test_system_node_drain_stops_without_migration(pair):
    """A drained node's alloc diffs into a migration, which a system job
    turns into a stop (util.diff_system_allocs; the dense diff does the
    same per node)."""
    job = strip_net(mock.system_job())
    h, _hp, nodes = registered(pair, 77, 3, job)
    h.state.update_node_drain(h.next_index(), nodes[0].id, True)
    hp2 = run_both(pair, next_harness(h, 78),
                   new_eval(job, consts.EVAL_TRIGGER_NODE_UPDATE))
    stops = stopped(hp2)
    assert [a.node_id for a in stops] == [nodes[0].id]
    assert all(a.node_id != nodes[0].id for a in placed(hp2))


@pairs
def test_system_queued_with_constraints(pair):
    h = Harness(seed=79)
    node = mock.node()
    node.attributes["kernel.name"] = "darwin"
    node.compute_class()
    h.state.upsert_node(h.next_index(), node)
    job = strip_net(mock.system_job())
    job.constraints.append(
        Constraint(ltarget="${attr.kernel.name}", rtarget="linux",
                   operand="="))
    h.state.upsert_job(h.next_index(), job)
    hp = run_both(pair, h, new_eval(job, consts.EVAL_TRIGGER_JOB_REGISTER))
    ev = hp.evals[0]
    assert ev.status == consts.EVAL_STATUS_COMPLETE
    assert ev.queued_allocations.get("web", 0) == 0


@pairs
def test_system_chained_alloc_ids(pair):
    job = strip_net(mock.system_job())
    h, _hp, _nodes = registered(pair, 80, 2, job)
    first = {a.node_id: a.id for a in h.state.allocs_by_job(job.id)}
    job2 = job.copy()
    job2.task_groups[0].tasks[0].config = {"x": "y"}
    h.state.upsert_job(h.next_index(), job2)
    hp2 = run_both(pair, next_harness(h, 81),
                   new_eval(job2, consts.EVAL_TRIGGER_JOB_REGISTER))
    out = placed(hp2)
    assert len(out) == 2
    for a in out:
        assert a.previous_allocation == first[a.node_id]


@pairs
def test_system_annotate_plan(pair):
    h = Harness(seed=82)
    seed_nodes(h, 5)
    job = strip_net(mock.system_job())
    h.state.upsert_job(h.next_index(), job)
    ev = new_eval(job, consts.EVAL_TRIGGER_JOB_REGISTER)
    ev.annotate_plan = True
    hp = run_both(pair, h, ev)
    assert hp.plans[0].annotations.desired_tg_updates["web"].place == 5


# --------------------------------- mirrors of tests/test_system_dense.py


@pairs
def test_dense_system_register_runs_everywhere(pair):
    job = strip_net(mock.system_job())
    _h, hp, nodes = registered(pair, 20, 10, job)
    out = hp.state.allocs_by_job(job.id)
    assert len(out) == 10
    assert {a.node_id for a in out} == {n.id for n in nodes}
    hp.assert_eval_status(consts.EVAL_STATUS_COMPLETE)


@pairs
def test_dense_system_constraint_filters_nodes(pair):
    h = Harness(seed=21)
    nodes = seed_nodes(h, 4)
    for n in nodes[:2]:
        n2 = n.copy()
        n2.attributes["kernel.name"] = "windows"
        n2.compute_class()
        h.state.upsert_node(h.next_index(), n2)
    job = strip_net(mock.system_job())
    job.constraints.append(
        Constraint(ltarget="${attr.kernel.name}", rtarget="linux",
                   operand="="))
    h.state.upsert_job(h.next_index(), job)
    hp = run_both(pair, h, new_eval(job, consts.EVAL_TRIGGER_JOB_REGISTER))
    out = hp.state.allocs_by_job(job.id)
    assert {a.node_id for a in out} == {n.id for n in nodes[2:]}
    ev = hp.evals[0]
    assert ev.queued_allocations.get("web", 0) == 0
    metric = ev.failed_tg_allocs["web"]
    assert metric.nodes_filtered == 1
    assert metric.coalesced_failures == 1
    # Stored allocs carry their own metric records: the dense path
    # shares one object across its plan, and the store's upsert copies.
    assert all(a.metrics.nodes_filtered == 0 for a in out)
    assert len({id(a.metrics) for a in out}) == len(out)


@pairs
def test_dense_system_resource_exhaustion_fails_tg(pair):
    job = strip_net(mock.system_job())
    job.task_groups[0].tasks[0].resources.cpu = 10 ** 7
    _h, hp, _nodes = registered(pair, 22, 3, job)
    assert hp.state.allocs_by_job(job.id) == []
    metric = hp.evals[0].failed_tg_allocs["web"]
    assert metric.nodes_exhausted == 1 and metric.coalesced_failures == 2


@pairs
def test_dense_system_node_down_stops_alloc(pair):
    job = strip_net(mock.system_job())
    h, _hp, nodes = registered(pair, 23, 4, job)
    h.state.update_node_status(h.next_index(), nodes[0].id,
                               consts.NODE_STATUS_DOWN)
    hp2 = run_both(pair, next_harness(h, 25),
                   new_eval(job, consts.EVAL_TRIGGER_NODE_UPDATE))
    assert len(stopped(hp2)) >= 1
    assert all(a.node_id != nodes[0].id for a in placed(hp2))


@pairs
def test_dense_system_ports_assigned_exactly(pair):
    job = mock.system_job()
    job.task_groups[0].tasks[0].resources.networks = [
        NetworkResource(mbits=10, dynamic_ports=[Port(label="http")])]
    _h, hp, _nodes = registered(pair, 24, 5, job)
    allocs = hp.state.allocs_by_job(job.id)
    assert len(allocs) == 5
    for a in allocs:
        nets = a.task_resources["web"].networks
        assert nets and nets[0].dynamic_ports[0].value >= 20000


def _two_group_cluster(seed):
    """test_system_dense's parity cluster: 8 nodes with stable ids, one
    constrained group and one open group."""
    h = Harness(seed=seed)
    for i in range(8):
        n = mock.node()
        n.id = f"node-{i}"
        n.compute_class()
        h.state.upsert_node(h.next_index(), n)
    job = strip_net(mock.system_job())
    tg2 = job.task_groups[0].copy()
    tg2.name = "aux"
    tg2.tasks[0].resources.cpu = 100
    job.task_groups.append(tg2)
    h.state.upsert_job(h.next_index(), job)
    return h, job


@pytest.mark.parametrize("seed", [31, 32])
def test_dense_system_parity_with_host_path(seed):
    """The four factories on the same cluster and job: the same placed
    (node, task group) pairs, queued counts and status."""
    results = {}
    for pair in PAIRS:
        h, job = _two_group_cluster(seed)
        hp = run_both(pair, h, new_eval(job,
                                        consts.EVAL_TRIGGER_JOB_REGISTER))
        for key, harness in ((("jax",) + pair[:1], h),
                             (("port",) + pair[1:], hp)):
            results[key] = {
                "placed": sorted((a.node_id, a.task_group)
                                 for a in harness.state.allocs_by_job(job.id)),
                "queued": harness.evals[0].queued_allocations,
                "status": harness.evals[0].status,
            }
    first = results[("jax", "system")]
    assert len(first["placed"]) == 16
    assert all(r == first for r in results.values()), results


@pairs
def test_dense_system_deregister_stops_all(pair):
    """job=None (deregistered) takes the ungated host diff in the dense
    scheduler: every alloc stops."""
    job = strip_net(mock.system_job())
    h, _hp, _nodes = registered(pair, 26, 3, job)
    h.state.delete_job(h.next_index(), job.id)
    hp2 = run_both(pair, next_harness(h, 27),
                   new_eval(job, consts.EVAL_TRIGGER_JOB_DEREGISTER))
    assert len(stopped(hp2)) == 3
    hp2.assert_eval_status(consts.EVAL_STATUS_COMPLETE)


# ------------------------------------------------- the paths in between


@pairs
def test_deregister_with_tainted_nodes(pair):
    """Deregister with one node drained: every alloc stops, nothing is
    placed. Then that node and another go down and a second deregister
    eval marks the stopped allocs still pending there lost
    (update_non_terminal_allocs_to_lost)."""
    job = strip_net(mock.system_job())
    h, _hp, nodes = registered(pair, 90, 5, job)
    h.state.update_node_drain(h.next_index(), nodes[1].id, True)
    h.state.delete_job(h.next_index(), job.id)
    h2 = next_harness(h, 91)
    hp2 = run_both(pair, h2,
                   new_eval(job, consts.EVAL_TRIGGER_JOB_DEREGISTER))
    assert len(stopped(hp2)) == 5 and placed(hp2) == []
    for n in nodes[:2]:
        h2.state.update_node_status(h2.next_index(), n.id,
                                    consts.NODE_STATUS_DOWN)
    hp3 = run_both(pair, next_harness(h2, 92),
                   new_eval(job, consts.EVAL_TRIGGER_JOB_DEREGISTER))
    lost = stopped(hp3)
    assert sorted(a.node_id for a in lost) == sorted(n.id for n in nodes[:2])
    assert all(a.client_status == consts.ALLOC_CLIENT_LOST for a in lost)


@pairs
def test_prefiltered_accounting_with_annotations(pair):
    """Two groups, one constrained by rack: the dense diff never
    materializes the constrained group's infeasible slots and folds
    them into queued counts, failed_tg_allocs (first offender, the rest
    coalesced) and the annotations the way the host loop's one-at-a-time
    filtering does. One node is too small for the open group; on the
    node-update eval one node is drained and a new one joins."""
    h = Harness(seed=92)
    nodes = []
    for i in range(9):
        n = mock.node()
        n.meta["rack"] = f"r{i % 3}"
        if i == 4:
            n.resources.cpu = 300
        n.compute_class()
        h.state.upsert_node(h.next_index(), n)
        nodes.append(n)
    job = strip_net(mock.system_job())
    tg2 = job.task_groups[0].copy()
    tg2.name = "rack0"
    tg2.tasks[0].resources.cpu = 50
    tg2.constraints.append(Constraint(ltarget="${meta.rack}", operand="=",
                                      rtarget="r0"))
    job.task_groups.append(tg2)
    h.state.upsert_job(h.next_index(), job)
    ev = new_eval(job, consts.EVAL_TRIGGER_JOB_REGISTER)
    ev.annotate_plan = True
    hp = run_both(pair, h, ev)
    upd = hp.plans[0].annotations.desired_tg_updates
    assert upd["web"].place == 9 and upd["rack0"].place == 3
    failed = hp.evals[0].failed_tg_allocs
    assert failed["web"].nodes_exhausted == 1
    assert failed["rack0"].nodes_filtered == 1
    assert failed["rack0"].coalesced_failures == 5

    h2 = next_harness(h, 93)
    h2.state.update_node_drain(h2.next_index(), nodes[1].id, True)
    extra = mock.node()
    extra.meta["rack"] = "r1"
    extra.compute_class()
    h2.state.upsert_node(h2.next_index(), extra)
    ev = new_eval(job, consts.EVAL_TRIGGER_NODE_UPDATE)
    ev.annotate_plan = True
    hp2 = run_both(pair, h2, ev)
    upd = hp2.plans[0].annotations.desired_tg_updates
    assert upd["rack0"].place == 0 and upd["web"].stop == 1
    assert [a.node_id for a in placed(hp2)] == [extra.id]
    assert [a.node_id for a in stopped(hp2)] == [nodes[1].id]
    assert hp2.evals[0].failed_tg_allocs["rack0"].coalesced_failures > 0


def test_dense_filter_branch_on_the_ungated_diff(monkeypatch):
    """The dense placement loop's own constraint branch (undo the queued
    count and the annotation's place, record the filter) runs only on
    candidates the gated diff let through. Fed the host's ungated diff
    in both packages, the dense pair still agrees, and with the host
    pair's annotations, queued counts and placements."""
    from nomad_tpu.scheduler import system as ref_system
    from nomad_tpu.scheduler import tpu as ref_tpu
    from nomad_tpu_torch.scheduler import system as port_system
    from nomad_tpu_torch.scheduler import tpu as port_tpu

    def scenario(pair):
        h = Harness(seed=98)
        for i in range(6):
            n = mock.node()
            n.id = f"node-{i}"
            n.meta["rack"] = f"r{i % 3}"
            n.compute_class()
            h.state.upsert_node(h.next_index(), n)
        job = strip_net(mock.system_job())
        job.constraints.append(Constraint(ltarget="${meta.rack}",
                                          operand="=", rtarget="r1"))
        h.state.upsert_job(h.next_index(), job)
        ev = new_eval(job, consts.EVAL_TRIGGER_JOB_REGISTER)
        ev.annotate_plan = True
        hp = run_both(pair, h, ev)
        return (annotations_view(hp.plans[0]), hp.evals[0].queued_allocations,
                sorted(a.node_id for a in placed(hp)),
                failed_detail(hp.evals[0]))

    host = scenario(PAIRS[0])
    for mod_sys, mod_tpu in ((ref_system, ref_tpu), (port_system, port_tpu)):
        monkeypatch.setattr(mod_tpu.DenseSystemScheduler, "_diff_system",
                            mod_sys.SystemScheduler._diff_system)
    dense = scenario(PAIRS[1])
    assert host[0] == dense[0] and host[0]["web"]["place"] == 2
    assert host[1:3] == dense[1:3]
    assert dense[2] == ["node-1", "node-4"]
    assert dense[3][0]["web"][1:4] == (1, 0, 3)


def _collision_job():
    """A system job asking the static port 5000, which mock.alloc's
    network holds on the mock node's address."""
    job = mock.system_job()
    job.task_groups[0].tasks[0].resources.networks = [
        NetworkResource(mbits=10, reserved_ports=[Port("main", 5000)])]
    return job


@pairs
def test_port_collision_takes_the_exact_path(pair, monkeypatch):
    """The dense fit counts free ports and misses a static-port
    collision: the exact offer fails on that node, and the one alloc
    goes through the host path (the reference's retry), which records
    the failure. The other nodes place with the static port."""
    from nomad_tpu_torch.scheduler import system as port_system

    h = Harness(seed=94)
    nodes = seed_nodes(h, 4)
    holder = mock.alloc()
    holder.node_id = nodes[2].id
    holder.desired_status = consts.ALLOC_DESIRED_RUN
    holder.client_status = consts.ALLOC_CLIENT_RUNNING
    holder.task_resources["web"].cpu = 100
    holder.task_resources["web"].memory_mb = 64
    holder.resources = None
    h.state.upsert_job(h.next_index(), holder.job)
    h.state.upsert_allocs(h.next_index(), [holder])
    job = _collision_job()
    h.state.upsert_job(h.next_index(), job)

    host_calls = []
    host = port_system.SystemScheduler._compute_placements

    def spy(self, place):
        host_calls.append(len(place))
        return host(self, place)

    monkeypatch.setattr(port_system.SystemScheduler, "_compute_placements",
                        spy)
    hp = run_both(pair, h, new_eval(job, consts.EVAL_TRIGGER_JOB_REGISTER))
    out = placed(hp)
    assert sorted(a.node_id for a in out) == sorted(
        n.id for i, n in enumerate(nodes) if i != 2)
    for a in out:
        ports = a.task_resources["web"].networks[0].reserved_ports
        assert [(p.label, p.value) for p in ports] == [("main", 5000)]
    metric = hp.evals[0].failed_tg_allocs["web"]
    assert metric.nodes_exhausted == 1
    assert metric.coalesced_failures == 0
    # The host scheduler places all four in one loop; the dense one
    # retries exactly the colliding alloc on the host path.
    assert host_calls == ([4] if pair[1] == "system" else [1])


@pairs
def test_trigger_gate_fails_other_reasons(pair):
    """process_eval's gate: a trigger the system scheduler does not
    handle fails the eval without a plan."""
    h = Harness(seed=95)
    seed_nodes(h, 2)
    job = strip_net(mock.system_job())
    h.state.upsert_job(h.next_index(), job)
    hp = run_both(pair, h, new_eval(job, consts.EVAL_TRIGGER_MIGRATION))
    assert hp.plans == []
    assert hp.evals[0].status == consts.EVAL_STATUS_FAILED


@pairs
def test_rolling_update_creates_next_eval(pair):
    """A destructive update under a rolling update stanza replaces
    max_parallel allocs and chains a rolling-update eval
    (limit_reached)."""
    from nomad_tpu.structs import UpdateStrategy

    job = strip_net(mock.system_job())
    job.update = UpdateStrategy(stagger=30.0, max_parallel=2)
    h, _hp, _nodes = registered(pair, 96, 5, job)
    job2 = job.copy()
    job2.task_groups[0].tasks[0].config = {"command": "/bin/other"}
    h.state.upsert_job(h.next_index(), job2)
    hp2 = run_both(pair, next_harness(h, 97),
                   new_eval(job2, consts.EVAL_TRIGGER_JOB_REGISTER))
    assert len(stopped(hp2)) == 2 and len(placed(hp2)) == 2
    assert [e.triggered_by for e in hp2.create_evals] == [
        consts.EVAL_TRIGGER_ROLLING_UPDATE]


# ----------------- tests/test_parity_fuzz.py's system drain sweep seeds


def verify_port_plan(hp, snap_before):
    """Every node's proposed alloc set fits (the plan applier's check),
    with the port's own allocs_fit."""
    from nomad_tpu_torch.structs import allocs_fit, remove_allocs

    for plan in hp.plans:
        for node_id, new in plan.node_allocation.items():
            node = snap_before.node_by_id(node_id)
            existing = snap_before.allocs_by_node_terminal(node_id, False)
            proposed = remove_allocs(existing,
                                     plan.node_update.get(node_id, [])) + new
            for a in proposed:
                if a.job is None:
                    a.job = plan.job
            fit, dim, _ = allocs_fit(node, proposed)
            assert fit, f"plan failed verification on {node_id}: {dim}"


@pytest.mark.parametrize("seed", range(300, 316))
def test_randomized_system_parity_with_drains(seed):
    """The JAX sweep's clusters (random sizes, racks and drains): the
    JAX package's system-tpu and the port's system-gpu give the same
    plans; the port's host system places on the same node set; both
    port plans verify."""
    rng = random.Random(seed)
    n_nodes = rng.choice([4, 8, 16])
    use_racks = rng.random() < 0.5
    drain_frac = rng.choice([0.0, 0.25, 0.5])

    job = mock.system_job()
    job.task_groups[0].tasks[0].resources.networks = []
    job.task_groups[0].tasks[0].resources.cpu = rng.choice([50, 400])
    if use_racks:
        job.constraints.append(Constraint(
            ltarget="${meta.rack}", operand="=", rtarget="r0"))
    nodes = []
    for i in range(n_nodes):
        node = mock.node()
        if use_racks:
            node.meta["rack"] = f"r{i % 2}"
        node.compute_class()
        nodes.append(node)
    drained = [n.id for n in nodes[: int(n_nodes * drain_frac)]]

    h = Harness(seed=seed)
    for node in nodes:
        h.state.upsert_node(h.next_index(), node)
    h.state.upsert_job(h.next_index(), job.copy())
    for nid in drained:
        h.state.update_node_drain(h.next_index(), nid, True)
    hp_host = carry_over(h)
    before = carry_over(h).state.snapshot()
    ev = new_eval(h.state.job_by_id(job.id), consts.EVAL_TRIGGER_NODE_UPDATE)
    hp = run_both(PAIRS[1], h, ev)
    hp_host.process("system", port_eval(ev))

    dense = hp.state.allocs_by_job(job.id)
    host = hp_host.state.allocs_by_job(job.id)
    assert {a.node_id for a in dense} == {a.node_id for a in host}
    assert not {a.node_id for a in dense} & set(drained)
    assert hp.evals[0].queued_allocations == \
        hp_host.evals[0].queued_allocations
    verify_port_plan(hp, before)
    verify_port_plan(hp_host, before)


# ------------------------- config 5's drain storm, scaled to 200 x 20


def test_drain_storm_four_factories_agree():
    """bench.py ``_system_drain_storm`` at 200 nodes x 20 rack-scoped
    system jobs, 10% of the nodes drained, one node-update eval a job:
    the JAX package's system and system-tpu and the port's system and
    system-gpu agree per job on the placed (node, task group) set and
    the queued counts; the dense pair also alloc for alloc."""
    n_nodes, n_jobs = 200, 20
    nodes = []
    for i in range(n_nodes):
        node = mock.node()
        node.meta["rack"] = f"r{i % n_jobs}"
        node.compute_class()
        nodes.append(node)
    jobs = []
    for j in range(n_jobs):
        job = strip_net(mock.system_job())
        job.id = f"sys-{j}"
        job.constraints.append(Constraint(
            ltarget="${meta.rack}", operand="=", rtarget=f"r{j}"))
        job.task_groups[0].tasks[0].resources.cpu = 5
        job.task_groups[0].tasks[0].resources.memory_mb = 8
        jobs.append(job)
    drained = {n.id for n in nodes[: n_nodes // 10]}

    refs = {}
    for name in ("system", "system-tpu"):
        h = Harness(seed=5)
        for node in nodes:
            h.state.upsert_node(h.next_index(), node)
        for job in jobs:
            h.state.upsert_job(h.next_index(), job)
        for nid in sorted(drained):
            h.state.update_node_drain(h.next_index(), nid, True)
        refs[name] = h
    ports = {"system": carry_over(refs["system"]),
             "system-gpu": carry_over(refs["system-tpu"])}
    runs = [(refs["system"], "system"), (refs["system-tpu"], "system-tpu"),
            (ports["system"], "system"), (ports["system-gpu"], "system-gpu")]
    for job in jobs:
        ev = mock.eval()
        ev.job_id = job.id
        ev.type = consts.JOB_TYPE_SYSTEM
        ev.triggered_by = consts.EVAL_TRIGGER_NODE_UPDATE
        seen = []
        for harness, name in runs:
            e = ev if harness in refs.values() else port_eval(ev)
            harness.process(name, e)
            allocs = harness.state.allocs_by_job(job.id)
            seen.append((sorted((a.node_id, a.task_group) for a in allocs),
                         harness.evals[-1].queued_allocations,
                         harness.evals[-1].status))
        assert all(s == seen[0] for s in seen), job.id
        assert len(seen[0][0]) == n_nodes // n_jobs - 1
        assert not {nid for nid, _tg in seen[0][0]} & drained
    assert_same(refs["system-tpu"], ports["system-gpu"])


# ------------------------------------------------------------- registry


def test_registry_lists_and_resolves_system_factories():
    """scheduler_names() lists both; system is registered when the
    package is imported and system-gpu resolves lazily, in a fresh
    interpreter, without loading the port's device code."""
    import subprocess
    import sys
    from pathlib import Path

    from nomad_tpu_torch.scheduler import scheduler_names

    assert {"system", "system-gpu"} <= set(scheduler_names())
    code = (
        "import logging, sys\n"
        "import nomad_tpu_torch.scheduler as s\n"
        "from nomad_tpu_torch.state import StateStore\n"
        "assert 'system' in s._BUILTIN and 'system-gpu' not in s._BUILTIN\n"
        "assert 'nomad_tpu_torch.ops.cuda' not in sys.modules\n"
        "sched = s.new_scheduler('system-gpu', logging.getLogger('t'),"
        " StateStore().snapshot(), None)\n"
        "print(type(sched).__name__, isinstance(sched, s.SystemScheduler))\n")
    repo = Path(__file__).resolve().parent.parent
    out = subprocess.run([sys.executable, "-c", code], cwd=repo,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.split() == ["DenseSystemScheduler", "True"]


def test_system_factories_need_no_device():
    """Neither system factory resolves a device: both are host passes
    in the JAX package too."""
    from nomad_tpu_torch.device import set_default_device
    from nomad_tpu_torch.scheduler import new_scheduler
    from nomad_tpu_torch.state import StateStore

    set_default_device(None)
    try:
        for name in ("system", "system-gpu"):
            sched = new_scheduler(name, logging.getLogger("test"),
                                  StateStore().snapshot(), None)
            assert not hasattr(sched, "device")
    finally:
        set_default_device("cpu")
