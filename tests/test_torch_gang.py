"""K7 and the gang legs (nomad_tpu_torch/ops/gang.py, gang/,
scheduler/generic.py and scheduler/tpu.py) against the JAX package on
the same inputs.

The JAX program runs jitted on the CPU, as the JAX package's own tests
run it; the port runs its plain PyTorch versions (CPU tensors).
Choices and slice groups must be equal, scores within 1e-4 (float32
``pow`` may differ in its last bits between the two libraries). The
scheduler cases run the JAX package's "service-tpu" against the port's
"service-gpu", and the two host "service" schedulers, on one
carried-over Harness."""

from __future__ import annotations

import numpy as np
import pytest

import torch_parity  # noqa: F401  (the port on the CPU, one torch thread)
from nomad_tpu import mock
from nomad_tpu.gang import build_gang_state as jax_build_gang_state
from nomad_tpu.ops.binpack import host_prng_key
from nomad_tpu.ops.gang import (
    GangConfig,
    _group_capacity,
    _member_units,
    gang_placement_program_jit,
    make_gang_state,
)
from nomad_tpu.scheduler.testing import Harness, seed_harness_cluster
from nomad_tpu.structs import Constraint, Gang, consts
from nomad_tpu.structs.eval import new_eval
from nomad_tpu_torch import carry
from nomad_tpu_torch import gang as port_gang
from nomad_tpu_torch.ops import gang as port_ops
from torch_parity import (
    carry_over,
    failed_view,
    gang_view,
    plan_view,
    port_eval,
)

SCORE_TOL = 1e-4
MODES = ("free", "slice", "spread", "affinity")


@pytest.fixture(autouse=True)
def _reset_stats():
    from nomad_tpu.gang import reset_gang_stats

    reset_gang_stats()
    port_gang.reset_gang_stats()
    yield
    reset_gang_stats()
    port_gang.reset_gang_stats()


# ---------------------------------------------------------------------
# the program


def _hand_state(caps, racks, feas=None):
    """The JAX package's hand-built GangState: caps[i] = (cpu, mem)."""
    n = len(caps)
    capacity = np.zeros((n, 4), np.float32)
    capacity[:, 0] = [c[0] for c in caps]
    capacity[:, 1] = [c[1] for c in caps]
    capacity[:, 2] = 100_000
    capacity[:, 3] = 10_000
    return make_gang_state(
        capacity=capacity, sched_capacity=capacity,
        util=np.zeros((n, 4), np.float32), bw_avail=np.full(n, 1e9),
        bw_used=np.zeros(n), ports_free=np.full(n, 100),
        feas_row=np.ones(n, bool) if feas is None else feas,
        job_count=np.zeros(n, np.int32), dh_presence=np.zeros(n, np.int32),
        topo_ids=np.asarray(racks, np.int32))


def _both(state, k, config, ask=(400, 256, 0, 0), bw=0.0, ports=0.0,
          seed=3, k_pad=8):
    """(JAX, port) of one gang dispatch; asserts they agree and
    returns the port's (choices, scores, slice_group) as numpy."""
    active = np.zeros(k_pad, bool)
    active[:k] = True
    ask = np.asarray(ask, np.float32)
    key = host_prng_key(seed)
    want = gang_placement_program_jit(state, ask, np.float32(bw),
                                      np.float32(ports), active, key, config)
    got = port_ops.gang_placement(
        port_ops.make_gang_state(*state), ask, np.float32(bw),
        np.float32(ports), active, key, port_ops.GangConfig(*config), "cpu")
    want = tuple(np.asarray(x) for x in want)
    got = tuple(x.numpy() for x in got)
    assert np.array_equal(want[0], got[0])
    assert int(want[2]) == int(got[2])
    assert np.abs(want[1] - got[1]).max() <= SCORE_TOL
    return got


def _cfg(mode, dh=False, g_pad=16, penalty=0.0):
    return GangConfig(anti_affinity_penalty=penalty, mode=mode,
                      distinct_hosts=dh, g_pad=g_pad)


def test_slice_picks_tightest_sufficient_group():
    state = _hand_state([(450, 300), (450, 300), (900, 600), (900, 600),
                         (2200, 1500), (2200, 1500)], [0, 0, 1, 1, 2, 2])
    ch, _s, grp = _both(state, 4, _cfg("slice"))
    assert grp == 1 and set(ch[:4]) == {2, 3}
    assert (ch[4:] == -1).all()


def test_all_k_or_nothing():
    state = _hand_state([(450, 300)] * 3, [0, 0, 1])
    ch, sc, grp = _both(state, 4, _cfg("free"))
    assert (ch == -1).all() and grp == -1 and (sc == 0).all()


def test_slice_requires_single_group():
    state = _hand_state([(900, 600), (900, 600)], [0, 1])
    ch, _s, grp = _both(state, 4, _cfg("slice"))
    assert (ch == -1).all() and grp == -1
    ch, _s, _g = _both(state, 4, _cfg("free"))
    assert (ch[:4] >= 0).all()


def test_slice_excludes_topologyless_nodes():
    state = _hand_state([(450, 300), (5000, 5000)], [0, -1])
    ch, _s, _g = _both(state, 2, _cfg("slice"))
    assert (ch == -1).all()


def test_spread_caps_members_per_group():
    state = _hand_state([(5000, 5000)] * 4, [0, 1, 2, 3])
    ch, _s, _g = _both(state, 4, _cfg("spread"))
    assert sorted(ch[:4]) == [0, 1, 2, 3]


def test_spread_cap_counts_active_members_only():
    """ceil(k_actual / eligible), not over the padded K: 3 members over
    3 groups is one per group even with K padded to 8."""
    state = _hand_state([(5000, 5000)] * 6, [0, 0, 1, 1, 2, 2])
    ch, _s, _g = _both(state, 3, _cfg("spread"))
    assert len({c // 2 for c in ch[:3]}) == 3


def test_distinct_hosts_one_member_per_node():
    state = _hand_state([(5000, 5000)] * 4, [0, 0, 0, 0])
    ch, _s, _g = _both(state, 4, _cfg("free", dh=True))
    assert sorted(ch[:4]) == [0, 1, 2, 3]
    ch, _s, _g = _both(state, 5, _cfg("free", dh=True))
    assert (ch == -1).all()


def test_affinity_co_locates():
    state = _hand_state([(2000, 2000)] * 4, [0, 0, 1, 1])
    ch, _s, _g = _both(state, 4, _cfg("affinity"))
    assert len({0 if c in (0, 1) else 1 for c in ch[:4]}) == 1


@pytest.mark.parametrize("mode", ["slice", "free"])
def test_zero_ask_units_pass_2_24(mode):
    """A zero ask gives every feasible node 1e9 units, so group sums
    pass 2^24; the chosen group and the placements still agree."""
    n = 60
    racks = [i // 13 for i in range(n)]
    feas = np.random.default_rng(1).random(n) < 0.8
    state = _hand_state([(1000, 1000)] * n, racks, feas=feas)
    ch, _s, grp = _both(state, 6, _cfg(mode), ask=(0, 0, 0, 0))
    assert (ch[:6] >= 0).all()
    if mode == "slice":
        assert grp >= 0
    units = np.asarray(_member_units(state, np.zeros(4, np.float32),
                                     np.float32(0), np.float32(0),
                                     _cfg(mode)))
    assert units.max() == 1e9
    caps = np.asarray(_group_capacity(units, state.topo_ids, 16))
    assert caps.max() > 2 ** 24


def _random_state(rng, n, rack):
    cap = np.tile(np.array([[2000, 4000, 10000, 100]], np.float32), (n, 1))
    sched = cap - np.array([[100, 200, 0, 0]], np.float32)
    sched[rng.random(n) < 0.03, 1] = 0.0  # the zero-capacity guard binds
    util = (cap - sched) + np.stack(
        [rng.integers(0, 30, n) * 50, rng.integers(0, 30, n) * 100,
         np.zeros(n), np.zeros(n)], 1).astype(np.float32)
    topo = (np.arange(n) // rack).astype(np.int32)
    topo[rng.random(n) < 0.1] = -1
    return make_gang_state(
        cap, sched, util, np.full(n, 100.0), rng.integers(0, 5, n) * 20.0,
        rng.integers(0, 4, n), rng.random(n) < 0.9, rng.integers(0, 3, n),
        (rng.random(n) < 0.1).astype(np.int32), topo)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dh", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_random_cluster_every_mode(mode, dh, seed):
    """Seeded clusters: racks of 12 with nodes lacking topology, free
    ports and bandwidth that bind, job_count and dh conflicts."""
    rng = np.random.default_rng(seed)
    state = _random_state(rng, 120, 12)
    k = int(rng.integers(4, 9))
    got = _both(state, k, _cfg(mode, dh=dh, penalty=10.0), bw=10.0,
                ports=1.0, seed=40 + seed)
    assert got[0].shape == (8,)


@pytest.mark.parametrize("mode", MODES)
def test_more_than_1024_groups(mode):
    """1,200 racks of two (g_pad 2,048), as a level that most nodes
    lack gives in free, spread and affinity mode."""
    rng = np.random.default_rng(9)
    state = _random_state(rng, 2400, 2)
    got = _both(state, 6, _cfg(mode, g_pad=2048, penalty=10.0), bw=10.0,
                ports=1.0, seed=21)
    assert got[0].shape == (8,)


def test_member_units_and_group_capacity_match():
    rng = np.random.default_rng(4)
    state = _random_state(rng, 200, 10)
    ask = np.array([300, 256, 0, 0], np.float32)
    for mode in MODES:
        for dh in (False, True):
            cfg = _cfg(mode, dh=dh, g_pad=64)
            want = np.asarray(_member_units(state, ask, np.float32(10),
                                            np.float32(1), cfg))
            t = carry.gang_state_from_numpy(state, "cpu")
            import torch

            got = port_ops.member_units_plain(
                t, torch.from_numpy(ask), torch.tensor(np.float32(10)),
                torch.tensor(np.float32(1)), port_ops.GangConfig(*cfg))
            assert np.array_equal(want, got.numpy())
            assert np.array_equal(
                np.asarray(_group_capacity(want, state.topo_ids, 64)),
                port_ops.group_capacity_plain(got, t.topo_ids, 64).numpy())


# ---------------------------------------------------------------------
# the scheduler


def topo_nodes(n=12, rack_size=4, cpu=3000, mem=3000, bare=0):
    """n nodes in racks of rack_size with ICI pairs inside each rack;
    the last ``bare`` nodes carry no topology meta."""
    nodes = []
    for i in range(n):
        node = mock.node()
        node.resources.cpu = cpu
        node.resources.memory_mb = mem
        if i < n - bare:
            node.meta["rack"] = f"r{i // rack_size}"
            node.meta["ici"] = f"r{i // rack_size}-i{(i % rack_size) // 2}"
        node.compute_class()
        nodes.append(node)
    return nodes


def gang_job(k=4, cpu=400, mem=256, slice="", affinity="", spread="",
             jid="gang-job", ports=False, dh=False):
    job = mock.job()
    job.id = jid
    tg = job.task_groups[0]
    tg.count = k
    tg.gang = Gang(slice=slice, affinity=affinity, spread=spread)
    t = tg.tasks[0]
    t.resources.cpu = cpu
    t.resources.memory_mb = mem
    if not ports:
        t.resources.networks = []
    if dh:
        tg.constraints.append(
            Constraint(operand=consts.CONSTRAINT_DISTINCT_HOSTS))
    return job


def _assert_same(h, hp, since=(0, 0, 0)):
    plans, evals, created = since
    h_plans = h.plans[plans:]
    assert len(h_plans) == len(hp.plans)
    for pj, pt in zip(h_plans, hp.plans):
        vj, vt = plan_view(pj), plan_view(pt)
        assert set(vj) == set(vt)
        for name, (node, scores, ports) in vj.items():
            assert (node, ports) == (vt[name][0], vt[name][2]), name
            assert set(scores) == set(vt[name][1])
            for key, s in scores.items():
                assert abs(s - vt[name][1][key]) <= SCORE_TOL
        assert gang_view(pj) == gang_view(pt)
        assert ({n: sorted(a.id for a in u) for n, u in
                 pj.node_update.items()}
                == {n: sorted(a.id for a in u) for n, u in
                    pt.node_update.items()})
    assert [failed_view(e) for e in h.evals[evals:]] == \
        [failed_view(e) for e in hp.evals]
    assert [e.status for e in h.evals[evals:]] == [e.status
                                                    for e in hp.evals]
    assert [e.status for e in h.create_evals[created:]] == [
        e.status for e in hp.create_evals]


SCHED_CASES = {
    "slice": dict(k=4, slice="rack"),
    "slice_reject": dict(k=9, cpu=1000, mem=1000, slice="rack"),
    "free": dict(k=9, cpu=1000, mem=1000),
    "spread": dict(k=6, spread="rack"),
    "affinity": dict(k=3, affinity="rack"),
    "slice_ici_ports": dict(k=5, slice="ici", ports=True),
    "spread_ports": dict(k=6, spread="ici", ports=True),
    "slice_dh": dict(k=4, slice="rack", dh=True),
}


@pytest.mark.parametrize("factories", [("service-tpu", "service-gpu"),
                                       ("service", "service")],
                         ids=["dense", "host"])
@pytest.mark.parametrize("case", sorted(SCHED_CASES))
def test_gang_job_same_plan(factories, case):
    """The gang jobs of the JAX package's tests on 12 nodes in racks of
    4 (two without topology): same members, nodes, ports, gang leg and
    failure metrics."""
    nodes = topo_nodes(n=12, bare=2)
    job = gang_job(**SCHED_CASES[case])
    h = Harness(seed=7)
    seed_harness_cluster(h, nodes=nodes, jobs=[job.copy()])
    hp = carry_over(h)
    ev = new_eval(h.state.job_by_id(job.id), consts.EVAL_TRIGGER_JOB_REGISTER)
    h.process(factories[0], ev)
    hp.process(factories[1], port_eval(ev))
    _assert_same(h, hp)
    live = [a for a in hp.state.allocs_by_job(job.id)
            if not a.terminal_status()]
    k = SCHED_CASES[case]["k"]
    if case == "slice_reject":
        assert live == [] and hp.plans == []
        (failed,) = hp.evals[-1].failed_tg_allocs.values()
        assert failed.coalesced_failures == (k - 1 if factories[1]
                                             == "service-gpu" else 0)
        assert port_gang.gang_stats()["gangs_rejected"] == 1
    else:
        assert len(live) == k
        assert port_gang.gang_stats()["gangs_placed"] == 1


BARE_CASES = {
    "free": dict(k=40),
    "spread": dict(k=40, spread="rack"),
    "affinity": dict(k=20, affinity="ici"),
    "slice": dict(k=4, slice="rack"),
}


@pytest.mark.parametrize("case", sorted(BARE_CASES))
def test_gang_without_topology_meta_same_plan(case):
    """1,100 nodes without rack or ici meta: free, spread and affinity
    make every node its own group (g_pad 2,048), slice excludes them
    all and rejects the gang whole."""
    nodes = topo_nodes(n=1100, bare=1100)
    job = gang_job(**BARE_CASES[case])
    h = Harness(seed=7)
    seed_harness_cluster(h, nodes=nodes, jobs=[job.copy()])
    hp = carry_over(h)
    ev = new_eval(h.state.job_by_id(job.id), consts.EVAL_TRIGGER_JOB_REGISTER)
    h.process("service-tpu", ev)
    hp.process("service-gpu", port_eval(ev))
    _assert_same(h, hp)
    live = [a for a in hp.state.allocs_by_job(job.id)
            if not a.terminal_status()]
    want = 0 if case == "slice" else BARE_CASES[case]["k"]
    assert len(live) == want
    if case == "spread":  # a cap of one member a group: one a node
        assert len({a.node_id for a in live}) == want


def test_node_down_replaces_whole_gang_same_plan():
    """A member's node goes down: both packages stop the survivors and
    re-place all K as a unit, with the same plan."""
    nodes = topo_nodes(n=12)
    job = gang_job(k=4, slice="rack")
    h = Harness(seed=9)
    seed_harness_cluster(h, nodes=nodes, jobs=[job.copy()])
    h.process("service-tpu", new_eval(h.state.job_by_id(job.id),
                                      consts.EVAL_TRIGGER_JOB_REGISTER))
    first = [a for a in h.state.allocs_by_job(job.id)
             if not a.terminal_status()]
    node = h.state.node_by_id(first[0].node_id)
    node.status = consts.NODE_STATUS_DOWN
    h.state.upsert_node(h.next_index(), node)
    hp = carry_over(h)
    since = (len(h.plans), len(h.evals), len(h.create_evals))
    ev = new_eval(h.state.job_by_id(job.id), consts.EVAL_TRIGGER_NODE_UPDATE)
    h.process("service-tpu", ev)
    hp.process("service-gpu", port_eval(ev))
    _assert_same(h, hp, since)
    live = [a for a in hp.state.allocs_by_job(job.id)
            if not a.terminal_status()]
    assert len(live) == 4
    assert {a.id for a in live}.isdisjoint({a.id for a in first})


def test_build_gang_state_matches_reference():
    """The dense inputs of a gang dispatch (state, member mask, ask,
    config) are the JAX package's, for each mode."""
    from nomad_tpu.models.matrix import ClusterMatrix as JaxMatrix
    from nomad_tpu_torch.models.matrix import ClusterMatrix as PortMatrix

    nodes = topo_nodes(n=12, bare=2)
    for case in ("slice", "spread", "affinity", "slice_dh"):
        job = gang_job(**SCHED_CASES[case], jid=f"g-{case}")
        h = Harness(seed=3)
        seed_harness_cluster(h, nodes=nodes, jobs=[job.copy()])
        hp = carry_over(h)
        jj, pj = h.state.job_by_id(job.id), hp.state.job_by_id(job.id)
        want = jax_build_gang_state(JaxMatrix(h.state.snapshot(), jj), jj,
                                    jj.task_groups[0])
        got = port_gang.build_gang_state(
            PortMatrix(hp.state.snapshot(), pj), pj, pj.task_groups[0])
        for x, y in zip(want[0], got[0]):
            assert np.array_equal(x, y) and x.dtype == y.dtype
        assert np.array_equal(want[1], got[1])
        for x, y in zip(want[2], got[2]):
            assert np.array_equal(x, y)
        assert tuple(want[3]) == tuple(got[3])


def test_mixed_update_replaces_whole_gang_same_plan():
    """An update in-place compatible on every member's node but one (a
    tightened constraint fails there) routes the whole gang destructive
    in both packages: the same stops and the same re-placement."""
    nodes = topo_nodes(n=12)
    job = gang_job(k=4, slice="rack")
    h = Harness(seed=11)
    seed_harness_cluster(h, nodes=nodes, jobs=[job.copy()])
    h.process("service-tpu", new_eval(h.state.job_by_id(job.id),
                                      consts.EVAL_TRIGGER_JOB_REGISTER))
    first = [a for a in h.state.allocs_by_job(job.id)
             if not a.terminal_status()]
    bad_node = first[0].node_id
    for node in nodes:
        node.meta["keep"] = "no" if node.id == bad_node else "yes"
        node.compute_class()
        h.state.upsert_node(h.next_index(), node)
    updated = h.state.job_by_id(job.id).copy()
    updated.task_groups[0].tasks[0].env["PHASE"] = "2"
    updated.constraints.append(Constraint(
        ltarget="${meta.keep}", rtarget="yes", operand="="))
    updated.job_modify_index += 1
    updated.modify_index += 1
    h.state.upsert_job(h.next_index(), updated)
    hp = carry_over(h)
    since = (len(h.plans), len(h.evals), len(h.create_evals))
    ev = new_eval(h.state.job_by_id(job.id), consts.EVAL_TRIGGER_JOB_REGISTER)
    h.process("service-tpu", ev)
    hp.process("service-gpu", port_eval(ev))
    _assert_same(h, hp, since)
    live = [a for a in hp.state.allocs_by_job(job.id)
            if not a.terminal_status()]
    assert len(live) == 4 and bad_node not in {a.node_id for a in live}
    assert {a.id for a in live}.isdisjoint({a.id for a in first})
