"""K6 and the preemption leg (nomad_tpu_torch/ops/preempt.py,
migrate/, models/matrix.py build_victims, scheduler/tpu.py
_preempt_placements) against the JAX package on the same inputs.

The JAX program runs jitted on the CPU, as the JAX package's own tests
run it; the port runs its plain PyTorch versions (CPU tensors).
Choices and victim counts must be equal, scores within 1e-4 (float32
``pow`` may differ in its last bits between the two libraries)."""

from __future__ import annotations

import numpy as np
import pytest

import torch_parity  # noqa: F401  (the port on the CPU, one torch thread)
from nomad_tpu import mock
from nomad_tpu import migrate as jax_migrate
from nomad_tpu.ops.binpack import PlacementConfig as JaxConfig
from nomad_tpu.ops.binpack import host_prng_key, make_asks, make_node_state
from nomad_tpu.ops.preempt import (
    make_victim_state,
    preempt_placement_program_jit,
)
from nomad_tpu.scheduler.testing import Harness
from nomad_tpu.structs import consts
from nomad_tpu.structs.eval import new_eval
from nomad_tpu_torch import carry
from nomad_tpu_torch import migrate as port_migrate
from nomad_tpu_torch.ops import binpack as port_binpack
from nomad_tpu_torch.ops import preempt as port_preempt
from torch_parity import (
    carry_over,
    failed_view,
    plan_view,
    port_eval,
    preemptions_view,
)

V = port_preempt.PREEMPT_MAX_VICTIMS
SCORE_TOL = 1e-4


@pytest.fixture(autouse=True)
def _restore_policy():
    """The preemption policy is process-global in both packages."""
    yield
    for mod in (jax_migrate, port_migrate):
        mod.configure(migrate_max_parallel=32, preemption_enabled=False,
                      preempt_priority_threshold=50)
        mod._policy.configure(pressure_probe=lambda: "green")


# ---------------------------------------------------------------------
# the program, unit by unit


def _state(n=4, util=90.0, cap=100.0, ports=20.0, job_count=0):
    capacity = np.full((n, 4), cap, np.float32)
    return make_node_state(
        capacity=capacity, sched_capacity=capacity,
        util=np.full((n, 4), util, np.float32),
        bw_avail=np.full(n, 1000.0), bw_used=np.zeros(n),
        ports_free=np.full(n, ports), job_count=np.full(n, job_count),
        tg_count=np.zeros((n, 1)), feasible=np.ones((n, 1), bool),
        node_ok=np.ones(n, bool))


def _asks(k, res, ports=0.0, active=None, job_dh=False):
    return make_asks(
        resources=np.full((k, 4), res, np.float32), bw=np.zeros(k),
        ports=np.full(k, ports), tg_index=np.zeros(k, np.int32),
        active=np.ones(k, bool) if active is None else active,
        job_distinct_hosts=job_dh, tg_distinct_hosts=np.zeros(1, bool))


def _victims(n, entries):
    """entries: {row: [(res, prio) or (res, prio, ports), ...]},
    priority-ascending."""
    res = np.zeros((n, V, 4), np.float32)
    bw = np.zeros((n, V), np.float32)
    ports = np.zeros((n, V), np.float32)
    prio = np.full((n, V), np.inf, np.float32)
    ok = np.zeros((n, V), bool)
    for row, lst in entries.items():
        for v, ent in enumerate(lst):
            res[row, v] = ent[0]
            prio[row, v] = ent[1]
            ports[row, v] = ent[2] if len(ent) > 2 else 0.0
            ok[row, v] = True
    return make_victim_state(res, bw, ports, prio, ok)


def _both(state, victims, asks, seed, priority, penalty=10.0):
    """(JAX, port) results as numpy, each (choices, scores, counts)."""
    key = host_prng_key(seed)
    want = preempt_placement_program_jit(
        state, victims, asks, key, np.float32(priority),
        JaxConfig(anti_affinity_penalty=penalty))
    got = port_preempt.preempt_placement(
        port_binpack.make_node_state(*state),
        port_preempt.make_victim_state(*victims),
        port_binpack.make_asks(*asks), key, np.float32(priority),
        port_binpack.PlacementConfig(anti_affinity_penalty=penalty), "cpu")
    want = tuple(np.asarray(x) for x in want)
    got = tuple(x.numpy() for x in got)
    assert np.array_equal(want[0], got[0])
    assert np.array_equal(want[2], got[2])
    assert np.abs(want[1] - got[1]).max() <= SCORE_TOL
    return got


def test_selects_lowest_priority_prefix():
    got = _both(_state(), _victims(4, {0: [(30.0, 10), (30.0, 20)]}),
                _asks(2, 25.0), 7, 50)
    # Both asks land on node 0, each consuming ONE victim in order.
    assert list(got[0]) == [0, 0] and list(got[2]) == [1, 1]


def test_normal_fit_beats_preemption():
    state = _state(util=90.0)
    state.util[2, :] = 10.0
    got = _both(state, _victims(4, {0: [(60.0, 10)], 1: [(60.0, 10)]}),
                _asks(1, 25.0), 3, 50)
    assert int(got[0][0]) == 2 and int(got[2][0]) == 0


def test_never_evicts_equal_or_higher_priority():
    got = _both(_state(), _victims(4, {0: [(60.0, 50)], 1: [(60.0, 80)]}),
                _asks(1, 25.0), 5, 50)
    assert int(got[0][0]) == -1 and int(got[2][0]) == 0


def test_prefix_stops_at_first_fit():
    got = _both(_state(util=95.0),
                _victims(4, {1: [(40.0, 5), (40.0, 30)]}),
                _asks(1, 25.0), 9, 50)
    assert int(got[0][0]) == 1 and int(got[2][0]) == 1


def test_outranking_victim_ends_the_prefix():
    """A live victim at or above the eval's priority ends the prefix:
    the one behind it stays out of reach."""
    got = _both(_state(util=95.0),
                _victims(4, {0: [(10.0, 5), (50.0, 60), (50.0, 7)]}),
                _asks(1, 25.0), 2, 50)
    assert int(got[0][0]) == -1


def test_consumed_victim_is_never_reused():
    """Three asks on a one-node cluster with three small victims: each
    ask evicts the NEXT victim, never one an earlier ask consumed."""
    got = _both(_state(n=1, util=100.0),
                _victims(1, {0: [(30.0, 10), (30.0, 20), (30.0, 30),
                                 (30.0, 40)]}),
                _asks(3, 25.0), 11, 50)
    assert list(got[0]) == [0, 0, 0]
    # ask 0 frees 30 (5 left over), ask 1 fits in 5 + 30, ...
    assert sum(got[2]) == 3


def test_ports_bind_the_victim_prefix():
    """No free ports: the prefix must reach a victim holding ports."""
    got = _both(_state(util=50.0, ports=0.0),
                _victims(4, {3: [(10.0, 5, 0.0), (10.0, 6, 2.0)]}),
                _asks(1, 25.0, ports=2.0), 4, 50)
    assert int(got[0][0]) == 3 and int(got[2][0]) == 2


def test_job_distinct_hosts_excludes_nodes_with_the_job():
    state = _state(util=95.0)
    state.job_count[:] = [1, 0, 1, 1]
    victims = _victims(4, {r: [(40.0, 5)] for r in range(4)})
    got = _both(state, victims, _asks(2, 25.0, job_dh=True), 8, 50)
    assert int(got[0][0]) == 1
    assert int(got[0][1]) == -1  # node 1 now holds the job too


def test_padding_asks_place_nothing():
    active = np.array([True, True, False, False])
    got = _both(_state(), _victims(4, {0: [(40.0, 5)], 2: [(40.0, 5)]}),
                _asks(4, 25.0, active=active), 12, 50)
    assert list(got[0][2:]) == [-1, -1] and list(got[2][2:]) == [0, 0]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_random_crowded_cluster(seed):
    """Seeded crowded clusters: varied footprints, victims holding
    ports and bandwidth, task-group distinct_hosts on group 0, some
    nodes with room, padding asks."""
    rng = np.random.default_rng(seed)
    n, k, g = 96, 32, 2
    cap = np.tile(np.array([[1000, 2000, 10000, 100]], np.float32), (n, 1))
    sched = cap - np.array([[100, 200, 0, 0]], np.float32)
    util = (cap - sched) + np.stack(
        [rng.integers(12, 19, n) * 50, rng.integers(10, 19, n) * 100,
         np.zeros(n), np.zeros(n)], 1).astype(np.float32)
    util[rng.random(n) < 0.05, :2] = (300, 400)
    state = make_node_state(
        cap, sched, util, np.full(n, 100.0), rng.integers(0, 5, n) * 20.0,
        rng.integers(0, 3, n), rng.integers(0, 2, n),
        rng.integers(0, 2, (n, g)), rng.random((n, g)) < 0.9,
        rng.random(n) < 0.95)
    entries = {}
    for i in range(n):
        m = int(rng.integers(0, V + 1))
        prios = np.sort(rng.integers(5, 80, m))
        entries[i] = [((rng.integers(1, 6) * 50, rng.integers(1, 6) * 100,
                        0, 0), int(p), float(rng.integers(0, 2)))
                      for p in prios]
    victims = _victims(n, entries)
    victims.bw[:] = np.where(victims.ok,
                             rng.integers(0, 3, (n, V)) * 10.0, 0.0)
    active = np.ones(k, bool)
    active[-3:] = False
    asks = make_asks(np.tile([[300, 400, 0, 0]], (k, 1)), np.full(k, 20.0),
                     np.ones(k), rng.integers(0, g, k), active, False,
                     np.array([True, False]))
    got = _both(state, victims, asks, 100 + seed, 50)
    assert (got[2] > 0).any()


def test_carried_victim_state_matches():
    """carry.victim_state_from_numpy hands the JAX package's arrays
    over as tensors of the same dtypes and values."""
    victims = _victims(3, {1: [(5.0, 3, 1.0)]})
    t = carry.victim_state_from_numpy(victims, "cpu")
    for x, y in zip(victims, t):
        assert np.array_equal(x, y.numpy()) and x.dtype == y.numpy().dtype


# ---------------------------------------------------------------------
# the host side: policy, oracle, victim tensor


def test_eligibility_policy():
    port_migrate.configure(preemption_enabled=False,
                           pressure_probe=lambda: "red")
    assert not port_migrate.preemption_eligible(90)
    port_migrate.configure(preemption_enabled=True,
                           preempt_priority_threshold=50)
    assert port_migrate.preemption_eligible(51)
    assert not port_migrate.preemption_eligible(50)

    def broken():
        raise RuntimeError("probe down")

    port_migrate.configure(pressure_probe=broken)
    assert not port_migrate.preemption_eligible(90)
    port_migrate.configure(pressure_probe=lambda: "yellow")
    assert not port_migrate.preemption_eligible(90)
    before = port_migrate.preempt_stats()["evictions_staged"]
    port_migrate.note_preemption(3, 2)
    port_migrate.note_preemption_committed(3)
    stats = port_migrate.churn_stats()["preemption"]
    assert stats["evictions_staged"] == before + 3
    assert stats["evictions_committed"] >= 3


def _stub_allocs(rng, n=6):
    from nomad_tpu.structs import Resources

    out = []
    for i in range(n):
        a = mock.alloc()
        job = mock.job()
        job.priority = int(rng.choice([10, 20, 20, 30, 60]))
        a.job, a.job_id = job, job.id
        a.create_index = int(rng.integers(0, 5))
        a.task_resources = {"web": Resources(cpu=int(rng.integers(1, 4)) * 50,
                                             memory_mb=10)}
        a.shared_resources = None
        out.append(a)
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_select_victims_host_matches_reference(seed):
    from nomad_tpu_torch.structs import Allocation
    from nomad_tpu.utils.codec import to_dict
    from nomad_tpu_torch.utils.codec import from_dict

    rng = np.random.default_rng(seed)
    allocs = _stub_allocs(rng)
    ported = [from_dict(Allocation, to_dict(a)) for a in allocs]
    for need in (50.0, 150.0, 400.0, 5000.0):
        want = jax_migrate.select_victims_host(allocs, (need, 0, 0, 0), 50)
        got = port_migrate.select_victims_host(ported, (need, 0, 0, 0), 50)
        assert (want is None) == (got is None)
        if want is not None:
            assert [a.id for a in want] == [a.id for a in got]
    assert ([jax_migrate.victim_sort_key(a) for a in allocs]
            == [port_migrate.victim_sort_key(a) for a in ported])


def _storm_harness(seed, n_nodes=4, extra=()):
    """The JAX package's priority-storm fixture: one low-priority alloc
    filling each node, then a high-priority job of count n_nodes."""
    h = Harness(seed=seed)
    for _ in range(n_nodes):
        n = mock.node()
        n.resources.cpu = 1000
        n.resources.memory_mb = 4096
        n.compute_class()
        h.state.upsert_node(h.next_index(), n)
    for jid, prio, cpu in (("low-prio", 20, 600),) + tuple(extra):
        low = mock.job()
        low.id = jid
        low.priority = prio
        low.task_groups[0].count = n_nodes
        t = low.task_groups[0].tasks[0]
        t.resources.cpu = cpu
        t.resources.memory_mb = 256
        t.resources.networks = []
        h.state.upsert_job(h.next_index(), low)
        h.process("service-tpu", new_eval(h.state.job_by_id(low.id),
                                          consts.EVAL_TRIGGER_JOB_REGISTER))
    high = mock.job()
    high.id = "high-prio"
    high.priority = 60
    high.task_groups[0].count = n_nodes
    t = high.task_groups[0].tasks[0]
    t.resources.cpu = 500
    t.resources.memory_mb = 128
    t.resources.networks = []
    h.state.upsert_job(h.next_index(), high)
    return h, high


def test_build_victims_matches_reference():
    """The victim tensor and the ordered victim lists of a crowded
    cluster are the JAX package's."""
    from nomad_tpu.models.matrix import ClusterMatrix as JaxMatrix
    from nomad_tpu_torch.models.matrix import ClusterMatrix as PortMatrix

    h, high = _storm_harness(5, n_nodes=6,
                             extra=(("mid-prio", 30, 150),
                                    ("top-prio", 90, 100)))
    hp = carry_over(h)
    want = JaxMatrix(h.state.snapshot(), h.state.job_by_id(high.id))
    got = PortMatrix(hp.state.snapshot(), hp.state.job_by_id(high.id))
    (wa, wl, wt), (ga, gl, gt) = (m.build_victims(60) for m in (want, got))
    assert wt == gt > 0
    for x, y in zip(wa, ga):
        assert np.array_equal(x, y) and x.dtype == y.dtype
    assert ({r: [a.id for a in lst] for r, lst in wl.items()}
            == {r: [a.id for a in lst] for r, lst in gl.items()})


# ---------------------------------------------------------------------
# the scheduler: JAX "service-tpu" vs the port's "service-gpu"


def _configure(**kw):
    for mod in (jax_migrate, port_migrate):
        mod.configure(**kw)


def _run_storm(seed, n_nodes=4, extra=()):
    h, high = _storm_harness(seed, n_nodes, extra)
    hp = carry_over(h)
    # The reference harness keeps the set-up's history: compare what
    # this eval adds.
    plans, evals, created = len(h.plans), len(h.evals), len(h.create_evals)
    ev = new_eval(h.state.job_by_id(high.id),
                  consts.EVAL_TRIGGER_JOB_REGISTER)
    h.process("service-tpu", ev)
    hp.process("service-gpu", port_eval(ev))
    h_plans, h_evals = h.plans[plans:], h.evals[evals:]
    h_created = h.create_evals[created:]
    assert len(h_plans) == len(hp.plans)
    for pj, pt in zip(h_plans, hp.plans):
        vj, vt = plan_view(pj), plan_view(pt)
        assert set(vj) == set(vt)
        for name, (node, scores, ports) in vj.items():
            assert (node, ports) == vt[name][:1] + vt[name][2:]
            for key, s in scores.items():
                assert abs(s - vt[name][1][key]) <= SCORE_TOL
        assert preemptions_view(pj) == preemptions_view(pt)
    assert [failed_view(e) for e in h_evals] == \
        [failed_view(e) for e in hp.evals]
    assert [e.status for e in h_evals] == [e.status for e in hp.evals]
    assert ([(e.job_id, e.triggered_by, e.status) for e in h_created]
            == [(e.job_id, e.triggered_by, e.status)
                for e in hp.create_evals])
    return hp, high


@pytest.mark.parametrize("seed", [31, 36])
def test_priority_storm_preemption_on_same_plan(seed):
    _configure(preemption_enabled=True, preempt_priority_threshold=50,
               pressure_probe=lambda: "red")
    hp, high = _run_storm(seed)
    live = [a for a in hp.state.allocs_by_job(high.id)
            if not a.terminal_status()]
    assert len(live) == 4
    evicted = [a for a in hp.state.allocs_by_job("low-prio")
               if a.desired_status == consts.ALLOC_DESIRED_EVICT]
    assert len(evicted) == 4
    assert [e.triggered_by for e in hp.create_evals] == [
        consts.EVAL_TRIGGER_PREEMPTION]


def test_priority_storm_mixed_priorities_same_plan():
    """Three filler jobs per node (priorities 20, 30, 90): victims come
    lowest-priority first and the priority-90 job is never touched."""
    _configure(preemption_enabled=True, preempt_priority_threshold=50,
               pressure_probe=lambda: "red")
    hp, high = _run_storm(37, n_nodes=6, extra=(("mid-prio", 30, 150),
                                                ("top-prio", 90, 100)))
    assert not [a for a in hp.state.allocs_by_job("top-prio")
                if a.desired_status == consts.ALLOC_DESIRED_EVICT]


def test_priority_storm_preemption_off_same_plan():
    _configure(preemption_enabled=False, pressure_probe=lambda: "red")
    hp, high = _run_storm(32)
    assert not [a for a in hp.state.allocs_by_job(high.id)
                if not a.terminal_status()]
    assert any(e.status == consts.EVAL_STATUS_BLOCKED
               for e in hp.create_evals)


def test_priority_storm_green_cluster_same_plan():
    _configure(preemption_enabled=True, preempt_priority_threshold=50,
               pressure_probe=lambda: "green")
    hp, _high = _run_storm(33)
    assert not [a for a in hp.state.allocs_by_job("low-prio")
                if a.desired_status == consts.ALLOC_DESIRED_EVICT]
