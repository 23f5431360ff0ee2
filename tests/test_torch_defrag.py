"""The port's defrag solve (nomad_tpu_torch/defrag: K9's plain PyTorch
version on the CPU, the host rounding and move extraction, the wave
evals) against the JAX package's nomad_tpu/defrag on one carried-over
cluster, plus the JAX package's solver-level cases
(tests/test_defrag.py) run on the port.

Tolerances: the carried logits within LOGIT_TOL relative to
max(1, |logit|) (the relaxation's sums run in another order in
XLA-CPU than in torch); the moves (alloc and target) identical;
frag_before and frag_after within 1e-6 (float64 host arithmetic on the
same utilization). K9 alone is held against the float64 solve as
closely as JAX's solve is (solve_err)."""

from __future__ import annotations

import random

import numpy as np
import pytest
import torch

import torch_parity
from test_defrag import fragmented_harness

from nomad_tpu.defrag import WarmState as JaxWarmState
from nomad_tpu.defrag import compute_defrag_plan as jax_compute_defrag_plan
from nomad_tpu.defrag.solver import _solve_jit
from nomad_tpu.scheduler.testing import Harness as JaxHarness
from nomad_tpu.scheduler.testing import (
    churn_stop_small_allocs as jax_churn,
    seed_consolidation_cluster as jax_consolidation,
)
from nomad_tpu_torch import carry, mock
from nomad_tpu_torch.defrag import (
    WarmState,
    build_wave_evals,
    cluster_fragmentation,
    compute_defrag_plan,
    reference_asks,
)
from nomad_tpu_torch.kernels.convex import defrag_solve, defrag_solve_plain
from nomad_tpu_torch.kernels.differential import judge_migration_plan
from nomad_tpu_torch.migrate import configure as migrate_configure
from nomad_tpu_torch.migrate import get_governor
from nomad_tpu_torch.scheduler.testing import (
    Harness,
    churn_stop_small_allocs,
    seed_consolidation_cluster,
    seed_harness_cluster,
)
from nomad_tpu_torch.structs import consts
from nomad_tpu_torch.structs.eval import Evaluation

LOGIT_TOL = 1e-4
FRAG_TOL = 1e-6


@pytest.fixture(autouse=True)
def _governor_hygiene():
    """The port's migration governor is process-global: return leaked
    slots and re-baseline around every test."""
    migrate_configure(migrate_max_parallel=32)
    yield
    g = get_governor()
    leaked = g.stats()["in_flight"]
    if leaked:
        g.release(leaked)
    migrate_configure(migrate_max_parallel=32)
    g.reset_stats()


def port_fragmented():
    """tests/test_defrag.py's hand-placed fragmented cluster, carried
    over to the port."""
    return torch_parity.carry_over(fragmented_harness())


def assert_close(want, got, tol, relative):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    err = np.abs(want - got)
    if relative:
        err = err / np.maximum(1.0, np.abs(want))
    assert err.max() <= tol, f"error {err.max():.3g} > {tol}"


# ------------------------------------------------------------ K9 alone


def _solve_inputs(warm):
    """K9's inputs over 48 nodes: a residual state with a down node and
    a zero-capacity row, 32 asks (5 inactive padding rows), and for the
    warm case carried logits on about 70% of the rows."""
    rng = np.random.default_rng(11)
    k, w = 32, 48
    cap = np.tile(np.array([[1000, 1000, 5000, 100]], np.float32), (w, 1))
    cap[3, 0] = 0.0  # no CPU: infeasible even for an ask of no CPU
    active = np.ones(k, bool)
    active[-5:] = False
    ask = np.stack([rng.choice([300, 600], k), rng.choice([300, 600], k),
                    np.zeros(k), np.zeros(k)], 1).astype(np.float32)
    ask[0, 0] = 0.0
    return (rng.normal(0, 5, (k, w)).astype(np.float32),
            rng.random(k) < (0.3 if warm else 2.0),
            (cap * rng.random((w, 4)) * 0.8).astype(np.float32), cap, cap,
            rng.random(w) < 0.95, np.full(w, 400, np.float32),
            rng.integers(0, 300, w).astype(np.float32),
            rng.integers(0, 4, w).astype(np.float32), ask,
            np.full(k, 20.0, np.float32),
            rng.integers(0, 2, k).astype(np.float32), active)


def solve_err(got, want, kind):
    """The largest error of a K9 output: logits relative to max(1,
    |logit|), x relative to its row's largest entry (a row of x sums to
    1 over the nodes, so an absolute error says little)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    err = np.abs(got - want)
    if kind == "logits":
        return (err / np.maximum(1.0, np.abs(want))).max()
    return (err / np.maximum(np.abs(want).max(-1, keepdims=True),
                             1e-30)).max()


# Past this distance from float64 the comparison below holds nothing.
CHAOS_CAP = 0.1


@pytest.mark.parametrize("warm", [False, True])
def test_defrag_solve_tracks_float64_as_closely_as_jax(warm):
    """K9 alone on an over-committed residual state with tight ports is
    chaotic in float32: the over-capacity penalty flips mass between
    nodes each step, and a last-bit difference grows about tenfold
    every two steps (measured on these inputs, cold, both packages
    against the float64 solve: logits within 8e-4 relative after 2
    steps, 6e-3 after 8, 3e-2 after 10 and O(1) after 24, the port and
    JAX alternately the closer). A fixed tolerance against JAX would
    test the chaos, not the port: at 2, 5 and 8 steps the port must
    stay within 10x JAX's own distance from the float64 solve (plus
    1e-5), and that bound must stay under CHAOS_CAP. The tolerance
    check of the solve against JAX is the plan parity below, on the
    consolidation cluster the defrag runs on."""
    args = _solve_inputs(warm)
    t32 = [torch.from_numpy(np.array(a)) for a in args]
    t64 = [t.double() if t.dtype == torch.float32 else t for t in t32]
    for iters in (2, 5, 8):
        want = [np.asarray(x) for x in _solve_jit()(*args, iters=iters)]
        got = defrag_solve(*t32, iters)
        ref = defrag_solve_plain(*t64, iters)
        for kind, w, g, r in zip(("logits", "x"), want, got, ref):
            port_err = solve_err(g.numpy(), r.numpy(), kind)
            bound = 10.0 * solve_err(w, r.numpy(), kind) + 1e-5
            assert bound < CHAOS_CAP, (iters, kind, bound)
            assert port_err <= bound, (iters, kind, port_err, bound)
        assert got[1][-5:].abs().max() == 0.0  # inactive rows: no mass


# ------------------------------------------------------------ parity


def _consolidation(seed):
    h = JaxHarness(seed=seed)
    jax_consolidation(h, 32)
    jax_churn(h, random.Random(seed), 0.35)
    return h


def _same_plan(want, got):
    for field in ("movable", "k", "n", "warm", "carried", "candidates",
                  "compressed", "classes"):
        assert getattr(want, field) == getattr(got, field), field
    assert [(m.alloc_id, m.to_node, m.from_node) for m in want.moves] == \
        [(m.alloc_id, m.to_node, m.from_node) for m in got.moves]
    assert abs(want.frag_before - got.frag_before) <= FRAG_TOL
    assert abs(want.frag_after - got.frag_after) <= FRAG_TOL


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("cluster", ["consolidation", "fragmented"])
def test_compute_defrag_plan_matches_cold_then_warm(cluster, compress):
    """Both packages' compute_defrag_plan on one carried-over cluster:
    a cold round, then a warm round that both start from the JAX
    solver's carried logits. The consolidation cluster (the defrag
    rig's, scheduler-placed: its layout and so its moves vary from
    process to process with the node ids) and tests/test_defrag.py's
    hand-placed one (deterministic: it always has moves)."""
    h = _consolidation(8101) if cluster == "consolidation" \
        else fragmented_harness()
    hp = torch_parity.carry_over(h)
    jwarm = JaxWarmState()
    pwarm = WarmState()
    kw = dict(max_moves=8, min_gain=0.0, class_compress=compress)
    want = jax_compute_defrag_plan(h.state.snapshot(), ["dc1"], warm=jwarm,
                                   **kw)
    got = compute_defrag_plan(hp.state.snapshot(), ["dc1"], warm=pwarm, **kw)
    assert not want.warm and want.candidates
    if cluster == "fragmented":
        assert want.moves
    _same_plan(want, got)
    assert pwarm.key == jwarm.key
    assert set(pwarm.logits) == set(jwarm.logits)
    for alloc_id, row in jwarm.logits.items():
        assert_close(row, pwarm.logits[alloc_id], LOGIT_TOL, True)
    # The warm round, both from the JAX solver's carried logits.
    pwarm = carry.warm_state_from_numpy(jwarm.key, jwarm.logits)
    want = jax_compute_defrag_plan(h.state.snapshot(), ["dc1"], warm=jwarm,
                                   **kw)
    got = compute_defrag_plan(hp.state.snapshot(), ["dc1"], warm=pwarm, **kw)
    assert want.warm and want.carried == want.movable
    _same_plan(want, got)
    for alloc_id, row in jwarm.logits.items():
        assert_close(row, pwarm.logits[alloc_id], LOGIT_TOL, True)


# ------------------------------------------------------------ solver units


def test_reference_asks_frequency_weighted():
    asks = np.array([[300, 300, 0, 0]] * 3 + [[600, 600, 0, 0]] * 1,
                    np.float64)
    refs = reference_asks(asks)
    assert len(refs) == 2
    assert refs[0][1] == pytest.approx(0.75)
    assert list(refs[0][0][:2]) == [300, 300]
    assert sum(w for _a, w in refs) == pytest.approx(1.0)
    assert reference_asks(np.zeros((0, 4))) == []


def test_solver_finds_consolidation_gain_and_respects_cap():
    h = port_fragmented()
    snap = h.state.snapshot()
    plan = compute_defrag_plan(snap, ["dc1"], max_moves=3, min_gain=0.001,
                               warm=WarmState())
    assert plan.movable > 0
    assert plan.gain > 0
    assert 0 < len(plan.moves) <= 3
    assert plan.frag_after < plan.frag_before
    assert sum(m.gain for m in plan.moves) == pytest.approx(plan.gain,
                                                           abs=1e-9)
    for mv in plan.moves:
        stored = snap.alloc_by_id(mv.alloc_id)
        assert stored is not None and stored.node_id == mv.from_node
        assert mv.to_node != mv.from_node


def test_solver_min_gain_gate_suppresses_moves():
    h = port_fragmented()
    plan = compute_defrag_plan(h.state.snapshot(), ["dc1"], max_moves=8,
                               min_gain=10.0, warm=WarmState())
    assert plan.moves == []
    assert plan.gain < 10.0


def test_warm_start_carries_and_key_mismatch_drops():
    h = port_fragmented()
    snap = h.state.snapshot()
    warm = WarmState()
    p1 = compute_defrag_plan(snap, ["dc1"], max_moves=8, min_gain=0.0,
                             warm=warm)
    assert not p1.warm and p1.carried == 0
    p2 = compute_defrag_plan(snap, ["dc1"], max_moves=8, min_gain=0.0,
                             warm=warm)
    assert p2.warm and p2.carried == p2.movable
    node = mock.node()
    node.compute_class()
    seed_harness_cluster(h, nodes=[node])
    p3 = compute_defrag_plan(h.state.snapshot(), ["dc1"], max_moves=8,
                             min_gain=0.0, warm=warm)
    assert not p3.warm and p3.carried == 0


def test_cluster_fragmentation_matches_plan_frag_before():
    h = port_fragmented()
    snap = h.state.snapshot()
    measured = cluster_fragmentation(snap, ["dc1"])
    plan = compute_defrag_plan(snap, ["dc1"], max_moves=4, min_gain=0.0,
                               warm=WarmState())
    assert measured == pytest.approx(plan.frag_before, abs=1e-9)


def test_consolidation_fixture_matches_reference():
    """The port's fixtures build the JAX package's workload: the same
    jobs with the same live-alloc counts; the churn sweep stops only
    small-job allocs, each with its probability (alloc ids differ
    between the packages, so which ones is not compared)."""
    hp = Harness(seed=8102)
    seed_consolidation_cluster(hp, 32)
    h = JaxHarness(seed=8102)
    jax_consolidation(h, 32)

    def live(st):
        return sorted((j.id, len([a for a in st.allocs_by_job(j.id)
                                  if not a.terminal_status()]))
                      for j in st.jobs())

    assert live(hp.state) == live(h.state)
    smalls = sum(n for j, n in live(hp.state) if j.startswith("csmall"))
    assert churn_stop_small_allocs(hp, random.Random(1), 0.0) == []
    stops = churn_stop_small_allocs(hp, random.Random(1), 1.0)
    assert len(stops) == smalls
    assert all(a.job_id.startswith("csmall") for a in stops)
    assert all(n == 0 for j, n in live(hp.state) if j.startswith("csmall"))


# ------------------------------------------------- waves through scheduler


def _drive_wave(h, factory="service", max_moves=8):
    snap = h.state.snapshot()
    plan = compute_defrag_plan(snap, ["dc1"], max_moves=max_moves,
                               min_gain=0.001, warm=WarmState())
    evals = build_wave_evals(snap, plan.moves)
    for ev in evals:
        h.process(factory, ev)
    return plan, evals


@pytest.mark.parametrize("factory", ["service", "service-gpu",
                                     "service-convex-gpu"])
def test_wave_moves_allocs_with_exactly_once_evictions(factory):
    h = port_fragmented()
    want_live = {
        j.id: len([a for a in h.state.allocs_by_job(j.id)
                   if not a.terminal_status()])
        for j in h.state.jobs()}
    frag0 = cluster_fragmentation(h.state.snapshot(), ["dc1"])
    plan, evals = _drive_wave(h, factory=factory)
    assert plan.moves and evals
    for mv in plan.moves:
        stored = h.state.alloc_by_id(mv.alloc_id)
        assert stored is not None
        assert stored.desired_status == consts.ALLOC_DESIRED_STOP
        replacements = [
            a for a in h.state.allocs_by_job(mv.job_id)
            if a.previous_allocation == mv.alloc_id
            and not a.terminal_status()]
        assert len(replacements) == 1, mv
    for job_id, want in want_live.items():
        got = len([a for a in h.state.allocs_by_job(job_id)
                   if not a.terminal_status()])
        assert got >= want, (job_id, want, got)
    if factory == "service":
        assert cluster_fragmentation(h.state.snapshot(), ["dc1"]) < frag0


def test_wave_replacements_prefer_solver_targets():
    h = port_fragmented()
    plan, _evals = _drive_wave(h)
    targets = {m.alloc_id: m.to_node for m in plan.moves}
    hits = total = 0
    for a in h.state.allocs():
        if a.previous_allocation in targets and not a.terminal_status():
            total += 1
            hits += a.node_id == targets[a.previous_allocation]
    assert total == len(plan.moves)
    assert hits >= max(1, total // 2), (hits, total)


def test_defrag_eval_is_budget_exempt_but_drains_still_claim():
    h = port_fragmented()
    migrate_configure(migrate_max_parallel=1)
    get_governor().reset_stats()
    plan, _evals = _drive_wave(h, max_moves=4)
    assert len(plan.moves) >= 2
    g = get_governor().stats()
    assert g["granted_total"] == 0 and g["deferred_total"] == 0
    for mv in plan.moves:
        stored = h.state.alloc_by_id(mv.alloc_id)
        assert stored.desired_status == consts.ALLOC_DESIRED_STOP


def test_wave_eval_routes_to_legacy_lane_under_executive():
    from nomad_tpu_torch.scheduler.util import COHORT_FAST_TRIGGERS

    assert consts.EVAL_TRIGGER_DEFRAG not in COHORT_FAST_TRIGGERS


def test_defrag_eval_fields_survive_wire_roundtrip():
    from nomad_tpu_torch.utils.codec import from_dict, to_dict

    ev = Evaluation(
        id="e1", type="service",
        triggered_by=consts.EVAL_TRIGGER_DEFRAG, job_id="j1",
        status=consts.EVAL_STATUS_PENDING,
        defrag_alloc_ids=["a1", "a2"],
        defrag_targets={"a1": "n1", "a2": "n2"})
    back = from_dict(Evaluation, to_dict(ev))
    assert back.defrag_alloc_ids == ["a1", "a2"]
    assert back.defrag_targets == {"a1": "n1", "a2": "n2"}


def test_judge_migration_plan_accepts_real_wave_and_catches_tampering():
    h = port_fragmented()
    snap = h.state.snapshot()
    plan = compute_defrag_plan(snap, ["dc1"], max_moves=4, min_gain=0.001,
                               warm=WarmState())
    assert plan.moves
    wave_plans = []
    for ev in build_wave_evals(snap, plan.moves):
        ev_snap = h.state.snapshot()
        seen = len(h.plans)
        h.process("service", ev)
        for wp in h.plans[seen:]:
            assert judge_migration_plan(ev_snap, wp) == []
            wave_plans.append(wp)
    assert wave_plans
    snap = h.state.snapshot()
    wp = wave_plans[0]
    node_id = next(iter(wp.node_update))
    ghost = wp.node_update[node_id][0].copy()
    ghost.id = "ghost-alloc"
    wp.node_update[node_id].append(ghost)
    bad = judge_migration_plan(snap, wp)
    assert any("ghost-alloc does not exist" in v for v in bad)
    wp.node_update[node_id].pop()
    terminal = next(a for a in snap.allocs() if a.terminal_status())
    wp.node_update.setdefault(terminal.node_id, []).append(terminal.copy())
    bad = judge_migration_plan(snap, wp)
    assert any("already terminal" in v for v in bad)
