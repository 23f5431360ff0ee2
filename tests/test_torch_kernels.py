"""The port's placement-kernel subsystem (nomad_tpu_torch/kernels): the
registry and its ``service-<k>-gpu`` factories, the quality board
against the JAX package's kernels/quality.py, and the oracle
differential rig (green for convex, greedy, gangs and defrag waves; red
for a kernel that cheats). The port runs its plain PyTorch versions on
the CPU (tests/torch_parity.py)."""

from __future__ import annotations

import logging

import numpy as np
import pytest
import torch

import torch_parity
from nomad_tpu.kernels import quality as jq
from nomad_tpu_torch import carry
from nomad_tpu_torch import scheduler as sched_mod
from nomad_tpu_torch.kernels import (
    _LOADERS,
    _LOCK,
    _PROGRAMS,
    active_kernel,
    configure,
    kernel_names,
    kernel_program,
    register_kernel,
)
from nomad_tpu_torch.kernels import quality as tq
from nomad_tpu_torch.kernels.differential import (
    DEFAULT_SEEDS,
    run_defrag_differential,
    run_differential,
    run_gang_differential,
)
from nomad_tpu_torch.scheduler.testing import Harness
from nomad_tpu_torch.structs import consts, new_eval


@pytest.fixture(autouse=True)
def _restore_kernel():
    before = active_kernel()
    yield
    configure(before)


def _unregister(name):
    """Drop a test kernel and its lazily registered factories."""
    import nomad_tpu_torch.kernels as kmod

    with _LOCK:
        _LOADERS.pop(name, None)
        _PROGRAMS.pop(name, None)
        kmod._NAMES = tuple(sorted(_LOADERS))
    for fname in [f for f in sched_mod.scheduler_names()
                  if f"-{name}-" in f]:
        sched_mod._BUILTIN.pop(fname)


# --------------------------------------------------------------- registry


def test_registry_builtins_and_unknown():
    assert {"greedy", "convex"} <= set(kernel_names())
    with pytest.raises(ValueError, match="unknown placement kernel"):
        configure("cvx")
    configure("convex")
    assert active_kernel() == "convex"
    assert callable(kernel_program("convex"))
    with pytest.raises(ValueError, match="unknown placement kernel"):
        kernel_program("nope")


def test_registry_rejects_dashed_names():
    with pytest.raises(ValueError, match="no dashes"):
        register_kernel("my-kernel", lambda: None)


def test_registry_rejects_replacing_greedy():
    with pytest.raises(ValueError, match="cannot be replaced"):
        register_kernel("greedy", lambda: None)


def test_greedy_resolves_through_registry():
    from nomad_tpu_torch.ops.binpack import greedy_placement_program

    assert kernel_program("greedy") is greedy_placement_program


def test_pinned_factories_for_every_kernel():
    names = sched_mod.scheduler_names()
    for kernel in kernel_names():
        assert f"service-{kernel}-gpu" in names
        assert f"batch-{kernel}-gpu" in names
    h = Harness()
    s = sched_mod.new_scheduler("batch-convex-gpu", logging.getLogger("t"),
                                h.snapshot(), h)
    assert s.kernel == "convex" and s.batch
    s = sched_mod.new_scheduler("service-gpu", logging.getLogger("t"),
                                h.snapshot(), h)
    assert s.kernel is None


def test_third_party_kernel_registers_and_routes():
    """A plugin kernel becomes selectable through configure() and the
    factory registry; its loader resolves lazily on first dispatch."""
    from nomad_tpu_torch.kernels.convex import convex_placement_program

    loads = []

    def loader():
        loads.append(1)
        return convex_placement_program

    register_kernel("thirdparty", loader)
    try:
        assert "thirdparty" in kernel_names()
        assert not loads  # lazy: registration must not load
        configure("thirdparty")
        assert kernel_program("thirdparty") is convex_placement_program
        assert loads == [1]
        kernel_program("thirdparty")
        assert loads == [1]  # memoized
        h = Harness()
        s = sched_mod.new_scheduler(
            "service-thirdparty-gpu", logging.getLogger("t"),
            h.snapshot(), h)
        assert s.kernel == "thirdparty"
    finally:
        _unregister("thirdparty")


def test_uniform_dh_is_greedy_only():
    """Config 4's shape (one task group under distinct_hosts) takes K2
    under greedy; the convex kernel never does."""
    from nomad_tpu_torch.scheduler.tpu import build_placement_config

    placements = [0] * 8
    arrays = (None,) * 5 + (False, np.array([True]))
    assert build_placement_config(False, False, "greedy", placements,
                                  arrays).uniform_dh
    cfg = build_placement_config(False, False, "convex", placements, arrays)
    assert not cfg.uniform_dh and cfg.kernel == "convex"
    configure("convex")
    assert build_placement_config(False, True, None, placements,
                                  arrays).kernel == "convex"


# ---------------------------------------------------------------- quality


def test_quality_from_arrays_matches_reference():
    rng = np.random.default_rng(5)
    n = 64
    capacity = rng.integers(0, 4, (n, 4)).astype(np.float64) * 500
    util = capacity * rng.random((n, 4))
    node_ok = rng.random(n) < 0.9
    for ask in (np.array([300, 400, 0, 0.0]), np.array([900, 100, 10, 0])):
        assert tq.quality_from_arrays(util, capacity, node_ok, ask) == \
            jq.quality_from_arrays(util, capacity, node_ok, ask)
    topo = rng.integers(-1, 6, n)
    for k in (1, 3, 9):
        assert tq.slice_fragmentation(util, capacity, node_ok, topo,
                                      [300, 300, 0, 0], k) == \
            jq.slice_fragmentation(util, capacity, node_ok, topo,
                                   [300, 300, 0, 0], k)


def test_quality_from_arrays_known_cases():
    capacity = np.array([[100, 100, 0, 0]] * 4, float)
    node_ok = np.array([True, True, True, False])
    ask = np.array([40, 40, 0, 0], float)
    util = np.array([[100, 100, 0, 0], [80, 80, 0, 0],
                     [0, 0, 0, 0], [0, 0, 0, 0]], float)
    q = tq.quality_from_arrays(util, capacity, node_ok, ask)
    assert q["fragmentation"] == pytest.approx(0.4 / 2.4)
    assert q["binpack_score"] == pytest.approx(0.9)
    empty = tq.quality_from_arrays(
        np.zeros((2, 4)), np.zeros((2, 4)), np.zeros(2, bool), ask)
    assert empty == {"fragmentation": 0.0, "binpack_score": 0.0}


def test_quality_from_store_matches_on_a_carried_cluster():
    h = torch_parity.build_reference_cluster(24, seed=7)
    hp = torch_parity.carry_over(h)
    job = torch_parity.two_group_job()
    pjob = hp.state.job_by_id("filler")
    assert tq.quality_from_store(hp.state.snapshot(), pjob) == \
        jq.quality_from_store(h.state.snapshot(), h.state.job_by_id("filler"))
    assert np.array_equal(tq.reference_ask(pjob),
                          jq.reference_ask(h.state.job_by_id("filler")))
    assert jq.reference_ask(job)[0] > 0


def test_quality_board_rings_and_snapshot():
    from nomad_tpu_torch.trace import get_recorder

    get_recorder().reset()
    board = tq.QualityBoard()
    for _ in range(600):  # wraps the 512-cap ring
        board.note_plan("greedy", 0.25, 0.5)
    board.note_plan("convex", 0.1, 0.8)
    snap = board.snapshot()
    assert snap["kernels"]["greedy"]["samples"] == 600
    assert snap["kernels"]["greedy"]["fragmentation"] == 0.25
    assert snap["kernels"]["convex"]["binpack_score"] == 0.8
    # No broker.wait span until the broker is ported: the recorder's 0.0.
    assert snap["queueing_delay_ms"] == 0.0
    board.reset_window()
    assert board.window_snapshot()["kernels"] == {}
    board.note_plan("convex", 0.3, 0.6)
    win = board.window_snapshot(reset=True)["kernels"]
    assert win == {"convex": {"fragmentation": 0.3, "binpack_score": 0.6,
                              "samples": 1}}
    assert board.window_snapshot()["kernels"] == {}
    board.reset()
    assert board.snapshot()["kernels"] == {}


def test_quality_board_sampling_rule():
    board = tq.QualityBoard()
    picks = [board.should_sample("k") for _ in range(tq.WARM_SAMPLES + 64)]
    assert all(picks[:tq.WARM_SAMPLES])
    tail = picks[tq.WARM_SAMPLES:]
    assert sum(tail) == 64 // tq.SAMPLE_EVERY
    assert board.should_sample("other")  # per kernel


def test_dense_plans_feed_the_board_per_kernel():
    """service-<k>-gpu scores each committed dense plan under its
    kernel's name, from the plan's own claims."""
    board = tq.get_board()
    board.reset()
    for kernel in ("greedy", "convex"):
        h = torch_parity.build_reference_cluster(16, seed=8)
        h.state.upsert_job(h.next_index(), torch_parity.two_group_job((6, 4)))
        hp = torch_parity.carry_over(h)
        hp.process(f"service-{kernel}-gpu", new_eval(
            hp.state.job_by_id("two"), consts.EVAL_TRIGGER_JOB_REGISTER))
        assert hp.evals[-1].status == consts.EVAL_STATUS_COMPLETE
    kernels = board.snapshot()["kernels"]
    assert kernels["greedy"]["samples"] == kernels["convex"]["samples"] == 1
    for q in kernels.values():
        assert 0.0 < q["binpack_score"] <= 1.0
    board.reset()


# ------------------------------------------------- differential property


@pytest.mark.parametrize("seed", list(DEFAULT_SEEDS)[:8])
def test_convex_kernel_oracle_differential(seed):
    report = run_differential("convex", seeds=[seed])
    assert report["green"], "\n".join(report["violations"])


def test_greedy_kernel_oracle_differential_sample():
    report = run_differential("greedy", seeds=list(DEFAULT_SEEDS)[:3],
                              with_oracle_counts=True)
    assert report["green"], "\n".join(report["violations"])
    assert all(k == o for k, o in report["placed"].values())


def test_gang_differential_rig_green():
    report = run_gang_differential()
    assert report["green"], report["violations"]
    assert report["placed_gangs"] > 0


def test_defrag_differential_rig_green():
    report = run_defrag_differential()
    assert report["waves"] > 0
    assert report["green"], report["violations"]


def test_batcher_gives_a_registered_kernel_only_its_live_rows():
    """The batcher pads the native greedy scan's batch axis up its
    ladder (B = 4 for one eval) but hands a registered kernel the live
    evals alone: the convex relaxation's work grows with every row. The
    lone eval's result is the one the kernel gives it directly."""
    from nomad_tpu_torch.kernels.convex import convex_placement_program
    from nomad_tpu_torch.ops import binpack as tb
    from nomad_tpu_torch.scheduler.batcher import PlacementBatcher
    from test_torch_batcher import build_asks, build_state

    rows = []

    def counting(*args, **kw):
        rows.append(args[9].shape[0])  # feasible [B, N, G]
        return convex_placement_program(*args, **kw)

    register_kernel("rowcount", lambda: counting)
    try:
        config = tb.PlacementConfig(10.0, kernel="rowcount")
        state, asks = build_state(token=91), build_asks()
        key = np.array([0, 5], np.uint32)
        got = PlacementBatcher("cpu", window=0.001).place(state, asks, key,
                                                          config)
        assert rows == [1]
        direct = tb.placement_program(
            carry.node_state_from_numpy(
                [getattr(state, f) for f in tb.NodeState._fields], "cpu"),
            carry.asks_from_numpy(asks, "cpu"), key, config)
        np.testing.assert_array_equal(got[0], direct[0].numpy())
        np.testing.assert_allclose(got[1], direct[1].numpy(), atol=1e-4)
    finally:
        _unregister("rowcount")


def test_differential_rig_catches_a_lying_kernel():
    """The rig must be able to FAIL: a kernel that places every ask on
    node row 0, whatever the mask says, turns it red."""
    from nomad_tpu_torch.ops.binpack import fresh_carry

    def cheating_program(capacity, sched_capacity, util, bw_avail, bw_used,
                         ports_free, node_ok, job_count, tg_count, feasible,
                         asks, keys, config, seq=False):
        b, k = asks.active.shape
        carry = fresh_carry(util, bw_used, ports_free, job_count, tg_count,
                            b, seq)
        return (torch.zeros((b, k), dtype=torch.int32),
                torch.zeros((b, k)), carry)

    register_kernel("cheat", lambda: cheating_program)
    try:
        report = run_differential("cheat", seeds=list(DEFAULT_SEEDS)[:4])
        assert not report["green"]
        assert report["violations"]
    finally:
        _unregister("cheat")


def test_rig_cases_reach_the_dense_kernel():
    """Every rig case places more than 3 asks, so the dense path (not
    the host iterators) runs the kernel under test."""
    from nomad_tpu_torch.kernels import convex

    calls = []
    real = convex.relaxed_pref

    def spy(*args):
        calls.append(args[6].active.shape)
        return real(*args)

    convex.relaxed_pref = spy
    try:
        report = run_differential("convex", seeds=list(DEFAULT_SEEDS)[:4])
    finally:
        convex.relaxed_pref = real
    assert report["green"]
    assert len(calls) >= 4
