"""The port's continuous defrag loop (nomad_tpu_torch/defrag
``DefragLoop``) against the JAX package's, on the CPU.

Mirrors tests/test_defrag.py's loop cases on the port: a round claims
governor slots and releases them as its wave lands (:411), the
pressure gate backs off (:435), leadership loss abandons the wave and
pauses the loop (:452), a wave timeout releases its slots (:469), a
disabled loop does nothing (:485), a round records the ``defrag.solve``
stage (:586), the knobs flow from the config (:598), and the stats
surface (:756, the reference's keys less ``solve_programs``: the port
has no compiled programs to count). The live server case (:628) runs
on the port's Server with the executive on, stepped by
``tick(now=...)`` and waiting on eval statuses, never on the loop
thread's timing.

The reference's chaos cases (:513 ``defrag.solve_stale``, :530
``defrag.wave_lost``, :556 the firing log) are not carried: the port has
no fault injection. The stale-discard path they forced is driven here
without it: a ``compute_defrag_plan`` that moves the base epoch while it
solves must discard the wave and the warm carry.

Cross-package: the same fragmented harness, stepped by the same tick
sequence in both packages' loops, must give the same moves, governor
counters, wave evals (job ids, marked alloc ids, targets) and loop
counters. Tolerance: the gain and fragmentation within FRAG_TOL
(float64 host arithmetic on the same utilization); every other
comparison is exact."""

from __future__ import annotations

import time
import types

import pytest

import torch_parity
from test_defrag import _StubServer as JaxStubServer
from test_defrag import _mkjob as jax_mkjob
from test_defrag import fragmented_harness

from nomad_tpu.defrag import DefragLoop as JaxDefragLoop
from nomad_tpu.migrate import configure as jax_migrate_configure
from nomad_tpu.migrate import get_governor as jax_get_governor
from nomad_tpu_torch.defrag import (
    WAVE_TIMEOUT,
    DefragLoop,
    cluster_fragmentation,
)
from nomad_tpu_torch.migrate import configure as migrate_configure
from nomad_tpu_torch.migrate import get_governor
from nomad_tpu_torch.server.config import ServerConfig
from nomad_tpu_torch.structs import consts

FRAG_TOL = 1e-6


@pytest.fixture(autouse=True)
def _governor_hygiene():
    """Both packages' migration governors are process-global, and the
    gate cases leave waves in flight: return leaked slots and
    re-baseline around every test."""
    for configure, governor in ((migrate_configure, get_governor),
                                (jax_migrate_configure, jax_get_governor)):
        configure(migrate_max_parallel=32)
        governor().reset_stats()
    yield
    for configure, governor in ((migrate_configure, get_governor),
                                (jax_migrate_configure, jax_get_governor)):
        g = governor()
        leaked = g.stats()["in_flight"]
        if leaked:
            g.release(leaked)
        configure(migrate_max_parallel=32)
        g.reset_stats()


class _StubServer:
    """tests/test_defrag.py's stub: the slice of Server the loop touches,
    fully deterministic, over a port Harness."""

    def __init__(self, harness, **cfg):
        defaults = dict(defrag_enabled=True, defrag_interval=0.01,
                        defrag_min_gain=0.001,
                        defrag_max_moves_per_wave=8)
        defaults.update(cfg)
        self.config = ServerConfig(**defaults)
        self.harness = harness
        self.fsm = types.SimpleNamespace(state=harness.state)
        self.leader = True
        self.level = "green"
        self.admission = types.SimpleNamespace(level=lambda: self.level)
        self.submitted = []

    def is_leader(self):
        return self.leader

    def eval_update(self, evals):
        self.submitted.extend(evals)
        # park them pending in the store so the wave watch sees them
        self.harness.state.upsert_evals(
            self.harness.next_index(), [e.copy() for e in evals])


def _terminalize(stub, evals):
    done = []
    for ev in evals:
        upd = ev.copy()
        upd.status = consts.EVAL_STATUS_COMPLETE
        done.append(upd)
    stub.harness.state.upsert_evals(stub.harness.next_index(), done)


def port_stub(**cfg):
    return _StubServer(torch_parity.carry_over(fragmented_harness()), **cfg)


# ---------------------------------------------- tests/test_defrag.py


def test_loop_round_claims_and_releases_governor_slots():
    stub = port_stub(defrag_interval=10_000.0)
    loop = DefragLoop(stub)
    base = get_governor().stats()["in_flight"]
    loop.tick(now=1000.0)
    st = loop.stats()
    assert st["rounds"] == 1 and st["waves"] == 1
    assert stub.submitted
    held = get_governor().stats()["in_flight"] - base
    assert held == st["wave_in_flight"] > 0
    # wave still pending: a second tick keeps holding (one wave at a
    # time, no new round)
    loop.tick(now=1001.0)
    assert loop.stats()["rounds"] == 1
    _terminalize(stub, stub.submitted)
    loop.tick(now=1002.0)
    st = loop.stats()
    assert st["wave_in_flight"] == 0
    assert st["moves_completed"] == held
    assert get_governor().stats()["in_flight"] == base


def test_loop_pressure_gate_backs_off():
    stub = port_stub(defrag_interval=100.0)
    stub.level = "red"
    loop = DefragLoop(stub)
    loop.tick(now=1000.0)
    st = loop.stats()
    assert st["rounds"] == 0 and st["pressure_skips"] == 1
    # red compounds the backoff: the next eligible round is pushed
    # past interval * 2
    loop.tick(now=1000.0 + stub.config.defrag_interval * 1.5)
    assert loop.stats()["rounds"] == 0
    stub.level = "green"
    loop.tick(now=2000.0)
    assert loop.stats()["rounds"] == 1


def test_loop_leadership_loss_abandons_wave_and_pauses():
    stub = port_stub(defrag_interval=10_000.0)
    loop = DefragLoop(stub)
    base = get_governor().stats()["in_flight"]
    loop.tick(now=1000.0)
    assert loop.stats()["wave_in_flight"] > 0
    stub.leader = False
    loop.tick(now=1001.0)
    st = loop.stats()
    assert st["wave_in_flight"] == 0 and st["waves_lost"] == 1
    assert get_governor().stats()["in_flight"] == base
    # paused: no rounds while not leader
    loop.tick(now=5000.0)
    assert loop.stats()["rounds"] == 1


def test_loop_wave_timeout_releases_slots():
    stub = port_stub(defrag_interval=10_000.0)
    loop = DefragLoop(stub)
    base = get_governor().stats()["in_flight"]
    loop.tick(now=1000.0)
    assert loop.stats()["wave_in_flight"] > 0
    with loop._lock:
        loop._wave_started = time.monotonic() - WAVE_TIMEOUT - 1
    loop.tick(now=1001.0)
    assert loop.stats()["waves_lost"] == 1
    assert get_governor().stats()["in_flight"] == base


def test_loop_disabled_does_nothing():
    stub = port_stub(defrag_enabled=False)
    loop = DefragLoop(stub)
    loop.tick(now=1000.0)
    assert loop.stats()["rounds"] == 0 and not stub.submitted


def test_stale_base_discards_wave_and_warm_carry(monkeypatch):
    """A resident-base purge during the solve (the base epoch moved)
    discards the round's wave and the warm carry; the next round
    proposes normally."""
    import nomad_tpu_torch.defrag as defrag_mod
    from nomad_tpu_torch.models import matrix as matrix_mod

    real = defrag_mod.compute_defrag_plan
    purges = {"left": 1}

    def solve_then_purge(*args, **kwargs):
        plan = real(*args, **kwargs)
        if purges["left"]:
            purges["left"] -= 1
            with matrix_mod._BASE_CACHE_LOCK:
                matrix_mod._BASE_EPOCH += 1
        return plan

    monkeypatch.setattr(defrag_mod, "compute_defrag_plan", solve_then_purge)
    stub = port_stub(defrag_interval=100.0)
    loop = DefragLoop(stub)
    loop.tick(now=1000.0)
    st = loop.stats()
    assert st["stale_discards"] == 1
    assert st["waves"] == 0 and not stub.submitted
    assert loop._warm.key is None  # carry dropped with the chain
    assert get_governor().stats()["in_flight"] == 0
    loop.tick(now=2000.0)
    st = loop.stats()
    assert st["waves"] == 1 and st["stale_discards"] == 1


def test_loop_round_records_trace_stage():
    from nomad_tpu_torch import trace

    trace.get_recorder().reset()
    loop = DefragLoop(port_stub())
    loop.run_round()
    stages = trace.get_recorder().stage_stats()
    assert stages.get("defrag.solve", {}).get("count", 0) >= 1


def test_defrag_knobs_flow_from_config():
    stub = port_stub(defrag_enabled=True, defrag_interval=7.5,
                     defrag_min_gain=0.25, defrag_max_moves_per_wave=3)
    loop = DefragLoop(stub)
    st = loop.stats()
    assert st["enabled"] and st["interval"] == 7.5
    assert st["min_gain"] == 0.25 and st["max_moves_per_wave"] == 3
    loop.configure(enabled=False, max_moves=5)
    st = loop.stats()
    assert not st["enabled"] and st["max_moves_per_wave"] == 5


def test_server_stats_exposes_defrag_surface():
    """The port's stats carry the reference's keys less
    ``solve_programs``."""
    got = DefragLoop(port_stub()).stats()
    want = JaxDefragLoop(JaxStubServer(fragmented_harness())).stats()
    assert set(want) - set(got) == {"solve_programs"}
    assert set(got) <= set(want)


# ------------------------------------------------- live server e2e


def _wait_terminal(server, pred, timeout=120.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        evs = [e for e in server.fsm.state.evals() if pred(e)]
        if all(e.terminal_status() for e in evs):
            return evs
        time.sleep(0.02)
    raise AssertionError("evals not terminal")


def test_live_server_defrag_loop_end_to_end():
    """A dev server with the executive and the loop on converges a
    churned cluster: waves committed under the governor cap through the
    executive's legacy lane, slots fully released, fragmentation never
    up, every displaced alloc stopped once with one replacement, the
    trace stage and stats populated, the first solve cold and later
    ones warm. The loop's thread is stopped and the test steps it with
    an injected clock (the thread's own ticks would race it), waiting
    on eval statuses between rounds. Solve times are not compared
    here: on a CPU shared with other test processes they measure the
    machine; chip_smoke.py prints them on the card."""
    from nomad_tpu_torch import mock, trace
    from nomad_tpu_torch.server import Server

    migrate_configure(migrate_max_parallel=32)
    server = Server(ServerConfig(
        num_schedulers=2, scheduler_factories={"service": "service-gpu"},
        scheduler_executive=True, eval_nack_timeout=30.0,
        defrag_enabled=True, defrag_interval=10_000.0,
        defrag_min_gain=0.001, defrag_max_moves_per_wave=8))
    server.start()
    server.defrag.stop()
    try:
        for _ in range(24):
            node = mock.node()
            node.resources.cpu = 1000
            node.resources.memory_mb = 1000
            node.reserved = None
            node.compute_class()
            server.log.apply("node_register", {"node": node})
        jobs = ([torch_parity_job(f"big{j}", 4, 600) for j in range(3)]
                + [torch_parity_job(f"small{j}", 6, 300) for j in range(4)])
        for job in jobs:
            server.job_register(job)
        _wait_terminal(server, lambda e: True)
        server.job_deregister("small0")  # churn: leave holes
        _wait_terminal(server, lambda e: True)
        frag = [cluster_fragmentation(server.fsm.state.snapshot(), ["dc1"])]
        trace.get_recorder().reset()
        routed0 = server.executive.stats()["routed_host"]
        loop = server.defrag
        for k in range(4):
            loop.tick(now=1000.0 + 20_000.0 * k)
            _wait_terminal(
                server,
                lambda e: e.triggered_by == consts.EVAL_TRIGGER_DEFRAG)
            frag.append(cluster_fragmentation(
                server.fsm.state.snapshot(), ["dc1"]))
        loop.configure(enabled=False)
        loop.tick(now=1e6)  # settle: release the last wave's slots
        st = server.stats()["defrag"]
        assert st["waves"] >= 1, st
        assert st["moves_completed"] == st["moves_proposed"], st
        assert st["wave_in_flight"] == 0 and st["waves_lost"] == 0, st
        assert st["stale_discards"] == 0, st
        assert st["cold_solves"] == 1 and st["warm_solves"] >= 1, st
        g = get_governor().stats()
        assert g["in_flight"] == 0, g
        assert g["high_water"] <= server.config.migrate_max_parallel
        assert all(b <= a + FRAG_TOL for a, b in zip(frag, frag[1:])), frag
        # displaced allocs: one stop each, one replacement each
        state = server.fsm.state
        moved = [a for a in state.allocs()
                 if a.desired_description == "alloc is being migrated"]
        assert moved
        for a in moved:
            assert a.desired_status == consts.ALLOC_DESIRED_STOP
            assert len([r for r in state.allocs()
                        if r.previous_allocation == a.id]) == 1
        assert len(moved) == st["moves_proposed"]
        # Every wave eval went through the executive: the legacy lane
        # (defrag is not a fast trigger), or the host route when its
        # cohort was smaller than dense_min_batch.
        ex = server.stats()["scheduler_executive"]
        waves = [e for e in state.evals()
                 if e.triggered_by == consts.EVAL_TRIGGER_DEFRAG]
        assert ex["legacy_reasons"].get("trigger 'defrag-migration'", 0) \
            + ex["routed_host"] - routed0 == len(waves), ex
        assert server.stats()["trace"].get("defrag.solve", {}).get(
            "count", 0) == st["rounds"]
    finally:
        server.shutdown()


def torch_parity_job(jid, count, size):
    """tests/test_defrag.py's _mkjob (cpu and memory ``size``, no
    networks) on the port's structs."""
    from test_torch_server_e2e_parity import port

    return port(jax_mkjob(jid, count, size, size))


# ---------------------------------------------------- cross-package


def _tick_sequence(loop, stub, terminalize):
    """Two rounds with their waves landed, then a settle tick; returns
    each round's wave as [(job id, alloc ids, targets)] and the loop's
    float figures after each round."""
    waves, floats = [], []
    for now in (1000.0, 2000.0):
        seen = len(stub.submitted)
        loop.tick(now=now)
        wave = stub.submitted[seen:]
        waves.append([(ev.job_id, list(ev.defrag_alloc_ids),
                       dict(ev.defrag_targets)) for ev in wave])
        floats.append((loop.last_gain, loop.last_frag))
        terminalize(stub, wave)
        loop.tick(now=now + 1.0)
    loop.configure(enabled=False)
    loop.tick(now=9000.0)
    return waves, floats


def test_tick_sequence_matches_the_reference_loop():
    from test_defrag import _terminalize as jax_terminalize

    jax_h = fragmented_harness()
    stub = _StubServer(torch_parity.carry_over(jax_h), defrag_interval=100.0)
    ref_stub = JaxStubServer(jax_h, defrag_interval=100.0)
    loop, ref_loop = DefragLoop(stub), JaxDefragLoop(ref_stub)
    want_waves, want_floats = _tick_sequence(ref_loop, ref_stub,
                                             jax_terminalize)
    got_waves, got_floats = _tick_sequence(loop, stub, _terminalize)
    assert want_waves[0] and want_waves[1]
    assert got_waves == want_waves
    for (g_gain, g_frag), (w_gain, w_frag) in zip(got_floats, want_floats):
        assert abs(g_gain - w_gain) <= FRAG_TOL
        assert abs(g_frag - w_frag) <= FRAG_TOL
    assert get_governor().stats() == jax_get_governor().stats()
    timing = {k for k in ref_loop.stats() if k.endswith("_ms")}
    floats = {"last_gain", "last_fragmentation", "solve_programs"}
    want = {k: v for k, v in ref_loop.stats().items()
            if k not in timing | floats}
    got = {k: v for k, v in loop.stats().items()
           if k not in timing | floats}
    assert got == want
    assert got["cold_solves"] == 1 and got["warm_solves"] == 1
