"""The port's scheduler executive (nomad_tpu_torch/server/executive.py)
against the JAX package's, on the CPU.

The ten cases of tests/test_executive.py on the port's Server: the
dry-broker early cut, a storm as a few cohorts with every alloc placed
exactly once, executive-vs-worker placement parity, job updates on the
legacy lane, blocked evals that unblock, deadline expiry, leadership
loss draining leases, saturation backpressure and the stats surface.
The reference's device-fault case (a host fallback under the breaker)
becomes "nacks and redelivers, never host": the port has no breaker
and no host fallback. tests/test_gang.py's executive gang case is
carried too.

Cross-package cases: the JAX Server and the port's Server, both with
the executive on, over tests/test_executive.py's forced-placement
cluster must commit identical (job, slot) -> node maps; one eval at a
time through the executive's fast path (``dense_min_batch=1``), both
executives' per-eval PRNG seeded from the same counter (the module's
``os`` replaced, as the serial Server parity does for the workers),
must commit identical nodes and ports; and a storm eval's trace holds
the same executive stages in both packages. Every comparison is exact:
no tolerance."""

from __future__ import annotations

import threading
import time

import pytest

import torch_parity  # noqa: F401  (the port on the CPU)
from test_torch_server_e2e_parity import (
    _CounterOS,
    cluster,
    jobs_for,
    placements,
    port,
    wait_terminal,
)
from nomad_tpu_torch import mock
from nomad_tpu_torch.server import Server, ServerConfig
from nomad_tpu_torch.server.worker import DEQUEUE_TIMEOUT
from nomad_tpu_torch.structs import consts


def wait_until(fn, timeout=90.0, interval=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if fn():
            return True
        time.sleep(interval)
    return False


def make_server(**over):
    defaults = dict(
        num_schedulers=2,
        scheduler_factories={"service": "service-gpu"},
        eval_batch_size=16,
        scheduler_executive=True,
        executive_threads=4,
        eval_nack_timeout=5.0,
        eval_delivery_limit=8,
    )
    defaults.update(over)
    server = Server(ServerConfig(**defaults))
    server.start()
    return server


def seed_nodes(server, n=30, cpu=None, mem=None):
    nodes = []
    for i in range(n):
        node = mock.node()
        if cpu is not None:
            node.resources.cpu = cpu + i * 10
        if mem is not None:
            node.resources.memory_mb = mem
        node.compute_class()
        server.node_register(node)
        nodes.append(node)
    return nodes


def quiesce(server):
    for w in server.workers:
        w.set_pause(True)
    server.executive.set_pause(True)
    assert wait_until(
        lambda: all(w.parked() for w in server.workers)
        and server.executive.parked(),
        timeout=4 * DEQUEUE_TIMEOUT + 30.0)


def release(server):
    for w in server.workers:
        w.set_pause(False)
    server.executive.set_pause(False)


def make_job(jid, count=5, cpu=20, mem=16):
    job = mock.job()
    job.id = jid
    job.task_groups[0].count = count
    t = job.task_groups[0].tasks[0]
    t.resources.cpu = cpu
    t.resources.memory_mb = mem
    t.resources.networks = []
    return job


def run_storm(server, n_jobs, prefix, count=5):
    quiesce(server)
    jobs, evals = [], []
    for i in range(n_jobs):
        job = make_job(f"{prefix}-{i}", count=count)
        ev, _ = server.job_register(job)
        jobs.append(job)
        evals.append(ev)
    assert wait_until(lambda: server.broker.ready_count() >= n_jobs, 15.0)
    release(server)
    return jobs, evals


def settle(server, evals, timeout=120.0):
    state = server.fsm.state

    def done():
        evs = [state.eval_by_id(e) for e in evals]
        return all(e is not None and e.terminal_status() for e in evs)

    assert wait_until(done, timeout), {
        e: getattr(state.eval_by_id(e), "status", None) for e in evals}


def live(server, job_id):
    return [a for a in server.fsm.state.allocs_by_job(job_id)
            if not a.terminal_status()]


# ------------------------------------------ tests/test_executive.py


def test_drain_cuts_early_when_broker_dry():
    """With a cohort in hand and the broker dry for dispatch_idle_grace,
    the drain cuts early instead of holding the whole (huge) window."""
    server = Server(ServerConfig(
        num_schedulers=2,
        scheduler_factories={"service": "service-gpu"},
        eval_batch_size=16, scheduler_executive=True,
        dispatch_window=30.0, dispatch_idle_grace=0.02))
    try:
        server.establish_leadership()
        seed_nodes(server, 4)
        for i in range(3):
            server.job_register(make_job(f"dry-{i}", count=2))
        assert server.broker.ready_count() == 3
        ev, token = server.broker.dequeue(["service"], timeout=1.0)
        assert ev is not None
        server.executive.submit(ev, token)
        t0 = time.monotonic()
        batch = server.executive._drain(window=30.0)
        elapsed = time.monotonic() - t0
        assert len(batch) == 3
        assert elapsed < 5.0, f"drain held a dry broker {elapsed:.1f}s"
        for entry in batch:
            server.eval_nack(entry.eval.id, entry.token)
    finally:
        server.shutdown()


def test_executive_storm_forms_cohorts_and_places_exactly_once():
    from nomad_tpu_torch.scheduler.batcher import get_batcher

    server = make_server()
    try:
        seed_nodes(server)
        before = get_batcher().stats()["cohort_dispatches"]
        jobs, evals = run_storm(server, 12, "storm")
        settle(server, evals)
        for job in jobs:
            allocs = live(server, job.id)
            assert len(allocs) == 5, (job.id, len(allocs))
            assert len({a.name for a in allocs}) == 5  # exactly once
        ex = server.executive.stats()
        assert ex["enabled"]
        assert ex["fast_evals"] >= 10, ex
        assert 1 <= ex["cohorts"] <= 4, ex
        assert ex["occupancy"] >= 3, ex
        # The device work went through the no-park cohort dispatch.
        assert get_batcher().stats()["cohort_dispatches"] > before
        # The superseded pipeline never engaged.
        assert not server.dispatch.enabled
        assert server.stats()["dispatch_pipeline"]["batches"] == 0
    finally:
        server.shutdown()


def _forced_cluster(n_jobs, count):
    """tests/test_executive.py's forced-placement cluster: node i in rack
    r{i % n_jobs}, each job pinned to its rack under distinct_hosts, so
    the committed node set of a job is unique."""
    from nomad_tpu import mock as jax_mock

    nodes = []
    for i in range(n_jobs * count):
        node = jax_mock.node()
        node.id = f"forced-{i:03d}"
        node.meta["rack"] = f"r{i % n_jobs}"
        node.compute_class()
        nodes.append(node)
    return nodes


def _forced_jobs(n_jobs, count):
    from nomad_tpu import mock as jax_mock
    from nomad_tpu.structs import Constraint as JaxConstraint

    jobs = []
    for j in range(n_jobs):
        job = jax_mock.job()
        job.id = f"par-{j}"
        tg = job.task_groups[0]
        tg.count = count
        t = tg.tasks[0]
        t.resources.cpu, t.resources.memory_mb = 20, 16
        t.resources.networks = []
        job.constraints.append(JaxConstraint(
            ltarget="${meta.rack}", operand="=", rtarget=f"r{j}"))
        tg.constraints.append(
            JaxConstraint(operand=consts.CONSTRAINT_DISTINCT_HOSTS))
        jobs.append(job)
    return jobs


def _run_forced(server, nodes, jobs, convert, by_hand=False):
    """Register ``nodes`` and a storm of ``jobs``; returns the committed
    {(job, slot): node rank}. ``by_hand``: the workers stay parked and
    the test seeds the executive with every eval in broker order, so
    the cohort's row order is fixed."""
    for node in nodes:
        server.node_register(convert(node))
    quiesce(server)
    evals = [server.job_register(convert(job))[0] for job in jobs]
    assert wait_until(
        lambda: server.broker.ready_count() >= len(jobs), 15.0)
    if by_hand:
        for _ in jobs:
            ev, token = server.broker.dequeue(["service"], timeout=5.0)
            server.executive.submit(ev, token)
        server.executive.set_pause(False)
    else:
        release(server)
    settle(server, evals)
    rank = {n.id: i for i, n in enumerate(nodes)}
    out = {}
    for job in jobs:
        for a in server.fsm.state.allocs_by_job(job.id):
            if not a.terminal_status():
                out[(a.job_id, a.name)] = rank[a.node_id]
    return out


def test_executive_vs_worker_placement_parity():
    """The port's executive and its workers (the dispatch pipeline)
    commit the same node set per job on the forced-placement cluster
    (slot-name pairing within a job is tie-broken by independent per-eval
    streams, as in the reference's case)."""
    n_jobs, count = 4, 3
    nodes, jobs = _forced_cluster(n_jobs, count), _forced_jobs(n_jobs, count)

    def run(executive):
        server = make_server(scheduler_executive=executive)
        try:
            committed = _run_forced(server, nodes, jobs, port)
            assert len(committed) == n_jobs * count, committed
            by_job = {}
            for (job_id, _name), r in committed.items():
                by_job.setdefault(job_id, set()).add(r)
            return {j: frozenset(v) for j, v in by_job.items()}
        finally:
            server.shutdown()

    assert run(True) == run(False)


def test_job_update_routes_legacy_and_commits():
    server = make_server()
    try:
        seed_nodes(server)
        jobs, evals = run_storm(server, 4, "upd", count=3)
        settle(server, evals)
        base_legacy = server.executive.stats()["legacy_evals"]
        # Destructive update: bump resources -> diff has update bucket.
        quiesce(server)
        ev2 = []
        for job in jobs:
            ev, _ = server.job_register(make_job(job.id, count=3, cpu=30))
            ev2.append(ev)
        release(server)
        settle(server, ev2)
        ex = server.executive.stats()
        assert ex["legacy_evals"] > base_legacy, ex
        assert any("stop/update" in r or "buckets" in r
                   for r in ex["legacy_reasons"]), ex["legacy_reasons"]
        for job in jobs:
            assert len(live(server, job.id)) == 3
    finally:
        server.shutdown()


def test_exhaustion_creates_blocked_evals_that_unblock():
    server = make_server()
    try:
        seed_nodes(server, n=2, cpu=100, mem=256)
        # 8 allocs x 20 cpu do not fit 2 tiny nodes' free cpu.
        jobs, evals = run_storm(server, 1, "blocked", count=8)
        settle(server, evals)
        blocked = [e for e in server.fsm.state.evals()
                   if e.status == consts.EVAL_STATUS_BLOCKED]
        assert blocked, [
            (e.status, e.triggered_by) for e in server.fsm.state.evals()]
        # Capacity arrives -> the blocked eval unblocks and places.
        for _ in range(6):
            node = mock.node()
            node.compute_class()
            server.node_register(node)
        assert wait_until(lambda: len(live(server, jobs[0].id)) == 8, 90.0)
    finally:
        server.shutdown()


def test_device_fault_nacks_and_redelivers_never_host(monkeypatch):
    """The cohort dispatch raises for the first cohorts: every fast row
    of a faulted cohort is nacked (``device_faults``) and the broker
    redelivers it to a later cohort, which places it on the device. No
    scheduler run of either lane, nor of a worker, uses the host
    factory ("service"): dense_min_batch=1 turns size routing off, so
    "service" could only appear through a fallback."""
    import nomad_tpu_torch.server.executive as executive_mod
    import nomad_tpu_torch.server.worker as worker_mod
    from nomad_tpu_torch.scheduler.batcher import PlacementBatcher

    factories = []
    lock = threading.Lock()

    def spy(real):
        def new_scheduler(name, logger, state, planner, rng=None):
            with lock:
                factories.append(name)
            return real(name, logger, state, planner, rng=rng)
        return new_scheduler

    monkeypatch.setattr(executive_mod, "new_scheduler",
                        spy(executive_mod.new_scheduler))
    monkeypatch.setattr(worker_mod, "new_scheduler",
                        spy(worker_mod.new_scheduler))
    faults = {"left": 2}
    real_cohort = PlacementBatcher.place_cohort

    def place_cohort(self, requests):
        with lock:
            fail = faults["left"] > 0
            faults["left"] -= fail
        if fail:
            raise RuntimeError("injected device fault")
        return real_cohort(self, requests)

    monkeypatch.setattr(PlacementBatcher, "place_cohort", place_cohort)
    server = make_server(dense_min_batch=1)
    try:
        seed_nodes(server)
        jobs, evals = run_storm(server, 6, "faulted")
        settle(server, evals)
        assert faults["left"] == 0
        for job in jobs:
            assert len(live(server, job.id)) == 5
        for e in evals:
            assert server.fsm.state.eval_by_id(e).status == \
                consts.EVAL_STATUS_COMPLETE
        ex = server.executive.stats()
        assert ex["device_faults"] >= 1, ex
        assert ex["nacked"] >= ex["device_faults"], ex
        assert "host_fallbacks" not in ex
        assert all(name == "service-gpu" for name in factories), factories
    finally:
        server.shutdown()


def test_expired_eval_terminalizes_structured():
    from nomad_tpu_torch.structs.eval import new_eval

    server = make_server()
    try:
        seed_nodes(server, n=4)
        quiesce(server)
        job = make_job("late", count=4)
        idx = server.log.apply("job_register", {"job": job})
        stored = server.fsm.state.job_by_id(job.id)
        ev = new_eval(stored, consts.EVAL_TRIGGER_JOB_REGISTER)
        # Expires AFTER dequeue, while pending in the parked executive.
        ev.deadline = time.time() + 1.0
        ev.modify_index = idx
        server.eval_update([ev])
        got, token = server.broker.dequeue(["service"], timeout=5.0)
        assert got is not None and got.id == ev.id
        server.executive.submit(got, token)
        time.sleep(1.2)
        release(server)
        assert wait_until(lambda: (
            server.fsm.state.eval_by_id(ev.id) is not None
            and server.fsm.state.eval_by_id(ev.id).status
            == consts.EVAL_STATUS_FAILED), 30.0)
        desc = server.fsm.state.eval_by_id(ev.id).status_description
        assert "deadline expired" in desc
        assert server.executive.stats()["expired_dropped"] == 1
    finally:
        server.shutdown()


def test_leadership_loss_drains_accumulated_leases():
    server = make_server()
    try:
        seed_nodes(server, n=6)
        quiesce(server)
        jobs = [make_job(f"dr-{i}", count=4) for i in range(4)]
        evals = [server.job_register(j)[0] for j in jobs]
        pairs = []
        while len(pairs) < 4:
            ev, token = server.broker.dequeue(["service"], timeout=5.0)
            assert ev is not None
            pairs.append((ev, token))
        for ev, token in pairs:
            server.executive.submit(ev, token)
        assert server.executive.pending_count() == 4
        assert server.executive.drain() == 4
        assert server.executive.stats()["nacked"] >= 4
        # The nacks re-readied the evals; release and settle.
        release(server)
        settle(server, evals)
    finally:
        server.shutdown()


def test_saturation_backpressures_worker_handoff():
    server = make_server(eval_batch_size=4)
    try:
        assert not server.executive.saturated()
        quiesce(server)
        seed_nodes(server, n=4)
        jobs = [make_job(f"sat-{i}", count=4) for i in range(9)]
        evals = [server.job_register(j)[0] for j in jobs]
        pairs = []
        while len(pairs) < 8:
            ev, token = server.broker.dequeue(["service"], timeout=5.0)
            assert ev is not None
            pairs.append((ev, token))
        for ev, token in pairs:
            server.executive.submit(ev, token)
        # 2 * max_batch entries held -> the worker drain must nap.
        assert server.executive.saturated()
        release(server)
        settle(server, evals)
        assert not server.executive.saturated()
    finally:
        server.shutdown()


def test_executive_stats_surface_and_knobs():
    from nomad_tpu.server.executive import SchedulerExecutive as JaxExecutive
    from nomad_tpu.server.config import ServerConfig as JaxConfig

    server = make_server(executive_threads=2)
    try:
        st = server.stats()["scheduler_executive"]
        assert st["enabled"] and st["executive_threads"] == 2
        cfg = ServerConfig()
        assert cfg.scheduler_executive is False
        assert cfg.executive_threads == JaxConfig().executive_threads == 4
        # The reference's stats less the left-out paths' counters, plus
        # the port's device-fault count.
        ref = JaxExecutive(type("S", (), {"config": JaxConfig(
            scheduler_factories={"service": "service-tpu"},
            scheduler_executive=True)})()).stats()
        assert set(ref) - set(st) == {"host_fallbacks", "finish_dropped"}
        assert set(st) - set(ref) == {"device_faults"}
    finally:
        server.shutdown()


# ------------------------------------------------- tests/test_gang.py


def test_executive_places_gang_atomically():
    from test_gang import gang_job, topo_nodes

    server = make_server(executive_threads=2, eval_batch_size=64)
    try:
        nodes = topo_nodes(n=8, rack_size=4)
        for node in nodes:
            server.node_register(port(node))
        quiesce(server)
        # a gang job AND plain jobs: the cohort clears dense_min_batch
        # so the executive's array reconcile classifies it
        job = gang_job(k=4, slice="rack")
        evals = [server.job_register(port(job))[0]]
        for i in range(3):
            plain = mock.job()
            plain.id = f"plain-{i}"
            plain.task_groups[0].count = 2
            plain.task_groups[0].tasks[0].resources.networks = []
            evals.append(server.job_register(plain)[0])
        assert wait_until(
            lambda: server.broker.ready_count() >= len(evals), 15.0)
        release(server)
        settle(server, evals)
        members = live(server, job.id)
        assert len(members) == 4
        by_id = {n.id: n for n in nodes}
        assert len({by_id[a.node_id].meta["rack"] for a in members}) == 1
        st = server.executive.stats()
        assert st["legacy_reasons"].get("gang task group", 0) >= 1
    finally:
        server.shutdown()


# ------------------------------------------------------ cross-package


COMMON = dict(num_schedulers=2, eval_batch_size=16, scheduler_executive=True,
              executive_threads=4, eval_nack_timeout=5.0,
              eval_delivery_limit=8)


def ref_server(**over):
    """The JAX package's Server with its executive on (service-tpu)."""
    from nomad_tpu.server import Server as RefServer
    from nomad_tpu.server import ServerConfig as RefConfig

    server = RefServer(RefConfig(
        scheduler_factories={"service": "service-tpu"},
        **{**COMMON, **over}))
    server.start()
    return server


def _both(**over):
    return ref_server(**over), make_server(**{**COMMON, **over})


def test_forced_placement_matches_the_reference_executive(monkeypatch):
    """Both packages' executives over the same forced-placement cluster
    and jobs commit identical (job, slot) -> node-rank maps: the test
    seeds each executive with the storm in broker order, one executive
    thread builds the rows in cohort order, and both executives draw
    each row's PRNG seed from the same counter."""
    import nomad_tpu.server.executive as ref_executive
    import nomad_tpu_torch.server.executive as port_executive

    monkeypatch.setattr(ref_executive, "os", _CounterOS())
    monkeypatch.setattr(port_executive, "os", _CounterOS())
    n_jobs, count = 4, 3
    nodes, jobs = _forced_cluster(n_jobs, count), _forced_jobs(n_jobs, count)
    ref, srv = _both(num_schedulers=1, executive_threads=1)
    try:
        want = _run_forced(ref, nodes, jobs, lambda o: o.copy(),
                           by_hand=True)
        got = _run_forced(srv, nodes, jobs, port, by_hand=True)
        assert len(want) == n_jobs * count, want
        assert got == want
        for s in (ref, srv):
            ex = s.executive.stats()
            assert ex["cohorts"] == 1 and ex["fast_evals"] == n_jobs, ex
    finally:
        ref.shutdown()
        srv.shutdown()


@pytest.mark.parametrize("seed", [0, 1])
def test_serial_executive_places_as_the_reference(monkeypatch, seed):
    """One eval at a time through each executive's fast path (a cohort
    of one with dense_min_batch=1: reconcile, row build, place_cohort,
    finalize): each (job, group, index) lands on the same node with
    the same ports in both packages, and each eval ends alike (status,
    failed groups, blocked follow-up)."""
    import nomad_tpu.server.executive as ref_executive
    import nomad_tpu_torch.server.executive as port_executive
    from nomad_tpu.structs import new_eval as jax_new_eval

    monkeypatch.setattr(ref_executive, "os", _CounterOS())
    monkeypatch.setattr(port_executive, "os", _CounterOS())
    ref, srv = _both(num_schedulers=1, dense_min_batch=1,
                     eval_nack_timeout=30.0)
    try:
        for node in cluster(seed):
            ref.log.apply("node_register", {"node": node})
            srv.log.apply("node_register", {"node": port(node)})
        for i, job in enumerate(jobs_for(seed, impossible=True)):
            ref.log.apply("job_register", {"job": job})
            srv.log.apply("job_register", {"job": port(job)})
            ev = jax_new_eval(ref.fsm.state.job_by_id(job.id),
                              consts.EVAL_TRIGGER_JOB_REGISTER)
            ev.id = f"eval-{seed}-{i}"
            crossed = port(ev)
            ref.eval_update([ev])
            want_status = wait_terminal(ref, [ev.id])
            srv.eval_update([crossed])
            assert wait_terminal(srv, [ev.id]) == want_status
            assert placements(srv, job.id) == placements(ref, job.id), job.id
            got_ev = srv.fsm.state.eval_by_id(ev.id)
            want_ev = ref.fsm.state.eval_by_id(ev.id)
            assert sorted(got_ev.failed_tg_allocs) == \
                sorted(want_ev.failed_tg_allocs)
            assert bool(got_ev.blocked_eval) == bool(want_ev.blocked_eval)
        assert len(srv.fsm.state.allocs()) == len(ref.fsm.state.allocs())
        for s in (ref, srv):
            ex = s.executive.stats()
            assert ex["fast_evals"] >= 1 and ex["routed_host"] == 0, ex
    finally:
        ref.shutdown()
        srv.shutdown()


EXECUTIVE_STAGES = ("dispatch.accumulate", "matrix.build", "device.dispatch",
                    "device.solve", "scheduler.process")


def _storm_trace(server, job_of, rec):
    """A 6-eval storm through the executive; returns one fast eval's
    completed trace as {stage: [(annotations, parent)]}."""
    quiesce(server)
    evals = []
    for i in range(6):
        job = job_of(f"tr-{i}")
        evals.append(server.job_register(job)[0])
    assert wait_until(lambda: server.broker.ready_count() >= 6, 15.0)
    release(server)
    settle(server, evals)
    assert wait_until(lambda: all(rec.trace_for(e) for e in evals), 30.0)
    for e in evals:
        spans = {}
        for s in rec.trace_for(e)["spans"]:
            spans.setdefault(s["name"], []).append(
                (s.get("annotations", {}), s["parent"]))
        if "device.solve" in spans:
            return spans
    raise AssertionError("no storm eval took the fast path")


def test_storm_trace_holds_the_reference_executive_stages():
    from nomad_tpu import mock as jax_mock
    from nomad_tpu import trace as jax_trace
    from nomad_tpu_torch import trace as port_trace

    def jax_job(jid):
        job = jax_mock.job()
        job.id = jid
        job.task_groups[0].count = 5
        job.task_groups[0].tasks[0].resources.networks = []
        return job

    traced = {}
    for name, trace_mod, make, job_of, node_of in (
            ("ref", jax_trace, ref_server, jax_job, jax_mock.node),
            ("port", port_trace, make_server, make_job, mock.node)):
        rec = trace_mod.get_recorder()
        rec.reset()
        rec.set_enabled(True)
        server = make()
        try:
            for _ in range(8):
                node = node_of()
                node.compute_class()
                server.node_register(node)
            traced[name] = _storm_trace(server, job_of, rec)
        finally:
            server.shutdown()
            rec.reset()
    for name, spans in traced.items():
        for stage in EXECUTIVE_STAGES:
            assert stage in spans, (name, stage, sorted(spans))
        assert spans["dispatch.accumulate"][0][0]["executive"] is True
        assert spans["scheduler.process"][0][0]["path"] == "executive"
        assert spans["matrix.build"][0][0]["executive"] is True
        assert all(parent == "device.dispatch"
                   for _ann, parent in spans["device.solve"]), spans
    assert set(traced["port"]) == set(traced["ref"])
