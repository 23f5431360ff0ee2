"""The port's dev-mode Server end to end against the JAX package's, on
the same cluster and the same jobs.

Serial: one worker and ``eval_batch_size=1`` (no pipeline, no
batching). Nodes and jobs go in through ``log.apply``, the evals with
fixed ids through ``eval_update``, one at a time, and each worker's
per-eval PRNG is seeded from the same counter in both packages (the
worker seeds it from ``os.urandom``; the test gives both worker modules
a counter in its place), so both packages draw the same noise and port
offers. Each (job, group, index) must land on the same node, with the
same ports, through the host factories and through the dense ones
(``service-tpu`` / ``service-gpu``).

Batched: the dispatch pipeline, the workers paused while the jobs
register, then released. Batch composition depends on thread timing,
so the placements themselves may differ; the test holds both packages
to the same invariants instead: every eval complete, the same placed
and failed counts per job, distinct_hosts held, no port held twice on a
node, and every node's live allocs fit (``allocs_fit``)."""

from __future__ import annotations

import itertools
import random
import time

import pytest

import torch_parity  # noqa: F401  (the port on the CPU)
from nomad_tpu import mock
from nomad_tpu.structs import Constraint, consts, new_eval
from nomad_tpu.utils.codec import to_dict
from nomad_tpu_torch import structs as pstructs
from nomad_tpu_torch.utils.codec import from_dict

WAIT_S = 60.0


def port(obj):
    return from_dict(getattr(pstructs, type(obj).__name__), to_dict(obj))


class _CounterOS:
    """Stands in for the worker module's ``os``: urandom gives the next
    value of a counter, so the n-th eval a worker runs gets the same
    PRNG seed in both packages."""

    def __init__(self):
        self._n = itertools.count(1)

    def urandom(self, n):
        return next(self._n).to_bytes(n, "little")


def cluster(seed, n_nodes=24):
    rng = random.Random(seed)
    nodes = []
    for i in range(n_nodes):
        node = mock.node()
        node.id = f"node-{seed}-{i:03d}"
        node.resources.cpu = rng.choice([2000, 3000, 4000])
        node.resources.memory_mb = rng.choice([4096, 8192])
        node.compute_class()
        nodes.append(node)
    return nodes


def jobs_for(seed, n_jobs=6, impossible=False):
    rng = random.Random(seed + 100)
    jobs = []
    for j in range(n_jobs):
        job = mock.job()
        job.id = f"job-{seed}-{j}"
        tg = job.task_groups[0]
        tg.count = rng.choice([5, 6, 7, 8])
        tg.tasks[0].resources.cpu = rng.choice([100, 250, 500])
        tg.tasks[0].resources.memory_mb = rng.choice([64, 256])
        if j % 2 == 0:
            tg.constraints.append(
                Constraint(operand=consts.CONSTRAINT_DISTINCT_HOSTS))
        if j % 3 == 2:
            api = tg.copy()
            api.name = "api"
            api.count = rng.choice([4, 6])
            api.tasks[0].resources.cpu = 150
            job.task_groups = [tg, api]
        jobs.append(job)
    if impossible:
        job = mock.job()
        job.id = f"job-{seed}-huge"
        job.task_groups[0].count = 4
        job.task_groups[0].tasks[0].resources.cpu = 100_000
        jobs.append(job)
    return jobs


def wait_terminal(server, eval_ids, timeout=WAIT_S):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        evs = [server.fsm.state.eval_by_id(e) for e in eval_ids]
        if all(e is not None and e.terminal_status() for e in evs):
            return [e.status for e in evs]
        time.sleep(0.01)
    raise AssertionError(f"evals not terminal after {timeout} s")


def placements(server, job_id):
    """{alloc name: (node id, {task: sorted port values})} of the
    job's live allocs."""
    out = {}
    for a in server.fsm.state.allocs_by_job(job_id):
        if a.terminal_status():
            continue
        ports = {t: sorted(p.value for n in (r.networks or [])
                           for p in list(n.reserved_ports)
                           + list(n.dynamic_ports))
                 for t, r in (a.task_resources or {}).items()}
        out[a.name] = (a.node_id, ports)
    return out


def servers(ref_cfg, port_cfg):
    from nomad_tpu.server import Server as RefServer
    from nomad_tpu_torch.server import Server

    ref, srv = RefServer(ref_cfg), Server(port_cfg)
    ref.start()
    srv.start()
    return ref, srv


@pytest.mark.parametrize("factories", [("service", "service"),
                                       ("service-tpu", "service-gpu")])
@pytest.mark.parametrize("seed", [0, 1])
def test_serial_server_places_as_the_reference(monkeypatch, seed,
                                               factories):
    import nomad_tpu.server.worker as ref_worker
    import nomad_tpu_torch.server.worker as port_worker
    from nomad_tpu.server import ServerConfig as RefConfig
    from nomad_tpu_torch.server import ServerConfig

    monkeypatch.setattr(ref_worker, "os", _CounterOS())
    monkeypatch.setattr(port_worker, "os", _CounterOS())
    kw = dict(num_schedulers=1, eval_batch_size=1, eval_nack_timeout=30.0)
    ref, srv = servers(
        RefConfig(scheduler_factories={"service": factories[0]}, **kw),
        ServerConfig(scheduler_factories={"service": factories[1]}, **kw))
    try:
        for node in cluster(seed):
            ref.log.apply("node_register", {"node": node})
            srv.log.apply("node_register", {"node": port(node)})
        for i, job in enumerate(jobs_for(seed, impossible=True)):
            ref.log.apply("job_register", {"job": job})
            srv.log.apply("job_register", {"job": port(job)})
            ev = new_eval(ref.fsm.state.job_by_id(job.id),
                          consts.EVAL_TRIGGER_JOB_REGISTER)
            ev.id = f"eval-{seed}-{i}"
            crossed = port(ev)
            ref.eval_update([ev])
            want_status = wait_terminal(ref, [ev.id])
            srv.eval_update([crossed])
            assert wait_terminal(srv, [ev.id]) == want_status
            want = placements(ref, job.id)
            assert placements(srv, job.id) == want, job.id
            got_ev = srv.fsm.state.eval_by_id(ev.id)
            want_ev = ref.fsm.state.eval_by_id(ev.id)
            assert sorted(got_ev.failed_tg_allocs) == \
                sorted(want_ev.failed_tg_allocs)
            assert bool(got_ev.blocked_eval) == bool(want_ev.blocked_eval)
        assert len(srv.fsm.state.allocs()) == len(ref.fsm.state.allocs())
    finally:
        ref.shutdown()
        srv.shutdown()


def paused_wave(server, jobs):
    for w in server.workers:
        w.set_pause(True)
    deadline = time.monotonic() + 10.0
    while not all(w.parked() for w in server.workers):
        assert time.monotonic() < deadline, "workers did not park"
        time.sleep(0.005)
    evals = [server.job_register(job)[0] for job in jobs]
    for w in server.workers:
        w.set_pause(False)
    return wait_terminal(server, evals)


def invariants(server, jobs, fit):
    """Per job (placed, failed groups) and the node-level holds, with
    the server's own package's ``allocs_fit``."""
    state = server.fsm.state
    out = {}
    for job in jobs:
        live = [a for a in state.allocs_by_job(job.id)
                if not a.terminal_status()]
        # The registration's own eval (a blocked follow-up carries the
        # same trigger and comes later).
        ev = min(state.evals_by_job(job.id), key=lambda e: e.create_index)
        dh = any(c.operand == consts.CONSTRAINT_DISTINCT_HOSTS
                 for tg in job.task_groups for c in tg.constraints)
        if dh:
            by_group = {}
            for a in live:
                by_group.setdefault(a.task_group, []).append(a.node_id)
            for nodes in by_group.values():
                assert len(set(nodes)) == len(nodes), job.id
        out[job.id] = (len(live), sorted(ev.failed_tg_allocs or {}))
    for node in state.nodes():
        live = state.allocs_by_node_terminal(node.id, False)
        seen = []
        for a in live:
            for r in (a.task_resources or {}).values():
                for n in r.networks or []:
                    seen += [p.value for p in list(n.reserved_ports)
                             + list(n.dynamic_ports)]
        assert len(seen) == len(set(seen)), f"port twice on {node.id}"
        assert fit(node, live)[0], f"{node.id} over capacity"
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_batched_server_holds_the_reference_invariants(seed):
    from nomad_tpu.server import ServerConfig as RefConfig
    from nomad_tpu.structs import allocs_fit as ref_fit
    from nomad_tpu_torch.server import ServerConfig
    from nomad_tpu_torch.structs import allocs_fit as port_fit

    kw = dict(num_schedulers=2, eval_batch_size=16, eval_nack_timeout=30.0)
    ref, srv = servers(
        RefConfig(scheduler_factories={"service": "service-tpu"}, **kw),
        ServerConfig(scheduler_factories={"service": "service-gpu"}, **kw))
    try:
        nodes = cluster(seed, n_nodes=32)
        for node in nodes:
            ref.log.apply("node_register", {"node": node})
            srv.log.apply("node_register", {"node": port(node)})
        jobs = jobs_for(seed, n_jobs=10, impossible=True)
        want_status = paused_wave(ref, jobs)
        got_status = paused_wave(srv, [port(j) for j in jobs])
        assert got_status == want_status
        assert set(want_status) == {consts.EVAL_STATUS_COMPLETE}
        want = invariants(ref, jobs, ref_fit)
        assert invariants(srv, jobs, port_fit) == want
        assert want[f"job-{seed}-huge"] == (0, ["web"])
        # The wave went through the pipeline in batches, not one by one.
        assert srv.dispatch.stats()["dispatched_evals"] >= len(jobs)
        assert srv.dispatch.stats()["routed_host"] < len(jobs)
    finally:
        ref.shutdown()
        srv.shutdown()


def _reject_every_node(server, submits):
    """The server's applier verifies no node of any plan: each plan is
    wholly rejected with a refresh, so no attempt makes progress."""
    inner = server.plan_applier._evaluate_plan

    def reject(snapshot, plan):
        result = inner(snapshot, plan)
        submits.append(plan.eval_id)
        result.node_allocation = {}
        result.node_update = {}
        result.refresh_index = snapshot.latest_index()
        return result

    server.plan_applier._evaluate_plan = reject


@pytest.mark.parametrize("dense", [False, True])
def test_rejected_plans_fail_the_eval_as_the_reference(dense):
    """An eval whose plans the applier keeps rejecting ends ``failed``
    on the scheduler's attempt limit in both packages, after the same
    number of plan submissions, through the dispatch pipeline's
    conflict requeues (dense) or the worker alone (host)."""
    from nomad_tpu.scheduler.generic import MAX_SERVICE_SCHEDULE_ATTEMPTS
    from nomad_tpu.server import ServerConfig as RefConfig
    from nomad_tpu_torch.server import ServerConfig

    factories = ("service-tpu", "service-gpu") if dense else \
        ("service", "service")
    kw = dict(num_schedulers=1, eval_batch_size=16, dense_min_batch=1,
              eval_nack_timeout=30.0)
    ref, srv = servers(
        RefConfig(scheduler_factories={"service": factories[0]}, **kw),
        ServerConfig(scheduler_factories={"service": factories[1]}, **kw))
    try:
        for node in cluster(0, n_nodes=8):
            ref.log.apply("node_register", {"node": node})
            srv.log.apply("node_register", {"node": port(node)})
        want_submits, got_submits = [], []
        _reject_every_node(ref, want_submits)
        _reject_every_node(srv, got_submits)
        job = jobs_for(0, n_jobs=1)[0]
        ev, _ = ref.job_register(job)
        want = ref.fsm.state.eval_by_id(ev)
        assert wait_terminal(ref, [ev]) == [consts.EVAL_STATUS_FAILED]
        ev, _ = srv.job_register(port(job))
        assert wait_terminal(srv, [ev]) == [consts.EVAL_STATUS_FAILED]
        want = ref.fsm.state.eval_by_id(want.id)
        got = srv.fsm.state.eval_by_id(ev)
        assert got.status_description == want.status_description
        assert "maximum attempts" in got.status_description
        assert len(got_submits) == len(want_submits)
        # The scheduler's attempt limit, after the pipeline's requeues.
        requeues = ServerConfig().dispatch_max_requeues
        assert len(got_submits) == MAX_SERVICE_SCHEDULE_ATTEMPTS + (
            requeues if dense else 0)
        if dense:
            assert srv.dispatch.stats()["requeues"] == \
                ref.dispatch.stats()["requeues"] > 0
        assert srv.fsm.state.allocs_by_job(job.id) == []
    finally:
        ref.shutdown()
        srv.shutdown()


def networked_two_group_jobs(seed, n_jobs, count):
    """chip_smoke.py phase 12's first pre_resolve-off wave at a small
    count: the mock two-group job (web cpu 500, api cpu 250 / 384 MB),
    each task asking 50 Mbit/s and two dynamic ports."""
    jobs = []
    for j in range(n_jobs):
        job = mock.job()
        job.id = f"off-{seed}-{j}"
        web = job.task_groups[0]
        web.count = count
        api = web.copy()
        api.name = "api"
        api.tasks[0].resources.cpu = 250
        api.tasks[0].resources.memory_mb = 384
        job.task_groups = [web, api]
        jobs.append(job)
    return jobs


@pytest.mark.parametrize("seed", [0, 1])
def test_pre_resolve_off_networked_wave_as_the_reference(seed):
    """Batched evals with ``dense_pre_resolve=False`` scan independently
    and collide on the same nodes; the applier's rejections come back
    through the pipeline's conflict requeue and the schedulers' retries.
    Both packages go through the same networked wave, and the port is
    held to the reference's per-job statuses, placed counts and failed
    groups, with every node's ports unique and its allocs fitting."""
    from nomad_tpu.server import ServerConfig as RefConfig
    from nomad_tpu.structs import allocs_fit as ref_fit
    from nomad_tpu_torch.server import ServerConfig
    from nomad_tpu_torch.structs import allocs_fit as port_fit

    kw = dict(num_schedulers=2, eval_batch_size=16, eval_nack_timeout=30.0,
              dense_pre_resolve=False)
    ref, srv = servers(
        RefConfig(scheduler_factories={"service": "service-tpu"}, **kw),
        ServerConfig(scheduler_factories={"service": "service-gpu"}, **kw))
    try:
        for node in cluster(seed, n_nodes=48):
            ref.log.apply("node_register", {"node": node})
            srv.log.apply("node_register", {"node": port(node)})
        jobs = networked_two_group_jobs(seed, n_jobs=8, count=16)
        want_status = paused_wave(ref, jobs)
        got_status = paused_wave(srv, [port(j) for j in jobs])
        assert got_status == want_status
        want = invariants(ref, jobs, ref_fit)
        assert invariants(srv, jobs, port_fit) == want
        # The wave did collide in both packages.
        assert ref.dispatch.stats()["plan_conflicts"] > 0
        assert srv.dispatch.stats()["plan_conflicts"] > 0
    finally:
        ref.shutdown()
        srv.shutdown()
