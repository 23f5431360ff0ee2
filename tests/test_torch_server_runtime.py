"""The runtime's reference tests that need the broker or a Server, on
the port: tests/test_trace.py's dead-letter and re-block traces through
the broker (:192-249) and the span tree of every eval through the
dispatch pipeline (:336-375), tests/test_metrics.py's server worker and
FSM samples (:346), and tests/test_profile.py's pressure reasons citing
a lock site (:638). Their fault-injection (chaos) case is not carried:
the port has no chaos module."""

import threading
import time

import pytest

import torch_parity  # noqa: F401  (the port on the CPU)
from nomad_tpu_torch import mock
from nomad_tpu_torch.profile import ProfiledLock, get_profiler
from nomad_tpu_torch.trace import (
    LIFECYCLE_CORE_STAGES,
    STAGE_DEVICE_DISPATCH,
    STAGE_DISPATCH_ACCUMULATE,
    STAGE_DISPATCH_LAUNCH,
    STAGE_MATRIX_BUILD,
    get_recorder,
)


def wait_until(fn, timeout=60.0, interval=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if fn():
            return True
        time.sleep(interval)
    return False


@pytest.fixture(autouse=True)
def fresh_recorder():
    """The recorder is process-global; every test starts it empty and
    enabled."""
    rec = get_recorder()
    rec.reset()
    rec.set_enabled(True)
    yield rec
    rec.reset()


@pytest.fixture
def prof():
    p = get_profiler()
    p.reset()
    p.set_enabled(True)
    yield p
    p.reset()
    p.set_enabled(True)


def test_dead_letter_completes_trace_exactly_once(fresh_recorder):
    """Delivery-limit exhaustion closes the trace as 'dead-letter';
    the failed-queue copy and the reaper's later dequeue+ack must NOT
    open or publish a second trace for the same eval."""
    from nomad_tpu_torch.server.broker import FAILED_QUEUE, EvalBroker

    broker = EvalBroker(nack_timeout=60.0, delivery_limit=1)
    broker.set_enabled(True)
    ev = mock.eval()
    broker.enqueue(ev)
    got, token = broker.dequeue([ev.type], timeout=1.0)
    assert got is not None
    broker.nack(ev.id, token)  # delivery limit 1 -> dead-letters
    rec = fresh_recorder
    tr = rec.trace_for(ev.id)
    assert tr is not None and tr["status"] == "dead-letter"
    # the dead copy sits in the failed queue with NO active trace
    assert broker.failed_evals()
    assert rec.stats()["active"] == 0
    # reaper-style pickup: dequeue from the failed queue and ack
    dead, dtoken = broker.dequeue([FAILED_QUEUE], timeout=1.0)
    assert dead is not None
    broker.ack(dead.id, dtoken)
    # still exactly one completed trace, still the dead-letter one
    assert rec.stats()["completed"] == 1
    assert rec.trace_for(ev.id)["status"] == "dead-letter"


def test_reblock_requeue_starts_fresh_trace_with_broker_wait(
        fresh_recorder):
    """An eval reblocked while outstanding: ack completes the FIRST
    run's trace, and the requeued run re-enters with its own enqueue
    mark so its next dequeue still records broker.wait."""
    from nomad_tpu_torch.server.broker import EvalBroker

    broker = EvalBroker(nack_timeout=60.0)
    broker.set_enabled(True)
    ev = mock.eval()
    broker.enqueue(ev)
    got, token = broker.dequeue([ev.type], timeout=1.0)
    assert got is not None
    broker.enqueue(ev, token)  # reblock while outstanding
    broker.ack(ev.id, token)
    rec = fresh_recorder
    assert rec.trace_for(ev.id)["status"] == "acked"
    # the requeued run is live again with a fresh enqueue mark...
    assert rec.stats()["active"] == 1
    got2, token2 = broker.dequeue([ev.type], timeout=1.0)
    assert got2 is not None
    broker.ack(ev.id, token2)
    # ...and its own complete trace carrying broker.wait
    assert rec.stats()["completed"] == 2
    second = rec.trace_for(ev.id)
    assert "broker.wait" in {s["name"] for s in second["spans"]}


def make_server(**over):
    from nomad_tpu_torch.server import Server, ServerConfig

    defaults = dict(
        num_schedulers=4,
        scheduler_factories={"service": "service-gpu"},
        eval_batch_size=16,
        eval_nack_timeout=60.0,
    )
    defaults.update(over)
    server = Server(ServerConfig(**defaults))
    server.start()
    return server


def run_dense_storm(server, n_jobs=6):
    """Register a storm of dense-path jobs while the workers are parked,
    release, and wait for completion. Returns the eval ids."""
    for w in server.workers:
        w.set_pause(True)
    assert wait_until(lambda: all(w.parked() for w in server.workers), 10.0)
    jobs = []
    for _ in range(n_jobs):
        job = mock.job()
        job.task_groups[0].count = 5  # >3 engages the dense path
        job.task_groups[0].tasks[0].resources.cpu = 20
        job.task_groups[0].tasks[0].resources.memory_mb = 16
        server.job_register(job)
        jobs.append(job)
    assert wait_until(lambda: server.broker.ready_count() >= n_jobs, 10.0)
    for w in server.workers:
        w.set_pause(False)
    assert wait_until(
        lambda: all(
            len(server.fsm.state.allocs_by_job(j.id)) == 5 for j in jobs),
        timeout=120.0)
    evals = [e for j in jobs for e in server.fsm.state.evals_by_job(j.id)]
    assert wait_until(
        lambda: (lambda s: s["acked"] + s["nacked"] >= n_jobs
                 and s["in_flight"] == 0)(server.dispatch.stats()),
        timeout=30.0)
    return [e.id for e in evals]


def _assert_monotonic_tree(tr):
    prev_start = -1.0
    for s in tr["spans"]:
        assert s["start_ms"] >= 0.0
        assert s["end_ms"] >= s["start_ms"]
        assert s["start_ms"] >= prev_start  # sorted by start
        prev_start = s["start_ms"]
        assert s["end_ms"] <= tr["duration_ms"] + 1.0


def test_e2e_span_tree_per_eval_dense_pipeline(fresh_recorder):
    """Every eval through the dispatch pipeline yields ONE complete
    span tree: broker wait, pipeline accumulate/launch, scheduler
    invoke, matrix build, device dispatch, plan submit/evaluate/commit,
    alloc upsert — with monotonic timestamps."""
    server = make_server()
    try:
        for _ in range(8):
            node = mock.node()
            node.compute_class()
            server.node_register(node)
        eval_ids = run_dense_storm(server, n_jobs=6)
        rec = fresh_recorder
        complete = []
        for eid in eval_ids:
            tr = rec.trace_for(eid)
            if tr is None:
                continue
            names = {s["name"] for s in tr["spans"]}
            if set(LIFECYCLE_CORE_STAGES) <= names:
                complete.append(tr)
        assert complete, "no complete span tree found"
        dense = [
            tr for tr in complete
            if {STAGE_DISPATCH_ACCUMULATE, STAGE_DISPATCH_LAUNCH,
                STAGE_MATRIX_BUILD,
                STAGE_DEVICE_DISPATCH} <= {s["name"] for s in tr["spans"]}
        ]
        assert dense, "no trace covered the dense pipeline stages"
        for tr in complete:
            assert tr["status"] == "acked"
            _assert_monotonic_tree(tr)
        stages = rec.stage_stats()
        for stage in LIFECYCLE_CORE_STAGES + ("e2e",):
            assert stage in stages, f"missing stage {stage}"
            assert stages[stage]["p99_ms"] >= stages[stage]["p50_ms"] >= 0
        # the table also rides server.stats()
        assert "trace" in server.stats()
        assert server.stats()["trace"].keys() == stages.keys()
    finally:
        server.shutdown()


def test_server_emits_worker_and_fsm_samples():
    """End to end: registering and scheduling a job must produce fsm/
    worker/plan timing samples in the global registry, and the gauge
    loop the broker gauges."""
    from nomad_tpu_torch.server import Server, ServerConfig
    from nomad_tpu_torch.utils import metrics as gm

    gm.configure()  # fresh global registry
    s = Server(ServerConfig(num_schedulers=1, telemetry_interval=0.05))
    s.start()
    try:
        for i in range(3):
            s.fsm.state.upsert_node(i + 1, mock.node())
        job = mock.job()
        s.job_register(job)

        deadline = time.monotonic() + 5.0
        needed = {
            "nomad_tpu.fsm.job_register",
            "nomad_tpu.worker.invoke_scheduler.service",
            "nomad_tpu.plan.evaluate",
        }
        while time.monotonic() < deadline:
            seen = set()
            for iv in gm.get_metrics().snapshot():
                seen |= set(iv["samples"])
            if needed <= seen:
                break
            time.sleep(0.05)
        assert needed <= seen, f"missing: {needed - seen}"

        deadline = time.monotonic() + 3.0
        while time.monotonic() < deadline:
            gauges = {}
            for iv in gm.get_metrics().snapshot():
                gauges.update(iv["gauges"])
            if "nomad_tpu.broker.total_ready" in gauges:
                break
            time.sleep(0.05)
        assert "nomad_tpu.broker.total_ready" in gauges
    finally:
        s.shutdown()
        gm.configure()  # reset global for other tests


def test_pressure_reasons_cite_lock_site(prof):
    """With the lock-wait thresholds configured, sustained contention
    drives the pressure level and the reason NAMES the hottest
    site."""
    from nomad_tpu_torch.server import Server, ServerConfig

    server = Server(ServerConfig(
        num_schedulers=1,
        admission_lock_wait_yellow_ms=0.0001,
        admission_lock_wait_red_ms=1e9))
    server.start()
    try:
        lock = ProfiledLock("test.pressure.site")

        def holder():
            with lock:
                time.sleep(0.03)

        t = threading.Thread(target=holder)
        t.start()
        time.sleep(0.005)
        with lock:
            pass
        t.join()
        snap = server.admission.pressure.snapshot(refresh=True)
        assert snap["inputs"]["lock_wait_p99_ms"] > 0
        assert snap["inputs"]["lock_wait_site"] == "test.pressure.site"
        assert snap["level"] in ("yellow", "red")
        assert any("test.pressure.site" in r for r in snap["reasons"])
    finally:
        server.shutdown()
