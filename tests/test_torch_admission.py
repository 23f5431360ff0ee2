"""The port's admission package (nomad_tpu_torch/admission): the JAX
package's tests/test_admission.py (token buckets, the admission
controller's level-driven policy, the pressure monitor, deadline
derivation) run on the port, without the device-path circuit breaker
and the fault-injection sites, which the port does not carry; then the
same inputs go through both packages and must give the same levels,
reasons, verdicts and deadlines."""

import torch_parity  # noqa: F401  (the port on the CPU)
import time
from types import SimpleNamespace

import pytest

from nomad_tpu_torch.admission import (
    LEVEL_GREEN,
    LEVEL_RED,
    LEVEL_YELLOW,
    ROUTE_EXEMPT,
    ROUTE_READ,
    ROUTE_WRITE,
    RPC_EXEMPT_KINDS,
    AdmissionController,
    AdmissionRejected,
    PressureMonitor,
    TokenBucket,
    classify_http,
    deadline_for,
    priority_factor,
)
from nomad_tpu_torch.admission import deadline as deadline_mod
from nomad_tpu_torch.server.config import ServerConfig
from nomad_tpu_torch.structs import Evaluation, consts


def stub_server(cfg=None, ready=0, unacked=0, blocked=0, shed=0,
                expired=0, in_flight=0, pending=0, max_batch=64,
                max_inflight=2, dispatch_enabled=True,
                ready_by_queue=None):
    cfg = cfg or ServerConfig()
    if ready_by_queue is None:
        # Default: all ready depth on the 'service' queue.
        ready_by_queue = {"service": ready} if ready else {}
    broker = SimpleNamespace(stats=lambda: {
        "ready_by_queue": dict(ready_by_queue),
        "total_ready": ready, "total_unacked": unacked,
        "total_blocked": blocked, "total_waiting": 0,
        "dead_lettered": 0, "shed": shed, "expired": expired,
    })
    dispatch = SimpleNamespace(
        stats=lambda: {
            "enabled": dispatch_enabled, "in_flight": in_flight,
            "pending": pending, "max_batch": max_batch,
        },
        max_inflight=max_inflight,
    )
    return SimpleNamespace(config=cfg, broker=broker, dispatch=dispatch)


# ---------------------------------------------------------------- bucket


def test_token_bucket_burst_then_deficit_hint():
    b = TokenBucket(rate=10.0, burst=2.0)
    ok1, _ = b.try_acquire()
    ok2, _ = b.try_acquire()
    assert ok1 and ok2
    ok3, retry = b.try_acquire()
    assert not ok3
    assert 0.0 < retry <= 0.2  # ~1 token deficit at 10/s
    st = b.stats()
    assert st["granted"] == 2 and st["rejected"] == 1


def test_token_bucket_refills_at_rate():
    b = TokenBucket(rate=100.0, burst=1.0)
    assert b.try_acquire()[0]
    assert not b.try_acquire()[0]
    time.sleep(0.05)  # 100/s refills a full token in 10ms
    assert b.try_acquire()[0]


def test_token_bucket_zero_rate_never_grants_after_burst():
    b = TokenBucket(rate=0.0, burst=1.0)
    assert b.try_acquire()[0]
    ok, retry = b.try_acquire()
    assert not ok and retry > 0


# ------------------------------------------------------------- classify


def test_classify_http_route_classes():
    assert classify_http("POST", "/v1/internal/eval/ack") == ROUTE_EXEMPT
    assert classify_http("GET", "/v1/agent/self") == ROUTE_EXEMPT
    assert classify_http("GET", "/v1/metrics") == ROUTE_EXEMPT
    assert classify_http("GET", "/v1/status/leader") == ROUTE_EXEMPT
    # Client control traffic: shedding heartbeats would turn overload
    # into node-down cascades.
    assert classify_http(
        "PUT", "/v1/node/n1/heartbeat", "node_heartbeat") == ROUTE_EXEMPT
    assert classify_http(
        "POST", "/v1/node/n1/allocs", "node_update_allocs") == ROUTE_EXEMPT
    assert classify_http("PUT", "/v1/jobs", "jobs") == ROUTE_WRITE
    assert classify_http("DELETE", "/v1/job/x", "job") == ROUTE_WRITE
    assert classify_http("GET", "/v1/jobs", "jobs") == ROUTE_READ
    assert classify_http("GET", "/v1/allocations") == ROUTE_READ


# ------------------------------------------------------------- pressure


def test_pressure_green_when_quiet():
    mon = PressureMonitor(stub_server(), ServerConfig())
    snap = mon.snapshot(refresh=True)
    assert snap["level"] == LEVEL_GREEN
    assert snap["reasons"] == []


def test_pressure_absolute_depth_thresholds_when_uncapped():
    cfg = ServerConfig(admission_depth_yellow=10, admission_depth_red=20)
    mon = PressureMonitor(stub_server(cfg, ready=8, unacked=3), cfg)
    assert mon.snapshot(refresh=True)["level"] == LEVEL_YELLOW
    mon = PressureMonitor(stub_server(cfg, ready=18, unacked=3), cfg)
    snap = mon.snapshot(refresh=True)
    assert snap["level"] == LEVEL_RED
    assert any("depth" in r for r in snap["reasons"])


def test_pressure_capped_queues_use_cap_fractions():
    cfg = ServerConfig(eval_ready_cap=100)
    # 4 enabled schedulers x 100 = 400 total budget; 300/400 = 75%.
    mon = PressureMonitor(stub_server(cfg, ready=300), cfg)
    assert mon.snapshot(refresh=True)["level"] == LEVEL_YELLOW
    mon = PressureMonitor(stub_server(cfg, ready=395), cfg)
    assert mon.snapshot(refresh=True)["level"] == LEVEL_RED


def test_pressure_uncapped_backlog_is_not_cap_pressure():
    """Backlog on a deliberately-UNCAPPED queue must not read as
    pressure against another queue's cap (it used to: total ready
    across all queues was divided by only the capped budget, so 500
    batch evals drove a false red that shed healthy service traffic).
    It is still visible — through the absolute depth thresholds."""
    cfg = ServerConfig(eval_ready_cap=0, eval_ready_caps={"service": 100})
    mon = PressureMonitor(
        stub_server(cfg, ready=500, ready_by_queue={"batch": 500}), cfg)
    snap = mon.snapshot(refresh=True)
    assert not any("of cap" in r for r in snap["reasons"]), snap
    # Defaults: depth_yellow=256 — the backlog reads as absolute depth.
    assert snap["level"] == LEVEL_YELLOW
    assert any("broker depth" in r for r in snap["reasons"])
    assert snap["inputs"]["ready_capped"] == 0
    # The capped queue itself still drives the fraction.
    mon = PressureMonitor(
        stub_server(cfg, ready=99, ready_by_queue={"service": 99}), cfg)
    snap = mon.snapshot(refresh=True)
    assert snap["level"] == LEVEL_RED
    assert any("of cap" in r for r in snap["reasons"])


def test_pressure_blocked_and_unacked_count_toward_absolute_depth():
    cfg = ServerConfig(admission_depth_yellow=10, admission_depth_red=20)
    mon = PressureMonitor(stub_server(cfg, unacked=6, blocked=6), cfg)
    snap = mon.snapshot(refresh=True)
    assert snap["level"] == LEVEL_YELLOW
    assert snap["inputs"]["blocked"] == 6


def test_pressure_dispatch_saturation():
    cfg = ServerConfig()
    mon = PressureMonitor(
        stub_server(cfg, in_flight=2, pending=64, max_batch=64,
                    max_inflight=2), cfg)
    assert mon.snapshot(refresh=True)["level"] == LEVEL_YELLOW
    mon = PressureMonitor(
        stub_server(cfg, in_flight=2, pending=128, max_batch=64,
                    max_inflight=2), cfg)
    assert mon.snapshot(refresh=True)["level"] == LEVEL_RED


def test_pressure_e2e_p99_input(monkeypatch):
    from nomad_tpu_torch.trace.recorder import FlightRecorder

    monkeypatch.setattr(FlightRecorder, "e2e_p99", lambda self: 900.0)
    cfg = ServerConfig(admission_p99_yellow_ms=500.0,
                       admission_p99_red_ms=2000.0)
    mon = PressureMonitor(stub_server(cfg), cfg)
    snap = mon.snapshot(refresh=True)
    assert snap["level"] == LEVEL_YELLOW
    assert any("p99" in r for r in snap["reasons"])
    assert snap["inputs"]["e2e_p99_ms"] == 900.0


# ------------------------------------------------------------ controller


def make_controller(**cfg_over):
    cfg = ServerConfig(**cfg_over)
    return AdmissionController(stub_server(cfg), cfg)


def test_controller_green_admits_everything():
    ctl = make_controller(admission_write_rate=0.0,
                          admission_write_burst=0.0)
    ctl.check_http("PUT", "/v1/jobs", "jobs")  # no raise even at 0 rate
    ctl.check_rpc("bulk_query")


def test_controller_yellow_rate_limits_writes_429():
    ctl = make_controller(admission_write_rate=100.0,
                          admission_write_burst=1.0)
    ctl.force_level(LEVEL_YELLOW)
    ctl.check_http("PUT", "/v1/jobs", "jobs")  # burst token
    with pytest.raises(AdmissionRejected) as exc:
        ctl.check_http("PUT", "/v1/jobs", "jobs")
    assert exc.value.status == 429
    assert exc.value.retry_after > 0
    # Reads pass under yellow.
    ctl.check_http("GET", "/v1/jobs", "jobs")
    assert ctl.snapshot()["http_rejected"] == 1


def test_controller_red_sheds_writes_503_limits_reads():
    ctl = make_controller(admission_read_rate=100.0,
                          admission_read_burst=1.0,
                          admission_red_retry_after=2.5)
    ctl.force_level(LEVEL_RED)
    with pytest.raises(AdmissionRejected) as exc:
        ctl.check_http("POST", "/v1/jobs", "jobs")
    assert exc.value.status == 503
    assert exc.value.retry_after == 2.5
    ctl.check_http("GET", "/v1/jobs", "jobs")  # read burst token
    with pytest.raises(AdmissionRejected) as exc:
        ctl.check_http("GET", "/v1/jobs", "jobs")
    assert exc.value.status == 429


def test_controller_red_degrades_reads_to_stale_with_replica():
    """With replica state on hand, an over-budget red read degrades to
    the 'stale' verdict (serve local replica) instead of a 429; the
    stub-server path without an fsm keeps the old 429 behavior."""
    cfg = ServerConfig(admission_read_rate=100.0,
                       admission_read_burst=1.0)
    server = stub_server(cfg)
    server.fsm = SimpleNamespace(
        state=SimpleNamespace(latest_index=lambda: 7))
    ctl = AdmissionController(server, cfg)
    ctl.force_level(LEVEL_RED)
    assert ctl.check_http("GET", "/v1/jobs", "jobs") is None  # burst token
    assert ctl.check_http("GET", "/v1/jobs", "jobs") == "stale"
    # No replica yet (index 0) → the 429 path stands.
    server.fsm.state = SimpleNamespace(latest_index=lambda: 0)
    with pytest.raises(AdmissionRejected) as exc:
        ctl.check_http("GET", "/v1/jobs", "jobs")
    assert exc.value.status == 429


def test_controller_exemptions_hold_under_red():
    ctl = make_controller()
    ctl.force_level(LEVEL_RED)
    ctl.check_http("POST", "/v1/internal/plan/submit", "internal_plan_submit")
    ctl.check_http("PUT", "/v1/node/n/heartbeat", "node_heartbeat")
    ctl.check_http("GET", "/v1/metrics", "metrics")
    for kind in sorted(RPC_EXEMPT_KINDS):
        ctl.check_rpc(kind)
    with pytest.raises(AdmissionRejected) as exc:
        ctl.check_rpc("bulk_query")
    assert exc.value.status == 503


def test_controller_disabled_is_transparent():
    ctl = make_controller(admission_enabled=False)
    ctl.force_level(LEVEL_RED)
    ctl.check_http("PUT", "/v1/jobs", "jobs")
    ctl.check_rpc("bulk_query")


# -------------------------------------------------------------- deadline


def test_deadline_priority_scaling():
    assert priority_factor(consts.JOB_DEFAULT_PRIORITY) == 1.0
    assert priority_factor(100) == 1.5
    assert priority_factor(consts.CORE_JOB_PRIORITY) == 2.5
    assert priority_factor(-1000) == 0.25  # floor
    now = 1000.0
    assert deadline_for(50, 30.0, now) == pytest.approx(1030.0)
    assert deadline_for(100, 30.0, now) == pytest.approx(1045.0)
    assert deadline_for(50, 0.0, now) == 0.0  # disabled


def test_deadline_stamp_semantics():
    now = 5000.0
    ev = Evaluation(id="e1", priority=50,
                    status=consts.EVAL_STATUS_PENDING)
    deadline_mod.stamp(ev, 30.0, now)
    assert ev.deadline == pytest.approx(5030.0)
    # Idempotent: a re-commit through the funnel keeps the original.
    deadline_mod.stamp(ev, 99.0, now + 100)
    assert ev.deadline == pytest.approx(5030.0)
    # Terminal evals are never stamped.
    done = Evaluation(id="e2", priority=50,
                      status=consts.EVAL_STATUS_COMPLETE)
    deadline_mod.stamp(done, 30.0, now)
    assert done.deadline == 0.0
    assert not ev.expired(now + 10)
    assert ev.expired(now + 31)


def test_server_eval_update_stamps_fresh_pending_evals():
    from nomad_tpu_torch.server import Server, ServerConfig as SC

    server = Server(SC(num_schedulers=0, eval_deadline_ttl=30.0))
    server.start()
    try:
        ev = Evaluation(id="stamped", priority=50, type="service",
                        job_id="j1", status=consts.EVAL_STATUS_PENDING)
        before = time.time()
        server.eval_update([ev])
        stored = server.fsm.state.eval_by_id("stamped")
        assert stored.deadline == pytest.approx(before + 30.0, abs=2.0)
    finally:
        server.shutdown()


# ----------------------------------------------------- server stats surface


def test_server_stats_expose_admission_surface():
    from nomad_tpu_torch.server import Server, ServerConfig as SC

    server = Server(SC(num_schedulers=0))
    server.start()
    try:
        adm = server.stats()["admission"]
        assert adm["enabled"] is True
        assert adm["pressure"]["level"] == LEVEL_GREEN
        assert "write_bucket" in adm and "read_bucket" in adm
        # The port carries no device-path breaker.
        assert "breaker" not in adm
        broker_stats = server.stats()["broker"]
        assert broker_stats["shed"] == 0 and broker_stats["expired"] == 0
    finally:
        server.shutdown()
