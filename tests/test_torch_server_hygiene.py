"""The JAX package's tests/test_leader_hygiene.py on the port.

Leader eval-hygiene loops (leader.go:369 reapFailedEvaluations,
:407 reapDupBlockedEvaluations, :441 periodicUnblockFailedEvals):
delivery-limit evals end failed, duplicate blocked evals get cancelled,
and max-plan-failure evals are periodically released to run again."""

import torch_parity  # noqa: F401  (the port on the CPU)
import time

import pytest

from nomad_tpu_torch import mock
from nomad_tpu_torch.server import Server, ServerConfig
from nomad_tpu_torch.structs import consts


def wait_until(fn, timeout=5.0, interval=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if fn():
            return True
        time.sleep(interval)
    return False


@pytest.fixture
def server():
    # No workers: the tests drive the broker by hand so a scheduler
    # can't race the janitors for the evals under test.
    cfg = ServerConfig(
        num_schedulers=0,
        eval_delivery_limit=2,
        eval_nack_timeout=30.0,
        failed_eval_unblock_interval=0.3,
    )
    s = Server(cfg)
    s.start()
    yield s
    s.shutdown()


def test_delivery_limit_eval_reaped_as_failed(server):
    ev = mock.eval()
    server.eval_update([ev])
    assert wait_until(lambda: server.broker.ready_count() == 1)

    # Exhaust the delivery limit by hand (a crashing scheduler).
    for _ in range(server.config.eval_delivery_limit):
        got, token = server.broker.dequeue([ev.type], timeout=2.0)
        assert got is not None and got.id == ev.id
        server.broker.nack(got.id, token)
    # Either still parked in the broker's failed queue, or the reap
    # loop already won the race and pulled it (that loop IS the thing
    # under test — it can fire between the last nack and this line).
    assert wait_until(
        lambda: [e.id for e in server.broker.failed_evals()] == [ev.id]
        or ((e2 := server.fsm.state.eval_by_id(ev.id)) is not None
            and e2.status == consts.EVAL_STATUS_FAILED))

    # The reap loop marks it failed through raft and acks it out.
    assert wait_until(
        lambda: (e := server.fsm.state.eval_by_id(ev.id)) is not None
        and e.status == consts.EVAL_STATUS_FAILED
    )
    assert wait_until(lambda: not server.broker.failed_evals())
    stored = server.fsm.state.eval_by_id(ev.id)
    assert "delivery limit" in stored.status_description


def test_duplicate_blocked_eval_cancelled(server):
    ev1 = mock.eval()
    ev1.status = consts.EVAL_STATUS_BLOCKED
    server.eval_update([ev1])
    assert wait_until(
        lambda: server.blocked_evals.stats()["total_blocked"] == 1)

    # A second blocked eval for the SAME job displaces into the
    # duplicate list; the janitor cancels it through raft.
    ev2 = mock.eval()
    ev2.job_id = ev1.job_id
    ev2.status = consts.EVAL_STATUS_BLOCKED
    server.eval_update([ev2])
    assert wait_until(
        lambda: (e := server.fsm.state.eval_by_id(ev2.id)) is not None
        and e.status == consts.EVAL_STATUS_CANCELLED
    )
    # The original blocked eval is untouched.
    assert (server.fsm.state.eval_by_id(ev1.id).status
            == consts.EVAL_STATUS_BLOCKED)
    assert server.blocked_evals.stats()["total_blocked"] == 1


def test_failed_then_unblocked_eval_reschedules(server):
    """An eval blocked by max-plan failures is released back to the
    ready queue on the periodic unblock tick."""
    ev = mock.eval()
    ev.status = consts.EVAL_STATUS_BLOCKED
    ev.triggered_by = consts.EVAL_TRIGGER_MAX_PLANS
    server.eval_update([ev])
    assert wait_until(
        lambda: server.blocked_evals.stats()["total_blocked"] == 1)
    # With failed_eval_unblock_interval=0.3 the next tick re-enqueues.
    assert wait_until(lambda: server.broker.ready_count() == 1, timeout=3.0)
    assert server.blocked_evals.stats()["total_blocked"] == 0
    got, token = server.broker.dequeue([ev.type], timeout=2.0)
    assert got is not None and got.id == ev.id
    server.broker.nack(got.id, token)


def test_shutdown_ends_the_servers_pool_threads():
    """A storm through the dispatch pipeline and the read mux, then
    shutdown: none of the server's pool threads outlives it (the
    eval-batch pool alone grows to a batch's evals)."""
    import threading

    from nomad_tpu_torch.api import Client, HTTPServer

    prefixes = ("eval-batch", "executive", "read-serve", "plan-eval",
                "plan-commit", "raft-membership", "hb-invalidate")

    before = set(threading.enumerate())

    def pool_threads():
        return [t.name for t in threading.enumerate()
                if t.name.startswith(prefixes) and t not in before]

    server = Server(ServerConfig(
        num_schedulers=2, scheduler_factories={"service": "service-gpu"},
        eval_batch_size=8))
    server.start()
    http = HTTPServer(server)
    http.start()
    try:
        for _ in range(4):
            node = mock.node()
            node.compute_class()
            server.node_register(node)
        for w in server.workers:
            w.set_pause(True)
        assert wait_until(lambda: all(w.parked() for w in server.workers))
        evs = [server.job_register(mock.job())[0] for _ in range(6)]
        client = Client(http.addr, timeout=10.0)
        _ev, index = client.evaluations.info(evs[-1])
        for w in server.workers:
            w.set_pause(False)
        client.evaluations.info(evs[-1], index=index, wait=10.0)
        assert wait_until(lambda: all(
            server.fsm.state.eval_by_id(e).status
            == consts.EVAL_STATUS_COMPLETE for e in evs), 30.0)
        assert pool_threads()
    finally:
        http.stop()
        server.shutdown()
    assert wait_until(lambda: not pool_threads()), pool_threads()
