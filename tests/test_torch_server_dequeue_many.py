"""The JAX package's tests/test_dequeue_many.py on the port.

EvalBroker.dequeue_many tests: the drain-to-batch extension must
preserve every single-dequeue invariant — per-job serialization,
nack/redelivery with delivery limits, token checks — across a drained
batch (reference semantics: eval_broker.go:259 Dequeue, :461 Ack,
:520 Nack, :548 failed queue)."""

import torch_parity  # noqa: F401  (the port on the CPU)
import pytest

from nomad_tpu_torch.mock import eval as mock_eval
from nomad_tpu_torch.server.broker import FAILED_QUEUE, EvalBroker


def make_eval(job_id="job1", etype="service", priority=50):
    ev = mock_eval()
    ev.job_id = job_id
    ev.type = etype
    ev.priority = priority
    return ev


@pytest.fixture
def broker():
    b = EvalBroker(nack_timeout=60.0, delivery_limit=3)
    b.set_enabled(True)
    return b


def test_drains_up_to_max(broker):
    evs = [make_eval(job_id=f"j{i}") for i in range(6)]
    broker.enqueue_all(evs)
    got = broker.dequeue_many(["service"], 4)
    assert len(got) == 4
    assert broker.ready_count() == 2
    assert broker.unacked_count() == 4
    # Tokens are per-dequeue and distinct.
    assert len({t for _, t in got}) == 4


def test_empty_broker_returns_immediately(broker):
    assert broker.dequeue_many(["service"], 8) == []


def test_distinct_jobs_invariant(broker):
    """Two evals of one job never ride the same batch: the second waits
    in the per-job blocked heap until the first Acks (the per-job
    serialization that keeps concurrent schedulers from planning the
    same job twice, eval_broker.go:56-59)."""
    a1, a2 = make_eval(job_id="same"), make_eval(job_id="same")
    b1 = make_eval(job_id="other")
    broker.enqueue_all([a1, a2, b1])
    got = broker.dequeue_many(["service"], 8)
    assert {ev.job_id for ev, _ in got} == {"same", "other"}
    assert len(got) == 2
    assert broker.blocked_count() == 1
    # Ack the claimed eval: its sibling becomes ready.
    first = next((ev, t) for ev, t in got if ev.job_id == "same")
    broker.ack(first[0].id, first[1])
    follow = broker.dequeue_many(["service"], 8)
    assert [ev.id for ev, _ in follow] == [a2.id if first[0] is a1 else a1.id]


def test_priority_order_within_drain(broker):
    lo = make_eval(job_id="lo", priority=10)
    hi = make_eval(job_id="hi", priority=90)
    mid = make_eval(job_id="mid", priority=50)
    broker.enqueue_all([lo, hi, mid])
    got = broker.dequeue_many(["service"], 3)
    assert [ev.job_id for ev, _ in got] == ["hi", "mid", "lo"]


def test_scheduler_type_filter(broker):
    s = make_eval(job_id="s", etype="service")
    b = make_eval(job_id="b", etype="batch")
    broker.enqueue_all([s, b])
    got = broker.dequeue_many(["batch"], 8)
    assert [ev.id for ev, _ in got] == [b.id]
    assert broker.ready_count() == 1  # the service eval stays


def test_nack_of_batch_member_redelivers(broker):
    evs = [make_eval(job_id=f"j{i}") for i in range(3)]
    broker.enqueue_all(evs)
    got = broker.dequeue_many(["service"], 3)
    victim, token = got[1]
    broker.nack(victim.id, token)
    # Redelivered: dequeue again, same eval, NEW token.
    again = broker.dequeue_many(["service"], 3)
    assert len(again) == 1
    assert again[0][0].id == victim.id
    assert again[0][1] != token
    # Stale token from the first delivery is rejected everywhere.
    with pytest.raises(ValueError):
        broker.ack(victim.id, token)
    with pytest.raises(ValueError):
        broker.nack(victim.id, token)


def test_delivery_limit_routes_to_failed_queue(broker):
    ev = make_eval(job_id="poison")
    broker.enqueue(ev)
    for _ in range(broker.delivery_limit):
        got = broker.dequeue_many(["service"], 1)
        assert got and got[0][0].id == ev.id
        broker.nack(ev.id, got[0][1])
    # Past the limit: parked on _failed, not redelivered to `service`.
    assert broker.dequeue_many(["service"], 1) == []
    assert [e.id for e in broker.failed_evals()] == [ev.id]
    # The failed queue is still dequeueable (the leader's reaper
    # creates new evals from it, leader.go:369).
    got = broker.dequeue_many([FAILED_QUEUE], 1)
    assert got and got[0][0].id == ev.id


def test_mixed_dequeue_and_dequeue_many_tokens(broker):
    """A single-dequeued eval and a drained batch coexist; acks with
    the right tokens drain everything."""
    evs = [make_eval(job_id=f"j{i}") for i in range(4)]
    broker.enqueue_all(evs)
    one, tok1 = broker.dequeue(["service"], timeout=1.0)
    rest = broker.dequeue_many(["service"], 8)
    assert one is not None and len(rest) == 3
    broker.ack(one.id, tok1)
    for ev, t in rest:
        broker.ack(ev.id, t)
    assert broker.unacked_count() == 0
    assert broker.ready_count() == 0


def test_disabled_broker_drains_nothing(broker):
    broker.enqueue(make_eval())
    broker.set_enabled(False)
    assert broker.dequeue_many(["service"], 4) == []
