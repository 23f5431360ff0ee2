"""The JAX package's tests/test_broker.py on the port (its two fault-
injection cases are not carried: the port has no chaos module).

EvalBroker tests (mirror nomad/eval_broker_test.go scenarios)."""

import torch_parity  # noqa: F401  (the port on the CPU)
import time

import pytest

from nomad_tpu_torch import mock
from nomad_tpu_torch.server.broker import FAILED_QUEUE, EvalBroker


def make_eval(job_id=None, priority=50, type="service", wait=0.0):
    ev = mock.eval()
    ev.priority = priority
    ev.type = type
    ev.wait = wait
    if job_id:
        ev.job_id = job_id
    return ev


def test_enqueue_dequeue_ack():
    b = EvalBroker(nack_timeout=5.0)
    b.set_enabled(True)
    ev = make_eval()
    b.enqueue(ev)
    assert b.ready_count() == 1
    out, token = b.dequeue(["service"], timeout=0.1)
    assert out.id == ev.id and token
    assert b.unacked_count() == 1
    b.ack(ev.id, token)
    assert b.unacked_count() == 0
    assert b.ready_count() == 0


def test_dequeue_priority_order():
    b = EvalBroker()
    b.set_enabled(True)
    low = make_eval(priority=10)
    high = make_eval(priority=90)
    b.enqueue(low)
    b.enqueue(high)
    out, t = b.dequeue(["service"], timeout=0.1)
    assert out.id == high.id
    b.ack(out.id, t)


def test_dequeue_timeout_empty():
    b = EvalBroker()
    b.set_enabled(True)
    t0 = time.monotonic()
    out, token = b.dequeue(["service"], timeout=0.15)
    assert out is None and token == ""
    assert time.monotonic() - t0 >= 0.14


def test_dequeue_filters_scheduler_type():
    b = EvalBroker()
    b.set_enabled(True)
    b.enqueue(make_eval(type="batch"))
    out, _ = b.dequeue(["service"], timeout=0.1)
    assert out is None
    out, t = b.dequeue(["batch"], timeout=0.1)
    assert out is not None
    b.ack(out.id, t)


def test_per_job_serialization():
    b = EvalBroker()
    b.set_enabled(True)
    e1 = make_eval(job_id="job-1")
    e2 = make_eval(job_id="job-1")
    b.enqueue(e1)
    b.enqueue(e2)  # same job: must wait for e1's ack
    assert b.ready_count() == 1
    assert b.blocked_count() == 1
    out, token = b.dequeue(["service"], timeout=0.1)
    assert out.id == e1.id
    none, _ = b.dequeue(["service"], timeout=0.05)
    assert none is None
    b.ack(e1.id, token)
    out2, token2 = b.dequeue(["service"], timeout=0.1)
    assert out2.id == e2.id
    b.ack(e2.id, token2)


def test_nack_redelivers():
    b = EvalBroker()
    b.set_enabled(True)
    ev = make_eval()
    b.enqueue(ev)
    out, token = b.dequeue(["service"], timeout=0.1)
    b.nack(ev.id, token)
    out2, token2 = b.dequeue(["service"], timeout=0.1)
    assert out2.id == ev.id
    assert token2 != token
    b.ack(ev.id, token2)


def test_delivery_limit_routes_to_failed_queue():
    b = EvalBroker(delivery_limit=2)
    b.set_enabled(True)
    ev = make_eval()
    b.enqueue(ev)
    for _ in range(2):
        out, token = b.dequeue(["service"], timeout=0.1)
        assert out is not None
        b.nack(ev.id, token)
    assert [e.id for e in b.failed_evals()] == [ev.id]
    # failed evals are only dequeued by the failed queue consumers
    out, _ = b.dequeue(["service"], timeout=0.05)
    assert out is None
    out, t = b.dequeue([FAILED_QUEUE], timeout=0.05)
    assert out is not None
    b.ack(ev.id, t)


def test_nack_timeout_auto_redelivers():
    b = EvalBroker(nack_timeout=0.1)
    b.set_enabled(True)
    ev = make_eval()
    b.enqueue(ev)
    out, token = b.dequeue(["service"], timeout=0.1)
    time.sleep(0.25)  # let the nack timer fire
    out2, token2 = b.dequeue(["service"], timeout=0.5)
    assert out2.id == ev.id
    with pytest.raises(ValueError):
        b.ack(ev.id, token)  # old token no longer valid
    b.ack(ev.id, token2)


def test_pause_nack_timeout():
    b = EvalBroker(nack_timeout=0.15)
    b.set_enabled(True)
    ev = make_eval()
    b.enqueue(ev)
    out, token = b.dequeue(["service"], timeout=0.1)
    b.pause_nack_timeout(ev.id, token)
    time.sleep(0.3)  # timer would have fired
    assert b.outstanding(ev.id) == token  # still ours
    b.resume_nack_timeout(ev.id, token)
    b.ack(ev.id, token)


def test_wait_eval_delayed():
    b = EvalBroker()
    b.set_enabled(True)
    ev = make_eval(wait=0.15)
    b.enqueue(ev)
    assert b.waiting_count() == 1
    out, _ = b.dequeue(["service"], timeout=0.05)
    assert out is None
    out, t = b.dequeue(["service"], timeout=0.5)
    assert out is not None and out.id == ev.id
    b.ack(ev.id, t)


def test_disabled_broker_drops():
    b = EvalBroker()
    b.enqueue(make_eval())
    assert b.ready_count() == 0


def test_dedup_enqueue():
    b = EvalBroker()
    b.set_enabled(True)
    ev = make_eval()
    b.enqueue(ev)
    b.enqueue(ev)
    assert b.ready_count() == 1


# ---------------------------------------------------------------------
# dead-lettering: delivery-limit exhaustion is structured, not silent


def test_dead_letter_stamps_reason_and_counts():
    b = EvalBroker(delivery_limit=2)
    b.set_enabled(True)
    ev = make_eval()
    ev.triggered_by = "job-register"
    b.enqueue(ev)
    assert b.stats()["dead_lettered"] == 0
    for _ in range(2):
        out, token = b.dequeue(["service"], timeout=0.1)
        b.nack(out.id, token)
    dead = b.failed_evals()
    assert [e.id for e in dead] == [ev.id]
    # The parked copy carries a structured trigger + reason; the
    # original trigger survives inside the reason string.
    from nomad_tpu_torch.structs import consts

    assert dead[0].triggered_by == consts.EVAL_TRIGGER_DEAD_LETTER
    assert "delivery limit (2)" in dead[0].status_description
    assert "job-register" in dead[0].status_description
    assert b.stats()["dead_lettered"] == 1


def test_ack_after_dead_letter_rejected_cleanly():
    """A worker that was holding the eval when it dead-lettered (its
    nack timer fired) must get a clean ValueError from its late ack —
    not a silent success that would pull the eval off the failed
    queue."""
    b = EvalBroker(nack_timeout=0.1, delivery_limit=1)
    b.set_enabled(True)
    ev = make_eval()
    b.enqueue(ev)
    out, token = b.dequeue(["service"], timeout=0.1)
    assert out is not None
    # Let the nack timer fire: first delivery already exhausts the
    # limit of 1, so the timeout dead-letters it.
    deadline = time.monotonic() + 2.0
    while not b.failed_evals() and time.monotonic() < deadline:
        time.sleep(0.02)
    assert [e.id for e in b.failed_evals()] == [ev.id]
    with pytest.raises(ValueError):
        b.ack(ev.id, token)
    # Still parked for the reaper, reason intact.
    assert [e.id for e in b.failed_evals()] == [ev.id]
    assert b.stats()["dead_lettered"] == 1


# ---------------------------------------------------------------------
# bounded ready queues: priority-aware shedding (nomad_tpu_torch/admission)


def test_shed_at_cap_lowest_priority_newest_first():
    b = EvalBroker(ready_cap=2)
    b.set_enabled(True)
    keep_hi = make_eval(priority=90)
    keep_mid = make_eval(priority=50)
    b.enqueue(keep_hi)
    b.enqueue(keep_mid)
    # Equal-priority incoming is the NEWEST at the lowest priority:
    # it sheds itself; the older resident survives (FIFO fairness).
    incoming_same = make_eval(priority=50)
    b.enqueue(incoming_same)
    assert b.stats()["shed"] == 1
    assert [e.id for e in b.failed_evals()] == [incoming_same.id]
    # A strictly higher-priority incoming displaces the lowest
    # resident instead.
    incoming_high = make_eval(priority=70)
    b.enqueue(incoming_high)
    assert b.stats()["shed"] == 2
    shed_ids = {e.id for e in b.failed_evals()}
    assert keep_mid.id in shed_ids
    survivors = []
    while True:
        ev, t = b.dequeue(["service"], timeout=0.02)
        if ev is None:
            break
        survivors.append(ev.id)
        b.ack(ev.id, t)
    assert survivors == [keep_hi.id, incoming_high.id]


def test_shed_stamps_structured_outcome_exactly_once():
    from nomad_tpu_torch.structs import consts

    b = EvalBroker(ready_cap=1)
    b.set_enabled(True)
    ev = make_eval(priority=10)
    ev.triggered_by = "job-register"
    b.enqueue(ev)
    b.enqueue(make_eval(priority=90))  # displaces ev
    dead = b.failed_evals()
    assert [e.id for e in dead] == [ev.id]
    assert dead[0].triggered_by == consts.EVAL_TRIGGER_SHED
    assert "at capacity (1)" in dead[0].status_description
    assert "job-register" in dead[0].status_description
    assert b.stats()["shed"] == 1
    assert b.stats()["dead_lettered"] == 0


def test_shed_eval_never_also_dead_letters():
    """A shed eval's failed-queue copy can bounce through the nack
    path past the delivery limit (reaper flap) — it must re-park
    without a dead-letter restamp or a second count."""
    from nomad_tpu_torch.structs import consts

    b = EvalBroker(ready_cap=1, delivery_limit=1)
    b.set_enabled(True)
    victim = make_eval(priority=10)
    b.enqueue(victim)
    b.enqueue(make_eval(priority=90))
    assert b.stats()["shed"] == 1
    # Reaper dequeues the shed copy but its terminal write fails: nack.
    # Delivery 1 >= limit 1, so the dead-letter branch runs — and must
    # NOT restamp or count.
    for _ in range(3):
        ev, token = b.dequeue([FAILED_QUEUE], timeout=0.1)
        assert ev is not None and ev.id == victim.id
        assert ev.triggered_by == consts.EVAL_TRIGGER_SHED
        b.nack(ev.id, token)
    assert b.stats()["dead_lettered"] == 0
    assert b.stats()["shed"] == 1
    dead = b.failed_evals()
    assert [e.triggered_by for e in dead] == [consts.EVAL_TRIGGER_SHED]


def test_late_ack_nack_on_shed_eval_raises_cleanly():
    """An eval that redelivered, nacked back into a now-full queue and
    got shed is no longer outstanding: its old token must fail loudly,
    and the shed park must survive the attempt."""
    b = EvalBroker(ready_cap=1)
    b.set_enabled(True)
    ev = make_eval(priority=10)
    b.enqueue(ev)
    out, token = b.dequeue(["service"], timeout=0.1)
    assert out.id == ev.id
    # Queue fills with higher-priority work while ev is outstanding.
    b.enqueue(make_eval(priority=90))
    # The nack re-enqueue finds the queue full; ev (priority 10,
    # newest) sheds itself.
    b.nack(ev.id, token)
    assert b.stats()["shed"] == 1
    with pytest.raises(ValueError):
        b.ack(ev.id, token)
    with pytest.raises(ValueError):
        b.nack(ev.id, token)
    assert [e.id for e in b.failed_evals()] == [ev.id]


def test_enqueue_all_full_queue_sheds_strictly_lowest_priority_first():
    """Property test: across random priority mixes, the survivors of a
    capped enqueue_all are exactly the top-cap evals ordered by
    (priority desc, arrival asc) — shedding is strictly lowest-
    priority-first, newest-first within a priority."""
    import random as _random

    rng = _random.Random(1234)
    for trial in range(12):
        cap = rng.randint(1, 10)
        n = rng.randint(cap, cap * 3)
        prios = [rng.randint(1, 100) for _ in range(n)]
        b = EvalBroker(ready_cap=cap)
        b.set_enabled(True)
        evs = []
        for i, p in enumerate(prios):
            ev = make_eval(priority=p, job_id=f"t{trial}-j{i}")
            evs.append(ev)
        b.enqueue_all(evs)
        order = sorted(range(n), key=lambda i: (-prios[i], i))
        expect_keep = {evs[i].id for i in order[:cap]}
        kept = set()
        while True:
            ev, t = b.dequeue(["service"], timeout=0.01)
            if ev is None:
                break
            kept.add(ev.id)
            b.ack(ev.id, t)
        assert kept == expect_keep, (trial, cap, prios)
        assert {e.id for e in b.failed_evals()} == (
            {e.id for e in evs} - expect_keep)
        assert b.stats()["shed"] == n - cap


def test_per_type_ready_caps_override_default():
    b = EvalBroker(ready_cap=1, ready_caps={"batch": 3})
    b.set_enabled(True)
    for _ in range(3):
        b.enqueue(make_eval(type="batch"))
    for _ in range(3):
        b.enqueue(make_eval(type="service"))
    assert b.stats()["shed"] == 2  # service over its default cap of 1
    assert b.ready_count() == 4  # 3 batch + 1 service


def test_blocked_heap_bounded_by_cap_sheds_structured():
    """Re-registering ONE job at storm rate while its eval is
    outstanding must not grow the per-job blocked heap without bound
    (the ready cap never saw it): the blocked heap rides the same
    cap + lowest-priority-newest-first shed discipline, and the shed
    copy lands on the FAILED queue — not back in the blocked heap —
    even though the job claim belongs to a different eval."""
    from nomad_tpu_torch.structs import consts

    b = EvalBroker(ready_cap=2)
    b.set_enabled(True)
    first = make_eval(job_id="hot", priority=50)
    b.enqueue(first)
    out, token = b.dequeue(["service"], timeout=0.1)
    assert out.id == first.id
    # Storm the same job while `first` is outstanding: every one of
    # these lands in the blocked heap, past the ready-cap check.
    prios = [10, 90, 50, 20, 80]
    evs = [make_eval(job_id="hot", priority=p) for p in prios]
    for ev in evs:
        b.enqueue(ev)
    assert b.blocked_count() == 2  # bounded at the cap
    assert b.stats()["shed"] == 3  # 10, 20 (self), 50 displaced
    shed = b.failed_evals()
    assert sorted(e.priority for e in shed) == [10, 20, 50]
    assert all(e.triggered_by == consts.EVAL_TRIGGER_SHED for e in shed)
    assert all("blocked queue 'service'" in e.status_description
               for e in shed)
    # The survivors promote in priority order as acks release the claim.
    b.ack(first.id, token)
    out, t = b.dequeue(["service"], timeout=0.1)
    assert out.priority == 90
    b.ack(out.id, t)
    out, t = b.dequeue(["service"], timeout=0.1)
    assert out.priority == 80
    b.ack(out.id, t)
    assert b.blocked_count() == 0


def test_blocked_heap_unbounded_when_uncapped():
    b = EvalBroker(ready_cap=0)
    b.set_enabled(True)
    b.enqueue(make_eval(job_id="hot"))
    out, token = b.dequeue(["service"], timeout=0.1)
    for _ in range(10):
        b.enqueue(make_eval(job_id="hot"))
    assert b.blocked_count() == 10
    assert b.stats()["shed"] == 0
    b.ack(out.id, token)


# ---------------------------------------------------------------------
# deadlines: expired evals are parked at dequeue, never delivered


def test_expired_eval_skipped_at_dequeue_and_parked():
    from nomad_tpu_torch.structs import consts

    b = EvalBroker()
    b.set_enabled(True)
    stale = make_eval()
    stale.deadline = time.time() - 1.0
    live = make_eval()
    live.deadline = time.time() + 60.0
    b.enqueue(stale)
    b.enqueue(live)
    out, t = b.dequeue(["service"], timeout=0.1)
    assert out is not None and out.id == live.id
    b.ack(live.id, t)
    assert b.stats()["expired"] == 1
    dead = b.failed_evals()
    assert [e.id for e in dead] == [stale.id]
    assert dead[0].triggered_by == consts.EVAL_TRIGGER_EXPIRED
    assert "deadline expired" in dead[0].status_description
