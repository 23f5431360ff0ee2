"""The JAX package's tests/test_blocked_evals.py on the port.

BlockedEvals unit tests (mirror nomad/blocked_evals_test.go): the
computed-class capture/escape split, the missed-unblock index race,
one-blocked-eval-per-job with duplicate collection, and failed-eval
unblocking — the subtle protocol invariants SURVEY.md §5 calls out."""

import torch_parity  # noqa: F401  (the port on the CPU)
from nomad_tpu_torch import mock
from nomad_tpu_torch.server.blocked import BlockedEvals
from nomad_tpu_torch.structs import consts


def make_blocked(job_id="job1", classes=None, escaped=False,
                 snapshot_index=10):
    ev = mock.eval()
    ev.job_id = job_id
    ev.status = consts.EVAL_STATUS_BLOCKED
    ev.class_eligibility = dict(classes or {})
    ev.escaped_computed_class = escaped
    ev.snapshot_index = snapshot_index
    return ev


def build():
    released = []
    blocked = BlockedEvals(lambda evs: released.extend(evs))
    blocked.set_enabled(True)
    return blocked, released


def test_block_and_unblock_eligible_class():
    blocked, released = build()
    ev = make_blocked(classes={"c1": True})
    blocked.block(ev)
    assert blocked.stats()["total_blocked"] == 1

    blocked.unblock("c1", index=20)
    assert released == [ev]
    assert blocked.stats()["total_blocked"] == 0


def test_unblock_ineligible_class_keeps_eval_blocked():
    """An eval that already proved class c1 infeasible must NOT wake
    for capacity on c1 (blocked_evals_test.go ineligible case)."""
    blocked, released = build()
    ev = make_blocked(classes={"c1": False})
    blocked.block(ev)
    blocked.unblock("c1", index=20)
    assert released == []
    assert blocked.stats()["total_blocked"] == 1


def test_unblock_unknown_class_releases():
    """Capacity on a class the eval never evaluated could fit it —
    release (the reference treats unknown classes as potential fits)."""
    blocked, released = build()
    ev = make_blocked(classes={"c1": False})
    blocked.block(ev)
    blocked.unblock("c-new", index=20)
    assert released == [ev]


def test_escaped_eval_unblocks_on_any_class():
    """An eval whose constraints reference unique.* attributes escaped
    class memoization: any capacity change wakes it."""
    blocked, released = build()
    ev = make_blocked(classes={"c1": False}, escaped=True)
    blocked.block(ev)
    blocked.unblock("c1", index=20)
    assert released == [ev]


def test_missed_unblock_race_immediately_requeues():
    """Capacity arrived between the scheduler's snapshot and Block():
    the eval is re-enqueued instead of sleeping forever
    (blocked_evals.go:214 missedUnblock)."""
    blocked, released = build()
    blocked.unblock("c1", index=50)  # capacity at index 50, nobody blocked
    ev = make_blocked(classes={"c1": True}, snapshot_index=40)
    blocked.block(ev)  # snapshot predates the unblock
    assert released == [ev]
    assert blocked.stats()["total_blocked"] == 0


def test_no_missed_unblock_when_snapshot_is_newer():
    blocked, released = build()
    blocked.unblock("c1", index=50)
    ev = make_blocked(classes={"c1": True}, snapshot_index=60)
    blocked.block(ev)  # snapshot already saw that capacity: stay blocked
    assert released == []
    assert blocked.stats()["total_blocked"] == 1


def test_one_blocked_eval_per_job_collects_duplicates():
    """A second blocked eval for the same job replaces the first; the
    displaced one surfaces via get_duplicates for the leader to cancel
    (blocked_evals.go jobs/duplicates + leader.go reapDupBlocked)."""
    blocked, released = build()
    first = make_blocked(job_id="j1", classes={"c1": True})
    second = make_blocked(job_id="j1", classes={"c1": True})
    blocked.block(first)
    blocked.block(second)
    assert blocked.stats()["total_blocked"] == 1
    dups = blocked.get_duplicates()
    assert len(dups) == 1
    # one of the two was displaced; the survivor is still tracked
    assert dups[0].id in {first.id, second.id}
    blocked.unblock("c1", index=20)
    assert len(released) == 1


def test_unblock_failed_leaves_capacity_blocked_evals():
    """periodicUnblockFailedEvals (leader.go:441) retries only
    delivery-failure evals; a capacity-blocked eval stays put."""
    blocked, released = build()
    ev = make_blocked(classes={"c1": False})
    blocked.block(ev)
    blocked.unblock_failed()
    assert released == []
    assert blocked.stats()["total_blocked"] == 1


def test_untrack_on_job_update():
    """A job update invalidates its blocked eval (untrack on job
    registration, fsm wiring)."""
    blocked, released = build()
    ev = make_blocked(job_id="j1", classes={"c1": True})
    blocked.block(ev)
    blocked.untrack("j1")
    blocked.unblock("c1", index=20)
    assert released == []


def test_disabled_flushes_state():
    blocked, released = build()
    blocked.block(make_blocked(classes={"c1": True}))
    blocked.set_enabled(False)
    assert blocked.stats()["total_blocked"] == 0
    blocked.unblock("c1", index=20)
    assert released == []
