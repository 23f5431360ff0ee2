"""The JAX package's tests/test_timetable_planqueue.py on the port (its
HTTP chunked-reply case waits for the port's HTTP API).

Direct unit tests for two previously indirectly-covered leader
components: TimeTable (nomad/timetable.go:30 — index<->time ring used
by GC thresholds) and PlanQueue (nomad/plan_queue.go:29 — priority heap
of pending-plan futures, leader-only). Plus the uuid fork-safety hook
and the chunked-streaming HTTP reply path at size."""

import torch_parity  # noqa: F401  (the port on the CPU)
import os
import threading
import time

import pytest

from nomad_tpu_torch.server.plan_queue import PlanQueue
from nomad_tpu_torch.server.timetable import TimeTable
from nomad_tpu_torch.structs import Plan, PlanResult


class TestTimeTable:
    def test_witness_and_nearest_index(self):
        tt = TimeTable(granularity=0.0)
        t0 = 1000.0
        for i, dt in ((10, 0.0), (20, 10.0), (30, 20.0)):
            tt.witness(i, t0 + dt)
        assert tt.nearest_index(t0 + 25.0) == 30
        assert tt.nearest_index(t0 + 15.0) == 20
        assert tt.nearest_index(t0 + 5.0) == 10
        assert tt.nearest_index(t0 - 1.0) == 0

    def test_nearest_time(self):
        tt = TimeTable(granularity=0.0)
        tt.witness(10, 1000.0)
        tt.witness(20, 1010.0)
        assert tt.nearest_time(25) == 1010.0
        assert tt.nearest_time(15) == 1000.0
        assert tt.nearest_time(5) == 0.0

    def test_granularity_coalesces(self):
        tt = TimeTable(granularity=5.0)
        tt.witness(1, 1000.0)
        tt.witness(2, 1001.0)  # within granularity: dropped
        tt.witness(3, 1006.0)
        assert tt.nearest_index(1001.0) == 1
        assert tt.nearest_index(1007.0) == 3

    def test_history_limit_trims(self):
        tt = TimeTable(granularity=0.0, limit=10)
        tt.witness(1, 1000.0)
        tt.witness(2, 1020.0)  # 1000.0 is now past the 10s window
        assert tt.nearest_index(1001.0) == 0


class TestPlanQueue:
    def make_plan(self, priority=50):
        plan = Plan()
        plan.priority = priority
        return plan

    def test_disabled_rejects_enqueue(self):
        q = PlanQueue()
        with pytest.raises(Exception):
            q.enqueue(self.make_plan())

    def test_priority_order(self):
        q = PlanQueue()
        q.set_enabled(True)
        lo = q.enqueue(self.make_plan(10))
        hi = q.enqueue(self.make_plan(90))
        assert q.depth() == 2
        first = q.dequeue(timeout=1.0)
        assert first.plan.priority == 90
        assert q.dequeue(timeout=1.0).plan.priority == 10

    def test_future_resolves_waiter(self):
        q = PlanQueue()
        q.set_enabled(True)
        pending = q.enqueue(self.make_plan())
        got = {}

        def waiter():
            got["result"] = pending.wait(timeout=5.0)

        t = threading.Thread(target=waiter)
        t.start()
        applier_side = q.dequeue(timeout=1.0)
        result = PlanResult()
        applier_side.respond(result, None)
        t.join(timeout=5.0)
        assert got["result"] is result

    def test_future_propagates_error(self):
        q = PlanQueue()
        q.set_enabled(True)
        pending = q.enqueue(self.make_plan())
        q.dequeue(timeout=1.0).respond(None, RuntimeError("boom"))
        with pytest.raises(RuntimeError, match="boom"):
            pending.wait(timeout=5.0)

    def test_disable_flushes(self):
        q = PlanQueue()
        q.set_enabled(True)
        pending = q.enqueue(self.make_plan())
        q.set_enabled(False)
        # The parked plan fails rather than hanging its worker forever.
        with pytest.raises(Exception):
            pending.wait(timeout=5.0)
        assert q.depth() == 0

    def test_dequeue_timeout_returns_none(self):
        q = PlanQueue()
        q.set_enabled(True)
        assert q.dequeue(timeout=0.05) is None


def test_generate_uuid_fork_safe():
    """A forked child must not replay the parent's buffered entropy
    (utils/ids.py register_at_fork hook)."""
    from nomad_tpu_torch.utils.ids import generate_uuid

    generate_uuid()  # warm the parent's batch buffer
    r, w = os.pipe()
    pid = os.fork()
    if pid == 0:  # child
        os.close(r)
        ids = ",".join(generate_uuid() for _ in range(8))
        os.write(w, ids.encode())
        os.close(w)
        os._exit(0)
    os.close(w)
    child_ids = os.read(r, 65536).decode().split(",")
    os.close(r)
    os.waitpid(pid, 0)
    parent_ids = [generate_uuid() for _ in range(8)]
    assert not (set(child_ids) & set(parent_ids)), "fork replayed entropy"


