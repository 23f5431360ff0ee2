"""PlanQueue: leader-only priority queue of pending plans.

Reference: nomad/plan_queue.go:29 — plans are futures: the worker blocks
on the result while the single plan applier serializes commits.
"""

from __future__ import annotations

import heapq
import itertools
import threading
import time
from typing import List, Optional, Tuple

from ..structs import Plan, PlanResult


class PendingPlan:
    """A queued plan and its response future."""

    __slots__ = ("plan", "enqueue_time", "_event", "_result", "_error")

    def __init__(self, plan: Plan):
        self.plan = plan
        self.enqueue_time = time.monotonic()
        self._event = threading.Event()
        self._result: Optional[PlanResult] = None
        self._error: Optional[Exception] = None

    def respond(self, result: Optional[PlanResult], error: Optional[Exception]) -> None:
        self._result = result
        self._error = error
        self._event.set()

    def wait(self, timeout: Optional[float] = None) -> PlanResult:
        if not self._event.wait(timeout):
            raise TimeoutError("plan apply timed out")
        if self._error is not None:
            raise self._error
        return self._result


class PlanQueue:
    def __init__(self):
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._enabled = False
        self._heap: List[Tuple[int, int, PendingPlan]] = []
        self._counter = itertools.count()

    def set_enabled(self, enabled: bool) -> None:
        with self._lock:
            self._enabled = enabled
            if not enabled:
                for _, _, pending in self._heap:
                    pending.respond(None, RuntimeError("plan queue disabled"))
                self._heap = []
            self._cond.notify_all()

    def enabled(self) -> bool:
        with self._lock:
            return self._enabled

    def enqueue(self, plan: Plan) -> PendingPlan:
        with self._lock:
            if not self._enabled:
                raise RuntimeError("plan queue is disabled")
            pending = PendingPlan(plan)
            heapq.heappush(
                self._heap, (-plan.priority, next(self._counter), pending)
            )
            self._cond.notify()
            return pending

    def dequeue(self, timeout: Optional[float] = None) -> Optional[PendingPlan]:
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._lock:
            while True:
                if not self._enabled:
                    return None
                if self._heap:
                    return heapq.heappop(self._heap)[2]
                remaining = None
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return None
                self._cond.wait(remaining if remaining is not None else 1.0)

    def depth(self) -> int:
        with self._lock:
            return len(self._heap)
