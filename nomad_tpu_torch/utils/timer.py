"""Shared timer wheel: many logical timers on one firing thread.

The reference leans on Go's runtime timers, which are cheap (a heap
inside the scheduler, no thread per timer) and fire each callback on
its own goroutine. Python's threading.Timer spawns a whole OS thread
per timer — at hundreds of eval dequeues per second (one nack timer
each, eval_broker.go:365) plus one heartbeat TTL timer per node
(heartbeat.go:14, 10k+ nodes), that's untenable. This wheel gives the
Go cost model: schedule/cancel are O(log n) heap ops on one shared
firing thread.

Callback execution is decoupled from firing: the firing thread only
pops due handles and hands them to a small bounded WorkPool, so one
slow callback (a heartbeat expiry doing a raft apply during leader
loss) cannot delay every other timer in the process — Go's
run-on-own-goroutine property, at bounded thread cost. Known-slow
callbacks should still offload their heavy part to their own pool
(server/heartbeat.py) so a storm of them cannot occupy all dispatch
workers and head-of-line-block fast timers like broker nacks.

Cancellation is a flag check at fire time; a cancelled handle's entry
just drains out of the heap. Callbacks run outside the wheel lock, so
they may freely take subsystem locks (broker, heartbeat) that
themselves call schedule()/cancel().
"""

from __future__ import annotations

import heapq
import itertools
import logging
import threading
import time
from typing import Callable, List, Optional, Tuple

from .pool import WorkPool

logger = logging.getLogger("nomad_tpu_torch.timer")

DISPATCH_WORKERS = 4


class TimerHandle:
    """Cancelable scheduled callback (threading.Timer's cancel API)."""

    __slots__ = ("fn", "args", "cancelled")

    def __init__(self, fn: Callable, args: tuple):
        self.fn = fn
        self.args = args
        self.cancelled = False

    def cancel(self) -> None:
        self.cancelled = True


class TimerWheel:
    def __init__(self, name: str = "timer-wheel",
                 dispatch_workers: int = DISPATCH_WORKERS):
        self._name = name
        self._cond = threading.Condition()
        self._heap: List[Tuple[float, int, TimerHandle]] = []
        self._counter = itertools.count()
        self._thread: Optional[threading.Thread] = None
        self._pool = WorkPool(dispatch_workers, name=f"{name}-cb")

    def schedule(self, delay: float, fn: Callable, *args) -> TimerHandle:
        handle = TimerHandle(fn, args)
        deadline = time.monotonic() + max(delay, 0.0)
        with self._cond:
            heapq.heappush(self._heap, (deadline, next(self._counter), handle))
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._run, name=self._name, daemon=True
                )
                self._thread.start()
            # Wake the thread iff the new timer is now the earliest.
            if self._heap[0][2] is handle:
                self._cond.notify()
        return handle

    def _run(self) -> None:
        while True:
            with self._cond:
                while True:
                    now = time.monotonic()
                    # Drop cancelled entries at the front eagerly.
                    while self._heap and self._heap[0][2].cancelled:
                        heapq.heappop(self._heap)
                    if self._heap and self._heap[0][0] <= now:
                        _, _, handle = heapq.heappop(self._heap)
                        break
                    timeout = (
                        self._heap[0][0] - now if self._heap else 3600.0
                    )
                    self._cond.wait(timeout)
            if handle.cancelled:
                continue
            # Hand off: the firing thread never runs user code, so a
            # blocked callback cannot make other timers fire late.
            self._pool.submit(self._fire, handle)

    @staticmethod
    def _fire(handle: TimerHandle) -> None:
        if handle.cancelled:
            return
        try:
            handle.fn(*handle.args)
        except Exception:  # noqa: BLE001 - one bad timer can't kill the wheel
            logger.exception("timer callback failed")

    def pending(self) -> int:
        with self._cond:
            return sum(1 for _, _, h in self._heap if not h.cancelled)


_default: Optional[TimerWheel] = None
_default_lock = threading.Lock()


def default_wheel() -> TimerWheel:
    """Process-wide shared wheel (multiple in-process servers in tests
    share it; handles are independent)."""
    global _default
    with _default_lock:
        if _default is None:
            _default = TimerWheel()
        return _default
