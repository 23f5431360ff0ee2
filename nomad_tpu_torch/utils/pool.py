"""Bounded daemon-thread work pool.

The reference's concurrency units are goroutines — cheap enough that a
timer callback, a drained eval, or a migration fetch each gets its own
(heartbeat.go:84 expiries, worker.go:101 eval loops). Python threads
are OS threads; spawning one per event makes storm behavior (10k node
TTLs expiring, 16-eval drain batches on every broker visit) an
allocation storm of its own and hides leaks. This pool gives a fixed
ceiling: up to `size` lazily-spawned daemon workers drain a shared
queue; submit() never blocks and returns a waitable future.

Unlike concurrent.futures.ThreadPoolExecutor, workers are daemon
threads and nothing registers atexit joins — a wedged callback can
never hang interpreter shutdown (the wheel and the schedulers submit
callbacks that may block on raft applies during leader loss).
"""

from __future__ import annotations

import logging
import queue
import threading
from typing import Callable, List, Optional

logger = logging.getLogger("nomad_tpu_torch.pool")


class PoolFuture:
    """Minimal waitable result: done event + value-or-exception."""

    __slots__ = ("_event", "_result", "_error")

    def __init__(self):
        self._event = threading.Event()
        self._result = None
        self._error: Optional[BaseException] = None

    def done(self) -> bool:
        return self._event.is_set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._event.wait(timeout)

    def result(self, timeout: Optional[float] = None):
        if not self._event.wait(timeout):
            raise TimeoutError("pool future not done")
        if self._error is not None:
            raise self._error
        return self._result


class WorkPool:
    """Fixed-ceiling daemon-thread pool. Threads spawn on demand up to
    `size` and then persist, blocking on the queue when idle."""

    def __init__(self, size: int, name: str = "workpool"):
        self.size = max(1, size)
        self.name = name
        self._queue: "queue.SimpleQueue" = queue.SimpleQueue()
        self._lock = threading.Lock()
        self._threads: List[threading.Thread] = []
        self._idle = 0  # workers currently blocked on the queue

    def submit(self, fn: Callable, *args) -> PoolFuture:
        fut = PoolFuture()
        self._queue.put((fn, args, fut))
        with self._lock:
            # Spawn when queued work exceeds idle capacity (not just
            # idle==0: a worker between get() and its idle decrement
            # would otherwise suppress a needed spawn and strand this
            # item behind a long-blocking task). Erring toward spawning
            # is safe — the ceiling bounds it.
            self._threads = [t for t in self._threads if t.is_alive()]
            if self._queue.qsize() > self._idle and len(self._threads) < self.size:
                # Thread.start can fail under OS thread pressure —
                # AFTER the item was enqueued. Raising would hand
                # callers an item that is both "failed" and still due
                # to run (double accounting in callers' in-flight
                # tracking); running it inline would block submitters
                # that must never block (the dispatch pipeline hands
                # off EXACTLY to avoid that). So: retry once for
                # transient pressure, else leave the item queued —
                # qsize() reports it honestly, live workers drain it,
                # and EVERY future submit re-fires this spawn trigger.
                for attempt in (0, 1):
                    t = threading.Thread(
                        target=self._work,
                        name=f"{self.name}-{len(self._threads)}",
                        daemon=True)
                    try:
                        t.start()
                    except RuntimeError:
                        if attempt:
                            logger.warning(
                                "%s: worker spawn failed twice "
                                "(%d live, %d queued); queued work "
                                "waits for the next submit's retry",
                                self.name, len(self._threads),
                                self._queue.qsize(), exc_info=True)
                    else:
                        # Appended only on success: a never-started
                        # Thread would count toward the size ceiling
                        # until the next is_alive() prune.
                        self._threads.append(t)
                        break
        return fut

    def _work(self) -> None:
        while True:
            with self._lock:
                self._idle += 1
            try:
                item = self._queue.get()
            finally:
                with self._lock:
                    self._idle -= 1
            fn, args, fut = item
            try:
                fut._result = fn(*args)
            except BaseException as e:  # noqa: BLE001 - delivered via future
                fut._error = e
                logger.debug("pool task failed", exc_info=True)
            finally:
                fut._event.set()

    def queued(self) -> int:
        return self._queue.qsize()

    def worker_count(self) -> int:
        with self._lock:
            return sum(1 for t in self._threads if t.is_alive())
