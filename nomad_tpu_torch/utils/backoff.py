"""Jittered exponential backoff with per-attempt and overall deadlines.

The one retry/pacing primitive for the recovery paths: transport
redials, follower->leader forwarding, FSM catch-up polls in the
dispatch pipeline and workers, and the executor launch wait all ride
this instead of hand-rolled ``time.sleep`` loops (each of which had
its own cap, no jitter, and no shutdown check). Jitter matters at
fleet scale: a leader flap makes every follower retry at once, and
un-jittered exponential backoff keeps them synchronized into thundering
herds forever.

Defaults: base 20ms doubling to a 2s cap, ±25% jitter.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Callable, Optional

DEFAULT_BASE = 0.02
DEFAULT_FACTOR = 2.0
DEFAULT_MAX_DELAY = 2.0
DEFAULT_JITTER = 0.25


class Backoff:
    """Stateful backoff: each sleep() waits base*factor^n (capped at
    max_delay, ±jitter) and returns False once the overall deadline has
    passed, the attempt budget is spent, or `stop` is set — the
    caller's retry loop is `while bo.sleep(): ...`.

    Not thread-safe: one Backoff per retry loop (they are cheap)."""

    __slots__ = ("base", "factor", "max_delay", "jitter", "_deadline",
                 "_attempts_left", "_stop", "_rng", "_attempt")

    def __init__(self, base: float = DEFAULT_BASE,
                 factor: float = DEFAULT_FACTOR,
                 max_delay: float = DEFAULT_MAX_DELAY,
                 jitter: float = DEFAULT_JITTER,
                 deadline: Optional[float] = None,
                 attempts: Optional[int] = None,
                 stop: Optional[threading.Event] = None,
                 rng: Optional[random.Random] = None):
        self.base = base
        self.factor = factor
        self.max_delay = max_delay
        self.jitter = jitter
        self._deadline = (None if deadline is None
                          else time.monotonic() + deadline)
        self._attempts_left = attempts
        self._stop = stop
        self._rng = rng if rng is not None else random
        self._attempt = 0

    def reset(self) -> None:
        """Back to the base delay (a success in a long-lived loop)."""
        self._attempt = 0

    def expired(self) -> bool:
        if self._stop is not None and self._stop.is_set():
            return True
        if self._attempts_left is not None and self._attempts_left <= 0:
            return True
        return (self._deadline is not None
                and time.monotonic() >= self._deadline)

    def next_delay(self) -> float:
        """The next attempt's delay (advances the attempt counter)."""
        delay = min(self.base * (self.factor ** self._attempt),
                    self.max_delay)
        self._attempt += 1
        if self.jitter:
            delay *= 1.0 + self.jitter * (2.0 * self._rng.random() - 1.0)
        if self._deadline is not None:
            # Never sleep past the overall deadline; the final slice
            # still runs so the caller gets one last check at expiry.
            delay = min(delay, max(0.0, self._deadline - time.monotonic()))
        return max(delay, 0.0)

    def sleep(self) -> bool:
        """Sleep one backoff step. True = retry; False = give up
        (deadline hit, attempt budget spent, or stop set). Interrupted
        immediately when `stop` fires mid-sleep."""
        if self.expired():
            return False
        delay = self.next_delay()
        if self._attempts_left is not None:
            self._attempts_left -= 1
        if self._stop is not None:
            if self._stop.wait(delay):
                return False
        elif delay > 0:
            time.sleep(delay)
        # The deadline may have landed DURING the (deadline-clamped)
        # sleep: still grant the post-sleep retry — callers poll state
        # that can have become true while we slept, and the NEXT sleep()
        # reports expiry. Stop is the exception: shutdown wins now.
        return not (self._stop is not None and self._stop.is_set())


def sleep_jittered(delay: float, jitter: float = DEFAULT_JITTER,
                   rng: Optional[random.Random] = None) -> None:
    """One jittered sleep for fixed-interval retry loops that need no
    growth (a worker pacing its next dequeue attempt): ±jitter spreads
    a fleet's synchronized retries so a recovering leader is not hit by
    every follower on the same tick."""
    r = rng if rng is not None else random
    time.sleep(max(0.0, delay * (1.0 + jitter * (2.0 * r.random() - 1.0))))


def poll_until(predicate: Callable[[], bool], timeout: float,
               stop: Optional[threading.Event] = None,
               base: float = 0.001, factor: float = DEFAULT_FACTOR,
               max_delay: float = 0.1,
               jitter: float = DEFAULT_JITTER) -> bool:
    """Poll `predicate` under jittered backoff until it returns True or
    `timeout` elapses (or `stop` is set). Returns the final predicate
    verdict — including one last check at the deadline, so a condition
    that became true during the final sleep is not reported missed."""
    if predicate():
        return True
    bo = Backoff(base=base, factor=factor, max_delay=max_delay,
                 jitter=jitter, deadline=timeout, stop=stop)
    while bo.sleep():
        if predicate():
            return True
    if stop is not None and stop.is_set():
        return False
    return predicate()
