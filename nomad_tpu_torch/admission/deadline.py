"""Deadline derivation for evaluations.

An eval's deadline is stamped once, at creation time (the server's
eval_update funnel — every fresh pending eval passes through it before
the FSM commit that enqueues it), as an absolute wall-clock instant::

    deadline = now + ttl * priority_factor(priority)

The factor scales the configured base TTL by priority so that under
sustained overload the work that survives queueing longest is the work
the operator ranked highest: priority 50 (the default) gets exactly
the base TTL, priority 100 gets 1.5x, priority 1 about 0.5x, and core
jobs (priority 200) 2.5x. The floor keeps a pathological priority from
producing an already-expired stamp.

Consumers:

- the broker skips expired evals at dequeue (stamping
  ``EVAL_TRIGGER_EXPIRED`` onto the failed-queue copy, exactly once);
- the dispatch pipeline drops expired evals at batch launch, BEFORE
  any matrix build, so stale work never burns a device lane.

Wall clock (``time.time``), not monotonic: deadlines replicate through
raft to followers whose monotonic clocks share no epoch.
"""

from __future__ import annotations

import time
from typing import Optional

from ..structs import consts

_FACTOR_FLOOR = 0.25


def priority_factor(priority: int) -> float:
    """0.25..2.5 multiplier on the base TTL (1.0 at default priority).
    Linear in priority: factor = 0.5 + priority/100."""
    return max(_FACTOR_FLOOR, 0.5 + priority / 100.0)


def deadline_for(priority: int, ttl: float,
                 now: Optional[float] = None) -> float:
    """Absolute wall-clock deadline for a fresh eval; 0.0 when
    deadlines are disabled (ttl <= 0)."""
    if ttl <= 0:
        return 0.0
    if now is None:
        now = time.time()
    return now + ttl * priority_factor(priority)


def stamp(ev, ttl: float, now: Optional[float] = None) -> None:
    """Stamp `ev` if it is a fresh pending/blocked eval without a
    deadline. Terminal or already-stamped evals pass through untouched
    (status updates re-commit existing evals through the same
    funnel)."""
    if ttl <= 0 or ev.deadline:
        return
    if ev.status not in (consts.EVAL_STATUS_PENDING,
                         consts.EVAL_STATUS_BLOCKED):
        return
    ev.deadline = deadline_for(ev.priority, ttl, now)
