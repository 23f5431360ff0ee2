"""Churn control plane, the part the generic scheduler reaches: the
bounded migration budget (:class:`MigrationGovernor`) and the
preemption-eligibility check.

A copy of ``nomad_tpu/migrate/__init__.py``'s MigrationGovernor
without the chaos gate. Preemption itself (the dense victim search) is
a later slice of the port.
"""

from __future__ import annotations

import threading
from typing import Dict

# Default in-flight migration budget (0 = unbounded).
DEFAULT_MAX_PARALLEL = 32

# Wait stamped on budget-deferred follow-up migration evals.
MIGRATE_RETRY_WAIT = 0.05


class MigrationGovernor:
    """Bounded migration parallelism, shared by every scheduling
    worker in the process."""

    def __init__(self, max_parallel: int = DEFAULT_MAX_PARALLEL):
        self._lock = threading.Lock()
        self.max_parallel = max_parallel  # guarded-by: _lock (0 = off)
        self.in_flight = 0  # guarded-by: _lock
        self.high_water = 0  # guarded-by: _lock
        self.granted_total = 0  # guarded-by: _lock
        self.deferred_total = 0  # guarded-by: _lock
        self.released_total = 0  # guarded-by: _lock

    def acquire(self, n: int) -> int:
        """Claim up to ``n`` migration slots; returns the grant (which
        may be 0 — the caller defers the remainder to a follow-up
        migration eval)."""
        if n <= 0:
            return 0
        with self._lock:
            if self.max_parallel <= 0:
                granted = n
            else:
                granted = max(0, min(n, self.max_parallel - self.in_flight))
            self.in_flight += granted
            self.high_water = max(self.high_water, self.in_flight)
            self.granted_total += granted
            self.deferred_total += n - granted
            return granted

    def release(self, n: int) -> None:
        """Return ``n`` slots (the claiming attempt's plan submit
        finished)."""
        if n <= 0:
            return
        with self._lock:
            self.in_flight = max(0, self.in_flight - n)
            self.released_total += n

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "max_parallel": self.max_parallel,
                "in_flight": self.in_flight,
                "high_water": self.high_water,
                "granted_total": self.granted_total,
                "deferred_total": self.deferred_total,
                "released_total": self.released_total,
            }


_governor = MigrationGovernor()


def get_governor() -> MigrationGovernor:
    return _governor


def preemption_eligible(eval_priority: int) -> bool:
    """Whether this eval may run the dense preemption pass. In the JAX
    package that takes preemption switched on, a pressure probe reading
    red, and an eval above the priority threshold; the port has no
    pressure probe yet (admission control is a later slice), so the
    answer is the JAX package's answer at green pressure: no."""
    return False
