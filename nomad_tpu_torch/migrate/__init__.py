"""Churn control plane: bounded migration parallelism and the priority
preemption policy — the port of the JAX package's migrate/__init__.py.

- **Migration budget** (:class:`MigrationGovernor`): a process-global
  bound on how many displaced allocations may be in flight (claimed by
  a scheduling attempt, not yet committed or released) at once. Each
  eval claims up to the remaining budget, defers the rest to a
  follow-up ``migration`` eval, and releases its claim when its plan
  submit finishes.

- **Preemption policy**: the host-side half of the dense preemption
  pass (ops/preempt.py): eligibility (enabled, the pressure probe
  reading red, and the eval's priority above the threshold), the
  victim-selection oracle the kernel is judged against, and the
  staged/committed counters.

Both are process-global and lock-guarded; ``configure()`` sets the
knobs and never resets counters. The pressure probe is a callable the
caller sets (``configure(pressure_probe=...)``): with none, nothing
preempts. The JAX package's chaos gate for the migration leg is not
carried over.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional

# Default in-flight migration budget (ServerConfig.migrate_max_parallel
# overrides; 0 = unbounded). 32 keeps a 100-node drain storm to a few
# waves without letting it flood the plan queue.
DEFAULT_MAX_PARALLEL = 32

# Evals must outrank this to preempt (strictly greater). The default
# job priority is 50, so out of the box only above-normal-priority
# work may evict.
DEFAULT_PREEMPT_PRIORITY = 50

# Wait stamped on budget-deferred follow-up migration evals: long
# enough that the claiming wave's submits have freed slots by the time
# the broker re-delivers, short enough that a drain storm's tail wave
# is not operator-visible latency.
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

    def configure(self, max_parallel: Optional[int] = None) -> None:
        with self._lock:
            if max_parallel is not None:
                self.max_parallel = int(max_parallel)

    def acquire(self, n: int) -> int:
        """Claim up to ``n`` migration slots; returns the grant (which
        may be 0 — the caller defers the remainder to a follow-up
        migration eval). Unbounded (max_parallel <= 0) grants all of
        ``n`` but still tracks in-flight/high-water for observability."""
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

    def reset_stats(self) -> None:
        """Re-baseline the observability counters (high-water mark,
        grant/defer/release totals) WITHOUT touching in-flight claims —
        tests measure a window, and a lifetime max would
        smear earlier windows into it."""
        with self._lock:
            self.high_water = self.in_flight
            self.granted_total = 0
            self.deferred_total = 0
            self.released_total = 0

    def release(self, n: int) -> None:
        """Return ``n`` slots (the claiming attempt's plan submit
        finished — committed or failed; either way those migrations
        are no longer in flight at the scheduler)."""
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


class _PreemptPolicy:
    """Process-global preemption switchboard + counters."""

    def __init__(self):
        self._lock = threading.Lock()
        self.enabled = False  # guarded-by: _lock
        self.priority_threshold = DEFAULT_PREEMPT_PRIORITY  # guarded-by: _lock
        # Pressure probe: () -> "green"|"yellow"|"red", set by the
        # caller (the admission controller, once ported; tests).
        # None = no signal = never preempt (preemption is an overload
        # valve, not a default placement strategy).
        self.pressure_probe: Optional[Callable[[], str]] = None  # guarded-by: _lock
        self.evictions_staged = 0  # guarded-by: _lock
        self.evictions_committed = 0  # guarded-by: _lock
        self.placements = 0  # guarded-by: _lock

    def configure(self, enabled: Optional[bool] = None,
                  priority_threshold: Optional[int] = None,
                  pressure_probe: Optional[Callable[[], str]] = None) -> None:
        with self._lock:
            if enabled is not None:
                self.enabled = bool(enabled)
            if priority_threshold is not None:
                self.priority_threshold = int(priority_threshold)
            if pressure_probe is not None:
                self.pressure_probe = pressure_probe

    def eligible(self, eval_priority: int) -> bool:
        with self._lock:
            if not self.enabled:
                return False
            if eval_priority <= self.priority_threshold:
                return False
            probe = self.pressure_probe
        if probe is None:
            return False
        try:
            return probe() == "red"
        except Exception:  # noqa: BLE001 - a broken probe must not fail evals
            return False

    def note(self, staged: int = 0, committed: int = 0,
             placements: int = 0) -> None:
        with self._lock:
            self.evictions_staged += staged
            self.evictions_committed += committed
            self.placements += placements

    def stats(self) -> Dict[str, object]:
        with self._lock:
            return {
                "enabled": self.enabled,
                "priority_threshold": self.priority_threshold,
                "evictions_staged": self.evictions_staged,
                "evictions_committed": self.evictions_committed,
                "placements": self.placements,
            }


_governor = MigrationGovernor()
_policy = _PreemptPolicy()


def get_governor() -> MigrationGovernor:
    return _governor


def configure(migrate_max_parallel: Optional[int] = None,
              preemption_enabled: Optional[bool] = None,
              preempt_priority_threshold: Optional[int] = None,
              pressure_probe: Optional[Callable[[], str]] = None) -> None:
    """The configuration funnel: the last explicit value of each knob
    wins, counters survive."""
    _governor.configure(max_parallel=migrate_max_parallel)
    _policy.configure(enabled=preemption_enabled,
                      priority_threshold=preempt_priority_threshold,
                      pressure_probe=pressure_probe)


def preemption_eligible(eval_priority: int) -> bool:
    """Whether this eval may run the dense preemption pass: preemption
    is on, the pressure probe reads red, and the eval outranks the
    threshold. Checked AFTER normal placement failed
    — preemption is the last resort, never the first choice."""
    return _policy.eligible(eval_priority)


def note_preemption(staged: int, placements: int = 0) -> None:
    """Scheduler-side accounting: victims staged into a plan and the
    placements they enabled."""
    _policy.note(staged=staged, placements=placements)


def note_preemption_committed(n: int) -> None:
    """Plan-applier-side accounting: victims whose eviction actually
    committed."""
    if n > 0:
        _policy.note(committed=n)


def select_victims_host(allocs: List, needed, max_priority: int,
                        limit: Optional[int] = None) -> Optional[List]:
    """The CPU victim-selection oracle: lowest-priority-first prefix of
    a node's live allocations that frees at least ``needed`` (cpu, mem,
    disk, iops) — exactly what the dense pass's prefix-of-sorted-
    candidates selection computes on device. Returns the victim list,
    or None when even evicting every eligible alloc cannot free enough.
    Held against the kernel's victim choice by the tests and the chip
    smoke run."""
    eligible = sorted(
        (a for a in allocs
         if not a.terminal_status() and victim_priority(a) < max_priority),
        key=victim_sort_key)
    if limit is not None:
        eligible = eligible[:limit]
    freed = [0.0, 0.0, 0.0, 0.0]
    victims: List = []
    for a in eligible:
        if all(f >= n for f, n in zip(freed, needed)):
            break
        r = _alloc_res(a)
        for i in range(4):
            freed[i] += r[i]
        victims.append(a)
    if all(f >= n for f, n in zip(freed, needed)):
        return victims
    return None


def victim_priority(alloc) -> int:
    """An allocation's preemption rank: its job's priority (the stored
    alloc carries the job denormalized; a stripped copy defends with
    the default)."""
    return alloc.job.priority if alloc.job is not None else 50


def victim_sort_key(alloc):
    """Deterministic lowest-priority-first victim order (ties broken
    oldest-first then by id, so the dense tensor and the host oracle
    agree on the exact prefix)."""
    return (victim_priority(alloc), alloc.create_index, alloc.id)


def _alloc_res(alloc):
    tr = alloc.task_resources or {}
    cpu = mem = iops = 0.0
    disk = (alloc.shared_resources.disk_mb
            if alloc.shared_resources is not None else 0.0)
    for r in tr.values():
        cpu += r.cpu
        mem += r.memory_mb
        disk += r.disk_mb
        iops += r.iops
    return (cpu, mem, disk, iops)


def preempt_stats() -> Dict[str, object]:
    return _policy.stats()


def churn_stats() -> Dict[str, object]:
    """Migration budget and preemption counters in one place."""
    out: Dict[str, object] = {"migration": _governor.stats()}
    out["preemption"] = _policy.stats()
    return out


__all__ = [
    "DEFAULT_MAX_PARALLEL",
    "DEFAULT_PREEMPT_PRIORITY",
    "MIGRATE_RETRY_WAIT",
    "MigrationGovernor",
    "churn_stats",
    "configure",
    "get_governor",
    "note_preemption",
    "note_preemption_committed",
    "preempt_stats",
    "preemption_eligible",
    "select_victims_host",
    "victim_priority",
    "victim_sort_key",
]
