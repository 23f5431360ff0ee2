"""Device-resident cluster-state tracking.

The dense path's authoritative ``[N, R]`` node matrix lives ON DEVICE
(scheduler/batcher.py's base cache); ``models/matrix.py``'s cached
``_ClusterBase`` is its host-side mirror. This module is the control
plane for that residency:

- **generation accounting** — every base is keyed by the raft
  watermarks it was built from (``nodes`` index, ``allocs`` index); a
  newer snapshot derives the next generation by a DELTA (recompute the
  touched rows, scatter them on device) instead of a full rebuild +
  re-upload. Plan commits advance the allocs axis
  (``_ClusterBase.delta_update``); node up/down/drain transitions
  advance the nodes axis and ride the SAME row scatter — the node
  stays in the matrix with ``node_ok`` masked instead of forcing a
  rebuild of the node axis (the matrix is built over the full
  datacenter *universe*, not the ready subset, exactly so readiness
  is row state rather than matrix shape).
- **rebuild policy** — thresholds for when a delta stops being worth
  it (too many touched rows) or stops being *possible* (alloc
  deletions, node registrations, capacity edits), with counters that
  tell the two cases apart.
- **staleness safety net** — the plan applier re-verifies every node
  exactly (server/plan_apply.py); a rejected plan means *some* state
  the scheduler planned against was wrong, so ``note_rejection()``
  marks the resident state suspect and the next build pays one full
  rebuild (``stale_rebuilds``) instead of trusting a possibly-bad
  delta chain. A wrong placement therefore costs one retry, never a
  committed double-book — the carve-over of the reference's
  plan_apply.go:318 exactness.

Everything here is process-global (like the batcher's device cache it
fronts) and lock-guarded; counters are exposed via
``server.stats()["device_state"]`` and ``/v1/metrics``.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

# Default max refilled rows before a full rebuild is the better deal;
# mirrors the historical inline policy in _ClusterBase.delta_update.
AUTO_REBUILD_ROWS = 0  # 0 = max(64, n_real // 4)


class ResidentStateTracker:
    """Counters + policy for the device-resident node matrix."""

    def __init__(self):
        self._lock = threading.Lock()
        self.enabled = True  # guarded-by: _lock (universe + node deltas)
        self.rebuild_rows = AUTO_REBUILD_ROWS  # guarded-by: _lock
        # Build-mode counters. full_rebuilds counts every from-scratch
        # _ClusterBase on the cacheable path; the *_reason counters
        # attribute why the delta path was skipped.
        self.full_rebuilds = 0  # guarded-by: _lock
        self.delta_updates = 0  # guarded-by: _lock (alloc-axis rows)
        self.node_delta_updates = 0  # guarded-by: _lock (node-axis rows)
        # Cumulative recomputed-row counts per axis: delta SIZE, not
        # count — a climbing rows/update ratio says deltas are drifting
        # toward the rebuild threshold.
        self.alloc_delta_rows = 0  # guarded-by: _lock
        self.node_delta_rows = 0  # guarded-by: _lock
        self.stale_rebuilds = 0  # guarded-by: _lock (post-rejection)
        self.universe_rebuilds = 0  # guarded-by: _lock (node set changed)
        # Plan-apply rejection marked the resident chain suspect; the
        # next cacheable build consumes this and rebuilds from scratch.
        self._stale = False  # guarded-by: _lock

    # ------------------------------------------------------------ policy

    def configure(self, enabled: Optional[bool] = None,
                  rebuild_rows: Optional[int] = None) -> None:
        with self._lock:
            if enabled is not None:
                self.enabled = bool(enabled)
            if rebuild_rows is not None:
                self.rebuild_rows = int(rebuild_rows)

    def is_enabled(self) -> bool:
        with self._lock:
            return self.enabled

    def max_refill_rows(self, n_real: int) -> int:
        with self._lock:
            limit = self.rebuild_rows
        return limit if limit > 0 else max(64, n_real // 4)

    # --------------------------------------------------------- staleness

    def note_rejection(self) -> None:
        """The plan applier rejected a plan: whatever matrix the
        scheduler planned against disagreed with the store. Mark the
        resident chain suspect — one full rebuild re-anchors it. Cheap
        and idempotent; called from the applier's rejection path."""
        with self._lock:
            self._stale = True

    def consume_stale(self) -> bool:
        """True exactly once per note_rejection burst: the caller must
        full-rebuild (and gets counted in stale_rebuilds)."""
        with self._lock:
            if not self._stale:
                return False
            self._stale = False
            self.stale_rebuilds += 1
            return True

    # ---------------------------------------------------------- counters

    def count_full(self) -> None:
        with self._lock:
            self.full_rebuilds += 1

    def count_universe(self) -> None:
        with self._lock:
            self.universe_rebuilds += 1

    def count_delta(self, alloc_rows: int, node_rows: int) -> None:
        with self._lock:
            self.delta_updates += 1
            self.alloc_delta_rows += alloc_rows
            if node_rows:
                self.node_delta_updates += 1
                self.node_delta_rows += node_rows

    def stats(self) -> Dict[str, object]:
        with self._lock:
            return {
                "enabled": self.enabled,
                "full_rebuilds": self.full_rebuilds,
                "delta_updates": self.delta_updates,
                "node_delta_updates": self.node_delta_updates,
                "alloc_delta_rows": self.alloc_delta_rows,
                "node_delta_rows": self.node_delta_rows,
                "stale_rebuilds": self.stale_rebuilds,
                "universe_rebuilds": self.universe_rebuilds,
            }


_tracker = ResidentStateTracker()


def get_tracker() -> ResidentStateTracker:
    return _tracker


def configure(enabled: Optional[bool] = None,
              rebuild_rows: Optional[int] = None) -> None:
    _tracker.configure(enabled=enabled, rebuild_rows=rebuild_rows)


def note_rejection() -> None:
    _tracker.note_rejection()


def device_state_stats() -> Dict[str, object]:
    """Resident-chain counters plus the batcher's upload/delta
    tallies."""
    from ..scheduler.batcher import get_batcher

    out = _tracker.stats()
    b = get_batcher().stats()
    out["base_uploads"] = b["base_uploads"]
    out["base_delta_updates"] = b["base_delta_updates"]
    out["upload_bytes"] = b["upload_bytes"]
    return out
