"""BlockedEvals: evals waiting for cluster capacity changes.

Reference: nomad/blocked_evals.go:24 — captured evals indexed by
computed-class eligibility, escaped evals re-run on any change, one
blocked eval per job with duplicate cancellation, and the
missed-unblock index check that closes the race between a capacity
change landing and the blocked eval being registered.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional

from ..structs import Evaluation, consts


class BlockedEvals:
    def __init__(self, enqueue_fn: Callable[[List[Evaluation]], None]):
        self._lock = threading.RLock()
        self._enabled = False
        self._enqueue = enqueue_fn  # broker enqueue_all

        self._captured: Dict[str, Evaluation] = {}  # class-limited evals
        self._escaped: Dict[str, Evaluation] = {}  # escaped computed class
        self._jobs: Dict[str, str] = {}  # job_id -> blocked eval id
        self._duplicates: List[Evaluation] = []
        # class -> latest index at which that class saw new capacity
        self._unblock_indexes: Dict[str, int] = {}

    # ------------------------------------------------------------------

    def set_enabled(self, enabled: bool) -> None:
        with self._lock:
            self._enabled = enabled
        if not enabled:
            self.flush()

    def flush(self) -> None:
        with self._lock:
            self._captured.clear()
            self._escaped.clear()
            self._jobs.clear()
            self._duplicates.clear()
            self._unblock_indexes.clear()

    # ------------------------------------------------------------------

    def block(self, ev: Evaluation) -> None:
        with self._lock:
            if not self._enabled:
                return
            if ev.id in self._captured or ev.id in self._escaped:
                return
            # One blocked eval per job: newer ones are duplicates the
            # leader cancels (blocked_evals.go:43-54).
            existing = self._jobs.get(ev.job_id)
            if existing is not None and existing != ev.id:
                self._duplicates.append(ev)
                return
            # Missed-unblock race: capacity may have changed between the
            # eval's snapshot and now (blocked_evals.go:214).
            if self._missed_unblock(ev):
                self._enqueue([ev])
                return
            self._jobs[ev.job_id] = ev.id
            if ev.escaped_computed_class:
                self._escaped[ev.id] = ev
            else:
                self._captured[ev.id] = ev

    def reblock(self, ev: Evaluation) -> None:
        """Re-track an eval that was already blocked (the scheduler ran
        it again and still couldn't place everything)."""
        with self._lock:
            self._jobs.pop(ev.job_id, None)
            self._captured.pop(ev.id, None)
            self._escaped.pop(ev.id, None)
        self.block(ev)

    def _missed_unblock(self, ev: Evaluation) -> bool:
        for cls, index in self._unblock_indexes.items():
            if index <= ev.snapshot_index:
                continue
            if ev.escaped_computed_class:
                return True
            elig = ev.class_eligibility.get(cls)
            if elig is None or elig:
                # Unknown or eligible class gained capacity after our
                # snapshot: we may have missed it.
                return True
        return False

    # ------------------------------------------------------------------

    def unblock(self, computed_class: str, index: int) -> None:
        """Capacity changed on nodes of the given class: requeue every
        eval that might now be placeable."""
        with self._lock:
            if not self._enabled:
                return
            self._unblock_indexes[computed_class] = index
            unblocked: List[Evaluation] = []
            for eid, ev in list(self._escaped.items()):
                unblocked.append(ev)
                del self._escaped[eid]
                self._jobs.pop(ev.job_id, None)
            for eid, ev in list(self._captured.items()):
                elig = ev.class_eligibility.get(computed_class)
                if elig is None or elig:
                    unblocked.append(ev)
                    del self._captured[eid]
                    self._jobs.pop(ev.job_id, None)
            if unblocked:
                self._enqueue(unblocked)

    def unblock_failed(self) -> None:
        """Periodically retried by the leader so evals blocked due to
        max-plan failures aren't stuck forever (leader.go:441)."""
        with self._lock:
            unblocked = []
            for store in (self._captured, self._escaped):
                for eid, ev in list(store.items()):
                    if ev.triggered_by == consts.EVAL_TRIGGER_MAX_PLANS:
                        unblocked.append(ev)
                        del store[eid]
                        self._jobs.pop(ev.job_id, None)
            if unblocked:
                self._enqueue(unblocked)

    def untrack(self, job_id: str) -> None:
        """Job deregistered: drop its blocked eval."""
        with self._lock:
            eid = self._jobs.pop(job_id, None)
            if eid:
                self._captured.pop(eid, None)
                self._escaped.pop(eid, None)

    def get_duplicates(self) -> List[Evaluation]:
        """Drain duplicate blocked evals for leader cancellation
        (leader.go:407 reapDupBlockedEvaluations)."""
        with self._lock:
            dups = self._duplicates
            self._duplicates = []
            return dups

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "total_blocked": len(self._captured) + len(self._escaped),
                "total_escaped": len(self._escaped),
            }
