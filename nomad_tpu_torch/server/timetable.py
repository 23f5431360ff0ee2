"""TimeTable: log-index <-> wall-clock mapping for GC thresholds.

Reference: nomad/timetable.go:30 (ring buffer of (index, time) pairs,
witnessed on every FSM apply, fsm.go:107).
"""

from __future__ import annotations

import threading
import time
from typing import List, Tuple


class TimeTable:
    def __init__(self, granularity: float = 1.0, limit: int = 72 * 3600):
        self.granularity = granularity
        self.limit = limit  # seconds of history retained
        self._lock = threading.Lock()
        self._table: List[Tuple[int, float]] = []  # (index, time), newest first

    def witness(self, index: int, when: float = None) -> None:
        when = time.time() if when is None else when
        with self._lock:
            if self._table and when - self._table[0][1] < self.granularity:
                return
            self._table.insert(0, (index, when))
            cutoff = when - self.limit
            while self._table and self._table[-1][1] < cutoff:
                self._table.pop()

    def nearest_index(self, when: float) -> int:
        """Largest index witnessed at-or-before `when` (0 if none)."""
        with self._lock:
            for index, t in self._table:
                if t <= when:
                    return index
        return 0

    def nearest_time(self, index: int) -> float:
        with self._lock:
            for idx, t in self._table:
                if idx <= index:
                    return t
        return 0.0
