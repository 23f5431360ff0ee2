"""PeriodicDispatch: leader-only cron launcher for periodic jobs.

Reference: nomad/periodic.go:135 — a heap of (next launch time, job);
children are derived as '<id>/periodic-<epoch>' (periodic.go:400) and
forced through the normal register+eval path; prohibit_overlap skips a
launch while a previous child is non-terminal.
"""

from __future__ import annotations

import heapq
import logging
import threading
import time
from typing import Dict, List, Optional, Tuple

from ..structs import Job, consts

PERIODIC_LAUNCH_SUFFIX = "/periodic-"


def derive_job(parent: Job, launch_time: float) -> Job:
    child = parent.copy()
    child.parent_id = parent.id
    child.id = f"{parent.id}{PERIODIC_LAUNCH_SUFFIX}{int(launch_time)}"
    child.name = child.id
    child.periodic = None
    child.status = ""
    return child


class PeriodicDispatch:
    def __init__(self, server):
        self.server = server
        self.logger = logging.getLogger("nomad_tpu_torch.periodic")
        self._lock = threading.RLock()
        self._cond = threading.Condition(self._lock)
        self._enabled = False
        self._running = False
        self._tracked: Dict[str, Job] = {}
        self._heap: List[Tuple[float, str]] = []  # (next launch, job id)
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------

    def set_enabled(self, enabled: bool) -> None:
        with self._lock:
            self._enabled = enabled
            if enabled and not self._running:
                self._running = True
                self._thread = threading.Thread(
                    target=self._run, name="periodic-dispatch", daemon=True
                )
                self._thread.start()
            if not enabled:
                self._tracked.clear()
                self._heap = []
                self._running = False
                self._cond.notify_all()

    def tracked(self) -> List[Job]:
        with self._lock:
            return list(self._tracked.values())

    def add(self, job: Job) -> None:
        with self._lock:
            if not self._enabled:
                return
            if not job.is_periodic():
                self._untrack(job.id)
                return
            self._tracked[job.id] = job
            nxt = job.periodic.next_launch(time.time())
            if nxt is not None:
                heapq.heappush(self._heap, (nxt, job.id))
                self._cond.notify_all()

    def remove(self, job_id: str) -> None:
        with self._lock:
            self._untrack(job_id)

    def _untrack(self, job_id: str) -> None:
        self._tracked.pop(job_id, None)
        self._heap = [(t, j) for t, j in self._heap if j != job_id]
        heapq.heapify(self._heap)
        self._cond.notify_all()

    # ------------------------------------------------------------------

    def force_run(self, job_id: str) -> Optional[str]:
        """Periodic.Force endpoint: launch now (periodic.go:46)."""
        with self._lock:
            job = self._tracked.get(job_id)
        if job is None:
            raise ValueError(f"job {job_id!r} is not tracked as periodic")
        return self._dispatch(job, time.time())

    def _run(self) -> None:
        while True:
            with self._lock:
                if not self._enabled:
                    return
                if not self._heap:
                    self._cond.wait(1.0)
                    continue
                launch_time, job_id = self._heap[0]
                now = time.time()
                if launch_time > now:
                    self._cond.wait(min(launch_time - now, 1.0))
                    continue
                heapq.heappop(self._heap)
                job = self._tracked.get(job_id)
                if job is None:
                    continue
                nxt = job.periodic.next_launch(launch_time)
                if nxt is not None:
                    heapq.heappush(self._heap, (nxt, job_id))
            try:
                self._dispatch(job, launch_time)
            except Exception:
                self.logger.exception("periodic launch of %s failed", job_id)

    def _dispatch(self, job: Job, launch_time: float) -> Optional[str]:
        if job.periodic.prohibit_overlap:
            children = [
                j for j in self.server.fsm.state.jobs()
                if j.parent_id == job.id and j.status != consts.JOB_STATUS_DEAD
            ]
            if children:
                self.logger.debug(
                    "skipping launch of %s: child still running", job.id
                )
                return None
        child = derive_job(job, launch_time)
        self.server.job_register(child, triggered_by=consts.EVAL_TRIGGER_PERIODIC_JOB)
        self.server.periodic_launch_record(job.id, launch_time)
        return child.id
