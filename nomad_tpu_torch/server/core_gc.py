"""CoreScheduler: garbage collection driven by `_core` evals.

Reference: nomad/core_sched.go:29 — the leader periodically enqueues
core-job evals (leader.go GC timers); a worker dequeues them like any
other eval and this scheduler reaps terminal evals/allocs, dead jobs,
and down nodes older than their thresholds, using the TimeTable to map
time thresholds to log indexes.
"""

from __future__ import annotations

import logging
import time
from typing import List, Optional

from ..structs import Evaluation, consts


class CoreScheduler:
    """Registered under the `_core` eval type. The eval's job_id selects
    the GC pass: eval-gc, job-gc, node-gc, or force-gc."""

    def __init__(self, logger, state, planner, rng=None, server=None):
        self.logger = logger or logging.getLogger("nomad_tpu_torch.core_gc")
        self.state = state
        self.server = server

    def process_eval(self, ev: Evaluation) -> None:
        kind = ev.job_id
        if kind == consts.CORE_JOB_EVAL_GC:
            self._eval_gc(force=False)
        elif kind == consts.CORE_JOB_JOB_GC:
            self._job_gc(force=False)
        elif kind == consts.CORE_JOB_NODE_GC:
            self._node_gc(force=False)
        elif kind == consts.CORE_JOB_FORCE_GC:
            self._eval_gc(force=True)
            self._job_gc(force=True)
            self._node_gc(force=True)
        else:
            self.logger.error("core sched: unknown job %r", kind)

    # ------------------------------------------------------------------

    def _threshold_index(self, threshold_seconds: float, force: bool) -> int:
        if force:
            return self.server.fsm.state.latest_index()
        cutoff = time.time() - threshold_seconds
        return self.server.fsm.timetable.nearest_index(cutoff)

    def _eval_gc(self, force: bool) -> None:
        """Reap terminal evals (and their terminal allocs) older than the
        threshold (core_sched.go:164)."""
        cfg = self.server.config
        oldest = self._threshold_index(cfg.eval_gc_threshold, force)
        gc_evals: List[str] = []
        gc_allocs: List[str] = []
        for ev in self.state.evals():
            if not ev.terminal_status() or ev.modify_index > oldest:
                continue
            allocs = self.state.allocs_by_eval(ev.id)
            if any(not a.terminal_status() or a.modify_index > oldest for a in allocs):
                continue  # eval still referenced by live allocs
            gc_evals.append(ev.id)
            gc_allocs.extend(a.id for a in allocs)
        if gc_evals or gc_allocs:
            self.logger.debug(
                "eval GC reaping %d evals, %d allocs", len(gc_evals), len(gc_allocs)
            )
            self.server.eval_reap(gc_evals, gc_allocs)

    def _job_gc(self, force: bool) -> None:
        """Reap dead jobs whose evals/allocs are all collectible
        (core_sched.go:68)."""
        cfg = self.server.config
        oldest = self._threshold_index(cfg.job_gc_threshold, force)
        for job in self.state.jobs():
            if job.status != consts.JOB_STATUS_DEAD or job.modify_index > oldest:
                continue
            if job.is_periodic():
                continue  # parents live until deregistered
            evals = self.state.evals_by_job(job.id)
            if any(not ev.terminal_status() or ev.modify_index > oldest for ev in evals):
                continue
            allocs = self.state.allocs_by_job(job.id)
            if any(not a.terminal_status() or a.modify_index > oldest for a in allocs):
                continue
            self.logger.debug("job GC reaping %s", job.id)
            self.server.eval_reap(
                [ev.id for ev in evals], [a.id for a in allocs]
            )
            self.server.job_deregister(job.id, create_eval=False)

    def _node_gc(self, force: bool) -> None:
        """Reap down nodes with no allocs (core_sched.go:335)."""
        cfg = self.server.config
        oldest = self._threshold_index(cfg.node_gc_threshold, force)
        for node in self.state.nodes():
            if node.status != consts.NODE_STATUS_DOWN or node.modify_index > oldest:
                continue
            # Only NON-terminal allocations pin a node; completed ones
            # are the eval GC's business (core_sched.go:361-378
            # TestCoreScheduler_NodeGC_TerminalAllocs).
            if any(not a.terminal_status()
                   for a in self.state.allocs_by_node(node.id)):
                continue
            self.logger.debug("node GC reaping %s", node.id)
            self.server.node_deregister(node.id)
