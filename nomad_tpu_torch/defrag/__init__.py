"""Continuous cluster defragmentation: the leader-side optimizer loop.

The closed loop, stitched from the port's other subsystems:

- the **solve** is kernels/convex.py's mirror-descent program run
  globally over the cluster's node state (defrag/solver.py, K9),
  warm-started from the previous round's iterate so steady-state
  rounds cost a few gradient steps;
- the **moves** commit through the churn machinery: the loop claims
  ``MigrationGovernor`` slots for each wave (so defrag disruption counts
  against — and is capped by — ``migrate_max_parallel``, in the same
  high-water mark as drain storms), mints per-job
  ``triggered_by=defrag-migration`` evals (``build_wave_evals``) through
  the server's eval funnel, and the generic scheduler stages the marked
  allocs as budget-exempt migrations: an applier-verified eviction leg
  plus a replacement placement that prefers the solver's target node,
  in one plan, every displaced alloc getting its exactly-once terminal;
- the **gate** is the admission signal: the loop only optimizes a green
  cluster, backs off at yellow/red, pauses on leadership loss, and
  discards any wave whose solve raced a resident-base rejection purge
  (models/matrix.py ``base_epoch``).

One wave is in flight at a time: the loop watches its evals to their
terminal status and releases the governor slots as each lands.
Surfaces: ``server.stats()["defrag"]``, the ``defrag.*`` gauges, the
``defrag.solve`` trace stage, and the ``defrag_*`` ServerConfig knobs.

The port of the JAX package's defrag package. It leaves out the
fault-injection sites (``defrag.solve_stale``, ``defrag.wave_lost``) and
the ``solve_programs`` stat (defrag/solver.py: no compiled programs to
count).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, List, Optional

from .solver import (  # noqa: F401 (re-exported rig surface)
    COLD_ITERS,
    MAX_SOLVE_ALLOCS,
    WARM_ITERS,
    DefragPlan,
    Move,
    WarmState,
    cluster_fragmentation,
    compute_defrag_plan,
    frag_score,
    reference_asks,
)

# How long a wave may stay in flight before the loop declares it dead
# and reclaims its governor slots (a crashed scheduler or a flushed
# broker can orphan a wave's evals; their redelivery/terminal path is
# exactly-once regardless — this bounds only the loop's OWN claim).
WAVE_TIMEOUT = 60.0
# Loop tick: the wait slice between wake-ups (leadership, wave watch,
# and the interval clock are all checked per tick; the tick is NOT the
# optimization cadence — defrag_interval is).
TICK = 0.1
# Pressure backoff multiplier: a yellow/red tick pushes the next round
# out by this many intervals (red compounds per consecutive skip up to
# MAX_BACKOFF intervals).
PRESSURE_BACKOFF = 2.0
MAX_BACKOFF = 8.0


def build_wave_evals(state, moves: List[Move]) -> List:
    """Per-job defrag evals for one wave's move set. Jobs deregistered
    since the solve snapshot drop out (their allocs are dying anyway);
    the eval carries the marked alloc ids and the solver's target per
    alloc (a preference, not a mandate — scheduler/generic.py)."""
    from ..structs import Evaluation, consts
    from ..utils.ids import generate_uuid

    by_job: Dict[str, List[Move]] = {}
    for mv in moves:
        by_job.setdefault(mv.job_id, []).append(mv)
    evals = []
    # Markers void themselves when the loop's wave claim does: an eval
    # surfacing after WAVE_TIMEOUT (backed-up broker, leadership move)
    # would otherwise stage budget-EXEMPT evictions against governor
    # slots nobody holds anymore.
    expires = time.time() + WAVE_TIMEOUT
    for job_id in sorted(by_job):
        job = state.job_by_id(job_id)
        if job is None or getattr(job, "stop", False):
            continue
        job_moves = by_job[job_id]
        evals.append(Evaluation(
            id=generate_uuid(),
            priority=job.priority,
            type=job.type,
            triggered_by=consts.EVAL_TRIGGER_DEFRAG,
            job_id=job_id,
            job_modify_index=job.job_modify_index,
            status=consts.EVAL_STATUS_PENDING,
            trace_id=generate_uuid(),
            defrag_alloc_ids=[mv.alloc_id for mv in job_moves],
            defrag_targets={mv.alloc_id: mv.to_node
                            for mv in job_moves},
            defrag_wave_expires=expires,
        ))
    return evals


class DefragLoop:
    """The background optimizer thread. Constructed unconditionally by
    the Server (stats surface), started with it; actually optimizes
    only while ``defrag_enabled`` AND this server holds leadership AND
    the admission monitor reads green."""

    def __init__(self, server):
        self.server = server
        self.logger = logging.getLogger("nomad_tpu_torch.defrag")
        cfg = server.config
        self._lock = threading.Lock()
        self.enabled = bool(cfg.defrag_enabled)  # guarded-by: _lock
        self.interval = float(cfg.defrag_interval)  # guarded-by: _lock
        self.min_gain = float(cfg.defrag_min_gain)  # guarded-by: _lock
        self.max_moves = int(cfg.defrag_max_moves_per_wave)  # guarded-by: _lock
        self._warm = WarmState()  # solver-iterate carry (loop thread only)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # In-flight wave: eval id -> governor slots it holds.
        self._wave: Dict[str, int] = {}  # guarded-by: _lock
        self._wave_started = 0.0  # guarded-by: _lock
        self._next_round = 0.0  # guarded-by: _lock (monotonic deadline)
        self._backoff = 1.0  # guarded-by: _lock (pressure compounding)
        # Counters (guarded-by: _lock).
        self.rounds = 0
        self.waves = 0
        self.waves_lost = 0
        self.moves_proposed = 0
        self.moves_completed = 0  # wave evals reaching terminal (slots)
        self.no_gain_rounds = 0
        self.pressure_skips = 0
        self.budget_skips = 0
        self.stale_discards = 0
        self.cold_solves = 0
        self.warm_solves = 0
        self.last_gain = 0.0
        self.last_frag = 0.0
        self.last_movable = 0
        self.last_solve_ms = 0.0
        self.last_cold_solve_ms = 0.0
        self.last_warm_solve_ms = 0.0
        # Acceptance pair for "warm is measurably cheaper than cold":
        # the FIRST cold solve (the full iteration budget) vs the
        # cheapest warm steady-state solve. last_* can invert on noise.
        self.first_cold_solve_ms = 0.0
        self.min_warm_solve_ms = 0.0

    # ---------------------------------------------------------- config

    def configure(self, enabled: Optional[bool] = None,
                  interval: Optional[float] = None,
                  min_gain: Optional[float] = None,
                  max_moves: Optional[int] = None) -> None:
        with self._lock:
            if enabled is not None:
                self.enabled = bool(enabled)
            if interval is not None:
                self.interval = float(interval)
            if min_gain is not None:
                self.min_gain = float(min_gain)
            if max_moves is not None:
                self.max_moves = int(max_moves)

    # ------------------------------------------------------- lifecycle

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        t = threading.Thread(target=self._run, name="defrag-loop",
                             daemon=True)
        self._thread = t
        t.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
            self._thread = None
        self._abandon_wave("shutdown")

    def _run(self) -> None:
        while not self._stop.wait(TICK):
            try:
                self.tick()
            except Exception:  # noqa: BLE001 - the loop must survive
                self.logger.exception("defrag tick failed")

    # ------------------------------------------------------------ tick

    def tick(self, now: Optional[float] = None) -> None:
        """One scheduling decision: watch the in-flight wave, then run
        a round if the interval elapsed on a green, led cluster.
        Public (and monotonic-clock injectable) so tests and benchmarks
        can step the loop synchronously."""
        now = time.monotonic() if now is None else now
        with self._lock:
            enabled = self.enabled
        if not self.server.is_leader():
            # Leadership loss pauses the loop AND abandons the wave:
            # the new leader re-derives its own (our wave's evals keep
            # their exactly-once path on whichever leader serves them,
            # but the slots are THIS process's claim to return).
            self._abandon_wave("leadership-lost")
            return
        # The wave clock is real monotonic time regardless of an
        # injected `now` (tests inject the ROUND clock; _wave_started
        # is always stamped from time.monotonic()).
        self._watch_wave(time.monotonic())
        if not enabled:
            return
        with self._lock:
            if self._wave:  # one wave at a time
                return
            if now < self._next_round:
                return
            interval = self.interval
        try:
            level = self.server.admission.level()
        except Exception:  # noqa: BLE001 - a broken probe = don't optimize
            self.logger.exception("defrag pressure probe failed")
            level = "red"
        if level != "green":
            # An optimizer must never compete with overload: back off,
            # compounding x2 per consecutive skip (yellow AND red) up to
            # MAX_BACKOFF intervals; a green round resets.
            with self._lock:
                self.pressure_skips += 1
                self._backoff = min(self._backoff * PRESSURE_BACKOFF,
                                    MAX_BACKOFF)
                self._next_round = now + interval * self._backoff
            return
        with self._lock:
            self._backoff = 1.0
            self._next_round = now + interval
        self.run_round()

    # ----------------------------------------------------------- round

    def run_round(self) -> Optional[DefragPlan]:
        """One solve->diff->wave round against the current snapshot.
        Returns the solver plan (None only if the server has no nodes
        yet). Public for benchmarks and tests."""
        from .. import trace
        from ..migrate import get_governor
        from ..models.matrix import base_epoch
        from ..utils.ids import generate_uuid

        state = self.server.fsm.state.snapshot()
        dcs = sorted({n.datacenter for n in state.nodes()})
        if not dcs:
            return None
        with self._lock:
            min_gain = self.min_gain
            max_moves = self.max_moves
        epoch0 = base_epoch()
        t0 = time.monotonic()
        plan = compute_defrag_plan(
            state, dcs, max_moves=max_moves, min_gain=min_gain,
            warm=self._warm)
        round_id = f"defrag-{generate_uuid()[:8]}"
        trace.record_span(
            round_id, trace.STAGE_DEFRAG_SOLVE, t0,
            ann={"movable": plan.movable, "moves": len(plan.moves),
                 "gain": round(plan.gain, 4), "warm": plan.warm,
                 "solve_ms": round(plan.solve_ms, 3)})
        trace.complete(round_id)
        with self._lock:
            self.rounds += 1
            self.last_solve_ms = plan.solve_ms
            self.last_gain = plan.gain
            self.last_frag = plan.frag_after
            self.last_movable = plan.movable
            # No movable set = no solve ran: it counts as neither a
            # cold nor a warm solve.
            if plan.movable and plan.warm:
                self.warm_solves += 1
                self.last_warm_solve_ms = plan.solve_ms
                if (self.min_warm_solve_ms == 0.0
                        or plan.solve_ms < self.min_warm_solve_ms):
                    self.min_warm_solve_ms = plan.solve_ms
            elif plan.movable:
                self.cold_solves += 1
                self.last_cold_solve_ms = plan.solve_ms
                if self.first_cold_solve_ms == 0.0:
                    self.first_cold_solve_ms = plan.solve_ms

        # Staleness: a plan-apply rejection purged the resident base
        # chain while we solved — whatever this wave derived from is
        # suspect. Discard it (and the warm carry: it extends the same
        # convicted chain); the next round re-anchors from a clean
        # rebuild.
        if base_epoch() != epoch0:
            with self._lock:
                self.stale_discards += 1
            self._warm.clear()
            return plan

        if not plan.moves:
            with self._lock:
                self.no_gain_rounds += 1
            return plan

        # Wave budget: claim governor slots UP FRONT (the scheduler
        # treats defrag-marked migrations as pre-claimed), so defrag
        # disruption shares migrate_max_parallel with drain storms —
        # one cap, one high-water mark.
        governor = get_governor()
        granted = governor.acquire(len(plan.moves))
        if granted == 0:
            with self._lock:
                self.budget_skips += 1
            return plan
        moves = plan.moves[:granted]
        evals = build_wave_evals(state, moves)
        if not evals:
            governor.release(granted)
            return plan
        # Slots per eval = its move count; any clamp remainder rides on
        # the first eval so every granted slot has an owner to release.
        per_eval = {ev.id: len(ev.defrag_alloc_ids) for ev in evals}
        slack = granted - sum(per_eval.values())
        if slack > 0:
            per_eval[evals[0].id] += slack
        try:
            self.server.eval_update(evals)
        except Exception:  # noqa: BLE001 - leader flap mid-wave
            self.logger.exception("defrag wave submit failed")
            governor.release(granted)
            return plan
        with self._lock:
            self._wave = per_eval
            self._wave_started = time.monotonic()
            self.waves += 1
            self.moves_proposed += sum(
                len(ev.defrag_alloc_ids) for ev in evals)
        self.logger.info(
            "defrag wave: %d moves across %d jobs (gain %.4f, frag "
            "%.4f -> %.4f)", len(moves), len(evals), plan.gain,
            plan.frag_before, plan.frag_after)
        return plan

    # ------------------------------------------------------ wave watch

    def _watch_wave(self, now: float) -> None:
        from ..migrate import get_governor

        with self._lock:
            if not self._wave:
                return
            started = self._wave_started
            pending = dict(self._wave)
        if now - started > WAVE_TIMEOUT:
            self._abandon_wave("timeout")
            return
        state = self.server.fsm.state
        done: List[str] = []
        for eval_id in pending:
            ev = state.eval_by_id(eval_id)
            if ev is None or ev.terminal_status():
                done.append(eval_id)
        if not done:
            return
        released = 0
        with self._lock:
            for eval_id in done:
                released += self._wave.pop(eval_id, 0)
            self.moves_completed += released
            wave_done = not self._wave
        if released:
            get_governor().release(released)
        if wave_done:
            self.logger.debug("defrag wave settled (%d slots)", released)

    def _abandon_wave(self, reason: str) -> None:
        from ..migrate import get_governor

        with self._lock:
            if not self._wave:
                return
            slots = sum(self._wave.values())
            self._wave = {}
            self.waves_lost += 1
        get_governor().release(slots)
        self.logger.warning(
            "defrag wave abandoned (%s): released %d slots", reason, slots)

    # ----------------------------------------------------------- stats

    def reset_stats(self) -> None:
        """Re-baseline counters (measurement windows) without touching
        the in-flight wave or the warm carry."""
        with self._lock:
            self.rounds = self.waves = self.waves_lost = 0
            self.moves_proposed = self.moves_completed = 0
            self.no_gain_rounds = self.pressure_skips = 0
            self.budget_skips = self.stale_discards = 0
            self.cold_solves = self.warm_solves = 0
            self.first_cold_solve_ms = 0.0
            self.min_warm_solve_ms = 0.0

    def stats(self) -> Dict[str, object]:
        with self._lock:
            return {
                "enabled": self.enabled,
                "interval": self.interval,
                "min_gain": self.min_gain,
                "max_moves_per_wave": self.max_moves,
                "rounds": self.rounds,
                "waves": self.waves,
                "waves_lost": self.waves_lost,
                "wave_in_flight": sum(self._wave.values()),
                "moves_proposed": self.moves_proposed,
                "moves_completed": self.moves_completed,
                "no_gain_rounds": self.no_gain_rounds,
                "pressure_skips": self.pressure_skips,
                "budget_skips": self.budget_skips,
                "stale_discards": self.stale_discards,
                "cold_solves": self.cold_solves,
                "warm_solves": self.warm_solves,
                "last_gain": round(self.last_gain, 6),
                "last_fragmentation": round(self.last_frag, 6),
                "last_movable": self.last_movable,
                "last_solve_ms": round(self.last_solve_ms, 3),
                "last_cold_solve_ms": round(self.last_cold_solve_ms, 3),
                "last_warm_solve_ms": round(self.last_warm_solve_ms, 3),
                "first_cold_solve_ms": round(self.first_cold_solve_ms, 3),
                "min_warm_solve_ms": round(self.min_warm_solve_ms, 3),
            }


__all__ = [
    "COLD_ITERS",
    "MAX_SOLVE_ALLOCS",
    "WARM_ITERS",
    "WAVE_TIMEOUT",
    "DefragLoop",
    "DefragPlan",
    "Move",
    "WarmState",
    "build_wave_evals",
    "cluster_fragmentation",
    "compute_defrag_plan",
    "frag_score",
    "reference_asks",
]
