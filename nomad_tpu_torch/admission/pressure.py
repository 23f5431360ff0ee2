"""Pressure monitor: one green/yellow/red overload level for the
control plane.

Inputs (all already maintained by other subsystems — the monitor only
reads):

- **broker depth** — per-queue ready + unacked + blocked counts from
  the EvalBroker. CAPPED queues are measured as a fraction of their
  summed budget (yellow at ``ready_frac_yellow``, red at
  ``ready_frac_red``); everything outside a cap — uncapped queues'
  ready, unacked, blocked — is judged by the absolute
  ``depth_yellow`` / ``depth_red`` thresholds, so a deliberately
  unbounded queue's backlog neither reads as false cap pressure nor
  hides from the monitor.
- **dispatch saturation** — the central pipeline's in-flight slots and
  pending accumulator depth: every slot busy AND a full batch already
  waiting is yellow; pending at 2x a full batch is red.
- **rolling e2e p99** — the flight recorder's end-to-end latency
  p99 (trace/recorder.py) against the ``p99_yellow_ms`` /
  ``p99_red_ms`` thresholds (0 disables this input — the default,
  since absolute latency is deployment-specific).
- **hot-lock wait p99** — the contention observatory's worst
  per-site contended acquire-wait p99 (profile/) against
  ``admission_lock_wait_yellow_ms`` / ``_red_ms`` (0 disables, the
  default). When it fires, the reason NAMES the hottest lock site —
  "why are we shedding" can now answer "the broker lock convoys".

The level is the MAX of the inputs' contributions; ``reasons`` names
which input(s) drove it, so ``/v1/agent/self`` answers "why are we
shedding" directly. Snapshots are cached for ``CACHE_TTL`` so the
admission check on every HTTP request costs an attribute read + a
cache hit, not four stats() calls.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from .. import trace
from ..utils import metrics

LEVEL_GREEN = "green"
LEVEL_YELLOW = "yellow"
LEVEL_RED = "red"
LEVEL_NUM = {LEVEL_GREEN: 0, LEVEL_YELLOW: 1, LEVEL_RED: 2}


class PressureMonitor:
    CACHE_TTL = 0.25

    def __init__(self, server, config):
        self.server = server
        # Thresholds: read-mostly plain attributes (set at boot).
        self.ready_frac_yellow = 0.75
        self.ready_frac_red = 0.95
        self.depth_yellow = config.admission_depth_yellow
        self.depth_red = config.admission_depth_red
        self.p99_yellow_ms = config.admission_p99_yellow_ms
        self.p99_red_ms = config.admission_p99_red_ms
        self.lock_wait_yellow_ms = getattr(
            config, "admission_lock_wait_yellow_ms", 0.0)
        self.lock_wait_red_ms = getattr(
            config, "admission_lock_wait_red_ms", 0.0)
        self._lock = threading.RLock()
        self._cached: Optional[dict] = None  # guarded-by: _lock
        self._cached_at = 0.0  # guarded-by: _lock

    # ------------------------------------------------------------ read

    def level(self) -> str:
        return self.snapshot()["level"]

    def snapshot(self, refresh: bool = False) -> dict:
        now = time.monotonic()
        with self._lock:
            if (not refresh and self._cached is not None
                    and now - self._cached_at < self.CACHE_TTL):
                return self._cached
        # Compute OUTSIDE the lock: the inputs take the broker/pipeline
        # locks and holding ours across them would nest lock orders for
        # no benefit; a racing duplicate compute is harmless.
        snap = self._compute()
        with self._lock:
            self._cached = snap
            self._cached_at = time.monotonic()
        metrics.set_gauge(("admission", "pressure_level"),
                          snap["level_num"])
        return snap

    # --------------------------------------------------------- compute

    def _capped_depth(self, ready_by_queue: dict) -> tuple:
        """(capped_ready, cap_total): the summed depth of the CAPPED
        queues only, against their summed budget. An uncapped queue's
        backlog must not count against the capped budget — with e.g.
        only 'service' capped, a burst of deliberately-unbounded batch
        evals would otherwise read as >100% of a cap it never
        consumes, driving a false red that sheds healthy traffic.
        Uncapped queues are judged by the absolute depth thresholds
        instead."""
        cfg = self.server.config
        caps = cfg.eval_ready_caps
        default = cfg.eval_ready_cap
        capped_ready = 0
        cap_total = 0
        # Per-type overrides outside enabled_schedulers still bound
        # real queues; the union covers them.
        for sched in set(cfg.enabled_schedulers) | set(caps):
            cap = caps.get(sched, default)
            if cap > 0:
                cap_total += cap
                capped_ready += ready_by_queue.get(sched, 0)
        return capped_ready, cap_total

    def _compute(self) -> dict:
        broker = self.server.broker.stats()
        ready = broker["total_ready"]
        unacked = broker["total_unacked"]
        blocked = broker.get("total_blocked", 0)
        dispatch = self.server.dispatch.stats()
        p99_ms = trace.get_recorder().e2e_p99()

        level = LEVEL_GREEN
        reasons = []

        def bump(new_level: str, reason: str) -> None:
            nonlocal level
            reasons.append(reason)
            if LEVEL_NUM[new_level] > LEVEL_NUM[level]:
                level = new_level

        capped_ready, cap = self._capped_depth(
            broker.get("ready_by_queue", {}))
        if cap > 0:
            frac = capped_ready / cap
            if frac >= self.ready_frac_red:
                bump(LEVEL_RED, f"ready depth {capped_ready}/{cap} >= "
                                f"{self.ready_frac_red:.0%} of cap")
            elif frac >= self.ready_frac_yellow:
                bump(LEVEL_YELLOW,
                     f"ready depth {capped_ready}/{cap} >= "
                     f"{self.ready_frac_yellow:.0%} of cap")
        # Uncapped backlog (ready outside any cap, unacked, blocked)
        # is judged by the absolute thresholds — regardless of whether
        # caps exist elsewhere, so a mixed config can't hide depth in
        # its unbounded queues.
        depth = (ready - capped_ready) + unacked + blocked
        if self.depth_red and depth >= self.depth_red:
            bump(LEVEL_RED,
                 f"broker depth {depth} >= {self.depth_red}")
        elif self.depth_yellow and depth >= self.depth_yellow:
            bump(LEVEL_YELLOW,
                 f"broker depth {depth} >= {self.depth_yellow}")

        if dispatch.get("enabled"):
            in_flight = dispatch["in_flight"]
            pending = dispatch["pending"]
            max_batch = max(1, dispatch["max_batch"])
            saturated = (in_flight >= self.server.dispatch.max_inflight
                         and pending >= max_batch)
            if saturated and pending >= 2 * max_batch:
                bump(LEVEL_RED,
                     f"dispatch saturated: {in_flight} in flight, "
                     f"{pending} pending (>= 2x batch)")
            elif saturated:
                bump(LEVEL_YELLOW,
                     f"dispatch saturated: {in_flight} in flight, "
                     f"{pending} pending")

        if self.p99_red_ms and p99_ms >= self.p99_red_ms:
            bump(LEVEL_RED,
                 f"e2e p99 {p99_ms:.1f}ms >= {self.p99_red_ms:.1f}ms")
        elif self.p99_yellow_ms and p99_ms >= self.p99_yellow_ms:
            bump(LEVEL_YELLOW,
                 f"e2e p99 {p99_ms:.1f}ms >= {self.p99_yellow_ms:.1f}ms")

        # Hot-lock contention (profile/): the worst per-site
        # contended acquire-wait p99. Always reported in inputs; only
        # drives the level when thresholds are configured — and then
        # the reason cites the SITE, so yellow/red explains itself.
        lock_p99, lock_site = self._hottest_lock()
        if self.lock_wait_red_ms and lock_p99 >= self.lock_wait_red_ms:
            bump(LEVEL_RED,
                 f"lock wait p99 {lock_p99:.1f}ms on {lock_site!r} >= "
                 f"{self.lock_wait_red_ms:.1f}ms")
        elif (self.lock_wait_yellow_ms
              and lock_p99 >= self.lock_wait_yellow_ms):
            bump(LEVEL_YELLOW,
                 f"lock wait p99 {lock_p99:.1f}ms on {lock_site!r} >= "
                 f"{self.lock_wait_yellow_ms:.1f}ms")

        return {
            "level": level,
            "level_num": LEVEL_NUM[level],
            "reasons": reasons,
            "inputs": {
                "ready": ready,
                "ready_capped": capped_ready,
                "ready_cap_total": cap,
                "unacked": unacked,
                "blocked": blocked,
                "shed": broker.get("shed", 0),
                "expired": broker.get("expired", 0),
                "dispatch_in_flight": dispatch.get("in_flight", 0),
                "dispatch_pending": dispatch.get("pending", 0),
                "e2e_p99_ms": round(p99_ms, 3),
                "lock_wait_p99_ms": round(lock_p99, 3),
                "lock_wait_site": lock_site,
            },
        }

    @staticmethod
    def _hottest_lock() -> tuple:
        """(worst contended acquire-wait p99 in ms, its site name)
        across every profiled lock site."""
        from ..profile import get_profiler
        from ..utils.metrics import hist_percentile

        worst, site = 0.0, ""
        buckets = get_profiler().lock_site_buckets("wait")
        for name, (count, _total, dense) in buckets.items():
            p99 = hist_percentile(dense, count, 0.99)
            if p99 > worst:
                worst, site = p99, name
        return worst, site
