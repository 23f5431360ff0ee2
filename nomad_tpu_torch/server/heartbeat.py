"""Leader-side node heartbeat TTL timers.

Reference: nomad/heartbeat.go:14 — a timer per node; expiry marks the
node down through the normal status-update path, which fans out
re-scheduling evals. TTLs are randomized within [min, min + n/rate] to
spread renewal load (heartbeat.go:47, config.go:235-238).
"""

from __future__ import annotations

import logging
import random
import threading
from typing import Dict

from ..structs import consts
from ..utils.pool import WorkPool
from ..utils.timer import default_wheel

INVALIDATE_WORKERS = 8


class HeartbeatTimers:
    def __init__(self, server):
        self.server = server
        self.logger = logging.getLogger("nomad_tpu_torch.heartbeat")
        self._lock = threading.Lock()
        self._wheel = default_wheel()  # one thread for ALL node TTLs
        self._timers: Dict[str, object] = {}
        self._enabled = False
        # Invalidation does a raft apply, which can block for a leader
        # term; running it on the wheel's dispatch pool would let a
        # drain storm head-of-line-block broker nack timers. A private
        # bounded pool absorbs the storm instead.
        self._invalidate_pool = WorkPool(INVALIDATE_WORKERS, name="hb-invalidate")

    def set_enabled(self, enabled: bool) -> None:
        with self._lock:
            self._enabled = enabled
            if not enabled:
                for t in self._timers.values():
                    t.cancel()
                self._timers.clear()

    def initialize(self) -> None:
        """On becoming leader, arm a timer for every live node
        (heartbeat.go:14 initializeHeartbeatTimers)."""
        for node in self.server.fsm.state.nodes():
            if node.terminal_status():
                continue
            self.reset_timer(node.id)

    def ttl(self) -> float:
        cfg = self.server.config
        n = len(self._timers)
        spread = max(n / cfg.max_heartbeats_per_second, cfg.heartbeat_grace)
        return cfg.min_heartbeat_ttl + random.random() * spread

    def reset_timer(self, node_id: str) -> float:
        """(Re)arm the TTL timer; returns the TTL granted to the node."""
        with self._lock:
            if not self._enabled:
                return 0.0
            existing = self._timers.pop(node_id, None)
            if existing is not None:
                existing.cancel()
            ttl = self.ttl()
            self._timers[node_id] = self._wheel.schedule(
                ttl + self.server.config.heartbeat_grace,
                self._invalidate, node_id,
            )
            return ttl

    def clear_timer(self, node_id: str) -> None:
        with self._lock:
            timer = self._timers.pop(node_id, None)
            if timer is not None:
                timer.cancel()

    def _invalidate(self, node_id: str) -> None:
        """TTL expired without a heartbeat: node is down
        (heartbeat.go:84 invalidateHeartbeat). Runs on the wheel's
        dispatch pool — only bookkeeping here; the raft apply moves to
        the private pool."""
        with self._lock:
            self._timers.pop(node_id, None)
            if not self._enabled:
                return
        self._invalidate_pool.submit(self._apply_down, node_id)

    def _apply_down(self, node_id: str) -> None:
        # The apply may have sat queued behind raft-blocked workers for
        # a while: if the node heartbeated meanwhile (timer re-armed) or
        # leadership was lost, downing it now would be spurious.
        with self._lock:
            if not self._enabled or node_id in self._timers:
                return
        self.logger.warning("node %s TTL expired, marking down", node_id)
        try:
            self.server.node_update_status(node_id, consts.NODE_STATUS_DOWN)
        except Exception:
            self.logger.exception("failed to invalidate heartbeat for %s", node_id)

    def count(self) -> int:
        with self._lock:
            return len(self._timers)
