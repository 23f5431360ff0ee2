"""Token-bucket admission control for the API surfaces.

Route classes and policy (driven by the pressure level,
pressure.py)::

    class    green   yellow                  red
    exempt   pass    pass                    pass
    write    pass    write bucket (429)      shed outright (503)
    read     pass    pass                    read bucket (429)

- **exempt**: leader-forward internals (``/v1/internal/*``), raft RPC
  kinds, client control traffic (node register/heartbeat/status/alloc
  updates — shedding those converts overload into node-down cascades,
  which makes overload WORSE), and the observability surfaces
  (``/v1/agent/*``, ``/v1/metrics``, ``/v1/status/*``) an operator
  needs precisely while the server is melting.
- **write**: job submissions/evaluations and other mutations — the
  traffic that grows broker depth.
- **read**: everything else.

Rejections carry a machine-readable ``Retry-After`` (seconds): under
yellow it is the token-bucket refill deficit, under red the configured
back-off hint. 429 = rate-limited (retry at the hint), 503 = shed
(pressure red; the server is protecting goodput).
"""

from __future__ import annotations

import threading
import time
from typing import Optional, Tuple

from ..utils import metrics
from .pressure import LEVEL_GREEN, LEVEL_RED, LEVEL_YELLOW, PressureMonitor

ROUTE_EXEMPT = "exempt"
ROUTE_WRITE = "write"
ROUTE_READ = "read"

# Raft consensus + leader-forward RPC kinds on the TCP transport: the
# cluster's own control traffic is never shed (shedding append_entries
# would turn overload into leader loss).
RPC_EXEMPT_KINDS = frozenset({
    "request_vote", "append_entries", "install_snapshot", "forward_apply",
})

# HTTP handler names (api/http.py) that are client control traffic.
_CLIENT_CONTROL_HANDLERS = frozenset({
    "node_register", "node_heartbeat", "node_status", "node_update_allocs",
    "node_derive_vault", "vault_renew",
})

_EXEMPT_PREFIXES = ("/v1/internal/", "/v1/agent/", "/v1/status/",
                    "/debug/")
_EXEMPT_PATHS = ("/v1/metrics", "/v1/regions")

_WRITE_METHODS = frozenset({"PUT", "POST", "DELETE"})


class AdmissionRejected(Exception):
    """Raised by the admission checks; the HTTP layer converts it to a
    429/503 response with a Retry-After header, the RPC layer to a
    structured error frame."""

    def __init__(self, status: int, message: str, retry_after: float):
        super().__init__(message)
        self.status = status
        self.message = message
        self.retry_after = retry_after


class TokenBucket:
    """Classic token bucket: `rate` tokens/second refill up to `burst`.
    try_acquire never sleeps — it returns the refill deficit as a
    Retry-After hint instead, so no handler thread parks on admission."""

    def __init__(self, rate: float, burst: float):
        self._lock = threading.RLock()
        self.rate = float(rate)
        self.burst = float(burst)
        self._tokens = float(burst)  # guarded-by: _lock
        self._last = time.monotonic()  # guarded-by: _lock
        self.granted = 0  # guarded-by: _lock
        self.rejected = 0  # guarded-by: _lock

    def try_acquire(self, n: float = 1.0) -> Tuple[bool, float]:
        """(granted, retry_after_seconds)."""
        with self._lock:
            now = time.monotonic()
            self._tokens = min(
                self.burst, self._tokens + (now - self._last) * self.rate)
            self._last = now
            if self._tokens >= n:
                self._tokens -= n
                self.granted += 1
                return True, 0.0
            self.rejected += 1
            deficit = n - self._tokens
            return False, (deficit / self.rate if self.rate > 0 else 1.0)

    def stats(self) -> dict:
        with self._lock:
            return {
                "rate": self.rate,
                "burst": self.burst,
                "tokens": round(self._tokens, 3),
                "granted": self.granted,
                "rejected": self.rejected,
            }


def classify_http(method: str, path: str, handler_name: str = "") -> str:
    """Route class for one HTTP request (see module docstring)."""
    if path in _EXEMPT_PATHS or any(
            path.startswith(p) for p in _EXEMPT_PREFIXES):
        return ROUTE_EXEMPT
    if handler_name in _CLIENT_CONTROL_HANDLERS:
        return ROUTE_EXEMPT
    if method in _WRITE_METHODS:
        return ROUTE_WRITE
    return ROUTE_READ


class AdmissionController:
    """Glue object the Server owns: pressure monitor + per-class token
    buckets, plus the check_* entry
    points the HTTP/RPC layers call."""

    def __init__(self, server, config):
        self.enabled = bool(config.admission_enabled)
        # Kept for the read-degradation probe: a red-limited read can
        # be downgraded to a stale local-replica serve instead of a 429
        # when this server has replica state to serve from.
        self._server = server
        self.pressure = PressureMonitor(server, config)
        self._write = TokenBucket(config.admission_write_rate,
                                  config.admission_write_burst)
        self._read = TokenBucket(config.admission_read_rate,
                                 config.admission_read_burst)
        self.red_retry_after = config.admission_red_retry_after
        self._lock = threading.RLock()
        self.http_rejected = 0  # guarded-by: _lock
        self.rpc_rejected = 0  # guarded-by: _lock
        # Operator/test override: force a level regardless of inputs
        # (the ops analog of a load-shedding kill switch).
        self._forced_level: Optional[str] = None  # guarded-by: _lock

    # --------------------------------------------------------- control

    def force_level(self, level: Optional[str]) -> None:
        with self._lock:
            self._forced_level = level

    def level(self) -> str:
        """The effective pressure level (forced override included) —
        the public probe the preemption policy (migrate/)
        and operators read."""
        return self._level()

    def _level(self) -> str:
        with self._lock:
            forced = self._forced_level
        return forced if forced is not None else self.pressure.level()

    # ---------------------------------------------------------- checks

    def check_http(self, method: str, path: str,
                   handler_name: str = "") -> Optional[str]:
        """Admission gate for one HTTP request: returns None on admit,
        returns the verdict "stale" to degrade a red-pressure read to
        stale local-replica serving, raises AdmissionRejected on
        shed/limit."""
        if not self.enabled:
            return None
        route_class = classify_http(method, path, handler_name)
        if route_class == ROUTE_EXEMPT:
            return
        level = self._level()
        if level == LEVEL_GREEN:
            return
        if route_class == ROUTE_WRITE:
            if level == LEVEL_RED:
                self._reject_http()
                raise AdmissionRejected(
                    503,
                    "server overloaded (pressure red): write shed",
                    self.red_retry_after)
            ok, retry = self._write.try_acquire()
            if not ok:
                self._reject_http()
                raise AdmissionRejected(
                    429,
                    "write rate limited (pressure yellow)",
                    max(retry, 0.05))
            return
        # Reads are limited only under red.
        if level == LEVEL_RED:
            ok, retry = self._read.try_acquire()
            if not ok:
                if self._has_replica_state():
                    # Degrade, don't deny: over-budget red reads serve
                    # the local replica in stale mode (http.py injects
                    # ?stale and stamps X-Nomad-Degraded) — a bounded-
                    # staleness answer beats a 429 when state exists.
                    return "stale"
                self._reject_http()
                raise AdmissionRejected(
                    429, "read rate limited (pressure red)",
                    max(retry, 0.05))
        return None

    def _has_replica_state(self) -> bool:
        """True when this server holds a replica snapshot worth serving
        stale reads from. The getattr chain tolerates the stub servers
        tests hand to AdmissionController (no fsm → old 429 path)."""
        state = getattr(getattr(self._server, "fsm", None), "state", None)
        if state is None:
            return False
        try:
            return state.latest_index() > 0
        except Exception:  # noqa: BLE001
            return False

    def check_rpc(self, kind: str) -> None:
        """Admission gate for one transport RPC frame. Raft consensus
        and leader-forward kinds are exempt unconditionally."""
        if not self.enabled or kind in RPC_EXEMPT_KINDS:
            return
        level = self._level()
        if level == LEVEL_GREEN:
            return
        if level == LEVEL_RED:
            with self._lock:
                self.rpc_rejected += 1
            metrics.incr_counter(("admission", "rpc_rejected"))
            raise AdmissionRejected(
                503, f"server overloaded (pressure red): rpc "
                     f"{kind!r} shed", self.red_retry_after)
        ok, retry = self._write.try_acquire()
        if not ok:
            with self._lock:
                self.rpc_rejected += 1
            metrics.incr_counter(("admission", "rpc_rejected"))
            raise AdmissionRejected(
                429, f"rpc {kind!r} rate limited (pressure yellow)",
                max(retry, 0.05))

    def _reject_http(self) -> None:
        with self._lock:
            self.http_rejected += 1
        metrics.incr_counter(("admission", "http_rejected"))

    # ----------------------------------------------------- observation

    def snapshot(self) -> dict:
        with self._lock:
            http_rejected = self.http_rejected
            rpc_rejected = self.rpc_rejected
            forced = self._forced_level
        out = {
            "enabled": self.enabled,
            "pressure": self.pressure.snapshot(),
            "write_bucket": self._write.stats(),
            "read_bucket": self._read.stats(),
            "http_rejected": http_rejected,
            "rpc_rejected": rpc_rejected,
        }
        if forced is not None:
            out["forced_level"] = forced
        return out
