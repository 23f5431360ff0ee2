"""Remote-leader client: follower→leader forwarding over HTTP.

Reference: rpc.go:178 `forward` — workers and endpoints on a follower
route leader-only operations (eval broker dequeue/ack/nack, plan
submit, heartbeat timers) to the current leader. The reference pipes
them over its msgpack RPC; here they ride the same HTTP substrate as
everything else, on internal /v1/internal/* routes the leader serves.

The port of the JAX package's server/leader_client.py, on the port's
structs, codec, backoff and keep-alive pool. It speaks the HTTP API's
internal routes, which the port's ``api.HTTPServer`` and the JAX
package's serve alike.
"""

from __future__ import annotations

import json
from typing import List, Optional, Tuple

from ..structs import Evaluation, Plan, PlanResult
from ..utils.backoff import Backoff
from ..utils.codec import from_dict, to_dict
from ..utils.httppool import HTTPPool, PoolError


class LeaderUnavailableError(Exception):
    pass


class RemoteLeader:
    """Leader-only operations executed on a remote leader.

    Rides a keep-alive pool (pool.go:144): a follower's workers
    dequeue/ack/submit against the leader on a handful of persistent
    sockets instead of a TCP handshake per RPC. The pool is
    per-instance (the server caches one RemoteLeader per leader addr):
    a process-wide pool keyed by address could hand a NEW leader's
    client a socket opened to a previous process on a reused port."""

    def __init__(self, addr: str, timeout: float = 10.0,
                 ssl_context=None):
        self.addr = addr.rstrip("/")
        self.timeout = timeout
        # The dequeue long-poll passes per-call timeouts above
        # self.timeout; size the pool's ceiling for those.
        # ssl_context: the cluster client context when the HTTP API
        # runs under TLS — without it every follower->leader forward
        # would fail verification against the cluster CA.
        self._pool = HTTPPool(self.addr, timeout=120.0,
                              ssl_context=ssl_context)

    def _call(self, path: str, body: dict, timeout: Optional[float] = None,
              retryable: bool = True):
        """One leader RPC. `retryable` ops ride a short jittered
        backoff through transport-level failures (a leader restart's
        refused-connection window): every /v1/internal mutation is
        token-guarded — a duplicate ack/nack after a lost response is
        REJECTED by the broker, never double-applied — so at-least-once
        retry only converts 'leader briefly gone' from an error into
        latency. Non-retryable: the long-poll dequeue (its wait budget
        is the caller's) and plan submit (at-most-once by contract; the
        conflict machinery owns its retries)."""
        bo = Backoff(base=0.05, max_delay=0.4, attempts=2)
        while True:
            try:
                status, _headers, payload = self._pool.request(
                    "PUT", path, body=json.dumps(body).encode(),
                    headers={"Content-Type": "application/json"},
                    timeout=timeout or self.timeout,
                )
            except PoolError as e:
                if retryable and bo.sleep():
                    continue
                raise LeaderUnavailableError(str(e)) from None
            if status >= 400:
                try:
                    message = json.loads(payload).get("error", "")
                except Exception:  # noqa: BLE001
                    message = payload.decode(errors="replace")
                raise LeaderUnavailableError(message or f"HTTP {status}")
            return json.loads(payload or b"null")

    # ------------------------------------------------------------ evals

    def eval_dequeue(self, schedulers: List[str],
                     timeout: float) -> Tuple[Optional[Evaluation], str]:
        out = self._call(
            "/v1/internal/eval/dequeue",
            {"schedulers": schedulers, "timeout": timeout},
            timeout=timeout + 10.0,
            retryable=False,  # long-poll: the wait budget is the caller's
        )
        ev = from_dict(Evaluation, out.get("eval")) if out.get("eval") else None
        return ev, out.get("token", "")

    def eval_dequeue_many(
        self, schedulers: List[str], max_n: int
    ) -> List[Tuple[Evaluation, str]]:
        out = self._call(
            "/v1/internal/eval/dequeue-many",
            {"schedulers": schedulers, "max_n": max_n},
        )
        return [
            (from_dict(Evaluation, item["eval"]), item.get("token", ""))
            for item in out.get("evals") or []
        ]

    def eval_ack(self, eval_id: str, token: str) -> None:
        self._call("/v1/internal/eval/ack",
                   {"eval_id": eval_id, "token": token})

    def eval_nack(self, eval_id: str, token: str) -> None:
        self._call("/v1/internal/eval/nack",
                   {"eval_id": eval_id, "token": token})

    def eval_pause_nack(self, eval_id: str, token: str) -> None:
        self._call("/v1/internal/eval/pause-nack",
                   {"eval_id": eval_id, "token": token})

    def eval_resume_nack(self, eval_id: str, token: str) -> None:
        self._call("/v1/internal/eval/resume-nack",
                   {"eval_id": eval_id, "token": token})

    def eval_outstanding(self, eval_id: str) -> Optional[str]:
        out = self._call("/v1/internal/eval/outstanding",
                         {"eval_id": eval_id})
        return out.get("token") or None

    # ------------------------------------------------------------ plans

    def plan_submit(self, plan: Plan) -> PlanResult:
        out = self._call("/v1/internal/plan/submit",
                         {"plan": to_dict(plan)}, timeout=40.0,
                         retryable=False)  # at-most-once by contract
        return from_dict(PlanResult, out["result"])

    # ------------------------------------------------------- heartbeats

    def heartbeat_reset(self, node_id: str) -> float:
        out = self._call("/v1/internal/heartbeat/reset",
                         {"node_id": node_id})
        return float(out.get("ttl", 0.0))
