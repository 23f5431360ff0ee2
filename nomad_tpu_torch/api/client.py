"""Python SDK mirroring the HTTP API.

Reference: api/ (Go SDK, api.go:140 NewClient + per-resource clients),
including blocking-query support (QueryOptions:20).

The port of the JAX package's api/client.py on the port's structs,
codec and keep-alive pool. The alloc filesystem and client stats
clients (``AllocFS``, ``ClientStats``) call only /v1/client/* routes,
which need the client agent, and are not carried yet.
"""

from __future__ import annotations

import json
import threading
import urllib.parse
from typing import Any, Dict, List, Optional, Tuple

from ..structs import Allocation, Evaluation, Job, Node
from ..utils.codec import from_dict, to_dict
from ..utils.httppool import HTTPPool, PoolError


class APIError(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(f"{status}: {message}")
        self.status = status


class Client:
    def __init__(self, address: str, timeout: float = 305.0, region: str = "",
                 ssl_context=None, consistency: str = "default"):
        self.timeout = timeout
        # Read-consistency mode stamped on every query (api.go
        # QueryOptions.AllowStale): "stale" serves the contacted
        # replica's local state immediately (X-Nomad-LastContact
        # bounds the staleness), "consistent" makes a follower catch
        # up to the leader's commit index first, "default" keeps the
        # server's standard semantics. Per-call override via
        # _query_params(stale=/consistent=).
        if consistency not in ("default", "stale", "consistent"):
            raise ValueError(f"unknown consistency mode {consistency!r}")
        self.consistency = consistency
        self._ssl_context = ssl_context
        self._address = ""
        self._addr_lock = threading.Lock()
        self.pool: Optional[HTTPPool] = None
        # Keep-alive pool (pool.go:144): sequential requests — above
        # all the blocking-query wakeup loop — reuse one socket instead
        # of a TCP handshake per call. Assigning .address (the client
        # agent's rpc-failover path does this live) swaps the pool.
        self.address = address
        # Target region: forwarded server-side when it differs from the
        # contacted agent's region (api.go QueryOptions.Region).
        self.region = region
        self.jobs = Jobs(self)
        self.nodes = Nodes(self)
        self.allocations = Allocations(self)
        self.evaluations = Evaluations(self)
        self.system = System(self)
        self.agent = Agent(self)
        self.regions = Regions(self)

    # ------------------------------------------------------------------

    @property
    def address(self) -> str:
        return self._address

    @address.setter
    def address(self, value: str) -> None:
        value = value.rstrip("/")
        # Locked: concurrent failovers (heartbeat loop + alloc watcher
        # both call _rpc_failed) must never leave _address naming one
        # server while the pool dials another — the early-return guard
        # would then pin the client to the wrong server forever.
        with self._addr_lock:
            if value == self._address and self.pool is not None:
                return
            old = self.pool
            self._address = value
            self.pool = HTTPPool(value, timeout=self.timeout,
                                 ssl_context=self._ssl_context)
        if old is not None:
            old.close()

    def _path_with_params(self, path: str, params) -> str:
        if self.region:
            if isinstance(params, list):
                if not any(k == "region" for k, _ in params):
                    params = params + [("region", self.region)]
            else:
                params = dict(params or {})
                params.setdefault("region", self.region)
        mode = self.consistency
        if mode in ("stale", "consistent"):
            if isinstance(params, list):
                if not any(k == mode for k, _ in params):
                    params = params + [(mode, "true")]
            else:
                params = dict(params or {})
                params.setdefault(mode, "true")
        if params:
            path += "?" + urllib.parse.urlencode(params)
        return path

    def _raw_request(self, method: str, path: str, body: Any = None,
                     params=None) -> Tuple[bytes, Dict[str, str]]:
        path = self._path_with_params(path, params)
        data = json.dumps(body).encode() if body is not None else None
        # Blocking queries can legitimately hold the line for the full
        # `wait`; wait= is in the path but the pool needs the socket
        # timeout to outlast it, which self.timeout (305s default) does.
        try:
            status, headers, payload = self.pool.request(
                method, path, body=data,
                headers={"Content-Type": "application/json"})
        except PoolError as e:
            raise APIError(
                0, f"failed to reach agent at {self.address}: {e}"
            ) from None
        if status >= 400:
            try:
                message = json.loads(payload).get("error", "")
            except Exception:  # noqa: BLE001
                message = payload.decode(errors="replace")
            raise APIError(status, message or f"HTTP {status}")
        return payload, headers

    def _request(
        self,
        method: str,
        path: str,
        body: Any = None,
        params: Optional[Dict[str, str]] = None,
    ) -> Tuple[Any, int]:
        payload, headers = self._raw_request(method, path, body, params)
        # Case-insensitive: proxies/HTTP2 gateways lowercase header
        # names, and a missed index would turn every blocking query
        # into a silent busy-poll.
        index = 0
        for k, v in headers.items():
            if k.lower() == "x-nomad-index":
                index = int(v or 0)
                break
        return json.loads(payload or b"null"), index

    def get(self, path: str, params: Optional[Dict] = None) -> Tuple[Any, int]:
        return self._request("GET", path, params=params)

    def get_raw(self, path: str, params: Optional[Dict] = None) -> bytes:
        """GET returning raw bytes (the metrics exposition, the chrome
        trace document)."""
        payload, _ = self._raw_request("GET", path, params=params)
        return payload

    def put(self, path: str, body: Any = None, params: Optional[Dict] = None):
        return self._request("PUT", path, body=body, params=params)

    def delete(self, path: str) -> Tuple[Any, int]:
        return self._request("DELETE", path)


def _query_params(index: Optional[int], wait: Optional[float],
                  stale: bool = False,
                  consistent: bool = False) -> Dict[str, str]:
    params: Dict[str, str] = {}
    if index is not None:
        params["index"] = str(index)
    if wait is not None:
        params["wait"] = str(wait)
    if stale:
        params["stale"] = "true"
    if consistent:
        params["consistent"] = "true"
    return params


class Jobs:
    def __init__(self, client: Client):
        self.c = client

    def register(self, job: Job) -> str:
        out, _ = self.c.put("/v1/jobs", {"job": to_dict(job)})
        return out["eval_id"]

    def enforce_register(self, job: Job, modify_index: int) -> str:
        """Register gated on the job-modify index (api/jobs.go:49-58)."""
        out, _ = self.c.put("/v1/jobs", {
            "job": to_dict(job),
            "enforce_index": True,
            "job_modify_index": modify_index,
        })
        return out["eval_id"]

    def list(self, index: Optional[int] = None, wait: Optional[float] = None):
        return self.c.get("/v1/jobs", _query_params(index, wait))

    def info(self, job_id: str, index: Optional[int] = None,
             wait: Optional[float] = None) -> Tuple[Job, int]:
        out, idx = self.c.get(f"/v1/job/{job_id}", _query_params(index, wait))
        return from_dict(Job, out), idx

    def deregister(self, job_id: str) -> str:
        out, _ = self.c.delete(f"/v1/job/{job_id}")
        return out["eval_id"]

    def allocations(self, job_id: str, index: Optional[int] = None,
                    wait: Optional[float] = None):
        return self.c.get(f"/v1/job/{job_id}/allocations", _query_params(index, wait))

    def evaluations(self, job_id: str):
        out, idx = self.c.get(f"/v1/job/{job_id}/evaluations")
        return [from_dict(Evaluation, e) for e in out], idx

    def evaluate(self, job_id: str) -> str:
        out, _ = self.c.put(f"/v1/job/{job_id}/evaluate")
        return out["eval_id"]

    def plan(self, job: Job, diff: bool = False, contextual: bool = False) -> dict:
        out, _ = self.c.put(
            f"/v1/job/{job.id}/plan",
            {"job": to_dict(job), "diff": diff, "contextual": contextual},
        )
        return out

    def periodic_force(self, job_id: str) -> str:
        out, _ = self.c.put(f"/v1/job/{job_id}/periodic/force")
        return out["child_job_id"]

    def summary(self, job_id: str):
        return self.c.get(f"/v1/job/{job_id}/summary")


class Nodes:
    def __init__(self, client: Client):
        self.c = client

    def list(self, index: Optional[int] = None, wait: Optional[float] = None):
        return self.c.get("/v1/nodes", _query_params(index, wait))

    def info(self, node_id: str) -> Tuple[Node, int]:
        out, idx = self.c.get(f"/v1/node/{node_id}")
        return from_dict(Node, out), idx

    def allocations(self, node_id: str, secret: str = "",
                    index: Optional[int] = None, wait: Optional[float] = None):
        params = _query_params(index, wait)
        if secret:
            params["secret"] = secret
        out, idx = self.c.get(f"/v1/node/{node_id}/allocations", params)
        return [from_dict(Allocation, a) for a in out], idx

    def drain(self, node_id: str, drain: bool = True) -> None:
        self.c.put(f"/v1/node/{node_id}/drain", {"drain": drain})

    def register(self, node: Node) -> float:
        out, _ = self.c.put(f"/v1/node/{node.id}/register", {"node": to_dict(node)})
        return out["heartbeat_ttl"]

    def heartbeat(self, node_id: str, secret_id: str = "") -> float:
        out, _ = self.c.put(
            f"/v1/node/{node_id}/heartbeat", {"secret_id": secret_id}
        )
        return out["heartbeat_ttl"]

    def update_status(self, node_id: str, status: str) -> float:
        out, _ = self.c.put(f"/v1/node/{node_id}/status", {"status": status})
        return out["heartbeat_ttl"]

    def update_allocs(self, node_id: str, allocs: List[Allocation]) -> int:
        out, _ = self.c.put(
            f"/v1/node/{node_id}/allocs",
            {"allocs": [to_dict(a) for a in allocs]},
        )
        return out["index"]


class Allocations:
    def __init__(self, client: Client):
        self.c = client

    def list(self, index: Optional[int] = None, wait: Optional[float] = None):
        return self.c.get("/v1/allocations", _query_params(index, wait))

    def info(self, alloc_id: str, index: Optional[int] = None,
             wait: Optional[float] = None) -> Tuple[Allocation, int]:
        out, idx = self.c.get(
            f"/v1/allocation/{alloc_id}", _query_params(index, wait))
        return from_dict(Allocation, out), idx


class Evaluations:
    def __init__(self, client: Client):
        self.c = client

    def list(self):
        out, idx = self.c.get("/v1/evaluations")
        return [from_dict(Evaluation, e) for e in out], idx

    def info(self, eval_id: str, index: Optional[int] = None,
             wait: Optional[float] = None) -> Tuple[Evaluation, int]:
        out, idx = self.c.get(f"/v1/evaluation/{eval_id}", _query_params(index, wait))
        return from_dict(Evaluation, out), idx

    def allocations(self, eval_id: str):
        return self.c.get(f"/v1/evaluation/{eval_id}/allocations")


class System:
    def __init__(self, client: Client):
        self.c = client

    def garbage_collect(self) -> None:
        self.c.put("/v1/system/gc")


class Agent:
    def __init__(self, client: Client):
        self.c = client

    def self(self) -> dict:
        out, _ = self.c.get("/v1/agent/self")
        return out

    def leader(self) -> str:
        out, _ = self.c.get("/v1/status/leader")
        return out

    def members(self) -> List[dict]:
        out, _ = self.c.get("/v1/agent/members")
        return out

    def join(self, addrs: List[str]) -> int:
        out, _ = self.c.put(
            "/v1/agent/join", params=[("address", a) for a in addrs]
        )
        return out["num_joined"]

    def force_leave(self, name: str) -> None:
        self.c.put("/v1/agent/force-leave", params={"node": name})

    def servers(self) -> List[str]:
        out, _ = self.c.get("/v1/agent/servers")
        return out


class Regions:
    """Region listing (api/regions.go)."""

    def __init__(self, client: Client):
        self.c = client

    def list(self) -> List[str]:
        out, _ = self.c.get("/v1/regions")
        return out
