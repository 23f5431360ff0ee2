"""Keep-alive HTTP connection pool.

Reference: nomad/pool.go:144 (ConnPool) — the reference keeps one
yamux-multiplexed TCP connection per server pair and every RPC
(including long-poll blocking queries) rides a stream on it, so a 10k
client cluster holds 10k sockets, not 10k reconnects per heartbeat
interval. HTTP/1.1 has no stream multiplexing, so the equivalent
here is a keep-alive pool: one socket per CONCURRENT request,
reused across sequential requests (a blocking-query wakeup loop runs
on a single socket forever). TLS (task: rpc.go:23-30 rpcTLS) slots in
via the `ssl_context` parameter.
"""

from __future__ import annotations

import http.client
import select
import socket
import ssl
import threading
import urllib.parse
from typing import Dict, List, Optional, Tuple


class PoolError(Exception):
    """Transport-level failure (unreachable, reset mid-request)."""


class HTTPPool:
    """Connection pool for one base address (scheme://host:port).

    request() checks a connection out of the idle list (or dials), runs
    one request/response cycle on it, and returns it if the response
    permits reuse. A request that fails on a POOLED connection is
    retried once on a fresh dial: the server may have closed the idle
    socket between our requests (keep-alive race) — indistinguishable
    from a dead server except by redialling.
    """

    def __init__(self, address: str, timeout: float = 305.0,
                 max_idle: int = 8,
                 ssl_context: Optional[ssl.SSLContext] = None):
        parsed = urllib.parse.urlsplit(address)
        self.scheme = parsed.scheme or "http"
        self.host = parsed.hostname or "127.0.0.1"
        self.port = parsed.port or (443 if self.scheme == "https" else 80)
        self.timeout = timeout
        self.max_idle = max_idle
        self.ssl_context = ssl_context
        self._idle: List[http.client.HTTPConnection] = []
        self._lock = threading.Lock()
        self._dials = 0  # sockets ever opened (observability/tests)
        self._closed = False

    # ------------------------------------------------------------ conns

    def _dial(self, timeout: float) -> http.client.HTTPConnection:
        with self._lock:
            self._dials += 1
        if self.scheme == "https":
            ctx = self.ssl_context
            if ctx is None:
                ctx = ssl.create_default_context()
            return http.client.HTTPSConnection(
                self.host, self.port, timeout=timeout, context=ctx)
        return http.client.HTTPConnection(
            self.host, self.port, timeout=timeout)

    def _checkout(self, timeout: float) -> Tuple[http.client.HTTPConnection, bool]:
        """Returns (conn, pooled): pooled connections get one retry."""
        with self._lock:
            while self._idle:
                conn = self._idle.pop()
                try:
                    # Timeouts are per-request (blocking queries pass
                    # their own); update the live socket too.
                    conn.timeout = timeout
                    if conn.sock is not None:
                        conn.sock.settimeout(timeout)
                        # A healthy idle HTTP socket has nothing to
                        # read; readable means the peer closed (EOF) or
                        # broke framing. Detecting it HERE matters for
                        # non-idempotent requests, which are never
                        # retried after their bytes go out. poll, not
                        # select: select() rejects fds >= FD_SETSIZE
                        # (1024), which a busy agent exceeds.
                        poller = select.poll()
                        poller.register(conn.sock, select.POLLIN)
                        if poller.poll(0):
                            conn.close()
                            continue
                except OSError:
                    conn.close()  # socket died while idle; skip it
                    continue
                return conn, True
        return self._dial(timeout), False

    def _checkin(self, conn: http.client.HTTPConnection) -> None:
        with self._lock:
            # A request in flight when close() ran must not park its
            # socket in a pool nobody will drain again (the SDK swaps
            # pools on address change mid-request).
            if not self._closed and len(self._idle) < self.max_idle:
                self._idle.append(conn)
                return
        conn.close()

    @property
    def dials(self) -> int:
        with self._lock:
            return self._dials

    def close(self) -> None:
        with self._lock:
            self._closed = True
            idle, self._idle = self._idle, []
        for conn in idle:
            conn.close()

    # --------------------------------------------------------- requests

    def request(
        self,
        method: str,
        path: str,
        body: Optional[bytes] = None,
        headers: Optional[Dict[str, str]] = None,
        timeout: Optional[float] = None,
    ) -> Tuple[int, Dict[str, str], bytes]:
        """One request/response cycle; returns (status, headers, body).

        The response body is always fully read (framing: the next
        request on this socket must start clean)."""
        t = self.timeout if timeout is None else timeout
        attempts = 0
        while True:
            conn, pooled = self._checkout(t)
            sent = False
            try:
                conn.request(method, path, body=body, headers=headers or {})
                sent = True
                resp = conn.getresponse()
                payload = resp.read()
            except (http.client.HTTPException, ConnectionError,
                    socket.timeout, TimeoutError, OSError) as e:
                conn.close()
                # A stale pooled socket fails instantly on first use —
                # retry once on a fresh dial. ONLY when that cannot
                # double-execute the request: either the request bytes
                # never went out (server can't have acted), or the
                # method is idempotent (GET). A PUT that failed after
                # send may have been applied (plan submit, job
                # register) — re-sending it would turn at-most-once
                # RPCs into at-least-once; let the caller decide.
                # Timeouts burned the caller's wait budget: never retry.
                is_timeout = isinstance(e, (socket.timeout, TimeoutError))
                retryable = (not sent) or method in ("GET", "HEAD")
                if pooled and attempts == 0 and retryable and not is_timeout:
                    attempts += 1
                    continue
                raise PoolError(
                    f"{method} {self.scheme}://{self.host}:{self.port}"
                    f"{path}: {e}") from e
            resp_headers = dict(resp.getheaders())
            if resp.will_close:
                conn.close()
            else:
                self._checkin(conn)
            return resp.status, resp_headers, payload


