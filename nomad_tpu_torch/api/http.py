"""HTTP API: /v1/* routes with blocking-query support.

Reference: command/agent/http.go:103-138 (routes) and the blocking-query
protocol (rpc.go:334 blockingRPC): `?index=N&wait=Ns` long-polls until
the watched scope passes index N or the wait expires; responses carry
X-Nomad-Index.

The port of the JAX package's api/http.py over the port's Server, read
mux, admission controller, flight recorder and profiler. The client
agent is not carried yet: the /v1/client/* routes answer 501, as the
JAX server does with no client attached, and the server is required.
"""

from __future__ import annotations

import json
import logging
import re
import socket
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, List, Optional, Tuple

from ..admission import AdmissionRejected
from ..state import watch
from ..structs import Allocation, Job, Node, Plan
from ..utils import metrics
from ..utils.codec import from_dict, to_dict

MAX_BLOCKING_WAIT = 300.0  # rpc.go:34
DEFAULT_BLOCKING_WAIT = 300.0


class HTTPError(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status
        self.message = message


class JSONResponse:
    """JSON reply carrying an explicit X-Nomad-Index and extra headers
    — how blocking reads report their watch SCOPE's modify index (not
    the global raft index) plus staleness / effective-wait headers
    through _dispatch. index=None falls back to the global index."""

    __slots__ = ("body", "index", "headers")

    def __init__(self, body, index: Optional[int] = None, headers=None):
        self.body = body
        self.index = index
        self.headers = dict(headers) if headers else {}


class _ParkSignal(Exception):
    """Raised out of _blocking to hand a long-poll to the read mux:
    _dispatch catches it, registers the continuation (readplane/
    mux.py), and detaches the client socket so the handler thread can
    exit — a parked watcher holds no thread. Falls back to the
    thread-parking loop when the mux refuses (full or stopped)."""

    def __init__(self, items, min_index: int, deadline: float, run,
                 headers):
        super().__init__("blocking query parked")
        self.items = items
        self.min_index = min_index
        self.deadline = deadline
        self.run = run
        self.headers = headers


def _qflag(query, name: str) -> bool:
    """True when `?name` is present bare or with a truthy value (both
    `?stale` and `?stale=true` select the mode, like the reference)."""
    if name not in query:
        return False
    v = query[name][0]
    return v == "" or v.lower() in ("1", "true")


class RawResponse:
    """Non-JSON reply (file contents for the fs endpoints). A non-None
    index overrides the X-Nomad-Index header (used by cross-region
    forwarding so the remote region's index is preserved).

    `stream` (mutually exclusive with `data`) is a callable taking a
    writable file-like; the reply goes out chunked as the callable
    writes, so arbitrarily large payloads — the sticky-disk snapshot
    tar (alloc_dir.go Snapshot streams it in the reference) — never
    materialize in server memory."""

    def __init__(self, data: bytes = b"",
                 content_type: str = "application/octet-stream",
                 index: Optional[int] = None, stream=None):
        self.data = data
        self.content_type = content_type
        self.index = index
        self.stream = stream


class _ChunkedWriter:
    """Wraps the raw socket file in HTTP/1.1 chunked framing."""

    def __init__(self, wfile):
        self._w = wfile

    def write(self, data: bytes) -> int:
        if not data:
            return 0
        self._w.write(f"{len(data):x}\r\n".encode())
        self._w.write(data)
        self._w.write(b"\r\n")
        return len(data)

    def finish(self) -> None:
        self._w.write(b"0\r\n\r\n")


class HTTPServer:
    """Embeds the server; serves the public API on localhost. The
    /v1/client/* fs + stats endpoints (command/agent/fs_endpoint.go)
    answer 501: no client agent is attached."""

    def __init__(self, server, host: str = "127.0.0.1", port: int = 0,
                 enable_debug: bool = False,
                 ssl_context=None, forward_ssl_context=None):
        self.server = server
        self.logger = logging.getLogger("nomad_tpu_torch.http")
        # TLS termination (agent tls block; reference EnableHTTP,
        # nomad/structs/config/tls.go). The handshake happens in the
        # per-connection handler thread (Handler.setup), never in the
        # accept loop. forward_ssl_context is the CLIENT side for
        # cross-region proxying to https peers (verified against the
        # cluster CA, not system CAs).
        self.ssl_context = ssl_context
        self.forward_ssl_context = forward_ssl_context
        # Gates the /debug/* introspection routes (the reference gates
        # pprof the same way, command/agent/http.go:135 enableDebug).
        self.enable_debug = enable_debug
        api = self

        # Accepted-TCP-connection count: with keep-alive clients this
        # should track concurrent clients, not total requests (the
        # pool.go:144 property the SDK pool restores).
        self.connections_accepted = 0
        self._conn_count_lock = threading.Lock()

        # Raw-socket ids of connections handed to the read mux: the
        # handler thread exits while the continuation owns the socket,
        # so socketserver's per-request close must be skipped — one
        # skip CREDIT per park, consumed by shutdown_request. A
        # counter, not a set: a served keep-alive connection is resumed
        # via process_request and can park AGAIN before the previous
        # handler thread reaches its shutdown hook, so two credits must
        # coexist. Keyed by the PRE-TLS socket — that is the object
        # socketserver closes. _resumed marks sockets re-entering the
        # server after a parked serve (skip the accept count; under TLS
        # carry the live wrapped socket so setup() doesn't re-handshake).
        self._detached: dict = {}
        self._resumed: dict = {}
        self._detached_lock = threading.Lock()

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            # Idle keep-alive connections must not pin handler threads
            # forever: readline times out, handle_one_request closes
            # the connection. Above MAX_BLOCKING_WAIT so a parked
            # long-poll (which blocks in the handler, not in readline)
            # is never cut short.
            timeout = MAX_BLOCKING_WAIT + 30.0

            def setup(self):
                with api._detached_lock:
                    resumed = id(self.request) in api._resumed
                    wrapped = api._resumed.pop(id(self.request), None)
                if not resumed:
                    # A resumed connection (back from a parked serve)
                    # is NOT a new accept.
                    with api._conn_count_lock:
                        api.connections_accepted += 1
                # Captured BEFORE any TLS wrap: _Server.shutdown_request
                # closes this exact object, so the detached-socket
                # protocol must key on it (the wrapped socket is a
                # different Python object).
                self._raw_request = self.request
                self._nomad_parked = False
                if api.ssl_context is not None and wrapped is not None:
                    # The TLS session on a resumed socket is live:
                    # re-wrapping would force a second handshake on an
                    # established stream. Reuse the wrapped object.
                    self.request = wrapped
                    self.connection = wrapped
                elif api.ssl_context is not None:
                    # Bound the handshake: Handler.timeout only lands
                    # in super().setup(), and an unbounded wrap lets a
                    # connect-and-say-nothing client pin this thread.
                    # A failed handshake (plaintext probe, bad cert)
                    # raises here; _Server.handle_error swallows it
                    # quietly and socketserver closes the connection.
                    self.request.settimeout(self.timeout)
                    self.request = api.ssl_context.wrap_socket(
                        self.request, server_side=True)
                    self.connection = self.request
                super().setup()

            def log_message(self, fmt, *args):
                pass

            def _dispatch(self):
                _start = time.monotonic()
                # Set by api.handle when a route matches; a single
                # undifferentiated ("http", "request") sample mixed
                # every route into one meaningless distribution — the
                # histogram percentiles only mean something per
                # (method, route).
                self.nomad_route = "unmatched"
                try:
                    body = api.handle(self)
                except _ParkSignal as sig:
                    # The blocking query wants to park: hand the
                    # continuation to the read mux and detach the
                    # socket. Mux full/stopped → classic thread-park.
                    try:
                        if api._park_handler(self, sig):
                            self._nomad_parked = True
                            self.close_connection = True
                        else:
                            self._reply_body(api._blocking_threadpark(
                                sig.items, sig.min_index, sig.deadline,
                                sig.run, sig.headers, True))
                    except HTTPError as e:
                        self._reply(e.status, {"error": e.message})
                    except Exception as e:  # noqa: BLE001
                        self._reply(500, {"error": str(e)})
                except AdmissionRejected as e:
                    # Overload shed/limit (nomad_tpu/admission): a
                    # machine-readable Retry-After so well-behaved
                    # clients adapt their cadence instead of hammering.
                    self._reply(
                        e.status,
                        {"error": e.message,
                         "retry_after": round(e.retry_after, 3)},
                        headers={"Retry-After": f"{e.retry_after:.3f}"})
                except HTTPError as e:
                    self._reply(e.status, {"error": e.message})
                except (ValueError, PermissionError) as e:
                    status = 403 if isinstance(e, PermissionError) else 400
                    self._reply(status, {"error": str(e)})
                except Exception as e:  # noqa: BLE001
                    self._reply(500, {"error": str(e)})
                else:
                    self._reply_body(body)
                metrics.measure_since(
                    ("http", "request", self.command, self.nomad_route),
                    _start)

            def _reply_body(self, body):
                """200 reply with the right X-Nomad-Index: a
                JSONResponse carries its scope index (and extra
                headers); everything else gets the global index."""
                headers = None
                index = None
                if isinstance(body, JSONResponse):
                    index = body.index
                    headers = body.headers or None
                    body = body.body
                if index is None:
                    index = api.server.fsm.state.latest_index()
                self._reply(200, body, index, headers=headers)

            def finish(self):
                if self._nomad_parked:
                    # The parked continuation owns the socket now: do
                    # not flush or close it — but DO drop rfile/wfile,
                    # whose makefile io-refs would otherwise keep the
                    # fd open after the continuation's conn.close()
                    # (nothing was written, so closing flushes nothing).
                    for f in (self.wfile, self.rfile):
                        try:
                            f.close()
                        except OSError:
                            pass
                    return
                super().finish()

            def _reply(self, status, body, index=None, headers=None):
                stream = None
                if isinstance(body, RawResponse):
                    data, ctype, stream = body.data, body.content_type, body.stream
                    if body.index is not None:
                        index = body.index
                else:
                    data, ctype = json.dumps(body).encode(), "application/json"
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                for name, value in (headers or {}).items():
                    self.send_header(name, value)
                if stream is None:
                    self.send_header("Content-Length", str(len(data)))
                else:
                    self.send_header("Transfer-Encoding", "chunked")
                if index is not None:
                    self.send_header("X-Nomad-Index", str(index))
                self.end_headers()
                if stream is None:
                    self.wfile.write(data)
                else:
                    # Headers are already on the wire: if the stream
                    # callable dies mid-body (snapshot tar read error,
                    # log file rotated away) the chunked response is
                    # unterminated and the connection must not be
                    # reused — bound the damage to THIS connection.
                    try:
                        w = _ChunkedWriter(self.wfile)
                        stream(w)
                        w.finish()
                    except ConnectionError:
                        # Client hung up mid-stream (normal for a
                        # log-follow Ctrl-C) — not a server error.
                        api.logger.debug(
                            "stream client disconnected: %s", self.path)
                        self.close_connection = True
                    except Exception:  # noqa: BLE001
                        api.logger.exception(
                            "stream response truncated: %s", self.path)
                        self.close_connection = True

            do_GET = do_PUT = do_POST = do_DELETE = _dispatch

        class _Server(ThreadingHTTPServer):
            daemon_threads = True
            # socketserver's default listen backlog is 5: a burst of
            # clients (re)connecting — agent restart, failover — would
            # see connect timeouts. 10k-node clusters reconnect in
            # herds; give the accept queue real depth.
            request_queue_size = 512

            def handle_error(self, request, client_address):
                # TLS handshake failures (plaintext probes, health
                # checkers hitting the https port, cert mismatches) are
                # the CLIENT's problem — don't traceback-spam stderr
                # per probe the way the default handler does.
                import ssl as _ssl
                import sys as _sys

                exc = _sys.exc_info()[1]
                if isinstance(exc, (_ssl.SSLError, ConnectionError,
                                    TimeoutError, OSError)):
                    api.logger.debug(
                        "connection error from %s: %s", client_address,
                        exc)
                    return
                super().handle_error(request, client_address)

            def shutdown_request(self, request):
                # Detached-socket protocol: each park banks exactly one
                # close-skip credit (registered strictly before the
                # handler returns — handle() runs inside the handler
                # constructor) and each handler exit consumes at most
                # one, keeping the table self-cleaning.
                with api._detached_lock:
                    n = api._detached.get(id(request), 0)
                    if n:
                        if n == 1:
                            del api._detached[id(request)]
                        else:
                            api._detached[id(request)] = n - 1
                        return
                super().shutdown_request(request)

        self._httpd = _Server((host, port), Handler)
        self.port = self._httpd.server_address[1]
        scheme = "https" if ssl_context is not None else "http"
        self.addr = f"{scheme}://{host}:{self.port}"
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="http-api", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()

    # ------------------------------------------------------------------

    def handle(self, req) -> Any:
        parsed = urllib.parse.urlparse(req.path)
        path = parsed.path.rstrip("/")
        # keep_blank_values: the consistency flags are bare in the
        # reference API (`?stale`, `?consistent`) and parse_qs drops
        # valueless keys by default.
        query = urllib.parse.parse_qs(parsed.query, keep_blank_values=True)
        method = req.command
        body = None
        length = int(req.headers.get("Content-Length") or 0)
        if length:
            body = json.loads(req.rfile.read(length))

        # Cross-region forwarding (rpc.go:178,263 forwardRegion): if the
        # request names another region, proxy it to a server there.
        region = query.get("region", [None])[0]
        if region and region != self.server.config.region:
            return self._forward_region(region, method, parsed, body, req)

        route_handlers: List[Tuple[str, Callable]] = [
            (r"^/v1/regions$", self._regions),
            (r"^/v1/agent/members$", self._agent_members),
            (r"^/v1/agent/join$", self._agent_join),
            (r"^/v1/agent/force-leave$", self._agent_force_leave),
            (r"^/v1/agent/servers$", self._agent_servers),
            (r"^/v1/jobs$", self._jobs),
            (r"^/v1/job/(?P<job_id>[^/]+)$", self._job),
            (r"^/v1/job/(?P<job_id>[^/]+)/allocations$", self._job_allocations),
            (r"^/v1/job/(?P<job_id>[^/]+)/evaluations$", self._job_evaluations),
            (r"^/v1/job/(?P<job_id>[^/]+)/evaluate$", self._job_evaluate),
            (r"^/v1/job/(?P<job_id>[^/]+)/plan$", self._job_plan),
            (r"^/v1/job/(?P<job_id>[^/]+)/periodic/force$", self._job_periodic_force),
            (r"^/v1/job/(?P<job_id>[^/]+)/summary$", self._job_summary),
            (r"^/v1/nodes$", self._nodes),
            (r"^/v1/node/(?P<node_id>[^/]+)$", self._node),
            (r"^/v1/node/(?P<node_id>[^/]+)/allocations$", self._node_allocations),
            (r"^/v1/node/(?P<node_id>[^/]+)/drain$", self._node_drain),
            (r"^/v1/node/(?P<node_id>[^/]+)/register$", self._node_register),
            (r"^/v1/node/(?P<node_id>[^/]+)/heartbeat$", self._node_heartbeat),
            (r"^/v1/node/(?P<node_id>[^/]+)/status$", self._node_status),
            (r"^/v1/node/(?P<node_id>[^/]+)/allocs$", self._node_update_allocs),
            (r"^/v1/node/(?P<node_id>[^/]+)/derive-vault$", self._node_derive_vault),
            (r"^/v1/vault/renew$", self._vault_renew),
            (r"^/v1/allocations$", self._allocations),
            (r"^/v1/allocation/(?P<alloc_id>[^/]+)$", self._allocation),
            (r"^/v1/evaluations$", self._evaluations),
            (r"^/v1/evaluation/(?P<eval_id>[^/]+)$", self._evaluation),
            (r"^/v1/evaluation/(?P<eval_id>[^/]+)/allocations$", self._eval_allocations),
            (r"^/v1/status/leader$", self._status_leader),
            (r"^/v1/status/peers$", self._status_peers),
            (r"^/v1/agent/self$", self._agent_self),
            (r"^/v1/agent/trace$", self._agent_trace),
            (r"^/v1/agent/profile$", self._agent_profile),
            (r"^/v1/metrics$", self._metrics),
            (r"^/v1/system/gc$", self._system_gc),
            (r"^/v1/client/fs/(ls|stat|cat|readat|logs)/[^/]+$",
             self._client),
            (r"^/v1/client/stats$", self._client),
            (r"^/v1/client/allocation/[^/]+/(stats|snapshot)$",
             self._client),
            # follower->leader forwarding targets (rpc.go:178 forward);
            # served by the leader for remote followers' workers/timers
            (r"^/v1/internal/eval/dequeue$", self._internal_eval_dequeue),
            (r"^/v1/internal/eval/dequeue-many$",
             self._internal_eval_dequeue_many),
            (r"^/v1/internal/eval/ack$", self._internal_eval_ack),
            (r"^/v1/internal/eval/nack$", self._internal_eval_nack),
            (r"^/v1/internal/eval/pause-nack$", self._internal_eval_pause),
            (r"^/v1/internal/eval/resume-nack$", self._internal_eval_resume),
            (r"^/v1/internal/eval/outstanding$", self._internal_eval_outstanding),
            (r"^/v1/internal/plan/submit$", self._internal_plan_submit),
            (r"^/v1/internal/heartbeat/reset$", self._internal_heartbeat_reset),
            # Debug introspection, gated on enable_debug (the pprof
            # analog: command/agent/http.go:135-138).
            (r"^/debug/stacks$", self._debug_stacks),
            (r"^/debug/profile$", self._debug_profile),
            (r"^/debug/vars$", self._debug_vars),
        ]
        for pattern, handler in route_handlers:
            m = re.match(pattern, path)
            if m:
                # Route tag for the per-route request histogram: the
                # handler's name is a stable, low-cardinality stand-in
                # for the route pattern (path params never leak into
                # metric names).
                req.nomad_route = handler.__name__.lstrip("_")
                # Overload admission gate (admission/): sheds or
                # rate-limits write/read traffic past green pressure;
                # internal leader-forward, client control, and
                # observability routes are exempt (limiter.py).
                ctl = getattr(self.server, "admission", None)
                degraded = False
                if ctl is not None:
                    verdict = ctl.check_http(method, path, req.nomad_route)
                    if verdict == "stale":
                        # Red-pressure read degradation: serve from the
                        # local replica (stale mode) instead of 429ing
                        # — a degraded answer beats no answer when a
                        # snapshot exists to serve from.
                        query["stale"] = ["true"]
                        degraded = True
                result = handler(method, query, body, **m.groupdict())
                if degraded:
                    if not isinstance(result, JSONResponse):
                        result = JSONResponse(result)
                    result.headers["X-Nomad-Degraded"] = "stale"
                return result
        raise HTTPError(404, f"no handler for {path!r}")

    # ------------------------------------------------------------------

    def _blocking(self, query, items, run: Callable[[], Any]) -> Any:
        """Blocking-query wrapper: serve once the watch SCOPE's index
        passes ?index=N or the wait expires. Consistency modes ride on
        every blocking route: `?stale` serves the local replica
        immediately-on-satisfaction with X-Nomad-LastContact /
        X-Nomad-KnownLeader staleness headers; `?consistent` first
        waits for the local FSM to reach the leader's last-known
        commit index (read-your-writes on a follower). The default
        preserves the pre-read-plane semantics.

        Queries that must park go to the read mux (_ParkSignal) so no
        HTTP thread waits; the thread-parking loop remains as the
        mux-full / global-index-arm fallback."""
        min_index = int(query.get("index", ["0"])[0])
        requested = float(query.get("wait", [DEFAULT_BLOCKING_WAIT])[0])
        wait = min(requested, MAX_BLOCKING_WAIT)
        headers = {}
        if "wait" in query:
            # The clamp is not silent (the PR 5 dequeue contract,
            # extended to every blocking route): the EFFECTIVE wait
            # goes back so a client asking past MAX_BLOCKING_WAIT can
            # see its actual long-poll budget.
            headers["X-Nomad-Effective-Wait"] = f"{wait:.3f}"
        server = self.server
        state = server.fsm.state
        scoped = getattr(server.config, "read_scoped_index", True)
        stale = _qflag(query, "stale")
        consistent = _qflag(query, "consistent")
        if stale and consistent:
            raise HTTPError(
                400, "?stale and ?consistent are mutually exclusive")
        if stale:
            contact_ms, known = server.read_staleness()
            headers["X-Nomad-LastContact"] = str(int(round(contact_ms)))
            headers["X-Nomad-KnownLeader"] = "true" if known else "false"
        elif consistent:
            try:
                server.wait_consistent()
            except TimeoutError as e:
                raise HTTPError(
                    504, f"consistent read barrier timed out: {e}")

        def cur_index() -> int:
            return (state.scope_index(items) if scoped
                    else state.latest_index())

        if min_index <= 0 or cur_index() > min_index:
            return JSONResponse(run(), index=max(cur_index(), 1),
                                headers=headers)
        deadline = time.monotonic() + wait
        mux = getattr(server, "read_mux", None)
        if scoped and mux is not None:
            raise _ParkSignal(items, min_index, deadline, run, headers)
        return self._blocking_threadpark(
            items, min_index, deadline, run, headers, scoped)

    def _blocking_threadpark(self, items, min_index: int, deadline: float,
                             run, headers, scoped: bool) -> "JSONResponse":
        """The pre-mux blocking loop: park THIS handler thread on the
        watch until satisfied or expired. Baseline arm for the bench
        A/B (`read_mux_enabled=false` / `read_scoped_index=false`) and
        the overflow path when the mux is full."""
        state = self.server.fsm.state

        def cur_index() -> int:
            return (state.scope_index(items) if scoped
                    else state.latest_index())

        while True:
            ev = state.watch(items)
            if cur_index() > min_index:
                state.stop_watch(items, ev)
                break
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                state.stop_watch(items, ev)
                break
            ev.wait(min(remaining, 1.0))
            state.stop_watch(items, ev)
        return JSONResponse(run(), index=max(cur_index(), 1),
                            headers=headers)

    def _park_handler(self, handler, sig: "_ParkSignal") -> bool:
        """Build the serialized-response continuation for a parking
        blocking query and register it with the read mux. On success
        the handler thread must exit WITHOUT closing the connection —
        the continuation owns the socket and writes the raw HTTP/1.1
        response when the mux wakes or expires it, then hands the
        still-open socket back to the HTTP server for its next request
        cycle (pooled SDK clients ride ONE socket per client across
        the whole long-poll loop — tests/test_httppool.py)."""
        from http.client import responses as _status_phrases

        server = self.server
        conn = handler.connection
        raw = handler._raw_request
        client_address = handler.client_address
        # The client's keep-alive wish, read off the request headers
        # BEFORE _dispatch forces close_connection to exit its loop.
        keepalive = not handler.close_connection
        scopes = list(sig.items)

        def serve(reason: str) -> None:
            try:
                payload, status = sig.run(), 200
            except HTTPError as e:
                payload, status = {"error": e.message}, e.status
            except Exception as e:  # noqa: BLE001
                payload, status = {"error": str(e)}, 500
            state = server.fsm.state
            scoped = getattr(server.config, "read_scoped_index", True)
            index = (state.scope_index(scopes) if scoped
                     else state.latest_index())
            headers = dict(sig.headers)
            if "X-Nomad-LastContact" in headers:
                # Staleness is measured at SERVE time, not park time.
                contact_ms, known = server.read_staleness()
                headers["X-Nomad-LastContact"] = str(int(round(contact_ms)))
                headers["X-Nomad-KnownLeader"] = (
                    "true" if known else "false")
            # On shutdown the server is going away with the socket;
            # otherwise honor the client's keep-alive so its next
            # blocking query reuses this connection instead of dialing.
            keep = keepalive and reason != "shutdown"
            data = json.dumps(payload).encode()
            lines = [
                f"HTTP/1.1 {status} {_status_phrases.get(status, 'OK')}",
                "Content-Type: application/json",
                f"Content-Length: {len(data)}",
                f"X-Nomad-Index: {max(index, 1)}",
            ]
            lines.extend(f"{k}: {v}" for k, v in headers.items())
            lines.extend(
                ["Connection: keep-alive" if keep else "Connection: close",
                 "", ""])

            def close_conn():
                # shutdown() pushes the FIN out NOW — close() alone
                # only drops this reference, and a lingering ref (idle
                # pool worker locals, exception tracebacks) would leave
                # the client waiting on a connection that never ends.
                try:
                    conn.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                try:
                    conn.close()
                except OSError:
                    pass

            try:
                # Bound the write: a stalled client must not wedge a
                # serve-pool thread for good.
                conn.settimeout(30.0)
                conn.sendall("\r\n".join(lines).encode() + data)
            except BaseException:
                close_conn()
                raise
            if keep:
                try:
                    self._resume_connection(raw, conn, client_address)
                    return
                except Exception:  # noqa: BLE001
                    pass  # server torn down mid-serve: fall through
            close_conn()

        parked = server.read_mux.park(
            scopes, sig.min_index, sig.deadline, serve)
        if parked:
            with self._detached_lock:
                rid = id(raw)
                self._detached[rid] = self._detached.get(rid, 0) + 1
        return parked

    def _resume_connection(self, raw, conn, client_address) -> None:
        """Hand a just-served keep-alive socket back to the HTTP server
        for its next request cycle. The _resumed entry tells the fresh
        handler's setup() this is not a new accept and, under TLS,
        carries the live wrapped socket (conn) so it isn't re-wrapped;
        process_request is handed the PRE-TLS object so the close
        machinery keys on the right socket."""
        with self._detached_lock:
            self._resumed[id(raw)] = None if conn is raw else conn
        try:
            self._httpd.process_request(raw, client_address)
        except BaseException:
            with self._detached_lock:
                self._resumed.pop(id(raw), None)
            raise

    # ------------------------------------------------------------- jobs

    def _jobs(self, method, query, body):
        if method in ("PUT", "POST"):
            job = from_dict(Job, body.get("job", body))
            eval_id, index = self.server.job_register(
                job,
                enforce_index=bool(body.get("enforce_index")),
                job_modify_index=int(body.get("job_modify_index") or 0),
            )
            return {"eval_id": eval_id, "index": index}
        state = self.server.fsm.state
        prefix = query.get("prefix", [""])[0]
        return self._blocking(
            query,
            [watch.table("jobs")],
            lambda: [
                _job_stub(j)
                for j in state.jobs()
                if j.id.startswith(prefix)
            ],
        )

    def _job(self, method, query, body, job_id):
        if method == "DELETE":
            eval_id = self.server.job_deregister(job_id)
            return {"eval_id": eval_id or ""}
        if method in ("PUT", "POST"):
            job = from_dict(Job, body.get("job", body))
            if job.id != job_id:
                raise HTTPError(400, "job ID does not match URL")
            eval_id, index = self.server.job_register(job)
            return {"eval_id": eval_id, "index": index}
        state = self.server.fsm.state

        def run():
            job = state.job_by_id(job_id)
            if job is None:
                raise HTTPError(404, f"job {job_id!r} not found")
            return to_dict(job)

        return self._blocking(query, [watch.job(job_id)], run)

    def _job_allocations(self, method, query, body, job_id):
        state = self.server.fsm.state
        return self._blocking(
            query,
            [watch.alloc_job(job_id)],
            lambda: [a.stub() for a in state.allocs_by_job(job_id)],
        )

    def _job_evaluations(self, method, query, body, job_id):
        state = self.server.fsm.state
        return self._blocking(
            query,
            [watch.table("evals")],
            lambda: [to_dict(e) for e in state.evals_by_job(job_id)],
        )

    def _job_evaluate(self, method, query, body, job_id):
        return {"eval_id": self.server.job_evaluate(job_id)}

    def _job_plan(self, method, query, body, job_id):
        job = from_dict(Job, body.get("job", body))
        result = self.server.job_plan(
            job, diff=bool(body.get("diff")),
            contextual=bool(body.get("contextual")),
        )
        return {
            "annotations": to_dict(result["annotations"]),
            "failed_tg_allocs": to_dict(result["failed_tg_allocs"]),
            "index": result["index"],
            "job_modify_index": result["job_modify_index"],
            "diff": to_dict(result.get("diff")),
        }

    def _job_periodic_force(self, method, query, body, job_id):
        child = self.server.periodic_force(job_id)
        return {"child_job_id": child}

    def _job_summary(self, method, query, body, job_id):
        state = self.server.fsm.state

        def run():
            summary = state.job_summary_by_id(job_id)
            if summary is None:
                raise HTTPError(404, f"job {job_id!r} not found")
            return to_dict(summary)

        return self._blocking(query, [watch.job_summary(job_id)], run)

    # ------------------------------------------------------------ nodes

    def _nodes(self, method, query, body):
        state = self.server.fsm.state
        return self._blocking(
            query,
            [watch.table("nodes")],
            lambda: [_node_stub(n) for n in state.nodes()],
        )

    def _node(self, method, query, body, node_id):
        state = self.server.fsm.state

        def run():
            node = state.node_by_id(node_id)
            if node is None:
                raise HTTPError(404, f"node {node_id!r} not found")
            return to_dict(node)

        return self._blocking(query, [watch.node(node_id)], run)

    def _node_allocations(self, method, query, body, node_id):
        state = self.server.fsm.state
        secret = query.get("secret", [""])[0]
        node = state.node_by_id(node_id)
        # MANDATORY whenever the node carries a secret
        # (node_endpoint.go:585-607 Node.GetClientAllocs): the old
        # `if secret` guard let a caller watch any node's allocs by
        # simply omitting the parameter.
        if node is not None and node.secret_id and node.secret_id != secret:
            raise HTTPError(403, "node secret ID does not match")
        return self._blocking(
            query,
            [watch.alloc_node(node_id)],
            lambda: [to_dict(a) for a in state.allocs_by_node(node_id)],
        )

    def _node_drain(self, method, query, body, node_id):
        drain = (body or {}).get("drain", True)
        self.server.node_update_drain(node_id, drain)
        return {"index": self.server.fsm.state.latest_index()}

    def _node_register(self, method, query, body, node_id):
        node = from_dict(Node, body["node"])
        ttl = self.server.node_register(node)
        return {"heartbeat_ttl": ttl}

    def _node_heartbeat(self, method, query, body, node_id):
        ttl = self.server.node_heartbeat(node_id, (body or {}).get("secret_id", ""))
        return {"heartbeat_ttl": ttl}

    def _node_status(self, method, query, body, node_id):
        ttl = self.server.node_update_status(node_id, body["status"])
        return {"heartbeat_ttl": ttl}

    def _node_update_allocs(self, method, query, body, node_id):
        allocs = [from_dict(Allocation, a) for a in body["allocs"]]
        index = self.server.node_update_allocs(allocs)
        return {"index": index}

    def _node_derive_vault(self, method, query, body, node_id):
        """Node.DeriveVaultToken (node_endpoint.go:940)."""
        tokens, ttl = self.server.derive_vault_token(
            node_id,
            (body or {}).get("secret_id", ""),
            (body or {}).get("alloc_id", ""),
            (body or {}).get("tasks", []),
        )
        return {"tasks": tokens, "ttl": ttl}

    def _vault_renew(self, method, query, body):
        ttl = self.server.vault_renew((body or {}).get("token", ""))
        return {"ttl": ttl}

    # ----------------------------------------------------- allocs/evals

    def _allocations(self, method, query, body):
        state = self.server.fsm.state
        return self._blocking(
            query,
            [watch.table("allocs")],
            lambda: [a.stub() for a in state.allocs()],
        )

    def _allocation(self, method, query, body, alloc_id):
        state = self.server.fsm.state

        def run():
            alloc = state.alloc_by_id(alloc_id)
            if alloc is None:
                raise HTTPError(404, f"alloc {alloc_id!r} not found")
            return to_dict(alloc)

        return self._blocking(query, [watch.alloc(alloc_id)], run)

    def _evaluations(self, method, query, body):
        state = self.server.fsm.state
        return self._blocking(
            query,
            [watch.table("evals")],
            lambda: [to_dict(e) for e in state.evals()],
        )

    def _evaluation(self, method, query, body, eval_id):
        state = self.server.fsm.state

        def run():
            ev = state.eval_by_id(eval_id)
            if ev is None:
                raise HTTPError(404, f"eval {eval_id!r} not found")
            return to_dict(ev)

        return self._blocking(query, [watch.eval_item(eval_id)], run)

    def _eval_allocations(self, method, query, body, eval_id):
        state = self.server.fsm.state
        return self._blocking(
            query,
            [watch.alloc_eval(eval_id)],
            lambda: [a.stub() for a in state.allocs_by_eval(eval_id)],
        )

    # ----------------------------------------------------------- system

    # ---------------------------------------- internal leader routes

    def _require_leader(self):
        if not self.server.is_leader():
            raise HTTPError(400, "not the leader")

    def _internal_eval_dequeue(self, method, query, body):
        self._require_leader()
        # The clamp is no longer silent: the EFFECTIVE timeout goes
        # back in the response body, so a client that asked for more
        # than MAX_BLOCKING_WAIT can see its actual long-poll budget
        # and adapt its retry cadence instead of assuming the server
        # honored the request.
        timeout = min(float(body.get("timeout", 1.0)), MAX_BLOCKING_WAIT)
        ev, token = self.server.broker.dequeue(
            body.get("schedulers") or [], timeout)
        return {"eval": to_dict(ev) if ev is not None else None,
                "token": token,
                "timeout": timeout}

    def _internal_eval_dequeue_many(self, method, query, body):
        """Non-blocking drain for a FOLLOWER worker's batch: without
        this, only leader-local workers could form device batches and
        the dense backend's throughput story would hold for one server
        only (the reference's point is N workers x all servers)."""
        self._require_leader()
        pairs = self.server.broker.dequeue_many(
            body.get("schedulers") or [], int(body.get("max_n", 0)))
        return {"evals": [
            {"eval": to_dict(ev), "token": token} for ev, token in pairs]}

    def _internal_eval_ack(self, method, query, body):
        self._require_leader()
        self.server.broker.ack(body["eval_id"], body["token"])
        return {}

    def _internal_eval_nack(self, method, query, body):
        self._require_leader()
        self.server.broker.nack(body["eval_id"], body["token"])
        return {}

    def _internal_eval_pause(self, method, query, body):
        self._require_leader()
        self.server.broker.pause_nack_timeout(body["eval_id"], body["token"])
        return {}

    def _internal_eval_resume(self, method, query, body):
        self._require_leader()
        self.server.broker.resume_nack_timeout(body["eval_id"], body["token"])
        return {}

    def _internal_eval_outstanding(self, method, query, body):
        self._require_leader()
        return {"token": self.server.broker.outstanding(body["eval_id"])}

    def _internal_plan_submit(self, method, query, body):
        self._require_leader()
        plan = from_dict(Plan, body["plan"])
        result = self.server.plan_submit(plan)
        return {"result": to_dict(result)}

    def _internal_heartbeat_reset(self, method, query, body):
        self._require_leader()
        return {"ttl": self.server.heartbeats.reset_timer(body["node_id"])}

    def _status_leader(self, method, query, body):
        if self.server.is_leader():
            # Prefer our ADVERTISED http addr from serf tags; self.addr
            # is built from the bind host and may be 0.0.0.0.
            serf = getattr(self.server, "serf", None)
            if serf is not None:
                advertised = serf._local.tags.get("http_addr")
                if advertised:
                    return advertised
            return self.addr
        # Raft follower: resolve the leader's raft address to its HTTP
        # address through serf tags (status_endpoint.go Leader).
        raft = getattr(self.server, "raft", None)
        if raft is not None and raft.leader_id:
            for m in self.server.serf_members():
                if m.tags.get("rpc_addr") == raft.leader_id:
                    return m.tags.get("http_addr") or ""
        return ""

    def _status_peers(self, method, query, body):
        raft = getattr(self.server, "raft", None)
        if raft is not None:
            # every same-region ALIVE server advertising a raft address
            peers = sorted(
                m.tags.get("rpc_addr") for m in self.server.serf_members()
                if m.tags.get("rpc_addr")
                and getattr(m, "region", None) == self.server.config.region
                and getattr(m, "status", "alive") == "alive"
            )
            if peers:
                return peers
        return [self.addr]

    def _agent_self(self, method, query, body):
        out = {"metrics": metrics.get_metrics().snapshot(),
               "stats": self.server.stats(),
               "config": to_dict(self.server.config)}
        # Placement batcher observability (only once the lazy
        # factories have loaded it): one batcher's stats, or each
        # device's where the process holds several.
        import sys

        batcher_mod = sys.modules.get("nomad_tpu_torch.scheduler.batcher")
        batchers = dict(batcher_mod._batchers) if batcher_mod else {}
        if len(batchers) == 1:
            out["placement_batcher"] = next(iter(batchers.values())).stats()
        elif batchers:
            out["placement_batcher"] = {
                str(dev): b.stats() for dev, b in batchers.items()}
        # Central dispatch pipeline observability (occupancy, retries
        # per eval, batches in flight, stage latencies) — the lane-fill
        # telemetry the r05 verdict asked for.
        dispatch = getattr(self.server, "dispatch", None)
        if dispatch is not None:
            out["dispatch_pipeline"] = dispatch.stats()
        return out

    def _agent_trace(self, method, query, body):
        """Eval-lifecycle traces from the local flight recorder
        (nomad_tpu/trace): recent completed span trees, the tail-kept
        slow traces (past the rolling e2e p99), the per-stage latency
        table, and recorder health counters. ?limit=N bounds the recent
        list; ?eval=<id> fetches one eval's trace.

        ?format=chrome returns a Chrome trace-event (Perfetto-loadable)
        document instead: tail-kept + recent traces merged with the
        contention observatory's pipeline timeline and completed
        convoys (nomad_tpu/profile/export.py; tools/traceconv.py does
        the same conversion offline)."""
        from ..trace import get_recorder

        rec = get_recorder()
        eval_id = query.get("eval", [""])[0]
        if eval_id:
            found = rec.trace_for(eval_id)
            if found is None:
                raise HTTPError(404, f"no trace for eval {eval_id!r}")
            return {"trace": found}
        limit = int(query.get("limit", ["50"])[0])
        if query.get("format", [""])[0] == "chrome":
            from ..profile import get_profiler
            from ..profile.export import chrome_trace

            prof = get_profiler()
            # Tail-kept first: the dedup keeps the first occurrence,
            # so the p99-defining outliers survive over their
            # recent-ring duplicates.
            doc = chrome_trace(
                rec.tail_traces() + rec.traces(limit),
                timeline=prof.timeline.events(),
                convoys=prof.convoy_table()["recent"])
            return RawResponse(
                json.dumps(doc).encode(), "application/json")
        return {
            "recent": rec.traces(limit),
            "tail": rec.tail_traces(),
            "stages": rec.stage_stats(),
            "recorder": rec.stats(),
        }

    def _agent_profile(self, method, query, body):
        """Contention observatory (nomad_tpu/profile): per-site lock
        wait/hold tables, GIL-pressure sampler, run-queue delays, the
        batch-boundary convoy report and timeline health. Drill-downs:
        ?lock=<site> returns that site's per-instance stats;
        ?thread=<name> one thread's contention totals; ?threads=1
        includes the whole per-thread table."""
        from ..profile import get_profiler

        prof = get_profiler()
        lock_site = query.get("lock", [""])[0]
        if lock_site:
            table = prof.lock_table()
            if lock_site not in table:
                raise HTTPError(
                    404, f"no profiled lock site {lock_site!r}")
            return {"site": lock_site, "stats": table[lock_site]}
        thread = query.get("thread", [""])[0]
        if thread:
            threads = prof.threads_table()
            if thread not in threads:
                raise HTTPError(
                    404, f"no contention record for thread {thread!r}")
            return {"thread": thread, "stats": threads[thread]}
        want_threads = query.get("threads", [""])[0] in ("1", "true")
        return prof.snapshot(threads=want_threads)

    def _metrics(self, method, query, body):
        """Prometheus text exposition of the shared telemetry registry
        (counters/gauges + log-bucket histograms for every timing
        sample). format=json returns the raw inmem snapshot instead."""
        if query.get("format", [""])[0] == "json":
            return metrics.get_metrics().snapshot()
        from ..profile import get_profiler

        # One exposition: the telemetry registry plus the contention
        # observatory's histograms/gauges (lock wait/hold, GIL
        # overshoot, runq delay, convoy width).
        body_text = (metrics.format_prometheus()
                     + get_profiler().format_prometheus())
        return RawResponse(
            body_text.encode(),
            "text/plain; version=0.0.4; charset=utf-8")

    def _system_gc(self, method, query, body):
        self.server.force_gc()
        return {}

    # ------------------------------------------------- regions + gossip

    def _forward_region(self, region: str, method: str, parsed, body,
                        req=None):
        """Proxy the request to a server in the target region, keeping
        path and query intact (the remote matches the region so it
        handles locally). Each hop appends itself to
        X-Nomad-Forwarded-For; seeing ourselves in that list means the
        serf region table is cyclic (split-brain or misconfigured
        federation) and the request 508s instead of ping-ponging until
        both regions' handler threads are exhausted."""
        hops: List[str] = []
        if req is not None:
            raw_hops = req.headers.get("X-Nomad-Forwarded-For") or ""
            hops = [h.strip() for h in raw_hops.split(",") if h.strip()]
        me = f"{self.server.node_id}.{self.server.config.region}"
        if me in hops:
            raise HTTPError(
                508, "region forwarding loop detected: "
                + " -> ".join(hops + [me]))
        peer = self.server.peer_http_addr(region)
        if peer is None:
            raise HTTPError(500, f"no path to region {region!r}")
        url = peer.rstrip("/") + parsed.path
        if parsed.query:
            url += "?" + parsed.query
        if url.startswith("https://") and self.forward_ssl_context is None:
            # Without a local tls block, urlopen would fall back to
            # system-CA verification, fail against the cluster CA, and
            # surface as an opaque generic forward error — the exact
            # rolling-TLS-rollout trap ADVICE r5 flagged. Name the
            # misconfiguration instead.
            raise HTTPError(
                502,
                f"region {region!r} peer {peer!r} requires TLS but "
                "cluster TLS material is not configured on this agent "
                "(add a tls block with the cluster CA and certs)")
        data = json.dumps(body).encode() if body is not None else None
        freq = urllib.request.Request(url, data=data, method=method)
        freq.add_header("Content-Type", "application/json")
        freq.add_header("X-Nomad-Forwarded-For", ", ".join(hops + [me]))
        try:
            # Outlive the longest server-side blocking query
            # (MAX_BLOCKING_WAIT) so forwarded long-polls don't 500.
            # With cluster TLS the peer's advertised address is
            # https://; verify against the cluster CA, not system CAs.
            with urllib.request.urlopen(
                freq, timeout=MAX_BLOCKING_WAIT + 10.0,
                context=(self.forward_ssl_context
                         if url.startswith("https://") else None),
            ) as resp:
                # Pass the remote reply through verbatim — content type
                # (fs endpoints return octet-streams) and the remote
                # region's X-Nomad-Index both survive the proxy hop.
                remote_index = resp.headers.get("X-Nomad-Index")
                return RawResponse(
                    resp.read(),
                    resp.headers.get("Content-Type") or "application/json",
                    index=int(remote_index) if remote_index else None,
                )
        except urllib.error.HTTPError as e:
            detail = e.read().decode(errors="replace")
            try:
                detail = json.loads(detail).get("error", detail)
            except ValueError:
                pass
            raise HTTPError(e.code, detail)
        except urllib.error.URLError as e:
            raise HTTPError(500, f"region {region!r} forward failed: {e.reason}")

    def _regions(self, method, query, body):
        return self.server.regions()

    def _agent_members(self, method, query, body):
        return [
            {
                "name": m.name,
                "region": m.region,
                "datacenter": m.datacenter,
                "addr": m.addr,
                "status": m.status,
                "tags": m.tags,
            }
            for m in self.server.serf_members()
        ]

    def _agent_join(self, method, query, body):
        addrs = query.get("address", [])
        joined = self.server.serf_join(addrs)
        return {"num_joined": joined, "error": "" if joined else "no peers contacted"}

    def _agent_force_leave(self, method, query, body):
        name = query.get("node", [""])[0]
        if not name:
            raise HTTPError(400, "missing ?node= parameter")
        self.server.serf_force_leave(name)
        return {}

    def _agent_servers(self, method, query, body):
        members = [
            m for m in self.server.serf_members()
            if m.region == self.server.config.region and m.status == "alive"
        ]
        if members:
            return [m.tags.get("http_addr") or m.addr for m in members]
        return [self.addr]

    # --------------------------------------- client fs + stats routes

    def _client(self, method, query, body):
        raise HTTPError(501, "no client agent attached to this HTTP server")

    @staticmethod
    def _q(query, name, default=""):
        return query.get(name, [default])[0]

    # ------------------------------------------------ debug (pprof analog)

    def _require_debug(self) -> None:
        if not self.enable_debug:
            # 404 like the reference, which never registers the routes
            # unless enable_debug is set — their existence should not be
            # probeable on production agents.
            raise HTTPError(404, "debug endpoints not enabled")

    def _debug_stacks(self, method, query, body):
        """Stack of every live thread (goroutine-dump analog)."""
        self._require_debug()
        import sys
        import traceback

        names = {t.ident: (t.name, t.daemon) for t in threading.enumerate()}
        parts = []
        for ident, frame in sorted(sys._current_frames().items()):
            name, daemon = names.get(ident, ("?", False))
            parts.append(
                f"== thread {name} (ident {ident}"
                f"{', daemon' if daemon else ''})\n"
                + "".join(traceback.format_stack(frame))
            )
        return RawResponse("\n".join(parts).encode(), "text/plain")

    def _debug_profile(self, method, query, body):
        """Sampling wall-clock profile across ALL threads for ?seconds=N
        (cpu-pprof analog): stacks sampled at ~100 Hz, aggregated by
        call path, top paths by sample count."""
        self._require_debug()
        import sys
        from collections import Counter

        seconds = min(max(float(self._q(query, "seconds", "1")), 0.1), 30.0)
        hz = 100
        counts: Counter = Counter()
        me = threading.get_ident()
        deadline = time.monotonic() + seconds
        n_samples = 0
        while time.monotonic() < deadline:
            for ident, frame in sys._current_frames().items():
                if ident == me:
                    continue
                stack = []
                f = frame
                while f is not None and len(stack) < 24:
                    code = f.f_code
                    stack.append(
                        f"{code.co_name} ({code.co_filename.rsplit('/', 1)[-1]}"
                        f":{f.f_lineno})")
                    f = f.f_back
                counts[";".join(reversed(stack))] += 1
            n_samples += 1
            time.sleep(1.0 / hz)
        lines = [f"# {n_samples} sampling rounds over {seconds:.1f}s @~{hz}Hz"]
        for path, c in counts.most_common(50):
            lines.append(f"{c}\t{path}")
        return RawResponse("\n".join(lines).encode(), "text/plain")

    def _debug_vars(self, method, query, body):
        """Process-level runtime vars (expvar analog)."""
        self._require_debug()
        import gc
        import resource
        import sys

        ru = resource.getrusage(resource.RUSAGE_SELF)
        return {
            "threads": len(threading.enumerate()),
            "gc_counts": gc.get_count(),
            "gc_objects": len(gc.get_objects()),
            "max_rss_kb": ru.ru_maxrss,
            "user_cpu_s": ru.ru_utime,
            "system_cpu_s": ru.ru_stime,
            "python": sys.version.split()[0],
        }


def _job_stub(job: Job) -> dict:
    return {
        "id": job.id,
        "parent_id": job.parent_id,
        "name": job.name,
        "type": job.type,
        "priority": job.priority,
        "status": job.status,
        "status_description": job.status_description,
        "create_index": job.create_index,
        "modify_index": job.modify_index,
        "job_modify_index": job.job_modify_index,
    }


def _node_stub(node: Node) -> dict:
    return {
        "id": node.id,
        "datacenter": node.datacenter,
        "name": node.name,
        "node_class": node.node_class,
        "drain": node.drain,
        "status": node.status,
        "status_description": node.status_description,
        "create_index": node.create_index,
        "modify_index": node.modify_index,
    }
