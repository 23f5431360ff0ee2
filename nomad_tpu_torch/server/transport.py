"""TCP/JSON raft transport for multi-host clusters.

Reference: the reference multiplexes raft streams over one TCP port
with a 1-byte protocol prefix (nomad/rpc.go:23-30, raft_rpc.go:33) and
POOLS yamux sessions per peer (nomad/pool.go:144) so replication fan-out
rides persistent connections. Here each message is one length-prefixed
JSON frame; connections are keep-alive and pooled per peer (a stale
pooled socket gets one retry on a fresh dial, utils/httppool.py's
discipline), and the whole channel optionally runs under mutual TLS
(utils/tlsutil.py; a plaintext or unauthenticated peer fails the
handshake, rpc.go:23-30 rpcTLS).

The port of the JAX package's server/transport.py, on the port's
structs and codec, without its fault injection: no send or receive
fault site. The frames are the same JSON, so a port node and a JAX
node speak to each other.
"""

from __future__ import annotations

import json
import logging
import socket
import socketserver
import ssl
import struct
import threading
from typing import Any, Dict, List, Optional, Tuple

from ..admission import AdmissionRejected
from ..utils.backoff import Backoff
from ..utils.codec import from_dict, to_dict
from .raft import LogEntry, Transport

_HEADER = struct.Struct(">I")
CONNECT_TIMEOUT = 1.0
RPC_TIMEOUT = 5.0
# Server side: how long a pooled keep-alive connection may sit idle
# before its handler thread gives up on it. Heartbeat cadence is
# sub-second, so anything this quiet belongs to a departed peer.
IDLE_CONN_TIMEOUT = 300.0


def _send_frame(sock: socket.socket, obj: dict) -> None:
    data = json.dumps(obj).encode()
    sock.sendall(_HEADER.pack(len(data)) + data)


def _recv_frame(sock: socket.socket) -> Optional[dict]:
    header = _recv_exact(sock, _HEADER.size)
    if header is None:
        return None
    (length,) = _HEADER.unpack(header)
    data = _recv_exact(sock, length)
    if data is None:
        return None
    return json.loads(data)


def _recv_exact(sock: socket.socket, count: int) -> Optional[bytes]:
    buf = b""
    while len(buf) < count:
        chunk = sock.recv(count - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf


def _encode_payload(payload: Any) -> Any:
    """Log payloads hold structs objects; encode them for the wire."""
    if isinstance(payload, dict):
        return {
            k: to_dict(v) if not isinstance(v, (str, int, float, bool, type(None))) else v
            for k, v in payload.items()
        }
    return to_dict(payload)


class TCPTransport(Transport):
    """Raft transport over TCP. The local node must call serve() with
    its bind address; peers are "host:port" strings.

    Note: JSON payload round-trips lose the structs object types, so
    multi-host mode requires typed payload decode hooks per message
    type; the decode_payload callback does that (the server wires it to
    the FSM's schema)."""

    MAX_IDLE_PER_PEER = 4

    def __init__(self, decode_payload=None,
                 ssl_server_ctx: Optional[ssl.SSLContext] = None,
                 ssl_client_ctx: Optional[ssl.SSLContext] = None):
        self.logger = logging.getLogger("nomad_tpu_torch.raft.tcp")
        self.node: Optional[object] = None
        self.decode_payload = decode_payload or (lambda mt, p: p)
        self._server: Optional[socketserver.ThreadingTCPServer] = None
        self.addr: str = ""
        self.ssl_server_ctx = ssl_server_ctx
        self.ssl_client_ctx = ssl_client_ctx
        # Per-peer idle keep-alive connections (pool.go:144): one
        # socket per CONCURRENT in-flight RPC to a peer, reused across
        # sequential heartbeats/appends instead of a dial per message.
        self._pools: Dict[str, List[socket.socket]] = {}
        self._pool_lock = threading.Lock()
        self._closed = False
        self.dials = 0  # sockets ever opened (observability/tests)
        # RPC-intake admission control (admission/), wired by
        # Server.start_with_raft. Raft consensus and leader-forward
        # kinds are exempt inside check_rpc — shedding append_entries
        # would turn overload into leader loss — so today this gates
        # only non-raft frames (future bulk/query kinds).
        self.admission = None

    # ------------------------------------------------------- serving

    def register(self, node) -> None:
        self.node = node

    def serve(self, host: str = "127.0.0.1", port: int = 0) -> str:
        transport = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                sock = self.request
                try:
                    # The idle read timeout bounds handler threads
                    # orphaned by peers that pooled a connection and
                    # then left the cluster — and it must be armed
                    # BEFORE the TLS handshake, or a peer that connects
                    # and never handshakes pins the thread forever.
                    sock.settimeout(IDLE_CONN_TIMEOUT)
                    # TLS terminates HERE, in the per-connection thread:
                    # wrapping in get_request would let one slow/failing
                    # handshake stall the accept loop for every peer.
                    if transport.ssl_server_ctx is not None:
                        sock = transport.ssl_server_ctx.wrap_socket(
                            sock, server_side=True)
                    # Keep-alive: serve frames until the peer hangs up —
                    # the client side pools this connection across
                    # heartbeats/appends instead of redialling.
                    while True:
                        msg = _recv_frame(sock)
                        if msg is None:
                            return
                        resp = transport._dispatch(msg)
                        _send_frame(sock, resp)
                except (OSError, ValueError, ssl.SSLError):
                    pass

        # Reuse-addr: an agent restarting on its configured port must
        # not fail on TIME_WAIT sockets from its previous run.
        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True

        self._server = Server((host, port), Handler)
        self._server.daemon_threads = True
        self.addr = "%s:%d" % self._server.server_address
        t = threading.Thread(
            target=self._server.serve_forever, name="raft-tcp", daemon=True
        )
        t.start()
        return self.addr

    def close(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
        with self._pool_lock:
            self._closed = True
            pools, self._pools = self._pools, {}
        for conns in pools.values():
            for sock in conns:
                try:
                    sock.close()
                except OSError:
                    pass

    def _dispatch(self, msg: dict) -> dict:
        kind = msg.get("kind")
        if self.node is None:
            return {"error": "node not ready"}
        if self.admission is not None:
            try:
                self.admission.check_rpc(kind)
            except AdmissionRejected as e:
                # Structured 503/429 analog for the frame protocol: the
                # caller sees a normal error frame plus the machine-
                # readable back-off hint, never a dropped connection.
                return {"error": e.message, "status": e.status,
                        "retry_after": round(e.retry_after, 3)}
        if kind == "request_vote":
            return self.node.handle_request_vote(msg["args"])
        if kind == "append_entries":
            args = msg["args"]
            args["entries"] = [
                LogEntry(
                    term=e["term"],
                    index=e["index"],
                    msg_type=e["msg_type"],
                    payload=self.decode_payload(e["msg_type"], e["payload"]),
                )
                for e in args["entries"]
            ]
            return self.node.handle_append_entries(args)
        if kind == "install_snapshot":
            return self.node.handle_install_snapshot(msg["args"])
        if kind == "forward_apply":
            index = self.node.apply(
                msg["msg_type"], self.decode_payload(msg["msg_type"], msg["payload"])
            )
            return {"index": index}
        return {"error": f"unknown kind {kind!r}"}

    # -------------------------------------------------------- client

    def _checkout(self, peer: str,
                  use_pool: bool = True) -> Tuple[Optional[socket.socket], bool]:
        """Returns (conn, pooled); dials when the idle pool is empty
        (or when the caller demands a fresh socket — the keep-alive
        retry must not pop ANOTHER stale pooled socket, or a restarted
        peer with several pooled sockets looks dead until the pool
        drains)."""
        if use_pool:
            with self._pool_lock:
                conns = self._pools.get(peer)
                if conns:
                    return conns.pop(), True
        host, port_s = peer.rsplit(":", 1)
        try:
            sock = socket.create_connection(
                (host, int(port_s)), timeout=CONNECT_TIMEOUT)
            if self.ssl_client_ctx is not None:
                sock = self.ssl_client_ctx.wrap_socket(
                    sock, server_hostname=host)
        except (OSError, ValueError, ssl.SSLError):
            return None, False
        with self._pool_lock:
            self.dials += 1
        return sock, False

    def forget_peer(self, peer: str) -> None:
        """Drop the idle pool for a peer that left the cluster; without
        this, every address ever contacted keeps up to
        MAX_IDLE_PER_PEER sockets open until process shutdown."""
        with self._pool_lock:
            conns = self._pools.pop(peer, [])
        for sock in conns:
            try:
                sock.close()
            except OSError:
                pass

    def _checkin(self, peer: str, sock: socket.socket) -> None:
        with self._pool_lock:
            # An RPC in flight during close() must not park its socket
            # in a pool nobody will drain again (httppool.py's _closed
            # discipline).
            if not self._closed:
                conns = self._pools.setdefault(peer, [])
                if len(conns) < self.MAX_IDLE_PER_PEER:
                    conns.append(sock)
                    return
        try:
            sock.close()
        except OSError:
            pass

    def _call(self, peer: str, msg: dict, timeout: float = RPC_TIMEOUT,
              connect_backoff: Optional[Backoff] = None) -> Optional[dict]:
        """One RPC round-trip. `connect_backoff` is a retry policy for
        DIAL failures only — a failed dial provably sent nothing, so
        retrying it can never double-deliver; exchange failures keep
        the single fresh-dial keep-alive retry and then fail to the
        caller (the frame may have been acted on)."""
        use_pool = True
        while True:
            sock, pooled = self._checkout(peer, use_pool=use_pool)
            if sock is None:
                # Dial failure: nothing was sent. Ride out a peer
                # restart / flap window when the caller asked for it.
                if connect_backoff is not None and connect_backoff.sleep():
                    continue
                return None
            try:
                sock.settimeout(timeout)
                _send_frame(sock, msg)
                resp = _recv_frame(sock)
                if resp is None:
                    raise OSError("peer closed connection")
            except (OSError, ValueError, ssl.SSLError) as e:
                try:
                    sock.close()
                except OSError:
                    pass
                # The peer may have dropped the idle socket between our
                # messages (keep-alive race): raft RPCs are idempotent
                # (term/index-guarded state machines), so one retry on
                # a fresh dial is safe. NOT after a timeout: a slow but
                # alive peer already burned the full RPC timeout, and
                # _broadcast_heartbeat iterates peers serially — a
                # retry would double the stall for every other
                # follower. The keep-alive race shows up as instant
                # EOF/RST, never as a timeout.
                is_timeout = isinstance(e, (socket.timeout, TimeoutError))
                if pooled and not is_timeout:
                    use_pool = False
                    continue
                return None
            self._checkin(peer, sock)
            return resp

    def request_vote(self, peer: str, args: dict) -> Optional[dict]:
        return self._call(peer, {"kind": "request_vote", "args": args})

    def install_snapshot(self, peer: str, args: dict) -> Optional[dict]:
        # FSM snapshot data is already wire-safe (state.persist() emits
        # plain dicts), so it ships as-is.
        return self._call(peer, {"kind": "install_snapshot", "args": args},
                          timeout=30.0)

    def append_entries(self, peer: str, args: dict) -> Optional[dict]:
        wire_args = dict(args)
        wire_args["entries"] = [
            {
                "term": e.term,
                "index": e.index,
                "msg_type": e.msg_type,
                "payload": _encode_payload(e.payload),
            }
            for e in args["entries"]
        ]
        return self._call(peer, {"kind": "append_entries", "args": wire_args})

    def forward_apply(self, peer: str, msg_type: str, payload: Any) -> int:
        # Dial-failure retries ride a jittered backoff: a follower
        # forwarding a write during a leader restart sees connection
        # refusals for the flap window — retrying those is free of
        # double-apply risk (nothing was sent), unlike exchange
        # failures, which _call never retries past the keep-alive race.
        resp = self._call(
            peer,
            {
                "kind": "forward_apply",
                "msg_type": msg_type,
                "payload": _encode_payload(payload),
            },
            connect_backoff=Backoff(base=0.05, max_delay=0.4, attempts=3),
        )
        if resp is None or "error" in resp:
            raise ConnectionError(
                f"forward to {peer} failed: {resp and resp.get('error')}"
            )
        return resp["index"]


def fsm_payload_decoder(msg_type: str, payload: Any) -> Any:
    """Decode wire payloads back into structs objects per message type
    (the typed half of the codec)."""
    from ..structs import Allocation, Evaluation, Job, Node
    from . import fsm as m

    if not isinstance(payload, dict):
        return payload
    out = dict(payload)
    if msg_type == m.NODE_REGISTER and "node" in out:
        out["node"] = from_dict(Node, out["node"])
    elif msg_type == m.JOB_REGISTER and "job" in out:
        out["job"] = from_dict(Job, out["job"])
    elif msg_type == m.EVAL_UPDATE and "evals" in out:
        out["evals"] = [from_dict(Evaluation, e) for e in out["evals"]]
    elif msg_type in (m.ALLOC_UPDATE, m.ALLOC_CLIENT_UPDATE):
        if out.get("allocs"):
            out["allocs"] = [from_dict(Allocation, a) for a in out["allocs"]]
        if out.get("job"):
            out["job"] = from_dict(Job, out["job"])
    elif msg_type == m.VAULT_ACCESSOR_REGISTER and out.get("accessors"):
        from .vault import VaultAccessor

        out["accessors"] = [
            a if isinstance(a, VaultAccessor) else from_dict(VaultAccessor, a)
            for a in out["accessors"]
        ]
    return out
