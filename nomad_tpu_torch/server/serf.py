"""Gossip membership: the serf/memberlist analog.

Reference: nomad/serf.go (event handler wiring peers/localPeers maps,
server.go:100-104), server tags at server.go:740-760, and Serf's
push-pull anti-entropy protocol. The reference rides hashicorp/serf
(SWIM over UDP/TCP); here membership is a TCP digest gossip: each
member runs a small listener, periodically exchanges an incarnation
digest with one random alive peer (full member records cross the wire
only for rows the digests disagree on — O(changes), not O(members)
state per round), and marks peers failed after consecutive probe
failures. Member records carry lamport-style incarnation numbers so
newer information wins and a live member can refute its own death.
SWIM-style indirect UDP probing is still out of scope: failure
detection is direct-probe only, which is fine at server-pool sizes
(~3-7 per region) though not at client-pool scale.

This layer only tracks *server* membership (within and across regions)
— clients discover servers via the HTTP API, as in the reference.

The port of the JAX package's server/serf.py: the same frames, so a
port member and a JAX member gossip with each other.
"""

from __future__ import annotations

import json
import logging
import random
import socket
import socketserver
import struct
import threading
from dataclasses import asdict, dataclass, field
from typing import Callable, Dict, List, Optional

_HEADER = struct.Struct(">I")
CONNECT_TIMEOUT = 1.0

# Member statuses (serf's alive/leaving/left/failed, collapsed).
ALIVE = "alive"
LEFT = "left"
FAILED = "failed"

# Equal-incarnation precedence (SWIM's dead-state dominance): a
# FAILED/LEFT claim at incarnation k beats ALIVE at k — only the
# member ITSELF refutes, by re-asserting ALIVE at k+1 (_merge's
# self-refutation branch). Without this ordering a detector's FAILED
# marking would be erased by any peer still holding ALIVE at the same
# incarnation, and failure information could never spread.
_STATUS_RANK = {ALIVE: 0, FAILED: 1, LEFT: 2}


def _outranks(a: str, b: str) -> bool:
    return _STATUS_RANK.get(a, 0) > _STATUS_RANK.get(b, 0)

# Gossip events (serf.go: serfEventHandler switch).
EVENT_JOIN = "member-join"
EVENT_LEAVE = "member-leave"
EVENT_FAILED = "member-failed"
EVENT_UPDATE = "member-update"


@dataclass
class Member:
    """One server in the gossip pool.

    Tags mirror the reference's serf tags (server.go:740-760): role,
    region, dc, build, bootstrap expectation, plus the addresses other
    layers need (rpc_addr for raft forwarding, http_addr for region
    forwarding of API requests).
    """

    name: str
    region: str = "global"
    datacenter: str = "dc1"
    addr: str = ""  # gossip host:port
    status: str = ALIVE
    incarnation: int = 0
    tags: Dict[str, str] = field(default_factory=dict)

    def to_wire(self) -> dict:
        return asdict(self)

    @classmethod
    def from_wire(cls, d: dict) -> "Member":
        return cls(
            name=d["name"],
            region=d.get("region", "global"),
            datacenter=d.get("datacenter", "dc1"),
            addr=d.get("addr", ""),
            status=d.get("status", ALIVE),
            incarnation=int(d.get("incarnation", 0)),
            tags=dict(d.get("tags") or {}),
        )


def _send_frame(sock: socket.socket, obj: dict) -> None:
    data = json.dumps(obj).encode()
    sock.sendall(_HEADER.pack(len(data)) + data)


def _recv_frame(sock: socket.socket) -> Optional[dict]:
    buf = b""
    while len(buf) < _HEADER.size:
        chunk = sock.recv(_HEADER.size - len(buf))
        if not chunk:
            return None
        buf += chunk
    (length,) = _HEADER.unpack(buf)
    data = b""
    while len(data) < length:
        chunk = sock.recv(length - len(data))
        if not chunk:
            return None
        data += chunk
    return json.loads(data)


class Serf:
    """TCP push-pull gossip pool member.

    on_event(event: str, member: Member) is invoked (outside the lock)
    for join/leave/failed/update transitions — the server wires this to
    its peers/localPeers maps exactly like serf.go's serfEventHandler.
    """

    def __init__(
        self,
        name: str,
        region: str = "global",
        datacenter: str = "dc1",
        tags: Optional[Dict[str, str]] = None,
        on_event: Optional[Callable[[str, Member], None]] = None,
        probe_interval: float = 1.0,
        suspicion_probes: int = 3,
        ssl_server_ctx=None,
        ssl_client_ctx=None,
    ):
        self.logger = logging.getLogger("nomad_tpu_torch.serf")
        self.name = name
        # mTLS (agent tls block): gossip carries the addresses leader
        # and cross-region forwarding dial, so an unauthenticated
        # gossip port would let any network peer inject member records
        # and redirect the very traffic the other channels' TLS
        # protects. Plaintext or wrong-CA peers fail the handshake.
        self.ssl_server_ctx = ssl_server_ctx
        self.ssl_client_ctx = ssl_client_ctx
        self.on_event = on_event
        self.probe_interval = probe_interval
        self.suspicion_probes = suspicion_probes
        self._lock = threading.Lock()
        self._local = Member(
            name=name, region=region, datacenter=datacenter, tags=dict(tags or {})
        )
        self._members: Dict[str, Member] = {name: self._local}
        self._fail_counts: Dict[str, int] = {}
        self._server: Optional[socketserver.ThreadingTCPServer] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------ serving

    def serve(self, host: str = "127.0.0.1", port: int = 0) -> str:
        serf = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                sock = self.request
                try:
                    # Bounded reads: the digest exchange has a second
                    # inbound frame, and an initiator dying mid-exchange
                    # must not pin this handler thread in recv forever.
                    # Armed before the TLS handshake so a silent
                    # connect can't pin the thread either.
                    sock.settimeout(CONNECT_TIMEOUT * 5)
                    if serf.ssl_server_ctx is not None:
                        sock = serf.ssl_server_ctx.wrap_socket(
                            sock, server_side=True)
                    self.request = sock
                    msg = _recv_frame(sock)
                    if msg is None:
                        return
                    if msg.get("kind") == "push_pull":
                        # Legacy full-table exchange (kept for mixed
                        # versions during a rolling upgrade).
                        remote = [Member.from_wire(m) for m in msg["members"]]
                        serf._merge(remote)
                        _send_frame(
                            self.request,
                            {"members": [m.to_wire() for m in serf.members()]},
                        )
                    elif msg.get("kind") == "push_pull_digest":
                        # Digest anti-entropy: the initiator sent only
                        # {name: [incarnation, status]}; full records
                        # cross the wire ONLY where the digests
                        # disagree — O(changes), not O(members²) state
                        # per round at steady gossip.
                        digest = msg.get("digest") or {}
                        updates, want = serf._diff_digest(digest)
                        _send_frame(self.request, {
                            "updates": [m.to_wire() for m in updates],
                            "want": want,
                        })
                        reply = _recv_frame(self.request)
                        if reply and reply.get("updates"):
                            serf._merge([Member.from_wire(m)
                                         for m in reply["updates"]])
                except (OSError, ValueError):
                    pass

        # Reuse-addr: a member restarting on its configured gossip port
        # must not fail on TIME_WAIT sockets from its previous run.
        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True

        self._server = Server((host, port), Handler)
        self._server.daemon_threads = True
        addr = "%s:%d" % self._server.server_address
        with self._lock:
            self._local.addr = addr
        threading.Thread(
            target=self._server.serve_forever, name="serf-listen", daemon=True
        ).start()
        self._thread = threading.Thread(
            target=self._gossip_loop, name="serf-gossip", daemon=True
        )
        self._thread.start()
        return addr

    def shutdown(self) -> None:
        self._stop.set()
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()

    # ------------------------------------------------------------- public

    @property
    def local_member(self) -> Member:
        return self._local

    def members(self) -> List[Member]:
        with self._lock:
            return [
                Member(
                    name=m.name,
                    region=m.region,
                    datacenter=m.datacenter,
                    addr=m.addr,
                    status=m.status,
                    incarnation=m.incarnation,
                    tags=dict(m.tags),
                )
                for m in self._members.values()
            ]

    def alive_members(self) -> List[Member]:
        return [m for m in self.members() if m.status == ALIVE]

    def join(self, addrs: List[str]) -> int:
        """Push-pull sync with each address; returns contact count."""
        joined = 0
        for addr in addrs:
            if self._push_pull(addr):
                joined += 1
        return joined

    def leave(self) -> None:
        """Graceful leave: bump incarnation, mark left, broadcast."""
        with self._lock:
            self._local.incarnation += 1
            self._local.status = LEFT
            peers = [
                m.addr
                for m in self._members.values()
                if m.name != self.name and m.status == ALIVE and m.addr
            ]
        for addr in peers:
            self._push_pull(addr)
        self.shutdown()

    def force_leave(self, name: str) -> bool:
        """Operator eviction of a failed member (serf RemoveFailedNode)."""
        with self._lock:
            m = self._members.get(name)
            if m is None:
                return False
            m.status = LEFT
            m.incarnation += 1
        self._fire(EVENT_LEAVE, m)
        return True

    def set_tags(self, tags: Dict[str, str]) -> None:
        with self._lock:
            self._local.tags.update(tags)
            self._local.incarnation += 1

    # ----------------------------------------------------------- internal

    def _gossip_loop(self) -> None:
        while not self._stop.wait(self.probe_interval):
            with self._lock:
                candidates = [
                    m
                    for m in self._members.values()
                    if m.name != self.name and m.status == ALIVE and m.addr
                ]
            if not candidates:
                continue
            target = random.choice(candidates)
            if self._push_pull(target.addr):
                self._fail_counts.pop(target.name, None)
            else:
                n = self._fail_counts.get(target.name, 0) + 1
                self._fail_counts[target.name] = n
                if n >= self.suspicion_probes:
                    self._mark_failed(target.name)

    def _digest(self) -> Dict[str, list]:
        with self._lock:
            return {m.name: [m.incarnation, m.status]
                    for m in self._members.values()}

    def _diff_digest(self, digest: Dict[str, list]):
        """(records newer here than the digest, names newer there).
        "Newer" follows incarnation first, then the equal-incarnation
        status precedence (_outranks): failure detection is a status
        edge at the victim's current incarnation, and it must both
        propagate outward and never be pulled back by a stale ALIVE."""
        updates: List[Member] = []
        want: List[str] = []
        with self._lock:
            for m in self._members.values():
                ent = digest.get(m.name)
                if (ent is None or m.incarnation > int(ent[0])
                        or (m.incarnation == int(ent[0])
                            and _outranks(m.status, ent[1]))):
                    updates.append(m)
            for name, ent in digest.items():
                cur = self._members.get(name)
                if (cur is None or int(ent[0]) > cur.incarnation
                        or (int(ent[0]) == cur.incarnation
                            and _outranks(ent[1], cur.status))):
                    want.append(name)
        return updates, want

    def _connect(self, addr: str) -> socket.socket:
        host, port_s = addr.rsplit(":", 1)
        sock = socket.create_connection(
            (host, int(port_s)), timeout=CONNECT_TIMEOUT)
        if self.ssl_client_ctx is not None:
            sock = self.ssl_client_ctx.wrap_socket(
                sock, server_hostname=host)
        return sock

    def _push_pull(self, addr: str) -> bool:
        """Digest-based anti-entropy round (memberlist pushPull with a
        digest instead of the full state): exchange {name:
        incarnation/status} summaries, ship full member records only
        for the rows the summaries disagree on."""
        try:
            with self._connect(addr) as sock:
                sock.settimeout(CONNECT_TIMEOUT)
                _send_frame(sock, {"kind": "push_pull_digest",
                                   "digest": self._digest()})
                resp = _recv_frame(sock)
                if resp is None:
                    # A pre-digest peer drops unknown kinds: fall back
                    # to the legacy full-table exchange rather than
                    # counting a healthy old-version server as a probe
                    # failure (which would mark the whole un-upgraded
                    # pool FAILED during a rolling upgrade).
                    return self._push_pull_full(addr)
                if resp.get("updates"):
                    self._merge([Member.from_wire(m)
                                 for m in resp["updates"]])
                wanted = resp.get("want") or []
                with self._lock:
                    send = [self._members[n].to_wire()
                            for n in wanted if n in self._members]
                _send_frame(sock, {"updates": send})
                return True
        except (OSError, ValueError):
            return False

    def _push_pull_full(self, addr: str) -> bool:
        """Legacy full-table exchange (pre-digest wire protocol)."""
        try:
            with self._connect(addr) as sock:
                sock.settimeout(CONNECT_TIMEOUT)
                with self._lock:
                    local = [m.to_wire() for m in self._members.values()]
                _send_frame(sock, {"kind": "push_pull", "members": local})
                resp = _recv_frame(sock)
                if resp is None:
                    return False
                self._merge([Member.from_wire(m)
                             for m in resp.get("members", [])])
                return True
        except (OSError, ValueError):
            return False

    def _merge(self, remote: List[Member]) -> None:
        events: List[tuple] = []
        with self._lock:
            for rm in remote:
                if rm.name == self.name:
                    # Refute rumors of our own death/leave (serf alive
                    # rebroadcast with a higher incarnation).
                    if (
                        rm.status != ALIVE
                        and rm.incarnation >= self._local.incarnation
                    ):
                        self._local.incarnation = rm.incarnation + 1
                    continue
                cur = self._members.get(rm.name)
                if cur is None:
                    self._members[rm.name] = rm
                    if rm.status == ALIVE:
                        events.append((EVENT_JOIN, rm))
                    continue
                if rm.incarnation < cur.incarnation:
                    continue
                if (rm.incarnation == cur.incarnation
                        and not _outranks(rm.status, cur.status)):
                    continue
                old_status = cur.status
                cur.incarnation = rm.incarnation
                cur.status = rm.status
                cur.addr = rm.addr or cur.addr
                cur.region = rm.region
                cur.datacenter = rm.datacenter
                cur.tags = dict(rm.tags)
                if old_status != cur.status:
                    if cur.status == ALIVE:
                        events.append((EVENT_JOIN, cur))
                    elif cur.status == LEFT:
                        events.append((EVENT_LEAVE, cur))
                    elif cur.status == FAILED:
                        events.append((EVENT_FAILED, cur))
                else:
                    events.append((EVENT_UPDATE, cur))
        for ev, m in events:
            self._fire(ev, m)

    def _mark_failed(self, name: str) -> None:
        with self._lock:
            m = self._members.get(name)
            if m is None or m.status != ALIVE:
                return
            m.status = FAILED
        self.logger.warning("serf: member %s failed (no ack)", name)
        self._fire(EVENT_FAILED, m)

    def _fire(self, event: str, member: Member) -> None:
        if self.on_event is not None:
            try:
                self.on_event(event, member)
            except Exception:  # noqa: BLE001
                self.logger.exception("serf event handler error")
