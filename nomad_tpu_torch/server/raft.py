"""Raft consensus: leader election, log replication, commit.

Reference: the reference embeds hashicorp/raft (nomad/server.go:634
setupRaft, raft_rpc.go stream layer); this is a from-scratch
implementation of the same protocol surface the control plane needs:
randomized election timeouts, RequestVote/AppendEntries, majority
commit, leadership-change notification driving the leader-only
services, and write forwarding to the leader. Transports are
pluggable: in-memory for in-process clusters/tests, TCP/JSON for
multi-host.

Durability and compaction (reference: raft-boltdb log + FSM snapshot
files, fsm.go:506, server.go:50): with a RaftStorage attached, the
term/vote metadata is fsynced before votes, the log is persisted and
replayed on restart, the FSM snapshots every `snapshot_threshold`
applies (retained files, log truncated), and followers too far behind
the compacted log receive an InstallSnapshot RPC.

Dynamic membership (reference: hashicorp/raft AddPeer/RemovePeer driven
by serf events, nomad/leader.go:551 addRaftPeer / :577 removeRaftPeer):
single-server configuration-change entries (`_raft.config`) carrying
the full member set. A configuration becomes ACTIVE when appended (the
dissertation's §4.1 rule — commitment is counted under the latest
appended config), one change may be in flight at a time, truncation
reverts to the previous config in the log, and snapshots embed the
member set so a restarted or far-behind node recovers membership with
its FSM.

The port of the JAX package's server/raft.py, without its fault
injection: no transport, heartbeat, commit or apply fault site.
"""

from __future__ import annotations

import logging
import random
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..utils.backoff import poll_until

FOLLOWER = "follower"
CANDIDATE = "candidate"
LEADER = "leader"

HEARTBEAT_INTERVAL = 0.05
ELECTION_TIMEOUT_MIN = 0.15
ELECTION_TIMEOUT_MAX = 0.30
APPLY_TIMEOUT = 10.0


@dataclass
class LogEntry:
    term: int
    index: int
    msg_type: str
    payload: Any


class _ApplyWaiter:
    __slots__ = ("event", "committed")

    def __init__(self):
        self.event = threading.Event()
        self.committed = False


class NotLeaderError(Exception):
    def __init__(self, leader_id: Optional[str]):
        super().__init__(f"not the leader (leader: {leader_id})")
        self.leader_id = leader_id


NOOP_TYPE = "_raft.noop"  # leadership barrier entry; never hits the FSM
CONFIG_TYPE = "_raft.config"  # membership change; payload {"peers": [...]}


class Transport:
    """RPC transport between raft peers."""

    def request_vote(self, peer: str, args: dict) -> Optional[dict]:
        raise NotImplementedError

    def append_entries(self, peer: str, args: dict) -> Optional[dict]:
        raise NotImplementedError

    def install_snapshot(self, peer: str, args: dict) -> Optional[dict]:
        raise NotImplementedError

    def forward_apply(self, peer: str, msg_type: str, payload: Any) -> int:
        raise NotImplementedError


class InmemTransport(Transport):
    """In-process transport: a shared registry of nodes. Supports
    partitioning for failure tests."""

    def __init__(self):
        self.nodes: Dict[str, "RaftNode"] = {}
        self.disconnected: set = set()

    def register(self, node: "RaftNode") -> None:
        self.nodes[node.node_id] = node

    def disconnect(self, node_id: str) -> None:
        self.disconnected.add(node_id)

    def reconnect(self, node_id: str) -> None:
        self.disconnected.discard(node_id)

    def _reachable(self, a: str, b: str) -> bool:
        return a not in self.disconnected and b not in self.disconnected

    def request_vote(self, peer: str, args: dict) -> Optional[dict]:
        node = self.nodes.get(peer)
        if node is None or not self._reachable(args["candidate_id"], peer):
            return None
        return node.handle_request_vote(args)

    def append_entries(self, peer: str, args: dict) -> Optional[dict]:
        node = self.nodes.get(peer)
        if node is None or not self._reachable(args["leader_id"], peer):
            return None
        return node.handle_append_entries(args)

    def install_snapshot(self, peer: str, args: dict) -> Optional[dict]:
        node = self.nodes.get(peer)
        if node is None or not self._reachable(args["leader_id"], peer):
            return None
        return node.handle_install_snapshot(args)

    def forward_apply(self, peer: str, msg_type: str, payload: Any) -> int:
        node = self.nodes.get(peer)
        if node is None or peer in self.disconnected:
            raise ConnectionError(f"peer {peer} unreachable")
        return node.apply(msg_type, payload)


class RaftNode:
    def __init__(
        self,
        node_id: str,
        peers: List[str],
        transport: Transport,
        fsm_apply: Callable[[int, str, Any], Any],
        on_leadership: Callable[[bool], None],
        fsm_snapshot: Optional[Callable[[], dict]] = None,
        fsm_restore: Optional[Callable[[dict], None]] = None,
        storage=None,
        snapshot_threshold: int = 0,
    ):
        self.node_id = node_id
        self.peers = [p for p in peers if p != node_id]
        # Membership: seed config until a _raft.config entry or a
        # config-carrying snapshot overrides it. `removed` parks this
        # node (no campaigning) once a config excludes it.
        self._seed_peers = list(self.peers)
        self._snapshot_peers: Optional[List[str]] = None
        self.removed = False
        self.transport = transport
        self.fsm_apply = fsm_apply
        self.on_leadership = on_leadership
        self.fsm_snapshot = fsm_snapshot
        self.fsm_restore = fsm_restore
        self.storage = storage
        self.snapshot_threshold = snapshot_threshold
        self.logger = logging.getLogger(f"nomad_tpu_torch.raft.{node_id}")

        self._lock = threading.RLock()
        self.state = FOLLOWER
        self.current_term = 0
        self.voted_for: Optional[str] = None
        self.log: List[LogEntry] = []  # indexes log_offset+1 .. via helpers
        # Compaction: everything at or below log_offset lives only in
        # the latest snapshot (log_offset = snapshot's last index).
        self.log_offset = 0
        self.snapshot_term = 0
        self._latest_snapshot: Optional[tuple] = None  # (index, term, data)
        self.commit_index = 0
        self.last_applied = 0
        self.leader_id: Optional[str] = None
        if storage is not None:
            self._restore_from_storage()

        # leader volatile state
        self.next_index: Dict[str, int] = {}
        self.match_index: Dict[str, int] = {}
        # Index of the noop barrier appended on election; config changes
        # are refused until it commits (see _change_config).
        self._term_start_index = 0

        self._last_heartbeat = time.monotonic()
        # Stale enough that votes are granted normally at boot.
        self._last_leader_contact = time.monotonic() - 3600.0
        self._election_deadline = self._next_election_deadline()
        # index -> (expected term, waiter); the commit must match the
        # term or the write was superseded by another leader.
        self._apply_waiters: Dict[int, Tuple[int, "_ApplyWaiter"]] = {}
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        # Leadership gain/loss callbacks run on one dispatcher thread in
        # FIFO order — a flap must never apply them reversed.
        import queue as _queue

        self._notify_queue: "_queue.Queue" = _queue.Queue()

    # ------------------------------------------------------------------

    def _notify_leadership(self, is_leader: bool) -> None:
        self._notify_queue.put(is_leader)

    def _run_notify(self) -> None:
        import queue as _queue

        while not self._stop.is_set():
            try:
                is_leader = self._notify_queue.get(timeout=0.2)
            except _queue.Empty:
                continue
            try:
                self.on_leadership(is_leader)
            except Exception:
                self.logger.exception("leadership callback failed")

    def start(self) -> None:
        for target, name in (
            (self._run_election_timer, "election"),
            (self._run_heartbeats, "heartbeat"),
            (self._run_apply, "apply"),
            (self._run_notify, "notify"),
        ):
            t = threading.Thread(
                target=target, name=f"raft-{self.node_id}-{name}", daemon=True
            )
            t.start()
            self._threads.append(t)

    def stop(self) -> None:
        was_leader = False
        with self._lock:
            was_leader = self.state == LEADER
            self.state = FOLLOWER
        self._stop.set()
        for t in self._threads:
            t.join(timeout=2.0)
        if was_leader:
            self.on_leadership(False)  # dispatcher stopped; call direct

    # ------------------------------------------------------ membership

    @staticmethod
    def _wrap_snapshot(data, peers: List[str]) -> dict:
        """Snapshots carry the member set so membership survives
        compaction/restart/InstallSnapshot alongside the FSM."""
        return {"__raft_fsm__": data, "__raft_peers__": sorted(peers)}

    @staticmethod
    def _unwrap_snapshot(blob) -> Tuple[Any, Optional[List[str]]]:
        if isinstance(blob, dict) and "__raft_fsm__" in blob:
            return blob["__raft_fsm__"], list(blob.get("__raft_peers__") or [])
        return blob, None  # legacy snapshot without a config

    def _members_locked(self) -> List[str]:
        return sorted(set(self.peers) | {self.node_id})

    def _activate_config_locked(self, members: List[str]) -> None:
        """A configuration takes effect as soon as it is appended (the
        single-server-change rule): votes and commit quorums count under
        the newest config in the log."""
        old_peers = set(self.peers)
        self.peers = [m for m in members if m != self.node_id]
        self.removed = self.node_id not in members
        if self.state == LEADER:
            nxt = self._last_log_index() + 1
            for p in self.peers:
                self.next_index.setdefault(p, nxt)
                self.match_index.setdefault(p, 0)
            for p in list(self.next_index):
                if p not in self.peers:
                    self.next_index.pop(p, None)
                    self.match_index.pop(p, None)
        # Departed peers: release their pooled transport connections
        # (otherwise every address ever in the cluster keeps sockets
        # open until process shutdown).
        forget = getattr(self.transport, "forget_peer", None)
        if forget is not None:
            for p in old_peers - set(self.peers):
                forget(p)
        self.logger.info("raft config active: %s", members)

    def _recompute_config_locked(self) -> None:
        """After truncation or restore: the active config is the last
        _raft.config entry in the log, else the snapshot's, else the
        seed peer set."""
        for entry in reversed(self.log):
            if entry.msg_type == CONFIG_TYPE:
                self._activate_config_locked(list(entry.payload["peers"]))
                return
        if self._snapshot_peers is not None:
            self._activate_config_locked(list(self._snapshot_peers))
            return
        self._activate_config_locked(
            sorted(set(self._seed_peers) | {self.node_id}))

    def _uncommitted_config_locked(self) -> bool:
        return any(
            e.msg_type == CONFIG_TYPE and e.index > self.commit_index
            for e in self.log
        )

    def _config_at_locked(self, index: int) -> List[str]:
        """Member set as of log position `index`: the last config entry
        at or below it, else the previous snapshot's, else the seed.
        Snapshots must embed THIS (not the active config): an active
        config past `index` may still be uncommitted, and persisting it
        would resurrect a truncated change after restart."""
        for entry in reversed(self.log):
            if entry.msg_type == CONFIG_TYPE and entry.index <= index:
                return list(entry.payload["peers"])
        if self._snapshot_peers is not None:
            return list(self._snapshot_peers)
        return sorted(set(self._seed_peers) | {self.node_id})

    # ----------------------------------------------------- persistence

    def _restore_from_storage(self) -> None:
        """Snapshot install + log replay on restart (the reference's
        raft does the same from raft.db + snapshot files)."""
        self.current_term, self.voted_for = self.storage.load_meta()
        snap = self.storage.load_latest_snapshot()
        if snap is not None:
            index, term, blob = snap
            data, peers = self._unwrap_snapshot(blob)
            if self.fsm_restore is not None:
                self.fsm_restore(data)
            self._snapshot_peers = peers
            self.log_offset = index
            self.snapshot_term = term
            self.commit_index = index
            self.last_applied = index
            self._latest_snapshot = snap
        entries = [e for e in self.storage.load_log(LogEntry)
                   if e.index > self.log_offset]
        # Guard against a gap (snapshot newer than the log tail).
        expect = self.log_offset + 1
        for e in entries:
            if e.index != expect:
                break
            self.log.append(e)
            expect += 1
        if snap is not None or any(
                e.msg_type == CONFIG_TYPE for e in self.log):
            self._recompute_config_locked()
        if self.log or snap is not None:
            self.logger.info(
                "restored raft state: snapshot@%d + %d log entries",
                self.log_offset, len(self.log))

    def _persist_meta(self) -> None:
        if self.storage is not None:
            self.storage.save_meta(self.current_term, self.voted_for)

    # ----------------------------------------------------- log helpers

    def _last_log_index(self) -> int:
        return self.log[-1].index if self.log else self.log_offset

    def _last_log_term(self) -> int:
        return self.log[-1].term if self.log else self.snapshot_term

    def _entry_at(self, index: int) -> Optional[LogEntry]:
        i = index - self.log_offset
        if i <= 0 or i > len(self.log):
            return None
        return self.log[i - 1]

    @staticmethod
    def _next_election_deadline() -> float:
        return time.monotonic() + random.uniform(
            ELECTION_TIMEOUT_MIN, ELECTION_TIMEOUT_MAX
        )

    # ------------------------------------------------------- RPC side

    def handle_request_vote(self, args: dict) -> dict:
        with self._lock:
            term = args["term"]
            up_to_date = (args["last_log_term"], args["last_log_index"]) >= (
                self._last_log_term(),
                self._last_log_index(),
            )
            if args.get("prevote"):
                # PreVote (dissertation §9.6, etcd PreVote): a candidate
                # first asks whether an election is even warranted —
                # NOTHING here mutates state, so a disruptive candidate
                # (a REMOVED server that never learned of its removal,
                # or a rejoining partitioned node) cannot inflate terms
                # and depose a healthy leader unless a majority agrees
                # the leader is gone. Grant iff the candidate's log
                # qualifies AND we have not heard from a live leader
                # within the minimum election timeout (the leader itself
                # counts ACK receipt as contact).
                leaderish = self.leader_id is not None or self.state == LEADER
                heard_recently = (
                    time.monotonic() - self._last_leader_contact
                    < ELECTION_TIMEOUT_MIN
                )
                granted = (
                    term >= self.current_term
                    and up_to_date
                    and not (leaderish and heard_recently
                             and args["candidate_id"] != self.leader_id)
                )
                return {"term": self.current_term, "vote_granted": granted}
            if term < self.current_term:
                return {"term": self.current_term, "vote_granted": False}
            if term > self.current_term:
                self._become_follower(term)
            if self.voted_for in (None, args["candidate_id"]) and up_to_date:
                self.voted_for = args["candidate_id"]
                self._persist_meta()  # durable before the vote leaves
                self._election_deadline = self._next_election_deadline()
                return {"term": self.current_term, "vote_granted": True}
            return {"term": self.current_term, "vote_granted": False}

    def handle_append_entries(self, args: dict) -> dict:
        with self._lock:
            term = args["term"]
            if term < self.current_term:
                return {"term": self.current_term, "success": False}
            if term > self.current_term or self.state != FOLLOWER:
                self._become_follower(term)
            self.leader_id = args["leader_id"]
            self._last_leader_contact = time.monotonic()
            self._election_deadline = self._next_election_deadline()

            prev_index = args["prev_log_index"]
            prev_term = args["prev_log_term"]
            if prev_index > 0 and prev_index != self.log_offset:
                entry = self._entry_at(prev_index)
                if entry is None or entry.term != prev_term:
                    return {"term": self.current_term, "success": False}
            if prev_index == self.log_offset and self.log_offset > 0:
                if prev_term != self.snapshot_term:
                    return {"term": self.current_term, "success": False}

            # Append, truncating conflicts.
            truncated = False
            appended = []
            for raw in args["entries"]:
                entry = LogEntry(**raw) if isinstance(raw, dict) else raw
                if entry.index <= self.log_offset:
                    continue  # already compacted into the snapshot
                existing = self._entry_at(entry.index)
                if existing is not None and existing.term != entry.term:
                    del self.log[entry.index - 1 - self.log_offset:]
                    truncated = True
                    existing = None
                if existing is None:
                    self.log.append(entry)
                    appended.append(entry)
            if self.storage is not None:
                if truncated:
                    self.storage.rewrite_log(self.log)
                else:
                    for entry in appended:
                        self.storage.append_entry(entry)
            if truncated or any(
                    e.msg_type == CONFIG_TYPE for e in appended):
                # Config entries activate on append; a truncation may
                # have removed one, reverting to the prior config.
                self._recompute_config_locked()

            if args["leader_commit"] > self.commit_index:
                self.commit_index = min(
                    args["leader_commit"], self._last_log_index()
                )
            return {"term": self.current_term, "success": True}

    def handle_install_snapshot(self, args: dict) -> dict:
        """A follower too far behind the leader's compacted log gets
        the whole FSM snapshot (raft InstallSnapshot)."""
        with self._lock:
            term = args["term"]
            if term < self.current_term:
                return {"term": self.current_term}
            if term > self.current_term or self.state != FOLLOWER:
                self._become_follower(term)
            self.leader_id = args["leader_id"]
            self._last_leader_contact = time.monotonic()
            self._election_deadline = self._next_election_deadline()
            last_index = args["last_index"]
            if last_index <= self.log_offset:
                return {"term": self.current_term}  # already have it
            data, peers = self._unwrap_snapshot(args["data"])
            if self.fsm_restore is not None:
                self.fsm_restore(data)
            self._snapshot_peers = peers
            self.log = []
            self.log_offset = last_index
            self.snapshot_term = args["last_term"]
            self.commit_index = max(self.commit_index, last_index)
            self.last_applied = last_index
            self._latest_snapshot = (last_index, args["last_term"],
                                     args["data"])
            if peers is not None:
                self._recompute_config_locked()
            if self.storage is not None:
                self.storage.save_snapshot(last_index, args["last_term"],
                                           args["data"])
                self.storage.rewrite_log(self.log)
            self.logger.info("installed snapshot @%d", last_index)
            return {"term": self.current_term}

    # ------------------------------------------------------ elections

    def _become_follower(self, term: int) -> None:
        was_leader = self.state == LEADER
        self.state = FOLLOWER
        if term > self.current_term:
            # One vote per term: voted_for only resets on a NEW term.
            self.current_term = term
            self.voted_for = None
            self._persist_meta()
        if was_leader:
            self._notify_leadership(False)

    def _run_election_timer(self) -> None:
        while not self._stop.is_set():
            time.sleep(0.02)
            with self._lock:
                if self.state == LEADER:
                    continue
                if self.removed:
                    # Excluded by the active config: never campaign (a
                    # removed node bumping terms would disrupt the
                    # cluster it was removed from).
                    continue
                if time.monotonic() < self._election_deadline:
                    continue
                # Timeout: probe with a PreVote round BEFORE touching
                # any state — only a majority agreeing the leader is
                # gone justifies a term bump (disruption-free elections).
                self._election_deadline = self._next_election_deadline()
                probe_term = self.current_term + 1
                last_idx, last_term = self._last_log_index(), self._last_log_term()
            try:
                if not self._prevote(probe_term, last_idx, last_term):
                    continue
            except Exception:  # noqa: BLE001 - the timer must survive
                self.logger.exception("prevote failed")
                continue
            with self._lock:
                if self.state == LEADER or self.removed:
                    continue
                self.state = CANDIDATE
                self.current_term += 1
                self.voted_for = self.node_id
                self._persist_meta()
                term = self.current_term
                self._election_deadline = self._next_election_deadline()
                last_idx, last_term = self._last_log_index(), self._last_log_term()
            try:
                self._campaign(term, last_idx, last_term)
            except Exception:  # noqa: BLE001 - the timer must survive
                self.logger.exception("campaign failed")

    def _prevote(self, term: int, last_idx: int, last_term: int) -> bool:
        """True when a majority would vote for us at `term` — no state
        anywhere changes during the probe."""
        votes = 1  # we would vote for ourselves
        args = {
            "term": term,
            "candidate_id": self.node_id,
            "last_log_index": last_idx,
            "last_log_term": last_term,
            "prevote": True,
        }
        for peer in self.peers:
            resp = self.transport.request_vote(peer, args)
            if resp and resp.get("vote_granted"):
                votes += 1
            if votes * 2 > len(self.peers) + 1:
                return True
        return votes * 2 > len(self.peers) + 1

    def _campaign(self, term: int, last_idx: int, last_term: int) -> None:
        votes = 1
        args = {
            "term": term,
            "candidate_id": self.node_id,
            "last_log_index": last_idx,
            "last_log_term": last_term,
        }
        for peer in self.peers:
            resp = self.transport.request_vote(peer, args)
            if resp is None or "term" not in resp:
                continue  # unreachable, or peer's raft not up yet
            with self._lock:
                if resp["term"] > self.current_term:
                    self._become_follower(resp["term"])
                    return
                if self.state != CANDIDATE or self.current_term != term:
                    return
            if resp["vote_granted"]:
                votes += 1
        if votes * 2 > len(self.peers) + 1:
            with self._lock:
                if self.state != CANDIDATE or self.current_term != term:
                    return
                self.state = LEADER
                self.leader_id = self.node_id
                # Barrier noop: raft never commits an older-term entry
                # by counting replicas, so a fresh leader appends one
                # entry of its own term to drive the commit index over
                # everything inherited (also what makes restart-recovery
                # of a single-node cluster re-apply its restored log).
                noop = LogEntry(term, self._last_log_index() + 1,
                                NOOP_TYPE, None)
                self.log.append(noop)
                self._term_start_index = noop.index
                if self.storage is not None:
                    self.storage.append_entry(noop)
                nxt = self._last_log_index() + 1
                self.next_index = {p: nxt for p in self.peers}
                self.match_index = {p: 0 for p in self.peers}
                # Queued under the lock, before the first broadcast: a
                # step-down during that broadcast queues its loss after
                # this gain, never before it.
                self._notify_leadership(True)
            self.logger.info("became leader for term %d", term)
            self._broadcast_heartbeat()

    # ------------------------------------------------------ leadership

    def _run_heartbeats(self) -> None:
        while not self._stop.is_set():
            with self._lock:
                is_leader = self.state == LEADER
            if is_leader:
                try:
                    self._broadcast_heartbeat()
                except Exception:  # noqa: BLE001 - must survive
                    self.logger.exception("heartbeat broadcast failed")
            time.sleep(HEARTBEAT_INTERVAL)

    def _broadcast_heartbeat(self) -> None:
        for peer in self.peers:
            self._replicate_to(peer)
        self._advance_commit()

    def _replicate_to(self, peer: str) -> None:
        with self._lock:
            if self.state != LEADER:
                return
            next_idx = self.next_index.get(peer, self._last_log_index() + 1)
            if next_idx <= self.log_offset and self._latest_snapshot:
                # The entries this peer needs are compacted away: ship
                # the snapshot instead (InstallSnapshot RPC).
                snap_index, snap_term, snap_data = self._latest_snapshot
                install_args = {
                    "term": self.current_term,
                    "leader_id": self.node_id,
                    "last_index": snap_index,
                    "last_term": snap_term,
                    "data": snap_data,
                }
            else:
                install_args = None
                next_idx = max(next_idx, self.log_offset + 1)
                prev_idx = next_idx - 1
                if prev_idx == self.log_offset:
                    prev_term = self.snapshot_term
                else:
                    prev_entry = self._entry_at(prev_idx)
                    prev_term = prev_entry.term if prev_entry else 0
                entries = list(self.log[next_idx - 1 - self.log_offset:])
                args = {
                    "term": self.current_term,
                    "leader_id": self.node_id,
                    "prev_log_index": prev_idx,
                    "prev_log_term": prev_term,
                    "entries": entries,
                    "leader_commit": self.commit_index,
                }
        if install_args is not None:
            resp = self.transport.install_snapshot(peer, install_args)
            if resp is None or "term" not in resp:
                return
            with self._lock:
                if resp["term"] > self.current_term:
                    self._become_follower(resp["term"])
                    return
                if self.state != LEADER:
                    return
                self.match_index[peer] = max(
                    self.match_index.get(peer, 0), install_args["last_index"])
                self.next_index[peer] = install_args["last_index"] + 1
            return
        resp = self.transport.append_entries(peer, args)
        if resp is None or "term" not in resp:
            return  # unreachable, or peer's raft not up yet
        with self._lock:
            if resp["term"] > self.current_term:
                self._become_follower(resp["term"])
                return
            if self.state != LEADER:
                return
            # A same-term response from a member is cluster contact: it
            # keeps the LEADER'S recent-leader window fresh for PreVote
            # denial, so a removed server's endless campaigns cannot
            # depose a leader that is still replicating (followers get
            # their window from receiving these appends; the leader
            # gets it from the ACKs).
            self._last_leader_contact = time.monotonic()
            if resp.get("success"):
                if entries:
                    self.match_index[peer] = entries[-1].index
                    self.next_index[peer] = entries[-1].index + 1
            else:
                self.next_index[peer] = max(1, self.next_index.get(peer, 1) - 1)

    def _advance_commit(self) -> None:
        with self._lock:
            if self.state != LEADER:
                return
            for n in range(self._last_log_index(), self.commit_index, -1):
                entry = self._entry_at(n)
                if entry is None or entry.term != self.current_term:
                    continue
                votes = 1 + sum(
                    1 for p in self.peers if self.match_index.get(p, 0) >= n
                )
                if votes * 2 > len(self.peers) + 1:
                    self.commit_index = n
                    break

    # ----------------------------------------------------------- apply

    def apply(self, msg_type: str, payload: Any) -> int:
        """Append an entry; blocks until it is committed and applied
        locally. Followers forward to the leader. Raises if the write
        was superseded (lost leadership before commit)."""
        with self._lock:
            if self.state != LEADER:
                leader = self.leader_id
                if leader is None or leader == self.node_id:
                    # A leader that stepped down keeps its own id until
                    # it hears from the next one: forwarding to itself
                    # would recurse.
                    raise NotLeaderError(None)
                forward = True
                index = waiter = None
            else:
                forward = False
                index, waiter = self._leader_append_locked(msg_type, payload)
        if forward:
            return self.transport.forward_apply(leader, msg_type, payload)
        return self._wait_commit(index, waiter)

    def _leader_append_locked(self, msg_type: str, payload: Any):
        index = self._last_log_index() + 1
        term = self.current_term
        entry = LogEntry(term, index, msg_type, payload)
        self.log.append(entry)
        if self.storage is not None:
            self.storage.append_entry(entry)
        waiter = _ApplyWaiter()
        self._apply_waiters[index] = (term, waiter)
        return index, waiter

    def _wait_commit(self, index: int, waiter: "_ApplyWaiter") -> int:
        # Actively drive replication while waiting: a dropped round
        # otherwise stalls the commit until the next heartbeat tick.
        deadline = time.monotonic() + APPLY_TIMEOUT
        self._broadcast_heartbeat()
        while not waiter.event.wait(0.05):
            if time.monotonic() > deadline:
                with self._lock:
                    self._apply_waiters.pop(index, None)
                raise TimeoutError(f"apply of index {index} timed out")
            self._broadcast_heartbeat()
        if not waiter.committed:
            # A different leader committed a different entry here.
            raise NotLeaderError(self.leader_id)
        return index

    # --------------------------------------------- membership change API

    def add_peer(self, peer_id: str) -> None:
        """Leader-only: add a server to the cluster (leader.go:551
        addRaftPeer). No-op if already a member."""
        self._change_config(add=peer_id)

    def remove_peer(self, peer_id: str) -> None:
        """Leader-only: remove a server (leader.go:577 removeRaftPeer).
        No-op if not a member."""
        self._change_config(remove=peer_id)

    def _wait_term_barrier(self, timeout: float = 2.0) -> None:
        """Block until an entry of the CURRENT term (the election noop)
        is committed. With append-time-active single-server changes, a
        config change before that barrier is the classic membership
        safety bug: an old leader holding an uncommitted add-peer config
        and a new leader appending remove-peer before its barrier
        commits can form disjoint quorums and commit divergent entries.
        PreVote narrows but does not close the window under partition —
        this gate closes it. Raises if the barrier doesn't land in time
        (the membership reconcile sweep retries)."""
        deadline = time.monotonic() + timeout
        # One nudge up front to drive the barrier's replication; after
        # that the heartbeat thread owns retransmission. Broadcasting
        # from the waiter loop (as this once did) serializes synchronous
        # per-peer RPCs every 20ms — with an unreachable peer and a slow
        # transport timeout a single _change_config could block far past
        # the deadline while hammering the network.
        nudged = False
        while True:
            with self._lock:
                if self.state != LEADER:
                    raise NotLeaderError(self.leader_id)
                if self.commit_index >= self._term_start_index:
                    return
            if time.monotonic() > deadline:
                raise ValueError(
                    "leadership not established: election barrier not "
                    "committed yet")
            if not nudged:
                nudged = True
                self._broadcast_heartbeat()
            time.sleep(0.02)

    def _change_config(self, add: Optional[str] = None,
                       remove: Optional[str] = None) -> None:
        self._wait_term_barrier()
        with self._lock:
            if self.state != LEADER:
                raise NotLeaderError(self.leader_id)
            if remove == self.node_id:
                raise ValueError(
                    "cannot remove the leader; transfer leadership first")
            if self.commit_index < self._term_start_index:
                # Re-elected between the barrier wait and here: the NEW
                # term's barrier is pending again; let the caller retry.
                raise ValueError(
                    "leadership not established: election barrier not "
                    "committed yet")
            if self._uncommitted_config_locked():
                raise ValueError("configuration change already in progress")
            members = set(self.peers) | {self.node_id}
            if add is not None:
                if add in members:
                    return
                members.add(add)
            if remove is not None:
                if remove not in members:
                    return
                members.discard(remove)
            index, waiter = self._leader_append_locked(
                CONFIG_TYPE, {"peers": sorted(members)})
            # Active on append: replication and commit of this very
            # entry already count under the new configuration.
            self._activate_config_locked(sorted(members))
        self._wait_commit(index, waiter)

    def _run_apply(self) -> None:
        while not self._stop.is_set():
            applied_any = False
            while self._apply_next():
                applied_any = True
            if applied_any:
                self._maybe_compact()
            else:
                time.sleep(0.005)

    def _apply_next(self) -> bool:
        """Apply the next committed entry, if any. The raft lock is held
        for one entry at a time: a follower catching up on a backlog
        (a burst of concurrent writes commits many entries at once)
        would otherwise hold it across every apply, blocking the
        leader's appends and heartbeats past the election timeout."""
        with self._lock:
            if self.last_applied >= self.commit_index:
                return False
            self.last_applied += 1
            entry = self._entry_at(self.last_applied)
            waiting = self._apply_waiters.pop(self.last_applied, None)
            if entry is not None and entry.msg_type not in (
                    NOOP_TYPE, CONFIG_TYPE):
                try:
                    self.fsm_apply(entry.index, entry.msg_type, entry.payload)
                except Exception:
                    self.logger.exception(
                        "fsm apply failed at %d", entry.index
                    )
            if waiting is not None:
                expected_term, waiter = waiting
                # Only ack the waiter if OUR entry committed; a
                # different term means the write was lost.
                waiter.committed = (
                    entry is not None and entry.term == expected_term
                )
                waiter.event.set()
            return True

    def _maybe_compact(self) -> None:
        """Snapshot the FSM and truncate the applied log prefix once
        enough entries accumulated (fsm.go:506 persist, retained files;
        threshold 0 disables)."""
        if (not self.snapshot_threshold or self.fsm_snapshot is None):
            return
        with self._lock:
            due = (self.last_applied - self.log_offset
                   >= self.snapshot_threshold)
            snap_index = self.last_applied
        if not due:
            return
        # Snapshotting outside the raft lock keeps elections unblocked;
        # normally only this thread advances the FSM, but an
        # InstallSnapshot can land concurrently — re-validate under the
        # lock and abort if it did (the installed snapshot is newer).
        data = self.fsm_snapshot()
        with self._lock:
            if self.log_offset >= snap_index or self.last_applied != snap_index:
                return  # superseded by a concurrent snapshot install
            entry = self._entry_at(snap_index)
            snap_term = entry.term if entry else self.snapshot_term
            snap_peers = self._config_at_locked(snap_index)
            blob = self._wrap_snapshot(data, snap_peers)
            self.log = self.log[snap_index - self.log_offset:]
            self.log_offset = snap_index
            self.snapshot_term = snap_term
            self._snapshot_peers = snap_peers
            self._latest_snapshot = (snap_index, snap_term, blob)
            if self.storage is not None:
                self.storage.save_snapshot(snap_index, snap_term, blob)
                self.storage.rewrite_log(self.log)
        self.logger.info("compacted log @%d (%d entries kept)",
                         snap_index, len(self.log))

    # ------------------------------------------------------------------

    def is_leader(self) -> bool:
        with self._lock:
            return self.state == LEADER

    def last_index(self) -> int:
        with self._lock:
            return self.last_applied

    def last_contact(self) -> float:
        """Seconds since this node last heard from a leader (0.0 while
        leading) — the staleness bound a `?stale` read advertises via
        X-Nomad-LastContact."""
        with self._lock:
            if self.state == LEADER:
                return 0.0
            return max(0.0, time.monotonic() - self._last_leader_contact)

    def known_commit_index(self) -> int:
        """The leader commit index this node has observed — the wait
        target a `?consistent` follower read uses for read-your-writes
        without leader forwarding."""
        with self._lock:
            return self.commit_index

    def barrier(self) -> int:
        return self.last_index()

    def wait_leader_barrier(self) -> bool:
        """Block until this leader has applied the noop that opened its
        term, and so every entry committed before it (the reference's
        raft.Barrier in leader.go leaderLoop, before establishLeadership;
        like its leader loop, it waits as long as the term lasts). False
        when the term ends first or the node stops."""
        with self._lock:
            target, term = self._term_start_index, self.current_term

        def settled():
            with self._lock:
                return (self.last_applied >= target or self.state != LEADER
                        or self.current_term != term)

        while not self._stop.is_set():
            if poll_until(settled, 1.0, stop=self._stop, base=0.002,
                          max_delay=0.05):
                break
        with self._lock:
            return (self.state == LEADER and self.current_term == term
                    and self.last_applied >= target)

    def stats(self) -> dict:
        with self._lock:
            return {
                "state": self.state,
                "term": self.current_term,
                "leader": self.leader_id,
                "commit_index": self.commit_index,
                "last_applied": self.last_applied,
                "log_len": len(self.log),
                "members": self._members_locked(),
                "removed": self.removed,
            }


class UnavailableLog:
    """Log stand-in while a raft cluster is still forming: writes fail
    with no-leader (the reference blocks RPC writes the same way until
    raft elects), reads see index 0."""

    def apply(self, msg_type: str, payload: Any) -> int:
        raise NotLeaderError(None)

    def last_index(self) -> int:
        return 0

    def barrier(self) -> int:
        return 0


class RaftLog:
    """Adapter giving RaftNode the DevLog interface the Server uses.
    Forwarded writes wait for the local FSM to catch up so endpoint code
    can read its own writes (the reference forwards whole RPCs to the
    leader, which reads there; here only the log write forwards)."""

    def __init__(self, node: RaftNode):
        self.node = node

    def apply(self, msg_type: str, payload: Any) -> int:
        index = self.node.apply(msg_type, payload)
        if not poll_until(lambda: self.node.last_index() >= index,
                          APPLY_TIMEOUT, base=0.002, max_delay=0.05):
            raise TimeoutError(
                f"local fsm did not reach index {index} in time"
            )
        return index

    def last_index(self) -> int:
        return self.node.last_index()

    def barrier(self) -> int:
        return self.node.barrier()
