"""The port's raft (nomad_tpu_torch/server/raft.py, raft_storage.py,
transport.py) on the cases of tests/test_raft.py that need no Server:
election, replication, forwarding, failover, quorum loss, the TCP
transport and its typed payloads, and durability with compaction and
InstallSnapshot. The waits are as long as the JAX package's later ones
(20-25 s), so that they hold under the parallel suite."""

import json
import time

import pytest

import torch_parity  # noqa: F401  (the port on the CPU)
from nomad_tpu_torch import mock
from nomad_tpu_torch.server.raft import (
    InmemTransport,
    NotLeaderError,
    RaftNode,
)
from nomad_tpu_torch.server.raft_storage import RaftStorage
from nomad_tpu_torch.server.transport import (
    TCPTransport,
    _encode_payload,
    fsm_payload_decoder,
)
from nomad_tpu_torch.structs import Job, Node

WAIT = 20.0


def wait_until(fn, timeout=WAIT, interval=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if fn():
            return True
        time.sleep(interval)
    return False


def make_raft_cluster(n):
    transport = InmemTransport()
    applied = {i: [] for i in range(n)}
    nodes = []
    ids = [f"n{i}" for i in range(n)]
    for i, node_id in enumerate(ids):
        def make_apply(i):
            return lambda index, mtype, payload: applied[i].append(
                (index, mtype, payload)
            )

        node = RaftNode(node_id, ids, transport, make_apply(i), lambda _: None)
        transport.register(node)
        nodes.append(node)
    for node in nodes:
        node.start()
    return transport, nodes, applied


def find_leader(nodes):
    leaders = [n for n in nodes if n.is_leader()]
    return leaders[0] if len(leaders) == 1 else None


def stop_all(nodes):
    for n in nodes:
        n.stop()


def test_raft_elects_single_leader():
    transport, nodes, applied = make_raft_cluster(3)
    try:
        assert wait_until(lambda: find_leader(nodes) is not None)
        leader = find_leader(nodes)
        assert wait_until(
            lambda: all(n.leader_id == leader.node_id for n in nodes)
        )
    finally:
        stop_all(nodes)


def test_raft_replicates_and_applies_everywhere():
    transport, nodes, applied = make_raft_cluster(3)
    try:
        assert wait_until(lambda: find_leader(nodes) is not None)
        leader = find_leader(nodes)
        idx = leader.apply("test", {"value": 42})
        # the leadership noop barrier occupies index 1
        assert idx == 2
        assert wait_until(
            lambda: all(len(applied[i]) == 1 for i in range(3))
        )
        for i in range(3):
            assert applied[i][0] == (idx, "test", {"value": 42})
    finally:
        stop_all(nodes)


def test_raft_follower_forwards_to_leader():
    transport, nodes, applied = make_raft_cluster(3)
    try:
        assert wait_until(lambda: find_leader(nodes) is not None)
        leader = find_leader(nodes)
        follower = next(n for n in nodes if not n.is_leader())
        idx = follower.apply("fwd", {"x": 1})
        assert idx == 2  # index 1 is the leadership noop
        assert wait_until(lambda: leader.last_index() == idx)
    finally:
        stop_all(nodes)


def test_raft_leader_failover():
    transport, nodes, applied = make_raft_cluster(3)
    try:
        assert wait_until(lambda: find_leader(nodes) is not None)
        old_leader = find_leader(nodes)
        old_leader.apply("before", {})

        transport.disconnect(old_leader.node_id)
        remaining = [n for n in nodes if n is not old_leader]
        assert wait_until(lambda: any(n.is_leader() for n in remaining))
        new_leader = next(n for n in remaining if n.is_leader())
        assert new_leader is not old_leader
        idx = new_leader.apply("after", {})
        # old log: [noop, before]; new leader adds its own noop first
        assert idx == 4

        # old leader rejoins as follower and catches up
        transport.reconnect(old_leader.node_id)
        assert wait_until(
            lambda: not old_leader.is_leader()
            and old_leader.last_index() == idx
        )
    finally:
        stop_all(nodes)


def test_raft_no_leader_without_quorum():
    transport, nodes, applied = make_raft_cluster(3)
    try:
        assert wait_until(lambda: find_leader(nodes) is not None)
        # partition everyone: no quorum, no leader progress
        for n in nodes:
            transport.disconnect(n.node_id)
        time.sleep(0.5)
        leader = find_leader(nodes)
        if leader is not None:
            with pytest.raises((NotLeaderError, TimeoutError,
                                ConnectionError)):
                leader.apply("doomed", {})
    finally:
        stop_all(nodes)


# -------------------------------------------------------- TCP transport


def test_raft_over_tcp_transport():
    """Three raft nodes talking over real TCP sockets."""
    transports = [TCPTransport(fsm_payload_decoder) for _ in range(3)]
    addrs = [t.serve("127.0.0.1", 0) for t in transports]
    applied = {i: [] for i in range(3)}
    nodes = []
    for i, t in enumerate(transports):
        def make_apply(i):
            return lambda index, mtype, payload: applied[i].append(
                (index, mtype, payload))

        node = RaftNode(addrs[i], addrs, t, make_apply(i), lambda _: None)
        t.register(node)
        nodes.append(node)
    for n in nodes:
        n.start()
    try:
        assert wait_until(lambda: find_leader(nodes) is not None)
        leader = find_leader(nodes)
        follower = next(n for n in nodes if not n.is_leader())

        # typed payload survives the wire: each follower decodes its
        # own copy of the port's Node
        node_obj = mock.node()
        idx = leader.apply("node_register", {"node": node_obj})
        assert idx == 2  # index 1 is the leadership noop
        assert wait_until(lambda: all(len(applied[i]) == 1 for i in range(3)))
        for i in range(3):
            got = applied[i][0][2]["node"]
            assert isinstance(got, Node) and got == node_obj

        # follower forwards over TCP
        idx2 = follower.apply("test", {"x": 1})
        assert idx2 == 3
        assert wait_until(lambda: all(len(applied[i]) == 2 for i in range(3)))
    finally:
        stop_all(nodes)
        for t in transports:
            t.close()


def test_tcp_transport_typed_roundtrip():
    """FSM payloads decode back to the port's structs after the JSON
    wire."""
    payload = {"node": mock.node()}
    wire = json.loads(json.dumps(_encode_payload(payload)))
    decoded = fsm_payload_decoder("node_register", wire)
    assert isinstance(decoded["node"], Node)
    assert decoded["node"] == payload["node"]

    payload = {"job": mock.job()}
    decoded = fsm_payload_decoder(
        "job_register", json.loads(json.dumps(_encode_payload(payload)))
    )
    assert isinstance(decoded["job"], Job)
    assert decoded["job"] == payload["job"]


# ---------------------------------------------- durability + snapshots


def make_persistent_node(tmp_path, node_id="n0", threshold=0):
    """Single-node raft with storage; the FSM is a dict the apply fn
    mutates and snapshot/restore round-trips."""
    transport = InmemTransport()
    state = {}
    applied = []

    def fsm_apply(index, mtype, payload):
        applied.append((index, mtype, payload))
        state[payload["k"]] = payload["v"]
        state["_index"] = index

    node = RaftNode(
        node_id, [node_id], transport, fsm_apply, lambda _: None,
        fsm_snapshot=lambda: dict(state),
        fsm_restore=lambda data: (state.clear(), state.update(data)),
        storage=RaftStorage(str(tmp_path)),
        snapshot_threshold=threshold,
    )
    transport.register(node)
    node.start()
    return node, state, applied


def test_raft_log_survives_restart(tmp_path):
    node, state, applied = make_persistent_node(tmp_path)
    assert wait_until(node.is_leader)
    for i in range(5):
        node.apply("set", {"k": f"k{i}", "v": i})
    assert state["k4"] == 4
    node.stop()

    # A fresh process (new node, same dir) replays the log.
    node2, state2, applied2 = make_persistent_node(tmp_path)
    try:
        assert wait_until(node2.is_leader)
        assert wait_until(lambda: state2.get("k4") == 4)
        assert [p["v"] for _, _, p in applied2] == [0, 1, 2, 3, 4]
        # terms are durable: the restart bumped, never reused a term
        assert node2.current_term > 0
    finally:
        node2.stop()


def test_raft_compaction_and_snapshot_restart(tmp_path):
    node, state, applied = make_persistent_node(tmp_path, threshold=10)
    assert wait_until(node.is_leader)
    for i in range(25):
        node.apply("set", {"k": f"k{i}", "v": i})
    assert wait_until(lambda: node.log_offset > 0)
    offset_before = node.log_offset
    assert len(node.log) < 25  # prefix truncated
    node.stop()

    # Restart restores from snapshot + replays only the tail.
    node2, state2, applied2 = make_persistent_node(tmp_path, threshold=10)
    try:
        assert wait_until(node2.is_leader)
        assert wait_until(lambda: state2.get("k24") == 24)
        assert state2.get("k0") == 0  # from the snapshot
        # tail-only replay: far fewer applies than writes
        assert len(applied2) <= 25 - offset_before + 2
        # retention: at most 2 snapshot files on disk
        snaps = [n for n in tmp_path.iterdir()
                 if n.name.startswith("snapshot-")]
        assert 1 <= len(snaps) <= 2
    finally:
        node2.stop()


def test_raft_install_snapshot_catches_up_lagging_follower():
    """A follower that missed everything beyond the compacted log gets
    the leader's snapshot via InstallSnapshot."""
    transport = InmemTransport()
    states = {}
    ids = ["a", "b", "c"]

    def build(node_id, threshold):
        state = {}
        states[node_id] = state

        def fsm_apply(index, mtype, payload):
            state[payload["k"]] = payload["v"]

        node = RaftNode(
            node_id, ids, transport, fsm_apply, lambda _: None,
            fsm_snapshot=lambda s=state: dict(s),
            fsm_restore=lambda data, s=state: (s.clear(), s.update(data)),
            snapshot_threshold=threshold,
        )
        transport.register(node)
        node.start()
        return node

    nodes = [build(i, threshold=8) for i in ids]
    try:
        assert wait_until(lambda: find_leader(nodes) is not None)
        leader = find_leader(nodes)
        lagger = next(n for n in nodes if not n.is_leader())
        transport.disconnect(lagger.node_id)

        for i in range(30):
            leader.apply("set", {"k": f"k{i}", "v": i})
        assert wait_until(lambda: leader.log_offset > 0)

        # the lagger needs entries below the leader's log_offset
        transport.reconnect(lagger.node_id)
        assert wait_until(lambda: states[lagger.node_id].get("k29") == 29)
        assert states[lagger.node_id].get("k0") == 0
        assert lagger.log_offset >= 8  # snapshot was installed
    finally:
        stop_all(nodes)
