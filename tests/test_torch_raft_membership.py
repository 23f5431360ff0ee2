"""Raft dynamic membership on the port (the cases of
tests/test_raft_membership.py; reference: nomad/leader.go:551
addRaftPeer / :577 removeRaftPeer over hashicorp/raft configuration
changes): config-change entries grow and shrink the voting set at
runtime, survive leader failover and partitions without split brain,
and gossip drives them at the server level."""

import time

import pytest

import torch_parity  # noqa: F401  (the port on the CPU)
from nomad_tpu_torch.server import Server, ServerConfig
from nomad_tpu_torch.server.raft import (
    CONFIG_TYPE,
    InmemTransport,
    NotLeaderError,
    RaftNode,
)


def wait_until(fn, timeout=20.0, interval=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if fn():
            return True
        time.sleep(interval)
    return False


def make_node(transport, applied, node_id, peer_ids):
    log = applied.setdefault(node_id, [])
    node = RaftNode(
        node_id, peer_ids, transport,
        lambda index, mtype, payload, _log=log: _log.append(
            (index, mtype, payload)),
        lambda _: None,
    )
    transport.register(node)
    return node


def make_cluster(n):
    transport = InmemTransport()
    applied = {}
    ids = [f"n{i}" for i in range(n)]
    nodes = [make_node(transport, applied, i, ids) for i in ids]
    for node in nodes:
        node.start()
    return transport, nodes, applied


def find_leader(nodes):
    leaders = [n for n in nodes if n.is_leader() and not n.removed]
    return leaders[0] if len(leaders) == 1 else None


def stop_all(nodes):
    for n in nodes:
        n.stop()


def test_add_peer_grows_cluster_and_replicates():
    transport, nodes, applied = make_cluster(3)
    try:
        assert wait_until(lambda: find_leader(nodes) is not None)
        leader = find_leader(nodes)
        n3 = make_node(transport, applied, "n3", [leader.node_id])
        n3.start()
        leader.add_peer("n3")
        nodes.append(n3)
        assert "n3" in leader.stats()["members"]
        # Everyone converges on the 4-member config.
        assert wait_until(lambda: all(
            "n3" in n.stats()["members"] for n in nodes))
        # The new node receives both old and new writes.
        idx = leader.apply("test", {"v": 1})
        assert wait_until(lambda: any(
            e[0] == idx for e in applied["n3"]))
    finally:
        stop_all(nodes)


def test_grow_to_five_then_leader_loss_still_commits():
    """3 -> 5 servers, kill the leader, the survivors elect and
    commit."""
    transport, nodes, applied = make_cluster(3)
    try:
        assert wait_until(lambda: find_leader(nodes) is not None)
        leader = find_leader(nodes)
        for name in ("n3", "n4"):
            nn = make_node(transport, applied, name, [leader.node_id])
            nn.start()
            leader.add_peer(name)
            nodes.append(nn)
        assert wait_until(lambda: all(
            len(n.stats()["members"]) == 5 for n in nodes))
        # Kill the leader.
        transport.disconnect(leader.node_id)
        survivors = [n for n in nodes if n is not leader]
        assert wait_until(lambda: find_leader(survivors) is not None,
                          timeout=20.0)
        new_leader = find_leader(survivors)
        idx = new_leader.apply("after-failover", {"v": 2})
        # Majority of 5 = 3; four survivors must reach it.
        assert wait_until(lambda: sum(
            1 for n in survivors
            if any(e[0] == idx for e in applied[n.node_id])) >= 3)
    finally:
        stop_all(nodes)


def test_remove_peer_shrinks_quorum():
    transport, nodes, applied = make_cluster(3)
    try:
        assert wait_until(lambda: find_leader(nodes) is not None)
        leader = find_leader(nodes)
        victim = next(n for n in nodes if n is not leader)
        leader.remove_peer(victim.node_id)
        assert victim.node_id not in leader.stats()["members"]
        term_after_remove = leader.stats()["term"]
        # The removed node never hears about the config (the leader
        # stops replicating to it) — its election timeouts must NOT
        # depose the live leader: PreVote denies its probes while any
        # member heard from the leader recently (the leader's own
        # window is kept fresh by append ACKs), so its term never
        # bumps anyone. A deposed-and-rewon leader would show up as
        # term inflation even if is_leader() flickers back true.
        time.sleep(1.0)  # several election timeouts
        assert leader.is_leader()
        assert leader.stats()["term"] == term_after_remove, \
            "removed server's campaigns inflated the term (deposed leader)"
        # Disconnect the removed node entirely: with a 2-member config
        # the surviving pair still commits (proves quorum shrank — in a
        # fixed 3-set, 2 nodes could still commit, so also check the
        # victim never rejoins the member list).
        transport.disconnect(victim.node_id)
        idx = leader.apply("post-remove", {"v": 3})
        others = [n for n in nodes if n is not victim]
        assert wait_until(lambda: all(
            any(e[0] == idx for e in applied[n.node_id]) for n in others))
        assert all(victim.node_id not in n.stats()["members"] for n in others)
    finally:
        stop_all(nodes)


def test_leader_cannot_remove_self():
    transport, nodes, applied = make_cluster(3)
    try:
        assert wait_until(lambda: find_leader(nodes) is not None)
        leader = find_leader(nodes)
        with pytest.raises(ValueError, match="remove the leader"):
            leader.remove_peer(leader.node_id)
    finally:
        stop_all(nodes)


def test_follower_rejects_membership_change():
    transport, nodes, applied = make_cluster(3)
    try:
        assert wait_until(lambda: find_leader(nodes) is not None)
        leader = find_leader(nodes)
        follower = next(n for n in nodes if n is not leader)
        with pytest.raises(NotLeaderError):
            follower.add_peer("nX")
    finally:
        stop_all(nodes)


def test_config_entries_skip_fsm():
    transport, nodes, applied = make_cluster(3)
    try:
        assert wait_until(lambda: find_leader(nodes) is not None)
        leader = find_leader(nodes)
        n3 = make_node(transport, applied, "n3", [leader.node_id])
        n3.start()
        leader.add_peer("n3")
        nodes.append(n3)
        idx = leader.apply("real", {"v": 1})
        assert wait_until(lambda: any(
            e[0] == idx for e in applied[leader.node_id]))
        assert all(
            mtype != CONFIG_TYPE
            for log in applied.values() for _, mtype, _ in log)
    finally:
        stop_all(nodes)


def test_duplicate_add_is_noop():
    transport, nodes, applied = make_cluster(3)
    try:
        assert wait_until(lambda: find_leader(nodes) is not None)
        leader = find_leader(nodes)
        before = leader.stats()["log_len"]
        leader.add_peer("n1")  # already a member
        assert leader.stats()["log_len"] == before
        leader.remove_peer("nZ")  # never a member
        assert leader.stats()["log_len"] == before
    finally:
        stop_all(nodes)


def inject_uncommitted_config(leader, members):
    """Simulate the moment a leader has APPENDED a config entry (and
    activated it — single-server changes are active on append) but not
    yet replicated it: exactly the in-flight state a partition or crash
    can strand. Mirrors _change_config's internals minus the commit
    wait."""
    with leader._lock:
        index, _waiter = leader._leader_append_locked(
            CONFIG_TYPE, {"peers": sorted(members)})
        leader._activate_config_locked(sorted(members))
    return index


def assert_no_divergent_applies(applied):
    """No two nodes may have applied different payloads at the same
    index — the definition of split-brain damage."""
    by_index = {}
    for node_id, log in applied.items():
        for index, mtype, payload in log:
            seen = by_index.setdefault(index, (mtype, payload))
            assert seen == (mtype, payload), (
                f"divergent commit at index {index}: {seen} vs "
                f"({mtype}, {payload}) on {node_id}")


def test_partition_during_config_change_no_split_brain():
    """The old leader is partitioned away holding an
    appended-but-uncommitted add-peer config; the majority elects a new
    leader that performs a DIFFERENT config change. On heal: one
    leader, one member set, no divergent committed entries, and the
    phantom peer is gone."""
    transport, nodes, applied = make_cluster(5)
    try:
        assert wait_until(lambda: find_leader(nodes) is not None)
        old = find_leader(nodes)
        # Ensure the barrier landed (normal steady state), then strand
        # an add-peer config on the leader right as it partitions.
        old._wait_term_barrier()
        transport.disconnect(old.node_id)
        inject_uncommitted_config(
            old, set(old.stats()["members"]) | {"phantom"})
        assert "phantom" in old.stats()["members"]
        survivors = [n for n in nodes if n is not old]
        assert wait_until(lambda: find_leader(survivors) is not None,
                          timeout=20.0)
        new = find_leader(survivors)
        # The new leader commits a DIFFERENT change: remove a survivor.
        victim = next(n for n in survivors if n is not new)
        new.remove_peer(victim.node_id)
        idx = new.apply("post-partition", {"v": 1})
        committed_members = set(new.stats()["members"])
        assert "phantom" not in committed_members
        # Heal. The old leader must step down, truncate its uncommitted
        # config, and converge on the new leader's configuration.
        transport.reconnect(old.node_id)
        assert wait_until(
            lambda: not old.is_leader()
            and set(old.stats()["members"]) == committed_members,
            timeout=20.0)
        live = [n for n in nodes if n is not victim]
        assert wait_until(lambda: all(
            set(n.stats()["members"]) == committed_members for n in live))
        assert wait_until(lambda: any(
            e[0] == idx for e in applied[old.node_id]))
        # Exactly one leader overall, and no divergent commits anywhere.
        assert wait_until(lambda: find_leader(nodes) is not None)
        assert_no_divergent_applies(applied)
        # The healed cluster still makes progress.
        leader = find_leader(nodes)
        idx2 = leader.apply("after-heal", {"v": 2})
        assert wait_until(lambda: sum(
            1 for n in live
            if any(e[0] == idx2 for e in applied[n.node_id])) >= 2)
    finally:
        stop_all(nodes)


def test_leader_kill_with_partially_replicated_config_converges():
    """The leader dies with a config change replicated
    to exactly ONE follower. Whoever wins the election, the cluster
    must converge on a single config with no divergent commits —
    whether the half-replicated change survives depends on who wins,
    and both outcomes are legal."""
    transport, nodes, applied = make_cluster(5)
    try:
        assert wait_until(lambda: find_leader(nodes) is not None)
        old = find_leader(nodes)
        old._wait_term_barrier()
        followers = [n for n in nodes if n is not old]
        lucky, rest = followers[0], followers[1:]
        # Partition off everyone but the lucky follower, append the
        # config, replicate it to the lucky one only, then kill the
        # leader and heal the rest: a half-replicated config change.
        for n in rest:
            transport.disconnect(n.node_id)
        inject_uncommitted_config(
            old, set(old.stats()["members"]) | {"n5"})
        old._broadcast_heartbeat()  # reaches only `lucky`
        assert wait_until(
            lambda: "n5" in lucky.stats()["members"])
        transport.disconnect(old.node_id)
        for n in rest:
            transport.reconnect(n.node_id)
        # n5 itself never started; if `lucky`'s longer log wins it will
        # count quorum under the 6-member config (needs 4 of 6 — the 4
        # live survivors suffice). Either way: one leader.
        assert wait_until(lambda: find_leader(followers) is not None,
                          timeout=30.0)
        new = find_leader(followers)
        idx = new.apply("after-kill", {"v": 3})
        assert wait_until(lambda: sum(
            1 for n in followers
            if any(e[0] == idx for e in applied[n.node_id])) >= 3,
            timeout=20.0)
        # All survivors converge on the winner's member set.
        final_members = set(new.stats()["members"])
        assert wait_until(lambda: all(
            set(n.stats()["members"]) == final_members
            for n in followers))
        assert_no_divergent_applies(applied)
    finally:
        stop_all(nodes)


def test_gossip_drives_membership_on_servers():
    """Server-level wiring: a serf member joining with a raft address
    is added by the leader; a leaving one is removed (leader.go:491
    reconcileMember)."""
    from nomad_tpu_torch.server.serf import ALIVE, LEFT

    class FakeMember:
        def __init__(self, name, rpc, status=ALIVE, region="global"):
            self.name = name
            self.region = region
            self.status = status
            self.tags = {"rpc_addr": rpc}

    transport = InmemTransport()
    ids = ["s0", "s1", "s2"]
    servers = []
    cluster = {}
    for sid in ids:
        srv = Server(ServerConfig(num_schedulers=0, node_name=sid))
        srv.start_with_raft(sid, ids, transport, cluster)
        servers.append(srv)
    try:
        assert wait_until(lambda: sum(
            1 for s in servers if s.raft.is_leader()) == 1)
        leader = next(s for s in servers if s.raft.is_leader())
        # New server gossips in.
        s3 = Server(ServerConfig(num_schedulers=0, node_name="s3"))
        s3.start_with_raft("s3", [leader.raft.node_id], transport, cluster)
        servers.append(s3)
        leader._reconcile_raft_member(FakeMember("s3.global", "s3"))
        assert wait_until(lambda: all(
            "s3" in s.raft.stats()["members"] for s in servers))
        # Writes commit across the 4-member cluster.
        job_index = leader.fsm.state.latest_index()
        from nomad_tpu_torch import mock

        leader.job_register(mock.job())
        assert leader.fsm.state.latest_index() > job_index
        # The member leaves: removed from the voting set.
        leader._reconcile_raft_member(
            FakeMember("s3.global", "s3", status=LEFT))
        assert wait_until(lambda: "s3" not in leader.raft.stats()["members"])
        # Cross-region and tag-less members are ignored.
        leader._reconcile_raft_member(
            FakeMember("x.eu", "sX", region="eu"))
        assert "sX" not in leader.raft.stats()["members"]
    finally:
        for s in servers:
            s.shutdown()
