"""Three of the port's Servers form a raft cluster through gossip over
TCP (``setup_serf``, ``serf_join``, ``setup_raft_cluster(expect=3)`` on
127.0.0.1 ephemeral ports), as the JAX agent does with
``bootstrap_expect = 3``: one leader, gossip-driven membership, and
followers whose FSMs decode their own copies of every entry and equal
the leader's field by field. No server here runs an HTTPServer
(tests/test_torch_http_cluster.py does), so the followers' workers find
no leader address in serf tags and back off; the leader's own worker
schedules."""

import time

import torch_parity  # noqa: F401  (the port on the CPU)
from torch_server import MockClient

from nomad_tpu_torch import mock
from nomad_tpu_torch.server import Server, ServerConfig
from nomad_tpu_torch.server.transport import TCPTransport, fsm_payload_decoder
from nomad_tpu_torch.structs import consts
from nomad_tpu_torch.utils.codec import to_dict

WAIT = 25.0


def wait_until(fn, timeout=WAIT, interval=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if fn():
            return True
        time.sleep(interval)
    return False


def node_record(node):
    """A node as plain data, without ``status_updated_at``: each replica
    stamps that with its own clock when it applies a status change (the
    JAX store does the same)."""
    out = to_dict(node)
    out.pop("status_updated_at")
    return out


def tables(server):
    """The FSM's node, job, alloc and eval tables as plain data."""
    state = server.fsm.state
    return {
        "nodes": sorted((node_record(n) for n in state.nodes()),
                        key=lambda d: d["id"]),
        "jobs": sorted((to_dict(j) for j in state.jobs()),
                       key=lambda d: d["id"]),
        "allocs": sorted((to_dict(a) for a in state.allocs()),
                         key=lambda d: d["id"]),
        "evals": sorted((to_dict(e) for e in state.evals()),
                        key=lambda d: d["id"]),
    }


def test_gossip_bootstrap_forms_one_cluster_over_tcp():
    servers, transports = [], []
    try:
        for i in range(3):
            srv = Server(ServerConfig(
                num_schedulers=1, node_name=f"t{i}", bootstrap_expect=3,
                eval_nack_timeout=5.0))
            transport = TCPTransport(fsm_payload_decoder)
            raft_addr = transport.serve("127.0.0.1", 0)
            srv.setup_serf(rpc_addr=raft_addr)
            srv.serf.probe_interval = 0.1
            servers.append(srv)
            transports.append((transport, raft_addr))
        for srv in servers[1:]:
            assert srv.serf_join([servers[0].serf.local_member.addr]) == 1
        assert wait_until(lambda: all(
            len(s.serf_members()) == 3 for s in servers))
        for srv, (transport, raft_addr) in zip(servers, transports):
            srv.setup_raft_cluster(transport, raft_addr, expect=3)

        def leaders():
            return [s for s in servers if s.raft is not None
                    and s.is_leader()]

        assert wait_until(lambda: len(leaders()) == 1 and all(
            s.raft is not None and s.raft.leader_id == leaders()[0].node_id
            for s in servers))
        leader = leaders()[0]
        assert sorted(leader.raft.stats()["members"]) == sorted(
            addr for _t, addr in transports)
        assert leader.regions() == ["global"]
        # Followers know the leader's raft address but no HTTP address.
        follower = next(s for s in servers if s is not leader)
        assert follower.leader_http_addr() is None

        client = MockClient(leader)
        client.start()
        try:
            job = mock.job()
            job.task_groups[0].count = 3
            eval_id, _ = leader.job_register(job)
            assert wait_until(lambda: all(
                (e := s.fsm.state.eval_by_id(eval_id)) is not None
                and e.status == consts.EVAL_STATUS_COMPLETE
                and len(s.fsm.state.allocs_by_job(job.id)) == 3
                for s in servers))
        finally:
            client.stop()
        index = leader.raft.stats()["commit_index"]
        assert wait_until(lambda: all(
            s.raft.stats()["last_applied"] >= index for s in servers))
        want = tables(leader)
        for s in servers:
            if s is not leader:
                assert tables(s) == want
                # Decoded copies, not the leader's objects.
                assert s.fsm.state.job_by_id(job.id) is not \
                    leader.fsm.state.job_by_id(job.id)
    finally:
        for s in servers:
            s.shutdown()
        for transport, _addr in transports:
            transport.close()
