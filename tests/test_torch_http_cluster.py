"""Three of the port's Servers over TCP, each behind its own HTTPServer
on 127.0.0.1:0 whose address it tags into serf (``setup_serf(...,
http_addr=)``): a follower finds the leader's HTTP address in the serf
tags, and its worker dequeues, submits its plan and acks through the
leader's internal routes (``RemoteLeader``). With the leader's own
worker paused, a follower places the eval. A ``?consistent`` read on a
follower's API sees the leader's last commit."""

import json
import time
import urllib.request

import torch_parity  # noqa: F401  (the port on the CPU)

from nomad_tpu_torch import mock
from nomad_tpu_torch.api import HTTPServer
from nomad_tpu_torch.server import Server, ServerConfig
from nomad_tpu_torch.server.transport import TCPTransport, fsm_payload_decoder
from nomad_tpu_torch.structs import consts

WAIT = 30.0


def wait_until(fn, timeout=WAIT, interval=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if fn():
            return True
        time.sleep(interval)
    return False


def get(addr, path):
    with urllib.request.urlopen(addr + path, timeout=10.0) as resp:
        return resp.status, dict(resp.headers), json.loads(resp.read())


def count_follower_dequeues(server, dequeued):
    """Note each eval ``server``'s workers dequeue while it does not
    lead: installed before its workers start, so no dequeue in flight
    escapes it."""
    inner = server.eval_dequeue

    def counted(schedulers, timeout):
        follower = not server.is_leader()
        ev, token = inner(schedulers, timeout)
        if follower and ev is not None:
            dequeued.setdefault(server.node_id, []).append(ev.id)
        return ev, token

    server.eval_dequeue = counted


def test_a_follower_places_an_eval_through_the_leaders_http():
    servers, transports, https = [], [], []
    dequeued = {}
    try:
        for i in range(3):
            srv = Server(ServerConfig(
                num_schedulers=1, node_name=f"h{i}", bootstrap_expect=3,
                eval_nack_timeout=5.0))
            transport = TCPTransport(fsm_payload_decoder)
            raft_addr = transport.serve("127.0.0.1", 0)
            http = HTTPServer(srv, "127.0.0.1", 0)
            http.start()
            srv.setup_serf(http_addr=http.addr, rpc_addr=raft_addr)
            srv.serf.probe_interval = 0.1
            count_follower_dequeues(srv, dequeued)
            servers.append(srv)
            transports.append((transport, raft_addr))
            https.append(http)
        for srv in servers[1:]:
            assert srv.serf_join([servers[0].serf.local_member.addr]) == 1
        assert wait_until(lambda: all(
            len(s.serf_members()) == 3 for s in servers))
        for srv, (transport, raft_addr) in zip(servers, transports):
            srv.setup_raft_cluster(transport, raft_addr, expect=3)

        def leader():
            found = [s for s in servers if s.raft is not None
                     and s.is_leader()]
            if len(found) == 1 and all(
                    s.raft is not None
                    and s.raft.leader_id == found[0].node_id
                    for s in servers):
                return found[0]
            return None

        assert wait_until(lambda: leader() is not None)
        lead = leader()
        lead_http = https[servers.index(lead)]
        followers = [s for s in servers if s is not lead]
        for f in followers:
            assert f.leader_http_addr() == lead_http.addr

        # Only the followers' workers may schedule.
        for w in lead.workers:
            w.set_pause(True)
        assert wait_until(lambda: all(w.parked() for w in lead.workers))
        for _ in range(20):
            node = mock.node()
            node.compute_class()
            lead.node_register(node)
        job = mock.job()
        job.task_groups[0].count = 3
        eval_id, _ = lead.job_register(job)
        assert wait_until(lambda: all(
            (e := s.fsm.state.eval_by_id(eval_id)) is not None
            and e.status == consts.EVAL_STATUS_COMPLETE
            and len(s.fsm.state.allocs_by_job(job.id)) == 3
            for s in servers))
        assert lead.is_leader()
        assert any(eval_id in ids for ids in dequeued.values()), dequeued
        # The follower acks through the leader's HTTP after the eval's
        # status commits.
        assert wait_until(lambda: lead.broker.stats()["total_unacked"] == 0)

        # ?consistent on a follower serves at the leader's last commit.
        second = mock.job()
        _ev, index = lead.job_register(second)
        follower = followers[0]
        assert wait_until(
            lambda: follower.raft.known_commit_index() >= index)
        status, headers, body = get(https[servers.index(follower)].addr,
                                    f"/v1/job/{second.id}?consistent")
        assert status == 200 and body["id"] == second.id
        assert int(headers["X-Nomad-Index"]) >= index
    finally:
        for http in https:
            http.stop()
        for s in servers:
            s.shutdown()
        for transport, _addr in transports:
            transport.close()
