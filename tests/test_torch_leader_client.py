"""The port's RemoteLeader (nomad_tpu_torch/server/leader_client.py)
against a leader's broker, plan queue and heartbeats through its
HTTPServer's internal routes: a JAX Server behind the JAX HTTPServer,
and a port Server behind the port's. The wire format is the JAX API's,
and what comes back is the port's structs. As in
tests/test_httppool.py:123, the follower path goes through serf tags on
a port Server that is not the leader."""

import time
from types import SimpleNamespace

import pytest

import torch_parity  # noqa: F401  (the port on the CPU)
from nomad_tpu import mock as ref_mock
from nomad_tpu.api import HTTPServer as RefHTTPServer
from nomad_tpu.server import Server as RefServer
from nomad_tpu.server import ServerConfig as RefConfig
from nomad_tpu.structs import consts
from nomad_tpu.utils.codec import to_dict as ref_to_dict
from nomad_tpu_torch import mock as port_mock
from nomad_tpu_torch.api import HTTPServer
from nomad_tpu_torch.server import Server, ServerConfig
from nomad_tpu_torch.server.leader_client import (
    LeaderUnavailableError,
    RemoteLeader,
)
from nomad_tpu_torch.structs import Evaluation, Plan, PlanResult
from nomad_tpu_torch.utils.codec import from_dict, to_dict


def wait_until(fn, timeout=20.0, interval=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if fn():
            return True
        time.sleep(interval)
    return False


LEADERS = {
    "jax": SimpleNamespace(server=RefServer, config=RefConfig,
                           http=RefHTTPServer, mock=ref_mock,
                           to_dict=ref_to_dict),
    "port": SimpleNamespace(server=Server, config=ServerConfig,
                            http=HTTPServer, mock=port_mock,
                            to_dict=to_dict),
}


@pytest.fixture(params=sorted(LEADERS))
def leader(request):
    """A worker-less dev server (its own leader) behind its HTTP API,
    so the test's dequeues are the broker's only consumers: the JAX
    package's, then the port's."""
    pkg = LEADERS[request.param]
    server = pkg.server(pkg.config(num_schedulers=0, eval_nack_timeout=5.0))
    server.start()
    http = pkg.http(server)
    http.start()
    server.pkg = pkg
    yield server, http
    http.stop()
    server.shutdown()


def parked_evals(server, n):
    evals = []
    for _ in range(n):
        ev = server.pkg.mock.eval()
        ev.type = consts.JOB_TYPE_SERVICE
        evals.append(ev)
    server.broker.enqueue_all(evals)
    assert wait_until(lambda: server.broker.stats()["total_ready"] == n)
    return evals


def test_remote_leader_drains_and_nacks_a_reference_broker(leader):
    server, http = leader
    evals = parked_evals(server, 4)
    remote = RemoteLeader(http.addr)
    pairs = remote.eval_dequeue_many([consts.JOB_TYPE_SERVICE], 10)
    assert len(pairs) == 4
    by_id = {ev.id: ev for ev in evals}
    for ev, token in pairs:
        assert isinstance(ev, Evaluation) and token
        assert to_dict(ev) == server.pkg.to_dict(by_id[ev.id])
        assert remote.eval_outstanding(ev.id) == token
        remote.eval_nack(ev.id, token)  # put them back
    assert wait_until(lambda: server.broker.stats()["total_ready"] == 4)

    # The long-poll dequeue, the nack timer's pause and resume, the ack.
    ev, token = remote.eval_dequeue([consts.JOB_TYPE_SERVICE], 1.0)
    assert isinstance(ev, Evaluation) and ev.id in by_id
    remote.eval_pause_nack(ev.id, token)
    remote.eval_resume_nack(ev.id, token)
    remote.eval_ack(ev.id, token)
    assert server.broker.outstanding(ev.id) is None
    # A stale token is refused by the broker, not applied twice.
    with pytest.raises(LeaderUnavailableError):
        remote.eval_ack(ev.id, token)


def test_remote_leader_submits_a_plan_and_resets_heartbeats(leader):
    """A port Plan crosses to the leader's applier and its PlanResult
    comes back as the port's struct; the heartbeat reset returns the
    leader's TTL."""
    server, http = leader
    mock, dump = server.pkg.mock, server.pkg.to_dict
    node = mock.node()
    server.node_register(node)
    job = mock.job()
    job.task_groups[0].count = 1
    server.job_register(job)
    ev, token = server.broker.dequeue([consts.JOB_TYPE_SERVICE], 5.0)
    assert ev is not None
    stored = server.fsm.state.job_by_id(job.id)
    alloc = mock.alloc()
    alloc.job, alloc.job_id = stored, stored.id
    alloc.node_id, alloc.eval_id = node.id, ev.id
    plan = from_dict(Plan, {"eval_id": ev.id, "eval_token": token,
                            "priority": 50, "job": dump(stored),
                            "node_allocation": {
                                node.id: [dump(alloc)]}})
    remote = RemoteLeader(http.addr)
    result = remote.plan_submit(plan)
    assert isinstance(result, PlanResult)
    assert [a.id for a in result.node_allocation[node.id]] == [alloc.id]
    assert server.fsm.state.alloc_by_id(alloc.id) is not None
    server.broker.ack(ev.id, token)
    assert remote.heartbeat_reset(node.id) > 0.0


def test_follower_server_forwards_through_serf_tags(leader):
    """A port Server that is not the leader and knows the leader only by
    its raft address resolves the leader's HTTP address from serf tags
    and routes every leader-only operation there."""
    server, http = leader
    parked_evals(server, 4)
    follower = Server(ServerConfig(num_schedulers=0))
    try:
        follower.cluster = {}
        follower.raft = SimpleNamespace(
            leader_id="L", is_leader=lambda: False, stop=lambda: None)
        follower.serf_members = lambda: [SimpleNamespace(
            tags={"rpc_addr": "L", "http_addr": http.addr})]
        assert follower.leader_http_addr() == http.addr
        pairs = follower.eval_dequeue_many([consts.JOB_TYPE_SERVICE], 10)
        assert len(pairs) == 4
        for ev, token in pairs:
            assert isinstance(ev, Evaluation)
            assert follower.eval_outstanding(ev.id) == token
            follower.eval_ack(ev.id, token)
        assert server.broker.stats()["total_unacked"] == 0
        # The cached client serves the next call; a leader without an
        # address leaves the follower's dequeue empty-handed.
        assert follower._remote_leader() is follower._remote_leader()
        follower.serf_members = lambda: []
        assert follower.eval_dequeue_many([consts.JOB_TYPE_SERVICE], 4) == []
        with pytest.raises(ValueError, match="no leader"):
            follower.plan_submit(Plan(eval_id="x"))
    finally:
        follower.shutdown()
