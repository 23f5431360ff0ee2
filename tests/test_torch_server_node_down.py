"""The JAX package's tests/test_node_down.py on the port's Server.
Heartbeat-TTL failure propagation, end to end: a node whose
heartbeats stop (the mock client's heartbeats switched off; the JAX
package drops them with a fault-injection site) must expire its TTL,
go down through the normal status-update path, have its running allocs
marked LOST by the rescheduling eval, get replacements placed on the
surviving nodes — and a lost client report must re-trigger
capacity-blocked evals (the last link the FSM previously dropped)."""

import torch_parity  # noqa: F401  (the port on the CPU)
import time

import pytest

from nomad_tpu_torch import mock
from torch_server import MockClient
from nomad_tpu_torch.server import Server, ServerConfig
from nomad_tpu_torch.structs import consts


def wait_until(fn, timeout=20.0, interval=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if fn():
            return True
        time.sleep(interval)
    return False


@pytest.fixture
def server():
    cfg = ServerConfig(
        num_schedulers=2,
        # Fast TTLs so expiry lands in test time: ttl in [0.3, 0.45],
        # invalidation timer = ttl + grace in [0.45, 0.6].
        min_heartbeat_ttl=0.3,
        heartbeat_grace=0.15,
        max_heartbeats_per_second=1000.0,
        eval_nack_timeout=30.0,
    )
    s = Server(cfg)
    s.start()
    yield s
    s.shutdown()


def test_heartbeat_ttl_node_down_allocs_lost_replacements(server):
    clients = [MockClient(server) for _ in range(3)]
    for c in clients:
        c.start()
    try:
        job = mock.job()
        job.task_groups[0].count = 4
        job.task_groups[0].tasks[0].resources.networks = []
        server.job_register(job)
        assert wait_until(lambda: len([
            a for a in server.fsm.state.allocs_by_job(job.id)
            if a.client_status == consts.ALLOC_CLIENT_RUNNING]) == 4)

        # Pick a node actually holding work, then stop ONLY its
        # heartbeats.
        by_node = {}
        for a in server.fsm.state.allocs_by_job(job.id):
            by_node.setdefault(a.node_id, []).append(a)
        victim_id = max(by_node, key=lambda n: len(by_node[n]))
        victim_allocs = {a.id for a in by_node[victim_id]}
        next(c for c in clients
             if c.node.id == victim_id).heartbeats.clear()

        # TTL expiry -> node down through the normal status path.
        assert wait_until(
            lambda: server.fsm.state.node_by_id(victim_id).status
            == consts.NODE_STATUS_DOWN, 20.0)
        # The down transition fans out a node-update eval for the job.
        assert wait_until(lambda: any(
            e.triggered_by == consts.EVAL_TRIGGER_NODE_UPDATE
            and e.job_id == job.id
            for e in server.fsm.state.evals()))
        # Its scheduler marks the stranded allocs LOST...
        assert wait_until(lambda: all(
            (a := server.fsm.state.alloc_by_id(aid)) is not None
            and a.client_status == consts.ALLOC_CLIENT_LOST
            and a.desired_status == consts.ALLOC_DESIRED_STOP
            for aid in victim_allocs), 20.0), [
                (server.fsm.state.alloc_by_id(aid).client_status,
                 server.fsm.state.alloc_by_id(aid).desired_status)
                for aid in victim_allocs]
        # ...and replacements land on the surviving nodes only.
        assert wait_until(lambda: len([
            a for a in server.fsm.state.allocs_by_job(job.id)
            if not a.terminal_status()
            and a.node_id != victim_id]) == 4, 20.0)
    finally:
        for c in clients:
            c.stop()


def test_lost_client_report_unblocks_capacity_waiters(server):
    """A client syncing client_status=lost frees capacity exactly like
    complete/failed do: evals blocked on that node's class must
    re-trigger (fsm alloc_client_update -> blocked_evals.unblock)."""
    client = MockClient(server)
    client.start()
    try:
        node = client.node
        alloc = mock.alloc()
        alloc.node_id = node.id
        alloc.desired_status = consts.ALLOC_DESIRED_RUN
        alloc.client_status = consts.ALLOC_CLIENT_RUNNING
        server.log.apply("alloc_update", {"allocs": [alloc]})

        blocked = mock.eval()
        blocked.status = consts.EVAL_STATUS_BLOCKED
        # Snapshot AFTER the node registered, or the missed-unblock
        # check re-enqueues it immediately (capacity appeared after an
        # index-0 snapshot) and there is nothing blocked to release.
        blocked.snapshot_index = server.fsm.state.latest_index()
        server.eval_update([blocked])
        assert wait_until(
            lambda: server.blocked_evals.stats()["total_blocked"] == 1)

        lost = alloc.copy()
        lost.client_status = consts.ALLOC_CLIENT_LOST
        server.node_update_allocs([lost])
        assert wait_until(
            lambda: server.blocked_evals.stats()["total_blocked"] == 0)
        # Re-enqueued and picked up by a worker: it leaves `blocked`.
        assert wait_until(
            lambda: server.fsm.state.eval_by_id(blocked.id).status
            != consts.EVAL_STATUS_BLOCKED)
    finally:
        client.stop()
