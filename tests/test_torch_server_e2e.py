"""The JAX package's tests/test_server_e2e.py on the port (the mock
client is tests/torch_server.py's).

End-to-end dev-server tests: eval -> worker -> plan -> commit ->
client status (mirror nomad/ integration tests run in dev mode)."""

import torch_parity  # noqa: F401  (the port on the CPU)
import time

import pytest

from nomad_tpu_torch import mock
from torch_server import MockClient
from nomad_tpu_torch.server import Server, ServerConfig
from nomad_tpu_torch.structs import consts


def wait_until(fn, timeout=5.0, interval=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if fn():
            return True
        time.sleep(interval)
    return False


@pytest.fixture
def server():
    cfg = ServerConfig(num_schedulers=2, eval_nack_timeout=5.0)
    s = Server(cfg)
    s.start()
    yield s
    s.shutdown()


def test_job_register_end_to_end(server):
    clients = [MockClient(server) for _ in range(3)]
    for c in clients:
        c.start()
    try:
        job = mock.job()
        job.task_groups[0].count = 5
        eval_id, _ = server.job_register(job)

        assert wait_until(
            lambda: (e := server.fsm.state.eval_by_id(eval_id)) is not None
            and e.status == consts.EVAL_STATUS_COMPLETE
        ), server.fsm.state.eval_by_id(eval_id)

        allocs = server.fsm.state.allocs_by_job(job.id)
        assert len(allocs) == 5
        # mock clients flip them to running
        assert wait_until(
            lambda: all(
                a.client_status == consts.ALLOC_CLIENT_RUNNING
                for a in server.fsm.state.allocs_by_job(job.id)
            )
        )
        assert server.fsm.state.job_by_id(job.id).status == consts.JOB_STATUS_RUNNING
        summary = server.fsm.state.job_summary_by_id(job.id)
        assert summary.summary["web"].running == 5
    finally:
        for c in clients:
            c.stop()


def test_job_register_without_capacity_blocks_then_unblocks(server):
    job = mock.job()
    job.task_groups[0].count = 3
    eval_id, _ = server.job_register(job)

    # no nodes: eval completes with failed allocs + a blocked eval
    assert wait_until(
        lambda: (e := server.fsm.state.eval_by_id(eval_id)) is not None
        and e.status == consts.EVAL_STATUS_COMPLETE
        and e.blocked_eval != ""
    )
    blocked_id = server.fsm.state.eval_by_id(eval_id).blocked_eval
    assert server.fsm.state.eval_by_id(blocked_id).status == consts.EVAL_STATUS_BLOCKED

    # a node joins -> blocked eval unblocks -> placements happen
    client = MockClient(server)
    client.start()
    try:
        assert wait_until(
            lambda: len(server.fsm.state.allocs_by_job(job.id)) == 3, timeout=8.0
        )
    finally:
        client.stop()


def test_sparse_client_terminal_update_unblocks_capacity_evals(server):
    """Regression: the live client's alloc sync sends SPARSE allocs
    (id + client_status only, client/agent.py _flush_dirty) — the FSM
    must resolve the node from the stored alloc or the capacity
    unblock never fires and blocked evals wedge forever (found driving
    a real agent: 16/30 batch jobs never placed)."""
    from nomad_tpu_torch.structs import Allocation

    node = mock.node()
    node.resources.cpu = 2000
    node.compute_class()
    server.node_register(node)

    jobs = []
    for i in range(5):
        j = mock.job()
        j.id = j.name = f"wave-{i}"
        j.type = "batch"
        j.task_groups[0].count = 1
        j.task_groups[0].tasks[0].resources.cpu = 600
        j.task_groups[0].tasks[0].resources.networks = []
        jobs.append(j)
        server.job_register(j)

    # 3 fit (2000/600), 2 block on capacity.
    assert wait_until(
        lambda: len([a for a in server.fsm.state.allocs()
                     if a.desired_status == consts.ALLOC_DESIRED_RUN]) == 3
        and server.blocked_evals.stats()["total_blocked"] == 2
    )

    # Complete the running allocs the way the REAL client does: a
    # sparse record with no node_id.
    sparse = [
        Allocation(id=a.id, client_status=consts.ALLOC_CLIENT_COMPLETE)
        for a in server.fsm.state.allocs()
        if a.desired_status == consts.ALLOC_DESIRED_RUN
    ]
    server.node_update_allocs(sparse)
    assert wait_until(
        lambda: server.blocked_evals.stats()["total_blocked"] == 0)
    assert wait_until(
        lambda: len(server.fsm.state.allocs()) == 5, timeout=8.0)


def test_node_down_triggers_replacement(server):
    c1 = MockClient(server)
    c2 = MockClient(server)
    c1.start()
    c2.start()
    try:
        job = mock.job()
        job.task_groups[0].count = 2
        server.job_register(job)
        assert wait_until(
            lambda: len(
                [a for a in server.fsm.state.allocs_by_job(job.id)
                 if a.client_status == consts.ALLOC_CLIENT_RUNNING]
            ) == 2
        )
        # kill node 1: its alloc is lost and replaced on node 2
        c1.stop()
        server.node_update_status(c1.node.id, consts.NODE_STATUS_DOWN)
        assert wait_until(
            lambda: all(
                a.node_id == c2.node.id
                for a in server.fsm.state.allocs_by_job(job.id)
                if not a.terminal_status()
            )
            and len(
                [a for a in server.fsm.state.allocs_by_job(job.id)
                 if not a.terminal_status()]
            ) == 2,
            timeout=8.0,
        )
    finally:
        c2.stop()


def test_job_deregister_stops_allocs(server):
    client = MockClient(server)
    client.start()
    try:
        job = mock.job()
        job.task_groups[0].count = 2
        server.job_register(job)
        assert wait_until(
            lambda: len(server.fsm.state.allocs_by_job(job.id)) == 2
        )
        server.job_deregister(job.id)
        assert wait_until(
            lambda: all(
                a.desired_status == consts.ALLOC_DESIRED_STOP
                for a in server.fsm.state.allocs_by_job(job.id)
            )
        )
        assert wait_until(
            lambda: server.fsm.state.job_by_id(job.id) is None
        )
    finally:
        client.stop()


def test_system_job_runs_on_new_nodes(server):
    job = mock.system_job()
    server.job_register(job)
    clients = [MockClient(server) for _ in range(2)]
    for c in clients:
        c.start()
    try:
        # node-update evals fan the system job onto each node
        assert wait_until(
            lambda: {
                a.node_id
                for a in server.fsm.state.allocs_by_job(job.id)
                if not a.terminal_status()
            }
            == {c.node.id for c in clients},
            timeout=8.0,
        )
    finally:
        for c in clients:
            c.stop()


def test_job_plan_dry_run(server):
    client = MockClient(server)
    client.start()
    try:
        job = mock.job()
        job.task_groups[0].count = 2
        result = server.job_plan(job)
        assert result["annotations"] is not None
        assert result["annotations"].desired_tg_updates["web"].place == 2
        # nothing committed
        assert server.fsm.state.job_by_id(job.id) is None
        assert server.fsm.state.allocs_by_job(job.id) == []
    finally:
        client.stop()


def test_eval_gc(server):
    job = mock.job()
    job.task_groups[0].count = 1
    client = MockClient(server)
    client.start()
    try:
        eval_id, _ = server.job_register(job)
        assert wait_until(
            lambda: (e := server.fsm.state.eval_by_id(eval_id)) is not None
            and e.status == consts.EVAL_STATUS_COMPLETE
        )
        server.job_deregister(job.id)
        assert wait_until(lambda: server.fsm.state.job_by_id(job.id) is None)
        assert wait_until(
            lambda: all(
                a.client_status == consts.ALLOC_CLIENT_COMPLETE
                for a in server.fsm.state.allocs_by_job(job.id)
            )
        )
        server.force_gc()
        assert wait_until(
            lambda: server.fsm.state.eval_by_id(eval_id) is None, timeout=8.0
        )
        assert server.fsm.state.allocs_by_job(job.id) == []
    finally:
        client.stop()


def test_periodic_job_launches_children(server):
    from nomad_tpu_torch.structs import PeriodicConfig

    client = MockClient(server)
    client.start()
    try:
        job = mock.job()
        job.task_groups[0].count = 1
        job.periodic = PeriodicConfig(enabled=True, spec="0 0 1 1 *")
        eval_id, _ = server.job_register(job)
        assert eval_id == ""  # periodic parents get no eval
        assert server.fsm.state.job_by_id(job.id).status == consts.JOB_STATUS_RUNNING

        child_id = server.periodic_force(job.id)
        assert child_id is not None and child_id.startswith(f"{job.id}/periodic-")
        assert wait_until(
            lambda: len(server.fsm.state.allocs_by_job(child_id)) == 1
        )
        launch = server.fsm.state.periodic_launch_by_id(job.id)
        assert launch is not None
    finally:
        client.stop()


def test_heartbeat_expiry_marks_node_down():
    cfg = ServerConfig(
        num_schedulers=1,
        min_heartbeat_ttl=0.2,
        heartbeat_grace=0.1,
        max_heartbeats_per_second=1000.0,
    )
    s = Server(cfg)
    s.start()
    try:
        node = mock.node()
        node.status = consts.NODE_STATUS_INIT
        s.node_register(node)
        s.node_update_status(node.id, consts.NODE_STATUS_READY)
        # never heartbeat again: TTL expires
        assert wait_until(
            lambda: s.fsm.state.node_by_id(node.id).status == consts.NODE_STATUS_DOWN,
            timeout=5.0,
        )
    finally:
        s.shutdown()


def test_gpu_factory_routing():
    cfg = ServerConfig(
        num_schedulers=1,
        scheduler_factories={"service": "service-gpu"},
    )
    s = Server(cfg)
    s.start()
    client = MockClient(s)
    client.start()
    try:
        job = mock.job()
        job.task_groups[0].count = 3
        eval_id, _ = s.job_register(job)
        assert wait_until(
            lambda: (e := s.fsm.state.eval_by_id(eval_id)) is not None
            and e.status == consts.EVAL_STATUS_COMPLETE,
            timeout=30.0,
        )
        assert len(s.fsm.state.allocs_by_job(job.id)) == 3
    finally:
        client.stop()
        s.shutdown()
