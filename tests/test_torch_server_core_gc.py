"""The JAX package's tests/test_core_gc.py on the port.

CoreScheduler GC unit tests (mirror nomad/core_sched_test.go):
eval/alloc GC with partial blocking, node GC gated on live allocs,
job GC gated on outstanding evals/allocs, and force-GC bypassing
thresholds."""

import torch_parity  # noqa: F401  (the port on the CPU)
import time

from nomad_tpu_torch import mock
from nomad_tpu_torch.structs import consts


def gc_server():
    from nomad_tpu_torch.server.config import ServerConfig
    from nomad_tpu_torch.server.server import Server

    server = Server(ServerConfig(num_schedulers=1, eval_nack_timeout=5.0))
    server.start()
    return server


def test_eval_gc_reaps_terminal_eval_and_allocs():
    server = gc_server()
    try:
        state = server.fsm.state
        job = mock.job()
        server.log.apply("job_register", {"job": job})
        ev = mock.eval()
        ev.job_id = job.id
        ev.status = consts.EVAL_STATUS_COMPLETE
        server.log.apply("eval_update", {"evals": [ev]})
        alloc = mock.alloc()
        alloc.job_id = job.id
        alloc.job = job
        alloc.eval_id = ev.id
        alloc.desired_status = consts.ALLOC_DESIRED_STOP
        alloc.client_status = consts.ALLOC_CLIENT_COMPLETE
        server.log.apply("alloc_update", {"allocs": [alloc], "job": job})
        server.log.apply("job_deregister", {"job_id": job.id})

        server.force_gc()
        deadline = time.monotonic() + 8
        while time.monotonic() < deadline:
            if (state.eval_by_id(ev.id) is None
                    and state.alloc_by_id(alloc.id) is None):
                break
            time.sleep(0.1)
        assert state.eval_by_id(ev.id) is None
        assert state.alloc_by_id(alloc.id) is None
    finally:
        server.shutdown()


def test_eval_gc_partial_blocked_by_running_alloc():
    """TestCoreScheduler_EvalGC_Partial: an eval with a NON-terminal
    alloc is not reaped."""
    server = gc_server()
    try:
        state = server.fsm.state
        job = mock.job()
        server.log.apply("job_register", {"job": job})
        ev = mock.eval()
        ev.job_id = job.id
        ev.status = consts.EVAL_STATUS_COMPLETE
        server.log.apply("eval_update", {"evals": [ev]})
        alloc = mock.alloc()
        alloc.job_id = job.id
        alloc.job = job
        alloc.eval_id = ev.id
        alloc.desired_status = consts.ALLOC_DESIRED_RUN
        alloc.client_status = consts.ALLOC_CLIENT_RUNNING
        server.log.apply("alloc_update", {"allocs": [alloc], "job": job})

        server.force_gc()
        time.sleep(1.0)
        assert state.eval_by_id(ev.id) is not None  # still referenced
        assert state.alloc_by_id(alloc.id) is not None
    finally:
        server.shutdown()


def test_node_gc_reaps_down_node_without_allocs():
    server = gc_server()
    try:
        state = server.fsm.state
        node = mock.node()
        server.log.apply("node_register", {"node": node})
        server.log.apply("node_update_status",
                         {"node_id": node.id,
                          "status": consts.NODE_STATUS_DOWN})
        server.force_gc()
        deadline = time.monotonic() + 8
        while time.monotonic() < deadline:
            if state.node_by_id(node.id) is None:
                break
            time.sleep(0.1)
        assert state.node_by_id(node.id) is None
    finally:
        server.shutdown()


def test_node_gc_blocked_by_running_alloc():
    """TestCoreScheduler_NodeGC_RunningAllocs: a down node with a
    non-terminal alloc is kept."""
    server = gc_server()
    try:
        state = server.fsm.state
        node = mock.node()
        server.log.apply("node_register", {"node": node})
        job = mock.job()
        server.log.apply("job_register", {"job": job})
        alloc = mock.alloc()
        alloc.node_id = node.id
        alloc.job_id = job.id
        alloc.job = job
        alloc.desired_status = consts.ALLOC_DESIRED_RUN
        alloc.client_status = consts.ALLOC_CLIENT_RUNNING
        server.log.apply("alloc_update", {"allocs": [alloc], "job": job})
        server.log.apply("node_update_status",
                         {"node_id": node.id,
                          "status": consts.NODE_STATUS_DOWN})
        server.force_gc()
        time.sleep(1.0)
        assert state.node_by_id(node.id) is not None
    finally:
        server.shutdown()


def test_node_gc_allows_terminal_allocs():
    """TestCoreScheduler_NodeGC_TerminalAllocs: terminal allocs don't
    pin a down node."""
    server = gc_server()
    try:
        state = server.fsm.state
        node = mock.node()
        server.log.apply("node_register", {"node": node})
        job = mock.job()
        server.log.apply("job_register", {"job": job})
        alloc = mock.alloc()
        alloc.node_id = node.id
        alloc.job_id = job.id
        alloc.job = job
        alloc.desired_status = consts.ALLOC_DESIRED_STOP
        alloc.client_status = consts.ALLOC_CLIENT_COMPLETE
        server.log.apply("alloc_update", {"allocs": [alloc], "job": job})
        server.log.apply("node_update_status",
                         {"node_id": node.id,
                          "status": consts.NODE_STATUS_DOWN})
        server.force_gc()
        deadline = time.monotonic() + 8
        while time.monotonic() < deadline:
            if state.node_by_id(node.id) is None:
                break
            time.sleep(0.1)
        assert state.node_by_id(node.id) is None
    finally:
        server.shutdown()
