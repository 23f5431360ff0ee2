"""The JAX package's tests/test_factory_routing.py on the port's
Server. Latency-aware factory routing: with a dense (``-gpu``) factory
configured, a LONE eval runs on the host iterator pipeline
(millisecond latency — it must not pay the batch window + device
round trip), while a drained batch runs dense and coalesces into
shared device dispatches."""

import torch_parity  # noqa: F401  (the port on the CPU)
import time

import pytest

from nomad_tpu_torch import mock
from nomad_tpu_torch.scheduler.batcher import get_batcher
from nomad_tpu_torch.server import Server, ServerConfig
from nomad_tpu_torch.server.worker import host_factory, is_dense_factory


def wait_until(fn, timeout=30.0, interval=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if fn():
            return True
        time.sleep(interval)
    return False


def make_server(**over):
    kw = dict(num_schedulers=1,
              scheduler_factories={"service": "service-gpu"},
              eval_batch_size=16)
    kw.update(over)
    server = Server(ServerConfig(**kw))
    server.start()
    return server


def park(server):
    """Pause every worker and wait until each is parked: a worker still
    inside its blocking dequeue would take the first eval registered
    next, and the pipeline would drain the rest before the storm
    stands."""
    for w in server.workers:
        w.set_pause(True)
    assert wait_until(lambda: all(w.parked() for w in server.workers), 10.0)


def seed_nodes(server, n=8):
    for _ in range(n):
        node = mock.node()
        node.compute_class()
        server.node_register(node)


def test_host_factory_mapping():
    assert host_factory("service-gpu") == "service"
    assert host_factory("batch-gpu") == "batch"
    assert host_factory("service") == "service"
    assert is_dense_factory("system-gpu")
    assert not is_dense_factory("system")
    # Kernel-pinned dense variants (nomad_tpu_torch/kernels) fall back to
    # the SAME host factory: the kernel infix strips with the suffix.
    assert host_factory("service-convex-gpu") == "service"
    assert host_factory("batch-greedy-gpu") == "batch"
    assert is_dense_factory("service-convex-gpu")


def test_gpu_suffix_fallback_registers_lazily():
    """scheduler/__init__.py: an unregistered `*-gpu` name triggers
    lazy dense-factory registration (including every kernel's pinned
    variants) instead of failing — and a name that is neither
    registered nor a -gpu factory fails loudly."""
    import logging

    import pytest as _pytest

    from nomad_tpu_torch import scheduler as sched_mod
    from nomad_tpu_torch.scheduler.testing import Harness

    # Force the lazy path even if another test already registered the
    # dense factories in this process.
    for name in [n for n in sched_mod.scheduler_names()
                 if n.endswith("-gpu")]:
        sched_mod._BUILTIN.pop(name)
    h = Harness()
    logger = logging.getLogger("test")

    s = sched_mod.new_scheduler("service-gpu", logger, h.snapshot(), h)
    assert type(s).__name__ == "BatchedGPUScheduler"
    assert s.kernel is None  # defers to the process-global kernel
    # Kernel-pinned variant, also via the fallback.
    for name in [n for n in sched_mod.scheduler_names()
                 if n.endswith("-gpu")]:
        sched_mod._BUILTIN.pop(name)
    s2 = sched_mod.new_scheduler(
        "batch-convex-gpu", logger, h.snapshot(), h)
    assert type(s2).__name__ == "BatchedGPUScheduler"
    assert s2.kernel == "convex"
    assert s2.batch is True

    with _pytest.raises(ValueError, match="unknown scheduler"):
        sched_mod.new_scheduler("service-xyz", logger, h.snapshot(), h)
    # An unknown KERNEL variant: the -gpu fallback registers the real
    # kernels, the typo'd name stays unknown and fails loudly.
    with _pytest.raises(ValueError, match="unknown scheduler"):
        sched_mod.new_scheduler(
            "service-convexx-gpu", logger, h.snapshot(), h)


def test_unknown_placement_kernel_fails_at_server_init():
    """A typo'd `placement_kernel` must abort Server construction with
    the registered-kernel list — not surface at the first eval."""
    import pytest as _pytest

    from nomad_tpu_torch.kernels import active_kernel, configure

    before = active_kernel()
    try:
        with _pytest.raises(ValueError, match="unknown placement kernel"):
            Server(ServerConfig(num_schedulers=1,
                                placement_kernel="convexx"))
        # The valid names configure cleanly (no server needed).
        configure("convex")
        assert active_kernel() == "convex"
        configure("greedy")
    finally:
        configure(before)


def test_placement_kernel_knob_reaches_stats_surface():
    """ServerConfig.placement_kernel = "convex" routes dense evals
    through the convex kernel, and the quality scoreboard surfaces it
    in server.stats()["placement_quality"]."""
    from nomad_tpu_torch.kernels import active_kernel, configure
    from nomad_tpu_torch.kernels.quality import get_board

    before = active_kernel()
    get_board().reset()
    server = make_server(placement_kernel="convex")
    try:
        seed_nodes(server)
        park(server)
        jobs = []
        for _ in range(4):
            job = mock.job()
            job.task_groups[0].count = 5  # >3 so the dense path engages
            server.job_register(job)
            jobs.append(job)
        assert wait_until(lambda: server.broker.ready_count() >= 4)
        for w in server.workers:
            w.set_pause(False)
        assert wait_until(
            lambda: all(
                len(server.fsm.state.allocs_by_job(j.id)) == 5
                for j in jobs),
            timeout=60.0,
        )
        pq = server.stats()["placement_quality"]
        assert "convex" in pq["kernels"], pq
        entry = pq["kernels"]["convex"]
        assert entry["samples"] > 0
        assert 0.0 <= entry["fragmentation"] <= 1.0
        assert 0.0 <= entry["binpack_score"] <= 1.0
        assert "queueing_delay_ms" in pq
    finally:
        server.shutdown()
        configure(before)


def test_lone_eval_routes_to_host_path():
    """One job registered on an idle broker: placements must NOT go
    through the device batcher."""
    server = make_server()
    try:
        seed_nodes(server)
        batcher = get_batcher()
        before = batcher.batched_requests
        job = mock.job()
        job.task_groups[0].count = 3
        server.job_register(job)
        assert wait_until(
            lambda: len(server.fsm.state.allocs_by_job(job.id)) == 3)
        # Placed by the host pipeline: zero new batcher traffic.
        assert batcher.batched_requests == before
    finally:
        server.shutdown()


def test_eval_storm_routes_to_dense_path():
    """Many ready evals drain as one batch and ride the device
    batcher."""
    server = make_server()
    try:
        seed_nodes(server)
        batcher = get_batcher()
        before_req = batcher.batched_requests
        park(server)
        jobs = []
        for _ in range(6):
            job = mock.job()
            job.task_groups[0].count = 5  # >3 so the dense path engages
            server.job_register(job)
            jobs.append(job)
        assert wait_until(lambda: server.broker.ready_count() >= 6)
        for w in server.workers:
            w.set_pause(False)
        assert wait_until(
            lambda: all(
                len(server.fsm.state.allocs_by_job(j.id)) == 5 for j in jobs),
            timeout=60.0,
        )
        # The drained batch went dense: batcher served its requests.
        assert batcher.batched_requests > before_req
    finally:
        server.shutdown()


def test_dense_min_batch_one_forces_dense():
    """Operators can force the dense path for every eval."""
    server = make_server(dense_min_batch=1)
    try:
        seed_nodes(server)
        batcher = get_batcher()
        before = batcher.batched_requests
        job = mock.job()
        job.task_groups[0].count = 6  # >3: small-K host fallback skipped
        server.job_register(job)
        assert wait_until(
            lambda: len(server.fsm.state.allocs_by_job(job.id)) == 6,
            timeout=60.0,
        )
        assert batcher.batched_requests > before
    finally:
        server.shutdown()


def test_batch_size_one_runs_dense_alone():
    """eval_batch_size=1 turns the dispatch pipeline off: the worker
    runs each dense eval alone on the factory it was configured with,
    with no routing to the host."""
    server = make_server(eval_batch_size=1)
    try:
        assert not server.dispatch.enabled
        seed_nodes(server)
        batcher = get_batcher()
        before = batcher.batched_requests
        job = mock.job()
        job.task_groups[0].count = 6  # >3: small-K host fallback skipped
        server.job_register(job)
        assert wait_until(
            lambda: len(server.fsm.state.allocs_by_job(job.id)) == 6,
            timeout=60.0,
        )
        assert batcher.batched_requests > before
        pipe = server.stats()["dispatch_pipeline"]
        assert pipe["batches"] == 0 and pipe["routed_host"] == 0, pipe
    finally:
        server.shutdown()


@pytest.mark.parametrize("option", [
    "node_name", "bootstrap_expect", "dispatch_pipeline", "executive_threads", "defrag_interval",
    "defrag_min_gain", "defrag_max_moves_per_wave", "read_mux_enabled",
    "read_mux_workers", "read_mux_max_parked", "read_scoped_index",
    "breaker_enabled", "breaker_failure_threshold", "breaker_slow_ms",
    "breaker_slow_batches", "breaker_cooldown",
])
def test_options_of_unported_parts_are_refused(option):
    """An option whose part the port does not carry is not accepted and
    then ignored: ServerConfig has no such field."""
    with pytest.raises(TypeError):
        ServerConfig(**{option: 1})


@pytest.mark.parametrize("option,names", [
    ("scheduler_executive", "executive"),
    ("defrag_enabled", "DefragLoop"),
])
def test_unported_parts_raise(option, names):
    """The executive and the defrag loop are kept as options of the
    reference's config, and a server asked for either refuses to
    start."""
    with pytest.raises(NotImplementedError, match=names):
        Server(ServerConfig(**{option: True}))
