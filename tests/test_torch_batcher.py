"""The port's coalescing batcher (nomad_tpu_torch/scheduler/batcher.py)
on the CPU, mirroring tests/test_batcher.py and
tests/test_batcher_overlay.py, and held against the JAX package's
batcher on the same cohorts. The mesh cases give the port's batcher an
8-shard CPU mesh; the JAX batcher shards over its 8 virtual CPU
devices by itself (tests/conftest.py).

Choices must be identical and scores within 1e-4 absolute (float32
pow(10, x) may differ in the last ulp between XLA's and torch's CPU
code)."""

from __future__ import annotations

import threading

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (the port on the CPU, one torch thread)

import nomad_tpu_torch.scheduler.batcher as batcher_mod
from nomad_tpu import mock
from nomad_tpu.models.matrix import ClusterMatrix as RefMatrix
from nomad_tpu.ops import binpack as jb
from nomad_tpu.scheduler.batcher import PlacementBatcher as RefBatcher
from nomad_tpu.structs import consts
from nomad_tpu_torch.models.matrix import ClusterMatrix
from nomad_tpu_torch.ops import binpack as tb
from nomad_tpu_torch.scheduler.batcher import PlacementBatcher
from torch_parity import (
    build_reference_cluster,
    carry_over,
    distinct_hosts_job,
    two_group_job,
)

SCORE_TOL = 1e-4
CONFIG = tb.PlacementConfig(anti_affinity_penalty=10.0)
REF_CONFIG = jb.PlacementConfig(anti_affinity_penalty=10.0)


def tiny_inputs(n=128, k=8, g=2, seed=0):
    """tests/test_batcher.py's inputs: a uniform cluster, host key."""
    state = jb.make_node_state(
        capacity=np.tile([4000, 8192, 100000, 150], (n, 1)),
        sched_capacity=np.tile([3900, 7936, 96000, 150], (n, 1)),
        util=np.tile([100.0, 256.0, 4096.0, 0.0], (n, 1)),
        bw_avail=np.full(n, 1000.0), bw_used=np.zeros(n),
        ports_free=np.full(n, 40000.0), job_count=np.zeros(n, np.int32),
        tg_count=np.zeros((n, g), np.int32), feasible=np.ones((n, g), bool),
        node_ok=np.ones(n, bool))
    asks = jb.make_asks(
        resources=np.tile([500, 256, 150, 0], (k, 1)), bw=np.full(k, 50.0),
        ports=np.full(k, 2.0), tg_index=np.arange(k, dtype=np.int32) % g,
        active=np.ones(k, bool), job_distinct_hosts=False,
        tg_distinct_hosts=np.zeros(g, bool))
    return state, asks, jb.host_prng_key(seed)


def direct(state, asks, key):
    """Oracle: the reference's unbatched program on the full state."""
    full = jb.make_node_state(
        state.capacity, state.sched_capacity, state.util, state.bw_avail,
        state.bw_used, state.ports_free, state.job_count, state.tg_count,
        state.feasible, state.node_ok)
    c, s, _ = jb.placement_program_jit(full, asks, key, REF_CONFIG)
    return np.asarray(c), np.asarray(s)


def assert_result(got, want):
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(want[0]))
    assert np.abs(np.asarray(got[1]) - np.asarray(want[1])).max() \
        <= SCORE_TOL


def run_threads(fn, n, timeout=60):
    errors = []

    def wrap(i):
        try:
            fn(i)
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=wrap, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout)
    assert all(not t.is_alive() for t in threads), "worker deadlocked"
    return errors


# ------------------------------------------------ tests/test_batcher.py


def test_single_request_matches_direct_program():
    batcher = PlacementBatcher("cpu", window=0.001)
    state, asks, key = tiny_inputs(seed=3)
    assert_result(batcher.place(state, asks, key, CONFIG),
                  direct(state, asks, key))
    assert batcher.stats()["lone_dispatches"] == 1


def test_concurrent_requests_share_one_dispatch():
    """With pre_resolve off the batched results do not depend on how
    the batch formed: each equals the reference's lone result."""
    batcher = PlacementBatcher("cpu", window=0.25)
    results = {}

    def worker(i):
        state, asks, key = tiny_inputs(seed=i)
        results[i] = batcher.place(state, asks, key, CONFIG)

    assert not run_threads(worker, 6)
    assert len(results) == 6
    assert batcher.dispatches < 6
    assert batcher.batched_requests == 6
    for i in range(6):
        assert_result(results[i], direct(*tiny_inputs(seed=i)))


def test_place_cohort_matches_direct_program_and_never_parks():
    batcher = PlacementBatcher("cpu", window=0.25)
    reqs = [(*tiny_inputs(seed=100 + i), CONFIG, None) for i in range(6)]
    before_threads = threading.active_count()
    results = batcher.place_cohort(reqs)
    assert threading.active_count() <= before_threads
    assert len(results) == 6
    for (state, asks, key, _c, _s), got in zip(reqs, results):
        assert_result(got, direct(state, asks, key))
    stats = batcher.stats()
    assert stats["cohort_dispatches"] == 1
    assert stats["batched_requests"] == 6
    assert stats["dispatches"] == 1


def test_place_cohort_groups_mixed_shapes():
    batcher = PlacementBatcher("cpu", window=0.25)
    s1, a1, k1 = tiny_inputs(seed=1)
    s2, a2, k2 = tiny_inputs(n=64, k=4, seed=2)
    results = batcher.place_cohort([
        (s1, a1, k1, CONFIG, None), (s2, a2, k2, CONFIG, None),
        (s1, a1, k1, CONFIG, None)])
    assert len(results) == 3
    assert batcher.stats()["dispatches"] == 2
    for inputs, got in zip(((s1, a1, k1), (s2, a2, k2), (s1, a1, k1)),
                           results):
        assert_result(got, direct(*inputs))


def test_mixed_shapes_do_not_batch_together():
    batcher = PlacementBatcher("cpu", window=0.05)
    out = {}

    def worker(i):
        state, asks, key = tiny_inputs(n=(128, 256)[i])
        out[i] = batcher.place(state, asks, key, CONFIG)

    assert not run_threads(worker, 2)
    assert out[0][0].shape == out[1][0].shape  # both [K]
    assert batcher.dispatches == 2


def test_dispatch_error_propagates_to_all_requests(monkeypatch):
    batcher = PlacementBatcher("cpu", window=0.2)
    state, asks, key = tiny_inputs()
    bad_asks = asks._replace(resources=np.asarray([[1.0]]))  # wrong shape
    with pytest.raises(Exception):
        batcher.place(state, bad_asks, key, CONFIG)

    # A fault of the dispatch reaches every request of the batch.
    def boom(self, batch, config):
        raise RuntimeError("device fault")

    monkeypatch.setattr(PlacementBatcher, "_run_batch", boom)
    batcher = PlacementBatcher("cpu", window=0.25)
    errors = run_threads(
        lambda i: batcher.place(*tiny_inputs(seed=i), CONFIG), 4)
    assert len(errors) == 4
    assert all("device fault" in str(e) for e in errors)
    with pytest.raises(RuntimeError, match="device fault"):
        batcher.place_cohort([(*tiny_inputs(), CONFIG, None)])


def test_gpu_scheduler_uses_batcher():
    """The service-gpu factory's placements flow through the global
    batcher."""
    from nomad_tpu_torch import mock as port_mock
    from nomad_tpu_torch.scheduler.batcher import get_batcher
    from nomad_tpu_torch.scheduler.testing import Harness
    from nomad_tpu_torch.structs import consts as port_consts
    from nomad_tpu_torch.structs.eval import new_eval

    batcher = get_batcher()
    before = batcher.stats()["batched_requests"]
    h = Harness(seed=9)
    for _ in range(4):
        n = port_mock.node()
        n.compute_class()
        h.state.upsert_node(h.next_index(), n)
    job = port_mock.job()
    job.task_groups[0].count = 4  # >3: below that the host path runs
    h.state.upsert_job(h.next_index(), job)
    h.process("service-gpu",
              new_eval(job, port_consts.EVAL_TRIGGER_JOB_REGISTER))
    assert len(h.state.allocs_by_job(job.id)) == 4
    assert batcher.stats()["batched_requests"] > before


def test_overflow_beyond_max_batch_all_served():
    batcher = PlacementBatcher("cpu", max_batch=3, window=0.25)
    results = {}

    def worker(i):
        results[i] = batcher.place(*tiny_inputs(seed=i), CONFIG)

    assert not run_threads(worker, 8, timeout=90)
    assert len(results) == 8
    assert batcher.batched_requests == 8
    assert batcher.dispatches >= 3  # ceil(8/3)


def test_pad_ladders():
    from nomad_tpu_torch.scheduler.batcher import (
        BATCH_BUCKETS,
        ROW_BUCKETS,
        _pad_batch,
        _pad_rows,
    )

    for n in range(1, 65):
        b = _pad_batch(n, 64)
        assert b >= n and (b in BATCH_BUCKETS or b == 64)
    assert _pad_batch(1, 64) == 4
    assert _pad_batch(3, 64) == 4
    assert _pad_batch(17, 64) == 64
    assert _pad_batch(100, 64) == 64  # capped at max_batch
    rows = _pad_rows([7, 3, 9])
    assert len(rows) == ROW_BUCKETS[0]
    assert rows.dtype == np.int32
    assert list(rows[:3]) == [7, 3, 9]
    assert (rows[3:] == 7).all()  # padding repeats the FIRST row
    assert len(_pad_rows(list(range(300)))) == ROW_BUCKETS[1]
    assert len(_pad_rows(list(range(5000)))) == 8192


def test_place_self_rescues_when_dispatcher_never_runs(monkeypatch):
    """A dispatcher whose thread never ran leaves its request queued
    and ownerless; the bounded park notices and dispatches inline."""
    batcher = PlacementBatcher("cpu", window=0.01)
    state, asks, key = tiny_inputs(seed=5)
    real_dispatch = PlacementBatcher._dispatch
    died_once = []

    def flaky(self, shape_key, config, wait_window):
        if not died_once:
            died_once.append(shape_key)
            with self._lock:
                self._dispatchers.pop(shape_key, None)
            return None
        return real_dispatch(self, shape_key, config, wait_window)

    monkeypatch.setattr(PlacementBatcher, "_dispatch", flaky)
    result = {}
    t = threading.Thread(target=lambda: result.setdefault(
        "v", batcher.place(state, asks, key, CONFIG)), daemon=True)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive(), "place() wedged: self-rescue did not fire"
    assert_result(result["v"], direct(state, asks, key))


def test_spawn_dispatcher_start_failure_unclaims_slot(monkeypatch):
    batcher = PlacementBatcher("cpu", window=0.01)

    def boom(self):
        raise RuntimeError("can't start new thread")

    monkeypatch.setattr(threading.Thread, "start", boom)
    with batcher._lock:
        batcher._dispatchers["shape"] = 1
    batcher._spawn_dispatcher("shape", CONFIG)
    with batcher._lock:
        assert batcher._dispatchers.get("shape", 0) == 0


# ---------------------------------------- tests/test_batcher_overlay.py


class TokenState:
    """NodeState fields + base_token, as ClusterMatrix presents them."""

    def __init__(self, state, token):
        for f in state._fields:
            setattr(self, f, np.asarray(getattr(state, f)))
        self.base_token = token


def build_state(n=128, g=2, token=1, job_seed=0):
    state = jb.make_node_state(
        capacity=np.tile([4000, 8192, 100000, 150], (n, 1)),
        sched_capacity=np.tile([3900, 7936, 96000, 150], (n, 1)),
        util=np.tile([100.0, 256.0, 4096.0, 0.0], (n, 1)),
        bw_avail=np.full(n, 1000.0), bw_used=np.zeros(n),
        ports_free=np.full(n, 40000.0),
        # Per-job overlay varies with job_seed; the base stays shared.
        job_count=(np.arange(n) % (job_seed + 2) == 0).astype(np.int32),
        tg_count=np.zeros((n, g), np.int32), feasible=np.ones((n, g), bool),
        node_ok=np.ones(n, bool))
    return TokenState(state, token)


def build_asks(k=8, g=2):
    return tiny_inputs(k=k, g=g)[1]


def test_lone_dispatch_uses_overlay_path_and_matches_direct():
    """A single token-carrying request pads to B = 4 on the overlay
    path and keeps the base on the device."""
    b = PlacementBatcher("cpu", window=0.001)
    asks = build_asks()
    s1 = build_state(token=77, job_seed=0)
    k1 = jb.host_prng_key(1)
    assert_result(b.place(s1, asks, k1, CONFIG), direct(s1, asks, k1))
    assert b.base_uploads == 1
    assert b.overlay_dispatches == 1
    s2 = build_state(token=77, job_seed=3)
    k2 = jb.host_prng_key(2)
    assert_result(b.place(s2, asks, k2, CONFIG), direct(s2, asks, k2))
    assert b.base_uploads == 1
    assert b.overlay_dispatches == 2


def test_batch_then_lone_no_base_reupload():
    b = PlacementBatcher("cpu", window=0.25)
    asks = build_asks()
    results = {}

    def worker(i):
        s = build_state(token=5, job_seed=i)
        key = jb.host_prng_key(i)
        results[i] = (s, key, b.place(s, asks, key, CONFIG))

    assert not run_threads(worker, 4)
    assert b.base_uploads == 1
    s = build_state(token=5, job_seed=9)
    key = jb.host_prng_key(99)
    assert_result(b.place(s, asks, key, CONFIG), direct(s, asks, key))
    assert b.base_uploads == 1
    for si, ki, got in results.values():
        assert_result(got, direct(si, asks, ki))


def test_mixed_tokens_fall_back_to_full_state_path():
    b = PlacementBatcher("cpu", window=0.25)
    asks = build_asks()
    results = {}

    def worker(i):
        s = build_state(token=100 + i, job_seed=i)  # distinct bases
        key = jb.host_prng_key(i)
        results[i] = (s, key, b.place(s, asks, key, CONFIG))

    assert not run_threads(worker, 3)
    for si, ki, got in results.values():
        assert_result(got, direct(si, asks, ki))
    # Token-less requests of one cohort stack their full states.
    reqs = [(build_state(token=None, job_seed=i), asks, jb.host_prng_key(i),
             CONFIG, None) for i in range(3)]
    for (s, a, k, _c, _s), got in zip(reqs, b.place_cohort(reqs)):
        assert_result(got, direct(s, a, k))


def test_delta_derived_base_updates_on_device():
    b = PlacementBatcher("cpu", window=0.001)
    asks = build_asks()
    s1 = build_state(token="parent", job_seed=0)
    b.place(s1, asks, jb.host_prng_key(1), CONFIG)
    assert b.base_uploads == 1 and b.base_delta_updates == 0
    s2 = build_state(token="child", job_seed=0)
    s2.util = s1.util.copy()
    s2.util[3] += [500, 256, 150, 0]
    s2.util[17] += [1000, 512, 300, 0]
    s2.bw_used = s1.bw_used.copy()
    s2.bw_used[3] += 50.0
    s2.ports_free = s1.ports_free.copy()
    s2.ports_free[17] -= 2.0
    s2.base_delta = ("parent", (3, 17))
    key = jb.host_prng_key(2)
    assert_result(b.place(s2, asks, key, CONFIG), direct(s2, asks, key))
    assert b.base_uploads == 1, "delta path still did a full upload"
    assert b.base_delta_updates == 1
    # Parent gone from the device cache: the delta becomes a full upload.
    b2 = PlacementBatcher("cpu", window=0.001)
    s3 = build_state(token="orphan", job_seed=1)
    s3.base_delta = ("no-such-parent", (1, 2))
    key = jb.host_prng_key(3)
    assert_result(b2.place(s3, asks, key, CONFIG), direct(s3, asks, key))
    assert b2.base_uploads == 1 and b2.base_delta_updates == 0


def test_device_base_cache_is_true_lru(monkeypatch):
    monkeypatch.setattr(batcher_mod, "DEVICE_BASE_CACHE", 2)
    b = PlacementBatcher("cpu", window=0.001)
    asks = build_asks()

    def place_tok(tok, seed):
        s = build_state(token=tok, job_seed=seed)
        return b.place(s, asks, jb.host_prng_key(seed), CONFIG)

    place_tok("A", 0)
    place_tok("B", 1)
    assert b.base_uploads == 2
    place_tok("A", 2)  # hit: refreshes A's recency
    assert b.base_uploads == 2
    place_tok("C", 3)  # evicts B (least recent), NOT A
    assert b.base_uploads == 3
    place_tok("A", 4)
    assert b.base_uploads == 3
    place_tok("B", 5)
    assert b.base_uploads == 4


def _store_with_nodes(n_nodes, classless_every=0):
    from nomad_tpu_torch import mock as port_mock
    from nomad_tpu_torch.state import StateStore

    store = StateStore()
    idx = 0
    for i in range(n_nodes):
        node = port_mock.node()
        if classless_every and i % classless_every == 0:
            node.node_class = ""  # classless rows exercise the patch
        node.compute_class()
        idx += 1
        store.upsert_node(idx, node)
    job = port_mock.job()
    job.task_groups[0].tasks[0].resources.networks = []
    idx += 1
    store.upsert_job(idx, job)
    return store, job, idx


def _job_allocs(job, nodes):
    from nomad_tpu_torch import mock as port_mock

    out = []
    for nd in nodes:
        a = port_mock.alloc()
        a.job_id, a.job, a.node_id = job.id, job, nd.id
        a.task_group = job.task_groups[0].name
        for tr in a.task_resources.values():
            tr.networks = []
        out.append(a)
    return out


def test_compact_overlay_matches_dense_through_live_batcher():
    store, job, idx = _store_with_nodes(130, classless_every=9)
    nodes = store.nodes()
    store.upsert_allocs(idx + 1, _job_allocs(job, nodes[0:33:3]))
    snap = store.snapshot()
    matrix = ClusterMatrix(snap, job)
    assert matrix.compact_overlay is not None
    asks = tb.make_asks(*matrix.build_asks([0] * 8))
    b = PlacementBatcher("cpu", window=0.0)
    got = b.place(matrix, asks, tb.host_prng_key(7), CONFIG)
    assert b.stats()["compact_dispatches"] == 1
    assert b.stats()["overlay_dispatches"] == 1
    matrix2 = ClusterMatrix(snap, job)
    matrix2.compact_overlay = None
    b2 = PlacementBatcher("cpu", window=0.0)
    dense = b2.place(matrix2, asks, tb.host_prng_key(7), CONFIG)
    assert b2.stats()["compact_dispatches"] == 0
    np.testing.assert_array_equal(got[0], dense[0])
    np.testing.assert_array_equal(got[1], dense[1])
    st = b.stats()
    assert st["issue_us"] >= 0 and st["sync_us"] >= 0
    assert st["payload_bytes"] > 0 and st["upload_bytes"] > 0


def test_fused_delta_compact_dispatch_through_live_batcher():
    store, job, idx = _store_with_nodes(130)
    nodes = store.nodes()
    idx += 1
    store.upsert_allocs(idx, _job_allocs(job, nodes[:5]))
    m1 = ClusterMatrix(store.snapshot(), job)
    asks = tb.make_asks(*m1.build_asks([0] * 8))
    b = PlacementBatcher("cpu", window=0.0)
    b.place(m1, asks, tb.host_prng_key(3), CONFIG)
    assert b.base_uploads == 1
    idx += 1
    store.upsert_allocs(idx, _job_allocs(job, nodes[40:43]))
    snap2 = store.snapshot()
    m2 = ClusterMatrix(snap2, job)
    assert m2.base_delta is not None and m2.base_delta[0] == m1.base_token
    key = tb.host_prng_key(4)
    got = b.place(m2, asks, key, CONFIG)
    assert b.base_uploads == 1
    assert b.base_delta_updates == 1 and b.fused_delta_updates == 1
    assert b.stats()["compact_dispatches"] == 2
    assert m2.base_token in b._device_bases
    assert not b._base_pending  # claim slot released
    # Oracle: the same matrix through the stacked full-state path.
    m2d = ClusterMatrix(snap2, job)
    m2d.compact_overlay = m2d.base_token = m2d.base_delta = None
    dense = PlacementBatcher("cpu", window=0.0).place(m2d, asks, key, CONFIG)
    np.testing.assert_array_equal(got[0], dense[0])
    np.testing.assert_array_equal(got[1], dense[1])
    m3 = ClusterMatrix(snap2, job)
    assert m3.base_token == m2.base_token
    b.place(m3, asks, tb.host_prng_key(5), CONFIG)
    assert b.base_uploads == 1 and b.base_delta_updates == 1


# ------------------------------------------ cohorts against the reference


def _add_filler_allocs(h, hp, rows, seed):
    """The same filler allocs (node, cpu, memory) committed to both
    stores at one index: the next snapshot's base is a delta child."""
    from nomad_tpu_torch import mock as port_mock

    rng = np.random.default_rng(seed)
    nodes = h.state.nodes()
    idx = h.next_index()
    hp._next_index = h._next_index
    ref, port = [], []
    for r in rows:
        cpu, mem = int(rng.integers(50, 300)), int(rng.integers(64, 512))
        for pkg_mock, store, out in ((mock, h.state, ref),
                                     (port_mock, hp.state, port)):
            a = pkg_mock.alloc()
            a.node_id = nodes[r].id
            filler = store.job_by_id("filler")
            a.job_id, a.job = filler.id, filler
            a.desired_status = consts.ALLOC_DESIRED_RUN
            a.client_status = consts.ALLOC_CLIENT_RUNNING
            for tr in a.task_resources.values():
                tr.cpu, tr.memory_mb, tr.networks = cpu, mem, []
            a.resources = None
            out.append(a)
    h.state.upsert_allocs(idx, ref)
    hp.state.upsert_allocs(idx, port)


def _cohort(h, hp, job, b, path, seed):
    """B evals of ``job`` on each side's current snapshot, prepared for
    ``path``: compact (as built), dense (compact overlay stripped) or
    stacked (no base token)."""
    out = []
    for side, matrix_cls, state in (("ref", RefMatrix, h.state),
                                    ("port", ClusterMatrix, hp.state)):
        rows = []
        for i in range(b):
            m = matrix_cls(state.snapshot(), state.job_by_id(job.id))
            if path == "dense":
                m.compact_overlay = None
            if path == "stacked":
                m.compact_overlay = m.base_token = m.base_delta = None
            tgs = [gi for gi, tg in enumerate(job.task_groups)
                   for _ in range(tg.count)]
            rows.append((m, m.build_asks(tgs), jb.host_prng_key(seed + i)))
        out.append(rows)
    return out


@pytest.mark.parametrize("uniform", [False, True], ids=["greedy", "uniform"])
@pytest.mark.parametrize("path", ["compact", "fused", "dense", "stacked"])
@pytest.mark.parametrize("pre_resolve", [True, False],
                         ids=["pre_resolve", "independent"])
def test_place_cohort_matches_reference(pre_resolve, path, uniform):
    """One cohort through the port's place_cohort and the reference's,
    on every _run_batch branch the cohort can take."""
    h = build_reference_cluster(96, 61 + uniform, harness_seed=5)
    job = distinct_hosts_job(12) if uniform else two_group_job((7, 5))
    h.state.upsert_job(h.next_index(), job)
    hp = carry_over(h)
    kw = dict(anti_affinity_penalty=10.0, pre_resolve=pre_resolve,
              uniform_dh=uniform)
    cj, ct = jb.PlacementConfig(**kw), tb.PlacementConfig(**kw)
    ref, port = RefBatcher(), PlacementBatcher("cpu")
    if path == "fused":
        # Cache the parent base on both sides, then commit allocs: the
        # cohort's base is a delta child, derived inside its dispatch.
        r0, p0 = _cohort(h, hp, job, 1, "compact", 900)
        ref.place_cohort([(m, jb.make_asks(*a), k, cj, None)
                          for m, a, k in r0])
        port.place_cohort([(m, tb.make_asks(*a), k, ct, None)
                           for m, a, k in p0])
        _add_filler_allocs(h, hp, rows=range(0, 60, 3), seed=7)
    rr, pr = _cohort(h, hp, job, 6, "compact" if path == "fused" else path,
                     1000)
    want = ref.place_cohort([(m, jb.make_asks(*a), k, cj, None)
                             for m, a, k in rr])
    got = port.place_cohort([(m, tb.make_asks(*a), k, ct, None)
                             for m, a, k in pr])
    for w, g in zip(want, got):
        assert_result(g, w)
    st = port.stats()
    assert st["compact_dispatches"] == (path in ("compact", "fused")) + (
        path == "fused")
    assert st["fused_delta_updates"] == (path == "fused")
    assert st["pre_resolve_dispatches"] == (
        pre_resolve and path != "stacked") * (1 + (path == "fused"))
    if path == "stacked":
        assert st["overlay_dispatches"] == 0
    placed = sum(int((np.asarray(c) >= 0).sum()) for c, _s in got)
    assert placed > 0


def test_cached_child_base_is_pre_placement():
    """A fused delta under pre_resolve caches the child base as the
    delta left it, before any placement: neither the evals' claims nor
    the padding rows' leak into the next snapshot's base."""
    h = build_reference_cluster(96, 71, harness_seed=5)
    job = distinct_hosts_job(12)
    h.state.upsert_job(h.next_index(), job)
    hp = carry_over(h)
    ct = tb.PlacementConfig(anti_affinity_penalty=10.0, pre_resolve=True,
                            uniform_dh=True)
    port = PlacementBatcher("cpu")
    _r, p0 = _cohort(h, hp, job, 1, "compact", 1)
    port.place_cohort([(m, tb.make_asks(*a), k, ct, None)
                       for m, a, k in p0])
    _add_filler_allocs(h, hp, rows=range(0, 40, 2), seed=8)
    _r, p1 = _cohort(h, hp, job, 3, "compact", 2)
    got = port.place_cohort([(m, tb.make_asks(*a), k, ct, None)
                             for m, a, k in p1])
    assert port.stats()["fused_delta_updates"] == 1
    assert sum(int((c >= 0).sum()) for c, _s in got) > 0
    child = p1[0][0]
    dev = port._device_bases[child.base_token]
    np.testing.assert_array_equal(dev[2].numpy(), child.util)
    np.testing.assert_array_equal(dev[4].numpy(), child.bw_used)
    np.testing.assert_array_equal(dev[5].numpy(), child.ports_free)
    np.testing.assert_array_equal(dev[6].numpy(), child.node_ok)


def test_concurrent_builds_of_one_base_upload_once(monkeypatch):
    """The pending-build guard: dispatchers that need one base at once
    wait for a single upload instead of each paying it."""
    b = PlacementBatcher("cpu")
    s = build_state(token="one")
    base = batcher_mod._base_of(s)[1]
    started = threading.Event()
    release = threading.Event()
    real = PlacementBatcher._build_device_base

    def slow(self, token, base, delta):
        started.set()
        release.wait(10)
        return real(self, token, base, delta)

    monkeypatch.setattr(PlacementBatcher, "_build_device_base", slow)
    out = []
    threads = [threading.Thread(
        target=lambda: out.append(b._device_base("one", base)))
        for _ in range(4)]
    threads[0].start()
    assert started.wait(10)
    for t in threads[1:]:
        t.start()
    # A fused claim on a token being built is refused too.
    assert b._claim_fused_delta("one", ("parent", (1,))) is None
    release.set()
    for t in threads:
        t.join(10)
    assert b.base_uploads == 1
    assert len(out) == 4 and all(o[0] is out[0][0] for o in out)
    assert not b._base_pending


def test_cohort_announcement_holds_the_window():
    """add_cohort stretches the dispatch window until the announced
    requests arrive; cohort_cancel repays and floors at zero."""
    b = PlacementBatcher("cpu", window=0.01)
    b.add_cohort(3)
    results = {}

    def worker(i):
        if i:
            threading.Event().wait(0.1 * i)  # staggered arrivals
        results[i] = b.place(*tiny_inputs(seed=i), CONFIG)

    assert not run_threads(worker, 3)
    assert b.dispatches == 1 and b.batched_requests == 3
    b.cohort_cancel(5)
    with b._lock:
        assert b._cohort == 0
    for i in range(3):
        assert_result(results[i], direct(*tiny_inputs(seed=i)))


def test_stats_report_occupancy_and_timings():
    b = PlacementBatcher("cpu")
    reqs = [(*tiny_inputs(seed=i), CONFIG, None) for i in range(5)]
    b.place_cohort(reqs)
    st = b.stats()
    assert st["dispatches"] == 1 and st["occupancy"] == 5.0
    for key in ("stack_us", "issue_us", "sync_us", "payload_bytes",
                "cohort_dispatches", "pre_resolve_dispatches"):
        assert key in st
    assert st["payload_bytes"] > 0
    assert torch.device(st["device"]).type == "cpu"


# ------------------------------------------- the node-sharded mesh path


def cpu_mesh(w=8):
    from nomad_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(devices=["cpu"] * w)


def test_large_cluster_base_shards_across_mesh():
    """At SHARD_MIN_NODES the cached base shards over the mesh's node
    axis and the dispatch matches the unsharded oracle; a delta child of
    the sharded parent derives shard by shard (K10a), with no full
    re-upload, and is sharded too."""
    from nomad_tpu_torch.parallel.mesh import is_sharded

    n = batcher_mod.SHARD_MIN_NODES
    b = PlacementBatcher("cpu", window=0.001, mesh=cpu_mesh())
    asks = build_asks()
    s1 = build_state(n=n, token="bigA", job_seed=0)
    key = jb.host_prng_key(7)
    got = b.place(s1, asks, key, CONFIG)
    assert b.sharded_bases == 1
    dev = b._device_bases["bigA"]
    assert is_sharded(dev[0]) and len(dev[0].parts[0]) == 8
    assert_result(got, direct(s1, asks, key))

    s2 = build_state(n=n, token="bigB", job_seed=0)
    s2.util = s1.util.copy()
    s2.util[1234] += [500, 256, 150, 0]
    s2.base_delta = ("bigA", (1234,))
    key2 = jb.host_prng_key(8)
    got2 = b.place(s2, asks, key2, CONFIG)
    assert b.base_uploads == 1
    assert b.base_delta_updates == 1 and b.fused_delta_updates == 0
    assert b.sharded_bases == 2
    assert_result(got2, direct(s2, asks, key2))
    child = b._device_bases["bigB"]
    from nomad_tpu_torch.parallel.mesh import gather

    np.testing.assert_array_equal(gather(child[2]).numpy(), s2.util)
    occ = b.shard_occupancy()
    assert len(occ) == 8 and all(e["rows"] == n // 8 for e in occ)


def test_sharded_dispatch_runs_the_live_rows(monkeypatch):
    """Over a sharded base the batch is not padded up a ladder bucket:
    a lone eval scans as B = 1 (every row is work in each shard's
    launches), where the unsharded batcher pads it to 4."""
    from nomad_tpu_torch.parallel import shard

    seen = []
    orig = shard.sharded_greedy_scan

    def spy(shards, penalty, seq=False):
        seen.append(shards[0].feasible.shape[0])
        return orig(shards, penalty, seq)

    monkeypatch.setattr(shard, "sharded_greedy_scan", spy)
    b = PlacementBatcher("cpu", window=0.001, mesh=cpu_mesh())
    s = build_state(n=batcher_mod.SHARD_MIN_NODES, token="live", job_seed=0)
    asks, key = build_asks(), jb.host_prng_key(3)
    got = b.place(s, asks, key, CONFIG)
    assert b.sharded_bases == 1 and seen == [1]
    assert_result(got, direct(s, asks, key))


def test_small_cluster_base_stays_unsharded():
    b = PlacementBatcher("cpu", window=0.001, mesh=cpu_mesh())
    s = build_state(n=128, token="small", job_seed=0)
    b.place(s, build_asks(), jb.host_prng_key(1), CONFIG)
    assert b.sharded_bases == 0
    assert len(b.shard_occupancy()) == 1


@pytest.fixture(scope="module")
def big_cluster():
    """A 2,048-node cluster (SHARD_MIN_NODES) in the JAX package's
    store and the port's, carried over: shared by the mesh cases."""
    h = build_reference_cluster(2048, 29, allocs_per_node=1,
                                harness_seed=5)
    return h, carry_over(h)


def test_live_batcher_compact_dispatch_on_the_mesh(big_cluster):
    """``__graft_entry__._dryrun_live_batcher`` on the port: a 2,048-node
    StateStore snapshot -> ClusterMatrix (compact overlay) -> batcher,
    the cached base sharded over the node axis; the same eval through
    the JAX batcher (sharded over its 8 devices) places the same."""
    h, hp = big_cluster
    job = distinct_hosts_job(8, "live-dh")
    h.state.upsert_job(h.next_index(), job)
    hp.state.upsert_job(h._next_index - 1, carry_over_job(job))
    hp._next_index = h._next_index
    m = ClusterMatrix(hp.state.snapshot(), hp.state.job_by_id(job.id))
    assert m.compact_overlay is not None
    asks = tb.make_asks(*m.build_asks([0] * 8))
    b = PlacementBatcher("cpu", window=0.0, mesh=cpu_mesh())
    got = b.place(m, asks, tb.host_prng_key(1), CONFIG)
    st = b.stats()
    assert st["sharded_bases"] == 1 and st["compact_dispatches"] == 1
    assert (np.asarray(got[0])[:8] >= 0).all()
    rm = RefMatrix(h.state.snapshot(), h.state.job_by_id(job.id))
    ref = RefBatcher(window=0.0)
    want = ref.place(rm, jb.make_asks(*rm.build_asks([0] * 8)),
                     jb.host_prng_key(1), REF_CONFIG)
    assert ref.stats()["sharded_bases"] == 1
    assert_result(got, want)


def carry_over_job(job):
    from nomad_tpu.utils.codec import to_dict
    from nomad_tpu_torch.structs import Job as PortJob
    from nomad_tpu_torch.utils.codec import from_dict

    return from_dict(PortJob, to_dict(job))


@pytest.mark.parametrize("uniform", [True, False],
                         ids=["uniform", "greedy"])
def test_pre_resolve_cohort_on_the_mesh_matches_reference(big_cluster,
                                                         uniform):
    """A pre_resolve cohort through place_cohort on the mesh (K3 with a
    row offset, then K10d or K10c in order over the shared claimed
    capacity), then a second cohort on a delta child of the sharded
    base (K10a), against the JAX batcher on its sharded base."""
    h, hp = big_cluster
    job = distinct_hosts_job(12, f"coh-{uniform}") if uniform else \
        two_group_job((7, 5), f"coh-{uniform}")
    h.state.upsert_job(h.next_index(), job)
    hp.state.upsert_job(h._next_index - 1, carry_over_job(job))
    hp._next_index = h._next_index
    kw = dict(anti_affinity_penalty=10.0, pre_resolve=True,
              uniform_dh=uniform)
    cj, ct = jb.PlacementConfig(**kw), tb.PlacementConfig(**kw)
    ref, port = RefBatcher(), PlacementBatcher("cpu", mesh=cpu_mesh())
    for round_, seed in ((0, 3000), (1, 4000)):
        if round_:
            _add_filler_allocs(h, hp, rows=range(0, 2048, 97), seed=9)
        rr, pr = _cohort(h, hp, job, 6, "compact", seed + 10 * uniform)
        want = ref.place_cohort([(m, jb.make_asks(*a), k, cj, None)
                                 for m, a, k in rr])
        got = port.place_cohort([(m, tb.make_asks(*a), k, ct, None)
                                 for m, a, k in pr])
        for w_, g_ in zip(want, got):
            assert_result(g_, w_)
        assert sum(int((c >= 0).sum()) for c, _s in got) > 0
    st = port.stats()
    assert st["base_uploads"] == 1 and st["base_delta_updates"] == 1
    assert st["fused_delta_updates"] == 0 and st["sharded_bases"] == 2
    assert st["pre_resolve_dispatches"] == 2
    assert ref.stats()["sharded_bases"] == 2


def test_registered_kernel_over_a_sharded_base_raises(big_cluster,
                                                      monkeypatch):
    """The convex kernel over a sharded base (K0 and K3 a shard, the
    sharded relaxation K10g-a, the rounding over shards K10g-b): a lone
    eval, then a pre_resolve cohort of three, through place_cohort on a
    mesh batcher place as the JAX batcher's convex dispatch over its
    automatically sharded base (choices equal, scores within SCORE_TOL:
    the relaxation's cross-shard softmax sums in another order, orders
    below the noise's separation here). The batch is not padded: a
    registered kernel's batch never is."""
    from nomad_tpu_torch.kernels import convex as tconvex

    h, hp = big_cluster
    job = two_group_job((3, 1), "convex-mesh")  # both datacenters
    h.state.upsert_job(h.next_index(), job)
    hp.state.upsert_job(h._next_index - 1, carry_over_job(job))
    hp._next_index = h._next_index
    m = ClusterMatrix(hp.state.snapshot(), hp.state.job_by_id(job.id))
    assert m.capacity.shape[0] >= batcher_mod.SHARD_MIN_NODES
    asks = tb.make_asks(*m.build_asks([0, 0, 0, 1]))
    rm = RefMatrix(h.state.snapshot(), h.state.job_by_id(job.id))
    rasks = jb.make_asks(*rm.build_asks([0, 0, 0, 1]))
    b, ref = PlacementBatcher("cpu", mesh=cpu_mesh()), RefBatcher()
    cfg = CONFIG._replace(kernel="convex")
    rcfg = REF_CONFIG._replace(kernel="convex")
    batches = []
    program = tconvex.convex_shard_program

    def spy(shards, config, seq=False):
        batches.append(shards[0].feasible.shape[0])
        return program(shards, config, seq)

    monkeypatch.setattr(tconvex, "convex_shard_program", spy)
    got = b.place_cohort([(m, asks, tb.host_prng_key(2), cfg, None)])
    want = ref.place_cohort([(rm, rasks, jb.host_prng_key(2), rcfg, None)])
    assert_result(got[0], want[0])
    assert (np.asarray(got[0][0]) >= 0).sum() == 4
    rr, pr = _cohort(h, hp, job, 3, "compact", 77)
    cfg, rcfg = cfg._replace(pre_resolve=True), rcfg._replace(
        pre_resolve=True)
    got = b.place_cohort([(m_, tb.make_asks(*a), k, cfg, None)
                          for m_, a, k in pr])
    want = ref.place_cohort([(m_, jb.make_asks(*a), k, rcfg, None)
                             for m_, a, k in rr])
    for g_, w_ in zip(got, want):
        assert_result(g_, w_)
    assert batches == [1, 3]  # the live evals: no padding rows
    st = b.stats()
    assert st["sharded_bases"] == 1 and st["pre_resolve_dispatches"] == 1
    assert ref.stats()["sharded_bases"] >= 1


def test_batcher_takes_a_node_axis_mesh_only():
    from nomad_tpu_torch.parallel.mesh import make_mesh

    with pytest.raises(ValueError, match="dp = 1"):
        PlacementBatcher("cpu", mesh=make_mesh(devices=["cpu"] * 4, dp=2))
