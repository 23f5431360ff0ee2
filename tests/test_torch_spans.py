"""The runtime wired into the port's scheduler path, held against the
JAX package's on the same inputs.

The same evals go through the JAX package's dense factories
("service-tpu", "system-tpu") and the port's ("service-gpu",
"system-gpu", on the CPU): a one-group distinct-hosts job, a two-group
job after it and that job's scale-up, a preemption eval, a gang eval, a system eval and
a drain's migration eval. Each eval must record the same stages, in the
same order, under the same parents and with equal annotations in both
flight recorders; timings are not compared, ``device.solve``'s kernel
and batch are. That holds the two ClusterMatrixes' build kind, delta
rows and class-index stats against each other too.

Then the batcher: one ``device.solve`` span a traced request on the
lone, overlay, compact, fused and stacked paths, and through
``place_cohort`` in chunks, equal to the JAX batcher's; a parked
``place()`` stamps ``batch_park`` run-queue delay and counts in the
``batcher.place`` convoy tracker; the lock table names the batcher's,
the matrix's and the recorder's sites."""

from __future__ import annotations

import pytest

import torch_parity  # noqa: F401  (the port on the CPU, one torch thread)

from nomad_tpu import migrate as ref_migrate
from nomad_tpu import mock
from nomad_tpu import profile as ref_profile
from nomad_tpu import trace as ref_trace
from nomad_tpu.models.matrix import ClusterMatrix as RefMatrix
from nomad_tpu.ops import binpack as jb
from nomad_tpu.scheduler.batcher import PlacementBatcher as RefBatcher
from nomad_tpu.scheduler.testing import Harness, seed_harness_cluster
from nomad_tpu.structs import Constraint, Gang, consts
from nomad_tpu.structs.eval import new_eval
from nomad_tpu_torch import migrate as port_migrate
from nomad_tpu_torch import profile
from nomad_tpu_torch import trace
from nomad_tpu_torch.models.matrix import ClusterMatrix
from nomad_tpu_torch.ops import binpack as tb
from nomad_tpu_torch.scheduler.batcher import PlacementBatcher
from torch_parity import (
    build_reference_cluster,
    carry_over,
    distinct_hosts_job,
    port_eval,
    two_group_job,
)

DENSE_STAGES = ("matrix.build", "matrix.update", "matrix.compress",
                "device.dispatch", "device.solve")


@pytest.fixture(autouse=True)
def fresh_runtime():
    """Recorder, profiler, migration governor and preemption policy are
    process-global in both packages: every test starts them clean and
    leaves them at their defaults."""
    recs = (trace.get_recorder(), ref_trace.get_recorder())
    profs = (profile.get_profiler(), ref_profile.get_profiler())
    for r in recs:
        r.reset()
        r.set_enabled(True)
    for p in profs:
        p.reset()
        p.set_enabled(True)
    yield
    for r in recs:
        r.reset()
    for p in profs:
        p.reset()
    for mod in (ref_migrate, port_migrate):
        g = mod.get_governor()
        leaked = g.stats()["in_flight"]
        if leaked:
            g.release(leaked)
        mod.configure(migrate_max_parallel=32, preemption_enabled=False,
                      preempt_priority_threshold=50)
        mod._policy.configure(pressure_probe=lambda: "green")
        g.reset_stats()


def trace_view(rec, eval_id):
    """[(stage, annotations, parent)] of one eval's completed trace, in
    the recorder's start order."""
    rec.complete(eval_id)
    tr = rec.trace_for(eval_id)
    assert tr is not None, eval_id
    return [(s["name"], s.get("annotations"), s["parent"])
            for s in tr["spans"]]


def run_pair(h, ev, ref_factory="service-tpu", port_factory="service-gpu",
             hp=None):
    """``ev`` through the JAX factory on ``h`` and the port's on a
    carried-over copy (or on ``hp``); returns (hp, port view, JAX
    view) of the eval's trace."""
    hp = carry_over(h) if hp is None else hp
    h.process(ref_factory, ev)
    hp.process(port_factory, port_eval(ev))
    got = trace_view(trace.get_recorder(), ev.id)
    want = trace_view(ref_trace.get_recorder(), ev.id)
    return hp, got, want


def assert_same_trace(got, want, stages=DENSE_STAGES):
    assert got == want
    names = [name for name, _a, _p in got]
    for stage in stages:
        assert stage in names, (stage, names)


def solve_inside_dispatch(eval_id):
    """The port's device.solve lies inside its device.dispatch."""
    tr = trace.get_recorder().trace_for(eval_id)
    spans = {s["name"]: s for s in tr["spans"]}
    solve, disp = spans["device.solve"], spans["device.dispatch"]
    assert disp["start_ms"] <= solve["start_ms"]
    assert solve["end_ms"] <= disp["end_ms"]
    assert solve["parent"] == "device.dispatch"


def annotation(view, stage):
    (ann,) = [a for name, a, _p in view if name == stage]
    return ann


# ---------------------------------------------------------------------
# the slice: the same evals through both packages


@pytest.mark.parametrize("seed", [3, 11])
def test_distinct_hosts_eval_same_spans(seed):
    h = build_reference_cluster(256, seed, harness_seed=seed)
    job = distinct_hosts_job(40)
    h.state.upsert_job(h.next_index(), job)
    ev = new_eval(h.state.job_by_id(job.id),
                  consts.EVAL_TRIGGER_JOB_REGISTER)
    _hp, got, want = run_pair(h, ev)
    assert_same_trace(got, want)
    solve_inside_dispatch(ev.id)
    assert annotation(got, "matrix.build") == {"placements": 40}
    assert annotation(got, "device.solve") == {"kernel": "greedy",
                                               "batch": 1}
    assert annotation(got, "matrix.update")["kind"] in ("full", "hit",
                                                        "delta")


def test_eval_sequence_and_scale_up_same_spans():
    """Three evals on one store, as chip_smoke.py's phase 3 runs them: a
    distinct-hosts job on a fresh cluster (matrix.update "full"), a
    two-group job after it committed (its base a "delta" of the first
    eval's, with the touched rows), then that job scaled up. The
    scale-up's plan already holds in-place updates of the committed
    allocs when its matrix is built, so its base is not cacheable and
    reads "full" again: the JAX package's rule (ClusterMatrix
    ``cacheable``), held here in both packages."""
    from test_torch_scheduler import port_job

    h = build_reference_cluster(256, 23, harness_seed=23)
    hp = carry_over(h)
    two = two_group_job((12, 10), job_id="grow")
    grown = two.copy()
    grown.task_groups[0].count = 40
    grown.task_groups[1].count = 30
    kinds = []
    for job in (distinct_hosts_job(8), two, grown):
        h.state.upsert_job(h.next_index(), job)
        hp.state.upsert_job(hp.next_index(), port_job(job))
        ev = new_eval(h.state.job_by_id(job.id),
                      consts.EVAL_TRIGGER_JOB_REGISTER)
        _hp, got, want = run_pair(h, ev, hp=hp)
        assert_same_trace(got, want)
        solve_inside_dispatch(ev.id)
        kinds.append(annotation(got, "matrix.update"))
    assert [k["kind"] for k in kinds] == ["full", "delta", "full"]
    assert kinds[1]["rows"] > 0
    assert annotation(got, "matrix.build") == {"placements": 48}


def _preempt_harness(seed, n_nodes=4):
    """The JAX package's priority-storm fixture: one low-priority alloc
    filling each node (its eval through both packages, so both stores
    and base caches share the history), then a high-priority job of
    count n_nodes. Returns (h, hp, high)."""
    h = Harness(seed=seed)
    for _ in range(n_nodes):
        n = mock.node()
        n.resources.cpu = 1000
        n.resources.memory_mb = 4096
        n.compute_class()
        h.state.upsert_node(h.next_index(), n)
    low = mock.job()
    low.id, low.priority = "low-prio", 20
    low.task_groups[0].count = n_nodes
    t = low.task_groups[0].tasks[0]
    t.resources.cpu, t.resources.memory_mb, t.resources.networks = \
        600, 256, []
    high = mock.job()
    high.id, high.priority = "high-prio", 60
    high.task_groups[0].count = n_nodes
    t = high.task_groups[0].tasks[0]
    t.resources.cpu, t.resources.memory_mb, t.resources.networks = \
        500, 128, []
    h.state.upsert_job(h.next_index(), low)
    h.state.upsert_job(h.next_index(), high)
    hp = carry_over(h)
    run_pair(h, new_eval(h.state.job_by_id(low.id),
                         consts.EVAL_TRIGGER_JOB_REGISTER), hp=hp)
    return h, hp, high


def test_preemption_eval_same_spans():
    for mod in (ref_migrate, port_migrate):
        mod.configure(preemption_enabled=True,
                      preempt_priority_threshold=50,
                      pressure_probe=lambda: "red")
    h, hp, high = _preempt_harness(31)
    ev = new_eval(h.state.job_by_id(high.id),
                  consts.EVAL_TRIGGER_JOB_REGISTER)
    hp, got, want = run_pair(h, ev, hp=hp)
    assert_same_trace(got, want, DENSE_STAGES + ("preempt.select",))
    assert annotation(got, "preempt.select") == {"asks": 4, "candidates": 4}
    evicted = [a for a in hp.state.allocs_by_job("low-prio")
               if a.desired_status == consts.ALLOC_DESIRED_EVICT]
    assert len(evicted) == 4


def _topo_nodes(n=12, rack_size=4):
    nodes = []
    for i in range(n):
        node = mock.node()
        node.resources.cpu = node.resources.memory_mb = 3000
        node.meta["rack"] = f"r{i // rack_size}"
        node.meta["ici"] = f"r{i // rack_size}-i{(i % rack_size) // 2}"
        node.compute_class()
        nodes.append(node)
    return nodes


@pytest.mark.parametrize("gang", [dict(slice="rack"), dict(spread="rack"),
                                  dict()], ids=["slice", "spread", "free"])
def test_gang_eval_same_spans(gang):
    job = mock.job()
    job.id = "gang-job"
    tg = job.task_groups[0]
    tg.count = 4
    tg.gang = Gang(**gang)
    t = tg.tasks[0]
    t.resources.cpu, t.resources.memory_mb, t.resources.networks = \
        400, 256, []
    h = Harness(seed=7)
    seed_harness_cluster(h, nodes=_topo_nodes(), jobs=[job.copy()])
    ev = new_eval(h.state.job_by_id(job.id),
                  consts.EVAL_TRIGGER_JOB_REGISTER)
    _hp, got, want = run_pair(h, ev)
    assert_same_trace(got, want, ("gang.select",))
    ann = annotation(got, "gang.select")
    assert ann["members"] == 4 and ann["mode"] == want[0][1]["mode"]


def test_system_eval_same_spans():
    h = Harness(seed=5)
    for i in range(12):
        n = mock.node()
        n.meta["rack"] = f"r{i % 3}"
        n.compute_class()
        h.state.upsert_node(h.next_index(), n)
    job = mock.system_job()
    job.constraints.append(Constraint(ltarget="${meta.rack}",
                                      rtarget="r1", operand="="))
    h.state.upsert_job(h.next_index(), job)
    ev = new_eval(h.state.job_by_id(job.id),
                  consts.EVAL_TRIGGER_JOB_REGISTER)
    _hp, got, want = run_pair(h, ev, "system-tpu", "system-gpu")
    assert got == want == [
        ("matrix.build", {"placements": 4, "pinned": True}, None)]


def test_migration_eval_same_spans():
    """Four drained nodes' allocs migrate under a budget of 2: the
    node-update eval records migrate.place with the claimed and the
    deferred counts, then places the claimed ones densely."""
    for mod in (ref_migrate, port_migrate):
        mod.configure(migrate_max_parallel=2)
    h = Harness(seed=9)
    for _ in range(16):
        n = mock.node()
        n.compute_class()
        h.state.upsert_node(h.next_index(), n)
    job = mock.job()
    job.id = "mig"
    job.task_groups[0].count = 12
    t = job.task_groups[0].tasks[0]
    t.resources.cpu, t.resources.memory_mb, t.resources.networks = \
        20, 16, []
    h.state.upsert_job(h.next_index(), job)
    hp = carry_over(h)
    run_pair(h, new_eval(h.state.job_by_id(job.id),
                         consts.EVAL_TRIGGER_JOB_REGISTER), hp=hp)
    holders = sorted({a.node_id for a in h.state.allocs_by_job(job.id)})
    drained = holders[:4]
    displaced = sum(a.node_id in drained
                    for a in h.state.allocs_by_job(job.id))
    assert displaced > 2  # more displaced than the budget
    for node_id in drained:
        h.state.update_node_drain(h.next_index(), node_id, True)
        hp.state.update_node_drain(hp.next_index(), node_id, True)
    ev = new_eval(h.state.job_by_id(job.id), consts.EVAL_TRIGGER_NODE_UPDATE)
    _hp, got, want = run_pair(h, ev, hp=hp)
    assert got == want
    assert annotation(got, "migrate.place") == {
        "migrations": 2, "deferred": displaced - 2}


# ---------------------------------------------------------------------
# the batcher's device.solve spans, path by path


def _cohort_rows(path, b=3, seed=1):
    """B evals of one job on each side's snapshot, shaped for ``path``
    (as tests/test_torch_batcher.py's _cohort does)."""
    h = build_reference_cluster(96, 61, harness_seed=5)
    job = two_group_job((7, 5))
    h.state.upsert_job(h.next_index(), job)
    hp = carry_over(h)
    return h, hp, job, _rows(h, hp, job, path, b, seed)


def _rows(h, hp, job, path, b, seed):
    out = []
    for matrix_cls, state in ((RefMatrix, h.state), (ClusterMatrix,
                                                      hp.state)):
        rows = []
        for i in range(b):
            m = matrix_cls(state.snapshot(), state.job_by_id(job.id))
            if path in ("overlay", "lone"):
                m.compact_overlay = None
            if path in ("stacked", "lone"):
                m.compact_overlay = m.base_token = m.base_delta = None
            tgs = [gi for gi, tg in enumerate(job.task_groups)
                   for _ in range(tg.count)]
            rows.append((m, m.build_asks(tgs), jb.host_prng_key(seed + i)))
        out.append(rows)
    return out


def _spans(rows, tag):
    return [(f"{tag}-e{i}", f"{tag}-t{i}") for i in range(len(rows))]


def _solve_views(eval_ids):
    """{eval: [device.solve annotations]} in both recorders."""
    out = []
    for rec in (trace.get_recorder(), ref_trace.get_recorder()):
        views = {}
        for e in eval_ids:
            rec.complete(e)
            tr = rec.trace_for(e)
            views[e] = [s["annotations"] for s in tr["spans"]
                        if s["name"] == "device.solve"]
            assert tr["trace_id"] == e.replace("-e", "-t")
        out.append(views)
    return out


@pytest.mark.parametrize("path,b", [("lone", 1), ("overlay", 3),
                                    ("compact", 3), ("fused", 3),
                                    ("stacked", 3)])
def test_device_solve_span_on_every_batch_path(path, b):
    cfg = dict(anti_affinity_penalty=10.0, pre_resolve=True)
    cj, ct = jb.PlacementConfig(**cfg), tb.PlacementConfig(**cfg)
    ref, port = RefBatcher(), PlacementBatcher("cpu")
    h, hp, job, (rr, pr) = _cohort_rows(
        "compact" if path == "fused" else path, b)
    if path == "fused":
        # Cache the parent on both sides (untraced), commit allocs: the
        # cohort's base is a delta child derived inside its dispatch.
        from test_torch_batcher import _add_filler_allocs

        ref.place_cohort([(m, jb.make_asks(*a), k, cj, None)
                          for m, a, k in rr[:1]])
        port.place_cohort([(m, tb.make_asks(*a), k, ct, None)
                           for m, a, k in pr[:1]])
        _add_filler_allocs(h, hp, rows=range(0, 60, 3), seed=7)
        rr, pr = _rows(h, hp, job, "compact", b, 50)
    spans = _spans(pr, path)
    ref.place_cohort([(m, jb.make_asks(*a), k, cj, s)
                      for (m, a, k), s in zip(rr, spans)])
    port.place_cohort([(m, tb.make_asks(*a), k, ct, s)
                       for (m, a, k), s in zip(pr, spans)])
    got, want = _solve_views([e for e, _t in spans])
    assert got == want
    assert all(v == [{"kernel": "greedy", "batch": b}]
               for v in got.values())
    st = port.stats()
    assert st["lone_dispatches"] == (path == "lone")
    assert st["fused_delta_updates"] == (path == "fused")
    assert st["compact_dispatches"] == (path in ("compact", "fused")) * (
        1 + (path == "fused"))


def test_untraced_requests_record_nothing():
    _h, _hp, _job, (_rr, pr) = _cohort_rows("compact", 2)
    ct = tb.PlacementConfig(anti_affinity_penalty=10.0)
    PlacementBatcher("cpu").place_cohort(
        [(m, tb.make_asks(*a), k, ct, None) for m, a, k in pr])
    assert trace.get_recorder().stats()["active"] == 0
    assert "device.solve" not in trace.get_recorder().stage_stats()


def test_place_cohort_chunks_carry_their_live_batch():
    """Six traced requests through a max_batch = 4 batcher: two
    dispatches, each eval with exactly one device.solve span whose
    batch is its chunk's live count (4, then 2), as in the JAX
    batcher."""
    cfg = dict(anti_affinity_penalty=10.0, pre_resolve=True)
    cj, ct = jb.PlacementConfig(**cfg), tb.PlacementConfig(**cfg)
    _h, _hp, _job, (rr, pr) = _cohort_rows("compact", 6)
    spans = _spans(pr, "chunk")
    RefBatcher(max_batch=4).place_cohort(
        [(m, jb.make_asks(*a), k, cj, s) for (m, a, k), s in zip(rr, spans)])
    port = PlacementBatcher("cpu", max_batch=4)
    port.place_cohort(
        [(m, tb.make_asks(*a), k, ct, s) for (m, a, k), s in zip(pr, spans)])
    got, want = _solve_views([e for e, _t in spans])
    assert got == want
    assert [v[0]["batch"] for v in got.values()] == [4, 4, 4, 4, 2, 2]
    assert port.stats()["cohort_dispatches"] == 2


# ---------------------------------------------------------------------
# the batcher under the profiler


def test_parked_place_stamps_runq_and_convoy():
    """Concurrent place() calls on one shape: the first in dispatches,
    the rest park at the batch boundary. Every parked request is woken
    with its ready stamp (batch_park run-queue delay), its park counts
    in the batcher.place convoy tracker, and the batcher's profiled
    lock and condition record their acquires and waits. Each traced
    request gets its one device.solve span."""
    from test_torch_batcher import run_threads, tiny_inputs

    prof = profile.get_profiler()
    batcher = PlacementBatcher("cpu", window=0.25)
    config = tb.PlacementConfig(anti_affinity_penalty=10.0)
    results = {}

    def worker(i):
        state, asks, key = tiny_inputs(seed=i)
        results[i] = batcher.place(state, asks, key, config,
                                   span=(f"park-e{i}", f"park-t{i}"))

    assert not run_threads(worker, 6)
    assert len(results) == 6
    runq = prof.runq_table()
    assert runq["batch_park"]["count"] >= 1
    convoy = prof.convoy_table()["sites"]["batcher.place"]
    assert convoy["max_width"] >= 1 and convoy["width"] == 0
    locks = prof.lock_table()
    assert locks["scheduler.batcher"]["acquires"] > 0
    assert locks["scheduler.batcher"]["cond_waits"] > 0
    rec = trace.get_recorder()
    batches = []
    for i in range(6):
        rec.complete(f"park-e{i}")
        solves = [s for s in rec.trace_for(f"park-e{i}")["spans"]
                  if s["name"] == "device.solve"]
        assert len(solves) == 1
        batches.append(solves[0]["annotations"]["batch"])
    assert sum(batches) >= 6 and batcher.stats()["batched_requests"] == 6


def test_parked_place_behaves_the_same_with_the_profiler_off():
    """The park loop's bounded slices, ownership re-check and results
    do not depend on the profiler: off, nothing is recorded and every
    request is served."""
    from test_torch_batcher import assert_result, direct, run_threads, \
        tiny_inputs

    prof = profile.get_profiler()
    prof.set_enabled(False)
    batcher = PlacementBatcher("cpu", window=0.1)
    config = tb.PlacementConfig(anti_affinity_penalty=10.0)
    results = {}

    def worker(i):
        results[i] = batcher.place(*tiny_inputs(seed=i), config)

    try:
        assert not run_threads(worker, 5)
    finally:
        prof.set_enabled(True)
    for i in range(5):
        assert_result(results[i], direct(*tiny_inputs(seed=i)))
    assert "batch_park" not in prof.runq_table()
    assert prof.lock_table()["scheduler.batcher"]["acquires"] == 0


def test_lock_table_names_the_slice_sites():
    """A service-gpu eval exercises the batcher's lock, the matrix's
    position index and the recorder's stripes: all three sites are in
    the profiler's lock table under the JAX package's names."""
    h = build_reference_cluster(64, 4, harness_seed=4)
    job = two_group_job((6, 4))
    h.state.upsert_job(h.next_index(), job)
    hp = carry_over(h)
    hp.process("service-gpu", port_eval(new_eval(
        h.state.job_by_id(job.id), consts.EVAL_TRIGGER_JOB_REGISTER)))
    table = profile.get_profiler().lock_table()
    for site in ("scheduler.batcher", "models.matrix.positions",
                 "trace.recorder.stripe", "trace.recorder.hist"):
        assert site in table, (site, sorted(table))
    assert table["scheduler.batcher"]["acquires"] > 0
    assert table["trace.recorder.stripe"]["acquires"] > 0
