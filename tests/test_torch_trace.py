"""The port's flight recorder (nomad_tpu_torch/trace) against the JAX
package's: the reference's own unit tests (tests/test_trace.py: span
trees, ring-buffer bounds under concurrent writers, span cap, active
eviction, tail-keep, create=False) run on the port's module, then the
same span sequences go into both recorders and must read back equal
(stage table, span trees, tail-keep choices), and the quality board's
queueing field reads both recorders alike.

The reference tests that start a Server, the HTTP API or the broker
wait for those modules (ROADMAP, Queue A)."""

import threading
import time

import numpy as np
import pytest

from nomad_tpu import trace as ref_trace
from nomad_tpu.kernels import quality as ref_quality
from nomad_tpu_torch import trace
from nomad_tpu_torch.kernels import quality
from nomad_tpu_torch.trace import get_recorder
from nomad_tpu_torch.trace.recorder import (
    ACTIVE_PER_STRIPE,
    FlightRecorder,
    N_STRIPES,
    RING_PER_STRIPE,
    SPAN_CAP,
    TAIL_KEEP,
    TAIL_MIN_SAMPLES,
)


@pytest.fixture(autouse=True)
def fresh_recorder():
    """The recorder is process-global in both packages; every test
    starts both empty and enabled."""
    recs = (get_recorder(), ref_trace.get_recorder())
    for rec in recs:
        rec.reset()
        rec.set_enabled(True)
    yield recs[0]
    for rec in recs:
        rec.reset()


# ---------------------------------------------------------------------
# unit: span trees


def test_span_tree_parents_and_ordering():
    rec = FlightRecorder()
    t0 = time.monotonic()
    rec.record_span("e1", "scheduler.process", t0, t0 + 0.100)
    rec.record_span("e1", "plan.submit", t0 + 0.040, t0 + 0.090)
    rec.record_span("e1", "plan.evaluate", t0 + 0.050, t0 + 0.060)
    rec.record_span("e1", "matrix.build", t0 + 0.010, t0 + 0.020)
    rec.complete("e1")
    tr = rec.trace_for("e1")
    assert tr is not None
    names = [s["name"] for s in tr["spans"]]
    assert names == ["scheduler.process", "matrix.build", "plan.submit",
                     "plan.evaluate"]  # sorted by start
    by_name = {s["name"]: s for s in tr["spans"]}
    assert by_name["scheduler.process"]["parent"] is None
    assert by_name["matrix.build"]["parent"] == "scheduler.process"
    assert by_name["plan.submit"]["parent"] == "scheduler.process"
    assert by_name["plan.evaluate"]["parent"] == "plan.submit"
    for s in tr["spans"]:
        assert s["end_ms"] >= s["start_ms"] >= 0.0
    assert tr["duration_ms"] >= 100.0


def test_trace_id_carried_and_eval_id_fallback():
    rec = FlightRecorder()
    rec.record_span("e1", "x", time.monotonic(), trace_id="tr-42")
    rec.complete("e1")
    assert rec.trace_for("e1")["trace_id"] == "tr-42"
    rec.record_span("e2", "x", time.monotonic())
    rec.complete("e2")
    assert rec.trace_for("e2")["trace_id"] == "e2"


def test_disabled_recorder_records_nothing():
    rec = FlightRecorder()
    rec.set_enabled(False)
    rec.record_span("e1", "x", time.monotonic())
    rec.complete("e1")
    assert rec.traces() == []
    assert rec.stats()["completed"] == 0


# ---------------------------------------------------------------------
# ring buffer: concurrency + bounds


def test_concurrent_writers_no_torn_spans_bounded_memory():
    """Hammer one recorder from many threads: every completed trace
    must read back internally consistent (no torn spans), and every
    storage structure must stay at its cap."""
    rec = FlightRecorder()
    threads = 8
    evals_per_thread = 300
    spans_per_eval = 6
    errors = []

    def writer(tid):
        try:
            for i in range(evals_per_thread):
                eid = f"t{tid}-e{i}"
                t0 = time.monotonic()
                for k in range(spans_per_eval):
                    rec.record_span(eid, f"stage.{k}", t0, t0 + 0.001 * k)
                rec.annotate_fault(eid, "broker.deliver", i, "drop")
                rec.complete(eid)
        except Exception as e:  # noqa: BLE001 - surface in the assert
            errors.append(e)

    ts = [threading.Thread(target=writer, args=(t,)) for t in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60.0)
    assert not errors
    stats = rec.stats()
    assert stats["completed"] == threads * evals_per_thread
    assert stats["active"] == 0
    # fixed memory: rings never exceed their preallocated sizes
    for stripe in rec._stripes:
        assert len(stripe.ring) == RING_PER_STRIPE
        assert len(stripe.active) <= ACTIVE_PER_STRIPE
    assert len(rec._tail) == TAIL_KEEP
    # every readable trace is whole: all spans present, none torn
    traces = rec.traces(limit=10_000)
    assert traces
    for tr in traces:
        assert len(tr["spans"]) == spans_per_eval
        for s in tr["spans"]:
            assert s["end_ms"] >= s["start_ms"]
            assert s["name"].startswith("stage.")


def test_span_cap_drops_excess_not_memory():
    rec = FlightRecorder()
    t0 = time.monotonic()
    for i in range(SPAN_CAP + 50):
        rec.record_span("e1", f"s{i}", t0, t0 + 0.001)
    rec.complete("e1")
    tr = rec.trace_for("e1")
    assert len(tr["spans"]) == SPAN_CAP
    assert tr["dropped_spans"] == 50
    assert rec.stats()["dropped_spans"] == 50


def test_active_eviction_is_drop_oldest_not_growth():
    rec = FlightRecorder()
    # All keys on one stripe would need hash control; instead flood all
    # stripes far past the global active cap.
    n = N_STRIPES * ACTIVE_PER_STRIPE * 2
    t0 = time.monotonic()
    for i in range(n):
        rec.record_span(f"e{i}", "x", t0)  # never completed
    total_active = rec.stats()["active"]
    assert total_active <= N_STRIPES * ACTIVE_PER_STRIPE
    assert rec.stats()["evicted_active"] >= n - total_active


def test_tail_keep_catches_past_p99_traces():
    rec = FlightRecorder()
    t0 = time.monotonic()
    # fast herd to establish the rolling e2e distribution
    for i in range(TAIL_MIN_SAMPLES + 20):
        eid = f"fast{i}"
        rec.record_span(eid, "x", t0 - 0.001, t0)
        rec.complete(eid)
    # now a slow outlier: must be tail-kept
    rec.record_span("slow", "x", t0 - 5.0, t0)
    rec.complete("slow")
    tail_ids = [t["eval_id"] for t in rec.tail_traces()]
    assert "slow" in tail_ids
    assert rec.trace_for("slow")["tail_kept"] is True


def test_record_span_create_false_requires_active_trace():
    """FSM applies on followers/replay must not mint traces: with
    create=False a span lands only on an already-open trace."""
    rec = FlightRecorder()
    rec.record_span("ghost", "fsm.alloc_upsert", time.monotonic(),
                    create=False)
    assert rec.stats()["active"] == 0
    rec.record_span("live", "broker.wait", time.monotonic())
    rec.record_span("live", "fsm.alloc_upsert", time.monotonic(),
                    create=False)
    rec.complete("live")
    assert [s["name"] for s in rec.trace_for("live")["spans"]] == [
        "broker.wait", "fsm.alloc_upsert"]




def test_churn_stages_registered_and_documented():
    """migrate.place + preempt.select are first-class lifecycle stages:
    present in ALL_STAGES and in the port's trace package docstring,
    which lists the stages its scheduler path records."""
    from nomad_tpu_torch.trace import (
        ALL_STAGES,
        STAGE_MIGRATE_PLACE,
        STAGE_PREEMPT_SELECT,
    )

    assert STAGE_MIGRATE_PLACE in ALL_STAGES
    assert STAGE_PREEMPT_SELECT in ALL_STAGES
    for stage in (STAGE_MIGRATE_PLACE, STAGE_PREEMPT_SELECT):
        assert stage in trace.__doc__, stage


def test_stage_vocabulary_matches_the_reference():
    assert trace.ALL_STAGES == ref_trace.ALL_STAGES
    assert trace.LIFECYCLE_CORE_STAGES == ref_trace.LIFECYCLE_CORE_STAGES
    from nomad_tpu.trace import recorder as ref_recorder
    from nomad_tpu_torch.trace import recorder

    for name in ("N_STRIPES", "RING_PER_STRIPE", "TAIL_KEEP", "SPAN_CAP",
                 "FAULT_CAP", "ACTIVE_PER_STRIPE", "TAIL_MIN_SAMPLES",
                 "MAX_STAGES", "NTA_RECORD_PATH"):
        assert getattr(recorder, name) == getattr(ref_recorder, name), name


# ---------------------------------------------------------------------
# parity: the same span sequence into both recorders


def _span_sequence(seed, n_evals, base):
    """[(eval_id, trace_id, stage, t0, t1, ann)] on fixed monotonic
    stamps around ``base``. Every trace's outermost span starts in the
    past and ends 60 s ahead, so a trace's origin and end (hence its
    e2e duration) are set by the spans, not by when complete() runs."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_evals):
        eid = f"e{i}"
        start = base - float(rng.uniform(0.01, 2.0))
        if i >= TAIL_MIN_SAMPLES and i % 17 == 5:
            start -= 40.0  # a slow outlier past the rolling p99
        out.append((eid, f"tr{i}", "scheduler.process", start, base + 60.0,
                    None))
        t = start
        for stage in ("matrix.build", "matrix.update", "device.dispatch",
                      "device.solve"):
            dur = float(rng.uniform(1e-4, 0.3))
            ann = ({"kernel": "greedy", "batch": int(rng.integers(1, 65))}
                   if stage == "device.solve" else
                   {"kind": "delta", "rows": int(rng.integers(0, 9))}
                   if stage == "matrix.update" else None)
            out.append((eid, f"tr{i}", stage, t, t + dur, ann))
            t += dur / 2
    return out


def _feed(rec, seq, n_evals):
    for eid, tid, stage, t0, t1, ann in seq:
        rec.record_span(eid, stage, t0, t1, ann=ann, trace_id=tid)
    for i in range(n_evals):
        rec.complete(f"e{i}")


def _tree(tr):
    """A completed trace without its wall-clock start."""
    return {k: v for k, v in tr.items() if k != "start_unix"}


@pytest.mark.parametrize("seed,n_evals", [(0, 12), (1, TAIL_MIN_SAMPLES + 40)])
def test_same_spans_read_back_equal_in_both_recorders(seed, n_evals):
    port, ref = FlightRecorder(), ref_trace.FlightRecorder()
    seq = _span_sequence(seed, n_evals, time.monotonic())
    _feed(port, seq, n_evals)
    _feed(ref, seq, n_evals)
    assert port.stage_stats() == ref.stage_stats()
    assert port.stats() == ref.stats()
    for i in range(n_evals):
        got, want = port.trace_for(f"e{i}"), ref.trace_for(f"e{i}")
        if want is None:  # wrapped out of its stripe's ring in both
            assert got is None
            continue
        assert _tree(got) == _tree(want)
    tail = [t["eval_id"] for t in port.tail_traces()]
    assert tail == [t["eval_id"] for t in ref.tail_traces()]
    if n_evals > TAIL_MIN_SAMPLES:
        assert tail  # the outliers past the rolling p99 were kept
    assert port.stage_buckets("device.solve") == ref.stage_buckets(
        "device.solve")


def test_span_dicts_equal():
    span = ("device.solve", 10.0, 10.25, {"kernel": "convex", "batch": 3})
    faults = [(10.1, "binpack.device", 2, "error")]
    assert trace.span.span_to_dict(span, 9.5, faults) == \
        ref_trace.span.span_to_dict(span, 9.5, faults)
    assert trace.span.make_span("x", 2.0, 1.0) == \
        ref_trace.span.make_span("x", 2.0, 1.0)


def test_observe_stage_feeds_the_table_not_e2e():
    for rec in (FlightRecorder(), ref_trace.FlightRecorder()):
        rec.observe_stage("read.park", 3.0)
        assert rec.stage_stats()["read.park"]["count"] == 1
        assert "e2e" not in rec.stage_stats()
        assert rec.e2e_p99() == 0.0


def test_quality_board_queueing_reads_both_recorders_alike():
    """queueing_delay_ms is the broker.wait p99 (lifetime in snapshot(),
    since the last reset_window() in window_snapshot()). With no
    broker.wait span both read 0.0; fed the same spans, both read the
    same p99."""
    boards = (quality.QualityBoard(), ref_quality.QualityBoard())
    recs = (get_recorder(), ref_trace.get_recorder())
    for board in boards:
        assert board.snapshot()["queueing_delay_ms"] == 0.0
        assert board.window_snapshot()["queueing_delay_ms"] == 0.0
        board.reset_window()
    base = time.monotonic()
    for rec in recs:
        for i, ms in enumerate((2.0, 5.0, 40.0, 7.0)):
            rec.record_span(f"q{i}", "broker.wait", base - ms / 1000.0, base)
    snaps = [b.snapshot()["queueing_delay_ms"] for b in boards]
    wins = [b.window_snapshot(reset=True)["queueing_delay_ms"]
            for b in boards]
    assert snaps[0] == snaps[1] > 0.0
    assert wins[0] == wins[1] == snaps[0]
    for rec in recs:
        rec.record_span("q9", "broker.wait", base - 0.001, base)
    wins = [b.window_snapshot()["queueing_delay_ms"] for b in boards]
    assert wins[0] == wins[1] < snaps[0]  # only the newest span
