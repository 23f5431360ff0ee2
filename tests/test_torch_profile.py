"""The port's contention observatory (nomad_tpu_torch/profile): the
reference's own tests (tests/test_profile.py: ProfiledLock parity with
threading primitives, concurrent-writer safety on the profiler rings,
the convoy detector's 64-thread fixture, the GIL sampler, the
Prometheus exposition, the Chrome trace-event export, retirement and
reset) run on the port's module; then the same traces, timeline events
and convoys go through both packages' Chrome exporters and must give
equal documents and equal validator verdicts.

The reference tests of tools/traceconv.py, the HTTP endpoints and the
admission pressure monitor wait for those modules (ROADMAP, Queue A
items 4-6)."""

import json
import threading
import time

import pytest

from nomad_tpu import profile as ref_profile
from nomad_tpu.profile import export as ref_export
from nomad_tpu_torch import profile
from nomad_tpu_torch.profile import (
    ProfiledCondition,
    ProfiledLock,
    ProfiledRLock,
    get_profiler,
)
from nomad_tpu_torch.profile.export import chrome_trace, validate_chrome_trace
from nomad_tpu_torch.profile.timeline import ConvoyTracker, Timeline


@pytest.fixture
def prof():
    p = get_profiler()
    p.reset()
    p.set_enabled(True)
    yield p
    p.reset()
    p.set_enabled(True)


# ---------------------------------------------------------------------
# ProfiledLock semantics parity


def test_lock_context_manager_and_locked(prof):
    lock = ProfiledLock("t.basic")
    assert not lock.locked()
    with lock:
        assert lock.locked()
    assert not lock.locked()


def test_lock_nonblocking_and_timeout_acquire(prof):
    lock = ProfiledLock("t.nb")
    assert lock.acquire(blocking=False)
    # Held: a second non-blocking acquire fails without deadlock, a
    # bounded blocking acquire times out False.
    got = [None, None]

    def other():
        got[0] = lock.acquire(blocking=False)
        got[1] = lock.acquire(True, 0.02)

    t = threading.Thread(target=other)
    t.start()
    t.join()
    assert got == [False, False]
    lock.release()
    assert lock.acquire(True, 0.5)
    lock.release()


def test_lock_releases_on_context_exception(prof):
    lock = ProfiledLock("t.exc")
    with pytest.raises(RuntimeError):
        with lock:
            raise RuntimeError("boom")
    # The with-statement released despite the exception.
    assert lock.acquire(blocking=False)
    lock.release()


def test_rlock_reentrancy(prof):
    lock = ProfiledRLock("t.rlock")
    with lock:
        with lock:
            with lock:
                assert lock._depth == 3
        assert lock._depth == 1
    assert lock._depth == 0
    # Hold recorded ONCE per outermost hold, not per nesting level.
    assert lock.stats.hold.count == 1
    assert lock.stats.acquires == 3


def test_rlock_locked_parity(prof):
    """threading.RLock has no .locked() before 3.14; the drop-in
    wrapper must answer correctly anyway — including for the owner
    (where a naive non-blocking probe would reentrantly succeed and
    report free)."""
    lock = ProfiledRLock("t.rlocked")
    assert not lock.locked()
    with lock:
        assert lock.locked()
        seen = []
        t = threading.Thread(target=lambda: seen.append(lock.locked()))
        t.start()
        t.join()
        assert seen == [True]
    assert not lock.locked()


def test_unpark_balances_after_disable_mid_park(prof):
    """A park counted while enabled must decrement even if recording
    is switched off mid-park (the bench --profile-ab off arm), or the
    width gauge reports a phantom pile-up forever."""
    parked = profile.park("t.flip")
    assert parked is True
    prof.set_enabled(False)
    profile.unpark("t.flip")
    prof.set_enabled(True)
    assert prof.convoy_table()["sites"]["t.flip"]["width"] == 0
    # And a park attempted while disabled reports uncounted, so the
    # caller skips the matching unpark.
    prof.set_enabled(False)
    assert profile.park("t.flip") is False


def test_rlock_cross_thread_exclusion(prof):
    lock = ProfiledRLock("t.rlock2")
    lock.acquire()
    seen = []

    def other():
        seen.append(lock.acquire(blocking=False))

    t = threading.Thread(target=other)
    t.start()
    t.join()
    assert seen == [False]
    lock.release()


def test_condition_wait_timeout_returns_false(prof):
    cond = ProfiledCondition(ProfiledLock("t.cond.to"), "t.cond.to")
    t0 = time.monotonic()
    with cond:
        assert cond.wait(0.05) is False
    assert time.monotonic() - t0 >= 0.04
    # The park landed in the cond-wait histogram, and hold accounting
    # resumed (release observed a second, tiny hold).
    assert cond.stats.cond_waits == 1
    assert cond.stats.cond_wait.count == 1


def test_condition_notify_wakes_waiter(prof):
    lock = ProfiledLock("t.cond.n")
    cond = ProfiledCondition(lock, "t.cond.n")
    results = []

    def waiter():
        with cond:
            results.append(cond.wait(5.0))

    t = threading.Thread(target=waiter)
    t.start()
    time.sleep(0.05)
    with cond:
        cond.notify_all()
    t.join(timeout=5.0)
    assert results == [True]


def test_condition_over_rlock_with_reentrant_notify(prof):
    """The broker shape: Condition over an RLock, notified from a
    nested (reentrant) critical section."""
    lock = ProfiledRLock("t.cond.r")
    cond = ProfiledCondition(lock, "t.cond.r")
    results = []

    def waiter():
        with cond:
            results.append(cond.wait(5.0))

    t = threading.Thread(target=waiter)
    t.start()
    time.sleep(0.05)
    with cond:
        with lock:  # reentrant alias of the same lock
            cond.notify_all()
    t.join(timeout=5.0)
    assert results == [True]
    # Wrapper depth bookkeeping survived the cond.wait save/restore.
    assert lock._depth == 0 and lock._owner is None


def test_condition_wait_for(prof):
    cond = ProfiledCondition(ProfiledLock("t.cond.wf"), "t.cond.wf")
    flag = []

    def setter():
        time.sleep(0.05)
        with cond:
            flag.append(1)
            cond.notify_all()

    t = threading.Thread(target=setter)
    t.start()
    with cond:
        assert cond.wait_for(lambda: flag, timeout=5.0)
    t.join()


def test_condition_requires_profiled_lock(prof):
    with pytest.raises(TypeError):
        ProfiledCondition(threading.Lock(), "t.raw")


def test_contended_wait_and_hold_recorded(prof):
    lock = ProfiledLock("t.contend")

    def holder():
        with lock:
            time.sleep(0.03)

    t = threading.Thread(target=holder)
    t.start()
    time.sleep(0.005)
    with lock:
        pass
    t.join()
    st = lock.stats
    assert st.contended == 1
    assert st.wait.count == 1
    assert st.wait.max >= 10.0  # waited most of the 30ms hold
    assert st.hold.count == 2
    assert st.hold.max >= 25.0
    # The waiting thread's drill-down attributes the wait to the site.
    table = prof.threads_table()
    me = threading.current_thread().name
    assert table[me]["lock_waits"] >= 1
    assert table[me]["hottest_site"] == "t.contend"
    assert prof.thread_wait_ms() > 0.0


def test_disabled_profiler_still_locks_correctly(prof):
    prof.set_enabled(False)
    lock = ProfiledLock("t.disabled")
    with lock:
        assert lock.locked()
    rlock = ProfiledRLock("t.disabled.r")
    with rlock:
        with rlock:
            pass
    cond = ProfiledCondition(ProfiledLock("t.disabled.c"), "t.disabled.c")
    with cond:
        assert cond.wait(0.01) is False
    assert lock.stats.acquires == 0
    assert cond.stats.cond_waits == 0


def test_site_aggregation_across_instances(prof):
    """Stripe shape: N locks sharing one declaration site aggregate in
    the read-side table."""
    locks = [ProfiledLock("t.stripe") for _ in range(4)]
    for lk in locks:
        with lk:
            pass
    table = prof.lock_table()
    assert table["t.stripe"]["instances"] >= 4
    assert table["t.stripe"]["acquires"] >= 4


# ---------------------------------------------------------------------
# Timeline ring: concurrent writers, no torn events, caps respected


def test_timeline_concurrent_writers_no_torn_events():
    tl = Timeline(cap=256)
    n_threads, per_thread = 8, 500

    def writer(tid):
        for i in range(per_thread):
            # Self-consistent payload: b is derived from a, so a torn
            # event (fields from two writers) breaks the checksum.
            tl.push("park", f"w{tid}", a=i, b=i * 31 + tid)

    threads = [threading.Thread(target=writer, args=(k,))
               for k in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    stats = tl.stats()
    assert stats["events"] == n_threads * per_thread
    assert stats["stored"] == 256  # cap respected, drop-oldest
    events = tl.events()
    assert len(events) == 256
    for (_t, _wall, kind, thread, a, b) in events:
        assert kind == "park"
        tid = int(thread[1:])
        assert b == a * 31 + tid, "torn event: payload fields mixed"


def test_timeline_events_limit_and_order():
    tl = Timeline(cap=64)
    for i in range(100):
        tl.push("ack", a=i)
    evts = tl.events(limit=10)
    assert [e[4] for e in evts] == list(range(90, 100))  # newest, ordered


# ---------------------------------------------------------------------
# Convoy detector


def test_convoy_tracker_width_and_duration():
    tr = ConvoyTracker(min_width=3, keep=8)
    for _ in range(5):
        tr.park()
    assert tr.stats()["width"] == 5
    time.sleep(0.02)
    for _ in range(5):
        tr.unpark()
    assert tr.stats()["width"] == 0
    assert tr.convoys == 1
    recent = tr.recent()
    assert recent[0]["width"] == 5
    assert recent[0]["duration_ms"] >= 10.0


def test_convoy_below_threshold_not_reported():
    tr = ConvoyTracker(min_width=4, keep=8)
    tr.park()
    tr.park()
    tr.unpark()
    tr.unpark()
    assert tr.convoys == 0
    assert tr.stats()["max_width"] == 2


def test_synthetic_64_thread_convoy(prof):
    """The batch-boundary fixture: 64 threads pile up at a park site;
    the detector must report a convoy of width >= 48."""
    n = 64
    release = threading.Event()
    started = threading.Barrier(n + 1)

    def worker():
        started.wait(timeout=10.0)
        profile.park("test.convoy")
        try:
            release.wait(timeout=10.0)
        finally:
            profile.unpark("test.convoy")

    threads = [threading.Thread(target=worker) for _ in range(n)]
    for t in threads:
        t.start()
    started.wait(timeout=10.0)
    # Wait until the pile-up is visible, then release.
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline:
        width = prof.convoy_table()["sites"].get(
            "test.convoy", {}).get("width", 0)
        if width >= 48:
            break
        time.sleep(0.005)
    assert width >= 48, f"pile-up never reached width 48 (saw {width})"
    release.set()
    for t in threads:
        t.join(timeout=10.0)
    table = prof.convoy_table()
    assert table["max_width"] >= 48
    assert table["convoys"] >= 1
    widest = max(c["width"] for c in table["recent"])
    assert widest >= 48
    # The park/unpark flow landed in the timeline too.
    kinds = {e[2] for e in prof.timeline.events()}
    assert {"park", "unpark"} <= kinds


# ---------------------------------------------------------------------
# GIL sampler + runq


def test_gil_sampler_measures_overshoot(prof):
    prof.gil.interval = 0.002
    prof.gil.start()
    try:
        deadline = time.monotonic() + 5.0
        while prof.gil.hist.count < 5 and time.monotonic() < deadline:
            time.sleep(0.01)
    finally:
        prof.gil.stop()
    stats = prof.gil.stats()
    assert stats["count"] >= 5
    assert stats["p99_ms"] >= 0.0
    assert not prof.gil.running()


def test_runq_sites_fixed_vocabulary(prof):
    profile.record_runq("batch_park", 1.5)
    profile.record_runq("broker_drain", 2.5)
    profile.record_runq("not_a_site", 9.9)  # ignored, never grows
    table = prof.runq_table()
    assert set(table) == {"batch_park", "broker_drain"}
    assert table["batch_park"]["count"] == 1


def test_profiler_snapshot_shape(prof):
    lock = ProfiledLock("t.snap")
    with lock:
        pass
    snap = prof.snapshot(threads=True)
    assert snap["enabled"] is True
    assert "t.snap" in snap["locks"]
    for key in ("gil", "runq", "convoys", "timeline", "threads"):
        assert key in snap
    json.dumps(snap)  # everything JSON-serializable


# ---------------------------------------------------------------------
# Prometheus exposition of the observatory


def test_profile_prometheus_exposition(prof):
    lock = ProfiledLock("t.prom")

    def holder():
        with lock:
            time.sleep(0.02)

    t = threading.Thread(target=holder)
    t.start()
    time.sleep(0.005)
    with lock:
        pass
    t.join()
    profile.record_runq("batch_park", 3.0)
    text = prof.format_prometheus()
    assert '# TYPE nomad_tpu_profile_lock_wait_ms histogram' in text
    assert 'site="t.prom"' in text
    assert 'le="+Inf"' in text
    assert "nomad_tpu_profile_lock_wait_ms_sum" in text
    assert "nomad_tpu_profile_lock_wait_ms_count" in text
    assert "# TYPE nomad_tpu_profile_convoy_max_width gauge" in text
    assert "# TYPE nomad_tpu_profile_convoys_total counter" in text


# ---------------------------------------------------------------------
# Chrome trace-event export + traceconv round trip


def _sample_traces():
    from nomad_tpu_torch.trace import get_recorder

    rec = get_recorder()
    rec.reset()
    for i in range(3):
        eid = f"chrome-{i}"
        t0 = time.monotonic()
        rec.record_span(eid, "scheduler.process", t0 - 0.05, t0 - 0.01,
                        ann={"path": "test"})
        rec.record_span(eid, "device.dispatch", t0 - 0.04, t0 - 0.02)
        rec.complete(eid)
    traces = rec.traces(10)
    rec.reset()
    return traces


def test_chrome_export_schema_valid(prof):
    traces = _sample_traces()
    profile.event("launch", "dispatcher", a=3)
    profile.park("test.chrome")
    profile.unpark("test.chrome")
    doc = chrome_trace(
        traces,
        timeline=prof.timeline.events(),
        convoys=[{"start_unix": time.time(), "duration_ms": 5.0,
                  "width": 12, "site": "test.chrome"}])
    assert validate_chrome_trace(doc) == []
    events = doc["traceEvents"]
    # Every eval got a track: a thread_name metadata event + X spans.
    meta = [e for e in events if e["ph"] == "M" and e["tid"] >= 10]
    assert len(meta) == 3
    spans = [e for e in events if e["ph"] == "X" and e.get("cat") == "eval"]
    assert len(spans) == 6
    for e in spans:
        assert e["dur"] > 0 and e["ts"] > 1e15  # absolute wall micros
    # Pipeline instants + the convoy interval are present.
    assert any(e["ph"] == "i" and e["name"] == "launch" for e in events)
    assert any(e.get("cat") == "convoy" for e in events)


def test_chrome_export_dedups_tail_first():
    traces = _sample_traces()
    dup = dict(traces[0])
    dup["status"] = "tail-copy"
    doc = chrome_trace([dup] + traces)
    names = [e["args"]["name"] for e in doc["traceEvents"]
             if e["ph"] == "M" and e["tid"] >= 10]
    # First occurrence wins; no duplicate track for the same eval.
    assert len(names) == 3
    assert any("tail-copy" in n for n in names)


def test_validate_chrome_trace_catches_violations():
    assert validate_chrome_trace({"nope": 1})
    bad = {"traceEvents": [
        {"ph": "X", "pid": 1, "tid": 2, "name": "x", "ts": -5, "dur": 1},
        {"ph": "Z", "pid": 1, "tid": 2, "name": "x", "ts": 0},
        {"ph": "X", "pid": 1, "tid": 2, "name": "", "ts": 0, "dur": 1},
    ]}
    errors = validate_chrome_trace(bad)
    assert len(errors) == 3


# ---------------------------------------------------------------------
# Reset semantics (bench A/B isolation)


def test_dead_locks_retire_into_site_aggregate(prof):
    """Snapshot churn (a ProfiledLock per ClusterBase) must not
    exhaust the registry or accrete dead histograms: a GC'd lock's
    counts fold into the site's retired aggregate, its live slot
    frees, and the site table still reports the full history."""
    import gc

    before = prof._lock_instances
    for _ in range(10):
        lock = ProfiledLock("t.churn")
        with lock:
            pass
        del lock
    gc.collect()
    table = prof.lock_table()  # read side drains the retired queue
    # No net growth from the churned locks (<=, not ==: the drain may
    # also retire other tests' dead locks from earlier in the session,
    # shrinking the count below `before`).
    assert prof._lock_instances <= before
    with prof._reg_lock:
        assert prof._lock_sites.get("t.churn", []) == []  # slots freed
    assert table["t.churn"]["acquires"] == 10  # history retained
    assert table["t.churn"]["instances"] == 1  # one retired aggregate
    # And disabled-arm holds never leave a stale stamp behind: a hold
    # spanning a disable/enable flip records nothing giant.
    lock = ProfiledLock("t.stale")
    lock.acquire()
    prof.set_enabled(False)
    lock.release()
    lock.acquire()
    prof.set_enabled(True)
    time.sleep(0.01)
    lock.release()
    assert lock.stats.hold.max < 1000.0  # no disabled-window hold
    assert lock.stats.hold.count <= 1


def test_reset_clears_stats_but_keeps_registrations(prof):
    lock = ProfiledLock("t.reset")
    with lock:
        pass
    profile.park("t.reset.site")
    profile.unpark("t.reset.site")
    assert prof.lock_table()["t.reset"]["acquires"] == 1
    prof.reset()
    table = prof.lock_table()
    assert "t.reset" in table  # registration survives
    assert table["t.reset"]["acquires"] == 0
    assert prof.timeline.stats()["events"] == 0
    with lock:
        pass
    assert prof.lock_table()["t.reset"]["acquires"] == 1


# ---------------------------------------------------------------------
# parity: both packages' exporters and record paths on the same inputs


def _fixed_traces():
    """Completed-trace dicts as the recorder publishes them, on fixed
    wall stamps (so both exporters see identical input)."""
    out = []
    for i in range(3):
        spans = [
            {"name": "scheduler.process", "start_ms": 0.0,
             "end_ms": 40.0 + i, "duration_ms": 40.0 + i, "parent": None,
             "annotations": {"path": "test"}},
            {"name": "device.dispatch", "start_ms": 10.0, "end_ms": 30.0,
             "duration_ms": 20.0, "parent": "scheduler.process"},
            {"name": "device.solve", "start_ms": 12.5, "end_ms": 29.0,
             "duration_ms": 16.5, "parent": "device.dispatch",
             "annotations": {"kernel": "greedy", "batch": 3},
             "faults": [{"site": "binpack.device", "ordinal": 1,
                         "kind": "error"}]},
        ]
        out.append({"eval_id": f"chrome-{i}", "trace_id": f"tr-{i}",
                    "status": "complete",
                    "start_unix": 1_800_000_000.0 + i * 0.5,
                    "duration_ms": 40.0 + i, "spans": spans,
                    "dropped_spans": 0})
    return out


TIMELINE = [(10.0, 1_800_000_000.01, "launch", "dispatcher", 3, 0),
            (10.1, 1_800_000_000.02, "park", "worker-1", 1, "batcher.place"),
            (10.2, 1_800_000_000.03, "unpark", "worker-1", 0,
             "batcher.place")]
CONVOYS = [{"start_unix": 1_800_000_000.5, "duration_ms": 5.0, "width": 12,
            "site": "batcher.place"}]


@pytest.mark.parametrize("parts", ["traces", "timeline", "all", "dup"])
def test_chrome_export_parity(parts):
    traces = _fixed_traces()
    if parts == "dup":
        dup = dict(traces[0], status="tail-copy")
        traces = [dup] + traces
    kw = {}
    if parts in ("timeline", "all"):
        kw["timeline"] = TIMELINE
    if parts == "all":
        kw["convoys"] = CONVOYS
    got = chrome_trace(traces if parts != "timeline" else [], **kw)
    want = ref_export.chrome_trace(traces if parts != "timeline" else [],
                                   **kw)
    assert got == want
    assert validate_chrome_trace(got) == ref_export.validate_chrome_trace(
        want) == []
    json.dumps(got)


@pytest.mark.parametrize("doc", [
    {"nope": 1},
    {"traceEvents": "x"},
    {"traceEvents": [
        {"ph": "X", "pid": 1, "tid": 2, "name": "x", "ts": -5, "dur": 1},
        {"ph": "Z", "pid": 1, "tid": 2, "name": "x", "ts": 0},
        {"ph": "X", "pid": 1, "tid": 2, "name": "", "ts": 0, "dur": 1},
        {"ph": "X", "pid": 1, "name": "y", "ts": 0},
        {"ph": "i", "pid": 1, "tid": 0, "name": "launch", "ts": 3}]},
])
def test_validator_verdict_parity(doc):
    assert validate_chrome_trace(doc) == ref_export.validate_chrome_trace(doc)


def test_runq_and_convoy_record_parity(prof):
    """The same run-queue stamps and park/unpark sequence into both
    profilers give equal runq and convoy site tables."""
    ref = ref_profile.get_profiler()
    ref.reset()
    ref.set_enabled(True)
    try:
        for p, mod in ((prof, profile), (ref, ref_profile)):
            for ms in (0.05, 1.5, 2.5, 40.0, 0.0, -1.0):
                mod.record_runq("batch_park", ms)
            mod.record_runq("not_a_site", 9.9)
            for _ in range(6):
                mod.park("parity.site")
            for _ in range(6):
                mod.unpark("parity.site")
        assert prof.runq_table() == ref.runq_table()
        got = prof.convoy_table()["sites"]["parity.site"]
        want = ref.convoy_table()["sites"]["parity.site"]
        assert got == want
        assert got["max_width"] == 6
        assert got["convoys"] == want["convoys"] == 1
        assert profile.RUNQ_SITES == ref_profile.RUNQ_SITES
    finally:
        ref.reset()

