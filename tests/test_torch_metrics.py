"""The port's telemetry registry (nomad_tpu_torch/utils/metrics.py):
the reference's own tests (tests/test_metrics.py: inmem interval sink,
log-bucket math, statsd/statsite/circonus sinks, the Prometheus
exposition and its line-level conformance parser) run on the port's
module, then the same samples go into both packages' histograms and
registries and must read back equal (buckets, percentiles, exposition
text).

The reference's server-emission test waits for the server modules
(ROADMAP, Queue A item 4)."""

import socket
import time

import numpy as np
import pytest

from nomad_tpu.utils import metrics as ref_metrics
from nomad_tpu_torch.utils import metrics as port_metrics
from nomad_tpu_torch.utils.metrics import InmemSink, Metrics, StatsdSink


def test_inmem_counter_gauge_sample_aggregation():
    sink = InmemSink(interval=60.0)
    sink.incr_counter("a.b", 1)
    sink.incr_counter("a.b", 3)
    sink.set_gauge("g", 7.0)
    sink.set_gauge("g", 9.0)  # last write wins within the interval
    for v in (5.0, 1.0, 3.0):
        sink.add_sample("s", v)

    snap = sink.snapshot()[-1]
    assert snap["counters"]["a.b"] == {"count": 2, "sum": 4}
    assert snap["gauges"]["g"] == 9.0
    s = snap["samples"]["s"]
    assert s["count"] == 3 and s["min"] == 1.0 and s["max"] == 5.0
    assert abs(s["mean"] - 3.0) < 1e-9


def test_hist_bucket_math_at_extremes():
    """Log-bucket ladder edges: zero/negative land in the dedicated
    zero bucket, sub-ms values in the floor bucket, multi-second values
    in a finite bucket whose bound brackets them within one ratio step,
    and absurd values clamp to the last bucket instead of overflowing."""
    from nomad_tpu_torch.utils.metrics import (
        HIST_BUCKETS,
        HIST_MIN_MS,
        HIST_RATIO,
        hist_bucket,
        hist_bucket_upper,
        hist_percentile,
    )

    assert hist_bucket(0.0) == 0 and hist_bucket(-3.0) == 0
    assert hist_bucket_upper(0) == 0.0
    assert hist_bucket(1e-7) == 1 and hist_bucket(HIST_MIN_MS) == 1
    for v in (0.004, 0.7, 12.5, 5_000.0, 3_600_000.0):  # sub-ms .. 1h
        b = hist_bucket(v)
        assert 1 < b < HIST_BUCKETS - 1
        assert v <= hist_bucket_upper(b) <= v * HIST_RATIO * (1 + 1e-9)
    assert hist_bucket(1e15) == HIST_BUCKETS - 1  # clamp, no IndexError
    # percentiles: empty -> 0; all-zero samples -> 0 (the zero bucket)
    assert hist_percentile([0] * HIST_BUCKETS, 0, 0.99) == 0.0
    zeros = [0] * HIST_BUCKETS
    zeros[0] = 10
    assert hist_percentile(zeros, 10, 0.99) == 0.0


def test_inmem_sample_percentiles():
    """p50/p95/p99 recoverable from any interval snapshot (the old
    count/sum/min/max could not reconstruct a percentile) — within one
    bucket-ratio step of the true order statistic."""
    import numpy as np

    from nomad_tpu_torch.utils.metrics import HIST_RATIO

    sink = InmemSink(interval=60.0)
    vals = [0.0, 0.0004] + [float(i) for i in range(1, 999)] + [7200.0]
    for v in vals:
        sink.add_sample("mixed", v)
    s = sink.snapshot()[-1]["samples"]["mixed"]
    for q, key in ((0.50, "p50"), (0.95, "p95"), (0.99, "p99")):
        true = float(np.percentile(vals, q * 100))
        assert true <= s[key] <= max(true, 1e-3) * HIST_RATIO * 1.02, (
            q, true, s[key])
    assert s["count"] == len(vals) and s["min"] == 0.0


def test_statsd_wire_format_unchanged_by_histograms():
    """The statsd/statsite sinks' line protocol must not grow bucket
    baggage — only the inmem sink aggregates histograms."""
    recv = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    recv.bind(("127.0.0.1", 0))
    recv.settimeout(2.0)
    port = recv.getsockname()[1]
    m = Metrics(prefix="nomad_tpu")
    m.add_sink(StatsdSink(f"127.0.0.1:{port}"))
    m.add_sample(("plan", "evaluate"), 12.5)
    assert recv.recv(1024).decode() == "nomad_tpu.plan.evaluate:12.5|ms"
    recv.close()


def test_prometheus_counters_survive_interval_rotation():
    """The exposition reads LIFETIME aggregates: counters must not
    shrink when old intervals rotate out of the inmem ring (a shrinking
    _total reads as a counter reset to rate())."""
    from nomad_tpu_torch.utils.metrics import Metrics, format_prometheus

    m = Metrics(prefix="nt")
    m.inmem.interval = 0.01
    m.inmem.retain = 2
    for _ in range(5):
        m.incr_counter(("c",), 1)
        m.add_sample(("s",), 1.0)
        time.sleep(0.015)
    # rolling window kept only 2 intervals...
    assert len(m.inmem._intervals) <= 2
    text = format_prometheus(m)
    # ...but the exposed totals cover all 5 increments
    assert "nt_c_total 5" in text
    assert "nt_s_count 5" in text


def test_prometheus_exposition_shape():
    from nomad_tpu_torch.utils.metrics import Metrics, format_prometheus

    m = Metrics(prefix="nt")
    m.incr_counter(("rpc", "query"), 3)
    m.set_gauge(("broker", "depth"), 5)
    for v in (1.0, 2.0, 400.0):
        m.add_sample(("plan", "evaluate"), v)
    text = format_prometheus(m)
    assert "# TYPE nt_rpc_query_total counter" in text
    assert "nt_rpc_query_total 3" in text
    assert "# TYPE nt_broker_depth gauge" in text
    assert "# TYPE nt_plan_evaluate histogram" in text
    assert 'nt_plan_evaluate_bucket{le="+Inf"} 3' in text
    assert "nt_plan_evaluate_count 3" in text
    assert "nt_plan_evaluate_sum 403" in text
    # cumulative: bucket counts never decrease
    cums = [int(line.rsplit(" ", 1)[1]) for line in text.splitlines()
            if line.startswith("nt_plan_evaluate_bucket")]
    assert cums == sorted(cums)


def _parse_exposition(text):
    """Line-level Prometheus 0.0.4 text-format parser (the conformance
    gate for /v1/metrics): validates comment structure, metric-name and
    label syntax, value syntax (including +Inf/-Inf/NaN spellings),
    single TYPE per family declared before its samples, and — for
    histograms — per-labelset le-ascending CUMULATIVE buckets ending in
    +Inf whose count equals _count, with _sum/_count present. Returns
    {family: type}; raises AssertionError on any violation."""
    import re

    name_re = r"[a-zA-Z_:][a-zA-Z0-9_:]*"
    label_re = re.compile(
        r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')
    sample_re = re.compile(
        rf"^({name_re})(?:\{{(.*)\}})? (\S+)$")
    types = {}
    seen_sample_families = set()
    # (family, frozenset(non-le labels)) -> [(le, cum)] + flags
    hist_series = {}
    hist_sum = set()
    hist_count = {}

    def family_of(name):
        for suffix in ("_bucket", "_sum", "_count", "_total"):
            if name.endswith(suffix) and name[: -len(suffix)] in types:
                return name[: -len(suffix)], suffix
        return name, ""

    def parse_value(v):
        if v in ("+Inf", "-Inf", "NaN"):
            return float(v.replace("Inf", "inf").replace("NaN", "nan"))
        return float(v)  # raises on malformed

    lines = text.splitlines()
    assert text.endswith("\n"), "exposition must end with a newline"
    for line in lines:
        assert line == line.strip(), f"stray whitespace: {line!r}"
        if not line:
            continue
        if line.startswith("#"):
            m = re.match(rf"^# (HELP|TYPE) ({name_re})(?: (.*))?$", line)
            assert m, f"malformed comment line: {line!r}"
            if m.group(1) == "TYPE":
                fam = m.group(2)
                for suffix in ("_total",):
                    if fam.endswith(suffix):
                        fam = fam  # _total families are declared whole
                assert fam not in types, f"duplicate TYPE for {fam}"
                assert fam not in seen_sample_families, (
                    f"TYPE for {fam} after its samples")
                assert m.group(3) in (
                    "counter", "gauge", "histogram", "summary",
                    "untyped"), f"bad type: {line!r}"
                types[fam] = m.group(3)
            continue
        m = sample_re.match(line)
        assert m, f"malformed sample line: {line!r}"
        name, labels_raw, value_raw = m.groups()
        value = parse_value(value_raw)
        labels = {}
        if labels_raw:
            consumed = label_re.sub("", labels_raw).strip(", ")
            assert consumed == "", f"malformed labels: {line!r}"
            labels = dict(label_re.findall(labels_raw))
        fam, suffix = family_of(name)
        assert fam in types, f"sample before any TYPE: {line!r}"
        seen_sample_families.add(fam)
        if types[fam] == "histogram":
            key = (fam, frozenset(
                (k, v) for k, v in labels.items() if k != "le"))
            if suffix == "_bucket":
                le = labels.get("le")
                assert le is not None, f"bucket without le: {line!r}"
                le_v = parse_value(le)
                series = hist_series.setdefault(key, [])
                if series:
                    assert le_v > series[-1][0], (
                        f"le not ascending: {line!r}")
                    assert value >= series[-1][1], (
                        f"cumulative count decreased: {line!r}")
                series.append((le_v, value))
            elif suffix == "_sum":
                hist_sum.add(key)
            elif suffix == "_count":
                hist_count[key] = value
    for key, series in hist_series.items():
        fam = key[0]
        assert series, f"histogram {fam} with no buckets"
        assert series[-1][0] == float("inf"), (
            f"histogram {fam} missing +Inf bucket")
        assert key in hist_sum, f"histogram {fam} missing _sum"
        assert key in hist_count, f"histogram {fam} missing _count"
        assert series[-1][1] == hist_count[key], (
            f"histogram {fam}: +Inf bucket != _count")
    return types


def test_prometheus_exposition_line_level_conformance():
    """The 0.0.4 parser gate over a fully-populated registry: every
    line must parse, histograms must be cumulative/le-ordered with
    +Inf/_sum/_count, TYPE once per family before its samples."""
    from nomad_tpu_torch.utils.metrics import Metrics, format_prometheus

    m = Metrics(prefix="nt")
    m.incr_counter(("rpc", "query"), 3)
    m.incr_counter(("broker", "shed"), 1)
    m.set_gauge(("broker", "depth"), 5.5)
    m.set_gauge(("weird", "gauge"), float("nan"))  # must not crash
    m.set_gauge(("inf", "gauge"), float("inf"))
    for v in (0.0, 0.5, 1.0, 2.0, 400.0, 9e9):
        m.add_sample(("plan", "evaluate"), v)
    for v in (1.0, 3.0):
        m.add_sample(("http", "request", "GET", "jobs"), v)
    text = format_prometheus(m)
    types = _parse_exposition(text)
    assert types["nt_rpc_query_total"] == "counter"
    assert types["nt_broker_depth"] == "gauge"
    assert types["nt_plan_evaluate"] == "histogram"
    assert "NaN" in text and "+Inf" in text  # exposition spellings


def test_prometheus_exposition_name_collision_single_family():
    """Two raw names sanitizing to one prom name must not emit two
    TYPE blocks (a parse error for every scraper): first wins."""
    from nomad_tpu_torch.utils.metrics import Metrics, format_prometheus

    m = Metrics(prefix="nt")
    m.add_sample(("a.b", "x"), 1.0)
    m.add_sample(("a_b", "x"), 2.0)
    text = format_prometheus(m)
    assert text.count("# TYPE nt_a_b_x histogram") == 1
    _parse_exposition(text)


def test_profile_exposition_passes_conformance_parser():
    """The observatory's labelled histograms ride the same gate: the
    combined /v1/metrics body (registry + profiler) must parse line by
    line."""
    import threading

    from nomad_tpu_torch import profile
    from nomad_tpu_torch.profile import ProfiledLock, get_profiler
    from nomad_tpu_torch.utils.metrics import Metrics, format_prometheus

    prof = get_profiler()
    prof.reset()
    lock = ProfiledLock("conf.site")

    def holder():
        with lock:
            time.sleep(0.02)

    t = threading.Thread(target=holder)
    t.start()
    time.sleep(0.005)
    with lock:
        pass
    t.join()
    profile.record_runq("batch_park", 2.0)
    profile.park("conf.park")
    profile.unpark("conf.park")
    m = Metrics(prefix="nt")
    m.incr_counter(("rpc", "query"), 1)
    text = format_prometheus(m) + prof.format_prometheus()
    types = _parse_exposition(text)
    assert types["nomad_tpu_profile_lock_wait_ms"] == "histogram"
    assert types["nomad_tpu_profile_runq_delay_ms"] == "histogram"
    assert types["nomad_tpu_profile_convoys_total"] == "counter"
    prof.reset()


def test_inmem_interval_rotation():
    sink = InmemSink(interval=0.01, retain=3)
    for i in range(6):
        sink.incr_counter("c", 1)
        time.sleep(0.015)
    assert len(sink._intervals) <= 3


def test_metrics_prefix_and_measure_since():
    m = Metrics(prefix="test")
    start = time.monotonic()
    time.sleep(0.01)
    m.measure_since(("stage", "x"), start)
    snap = m.snapshot()[-1]
    (name,) = snap["samples"].keys()
    assert name == "test.stage.x"
    assert snap["samples"][name]["max"] >= 10.0  # milliseconds


def test_statsd_sink_sends_datagrams():
    recv = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    recv.bind(("127.0.0.1", 0))
    recv.settimeout(2.0)
    port = recv.getsockname()[1]

    m = Metrics(prefix="nomad_tpu")
    m.add_sink(StatsdSink(f"127.0.0.1:{port}"))
    m.incr_counter(("rpc", "query"), 1)
    m.set_gauge(("broker", "depth"), 5)
    m.add_sample(("plan", "evaluate"), 12.5)

    got = set()
    for _ in range(3):
        got.add(recv.recv(1024).decode())
    assert "nomad_tpu.rpc.query:1|c" in got
    assert "nomad_tpu.broker.depth:5|g" in got
    assert "nomad_tpu.plan.evaluate:12.5|ms" in got
    recv.close()


def test_statsite_sink_tcp():
    """Statsite speaks statsd lines over persistent TCP
    (go-metrics statsite.go)."""
    import socket
    import threading

    from nomad_tpu_torch.utils.metrics import StatsiteSink

    received = []
    ready = threading.Event()
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    port = srv.getsockname()[1]

    def accept():
        ready.set()
        conn, _ = srv.accept()
        buf = b""
        while b"\n" not in buf or buf.count(b"\n") < 3:
            data = conn.recv(4096)
            if not data:
                break
            buf += data
        received.extend(buf.decode().strip().splitlines())
        conn.close()

    t = threading.Thread(target=accept, daemon=True)
    t.start()
    ready.wait(2.0)

    sink = StatsiteSink(f"127.0.0.1:{port}")
    sink.incr_counter("a.b", 2)
    sink.set_gauge("a.g", 7.5)
    sink.add_sample("a.s", 12.0)
    t.join(timeout=3.0)
    sink.close()
    srv.close()
    assert "a.b:2|c" in received
    assert "a.g:7.5|g" in received
    assert "a.s:12.0|ms" in received


def test_statsite_sink_survives_down_target():
    from nomad_tpu_torch.utils.metrics import StatsiteSink

    sink = StatsiteSink("127.0.0.1:1")  # nothing listens there
    sink.incr_counter("x", 1)  # must not raise
    sink.close()


def test_hostname_tagging_gauges_only():
    """Only gauges carry the hostname (go-metrics SetGauge semantics);
    counters/samples stay cluster-aggregatable."""
    from nomad_tpu_torch.utils.metrics import Metrics

    m = Metrics("nomad_tpu", hostname="host1")
    m.incr_counter("worker.dequeue", 1)
    m.add_sample("worker.invoke", 2.0)
    m.set_gauge("broker.ready", 3)
    counters, gauges, samples = set(), set(), set()
    for iv in m.snapshot():
        counters |= set(iv["counters"])
        gauges |= set(iv["gauges"])
        samples |= set(iv["samples"])
    assert "nomad_tpu.worker.dequeue" in counters
    assert "nomad_tpu.worker.invoke" in samples
    assert "nomad_tpu.host1.broker.ready" in gauges


def test_format_snapshot():
    from nomad_tpu_torch.utils.metrics import Metrics, format_snapshot

    m = Metrics("t")
    m.incr_counter("c1", 3)
    m.set_gauge("g1", 9)
    m.add_sample("s1", 4.5)
    text = format_snapshot(m.snapshot())
    assert "counter t.c1: count=1 sum=3" in text
    assert "gauge t.g1: 9" in text
    assert "sample t.s1: count=1 mean=4.500" in text


def test_configure_full():
    import nomad_tpu_torch.utils.metrics as gm

    m = gm.configure(statsd_addr="127.0.0.1:18125",
                     statsite_addr="",
                     disable_hostname=False, interval=5.0)
    try:
        assert m.hostname  # hostname tagging on
        assert m.inmem.interval == 5.0
        m.incr_counter("x", 1)  # statsd UDP send must not raise
    finally:
        gm.configure()


def test_circonus_sink_flushes_httptrap():
    """CirconusSink batches metrics and PUTs one JSON document to the
    submission URL (httptrap shape)."""
    import http.server
    import json
    import socketserver
    import threading

    from nomad_tpu_torch.utils.metrics import CirconusSink

    received = []
    done = threading.Event()

    class Handler(http.server.BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_PUT(self):
            n = int(self.headers.get("Content-Length") or 0)
            received.append(json.loads(self.rfile.read(n)))
            self.send_response(200)
            self.send_header("Content-Length", "2")
            self.end_headers()
            self.wfile.write(b"{}")
            done.set()

    class Server(socketserver.ThreadingMixIn, http.server.HTTPServer):
        daemon_threads = True

    srv = Server(("127.0.0.1", 0), Handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{srv.server_address[1]}/module/httptrap/x/y"
    sink = CirconusSink(url, flush_interval=3600)  # manual flush only
    try:
        sink.set_gauge("nomad_tpu.broker.total_ready", 4)
        sink.incr_counter("nomad_tpu.worker.dequeue", 1)
        sink.flush()
        assert done.wait(5.0)
        doc = received[0]
        assert doc["nomad_tpu.broker.total_ready"] == {"_type": "n",
                                                       "_value": 4}
        assert "nomad_tpu.worker.dequeue" in doc
        # a second flush with nothing pending sends nothing
        count = len(received)
        sink.flush()
        assert len(received) == count
    finally:
        sink.close()
        srv.shutdown()
        srv.server_close()


def test_circonus_sink_survives_down_endpoint():
    from nomad_tpu_torch.utils.metrics import CirconusSink

    sink = CirconusSink("http://127.0.0.1:1/x", flush_interval=3600)
    sink.set_gauge("g", 1)
    sink.flush()  # must not raise
    sink.close()


def test_circonus_counters_accumulate():
    from nomad_tpu_torch.utils.metrics import CirconusSink

    sink = CirconusSink("http://127.0.0.1:1/x", flush_interval=3600)
    try:
        for _ in range(5):
            sink.incr_counter("c", 1)
        sink.set_gauge("g", 1)
        sink.set_gauge("g", 9)
        with sink._lock:
            assert sink._pending["c"] == 5  # counters sum
            assert sink._pending["g"] == 9  # gauges last-write-wins
    finally:
        sink.close()


# ---------------------------------------------------------------------
# parity: the same samples into both packages


def _samples(seed, n=2000):
    """Latencies in ms over the ladder's whole range: zeros, sub-floor
    values, a log-normal body and a few multi-second outliers."""
    rng = np.random.default_rng(seed)
    body = rng.lognormal(mean=1.0, sigma=1.5, size=n)
    return np.concatenate([[0.0, -1.0, 1e-7, 3_600_000.0, 1e15],
                           body, rng.uniform(1_000, 9_000, size=7)])


def test_ladder_constants_match_the_reference():
    for name in ("HIST_BUCKETS", "HIST_MIN_MS", "HIST_RATIO",
                 "NTA_RECORD_PATH"):
        assert getattr(port_metrics, name) == getattr(ref_metrics, name)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_latency_hist_parity(seed):
    port, ref = port_metrics.LatencyHist(), ref_metrics.LatencyHist()
    for v in _samples(seed):
        port.observe(float(v))
        ref.observe(float(v))
    assert port.buckets == ref.buckets
    assert (port.count, port.total, port.max) == (ref.count, ref.total,
                                                   ref.max)
    for q in (0.0, 0.25, 0.5, 0.9, 0.95, 0.99, 0.999, 1.0):
        assert port_metrics.hist_percentile(port.buckets, port.count, q) == \
            ref_metrics.hist_percentile(ref.buckets, ref.count, q)
    for v in _samples(seed, 50):
        assert port_metrics.hist_bucket(float(v)) == \
            ref_metrics.hist_bucket(float(v))


def _fill(m, seed):
    rng = np.random.default_rng(seed)
    m.incr_counter(("rpc", "query"), 3)
    m.incr_counter(("broker", "shed"), 1)
    m.set_gauge(("broker", "depth"), 5.5)
    m.set_gauge(("inf", "gauge"), float("inf"))
    for v in _samples(seed, 300):
        m.add_sample(("plan", "evaluate"), float(v))
    for v in rng.uniform(0.1, 50.0, size=40):
        m.add_sample(("http", "request", "GET", "jobs"), float(v))


@pytest.mark.parametrize("seed", [0, 3])
def test_prometheus_text_parity(seed):
    port = port_metrics.Metrics(prefix="nt")
    ref = ref_metrics.Metrics(prefix="nt")
    _fill(port, seed)
    _fill(ref, seed)
    text = port_metrics.format_prometheus(port)
    assert text == ref_metrics.format_prometheus(ref)
    _parse_exposition(text)


def test_histogram_family_emitter_parity():
    hist = port_metrics.LatencyHist()
    for v in _samples(5, 100):
        hist.observe(float(v))
    series = {"": (hist.count, hist.total, list(hist.buckets)),
              'a"b': (2, 3.0, {4: 1, 9: 1})}
    port_lines, ref_lines = [], []
    port_metrics.emit_histogram_family(port_lines, "x_ms", "help", series)
    ref_metrics.emit_histogram_family(ref_lines, "x_ms", "help", series)
    assert port_lines == ref_lines

