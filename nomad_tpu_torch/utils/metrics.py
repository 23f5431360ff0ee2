"""Telemetry: counters, gauges, and timing samples with pluggable sinks.

Reference: the go-metrics fanout wired in command/agent/command.go:570
(setupTelemetry) — an in-memory interval sink (signal-dumpable) plus
optional statsd/statsite UDP sinks — and the `MeasureSince` calls
sprinkled through worker.go:152,248,290, plan_apply.go:168,195, fsm.go
per-handler, and rpc.go:168-172.
"""

from __future__ import annotations

import math
import re
import socket
import threading
import time
from collections import defaultdict
from typing import Dict, List, Optional

# ------------------------------------------------------ histogram math
#
# Log-bucketed latency histograms (milliseconds). Shared by the inmem
# sink's samples and the trace flight recorder (trace/) so
# both report percentiles off the same bucket ladder. Layout:
#
#   bucket 0              v <= 0            (upper bound 0)
#   bucket 1              0 < v <= 1e-3 ms  (sub-microsecond floor)
#   bucket i >= 2         upper = 1e-3 * RATIO^(i-1)
#
# RATIO = 2^(1/4) (~19% bucket width): a percentile read off a bucket's
# upper bound overstates the true value by at most one ratio step. 200
# buckets span 1e-3 ms .. ~8e8 ms (~9 days) — everything past the top
# clamps into the last bucket.

HIST_MIN_MS = 1e-3
HIST_RATIO = 2.0 ** 0.25
_HIST_LOG_RATIO = math.log(HIST_RATIO)
HIST_BUCKETS = 200


def hist_bucket(v: float) -> int:
    """Bucket index for a millisecond value (extremes well-defined:
    zero/negative -> 0, sub-floor -> 1, huge -> last bucket)."""
    if v <= 0.0:
        return 0
    if v <= HIST_MIN_MS:
        return 1
    b = 2 + int(math.log(v / HIST_MIN_MS) / _HIST_LOG_RATIO)
    return b if b < HIST_BUCKETS else HIST_BUCKETS - 1


def hist_bucket_upper(i: int) -> float:
    """Inclusive upper bound (ms) of bucket `i`."""
    if i <= 0:
        return 0.0
    if i == 1:
        return HIST_MIN_MS
    return HIST_MIN_MS * HIST_RATIO ** (i - 1)


def hist_percentile(buckets, count: int, q: float) -> float:
    """The q-quantile read off bucket counts: the upper bound of the
    bucket where the cumulative count crosses rank ceil(q * count).
    `buckets` is either a dense count list (flight recorder) or a
    sparse {bucket_index: count} dict (inmem samples) — one rank-walk
    serves both so the two surfaces cannot drift. Returns 0.0 on an
    empty histogram."""
    if count <= 0:
        return 0.0
    rank = max(1, math.ceil(q * count))
    items = (sorted(buckets.items()) if isinstance(buckets, dict)
             else enumerate(buckets))
    cum = 0
    last = 0
    for i, c in items:
        cum += c
        last = i
        if cum >= rank:
            return hist_bucket_upper(i)
    return hist_bucket_upper(last)


# Record-path manifest, kept as data (the JAX package's linter walks
# the same names there): observe is
# the leaf every flight-recorder span and every profiler lock/runq/GIL
# record lands in — arithmetic + preallocated-subscript writes only.
NTA_RECORD_PATH = ("LatencyHist.observe",)


class LatencyHist:
    """Fixed-size log-bucketed latency histogram (milliseconds) over
    the shared ladder above. The ONE histogram implementation the
    flight recorder (trace/recorder.py) and the contention observatory
    (profile/) both store into, so their percentiles can
    never diverge from the ladder or from each other."""

    __slots__ = ("count", "total", "max", "buckets")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.max = 0.0
        self.buckets = [0] * HIST_BUCKETS

    def observe(self, ms: float) -> None:
        self.count += 1
        self.total += ms
        if ms > self.max:
            self.max = ms
        self.buckets[hist_bucket(ms)] += 1


class _Interval:
    __slots__ = ("start", "counters", "gauges", "samples")

    def __init__(self, start: float):
        self.start = start
        self.counters: Dict[str, List[float]] = defaultdict(lambda: [0, 0.0])  # count, sum
        self.gauges: Dict[str, float] = {}
        # count, sum, min, max, {bucket: count} (log-bucketed, so
        # p50/p95/p99 are recoverable from any interval snapshot —
        # count/sum/min/max alone cannot reconstruct a percentile).
        self.samples: Dict[str, list] = defaultdict(
            lambda: [0, 0.0, float("inf"), float("-inf"), {}]
        )


class InmemSink:
    """Ring of aggregation intervals (go-metrics inmem.go analog)."""

    def __init__(self, interval: float = 10.0, retain: int = 60):
        self.interval = interval
        self.retain = retain
        self._lock = threading.Lock()
        self._intervals: List[_Interval] = [_Interval(time.time())]
        # Lifetime aggregates, never rotated: the Prometheus surface
        # reads THESE — counters and histogram buckets exposed from the
        # rolling intervals would DECREASE as old intervals rotate out,
        # and every decrease reads as a counter reset to rate().
        self._life = _Interval(time.time())

    def _current(self) -> _Interval:
        now = time.time()
        cur = self._intervals[-1]
        if now - cur.start >= self.interval:
            cur = _Interval(now)
            self._intervals.append(cur)
            if len(self._intervals) > self.retain:
                del self._intervals[: len(self._intervals) - self.retain]
        return cur

    def incr_counter(self, name: str, n: float) -> None:
        with self._lock:
            for c in (self._current().counters[name],
                      self._life.counters[name]):
                c[0] += 1
                c[1] += n

    def set_gauge(self, name: str, v: float) -> None:
        with self._lock:
            self._current().gauges[name] = v
            self._life.gauges[name] = v

    def add_sample(self, name: str, v: float) -> None:
        b = hist_bucket(v)
        with self._lock:
            for s in (self._current().samples[name],
                      self._life.samples[name]):
                s[0] += 1
                s[1] += v
                s[2] = min(s[2], v)
                s[3] = max(s[3], v)
                s[4][b] = s[4].get(b, 0) + 1

    @staticmethod
    def _sample_dict(v: list) -> dict:
        count = v[0]
        return {
            "count": count,
            "sum": v[1],
            "min": v[2] if count else 0.0,
            "max": v[3] if count else 0.0,
            "mean": (v[1] / count) if count else 0.0,
            "p50": hist_percentile(v[4], count, 0.50),
            "p95": hist_percentile(v[4], count, 0.95),
            "p99": hist_percentile(v[4], count, 0.99),
        }

    def snapshot(self, intervals: int = 2) -> List[dict]:
        """The most recent aggregation intervals, newest last."""
        with self._lock:
            out = []
            for iv in self._intervals[-intervals:]:
                out.append({
                    "start": iv.start,
                    "counters": {
                        k: {"count": v[0], "sum": v[1]} for k, v in iv.counters.items()
                    },
                    "gauges": dict(iv.gauges),
                    "samples": {
                        k: self._sample_dict(v)
                        for k, v in iv.samples.items()
                    },
                })
            return out

    def merged(self) -> dict:
        """The LIFETIME aggregates (never rotated) — the Prometheus
        exposition source. Exposing the rolling intervals instead would
        make _total/_count/_bucket values decrease as intervals rotate
        out, which rate()/increase() read as counter resets."""
        with self._lock:
            return {
                "counters": {k: list(v)
                             for k, v in self._life.counters.items()},
                "gauges": dict(self._life.gauges),
                "samples": {
                    k: [v[0], v[1], v[2], v[3], dict(v[4])]
                    for k, v in self._life.samples.items()
                },
            }


class StatsdSink:
    """Plain UDP statsd datagrams (`name:value|type`)."""

    def __init__(self, addr: str):
        host, _, port = addr.partition(":")
        self._addr = (host or "127.0.0.1", int(port or 8125))
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)

    def _send(self, payload: str) -> None:
        try:
            self._sock.sendto(payload.encode(), self._addr)
        except OSError:
            pass  # telemetry must never take the agent down

    def incr_counter(self, name: str, n: float) -> None:
        self._send(f"{name}:{n}|c")

    def set_gauge(self, name: str, v: float) -> None:
        self._send(f"{name}:{v}|g")

    def add_sample(self, name: str, v: float) -> None:
        self._send(f"{name}:{v}|ms")


class StatsiteSink:
    """Statsite speaks the statsd line protocol over a persistent TCP
    stream (go-metrics statsite.go). Reconnects lazily; telemetry
    errors never propagate."""

    def __init__(self, addr: str, timeout: float = 3.0):
        host, _, port = addr.partition(":")
        self._addr = (host or "127.0.0.1", int(port or 8125))
        self._timeout = timeout
        self._sock: Optional[socket.socket] = None
        self._lock = threading.Lock()

    def _send(self, payload: str) -> None:
        with self._lock:
            try:
                if self._sock is None:
                    self._sock = socket.create_connection(
                        self._addr, timeout=self._timeout)
                self._sock.sendall((payload + "\n").encode())
            except OSError:
                if self._sock is not None:
                    try:
                        self._sock.close()
                    except OSError:
                        pass
                    self._sock = None

    def incr_counter(self, name: str, n: float) -> None:
        self._send(f"{name}:{n}|c")

    def set_gauge(self, name: str, v: float) -> None:
        self._send(f"{name}:{v}|g")

    def add_sample(self, name: str, v: float) -> None:
        self._send(f"{name}:{v}|ms")

    def close(self) -> None:
        with self._lock:
            if self._sock is not None:
                try:
                    self._sock.close()
                except OSError:
                    pass
                self._sock = None


class CirconusSink:
    """Circonus httptrap submission (command.go:628-651 wires
    circonus-gometrics): metrics buffer locally and flush as one JSON
    document to the check's submission URL on an interval. Numeric
    gauges/counters/samples submit as numeric values;
    a failed flush drops the batch (telemetry must never block)."""

    def __init__(self, submission_url: str, flush_interval: float = 10.0):
        self.url = submission_url
        self.flush_interval = flush_interval
        self._lock = threading.Lock()
        self._pending: Dict[str, float] = {}
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="circonus-flush")
        self._thread.start()

    def _record(self, name: str, value: float) -> None:
        with self._lock:
            self._pending[name] = value

    def incr_counter(self, name: str, value: float) -> None:
        # Counters ACCUMULATE within a flush window (circonus-gometrics
        # does the same); only gauges/samples are last-write-wins.
        with self._lock:
            self._pending[name] = self._pending.get(name, 0.0) + value

    set_gauge = _record
    add_sample = _record

    def _run(self) -> None:
        while not self._stop.wait(self.flush_interval):
            self.flush()

    def flush(self) -> None:
        import json as _json
        import urllib.request

        with self._lock:
            if not self._pending:
                return
            batch, self._pending = self._pending, {}
        body = _json.dumps({k: {"_type": "n", "_value": v}
                            for k, v in batch.items()}).encode()
        req = urllib.request.Request(
            self.url, data=body, method="PUT",
            headers={"Content-Type": "application/json"})
        try:
            urllib.request.urlopen(req, timeout=5.0).read()
        except Exception:  # noqa: BLE001 - telemetry drops, never blocks
            pass

    def close(self) -> None:
        self._stop.set()
        self.flush()  # don't drop the final interval's metrics


class Metrics:
    """Fanout front-end; the module-global instance is what call sites
    use (go-metrics global metrics object)."""

    def __init__(self, prefix: str = "nomad_tpu", hostname: str = ""):
        self.prefix = prefix
        # go-metrics tags gauges with the hostname unless
        # disable_hostname is set (command.go:582-585).
        self.hostname = hostname
        self.inmem = InmemSink()
        self._sinks: List[object] = [self.inmem]
        self._statsd_addrs: set = set()

    def add_sink(self, sink) -> None:
        self._sinks.append(sink)

    def add_statsd(self, addr: str) -> None:
        """Attach a statsd sink once per address (servers and the CLI
        may both request the same target)."""
        if addr in self._statsd_addrs:
            return
        self._statsd_addrs.add(addr)
        self.add_sink(StatsdSink(addr))

    def _name(self, parts, tag_host: bool = False) -> str:
        head = (f"{self.prefix}.{self.hostname}"
                if tag_host and self.hostname else self.prefix)
        if isinstance(parts, str):
            return f"{head}.{parts}"
        return ".".join([head, *parts])

    def incr_counter(self, parts, n: float = 1) -> None:
        name = self._name(parts)
        for s in self._sinks:
            s.incr_counter(name, n)

    def set_gauge(self, parts, v: float) -> None:
        # Only gauges carry the hostname (go-metrics SetGauge applies
        # HostName; counters/samples stay cluster-aggregatable).
        name = self._name(parts, tag_host=True)
        for s in self._sinks:
            s.set_gauge(name, v)

    def add_sample(self, parts, v: float) -> None:
        name = self._name(parts)
        for s in self._sinks:
            s.add_sample(name, v)

    def measure_since(self, parts, start: float) -> None:
        """Record elapsed milliseconds since `start` (time.monotonic)."""
        self.add_sample(parts, (time.monotonic() - start) * 1000.0)

    def snapshot(self) -> List[dict]:
        return self.inmem.snapshot()


_global = Metrics()


def get_metrics() -> Metrics:
    return _global


def configure(prefix: Optional[str] = None, statsd_addr: Optional[str] = None,
              statsite_addr: Optional[str] = None,
              disable_hostname: bool = True,
              interval: Optional[float] = None,
              circonus_url: Optional[str] = None) -> Metrics:
    """Re-init the global registry from agent telemetry config
    (command.go:570 setupTelemetry): inmem sink always; statsd (UDP),
    statsite (TCP), and circonus (httptrap) fanout when configured;
    hostname tagging unless disabled."""
    import socket as _socket

    global _global
    hostname = "" if disable_hostname else _socket.gethostname()
    m = Metrics(prefix or "nomad_tpu", hostname=hostname)
    if interval:
        m.inmem.interval = interval
    if statsd_addr:
        m.add_statsd(statsd_addr)
    if statsite_addr:
        m.add_sink(StatsiteSink(statsite_addr))
    if circonus_url:
        m.add_sink(CirconusSink(circonus_url))
    # Swap FIRST, then release the old sinks off-thread: emitters racing
    # the swap can't resurrect a closed statsite socket, and a final
    # circonus flush to a blackholed URL (5s timeout) can't stall the
    # reconfigure caller.
    old = _global
    _global = m
    old_sinks = getattr(old, "_sinks", [])
    if any(getattr(s, "close", None) for s in old_sinks):
        def _release(sinks=old_sinks):
            for sink in sinks:
                closer = getattr(sink, "close", None)
                if closer is not None:
                    try:
                        closer()
                    except Exception:  # noqa: BLE001
                        pass

        threading.Thread(target=_release, daemon=True,
                         name="metrics-release").start()
    return m


def format_snapshot(snapshot: List[dict]) -> str:
    """Human-readable dump of inmem intervals (go-metrics InmemSignal
    output shape)."""
    lines = []
    for iv in snapshot:
        stamp = time.strftime("%Y-%m-%d %H:%M:%S", time.localtime(iv["start"]))
        lines.append(f"[{stamp}]")
        for name, c in sorted(iv["counters"].items()):
            lines.append(f"  counter {name}: count={c['count']} sum={c['sum']:g}")
        for name, v in sorted(iv["gauges"].items()):
            lines.append(f"  gauge {name}: {v:g}")
        for name, s in sorted(iv["samples"].items()):
            lines.append(
                f"  sample {name}: count={s['count']} mean={s['mean']:.3f} "
                f"min={s['min']:.3f} max={s['max']:.3f}")
    return "\n".join(lines)


def install_signal_dump(signum: Optional[int] = None) -> None:
    """SIGUSR1 dumps the recent telemetry intervals to stderr
    (command.go in-memory sink + InmemSignal). Main thread only."""
    import signal
    import sys

    signum = signum or signal.SIGUSR1

    def dump(_sig, _frame):
        print(format_snapshot(_global.snapshot()), file=sys.stderr)

    signal.signal(signum, dump)


_PROM_BAD = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str) -> str:
    out = _PROM_BAD.sub("_", name)
    if out and out[0].isdigit():
        out = "_" + out
    return out


def _prom_num(v: float) -> str:
    # Integral values print as integers (the common case for counts);
    # everything else as repr floats — both are valid exposition.
    # Non-finite values must spell the exposition tokens exactly
    # (Go's ParseFloat accepts "+Inf"/"-Inf"/"NaN", not Python's
    # repr "inf"/"nan" — and int(nan) raises outright).
    f = float(v)
    if f != f:
        return "NaN"
    if f == float("inf"):
        return "+Inf"
    if f == float("-inf"):
        return "-Inf"
    if f == int(f):
        return str(int(f))
    return repr(f)


def _prom_escape(v: str) -> str:
    """Label-value escaping per the exposition format."""
    return (v.replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def emit_histogram_family(lines: List[str], name: str, help_text: str,
                          series: dict, label: str = "site") -> None:
    """Append ONE 0.0.4 histogram family to `lines`: HELP/TYPE, then
    per series cumulative le-ordered buckets ending in +Inf, _sum and
    _count. `series` maps a label value ("" = unlabelled) to
    ``(count, total, buckets)`` where buckets is a dense count list or
    a sparse {bucket_index: count} dict over the shared ladder. The
    single histogram emitter for the registry AND the contention
    observatory (profile/), so a conformance fix can never
    apply to one half of the exposition only."""
    if not series:
        return
    lines.append(f"# HELP {name} {help_text}")
    lines.append(f"# TYPE {name} histogram")
    for key in sorted(series):
        count, total, buckets = series[key]
        lbl = f'{label}="{_prom_escape(key)}",' if key else ""
        items = (sorted(buckets.items()) if isinstance(buckets, dict)
                 else enumerate(buckets))
        cum = 0
        for b, c in items:
            if not c:
                continue
            cum += c
            lines.append(
                f'{name}_bucket{{{lbl}le="{hist_bucket_upper(b):g}"}} '
                f"{cum}")
        lines.append(f'{name}_bucket{{{lbl}le="+Inf"}} {count}')
        tail = f"{{{lbl[:-1]}}}" if lbl else ""
        lines.append(f"{name}_sum{tail} {_prom_num(total)}")
        lines.append(f"{name}_count{tail} {count}")


def format_prometheus(metrics: Optional[Metrics] = None) -> str:
    """Prometheus text exposition (format 0.0.4) of the inmem sink,
    aggregated across every retained interval: counters as counters,
    gauges as gauges, timing samples as histograms over the shared
    log-bucket ladder (values are MILLISECONDS — measure_since's unit —
    stated in each HELP line)."""
    m = metrics or _global
    merged = m.inmem.merged()
    lines: List[str] = []
    # Family names must be unique across the whole exposition: two raw
    # names can sanitize to one prom name ("a.b" and "a_b"), and a
    # duplicate TYPE block is a parse error for every scraper. First
    # (sorted) name wins; later collisions are skipped, not emitted
    # twice.
    seen: set = set()

    def _family(p: str) -> bool:
        if p in seen:
            return False
        seen.add(p)
        return True

    for name in sorted(merged["counters"]):
        v = merged["counters"][name]
        p = _prom_name(name)
        if not _family(f"{p}_total"):
            continue
        lines.append(f"# HELP {p}_total aggregated counter {name}")
        lines.append(f"# TYPE {p}_total counter")
        lines.append(f"{p}_total {_prom_num(v[1])}")
    for name in sorted(merged["gauges"]):
        p = _prom_name(name)
        if not _family(p):
            continue
        lines.append(f"# HELP {p} gauge {name}")
        lines.append(f"# TYPE {p} gauge")
        lines.append(f"{p} {_prom_num(merged['gauges'][name])}")
    for name in sorted(merged["samples"]):
        v = merged["samples"][name]
        p = _prom_name(name)
        if not _family(p):
            continue
        emit_histogram_family(
            lines, p, f"timing sample {name} (milliseconds)",
            {"": (v[0], v[1], v[4])})
    return "\n".join(lines) + "\n"


def incr_counter(parts, n: float = 1) -> None:
    _global.incr_counter(parts, n)


def set_gauge(parts, v: float) -> None:
    _global.set_gauge(parts, v)


def add_sample(parts, v: float) -> None:
    _global.add_sample(parts, v)


def measure_since(parts, start: float) -> None:
    _global.measure_since(parts, start)
