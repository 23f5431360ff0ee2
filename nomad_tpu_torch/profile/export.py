"""Chrome trace-event (Perfetto-loadable) export.

Merges flight-recorder span trees (trace/) with the
profiler's pipeline timeline and completed convoys into one JSON
object in the Trace Event Format — the ``{"traceEvents": [...]}``
shape chrome://tracing and https://ui.perfetto.dev load directly.

Mapping:

- each EVAL is a track (``tid``): one ``M`` thread_name metadata event
  naming it, then one ``X`` (complete) event per span — ``ts`` is
  absolute wall-clock microseconds (trace ``start_unix`` + the span's
  relative offset), ``dur`` the span length. Annotations and fault
  attributions ride in ``args``.
- the PIPELINE timeline rides track 0 as ``i`` (instant) events —
  accumulate open/close, launch, submit, ack, prefetch, park/unpark.
- completed CONVOYS ride a dedicated track as ``X`` events named by
  their width, so the pile-up interval is visible under the eval spans
  that caused it.

Timeline event tuples carry both monotonic and wall stamps
(timeline.py); the export uses the wall stamp so every event source
shares one absolute axis.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional

PID = 1
TID_PIPELINE = 0
TID_CONVOYS = 1
TID_EVAL_BASE = 10  # eval tracks start here; 0/1 are system tracks


def _span_args(span: dict) -> dict:
    args = {}
    if span.get("annotations"):
        args.update(span["annotations"])
    if span.get("faults"):
        args["faults"] = span["faults"]
    if span.get("parent"):
        args["parent"] = span["parent"]
    return args


def trace_events(traces: Iterable[dict],
                 timeline: Optional[Iterable[tuple]] = None,
                 convoys: Optional[Iterable[dict]] = None) -> List[dict]:
    """The flat traceEvents list. ``traces`` are recorder dicts
    (recorder.py _finalize_locked shape), deduped by eval_id with the
    first occurrence winning (callers pass tail-kept traces first when
    they want the outliers to survive the dedup)."""
    events: List[dict] = [
        {"ph": "M", "pid": PID, "tid": TID_PIPELINE, "name": "thread_name",
         "args": {"name": "pipeline timeline"}},
        {"ph": "M", "pid": PID, "tid": TID_CONVOYS, "name": "thread_name",
         "args": {"name": "convoys (parked-thread pile-ups)"}},
    ]
    seen: Dict[str, int] = {}
    tid = TID_EVAL_BASE
    for trace in traces:
        eval_id = trace.get("eval_id", "")
        if not eval_id or eval_id in seen:
            continue
        seen[eval_id] = tid
        base_us = trace["start_unix"] * 1e6
        label = f"eval {eval_id[:12]} [{trace.get('status', '?')}]"
        if trace.get("tail_kept"):
            label += " (tail)"
        events.append({"ph": "M", "pid": PID, "tid": tid,
                       "name": "thread_name", "args": {"name": label}})
        for span in trace.get("spans", ()):
            events.append({
                "ph": "X", "pid": PID, "tid": tid, "cat": "eval",
                "name": span["name"],
                "ts": base_us + span["start_ms"] * 1e3,
                "dur": max(0.0, span["duration_ms"] * 1e3),
                "args": _span_args(span),
            })
        tid += 1
    for evt in timeline or ():
        _t_mono, wall, kind, thread, a, b = evt
        events.append({
            "ph": "i", "s": "t", "pid": PID, "tid": TID_PIPELINE,
            "cat": "pipeline", "name": kind, "ts": wall * 1e6,
            "args": {"thread": thread, "a": a, "b": b},
        })
    for convoy in convoys or ():
        events.append({
            "ph": "X", "pid": PID, "tid": TID_CONVOYS, "cat": "convoy",
            "name": f"convoy width={convoy['width']}",
            "ts": convoy["start_unix"] * 1e6,
            "dur": max(0.0, convoy["duration_ms"] * 1e3),
            "args": {"width": convoy["width"],
                     "site": convoy.get("site", "")},
        })
    return events


def chrome_trace(traces: Iterable[dict],
                 timeline: Optional[Iterable[tuple]] = None,
                 convoys: Optional[Iterable[dict]] = None) -> dict:
    """The full Perfetto-loadable document."""
    return {
        "traceEvents": trace_events(traces, timeline, convoys),
        "displayTimeUnit": "ms",
        "otherData": {"source": "nomad_tpu contention observatory"},
    }


def validate_chrome_trace(doc: dict) -> List[str]:
    """Schema check for the export (the round-trip test and traceconv
    --validate both run this): returns a list of violations, empty when
    the document is loadable. Checks the fields Perfetto's importer
    actually requires, not a full spec."""
    errors: List[str] = []
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        return ["document is not an object with a traceEvents list"]
    events = doc["traceEvents"]
    if not isinstance(events, list):
        return ["traceEvents is not a list"]
    for i, e in enumerate(events):
        where = f"traceEvents[{i}]"
        if not isinstance(e, dict):
            errors.append(f"{where}: not an object")
            continue
        ph = e.get("ph")
        if ph not in ("X", "M", "i", "b", "e"):
            errors.append(f"{where}: bad ph {ph!r}")
            continue
        if not isinstance(e.get("name"), str) or not e["name"]:
            errors.append(f"{where}: missing name")
        if not isinstance(e.get("pid"), int):
            errors.append(f"{where}: missing integer pid")
        if not isinstance(e.get("tid"), int):
            errors.append(f"{where}: missing integer tid")
        if ph == "M":
            if e.get("name") == "thread_name" and not (
                    isinstance(e.get("args"), dict)
                    and isinstance(e["args"].get("name"), str)):
                errors.append(f"{where}: thread_name without args.name")
            continue
        ts = e.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            errors.append(f"{where}: bad ts {ts!r}")
        if ph == "X":
            dur = e.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                errors.append(f"{where}: bad dur {dur!r}")
        if ph == "i" and e.get("s") not in ("t", "p", "g"):
            errors.append(f"{where}: instant without scope s")
        if "args" in e and not isinstance(e["args"], dict):
            errors.append(f"{where}: args not an object")
    return errors
