"""Span model for eval-lifecycle tracing.

A *span* is one named stage of one evaluation's life, with monotonic
start/end timestamps and optional annotations. The full set of stage
names an eval can produce is enumerated here so the e2e completeness
test (and the README table) have one source of truth.

Spans are stored as plain immutable tuples — ``(name, t0, t1, ann)`` —
so a reader racing the flight recorder can never observe a torn span:
the tuple is fully constructed before it is published into a ring slot.
"""

from __future__ import annotations

from typing import Optional, Tuple

# ------------------------------------------------------- stage names
#
# Ordered roughly by lifecycle position. Not every eval produces every
# stage: host-path evals skip the dense stages, placement-less evals
# (job stop) skip fsm.alloc_upsert, and dispatch.* only appear when the
# central pipeline handles the eval.

STAGE_BROKER_WAIT = "broker.wait"          # enqueue -> dequeue
STAGE_DISPATCH_ACCUMULATE = "dispatch.accumulate"  # pipeline admit -> batch cut
STAGE_DISPATCH_LAUNCH = "dispatch.launch"  # launch prologue (catch-up + snapshot)
STAGE_SCHED_PROCESS = "scheduler.process"  # scheduler invoke, end to end
STAGE_MATRIX_BUILD = "matrix.build"        # ClusterMatrix + ask construction
STAGE_MATRIX_UPDATE = "matrix.update"      # incremental delta vs full rebuild
STAGE_MATRIX_COMPRESS = "matrix.compress"  # signature-class interning
#   (models/classes.py; ann: classes C, nodes N, escaped, ratio N/C)
STAGE_DEVICE_TRANSFER = "device.transfer"  # base prefetch host->device
STAGE_DEVICE_DISPATCH = "device.dispatch"  # batcher.place round-trip
STAGE_DEVICE_SOLVE = "device.solve"        # the jitted placement-kernel
#   solve inside the dispatch (issue + device sync, kernel-annotated) —
#   device.dispatch minus batch-wait and host stacking
STAGE_MIGRATE_PLACE = "migrate.place"      # drain-displaced allocs staged
#   for re-placement under the migration budget (ann: migrations
#   claimed this wave, deferred to the follow-up eval)
STAGE_PREEMPT_SELECT = "preempt.select"    # dense victim-selection +
#   placement pass (ops/preempt.py; ann: asks, candidate victims)
STAGE_GANG_SELECT = "gang.select"          # all-K gang slice selection
#   + member assignment (ops/gang.py; ann: members, mode,
#   slice group, host_fallback) — one span per gang dispatch
#   (gang/)
STAGE_DEFRAG_SOLVE = "defrag.solve"        # one defrag-loop round's
#   warm-started global relaxation solve + move extraction
#   (defrag/; ann: movable, moves, gain, warm, solve_ms) —
#   recorded on its own per-round trace, not an eval's
STAGE_PLAN_SUBMIT = "plan.submit"          # plan queue wait + commit (worker view)
STAGE_PLAN_EVALUATE = "plan.evaluate"      # applier per-node verification
STAGE_PLAN_COMMIT = "plan.commit"          # raft apply of the accepted plan
STAGE_ALLOC_UPSERT = "fsm.alloc_upsert"    # state-store alloc write

ALL_STAGES = (
    STAGE_BROKER_WAIT,
    STAGE_DISPATCH_ACCUMULATE,
    STAGE_DISPATCH_LAUNCH,
    STAGE_SCHED_PROCESS,
    STAGE_MATRIX_BUILD,
    STAGE_MATRIX_UPDATE,
    STAGE_MATRIX_COMPRESS,
    STAGE_DEVICE_TRANSFER,
    STAGE_DEVICE_DISPATCH,
    STAGE_DEVICE_SOLVE,
    STAGE_MIGRATE_PLACE,
    STAGE_PREEMPT_SELECT,
    STAGE_GANG_SELECT,
    STAGE_DEFRAG_SOLVE,
    STAGE_PLAN_SUBMIT,
    STAGE_PLAN_EVALUATE,
    STAGE_PLAN_COMMIT,
    STAGE_ALLOC_UPSERT,
)

# The stages every PLACING eval must produce regardless of path (the
# e2e completeness contract; dense/dispatch stages are path-dependent).
LIFECYCLE_CORE_STAGES = (
    STAGE_BROKER_WAIT,
    STAGE_SCHED_PROCESS,
    STAGE_PLAN_SUBMIT,
    STAGE_PLAN_EVALUATE,
    STAGE_PLAN_COMMIT,
    STAGE_ALLOC_UPSERT,
)

# Span tuple layout: (stage_name, t0_monotonic, t1_monotonic, ann)
# where ann is None or a small read-only dict built by the caller.
Span = Tuple[str, float, float, Optional[dict]]


def make_span(name: str, t0: float, t1: float,
              ann: Optional[dict] = None) -> Span:
    if t1 < t0:  # clock users pass (start, now); never invert
        t1 = t0
    return (name, t0, t1, ann)


def span_to_dict(span: Span, origin: float, faults=()) -> dict:
    """JSON shape for one span. `origin` is the trace's monotonic start
    so exported offsets are relative (monotonic absolutes are
    process-meaningless). `faults` are the injected (site, ordinal, kind)
    triples whose firing time fell inside this span."""
    name, t0, t1, ann = span
    out = {
        "name": name,
        "start_ms": round((t0 - origin) * 1000.0, 3),
        "end_ms": round((t1 - origin) * 1000.0, 3),
        "duration_ms": round((t1 - t0) * 1000.0, 3),
    }
    if ann:
        out["annotations"] = dict(ann)
    if faults:
        out["faults"] = [
            {"site": site, "ordinal": seq, "kind": kind}
            for (_t, site, seq, kind) in faults
        ]
    return out
