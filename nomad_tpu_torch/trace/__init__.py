"""Eval-lifecycle tracing: flight-recorder spans with p99 stage
attribution (the port of the JAX package's trace/).

Every evaluation yields a span tree recorded into a bounded
lock-striped ring buffer (recorder.py). The port's scheduler path
records matrix.build / matrix.update / matrix.compress /
device.dispatch (scheduler/tpu.py), device.solve (scheduler/batcher.py),
gang.select, preempt.select and migrate.place; the broker, pipeline,
plan and FSM stages of span.py come with those modules. Read back
through ``get_recorder()``: ``traces()`` / ``trace_for(eval_id)`` for
the span trees (after ``complete(eval_id)``), ``stage_stats()`` for
the per-stage p50/p95/p99 table.

Call sites use the module-level helpers below against the process-wide
recorder; all of them are no-ops when the recorder is disabled and
never raise into the instrumented path.
"""

from .recorder import FlightRecorder  # noqa: F401
from .span import (  # noqa: F401
    ALL_STAGES,
    LIFECYCLE_CORE_STAGES,
    STAGE_ALLOC_UPSERT,
    STAGE_BROKER_WAIT,
    STAGE_DEFRAG_SOLVE,
    STAGE_DEVICE_DISPATCH,
    STAGE_DEVICE_SOLVE,
    STAGE_DEVICE_TRANSFER,
    STAGE_DISPATCH_ACCUMULATE,
    STAGE_DISPATCH_LAUNCH,
    STAGE_GANG_SELECT,
    STAGE_MATRIX_BUILD,
    STAGE_MATRIX_COMPRESS,
    STAGE_MATRIX_UPDATE,
    STAGE_MIGRATE_PLACE,
    STAGE_PLAN_COMMIT,
    STAGE_PLAN_EVALUATE,
    STAGE_PLAN_SUBMIT,
    STAGE_PREEMPT_SELECT,
    STAGE_SCHED_PROCESS,
)

# The process-wide recorder every instrumentation site uses. Module
# level so the disabled check is two attribute loads + a branch (the
# same shape as profile._profiler).
_recorder = FlightRecorder()


def get_recorder() -> FlightRecorder:
    return _recorder


def mark(eval_id: str, trace_id: str = "") -> None:
    _recorder.mark(eval_id, trace_id)


def record_since_mark(eval_id: str, stage: str, ann=None) -> None:
    _recorder.record_since_mark(eval_id, stage, ann)


def record_span(eval_id: str, stage: str, t0: float, t1=None, ann=None,
                trace_id: str = "", create: bool = True) -> None:
    _recorder.record_span(eval_id, stage, t0, t1, ann, trace_id, create)


def annotate_fault(eval_id: str, site: str, seq: int, kind: str) -> None:
    _recorder.annotate_fault(eval_id, site, seq, kind)


def complete(eval_id: str, status: str = "complete") -> None:
    _recorder.complete(eval_id, status)
