"""Data model for nomad_tpu (reference: nomad/structs/)."""

from . import consts
from .alloc import VaultAccessor
from .alloc import (
    AllocMetric,
    Allocation,
    TaskEvent,
    TaskState,
    filter_terminal_allocs,
    new_task_event,
    remove_allocs,
)
from .bitmap import Bitmap
from .eval import Evaluation, new_eval
from .funcs import allocs_fit, score_fit
from .job import (
    Constraint,
    DispatchPayloadConfig,
    EphemeralDisk,
    Gang,
    Job,
    JobSummary,
    LogConfig,
    PeriodicConfig,
    RestartPolicy,
    Service,
    ServiceCheck,
    Task,
    TaskArtifact,
    TaskGroup,
    TaskGroupSummary,
    Template,
    UpdateStrategy,
    Vault,
    default_batch_restart_policy,
    default_service_restart_policy,
)
from .network import NetworkIndex
from .node import (
    Node,
    escaped_constraints,
    is_unique_namespace,
    unique_namespace,
)
from .plan import DesiredUpdates, Plan, PlanAnnotations, PlanResult
from .resources import NetworkResource, Port, Resources

__all__ = [
    "consts",
    "AllocMetric",
    "Allocation",
    "TaskEvent",
    "TaskState",
    "filter_terminal_allocs",
    "new_task_event",
    "remove_allocs",
    "Bitmap",
    "Evaluation",
    "new_eval",
    "allocs_fit",
    "score_fit",
    "Constraint",
    "DispatchPayloadConfig",
    "EphemeralDisk",
    "Gang",
    "Job",
    "JobSummary",
    "LogConfig",
    "PeriodicConfig",
    "RestartPolicy",
    "Service",
    "ServiceCheck",
    "Task",
    "TaskArtifact",
    "TaskGroup",
    "TaskGroupSummary",
    "Template",
    "UpdateStrategy",
    "Vault",
    "default_batch_restart_policy",
    "default_service_restart_policy",
    "NetworkIndex",
    "Node",
    "escaped_constraints",
    "is_unique_namespace",
    "unique_namespace",
    "DesiredUpdates",
    "Plan",
    "PlanAnnotations",
    "PlanResult",
    "NetworkResource",
    "Port",
    "Resources",
]
