"""Scheduler factories and interfaces.

Reference: scheduler/scheduler.go:13 (BuiltinSchedulers), :21
(NewScheduler), :44 (Scheduler iface), :77 (Planner iface).

The port's registry: "service", "batch" and "system" are the host
schedulers (the oracle); "service-gpu" and "batch-gpu" the dense
factories whose placements run on the device (scheduler/tpu.py) with
the process-global active placement kernel (nomad_tpu_torch/kernels
``configure``); for every registered kernel k, "service-k-gpu" and
"batch-k-gpu" pinned to that kernel (the seam the differential rig
selects kernels through); and "system-gpu" the system scheduler's
vectorized pass (scheduler/tpu.py DenseSystemScheduler, host numpy as
in the JAX package). The dense factories are registered lazily so
importing the scheduler package loads no device code.
"""

from __future__ import annotations

import functools
import random
from typing import Callable, Dict, Optional, Protocol, Tuple

from ..structs import Evaluation, Plan, PlanResult
from .generic import GenericScheduler
from .system import SystemScheduler


class Planner(Protocol):
    """What a scheduler needs from its host (the worker / harness)."""

    def submit_plan(self, plan: Plan) -> Tuple[PlanResult, Optional[object]]:
        """Submit a plan; returns (result, refreshed-state-or-None)."""
        ...

    def update_eval(self, eval: Evaluation) -> None: ...

    def create_eval(self, eval: Evaluation) -> None: ...

    def reblock_eval(self, eval: Evaluation) -> None: ...


SchedulerFactory = Callable[..., object]

_BUILTIN: Dict[str, SchedulerFactory] = {}


def register_scheduler(name: str, factory: SchedulerFactory) -> None:
    _BUILTIN[name] = factory


def scheduler_names():
    _register_gpu_factories()
    return sorted(_BUILTIN)


def new_scheduler(name: str, logger, state, planner,
                  rng: Optional[random.Random] = None):
    factory = _BUILTIN.get(name)
    if factory is None and name.endswith("-gpu"):
        _register_gpu_factories()
        factory = _BUILTIN.get(name)
    if factory is None:
        raise ValueError(f"unknown scheduler '{name}'")
    return factory(logger, state, planner, rng=rng)


register_scheduler(
    "service",
    lambda logger, state, planner, rng=None: GenericScheduler(
        logger, state, planner, batch=False, rng=rng
    ),
)
register_scheduler(
    "batch",
    lambda logger, state, planner, rng=None: GenericScheduler(
        logger, state, planner, batch=True, rng=rng
    ),
)
register_scheduler(
    "system",
    lambda logger, state, planner, rng=None: SystemScheduler(
        logger, state, planner, rng=rng
    ),
)


def _register_gpu_factories() -> None:
    """The dense factories: unpinned, one pinned pair per registered
    kernel (the JAX package's service-<k>-tpu, with the -gpu suffix),
    and system-gpu."""
    from ..kernels import kernel_names
    from .tpu import BatchedGPUScheduler, DenseSystemScheduler

    def pinned(kernel):
        def factory(logger, state, planner, rng=None, *, batch):
            return BatchedGPUScheduler(logger, state, planner, batch=batch,
                                       rng=rng, kernel=kernel)
        return factory

    for kernel in (None, *kernel_names()):
        infix = "" if kernel is None else f"{kernel}-"
        factory = pinned(kernel)
        register_scheduler(f"service-{infix}gpu",
                           functools.partial(factory, batch=False))
        register_scheduler(f"batch-{infix}gpu",
                           functools.partial(factory, batch=True))
    register_scheduler(
        "system-gpu",
        lambda logger, state, planner, rng=None: DenseSystemScheduler(
            logger, state, planner, rng=rng
        ),
    )


__all__ = [
    "GenericScheduler",
    "SystemScheduler",
    "Planner",
    "new_scheduler",
    "register_scheduler",
    "scheduler_names",
]
