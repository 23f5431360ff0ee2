"""Scheduler factories and interfaces.

Reference: scheduler/scheduler.go:13 (BuiltinSchedulers), :21
(NewScheduler), :44 (Scheduler iface), :77 (Planner iface).

The port's registry: "service" and "batch" are the host schedulers
(the oracle), "service-gpu" and "batch-gpu" the dense factories whose
placements run on the device (scheduler/tpu.py). The dense factories
are registered lazily so importing the scheduler package loads no
device code.
"""

from __future__ import annotations

import functools
import random
from typing import Callable, Dict, Optional, Protocol, Tuple

from ..structs import Evaluation, Plan, PlanResult
from .generic import GenericScheduler


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


def _register_gpu_factories() -> None:
    from .tpu import BatchedGPUScheduler

    def factory(logger, state, planner, rng=None, *, batch):
        return BatchedGPUScheduler(logger, state, planner, batch=batch,
                                   rng=rng)

    register_scheduler("service-gpu", functools.partial(factory, batch=False))
    register_scheduler("batch-gpu", functools.partial(factory, batch=True))


__all__ = [
    "GenericScheduler",
    "Planner",
    "new_scheduler",
    "register_scheduler",
    "scheduler_names",
]
