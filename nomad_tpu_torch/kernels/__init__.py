"""Pluggable dense placement kernels: the port of the JAX package's
kernels/__init__.py.

A *placement kernel* is the per-batch solve at the heart of the dense
scheduler, in the port's batched form (ops/binpack.py
``greedy_placement_program``):

    kernel(capacity, sched_capacity, util, bw_avail, bw_used,
           ports_free, node_ok, job_count, tg_count, feasible,
           asks, keys, config, seq=False)
        -> (choices [B,K] i32, scores [B,K] f32, carry)

``ops/binpack.py`` dispatches every batch layout (lone, independent,
sequential ``pre_resolve``, stacked) to the kernel named by
``PlacementConfig.kernel``. The name joins the batcher's shape key (the
config does), so kernels never share a dispatch; a kernel swaps only
HOW the solve is computed, never how batches form, how bases become
device-resident, or how plans commit.

Selection surfaces: ``configure(kernel)`` (the process-global active
kernel the plain ``service-gpu`` / ``batch-gpu`` factories use), and
the pinned factories ``service-<k>-gpu`` / ``batch-<k>-gpu`` that
scheduler/__init__.py registers for every kernel k here.

Built-ins: ``greedy`` (the native masked-argmax scan, K1/K2) and
``convex`` (kernels/convex.py: a convex relaxation solved by mirror
descent, K8a, then a feasibility-mask-respecting rounding scan, K8b).

Validity contract: a kernel may trade placement QUALITY, never
VALIDITY. The oracle differential rig (kernels/differential.py) runs
any registered kernel against the sequential host oracle; the quality
board (kernels/quality.py) measures the trade.

Importing this module loads no device code: kernel programs register
as lazy loaders, resolved on first dispatch.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List

# The kernel ops/binpack.py implements natively.
DEFAULT_KERNEL = "greedy"

# name -> zero-arg loader returning the kernel program. guarded-by: _LOCK
_LOADERS: Dict[str, Callable[[], Callable]] = {}
# name -> resolved program (memoized loads). guarded-by: _LOCK
_PROGRAMS: Dict[str, Callable] = {}
# Sorted names, swapped whole on registration so reads take no lock.
_NAMES: tuple = ()
_LOCK = threading.Lock()
# Process-global active kernel (configure). guarded-by: _LOCK
_ACTIVE = DEFAULT_KERNEL


def _load_greedy():
    from ..ops.binpack import greedy_placement_program

    return greedy_placement_program


def _load_convex():
    from .convex import convex_placement_program

    return convex_placement_program


def register_kernel(name: str, loader: Callable[[], Callable]) -> None:
    """Register a placement kernel under ``name``; ``loader`` returns
    its program on first dispatch. A registered kernel is selectable
    through ``configure`` and the ``service-<name>-gpu`` factories."""
    if not name or "-" in name:
        # Names embed into factory names ("service-<k>-gpu"); a dash
        # would make that mapping ambiguous.
        raise ValueError(
            f"invalid kernel name {name!r}: non-empty, no dashes")
    if name == DEFAULT_KERNEL and DEFAULT_KERNEL in _LOADERS:
        # ops/binpack.py runs the native scan for the default name
        # without consulting the registry: a replacement would never run.
        raise ValueError(
            f"the native {DEFAULT_KERNEL!r} kernel cannot be replaced; "
            f"register under a new name")
    global _NAMES
    with _LOCK:
        _LOADERS[name] = loader
        _PROGRAMS.pop(name, None)
        _NAMES = tuple(sorted(_LOADERS))


register_kernel(DEFAULT_KERNEL, _load_greedy)
register_kernel("convex", _load_convex)


def kernel_names() -> List[str]:
    return list(_NAMES)


def kernel_program(name: str) -> Callable:
    """Resolve a kernel name to its program, loading it on first use."""
    with _LOCK:
        prog = _PROGRAMS.get(name)
        loader = _LOADERS.get(name)
    if prog is not None:
        return prog
    if loader is None:
        raise ValueError(
            f"unknown placement kernel {name!r} "
            f"(registered: {', '.join(kernel_names())})")
    prog = loader()
    with _LOCK:
        _PROGRAMS[name] = prog
    return prog


def validate(kernel: str) -> None:
    """Raise ValueError unless ``kernel`` is registered."""
    if kernel not in _NAMES:
        raise ValueError(
            f"unknown placement kernel {kernel!r} "
            f"(registered: {', '.join(_NAMES)})")


def configure(kernel: str = None) -> None:
    """Set the process-global active kernel (the one the unpinned
    ``*-gpu`` factories use); None leaves it as it is."""
    global _ACTIVE
    if kernel is None:
        return
    validate(kernel)
    with _LOCK:
        _ACTIVE = kernel


def active_kernel() -> str:
    with _LOCK:
        return _ACTIVE


__all__ = [
    "DEFAULT_KERNEL",
    "active_kernel",
    "configure",
    "kernel_names",
    "kernel_program",
    "register_kernel",
    "validate",
]
