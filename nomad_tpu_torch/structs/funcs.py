"""Placement fit and scoring primitives — the kernel the TPU path
vectorizes.

Reference: nomad/structs/funcs.go:60 (AllocsFit), :123 (ScoreFit,
Google BestFit-v3).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from .alloc import Allocation
from .network import NetworkIndex
from .node import Node
from .resources import Resources


def allocs_fit(
    node: Node,
    allocs: List[Allocation],
    net_idx: Optional[NetworkIndex] = None,
) -> Tuple[bool, str, Resources]:
    """Whether the set of allocs (plus the node's reserved resources) fits
    on the node. Returns (fit, exhausted-dimension, utilization)."""
    used = Resources()
    if node.reserved:
        used.add(node.reserved)

    for alloc in allocs:
        if alloc.resources is not None:
            used.add(alloc.resources)
        elif alloc.task_resources:
            # Plan allocs carry the combined resources stripped; sum the
            # shared ask plus each task's resources (funcs.go:77-90).
            used.add(alloc.shared_resources)
            for task_res in alloc.task_resources.values():
                used.add(task_res)
        else:
            raise ValueError(f"allocation {alloc.id!r} has no resources set")

    ok, dimension = node.resources.superset(used)
    if not ok:
        return False, dimension, used

    if net_idx is None:
        net_idx = NetworkIndex()
        if net_idx.set_node(node) or net_idx.add_allocs(allocs):
            return False, "reserved port collision", used

    if net_idx.overcommitted():
        return False, "bandwidth exceeded", used

    return True, "", used


def score_fit(node: Node, util: Resources) -> float:
    """BestFit-v3: 20 - (10^free_cpu_frac + 10^free_mem_frac), clamped to
    [0, 18]. Packed nodes score high; empty nodes score 0.

    Note: util (from allocs_fit) includes node.reserved while the
    denominator subtracts it — reference parity (funcs.go:123-131 does
    the same), so reserved-heavy nodes score as partially packed."""
    node_cpu = float(node.resources.cpu)
    node_mem = float(node.resources.memory_mb)
    if node.reserved:
        node_cpu -= node.reserved.cpu
        node_mem -= node.reserved.memory_mb
    if node_cpu <= 0 or node_mem <= 0:
        # Fully-reserved node: nothing schedulable, worst score.
        return 0.0

    free_pct_cpu = 1.0 - (util.cpu / node_cpu)
    free_pct_mem = 1.0 - (util.memory_mb / node_mem)
    total = 10.0**free_pct_cpu + 10.0**free_pct_mem
    score = 20.0 - total
    return max(0.0, min(18.0, score))
