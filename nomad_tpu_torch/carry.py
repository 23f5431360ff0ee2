"""Carry the JAX package's state across to the port.

A scheduler has no weights: what it plans against is the cluster
state and the dense arrays built from it. These functions take that
state as the JAX package produces it — plain dicts
(``StateStore.persist()``, whose records are ``utils.codec.to_dict``
output) and host numpy arrays (``NodeState``, ``Asks``,
``CompactOverlay``, ``VictimState``, ``GangState``) — and rebuild it
in the port, so the same inputs can go through both packages. The
defrag solver's warm start crosses the same way: the carried iterate
is a key and a dict of numpy logits rows.

Nothing here imports the JAX package: the caller hands over plain data.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .ops.binpack import Asks, CompactOverlay, NodeState
from .ops.gang import GangState
from .ops.preempt import VictimState
from .state import StateStore


def state_from_reference(dicts: Mapping) -> StateStore:
    """The port's StateStore from the JAX package's persisted store
    (nodes, jobs, job summaries, allocs, evals and table indexes as
    plain dicts), loaded with the port's own ``from_dict``."""
    return StateStore.restore(dict(dicts))


def _tensors(cls, arrays, device):
    return cls(*(torch.from_numpy(np.array(x, copy=True)).to(device)
                 for x in arrays))


def node_state_from_numpy(state, device) -> NodeState:
    """A NodeState of host numpy arrays (the JAX package's
    make_node_state output) as the port's tensors on ``device``."""
    return _tensors(NodeState, state, device)


def asks_from_numpy(asks, device) -> Asks:
    """An Asks of host numpy arrays as the port's tensors."""
    return _tensors(Asks, asks, device)


def overlay_from_numpy(overlay, device) -> CompactOverlay:
    """A CompactOverlay of host numpy arrays as the port's tensors."""
    return _tensors(CompactOverlay, overlay, device)


def victim_state_from_numpy(victims, device) -> VictimState:
    """A VictimState of host numpy arrays (the JAX package's
    make_victim_state output) as the port's tensors."""
    return _tensors(VictimState, victims, device)


def gang_state_from_numpy(state, device) -> GangState:
    """A GangState of host numpy arrays (the JAX package's
    make_gang_state output) as the port's tensors."""
    return _tensors(GangState, state, device)


def warm_state_from_numpy(key, logits: Mapping[str, np.ndarray]):
    """The defrag solver's WarmState from the JAX package's carried
    iterate (its WarmState ``key`` and ``logits`` {alloc id: [W] f32}),
    so both solvers can start a warm round from the same logits."""
    from .defrag.solver import WarmState

    warm = WarmState()
    warm.store(key, {alloc_id: np.array(row, np.float32, copy=True)
                     for alloc_id, row in logits.items()})
    return warm
