"""Node type and computed node class.

Reference: nomad/structs/structs.go:629 (Node),
nomad/structs/node_class.go:31 (ComputeClass — hash over Datacenter,
Attributes, Meta, NodeClass, excluding `unique.`-prefixed map keys).
"""

from __future__ import annotations

import copy
import hashlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from . import consts
from .job import Constraint
from .resources import Resources


@dataclass
class Node:
    id: str = ""
    secret_id: str = ""
    datacenter: str = ""
    name: str = ""
    http_addr: str = ""
    attributes: Dict[str, str] = field(default_factory=dict)
    resources: Optional[Resources] = None
    reserved: Optional[Resources] = None
    links: Dict[str, str] = field(default_factory=dict)
    meta: Dict[str, str] = field(default_factory=dict)
    node_class: str = ""
    computed_class: str = ""
    drain: bool = False
    status: str = consts.NODE_STATUS_INIT
    status_description: str = ""
    status_updated_at: float = 0.0
    create_index: int = 0
    modify_index: int = 0

    def copy(self) -> "Node":
        return copy.deepcopy(self)

    def terminal_status(self) -> bool:
        return self.status == consts.NODE_STATUS_DOWN

    def ready(self) -> bool:
        return self.status == consts.NODE_STATUS_READY and not self.drain

    def compute_class(self) -> None:
        """Derive the computed class: a stable digest over the scheduling-
        relevant identity of the node, excluding `unique.` keys so nodes
        with identical capabilities share a class (the scheduler memoizes
        feasibility per class)."""
        h = hashlib.blake2b(digest_size=8)
        h.update(self.datacenter.encode())
        h.update(b"\x00")
        h.update(self.node_class.encode())
        for m in (self.attributes, self.meta):
            h.update(b"\x01")
            for k in sorted(m):
                if is_unique_namespace(k):
                    continue
                v = m[k]
                if not isinstance(v, (str, int, float, bool)):
                    # Escape hatch: a dynamic, non-hashable value (the
                    # reference's HashIncludeMap error path) has no
                    # stable digest — str() of a list/dict would make
                    # the class depend on repr ordering. Classless
                    # nodes evaluate feasibility per node and get a
                    # singleton class in models/classes.py.
                    self.computed_class = ""
                    return
                h.update(k.encode())
                h.update(b"\x02")
                h.update(str(v).encode())
                h.update(b"\x03")
        self.computed_class = "v1:" + h.hexdigest()


def is_unique_namespace(key: str) -> bool:
    return key.startswith(consts.NODE_UNIQUE_NAMESPACE)


def unique_namespace(key: str) -> str:
    return consts.NODE_UNIQUE_NAMESPACE + key


def escaped_constraints(constraints: List[Constraint]) -> List[Constraint]:
    """Constraints referencing unique node properties escape computed-class
    memoization (node_class.go:70-94)."""
    return [
        c
        for c in constraints
        if _target_escapes(c.ltarget) or _target_escapes(c.rtarget)
    ]


def _target_escapes(target: str) -> bool:
    return (
        target.startswith("${node.unique.")
        or target.startswith("${attr.unique.")
        or target.startswith("${meta.unique.")
    )
