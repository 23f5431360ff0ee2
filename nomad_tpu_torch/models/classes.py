"""The compression plane: computed-node-class dedup for the dense path.

Real fleets collapse into C << N equivalence classes — the reference
memoizes *feasibility* per computed class (structs/node_class.go:31,
scheduler/feasible.go:457) and models/matrix.py already rides that for
the [N, G] constraint mask. This module interns the rest of a node's
*placement-relevant* identity so whole dense programs can run at class
granularity and expand back to concrete nodes only at the
assignment/rounding step (defrag/solver.py's global solve is the first
consumer: its x[K, N] tensor is the biggest in the system and shrinks
to x[K, C]).

The signature REFINES the computed class: it is the computed-class
digest (datacenter / node_class / non-unique attrs+meta — everything
the feasibility checkers read, scheduler/feasible.py
resolve_constraint_target) plus the static row state matrix.py
_fill_static derives (raw + reserved capacity, link bandwidth, reserved
ports) and the topology group ids (models/topology.py). Two nodes with
equal signatures therefore produce bit-identical static matrix rows and
identical feasibility verdicts for every non-escaped constraint — they
are placement-indistinguishable up to their *live* allocations, which
stay per-node in the dense arrays (tests/test_classes.py holds this
against the oracle differential rig).

Escape hatch: a node without a computed class (dynamic, non-hashable
attr values — structs/node.py compute_class refuses to digest those)
gets a SINGLETON class, so every node is in exactly one class and
class-granular aggregation covers the whole fleet; it just compresses
nothing for the escaped rows.

Like the class index and topology tensor, a ClassIndex is node-level
and alloc-independent: delta clones of a cluster base share it by
reference, and a node whose signature moves (meta edit, capacity
change) refuses the row delta and forces a rebuild that re-interns
(models/matrix.py delta_update — the class-split path).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ..structs import consts
from ..structs.node import Node
from .topology import TOPOLOGY_META_KEYS


def node_signature(node: Node) -> Optional[Tuple]:
    """Hashable placement signature of one node, or None for the
    escape-hatch (singleton-class) path. Covers the computed-class
    digest plus every static field matrix.py _fill_static reads, so
    signature equality implies bit-identical static rows."""
    if not node.computed_class:
        return None
    r = node.resources
    if r is None:
        return None
    res = node.reserved
    res_bw = 0.0
    res_ports = 0
    if res is not None:
        for net in res.networks:
            res_bw += net.mbits
            for p in list(net.reserved_ports) + list(net.dynamic_ports):
                if consts.MIN_DYNAMIC_PORT <= p.value < consts.MAX_DYNAMIC_PORT:
                    res_ports += 1
    return (
        node.computed_class,
        (r.cpu, r.memory_mb, r.disk_mb, r.iops),
        (res.cpu, res.memory_mb, res.disk_mb, res.iops)
        if res is not None else (0, 0, 0, 0),
        r.networks[0].mbits if r.networks else 0.0,
        res_bw,
        res_ports,
        # Topology group membership (models/topology.py): non-unique
        # meta is already inside the computed-class digest, but the
        # gang program's group ids must never ride a merged class even
        # if the digest scheme drifts — state them explicitly.
        tuple(node.meta.get(k) for k in sorted(TOPOLOGY_META_KEYS.values())),
    )


class ClassIndex:
    """Node -> signature-class interning over one matrix's node list.

    ``ids[i]`` is the class of row i (-1 only on padding rows — escaped
    nodes get singleton classes, so every real row is classed),
    ``reps[c]`` a representative row, ``counts[c]`` the member count,
    and ``members(c)`` the member rows. Construction is deterministic
    in row order, so two builds over the same node list are equal
    array-for-array (the parity property tests/test_resident_state.py
    asserts at every raft index)."""

    __slots__ = ("ids", "reps", "counts", "signatures", "n_real",
                 "n_classes", "n_escaped", "_members")

    def __init__(self, nodes: List[Node], n_pad: Optional[int] = None):
        n_real = len(nodes)
        self.n_real = n_real
        if n_pad is None:
            # Default-sized builds land on the node bucket ladder: a
            # raw len(nodes) shape here becomes a per-N compile key
            # the moment ids rides a device program (ntalint
            # unbucketed-shape). Lazy import: matrix.py imports us.
            from .matrix import BUCKETS, bucket_size
            n_pad = bucket_size(max(n_real, 1), BUCKETS)
        self.ids = np.full(n_pad, -1, np.int32)
        self.reps: List[int] = []
        self.signatures: List[Optional[Tuple]] = []
        counts: List[int] = []
        index: Dict[Tuple, int] = {}
        escaped = 0
        for i, node in enumerate(nodes):
            sig = node_signature(node)
            if sig is None:
                # Escape hatch: a class of one, never merged.
                ci = len(self.reps)
                self.reps.append(i)
                self.signatures.append(None)
                counts.append(1)
                escaped += 1
            else:
                ci = index.get(sig)
                if ci is None:
                    ci = len(self.reps)
                    index[sig] = ci
                    self.reps.append(i)
                    self.signatures.append(sig)
                    counts.append(0)
                counts[ci] += 1
            self.ids[i] = ci
        self.counts = np.asarray(counts, np.int32)
        self.n_classes = len(self.reps)
        self.n_escaped = escaped
        self._members: Optional[List[np.ndarray]] = None

    def signature_of(self, row: int) -> Optional[Tuple]:
        """The interned signature of one real row (None for escaped
        rows) — what delta_update compares against the refreshed node
        object to detect a class split."""
        ci = int(self.ids[row])
        if ci < 0:
            return None
        return self.signatures[ci]

    def members(self, ci: int) -> np.ndarray:
        """Member rows of one class (ascending). The per-class lists
        build lazily in one vectorized pass — expansion-side consumers
        (defrag rounding, bench audits) want them, the hot build path
        does not."""
        if self._members is None:
            order = np.argsort(self.ids[: self.n_real], kind="stable")
            ordered_ids = self.ids[order]
            bounds = np.searchsorted(
                ordered_ids, np.arange(self.n_classes + 1))
            self._members = [
                order[bounds[c]: bounds[c + 1]]
                for c in range(self.n_classes)
            ]
        return self._members[ci]

    def compression_ratio(self) -> float:
        """N / C — the bench's ``class_compression_ratio`` column; 1.0
        means the plane compresses nothing (all-singleton fleet)."""
        return self.n_real / max(1, self.n_classes)

    def stats(self) -> dict:
        """The ``matrix.compress`` trace-span annotation shape."""
        return {
            "classes": int(self.n_classes),
            "nodes": int(self.n_real),
            "escaped": int(self.n_escaped),
            "ratio": round(self.compression_ratio(), 2),
        }


def best_member_rows(idx: ClassIndex, util: np.ndarray,
                     capacity: np.ndarray,
                     node_ok: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Per-class choice of the concrete node a class-granular placement
    expands to: the least-filled schedulable member (fill = max of the
    cpu/mem utilization fractions). Returns (rows [n_classes] int64,
    class_ok [n_classes] bool); rows of classes with no schedulable
    member point at the representative and class_ok goes False.

    Host numpy, once per placement round on the expansion path — the
    dense program scores C class rows, this picks which member each
    winning class lands on (the same expand-at-rounding step the defrag
    solve takes through expand_to_nodes)."""
    n = idx.n_real
    denom = np.maximum(capacity[:n, :2], 1.0)
    fill = np.max(util[:n, :2] / denom, axis=1)
    fill = np.where(node_ok[:n], fill, np.inf)
    rows = np.empty(idx.n_classes, np.int64)
    ok = np.empty(idx.n_classes, bool)
    for c in range(idx.n_classes):
        members = idx.members(c)
        best = members[np.argmin(fill[members])]
        rows[c] = best
        ok[c] = np.isfinite(fill[best])
    return rows, ok


def class_sum(values: np.ndarray, ids: np.ndarray, n_classes: int,
              where: Optional[np.ndarray] = None) -> np.ndarray:
    """Aggregate per-node values [N(, R)] to per-class sums
    [n_classes(, R)] (n_classes may be padded past the index's count).
    ``where`` masks rows out of the aggregate — the defrag solve drops
    not-ok members so a class's capacity is its LIVE capacity."""
    n = len(ids)
    vals = values[:n]
    if where is not None:
        w = where[:n].astype(vals.dtype)
        vals = vals * (w[:, None] if vals.ndim == 2 else w)
    out_shape = (n_classes,) + vals.shape[1:]
    out = np.zeros(out_shape, vals.dtype)
    np.add.at(out, ids, vals)
    return out


def class_any(flags: np.ndarray, ids: np.ndarray,
              n_classes: int) -> np.ndarray:
    """Per-class OR of a boolean row property (e.g. node_ok: a class is
    schedulable while any member is)."""
    out = np.zeros(n_classes, bool)
    np.logical_or.at(out, ids, flags[: len(ids)])
    return out


def expand_to_nodes(per_class: np.ndarray, ids: np.ndarray,
                    counts: np.ndarray) -> np.ndarray:
    """Expand a class-granular solution [.., C] back to node granularity
    [.., N], splitting each class's mass evenly over its members — the
    expansion step before per-node rounding (defrag/solver.py walks the
    expanded preferences against actual per-node headroom, so the even
    split is a tie-break, not a feasibility claim).

    Host numpy on purpose: expansion happens once per solve on the
    host rounding path, never inside a jitted program (the ntalint
    residency gate keeps device transfers out of here)."""
    share = per_class[..., ids] / np.maximum(counts[ids], 1)
    return share.astype(per_class.dtype, copy=False)
