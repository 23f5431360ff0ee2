"""Node-topology tensor: rack / ICI-neighborhood ids as integer
columns on the cluster base.

Gang scheduling (nomad_tpu/gang) needs topology as ARRAYS: the dense
all-K feasibility pass groups per-node member capacity by topology
group (a scatter-add over group ids) and selects a contiguous slice on
device — per-node python dict reads per eval would put the whole gang
pass back on the GIL. This module interns each topology level's node
meta values (``meta.rack``, ``meta.ici``) into dense int32 id columns
padded to the base's node bucket.

Residency contract: topology is NODE-level and alloc-independent,
exactly like the computed-class index — a ``_ClusterBase`` builds its
``TopologyIndex`` once and every delta clone shares it BY REFERENCE
(models/matrix.py delta_update), so plan commits and node up/down/
drain flips ride the existing delta scatter without touching it. The
one transition that can change topology membership — node register/
deregister, or a meta edit (which moves the computed class and already
refuses the row delta) — breaks the delta family and re-anchors with a
full rebuild, which re-derives the tensor. That is how register/
deregister keeps the tensor current without a dedicated update path.

Padding/missing conventions (shared with ops/gang.py):

- rows past ``n_real`` (bucket padding) carry ``-1``;
- real nodes MISSING the meta key carry ``-1`` too: they can never
  prove slice contiguity, so slice-constrained gangs exclude them;
  spread/affinity treat each as its own singleton group.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

# Node meta keys per topology level. "rack" reuses the key the
# differential rig and docs already use; "ici" names the accelerator
# interconnect neighborhood (the Tesserae slice axis).
TOPOLOGY_META_KEYS = {"rack": "rack", "ici": "ici"}
TOPOLOGY_LEVELS = tuple(TOPOLOGY_META_KEYS)

# Topology-group-count padding ladder: the gang program's group-
# capacity array is [G_pad] and each distinct size is one compiled
# program (models/matrix.py CLASS_BUCKETS precedent — coarse beats
# tight through a compile-per-shape regime).
TOPO_GROUP_BUCKETS = [16, 64, 256, 1024]

# Registered sizer for ntalint's `unbucketed-shape` rule. The
# returns-a-bucketizer closure already sanctions topo_group_pad
# (its return IS a bucket_size call); the manifest states the intent
# explicitly so the sanction survives any reshaping of the body.
NTA_BUCKET_FNS = ("topo_group_pad",)


def topo_group_pad(n_groups: int) -> int:
    from .matrix import bucket_size

    return bucket_size(max(n_groups, 1), TOPO_GROUP_BUCKETS)


class TopologyIndex:
    """Interned topology columns for one node set. ``ids[level]`` is a
    padded [n_pad] int32 column (-1 = missing/padding), ``names[level]``
    the interned group-name list (id -> name)."""

    __slots__ = ("n_real", "n_pad", "ids", "names", "counts")

    def __init__(self, nodes, n_pad: int):
        self.n_real = len(nodes)
        self.n_pad = n_pad
        self.ids: Dict[str, np.ndarray] = {}
        self.names: Dict[str, List[str]] = {}
        self.counts: Dict[str, int] = {}
        for level, key in TOPOLOGY_META_KEYS.items():
            col = np.full(n_pad, -1, np.int32)
            interned: Dict[str, int] = {}
            names: List[str] = []
            for i, node in enumerate(nodes):
                value = node.meta.get(key)
                if not value:
                    continue
                gid = interned.get(value)
                if gid is None:
                    gid = len(names)
                    interned[value] = gid
                    names.append(value)
                col[i] = gid
            self.ids[level] = col
            self.names[level] = names
            self.counts[level] = len(names)

    def column(self, level: str) -> np.ndarray:
        """The padded id column for one level (read-only by contract:
        delta clones share it by reference)."""
        return self.ids[level]

    def group_name(self, level: str, gid: int) -> str:
        names = self.names[level]
        return names[gid] if 0 <= gid < len(names) else ""

    def singleton_column(self, level: str) -> Tuple[np.ndarray, int]:
        """The level's column with MISSING rows remapped to unique
        singleton group ids (spread/affinity semantics: a node without
        the meta key is its own group). Returns (column, group_count
        including singletons); padding rows stay -1."""
        col = self.ids[level].copy()
        base = self.counts[level]
        missing = np.flatnonzero(col[: self.n_real] < 0)
        col[missing] = base + np.arange(len(missing), dtype=np.int32)
        return col, base + len(missing)


def node_topology_summary(nodes) -> Dict[str, Dict[str, int]]:
    """{level: {group name: node count}} over a node list — the
    stats/debug surface (server.stats()["gang"]["topology"])."""
    out: Dict[str, Dict[str, int]] = {}
    for level, key in TOPOLOGY_META_KEYS.items():
        per: Dict[str, int] = {}
        for node in nodes:
            value = node.meta.get(key)
            if value:
                per[value] = per.get(value, 0) + 1
        out[level] = per
    return out
