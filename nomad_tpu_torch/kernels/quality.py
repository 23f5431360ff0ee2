"""Kernel-agnostic placement-quality scoreboard: the port of the JAX
package's kernels/quality.py.

Throughput says how FAST a kernel places; this module scores how WELL,
on the two axes Tesserae (PAPERS.md) evaluates placement policies on,
plus the queueing axis:

- **fragmentation** — the fraction of the cluster's free cpu+mem
  capacity stranded on nodes that can no longer fit a reference ask.
  0 = every free node still fits the ask; 1 = all remaining headroom
  is unusable fragments.
- **binpack_score** — mean fill fraction (max of cpu/mem) over the
  OCCUPIED schedulable nodes. Higher = tighter.
- **queueing_delay_ms** — p99 time placement work spent QUEUED, read
  off the flight recorder's ``broker.wait`` stage (trace/). Until the
  broker is ported no ``broker.wait`` span is recorded, so the field
  reads 0.0: the JAX package's own reading with no broker spans.

Fragmentation and bin-pack are computed from COMMITTED state: the dense scheduler feeds the
board from the post-placement claimed arrays right after appending to
the plan (scheduler/tpu.py note_quality), and ``quality_from_store``
recomputes from a state store for the differential rig and tests. The
board never touches the state store and never blocks: bounded rings of
samples under one leaf lock.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

import numpy as np

# Samples kept per kernel (ring, drop-oldest).
SAMPLE_CAP = 512
# Sampling: the first WARM_SAMPLES evals per kernel always score, then
# 1 in SAMPLE_EVERY (scoring is O(N) host work on the hot path).
WARM_SAMPLES = 64
SAMPLE_EVERY = 8


def quality_from_arrays(util, capacity, node_ok, ask_res) -> Dict[str, float]:
    """Score one committed cluster state. `util`/`capacity` are the
    dense [N, R] arrays (reserved included in util, exactly the kernel
    accounting), `node_ok` the [N] readiness mask, `ask_res` the [R]
    reference ask fragmentation is measured against (a job's task-group
    ask). Returns {"fragmentation", "binpack_score"}."""
    util = np.asarray(util, np.float64)
    capacity = np.asarray(capacity, np.float64)
    node_ok = np.asarray(node_ok, bool)
    ask_res = np.asarray(ask_res, np.float64)

    real = node_ok & (capacity[:, 0] > 0)
    if not real.any():
        return {"fragmentation": 0.0, "binpack_score": 0.0}
    cap = capacity[real]
    use = np.minimum(util[real], cap)
    free = cap - use

    # Fragmentation: free cpu+mem stranded on nodes that cannot fit
    # the reference ask on EVERY dimension it asks for.
    fits = np.ones(len(cap), bool)
    for r in range(len(ask_res)):
        if ask_res[r] > 0:
            fits &= free[:, r] >= ask_res[r]
    weight = free[:, 0] / max(cap[:, 0].max(), 1.0) + \
        free[:, 1] / max(cap[:, 1].max(), 1.0)
    total_free = float(weight.sum())
    stranded = float(weight[~fits].sum())
    fragmentation = stranded / total_free if total_free > 0 else 0.0

    # Bin-pack utilization: mean max(cpu, mem) fill over occupied
    # nodes (nodes carrying any cpu or mem load beyond zero).
    frac = use[:, :2] / np.maximum(cap[:, :2], 1.0)
    occupied = frac.max(axis=1) > 1e-9
    binpack = float(frac[occupied].max(axis=1).mean()) if occupied.any() \
        else 0.0
    return {"fragmentation": fragmentation, "binpack_score": binpack}


def quality_from_store(state, job) -> Dict[str, float]:
    """Recompute the scoreboard metrics from a state store snapshot
    (the differential rig's checks and tests).
    `job`'s first task group is the reference ask."""
    from ..structs import allocs_fit

    nodes = [n for n in state.nodes()]
    n = len(nodes)
    util = np.zeros((n, 4), np.float64)
    capacity = np.zeros((n, 4), np.float64)
    node_ok = np.zeros(n, bool)
    for i, node in enumerate(nodes):
        r = node.resources
        capacity[i] = (r.cpu, r.memory_mb, r.disk_mb, r.iops)
        node_ok[i] = node.ready()
        live = [a for a in state.allocs_by_node(node.id)
                if not a.terminal_status()]
        _fit, _dim, used = allocs_fit(node, live)
        util[i] = (used.cpu, used.memory_mb, used.disk_mb, used.iops)
    return quality_from_arrays(
        util, capacity, node_ok, reference_ask(job))


def slice_fragmentation(util, capacity, node_ok, topo_ids, ask_res,
                        k: int) -> float:
    """Gang-scheduling quality axis (gang/): the fraction of
    the cluster's free cpu+mem capacity stranded in topology groups
    that can no longer fit a WHOLE gang of ``k`` members asking
    ``ask_res`` — node-level fragmentation's analog at rack/ICI
    granularity. 0 = every group's free capacity is gang-usable; 1 =
    all remaining headroom sits in groups too fragmented (or too
    small) for any gang. Nodes with topo id < 0 count as stranded for
    gangs (they can never prove slice contiguity)."""
    util = np.asarray(util, np.float64)
    capacity = np.asarray(capacity, np.float64)
    node_ok = np.asarray(node_ok, bool)
    topo_ids = np.asarray(topo_ids, np.int64)
    ask = np.asarray(ask_res, np.float64)

    real = node_ok & (capacity[:, 0] > 0)
    if not real.any():
        return 0.0
    cap = capacity[real]
    use = np.minimum(util[real], cap)
    free = cap - use
    ids = topo_ids[: len(node_ok)][real]

    # Per-node member units from free capacity (ops/gang.py
    # _member_units, resource dims only).
    units = np.full(len(cap), np.inf)
    for r in range(min(len(ask), cap.shape[1])):
        if ask[r] > 0:
            units = np.minimum(units, np.floor(free[:, r] / ask[r]))
    units = np.where(np.isfinite(units), np.maximum(units, 0.0), 0.0)

    weight = free[:, 0] / max(cap[:, 0].max(), 1.0) + \
        free[:, 1] / max(cap[:, 1].max(), 1.0)
    total = float(weight.sum())
    if total <= 0:
        return 0.0
    stranded = float(weight[ids < 0].sum())
    for gid in np.unique(ids[ids >= 0]):
        sel = ids == gid
        if units[sel].sum() < k:
            stranded += float(weight[sel].sum())
    return stranded / total


def slice_frag_from_store(state, job, tg, level: str = "rack") -> float:
    """slice_fragmentation recomputed from a state-store snapshot (the
    rig's checks). ``tg`` is the gang task
    group whose member ask and count parameterize the axis."""
    from ..models.topology import TOPOLOGY_META_KEYS
    from ..structs import allocs_fit

    key = TOPOLOGY_META_KEYS[level]
    nodes = list(state.nodes())
    n = len(nodes)
    util = np.zeros((n, 4), np.float64)
    capacity = np.zeros((n, 4), np.float64)
    node_ok = np.zeros(n, bool)
    topo = np.full(n, -1, np.int64)
    interned = {}
    for i, node in enumerate(nodes):
        r = node.resources
        capacity[i] = (r.cpu, r.memory_mb, r.disk_mb, r.iops)
        node_ok[i] = node.ready()
        value = node.meta.get(key)
        if value:
            topo[i] = interned.setdefault(value, len(interned))
        live = [a for a in state.allocs_by_node(node.id)
                if not a.terminal_status()]
        _fit, _dim, used = allocs_fit(node, live)
        util[i] = (used.cpu, used.memory_mb, used.disk_mb, used.iops)
    ask = np.zeros(4, np.float64)
    for task in tg.tasks:
        r = task.resources
        ask += (r.cpu, r.memory_mb, r.disk_mb, r.iops)
    if tg.ephemeral_disk:
        ask[2] += tg.ephemeral_disk.size_mb
    return slice_fragmentation(util, capacity, node_ok, topo, ask,
                               tg.count)


def reference_ask(job) -> np.ndarray:
    """[R] cpu/mem/disk/iops ask of the job's first task group — the
    fragmentation reference."""
    ask = np.zeros(4, np.float64)
    if job is None or not job.task_groups:
        return ask
    tg = job.task_groups[0]
    for task in tg.tasks:
        r = task.resources
        ask += (r.cpu, r.memory_mb, r.disk_mb, r.iops)
    if tg.ephemeral_disk:
        ask[2] += tg.ephemeral_disk.size_mb
    return ask


class QualityBoard:
    """Bounded per-kernel sample board. note_plan() is called on the
    scheduler hot path right after a dense plan's placements are
    appended: one leaf lock around ring bookkeeping, never blocks."""

    def __init__(self):
        self._lock = threading.Lock()
        # kernel -> [fragmentation ring, binpack ring, sample count];
        # slot = count mod SAMPLE_CAP. guarded-by: _lock
        self._rings: Dict[str, list] = {}
        # kernel -> should_sample tick count. guarded-by: _lock
        self._ticks: Dict[str, int] = {}
        # kernel -> sample count at the last reset_window(), so
        # window_snapshot() reads only samples since. guarded-by: _lock
        self._window_marks: Dict[str, int] = {}
        # broker.wait histogram snapshot at the last reset (count,
        # buckets) for the windowed queueing p99. guarded-by: _lock
        self._queue_mark = None

    def should_sample(self, kernel: str) -> bool:
        """Whether this eval should pay the O(N) scoring cost (see
        WARM_SAMPLES / SAMPLE_EVERY)."""
        with self._lock:
            tick = self._ticks.get(kernel, 0)
            self._ticks[kernel] = tick + 1
        return tick < WARM_SAMPLES or tick % SAMPLE_EVERY == 0

    def note_plan(self, kernel: str, fragmentation: float,
                  binpack: float) -> None:
        with self._lock:
            ent = self._rings.get(kernel)
            if ent is None:
                ent = [np.zeros(SAMPLE_CAP), np.zeros(SAMPLE_CAP), 0]
                self._rings[kernel] = ent
            slot = ent[2] % SAMPLE_CAP
            ent[0][slot] = fragmentation
            ent[1][slot] = binpack
            ent[2] += 1

    def reset(self) -> None:
        with self._lock:
            self._rings.clear()
            self._ticks.clear()
            self._window_marks.clear()
            self._queue_mark = None

    def reset_window(self) -> None:
        """Start a fresh rolling window: window_snapshot() then reads
        only the samples noted after this call, and the broker-wait
        histogram's growth since."""
        marks = self._queue_marks_now()
        with self._lock:
            for kernel, ent in self._rings.items():
                self._window_marks[kernel] = ent[2]
            self._queue_mark = marks

    @staticmethod
    def _queue_marks_now():
        from .. import trace

        return trace.get_recorder().stage_buckets("broker.wait")

    def window_snapshot(self, reset: bool = False) -> Dict[str, dict]:
        """Per-kernel medians over the samples since the last
        reset_window() (capped at the ring size), plus the windowed
        broker-wait queueing p99. A kernel with no window samples is
        omitted."""
        from ..utils.metrics import hist_percentile

        with self._lock:
            items = [(k, ent[0].copy(), ent[1].copy(), ent[2],
                      self._window_marks.get(k, 0))
                     for k, ent in self._rings.items()]
            queue_mark = self._queue_mark
        kernels: Dict[str, dict] = {}
        for kernel, frag, binp, count, mark in items:
            n_window = min(count - mark, SAMPLE_CAP, count)
            if n_window <= 0:
                continue
            # The window's slots are the n_window newest writes.
            slots = np.arange(count - n_window, count) % SAMPLE_CAP
            kernels[kernel] = {
                "fragmentation": round(float(np.median(frag[slots])), 4),
                "binpack_score": round(float(np.median(binp[slots])), 4),
                "samples": int(n_window),
            }
        cur = self._queue_marks_now()
        queueing = 0.0
        if cur is not None:
            count, buckets = cur
            if queue_mark is not None:
                m_count, m_buckets = queue_mark
                count -= m_count
                buckets = [b - mb for b, mb in zip(buckets, m_buckets)]
            if count > 0:
                queueing = hist_percentile(buckets, count, 0.99)
        out = {"kernels": kernels,
               "queueing_delay_ms": round(float(queueing), 3)}
        if reset:
            self.reset_window()
        return out

    def snapshot(self) -> Dict[str, dict]:
        """Per-kernel medians and sample counts, plus the queueing
        p99 off the flight recorder (one number: queueing happens
        before a kernel is chosen, so it is cluster-wide)."""
        from .. import trace

        out: Dict[str, dict] = {}
        with self._lock:
            items = [(k, ent[0].copy(), ent[1].copy(), ent[2])
                     for k, ent in self._rings.items()]
        for kernel, frag, binp, count in items:
            n = min(count, SAMPLE_CAP)
            if not n:
                continue
            out[kernel] = {
                "fragmentation": round(float(np.median(frag[:n])), 4),
                "binpack_score": round(float(np.median(binp[:n])), 4),
                "samples": count,
            }
        stages = trace.get_recorder().stage_stats()
        wait = stages.get("broker.wait", {})
        return {
            "kernels": out,
            "queueing_delay_ms": round(float(wait.get("p99_ms", 0.0)), 3),
        }


_global: Optional[QualityBoard] = None
_global_lock = threading.Lock()


def get_board() -> QualityBoard:
    global _global
    with _global_lock:
        if _global is None:
            _global = QualityBoard()
        return _global
