"""MVCC in-memory state store.

Reference: nomad/state/state_store.go:35 (StateStore over go-memdb's
immutable radix trees) and nomad/state/schema.go:18-40 (tables: nodes,
jobs, job_summary, periodic_launch, evals, allocs, index).

Design: tables are plain dicts treated as immutable-after-snapshot.
`snapshot()` marks every table shared and returns views in O(1); the
next write to a shared table copies it first (copy-on-write at table
granularity). Records are never mutated in place once inserted — writers
insert fresh copies — so snapshots are stable without locking, which is
what lets N scheduling workers read while the FSM writes (the
reference's lock-free MVCC property, SURVEY.md section 2.3).
"""

from __future__ import annotations

import copy as _copy
import threading
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Set

from ..structs import (
    Allocation,
    Evaluation,
    Job,
    JobSummary,
    Node,
    TaskGroupSummary,
    consts,
)
from . import watch


@dataclass
class PeriodicLaunch:
    id: str = ""
    launch: float = 0.0  # unix time of last launch
    create_index: int = 0
    modify_index: int = 0


class _Table:
    __slots__ = ("data", "shared")

    def __init__(self):
        self.data: Dict[str, object] = {}
        self.shared = False

    def for_write(self) -> Dict[str, object]:
        if self.shared:
            self.data = dict(self.data)
            self.shared = False
        return self.data

    def share(self) -> Dict[str, object]:
        self.shared = True
        return self.data


class _Index:
    """Secondary index: key -> frozenset-ish of ids, copy-on-write.

    COW granularity is per-SET, not per-dict: `_fresh` names the keys
    whose set was created or copied since the last `share()` — no
    snapshot can hold those, so they mutate in place. Without this,
    every `add` under one hot key (500k allocs of one job) copies the
    whole growing set and a bulk load goes quadratic.
    """

    __slots__ = ("data", "shared", "_fresh")

    def __init__(self):
        self.data: Dict[str, Set[str]] = {}
        self.shared = False
        self._fresh: Set[str] = set()

    def _for_write(self) -> Dict[str, Set[str]]:
        if self.shared:
            self.data = {k: v for k, v in self.data.items()}
            self.shared = False
        return self.data

    def add(self, key: str, id_: str) -> None:
        data = self._for_write()
        cur = data.get(key)
        if cur is None:
            data[key] = {id_}
            self._fresh.add(key)
        elif key in self._fresh:
            cur.add(id_)  # private since last share(): mutate in place
        else:
            data[key] = cur | {id_}  # copy: snapshots may hold cur
            self._fresh.add(key)

    def remove(self, key: str, id_: str) -> None:
        data = self._for_write()
        cur = data.get(key)
        if cur and id_ in cur:
            if key in self._fresh:
                cur.discard(id_)
                if not cur:
                    del data[key]
                    self._fresh.discard(key)
            else:
                nxt = cur - {id_}
                if nxt:
                    data[key] = nxt
                    self._fresh.add(key)
                else:
                    del data[key]

    def share(self) -> Dict[str, Set[str]]:
        self.shared = True
        self._fresh.clear()
        return self.data


TABLES = (
    "nodes",
    "jobs",
    "job_summary",
    "periodic_launch",
    "evals",
    "allocs",
    "vault_accessors",
)


class StateSnapshot:
    """Immutable point-in-time view with the scheduler's read interface
    (scheduler.State, reference scheduler/scheduler.go:55)."""

    def __init__(self, tables, indexes, table_indexes, latest,
                 store_id: str = ""):
        self._t = tables
        self._i = indexes
        self._table_indexes = table_indexes
        self._latest = latest
        # Identity of the owning store: table indexes alone are not
        # unique across stores in one process (tests, multi-server),
        # so caches keyed on indexes must include this.
        self.store_id = store_id

    # -- index queries --
    def latest_index(self) -> int:
        return self._latest

    def index(self, table: str) -> int:
        return self._table_indexes.get(table, 0)

    # -- nodes --
    def node_by_id(self, node_id: str) -> Optional[Node]:
        return self._t["nodes"].get(node_id)

    def nodes(self) -> List[Node]:
        return list(self._t["nodes"].values())

    # -- jobs --
    def job_by_id(self, job_id: str) -> Optional[Job]:
        return self._t["jobs"].get(job_id)

    def jobs(self) -> List[Job]:
        return list(self._t["jobs"].values())

    def jobs_by_scheduler(self, scheduler_type: str) -> List[Job]:
        return [j for j in self._t["jobs"].values() if j.type == scheduler_type]

    def jobs_by_periodic(self, periodic: bool = True) -> List[Job]:
        return [j for j in self._t["jobs"].values() if j.is_periodic() == periodic]

    def job_summary_by_id(self, job_id: str) -> Optional[JobSummary]:
        return self._t["job_summary"].get(job_id)

    # -- periodic launches --
    def periodic_launch_by_id(self, job_id: str) -> Optional[PeriodicLaunch]:
        return self._t["periodic_launch"].get(job_id)

    def periodic_launches(self) -> List[PeriodicLaunch]:
        return list(self._t["periodic_launch"].values())

    # -- evals --
    def eval_by_id(self, eval_id: str) -> Optional[Evaluation]:
        return self._t["evals"].get(eval_id)

    def evals(self) -> List[Evaluation]:
        return list(self._t["evals"].values())

    def evals_by_job(self, job_id: str) -> List[Evaluation]:
        ids = self._i["evals_by_job"].get(job_id, ())
        return [self._t["evals"][i] for i in ids]

    # -- allocs --
    def alloc_by_id(self, alloc_id: str) -> Optional[Allocation]:
        return self._t["allocs"].get(alloc_id)

    def allocs(self) -> List[Allocation]:
        return list(self._t["allocs"].values())

    def alloc_count(self) -> int:
        """O(1) allocs-table size (delta caches detect GC deletions by
        comparing it; listing 50k allocs to count them would defeat the
        point)."""
        return len(self._t["allocs"])

    def allocs_by_job(self, job_id: str) -> List[Allocation]:
        ids = self._i["allocs_by_job"].get(job_id, ())
        return [self._t["allocs"][i] for i in ids]

    def allocs_by_node(self, node_id: str) -> List[Allocation]:
        ids = self._i["allocs_by_node"].get(node_id, ())
        return [self._t["allocs"][i] for i in ids]

    def allocs_by_node_terminal(self, node_id: str, terminal: bool) -> List[Allocation]:
        return [
            a for a in self.allocs_by_node(node_id) if a.terminal_status() == terminal
        ]

    def vault_accessors(self) -> List[object]:
        return list(self._t["vault_accessors"].values())

    def vault_accessors_by_alloc(self, alloc_id: str) -> List[object]:
        return [
            a for a in self._t["vault_accessors"].values()
            if a.alloc_id == alloc_id
        ]

    def allocs_by_eval(self, eval_id: str) -> List[Allocation]:
        ids = self._i["allocs_by_eval"].get(eval_id, ())
        return [self._t["allocs"][i] for i in ids]


class StateStore:
    """The authoritative replicated state. All writes come from the FSM
    applying log entries; every write bumps the per-table and global
    index and fires scoped watches."""

    def __init__(self):
        self._lock = threading.RLock()
        self._tables: Dict[str, _Table] = {name: _Table() for name in TABLES}
        self._indexes = {
            "evals_by_job": _Index(),
            "allocs_by_job": _Index(),
            "allocs_by_node": _Index(),
            "allocs_by_eval": _Index(),
        }
        self._table_indexes: Dict[str, int] = {}
        self._latest_index = 0
        # Per-watch-scope modify indexes (the reference's state_store.go
        # index-table device, at watch.Item granularity): one entry per
        # (kind, key) actually touched by a commit. Blocking queries
        # wake — and stamp X-Nomad-Index — off THEIR scope's index, not
        # the global one, so a write to job A never re-runs a watcher
        # of job B. Bounded by _SCOPE_CAP: pruning raises _scope_floor
        # so evicted scopes degrade to conservative (global-ish) wakes
        # instead of missed ones.
        self._scope_indexes: Dict[watch.Item, int] = {}
        self._scope_floor = 0
        self.notify = watch.NotifyGroup()
        from ..utils.ids import generate_uuid

        self.store_id = generate_uuid()

    # ------------------------------------------------------------------
    # snapshots & watches
    # ------------------------------------------------------------------

    def snapshot(self) -> StateSnapshot:
        with self._lock:
            tables = {name: t.share() for name, t in self._tables.items()}
            indexes = {name: i.share() for name, i in self._indexes.items()}
            return StateSnapshot(
                tables, indexes, dict(self._table_indexes),
                self._latest_index, store_id=self.store_id,
            )

    def latest_index(self) -> int:
        with self._lock:
            return self._latest_index

    def index(self, table: str) -> int:
        with self._lock:
            return self._table_indexes.get(table, 0)

    def watch(self, items) -> "threading.Event":
        return self.notify.watch(items)

    def stop_watch(self, items, ev) -> None:
        self.notify.stop_watch(items, ev)

    def scope_index(self, items) -> int:
        """Max modify index across the given watch scopes — the index a
        blocking query on `items` should compare against ?index=N and
        report as X-Nomad-Index. Never-stamped scopes fall back to the
        scope floor (0 on a fresh store; the restored latest index when
        the snapshot predates scope persistence, so correctness degrades
        to the old conservative global behavior, never to missed
        wakes)."""
        with self._lock:
            best = 0
            for item in items:
                idx = self._scope_indexes.get(item)
                if idx is None:
                    kind, key = item
                    if kind == "table":
                        idx = self._table_indexes.get(key, 0)
                    else:
                        idx = self._scope_floor
                if idx > best:
                    best = idx
            return best

    # Read API mirrors the snapshot's (reads go through a fresh snapshot
    # so they are consistent).
    def __getattr__(self, name):
        snap_methods = (
            "node_by_id",
            "nodes",
            "job_by_id",
            "jobs",
            "jobs_by_scheduler",
            "jobs_by_periodic",
            "job_summary_by_id",
            "periodic_launch_by_id",
            "periodic_launches",
            "eval_by_id",
            "evals",
            "evals_by_job",
            "alloc_by_id",
            "allocs",
            "alloc_count",
            "allocs_by_job",
            "allocs_by_node",
            "allocs_by_node_terminal",
            "allocs_by_eval",
            "vault_accessors",
            "vault_accessors_by_alloc",
        )
        if name in snap_methods:
            return getattr(self.snapshot(), name)
        raise AttributeError(name)

    # ------------------------------------------------------------------
    # write transactions (FSM-only)
    # ------------------------------------------------------------------

    # Scope entries ever stamped before pruning engages; prune drops
    # the oldest half and raises the floor to the highest dropped
    # index (conservative, not lossy).
    _SCOPE_CAP = 262144

    def _bump(self, index: int, *tables: str) -> None:
        for t in tables:
            self._table_indexes[t] = index
        self._latest_index = max(self._latest_index, index)

    def _stamp(self, index: int, items) -> None:
        """Record `index` as the modify index of every touched scope.
        Runs under self._lock, after the txn's table writes, so a
        reader never sees new data with a pre-txn scope index."""
        scopes = self._scope_indexes
        for item in items:
            scopes[item] = index
        if len(scopes) > self._SCOPE_CAP:
            by_age = sorted(scopes.items(), key=lambda kv: kv[1])
            cut = len(by_age) // 2
            for item, idx in by_age[:cut]:
                del scopes[item]
            if cut:
                self._scope_floor = max(self._scope_floor,
                                        by_age[cut - 1][1])

    def upsert_node(self, index: int, node: Node) -> None:
        items = [watch.table("nodes"), watch.node(node.id)]
        with self._lock:
            table = self._tables["nodes"].for_write()
            existing = table.get(node.id)
            node = node.copy()
            if existing is not None:
                node.create_index = existing.create_index
            else:
                node.create_index = index
            node.modify_index = index
            # Always recompute: a re-registering node may carry a stale
            # class alongside changed attributes.
            node.compute_class()
            table[node.id] = node
            self._bump(index, "nodes")
            self._stamp(index, items)
        self.notify.notify(items)

    def delete_node(self, index: int, node_id: str) -> None:
        items = [watch.table("nodes"), watch.node(node_id)]
        with self._lock:
            table = self._tables["nodes"].for_write()
            if node_id not in table:
                return
            del table[node_id]
            self._bump(index, "nodes")
            self._stamp(index, items)
        self.notify.notify(items)

    def update_node_status(self, index: int, node_id: str, status: str) -> None:
        items = [watch.table("nodes"), watch.node(node_id)]
        with self._lock:
            table = self._tables["nodes"].for_write()
            existing = table.get(node_id)
            if existing is None:
                raise KeyError(f"node {node_id} not found")
            node = existing.copy()
            node.status = status
            node.modify_index = index
            import time as _time

            node.status_updated_at = _time.time()
            table[node_id] = node
            self._bump(index, "nodes")
            self._stamp(index, items)
        self.notify.notify(items)

    def update_node_drain(self, index: int, node_id: str, drain: bool) -> None:
        items = [watch.table("nodes"), watch.node(node_id)]
        with self._lock:
            table = self._tables["nodes"].for_write()
            existing = table.get(node_id)
            if existing is None:
                raise KeyError(f"node {node_id} not found")
            node = existing.copy()
            node.drain = drain
            node.modify_index = index
            table[node_id] = node
            self._bump(index, "nodes")
            self._stamp(index, items)
        self.notify.notify(items)

    def upsert_job(self, index: int, job: Job) -> None:
        items = [watch.table("jobs"), watch.job(job.id), watch.job_summary(job.id)]
        with self._lock:
            table = self._tables["jobs"].for_write()
            existing = table.get(job.id)
            job = job.copy()
            if existing is not None:
                job.create_index = existing.create_index
                job.job_modify_index = index
            else:
                job.create_index = index
                job.job_modify_index = index
            job.modify_index = index
            table[job.id] = job
            self._ensure_job_summary(index, job)
            items.extend(self._set_job_status(index, job))
            self._bump(index, "jobs", "job_summary")
            self._stamp(index, items)
        self.notify.notify(items)

    def delete_job(self, index: int, job_id: str) -> None:
        items = [watch.table("jobs"), watch.job(job_id), watch.job_summary(job_id)]
        with self._lock:
            table = self._tables["jobs"].for_write()
            if job_id not in table:
                return
            del table[job_id]
            summary = self._tables["job_summary"].for_write()
            summary.pop(job_id, None)
            launches = self._tables["periodic_launch"].for_write()
            launches.pop(job_id, None)
            self._bump(index, "jobs", "job_summary", "periodic_launch")
            self._stamp(index, items)
        self.notify.notify(items)

    def upsert_periodic_launch(self, index: int, launch: PeriodicLaunch) -> None:
        items = [watch.table("periodic_launch")]
        with self._lock:
            table = self._tables["periodic_launch"].for_write()
            existing = table.get(launch.id)
            rec = PeriodicLaunch(
                id=launch.id,
                launch=launch.launch,
                create_index=existing.create_index if existing else index,
                modify_index=index,
            )
            table[launch.id] = rec
            self._bump(index, "periodic_launch")
            self._stamp(index, items)
        self.notify.notify(items)

    def delete_periodic_launch(self, index: int, job_id: str) -> None:
        items = [watch.table("periodic_launch")]
        with self._lock:
            table = self._tables["periodic_launch"].for_write()
            table.pop(job_id, None)
            self._bump(index, "periodic_launch")
            self._stamp(index, items)
        self.notify.notify(items)

    def upsert_vault_accessors(self, index: int, accessors) -> None:
        """Track derived vault tokens (state_store.go vault_accessors
        table; schema.go:18-40)."""
        items = [watch.table("vault_accessors")]
        with self._lock:
            table = self._tables["vault_accessors"].for_write()
            for acc in accessors:
                acc.create_index = index
                table[acc.accessor] = acc
            self._bump(index, "vault_accessors")
            self._stamp(index, items)
        self.notify.notify(items)

    def delete_vault_accessors(self, index: int, accessors: List[str]) -> None:
        items = [watch.table("vault_accessors")]
        with self._lock:
            table = self._tables["vault_accessors"].for_write()
            for acc in accessors:
                table.pop(acc, None)
            self._bump(index, "vault_accessors")
            self._stamp(index, items)
        self.notify.notify(items)

    def upsert_evals(self, index: int, evals: List[Evaluation]) -> None:
        items = [watch.table("evals")]
        with self._lock:
            table = self._tables["evals"].for_write()
            for ev in evals:
                items.append(watch.eval_item(ev.id))
                existing = table.get(ev.id)
                ev = ev.copy()
                if existing is not None:
                    ev.create_index = existing.create_index
                else:
                    ev.create_index = index
                    self._indexes["evals_by_job"].add(ev.job_id, ev.id)
                ev.modify_index = index
                table[ev.id] = ev
                # Propagate queued-alloc counts into the job summary
                # (state_store.go UpsertEvals -> updateSummaryWithEval).
                if ev.queued_allocations:
                    self._update_summary_queued(index, ev)
                job = self._tables["jobs"].data.get(ev.job_id)
                if job is not None:
                    items.extend(self._set_job_status(index, job))
                    items.append(watch.job_summary(ev.job_id))
            self._bump(index, "evals", "job_summary")
            self._stamp(index, items)
        self.notify.notify(items)

    def delete_evals(self, index: int, eval_ids: List[str], alloc_ids: List[str]) -> None:
        items = [watch.table("evals"), watch.table("allocs")]
        touched_jobs: Set[str] = set()
        with self._lock:
            evals = self._tables["evals"].for_write()
            for eid in eval_ids:
                ev = evals.pop(eid, None)
                if ev is not None:
                    self._indexes["evals_by_job"].remove(ev.job_id, eid)
                    items.append(watch.eval_item(eid))
                    touched_jobs.add(ev.job_id)
            allocs = self._tables["allocs"].for_write()
            for aid in alloc_ids:
                alloc = allocs.pop(aid, None)
                if alloc is not None:
                    self._indexes["allocs_by_job"].remove(alloc.job_id, aid)
                    self._indexes["allocs_by_node"].remove(alloc.node_id, aid)
                    self._indexes["allocs_by_eval"].remove(alloc.eval_id, aid)
                    touched_jobs.add(alloc.job_id)
                    items.extend(
                        [
                            watch.alloc(aid),
                            watch.alloc_job(alloc.job_id),
                            watch.alloc_node(alloc.node_id),
                            watch.alloc_eval(alloc.eval_id),
                        ]
                    )
            for job_id in touched_jobs:
                job = self._tables["jobs"].data.get(job_id)
                if job is not None:
                    items.extend(self._set_job_status(index, job, eval_delete=True))
            self._bump(index, "evals", "allocs")
            self._stamp(index, items)
        self.notify.notify(items)

    def upsert_allocs(self, index: int, allocs: List[Allocation]) -> None:
        """Scheduler/plan-apply driven alloc writes (state_store.go:922).
        Client-reported status on existing allocs is preserved."""
        items = [watch.table("allocs")]
        with self._lock:
            table = self._tables["allocs"].for_write()
            for alloc in allocs:
                existing = table.get(alloc.id)
                alloc = alloc.copy()
                if existing is not None:
                    alloc.create_index = existing.create_index
                    alloc.task_states = existing.task_states
                    # The client owns client_status — EXCEPT lost: the
                    # scheduler marks an alloc lost exactly because its
                    # node went down and the client can never report
                    # again (state_store.go:922 carves out the same
                    # case). Without this the node-down -> alloc-lost
                    # chain silently reverted to the stale 'running'.
                    if alloc.client_status != consts.ALLOC_CLIENT_LOST:
                        alloc.client_status = existing.client_status
                        alloc.client_description = existing.client_description
                else:
                    alloc.create_index = index
                    if not alloc.client_status:
                        alloc.client_status = consts.ALLOC_CLIENT_PENDING
                    self._indexes["allocs_by_job"].add(alloc.job_id, alloc.id)
                    self._indexes["allocs_by_node"].add(alloc.node_id, alloc.id)
                    self._indexes["allocs_by_eval"].add(alloc.eval_id, alloc.id)
                alloc.modify_index = index
                alloc.alloc_modify_index = index
                table[alloc.id] = alloc
                self._update_summary_with_alloc(index, alloc, existing)
                items.extend(
                    [
                        watch.alloc(alloc.id),
                        watch.alloc_job(alloc.job_id),
                        watch.alloc_node(alloc.node_id),
                        watch.alloc_eval(alloc.eval_id),
                        watch.job_summary(alloc.job_id),
                    ]
                )
            # Derived job status recomputes once per touched job, not
            # once per alloc (a system job upserts one alloc per node).
            for job_id in {a.job_id for a in allocs}:
                job = self._tables["jobs"].data.get(job_id)
                if job is not None:
                    items.extend(self._set_job_status(index, job))
            self._bump(index, "allocs", "job_summary")
            self._stamp(index, items)
        self.notify.notify(items)

    def update_allocs_from_client(self, index: int, allocs: List[Allocation]) -> None:
        """Client status sync (state_store.go:843): only client-owned
        fields change; alloc_modify_index is NOT bumped so the client's
        long-poll diff (keyed on it) ignores its own writes."""
        items = [watch.table("allocs")]
        with self._lock:
            table = self._tables["allocs"].for_write()
            for update in allocs:
                existing = table.get(update.id)
                if existing is None:
                    continue
                alloc = existing.copy()
                alloc.client_status = update.client_status
                alloc.client_description = update.client_description
                # Deep-copy: the caller keeps mutating its TaskState objects
                # and stored records must stay immutable for snapshots.
                alloc.task_states = {
                    k: _copy.deepcopy(v) for k, v in update.task_states.items()
                }
                alloc.modify_index = index
                table[alloc.id] = alloc
                self._update_summary_with_alloc(index, alloc, existing)
                job = self._tables["jobs"].data.get(alloc.job_id)
                if job is not None:
                    items.extend(self._set_job_status(index, job))
                items.extend(
                    [
                        watch.alloc(alloc.id),
                        watch.alloc_job(alloc.job_id),
                        watch.alloc_node(alloc.node_id),
                        watch.alloc_eval(alloc.eval_id),
                        watch.job_summary(alloc.job_id),
                    ]
                )
            self._bump(index, "allocs", "job_summary")
            self._stamp(index, items)
        self.notify.notify(items)

    # ------------------------------------------------------------------
    # derived state (job status + summaries)
    # ------------------------------------------------------------------

    def _ensure_job_summary(self, index: int, job: Job) -> None:
        summaries = self._tables["job_summary"].for_write()
        existing = summaries.get(job.id)
        summary = existing.copy() if existing else JobSummary(job_id=job.id, create_index=index)
        for tg in job.task_groups:
            summary.summary.setdefault(tg.name, TaskGroupSummary())
        summary.modify_index = index
        summaries[job.id] = summary

    def _update_summary_queued(self, index: int, ev: Evaluation) -> None:
        summaries = self._tables["job_summary"].for_write()
        existing = summaries.get(ev.job_id)
        if existing is None:
            return
        summary = existing.copy()
        for tg, queued in ev.queued_allocations.items():
            tgs = summary.summary.setdefault(tg, TaskGroupSummary())
            tgs.queued = queued
        summary.modify_index = index
        summaries[ev.job_id] = summary

    def _update_summary_with_alloc(
        self, index: int, alloc: Allocation, existing: Optional[Allocation]
    ) -> None:
        """Maintain per-task-group client-status counts
        (state_store.go:1552 updateSummaryWithAlloc)."""
        summaries = self._tables["job_summary"].for_write()
        cur = summaries.get(alloc.job_id)
        if cur is None:
            cur = JobSummary(job_id=alloc.job_id, create_index=index)
        summary = cur.copy()
        tgs = summary.summary.setdefault(alloc.task_group, TaskGroupSummary())

        def bucket(status: str) -> Optional[str]:
            return {
                consts.ALLOC_CLIENT_PENDING: "starting",
                consts.ALLOC_CLIENT_RUNNING: "running",
                consts.ALLOC_CLIENT_COMPLETE: "complete",
                consts.ALLOC_CLIENT_FAILED: "failed",
                consts.ALLOC_CLIENT_LOST: "lost",
            }.get(status)

        if existing is not None:
            old = bucket(existing.client_status)
            if old and getattr(tgs, old) > 0:
                setattr(tgs, old, getattr(tgs, old) - 1)
        new = bucket(alloc.client_status)
        if new:
            setattr(tgs, new, getattr(tgs, new) + 1)
        summary.modify_index = index
        summaries[alloc.job_id] = summary

    def _get_job_status(self, job: Job, eval_delete: bool) -> str:
        """Derive job status (state_store.go:1457 getJobStatus): running if
        any non-terminal alloc; pending if any non-terminal eval; dead when
        everything outstanding is terminal (or evals were GC'd); a brand-new
        job with nothing outstanding is pending (running if periodic)."""
        has_alloc = False
        for aid in self._indexes["allocs_by_job"].data.get(job.id, ()):
            alloc = self._tables["allocs"].data.get(aid)
            if alloc is None:
                continue
            has_alloc = True
            if not alloc.terminal_status():
                return consts.JOB_STATUS_RUNNING
        has_eval = False
        for eid in self._indexes["evals_by_job"].data.get(job.id, ()):
            ev = self._tables["evals"].data.get(eid)
            if ev is None:
                continue
            has_eval = True
            if not ev.terminal_status():
                return consts.JOB_STATUS_PENDING
        if eval_delete or has_eval or has_alloc:
            return consts.JOB_STATUS_DEAD
        # A periodic parent never gets allocs/evals of its own.
        if job.is_periodic():
            return consts.JOB_STATUS_RUNNING
        return consts.JOB_STATUS_PENDING

    def _set_job_status(self, index: int, job: Job, eval_delete: bool = False) -> list:
        """Recompute and store the derived job status (state_store.go:1417
        setJobStatus). Returns the watch items to notify (empty when the
        status is unchanged); a change also bumps the jobs table index."""
        status = self._get_job_status(job, eval_delete)
        stored = self._tables["jobs"].data.get(job.id)
        if stored is None or stored.status == status:
            return []  # avoid the jobs-table copy-on-write when unchanged
        jobs = self._tables["jobs"].for_write()
        updated = jobs[job.id].copy()
        updated.status = status
        updated.modify_index = index
        jobs[job.id] = updated
        self._bump(index, "jobs")
        return [watch.table("jobs"), watch.job(job.id)]

    # ------------------------------------------------------------------
    # persistence (FSM snapshot install/restore)
    # ------------------------------------------------------------------

    def persist(self) -> dict:
        from ..utils.codec import to_dict

        with self._lock:
            return {
                "nodes": [to_dict(n) for n in self._tables["nodes"].data.values()],
                "jobs": [to_dict(j) for j in self._tables["jobs"].data.values()],
                "job_summary": [
                    to_dict(s) for s in self._tables["job_summary"].data.values()
                ],
                "periodic_launch": [
                    to_dict(p) for p in self._tables["periodic_launch"].data.values()
                ],
                "evals": [to_dict(e) for e in self._tables["evals"].data.values()],
                "allocs": [to_dict(a) for a in self._tables["allocs"].data.values()],
                "vault_accessors": [
                    to_dict(v)
                    for v in self._tables["vault_accessors"].data.values()
                ],
                "table_indexes": dict(self._table_indexes),
                "latest_index": self._latest_index,
                "scope_indexes": [
                    [kind, key, idx]
                    for (kind, key), idx in self._scope_indexes.items()
                ],
                "scope_floor": self._scope_floor,
            }

    @classmethod
    def restore(cls, data: dict) -> "StateStore":
        from ..utils.codec import from_dict

        store = cls()
        with store._lock:
            for raw in data.get("nodes", []):
                n = from_dict(Node, raw)
                store._tables["nodes"].data[n.id] = n
            for raw in data.get("jobs", []):
                j = from_dict(Job, raw)
                store._tables["jobs"].data[j.id] = j
            for raw in data.get("job_summary", []):
                s = from_dict(JobSummary, raw)
                store._tables["job_summary"].data[s.job_id] = s
            for raw in data.get("periodic_launch", []):
                p = from_dict(PeriodicLaunch, raw)
                store._tables["periodic_launch"].data[p.id] = p
            for raw in data.get("evals", []):
                e = from_dict(Evaluation, raw)
                store._tables["evals"].data[e.id] = e
                store._indexes["evals_by_job"].add(e.job_id, e.id)
            for raw in data.get("allocs", []):
                a = from_dict(Allocation, raw)
                store._tables["allocs"].data[a.id] = a
                store._indexes["allocs_by_job"].add(a.job_id, a.id)
                store._indexes["allocs_by_node"].add(a.node_id, a.id)
                store._indexes["allocs_by_eval"].add(a.eval_id, a.id)
            from ..structs.alloc import VaultAccessor

            for raw in data.get("vault_accessors", []):
                v = from_dict(VaultAccessor, raw)
                store._tables["vault_accessors"].data[v.accessor] = v
            store._table_indexes = dict(data.get("table_indexes", {}))
            store._latest_index = data.get("latest_index", 0)
            scopes = data.get("scope_indexes")
            if scopes is None:
                # Snapshot predates scope persistence: every scope's
                # history is unknown, so the floor is the whole
                # restored history (conservative global-index wakes for
                # pre-restore scopes, exact tracking from here on).
                store._scope_floor = store._latest_index
            else:
                store._scope_indexes = {
                    (kind, key): idx for kind, key, idx in scopes
                }
                store._scope_floor = data.get("scope_floor", 0)
        return store
