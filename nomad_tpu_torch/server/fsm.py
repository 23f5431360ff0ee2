"""FSM: applies replicated log entries to the state store, with
leader-side hooks into the broker / blocked-evals / periodic services.
The port of the JAX package's server/fsm.py: the same message types and
handlers, so the same log entries leave both stores equal.

Reference: nomad/fsm.go:44 (nomadFSM), :102 (Apply switch over the
message types of structs.go:40-56), :506/:520 (Snapshot/Restore).
"""

from __future__ import annotations

import logging
import threading
import time
from collections import OrderedDict
from typing import Callable, Dict, List, Optional

from ..state import PeriodicLaunch, StateStore
from ..utils import metrics
from ..structs import Allocation, Evaluation, Job, Node, consts
from .. import trace
from .timetable import TimeTable

# The commit-path manifest (data, as in the JAX package): THE
# sanctioned commit path. State-store mutators and terminal status stamps are
# only legal inside these handlers' whole-program call closure (or,
# for stamps, on a copy that flows into an eval_update/alloc_update
# submit in the same function). Everything here runs on the serialized
# raft apply thread on every replica — the one place a write cannot
# diverge or double-commit.
NTA_RAFT_FUNNELS = (
    "FSM.apply",
    "FSM._apply_node_register",
    "FSM._apply_node_deregister",
    "FSM._apply_node_status",
    "FSM._apply_node_drain",
    "FSM._apply_job_register",
    "FSM._apply_job_deregister",
    "FSM._apply_eval_update",
    "FSM._apply_eval_delete",
    "FSM._apply_alloc_update",
    "FSM._apply_alloc_client_update",
    "FSM._apply_periodic_launch",
    "FSM._apply_periodic_launch_delete",
    "FSM._apply_vault_accessor_register",
    "FSM._apply_vault_accessor_deregister",
    "FSM.restore",
)

# Log message types (structs.go:40-53)
NODE_REGISTER = "node_register"
NODE_DEREGISTER = "node_deregister"
NODE_UPDATE_STATUS = "node_update_status"
NODE_UPDATE_DRAIN = "node_update_drain"
JOB_REGISTER = "job_register"
JOB_DEREGISTER = "job_deregister"
EVAL_UPDATE = "eval_update"
EVAL_DELETE = "eval_delete"
ALLOC_UPDATE = "alloc_update"
ALLOC_CLIENT_UPDATE = "alloc_client_update"
PERIODIC_LAUNCH = "periodic_launch"
PERIODIC_LAUNCH_DELETE = "periodic_launch_delete"
VAULT_ACCESSOR_REGISTER = "vault_accessor_register"
VAULT_ACCESSOR_DEREGISTER = "vault_accessor_deregister"


class FSM:
    def __init__(self, logger: Optional[logging.Logger] = None):
        self.logger = logger or logging.getLogger("nomad_tpu_torch.fsm")
        self.state = StateStore()
        self.timetable = TimeTable()
        # Leader-only services, attached while this server is leader
        # (fsm.go enqueues into the broker only on the leader).
        self.broker = None
        self.blocked_evals = None
        self.periodic = None
        self.last_applied_index = 0
        # Recent apply outcomes (rejections), bounded; keyed by index.
        self._outcomes: "OrderedDict[int, object]" = OrderedDict()
        self._handlers: Dict[str, Callable] = {
            NODE_REGISTER: self._apply_node_register,
            NODE_DEREGISTER: self._apply_node_deregister,
            NODE_UPDATE_STATUS: self._apply_node_status,
            NODE_UPDATE_DRAIN: self._apply_node_drain,
            JOB_REGISTER: self._apply_job_register,
            JOB_DEREGISTER: self._apply_job_deregister,
            EVAL_UPDATE: self._apply_eval_update,
            EVAL_DELETE: self._apply_eval_delete,
            ALLOC_UPDATE: self._apply_alloc_update,
            ALLOC_CLIENT_UPDATE: self._apply_alloc_client_update,
            PERIODIC_LAUNCH: self._apply_periodic_launch,
            PERIODIC_LAUNCH_DELETE: self._apply_periodic_launch_delete,
            VAULT_ACCESSOR_REGISTER: self._apply_vault_accessor_register,
            VAULT_ACCESSOR_DEREGISTER: self._apply_vault_accessor_deregister,
        }

    def apply(self, index: int, msg_type: str, payload: dict) -> object:
        self.timetable.witness(index)
        handler = self._handlers.get(msg_type)
        if handler is None:
            raise ValueError(f"unknown log message type {msg_type!r}")
        start = time.monotonic()
        result = handler(index, payload)
        metrics.measure_since(("fsm", msg_type), start)
        self.last_applied_index = index
        return result

    def outcome(self, index: int) -> object:
        """Deterministic apply outcome for a recent log index (e.g. an
        enforce-index rejection). Every replica computes the same value
        from identical state, so reading it locally is safe."""
        return self._outcomes.get(index)

    # ------------------------------------------------------------ nodes

    def _apply_node_register(self, index: int, payload: dict):
        node: Node = payload["node"]
        self.state.upsert_node(index, node)
        # New capacity may unblock waiting evals.
        if self.blocked_evals is not None and node.status == consts.NODE_STATUS_READY:
            stored = self.state.node_by_id(node.id)
            self.blocked_evals.unblock(stored.computed_class, index)
        return None

    def _apply_node_deregister(self, index: int, payload: dict):
        self.state.delete_node(index, payload["node_id"])
        return None

    def _apply_node_status(self, index: int, payload: dict):
        node_id, status = payload["node_id"], payload["status"]
        self.state.update_node_status(index, node_id, status)
        if self.blocked_evals is not None and status == consts.NODE_STATUS_READY:
            node = self.state.node_by_id(node_id)
            if node is not None:
                self.blocked_evals.unblock(node.computed_class, index)
        return None

    def _apply_node_drain(self, index: int, payload: dict):
        self.state.update_node_drain(index, payload["node_id"], payload["drain"])
        return None

    # ------------------------------------------------------------ vault

    def _apply_vault_accessor_register(self, index: int, payload: dict):
        """fsm.go applyUpsertVaultAccessor."""
        self.state.upsert_vault_accessors(index, payload["accessors"])
        return None

    def _apply_vault_accessor_deregister(self, index: int, payload: dict):
        """fsm.go applyDeregisterVaultAccessor."""
        self.state.delete_vault_accessors(index, payload["accessors"])
        return None

    # ------------------------------------------------------------- jobs

    def _apply_job_register(self, index: int, payload: dict):
        job: Job = payload["job"]
        # Enforce-index gate (job_endpoint.go:60-79) is evaluated here,
        # inside the serialized apply path, so the check-and-commit is
        # atomic and identical on every replica — two concurrent
        # `run -check-index N` submissions commit at different log
        # positions and the second deterministically loses.
        if payload.get("enforce_index"):
            jmi = int(payload.get("job_modify_index") or 0)
            cur = self.state.job_by_id(job.id)
            err = None
            if jmi == 0 and cur is not None:
                err = "Enforcing job modify index 0: job already exists"
            elif jmi != 0 and cur is None:
                err = f"Enforcing job modify index {jmi}: job does not exist"
            elif jmi != 0 and cur.job_modify_index != jmi:
                err = (
                    f"Enforcing job modify index {jmi}: job exists "
                    f"with conflicting job modify index: {cur.job_modify_index}"
                )
            if err is not None:
                self._outcomes[index] = err
                while len(self._outcomes) > 1024:
                    self._outcomes.popitem(last=False)
                return err
        self.state.upsert_job(index, job)
        if self.periodic is not None and job.is_periodic():
            self.periodic.add(self.state.job_by_id(job.id))
        return None

    def _apply_job_deregister(self, index: int, payload: dict):
        job_id = payload["job_id"]
        self.state.delete_job(index, job_id)
        if self.periodic is not None:
            self.periodic.remove(job_id)
            self.state.delete_periodic_launch(index, job_id)
        if self.blocked_evals is not None:
            self.blocked_evals.untrack(job_id)
        return None

    # ------------------------------------------------------------ evals

    def _apply_eval_update(self, index: int, payload: dict):
        evals: List[Evaluation] = payload["evals"]
        self.state.upsert_evals(index, evals)
        if self.broker is None:
            return None
        for ev in evals:
            if ev.should_enqueue():
                self.broker.enqueue(ev, payload.get("token", ""))
            elif ev.should_block() and self.blocked_evals is not None:
                stored = self.state.eval_by_id(ev.id)
                self.blocked_evals.block(stored)
        return None

    def _apply_eval_delete(self, index: int, payload: dict):
        self.state.delete_evals(index, payload["eval_ids"], payload["alloc_ids"])
        return None

    # ----------------------------------------------------------- allocs

    def _apply_alloc_update(self, index: int, payload: dict):
        allocs: List[Allocation] = payload["allocs"]
        job = payload.get("job")
        for alloc in allocs:
            if alloc.job is None:
                if job is not None and alloc.job_id == job.id:
                    alloc.job = job
                else:
                    # A plan may carry OTHER jobs' allocs (preemption
                    # victims): re-denormalize from the stored record,
                    # never from the submitting plan's job — a victim
                    # stamped with the preemptor's job would lie about
                    # its own priority to every later scheduler pass.
                    stored = self.state.alloc_by_id(alloc.id)
                    if stored is not None:
                        alloc.job = stored.job
        t0 = time.monotonic()
        self.state.upsert_allocs(index, allocs)
        # Trace: the state-store write is the lifecycle's last
        # side-effecting stage; one span per eval whose allocs landed
        # in this apply (a plan's allocs share one eval). create=False:
        # this handler ALSO runs on followers and on raft-log replay,
        # where no broker opened the trace — only an active (leader,
        # live) lifecycle records here.
        for eval_id in {a.eval_id for a in allocs if a.eval_id}:
            trace.record_span(eval_id, trace.STAGE_ALLOC_UPSERT, t0,
                              ann={"index": index}, create=False)
        return None

    def _apply_alloc_client_update(self, index: int, payload: dict):
        allocs: List[Allocation] = payload["allocs"]
        self.state.update_allocs_from_client(index, allocs)
        # A terminal client status frees capacity: unblock by the node's
        # computed class (fsm.go applyAllocClientUpdate -> Unblock).
        if self.blocked_evals is not None:
            for alloc in allocs:
                if alloc.client_status in (
                    consts.ALLOC_CLIENT_COMPLETE,
                    consts.ALLOC_CLIENT_FAILED,
                    # Lost frees capacity too: a client re-syncing after
                    # its node was downed (heartbeat TTL) reports its
                    # allocs lost, and evals blocked on that class must
                    # re-trigger — the node-down -> alloc-lost ->
                    # blocked-eval chain ends here.
                    consts.ALLOC_CLIENT_LOST,
                ):
                    # Client sync updates are SPARSE (id + status +
                    # task_states, client/agent.py _flush_dirty): the
                    # node comes from the stored record, which the
                    # upsert above just refreshed. Looking at the wire
                    # alloc's empty node_id here silently skipped every
                    # unblock, wedging capacity-blocked evals forever.
                    node_id = alloc.node_id
                    if not node_id:
                        stored = self.state.alloc_by_id(alloc.id)
                        node_id = stored.node_id if stored else ""
                    node = self.state.node_by_id(node_id)
                    if node is not None:
                        self.blocked_evals.unblock(node.computed_class, index)
        return None

    # --------------------------------------------------------- periodic

    def _apply_periodic_launch(self, index: int, payload: dict):
        self.state.upsert_periodic_launch(
            index, PeriodicLaunch(id=payload["job_id"], launch=payload["launch"])
        )
        return None

    def _apply_periodic_launch_delete(self, index: int, payload: dict):
        self.state.delete_periodic_launch(index, payload["job_id"])
        return None

    # --------------------------------------------------------- snapshot

    def snapshot_data(self) -> dict:
        return self.state.persist()

    def restore(self, data: dict) -> None:
        self.state = StateStore.restore(data)
        self.last_applied_index = self.state.latest_index()


class DevLog:
    """Single-node, in-memory replicated-log stand-in: applies entries
    synchronously to the local FSM (the reference's dev mode uses
    raft.InmemStore with a single peer, server.go:657-663). The port
    has no raft log yet: dev mode is the only mode."""

    def __init__(self, fsm: FSM):
        self.fsm = fsm
        self._lock = threading.Lock()
        self._index = 0

    def apply(self, msg_type: str, payload: dict) -> int:
        with self._lock:
            self._index += 1
            index = self._index
        self.fsm.apply(index, msg_type, payload)
        return index

    def last_index(self) -> int:
        with self._lock:
            return self._index

    def barrier(self) -> int:
        return self.last_index()
