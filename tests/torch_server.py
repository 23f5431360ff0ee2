"""Shared helpers of the tests that drive the port's dev-mode Server
(nomad_tpu_torch.server) on the CPU.

MockClient is the JAX package's client/mock_client.py on the port's
structs (the port has no client agent yet): it registers a node,
heartbeats, watches its allocations (the client pull model, reference
client/client.go:1125 watchAllocations keyed on alloc_modify_index), and
drives alloc client status pending -> running (-> complete for batch).
Its heartbeats can be stopped (``heartbeats=False``) to let the node's
TTL expire.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, Optional

import torch_parity  # noqa: F401  (the port on the CPU)
from nomad_tpu_torch import mock
from nomad_tpu_torch.state import watch
from nomad_tpu_torch.structs import Node, TaskState, consts


class MockClient:
    def __init__(self, server, node: Optional[Node] = None,
                 complete_after: Optional[float] = None):
        self.server = server
        self.logger = logging.getLogger("tests.mock_client")
        self.node = node or mock.node()
        # How long a "task" runs before completing (batch semantics);
        # None means run forever (service semantics).
        self.complete_after = complete_after
        self._stop = threading.Event()
        self._threads = []
        self._seen_index: Dict[str, int] = {}  # alloc id -> alloc_modify_index
        self._started_at: Dict[str, float] = {}
        self.heartbeat_ttl = 0.0
        self.heartbeats = threading.Event()
        self.heartbeats.set()

    # ------------------------------------------------------------------

    def start(self) -> None:
        self.node.status = consts.NODE_STATUS_INIT
        self.server.node_register(self.node)
        self.heartbeat_ttl = self.server.node_update_status(
            self.node.id, consts.NODE_STATUS_READY
        )
        for target in (self._heartbeat_loop, self._watch_allocs):
            t = threading.Thread(target=target, daemon=True)
            t.start()
            self._threads.append(t)

    def stop(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=2.0)

    # ------------------------------------------------------------------

    def _heartbeat_loop(self) -> None:
        while not self._stop.is_set():
            interval = max(self.heartbeat_ttl / 2.0, 0.05)
            if self._stop.wait(interval):
                return
            if not self.heartbeats.is_set():
                continue  # heartbeats stopped: the node's TTL runs out
            try:
                self.heartbeat_ttl = self.server.node_heartbeat(
                    self.node.id, self.node.secret_id
                )
            except Exception:  # noqa: BLE001 - loop must survive
                self.logger.debug(
                    "heartbeat failed; retrying next tick", exc_info=True)

    def _watch_allocs(self) -> None:
        """Long-poll on this node's alloc scope; sync changed allocs'
        client status back (client.go:1125/runAllocs:1285)."""
        state = self.server.fsm.state
        items = [watch.alloc_node(self.node.id)]
        while not self._stop.is_set():
            ev = state.watch(items)
            self._sync_once()
            ev.wait(0.2)
            state.stop_watch(items, ev)

    def _sync_once(self) -> None:
        state = self.server.fsm.state
        updates = []
        now = time.time()
        for alloc in state.allocs_by_node(self.node.id):
            seen = self._seen_index.get(alloc.id, -1)
            task_names = (
                [t.name for t in alloc.job.lookup_task_group(alloc.task_group).tasks]
                if alloc.job and alloc.job.lookup_task_group(alloc.task_group)
                else ["task"]
            )
            if alloc.desired_status == consts.ALLOC_DESIRED_RUN:
                if alloc.client_status == consts.ALLOC_CLIENT_PENDING:
                    updated = alloc.copy()
                    updated.client_status = consts.ALLOC_CLIENT_RUNNING
                    updated.task_states = {
                        name: TaskState(state=consts.TASK_STATE_RUNNING)
                        for name in task_names
                    }
                    updates.append(updated)
                    self._started_at[alloc.id] = now
                elif (
                    alloc.client_status == consts.ALLOC_CLIENT_RUNNING
                    and self.complete_after is not None
                    and now - self._started_at.get(alloc.id, now)
                    >= self.complete_after
                ):
                    updated = alloc.copy()
                    updated.client_status = consts.ALLOC_CLIENT_COMPLETE
                    updated.task_states = {
                        name: TaskState(state=consts.TASK_STATE_DEAD, failed=False)
                        for name in task_names
                    }
                    updates.append(updated)
            elif alloc.desired_status in (
                consts.ALLOC_DESIRED_STOP,
                consts.ALLOC_DESIRED_EVICT,
            ):
                if alloc.client_status in (
                    consts.ALLOC_CLIENT_PENDING,
                    consts.ALLOC_CLIENT_RUNNING,
                ):
                    updated = alloc.copy()
                    updated.client_status = consts.ALLOC_CLIENT_COMPLETE
                    updated.task_states = {
                        name: TaskState(state=consts.TASK_STATE_DEAD, failed=False)
                        for name in task_names
                    }
                    updates.append(updated)
            self._seen_index[alloc.id] = alloc.alloc_modify_index
        if updates:
            try:
                self.server.node_update_allocs(updates)
            except Exception:  # noqa: BLE001 - next watch tick retries
                self.logger.debug(
                    "alloc status sync failed; retried next tick",
                    exc_info=True)


def wait_until(fn, timeout=5.0, interval=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if fn():
            return True
        time.sleep(interval)
    return False
