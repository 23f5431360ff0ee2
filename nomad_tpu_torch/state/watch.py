"""Scoped watch notifications powering blocking queries.

Reference: nomad/watch/watch.go:11 (Item — one-scope-per-item keys) and
nomad/notify.go:7 (NotifyGroup). A watcher subscribes to a set of scoped
items; every state-store write transaction notifies the union of the
scopes it touched.
"""

from __future__ import annotations

import threading
from typing import Dict, FrozenSet, Iterable, Set, Tuple

# A watch item is a (kind, key) pair, e.g. ("table", "nodes"),
# ("alloc_job", job_id), ("eval", eval_id), ("node", node_id).
Item = Tuple[str, str]


def table(name: str) -> Item:
    return ("table", name)


def job(job_id: str) -> Item:
    return ("job", job_id)


def job_summary(job_id: str) -> Item:
    return ("job_summary", job_id)


def node(node_id: str) -> Item:
    return ("node", node_id)


def eval_item(eval_id: str) -> Item:
    return ("eval", eval_id)


def alloc(alloc_id: str) -> Item:
    return ("alloc", alloc_id)


def alloc_job(job_id: str) -> Item:
    return ("alloc_job", job_id)


def alloc_node(node_id: str) -> Item:
    return ("alloc_node", node_id)


def alloc_eval(eval_id: str) -> Item:
    return ("alloc_eval", eval_id)


class NotifyGroup:
    """Fan-out notification: wait on any of a set of items.

    Two consumer shapes: per-query Events (``watch``/``stop_watch``,
    the thread-parking blocking query) and process-wide sinks
    (``subscribe``), callables invoked with every commit's item list —
    the read-plane multiplexer's wake feed. Sinks run OUTSIDE the
    group lock, on the committing (FSM) thread, so they must be cheap
    and non-blocking (the mux only appends to a deque and signals its
    own condition)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._watchers: Dict[Item, Set[threading.Event]] = {}
        self._sinks: list = []  # guarded-by: _lock (copy-on-write)

    def watch(self, items: Iterable[Item]) -> threading.Event:
        ev = threading.Event()
        with self._lock:
            for item in items:
                self._watchers.setdefault(item, set()).add(ev)
        return ev

    def stop_watch(self, items: Iterable[Item], ev: threading.Event) -> None:
        with self._lock:
            for item in items:
                group = self._watchers.get(item)
                if group:
                    group.discard(ev)
                    if not group:
                        del self._watchers[item]

    def subscribe(self, sink) -> None:
        """Register a commit sink: called with every notify()'s item
        list (a materialized list, safe to retain)."""
        with self._lock:
            self._sinks = self._sinks + [sink]

    def unsubscribe(self, sink) -> None:
        with self._lock:
            self._sinks = [s for s in self._sinks if s is not sink]

    def notify(self, items: Iterable[Item]) -> None:
        items = list(items)
        fired: Set[threading.Event] = set()
        with self._lock:
            sinks = self._sinks
            for item in items:
                for ev in self._watchers.get(item, ()):
                    fired.add(ev)
        for ev in fired:
            ev.set()
        for sink in sinks:
            sink(items)
