"""Placement batcher: coalesce concurrent evaluations into one device
dispatch (the port of the JAX package's scheduler/batcher.py).

Evals drained in a storm batch into a single device program: N
workers' placement requests with the same bucketed shapes ride one
dispatch instead of N serial ones, and the per-dispatch cost (the
Python call, the transfers, the copy back) is paid once per batch.

Requests are grouped by shape key (node bucket, ask bucket, group
count, config, base token, compact overlay sizes): only same-shaped
requests can share a dispatch. Within a batch the paths are:

- lone: one request with no base token dispatches as it is;
- shared base: every request names one *cluster base* (the
  job-independent [N,4] arrays, models/matrix.py _ClusterBase,
  identified by its token); the base moves to the device once and is
  LRU-cached there, and the dispatch moves only the per-eval overlays,
  asks and keys. With compact overlays the overlays expand on the
  device (ops/binpack.py batched_placement_program_compact), and a
  base derived from a cached parent ships only its changed rows, fused
  into the dispatch (``_compact_delta``); dense overlays take
  batched_placement_program_overlay;
- mixed bases: the full states stack along the batch axis
  (batched_placement_program).

Under ``PlacementConfig.pre_resolve`` (the server default) the evals of
a shared-base batch run in order over one copy of the claimed
capacity, so each sees what the earlier ones claimed.

Given a ``mesh`` (parallel/mesh.py), a base of SHARD_MIN_NODES or more
nodes lives sharded over the mesh's node axis: its upload splits into
per-shard slices, a delta child derives shard by shard (K10a), and the
shared-base dispatches run over the shards (K3 with a row offset, then
K10c or K10d for the greedy kernel, K10g for the convex kernel). The
lone and stacked paths stay unsharded. The mesh is explicit: without
one, nothing shards.

Two ways in: concurrent ``place()`` calls queue by shape key and one of
them (or a dispatcher thread) dispatches the batch after an adaptive
window; ``place_cohort()`` dispatches a pre-formed cohort on the
calling thread, with no queue and no parking.

The runtime rides along as in the JAX package: the batcher's lock and
condition are profiled (site ``scheduler.batcher``), a parked place()
counts in the ``batcher.place`` convoy tracker and stamps its wake
latency as ``batch_park`` run-queue delay, and every request that
carries a trace identity gets one ``device.solve`` span per dispatch.

A device fault raises out of ``place()`` and ``place_cohort()``; there
is no host fallback.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import profile, trace
from ..device import default_device
from ..profile import ProfiledCondition, ProfiledLock

MAX_BATCH = 64
# Node count at which a batcher given a mesh keeps the cluster base
# sharded over the mesh's node axis (parallel/): below this the per
# shard slices are too small to pay for the cross-shard steps.
SHARD_MIN_NODES = 2048
# Idle-batcher accumulation window: a drained group's place() calls
# arrive staggered by their GIL-serialized host phases, so a too-small
# window ships a near-empty first dispatch. Adaptive: a large measured
# dispatch round-trip widens it up to WINDOW_MAX_S.
WINDOW_S = 0.02
WINDOW_MAX_S = 0.12
RESPAWN_WINDOW_S = 0.005  # post-dispatch window: catch GIL stragglers
# Cluster bases kept on device: a storm's wave snapshots plus the delta
# parents they derive from (evicting a parent forces the next delta
# into a full upload).
DEVICE_BASE_CACHE = 8
# In-flight dispatches allowed per shape key: the next batch
# accumulates and uploads while the last one runs.
MAX_INFLIGHT = 3
# Requester park slice while its batch is in flight: a dead dispatcher
# is noticed within two slices.
REQUEST_WAIT_SLICE_S = 0.1
# Ceiling on cohort-extended accumulation (add_cohort): an announced
# eval that never places must not wedge the dispatcher.
COHORT_WAIT_MAX = 1.0
# How long a dispatcher waits for another's build of the same base.
PENDING_WAIT_S = 30.0

# Shape-bucket ladders: every distinct padded size is a distinct set of
# launch shapes, so the ladders are coarse.
ROW_BUCKETS = (256, 4096)
BATCH_BUCKETS = (4, 16, 64)


def _pad_rows(rows) -> np.ndarray:
    """Pad a changed-row index list up to a ladder bucket; padding
    repeats the FIRST changed row, and a duplicate-index write of the
    identical value is benign."""
    n = len(rows)
    for b in ROW_BUCKETS:
        if n <= b:
            k = b
            break
    else:
        k = 1 << (n - 1).bit_length()
    rows_p = np.full(k, rows[0], np.int32)
    rows_p[:n] = rows
    return rows_p


def _pad_batch(n: int, max_batch: int) -> int:
    for b in BATCH_BUCKETS:
        if n <= b <= max_batch:
            return b
    return max_batch


def _delta_payload(base, rows):
    """The changed rows of a base delta, padded (``_pad_rows``), with
    the child's values of the four mutable arrays at those rows."""
    rows_p = _pad_rows(rows)
    return (rows_p, np.asarray(base[2])[rows_p], np.asarray(base[4])[rows_p],
            np.asarray(base[5])[rows_p], np.asarray(base[6])[rows_p])


def _stack(items) -> list:
    """Stack same-typed NamedTuples of host arrays field by field along
    a new leading batch axis."""
    return [np.stack([np.asarray(x) for x in xs]) for xs in zip(*items)]


class _Request:
    __slots__ = ("token", "base", "overlay", "compact", "asks", "key",
                 "delta", "event", "choices", "scores", "error", "span",
                 "ready_at")

    def __init__(self, token, base, overlay, asks, key, delta=None,
                 compact=None, span=None):
        self.token = token  # cluster-base identity, None = unshared
        self.base = base  # (capacity, sched_capacity, util, bw_avail,
        #                    bw_used, ports_free, node_ok, class_ids)
        self.overlay = overlay  # (job_count, tg_count, feasible)
        # Pre-expansion overlay (ops/binpack.py CompactOverlay): when
        # every request of a shared-base batch carries one, only a few
        # KB cross per eval and the dense overlays are rebuilt on the
        # device.
        self.compact = compact
        self.asks = asks
        self.key = key
        self.delta = delta  # (parent_token, changed_rows) or None
        self.span = span  # (eval_id, trace_id) for the device.solve span
        self.event = threading.Event()
        self.choices = None
        self.scores = None
        self.error: Optional[BaseException] = None
        # Stamped (time.monotonic) by the dispatcher right before
        # event.set(): the parked requester's wake latency from here is
        # its run-queue delay (profile record_runq "batch_park").
        self.ready_at = 0.0

    def full_state(self) -> tuple:
        """The NodeState field order: capacity .. feasible, node_ok."""
        b, o = self.base, self.overlay
        return (b[0], b[1], b[2], b[3], b[4], b[5], o[0], o[1], o[2], b[6])


def _base_of(state):
    """(token, base arrays, delta) of a place() state: a ClusterMatrix
    or anything with the NodeState field names."""
    class_ids = getattr(state, "class_ids", None)
    if class_ids is None:
        # Plain NodeState callers: no class index, no compact path.
        class_ids = np.full(np.shape(state.node_ok), -1, np.int32)
    base = (state.capacity, state.sched_capacity, state.util,
            state.bw_avail, state.bw_used, state.ports_free,
            state.node_ok, class_ids)
    return (getattr(state, "base_token", None), base,
            getattr(state, "base_delta", None))


def _request(state, asks, rng_key, config, span=None):
    """(shape key, _Request) for one place() argument set."""
    token, base, delta = _base_of(state)
    overlay = (state.job_count, state.tg_count, state.feasible)
    compact = getattr(state, "compact_overlay", None)
    # The token joins the key: same-token requests share one dispatch
    # through the device-cached base. Compact padding sizes join it
    # too: stacking needs every request of a batch to share them.
    compact_key = None if compact is None else (
        np.shape(compact.verdicts)[0],
        np.shape(compact.patch_rows)[0],
        np.shape(compact.job_rows)[0],
    )
    shape_key = (
        np.shape(state.capacity), np.shape(asks.resources),
        np.shape(state.feasible)[-1], config, token, compact_key,
    )
    return shape_key, _Request(token, base, overlay, asks, rng_key,
                               delta=delta, compact=compact, span=span)


class PlacementBatcher:
    """Coalesces placement dispatches on one device across scheduler
    threads, caching cluster bases there."""

    def __init__(self, device: Optional[torch.device] = None,
                 max_batch: int = MAX_BATCH, window: float = WINDOW_S,
                 mesh=None):
        self.device = torch.device(device) if device is not None \
            else default_device()
        if mesh is not None and mesh.shape["dp"] != 1:
            raise ValueError("the batcher shards the node axis only: give "
                             f"it a dp = 1 mesh, not {mesh.shape}")
        # parallel/mesh.py Mesh (dp = 1) over which big bases shard.
        self.mesh = mesh
        self.max_batch = max_batch
        self.window = window
        self.logger = logging.getLogger("nomad_tpu_torch.batcher")
        # Profiled (profile/): the hot lock of the dense path; its
        # wait and hold histograms attribute the device.dispatch tail.
        self._lock = ProfiledLock("scheduler.batcher")
        # Signaled by place() when a shape's queue reaches max_batch and
        # by cohort changes, so an accumulating dispatcher wakes at once.
        self._full = ProfiledCondition(self._lock, "scheduler.batcher")
        self._queues: Dict[Tuple, List[_Request]] = {}  # guarded-by: _lock
        self._dispatchers: Dict[Tuple, int] = {}  # guarded-by: _lock
        self._device_bases: "OrderedDict[object, tuple]" = OrderedDict()  # guarded-by: _lock
        # token -> Event while an upload or derivation is in progress:
        # concurrent dispatchers on one token wait for it instead of
        # each paying the transfer this cache exists to avoid.
        self._base_pending: Dict[object, threading.Event] = {}  # guarded-by: _lock
        self.dispatches = 0  # guarded-by: _lock (device calls issued)
        self.batched_requests = 0  # guarded-by: _lock (requests served)
        # Dispatches issued inline by place_cohort; a subset of
        # `dispatches`.
        self.cohort_dispatches = 0  # guarded-by: _lock
        self.lone_dispatches = 0  # guarded-by: _lock
        self.overlay_dispatches = 0  # guarded-by: _lock (shared base)
        self.compact_dispatches = 0  # guarded-by: _lock (device expand)
        self.pre_resolve_dispatches = 0  # guarded-by: _lock
        self.base_uploads = 0  # guarded-by: _lock (full uploads)
        self.base_delta_updates = 0  # guarded-by: _lock (derived bases)
        self.fused_delta_updates = 0  # guarded-by: _lock (inside a dispatch)
        # Bases made device-resident sharded over the mesh: full uploads
        # and delta derivations from a sharded parent alike.
        self.sharded_bases = 0  # guarded-by: _lock
        # Per-dispatch cost breakdown (seconds and bytes, cumulative):
        # host stacking and the payload upload, kernel issue, and the
        # copy back of the results (which waits for the device).
        self.t_stack = 0.0  # guarded-by: _lock
        self.t_issue = 0.0  # guarded-by: _lock
        self.t_sync = 0.0  # guarded-by: _lock
        self.t_upload = 0.0  # guarded-by: _lock (base uploads)
        self.bytes_overlay = 0  # guarded-by: _lock (dispatch payload)
        self.bytes_upload = 0  # guarded-by: _lock (base payload)
        # EMA of the copy-back wait, drives the adaptive window.
        self._sync_ema = 0.0  # guarded-by: _lock
        # Requests ANNOUNCED but not yet arrived (add_cohort): dispatch
        # accumulation waits for them. _cohort_gen bumps on every cohort
        # change: an expiring dispatcher zeroes only a cohort that was
        # inert through its whole wait.
        self._cohort = 0  # guarded-by: _lock
        self._cohort_gen = 0  # guarded-by: _lock

    # ------------------------------------------------------------ cohorts

    def add_cohort(self, n: int) -> None:
        """Announce that ``n`` place() calls are on their way. Dispatch
        accumulation extends past its window while announced requests
        are outstanding, bounded by COHORT_WAIT_MAX."""
        if n <= 0:
            return
        with self._full:
            self._cohort += n
            self._cohort_gen += 1
            self._full.notify_all()

    def cohort_cancel(self, n: int = 1) -> None:
        """Repay an announced place() that will never arrive. Floors at
        zero: a double repayment only un-stretches the window."""
        with self._full:
            self._cohort = max(0, self._cohort - n)
            self._cohort_gen += 1
            self._full.notify_all()

    # ------------------------------------------------------------ place

    def place(self, state, asks, rng_key, config, span=None):
        """Submit one eval's placement; blocks until its batch's
        dispatch returns. ``state`` is a ClusterMatrix (or anything with
        the NodeState field names; a ``base_token`` enables the shared
        device base); ``asks`` the host Asks arrays; ``rng_key`` a host
        uint32[2]; ``span`` an optional (eval_id, trace_id) on which the
        dispatch records a ``device.solve`` span. Returns (choices,
        scores) of THIS request as host numpy arrays."""
        shape_key, req = _request(state, asks, rng_key, config, span)
        run_dispatch = False
        with self._lock:
            if self._cohort > 0:
                self._cohort -= 1
                self._cohort_gen += 1
            q = self._queues.setdefault(shape_key, [])
            q.append(req)
            if len(q) >= self.max_batch:
                self._full.notify_all()
            if self._dispatchers.get(shape_key, 0) == 0:
                # First in on an idle shape: this thread dispatches.
                self._dispatchers[shape_key] = 1
                run_dispatch = True
        if run_dispatch:
            self._dispatch(shape_key, config, wait_window=True)
        # Bounded park: slices with an ownership re-check, so a
        # dispatcher that could not spawn cannot wedge this thread.
        # Ownership has a legal gap (between a dispatcher's queue pop
        # and its finally), so act only on the SECOND ownerless look.
        # This wait is the batch boundary: the profiler's convoy tracker
        # measures the pile-up here, and ready_at -> wake is the
        # thread's run-queue delay.
        suspect = False
        if not req.event.is_set():
            parked = profile.park("batcher.place")
            try:
                while not req.event.wait(REQUEST_WAIT_SLICE_S):
                    claim = orphaned = False
                    with self._lock:
                        live = self._dispatchers.get(shape_key, 0)
                        queued = any(
                            r is req
                            for r in self._queues.get(shape_key, ()))
                        if live > 0:
                            suspect = False
                        elif suspect and queued:
                            # Self-rescue: still queued with no
                            # dispatcher (a respawn's Thread.start
                            # failed): dispatch inline.
                            self._dispatchers[shape_key] = 1
                            claim = True
                        elif suspect:
                            orphaned = True
                        else:
                            suspect = True
                    if claim:
                        self._dispatch(shape_key, config,
                                       wait_window=False)
                    elif orphaned and not req.event.is_set():
                        raise RuntimeError(
                            "placement request orphaned: no live "
                            "dispatcher for its shape key and the "
                            "request left the queue without a result")
            finally:
                if parked:
                    profile.unpark("batcher.place")
        if req.ready_at:
            profile.record_runq(
                "batch_park", (time.monotonic() - req.ready_at) * 1000.0)
        if req.error is not None:
            raise req.error
        return req.choices, req.scores

    def place_cohort(self, requests):
        """Dispatch a pre-formed cohort on the CALLING thread: requests
        group by place()'s shape key, chunk to max_batch, and each chunk
        runs ``_run_batch`` inline. No queues, no events, no dispatcher
        threads. ``requests`` is a list of (state, asks, rng_key,
        config, span) tuples as place() takes them (``span`` None where
        nothing is traced). Returns [(choices, scores)] in input order;
        a device fault raises out of the whole call."""
        built = [(*_request(state, asks, rng_key, config, span), config)
                 for state, asks, rng_key, config, span in requests]
        groups: "OrderedDict[Tuple, List[_Request]]" = OrderedDict()
        configs: Dict[Tuple, object] = {}
        for shape_key, req, config in built:
            groups.setdefault(shape_key, []).append(req)
            configs[shape_key] = config
        for shape_key, reqs in groups.items():
            for at in range(0, len(reqs), self.max_batch):
                chunk = reqs[at:at + self.max_batch]
                self._run_batch(chunk, configs[shape_key])
                with self._lock:
                    self.dispatches += 1
                    self.batched_requests += len(chunk)
                    self.cohort_dispatches += 1
        return [(req.choices, req.scores) for _k, req, _c in built]

    # ------------------------------------------------------------ bases

    def _cache_put(self, token, dev) -> None:
        """Insert a device base, evicting the least recent; the caller
        holds _lock."""
        while len(self._device_bases) >= DEVICE_BASE_CACHE:
            self._device_bases.popitem(last=False)
        self._device_bases[token] = dev

    def _device_base(self, token, base, delta=None):
        """The device copy of one cluster base, LRU-cached: a hit, a
        delta derived from a cached parent (only the changed rows
        cross), or a full upload. One builder per token: concurrent
        callers wait for its cache insert. Returns (base, bytes that
        crossed)."""
        while True:
            with self._lock:
                cached = self._device_bases.get(token)
                if cached is not None:
                    # True LRU: a hit refreshes recency.
                    self._device_bases.move_to_end(token)
                    return cached, 0
                pending = self._base_pending.get(token)
                if pending is None:
                    done = threading.Event()
                    self._base_pending[token] = done
                    break
            pending.wait(PENDING_WAIT_S)
        try:
            return self._build_device_base(token, base, delta)
        finally:
            with self._lock:
                self._base_pending.pop(token, None)
            done.set()

    def prefetch_base(self, state) -> int:
        """Make ``state``'s cluster base device-resident now, on the
        caller's thread, so a later dispatch finds it cached. Returns
        the bytes that crossed (0 on a hit or for an un-tokened
        state)."""
        token, base, delta = _base_of(state)
        if token is None:
            return 0
        with self._lock:
            if token in self._device_bases:
                return 0
        _dev, nbytes = self._device_base(token, base, delta)
        return int(nbytes)

    def _base_mesh(self, n: int):
        """The mesh a base of ``n`` nodes shards over: None without a
        mesh, below SHARD_MIN_NODES, or when n does not split evenly
        over the node axis (bucketing should prevent that)."""
        mesh = self.mesh
        if mesh is None or n < SHARD_MIN_NODES:
            return None
        if n % mesh.shape["nodes"]:
            return None
        return mesh

    def _build_device_base(self, token, base, delta):
        from ..ops.binpack import apply_base_delta, device_resident
        from ..parallel.mesh import is_sharded, upload_base

        t0 = time.perf_counter()
        dev = None
        if delta is not None:
            parent_token, rows = delta
            with self._lock:
                parent = self._device_bases.get(parent_token)
            if parent is not None and rows:
                payload = _delta_payload(base, rows)
                nbytes = sum(x.nbytes for x in payload)
                if is_sharded(parent[0]):
                    # A sharded parent: the payload replicates, and each
                    # shard keeps the rows of its slice (K10a).
                    from ..parallel.shard import sharded_base_delta

                    util2, bw2, ports2, ok2 = sharded_base_delta(
                        self.mesh)(parent[2], parent[4], parent[5],
                                   parent[6], *payload)
                else:
                    util2, bw2, ports2, ok2 = apply_base_delta(
                        parent[2], parent[4], parent[5], parent[6],
                        *device_resident(payload, self.device))
                # capacity/sched_capacity/bw_avail/class_ids never
                # change with allocs: share the parent's device tensors.
                dev = (parent[0], parent[1], util2, parent[3], bw2, ports2,
                       ok2, parent[7])
        delta_derived = dev is not None
        if dev is None:
            mesh = self._base_mesh(np.shape(base[0])[0])
            if mesh is not None:
                dev = upload_base(mesh, base)
            else:
                dev = device_resident(base, self.device)
            nbytes = sum(np.asarray(x).nbytes for x in base)
        with self._lock:
            self.t_upload += time.perf_counter() - t0
            self.bytes_upload += nbytes
            if delta_derived:
                self.base_delta_updates += 1
            else:
                self.base_uploads += 1
            if is_sharded(dev[0]):
                self.sharded_bases += 1
            self._cache_put(token, dev)
        return dev, nbytes

    def _claim_fused_delta(self, token, delta):
        """Claim the right to derive ``token``'s base INSIDE the compact
        dispatch (batched_placement_program_compact_delta): the child is
        neither cached nor being built, and its parent is cached.
        Returns (parent device base, changed rows, done event), else
        None. A claim registers ``done`` in _base_pending[token]; the
        caller caches the derived base, clears the slot and sets the
        event, and concurrent dispatchers on the token wait on it."""
        if delta is None:
            return None
        parent_token, rows = delta
        if not rows:
            return None
        with self._lock:
            if token in self._device_bases or token in self._base_pending:
                return None
            parent = self._device_bases.get(parent_token)
            if parent is None:
                return None
            if not isinstance(parent[0], torch.Tensor):
                # A sharded parent derives through _build_device_base
                # (K10a, shard by shard): the fused program runs on one
                # device.
                return None
            self._device_bases.move_to_end(parent_token)
            done = threading.Event()
            self._base_pending[token] = done
        return parent, rows, done

    # ------------------------------------------------------------ dispatch

    def _run_batch(self, batch: List[_Request], config) -> None:
        """One device dispatch for ``batch`` (same shape key); sets
        every request's choices and scores."""
        from ..ops import binpack

        t0 = time.perf_counter()
        token = batch[0].token
        if len(batch) == 1 and token is None:
            # Unshared lone request: nothing cacheable, dispatch as is.
            req = batch[0]
            st = binpack.NodeState(*binpack.device_resident(
                req.full_state(), self.device))
            t1 = time.perf_counter()
            choices, scores, _ = binpack.placement_program(
                st, binpack.Asks(*binpack.device_resident(
                    req.asks, self.device)), req.key, config)
            t2 = time.perf_counter()
            req.choices = choices.cpu().numpy()
            req.scores = scores.cpu().numpy()
            t3 = self._account(t0, t1, t2, 0, lone=True)
            self._record_solve(batch, config, t3 - t1, 1)
            return

        n_live = len(batch)
        overlay = token is not None and all(r.token == token for r in batch)
        compact = overlay and batch[0].compact is not None
        fused = None
        try:
            if compact:
                fused = self._claim_fused_delta(token, batch[0].delta)
            dev = None
            if overlay and not fused:
                dev, _ = self._device_base(token, batch[0].base,
                                           batch[0].delta)
            # A node-sharded base (parallel/mesh.py): the payload goes
            # to every shard and the dispatch runs over the shards.
            sharded = dev is not None and not isinstance(dev[0],
                                                         torch.Tensor)
            # Pad the batch axis up a ladder bucket: padding rows repeat
            # the last request (under pre_resolve they scan after the
            # real rows) and their outputs are dropped. Only the native
            # greedy scan on one device is padded, and it runs one block
            # per eval, so its padding rows cost no time. A registered
            # kernel's work grows with every row (the convex relaxation
            # is [B,K,N]), and so does a sharded scan's (every row is
            # work in each shard's launches, and under pre_resolve K10c
            # and K10d issue theirs eval by eval): they get the live
            # rows.
            n_rows = (_pad_batch(n_live, self.max_batch)
                      if config.kernel == "greedy" and not sharded
                      else n_live)
            padded = batch + [batch[-1]] * (n_rows - n_live)
            keys = np.stack([np.asarray(r.key, np.uint32)
                             for r in padded]).astype(np.int64)
            host = [keys, *_stack([r.asks for r in padded])]
            if compact:
                host += _stack([r.compact for r in padded])
            elif overlay:
                host += _stack([r.overlay for r in padded])
            else:
                host += _stack([r.full_state() for r in padded])
            if fused:
                host += list(_delta_payload(batch[0].base, fused[1]))
            payload = sum(x.nbytes for x in host)
            if sharded:
                from ..parallel.mesh import place_payload, sharded_dispatch

                # One copy a distinct device: the dispatch payload.
                placed, payload = place_payload(dev, host, compact)
            else:
                up = binpack.device_resident(host, self.device)
                keys_t, asks = up[0], binpack.Asks(*up[1:8])
                rest = up[8:]
            t1 = time.perf_counter()
            if sharded:
                choices, scores = sharded_dispatch(dev, placed, compact,
                                                   config)
            elif fused:
                parent = fused[0]
                overlays = binpack.CompactOverlay(*rest[:5])
                (choices, scores, util2, bw2, ports2, ok2) = \
                    binpack.batched_placement_program_compact_delta(
                        *parent, *rest[5:], overlays, asks, keys_t, config)
                with self._lock:
                    self.base_delta_updates += 1
                    self.fused_delta_updates += 1
                    self.bytes_upload += sum(x.nbytes for x in host[-5:])
                    self._cache_put(token, (parent[0], parent[1], util2,
                                            parent[3], bw2, ports2, ok2,
                                            parent[7]))
            elif compact:
                choices, scores, _ = \
                    binpack.batched_placement_program_compact(
                        *dev, binpack.CompactOverlay(*rest), asks, keys_t,
                        config)
            elif overlay:
                state = binpack.NodeState(
                    capacity=dev[0], sched_capacity=dev[1], util=dev[2],
                    bw_avail=dev[3], bw_used=dev[4], ports_free=dev[5],
                    job_count=rest[0], tg_count=rest[1], feasible=rest[2],
                    node_ok=dev[6])
                choices, scores, _ = \
                    binpack.batched_placement_program_overlay(
                        state, asks, keys_t, config)
            else:
                choices, scores, _ = binpack.batched_placement_program(
                    binpack.NodeState(*rest), asks, keys_t, config)
            t2 = time.perf_counter()
            choices = choices.cpu().numpy()
            scores = scores.cpu().numpy()
        finally:
            if fused:
                with self._lock:
                    self._base_pending.pop(token, None)
                fused[2].set()
        t3 = self._account(t0, t1, t2, payload, overlay=overlay,
                           compact=compact,
                           pre_resolve=overlay and config.pre_resolve)
        for i, req in enumerate(batch):
            req.choices = choices[i]
            req.scores = scores[i]
        self._record_solve(batch, config, t3 - t1, n_live)

    def _account(self, t0, t1, t2, payload, lone=False, overlay=False,
                 compact=False, pre_resolve=False) -> float:
        """Record one dispatch's timings (stack t0..t1, issue t1..t2,
        sync t2..now) and path counters. Returns now (perf_counter)."""
        t3 = time.perf_counter()
        with self._lock:
            self.t_stack += t1 - t0
            self.t_issue += t2 - t1
            self.t_sync += t3 - t2
            self.bytes_overlay += payload
            self.lone_dispatches += lone
            self.overlay_dispatches += overlay
            self.compact_dispatches += compact
            self.pre_resolve_dispatches += pre_resolve
            sync = t3 - t2
            self._sync_ema = (sync if self._sync_ema == 0.0
                              else 0.7 * self._sync_ema + 0.3 * sync)
        return t3

    def _record_solve(self, batch, config, dur: float, n_live: int) -> None:
        """device.solve spans for the requests that carry a trace
        identity: the issue + copy-back window (t1..t3 of _account),
        kernel-annotated, the part of device.dispatch that is the
        kernel (batch wait and host stacking excluded). The duration
        was measured on perf_counter; the span is anchored to the
        monotonic clock the recorder runs on by subtracting it from
        now (both clocks tick at the same rate)."""
        if not any(r.span for r in batch):
            return
        end = time.monotonic()
        ann = {"kernel": config.kernel, "batch": n_live}
        for req in batch:
            if req.span:
                trace.record_span(req.span[0], trace.STAGE_DEVICE_SOLVE,
                                  end - dur, end, ann=ann,
                                  trace_id=req.span[1])

    def _accumulate(self, shape_key, window: float) -> None:
        """Wait up to ``window`` for requests to pile on; a full batch
        dispatches at once. A live cohort (announced requests still on
        their way) extends the wait past the window, bounded by
        COHORT_WAIT_MAX."""
        start = time.monotonic()
        deadline = start + window
        hard = start + COHORT_WAIT_MAX
        gen_seen = None  # cohort generation when we began extending
        with self._full:
            while len(self._queues.get(shape_key, ())) < self.max_batch:
                now = time.monotonic()
                if now >= deadline:
                    if self._cohort <= 0:
                        return
                    if gen_seen is None:
                        gen_seen = self._cohort_gen
                    if now >= hard:
                        # Zero the hint only if it was INERT the whole
                        # time: an active counter belongs to a batch
                        # whose announcements are still arriving.
                        if self._cohort_gen == gen_seen:
                            self._cohort = 0
                            self._cohort_gen += 1
                        return
                    self._full.wait(min(0.002, hard - now))
                    continue
                self._full.wait(deadline - now)

    def _spawn_dispatcher(self, shape_key, config) -> None:
        t = threading.Thread(
            target=self._dispatch, args=(shape_key, config, False),
            daemon=True, name="placement-batch")
        try:
            t.start()
        except (RuntimeError, OSError):
            # OS thread pressure: un-claim the slot the caller counted
            # for us; a parked requester self-rescues (place()).
            with self._lock:
                remaining = self._dispatchers.get(shape_key, 1) - 1
                if remaining > 0:
                    self._dispatchers[shape_key] = remaining
                else:
                    self._dispatchers.pop(shape_key, None)
            self.logger.warning(
                "placement dispatcher thread failed to spawn; parked "
                "requesters will self-rescue", exc_info=True)

    def _dispatch(self, shape_key, config, wait_window: bool) -> None:
        """Accumulate, pop and run one batch of ``shape_key``. The
        caller has counted us in _dispatchers; the finally counts us
        out and respawns if work remains. Everything runs under the
        error handler: a dispatcher that died without setting its
        requests' events would wedge them."""
        batch: List[_Request] = []
        popped = False
        try:
            with self._lock:
                sync_ema = self._sync_ema
            if wait_window and self.window > 0:
                self._accumulate(shape_key, min(
                    WINDOW_MAX_S, max(self.window, sync_ema * 0.5)))
            elif not wait_window:
                self._accumulate(shape_key, max(
                    RESPAWN_WINDOW_S, min(WINDOW_MAX_S, sync_ema * 0.5)))
            with self._lock:
                waiting = self._queues.pop(shape_key, [])
                batch = waiting[:self.max_batch]
                if waiting[self.max_batch:]:
                    # Overflow rides the next dispatch.
                    self._queues[shape_key] = waiting[self.max_batch:]
                popped = True
                # Overlap: work already waiting gets its dispatcher NOW,
                # so its accumulation and upload run under our dispatch.
                overlap = (bool(self._queues.get(shape_key))
                           and self._dispatchers.get(shape_key, 0)
                           < MAX_INFLIGHT)
                if overlap:
                    self._dispatchers[shape_key] += 1
            if overlap:
                self._spawn_dispatcher(shape_key, config)
            if not batch:
                return
            self._run_batch(batch, config)
            with self._lock:
                self.dispatches += 1
                self.batched_requests += len(batch)
        except BaseException as e:  # noqa: BLE001 - reaches every request
            with self._lock:
                # Died before the pop: the queued requests were ours.
                if not popped:
                    batch = self._queues.pop(shape_key, [])
            for req in batch:
                req.error = e
        finally:
            ready = time.monotonic()
            for req in batch:
                req.ready_at = ready
                req.event.set()
            with self._lock:
                remaining = self._dispatchers.get(shape_key, 1) - 1
                spawn = bool(self._queues.get(shape_key)) and remaining == 0
                if spawn:
                    remaining = 1
                if remaining > 0:
                    self._dispatchers[shape_key] = remaining
                else:
                    # Every new base token mints a new shape key: drop
                    # the dead entries.
                    self._dispatchers.pop(shape_key, None)
            if spawn:
                self._spawn_dispatcher(shape_key, config)

    def shard_occupancy(self) -> list:
        """[{shard, device, rows, bytes}] per node shard of the newest
        resident base (parallel/shard.py per_shard_occupancy): one row
        for an unsharded base, none before the first upload."""
        from ..parallel.shard import per_shard_occupancy

        with self._lock:
            dev = next(reversed(self._device_bases.values()), None)
        return [] if dev is None else per_shard_occupancy(dev)

    def stats(self) -> dict:
        with self._lock:
            return {
                "device": str(self.device),
                "dispatches": self.dispatches,
                "batched_requests": self.batched_requests,
                # Requests per dispatch.
                "occupancy": (self.batched_requests / self.dispatches
                              if self.dispatches else 0.0),
                "cohort_dispatches": self.cohort_dispatches,
                "lone_dispatches": self.lone_dispatches,
                "overlay_dispatches": self.overlay_dispatches,
                "compact_dispatches": self.compact_dispatches,
                "pre_resolve_dispatches": self.pre_resolve_dispatches,
                "base_uploads": self.base_uploads,
                "base_delta_updates": self.base_delta_updates,
                "fused_delta_updates": self.fused_delta_updates,
                "sharded_bases": self.sharded_bases,
                # Cumulative; divide by `dispatches` for per-dispatch.
                "stack_us": int(self.t_stack * 1e6),
                "issue_us": int(self.t_issue * 1e6),
                "sync_us": int(self.t_sync * 1e6),
                "upload_us": int(self.t_upload * 1e6),
                "payload_bytes": int(self.bytes_overlay),
                "upload_bytes": int(self.bytes_upload),
                "cached_bases": len(self._device_bases),
            }


_batchers: Dict[torch.device, PlacementBatcher] = {}
_batchers_lock = threading.Lock()


def get_batcher(device: Optional[torch.device] = None) -> PlacementBatcher:
    """The process's batcher for ``device`` (default: the port's
    default device)."""
    device = torch.device(device) if device is not None else default_device()
    with _batchers_lock:
        b = _batchers.get(device)
        if b is None:
            b = _batchers[device] = PlacementBatcher(device)
        return b
