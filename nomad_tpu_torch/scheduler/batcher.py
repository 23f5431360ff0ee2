"""Placement batcher, synchronous subset: one eval's placement dispatch
on the calling thread, against a device-resident cluster base.

The port of the JAX package's scheduler/batcher.py without its
coalescing window, dispatcher threads and cohorts (a later slice):
``place()`` runs its request as a batch of one, at once. What it keeps:

- the device-base cache: the job-independent [N,4] base arrays of one
  cluster snapshot (models/matrix.py _ClusterBase, identified by its
  token) move to the device once and stay there, LRU-cached
  (DEVICE_BASE_CACHE, a hit refreshes recency);
- base deltas: a base derived from a cached parent ships only its
  changed rows (ROW_BUCKETS padding) and derives the child on the
  device — fused into the compact dispatch itself when this request is
  the one that first needs the child;
- the compact path: per-eval overlays cross in their compact form and
  expand on the device (ops/binpack.py expand_overlay);
- the lone path: a state with no base token runs as it is.

A device fault raises out of ``place()``; there is no host fallback.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Dict, Optional

import numpy as np
import torch

from ..device import default_device

# Cluster bases kept on device.
DEVICE_BASE_CACHE = 8

# Changed-row padding ladder for base deltas.
ROW_BUCKETS = (256, 4096)


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


def _delta_payload(base, rows):
    """The changed rows of a base delta, padded (``_pad_rows``), with
    the child's values of the four mutable arrays at those rows."""
    rows_p = _pad_rows(rows)
    return (rows_p, np.asarray(base[2])[rows_p], np.asarray(base[4])[rows_p],
            np.asarray(base[5])[rows_p], np.asarray(base[6])[rows_p])


def _stack(tuples, device):
    """Stack a list of same-typed NamedTuples of host arrays along a
    new leading batch axis, as tensors on ``device``."""
    cls = type(tuples[0])
    return cls(*(torch.from_numpy(np.stack([np.asarray(x) for x in xs]))
                 .to(device) for xs in zip(*tuples)))


class PlacementBatcher:
    """Runs placement dispatches on one device, caching cluster bases
    there."""

    def __init__(self, device: Optional[torch.device] = None):
        self.device = torch.device(device) if device is not None \
            else default_device()
        self._lock = threading.Lock()
        self._device_bases: "OrderedDict[object, tuple]" = OrderedDict()  # guarded-by: _lock
        self.dispatches = 0  # guarded-by: _lock
        self.lone_dispatches = 0  # guarded-by: _lock
        self.overlay_dispatches = 0  # guarded-by: _lock
        self.compact_dispatches = 0  # guarded-by: _lock
        self.base_uploads = 0  # guarded-by: _lock
        self.base_delta_updates = 0  # guarded-by: _lock
        self.fused_delta_updates = 0  # guarded-by: _lock
        self.bytes_upload = 0  # guarded-by: _lock
        # Wall time inside place(): uploads, kernels and the copy back
        # (the results' .cpu() waits for the device).
        self.t_place = 0.0  # guarded-by: _lock

    # ------------------------------------------------------------ bases

    def _tensor(self, x) -> torch.Tensor:
        return torch.from_numpy(np.array(x, copy=True)).to(self.device)

    def _cache_put(self, token, dev) -> None:
        with self._lock:
            while len(self._device_bases) >= DEVICE_BASE_CACHE:
                self._device_bases.popitem(last=False)
            self._device_bases[token] = dev

    def _cache_get(self, token):
        with self._lock:
            dev = self._device_bases.get(token)
            if dev is not None:
                # True LRU: a hit refreshes recency.
                self._device_bases.move_to_end(token)
            return dev

    def _device_base(self, token, base, delta):
        """The device copy of one cluster base: a cache hit, a delta
        derived from a cached parent (only the changed rows cross), or
        a full upload."""
        dev = self._cache_get(token)
        if dev is not None:
            return dev
        if delta is not None:
            parent_token, rows = delta
            parent = self._cache_get(parent_token)
            if parent is not None and rows:
                from ..ops.binpack import apply_base_delta

                payload = _delta_payload(base, rows)
                util2, bw2, ports2, ok2 = apply_base_delta(
                    parent[2], parent[4], parent[5], parent[6],
                    *(self._tensor(x) for x in payload))
                # capacity/sched_capacity/bw_avail/class_ids never
                # change with allocs: share the parent's device tensors.
                dev = (parent[0], parent[1], util2, parent[3], bw2, ports2,
                       ok2, parent[7])
                with self._lock:
                    self.base_delta_updates += 1
                    self.bytes_upload += sum(x.nbytes for x in payload)
                self._cache_put(token, dev)
                return dev
        dev = tuple(self._tensor(x) for x in base)
        with self._lock:
            self.base_uploads += 1
            self.bytes_upload += sum(np.asarray(x).nbytes for x in base)
        self._cache_put(token, dev)
        return dev

    def _claim_fused_delta(self, token, delta):
        """The parent device base when ``token``'s base can be derived
        INSIDE this compact dispatch (the child is not cached yet and
        its parent is), else None."""
        if delta is None:
            return None
        parent_token, rows = delta
        if not rows or self._cache_get(token) is not None:
            return None
        return self._cache_get(parent_token)

    # ------------------------------------------------------------ place

    def place(self, state, asks, rng_key, config):
        """Run one eval's placement. ``state`` is a ClusterMatrix (or
        anything with the NodeState field names); ``asks`` the host
        Asks arrays; ``rng_key`` a host uint32[2]. Returns (choices,
        scores) as host numpy arrays."""
        t0 = time.perf_counter()
        try:
            return self._place(state, asks, rng_key, config)
        finally:
            with self._lock:
                self.t_place += time.perf_counter() - t0

    def _place(self, state, asks, rng_key, config):
        from ..ops import binpack

        token = getattr(state, "base_token", None)
        class_ids = getattr(state, "class_ids", None)
        if class_ids is None:
            class_ids = np.full(np.shape(state.node_ok), -1, np.int32)
        base = (state.capacity, state.sched_capacity, state.util,
                state.bw_avail, state.bw_used, state.ports_free,
                state.node_ok, class_ids)
        keys = binpack.keys_tensor(rng_key, self.device)
        if token is None:
            # Unshared lone request: nothing cacheable, dispatch as-is.
            st = binpack.NodeState(*(self._tensor(x) for x in (
                state.capacity, state.sched_capacity, state.util,
                state.bw_avail, state.bw_used, state.ports_free,
                state.job_count, state.tg_count, state.feasible,
                state.node_ok)))
            choices, scores, _ = binpack.placement_program(
                st, binpack.Asks(*(self._tensor(x) for x in asks)),
                rng_key, config)
            with self._lock:
                self.dispatches += 1
                self.lone_dispatches += 1
            return choices.cpu().numpy(), scores.cpu().numpy()

        asks_b = _stack([asks], self.device)
        compact = getattr(state, "compact_overlay", None)
        delta = getattr(state, "base_delta", None)
        if compact is not None:
            overlays = _stack([compact], self.device)
            parent = self._claim_fused_delta(token, delta)
            if parent is not None:
                # The changed rows ride this dispatch; the derived
                # child base comes back with the results.
                payload = _delta_payload(base, delta[1])
                (choices, scores, util2, bw2, ports2, ok2) = \
                    binpack.batched_placement_program_compact_delta(
                        *parent, *(self._tensor(x) for x in payload),
                        overlays, asks_b, keys, config)
                self._cache_put(token, (parent[0], parent[1], util2,
                                        parent[3], bw2, ports2, ok2,
                                        parent[7]))
                with self._lock:
                    self.base_delta_updates += 1
                    self.fused_delta_updates += 1
                    self.bytes_upload += sum(x.nbytes for x in payload)
            else:
                dev = self._device_base(token, base, delta)
                choices, scores, _ = \
                    binpack.batched_placement_program_compact(
                        *dev, overlays, asks_b, keys, config)
            with self._lock:
                self.compact_dispatches += 1
        else:
            dev = self._device_base(token, base, delta)
            st = binpack.NodeState(
                capacity=dev[0], sched_capacity=dev[1], util=dev[2],
                bw_avail=dev[3], bw_used=dev[4], ports_free=dev[5],
                job_count=self._tensor(state.job_count)[None],
                tg_count=self._tensor(state.tg_count)[None],
                feasible=self._tensor(state.feasible)[None],
                node_ok=dev[6])
            choices, scores, _ = binpack.batched_placement_program_overlay(
                st, asks_b, keys, config)
        with self._lock:
            self.dispatches += 1
            self.overlay_dispatches += 1
        return choices[0].cpu().numpy(), scores[0].cpu().numpy()

    def stats(self) -> dict:
        with self._lock:
            return {
                "device": str(self.device),
                "dispatches": self.dispatches,
                "lone_dispatches": self.lone_dispatches,
                "overlay_dispatches": self.overlay_dispatches,
                "compact_dispatches": self.compact_dispatches,
                "base_uploads": self.base_uploads,
                "base_delta_updates": self.base_delta_updates,
                "fused_delta_updates": self.fused_delta_updates,
                "upload_bytes": int(self.bytes_upload),
                "place_us": int(self.t_place * 1e6),
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
