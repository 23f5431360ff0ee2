"""K0: tie-break noise, bit-identical to ``jax.random.uniform``.

The JAX package draws its placement noise with
``jax.random.uniform(key, shape, 0, noise_scale)`` (ops/binpack.py:320
and :384 there): threefry2x32 under ``jax_threefry_partitionable``
(the default of the JAX it runs), from a raw ``uint32[2]`` key. This
module computes the same float32 values from the same key words:

- element i of the flattened shape hashes the 64-bit counter i, as the
  pair (i >> 32, i & 0xffffffff), under the key (k0, k1);
- its 32 bits are the XOR of the two output words;
- the float is ``(bits >> 9 | 0x3f800000) - 1`` in [0, 1), then
  ``max(minval, f * (maxval - minval) + minval)``, where XLA rounds the
  multiply-add once (a fused multiply-add); the plain version forms it
  in float64, which is exact, and rounds once.

Bit-identical noise is what lets the port's plans be held against the
JAX package's at the production ``noise_scale=2.0``, not only at zero
noise.

``threefry_uniform`` launches the CUDA kernel (csrc/threefry.cu) for a
CUDA tensor of keys and runs ``threefry_uniform_plain`` for a CPU one.
The main path's scans take a ``Draw`` (the keys and the draw's
geometry) and draw the same values inside their own kernels (K2; K1
where that beats K0, ``scan.draws``), or K0 draws them first for K1
to read.

``fold_in`` derives a key on the host as ``jax.random.fold_in`` does
(the gang program's group noise draws from ``fold_in(key, 1)``): one
threefry2x32 hash of the counter pair (0, data), the words of
``threefry_seed(data)`` for a 32-bit ``data``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from . import cuda

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) | (x >> (32 - d))) & _MASK


def threefry2x32_plain(k0: torch.Tensor, k1: torch.Tensor,
                       x0: torch.Tensor, x1: torch.Tensor):
    """threefry2x32 over int64 tensors holding uint32 values (torch's
    uint32 arithmetic is thin, so every sum is masked to 32 bits)."""
    k2 = k0 ^ k1 ^ 0x1BD11BDA
    ks = (k0, k1, k2)
    x0 = (x0 + k0) & _MASK
    x1 = (x1 + k1) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def fold_in(key, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)`` for a raw uint32[2] threefry
    key, computed on the host: the new key is threefry2x32 under
    ``key`` of the counter pair (0, data). Returns a uint32[2]."""
    k0, k1 = (torch.tensor(int(w), dtype=torch.int64)
              for w in np.asarray(key, np.uint32).reshape(2))
    x0, x1 = threefry2x32_plain(k0, k1, torch.tensor(0, dtype=torch.int64),
                                torch.tensor(int(data) & _MASK,
                                             dtype=torch.int64))
    return np.array([int(x0), int(x1)], np.uint32)


def _draw_shape(shape, window):
    """(rows, cols, total_cols, lo) of a draw: ``shape``'s last axis is
    the column window [lo, lo + cols) of a [rows, total_cols] draw."""
    shape = tuple(int(x) for x in shape)
    cols = shape[-1] if shape else 1
    rows = int(np.prod(shape[:-1], dtype=np.int64)) if shape else 1
    lo, total = window if window is not None else (0, cols)
    if not 0 <= lo <= lo + cols <= total:
        raise ValueError(f"window [{lo}, {lo + cols}) outside {total} "
                         "columns")
    return rows, cols, int(total), int(lo)


def threefry_uniform_plain(keys: torch.Tensor, shape: Sequence[int],
                           minval: float, maxval: float,
                           window=None) -> torch.Tensor:
    """The plain PyTorch version: one eval row at a time, so the int64
    temporaries stay at one row's size."""
    batch = keys.shape[0]
    rows, cols, total, lo = _draw_shape(shape, window)
    dev = keys.device
    out = torch.empty((batch, rows * cols), dtype=torch.float32, device=dev)
    counter = (torch.arange(rows, dtype=torch.int64, device=dev)[:, None]
               * total + lo
               + torch.arange(cols, dtype=torch.int64, device=dev)[None, :]
               ).reshape(-1)
    hi = counter >> 32
    lo_w = counter & _MASK
    lo_f = torch.tensor(minval, dtype=torch.float32, device=dev)
    scale = float(np.float32(maxval) - np.float32(minval))
    for b in range(batch):
        k0 = keys[b, 0] & _MASK
        k1 = keys[b, 1] & _MASK
        x0, x1 = threefry2x32_plain(k0, k1, hi, lo_w)
        bits = (x0 ^ x1) >> 9 | 0x3F800000
        f = bits.to(torch.int32).view(torch.float32) - 1.0
        fma = (f.double() * scale + float(lo_f)).float()
        out[b] = torch.maximum(lo_f, fma)
    return out.reshape((batch, *shape))


class Draw(NamedTuple):
    """A batch's tie-break noise as the main path's scans take it
    (csrc/greedy_scan.cu, csrc/uniform_topk.cu: drawn in the kernel
    through csrc/common.cuh nt_noise_at, or read from K0's tensor of the
    same values): eval b's value at (row r, column j)
    is K0's, under ``keys[b]``, of the counter r x total + lo + j, where
    the rows are a greedy scan's K steps (one row for the uniform
    top-K) and the columns its nodes; the values lie in [0, scale).
    ``keys`` is int64 [B, 2] on the scan's device; ``total`` None is the
    scan's own node count (the whole draw), and (lo, total) a node
    shard's window of it. ``noise`` draws the same values with the plain
    version, as a tensor: the CPU route and the tests' yardstick."""

    keys: torch.Tensor
    scale: float
    lo: int = 0
    total: Optional[int] = None

    @property
    def scale32(self) -> float:
        """The noise's maxval (minval 0) as float32, as K0 scales."""
        return float(np.float32(self.scale))

    def columns(self, n: int) -> int:
        """The draw's total columns for a scan over ``n`` nodes."""
        total = n if self.total is None else int(self.total)
        if not 0 <= self.lo <= self.lo + n <= total:
            raise ValueError(f"draw window [{self.lo}, {self.lo + n}) "
                             f"outside {total} columns")
        return total

    def noise(self, shape: Sequence[int]) -> torch.Tensor:
        """float32 [B, *shape]: the values the kernel draws, by
        ``threefry_uniform_plain``."""
        return threefry_uniform_plain(
            self.keys, shape, 0.0, self.scale,
            (self.lo, self.columns(int(shape[-1]))))


# csrc/threefry.cu: most threads a block (NT_TF_THREADS), columns a
# thread (NT_TF_PER).
NOISE_THREADS = 256
NOISE_PER = 4


def noise_launch(cols: int) -> tuple:
    """(runs, threads) of K0's launch for rows of ``cols`` columns: a
    block a (eval, row) pair and run of ``4 x threads`` columns, the
    fewest threads (a multiple of 32, up to 256) that give a row's
    columns to one run where they fit, else runs of 256 threads."""
    groups = max(1, -(-cols // NOISE_PER))
    threads = min(NOISE_THREADS, -(-groups // 32) * 32)
    return -(-groups // threads), threads


def threefry_uniform(keys: torch.Tensor, shape: Sequence[int],
                     minval: float, maxval: float,
                     window=None) -> torch.Tensor:
    """float32[B, *shape] noise, row b drawn from key ``keys[b]``.

    ``keys`` is int64[B, 2] holding the two uint32 key words (the
    layout of ``binpack.host_prng_key``). Replaces
    ``jax.random.uniform(key, shape, minval, maxval)`` vmapped over the
    keys (ops/binpack.py:320,384 of the JAX package). ``window`` =
    (lo, total) draws columns [lo, lo + shape[-1]) of the
    ``(*shape[:-1], total)`` draw: element (r, j) hashes counter
    r * total + lo + j, so the node shards of a mesh
    (nomad_tpu_torch/parallel) draw exactly the unsharded noise's
    columns. On the card: csrc/threefry.cu, integer-ALU bound; a block
    an (eval, row) pair and run of columns, four counters and one
    16-byte store a thread. The main path's scans take a ``Draw`` and
    draw their own noise where that is faster (ops/scan.py).
    """
    if keys.dtype != torch.int64 or keys.dim() != 2 or keys.shape[1] != 2:
        raise ValueError(f"keys must be int64[B, 2], got {keys.dtype} "
                         f"{tuple(keys.shape)}")
    if keys.device.type == "cpu":
        return threefry_uniform_plain(keys, shape, minval, maxval, window)
    if keys.device.type != "cuda":
        raise ValueError(f"unsupported device {keys.device}")
    rows, cols, total, lo = _draw_shape(shape, window)
    keys = keys.contiguous()
    batch = keys.shape[0]
    out = torch.empty((batch, *shape), dtype=torch.float32,
                      device=keys.device)
    scale = float(np.float32(maxval) - np.float32(minval))
    runs, threads = noise_launch(cols)
    with cuda.on_device(keys.device):  # the keys' card, whichever is current
        cuda.launch("nt_threefry_uniform", keys.data_ptr(), out.data_ptr(),
                    rows, cols, total, lo, batch, runs, threads,
                    float(np.float32(minval)), scale,
                    cuda.stream_ptr(keys.device))
    cuda.count_launch("threefry_uniform")
    return out
