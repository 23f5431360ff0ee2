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
"""

from __future__ import annotations

from typing import Sequence

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


def threefry_uniform_plain(keys: torch.Tensor, shape: Sequence[int],
                           minval: float, maxval: float) -> torch.Tensor:
    """The plain PyTorch version: one eval row at a time, so the int64
    temporaries stay at one row's size."""
    batch = keys.shape[0]
    per_eval = int(np.prod(shape, dtype=np.int64))
    out = torch.empty((batch, per_eval), dtype=torch.float32,
                      device=keys.device)
    counter = torch.arange(per_eval, dtype=torch.int64, device=keys.device)
    hi = counter >> 32
    lo = counter & _MASK
    lo_f = torch.tensor(minval, dtype=torch.float32, device=keys.device)
    scale = float(np.float32(maxval) - np.float32(minval))
    for b in range(batch):
        k0 = keys[b, 0] & _MASK
        k1 = keys[b, 1] & _MASK
        x0, x1 = threefry2x32_plain(k0, k1, hi, lo)
        bits = (x0 ^ x1) >> 9 | 0x3F800000
        f = bits.to(torch.int32).view(torch.float32) - 1.0
        fma = (f.double() * scale + float(lo_f)).float()
        out[b] = torch.maximum(lo_f, fma)
    return out.reshape((batch, *shape))


def threefry_uniform(keys: torch.Tensor, shape: Sequence[int],
                     minval: float, maxval: float) -> torch.Tensor:
    """float32[B, *shape] noise, row b drawn from key ``keys[b]``.

    ``keys`` is int64[B, 2] holding the two uint32 key words (the
    layout of ``binpack.host_prng_key``). Replaces
    ``jax.random.uniform(key, shape, minval, maxval)`` vmapped over the
    keys (ops/binpack.py:320,384 of the JAX package). On the card:
    csrc/threefry.cu, integer-ALU bound (20 rounds per 4-byte store);
    one thread per element, no shared memory.
    """
    if keys.dtype != torch.int64 or keys.dim() != 2 or keys.shape[1] != 2:
        raise ValueError(f"keys must be int64[B, 2], got {keys.dtype} "
                         f"{tuple(keys.shape)}")
    if keys.device.type == "cpu":
        return threefry_uniform_plain(keys, shape, minval, maxval)
    if keys.device.type != "cuda":
        raise ValueError(f"unsupported device {keys.device}")
    keys = keys.contiguous()
    batch = keys.shape[0]
    per_eval = int(np.prod(shape, dtype=np.int64))
    out = torch.empty((batch, *shape), dtype=torch.float32,
                      device=keys.device)
    scale = float(np.float32(maxval) - np.float32(minval))
    cuda.launch("nt_threefry_uniform", keys.data_ptr(), out.data_ptr(),
                per_eval, batch, float(np.float32(minval)), scale,
                cuda.stream_ptr(keys.device))
    cuda.count_launch("threefry_uniform")
    return out
