"""K0 (nomad_tpu_torch/ops/prng.py): the port's threefry2x32 noise is
bit-identical to jax.random.uniform on the same raw key, at the shapes
of the placement programs' noise draws. The port runs its plain
PyTorch version here (CPU tensors)."""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (the port on the CPU, one torch thread)

from nomad_tpu.ops.binpack import host_prng_key as jax_host_prng_key
from nomad_tpu_torch.ops import binpack as port_binpack
from nomad_tpu_torch.ops.prng import threefry_uniform

SHAPES = [(8, 128), (16, 256), (1, 10240)]


def _bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.uint32)


def _port(keys, shape, minval=0.0, maxval=2.0):
    keys = np.asarray(keys, np.uint32).reshape(-1, 2)
    t = torch.from_numpy(keys.astype(np.int64))
    return threefry_uniform(t, shape, minval, maxval).numpy()


@pytest.mark.parametrize("shape", SHAPES)
def test_bits_equal_for_host_prng_key_7(shape):
    key = jax_host_prng_key(7)
    want = jax.random.uniform(key, shape, minval=0.0, maxval=2.0)
    got = _port(key, shape)[0]
    assert np.array_equal(_bits(want), _bits(got))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bits_equal_for_random_seeds(shape, seed):
    rng = np.random.default_rng(100 + seed)
    key = jax_host_prng_key(int(rng.integers(0, 2**31)))
    want = jax.random.uniform(key, shape, minval=0.0, maxval=2.0)
    assert np.array_equal(_bits(want), _bits(_port(key, shape)[0]))


def test_bits_equal_for_full_width_keys_and_batch():
    """Both key words random (not the host_prng_key layout), several
    keys at once: row b is jax.random.uniform under key b (the vmap
    form)."""
    rng = np.random.default_rng(7)
    keys = rng.integers(0, 2**32, (5, 2), dtype=np.uint64).astype(np.uint32)
    got = _port(keys, (4, 300))
    for b, key in enumerate(keys):
        want = jax.random.uniform(key, (4, 300), minval=0.0, maxval=2.0)
        assert np.array_equal(_bits(want), _bits(got[b]))


def test_bits_equal_with_nonzero_minval():
    """XLA forms f * (max - min) + min as one fused multiply-add; the
    port rounds it once too."""
    key = np.array([123456789, 987654321], np.uint32)
    want = jax.random.uniform(key, (5, 700), minval=-1.5, maxval=3.0)
    assert np.array_equal(_bits(want), _bits(_port(key, (5, 700), -1.5,
                                                   3.0)[0]))


def test_host_key_layout_matches_reference():
    for seed in (0, 7, 2**31 - 1, 2**32 + 5):
        assert np.array_equal(port_binpack.host_prng_key(seed),
                              jax_host_prng_key(seed))
    keys = port_binpack.keys_tensor(port_binpack.host_prng_key(9), "cpu")
    assert keys.dtype == torch.int64 and tuple(keys.shape) == (1, 2)
    assert keys.tolist() == [[0, 9]]


def test_wrapper_rejects_bad_keys():
    with pytest.raises(ValueError):
        threefry_uniform(torch.zeros((2, 2), dtype=torch.int32), (4,), 0, 1)
    with pytest.raises(ValueError):
        threefry_uniform(torch.zeros((2, 3), dtype=torch.int64), (4,), 0, 1)
