"""The port's node-sharded mesh path (nomad_tpu_torch/parallel) on W
CPU shards, held against the JAX package's sharded programs on its
8-device virtual CPU mesh (tests/conftest.py) and against the port's
own unsharded programs, on the same numpy inputs from a seed.

Mirrors tests/test_mesh.py and the shard parity items 1, 2 and 4 of
``__graft_entry__._dryrun_shard_parity``; adds the noise windows and
the uniform top-k over shards (independent and pre_resolve) against
the JAX compact program on a sharded base.

Tolerances: the port's sharded results equal its unsharded ones bit
for bit (the same float operations in the same order). Against the JAX
package choices are exact and scores within 1e-4 absolute (float32
pow(10, x) may differ in the last ulp between XLA's and torch's CPU
code); the carried state, sums of the same float32 addends in the
same order, is exact. Group capacities of whole numbers under 2^24 are
exact; a zero ask's 1e9 units a node take a group's sum past 2^24,
where every addition rounds (to within 2^-24 of the sum), so the
shard order and the node order each sit within m x 2^-24 of the exact
sum for a group of m addends, and are held to 2 m x 2^-24 relative of
each other.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (the port on the CPU, one torch thread)

from nomad_tpu.ops import binpack as jb
from nomad_tpu.ops.gang import _group_capacity
from nomad_tpu.parallel import mesh as jmesh
from nomad_tpu.parallel import shard as jshard
from nomad_tpu_torch.ops import binpack as tb
from nomad_tpu_torch.ops.prng import threefry_uniform
from nomad_tpu_torch.parallel import mesh as tmesh
from nomad_tpu_torch.parallel import shard as tshard
from nomad_tpu_torch.parallel.mesh import (
    DP_AXIS,
    NODE_AXIS,
    gather,
    make_mesh,
    shard_placement_inputs,
    sharded_placement,
)

SCORE_TOL = 1e-4
CONFIG = tb.PlacementConfig(anti_affinity_penalty=10.0)
REF_CONFIG = jb.PlacementConfig(anti_affinity_penalty=10.0)


def cpu_mesh(w, dp=1):
    return make_mesh(devices=["cpu"] * (w * dp), dp=dp)


def build_inputs(n=256, k=8, g=2, batch=0, seed=0):
    """tests/test_mesh.py's inputs: per-node variation, and batch
    members that genuinely differ (a stacked batch: a base per eval)."""
    rng = np.random.RandomState(seed)

    def maybe_batch(x):
        if batch:
            out = np.stack([x] * batch)
            if out.dtype in (np.float64, np.float32):
                out = out + (rng.rand(*out.shape) * 8.0).astype(out.dtype)
            return out
        return x

    capacity = np.tile([4000.0, 8192.0, 100000.0, 150.0], (n, 1))
    util = np.stack([rng.randint(0, 2000, n).astype(np.float64),
                     rng.randint(0, 4096, n).astype(np.float64),
                     rng.randint(0, 50000, n).astype(np.float64),
                     np.zeros(n)], axis=1)
    state = jb.make_node_state(
        capacity=maybe_batch(capacity),
        sched_capacity=maybe_batch(capacity * 0.95),
        util=maybe_batch(util),
        bw_avail=maybe_batch(np.full(n, 1000.0)),
        bw_used=maybe_batch(rng.randint(0, 500, n).astype(np.float64)),
        ports_free=maybe_batch(np.full(n, 40000.0)),
        job_count=maybe_batch(rng.randint(0, 2, n).astype(np.int32)),
        tg_count=maybe_batch(np.zeros((n, g), np.int32)),
        feasible=maybe_batch(rng.rand(n, g) > 0.2),
        node_ok=maybe_batch(rng.rand(n) > 0.1))
    asks = jb.make_asks(
        resources=maybe_batch(np.tile([500.0, 256.0, 150.0, 0.0], (k, 1))),
        bw=maybe_batch(np.full(k, 50.0)),
        ports=maybe_batch(np.full(k, 2.0)),
        tg_index=maybe_batch(np.arange(k, dtype=np.int32) % g),
        active=maybe_batch(np.ones(k, bool)),
        job_distinct_hosts=maybe_batch(np.asarray(False)),
        tg_distinct_hosts=maybe_batch(np.zeros(g, bool)))
    if batch:
        keys = np.stack([jb.host_prng_key(seed * 100 + i)
                         for i in range(batch)])
    else:
        keys = jb.host_prng_key(seed)
    return state, asks, keys


def np_state(state):
    return tb.NodeState(*(np.asarray(x) for x in state))


def np_asks(asks):
    return tb.Asks(*(np.asarray(x) for x in asks))


def port_unsharded(state, asks, keys, config, batched):
    st = tb.NodeState(*tb.device_resident(np_state(state), "cpu"))
    ak = tb.Asks(*tb.device_resident(np_asks(asks), "cpu"))
    if batched:
        return tb.batched_placement_program(
            st, ak, tb.keys_tensor(keys, "cpu"), config)
    return tb.placement_program(st, ak, keys, config)


def ref_sharded(w, dp, state, asks, keys, batched, config=REF_CONFIG):
    mesh = jmesh.make_mesh(w * dp, dp=dp)
    return jmesh.sharded_placement(mesh, state, asks, keys, config,
                                   batched=batched)


def assert_same_choices(got, want):
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(want[0]))
    assert np.abs(np.asarray(got[1]) - np.asarray(want[1])).max() \
        <= SCORE_TOL


# ---------------------------------------------------- tests/test_mesh.py


@pytest.mark.parametrize("dp,batched", [(1, False), (2, True), (4, True)])
def test_sharded_matches_unsharded(dp, batched):
    """2x4 / 4x2 / 1x8 meshes: the sharded output equals the port's
    unsharded program bit for bit, carried state included, and the JAX
    package's sharded program on its own 8-device mesh."""
    batch = dp * 2 if batched else 0
    state, asks, keys = build_inputs(n=256, batch=batch)
    mesh = cpu_mesh(8 // dp, dp)
    got_c, got_s, got_final = sharded_placement(
        mesh, np_state(state), np_asks(asks), keys, CONFIG, batched=batched)
    want_c, want_s, want_final = port_unsharded(state, asks, keys, CONFIG,
                                                batched)
    assert torch.equal(got_c, want_c)
    assert torch.equal(got_s, want_s)
    if batched:  # the stacked program returns its carry
        want_final = np_state(state)._replace(**dict(zip(
            ("util", "bw_used", "ports_free", "job_count", "tg_count"),
            want_final)))
    for name in tb.NodeState._fields:
        np.testing.assert_array_equal(
            gather(getattr(got_final, name)).numpy(),
            np.asarray(getattr(want_final, name)), err_msg=f"final.{name}")
    ref_c, ref_s, ref_final = ref_sharded(8 // dp, dp, state, asks, keys,
                                          batched)
    assert_same_choices((got_c, got_s), (ref_c, ref_s))
    for name in ("util", "bw_used", "ports_free", "job_count", "tg_count"):
        np.testing.assert_array_equal(
            gather(getattr(got_final, name)).numpy(),
            np.asarray(getattr(ref_final, name)), err_msg=f"final.{name}")


def test_sharded_uneven_bucket():
    """Node bucket not a power of two (384 = 96 a shard on a 4-way node
    axis) and an odd ask count."""
    state, asks, keys = build_inputs(n=384, k=7, batch=4)
    got = sharded_placement(cpu_mesh(4, 2), np_state(state), np_asks(asks),
                            keys, CONFIG, batched=True)
    want = port_unsharded(state, asks, keys, CONFIG, True)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert_same_choices(got, ref_sharded(4, 2, state, asks, keys, True))


def test_input_shardings_land_on_mesh():
    """shard_placement_inputs splits the node axis over NODE_AXIS and
    the batch over DP_AXIS; the values survive the split."""
    mesh = cpu_mesh(4, 2)
    state, asks, keys = build_inputs(n=256, batch=4)
    state_sh, asks_sh, keys_sh = shard_placement_inputs(
        mesh, np_state(state), np_asks(asks), keys, batched=True)
    assert state_sh.util.spec[:2] == (DP_AXIS, NODE_AXIS)
    assert keys_sh.spec[0] == DP_AXIS
    assert state_sh.util.lo == (0, 64, 128, 192)
    assert tuple(state_sh.util.parts[1][3].shape) == (2, 64, 4)
    assert tuple(asks_sh.resources.parts[0][2].shape) == (2, 8, 4)
    np.testing.assert_array_equal(gather(state_sh.util).numpy(),
                                  np.asarray(state.util))
    np.testing.assert_array_equal(gather(asks_sh.resources).numpy(),
                                  np.asarray(asks.resources))


def test_make_mesh_shapes():
    mesh = cpu_mesh(4, 2)
    assert dict(mesh.shape) == {DP_AXIS: 2, NODE_AXIS: 4}
    mesh = make_mesh(devices=["cpu"] * 8)
    assert dict(mesh.shape) == {DP_AXIS: 1, NODE_AXIS: 8}
    with pytest.raises(ValueError):
        make_mesh(1024)
    with pytest.raises(ValueError):
        make_mesh(devices=["cpu"] * 8, dp=3)
    with pytest.raises(ValueError):
        make_mesh(9, devices=["cpu"] * 8)


def test_make_mesh_never_moves_to_the_cpu(monkeypatch):
    """Asked for more cards than there are, with no ``devices``, it
    raises (JAX's make_mesh falls back to CPU devices; the port does
    not)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert make_mesh(1).devices == ((torch.device("cuda", 0),),)
    with pytest.raises(ValueError, match="need 2 CUDA devices, have 1"):
        make_mesh(2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(ValueError):
        make_mesh()


# ------------------------------------- the graft's shard parity items


def ints(rng, *shape):
    return rng.integers(0, 1000, shape).astype(np.float32)


@pytest.mark.parametrize("w", [2, 4, 8])
def test_sharded_base_delta_across_every_shard(w):
    """Item 1: rows spanning every shard, plus padding rows that repeat
    the first row; the port's shards equal the JAX shard_map program
    and the one-device scatter."""
    rng = np.random.default_rng(16 + w)
    n = 128 * w
    util, bw_used, ports_free = ints(rng, n, 4), ints(rng, n), ints(rng, n)
    node_ok = rng.integers(0, 2, n).astype(bool)
    rows = np.sort(rng.choice(n, 16, replace=False)).astype(np.int32)
    rows = np.concatenate([rows, np.full(8, rows[0], np.int32)])
    vals = (ints(rng, 16, 4), ints(rng, 16), ints(rng, 16),
            rng.integers(0, 2, 16).astype(bool))
    payload = (rows, *(np.concatenate([v, np.repeat(v[:1], 8, 0)])
                       for v in vals))
    got = tshard.sharded_base_delta(cpu_mesh(w))(
        util, bw_used, ports_free, node_ok, *payload)
    ref = jshard.sharded_base_delta(jmesh.make_mesh(w, dp=1))(
        util, bw_used, ports_free, node_ok, *payload)
    one = tb.apply_base_delta(*(torch.from_numpy(x) for x in (
        util, bw_used, ports_free, node_ok, *payload)))
    for g_, r_, o_ in zip(got, ref, one):
        np.testing.assert_array_equal(gather(g_).numpy(), np.asarray(r_))
        np.testing.assert_array_equal(gather(g_).numpy(), o_.numpy())


@pytest.mark.parametrize("w,g_pad", [(2, 16), (4, 16), (8, 16), (4, 2048)])
def test_sharded_group_capacity_with_dropped_ids(w, g_pad):
    """Item 2: a group spans shards (ids stride over the node axis),
    ids -1 drop, and past 1,024 groups. Whole-number units under 2^24:
    every partial is exact, so the shard-order sum equals the JAX psum
    and the one-device node-order sum exactly."""
    rng = np.random.default_rng(2 + w)
    n = 128 * w
    units = ints(rng, n)
    topo_ids = (np.arange(n, dtype=np.int32) % (g_pad - 2))
    topo_ids[:4] = -1
    got = tshard.sharded_group_capacity(cpu_mesh(w), g_pad)(units, topo_ids)
    ref = jshard.sharded_group_capacity(jmesh.make_mesh(w, dp=1), g_pad)(
        units, topo_ids)
    one = _group_capacity(units, topo_ids, g_pad)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(got.numpy(), np.asarray(one))


def test_sharded_group_capacity_past_2_24():
    """A zero ask gives every feasible node 1e9 units: past 2^24 every
    addition rounds, in shard order here and in node order on one
    device; the two are held within 2 m x 2^-24 relative (m addends a
    group), and each within m x 2^-24 of the float64 sum."""
    w, n, g_pad = 8, 1024, 16
    units = np.full(n, 1e9, np.float32)
    topo_ids = (np.arange(n, dtype=np.int32) % 5)
    got = tshard.sharded_group_capacity(cpu_mesh(w), g_pad)(units, topo_ids)
    one = np.asarray(_group_capacity(units, topo_ids, g_pad))
    m = np.bincount(topo_ids, minlength=g_pad).max()
    exact = np.bincount(topo_ids, weights=units.astype(np.float64),
                        minlength=g_pad)
    np.testing.assert_allclose(got.numpy(), one, rtol=2 * m * 2.0 ** -24)
    np.testing.assert_allclose(got.numpy(), exact, rtol=m * 2.0 ** -24)
    np.testing.assert_allclose(one, exact, rtol=m * 2.0 ** -24)


@pytest.mark.parametrize("w", [2, 4, 8])
def test_sharded_placement_noise_on(w):
    """Item 4: the lone placement program on W shards with the
    production noise (noise_scale 2.0): equal to the port's unsharded
    program bit for bit and to the JAX sharded program's choices."""
    state, asks, keys = build_inputs(n=128 * w, seed=w)
    got = sharded_placement(cpu_mesh(w), np_state(state), np_asks(asks),
                            keys, CONFIG)
    want = port_unsharded(state, asks, keys, CONFIG, False)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert_same_choices(got, ref_sharded(w, 1, state, asks, keys, False))


@pytest.mark.parametrize("w", [2, 4, 8])
def test_noise_windows_are_the_global_draws_columns(w):
    """Shard s draws counters k * N + lo + j: its window equals the
    global [K, N] draw's columns, and the JAX draw's."""
    n, k = 96 * w, 5
    keys = tb.keys_tensor(np.stack([jb.host_prng_key(3),
                                    jb.host_prng_key(9)]), "cpu")
    full = threefry_uniform(keys, (k, n), 0.0, 2.0)
    for lo, hi in tmesh.shard_bounds(n, w):
        part = threefry_uniform(keys, (k, hi - lo), 0.0, 2.0,
                                window=(lo, n))
        assert torch.equal(part, full[:, :, lo:hi])
    ref = jax.random.uniform(jax.numpy.asarray(jb.host_prng_key(3)), (k, n),
                             minval=0.0, maxval=2.0)
    np.testing.assert_array_equal(full[0].numpy(), np.asarray(ref))


def test_tie_across_a_shard_boundary_and_no_fit():
    """Equal scores on both sides of a shard boundary (noise off) go to
    the lower global index; a step where no node fits anywhere gives
    -1 and score 0, and the next ask still places."""
    n, k, g, w = 64, 3, 1, 4
    state = jb.make_node_state(
        capacity=np.tile([1000.0, 1000.0, 1000.0, 10.0], (n, 1)),
        sched_capacity=np.tile([1000.0, 1000.0, 1000.0, 10.0], (n, 1)),
        util=np.tile([900.0, 900.0, 0.0, 0.0], (n, 1)),
        bw_avail=np.full(n, 100.0), bw_used=np.zeros(n),
        ports_free=np.full(n, 10.0), job_count=np.zeros(n, np.int32),
        tg_count=np.zeros((n, g), np.int32), feasible=np.ones((n, g), bool),
        node_ok=np.zeros(n, bool))
    ok = np.array(state.node_ok)
    ok[[15, 16, 47]] = True  # 15 | 16 straddle the first boundary
    state = state._replace(node_ok=ok)
    asks = jb.make_asks(
        resources=np.array([[50.0, 50, 0, 0], [500.0, 0, 0, 0],
                            [50.0, 50, 0, 0]]),
        bw=np.zeros(k), ports=np.zeros(k), tg_index=np.zeros(k, np.int32),
        active=np.ones(k, bool), job_distinct_hosts=False,
        tg_distinct_hosts=np.zeros(g, bool))
    key = jb.host_prng_key(1)
    cfg = CONFIG._replace(noise_scale=0.0)
    got = sharded_placement(cpu_mesh(w), np_state(state), np_asks(asks), key,
                            cfg)
    want = port_unsharded(state, asks, key, cfg, False)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert got[0].tolist() == [15, -1, 16]
    assert got[1][1].item() == 0.0
    ref = ref_sharded(w, 1, state, asks, key, False,
                      REF_CONFIG._replace(noise_scale=0.0))
    assert_same_choices(got, ref)


# ------------------------------ uniform top-k and greedy over shards


def compact_batch(n, b, k, g, seed, uniform):
    """A shared cluster base and B compact overlays (class verdicts,
    patch rows and job rows padded with N), with uniform or mixed
    asks."""
    rng = np.random.default_rng(seed)
    cap = np.tile(np.array([4000, 8192, 102400, 150], np.float32), (n, 1))
    sched = cap - np.array([100, 256, 4096, 0], np.float32)
    util = (cap - sched) + np.stack(
        [rng.integers(0, 20, n) * 50, rng.integers(0, 20, n) * 64,
         np.zeros(n), np.zeros(n)], 1).astype(np.float32)
    class_ids = rng.integers(-1, 6, n).astype(np.int32)
    base = (cap, sched, util, np.full(n, 1000, np.float32),
            (rng.integers(0, 10, n) * 50).astype(np.float32),
            rng.integers(0, 7, n).astype(np.float32), rng.random(n) < 0.95,
            class_ids)
    c, p, j = 6, 12, 10
    patch_rows = rng.integers(0, n, (b, p)).astype(np.int32)
    patch_rows[:, -3:] = n
    job_rows = rng.integers(0, n, (b, j)).astype(np.int32)
    job_rows[:, -2:] = n
    overlay = tb.CompactOverlay(
        verdicts=rng.random((b, c, g)) < 0.9, patch_rows=patch_rows,
        patch_vals=rng.random((b, p, g)) < 0.5, job_rows=job_rows,
        job_tgs=rng.integers(0, g, (b, j)).astype(np.int32))
    active = np.ones((b, k), bool)
    active[:, -2:] = False
    tg = np.zeros((b, k), np.int32) if uniform else \
        rng.integers(0, g, (b, k)).astype(np.int32)
    res = np.stack([rng.integers(1, 11, (b, k)) * 100,
                    rng.integers(1, 5, (b, k)) * 128,
                    np.full((b, k), 300), np.zeros((b, k))], 2)
    if uniform:
        res[:] = res[:, :1]
    asks = tb.Asks(
        resources=res.astype(np.float32),
        bw=np.repeat((rng.integers(0, 3, (b, 1)) * 50).astype(np.float32),
                     k, 1),
        ports=np.ones((b, k), np.float32), tg_index=tg, active=active,
        job_distinct_hosts=np.zeros(b, bool),
        tg_distinct_hosts=np.tile(np.arange(g) == 0, (b, 1)))
    keys = np.stack([jb.host_prng_key(seed * 10 + i) for i in range(b)])
    return base, overlay, asks, keys


@pytest.mark.parametrize("uniform", [True, False], ids=["uniform", "greedy"])
@pytest.mark.parametrize("pre_resolve", [False, True],
                         ids=["independent", "pre_resolve"])
@pytest.mark.parametrize("w", [2, 8])
def test_compact_dispatch_over_shards(w, pre_resolve, uniform):
    """The batcher's compact dispatch over a node-sharded base (K3 with
    a row offset, then K10d or K10c) against the JAX compact program
    on a base sharded over its mesh, and the port's unsharded compact
    program."""
    n, b, k, g = 64 * w, 5, 12, 2
    base, overlay, asks, keys = compact_batch(n, b, k, g, 40 + w, uniform)
    cfg = CONFIG._replace(pre_resolve=pre_resolve, uniform_dh=uniform)
    dev = tmesh.upload_base(cpu_mesh(w), base)
    host = [keys.astype(np.int64), *asks, *overlay]
    placed, _ = tmesh.place_payload(dev, host, True)
    got = tmesh.sharded_dispatch(dev, placed, True, cfg)
    flat = tb.device_resident([*base, *overlay, *asks], "cpu")
    want = tb.batched_placement_program_compact(
        *flat[:8], tb.CompactOverlay(*flat[8:13]), tb.Asks(*flat[13:]),
        tb.keys_tensor(keys, "cpu"), cfg)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    jmesh_ = jmesh.make_mesh(w, dp=1)
    from jax.sharding import NamedSharding

    jbase = jax.device_put(tuple(base), tuple(
        NamedSharding(jmesh_, s) for s in jmesh.base_specs()))
    rcfg = REF_CONFIG._replace(pre_resolve=pre_resolve, uniform_dh=uniform)
    ref = jb.batched_placement_program_compact(
        *jbase, jb.CompactOverlay(*overlay), jb.Asks(*asks), keys, rcfg)
    assert_same_choices(got, ref)
    assert (np.asarray(got[0]) >= 0).sum() > 0


def test_dense_overlay_dispatch_over_shards():
    """The dense overlay layout (job_count, tg_count, feasible split
    over the nodes) equals the compact one on the same evals."""
    w, n, b, k, g = 4, 256, 3, 8, 2
    base, overlay, asks, keys = compact_batch(n, b, k, g, 7, False)
    cfg = CONFIG._replace(pre_resolve=True)
    dev = tmesh.upload_base(cpu_mesh(w), base)
    host = [keys.astype(np.int64), *asks, *overlay]
    compact = tmesh.sharded_dispatch(
        dev, tmesh.place_payload(dev, host, True)[0], True, cfg)
    cid = torch.from_numpy(base[7])
    feas, jc, tgc = tb.expand_overlay(cid, tb.CompactOverlay(
        *(torch.from_numpy(np.asarray(x)) for x in overlay)), n)
    host = [keys.astype(np.int64), *asks, jc.numpy(), tgc.numpy(),
            feas.numpy()]
    dense = tmesh.sharded_dispatch(
        dev, tmesh.place_payload(dev, host, False)[0], False, cfg)
    assert torch.equal(compact[0], dense[0])
    assert torch.equal(compact[1], dense[1])


def test_registered_kernel_has_no_sharded_form():
    """The registered convex kernel dispatched over a sharded base (the
    compact layout, K10g), against the JAX compact program on a base
    sharded over its mesh: choices equal, scores within SCORE_TOL (the
    cross-shard softmax sums in another order). The port's unsharded
    compact program gives the same choices and scores."""
    base, overlay, asks, keys = compact_batch(128, 2, 4, 2, 3, False)
    cfg = CONFIG._replace(kernel="convex")
    dev = tmesh.upload_base(cpu_mesh(2), base)
    placed, _ = tmesh.place_payload(
        dev, [keys.astype(np.int64), *asks, *overlay], True)
    got = tmesh.sharded_dispatch(dev, placed, True, cfg)
    from jax.sharding import NamedSharding

    jm = jmesh.make_mesh(2, dp=1)
    jbase = jax.device_put(tuple(base), tuple(
        NamedSharding(jm, s) for s in jmesh.base_specs()))
    ref = jb.batched_placement_program_compact(
        *jbase, jb.CompactOverlay(*overlay), jb.Asks(*asks), keys,
        REF_CONFIG._replace(kernel="convex"))
    assert_same_choices(got, ref)
    flat = tb.device_resident([*base, *overlay, *asks], "cpu")
    want = tb.batched_placement_program_compact(
        *flat[:8], tb.CompactOverlay(*flat[8:13]), tb.Asks(*flat[13:]),
        tb.keys_tensor(keys, "cpu"), cfg)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert (np.asarray(got[0]) >= 0).sum() > 0


def test_per_shard_occupancy():
    base, _o, _a, _k = compact_batch(256, 1, 4, 2, 5, False)
    occ = tshard.per_shard_occupancy(tmesh.upload_base(cpu_mesh(4), base))
    assert [e["shard"] for e in occ] == [0, 1, 2, 3]
    assert all(e["rows"] == 64 for e in occ)
    total = sum(np.asarray(x).nbytes for x in base)
    assert sum(e["bytes"] for e in occ) == total
    one = tshard.per_shard_occupancy(tuple(
        torch.from_numpy(np.asarray(x)) for x in base))
    assert len(one) == 1 and one[0]["rows"] == 256
