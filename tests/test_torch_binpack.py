"""The port's placement programs (nomad_tpu_torch/ops/binpack.py, the
plain PyTorch versions of kernels K1-K3 on CPU tensors) against the JAX
package's on the same inputs.

Data is integer-valued float32 (as __graft_entry__.py's parity checks
use), so every sum is exact; noise is drawn at the production scale of
2.0 from the same key. Choices must be identical, final utilization
equal, and scores within 1e-4 absolute: the BestFit-v3 score takes two
float32 pow(10, x), where XLA's and torch's CPU pow may differ in the
last ulp."""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (the port on the CPU, one torch thread)

from nomad_tpu.ops import binpack as jb
from nomad_tpu_torch import carry
from nomad_tpu_torch.ops import binpack as tb

SCORE_TOL = 1e-4


def world(seed, n, k, g=2, uniform=False, dh=True):
    rng = np.random.default_rng(seed)

    def ints(lo, hi, *shape):
        return rng.integers(lo, hi, shape).astype(np.float32)

    cap = ints(2000, 9000, n, 4)
    sched = cap - ints(0, 300, n, 4)
    state = jb.make_node_state(
        capacity=cap, sched_capacity=sched,
        util=(cap - sched) + ints(0, 1500, n, 4),
        bw_avail=ints(500, 1000, n), bw_used=ints(0, 400, n),
        ports_free=ints(0, 30, n),
        job_count=rng.integers(0, 2, n).astype(np.int32),
        tg_count=rng.integers(0, 2, (n, g)).astype(np.int32),
        feasible=rng.random((n, g)) < 0.85,
        node_ok=rng.random(n) < 0.92)
    if uniform:
        res = np.tile(ints(50, 600, 1, 4), (k, 1))
        tgi = np.zeros(k, np.int32)
    else:
        res = ints(50, 600, k, 4)
        tgi = rng.integers(0, g, k).astype(np.int32)
    active = np.ones(k, bool)
    active[k - max(1, k // 8):] = False  # a padding tail
    tg_dh = np.zeros(g, bool)
    tg_dh[0] = dh
    asks = jb.make_asks(res, ints(0, 60, k), ints(0, 3, k), tgi, active,
                        bool(uniform and dh), tg_dh)
    key = jb.host_prng_key(int(rng.integers(0, 2**31)))
    return state, asks, key


def run_port(state, asks, key, config):
    choices, scores, final = tb.placement_program(
        carry.node_state_from_numpy(state, "cpu"),
        carry.asks_from_numpy(asks, "cpu"), key, config)
    return choices.numpy(), scores.numpy(), final


def assert_same(want, got):
    (c_j, s_j, f_j), (c_t, s_t, f_t) = want, got
    np.testing.assert_array_equal(np.asarray(c_j), c_t)
    assert np.abs(np.asarray(s_j) - s_t).max() <= SCORE_TOL
    np.testing.assert_array_equal(np.asarray(f_j.util), f_t.util.numpy())
    np.testing.assert_array_equal(np.asarray(f_j.job_count),
                                  f_t.job_count.numpy())
    np.testing.assert_array_equal(np.asarray(f_j.tg_count),
                                  f_t.tg_count.numpy())


@pytest.mark.parametrize("seed,n,k", [(0, 128, 8), (1, 256, 64),
                                      (2, 512, 128), (3, 128, 256)])
def test_greedy_placement_program_matches(seed, n, k):
    state, asks, key = world(seed, n, k)
    cj = jb.PlacementConfig(anti_affinity_penalty=10.0)
    ct = tb.PlacementConfig(anti_affinity_penalty=10.0)
    want = jb.placement_program_jit(state, asks, key, cj)
    got = run_port(state, asks, key, ct)
    assert_same(want, got)
    assert (got[0] >= 0).sum() > 0


@pytest.mark.parametrize("seed,n,k", [(4, 128, 8), (5, 256, 64),
                                      (6, 1024, 512)])
def test_uniform_dh_placement_program_matches(seed, n, k):
    state, asks, key = world(seed, n, k, uniform=True)
    cj = jb.PlacementConfig(anti_affinity_penalty=5.0, uniform_dh=True)
    ct = tb.PlacementConfig(anti_affinity_penalty=5.0, uniform_dh=True)
    want = jb.placement_program_jit(state, asks, key, cj)
    assert_same(want, run_port(state, asks, key, ct))


def test_asks_padding_past_node_bucket():
    """count > cluster size (after tests/test_uniform_dh.py:63): the
    ask bucket (256) exceeds the node bucket (128); top-k clamps to N
    and the surplus asks report -1, as the K-step scan does."""
    n, k = 128, 256
    state, asks, key = world(7, n, k, uniform=True)
    state = state._replace(
        feasible=np.ones_like(state.feasible),
        node_ok=np.ones_like(state.node_ok),
        job_count=np.zeros_like(state.job_count),
        tg_count=np.zeros_like(state.tg_count),
        ports_free=np.full(n, 100.0, np.float32),
        util=state.sched_capacity * 0 + (state.capacity
                                         - state.sched_capacity),
        bw_used=np.zeros(n, np.float32))
    active = np.ones(k, bool)
    active[200:] = False
    asks = asks._replace(active=active)
    cj = jb.PlacementConfig(anti_affinity_penalty=10.0, uniform_dh=True)
    ct = tb.PlacementConfig(anti_affinity_penalty=10.0, uniform_dh=True)
    want = jb.placement_program_jit(state, asks, key, cj)
    got = run_port(state, asks, key, ct)
    assert_same(want, got)
    c = got[0]
    assert len(set(c[c >= 0].tolist())) == (c >= 0).sum() == n
    assert (c[n:] == -1).all()
    # ... and, without noise (the two forms draw it in different
    # shapes), the greedy scan agrees with the top-k form.
    quiet = ct._replace(noise_scale=0.0)
    top = run_port(state, asks, key, quiet)
    seq = run_port(state, asks, key, quiet._replace(uniform_dh=False))
    np.testing.assert_array_equal(top[0], seq[0])
    assert_same(jb.placement_program_jit(
        state, asks, key, cj._replace(noise_scale=0.0, uniform_dh=False)),
        seq)


def test_topk_tie_order_is_lowest_index_first():
    """Identical nodes and no noise: every score ties, so the order is
    the tie order alone. lax.top_k puts the lower index first; the port
    pins the same (torch.topk promises no tie order)."""
    n, k = 128, 16
    state = jb.make_node_state(
        capacity=np.tile([4000.0, 8192, 100000, 150], (n, 1)),
        sched_capacity=np.tile([3900.0, 7936, 96000, 150], (n, 1)),
        util=np.tile([100.0, 256, 4096, 0], (n, 1)),
        bw_avail=np.full(n, 1000.0), bw_used=np.zeros(n),
        ports_free=np.full(n, 100.0), job_count=np.zeros(n, np.int32),
        tg_count=np.zeros((n, 2), np.int32),
        feasible=np.ones((n, 2), bool),
        node_ok=np.arange(n) % 3 != 0)
    asks = jb.make_asks(np.tile([500.0, 256, 150, 0], (k, 1)),
                        np.full(k, 50.0), np.full(k, 2.0),
                        np.zeros(k, np.int32), np.ones(k, bool), True,
                        np.zeros(2, bool))
    key = jb.host_prng_key(3)
    for uniform in (True, False):
        cj = jb.PlacementConfig(anti_affinity_penalty=10.0, noise_scale=0.0,
                                uniform_dh=uniform)
        ct = tb.PlacementConfig(anti_affinity_penalty=10.0, noise_scale=0.0,
                                uniform_dh=uniform)
        want = jb.placement_program_jit(state, asks, key, cj)
        got = run_port(state, asks, key, ct)
        assert_same(want, got)
        expect = [i for i in range(n) if i % 3 != 0][:k]
        assert got[0].tolist() == expect


def _compact_world(seed, b, n, g=2, c=8, p=16, j=64):
    rng = np.random.default_rng(seed)
    state, asks, _ = world(seed, n, 32, g=g)
    class_ids = rng.integers(-1, c - 2, n).astype(np.int32)
    verdicts = rng.random((b, c, g)) < 0.8
    patch_rows = np.full((b, p), n, np.int32)  # pad = N
    patch_vals = rng.random((b, p, g)) < 0.5
    job_rows = np.full((b, j), n, np.int32)
    job_tgs = np.zeros((b, j), np.int32)
    for i in range(b):
        patch_rows[i, :p // 2] = rng.choice(n, p // 2, replace=False)
        job_rows[i, :j // 2] = rng.integers(0, n, j // 2)  # duplicates
        job_tgs[i, :j // 2] = rng.integers(0, g, j // 2)
    overlays = jb.CompactOverlay(verdicts, patch_rows, patch_vals,
                                 job_rows, job_tgs)
    asks_b = jb.Asks(*(np.stack([np.asarray(x)] * b) for x in asks))
    keys = np.stack([jb.host_prng_key(int(s))
                     for s in rng.integers(0, 2**31, b)])
    return state, class_ids, overlays, asks_b, keys


def _port_base(state, class_ids):
    t = lambda x: torch.from_numpy(np.array(x, copy=True))
    return (t(state.capacity), t(state.sched_capacity), t(state.util),
            t(state.bw_avail), t(state.bw_used), t(state.ports_free),
            t(state.node_ok), t(class_ids))


@pytest.mark.parametrize("uniform", [False, True])
def test_compact_batch_matches(uniform):
    b, n = 4, 256
    state, class_ids, overlays, asks, keys = _compact_world(8, b, n)
    if uniform:
        asks = asks._replace(tg_index=np.zeros_like(asks.tg_index))
    cj = jb.PlacementConfig(anti_affinity_penalty=10.0, uniform_dh=uniform)
    ct = tb.PlacementConfig(anti_affinity_penalty=10.0, uniform_dh=uniform)
    c_j, s_j, _ = jb.batched_placement_program_compact(
        state.capacity, state.sched_capacity, state.util, state.bw_avail,
        state.bw_used, state.ports_free, state.node_ok, class_ids,
        overlays, asks, keys, cj)
    c_t, s_t, _ = tb.batched_placement_program_compact(
        *_port_base(state, class_ids),
        carry.overlay_from_numpy(overlays, "cpu"),
        carry.asks_from_numpy(asks, "cpu"),
        tb.keys_tensor(keys, "cpu"), ct)
    np.testing.assert_array_equal(np.asarray(c_j), c_t.numpy())
    assert np.abs(np.asarray(s_j) - s_t.numpy()).max() <= SCORE_TOL


def test_compact_delta_matches():
    """The fused base delta: the changed rows set first (padding rows
    repeat a real row), then the compact batch; the derived base comes
    back too."""
    b, n = 2, 256
    state, class_ids, overlays, asks, keys = _compact_world(9, b, n)
    rng = np.random.default_rng(9)
    rows = np.sort(rng.choice(n, 10, replace=False)).astype(np.int32)
    rows_p = np.concatenate([rows, np.full(6, rows[0], np.int32)])
    util_rows = state.util[rows_p] + 50.0
    bw_rows = state.bw_used[rows_p] + 5.0
    ports_rows = state.ports_free[rows_p] - 1.0
    ok_rows = ~state.node_ok[rows_p]
    cj = jb.PlacementConfig(anti_affinity_penalty=10.0)
    want = jb.batched_placement_program_compact_delta(
        state.capacity, state.sched_capacity, state.util, state.bw_avail,
        state.bw_used, state.ports_free, state.node_ok, class_ids, rows_p,
        util_rows, bw_rows, ports_rows, ok_rows, overlays, asks, keys, cj)
    t = lambda x: torch.from_numpy(np.array(x, copy=True))
    base = _port_base(state, class_ids)
    got = tb.batched_placement_program_compact_delta(
        *base, t(rows_p), t(util_rows), t(bw_rows), t(ports_rows),
        t(ok_rows), carry.overlay_from_numpy(overlays, "cpu"),
        carry.asks_from_numpy(asks, "cpu"), tb.keys_tensor(keys, "cpu"),
        tb.PlacementConfig(anti_affinity_penalty=10.0))
    np.testing.assert_array_equal(np.asarray(want[0]), got[0].numpy())
    assert np.abs(np.asarray(want[1]) - got[1].numpy()).max() <= SCORE_TOL
    for w, g in zip(want[2:], got[2:]):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())
    # The parent base the cache may still hold is left as it was.
    np.testing.assert_array_equal(base[2].numpy(), state.util)
    np.testing.assert_array_equal(base[6].numpy(), state.node_ok)


def test_expand_overlay_matches_and_drops_pad_rows():
    b, n, g = 3, 128, 2
    _state, class_ids, overlays, _asks, _keys = _compact_world(10, b, n)
    got = tb.expand_overlay(torch.from_numpy(class_ids),
                            carry.overlay_from_numpy(overlays, "cpu"), n)
    for i in range(b):
        ov = jb.CompactOverlay(*(np.asarray(x)[i] for x in overlays))
        want = jb._expand_overlay(class_ids, ov, n, g)
        for w, t in zip(want, got):
            np.testing.assert_array_equal(np.asarray(w), t[i].numpy())
    # Only the real job positions count: the pad rows (index N) drop.
    real = overlays.job_rows < n
    assert int(got[1].sum()) == int(real.sum())
    assert int(got[2].sum()) == int(real.sum())


def test_programs_leave_their_inputs_unchanged():
    """The kernels update the carry in place, on per-eval copies: the
    caller's state (a cached device base, in the batcher) stays as it
    was."""
    state, asks, key = world(11, 128, 16)
    ts = carry.node_state_from_numpy(state, "cpu")
    before = [x.clone() for x in ts]
    for uniform in (False, True):
        tb.placement_program(ts, carry.asks_from_numpy(asks, "cpu"), key,
                             tb.PlacementConfig(10.0, uniform_dh=uniform))
        for x, y in zip(before, ts):
            assert torch.equal(x, y)


def test_wrappers_check_their_arguments():
    state, asks, key = world(12, 128, 16)
    ts = carry.node_state_from_numpy(state, "cpu")
    bad = ts._replace(util=ts.util.double())
    with pytest.raises(ValueError):
        tb.placement_program(bad, carry.asks_from_numpy(asks, "cpu"), key,
                             tb.PlacementConfig(10.0))


def test_unported_options_raise():
    """A kernel name the registry does not know raises; the registered
    ones (greedy and convex) run (a lone program ignores pre_resolve,
    as placement_program_jit does)."""
    state, asks, key = world(13, 128, 16)
    ts = carry.node_state_from_numpy(state, "cpu")
    ta = carry.asks_from_numpy(asks, "cpu")
    with pytest.raises(ValueError, match="unknown placement kernel"):
        tb.placement_program(ts, ta, key,
                             tb.PlacementConfig(10.0, kernel="cvx"))
    choices, _scores, _final = tb.placement_program(
        ts, ta, key, tb.PlacementConfig(10.0, kernel="convex"))
    assert choices.shape == ta.active.shape


def test_batcher_lone_path_matches():
    """A state with no base token (a bare NodeState) dispatches as it
    is, through the lone path."""
    from nomad_tpu_torch.scheduler.batcher import PlacementBatcher

    state, asks, key = world(14, 256, 32)
    config = jb.PlacementConfig(anti_affinity_penalty=10.0)
    c_j, s_j, _ = jb.placement_program_jit(state, asks, key, config)
    batcher = PlacementBatcher("cpu")
    c_t, s_t = batcher.place(state, asks, key,
                             tb.PlacementConfig(anti_affinity_penalty=10.0))
    np.testing.assert_array_equal(np.asarray(c_j), c_t)
    assert np.abs(np.asarray(s_j) - s_t).max() <= SCORE_TOL
    assert batcher.stats()["lone_dispatches"] == 1


# ------------------------------------------------ batch layouts (K4, K5)


def _overlay_world(seed, b, n, k, g=2, uniform=False):
    """B evals over one tight shared base: per-eval overlays (job and
    task-group counts, feasibility) and asks, keys [B, 2]. Few nodes and
    many asks, so the evals compete for the same rows."""
    rng = np.random.default_rng(seed)
    state, _asks, _key = world(seed, n, k, g=g)
    state = state._replace(
        job_count=rng.integers(0, 2, (b, n)).astype(np.int32),
        tg_count=rng.integers(0, 2, (b, n, g)).astype(np.int32),
        feasible=rng.random((b, n, g)) < 0.85)
    per = [world(seed * 100 + i, n, k, g=g, uniform=uniform)[1]
           for i in range(b)]
    asks = jb.Asks(*(np.stack([np.asarray(x) for x in xs])
                     for xs in zip(*per)))
    keys = np.stack([jb.host_prng_key(int(s))
                     for s in rng.integers(0, 2**31, b)])
    return state, asks, keys


def _configs(uniform, pre_resolve):
    kw = dict(anti_affinity_penalty=10.0, uniform_dh=uniform,
              pre_resolve=pre_resolve)
    return jb.PlacementConfig(**kw), tb.PlacementConfig(**kw)


def _assert_batch_same(want, got, claimed=None):
    """Choices equal, scores within SCORE_TOL, and the claimed
    capacity (util, bw_used, ports_free) equal where given."""
    np.testing.assert_array_equal(np.asarray(want[0]), got[0].numpy())
    assert np.abs(np.asarray(want[1]) - got[1].numpy()).max() <= SCORE_TOL
    if claimed is not None:
        for w, t in zip(claimed, got[2][:3]):
            np.testing.assert_array_equal(np.asarray(w), t.numpy())


@pytest.mark.parametrize("uniform", [False, True])
def test_pre_resolve_overlay_matches(uniform):
    """The sequential eval axis (the JAX package's _overlay_seq): each
    eval sees the capacity earlier evals claimed; the carried util,
    bw_used and ports_free come back shared."""
    b, n, k = 6, 64, 16
    state, asks, keys = _overlay_world(20 + uniform, b, n, k,
                                       uniform=uniform)
    cj, ct = _configs(uniform, True)
    want = jb.batched_placement_program_overlay(state, asks, keys, cj)
    got = tb.batched_placement_program_overlay(
        carry.node_state_from_numpy(state, "cpu"),
        carry.asks_from_numpy(asks, "cpu"), tb.keys_tensor(keys, "cpu"), ct)
    _assert_batch_same(want, got, claimed=want[2])
    # The independent form places differently on this tight base.
    off = tb.batched_placement_program_overlay(
        carry.node_state_from_numpy(state, "cpu"),
        carry.asks_from_numpy(asks, "cpu"), tb.keys_tensor(keys, "cpu"),
        ct._replace(pre_resolve=False))
    assert not torch.equal(off[0], got[0])


@pytest.mark.parametrize("uniform", [False, True])
def test_pre_resolve_compact_matches(uniform):
    b, n = 4, 256
    state, class_ids, overlays, asks, keys = _compact_world(30, b, n)
    if uniform:
        asks = asks._replace(tg_index=np.zeros_like(asks.tg_index))
    cj, ct = _configs(uniform, True)
    want = jb.batched_placement_program_compact(
        state.capacity, state.sched_capacity, state.util, state.bw_avail,
        state.bw_used, state.ports_free, state.node_ok, class_ids,
        overlays, asks, keys, cj)
    got = tb.batched_placement_program_compact(
        *_port_base(state, class_ids),
        carry.overlay_from_numpy(overlays, "cpu"),
        carry.asks_from_numpy(asks, "cpu"), tb.keys_tensor(keys, "cpu"), ct)
    _assert_batch_same(want, got, claimed=want[2])


@pytest.mark.parametrize("uniform", [False, True])
def test_pre_resolve_compact_delta_matches(uniform):
    """The fused delta under pre_resolve: the derived base that comes
    back is the child after the delta and before any placement."""
    b, n = 4, 256
    state, class_ids, overlays, asks, keys = _compact_world(31, b, n)
    if uniform:
        asks = asks._replace(tg_index=np.zeros_like(asks.tg_index))
    rng = np.random.default_rng(31)
    rows = rng.choice(n, 12, replace=False).astype(np.int32)
    rows_p = np.concatenate([rows, np.full(4, rows[0], np.int32)])
    delta = (rows_p, state.util[rows_p] + 100.0,
             state.bw_used[rows_p] + 5.0, state.ports_free[rows_p] - 1.0,
             ~state.node_ok[rows_p])
    cj, ct = _configs(uniform, True)
    want = jb.batched_placement_program_compact_delta(
        state.capacity, state.sched_capacity, state.util, state.bw_avail,
        state.bw_used, state.ports_free, state.node_ok, class_ids, *delta,
        overlays, asks, keys, cj)
    t = lambda x: torch.from_numpy(np.array(x, copy=True))
    got = tb.batched_placement_program_compact_delta(
        *_port_base(state, class_ids), *(t(x) for x in delta),
        carry.overlay_from_numpy(overlays, "cpu"),
        carry.asks_from_numpy(asks, "cpu"), tb.keys_tensor(keys, "cpu"), ct)
    _assert_batch_same(want, got)
    for w, g in zip(want[2:], got[2:]):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())
    child_util = state.util.copy()
    child_util[rows_p] = delta[1]
    np.testing.assert_array_equal(got[2].numpy(), child_util)


def _serial_inputs(n, k, g, b, node_cpu=1000.0, ask_cpu=400.0):
    """tests/test_dispatch_pipeline.py's _shared_batch_inputs."""
    state = jb.make_node_state(
        capacity=np.tile([node_cpu, 8192, 100000, 150], (n, 1)),
        sched_capacity=np.tile([node_cpu, 8192, 100000, 150], (n, 1)),
        util=np.zeros((n, 4)), bw_avail=np.full(n, 1000.0),
        bw_used=np.zeros(n), ports_free=np.full(n, 100.0),
        job_count=np.zeros((b, n), np.int32),
        tg_count=np.zeros((b, n, g), np.int32),
        feasible=np.ones((b, n, g), bool), node_ok=np.ones(n, bool))
    asks = jb.make_asks(
        resources=np.tile([ask_cpu, 64, 100, 0], (b, k, 1)),
        bw=np.full((b, k), 10.0), ports=np.full((b, k), 1.0),
        tg_index=np.zeros((b, k), np.int32), active=np.ones((b, k), bool),
        job_distinct_hosts=np.zeros(b, bool),
        tg_distinct_hosts=np.zeros((b, g), bool))
    return state, asks


def test_pre_resolve_parity_vs_serial_placement():
    """Mirror of tests/test_dispatch_pipeline.py's serial parity: the
    pre-resolved batch equals placing the evals one at a time while
    carrying the shared capacity, in the port and in the reference."""
    b, n, k, g = 6, 16, 4, 1
    state, asks = _serial_inputs(n, k, g, b)
    keys = np.stack([jb.host_prng_key(i) for i in range(b)])
    cj, ct = _configs(False, True)
    ts = carry.node_state_from_numpy(state, "cpu")
    choices, scores, _ = tb.batched_placement_program_overlay(
        ts, carry.asks_from_numpy(asks, "cpu"), tb.keys_tensor(keys, "cpu"),
        ct)
    want, _s, _c = jb.batched_placement_program_overlay(state, asks, keys, cj)
    np.testing.assert_array_equal(np.asarray(want), choices.numpy())
    util, bw, pf = ts.util, ts.bw_used, ts.ports_free
    serial_c, serial_s = [], []
    for i in range(b):
        s = ts._replace(util=util, bw_used=bw, ports_free=pf,
                        job_count=ts.job_count[i], tg_count=ts.tg_count[i],
                        feasible=ts.feasible[i])
        a = tb.Asks(*(torch.as_tensor(np.asarray(x)[i]) for x in asks))
        c, sc, fin = tb.placement_program(s, a, keys[i], ct)
        util, bw, pf = fin.util, fin.bw_used, fin.ports_free
        serial_c.append(c)
        serial_s.append(sc)
    assert torch.equal(choices, torch.stack(serial_c))
    assert torch.allclose(scores, torch.stack(serial_s))


def test_pre_resolve_eliminates_in_batch_overcommit():
    """Mirror of tests/test_dispatch_pipeline.py's overcommit A/B:
    independent evals over a tight cluster overcommit it, the
    pre-resolved batch does not."""
    b, n, k, g = 8, 8, 2, 1
    node_cpu, ask_cpu = 800.0, 400.0
    state, asks = _serial_inputs(n, k, g, b, node_cpu=node_cpu,
                                 ask_cpu=ask_cpu)
    keys = tb.keys_tensor(
        np.stack([jb.host_prng_key(100 + i) for i in range(b)]), "cpu")

    def overcommits(pre_resolve):
        choices, _, _ = tb.batched_placement_program_overlay(
            carry.node_state_from_numpy(state, "cpu"),
            carry.asks_from_numpy(asks, "cpu"), keys,
            _configs(False, pre_resolve)[1])
        claimed = np.zeros(n)
        rejected = 0
        for i in range(b):
            bad = False
            for c in choices[i].tolist():
                if c < 0 or claimed[c] + ask_cpu > node_cpu:
                    bad = True
                    continue
                claimed[c] += ask_cpu
            rejected += bad
        return rejected

    assert overcommits(False) > 0
    assert overcommits(True) == 0


@pytest.mark.parametrize("uniform", [False, True])
def test_stacked_program_matches(uniform):
    """Stacked full states, a base per eval (batched_placement_program,
    the mixed-token path)."""
    b, n, k = 3, 128, 16
    worlds = [world(40 + i, n, k, uniform=uniform) for i in range(b)]
    states = jb.NodeState(*(np.stack([np.asarray(x) for x in xs])
                            for xs in zip(*(w[0] for w in worlds))))
    asks = jb.Asks(*(np.stack([np.asarray(x) for x in xs])
                     for xs in zip(*(w[1] for w in worlds))))
    keys = np.stack([w[2] for w in worlds])
    for pre_resolve in (False, True):  # ignored: no shared base
        cj, ct = _configs(uniform, pre_resolve)
        want = jb.batched_placement_program(states, asks, keys, cj)
        got = tb.batched_placement_program(
            carry.node_state_from_numpy(states, "cpu"),
            carry.asks_from_numpy(asks, "cpu"), tb.keys_tensor(keys, "cpu"),
            ct)
        _assert_batch_same(want, got, claimed=(want[2].util,
                                               want[2].bw_used,
                                               want[2].ports_free))


@pytest.mark.parametrize("uniform", [False, True])
def test_shared_program_matches(uniform):
    """One state and one ask list, B keys
    (batched_placement_program_shared)."""
    state, asks, _key = world(50, 128, 16, uniform=uniform)
    keys = np.stack([jb.host_prng_key(i) for i in range(5)])
    cj, ct = _configs(uniform, False)
    want = jb.batched_placement_program_shared(state, asks, keys, cj)
    got = tb.batched_placement_program_shared(
        carry.node_state_from_numpy(state, "cpu"),
        carry.asks_from_numpy(asks, "cpu"), tb.keys_tensor(keys, "cpu"), ct)
    _assert_batch_same(want, got, claimed=(want[2].util, want[2].bw_used,
                                           want[2].ports_free))


def test_placement_program_ignores_pre_resolve():
    state, asks, key = world(51, 128, 16)
    cj, ct = _configs(False, True)
    want = jb.placement_program_jit(state, asks, key, cj)
    assert_same(want, run_port(state, asks, key, ct))
    assert_same(want, run_port(state, asks, key, ct._replace(
        pre_resolve=False)))


def test_apply_base_delta_matches_with_padded_rows():
    """K4's plain version against the reference scatter: the padding
    rows repeat the first changed row with its value, as the batcher's
    _pad_rows makes them."""
    from nomad_tpu_torch.scheduler.batcher import _delta_payload

    n = 300
    state, _asks, _key = world(52, n, 8)
    rng = np.random.default_rng(52)
    rows = rng.choice(n, 37, replace=False).tolist()
    child = [np.asarray(x).copy() for x in (
        state.capacity, state.sched_capacity, state.util, state.bw_avail,
        state.bw_used, state.ports_free, state.node_ok)]
    child[2][rows] += 64.0
    child[4][rows] += 5.0
    child[5][rows] -= 1.0
    child[6][rows] = ~child[6][rows]
    payload = _delta_payload(child, rows)
    assert len(payload[0]) == 256 and (payload[0][37:] == rows[0]).all()
    want = jb.apply_base_delta(state.util, state.bw_used, state.ports_free,
                               state.node_ok, *payload)
    t = lambda x: torch.from_numpy(np.array(x, copy=True))
    parent = [t(x) for x in (state.util, state.bw_used, state.ports_free,
                             state.node_ok)]
    got = tb.apply_base_delta(*parent, *(t(x) for x in payload))
    for w, g, c in zip(want, got, (child[2], child[4], child[5], child[6])):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())
        np.testing.assert_array_equal(c, g.numpy())
    np.testing.assert_array_equal(parent[0].numpy(), state.util)


def test_device_resident_packs_every_array():
    """The one-copy upload: every array comes back with its shape,
    dtype and values, 0-d flags and empty arrays included."""
    rng = np.random.default_rng(53)
    arrays = (rng.random((5, 4)).astype(np.float32),
              rng.integers(-3, 9, 7).astype(np.int32),
              np.asarray(True), rng.random(3) < 0.5,
              np.zeros((0, 2), np.float32),
              rng.integers(0, 2**32, (2, 2), dtype=np.uint64)
              .astype(np.int64))
    out = tb.device_resident(arrays, "cpu")
    for a, t in zip(arrays, out):
        assert tuple(t.shape) == a.shape and t.is_contiguous()
        np.testing.assert_array_equal(t.numpy(), a)
