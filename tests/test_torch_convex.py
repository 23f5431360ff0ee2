"""The convex placement kernel of the port (nomad_tpu_torch/kernels/
convex.py: K8a's relaxation, K8b's rounding scan and the whole program
in every batch layout, as plain PyTorch on CPU tensors) against the
JAX package's kernels/convex.py on the same inputs.

Tolerances, and why:

- The relaxation: its sums over K (the node contractions) and over N
  (the softmax) run in another order in XLA-CPU than in torch, and 12
  mirror-descent steps carry that float32 rounding forward. Logits
  within LOGIT_TOL relative to max(1, |logit|); x and pref (both in
  [0, 1]) within X_TOL absolute: where expected ports overflow, the
  logits reach several hundred, and a relative difference of ~1e-5 in
  them moves a softmax entry by ~1e-3 (measured: 1.2e-3 on the "ports"
  case, 3e-6 to 3e-5 on the others).
- The rounding scan fed the same x: choices and the five carried
  tensors identical, scores within 1e-4 (K1's rule: two float32
  pow(10, x) may differ in the last ulp).
- The whole program: choices identical, scores within 1e-4. At these
  sizes the tie-break noise separates the best two nodes by about
  2 / N fitness points, orders above the relaxation's float error; a
  mismatch prints the preference margin at the first differing ask.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (the port on the CPU, one torch thread)
from test_torch_binpack import (
    _compact_world,
    _overlay_world,
    _port_base,
    world,
)

from nomad_tpu.kernels import convex as jc
from nomad_tpu.ops import binpack as jb
from nomad_tpu_torch import carry
from nomad_tpu_torch.kernels import convex as tc
from nomad_tpu_torch.ops import binpack as tb

SCORE_TOL = 1e-4
LOGIT_TOL = 1e-4
X_TOL = 5e-3


def assert_close(want, got, what, tol=LOGIT_TOL, relative=True):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    err = np.abs(want - got)
    if relative:
        err = err / np.maximum(1.0, np.abs(want))
    assert err.max() <= tol, f"{what}: error {err.max():.3g} > {tol}"


def convex_world(seed, n, k, case="plain"):
    """``world``'s state and asks, bent toward each branch of the
    relaxation: inactive asks (its padding tail), asks no node can take
    (all-NEG_INF rows), tight ports, job-level distinct_hosts."""
    state, asks, key = world(seed, n, k)
    res = np.array(asks.resources)
    if case == "infeasible":
        res[: k // 4, 0] = 1e7  # rows whose softmax is over NEG_INF only
    asks = asks._replace(resources=res)
    if case == "ports":
        asks = asks._replace(ports=np.full(k, 8.0, np.float32))
        state = state._replace(ports_free=np.asarray(
            np.random.default_rng(seed).integers(0, 12, n), np.float32))
    if case == "job_dh":
        asks = asks._replace(job_distinct_hosts=np.asarray(True))
    return state, asks, key


def port_args(state, asks):
    """The port's batched relaxation / scan arguments of one eval."""
    ts = carry.node_state_from_numpy(state, "cpu")
    ta = carry.asks_from_numpy(asks, "cpu")
    un = lambda t: t.unsqueeze(0).contiguous()  # noqa: E731
    static = (ts.capacity, ts.sched_capacity, ts.bw_avail, ts.node_ok)
    c = (un(ts.util), un(ts.bw_used), un(ts.ports_free), un(ts.job_count),
         un(ts.tg_count))
    return static, c, un(ts.feasible), tb.Asks(*(un(x) for x in ta))


_relax_jit = jax.jit(jc._relaxed_assignment, static_argnames="config")


# ------------------------------------------------------------ relaxation


def test_mirror_descent_matches():
    """The loop alone, on the JAX signature: a row with no feasible
    node, inactive rows, over-capacity that binds."""
    rng = np.random.default_rng(3)
    k, n = 24, 96
    f = lambda *s: rng.random(s).astype(np.float32)  # noqa: E731
    mask = np.where(rng.random((k, n)) < 0.8, 0.0, -1e30).astype(np.float32)
    mask[0] = -1e30
    lin = (f(k, n) * 18).astype(np.float32)
    active = np.ones((k, 1), np.float32)
    active[-4:] = 0.0
    res = (f(k, 4) * 400 + 50) * active
    args = (lin, lin, mask, res, f(k) * 50 * active[:, 0],
            np.full(k, 2.0, np.float32) * active[:, 0], f(n, 4) * 0.9,
            f(n) * 0.5, np.full((n, 4), 1000.0, np.float32),
            np.full(n, 500.0, np.float32), np.full(n, 3.0, np.float32),
            active)
    want = np.asarray(jax.jit(jc.mirror_descent, static_argnums=12)(
        *args, jc.SOLVE_ITERS))
    got = tc.mirror_descent(*(torch.from_numpy(a) for a in args),
                            tc.SOLVE_ITERS)
    assert_close(want, got.numpy(), "logits")
    assert np.abs(want).max() > 18.0  # the penalty moved the logits


@pytest.mark.parametrize("case", ["plain", "infeasible", "ports", "job_dh"])
def test_relaxed_assignment_matches(case):
    state, asks, _key = convex_world(60, 128, 32, case)
    cfg = jb.PlacementConfig(anti_affinity_penalty=10.0, kernel="convex")
    want = np.asarray(_relax_jit(state, asks, cfg))
    static, c, feas, ta = port_args(state, asks)
    _logits, x, pref = tc.relaxed_assignment(*static, c, feas, ta, 10.0)
    assert_close(want, x[0].numpy(), "x", X_TOL, relative=False)
    y = want.sum(0)
    want_pref = (want / (want.max(1, keepdims=True) + 1e-9)
                 + y[None] / (y.max() + 1e-9)) * 0.5
    assert_close(want_pref, pref[0].numpy(), "pref", X_TOL, relative=False)
    if case == "infeasible":
        # Rows over NEG_INF only come out uniform, as softmax makes them.
        np.testing.assert_allclose(x[0, :8].numpy(), 1.0 / 128, rtol=1e-6)


# ------------------------------------------------------------ rounding


@pytest.mark.parametrize("case", ["plain", "ports", "job_dh"])
def test_rounding_scan_matches_exactly(case, monkeypatch):
    """K8b's plain version fed the JAX relaxation's own x: the same
    choices and all five carried tensors, scores within 1e-4."""
    state, asks, key = convex_world(61, 128, 48, case)
    cfg = jb.PlacementConfig(anti_affinity_penalty=10.0, kernel="convex")
    x = _relax_jit(state, asks, cfg)

    def rounding(state, asks, key, x):
        # x is an argument, not a constant: a program traced for
        # another case's x can never be reused here.
        monkeypatch.setattr(jc, "_relaxed_assignment", lambda s, a, c: x)
        return jc.convex_placement_program(state, asks, key, cfg)

    c_j, s_j, f_j = jax.jit(rounding)(state, asks, key, x)
    static, c, feas, ta = port_args(state, asks)
    noise = tb.threefry_uniform(tb.keys_tensor(key, "cpu"), (48, 128),
                                0.0, 2.0)
    pref = tc.convex_pref(torch.from_numpy(np.array(x))[None])
    c_t, s_t = tc.convex_round(*static, c, feas, ta, noise, 10.0, pref)
    np.testing.assert_array_equal(np.asarray(c_j), c_t[0].numpy())
    assert np.abs(np.asarray(s_j) - s_t[0].numpy()).max() <= SCORE_TOL
    np.testing.assert_array_equal(np.asarray(f_j.util), c[0][0].numpy())
    np.testing.assert_array_equal(np.asarray(f_j.bw_used), c[1][0].numpy())
    np.testing.assert_array_equal(np.asarray(f_j.ports_free),
                                  c[2][0].numpy())
    np.testing.assert_array_equal(np.asarray(f_j.job_count),
                                  c[3][0].numpy())
    np.testing.assert_array_equal(np.asarray(f_j.tg_count), c[4][0].numpy())
    assert (c_t >= 0).sum() > 8


def test_rounding_seq_and_stacked_layouts_match_one_by_one():
    """K8b under seq (one shared carry, evals in order) and stacked
    (a base per eval) equals the same evals scanned one at a time."""
    b, n, k = 3, 64, 12
    state, asks, keys = _overlay_world(62, b, n, k)
    ts = carry.node_state_from_numpy(state, "cpu")
    ta = carry.asks_from_numpy(asks, "cpu")
    static = (ts.capacity, ts.sched_capacity, ts.bw_avail, ts.node_ok)
    noise = tb.threefry_uniform(tb.keys_tensor(keys, "cpu"), (k, n), 0.0,
                                2.0)
    pref = torch.rand((b, k, n), generator=torch.Generator().manual_seed(6))
    seq = (ts.util.clone(), ts.bw_used.clone(), ts.ports_free.clone(),
           ts.job_count.clone(), ts.tg_count.clone())
    c_seq, s_seq = tc.convex_round(*static, seq, ts.feasible, ta, noise,
                                   10.0, pref, seq=True)
    one_util = (ts.util.clone(), ts.bw_used.clone(), ts.ports_free.clone())
    for i in range(b):
        own = (one_util[0][None], one_util[1][None], one_util[2][None],
               ts.job_count[i:i + 1].clone(), ts.tg_count[i:i + 1].clone())
        c1, s1 = tc.convex_round(
            *static, own, ts.feasible[i:i + 1],
            tb.Asks(*(x[i:i + 1] for x in ta)), noise[i:i + 1], 10.0,
            pref[i:i + 1].contiguous())
        assert torch.equal(c1[0], c_seq[i])
        assert torch.equal(s1[0], s_seq[i])
    assert torch.equal(one_util[0], seq[0])
    stacked = tuple(x.expand(b, *x.shape).contiguous() for x in static)
    carry_b = tb.fresh_carry(ts.util, ts.bw_used, ts.ports_free,
                             ts.job_count, ts.tg_count, b, False)
    c_st, _s = tc.convex_round(*stacked, carry_b, ts.feasible, ta, noise,
                               10.0, pref)
    carry_i = tb.fresh_carry(ts.util, ts.bw_used, ts.ports_free,
                             ts.job_count, ts.tg_count, b, False)
    c_in, _s = tc.convex_round(*static, carry_i, ts.feasible, ta, noise,
                               10.0, pref)
    assert torch.equal(c_st, c_in)
    assert not torch.equal(c_in, c_seq)  # the shared carry binds


# ------------------------------------------------------------ whole program


def _convex_configs(pre_resolve):
    kw = dict(anti_affinity_penalty=10.0, pre_resolve=pre_resolve,
              kernel="convex")
    return jb.PlacementConfig(**kw), tb.PlacementConfig(**kw)


def _assert_program_same(want, got, pref=None):
    """Choices identical and scores within SCORE_TOL. On a mismatch the
    message names the first differing ask and, given the port's
    preference [..., K, N], its biased margin between the two nodes."""
    c_j = np.asarray(want[0])
    c_t = got[0].numpy()
    if not np.array_equal(c_j, c_t):
        bad = tuple(np.argwhere(c_j != c_t)[0])
        msg = f"first differing ask {bad}: JAX {c_j[bad]}, port {c_t[bad]}"
        if pref is not None and c_j[bad] >= 0 and c_t[bad] >= 0:
            row = pref.numpy().reshape(-1, pref.shape[-1])[
                int(np.ravel_multi_index(bad, c_j.shape))]
            gap = tc.ROUND_BIAS * abs(row[c_j[bad]] - row[c_t[bad]])
            msg += f"; ROUND_BIAS x pref gap between them {gap:.3g}"
        raise AssertionError(msg)
    assert np.abs(np.asarray(want[1]) - got[1].numpy()).max() <= SCORE_TOL


@pytest.mark.parametrize("case", ["plain", "infeasible", "ports", "job_dh"])
def test_convex_placement_program_matches(case):
    state, asks, key = convex_world(63, 128, 32, case)
    cj, ct = _convex_configs(False)
    want = jb.placement_program_jit(state, asks, key, cj)
    got = tb.placement_program(carry.node_state_from_numpy(state, "cpu"),
                               carry.asks_from_numpy(asks, "cpu"), key, ct)
    static, c, feas, ta = port_args(state, asks)
    pref = tc.relaxed_assignment(*static, c, feas, ta, 10.0)[2]
    _assert_program_same(want, got, pref)
    np.testing.assert_array_equal(np.asarray(want[2].util),
                                  got[2].util.numpy())
    # The convex kernel places differently from greedy on this state.
    greedy = tb.placement_program(carry.node_state_from_numpy(state, "cpu"),
                                  carry.asks_from_numpy(asks, "cpu"), key,
                                  ct._replace(kernel="greedy"))
    if case == "plain":
        assert not torch.equal(greedy[0], got[0])


@pytest.mark.parametrize("pre_resolve", [False, True])
def test_convex_overlay_layout_matches(pre_resolve):
    b, n, k = 4, 64, 12
    state, asks, keys = _overlay_world(64, b, n, k)
    cj, ct = _convex_configs(pre_resolve)
    want = jb.batched_placement_program_overlay(state, asks, keys, cj)
    got = tb.batched_placement_program_overlay(
        carry.node_state_from_numpy(state, "cpu"),
        carry.asks_from_numpy(asks, "cpu"), tb.keys_tensor(keys, "cpu"), ct)
    _assert_program_same(want, got)
    if pre_resolve:
        for w, t in zip(want[2], got[2][:3]):
            np.testing.assert_array_equal(np.asarray(w), t.numpy())


@pytest.mark.parametrize("pre_resolve", [False, True])
def test_convex_compact_layouts_match(pre_resolve):
    """The compact batch and the compact batch with the base delta
    fused in (the storm's dispatches)."""
    b, n = 3, 128
    state, class_ids, overlays, asks, keys = _compact_world(65, b, n)
    cj, ct = _convex_configs(pre_resolve)
    base = (state.capacity, state.sched_capacity, state.util,
            state.bw_avail, state.bw_used, state.ports_free, state.node_ok,
            class_ids)
    want = jb.batched_placement_program_compact(*base, overlays, asks, keys,
                                                cj)
    got = tb.batched_placement_program_compact(
        *_port_base(state, class_ids),
        carry.overlay_from_numpy(overlays, "cpu"),
        carry.asks_from_numpy(asks, "cpu"), tb.keys_tensor(keys, "cpu"), ct)
    _assert_program_same(want, got)
    rng = np.random.default_rng(65)
    rows = rng.choice(n, 8, replace=False).astype(np.int32)
    rows_p = np.concatenate([rows, np.full(8, rows[0], np.int32)])
    delta = (rows_p, state.util[rows_p] + 100.0,
             state.bw_used[rows_p] + 5.0, state.ports_free[rows_p] - 1.0,
             ~state.node_ok[rows_p])
    want = jb.batched_placement_program_compact_delta(
        *base, *delta, overlays, asks, keys, cj)
    t = lambda x: torch.from_numpy(np.array(x, copy=True))  # noqa: E731
    got = tb.batched_placement_program_compact_delta(
        *_port_base(state, class_ids), *(t(x) for x in delta),
        carry.overlay_from_numpy(overlays, "cpu"),
        carry.asks_from_numpy(asks, "cpu"), tb.keys_tensor(keys, "cpu"), ct)
    _assert_program_same(want, got)
    for w, g in zip(want[2:], got[2:]):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())


def test_convex_stacked_and_shared_layouts_match():
    b, n, k = 3, 64, 12
    worlds = [world(66 + i, n, k) for i in range(b)]
    states = jb.NodeState(*(np.stack([np.asarray(x) for x in xs])
                            for xs in zip(*(w[0] for w in worlds))))
    asks = jb.Asks(*(np.stack([np.asarray(x) for x in xs])
                     for xs in zip(*(w[1] for w in worlds))))
    keys = np.stack([w[2] for w in worlds])
    cj, ct = _convex_configs(False)
    want = jb.batched_placement_program(states, asks, keys, cj)
    got = tb.batched_placement_program(
        carry.node_state_from_numpy(states, "cpu"),
        carry.asks_from_numpy(asks, "cpu"), tb.keys_tensor(keys, "cpu"), ct)
    _assert_program_same(want, got)
    np.testing.assert_array_equal(np.asarray(want[2].util),
                                  got[2][0].numpy())
    state, one_asks, _key = worlds[0]
    want = jb.batched_placement_program_shared(state, one_asks, keys, cj)
    got = tb.batched_placement_program_shared(
        carry.node_state_from_numpy(state, "cpu"),
        carry.asks_from_numpy(one_asks, "cpu"), tb.keys_tensor(keys, "cpu"),
        ct)
    _assert_program_same(want, got)


def test_pre_resolve_relaxes_on_claimed_capacity():
    """Under pre_resolve each eval's relaxation reads the capacity the
    earlier evals' rounding claimed: on a tight base the second eval's
    preference differs from the one it has on the untouched base."""
    b, n, k = 2, 32, 16
    state, asks, keys = _overlay_world(67, b, n, k)
    ts = carry.node_state_from_numpy(state, "cpu")
    ta = carry.asks_from_numpy(asks, "cpu")
    calls = []
    real = tc.relaxed_pref

    def spy(*args):
        out = real(*args)
        calls.append(args[4][0].clone())
        return out

    tc.relaxed_pref = spy
    try:
        tb.batched_placement_program_overlay(
            ts, ta, tb.keys_tensor(keys, "cpu"),
            tb.PlacementConfig(10.0, pre_resolve=True, kernel="convex"))
    finally:
        tc.relaxed_pref = real
    assert len(calls) == b
    assert torch.equal(calls[0], ts.util)
    assert not torch.equal(calls[1], ts.util)
