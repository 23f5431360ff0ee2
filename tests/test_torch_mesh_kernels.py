"""The port's last three node-sharded programs on W CPU shards (W in
{2, 4, 8}), held against the JAX package's sharded programs on its
8-device virtual CPU mesh (tests/conftest.py) and against the port's
own unsharded programs, on the same numpy inputs from a seed:

- K10e, the gang program on a node-sharded GangState
  (``shard_gang_inputs`` + ``gang_placement``), mirroring
  ``__graft_entry__._dryrun_shard_parity`` item 3;
- K10f, ``compute_defrag_plan(..., mesh=)``, x's node columns split;
- K10g, the convex kernel over node shards (``sharded_placement`` lone
  and stacked; the batcher's compact dispatch over a sharded base is
  in tests/test_torch_parallel.py and tests/test_torch_batcher.py).

Tolerances, and why:

- K10e: on integer data with the noise off, choices, scores and the
  slice group equal the JAX package's bit for bit (every sum exact,
  every score one float32 rounding of the same operations). With the
  noise on, choices and slice groups are equal and scores within
  SCORE_TOL = 1e-4 of JAX's (float32 pow(10, x) may differ in its last
  ulp between XLA's and torch's CPU code); against the port's unsharded
  program (K7's plain version) everything is bit-equal: the same float
  operations in the same order.
- K10f: the plans as tests/test_torch_defrag.py holds them (the same
  moves, ``_same_plan``), the carried logits within LOGIT_TOL = 1e-4
  relative to max(1, |logit|). The solve alone is chaotic in float32
  where over-capacity binds, so it is held as test_torch_defrag.py
  holds K9: within 10x JAX's own distance from a float64 run (plus
  1e-5), a bound that must stay under CHAOS_CAP = 0.1.
- K10g: the cross-shard softmax sums in another order than one
  device's, so x and pref differ in their last bits: x and pref within
  X_TOL = 5e-3 absolute of JAX's (test_torch_convex.py's rule), and the
  choices equal, scores within SCORE_TOL, on these non-chaotic
  instances. With one shard the sharded relaxation is the unsharded
  one bit for bit.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

import torch_parity
from test_defrag import fragmented_harness
from test_torch_defrag import (
    CHAOS_CAP,
    LOGIT_TOL,
    _consolidation,
    _same_plan,
    _solve_inputs,
    assert_close,
    solve_err,
)
from test_torch_parallel import (
    CONFIG,
    REF_CONFIG,
    SCORE_TOL,
    assert_same_choices,
    build_inputs,
    cpu_mesh,
    np_asks,
    np_state,
    port_unsharded,
)

from nomad_tpu.defrag import WarmState as JaxWarmState
from nomad_tpu.defrag import compute_defrag_plan as jax_compute_defrag_plan
from nomad_tpu.defrag.solver import _solve_jit
from nomad_tpu.ops import binpack as jb
from nomad_tpu.ops.gang import (
    GangConfig,
    gang_placement_program_jit,
    make_gang_state,
)
from nomad_tpu.parallel import mesh as jmesh
from nomad_tpu_torch import carry
from nomad_tpu_torch.defrag import WarmState, compute_defrag_plan
from nomad_tpu_torch.kernels import convex as tc
from nomad_tpu_torch.ops import binpack as tb
from nomad_tpu_torch.ops import gang as tg
from nomad_tpu_torch.ops import prng as tp
from nomad_tpu_torch.parallel import mesh as tmesh
from nomad_tpu_torch.parallel import shard as tshard

X_TOL = 5e-3
WIDTHS = [2, 4, 8]


# ------------------------------------------------------------ K10e


def graft_gang_state(n, g_pad):
    """``__graft_entry__._dryrun_shard_parity``'s gang state: integer
    capacities, racks striding over the node axis (a rack spans every
    shard), the first four nodes without an id."""
    topo_ids = (np.arange(n, dtype=np.int32) % (g_pad - 2))
    topo_ids[:4] = -1
    cap = np.tile(np.array([4000, 8192, 100000, 150], np.float32), (n, 1))
    return make_gang_state(
        capacity=cap, sched_capacity=cap * 0.75, util=np.zeros((n, 4)),
        bw_avail=np.full(n, 1000.0), bw_used=np.zeros(n),
        ports_free=np.full(n, 256.0), feas_row=np.ones(n, bool),
        job_count=np.zeros(n, np.int32), dh_presence=np.zeros(n, np.int32),
        topo_ids=topo_ids)


def random_gang_state(rng, n, rack, singletons=False):
    """tests/test_torch_gang.py's seeded cluster: racks with nodes
    lacking topology, free ports and bandwidth that bind, job_count and
    distinct_hosts conflicts; ``singletons`` gives every node its own
    group, ids shuffled over the node axis."""
    cap = np.tile(np.array([[2000, 4000, 10000, 100]], np.float32), (n, 1))
    sched = cap - np.array([[100, 200, 0, 0]], np.float32)
    sched[rng.random(n) < 0.03, 1] = 0.0  # the zero-capacity guard binds
    util = (cap - sched) + np.stack(
        [rng.integers(0, 30, n) * 50, rng.integers(0, 30, n) * 100,
         np.zeros(n), np.zeros(n)], 1).astype(np.float32)
    topo = (np.arange(n) // rack).astype(np.int32)
    if singletons:
        topo = rng.permutation(n).astype(np.int32)
    topo[rng.random(n) < 0.1] = -1
    return make_gang_state(
        cap, sched, util, np.full(n, 100.0), rng.integers(0, 5, n) * 20.0,
        rng.integers(0, 4, n), rng.random(n) < 0.9, rng.integers(0, 3, n),
        (rng.random(n) < 0.1).astype(np.int32), topo)


def gang_three_ways(w, state, ask, active, key, config):
    """(JAX sharded, port sharded, port unsharded) of one gang, each as
    numpy (choices, scores, slice_group)."""
    jstate = jmesh.shard_gang_inputs(jmesh.make_mesh(w, dp=1), state)
    want = gang_placement_program_jit(jstate, *ask, active, key, config)
    pcfg = tg.GangConfig(*config)
    pstate = tg.make_gang_state(*state)
    got = tg.gang_placement(tmesh.shard_gang_inputs(cpu_mesh(w), pstate),
                            *ask, active, key, pcfg)
    one = tg.gang_placement(pstate, *ask, active, key, pcfg, "cpu")
    return tuple(tuple(np.asarray(x) for x in out)
                 for out in (want, got, one))


@pytest.mark.parametrize("w", WIDTHS)
def test_sharded_gang_matches_graft_item_3(w):
    """Item 3: the slice gang on a node-sharded GangState, integer data,
    noise off: choices, scores and slice group equal the JAX package's
    sharded program bit for bit, and the port's unsharded K7."""
    n, g_pad = 128 * w, 16
    state = graft_gang_state(n, g_pad)
    ask = (np.array([500, 256, 150, 0], np.float32), np.float32(50.0),
           np.float32(2.0))
    active = np.ones(8, bool)
    config = GangConfig(anti_affinity_penalty=10.0, mode="slice",
                        distinct_hosts=False, g_pad=g_pad, noise_scale=0.0)
    want, got, one = gang_three_ways(w, state, ask, active,
                                     jb.host_prng_key(7), config)
    for x, y, z in zip(want, got, one):
        np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(y, z)
    assert (got[0] >= 0).all() and int(got[2]) >= 0


@pytest.mark.parametrize("w", WIDTHS)
@pytest.mark.parametrize("dh", [False, True])
@pytest.mark.parametrize("mode", ["slice", "spread", "affinity", "free"])
def test_sharded_gang_every_mode_noise_on(mode, dh, w):
    """Every gang mode, with and without distinct_hosts, the production
    noise, racks of 12 that straddle the shard edges, padded members:
    choices and slice group equal JAX's, scores within SCORE_TOL;
    everything equal to the port's unsharded program."""
    rng = np.random.default_rng(w * 10 + dh)
    n = 96 * w
    state = random_gang_state(rng, n, 12)
    active = np.zeros(8, bool)
    active[:int(rng.integers(4, 9))] = True
    ask = (np.array([400, 256, 0, 0], np.float32), np.float32(10.0),
           np.float32(1.0))
    config = GangConfig(anti_affinity_penalty=10.0, mode=mode,
                        distinct_hosts=dh, g_pad=16)
    want, got, one = gang_three_ways(w, state, ask, active,
                                     jb.host_prng_key(40 + w), config)
    np.testing.assert_array_equal(want[0], got[0])
    assert int(want[2]) == int(got[2])
    assert np.abs(want[1] - got[1]).max() <= SCORE_TOL
    for y, z in zip(got, one):
        np.testing.assert_array_equal(y, z)
    assert (got[0][active] >= 0).all()


@pytest.mark.parametrize("w", [2, 8])
@pytest.mark.parametrize("mode", ["spread", "affinity", "free"])
def test_sharded_gang_past_1024_groups(mode, w):
    """Every node its own group, ids shuffled over the node axis
    (g_pad 2,048, past K7's shared-memory groups), as a level the nodes
    lack gives in free, spread and affinity mode: the winner's group id
    travels from its owning shard, and every shard counts it."""
    rng = np.random.default_rng(5 + w)
    n = 2048
    state = random_gang_state(rng, n, 1, singletons=True)
    active = np.ones(16, bool)
    ask = (np.array([400, 256, 0, 0], np.float32), np.float32(10.0),
           np.float32(1.0))
    config = GangConfig(anti_affinity_penalty=10.0, mode=mode, g_pad=2048)
    want, got, one = gang_three_ways(w, state, ask, active,
                                     jb.host_prng_key(11), config)
    np.testing.assert_array_equal(want[0], got[0])
    assert np.abs(want[1] - got[1]).max() <= SCORE_TOL
    for y, z in zip(got, one):
        np.testing.assert_array_equal(y, z)


def test_sharded_gang_group_id_crosses_shards():
    """The spread cap binds only if every shard counts the members the
    others placed: racks of 8 straddling two shards, a cap of 1 a rack
    (K = 8 over 8 eligible racks). A winner whose group id stayed on its
    own shard would place two members in a rack."""
    n, w = 64, 4
    caps = [(4000, 8000)] * n
    state = make_gang_state(
        capacity=np.array([[c, m, 1e5, 1e4] for c, m in caps], np.float32),
        sched_capacity=np.array([[c, m, 1e5, 1e4] for c, m in caps],
                                np.float32),
        util=np.zeros((n, 4)), bw_avail=np.full(n, 1e9),
        bw_used=np.zeros(n), ports_free=np.full(n, 100),
        feas_row=np.ones(n, bool), job_count=np.zeros(n, np.int32),
        dh_presence=np.zeros(n, np.int32),
        topo_ids=((np.arange(n) + 4) // 8 % 8).astype(np.int32))
    config = GangConfig(anti_affinity_penalty=0.0, mode="spread", g_pad=16)
    ask = (np.array([400, 256, 0, 0], np.float32), np.float32(0.0),
           np.float32(0.0))
    want, got, one = gang_three_ways(w, state, ask, np.ones(8, bool),
                                     jb.host_prng_key(2), config)
    np.testing.assert_array_equal(want[0], got[0])
    racks = np.asarray(state.topo_ids)[got[0]]
    assert sorted(racks.tolist()) == list(range(8))


# ------------------------------------------------------------ K10f


def _defrag_mesh_case(h, w, **kw):
    """One cold then one warm round of both packages' defrag solve on
    ``w`` shards (the warm round from the JAX solver's carried logits);
    returns the two JAX plans."""
    hp = torch_parity.carry_over(h)
    jwarm, pwarm = JaxWarmState(), WarmState()
    jm, pm = jmesh.make_mesh(w, dp=1), cpu_mesh(w)
    kw = dict(max_moves=8, min_gain=0.0, **kw)
    plans = []
    for round_ in range(2):
        if round_:
            pwarm = carry.warm_state_from_numpy(jwarm.key, jwarm.logits)
        want = jax_compute_defrag_plan(h.state.snapshot(), ["dc1"],
                                       warm=jwarm, mesh=jm, **kw)
        got = compute_defrag_plan(hp.state.snapshot(), ["dc1"], warm=pwarm,
                                  mesh=pm, **kw)
        _same_plan(want, got)
        assert set(pwarm.logits) == set(jwarm.logits)
        for alloc_id, row in jwarm.logits.items():
            assert_close(row, pwarm.logits[alloc_id], LOGIT_TOL, True)
        plans.append(want)
    return plans


@pytest.mark.parametrize("w", WIDTHS)
@pytest.mark.parametrize("cluster", ["consolidation", "fragmented"])
def test_sharded_defrag_plan_matches(cluster, w):
    """``compute_defrag_plan(..., mesh=)`` on the uncompressed solve,
    cold then warm, in both packages: the same moves, the warm start's
    rows in global node order (the warm round solves from them)."""
    h = _consolidation(8101) if cluster == "consolidation" \
        else fragmented_harness()
    cold, warm = _defrag_mesh_case(h, w, class_compress=False)
    assert not cold.warm and warm.warm and cold.candidates
    assert cold.n % w == 0 and not cold.compressed
    if cluster == "fragmented":
        assert cold.moves


def test_defrag_mesh_ignored_when_compressed_or_uneven(monkeypatch):
    """The compressed solve, and a node count that does not divide over
    the shards (128 nodes over 3), solve on one device in both
    packages: the plan and the carried logits equal the mesh-less
    round's exactly, and the sharded solve never runs."""
    from nomad_tpu_torch.defrag import solver

    monkeypatch.setattr(solver, "_solve_sharded", None)
    h = fragmented_harness()
    hp = torch_parity.carry_over(h)
    for compress, w in ((True, 4), (False, 3)):
        kw = dict(max_moves=8, min_gain=0.0, class_compress=compress)
        a, b = WarmState(), WarmState()
        plain = compute_defrag_plan(hp.state.snapshot(), ["dc1"], warm=a,
                                    **kw)
        meshed = compute_defrag_plan(hp.state.snapshot(), ["dc1"], warm=b,
                                     mesh=cpu_mesh(w), **kw)
        assert plain.compressed == compress
        assert compress or plain.n % w
        _same_plan(plain, meshed)
        for alloc_id, row in a.logits.items():
            np.testing.assert_array_equal(row, b.logits[alloc_id])
        _defrag_mesh_case(h, w, class_compress=compress)


def defrag_shards(args, w):
    """K9's host arguments split into ``w`` DefragShards on the CPU."""
    placed = tmesh.shard_defrag_inputs(
        cpu_mesh(w), [np.ascontiguousarray(a) for a in args])
    return [tshard.DefragShard(lo, *(x.parts[0][s] for x in placed))
            for s, lo in enumerate(placed[0].lo)]


@pytest.mark.parametrize("w", WIDTHS)
@pytest.mark.parametrize("warm", [False, True])
def test_sharded_defrag_solve_tracks_float64(warm, w):
    """K10f alone against the float64 solve, as tests/test_torch_defrag.py
    holds K9: at 2, 5 and 8 steps within 10x the JAX sharded solve's
    own distance from float64 (plus 1e-5), a bound under CHAOS_CAP; one
    shard equals K9's plain version bit for bit."""
    args = _solve_inputs(warm)
    jargs = jmesh.shard_defrag_inputs(jmesh.make_mesh(w, dp=1), args)
    t64 = [torch.from_numpy(np.array(a)) for a in args]
    t64 = [t.double() if t.dtype == torch.float32 else t for t in t64]
    for iters in (2, 5, 8):
        want = [np.asarray(x) for x in _solve_jit()(*jargs, iters=iters)]
        got = [np.concatenate([o[i].numpy() for o in tshard.sharded_relax(
            defrag_shards(args, w), iters)], axis=1) for i in (0, 1)]
        ref = tc.defrag_solve_plain(*t64, iters)
        for kind, w_, g_, r_ in zip(("logits", "x"), want, got, ref):
            port_err = solve_err(g_, r_.numpy(), kind)
            bound = 10.0 * solve_err(w_, r_.numpy(), kind) + 1e-5
            assert bound < CHAOS_CAP, (iters, kind, bound)
            assert port_err <= bound, (iters, kind, port_err, bound)
        assert np.abs(got[1][-5:]).max() == 0.0  # inactive rows: no mass
    one = tshard.sharded_relax(defrag_shards(args, 1), 5)[0]
    t32 = [torch.from_numpy(np.array(a)) for a in args]
    plain = tc.defrag_solve_plain(*t32, 5)
    assert torch.equal(one[0], plain[0]) and torch.equal(one[1], plain[1])


# ------------------------------------------------------------ K10g


CONVEX = CONFIG._replace(kernel="convex")
REF_CONVEX = REF_CONFIG._replace(kernel="convex")


def relax_shards(state, asks, w):
    """One eval's placement relaxation inputs as ``w`` NodeShards."""
    ts = carry.node_state_from_numpy(state, "cpu")
    ta = carry.asks_from_numpy(asks, "cpu")
    un = lambda t: t.unsqueeze(0).contiguous()  # noqa: E731
    n = ts.capacity.shape[0]
    out = []
    for lo, hi in tmesh.shard_bounds(n, w):
        cut = lambda t, d=0: t.narrow(d, lo, hi - lo).contiguous()  # noqa
        out.append(tshard.NodeShard(
            lo, cut(ts.capacity), cut(ts.sched_capacity), cut(ts.bw_avail),
            cut(ts.node_ok),
            (un(cut(ts.util)), un(cut(ts.bw_used)), un(cut(ts.ports_free)),
             un(cut(ts.job_count)), un(cut(ts.tg_count))),
            un(cut(ts.feasible)), tb.Asks(*(un(x) for x in ta)), None))
    return out


@pytest.mark.parametrize("w", [1, 2, 4, 8])
@pytest.mark.parametrize("case", ["plain", "infeasible", "ports"])
def test_sharded_relaxation_matches(case, w):
    """K10g-a: x and pref over the shards, joined in node order, within
    X_TOL of the JAX relaxation; rows whose every entry is NEG_INF come
    out uniform over the WHOLE node axis (1 / N, not 1 / N_shard); one
    shard is the unsharded relaxation bit for bit."""
    from test_torch_convex import _relax_jit, convex_world

    n, k = 128, 32
    state, asks, _key = convex_world(60, n, k, case)
    want = np.asarray(_relax_jit(state, asks, jb.PlacementConfig(
        anti_affinity_penalty=10.0, kernel="convex")))
    out = tshard.sharded_relax(relax_shards(state, asks, w),
                               tc.SOLVE_ITERS, 10.0)
    x = torch.cat([o[1] for o in out], dim=-1)[0]
    pref = torch.cat([o[2] for o in out], dim=-1)[0]
    assert np.abs(want - x.numpy()).max() <= X_TOL
    y = want.sum(0)
    want_pref = (want / (want.max(1, keepdims=True) + 1e-9)
                 + y[None] / (y.max() + 1e-9)) * 0.5
    assert np.abs(want_pref - pref.numpy()).max() <= X_TOL
    if case == "infeasible":
        np.testing.assert_allclose(x[:8].numpy(), 1.0 / n, rtol=1e-6)
    if w == 1:
        sh = relax_shards(state, asks, 1)[0]
        one = tc.relaxed_assignment(sh.capacity, sh.sched_capacity,
                                    sh.bw_avail, sh.node_ok, sh.carry,
                                    sh.feasible, sh.asks, 10.0)
        for a, b in zip(out[0], one):
            assert torch.equal(a, b)


@pytest.mark.parametrize("w", WIDTHS)
def test_sharded_convex_placement_lone(w):
    """The lone convex program on W shards (K0 windows, K10g-a, K10g-b)
    against the JAX package's sharded_placement with kernel "convex":
    choices equal, scores within SCORE_TOL; and the port's unsharded
    convex program's choices and scores exactly (the score at a choice
    does not read the preference)."""
    state, asks, keys = build_inputs(n=128 * w, k=12, seed=w)
    got = tmesh.sharded_placement(cpu_mesh(w), np_state(state),
                                  np_asks(asks), keys, CONVEX)
    want = jmesh.sharded_placement(jmesh.make_mesh(w, dp=1), state, asks,
                                   keys, REF_CONVEX)
    assert_same_choices(got, want)
    one = port_unsharded(state, asks, keys, CONVEX, False)
    assert torch.equal(got[0], one[0]) and torch.equal(got[1], one[1])
    np.testing.assert_array_equal(tmesh.gather(got[2].util).numpy(),
                                  one[2].util.numpy())
    assert (got[0] >= 0).sum() > 0


@pytest.mark.parametrize("dp", [1, 2])
def test_sharded_convex_placement_stacked(dp):
    """Stacked states (a base per eval) with the convex kernel, on a 2x4
    and a 1x8 mesh, against the JAX package's batched sharded program."""
    state, asks, keys = build_inputs(n=256, k=8, batch=2 * dp, seed=3)
    w = 8 // dp
    got = tmesh.sharded_placement(cpu_mesh(w, dp), np_state(state),
                                  np_asks(asks), keys, CONVEX, batched=True)
    want = jmesh.sharded_placement(jmesh.make_mesh(w * dp, dp=dp), state,
                                   asks, keys, REF_CONVEX, batched=True)
    assert_same_choices(got, want)
    one = port_unsharded(state, asks, keys, CONVEX, True)
    assert torch.equal(got[0], one[0]) and torch.equal(got[1], one[1])


@pytest.mark.parametrize("pre_resolve", [False, True],
                         ids=["independent", "pre_resolve"])
@pytest.mark.parametrize("w", [2, 8])
def test_sharded_convex_round_matches_plain_rounding(w, pre_resolve):
    """K10g-b fed one preference (random, a shard's columns each):
    choices, scores and the carried tensors equal K8b's rounding scan on
    the whole node axis bit for bit, in the independent and the
    sequential layouts."""
    from test_torch_parallel import compact_batch

    n, b, k, g = 64 * w, 4, 10, 2
    base, overlay, asks, keys = compact_batch(n, b, k, g, 70 + w, False)
    flat = tb.device_resident([*base, *overlay, *asks], "cpu")
    cap, sched, util, bw_avail, bw_used, ports, ok, cid = flat[:8]
    feas, jc, tgc = tb.expand_overlay(cid, tb.CompactOverlay(*flat[8:13]),
                                      n)
    ta = tb.Asks(*flat[13:])
    noise = tp.threefry_uniform(tb.keys_tensor(keys, "cpu"), (k, n), 0.0,
                                2.0)
    pref = torch.rand((b, k, n), generator=torch.Generator().manual_seed(w))
    seq = pre_resolve
    whole = tb.fresh_carry(util, bw_used, ports, jc, tgc, b, seq)
    want = tc.convex_round(cap, sched, bw_avail, ok, whole, feas, ta, noise,
                           10.0, pref, seq)
    carry_ = tb.fresh_carry(util, bw_used, ports, jc, tgc, b, seq)
    own = 0 if seq else 1
    shards = []
    for lo, hi in tmesh.shard_bounds(n, w):
        cut = lambda t, d: t.narrow(d, lo, hi - lo).contiguous()  # noqa
        shards.append(tshard.NodeShard(
            lo, cut(cap, 0), cut(sched, 0), cut(bw_avail, 0), cut(ok, 0),
            (cut(carry_[0], own), cut(carry_[1], own), cut(carry_[2], own),
             cut(carry_[3], 1), cut(carry_[4], 1)), cut(feas, 1), ta,
            cut(noise, 2), cut(pref, 2)))
    got = tshard.sharded_convex_round(shards, 10.0, seq)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for i in range(5):
        joined = torch.cat([sh.carry[i] for sh in shards],
                           dim=own if i < 3 else 1)
        assert torch.equal(joined, whole[i])
    assert (got[0] >= 0).sum() > 0


@pytest.mark.parametrize("pre_resolve", [False, True],
                         ids=["independent", "pre_resolve"])
@pytest.mark.parametrize("w", WIDTHS)
def test_convex_compact_dispatch_over_shards(w, pre_resolve):
    """The batcher's compact dispatch with the convex kernel over a
    node-sharded base (K3 with a row offset, then K10g; under
    pre_resolve eval by eval over the shared claimed capacity) against
    the JAX compact program on a base sharded over its mesh (choices
    equal, scores within SCORE_TOL) and the port's unsharded compact
    program (choices and scores equal)."""
    from jax.sharding import NamedSharding
    from test_torch_parallel import compact_batch

    n, b, k, g = 64 * w, 4, 10, 2
    base, overlay, asks, keys = compact_batch(n, b, k, g, 90 + w, False)
    cfg = CONVEX._replace(pre_resolve=pre_resolve)
    dev = tmesh.upload_base(cpu_mesh(w), base)
    placed, _ = tmesh.place_payload(
        dev, [keys.astype(np.int64), *asks, *overlay], True)
    got = tmesh.sharded_dispatch(dev, placed, True, cfg)
    jm = jmesh.make_mesh(w, dp=1)
    jbase = jax.device_put(tuple(base), tuple(
        NamedSharding(jm, s) for s in jmesh.base_specs()))
    ref = jb.batched_placement_program_compact(
        *jbase, jb.CompactOverlay(*overlay), jb.Asks(*asks), keys,
        REF_CONVEX._replace(pre_resolve=pre_resolve))
    assert_same_choices(got, ref)
    flat = tb.device_resident([*base, *overlay, *asks], "cpu")
    want = tb.batched_placement_program_compact(
        *flat[:8], tb.CompactOverlay(*flat[8:13]), tb.Asks(*flat[13:]),
        tb.keys_tensor(keys, "cpu"), cfg)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert (np.asarray(got[0]) >= 0).sum() > b


def test_kernel_without_a_sharded_program_raises():
    """A kernel registered without a node-sharded program is refused by
    name over a sharded base (the greedy and convex kernels have one)."""
    from test_torch_parallel import compact_batch

    base, overlay, asks, keys = compact_batch(128, 2, 4, 2, 3, False)
    dev = tmesh.upload_base(cpu_mesh(2), base)
    placed, _ = tmesh.place_payload(
        dev, [keys.astype(np.int64), *asks, *overlay], True)
    with pytest.raises(ValueError, match="'custom' has no node-sharded"):
        tmesh.sharded_dispatch(dev, placed, True,
                               CONFIG._replace(kernel="custom"))


def test_convex_dense_overlay_dispatch_over_shards():
    """The dense overlay layout (job_count, tg_count, feasible split over
    the nodes) with the convex kernel under pre_resolve equals the
    compact one on the same evals."""
    from test_torch_parallel import compact_batch

    w, n, b, k, g = 4, 256, 3, 8, 2
    base, overlay, asks, keys = compact_batch(n, b, k, g, 17, False)
    cfg = CONVEX._replace(pre_resolve=True)
    dev = tmesh.upload_base(cpu_mesh(w), base)
    host = [keys.astype(np.int64), *asks, *overlay]
    compact = tmesh.sharded_dispatch(
        dev, tmesh.place_payload(dev, host, True)[0], True, cfg)
    feas, jc, tgc = tb.expand_overlay(torch.from_numpy(base[7]),
                                      tb.CompactOverlay(*(
                                          torch.from_numpy(np.asarray(x))
                                          for x in overlay)), n)
    host = [keys.astype(np.int64), *asks, jc.numpy(), tgc.numpy(),
            feas.numpy()]
    dense = tmesh.sharded_dispatch(
        dev, tmesh.place_payload(dev, host, False)[0], False, cfg)
    assert torch.equal(compact[0], dense[0])
    assert torch.equal(compact[1], dense[1])
    assert (compact[0] >= 0).sum() > 0
