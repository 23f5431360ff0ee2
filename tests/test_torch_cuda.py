"""The port's CUDA kernels against their plain PyTorch versions, on the
card, at small shapes that reach every branch: free ports and
distinct_hosts (per task group and per job) that limit where asks fit,
inactive asks, asks past the node count, a node bucket whose top-k
sorts in global scratch, overlay rows padded with N, the sequential
(pre_resolve) and stacked batch layouts of the scans, base deltas
with padding rows, preemption where victims, ports and distinct_hosts
bind, every gang mode, and the convex kernel's relaxation (placement
and defrag modes, every batch layout) and rounding scan.

Marked ``cuda``; without a CUDA card every test skips. On the card's
machine, which need not have JAX (tests/conftest.py configures it):

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py -q
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from nomad_tpu_torch.kernels import convex
from nomad_tpu_torch.ops import binpack, cuda, gang, preempt, prng

pytestmark = pytest.mark.cuda

CARRY = ("util", "bw_used", "ports_free", "job_count", "tg_count")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def scan_inputs(n, k, g, b, seed, dev):
    """Static node rows, a carried base, and asks that the ports and
    distinct_hosts limits bind."""
    rng = np.random.default_rng(seed)
    cap = np.tile(np.array([[4000, 8192, 102400, 150]], np.float32), (n, 1))
    sched = cap - np.array([[100, 256, 4096, 0]], np.float32)
    util = (cap - sched) + np.stack(
        [rng.integers(0, 20, n) * 50, rng.integers(0, 20, n) * 64,
         np.zeros(n), np.zeros(n)], 1).astype(np.float32)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    static = (t(cap), t(sched), t(np.full(n, 1000, np.float32)),
              t(rng.random(n) < 0.95))
    base = (t(util), t(rng.integers(0, 10, n).astype(np.float32) * 50),
            t(rng.integers(0, 7, n).astype(np.float32)),
            t(rng.integers(0, 2, (b, n)).astype(np.int32)),
            t(rng.integers(0, 2, (b, n, g)).astype(np.int32)))
    res = np.stack([rng.integers(1, 11, (b, k)) * 100,
                    rng.integers(1, 5, (b, k)) * 128,
                    np.full((b, k), 300), np.zeros((b, k))], 2)
    active = np.ones((b, k), bool)
    active[:, -3:] = False
    asks = binpack.Asks(
        resources=t(res.astype(np.float32)),
        bw=t(rng.integers(0, 3, (b, k)).astype(np.float32) * 50),
        ports=t(rng.integers(1, 3, (b, k)).astype(np.float32)),
        tg_index=t(rng.integers(0, g, (b, k)).astype(np.int32)),
        active=t(active),
        job_distinct_hosts=t(np.arange(b) % 3 == 2),
        tg_distinct_hosts=t(np.tile(np.arange(g) == 0, (b, 1))))
    feasible = t(rng.random((b, n, g)) < 0.9)
    return static, base, feasible, asks


def fresh(base, b, n):
    """Per-eval copies of the base (clones: at B = 1 the expanded view
    is already contiguous, and the scans update their carry in place)."""
    util, bw, ports, jc, tgc = base
    return tuple(x.clone(memory_format=torch.contiguous_format) for x in (
        util.expand(b, n, 4), bw.expand(b, n), ports.expand(b, n), jc, tgc))


def assert_scans_agree(kernel, plain):
    (ch, sc, c_k), (ch_p, sc_p, c_p) = kernel, plain
    assert torch.equal(ch, ch_p)
    assert (sc - sc_p).abs().max().item() <= 1e-4
    for name, x, y in zip(CARRY, c_k, c_p):
        assert torch.equal(x, y), name


@pytest.mark.parametrize("b,k,n", [(1, 8, 128), (4, 16, 256), (2, 1, 10240)])
def test_threefry_uniform_bits(dev, b, k, n):
    keys = torch.from_numpy(np.random.default_rng(b).integers(
        0, 2**32, (b, 2), dtype=np.uint64).astype(np.int64)).to(dev)
    got = prng.threefry_uniform(keys, (k, n), 0.0, 2.0)
    want = prng.threefry_uniform_plain(keys, (k, n), 0.0, 2.0)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("b,n,k,g", [(1, 300, 64, 2), (5, 777, 200, 3)])
def test_greedy_scan_matches_plain(dev, b, n, k, g):
    static, base, feasible, asks = scan_inputs(n, k, g, b, n, dev)
    keys = torch.arange(2 * b, device=dev).view(b, 2)
    noise = prng.threefry_uniform(keys, (k, n), 0.0, 2.0)
    runs = []
    for fn in (binpack.greedy_scan, binpack.greedy_scan_plain):
        c = fresh(base, b, n)
        runs.append((*fn(*static, c, feasible, asks, noise, 10.0), c))
    assert_scans_agree(*runs)
    placed = runs[0][0] >= 0
    assert placed.any() and not placed.all()
    # The port limit binds: some node ends with fewer ports than an ask.
    assert ((base[2] >= 2) & (runs[0][2][2] < 2)).any()


@pytest.mark.parametrize("b,n,k", [(1, 1000, 64), (3, 100, 128),
                                   (2, 40000, 256)])
def test_uniform_topk_matches_plain(dev, b, n, k):
    static, base, feasible, asks = scan_inputs(n, k, 2, b, n, dev)
    asks = asks._replace(
        resources=asks.resources[:, :1].expand(b, k, 4).contiguous(),
        bw=asks.bw[:, :1].expand(b, k).contiguous(),
        ports=asks.ports[:, :1].expand(b, k).contiguous(),
        tg_index=torch.zeros_like(asks.tg_index),
        tg_distinct_hosts=torch.ones_like(asks.tg_distinct_hosts))
    noise = prng.threefry_uniform(
        torch.arange(2 * b, device=dev).view(b, 2), (n,), 0.0, 2.0)
    runs = []
    for fn in (binpack.uniform_topk, binpack.uniform_topk_plain):
        c = fresh(base, b, n)
        runs.append((*fn(*static, c, feasible, asks, noise, 10.0), c))
    assert_scans_agree(*runs)
    if k > n:
        assert (runs[0][0][:, n:] == -1).all()


@pytest.mark.parametrize("b,n", [(1, 500), (4, 3000)])
def test_expand_overlay_matches_plain(dev, b, n):
    rng = np.random.default_rng(n)
    g, c, p, j = 2, 16, 32, 64
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    patch_rows = np.full((b, p), n, np.int32)
    patch_rows[:, :20] = np.stack([rng.choice(n, 20, replace=False)
                                   for _ in range(b)])
    job_rows = np.full((b, j), n, np.int32)
    job_rows[:, :50] = rng.integers(0, n // 10, (b, 50))  # duplicate rows
    ov = binpack.CompactOverlay(
        verdicts=t(rng.random((b, c, g)) < 0.7), patch_rows=t(patch_rows),
        patch_vals=t(rng.random((b, p, g)) < 0.5), job_rows=t(job_rows),
        job_tgs=t(rng.integers(0, g, (b, j)).astype(np.int32)))
    class_ids = t(rng.integers(-1, c, n).astype(np.int32))
    got = binpack.expand_overlay(class_ids, ov, n)
    want = binpack.expand_overlay_plain(class_ids, ov, n)
    for x, y in zip(got, want):
        assert torch.equal(x, y)


def test_wrappers_count_their_launches(dev):
    keys = torch.zeros((1, 2), dtype=torch.int64, device=dev)
    before = cuda.launch_counts().get("threefry_uniform", 0)
    prng.threefry_uniform(keys, (4, 32), 0.0, 1.0)
    prng.threefry_uniform_plain(keys, (4, 32), 0.0, 1.0)
    assert cuda.launch_counts()["threefry_uniform"] == before + 1


def shared_carry(base):
    """One shared copy of the claimed capacity (the sequential layout)
    and per-eval job and task-group counts."""
    util, bw, ports, jc, tgc = base
    return tuple(x.clone() for x in (util, bw, ports, jc, tgc))


@pytest.mark.parametrize("b,n,k,g", [(4, 300, 64, 2), (6, 777, 40, 3)])
def test_greedy_scan_seq_matches_plain(dev, b, n, k, g):
    """The pre_resolve layout: one block walks the evals in order over
    one shared copy of util/bw_used/ports_free."""
    static, base, feasible, asks = scan_inputs(n, k, g, b, n + 1, dev)
    keys = torch.arange(2 * b, device=dev).view(b, 2)
    noise = prng.threefry_uniform(keys, (k, n), 0.0, 2.0)
    runs = []
    for fn in (binpack.greedy_scan, binpack.greedy_scan_plain):
        c = shared_carry(base)
        runs.append((*fn(*static, c, feasible, asks, noise, 10.0, True), c))
    assert_scans_agree(*runs)
    # Later evals see earlier claims: the shared ports run out.
    assert ((base[2] >= 2) & (runs[0][2][2] < 2)).any()


@pytest.mark.parametrize("b,n,k", [(8, 1000, 16), (3, 40000, 64)])
def test_uniform_topk_seq_matches_plain(dev, b, n, k):
    static, base, feasible, asks = scan_inputs(n, k, 2, b, n + 2, dev)
    asks = asks._replace(
        resources=asks.resources[:, :1].expand(b, k, 4).contiguous(),
        bw=asks.bw[:, :1].expand(b, k).contiguous(),
        ports=asks.ports[:, :1].expand(b, k).contiguous(),
        tg_index=torch.zeros_like(asks.tg_index),
        tg_distinct_hosts=torch.ones_like(asks.tg_distinct_hosts))
    noise = prng.threefry_uniform(
        torch.arange(2 * b, device=dev).view(b, 2), (n,), 0.0, 2.0)
    runs = []
    for fn in (binpack.uniform_topk, binpack.uniform_topk_plain):
        c = shared_carry(base)
        runs.append((*fn(*static, c, feasible, asks, noise, 10.0, True), c))
    assert_scans_agree(*runs)


@pytest.mark.parametrize("uniform", [False, True])
def test_stacked_scans_match_plain(dev, uniform):
    """Per-eval bases (batched_placement_program's stacked states):
    the static rows carry the batch axis."""
    b, n, k, g = 4, 500, 32, 2
    static, base, feasible, asks = scan_inputs(n, k, g, b, 7, dev)
    rng = np.random.default_rng(8)
    scale = torch.from_numpy(rng.integers(1, 3, (b, n, 1)).astype(
        np.float32)).to(dev)
    cap = (static[0] * scale).contiguous()
    stacked = (cap, (cap - (static[0] - static[1])).contiguous(),
               static[2].expand(b, n).contiguous(),
               torch.from_numpy(rng.random((b, n)) < 0.9).to(dev))
    keys = torch.arange(2 * b, device=dev).view(b, 2)
    if uniform:
        asks = asks._replace(
            resources=asks.resources[:, :1].expand(b, k, 4).contiguous(),
            bw=asks.bw[:, :1].expand(b, k).contiguous(),
            ports=asks.ports[:, :1].expand(b, k).contiguous(),
            tg_index=torch.zeros_like(asks.tg_index),
            tg_distinct_hosts=torch.ones_like(asks.tg_distinct_hosts))
        noise = prng.threefry_uniform(keys, (n,), 0.0, 2.0)
        fns = (binpack.uniform_topk, binpack.uniform_topk_plain)
    else:
        noise = prng.threefry_uniform(keys, (k, n), 0.0, 2.0)
        fns = (binpack.greedy_scan, binpack.greedy_scan_plain)
    runs = []
    for fn in fns:
        c = fresh(base, b, n)
        runs.append((*fn(*stacked, c, feasible, asks, noise, 10.0), c))
    assert_scans_agree(*runs)


@pytest.mark.parametrize("n,r", [(1000, 256), (10240, 4096)])
def test_base_delta_matches_plain(dev, n, r):
    """K4 bit-equal to its plain version, padding rows repeating the
    first changed row; the parent arrays stay as they were."""
    rng = np.random.default_rng(r)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    parent = (t(rng.random((n, 4)).astype(np.float32)),
              t(rng.random(n).astype(np.float32)),
              t(rng.random(n).astype(np.float32)), t(rng.random(n) < 0.5))
    real = min(r - 3, n)
    rows = np.full(r, 0, np.int32)
    rows[:real] = rng.choice(n, real, replace=False)
    rows[real:] = rows[0]
    vals = (rng.random((r, 4)).astype(np.float32),
            rng.random(r).astype(np.float32),
            rng.random(r).astype(np.float32), rng.random(r) < 0.5)
    for v in vals:
        v[real:] = v[0]
    payload = (t(rows), *(t(v) for v in vals))
    before = [x.clone() for x in parent]
    got = binpack.apply_base_delta(*parent, *payload)
    want = binpack.apply_base_delta_plain(*parent, *payload)
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    for x, y in zip(parent, before):
        assert torch.equal(x, y)


def preempt_inputs(n, k, g, seed, dev, dh=True):
    """A crowded cluster for K6: most nodes full, a few with room;
    per node up to 8 priority-sorted victims (some outranking the
    eval, some holding ports and bandwidth); asks with ports, under
    task-group distinct_hosts on group 0 when ``dh``."""
    rng = np.random.default_rng(seed)
    v = preempt.PREEMPT_MAX_VICTIMS
    t = lambda x: torch.from_numpy(np.array(x)).to(dev)
    cap = np.tile(np.array([[1000, 2000, 10000, 100]], np.float32), (n, 1))
    sched = cap - np.array([[100, 200, 0, 0]], np.float32)
    util = (cap - sched) + np.stack(
        [rng.integers(12, 19, n) * 50, rng.integers(10, 19, n) * 100,
         np.zeros(n), np.zeros(n)], 1).astype(np.float32)
    util[rng.random(n) < 0.05, :2] = (300, 400)  # room without eviction
    state = binpack.NodeState(
        capacity=t(cap), sched_capacity=t(sched), util=t(util),
        bw_avail=t(np.full(n, 100, np.float32)),
        bw_used=t(rng.integers(0, 5, n).astype(np.float32) * 20),
        ports_free=t(rng.integers(0, 3, n).astype(np.float32)),
        job_count=t(rng.integers(0, 2, n).astype(np.int32)),
        tg_count=t(rng.integers(0, 2, (n, g)).astype(np.int32)),
        feasible=t(rng.random((n, g)) < 0.9), node_ok=t(rng.random(n) < 0.95))
    res = np.zeros((n, v, 4), np.float32)
    vbw = np.zeros((n, v), np.float32)
    vports = np.zeros((n, v), np.float32)
    prio = np.full((n, v), np.inf, np.float32)
    ok = np.zeros((n, v), bool)
    for i in range(n):
        m = int(rng.integers(0, v + 1))
        prio[i, :m] = np.sort(rng.integers(5, 80, m))
        res[i, :m, 0] = rng.integers(1, 6, m) * 50
        res[i, :m, 1] = rng.integers(1, 6, m) * 100
        vbw[i, :m] = rng.integers(0, 3, m) * 10
        vports[i, :m] = rng.integers(0, 2, m)
        ok[i, :m] = True
    victims = preempt.VictimState(t(res), t(vbw), t(vports), t(prio), t(ok))
    active = np.ones(k, bool)
    active[-3:] = False
    asks = binpack.Asks(
        resources=t(np.tile(np.array([[300, 400, 0, 0]], np.float32),
                            (k, 1))),
        bw=t(np.full(k, 20, np.float32)), ports=t(np.ones(k, np.float32)),
        tg_index=t(rng.integers(0, g, k).astype(np.int32)), active=t(active),
        job_distinct_hosts=t(np.array(False)),
        tg_distinct_hosts=t((np.arange(g) == 0) & dh))
    return state, victims, asks


def preempt_carry(state, victims):
    return (state._replace(util=state.util.clone(),
                           bw_used=state.bw_used.clone(),
                           ports_free=state.ports_free.clone(),
                           job_count=state.job_count.clone(),
                           tg_count=state.tg_count.clone()),
            victims.ok.clone())


@pytest.mark.parametrize("n,k,dh", [(300, 64, True), (2000, 256, True),
                                   (40, 64, False)])
def test_preempt_scan_matches_plain(dev, n, k, dh):
    """K6 against its plain version: choices, n_victims, scores, and
    the final carry (util, bw_used, ports_free, job_count, tg_count and
    the consumed-victim mask). Without distinct_hosts, 64 asks on 40
    nodes evict on the same node more than once, so the consumed
    victims decide later choices."""
    state, victims, asks = preempt_inputs(n, k, 2, n + k, dev, dh)
    noise = prng.threefry_uniform(
        torch.tensor([[3, n]], device=dev), (k, n), 0.0, 2.0)[0]
    runs = []
    for fn in (preempt.preempt_scan, preempt.preempt_scan_plain):
        st, vok = preempt_carry(state, victims)
        runs.append((*fn(st, victims, vok, asks, noise, 50.0, 10.0),
                     st, vok))
    (ch, sc, nv, st, vok), (ch_p, sc_p, nv_p, st_p, vok_p) = runs
    assert torch.equal(ch, ch_p)
    assert torch.equal(nv, nv_p)
    assert (sc - sc_p).abs().max().item() <= 1e-4
    for name in CARRY:
        assert torch.equal(getattr(st, name), getattr(st_p, name)), name
    assert torch.equal(vok, vok_p)
    # Both branches ran: some asks evicted, some fit without.
    assert (nv > 0).any() and ((ch >= 0) & (nv == 0)).any()
    assert (ch[-3:] == -1).all()


def test_preempt_placement_program_matches_plain(dev):
    """The scheduler's entry point (upload, K0, K6) against the plain
    program on the same host inputs."""
    state, victims, asks = preempt_inputs(500, 32, 2, 9, dev)
    host = lambda x: type(x)(*(f.cpu().numpy() for f in x))
    cfg = binpack.PlacementConfig(anti_affinity_penalty=10.0)
    key = binpack.host_prng_key(21)
    got = preempt.preempt_placement(host(state), host(victims), host(asks),
                                    key, 50.0, cfg, dev)
    want = preempt.preempt_placement_plain(state, victims, asks, key, 50.0,
                                           cfg)
    assert torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])
    assert (got[1] - want[1]).abs().max().item() <= 1e-4


def gang_inputs(n, seed, dev, rack=8, zero_ask=False):
    """A topology cluster for K7: racks of ``rack`` nodes (every tenth
    node without an id), varied free capacity and ports."""
    rng = np.random.default_rng(seed)
    t = lambda x: torch.from_numpy(np.array(x)).to(dev)
    cap = np.tile(np.array([[2000, 4000, 10000, 100]], np.float32), (n, 1))
    sched = cap - np.array([[100, 200, 0, 0]], np.float32)
    sched[rng.random(n) < 0.02, 0] = 0.0  # the zero-capacity guard binds
    util = (cap - sched) + np.stack(
        [rng.integers(0, 30, n) * 50, rng.integers(0, 30, n) * 100,
         np.zeros(n), np.zeros(n)], 1).astype(np.float32)
    topo = (np.arange(n) // rack).astype(np.int32)
    topo[rng.random(n) < 0.1] = -1
    state = gang.GangState(
        capacity=t(cap), sched_capacity=t(sched), util=t(util),
        bw_avail=t(np.full(n, 100, np.float32)),
        bw_used=t(rng.integers(0, 5, n).astype(np.float32) * 20),
        ports_free=t(rng.integers(0, 4, n).astype(np.float32)),
        feas_row=t(rng.random(n) < 0.9),
        job_count=t(rng.integers(0, 2, n).astype(np.int32)),
        dh_presence=t((rng.random(n) < 0.1).astype(np.int32)),
        topo_ids=t(topo))
    ask = (0, 0, 0, 0) if zero_ask else (300, 256, 0, 0)
    return (state, t(np.asarray(ask, np.float32)),
            t(np.float32(0 if zero_ask else 10)),
            t(np.float32(0 if zero_ask else 1)))


GANG_CASES = [(mode, dh) for mode in ("free", "slice", "spread", "affinity")
              for dh in (False, True)]


@pytest.mark.parametrize("mode,dh", GANG_CASES)
@pytest.mark.parametrize("n,k_real,k,g_pad,rack", [
    (400, 12, 16, 64, 8), (1200, 16, 16, 64, 60),
    (3000, 200, 256, 1024, 3), (40, 200, 256, 16, 8)])
def test_gang_scan_matches_plain(dev, mode, dh, n, k_real, k, g_pad, rack):
    """K7 against its plain version in every mode, with and without
    distinct_hosts: choices, scores, slice_group and the final carry
    (util, bw_used, ports_free, placed, group members)."""
    state, ask, abw, aports = gang_inputs(n, k_real + n, dev, rack=rack)
    _hold_gang_scan(state, ask, abw, aports, mode, dh, n, k_real, k, g_pad)


@pytest.mark.parametrize("mode,dh", GANG_CASES)
@pytest.mark.parametrize("n,k_real,k,g_pad,rack,shuffle", [
    (6000, 300, 512, 4096, 2, False), (5000, 4, 8, 4096, 2, False),
    (2000, 64, 64, 2048, 1, True)])
def test_gang_scan_many_groups(dev, mode, dh, n, k_real, k, g_pad, rack,
                               shuffle):
    """Past 1,024 groups (every node without the level's meta is its
    own group in free, spread and affinity mode) the group sums and
    member counts live in global memory: the same checks as above, on
    racks of two and on singleton groups whose ids are shuffled over
    the nodes."""
    state, ask, abw, aports = gang_inputs(n, k_real + n, dev, rack=rack)
    if shuffle:
        perm = np.random.default_rng(n).permutation(n)
        state = state._replace(topo_ids=state.topo_ids[torch.from_numpy(
            perm).to(dev)].contiguous())
    _hold_gang_scan(state, ask, abw, aports, mode, dh, n, k_real, k, g_pad)


def test_gang_scan_zero_ask_many_groups(dev):
    """A zero ask over 2,000 racks of two: each rack's capacity is 1e9
    or 2e9, held in global memory, and the slice choice is the plain
    version's."""
    n, k, g_pad = 4000, 8, 2048
    state, ask, abw, aports = gang_inputs(n, 6, dev, rack=2, zero_ask=True)
    active = torch.ones(k, dtype=torch.bool, device=dev)
    cfg = gang.GangConfig(anti_affinity_penalty=10.0, mode="slice",
                          g_pad=g_pad)
    key = binpack.host_prng_key(5)
    outs = [fn(state, ask, abw, aports, active, key, cfg)
            for fn in (gang.gang_placement_plain, _gang_on_card)]
    (ch, sc, sg), (ch_p, sc_p, sg_p) = outs
    assert torch.equal(ch, ch_p) and int(sg) == int(sg_p) >= 0
    assert (sc - sc_p).abs().max().item() <= 1e-4


def _hold_gang_scan(state, ask, abw, aports, mode, dh, n, k_real, k, g_pad):
    dev = state.capacity.device
    active = torch.zeros(k, dtype=torch.bool, device=dev)
    active[:k_real] = True
    cfg = gang.GangConfig(anti_affinity_penalty=10.0, mode=mode,
                          distinct_hosts=dh, g_pad=g_pad)
    keys = torch.tensor([[0, k_real], [1, n]], device=dev)
    noise = prng.threefry_uniform(keys[:1], (k, n), 0.0, 2.0)[0]
    gnoise = prng.threefry_uniform(keys[1:], (g_pad,), 0.0, 1.0)[0]
    runs = []
    for fn in (gang.gang_scan, gang.gang_scan_plain):
        st = state._replace(util=state.util.clone(),
                            bw_used=state.bw_used.clone(),
                            ports_free=state.ports_free.clone())
        placed = torch.zeros(n, dtype=torch.int32, device=dev)
        members = torch.zeros(g_pad, dtype=torch.float32, device=dev)
        out = fn(st, ask, abw, aports, active, noise, gnoise, cfg, placed,
                 members)
        runs.append((*out, st, placed, members))
    (ch, sc, sg, st, pl, gm), (ch_p, sc_p, sg_p, st_p, pl_p, gm_p) = runs
    assert torch.equal(ch, ch_p)
    assert int(sg) == int(sg_p)
    assert (sc - sc_p).abs().max().item() <= 1e-4
    for name in ("util", "bw_used", "ports_free"):
        assert torch.equal(getattr(st, name), getattr(st_p, name)), name
    assert torch.equal(pl, pl_p) and torch.equal(gm, gm_p)
    placed = (ch[:k_real] >= 0)
    assert placed.all() or not placed.any()  # all-K or none
    assert (ch[k_real:] == -1).all()
    if n < k_real:  # more members than the cluster holds: whole reject
        assert not placed.any() and int(sg) == -1
        if mode != "slice":  # members were placed, then rewritten
            assert pl.sum().item() > 0


@pytest.mark.parametrize("mode", ["slice", "free"])
def test_gang_scan_zero_ask_units(dev, mode):
    """A zero ask gives every feasible node 1e9 units: group sums pass
    2^24 and the chosen group must still be the plain version's."""
    n, k, g_pad = 1000, 8, 256
    state, ask, abw, aports = gang_inputs(n, 5, dev, rack=13, zero_ask=True)
    active = torch.ones(k, dtype=torch.bool, device=dev)
    cfg = gang.GangConfig(anti_affinity_penalty=10.0, mode=mode, g_pad=g_pad)
    key = binpack.host_prng_key(4)
    outs = [fn(state, ask, abw, aports, active, key, cfg)
            for fn in (gang.gang_placement_plain, _gang_on_card)]
    (ch, sc, sg), (ch_p, sc_p, sg_p) = outs
    assert torch.equal(ch, ch_p) and int(sg) == int(sg_p)
    assert (sc - sc_p).abs().max().item() <= 1e-4
    if mode == "slice":
        assert int(sg) >= 0


def _gang_on_card(state, ask, abw, aports, active, key, cfg):
    host = type(state)(*(f.cpu().numpy() for f in state))
    return gang.gang_placement(host, ask.cpu().numpy(), abw.cpu().numpy(),
                               aports.cpu().numpy(), active.cpu().numpy(),
                               key, cfg, ask.device)


def test_new_wrappers_count_their_launches(dev):
    state, victims, asks = preempt_inputs(100, 8, 2, 1, dev)
    noise = torch.zeros((8, 100), device=dev)
    before = cuda.launch_counts()
    st, vok = preempt_carry(state, victims)
    preempt.preempt_scan(st, victims, vok, asks, noise, 50.0, 10.0)
    st, vok = preempt_carry(state, victims)
    preempt.preempt_scan_plain(st, victims, vok, asks, noise, 50.0, 10.0)
    gstate, ask, abw, aports = gang_inputs(100, 2, dev)
    active = torch.ones(8, dtype=torch.bool, device=dev)
    cfg = gang.GangConfig(anti_affinity_penalty=10.0)
    gang.gang_placement_plain(gstate, ask, abw, aports, active,
                              binpack.host_prng_key(1), cfg)
    _gang_on_card(gstate, ask, abw, aports, active, binpack.host_prng_key(1),
                  cfg)
    after = cuda.launch_counts()
    assert after["preempt_scan"] == before.get("preempt_scan", 0) + 1
    assert after["gang_scan"] == before.get("gang_scan", 0) + 1


# ------------------------------------------------------------ convex (K8, K9)

# K8a / K9 outputs against their plain versions: logits relative to
# max(1, |logit|) (tests/test_torch_convex.py); x relative to its row's
# largest entry (a row sums to 1 over N nodes: at N = 10,240 every
# entry is below 1e-3, so an absolute tolerance would pass a zero); pref
# absolute (its terms are already over their maxima).
RELAX_TOLS = {"logits": 1e-4, "x": 1e-3, "pref": 1e-3}
# Past this distance from float64 a comparison holds nothing.
CHAOS_CAP = 0.1


def relax_err(got, want, kind):
    got, want = got.double(), want.double()
    err = (got - want).abs()
    if kind == "logits":
        err = err / want.abs().clamp(min=1.0)
    elif kind == "x":
        err = err / want.abs().amax(-1, keepdim=True).clamp(min=1e-30)
    return err.max().item()


def assert_relax_agrees(got, plain, plain64, kinds):
    """Each output within RELAX_TOLS of the plain version, or, where
    float32 rounding moves the sums (an ill-conditioned, chaotic
    instance: tests/test_torch_defrag.py), no farther from the float64
    run than 10x the plain version's own distance, a bound that must
    stay under CHAOS_CAP."""
    for g, p, p64, kind in zip(got, plain, plain64, kinds):
        err = relax_err(g, p, kind)
        if err <= RELAX_TOLS[kind]:
            continue
        bound = 10 * relax_err(p, p64, kind) + 1e-5
        assert bound < CHAOS_CAP, (kind, err, bound)
        assert relax_err(g, p64, kind) <= bound, (kind, err, bound)


def _double(x):
    if isinstance(x, tuple):
        items = [_double(i) for i in x]
        return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
    return x.double() if x.dtype == torch.float32 else x


def relax_inputs(layout, n, k, g, b, seed, dev):
    """scan_inputs in one of the relaxation's layouts: a carry per eval
    ("independent"), one shared [N,...] carry ("shared", B = 1, as the
    pre_resolve host loop calls it), or a base per eval ("stacked")."""
    static, base, feasible, asks = scan_inputs(n, k, g, b, seed, dev)
    if layout == "shared":
        c = shared_carry(base)
    else:
        c = fresh(base, b, n)
    if layout == "stacked":
        static = tuple(x.expand(b, *x.shape).contiguous() for x in static)
        static = (static[0] * 2, static[1] * 2, *static[2:])
    return static, c, feasible, asks


@pytest.mark.parametrize("layout,b,n,k,g", [
    ("independent", 3, 300, 24, 2), ("shared", 1, 777, 40, 3),
    ("stacked", 2, 500, 16, 2), ("independent", 1, 10240, 8, 2)])
def test_convex_relax_matches_plain(dev, layout, b, n, k, g):
    static, c, feasible, asks = relax_inputs(layout, n, k, g, b, n, dev)
    before = tuple(x.clone() for x in c)
    got = convex.relaxed_assignment(*static, c, feasible, asks, 10.0)
    plain = convex.relaxed_assignment_plain(*static, c, feasible, asks, 10.0)
    plain64 = convex.relaxed_assignment_plain(
        *_double(static), _double(c), feasible, _double(asks), 10.0)
    assert_relax_agrees(got, plain, plain64, ("logits", "x", "pref"))
    # The program's launch, x staged in pref's buffer: the same bits.
    assert torch.equal(
        convex.relaxed_pref(*static, c, feasible, asks, 10.0), got[2])
    for x, y in zip(c, before):
        assert torch.equal(x, y)  # the relaxation only reads the carry
    # Inactive asks and their rows of x: softmax rows still sum to 1.
    assert torch.allclose(got[1].sum(-1), torch.ones_like(got[1][..., 0]),
                          atol=1e-4)


def test_mirror_descent_matches_plain(dev):
    rng = np.random.default_rng(3)
    k, n = 24, 500
    t = lambda x: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(x, np.float32)).to(dev)
    mask = np.where(rng.random((k, n)) < 0.8, 0.0, -1e30)
    mask[0] = -1e30
    lin = rng.random((k, n)) * 18
    active = np.ones((k, 1))
    active[-4:] = 0.0
    args = [t(lin), t(lin), t(mask), t((rng.random((k, 4)) * 400 + 50)
                                       * active),
            t(rng.random(k) * 50 * active[:, 0]), t(2.0 * active[:, 0]),
            t(rng.random((n, 4)) * 0.9), t(rng.random(n) * 0.5),
            t(np.full((n, 4), 1000.0)), t(np.full(n, 500.0)),
            t(np.full(n, 3.0)), t(active)]
    got = convex.mirror_descent(*args, 12)
    plain = convex.mirror_descent_plain(*args, 12)
    plain64 = convex.mirror_descent_plain(*[a.double() for a in args], 12)
    assert_relax_agrees(
        [got, convex._softmax(got + args[2])],
        [plain, convex._softmax(plain + args[2])],
        [plain64, convex._softmax(plain64 + args[2].double())],
        ("logits", "x"))


def defrag_args(warm, k, w, dev):
    """K9's arguments over w nodes: a residual state with a node that
    only the capacity[:, 0] > 0 rule keeps ask 0 off, 3 inactive asks,
    and for the warm case carried logits on about 40% of the rows."""
    rng = np.random.default_rng(w + warm)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)  # noqa
    cap = np.tile(np.array([[4000, 8192, 100000, 150]], np.float32), (w, 1))
    # Node 5 has no CPU and the only room for ask 0's memory, which asks
    # no CPU: the defrag prologue's capacity[:, 0] > 0 alone keeps ask 0
    # off it (its row then has no feasible node).
    cap[5] = (0.0, 100000.0, 100000.0, 150.0)
    active = np.ones(k, bool)
    active[-3:] = False
    ask = np.stack([rng.choice([50, 100], k), rng.choice([64, 128], k),
                    np.zeros(k), np.zeros(k)], 1).astype(np.float32)
    ask[0] = (0.0, 50000.0, 0.0, 0.0)
    util = (cap * rng.random((w, 4)) * 0.5).astype(np.float32)
    util[5] = 0.0
    ok = rng.random(w) < 0.95
    ok[5] = True
    args = [t(rng.normal(0, 5, (k, w)).astype(np.float32)),
            t(rng.random(k) < (0.4 if warm else 2.0)), t(util), t(cap),
            t(cap), t(ok), t(np.full(w, 1000, np.float32)),
            t(rng.integers(0, 500, w).astype(np.float32)),
            t(rng.integers(0, 8, w).astype(np.float32)), t(ask),
            t(np.zeros(k, np.float32)), t(np.zeros(k, np.float32)),
            t(active)]
    return args, 5 if warm else 24


@pytest.mark.parametrize("warm,k,w", [(False, 64, 700), (True, 64, 700),
                                      (False, 16, 10240)])
def test_defrag_solve_matches_plain(dev, warm, k, w):
    args, iters = defrag_args(warm, k, w, dev)
    got = convex.defrag_solve(*args, iters)
    plain = convex.defrag_solve_plain(*args, iters)
    plain64 = convex.defrag_solve_plain(*_double(tuple(args)), iters)
    assert_relax_agrees(got, plain, plain64, ("logits", "x"))
    assert got[1][-3:].abs().max().item() == 0.0


@pytest.mark.parametrize("layout,b,n,k,g", [
    ("independent", 3, 300, 48, 2), ("seq", 4, 777, 40, 3),
    ("stacked", 2, 500, 64, 2), ("independent", 1, 10240, 128, 2),
    ("tight", 3, 300, 48, 2)])
def test_convex_round_matches_plain(dev, layout, b, n, k, g):
    """K8b fed one pref: choices and all five carried tensors equal,
    scores within 1e-4, with ports and distinct_hosts binding. "tight"
    gives every node the same pref and 1 to 3 asks of CPU headroom, so
    the strand term decides between nodes."""
    static, base, feasible, asks = scan_inputs(n, k, g, b, n + 5, dev)
    if layout == "tight":
        rng = np.random.default_rng(n)
        head = torch.from_numpy(rng.integers(8, 24, n) * 50.0).to(dev)
        base = (base[0].clone(), *base[1:])
        base[0][:, 0] = static[0][:, 0] - head.float()
        asks = asks._replace(resources=torch.tensor(
            [400.0, 256.0, 300.0, 0.0], device=dev).expand(b, k, 4)
            .contiguous())
    if layout == "stacked":
        static = tuple(x.expand(b, *x.shape).contiguous() for x in static)
    seq = layout == "seq"
    noise = prng.threefry_uniform(torch.arange(2 * b, device=dev).view(b, 2),
                                  (k, n), 0.0, 2.0)
    pref = torch.rand((b, k, n), device=dev,
                      generator=torch.Generator(dev).manual_seed(n))
    if layout == "tight":
        pref = torch.full_like(pref, 0.5)
    runs = []
    for fn in (convex.convex_round, convex.convex_round_plain):
        c = shared_carry(base) if seq else fresh(base, b, n)
        runs.append((*fn(*static, c, feasible, asks, noise, 10.0, pref,
                         seq), c))
    assert_scans_agree(*runs)
    placed = runs[0][0] >= 0
    assert placed.any()
    assert ((base[2] >= 2) & (runs[0][2][2] < 2)).any()


def test_convex_wrappers_count_their_launches(dev):
    static, c, feasible, asks = relax_inputs("independent", 64, 4, 2, 1, 1,
                                             dev)
    before = cuda.launch_counts()
    pref = convex.relaxed_assignment(*static, c, feasible, asks, 10.0)[2]
    convex.relaxed_pref(*static, c, feasible, asks, 10.0)
    convex.relaxed_assignment_plain(*static, c, feasible, asks, 10.0)
    noise = torch.zeros((1, 4, 64), device=dev)
    convex.convex_round(*static, c, feasible, asks, noise, 10.0, pref)
    after = cuda.launch_counts()
    assert after["convex_relax"] == before.get("convex_relax", 0) + 2
    assert after["convex_round"] == before.get("convex_round", 0) + 1


# ---------------------------------------------- K10: the node-sharded path


def shard_split(static, base, feasible, asks, keys, w, uniform, seq,
                noise_scale=2.0):
    """The scan inputs split into w node shards (NodeShard), each with
    its own carry copy and its window of the noise."""
    from nomad_tpu_torch.parallel.mesh import shard_bounds
    from nomad_tpu_torch.parallel.shard import NodeShard

    b, n, _g = feasible.shape
    k = asks.resources.shape[1]
    stacked = static[0].dim() == 3
    carry = shared_carry(base) if seq else fresh(base, b, n)
    d = 1 if stacked else 0
    out = []
    for lo, hi in shard_bounds(n, w):
        part = lambda x, dim: x.narrow(dim, lo, hi - lo).contiguous()  # noqa: E731
        own = 0 if seq else 1
        shape = (hi - lo,) if uniform else (k, hi - lo)
        out.append(NodeShard(
            lo, *(part(x, d) for x in static),
            (part(carry[0], own), part(carry[1], own), part(carry[2], own),
             part(carry[3], 1), part(carry[4], 1)),
            part(feasible, 1), asks,
            prng.threefry_uniform(keys, shape, 0.0, noise_scale,
                                  window=(lo, n))))
    return out


def join_carry(shards, seq):
    own = 0 if seq else 1
    return tuple(torch.cat([sh.carry[i] for sh in shards],
                           dim=own if i < 3 else 1) for i in range(5))


def uniform_asks(asks, b, k):
    return asks._replace(
        resources=asks.resources[:, :1].expand(b, k, 4).contiguous(),
        bw=asks.bw[:, :1].expand(b, k).contiguous(),
        ports=asks.ports[:, :1].expand(b, k).contiguous(),
        tg_index=torch.zeros_like(asks.tg_index),
        tg_distinct_hosts=torch.ones_like(asks.tg_distinct_hosts))


def stacked_of(static, b, n, dev, seed):
    rng = np.random.default_rng(seed)
    scale = torch.from_numpy(rng.integers(1, 3, (b, n, 1)).astype(
        np.float32)).to(dev)
    cap = (static[0] * scale).contiguous()
    return (cap, (cap - (static[0] - static[1])).contiguous(),
            static[2].expand(b, n).contiguous(),
            torch.from_numpy(rng.random((b, n)) < 0.9).to(dev))


@pytest.mark.parametrize("layout", ["independent", "seq", "stacked"])
@pytest.mark.parametrize("w", [1, 2, 4])
@pytest.mark.parametrize("uniform", [False, True], ids=["greedy", "uniform"])
def test_sharded_scans_match_plain_and_unsharded(dev, uniform, w, layout):
    """K10c / K10d on w shards of the card: choices, scores and every
    carried tensor equal the plain sharded version's (scores within
    1e-4), and equal K1 / K2 on the whole node axis bit for bit."""
    from nomad_tpu_torch.parallel import shard

    b, n, k, g = 3, 1000, 40, 2
    seq = layout == "seq"
    static, base, feasible, asks = scan_inputs(n, k, g, b, 11 * w, dev)
    if layout == "stacked":
        static = stacked_of(static, b, n, dev, w)
    if uniform:
        asks = uniform_asks(asks, b, k)
    keys = torch.arange(2 * b, device=dev).view(b, 2) + 5
    kern, plain, one = ((shard.sharded_uniform_topk,
                         shard.sharded_uniform_topk_plain,
                         binpack.uniform_topk) if uniform else
                        (shard.sharded_greedy_scan,
                         shard.sharded_greedy_scan_plain,
                         binpack.greedy_scan))
    runs = []
    for fn in (kern, plain):
        shards = shard_split(static, base, feasible, asks, keys, w, uniform,
                             seq)
        runs.append((*fn(shards, 10.0, seq), join_carry(shards, seq)))
    assert_scans_agree(*runs)
    c = shared_carry(base) if seq else fresh(base, b, n)
    noise = prng.threefry_uniform(keys, (n,) if uniform else (k, n), 0.0,
                                  2.0)
    ch, sc = one(*static, c, feasible, asks, noise, 10.0, seq)
    assert torch.equal(runs[0][0], ch) and torch.equal(runs[0][1], sc)
    for name, x, y in zip(CARRY, runs[0][2], c):
        assert torch.equal(x, y), name
    assert (ch >= 0).any()


def tie_inputs(n, k, dev, fit_row=None):
    """Equal nodes (noise off): every score ties; ask 1 fits nowhere."""
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    cap = np.tile(np.array([[1000, 1000, 1000, 10]], np.float32), (n, 1))
    ok = np.zeros(n, bool)
    ok[fit_row] = True
    static = (t(cap), t(cap), t(np.full(n, 100, np.float32)), t(ok))
    base = (t(np.tile(np.array([[900, 900, 0, 0]], np.float32), (n, 1))),
            t(np.zeros(n, np.float32)), t(np.full(n, 10, np.float32)),
            t(np.zeros((1, n), np.int32)), t(np.zeros((1, n, 1), np.int32)))
    res = np.tile(np.array([[50, 50, 0, 0]], np.float32), (k, 1))
    res[1] = [500, 0, 0, 0]
    asks = binpack.Asks(
        resources=t(res[None]), bw=t(np.zeros((1, k), np.float32)),
        ports=t(np.zeros((1, k), np.float32)),
        tg_index=t(np.zeros((1, k), np.int32)),
        active=t(np.ones((1, k), bool)), job_distinct_hosts=t(np.zeros(1, bool)),
        tg_distinct_hosts=t(np.zeros((1, 1), bool)))
    return static, base, t(np.ones((1, n, 1), bool)), asks


@pytest.mark.parametrize("w", [2, 4])
def test_sharded_greedy_tie_across_a_boundary_and_no_fit(dev, w):
    """A tie between the last row of shard 0 and the first of shard 1
    goes to the lower global index; an ask that fits nowhere gives -1
    and 0 on every shard, and the scan goes on."""
    from nomad_tpu_torch.parallel import shard

    n, k = 256, 3
    edge = n // w
    static, base, feasible, asks = tie_inputs(n, k, dev, [edge - 1, edge])
    keys = torch.zeros((1, 2), dtype=torch.int64, device=dev)
    runs = []
    for fn in (shard.sharded_greedy_scan, shard.sharded_greedy_scan_plain):
        shards = shard_split(static, base, feasible, asks, keys, w, False,
                             False, noise_scale=0.0)
        runs.append((*fn(shards, 10.0), join_carry(shards, False)))
    assert_scans_agree(*runs)
    assert runs[0][0].tolist() == [[edge - 1, -1, edge]]
    assert runs[0][1][0, 1].item() == 0.0


@pytest.mark.parametrize("w", [2, 4])
def test_sharded_uniform_topk_tie_across_a_boundary(dev, w):
    """Tied nodes on both sides of a shard boundary (noise off) come
    out lowest global index first; the surplus ask, with no node left
    that fits, is -1."""
    from nomad_tpu_torch.parallel import shard

    n, k = 256, 3
    edge = n // w
    static, base, feasible, asks = tie_inputs(n, k, dev, [edge, edge - 1])
    asks = uniform_asks(asks, 1, k)
    keys = torch.zeros((1, 2), dtype=torch.int64, device=dev)
    runs = []
    for fn in (shard.sharded_uniform_topk, shard.sharded_uniform_topk_plain):
        shards = shard_split(static, base, feasible, asks, keys, w, True,
                             False, noise_scale=0.0)
        runs.append((*fn(shards, 10.0), join_carry(shards, False)))
    assert_scans_agree(*runs)
    assert runs[0][0].tolist() == [[edge - 1, edge, -1]]


@pytest.mark.parametrize("w", [1, 2, 4])
def test_sharded_uniform_topk_global_scratch_and_surplus(dev, w):
    """Shards whose slice sorts in global scratch (n_local past the
    shared-memory limit at w = 1, 2), and more asks than nodes fit."""
    from nomad_tpu_torch.parallel import shard

    b, n, k = 2, 60000, 64
    static, base, feasible, asks = scan_inputs(n, k, 2, b, 3 + w, dev)
    asks = uniform_asks(asks, b, k)
    keys = torch.arange(2 * b, device=dev).view(b, 2)
    runs = []
    for fn in (shard.sharded_uniform_topk, shard.sharded_uniform_topk_plain):
        shards = shard_split(static, base, feasible, asks, keys, w, True,
                             True)
        runs.append((*fn(shards, 10.0, True), join_carry(shards, True)))
    assert_scans_agree(*runs)
    c = shared_carry(base)
    noise = prng.threefry_uniform(keys, (n,), 0.0, 2.0)
    ch, _sc = binpack.uniform_topk(*static, c, feasible, asks, noise, 10.0,
                                   True)
    assert torch.equal(runs[0][0], ch)


@pytest.mark.parametrize("w", [1, 2, 4])
def test_sharded_base_delta_matches_plain(dev, w):
    """K10a: rows in every shard, padding rows repeating the first
    row; each shard keeps its own rows. Bit-equal to the plain version
    and to K4 on the whole base."""
    from nomad_tpu_torch.parallel.mesh import gather, make_mesh, place
    from nomad_tpu_torch.parallel.shard import sharded_base_delta

    n, r = 4096, 256
    rng = np.random.default_rng(w)
    parent = (rng.random((n, 4)).astype(np.float32),
              rng.random(n).astype(np.float32),
              rng.random(n).astype(np.float32), rng.random(n) < 0.5)
    rows = np.full(r, 0, np.int32)
    rows[:200] = rng.choice(n, 200, replace=False)
    rows[200:] = rows[0]
    vals = [rng.random((r, 4)).astype(np.float32),
            rng.random(r).astype(np.float32),
            rng.random(r).astype(np.float32), rng.random(r) < 0.5]
    for v in vals:
        v[200:] = v[0]
    specs = [("nodes", None), ("nodes",), ("nodes",), ("nodes",)]
    got = []
    for devices in (["cuda"] * w, ["cpu"] * w):
        mesh = make_mesh(devices=devices)
        targets = place(mesh, parent, specs)
        got.append([gather(x) for x in sharded_base_delta(mesh)(
            *targets, rows, *vals)])
        for x, p in zip(targets, parent):
            assert torch.equal(gather(x), torch.from_numpy(p))  # untouched
    one = binpack.apply_base_delta(*(torch.from_numpy(x).to(dev) for x in (
        *parent, rows, *vals)))
    for x, y, z in zip(*got, one):
        assert torch.equal(x, y) and torch.equal(x, z.cpu())


@pytest.mark.parametrize("w,g_pad,singletons", [
    (1, 256, False), (2, 16, False), (4, 2048, False), (4, 10240, True)])
def test_sharded_group_capacity_matches_plain(dev, w, g_pad, singletons):
    """K10b: -1 ids drop, a group spans shards, more than 1,024 groups,
    and one group a node (the meta-less case, g_pad 10,240). Whole
    numbers under 2^24: bit-equal to the plain version and to the
    one-device index_add_."""
    from nomad_tpu_torch.ops.gang import group_capacity_plain
    from nomad_tpu_torch.parallel.mesh import make_mesh
    from nomad_tpu_torch.parallel.shard import sharded_group_capacity

    n = 10240 if singletons else 4096
    rng = np.random.default_rng(g_pad)
    units = rng.integers(0, 40, n).astype(np.float32)
    ids = (np.arange(n) if singletons else rng.integers(0, g_pad - 2, n)) \
        .astype(np.int32)
    ids[rng.choice(n, 50, replace=False)] = -1
    got = sharded_group_capacity(make_mesh(devices=["cuda"] * w), g_pad)(
        units, ids)
    want = sharded_group_capacity(make_mesh(devices=["cpu"] * w), g_pad)(
        units, ids)
    one = group_capacity_plain(torch.from_numpy(units),
                               torch.from_numpy(ids), g_pad)
    assert torch.equal(got.cpu(), want) and torch.equal(want, one)


@pytest.mark.parametrize("w", [2, 4])
def test_noise_window_at_an_offset(dev, w):
    """The kernel's window at lo > 0 is the full draw's columns."""
    keys = torch.tensor([[7, 11], [3, 5]], dtype=torch.int64, device=dev)
    n, k = 1000 * w, 6
    full = prng.threefry_uniform(keys, (k, n), 0.0, 2.0)
    for s in range(1, w):
        lo = s * (n // w)
        part = prng.threefry_uniform(keys, (k, n // w), 0.0, 2.0,
                                     window=(lo, n))
        assert torch.equal(part, full[:, :, lo:lo + n // w])
        plain = prng.threefry_uniform_plain(keys, (k, n // w), 0.0, 2.0,
                                            window=(lo, n))
        assert torch.equal(part, plain)


def test_sharded_wrappers_count_their_launches(dev):
    """K x (W + 1) + W launches for a greedy scan of one eval, W + 1 +
    W for an independent top-k, W + 1 for a group capacity, W for a
    delta; plain versions count nothing."""
    from nomad_tpu_torch.parallel import shard
    from nomad_tpu_torch.parallel.mesh import make_mesh

    b, n, k, w = 1, 512, 5, 4
    static, base, feasible, asks = scan_inputs(n, k, 2, b, 1, dev)
    keys = torch.zeros((b, 2), dtype=torch.int64, device=dev)
    cuda.reset_launch_counts()
    shard.sharded_greedy_scan(shard_split(static, base, feasible, asks, keys,
                                          w, False, False), 10.0)
    shard.sharded_greedy_scan_plain(shard_split(
        static, base, feasible, asks, keys, w, False, False), 10.0)
    ua = uniform_asks(asks, b, k)
    shard.sharded_uniform_topk(shard_split(static, base, feasible, ua, keys,
                                           w, True, False), 10.0)
    mesh = make_mesh(devices=["cuda"] * w)
    shard.sharded_group_capacity(mesh, 16)(
        np.ones(n, np.float32), np.zeros(n, np.int32))
    counts = cuda.launch_counts()
    assert counts["sharded_greedy_scan"] == k * (w + 1) + w
    assert counts["sharded_uniform_topk"] == 2 * w + 1
    assert counts["group_capacity"] == w + 1


# ------------------------------ K10e-K10g: the last node-sharded programs


def gang_shards(state, ask, abw, aports, noise, g_pad, w):
    """A gang state split into w GangShards (copies), each with its
    window of the member noise and fresh carries."""
    from nomad_tpu_torch.parallel.mesh import shard_bounds
    from nomad_tpu_torch.parallel.shard import GangShard

    n = state.capacity.shape[0]
    dev = state.capacity.device
    return [GangShard(lo, gang.GangState(*(f[lo:hi].clone() for f in state)),
                      ask, abw, aports, noise[:, lo:hi].contiguous(),
                      torch.zeros(hi - lo, dtype=torch.int32, device=dev),
                      torch.zeros(g_pad, dtype=torch.float32, device=dev))
            for lo, hi in shard_bounds(n, w)]


@pytest.mark.parametrize("mode,dh", GANG_CASES)
@pytest.mark.parametrize("w", [2, 4])
@pytest.mark.parametrize("n,k_real,k,g_pad,rack,shuffle", [
    (400, 12, 16, 64, 8, False), (3000, 200, 256, 1024, 3, False),
    (2000, 64, 64, 2048, 1, True)])
def test_sharded_gang_scan_matches_plain_and_k7(dev, mode, dh, w, n, k_real,
                                                k, g_pad, rack, shuffle):
    """K10e on w shards of the card in every mode, with and without
    distinct_hosts, racks straddling the shard edges and singleton groups
    shuffled over the node axis (past 1,024 groups): choices, slice group
    and every shard's carry (util, bw_used, ports_free, placed, its copy
    of the group member counts) equal the plain version's, scores within
    1e-4; and K7 on the whole node axis bit for bit."""
    from nomad_tpu_torch.parallel import shard

    state, ask, abw, aports = gang_inputs(n, k_real + n, dev, rack=rack)
    if shuffle:
        perm = np.random.default_rng(n).permutation(n)
        state = state._replace(topo_ids=state.topo_ids[torch.from_numpy(
            perm).to(dev)].contiguous())
    active = torch.zeros(k, dtype=torch.bool, device=dev)
    active[:k_real] = True
    cfg = gang.GangConfig(anti_affinity_penalty=10.0, mode=mode,
                          distinct_hosts=dh, g_pad=g_pad)
    keys = torch.tensor([[0, k_real], [1, n]], device=dev)
    noise = prng.threefry_uniform(keys[:1], (k, n), 0.0, 2.0)[0]
    gnoise = prng.threefry_uniform(keys[1:], (g_pad,), 0.0, 1.0)[0]
    runs = []
    for fn in (shard.sharded_gang_scan, shard.sharded_gang_scan_plain):
        shards = gang_shards(state, ask, abw, aports, noise, g_pad, w)
        runs.append((fn(shards, active, gnoise, cfg), shards))
    ((ch, sc, sg), shards), ((ch_p, sc_p, sg_p), shards_p) = runs
    assert torch.equal(ch, ch_p) and int(sg) == int(sg_p)
    assert (sc - sc_p).abs().max().item() <= 1e-4
    for a, b in zip(shards, shards_p):
        for name in ("util", "bw_used", "ports_free"):
            assert torch.equal(getattr(a.state, name),
                               getattr(b.state, name)), name
        assert torch.equal(a.placed, b.placed)
        assert torch.equal(a.group_members, b.group_members)
    st = state._replace(util=state.util.clone(),
                        bw_used=state.bw_used.clone(),
                        ports_free=state.ports_free.clone())
    placed = torch.zeros(n, dtype=torch.int32, device=dev)
    members = torch.zeros(g_pad, dtype=torch.float32, device=dev)
    ch1, sc1, sg1 = gang.gang_scan(st, ask, abw, aports, active, noise,
                                   gnoise, cfg, placed, members)
    assert torch.equal(ch, ch1) and torch.equal(sc, sc1)
    assert int(sg) == int(sg1)
    assert torch.equal(torch.cat([a.placed for a in shards]), placed)
    assert torch.equal(torch.cat([a.state.util for a in shards]), st.util)
    for a in shards:
        assert torch.equal(a.group_members, members)
    if n >= k_real:
        assert (ch[:k_real] >= 0).any() or mode == "slice"


def _double_any(x):
    """Float tensors, alone or in (named) tuples, as float64; anything
    else as is."""
    if isinstance(x, tuple):
        items = [_double_any(i) for i in x]
        return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
    if isinstance(x, torch.Tensor) and x.dtype == torch.float32:
        return x.double()
    return x


def relax_node_shards(static, c, feasible, asks, w):
    """relax_inputs' arguments split into w NodeShards (no noise)."""
    from nomad_tpu_torch.parallel.mesh import shard_bounds
    from nomad_tpu_torch.parallel.shard import NodeShard

    n = feasible.shape[1]
    d = 1 if static[0].dim() == 3 else 0
    own = 0 if c[0].dim() == 2 else 1
    out = []
    for lo, hi in shard_bounds(n, w):
        cut = lambda x, dim: x.narrow(dim, lo, hi - lo).contiguous()  # noqa
        out.append(NodeShard(
            lo, *(cut(x, d) for x in static),
            (cut(c[0], own), cut(c[1], own), cut(c[2], own), cut(c[3], 1),
             cut(c[4], 1)), cut(feasible, 1), asks, None))
    return out


def joined_outputs(outs):
    return [torch.cat([o[i] for o in outs], dim=-1)
            for i in range(len(outs[0]))]


@pytest.mark.parametrize("w", [1, 2, 4])
@pytest.mark.parametrize("layout,b,n,k,g", [
    ("independent", 3, 300, 24, 2), ("shared", 1, 776, 40, 3),
    ("stacked", 2, 500, 16, 2), ("independent", 1, 10240, 8, 2)])
def test_sharded_relax_placement_matches_plain(dev, layout, b, n, k, g, w):
    """K10g-a on w shards of the card: logits, x and pref (joined in node
    order) held to RELAX_TOLS against the plain version (the float64 run
    where float32 itself drifts); one shard gives K8a's bits."""
    from nomad_tpu_torch.parallel import shard

    static, c, feasible, asks = relax_inputs(layout, n, k, g, b, n, dev)
    shards = relax_node_shards(static, c, feasible, asks, w)
    got = joined_outputs(shard.sharded_relax(shards, convex.SOLVE_ITERS,
                                             10.0))
    plain = joined_outputs(shard.sharded_relax_plain(
        shards, convex.SOLVE_ITERS, 10.0))
    plain64 = joined_outputs(shard.sharded_relax_plain(
        [_double_any(sh) for sh in shards], convex.SOLVE_ITERS, 10.0))
    assert_relax_agrees(got, plain, plain64, ("logits", "x", "pref"))
    if w == 1:
        one = convex.relaxed_assignment(*static, c, feasible, asks, 10.0)
        for a, b_ in zip(got, one):
            assert torch.equal(a, b_)


def test_sharded_relax_all_infeasible_rows_are_uniform(dev):
    """Rows with no feasible node on any shard come out 1 / N over the
    whole node axis, not 1 / N_shard: the combine keeps the NEG_INF
    offsets finite."""
    from nomad_tpu_torch.parallel import shard

    static, c, feasible, asks = relax_inputs("independent", 400, 16, 2, 1,
                                             9, dev)
    res = asks.resources.clone()
    res[:, :4, 0] = 1e7
    asks = asks._replace(resources=res)
    for w in (2, 4):
        x = joined_outputs(shard.sharded_relax(
            relax_node_shards(static, c, feasible, asks, w),
            convex.SOLVE_ITERS, 10.0))[1]
        assert torch.allclose(x[0, :4], torch.full_like(x[0, :4], 1 / 400),
                              rtol=1e-5, atol=0)


@pytest.mark.parametrize("w", [1, 2, 4])
@pytest.mark.parametrize("warm,k,n", [(False, 64, 700), (True, 64, 700),
                                      (False, 16, 10240)])
def test_sharded_defrag_solve_matches_plain(dev, warm, k, n, w):
    """K10f on w shards of the card: logits and x (joined in node order)
    held to RELAX_TOLS against the plain version (the float64 run where
    float32 itself drifts); one shard gives K9's bits; inactive rows
    carry no mass."""
    from nomad_tpu_torch.parallel.mesh import shard_bounds
    from nomad_tpu_torch.parallel.shard import (
        DefragShard,
        sharded_relax,
        sharded_relax_plain,
    )

    args, iters = defrag_args(warm, k, n, dev)
    node_dim = (1, None, 0, 0, 0, 0, 0, 0, 0, None, None, None, None)

    def shards_of(xs):
        return [DefragShard(lo, *(
            x if d is None else x.narrow(d, lo, hi - lo).contiguous()
            for x, d in zip(xs, node_dim))) for lo, hi in shard_bounds(n, w)]

    got = joined_outputs(sharded_relax(shards_of(args), iters))
    plain = joined_outputs(sharded_relax_plain(shards_of(args), iters))
    plain64 = joined_outputs(sharded_relax_plain(
        shards_of(_double_any(tuple(args))), iters))
    assert_relax_agrees(got, plain, plain64, ("logits", "x"))
    assert got[1][-3:].abs().max().item() == 0.0
    if w == 1:
        one = convex.defrag_solve(*args, iters)
        assert torch.equal(got[0], one[0]) and torch.equal(got[1], one[1])


@pytest.mark.parametrize("w", [1, 2, 4])
@pytest.mark.parametrize("layout,b,n,k,g", [
    ("independent", 3, 300, 48, 2), ("seq", 4, 776, 40, 3),
    ("stacked", 2, 500, 64, 2), ("tight", 3, 300, 48, 2)])
def test_sharded_convex_round_matches_plain_and_k8b(dev, layout, b, n, k, g,
                                                    w):
    """K10g-b on w shards of the card, fed one pref: choices and every
    carried tensor equal the plain version's (scores within 1e-4), and
    K8b's on the whole node axis bit for bit. "tight" makes the strand
    term, read from each shard's own carried rows, decide."""
    from nomad_tpu_torch.parallel import shard

    static, base, feasible, asks = scan_inputs(n, k, g, b, n + 5, dev)
    if layout == "tight":
        rng = np.random.default_rng(n)
        head = torch.from_numpy(rng.integers(8, 24, n) * 50.0).to(dev)
        base = (base[0].clone(), *base[1:])
        base[0][:, 0] = static[0][:, 0] - head.float()
        asks = asks._replace(resources=torch.tensor(
            [400.0, 256.0, 300.0, 0.0], device=dev).expand(b, k, 4)
            .contiguous())
    if layout == "stacked":
        static = stacked_of(static, b, n, dev, w)
    seq = layout == "seq"
    keys = torch.arange(2 * b, device=dev).view(b, 2) + 3
    pref = torch.rand((b, k, n), device=dev,
                      generator=torch.Generator(dev).manual_seed(n))
    if layout == "tight":
        pref = torch.full_like(pref, 0.5)
    runs = []
    for fn in (shard.sharded_convex_round, shard.sharded_convex_round_plain):
        shards = [sh._replace(pref=pref[..., sh.lo:sh.lo + sh.noise.shape[
            -1]].contiguous()) for sh in shard_split(
                static, base, feasible, asks, keys, w, False, seq)]
        runs.append((*fn(shards, 10.0, seq), join_carry(shards, seq)))
    assert_scans_agree(*runs)
    c = shared_carry(base) if seq else fresh(base, b, n)
    noise = prng.threefry_uniform(keys, (k, n), 0.0, 2.0)
    ch, sc = convex.convex_round(*static, c, feasible, asks, noise, 10.0,
                                 pref, seq)
    assert torch.equal(runs[0][0], ch) and torch.equal(runs[0][1], sc)
    for name, x, y in zip(CARRY, runs[0][2], c):
        assert torch.equal(x, y), name
    assert (ch >= 0).any()


def test_mesh_kernel_wrappers_count_their_launches(dev):
    """K10g-b: K x (W + 1) + W a call; K10g-a: 3 W + iters x (2 W + 1) +
    2 x (2 W + 1); K10f: 3 W + iters x (2 W + 1) + 2 W + 1; K10e in
    slice mode: W + 1 + K x (W + 1) + W + 1, and K10b's W + 1; plain
    versions count nothing."""
    from nomad_tpu_torch.parallel import shard

    b, n, k, w, it = 1, 512, 5, 4, convex.SOLVE_ITERS
    static, base, feasible, asks = scan_inputs(n, k, 2, b, 1, dev)
    keys = torch.zeros((b, 2), dtype=torch.int64, device=dev)
    cuda.reset_launch_counts()
    shards = shard_split(static, base, feasible, asks, keys, w, False, False)
    outs = shard.sharded_relax(shards, it, 10.0)
    shard.sharded_relax_plain(shards, it, 10.0)
    shards = [sh._replace(pref=o[2]) for sh, o in zip(shards, outs)]
    shard.sharded_convex_round(shards, 10.0)
    shard.sharded_convex_round_plain([sh._replace(pref=o[2]) for sh, o in zip(
        shard_split(static, base, feasible, asks, keys, w, False, False),
        outs)], 10.0)
    args, iters = defrag_args(False, 16, 700, dev)
    from nomad_tpu_torch.parallel.mesh import shard_bounds

    node_dim = (1, None, 0, 0, 0, 0, 0, 0, 0, None, None, None, None)
    dshards = [shard.DefragShard(lo, *(
        x if d is None else x.narrow(d, lo, hi - lo).contiguous()
        for x, d in zip(args, node_dim))) for lo, hi in shard_bounds(700, w)]
    shard.sharded_relax(dshards, iters)
    state, ask, abw, aports = gang_inputs(400, 3, dev)
    active = torch.ones(8, dtype=torch.bool, device=dev)
    cfg = gang.GangConfig(anti_affinity_penalty=10.0, mode="slice", g_pad=64)
    noise = torch.zeros((8, 400), device=dev)
    gnoise = torch.zeros(64, device=dev)
    shard.sharded_gang_scan(gang_shards(state, ask, abw, aports, noise, 64,
                                        w), active, gnoise, cfg)
    shard.sharded_gang_scan_plain(gang_shards(state, ask, abw, aports, noise,
                                              64, w), active, gnoise, cfg)
    counts = cuda.launch_counts()
    assert counts["sharded_convex_round"] == k * (w + 1) + w
    assert counts["sharded_convex_relax"] == \
        3 * w + it * (2 * w + 1) + 2 * (2 * w + 1)
    assert counts["sharded_defrag_solve"] == \
        3 * w + iters * (2 * w + 1) + 2 * w + 1
    assert counts["sharded_gang_scan"] == w + 1 + 8 * (w + 1) + w + 1
    assert counts["group_capacity"] == w + 1


def _to(x, device):
    """Tensors, alone or in (named) tuples, moved to ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, tuple):
        items = [_to(i, device) for i in x]
        return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
    return x


def test_sharded_paths_on_distinct_cards(dev):
    """The distinct-card path: four shards over the cards round-robin
    (per-card launches, partial buffers and winners crossing between
    cards) give what four shards of one card give, for K10a-K10d.
    Skips on a machine with one card."""
    from nomad_tpu_torch.parallel import shard
    from nomad_tpu_torch.parallel.mesh import gather, make_mesh, place

    cards = torch.cuda.device_count()
    if cards < 2:
        pytest.skip("needs two or more cards: the distinct-card path")
    w = 4
    spread = [torch.device("cuda", s % cards) for s in range(w)]
    b, n, k, g = 3, 1000, 24, 2
    for uniform in (False, True):
        for seq in (False, True):
            static, base, feasible, asks = scan_inputs(n, k, g, b, 21, dev)
            if uniform:
                asks = uniform_asks(asks, b, k)
            keys = torch.arange(2 * b, device=dev).view(b, 2)
            fn = (shard.sharded_uniform_topk if uniform
                  else shard.sharded_greedy_scan)
            one = shard_split(static, base, feasible, asks, keys, w, uniform,
                              seq)
            many = [_to(sh, d) for sh, d in zip(
                shard_split(static, base, feasible, asks, keys, w, uniform,
                            seq), spread)]
            want = fn(one, 10.0, seq)
            got = fn(many, 10.0, seq)
            assert torch.equal(got[0], want[0]), (uniform, seq)
            assert torch.equal(got[1], want[1]), (uniform, seq)
            for a, c in zip(one, many):
                for x, y in zip(a.carry, c.carry):
                    assert torch.equal(x, y.to(dev)), (uniform, seq)
    rng = np.random.default_rng(5)
    parent = (rng.random((n, 4)).astype(np.float32),
              rng.random(n).astype(np.float32),
              rng.random(n).astype(np.float32), rng.random(n) < 0.5)
    rows = rng.choice(n, 40, replace=False).astype(np.int32)
    vals = [rng.random((40, 4)).astype(np.float32),
            rng.random(40).astype(np.float32),
            rng.random(40).astype(np.float32), rng.random(40) < 0.5]
    units = rng.integers(0, 40, n).astype(np.float32)
    ids = rng.integers(-1, 1100, n).astype(np.int32)
    specs = [("nodes", None), ("nodes",), ("nodes",), ("nodes",)]
    out = []
    for devices in (["cuda:0"] * w, [str(d) for d in spread]):
        mesh = make_mesh(devices=devices)
        delta = shard.sharded_base_delta(mesh)(
            *place(mesh, parent, specs), rows, *vals)
        caps = shard.sharded_group_capacity(mesh, 1152)(units, ids)
        out.append(([gather(x) for x in delta], caps.cpu()))
    for x, y in zip(out[0][0], out[1][0]):
        assert torch.equal(x, y)
    assert torch.equal(out[0][1], out[1][1])


def test_mesh_programs_on_distinct_cards(dev):
    """K10e, K10f, K10g-a and K10g-b on four shards over the cards
    round-robin (meta, candidates, winners and softmax statistics
    crossing between cards) give what four shards of one card give, bit
    for bit. Skips on a machine with one card."""
    from nomad_tpu_torch.parallel import shard
    from nomad_tpu_torch.parallel.mesh import shard_bounds

    cards = torch.cuda.device_count()
    if cards < 2:
        pytest.skip("needs two or more cards: the distinct-card path")
    w = 4
    spread = [torch.device("cuda", s % cards) for s in range(w)]
    # K10e, spread mode: the group counts cross cards with the winners.
    state, ask, abw, aports = gang_inputs(2000, 7, dev, rack=3)
    active = torch.ones(64, dtype=torch.bool, device=dev)
    cfg = gang.GangConfig(anti_affinity_penalty=10.0, mode="spread",
                          g_pad=1024)
    keys = torch.tensor([[0, 5], [1, 9]], device=dev)
    noise = prng.threefry_uniform(keys[:1], (64, 2000), 0.0, 2.0)[0]
    gnoise = prng.threefry_uniform(keys[1:], (1024,), 0.0, 1.0)[0]
    one = gang_shards(state, ask, abw, aports, noise, 1024, w)
    many = [_to(sh, d) for sh, d in zip(
        gang_shards(state, ask, abw, aports, noise, 1024, w), spread)]
    want = shard.sharded_gang_scan(one, active, gnoise, cfg)
    got = shard.sharded_gang_scan(many, active, gnoise, cfg)
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    for a, b in zip(one, many):
        assert torch.equal(a.group_members, b.group_members.to(dev))
        assert torch.equal(a.placed, b.placed.to(dev))
    # K10f
    args, iters = defrag_args(False, 64, 700, dev)
    node_dim = (1, None, 0, 0, 0, 0, 0, 0, 0, None, None, None, None)
    dshards = [shard.DefragShard(lo, *(
        x if d is None else x.narrow(d, lo, hi - lo).contiguous()
        for x, d in zip(args, node_dim))) for lo, hi in shard_bounds(700, w)]
    want = shard.sharded_relax(dshards, iters)
    got = shard.sharded_relax([_to(sh, d) for sh, d in zip(dshards, spread)],
                              iters)
    for o, r in zip(got, want):
        for x, y in zip(o, r):
            assert torch.equal(x.to(dev), y)
    # K10g-a, then K10g-b fed its pref
    b, n, k, g = 2, 1000, 24, 2
    static, base, feasible, asks = scan_inputs(n, k, g, b, 33, dev)
    keys = torch.arange(2 * b, device=dev).view(b, 2)
    one = shard_split(static, base, feasible, asks, keys, w, False, False)
    many = [_to(sh, d) for sh, d in zip(shard_split(
        static, base, feasible, asks, keys, w, False, False), spread)]
    want = shard.sharded_relax(one, convex.SOLVE_ITERS, 10.0)
    got = shard.sharded_relax(many, convex.SOLVE_ITERS, 10.0)
    for o, r in zip(got, want):
        for x, y in zip(o, r):
            assert torch.equal(x.to(dev), y)
    one = [sh._replace(pref=o[2]) for sh, o in zip(one, want)]
    many = [sh._replace(pref=o[2]) for sh, o in zip(many, got)]
    want = shard.sharded_convex_round(one, 10.0)
    got = shard.sharded_convex_round(many, 10.0)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for a, c in zip(one, many):
        for x, y in zip(a.carry, c.carry):
            assert torch.equal(x, y.to(dev))
