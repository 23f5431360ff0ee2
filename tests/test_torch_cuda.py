"""The port's CUDA kernels against their plain PyTorch versions, on the
card, at small shapes that reach every branch: free ports and
distinct_hosts (per task group and per job) that limit where asks fit,
inactive asks, asks past the node count, a node bucket whose top-k
sorts in global scratch, overlay rows padded with N, the sequential
(pre_resolve) and stacked batch layouts of the scans, base deltas
with padding rows, preemption where victims, ports and distinct_hosts
bind, and every gang mode.

Marked ``cuda``; without a CUDA card every test skips. On the card's
machine, which need not have JAX (tests/conftest.py configures it):

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py -q
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

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
