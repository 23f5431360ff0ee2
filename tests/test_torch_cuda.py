"""The port's CUDA kernels against their plain PyTorch versions, on the
card, at small shapes that reach every branch: free ports and
distinct_hosts (per task group and per job) that limit where asks fit,
inactive asks, asks past the node count, the top-k's two selections,
cluster slices and resident rows, overlay rows padded with N, the sequential
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
from nomad_tpu_torch.ops import binpack, cuda, gang, preempt, prng, scan

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


def assert_scans_agree(kernel, plain, bits=False):
    """Choices and every carried tensor equal; scores within 1e-4, or
    with ``bits`` bit for bit (a scan that draws its own noise against
    the plain draw and the plain scan)."""
    (ch, sc, c_k), (ch_p, sc_p, c_p) = kernel, plain
    assert torch.equal(ch, ch_p)
    if bits:
        assert torch.equal(sc.view(torch.int32), sc_p.view(torch.int32))
    else:
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
    draw = prng.Draw(torch.arange(2 * b, device=dev).view(b, 2), 2.0)
    runs = []
    for fn, noise in ((binpack.greedy_scan, draw),
                      (binpack.greedy_scan_plain, draw.noise((k, n)))):
        c = fresh(base, b, n)
        runs.append((*fn(*static, c, feasible, asks, noise, 10.0), c))
    assert_scans_agree(*runs, bits=True)
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
    draw = prng.Draw(torch.arange(2 * b, device=dev).view(b, 2), 2.0)
    runs = []
    for fn, noise in ((binpack.uniform_topk, draw),
                      (binpack.uniform_topk_plain, draw.noise((n,)))):
        c = fresh(base, b, n)
        runs.append((*fn(*static, c, feasible, asks, noise, 10.0), c))
    assert_scans_agree(*runs, bits=True)
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


@pytest.mark.parametrize("b,n,g,c,p,j", [
    (1, 1000, 2, 16, 32, 64), (3, 1500, 3, 8, 64, 256),
    (2, 512, 1, 4, 16, 16), (2, 700, 64, 12, 32, 128),
    (4, 37, 2, 3, 8, 40), (2, 90, 700, 5, 8, 300),
    (64, 10240, 2, 128, 256, 1024)])
def test_expand_overlay_tiles_match_plain(dev, b, n, g, c, p, j):
    """K3 over node tiles on the CPU tests' cases (class ids of -1 and
    past C, the pad row, four allocs of one job on one node; G = 64
    takes 128-row tiles, G = 700 three task-group windows) and the main
    path's B = 64 widths, and in the shard form at lo > 0 (other
    shards' rows drop)."""
    rng = np.random.default_rng(n + g)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    n_total = 2 * n
    class_ids = rng.integers(-1, c + 3, n_total).astype(np.int32)
    patch_rows = np.full((b, p), n_total, np.int32)
    job_rows = np.full((b, j), n_total, np.int32)
    for e in range(b):
        real = rng.integers(1, p)
        patch_rows[e, :real] = rng.choice(n_total, real, replace=False)
        used = rng.integers(4, j)
        job_rows[e, :used] = rng.integers(0, n_total, used)
        job_rows[e, :4] = job_rows[e, 0]
    ov = binpack.CompactOverlay(
        verdicts=t(rng.random((b, c, g)) < 0.6), patch_rows=t(patch_rows),
        patch_vals=t(rng.random((b, p, g)) < 0.5), job_rows=t(job_rows),
        job_tgs=t(rng.integers(0, g + 1, (b, j)).astype(np.int32)))
    for lo in (0, n):
        ids = t(class_ids[lo:lo + n])
        got = binpack.expand_overlay(ids, ov, n, lo)
        want = binpack.expand_overlay_plain(ids, ov, n, lo)
        for x, y in zip(got, want):
            assert torch.equal(x, y), lo


@pytest.mark.parametrize("batch,rows,cols,total,lo", [
    (1, 1, 10240, 10240, 0), (2, 64, 10240, 10240, 0),
    (3, 5, 2561, 10244, 2561), (2, 7, 13, 40, 27), (1, 9, 3, 3, 0),
    (1, 4, 1, 1, 0), (2, 3, 1030, 1030, 0), (64, 1024, 10, 10, 0),
    (1, 70000, 16, 70000, 69984)])
def test_threefry_uniform_launch_shapes_bits(dev, batch, rows, cols, total,
                                             lo):
    """The rebuilt K0 on the launch plan test's shapes
    (tests/test_torch_draw.py): column windows, rows off 16-byte
    alignment, 65,536 (eval, row) pairs, counters past 2^32; bit-equal
    to the plain version."""
    keys = torch.from_numpy(np.random.default_rng(rows).integers(
        0, 2**32, (batch, 2), dtype=np.uint64).astype(np.int64)).to(dev)
    got = prng.threefry_uniform(keys, (rows, cols), 0.0, 2.0,
                                window=(lo, total))
    want = prng.threefry_uniform_plain(keys, (rows, cols), 0.0, 2.0,
                                       window=(lo, total))
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


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
    draw = prng.Draw(torch.arange(2 * b, device=dev).view(b, 2), 2.0)
    runs = []
    for fn, noise in ((binpack.greedy_scan, draw),
                      (binpack.greedy_scan_plain, draw.noise((k, n)))):
        c = shared_carry(base)
        runs.append((*fn(*static, c, feasible, asks, noise, 10.0, True), c))
    assert_scans_agree(*runs, bits=True)
    # Later evals see earlier claims: the shared ports run out.
    assert ((base[2] >= 2) & (runs[0][2][2] < 2)).any()


def forced_scan(**force):
    """K1 launched on the cluster, form and noise mode ``force`` gives
    (``scan.plan_for``'s ``ctas``, ``resident`` and ``drawn``),
    arguments as ``binpack.greedy_scan``."""
    def run(capacity, sched, bw_avail, node_ok, carry, feasible, asks,
            draw, penalty, seq=False):
        b, n, g = feasible.shape
        plan = scan.plan_for(feasible.device, b, n, g, seq, **force)
        return scan.launch(plan, (capacity, sched, bw_avail, node_ok),
                           carry, feasible, asks, draw, penalty, seq)
    return run


def run_greedy(static, base, feasible, asks, draw, seq, **force):
    """K1 (on the cluster, form and noise mode ``force`` gives, or
    through the wrapper on the plan's), its noise from ``draw`` (drawn
    in the kernel, or K0's read), and its plain version on the plain
    draw, on copies of the carry; returns K1's (choices, scores, carry)
    after holding the choices, the carry and the scores' bits equal."""
    b, n, _g = feasible.shape
    k = asks.resources.shape[1]
    runs = []
    kernel = forced_scan(**force) if force else binpack.greedy_scan
    for fn, noise in ((kernel, draw),
                      (binpack.greedy_scan_plain, draw.noise((k, n)))):
        c = shared_carry(base) if seq else fresh(base, b, n)
        runs.append((*fn(*static, c, feasible, asks, noise, 10.0, seq), c))
    assert_scans_agree(*runs, bits=True)
    return runs[0]


def greedy_draw(b, dev, seed=0, scale=2.0):
    """The noise of b evals as the scans draw it: keys and scale."""
    keys = torch.arange(seed, seed + 2 * b, device=dev).view(b, 2)
    return prng.Draw(keys, scale)


@pytest.mark.parametrize("drawn", [True, False], ids=["drawn", "read"])
@pytest.mark.parametrize("seq", [False, True], ids=["independent", "seq"])
@pytest.mark.parametrize("ctas", [1, 2, 4, 8, 16])
def test_greedy_scan_any_cluster_size(dev, ctas, seq, drawn):
    """A cluster of 1 to 16 CTAs (16: a non-portable cluster) gives the
    same choices and carry, at N = 3,001 (not a multiple of the CTAs or
    of their threads), the noise drawn in the kernel or read from
    K0's."""
    b, n, k, g = 3, 3001, 96, 2
    static, base, feasible, asks = scan_inputs(n, k, g, b, ctas, dev)
    ch, _sc, _c = run_greedy(static, base, feasible, asks,
                             greedy_draw(b, dev), seq, ctas=ctas,
                             drawn=drawn)
    assert (ch >= 0).any() and (ch == -1).any()


@pytest.mark.parametrize("n,ctas", [(5, 8), (9, 16), (1, 2), (1025, 1),
                                    (2049, 2), (16 * 1024 + 7, 16)])
def test_greedy_scan_short_and_ragged_slices(dev, n, ctas):
    """N below the cluster's CTAs (empty slices meet every barrier), and
    slices just past a multiple of the threads (the threads' node
    counts differ by one)."""
    b, k, g = 2, 12, 2
    static, base, feasible, asks = scan_inputs(n, k, g, b, n, dev)
    for seq in (False, True):
        run_greedy(static, base, feasible, asks, greedy_draw(b, dev),
                   seq, ctas=ctas)


@pytest.mark.parametrize("ctas", [2, 8, 16])
def test_greedy_scan_ties_across_cta_slices(dev, ctas):
    """Equal nodes with the noise off: every score ties, so each step
    takes the lowest fitting row, across the CTA slices' boundaries;
    ask 1 fits nowhere (-1, score 0, no update)."""
    n, k = 256, 6
    edges = [r * n // ctas for r in range(1, ctas)]
    rows = sorted({x for e in edges for x in (e - 1, e)})
    static, base, feasible, asks = tie_inputs(n, k, dev, rows)
    quiet = greedy_draw(1, dev, scale=0.0)
    for seq in (False, True):
        ch, sc, _c = run_greedy(static, base, feasible, asks, quiet, seq,
                                ctas=ctas)
        assert ch[0, 1].item() == -1 and sc[0, 1].item() == 0.0
        assert ch[0, 0].item() == rows[0]


def test_greedy_scan_infeasible_evals_and_inactive_asks(dev):
    """An eval no node fits and asks switched off in the middle of an
    eval: -1 with score 0 and no row update; the evals around them
    place as the plain version does (under seq: after them)."""
    b, n, k, g = 4, 2000, 40, 2
    static, base, feasible, asks = scan_inputs(n, k, g, b, 17, dev)
    feasible[1] = False
    active = asks.active.clone()
    active[2, 5:9] = False
    asks = asks._replace(active=active)
    for seq in (False, True):
        ch, sc, _c = run_greedy(static, base, feasible, asks,
                                greedy_draw(b, dev), seq)
        assert (ch[1] == -1).all() and (sc[1] == 0).all()
        assert (ch[2, 5:9] == -1).all() and (ch[0] >= 0).any()


@pytest.mark.parametrize("drawn", [True, False], ids=["drawn", "read"])
@pytest.mark.parametrize("resident", [None, False], ids=["plan", "streamed"])
@pytest.mark.parametrize("seq", [False, True], ids=["independent", "seq"])
def test_greedy_scan_reuses_scores_across_alike_asks(dev, seq, resident,
                                                      drawn):
    """Runs of alike asks (the score cache: each step rescoring only the
    node updated last), broken by asks that differ in one field at a
    time and by a new eval; distinct_hosts and ports bind, so a stale
    score would move a choice."""
    b, n, k, g = 3, 3000, 120, 2
    static, base, feasible, asks = scan_inputs(n, k, g, b, 41, dev)
    run = torch.arange(k, device=dev) // 8
    pick = lambda x: x[:, :1].expand_as(x).clone()  # noqa: E731
    res, bw, ports, tg = (pick(asks.resources), pick(asks.bw),
                          pick(asks.ports), pick(asks.tg_index))
    res[:, run % 5 == 1, 0] += 100.0
    res[:, run % 5 == 2, 3] += 1.0
    bw[:, run % 5 == 3] += 50.0
    ports[:, run % 5 == 4] += 1.0
    tg[:, run % 7 == 6] = (tg[:, run % 7 == 6] + 1) % g
    asks = asks._replace(resources=res.contiguous(), bw=bw.contiguous(),
                         ports=ports.contiguous(), tg_index=tg.contiguous(),
                         tg_distinct_hosts=torch.ones_like(
                             asks.tg_distinct_hosts))
    plan = scan.plan_for(dev, b, n, g, seq, None, resident, drawn)
    assert plan.cache and plan.drawn == drawn
    ch, _sc, _c = run_greedy(static, base, feasible, asks,
                             greedy_draw(b, dev), seq,
                             resident=resident, drawn=drawn)
    assert (ch >= 0).sum() > b * k // 2


@pytest.mark.parametrize("drawn", [True, False], ids=["drawn", "read"])
def test_greedy_scan_without_cache_or_stages(dev, drawn):
    """One CTA over 60,000 nodes: no room for the score cache or the
    read noise's stages; every row read in place, 59 nodes a thread
    (drawn: the first 5 a step ahead, the rest in the scoring pass)."""
    b, n, k, g = 2, 60000, 16, 2
    static, base, feasible, asks = scan_inputs(n, k, g, b, 43, dev)
    plan = scan.plan_for(dev, b, n, g, False, 1, None, drawn)
    assert not (plan.cache or plan.stage_noise or plan.resident)
    run_greedy(static, base, feasible, asks, greedy_draw(b, dev),
               False, ctas=1, drawn=drawn)


@pytest.mark.parametrize("seq", [False, True], ids=["independent", "seq"])
def test_greedy_scan_runs_out_of_ports(dev, seq):
    """Asks of 2 ports over 64 nodes with 0-6 free: nodes fill to their
    port limit, and later asks (later evals, under seq) go elsewhere or
    nowhere."""
    b, n, k, g = 4, 64, 64, 2
    static, base, feasible, asks = scan_inputs(n, k, g, b, 23, dev)
    asks = asks._replace(ports=torch.full_like(asks.ports, 2.0),
                         active=torch.ones_like(asks.active))
    ch, _sc, c = run_greedy(static, base, feasible, asks,
                            greedy_draw(b, dev), seq, ctas=2)
    assert ((base[2] >= 2) & (c[2] < 2)).any() and (ch == -1).any()


@pytest.mark.parametrize("b,k", [(4, 1024), (64, 64)])
@pytest.mark.parametrize("resident", [None, False], ids=["plan", "streamed"])
def test_greedy_scan_seq_main_path_shapes(dev, b, k, resident):
    """The pre_resolve shapes of the storm path at N = 10,240: B x K = 4
    x 1,024 and 64 x 64, per-eval feasibility and counts, the rows
    resident (the plan's form) and streamed; the shared ports run
    out."""
    n, g = 10240, 2
    static, base, feasible, asks = scan_inputs(n, k, g, b, b + k, dev)
    plan = scan.plan_for(dev, b, n, g, True, None, resident)
    assert plan.resident == (resident is None) and plan.ctas >= 4
    _ch, _sc, c = run_greedy(static, base, feasible, asks,
                             greedy_draw(b, dev), True,
                             resident=resident)
    assert ((base[2] >= 2) & (c[2] < 2)).any()


@pytest.mark.parametrize("b,resident", [(1, None), (1, False), (64, None),
                                        (4, None)])
@pytest.mark.parametrize("drawn", [None, True], ids=["plan", "drawn"])
def test_greedy_scan_main_path_shapes(dev, b, resident, drawn):
    """K1 at N = 10,240, K = 1,024 (B = 1: at least 4 CTAs, resident;
    B = 64: a one-wave cluster, streamed) and the stacked layout at B =
    4; through the wrapper (the plan's form and noise), one launch a
    call; and each with the noise drawn in the kernel."""
    n, k, g = 10240, 1024 if b < 64 else 128, 2
    static, base, feasible, asks = scan_inputs(n, k, g, b, 31 + b, dev)
    if b == 4:
        static = stacked_of(static, b, n, dev, 5)
    plan = scan.plan_for(dev, b, n, g, False, None, resident, drawn)
    assert plan.waves == 1
    if b == 1:
        assert plan.ctas >= 4 and plan.resident == (resident is None)
    name = "greedy_scan_stacked" if b == 4 else "greedy_scan"
    before = cuda.launch_counts().get(name, 0)
    force = {x: v for x, v in (("resident", resident), ("drawn", drawn))
             if v is not None}
    run_greedy(static, base, feasible, asks, greedy_draw(b, dev),
               False, **force)
    assert cuda.launch_counts().get(name, 0) == before + (not force)


def test_greedy_scan_draws_or_reads_the_noise_by_the_plan(dev):
    """Through the wrapper: one eval (a cluster of 16 CTAs) reads K0's
    noise, K0 launched once before the scan; 64 evals (128 CTAs) draw it
    in the kernel, no K0; bit-equal to the plain draw and scan both
    ways."""
    n, k, g = 10240, 64, 2
    for b, drawn in ((1, False), (64, True)):
        static, base, feasible, asks = scan_inputs(n, k, g, b, 61 + b, dev)
        assert scan.plan_for(dev, b, n, g, False).drawn == drawn
        before = cuda.launch_counts()
        run_greedy(static, base, feasible, asks, greedy_draw(b, dev), False)
        after = cuda.launch_counts()
        assert (after.get("threefry_uniform", 0)
                - before.get("threefry_uniform", 0)) == (not drawn)
        assert after["greedy_scan"] - before.get("greedy_scan", 0) == 1


def test_greedy_scan_refused_launch_raises(dev):
    """A cluster the card or the kernel refuses raises out of the
    wrapper; nothing else runs."""
    n, k, g, b = 500, 8, 2, 1
    static, base, feasible, asks = scan_inputs(n, k, g, b, 3, dev)
    draw = greedy_draw(b, dev)
    with pytest.raises(RuntimeError, match="no cluster"):
        forced_scan(ctas=17)(*static, fresh(base, b, n), feasible, asks,
                             draw, 10.0)
    assert scan.occupancy_of(dev)(16, 1024, 300 * 1024, True) == 0
    with pytest.raises(RuntimeError, match="no cluster"):
        scan.scan_plan(b, n, g, False, lambda c, t, m, r: 0)
    plan = scan.plan_for(dev, b, n, g, False)
    for bad in (plan._replace(smem=plan.smem + 16),
                plan._replace(ctas=32)):
        with pytest.raises(RuntimeError, match="nt_greedy_scan"):
            scan.launch(bad, static, fresh(base, b, n), feasible, asks,
                        draw, 10.0, False)


def test_greedy_scan_refuses_one_eval_buffer_under_seq(dev):
    """Resident under seq with B > 1, eval e + 1's rows load while eval
    e runs: a plan with one buffer for them (its layout sized to match)
    is refused, not run over rows still in use."""
    b, n, k, g = 3, 2000, 8, 2
    static, base, feasible, asks = scan_inputs(n, k, g, b, 5, dev)
    plan = scan.plan_for(dev, b, n, g, True)
    assert plan.resident and plan.eval_bufs == 2
    one = plan._replace(eval_bufs=1, smem=scan.layout(
        plan.ctas, plan.threads // 32, plan.slice, g, True,
        plan.stage_noise, 1, plan.cache)[1])
    with pytest.raises(RuntimeError, match="nt_greedy_scan"):
        scan.launch(one, static, shared_carry(base), feasible, asks,
                    greedy_draw(b, dev), 10.0, True)


@pytest.mark.skipif(not torch.cuda.is_available()
                    or torch.cuda.device_count() < 2,
                    reason="needs a second card")
def test_greedy_scan_on_a_second_card():
    """The kernels' attributes (shared memory, 16-CTA clusters) are set
    on each card: after cuda:0's, the plan on cuda:1 takes the same
    cluster and K1 there equals its plain version (cuda:1 current, as
    the mesh path makes each shard's card for its launches)."""
    b, n, k, g = 1, 10240, 64, 2
    on = [torch.device("cuda", i) for i in (0, 1)]
    first = scan.plan_for(on[0], b, n, g, False)
    with torch.cuda.device(on[1]):
        assert scan.plan_for(on[1], b, n, g, False) == first
        static, base, feasible, asks = scan_inputs(n, k, g, b, 9, on[1])
        run_greedy(static, base, feasible, asks,
                   greedy_draw(b, on[1]), False)


def test_wrappers_launch_on_their_tensors_card(dev):
    """With cuda:0 current, every wrapper that launches on its tensors'
    card does so under that card's context: K0, K4, K2 (through the
    cluster launch), K3, K6, K7 and K8b on cuda:1 tensors equal their
    plain versions, so does K1 with its noise drawn in the kernel and
    read from K0's, and one PlacementBatcher("cuda:1") dispatch (the
    base upload, K3, K0 and K1 reading its noise, as the plan takes at
    that batch) equals a CPU batcher's. Skips on a machine with one
    card."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs a second card: the cross-card launches")
    from nomad_tpu_torch import mock as port_mock
    from nomad_tpu_torch.models.matrix import ClusterMatrix
    from nomad_tpu_torch.scheduler.batcher import PlacementBatcher
    from nomad_tpu_torch.state import StateStore

    one = torch.device("cuda", 1)
    with torch.cuda.device(0):
        assert torch.cuda.current_device() == 0
        # K0
        keys = torch.tensor([[5, 9], [7, 3]], dtype=torch.int64, device=one)
        got = prng.threefry_uniform(keys, (6, 1000), 0.0, 2.0)
        want = prng.threefry_uniform_plain(keys, (6, 1000), 0.0, 2.0)
        assert got.device == one and torch.equal(got, want)
        # K4
        rng = np.random.default_rng(1)
        t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(one)  # noqa: E731
        n, r = 1000, 64
        parent = (t(rng.random((n, 4)).astype(np.float32)),
                  t(rng.random(n).astype(np.float32)),
                  t(rng.random(n).astype(np.float32)), t(rng.random(n) < 0.5))
        payload = (t(rng.choice(n, r, replace=False).astype(np.int32)),
                   t(rng.random((r, 4)).astype(np.float32)),
                   t(rng.random(r).astype(np.float32)),
                   t(rng.random(r).astype(np.float32)), t(rng.random(r) < 0.5))
        for x, y in zip(binpack.apply_base_delta(*parent, *payload),
                        binpack.apply_base_delta_plain(*parent, *payload)):
            assert torch.equal(x, y)
        # K2 (uniform_topk_cluster)
        static, base, feasible, asks, draw = uniform_inputs(3, 1000, 8, 4, one)
        run_uniform(static, base, feasible, asks, draw, True)
        # K3
        ov = binpack.CompactOverlay(
            verdicts=t(rng.random((2, 8, 2)) < 0.6),
            patch_rows=t(np.array([[3, 9, n], [4, n, n]], np.int32)),
            patch_vals=t(rng.random((2, 3, 2)) < 0.5),
            job_rows=t(np.array([[1, 1, 7, n], [2, 5, n, n]], np.int32)),
            job_tgs=t(np.array([[0, 1, 0, 0], [1, 0, 0, 0]], np.int32)))
        ids = t(rng.integers(-1, 8, n).astype(np.int32))
        for x, y in zip(binpack.expand_overlay(ids, ov, n),
                        binpack.expand_overlay_plain(ids, ov, n)):
            assert torch.equal(x, y)
        # K1, the noise drawn in the kernel and read from K0's
        static, base, feasible, asks = scan_inputs(n, 32, 2, 3, 4, one)
        for drawn in (True, False):
            run_greedy(static, base, feasible, asks, greedy_draw(3, one),
                       False, drawn=drawn)
        # K6
        state, victims, pasks = preempt_inputs(300, 32, 2, 3, one)
        noise = prng.threefry_uniform_plain(
            torch.tensor([[3, 1]], device=one), (32, 300), 0.0, 2.0)[0]
        outs = []
        for fn in (preempt.preempt_scan, preempt.preempt_scan_plain):
            st, vok = preempt_carry(state, victims)
            outs.append((*fn(st, victims, vok, pasks, noise, 50.0, 10.0),
                         st.util, vok))
        (ch, sc, nv, u, vk), (ch_p, sc_p, nv_p, u_p, vk_p) = outs
        assert torch.equal(ch, ch_p) and torch.equal(nv, nv_p)
        assert (sc - sc_p).abs().max().item() <= 1e-4
        assert torch.equal(u, u_p) and torch.equal(vk, vk_p)
        # K7
        gstate, ask, abw, aports = gang_inputs(400, 6, one)
        _hold_gang_scan(gstate, ask, abw, aports, "slice", False, 400, 12,
                        16, 64)
        # K8b
        b, k, g = 2, 24, 2
        static, base, feasible, asks = scan_inputs(n, k, g, b, 8, one)
        noise = prng.threefry_uniform_plain(
            torch.arange(2 * b, device=one).view(b, 2), (k, n), 0.0, 2.0)
        pref = torch.rand((b, k, n), device=one,
                          generator=torch.Generator(one).manual_seed(n))
        runs = []
        for fn in (convex.convex_round, convex.convex_round_plain):
            c = fresh(base, b, n)
            runs.append((*fn(*static, c, feasible, asks, noise, 10.0, pref),
                         c))
        assert_scans_agree(*runs)
        # One batcher dispatch on cuda:1.
        store = StateStore()
        for i in range(200):
            node = port_mock.node()
            node.compute_class()
            store.upsert_node(i + 1, node)
        job = port_mock.job()
        job.task_groups[0].tasks[0].resources.networks = []
        store.upsert_job(300, job)
        matrix = ClusterMatrix(store.snapshot(), job)
        masks = binpack.make_asks(*matrix.build_asks([0] * 8))
        config = binpack.PlacementConfig(anti_affinity_penalty=10.0)
        key = binpack.host_prng_key(7)
        got = PlacementBatcher("cuda:1", window=0.0).place(
            matrix, masks, key, config)
        want = PlacementBatcher("cpu", window=0.0).place(
            matrix, masks, key, config)
        np.testing.assert_array_equal(got[0], want[0])
        assert (np.asarray(got[0]) >= 0).any()
        assert torch.cuda.current_device() == 0


@pytest.mark.parametrize("b,n,k", [(8, 1000, 16), (3, 40000, 64)])
def test_uniform_topk_seq_matches_plain(dev, b, n, k):
    static, base, feasible, asks = scan_inputs(n, k, 2, b, n + 2, dev)
    asks = asks._replace(
        resources=asks.resources[:, :1].expand(b, k, 4).contiguous(),
        bw=asks.bw[:, :1].expand(b, k).contiguous(),
        ports=asks.ports[:, :1].expand(b, k).contiguous(),
        tg_index=torch.zeros_like(asks.tg_index),
        tg_distinct_hosts=torch.ones_like(asks.tg_distinct_hosts))
    draw = prng.Draw(torch.arange(2 * b, device=dev).view(b, 2), 2.0)
    runs = []
    for fn, noise in ((binpack.uniform_topk, draw),
                      (binpack.uniform_topk_plain, draw.noise((n,)))):
        c = shared_carry(base)
        runs.append((*fn(*static, c, feasible, asks, noise, 10.0, True), c))
    assert_scans_agree(*runs, bits=True)


def uniform_inputs(b, n, k, seed, dev, stacked=False):
    """scan_inputs with K2's asks (every ask is ask 0 of task group 0)
    and the draw of one noise value a node; every ask active when K <
    4."""
    static, base, feasible, asks = scan_inputs(n, k, 2, b, seed, dev)
    if stacked:
        static = stacked_of(static, b, n, dev, seed)
    asks = uniform_asks(asks, b, k)
    if k < 4:
        asks = asks._replace(active=torch.ones_like(asks.active))
    return static, base, feasible, asks, greedy_draw(b, dev)


def cluster_topk(ctas, resident=True):
    """K2 launched with ``ctas`` CTAs a cluster (one segment) and the
    seq rows streamed where ``resident`` is False (uniform_topk
    launches 8, resident where the rows fit)."""
    def run(capacity, sched, bw_avail, node_ok, carry, feasible, asks,
            draw, penalty, seq=False):
        _b, n, g = feasible.shape
        segs = [(0, n, (capacity, sched, bw_avail, node_ok, *carry,
                        feasible))]
        return binpack.uniform_topk_cluster(
            "uniform_topk", segs, asks, draw, g, n, penalty, seq,
            capacity.dim() == 3, ctas, resident=resident)
    return run


def run_uniform(static, base, feasible, asks, draw, seq,
                kernel=binpack.uniform_topk):
    """K2, drawing its noise from ``draw`` in the kernel, and its plain
    version on the plain draw, on copies of the carry: choices, carry
    and the scores' bits equal."""
    b, n, _g = feasible.shape
    runs = []
    for fn, noise in ((kernel, draw),
                      (binpack.uniform_topk_plain, draw.noise((n,)))):
        c = shared_carry(base) if seq else fresh(base, b, n)
        runs.append((*fn(*static, c, feasible, asks, noise, 10.0, seq), c))
    assert_scans_agree(*runs, bits=True)
    return runs[0]


@pytest.mark.parametrize("layout", ["independent", "seq", "stacked"])
@pytest.mark.parametrize("n,k", [(5, 8), (7, 3), (1003, 1), (1003, 8),
                                 (1003, 9), (1003, 32), (1003, 33),
                                 (2000, 1024), (300, 1024)])
def test_uniform_topk_selection_matches_plain(dev, layout, n, k):
    """K on both sides of the register-list limit (32) and at 1 and
    1,024 (radix select); N not a multiple of the cluster's 8 CTAs,
    below it (empty slices), and below K (surplus asks -1)."""
    b = 4
    static, base, feasible, asks, draw = uniform_inputs(
        b, n, k, 3 * n + k, dev, stacked=layout == "stacked")
    ch, _sc, _c = run_uniform(static, base, feasible, asks, draw,
                              layout == "seq")
    assert (ch >= 0).any()
    if k > n:
        assert (ch[:, n:] == -1).all()


@pytest.mark.parametrize("k", [8, 64])
def test_uniform_topk_all_infeasible_eval(dev, k):
    """An eval no node fits: every ask -1 with score 0, and the evals
    around it (seq: after it) place as the plain version does."""
    b, n = 3, 1000
    static, base, feasible, asks, draw = uniform_inputs(b, n, k, 5, dev)
    feasible[1] = False
    for seq in (False, True):
        ch, sc, _c = run_uniform(static, base, feasible, asks, draw, seq)
        assert (ch[1] == -1).all() and (sc[1] == 0).all()
        assert (ch[0] >= 0).any() and (ch[2] >= 0).any()


@pytest.mark.parametrize("k,rows", [(3, (31, 32)), (6, range(28, 40)),
                                    (40, range(20, 61)), (40, range(256))])
def test_uniform_topk_ties_across_cta_slices(dev, k, rows):
    """Equal nodes with the noise off: every score ties, so the choices
    are the fitting rows lowest index first, across the CTA slices'
    boundaries (32-row slices at N = 256) in both selections."""
    n = 256
    static, base, feasible, asks = tie_inputs(n, k, dev, list(rows))
    asks = uniform_asks(asks, 1, k)
    quiet = greedy_draw(1, dev, scale=0.0)
    for seq in (False, True):
        ch, _sc, _c = run_uniform(static, base, feasible, asks, quiet, seq)
        want = (list(rows) + [-1] * k)[:k]
        assert ch[0].tolist() == want


def test_uniform_topk_seq_runs_out_of_ports(dev):
    """16 evals of 8 asks over 64 nodes in order: later evals see the
    shared ports earlier ones claimed, and nodes run out of them."""
    b, n, k = 16, 64, 8
    static, base, feasible, asks, draw = uniform_inputs(b, n, k, 9, dev)
    _ch, _sc, c = run_uniform(static, base, feasible, asks, draw, True)
    assert ((base[2] >= 2) & (c[2] < 2)).any()


@pytest.mark.parametrize("n,resident", [(10000, True), (10000, False),
                                        (40000, True)])
def test_uniform_topk_seq_resident_and_streamed(dev, n, resident):
    """Under seq the slices' rows sit in shared memory where they fit
    (N = 10,000 on 8 CTAs) and are read from global memory where they
    do not (N = 40,000) or when asked: the same choices either way."""
    b, k = 6, 8
    static, base, feasible, asks, draw = uniform_inputs(b, n, k, n, dev)
    ch, _sc, _c = run_uniform(static, base, feasible, asks, draw, True,
                              cluster_topk(8, resident))
    assert (ch >= 0).sum() > b * k // 2


@pytest.mark.parametrize("ctas", [1, 2, 3, 5, 8])
def test_uniform_topk_any_cluster_size(dev, ctas):
    """A cluster of 1 to 8 CTAs, a power of two or not (K10d's W = 3,
    5-7 shards of one card), selects the same top K."""
    for k in (8, 64):
        static, base, feasible, asks, draw = uniform_inputs(
            4, 3000, k, ctas + k, dev)
        run_uniform(static, base, feasible, asks, draw, True,
                    cluster_topk(ctas))


def test_uniform_topk_refused_launch_raises(dev):
    """A launch the kernel refuses (more CTAs than a portable cluster)
    raises out of the wrapper; no other path runs."""
    static, base, feasible, asks, draw = uniform_inputs(1, 500, 8, 1, dev)
    with pytest.raises(RuntimeError, match="nt_uniform_topk"):
        cluster_topk(9, True)(*static, fresh(base, 1, 500), feasible, asks,
                              draw, 10.0)


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
    draw = greedy_draw(b, dev)
    if uniform:
        asks = asks._replace(
            resources=asks.resources[:, :1].expand(b, k, 4).contiguous(),
            bw=asks.bw[:, :1].expand(b, k).contiguous(),
            ports=asks.ports[:, :1].expand(b, k).contiguous(),
            tg_index=torch.zeros_like(asks.tg_index),
            tg_distinct_hosts=torch.ones_like(asks.tg_distinct_hosts))
        fns = ((binpack.uniform_topk, draw),
               (binpack.uniform_topk_plain, draw.noise((n,))))
    else:
        fns = ((binpack.greedy_scan, draw),
               (binpack.greedy_scan_plain, draw.noise((k, n))))
    runs = []
    for fn, noise in fns:
        c = fresh(base, b, n)
        runs.append((*fn(*stacked, c, feasible, asks, noise, 10.0), c))
    assert_scans_agree(*runs, bits=True)


@pytest.mark.parametrize("n,r", [(1000, 256), (10240, 4096), (10240, 256),
                                 (1000, 1), (10241, 256), (513, 4096),
                                 (511, 300)])
def test_base_delta_matches_plain(dev, n, r):
    """K4 bit-equal to its plain version, padding rows repeating the
    first changed row, rows at 0 and N - 1 and one past the end (which
    drops), N a multiple of the kernel's tile or not; the parent arrays
    stay as they were. One launch and one allocation a call: the four
    children are views of one buffer."""
    rng = np.random.default_rng(r + n)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    parent = (t(rng.random((n, 4)).astype(np.float32)),
              t(rng.random(n).astype(np.float32)),
              t(rng.random(n).astype(np.float32)), t(rng.random(n) < 0.5))
    real = max(1, min(r - 3, n))
    rows = np.full(r, 0, np.int32)
    if real >= 3:  # distinct rows: 0, N - 1, one past the end, the rest
        rows[:3] = (0, n - 1, n)
        rows[3:real] = rng.choice(np.arange(1, n - 1), real - 3,
                                  replace=False)
    else:
        rows[:real] = rng.choice(n, real, replace=False)
    rows[real:] = rows[0]
    vals = (rng.random((r, 4)).astype(np.float32),
            rng.random(r).astype(np.float32),
            rng.random(r).astype(np.float32), rng.random(r) < 0.5)
    for v in vals:
        v[real:] = v[0]
    payload = (t(rows), *(t(v) for v in vals))
    before = [x.clone() for x in parent]
    torch.cuda.synchronize()
    launches = cuda.launch_counts().get("base_delta", 0)
    allocs = torch.cuda.memory_stats()["allocation.all.allocated"]
    got = binpack.apply_base_delta(*parent, *payload)
    assert torch.cuda.memory_stats()["allocation.all.allocated"] == \
        allocs + 1
    assert cuda.launch_counts()["base_delta"] == launches + 1
    assert len({x.untyped_storage().data_ptr() for x in got}) == 1
    assert all(x.data_ptr() % 16 == 0 for x in got)
    want = binpack.apply_base_delta_plain(*parent, *payload)
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    for x, y in zip(parent, before):
        assert torch.equal(x, y)


def preempt_inputs(n, k, g, seed, dev, dh=True, room=None, varied=False,
                   holes=False):
    """A crowded cluster for K6: most nodes full, a few with room (5%,
    or ``room`` nodes); per node up to 8 priority-sorted victims (some
    outranking the eval, some holding ports and bandwidth); asks with
    ports, under task-group distinct_hosts on group 0 when ``dh``, one
    ask throughout (``varied``: each its own resources), the last 3
    inactive (``holes``: a run in the middle and the last quarter)."""
    rng = np.random.default_rng(seed)
    v = preempt.PREEMPT_MAX_VICTIMS
    t = lambda x: torch.from_numpy(np.array(x)).to(dev)
    cap = np.tile(np.array([[1000, 2000, 10000, 100]], np.float32), (n, 1))
    sched = cap - np.array([[100, 200, 0, 0]], np.float32)
    # With ``room`` given, no other node fits the ask without eviction.
    util = (cap - sched) + np.stack(
        [rng.integers(12 if room is None else 13, 19, n) * 50,
         rng.integers(10, 19, n) * 100, np.zeros(n), np.zeros(n)],
        1).astype(np.float32)
    roomy = (rng.random(n) < 0.05 if room is None
             else np.isin(np.arange(n), rng.choice(n, room, replace=False)))
    util[roomy, :2] = (300, 400)  # room without eviction
    feasible = rng.random((n, g)) < 0.9
    node_ok = rng.random(n) < 0.95
    tg_count = rng.integers(0, 2, (n, g)).astype(np.int32)
    if room is not None:  # the roomy nodes take any ask
        feasible[roomy] = node_ok[roomy] = True
        tg_count[roomy] = 0
    state = binpack.NodeState(
        capacity=t(cap), sched_capacity=t(sched), util=t(util),
        bw_avail=t(np.full(n, 100, np.float32)),
        bw_used=t(rng.integers(0, 5, n).astype(np.float32) * 20),
        ports_free=t(rng.integers(0, 3, n).astype(np.float32)),
        job_count=t(rng.integers(0, 2, n).astype(np.int32)),
        tg_count=t(tg_count), feasible=t(feasible), node_ok=t(node_ok))
    res = np.zeros((n, v, 4), np.float32)
    vbw = np.zeros((n, v), np.float32)
    vports = np.zeros((n, v), np.float32)
    prio = np.full((n, v), np.inf, np.float32)
    ok = np.zeros((n, v), bool)
    m = rng.integers(0, v + 1, n)
    for i in range(n):
        prio[i, :m[i]] = np.sort(rng.integers(5, 80, m[i]))
        res[i, :m[i], 0] = rng.integers(1, 6, m[i]) * 50
        res[i, :m[i], 1] = rng.integers(1, 6, m[i]) * 100
        vbw[i, :m[i]] = rng.integers(0, 3, m[i]) * 10
        vports[i, :m[i]] = rng.integers(0, 2, m[i])
        ok[i, :m[i]] = True
    victims = preempt.VictimState(t(res), t(vbw), t(vports), t(prio), t(ok))
    active = np.ones(k, bool)
    active[-3:] = False
    if holes:
        active[k // 4:k // 4 + 5] = False
        active[-(k // 4):] = False
    ask = np.tile(np.array([[300, 400, 0, 0]], np.float32), (k, 1))
    if varied:
        ask[:, 0] = rng.integers(2, 8, k) * 50
        ask[:, 1] = rng.integers(2, 8, k) * 100
    asks = binpack.Asks(
        resources=t(ask),
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


def forced_preempt(stage_noise=None, cache=None, **force):
    """K6 launched on the cluster and form ``force`` gives
    (``scan.preempt_plan_for``'s ``ctas`` and ``resident``), with the
    noise's stages or the score cache turned off where ``stage_noise``
    or ``cache`` is False (the forms a slice past the shared memory
    takes), arguments as ``preempt.preempt_scan``."""
    def run(state, victims, vok, asks, noise, prio, penalty):
        n, g = state.feasible.shape
        plan = scan.preempt_plan_for(state.capacity.device, n, g, **force)
        if stage_noise is not None or cache is not None:
            plan = plan._replace(
                stage_noise=plan.stage_noise if stage_noise is None
                else stage_noise,
                cache=plan.cache if cache is None else cache)
            plan = plan._replace(smem=scan.preempt_layout(
                plan.ctas, plan.threads // 32, plan.slice, g, plan.resident,
                plan.stage_noise, plan.cache)[1])
        return scan.launch_preempt(plan, state, victims, vok, asks, noise,
                                   float(np.float32(prio)), penalty)
    return run


@pytest.mark.parametrize("n,k,g,dh,room,varied,holes,force", [
    (300, 64, 2, True, None, False, False, {}),
    (2000, 256, 2, True, None, False, False, {}),
    # 64 asks on 40 nodes without distinct_hosts evict on the same node
    # more than once, so the consumed victims decide later choices.
    (40, 64, 2, False, None, False, False, {}),
    (40, 64, 2, False, None, False, False, {"resident": False}),
    # The chip phase's shape (one task group, 256 nodes with room),
    # resident on 16 CTAs.
    (10240, 1024, 1, True, 256, False, False, {}),
    (10240, 64, 16, True, 4, False, False, {}),  # streamed by its G
    (3000, 128, 2, True, 10, False, False, {"resident": False}),
    (3000, 128, 2, True, 10, False, False, {"ctas": 3}),
    (2000, 256, 2, True, 10, True, False, {}),  # varied asks: cache misses
    (2000, 8, 2, True, 1, False, False, {}),  # K = 8
    (2000, 96, 2, True, 8, False, True, {}),  # inactive runs
    (2000, 96, 2, True, 8, True, True, {"resident": False}),
    # Streamed with the noise read from K0's tensor (no stages), the
    # score cache on and off; inactive runs skip the block barrier.
    (3000, 128, 2, True, 10, False, False,
     {"resident": False, "stage_noise": False}),
    (3000, 128, 2, True, 10, False, False,
     {"resident": False, "stage_noise": False, "cache": False}),
    (2000, 96, 2, True, 8, True, True,
     {"resident": False, "stage_noise": False}),
    (2000, 96, 2, True, 8, True, True,
     {"resident": False, "stage_noise": False, "cache": False})])
def test_preempt_scan_matches_plain(dev, n, k, g, dh, room, varied, holes,
                                    force):
    """K6 against its plain version: choices, n_victims, scores, and
    the final carry (util, bw_used, ports_free, job_count, tg_count and
    the consumed-victim mask), through the wrapper (one launch a call,
    the plan's cluster and form) or on a forced plan."""
    state, victims, asks = preempt_inputs(n, k, g, n + k, dev, dh, room,
                                          varied, holes)
    noise = prng.threefry_uniform(
        torch.tensor([[3, n]], device=dev), (k, n), 0.0, 2.0)[0]
    runs = []
    kernel = forced_preempt(**force) if force else preempt.preempt_scan
    for fn in (kernel, preempt.preempt_scan_plain):
        st, vok = preempt_carry(state, victims)
        before = cuda.launch_counts().get("preempt_scan", 0)
        runs.append((*fn(st, victims, vok, asks, noise, 50.0, 10.0),
                     st, vok))
        if fn is preempt.preempt_scan:
            assert cuda.launch_counts()["preempt_scan"] == before + 1
    (ch, sc, nv, st, vok), (ch_p, sc_p, nv_p, st_p, vok_p) = runs
    assert torch.equal(ch, ch_p)
    assert torch.equal(nv, nv_p)
    assert (sc - sc_p).abs().max().item() <= 1e-4
    for name in CARRY:
        assert torch.equal(getattr(st, name), getattr(st_p, name)), name
    assert torch.equal(vok, vok_p)
    # Both branches ran: some asks evicted, some fit without.
    assert (nv > 0).any() and ((ch >= 0) & (nv == 0)).any()
    assert (ch[~asks.active] == -1).all() and (nv[~asks.active] == 0).all()


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
# K7's cluster forced (``scan.gang_plan_for``'s hooks): the plan's, 3
# CTAs (N not a multiple of them), the rows streamed, the group counts
# and sums in global memory.
GANG_FORMS = [{}, {"ctas": 3}, {"resident": False}, {"groups": False}]
GANG_FORM_IDS = ["plan", "3-ctas", "streamed", "global-groups"]


@pytest.mark.parametrize("force", GANG_FORMS, ids=GANG_FORM_IDS)
@pytest.mark.parametrize("mode,dh", GANG_CASES)
@pytest.mark.parametrize("n,k_real,k,g_pad,rack", [
    (400, 12, 16, 64, 8), (1200, 16, 16, 64, 60),
    (3000, 200, 256, 1024, 3), (40, 200, 256, 16, 8)])
def test_gang_scan_matches_plain(dev, mode, dh, n, k_real, k, g_pad, rack,
                                 force):
    """K7 against its plain version in every mode, with and without
    distinct_hosts, on the plan's cluster and on each forced form:
    choices, scores, slice_group and the final carry (util, bw_used,
    ports_free, placed, group members); one launch a call."""
    state, ask, abw, aports = gang_inputs(n, k_real + n, dev, rack=rack)
    _hold_gang_scan(state, ask, abw, aports, mode, dh, n, k_real, k, g_pad,
                    **force)


@pytest.mark.parametrize("force", [{}, {"groups": False}],
                         ids=["plan", "global-groups"])
@pytest.mark.parametrize("mode,dh", GANG_CASES)
@pytest.mark.parametrize("n,k_real,k,g_pad,rack,shuffle", [
    (6000, 300, 512, 4096, 2, False), (5000, 4, 8, 4096, 2, False),
    (2000, 64, 64, 2048, 1, True), (6000, 300, 512, 65536, 2, False),
    (10240, 512, 512, 10240, 1, True)])
def test_gang_scan_many_groups(dev, mode, dh, n, k_real, k, g_pad, rack,
                               shuffle, force):
    """Many groups (every node without the level's meta is its own
    group in free, spread and affinity mode): the group counts and sums
    in shared memory where the plan's layout holds them (10,240 on 16
    CTAs) and in global memory past it (65,536 groups: a row of counts a
    CTA), or forced there; the same checks as above, on racks of two
    and on singleton groups whose ids are shuffled over the nodes."""
    state, ask, abw, aports = gang_inputs(n, k_real + n, dev, rack=rack)
    if shuffle:
        perm = np.random.default_rng(n).permutation(n)
        state = state._replace(topo_ids=state.topo_ids[torch.from_numpy(
            perm).to(dev)].contiguous())
    plan = scan.gang_plan_for(dev, n, g_pad, gang._MODE_IDS[mode], **force)
    assert plan.groups == (g_pad <= 10240 and not force)
    _hold_gang_scan(state, ask, abw, aports, mode, dh, n, k_real, k, g_pad,
                    **force)


@pytest.mark.parametrize("mode,dh", GANG_CASES)
@pytest.mark.parametrize("n,ctas", [(5, 8), (9, 16), (1, 2), (1025, 1),
                                    (500, 16), (3001, 5),
                                    (16 * 1024 + 7, 16)])
def test_gang_scan_short_and_ragged_slices(dev, mode, dh, n, ctas):
    """N below the cluster's CTAs (empty slices meet every barrier), N
    under 32 a CTA, N not a multiple of the CTAs, and slices just past a
    multiple of the threads."""
    state, ask, abw, aports = gang_inputs(n, n + ctas, dev, rack=3)
    _hold_gang_scan(state, ask, abw, aports, mode, dh, n, min(n, 6),
                    min(n, 6) + 2, 64, ctas=ctas)


@pytest.mark.parametrize("force", GANG_FORMS, ids=GANG_FORM_IDS)
@pytest.mark.parametrize("mode", ["slice", "spread"])
def test_gang_scan_zero_ask_group_sums_on_every_form(dev, mode, force):
    """A zero ask gives every feasible node 1e9 units: the group sums
    pass 2^24, so rank 0 sums them again in node order; on every form
    (the sums in its shared memory or in global memory), racks of 2 and
    of 13, the slice choice and the spread cap are the plain
    version's."""
    for n, rack, g_pad in ((4000, 2, 2048), (1000, 13, 256)):
        state, ask, abw, aports = gang_inputs(n, 6, dev, rack=rack,
                                              zero_ask=True)
        _hold_gang_scan(state, ask, abw, aports, mode, False, n, 8, 8,
                        g_pad, **force)


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


def forced_gang(**force):
    """K7 launched on the cluster, form and group placement ``force``
    gives (``scan.gang_plan_for``'s ``ctas``, ``resident`` and
    ``groups``), arguments as ``gang.gang_scan``."""
    def run(state, ask, abw, aports, active, noise, gnoise, cfg, placed,
            members):
        mode = gang._MODE_IDS[cfg.mode]
        plan = scan.gang_plan_for(state.capacity.device,
                                  state.util.shape[0], cfg.g_pad, mode,
                                  **force)
        return scan.launch_gang(plan, state, ask, abw, aports, active, noise,
                                gnoise, mode, cfg.distinct_hosts,
                                cfg.anti_affinity_penalty, placed, members)
    return run


def _hold_gang_scan(state, ask, abw, aports, mode, dh, n, k_real, k, g_pad,
                    **force):
    """K7 (through the wrapper, one launch a call, or on the forced
    plan) and its plain version on copies of the carry: every output
    and the final carry equal, scores within 1e-4."""
    dev = state.capacity.device
    active = torch.zeros(k, dtype=torch.bool, device=dev)
    active[:k_real] = True
    cfg = gang.GangConfig(anti_affinity_penalty=10.0, mode=mode,
                          distinct_hosts=dh, g_pad=g_pad)
    keys = torch.tensor([[0, k_real], [1, n]], device=dev)
    noise = prng.threefry_uniform(keys[:1], (k, n), 0.0, 2.0)[0]
    gnoise = prng.threefry_uniform(keys[1:], (g_pad,), 0.0, 1.0)[0]
    runs = []
    kernel = forced_gang(**force) if force else gang.gang_scan
    for fn in (kernel, gang.gang_scan_plain):
        st = state._replace(util=state.util.clone(),
                            bw_used=state.bw_used.clone(),
                            ports_free=state.ports_free.clone())
        placed = torch.zeros(n, dtype=torch.int32, device=dev)
        members = torch.zeros(g_pad, dtype=torch.float32, device=dev)
        before = cuda.launch_counts().get("gang_scan", 0)
        out = fn(st, ask, abw, aports, active, noise, gnoise, cfg, placed,
                 members)
        if fn is gang.gang_scan:
            assert cuda.launch_counts()["gang_scan"] == before + 1
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
    if k >= 1024:
        # 1,024 asks of 1-2 ports on nodes with 0-6 free ports make the
        # float32 solve chaotic (the plain version itself lands ~0.3 from
        # its float64 run, which then holds nothing): these take none.
        asks = asks._replace(ports=torch.zeros_like(asks.ports))
    if layout == "shared":
        c = shared_carry(base)
    else:
        c = fresh(base, b, n)
    if layout == "stacked":
        static = tuple(x.expand(b, *x.shape).contiguous() for x in static)
        static = (static[0] * 2, static[1] * 2, *static[2:])
    return static, c, feasible, asks


# K8a's and K10g-a's shapes on the card: K in {1, 8, 64, 1,024}, N not
# a multiple of a tile (32 nodes) or a piece, B > 1 in every layout.
RELAX_SHAPES = [
    ("independent", 3, 300, 24, 2), ("shared", 1, 777, 40, 3),
    ("stacked", 2, 500, 16, 2), ("independent", 1, 10240, 8, 2),
    ("independent", 2, 1001, 1, 2), ("shared", 3, 650, 8, 2),
    ("stacked", 3, 333, 64, 3), ("independent", 1, 10240, 1024, 2),
    ("shared", 2, 2049, 64, 2), ("stacked", 2, 1500, 1024, 2)]


@pytest.mark.parametrize("layout,b,n,k,g", RELAX_SHAPES)
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
    # Two runs give the same bits.
    again = convex.relaxed_assignment(*static, c, feasible, asks, 10.0)
    for x, y in zip(got, again):
        assert torch.equal(x, y)


@pytest.mark.parametrize("k,n", [(1, 3000), (8, 3000), (64, 3000),
                                 (1024, 10240)])
def test_convex_relax_all_infeasible_rows_are_uniform(dev, k, n):
    """A row with no feasible node comes out 1 / N on every node, and
    its pref is what the plain version gives; the other rows stay held
    to RELAX_TOLS."""
    static, c, feasible, asks = relax_inputs("independent", n, k, 2, 2, 4,
                                             dev)
    res = asks.resources.clone()
    res[:, : max(1, k // 4), 0] = 1e7
    asks = asks._replace(resources=res)
    got = convex.relaxed_assignment(*static, c, feasible, asks, 10.0)
    plain = convex.relaxed_assignment_plain(*static, c, feasible, asks, 10.0)
    plain64 = convex.relaxed_assignment_plain(
        *_double(static), _double(c), feasible, _double(asks), 10.0)
    assert_relax_agrees(got, plain, plain64, ("logits", "x", "pref"))
    dead = got[1][:, : max(1, k // 4)]
    assert torch.allclose(dead, torch.full_like(dead, 1 / n), rtol=1e-5,
                          atol=0)


def test_relax_is_one_launch_a_call(dev):
    """K8a, K9 and the loop alone: one launch a call, at K = 8 and K =
    1,024."""
    for k in (8, 1024):
        static, c, feasible, asks = relax_inputs("independent", 1000, k, 2,
                                                 1, 2, dev)
        before = cuda.launch_counts()
        convex.relaxed_pref(*static, c, feasible, asks, 10.0)
        args, iters = defrag_args(False, k, 700, dev)
        convex.defrag_solve(*args, iters)
        after = cuda.launch_counts()
        for name in ("convex_relax", "defrag_solve"):
            assert after[name] == before.get(name, 0) + 1, (name, k)


def test_relax_refused_launch_raises(dev, monkeypatch):
    """A grid larger than the card holds at once is refused by the
    cooperative launch, and the wrapper raises: nothing runs, nothing
    falls back."""
    from nomad_tpu_torch.ops import relax

    static, c, feasible, asks = relax_inputs("independent", 1000, 8, 2, 1,
                                             2, dev)
    blocks, sms = relax.occupancy(dev, False)
    monkeypatch.setattr(relax, "grid_size",
                        lambda plan, b, s: 2 * blocks * sms + 1)
    with pytest.raises(RuntimeError, match="nt_relax_solve"):
        convex.relaxed_pref(*static, c, feasible, asks, 10.0)
    torch.cuda.synchronize()


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
                                      (False, 16, 10240), (True, 16, 10240),
                                      (False, 1, 333), (True, 512, 1000)])
def test_defrag_solve_matches_plain(dev, warm, k, w):
    args, iters = defrag_args(warm, k, w, dev)
    got = convex.defrag_solve(*args, iters)
    plain = convex.defrag_solve_plain(*args, iters)
    plain64 = convex.defrag_solve_plain(*_double(tuple(args)), iters)
    assert_relax_agrees(got, plain, plain64, ("logits", "x"))
    assert got[1][-3:].abs().max().item() == 0.0


def round_call(layout, b, n, k, g, dev):
    """K8b's inputs for one layout: (static, base, feasible, asks,
    noise, pref, seq). "tight" gives every node the same pref and 1 to
    3 asks of CPU headroom, so the strand term decides between nodes;
    "varied" gives each step other resources than the last (the score
    cache serves no step); "alike" one ask throughout (it serves every
    step but the first)."""
    static, base, feasible, asks = scan_inputs(n, k, g, b, n + 5, dev)
    if layout == "varied":
        res = asks.resources.clone()
        res[:, :, 0] = 100.0 * (1 + torch.arange(k, device=dev) % 10)
        asks = asks._replace(resources=res)
    if layout == "alike":
        pick = lambda x: x[:, :1].expand_as(x).contiguous()  # noqa: E731
        asks = asks._replace(resources=pick(asks.resources),
                             bw=pick(asks.bw), ports=pick(asks.ports))
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
    return static, base, feasible, asks, noise, pref, seq


def forced_round(**force):
    """K8b launched on the cluster and form ``force`` gives
    (``scan.plan_for``'s ``ctas`` and ``resident``, with ``bias``),
    arguments as ``convex.convex_round``."""
    def run(capacity, sched, bw_avail, node_ok, carry, feasible, asks, noise,
            penalty, pref, seq=False):
        b, n, g = feasible.shape
        plan = scan.plan_for(feasible.device, b, n, g, seq, bias=True,
                             **force)
        return scan.launch_round(plan, (capacity, sched, bw_avail, node_ok),
                                 carry, feasible, asks, noise, pref, penalty,
                                 seq)
    return run


def hold_round(static, base, feasible, asks, noise, pref, seq, **force):
    """K8b (through the wrapper, one launch a call, or on the forced
    plan) against its plain version on copies of the carry; returns
    K8b's (choices, scores, carry)."""
    b, n, _g = feasible.shape
    stacked = static[0].dim() == 3
    name = "convex_round" + ("_seq" if seq else "_stacked" if stacked
                             else "")
    runs = []
    kernel = forced_round(**force) if force else convex.convex_round
    for fn in (kernel, convex.convex_round_plain):
        c = shared_carry(base) if seq else fresh(base, b, n)
        before = cuda.launch_counts().get(name, 0)
        runs.append((*fn(*static, c, feasible, asks, noise, 10.0, pref,
                         seq), c))
        if fn is convex.convex_round:
            assert cuda.launch_counts()[name] == before + 1
    assert_scans_agree(*runs)
    return runs[0]


@pytest.mark.parametrize("layout,b,n,k,g", [
    ("independent", 3, 300, 48, 2), ("seq", 4, 777, 40, 3),
    ("stacked", 2, 500, 64, 2), ("independent", 1, 10240, 128, 2),
    ("tight", 3, 300, 48, 2), ("seq", 1, 10240, 8, 2),
    ("seq", 1, 128, 8, 2), ("independent", 1, 128, 16, 2),
    ("stacked", 3, 128, 16, 2), ("varied", 2, 3001, 64, 2),
    ("alike", 2, 3001, 64, 2), ("seq", 3, 3001, 64, 2)])
def test_convex_round_matches_plain(dev, layout, b, n, k, g):
    """K8b fed one pref: choices and all five carried tensors equal,
    scores within 1e-4, with ports and distinct_hosts binding, through
    the wrapper (one launch a call): every batch layout (under seq one
    eval, as each eval under pre_resolve, and several), the storm's 1 x
    8 at N = 10,240 and the rig's N = 128, asks alike at every step and
    asks that differ at every step."""
    static, base, feasible, asks, noise, pref, seq = round_call(
        layout, b, n, k, g, dev)
    ch, _sc, c = hold_round(static, base, feasible, asks, noise, pref, seq)
    assert (ch >= 0).any()
    if k >= 40:  # the ports run out somewhere
        assert ((base[2] >= 2) & (c[2] < 2)).any()


@pytest.mark.parametrize("force", [{"ctas": 1}, {"ctas": 3}, {"ctas": 16},
                                   {"resident": False},
                                   {"ctas": 16, "resident": False}],
                         ids=["1-cta", "3-ctas", "16-ctas", "streamed",
                              "16-streamed"])
@pytest.mark.parametrize("layout", ["independent", "seq", "stacked",
                                    "tight", "varied"])
def test_convex_round_on_every_cluster_and_form(dev, layout, force):
    """K8b on clusters of 1, 3 and 16 CTAs (N = 3,001: not a multiple of
    them) and streamed (the pref read in place where its stages do not
    fit), in every layout: the plain version's choices and carry."""
    b, n, k, g = (1 if layout == "seq" else 2), 3001, 40, 2
    static, base, feasible, asks, noise, pref, seq = round_call(
        layout, b, n, k, g, dev)
    hold_round(static, base, feasible, asks, noise, pref, seq, **force)


def test_convex_round_short_slices(dev):
    """N below the cluster's CTAs and under 32 a CTA (empty slices meet
    every exchange)."""
    for n, ctas in ((5, 8), (9, 16), (100, 16)):
        for layout in ("independent", "seq"):
            static, base, feasible, asks, noise, pref, seq = round_call(
                layout, 1, n, 6, 2, dev)
            hold_round(static, base, feasible, asks, noise, pref, seq,
                       ctas=ctas)


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
                noise_scale=2.0, drawn=False, bounds=None, views=False):
    """The scan inputs split into w node shards (NodeShard), each with
    its own carry copy and its window of the noise: K0's window
    (greedy), the window's Draw (uniform: K10d's one-card route draws
    it in its kernel), or with ``drawn`` the plain draw of the window
    (the plain versions' yardstick). ``bounds``: the shards' [lo, hi)
    (default w equal ones); ``views``: each shard's rows a view into
    the whole tensor where that is contiguous (rows that start at any
    byte, as a mesh's one allocation gives them), else a copy."""
    from nomad_tpu_torch.parallel.mesh import shard_bounds
    from nomad_tpu_torch.parallel.shard import NodeShard

    b, n, _g = feasible.shape
    k = asks.resources.shape[1]
    stacked = static[0].dim() == 3
    carry = shared_carry(base) if seq else fresh(base, b, n)
    d = 1 if stacked else 0
    out = []
    for lo, hi in bounds or shard_bounds(n, w):
        def part(x, dim):
            v = x.narrow(dim, lo, hi - lo)
            return v if views and v.is_contiguous() else v.contiguous()
        own = 0 if seq else 1
        shape = (hi - lo,) if uniform else (k, hi - lo)
        draw = prng.Draw(keys, noise_scale, lo, n)
        if drawn:
            noise, draw = draw.noise(shape), None
        elif uniform:
            noise = None
        else:
            noise, draw = prng.threefry_uniform(
                keys, shape, 0.0, noise_scale, window=(lo, n)), None
        out.append(NodeShard(
            lo, *(part(x, d) for x in static),
            (part(carry[0], own), part(carry[1], own), part(carry[2], own),
             part(carry[3], 1), part(carry[4], 1)),
            part(feasible, 1), asks, noise, draw=draw))
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
@pytest.mark.parametrize("w", [1, 2, 3, 4, 8, 9])
@pytest.mark.parametrize("uniform", [False, True], ids=["greedy", "uniform"])
def test_sharded_scans_match_plain_and_unsharded(dev, uniform, w, layout):
    """K10c / K10d on w shards of the card: choices, scores and every
    carried tensor equal the plain sharded version's (scores within
    1e-4), and equal K1 / K2 on the whole node axis bit for bit. K10d
    takes its one-launch path at w <= 8 (a cluster of 6 CTAs at w = 3)
    and its per-shard path at w = 9 (N = 1,008 where 1,000 does not
    split)."""
    from nomad_tpu_torch.parallel import shard

    b, n, k, g = 3, 1008 if w in (3, 9) else 1000, 40, 2
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
    for fn, drawn in ((kern, False), (plain, True)):
        shards = shard_split(static, base, feasible, asks, keys, w, uniform,
                             seq, drawn=drawn)
        runs.append((*fn(shards, 10.0, seq), join_carry(shards, seq)))
    assert_scans_agree(*runs, bits=True)
    c = shared_carry(base) if seq else fresh(base, b, n)
    ch, sc = one(*static, c, feasible, asks, prng.Draw(keys, 2.0), 10.0,
                 seq)
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
    for fn, drawn in ((shard.sharded_greedy_scan, False),
                      (shard.sharded_greedy_scan_plain, True)):
        shards = shard_split(static, base, feasible, asks, keys, w, False,
                             False, noise_scale=0.0, drawn=drawn)
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
    for fn, drawn in ((shard.sharded_uniform_topk, False),
                      (shard.sharded_uniform_topk_plain, True)):
        shards = shard_split(static, base, feasible, asks, keys, w, True,
                             False, noise_scale=0.0, drawn=drawn)
        runs.append((*fn(shards, 10.0), join_carry(shards, False)))
    assert_scans_agree(*runs)
    assert runs[0][0].tolist() == [[edge - 1, edge, -1]]


@pytest.mark.parametrize("w", [1, 2, 4])
def test_sharded_uniform_topk_global_scratch_and_surplus(dev, w):
    """Shards of 15,000 to 60,000 nodes (past the shared-memory
    residency of their CTAs' slices, the rows read from global memory),
    and more asks than nodes fit."""
    from nomad_tpu_torch.parallel import shard

    b, n, k = 2, 60000, 64
    static, base, feasible, asks = scan_inputs(n, k, 2, b, 3 + w, dev)
    asks = uniform_asks(asks, b, k)
    keys = torch.arange(2 * b, device=dev).view(b, 2)
    runs = []
    for fn, drawn in ((shard.sharded_uniform_topk, False),
                      (shard.sharded_uniform_topk_plain, True)):
        shards = shard_split(static, base, feasible, asks, keys, w, True,
                             True, drawn=drawn)
        runs.append((*fn(shards, 10.0, True), join_carry(shards, True)))
    assert_scans_agree(*runs, bits=True)
    c = shared_carry(base)
    ch, _sc = binpack.uniform_topk(*static, c, feasible, asks,
                                   prng.Draw(keys, 2.0), 10.0, True)
    assert torch.equal(runs[0][0], ch)


def delta_inputs(n, r, seed):
    """A parent base of n rows and an R-row payload: R - 56 distinct
    rows, the rest repeating the first (the batcher's padding), two rows
    outside the base."""
    rng = np.random.default_rng(seed)
    parent = (rng.random((n, 4)).astype(np.float32),
              rng.random(n).astype(np.float32),
              rng.random(n).astype(np.float32), rng.random(n) < 0.5)
    real = r - 56
    rows = np.full(r, 0, np.int32)
    rows[:real] = rng.choice(n, real, replace=False)
    rows[real:] = rows[0]
    vals = [rng.random((r, 4)).astype(np.float32),
            rng.random(r).astype(np.float32),
            rng.random(r).astype(np.float32), rng.random(r) < 0.5]
    for v in vals:
        v[real:] = v[0]
    rows[1], rows[2] = -5, n + 3
    return parent, rows, vals


@pytest.mark.parametrize("r", [256, 4096])
@pytest.mark.parametrize("w", [1, 2, 4, 8, 9])
def test_sharded_base_delta_matches_plain(dev, w, r):
    """K10a: one fused launch over the W shards of the card, rows in
    every shard, padding rows repeating the first row, rows outside the
    base dropped. Bit-equal to the plain version and to K4 on the whole
    base; the parent stays as it was."""
    from nomad_tpu_torch.parallel.mesh import gather, make_mesh, place
    from nomad_tpu_torch.parallel.shard import sharded_base_delta

    n = 4608
    parent, rows, vals = delta_inputs(n, r, w + r)
    specs = [("nodes", None), ("nodes",), ("nodes",), ("nodes",)]
    got = []
    for devices in (["cuda"] * w, ["cpu"] * w):
        mesh = make_mesh(devices=devices)
        targets = place(mesh, parent, specs)
        cuda.reset_launch_counts()
        got.append([gather(x) for x in sharded_base_delta(mesh)(
            *targets, rows, *vals)])
        assert cuda.launch_counts().get("sharded_base_delta", 0) == (
            1 if devices[0] == "cuda" else 0)
        for x, p in zip(targets, parent):
            assert torch.equal(gather(x), torch.from_numpy(p))  # untouched
    keep = (rows >= 0) & (rows < n)
    one = binpack.apply_base_delta(*(torch.from_numpy(x).to(dev) for x in (
        *parent, rows[keep], *(v[keep] for v in vals))))
    for x, y, z in zip(*got, one):
        assert torch.equal(x, y) and torch.equal(x, z.cpu())


def test_sharded_base_delta_children_share_one_allocation(dev):
    """The card's children are views of one allocation, the util rows
    16-byte aligned; a second delta on a child leaves that child as it
    was."""
    from nomad_tpu_torch.parallel.mesh import gather, make_mesh, place
    from nomad_tpu_torch.parallel.shard import sharded_base_delta

    n, w = 2048, 4
    parent, rows, vals = delta_inputs(n, 256, 3)
    mesh = make_mesh(devices=["cuda"] * w)
    child = sharded_base_delta(mesh)(*place(mesh, parent, [
        ("nodes", None), ("nodes",), ("nodes",), ("nodes",)]), rows, *vals)
    storage = {x.untyped_storage().data_ptr() for c in child
               for x in c.parts[0]}
    assert len(storage) == 1
    assert all(x.data_ptr() % 16 == 0 for x in child[0].parts[0])
    before = [gather(c) for c in child]
    _p2, rows2, vals2 = delta_inputs(n, 256, 4)
    grand = sharded_base_delta(mesh)(*child, rows2, *vals2)
    for c, b in zip(child, before):
        assert torch.equal(gather(c), b)
    keep = (rows2 >= 0) & (rows2 < n)
    for j, (g, b) in enumerate(zip(grand, before)):
        b = b.clone()
        b[torch.from_numpy(rows2[keep]).long()] = torch.from_numpy(
            vals2[j][keep])
        assert torch.equal(gather(g), b)


def test_sharded_base_delta_refused_launch_raises(dev):
    """No fallback: a table forced into shared memory past its 227 KB
    (R = 32,768) is refused by the C entry, and the wrapper raises. The
    same table searched in device memory gives each child the plain
    scatter of its shard (duplicate rows carry equal values, as the
    batcher's padding does; rows outside the base drop)."""
    from nomad_tpu_torch.parallel import shard
    from nomad_tpu_torch.parallel.mesh import make_mesh, place

    n, r = 1024, 32768
    parent, _rows, _vals = delta_inputs(n, 256, 5)
    mesh = make_mesh(devices=["cuda"] * 2)
    targets = place(mesh, parent, [("nodes", None), ("nodes",), ("nodes",),
                                   ("nodes",)])
    rng = np.random.default_rng(5)
    raw = rng.integers(-32, n + 32, r).astype(np.int32)
    by_row = (rng.random((n + 64, 4)).astype(np.float32),
              rng.random(n + 64).astype(np.float32),
              rng.random(n + 64).astype(np.float32), rng.random(n + 64) < 0.5)
    vals = [v[raw + 32] for v in by_row]
    rows, order = shard.delta_row_table(raw)
    pay = [torch.from_numpy(x).to(dev) for x in (rows, order, *vals)]
    parents = [t.parts[0] for t in targets]
    ptrs = [x.data_ptr() for x in pay]
    with pytest.raises(RuntimeError, match="nt_base_delta_shards"):
        shard._base_delta_card(parents[0][0].device, [0, 1], parents,
                               targets[0].lo, ptrs, r, True)
    got = shard._base_delta_card(parents[0][0].device, [0, 1], parents,
                                 targets[0].lo, ptrs, r, False)
    for i in range(2):
        want = binpack.apply_base_delta_plain(
            *(p[i].cpu() for p in parents), torch.from_numpy(raw),
            *(torch.from_numpy(v) for v in vals), targets[0].lo[i])
        for g, x in zip(got, want):
            assert torch.equal(g[i].cpu(), x)


def group_inputs(n, g_pad, seed, huge=False):
    """Units and ids for K10b: whole numbers under 2^24 (or, ``huge``,
    1e9-scale addends whose sums round), ids in range with -1s (at
    most n / 3 groups, so groups collect several nodes), and one group a
    node at g_pad = n + 1,024."""
    rng = np.random.default_rng(seed)
    if huge:
        units = rng.choice(np.array([1e9, 1e9 + 64, 7.5e8, 3.0, 0.0],
                                    np.float32), n)
    else:
        units = rng.integers(0, 40, n).astype(np.float32)
    ids = (np.arange(n) if g_pad == n + 1024 else rng.integers(
        0, min(g_pad - 2, n // 3), n)).astype(np.int32)
    ids[rng.choice(n, 50, replace=False)] = -1
    return units, ids


@pytest.mark.parametrize("g_pad", [16, 256, 2048, 10240, 65536])
@pytest.mark.parametrize("w", [1, 2, 4, 8, 9])
def test_sharded_group_capacity_matches_plain(dev, w, g_pad):
    """K10b, one launch on the card: -1 ids drop, a group spans shards,
    more than 1,024 groups, one group a node (g_pad 10,240), and a
    partial past shared memory (g_pad 65,536: built in its device-memory
    row). Whole numbers under 2^24: bit-equal to the plain version and
    to the one-device index_add_; run twice (the last CTA's counter is
    left zeroed)."""
    from nomad_tpu_torch.ops.gang import group_capacity_plain
    from nomad_tpu_torch.parallel.mesh import make_mesh
    from nomad_tpu_torch.parallel.shard import sharded_group_capacity

    n = 9216
    units, ids = group_inputs(n, g_pad, g_pad + w)
    run = sharded_group_capacity(make_mesh(devices=["cuda"] * w), g_pad)
    cuda.reset_launch_counts()
    got = [run(units, ids).cpu() for _ in range(2)]
    assert cuda.launch_counts()["group_capacity"] == 2
    want = sharded_group_capacity(make_mesh(devices=["cpu"] * w), g_pad)(
        units, ids)
    one = group_capacity_plain(torch.from_numpy(units),
                               torch.from_numpy(ids), g_pad)
    assert torch.equal(got[0], want) and torch.equal(got[1], want)
    assert torch.equal(want, one)


@pytest.mark.parametrize("g_pad", [16, 2048, 65536])
@pytest.mark.parametrize("w", [1, 2, 4, 8, 9])
def test_sharded_group_capacity_past_2_24_on_the_card(dev, w, g_pad):
    """Past 2^24 every addition rounds: 1e9-scale addends mixed with
    small ones, so the order decides the bits. The kernel keeps the
    plain version's order (node order in a shard, shard order across),
    so it is bit-equal to it."""
    from nomad_tpu_torch.parallel.mesh import make_mesh
    from nomad_tpu_torch.parallel.shard import sharded_group_capacity

    n = 9216
    units, ids = group_inputs(n, g_pad, 7 * w + g_pad, huge=True)
    got = sharded_group_capacity(make_mesh(devices=["cuda"] * w), g_pad)(
        units, ids)
    want = sharded_group_capacity(make_mesh(devices=["cpu"] * w), g_pad)(
        units, ids)
    assert float(want.max()) > 2.0 ** 24
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("g_pad,smem_partial", [(49920, True),
                                                 (49921, False)])
def test_sharded_group_capacity_at_the_shared_memory_edge(dev, g_pad,
                                                          smem_partial):
    """At a chunk of 4,096 (shards of 2,560 nodes) the last g_pad whose
    partial fits beside the chunk in a CTA's 227 KB takes all of it, and
    the launch is taken; one more group builds the partial in its
    device-memory row. Both bit-equal to the plain version."""
    from nomad_tpu_torch.parallel import shard
    from nomad_tpu_torch.parallel.mesh import make_mesh

    n, w = 10240, 4
    units, ids = group_inputs(n, g_pad, 11)
    mesh = make_mesh(devices=["cuda"] * w)
    (ln,) = shard.group_capacity_plan(["cuda"] * w, [n // w] * w, g_pad)
    assert (ln.chunk, ln.smem_partial) == (4096, smem_partial)
    got = shard.sharded_group_capacity(mesh, g_pad)(units, ids)
    want = shard.sharded_group_capacity(make_mesh(devices=["cpu"] * w),
                                        g_pad)(units, ids)
    assert torch.equal(got.cpu(), want)


def test_sharded_group_capacity_refused_launch_raises(dev):
    """No fallback: a partial forced into shared memory past its 227 KB
    is refused by the C entry, and the wrapper raises."""
    from nomad_tpu_torch.parallel import shard

    g_pad, w = 65536, 4
    units, ids = group_inputs(1024, g_pad, 1)
    u = torch.from_numpy(units).to(dev).chunk(w)
    i = torch.from_numpy(ids).to(dev).chunk(w)
    (ln,) = shard.group_capacity_plan([x.device for x in u],
                                      [x.shape[0] for x in u], g_pad)
    assert (ln.path, ln.smem_partial) == ("combine", False)
    forced = ln._replace(smem_partial=True)
    with pytest.raises(RuntimeError, match="nt_group_capacity"):
        shard._group_capacity_cards(u, i, g_pad, [forced])


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
    """One launch for a greedy scan, an independent top-k, a group
    capacity and a base delta on the shards of one card; K x (W + 1) +
    W for a greedy scan of one eval on the per-shard route (forced);
    plain versions count nothing."""
    from nomad_tpu_torch.parallel import shard
    from nomad_tpu_torch.parallel.mesh import make_mesh

    b, n, k, w = 1, 512, 5, 4
    static, base, feasible, asks = scan_inputs(n, k, 2, b, 1, dev)
    keys = torch.zeros((b, 2), dtype=torch.int64, device=dev)
    cuda.reset_launch_counts()
    shard.sharded_greedy_scan(shard_split(static, base, feasible, asks, keys,
                                          w, False, False), 10.0)
    assert cuda.launch_counts()["sharded_greedy_scan"] == 1
    shard.sharded_greedy_scan(shard_split(static, base, feasible, asks, keys,
                                          w, False, False), 10.0,
                              force_shards=True)
    shard.sharded_greedy_scan_plain(shard_split(
        static, base, feasible, asks, keys, w, False, False, drawn=True),
        10.0)
    ua = uniform_asks(asks, b, k)
    shard.sharded_uniform_topk(shard_split(static, base, feasible, ua, keys,
                                           w, True, False), 10.0)
    mesh = make_mesh(devices=["cuda"] * w)
    shard.sharded_group_capacity(mesh, 16)(
        np.ones(n, np.float32), np.zeros(n, np.int32))
    parent, rows, vals = delta_inputs(n, 256, 1)
    shard.sharded_base_delta(mesh)(*parent, rows, *vals)
    shard.sharded_base_delta(make_mesh(devices=["cpu"] * w))(
        *parent, rows, *vals)
    counts = cuda.launch_counts()
    assert counts["sharded_greedy_scan"] == 1 + k * (w + 1) + w
    assert counts["sharded_uniform_topk"] == 1
    assert counts["group_capacity"] == 1
    assert counts["sharded_base_delta"] == 1


@pytest.mark.parametrize("w,seq,launches", [(4, False, 1), (4, True, 1),
                                            (9, False, 19), (9, True, 39)])
def test_sharded_uniform_topk_launches_per_path(dev, w, seq, launches):
    """K10d: one launch a call for the shards of one card (W <= 8);
    past a cluster's 8 CTAs the per-shard path's W + 1 launches an eval
    (seq; one of each for independent evals) and W to apply the last
    winners."""
    from nomad_tpu_torch.parallel import shard

    b, n, k = 3, 900, 5
    static, base, feasible, asks = scan_inputs(n, k, 2, b, 2, dev)
    ua = uniform_asks(asks, b, k)
    keys = torch.zeros((b, 2), dtype=torch.int64, device=dev)
    cuda.reset_launch_counts()
    shard.sharded_uniform_topk(shard_split(static, base, feasible, ua, keys,
                                           w, True, seq), 10.0, seq)
    assert cuda.launch_counts()["sharded_uniform_topk"] == launches


# ------------------------------ K10e-K10g: the last node-sharded programs


def gang_shards(state, ask, abw, aports, noise, g_pad, w, bounds=None):
    """A gang state split into w GangShards (copies), each with its
    window of the member noise and fresh carries; ``bounds`` as
    ``shard_split``'s."""
    from nomad_tpu_torch.parallel.mesh import shard_bounds
    from nomad_tpu_torch.parallel.shard import GangShard

    n = state.capacity.shape[0]
    dev = state.capacity.device
    return [GangShard(lo, gang.GangState(*(f[lo:hi].clone() for f in state)),
                      ask, abw, aports, noise[:, lo:hi].contiguous(),
                      torch.zeros(hi - lo, dtype=torch.int32, device=dev),
                      torch.zeros(g_pad, dtype=torch.float32, device=dev))
            for lo, hi in bounds or shard_bounds(n, w)]


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
    ("stacked", 2, 500, 16, 2), ("independent", 1, 10240, 8, 2),
    ("independent", 2, 1000, 1, 2), ("shared", 3, 652, 8, 2),
    ("stacked", 3, 332, 64, 3), ("independent", 1, 10240, 1024, 2)])
def test_sharded_relax_placement_matches_plain(dev, layout, b, n, k, g, w):
    """K10g-a on w shards of the card: logits, x and pref (joined in node
    order) held to RELAX_TOLS against the plain version (the float64 run
    where float32 itself drifts); one shard gives K8a's bits; a second
    run gives the same bits, and so does the shards route (a launch a
    phase a shard) on the same card."""
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
    for force in (False, True):
        again = joined_outputs(shard.sharded_relax(
            shards, convex.SOLVE_ITERS, 10.0, force_shards=force))
        for a, b_ in zip(got, again):
            assert torch.equal(a, b_), force


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
    for force in (False, True):
        again = joined_outputs(sharded_relax(shards_of(args), iters,
                                             force_shards=force))
        for a, b_ in zip(got, again):
            assert torch.equal(a, b_), force


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
    """On the shards of one card: K10g-b, K10g-a, K10f and K10e one a
    call (K10e's group sums inside its launch: no K10b); on the
    per-shard route (forced), K10g-b K x (W + 1) + W a call and K10e in
    slice mode W + 1 + K x (W + 1) + W + 1, and K10b's one; plain
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
    assert cuda.launch_counts()["sharded_convex_round"] == 1
    shard.sharded_convex_round([sh._replace(pref=o[2]) for sh, o in zip(
        shard_split(static, base, feasible, asks, keys, w, False, False),
        outs)], 10.0, force_shards=True)
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
    assert cuda.launch_counts()["sharded_gang_scan"] == 1
    assert "group_capacity" not in cuda.launch_counts()
    shard.sharded_gang_scan(gang_shards(state, ask, abw, aports, noise, 64,
                                        w), active, gnoise, cfg,
                            force_shards=True)
    shard.sharded_gang_scan_plain(gang_shards(state, ask, abw, aports, noise,
                                              64, w), active, gnoise, cfg)
    counts = cuda.launch_counts()
    assert counts["sharded_convex_round"] == 1 + k * (w + 1) + w
    assert counts["sharded_convex_relax"] == 1
    assert counts["sharded_defrag_solve"] == 1
    assert counts["sharded_gang_scan"] == 1 + w + 1 + 8 * (w + 1) + w + 1
    assert counts["group_capacity"] == 1


# ---------------------- K10c, K10g-b, K10e: one launch on one card's cluster

# (W, bounds): W equal shards of N = 1,200 (16 of 75 rows), and uneven
# shards whose rows start off 16-byte boundaries (one shorter than its
# CTAs).
CLUSTER_SHARDS = [
    (1, None), (2, None), (3, None), (4, None), (5, None), (16, None),
    (3, [(0, 333), (333, 700), (700, 1200)]),
    (5, [(0, 101), (101, 333), (333, 336), (336, 801), (801, 1200)])]
CLUSTER_IDS = ["w1", "w2", "w3", "w4", "w5", "w16", "uneven3", "uneven5"]


def scan_launches(name):
    return cuda.launch_counts().get(name, 0)


def hold_cluster_scan(dev, biased, w, bounds, layout, n=1200, b=3, k=40,
                      g=2, force=False):
    """K10c (or with ``biased`` K10g-b, fed one pref) on w shards of the
    card, each shard's rows views into the whole tensors where they are
    contiguous: choices, scores (bit for bit; K10g-b within 1e-4) and
    every shard's carry equal the plain version's, and K1's / K8b's on
    the whole node axis bit for bit; one launch a call (``force``: the
    per-shard route, K x (W + 1) + W launches an eval). Returns the
    launches of the call."""
    from nomad_tpu_torch.parallel import shard

    seq = layout == "seq"
    static, base, feasible, asks = scan_inputs(n, k, g, b, 7 * w + n, dev)
    if layout == "stacked":
        static = stacked_of(static, b, n, dev, w)
    keys = torch.arange(2 * b, device=dev).view(b, 2) + w
    pref = torch.rand((b, k, n), device=dev,
                      generator=torch.Generator(dev).manual_seed(n + w))
    kern, plain = ((shard.sharded_convex_round,
                    shard.sharded_convex_round_plain) if biased else
                   (shard.sharded_greedy_scan,
                    shard.sharded_greedy_scan_plain))
    runs, launches = [], None
    for fn, drawn in ((kern, False), (plain, not biased)):
        shards = shard_split(static, base, feasible, asks, keys, w, False,
                             seq, drawn=drawn, bounds=bounds, views=True)
        if biased:
            shards = [sh._replace(pref=pref[..., sh.lo:sh.lo + sh.feasible
                                            .shape[1]].contiguous())
                      for sh in shards]
        before = scan_launches(kern.__name__)
        extra = {"force_shards": True} if force and fn is kern else {}
        out = fn(shards, 10.0, seq, **extra)
        if fn is kern:
            launches = scan_launches(kern.__name__) - before
        runs.append((*out, join_carry(shards, seq)))
    assert_scans_agree(*runs, bits=not biased)
    c = shared_carry(base) if seq else fresh(base, b, n)
    if biased:
        noise = prng.threefry_uniform(keys, (k, n), 0.0, 2.0)
        ch, sc = convex.convex_round(*static, c, feasible, asks, noise, 10.0,
                                     pref, seq)
    else:
        ch, sc = binpack.greedy_scan(*static, c, feasible, asks,
                                     prng.Draw(keys, 2.0), 10.0, seq)
    assert torch.equal(runs[0][0], ch) and torch.equal(runs[0][1], sc)
    for name, x, y in zip(CARRY, runs[0][2], c):
        assert torch.equal(x, y), name
    assert (ch >= 0).any()
    return launches


@pytest.mark.parametrize("layout", ["independent", "seq", "stacked"])
@pytest.mark.parametrize("w,bounds", CLUSTER_SHARDS, ids=CLUSTER_IDS)
@pytest.mark.parametrize("biased", [False, True], ids=["k10c", "k10g_b"])
def test_sharded_scans_on_one_cluster(dev, biased, w, bounds, layout):
    """K10c and K10g-b on 1-16 shards of one card, equal and uneven, in
    every batch layout: one launch of K1's cluster kernel over the
    shards' segments, held against the plain version and the unsharded
    kernel."""
    assert hold_cluster_scan(dev, biased, w, bounds, layout) == 1


@pytest.mark.parametrize("seq", [False, True])
@pytest.mark.parametrize("biased", [False, True], ids=["k10c", "k10g_b"])
def test_sharded_scans_per_shard_route(dev, biased, seq):
    """Past a cluster's 16 shards of one card (17 of 24 rows) and forced
    on 4, K10c and K10g-b take the per-shard launches (K x (W + 1) + W
    an eval) and still equal the plain version and the unsharded
    kernel."""
    b, k = 2, 6
    layout = "seq" if seq else "independent"
    for w, force in ((17, False), (4, True)):
        got = hold_cluster_scan(dev, biased, w, None, layout, n=24 * 17 if
                                w == 17 else 400, b=b, k=k, force=force)
        assert got == (b if seq else 1) * k * (w + 1) + w


# (n, k_real, k, g_pad, rack, shuffle, shards): racks across the shard
# edges, singleton groups shuffled past 1,024 groups.
GANG_CLUSTER_CASES = [
    *[(1200, 12, 16, 64, 8, False, s) for s in CLUSTER_SHARDS],
    (3000, 200, 256, 1024, 3, False, (4, None)),
    (3000, 200, 256, 1024, 3, False,
     (5, [(0, 101), (101, 1333), (1333, 1336), (1336, 2801), (2801, 3000)])),
    (2400, 64, 64, 2048, 1, True, (3, None)),
    (2400, 64, 64, 2048, 1, True, (16, None))]


@pytest.mark.parametrize("mode,dh", GANG_CASES)
@pytest.mark.parametrize("n,k_real,k,g_pad,rack,shuffle,shards",
                         GANG_CLUSTER_CASES)
def test_sharded_gang_on_one_cluster(dev, mode, dh, n, k_real, k, g_pad,
                                     rack, shuffle, shards):
    """K10e on 1-16 shards of one card (equal and uneven) in every mode,
    with and without distinct_hosts: one launch of K7's cluster kernel
    over the shards' segments; choices, slice group and every shard's
    carry (util, bw_used, ports_free, placed, its copy of the member
    counts) equal the plain version's, scores within 1e-4; and K7's on
    the whole node axis bit for bit."""
    from nomad_tpu_torch.parallel import shard

    w, bounds = shards
    state, ask, abw, aports = gang_inputs(n, k_real + n + w, dev, rack=rack)
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
        parts = gang_shards(state, ask, abw, aports, noise, g_pad, w, bounds)
        before = scan_launches("sharded_gang_scan")
        runs.append((fn(parts, active, gnoise, cfg), parts))
        if fn is shard.sharded_gang_scan:
            assert scan_launches("sharded_gang_scan") == before + 1
    ((ch, sc, sg), parts), ((ch_p, sc_p, sg_p), parts_p) = runs
    assert torch.equal(ch, ch_p) and int(sg) == int(sg_p)
    assert (sc - sc_p).abs().max().item() <= 1e-4
    for a, b in zip(parts, parts_p):
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
    assert torch.equal(torch.cat([a.placed for a in parts]), placed)
    for a in parts:
        assert torch.equal(a.group_members, members)


@pytest.mark.parametrize("mode", ["slice", "spread"])
@pytest.mark.parametrize("w,bounds", [
    (2, None), (3, [(0, 333), (333, 700), (700, 1200)]),
    (5, [(0, 101), (101, 333), (333, 336), (336, 801), (801, 1200)]),
    (16, None)], ids=["w2", "uneven3", "uneven5", "w16"])
@pytest.mark.parametrize("groups", [None, False], ids=["plan", "global"])
def test_sharded_gang_on_one_cluster_sums_past_2_24(dev, mode, w, bounds,
                                                    groups, monkeypatch):
    """A zero ask gives every feasible node 1e9 units, so the group sums
    (racks of 13 across the shard edges) pass 2^24 and round: the
    cluster route sums each shard's units in node order and the
    partials in shard order, K10b's order, so the slice choice, the
    spread cap and every output equal the plain version's; with the
    sums in shared memory (the plan's) and in global memory."""
    from nomad_tpu_torch.parallel import shard

    if groups is not None:  # the counts and sums forced to global memory
        plan_for = scan.gang_plan_for
        monkeypatch.setattr(scan, "gang_plan_for", lambda *a, **kw: plan_for(
            *a, **kw, groups=groups))
    n, k, g_pad = 1200, 8, 128
    state, ask, abw, aports = gang_inputs(n, 6 + w, dev, rack=13,
                                          zero_ask=True)
    active = torch.ones(k, dtype=torch.bool, device=dev)
    cfg = gang.GangConfig(anti_affinity_penalty=10.0, mode=mode, g_pad=g_pad)
    keys = torch.tensor([[0, 3], [1, 4]], device=dev)
    noise = prng.threefry_uniform(keys[:1], (k, n), 0.0, 2.0)[0]
    gnoise = prng.threefry_uniform(keys[1:], (g_pad,), 0.0, 1.0)[0]
    runs = []
    for fn in (shard.sharded_gang_scan, shard.sharded_gang_scan_plain):
        parts = gang_shards(state, ask, abw, aports, noise, g_pad, w, bounds)
        runs.append((fn(parts, active, gnoise, cfg), parts))
    ((ch, sc, sg), parts), ((ch_p, sc_p, sg_p), parts_p) = runs
    assert torch.equal(ch, ch_p) and int(sg) == int(sg_p)
    assert (sc - sc_p).abs().max().item() <= 1e-4
    for a, b in zip(parts, parts_p):
        assert torch.equal(a.placed, b.placed)
        assert torch.equal(a.group_members, b.group_members)
        assert torch.equal(a.state.util, b.state.util)
    if mode == "slice":
        assert int(sg) >= 0


@pytest.mark.parametrize("mode", ["slice", "spread", "affinity"])
def test_sharded_gang_per_shard_route(dev, mode):
    """Past a cluster's 16 shards of one card (17 of 24 rows) and forced
    on 4, K10e takes the per-shard launches and equals the plain
    version."""
    from nomad_tpu_torch.parallel import shard

    k, g_pad = 8, 64
    for w, n, force in ((17, 24 * 17, False), (4, 400, True)):
        state, ask, abw, aports = gang_inputs(n, w, dev, rack=5)
        active = torch.ones(k, dtype=torch.bool, device=dev)
        cfg = gang.GangConfig(anti_affinity_penalty=10.0, mode=mode,
                              g_pad=g_pad)
        keys = torch.tensor([[0, 5], [1, 6]], device=dev)
        noise = prng.threefry_uniform(keys[:1], (k, n), 0.0, 2.0)[0]
        gnoise = prng.threefry_uniform(keys[1:], (g_pad,), 0.0, 1.0)[0]
        parts = gang_shards(state, ask, abw, aports, noise, g_pad, w)
        before = scan_launches("sharded_gang_scan")
        got = shard.sharded_gang_scan(parts, active, gnoise, cfg,
                                      force_shards=force)
        own = w + 1 if mode in ("slice", "spread") else 1
        assert scan_launches("sharded_gang_scan") - before == \
            own + k * (w + 1) + w + 1
        plain = gang_shards(state, ask, abw, aports, noise, g_pad, w)
        want = shard.sharded_gang_scan_plain(plain, active, gnoise, cfg)
        assert torch.equal(got[0], want[0]) and int(got[2]) == int(want[2])
        assert (got[1] - want[1]).abs().max().item() <= 1e-4
        for a, b in zip(parts, plain):
            assert torch.equal(a.placed, b.placed)
            assert torch.equal(a.group_members, b.group_members)


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
    cards) give what four shards of one card give, for K10a-K10d; K10a
    and K10b also at eight shards (two a card on four cards). Skips on
    a machine with one card."""
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
    # K10a and K10b launch once a card: one shard a card (W = 4) and two
    # (W = 8), the partial rows in shared memory (g_pad 1,152) and past
    # it (65,536), combined on the first shard's card.
    for shards in (w, 2 * w):
        out = []
        for devices in (["cuda:0"] * shards,
                        [f"cuda:{s % cards}" for s in range(shards)]):
            mesh = make_mesh(devices=devices)
            delta = shard.sharded_base_delta(mesh)(
                *place(mesh, parent, specs), rows, *vals)
            caps = [shard.sharded_group_capacity(mesh, g_pad)(units, ids)
                    .cpu() for g_pad in (1152, 65536)]
            out.append(([gather(x) for x in delta], caps))
        for x, y in zip(out[0][0], out[1][0]):
            assert torch.equal(x, y), shards
        for x, y in zip(out[0][1], out[1][1]):
            assert torch.equal(x, y), shards


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
