"""The port's CUDA kernels against their plain PyTorch versions, on the
card, at small shapes that reach every branch: free ports and
distinct_hosts (per task group and per job) that limit where asks fit,
inactive asks, asks past the node count, a node bucket whose top-k
sorts in global scratch, overlay rows padded with N, the sequential
(pre_resolve) and stacked batch layouts of the scans, and base deltas
with padding rows.

Marked ``cuda``; without a CUDA card every test skips. On the card's
machine, which need not have JAX (tests/conftest.py configures it):

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py -q
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from nomad_tpu_torch.ops import binpack, cuda, prng

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
