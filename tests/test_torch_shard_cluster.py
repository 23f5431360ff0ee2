"""The one-card route of the mesh scans (parallel/shard.py): K10c, K10g-b
and K10e on the shards of one card take ONE launch of K1's or K7's
cluster kernel (csrc/greedy_scan.cu ``nt_scan_segments``,
csrc/gang_scan.cu ``nt_gang_segments``), each shard's rows their own
segment, ``scan_ctas`` CTAs a shard; shards on distinct cards, or more
than a cluster's 16, take the per-shard launches.

Held here on the CPU, as tests/test_torch_topk_layout.py and
tests/test_torch_cluster_plan.py hold theirs: the path choice, the
segment plan (ops/scan.py ``scan_plan`` / ``gang_plan`` with
``segments``) with the H100's occupancy given, the arguments each route
hands ``cuda.launch`` (recorded, not made) and the plain versions for
CPU tensors. The kernels are held on the card
(tests/test_torch_cuda.py)."""

from __future__ import annotations

import ctypes

import pytest
import torch

from nomad_tpu_torch.ops import binpack, cuda, gang, scan
from nomad_tpu_torch.parallel import shard
from nomad_tpu_torch.parallel.shard import GangShard, NodeShard, scan_ctas

# Clusters of one CTA a SM an H100 holds at once, by CTAs a cluster.
H100 = {c: 132 // c for c in range(1, 17)}


def h100(ctas, threads, smem, resident):
    return H100[ctas] if smem <= scan.SMEM_MAX else 0


def cards(*indices):
    return [torch.device("cuda", i) for i in indices]


# ------------------------------------------------------------ the route


@pytest.mark.parametrize("w", range(1, 17))
def test_shards_of_one_card_split_one_cluster(w):
    """W <= 16 shards of one card: 16 // W CTAs a shard, one cluster of
    at most 16 CTAs (W = 4: 4 CTAs a shard, K1's 16 at B = 1)."""
    cps = scan_ctas(cards(*[0] * w))
    assert cps == 16 // w
    assert 1 <= cps * w <= scan.CLUSTER_MAX


@pytest.mark.parametrize("w", [17, 32])
def test_more_shards_than_a_cluster_take_the_per_shard_route(w):
    assert scan_ctas(cards(*[0] * w)) == 0


@pytest.mark.parametrize("indices", [(0, 1), (0, 1, 2, 3), (0, 0, 1, 1),
                                     (1, 1, 1, 0)])
def test_distinct_cards_take_the_per_shard_route(indices):
    assert scan_ctas(cards(*indices)) == 0


def test_the_choice_reads_the_devices_once():
    assert scan_ctas(d for d in cards(0, 0, 0, 0)) == 4
    assert scan_ctas(iter(cards(*[2] * 16))) == 1


# ------------------------------------------------------------ the plans

# (segments, CTAs a segment): W = 1, 3, 4, 16 of N = 10,240, and uneven
# shards (one shorter than a CTA count, one empty part).
SEGMENTS = [((10240,), 16), ((3414, 3413, 3413), 5), ((2560,) * 4, 4),
            ((640,) * 16, 1), ((4000, 1000, 5240), 5), ((3, 400, 997), 5),
            ((2000, 1), 8)]


@pytest.mark.parametrize("segments,cps", SEGMENTS)
@pytest.mark.parametrize("b,seq,bias", [(1, True, False), (1, False, False),
                                        (4, True, False), (3, False, True),
                                        (1, True, True)])
def test_the_segment_plan(segments, cps, b, seq, bias):
    """K10c's and K10g-b's plan over the shards: the cluster of cps x W
    CTAs, the slices the longest of the shards' parts, the threads for
    it, the noise read, resident where the layout fits beside each
    CTA's copy of its segment's row, the layout's size as the kernel
    computes it (nt_scan_layout)."""
    w, n, g = len(segments), sum(segments), 2
    plan = scan.scan_plan(b, n, g, seq, h100, ctas=cps * w, bias=bias,
                          segments=segments)
    assert (plan.ctas, plan.segments, plan.cps) == (cps * w, w, cps)
    assert plan.slice == max(-(-x // cps) for x in segments)
    assert plan.threads == scan.threads_for(plan.slice)
    assert not plan.drawn and plan.bias == bias
    assert plan.clusters == (1 if seq else b)
    bufs = 2 if seq and b > 1 else 1
    budget = scan.SMEM_MAX - scan.SEGMENT_SMEM
    fits = scan.layout(plan.ctas, plan.threads // 32, plan.slice, g, True,
                       True, bufs, True, bias)[1] <= budget
    assert plan.resident == fits
    assert plan.smem == scan.layout(
        plan.ctas, plan.threads // 32, plan.slice, g, plan.resident,
        plan.stage_noise, plan.eval_bufs, plan.cache, bias)[1]
    assert plan.smem <= budget


def test_four_shards_take_k1s_slices_at_b_1():
    """W = 4 at N = 10,240: 16 CTAs of 640 nodes, resident, the same
    layout as K1's own plan for one eval reading the noise; one shard
    is K1's plan."""
    k1 = scan.scan_plan(1, 10240, 2, True, h100, drawn=False)
    for segments in ((2560,) * 4, (10240,)):
        plan = scan.scan_plan(1, 10240, 2, True, h100, ctas=16,
                              segments=segments)
        assert (plan.ctas, plan.threads, plan.slice, plan.resident,
                plan.smem) == (k1.ctas, k1.threads, k1.slice, k1.resident,
                               k1.smem) == (16, 640, 640, True, k1.smem)


def test_the_segment_forms_keep_room_for_their_row():
    """A layout that fits K1's 227 KB but not 227 KB less the segment
    row goes down a form on the segment route: at N = 33,776 under seq
    (two eval buffers) K1's rows stay resident, the segments' stream."""
    n, g = 33776, 2
    k1 = scan.scan_plan(2, n, g, True, h100, ctas=16, drawn=False)
    seg = scan.scan_plan(2, n, g, True, h100, ctas=16, segments=(n,))
    budget = scan.SMEM_MAX - scan.SEGMENT_SMEM
    assert budget < k1.smem <= scan.SMEM_MAX and k1.resident
    assert not seg.resident and seg.smem <= budget


def test_long_segments_stream():
    """Shards whose parts pass the resident budget stream their rows."""
    plan = scan.scan_plan(1, 120000, 2, False, h100, ctas=16,
                          segments=(60000, 60000))
    assert plan.form == "streamed" and plan.slice == 7500
    assert plan.threads == 960  # 8 nodes a thread


@pytest.mark.parametrize("segments,cps", SEGMENTS)
@pytest.mark.parametrize("g_pad,capg", [(256, False), (1024, True),
                                        (10240, True), (65536, True)])
def test_the_gang_segment_plan(segments, cps, g_pad, capg):
    """K10e's plan over the shards: K7's layout for the longest part,
    the counts (and sums) in shared memory where they fit."""
    w, n = len(segments), sum(segments)
    plan = scan.gang_plan(n, g_pad, capg, h100, ctas=cps * w,
                          segments=segments)
    assert (plan.ctas, plan.segments, plan.cps) == (cps * w, w, cps)
    assert plan.slice == max(-(-x // cps) for x in segments)
    assert plan.threads == scan.threads_for(plan.slice)
    assert plan.smem == scan.gang_layout(
        plan.ctas, plan.threads // 32, plan.slice, g_pad, plan.resident,
        plan.stage_noise, plan.cache, plan.groups, capg)[1]
    assert plan.smem <= scan.SMEM_MAX - scan.SEGMENT_SMEM
    k7 = scan.gang_plan(n, g_pad, capg, h100)
    if w == 1 and cps == 16:  # one shard is K7's plan
        assert plan._replace(segments=1) == k7


def test_a_refused_segment_plan_raises():
    with pytest.raises(RuntimeError, match="segments"):
        scan.scan_plan(1, 300, 2, False, h100, ctas=16,
                       segments=(100, 100, 100))  # 16 CTAs over 3
    with pytest.raises(RuntimeError, match="segments"):
        scan.scan_plan(1, 300, 2, False, h100, segments=(150, 150))
    with pytest.raises(RuntimeError, match="segments"):
        scan.scan_plan(1, 301, 2, False, h100, ctas=2, segments=(150, 150))
    with pytest.raises(RuntimeError, match="no cluster"):
        scan.scan_plan(1, 300, 2, False, lambda c, t, m, r: 0, ctas=2,
                       segments=(150, 150))
    with pytest.raises(RuntimeError, match="segments"):
        scan.gang_plan(300, 16, True, h100, ctas=17,
                       segments=(100,) * 17)
    with pytest.raises(RuntimeError, match="no cluster"):
        scan.gang_plan(300, 16, True, lambda c, t, m, r: 0, ctas=3,
                       segments=(100,) * 3)


# ------------------------------------------------------------ the launches


def node_shards(sizes, b, k, g, seq=False, stacked=False, biased=False):
    """CPU NodeShards of ``sizes`` rows, from seeded values."""
    gen = torch.Generator().manual_seed(sum(sizes) + b)
    rnd = lambda *s: torch.rand(*s, generator=gen)  # noqa: E731
    i32 = torch.int32
    asks = binpack.Asks(rnd(b, k, 4) * 50, rnd(b, k), rnd(b, k),
                        torch.zeros(b, k, dtype=i32),
                        torch.ones(b, k, dtype=torch.bool),
                        torch.zeros(b, dtype=torch.bool),
                        torch.zeros(b, g, dtype=torch.bool))
    out, lo = [], 0
    for n in sizes:
        lead = (b, n) if stacked else (n,)
        own = (n,) if seq else (b, n)
        cap = torch.full((*lead, 4), 1000.0)
        carry = (rnd(*own, 4) * 100, rnd(*own), torch.full(own, 5.0),
                 torch.zeros(b, n, dtype=i32), torch.zeros(b, n, g, dtype=i32))
        out.append(NodeShard(
            lo, cap, cap.clone(), torch.full(lead, 10.0),
            torch.ones(lead, dtype=torch.bool), carry,
            torch.ones(b, n, g, dtype=torch.bool), asks, rnd(b, k, n),
            pref=rnd(b, k, n) if biased else None))
        lo += n
    return out


@pytest.fixture
def recorded(monkeypatch):
    """cuda.launch recorded instead of made, the routes' plans on the
    H100's occupancy, the CPU shards taken for the card's."""
    calls = []
    monkeypatch.setattr(cuda, "launch", lambda *a: calls.append(a))
    monkeypatch.setattr(cuda, "stream_ptr", lambda dev: 7)
    monkeypatch.setattr(shard, "_kind", lambda tensors: "cuda")
    monkeypatch.setattr(scan, "plan_for", lambda dev, b, n, g, seq, **kw: (
        scan.scan_plan(b, n, g, seq, h100, **kw)))
    monkeypatch.setattr(scan, "gang_plan_for", lambda dev, n, g_pad, mode,
                        **kw: scan.gang_plan(n, g_pad, scan.sums_groups(mode),
                                             h100, **kw))
    cuda.reset_launch_counts()
    return calls


@pytest.mark.parametrize("sizes", [(40,), (40, 25, 35), (10,) * 16])
@pytest.mark.parametrize("seq,stacked", [(False, False), (True, False),
                                         (False, True)])
@pytest.mark.parametrize("biased", [False, True])
def test_the_scan_route_passes_the_segments(recorded, sizes, seq, stacked,
                                            biased):
    """K10c / K10g-b on W shards of one card: ONE call of
    nt_scan_segments (its signature's length), the batch and the
    segment plan's fields in the entry's order, the segment table in
    shard order (each shard's global lo and rows, then its twelve row
    pointers: ten rows, the noise window, the pref columns or none),
    the asks, the outputs and the stream; one launch counted."""
    b, k, g, w = 2, 3, 2, len(sizes)
    shards = node_shards(sizes, b, k, g, seq, stacked, biased)
    fn = shard.sharded_convex_round if biased else shard.sharded_greedy_scan
    name = fn.__name__
    out = fn(shards, 10.0, seq)
    (args,) = recorded
    assert args[0] == "nt_scan_segments"
    assert len(args) - 1 == len(cuda.SIGNATURES["nt_scan_segments"])
    cps = 16 // w
    plan = scan.scan_plan(b, sum(sizes), g, seq, h100, ctas=cps * w,
                          bias=biased, segments=sizes)
    assert args[1:16] == (b, g, k, w, cps, 10.0, int(seq), int(stacked),
                          int(biased), plan.threads, int(plan.resident),
                          int(plan.stage_noise), plan.eval_bufs,
                          int(plan.cache), plan.smem)
    dims, ptrs = args[16], args[17]
    assert isinstance(dims, ctypes.Array) and isinstance(ptrs, ctypes.Array)
    assert list(dims) == [x for sh in shards
                          for x in (sh.lo, sh.feasible.shape[1])]
    want = []
    for sh in shards:
        rows = (sh.capacity, sh.sched_capacity, sh.bw_avail, sh.node_ok,
                *sh.carry, sh.feasible, sh.noise)
        want += [t.data_ptr() for t in rows]
        want.append(sh.pref.data_ptr() if biased else None)
    assert list(ptrs) == want
    asks = shards[0].asks
    assert args[18:25] == tuple(t.data_ptr() for t in asks)
    assert args[25:27] == tuple(t.data_ptr() for t in out)
    assert args[27] == 7
    assert [o.shape for o in out] == [(b, k), (b, k)]
    assert cuda.launch_counts() == {name: 1}


@pytest.mark.parametrize("biased", [False, True])
def test_past_a_cluster_or_forced_the_scans_take_the_per_shard_route(
        monkeypatch, recorded, biased):
    """17 shards of one card, or ``force_shards``, go to the per-shard
    host loop (recorded here) and never to the cluster's entry."""
    seen = []
    monkeypatch.setattr(shard, "_steps_on_card", lambda *a: seen.append(a))
    fn = shard.sharded_convex_round if biased else shard.sharded_greedy_scan
    fn(node_shards((3,) * 17, 1, 2, 2, biased=biased), 10.0)
    fn(node_shards((20, 20), 1, 2, 2, biased=biased), 10.0,
       force_shards=True)
    assert len(seen) == 2 and not recorded
    assert [a[4] for a in seen] == [biased, biased]  # the bias passed on


def gang_shards(sizes, k, g_pad):
    """CPU GangShards of ``sizes`` rows (racks of 3), their own noise
    windows, placed and member counts."""
    gen = torch.Generator().manual_seed(len(sizes) + k)
    out, lo = [], 0
    for n in sizes:
        st = gang.GangState(
            torch.full((n, 4), 100.0), torch.full((n, 4), 100.0),
            torch.rand(n, 4, generator=gen) * 50, torch.full((n,), 10.0),
            torch.zeros(n), torch.full((n,), 4.0),
            torch.ones(n, dtype=torch.bool),
            torch.zeros(n, dtype=torch.int32),
            torch.zeros(n, dtype=torch.int32),
            ((torch.arange(n) + lo) // 3).to(torch.int32))
        out.append(GangShard(lo, st, torch.ones(4), torch.tensor(0.0),
                             torch.tensor(0.0),
                             torch.rand(k, n, generator=gen),
                             torch.zeros(n, dtype=torch.int32),
                             torch.zeros(g_pad)))
        lo += n
    return out


@pytest.mark.parametrize("sizes", [(30,), (30, 12, 21), (6,) * 16])
@pytest.mark.parametrize("mode,g_pad", [("free", 64), ("slice", 64),
                                        ("spread", 65536),
                                        ("affinity", 65536)])
def test_the_gang_route_passes_the_segments(recorded, sizes, mode, g_pad):
    """K10e on W shards of one card: ONE call of nt_gang_segments, the
    gang and the segment plan's fields, the segment table in shard
    order (lo and rows, then thirteen pointers: the GangState's ten
    rows, the noise window, placed, the member counts), the ask, the
    outputs, K7's scratch and, in slice and spread mode over several
    shards, the walk's partial; one launch counted."""
    k, w = 5, len(sizes)
    shards = gang_shards(sizes, k, g_pad)
    active = torch.ones(k, dtype=torch.bool)
    gnoise = torch.zeros(g_pad)
    cfg = gang.GangConfig(anti_affinity_penalty=10.0, mode=mode,
                          distinct_hosts=True, g_pad=g_pad)
    out = shard.sharded_gang_scan(shards, active, gnoise, cfg)
    (args,) = recorded
    assert args[0] == "nt_gang_segments"
    assert len(args) - 1 == len(cuda.SIGNATURES["nt_gang_segments"])
    mode_id = gang._MODE_IDS[mode]
    capg = scan.sums_groups(mode_id)
    cps, n = 16 // w, sum(sizes)
    plan = scan.gang_plan(n, g_pad, capg, h100, ctas=cps * w,
                          segments=sizes)
    assert args[1:14] == (k, g_pad, mode_id, 1, 10.0, w, cps, plan.threads,
                          int(plan.resident), int(plan.stage_noise),
                          int(plan.cache), int(plan.groups), plan.smem)
    assert list(args[14]) == [x for sh in shards
                              for x in (sh.lo, sh.state.capacity.shape[0])]
    assert list(args[15]) == [
        t.data_ptr() for sh in shards
        for t in (*sh.state, sh.noise, sh.placed, sh.group_members)]
    first = shards[0]
    assert args[16:21] == tuple(t.data_ptr() for t in (
        first.ask_res, first.ask_bw, first.ask_ports, active, gnoise))
    assert args[21:24] == tuple(t.data_ptr() for t in out)
    sums, rows, units, walk = args[24:28]
    assert (sums is not None) == (capg and not plan.groups)
    assert (rows is not None) == (not plan.groups)
    assert (units is not None) == capg
    assert (walk is not None) == (capg and w > 1)
    assert args[28] == 7
    assert cuda.launch_counts() == {"sharded_gang_scan": 1}


def test_past_a_cluster_the_gang_takes_the_per_shard_route(monkeypatch,
                                                           recorded):
    """17 shards of one card, or ``force_shards``, run the per-shard
    launches (csrc/sharded_gang.cu's entries, recorded) and never the
    cluster's entry."""
    libs = []

    class Lib:
        def __getattr__(self, name):
            libs.append(name)
            return lambda *a: 0

    monkeypatch.setattr(cuda, "library", Lib)
    monkeypatch.setattr(shard, "_on", lambda dev: __import__(
        "contextlib").nullcontext())
    active = torch.ones(2, dtype=torch.bool)
    cfg = gang.GangConfig(anti_affinity_penalty=10.0, mode="free", g_pad=8)
    for sizes, force in (((3,) * 17, False), ((10, 10), True)):
        shard.sharded_gang_scan(gang_shards(sizes, 2, 8), active,
                                torch.zeros(8), cfg, force_shards=force)
    assert not recorded
    assert "nt_gang_step" in libs and "nt_gang_segments" not in libs
    w = (17, 2)
    assert cuda.launch_counts()["sharded_gang_scan"] == sum(
        1 + 2 * (x + 1) + x + 1 for x in w)


# ------------------------------------------------------------ the CPU


@pytest.mark.parametrize("sizes", [(30,), (30, 12, 21), (3,) * 17])
@pytest.mark.parametrize("seq", [False, True])
def test_cpu_shards_run_the_plain_scans(monkeypatch, sizes, seq):
    """CPU tensors take the plain versions on any shard count and with
    ``force_shards``: the same choices, scores and carries, no launch."""
    monkeypatch.setattr(cuda, "launch", lambda *a: pytest.fail("launched"))
    monkeypatch.setattr(cuda, "library", lambda: pytest.fail("built"))
    for biased, fn, plain in (
            (False, shard.sharded_greedy_scan,
             shard.sharded_greedy_scan_plain),
            (True, shard.sharded_convex_round,
             shard.sharded_convex_round_plain)):
        runs = []
        for call in (lambda s: fn(s, 10.0, seq),
                     lambda s: fn(s, 10.0, seq, force_shards=True),
                     lambda s: plain(s, 10.0, seq)):
            shards = node_shards(sizes, 2, 3, 2, seq, biased=biased)
            runs.append((*call(shards), *[c for sh in shards
                                          for c in sh.carry]))
        for run in runs[:2]:
            for x, y in zip(run, runs[2]):
                assert torch.equal(x, y)
        assert (runs[0][0] >= 0).any()


@pytest.mark.parametrize("sizes", [(30,), (30, 12, 21), (3,) * 17])
@pytest.mark.parametrize("mode", ["free", "slice", "spread", "affinity"])
def test_cpu_shards_run_the_plain_gang(monkeypatch, sizes, mode):
    monkeypatch.setattr(cuda, "launch", lambda *a: pytest.fail("launched"))
    monkeypatch.setattr(cuda, "library", lambda: pytest.fail("built"))
    active = torch.ones(4, dtype=torch.bool)
    cfg = gang.GangConfig(anti_affinity_penalty=10.0, mode=mode, g_pad=32)
    runs = []
    for call in (shard.sharded_gang_scan, shard.sharded_gang_scan_plain):
        shards = gang_shards(sizes, 4, 32)
        runs.append((*call(shards, active, torch.zeros(32), cfg),
                     *[t for sh in shards for t in (
                         sh.placed, sh.group_members, sh.state.util)]))
    for x, y in zip(*runs):
        assert torch.equal(x, y)
    assert (runs[0][0] >= 0).all()
