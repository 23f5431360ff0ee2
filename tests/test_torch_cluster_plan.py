"""The host side of the two scans that run on the greedy scan's cluster
besides K1 (ops/scan.py): K8b, the convex kernel's rounding scan (K1's
plan with ``bias``: the noise read, a pref stage beside each noise
stage and a strand term beside each cached score), and K7, the gang
scan (``gang_plan``: one cluster, its rows resident or streamed, the
group counts and sums in shared memory or global). Plain functions of
the shapes, held here on the CPU with the card's occupancy given and
the launches recorded instead of made; the kernels are held on the card
(tests/test_torch_cuda.py)."""

from __future__ import annotations

import pytest
import torch

from nomad_tpu_torch.kernels import convex
from nomad_tpu_torch.ops import binpack, cuda, gang, scan

# Clusters of one CTA a SM an H100 holds at once, by CTAs a cluster.
H100 = {1: 132, 2: 66, 4: 30, 8: 15, 16: 7}


def h100(ctas, threads, smem, resident):
    return H100[ctas] if smem <= scan.SMEM_MAX else 0


def up16(b):
    return -(-b // 16) * 16


def region(b):
    """A staged region: 16-byte aligned, 32 bytes for the bulk copy's
    superset."""
    return up16(b) + 32


# ------------------------------------------------------------ K8b


def round_total(ctas, threads, length, g, resident, staged, bufs, cache):
    """K8b's layout from its parts: K1's (eight mbarriers and seven
    profile counters, the keys, the cache, the noise stages, the rows)
    with a strand term beside each cached score and a pref stage beside
    each noise stage."""
    total = 128 + 16 * (ctas + threads // 32)
    if cache:
        total += up16(8 * length)
    if staged:
        total += 2 * 4 * region(4 * length)
    if resident:
        total += sum(region(per * length) for per in scan.STATIC_ROWS)
        total += bufs * sum(region(per * length) for per in (4, 4 * g, g))
    return total


@pytest.mark.parametrize("b,seq,ctas", [
    (1, False, 16), (1, True, 16), (4, True, 16), (1, False, 8),
    (1, False, 4), (3, False, 2), (64, False, 2), (1, False, 1)])
@pytest.mark.parametrize("g", [2, 64])
def test_the_round_plan_counts_the_pref_stages_and_strand_cache(b, seq, ctas,
                                                                g):
    """At N = 10,240: K8b's plan reads the noise, and its layout is K1's
    read layout plus four pref stages (4 bytes a node each) and a strand
    term a node beside the cache, each where its half is kept; the
    offsets 16-byte aligned and in order, the total under 227 KB."""
    n = 10240
    plan = scan.scan_plan(b, n, g, seq, h100, ctas=ctas, bias=True)
    assert plan.bias and not plan.drawn
    assert plan.smem <= scan.SMEM_MAX
    assert plan.smem == round_total(ctas, plan.threads, plan.slice, g,
                                    plan.resident, plan.stage_noise,
                                    plan.eval_bufs, plan.cache)
    offsets, total = scan.layout(ctas, plan.threads // 32, plan.slice, g,
                                 plan.resident, plan.stage_noise,
                                 plan.eval_bufs, plan.cache, True)
    assert total == plan.smem
    assert all(at % 16 == 0 for at in offsets.values())
    assert list(offsets.values()) == sorted(offsets.values())
    pref = [x for x in offsets if x.startswith("pref")]
    assert len(pref) == (scan.STAGES if plan.stage_noise else 0)
    # K1's read plan at the same shape takes exactly the bias's bytes
    # fewer, where both keep the same parts.
    k1 = scan.scan_plan(b, n, g, seq, h100, ctas=ctas, drawn=False)
    if (k1.resident, k1.stage_noise, k1.cache) == (
            plan.resident, plan.stage_noise, plan.cache):
        extra = (4 * region(4 * plan.slice) if plan.stage_noise else 0) + (
            up16(8 * plan.slice) - up16(4 * plan.slice) if plan.cache else 0)
        assert plan.smem - k1.smem == extra


@pytest.mark.parametrize("b,seq,g", [(1, False, 2), (1, True, 2),
                                     (4, True, 2), (2, False, 8)])
def test_the_round_plan_is_resident_where_the_bytes_fit(b, seq, g):
    """For every cluster size: resident exactly where the resident
    layout (with the pref stages and strand cache) fits in 227 KB, else
    streamed; a forced resident form that does not fit is refused."""
    n = 10240
    for ctas in (1, 2, 4, 8, 16):
        length = scan.slice_len(n, ctas)
        threads = scan.threads_for(length)
        bufs = 2 if seq and b > 1 else 1
        fits = scan.layout(ctas, threads // 32, length, g, True, True, bufs,
                           True, True)[1] <= scan.SMEM_MAX
        plan = scan.scan_plan(b, n, g, seq, h100, ctas=ctas, bias=True)
        assert plan.resident == fits
        if not fits:
            with pytest.raises(RuntimeError, match="resident rows"):
                scan.scan_plan(b, n, g, seq, h100, ctas=ctas, resident=True,
                               bias=True)


@pytest.mark.parametrize("b,n,seq,ctas,threads,form", [
    (1, 10240, False, 16, 640, "resident"),  # the 512 + 512 convex eval
    (1, 10240, True, 16, 640, "resident"),   # a storm eval, pre_resolve
    (1, 128, True, 16, 32, "resident"),      # the rig's N = 128 calls
    (1, 128, False, 16, 32, "resident"),
    (3, 300, False, 16, 32, "resident"),
    (64, 10240, False, 2, 1024, "streamed")])
def test_the_round_plans_of_the_main_path(b, n, seq, ctas, threads, form):
    """The shapes K8b takes: one cluster of 16 CTAs for one eval (and
    for the rig's 128 nodes, 8 a CTA), resident; 64 independent evals a
    cluster of 2 each, streamed."""
    plan = scan.scan_plan(b, n, 2, seq, h100, bias=True)
    assert (plan.ctas, plan.threads, plan.form) == (ctas, threads, form)
    assert plan.waves == 1 and not plan.drawn


def test_a_long_round_slice_keeps_the_cache_before_the_stages():
    """Streamed on one CTA: the stages (noise and pref) where they fit,
    then the cache (score and strand), each read in place otherwise."""
    for n, staged, cache in ((4000, True, True), (10240, False, True),
                             (25000, False, True), (30000, False, False)):
        plan = scan.scan_plan(1, n, 2, False, h100, ctas=1, bias=True)
        assert plan.form == "streamed"
        assert (plan.stage_noise, plan.cache) == (staged, cache)
        assert plan.smem == round_total(1, 1024, n, 2, False, staged, 0,
                                        cache) <= scan.SMEM_MAX


def round_args(b, n, g, k, stacked=False):
    i32 = torch.int32
    lead = (b, n) if stacked else (n,)
    static = (torch.zeros(*lead, 4), torch.zeros(*lead, 4),
              torch.zeros(*lead), torch.zeros(*lead, dtype=torch.bool))
    carry = (torch.zeros(b, n, 4), torch.zeros(b, n), torch.zeros(b, n),
             torch.zeros(b, n, dtype=i32), torch.zeros(b, n, g, dtype=i32))
    asks = binpack.Asks(torch.zeros(b, k, 4), torch.zeros(b, k),
                        torch.zeros(b, k), torch.zeros(b, k, dtype=i32),
                        torch.ones(b, k, dtype=torch.bool),
                        torch.zeros(b, dtype=torch.bool),
                        torch.zeros(b, g, dtype=torch.bool))
    feasible = torch.ones(b, n, g, dtype=torch.bool)
    return static, carry, feasible, asks


@pytest.mark.parametrize("stacked", [False, True])
def test_the_round_launch_passes_the_entry_its_arguments(monkeypatch,
                                                          stacked):
    """One C call (nt_convex_round) with as many arguments as its
    signature: the plan's fields in the entry's order, then every tensor
    by pointer, the noise and pref, the outputs, no profile, the
    stream."""
    calls = []
    monkeypatch.setattr(cuda, "launch", lambda *a: calls.append(a))
    monkeypatch.setattr(cuda, "stream_ptr", lambda dev: 7)
    b, n, g, k = 2, 300, 2, 5
    static, carry, feasible, asks = round_args(b, n, g, k, stacked)
    noise, pref = torch.zeros(b, k, n), torch.zeros(b, k, n)
    plan = scan.scan_plan(b, n, g, False, h100, bias=True)
    out = scan.launch_round(plan, static, carry, feasible, asks, noise,
                            pref, 10.0, False)
    assert out[0].dtype == torch.int32 and out[1].dtype == torch.float32
    assert out[0].shape == out[1].shape == (b, k)
    (args,) = calls
    assert args[0] == "nt_convex_round"
    assert len(args) - 1 == len(cuda.SIGNATURES["nt_convex_round"])
    assert args[1:15] == (b, n, g, k, 10.0, 0, int(stacked), plan.ctas,
                          plan.threads, int(plan.resident),
                          int(plan.stage_noise), plan.eval_bufs,
                          int(plan.cache), plan.smem)
    tensors = (*static, *carry, feasible, *asks, noise, pref, *out)
    assert args[15:15 + len(tensors)] == tuple(t.data_ptr() for t in tensors)
    assert args[-2:] == (None, 7)


def test_a_cpu_round_is_the_plain_version(monkeypatch):
    monkeypatch.setattr(cuda, "launch", lambda *a: pytest.fail("launched"))
    b, n, g, k = 1, 40, 2, 4
    static, _c, feasible, asks = round_args(b, n, g, k)
    static = (torch.full((n, 4), 100.0), torch.full((n, 4), 100.0),
              torch.full((n,), 10.0), torch.ones(n, dtype=torch.bool))
    asks = asks._replace(resources=torch.ones(b, k, 4))
    noise = torch.rand(b, k, n, generator=torch.Generator().manual_seed(1))
    pref = torch.rand(b, k, n, generator=torch.Generator().manual_seed(2))
    runs = []
    for fn in (convex.convex_round, convex.convex_round_plain):
        carry = round_args(b, n, g, k)[1]
        runs.append(fn(*static, carry, feasible, asks, noise, 10.0, pref))
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])


# ------------------------------------------------------------ K7


def gang_total(ctas, threads, length, g_pad, resident, staged, cache,
               groups, capg):
    """K7's layout from its parts: seven mbarriers, seven profile
    counters and four control words (128 bytes), two steps' keys a CTA
    and a warp, the score cache, four noise stages, eleven resident
    rows (77 bytes a node), then the group counts (and sums)."""
    total = 128 + 16 * (ctas + threads // 32)
    if cache:
        total += up16(4 * length)
    if staged:
        total += 4 * region(4 * length)
    if resident:
        total += sum(region(per * length) for per in scan.GANG_ROWS)
    if groups:
        total += up16(4 * g_pad) * (2 if capg else 1)
    return total


def test_the_gang_rows_are_77_bytes_a_node():
    assert sum(scan.GANG_ROWS) == 77 and len(scan.GANG_ROWS) == 11


@pytest.mark.parametrize("n,g_pad,capg,ctas,threads,form,groups", [
    (10240, 256, False, 16, 640, "resident", True),     # the free gang
    (10240, 1024, True, 16, 640, "resident", True),     # the ici slice
    (10240, 10240, True, 16, 640, "resident", True),    # spread, no meta
    (10240, 10240, False, 16, 640, "resident", True),   # affinity, no meta
    (10240, 65536, True, 16, 640, "resident", False),   # past the budget
    (60000, 256, True, 16, 960, "streamed", True),
    (400, 64, True, 16, 32, "resident", True),
    (40, 16, False, 16, 32, "resident", True),
    (9, 16, True, 8, 32, "resident", True),
    (0, 16, True, 1, 32, "resident", True)])
def test_the_gang_plan(n, g_pad, capg, ctas, threads, form, groups):
    """One cluster, the largest the card holds and no more CTAs than
    nodes; the rows resident and the group counts in shared memory
    where the layout fits; the layout's size from its parts, aligned,
    in order, under 227 KB."""
    plan = scan.gang_plan(n, g_pad, capg, h100)
    assert (plan.ctas, plan.threads, plan.form, plan.groups) == (
        ctas, threads, form, groups)
    assert plan.slice == scan.slice_len(n, plan.ctas)
    assert plan.occupancy == H100[plan.ctas]
    assert plan.smem <= scan.SMEM_MAX
    assert plan.smem == gang_total(ctas, threads, plan.slice, g_pad,
                                   plan.resident, plan.stage_noise,
                                   plan.cache, plan.groups, capg)
    offsets, total = scan.gang_layout(ctas, threads // 32, plan.slice, g_pad,
                                      plan.resident, plan.stage_noise,
                                      plan.cache, plan.groups, capg)
    assert total == plan.smem
    aligned = {k: v for k, v in offsets.items() if k != "ctl"}
    assert all(at % 16 == 0 for at in aligned.values())
    assert list(offsets.values()) == sorted(offsets.values())
    assert ("sums" in offsets) == (groups and capg)


@pytest.mark.parametrize("capg", [False, True])
@pytest.mark.parametrize("ctas", [16, 8])
def test_the_gang_counts_go_global_past_the_budget(capg, ctas):
    """At N = 10,240 with the rows resident: the group counts (and sums)
    stay in shared memory up to the g_pad where the layout with them
    passes 227 KB, and go to global memory (a row of counts a CTA) from
    there, the rows still resident; forcing them into shared memory past
    it with the rows is refused."""
    n = 10240
    length = scan.slice_len(n, ctas)
    threads = scan.threads_for(length)
    base = scan.gang_plan(n, 16, capg, h100, ctas=ctas)
    assert base.resident and base.stage_noise and base.cache
    room = scan.SMEM_MAX - gang_total(ctas, threads, length, 0, True, True,
                                      True, False, capg)
    edge = room // (8 if capg else 4)  # the most groups that fit
    inside = scan.gang_plan(n, edge, capg, h100, ctas=ctas)
    past = scan.gang_plan(n, edge + 4, capg, h100, ctas=ctas)
    assert inside.groups and inside.resident
    assert not past.groups and past.resident
    assert scan.gang_scratch(past, n, edge + 4, capg) == (
        edge + 4 if capg else 0, ctas * (edge + 4), n if capg else 0)
    assert scan.gang_scratch(inside, n, edge, capg) == (
        0, 0, n if capg else 0)
    with pytest.raises(RuntimeError, match="no layout"):
        scan.gang_plan(n, edge + 4, capg, h100, ctas=ctas, resident=True,
                       groups=True)


@pytest.mark.parametrize("ctas", [4, 2, 1])
def test_streamed_gang_counts_go_global_past_the_budget(ctas):
    """With the rows streamed (N = 10,240 on 1-4 CTAs): 10,240 groups
    keep their counts and sums in shared memory (the noise stages give
    way first where they must), 60,000 do not fit and go global."""
    n = 10240
    plan = scan.gang_plan(n, 10240, True, h100, ctas=ctas)
    assert not plan.resident and plan.groups and plan.cache
    big = scan.gang_plan(n, 60000, True, h100, ctas=ctas)
    assert not big.resident and not big.groups
    assert scan.gang_scratch(big, n, 60000, True) == (60000, ctas * 60000,
                                                      n)


@pytest.mark.parametrize("ctas", [16, 4, 1])
def test_the_gang_rows_stream_where_they_do_not_fit(ctas):
    """Resident exactly where the resident layout fits; streamed past
    that, the noise stages and the cache kept where they fit (the cache
    first)."""
    for n in (10240, 30000, 45000, 60000, 200000):
        length = scan.slice_len(n, ctas)
        threads = scan.threads_for(length)
        fits = gang_total(ctas, threads, length, 256, True, True, True, True,
                          True) <= scan.SMEM_MAX
        plan = scan.gang_plan(n, 256, True, h100, ctas=ctas)
        assert plan.resident == fits
        if not fits:
            assert plan.groups
            staged = gang_total(ctas, threads, length, 256, False, True,
                                True, True, True) <= scan.SMEM_MAX
            cache = gang_total(ctas, threads, length, 256, False, False,
                               True, True, True) <= scan.SMEM_MAX
            assert (plan.stage_noise, plan.cache) == (staged, cache)


def test_a_refused_gang_plan_raises():
    with pytest.raises(RuntimeError, match="no cluster"):
        scan.gang_plan(10240, 256, True, lambda c, t, m, r: 0)
    for ctas in (0, 17):
        with pytest.raises(RuntimeError, match="no cluster"):
            scan.gang_plan(10240, 256, True, h100, ctas=ctas)
    with pytest.raises(RuntimeError, match="no layout"):
        scan.gang_plan(60000, 256, True, h100, ctas=16, resident=True)
    with pytest.raises(ValueError):
        scan.gang_plan(100, 0, True, h100)
    plan = scan.gang_plan(10240, 256, True, h100, resident=False)
    assert plan.ctas == 16 and plan.form == "streamed"


def gang_args(n, k, g_pad):
    state = gang.GangState(
        torch.zeros(n, 4), torch.zeros(n, 4), torch.zeros(n, 4),
        torch.zeros(n), torch.zeros(n), torch.zeros(n),
        torch.ones(n, dtype=torch.bool), torch.zeros(n, dtype=torch.int32),
        torch.zeros(n, dtype=torch.int32),
        torch.arange(n, dtype=torch.int32) % g_pad)
    return (state, torch.ones(4), torch.tensor(0.0), torch.tensor(0.0),
            torch.ones(k, dtype=torch.bool), torch.zeros(k, n),
            torch.zeros(g_pad))


@pytest.mark.parametrize("mode,g_pad", [(0, 256), (1, 256), (2, 65536),
                                        (3, 65536)])
def test_the_gang_launch_passes_the_entry_its_arguments(monkeypatch, mode,
                                                         g_pad):
    """One C call (nt_gang_scan) with as many arguments as its
    signature: the plan's fields in the entry's order, every tensor by
    pointer, and the scratch the plan needs (the group sums in slice and
    spread mode past the budget, the CTAs' count rows past it, the
    units in slice and spread mode) carved from one allocation."""
    calls = []
    monkeypatch.setattr(cuda, "launch", lambda *a: calls.append(a))
    monkeypatch.setattr(cuda, "stream_ptr", lambda dev: 7)
    n, k = 10240, 8
    state, ask, abw, aports, active, noise, gnoise = gang_args(n, k, g_pad)
    placed = torch.zeros(n, dtype=torch.int32)
    members = torch.zeros(g_pad)
    capg = scan.sums_groups(mode)
    assert capg == (mode in (1, 2))  # slice and spread sum the groups
    plan = scan.gang_plan(n, g_pad, capg, h100)
    out = scan.launch_gang(plan, state, ask, abw, aports, active, noise,
                           gnoise, mode, True, 10.0, placed, members)
    assert [o.shape for o in out] == [(k,), (k,), ()]
    (args,) = calls
    assert args[0] == "nt_gang_scan"
    assert len(args) - 1 == len(cuda.SIGNATURES["nt_gang_scan"])
    assert args[1:14] == (n, k, g_pad, mode, 1, 10.0, plan.ctas,
                          plan.threads, int(plan.resident),
                          int(plan.stage_noise), int(plan.cache),
                          int(plan.groups), plan.smem)
    tensors = (*state, ask, abw, aports, active, noise, gnoise, placed,
               members, *out)
    at = 14 + len(tensors)
    assert args[14:at] == tuple(t.data_ptr() for t in tensors)
    sums, rows, units = args[at:at + 3]
    parts = scan.gang_scratch(plan, n, g_pad, capg)
    for ptr, size in zip((sums, rows, units), parts):
        assert (ptr is None) == (size == 0)
    assert (sums is not None) == (capg and not plan.groups)
    assert (rows is not None) == (not plan.groups)
    assert (units is not None) == capg
    assert args[-2:] == (None, 7)


def test_a_cpu_gang_scan_is_the_plain_version(monkeypatch):
    monkeypatch.setattr(cuda, "launch", lambda *a: pytest.fail("launched"))
    n, k, g_pad = 60, 4, 16
    state, ask, abw, aports, active, noise, gnoise = gang_args(n, k, g_pad)
    state = state._replace(capacity=torch.full((n, 4), 10.0),
                           sched_capacity=torch.full((n, 4), 10.0))
    noise = torch.rand(k, n, generator=torch.Generator().manual_seed(3))
    cfg = gang.GangConfig(anti_affinity_penalty=10.0, mode="spread",
                          g_pad=g_pad)
    runs = []
    for fn in (gang.gang_scan, gang.gang_scan_plain):
        st = state._replace(util=state.util.clone())
        placed = torch.zeros(n, dtype=torch.int32)
        members = torch.zeros(g_pad)
        runs.append((*fn(st, ask, abw, aports, active, noise, gnoise, cfg,
                         placed, members), placed, members))
    for x, y in zip(*runs):
        assert torch.equal(x, y)
    assert (runs[0][0] >= 0).all()
