"""The host side of K6, the preemption scan, on the greedy scan's
cluster (ops/scan.py ``preempt_plan``: one eval, one cluster, its rows
and victim slots resident or streamed), and of K4, the base delta, as
one allocation and one launch (ops/binpack.py ``child_arrays``,
``launch_base_delta``). Plain functions of the shapes, held here on the
CPU with the card's occupancy given and the launches recorded instead
of made; the kernels are held on the card (tests/test_torch_cuda.py)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from nomad_tpu_torch.ops import binpack, cuda, preempt, scan

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


def preempt_total(ctas, threads, length, g, resident, staged, cache):
    """K6's layout from its parts: seven mbarriers and seven profile
    counters (112 bytes), two steps' key pairs a CTA and a warp, two
    cached scores a node, four noise stages, thirteen staged rows and
    the two slot masks a node."""
    total = 112 + 32 * (ctas + threads // 32)
    if cache:
        total += up16(8 * length)
    if staged:
        total += 4 * region(4 * length)
    if resident:
        total += sum(region(per * length) for per in scan.preempt_rows(g))
        total += up16(2 * length)
    return total


@pytest.mark.parametrize("g,bytes_", [(1, 264), (2, 269), (4, 279),
                                      (16, 339)])
def test_the_preempt_rows_a_node(g, bytes_):
    """The node rows (61 bytes) and job_count (4), tg_count and
    feasible (5 a group), the victims' footprints (192: res 128, bw 32,
    ports 32), staged; v_ok and v_prio become two one-byte masks a node
    (40 bytes a node in device memory)."""
    rows = scan.preempt_rows(g)
    assert rows == (16, 16, 16, 4, 4, 4, 1, 4, 4 * g, g, 128, 32, 32)
    assert sum(scan.PREEMPT_ROWS) == 65
    assert sum(scan.PREEMPT_VICTIM_ROWS) == 192
    assert sum(rows) + scan.PREEMPT_MASKS == bytes_


@pytest.mark.parametrize("n,g,ctas,threads,form", [
    (10240, 1, 16, 640, "resident"),     # the chip phase: one task group
    (10240, 2, 16, 640, "resident"),
    (10240, 8, 16, 640, "resident"),
    (10240, 16, 16, 640, "streamed"),    # large G
    (10000, 2, 16, 640, "resident"),
    (11000, 2, 16, 704, "resident"),
    (60000, 2, 16, 960, "streamed"),     # large N
    (400, 2, 16, 32, "resident"),
    (40, 2, 16, 32, "resident"),
    (9, 2, 8, 32, "resident"),
    (1, 2, 1, 32, "resident"),
    (0, 2, 1, 32, "resident")])
def test_the_preempt_plan(n, g, ctas, threads, form):
    """One cluster, the largest the card holds and no more CTAs than
    nodes; the rows and victim slots resident where the layout fits;
    the layout's size from its parts, aligned, in order, under 227
    KB."""
    plan = scan.preempt_plan(n, g, h100)
    assert (plan.ctas, plan.threads, plan.form) == (ctas, threads, form)
    assert plan.slice == scan.slice_len(n, plan.ctas)
    assert plan.occupancy == H100[plan.ctas]
    assert plan.smem <= scan.SMEM_MAX
    assert plan.smem == preempt_total(ctas, threads, plan.slice, g,
                                      plan.resident, plan.stage_noise,
                                      plan.cache)
    offsets, total = scan.preempt_layout(ctas, threads // 32, plan.slice, g,
                                         plan.resident, plan.stage_noise,
                                         plan.cache)
    assert total == plan.smem
    assert all(at % 16 == 0 for at in offsets.values())
    assert list(offsets.values()) == sorted(offsets.values())
    assert ("masks" in offsets) == plan.resident
    if plan.resident:
        assert plan.stage_noise and plan.cache


def test_the_chip_phase_is_resident_on_16_ctas():
    """N = 10,240 and G = 2 on 16 CTAs: 640 nodes a CTA, 267 bytes a
    node staged and 2 of masks, with the noise stages and the two-score
    cache, inside the 227 KB a CTA may take."""
    plan = scan.preempt_plan(10240, 2, h100)
    assert (plan.ctas, plan.slice, plan.resident) == (16, 640, True)
    rows = sum(region(per * 640) for per in scan.preempt_rows(2))
    assert rows == 267 * 640 + 13 * 32
    assert plan.smem == (112 + 32 * (16 + 20) + 8 * 640 + 4 * region(2560)
                         + rows + 2 * 640)
    assert plan.smem <= scan.SMEM_MAX


@pytest.mark.parametrize("ctas", [16, 8, 4, 1])
def test_the_preempt_rows_stream_where_they_do_not_fit(ctas):
    """Resident exactly where the resident layout fits; streamed past
    that, the cache and then the noise stages kept where they fit."""
    for n in (10240, 12000, 30000, 60000, 200000):
        for g in (1, 2, 16):
            length = scan.slice_len(n, ctas)
            threads = scan.threads_for(length)
            fits = preempt_total(ctas, threads, length, g, True, True,
                                 True) <= scan.SMEM_MAX
            plan = scan.preempt_plan(n, g, h100, ctas=ctas)
            assert plan.resident == fits
            if not fits:
                staged = preempt_total(ctas, threads, length, g, False, True,
                                       True) <= scan.SMEM_MAX
                cache = preempt_total(ctas, threads, length, g, False, False,
                                      True) <= scan.SMEM_MAX
                assert (plan.stage_noise, plan.cache) == (staged, cache)


def test_a_refused_preempt_plan_raises():
    with pytest.raises(RuntimeError, match="no cluster"):
        scan.preempt_plan(10240, 2, lambda c, t, m, r: 0)
    for ctas in (0, 17):
        with pytest.raises(RuntimeError, match="no cluster"):
            scan.preempt_plan(10240, 2, h100, ctas=ctas)
    with pytest.raises(RuntimeError, match="no layout"):
        scan.preempt_plan(60000, 2, h100, ctas=16, resident=True)
    with pytest.raises(RuntimeError, match="no layout"):
        scan.preempt_plan(10240, 16, h100, ctas=16, resident=True)
    for n, g in ((-1, 2), (100, 0)):
        with pytest.raises(ValueError):
            scan.preempt_plan(n, g, h100)
    plan = scan.preempt_plan(10240, 2, h100, resident=False)
    assert plan.ctas == 16 and plan.form == "streamed"
    # A smaller cluster where the card holds no 16-CTA one.
    plan = scan.preempt_plan(10240, 2, lambda c, t, m, r: int(c <= 4))
    assert plan.ctas == 4 and plan.occupancy == 1


def preempt_args(n, k, g, seed=0):
    """One eval's K6 arguments on the CPU: a crowded state, victims
    below and above the eval's priority, asks with ports."""
    rng = np.random.default_rng(seed)
    v = preempt.PREEMPT_MAX_VICTIMS
    t = torch.from_numpy
    cap = np.tile(np.array([[1000, 2000, 10000, 100]], np.float32), (n, 1))
    util = cap * 0.9
    util[: max(1, n // 40)] = 100.0  # room without eviction
    state = binpack.NodeState(
        t(cap), t(cap - 50), t(util.astype(np.float32)),
        t(np.full(n, 100, np.float32)), t(np.zeros(n, np.float32)),
        t(rng.integers(0, 3, n).astype(np.float32)),
        t(np.zeros(n, np.int32)), t(np.zeros((n, g), np.int32)),
        t(rng.random((n, g)) < 0.9), t(rng.random(n) < 0.95))
    res = np.zeros((n, v, 4), np.float32)
    res[:, :, :2] = rng.integers(1, 4, (n, v, 2)) * 100
    victims = preempt.VictimState(
        t(res), t(np.zeros((n, v), np.float32)),
        t(rng.integers(0, 2, (n, v)).astype(np.float32)),
        t(np.sort(rng.integers(5, 90, (n, v)), 1).astype(np.float32)),
        t(rng.random((n, v)) < 0.8))
    active = np.ones(k, bool)
    active[-2:] = False
    asks = binpack.Asks(
        t(np.tile(np.array([[300, 400, 0, 0]], np.float32), (k, 1))),
        t(np.zeros(k, np.float32)), t(np.ones(k, np.float32)),
        t(rng.integers(0, g, k).astype(np.int32)), t(active),
        torch.tensor(False), t(np.arange(g) == 0))
    noise = t(rng.random((k, n)).astype(np.float32) * 2)
    return state, victims, asks, noise


@pytest.mark.parametrize("n,g", [(10240, 2), (10240, 16), (300, 1)])
def test_the_preempt_launch_passes_the_entry_its_arguments(monkeypatch, n,
                                                           g):
    """One C call (nt_preempt_scan) with as many arguments as its
    signature: the shapes, the penalty and the eval's priority, the
    plan's fields in the entry's order, every tensor by pointer (the
    state in NodeState's order, the victims, the carried mask, the
    asks, the noise, the three outputs), no profile, the stream."""
    calls = []
    monkeypatch.setattr(cuda, "launch", lambda *a: calls.append(a))
    monkeypatch.setattr(cuda, "stream_ptr", lambda dev: 7)
    k = 8
    state, victims, asks, noise = preempt_args(n, k, g)
    vok = victims.ok.clone()
    plan = scan.preempt_plan(n, g, h100)
    out = scan.launch_preempt(plan, state, victims, vok, asks, noise, 70.0,
                              10.0)
    assert [o.shape for o in out] == [(k,), (k,), (k,)]
    assert [o.dtype for o in out] == [torch.int32, torch.float32,
                                      torch.int32]
    (args,) = calls
    assert args[0] == "nt_preempt_scan"
    assert len(args) - 1 == len(cuda.SIGNATURES["nt_preempt_scan"])
    assert args[1:12] == (n, g, k, 10.0, 70.0, plan.ctas, plan.threads,
                          int(plan.resident), int(plan.stage_noise),
                          int(plan.cache), plan.smem)
    tensors = (*state, *victims[:4], vok, *asks, noise, *out)
    assert args[12:12 + len(tensors)] == tuple(t.data_ptr()
                                               for t in tensors)
    assert args[-2:] == (None, 7)


def test_the_preempt_launch_passes_the_profile(monkeypatch):
    calls = []
    monkeypatch.setattr(cuda, "launch", lambda *a: calls.append(a))
    monkeypatch.setattr(cuda, "stream_ptr", lambda dev: 7)
    state, victims, asks, noise = preempt_args(100, 4, 2)
    prof = torch.zeros(len(scan.PARTS), dtype=torch.int64)
    scan.launch_preempt(scan.preempt_plan(100, 2, h100), state, victims,
                        victims.ok.clone(), asks, noise, 50.0, 5.0, prof)
    assert calls[0][-2:] == (prof.data_ptr(), 7)


def test_the_preempt_wrapper_plans_and_counts_one_launch(monkeypatch):
    """``preempt_scan`` on a card's tensors: the plan of its N and G on
    that card, one launch through ``launch_preempt`` with the eval's
    priority rounded to float32, one launch counted."""
    state, victims, asks, noise = preempt_args(200, 6, 2)
    planned, launched = [], []

    def plan_for(dev, n, g, ctas=None, resident=None):
        planned.append((str(dev), n, g))
        return scan.preempt_plan(n, g, h100)

    def launch(plan, *args):
        launched.append((plan, args))
        return "out"

    class FakeDevice:
        type = "cuda"

        def __eq__(self, other):
            return True

        def __str__(self):
            return "cuda:0"

    dev = FakeDevice()
    monkeypatch.setattr(scan, "preempt_plan_for", plan_for)
    monkeypatch.setattr(scan, "launch_preempt", launch)
    monkeypatch.setattr(preempt, "_check_preempt_args",
                        lambda *a: (200, 2, 6))
    state = state._replace(capacity=type("T", (), {"device": dev})())
    before = cuda.launch_counts().get("preempt_scan", 0)
    vok = victims.ok.clone()
    got = preempt.preempt_scan(state, victims, vok, asks, noise, 70.3, 10.0)
    assert got == "out"
    assert planned == [("cuda:0", 200, 2)]
    (plan, args), = launched
    assert plan == scan.preempt_plan(200, 2, h100)
    assert args[:5] == (state, victims, vok, asks, noise)
    assert args[5] == float(np.float32(70.3)) and args[6] == 10.0
    assert cuda.launch_counts()["preempt_scan"] == before + 1


@pytest.mark.parametrize("n,g,k,dh", [(60, 2, 12, True), (40, 1, 30, False),
                                      (300, 2, 60, True)])
def test_a_cpu_preempt_scan_is_the_plain_version(monkeypatch, n, g, k, dh):
    monkeypatch.setattr(cuda, "launch", lambda *a: pytest.fail("launched"))
    state, victims, asks, noise = preempt_args(n, k, g, seed=n + k)
    asks = asks._replace(tg_distinct_hosts=asks.tg_distinct_hosts & dh)
    runs = []
    for fn in (preempt.preempt_scan, preempt.preempt_scan_plain):
        st = state._replace(util=state.util.clone(),
                            bw_used=state.bw_used.clone(),
                            ports_free=state.ports_free.clone(),
                            job_count=state.job_count.clone(),
                            tg_count=state.tg_count.clone())
        vok = victims.ok.clone()
        runs.append((*fn(st, victims, vok, asks, noise, 50.0, 10.0), *st,
                     vok))
    for x, y in zip(*runs):
        assert torch.equal(x, y)
    assert (runs[0][2] > 0).any()  # some ask evicted


# ------------------------------------------------------------ K4


def delta_args(n, r, seed=0):
    rng = np.random.default_rng(seed)
    t = torch.from_numpy
    parent = (t(rng.random((n, 4)).astype(np.float32)),
              t(rng.random(n).astype(np.float32)),
              t(rng.random(n).astype(np.float32)), t(rng.random(n) < 0.5))
    rows = rng.integers(0, n, r).astype(np.int32)
    rows[0] = 0
    rows[-1] = n - 1
    payload = (t(rows), t(rng.random((r, 4)).astype(np.float32)),
               t(rng.random(r).astype(np.float32)),
               t(rng.random(r).astype(np.float32)), t(rng.random(r) < 0.5))
    return parent, payload


@pytest.mark.parametrize("n", [0, 1, 3, 4, 5, 511, 513, 10240, 10241])
def test_the_children_are_views_of_one_allocation(n):
    """util [n,4], bw_used, ports_free [n] f32 and node_ok [n] bool,
    each 16-byte aligned, contiguous and disjoint, in one buffer."""
    out = binpack.child_arrays("cpu", n)
    assert [tuple(x.shape) for x in out] == [(n, 4), (n,), (n,), (n,)]
    assert [x.dtype for x in out] == [torch.float32] * 3 + [torch.bool]
    assert len({x.untyped_storage().data_ptr() for x in out}) == 1
    assert all(x.is_contiguous() for x in out)
    assert all((x.data_ptr() - out[0].data_ptr()) % 16 == 0 for x in out)
    spans = sorted((x.data_ptr(), x.data_ptr() + x.nbytes) for x in out)
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    assert spans[-1][1] <= out[0].data_ptr() + \
        out[0].untyped_storage().nbytes()


@pytest.mark.parametrize("n,r", [(10240, 256), (10240, 4096), (1000, 1),
                                 (2561, 256)])
def test_the_base_delta_launch_passes_the_entry_its_arguments(monkeypatch,
                                                              n, r):
    """One C call (nt_base_delta) with as many arguments as its
    signature: N and R, the payload, the parent's four arrays and the
    children's (one allocation) by pointer, the stream."""
    calls = []
    monkeypatch.setattr(cuda, "launch", lambda *a: calls.append(a))
    monkeypatch.setattr(cuda, "stream_ptr", lambda dev: 7)
    parent, payload = delta_args(n, r)
    out = binpack.launch_base_delta(parent, payload)
    (args,) = calls
    assert args[0] == "nt_base_delta"
    assert len(args) - 1 == len(cuda.SIGNATURES["nt_base_delta"])
    assert args[1:3] == (n, r)
    assert args[3:16] == tuple(x.data_ptr()
                               for x in (*payload, *parent, *out))
    assert args[16] == 7
    assert len({x.untyped_storage().data_ptr() for x in out}) == 1


def test_the_base_delta_wrapper_counts_one_launch(monkeypatch):
    """``apply_base_delta`` on a card's tensors: the checks, one launch
    through ``launch_base_delta``, one ``base_delta`` launch counted."""
    parent, payload = delta_args(300, 20)
    launched = []
    monkeypatch.setattr(binpack, "launch_base_delta",
                        lambda *a: launched.append(a) or "children")
    monkeypatch.setattr(binpack, "_check", lambda *a: None)

    class FakeDevice:
        type = "cuda"

    util = type("T", (), {"shape": (300, 4), "device": FakeDevice()})()
    before = cuda.launch_counts().get("base_delta", 0)
    got = binpack.apply_base_delta(util, *parent[1:], *payload)
    assert got == "children"
    assert launched == [((util, *parent[1:]), payload)]
    assert cuda.launch_counts()["base_delta"] == before + 1


@pytest.mark.parametrize("n,r", [(100, 1), (1000, 256), (513, 600)])
def test_a_cpu_base_delta_is_the_plain_version(monkeypatch, n, r):
    monkeypatch.setattr(cuda, "launch", lambda *a: pytest.fail("launched"))
    parent, payload = delta_args(n, r, seed=n)
    before = [x.clone() for x in parent]
    got = binpack.apply_base_delta(*parent, *payload)
    want = binpack.apply_base_delta_plain(*parent, *payload)
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    for x, y in zip(parent, before):
        assert torch.equal(x, y)
    assert torch.equal(got[0][payload[0].long()[-1]], payload[1][-1]) or \
        (payload[0] == payload[0][-1]).sum() > 1
