"""The host side of the greedy scan's cluster launch (ops/scan.py): the
cluster a call takes from B and the card's occupancy, how the node axis
is cut into the CTAs' slices, the threads a CTA, whether the kernel
draws the noise or reads K0's, the shared-memory layout and the
resident-or-streamed form, and the launch's arguments.
Plain functions of the shapes, held here on the CPU with the card's
occupancy given and the launch recorded instead of made; the kernel
they drive is held on the card (tests/test_torch_cuda.py)."""

from __future__ import annotations

import pytest
import torch

from nomad_tpu_torch.ops import binpack, cuda, prng, scan

# Clusters of one CTA a SM an H100 holds at once, by CTAs a cluster
# (cudaOccupancyMaxActiveClusters for the scan's kernel on that card).
H100 = {1: 132, 2: 66, 4: 30, 8: 15, 16: 7}


def h100(ctas, threads, smem, resident):
    return H100[ctas] if smem <= scan.SMEM_MAX else 0


# ------------------------------------------------------------ clusters


@pytest.mark.parametrize("b,seq,want", [
    (1, False, 16), (4, True, 16), (64, True, 16), (4, False, 16),
    (7, False, 16), (8, False, 8), (15, False, 8), (16, False, 4),
    (30, False, 4), (31, False, 2), (64, False, 2), (66, False, 2),
    (67, False, 1), (132, False, 1)])
def test_the_cluster_is_the_largest_one_wave(b, seq, want):
    """The largest cluster of which the card holds one for every eval
    of the call at once (one for the batch under seq)."""
    plan = scan.scan_plan(b, 10240, 2, seq, h100)
    assert plan.ctas == want
    assert plan.waves == 1
    assert plan.clusters == (1 if seq else b)
    assert plan.occupancy == H100[want]


def test_past_one_wave_the_smallest_cluster_runs_in_waves():
    plan = scan.scan_plan(200, 10240, 2, False, h100)
    assert plan.ctas == 1 and plan.waves == 2


@pytest.mark.parametrize("n,want", [(0, 1), (1, 1), (5, 4), (9, 8),
                                    (16, 16)])
def test_no_more_ctas_than_nodes(n, want):
    assert scan.scan_plan(1, n, 2, False, h100).ctas == want


def test_a_forced_cluster_is_taken_as_it_is():
    plan = scan.scan_plan(64, 10240, 2, False, h100, ctas=4)
    assert plan.ctas == 4 and plan.waves == 3


# ------------------------------------------------------------ slices


@pytest.mark.parametrize("n", [0, 1, 5, 15, 16, 17, 1000, 10240, 10241,
                               16 * 1024 + 7])
@pytest.mark.parametrize("ctas", [1, 2, 3, 4, 8, 16])
def test_slices_cover_the_node_axis_in_order(n, ctas):
    cut = scan.slices(n, ctas)
    assert len(cut) == ctas
    nodes = [i for lo, cnt in cut for i in range(lo, lo + cnt)]
    assert nodes == list(range(n))
    sizes = [cnt for _lo, cnt in cut]
    assert max(sizes) - min(sizes) <= 1
    assert max(sizes) == scan.slice_len(n, ctas)
    if n >= ctas:
        assert min(sizes) > 0


@pytest.mark.parametrize("length", list(range(1, 4200, 37)) + [1024, 1025,
                                                               2048, 10240])
def test_every_thread_owns_as_many_nodes_as_the_fewest_threads_allow(length):
    threads = scan.threads_for(length)
    per = -(-length // threads)
    assert threads % 32 == 0 and 32 <= threads <= scan.THREADS_MAX
    assert per == -(-length // scan.THREADS_MAX)
    assert threads - 32 < -(-length // per) <= threads


# ------------------------------------------------------------ layout


def up16(b):
    return -(-b // 16) * 16


def region(b):
    """A staged region: 16-byte aligned, 32 bytes for the bulk copy's
    superset."""
    return up16(b) + 32


def layout_total(ctas, threads, length, g, resident, stage_noise, bufs,
                 cache):
    """The layout's size from its parts: eight mbarriers and seven
    profile counters (128 bytes), two steps' keys a CTA and a warp, the
    score cache, four noise stages (reading K0's noise) and the rows,
    each staged region 16-byte aligned with 32 bytes for the bulk copy's
    superset."""
    total = 128 + 16 * (ctas + threads // 32)
    if cache:
        total += up16(4 * length)
    if stage_noise:
        total += 4 * region(4 * length)
    if resident:
        total += sum(region(per * length) for per in scan.STATIC_ROWS)
        total += bufs * sum(region(per * length) for per in (4, 4 * g, g))
    return total


# At N = 10,240, one eval or one sequential cluster (the noise read from
# K0's tensor, staged): (G, CTAs, seq) -> the form and the shared memory
# a CTA, then the same launch drawing the noise in the kernel.
LAYOUTS = [
    (2, 16, False, "resident", 61952, "resident", 51584),
    (2, 8, False, "resident", 122624, "resident", 102016),
    (2, 8, True, "resident", 140640, "resident", 120032),
    (2, 4, False, "streamed", 51952, "resident", 203184),
    (2, 4, True, "streamed", 51952, "streamed", 10864),
    (2, 2, False, "streamed", 103200, "streamed", 21152),
    (2, 1, False, "streamed", 205584, "streamed", 41616),
    (64, 16, False, "streamed", 13632, "streamed", 3264),
    (64, 8, False, "streamed", 26304, "streamed", 5696),
    (64, 2, True, "streamed", 103200, "streamed", 21152),
    (64, 1, False, "streamed", 205584, "streamed", 41616)]


@pytest.mark.parametrize("g,ctas,seq,form,smem,_df,_ds", LAYOUTS)
def test_resident_where_the_rows_fit(g, ctas, seq, form, smem, _df, _ds):
    """At N = 10,240: the slice's rows in shared memory where the layout
    fits in 227 KB (two sets of an eval's rows under seq), else
    streamed with the cache and the noise staged."""
    n, b = 10240, 4 if seq else 1
    plan = scan.scan_plan(b, n, g, seq, h100, ctas=ctas)
    assert plan.form == form and plan.smem == smem <= scan.SMEM_MAX
    length = scan.slice_len(n, ctas)
    assert plan.slice == length and plan.threads == scan.threads_for(length)
    assert plan.stage_noise and not plan.drawn
    assert plan.eval_bufs == ((2 if seq else 1) if plan.resident else 0)
    assert plan.cache
    assert smem == layout_total(ctas, plan.threads, length, g,
                                plan.resident, True, plan.eval_bufs, True)
    offsets, total = scan.layout(ctas, plan.threads // 32, length, g,
                                 plan.resident, True, plan.eval_bufs, True)
    assert total == smem
    assert all(at % 16 == 0 for at in offsets.values())
    assert list(offsets.values()) == sorted(offsets.values())


@pytest.mark.parametrize("g,ctas,seq,_f,_s,form,smem", LAYOUTS)
def test_a_drawn_launch_takes_no_noise_stages(g, ctas, seq, _f, _s, form,
                                              smem):
    """The same launches drawing the noise in the kernel: no noise
    stages, which frees four staged regions of 4 bytes a node a CTA; at
    4 CTAs (G = 2, one eval) that makes the rows resident, where the
    staged layout is over 227 KB."""
    n, b = 10240, 4 if seq else 1
    plan = scan.scan_plan(b, n, g, seq, h100, ctas=ctas, drawn=True)
    assert plan.drawn and not plan.stage_noise
    assert plan.form == form and plan.smem == smem <= scan.SMEM_MAX
    offsets, total = scan.layout(ctas, plan.threads // 32, plan.slice, g,
                                 plan.resident, False, plan.eval_bufs,
                                 plan.cache)
    assert total == smem
    assert not any(name.startswith("noise") for name in offsets)
    staged = layout_total(ctas, plan.threads, plan.slice, g, plan.resident,
                          True, plan.eval_bufs, plan.cache)
    assert staged - smem == 4 * region(4 * plan.slice)
    if (g, ctas, seq) == (2, 4, False):
        assert staged > scan.SMEM_MAX and plan.resident


@pytest.mark.parametrize("b,seq,sms,drawn", [
    (1, False, 132, False), (4, True, 132, False), (64, True, 132, False),
    (4, False, 132, False), (16, False, 132, False), (31, False, 132, False),
    (17, False, 132, False), (33, False, 132, False), (34, False, 132, False),
    (35, False, 132, True), (64, False, 132, True), (132, False, 132, True),
    (200, False, 132, True), (4, False, 64, True), (64, False, 512, False)])
def test_the_noise_is_drawn_where_the_launch_covers_half_the_card(
        b, seq, sms, drawn):
    """The kernel draws the noise where the nodes a CTA hashes a step
    (its slice, on its own SM) come to at most DRAW_FACTOR times those
    K0 hashes a step on each SM (the launch's evals' N over the SMs);
    else it reads K0's tensor, which K0 draws on every SM."""
    plan = scan.scan_plan(b, 10240, 2, seq, h100, sms=sms)
    assert plan.drawn == drawn
    assert plan.drawn == (scan.slice_len(10240, plan.ctas) * sms
                          <= scan.DRAW_FACTOR * plan.clusters * 10240)
    assert plan.drawn == scan.draws(10240, plan.ctas, plan.clusters, sms)
    assert plan.stage_noise == (not drawn and plan.smem == layout_total(
        plan.ctas, plan.threads, plan.slice, 2, plan.resident, True,
        plan.eval_bufs, plan.cache))


@pytest.mark.parametrize("n,staged,cache", [(10240, True, True),
                                            (40000, False, True),
                                            (60000, False, False)])
def test_a_long_slice_keeps_the_cache_before_the_noise_stages(n, staged,
                                                              cache):
    """Streamed on one CTA, the noise read: the noise's four stages
    where they fit, the score cache where it fits, each read in place
    otherwise."""
    plan = scan.scan_plan(200, n, 2, False, h100, ctas=1, drawn=False)
    assert plan.form == "streamed"
    assert (plan.stage_noise, plan.cache) == (staged, cache)
    assert plan.smem == layout_total(1, 1024, n, 2, False, staged, 0, cache)
    assert plan.smem <= scan.SMEM_MAX


@pytest.mark.parametrize("n,cache", [(10240, True), (40000, True),
                                     (60000, False)])
def test_a_long_slice_keeps_the_score_cache_where_it_fits(n, cache):
    """Streamed on one CTA, the noise drawn: the score cache where it
    fits, the rows read in place otherwise."""
    plan = scan.scan_plan(200, n, 2, False, h100, ctas=1)
    assert plan.form == "streamed" and plan.drawn
    assert plan.cache == cache and not plan.stage_noise
    assert plan.smem == layout_total(1, 1024, n, 2, False, False, 0, cache)
    assert plan.smem <= scan.SMEM_MAX


# ------------------------------------------------------------ refusals


def test_a_refused_plan_raises():
    with pytest.raises(RuntimeError, match="no cluster"):
        scan.scan_plan(1, 10240, 2, False, lambda c, t, m, r: 0)
    for ctas in (0, 17):
        with pytest.raises(RuntimeError, match="no cluster"):
            scan.scan_plan(1, 10240, 2, False, h100, ctas=ctas)
    with pytest.raises(RuntimeError, match="resident rows"):
        scan.scan_plan(1, 10240, 64, False, h100, ctas=16, resident=True)
    with pytest.raises(ValueError):
        scan.scan_plan(0, 10240, 2, False, h100)


def test_the_streamed_form_can_be_forced():
    plan = scan.scan_plan(1, 10240, 2, False, h100, resident=False)
    assert plan.ctas == 16 and plan.form == "streamed"


# ------------------------------------------------------------ launch


@pytest.mark.parametrize("drawn", [True, False], ids=["drawn", "read"])
def test_the_launch_passes_the_entry_its_arguments(monkeypatch, drawn):
    """One C call with as many arguments as its signature, the plan's
    fields in the entry's order, and every tensor by pointer; reading
    the noise, K0's draw of the window first (its plain version here:
    the keys lie on the CPU)."""
    calls = []
    monkeypatch.setattr(cuda, "launch", lambda *a: calls.append(a))
    monkeypatch.setattr(cuda, "stream_ptr", lambda dev: 7)
    drew = []
    real = scan.threefry_uniform
    monkeypatch.setattr(scan, "threefry_uniform", lambda *a, **kw: (
        drew.append((a, kw)), real(*a, **kw))[1])
    b, n, g, k = 2, 300, 2, 5
    f32, i32 = torch.float32, torch.int32
    static = (torch.zeros(n, 4), torch.zeros(n, 4), torch.zeros(n),
              torch.zeros(n, dtype=torch.bool))
    carry = (torch.zeros(b, n, 4), torch.zeros(b, n), torch.zeros(b, n),
             torch.zeros(b, n, dtype=i32), torch.zeros(b, n, g, dtype=i32))
    asks = binpack.Asks(torch.zeros(b, k, 4), torch.zeros(b, k),
                        torch.zeros(b, k), torch.zeros(b, k, dtype=i32),
                        torch.ones(b, k, dtype=torch.bool),
                        torch.zeros(b, dtype=torch.bool),
                        torch.zeros(b, g, dtype=torch.bool))
    feasible = torch.ones(b, n, g, dtype=torch.bool)
    keys = torch.tensor([[1, 2], [3, 4]], dtype=torch.int64)
    draw = prng.Draw(keys, 2.0, 100, 1000)
    plan = scan.scan_plan(b, n, g, False, h100, drawn=drawn)
    out = scan.launch(plan, static, carry, feasible, asks, draw, 10.0,
                      False)
    assert out[0].dtype == i32 and out[1].dtype == f32
    assert out[0].shape == out[1].shape == (b, k)
    (args,) = calls
    assert args[0] == "nt_greedy_scan"
    assert len(args) - 1 == len(cuda.SIGNATURES["nt_greedy_scan"])
    assert args[1:15] == (b, n, g, k, 10.0, 0, 0, plan.ctas, plan.threads,
                          int(plan.resident), int(drawn),
                          int(plan.stage_noise), plan.eval_bufs,
                          int(plan.cache))
    assert args[15] == plan.smem
    tensors = (*static, *carry, feasible, *asks, keys)
    at = 16 + len(tensors)
    assert args[16:at] == tuple(t.data_ptr() for t in tensors)
    # The draw: its scale, total columns and window offset.
    assert args[at:at + 3] == (2.0, 1000, 100)
    if drawn:
        assert args[at + 3] is None and not drew
    else:
        ((dargs, dkw),) = drew
        assert dargs[1:] == ((k, n), 0.0, 2.0)
        assert dkw == {"window": (100, 1000)}
        assert isinstance(args[at + 3], int)
    assert args[at + 4:at + 6] == tuple(t.data_ptr() for t in out)
    assert args[-2:] == (None, 7)


def test_a_cpu_scan_is_the_plain_version(monkeypatch):
    """CPU tensors never reach the launch."""
    monkeypatch.setattr(cuda, "launch", lambda *a: pytest.fail("launched"))
    b, n, g, k = 1, 50, 1, 3
    i32 = torch.int32
    static = (torch.full((n, 4), 100.0), torch.full((n, 4), 100.0),
              torch.full((n,), 10.0), torch.ones(n, dtype=torch.bool))
    asks = binpack.Asks(torch.ones(b, k, 4), torch.zeros(b, k),
                        torch.zeros(b, k), torch.zeros(b, k, dtype=i32),
                        torch.ones(b, k, dtype=torch.bool),
                        torch.zeros(b, dtype=torch.bool),
                        torch.zeros(b, g, dtype=torch.bool))
    draw = prng.Draw(torch.tensor([[0, 7]], dtype=torch.int64), 2.0)
    runs = []
    for fn, noise in ((binpack.greedy_scan, draw),
                      (binpack.greedy_scan_plain, draw.noise((k, n)))):
        carry = (torch.zeros(b, n, 4), torch.zeros(b, n), torch.zeros(b, n),
                 torch.zeros(b, n, dtype=i32), torch.zeros(b, n, g, dtype=i32))
        runs.append(fn(*static, carry, torch.ones(b, n, g, dtype=torch.bool),
                       asks, noise, 10.0))
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])
