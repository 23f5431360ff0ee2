"""The host side of the mirror-descent solve's one launch a card
(ops/relax.py): how the nodes are cut into the kernel's tiles, the
launch table, the scratch, the grid, and which route a solve takes.
Plain functions of the shapes and devices, held here on the CPU with
the launches recorded instead of made; the kernel they drive is held on
the card (tests/test_torch_cuda.py)."""

from __future__ import annotations

import pytest
import torch

from nomad_tpu_torch.ops import cuda, relax
from nomad_tpu_torch.parallel import shard

SHAPES = [((10240,), 1, 1024), ((2560,) * 4, 1, 1024), ((10240,), 1, 8),
          ((2560,) * 4, 1, 8), ((10240,), 1, 512), ((128,), 1, 512),
          ((300,), 3, 24), ((777,), 1, 40), ((250,) * 2, 2, 16),
          ((100, 101, 99), 4, 17), ((65536,), 1, 8), ((7,) * 8, 2, 1),
          ((1000, 1, 5000), 1, 64)]


def cards(*indices):
    return [torch.device("cuda", i) for i in indices]


def row_tile(plan, t):
    """The kernel's decode of row tile t (csrc/relax.cuh
    nt_rx_row_tile): (eval, row group, segment, first node, end)."""
    pc = t % plan.pieces_total
    rest = t // plan.pieces_total
    rg, b = rest % plan.row_groups, rest // plan.row_groups
    s = 0
    while s + 1 < len(plan.nodes) and pc >= plan.piece0[s + 1]:
        s += 1
    lo = (pc - plan.piece0[s]) * plan.piece[s]
    return b, rg, s, lo, min(plan.nodes[s], lo + plan.piece[s])


def col_tile(plan, t):
    """The kernel's decode of column tile t (nt_rx_col_tile): (eval,
    segment, first node, end, first row, end)."""
    split, rest = t % plan.splits, t // plan.splits
    c, b = rest % plan.cols_total, rest // plan.cols_total
    s = 0
    while s + 1 < len(plan.nodes) and c >= plan.col0[s + 1]:
        s += 1
    lo = (c - plan.col0[s]) * relax.COL_TILE
    span = -(-plan.k // plan.splits)
    return (b, s, lo, min(plan.nodes[s], lo + relax.COL_TILE),
            split * span, min(plan.k, (split + 1) * span))


# ------------------------------------------------------------ tiles


@pytest.mark.parametrize("nodes,b,k", SHAPES)
def test_segments_cover_the_nodes_in_shard_order(nodes, b, k):
    plan = relax.relax_plan(nodes, b, k)
    assert plan.nodes == nodes
    assert plan.piece0 == tuple(sum(plan.pieces[:s])
                                for s in range(len(nodes)))
    assert plan.col0 == tuple(sum(plan.cols[:s]) for s in range(len(nodes)))
    dims = plan.dims("place", 2, 12, False, True)
    assert dims[:12] == [0, b, k, 2, 12, 0, 1, len(nodes), plan.row_groups,
                         plan.pieces_total, plan.cols_total, plan.splits]
    for s, n in enumerate(nodes):
        assert dims[12 + 5 * s:17 + 5 * s] == [
            n, plan.piece[s], plan.pieces[s], plan.piece0[s], plan.col0[s]]


@pytest.mark.parametrize("nodes,b,k", SHAPES)
def test_no_tile_straddles_a_segment(nodes, b, k):
    """Every row tile's piece and every column tile lies inside one
    segment, and each segment's tiles cover its nodes once, in order,
    for every eval and row group."""
    plan = relax.relax_plan(nodes, b, k)
    rows = {}
    for t in range(plan.row_tiles):
        e, rg, s, lo, hi = row_tile(plan, t)
        assert 0 <= lo < hi <= nodes[s]
        rows.setdefault((e, rg, s), []).append((lo, hi))
    assert len(rows) == b * plan.row_groups * len(nodes)
    for (_e, _rg, s), spans in rows.items():
        assert spans[0][0] == 0 and spans[-1][1] == nodes[s]
        assert all(a[1] == c[0] for a, c in zip(spans, spans[1:]))
    cols, rows_of = {}, {}
    for t in range(plan.col_tiles):
        e, s, lo, hi, k0, k1 = col_tile(plan, t)
        assert 0 <= lo < hi <= nodes[s]
        assert 0 <= k0 < k1 <= k  # every span has rows
        rows_of.setdefault((e, s, lo), []).append((k0, k1))
        if k0 == 0:
            cols.setdefault((e, s), []).append((lo, hi))
    assert len(cols) == b * len(nodes)
    for (_e, s), spans in cols.items():
        assert spans[0][0] == 0 and spans[-1][1] == nodes[s]
        assert all(a[1] == c[0] for a, c in zip(spans, spans[1:]))
    for spans in rows_of.values():  # a node tile's spans cover the rows
        assert len(spans) == plan.splits
        assert spans[0][0] == 0 and spans[-1][1] == k
        assert all(a[1] == c[0] for a, c in zip(spans, spans[1:]))


@pytest.mark.parametrize("nodes,b,k", SHAPES)
def test_pieces_fit_the_kernel(nodes, b, k):
    """A piece is a multiple of 32 nodes and at least PIECE_MIN; a
    segment has at most PIECES_MAX pieces, and
    the pieces share one length unless a segment outgrows it."""
    plan = relax.relax_plan(nodes, b, k)
    base = min(plan.piece)
    for n, p, q in zip(nodes, plan.piece, plan.pieces):
        assert p % 32 == 0 and p >= relax.PIECE_MIN
        assert 1 <= q <= relax.PIECES_MAX
        assert (q - 1) * p < n <= q * p
        assert p == base or -(-n // base) > relax.PIECES_MAX


@pytest.mark.parametrize("nodes,b,k", SHAPES)
def test_tile_counts_and_scratch_sizes_agree_with_the_shapes(nodes, b, k):
    plan = relax.relax_plan(nodes, b, k)
    assert plan.row_groups == -(-k // 16)
    assert plan.row_tiles == b * plan.row_groups * sum(plan.pieces)
    cols = sum(-(-n // 128) for n in nodes)
    assert plan.col_tiles == b * cols * plan.splits
    assert 1 <= plan.splits <= relax.SPLITS_MAX
    assert plan.splits == 1 or k // plan.splits >= relax.SPAN_MIN
    assert plan.counters == 1 + b * plan.row_groups + b + b * cols
    bk = b * k
    sizes = {(name, s): size for name, s, size in
             relax.scratch_bytes(plan, "place")}
    assert sizes[("res_active", -1)] == 16 * bk
    for name in ("bw_active", "ports_active", "act", "rowmax"):
        assert sizes[(name, -1)] == 4 * bk
    assert sizes[("part_m", -1)] == sizes[("part_s", -1)] \
        == 4 * plan.pieces_total * bk
    assert sizes[("stats", -1)] == 8 * bk
    assert sizes[("npart", -1)] == 8 * plan.splits * b * cols * 6 * 128
    assert sizes[("ypart", -1)] == 4 * b * plan.cols_total
    assert sizes[("ymax", -1)] == 4 * b
    for s, n in enumerate(nodes):
        assert sizes[("mask", s)] == bk * n
        assert sizes[("lin", s)] == 4 * bk * n
        assert sizes[("denom", s)] == sizes[("base_frac", s)] == 16 * b * n
        assert sizes[("terms", s)] == 24 * b * n
        for name in ("bw_denom", "base_bw_frac", "ports_denom", "y"):
            assert sizes[(name, s)] == 4 * b * n
    assert len(sizes) == 11 + 9 * len(nodes)
    given = ("mask", "lin", "denom", "res_active")
    left = {(name, s) for name, s, _ in
            relax.scratch_bytes(plan, "loop", given)}
    assert not any(name in given for name, _s in left)


def test_a_shard_plan_cuts_its_nodes_as_the_card_plan():
    whole = relax.relax_plan((2560,) * 4, 1, 8)
    for s in range(4):
        own = relax.shard_plan(whole, s)
        assert own.nodes == (2560,) and own.piece0 == (0,) \
            and own.col0 == (0,)
        assert own.piece == (whole.piece[s],)
        assert own.pieces == (whole.pieces[s],)
        assert own.cols == (whole.cols[s],)
        assert own.splits == whole.splits
    # A lone shard's own plan would cut it finer: the shards route must
    # not ask for one.
    whole = relax.relax_plan((2560,) * 4, 1, 1024)
    assert relax.relax_plan((2560,), 1, 1024).piece != (whole.piece[0],)


@pytest.mark.parametrize("nodes,b,k", [((0,), 1, 8), ((), 1, 8),
                                        ((10,), 0, 8), ((10,), 1, 0)])
def test_an_empty_solve_has_no_plan(nodes, b, k):
    with pytest.raises(ValueError, match="no solve"):
        relax.relax_plan(nodes, b, k)


# ------------------------------------------------------------ grid, route


@pytest.mark.parametrize("blocks,sms,nodes,k,want", [
    (2, 132, (10240,), 1024, 264), (1, 132, (10240,), 1024, 132),
    (2, 132, (10240,), 8, 80), (3, 132, (300,), 24, 6),
    (2, 114, (2560,) * 4, 1024, 228), (2, 132, (7,), 1, 1),
    (2, 132, (10240,), 512, 264)])
def test_the_grid_follows_from_the_occupancy(blocks, sms, nodes, k, want):
    plan = relax.relax_plan(nodes, 1, k)
    assert relax.grid_size(plan, blocks, sms) == want
    assert want <= blocks * sms


def test_no_resident_block_is_refused():
    with pytest.raises(ValueError, match="no co-resident grid"):
        relax.grid_size(relax.relax_plan((100,), 1, 8), 0, 132)


@pytest.mark.parametrize("devices,want", [
    (cards(0), "card"), (cards(0, 0, 0, 0), "card"),
    (cards(*[0] * 8), "card"), (cards(*[0] * 9), "shards"),
    (cards(0, 1), "shards"), (cards(0, 1, 0, 1), "shards"),
    (cards(1, 1), "card")])
def test_one_card_gives_one_launch_and_distinct_cards_the_shards_route(
        devices, want):
    assert relax.route(devices) == want
    w = len(devices)
    got = relax.launches(want, w, 12, "place")
    assert got == (1 if want == "card" else 4 * w + 2 + 12 * (2 * w + 1))
    assert relax.launches(want, w, 24, "defrag") == (
        1 if want == "card" else 2 * w + 1 + 24 * (2 * w + 1))


# ------------------------------------------------------------ launches


class Launches:
    """cuda.launch, stream_ptr and the occupancy recorded instead of
    made (CPU tensors stand in for a card's)."""

    def __init__(self, monkeypatch, blocks=2, sms=132):
        self.calls = []
        monkeypatch.setattr(cuda, "launch",
                            lambda name, *a: self.calls.append((name, a)))
        monkeypatch.setattr(cuda, "stream_ptr", lambda dev: 7)
        monkeypatch.setattr(relax, "occupancy",
                            lambda dev, fm: (blocks, sms))

    def solves(self):
        return [a for name, a in self.calls if name == "nt_relax_solve"]


def segments(nodes, b, k, mode="place"):
    """Segments with distinct fake input pointers (never read)."""
    segs = []
    for s, n in enumerate(nodes):
        ptrs = {name: 1000 * (s + 1) + i for i, name in enumerate(
            ("capacity", "sched", "bw_avail", "node_ok", "util", "bw_used",
             "ports_free", "job_count", "tg_count", "feasible", "logits",
             "x", "pref"))}
        if mode == "place":
            ptrs["x"] = 0  # staged in pref's buffer
        asks = {name: 100 * (s + 1) + i
                for i, name in enumerate(relax.ASK_PTRS[:8])}
        segs.append(relax.Segment(torch.device("cpu"), n, ptrs, asks))
    return segs


def unpack(args):
    fm, phase, grid, penalty, dims, ptrs, stream = args
    dims = list(dims)
    ptrs = [p or 0 for p in ptrs]
    nseg = dims[7]
    g = dict(zip(relax.ASK_PTRS + relax.CROSS_PTRS, ptrs[:24]))
    segs = [dict(zip(relax.SEG_PTRS, ptrs[24 + 22 * s:46 + 22 * s]))
            for s in range(nseg)]
    assert len(ptrs) == 24 + 22 * nseg and len(dims) == 12 + 5 * nseg
    return fm, phase, grid, penalty, dims, g, segs, stream


@pytest.mark.parametrize("nodes,b,k", [((10240,), 1, 1024),
                                       ((2560,) * 4, 1, 8),
                                       ((100, 101, 99), 4, 17)])
def test_a_card_solve_is_one_cooperative_launch(monkeypatch, nodes, b, k):
    rec = Launches(monkeypatch)
    n = relax.solve("place", b, k, 2, 12, 10.0, False, True,
                    segments(nodes, b, k))
    assert n == 1
    (args,) = rec.solves()
    fm, phase, grid, penalty, dims, g, segs, stream = unpack(args)
    plan = relax.relax_plan(nodes, b, k)
    assert (fm, phase, penalty, stream) == (0, -1, 10.0, 7)
    assert grid == relax.grid_size(plan, 2, 132)
    assert dims == plan.dims("place", 2, 12, False, True)
    # One statistics buffer read and written; the counters after the
    # barrier word; the asks are the first shard's.
    assert g["stats_in"] == g["stats_out"] != 0
    assert g["rowmax_in"] == g["rowmax_out"] != 0
    assert g["ymax_in"] == g["ymax_out"] != 0
    assert g["cnt"] == g["bar"] + 4
    assert [g[name] for name in relax.ASK_PTRS[:8]] == list(range(100, 108))
    for s, seg in enumerate(segs):
        assert seg["capacity"] == 1000 * (s + 1)
        assert seg["x"] == seg["pref"]  # x staged in pref's buffer
        for name in ("mask", "lin", "denom", "base_frac", "bw_denom",
                     "base_bw_frac", "ports_denom", "terms", "y"):
            assert seg[name] % 16 == 0 and seg[name] != 0
    scratch = sorted(p for seg in segs for p in seg.values()
                     if p and p not in range(1000, 10000))
    assert len(set(scratch)) == len(scratch)  # no two arrays share bytes


@pytest.mark.parametrize("w,mode", [(4, "place"), (2, "defrag"),
                                    (9, "place")])
def test_the_shards_route_runs_each_phase_a_shard(monkeypatch, w, mode):
    """Each phase a launch a shard, in shard order, on the shard's own
    plan cut from the card's; the statistics and maxima combined between
    phases; as many launches as ``launches`` says."""
    rec = Launches(monkeypatch)
    nodes, b, k, iters = (300,) * w, 1 if mode == "defrag" else 2, 24, 3
    n = relax.solve(mode, b, k, 2, iters, 1.0, False, False,
                    segments(nodes, b, k, mode), force_shards=w < 9)
    assert n == relax.launches("shards", w, iters, mode) == len(rec.calls)
    whole = relax.relax_plan(nodes, b, k)
    order = ["prologue", "c"] + ["a", "b", "c"] * iters + ["x"]
    if mode == "place":
        order += ["y", "m", "pref"]
    got, names = [], {v: name for name, v in relax.PHASES.items()}
    for name, args in rec.calls:
        if name == "nt_relax_combine":
            tag = "c" if args[2] == 0 else "m"
            assert args[1] == (b * k if tag == "c" else b * k + b)
            assert args[0] == w
            if not got or got[-1] != tag:
                got.append(tag)
            continue
        fm, phase, grid, _p, dims, g, segs, _st = unpack(args)
        (seg,) = segs
        s = seg["capacity"] // 1000 - 1
        plan = relax.shard_plan(whole, s)
        assert dims == plan.dims(mode, 2, iters, False, False)
        rows = names[phase] in ("prologue", "b", "x", "pref")
        assert grid == (plan.row_tiles if rows else plan.col_tiles)
        assert g["bar"] == 0 and g["cnt"] != 0
        assert g["stats_out"] != g["stats_in"]
        if not got or got[-1] != names[phase]:
            got.append(names[phase])
            shards_seen = [s]
        else:
            shards_seen.append(s)
        assert shards_seen == list(range(len(shards_seen)))
    assert got == order


def test_the_loop_only_solve_takes_the_callers_operands(monkeypatch):
    rec = Launches(monkeypatch)
    given = dict(logits=11, mask=12, lin=13, denom=14, base_frac=15,
                 bw_denom=16, base_bw_frac=17, ports_denom=18)
    asks = dict(res_active=21, bw_active=22, ports_active=23, act=24)
    seg = relax.Segment(torch.device("cpu"), 500, given, asks)
    assert relax.solve("loop", 1, 24, 0, 12, 0.0, False, False, [seg]) == 1
    fm, phase, _grid, _p, dims, g, (s,), _st = unpack(rec.solves()[0])
    assert (fm, phase, dims[0]) == (1, -1, 2)
    for name, ptr in given.items():
        assert s[name] == ptr
    for name, ptr in asks.items():
        assert g[name] == ptr
    assert s["terms"] and s["y"] and g["part_m"]
    with pytest.raises(ValueError, match="one card"):
        relax.solve("loop", 1, 24, 0, 12, 0.0, False, False, [seg, seg],
                    force_shards=True)


def test_an_empty_solve_launches_nothing(monkeypatch):
    rec = Launches(monkeypatch)
    assert relax.solve("place", 1, 0, 2, 12, 0.0, False, False,
                       segments((100,), 1, 0)) == 0
    assert rec.calls == []


def test_counters_are_kept_a_device_and_stream(monkeypatch):
    monkeypatch.setattr(relax, "_counters", {})
    a = relax.counters("cpu", 1, 10)
    assert a.dtype == torch.int32 and a.numel() == 10 and not a.any()
    assert relax.counters("cpu", 1, 8) is a
    assert relax.counters("cpu", 2, 8) is not a
    grown = relax.counters("cpu", 1, 11)
    assert grown.numel() == 20 and relax.counters("cpu", 1, 5) is grown


def test_the_launch_table_is_flat_ctypes():
    dims, ptrs = cuda.table([1, 2, 3], [0, 16, 32])
    assert list(dims) == [1, 2, 3]
    assert list(ptrs) == [None, 16, 32]


@pytest.mark.parametrize("force", [False, True])
def test_sharded_relax_on_the_cpu_is_the_plain_version(force):
    """CPU shards run the plain version whatever the route asked."""
    from nomad_tpu_torch.parallel.mesh import shard_bounds

    rng = torch.Generator().manual_seed(3)
    k, n = 6, 90
    logits0 = torch.randn((k, n), generator=rng)
    fresh = torch.tensor([True, False] * 3)
    cap = torch.full((n, 4), 1000.0)
    args = (logits0, fresh, cap * 0.3, cap, cap, torch.ones(n, dtype=bool),
            torch.full((n,), 500.0), torch.zeros(n), torch.full((n,), 8.0),
            torch.full((k, 4), 50.0), torch.zeros(k), torch.zeros(k),
            torch.ones(k, dtype=bool))
    node_dim = (1, None, 0, 0, 0, 0, 0, 0, 0, None, None, None, None)
    shards = [shard.DefragShard(lo, *(
        x if d is None else x.narrow(d, lo, hi - lo).contiguous()
        for x, d in zip(args, node_dim))) for lo, hi in shard_bounds(n, 3)]
    got = shard.sharded_relax(shards, 5, force_shards=force)
    want = shard.sharded_relax_plain(shards, 5)
    for o, r in zip(got, want):
        for x, y in zip(o, r):
            assert torch.equal(x, y)
