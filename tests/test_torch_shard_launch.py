"""The host side of K10a's and K10b's one launch a card
(parallel/shard.py): which shards each card's launch takes, K10b's path
and chunk (combined in the launch, the partial in shared or device
memory; distinct-card partials), K10a's sorted row table and the
children's one allocation a card. Plain functions of the shards'
devices, sizes and payload, so they are held here on the CPU; the
kernels they drive are held on the card (tests/test_torch_cuda.py)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from nomad_tpu_torch.ops.binpack import apply_base_delta_plain
from nomad_tpu_torch.ops.gang import group_capacity_plain
from nomad_tpu_torch.parallel import shard
from nomad_tpu_torch.parallel.mesh import gather, make_mesh
from nomad_tpu_torch.scheduler.batcher import ROW_BUCKETS, _pad_rows


def cards(*indices):
    return [torch.device("cuda", i) for i in indices]


# ------------------------------------------------------------ segments


@pytest.mark.parametrize("w", [1, 4, 8, 9])
def test_shards_of_one_card_take_one_launch(w):
    assert shard.card_segments(cards(*[0] * w)) == [
        (torch.device("cuda", 0), list(range(w)))]


@pytest.mark.parametrize("indices,want", [
    ((0, 1), [(0, [0]), (1, [1])]),
    ((0, 1, 0, 1), [(0, [0, 2]), (1, [1, 3])]),
    ((1, 1, 0, 0), [(1, [0, 1]), (0, [2, 3])]),
    ((2, 0, 1, 3), [(2, [0]), (0, [1]), (1, [2]), (3, [3])])])
def test_distinct_cards_take_one_launch_each_in_first_shard_order(
        indices, want):
    got = shard.card_segments(cards(*indices))
    assert got == [(torch.device("cuda", c), idx) for c, idx in want]


def test_a_card_holds_at_most_a_table_of_shards():
    assert len(shard.card_segments(cards(*[0] * shard.SHARD_SEGS))[0][1]) \
        == shard.SHARD_SEGS
    with pytest.raises(ValueError, match="one launch takes"):
        shard.card_segments(cards(*[0] * (shard.SHARD_SEGS + 1)))


def test_segments_read_a_generator_once():
    assert shard.card_segments(d for d in cards(0, 0, 0)) == [
        (torch.device("cuda", 0), [0, 1, 2])]


# ------------------------------------------------------------ K10b path


@pytest.mark.parametrize("w,g_pad", [(1, 256), (4, 256), (4, 10240),
                                     (8, 10240), (2, 16), (9, 256),
                                     (16, 256), (32, 2048)])
def test_one_card_takes_the_combine_path(w, g_pad):
    """Every one-card launch combines its partial rows in the launch
    (the last CTA), whatever W; the partial is in shared memory."""
    (ln,) = shard.group_capacity_plan(cards(*[0] * w), [10240 // w] * w,
                                      g_pad)
    assert (ln.path, ln.smem_partial, ln.shards) == (
        "combine", True, list(range(w)))


@pytest.mark.parametrize("rows,fits", [([2560] * 4, 49920),
                                       ([2049], 49920), ([2048], 54016),
                                       ([64], 57984)])
def test_a_partial_past_shared_memory_lives_in_its_row(rows, fits):
    """The staged chunk's ids and units (8 B a node) and the partial (4 B
    a group) share a CTA's dynamic 227 KB, all of it (the kernel has no
    static shared memory): at a chunk of 4,096 the last g_pad in shared
    memory is 49,920; one more group puts the partial in its
    device-memory row, on the same path."""
    (ln,) = shard.group_capacity_plan(cards(*[0] * len(rows)), rows, fits)
    assert (ln.path, ln.smem_partial) == ("combine", True)
    assert ln.chunk * 8 + fits * 4 == shard.GROUP_SMEM_MAX
    (ln,) = shard.group_capacity_plan(cards(*[0] * len(rows)), rows,
                                      fits + 1)
    assert (ln.path, ln.smem_partial) == ("combine", False)


@pytest.mark.parametrize("indices", [(0, 1), (0, 1, 0, 1), (1, 1, 0, 0)])
def test_distinct_cards_take_the_partials_path(indices):
    plan = shard.group_capacity_plan(cards(*indices), [640] * len(indices),
                                     10240)
    assert [ln.path for ln in plan] == ["partials"] * len(plan)
    assert sorted(s for ln in plan for s in ln.shards) == \
        list(range(len(indices)))
    assert plan[0].device == torch.device("cuda", indices[0])


@pytest.mark.parametrize("rows,chunk", [([0], 2), ([1], 2), ([2], 2),
                                        ([3], 4), ([16, 9], 16),
                                        ([2560] * 4, 4096), ([10240], 4096),
                                        ([4097], 4096)])
def test_the_chunk_covers_the_largest_shard_up_to_4096(rows, chunk):
    (ln,) = shard.group_capacity_plan(cards(*[0] * len(rows)), rows, 16)
    assert ln.chunk == chunk


@pytest.mark.parametrize("w", [1, 4, 8, 9])
def test_group_capacity_on_the_cpu_is_the_plain_shard_order_sum(w):
    """The wrapper's CPU path: each shard's plain partial, added in shard
    order; with whole numbers under 2^24 equal to the one-device sum."""
    rng = np.random.default_rng(w)
    n, g_pad = 128 * w, 64
    units = rng.integers(0, 40, n).astype(np.float32)
    ids = rng.integers(-1, g_pad + 3, n).astype(np.int32)
    got = shard.sharded_group_capacity(make_mesh(devices=["cpu"] * w),
                                       g_pad)(units, ids)
    one = group_capacity_plain(torch.from_numpy(units),
                               torch.from_numpy(ids), g_pad)
    assert torch.equal(got, one)


# ------------------------------------------------------------ K10a table


def gather_form(parents, lo, rows, order, vals):
    """The kernel's gather in PyTorch: each node looks its global row up
    in the sorted table; a match takes the payload, else the parent."""
    n = parents[0].shape[0]
    node = torch.arange(lo, lo + n, dtype=torch.int64)
    table = torch.from_numpy(rows).long()
    pos = torch.searchsorted(table, node).clamp(max=len(rows) - 1)
    hit = table[pos] == node
    src = torch.from_numpy(order).long()[pos]
    out = []
    for p, v in zip(parents, vals):
        v = torch.from_numpy(np.asarray(v))[src]
        mask = hit.view(-1, *([1] * (p.dim() - 1)))
        out.append(torch.where(mask, v, p))
    return out


def payload(rng, n, r, real, out_of_range=0):
    rows = np.full(r, 0, np.int32)
    rows[:real] = rng.choice(n, real, replace=False)
    rows[real:] = rows[0]
    vals = [rng.random((r, 4)).astype(np.float32),
            rng.random(r).astype(np.float32),
            rng.random(r).astype(np.float32), rng.random(r) < 0.5]
    for v in vals:
        v[real:] = v[0]
    if out_of_range:
        rows[1:1 + out_of_range] = np.where(
            np.arange(out_of_range) % 2 == 0, -1 - np.arange(out_of_range),
            n + np.arange(out_of_range))
    return rows, vals


@pytest.mark.parametrize("r", ROW_BUCKETS)
def test_the_row_table_sorts_the_batchers_padded_rows(r):
    """At both ROW_BUCKETS: the padded rows (``_pad_rows``: the first
    changed row repeated) sorted ascending, each with its payload index;
    duplicates keep payload order."""
    rng = np.random.default_rng(r)
    changed = rng.choice(10240, r - 37, replace=False)
    rows = _pad_rows(list(changed))
    assert len(rows) == r
    sorted_rows, order = shard.delta_row_table(rows)
    assert sorted_rows.dtype == np.int32 and order.dtype == np.int32
    assert np.all(np.diff(sorted_rows) >= 0)
    assert np.array_equal(rows[order], sorted_rows)
    first = rows[0]
    dup = order[sorted_rows == first]
    assert np.array_equal(dup, np.sort(dup)) and len(dup) == 38


def test_the_row_table_keeps_rows_outside_the_base():
    rows = np.array([7, -3, 12, 7, 99, -1], np.int32)
    sorted_rows, order = shard.delta_row_table(rows)
    assert sorted_rows.tolist() == [-3, -1, 7, 7, 12, 99]
    assert order.tolist() == [1, 5, 0, 3, 2, 4]


@pytest.mark.parametrize("r", ROW_BUCKETS)
@pytest.mark.parametrize("w", [1, 4, 9])
def test_the_gather_over_the_table_is_the_scatter(r, w):
    """The kernel's gather form over the sorted table, shard by shard,
    gives the plain scatter's children: duplicates (padding) and rows
    outside the base included."""
    rng = np.random.default_rng(r + w)
    n = 640 * w
    parent = [torch.from_numpy(x) for x in (
        rng.random((n, 4)).astype(np.float32),
        rng.random(n).astype(np.float32), rng.random(n).astype(np.float32),
        rng.random(n) < 0.5)]
    rows, vals = payload(rng, n, r, min(r - 40, n - 1), out_of_range=6)
    sorted_rows, order = shard.delta_row_table(rows)
    step = n // w
    for s in range(w):
        lo = s * step
        parts = [p[lo:lo + step] for p in parent]
        want = apply_base_delta_plain(
            *parts, torch.from_numpy(rows),
            *(torch.from_numpy(v) for v in vals), lo)
        got = gather_form(parts, lo, sorted_rows, order, vals)
        for x, y in zip(got, want):
            assert torch.equal(x, y)


# ------------------------------------------------------------ K10a children


@pytest.mark.parametrize("ns", [[1], [2560] * 4, [3, 5, 7], [640] * 9])
def test_a_cards_children_are_views_of_one_allocation(ns):
    views = shard._child_views(torch.device("cpu"), ns)
    assert [len(v) for v in views] == [len(ns)] * 4
    base = views[0][0].untyped_storage().data_ptr()
    spans = []
    for (dtype, width), arrays in zip(shard._DELTA_COLS, views):
        for n, x in zip(ns, arrays):
            assert x.dtype == dtype and x.is_contiguous()
            assert tuple(x.shape) == ((n, width) if width > 1 else (n,))
            assert x.untyped_storage().data_ptr() == base
            assert x.data_ptr() % (16 if width > 1 else x.element_size()) \
                == 0
            spans.append((x.data_ptr(), x.data_ptr() + x.nbytes))
    spans.sort()
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))


def test_the_payload_and_the_shards_are_checked_once():
    rng = np.random.default_rng(3)
    n, w = 512, 4
    parent = (rng.random((n, 4)).astype(np.float32),
              rng.random(n).astype(np.float32),
              rng.random(n).astype(np.float32), rng.random(n) < 0.5)
    rows, vals = payload(rng, n, 16, 10)
    run = shard.sharded_base_delta(make_mesh(devices=["cpu"] * w))
    with pytest.raises(ValueError, match="util_rows"):
        run(*parent, rows, vals[0][:, :3], *vals[1:])
    with pytest.raises(ValueError, match="5 arrays"):
        run(*parent, rows, *vals[:3])
    from nomad_tpu_torch.parallel.mesh import Sharded, place

    targets = place(make_mesh(devices=["cpu"] * w), parent,
                    [("nodes", None), ("nodes",), ("nodes",), ("nodes",)])
    bw = targets[1]
    wide = Sharded((tuple(p.double() for p in bw.parts[0]),), bw.lo, bw.spec)
    with pytest.raises(ValueError, match="base array 1 shard 0"):
        run(targets[0], wide, *targets[2:], rows, *vals)


@pytest.mark.parametrize("w", [1, 2, 4, 8, 9])
def test_base_delta_on_the_cpu_leaves_the_parent(w):
    """The wrapper's CPU path on W shards equals the one-device scatter
    and leaves the parent's arrays as they were."""
    from nomad_tpu_torch.parallel.mesh import place

    rng = np.random.default_rng(40 + w)
    n = 128 * w
    parent = (rng.random((n, 4)).astype(np.float32),
              rng.random(n).astype(np.float32),
              rng.random(n).astype(np.float32), rng.random(n) < 0.5)
    rows, vals = payload(rng, n, 64, 50, out_of_range=2)
    mesh = make_mesh(devices=["cpu"] * w)
    targets = place(mesh, parent, [("nodes", None), ("nodes",), ("nodes",),
                                   ("nodes",)])
    got = shard.sharded_base_delta(mesh)(*targets, rows, *vals)
    for t, p in zip(targets, parent):
        assert torch.equal(gather(t), torch.from_numpy(p))
    for j, (g, p) in enumerate(zip(got, parent)):
        want = torch.from_numpy(p.copy())
        keep = (rows >= 0) & (rows < n)
        want[torch.from_numpy(rows[keep]).long()] = torch.from_numpy(
            np.asarray(vals[j])[keep])
        assert torch.equal(gather(g), want)
