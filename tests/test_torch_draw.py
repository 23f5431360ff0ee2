"""The tie-break noise the port's kernels draw (K0), held on the CPU.

- K0's launch (csrc/threefry.cu, planned by ops/prng.py noise_launch):
  a model of the kernel's index arithmetic, block by block, hashes
  every element of a [B, rows, cols] draw exactly once under its
  counter r * total + lo + j, with 16-byte stores only at 16-byte
  aligned addresses; for column windows of a wider draw, more (eval,
  row) pairs than gridDim.y could hold, rows that do not start 16-byte
  aligned, and counters past 2^32.
- ``prng.Draw``, the keys and geometry the main path's scans draw from
  in their kernels: its plain values are the window of the whole draw,
  a window outside its columns is refused, and the scans' CPU route
  (``binpack.greedy_scan``, ``binpack.uniform_topk``, through them
  ``greedy_placement_program``) matches the JAX package's placement
  program eval by eval.
- K10d's shards that carry a draw instead of a drawn window give the
  plain route's result, and a draw that is not the shard's window is
  refused.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (the port on the CPU, one torch thread)
from test_torch_binpack import world

from nomad_tpu.ops import binpack as jb
from nomad_tpu_torch import carry
from nomad_tpu_torch.ops import binpack as tb
from nomad_tpu_torch.ops import prng
from nomad_tpu_torch.parallel import shard

SCORE_TOL = 1e-4

# ------------------------------------------------------------ K0's launch


def model_launch(batch, rows, cols, total, lo, out_addr=0):
    """csrc/threefry.cu's blocks, vectorised over the (eval, row)
    pairs: (flat element index, counter) of every hash a thread makes,
    and whether every 16-byte store is 16-byte aligned. ``out_addr`` is
    the output's byte address mod 16 (rows start wherever pair x cols
    floats put them)."""
    runs, threads = prng.noise_launch(cols)
    assert 32 <= threads <= prng.NOISE_THREADS and threads % 32 == 0
    assert 1 <= runs <= 65535
    assert runs * threads * prng.NOISE_PER >= cols
    pairs = np.arange(batch * rows, dtype=np.int64)  # blockIdx.x
    b, r = pairs // rows, pairs % rows
    assert (b < batch).all()
    base = r * total + lo  # once a block, 64-bit
    row_addr = out_addr + pairs * cols * 4
    mis = row_addr & 15
    head = np.minimum(cols, ((16 - mis) & 15) >> 2)
    body = (cols - head) & ~3
    tail = cols - head - body
    elems, counters = [], []
    q = np.arange(runs * threads, dtype=np.int64)  # blockIdx.y, threadIdx.x
    grid_q = np.broadcast_to(q, (len(pairs), len(q)))
    stored = 4 * grid_q < body[:, None]
    j = head[:, None] + 4 * grid_q
    aligned = bool(((row_addr[:, None] + 4 * j) % 16 == 0)[stored].all())
    for u in range(4):
        elems.append((pairs[:, None] * cols + j + u)[stored])
        counters.append((base[:, None] + j + u)[stored])
    # The scalar head and tail: threads t < head + tail of run 0.
    t = np.arange(threads, dtype=np.int64)
    scalar = t[None, :] < (head + tail)[:, None]
    e = np.where(t[None, :] < head[:, None], t[None, :],
                 body[:, None] + t[None, :])
    elems.append((pairs[:, None] * cols + e)[scalar])
    counters.append((base[:, None] + e)[scalar])
    return np.concatenate(elems), np.concatenate(counters), aligned


LAUNCHES = [  # (batch, rows, cols, total, lo, out_addr)
    (1, 1, 10240, 10240, 0, 0),        # K2's draw: one row a node
    (2, 64, 10240, 10240, 0, 0),       # K1's [K, N] draw
    (3, 5, 2561, 10244, 2561, 0),      # a shard's window, odd columns
    (2, 7, 13, 40, 27, 4),             # rows off 16-byte alignment
    (1, 9, 3, 3, 0, 8),                # rows shorter than a group
    (1, 4, 1, 1, 0, 12),               # one column
    (2, 3, 1030, 1030, 0, 4),          # a run and a second one
    (1, 70000, 16, 70000, 69984, 0),   # past 65,535 pairs and 2^32
]


@pytest.mark.parametrize("batch,rows,cols,total,lo,addr", LAUNCHES)
def test_k0_launch_hashes_every_element_once(batch, rows, cols, total, lo,
                                             addr):
    elems, counters, aligned = model_launch(batch, rows, cols, total, lo,
                                            addr)
    n = batch * rows * cols
    assert np.bincount(elems, minlength=n).tolist() == [1] * n
    order = np.argsort(elems)
    flat = np.arange(n, dtype=np.int64)
    want = (flat // cols % rows) * total + lo + flat % cols
    np.testing.assert_array_equal(counters[order], want)
    assert aligned


def test_k0_launch_counters_pass_2_32():
    """Row 69,999 of a 70,000-column draw starts past 2^32: the model's
    counters there, hashed by the plain threefry, are the plain draw's
    values (the high word of the counter is not dropped)."""
    rows, total, cols, lo = 70000, 70000, 16, 69984
    elems, counters, _ = model_launch(1, rows, cols, total, lo)
    last = elems >= (rows - 1) * cols
    assert (counters[last] >= 2**32).all()
    keys = torch.tensor([[0x12345678, 0x9abcdef0]], dtype=torch.int64)
    c = torch.from_numpy(counters[last])
    x0, x1 = prng.threefry2x32_plain(keys[0, 0], keys[0, 1], c >> 32,
                                     c & 0xFFFFFFFF)
    bits = ((x0 ^ x1) >> 9 | 0x3F800000).to(torch.int32)
    got = torch.maximum(torch.tensor(0.0),
                        ((bits.view(torch.float32) - 1.0).double() * 2.0)
                        .float())
    row = prng.threefry_uniform_plain(
        keys, (rows, cols), 0.0, 2.0, window=(lo, total))[0, -1]
    order = np.argsort(elems[last])
    assert torch.equal(got[order].view(torch.int32), row.view(torch.int32))


@pytest.mark.parametrize("cols,runs,threads", [
    (1, 1, 32), (128, 1, 32), (129, 1, 64), (1024, 1, 256),
    (1025, 2, 256), (10240, 10, 256)])
def test_k0_launch_takes_the_fewest_threads(cols, runs, threads):
    assert prng.noise_launch(cols) == (runs, threads)


# ------------------------------------------------------------ Draw


def keys_of(b, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 2**32, (b, 2), dtype=np.uint64)
                            .astype(np.int64))


@pytest.mark.parametrize("shape,lo,total", [((4, 50), 0, None),
                                            ((4, 50), 30, 90),
                                            ((70,), 10, 80)])
def test_a_draw_is_its_window_of_the_whole_draw(shape, lo, total):
    keys = keys_of(3, lo)
    draw = prng.Draw(keys, 2.0, lo, total)
    whole = prng.threefry_uniform_plain(
        keys, (*shape[:-1], total or shape[-1]), 0.0, 2.0)
    got = draw.noise(shape)
    assert torch.equal(got, whole[..., lo:lo + shape[-1]])
    assert draw.scale32 == 2.0


@pytest.mark.parametrize("lo,total", [(-1, 10), (5, 10), (0, 7)])
def test_a_draw_outside_its_columns_is_refused(lo, total):
    with pytest.raises(ValueError, match="window"):
        prng.Draw(keys_of(1, 0), 2.0, lo, total).columns(8)


def port_batch(state, asks_list, keys):
    """B evals as the port's batched tensors over one shared base."""
    s = carry.node_state_from_numpy(state, "cpu")
    asks = [carry.asks_from_numpy(a, "cpu") for a in asks_list]
    stacked = tb.Asks(*(torch.stack(x) for x in zip(*asks)))
    b = len(asks_list)
    n = s.util.shape[0]
    static = (s.capacity, s.sched_capacity, s.bw_avail, s.node_ok)
    own = tb.fresh_carry(s.util, s.bw_used, s.ports_free,
                         s.job_count.expand(b, n).contiguous(),
                         s.tg_count.expand(b, *s.tg_count.shape)
                         .contiguous(), b, False)
    feasible = s.feasible.expand(b, *s.feasible.shape).contiguous()
    return static, own, feasible, stacked, tb.keys_tensor(keys, "cpu")


@pytest.mark.parametrize("uniform", [False, True], ids=["greedy", "uniform"])
def test_the_scans_cpu_route_matches_jax_eval_by_eval(uniform):
    """K1 and K2 on CPU tensors with a Draw (the plain draw, then the
    plain scan) over 3 independent evals: each eval's choices, scores
    and claimed rows are the JAX placement program's for its own asks
    and key."""
    b, n, k = 3, 256, 48
    state, _a, _k = world(11, n, k, uniform=uniform)
    asks_list, keys = [], []
    for i in range(b):
        _s, a, key = world(100 + i, n, k, uniform=uniform)
        asks_list.append(a)
        keys.append(key)
    static, own, feas, asks, keys_t = port_batch(state, asks_list,
                                                 np.stack(keys))
    scan = tb.uniform_topk if uniform else tb.greedy_scan
    ch, sc = scan(*static, own, feas, asks, prng.Draw(keys_t, 2.0), 10.0)
    cfg = jb.PlacementConfig(anti_affinity_penalty=10.0, uniform_dh=uniform)
    for i in range(b):
        c_j, s_j, f_j = jb.placement_program_jit(state, asks_list[i],
                                                 keys[i], cfg)
        np.testing.assert_array_equal(np.asarray(c_j), ch[i].numpy())
        assert np.abs(np.asarray(s_j) - sc[i].numpy()).max() <= SCORE_TOL
        np.testing.assert_array_equal(np.asarray(f_j.util), own[0][i].numpy())
        np.testing.assert_array_equal(np.asarray(f_j.tg_count),
                                      own[4][i].numpy())
    assert (ch >= 0).any()


def test_the_uniform_top_k_takes_the_whole_draw_only():
    state, asks, key = world(3, 64, 8, uniform=True)
    static, own, feas, a, keys = port_batch(state, [asks], key[None])
    with pytest.raises(ValueError, match="whole row"):
        tb.uniform_topk(*static, own, feas, a,
                        prng.Draw(keys, 2.0, 16, 80), 10.0)


def test_greedy_placement_program_draws_no_noise_tensor(monkeypatch):
    """The program hands its scan a Draw: it calls no K0 wrapper (the
    CPU scan draws with the plain version)."""
    monkeypatch.setattr(prng, "threefry_uniform",
                        lambda *a, **kw: pytest.fail("drew a noise tensor"))
    seen = []
    real = tb.greedy_scan

    def spy(*args, **kw):
        seen.append(args[7])
        return real(*args, **kw)

    monkeypatch.setattr(tb, "greedy_scan", spy)
    state, asks, key = world(5, 128, 16)
    cfg = tb.PlacementConfig(anti_affinity_penalty=10.0)
    choices, _scores, _final = tb.placement_program(
        carry.node_state_from_numpy(state, "cpu"),
        carry.asks_from_numpy(asks, "cpu"), key, cfg)
    (draw,) = seen
    assert isinstance(draw, prng.Draw) and draw.scale == cfg.noise_scale
    want = jb.placement_program_jit(
        state, asks, key, jb.PlacementConfig(anti_affinity_penalty=10.0))
    np.testing.assert_array_equal(np.asarray(want[0]), choices.numpy())


# ------------------------------------------------------------ K10d shards


def uniform_shards(w, seed, drawn):
    """A 2-eval uniform batch over ``w`` node shards of the CPU, each
    with its noise window drawn or its Draw."""
    b, n, k = 2, 96, 8
    state, asks, _key = world(seed, n, k, uniform=True)
    keys = keys_of(b, seed)
    static, own, feas, a, _kt = port_batch(state, [asks] * b,
                                           np.zeros((b, 2), np.uint32))
    shards = []
    for s in range(w):
        lo, hi = s * n // w, (s + 1) * n // w
        cut = slice(lo, hi)
        draw = prng.Draw(keys, 2.0, lo, n)
        shards.append(shard.NodeShard(
            lo, *(x[cut].contiguous() for x in static),
            tuple(x[:, cut].contiguous() for x in own),
            feas[:, cut].contiguous(), a,
            draw.noise((hi - lo,)) if drawn else None,
            draw=None if drawn else draw))
    return shards


@pytest.mark.parametrize("w", [1, 3, 4])
def test_uniform_shards_that_carry_a_draw_match_drawn_windows(w):
    got = shard.sharded_uniform_topk(uniform_shards(w, w, False), 10.0)
    want = shard.sharded_uniform_topk(uniform_shards(w, w, True), 10.0)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert (got[0] >= 0).any()


def test_a_shard_draw_that_is_not_its_window_is_refused():
    shards = uniform_shards(2, 2, False)
    bad = shards[1]._replace(draw=shards[1].draw._replace(lo=0))
    with pytest.raises(ValueError, match="window"):
        shard.sharded_uniform_topk([shards[0], bad], 10.0)
    with pytest.raises(ValueError, match="noise window"):
        shard.sharded_uniform_topk(
            [shards[0], shards[1]._replace(draw=None)], 10.0)
