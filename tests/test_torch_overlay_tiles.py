"""K3's tiled expansion (csrc/expand_overlay.cu), held on the CPU.

The kernel is a grid over (node tile, eval, task-group window): a CTA
gathers its tile's verdict rows (all task groups, or past G = 306 a
window of them) into shared memory, zeroes its counts, walks the eval's
patch rows and job positions applying those that land in its tile and
window (after the shard's -lo rebase), and writes its tile once, the
job counts from the first window's CTAs. ``tiled`` runs that
arithmetic tile by tile in Python; on seeded random overlays
it must equal ``binpack.expand_overlay_plain`` and the JAX package's
``_expand_overlay``, with class ids of -1 and past the C classes, the
pad row N, rows of other shards under ``lo`` and several allocs of one
job on one node. The kernel writes a patch row without ordering
against another patch of the same row, so the patch rows the matrix
builds must be distinct, with pads that drop: held on a real build.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (the port on the CPU, one torch thread)
from torch_parity import build_reference_cluster, carry_over, two_group_job

from nomad_tpu.ops import binpack as jb
from nomad_tpu.structs import Constraint
from nomad_tpu_torch import carry
from nomad_tpu_torch.models.matrix import ClusterMatrix as PortMatrix
from nomad_tpu_torch.ops import binpack as tb


def tiled(class_ids, ov, n, lo=0):
    """The kernel's blocks: (feasible [B,N,G], job_count [B,N], tg_count
    [B,N,G]) built tile by tile, each tile from its own walk of the
    eval's patch rows and job positions."""
    verdicts, patch_rows, patch_vals, job_rows, job_tgs = (
        np.asarray(x) for x in ov)
    b, c, g = verdicts.shape
    tile, groups = tb.overlay_tile(g)
    feasible = np.zeros((b, n, g), bool)
    job_count = np.full((b, n), -1, np.int32)  # every row must be written
    tg_count = np.full((b, n, g), -1, np.int32)
    for e in range(b):                          # blockIdx.y
        for r0 in range(0, n, tile):            # blockIdx.x
            for g0 in range(0, g, groups):      # blockIdx.z
                rows, gs = min(tile, n - r0), min(groups, g - g0)
                cid = np.minimum(class_ids[r0:r0 + rows], c - 1)
                s_feas = np.where((cid >= 0)[:, None],
                                  verdicts[e][np.maximum(cid, 0),
                                              g0:g0 + gs], False)
                s_jc = np.zeros(rows, np.int32)
                s_tgc = np.zeros((rows, gs), np.int32)
                for p in range(patch_rows.shape[1]):
                    row = int(patch_rows[e, p]) - lo - r0
                    if 0 <= row < rows:
                        s_feas[row] = patch_vals[e, p, g0:g0 + gs]
                for j in range(job_rows.shape[1]):
                    row = int(job_rows[e, j]) - lo - r0
                    if 0 <= row < rows:
                        s_jc[row] += 1
                        tg = int(job_tgs[e, j])
                        if g0 <= tg < g0 + gs:
                            s_tgc[row, tg - g0] += 1
                feasible[e, r0:r0 + rows, g0:g0 + gs] = s_feas
                tg_count[e, r0:r0 + rows, g0:g0 + gs] = s_tgc
                if g0 == 0:
                    job_count[e, r0:r0 + rows] = s_jc
    return feasible, job_count, tg_count


def overlays(seed, b, n_total, g, c, p, j):
    """Seeded compact overlays over ``n_total`` nodes: class ids in [-1,
    c + 3) (some past the C classes), distinct patch rows padded with
    n_total, job positions with repeats (several allocs of one job on
    one node), task groups in [0, g] (g, out of range, drops; the
    matrix never builds a negative one), padded with n_total."""
    rng = np.random.default_rng(seed)
    class_ids = rng.integers(-1, c + 3, n_total).astype(np.int32)
    patch_rows = np.full((b, p), n_total, np.int32)
    job_rows = np.full((b, j), n_total, np.int32)
    for e in range(b):
        real = rng.integers(1, p)
        patch_rows[e, :real] = rng.choice(n_total, real, replace=False)
        used = rng.integers(1, j)
        job_rows[e, :used] = rng.integers(0, n_total, used)
        job_rows[e, :4] = job_rows[e, 0]  # four allocs on one node
    ov = jb.CompactOverlay(
        verdicts=rng.random((b, c, g)) < 0.6, patch_rows=patch_rows,
        patch_vals=rng.random((b, p, g)) < 0.5, job_rows=job_rows,
        job_tgs=rng.integers(0, g + 1, (b, j)).astype(np.int32))
    return class_ids, ov


def jax_expand(class_ids, ov, n, g):
    """The JAX package's expansion eval by eval, on jax arrays (its
    gathers clamp class ids past C as the device program's do)."""
    out = [jb._expand_overlay(jnp.asarray(class_ids), jb.CompactOverlay(
        *(jnp.asarray(np.asarray(x)[e]) for x in ov)), n, g)
        for e in range(ov.verdicts.shape[0])]
    return tuple(np.stack([np.asarray(o[i]) for o in out]) for i in range(3))


@pytest.mark.parametrize("b,n,g,c,p,j", [
    (1, 1000, 2, 16, 32, 64), (3, 1500, 3, 8, 64, 256),
    (2, 512, 1, 4, 16, 16), (2, 700, 64, 12, 32, 128),
    (4, 37, 2, 3, 8, 40), (2, 90, 700, 5, 8, 300)])
def test_tiles_equal_the_plain_and_jax_expansion(b, n, g, c, p, j):
    class_ids, ov = overlays(n + g, b, n, g, c, p, j)
    got = tiled(class_ids, ov, n)
    plain = tb.expand_overlay(torch.from_numpy(class_ids),
                              carry.overlay_from_numpy(ov, "cpu"), n)
    want = jax_expand(class_ids, ov, n, g)
    for x, y, z in zip(got, plain, want):
        np.testing.assert_array_equal(x, y.numpy())
        np.testing.assert_array_equal(x, z)
    # The pad row and other out-of-range rows dropped; every real job
    # position with a task group in range counted once.
    real = np.asarray(ov.job_rows) < n
    assert got[1].sum() == real.sum()
    tg = np.asarray(ov.job_tgs)
    assert got[2].sum() == (real & (tg < g)).sum()
    assert (got[1] >= 4).any()


@pytest.mark.parametrize("w,s", [(2, 0), (2, 1), (4, 2), (3, 2)])
def test_a_shards_tiles_are_its_rows_of_the_whole_expansion(w, s):
    """The shard form: the outputs are one node shard's rows from
    global row lo; patch and job rows of other shards, and the pad
    (global N), drop."""
    b, n_total, g = 3, 2100, 2
    class_ids, ov = overlays(7 + s, b, n_total, g, 10, 64, 200)
    lo, hi = s * n_total // w, (s + 1) * n_total // w
    got = tiled(class_ids[lo:hi], ov, hi - lo, lo)
    plain = tb.expand_overlay(torch.from_numpy(class_ids[lo:hi].copy()),
                              carry.overlay_from_numpy(ov, "cpu"), hi - lo,
                              lo)
    whole = jax_expand(class_ids, ov, n_total, g)
    for x, y, z in zip(got, plain, whole):
        np.testing.assert_array_equal(x, y.numpy())
        np.testing.assert_array_equal(x, z[:, lo:hi])


@pytest.mark.parametrize("g,tile", [
    (1, (512, 1)), (2, (512, 2)), (64, (128, 64)), (300, (32, 300)),
    (306, (32, 306)), (307, (32, 306)), (500, (32, 306)),
    (10000, (32, 306))])
def test_a_tile_fits_the_ctas_shared_memory(g, tile):
    """512 rows a CTA where they fit in 48 KB (5 G + 4 bytes a row),
    fewer (a multiple of 32 down to 32) where they do not; past that,
    32 rows of a window of the task groups, so any G runs."""
    assert tb.overlay_tile(g) == tile
    rows, groups = tile
    assert rows * (5 * groups + 4) <= tb.OVERLAY_SMEM
    assert groups == g or rows == tb.OVERLAY_ROWS_MIN
    with pytest.raises(ValueError):
        tb.overlay_tile(0)


def test_the_matrix_builds_distinct_patch_rows_padded_to_drop():
    """The compact overlay of a real build: its patch rows are distinct
    real rows, then pads of N (out of range: the scatter drops them)."""
    h = build_reference_cluster(300, 5)
    job = two_group_job()
    job.constraints.append(Constraint(ltarget="${attr.kernel.name}",
                                      operand="=", rtarget="linux"))
    job.task_groups[1].constraints.append(Constraint(
        ltarget="${node.unique.id}", operand="!=",
        rtarget=h.state.nodes()[0].id))
    h.state.upsert_job(h.next_index(), job)
    hp = carry_over(h)
    m = PortMatrix(hp.state.snapshot(), hp.state.job_by_id(job.id))
    ov = m.compact_overlay
    assert ov is not None
    rows = np.asarray(ov.patch_rows)
    real = rows[rows < m.n]
    assert len(real) >= 1 and len(set(real.tolist())) == len(real)
    assert (real < m.n_real).all()
    assert (rows[len(real):] == m.n).all()
    assert (np.asarray(ov.job_rows)[np.asarray(ov.job_rows) >= m.n]
            == m.n).all()
