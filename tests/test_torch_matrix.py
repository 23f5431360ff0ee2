"""models/ in the port against the JAX package's: for the same cluster
carried across (nomad_tpu_torch/carry.py), both packages' ClusterMatrix
arrays, build_asks and compact overlay are equal, on a full build and
on a delta base. Rows are compared in node-ID order."""

from __future__ import annotations

import numpy as np
import pytest

from nomad_tpu.models.matrix import ClusterMatrix as JaxMatrix
from nomad_tpu.structs import Constraint, consts
from nomad_tpu.structs.eval import new_eval
from nomad_tpu_torch.models.matrix import ClusterMatrix as PortMatrix

from torch_parity import (
    build_reference_cluster,
    carry_over,
    distinct_hosts_job,
    port_eval,
    two_group_job,
)

ROW_FIELDS = ("capacity", "sched_capacity", "util", "bw_avail", "bw_used",
              "ports_free", "node_ok", "job_count", "tg_count", "feasible",
              "class_ids")


def _order(m):
    return np.argsort([n.id for n in m.nodes], kind="stable")


def assert_same_matrix(mj, mp):
    assert [n.id for n in mj.nodes] == [n.id for n in mp.nodes]
    assert (mj.n, mj.n_real, mj.g) == (mp.n, mp.n_real, mp.g)
    assert mj.nodes_by_dc == mp.nodes_by_dc
    oj, op = _order(mj), _order(mp)
    for name in ROW_FIELDS:
        a = np.asarray(getattr(mj, name))[: mj.n_real][oj]
        b = np.asarray(getattr(mp, name))[: mp.n_real][op]
        np.testing.assert_array_equal(a, b, err_msg=name)
        # padding rows too
        np.testing.assert_array_equal(
            np.asarray(getattr(mj, name))[mj.n_real:],
            np.asarray(getattr(mp, name))[mp.n_real:], err_msg=name)
    cj, cp = mj.compact_overlay, mp.compact_overlay
    assert (cj is None) == (cp is None)
    if cj is not None:
        for name in cj._fields:
            np.testing.assert_array_equal(getattr(cj, name),
                                          getattr(cp, name), err_msg=name)


def assert_same_asks(mj, mp, placements):
    for a, b in zip(mj.build_asks(placements), mp.build_asks(placements)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("seed", [1, 2])
def test_full_build_equal(seed):
    h = build_reference_cluster(200, seed)
    job = two_group_job()
    # A constraint that splits the fleet by class, and one escaped
    # (per-node) constraint, so verdicts and patch rows are non-trivial.
    job.constraints.append(Constraint(ltarget="${attr.kernel.name}",
                                      operand="=", rtarget="linux"))
    job.task_groups[1].constraints.append(Constraint(
        ltarget="${node.unique.id}", operand="!=",
        rtarget=h.state.nodes()[0].id))
    h.state.upsert_job(h.next_index(), job)
    hp = carry_over(h)
    mj = JaxMatrix(h.state.snapshot(), h.state.job_by_id(job.id))
    mp = PortMatrix(hp.state.snapshot(), hp.state.job_by_id(job.id))
    assert mj.build_kind == mp.build_kind == "full"
    assert_same_matrix(mj, mp)
    assert_same_asks(mj, mp, [0, 1, 1, 0, 1])
    assert mp.compact_overlay is not None
    assert (mp.compact_overlay.patch_rows < mp.n).sum() >= 1


def test_distinct_hosts_asks_equal():
    h = build_reference_cluster(100, 4)
    job = distinct_hosts_job(12)
    job.constraints.append(Constraint(operand=consts.CONSTRAINT_DISTINCT_HOSTS))
    h.state.upsert_job(h.next_index(), job)
    hp = carry_over(h)
    mj = JaxMatrix(h.state.snapshot(), h.state.job_by_id(job.id))
    mp = PortMatrix(hp.state.snapshot(), hp.state.job_by_id(job.id))
    assert_same_matrix(mj, mp)
    assert_same_asks(mj, mp, [0] * 12)
    assert bool(mp.build_asks([0])[5]) and bool(mp.build_asks([0])[6][0])


def test_delta_base_equal():
    """After a plan commits, the next snapshot's base is a delta of the
    previous one in both packages, with the same changed rows, and the
    job's compact overlay carries its alloc positions."""
    h = build_reference_cluster(160, 6, harness_seed=6)
    job = two_group_job((9, 7))
    h.state.upsert_job(h.next_index(), job)
    hp = carry_over(h)
    mj0 = JaxMatrix(h.state.snapshot(), h.state.job_by_id(job.id))
    mp0 = PortMatrix(hp.state.snapshot(), hp.state.job_by_id(job.id))
    assert_same_matrix(mj0, mp0)
    ev = new_eval(h.state.job_by_id(job.id), consts.EVAL_TRIGGER_JOB_REGISTER)
    h.process("service", ev)
    hp.process("service", port_eval(ev))
    mj = JaxMatrix(h.state.snapshot(), h.state.job_by_id(job.id))
    mp = PortMatrix(hp.state.snapshot(), hp.state.job_by_id(job.id))
    assert mj.build_kind == mp.build_kind == "delta"
    assert mj.base_delta[1] == mp.base_delta[1]
    assert mj.base_delta[0] == mj0.base_token
    assert mp.base_delta[0] == mp0.base_token
    assert_same_matrix(mj, mp)
    assert int((mp.compact_overlay.job_rows < mp.n).sum()) == 16


def test_dense_overlay_dispatch_matches_compact():
    """A matrix whose compact overlay overflowed its padding buckets
    dispatches its dense [N, G] overlay instead; both paths give the
    same placements."""
    from nomad_tpu_torch.ops.binpack import (
        PlacementConfig,
        host_prng_key,
        make_asks,
    )
    from nomad_tpu_torch.scheduler.batcher import PlacementBatcher

    h = build_reference_cluster(128, 8)
    job = two_group_job()
    h.state.upsert_job(h.next_index(), job)
    hp = carry_over(h)
    m = PortMatrix(hp.state.snapshot(), hp.state.job_by_id(job.id))
    asks = make_asks(*m.build_asks([0, 1] * 10))
    key = host_prng_key(99)
    config = PlacementConfig(anti_affinity_penalty=10.0)
    batcher = PlacementBatcher("cpu")
    compact = batcher.place(m, asks, key, config)
    m.compact_overlay = None
    dense = batcher.place(m, asks, key, config)
    np.testing.assert_array_equal(compact[0], dense[0])
    np.testing.assert_array_equal(compact[1], dense[1])
    stats = batcher.stats()
    assert stats["compact_dispatches"] == 1
    assert stats["overlay_dispatches"] == 2 and stats["base_uploads"] == 1
