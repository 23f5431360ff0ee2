"""The whole slice: the same carried-across state, eval and Harness
seed go through the JAX package's "service-tpu" and the port's
"service-gpu" (on the CPU). The plans must be equal per alloc name —
node, score within 1e-4 (float32 pow ulps), port offers — and so must
the failed-task-group metrics."""

from __future__ import annotations

import pytest

from nomad_tpu.structs import consts
from nomad_tpu.structs.eval import new_eval

from torch_parity import (
    build_reference_cluster,
    carry_over,
    distinct_hosts_job,
    failed_view,
    plan_view,
    port_eval,
    two_group_job,
)

SCORE_TOL = 1e-4


def _run_both(h, job, trigger=consts.EVAL_TRIGGER_JOB_REGISTER):
    h.state.upsert_job(h.next_index(), job)
    hp = carry_over(h)
    ev = new_eval(h.state.job_by_id(job.id), trigger)
    h.process("service-tpu", ev)
    hp.process("service-gpu", port_eval(ev))
    return h, hp


def _assert_same_plans(h, hp):
    assert len(h.plans) == len(hp.plans)
    for pj, pt in zip(h.plans, hp.plans):
        vj, vt = plan_view(pj), plan_view(pt)
        assert set(vj) == set(vt)
        for name, (node, scores, ports) in vj.items():
            node_t, scores_t, ports_t = vt[name]
            assert node == node_t, name
            assert ports == ports_t, name
            assert set(scores) == set(scores_t)
            for key, s in scores.items():
                assert abs(s - scores_t[key]) <= SCORE_TOL, (name, key)
    assert [failed_view(e) for e in h.evals] == \
        [failed_view(e) for e in hp.evals]
    assert [e.status for e in h.evals] == [e.status for e in hp.evals]
    assert [e.queued_allocations for e in h.evals] == \
        [e.queued_allocations for e in hp.evals]


@pytest.mark.parametrize("seed", [3, 11])
def test_distinct_hosts_job_same_plan(seed):
    """Config 4's shape (uniform distinct-hosts: K2 on the port)."""
    h = build_reference_cluster(256, seed, harness_seed=seed)
    h, hp = _run_both(h, distinct_hosts_job(40))
    _assert_same_plans(h, hp)
    assert len(plan_view(hp.plans[0])) == 40


@pytest.mark.parametrize("seed", [5, 17])
def test_two_group_job_same_plan(seed):
    """Two task groups, no distinct_hosts (K1 and K3 on the port)."""
    h = build_reference_cluster(256, seed, harness_seed=seed)
    h, hp = _run_both(h, two_group_job((30, 26)))
    _assert_same_plans(h, hp)
    assert len(plan_view(hp.plans[0])) == 56


def test_scale_up_after_commit_same_plan():
    """A job scaled up after its first plan committed: its existing
    allocs stage as in-place updates first, and the compact overlay
    carries their rows (K3 with job positions)."""
    h = build_reference_cluster(256, 23, harness_seed=23)
    job = two_group_job((12, 10), job_id="grow")
    h, hp = _run_both(h, job)
    _assert_same_plans(h, hp)
    grown = job.copy()
    grown.task_groups[0].count = 40
    grown.task_groups[1].count = 30
    h.state.upsert_job(h.next_index(), grown)
    hp.state.upsert_job(hp.next_index(), port_job(grown))
    ev = new_eval(h.state.job_by_id(job.id), consts.EVAL_TRIGGER_JOB_REGISTER)
    h.process("service-tpu", ev)
    hp.process("service-gpu", port_eval(ev))
    _assert_same_plans(h, hp)
    # 22 in-place updates of the committed allocs + 48 new placements.
    assert len(plan_view(hp.plans[1])) == 70


def test_eval_sequence_same_plans():
    """Three evals in a row on one store, the smoke's sequence at a
    small size: a distinct-hosts job, a two-group job (its base is a
    delta of the first eval's, fused into its dispatch), then
    replacements for failed allocs of the second job (a delta base and
    a compact overlay with the job's alloc rows)."""
    from nomad_tpu_torch.scheduler.batcher import get_batcher

    h = build_reference_cluster(256, 31, harness_seed=31)
    dh, two = distinct_hosts_job(16), two_group_job((20, 12))
    h.state.upsert_job(h.next_index(), dh)
    h.state.upsert_job(h.next_index(), two)
    hp = carry_over(h)
    before = get_batcher().stats()
    for job in (dh, two):
        ev = new_eval(h.state.job_by_id(job.id),
                      consts.EVAL_TRIGGER_JOB_REGISTER)
        h.process("service-tpu", ev)
        hp.process("service-gpu", port_eval(ev))
    for harness in (h, hp):
        live = sorted(harness.state.allocs_by_job(two.id),
                      key=lambda a: a.name)
        failed = []
        for a in live[:8]:
            upd = a.copy()
            upd.client_status = consts.ALLOC_CLIENT_FAILED
            failed.append(upd)
        harness.state.update_allocs_from_client(harness.next_index(), failed)
    ev = new_eval(h.state.job_by_id(two.id), consts.EVAL_TRIGGER_NODE_UPDATE)
    h.process("service-tpu", ev)
    hp.process("service-gpu", port_eval(ev))
    _assert_same_plans(h, hp)
    assert [len(plan_view(p)) for p in hp.plans] == [16, 32, 8]
    after = get_batcher().stats()
    assert after["fused_delta_updates"] - before["fused_delta_updates"] >= 2
    assert after["compact_dispatches"] - before["compact_dispatches"] == 3


@pytest.mark.parametrize("seed", [3, 11])
@pytest.mark.parametrize("make_job", [lambda: distinct_hosts_job(40),
                                      lambda: two_group_job((30, 26))],
                         ids=["distinct_hosts", "two_group"])
def test_pre_resolve_same_plan(seed, make_job):
    """The server's default planner runs with pre_resolve on (the JAX
    package's ServerConfig.dense_pre_resolve): the dense scheduler
    hands it to the batcher, whose padded batch scans its evals in
    order. The port places what the reference places."""
    h = build_reference_cluster(256, seed, harness_seed=seed)
    job = make_job()
    h.state.upsert_job(h.next_index(), job)
    hp = carry_over(h)
    h.pre_resolve = hp.pre_resolve = True
    ev = new_eval(h.state.job_by_id(job.id), consts.EVAL_TRIGGER_JOB_REGISTER)
    h.process("service-tpu", ev)
    hp.process("service-gpu", port_eval(ev))
    _assert_same_plans(h, hp)
    want = sum(tg.count for tg in job.task_groups)
    assert len(plan_view(hp.plans[0])) == want


def test_unplaceable_asks_same_failure_metrics():
    """More distinct-hosts asks than nodes: both fail the surplus with
    the same metrics and leave the same blocked eval."""
    h = build_reference_cluster(64, 29, harness_seed=29)
    h, hp = _run_both(h, distinct_hosts_job(90))
    _assert_same_plans(h, hp)
    assert failed_view(hp.evals[0])
    assert len(h.create_evals) == len(hp.create_evals) == 1


def port_job(job):
    from nomad_tpu.utils.codec import to_dict
    from nomad_tpu_torch.structs import Job
    from nomad_tpu_torch.utils.codec import from_dict

    return from_dict(Job, to_dict(job))
