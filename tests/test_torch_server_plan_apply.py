"""The JAX package's tests/test_plan_apply.py on the port.

Plan applier tests: per-node verification with partial commit, and
the pipelined verify-(N+1)-while-committing-(N) path with its
failed-commit refresh (mirror plan_apply.go:41-118,194-313)."""

import torch_parity  # noqa: F401  (the port on the CPU)
import threading
import time

from nomad_tpu_torch import mock
from nomad_tpu_torch.server.fsm import FSM, DevLog
from nomad_tpu_torch.server.plan_apply import OptimisticSnapshot, PlanApplier
from nomad_tpu_torch.server.plan_queue import PlanQueue
from nomad_tpu_torch.structs import Allocation, Plan, consts
from nomad_tpu_torch.utils.ids import generate_uuid


def build_world(n_nodes=2, cpu=1000):
    fsm = FSM()
    log = DevLog(fsm)
    nodes = []
    for _ in range(n_nodes):
        node = mock.node()
        node.resources.cpu = cpu
        log.apply("node_register", {"node": node})
        nodes.append(node)
    return fsm, log, nodes


def make_plan(node, cpu, job=None):
    job = job or mock.job()
    alloc = Allocation(
        id=generate_uuid(), job_id=job.id, job=job, node_id=node.id,
        task_group="web", desired_status=consts.ALLOC_DESIRED_RUN,
    )
    alloc.task_resources = {"web": mock.job().task_groups[0].tasks[0].resources.copy()}
    alloc.task_resources["web"].cpu = cpu
    alloc.task_resources["web"].networks = []
    plan = Plan(job=job)
    plan.append_alloc(alloc)
    return plan


class SlowLog:
    """DevLog wrapper with injectable commit latency/failures."""

    def __init__(self, inner, delay=0.0):
        self.inner = inner
        self.delay = delay
        self.fail_next = False
        self.applies = []

    def apply(self, msg_type, payload):
        if self.delay:
            time.sleep(self.delay)
        if self.fail_next:
            self.fail_next = False
            raise TimeoutError("injected commit failure")
        self.applies.append((msg_type, time.monotonic()))
        return self.inner.apply(msg_type, payload)

    def last_index(self):
        return self.inner.last_index()


def run_applier(fsm, log, plans, pool_size=2):
    queue = PlanQueue()
    queue.set_enabled(True)
    applier = PlanApplier(queue, fsm, log, pool_size=pool_size)
    applier.start()
    pendings = [queue.enqueue(p) for p in plans]
    results = []
    for pending in pendings:
        try:
            results.append(pending.wait(timeout=20.0))
        except Exception as e:  # noqa: BLE001
            results.append(e)
    applier.stop()
    return results


def test_plan_applies_and_commits():
    fsm, log, nodes = build_world()
    plan = make_plan(nodes[0], 100)
    (result,) = run_applier(fsm, log, [plan])
    assert not result.is_no_op()
    assert result.alloc_index > 0
    stored = fsm.state.allocs_by_node(nodes[0].id)
    assert len(stored) == 1


def test_partial_commit_rejects_overcommitted_node():
    """Node B can't fit; only node A's placement commits and the result
    carries a refresh index (plan_apply.go partial commit)."""
    fsm, log, nodes = build_world(n_nodes=2, cpu=300)
    job = mock.job()
    plan = Plan(job=job)
    for node, cpu in ((nodes[0], 100), (nodes[1], 10_000)):
        alloc = Allocation(
            id=generate_uuid(), job_id=job.id, job=job, node_id=node.id,
            task_group="web", desired_status=consts.ALLOC_DESIRED_RUN,
        )
        alloc.task_resources = {
            "web": mock.job().task_groups[0].tasks[0].resources.copy()}
        alloc.task_resources["web"].cpu = cpu
        alloc.task_resources["web"].networks = []
        plan.append_alloc(alloc)
    (result,) = run_applier(fsm, log, [plan])
    assert nodes[0].id in result.node_allocation
    assert nodes[1].id not in result.node_allocation
    assert result.refresh_index > 0


def test_pipelined_verification_overlaps_commit():
    """With a slow commit, plan N+1's verification runs BEFORE plan N's
    commit finishes — the pipelining the reference documents at
    plan_apply.go:19-39."""
    fsm, devlog, nodes = build_world(n_nodes=2)
    log = SlowLog(devlog, delay=0.3)

    eval_times = []
    queue = PlanQueue()
    queue.set_enabled(True)
    applier = PlanApplier(queue, fsm, log)
    orig_eval = applier._evaluate_plan

    def traced_eval(snapshot, plan):
        eval_times.append(time.monotonic())
        return orig_eval(snapshot, plan)

    applier._evaluate_plan = traced_eval
    applier.start()
    p1 = queue.enqueue(make_plan(nodes[0], 100))
    p2 = queue.enqueue(make_plan(nodes[1], 100))
    r1 = p1.wait(timeout=20.0)
    r2 = p2.wait(timeout=20.0)
    applier.stop()
    assert r1.alloc_index > 0 and r2.alloc_index > 0
    assert len(eval_times) == 2 and len(log.applies) == 2
    # plan 2 was verified before plan 1's commit landed
    commit1_done = log.applies[0][1]
    assert eval_times[1] < commit1_done, (
        f"no overlap: eval2 at {eval_times[1]}, commit1 done {commit1_done}")


def test_optimistic_view_sees_inflight_allocs():
    """Two plans placing on the SAME nearly-full node: the second must
    be rejected because the optimistic view includes the first's
    in-flight alloc (no double-commit of the same capacity)."""
    fsm, devlog, nodes = build_world(n_nodes=1, cpu=500)
    log = SlowLog(devlog, delay=0.2)
    plans = [make_plan(nodes[0], 250), make_plan(nodes[0], 250)]
    r1, r2 = run_applier(fsm, log, plans)
    assert r1.alloc_index > 0
    # second plan rejected at verification: partial-commit empty result
    assert r2.is_no_op() or not r2.node_allocation
    assert r2.refresh_index > 0
    stored = fsm.state.allocs_by_node(nodes[0].id)
    assert len(stored) == 1  # capacity was never double-committed


def test_failed_commit_forces_fresh_verification():
    """Plan 1's commit fails; plan 2 re-verifies on fresh state (which
    does NOT contain plan 1's phantom alloc) and commits fine."""
    fsm, devlog, nodes = build_world(n_nodes=1, cpu=500)
    log = SlowLog(devlog, delay=0.1)
    log.fail_next = True  # first commit blows up
    plans = [make_plan(nodes[0], 250), make_plan(nodes[0], 250)]
    r1, r2 = run_applier(fsm, log, plans)
    assert isinstance(r1, Exception)
    # plan 2 re-verified on fresh state: the phantom alloc from the
    # failed plan 1 is gone, so plan 2 fits and commits.
    assert not isinstance(r2, Exception)
    assert r2.alloc_index > 0
    stored = fsm.state.allocs_by_node(nodes[0].id)
    assert len(stored) == 1


def test_optimistic_snapshot_reads():
    fsm, log, nodes = build_world(n_nodes=1)
    base = fsm.state.snapshot()
    opt = OptimisticSnapshot(base)
    assert opt.node_by_id(nodes[0].id) is not None
    assert opt.allocs_by_node_terminal(nodes[0].id, False) == []

    from nomad_tpu_torch.structs import PlanResult

    alloc = Allocation(id="a1", node_id=nodes[0].id, job_id="j")
    opt.add_result(PlanResult(node_allocation={nodes[0].id: [alloc]}))
    live = opt.allocs_by_node_terminal(nodes[0].id, False)
    assert [a.id for a in live] == ["a1"]
    # eviction hides an alloc from the base view
    opt2 = OptimisticSnapshot(base)
    opt2.add_result(PlanResult(node_update={nodes[0].id: [alloc]}))
    assert all(a.id != "a1"
               for a in opt2.allocs_by_node_terminal(nodes[0].id, False))


def test_base_refreshes_after_each_commit():
    """External state changes applied between commits are visible to
    later plans (the base rebases per commit, bounding staleness)."""
    fsm, devlog, nodes = build_world(n_nodes=2)
    log = SlowLog(devlog, delay=0.05)
    queue = PlanQueue()
    queue.set_enabled(True)
    applier = PlanApplier(queue, fsm, log)
    applier.start()
    try:
        p1 = queue.enqueue(make_plan(nodes[0], 100))
        assert p1.wait(timeout=10.0).alloc_index > 0
        # Drain node 1 OUTSIDE the plan pipeline while the queue idles.
        devlog.apply("node_update_drain",
                     {"node_id": nodes[1].id, "drain": True})
        p2 = queue.enqueue(make_plan(nodes[1], 100))
        r2 = p2.wait(timeout=10.0)
        # the applier saw the drain: nothing placed on the drained node
        assert not r2.node_allocation
    finally:
        applier.stop()


def test_rejected_plan_refresh_index_covers_inflight_commit():
    """A plan rejected because of an IN-FLIGHT plan's allocs gets a
    refresh_index beyond the pre-commit state, so the worker actually
    waits for the commit instead of spinning."""
    fsm, devlog, nodes = build_world(n_nodes=1, cpu=500)
    log = SlowLog(devlog, delay=0.2)
    pre_index = fsm.state.latest_index()
    plans = [make_plan(nodes[0], 250), make_plan(nodes[0], 250)]
    r1, r2 = run_applier(fsm, log, plans)
    assert r1.alloc_index > 0
    assert not r2.node_allocation
    assert r2.refresh_index > pre_index


def test_rejected_plan_does_not_pin_stale_base():
    """A rejection with no commit in flight must not stick the NEXT
    plan to the same stale snapshot: capacity freed between plans is
    seen (the pre-pipelining fresh-snapshot-per-plan invariant)."""
    fsm, devlog, nodes = build_world(n_nodes=1, cpu=500)
    queue = PlanQueue()
    queue.set_enabled(True)
    applier = PlanApplier(queue, fsm, devlog)
    applier.start()
    try:
        # Fill the node.
        p1 = queue.enqueue(make_plan(nodes[0], 250))
        r1 = p1.wait(timeout=10.0)
        assert r1.alloc_index > 0
        big_alloc_id = next(iter(r1.node_allocation.values()))[0].id
        # Second plan rejected: node is full.
        p2 = queue.enqueue(make_plan(nodes[0], 250))
        r2 = p2.wait(timeout=10.0)
        assert not r2.node_allocation
        # Free the capacity OUTSIDE the plan pipeline (client update).
        stored = fsm.state.alloc_by_id(big_alloc_id)
        freed = stored.copy()
        freed.desired_status = consts.ALLOC_DESIRED_STOP
        freed.client_status = consts.ALLOC_CLIENT_COMPLETE
        devlog.apply("alloc_update", {"allocs": [freed], "job": stored.job})
        # The next plan must see the freed capacity and commit.
        p3 = queue.enqueue(make_plan(nodes[0], 250))
        r3 = p3.wait(timeout=10.0)
        assert r3.alloc_index > 0, "stale base pinned after rejection"
    finally:
        applier.stop()


# --------- evaluate_node_plan edges (plan_apply.go:318 test family) ---


def test_eval_node_plan_not_ready():
    from nomad_tpu_torch.server.plan_apply import evaluate_node_plan

    fsm, log, nodes = build_world(n_nodes=1)
    log.apply("node_update_status",
              {"node_id": nodes[0].id, "status": consts.NODE_STATUS_DOWN})
    snap = fsm.state.snapshot()
    assert evaluate_node_plan(snap, make_plan(nodes[0], 100), nodes[0].id) is False


def test_eval_node_plan_draining():
    from nomad_tpu_torch.server.plan_apply import evaluate_node_plan

    fsm, log, nodes = build_world(n_nodes=1)
    log.apply("node_update_drain", {"node_id": nodes[0].id, "drain": True})
    snap = fsm.state.snapshot()
    assert evaluate_node_plan(snap, make_plan(nodes[0], 100), nodes[0].id) is False


def test_eval_node_plan_missing_node():
    from nomad_tpu_torch.server.plan_apply import evaluate_node_plan

    fsm, log, nodes = build_world(n_nodes=1)
    plan = make_plan(nodes[0], 100)
    # rewrite the plan to target a node that does not exist
    plan.node_allocation = {"ghost": plan.node_allocation[nodes[0].id]}
    for a in plan.node_allocation["ghost"]:
        a.node_id = "ghost"
    snap = fsm.state.snapshot()
    assert evaluate_node_plan(snap, plan, "ghost") is False


def test_eval_node_plan_evictions_only_always_safe():
    """A plan that only stops allocs passes even on a down node
    (plan_apply.go:318 early return)."""
    from nomad_tpu_torch.server.plan_apply import evaluate_node_plan
    from nomad_tpu_torch.structs import Plan

    fsm, log, nodes = build_world(n_nodes=1)
    job = mock.job()
    alloc = mock.alloc()
    alloc.node_id = nodes[0].id
    log.apply("node_update_status",
              {"node_id": nodes[0].id, "status": consts.NODE_STATUS_DOWN})
    plan = Plan(job=job)
    plan.node_update = {nodes[0].id: [alloc]}
    snap = fsm.state.snapshot()
    assert evaluate_node_plan(snap, plan, nodes[0].id) is True


def test_eval_node_plan_update_existing_in_place():
    """Evicting an alloc and re-placing its replacement on the same
    node in one plan fits (the in-place update shape,
    TestPlanApply_EvalNodePlan_UpdateExisting)."""
    from nomad_tpu_torch.server.plan_apply import evaluate_node_plan
    from nomad_tpu_torch.structs import Plan

    fsm, log, nodes = build_world(n_nodes=1, cpu=500)
    job = mock.job()
    old = make_plan(nodes[0], 300, job=job).node_allocation[nodes[0].id][0]
    log.apply("alloc_update", {"allocs": [old], "job": job})

    replacement = make_plan(nodes[0], 300, job=job)
    replacement.node_update = {nodes[0].id: [old]}
    snap = fsm.state.snapshot()
    # without the eviction the node would be full; with it, it fits
    assert evaluate_node_plan(snap, replacement, nodes[0].id) is True


def test_eval_node_plan_node_full():
    from nomad_tpu_torch.server.plan_apply import evaluate_node_plan

    fsm, log, nodes = build_world(n_nodes=1, cpu=500)
    job = mock.job()
    old = make_plan(nodes[0], 300, job=job).node_allocation[nodes[0].id][0]
    log.apply("alloc_update", {"allocs": [old], "job": job})
    snap = fsm.state.snapshot()
    assert evaluate_node_plan(
        snap, make_plan(nodes[0], 300), nodes[0].id) is False


def test_gang_commit_all_at_once_rejects_whole_plan():
    """TestPlanApply_EvalPlan_Partial_AllAtOnce: with all_at_once, one
    failing node rejects the entire plan."""
    fsm, log, nodes = build_world(n_nodes=2, cpu=300)
    job = mock.job()
    from nomad_tpu_torch.structs import Allocation, Plan
    from nomad_tpu_torch.utils.ids import generate_uuid

    plan = Plan(job=job, all_at_once=True)
    for node, cpu in ((nodes[0], 100), (nodes[1], 10_000)):
        alloc = Allocation(
            id=generate_uuid(), job_id=job.id, job=job, node_id=node.id,
            task_group="web", desired_status=consts.ALLOC_DESIRED_RUN,
        )
        alloc.task_resources = {
            "web": mock.job().task_groups[0].tasks[0].resources.copy()}
        alloc.task_resources["web"].cpu = cpu
        alloc.task_resources["web"].networks = []
        plan.append_alloc(alloc)
    (result,) = run_applier(fsm, log, [plan])
    assert result.node_allocation == {} and result.node_update == {}
    assert result.refresh_index > 0


def test_rejection_past_matrix_watermark_is_ordinary_conflict():
    """A rejection explained by allocs that landed AFTER the plan's
    matrix watermark is an ordinary optimistic-concurrency loss: the
    device-resident chain must NOT be marked stale for it (a
    conflict-heavy storm would otherwise purge the base cache per
    rejection and degenerate into rebuild-per-snapshot)."""
    from nomad_tpu_torch.models.resident import get_tracker

    fsm, log, nodes = build_world(n_nodes=1, cpu=500)
    get_tracker().consume_stale()  # clear any leftover flag
    wm = fsm.state.latest_index()
    (first,) = run_applier(fsm, log, [make_plan(nodes[0], 300)])
    assert not first.is_no_op()
    loser = make_plan(nodes[0], 300)
    loser.matrix_index = wm  # planned before the winner committed
    (result,) = run_applier(fsm, log, [loser])
    assert nodes[0].id not in result.node_allocation
    assert not get_tracker().consume_stale()


def test_rejection_at_own_watermark_marks_resident_chain_stale():
    """A rejection with NO node/alloc change past the watermark means
    the matrix claimed a fit its own snapshot refutes — only resident
    staleness explains that, so the safety net must fire."""
    from nomad_tpu_torch.models.resident import get_tracker

    fsm, log, nodes = build_world(n_nodes=1, cpu=500)
    (first,) = run_applier(fsm, log, [make_plan(nodes[0], 300)])
    assert not first.is_no_op()
    get_tracker().consume_stale()
    doomed = make_plan(nodes[0], 300)
    doomed.matrix_index = fsm.state.latest_index()  # saw everything
    (result,) = run_applier(fsm, log, [doomed])
    assert nodes[0].id not in result.node_allocation
    assert get_tracker().consume_stale()


def test_rejection_without_watermark_stays_conservative():
    """Plans minted off the host path carry no watermark: a rejection
    keeps marking the chain suspect (the safe pre-watermark default)."""
    from nomad_tpu_torch.models.resident import get_tracker

    fsm, log, nodes = build_world(n_nodes=1, cpu=500)
    (first,) = run_applier(fsm, log, [make_plan(nodes[0], 300)])
    assert not first.is_no_op()
    get_tracker().consume_stale()
    (result,) = run_applier(fsm, log, [make_plan(nodes[0], 300)])
    assert nodes[0].id not in result.node_allocation
    assert get_tracker().consume_stale()
