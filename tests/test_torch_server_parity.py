"""The port's server core held against the JAX package's on the same
inputs, exactly, where the component is deterministic: the FSM's
``persist()`` after the same log entries, the eval broker's dequeue
order and its nack, delivery-limit and shed outcomes, the plan
applier's results on the same plans, job diffs, periodic launch times,
core GC picks and admission levels.

Inputs are made in the JAX package from a seed and cross over as plain
data (``utils.codec.to_dict`` -> the port's ``from_dict``), so both
packages see the same ids. ``node.status_updated_at`` is wall-clock time
stamped by each store on a status change; it is the one field left out
of the comparisons."""

from __future__ import annotations

import dataclasses
import json
import random

import pytest

import torch_parity  # noqa: F401  (the port on the CPU)
from nomad_tpu import mock
from nomad_tpu.structs import (
    Allocation,
    DesiredUpdates,
    PeriodicConfig,
    Plan,
    PlanAnnotations,
    Vault,
    consts,
)
from nomad_tpu.utils.codec import to_dict
from nomad_tpu_torch import structs as pstructs
from nomad_tpu_torch.utils.codec import from_dict

# ------------------------------------------------------------- crossing


def port(obj):
    """The port's struct for one of the JAX package's (same fields)."""
    return from_dict(getattr(pstructs, type(obj).__name__), to_dict(obj))


def port_payload(payload: dict) -> dict:
    out = {}
    for key, value in payload.items():
        if key in ("node", "job"):
            out[key] = None if value is None else port(value)
        elif key in ("evals", "allocs"):
            out[key] = [port(v) for v in value]
        elif key == "accessors":
            out[key] = [v if isinstance(v, str) else port(v) for v in value]
        else:
            out[key] = value
    return out


def canon(data) -> str:
    """Persisted store dicts as comparable text, without the
    wall-clock node status stamp."""
    def strip(x):
        if isinstance(x, dict):
            return {k: strip(v) for k, v in x.items()
                    if k != "status_updated_at"}
        if isinstance(x, list):
            return [strip(v) for v in x]
        return x
    return json.dumps(strip(data), sort_keys=True, default=str)


# ------------------------------------------------------------------ FSM


def log_entries(seed: int):
    """A seeded sequence of (message type, payload) covering every
    message type the FSM applies."""
    rng = random.Random(seed)
    entries = []
    nodes = []
    for i in range(6):
        node = mock.node()
        node.resources.cpu = rng.choice([2000, 4000, 8000])
        node.compute_class()
        nodes.append(node)
        entries.append(("node_register", {"node": node}))
    jobs = []
    for i in range(3):
        job = mock.job()
        job.id = f"job-{seed}-{i}"
        job.task_groups[0].count = rng.randint(1, 4)
        jobs.append(job)
        entries.append(("job_register", {"job": job}))
    periodic = mock.job()
    periodic.id = f"cron-{seed}"
    periodic.periodic = PeriodicConfig(enabled=True, spec="*/5 * * * *")
    entries.append(("job_register", {"job": periodic}))
    # An enforce-index registration that loses (job already exists).
    entries.append(("job_register", {"job": jobs[0].copy(),
                                     "enforce_index": True,
                                     "job_modify_index": 0}))
    evals = []
    for job in jobs:
        ev = mock.eval()
        ev.job_id = job.id
        ev.priority = rng.choice([20, 50, 70])
        evals.append(ev)
    entries.append(("eval_update", {"evals": evals, "token": ""}))
    allocs = []
    for j, job in enumerate(jobs):
        for k in range(job.task_groups[0].count):
            alloc = mock.alloc()
            alloc.job_id = job.id
            alloc.job = None
            alloc.eval_id = evals[j].id
            alloc.node_id = rng.choice(nodes).id
            alloc.name = f"{job.id}.web[{k}]"
            allocs.append(alloc)
    entries.append(("alloc_update", {"allocs": allocs[:3], "job": jobs[0]}))
    entries.append(("alloc_update", {"allocs": allocs[3:]}))
    entries.append(("node_update_status", {
        "node_id": nodes[1].id, "status": consts.NODE_STATUS_DOWN}))
    entries.append(("node_update_drain", {"node_id": nodes[2].id,
                                          "drain": True}))
    done = allocs[0].copy()
    done.client_status = consts.ALLOC_CLIENT_COMPLETE
    entries.append(("alloc_client_update", {"allocs": [done]}))
    entries.append(("periodic_launch", {"job_id": periodic.id,
                                        "launch": 1_700_000_000.0 + seed}))
    accessor = pstructs_ref_accessor(allocs[1], seed)
    entries.append(("vault_accessor_register", {"accessors": [accessor]}))
    finished = evals[0].copy()
    finished.status = consts.EVAL_STATUS_COMPLETE
    entries.append(("eval_update", {"evals": [finished], "token": ""}))
    entries.append(("vault_accessor_deregister",
                    {"accessors": [accessor.accessor]}))
    entries.append(("eval_delete", {"eval_ids": [evals[0].id],
                                    "alloc_ids": [allocs[0].id]}))
    entries.append(("periodic_launch_delete", {"job_id": periodic.id}))
    entries.append(("job_deregister", {"job_id": jobs[2].id}))
    entries.append(("node_deregister", {"node_id": nodes[5].id}))
    return entries


def pstructs_ref_accessor(alloc, seed):
    from nomad_tpu.structs.alloc import VaultAccessor

    return VaultAccessor(accessor=f"acc-{seed}", alloc_id=alloc.id,
                         task="web", node_id=alloc.node_id,
                         policies=["db"])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fsm_persist_equal_after_the_same_log(seed):
    from nomad_tpu.server.fsm import FSM as RefFSM
    from nomad_tpu_torch.server.fsm import FSM

    ref, fsm = RefFSM(), FSM()
    entries = log_entries(seed)
    for index, (msg, payload) in enumerate(entries, start=1):
        crossed = port_payload(payload)
        ref_out = ref.apply(index, msg, payload)
        out = fsm.apply(index, msg, crossed)
        assert out == ref_out, (msg, out, ref_out)
        if index == len(entries) // 2:
            assert canon(fsm.state.persist()) == canon(ref.state.persist())
    assert canon(fsm.state.persist()) == canon(ref.state.persist())
    assert fsm.last_applied_index == ref.last_applied_index == len(entries)
    assert fsm.outcome(5 + 3) == ref.outcome(5 + 3)
    # The restored copy reads the same as well.
    fsm2 = FSM()
    fsm2.restore(fsm.snapshot_data())
    assert canon(fsm2.state.persist()) == canon(ref.state.persist())


# --------------------------------------------------------------- broker


def broker_inputs(seed: int, n_evals: int = 24):
    rng = random.Random(seed)
    jobs = [f"job-{i}" for i in range(9)]
    evals = []
    for i in range(n_evals):
        ev = mock.eval()
        ev.id = f"{seed}-ev-{i:02d}"
        ev.job_id = rng.choice(jobs)
        ev.priority = rng.choice([10, 50, 50, 70, 90])
        ev.type = rng.choice([consts.JOB_TYPE_SERVICE, consts.JOB_TYPE_BATCH])
        evals.append(ev)
    ops = [rng.choice(["dequeue", "dequeue", "many", "ack", "nack", "nack"])
           for _ in range(120)]
    return evals, ops


def drive_broker(broker_cls, failed_queue, evals, ops, ready_cap):
    broker = broker_cls(60.0, 2, ready_cap=ready_cap)
    broker.set_enabled(True)
    broker.enqueue_all(evals)
    outstanding = []  # (eval id, token), oldest first
    trace = []
    types = [consts.JOB_TYPE_SERVICE, consts.JOB_TYPE_BATCH]
    for op in ops:
        if op == "dequeue":
            ev, token = broker.dequeue(types, timeout=0.0)
            trace.append((op, ev.id if ev is not None else None))
            if ev is not None:
                outstanding.append((ev.id, token))
        elif op == "many":
            got = broker.dequeue_many(types, 3)
            trace.append((op, [e.id for e, _ in got]))
            outstanding.extend((e.id, t) for e, t in got)
        elif outstanding:
            eval_id, token = outstanding.pop(0)
            getattr(broker, op)(eval_id, token)
            trace.append((op, eval_id))
    failed = []
    while True:
        ev, token = broker.dequeue([failed_queue], timeout=0.0)
        if ev is None:
            break
        failed.append((ev.id, ev.triggered_by, ev.status_description))
        broker.ack(ev.id, token)
    return trace, failed, broker.stats()


@pytest.mark.parametrize("seed,ready_cap", [(0, 0), (1, 0), (2, 2), (3, 3)])
def test_broker_order_nacks_delivery_limit_and_shed_equal(seed, ready_cap):
    from nomad_tpu.server.broker import FAILED_QUEUE as REF_FAILED
    from nomad_tpu.server.broker import EvalBroker as RefBroker
    from nomad_tpu_torch.server.broker import FAILED_QUEUE, EvalBroker

    evals, ops = broker_inputs(seed)
    want = drive_broker(RefBroker, REF_FAILED, evals, ops, ready_cap)
    got = drive_broker(EvalBroker, FAILED_QUEUE, [port(e) for e in evals],
                       ops, ready_cap)
    assert got == want
    # The script reaches every outcome it is meant to hold.
    assert want[1], "no eval reached the failed queue"
    if ready_cap:
        assert want[2]["shed"] > 0


# ------------------------------------------------------------- applier


def applier_world(seed: int):
    """Nodes of varied capacity and readiness with existing allocs,
    and a sequence of plans over them (overcommits, evictions, a node
    that is down, one draining, an all-at-once plan, a gang)."""
    from nomad_tpu.server.fsm import FSM as RefFSM
    from nomad_tpu.server.fsm import DevLog as RefLog
    from nomad_tpu.utils.ids import generate_uuid

    rng = random.Random(seed)
    fsm = RefFSM()
    log = RefLog(fsm)
    nodes = []
    for i in range(8):
        node = mock.node()
        node.resources.cpu = rng.choice([1000, 1500, 2000])
        node.compute_class()
        log.apply("node_register", {"node": node})
        nodes.append(node)
    log.apply("node_update_status", {"node_id": nodes[6].id,
                                      "status": consts.NODE_STATUS_DOWN})
    log.apply("node_update_drain", {"node_id": nodes[7].id, "drain": True})
    base_job = mock.job()
    base_job.id = "existing"
    log.apply("job_register", {"job": base_job})
    existing = []
    for node in nodes[:6]:
        alloc = mock.alloc()
        alloc.job_id = base_job.id
        alloc.job = base_job
        alloc.node_id = node.id
        for tr in alloc.task_resources.values():
            tr.cpu = rng.choice([200, 400])
            tr.networks = []
        alloc.resources = None
        existing.append(alloc)
    log.apply("alloc_update", {"allocs": existing})

    def alloc_for(job, node, cpu, tg="web"):
        alloc = Allocation(
            id=generate_uuid(), job_id=job.id, job=job, node_id=node.id,
            task_group=tg, desired_status=consts.ALLOC_DESIRED_RUN)
        res = mock.job().task_groups[0].tasks[0].resources.copy()
        res.cpu = cpu
        res.networks = []
        alloc.task_resources = {"web": res}
        return alloc

    plans = []
    for p in range(10):
        job = mock.job()
        job.id = f"plan-job-{p}"
        plan = Plan(job=job, priority=50)
        for _ in range(rng.randint(1, 4)):
            plan.append_alloc(alloc_for(job, rng.choice(nodes),
                                        rng.choice([200, 500, 900])))
        if rng.random() < 0.4:
            victim = rng.choice(existing)
            stop = victim.copy()
            stop.desired_status = consts.ALLOC_DESIRED_STOP
            plan.node_update.setdefault(victim.node_id, []).append(stop)
        if p == 4:
            plan.all_at_once = True
        if p == 6:
            members = [alloc_for(job, nodes[i], 300) for i in (0, 1, 2)]
            for m in members:
                plan.append_alloc(m)
            plan.gang_groups[f"{job.id}/web"] = [m.id for m in members]
        plans.append(plan)
    return fsm, log, plans


def result_view(result):
    def ids(d):
        return {node: sorted(a.id for a in allocs)
                for node, allocs in d.items() if allocs}
    return (ids(result.node_allocation), ids(result.node_update),
            ids(result.node_preemptions), result.refresh_index,
            result.alloc_index > 0)


def run_plans(applier_cls, queue_cls, fsm, log, plans):
    queue = queue_cls()
    queue.set_enabled(True)
    applier = applier_cls(queue, fsm, log, pool_size=2)
    applier.start()
    try:
        out = [result_view(queue.enqueue(p).wait(timeout=20.0))
               for p in plans]
    finally:
        applier.stop()
    return out, applier.stats()


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_plan_applier_results_equal_on_the_same_plans(seed):
    from nomad_tpu.server.plan_apply import PlanApplier as RefApplier
    from nomad_tpu.server.plan_queue import PlanQueue as RefQueue
    from nomad_tpu_torch.server.fsm import FSM, DevLog
    from nomad_tpu_torch.server.plan_apply import PlanApplier
    from nomad_tpu_torch.server.plan_queue import PlanQueue

    ref_fsm, ref_log, plans = applier_world(seed)
    fsm = FSM()
    fsm.restore(ref_fsm.snapshot_data())
    log = DevLog(fsm)
    log._index = ref_log.last_index()
    crossed = [port(p) for p in plans]
    want = run_plans(RefApplier, RefQueue, ref_fsm, ref_log, plans)
    got = run_plans(PlanApplier, PlanQueue, fsm, log, crossed)
    assert got == want
    assert want[1]["nodes_rejected"] > 0, "no plan lost a node"
    assert canon(fsm.state.persist()) == canon(ref_fsm.state.persist())


# ----------------------------------------------------------------- diff


def diff_pairs(seed: int):
    from nomad_tpu.structs.job import Constraint

    rng = random.Random(seed)
    old = mock.job()
    new = old.copy()
    new.priority = old.priority + rng.randint(1, 20)
    tg = new.task_groups[0]
    tg.count += rng.randint(1, 5)
    tg.tasks[0].resources.cpu += 100
    tg.tasks[0].env = {"A": "1", "B": str(seed)}
    new.meta = {"owner": f"team-{seed}"}
    new.constraints.append(Constraint(ltarget="${attr.kernel.name}",
                                      rtarget="linux", operand="="))
    extra = tg.copy()
    extra.name = "api"
    pairs = [(old, new), (None, new), (old, None), (old, old.copy())]
    grown = new.copy()
    grown.task_groups = grown.task_groups + [extra]
    pairs.append((new, grown))
    dropped = grown.copy()
    dropped.task_groups[0].tasks = dropped.task_groups[0].tasks[:0]
    pairs.append((grown, dropped))
    return pairs


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("contextual", [False, True])
def test_job_diffs_equal(seed, contextual):
    from nomad_tpu.structs.diff import job_diff as ref_diff
    from nomad_tpu_torch.structs.diff import job_diff

    for old, new in diff_pairs(seed):
        want = dataclasses.asdict(ref_diff(old, new, contextual=contextual))
        got = dataclasses.asdict(job_diff(
            None if old is None else port(old),
            None if new is None else port(new), contextual=contextual))
        assert got == want


def test_diff_annotations_equal():
    from nomad_tpu.structs.diff import annotate as ref_annotate
    from nomad_tpu.structs.diff import job_diff as ref_diff
    from nomad_tpu_torch.structs.diff import annotate, job_diff

    old, new = diff_pairs(0)[0]
    ann = PlanAnnotations(desired_tg_updates={"web": DesiredUpdates(
        place=3, stop=1, in_place_update=2)})
    want = ref_diff(old, new)
    ref_annotate(want, ann)
    got = job_diff(port(old), port(new))
    annotate(got, port(ann))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


# ------------------------------------------------------------- periodic


SPECS = ["* * * * *", "*/15 * * * *", "30 2 * * *", "0 9-17/2 * * 1-5",
         "5,35 */6 1,15 * *", "0 0 29 2 *", "0 0 * * 0"]


@pytest.mark.parametrize("spec", SPECS)
def test_periodic_launch_times_equal(spec):
    ref = PeriodicConfig(enabled=True, spec=spec)
    cfg = port(ref)
    t, u = 1_700_000_000.0, 1_700_000_000.0
    for _ in range(12):
        t, u = ref.next_launch(t), cfg.next_launch(u)
        assert u == t


def test_periodic_children_equal():
    from nomad_tpu.server.periodic import derive_job as ref_derive
    from nomad_tpu_torch.server.periodic import derive_job

    parent = mock.job()
    parent.id = "nightly"
    parent.periodic = PeriodicConfig(enabled=True, spec="0 3 * * *")
    for launch in (1_700_000_000.0, 1_700_086_400.5):
        want = to_dict(ref_derive(parent, launch))
        assert to_dict(derive_job(port(parent), launch)) == want


# ------------------------------------------------------------------- GC


class _GcServer:
    """What CoreScheduler reads of its server: the config, the FSM's
    store and time table; the reaps it asks for are recorded."""

    def __init__(self, config, fsm):
        self.config = config
        self.fsm = fsm
        self.calls = []

    def eval_reap(self, eval_ids, alloc_ids):
        self.calls.append(("eval_reap", sorted(eval_ids), sorted(alloc_ids)))

    def job_deregister(self, job_id, create_eval=True):
        self.calls.append(("job_deregister", job_id, create_eval))

    def node_deregister(self, node_id):
        self.calls.append(("node_deregister", node_id))


def gc_world(seed: int):
    from nomad_tpu.server.fsm import FSM as RefFSM
    from nomad_tpu.server.fsm import DevLog as RefLog

    rng = random.Random(seed)
    fsm = RefFSM()
    log = RefLog(fsm)
    nodes = [mock.node() for _ in range(5)]
    for node in nodes:
        log.apply("node_register", {"node": node})
    for node in nodes[:3]:
        log.apply("node_update_status", {"node_id": node.id,
                                          "status": consts.NODE_STATUS_DOWN})
    for j in range(5):
        job = mock.job()
        job.id = f"gc-job-{j}"
        log.apply("job_register", {"job": job})
        ev = mock.eval()
        ev.id = f"gc-ev-{j}"
        ev.job_id = job.id
        ev.status = rng.choice([consts.EVAL_STATUS_COMPLETE,
                                consts.EVAL_STATUS_PENDING])
        log.apply("eval_update", {"evals": [ev], "token": ""})
        alloc = mock.alloc()
        alloc.id = f"gc-alloc-{j}"
        alloc.job_id = job.id
        alloc.job = job
        alloc.eval_id = ev.id
        alloc.node_id = nodes[j % len(nodes)].id
        alloc.desired_status = rng.choice([consts.ALLOC_DESIRED_RUN,
                                           consts.ALLOC_DESIRED_STOP])
        alloc.client_status = (
            consts.ALLOC_CLIENT_COMPLETE
            if alloc.desired_status == consts.ALLOC_DESIRED_STOP
            else consts.ALLOC_CLIENT_RUNNING)
        log.apply("alloc_update", {"allocs": [alloc]})
        if rng.random() < 0.5:
            log.apply("job_deregister", {"job_id": job.id})
    return fsm


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("core_job", ["eval-gc", "job-gc", "node-gc",
                                      "force-gc"])
def test_core_gc_picks_equal(seed, core_job):
    from nomad_tpu.server.config import ServerConfig as RefConfig
    from nomad_tpu.server.core_gc import CoreScheduler as RefCore
    from nomad_tpu_torch.server.config import ServerConfig
    from nomad_tpu_torch.server.core_gc import CoreScheduler
    from nomad_tpu_torch.server.fsm import FSM

    ref_fsm = gc_world(seed)
    fsm = FSM()
    fsm.restore(ref_fsm.snapshot_data())
    # Thresholds of 0 s put every index behind the cut-off: the time
    # table maps "now" to the same index in both packages.
    zero = dict(eval_gc_threshold=0.0, job_gc_threshold=0.0,
                node_gc_threshold=0.0)
    kinds = {"eval-gc": consts.CORE_JOB_EVAL_GC,
             "job-gc": consts.CORE_JOB_JOB_GC,
             "node-gc": consts.CORE_JOB_NODE_GC,
             "force-gc": consts.CORE_JOB_FORCE_GC}
    ev = mock.eval()
    ev.job_id = kinds[core_job]
    ev.type = consts.JOB_TYPE_CORE
    for i in range(1, ref_fsm.last_applied_index + 1):
        ref_fsm.timetable.witness(i)
        fsm.timetable.witness(i)
    ref_server = _GcServer(RefConfig(**zero), ref_fsm)
    server = _GcServer(ServerConfig(**zero), fsm)
    RefCore(None, ref_fsm.state.snapshot(), None,
            server=ref_server).process_eval(ev)
    CoreScheduler(None, fsm.state.snapshot(), None,
                  server=server).process_eval(port(ev))
    assert server.calls == ref_server.calls
    if core_job == "force-gc":
        assert ref_server.calls, "force GC reaped nothing"


# ------------------------------------------------------------ admission


def pressure_grid():
    rng = random.Random(7)
    for _ in range(40):
        yield dict(
            ready=rng.choice([0, 10, 200, 900, 2000]),
            unacked=rng.choice([0, 50, 300]),
            blocked=rng.choice([0, 100, 800]),
            in_flight=rng.choice([0, 1, 2]),
            pending=rng.choice([0, 10, 64, 130]),
            cap=rng.choice([0, 100, 1000]),
        )


def stub(cfg, inputs):
    from types import SimpleNamespace

    ready = inputs["ready"]
    broker = SimpleNamespace(stats=lambda: {
        "ready_by_queue": {"service": ready} if ready else {},
        "total_ready": ready, "total_unacked": inputs["unacked"],
        "total_blocked": inputs["blocked"], "total_waiting": 0,
        "dead_lettered": 0, "shed": 0, "expired": 0})
    dispatch = SimpleNamespace(
        stats=lambda: {"enabled": True, "in_flight": inputs["in_flight"],
                       "pending": inputs["pending"], "max_batch": 64},
        max_inflight=2)
    return SimpleNamespace(config=cfg, broker=broker, dispatch=dispatch)


def test_admission_levels_and_verdicts_equal():
    from nomad_tpu.admission import AdmissionController as RefController
    from nomad_tpu.admission import AdmissionRejected as RefRejected
    from nomad_tpu.server.config import ServerConfig as RefConfig
    from nomad_tpu_torch.admission import (
        AdmissionController,
        AdmissionRejected,
    )
    from nomad_tpu_torch.server.config import ServerConfig

    requests = [("PUT", "/v1/jobs", ""), ("GET", "/v1/jobs", ""),
                ("POST", "/v1/node/x/heartbeat", "node_heartbeat"),
                ("GET", "/v1/agent/self", ""), ("DELETE", "/v1/job/a", "")]
    levels = set()
    for inputs in pressure_grid():
        caps = {"eval_ready_cap": inputs["cap"]}
        ref = RefController(stub(RefConfig(**caps), inputs), RefConfig(**caps))
        ctl = AdmissionController(stub(ServerConfig(**caps), inputs),
                                  ServerConfig(**caps))
        want, got = ref.pressure.snapshot(), ctl.pressure.snapshot()
        for snap in (want, got):
            snap["inputs"].pop("lock_wait_p99_ms")
            snap["inputs"].pop("lock_wait_site")
            snap["inputs"].pop("e2e_p99_ms")
        assert got == want
        levels.add(want["level"])
        for method, path, handler in requests:
            outcome = []
            for c, exc in ((ref, RefRejected), (ctl, AdmissionRejected)):
                try:
                    outcome.append(("ok", c.check_http(method, path,
                                                        handler)))
                except exc as e:
                    outcome.append(("rejected", e.status))
            assert outcome[0] == outcome[1], (inputs, method, path)
    assert levels == {"green", "yellow", "red"}


@pytest.mark.parametrize("priority", [0, 10, 50, 70, 100])
def test_deadlines_equal(priority):
    from nomad_tpu.admission import deadline as ref_deadline
    from nomad_tpu_torch.admission import deadline

    assert deadline.priority_factor(priority) == \
        ref_deadline.priority_factor(priority)
    assert deadline.deadline_for(priority, 30.0, 1_000.0) == \
        ref_deadline.deadline_for(priority, 30.0, 1_000.0)
    ev = mock.eval()
    ev.priority = priority
    crossed = port(ev)
    ref_deadline.stamp(ev, 30.0, 1_000.0)
    deadline.stamp(crossed, 30.0, 1_000.0)
    assert crossed.deadline == ev.deadline


def test_vault_accessor_payloads_cross():
    """A task's vault block crosses with its job (the FSM entries above
    carry accessors); the stub authorities agree on policy checks."""
    from nomad_tpu.server.vault import StubVault as RefStub
    from nomad_tpu.server.vault import VaultError as RefError
    from nomad_tpu_torch.server.vault import StubVault, VaultError

    job = mock.job()
    job.task_groups[0].tasks[0].vault = Vault(policies=["db", "web"])
    assert port(job).task_groups[0].tasks[0].vault.policies == ["db", "web"]
    for policies in (["db"], ["root"], ["db", "other"], []):
        outcome = []
        for stub_cls, err in ((RefStub, RefError), (StubVault, VaultError)):
            vault = stub_cls(allowed_policies=["db", "web"])
            try:
                _token, _acc, ttl = vault.create_token(policies)
                outcome.append(("ok", ttl))
            except err as e:
                outcome.append(("error", str(e)))
        assert outcome[0] == outcome[1], policies
