"""Multi-server clusters of the port's Server over raft (the cluster
cases of tests/test_raft.py, with the port's MockClient): election and
scheduling with writes registered through a follower, leader failover
restoring the leader-only services, pending evals surviving failover,
the durable log restoring jobs, and a follower restored by
InstallSnapshot placing its next eval on a fresh base."""

import time

import torch_parity  # noqa: F401  (the port on the CPU)
from torch_server import MockClient

from nomad_tpu_torch import mock
from nomad_tpu_torch.models import matrix
from nomad_tpu_torch.server import Server, ServerConfig
from nomad_tpu_torch.server.raft import InmemTransport
from nomad_tpu_torch.structs import consts

WAIT = 25.0


def wait_until(fn, timeout=WAIT, interval=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if fn():
            return True
        time.sleep(interval)
    return False


def make_server_cluster(n=3, data_dirs=None, snapshot_threshold=1024,
                        **cfg_kwargs):
    transport = InmemTransport()
    cluster = {}
    ids = [f"s{i}" for i in range(n)]
    servers = []
    cfg_kwargs.setdefault("num_schedulers", 1)
    for i, node_id in enumerate(ids):
        cfg = ServerConfig(eval_nack_timeout=5.0, node_name=node_id,
                           **cfg_kwargs)
        server = Server(cfg)
        server.start_with_raft(
            node_id, ids, transport, cluster,
            data_dir=data_dirs[i] if data_dirs else "",
            snapshot_threshold=snapshot_threshold)
        servers.append(server)
    return transport, servers


def cluster_leader(servers):
    leaders = [s for s in servers if s.is_leader()]
    return leaders[0] if len(leaders) == 1 else None


def stable_leader(servers):
    """The leader once every server names it, its election barrier has
    committed, and it still leads a moment later (a boot can flap)."""
    def settled():
        leader = cluster_leader(servers)
        if leader is None or any(
                s.raft.leader_id != leader.node_id for s in servers):
            return None
        raft = leader.raft
        if raft.known_commit_index() < raft._term_start_index:
            return None
        return leader, raft.stats()["term"]

    while True:
        assert wait_until(lambda: settled() is not None)
        first = settled()
        time.sleep(0.5)
        if first is not None and settled() == first:
            return first[0]


def shutdown_all(servers):
    for s in servers:
        s.shutdown()


def test_cluster_elects_leader_and_schedules():
    transport, servers = make_server_cluster(3)
    try:
        assert wait_until(lambda: cluster_leader(servers) is not None)
        leader = cluster_leader(servers)
        follower = next(s for s in servers if not s.is_leader())

        client = MockClient(leader)
        client.start()
        try:
            # register via a FOLLOWER: the write forwards to the leader
            job = mock.job()
            job.task_groups[0].count = 3
            eval_id, _ = follower.job_register(job)
            assert wait_until(lambda: all(
                len(s.fsm.state.allocs_by_job(job.id)) == 3
                for s in servers))
            assert wait_until(lambda: all(
                s.fsm.state.eval_by_id(eval_id) is not None
                and s.fsm.state.eval_by_id(eval_id).status
                == consts.EVAL_STATUS_COMPLETE
                for s in servers))
            assert all(s.stats()["raft"]["leader"] == leader.node_id
                       for s in servers)
        finally:
            client.stop()
    finally:
        shutdown_all(servers)


def test_cluster_leader_failover_restores_services():
    transport, servers = make_server_cluster(3)
    try:
        assert wait_until(lambda: cluster_leader(servers) is not None)
        leader = cluster_leader(servers)

        client = MockClient(leader)
        client.start()
        job = mock.job()
        job.task_groups[0].count = 2
        leader.job_register(job)
        assert wait_until(
            lambda: len(leader.fsm.state.allocs_by_job(job.id)) == 2)
        client.stop()

        # kill the leader
        transport.disconnect(leader.node_id)
        remaining = [s for s in servers if s is not leader]
        assert wait_until(lambda: any(s.is_leader() for s in remaining))
        new_leader = next(s for s in remaining if s.is_leader())
        assert wait_until(lambda: new_leader.broker.enabled())

        # the new leader can schedule: register another job through it
        client2 = MockClient(new_leader)
        client2.start()
        try:
            job2 = mock.job()
            job2.task_groups[0].count = 1
            eval_id, _ = new_leader.job_register(job2)
            assert wait_until(
                lambda: (e := new_leader.fsm.state.eval_by_id(eval_id))
                is not None and e.status == consts.EVAL_STATUS_COMPLETE)
            assert len(new_leader.fsm.state.allocs_by_job(job2.id)) == 1
        finally:
            client2.stop()
    finally:
        shutdown_all(servers)


def test_cluster_pending_evals_restored_on_failover():
    """Evals committed but not yet processed must survive failover
    (leader.go:192 restoreEvals)."""
    transport, servers = make_server_cluster(3)
    try:
        assert wait_until(lambda: cluster_leader(servers) is not None)
        leader = cluster_leader(servers)
        # No nodes: the eval completes with a blocked eval outstanding.
        job = mock.job()
        job.task_groups[0].count = 3  # must fit one mock node post-failover
        leader.job_register(job)
        assert wait_until(lambda: any(
            e.status == consts.EVAL_STATUS_BLOCKED
            for e in leader.fsm.state.evals_by_job(job.id)))

        transport.disconnect(leader.node_id)
        remaining = [s for s in servers if s is not leader]
        assert wait_until(lambda: any(s.is_leader() for s in remaining))
        new_leader = next(s for s in remaining if s.is_leader())

        # the blocked eval is tracked by the new leader; a node joining
        # unblocks it and the job schedules
        client = MockClient(new_leader)
        client.start()
        try:
            assert wait_until(
                lambda: len(new_leader.fsm.state.allocs_by_job(job.id)) == 3)
        finally:
            client.stop()
    finally:
        shutdown_all(servers)


def test_cluster_raft_with_data_dir_restores_jobs(tmp_path):
    """Full server: jobs registered before a restart are still there
    after, via the durable raft log."""

    def boot(transport):
        server = Server(ServerConfig(num_schedulers=0, node_name="s1"))
        server.start_with_raft("s1", ["s1"], transport, {},
                               data_dir=str(tmp_path / "raft"),
                               snapshot_threshold=4)
        return server

    server = boot(InmemTransport())
    try:
        assert wait_until(server.is_leader)
        for i in range(6):
            job = mock.job()
            job.id = f"job-{i}"
            job.task_groups[0].count = 0
            server.job_register(job)
        assert server.fsm.state.job_by_id("job-5") is not None
    finally:
        server.shutdown()

    server2 = boot(InmemTransport())
    try:
        assert wait_until(server2.is_leader)
        assert wait_until(
            lambda: server2.fsm.state.job_by_id("job-5") is not None)
        assert server2.fsm.state.job_by_id("job-0") is not None
        assert server2.fsm.state.job_summary_by_id("job-0") is not None
    finally:
        server2.shutdown()


def test_follower_restored_by_snapshot_places_on_a_fresh_base(
        monkeypatch):
    """A follower cut off while the leader compacts its log catches up
    by InstallSnapshot: its FSM's store is replaced (a new store id),
    and the next eval its worker places through ``service-gpu`` builds
    its cluster base in full from the new store — never a delta of the
    base it built on the old one — and places on nodes that exist only
    in the restored state. The logs compact in memory every 8 applies
    (no data_dir: a snapshot file's fsync under the raft lock would
    stall heartbeats on a slow disk)."""
    builds = []
    resolve = matrix.resolve_cluster_base

    def recorded(state, *args, **kwargs):
        base, kind = resolve(state, *args, **kwargs)
        builds.append((getattr(state, "store_id", ""), kind))
        return base, kind

    monkeypatch.setattr(matrix, "resolve_cluster_base", recorded)
    transport, servers = make_server_cluster(
        3, eval_batch_size=1,
        scheduler_factories={"service": "service-gpu"})
    for s in servers:
        s.raft.snapshot_threshold = 8
    try:
        leader = stable_leader(servers)
        lagger = next(s for s in servers if s is not leader)
        # Only the lagger's worker schedules: the others park (outside
        # any broker dequeue) before the first eval is registered.
        others = [w for s in servers if s is not lagger for w in s.workers]
        for w in others:
            w.set_pause(True)
        assert wait_until(lambda: all(w.parked() for w in others))

        def place(count, nodes):
            job = mock.job()
            job.task_groups[0].count = count
            eval_id, _ = leader.job_register(job)
            assert wait_until(lambda: (
                e := lagger.fsm.state.eval_by_id(eval_id)) is not None
                and e.status == consts.EVAL_STATUS_COMPLETE)
            placed = lagger.fsm.state.allocs_by_job(job.id)
            assert len(placed) == count
            assert {a.node_id for a in placed} <= nodes

        first = [mock.node() for _ in range(2)]
        for n in first:
            leader.node_register(n)
        place(4, {n.id for n in first})
        old_store = lagger.fsm.state.store_id
        assert (old_store, "full") in builds, builds

        transport.disconnect(lagger.node_id)
        # The old nodes go down; new ones arrive; enough entries for the
        # leader to compact past what the lagger holds.
        for n in first:
            leader.node_update_status(n.id, consts.NODE_STATUS_DOWN)
        fresh = [mock.node() for _ in range(12)]
        for n in fresh:
            leader.node_register(n)
        assert wait_until(lambda: leader.raft.log_offset
                          > lagger.raft.last_index())
        del builds[:]
        transport.reconnect(lagger.node_id)
        assert wait_until(lambda: lagger.fsm.state.store_id != old_store
                          and all(lagger.fsm.state.node_by_id(n.id)
                                  for n in fresh))
        assert lagger.raft.log_offset >= 8  # the snapshot was installed
        new_store = lagger.fsm.state.store_id

        place(5, {n.id for n in fresh})
        mine = [(sid, kind) for sid, kind in builds
                if sid in (old_store, new_store)]
        assert mine and mine[0] == (new_store, "full"), builds
        assert all(sid == new_store for sid, _ in mine), builds
    finally:
        shutdown_all(servers)


def test_followers_schedule_at_or_past_the_leaders_store_index():
    """In a cluster a follower's schedulers plan on a snapshot at or past
    the leader's store index (``snapshot_min_index``), so a redelivered
    eval sees what an earlier delivery committed; a dev-mode server and
    the leader itself need no more than the eval's own index. The index
    is the store's: raft's noops never reach it, so after an election an
    idle store would never reach raft's commit index. The servers run no
    scheduler, so that nothing dequeues the job's eval and commits past
    the index read here before the followers are asked."""
    dev = Server(ServerConfig(num_schedulers=0))
    assert dev.snapshot_min_index() == 0
    dev.shutdown()
    transport, servers = make_server_cluster(3, num_schedulers=0)
    try:
        leader = stable_leader(servers)
        leader.job_register(mock.job())
        index = leader.fsm.state.latest_index()
        assert 0 < index <= leader.raft.known_commit_index()
        assert leader.snapshot_min_index() == 0
        for s in servers:
            if s is not leader:
                assert s.snapshot_min_index() == index
                assert wait_until(
                    lambda s=s: s.fsm.state.latest_index() >= index)
    finally:
        shutdown_all(servers)


def test_a_new_leader_applies_its_term_before_its_services_start():
    """The barrier before establish_leadership (leader.go leaderLoop):
    when a new leader restores the broker from its FSM, it has applied
    the noop that opened its term, and every entry before it."""
    transport, servers = make_server_cluster(3)
    seen = []
    for s in servers:
        establish = s.establish_leadership

        def recorded(s=s, establish=establish):
            seen.append((s.node_id, s.raft.last_index(),
                         s.raft._term_start_index, s.raft.state))
            return establish()

        s.establish_leadership = recorded
    try:
        leader = stable_leader(servers)
        for i in range(20):
            job = mock.job()
            job.task_groups[0].count = 0
            leader.job_register(job)
        del seen[:]
        transport.disconnect(leader.node_id)
        remaining = [s for s in servers if s is not leader]
        assert wait_until(lambda: any(s.is_leader() for s in remaining))
        new = next(s for s in remaining if s.is_leader())
        assert seen and seen[0][0] == new.node_id
        _, applied, term_start, state = seen[0]
        assert state == "leader" and applied >= term_start > 0
        assert new.fsm.state.job_by_id(job.id) is not None
    finally:
        shutdown_all(servers)


def test_a_retry_snapshot_covers_the_plans_partial_commit():
    """A rejected plan's retry waits for its FSM to reach the index of
    the part that committed, not only the applier's refresh index: on a
    raft follower the commit lands in the FSM after plan_submit
    returns, and a retry on a snapshot without it would place those
    allocs twice."""
    from types import SimpleNamespace

    from nomad_tpu_torch.server.worker import EvalSession, refresh_index
    from nomad_tpu_torch.structs import Plan, PlanResult

    assert refresh_index(PlanResult(refresh_index=5, alloc_index=9)) == 9
    assert refresh_index(PlanResult(refresh_index=7, alloc_index=0)) == 7
    waited = []
    server = SimpleNamespace(
        config=ServerConfig(),
        plan_submit=lambda plan: PlanResult(refresh_index=5, alloc_index=9),
        eval_pause_nack=lambda *a: None, eval_resume_nack=lambda *a: None,
        fsm=SimpleNamespace(state=SimpleNamespace(snapshot=lambda: "fresh")))
    worker = SimpleNamespace(
        server=server,
        _wait_for_index=lambda index, timeout: waited.append(index) or True)
    session = EvalSession(worker, mock.eval(), "token")
    result, state = session.submit_plan(Plan(eval_id="e"))
    assert waited == [9] and state == "fresh"
