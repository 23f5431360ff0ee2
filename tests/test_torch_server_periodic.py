"""The JAX package's tests/test_periodic_cron.py on the port.

Cron schedule + periodic dispatch tests (reference:
nomad/periodic.go:135 PeriodicDispatch, periodic_test.go, and the
cronexpr semantics structs.PeriodicConfig.Next relies on)."""

import torch_parity  # noqa: F401  (the port on the CPU)
import time

import pytest

from nomad_tpu_torch import mock
from nomad_tpu_torch.server import Server, ServerConfig
from nomad_tpu_torch.server.periodic import derive_job
from nomad_tpu_torch.structs import PeriodicConfig, consts
from nomad_tpu_torch.utils.cron import CronSchedule


def wait_until(fn, timeout=8.0, interval=0.05):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if fn():
            return True
        time.sleep(interval)
    return False


def at(y, mo, d, h, mi):
    return time.mktime((y, mo, d, h, mi, 0, 0, 0, -1))


class TestCronSchedule:
    def test_every_minute(self):
        s = CronSchedule("* * * * *")
        t = at(2026, 7, 30, 12, 0)
        assert s.next_after(t) == at(2026, 7, 30, 12, 1)

    def test_step_minutes(self):
        s = CronSchedule("*/15 * * * *")
        assert s.next_after(at(2026, 7, 30, 12, 1)) == at(2026, 7, 30, 12, 15)
        assert s.next_after(at(2026, 7, 30, 12, 46)) == at(2026, 7, 30, 13, 0)

    def test_fixed_daily_time(self):
        s = CronSchedule("30 3 * * *")
        assert s.next_after(at(2026, 7, 30, 4, 0)) == at(2026, 7, 31, 3, 30)
        assert s.next_after(at(2026, 7, 30, 2, 0)) == at(2026, 7, 30, 3, 30)

    def test_lists_and_ranges(self):
        s = CronSchedule("0 9-11,14 * * *")
        assert s.next_after(at(2026, 7, 30, 9, 30)) == at(2026, 7, 30, 10, 0)
        assert s.next_after(at(2026, 7, 30, 12, 0)) == at(2026, 7, 30, 14, 0)

    def test_day_of_week(self):
        # 2026-07-30 is a Thursday; next Monday (dow 1) is 2026-08-03.
        s = CronSchedule("0 0 * * 1")
        assert s.next_after(at(2026, 7, 30, 1, 0)) == at(2026, 8, 3, 0, 0)

    def test_dom_dow_either_matches(self):
        # Standard cron: restricted dom AND dow -> either matches.
        # July 31 (dom) OR next Monday Aug 3 — dom comes first.
        s = CronSchedule("0 0 31 * 1")
        assert s.next_after(at(2026, 7, 30, 1, 0)) == at(2026, 7, 31, 0, 0)

    def test_month_rollover(self):
        s = CronSchedule("0 0 1 9 *")  # Sept 1st
        assert s.next_after(at(2026, 7, 30, 0, 0)) == at(2026, 9, 1, 0, 0)

    def test_invalid_specs_rejected(self):
        for bad in ("* * * *", "61 * * * *", "*/0 * * * *", "x * * * *"):
            with pytest.raises(ValueError):
                CronSchedule(bad)


class TestPeriodicDispatch:
    def periodic_job(self, spec="* * * * *"):
        job = mock.job()
        job.periodic = PeriodicConfig(enabled=True, spec=spec)
        job.type = "batch"
        return job

    def test_derive_job_naming(self):
        """Child ids are <parent>/periodic-<epoch> (periodic.go:400)."""
        parent = self.periodic_job()
        launch = at(2026, 7, 30, 12, 0)
        child = derive_job(parent, launch)
        assert child.id == f"{parent.id}/periodic-{int(launch)}"
        assert child.parent_id == parent.id
        assert child.periodic is None  # children are not periodic

    def test_register_tracks_and_force_runs(self):
        server = Server(ServerConfig(num_schedulers=0))
        server.start()
        try:
            job = self.periodic_job(spec="0 0 1 1 *")  # far future
            server.job_register(job)
            assert any(j.id == job.id for j in server.periodic.tracked())
            # Periodic parents get no immediate eval; force creates the
            # child + its eval (Periodic.Force endpoint).
            child_id = server.periodic.force_run(job.id)
            assert child_id and child_id.startswith(f"{job.id}/periodic-")
            child = server.fsm.state.job_by_id(child_id)
            assert child is not None and child.parent_id == job.id
            assert server.fsm.state.evals_by_job(child_id)
        finally:
            server.shutdown()

    def test_deregister_untracks(self):
        server = Server(ServerConfig(num_schedulers=0))
        server.start()
        try:
            job = self.periodic_job(spec="0 0 1 1 *")
            server.job_register(job)
            server.job_deregister(job.id)
            assert not any(j.id == job.id for j in server.periodic.tracked())
        finally:
            server.shutdown()

    def test_leader_loss_stops_dispatch(self):
        server = Server(ServerConfig(num_schedulers=0))
        server.start()
        try:
            job = self.periodic_job(spec="0 0 1 1 *")
            server.job_register(job)
            server.revoke_leadership()
            assert not server.periodic.tracked()
            # Re-election restores tracking from state (leader.go
            # restore semantics).
            server.establish_leadership()
            assert wait_until(lambda: any(
                j.id == job.id for j in server.periodic.tracked()))
        finally:
            server.shutdown()


# ---------------------------------------------------------------------
# schedule firing, overlap policy, and GC of terminal children (the
# periodic/GC promotion satellite of the churn PR)


class FastPeriodic:
    """Duck-typed PeriodicConfig whose next launch is sub-second, so
    the real heap-driven dispatch loop fires inside a test (cron specs
    are minute-granular). Registered through the raw log apply — the
    HTTP validate path only accepts cron specs, the FSM hook does not
    care."""

    enabled = True
    spec = "* * * * *"
    spec_type = "cron"

    def __init__(self, interval=0.25, prohibit_overlap=False):
        self.interval = interval
        self.prohibit_overlap = prohibit_overlap

    def next_launch(self, after):
        return after + self.interval

    def validate(self):
        return []


def _fast_periodic_job(interval=0.25, prohibit_overlap=False):
    job = mock.job()
    job.type = "batch"
    job.periodic = FastPeriodic(interval, prohibit_overlap)
    return job


def _children(server, parent_id):
    return [j for j in server.fsm.state.jobs() if j.parent_id == parent_id]


def test_schedule_firing_mints_children_through_eval_funnel():
    """The heap loop fires on schedule: children derive with the
    launch-time id, each child's eval is minted through the
    eval_update funnel (it lands in the state store AND the broker),
    and the periodic_launch table records the launch."""
    server = Server(ServerConfig(num_schedulers=0))
    server.start()
    try:
        job = _fast_periodic_job(interval=0.25)
        server.log.apply("job_register", {"job": job})
        assert wait_until(lambda: len(_children(server, job.id)) >= 2,
                          8.0), _children(server, job.id)
        kids = _children(server, job.id)
        for child in kids:
            assert child.id.startswith(f"{job.id}/periodic-")
            assert child.periodic is None
            evs = server.fsm.state.evals_by_job(child.id)
            assert evs, child.id  # funnel-committed eval
            assert all(e.triggered_by == consts.EVAL_TRIGGER_PERIODIC_JOB
                       for e in evs)
        launch = server.fsm.state.periodic_launch_by_id(job.id)
        assert launch is not None and launch.launch > 0
    finally:
        server.shutdown()


def test_prohibit_overlap_skips_while_child_lives():
    """With prohibit_overlap, a non-terminal child suppresses further
    launches; letting the child die releases the schedule."""
    server = Server(ServerConfig(num_schedulers=0))
    server.start()
    try:
        job = _fast_periodic_job(interval=0.2, prohibit_overlap=True)
        server.log.apply("job_register", {"job": job})
        assert wait_until(lambda: len(_children(server, job.id)) == 1, 8.0)
        # the child's eval is pending (no schedulers) -> child stays
        # non-dead -> every further tick is skipped
        time.sleep(0.8)
        kids = _children(server, job.id)
        assert len(kids) == 1, [j.id for j in kids]
        # complete the child's eval: the child goes dead, the next
        # tick launches again
        ev = server.fsm.state.evals_by_job(kids[0].id)[0].copy()
        ev.status = consts.EVAL_STATUS_COMPLETE
        server.log.apply("eval_update", {"evals": [ev]})
        assert wait_until(lambda: len(_children(server, job.id)) >= 2, 8.0)
    finally:
        server.shutdown()


def test_core_gc_reaps_terminal_periodic_children_not_parent():
    """Job GC collects dead children (terminal evals, no allocs) while
    the periodic parent lives until deregistered."""
    # One worker scoped to `_core` only: force_gc rides a core eval
    # through the normal broker path, while the children's batch evals
    # stay where this test puts them.
    server = Server(ServerConfig(num_schedulers=1,
                                 enabled_schedulers=["_core"]))
    server.start()
    try:
        job = _fast_periodic_job(interval=0.25)
        server.log.apply("job_register", {"job": job})
        assert wait_until(lambda: len(_children(server, job.id)) >= 1, 8.0)
        # stop the clock: deregistering would untrack; instead disable
        # dispatch so the child set is stable while we GC
        server.periodic.remove(job.id)
        time.sleep(0.3)  # let any in-flight dispatch land

        def complete_all():
            kids_now = _children(server, job.id)
            for child in kids_now:
                for ev in server.fsm.state.evals_by_job(child.id):
                    if ev.terminal_status():
                        continue
                    upd = ev.copy()
                    upd.status = consts.EVAL_STATUS_COMPLETE
                    server.log.apply("eval_update", {"evals": [upd]})
            return all(j.status == consts.JOB_STATUS_DEAD
                       for j in _children(server, job.id))

        assert wait_until(complete_all, 8.0)
        kids = _children(server, job.id)
        server.force_gc()
        assert wait_until(
            lambda: not _children(server, job.id), 8.0), (
                [j.id for j in _children(server, job.id)])
        # every child's evals went with it; the parent survives
        for child in kids:
            assert server.fsm.state.evals_by_job(child.id) == []
        assert server.fsm.state.job_by_id(job.id) is not None
    finally:
        server.shutdown()
