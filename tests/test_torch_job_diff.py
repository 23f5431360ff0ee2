"""The JAX package's tests/test_job_diff.py on the port.

Structural job diff + annotate (reference nomad/structs/diff.go,
scheduler/annotate.go) and the plan -> run -check-index gate
(nomad/job_endpoint.go:60-79)."""

import torch_parity  # noqa: F401  (the port on the CPU)
import pytest

from nomad_tpu_torch import mock
from nomad_tpu_torch.structs.diff import (
    DIFF_ADDED,
    DIFF_DELETED,
    DIFF_EDITED,
    DIFF_NONE,
    annotate,
    job_diff,
)
from nomad_tpu_torch.structs.job import Constraint, Task, TaskGroup
from nomad_tpu_torch.structs.resources import Resources


def test_no_change_is_none():
    job = mock.job()
    d = job_diff(job, job.copy())
    assert d.type == DIFF_NONE
    assert d.fields == []
    assert d.task_groups == []


def test_new_job_is_added():
    job = mock.job()
    d = job_diff(None, job)
    assert d.type == DIFF_ADDED
    assert d.id == job.id
    assert all(tg.type == DIFF_ADDED for tg in d.task_groups)


def test_deleted_job():
    job = mock.job()
    d = job_diff(job, None)
    assert d.type == DIFF_DELETED


def test_scalar_field_edit():
    old = mock.job()
    new = old.copy()
    new.priority = 90
    d = job_diff(old, new)
    assert d.type == DIFF_EDITED
    fd = {f.name: f for f in d.fields}
    assert fd["priority"].type == DIFF_EDITED
    assert fd["priority"].old == "50" and fd["priority"].new == "90"


def test_count_change_marks_group_edited():
    old = mock.job()
    new = old.copy()
    new.task_groups[0].count += 3
    d = job_diff(old, new)
    assert len(d.task_groups) == 1
    tgd = d.task_groups[0]
    assert tgd.type == DIFF_EDITED
    counts = {f.name: (f.old, f.new) for f in tgd.fields}
    assert counts["count"] == (str(old.task_groups[0].count), str(new.task_groups[0].count))


def test_task_added_and_deleted():
    old = mock.job()
    new = old.copy()
    t = Task(name="sidecar", driver="mock", resources=Resources(cpu=100, memory_mb=64))
    new.task_groups[0].tasks.append(t)
    d = job_diff(old, new)
    tasks = {td.name: td for td in d.task_groups[0].tasks}
    assert tasks["sidecar"].type == DIFF_ADDED
    assert "forces create" in tasks["sidecar"].annotations

    d2 = job_diff(new, old)
    tasks2 = {td.name: td for td in d2.task_groups[0].tasks}
    assert tasks2["sidecar"].type == DIFF_DELETED
    assert "forces destroy" in tasks2["sidecar"].annotations


def test_constraint_set_diff():
    old = mock.job()
    new = old.copy()
    new.constraints.append(Constraint("${attr.cpu.arch}", "amd64", "="))
    d = job_diff(old, new)
    names = [(o.name, o.type) for o in d.objects]
    assert ("constraints", DIFF_ADDED) in names


def test_meta_map_diff():
    old = mock.job()
    new = old.copy()
    new.meta["team"] = "team-x"
    d = job_diff(old, new)
    meta = [o for o in d.objects if o.name == "meta"]
    assert meta
    by_name = {f.name: f for f in meta[0].fields}
    assert by_name["meta[team]"].type == DIFF_ADDED


def test_group_added():
    old = mock.job()
    new = old.copy()
    tg = TaskGroup(name="extra", count=2, tasks=[
        Task(name="t", driver="mock", resources=Resources())
    ])
    new.task_groups.append(tg)
    d = job_diff(old, new)
    by_name = {t.name: t for t in d.task_groups}
    assert by_name["extra"].type == DIFF_ADDED


def test_diff_rejects_different_ids():
    a, b = mock.job(), mock.job()
    with pytest.raises(ValueError):
        job_diff(a, b)


def test_annotate_merges_plan_counts():
    job = mock.job()
    new = job.copy()
    new.task_groups[0].count += 1
    d = job_diff(job, new)

    class FakeAnnotations:
        desired_tg_updates = {job.task_groups[0].name: {"place": 1, "ignore": 10}}

    annotate(d, FakeAnnotations())
    tgd = d.task_groups[0]
    assert tgd.updates["create"] == 1
    assert tgd.updates["ignore"] == 10


def test_nested_object_diff_resources():
    old = mock.job()
    new = old.copy()
    new.task_groups[0].tasks[0].resources.cpu += 250
    d = job_diff(old, new)
    td = d.task_groups[0].tasks[0]
    assert td.type == DIFF_EDITED
    res = [o for o in td.objects if o.name == "resources"]
    assert res and any(f.name == "cpu" and f.type == DIFF_EDITED for f in res[0].fields)


# --------------------------------------------------- enforce-index gate


def test_enforce_index_flow(tmp_path):
    from nomad_tpu_torch.server import Server, ServerConfig

    s = Server(ServerConfig(num_schedulers=0))
    s.start()
    try:
        job = mock.job()
        # Registering a brand-new job with index 0 succeeds...
        s.job_register(job.copy(), enforce_index=True, job_modify_index=0)
        stored = s.fsm.state.job_by_id(job.id)
        # ... re-registering with index 0 fails (job already exists).
        with pytest.raises(ValueError, match="already exists"):
            s.job_register(job.copy(), enforce_index=True, job_modify_index=0)
        # The stored modify index gates the update.
        with pytest.raises(ValueError, match="conflicting"):
            s.job_register(job.copy(), enforce_index=True,
                           job_modify_index=stored.job_modify_index + 7)
        s.job_register(job.copy(), enforce_index=True,
                       job_modify_index=stored.job_modify_index)
        # Unknown job with a nonzero index fails.
        other = mock.job()
        with pytest.raises(ValueError, match="does not exist"):
            s.job_register(other, enforce_index=True, job_modify_index=5)
    finally:
        s.shutdown()


def test_job_plan_returns_diff():
    from nomad_tpu_torch.server import Server, ServerConfig

    s = Server(ServerConfig(num_schedulers=0))
    s.start()
    try:
        for i in range(3):
            s.fsm.state.upsert_node(i + 1, mock.node())
        job = mock.job()
        s.job_register(job.copy())
        stored = s.fsm.state.job_by_id(job.id)

        new = job.copy()
        new.task_groups[0].count += 2
        result = s.job_plan(new, diff=True)
        assert result["job_modify_index"] == stored.job_modify_index
        d = result["diff"]
        assert d.type == DIFF_EDITED
        assert d.task_groups[0].updates.get("create", 0) >= 1

        # contextual (plan -verbose): unchanged fields are included too
        ctx = s.job_plan(job.copy(), diff=True, contextual=True)["diff"]
        assert any(f.type == DIFF_NONE for f in ctx.fields)
    finally:
        s.shutdown()
