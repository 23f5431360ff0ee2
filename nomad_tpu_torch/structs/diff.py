"""Structural job diffs for `plan` dry-runs.

Reference: nomad/structs/diff.go:48-954 (Job.Diff / TaskGroup / Task /
ObjectDiff / FieldDiff) and scheduler/annotate.go:37 (merging plan
counts into the diff). The reference hand-writes a differ per struct;
here one recursive differ walks the dataclasses, which yields the same
diff shape (fields / nested objects / named-list matching) for every
type in the job tree.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from .job import Job, Task, TaskGroup

DIFF_NONE = "None"
DIFF_ADDED = "Added"
DIFF_DELETED = "Deleted"
DIFF_EDITED = "Edited"

# Fields that never belong in a user-facing spec diff.
_JOB_SKIP = {
    "id", "status", "status_description", "create_index", "modify_index",
    "job_modify_index", "vault_token", "task_groups", "parent_id",
}
_TG_SKIP = {"name", "tasks"}
_TASK_SKIP = {"name"}

# How to identify elements of a named object list when pairing old/new.
_LIST_KEYS = {
    "task_groups": "name",
    "tasks": "name",
    "services": "name",
    "checks": "name",
    "templates": "dest_path",
    "artifacts": "getter_source",
}


@dataclass
class FieldDiff:
    type: str = DIFF_NONE
    name: str = ""
    old: str = ""
    new: str = ""


@dataclass
class ObjectDiff:
    type: str = DIFF_NONE
    name: str = ""
    fields: List[FieldDiff] = field(default_factory=list)
    objects: List["ObjectDiff"] = field(default_factory=list)


@dataclass
class TaskDiff:
    type: str = DIFF_NONE
    name: str = ""
    fields: List[FieldDiff] = field(default_factory=list)
    objects: List[ObjectDiff] = field(default_factory=list)
    annotations: List[str] = field(default_factory=list)


@dataclass
class TaskGroupDiff:
    type: str = DIFF_NONE
    name: str = ""
    fields: List[FieldDiff] = field(default_factory=list)
    objects: List[ObjectDiff] = field(default_factory=list)
    tasks: List[TaskDiff] = field(default_factory=list)
    # Placement counts merged in by annotate() (scheduler/annotate.go:17-24):
    # create / destroy / migrate / in-place update / canary ...
    updates: Dict[str, int] = field(default_factory=dict)


@dataclass
class JobDiff:
    type: str = DIFF_NONE
    id: str = ""
    fields: List[FieldDiff] = field(default_factory=list)
    objects: List[ObjectDiff] = field(default_factory=list)
    task_groups: List[TaskGroupDiff] = field(default_factory=list)


def _is_scalar(v: Any) -> bool:
    return v is None or isinstance(v, (str, int, float, bool))


def _render(v: Any) -> str:
    if v is None:
        return ""
    if isinstance(v, bool):
        return "true" if v else "false"
    return str(v)


def _field_diff(name: str, old: Any, new: Any, contextual: bool) -> Optional[FieldDiff]:
    old_empty = old is None or old == "" or old == [] or old == {}
    new_empty = new is None or new == "" or new == [] or new == {}
    if old == new or (old_empty and new_empty):
        if contextual:
            return FieldDiff(DIFF_NONE, name, _render(old), _render(new))
        return None
    if old_empty:
        return FieldDiff(DIFF_ADDED, name, "", _render(new))
    if new_empty:
        return FieldDiff(DIFF_DELETED, name, _render(old), "")
    return FieldDiff(DIFF_EDITED, name, _render(old), _render(new))


def _map_diff(name: str, old: Dict, new: Dict, contextual: bool) -> Optional[ObjectDiff]:
    old = old or {}
    new = new or {}
    fields: List[FieldDiff] = []
    for k in sorted(set(old) | set(new)):
        fd = _field_diff(f"{name}[{k}]", old.get(k), new.get(k), contextual)
        if fd is not None:
            fields.append(fd)
    return _wrap_object(name, fields, [], old, new, contextual)


def _wrap_object(name: str, fields: List[FieldDiff], objects: List[ObjectDiff],
                 old: Any, new: Any, contextual: bool = False) -> Optional[ObjectDiff]:
    changed = ([f for f in fields if f.type != DIFF_NONE]
               or [o for o in objects if o.type != DIFF_NONE])
    if not changed:
        if contextual and (fields or objects):
            return ObjectDiff(DIFF_NONE, name, fields, objects)
        return None
    if old in (None, {}, []):
        typ = DIFF_ADDED
    elif new in (None, {}, []):
        typ = DIFF_DELETED
    else:
        typ = DIFF_EDITED
    return ObjectDiff(typ, name, fields, objects)


def _scalar_list_diff(name: str, old: List, new: List, contextual: bool) -> Optional[ObjectDiff]:
    old_set = set(map(str, old or []))
    new_set = set(map(str, new or []))
    fields: List[FieldDiff] = []
    for v in sorted(old_set | new_set):
        in_old, in_new = v in old_set, v in new_set
        if in_old and in_new:
            if contextual:
                fields.append(FieldDiff(DIFF_NONE, name, v, v))
        elif in_new:
            fields.append(FieldDiff(DIFF_ADDED, name, "", v))
        else:
            fields.append(FieldDiff(DIFF_DELETED, name, v, ""))
    return _wrap_object(name, fields, [], old, new, contextual)


def _object_set_diff(name: str, old: List, new: List) -> List[ObjectDiff]:
    """Set-style diff for unnamed object lists (constraints): elements
    are only ever Added or Deleted, never Edited (diff.go setDiff)."""
    out: List[ObjectDiff] = []
    old_strs = {_obj_repr(o): o for o in (old or [])}
    new_strs = {_obj_repr(o): o for o in (new or [])}
    for key in sorted(old_strs.keys() - new_strs.keys()):
        out.append(_obj_to_object_diff(name, old_strs[key], DIFF_DELETED))
    for key in sorted(new_strs.keys() - old_strs.keys()):
        out.append(_obj_to_object_diff(name, new_strs[key], DIFF_ADDED))
    return out


def _obj_repr(o: Any) -> str:
    if dataclasses.is_dataclass(o):
        return repr(dataclasses.astuple(o))
    return repr(o)


def _obj_to_object_diff(name: str, o: Any, typ: str) -> ObjectDiff:
    fields = []
    for f in dataclasses.fields(o):
        v = getattr(o, f.name)
        if _is_scalar(v):
            side = _render(v)
            fields.append(FieldDiff(
                typ, f.name,
                side if typ == DIFF_DELETED else "",
                side if typ == DIFF_ADDED else "",
            ))
    return ObjectDiff(typ, name, fields, [])


def _dataclass_diff(name: str, old: Any, new: Any, contextual: bool,
                    skip=frozenset()) -> tuple[List[FieldDiff], List[ObjectDiff]]:
    """Diff two same-typed dataclasses (either may be None) into flat
    field diffs plus nested object diffs."""
    template = old if old is not None else new
    fields: List[FieldDiff] = []
    objects: List[ObjectDiff] = []
    for f in dataclasses.fields(template):
        if f.name in skip:
            continue
        ov = getattr(old, f.name) if old is not None else None
        nv = getattr(new, f.name) if new is not None else None
        if _is_scalar(ov) and _is_scalar(nv):
            fd = _field_diff(f.name, ov, nv, contextual)
            if fd is not None:
                fields.append(fd)
        elif isinstance(ov or nv, dict):
            od = _map_diff(f.name, ov, nv, contextual)
            if od is not None:
                objects.append(od)
        elif isinstance(ov or nv, list):
            sample = (ov or nv)[0] if (ov or nv) else None
            if sample is None or _is_scalar(sample):
                od = _scalar_list_diff(f.name, ov, nv, contextual)
                if od is not None:
                    objects.append(od)
            elif f.name in _LIST_KEYS:
                objects.extend(_named_list_diff(f.name, ov, nv, contextual))
            else:
                objects.extend(_object_set_diff(f.name, ov, nv))
        elif dataclasses.is_dataclass(ov or nv):
            if ov == nv and not contextual:
                continue
            sub_f, sub_o = _dataclass_diff(f.name, ov, nv, contextual)
            od = _wrap_object(f.name, sub_f, sub_o, ov, nv, contextual)
            if od is not None:
                objects.append(od)
    return fields, objects


def _named_list_diff(name: str, old: List, new: List, contextual: bool) -> List[ObjectDiff]:
    key = _LIST_KEYS[name]
    singular = name[:-1] if name.endswith("s") else name
    old_by = {getattr(o, key): o for o in (old or [])}
    new_by = {getattr(o, key): o for o in (new or [])}
    out: List[ObjectDiff] = []
    for k in sorted(set(old_by) | set(new_by)):
        ov, nv = old_by.get(k), new_by.get(k)
        if ov == nv and not contextual:
            continue
        sub_f, sub_o = _dataclass_diff(singular, ov, nv, contextual)
        od = _wrap_object(f"{singular}[{k}]", sub_f, sub_o, ov, nv, contextual)
        if od is not None:
            out.append(od)
    return out


def _diff_type_of(old: Any, new: Any, fields, objects, children) -> str:
    if old is None and new is not None:
        return DIFF_ADDED
    if new is None and old is not None:
        return DIFF_DELETED
    changed = ([f for f in fields if f.type != DIFF_NONE] or objects
               or [c for c in children if c.type != DIFF_NONE])
    return DIFF_EDITED if changed else DIFF_NONE


def task_diff(old: Optional[Task], new: Optional[Task], contextual: bool = False) -> TaskDiff:
    template = old if old is not None else new
    fields, objects = _dataclass_diff("task", old, new, contextual, skip=_TASK_SKIP)
    d = TaskDiff(name=template.name if template else "", fields=fields, objects=objects)
    d.type = _diff_type_of(old, new, fields, objects, [])
    if d.type == DIFF_ADDED:
        d.annotations.append("forces create")
    elif d.type == DIFF_DELETED:
        d.annotations.append("forces destroy")
    return d


def task_group_diff(old: Optional[TaskGroup], new: Optional[TaskGroup],
                    contextual: bool = False) -> TaskGroupDiff:
    template = old if old is not None else new
    fields, objects = _dataclass_diff("group", old, new, contextual, skip=_TG_SKIP)
    old_tasks = {t.name: t for t in (old.tasks if old else [])}
    new_tasks = {t.name: t for t in (new.tasks if new else [])}
    tasks = []
    for name in sorted(set(old_tasks) | set(new_tasks)):
        td = task_diff(old_tasks.get(name), new_tasks.get(name), contextual)
        if td.type != DIFF_NONE or contextual:
            tasks.append(td)
    d = TaskGroupDiff(name=template.name if template else "",
                      fields=fields, objects=objects, tasks=tasks)
    d.type = _diff_type_of(old, new, fields, objects, tasks)
    return d


def job_diff(old: Optional[Job], new: Optional[Job], contextual: bool = False) -> JobDiff:
    """Job.Diff (diff.go:59): structural diff keyed by task-group and
    task name; index/status fields are excluded."""
    if old is not None and new is not None and old.id != new.id:
        raise ValueError("can not diff jobs with different IDs")
    template = old if old is not None else new
    fields, objects = _dataclass_diff("job", old, new, contextual, skip=_JOB_SKIP)
    old_tgs = {tg.name: tg for tg in (old.task_groups if old else [])}
    new_tgs = {tg.name: tg for tg in (new.task_groups if new else [])}
    tgs = []
    for name in sorted(set(old_tgs) | set(new_tgs)):
        tgd = task_group_diff(old_tgs.get(name), new_tgs.get(name), contextual)
        if tgd.type != DIFF_NONE or contextual:
            tgs.append(tgd)
    d = JobDiff(id=template.id if template else "",
                fields=fields, objects=objects, task_groups=tgs)
    d.type = _diff_type_of(old, new, fields, objects, tgs)
    return d


# --------------------------------------------------------------- annotate

UPDATE_TYPE_IGNORE = "ignore"
UPDATE_TYPE_CREATE = "create"
UPDATE_TYPE_DESTROY = "destroy"
UPDATE_TYPE_MIGRATE = "migrate"
UPDATE_TYPE_IN_PLACE = "in-place update"
UPDATE_TYPE_DESTRUCTIVE = "create/destroy update"


def annotate(diff: JobDiff, annotations) -> None:
    """Merge scheduler plan counts into the diff's per-group `updates`
    maps (scheduler/annotate.go:37). `annotations` is the plan's
    PlanAnnotations (desired_tg_updates: {tg: DesiredUpdates})."""
    if annotations is None:
        return
    desired = getattr(annotations, "desired_tg_updates", None) or {}
    by_name = {tg.name: tg for tg in diff.task_groups}
    for tg_name, du in desired.items():
        tgd = by_name.get(tg_name)
        if tgd is None:
            tgd = TaskGroupDiff(type=DIFF_NONE, name=tg_name)
            diff.task_groups.append(tgd)
            by_name[tg_name] = tgd
        counts = du if isinstance(du, dict) else dataclasses.asdict(du)
        mapping = {
            "ignore": UPDATE_TYPE_IGNORE,
            "place": UPDATE_TYPE_CREATE,
            "stop": UPDATE_TYPE_DESTROY,
            "migrate": UPDATE_TYPE_MIGRATE,
            "in_place_update": UPDATE_TYPE_IN_PLACE,
            "destructive_update": UPDATE_TYPE_DESTRUCTIVE,
        }
        for key, label in mapping.items():
            n = counts.get(key, 0)
            if n:
                tgd.updates[label] = tgd.updates.get(label, 0) + int(n)
