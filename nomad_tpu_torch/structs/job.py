"""Job specification types: Job, TaskGroup, Task and sub-blocks.

Reference: nomad/structs/structs.go:1068 (Job), :1532 (TaskGroup),
:1923 (Task), :2719 (Constraint), :1320 (UpdateStrategy),
:1343 (PeriodicConfig), :1471 (RestartPolicy), :2771 (EphemeralDisk).
"""

from __future__ import annotations

import copy
import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from . import consts


@dataclass
class Constraint:
    ltarget: str = ""  # left-hand target, e.g. "${attr.kernel.name}"
    rtarget: str = ""  # right-hand target / literal
    operand: str = "="  # =, !=, <, <=, >, >=, version, regexp, distinct_hosts

    def copy(self) -> "Constraint":
        return Constraint(self.ltarget, self.rtarget, self.operand)

    def __str__(self) -> str:
        return f"{self.ltarget} {self.operand} {self.rtarget}"

    def validate(self) -> List[str]:
        errs = []
        if not self.operand:
            errs.append("missing constraint operand")
        if self.operand == consts.CONSTRAINT_REGEX:
            try:
                re.compile(self.rtarget)
            except re.error as e:
                errs.append(f"regular expression failed to compile: {e}")
        return errs


@dataclass
class LogConfig:
    max_files: int = 10
    max_file_size_mb: int = 10


@dataclass
class RestartPolicy:
    attempts: int = 0
    interval: float = 0.0  # seconds (reference uses time.Duration)
    delay: float = 0.0  # seconds
    mode: str = consts.RESTART_POLICY_MODE_FAIL

    def validate(self) -> List[str]:
        errs = []
        if self.mode not in (consts.RESTART_POLICY_MODE_DELAY, consts.RESTART_POLICY_MODE_FAIL):
            errs.append(f"unsupported restart mode: {self.mode!r}")
        if self.interval and self.attempts > 0 and self.interval < 5:
            errs.append("interval is too small")
        return errs


def default_service_restart_policy() -> RestartPolicy:
    return RestartPolicy(attempts=2, interval=60.0, delay=15.0, mode=consts.RESTART_POLICY_MODE_DELAY)


def default_batch_restart_policy() -> RestartPolicy:
    return RestartPolicy(attempts=15, interval=7 * 24 * 3600.0, delay=15.0, mode=consts.RESTART_POLICY_MODE_DELAY)


@dataclass
class EphemeralDisk:
    sticky: bool = False
    migrate: bool = False
    size_mb: int = 300


@dataclass
class ServiceCheck:
    name: str = ""
    type: str = ""  # http | tcp | script
    command: str = ""
    args: List[str] = field(default_factory=list)
    path: str = ""
    protocol: str = ""
    port_label: str = ""
    interval: float = 0.0
    timeout: float = 0.0
    initial_status: str = ""


@dataclass
class Service:
    name: str = ""
    port_label: str = ""
    tags: List[str] = field(default_factory=list)
    checks: List[ServiceCheck] = field(default_factory=list)


@dataclass
class Vault:
    policies: List[str] = field(default_factory=list)
    env: bool = True
    change_mode: str = "restart"
    change_signal: str = ""


@dataclass
class Template:
    source_path: str = ""
    dest_path: str = ""
    embedded_tmpl: str = ""
    change_mode: str = "restart"
    change_signal: str = ""
    splay: float = 5.0


@dataclass
class TaskArtifact:
    getter_source: str = ""
    getter_options: Dict[str, str] = field(default_factory=dict)
    relative_dest: str = ""


@dataclass
class DispatchPayloadConfig:
    file: str = ""


from .resources import Resources  # noqa: E402  (avoid circular import at top)


@dataclass
class Task:
    name: str = ""
    driver: str = ""
    user: str = ""
    config: Dict[str, Any] = field(default_factory=dict)
    env: Dict[str, str] = field(default_factory=dict)
    services: List[Service] = field(default_factory=list)
    vault: Optional[Vault] = None
    templates: List[Template] = field(default_factory=list)
    constraints: List[Constraint] = field(default_factory=list)
    resources: Optional[Resources] = None
    meta: Dict[str, str] = field(default_factory=dict)
    kill_timeout: float = 5.0
    log_config: Optional[LogConfig] = None
    artifacts: List[TaskArtifact] = field(default_factory=list)

    def copy(self) -> "Task":
        return copy.deepcopy(self)

    def canonicalize(self) -> None:
        if self.resources is None:
            self.resources = Resources()
        self.resources.canonicalize()
        if self.log_config is None:
            self.log_config = LogConfig()

    def validate(self) -> List[str]:
        errs = []
        if not self.name:
            errs.append("missing task name")
        elif re.search(r"[^a-zA-Z0-9\-_]", self.name):
            errs.append(f"task name {self.name!r} has invalid characters")
        if not self.driver:
            errs.append(f"task {self.name!r} missing driver")
        if self.resources is None:
            errs.append(f"task {self.name!r} missing resources")
        elif self.kill_timeout < 0:
            errs.append("kill_timeout must be positive")
        for c in self.constraints:
            if c.operand == consts.CONSTRAINT_DISTINCT_HOSTS:
                errs.append("task-level constraint must not be distinct_hosts")
            errs.extend(c.validate())
        return errs


GANG_TOPOLOGY_LEVELS = ("rack", "ici")


@dataclass
class Gang:
    """Gang-scheduling stanza (nomad_tpu/gang): a task group carrying
    one places its `count` members ATOMICALLY — all K or none, in one
    plan leg the applier verifies per node and commits in one raft
    apply. Topology policy (all levels name a node-meta key,
    models/topology.py):

    - ``slice``: hard contiguity — all K members land inside ONE
      topology group of this level (one rack / one ICI neighborhood),
      or the whole gang is unplaceable. Nodes missing the meta key can
      never prove contiguity and are excluded.
    - ``spread``: balance — members spread across groups of this
      level, at most ceil(K / eligible groups) per group.
    - ``affinity``: soft co-location — members prefer groups already
      holding gang members, without requiring a single slice.

    ``slice`` subsumes ``affinity`` and contradicts ``spread``;
    validation enforces the exclusivity."""

    slice: str = ""  # "" | "rack" | "ici"
    affinity: str = ""  # "" | "rack" | "ici"
    spread: str = ""  # "" | "rack" | "ici"

    def copy(self) -> "Gang":
        return Gang(self.slice, self.affinity, self.spread)

    def validate(self) -> List[str]:
        errs = []
        for label, level in (("slice", self.slice),
                             ("affinity", self.affinity),
                             ("spread", self.spread)):
            if level and level not in GANG_TOPOLOGY_LEVELS:
                errs.append(
                    f"gang {label} must be one of {GANG_TOPOLOGY_LEVELS},"
                    f" got {level!r}")
        if self.slice and self.spread:
            errs.append("gang slice and spread are mutually exclusive")
        if self.slice and self.affinity:
            errs.append(
                "gang affinity is redundant with slice (a slice is "
                "already maximally co-located)")
        if self.spread and self.affinity:
            errs.append(
                "gang spread and affinity are mutually exclusive "
                "(spread caps a group's members, affinity piles them "
                "in — pick one policy)")
        return errs


@dataclass
class TaskGroup:
    name: str = ""
    count: int = 1
    constraints: List[Constraint] = field(default_factory=list)
    restart_policy: Optional[RestartPolicy] = None
    tasks: List[Task] = field(default_factory=list)
    ephemeral_disk: Optional[EphemeralDisk] = None
    meta: Dict[str, str] = field(default_factory=dict)
    # All-or-nothing multi-node placement (nomad_tpu/gang). None =
    # ordinary independent placement.
    gang: Optional[Gang] = None

    def copy(self) -> "TaskGroup":
        return copy.deepcopy(self)

    def canonicalize(self, job: "Job") -> None:
        if self.count == 0:
            self.count = 1
        if self.ephemeral_disk is None:
            self.ephemeral_disk = EphemeralDisk()
        if self.restart_policy is None:
            if job.type == consts.JOB_TYPE_BATCH:
                self.restart_policy = default_batch_restart_policy()
            else:
                self.restart_policy = default_service_restart_policy()
        for t in self.tasks:
            t.canonicalize()

    def lookup_task(self, name: str) -> Optional[Task]:
        for t in self.tasks:
            if t.name == name:
                return t
        return None

    def validate(self) -> List[str]:
        errs = []
        if not self.name:
            errs.append("missing task group name")
        if self.count < 0:
            errs.append(f"group {self.name!r} count must be positive")
        if not self.tasks:
            errs.append(f"group {self.name!r} missing tasks")
        seen = set()
        for t in self.tasks:
            if t.name in seen:
                errs.append(f"group {self.name!r} has duplicate task {t.name!r}")
            seen.add(t.name)
            errs.extend(t.validate())
        for c in self.constraints:
            errs.extend(c.validate())
        if self.gang is not None:
            errs.extend(self.gang.validate())
        return errs


@dataclass
class UpdateStrategy:
    stagger: float = 0.0  # seconds between sets of updates
    max_parallel: int = 0  # number of concurrent destructive updates

    def rolling(self) -> bool:
        return self.stagger > 0 and self.max_parallel > 0


@dataclass
class PeriodicConfig:
    enabled: bool = False
    spec: str = ""  # cron expression
    spec_type: str = "cron"
    prohibit_overlap: bool = False

    def validate(self) -> List[str]:
        if not self.enabled:
            return []
        errs = []
        if self.spec_type != "cron":
            errs.append(f"unknown periodic spec type {self.spec_type!r}")
        elif not self.spec:
            errs.append("must specify a spec")
        else:
            from ..utils.cron import CronSchedule

            try:
                CronSchedule(self.spec)
            except ValueError as e:
                errs.append(f"invalid cron spec: {e}")
        return errs

    def next_launch(self, after: float) -> Optional[float]:
        """Next launch time (unix seconds) strictly after `after`."""
        if not self.enabled:
            return None
        from ..utils.cron import CronSchedule

        return CronSchedule(self.spec).next_after(after)


@dataclass
class JobSummary:
    job_id: str = ""
    summary: Dict[str, "TaskGroupSummary"] = field(default_factory=dict)
    create_index: int = 0
    modify_index: int = 0

    def copy(self) -> "JobSummary":
        # Flat dataclass of counters — field-wise copy keeps the
        # per-alloc summary update out of the deepcopy machinery.
        new = JobSummary.__new__(JobSummary)
        new.__dict__.update(self.__dict__)
        new.summary = {}
        for k, v in self.summary.items():
            tgs = TaskGroupSummary.__new__(TaskGroupSummary)
            tgs.__dict__.update(v.__dict__)
            new.summary[k] = tgs
        return new


@dataclass
class TaskGroupSummary:
    queued: int = 0
    complete: int = 0
    failed: int = 0
    running: int = 0
    starting: int = 0
    lost: int = 0


@dataclass
class Job:
    region: str = "global"
    id: str = ""
    parent_id: str = ""  # set on periodic children
    name: str = ""
    type: str = consts.JOB_TYPE_SERVICE
    priority: int = consts.JOB_DEFAULT_PRIORITY
    all_at_once: bool = False
    datacenters: List[str] = field(default_factory=list)
    constraints: List[Constraint] = field(default_factory=list)
    task_groups: List[TaskGroup] = field(default_factory=list)
    update: Optional[UpdateStrategy] = None
    periodic: Optional[PeriodicConfig] = None
    meta: Dict[str, str] = field(default_factory=dict)
    vault_token: str = ""
    status: str = ""
    status_description: str = ""
    create_index: int = 0
    modify_index: int = 0
    job_modify_index: int = 0  # bumped only on spec changes (structs.go:1155)

    def copy(self) -> "Job":
        return copy.deepcopy(self)

    def canonicalize(self) -> None:
        if not self.name:
            self.name = self.id
        for tg in self.task_groups:
            tg.canonicalize(self)

    def lookup_task_group(self, name: str) -> Optional[TaskGroup]:
        for tg in self.task_groups:
            if tg.name == name:
                return tg
        return None

    def is_periodic(self) -> bool:
        return self.periodic is not None and self.periodic.enabled

    def stopped(self) -> bool:
        return self.status == consts.JOB_STATUS_DEAD

    def validate(self) -> List[str]:
        errs = []
        if not self.region:
            errs.append("missing job region")
        if not self.id:
            errs.append("missing job ID")
        elif " " in self.id:
            errs.append("job ID contains a space")
        if not self.name:
            errs.append("missing job name")
        if self.type not in (consts.JOB_TYPE_SERVICE, consts.JOB_TYPE_BATCH, consts.JOB_TYPE_SYSTEM):
            errs.append(f"invalid job type: {self.type!r}")
        if not (consts.JOB_MIN_PRIORITY <= self.priority <= consts.JOB_MAX_PRIORITY):
            errs.append(
                f"job priority must be between [{consts.JOB_MIN_PRIORITY}, {consts.JOB_MAX_PRIORITY}]"
            )
        if not self.datacenters:
            errs.append("missing job datacenters")
        if not self.task_groups:
            errs.append("missing job task groups")
        seen = set()
        for tg in self.task_groups:
            if tg.name in seen:
                errs.append(f"job has duplicate task group {tg.name!r}")
            seen.add(tg.name)
            errs.extend(tg.validate())
        for c in self.constraints:
            errs.extend(c.validate())
        if self.type == consts.JOB_TYPE_SYSTEM:
            if self.periodic and self.periodic.enabled:
                errs.append("periodic is not allowed on system jobs")
            if any(tg.gang is not None for tg in self.task_groups):
                errs.append(
                    "gang is not allowed on system jobs (system "
                    "placements are pinned per node, never gangs)")
        if self.periodic:
            errs.extend(self.periodic.validate())
        return errs
