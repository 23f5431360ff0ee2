"""Mock fixtures for tests and benchmarks.

Reference: nomad/mock/mock.go:9 (Node), :62 (Job), :157 (SystemJob),
:228 (Eval), :252 (Alloc) — same shapes: a 4GB/3.2GHz node with one
network, a service job with 10 web tasks, etc.
"""

from __future__ import annotations

from .structs import (
    AllocMetric,
    Allocation,
    Constraint,
    EphemeralDisk,
    Evaluation,
    Job,
    LogConfig,
    NetworkResource,
    Node,
    Port,
    Resources,
    RestartPolicy,
    Task,
    TaskGroup,
    UpdateStrategy,
    consts,
)
from .utils.ids import generate_uuid


def node() -> Node:
    n = Node(
        id=generate_uuid(),
        secret_id=generate_uuid(),
        datacenter="dc1",
        name="foobar",
        attributes={
            "kernel.name": "linux",
            "arch": "x86",
            "nomad.version": "0.5.0",
            "driver.exec": "1",
            "driver.mock_driver": "1",
        },
        resources=Resources(
            cpu=4000,
            memory_mb=8192,
            disk_mb=100 * 1024,
            iops=150,
            networks=[
                NetworkResource(
                    device="eth0",
                    cidr="192.168.0.100/32",
                    ip="192.168.0.100",
                    mbits=1000,
                )
            ],
        ),
        reserved=Resources(
            cpu=100,
            memory_mb=256,
            disk_mb=4 * 1024,
            networks=[
                NetworkResource(
                    device="eth0",
                    ip="192.168.0.100",
                    mbits=1,
                    reserved_ports=[Port("ssh", 22)],
                )
            ],
        ),
        links={"consul": "foobar.dc1"},
        meta={"pci-dss": "true"},
        node_class="linux-medium-pci",
        status=consts.NODE_STATUS_READY,
    )
    n.compute_class()
    return n


def job() -> Job:
    j = Job(
        region="global",
        id=generate_uuid(),
        name="my-job",
        type=consts.JOB_TYPE_SERVICE,
        priority=50,
        all_at_once=False,
        datacenters=["dc1"],
        constraints=[Constraint(ltarget="${attr.kernel.name}", rtarget="linux", operand="=")],
        task_groups=[
            TaskGroup(
                name="web",
                count=10,
                ephemeral_disk=EphemeralDisk(size_mb=150),
                restart_policy=RestartPolicy(
                    attempts=3, interval=10 * 60.0, delay=60.0, mode="delay"
                ),
                tasks=[
                    Task(
                        name="web",
                        driver="exec",
                        config={"command": "/bin/date"},
                        env={"FOO": "bar"},
                        log_config=LogConfig(),
                        resources=Resources(
                            cpu=500,
                            memory_mb=256,
                            networks=[
                                NetworkResource(
                                    mbits=50,
                                    dynamic_ports=[Port("http", 0), Port("admin", 0)],
                                )
                            ],
                        ),
                        meta={"foo": "bar"},
                    )
                ],
                meta={"elb_check_type": "http"},
            )
        ],
        meta={"owner": "armon"},
        status=consts.JOB_STATUS_PENDING,
        create_index=42,
        modify_index=99,
        job_modify_index=99,
    )
    j.canonicalize()
    return j


def system_job() -> Job:
    j = Job(
        region="global",
        id=generate_uuid(),
        name="my-job",
        type=consts.JOB_TYPE_SYSTEM,
        priority=100,
        all_at_once=False,
        datacenters=["dc1"],
        constraints=[Constraint(ltarget="${attr.kernel.name}", rtarget="linux", operand="=")],
        task_groups=[
            TaskGroup(
                name="web",
                count=1,
                restart_policy=RestartPolicy(
                    attempts=3, interval=10 * 60.0, delay=60.0, mode="delay"
                ),
                ephemeral_disk=EphemeralDisk(),
                tasks=[
                    Task(
                        name="web",
                        driver="exec",
                        config={"command": "/bin/date"},
                        env={},
                        log_config=LogConfig(),
                        resources=Resources(
                            cpu=500,
                            memory_mb=256,
                            networks=[NetworkResource(mbits=50, dynamic_ports=[Port("http", 0)])],
                        ),
                    )
                ],
            )
        ],
        meta={"owner": "armon"},
        status=consts.JOB_STATUS_PENDING,
        create_index=42,
        modify_index=99,
        job_modify_index=99,
    )
    j.canonicalize()
    return j


def batch_job() -> Job:
    j = job()
    j.type = consts.JOB_TYPE_BATCH
    for tg in j.task_groups:
        tg.restart_policy = RestartPolicy(attempts=0, interval=0.0, delay=0.0, mode="fail")
    return j


def eval() -> Evaluation:
    return Evaluation(
        id=generate_uuid(),
        priority=50,
        type=consts.JOB_TYPE_SERVICE,
        job_id=generate_uuid(),
        status=consts.EVAL_STATUS_PENDING,
    )


def alloc() -> Allocation:
    a = Allocation(
        id=generate_uuid(),
        eval_id=generate_uuid(),
        node_id="12345678-abcd-efab-cdef-123456789abc",
        task_group="web",
        resources=Resources(
            cpu=500,
            memory_mb=256,
            disk_mb=150,
            networks=[
                NetworkResource(
                    device="eth0",
                    ip="192.168.0.100",
                    mbits=50,
                    reserved_ports=[Port("main", 5000)],
                    dynamic_ports=[Port("http", 9876), Port("admin", 9877)],
                )
            ],
        ),
        task_resources={
            "web": Resources(
                cpu=500,
                memory_mb=256,
                networks=[
                    NetworkResource(
                        device="eth0",
                        ip="192.168.0.100",
                        mbits=50,
                        reserved_ports=[Port("main", 5000)],
                        dynamic_ports=[Port("http", 9876), Port("admin", 9877)],
                    )
                ],
            )
        },
        shared_resources=Resources(disk_mb=150),
        metrics=AllocMetric(),
        desired_status=consts.ALLOC_DESIRED_RUN,
        client_status=consts.ALLOC_CLIENT_PENDING,
    )
    j = job()
    a.job = j
    a.job_id = j.id
    a.name = f"{j.id}.web[0]"
    return a
