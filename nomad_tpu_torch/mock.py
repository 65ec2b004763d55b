"""Mock fixtures for tests and simulation (reference: nomad/mock/mock.go —
mock.Node(), mock.Job(), mock.Alloc(), mock.SystemJob(), mock.Eval())."""

from __future__ import annotations

from typing import Optional

from .structs.types import (
    AllocClientStatus,
    generate_uuid,
    AllocDesiredStatus,
    Allocation,
    DriverInfo,
    Evaluation,
    EvalTrigger,
    Job,
    JobType,
    Node,
    NodeResources,
    NodeReservedResources,
    Resources,
    Task,
    TaskGroup,
)


def node(**overrides) -> Node:
    n = Node(
        datacenter="dc1",
        node_class="linux-medium-pci",
        attributes={
            "kernel.name": "linux",
            "cpu.arch": "amd64",
            "os.name": "ubuntu",
            "os.version": "22.04",
            "driver.mock": "1",
        },
        resources=NodeResources(cpu=4000, memory_mb=8192, disk_mb=100 * 1024),
        reserved=NodeReservedResources(cpu=100, memory_mb=256),
        drivers={"mock": DriverInfo(detected=True, healthy=True)},
    )
    for k, v in overrides.items():
        setattr(n, k, v)
    return n


def job(**overrides) -> Job:
    j = Job(
        id=f"mock-service-{generate_uuid()[:8]}",
        name="my-job",
        type=JobType.SERVICE.value,
        priority=50,
        datacenters=["dc1"],
        task_groups=[
            TaskGroup(
                name="web",
                count=10,
                tasks=[
                    Task(
                        name="web",
                        driver="mock",
                        resources=Resources(cpu=500, memory_mb=256),
                    )
                ],
            )
        ],
    )
    for k, v in overrides.items():
        setattr(j, k, v)
    return j


def batch_job(**overrides) -> Job:
    j = job(**overrides)
    j.type = JobType.BATCH.value
    j.id = f"mock-batch-{generate_uuid()[:8]}"
    return j


def system_job(**overrides) -> Job:
    j = Job(
        id=f"mock-system-{generate_uuid()[:8]}",
        name="my-system-job",
        type=JobType.SYSTEM.value,
        priority=100,
        datacenters=["dc1"],
        task_groups=[
            TaskGroup(
                name="system",
                count=0,
                tasks=[
                    Task(
                        name="sys",
                        driver="mock",
                        resources=Resources(cpu=100, memory_mb=64),
                    )
                ],
            )
        ],
    )
    for k, v in overrides.items():
        setattr(j, k, v)
    return j


def eval_for(j: Job, **overrides) -> Evaluation:
    e = Evaluation(
        namespace=j.namespace,
        priority=j.priority,
        type=j.type,
        triggered_by=EvalTrigger.JOB_REGISTER.value,
        job_id=j.id,
    )
    for k, v in overrides.items():
        setattr(e, k, v)
    return e


def alloc(j: Optional[Job] = None, n: Optional[Node] = None, **overrides) -> Allocation:
    j = j if j is not None else job()
    tg = j.task_groups[0]
    a = Allocation(
        namespace=j.namespace,
        name=f"{j.id}.{tg.name}[0]",
        node_id=n.id if n else "",
        job_id=j.id,
        job=j,
        task_group=tg.name,
        resources=tg.combined_resources(),
        desired_status=AllocDesiredStatus.RUN.value,
        client_status=AllocClientStatus.RUNNING.value,
    )
    for k, v in overrides.items():
        setattr(a, k, v)
    return a
