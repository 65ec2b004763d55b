"""HCL/JSON job structures → ``structs.Job`` (and back, for the API).

Reference: ``jobspec2/parse.go`` and the api/ job types. Durations accept
Go-style strings ("15s", "5m", "1h30m") or numbers (seconds).
"""

from __future__ import annotations

import json
import re
from typing import Any, Dict, List, Optional

from ..structs.types import (
    Affinity,
    Constraint,
    EphemeralDisk,
    Job,
    MigrateStrategy,
    NetworkResource,
    PeriodicConfig,
    RequestedDevice,
    ReschedulePolicy,
    Resources,
    RestartPolicy,
    ScalingPolicy,
    Service,
    Spread,
    SpreadTarget,
    Task,
    TaskGroup,
    UpdateStrategy,
    VolumeMount,
    VolumeRequest,
)
from .hcl import parse_hcl

_DURATION_RE = re.compile(r"(\d+(?:\.\d+)?)(ms|h|m|s)")
_DURATION_UNITS = {"h": 3600.0, "m": 60.0, "s": 1.0, "ms": 0.001}


def duration(value: Any, default: float = 0.0) -> float:
    """Go-style duration ("1h30m", "15s") or bare number (seconds)."""
    if value is None:
        return default
    if isinstance(value, (int, float)):
        return float(value)
    s = str(value).strip()
    total = 0.0
    matched = False
    for num, unit in _DURATION_RE.findall(s):
        total += float(num) * _DURATION_UNITS[unit]
        matched = True
    if not matched:
        try:
            return float(s)
        except ValueError:
            return default
    return total


def parse_job(src: str) -> Job:
    """Parse an HCL or JSON job spec into a Job."""
    stripped = src.lstrip()
    if stripped.startswith("{"):
        data = json.loads(src)
        if "Job" in data:
            data = data["Job"]
        if "job" in data and isinstance(data["job"], dict):
            return _job_from_hcl_tree(data["job"])
        return api_to_job(data)
    tree = parse_hcl(src)
    jobs = tree.get("job")
    if not jobs:
        raise ValueError("no job block found")
    return _job_from_hcl_tree(jobs)


def _one(block) -> Dict[str, Any]:
    """HCL trees store repeated bare blocks as lists; take the first."""
    if isinstance(block, list):
        return block[0]
    return block or {}


def _many(block) -> List[Dict[str, Any]]:
    if block is None:
        return []
    if isinstance(block, list):
        return block
    return [block]


def _labeled(block) -> List[tuple]:
    """(label, body) pairs from a labeled-block subtree, order preserved;
    a repeated label yields multiple pairs."""
    out = []
    for label, body in (block or {}).items():
        for b in _many(body):
            out.append((label, b))
    return out


def _job_from_hcl_tree(tree: Dict[str, Any]) -> Job:
    # job "name" { ... } parses to {name: body}
    if len(tree) == 1 and isinstance(next(iter(tree.values())), dict) and (
        "group" in next(iter(tree.values()))
        or "task_group" in next(iter(tree.values()))
        or "type" in next(iter(tree.values()))
        or "datacenters" in next(iter(tree.values()))
    ):
        job_id, body = next(iter(tree.items()))
    else:
        job_id, body = "", tree

    job = Job(
        id=body.get("id", job_id) or job_id,
        name=body.get("name", job_id) or job_id,
        namespace=body.get("namespace", "default"),
        type=body.get("type", "service"),
        priority=int(body.get("priority", 50)),
        datacenters=list(body.get("datacenters", ["dc1"])),
        region=body.get("region", "global"),
        all_at_once=bool(body.get("all_at_once", False)),
        meta={str(k): str(v) for k, v in _one(body.get("meta")).items()},
    )
    job.constraints = [_constraint(c) for c in _many(body.get("constraint"))]
    job.affinities = [_affinity(a) for a in _many(body.get("affinity"))]
    job.spreads = [_spread(s) for s in _many(body.get("spread"))]
    if "update" in body:
        job.update = _update(_one(body["update"]))
    if "periodic" in body:
        p = _one(body["periodic"])
        job.periodic = PeriodicConfig(
            enabled=bool(p.get("enabled", True)),
            spec=p.get("cron", p.get("spec", "")),
            prohibit_overlap=bool(p.get("prohibit_overlap", False)),
            time_zone=p.get("time_zone", "UTC"),
        )
    if "parameterized" in body:
        job.parameterized = _one(body["parameterized"])

    for name, gbody in _labeled(body.get("group")):
        job.task_groups.append(_group(name, gbody, job))
    if not job.task_groups:
        raise ValueError("job has no task groups")
    return job


def _group(name: str, body: Dict[str, Any], job: Job) -> TaskGroup:
    tg = TaskGroup(
        name=name,
        count=int(body.get("count", 1)),
    )
    tg.constraints = [_constraint(c) for c in _many(body.get("constraint"))]
    tg.affinities = [_affinity(a) for a in _many(body.get("affinity"))]
    tg.spreads = [_spread(s) for s in _many(body.get("spread"))]
    if "restart" in body:
        r = _one(body["restart"])
        tg.restart_policy = RestartPolicy(
            attempts=int(r.get("attempts", 2)),
            interval=duration(r.get("interval"), 1800.0),
            delay=duration(r.get("delay"), 15.0),
            mode=r.get("mode", "fail"),
        )
    if "reschedule" in body:
        r = _one(body["reschedule"])
        tg.reschedule_policy = ReschedulePolicy(
            attempts=int(r.get("attempts", 0)),
            interval=duration(r.get("interval"), 0.0),
            delay=duration(r.get("delay"), 30.0),
            delay_function=r.get("delay_function", "exponential"),
            max_delay=duration(r.get("max_delay"), 3600.0),
            unlimited=bool(r.get("unlimited", True)),
        )
    if "migrate" in body:
        m = _one(body["migrate"])
        tg.migrate_strategy = MigrateStrategy(
            max_parallel=int(m.get("max_parallel", 1)),
            health_check=m.get("health_check", "checks"),
            min_healthy_time=duration(m.get("min_healthy_time"), 10.0),
            healthy_deadline=duration(m.get("healthy_deadline"), 300.0),
        )
    if "update" in body:
        tg.update = _update(_one(body["update"]))
    if "ephemeral_disk" in body:
        e = _one(body["ephemeral_disk"])
        tg.ephemeral_disk = EphemeralDisk(
            sticky=bool(e.get("sticky", False)),
            size_mb=int(e.get("size", e.get("size_mb", 300))),
            migrate=bool(e.get("migrate", False)),
        )
    for nbody in _many(body.get("network")):
        tg.networks.append(_network(nbody))
    if body.get("stop_after_client_disconnect") is not None:
        tg.stop_after_client_disconnect = duration(
            body["stop_after_client_disconnect"]
        )
    if "scaling" in body:
        s = _one(body["scaling"])
        tg.scaling = ScalingPolicy(
            min=int(s.get("min", 0)),
            max=int(s.get("max", 0)),
            enabled=bool(s.get("enabled", True)),
            policy=_one(s.get("policy")),
        )
    for vname, vbody in _labeled(body.get("volume")):
        tg.volumes[vname] = VolumeRequest(
            name=vname,
            type=vbody.get("type", "host"),
            source=vbody.get("source", vname),
            read_only=bool(vbody.get("read_only", False)),
            per_alloc=bool(vbody.get("per_alloc", False)),
        )
    for tname, tbody in _labeled(body.get("task")):
        tg.tasks.append(_task(tname, tbody))
    if not tg.tasks:
        raise ValueError(f"group {name!r} has no tasks")
    return tg


def _task(name: str, body: Dict[str, Any]) -> Task:
    t = Task(
        name=name,
        driver=body.get("driver", "mock"),
        config=_one(body.get("config")),
        env={str(k): str(v) for k, v in _one(body.get("env")).items()},
        kill_timeout=duration(body.get("kill_timeout"), 5.0),
        leader=bool(body.get("leader", False)),
    )
    if "lifecycle" in body:
        lc = _one(body["lifecycle"])
        t.lifecycle_hook = lc.get("hook", "")
        t.lifecycle_sidecar = bool(lc.get("sidecar", False))
    if "resources" in body:
        r = _one(body["resources"])
        t.resources = Resources(
            cpu=int(r.get("cpu", 100)),
            memory_mb=int(r.get("memory", r.get("memory_mb", 300))),
            disk_mb=int(r.get("disk", r.get("disk_mb", 0))),
        )
        for d_label, d_body in _labeled(r.get("device")):
            t.resources.devices.append(
                RequestedDevice(
                    name=d_label,
                    count=int(d_body.get("count", 1)),
                    constraints=[
                        _constraint(c)
                        for c in _many(d_body.get("constraint"))
                    ],
                )
            )
        for nbody in _many(r.get("network")):
            t.resources.networks.append(_network(nbody))
    t.constraints = [_constraint(c) for c in _many(body.get("constraint"))]
    t.affinities = [_affinity(a) for a in _many(body.get("affinity"))]
    for s_label, s_body in _labeled(body.get("service")):
        t.services.append(
            Service(
                name=s_label,
                port_label=s_body.get("port", ""),
                tags=list(s_body.get("tags", [])),
            )
        )
    for sbody in _many(body.get("artifact")):
        t.artifacts.append(sbody)
    for sbody in _many(body.get("template")):
        t.templates.append(sbody)
    if "dispatch_payload" in body:
        dp = _one(body["dispatch_payload"])
        t.dispatch_payload = {"file": dp.get("file", "input")}
    if "logs" in body:
        lg = _one(body["logs"])
        t.logs = {
            "max_files": int(lg.get("max_files", 10)),
            "max_file_size_mb": int(lg.get("max_file_size", lg.get(
                "max_file_size_mb", 10
            ))),
        }
    for vm in _many(body.get("volume_mount")):
        t.volume_mounts.append(VolumeMount(
            volume=vm.get("volume", ""),
            destination=vm.get("destination", ""),
            read_only=bool(vm.get("read_only", False)),
        ))
    return t


def _network(body: Dict[str, Any]) -> NetworkResource:
    net = NetworkResource(
        mode=body.get("mode", "host"), mbits=int(body.get("mbits", 0))
    )
    for label, pbody in _labeled(body.get("port")):
        static = pbody.get("static")
        if static:
            net.reserved_ports.append(int(static))
        else:
            net.dynamic_ports.append(label)
    return net


def _constraint(body: Dict[str, Any]) -> Constraint:
    operand = body.get("operator", body.get("operand", "="))
    # distinct_hosts / distinct_property sugar.
    if body.get("distinct_hosts"):
        return Constraint(operand="distinct_hosts")
    if body.get("distinct_property"):
        return Constraint(
            l_target=body["distinct_property"],
            operand="distinct_property",
            r_target=str(body.get("value", "")),
        )
    return Constraint(
        l_target=body.get("attribute", ""),
        r_target=str(body.get("value", "")),
        operand=operand,
    )


def _affinity(body: Dict[str, Any]) -> Affinity:
    return Affinity(
        l_target=body.get("attribute", ""),
        r_target=str(body.get("value", "")),
        operand=body.get("operator", "="),
        weight=int(body.get("weight", 50)),
    )


def _spread(body: Dict[str, Any]) -> Spread:
    targets = [
        SpreadTarget(value=label, percent=int(t.get("percent", 0)))
        for label, t in _labeled(body.get("target"))
    ]
    return Spread(
        attribute=body.get("attribute", ""),
        weight=int(body.get("weight", 50)),
        targets=targets,
    )


def _update(body: Dict[str, Any]) -> UpdateStrategy:
    return UpdateStrategy(
        max_parallel=int(body.get("max_parallel", 1)),
        health_check=body.get("health_check", "checks"),
        min_healthy_time=duration(body.get("min_healthy_time"), 10.0),
        healthy_deadline=duration(body.get("healthy_deadline"), 300.0),
        progress_deadline=duration(body.get("progress_deadline"), 600.0),
        auto_revert=bool(body.get("auto_revert", False)),
        auto_promote=bool(body.get("auto_promote", False)),
        canary=int(body.get("canary", 0)),
        stagger=duration(body.get("stagger"), 30.0),
    )


# ---------------------------------------------------------------------------
# API JSON <-> Job
# ---------------------------------------------------------------------------


def job_to_api(job: Job) -> Dict[str, Any]:
    """Job → JSON-able dict (dataclasses asdict, enums already str)."""
    import dataclasses

    return dataclasses.asdict(job)


def api_to_job(data: Dict[str, Any]) -> Job:
    """JSON dict (snake_case asdict form) → Job."""

    def build(cls, payload, field_builders=None):
        import dataclasses as dc

        kwargs = {}
        names = {f.name: f for f in dc.fields(cls)}
        for k, v in (payload or {}).items():
            if k not in names:
                continue
            builder = (field_builders or {}).get(k)
            kwargs[k] = builder(v) if builder else v
        return cls(**kwargs)

    def tasks(items):
        return [
            build(
                Task,
                t,
                {
                    "resources": lambda r: build(
                        Resources,
                        r,
                        {
                            "networks": lambda ns: [
                                build(NetworkResource, n) for n in ns
                            ],
                            "devices": lambda ds: [
                                build(RequestedDevice, d, {
                                    "constraints": lambda cs: [
                                        build(Constraint, c) for c in cs
                                    ],
                                    "affinities": lambda as_: [
                                        build(Affinity, a) for a in as_
                                    ],
                                })
                                for d in ds
                            ],
                        },
                    ),
                    "constraints": lambda cs: [
                        build(Constraint, c) for c in cs
                    ],
                    "affinities": lambda as_: [build(Affinity, a) for a in as_],
                    "services": lambda ss: [build(Service, s) for s in ss],
                    "volume_mounts": lambda vms: [
                        build(VolumeMount, v) for v in vms
                    ],
                },
            )
            for t in (items or [])
        ]

    def groups(items):
        return [
            build(
                TaskGroup,
                g,
                {
                    "tasks": tasks,
                    "constraints": lambda cs: [
                        build(Constraint, c) for c in cs
                    ],
                    "affinities": lambda as_: [build(Affinity, a) for a in as_],
                    "spreads": lambda ss: [
                        build(Spread, s, {
                            "targets": lambda ts: [
                                build(SpreadTarget, t) for t in ts
                            ]
                        })
                        for s in ss
                    ],
                    "restart_policy": lambda r: build(RestartPolicy, r),
                    "reschedule_policy": lambda r: build(ReschedulePolicy, r)
                    if r
                    else None,
                    "migrate_strategy": lambda m: build(MigrateStrategy, m),
                    "update": lambda u: build(UpdateStrategy, u) if u else None,
                    "ephemeral_disk": lambda e: build(EphemeralDisk, e),
                    "networks": lambda ns: [
                        build(NetworkResource, n) for n in ns
                    ],
                    "scaling": lambda s: build(ScalingPolicy, s)
                    if s else None,
                    "volumes": lambda vs: {
                        k: build(VolumeRequest, v) for k, v in vs.items()
                    },
                },
            )
            for g in (items or [])
        ]

    return build(
        Job,
        data,
        {
            "task_groups": groups,
            "constraints": lambda cs: [build(Constraint, c) for c in cs],
            "affinities": lambda as_: [build(Affinity, a) for a in as_],
            "spreads": lambda ss: [
                build(Spread, s, {
                    "targets": lambda ts: [
                        build(SpreadTarget, t) for t in ts
                    ]
                })
                for s in ss
            ],
            "update": lambda u: build(UpdateStrategy, u) if u else None,
            "periodic": lambda p: build(PeriodicConfig, p) if p else None,
        },
    )
