"""CLI — the user surface (reference: ``command/`` ~100 subcommands; this
covers the core operational set: agent, job run/status/stop/plan-parse,
node status/drain/eligibility, alloc status, eval status, server members,
operator scheduler config, metrics).

A copy of the reference package's ``cli.py``, run as
``python -m nomad_tpu_torch.cli``.  ``agent`` takes ``--device`` (default
``cuda``): the device of the agent's server, which fails without a card
unless ``--device cpu`` asks for the CPU.  ``lint`` runs the port's
static analysis (``nomad_tpu_torch/lint/``) over its own tree, without
the reference's ``--jaxpr`` (the port traces nothing).  Every other
command speaks HTTP only.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from typing import List, Optional

from .api.client import APIClient, APIError
from .jobspec import job_to_api, parse_job

DEFAULT_ADDR = os.environ.get("NOMAD_TPU_ADDR", "http://127.0.0.1:4646")


def _client(args) -> APIClient:
    return APIClient(args.address, token=getattr(args, "token", ""))


def _print(obj) -> None:
    print(json.dumps(obj, indent=2, default=str))


def cmd_agent(args) -> int:
    from .api.agent import Agent, AgentConfig
    from .api.config_file import apply_config, load_config_files

    # Precedence (command/agent/config.go): defaults < config files
    # (merged in order) < explicitly passed CLI flags.  Flags default to
    # None so "explicitly passed" is distinguishable from "defaulted".
    config = AgentConfig(http_port=4646)
    if args.config:
        apply_config(load_config_files(args.config), config)
    if args.name is not None:
        config.name = args.name
    if args.dc is not None:
        config.datacenter = args.dc
    if args.client_only:
        config.server_enabled = False
    if args.server_only:
        config.client_enabled = False
    if args.servers is not None:
        config.server_addr = args.servers
    if args.bind is not None:
        config.http_host = args.bind
    if args.port is not None:
        config.http_port = args.port
    if args.workers is not None:
        config.server_config.num_workers = args.workers
    if args.raft:
        config.server_config.raft_enabled = True
    if args.peers is not None:
        config.server_config.peers = [
            a for a in args.peers.split(",") if a
        ]
    if args.data_dir:
        config.server_config.data_dir = args.data_dir
    try:
        agent = Agent(config, device=args.device)
    except (RuntimeError, ValueError) as exc:
        # No card for --device cuda, or a client-only agent without servers.
        print(f"error: {exc}", file=sys.stderr)
        return 1
    agent.start()
    print(f"agent started; HTTP API at {agent.rpc_addr}", flush=True)
    try:
        while True:
            time.sleep(1)
    except KeyboardInterrupt:
        print("shutting down")
        agent.shutdown()
    return 0


def cmd_job_run(args) -> int:
    src = open(args.jobfile).read()
    job = parse_job(src)
    client = _client(args)
    result = client.register_job(job_to_api(job))
    print(f"Job {job.id!r} registered; eval {result.get('EvalID', '')}")
    if args.detach:
        return 0
    eval_id = result.get("EvalID")
    if not eval_id:
        return 0
    deadline = time.time() + 30
    while time.time() < deadline:
        ev = client.get_evaluation(eval_id)
        if ev["status"] in ("complete", "failed", "cancelled"):
            print(f"Evaluation {eval_id[:8]} {ev['status']}")
            if ev.get("queued_allocations"):
                queued = {
                    k: v
                    for k, v in ev["queued_allocations"].items()
                    if v
                }
                if queued:
                    print(f"Queued (unplaced): {queued}")
            for a in client.job_allocations(job.id, job.namespace):
                print(
                    f"  alloc {a['id'][:8]} {a['name']} -> node "
                    f"{a['node_id'][:8]} [{a['client_status']}]"
                )
            return 0
        time.sleep(0.2)
    print("timed out waiting for evaluation")
    return 1


def cmd_job_plan(args) -> int:
    """Dry-run the scheduler on a jobspec: what WOULD change
    (reference: `nomad job plan`, command/job_plan.go)."""
    job = parse_job(open(args.jobfile).read())
    client = _client(args)
    result = client.plan_job(
        job.id, job_to_api(job), diff=args.diff, namespace=job.namespace
    )
    diff = result.get("Diff")
    if diff:
        fields = f" ({', '.join(diff['Fields'])})" if diff["Fields"] else ""
        print(f"Job: {diff['Type']}{fields}")
    for tg, counts in (
        result.get("Annotations", {}).get("DesiredTGUpdates", {}) or {}
    ).items():
        shown = {k: v for k, v in counts.items() if v}
        print(f"Task Group {tg!r}: {shown or 'no changes'}")
    failed = result.get("FailedTGAllocs") or {}
    for tg, metric in failed.items():
        print(
            f"WARNING: task group {tg!r} would have "
            f"{metric.get('coalesced_failures', 0) + 1} unplaced alloc(s)"
        )
    print(
        "\nJob Modify Index:", result.get("JobModifyIndex", 0),
        "\n(run with this index via -check-index semantics to guard "
        "against concurrent changes)",
    )
    return 1 if failed else 0


def cmd_job_status(args) -> int:
    client = _client(args)
    if not args.job_id:
        for stub in client.list_jobs():
            print(
                f"{stub['id']:40} {stub['type']:8} prio={stub['priority']:3} "
                f"{stub['status']}{' (stopped)' if stub['stop'] else ''}"
            )
        return 0
    job = client.get_job(args.job_id, args.namespace)
    print(f"ID       = {job['id']}")
    print(f"Name     = {job['name']}")
    print(f"Type     = {job['type']}")
    print(f"Priority = {job['priority']}")
    print(f"Status   = {job['status']}{' (stopped)' if job['stop'] else ''}")
    try:
        summary = client.job_summary(args.job_id, args.namespace)
        print("Summary:")
        for tg, counts in summary["Summary"].items():
            shown = {k: v for k, v in counts.items() if v}
            print(f"  {tg}: {shown or '{}'}")
    except APIError:
        pass
    print("Allocations:")
    for a in client.job_allocations(args.job_id, args.namespace):
        print(
            f"  {a['id'][:8]} {a['name']:32} node={a['node_id'][:8]} "
            f"desired={a['desired_status']} status={a['client_status']}"
        )
    return 0


def cmd_job_stop(args) -> int:
    client = _client(args)
    result = client.deregister_job(
        args.job_id, purge=args.purge, namespace=args.namespace
    )
    print(f"Job {args.job_id!r} stopping; eval {result.get('EvalID', '')}")
    return 0


def cmd_job_parse(args) -> int:
    job = parse_job(open(args.jobfile).read())
    _print(dataclasses.asdict(job))
    return 0


def cmd_node_status(args) -> int:
    client = _client(args)
    if not args.node_id:
        for n in client.list_nodes():
            print(
                f"{n['id'][:8]} {n['name']:24} {n['datacenter']:8} "
                f"{n['status']:12} drain={n['drain']} "
                f"{n['scheduling_eligibility']}"
            )
        return 0
    node = client.get_node(args.node_id)
    _print(node)
    print("Allocations:")
    for a in client.node_allocations(args.node_id):
        print(
            f"  {a['id'][:8]} {a['name']:32} desired={a['desired_status']} "
            f"status={a['client_status']}"
        )
    return 0


def cmd_node_drain(args) -> int:
    client = _client(args)
    client.drain_node(
        args.node_id, enable=not args.disable, deadline=args.deadline
    )
    print(
        f"Node {args.node_id[:8]} drain "
        f"{'disabled' if args.disable else 'enabled'}"
    )
    return 0


def cmd_node_eligibility(args) -> int:
    client = _client(args)
    client.set_node_eligibility(args.node_id, args.enable)
    print(
        f"Node {args.node_id[:8]} marked "
        f"{'eligible' if args.enable else 'ineligible'}"
    )
    return 0


def cmd_alloc_status(args) -> int:
    client = _client(args)
    alloc = client.get_allocation(_resolve_alloc_id(client, args.alloc_id))
    keep = (
        "id", "name", "node_id", "job_id", "task_group", "desired_status",
        "client_status", "create_time",
    )
    _print({k: alloc[k] for k in keep if k in alloc})
    if args.verbose and alloc.get("metrics"):
        _print(alloc["metrics"])
    if alloc.get("task_states"):
        print("Task states:")
        for name, ts in alloc["task_states"].items():
            print(
                f"  {name}: {ts['state']} failed={ts['failed']} "
                f"restarts={ts['restarts']}"
            )
    return 0


def cmd_alloc_logs(args) -> int:
    """Tail (optionally follow) a task's stdout/stderr
    (reference: `nomad alloc logs`, command/alloc_logs.go)."""
    import urllib.parse
    import urllib.request

    args.alloc_id = _resolve_alloc_id(_client(args), args.alloc_id)
    task = args.task
    if not task:
        alloc = _client(args).get_allocation(args.alloc_id)
        states = alloc.get("task_states") or {}
        task = next(iter(states), "main")
    qs = urllib.parse.urlencode({
        "task": task,
        "type": "stderr" if args.stderr else "stdout",
        "follow": "true" if args.follow else "false",
        "offset": str(-args.tail_bytes),
    })
    url = f"{args.address}/v1/client/fs/logs/{args.alloc_id}?{qs}"
    req = urllib.request.Request(url)
    if getattr(args, "token", ""):
        req.add_header("X-Nomad-Token", args.token)
    try:
        with urllib.request.urlopen(req, timeout=None) as resp:
            while True:
                # read1 returns available bytes — read(n) would block a
                # live follow stream until n accumulate.
                chunk = resp.read1(8192)
                if not chunk:
                    break
                sys.stdout.write(chunk.decode(errors="replace"))
                sys.stdout.flush()
    except KeyboardInterrupt:
        pass
    return 0


def cmd_alloc_fs(args) -> int:
    """List or read files in an allocation's directory
    (reference: `nomad alloc fs`, command/alloc_fs.go)."""
    import urllib.parse
    import urllib.request

    qs = urllib.parse.urlencode({"path": args.path})
    base = f"{args.address}/v1/client/fs"
    # ls first; fall back to cat when the path is a file.
    for op in ("ls", "cat"):
        req = urllib.request.Request(
            f"{base}/{op}/{args.alloc_id}?{qs}"
        )
        if getattr(args, "token", ""):
            req.add_header("X-Nomad-Token", args.token)
        try:
            with urllib.request.urlopen(req, timeout=30) as resp:
                body = resp.read()
        except urllib.error.HTTPError as exc:
            if op == "ls" and exc.code == 404:
                continue
            print(exc.read().decode(errors="replace"), file=sys.stderr)
            return 1
        if op == "ls":
            for entry in json.loads(body):
                kind = "d" if entry["IsDir"] else "-"
                print(f"{kind} {entry['Size']:>10} {entry['Name']}")
        else:
            sys.stdout.write(body.decode(errors="replace"))
        return 0
    return 1


def _resolve_alloc_id(client: APIClient, prefix: str) -> str:
    """Expand a short alloc id the way the reference CLI does (prefix
    search, command/meta.go resolution)."""
    if len(prefix) >= 36:
        return prefix
    try:
        out = client.search(prefix, context="allocs")
        hits = out.get("Matches", {}).get("allocs", [])
    except APIError:
        return prefix
    if len(hits) == 1:
        return hits[0]
    if len(hits) > 1:
        print(f"alloc id prefix {prefix!r} is ambiguous: {hits}",
              file=sys.stderr)
    return prefix


def cmd_alloc_restart(args) -> int:
    client = _client(args)
    alloc_id = _resolve_alloc_id(client, args.alloc_id)
    out = client.restart_allocation(alloc_id, task=args.task)
    print(f"Restarted tasks: {out.get('Restarted', [])}")
    return 0


def cmd_alloc_signal(args) -> int:
    client = _client(args)
    alloc_id = _resolve_alloc_id(client, args.alloc_id)
    out = client.signal_allocation(
        alloc_id, signal=args.signal, task=args.task
    )
    print(f"Signalled tasks: {out.get('Signalled', [])}")
    return 0


def cmd_alloc_stop(args) -> int:
    client = _client(args)
    alloc_id = _resolve_alloc_id(client, args.alloc_id)
    out = client.stop_allocation(alloc_id)
    print(f"Alloc stopping; eval {out.get('EvalID', '')}")
    return 0


def cmd_alloc_exec(args) -> int:
    """Run a command inside a task's context (`nomad alloc exec`,
    command/alloc_exec.go; stdin is read upfront when piped)."""
    stdin = b""
    try:
        if not sys.stdin.isatty():
            stdin = sys.stdin.buffer.read()
    except (OSError, ValueError):
        pass  # no usable stdin (test harness)
    cmd = list(args.cmd or [])
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]  # only the leading separator; inner "--" is argv
    if not cmd:
        print("usage: alloc exec <alloc_id> [--task t] -- cmd args...",
              file=sys.stderr)
        return 1
    client = _client(args)
    alloc_id = _resolve_alloc_id(client, args.alloc_id)
    try:
        code, out, err = client.alloc_exec(
            alloc_id, args.task, cmd, stdin=stdin,
        )
    except APIError as exc:
        print(f"exec failed: {exc}", file=sys.stderr)
        return 1
    if out:
        sys.stdout.buffer.write(out)
        sys.stdout.flush()
    if err:
        sys.stderr.buffer.write(err)
        sys.stderr.flush()
    return code if code >= 0 else 1


def cmd_acl(args) -> int:
    """ACL admin (reference: `nomad acl bootstrap/policy/token`)."""
    client = _client(args)
    if args.acl_cmd == "bootstrap":
        t = client.acl_bootstrap()
        print(f"Accessor ID = {t['accessor_id']}")
        print(f"Secret ID   = {t['secret_id']}")
        print(f"Type        = {t['type']}")
        return 0
    if args.acl_cmd == "policy-apply":
        client.acl_upsert_policy(
            args.name, open(args.rules_file).read(),
            description=args.description,
        )
        print(f"Policy {args.name!r} applied")
        return 0
    if args.acl_cmd == "token-create":
        t = client.acl_create_token(
            name=args.name, type=args.type,
            policies=args.policy or [],
        )
        print(f"Accessor ID = {t['accessor_id']}")
        print(f"Secret ID   = {t['secret_id']}")
        print(f"Policies    = {t['policies']}")
        return 0
    return 1


def cmd_namespace(args) -> int:
    client = _client(args)
    if args.ns_cmd == "list":
        for n in client.list_namespaces():
            print(f"{n['Name']:20} {n.get('Description', '')}")
        return 0
    if args.ns_cmd == "apply":
        client.upsert_namespace(args.name, description=args.description)
        print(f"Namespace {args.name!r} applied")
        return 0
    if args.ns_cmd == "delete":
        client.delete_namespace(args.name)
        print(f"Namespace {args.name!r} deleted")
        return 0
    return 1


def cmd_search(args) -> int:
    client = _client(args)
    out = client.search(
        args.prefix, context=args.context, namespace=args.namespace
    )
    for context, ids in sorted(out.get("Matches", {}).items()):
        if not ids:
            continue
        print(f"{context}:")
        for i in ids:
            print(f"  {i}")
        if out.get("Truncations", {}).get(context):
            print("  ... (truncated)")
    return 0


def cmd_job_validate(args) -> int:
    """Server-side admission dry run (`nomad job validate`)."""
    job = parse_job(open(args.jobfile).read())
    out = _client(args).validate_job(job_to_api(job))
    if out["Valid"]:
        print("Job validation successful")
        return 0
    for e in out["ValidationErrors"]:
        print(f"  - {e}", file=sys.stderr)
    return 1


def cmd_job_inspect(args) -> int:
    """Full stored job JSON (`nomad job inspect`)."""
    _print(_client(args).get_job(args.job_id, args.namespace))
    return 0


def cmd_eval_list(args) -> int:
    for e in _client(args).list_evaluations(namespace=args.namespace):
        print(
            f"{e['id'][:8]} {e['job_id']:32} {e['triggered_by']:20} "
            f"{e['status']}"
        )
    return 0


def cmd_job_dispatch(args) -> int:
    client = _client(args)
    payload = b""
    if args.payload_file:
        with open(args.payload_file, "rb") as fh:
            payload = fh.read()
    for kv in args.meta or []:
        if "=" not in kv:
            print(f"-meta expects KEY=VALUE, got {kv!r}", file=sys.stderr)
            return 1
    meta = dict(kv.split("=", 1) for kv in args.meta or [])
    out = client.dispatch_job(
        args.job_id, payload, meta, namespace=args.namespace
    )
    print(f"Dispatched Job ID = {out['DispatchedJobID']}")
    print(f"Evaluation ID     = {out.get('EvalID', '')}")
    return 0


def cmd_job_history(args) -> int:
    client = _client(args)
    out = client.job_versions(args.job_id, namespace=args.namespace)
    for v in out["Versions"]:
        print(
            f"Version {v['version']:4}  submitted "
            f"{time.strftime('%Y-%m-%d %H:%M:%S', time.localtime(v['submit_time']))}"
            f"{'  (stopped)' if v['stop'] else ''}"
        )
    return 0


def cmd_job_revert(args) -> int:
    client = _client(args)
    out = client.revert_job(
        args.job_id, args.version, namespace=args.namespace
    )
    print(f"Reverted; eval {out.get('EvalID', '')}")
    return 0


def cmd_job_scale(args) -> int:
    client = _client(args)
    # `job scale <job> <count>` shorthand (single-group jobs): the count
    # binds to the optional group positional — reinterpret it.
    if args.count is None and args.group.lstrip("-").isdigit():
        args.count = int(args.group)
        args.group = ""
    if args.count is None:
        _print(client.job_scale_status(args.job_id, namespace=args.namespace))
        return 0
    out = client.scale_job(
        args.job_id, args.group, args.count,
        message=args.message, namespace=args.namespace,
    )
    print(f"Scaled {args.job_id}/{args.group} to {args.count}; "
          f"eval {out.get('EvalID', '')}")
    return 0


def _resolve_deployment_id(client: APIClient, prefix: str) -> str:
    if len(prefix) >= 36:
        return prefix
    try:
        out = client.search(prefix, context="deployment")
        hits = out.get("Matches", {}).get("deployment", [])
    except APIError:
        return prefix
    return hits[0] if len(hits) == 1 else prefix


def cmd_deployment(args) -> int:
    client = _client(args)
    action = args.deployment_action
    if getattr(args, "deployment_id", ""):
        args.deployment_id = _resolve_deployment_id(
            client, args.deployment_id
        )
    if action == "list":
        for d in client.list_deployments(namespace=args.namespace):
            print(
                f"{d['id'][:8]} job={d['job_id']:24} v{d['job_version']} "
                f"{d['status']:10} {d['status_description']}"
            )
        return 0
    if action == "status":
        _print(client.get_deployment(args.deployment_id))
        return 0
    if action == "promote":
        out = client.promote_deployment(
            args.deployment_id, args.group or None
        )
        print(f"Promoted; index {out.get('Index')}")
        return 0
    if action == "fail":
        client.fail_deployment(args.deployment_id)
        print("Deployment marked failed")
        return 0
    if action == "pause":
        client.pause_deployment(args.deployment_id, not args.resume)
        print("Deployment " + ("resumed" if args.resume else "paused"))
        return 0
    return 1


def cmd_volume(args) -> int:
    client = _client(args)
    action = args.volume_action
    if action == "list":
        for v in client.list_volumes(namespace=args.namespace):
            writers = len(v["write_claims"])
            readers = len(v["read_claims"])
            print(
                f"{v['id']:36} {v['access_mode']:24} "
                f"claims: {writers}w/{readers}r"
            )
        return 0
    if action == "register":
        spec = json.loads(open(args.volume_file).read())
        out = client.register_volume(spec, namespace=args.namespace)
        print(f"Registered volume {out['ID']}")
        return 0
    if action == "status":
        _print(client.get_volume(args.volume_id, namespace=args.namespace))
        return 0
    if action == "deregister":
        client.deregister_volume(args.volume_id, namespace=args.namespace)
        print("Deregistered")
        return 0
    return 1


def cmd_system_gc(args) -> int:
    _client(args).system_gc()
    print("GC triggered")
    return 0


def cmd_eval_status(args) -> int:
    client = _client(args)
    _print(client.get_evaluation(args.eval_id))
    return 0


def cmd_server_members(args) -> int:
    _print(_client(args).members())
    return 0


def cmd_server_join(args) -> int:
    out = _client(args).server_join(args.peer_addr)
    print("Members:")
    for m in out["Members"]:
        print(f"  {m}")
    return 0


def cmd_server_remove_peer(args) -> int:
    out = _client(args).server_remove_peer(args.peer_addr)
    print("Members:")
    for m in out["Members"]:
        print(f"  {m}")
    return 0


def cmd_operator_scheduler(args) -> int:
    client = _client(args)
    if args.algorithm:
        client.set_scheduler_configuration(
            {"scheduler_algorithm": args.algorithm}
        )
    _print(client.scheduler_configuration())
    return 0


def cmd_metrics(args) -> int:
    client = _client(args)
    if args.watch:
        return _watch_metrics(client, args)
    if args.format == "prometheus":
        sys.stdout.write(client.metrics_prometheus())
        return 0
    _print(client.metrics())
    return 0


def _watch_metrics(client, args) -> int:
    """Poll /v1/metrics and print per-interval deltas for counters (and
    current values for gauges) — `vmstat` for the cluster."""
    prev = None
    rounds = 0
    try:
        while args.count <= 0 or rounds < args.count:
            snap = client.metrics()
            flat = {
                k: v for k, v in snap.items()
                if isinstance(v, (int, float))
            }
            if prev is not None:
                deltas = {}
                for k, v in sorted(flat.items()):
                    d = v - prev.get(k, 0)
                    if d != 0:
                        deltas[k] = round(d, 6)
                stamp = time.strftime("%H:%M:%S")
                if deltas:
                    print(f"--- {stamp} (+{args.interval:g}s) ---")
                    for k, d in deltas.items():
                        sign = "+" if d > 0 else ""
                        print(f"  {k}: {sign}{d:g}  (now {flat[k]:g})")
                else:
                    print(f"--- {stamp} no change ---")
                rounds += 1
            prev = flat
            time.sleep(args.interval)
    except KeyboardInterrupt:
        pass
    return 0


def cmd_top(args) -> int:
    from .obs.top import run_top

    return run_top(
        _client(args),
        interval=args.interval,
        count=args.count,
        clear=not args.no_clear,
    )


def cmd_slo(args) -> int:
    client = _client(args)
    if args.health:
        _print(client.health())
    elif args.overload:
        _print(client.overload())
    else:
        _print(client.slo())
    return 0


def cmd_trace_dump(args) -> int:
    body = _client(args).trace_dump(limit=args.limit)
    if args.output:
        with open(args.output, "wb") as fh:
            fh.write(body)
        doc = json.loads(body)
        n = len(doc.get("traceEvents", []))
        print(f"wrote {n} trace events to {args.output}")
        print("open in https://ui.perfetto.dev (drag the file in)")
    else:
        sys.stdout.write(body.decode())
    return 0


def cmd_trace_config(args) -> int:
    client = _client(args)
    updates = {}
    if args.sample is not None:
        updates["sample"] = args.sample
    if args.ring is not None:
        updates["ring"] = args.ring
    if args.enable:
        updates["enabled"] = True
    if args.disable:
        updates["enabled"] = False
    if updates:
        _print(client.trace_configure(**updates))
    else:
        _print(client.trace_config())
    return 0


def cmd_lint(args) -> int:
    from .lint.__main__ import main as lint_main

    forwarded = []
    if args.verbose:
        forwarded.append("--verbose")
    if args.baseline:
        forwarded += ["--baseline", args.baseline]
    return lint_main(forwarded)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="nomad-tpu", description="workload orchestrator (PyTorch/CUDA port)"
    )
    p.add_argument("--address", default=DEFAULT_ADDR)
    p.add_argument("--token", default=os.environ.get("NOMAD_TOKEN", ""),
                   help="ACL secret (or NOMAD_TOKEN)")
    sub = p.add_subparsers(dest="command", required=True)

    agent = sub.add_parser("agent", help="run an agent (server+client)")
    # Flags default to None so config files only lose to EXPLICIT flags
    # (cmd_agent precedence chain).
    agent.add_argument("--name", default=None)
    agent.add_argument("--config", action="append", default=[],
                       help="config file or dir (repeatable; merged in order)")
    agent.add_argument("--dc", default=None)
    agent.add_argument("--bind", default=None)
    agent.add_argument("--port", type=int, default=None)
    agent.add_argument("--workers", type=int, default=None)
    agent.add_argument("--raft", action="store_true", default=False,
                       help="run replication even with no peers "
                            "(single server that grows via `server join`)")
    agent.add_argument("--peers", default=None,
                       help="comma-separated peer server HTTP addrs")
    agent.add_argument("--server-only", action="store_true")
    agent.add_argument("--client-only", action="store_true")
    agent.add_argument("--servers", default=None,
                       help="server agent address for client-only agents")
    agent.add_argument("--data-dir", default="",
                       help="server durability dir (WAL + snapshots)")
    agent.add_argument("--device", default="cuda",
                       help="device of the agent's server: cuda (default; "
                            "fails without a card) or cpu")
    agent.set_defaults(fn=cmd_agent)

    job = sub.add_parser("job", help="job operations").add_subparsers(
        dest="job_cmd", required=True
    )
    run = job.add_parser("run")
    run.add_argument("jobfile")
    run.add_argument("-detach", action="store_true")
    run.set_defaults(fn=cmd_job_run)
    plan = job.add_parser("plan")
    plan.add_argument("jobfile")
    plan.add_argument("-diff", action="store_true", default=False)
    plan.set_defaults(fn=cmd_job_plan)

    status = job.add_parser("status")
    status.add_argument("job_id", nargs="?")
    status.add_argument("--namespace", default="default")
    status.set_defaults(fn=cmd_job_status)
    stop = job.add_parser("stop")
    stop.add_argument("job_id")
    stop.add_argument("-purge", action="store_true")
    stop.add_argument("--namespace", default="default")
    stop.set_defaults(fn=cmd_job_stop)
    parse = job.add_parser("parse")
    parse.add_argument("jobfile")
    parse.set_defaults(fn=cmd_job_parse)
    validate = job.add_parser("validate")
    validate.add_argument("jobfile")
    validate.set_defaults(fn=cmd_job_validate)
    inspect = job.add_parser("inspect")
    inspect.add_argument("job_id")
    inspect.add_argument("--namespace", default="default")
    inspect.set_defaults(fn=cmd_job_inspect)
    dispatch = job.add_parser("dispatch")
    dispatch.add_argument("job_id")
    dispatch.add_argument("payload_file", nargs="?", default="")
    dispatch.add_argument("-meta", action="append", metavar="KEY=VALUE")
    dispatch.add_argument("--namespace", default="default")
    dispatch.set_defaults(fn=cmd_job_dispatch)
    history = job.add_parser("history")
    history.add_argument("job_id")
    history.add_argument("--namespace", default="default")
    history.set_defaults(fn=cmd_job_history)
    revert = job.add_parser("revert")
    revert.add_argument("job_id")
    revert.add_argument("version", nargs="?", type=int, default=None)
    revert.add_argument("--namespace", default="default")
    revert.set_defaults(fn=cmd_job_revert)
    scale = job.add_parser("scale")
    scale.add_argument("job_id")
    scale.add_argument("group", nargs="?", default="")
    scale.add_argument("count", nargs="?", type=int, default=None)
    scale.add_argument("--message", default="")
    scale.add_argument("--namespace", default="default")
    scale.set_defaults(fn=cmd_job_scale)

    dep = sub.add_parser("deployment", help="deployment ops").add_subparsers(
        dest="deployment_action", required=True
    )
    dlist = dep.add_parser("list")
    dlist.add_argument("--namespace", default="default")
    dlist.set_defaults(fn=cmd_deployment)
    for verb in ("status", "promote", "fail", "pause"):
        dp = dep.add_parser(verb)
        dp.add_argument("deployment_id")
        if verb == "promote":
            dp.add_argument("-group", action="append", default=[])
        if verb == "pause":
            dp.add_argument("-resume", action="store_true")
        dp.set_defaults(fn=cmd_deployment)

    system = sub.add_parser("system", help="system ops").add_subparsers(
        dest="system_cmd", required=True
    )
    system.add_parser("gc").set_defaults(fn=cmd_system_gc)

    vol = sub.add_parser("volume", help="volume ops").add_subparsers(
        dest="volume_action", required=True
    )
    vlist = vol.add_parser("list")
    vlist.add_argument("--namespace", default="default")
    vlist.set_defaults(fn=cmd_volume)
    vreg = vol.add_parser("register")
    vreg.add_argument("volume_file")
    vreg.add_argument("--namespace", default="default")
    vreg.set_defaults(fn=cmd_volume)
    for verb in ("status", "deregister"):
        vp = vol.add_parser(verb)
        vp.add_argument("volume_id")
        vp.add_argument("--namespace", default="default")
        vp.set_defaults(fn=cmd_volume)

    node = sub.add_parser("node", help="node operations").add_subparsers(
        dest="node_cmd", required=True
    )
    nstatus = node.add_parser("status")
    nstatus.add_argument("node_id", nargs="?")
    nstatus.set_defaults(fn=cmd_node_status)
    drain = node.add_parser("drain")
    drain.add_argument("node_id")
    drain.add_argument("-disable", action="store_true")
    drain.add_argument("--deadline", type=float, default=3600.0)
    drain.set_defaults(fn=cmd_node_drain)
    elig = node.add_parser("eligibility")
    elig.add_argument("node_id")
    elig.add_argument("-enable", dest="enable", action="store_true")
    elig.add_argument("-disable", dest="enable", action="store_false")
    elig.set_defaults(fn=cmd_node_eligibility, enable=True)

    alloc = sub.add_parser("alloc", help="allocation ops").add_subparsers(
        dest="alloc_cmd", required=True
    )
    astatus = alloc.add_parser("status")
    astatus.add_argument("alloc_id")
    astatus.add_argument("-verbose", action="store_true")
    astatus.set_defaults(fn=cmd_alloc_status)

    alogs = alloc.add_parser("logs")
    alogs.add_argument("alloc_id")
    alogs.add_argument("task", nargs="?", default="")
    alogs.add_argument("-f", "--follow", action="store_true", dest="follow")
    alogs.add_argument("-stderr", action="store_true", dest="stderr")
    alogs.add_argument("-tail-bytes", type=int, default=65536,
                       dest="tail_bytes")
    alogs.set_defaults(fn=cmd_alloc_logs)

    arestart = alloc.add_parser("restart")
    arestart.add_argument("alloc_id")
    arestart.add_argument("--task", default="")
    arestart.set_defaults(fn=cmd_alloc_restart)
    asignal = alloc.add_parser("signal")
    asignal.add_argument("alloc_id")
    asignal.add_argument("signal", nargs="?", default="SIGTERM")
    asignal.add_argument("--task", default="")
    asignal.set_defaults(fn=cmd_alloc_signal)
    astop = alloc.add_parser("stop")
    astop.add_argument("alloc_id")
    astop.set_defaults(fn=cmd_alloc_stop)
    aexec = alloc.add_parser("exec")
    aexec.add_argument("alloc_id")
    aexec.add_argument("--task", default="")
    aexec.add_argument("cmd", nargs=argparse.REMAINDER)
    aexec.set_defaults(fn=cmd_alloc_exec)
    afs = alloc.add_parser("fs")
    afs.add_argument("alloc_id")
    afs.add_argument("path", nargs="?", default="")
    afs.set_defaults(fn=cmd_alloc_fs)

    acl = sub.add_parser("acl", help="ACL admin").add_subparsers(
        dest="acl_cmd", required=True
    )
    acl.add_parser("bootstrap").set_defaults(fn=cmd_acl)
    pol = acl.add_parser("policy-apply")
    pol.add_argument("name")
    pol.add_argument("rules_file")
    pol.add_argument("-description", default="")
    pol.set_defaults(fn=cmd_acl)
    tok = acl.add_parser("token-create")
    tok.add_argument("-name", default="")
    tok.add_argument("-type", default="client")
    tok.add_argument("-policy", action="append")
    tok.set_defaults(fn=cmd_acl)

    ns = sub.add_parser("namespace", help="namespace ops").add_subparsers(
        dest="ns_cmd", required=True
    )
    ns.add_parser("list").set_defaults(fn=cmd_namespace)
    nsap = ns.add_parser("apply")
    nsap.add_argument("name")
    nsap.add_argument("-description", default="")
    nsap.set_defaults(fn=cmd_namespace)
    nsdel = ns.add_parser("delete")
    nsdel.add_argument("name")
    nsdel.set_defaults(fn=cmd_namespace)

    search = sub.add_parser("search", help="prefix search")
    search.add_argument("prefix")
    search.add_argument(
        "-context", default="all",
        choices=["all", "jobs", "nodes", "allocs", "evals", "deployment"],
    )
    search.add_argument("-namespace", default="default")
    search.set_defaults(fn=cmd_search)

    ev = sub.add_parser("eval", help="evaluation ops").add_subparsers(
        dest="eval_cmd", required=True
    )
    elist = ev.add_parser("list")
    elist.add_argument("--namespace", default="default")
    elist.set_defaults(fn=cmd_eval_list)
    estatus = ev.add_parser("status")
    estatus.add_argument("eval_id")
    estatus.set_defaults(fn=cmd_eval_status)

    sm = sub.add_parser("server", help="server ops").add_subparsers(
        dest="server_cmd", required=True
    )
    sm.add_parser("members").set_defaults(fn=cmd_server_members)
    sjoin = sm.add_parser("join")
    sjoin.add_argument("peer_addr")
    sjoin.set_defaults(fn=cmd_server_join)
    srm = sm.add_parser("remove-peer")
    srm.add_argument("peer_addr")
    srm.set_defaults(fn=cmd_server_remove_peer)

    op = sub.add_parser("operator", help="operator ops").add_subparsers(
        dest="operator_cmd", required=True
    )
    sched = op.add_parser("scheduler")
    sched.add_argument("--algorithm", choices=["binpack", "spread"])
    sched.set_defaults(fn=cmd_operator_scheduler)

    metrics = sub.add_parser("metrics", help="agent metrics")
    metrics.add_argument("--format", choices=["json", "prometheus"],
                         default="json")
    metrics.add_argument("--watch", action="store_true",
                         help="poll and print per-interval counter deltas")
    metrics.add_argument("--interval", type=float, default=2.0)
    metrics.add_argument("--count", type=int, default=0,
                         help="stop after N delta rounds (0 = forever)")
    metrics.set_defaults(fn=cmd_metrics)

    top = sub.add_parser("top", help="live cluster dashboard (evals/s, "
                         "phase latencies, queues, SLO burn rates)")
    top.add_argument("--interval", type=float, default=2.0,
                     help="refresh period in seconds")
    top.add_argument("--count", type=int, default=0,
                     help="render N frames then exit (0 = until ^C)")
    top.add_argument("--no-clear", action="store_true",
                     help="append frames instead of clearing the screen")
    top.set_defaults(fn=cmd_top)

    slo = sub.add_parser("slo", help="SLO report (burn rates, status)")
    slo.add_argument("--health", action="store_true",
                     help="show the composite health report instead")
    slo.add_argument("--overload", action="store_true",
                     help="show the overload controller report instead")
    slo.set_defaults(fn=cmd_slo)

    tr = sub.add_parser("trace", help="eval-lifecycle tracing").add_subparsers(
        dest="trace_cmd", required=True
    )
    tdump = tr.add_parser("dump", help="fetch Chrome/Perfetto trace JSON")
    tdump.add_argument("-o", "--output", default="",
                       help="write to file instead of stdout")
    tdump.add_argument("--limit", type=int, default=None,
                       help="most-recent N spans only")
    tdump.set_defaults(fn=cmd_trace_dump)
    tcfg = tr.add_parser("config", help="show or adjust trace sampling")
    tcfg.add_argument("--sample", type=float, default=None)
    tcfg.add_argument("--ring", type=int, default=None)
    tcfg.add_argument("--enable", action="store_true")
    tcfg.add_argument("--disable", action="store_true")
    tcfg.set_defaults(fn=cmd_trace_config)

    lint = sub.add_parser(
        "lint", help="static analysis: lock discipline, dispatch hot path, "
        "chaos seams, observability, dispatch contracts"
    )
    lint.add_argument("-v", "--verbose", action="store_true")
    lint.add_argument("--baseline", default=None)
    lint.set_defaults(fn=cmd_lint)
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return args.fn(args)
    except APIError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 1
    except FileNotFoundError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
