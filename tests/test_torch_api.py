"""The port's HTTP API against the JAX package's, on the CPU.

Each case starts a JAX ``Agent`` and a port ``Agent(device="cpu")`` on the
same config (one scheduling worker, an in-process mock-driver client whose
node has the same fixed id in both), runs the same requests against each
and compares status codes and bodies with ids, timestamps, indexes and
addresses masked (``torch_parity.assert_same``): every value exactly,
except an alloc's placement scores, which hold to the kernels' contract.
Modelled on ``tests/test_api.py``, ``test_agent_surface.py``,
``test_operator_surface.py``, ``test_stream.py`` and the HTTP part of
``test_slo.py``.
"""

import base64
import json
import queue
import threading
import time
import urllib.request

import pytest
import torch

from torch_parity import (
    AGENT_NODE_ID,
    agent_config,
    agent_pair,
    assert_same,
    free_ports,
    http,
    mask,
    settle_agent,
    start_agent,
    wait_until,
)

# One intra-op thread: these tests share the host's cores with the other
# test workers.
torch.set_num_threads(1)

TINY = """
job "tiny" {
  datacenters = ["dc1"]
  group "g" {
    count = 2
    ephemeral_disk { size = 10 }
    task "t" {
      driver = "mock"
      resources { cpu = 20 memory = 32 }
    }
  }
}
"""

CANARY = """
job "canary" {
  datacenters = ["dc1"]
  group "g" {
    count = 2
    ephemeral_disk { size = 10 }
    update {
      max_parallel      = 1
      canary            = 1
      auto_promote      = false
      min_healthy_time  = "0.15s"
      healthy_deadline  = "8s"
      progress_deadline = "30s"
    }
    task "t" {
      driver = "mock"
      env { V = "%s" }
      resources { cpu = 20 memory = 32 }
    }
  }
}
"""

SLOW_ROLLOUT = """
job "slow" {
  datacenters = ["dc1"]
  group "g" {
    count = 2
    ephemeral_disk { size = 10 }
    update {
      max_parallel      = 1
      min_healthy_time  = "30s"
      healthy_deadline  = "60s"
      progress_deadline = "120s"
    }
    task "t" {
      driver = "mock"
      env { V = "%s" }
      resources { cpu = 20 memory = 32 }
    }
  }
}
"""

PARAMETERIZED = """
job "batchy" {
  type        = "batch"
  datacenters = ["dc1"]
  parameterized {
    payload       = "optional"
    meta_required = ["k"]
  }
  group "g" {
    count = 1
    ephemeral_disk { size = 10 }
    task "t" {
      driver = "mock"
      config { run_for = 0.05 }
      resources { cpu = 20 memory = 32 }
    }
  }
}
"""

SCALED = """
job "scaled" {
  datacenters = ["dc1"]
  group "g" {
    count = 1
    ephemeral_disk { size = 10 }
    scaling {
      min = 1
      max = 3
    }
    task "t" {
      driver = "mock"
      env { V = "%s" }
      resources { cpu = 20 memory = 32 }
    }
  }
}
"""


@pytest.fixture
def pair(tmp_path):
    with agent_pair(tmp_path) as agents:
        yield agents


def api_job(addr, hcl):
    """The job's API form, as the agent's own parse route gives it."""
    code, job, _ = http(addr, "POST", "/v1/jobs/parse", {"JobHCL": hcl})
    assert code == 200, job
    return job


def register(addr, hcl, token=""):
    return http(addr, "PUT", "/v1/jobs", {"Job": api_job(addr, hcl)},
                token=token)


def eval_done(addr, eval_id):
    wait_until(lambda: http(addr, "GET", f"/v1/evaluation/{eval_id}")[1][
        "status"] in ("complete", "failed", "cancelled"), f"eval {eval_id}")


def running(addr, job_id, n):
    allocs = http(addr, "GET", f"/v1/job/{job_id}/allocations")[1]
    live = [a for a in allocs if a["desired_status"] == "run"
            and a["client_status"] == "running"]
    return len(live) == n


def run_both(pair, script):
    """``script(addr, agent)`` on each agent; its records (label ->
    response) compared label by label."""
    got = {name: script(agent.rpc_addr, agent)
           for name, agent in pair.items()}
    assert list(got["jax"]) == list(got["port"])
    for label in got["jax"]:
        assert_same(got["jax"][label], got["port"][label], label)
    return got


def test_job_lifecycle_over_http(pair):
    def script(addr, agent):
        out = {}
        code, body, _ = register(addr, TINY)
        out["register"] = (code, body)
        eval_done(addr, body["EvalID"])
        wait_until(lambda: running(addr, "tiny", 2), "tiny running")
        settle_agent(agent)
        for path in ("/v1/jobs", "/v1/job/tiny", "/v1/job/tiny/allocations",
                     "/v1/job/tiny/evaluations", "/v1/job/tiny/summary",
                     "/v1/job/tiny/deployment", "/v1/nodes",
                     f"/v1/node/{AGENT_NODE_ID}/allocations",
                     "/v1/evaluations", "/v1/allocations",
                     "/v1/agent/self", "/v1/agent/members",
                     "/v1/status/leader"):
            code, body, _ = http(addr, "GET", path)
            if isinstance(body, list):
                body = sorted(mask(body), key=json.dumps)
            out[path] = (code, body)
        alloc = min(http(addr, "GET", "/v1/job/tiny/allocations")[1],
                    key=lambda a: a["name"])
        out["alloc"] = http(addr, "GET", f"/v1/allocation/{alloc['id']}")[:2]
        out["eval allocs"] = len(http(
            addr, "GET", f"/v1/evaluation/{alloc['eval_id']}/allocations")[1])
        code, body, _ = http(addr, "DELETE", "/v1/job/tiny")
        out["stop"] = (code, body)
        eval_done(addr, body["EvalID"])
        settle_agent(agent)
        out["stopped"] = http(addr, "GET", "/v1/job/tiny")[:2]
        out["summary after stop"] = http(addr, "GET",
                                         "/v1/job/tiny/summary")[:2]
        return out

    run_both(pair, script)


def test_404s_and_bad_requests(pair):
    def script(addr, agent):
        out = {}
        for method, path in (
                ("GET", "/v1/job/nope"), ("GET", "/v1/job/nope/summary"),
                ("GET", "/v1/job/nope/versions"), ("DELETE", "/v1/job/nope"),
                ("GET", "/v1/evaluation/nope"), ("GET", "/v1/allocation/nope"),
                ("GET", "/v1/node/nope"), ("GET", "/v1/deployment/nope"),
                ("GET", "/v1/namespace/nope"), ("GET", "/v1/volume/nope"),
                ("GET", "/v1/no/such/route"), ("POST", "/v1/allocation/x/stop"),
                ("PUT", "/v1/acl/bootstrap")):
            out[f"{method} {path}"] = http(addr, method, path)[:2]
        out["missing job"] = http(addr, "PUT", "/v1/jobs", None)[:2]
        out["missing HCL"] = http(addr, "POST", "/v1/jobs/parse", {})[:2]
        out["bad HCL"] = http(addr, "POST", "/v1/jobs/parse",
                              {"JobHCL": 'job "x" {'})[:2]
        job = api_job(addr, TINY)
        out["plan id mismatch"] = http(addr, "PUT", "/v1/job/other/plan",
                                       {"Job": job})[:2]
        return out

    run_both(pair, script)


def test_parse_validate_and_plan(pair):
    def script(addr, agent):
        out = {}
        job = api_job(addr, TINY)
        out["parse"] = job
        out["valid"] = http(addr, "PUT", "/v1/validate/job", {"Job": job})[:2]
        bad = dict(job, task_groups=[])
        out["invalid"] = http(addr, "PUT", "/v1/validate/job",
                              {"Job": bad})[:2]
        out["malformed"] = http(addr, "PUT", "/v1/validate/job",
                                {"Job": dict(job, task_groups="x")})[:2]
        out["plan new"] = http(addr, "PUT", "/v1/job/tiny/plan",
                               {"Job": job, "Diff": True})[:2]
        out["nothing committed"] = (len(agent.server.store.allocs),
                                    agent.server.store.job_by_id(
                                        "default", "tiny") is None)
        code, body, _ = register(addr, TINY)
        eval_done(addr, body["EvalID"])
        wait_until(lambda: running(addr, "tiny", 2), "tiny running")
        settle_agent(agent)
        changed = api_job(addr, TINY.replace(
            'driver = "mock"', 'driver = "mock"\n      env { V = "2" }'))
        before = sorted(agent.server.store.allocs)
        out["plan update"] = http(addr, "PUT", "/v1/job/tiny/plan",
                                  {"Job": changed, "Diff": True})[:2]
        out["allocs untouched"] = sorted(agent.server.store.allocs) == before
        huge = api_job(addr, TINY.replace("cpu = 20", "cpu = 999999")
                       .replace('"tiny"', '"huge"'))
        out["plan failure"] = http(addr, "PUT", "/v1/job/huge/plan",
                                   {"Job": huge})[:2]
        return out

    run_both(pair, script)


def test_scheduler_config_search_and_namespaces(pair):
    def script(addr, agent):
        out = {}
        out["config"] = http(addr, "GET",
                             "/v1/operator/scheduler/configuration")[:2]
        out["set"] = http(addr, "PUT", "/v1/operator/scheduler/configuration",
                          {"scheduler_algorithm": "spread",
                           "preemption_config": {
                               "service_scheduler_enabled": True}})[:2]
        out["config after"] = http(addr, "GET",
                                   "/v1/operator/scheduler/configuration")[:2]
        code, body, _ = register(addr, TINY)
        eval_done(addr, body["EvalID"])
        settle_agent(agent)
        for prefix, context in (("ti", "jobs"), ("parity", "nodes"),
                                ("", "all"), ("zzz", "all")):
            code, body, _ = http(addr, "POST", "/v1/search", {
                "Prefix": prefix, "Context": context})
            out[f"search {prefix!r} {context}"] = (code, {
                k: len(v) if k in ("allocs", "evals") else v
                for k, v in body["Matches"].items()}, body["Truncations"])
        out["ns list"] = http(addr, "GET", "/v1/namespaces")[:2]
        out["ns put"] = http(addr, "PUT", "/v1/namespace/team-a",
                             {"Description": "team a"})[:2]
        out["ns get"] = http(addr, "GET", "/v1/namespace/team-a")[:2]
        out["ns list 2"] = http(addr, "GET", "/v1/namespaces")[:2]
        out["ns delete"] = http(addr, "DELETE", "/v1/namespace/team-a")[:2]
        out["ns delete default"] = http(addr, "DELETE",
                                        "/v1/namespace/default")[:2]
        out["ns gone"] = http(addr, "GET", "/v1/namespace/team-a")[:2]
        return out

    run_both(pair, script)


def test_deployment_promote(pair):
    def script(addr, agent):
        out = {}
        code, body, _ = register(addr, CANARY % "1")
        eval_done(addr, body["EvalID"])
        wait_until(lambda: running(addr, "canary", 2), "v0 running")
        settle_agent(agent)
        code, body, _ = register(addr, CANARY % "2")
        eval_done(addr, body["EvalID"])

        def canary_healthy():
            dep = http(addr, "GET", "/v1/job/canary/deployment")[1]
            return (dep is not None and dep["job_version"] == 1
                    and dep["task_groups"]["g"]["healthy_allocs"] >= 1)

        wait_until(canary_healthy, "the canary healthy")
        dep = http(addr, "GET", "/v1/job/canary/deployment")[1]
        out["parked"] = (dep["status"], dep["status_description"],
                         dep["task_groups"]["g"]["promoted"],
                         dep["task_groups"]["g"]["desired_canaries"])
        out["listed"] = [d["job_version"] for d in http(
            addr, "GET", "/v1/deployments")[1]]
        out["dep allocs"] = len(http(
            addr, "GET", f"/v1/deployment/{dep['id']}/allocations")[1])
        out["promote"] = http(addr, "POST",
                              f"/v1/deployment/{dep['id']}/promote",
                              {"All": True})[:2]
        wait_until(lambda: http(addr, "GET", f"/v1/deployment/{dep['id']}")[
            1]["status"] == "successful", "the deployment successful")
        wait_until(lambda: running(addr, "canary", 2), "v1 running")
        settle_agent(agent)
        done = http(addr, "GET", f"/v1/deployment/{dep['id']}")[1]
        out["done"] = (done["status"], done["status_description"],
                       done["task_groups"]["g"]["promoted"])
        out["promote again"] = http(addr, "POST",
                                    f"/v1/deployment/{dep['id']}/promote",
                                    {})[:2]
        out["job deployments"] = [d["job_version"] for d in http(
            addr, "GET", "/v1/job/canary/deployments")[1]]
        live = [a for a in http(addr, "GET", "/v1/job/canary/allocations")[1]
                if a["desired_status"] == "run"]
        out["live"] = sorted((a["name"], a["client_status"]) for a in live)
        return out

    run_both(pair, script)


def test_deployment_pause_and_fail(pair):
    def script(addr, agent):
        out = {}
        code, body, _ = register(addr, SLOW_ROLLOUT % "1")
        eval_done(addr, body["EvalID"])
        wait_until(lambda: running(addr, "slow", 2), "v0 running")
        settle_agent(agent)
        code, body, _ = register(addr, SLOW_ROLLOUT % "2")
        eval_done(addr, body["EvalID"])
        dep = http(addr, "GET", "/v1/job/slow/deployment")[1]
        out["no canaries"] = http(addr, "POST",
                                  f"/v1/deployment/{dep['id']}/promote",
                                  {})[:2]
        out["pause"] = http(addr, "POST", f"/v1/deployment/{dep['id']}/pause",
                            {"Pause": True})[:2]
        got = http(addr, "GET", f"/v1/deployment/{dep['id']}")[1]
        out["paused"] = (got["status"], got["status_description"])
        out["resume"] = http(addr, "POST", f"/v1/deployment/{dep['id']}/pause",
                             {"Pause": False})[:2]
        got = http(addr, "GET", f"/v1/deployment/{dep['id']}")[1]
        out["resumed"] = (got["status"], got["status_description"])
        out["fail"] = http(addr, "POST", f"/v1/deployment/{dep['id']}/fail",
                           {})[:2]
        got = http(addr, "GET", f"/v1/deployment/{dep['id']}")[1]
        out["failed"] = (got["status"], got["status_description"])
        out["fail again"] = http(addr, "POST",
                                 f"/v1/deployment/{dep['id']}/fail", {})[:2]
        settle_agent(agent)
        return out

    run_both(pair, script)


def test_dispatch_scale_history_revert_and_gc(pair):
    def script(addr, agent):
        out = {}
        code, body, _ = register(addr, PARAMETERIZED)
        out["register parameterized"] = (code, body)
        payload = base64.b64encode(b"hello").decode()
        code, body, _ = http(addr, "POST", "/v1/job/batchy/dispatch",
                             {"Payload": payload, "Meta": {"k": "v"}})
        out["dispatch"] = (code, body)
        child = body["DispatchedJobID"]
        eval_done(addr, body["EvalID"])
        out["child"] = http(addr, "GET", f"/v1/job/{child}")[:2]
        out["dispatch without meta"] = http(
            addr, "POST", "/v1/job/batchy/dispatch", {"Meta": {}})[:2]
        code, body, _ = register(addr, SCALED % "1")
        eval_done(addr, body["EvalID"])
        out["dispatch not parameterized"] = http(
            addr, "POST", "/v1/job/scaled/dispatch", {"Meta": {"k": "v"}})[:2]
        code, body, _ = http(addr, "POST", "/v1/job/scaled/scale", {
            "Target": {"Group": "g"}, "Count": 2, "Message": "up"})
        out["scale up"] = (code, body)
        eval_done(addr, body["EvalID"])
        wait_until(lambda: running(addr, "scaled", 2), "scaled to 2")
        out["scale past max"] = http(addr, "POST", "/v1/job/scaled/scale", {
            "Target": {"Group": "g"}, "Count": 5})[:2]
        out["scale unknown group"] = http(
            addr, "POST", "/v1/job/scaled/scale",
            {"Target": {"Group": "nope"}, "Count": 2})[:2]
        out["scale status"] = http(addr, "GET", "/v1/job/scaled/scale")[:2]
        out["policies"] = http(addr, "GET", "/v1/scaling/policies")[:2]
        code, body, _ = register(addr, SCALED % "2")
        eval_done(addr, body["EvalID"])
        settle_agent(agent)
        out["history"] = http(addr, "GET", "/v1/job/scaled/versions")[:2]
        code, body, _ = http(addr, "POST", "/v1/job/scaled/revert",
                             {"JobVersion": 0})
        out["revert"] = (code, body)
        eval_done(addr, body["EvalID"])
        settle_agent(agent)
        out["reverted"] = http(addr, "GET", "/v1/job/scaled")[1][
            "task_groups"][0]["tasks"][0]["env"]
        out["revert missing"] = http(addr, "POST", "/v1/job/scaled/revert",
                                     {"JobVersion": 99})[:2]
        code, body, _ = http(addr, "DELETE", "/v1/job/scaled?purge=true")
        eval_done(addr, body["EvalID"])
        settle_agent(agent)
        out["gc"] = http(addr, "PUT", "/v1/system/gc", {})[:2]
        settle_agent(agent)
        out["purged"] = http(addr, "GET", "/v1/job/scaled")[:2]
        return out

    run_both(pair, script)


def read_stream(addr, path, stop, lines):
    """Read an NDJSON stream into ``lines`` until ``stop`` is set."""
    with urllib.request.urlopen(addr + path, timeout=30) as resp:
        while not stop.is_set():
            line = resp.readline()
            if not line:
                return
            lines.put(json.loads(line))


def test_event_stream_with_topic_filter(pair):
    def script(addr, agent):
        stop = threading.Event()
        lines: "queue.Queue" = queue.Queue()
        reader = threading.Thread(target=read_stream, daemon=True, args=(
            addr, "/v1/event/stream?topic=Job:tiny&topic=Deployment:*",
            stop, lines))
        reader.start()
        try:
            # The subscription exists before the writes.
            wait_until(lambda: agent.server.store.events.subscriber_count()
                       >= 1, "the stream subscribed")
            code, body, _ = register(addr, TINY)
            eval_done(addr, body["EvalID"])
            code, body, _ = http(addr, "DELETE", "/v1/job/tiny")
            eval_done(addr, body["EvalID"])
            settle_agent(agent)
            events = []
            deadline = time.time() + 20
            while len(events) < 2 and time.time() < deadline:
                try:
                    ev = lines.get(timeout=0.5)
                except queue.Empty:
                    continue
                if ev:
                    events.append(ev)
            time.sleep(0.3)
            while not lines.empty():
                ev = lines.get()
                if ev:
                    events.append(ev)
        finally:
            stop.set()
        return {"events": events}

    got = run_both(pair, script)
    assert [(e["Topic"], e["Type"], e["Key"])
            for e in got["port"]["events"]] == [
        ("Job", "JobRegistered", "tiny"), ("Job", "JobRegistered", "tiny")]


def test_observability_routes(tmp_path):
    with agent_pair(tmp_path, slo_enabled=True, overload_enabled=True) as pair:
        def script(addr, agent):
            out = {}
            code, body, _ = register(addr, TINY)
            eval_done(addr, body["EvalID"])
            settle_agent(agent)
            for path in ("/v1/slo", "/v1/health", "/v1/overload"):
                code, body, _ = http(addr, "GET", path)
                out[path] = (code, key_paths(body))
            code, body, _ = http(addr, "GET", "/v1/health")
            out["health status"] = body["status"]
            code, snap, _ = http(addr, "GET", "/v1/metrics")
            out["metrics"] = (code, sorted(snap))
            code, text, hdrs = http(addr, "GET",
                                    "/v1/metrics?format=prometheus", raw=True)
            out["prometheus"] = (code, hdrs["Content-Type"], sorted({
                line.split()[2] for line in text.decode().splitlines()
                if line.startswith("# TYPE")}))
            code, body, _ = http(addr, "GET", "/v1/trace/config")
            out["trace config"] = (code, sorted(body))
            code, body, _ = http(addr, "GET", "/v1/trace?limit=5")
            out["trace"] = (code, sorted(body))
            code, body, _ = http(addr, "GET", "/v1/agent/profile")
            out["profile"] = (code, sorted(body), body["Count"] > 0)
            code, html, hdrs = http(addr, "GET", "/ui", raw=True)
            out["ui"] = (code, hdrs["Content-Type"], html)
            return out

        got = {name: script(a.rpc_addr, a) for name, a in pair.items()}
    # The port's registry lacks exactly the gauges whose subjects it does
    # not have (ROADMAP "Drops": the coalescer counters).
    dropped = {"nomad.kernel.feature_recompiles",
               "nomad.kernel.operand_bytes_total",
               "nomad.kernel.verify_conflicts",
               "nomad.topk.host_bytes_total"}
    jax_metrics = got["jax"].pop("metrics")
    port_metrics = got["port"].pop("metrics")
    assert port_metrics[0] == jax_metrics[0] == 200
    assert sorted(set(jax_metrics[1]) - dropped) == port_metrics[1]
    jax_prom = got["jax"].pop("prometheus")
    port_prom = got["port"].pop("prometheus")
    assert jax_prom[:2] == port_prom[:2]
    prom_dropped = {"nomad_kernel_feature_recompiles",
                    "nomad_kernel_operand_bytes_total",
                    "nomad_kernel_verify_conflicts",
                    "nomad_topk_host_bytes_total"}
    assert sorted(set(jax_prom[2]) - prom_dropped) == port_prom[2]
    assert any(n.startswith("nomad_coalescer_dispatches")
               for n in port_prom[2])
    for label in got["jax"]:
        assert_same(got["jax"][label], got["port"][label], label)


def key_paths(obj, prefix=""):
    """Every key path of a JSON body (the shape, without its values)."""
    out = []
    if isinstance(obj, dict):
        for k, v in obj.items():
            out.append(f"{prefix}.{k}")
            out.extend(key_paths(v, f"{prefix}.{k}"))
    elif isinstance(obj, list) and obj:
        out.extend(key_paths(obj[0], f"{prefix}[]"))
    return sorted(set(out))


def test_admission_429_and_handler_500(tmp_path):
    with agent_pair(tmp_path, overload_enabled=True, admission_rate=0.001,
                    admission_burst=1.0) as pair:
        def script(addr, agent):
            out = {}
            out["first"] = register(addr, TINY)[0]
            code, body, hdrs = register(
                addr, TINY.replace('"tiny"', '"second"'))
            retry_after = float(hdrs["Retry-After"])
            out["second"] = (code, body, retry_after > 0)
            # An exception no route maps to a status: the generic 500.
            out["500"] = http(addr, "POST", "/v1/internal/node/heartbeat",
                              {})[:2]
            out["500 register"] = http(addr, "POST",
                                       "/v1/internal/node/register", {})[:2]
            return out

        run_both(pair, script)


def test_acl_routes(tmp_path):
    with agent_pair(tmp_path, client=False, acl_enabled=True) as pair:
        def script(addr, agent):
            out = {}
            out["anonymous jobs"] = http(addr, "GET", "/v1/jobs")[:2]
            code, boot, _ = http(addr, "PUT", "/v1/acl/bootstrap", {})
            out["bootstrap"] = (code, boot)
            out["bootstrap again"] = http(addr, "PUT", "/v1/acl/bootstrap",
                                          {})[:2]
            mgmt = boot["secret_id"]
            rules = 'namespace "default" { capabilities = ["submit-job"] }'
            out["policy"] = http(addr, "PUT", "/v1/acl/policy/deployer", {
                "Rules": rules, "Description": "d"}, token=mgmt)[:2]
            out["policies"] = http(addr, "GET", "/v1/acl/policies",
                                   token=mgmt)[:2]
            code, tok, _ = http(addr, "PUT", "/v1/acl/token", {
                "Name": "deployer", "Type": "client",
                "Policies": ["deployer"]}, token=mgmt)
            out["token"] = (code, tok)
            secret = tok["secret_id"]
            out["self"] = http(addr, "GET", "/v1/acl/token/self",
                               token=secret)[:2]
            job = api_job(addr, TINY)
            out["anonymous submit"] = http(addr, "PUT", "/v1/jobs",
                                           {"Job": job})[:2]
            out["client token policies"] = http(addr, "GET",
                                                "/v1/acl/policies",
                                                token=secret)[:2]
            out["other namespace"] = http(
                addr, "PUT", "/v1/jobs",
                {"Job": dict(job, namespace="other")}, token=secret)[:2]
            code, body, _ = http(addr, "PUT", "/v1/jobs", {"Job": job},
                                 token=secret)
            out["submit"] = code
            out["nodes anonymous"] = http(addr, "GET", "/v1/nodes")[:2]
            out["stream anonymous"] = http(addr, "GET",
                                           "/v1/event/stream")[:2]
            out["tokens"] = sorted(t["name"] for t in http(
                addr, "GET", "/v1/acl/tokens", token=mgmt)[1])
            out["ns put by client"] = http(addr, "PUT", "/v1/namespace/x", {},
                                           token=secret)[:2]
            return out

        run_both(pair, script)


def test_replication_routes_answer_501(pair):
    def script(addr, agent):
        out = {}
        for path in ("/v1/internal/raft/stats", "/v1/internal/raft/append",
                     "/v1/internal/raft/vote", "/v1/internal/raft/snapshot"):
            out[path] = http(addr, "POST", path, {})[:2]
        out["join"] = http(addr, "PUT", "/v1/operator/raft/join",
                           {"Addr": "http://127.0.0.1:1"})[:2]
        out["remove"] = http(addr, "PUT", "/v1/operator/raft/remove-peer",
                             {"Addr": "http://127.0.0.1:1"})[:2]
        out["join without addr"] = http(addr, "PUT",
                                        "/v1/operator/raft/join", {})[:2]
        out["leader"] = http(addr, "GET", "/v1/status/leader")[1] == addr
        out["members"] = http(addr, "GET", "/v1/agent/members")[:2]
        return out

    got = run_both(pair, script)
    assert got["port"]["join"][0] == 501
    assert got["port"]["leader"] is True


def replicated_agents(pkg, tmp_path, field):
    """Two server agents of one package: with ``peers`` both list both
    addresses; with ``raft_enabled`` the first starts alone and the
    second joins it through ``PUT /v1/operator/raft/join``.  Returns what
    each step answered."""
    if pkg == "jax":
        from nomad_tpu.api import Agent
    else:
        from nomad_tpu_torch.api import Agent
    ports = free_ports(2)
    addrs = [f"http://127.0.0.1:{p}" for p in ports]

    def build(i):
        cfg = agent_config(pkg, tmp_path / f"s{i}", client=False,
                           server_id=f"server-{i}",
                           election_timeout=(0.15, 0.3),
                           raft_heartbeat_interval=0.05)
        cfg.http_port = ports[i]
        if field == "peers":
            cfg.server_config.peers = list(addrs)
        else:
            cfg.server_config.raft_enabled = True
            cfg.server_config.peers = [addrs[0]] if i else []
        return Agent(cfg) if pkg == "jax" else Agent(cfg, device="cpu")

    agents, out = [], {}
    try:
        if field == "peers":
            agents = [build(0), build(1)]
        else:
            agents = [build(0)]
            agents[0].start()
            wait_until(lambda: agents[0].server.replicator.is_leader,
                       "the lone server to lead")
            out["join"] = http(addrs[0], "PUT", "/v1/operator/raft/join",
                               {"Addr": addrs[1]})[:2]
            agents.append(build(1))
        out["roles at start"] = sorted(
            a.server.replicator.role for a in agents if not a.started_at)
        for a in agents:
            if not a.started_at:
                a.start()
        wait_until(lambda: sum(a.server.replicator.is_leader
                               for a in agents) == 1, "one leader")
        leader = next(a for a in agents if a.server.replicator.is_leader)
        wait_until(lambda: all(len(a.server.replicator.peers) == 1
                               and a.server.replicator.leader_addr
                               == leader.rpc_addr for a in agents),
                   "both members and the leader known everywhere")
        for i, a in enumerate(agents):
            out[f"leader {i}"] = http(a.rpc_addr, "GET",
                                      "/v1/status/leader")[1] == (
                                          leader.rpc_addr)
            out[f"members {i}"] = sorted(
                m["Addr"] == leader.rpc_addr for m in http(
                    a.rpc_addr, "GET", "/v1/agent/members")[1]["Members"])
        code, body, _ = http(leader.rpc_addr, "PUT", "/v1/jobs",
                             {"Job": api_job(leader.rpc_addr, TINY)})
        out["submit"] = code
        wait_until(lambda: all(a.server.store.job_by_id("default", "tiny")
                               for a in agents), "the job on both servers")
        return out
    finally:
        for a in agents:
            a.shutdown()


@pytest.mark.parametrize("field", ["peers", "raft_enabled"])
def test_agent_with_replication_config_follows_and_joins(tmp_path, field):
    """An agent configured with ``peers`` or ``raft_enabled`` runs a
    replicated server: it starts as a follower, one leader is elected (or
    the lone one leads and the other joins it), and writes reach both; as
    the reference's agents do."""
    got = {pkg: replicated_agents(pkg, tmp_path / pkg, field)
           for pkg in ("jax", "port")}
    assert_same(got["jax"], got["port"])
    assert got["port"]["submit"] == 200
    if field == "raft_enabled":
        assert got["port"]["join"][0] == 200


def test_port_agent_without_a_card_raises(tmp_path):
    from nomad_tpu_torch.api import Agent

    cfg = agent_config("port", tmp_path, client=False)
    if torch.cuda.is_available():
        pytest.skip("a card is visible here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Agent(cfg)


def test_blocked_client_query_wakes_on_shutdown(tmp_path):
    """A blocking client-allocs query parked in the server returns when
    the server shuts down, not when its wait runs out."""
    agent = start_agent("port", agent_config("port", tmp_path, client=False))
    result = {}

    def query():
        result["resp"] = http(agent.rpc_addr, "POST",
                              "/v1/internal/node/client-allocs",
                              {"NodeID": "n", "MinIndex": 10 ** 9,
                               "Wait": 50.0}, timeout=60)

    t = threading.Thread(target=query, daemon=True)
    t.start()
    time.sleep(0.3)
    t0 = time.time()
    agent.server.shutdown()
    t.join(10)
    # A query that comes after the shutdown is refused at once.
    t1 = time.time()
    late = http(agent.rpc_addr, "POST", "/v1/internal/node/client-allocs",
                {"NodeID": "n", "MinIndex": 10 ** 9, "Wait": 50.0},
                timeout=60)
    late_s = time.time() - t1
    agent.http.shutdown()
    assert not t.is_alive() and time.time() - t0 < 10
    assert result["resp"][0] == 200
    assert late[0] == 500 and "shut down" in late[1]["error"]
    assert late_s < 10


def test_client_backs_off_from_a_shut_down_server(tmp_path):
    """An in-process client whose server shut down first takes its watch
    backoff (0.25 s, doubling) instead of asking again at once."""
    from nomad_tpu_torch.client import Client, ClientConfig
    from nomad_tpu_torch.server import Server, ServerConfig

    srv = Server(ServerConfig(num_workers=1, node_capacity=16,
                              heartbeat_min_ttl=3600.0,
                              heartbeat_max_ttl=7200.0), device="cpu")
    srv.start()
    client = Client(srv, ClientConfig(data_dir=str(tmp_path / "c")))
    client.start()
    calls = []
    inner = srv.get_client_allocs

    def counted(*a, **kw):
        calls.append(time.time())
        return inner(*a, **kw)

    srv.get_client_allocs = counted
    try:
        srv.shutdown()
        time.sleep(1.5)
    finally:
        client.shutdown()
    assert 1 <= len(calls) <= 6, len(calls)


def test_listener_backlog_takes_concurrent_callers(tmp_path):
    """The port's listener queues 128 connections (ROADMAP R12): the
    reference's ``ThreadingHTTPServer`` keeps socketserver's 5, so a sixth
    caller connecting at once has its SYN dropped and retried a second
    later.  Every one of 32 concurrent callers is answered."""
    from nomad_tpu_torch.api.http_server import HTTPAPIServer

    agent = start_agent("port", agent_config("port", tmp_path, client=False))
    try:
        assert isinstance(agent.http, HTTPAPIServer)
        assert agent.http.httpd.request_queue_size >= 128
        codes = []

        def call():
            codes.append(http(agent.rpc_addr, "GET", "/v1/agent/self")[0])

        threads = [threading.Thread(target=call) for _ in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        assert not any(t.is_alive() for t in threads)
        assert codes == [200] * 32
    finally:
        agent.shutdown()


def test_failover_rpc_retargets_to_the_live_server(pair):
    """``FailoverRPC`` over a dead address and the agent's: the node RPCs
    land on the live server in both packages."""
    from nomad_tpu.api.rpc import FailoverRPC as JFailoverRPC
    from nomad_tpu_torch.api.rpc import FailoverRPC as TFailoverRPC

    got = {}
    for name, rpc_cls in (("jax", JFailoverRPC), ("port", TFailoverRPC)):
        agent = pair[name]
        rpc = rpc_cls(["http://127.0.0.1:1", agent.rpc_addr], timeout=5.0)
        ttl = rpc.heartbeat_node(AGENT_NODE_ID)
        allocs, index = rpc.get_client_allocs(AGENT_NODE_ID, 0, timeout=1.0)
        got[name] = (rpc.current == agent.rpc_addr, 3600.0 <= ttl <= 7200.0,
                     len(allocs), index)
    assert got["jax"] == got["port"] == (True, True, 0, 0)


def open_monitor(addr, tag, got, done):
    """Read ``/v1/agent/monitor`` until a record holding ``tag`` arrives
    (into ``got``), then until the stream ends (sets ``done``)."""
    def reader():
        req = urllib.request.Request(addr + "/v1/agent/monitor"
                                     "?log_level=warning")
        with urllib.request.urlopen(req, timeout=30) as resp:
            for line in resp:
                rec = json.loads(line)
                if rec and tag in rec.get("Message", ""):
                    got.append(rec)
        done.set()

    t = threading.Thread(target=reader, daemon=True)
    t.start()
    return t


def test_monitor_streams_logs(pair):
    import logging

    records = {}
    for name, agent in pair.items():
        got, done = [], threading.Event()
        t = open_monitor(agent.rpc_addr, f"monitor-{name}", got, done)
        time.sleep(0.3)
        logging.getLogger("parity.monitor").warning("monitor-%s ping", name)
        wait_until(lambda: got, "the monitor record", timeout=20)
        records[name] = dict(got[0], Message=got[0]["Message"].replace(
            name, "<pkg>"))
        assert t.is_alive()  # the stream stays open for more
    assert_same(records["jax"], records["port"], "monitor")
    assert records["port"]["Level"] == "WARNING"


def test_streams_end_when_the_api_shuts_down(tmp_path):
    """The monitor and event streams of a port agent end when it shuts
    down (the reference's loops run until their reader hangs up)."""
    agent = start_agent("port", agent_config("port", tmp_path, client=False))
    got, done = [], threading.Event()
    try:
        t = open_monitor(agent.rpc_addr, "never-logged", got, done)
        stop = threading.Event()
        lines: "queue.Queue" = queue.Queue()
        events = threading.Thread(target=read_stream, daemon=True, args=(
            agent.rpc_addr, "/v1/event/stream", stop, lines))
        events.start()
        wait_until(lambda: agent.server.store.events.subscriber_count() >= 1,
                   "the stream subscribed")
        time.sleep(0.3)
    finally:
        t0 = time.time()
        agent.shutdown()
    t.join(10)
    events.join(10)
    assert done.is_set() and not t.is_alive() and not events.is_alive()
    assert time.time() - t0 < 10
