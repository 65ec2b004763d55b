"""The port's CLI (``nomad_tpu_torch.cli``) against the JAX package's.

The same commands run through each package's ``main([...])`` against its
own agent (a JAX ``Agent`` and a port ``Agent(device="cpu")`` on the same
config, each with an in-process mock-driver client whose node has the same
fixed id); their outputs must be equal once ids, times, indexes and
addresses are masked.  The ACL, namespace and search commands run as
``python -m nomad_tpu_torch.cli`` in a subprocess; ``agent`` runs in one
too: without ``--device cpu`` it must fail on this card-less host, and
with it it serves a ``job run`` and stops on SIGINT with exit code 0.
Modelled on ``tests/test_api.py``, ``test_agent_surface.py`` and
``test_operator_surface.py``.
"""

import dataclasses
import json
import os
import re
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request

import pytest
import torch

from torch_parity import (agent_pair, free_ports, http, settle_agent,
                          wait_until)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

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

_MASKS = (
    (re.compile(r"[0-9a-f]{8}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{4}-"
                r"[0-9a-f]{12}"), "<id>"),
    (re.compile(r"http://127\.0\.0\.1:\d+"), "<addr>"),
    (re.compile(r"/(dispatch|periodic)-\d+(-[0-9a-f]{8})?"), "/<child>"),
    (re.compile(r"\d{4}-\d\d-\d\d \d\d:\d\d:\d\d"), "<time>"),
    (re.compile(r"\b[0-9a-f]{8}\b"), "<id8>"),
    (re.compile(r"(?i)(index:?\s*=?\s*)\d+"), r"\1<n>"),
    (re.compile(r'("[a-z_]*(?:index|time|_at)": )[0-9.e+-]+'), r"\1<n>"),
)


def mask_text(text: str) -> str:
    for pattern, repl in _MASKS:
        text = pattern.sub(repl, text)
    return text


def cli_main(name):
    if name == "jax":
        from nomad_tpu.cli import main
    else:
        from nomad_tpu_torch.cli import main
    return main


# `job run` lists the allocs as soon as the eval completes, before or
# after the in-process client's first update batch (200 ms) reports them
# running, in either package: that one race is folded, every other status
# is compared.
_JUST_PLACED = re.compile(r"\[(pending|running)\]$")


def run_cli(name, agent, capsys, *args):
    """One command through the package's ``main``; returns (rc, masked
    stdout lines, sorted: the stores list a job's allocs in an order that
    concurrent writers may vary, in either package)."""
    capsys.readouterr()
    rc = cli_main(name)(["--address", agent.rpc_addr, *args])
    lines = mask_text(capsys.readouterr().out).splitlines()
    if args[:2] == ("job", "run"):
        lines = [_JUST_PLACED.sub("[pending or running]", ln) for ln in lines]
    return rc, "\n".join(sorted(lines))


def port_cli(*args, timeout=60):
    """``python -m nomad_tpu_torch.cli`` in a subprocess."""
    return subprocess.run(
        [sys.executable, "-m", "nomad_tpu_torch.cli", *args],
        capture_output=True, text=True, timeout=timeout, cwd=REPO,
        env={**os.environ, "PYTHONPATH": REPO},
    )


@pytest.fixture
def pair(tmp_path):
    with agent_pair(tmp_path) as agents:
        yield agents


def write_jobs(tmp_path):
    files = {}
    for name, hcl in (("tiny", TINY), ("scaled", SCALED),
                      ("batchy", PARAMETERIZED)):
        path = tmp_path / f"{name}.hcl"
        path.write_text(hcl)
        files[name] = str(path)
    return files


def test_job_commands_match(pair, tmp_path, capsys):
    files = write_jobs(tmp_path)
    got = {}
    for name, agent in pair.items():
        out = {}
        out["run"] = run_cli(name, agent, capsys, "job", "run", files["tiny"])
        wait_until(lambda: len([
            a for a in agent.server.store.allocs.values()
            if a.client_status == "running"]) == 2, "tiny running")
        settle_agent(agent)
        out["status"] = run_cli(name, agent, capsys, "job", "status", "tiny")
        out["list"] = run_cli(name, agent, capsys, "job", "status")
        out["inspect"] = run_cli(name, agent, capsys, "job", "inspect",
                                 "tiny")
        out["validate"] = run_cli(name, agent, capsys, "job", "validate",
                                  files["tiny"])
        out["plan"] = run_cli(name, agent, capsys, "job", "plan",
                              files["scaled"])
        out["node status"] = run_cli(name, agent, capsys, "node", "status")
        out["eval list"] = run_cli(name, agent, capsys, "eval", "list")
        out["members"] = run_cli(name, agent, capsys, "server", "members")
        out["scheduler"] = run_cli(name, agent, capsys, "operator",
                                   "scheduler", "--algorithm", "spread")
        out["stop"] = run_cli(name, agent, capsys, "job", "stop", "tiny")
        settle_agent(agent)
        out["stopped"] = run_cli(name, agent, capsys, "job", "status", "tiny")
        out["missing"] = run_cli(name, agent, capsys, "job", "status", "nope")
        got[name] = out
    for label in got["jax"]:
        assert got["jax"][label] == got["port"][label], label
    assert got["port"]["run"][0] == 0 and "complete" in got["port"]["run"][1]


def test_scale_dispatch_and_deployment_commands_match(pair, tmp_path,
                                                      capsys):
    files = write_jobs(tmp_path)
    got = {}
    for name, agent in pair.items():
        out = {}
        out["run scaled"] = run_cli(name, agent, capsys, "job", "run",
                                    files["scaled"])
        out["scale"] = run_cli(name, agent, capsys, "job", "scale", "scaled",
                               "g", "2", "--message", "up")
        settle_agent(agent)
        out["scale status"] = run_cli(name, agent, capsys, "job", "scale",
                                      "scaled")
        out["scale past max"] = run_cli(name, agent, capsys, "job", "scale",
                                        "scaled", "g", "9")
        out["history"] = run_cli(name, agent, capsys, "job", "history",
                                 "scaled")
        out["deployments"] = run_cli(name, agent, capsys, "deployment",
                                     "list")
        out["run batchy"] = run_cli(name, agent, capsys, "job", "run",
                                    "-detach", files["batchy"])
        payload = tmp_path / "payload.txt"
        payload.write_text("hello")
        out["dispatch"] = run_cli(name, agent, capsys, "job", "dispatch",
                                  "batchy", str(payload), "-meta", "k=v")
        out["dispatch bad meta"] = run_cli(name, agent, capsys, "job",
                                           "dispatch", "batchy", "-meta", "k")
        out["dispatch no meta"] = run_cli(name, agent, capsys, "job",
                                          "dispatch", "batchy")
        settle_agent(agent)
        out["gc"] = run_cli(name, agent, capsys, "system", "gc")
        got[name] = out
    for label in got["jax"]:
        assert got["jax"][label] == got["port"][label], label
    assert got["port"]["scale past max"][0] == 1


def test_job_parse_matches(tmp_path, capsys):
    files = write_jobs(tmp_path)
    outs = []
    for name in ("jax", "port"):
        capsys.readouterr()
        rc = cli_main(name)(["job", "parse", files["scaled"]])
        outs.append((rc, capsys.readouterr().out))
    assert outs[0] == outs[1] and outs[1][0] == 0


CONFIG = """
name       = "from-file"
datacenter = "dc9"
region     = "r1"
bind_addr  = "127.0.0.2"
http_port  = 4747
data_dir   = "{data_dir}"
server {{
  enabled           = true
  workers           = 7
  node_capacity     = 2048
  acl_enabled       = true
  heartbeat_min_ttl = 30
  heartbeat_max_ttl = 60
}}
client {{
  enabled       = true
  servers       = "http://127.0.0.1:4646"
  token         = "node-secret"
  node_class    = "agent"
  artifact_root = "/srv/artifacts"
  meta {{ rack = "r9" }}
  host_volume "shared" {{ path = "/export/shared" }}
  plugin "ext" {{ binary = "/usr/local/bin/ext-driver" }}
}}
"""


def test_config_files_give_the_same_agent_config(tmp_path):
    from nomad_tpu.api.agent import AgentConfig as JAgentConfig
    from nomad_tpu.api.config_file import apply_config as japply
    from nomad_tpu.api.config_file import load_config_files as jload
    from nomad_tpu_torch.api.agent import AgentConfig as TAgentConfig
    from nomad_tpu_torch.api.config_file import apply_config as tapply
    from nomad_tpu_torch.api.config_file import load_config_files as tload

    (tmp_path / "conf").mkdir()
    (tmp_path / "conf" / "a.hcl").write_text(
        CONFIG.format(data_dir=tmp_path / "data"))
    (tmp_path / "conf" / "b.json").write_text(
        '{"server": {"workers": 9, "peers": ["http://h1:1"]}}')
    paths = [str(tmp_path / "conf")]
    jdoc, tdoc = jload(paths), tload(paths)
    assert jdoc == tdoc
    jcfg, tcfg = JAgentConfig(), TAgentConfig()
    japply(jdoc, jcfg)
    tapply(tdoc, tcfg)
    top = [f.name for f in dataclasses.fields(JAgentConfig)
           if f.name not in ("server_config", "client_config")]
    assert [f.name for f in dataclasses.fields(TAgentConfig)] == [
        f.name for f in dataclasses.fields(JAgentConfig)]
    assert {k: getattr(jcfg, k) for k in top} == {
        k: getattr(tcfg, k) for k in top}
    assert dataclasses.asdict(jcfg.client_config) == dataclasses.asdict(
        tcfg.client_config)
    port_fields = {f.name for f in dataclasses.fields(tcfg.server_config)}
    shared = [f.name for f in dataclasses.fields(jcfg.server_config)
              if f.name in port_fields]
    for key in ("num_workers", "node_capacity", "acl_enabled", "peers",
                "raft_enabled", "heartbeat_min_ttl", "heartbeat_max_ttl", "data_dir"):
        assert key in shared
    assert {k: getattr(jcfg.server_config, k) for k in shared
            if k != "scheduler_config"} == {
        k: getattr(tcfg.server_config, k) for k in shared
        if k != "scheduler_config"}
    assert tcfg.server_config.num_workers == 9
    assert tcfg.server_config.peers == ["http://h1:1"]


def spawn_agent(tmp_path, *args):
    """``python -m nomad_tpu_torch.cli agent --device cpu --port 0`` with
    ``args``; returns the process and its address from the start line."""
    agent = subprocess.Popen(
        [sys.executable, "-m", "nomad_tpu_torch.cli", "agent", "--device",
         "cpu", "--port", "0", *args],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=str(tmp_path), env={**os.environ, "PYTHONPATH": REPO},
    )
    line = agent.stdout.readline()
    if not line.startswith("agent started; HTTP API at "):
        agent.kill()
        raise AssertionError(line + agent.stderr.read())
    return agent, line.rsplit(" ", 1)[1].strip()


def stop_agent(agent):
    """SIGINT; the agent must exit 0 within 30 s."""
    try:
        agent.send_signal(signal.SIGINT)
        assert agent.wait(timeout=30) == 0
    finally:
        if agent.poll() is None:
            agent.kill()
            agent.wait(timeout=15)


def raft_stats(addr, secret=None):
    headers = {"X-Nomad-Cluster-Secret": secret} if secret else {}
    req = urllib.request.Request(addr + "/v1/internal/raft/stats", data=b"{}",
                                 method="POST", headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=10) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read())


@pytest.mark.parametrize("key", ["server_id", "cluster_secret"])
def test_config_file_replication_settings_match_reference(tmp_path, key):
    """``server_id`` and ``cluster_secret`` land in ``ServerConfig`` as the
    reference's ``apply_config`` puts them, and ``agent`` starts a
    replicated server with them: the id in the raft stats, the secret
    required of raft RPCs."""
    from nomad_tpu.api.agent import AgentConfig as JAgentConfig
    from nomad_tpu.api.config_file import apply_config as japply
    from nomad_tpu.api.config_file import load_config_files as jload
    from nomad_tpu_torch.api.agent import AgentConfig
    from nomad_tpu_torch.api.config_file import apply_config, load_config_files

    conf = tmp_path / "agent.hcl"
    conf.write_text(f'server {{\n  workers = 1\n  node_capacity = 16\n'
                    f'  raft_enabled = true\n  {key} = "s1"\n}}\n')
    jcfg, tcfg = JAgentConfig(), AgentConfig()
    japply(jload([str(conf)]), jcfg)
    apply_config(load_config_files([str(conf)]), tcfg)
    got = {k: getattr(tcfg.server_config, k)
           for k in ("server_id", "cluster_secret", "raft_enabled")}
    assert got == {k: getattr(jcfg.server_config, k) for k in got}
    assert got[key] == "s1" and got["raft_enabled"] is True

    agent, addr = spawn_agent(tmp_path, "--config", str(conf))
    try:
        secret = "s1" if key == "cluster_secret" else None
        wait_until(lambda: raft_stats(addr, secret)[1].get("Role")
                   == "leader", "the lone server to lead")
        code, stats = raft_stats(addr, secret)
        assert code == 200
        assert stats["ID"] == ("s1" if key == "server_id" else addr)
        if key == "cluster_secret":
            assert raft_stats(addr)[0] == 403
            assert raft_stats(addr, "wrong")[0] == 403
    finally:
        stop_agent(agent)


def test_acl_namespace_and_search_through_the_module(tmp_path, capsys):
    """The port's CLI as a module in a subprocess against the port agent;
    the JAX CLI's ``main`` against the JAX agent; equal outputs."""
    rules = tmp_path / "p.hcl"
    rules.write_text('namespace "default" { policy = "write" }')
    with agent_pair(tmp_path, client=False, acl_enabled=True) as pair:
        got = {}
        for name, agent in pair.items():
            def cli(*args, token=""):
                head = ["--address", agent.rpc_addr]
                if token:
                    head += ["--token", token]
                if name == "jax":
                    capsys.readouterr()
                    rc = cli_main("jax")([*head, *args])
                    return rc, capsys.readouterr().out
                proc = port_cli(*head, *args)
                assert not proc.stderr or proc.returncode, proc.stderr
                return proc.returncode, proc.stdout

            out = {}
            rc, text = cli("acl", "bootstrap")
            secret = next(line.split("=")[1].strip()
                          for line in text.splitlines()
                          if line.startswith("Secret ID"))
            out["bootstrap"] = (rc, mask_text(text))
            out["policy"] = cli("acl", "policy-apply", "writer", str(rules),
                                "-description", "w", token=secret)
            rc, text = cli("acl", "token-create", "-name", "ci", "-policy",
                           "writer", token=secret)
            out["token"] = (rc, mask_text(text))
            out["ns apply"] = cli("namespace", "apply", "prod",
                                  "-description", "production", token=secret)
            out["ns list"] = cli("namespace", "list", token=secret)
            out["ns delete"] = cli("namespace", "delete", "prod",
                                   token=secret)
            job = parse_with(name, TINY.replace('"tiny"', '"searchable"'))
            agent.server.submit_job(job)
            settle_agent(agent)
            out["search"] = cli("search", "searchable", token=secret)
            out["search jobs"] = cli("search", "s", "-context", "jobs",
                                     token=secret)
            rc, text = cli("search", "searchable")
            out["search anonymous"] = rc
            got[name] = out
    for label in got["jax"]:
        assert got["jax"][label] == got["port"][label], label
    assert "searchable" in got["port"]["search"][1]


def parse_with(name, hcl):
    if name == "jax":
        from nomad_tpu.jobspec import parse_job
    else:
        from nomad_tpu_torch.jobspec import parse_job
    return parse_job(hcl)


def test_top_renders_against_the_agent(pair, capsys):
    frames = {}
    for name, agent in pair.items():
        capsys.readouterr()
        rc = cli_main(name)(["--address", agent.rpc_addr, "top", "--count",
                             "1", "--no-clear"])
        text = capsys.readouterr().out
        assert rc == 0, text
        frames[name] = [line.split(":")[0].strip()
                        for line in text.splitlines() if ":" in line]
    assert frames["port"] == frames["jax"]
    assert frames["port"][0].startswith("nomad top")


def test_commands_other_than_agent_import_no_torch():
    """The CLI speaks HTTP: importing it (and ``top``) loads neither torch
    nor the server, so no command but ``agent`` can touch a device."""
    code = ("import sys, json\n"
            "import nomad_tpu_torch.cli\n"
            "from nomad_tpu_torch.obs.top import run_top\n"
            "print(json.dumps(sorted(m for m in sys.modules if m == 'torch'"
            " or m.startswith('nomad_tpu_torch.server'))))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=60, cwd=REPO,
                          env={**os.environ, "PYTHONPATH": REPO})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


def test_agent_without_a_device_fails_here(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is visible here")
    proc = port_cli("agent", "--server-only", "--port", "0", timeout=120)
    assert proc.returncode != 0
    assert "no CUDA device is available" in proc.stderr
    assert "agent started" not in proc.stdout


def test_agent_with_replication_flags_runs_a_replicated_server(tmp_path):
    """``agent --raft`` starts a one-member cluster that leads itself;
    ``server join`` adds a second ``agent --peers`` process, ``server
    members`` lists both, ``server remove-peer`` takes the second out;
    both stop on SIGINT with exit code 0."""
    first, addr = spawn_agent(tmp_path, "--server-only", "--raft")
    second = None
    try:
        wait_until(lambda: raft_stats(addr)[1].get("Role") == "leader",
                   "the lone server to lead")
        port = json.loads(port_cli("--address", addr, "server",
                                   "members").stdout)["Members"][0]["Addr"]
        assert port == addr
        second_port = free_ports(1)[0]
        second_addr = f"http://127.0.0.1:{second_port}"
        join = port_cli("--address", addr, "server", "join", second_addr)
        assert join.returncode == 0 and second_addr in join.stdout
        second = subprocess.Popen(
            [sys.executable, "-m", "nomad_tpu_torch.cli", "agent",
             "--device", "cpu", "--server-only", "--port", str(second_port),
             "--peers", addr],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=str(tmp_path), env={**os.environ, "PYTHONPATH": REPO})
        assert second.stdout.readline().startswith("agent started")
        wait_until(lambda: raft_stats(second_addr)[1].get("LeaderAddr")
                   == addr and raft_stats(addr)[1]["Peers"].get(
                       second_addr, {}).get("Healthy"), "the joiner")
        members = json.loads(port_cli("--address", addr, "server",
                                      "members").stdout)["Members"]
        assert sorted(m["Addr"] for m in members) == sorted(
            [addr, second_addr])
        out = port_cli("--address", addr, "server", "remove-peer",
                       second_addr)
        assert out.returncode == 0 and second_addr not in out.stdout
        stop_agent(second)
    finally:
        if second is not None and second.poll() is None:
            second.kill()
            second.wait(timeout=15)
        stop_agent(first)



def test_agent_on_cpu_serves_job_run_and_stops_on_sigint(tmp_path):
    conf = tmp_path / "agent.hcl"
    conf.write_text(f'data_dir = "{tmp_path / "data"}"\n'
                    "server {\n  workers = 1\n  node_capacity = 16\n}\n")
    job = tmp_path / "tiny.hcl"
    job.write_text(TINY)
    agent = subprocess.Popen(
        [sys.executable, "-m", "nomad_tpu_torch.cli", "agent", "--device",
         "cpu", "--port", "0", "--config", str(conf)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=str(tmp_path),
        env={**os.environ, "PYTHONPATH": REPO, "NOMAD_TPU_EXECUTOR_BIN": ""},
    )
    try:
        line = agent.stdout.readline()
        assert line.startswith("agent started; HTTP API at "), (
            line + agent.stderr.read() if agent.poll() is not None else line)
        addr = line.rsplit(" ", 1)[1].strip()
        run = port_cli("--address", addr, "job", "run", str(job))
        assert run.returncode == 0, run.stdout + run.stderr
        assert "Evaluation" in run.stdout and "complete" in run.stdout
        code, allocs, _ = http(addr, "GET", "/v1/job/tiny/allocations")
        assert code == 200 and len(allocs) == 2
        t0 = time.time()
        agent.send_signal(signal.SIGINT)
        rc = agent.wait(timeout=30)
        assert rc == 0 and time.time() - t0 < 30
        assert "shutting down" in agent.stdout.read()
    finally:
        if agent.poll() is None:
            agent.kill()
            agent.wait(timeout=15)
