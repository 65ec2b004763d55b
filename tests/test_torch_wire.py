"""The wire between agents in their own processes, the port against the
JAX package.

For each package three OS processes run its CLI's ``agent`` command: a
server-only agent (the port's with ``--device cpu``) and two client-only
agents (``--client-only --servers <addr>``, class ``agent``, their node
ids seeded in their data directories so both packages place alike).  They
speak only HTTP: registration, heartbeats, the blocking ``client-allocs``
query held open by the server, and batched alloc updates.  The task
filesystem, logs and exec are asked of the *server* agent, which forwards
to the node agent's advertised address; a sticky, migrating ephemeral disk
moves between the two node agents when its node drains.  Each package's
responses must be equal once ids, timestamps, indexes and addresses are
masked (``torch_parity.assert_same``).  Modelled on ``tests/test_wire.py``,
``test_alloc_fs.py`` and ``test_alloc_exec.py``.
"""

import base64
import json
import os
import signal
import subprocess
import sys
import time
import urllib.request

import pytest

from torch_parity import assert_same, http, mask, wait_until

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NODES = ("wire-agent-0", "wire-agent-1")

JAX_CLI = ("import sys; sys.path.insert(0, {repo!r}); import __graft_entry__;"
           " __graft_entry__._scrub_non_cpu_backends();"
           " from nomad_tpu.cli import main; sys.exit(main(sys.argv[1:]))")

SERVER_HCL = """
server {
  workers           = 1
  node_capacity     = 16
  heartbeat_min_ttl = 3600
  heartbeat_max_ttl = 7200
}
"""

AGENT_HCL = """
data_dir = "%s"
client {
  enabled    = true
  node_class = "agent"
  meta { agent = "%d" }
}
"""

LOGGER = """
job "logger" {
  datacenters = ["dc1"]
  constraint {
    attribute = "${node.class}"
    value     = "agent"
  }
  group "g" {
    count = 2
    ephemeral_disk { size = 10 }
    task "main" {
      driver = "raw_exec"
      env { GREETING = "bonjour" }
      config {
        command = "/bin/sh"
        args    = ["-c", "echo hello-$NOMAD_ALLOC_INDEX; echo oops >&2; echo file-$NOMAD_ALLOC_INDEX > local/note.txt; sleep 300"]
      }
      resources {
        cpu    = 20
        memory = 32
      }
    }
  }
}
"""

STICKY = """
job "sticky" {
  datacenters = ["dc1"]
  constraint {
    attribute = "${node.class}"
    value     = "agent"
  }
  group "g" {
    count = 1
    ephemeral_disk {
      size    = 10
      sticky  = true
      migrate = true
    }
    task "main" {
      driver = "raw_exec"
      config {
        command = "/bin/sh"
        args    = ["-c", "test -f local/state.txt || echo first-$NOMAD_ALLOC_ID > local/state.txt; sleep 300"]
      }
      resources {
        cpu    = 20
        memory = 32
      }
    }
  }
}
"""


def spawn(pkg, args, cwd):
    env = {**os.environ, "PYTHONPATH": REPO, "NOMAD_TPU_EXECUTOR_BIN": "",
           "JAX_PLATFORMS": "cpu"}
    if pkg == "jax":
        cmd = [sys.executable, "-u", "-c", JAX_CLI.format(repo=REPO), *args]
    else:
        cmd = [sys.executable, "-u", "-m", "nomad_tpu_torch.cli", *args]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, cwd=str(cwd),
                            env=env)


def agent_addr(proc, timeout=90.0):
    """The address from the agent's ``agent started; HTTP API at`` line."""
    deadline = time.time() + timeout
    while time.time() < deadline:
        line = proc.stdout.readline()
        if not line:
            break
        if line.startswith("agent started; HTTP API at "):
            return line.rsplit(" ", 1)[1].strip()
    proc.kill()
    raise AssertionError(f"agent never started: {proc.stderr.read()}")


def stop(proc, timeout=30.0):
    """SIGINT (the agent's clean stop), then kill; returns the exit code."""
    if proc.poll() is None:
        proc.send_signal(signal.SIGINT)
        try:
            return proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
    return proc.wait(timeout=15)


def ready_nodes(addr):
    return sorted(n["id"] for n in http(addr, "GET", "/v1/nodes")[1]
                  if n["status"] == "ready")


@pytest.fixture(scope="module")
def wire(tmp_path_factory):
    """Per package: a server agent and two client-only agents, each in its
    own process; yields {pkg: {"addr", "procs", "agents"}}."""
    root = tmp_path_factory.mktemp("wire")
    out = {pkg: {"procs": [], "agents": []} for pkg in ("jax", "port")}
    try:
        for pkg in out:
            conf = root / f"{pkg}-server.hcl"
            conf.write_text(SERVER_HCL)
            args = ["agent", "--server-only", "--port", "0", "--config",
                    str(conf)]
            if pkg == "port":
                args += ["--device", "cpu"]
            out[pkg]["procs"].append(spawn(pkg, args, root))
        for pkg in out:
            out[pkg]["addr"] = agent_addr(out[pkg]["procs"][0])
        # One node agent at a time, in the same order in both packages, so
        # their matrix rows (and so the placements) agree.
        for i, node_id in enumerate(NODES):
            for pkg in out:
                data = root / f"{pkg}-agent-{i}"
                state = data / "client" / "state"
                state.mkdir(parents=True)
                (state / "node.json").write_text(
                    json.dumps({"node_id": node_id}))
                conf = root / f"{pkg}-agent-{i}.hcl"
                conf.write_text(AGENT_HCL % (data, i))
                proc = spawn(pkg, ["agent", "--client-only", "--servers",
                                   out[pkg]["addr"], "--port", "0",
                                   "--config", str(conf)], root)
                out[pkg]["procs"].append(proc)
                out[pkg]["agents"].append(agent_addr(proc))
            for pkg in out:
                wait_until(lambda: ready_nodes(out[pkg]["addr"])
                           == sorted(NODES[:i + 1]), f"{pkg} node {i}",
                           timeout=60)
        yield out
    finally:
        for pkg in out:
            # Node agents first (they kill their tasks), then the server.
            for proc in reversed(out[pkg]["procs"]):
                stop(proc)


def register(addr, hcl):
    code, job, _ = http(addr, "POST", "/v1/jobs/parse", {"JobHCL": hcl})
    assert code == 200, job
    code, body, _ = http(addr, "PUT", "/v1/jobs", {"Job": job})
    assert code == 200, body
    return body


def live(addr, job_id):
    return [a for a in http(addr, "GET", f"/v1/job/{job_id}/allocations")[1]
            if a["desired_status"] == "run"]


def wait_running(addr, job_id, n, timeout=60):
    wait_until(lambda: len([a for a in live(addr, job_id)
                            if a["client_status"] == "running"]) == n,
               f"{job_id} running x{n}", timeout=timeout)


def by_index(addr, job_id):
    """The job's live allocs by their index in the group name."""
    return {int(a["name"].rsplit("[", 1)[1][:-1]): a
            for a in live(addr, job_id)}


def exec_frames(addr, alloc_id, body):
    req = urllib.request.Request(
        f"{addr}/v1/client/exec/{alloc_id}", data=json.dumps(body).encode(),
        method="POST", headers={"Content-Type": "application/json"})
    out = {"stdout": b"", "stderr": b"", "exit": None}
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            for line in resp:
                frame = json.loads(line)
                for key in ("stdout", "stderr"):
                    if key in frame:
                        out[key] += base64.b64decode(frame[key])
                if "exit" in frame:
                    out["exit"] = frame["exit"]
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read())
    return 200, {k: (v.decode() if isinstance(v, bytes) else v)
                 for k, v in out.items()}


def both(wire, script):
    got = {pkg: script(w["addr"], w) for pkg, w in wire.items()}
    for label in got["jax"]:
        assert_same(got["jax"][label], got["port"][label], label)
    return got


def test_full_lifecycle_across_processes(wire):
    def script(addr, w):
        out = {}
        out["nodes"] = sorted(mask(http(addr, "GET", "/v1/nodes")[1]),
                              key=json.dumps)
        body = register(addr, LOGGER)
        wait_until(lambda: http(addr, "GET", f"/v1/evaluation/"
                                f"{body['EvalID']}")[1]["status"]
                   == "complete", "logger eval")
        wait_running(addr, "logger", 2)
        allocs = by_index(addr, "logger")
        out["placed"] = {i: (a["node_id"], a["client_status"])
                         for i, a in sorted(allocs.items())}
        out["node allocs"] = {n: len(http(addr, "GET",
                                          f"/v1/node/{n}/allocations")[1])
                              for n in NODES}
        advertised = {n: http(addr, "GET", f"/v1/node/{n}")[1]["attributes"]
                      ["nomad.advertise.address"] for n in NODES}
        out["advertised"] = sorted(advertised.values()) == sorted(w["agents"])
        out["agent self"] = http(w["agents"][0], "GET", "/v1/agent/self")[:2]
        out["client stats"] = http(w["agents"][0], "GET",
                                   "/v1/client/stats")[0]
        out["client agent has no server"] = http(w["agents"][0], "GET",
                                                 "/v1/jobs")[:2]
        return out

    got = both(wire, script)
    assert got["port"]["advertised"] is True


def test_blocking_query_held_by_the_server(wire):
    def script(addr, w):
        out = {}
        code, first, _ = http(addr, "POST", "/v1/internal/node/client-allocs",
                              {"NodeID": NODES[0], "MinIndex": 0, "Wait": 5})
        out["immediate"] = (code, len(first["Allocs"]))
        t0 = time.time()
        code, held, _ = http(addr, "POST", "/v1/internal/node/client-allocs",
                             {"NodeID": NODES[0], "MinIndex": first["Index"],
                              "Wait": 1.0})
        waited = time.time() - t0
        out["held"] = (code, held["Index"] == first["Index"],
                       0.8 <= waited < 15.0)
        out["heartbeat"] = http(addr, "POST", "/v1/internal/node/heartbeat",
                                {"NodeID": NODES[0]})[0]
        return out

    both(wire, script)


def test_fs_logs_and_exec_forwarded_by_the_server(wire):
    def script(addr, w):
        out = {}
        wait_running(addr, "logger", 2)
        allocs = by_index(addr, "logger")
        for i, a in sorted(allocs.items()):
            aid = a["id"]
            wait_until(lambda: http(addr, "GET", f"/v1/client/fs/logs/{aid}"
                                    "?task=main&type=stdout", raw=True)[1]
                       == f"hello-{i}\n".encode(), f"alloc {i} logs")
            out[f"ls {i}"] = http(addr, "GET",
                                  f"/v1/client/fs/ls/{aid}?path=main/local")
            out[f"cat {i}"] = http(
                addr, "GET", f"/v1/client/fs/cat/{aid}?path=main/local/"
                "note.txt", raw=True)[:2]
            out[f"stderr {i}"] = http(
                addr, "GET", f"/v1/client/fs/logs/{aid}?task=main&"
                "type=stderr&offset=-3", raw=True)[:2]
            out[f"escape {i}"] = http(
                addr, "GET", f"/v1/client/fs/cat/{aid}?path=../../../../etc/"
                "passwd")[:2]
            out[f"exec {i}"] = exec_frames(addr, aid, {
                "Task": "main", "Cmd": ["/bin/sh", "-c",
                                        "cat; echo $GREETING; exit 3"],
                "Stdin": base64.b64encode(b"piped-in\n").decode()})
        aid = allocs[0]["id"]
        out["exec unknown task"] = exec_frames(addr, aid, {
            "Task": "nope", "Cmd": ["true"]})
        out["exec unknown alloc"] = exec_frames(addr, "nope", {
            "Cmd": ["true"]})
        out["fs unknown alloc"] = http(addr, "GET",
                                       "/v1/client/fs/ls/nope?path=")[:2]
        # Follow: the first chunk arrives through the server's forward and
        # the stream stays open.
        with urllib.request.urlopen(
                f"{addr}/v1/client/fs/logs/{aid}?task=main&type=stdout&"
                "follow=true", timeout=30) as resp:
            out["follow"] = resp.readline()
        for i in sorted(allocs):
            out[f"ls {i}"] = (out[f"ls {i}"][0], sorted(
                (e["Name"], e["IsDir"], e["Size"]) for e in out[f"ls {i}"][1]))
        return out

    got = both(wire, script)
    assert got["port"]["exec 0"] == (200, {
        "stdout": "piped-in\nbonjour\n", "stderr": "", "exit": 3})
    assert got["port"]["cat 1"] == (200, b"file-1\n")
    assert got["port"]["follow"] == b"hello-0\n"


def test_cross_node_sticky_migration(wire):
    """A sticky, migrating ephemeral disk follows its alloc to the other
    node agent when the node drains: the new agent fetches the old one's
    files over that agent's fs routes."""
    def script(addr, w):
        out = {}
        body = register(addr, STICKY)
        wait_running(addr, "sticky", 1)
        first = live(addr, "sticky")[0]
        wait_until(lambda: http(addr, "GET", f"/v1/client/fs/cat/"
                                f"{first['id']}?path=main/local/state.txt",
                                raw=True)[0] == 200, "the state file")
        content = http(addr, "GET", f"/v1/client/fs/cat/{first['id']}"
                       "?path=main/local/state.txt", raw=True)[1]
        out["written"] = content == f"first-{first['id']}\n".encode()
        code, _, _ = http(addr, "PUT", f"/v1/node/{first['node_id']}/drain",
                          {"DrainSpec": {"Deadline": 60}})
        out["drain"] = code

        def moved():
            allocs = [a for a in live(addr, "sticky")
                      if a["node_id"] != first["node_id"]
                      and a["client_status"] == "running"]
            return allocs[0] if allocs else None

        wait_until(lambda: moved() is not None, "the replacement running",
                   timeout=90)
        second = moved()
        out["previous"] = second["previous_allocation"] == first["id"]
        out["nodes"] = (first["node_id"], second["node_id"])
        code, data, _ = http(addr, "GET", f"/v1/client/fs/cat/{second['id']}"
                             "?path=main/local/state.txt", raw=True)
        out["migrated"] = (code, data == content)
        out["old stopped"] = http(addr, "GET", f"/v1/allocation/"
                                  f"{first['id']}")[1]["desired_status"]
        http(addr, "DELETE", "/v1/job/sticky")
        http(addr, "DELETE", "/v1/job/logger")
        return out

    got = both(wire, script)
    assert got["port"]["migrated"] == (200, True)
    assert got["port"]["nodes"][0] != got["port"]["nodes"][1]


def test_client_only_agent_creates_no_cuda_state(tmp_path):
    """A client-only agent builds no server and touches no device: run one
    against a port server agent on the CPU and ask its process."""
    script = (
        "import sys, json, time\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "import torch\n"
        "from nomad_tpu_torch.api import Agent, AgentConfig, APIClient\n"
        "from nomad_tpu_torch.client import ClientConfig\n"
        "server = Agent(AgentConfig(client_enabled=False), device='cpu')\n"
        "server.server.config.heartbeat_min_ttl = 3600\n"
        "server.start()\n"
        "cfg = AgentConfig(server_enabled=False, server_addr=server.rpc_addr,"
        f" client_config=ClientConfig(data_dir={str(tmp_path)!r}))\n"
        "client = Agent(cfg)\n"
        "client.start()\n"
        "ok = client.server is None and server.server is not None\n"
        "print(json.dumps({'ok': ok, 'cuda': torch.cuda.is_initialized(),"
        " 'nodes': len(server.server.store.nodes)}))\n"
        "client.shutdown(); server.shutdown()\n"
    )
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True,
                          text=True, timeout=120, cwd=str(tmp_path),
                          env={**os.environ, "PYTHONPATH": REPO})
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.splitlines()[-1]) == {
        "ok": True, "cuda": False, "nodes": 1}
