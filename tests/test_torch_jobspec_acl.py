"""The port's jobspec (HCL lexer and parser, ``parse_job``, ``job_to_api``,
``api_to_job``) and ACLs (``parse_policy``, ``ACL``, the server's
``bootstrap_acl``, ``resolve_token`` and ``check_acl_capability``) on the
CPU, against the JAX package's.

* the HCL jobs of the reference's API, ACL and alloc-fs tests parse to
  equal ``job_to_api`` dicts in both packages, and round-trip through
  ``api_to_job``;
* broken inputs raise ``HCLParseError`` with equal messages and lines;
* ACL decisions agree over a grid of policies x namespaces x
  capabilities, and on the node/agent/operator domains;
* the servers' token resolution agrees: bootstrap once, the anonymous
  policy, unknown secrets never cached, the cache invalidated by a bump of
  the ``acl_token``/``acl_policy`` table indexes; ACL state survives a
  restart of the port's server.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from nomad_tpu import acl as jacl
from nomad_tpu import jobspec as jjobspec
from nomad_tpu import mock as jmock
from nomad_tpu.jobspec import hcl as jhcl
from nomad_tpu.jobspec import parse as jparse
from nomad_tpu.server.server import Server as JServer
from nomad_tpu.server.server import ServerConfig as JServerConfig
from nomad_tpu.structs import types as jtypes
from nomad_tpu_torch import acl as tacl
from nomad_tpu_torch import jobspec as tjobspec
from nomad_tpu_torch import mock as tmock
from nomad_tpu_torch.jobspec import hcl as thcl
from nomad_tpu_torch.jobspec import parse as tparse
from nomad_tpu_torch.server.server import Server, ServerConfig
from nomad_tpu_torch.structs import types as ttypes

REPO = Path(__file__).resolve().parents[1]

# The HCL jobs of tests/test_api.py:16 and :207, tests/test_acl.py:19 and
# :216, and tests/test_alloc_fs.py:25.
EXAMPLE_HCL = """
# An example job.
job "web-app" {
  datacenters = ["dc1", "dc2"]
  type = "service"
  priority = 70

  meta {
    owner = "team-a"
  }

  constraint {
    attribute = "${attr.kernel.name}"
    value     = "linux"
  }

  update {
    max_parallel = 2
    canary       = 1
    auto_revert  = true
    min_healthy_time = "15s"
  }

  group "web" {
    count = 3

    restart {
      attempts = 2
      interval = "30m"
      delay    = "15s"
      mode     = "fail"
    }

    ephemeral_disk {
      size = 500
    }

    spread {
      attribute = "${attr.rack}"
      weight    = 50
      target "r1" { percent = 60 }
      target "r2" { percent = 40 }
    }

    network {
      port "http" {}
      port "admin" { static = 9901 }
    }

    task "server" {
      driver = "mock"

      config {
        run_for = 10
      }

      env {
        PORT = "8080"
      }

      resources {
        cpu    = 250
        memory = 128
      }

      affinity {
        attribute = "${attr.platform.tpu.type}"
        value     = "v5e"
        weight    = 75
      }

      service "web-svc" {
        port = "http"
        tags = ["frontend"]
      }
    }

    task "sidecar" {
      driver = "mock"
      lifecycle {
        hook    = "prestart"
        sidecar = true
      }
      resources {
        cpu    = 50
        memory = 32
      }
    }
  }

  group "worker" {
    count = 2
    task "work" {
      driver = "mock"
      resources { cpu = 100 memory = 64 }
    }
  }
}
"""

SMALL_JOB = """
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

ACL_JOB = SMALL_JOB.replace("count = 2", "count = 1")

LOG_JOB_ACL = """
job "aclogger" {
  datacenters = ["dc1"]
  group "g" {
    count = 1
    ephemeral_disk { size = 10 }
    task "main" {
      driver = "raw_exec"
      config {
        command = "/bin/sh"
        args = ["-c", "echo acl-ok; sleep 300"]
      }
      resources { cpu = 20 memory = 32 }
    }
  }
}
"""

LOG_JOB = LOG_JOB_ACL.replace("aclogger", "logger").replace(
    "acl-ok", "hello-logs")

# Every block kind parse_job reads, beyond the jobs above: periodic,
# parameterized, reschedule, migrate, scaling, volumes, devices,
# templates, artifacts, dispatch payload, logs, distinct_* sugar, a
# heredoc, block comments and escapes.
FULL_HCL = r'''
/* a block
   comment */
job "full" {
  namespace = "batch-ns"
  type = "batch"
  region = "eu"
  all_at_once = true
  periodic {
    cron = "*/5 * * * *"
    prohibit_overlap = true
    time_zone = "Europe/Paris"
  }
  parameterized {
    payload = "optional"
    meta_required = ["k"]
  }
  constraint {
    distinct_hosts = true
  }
  constraint {
    distinct_property = "${meta.rack}"
    value = 2
  }
  affinity {
    attribute = "${node.datacenter}"
    operator = "!="
    value = "dc9"
  }
  group "g" {
    count = 4
    stop_after_client_disconnect = "1m30s"
    reschedule {
      attempts = 3
      interval = "1h"
      delay = "10s"
      delay_function = "constant"
      max_delay = "2m"
      unlimited = false
    }
    migrate {
      max_parallel = 2
      health_check = "task_states"
      min_healthy_time = "5s"
      healthy_deadline = "2m"
    }
    update {
      max_parallel = 3
      stagger = "45s"
      progress_deadline = "20m"
      auto_promote = true
    }
    scaling {
      min = 1
      max = 8
      policy {
        cooldown = "1m"
      }
    }
    volume "data" {
      type = "csi"
      source = "vol-1"
      read_only = true
      per_alloc = true
    }
    task "t" {
      driver = "exec"
      leader = true
      kill_timeout = "250ms"
      config {
        command = "run"
        args = ["--flag=\"x\"", "tab\there"]
      }
      template {
        data = <<EOT
line one ${NOMAD_ALLOC_ID}
line two
EOT
        destination = "local/out.txt"
      }
      artifact {
        source = "https://example.invalid/a.tgz"
      }
      dispatch_payload {
        file = "input.json"
      }
      logs {
        max_files = 3
        max_file_size = 7
      }
      volume_mount {
        volume = "data"
        destination = "/srv"
        read_only = true
      }
      resources {
        cpu = 300
        memory_mb = 200
        disk = 50
        device "nvidia/gpu" {
          count = 2
          constraint {
            attribute = "${device.attr.memory}"
            operator = ">="
            value = "8 GiB"
          }
        }
        network {
          mbits = 10
          port "rpc" {}
        }
      }
      constraint {
        attribute = "${attr.cpu.arch}"
        value = "amd64"
      }
    }
  }
}
'''

JOBS = {
    "example": EXAMPLE_HCL,
    "small": SMALL_JOB,
    "acl": ACL_JOB,
    "logger": LOG_JOB,
    "aclogger": LOG_JOB_ACL,
    "full": FULL_HCL,
}


@pytest.mark.parametrize("name", sorted(JOBS))
def test_parsed_jobs_match(name):
    src = JOBS[name]
    want = jjobspec.job_to_api(jjobspec.parse_job(src))
    got = tjobspec.job_to_api(tjobspec.parse_job(src))
    assert got == want
    # The API's JSON form round-trips to the same job in both packages,
    # and the JSON job format parses to it too.
    wire = json.loads(json.dumps(got))
    assert tjobspec.job_to_api(tjobspec.api_to_job(wire)) == got
    assert jjobspec.job_to_api(jjobspec.api_to_job(wire)) == want
    assert tjobspec.job_to_api(
        tjobspec.parse_job(json.dumps({"Job": wire}))) == got
    assert isinstance(tjobspec.parse_job(src), ttypes.Job)


def test_parsed_example_fields():
    job = tjobspec.parse_job(EXAMPLE_HCL)
    web = job.task_groups[0]
    assert job.id == "web-app" and job.priority == 70
    assert job.update.min_healthy_time == 15.0
    assert web.restart_policy.interval == 1800.0
    assert web.networks[0].dynamic_ports == ["http"]
    assert web.networks[0].reserved_ports == [9901]
    assert web.tasks[1].lifecycle_hook == "prestart"
    full = tjobspec.parse_job(FULL_HCL)
    assert full.task_groups[0].tasks[0].kill_timeout == 0.25
    assert full.task_groups[0].stop_after_client_disconnect == 90.0
    assert full.task_groups[0].tasks[0].templates[0]["data"].startswith(
        "line one ${NOMAD_ALLOC_ID}")


@pytest.mark.parametrize("text", ["15s", "5m", "1h30m", "250ms", "2", 7,
                                  3.5, None, "soon"])
def test_durations_match(text):
    assert tparse.duration(text, 1.25) == jparse.duration(text, 1.25)


BROKEN = [
    'a = 1\nb = = 2\n',
    'job "x" {\n  group "g" {\n',
    'job "x" { a = [1, 2 }',
    'a = {x y}',
    'a = @',
    'job "x" "y" = 3',
    '}',
    'a = { 1 = 2 }',
    'job "x" { a = 1 }\njob = 2\njob "x" { b = 2 }',
]


def parse_outcome(hcl, src):
    """The tree, or the error's message and line."""
    try:
        return ("tree", hcl.parse_hcl(src))
    except hcl.HCLParseError as e:
        return ("error", str(e), e.line)


@pytest.mark.parametrize("src", BROKEN)
def test_parse_errors_match(src):
    got = parse_outcome(thcl, src)
    assert got == parse_outcome(jhcl, src)
    # A stray closing brace ends the top level early in both packages.
    assert got[0] == ("tree" if src == "}" else "error")


@pytest.mark.parametrize("src", [
    'job "x" { type = "service" }',
    'nothing = 1',
    'job "x" {\n  type = "service"\n  group "g" { count = 1 }\n}',
])
def test_job_errors_match(src):
    with pytest.raises(ValueError) as want:
        jjobspec.parse_job(src)
    with pytest.raises(ValueError) as got:
        tjobspec.parse_job(src)
    assert str(got.value) == str(want.value)


def test_hcl_trees_match():
    for src in list(JOBS.values()) + [
        'a = "x${y}z"\nb { c = 1 }\nb { c = 2 }\nm = { k: "v", "q" = [] }',
    ]:
        assert thcl.parse_hcl(src) == jhcl.parse_hcl(src)


# ---------------------------------------------------------------------------
# ACL policies and decisions
# ---------------------------------------------------------------------------

POLICIES = [
    'namespace "default" { policy = "read" }',
    'namespace "default" { policy = "write" }',
    'namespace "default" { policy = "deny" }',
    'namespace "team-*" { policy = "write" }',
    'namespace "team-a" { capabilities = ["read-job", "scale-job"] }',
    'namespace "*" { policy = "read" }\nnamespace "ops-*" { policy = "deny" }',
    'namespace "ops-prod" { capabilities = ["submit-job"] }',
    'node { policy = "read" }\nagent { policy = "write" }',
    'operator { policy = "write" }\nnode { policy = "deny" }',
    'namespace "default" {\n  policy = "read"\n  capabilities = ["alloc-exec"]\n}',
    '',
]
NAMESPACES = ["default", "team-a", "team-b", "ops-prod", "other"]
CAPABILITIES = [
    "list-jobs", "read-job", "submit-job", "dispatch-job", "read-logs",
    "read-fs", "alloc-exec", "alloc-lifecycle", "scale-job", "deny",
]
# Policy sets: each policy alone, and pairs in which deny must dominate or
# the widest grant must win.
POLICY_SETS = [[i] for i in range(len(POLICIES))] + [
    [1, 2], [3, 4], [5, 6], [7, 8], [0, 9], [3, 5, 8],
]


def decisions(pkg, policy_set):
    acl = pkg.ACL([pkg.parse_policy(POLICIES[i]) for i in policy_set])
    out = [acl.allow_namespace(ns, cap)
           for ns in NAMESPACES for cap in CAPABILITIES]
    for want in ("read", "write"):
        out += [acl.allow_node(want), acl.allow_agent(want),
                acl.allow_operator(want)]
    return out


@pytest.mark.parametrize("policy_set", POLICY_SETS,
                         ids=["+".join(map(str, s)) for s in POLICY_SETS])
def test_acl_decisions_match(policy_set):
    got = decisions(tacl, policy_set)
    assert got == decisions(jacl, policy_set)
    assert len(got) == len(NAMESPACES) * len(CAPABILITIES) + 6


def test_management_and_deny_all_match():
    for t, j in ((tacl.MANAGEMENT_ACL, jacl.MANAGEMENT_ACL),
                 (tacl.DENY_ALL_ACL, jacl.DENY_ALL_ACL)):
        for ns in NAMESPACES:
            for cap in CAPABILITIES:
                assert t.allow_namespace(ns, cap) == j.allow_namespace(ns, cap)
        for want in ("read", "write"):
            assert t.allow_node(want) == j.allow_node(want)
            assert t.allow_operator(want) == j.allow_operator(want)


@pytest.mark.parametrize("rules", [
    'namespace "x" { policy = "sudo" }',
    'node { policy = "admin" }',
    'namespace "x" { policy = ',
])
def test_bad_policies_rejected_alike(rules):
    with pytest.raises(jacl.ACLParseError) as want:
        jacl.parse_policy(rules)
    with pytest.raises(tacl.ACLParseError) as got:
        tacl.parse_policy(rules)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# The servers' ACL methods
# ---------------------------------------------------------------------------


def make_server(pkg, **kw):
    kw.setdefault("num_workers", 1)
    kw.setdefault("node_capacity", 16)
    kw.setdefault("slo_enabled", False)
    kw.setdefault("overload_enabled", False)
    if pkg == "jax":
        return JServer(JServerConfig(**kw)), jtypes
    return Server(ServerConfig(**kw), device="cpu"), ttypes


CHECKS = [
    ("namespace", "submit-job", "default"),
    ("namespace", "submit-job", "other"),
    ("namespace", "read-job", "default"),
    ("namespace", "read-job", "team-a"),
    ("node", "read", "default"),
    ("operator", "write", "default"),
    ("agent", "read", "default"),
]


def acl_script(pkg):
    """Bootstrap, two policies, three tokens; every check for every secret
    before and after the policies change and the anonymous policy
    appears.  Returns the decisions and what was cached."""
    srv, types = make_server(pkg, acl_enabled=True)
    out = []
    boot = srv.bootstrap_acl()
    with pytest.raises(PermissionError):
        srv.bootstrap_acl()
    out.append(boot.type)
    srv.store.upsert_acl_policy(srv.next_index(), types.ACLPolicy(
        name="deployer",
        rules='namespace "default" { capabilities = ["submit-job"] }'))
    srv.store.upsert_acl_policy(srv.next_index(), types.ACLPolicy(
        name="reader", rules='namespace "team-*" { policy = "read" }\n'
                             'node { policy = "read" }'))
    dep = types.ACLToken(name="dep", type="client", policies=["deployer"])
    both = types.ACLToken(name="both", type="client",
                          policies=["deployer", "reader", "missing"])
    srv.store.upsert_acl_tokens(srv.next_index(), [dep, both])
    secrets = {"boot": boot.secret_id, "dep": dep.secret_id,
               "both": both.secret_id, "none": "", "bad": "no-such-secret"}

    def round_():
        row = {}
        for who, secret in secrets.items():
            row[who] = [srv.check_acl_capability(secret, *c) for c in CHECKS]
            row[who + ".resolved"] = srv.resolve_token(secret) is not None
        return row

    out.append(round_())
    # The unknown secret is never cached; the others are, by table index.
    names = {secret: who for who, secret in secrets.items()}
    out.append(sorted(names[key[0]] for key in srv._acl_cache))
    cached = srv.resolve_token(dep.secret_id)
    assert srv.resolve_token(dep.secret_id) is cached
    # A policy change bumps acl_policy's index: the next resolution
    # compiles afresh and sees the new rules.
    srv.store.upsert_acl_policy(srv.next_index(), types.ACLPolicy(
        name="deployer", rules='namespace "*" { policy = "write" }'))
    srv.store.upsert_acl_policy(srv.next_index(), types.ACLPolicy(
        name="anonymous", rules='namespace "default" { policy = "read" }'))
    assert srv.resolve_token(dep.secret_id) is not cached
    out.append(round_())
    # A token change bumps acl_token's index.
    before = srv.resolve_token(both.secret_id)
    srv.store.upsert_acl_tokens(srv.next_index(), [types.ACLToken(
        name="late", type="management")])
    assert srv.resolve_token(both.secret_id) is not before
    out.append(round_())
    srv.shutdown()
    return out


def test_server_acl_methods_match():
    got = acl_script("port")
    assert got == acl_script("jax")
    first = got[1]
    assert first["dep"][0] is True and first["dep"][1] is False
    assert first["none"] == [False] * len(CHECKS)
    assert first["bad"] == [False] * len(CHECKS)
    assert first["bad.resolved"] is False
    assert first["boot"] == [True] * len(CHECKS)
    assert got[2] == ["boot", "both", "dep", "none"]


def test_acl_disabled_allows_everything():
    for pkg in ("jax", "port"):
        srv, _ = make_server(pkg)
        assert srv.check_acl_capability("", "namespace", "submit-job",
                                        "other")
        assert srv.resolve_token("whatever").management
        srv.shutdown()


def test_acl_state_survives_a_restart(tmp_path):
    """The ACL tables are journaled: a restored port server resolves the
    same tokens to the same decisions."""
    srv = Server(ServerConfig(num_workers=1, node_capacity=16,
                              acl_enabled=True, data_dir=str(tmp_path),
                              slo_enabled=False, overload_enabled=False),
                 device="cpu")
    boot = srv.bootstrap_acl()
    srv.store.upsert_acl_policy(srv.next_index(), ttypes.ACLPolicy(
        name="deployer",
        rules='namespace "default" { capabilities = ["submit-job"] }'))
    tok = ttypes.ACLToken(name="dep", type="client", policies=["deployer"])
    srv.store.upsert_acl_tokens(srv.next_index(), [tok])
    want = [srv.check_acl_capability(s, *c) for s in
            (boot.secret_id, tok.secret_id, "") for c in CHECKS]
    wal = srv.store.wal
    srv.store.wal = None  # crash-stop: no shutdown snapshot
    srv.shutdown()
    wal.close()
    again = Server(ServerConfig(num_workers=1, node_capacity=16,
                                acl_enabled=True, data_dir=str(tmp_path),
                                slo_enabled=False, overload_enabled=False),
                   device="cpu")
    try:
        got = [again.check_acl_capability(s, *c) for s in
               (boot.secret_id, tok.secret_id, "") for c in CHECKS]
        assert got == want
        assert got[len(CHECKS)] is True  # the client token submits
        with pytest.raises(PermissionError):
            again.bootstrap_acl()
    finally:
        again.shutdown()


def test_parsed_job_places_on_the_port():
    """An HCL job parsed by the port and submitted by a token that may
    submit it places like the JAX package's (same count on each)."""
    placed = {}
    for pkg, jobspec, mock in (("jax", jjobspec, jmock),
                               ("port", tjobspec, tmock)):
        srv, _ = make_server(pkg, acl_enabled=True,
                             heartbeat_min_ttl=3600.0,
                             heartbeat_max_ttl=7200.0)
        srv.start()
        try:
            for _ in range(4):
                srv.register_node(mock.node())
            boot = srv.bootstrap_acl()
            assert srv.check_acl_capability(boot.secret_id, "namespace",
                                            "submit-job", "default")
            ev = srv.submit_job(jobspec.parse_job(SMALL_JOB))
            assert srv.wait_for_eval(ev.id, 60).status == "complete"
            placed[pkg] = sorted(a.name for a in srv.store.allocs.values()
                                 if not a.terminal_status())
        finally:
            srv.shutdown()
    assert placed["port"] == placed["jax"] == ["tiny.g[0]", "tiny.g[1]"]


def test_new_modules_import_without_jax():
    code = (
        "import json, sys\n"
        "before = set(sys.modules)\n"
        "import nomad_tpu_torch.jobspec, nomad_tpu_torch.acl\n"
        "import nomad_tpu_torch.trace, nomad_tpu_torch.trace.export\n"
        "import nomad_tpu_torch.obs.breaker, nomad_tpu_torch.obs.top\n"
        "print(json.dumps(sorted(set(sys.modules) - before)))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=str(REPO), timeout=120)
    assert out.returncode == 0, out.stderr
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert "nomad_tpu_torch.obs.breaker" in loaded
    bad = [m for m in loaded if m == "jax" or m.startswith("jax.")
           or m == "nomad_tpu" or m.startswith("nomad_tpu.")]
    assert bad == []
