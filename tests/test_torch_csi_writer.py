"""The CSI single-writer check of ``submit_job``, in both packages.

A group of count > 1 that mounts a writable, not per-alloc CSI volume
whose registered volume is ``single-node-writer`` is refused before
anything journals (``nomad_tpu/server/server.py`` ``submit_job``). The
same job goes through a JAX server and a port server (in process, then
over each package's HTTP API); the message and the HTTP code must agree,
and neither store may hold the job afterwards. The cases that are allowed
(count 1, read-only, per-alloc, a multi-writer volume, no registered
volume) are accepted by both.
"""

import pytest
import torch

from torch_parity import agent_pair, http

torch.set_num_threads(1)

WRITER_JOB = """
job "writer" {
  datacenters = ["dc1"]
  group "web" {
    count = %(count)d
    volume "data" {
      type      = "csi"
      source    = "v"
      read_only = %(read_only)s
      per_alloc = %(per_alloc)s
    }
    task "t" {
      driver = "mock"
      resources { cpu = 20 memory = 32 }
    }
  }
}
"""


def _hcl(count=2, read_only=False, per_alloc=False):
    return WRITER_JOB % {"count": count,
                         "read_only": str(read_only).lower(),
                         "per_alloc": str(per_alloc).lower()}


def _pkg(name):
    if name == "jax":
        from nomad_tpu import mock
        from nomad_tpu.jobspec import parse_job
        from nomad_tpu.server import Server, ServerConfig
        from nomad_tpu.structs.types import Volume
        return mock, parse_job, Server, ServerConfig, Volume, {}
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.jobspec import parse_job
    from nomad_tpu_torch.server import Server, ServerConfig
    from nomad_tpu_torch.structs.types import Volume
    return mock, parse_job, Server, ServerConfig, Volume, {"device": "cpu"}


def _submit(name, hcl, access_mode="single-node-writer", register=True):
    """Submit ``hcl`` to a fresh server of package ``name``; returns
    ("ok", None) or ("refused", message), and whether the store holds
    the job."""
    _, parse_job, Server, ServerConfig, Volume, kw = _pkg(name)
    srv = Server(ServerConfig(num_workers=1, node_capacity=16,
                              slo_enabled=False, overload_enabled=False),
                 **kw)
    try:
        if register:
            srv.store.upsert_volume(srv.next_index(), Volume(
                id="v", namespace="default", access_mode=access_mode))
        job = parse_job(hcl)
        try:
            srv.submit_job(job)
            out = ("ok", None)
        except ValueError as exc:
            out = ("refused", str(exc))
        return out, srv.store.job_by_id("default", "writer") is not None
    finally:
        srv.shutdown()


def test_single_writer_volume_refused_with_the_references_message():
    got = {name: _submit(name, _hcl(count=2)) for name in ("jax", "port")}
    assert got["jax"] == got["port"]
    (verdict, msg), stored = got["port"]
    assert verdict == "refused"
    assert msg == ("group 'web': volume 'v' has single-node-writer access "
                   "mode but count=2")
    assert not stored


@pytest.mark.parametrize("case", [
    dict(hcl=dict(count=1)),
    dict(hcl=dict(count=2, read_only=True)),
    dict(hcl=dict(count=2, per_alloc=True)),
    dict(hcl=dict(count=2), access_mode="multi-node-multi-writer"),
    dict(hcl=dict(count=2), register=False),
], ids=["count1", "read_only", "per_alloc", "multi_writer", "unregistered"])
def test_allowed_volume_jobs_accepted_by_both(case):
    kw = {k: v for k, v in case.items() if k != "hcl"}
    got = {name: _submit(name, _hcl(**case["hcl"]), **kw)
           for name in ("jax", "port")}
    assert got["jax"] == got["port"] == (("ok", None), True)


def test_single_writer_refusal_is_the_same_http_answer(tmp_path):
    """Over each package's HTTP API the refusal is a 400 whose body is the
    same message; the job is not stored."""
    with agent_pair(tmp_path, client=False) as pair:
        answers = {}
        for name, agent in pair.items():
            _, _, _, _, Volume, _ = _pkg(name)
            srv = agent.server
            srv.store.upsert_volume(srv.next_index(), Volume(
                id="v", namespace="default"))
            addr = agent.rpc_addr
            code, job, _ = http(addr, "POST", "/v1/jobs/parse",
                                {"JobHCL": _hcl(count=3)})
            assert code == 200, job
            code, body, _ = http(addr, "PUT", "/v1/jobs", {"Job": job})
            answers[name] = (code, body)
            assert srv.store.job_by_id("default", "writer") is None
    assert answers["jax"] == answers["port"]
    code, body = answers["port"]
    assert code == 400
    assert "single-node-writer access mode but count=3" in str(body)
