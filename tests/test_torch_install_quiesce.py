"""A snapshot install while dry runs are in flight (ROADMAP P1).

``Server.plan_job`` runs the scheduler, the coalescer and the kernels
against a pinned snapshot, from any thread (``POST /v1/job/<id>/plan``
reaches it from the HTTP handler threads).  ``Server.install_snapshot``
clears the node matrix and refills it from the image.  A dry run that
overlaps an install would read rows that the install reassigned, and name
nodes of the new image that its snapshot never held.  The install waits
for the dry runs in flight and holds new ones off until the image is in;
every dry run here must plan only onto nodes of the snapshot it read.
"""

import threading
import time

import torch

from nomad_tpu_torch import mock as tmock
from nomad_tpu_torch.api.agent import Agent, AgentConfig
from nomad_tpu_torch.server import server as server_mod
from nomad_tpu_torch.server.server import Server, ServerConfig

from torch_parity import http

torch.set_num_threads(1)

PROBE_HCL = """
job "probe" {
  datacenters = ["dc1"]
  group "web" {
    count = 3
    task "t" {
      driver = "mock"
      resources {
        cpu    = 100
        memory = 64
      }
    }
  }
}
"""


def quiet_config(**kw):
    return ServerConfig(num_workers=2, node_capacity=128,
                        heartbeat_min_ttl=3600, heartbeat_max_ttl=7200,
                        slo_enabled=False, overload_enabled=False, **kw)


def image(prefix: str, n_nodes: int):
    """(snapshot wire, index) of a server holding ``n_nodes`` nodes whose
    ids start with ``prefix``."""
    srv = Server(quiet_config(), device="cpu")
    try:
        for i in range(n_nodes):
            node = tmock.node()
            node.id = f"{prefix}-{i:03d}"
            node.name = node.id
            srv.register_node(node)
        return srv.store.to_snapshot_wire(), srv.store.latest_index
    finally:
        srv.shutdown()


class Recorder(server_mod._DryRunPlanner):
    """The dry-run planner, keeping every instance for the checks and the
    node ids its snapshot held when the dry run began (a snapshot reads
    through to the live store, which a later install replaces)."""

    made: list = []
    lock = threading.Lock()

    def __init__(self, snapshot):
        super().__init__(snapshot)
        self.node_ids = {n.id for n in snapshot.nodes()}
        with Recorder.lock:
            Recorder.made.append(self)


def test_install_snapshot_quiesces_dry_runs(monkeypatch):
    monkeypatch.setattr(server_mod, "_DryRunPlanner", Recorder)
    Recorder.made = []
    images = [image("a", 40), image("b", 24)]
    agent = Agent(AgentConfig(client_enabled=False,
                              server_config=quiet_config()), device="cpu")
    agent.start()
    srv = agent.server
    addr = agent.http.addr
    errors = []
    stop = threading.Event()
    srv.install_snapshot(*images[0])
    code, job_wire, _ = http(addr, "POST", "/v1/jobs/parse",
                             {"JobHCL": PROBE_HCL})
    assert code == 200, job_wire

    def direct():
        while not stop.is_set():
            job = tmock.job()
            job.id = "probe"
            try:
                srv.plan_job(job)
            except Exception as exc:  # noqa: BLE001
                errors.append(f"plan_job: {exc!r}")

    def over_http():
        while not stop.is_set():
            code, body, _ = http(addr, "PUT", "/v1/job/probe/plan",
                                 {"Job": job_wire})
            if code != 200:
                errors.append(f"HTTP {code}: {body}")

    threads = [threading.Thread(target=direct) for _ in range(3)]
    threads += [threading.Thread(target=over_http) for _ in range(2)]
    for th in threads:
        th.start()
    try:
        for i in range(12):
            srv.install_snapshot(*images[(i + 1) % 2])
            time.sleep(0.05)
    finally:
        stop.set()
        for th in threads:
            th.join(timeout=60)
        agent.shutdown()
    assert not errors, errors[:5]
    planned = 0
    for rec in Recorder.made:
        for plan in rec.plans:
            for nid in plan.node_allocation:
                planned += 1
                assert nid in rec.node_ids, (
                    f"a dry run planned onto {nid}, a node its snapshot "
                    "never held")
    assert planned > 20
