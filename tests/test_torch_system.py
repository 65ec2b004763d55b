"""The port's system path against the JAX package's, on the CPU.

Two parts:

* ``system_feasible``: the port's plain version (what its wrapper runs on
  a CPU tensor) against ``nomad_tpu.ops.kernels.system_feasible`` on a
  seeded matrix carried across with ``state/carry.py``, over the request
  shapes the smoke's kernel phase holds the card kernel to: a static
  port some nodes already hold, a datacenter list, numeric, version,
  ``is_set`` and ``is_not_set`` constraints over a column with NaNs, a
  device ask, an escaped class (with class ids past the end of
  ``class_elig``) and a host mask, a dense base usage with deltas of both
  signs, and an ask that exhausts some nodes.  Both rows must be equal.
* A server script run by the JAX ``Server`` and the port's
  ``Server(device="cpu")``, one worker each, long heartbeat TTLs: register
  nodes, submit two system jobs and one service job, register four more
  nodes, drain two nodes (the test plays the client), mark two nodes down,
  deregister one system job.  Both must end with the same allocations and
  statuses, the same assigned ports, and the same eval statuses and
  failed-placement metrics.  The static port sits on the service job: a
  system job with a static port loses its allocs on re-evaluation in the
  JAX package (ROADMAP queue 3, R3), which the port fixes and
  tests/test_torch_nodes.py checks.
"""

import collections
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nomad_tpu import mock as jmock
from nomad_tpu.ops import RequestEncoder
from nomad_tpu.ops import kernels as jk
from nomad_tpu.server.server import Server as JServer
from nomad_tpu.server.server import ServerConfig as JServerConfig
from nomad_tpu.structs import (
    Allocation,
    Constraint,
    Job,
    NetworkResource,
    RequestedDevice,
    Resources,
)
from nomad_tpu.structs import types as jtypes
from nomad_tpu_torch import mock as tmock
from nomad_tpu_torch.ops import kernels as tk
from nomad_tpu_torch.server.server import Server, ServerConfig
from nomad_tpu_torch.structs import types as ttypes

from torch_parity import build_cluster, make_job, port_matrix, t

# One intra-op thread: these tests share the host's cores with the
# other test workers, whose timing tests a thread pool would starve.
torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# system_feasible
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cluster():
    """The parity cluster, with GPUs on some nodes (some in use) and port
    9100 held on every ninth node."""
    m, nodes = build_cluster(seed=23, n_nodes=200, capacity=256, n_allocs=60)
    for i in range(0, len(nodes), 5):
        node = nodes[i]
        node.resources.devices = {"gpu": [f"{node.id}-g{j}" for j in range(i % 4)]}
        m.upsert_node(node)
    for i in range(0, len(nodes), 10):
        m.add_alloc(Allocation(
            node_id=nodes[i].id, job=Job(priority=50),
            resources=Resources(cpu=10, memory_mb=10,
                                devices=[RequestedDevice(name="gpu", count=1)]),
        ))
    for i in range(4, len(nodes), 9):
        m.add_alloc(Allocation(
            node_id=nodes[i].id, job=Job(priority=50),
            resources=Resources(cpu=10, memory_mb=10, networks=[
                NetworkResource(reserved_ports=[9100])]),
        ))
    return m, nodes


def system_cases():
    """(name, job) — one per request shape of the smoke's kernel phase."""
    c = Constraint
    return [
        ("static-port", make_job(cpu=100, mem=64, networks=[
            NetworkResource(reserved_ports=[9100])])),
        ("datacenters", make_job(cpu=100, mem=64, datacenters=["dc2"])),
        ("numeric-version-set", make_job(cpu=100, mem=64, constraints=[
            c(l_target="${attr.cpu.numcores}", operand=">=", r_target="16"),
            c(l_target="${attr.os.version}", operand="version",
              r_target="< 3.0"),
            c(l_target="${attr.rack}", operand="is_set"),
        ])),
        ("not-set-and-ne", make_job(cpu=100, mem=64, constraints=[
            c(l_target="${attr.cpu.numcores}", operand="is_not_set"),
            c(l_target="${attr.kernel.name}", operand="!=",
              r_target="darwin"),
        ])),
        ("numeric-lt-nan", make_job(cpu=100, mem=64, constraints=[
            c(l_target="${attr.cpu.numcores}", operand="<", r_target="40"),
        ])),
        ("device", make_job(cpu=100, mem=64)),
        ("escaped-class-host-mask", make_job(cpu=100, mem=64)),
        ("signed-deltas", make_job(cpu=900, mem=1024)),
        ("exhausting", make_job(cpu=5000, mem=8000)),
    ]


def case_inputs(m, name, job, rng):
    """(compiled request, used0, class_elig, host_mask) for one case."""
    tg = job.task_groups[0]
    if name == "device":
        tg.tasks[0].resources.devices = [RequestedDevice(name="gpu", count=2)]
    req = RequestEncoder(m).compile(job, tg).request
    host = m.snapshot_host()
    n = m.capacity
    used0 = np.asarray(host["used"], np.float32).copy()
    ce = np.ones((4,), bool)
    hm = np.ones((n,), bool)
    if name == "escaped-class-host-mask":
        ce = np.array([False, True])  # ids past the end read the last entry
        hm[::7] = False
    if name == "signed-deltas":
        rows = rng.choice(200, 60, replace=False)
        # This job's own allocs subtracted, other plan deltas added.
        used0[rows[:30]] -= rng.integers(100, 900, (30, 3)).astype(np.float32)
        used0[rows[30:]] += rng.integers(100, 2000, (30, 3)).astype(np.float32)
    return req, used0, ce, hm


@pytest.mark.parametrize("case", [c[0] for c in system_cases()])
def test_system_feasible_matches_reference(cluster, case):
    m, _ = cluster
    job = dict(system_cases())[case]
    rng = np.random.default_rng(31)
    req, used0, ce, hm = case_inputs(m, case, job, rng)
    want = np.asarray(jk.system_feasible(
        m.sync(), jnp.asarray(used0), req, jnp.asarray(ce), jnp.asarray(hm)))

    tk.reset_counts()
    pm = port_matrix(m)
    req_i, req_f = tk.pack_request(req, "cpu")
    got = tk.system_feasible(pm.sync(), t(used0), req_i, req_f, t(ce), t(hm))
    assert got.dtype == torch.bool and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert tk.system_feasible_plain.calls == 1
    assert tk.system_feasible.launches == 0

    mask, fits = want
    live = mask[:200]
    assert live.any() and not live.all(), "the case separates no nodes"
    if case == "exhausting":
        assert (mask & ~fits).any() and (mask & fits).any()
    if case == "static-port":
        assert not mask[4] and mask[1]  # node 4 holds port 9100


# ---------------------------------------------------------------------------
# Server script
# ---------------------------------------------------------------------------

N_FIRST, N_LATER = 20, 4
SETTLE_TIMEOUT = 60.0


def script_nodes(mock, seed=13):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(N_FIRST + N_LATER):
        node = mock.node()
        node.id = node.name = f"node-{i:03d}"
        node.datacenter = "dc2" if i % 3 == 0 else "dc1"
        node.node_class = f"class-{i % 4}"
        # Every fifth node is too small for the log shipper.
        node.resources.cpu = 2000 if i % 5 == 0 else int(rng.integers(4000, 8000))
        node.resources.memory_mb = int(rng.integers(4096, 16384))
        out.append(node)
    return out


def script_jobs(mock, types):
    exporter = mock.system_job()
    exporter.id = exporter.name = "node-exporter"
    exporter.datacenters = ["dc1", "dc2"]
    shipper = mock.system_job()
    shipper.id = shipper.name = "log-shipper"
    shipper.datacenters = ["dc1"]
    shipper.task_groups[0].tasks[0].resources.cpu = 2500
    shipper.task_groups[0].constraints = [types.Constraint(
        l_target="${node.class}", operand="!=", r_target="class-3")]
    web = mock.job()
    web.id = web.name = "web"
    web.datacenters = ["dc1", "dc2"]
    web.task_groups[0].count = 3
    web.task_groups[0].constraints = [types.Constraint(operand="distinct_hosts")]
    web.task_groups[0].tasks[0].resources.networks = [
        types.NetworkResource(reserved_ports=[8080])]
    return exporter, shipper, web


def settle(srv, timeout=SETTLE_TIMEOUT):
    """Wait until no eval is queued, pending or in flight and every eval
    in the store is terminal or blocked, three polls in a row."""
    broker = srv.eval_broker
    deadline = time.time() + timeout
    quiet = 0
    while quiet < 3:
        if time.time() > deadline:
            raise AssertionError(f"server did not settle in {timeout} s")
        busy = (broker.ready_count() + broker.unacked_count()
                + broker.pending_count() + broker.delayed_count())
        open_evals = [e for e in list(srv.store.evals.values())
                      if not e.terminal_status() and e.status != "blocked"]
        quiet = quiet + 1 if not busy and not open_evals else 0
        time.sleep(0.03)


def play_client(srv, types):
    """Report every pending alloc the scheduler wants running as running."""
    updates = []
    for a in list(srv.store.allocs.values()):
        if a.client_status == "pending" and a.desired_status == "run":
            upd = a.copy()
            upd.client_status = types.AllocClientStatus.RUNNING.value
            updates.append(upd)
    if updates:
        srv.update_allocs_from_client(updates)


def step(srv, types):
    settle(srv)
    play_client(srv, types)
    settle(srv)


def live_nodes_of(srv, job_id):
    return sorted({a.node_id for a in srv.store.allocs.values()
                   if a.job_id == job_id and not a.terminal_status()})


def run_script(srv, mock, types):
    nodes = script_nodes(mock)
    for node in nodes[:N_FIRST]:
        srv.register_node(node)
    step(srv, types)
    exporter, shipper, web = script_jobs(mock, types)
    for job in (exporter, shipper, web):
        srv.submit_job(job)
        step(srv, types)
    for node in nodes[N_FIRST:]:
        srv.register_node(node)
    step(srv, types)

    drained = live_nodes_of(srv, "web")[:2]
    for nid in drained:
        srv.update_node_drain(nid, types.DrainStrategy())
        deadline = time.time() + SETTLE_TIMEOUT
        while srv.store.node_by_id(nid).drain:
            if time.time() > deadline:
                raise AssertionError(f"drain of {nid} did not complete")
            play_client(srv, types)
            time.sleep(0.03)
        step(srv, types)

    down = [nid for nid in live_nodes_of(srv, "web") if nid not in drained][:2]
    for nid in down:
        srv.update_node_status(nid, types.NodeStatus.DOWN.value)
        step(srv, types)

    srv.deregister_job("default", "log-shipper")
    step(srv, types)
    # The reference cancels duplicate blocked evals from a reaper that
    # wakes every 0.5 s.
    time.sleep(1.2)
    settle(srv)
    return collect(srv, drained, down)


def collect(srv, drained, down):
    allocs = collections.defaultdict(list)
    ports = {}
    for a in srv.store.allocs.values():
        key = (a.job_id, a.name, a.node_id)
        allocs[key].append((a.desired_status, a.client_status))
        if not a.terminal_status():
            ports[key] = {task: dict(p) for task, p in a.assigned_ports.items()}
    evals = collections.Counter()
    for e in srv.store.evals.values():
        metrics = tuple(sorted(
            (tg, m.nodes_evaluated, m.nodes_filtered, m.nodes_exhausted,
             m.coalesced_failures)
            for tg, m in (e.failed_tg_allocs or {}).items()))
        evals[(e.job_id, e.triggered_by, e.status, metrics)] += 1
    nodes = {n.id: (n.status, n.drain, n.scheduling_eligibility)
             for n in srv.store.nodes.values()}
    return dict(allocs={k: sorted(v) for k, v in allocs.items()},
                ports=ports, evals=evals, nodes=nodes, drained=drained,
                down=down)


@pytest.fixture(scope="module")
def reference_script():
    srv = JServer(JServerConfig(
        num_workers=1, node_capacity=32, heartbeat_min_ttl=3600.0,
        heartbeat_max_ttl=7200.0, slo_enabled=False, overload_enabled=False,
    ))
    srv.start()
    try:
        return run_script(srv, jmock, jtypes)
    finally:
        srv.shutdown()


@pytest.fixture(scope="module")
def port_script():
    tk.reset_counts()
    srv = Server(ServerConfig(num_workers=1, node_capacity=32,
                              heartbeat_min_ttl=3600.0,
                              heartbeat_max_ttl=7200.0), device="cpu")
    srv.start()
    try:
        out = run_script(srv, tmock, ttypes)
    finally:
        srv.shutdown()
    out["counts"] = (tk.system_feasible.launches,
                     tk.system_feasible_plain.calls)
    return out


def test_script_exercises_the_lifecycle(port_script):
    out = port_script
    assert len(out["drained"]) == 2 and len(out["down"]) == 2
    for nid in out["drained"]:
        status, drain, elig = out["nodes"][nid]
        assert (status, drain, elig) == ("ready", False, "ineligible")
    for nid in out["down"]:
        assert out["nodes"][nid][0] == "down"
    statuses = {s for v in out["allocs"].values() for s in v}
    assert ("stop", "lost") in statuses  # down nodes' allocs
    assert ("run", "running") in statuses
    web_live = [k for k, v in out["allocs"].items()
                if k[0] == "web" and ("run", "running") in v]
    assert len(web_live) == 3
    assert not {k[2] for k in web_live} & set(out["drained"] + out["down"])
    # The log shipper found exhausted nodes and parked a blocked eval.
    assert any(k[0] == "log-shipper" and k[2] == "blocked" for k in out["evals"])
    assert any(k[0] == "log-shipper" and k[3] for k in out["evals"])
    # No log shipper alloc is left running after the deregistration.
    assert not [k for k, v in out["allocs"].items()
                if k[0] == "log-shipper" and ("run", "running") in v]


def test_same_allocations_and_statuses(reference_script, port_script):
    assert port_script["drained"] == reference_script["drained"]
    assert port_script["down"] == reference_script["down"]
    assert port_script["allocs"] == reference_script["allocs"]
    assert port_script["nodes"] == reference_script["nodes"]


def test_same_assigned_ports(reference_script, port_script):
    assert port_script["ports"] == reference_script["ports"]
    web = [p for k, p in port_script["ports"].items() if k[0] == "web"]
    assert len(web) == 3 and all(8080 in p["web"].values() for p in web)


def test_same_eval_statuses_and_metrics(reference_script, port_script):
    assert port_script["evals"] == reference_script["evals"]


def test_plain_version_ran_on_the_cpu(port_script):
    launches, calls = port_script["counts"]
    assert launches == 0
    assert calls > 0
