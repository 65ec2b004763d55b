"""Shared inputs for the port-vs-reference parity tests (test_torch_*.py).

Builds seeded clusters and request mixes with the JAX package, and hands
them to the port as plain numpy through ``nomad_tpu_torch.state.carry``.
Sizes stay small (≤ 256 nodes, ≤ 8 lanes, ≤ 4 placements) so the suite
runs in seconds on the CPU.
"""

import json
import re
import socket
import time
import urllib.error
import urllib.request
from contextlib import contextmanager

import numpy as np
import torch

from nomad_tpu.ops import RequestEncoder
from nomad_tpu.ops.encode import MAX_SPREADS, MAX_SPREAD_VALUES
from nomad_tpu.state import NodeMatrix
from nomad_tpu.structs import (
    Affinity,
    Allocation,
    Constraint,
    DriverInfo,
    Job,
    NetworkResource,
    Node,
    NodeResources,
    Resources,
    Spread,
    SpreadTarget,
    Task,
    TaskGroup,
)
from nomad_tpu_torch.ops import kernels as tk
from nomad_tpu_torch.state import carry

SCAN = 4
# Parity contract (the one tests/test_fake_device.py holds the numpy twin
# to): rows, preemption flags, counters and VERIFIED exact; scores and
# binpack within these.
RTOL, ATOL = 1e-4, 1e-5


def make_node(rng, i, dc=None):
    attrs = {
        "rack": f"r{i % 8}",
        "kernel.name": "linux" if i % 5 else "darwin",
        "os.version": f"{1 + i % 3}.{i % 4}.0",
    }
    if i % 7:  # some nodes lack the attribute (missing-attr rules)
        attrs["cpu.numcores"] = str(int(rng.integers(2, 64)))
    if i % 11 == 0:  # unparseable numeric → NaN column
        attrs["cpu.numcores"] = "many"
    return Node(
        datacenter=dc or ("dc1" if i % 3 else "dc2"),
        node_class=f"class-{i % 4}",
        attributes=attrs,
        resources=NodeResources(
            cpu=int(rng.integers(2000, 8000)),
            memory_mb=int(rng.integers(2048, 16384)),
            disk_mb=100 * 1024,
        ),
        drivers={"mock": DriverInfo()},
    )


def make_job(cpu=500, mem=256, count=1, constraints=None, affinities=None,
             spreads=None, networks=None, **kw):
    tg = TaskGroup(
        name="web",
        count=count,
        tasks=[Task(resources=Resources(cpu=cpu, memory_mb=mem,
                                        networks=networks or []))],
        constraints=constraints or [],
        affinities=affinities or [],
        spreads=spreads or [],
    )
    return Job(task_groups=[tg], **kw)


def jax_edge_pkg():
    """The JAX package's types for ``torch_edge_cases.build``."""
    from nomad_tpu import structs
    from nomad_tpu.ops import encode
    from nomad_tpu.state import matrix

    import torch_edge_cases

    return torch_edge_cases.package(structs, encode, matrix)


def build_cluster(seed=7, n_nodes=200, capacity=256, n_allocs=80):
    """A seeded reference matrix: heterogeneous nodes, existing allocs at
    several priorities (prio_used), and a few occupied static ports."""
    rng = np.random.default_rng(seed)
    m = NodeMatrix(capacity=capacity)
    nodes = [make_node(rng, i) for i in range(n_nodes)]
    for node in nodes:
        m.upsert_node(node)
    for i in rng.choice(n_nodes, size=n_allocs, replace=False):
        nets = []
        if i % 4 == 0:
            nets = [NetworkResource(reserved_ports=[8080])]
        m.add_alloc(Allocation(
            node_id=nodes[i].id,
            job=Job(priority=int(rng.integers(10, 90))),
            resources=Resources(
                cpu=int(rng.integers(100, 2500)),
                memory_mb=int(rng.integers(64, 4096)),
                networks=nets,
            ),
        ))
    return m, nodes


def lane_jobs():
    """(job, algorithm, preemption) covering every scoring stage."""
    rank = [SpreadTarget(value="r1", percent=50),
            SpreadTarget(value="r2", percent=25)]
    return [
        (make_job(cpu=400, mem=300), "binpack", False),
        (make_job(cpu=700, mem=512, count=SCAN), "spread", False),
        (make_job(cpu=300, mem=256, constraints=[
            Constraint(l_target="${attr.kernel.name}", operand="=",
                       r_target="linux"),
            Constraint(l_target="${attr.cpu.numcores}", operand=">=",
                       r_target="16"),
            Constraint(l_target="${attr.os.version}", operand="version",
                       r_target=">= 2.1"),
        ]), "binpack", False),
        (make_job(cpu=200, mem=128, constraints=[
            Constraint(l_target="${attr.cpu.numcores}", operand="!=",
                       r_target="8"),
        ], affinities=[
            Affinity(l_target="${attr.rack}", operand="=", r_target="r3",
                     weight=80),
            Affinity(l_target="${attr.kernel.name}", operand="=",
                     r_target="darwin", weight=-40),
        ]), "binpack", False),
        (make_job(cpu=250, mem=200, count=SCAN, spreads=[
            Spread(attribute="${attr.rack}", weight=70),
            Spread(attribute="${node.datacenter}", weight=30, targets=rank),
        ]), "binpack", False),
        (make_job(cpu=3500, mem=6000, priority=90), "binpack", True),
        (make_job(cpu=300, mem=256, count=SCAN, networks=[
            NetworkResource(reserved_ports=[8080], dynamic_ports=["http"]),
        ], constraints=[
            Constraint(operand="distinct_hosts"),
        ]), "binpack", False),
        (make_job(cpu=100000, mem=100), "binpack", False),  # never fits
    ]


def compile_lanes(m, jobs):
    enc = RequestEncoder(m)
    return [enc.compile(j, j.task_groups[0], algorithm=alg,
                        preemption_enabled=pre) for j, alg, pre in jobs]


def stack(reqs):
    return type(reqs[0])(*[np.stack(f) for f in zip(*reqs)])


def lane_operands(b, n, n_classes, deltas=None, tg_counts=None,
                  penalties=None, max_deltas=4):
    drows = np.full((b, max_deltas), -1, np.int32)
    dvals = np.zeros((b, max_deltas, 3), np.float32)
    for lane, items in (deltas or {}).items():
        for j, (row, vals) in enumerate(items):
            drows[lane, j] = row
            dvals[lane, j] = vals
    tg = np.zeros((b, n), np.int32)
    for lane, counts in (tg_counts or {}).items():
        for row, c in counts.items():
            tg[lane, row] = c
    pen = np.zeros((b, n), bool)
    for lane, rows in (penalties or {}).items():
        pen[lane, list(rows)] = True
    sc = np.zeros((b, MAX_SPREADS, MAX_SPREAD_VALUES), np.float32)
    ce = np.ones((b, max(2, n_classes)), bool)
    hm = np.ones((b, n), bool)
    return drows, dvals, tg, sc, pen, ce, hm


def port_matrix(m):
    """The reference matrix carried into the port, on the CPU."""
    return carry.matrix_from_host(
        m.snapshot_host(), m.attrs.slot_of, m.class_ids, m.row_of, "cpu",
        class_repr=m.class_repr, dev_slots=m.devices.slot_of,
    )


def port_requests(reqs_np):
    ri, rf = tk.pack_requests(reqs_np)
    return torch.from_numpy(ri), torch.from_numpy(rf)


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def assert_packed_equal(got, want, cols=None):
    """Exact rows/flags/counters/VERIFIED; scores and binpack in tolerance."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    exact = [0, 3, 4, 5, 6] + ([7] if want.shape[-1] == 8 else [])
    np.testing.assert_array_equal(got[..., exact], want[..., exact])
    np.testing.assert_allclose(got[..., 1:3], want[..., 1:3], rtol=RTOL,
                               atol=ATOL)


# ---------------------------------------------------------------------------
# HTTP agents of both packages (test_torch_api.py, test_torch_cli.py,
# test_torch_wire.py)
# ---------------------------------------------------------------------------

_UUID = re.compile(
    r"[0-9a-f]{8}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{12}")
_ADDR = re.compile(r"http://127\.0\.0\.1:\d+")
# Short ids: generated node names ("node-<8 hex>") and id prefixes.
_SHORT = re.compile(r"\b[0-9a-f]{8}\b")
_SECRET_KEYS = ("secret_id", "accessor_id", "SecretID", "AccessorID")
# The one agent node of each package, with the same id in both.
AGENT_NODE_ID = "parity-agent-0"


# Wall-clock stamps and measured durations.  Durations of the job spec
# (min_healthy_time, kill_timeout, ...) are compared exactly.
_CLOCK_KEYS = frozenset((
    "create_time", "modify_time", "submit_time", "reschedule_time",
    "allocation_time", "timestamp", "time", "uptime_s", "at"))


def _volatile(key) -> bool:
    """Keys whose values differ between two runs of the same script: raft
    indexes, wall-clock times, ACL secrets."""
    if not isinstance(key, str):
        return False
    low = key.lower()
    return (low.endswith("index") or low.endswith("_at")
            or low in _CLOCK_KEYS or key in _SECRET_KEYS)


def mask(obj, key=None):
    """``obj`` with ids, timestamps, indexes and addresses masked."""
    if isinstance(obj, dict):
        return {k: mask(v, k) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [mask(v, key) for v in obj]
    if _volatile(key) and isinstance(obj, (int, float, str)) and not (
            isinstance(obj, bool)):
        return "<masked>"
    if isinstance(obj, str):
        return _SHORT.sub("<id8>", _ADDR.sub("<addr>", _UUID.sub("<id>", obj)))
    return obj


def canon(obj):
    """``mask(obj)`` with a top-level list in a stable order (the stores
    list objects in insertion order, which concurrent writers may vary)."""
    out = mask(obj)
    if isinstance(out, list):
        out = sorted(out, key=lambda v: json.dumps(v, sort_keys=True))
    return out


def http(addr, method, path, body=None, token="", raw=False, timeout=30):
    """One request; returns (status, decoded JSON or raw bytes, headers).
    HTTP errors are returned, not raised."""
    data = json.dumps(body).encode() if body is not None else None
    headers = {"Content-Type": "application/json"}
    if token:
        headers["X-Nomad-Token"] = token
    req = urllib.request.Request(addr + path, data=data, method=method,
                                 headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            code, payload, hdrs = resp.status, resp.read(), dict(resp.headers)
    except urllib.error.HTTPError as exc:
        code, payload, hdrs = exc.code, exc.read(), dict(exc.headers)
    if raw:
        return code, payload, hdrs
    return code, (json.loads(payload) if payload else None), hdrs


def free_ports(n):
    """``n`` loopback ports free at the time of the call (for agents whose
    peers must know their addresses before they start)."""
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def agent_config(pkg_name, data_dir, client=True, server=True, **server_kw):
    """An agent config of one package (``"jax"`` or ``"port"``): one
    scheduling worker, long heartbeat TTLs, the SLO loop and the overload
    gate off unless asked (their events and verdicts follow wall time)."""
    if pkg_name == "jax":
        from nomad_tpu.api import AgentConfig
        from nomad_tpu.client import ClientConfig
        from nomad_tpu.server import ServerConfig
    else:
        from nomad_tpu_torch.api import AgentConfig
        from nomad_tpu_torch.client import ClientConfig
        from nomad_tpu_torch.server import ServerConfig
    kw = dict(num_workers=1, node_capacity=16, heartbeat_min_ttl=3600.0,
              heartbeat_max_ttl=7200.0, slo_enabled=False,
              overload_enabled=False)
    kw.update(server_kw)
    return AgentConfig(
        server_enabled=server, client_enabled=client,
        server_config=ServerConfig(**kw),
        client_config=ClientConfig(data_dir=str(data_dir)),
    )


def start_agent(pkg_name, cfg):
    """Build and start an agent of one package; the port's on the CPU.  An
    in-process client gets the fixed node id ``AGENT_NODE_ID``."""
    if pkg_name == "jax":
        from nomad_tpu.api import Agent

        agent = Agent(cfg)
    else:
        from nomad_tpu_torch.api import Agent

        agent = Agent(cfg, device="cpu")
    if agent.client is not None:
        agent.client.node.id = AGENT_NODE_ID
        agent.client.node.name = AGENT_NODE_ID
    agent.start()
    return agent


@contextmanager
def agent_pair(tmp_path, client=True, **server_kw):
    """A JAX agent and a port agent on the same config, each with an
    in-process mock-driver client unless ``client`` is False; yields
    ``{"jax": agent, "port": agent}`` and shuts both down."""
    agents = {}
    try:
        for name in ("jax", "port"):
            agents[name] = start_agent(name, agent_config(
                name, tmp_path / f"{name}-client", client=client,
                **server_kw))
        yield agents
    finally:
        for agent in agents.values():
            agent.shutdown()


def wait_until(pred, what, timeout=45.0, every=0.02):
    deadline = time.time() + timeout
    while not pred():
        if time.time() > deadline:
            raise AssertionError(
                f"timed out after {timeout} s waiting for {what}")
        time.sleep(every)


def settle_agent(agent, timeout=45.0):
    """The agent's server is quiet: no eval queued, pending, delayed or in
    flight, every stored eval terminal or blocked, three polls in a row."""
    srv = agent.server
    broker = srv.eval_broker
    quiet = 0
    deadline = time.time() + timeout
    while quiet < 3:
        if time.time() > deadline:
            raise AssertionError(f"server did not settle in {timeout} s")
        busy = (broker.ready_count() + broker.unacked_count()
                + broker.pending_count() + broker.delayed_count())
        open_evals = [e for e in list(srv.store.evals.values())
                      if not e.terminal_status() and e.status != "blocked"]
        quiet = quiet + 1 if not busy and not open_evals else 0
        time.sleep(0.03)


_CHILD = re.compile(r"/(dispatch|periodic)-\d+(-[0-9a-f]{8})?")


def assert_same(jax, port, path="body"):
    """The JAX agent's and the port's masked responses are equal: every
    value exactly, except the floats under ``scores`` (an alloc's
    placement scores), which hold to the kernels' contract RTOL/ATOL."""
    jax, port = mask(jax), mask(port)
    _same(jax, port, path, scores=False)


def _same(a, b, path, scores):
    if isinstance(a, str) and isinstance(b, str):
        a, b = _CHILD.sub("/<child>", a), _CHILD.sub("/<child>", b)
    if isinstance(a, dict) and isinstance(b, dict):
        assert sorted(a) == sorted(b), (
            f"{path}: keys differ: jax-only {sorted(set(a) - set(b))}, "
            f"port-only {sorted(set(b) - set(a))}")
        for k in a:
            _same(a[k], b[k], f"{path}.{k}", scores or k == "scores")
        return
    if isinstance(a, list) and isinstance(b, list):
        assert len(a) == len(b), f"{path}: {len(a)} items vs {len(b)}"
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]", scores)
        return
    if (scores and isinstance(a, float) and isinstance(b, float)
            and not isinstance(a, bool)):
        assert abs(a - b) <= ATOL + RTOL * abs(a), f"{path}: {a} vs {b}"
        return
    assert a == b, f"{path}: jax {a!r} vs port {b!r}"


# The chaos scenarios' report keys: the reference's
# (``nomad_tpu/chaos/scenarios.py``) and the ones the port adds, each a
# deliberate difference listed in ROADMAP's "Drops".
CHAOS_REPORT_KEYS = {
    "leader_kill_mid_apply": {"pre_kill_evals", "post_kill_eval"},
    "wal_truncation_sweep": {"stride", "cuts"},
    "partition_then_heal": {"drops"},
    "wedged_driver_during_drain": set(),
    "flash_crowd_flapping_partition": {
        "pre_rate", "state_pre_crowd", "admitted", "rejected",
        "wave2_admitted", "wave2_rejected", "engaged", "time_to_engage_s",
        "fast_window_s", "state_under_load", "crowd_drained",
        "overload_rate", "goodput_ratio", "total_shed", "recovered",
        "flips", "flips_suppressed", "flip_budget"},
    "breach_while_leader_killed": {
        "admitted", "rejected", "engaged_pre_kill", "state_pre_kill",
        "shed_pre_kill", "old_leader_released", "post_kill_eval",
        "new_leader_state_initial", "recovered", "new_leader_flips",
        "flip_budget"},
    "wedged_dispatch_recovers": {
        "pre_rate", "tripped", "wedged_dispatches", "degraded_dispatches",
        "trips", "crowd_drained", "post_rate", "recovered",
        "recovered_rate", "throughput_ratio"},
    "device_slow_flapping": {
        "placed", "slow_recorded", "trips", "flips", "flips_suppressed",
        "flip_budget", "final_state"},
    "shard_loss_evacuation": {
        "pre_shards", "pre_counts", "post_shards", "post_counts",
        "evacuations", "placed_row", "parity_mismatches",
        "restored_shards"},
}
CHAOS_PORT_KEYS = {
    "flash_crowd_flapping_partition": {"pressure_at_end"},
    "breach_while_leader_killed": {"pressure_at_end"},
    "wedged_dispatch_recovers": {
        "crowd_placed", "placed_after_close", "crowd_to_trip_s",
        "trip_to_close_s", "crowd_to_placed_s"},
    "device_slow_flapping": {"refused"},
    "shard_loss_evacuation": {
        "pre_placed_row", "evacuation_ms", "reupload_bytes",
        "resident_mismatches"},
}


def assert_chaos_report(report):
    """No violation, and the reference's report keys plus the port's
    listed additions, no other."""
    name = report["name"]
    assert report["violations"] == [], report
    want = ({"name", "seed", "violations"} | CHAOS_REPORT_KEYS[name]
            | CHAOS_PORT_KEYS.get(name, set()))
    if name != "breach_while_leader_killed":  # installs no injector
        want.add("faults")
    assert set(report) == want, set(report) ^ want
