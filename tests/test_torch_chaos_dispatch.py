"""The port's device seams against the JAX package's, on the CPU:
``device.wedge``, ``device.slow``, ``coalescer.dispatch``, ``shard.loss``
and ``shard.partition`` on the coalescer.  Each case runs the port's
deliberate difference where it has one: an open breaker refuses
dispatches (nothing launched) where the reference places them on its
host twin.  With no injector installed a dispatch calls no seam effect
and starts no thread.
"""

import threading
import time
from types import SimpleNamespace

import numpy as np
import torch

from nomad_tpu_torch import chaos as tchaos
from nomad_tpu_torch import mock as tmock
from torch_chaos_parity import (  # noqa: F401 — seam_events is a fixture
    JAX,
    PKGS,
    PORT,
    chaos,
    mock,
    rows,
    seam_events,
    twin_nodes,
)

torch.set_num_threads(1)


def coalescer_pkg(pkg):
    if pkg == JAX:
        from nomad_tpu.ops.encode import RequestEncoder
        from nomad_tpu.scheduler import coalescer
        from nomad_tpu.state.matrix import NodeMatrix
    else:
        from nomad_tpu_torch.ops.encode import RequestEncoder
        from nomad_tpu_torch.scheduler import coalescer
        from nomad_tpu_torch.state.matrix import NodeMatrix
    return SimpleNamespace(enc=RequestEncoder, coalescer=coalescer,
                           NodeMatrix=NodeMatrix)


def matrix(pkg, nodes, shards=1):
    cp = coalescer_pkg(pkg)
    m = (cp.NodeMatrix(capacity=16) if pkg == JAX
         else cp.NodeMatrix(capacity=16, device="cpu"))
    if shards > 1:
        m.set_shard_count(shards)
    for n in nodes:
        m.upsert_node(n)
    return m


def place_inputs(pkg, m, job):
    cp = coalescer_pkg(pkg)
    compiled = cp.enc(m).compile(job, job.task_groups[0])
    n = m.capacity
    d = cp.coalescer.MAX_DELTA_ROWS
    return dict(
        request=compiled.request,
        delta_rows=np.full((d,), -1, np.int32),
        delta_vals=np.zeros((d, 3), np.float32),
        tg_count=np.zeros((n,), np.int32),
        spread_counts=np.zeros_like(compiled.request.s_desired),
        penalty=np.zeros((n,), bool),
        class_elig=np.ones((2,), bool),
        host_mask=np.ones((n,), bool),
    )


def make_coalescer(pkg, m, **kw):
    cp = coalescer_pkg(pkg)
    if pkg == JAX:
        return cp.coalescer.DeviceCoalescer(m, linger_s=0.0, **kw)
    return cp.coalescer.DeviceCoalescer(m, linger_s=0.0, device="cpu", **kw)




def drive(coal, inputs, n_threads=8):
    """Every request from ``n_threads`` callers; exceptions are outcomes."""
    results = [None] * len(inputs)
    todo = list(range(len(inputs)))
    lock = threading.Lock()

    def worker():
        while True:
            with lock:
                if not todo:
                    return
                i = todo.pop(0)
            try:
                results[i] = coal.place(**inputs[i], timeout=30.0)
            except BaseException as e:  # noqa: BLE001 — the outcome
                results[i] = e

    threads = [threading.Thread(target=worker) for _ in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not any(t.is_alive() for t in threads), "caller hung"
    return results


def device_env(monkeypatch, **extra):
    monkeypatch.setenv("NOMAD_TPU_FAKE_DEVICE", "1")
    monkeypatch.setenv("NOMAD_TPU_DEVICE_DEADLINE_MS", "120")
    monkeypatch.setenv("NOMAD_TPU_DEVICE_COLD_SCALE", "1")
    for k, v in extra.items():
        monkeypatch.setenv(k, v)


def test_depth8_seeded_wedge_fails_one_lane(monkeypatch, seam_events):
    """One seeded wedged ticket in a depth-8 pipeline: its future raises
    ``DeviceWedgedError`` (never hangs) in both packages, the breaker
    trips once and the counters reconcile.  The reference places every
    other request (on its host twin once open); the port places or
    refuses it (an open breaker launches nothing)."""
    from nomad_tpu.obs.breaker import DeviceWedgedError as JWedged
    from nomad_tpu_torch.obs.breaker import DeviceBreakerOpenError
    from nomad_tpu_torch.obs.breaker import DeviceWedgedError as TWedged

    device_env(monkeypatch, NOMAD_TPU_DEVICE_PROBATION="600")
    nodes = twin_nodes(8)
    out = {}
    for pkg, wedged_t in ((JAX, JWedged), (PORT, TWedged)):
        c = chaos(pkg)
        m = matrix(pkg, nodes[pkg])
        inputs = [place_inputs(pkg, m, mock(pkg).job()) for _ in range(10)]
        coal = make_coalescer(pkg, m, max_lanes=1, pipeline_depth=8)
        coal.start()
        try:
            with c.injected(13, [c.FaultSpec("device.wedge", "wedge",
                                             at_step=2, duration=0.6)]) as inj:
                res = drive(coal, inputs)
        finally:
            coal.stop()
        wedged = [r for r in res if isinstance(r, wedged_t)]
        refused = [r for r in res if isinstance(r, DeviceBreakerOpenError)]
        placed = [r for r in res if not isinstance(r, BaseException)]
        assert all(o.rows[0] >= 0 for o in placed), pkg
        assert len(wedged) + len(refused) + len(placed) == 10, (pkg, res)
        assert wedged[0].elapsed_s > wedged[0].deadline_s > 0, pkg
        brief = coal.breaker.brief()
        out[pkg] = (len(wedged), coal.wedged_dispatches, brief["trips"],
                    brief["breaker"], coal.inflight_depth(),
                    [(s, k) for s, k, _ in rows(inj.log)])
        if pkg == JAX:
            assert not refused and len(placed) == 9
        else:
            assert brief["degraded_dispatches"] == len(refused)
    assert out[PORT] == out[JAX]
    assert out[PORT][:5] == (1, 1, 1, "open", 0)
    assert "seam.device.wedge" in seam_events[PORT]


def test_seamed_slow_ticket_is_classified_slow_and_used(monkeypatch,
                                                        seam_events):
    """``device.slow`` holds one ticket's wait into the slow band: the
    verdict is slow, its placement is used, in both packages (on the
    port's CPU path too, where the result is on the host at once)."""
    device_env(monkeypatch, NOMAD_TPU_DEVICE_DEADLINE_MS="80")
    nodes = twin_nodes(8)
    out = {}
    for pkg in PKGS:
        c = chaos(pkg)
        m = matrix(pkg, nodes[pkg])
        coal = make_coalescer(pkg, m, max_lanes=1, pipeline_depth=1)
        coal.start()
        try:
            with c.injected(3, [c.FaultSpec("device.slow", "slow",
                                            at_step=2)]) as inj:
                t0 = time.monotonic()
                got = [coal.place(**place_inputs(pkg, m, mock(pkg).job()))
                       for _ in range(3)]
                took = time.monotonic() - t0
        finally:
            coal.stop()
        brief = coal.breaker.brief()
        out[pkg] = ([int(o.rows[0]) for o in got], brief["slow"],
                    brief["breaker"], rows(inj.log))
        assert took >= 0.08, (pkg, took)  # the held wait
    assert out[PORT] == out[JAX]
    assert out[PORT][1:3] == (1, "closed")
    assert "seam.device.slow" in seam_events[PORT]


def test_coalescer_dispatch_seam_fires_per_batch(monkeypatch, seam_events):
    device_env(monkeypatch)
    nodes = twin_nodes(4)
    out = {}
    for pkg in PKGS:
        c = chaos(pkg)
        m = matrix(pkg, nodes[pkg])
        coal = make_coalescer(pkg, m, max_lanes=1, pipeline_depth=1)
        coal.start()
        try:
            with c.injected(0, [c.FaultSpec("coalescer.dispatch", "delay",
                                            at_step=2, duration=0.05)]) as inj:
                for _ in range(3):
                    coal.place(**place_inputs(pkg, m, mock(pkg).job()))
                hits = inj.hits("coalescer.dispatch")
        finally:
            coal.stop()
        out[pkg] = (hits, rows(inj.log), coal.dispatches)
    assert out[PORT] == out[JAX] == (3, [("coalescer.dispatch", "delay", 2)],
                                     3)
    assert "seam.coalescer.dispatch" in seam_events[PORT]


def test_shard_loss_on_home_shards_evacuates_mid_dispatch(monkeypatch,
                                                         seam_events):
    """``shard.loss`` on a one-device coalescer over four home shards
    evacuates the most populated one mid-dispatch; the launch scores the
    re-homed layout: the same rows in both packages.  A dense layout
    (one shard) evacuates nothing."""
    device_env(monkeypatch)
    nodes = twin_nodes(12)
    out = {}
    for pkg in PKGS:
        c = chaos(pkg)
        got = []
        for shards in (4, 1):
            m = matrix(pkg, nodes[pkg], shards=shards)
            coal = make_coalescer(pkg, m, max_lanes=2, pipeline_depth=1)
            coal.start()
            try:
                with c.injected(5, [c.FaultSpec("shard.loss", "lost",
                                                count=1)]):
                    res = coal.place(**place_inputs(pkg, m,
                                                    mock(pkg).job()))
            finally:
                coal.stop()
            got.append((int(m.shard_count), m.shard_row_counts(),
                        coal.shard_evacuations,
                        {n.id: m.row_of[n.id] for n in nodes[pkg]},
                        res.rows[0] >= 0))
        out[pkg] = got
    assert out[PORT] == out[JAX]
    assert [g[:3] for g in out[PORT]] == [(3, [4, 4, 4], 1), (1, [12], 0)]
    assert "seam.shard.loss" in seam_events[PORT]


def test_dark_shard_placements_rejected_then_heal(monkeypatch, seam_events):
    """``shard.partition`` darkens a whole home shard mid-dispatch: the
    launch scored the copy synced before, the applier's eligibility-gated
    re-verify refuses a plan onto the dark shard, and after
    ``heal_shard_partitions()`` the same plan commits, with every
    invariant green: in both packages."""
    from nomad_tpu.server import Server as JServer
    from nomad_tpu.server import ServerConfig as JServerConfig
    from nomad_tpu.structs.types import Plan as JPlan
    from nomad_tpu_torch.server import Server as TServer
    from nomad_tpu_torch.server import ServerConfig as TServerConfig
    from nomad_tpu_torch.structs.types import Plan as TPlan

    monkeypatch.setenv("NOMAD_TPU_FAKE_DEVICE", "1")
    nodes = twin_nodes(12)
    out = {}
    for pkg in PKGS:
        c = chaos(pkg)
        kw = dict(num_workers=2, heartbeat_min_ttl=3600.0,
                  heartbeat_max_ttl=7200.0)
        if pkg == JAX:
            srv, Plan = JServer(JServerConfig(**kw)), JPlan
        else:
            srv, Plan = TServer(TServerConfig(**kw), device="cpu"), TPlan
        srv.start()
        try:
            m = srv.store.matrix
            m.set_shard_count(4)
            for n in nodes[pkg]:
                srv.register_node(n)
            coal = make_coalescer(pkg, m, max_lanes=2, pipeline_depth=1)
            coal.start()
            try:
                with c.injected(9, [c.FaultSpec("shard.partition", "dark",
                                                count=1)]):
                    res = coal.place(**place_inputs(pkg, m,
                                                    mock(pkg).job()))
            finally:
                coal.stop()
            dark = sorted(coal._dark_shards)
            dark_ids = set(coal._dark_shards[0])
            assert dark_ids == set(m.shard_nodes(0)), pkg
            dark_node = next(n for n in nodes[pkg] if n.id in dark_ids)
            job = mock(pkg).job()
            job.task_groups[0].count = 1

            def apply():
                plan = Plan(job=job, node_allocation={
                    dark_node.id: [mock(pkg).alloc(job, dark_node)]})
                return bool(srv.plan_applier.apply(plan).node_allocation)

            refused = not apply()
            healed = coal.heal_shard_partitions()
            out[pkg] = (res.rows[0] >= 0, dark, refused, healed, apply(),
                        chaos(pkg).check_store(srv))
        finally:
            srv.shutdown()
    assert out[PORT] == out[JAX] == (True, [0], True, [0], True, [])
    assert "seam.shard.partition" in seam_events[PORT]


def test_no_injector_calls_no_seam_effect_and_starts_no_thread(
        monkeypatch):
    """With no injector installed a dispatch runs no seam effect: no
    darkening, no evacuation, no held wait (the CPU path returns at once,
    never polling), and the seams start no thread."""
    from nomad_tpu_torch.scheduler import coalescer as tco

    assert tchaos.active() is None
    m = matrix(PORT, twin_nodes(8)[PORT], shards=4)
    coal = make_coalescer(PORT, m, max_lanes=1, pipeline_depth=1)
    effects = []
    for name in ("_darken_shard", "_lose_shard", "evacuate_shard"):
        monkeypatch.setattr(coal, name,
                            lambda *a, _n=name: effects.append(_n))
    polls = []
    real_poll = tco.poll_until
    monkeypatch.setattr(tco, "poll_until",
                        lambda *a: polls.append(1) or real_poll(*a))
    holds = []
    real_hold = coal._chaos_hold
    monkeypatch.setattr(coal, "_chaos_hold",
                        lambda *a: holds.append(real_hold(*a)) or holds[-1])
    coal.start()
    try:
        threads = threading.active_count()
        for _ in range(4):
            out = coal.place(**place_inputs(PORT, m, tmock.job()))
            assert out.rows[0] >= 0
        assert threading.active_count() == threads
    finally:
        coal.stop()
    assert effects == [] and polls == []
    assert holds == [None] * 4
    assert coal.breaker.brief()["slow"] == 0
