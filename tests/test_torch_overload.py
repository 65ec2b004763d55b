"""The port's admission gate, overload controller, SLOs and health on the
CPU, against the JAX package's.

Each building block runs in both packages on the same seeded inputs and a
synthetic clock, and every output is compared exactly:

* ``TokenBucket.take`` waits, and ``AdmissionGate`` admit/reject verdicts,
  ``retry_after`` hints and stats under gate-level changes;
* ``OverloadController.step(report, breached, now)``: the state after
  every step, the decision log, flip and suppression counts, and the
  actuations it drives on the gate and the broker;
* ``SLOEngine.tick`` transitions and reports, ``compute_health``;
* the observatory's ticks on an idle server (its SLO events and health);
* ``submit_job(internal=True)`` bypasses a closed gate and an external
  submit raises ``RateLimitError``, in both packages;
* ``collect_signals`` on a port server has ``pipeline_inflight``.
"""

import random
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from nomad_tpu import mock as jmock
from nomad_tpu.obs import controller as jcontroller
from nomad_tpu.obs import health as jhealth
from nomad_tpu.obs import slo as jslo
from nomad_tpu.server import admission as jadmission
from nomad_tpu.server.server import Server as JServer
from nomad_tpu.server.server import ServerConfig as JServerConfig
from nomad_tpu_torch import mock as tmock
from nomad_tpu_torch.obs import controller as tcontroller
from nomad_tpu_torch.obs import health as thealth
from nomad_tpu_torch.obs import slo as tslo
from nomad_tpu_torch.server import admission as tadmission
from nomad_tpu_torch.server.server import Server, ServerConfig

torch.set_num_threads(1)

JAX, PORT = "jax", "port"
PKGS = {
    JAX: SimpleNamespace(admission=jadmission, controller=jcontroller,
                         slo=jslo, health=jhealth, mock=jmock),
    PORT: SimpleNamespace(admission=tadmission, controller=tcontroller,
                          slo=tslo, health=thealth, mock=tmock),
}
SEEDS = pytest.mark.parametrize("seed", [0, 1, 2, 3])


def both(fn, *args):
    """``fn(pkg, *args)`` in each package; asserts the results equal and
    returns the port's."""
    jax_out = fn(PKGS[JAX], *args)
    port_out = fn(PKGS[PORT], *args)
    assert port_out == jax_out
    return port_out


# ---------------------------------------------------------------------------
# Token buckets and the gate
# ---------------------------------------------------------------------------


def bucket_trace(pkg, seed):
    rng = random.Random(seed)
    b = pkg.admission.TokenBucket(rate=rng.uniform(0.5, 20.0),
                                  burst=rng.uniform(1.0, 8.0))
    now, out = 100.0, []
    for _ in range(200):
        now += rng.choice([0.0, 0.0, rng.uniform(0.0, 0.5), rng.uniform(0, 3)])
        out.append(b.take(rng.choice([1.0, 1.0, 2.0]), now=now,
                          factor=rng.choice([1.0, 1.0, 0.5, 0.25])))
    return out


@SEEDS
def test_token_bucket_matches(seed):
    waits = both(bucket_trace, seed)
    assert 0.0 in waits and any(w > 0 for w in waits)


def gate_trace(pkg, seed):
    rng = random.Random(seed)
    gate = pkg.admission.AdmissionGate(rate=rng.uniform(1.0, 10.0),
                                       burst=rng.uniform(1.0, 5.0))
    now, out = 50.0, []
    for _ in range(300):
        now += rng.choice([0.0, 0.01, 0.1, rng.uniform(0.0, 2.0)])
        if rng.random() < 0.05:
            gate.set_gate_level(rng.choice([1.0, 0.5, 0.25, 1.5, -1.0]),
                                retry_after=rng.choice([0.5, 2.0]))
        try:
            gate.check(rng.choice(["default", "batch", "web"]), now=now)
            out.append(("admit", gate.factor))
        except pkg.admission.RateLimitError as e:
            out.append(("reject", e.retry_after, gate.factor))
    return out, gate.stats()


@SEEDS
def test_admission_gate_matches(seed):
    verdicts, stats = both(gate_trace, seed)
    assert stats["admitted"] and stats["rejected"]
    assert stats["namespaces"] == 3


def test_rate_zero_disables_the_gate():
    for pkg in PKGS.values():
        gate = pkg.admission.AdmissionGate(rate=0.0, burst=1.0)
        for _ in range(10):
            gate.check("default", now=1.0)
        assert gate.stats()["rejected"] == 0


# ---------------------------------------------------------------------------
# The overload controller on a synthetic clock
# ---------------------------------------------------------------------------


class _Metrics:
    def __init__(self):
        self.counts = {}

    def incr(self, name, n=1, **tags):
        key = (name, tuple(sorted(tags.items())))
        self.counts[key] = self.counts.get(key, 0) + n

    def gauge_fn(self, name, fn, **labels):
        pass


class _Broker:
    def __init__(self):
        self.calls = []

    def set_shedding(self, enabled, **kw):
        self.calls.append((enabled, tuple(sorted(kw.items()))))

    def shed_stats(self):
        return {"calls": len(self.calls)}


class _Blocked:
    def fairness_stats(self):
        return {"policy": "deficit-round-robin"}


def pressure_trace(seed, n=120):
    """(now, pressure, breached) steps: calm, a ramp, a spike, an
    oscillation, a recovery, with seeded noise and breaches."""
    rng = np.random.default_rng(seed)
    base = np.concatenate([
        np.zeros(15), np.linspace(0.0, 0.9, 20), np.full(20, 0.95),
        np.tile([0.9, 0.05], 15), np.linspace(0.6, 0.0, 20), np.zeros(15),
    ])[:n]
    noise = rng.uniform(-0.05, 0.05, base.shape)
    times = np.cumsum(rng.uniform(0.2, 1.5, base.shape)) + 1000.0
    breached = rng.random(base.shape) < 0.2
    return [(float(t), float(np.clip(p + e, 0.0, 1.0)),
             ["eval_throughput"] if b else [])
            for t, p, e, b in zip(times, base, noise, breached)]


CONTROLLER_CONFIGS = [
    dict(gate_enter=0.3, gate_exit=0.15, shed_enter=0.6, shed_exit=0.25,
         window_fast=2.0, window_slow=3.0, min_dwell=1.0, cooldown=0.1,
         max_flips=10, flip_window=60.0),
    dict(gate_enter=0.3, gate_exit=0.15, shed_enter=0.6, shed_exit=0.25,
         window_fast=0.5, window_slow=0.5, min_dwell=0.0, cooldown=0.0,
         max_flips=3, flip_window=60.0),
    dict(),  # the defaults
]


def controller_trace(pkg, seed, cfg_kw):
    srv = SimpleNamespace(
        admission_gate=pkg.admission.AdmissionGate(rate=100.0, burst=100.0),
        eval_broker=_Broker(), blocked_evals=_Blocked(), metrics=_Metrics())
    ctrl = pkg.controller.OverloadController(
        srv, config=pkg.controller.OverloadConfig(**cfg_kw))
    states = [ctrl.step({"pressure": p}, breached=b, now=t)
              for t, p, b in pressure_trace(seed)]
    report = ctrl.report(now=2000.0)
    ctrl.reset()
    return (states, list(ctrl.decisions), ctrl.flips_total,
            ctrl.flips_suppressed, srv.eval_broker.calls,
            srv.admission_gate.stats(), srv.metrics.counts,
            {k: v for k, v in report.items() if k != "evaluated_at"},
            ctrl.state)


@pytest.mark.parametrize("cfg", range(len(CONTROLLER_CONFIGS)))
@pytest.mark.parametrize("seed", [0, 1])
def test_overload_controller_matches(seed, cfg):
    states, decisions, flips, *_ , final = both(
        controller_trace, seed, CONTROLLER_CONFIGS[cfg])
    assert final == "steady"  # reset released the actuators
    if cfg < 2:
        assert {"gating", "shedding"} <= set(states)
        assert flips == len(decisions)


# ---------------------------------------------------------------------------
# SLOs and health
# ---------------------------------------------------------------------------


def slo_trace(pkg, seed):
    rng = np.random.default_rng(seed)
    slo = pkg.slo
    specs = slo.default_slos() + [
        slo.SLOSpec(name="lat", objective="m", op="<", target=5.0,
                    kind="gauge", windows=(1.0, 3.0), min_samples=3),
        slo.SLOSpec(name="lat30", objective="m", op="<=", target=5.0,
                    kind="gauge", windows=(1.0, 3.0), min_samples=3,
                    budget=0.3),
        slo.SLOSpec(name="thr", objective="c", op=">=", target=50.0,
                    kind="rate", windows=(10.0, 30.0), min_samples=2),
        slo.SLOSpec(name="hot", objective="m", op=">", target=2.0,
                    kind="gauge", windows=(2.0, 4.0), min_samples=4),
    ]
    eng = slo.SLOEngine(specs)
    level, now, out = 0.0, 100.0, []
    for i in range(150):
        now += float(rng.uniform(0.1, 0.6))
        phase = (i // 30) % 2
        level += float(rng.uniform(0, 60 if phase else 20))
        snap = {"m": float(rng.uniform(6, 9) if phase else rng.uniform(0, 4)),
                "c": level,
                "nomad.worker.evals_processed": level,
                "nomad.heartbeat.missed": float(i // 50)}
        out.append([(s.name, old, new)
                    for s, old, new in eng.tick(snap, now=now)])
    return out, eng.report(now=now), eng.breached()


@SEEDS
def test_slo_engine_matches(seed):
    transitions, report, _ = both(slo_trace, seed)
    assert any(transitions)
    assert {r["name"] for r in report} >= {"lat", "thr", "eval_throughput"}


def health_trace(pkg, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(50):
        signals = {
            "broker_backlog": float(rng.choice([0, rng.uniform(0, 2000)])),
            "blocked_evals": float(rng.uniform(0, 500)),
            "plan_queue_depth": float(rng.uniform(0, 200)),
            "plan_queue_wait_p99_ms": float(rng.uniform(0, 400)),
            "heartbeat_miss_rate": float(rng.uniform(0, 2)),
            "pipeline_inflight": float(rng.integers(0, 9)),
            "pipeline_depth": float(rng.choice([0, 8])),
        }
        breached = ["lat"] if rng.random() < 0.3 else []
        out.append(pkg.health.compute_health(signals, breached, now=5.0))
    return out


@SEEDS
def test_compute_health_matches(seed):
    reports = both(health_trace, seed)
    assert {r["status"] for r in reports} >= {"ok", "degraded"}


# ---------------------------------------------------------------------------
# Servers: the observatory, the gate on submit_job, the health signals
# ---------------------------------------------------------------------------


def make_server(pkg, **kw):
    kw.setdefault("num_workers", 1)
    kw.setdefault("node_capacity", 16)
    kw.setdefault("heartbeat_min_ttl", 3600.0)
    kw.setdefault("heartbeat_max_ttl", 7200.0)
    if pkg == JAX:
        return JServer(JServerConfig(**kw))
    return Server(ServerConfig(**kw), device="cpu")


def observatory_trace(pkg):
    """Twenty synthetic-clock ticks of an idle server's observatory (not
    started, so nothing else ticks it): the SLO and Health events it
    publishes, its last health report and the controller's state."""
    srv = make_server(pkg, slo_enabled=False)
    sub = srv.store.events.subscribe({"SLO": ["*"], "Health": ["*"]})
    reports = [srv.observatory.tick(now=500.0 + i) for i in range(20)]
    events = []
    while True:
        batch = sub.next(timeout=0.1)
        if not batch:
            break
        events += [(e.topic, e.type, e.key, e.index,
                    {k: v for k, v in e.payload.items() if k != "at"})
                   for e in batch]
    last = {k: v for k, v in reports[-1].items() if k != "device"}
    return (events, last, srv.observatory.slo_report()["ticks"],
            srv.overload_controller.state, srv.overload_controller.steps)


def test_observatory_ticks_match():
    jax_out = observatory_trace(JAX)
    port_out = observatory_trace(PORT)
    assert port_out == jax_out
    events, last, ticks, state, steps = port_out
    # An idle server misses its throughput floor (a breach, degraded
    # health) and loses no node (heartbeat liveness leaves pending).
    assert sorted((t, ty, k) for t, ty, k, *_ in events) == [
        ("Health", "HealthChanged", "degraded"),
        ("SLO", "SLOBreached", "eval_throughput"),
        ("SLO", "SLORecovered", "heartbeat_liveness")]
    assert last["status"] == "degraded" and ticks == 20
    assert state == "steady" and steps == 20


@pytest.mark.parametrize("pkg", [JAX, PORT])
def test_internal_submits_bypass_a_closed_gate(pkg):
    mock = PKGS[pkg].mock
    admission = PKGS[pkg].admission
    srv = make_server(pkg, admission_rate=1e-6, admission_burst=1.0,
                      slo_enabled=False, overload_enabled=False)
    srv.start()
    try:
        for _ in range(2):
            srv.register_node(mock.node())
        first = mock.job()
        first.id = "first"
        first.task_groups[0].count = 1
        assert srv.submit_job(first) is not None
        with pytest.raises(admission.RateLimitError) as exc:
            srv.submit_job(mock.job())
        assert exc.value.retry_after >= 0.1
        assert srv.submit_job(mock.job(), internal=True) is not None
        # A scale is internal; a dispatch pays the gate like a register.
        assert srv.scale_job("default", "first", "web", 2) is not None
        param = mock.batch_job()
        param.parameterized = {"payload": "optional"}
        srv.submit_job(param, internal=True)
        with pytest.raises(admission.RateLimitError):
            srv.dispatch_job("default", param.id)
        stats = srv.admission_gate.stats()
        assert (stats["admitted"], stats["rejected"]) == (1, 2)
    finally:
        srv.shutdown()


def test_port_health_signals_include_the_pipeline():
    """The signal the observatory reads from the coalescer: without
    ``inflight_depth`` it would vanish from the score silently."""
    srv = make_server(PORT, slo_enabled=False)
    jsrv = make_server(JAX, slo_enabled=False)
    signals = thealth.collect_signals(srv)
    assert signals["pipeline_inflight"] == 0
    assert signals["pipeline_depth"] == srv.coalescer.pipeline_depth
    assert set(signals) == set(jhealth.collect_signals(jsrv))
    snap = srv.metrics.snapshot()
    assert snap["nomad.coalescer.inflight_depth"] == 0
    assert "nomad.health.score" in snap and "nomad.overload.state" in snap


def test_leadership_cycle_resets_the_control_loop():
    srv = make_server(PORT, slo_interval=60.0)
    srv.start()
    try:
        assert srv.observatory._thread.is_alive()
        srv.overload_controller.step({"pressure": 0.99}, now=1.0)
        assert srv.overload_controller.state == "shedding"
        assert srv.admission_gate.factor < 1.0
        srv.revoke_leadership()
        assert not srv.observatory._thread.is_alive()
        assert srv.overload_controller.state == "steady"
        assert srv.admission_gate.factor == 1.0
        assert not srv.eval_broker.enabled
        srv.establish_leadership()
        assert srv.observatory._thread.is_alive()
        node = tmock.node()
        srv.register_node(node)
        job = tmock.job()
        job.task_groups[0].count = 1
        assert srv.wait_for_eval(srv.submit_job(job).id, 30).status == "complete"
    finally:
        srv.shutdown()
