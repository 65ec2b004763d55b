"""The port's tracing recorder and exporters on the CPU, against the JAX
package's.

* span nesting, parents, the ambient context and the cross-thread
  ``record_span`` stitch give the same records in both packages (span ids
  and times aside);
* per-trace sampling decides the same for the same trace ids; the ring
  bounds each thread and ``limit`` keeps the newest;
* ``chrome_trace`` builds the same Perfetto JSON, timestamps and ids
  aside; ``dump_flight_record`` writes it with its metadata;
* the coalescer hop: on a server burst ``coalescer.queue_wait`` and
  ``coalescer.device`` are children of the lane's ``sched.dispatch`` span,
  recorded on the dispatch and resolver threads, as in the reference;
* the fault that the recorder repairs: after the same mock burst both
  servers' registries hold the same ``nomad.phase.*`` timers and
  ``collect_signals`` the same keys (``plan_queue_wait_p99_ms`` among
  them) — the no-op ``trace`` module the port had fed none;
* the observatory's flight-record dump on an SLO breach;
* per-span cost under the budget of ``tests/test_trace_overhead.py``,
  timed as the minimum of repeats.
"""

import json
import threading
import time

import pytest

from nomad_tpu import mock as jmock
from nomad_tpu import trace as jtrace
from nomad_tpu.metrics import MetricsRegistry as JRegistry
from nomad_tpu.obs import health as jhealth
from nomad_tpu.server.server import Server as JServer
from nomad_tpu.server.server import ServerConfig as JServerConfig
from nomad_tpu_torch import mock as tmock
from nomad_tpu_torch import trace as ttrace
from nomad_tpu_torch.metrics import MetricsRegistry as TRegistry
from nomad_tpu_torch.obs import evaluator as tevaluator
from nomad_tpu_torch.obs import health as thealth
from nomad_tpu_torch.obs.slo import SLOSpec
from nomad_tpu_torch.server.server import Server, ServerConfig

PKGS = {"jax": (jtrace, JRegistry), "port": (ttrace, TRegistry)}

# The reference's span taxonomy on the service path (OBSERVABILITY.md).
PHASES = [
    "broker.queue_wait", "coalescer.device", "coalescer.launch",
    "coalescer.queue_wait", "eval.process", "plan.apply", "plan.queue_wait",
    "plan.submit", "sched.dispatch", "sched.encode", "sched.feasibility",
    "worker.invoke_scheduler", "worker.wait_for_index",
]


@pytest.fixture(autouse=True)
def _clean(monkeypatch, tmp_path):
    """Tracing is process-global in each package: every test starts from
    a cleared recorder and the default config, and dumps go to a
    temporary directory."""
    monkeypatch.setenv("NOMAD_TPU_TRACE_DIR", str(tmp_path / "traces"))
    for tr, _ in PKGS.values():
        tr.configure(enabled=True, sample=1.0, ring=4096)
        tr.clear()
    yield
    for tr, _ in PKGS.values():
        tr.configure(enabled=True, sample=1.0, ring=4096)
        tr.clear()


def normalized(records):
    """Records with span ids renumbered by first appearance, timestamps
    dropped and ambient trace ids (``name#id``) cut to their name."""
    ids = {0: 0}

    def rid(x):
        return ids.setdefault(x, len(ids))

    out = []
    for r in sorted(records, key=lambda r: (r["ts"], r["span"])):
        out.append({
            "name": r["name"], "ph": r["ph"],
            "trace": r["trace"].split("#")[0],
            "span": rid(r["span"]), "parent": rid(r["parent"]),
            "args": r["args"], "thread": r["thread"],
        })
    return out


def span_script(tr, reg):
    """Nested spans, an event, an ambient span and a cross-thread stitch
    on a named thread; returns what ``dump()`` holds."""
    with tr.span("eval.process", trace_id="ev-1", metrics=reg,
                 type="service") as root:
        assert tr.current() is root
        with tr.span("sched.encode", metrics=reg) as inner:
            assert tr.current() is inner
            tr.event("seam.test", k="v")
        carried = tr.current()
        assert carried is root
    assert tr.current() is None
    with tr.span("ambient.op"):
        pass

    def far_side():
        now = time.time()
        tr.record_span("coalescer.device", now, now + 0.002, ctx=carried,
                       metrics=reg, lanes=3)
        tr.record_span("late.stitch", now, now - 1.0, ctx=carried,
                       parent=7)

    t = threading.Thread(target=far_side, name="resolver-coalescer")
    t.start()
    t.join()
    tr.record_span("no.ctx", 1.0, 2.0, metrics=reg)
    return tr.dump()


def test_span_records_match():
    got = {}
    for pkg, (tr, registry) in PKGS.items():
        reg = registry()
        recs = span_script(tr, reg)
        got[pkg] = normalized(recs)
        timers = reg.snapshot()
        got[pkg + ".timers"] = sorted(
            k for k in timers if k.startswith("nomad.phase."))
        by = {r["name"]: r for r in recs}
        # Parents: inner → root, the stitch → the carried root, the
        # override wins; a negative duration is clamped to zero.
        assert by["sched.encode"]["parent"] == by["eval.process"]["span"]
        assert by["coalescer.device"]["parent"] == by["eval.process"]["span"]
        assert by["coalescer.device"]["thread"] == "resolver-coalescer"
        assert by["late.stitch"]["parent"] == 7
        assert by["late.stitch"]["dur"] == 0.0
        assert by["eval.process"]["parent"] == 0
        assert by["seam.test"]["parent"] == by["sched.encode"]["span"]
    assert got["port"] == got["jax"]
    assert got["port.timers"] == got["jax.timers"] == [
        "nomad.phase.coalescer.device", "nomad.phase.eval.process",
        "nomad.phase.no.ctx", "nomad.phase.sched.encode"]


def test_disabled_records_nothing_in_both():
    for tr, registry in PKGS.values():
        tr.configure(enabled=False)
        reg = registry()
        with tr.span("x", trace_id="t", metrics=reg) as ctx:
            assert ctx is None
        tr.record_span("y", 0.0, 1.0, metrics=reg)
        tr.event("z")
        assert tr.dump() == []
        assert not [k for k in reg.snapshot() if k.startswith("nomad.phase")]


def test_sampling_decisions_match():
    ids = [f"eval-{i:04d}" for i in range(400)]
    decisions = {}
    for pkg, (tr, _) in PKGS.items():
        decisions[pkg] = {}
        for sample in (0.0, 0.1, 0.37, 0.5, 1.0):
            tr.configure(sample=sample)
            decisions[pkg][sample] = [tr.start_trace(i).sampled for i in ids]
    assert decisions["port"] == decisions["jax"]
    d = decisions["port"]
    assert not any(d[0.0]) and all(d[1.0])
    assert 0 < sum(d[0.1]) < sum(d[0.5]) < len(ids)
    # An unsampled trace skips the ring but still feeds the timers, and a
    # sampled one is recorded whole.
    tr, registry = PKGS["port"]
    tr.configure(sample=0.37)
    reg = registry()
    for i in ids[:40]:
        with tr.span("eval.process", trace_id=i, metrics=reg):
            with tr.span("sched.encode", metrics=reg):
                pass
    recorded = {r["trace"] for r in tr.dump()}
    want = {i for i, s in zip(ids[:40], d[0.37][:40]) if s}
    assert recorded == want
    for t, recs in tr.traces_by_id().items():
        assert sorted(r["name"] for r in recs) == [
            "eval.process", "sched.encode"]
    assert reg.snapshot()["nomad.phase.eval.process"]["count"] == 40


def ring_script(tr, _reg):
    tr.configure(ring=16)
    for i in range(50):
        with tr.span(f"op.{i}"):
            pass
    return ([r["name"] for r in tr.dump()],
            [r["name"] for r in tr.dump(limit=5)],
            tr.dump(limit=0), tr.recorder().span_count())


def test_ring_bound_and_limit_match():
    got = {pkg: ring_script(*PKGS[pkg]) for pkg in PKGS}
    assert got["port"] == got["jax"]
    names, last5, none, count = got["port"]
    assert names == [f"op.{i}" for i in range(34, 50)]
    assert last5 == [f"op.{i}" for i in range(45, 50)]
    assert none == [] and count == 16


def normalized_chrome(doc):
    tids = {}
    ids = {0: 0}
    out = []
    for ev in doc["traceEvents"]:
        ev = dict(ev)
        ev["tid"] = tids.setdefault(ev["tid"], len(tids))
        ev.pop("ts", None)
        ev.pop("dur", None)
        if "args" in ev and "span" in ev["args"]:
            args = dict(ev["args"])
            args["span"] = ids.setdefault(args["span"], len(ids))
            args["parent"] = ids.setdefault(args["parent"], len(ids))
            args["trace"] = args["trace"].split("#")[0]
            ev["args"] = args
        out.append(ev)
    return {"events": out, "unit": doc["displayTimeUnit"],
            "metadata": doc["metadata"]}


def test_chrome_trace_matches():
    docs = {}
    for pkg, (tr, registry) in PKGS.items():
        recs = span_script(tr, registry())
        docs[pkg] = tr.chrome_trace(recs, metadata={"reason": "test"})
    assert normalized_chrome(docs["port"]) == normalized_chrome(docs["jax"])
    events = docs["port"]["traceEvents"]
    assert {e["ph"] for e in events} == {"M", "X", "i"}
    names = {e["args"]["name"] for e in events if e["ph"] == "M"}
    assert {"MainThread", "resolver-coalescer"} <= names
    # Loadable JSON: microsecond integer timestamps and durations.
    json.loads(json.dumps(docs["port"]))
    assert all(isinstance(e["ts"], int) for e in events if e["ph"] != "M")


def test_flight_record_dump(tmp_path):
    tr = ttrace
    span_script(tr, TRegistry())
    path = tr.dump_flight_record(path=str(tmp_path / "sub" / "f.json"),
                                 reason="manual", extra={"k": 1})
    doc = json.loads(open(path).read())
    assert doc["metadata"]["reason"] == "manual"
    assert doc["metadata"]["k"] == 1
    assert "chaos_seed" not in doc["metadata"]
    assert len([e for e in doc["traceEvents"] if e["ph"] == "X"]) == 6
    auto = tr.auto_dump("test-hook")
    assert auto is not None and auto.startswith(tr.trace_dir())
    tr.clear()
    assert tr.auto_dump("empty") is None


# ---------------------------------------------------------------------------
# Servers: the coalescer hop and the phase timers
# ---------------------------------------------------------------------------


def make_server(pkg, **kw):
    kw.setdefault("num_workers", 2)
    kw.setdefault("node_capacity", 16)
    kw.setdefault("heartbeat_min_ttl", 3600.0)
    kw.setdefault("heartbeat_max_ttl", 7200.0)
    kw.setdefault("slo_enabled", False)
    kw.setdefault("overload_enabled", False)
    if pkg == "jax":
        return JServer(JServerConfig(**kw)), jmock, jhealth
    return Server(ServerConfig(**kw), device="cpu"), tmock, thealth


def mock_burst(pkg):
    """8 mock nodes, 6 mock jobs, 2 workers; returns the registry's phase
    timer names, the health signals' keys and each eval's records."""
    srv, mock, health = make_server(pkg)
    tr = PKGS[pkg][0]
    tr.clear()
    srv.start()
    try:
        for _ in range(8):
            srv.register_node(mock.node())
        evals = [srv.submit_job(mock.job()) for _ in range(6)]
        for ev in evals:
            assert srv.wait_for_eval(ev.id, 120).status == "complete"
        timers = sorted(k[len("nomad.phase."):] for k in srv.metrics.snapshot()
                        if k.startswith("nomad.phase."))
        signals = sorted(health.collect_signals(srv))
        by = tr.traces_by_id()
        traces = {ev.id: by.get(ev.id, []) for ev in evals}
    finally:
        srv.shutdown()
    return timers, signals, traces


@pytest.fixture(scope="module")
def bursts():
    return {pkg: mock_burst(pkg) for pkg in ("jax", "port")}


def test_phase_timers_and_health_signals_match(bursts):
    """The fault the recorder repairs: the port's spans fed no phase
    timer, so its health signals lacked the plan-queue wait."""
    jt, js, _ = bursts["jax"]
    pt, ps, _ = bursts["port"]
    assert pt == jt == PHASES
    assert ps == js
    assert "plan_queue_wait_p99_ms" in ps


def hop_shape(traces):
    """Per span kind of the eval traces: (parent's kind, thread)."""
    shape = set()
    for recs in traces.values():
        by_span = {r["span"]: r for r in recs}
        for r in recs:
            if r["ph"] != "X":
                continue
            parent = by_span.get(r["parent"])
            shape.add((r["name"], parent["name"] if parent else None,
                       r["thread"]))
    return shape


def test_coalescer_hop_matches(bursts):
    _, _, port = bursts["port"]
    _, _, ref = bursts["jax"]
    for eval_id, recs in port.items():
        names = {r["name"] for r in recs}
        assert {"eval.process", "broker.queue_wait", "worker.invoke_scheduler",
                "sched.dispatch", "coalescer.queue_wait", "coalescer.device",
                "plan.submit", "plan.queue_wait", "plan.apply"} <= names
        dispatch = {r["span"] for r in recs if r["name"] == "sched.dispatch"}
        for r in recs:
            if r["name"] in ("coalescer.queue_wait", "coalescer.device"):
                assert r["parent"] in dispatch
                assert r["trace"] == eval_id
    shape = hop_shape(port)
    assert ("coalescer.device", "sched.dispatch", "resolver-coalescer") in shape
    assert ("coalescer.queue_wait", "sched.dispatch",
            "device-coalescer") in shape
    assert shape == hop_shape(ref)


def test_breach_dumps_the_flight_recorder(monkeypatch, tmp_path):
    monkeypatch.setattr(tevaluator, "_breach_dumps_used", 0)
    # Not started: only these ticks evaluate the SLO.
    srv, mock, _ = make_server(
        "port", slo_enabled=True, slo_specs=[SLOSpec(
            name="never_met", objective="nomad.worker.evals_processed",
            op=">=", target=1.0, windows=(5.0, 30.0), min_samples=1)])
    try:
        with ttrace.span("eval.process", trace_id="ev-breach"):
            pass
        for i in range(5):
            srv.observatory.tick(now=100.0 + i)
        assert len(srv.observatory.breach_dumps) == 1
        doc = json.loads(open(srv.observatory.breach_dumps[0]).read())
        assert doc["metadata"]["breached_slo"] == "never_met"
        assert doc["metadata"]["reason"] == "slo-breach-never_met"
        assert srv.observatory.breach_dumps[0].startswith(
            str(tmp_path / "traces"))
    finally:
        srv.shutdown()


# ---------------------------------------------------------------------------
# Per-span cost (tests/test_trace_overhead.py's budget)
# ---------------------------------------------------------------------------

SPANS_PER_EVAL = 12
EVAL_BUDGET_S = 0.020  # 50 evals/s floor
MAX_OVERHEAD_FRAC = 0.05
PER_SPAN_BUDGET_S = EVAL_BUDGET_S * MAX_OVERHEAD_FRAC / SPANS_PER_EVAL
CEILING_S = PER_SPAN_BUDGET_S / 5.0


def best_of(rounds, n, fn):
    """Least per-op time over the rounds: load from parallel test workers
    inflates the mean, the minimum reflects the cost."""
    best = float("inf")
    for _ in range(rounds):
        t0 = time.perf_counter()
        fn(n)
        best = min(best, (time.perf_counter() - t0) / n)
    return best


def span_burn(n, reg=None, trace_id="ev-fixed"):
    for _ in range(n):
        with ttrace.span("bench.op", trace_id=trace_id, metrics=reg):
            pass


def test_span_under_budget():
    reg = TRegistry()
    span_burn(500, reg)
    assert best_of(5, 2000, lambda n: span_burn(n, reg)) < CEILING_S


def test_record_span_and_event_under_budget():
    reg = TRegistry()
    ctx = ttrace.start_trace("ev-fixed")
    now = time.time()

    def stitch(n):
        for _ in range(n):
            ttrace.record_span("bench.stitch", now, now + 0.001, ctx=ctx,
                               metrics=reg)

    def events(n):
        for _ in range(n):
            ttrace.event("bench.seam", k="v")

    stitch(500)
    events(500)
    assert best_of(5, 2000, stitch) < CEILING_S
    assert best_of(5, 2000, events) < CEILING_S


def test_unsampled_and_disabled_spans_are_cheaper():
    reg = TRegistry()
    span_burn(500, reg)
    ttrace.configure(sample=0.0)
    span_burn(500, reg)
    # The sampled and unsampled burns alternate, round by round, so load
    # from the other test workers falls on both alike.
    sampled = unsampled = float("inf")
    for _ in range(5):
        ttrace.configure(sample=1.0)
        sampled = min(sampled, best_of(1, 2000, lambda n: span_burn(n, reg)))
        ttrace.configure(sample=0.0)
        unsampled = min(unsampled,
                        best_of(1, 2000, lambda n: span_burn(n, reg)))
    assert unsampled <= sampled * 1.5
    ttrace.configure(enabled=False)
    span_burn(500)
    assert best_of(5, 5000, span_burn) < CEILING_S / 2
