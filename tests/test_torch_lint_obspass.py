"""The port's chaos-seam and observability passes
(``nomad_tpu_torch/lint/chaospass.py`` C001-C004,
``nomad_tpu_torch/lint/obspass.py`` O001-O004) on seeded fixtures, as
``tests/test_lint.py`` holds the reference's, and on the port's tree:
its 17 seams against its own catalog (``nomad_tpu_torch/chaos/
CATALOG.md``; the reference's ``CHAOS.md`` stays the reference's), its
SLO specs, the overload actuators and the breaker's transitions.
"""

from __future__ import annotations

import textwrap

from nomad_tpu_torch.lint import chaospass, obspass

_dedent = textwrap.dedent

# The port's seams (the reference's seventeen).
PORT_SEAMS = (
    "rpc.call", "raft.send", "wal.write", "heartbeat.ttl",
    "client.heartbeat", "driver.start", "driver.wait", "driver.stop",
    "coalescer.dispatch", "controller.actuate", "broker.shed",
    "blocked.unblock", "admission.gate", "shard.partition", "device.wedge",
    "device.slow", "shard.loss",
)

_DOC = """
## Seam catalog

| Seam | Where | ctx keys | Kinds honored |
|---|---|---|---|
| `rpc.call` | `api/rpc.py` | path | drop |
| `ghost.seam` | `gone.py` | x | drop |
| `lonely.seam` | `real.py` | x | drop |

## Retry policy surface (`nomad_tpu_torch/retry.py`)

RPC failover (`api/rpc.py`), bare loop (`client/naked.py`).
"""


class TestChaosPass:
    def _analyze(self, **over):
        kw = dict(
            doc=_DOC,
            code_seams={
                "rpc.call": [("nomad_tpu_torch/api/rpc.py", 10)],
                "lonely.seam": [("nomad_tpu_torch/real.py", 5)],
                "rogue.seam": [("nomad_tpu_torch/rogue.py", 7)],
            },
            exercised={"rpc.call"},
            retry_sources={
                "api/rpc.py": "x = retry_call(fn, RetryPolicy())",
                "client/naked.py": "while True: time.sleep(1)",
            },
        )
        kw.update(over)
        return chaospass.analyze(**kw)

    def test_stale_documented_seam_fires_c001(self):
        fs = self._analyze()
        stale = [f for f in fs if f.rule == "C001"]
        assert len(stale) == 1 and stale[0].symbol == "ghost.seam", fs

    def test_undocumented_code_seam_fires_c002(self):
        fs = self._analyze()
        rogue = [f for f in fs if f.rule == "C002"]
        assert len(rogue) == 1 and rogue[0].symbol == "rogue.seam", fs

    def test_unexercised_seam_fires_c003(self):
        fs = self._analyze()
        dead = [f for f in fs if f.rule == "C003"]
        assert len(dead) == 1 and dead[0].symbol == "lonely.seam", fs

    def test_retry_drift_fires_c004(self):
        fs = self._analyze()
        drift = [f for f in fs if f.rule == "C004"]
        assert len(drift) == 1 and drift[0].symbol == "client/naked.py", fs

    def test_consistent_surface_is_clean(self):
        fs = self._analyze(
            code_seams={
                "rpc.call": [("nomad_tpu_torch/api/rpc.py", 10)],
                "ghost.seam": [("nomad_tpu_torch/gone.py", 3)],
                "lonely.seam": [("nomad_tpu_torch/real.py", 5)],
            },
            exercised={"rpc.call", "ghost.seam", "lonely.seam"},
            retry_sources={
                "api/rpc.py": "retry_call(fn)",
                "client/naked.py": "RetryPolicy()",
            },
        )
        assert fs == [], fs

    def test_port_catalog_parses(self):
        from nomad_tpu_torch.lint import repo_root

        import os

        with open(os.path.join(repo_root(), *chaospass.DOC_NAME.split("/"))
                  ) as fh:
            seams, retry_mods = chaospass.parse_doc(fh.read())
        assert sorted(seams) == sorted(PORT_SEAMS)
        assert any(m.endswith("rpc.py") for m in retry_mods)

    def test_port_catalog_matches_the_tree(self):
        """Every one of the 17 seams has a call site, a row and a test;
        every retry-surface module uses the shared helpers."""
        from nomad_tpu_torch.lint import repo_root

        root = repo_root()
        assert sorted(chaospass.collect_code_seams(root)) == sorted(
            PORT_SEAMS)
        assert chaospass.run(root) == []

    def test_missing_catalog_is_c001(self, tmp_path):
        (tmp_path / "nomad_tpu_torch").mkdir()
        fs = chaospass.run(str(tmp_path))
        assert [f.rule for f in fs] == ["C001"], fs
        assert fs[0].path == chaospass.DOC_NAME


class TestObsPass:
    def test_seam_without_trace_fires_o001(self):
        fs = obspass.analyze_module("nomad_tpu_torch/m.py", _dedent('''
            from ..chaos import inject

            def hot_path():
                fault = inject("wal.write", op="x")
                return fault
        '''))
        assert len(fs) == 1 and fs[0].rule == "O001", fs
        assert fs[0].symbol == "hot_path"
        assert "wal.write" in fs[0].message

    def test_direct_emission_is_clean(self):
        fs = obspass.analyze_module("nomad_tpu_torch/m.py", _dedent('''
            from .. import trace
            from ..chaos import inject

            def hot_path():
                fault = inject("wal.write", op="x")
                trace.event("seam.wal.write", op="x")
        '''))
        assert fs == [], fs

    def test_span_counts_as_emission(self):
        fs = obspass.analyze_module("nomad_tpu_torch/m.py", _dedent('''
            from .. import trace
            from ..chaos import inject

            def hot_path():
                inject("rpc.call", path="/x")
                with trace.span("rpc.send"):
                    pass
        '''))
        assert fs == [], fs

    def test_emitting_wrapper_covers_callers(self):
        # driver.py's pattern: a local _chaos guard emits the event for
        # every caller, so call sites need no trace call of their own.
        fs = obspass.analyze_module("nomad_tpu_torch/m.py", _dedent('''
            from .. import trace
            from ..chaos import inject

            def _chaos(point, **kw):
                f = inject(point, **kw)
                trace.event("seam." + point, **kw)
                return f

            def start_task():
                _chaos("driver.start", driver="d")
        '''))
        assert fs == [], fs

    def test_silent_wrapper_flags_callers(self):
        fs = obspass.analyze_module("nomad_tpu_torch/m.py", _dedent('''
            from ..chaos import inject

            def _chaos(point, **kw):
                return inject(point, **kw)

            def start_task():
                _chaos("driver.start", driver="d")
        '''))
        assert any(f.symbol == "start_task" for f in fs), fs

    def test_nested_def_does_not_leak_emission(self):
        # A trace call inside an inner closure is not on the seam's path.
        fs = obspass.analyze_module("nomad_tpu_torch/m.py", _dedent('''
            from .. import trace
            from ..chaos import inject

            def outer():
                inject("wal.write", op="x")
                def unrelated():
                    trace.event("elsewhere")
        '''))
        assert len(fs) == 1 and fs[0].symbol == "outer", fs

    def test_production_tree_is_clean(self):
        from nomad_tpu_torch.lint import repo_root

        assert obspass.run(repo_root()) == []


class TestO002SloObjectives:
    def test_unregistered_objective_fires(self):
        reg = obspass.collect_metric_names(
            'm = metrics.timer("nomad.eval.latency")')
        fs = obspass.analyze_slo_objectives("nomad_tpu_torch/m.py", _dedent('''
            from .obs import SLOSpec

            SPECS = [SLOSpec(name="lat", objective="nomad.evals.latency",
                             op="<", target=5.0)]
        '''), reg)
        assert len(fs) == 1 and fs[0].rule == "O002", fs
        assert fs[0].symbol == "lat"
        assert "nomad.evals.latency" in fs[0].message

    def test_registered_objective_is_clean(self):
        reg = obspass.collect_metric_names(
            'metrics.timer("nomad.eval.latency")')
        fs = obspass.analyze_slo_objectives("nomad_tpu_torch/m.py", _dedent('''
            SPECS = [SLOSpec(name="lat", objective="nomad.eval.latency",
                             op="<", target=5.0)]
        '''), reg)
        assert fs == [], fs

    def test_name_universe_covers_all_registration_shapes(self):
        reg = obspass.collect_metric_names(_dedent('''
            def setup(metrics, trace, snap):
                metrics.timer("nomad.a.timer")
                metrics.incr("nomad.b.counter")
                metrics.gauge_fn("nomad.c.gauge", lambda: 0)
                with trace.span("plan.apply"):
                    pass
                snap["nomad.d.handrolled"] = 1
        '''))
        assert reg == {
            "nomad.a.timer", "nomad.b.counter", "nomad.c.gauge",
            "nomad.phase.plan.apply", "nomad.d.handrolled",
        }

    def test_positional_objective_checked(self):
        fs = obspass.analyze_slo_objectives(
            "nomad_tpu_torch/m.py",
            'S = SLOSpec("lat", "nomad.bogus", "<", 5.0)',
            {"nomad.real"},
        )
        assert len(fs) == 1 and fs[0].symbol == "lat", fs

    def test_dynamic_objective_out_of_scope(self):
        # Only literals are checked — a computed name can't be resolved
        # statically and must not flag.
        fs = obspass.analyze_slo_objectives("nomad_tpu_torch/m.py", _dedent('''
            def make(name):
                return SLOSpec(name="x", objective=name, op="<", target=1.0)
        '''), set())
        assert fs == [], fs

    def test_default_slos_resolve_in_production_tree(self):
        # The shipped specs must stay wired to real metrics: collect the
        # whole package's name universe, check obs/slo.py against it.
        from nomad_tpu_torch.lint import repo_root

        root = repo_root()
        registered = set()
        for rel, src in obspass._walk_sources(root):
            registered |= obspass.collect_metric_names(src)
        import os as _os
        with open(_os.path.join(root, "nomad_tpu_torch", "obs", "slo.py")) as fh:
            src = fh.read()
        assert obspass.analyze_slo_objectives(
            "nomad_tpu_torch/obs/slo.py", src, registered) == []


class TestO003Actuators:
    def test_silent_actuator_fires(self):
        fs = obspass.analyze_actuators("nomad_tpu_torch/m.py", _dedent('''
            def engage(self):
                self.server.admission_gate.set_gate_level(0.5)
        '''))
        assert len(fs) == 1 and fs[0].rule == "O003", fs
        assert fs[0].symbol == "engage"
        assert "set_gate_level" in fs[0].message

    def test_trace_and_counter_is_clean(self):
        fs = obspass.analyze_actuators("nomad_tpu_torch/m.py", _dedent('''
            def engage(self):
                self.server.admission_gate.set_gate_level(0.5)
                self.server.eval_broker.set_shedding(True)
                trace.event("seam.controller.actuate", target="gating")
                self.server.metrics.incr("nomad.overload.actuations")
        '''))
        assert fs == [], fs

    def test_trace_without_counter_fires(self):
        fs = obspass.analyze_actuators("nomad_tpu_torch/m.py", _dedent('''
            def engage(self):
                self.broker.set_shedding(True)
                trace.event("seam.controller.actuate")
        '''))
        assert len(fs) == 1, fs
        assert "counter" in fs[0].message
        assert "trace" not in fs[0].message.split("never emits")[1]

    def test_counter_without_trace_fires(self):
        fs = obspass.analyze_actuators("nomad_tpu_torch/m.py", _dedent('''
            def engage(self):
                self.gate.set_gate_level(0.25)
                self.metrics.incr("nomad.overload.actuations")
        '''))
        assert len(fs) == 1, fs
        assert "trace event" in fs[0].message

    def test_non_nomad_counter_does_not_satisfy(self):
        # A dynamic or foreign counter name is not the registered-counter
        # contract — the dashboard row would not exist.
        fs = obspass.analyze_actuators("nomad_tpu_torch/m.py", _dedent('''
            def engage(self, name):
                self.gate.set_gate_level(0.25)
                trace.event("seam.controller.actuate")
                self.metrics.incr(name)
        '''))
        assert len(fs) == 1 and "counter" in fs[0].message, fs

    def test_nested_def_does_not_leak(self):
        fs = obspass.analyze_actuators("nomad_tpu_torch/m.py", _dedent('''
            def outer(self):
                self.gate.set_gate_level(1.0)
                def unrelated():
                    trace.event("elsewhere")
                    metrics.incr("nomad.x")
        '''))
        assert len(fs) == 1 and fs[0].symbol == "outer", fs

    def test_both_actuators_reported_per_site(self):
        fs = obspass.analyze_actuators("nomad_tpu_torch/m.py", _dedent('''
            def engage(self):
                self.gate.set_gate_level(0.5)
                self.broker.set_shedding(True)
        '''))
        assert len(fs) == 2, fs
        assert {f.rule for f in fs} == {"O003"}

    def test_controller_actuators_comply_in_tree(self):
        # The real decision sites must stay compliant (O003's raison
        # d'être) — check the shipped controller module directly.
        import os

        from nomad_tpu_torch.lint import repo_root

        with open(os.path.join(
            repo_root(), "nomad_tpu_torch", "obs", "controller.py"
        )) as fh:
            src = fh.read()
        assert obspass.analyze_actuators(
            "nomad_tpu_torch/obs/controller.py", src) == []


class TestO004Breaker:
    def test_silent_transition_fires(self):
        fs = obspass.analyze_breaker_transitions("nomad_tpu_torch/m.py", _dedent('''
            def trip(self):
                self._apply_transition(2, now)
        '''))
        assert len(fs) == 1 and fs[0].rule == "O004", fs
        assert fs[0].symbol == "trip"
        assert "_apply_transition" in fs[0].message

    def test_trace_and_counter_is_clean(self):
        fs = obspass.analyze_breaker_transitions("nomad_tpu_torch/m.py", _dedent('''
            def trip(self, now):
                self._apply_transition(2, now)
                trace.event("seam.breaker.transition", frm="closed", to="open")
                self.metrics.incr("nomad.breaker.transitions")
        '''))
        assert fs == [], fs

    def test_trace_without_counter_fires(self):
        fs = obspass.analyze_breaker_transitions("nomad_tpu_torch/m.py", _dedent('''
            def trip(self, now):
                self._apply_transition(2, now)
                trace.event("seam.breaker.transition")
        '''))
        assert len(fs) == 1, fs
        assert "counter" in fs[0].message
        assert "trace" not in fs[0].message.split("never emits")[1]

    def test_counter_without_trace_fires(self):
        fs = obspass.analyze_breaker_transitions("nomad_tpu_torch/m.py", _dedent('''
            def trip(self, now):
                self._apply_transition(2, now)
                self.metrics.incr("nomad.breaker.transitions")
        '''))
        assert len(fs) == 1, fs
        assert "trace event" in fs[0].message

    def test_mutator_definition_scope_is_skipped(self):
        # _apply_transition recursing into itself (or a wrapper that IS
        # the mutator) is not a call site that owes the emission.
        fs = obspass.analyze_breaker_transitions("nomad_tpu_torch/m.py", _dedent('''
            class DeviceBreaker:
                def _apply_transition(self, target, now):
                    if target == 3:
                        self._apply_transition(0, now)
        '''))
        assert fs == [], fs

    def test_nested_def_does_not_leak(self):
        fs = obspass.analyze_breaker_transitions("nomad_tpu_torch/m.py", _dedent('''
            def trip(self, now):
                self._apply_transition(2, now)
                def unrelated():
                    trace.event("seam.breaker.transition")
                    metrics.incr("nomad.breaker.transitions")
        '''))
        assert len(fs) == 1 and fs[0].symbol == "trip", fs

    def test_breaker_module_complies_in_tree(self):
        # The shipped breaker must stay compliant — every state flip has
        # a seam event and a counter to line up against placement latency.
        import os

        from nomad_tpu_torch.lint import repo_root

        with open(os.path.join(
            repo_root(), "nomad_tpu_torch", "obs", "breaker.py"
        )) as fh:
            src = fh.read()
        assert obspass.analyze_breaker_transitions(
            "nomad_tpu_torch/obs/breaker.py", src) == []
