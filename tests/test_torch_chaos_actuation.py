"""The port's overload actuation seams and its invariant oracle against
the JAX package's, on the CPU: ``controller.actuate``, ``broker.shed``,
``blocked.unblock`` and ``admission.gate`` lose their actuation alike
(the reference's ``tests/test_overload.py`` ``TestActuationSeams``), and
the reference's ``TestInvariants`` stores give the same violations.
"""

import random
from types import SimpleNamespace

import pytest
import torch

from torch_chaos_parity import (  # noqa: F401 — seam_events is a fixture
    JAX,
    PKGS,
    PORT,
    chaos,
    mock,
    seam_events,
    twin_nodes,
)

torch.set_num_threads(1)


def overload(pkg):
    if pkg == JAX:
        from nomad_tpu.obs import controller
        from nomad_tpu.server import admission, blocked_evals, eval_broker
    else:
        from nomad_tpu_torch.obs import controller
        from nomad_tpu_torch.server import (
            admission,
            blocked_evals,
            eval_broker,
        )
    return SimpleNamespace(controller=controller, admission=admission,
                           blocked=blocked_evals, broker=eval_broker)


class _Metrics:
    def __init__(self):
        self.counts = {}

    def incr(self, name, n=1, **tags):
        self.counts[name] = self.counts.get(name, 0) + n

    def gauge_fn(self, name, fn, **tags):
        pass


class _Broker:
    def __init__(self):
        self.shedding = False

    def set_shedding(self, enabled, **kw):
        self.shedding = enabled

    def shed_stats(self):
        return {"enabled": self.shedding, "total_shed": 0}


class _Blocked:
    def fairness_stats(self):
        return {"policy": "deficit-round-robin"}


def test_controller_actuate_lost_then_redriven(seam_events):
    out = {}
    for pkg in PKGS:
        c, o = chaos(pkg), overload(pkg)
        srv = SimpleNamespace(
            admission_gate=o.admission.AdmissionGate(rate=100.0, burst=100.0),
            eval_broker=_Broker(), blocked_evals=_Blocked(),
            metrics=_Metrics())
        cfg = o.controller.OverloadConfig(
            gate_enter=0.3, gate_exit=0.15, shed_enter=0.6, shed_exit=0.25,
            window_fast=2.0, window_slow=3.0, min_dwell=1.0, cooldown=0.1,
            max_flips=10, flip_window=60.0)
        ctrl = o.controller.OverloadController(srv, config=cfg)

        def step(t, p):
            return ctrl.step({"pressure": p}, breached=[], now=t)

        got = []
        with c.injected(1, [c.FaultSpec("controller.actuate", "error",
                                        count=1)]):
            got.append(step(0.0, 0.0))
            got.append(step(0.5, 0.9))  # escalation decided, lost
            got += [ctrl.actuations_lost, srv.admission_gate.factor]
            got.append(step(0.7, 0.9))  # re-driven
            got.append(srv.admission_gate.factor)
        out[pkg] = got
    assert out[PORT] == out[JAX]
    assert out[PORT][1] == "steady" and out[PORT][2] == 1
    assert out[PORT][3] == 1.0 and out[PORT][5] < 1.0
    assert "seam.controller.actuate" in seam_events[PORT]


def test_broker_shed_actuation_lost(seam_events):
    out = {}
    for pkg in PKGS:
        c, o = chaos(pkg), overload(pkg)
        b = o.broker.EvalBroker()
        with c.injected(1, [c.FaultSpec("broker.shed", "error", count=1)]):
            b.set_shedding(True, priority_floor=50)
            first = b.shed_stats()["enabled"]
            b.set_shedding(True, priority_floor=50)
        out[pkg] = (first, b.shed_stats()["enabled"])
    assert out[PORT] == out[JAX] == (False, True)
    assert "seam.broker.shed" in seam_events[PORT]


def test_blocked_unblock_wakeup_lost(seam_events):
    out = {}
    for pkg in PKGS:
        c, o = chaos(pkg), overload(pkg)
        got = []
        be = o.blocked.BlockedEvals(got.append)
        be.set_enabled(True)
        ev = mock(pkg).eval_for(mock(pkg).job())
        be.block(ev)
        with c.injected(1, [c.FaultSpec("blocked.unblock", "error",
                                        count=1)]):
            be.unblock("class-a", index=5)
            lost = list(got)
            be.unblock("class-a", index=6)
        out[pkg] = (lost, [e.id == ev.id for e in got])
    assert out[PORT] == out[JAX] == ([], [True])
    assert "seam.blocked.unblock" in seam_events[PORT]


def test_admission_gate_spurious_429(seam_events):
    out = {}
    for pkg in PKGS:
        c, o = chaos(pkg), overload(pkg)
        g = o.admission.AdmissionGate(rate=1000.0, burst=1000.0)
        with c.injected(1, [c.FaultSpec("admission.gate", "error",
                                        count=1)]):
            with pytest.raises(o.admission.RateLimitError) as ei:
                g.check("a", now=0.0)
            g.check("a", now=0.0)
        out[pkg] = (str(ei.value), ei.value.retry_after,
                    g.stats()["rejected"], g.stats()["admitted"])
    assert out[PORT] == out[JAX]
    assert out[PORT][2:] == (0, 1)  # the bucket was never touched
    assert "seam.admission.gate" in seam_events[PORT]




# ---------------------------------------------------------------------------
# The invariant checker
# ---------------------------------------------------------------------------


def store(pkg):
    if pkg == JAX:
        from nomad_tpu.state.store import StateStore
        return StateStore()
    from nomad_tpu_torch.state.matrix import NodeMatrix
    from nomad_tpu_torch.state.store import StateStore
    return StateStore(matrix=NodeMatrix(device="cpu"))


def twin_job_allocs(n_allocs, node=None):
    """A job and ``n_allocs`` allocs of it built alike in both packages."""
    out = {}
    for pkg in PKGS:
        random.seed(11)
        job = mock(pkg).job()
        job.id = "chaos-job"
        allocs = []
        for i in range(n_allocs):
            a = mock(pkg).alloc(job, node[pkg] if node else None)
            a.id = f"alloc-{i}"
            allocs.append(a)
        out[pkg] = (job, allocs)
    return out


def check(pkg, name, *a):
    return getattr(chaos(pkg), name)(*a)


def test_clean_store_has_no_violations():
    nodes = twin_nodes(1)
    for pkg in PKGS:
        s = store(pkg)
        s.upsert_node(1, nodes[pkg][0])
        for name in ("check_replacement_coverage", "check_allocs_fit",
                     "check_volume_writers"):
            assert check(pkg, name, s) == [], (pkg, name)


def test_volume_writer_violation_detected():
    out = {}
    for pkg in PKGS:
        if pkg == JAX:
            from nomad_tpu.structs.types import Volume
        else:
            from nomad_tpu_torch.structs.types import Volume
        s = store(pkg)
        _job, (a1, a2) = twin_job_allocs(2)[pkg]
        s.upsert_allocs(1, [a1, a2])
        vol = Volume(id="v1", namespace="default",
                     access_mode="single-node-writer")
        vol.write_claims = {a1.id: a1.node_id, a2.id: a2.node_id}
        with s._lock:
            s.volumes[(vol.namespace, vol.id)] = vol
        out[pkg] = check(pkg, "check_volume_writers", s)
    assert out[PORT] == out[JAX]
    assert len(out[PORT]) == 1 and "2 live writers" in out[PORT][0]


def test_overcommit_detected():
    nodes = twin_nodes(1)
    allocs = twin_job_allocs(2, node={p: nodes[p][0] for p in PKGS})
    out = {}
    for pkg in PKGS:
        s = store(pkg)
        node = nodes[pkg][0]
        s.upsert_node(1, node)
        _job, pair = allocs[pkg]
        for a in pair:
            a.resources.cpu = node.resources.cpu  # each alone fills it
        s.upsert_allocs(2, pair)
        out[pkg] = check(pkg, "check_allocs_fit", s)
    assert out[PORT] == out[JAX]
    assert len(out[PORT]) == 1 and "over-committed" in out[PORT][0]


def test_stranded_alloc_detected():
    nodes = twin_nodes(1)
    allocs = twin_job_allocs(1, node={p: nodes[p][0] for p in PKGS})
    out = {}
    for pkg in PKGS:
        s = store(pkg)
        node = nodes[pkg][0]
        s.upsert_node(1, node)
        s.upsert_allocs(2, allocs[pkg][1])
        node.status = "down"
        s.upsert_node(3, node)
        out[pkg] = check(pkg, "check_replacement_coverage", s)
    assert out[PORT] == out[JAX]
    assert len(out[PORT]) == 1 and "no replacement eval" in out[PORT][0]


def test_broker_flags_stuck_lease_not_transient_checkout():
    class StuckBroker:
        enabled = True

        def unacked_ids(self):
            return ["ev-stuck"]

    class TransientBroker:
        enabled = True

        def __init__(self):
            self._polls = 0

        def unacked_ids(self):
            self._polls += 1
            return ["ev-busy"] if self._polls == 1 else []

    for pkg in PKGS:
        srv = SimpleNamespace(eval_broker=StuckBroker())
        assert check(pkg, "check_broker", srv, 0.3) == [
            "eval broker holds 1 stuck unacked eval(s): ev-stuck"], pkg
        srv = SimpleNamespace(eval_broker=TransientBroker())
        assert check(pkg, "check_broker", srv, 0.3) == [], pkg


def test_convergence_names_the_diverging_server():
    nodes = twin_nodes(2)
    out = {}
    for pkg in PKGS:
        stores = [store(pkg) for _ in range(3)]
        for s in stores:
            s.upsert_node(1, nodes[pkg][0])
        stores[2].upsert_node(2, nodes[pkg][1])
        servers = [SimpleNamespace(store=s) for s in stores]
        out[pkg] = (check(pkg, "check_convergence", servers[:2]),
                    check(pkg, "check_convergence", servers),
                    check(pkg, "wait_converged", servers[:2], 0.2))
    assert out[PORT] == out[JAX]
    assert out[PORT][0] == [] and out[PORT][2] == []
    assert out[PORT][1][0] == "store indexes diverge: [1, 1, 2]"
    assert "server[2] FSM image differs" in out[PORT][1][1]
