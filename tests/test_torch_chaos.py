"""The port's fault injector against the JAX package's, on the CPU: the
same seeded coin for every ``(seed, seam, hit)``, and the reference's
``TestInjector`` schedules (``tests/test_chaos.py``) fire the same specs
at the same hits with the same log in both packages.

The seams are in ``test_torch_chaos_seams.py`` (the host seams),
``test_torch_chaos_actuation.py`` (the overload actuators, the dump's
seed and the invariant oracle) and ``test_torch_chaos_dispatch.py`` (the
device seams); the scenarios in ``test_torch_chaos_device.py``,
``_host.py``, ``_cluster.py`` and ``_overload.py``.  Every file holds few
tests, so ``--dist loadfile`` hands them out after ``tests/test_chaos.py``
(ROADMAP R2).
"""

import time

import pytest
import torch

from nomad_tpu import chaos as jchaos
from nomad_tpu_torch import chaos as tchaos
from torch_chaos_parity import PKGS, PORT, JAX, chaos, rows

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# The injector
# ---------------------------------------------------------------------------

SEAMS = ("rpc.call", "raft.send", "wal.write", "heartbeat.ttl",
         "client.heartbeat", "driver.start", "driver.wait", "driver.stop",
         "controller.actuate", "broker.shed", "blocked.unblock",
         "admission.gate", "device.wedge", "device.slow", "shard.loss",
         "shard.partition", "coalescer.dispatch")


def test_coin_table_matches():
    """The trigger coin is sha256 of ``seed:seam:hit``: equal tables."""
    for seed in (0, 1, 7, 42, 2**31 + 5):
        j = jchaos.FaultInjector(seed, [])
        t = tchaos.FaultInjector(seed, [])
        for seam in SEAMS:
            for hit in range(1, 65):
                assert t._coin(seam, hit) == j._coin(seam, hit), (
                    seed, seam, hit)


def _spec(pkg, *a, **kw):
    return chaos(pkg).FaultSpec(*a, **kw)


# (schedule, hit sequence of (seam, ctx)) — the reference's TestInjector.
INJECTOR_CASES = {
    "same_seed_p": (
        lambda pkg: [_spec(pkg, "raft.send", "drop", p=0.5)],
        [("raft.send", {"dst": "x"})] * 200, 42),
    "other_seed_p": (
        lambda pkg: [_spec(pkg, "s", "drop", p=0.5)],
        [("s", {})] * 64, 2),
    "at_step": (
        lambda pkg: [_spec(pkg, "s", "error", at_step=3)],
        [("s", {})] * 6, 0),
    "count": (
        lambda pkg: [_spec(pkg, "s", "drop", count=2)],
        [("s", {})] * 5, 0),
    "after_step": (
        lambda pkg: [_spec(pkg, "s", "drop", after_step=2)],
        [("s", {})] * 4, 0),
    "match": (
        lambda pkg: [_spec(pkg, "raft.send", "drop", match={"dst": "b"})],
        [("raft.send", {"dst": "a"}), ("raft.send", {"dst": "b"})] * 3, 0),
    "glob": (
        lambda pkg: [_spec(pkg, "driver.*", "hang")],
        [("driver.wait", {"task": "t"}), ("rpc.call", {})] * 3, 0),
    "first_match_wins": (
        lambda pkg: [_spec(pkg, "raft.send", "drop", match={"dst": "b"},
                           count=2),
                     _spec(pkg, "raft.*", "delay", p=0.3, after_step=1),
                     _spec(pkg, "*", "error", at_step=5)],
        [("raft.send", {"dst": "a"}), ("raft.send", {"dst": "b"}),
         ("rpc.call", {})] * 12, 9),
}


@pytest.mark.parametrize("case", sorted(INJECTOR_CASES))
def test_injector_schedules_fire_alike(case):
    make, hits, seed = INJECTOR_CASES[case]
    out = {}
    for pkg in PKGS:
        inj = chaos(pkg).FaultInjector(seed, make(pkg))
        fired = []
        for seam, ctx in hits:
            spec = inj.fire(seam, **ctx)
            fired.append(None if spec is None else (spec.seam, spec.kind))
        out[pkg] = (fired, rows(inj.log),
                    {s: inj.hits(s) for s, _ in hits})
    assert out[PORT] == out[JAX]
    if case == "same_seed_p":
        assert 0 < len(out[PORT][1]) < 200  # p=0.5 discriminates


def test_different_seeds_fire_differently():
    def fires(seed):
        inj = tchaos.FaultInjector(seed, [tchaos.FaultSpec("s", "drop",
                                                           p=0.5)])
        for _ in range(64):
            inj.fire("s")
        return [f.step for f in inj.log]

    assert fires(1) != fires(2) and fires(5) != fires(6)


def test_install_and_inject_match():
    for pkg in PKGS:
        c = chaos(pkg)
        assert c.active() is None
        assert c.inject("rpc.call", path="/x") is None
        with c.injected(1, [c.FaultSpec("a.b", "drop")]) as inj:
            assert c.active() is inj
            assert c.inject("a.b").kind == "drop"
        assert c.active() is None
        c.install(c.FaultInjector(3, []))
        assert c.active().seed == 3
        c.uninstall()
        assert c.active() is None


def test_delay_absorbed_in_inject():
    for pkg in PKGS:
        c = chaos(pkg)
        with c.injected(0, [c.FaultSpec("s", "delay", duration=0.05)]) as inj:
            t0 = time.monotonic()
            assert c.inject("s") is None  # absorbed, not returned
            assert time.monotonic() - t0 >= 0.04
        assert rows(inj.log) == [("s", "delay", 1)]
