"""Shared pieces of the chaos parity tests (``test_torch_chaos*.py``):
the two packages side by side, the fired-fault log as rows, a fixture
that records the trace events each package emits, and nodes built
alike in both."""

import numpy as np
import pytest

from nomad_tpu import chaos as jchaos
from nomad_tpu import mock as jmock
from nomad_tpu import trace as jtrace
from nomad_tpu_torch import chaos as tchaos
from nomad_tpu_torch import mock as tmock
from nomad_tpu_torch import trace as ttrace

JAX, PORT = "jax", "port"
PKGS = (JAX, PORT)


def chaos(pkg):
    return jchaos if pkg == JAX else tchaos


def mock(pkg):
    return jmock if pkg == JAX else tmock


def rows(log):
    return [(f.seam, f.kind, f.step) for f in log]


@pytest.fixture
def seam_events(monkeypatch):
    """The names of the trace events each package emits, by package."""
    seen = {JAX: [], PORT: []}
    for pkg, mod in ((JAX, jtrace), (PORT, ttrace)):
        real = mod.event

        def event(name, *a, _real=real, _pkg=pkg, **kw):
            seen[_pkg].append(name)
            return _real(name, *a, **kw)

        monkeypatch.setattr(mod, "event", event)
    return seen


def twin_nodes(n, seed=5):
    """``n`` nodes built alike in both packages (same ids and shapes)."""
    rng = np.random.default_rng(seed)
    out = {JAX: [], PORT: []}
    for i in range(n):
        nid = f"node-{i:04d}-{int(rng.integers(1 << 30)):08x}"
        for pkg in PKGS:
            node = mock(pkg).node()
            node.id = nid
            out[pkg].append(node)
    return out
