"""The single-card batched scheduling step, ready to run.

``entry()`` returns ``(fn, args)``: ``fn(*args)`` scores every node of a
small synthetic cluster for a batch of evals and picks each eval's best
node (``ops.kernels.score_batch``), the counterpart of the JAX package's
``__graft_entry__.entry()`` on the same cluster and batch.  It runs on the
card unless the caller asks for the CPU::

    from nomad_tpu_torch.entry import entry
    fn, args = entry()            # device="cuda"; entry("cpu") on a host
    res = fn(*args)               # BatchScoreResult: rows, scores, ...
"""

from __future__ import annotations

import numpy as np


def _build_cluster(n_nodes: int, capacity: int, b: int, device):
    """A small synthetic cluster (a rack attribute over four racks, usage
    at 0-50% of each node's totals) and a batch of ``b`` copies of one
    mock job's request."""
    from . import mock
    from .ops.encode import RequestEncoder
    from .parallel import build_batch_inputs
    from .state.matrix import NodeMatrix

    rng = np.random.default_rng(0)
    m = NodeMatrix(capacity=capacity, device=device)
    for i in range(n_nodes):
        node = mock.node()
        node.attributes = dict(node.attributes)
        node.attributes["rack"] = f"r{i % 4}"
        m.upsert_node(node)
    host = m.snapshot_host()
    for row in range(n_nodes):
        host["used"][row] = rng.uniform(0.0, 0.5, 3) * host["totals"][row]
        m._dirty.add(row)

    job = mock.job()
    compiled = RequestEncoder(m).compile(job, job.task_groups[0])
    arrays = m.sync()
    return arrays, build_batch_inputs(m, [compiled.request] * b, device)


def entry(device="cuda"):
    """(fn, example_args): the single-card batched scheduling step, on
    ``device``."""
    from .ops.kernels import score_batch

    arrays, inp = _build_cluster(n_nodes=24, capacity=32, b=4, device=device)
    args = (
        arrays,
        arrays.used,
        inp["tg_counts"],
        inp["spread_counts"],
        inp["penalties"],
        inp["req_i"],
        inp["req_f"],
        inp["class_eligs"],
        inp["host_masks"],
    )
    return score_batch, args
