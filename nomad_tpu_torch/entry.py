"""The single-card batched scheduling step, ready to run.

``entry()`` returns ``(fn, args)``: ``fn(*args)`` scores every node of a
small synthetic cluster for a batch of evals and picks each eval's best
node (``ops.kernels.score_batch``), the counterpart of the JAX package's
``__graft_entry__.entry()`` on the same cluster and batch.  It runs on the
card unless the caller asks for the CPU::

    from nomad_tpu_torch.entry import entry
    fn, args = entry()            # device="cuda"; entry("cpu") on a host
    res = fn(*args)               # BatchScoreResult: rows, scores, ...

``dryrun_multichip(n_devices, device)`` is the node-sharded counterpart
of ``__graft_entry__.dryrun_multichip``: one sharded scheduling step on an
``n_devices`` mesh, then a live server whose coalescer dispatches over the
same mesh.  From a shell::

    python -m nomad_tpu_torch.entry --dryrun 8 --device cpu
"""

from __future__ import annotations

import numpy as np


import argparse
import sys


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


def _mesh_devices(n_devices: int, device):
    """``device`` named ``n_devices`` times (virtual shards), or a list
    as it is."""
    if isinstance(device, (list, tuple)):
        return list(device)
    return [device] * n_devices


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """One sharded scheduling step on an ``n_devices`` mesh, then a live
    server (broker → worker → sharded coalescer → applier) over the same
    mesh placing three jobs of two allocs.  ``device`` is one device,
    named ``n_devices`` times (virtual shards: ``"cpu"``, ``"cuda:0"``),
    or a list of devices.  Raises on any failure; returns a summary."""
    from . import mock
    from .parallel import make_mesh, shard_matrix_arrays, sharded_schedule_step
    from .server import Server, ServerConfig

    devs = _mesh_devices(n_devices, device)
    mesh = make_mesh(n_devices, devices=devs)
    b_rows, node_shards = mesh.shape
    # Capacity must split evenly along the node axis.
    capacity = node_shards * max(8, -(-32 // node_shards))
    b = b_rows * 2
    arrays, inp = _build_cluster(n_nodes=capacity // 2, capacity=capacity,
                                 b=b, device=mesh.lead)
    sharded = shard_matrix_arrays(mesh, arrays)
    res, used_after = sharded_schedule_step(mesh)(
        sharded, inp["tg_counts"], inp["spread_counts"], inp["penalties"],
        inp["req_i"], inp["req_f"], inp["class_eligs"], inp["host_masks"])
    rows = res.rows.cpu().numpy()
    if rows.shape != (b,) or not (rows >= 0).all():
        raise RuntimeError(f"dryrun placements failed: {rows}")
    if not all(bool(u.isfinite().all()) for row in used_after for u in row):
        raise RuntimeError("dryrun usage is not finite")
    print(f"dryrun_multichip ok: mesh={mesh.shape} axes={mesh.axis_names} "
          f"rows={rows.tolist()}", flush=True)

    srv = Server(ServerConfig(
        num_workers=2, heartbeat_min_ttl=60.0, heartbeat_max_ttl=90.0,
        node_capacity=capacity, slo_enabled=False, overload_enabled=False,
    ), device=devs[:n_devices])
    srv.start()
    try:
        for i in range(capacity // 2):
            node = mock.node()
            node.attributes = dict(node.attributes)
            node.attributes["rack"] = f"r{i % 4}"
            srv.register_node(node)
        placed = 0
        for _ in range(3):
            job = mock.job()
            tg = job.task_groups[0]
            tg.count = 2
            tg.tasks[0].resources.cpu = 100
            tg.tasks[0].resources.memory_mb = 64
            ev = srv.submit_job(job)
            done = srv.wait_for_eval(ev.id, timeout=300.0)
            if done is None or done.status != "complete":
                raise RuntimeError(f"dryrun eval did not complete: {done}")
            allocs = srv.store.allocs_by_job("default", job.id)
            if len(allocs) != 2:
                raise RuntimeError(f"dryrun placed {len(allocs)} of 2")
            placed += len(allocs)
        coal = srv.coalescer
        if coal.dispatches == 0 or coal.n_device_shards != n_devices:
            raise RuntimeError(
                f"coalescer dispatched {coal.dispatches} times over "
                f"{coal.n_device_shards} shards, expected {n_devices}")
        print(f"dryrun_multichip live-server ok: {placed} allocs placed via "
              f"{coal.dispatches} sharded dispatches "
              f"(shards={coal.n_device_shards})", flush=True)
        return dict(mesh=mesh.shape, rows=rows.tolist(), placed=placed,
                    dispatches=coal.dispatches,
                    shards=coal.n_device_shards)
    finally:
        srv.shutdown()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m nomad_tpu_torch.entry")
    ap.add_argument("--dryrun", type=int, required=True, metavar="N",
                    help="run dryrun_multichip on an N-device mesh")
    ap.add_argument("--device", default="cuda",
                    help="the device the N virtual shards name")
    args = ap.parse_args(argv)
    dryrun_multichip(args.dryrun, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
