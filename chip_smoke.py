#!/usr/bin/env python3
"""Start the PyTorch/CUDA port (``nomad_tpu_torch``) on one card.

    python3 chip_smoke.py            # every phase, one CUDA device

Phases:

1. build — compile every hand-written kernel from ``nomad_tpu_torch/ops/
   csrc`` (one ``nvcc`` per source, in parallel) and print what ptxas
   reported, with the card's name and power limit.
2. kernels — on a 10,000-node cluster (capacity 10240, B=64 lanes, P=16
   placements) run each kernel and its plain PyTorch version on the same
   inputs on the card: a batch of the bench's eight job shapes, and a
   batch with preemption, static and dynamic ports, distinct_hosts, dead
   lanes, in-flight deltas and lanes that collide on a few nearly full
   nodes.  Rows, preemption flags, counters and the VERIFIED column must
   be equal; scores and binpack within rtol 1e-4, atol 1e-5.
3. solo — the stack's solo path (more than 32 plan deltas) at the same
   width: ``place_task_group``, which launches fused_place at B=1, over a
   dense usage with 40 plan deltas folded in by ``_dense_used0``, against
   the plain version on five lanes of the second batch, under the same
   contract.
3b. place_batch — K2, the staged dispatch: ``place_batch``
   (``fused_place.cu`` with every lane live, at full features as the
   staged path runs it) against ``place_batch_plain`` on both batches
   (the second's six dead lanes become padding lanes with all-False host
   masks), exactly, and equal to ``fused_place`` on every live lane; its
   CUDA-event and device time beside ``fused_place``'s at the same
   features, its plain time and its bound (``fused_place_work``).
3c. edge shapes — the cases of ``tests/torch_edge_cases.py`` built with
   the port on the card (300 nodes at capacity 333 and 11 lanes, B=1, ties
   across node tiles and cluster CTAs, spread tables with duplicate hashes
   and a free slot that the scan fills, s_width=2, lanes that fail at step
   0, distinct_hosts, preemption, a dead lane): ``fused_place`` at each
   case's own widths, ``place_batch`` at full widths and ``score_batch`` at
   both, each against its plain version under the full contract.  Then
   the three on both batches at 80,000 rows, where a lane's candidate
   state no longer fits its cluster's shared memory and ``fused_place``
   keeps it in device scratch (the phase fails if the launch shape says
   otherwise).  Each kernel's launch shape (cluster size, lanes per CTA or
   node span, node tile, dynamic shared memory, loop-width tier) is logged
   here and in the timing phases.  Then ``allocs_fit_verify`` on the
   event streams of ``VERIFY_CASES`` (the bench batch's sizes, one row
   every lane picks, B=64 with 1,024 delta rows a lane, B=1, every lane
   dead, order-sensitive values with rows out of range) against
   ``verify_lanes``, exactly, in both tiers of the kernel (event keys in
   shared memory, and in device scratch for the large case), and
   ``system_feasible`` at the node counts of ``SYSTEM_ROWS`` (1 to 80,000)
   on every constraint kind, all sixteen slots, a device ask, a static
   port and an escaped class, against its plain version, exactly.
4. system kernel — ``system_feasible`` against its plain version on the
   same cluster, over ten system-job requests (a static port some nodes
   hold, datacenter lists, numeric, version, presence and NaN-column
   constraints, a device ask, an escaped class and a host mask, a dense
   base usage with deltas of both signs, an ask that exhausts nodes):
   both rows of the (2, N) result must be equal.
5. server — a ``Server(device="cuda")`` with 32 workers and 64 lanes:
   register 10,000 nodes over four datacenters, pre-load usage, submit 64
   service jobs of count 2, wait until every eval is terminal, and check
   the 128 placements.  Every launch count is zeroed just before the jobs
   go in and read just after: both kernels must have launched, the plain
   version never.  Then, with the counts zeroed again, one distinct_hosts
   group of 56 whose plan outgrows 32 deltas: it must take the solo path,
   launch fused_place and never the plain version.  A burst of 64 jobs
   runs under the CUDA profiler and prints the card's busy and idle share
   and its device time by activity; each of its jobs must be placed in
   full.  Last, with the counts zeroed again,
   the system path: two system jobs (``node-exporter`` everywhere with
   static port 9100, ``log-shipper`` in dc1 off class-3) must hold one
   alloc on exactly the nodes their specs call for; 32 nodes join and get
   theirs; the smoke plays the client (pending allocs report running);
   16 nodes holding service allocs drain (service allocs re-place through
   fused_place, system allocs stop, each drain completes) and 16 others
   go down (their allocs are lost and the service ones replaced).
   ``system_feasible`` must have launched once per system eval and its
   plain version never.  Then the job lifecycle on the same server, the
   smoke playing the client and its health reports: a destructive
   rolling update (count 8, max_parallel 2) to successful, a canary
   placed alone and auto-promoted, a failing update auto-reverted, an
   interval periodic job's children, a dispatched parameterized job, a
   scale up and down within policy, and ``system_gc`` reaping a stopped
   job and 16 down nodes, whose freed matrix rows 16 new nodes take and
   the system jobs cover through ``system_feasible``.
5b. staged server — a second server built under ``NOMAD_TPU_MEGABATCH=0``
   over the same 10,000 nodes takes the same 64-job burst: exactly 128
   fitting allocs, counts zeroed just before, ``place_batch`` launched and
   neither fused kernel nor a plain version; its evals/s, applier
   refusals and retries are logged beside the fused burst's.
6. timing — each kernel and its plain version at the phase-2 shape (for
   ``system_feasible``, the node-exporter request at N=10240), timed with
   CUDA events (median of 20 launches after warm-up; fused_place's and
   allocs_fit_verify's plain versions the median of 3 runs), beside its
   bound: the larger of the bytes it must move over the card's memory
   rate and the float32 operations it needs over the card's float32
   rate, and its device time from the profiler.  Then the fused
   dispatch's device total (``fused_place`` + ``allocs_fit_verify``) and
   its CUDA-event time, ``allocs_fit_verify`` on the hot-row stream and
   in its device-scratch tier, and its wrapper's host time.
   ``system_feasible`` also gets the time of one whole system dispatch,
   and its wrapper's host time split into its parts beside the CUDA
   events' floor on an empty function.

7. batched scoring — ``score_batch`` (one launch scores every node for
   B independent evals and picks each one's best) on a fresh cluster
   built as phase 2's (10,000 nodes, 2M allocs' usage), at the bench's
   shapes: lane i the bench's job shape i mod 8, operands
   from ``parallel.build_batch_inputs``, features widened over the eight
   shapes.  Against the plain version (run in chunks of 256 lanes: its
   (B, N, V) intermediates are gigabytes each at B=4096) at B=4096 and
   B=256, on the feature batch's shapes at B=64 and full features with
   tg counts, penalties, class eligibility, host masks and spread tables
   that are not trivial, and through ``nomad_tpu_torch.entry.entry()``:
   rows, preemption flags and counters equal, scores and binpack within
   rtol 1e-4, atol 1e-5.  Then the main path, with every count zeroed
   just before and read just after: ``entry()``, 100 sync dispatches at
   B=4096 and at B=256 (each ending in a ``.cpu()`` of rows; median and
   p99) and 100 pipelined dispatches at B=4096, depth 8 (evals/s): the
   kernel must have launched once per dispatch and the plain version
   never.  Last, its CUDA-event time (median of 20), profiler device time,
   the plain version's time, the bound, and 20 sync dispatches under the
   profiler (busy share, kernel vs copy).
8. plan verify — ``verify_plan_fit`` on a seeded plan of 10,000 rows
   (padding, deltas past a node's room, negative deltas, ineligible
   nodes, a mixed eligible_required) and on each (rows, deltas,
   eligible_required) the applier checked for node-exporter in phase 5
   (recorded through ``server/plan_apply.py:host_verify``), launch counts
   zeroed around those calls; against its plain version and
   ``host_verify`` on every row (and the applier's own verdicts); every
   output byte 0 or 1; its times and bound at K=10,000.
9. restart — first a server without a ``data_dir`` registers 10,000
   ``server_node``s and takes a 64-job burst: the baseline of the
   journaled run.  Then a ``Server(device="cuda")`` with a ``data_dir`` in a
   temporary directory (the server phase's config: long heartbeat TTLs)
   journals 10,000 ``server_node``s, a 64-job burst, ``node-exporter``
   and a job whose eval blocks, and is crash-stopped (no snapshot).  A
   second server restores it from the write-ahead log: its tables
   (``to_snapshot_wire()``), latest index and matrix host arrays equal
   the first's, and its first sync is one full upload whose columns are
   bitwise equal to the first server's device columns.  With the counts
   zeroed it places 64 more count-2 jobs (exactly 128 fitting allocs),
   ``log-shipper`` on exactly its nodes and the restored blocked eval on
   a big node that registers, through ``fused_place``,
   ``allocs_fit_verify`` and ``system_feasible``, never a plain version.
   Its clean shutdown leaves a snapshot and an empty log; a third server
   restores from the snapshot alone to the same tables and arrays.  That
   image is installed into a running server whose 512-node matrix is
   already on the card (``Server.install_snapshot``: it steps down and
   its workers finish first): one full upload follows, the kernels' memoised
   column pointers are the new tensors', and a system job and a 64-job
   burst place on the installed nodes through the same kernels.  Logs
   the restore and install seconds, the full upload's bytes and time,
   the burst's evals/s with the WAL and without, events per topic and the
   observatory's and controller's states; removes the directory.
10. guarded and traced — a ``Server(device="cuda")`` with the server
   phase's config and ACLs on, over the 10,000 ``server_node``s: one
   bootstrap (a second raises), a policy granting ``submit-job`` in
   ``default`` and a token holding it, which may submit there and nowhere
   else (an empty and an unknown secret may not).  The 64 burst jobs and
   node-exporter, written in HCL and parsed by ``jobspec.parse_job``
   (each equal in ``job_to_api`` to the struct the server phase builds),
   submitted with the token: exactly 128 fitting allocs and node-exporter
   on exactly its nodes, through ``fused_place``, ``allocs_fit_verify``
   and ``system_feasible``, never a plain version (counts zeroed just
   before).  Every eval of the burst has one trace holding the service
   path's spans, each lane's device window holds a ``coalescer.launch``
   span, the registry the 13 ``nomad.phase.*`` timers and the health
   signals ``plan_queue_wait_p99_ms``; the Perfetto export (in a
   temporary directory, removed) covers the burst and ``obs.top``
   renders the breaker's row.  Bursts in the order A, B, B, A, A, B, B,
   A log the
   first-pass evals/s with tracing on and off, and with the resolver
   polling its ticket's event and waiting on a sacrificial thread.  Then the wedge
   drill, on a server whose breaker has a 200 ms deadline: spins on the
   card's stream (``torch.cuda._sleep``, calibrated with CUDA events)
   enqueued through ``run_device_op`` ahead of the next dispatch; one
   in the slow band gives a slow verdict whose placements are used, one
   of twice the wedge bound wedges a dispatch (its lanes fail with
   ``DeviceWedgedError``), trips the breaker, which refuses dispatches
   (their evals are nacked) until its canary closes it; every one of 16
   jobs is then placed in full, no plain version having run.  Logs the
   seconds from the spin to the trip, to the close and to the last
   placement, and how long an upload returns behind a spin from pageable
   and from page-locked memory.

Each phase logs its seconds.  Prints the kernel table as one JSON line
before the last, and ends with
``{"ok": true, "device": {...}}``.  Exits non-zero, printing no result,
when there is no CUDA device or when any phase fails.
"""

from __future__ import annotations

import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional

import numpy as np

N_NODES = 10_000
CAPACITY = 10_240
LANES = 64
SCAN = 16
JOB_SHAPES = 8
SERVER_JOBS = 64
SERVER_COUNT = 2
SERVER_WORKERS = 32
RTOL, ATOL = 1e-4, 1e-5
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_OPS_PER_S = 67e12  # H100 SXM, non-tensor float32
REPRESENTATIVES = 96  # distinct node shapes, replicated to N_NODES rows
SOLO_DELTAS = 40  # plan deltas of the solo case: more than MAX_DELTA_ROWS
# Feature-batch lanes the solo case replays: preemption, ports,
# distinct_hosts, targeted spread, rack spread.
SOLO_LANES = (0, 1, 2, 3, 6)
SOLO_COUNT = 56  # distinct_hosts group whose fourth chunk goes solo
DATACENTERS = ["dc1", "dc2", "dc3", "dc4"]
SYSTEM_PORT = 9100
SYSTEM_NEW_NODES = 32
SYSTEM_DRAINS = 16
SYSTEM_DOWNS = 16
LIFECYCLE_TIMEOUT_S = 300.0
# Batched scoring (bench.py's kernel phase: BATCH, INTERACTIVE_BATCH,
# DISPATCHES, PIPELINE_DEPTH).
SCORE_BATCH = 4096
INTERACTIVE_BATCH = 256
FEATURE_LANES = 64
DISPATCHES = 100
PIPELINE_DEPTH = 8
PIPE_DISPATCHES = 100
PLAIN_CHUNK = 256  # lanes per call of the plain version on the card
VERIFY_ROWS = 10_000  # plan rows of the seeded verify case
# fused_place's state past a cluster's shared memory (phase 3c).
LARGE_ROWS = 80_000
LARGE_LANES = 16


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else (
            f"nvidia-smi gave nothing (rc {out.returncode})"
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"


# ---------------------------------------------------------------------------
# Cluster and request batches (the bench's shapes, built with the port)
# ---------------------------------------------------------------------------


def build_cluster(n_nodes: int, capacity: int, device, seed: int = 42):
    """A bench-shaped cluster: datacenters dc1-4, six classes, 32 racks,
    seeded usage capped at 75% and spread over four priority buckets."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.state.matrix import (
        PRIORITY_BUCKETS, NodeMatrix, stable_hash,
    )

    rng = np.random.default_rng(seed)
    m = NodeMatrix(capacity=capacity, device=device)

    def sim_node(i: int):
        node = mock.node()
        node.datacenter = f"dc{i % 4 + 1}"
        node.node_class = f"class-{i % 6}"
        node.attributes = dict(node.attributes)
        node.attributes["rack"] = f"r{i % 32}"
        node.attributes["platform.tpu.type"] = "v5e" if i % 3 else "v5p"
        return node

    reps = min(REPRESENTATIVES, n_nodes)
    for i in range(reps):
        m.upsert_node(sim_node(i))
    host = m.snapshot_host()
    if n_nodes > reps:
        rows = np.arange(reps, n_nodes)
        src = rows % reps
        for key in host:
            host[key][rows] = host[key][src]
        ids = [f"sim-node-{int(r)}" for r in rows]
        id_hash = np.fromiter((stable_hash(s) for s in ids), np.int32, len(ids))
        for attr in ("node.unique.name", "node.unique.id"):
            slot = m.attrs.lookup(attr)
            if slot is not None:
                host["attr_hash"][rows, slot] = id_hash
        for r, node_id in zip(rows, ids):
            m.row_of[node_id] = int(r)
            m.node_of[int(r)] = node_id
        m._next_row = n_nodes
    per_node = 2_000_000 / n_nodes
    usage = rng.poisson(per_node, n_nodes)[:, None] * np.array(
        [[100.0, 128.0, 30.0]]
    ) * rng.uniform(0.05, 0.12, (n_nodes, 1))
    usage = np.round(np.minimum(usage, host["totals"][:n_nodes] * 0.75))
    host["used"][:n_nodes] = usage
    shares = rng.dirichlet(np.ones(4), n_nodes)
    for j, b in enumerate(rng.choice(PRIORITY_BUCKETS, 4, replace=False)):
        host["prio_used"][:n_nodes, b] = np.round(usage * shares[:, j:j + 1])
    # A few occupied static ports.
    host["port_words"][: n_nodes: 7, 8080 >> 5] |= np.uint32(1 << (8080 & 31))
    host["port_words"][3: n_nodes: 13, SYSTEM_PORT >> 5] |= np.uint32(
        1 << (SYSTEM_PORT & 31))
    # Two GPUs on every fifth node, one of them in use on every tenth.
    gpu = m.devices.register("gpu")
    host["dev_total"][: n_nodes: 5, gpu] = 2
    host["dev_used"][: n_nodes: 10, gpu] = 1
    m._dirty.update(range(n_nodes))
    m.version += 1
    return m


def bench_jobs():
    """The bench's eight job shapes: plain, affinity, spread, constraint."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.structs.types import Affinity, Constraint, Op, Spread

    jobs = []
    for i in range(JOB_SHAPES):
        job = mock.job()
        tg = job.task_groups[0]
        tg.tasks[0].resources.cpu = 100 + 50 * (i % 4)
        tg.tasks[0].resources.memory_mb = 128 + 64 * (i % 3)
        if i % 4 == 1:
            tg.affinities = [Affinity(
                l_target="${attr.platform.tpu.type}", r_target="v5e",
                operand=Op.EQ.value, weight=50)]
        if i % 4 == 2:
            tg.spreads = [Spread(attribute="${attr.rack}", weight=50)]
        if i % 4 == 3:
            tg.constraints = [Constraint(
                l_target="${attr.kernel.name}", r_target="linux",
                operand=Op.EQ.value)]
        jobs.append((job, False))
    return jobs


def feature_jobs():
    """Preemption, static and dynamic ports, distinct_hosts, a targeted
    spread and a version constraint."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.structs.types import (
        Constraint, NetworkResource, Spread, SpreadTarget,
    )

    out = []
    j = mock.job(priority=90)
    j.task_groups[0].tasks[0].resources.cpu = 3000
    j.task_groups[0].tasks[0].resources.memory_mb = 6000
    out.append((j, True))
    j = mock.job()
    j.task_groups[0].tasks[0].resources.networks = [NetworkResource(
        reserved_ports=[8080], dynamic_ports=["http", "admin"])]
    out.append((j, False))
    j = mock.job()
    j.task_groups[0].constraints = [Constraint(operand="distinct_hosts")]
    out.append((j, False))
    j = mock.job()
    j.task_groups[0].spreads = [Spread(
        attribute="${node.datacenter}", weight=60,
        targets=[SpreadTarget(value="dc1", percent=70),
                 SpreadTarget(value="dc2", percent=20)])]
    j.task_groups[0].constraints = [Constraint(
        l_target="${attr.os.name}", operand="!=", r_target="windows")]
    out.append((j, False))
    return out


class Batch:
    """One dispatch's operands, as numpy and as tensors on a device."""

    def __init__(self, arrays, np_ops, device):
        import torch

        from nomad_tpu_torch.ops import kernels as k

        self.arrays = arrays
        self.np = np_ops
        ri, rf = k.pack_requests(np_ops["reqs"])
        t = {name: torch.from_numpy(np.ascontiguousarray(v)).to(device)
             for name, v in np_ops.items() if name != "reqs"}
        t["req_i"] = torch.from_numpy(ri).to(device)
        t["req_f"] = torch.from_numpy(rf).to(device)
        self.t = t
        self.features = k.features_of(np_ops["reqs"])

    def args(self):
        t = self.t
        return (self.arrays, self.arrays.used, t["delta_rows"],
                t["delta_vals"], t["tg_counts"], t["spread_counts"],
                t["penalties"], t["req_i"], t["req_f"], t["class_eligs"],
                t["host_masks"], t["lane_mask"])


def make_batches(m, device, lanes: int = LANES, seed: int = 3):
    """(plain batch, feature batch) at the main path's shape."""
    from nomad_tpu_torch.ops.encode import (
        MAX_SPREAD_VALUES, MAX_SPREADS, RequestEncoder, pow2_bucket,
    )
    from nomad_tpu_torch.scheduler.coalescer import MAX_DELTA_ROWS

    rng = np.random.default_rng(seed)
    enc = RequestEncoder(m)
    arrays = m.sync(device)
    n = int(arrays.used.shape[0])
    n_cls = pow2_bucket(max(1, len(m.class_ids)))

    def operands(compiled):
        b = len(compiled)
        reqs = [c.request for c in compiled]
        stacked = type(reqs[0])(*[np.stack(f) for f in zip(*reqs)])
        return {
            "reqs": stacked,
            "delta_rows": np.full((b, MAX_DELTA_ROWS), -1, np.int32),
            "delta_vals": np.zeros((b, MAX_DELTA_ROWS, 3), np.float32),
            "tg_counts": np.zeros((b, n), np.int32),
            "spread_counts": np.zeros((b, MAX_SPREADS, MAX_SPREAD_VALUES),
                                      np.float32),
            "penalties": np.zeros((b, n), bool),
            "class_eligs": np.ones((b, n_cls), bool),
            "host_masks": np.ones((b, n), bool),
            "lane_mask": np.ones((b,), bool),
        }

    shapes = bench_jobs()
    plain = [enc.compile(j, j.task_groups[0]) for j, _ in
             (shapes[i % len(shapes)] for i in range(lanes))]
    ops1 = operands(plain)

    mix = feature_jobs() + shapes
    comp2 = []
    for i in range(lanes):
        j, pre = mix[i % len(mix)]
        comp2.append(enc.compile(j, j.task_groups[0],
                                 preemption_enabled=pre))
    ops2 = operands(comp2)
    # Dead lanes.
    ops2["lane_mask"][lanes - 6:] = False
    ops2["host_masks"][lanes - 6:] = False
    # In-flight deltas, some on duplicate rows.
    for lane in range(0, lanes, 5):
        k = int(rng.integers(1, 8))
        rows = rng.integers(0, min(n, 64), k)
        rows[-1] = rows[0]
        ops2["delta_rows"][lane, :k] = rows
        ops2["delta_vals"][lane, :k] = rng.integers(50, 400, (k, 3))
    # Collisions: lanes restricted to three nearly full nodes.
    host = m.snapshot_host()
    hot = np.array([11, 12, 13])
    collide = list(range(lanes // 2, min(lanes // 2 + 12, lanes - 6)))
    for lane in collide:
        ops2["host_masks"][lane] = False
        ops2["host_masks"][lane, hot] = True
    ask_max = max(float(np.asarray(comp2[l].request.ask)[0]) for l in collide)
    with m._host_lock:
        for r in hot:
            host["used"][r] = host["totals"][r] - np.float32(1.5 * ask_max)
            m._mark_dirty_locked(int(r))
    # Existing allocs of the lane's own job (anti-affinity) and penalties.
    ops2["tg_counts"][::3, 100:140] = 1
    ops2["penalties"][1::4, 200:260] = True
    # Re-sync after the collision rows changed, then rebuild both batches on
    # the fresh snapshot.
    arrays = m.sync(device)
    return Batch(arrays, ops1, device), Batch(arrays, ops2, device)


# ---------------------------------------------------------------------------
# Comparison and bounds
# ---------------------------------------------------------------------------


def compare(got, want, width: int):
    """(ok, max_abs_err, message) under the parity contract."""
    got = np.asarray(got)
    want = np.asarray(want)
    if got.shape != want.shape:
        return False, float("inf"), f"shape {got.shape} != {want.shape}"
    exact = [0, 3, 4, 5, 6] + ([7] if width == 8 else [])
    bad = np.argwhere(np.any(got[..., exact] != want[..., exact], axis=-1))
    err = float(np.max(np.abs(got[..., 1:3] - want[..., 1:3]))) if got.size else 0.0
    close = np.allclose(got[..., 1:3], want[..., 1:3], rtol=RTOL, atol=ATOL)
    if len(bad):
        lane, step = bad[0]
        return False, err, (
            f"{len(bad)} lane-steps differ in exact columns; first lane "
            f"{lane} step {step}: kernel {got[lane, step].tolist()} plain "
            f"{want[lane, step].tolist()}"
        )
    if not close:
        return False, err, f"scores/binpack outside rtol {RTOL} atol {ATOL}"
    return True, err, "ok"


# Float32 operations of the fused_place kernel body (csrc/fused_place.cu)
# for one node, by term.  Only float arithmetic and float compares count:
# the integer compares, selects and bit tests (hash predicates, device and
# port checks, class eligibility, masks) have no rate in the card's
# published table, and leaving them out keeps the bound a lower bound.
FIT_OPS = 24  # u + ask (3), fits (3), 1 - u/max(t, 1) (6), exp2 args (2),
#               exp2f (2), sum (1), two clamps (6), x (1/18) (1)
ANTI_AFFINITY_OPS = 4  # coll > 0, coll + 1, negate, / desired_count
NUMERIC_PREDICATE_OPS = 3  # v < want, v > want, v == want
AFFINITY_SLOT_OPS = 2  # match x weight, running sum
AFFINITY_TAIL_OPS = 4  # total != 0, wsum > 0, max(wsum, 1e-9), divide
SPREAD_VALUE_OPS = 2  # isnan(desired), desired sum, per value table entry
SPREAD_STEP_OPS = 6  # even or targeted score of the node's count, sum
PREEMPT_BUCKET_OPS = 10  # three prefix sums, three presence compares,
#                          the bucket midpoint (add, mul), max, sum
PREEMPT_TAIL_OPS = 18  # usable (3), fits without victims (6), net (4),
#                        logistic (5)
COMBINE_OPS = 11  # five component adds, five count adds, total / count


def _is_numeric(op: int) -> bool:
    return 2 <= op <= 5 or op >= 8


class LaneTerms:
    """What one lane's request makes a kernel read and compute: the
    attribute slots it refers to (hash, numeric, version), the port words
    of its static ports, its numeric constraint count, and its float32
    operations for a scored node, for the winner row, and per node and
    step (the spread term and the argmax compare)."""

    def __init__(self, reqs, lane: int, f):
        from nomad_tpu_torch.ops.encode import MAX_SPREAD_VALUES
        from nomad_tpu_torch.state.matrix import PRIORITY_BUCKETS

        self.slots, self.num_slots, self.ver_slots = set(), set(), set()
        self.words = set()
        c_slot, c_op = reqs.c_slot[lane], reqs.c_op[lane]
        a_slot, a_op = reqs.a_slot[lane], reqs.a_op[lane]
        s_slot = reqs.s_slot[lane]
        if int(reqs.dc_hash[lane][0]) != -1:
            self.slots.add(0)
        for slot, op in list(zip(c_slot, c_op))[:f.c_width] + list(
                zip(a_slot, a_op))[:f.a_width]:
            if slot < 0:
                continue
            self.slots.add(int(slot))
            if 2 <= op <= 5:
                self.num_slots.add(int(slot))
            elif op >= 8:
                self.ver_slots.add(int(slot))
        live_s = [int(s) for s in s_slot[:f.s_width] if s >= 0]
        self.slots.update(live_s)
        if f.ports:
            self.words.update(int(p) >> 5 for p in reqs.p_static[lane]
                              if p >= 0)
        kb = int(np.clip(reqs.preempt_bucket[lane], 0, PRIORITY_BUCKETS))
        pre = f.preempt and int(reqs.preempt_bucket[lane]) >= 0

        self.c_num = sum(_is_numeric(int(o)) for s, o in zip(
            c_slot[:f.c_width], c_op[:f.c_width]) if s >= 0)
        a_live = [(s, o) for s, o in zip(a_slot[:f.a_width], a_op[:f.a_width])
                  if s >= 0]
        self.winner = (FIT_OPS + ANTI_AFFINITY_OPS + COMBINE_OPS
                       + (PREEMPT_TAIL_OPS if pre else 0))
        self.scored = (self.winner + (PREEMPT_BUCKET_OPS * kb if pre else 0)
                       + sum(AFFINITY_SLOT_OPS
                             + NUMERIC_PREDICATE_OPS * _is_numeric(int(o))
                             for _, o in a_live)
                       + (AFFINITY_TAIL_OPS if a_live else 0)
                       + SPREAD_VALUE_OPS * MAX_SPREAD_VALUES * len(live_s))
        self.step = 1 + (SPREAD_STEP_OPS * len(live_s) + 3 if live_s else 0)


def matrix_bytes(n: int, reqs, live, f, terms) -> int:
    """Bytes of the matrix columns that the live lanes' ``terms`` refer
    to, each read once over ``n`` rows."""
    from nomad_tpu_torch.state.matrix import PRIORITY_BUCKETS

    slots = set().union(*(t.slots for t in terms))
    num_slots = set().union(*(t.num_slots for t in terms))
    ver_slots = set().union(*(t.ver_slots for t in terms))
    words = set().union(*(t.words for t in terms))
    return n * (
        12 + 12 + 1 + 4  # totals, used, eligible, class_id
        + 4 * len(slots) + 4 * len(num_slots) + 4 * len(ver_slots)
        + (64 if np.any(np.asarray(reqs.dev_ask)[live] > 0) else 0)
        + (4 + 4 * len(words) if f.ports else 0)  # dyn_used, port words
        + (PRIORITY_BUCKETS * 12 if f.preempt else 0)  # prio_used
    )


def fused_place_work(batch: Batch, packed, n_placements: int):
    """(bytes, float32 ops) the fused_place function needs on this batch.

    Bytes: each input read once — matrix columns only where a live lane
    refers to them, the per-lane arrays of live lanes — and the output
    written once.  Operations: what the data needs, not what the kernel
    does.  The numeric constraint predicates are counted once per
    (lane, node).  The other step-invariant terms (fit and binpack,
    preemption state, anti-affinity, affinity, the spread targets, the sum
    of the components) are counted once per (lane, feasible node): a node
    that fails feasibility needs no score.  Each step adds only what the
    carry changes: the spread term of every feasible node and its sum into
    the score, the argmax compare, and the winner row's fit,
    anti-affinity, preemption and score redone.  A lane runs steps until
    its first failed one (the kernel stops there); ``packed`` gives the
    steps and each step's feasible-node count."""
    from nomad_tpu_torch.ops import kernels as k

    arrays, f, reqs = batch.arrays, batch.features, batch.np["reqs"]
    n = int(arrays.used.shape[0])
    live = np.asarray(batch.np["lane_mask"], bool)
    out = np.asarray(packed.cpu())
    rows = out[..., k.PACKED_ROW]
    evaluated = out[..., k.PACKED_EVALUATED].astype(np.int64)

    terms = []
    ops = 0
    for lane in np.flatnonzero(live):
        t = LaneTerms(reqs, lane, f)
        terms.append(t)
        failed = np.flatnonzero(rows[lane, :n_placements] < 0)
        steps = int(failed[0]) + 1 if len(failed) else n_placements
        deltas = int((batch.np["delta_rows"][lane] >= 0).sum())
        ops += (n * NUMERIC_PREDICATE_OPS * t.c_num
                + int(evaluated[lane, 0]) * t.scored
                + int(evaluated[lane, :steps].sum()) * t.step
                + steps * t.winner + 3 * deltas)

    b_live = int(live.sum())
    lane_bytes = b_live * sum(
        v[0].nbytes for name, v in batch.np.items()
        if name not in ("reqs", "lane_mask"))
    lane_bytes += live.nbytes + b_live * (
        batch.t["req_i"][0].numel() + batch.t["req_f"][0].numel()) * 4
    out_bytes = live.shape[0] * n_placements * k.PACKED_WIDTH * 4
    return matrix_bytes(n, reqs, live, f, terms) + lane_bytes + out_bytes, ops


def score_batch_work(arrays, reqs, f, args, packed):
    """(bytes, float32 ops) the score_batch function needs on these
    inputs.  Bytes: the matrix columns the lanes refer to, once; every
    per-lane operand (``args[2:]``: tg counts, spread counts, penalties,
    the packed request, class eligibility, host masks) once; the (B, 7)
    output once.  Operations, as ``fused_place_work`` counts them for one
    step: the numeric constraint predicates on every (lane, node), and
    on every (lane, feasible node) the score terms, the spread term and
    the argmax compare (``packed`` gives each lane's feasible count)."""
    from nomad_tpu_torch.ops import kernels as k

    n = int(arrays.used.shape[0])
    out = np.asarray(packed.cpu())
    evaluated = out[:, k.PACKED_EVALUATED].astype(np.int64)
    b = out.shape[0]
    live = np.ones((b,), bool)
    terms = []
    ops = 0
    for lane in range(b):
        t = LaneTerms(reqs, lane, f)
        terms.append(t)
        ops += (n * NUMERIC_PREDICATE_OPS * t.c_num
                + int(evaluated[lane]) * (t.scored + t.step))
    lane_bytes = sum(a.numel() * a.element_size() for a in args[2:])
    out_bytes = b * k.PACKED_WIDTH * 4
    return matrix_bytes(n, reqs, live, f, terms) + lane_bytes + out_bytes, ops


def verify_work(batch: Batch, packed, n_placements: int):
    """(bytes, float32 ops) of the cross-lane AllocsFit scan: the rows the
    live lanes' deltas and placements touch (totals and used, 12 bytes
    each), the live lanes' deltas and asks, the packed columns in and out;
    three adds per delta, three adds and three compares per placement."""
    from nomad_tpu_torch.ops import kernels as k

    live = np.asarray(batch.np["lane_mask"], bool)
    b = live.shape[0]
    rows = np.asarray(packed.cpu())[..., k.PACKED_ROW][live]
    drows = batch.np["delta_rows"][live]
    touched = np.union1d(rows[rows >= 0], drows[drows >= 0])
    n_deltas = int((drows >= 0).sum())
    n_placed = int((rows >= 0).sum())
    nbytes = (len(touched) * 12 * 2
              + b * n_placements * (k.PACKED_WIDTH + k.FUSED_PACKED_WIDTH) * 4
              + int(live.sum()) * (3 * 4 + drows.shape[1] * 16) + b)
    ops = 3 * n_deltas + 6 * n_placed
    return nbytes, ops


def system_feasible_work(arrays, req, n_classes: int):
    """(bytes, float32 ops) the system_feasible function needs for one
    request.  Every row needs its eligible bit, host-mask byte, totals,
    base usage and two output bytes; only an eligible row needs the rest
    of the feasibility columns the request refers to (class id, the
    attribute columns of its datacenter list and constraints, the asked
    device slots, ``dyn_used`` and the port words of its static ports).
    Operations: the fit's three adds and three compares on every row, and
    three float compares per numeric or version constraint on each
    eligible row; integer work has no rate in the card's table."""
    from nomad_tpu_torch.ops import kernels as k

    n = int(arrays.used.shape[0])
    n_elig = int(arrays.eligible.sum())
    hash_slots, num_slots, ver_slots = set(), set(), set()
    if int(req.dc_hash[0]) != -1:
        hash_slots.add(0)
    n_numeric = 0
    for slot, op in zip(req.c_slot, req.c_op):
        if slot < 0:
            continue
        hash_slots.add(int(slot))
        if 2 <= op <= 5:
            num_slots.add(int(slot))
        elif op >= 8:
            ver_slots.add(int(slot))
        n_numeric += _is_numeric(int(op))
    words = {int(p) >> 5 for p in req.p_static if p >= 0}
    per_row = 1 + 1 + 12 + 12 + 2
    per_elig = (4 + 4 * (len(hash_slots) + len(num_slots) + len(ver_slots))
                + 8 * int((np.asarray(req.dev_ask) > 0).sum())
                + 4 + 4 * len(words))
    req_bytes = (k.REQ_INT_WIDTH + k.REQ_FLOAT_WIDTH) * 4
    nbytes = n * per_row + n_elig * per_elig + n_classes + req_bytes
    ops = 6 * n + 3 * n_numeric * n_elig
    return nbytes, ops


def bound(nbytes: float, ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_cuda(fn, runs: int, warmup: int = 2) -> float:
    """Median milliseconds of ``fn`` over ``runs`` launches, CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
            enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def phase_build(card: str) -> float:
    from nomad_tpu_torch.ops import build

    secs = build.build_all()
    log(f"build: {len(build.KERNELS)} kernels in {secs:.3f} s "
        f"(card: {card})")
    for name, report in build.ptxas_report.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"  ptxas {name}: {line.strip()}")
    return secs


def _sync() -> None:
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()


def phase_kernels(batches, results: dict) -> None:
    from nomad_tpu_torch.ops import kernels as k

    for label, batch in zip(("bench-shapes", "features"), batches):
        args = batch.args()
        kern = k.fused_place(*args, SCAN, batch.features)
        plain = k.place_lanes(*args, SCAN, batch.features)
        _sync()
        ok, err, msg = compare(kern.cpu(), plain.cpu(), k.PACKED_WIDTH)
        r = results.setdefault("fused_place", {"max_abs_err": 0.0})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        log(f"kernels[{label}] fused_place vs plain: {msg} "
            f"(max |err| {err:.3g})")
        if not ok:
            raise AssertionError(f"fused_place disagrees on {label}: {msg}")

        t = batch.t
        vk = k.allocs_fit_verify(batch.arrays.totals, batch.arrays.used, kern,
                                 t["req_f"], t["delta_rows"],
                                 t["delta_vals"], t["lane_mask"])
        vp = k.verify_lanes(batch.arrays.totals, batch.arrays.used, kern,
                            t["req_f"], t["delta_rows"], t["delta_vals"],
                            t["lane_mask"])
        _sync()
        ok, err, msg = compare(vk.cpu(), vp.cpu(), k.FUSED_PACKED_WIDTH)
        r = results.setdefault("allocs_fit_verify", {"max_abs_err": 0.0})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        verified = vk.cpu().numpy()[..., k.FUSED_PACKED_VERIFIED]
        rows = vk.cpu().numpy()[..., k.PACKED_ROW]
        zeros = int(((verified == 0.0) & (rows >= 0)).sum())
        log(f"kernels[{label}] allocs_fit_verify vs plain: {msg}; "
            f"VERIFIED 0.0 on {zeros} placements")
        if not ok:
            raise AssertionError(f"allocs_fit_verify disagrees on {label}: {msg}")
        if label == "features" and zeros == 0:
            raise AssertionError("collision batch produced no VERIFIED 0.0")
        placed = int((rows >= 0).sum())
        if placed == 0:
            raise AssertionError(f"{label}: nothing placed")
        # The whole fused entry against the whole plain version.
        full_k = k.fused_place_batch(*args, SCAN, batch.features)
        full_p = k.verify_lanes(
            batch.arrays.totals, batch.arrays.used,
            k.place_lanes(*args, SCAN, batch.features), t["req_f"],
            t["delta_rows"], t["delta_vals"], t["lane_mask"])
        ok, err, msg = compare(full_k.cpu(), full_p.cpu(), k.FUSED_PACKED_WIDTH)
        log(f"kernels[{label}] fused_place_batch vs plain: {msg}; "
            f"{placed} placements")
        if not ok:
            raise AssertionError(f"fused_place_batch disagrees on {label}: {msg}")
    for name in ("fused_place", "allocs_fit_verify"):
        results[name]["matches_plain"] = True


def phase_solo(batch: Batch, results: dict) -> None:
    """The stack's solo path at the main path's width: ``place_task_group``
    (fused_place at B=1) over the dense usage ``_dense_used0`` folds
    SOLO_DELTAS plan deltas into, against the plain version on the same
    inputs, lane by lane, under the full contract."""
    import torch

    from nomad_tpu_torch.ops import kernels as k
    from nomad_tpu_torch.ops.encode import SchedRequest
    from nomad_tpu_torch.scheduler.coalescer import MAX_DELTA_ROWS
    from nomad_tpu_torch.scheduler.stack import _dense_used0

    rng = np.random.default_rng(11)
    arrays, t, reqs = batch.arrays, batch.t, batch.np["reqs"]
    dev = arrays.used.device
    # Half the deltas on rows the batch picks first, so they move the
    # picks; the rest on random rows.
    picked = k.fused_place(*batch.args(), SCAN, batch.features).cpu().numpy()
    picked = picked[..., k.PACKED_ROW]
    hot = np.unique(picked[picked >= 0].astype(np.int64))[: SOLO_DELTAS // 2]
    nodes = np.flatnonzero(arrays.eligible.cpu().numpy())
    rest = rng.choice(np.setdiff1d(nodes, hot),
                      SOLO_DELTAS - len(hot), replace=False)
    deltas = {int(r): rng.integers(50, 400, 3).astype(np.float32)
              for r in np.concatenate([hot, rest])}
    if len(deltas) <= MAX_DELTA_ROWS:
        raise AssertionError(f"solo case has only {len(deltas)} deltas")
    used0 = _dense_used0(arrays, deltas)
    want0 = arrays.used.cpu().clone()
    for r, d in deltas.items():
        want0[r] += torch.from_numpy(d)
    if not torch.equal(used0.cpu(), want0):
        raise AssertionError("_dense_used0 differs from the row-by-row sum")

    err_max = 0.0
    for lane in SOLO_LANES:
        req = SchedRequest(*[np.asarray(f)[lane] for f in reqs])
        res = k.place_task_group(
            arrays, req, used0, t["tg_counts"][lane], t["spread_counts"][lane],
            t["penalties"][lane], t["class_eligs"][lane], t["host_masks"][lane],
            SCAN, batch.features)
        got = np.stack([res.rows, res.scores, res.binpack, res.preempted,
                        res.nodes_evaluated, res.nodes_filtered,
                        res.nodes_exhausted], axis=-1).astype(np.float32)[None]
        ri, rf = k.pack_requests(
            SchedRequest(*[np.asarray(f)[None] for f in req]))
        one = slice(lane, lane + 1)
        want = k.place_lanes(
            arrays, used0, torch.full((1, 1), -1, dtype=torch.int32, device=dev),
            torch.zeros((1, 1, 3), dtype=torch.float32, device=dev),
            t["tg_counts"][one], t["spread_counts"][one], t["penalties"][one],
            torch.from_numpy(ri).to(dev), torch.from_numpy(rf).to(dev),
            t["class_eligs"][one], t["host_masks"][one],
            torch.ones((1,), dtype=torch.bool, device=dev), SCAN,
            batch.features)
        ok, err, msg = compare(got, want.cpu(), k.PACKED_WIDTH)
        err_max = max(err_max, err)
        placed = int((res.rows >= 0).sum())
        log(f"kernels[solo lane {lane}] place_task_group vs plain over "
            f"{len(deltas)} deltas: {msg}; {placed} placements")
        if not ok:
            raise AssertionError(f"solo lane {lane} disagrees: {msg}")
        if placed == 0:
            raise AssertionError(f"solo lane {lane}: nothing placed")
    r = results["fused_place"]
    r["max_abs_err"] = max(r["max_abs_err"], err_max)


def phase_place_batch(batches, card: str, results: dict) -> None:
    """K2, the staged dispatch: ``place_batch`` (``fused_place.cu`` with
    every lane live, at full features as the staged path runs it) against
    ``place_batch_plain`` on both batches, under the full contract; the
    feature batch's last six lanes are padding (all-False host masks).  On
    live lanes it must also equal ``fused_place``'s output exactly.  Then,
    on the bench batch: its CUDA-event time, device time (profiler), plain
    time and bound, beside ``fused_place``'s at the same features."""
    from nomad_tpu_torch.ops import kernels as k

    full = k.FULL_FEATURES
    r = results.setdefault("place_batch", {"max_abs_err": 0.0})
    for label, batch in zip(("bench-shapes", "features"), batches):
        args = batch.args()[:-1]
        kern = k.place_batch(*args, SCAN)
        plain = k.place_batch_plain(*args, SCAN)
        fused = k.fused_place(*batch.args(), SCAN, full)
        _sync()
        ok, err, msg = compare(kern.cpu(), plain.cpu(), k.PACKED_WIDTH)
        r["max_abs_err"] = max(r["max_abs_err"], err)
        live = batch.np["lane_mask"]
        pad = ~batch.np["host_masks"].any(axis=1)
        got = kern.cpu().numpy()
        same_live = np.array_equal(got[live], fused.cpu().numpy()[live])
        pad_rows = got[pad][..., k.PACKED_ROW]
        log(f"kernels[{label}] place_batch vs plain: {msg} (max |err| "
            f"{err:.3g}); {int((got[..., k.PACKED_ROW] >= 0).sum())} "
            f"placements; live lanes equal fused_place: {same_live}; "
            f"{int(pad.sum())} pad lanes")
        if not ok:
            raise AssertionError(f"place_batch disagrees on {label}: {msg}")
        if not same_live or (pad_rows != -1).any():
            raise AssertionError(f"place_batch on {label}: live lanes differ "
                                 "from fused_place or a pad lane placed")
    r["matches_plain"] = True

    batch = batches[0]
    args = batch.args()[:-1]
    packed = k.place_batch(*args, SCAN)

    def run():
        k.place_batch(*args, SCAN)

    def run_plain():
        k.place_batch_plain(*args, SCAN)

    def run_fused():
        k.fused_place(*batch.args(), SCAN, full)

    ms = time_cuda(run, runs=20)
    fused_ms = time_cuda(run_fused, runs=20)
    dev_us = device_us_per_launch(run, "fused_place_kernel")
    fused_us = device_us_per_launch(run_fused, "fused_place_kernel")
    plain_ms = time_cuda(run_plain, runs=3, warmup=1)
    # The same function of the same inputs as fused_place's (the wider
    # loops of full features add no work these lanes need).
    work = fused_place_work(batch, packed, SCAN)
    b_ms, by = bound(*work)
    r.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
             library_ms=None, device_us=dev_us)
    shape = k.fused_place_shape(int(batch.arrays.used.shape[0]), LANES,
                                batch.t["delta_rows"].shape[1], SCAN, full)
    r["launch"] = shape
    log(f"timing place_batch: {ms:.4f} ms by CUDA events, {fmt_us(dev_us)} "
        f"a launch on the device (profiler); fused_place at the same full "
        f"features {fused_ms:.4f} ms, {fmt_us(fused_us)}; plain version "
        f"{plain_ms:.3f} ms; bound {b_ms:.5f} ms by {by}; {work[0]} bytes, "
        f"{work[1]:.4g} ops; launch {shape} (card: {card})")


def edge_cases_module():
    """``tests/torch_edge_cases.py``: the edge shapes the CPU parity tests
    and the card tests share (it imports neither package itself)."""
    here = str(Path(__file__).resolve().parent / "tests")
    if here not in sys.path:
        sys.path.insert(0, here)
    import torch_edge_cases

    return torch_edge_cases


def edge_case(case):
    """Case ``case`` of ``tests/torch_edge_cases.py``, built with the port
    on the card: (arrays, numpy inputs, tensors on the card)."""
    import torch

    from nomad_tpu_torch.ops import kernels as k

    edge = edge_cases_module()

    w = edge.build(edge.port_pkg(), case)
    arrays = w["m"].sync("cuda")
    ri, rf = k.pack_requests(w["reqs"])
    t = {name: torch.from_numpy(np.ascontiguousarray(w[name])).to("cuda")
         for name in ("drows", "dvals", "tg", "counts", "pen", "ce", "hm",
                      "lane_mask")}
    t["ri"] = torch.from_numpy(ri).to("cuda")
    t["rf"] = torch.from_numpy(rf).to("cuda")
    return arrays, w, t


def phase_edge_shapes(results: dict) -> None:
    """The redesigned kernels on the edge shapes the tiling and the hoisted
    scan make risky (ragged node and lane counts, B=1, ties across node
    tiles and cluster CTAs, spread tables with duplicate hashes filled
    mid-scan, s_width=2, lanes that fail at step 0): fused_place at the
    case's own widths, place_batch at full widths and score_batch at both,
    each against its plain version under the full contract, with the
    launch shape each took."""
    from nomad_tpu_torch.ops import kernels as k

    edge = edge_cases_module()

    for case in edge.CASES:
        arrays, w, t = edge_case(case)
        n, b = int(arrays.used.shape[0]), int(t["ri"].shape[0])
        own = k.features_of(w["reqs"])
        args = (arrays, arrays.used, t["drows"], t["dvals"], t["tg"],
                t["counts"], t["pen"], t["ri"], t["rf"], t["ce"], t["hm"])
        checks = (
            ("fused_place", own, k.fused_place(*args, t["lane_mask"],
                                               w["scan"], own),
             k.place_lanes(*args, t["lane_mask"], w["scan"], own),
             k.fused_place_shape(n, b, w["drows"].shape[1], w["scan"], own)),
            ("place_batch", k.FULL_FEATURES, k.place_batch(*args, w["scan"]),
             k.place_batch_plain(*args, w["scan"]),
             k.fused_place_shape(n, b, w["drows"].shape[1], w["scan"],
                                 k.FULL_FEATURES)),
        )
        sb = (arrays, arrays.used, t["tg"], t["counts"], t["pen"], t["ri"],
              t["rf"], t["ce"], t["hm"])
        for f in (own, k.FULL_FEATURES):
            checks += (("score_batch", f,
                        k.pack_batch_result(k.score_batch(*sb, f))[:, None],
                        k.pack_batch_result(k.score_batch_plain(*sb, f))[:, None],
                        k.score_batch_shape(n, b, f)),)
        _sync()
        for name, f, got, want, shape in checks:
            ok, err, msg = compare(got.cpu(), want.cpu(), k.PACKED_WIDTH)
            r = results.setdefault(name, {"max_abs_err": 0.0})
            r["max_abs_err"] = max(r["max_abs_err"], err)
            log(f"edge[{case}] {name} at {tuple(f)} vs plain: {msg} (max "
                f"|err| {err:.3g}); N={n}, B={b}; launch {shape}")
            if not ok:
                raise AssertionError(f"{name} disagrees on edge case {case}: "
                                     f"{msg}")
    check_past_shared_memory(results)
    check_verify_cases(results)
    check_system_rows(results)


def verify_operands(case: str):
    """Case ``case`` of ``torch_edge_cases.VERIFY_CASES`` as the seven
    operands of ``allocs_fit_verify`` on the card."""
    import torch

    from nomad_tpu_torch.ops import kernels as k

    w = edge_cases_module().verify_case(case)
    b = w["asks"].shape[0]
    req_f = np.zeros((b, k.REQ_FLOAT_WIDTH), np.float32)
    off = k.REQ_FLOAT_OFF["ask"][0]
    req_f[:, off:off + 3] = w["asks"]
    return tuple(torch.from_numpy(np.ascontiguousarray(x)).to("cuda")
                 for x in (w["totals"], w["used"], w["packed"], req_f,
                           w["drows"], w["dvals"], w["lane_mask"]))


def check_verify_cases(results: dict) -> None:
    """``allocs_fit_verify`` on the event streams of
    ``torch_edge_cases.VERIFY_CASES`` (the bench batch's sizes, one hot row
    picked by every lane, B=64 with 1,024 delta rows a lane, B=1, every
    lane dead, order-sensitive values with rows out of range): every
    column exactly as ``verify_lanes``'s, each in the tier its event count
    calls for.  Both tiers must launch: the large case keeps its event
    keys in device scratch, the others in shared memory."""
    from nomad_tpu_torch.ops import kernels as k

    tiers = set()
    r = results.setdefault("allocs_fit_verify", {"max_abs_err": 0.0})
    for case in edge_cases_module().VERIFY_CASES:
        ops = verify_operands(case)
        n, (b, p, _), d = ops[0].shape[0], ops[2].shape, ops[4].shape[1]
        plan = k.allocs_fit_verify_shape(n, b, p, d)
        before = k.allocs_fit_verify.launches
        got = k.allocs_fit_verify(*ops)
        _sync()
        if k.allocs_fit_verify.launches != before + 1:
            raise AssertionError(f"allocs_fit_verify did not launch on {case}")
        want = k.verify_lanes(*[x.cpu() for x in ops]).numpy()
        got = got.cpu().numpy()
        err = float(np.abs(got - want).max())
        r["max_abs_err"] = max(r["max_abs_err"], err)
        zeros = int((want[..., k.FUSED_PACKED_VERIFIED] == 0.0).sum())
        log(f"edge[verify {case}] allocs_fit_verify vs plain: max |err| "
            f"{err:.3g}, {'equal' if np.array_equal(got, want) else 'DIFFERENT'}"
            f"; B={b}, P={p}, D={d}, N={n}; VERIFIED 0.0 on {zeros} "
            f"placements; plan {plan}")
        if not np.array_equal(got, want):
            raise AssertionError(f"allocs_fit_verify disagrees on {case}")
        if plan["tier"] != (1 if case == "large" else 0):
            raise AssertionError(f"allocs_fit_verify on {case}: tier {plan}")
        tiers.add(plan["tier"])
    if tiers != {0, 1}:
        raise AssertionError(f"allocs_fit_verify tiers launched: {tiers}")


def check_system_rows(results: dict) -> None:
    """``system_feasible`` at the node counts of
    ``torch_edge_cases.SYSTEM_ROWS`` (1 to 80,000 rows, ragged ones
    included) on every request of ``system_case`` (every constraint kind,
    all sixteen slots, a datacenter list, a device ask, a static port, an
    exhausting ask, an escaped class with a host mask): both rows exactly
    as the plain version's, every byte 0 or 1."""
    import torch

    from nomad_tpu_torch.ops import kernels as k

    edge = edge_cases_module()
    r = results.setdefault("system_feasible", {"max_abs_err": 0.0})
    for n in edge.SYSTEM_ROWS:
        w = edge.system_case(edge.port_pkg(), n)
        arrays = edge.first_rows(w["m"].sync("cuda"), n)
        feasible = []
        for label, req, class_elig, host_mask in w["reqs"]:
            ri, rf = k.pack_request(req, "cuda")
            ce = torch.from_numpy(class_elig).to("cuda")
            hm = torch.from_numpy(host_mask[:n].copy()).to("cuda")
            got = k.system_feasible(arrays, arrays.used, ri, rf, ce, hm)
            want = k.system_feasible_plain(arrays, arrays.used, ri, rf, ce, hm)
            _sync()
            diff = (got.cpu().to(torch.int32) - want.cpu().to(torch.int32))
            err = float(diff.abs().max())
            r["max_abs_err"] = max(r.get("max_abs_err", 0.0), err)
            if int(got.view(torch.uint8).max()) > 1:
                raise AssertionError(f"system rows {n} {label}: a byte not 0/1")
            if not torch.equal(got.cpu(), want.cpu()):
                raise AssertionError(f"system_feasible disagrees at N={n} on "
                                     f"{label}")
            feasible.append(int(want[0].sum()))
        log(f"edge[system N={n}] system_feasible vs plain: equal on "
            f"{len(w['reqs'])} requests; feasible {feasible}")


def check_past_shared_memory(results: dict) -> None:
    """At LARGE_ROWS rows a lane's candidate state no longer fits its
    cluster's shared memory and ``fused_place`` keeps it in device scratch,
    in the same kernel: on both batches (built as phase 2's, LARGE_LANES
    lanes), ``fused_place`` at the batch's widths, ``place_batch`` at full
    widths and ``score_batch`` against their plain versions under the full
    contract.  Fails if the launch shape keeps the state in shared memory."""
    from nomad_tpu_torch.ops import kernels as k

    m = build_cluster(LARGE_ROWS, LARGE_ROWS, "cuda")
    for label, batch in zip(("bench", "features"),
                            make_batches(m, "cuda", lanes=LARGE_LANES)):
        a = batch.args()
        n, b, d = int(a[1].shape[0]), int(a[7].shape[0]), int(a[2].shape[1])
        own = batch.features
        sb = a[:2] + a[4:11]
        checks = (
            ("fused_place", own, k.fused_place(*a, SCAN, own),
             k.place_lanes(*a, SCAN, own),
             k.fused_place_shape(n, b, d, SCAN, own)),
            ("place_batch", k.FULL_FEATURES, k.place_batch(*a[:11], SCAN),
             k.place_batch_plain(*a[:11], SCAN),
             k.fused_place_shape(n, b, d, SCAN, k.FULL_FEATURES)),
            ("score_batch", own,
             k.pack_batch_result(k.score_batch(*sb, own))[:, None],
             k.pack_batch_result(k.score_batch_plain(*sb, own))[:, None],
             k.score_batch_shape(n, b, own)),
        )
        _sync()
        for name, f, got, want, shape in checks:
            if name != "score_batch" and shape["state_in_smem"]:
                raise AssertionError(f"{name} at N={n} kept its state in "
                                     f"shared memory: {shape}")
            ok, err, msg = compare(got.cpu(), want.cpu(), k.PACKED_WIDTH)
            r = results.setdefault(name, {"max_abs_err": 0.0})
            r["max_abs_err"] = max(r["max_abs_err"], err)
            log(f"past shared memory [{label}] {name} at {tuple(f)} vs plain: "
                f"{msg} (max |err| {err:.3g}); N={n}, B={b}; launch {shape}")
            if not ok:
                raise AssertionError(f"{name} disagrees at N={n} "
                                     f"({label} batch): {msg}")


def system_jobs():
    """The two system jobs of the server phase."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.structs.types import Constraint, NetworkResource

    exporter = mock.system_job()
    exporter.id = exporter.name = "node-exporter"
    exporter.datacenters = list(DATACENTERS)
    exporter.task_groups[0].tasks[0].resources.networks = [
        NetworkResource(reserved_ports=[SYSTEM_PORT])]
    shipper = mock.system_job()
    shipper.id = shipper.name = "log-shipper"
    shipper.datacenters = ["dc1"]
    shipper.task_groups[0].constraints = [Constraint(
        l_target="${node.class}", operand="!=", r_target="class-3")]
    return exporter, shipper


def system_cases(m, arrays):
    """(label, request, class_elig, host_mask, plan deltas) for the kernel
    phase: the shapes a system eval can hand ``system_feasible``."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.ops.encode import RequestEncoder, pow2_bucket
    from nomad_tpu_torch.structs.types import Constraint, RequestedDevice

    rng = np.random.default_rng(17)
    enc = RequestEncoder(m)
    n = int(arrays.used.shape[0])
    k_cls = pow2_bucket(max(1, len(m.class_ids)))
    exporter, shipper = system_jobs()

    def variant(**kw):
        job = mock.system_job()
        job.datacenters = list(DATACENTERS)
        tg = job.task_groups[0]
        for key, val in kw.items():
            if key in ("cpu", "memory_mb"):
                setattr(tg.tasks[0].resources, key, val)
            elif key == "devices":
                tg.tasks[0].resources.devices = val
            elif key == "datacenters":
                job.datacenters = val
            else:
                setattr(tg, key, val)
        return job

    c = Constraint
    jobs = [
        ("node-exporter", exporter),
        ("log-shipper", shipper),
        ("datacenters", variant(datacenters=["dc2", "dc3"])),
        ("numeric-version", variant(constraints=[
            c(l_target="${attr.os.version}", operand=">=", r_target="20"),
            c(l_target="${attr.os.version}", operand="version",
              r_target=">= 22.0"),
            c(l_target="${attr.rack}", operand="!=", r_target="r3")])),
        ("presence", variant(constraints=[
            c(l_target="${attr.platform.tpu.type}", operand="is_set"),
            c(l_target="${attr.gpu.model}", operand="is_not_set"),
            c(l_target="${attr.platform.tpu.type}", operand="=",
              r_target="v5e")])),
        # rack values ("r7") parse to NaN: every ordered compare fails.
        ("nan-column", variant(constraints=[
            c(l_target="${attr.rack}", operand="<", r_target="100")])),
        ("device", variant(devices=[RequestedDevice(name="gpu", count=2)])),
        ("escaped-class-host-mask", variant()),
        ("signed-deltas", variant(cpu=900, memory_mb=1024)),
        ("exhausting", variant(cpu=3000, memory_mb=4000)),
    ]
    out = []
    for label, job in jobs:
        req = enc.compile(job, job.task_groups[0]).request
        class_elig = np.ones((k_cls,), bool)
        host_mask = np.ones((n,), bool)
        deltas = {}
        if label == "escaped-class-host-mask":
            # Four entries for more class ids than that: the ids past the
            # end read the last entry.
            class_elig = np.array([True, False, True, True])
            host_mask[::17] = False
        if label == "signed-deltas":
            rows = rng.choice(N_NODES, N_NODES // 8, replace=False)
            half = len(rows) // 2
            for r in rows[:half]:  # this job's own allocs, subtracted
                deltas[int(r)] = -np.array([900, 1024, 0], np.float32)
            for r in rows[half:]:  # other placements in the plan
                deltas[int(r)] = rng.integers(100, 3000, 3).astype(np.float32)
        out.append((label, req, class_elig, host_mask, deltas))
    return out


def phase_system_kernel(m, results: dict) -> None:
    """system_feasible against its plain version at N=10240 on every
    request of ``system_cases``: both rows exactly equal, every output
    byte 0 or 1."""
    import torch

    from nomad_tpu_torch.ops import kernels as k
    from nomad_tpu_torch.scheduler.stack import _dense_used0

    arrays = m.sync("cuda")
    dev = arrays.used.device
    err = 0.0
    for label, req, class_elig, host_mask, deltas in system_cases(m, arrays):
        used0 = _dense_used0(arrays, deltas)
        ri, rf = k.pack_request(req, dev)
        ce = torch.from_numpy(class_elig).to(dev)
        hm = torch.from_numpy(host_mask).to(dev)
        got = k.system_feasible(arrays, used0, ri, rf, ce, hm)
        want = k.system_feasible_plain(arrays, used0, ri, rf, ce, hm)
        _sync()
        raw = got.view(torch.uint8).cpu()
        got, want = got.cpu(), want.cpu()
        diff = (got.to(torch.int32) - want.to(torch.int32)).abs()
        err = max(err, float(diff.max()))
        mask, fits = want[0], want[1]
        log(f"kernels[system {label}] system_feasible vs plain: "
            f"{int((diff != 0).sum())} entries differ; feasible "
            f"{int(mask.sum())}, fit {int(fits.sum())}, exhausted "
            f"{int((mask & ~fits).sum())} of {mask.shape[0]} rows, "
            f"{len(deltas)} deltas")
        if int(raw.max()) > 1:
            raise AssertionError(f"system {label}: an output byte is not 0/1")
        if not torch.equal(got, want):
            raise AssertionError(f"system_feasible disagrees on {label}")
    r = results.setdefault("system_feasible", {"max_abs_err": 0.0})
    r["max_abs_err"] = max(r["max_abs_err"], err)
    r["matches_plain"] = True


def server_config():
    """The server phases' config: 32 workers, 64 lanes, long heartbeat TTLs
    (the smoke plays no client heartbeats, and marks nodes down itself
    through the RPC that heartbeat expiry calls)."""
    from nomad_tpu_torch.server.server import ServerConfig

    return ServerConfig(num_workers=SERVER_WORKERS, coalescer_lanes=LANES,
                        node_capacity=CAPACITY, heartbeat_min_ttl=3600.0,
                        heartbeat_max_ttl=7200.0)


def register_cluster(srv, label: str, preload: bool = True) -> dict:
    """Register the server phases' 10,000 nodes and, with ``preload``,
    pre-load their usage (seeded, written into the matrix, so not
    journaled); returns node id -> (datacenter, class)."""
    rng = np.random.default_rng(7)
    t0 = time.perf_counter()
    specs = {}
    for i in range(N_NODES):
        node = server_node(i)
        specs[node.id] = (node.datacenter, node.node_class)
        srv.register_node(node)
    if not preload:
        log(f"{label}: {N_NODES} nodes registered in "
            f"{time.perf_counter() - t0:.2f} s")
        return specs
    with srv.matrix._host_lock:
        host = srv.matrix.snapshot_host()
        usage = np.round(rng.uniform(0.1, 0.6, (N_NODES, 3))
                         * host["totals"][:N_NODES])
        host["used"][:N_NODES] = usage
        srv.matrix._dirty.update(range(N_NODES))
        srv.matrix.version += 1
    log(f"{label}: {N_NODES} nodes registered in "
        f"{time.perf_counter() - t0:.2f} s")
    return specs


def service_job(i: int):
    """The service bursts' i-th job: count 2 over the four datacenters."""
    from nomad_tpu_torch import mock

    job = mock.job()
    job.datacenters = list(DATACENTERS)
    tg = job.task_groups[0]
    tg.count = SERVER_COUNT
    tg.tasks[0].resources.cpu = 50 + 25 * (i % 4)
    tg.tasks[0].resources.memory_mb = 64 + 32 * (i % 3)
    return job


def check_burst(srv, evals, label: str) -> dict:
    """Every job of a service burst holds exactly SERVER_COUNT allocs, each
    on a registered node whose usage fits its capacity; returns the
    burst's counts."""
    statuses = {srv.store.eval_by_id(e.id).status for e in evals}
    allocs = [a for a in srv.store.allocs.values()
              if not a.terminal_status()]
    want = SERVER_JOBS * SERVER_COUNT
    if len(allocs) != want:
        raise AssertionError(f"{label}: {len(allocs)} allocations, "
                             f"expected {want}")
    host = srv.matrix.snapshot_host()
    per_job = {}
    for a in allocs:
        row = srv.matrix.row_of.get(a.node_id)
        if row is None or srv.store.node_by_id(a.node_id) is None:
            raise AssertionError(f"alloc {a.id} on unknown node {a.node_id}")
        if not np.all(host["used"][row] <= host["totals"][row]):
            raise AssertionError(f"node row {row} over capacity")
        per_job[a.job_id] = per_job.get(a.job_id, 0) + 1
    if sorted(set(per_job.values())) != [SERVER_COUNT]:
        raise AssertionError(f"{label}: allocs per job "
                             f"{sorted(set(per_job.values()))}")
    return {"allocs": len(allocs), "statuses": sorted(statuses),
            "retried": retried_evals(srv, evals)}


def phase_server(card: str, results: dict, recorder) -> None:
    from nomad_tpu_torch.ops import kernels as k
    from nomad_tpu_torch.server.server import Server

    srv = Server(server_config(), device="cuda")
    srv.start()
    try:
        specs = register_cluster(srv, "server")
        k.reset_counts()
        refused0 = srv.plan_applier.nodes_refused
        evals, elapsed = burst(srv, [service_job(i) for i in range(SERVER_JOBS)])
        launches = {
            "fused_place": k.fused_place.launches,
            "allocs_fit_verify": k.allocs_fit_verify.launches,
            "place_batch": k.place_batch.launches,
            "plain": k.place_lanes.calls + k.verify_lanes.calls,
        }
        refused = srv.plan_applier.nodes_refused - refused0
        counts = check_burst(srv, evals, "server")
        log(f"server: {SERVER_JOBS} jobs x {SERVER_COUNT} in {elapsed:.3f} s = "
            f"{SERVER_JOBS / elapsed:.1f} evals/s, {counts['allocs']} "
            f"allocations, eval statuses {counts['statuses']} "
            f"({counts['retried']} retried after placement conflicts), "
            f"{refused} node placements refused by the applier, "
            f"{srv.coalescer.dispatches} dispatches / "
            f"{srv.coalescer.fused_lanes} lanes (card: {card})")
        log(f"server: launches during the run {launches}")
        if launches["fused_place"] <= 0 or launches["allocs_fit_verify"] <= 0:
            raise AssertionError(f"a kernel never launched: {launches}")
        if launches["plain"] != 0 or launches["place_batch"] != 0:
            raise AssertionError(f"plain version or the staged kernel ran "
                                 f"on the fused path: {launches}")
        results["fused_place"]["launches"] = launches["fused_place"]
        results["allocs_fit_verify"]["launches"] = launches["allocs_fit_verify"]
        results["server"] = {
            "evals_per_s": SERVER_JOBS / elapsed, "seconds": elapsed,
            "dispatches": srv.coalescer.dispatches,
            "lanes": srv.coalescer.fused_lanes, "refused": refused,
            "retried": counts["retried"],
        }
        solo_run(srv, service_job, results)
        trace_burst(srv, [service_job(i) for i in range(SERVER_JOBS)], card)
        system_run(srv, specs, card, results, recorder)
        lifecycle_run(srv, specs, card, results)
    finally:
        srv.shutdown()


def phase_staged_server(card: str, results: dict) -> None:
    """The staged dispatch end to end: a second server built under
    ``NOMAD_TPU_MEGABATCH=0`` over the same 10,000 nodes takes the same
    64-job burst through ``place_batch`` (no verify column, so the applier
    alone judges each pick).  Counts zeroed just before the burst and read
    just after: place_batch launched, the fused kernels and the plain
    versions never."""
    import os

    from nomad_tpu_torch.ops import kernels as k
    from nomad_tpu_torch.server.server import Server

    prev = os.environ.get("NOMAD_TPU_MEGABATCH")
    os.environ["NOMAD_TPU_MEGABATCH"] = "0"
    try:
        srv = Server(server_config(), device="cuda")
    finally:
        if prev is None:
            del os.environ["NOMAD_TPU_MEGABATCH"]
        else:
            os.environ["NOMAD_TPU_MEGABATCH"] = prev
    if srv.coalescer.megabatch:
        raise AssertionError("the staged server's coalescer is fused")
    srv.start()
    try:
        register_cluster(srv, "staged")
        k.reset_counts()
        evals, elapsed = burst(srv, [service_job(i) for i in range(SERVER_JOBS)])
        launches = {
            "place_batch": k.place_batch.launches,
            "fused_place": k.fused_place.launches,
            "allocs_fit_verify": k.allocs_fit_verify.launches,
            "plain": k.place_lanes.calls + k.verify_lanes.calls,
        }
        refused = srv.plan_applier.nodes_refused
        counts = check_burst(srv, evals, "staged")
        plan_retries = sum(1 for e in srv.store.evals.values()
                           if e.triggered_by == "max-plan-attempts")
        log(f"staged: {SERVER_JOBS} jobs x {SERVER_COUNT} in {elapsed:.3f} s "
            f"= {SERVER_JOBS / elapsed:.1f} evals/s, {counts['allocs']} "
            f"allocations, eval statuses {counts['statuses']} "
            f"({counts['retried']} retried after placement conflicts, "
            f"{plan_retries} max-plan-attempts evals), {refused} node "
            f"placements refused by the applier, "
            f"{srv.plan_applier.plans_partial} plans partly or wholly "
            f"refused, {srv.coalescer.dispatches} dispatches / "
            f"{srv.coalescer.coalesced_requests} lanes (card: {card})")
        log(f"staged: launches during the run {launches}")
        if launches["place_batch"] <= 0:
            raise AssertionError(f"place_batch never launched: {launches}")
        if (launches["allocs_fit_verify"] or launches["fused_place"]
                or launches["plain"]):
            raise AssertionError(f"the staged path ran another kernel or "
                                 f"a plain version: {launches}")
        if srv.coalescer.fused_dispatches:
            raise AssertionError("the staged server made a fused dispatch")
        results["place_batch"]["launches"] = launches["place_batch"]
        results["staged_server"] = {
            "evals_per_s": SERVER_JOBS / elapsed, "seconds": elapsed,
            "dispatches": srv.coalescer.dispatches,
            "lanes": srv.coalescer.coalesced_requests, "refused": refused,
            "retried": counts["retried"], "plan_retries": plan_retries,
        }
    finally:
        srv.shutdown()


def server_node(i: int):
    """The server phase's i-th node: four datacenters, six classes."""
    from nomad_tpu_torch import mock

    node = mock.node()
    node.datacenter = DATACENTERS[i % len(DATACENTERS)]
    node.node_class = f"class-{i % 6}"
    node.attributes = dict(node.attributes)
    node.attributes["rack"] = f"r{i % 32}"
    return node


def live_allocs(srv, job_id=None, node_id=None):
    allocs = (srv.store.allocs_by_node(node_id) if node_id is not None
              else list(srv.store.allocs.values()))
    return [a for a in allocs if not a.terminal_status()
            and (job_id is None or a.job_id == job_id)]


def play_client(srv) -> int:
    """Report every pending alloc the scheduler wants running as running
    (what each node's client would do); returns how many."""
    updates = []
    for a in list(srv.store.allocs.values()):
        if a.client_status == "pending" and a.desired_status == "run":
            upd = a.copy()
            upd.client_status = "running"
            updates.append(upd)
    if updates:
        srv.update_allocs_from_client(updates)
    return len(updates)


def wait_quiet(srv, what: str, timeout_s: float = LIFECYCLE_TIMEOUT_S) -> float:
    """Wait until no eval is queued or in flight and every eval in the
    store is terminal or blocked for want of room, three polls in a row;
    returns seconds.  An eval blocked after placement conflicts is still
    open: the server runs it again."""
    t0 = time.perf_counter()
    broker = srv.eval_broker
    quiet = 0
    while quiet < 3:
        if time.perf_counter() - t0 > timeout_s:
            raise AssertionError(f"{what}: evals still open after {timeout_s:.0f} s")
        busy = (broker.ready_count() + broker.unacked_count()
                + broker.pending_count() + broker.delayed_count())
        open_evals = any(not e.terminal_status() and (
            e.status != "blocked" or e.triggered_by == "max-plan-attempts")
            for e in list(srv.store.evals.values()))
        quiet = quiet + 1 if not busy and not open_evals else 0
        time.sleep(0.02)
    return time.perf_counter() - t0


def expect_system(srv, job, want_nodes, label: str) -> None:
    """``job`` holds exactly one live alloc on each node of ``want_nodes``
    and on no other node."""
    allocs = live_allocs(srv, job.id)
    nodes = [a.node_id for a in allocs]
    if len(nodes) != len(set(nodes)):
        raise AssertionError(f"{label}: {job.id} has two allocs on a node")
    if set(nodes) != set(want_nodes):
        raise AssertionError(
            f"{label}: {job.id} on {len(set(nodes))} nodes, expected "
            f"{len(want_nodes)} ({len(set(nodes) - set(want_nodes))} extra, "
            f"{len(set(want_nodes) - set(nodes))} missing)")


def check_capacity(srv, label: str) -> None:
    host = srv.matrix.snapshot_host()
    over = np.flatnonzero(np.any(host["used"] > host["totals"], axis=1))
    if len(over):
        raise AssertionError(f"{label}: {len(over)} node rows over capacity")


def system_run(srv, specs: dict, card: str, results: dict,
               recorder) -> None:
    """The system path on the server phase's 10,000 nodes: two system jobs,
    then 32 joining nodes, 16 drains and 16 nodes down, with every count
    checked exactly.  Launch counts are zeroed just before and read just
    after."""
    from nomad_tpu_torch.ops import kernels as k
    from nomad_tpu_torch.scheduler.system import MAX_SYSTEM_SCHEDULE_ATTEMPTS
    from nomad_tpu_torch.structs.types import DrainStrategy

    exporter, shipper = system_jobs()
    matches = {
        exporter.id: lambda dc, cls: True,
        shipper.id: lambda dc, cls: dc == "dc1" and cls != "class-3",
    }
    placed = {}  # job id -> the nodes that got an alloc at submit

    def wanted(job, gone=()):
        """The nodes ``job`` must hold: those that took it at submit and
        the joined nodes its spec matches (they join empty), less the
        gone ones."""
        joined = {nid for nid, spec in specs.items()
                  if nid in new_nodes and matches[job.id](*spec)}
        return (placed[job.id] | joined) - set(gone)

    evals_before = set(srv.store.evals)
    service_jobs = {a.job_id for a in live_allocs(srv)}
    service_count = {j: len(live_allocs(srv, j)) for j in service_jobs}
    parked = [e for e in srv.store.evals.values() if e.status == "blocked"]
    if parked:
        raise AssertionError(f"{len(parked)} blocked evals before the system "
                             "phase: its service counts would move")
    new_nodes: set = set()
    sched = srv.metrics.timer("nomad.worker.invoke_scheduler")
    sched0 = (sched.count, sched.sum)
    k.reset_counts()
    t_phase = time.perf_counter()

    # 1. Two system jobs on 10,000 nodes, one after the other.  The nodes
    # a job must land on follow from the specs registered and the room
    # each node has for its ask; a node without room is exhausted, which
    # the eval must report and park a blocked eval for.
    results["system_server"] = {}
    for job in (exporter, shipper):
        r = job.task_groups[0].combined_resources()
        ask = np.array([r.cpu, r.memory_mb, r.disk_mb], np.float32)
        with srv.matrix._host_lock:
            host = srv.matrix.snapshot_host()
            room_rows = np.all(host["used"] + ask <= host["totals"], axis=1)
        match = {nid for nid, spec in specs.items() if matches[job.id](*spec)}
        room = {nid for nid in match if room_rows[srv.matrix.row_of[nid]]}
        t0 = time.perf_counter()
        recorder.armed = job is exporter  # phase 8 replays its checks
        ev = srv.submit_job(job)
        while not srv.store.eval_by_id(ev.id).terminal_status():
            if time.perf_counter() - t0 > LIFECYCLE_TIMEOUT_S:
                raise AssertionError(f"{job.id}: eval not terminal in time")
            time.sleep(0.005)
        secs = time.perf_counter() - t0
        recorder.armed = False
        cur = srv.store.eval_by_id(ev.id)
        exhausted = sum(m.nodes_exhausted for m in cur.failed_tg_allocs.values())
        log(f"system: {job.id} eval {cur.status} in {secs:.3f} s (submit -> "
            f"complete), {len(live_allocs(srv, job.id))} allocs on "
            f"{len(match)} matching nodes, {exhausted} exhausted (predicted "
            f"{len(match) - len(room)}), blocked eval "
            f"{bool(cur.blocked_eval)} (card: {card})")
        if cur.status != "complete" or exhausted != len(match) - len(room):
            raise AssertionError(f"{job.id}: eval {cur.status}, "
                                 f"{exhausted} nodes exhausted")
        if bool(cur.blocked_eval) != (exhausted > 0):
            raise AssertionError(f"{job.id}: blocked eval {cur.blocked_eval!r}")
        placed[job.id] = room
        expect_system(srv, job, wanted(job), "submit")
        results["system_server"][f"{job.id}_eval_s"] = secs
    check_capacity(srv, "submit")

    # 2. 32 nodes join: each gets the system allocs its spec calls for.
    t0 = time.perf_counter()
    for i in range(N_NODES, N_NODES + SYSTEM_NEW_NODES):
        node = server_node(i)
        specs[node.id] = (node.datacenter, node.node_class)
        new_nodes.add(node.id)
        srv.register_node(node)
    secs = wait_quiet(srv, "node joins")
    joins = [e for e in srv.store.evals.values()
             if e.id not in evals_before and e.triggered_by == "node-update"]
    log(f"system: {SYSTEM_NEW_NODES} nodes joined, {len(joins)} node-update "
        f"evals done in {time.perf_counter() - t0:.3f} s "
        f"({secs:.3f} s after the last registration)")
    expect_system(srv, exporter, wanted(exporter), "joins")
    expect_system(srv, shipper, wanted(shipper), "joins")
    reported = play_client(srv)
    log(f"system: the client reported {reported} allocs running")

    # 3. Drain 16 nodes that hold service allocs.
    old_nodes = sorted(nid for nid in specs
                       if any(a.job_id in service_jobs
                              for a in live_allocs(srv, node_id=nid)))
    drained = old_nodes[:SYSTEM_DRAINS]
    down = old_nodes[SYSTEM_DRAINS:SYSTEM_DRAINS + SYSTEM_DOWNS]
    if len(down) != SYSTEM_DOWNS:
        raise AssertionError(f"only {len(old_nodes)} nodes hold service allocs")
    moved = [a.id for nid in drained for a in live_allocs(srv, node_id=nid)
             if a.job_id in service_jobs]
    t0 = time.perf_counter()
    for nid in drained:
        srv.update_node_drain(nid, DrainStrategy())
    while any(srv.store.node_by_id(nid).drain for nid in drained):
        if time.perf_counter() - t0 > LIFECYCLE_TIMEOUT_S:
            raise AssertionError("drains did not complete in time")
        play_client(srv)
        time.sleep(0.05)
    wait_quiet(srv, "drains")
    play_client(srv)
    log(f"system: {SYSTEM_DRAINS} drains complete in "
        f"{time.perf_counter() - t0:.3f} s, {len(moved)} service allocs "
        f"migrated")
    for nid in drained:
        node = srv.store.node_by_id(nid)
        if node.drain or node.scheduling_eligibility != "ineligible":
            raise AssertionError(f"drained node {nid}: drain {node.drain}, "
                                 f"{node.scheduling_eligibility}")
        if live_allocs(srv, node_id=nid):
            raise AssertionError(f"drained node {nid} still holds allocs")
    if not all(srv.store.alloc_by_id(a).desired_status == "stop" for a in moved):
        raise AssertionError("a drained service alloc was not stopped")

    # 4. 16 other nodes go down (the RPC a missed heartbeat calls).
    lost = [a.id for nid in down for a in live_allocs(srv, node_id=nid)]
    t0 = time.perf_counter()
    for nid in down:
        srv.update_node_status(nid, "down")
    wait_quiet(srv, "nodes down")
    play_client(srv)
    log(f"system: {SYSTEM_DOWNS} nodes down, {len(lost)} allocs lost and "
        f"handled in {time.perf_counter() - t0:.3f} s")
    not_lost = [srv.store.alloc_by_id(a) for a in lost
                if srv.store.alloc_by_id(a).client_status != "lost"]
    if not_lost:
        raise AssertionError(
            f"{len(not_lost)} allocs on down nodes not lost: " + "; ".join(
                f"{a.name} ({a.job.type if a.job else '?'}) desired "
                f"{a.desired_status} ({a.desired_description}) client "
                f"{a.client_status}, migrate "
                f"{a.desired_transition.should_migrate()}"
                for a in not_lost[:4]))

    # Final state: every count exact.
    gone = set(drained) | set(down)
    expect_system(srv, exporter, wanted(exporter, gone), "final")
    expect_system(srv, shipper, wanted(shipper, gone), "final")
    for job_id, count in service_count.items():
        allocs = live_allocs(srv, job_id)
        if len(allocs) != count or {a.node_id for a in allocs} & gone:
            evals = sorted(
                (e.create_index, e.triggered_by, e.status, e.status_description)
                for e in srv.store.evals.values()
                if e.job_id == job_id and e.id not in evals_before)
            raise AssertionError(f"service job {job_id}: {len(allocs)} live "
                                 f"allocs, expected {count} off the gone "
                                 f"nodes; its evals {evals}")
    check_capacity(srv, "final")

    sys_evals = [e for e in srv.store.evals.values()
                 if e.id not in evals_before and e.type == "system"]
    statuses = sorted({e.status for e in sys_evals})
    # Evals that ran the scheduler end complete; the blocked evals that
    # exhausted nodes park stay blocked, or are cancelled when a newer one
    # of the same job replaces them.  An eval whose plan only partly
    # commits runs the scheduler (and the kernel) again, up to five times.
    ran = [e for e in sys_evals if e.status == "complete"]
    parked = [e for e in sys_evals if e.status != "complete"]
    launches = {
        "system_feasible": k.system_feasible.launches,
        "system_feasible_plain": k.system_feasible_plain.calls,
        "fused_place": k.fused_place.launches,
        "plain": k.place_lanes.calls + k.verify_lanes.calls,
    }
    log(f"system: {len(sys_evals)} system evals {statuses} ({len(ran)} ran "
        f"the scheduler, {launches['system_feasible'] - len(ran)} extra "
        f"attempts after partial commits) in "
        f"{time.perf_counter() - t_phase:.3f} s; launches {launches}")
    if any(e.status not in ("blocked", "cancelled")
           or e.triggered_by != "queued-allocs" for e in parked):
        raise AssertionError(f"system eval statuses {statuses}")
    if not (len(ran) <= launches["system_feasible"]
            <= MAX_SYSTEM_SCHEDULE_ATTEMPTS * len(ran)):
        raise AssertionError(
            f"system_feasible launched {launches['system_feasible']} times "
            f"for {len(ran)} system evals of one task group each")
    if launches["system_feasible_plain"] or launches["plain"]:
        raise AssertionError(f"plain version ran on the card: {launches}")
    if launches["fused_place"] <= 0:
        raise AssertionError("no service replacement went through fused_place")
    results["system_feasible"]["launches"] = launches["system_feasible"]
    results["system_server"].update(
        system_evals=len(ran), fused_place=launches["fused_place"],
        seconds=time.perf_counter() - t_phase)
    n_sched = sched.count - sched0[0]
    mean_ms = (sched.sum - sched0[1]) / max(1, n_sched) * 1e3
    results["system_server"]["scheduler_ms_mean"] = mean_ms
    log(f"system: {n_sched} scheduler invocations (system and service) in "
        f"this phase, {mean_ms:.3f} ms each on average (card: {card})")


def play_health(srv, healthy=lambda a: True) -> int:
    """The client under deployments: report each alloc the scheduler wants
    running that was not reported yet, or not judged healthy or unhealthy
    yet, as running with the ``healthy`` verdict (allocs outside a
    deployment get no verdict); returns how many."""
    from nomad_tpu_torch.structs.types import AllocDeploymentStatus

    updates = []
    for a in list(srv.store.allocs.values()):
        if a.desired_status != "run" or a.terminal_status():
            continue
        unjudged = a.deployment_id and (
            a.deployment_status is None or a.deployment_status.healthy is None)
        if a.client_status != "pending" and not unjudged:
            continue
        upd = a.copy()
        upd.client_status = "running"
        if a.deployment_id:
            prev = a.deployment_status
            upd.deployment_status = AllocDeploymentStatus(
                healthy=healthy(a), timestamp=time.time(),
                canary=prev.canary if prev is not None else False)
        updates.append(upd)
    if updates:
        srv.update_allocs_from_client(updates)
    return len(updates)


def drive(srv, pred, what: str, healthy=lambda a: True,
          timeout_s: float = LIFECYCLE_TIMEOUT_S) -> float:
    """Play the client until ``pred()``; returns seconds."""
    t0 = time.perf_counter()
    while not pred():
        if time.perf_counter() - t0 > timeout_s:
            raise AssertionError(f"{what}: not reached in {timeout_s:.0f} s")
        play_health(srv, healthy)
        time.sleep(0.05)
    return time.perf_counter() - t0


def lifecycle_job(job_id: str, count: int, job_type: str = "service"):
    from nomad_tpu_torch import mock

    job = mock.job()
    job.id = job.name = job_id
    job.type = job_type
    job.datacenters = list(DATACENTERS)
    tg = job.task_groups[0]
    tg.count = count
    tg.tasks[0].resources.cpu = 100
    tg.tasks[0].resources.memory_mb = 64
    return job


def lifecycle_run(srv, specs: dict, card: str, results: dict) -> None:
    """The job lifecycle on the server phase's 10,000 nodes, the smoke as
    the client: a destructive rolling update (count 8, max_parallel 2) to
    successful, a canary auto-promoted, a failing update auto-reverted, an
    interval periodic job's children, a dispatched parameterized job, a
    scale up and down within policy, and ``system_gc``: a stopped job and
    16 down nodes reaped, then 16 nodes registered into the freed matrix
    rows and covered by the system jobs through ``system_feasible``.
    Launch counts zeroed just before and read just after."""
    from nomad_tpu_torch.ops import kernels as k
    from nomad_tpu_torch.structs.types import (
        PeriodicConfig, ScalingPolicy, UpdateStrategy,
    )

    def update(**kw):
        kw.setdefault("max_parallel", 1)
        kw.setdefault("min_healthy_time", 0.1)
        kw.setdefault("healthy_deadline", 120.0)
        kw.setdefault("progress_deadline", 600.0)
        return UpdateStrategy(**kw)

    def deployment(job_id, version):
        for d in list(srv.store.deployments.values()):
            if d.job_id == job_id and d.job_version == version:
                return d
        return None

    def successful(job_id, version):
        d = deployment(job_id, version)
        return d is not None and d.status == "successful"

    def new_version(job, env, **upd):
        job2 = job.copy()
        job2.task_groups[0].tasks[0].env = dict(env)
        if upd:
            job2.task_groups[0].update = update(**upd)
        return job2

    def versions(job_id):
        return sorted(a.job.version for a in live_allocs(srv, job_id))

    timings = {}
    k.reset_counts()
    t_phase = time.perf_counter()

    # 1. Rolling update: eight allocs, two at a time.
    t0 = time.perf_counter()
    web = lifecycle_job("rolling", 8)
    web.task_groups[0].update = update(max_parallel=2)
    srv.submit_job(web)
    drive(srv, lambda: successful("rolling", 0), "rolling v0")
    srv.submit_job(new_version(web, {"V": "2"}))
    drive(srv, lambda: successful("rolling", 1), "rolling v1")
    dep = deployment("rolling", 1)
    batches = sum(1 for e in list(srv.store.evals.values())
                  if e.deployment_id == dep.id
                  and e.triggered_by == "deployment-watcher")
    if versions("rolling") != [1] * 8 or batches < 3:
        raise AssertionError(f"rolling update: live versions "
                             f"{versions('rolling')}, {batches} batch evals")
    timings["rolling"] = time.perf_counter() - t0
    log(f"lifecycle: rolling update of 8 (max_parallel 2) successful in "
        f"{timings['rolling']:.3f} s, {batches} watcher batch evals")

    # 2. Canary, auto-promoted (the first version has none: ROADMAP R7).
    t0 = time.perf_counter()
    api = lifecycle_job("canary", 3)
    api.task_groups[0].update = update()
    srv.submit_job(api)
    drive(srv, lambda: successful("canary", 0), "canary v0")
    srv.submit_job(new_version(api, {"V": "2"}, canary=1, auto_promote=True))
    wait_quiet(srv, "canary placed")
    canaries = [a for a in live_allocs(srv, "canary")
                if a.deployment_status is not None and a.deployment_status.canary]
    drive(srv, lambda: successful("canary", 1), "canary v1")
    promoted = [s.promoted for s in deployment("canary", 1).task_groups.values()]
    if len(canaries) != 1 or promoted != [True] or versions("canary") != [1] * 3:
        raise AssertionError(f"canary: {len(canaries)} canaries before "
                             f"promotion, promoted {promoted}, live versions "
                             f"{versions('canary')}")
    timings["canary"] = time.perf_counter() - t0
    log(f"lifecycle: canary placed alone, auto-promoted, successful in "
        f"{timings['canary']:.3f} s")

    # 3. A failing update, auto-reverted.
    t0 = time.perf_counter()
    rev = lifecycle_job("revert", 2)
    rev.task_groups[0].update = update(auto_revert=True)
    srv.submit_job(rev)
    drive(srv, lambda: successful("revert", 0), "revert v0")
    srv.submit_job(new_version(rev, {"BAD": "1"}))

    def reverted():
        return (srv.store.job_by_id("default", "revert").version == 2
                and versions("revert") == [2, 2]
                and all(a.client_status == "running"
                        for a in live_allocs(srv, "revert")))

    drive(srv, reverted, "auto-revert",
          healthy=lambda a: not a.job.task_groups[0].tasks[0].env.get("BAD"))
    failed = deployment("revert", 1)
    if failed.status != "failed":
        raise AssertionError(f"revert: v1 deployment {failed.status}")
    timings["revert"] = time.perf_counter() - t0
    log(f"lifecycle: failing update {failed.status} "
        f"({failed.status_description}), reverted to version 2 in "
        f"{timings['revert']:.3f} s")

    # 4. An interval periodic batch job: two children or more, each placed.
    t0 = time.perf_counter()
    cron = lifecycle_job("cron", 1, "batch")
    cron.periodic = PeriodicConfig(spec="0.5", spec_type="interval")
    if srv.submit_job(cron) is not None:
        raise AssertionError("a periodic job got an eval at register")

    def children():
        return [jid for (_, jid) in list(srv.store.jobs)
                if jid.startswith("cron/periodic-")]

    drive(srv, lambda: len(children()) >= 2, "two periodic children")
    srv.deregister_job("default", "cron")
    wait_quiet(srv, "periodic children")
    kids = children()
    unplaced = [j for j in kids if len(live_allocs(srv, j)) != 1]
    if unplaced:
        raise AssertionError(f"periodic children not placed: {unplaced}")
    timings["periodic"] = time.perf_counter() - t0
    log(f"lifecycle: {len(kids)} periodic children launched and placed in "
        f"{timings['periodic']:.3f} s")

    # 5. A dispatched parameterized job.
    t0 = time.perf_counter()
    param = lifecycle_job("param", 1, "batch")
    param.parameterized = {"meta_required": ["k"], "payload": "optional"}
    srv.submit_job(param)
    try:
        srv.dispatch_job("default", "param")
        raise AssertionError("dispatch without required meta was accepted")
    except ValueError:
        pass
    child, ev = srv.dispatch_job("default", "param", payload=b"hi",
                                 meta={"k": "v"})
    wait_quiet(srv, "dispatch")
    if (srv.store.eval_by_id(ev.id).status != "complete"
            or len(live_allocs(srv, child.id)) != 1):
        raise AssertionError(f"dispatched child {child.id} not placed")
    timings["dispatch"] = time.perf_counter() - t0
    log(f"lifecycle: dispatched {child.id} placed in "
        f"{timings['dispatch']:.3f} s")

    # 6. Scale up and down within the group's policy.
    t0 = time.perf_counter()
    sc = lifecycle_job("scaled", 2)
    sc.task_groups[0].scaling = ScalingPolicy(min=1, max=5)
    srv.submit_job(sc)
    wait_quiet(srv, "scaled v0")
    try:
        srv.scale_job("default", "scaled", "web", 6)
        raise AssertionError("scale past the policy was accepted")
    except ValueError:
        pass
    counts = []
    for count in (4, 1):
        srv.scale_job("default", "scaled", "web", count)
        wait_quiet(srv, f"scale to {count}")
        counts.append(len(live_allocs(srv, "scaled")))
    if counts != [4, 1]:
        raise AssertionError(f"scale: live allocs {counts}, expected [4, 1]")
    timings["scale"] = time.perf_counter() - t0
    log(f"lifecycle: scaled 2 -> 4 -> 1 in {timings['scale']:.3f} s")

    # 7. system_gc: the stopped job and 16 down nodes (in a datacenter no
    # job runs in, so they hold no allocs), then 16 nodes into their rows.
    t0 = time.perf_counter()
    first = N_NODES + SYSTEM_NEW_NODES
    doomed = []
    for i in range(first, first + SYSTEM_DOWNS):
        node = server_node(i)
        node.datacenter = "dc5"
        srv.register_node(node)
        doomed.append(node.id)
    wait_quiet(srv, "dc5 joins")
    for nid in doomed:
        srv.update_node_status(nid, "down")
    srv.deregister_job("default", "scaled")
    wait_quiet(srv, "down and deregister")
    freed = {srv.matrix.row_of[nid] for nid in doomed}
    launches = {"fused_place": k.fused_place.launches,
                "plain": (k.place_lanes.calls + k.verify_lanes.calls
                          + k.system_feasible_plain.calls)}
    if launches["fused_place"] <= 0 or launches["plain"]:
        raise AssertionError(f"lifecycle placements: launches {launches}")
    k.reset_counts()
    srv.system_gc()
    drive(srv, lambda: any(e.type == "_core" and e.status == "complete"
                           for e in list(srv.store.evals.values())),
          "the force-gc eval")
    wait_quiet(srv, "gc")
    gone = [nid for nid in doomed if srv.store.node_by_id(nid) is None]
    if (len(gone) != len(doomed) or srv.store.job_by_id("default", "scaled")
            or freed & set(srv.matrix.row_of.values())):
        raise AssertionError(f"gc: {len(gone)} of {len(doomed)} down nodes "
                             f"reaped, stopped job still stored: "
                             f"{bool(srv.store.job_by_id('default', 'scaled'))}")
    strays = [a.id for a in live_allocs(srv)
              if srv.store.node_by_id(a.node_id) is None]
    if strays:
        raise AssertionError(f"gc: {len(strays)} live allocs on unknown nodes")
    reaped_s = time.perf_counter() - t0
    fresh = []
    for i in range(first + SYSTEM_DOWNS, first + 2 * SYSTEM_DOWNS):
        node = server_node(i)
        specs[node.id] = (node.datacenter, node.node_class)
        srv.register_node(node)
        fresh.append(node.id)
    wait_quiet(srv, "joins into freed rows")
    rows = {srv.matrix.row_of[nid] for nid in fresh}
    if rows != freed:
        raise AssertionError(f"new nodes took rows {sorted(rows)}, freed "
                             f"{sorted(freed)}")
    exporter, shipper = system_jobs()
    for nid in fresh:
        dc, cls = specs[nid]
        want = {exporter.id} | ({shipper.id} if dc == "dc1"
                                and cls != "class-3" else set())
        have = [a.job_id for a in live_allocs(srv, node_id=nid)]
        if sorted(have) != sorted(want):
            raise AssertionError(f"node {nid} in a freed row holds {have}, "
                                 f"expected {sorted(want)}")
    sys_launches = k.system_feasible.launches
    if sys_launches <= 0:
        raise AssertionError("no system eval of the joins ran system_feasible")
    timings["gc"] = time.perf_counter() - t0
    log(f"lifecycle: system_gc reaped the stopped job and {len(gone)} down "
        f"nodes in {reaped_s:.3f} s; {len(fresh)} nodes registered into "
        f"the freed rows got their system allocs ({sys_launches} "
        f"system_feasible launches) in {timings['gc'] - reaped_s:.3f} s")

    gc_plain = (k.place_lanes.calls + k.verify_lanes.calls
                + k.system_feasible_plain.calls)
    if gc_plain:
        raise AssertionError(f"plain version ran on the card: {gc_plain}")
    check_capacity(srv, "lifecycle")
    timings["total"] = time.perf_counter() - t_phase
    results["lifecycle"] = timings
    log(f"lifecycle: every check passed in {timings['total']:.3f} s; "
        f"launches before the gc step {launches}, in it system_feasible "
        f"{sys_launches} (card: {card})")


def solo_run(srv, make_job, results: dict) -> None:
    """One distinct_hosts group of SOLO_COUNT: its plan outgrows
    MAX_DELTA_ROWS deltas after three chunks, so the stack's solo path
    places the rest.  Launch counts are zeroed just before and read just
    after."""
    from nomad_tpu_torch.ops import kernels as k
    from nomad_tpu_torch.structs.types import Constraint

    wide = make_job(0)
    wide.task_groups[0].count = SOLO_COUNT
    wide.task_groups[0].constraints = [Constraint(operand="distinct_hosts")]
    solo0 = srv.coalescer.solo_ops
    k.reset_counts()
    _, elapsed = burst(srv, [wide])
    launches = {
        "fused_place": k.fused_place.launches,
        "allocs_fit_verify": k.allocs_fit_verify.launches,
        "plain": k.place_lanes.calls + k.verify_lanes.calls,
    }
    solo_ops = srv.coalescer.solo_ops - solo0
    nodes = [a.node_id for a in srv.store.allocs.values()
             if a.job_id == wide.id and not a.terminal_status()]
    log(f"server solo: 1 job x {SOLO_COUNT} (distinct_hosts) in "
        f"{elapsed:.3f} s, {len(nodes)} allocations on {len(set(nodes))} "
        f"nodes, {solo_ops} solo selects; launches {launches}")
    if len(nodes) != SOLO_COUNT or len(set(nodes)) != SOLO_COUNT:
        raise AssertionError(f"solo job placed {len(nodes)} allocs on "
                             f"{len(set(nodes))} nodes")
    if solo_ops <= 0 or launches["fused_place"] < solo_ops:
        raise AssertionError(f"solo path not driven: {solo_ops} solo "
                             f"selects, launches {launches}")
    if launches["plain"] != 0:
        raise AssertionError(f"plain version ran on the card: {launches}")
    results["fused_place"]["solo_run"] = {
        "launches": launches["fused_place"], "solo_selects": solo_ops}


def last_eval(srv, eval_id: str):
    """The eval that ``eval_id`` ends in: an eval that failed on placement
    conflicts hands its job to a blocked retry (``blocked_eval``), which
    the server runs again after a while."""
    ev = srv.store.eval_by_id(eval_id)
    while ev is not None and ev.status == "failed" and ev.blocked_eval:
        ev = srv.store.eval_by_id(ev.blocked_eval)
    return ev


def retried_evals(srv, evals) -> int:
    """How many of ``evals`` failed on placement conflicts and left their
    job to a blocked retry."""
    return sum(1 for e in evals
               if srv.store.eval_by_id(e.id).blocked_eval
               and srv.store.eval_by_id(e.id).status == "failed")


def burst(srv, jobs, timeout_s: float = 300.0):
    """Submit ``jobs`` and wait until every eval, or the retry it left
    after placement conflicts, is terminal; returns (evals, seconds)."""
    t0 = time.perf_counter()
    evals = [srv.submit_job(job) for job in jobs]
    deadline = time.time() + timeout_s
    pending = {e.id for e in evals}
    while pending and time.time() < deadline:
        pending = {
            eid for eid in pending
            if not (last_eval(srv, eid) is not None
                    and last_eval(srv, eid).terminal_status())
        }
        if pending:
            time.sleep(0.005)
    if pending:
        raise AssertionError(
            f"{len(pending)} evals not terminal after {timeout_s:.0f} s")
    return evals, time.perf_counter() - t0


def trace_burst(srv, jobs, card: str) -> None:
    """A second burst of the same size under the CUDA profiler (device
    activity only): how much of the burst's wall time the card spent on
    kernels and copies, by name.  The sum over activities counts any
    overlap twice, so the busy share is an upper bound.  Every job of the
    burst must hold its full count after it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from nomad_tpu_torch.ops import kernels as k

    launched = k.fused_place.launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        evals, wall = burst(srv, jobs)
        torch.cuda.synchronize()
    launched = k.fused_place.launches - launched
    # Every job of the traced burst placed in full: the system phase counts
    # on each service job holding its count.
    short = []
    for job, ev in zip(jobs, evals):
        have = len(live_allocs(srv, job.id))
        if have != job.task_groups[0].count:
            cur = last_eval(srv, ev.id)
            short.append(f"{job.id}: {have} allocs, eval {cur.status} "
                         f"({cur.status_description})")
    if short:
        raise AssertionError(f"traced burst left {len(short)} jobs short: "
                             + "; ".join(short[:4]))
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us > 0:
            rows.append((us, e.count, e.key))
    busy_s = sum(us for us, _, _ in rows) / 1e6
    if not rows:
        log(f"server trace: {len(jobs)} jobs in {wall:.3f} s under the "
            "profiler; device busy share not measured (the profiler "
            "recorded no device activity)")
        return
    log(f"server trace: {len(jobs)} jobs in {wall:.3f} s under the profiler "
        f"({retried_evals(srv, evals)} retried after placement conflicts); "
        f"device busy {busy_s * 1e3:.3f} ms = {100.0 * busy_s / wall:.2f}% "
        f"of the burst, idle {100.0 - 100.0 * busy_s / wall:.2f}% "
        f"(card: {card})")
    for us, count, key in sorted(rows, reverse=True)[:6]:
        log(f"  device {us / 1e3:9.3f} ms  x{count:<5d} {key[:70]}")
    kept_records(rows, "fused_place_kernel", launched)


def kept_records(rows, name: str, launched: int) -> None:
    """Log when the profiler kept fewer records of kernel ``name`` than
    its wrapper launched: the busy share then misses their time."""
    kept = sum(count for _, count, key in rows if name in key)
    if kept < launched:
        log(f"  the profiler kept {kept} of {launched} {name} launches: "
            "the busy share misses the rest")


def phase_timing(batch: Batch, card: str, results: dict) -> None:
    from nomad_tpu_torch.ops import kernels as k

    args = batch.args()
    t = batch.t
    packed = k.fused_place(*args, SCAN, batch.features)

    def run_fp():
        k.fused_place(*args, SCAN, batch.features)

    def run_fp_plain():
        k.place_lanes(*args, SCAN, batch.features)

    def run_v():
        k.allocs_fit_verify(batch.arrays.totals, batch.arrays.used, packed,
                            t["req_f"], t["delta_rows"], t["delta_vals"],
                            t["lane_mask"])

    def run_v_plain():
        k.verify_lanes(batch.arrays.totals, batch.arrays.used, packed,
                       t["req_f"], t["delta_rows"], t["delta_vals"],
                       t["lane_mask"])

    for name, fn, plain, work in (
        ("fused_place", run_fp, run_fp_plain,
         fused_place_work(batch, packed, SCAN)),
        ("allocs_fit_verify", run_v, run_v_plain,
         verify_work(batch, packed, SCAN)),
    ):
        ms = time_cuda(fn, runs=20)
        dev_us = device_us_per_launch(fn, f"{name}_kernel")
        plain_ms = time_cuda(plain, runs=3, warmup=1)
        b_ms, by = bound(*work)
        r = results[name]
        r.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
                 library_ms=None, device_us=dev_us)
        shape = ""
        if name == "fused_place":
            r["launch"] = k.fused_place_shape(
                int(batch.arrays.used.shape[0]), LANES,
                t["delta_rows"].shape[1], SCAN, batch.features)
            shape = f"; launch {r['launch']}"
        log(f"timing {name}: {ms:.4f} ms by CUDA events, {fmt_us(dev_us)} a "
            f"launch on the device (profiler); plain version {plain_ms:.3f} "
            f"ms, bound {b_ms:.5f} ms by {by}; {work[0]} bytes, "
            f"{work[1]:.4g} ops{shape} (card: {card})")
    r = results["allocs_fit_verify"]
    r["launch"] = k.allocs_fit_verify_shape(
        int(batch.arrays.used.shape[0]), LANES, SCAN,
        t["delta_rows"].shape[1])
    r["host_us"] = host_us_per_call(run_v)
    log(f"timing allocs_fit_verify: plan {r['launch']}; the wrapper's host "
        f"time {r['host_us']:.3f} us a call (card: {card})")

    # The fused dispatch: both launches of fused_place_batch.
    fp_us = results["fused_place"]["device_us"]
    v_us = results["allocs_fit_verify"]["device_us"]
    dispatch_ms = time_cuda(
        lambda: k.fused_place_batch(*args, SCAN, batch.features), runs=20)
    both_us = None if fp_us is None or v_us is None else fp_us + v_us
    results["fused_dispatch"] = {"device_us": both_us, "ms": dispatch_ms}
    log(f"timing fused dispatch: fused_place {fmt_us(fp_us)} + "
        f"allocs_fit_verify {fmt_us(v_us)} = {fmt_us(both_us)} on the device; "
        f"fused_place_batch {dispatch_ms:.4f} ms by CUDA events (card: {card})")

    # allocs_fit_verify on the hot-row stream and in its device-scratch tier.
    tiers = {}
    for case in ("hot_row", "large"):
        ops = verify_operands(case)
        n, (b, p, _), d = ops[0].shape[0], ops[2].shape, ops[4].shape[1]

        def run_case():
            k.allocs_fit_verify(*ops)

        tiers[case] = {
            "ms": time_cuda(run_case, runs=20),
            "device_us": device_us_per_launch(run_case,
                                              "allocs_fit_verify_kernel"),
            "launch": k.allocs_fit_verify_shape(n, b, p, d),
        }
        log(f"timing allocs_fit_verify [{case}]: {tiers[case]['ms']:.4f} ms "
            f"by CUDA events, {fmt_us(tiers[case]['device_us'])} a launch on "
            f"the device (profiler); B={b}, P={p}, D={d}; plan "
            f"{tiers[case]['launch']} (card: {card})")
    r["cases"] = tiers


def host_us_per_call(fn, runs: int = 2000) -> float:
    """Mean host microseconds of ``fn`` over ``runs`` calls after a
    warm-up (launches queue on the stream; the card is not waited for)."""
    import torch

    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(runs):
        fn()
    us = (time.perf_counter() - t0) / runs * 1e6
    torch.cuda.synchronize()
    return us


def device_us_per_launch(fn, name: str, runs: int = 20,
                         passes: int = 3) -> Optional[float]:
    """Median device time of kernel ``name`` per launch over ``runs``
    calls of ``fn`` (one launch each), from the CUDA profiler's kernel
    records.  Late in this long process the profiler keeps only some of
    a trace's records (14 of 20, or none, on the H100); a pass that kept
    fewer than half is profiled again, up to ``passes`` in all.  None
    (not measured) when no pass did."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(passes):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
        durations = [e.time_range.elapsed_us() for e in prof.events()
                     if name in e.name]
        if len(durations) < runs:
            log(f"profiler: {len(durations)} of {runs} {name} launches "
                "recorded")
        if 2 * len(durations) >= runs:
            return statistics.median(durations)
    return None


def fmt_us(x: Optional[float]) -> str:
    """A profiler time for the log, or "not measured"."""
    return "not measured" if x is None else f"{x:.3f} us"


def phase_system_timing(m, card: str, results: dict) -> None:
    """system_feasible alone on the node-exporter request at N=10240
    (CUDA events and the profiler), its plain version, its bound, and one
    whole dispatch of a node-update eval: ``_dense_used0`` over one plan
    delta per node, the kernel, and the (2, N) copy back."""
    import torch

    from nomad_tpu_torch.ops import kernels as k
    from nomad_tpu_torch.scheduler.stack import _dense_used0

    arrays = m.sync("cuda")
    dev = arrays.used.device
    _, req, class_elig, host_mask, _ = next(
        c for c in system_cases(m, arrays) if c[0] == "node-exporter")
    used0 = arrays.used.clone()
    ri, rf = k.pack_request(req, dev)
    ce = torch.from_numpy(class_elig).to(dev)
    hm = torch.from_numpy(host_mask).to(dev)

    def run():
        k.system_feasible(arrays, used0, ri, rf, ce, hm)

    def run_plain():
        k.system_feasible_plain(arrays, used0, ri, rf, ce, hm)

    ms = time_cuda(run, runs=20)
    dev_us = device_us_per_launch(run, "system_feasible_kernel")
    plain_ms = time_cuda(run_plain, runs=20)
    work = system_feasible_work(arrays, req, len(class_elig))
    split = system_wrapper_split(arrays, used0, ri, rf, ce, hm, card)
    b_ms, by = bound(*work)
    own = {r: -np.array([100.0, 64.0, 0.0], np.float32) for r in range(N_NODES)}

    def dispatch():
        return k.system_feasible(arrays, _dense_used0(arrays, own), ri, rf,
                                 ce, hm).cpu()

    for _ in range(3):
        dispatch()
    times = []
    for _ in range(20):
        t0 = time.perf_counter()
        dispatch()
        times.append((time.perf_counter() - t0) * 1e3)
    dispatch_ms = statistics.median(times)
    results["system_feasible"].update(
        ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=by, library_ms=None,
        device_us=dev_us, host_split_us=split)
    results["system_server"]["dispatch_ms"] = dispatch_ms
    log(f"timing system_feasible: {ms:.4f} ms by CUDA events, "
        f"{fmt_us(dev_us)} a launch on the device (profiler); plain version "
        f"{plain_ms:.3f} ms; bound {b_ms:.6f} ms by {by}; {work[0]} bytes, "
        f"{work[1]:.4g} ops; one node-update dispatch ({len(own)} deltas, "
        f"kernel, copy back) {dispatch_ms:.3f} ms on the host clock "
        f"(card: {card})")


def system_wrapper_split(arrays, used0, ri, rf, ce, hm, card: str) -> dict:
    """Where the host time of one ``system_feasible`` call goes: the CUDA
    events' floor on an empty function, the wrapper's host microseconds
    a call, and each of its parts alone — the matrix check (memoised with
    the columns' pointers), the four operand checks, ``load_library``
    behind its import, the output allocation, the stream handle, the
    ``ctypes`` launch — beside what the earlier wrapper did instead (a
    Stream object for the handle)."""
    import torch

    from nomad_tpu_torch.ops import build
    from nomad_tpu_torch.ops import kernels as k

    dev = used0.device
    n = int(used0.shape[0])
    kk = int(ce.shape[0])
    _, cols = k._checked_cols(arrays, used0, dev)
    fn = build.load_library("system_feasible").nomad_system_feasible
    out = torch.empty((2, n), dtype=torch.bool, device=dev)
    a, w = int(arrays.attr_hash.shape[1]), int(arrays.port_words.shape[1])

    def checks():
        k._check("req_i", ri, torch.int32, (1, k.REQ_INT_WIDTH), dev)
        k._check("req_f", rf, torch.float32, (1, k.REQ_FLOAT_WIDTH), dev)
        k._check("class_elig", ce, torch.bool, (kk,), dev)
        k._check("host_mask", hm, torch.bool, (n,), dev)

    def launch():
        fn(cols, used0.data_ptr(), ri.data_ptr(), rf.data_ptr(),
           ce.data_ptr(), hm.data_ptr(), out.data_ptr(), n, a, w, kk,
           k._stream(dev))

    def library():
        from nomad_tpu_torch.ops.build import load_library

        load_library("system_feasible")

    parts = {
        "wrapper": lambda: k.system_feasible(arrays, used0, ri, rf, ce, hm),
        "check_matrix": lambda: k._checked_cols(arrays, used0, dev),
        "four_checks": checks,
        "load_library": library,
        "torch_empty": lambda: torch.empty((2, n), dtype=torch.bool,
                                           device=dev),
        "stream": lambda: k._stream(dev),
        "ctypes_launch": launch,
        "earlier_stream_object":
            lambda: torch.cuda.current_stream().cuda_stream,
    }
    split = {name: host_us_per_call(f) for name, f in parts.items()}
    split["event_floor_us"] = time_cuda(lambda: None, runs=50) * 1e3
    split["event_us"] = time_cuda(parts["wrapper"], runs=50) * 1e3
    log("timing system_feasible host split (us a call): " + ", ".join(
        f"{name} {us:.3f}" for name, us in split.items()) + f" (card: {card})")
    return split


# ---------------------------------------------------------------------------
# Phase 7: batched scoring (the bench's kernel phase, on the port)
# ---------------------------------------------------------------------------


def stacked(reqs):
    from nomad_tpu_torch.ops.encode import SchedRequest

    return SchedRequest(*[np.stack(f) for f in zip(*reqs)])


def score_args(arrays, inp):
    return (arrays, arrays.used, inp["tg_counts"], inp["spread_counts"],
            inp["penalties"], inp["req_i"], inp["req_f"], inp["class_eligs"],
            inp["host_masks"])


def score_plain_in_chunks(args, features):
    """score_batch_plain over chunks of PLAIN_CHUNK lanes, stacked as the
    (B, 7) packed output: its (B, N) and (B, N, V) intermediates are
    gigabytes each at B=4096 in one piece."""
    import torch

    from nomad_tpu_torch.ops import kernels as k

    arrays, used, lane_args = args[0], args[1], args[2:]
    b = lane_args[0].shape[0]
    parts = []
    for c in range(0, b, PLAIN_CHUNK):
        sl = slice(c, c + PLAIN_CHUNK)
        parts.append(k.pack_batch_result(k.score_batch_plain(
            arrays, used, *[a[sl] for a in lane_args], features)))
    return torch.cat(parts)


def bench_requests(m, lanes: int):
    """Lane i the bench's job shape i mod 8 (bench.py build_requests), and
    the features widened over the eight shapes as bench.py does."""
    from nomad_tpu_torch.ops import kernels as k
    from nomad_tpu_torch.ops.encode import RequestEncoder

    enc = RequestEncoder(m)
    shapes = [enc.compile(j, j.task_groups[0]).request for j, _ in bench_jobs()]
    feats = k.features_of(shapes[0])
    for sh in shapes[1:]:
        feats = feats.widen(k.features_of(sh))
    return [shapes[i % len(shapes)] for i in range(lanes)], feats


def feature_score_inputs(m, device, lanes: int = FEATURE_LANES, seed: int = 21):
    """The feature batch's shapes (preemption, ports, distinct_hosts, a
    targeted spread, then the bench's eight) with per-lane operands that
    are not trivial: tg counts, penalties, class eligibility with holes,
    host masks (one lane masked out entirely) and spread tables holding
    rack values with counts.  Returns (inputs on ``device``, stacked numpy
    request)."""
    import torch

    from nomad_tpu_torch.ops import kernels as k
    from nomad_tpu_torch.ops.encode import (
        MAX_SPREAD_VALUES, MAX_SPREADS, RequestEncoder, pow2_bucket,
    )
    from nomad_tpu_torch.state.matrix import stable_hash

    rng = np.random.default_rng(seed)
    enc = RequestEncoder(m)
    mix = feature_jobs() + bench_jobs()
    reqs = stacked([
        enc.compile(j, j.task_groups[0], preemption_enabled=pre).request
        for j, pre in (mix[i % len(mix)] for i in range(lanes))])
    n = m.capacity
    s_hash = np.array(reqs.s_value_hash, copy=True)
    counts = np.zeros((lanes, MAX_SPREADS, MAX_SPREAD_VALUES), np.float32)
    for lane in range(lanes):
        for s in range(MAX_SPREADS):
            if reqs.s_slot[lane, s] < 0:
                continue
            for v in range(6):
                if s_hash[lane, s, v] == 0:
                    s_hash[lane, s, v] = stable_hash(f"r{v}")
                counts[lane, s, v] = float(rng.integers(0, 5))
    reqs = reqs._replace(s_value_hash=s_hash)
    tg = np.zeros((lanes, n), np.int32)
    tg[:, :N_NODES] = (rng.random((lanes, N_NODES)) < 0.02) * rng.integers(
        1, 4, (lanes, N_NODES))
    pen = rng.random((lanes, n)) < 0.05
    k_cls = pow2_bucket(max(1, len(m.class_ids)))
    ce = rng.random((lanes, k_cls)) < 0.85
    ce[:, 0] = True
    hm = rng.random((lanes, n)) < 0.9
    hm[lanes - 1] = False
    ri, rf = k.pack_requests(reqs)

    def on(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    inp = dict(req_i=on(ri), req_f=on(rf), tg_counts=on(tg),
               spread_counts=on(counts), penalties=on(pen),
               class_eligs=on(ce), host_masks=on(hm))
    return inp, reqs


def check_score(label: str, got, want, results: dict) -> None:
    from nomad_tpu_torch.ops import kernels as k

    ok, err, msg = compare(got.cpu()[:, None], want.cpu()[:, None],
                           k.PACKED_WIDTH)
    r = results.setdefault("score_batch", {"max_abs_err": 0.0})
    r["max_abs_err"] = max(r["max_abs_err"], err)
    rows = got.cpu().numpy()[:, k.PACKED_ROW]
    pre = int(got.cpu().numpy()[:, k.PACKED_PREEMPT].sum())
    log(f"batched[{label}] score_batch vs plain: {msg} (max |err| {err:.3g}); "
        f"{int((rows >= 0).sum())} of {len(rows)} lanes placed, "
        f"{len(set(rows[rows >= 0].tolist()))} distinct rows, "
        f"{pre} preempting")
    if not ok:
        raise AssertionError(f"score_batch disagrees on {label}: {msg}")


def pct(xs, q):
    return float(np.percentile(np.asarray(xs), q))


def phase_batched_scoring(m, card: str, results: dict) -> None:
    """score_batch at the bench's shapes: parity with the plain version
    (B=4096, B=256, the feature batch at B=64 and entry()), then the main
    path with the counts zeroed around it (entry(), 100 sync dispatches
    at B=4096 and at B=256, 100 pipelined dispatches at B=4096), then the
    kernel's CUDA-event and profiler times, the plain version's time, the
    bound and a traced window of sync dispatches."""
    import torch

    from nomad_tpu_torch.entry import entry
    from nomad_tpu_torch.ops import kernels as k
    from nomad_tpu_torch.parallel import build_batch_inputs

    arrays = m.sync("cuda")
    big_reqs, feats = bench_requests(m, SCORE_BATCH)
    big = build_batch_inputs(m, big_reqs, "cuda")
    small = build_batch_inputs(m, big_reqs[:INTERACTIVE_BATCH], "cuda")
    big_args, small_args = score_args(arrays, big), score_args(arrays, small)
    log(f"batched: {SCORE_BATCH} and {INTERACTIVE_BATCH} lanes of the "
        f"bench's eight shapes on {N_NODES} nodes (capacity "
        f"{arrays.used.shape[0]}), features {tuple(feats)}")

    # Parity (the plain version in chunks of PLAIN_CHUNK lanes).
    for label, args, f in (
        (f"bench B={SCORE_BATCH}", big_args, feats),
        (f"bench B={INTERACTIVE_BATCH}", small_args, feats),
    ):
        got = k.pack_batch_result(k.score_batch(*args, f))
        check_score(label, got, score_plain_in_chunks(args, f), results)
    f_inp, f_reqs = feature_score_inputs(m, "cuda")
    f_args = score_args(arrays, f_inp)
    got = k.pack_batch_result(k.score_batch(*f_args, k.FULL_FEATURES))
    check_score(f"features B={FEATURE_LANES} full", got,
                score_plain_in_chunks(f_args, k.FULL_FEATURES), results)
    rows = got.cpu().numpy()[:, k.PACKED_ROW]
    if rows[-1] != -1 or not got.cpu().numpy()[:, k.PACKED_PREEMPT].any():
        raise AssertionError("feature batch lost its masked lane or its "
                             "preempting picks")
    fn, e_args = entry()
    if e_args[1].device.type != "cuda":
        raise AssertionError("entry() did not take the card")
    check_score("entry()", k.pack_batch_result(fn(*e_args)),
                k.pack_batch_result(k.score_batch_plain(*e_args)), results)

    # The main path: entry() and the bench's dispatch loops.
    pinned = [torch.empty((SCORE_BATCH,), dtype=torch.int32, pin_memory=True)
              for _ in range(PIPELINE_DEPTH)]

    def sync_loop(args, label):
        for _ in range(2):
            k.score_batch(*args, feats).rows.cpu()
        total, launch, fetch = [], [], []
        for _ in range(DISPATCHES):
            t0 = time.perf_counter()
            res = k.score_batch(*args, feats)
            t1 = time.perf_counter()
            res.rows.cpu()
            t2 = time.perf_counter()
            total.append((t2 - t0) * 1e3)
            launch.append((t1 - t0) * 1e3)
            fetch.append((t2 - t1) * 1e3)
        b = args[2].shape[0]
        out = {"p50_ms": statistics.median(total), "p99_ms": pct(total, 99),
               "launch_p50_ms": statistics.median(launch),
               "fetch_p50_ms": statistics.median(fetch),
               "evals_per_s": DISPATCHES * b / (sum(total) / 1e3)}
        log(f"batched[sync {label}] {DISPATCHES} dispatches, each ending in "
            f"a .cpu() of rows: p50 {out['p50_ms']:.4f} ms, p99 "
            f"{out['p99_ms']:.4f} ms (launch p50 {out['launch_p50_ms']:.4f} "
            f"ms, fetch p50 {out['fetch_p50_ms']:.4f} ms), "
            f"{out['evals_per_s']:.1f} evals/s (card: {card})")
        return out

    def pipelined():
        """PIPELINE_DEPTH dispatches in flight; each dispatch's rows copy
        into its own pinned buffer right behind its kernel, and the host
        reads the oldest as it drains."""
        inflight = []
        t0 = time.perf_counter()
        for i in range(PIPE_DISPATCHES):
            res = k.score_batch(*big_args, feats)
            buf = pinned[i % PIPELINE_DEPTH]
            buf.copy_(res.rows, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record()
            inflight.append((ev, buf))
            if len(inflight) >= PIPELINE_DEPTH:
                ev0, buf0 = inflight.pop(0)
                ev0.synchronize()
                int(buf0[0])
        for ev0, buf0 in inflight:
            ev0.synchronize()
            int(buf0[0])
        secs = time.perf_counter() - t0
        return PIPE_DISPATCHES * SCORE_BATCH / secs, secs

    k.reset_counts()
    fn(*e_args).rows.cpu()
    sync_big = sync_loop(big_args, f"B={SCORE_BATCH}")
    sync_small = sync_loop(small_args, f"B={INTERACTIVE_BATCH}")
    pipe_rate, pipe_s = pipelined()
    launches = k.score_batch.launches
    plain_calls = k.score_batch_plain.calls
    made = 1 + 2 * (2 + DISPATCHES) + PIPE_DISPATCHES
    log(f"batched[pipelined B={SCORE_BATCH}] depth {PIPELINE_DEPTH}, "
        f"{PIPE_DISPATCHES} dispatches in {pipe_s:.4f} s = {pipe_rate:.1f} "
        f"evals/s (card: {card})")
    log(f"batched: launches during the main path {launches} for {made} "
        f"dispatches, plain version {plain_calls} calls")
    if launches != made or plain_calls != 0:
        raise AssertionError(f"score_batch launched {launches} times for "
                             f"{made} dispatches, plain {plain_calls}")

    # Times of the kernel alone, the plain version, the bound.
    r = results["score_batch"]
    timing = {}
    for label, args in ((SCORE_BATCH, big_args), (INTERACTIVE_BATCH, small_args)):
        ms = time_cuda(lambda: k.score_batch(*args, feats), runs=20)
        dev_us = device_us_per_launch(lambda: k.score_batch(*args, feats),
                                      "score_batch_kernel")
        timing[label] = (ms, dev_us)
    packed = k.pack_batch_result(k.score_batch(*big_args, feats))
    plain_ms = time_cuda(lambda: score_plain_in_chunks(big_args, feats),
                         runs=3, warmup=1)
    work = score_batch_work(arrays, stacked(big_reqs), feats, big_args, packed)
    b_ms, by = bound(*work)
    ms, dev_us = timing[SCORE_BATCH]
    r.update(launches=launches, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
             bound_by=by, library_ms=None, device_us=dev_us,
             matches_plain=True)
    results["batched"] = {
        "sync_4096": sync_big, "sync_256": sync_small,
        "pipelined_evals_per_s": pipe_rate,
        "ms_256": timing[INTERACTIVE_BATCH][0],
        "device_us_256": timing[INTERACTIVE_BATCH][1],
    }
    n = int(arrays.used.shape[0])
    r["launch"] = {b: k.score_batch_shape(n, b, feats) for b in timing}
    for label, (t_ms, t_us) in timing.items():
        log(f"timing score_batch B={label}: {t_ms:.4f} ms by CUDA events, "
            f"{fmt_us(t_us)} a launch on the device (profiler); launch "
            f"{r['launch'][label]} (card: {card})")
    log(f"timing score_batch B={SCORE_BATCH}: plain version {plain_ms:.3f} ms "
        f"(chunks of {PLAIN_CHUNK} lanes); bound {b_ms:.5f} ms by {by}; "
        f"{work[0]} bytes, {work[1]:.4g} ops (card: {card})")
    trace_sync(big_args, feats, card)


def trace_sync(args, feats, card: str, n: int = 20) -> None:
    """``n`` sync dispatches at B=4096 under the CUDA profiler: the card's
    busy share of the window's wall time, and device time by activity
    (the kernel, the result conversions, the device-to-host copy)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from nomad_tpu_torch.ops import kernels as k

    k.score_batch(*args, feats).rows.cpu()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            k.score_batch(*args, feats).rows.cpu()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us > 0:
            rows.append((us, e.count, e.key))
    if not rows:
        log(f"batched trace: {n} sync dispatches in {wall:.4f} s; device busy "
            "share not measured (the profiler recorded no device activity)")
        return
    busy_s = sum(us for us, _, _ in rows) / 1e6
    log(f"batched trace: {n} sync dispatches at B={SCORE_BATCH} in "
        f"{wall * 1e3:.3f} ms under the profiler; device busy "
        f"{busy_s * 1e3:.3f} ms = {100.0 * busy_s / wall:.2f}%, idle "
        f"{100.0 - 100.0 * busy_s / wall:.2f}% (card: {card})")
    for us, count, key in sorted(rows, reverse=True)[:6]:
        log(f"  device {us / 1e3:9.3f} ms  x{count:<5d} {key[:70]}")
    kept_records(rows, "score_batch_kernel", n)


# ---------------------------------------------------------------------------
# Phase 8: the plan verify
# ---------------------------------------------------------------------------


class HostVerifyRecorder:
    """Wraps the applier's ``host_verify`` (server/plan_apply.py) and, while
    ``armed``, keeps each call's inputs, the host mirror's used, totals and
    eligible columns it read, and its verdicts."""

    def __init__(self):
        from nomad_tpu_torch.server import plan_apply

        self.module = plan_apply
        self.real = plan_apply.host_verify
        self.armed = False
        self.calls = []
        plan_apply.host_verify = self

    def __call__(self, host, rows, deltas, elig_required):
        out = self.real(host, rows, deltas, elig_required)
        if self.armed:
            self.calls.append(dict(
                used=np.array(host["used"]), totals=np.array(host["totals"]),
                eligible=np.array(host["eligible"]),
                rows=np.asarray(rows, np.int32), deltas=np.stack(deltas),
                elig_required=np.asarray(elig_required, bool), verdicts=out))
        return out

    def close(self) -> None:
        self.module.host_verify = self.real


def plan_verify_cases(m, recorder):
    """(label, host columns, rows, deltas, elig_required, applier verdicts
    or None): (a) a seeded plan of K=10,000 rows on the phase-2 cluster
    (padding, deltas past the node's room, negative deltas, ineligible
    nodes, a mixed elig_required), (b) each plan check the applier made
    for node-exporter in the system phase."""
    rng = np.random.default_rng(31)
    host = m.snapshot_host()
    cols = {"used": np.array(host["used"]), "totals": np.array(host["totals"]),
            "eligible": np.array(host["eligible"])}
    off = rng.choice(N_NODES, 300, replace=False)
    cols["eligible"][off] = False
    k_rows = VERIFY_ROWS
    rows = rng.integers(0, N_NODES, k_rows).astype(np.int32)
    rows[rng.random(k_rows) < 0.05] = -1
    safe = np.maximum(rows, 0)
    room = cols["totals"][safe] - cols["used"][safe]
    deltas = (room * rng.uniform(0.3, 1.3, (k_rows, 3))).astype(np.float32)
    deltas[rng.random(k_rows) < 0.05] *= -1.0
    exact = rng.random(k_rows) < 0.02
    deltas[exact] = room[exact]
    elig_required = rng.random(k_rows) < 0.6
    cases = [("seeded", cols, rows, deltas, elig_required, None)]
    for i, c in enumerate(recorder.calls):
        cases.append((f"node-exporter plan {i}",
                      {f: c[f] for f in ("used", "totals", "eligible")},
                      c["rows"], c["deltas"], c["elig_required"],
                      c["verdicts"]))
    return cases


def verify_plan_fit_work(cols, rows):
    """(bytes, float32 ops): each row's index, delta, elig_required and
    verdict byte, and the used, totals and eligible byte of each distinct
    node a live row names, once; three adds and three compares a live
    row."""
    live = rows[rows >= 0]
    nbytes = len(rows) * (4 + 12 + 1 + 1) + len(np.unique(live)) * (12 + 12 + 1)
    return nbytes, 6 * len(live)


def phase_plan_verify(card: str, m, recorder, results: dict) -> None:
    """verify_plan_fit on the seeded plan and on the applier's recorded
    node-exporter plans, with the counts zeroed around those calls; then
    against its plain version and the applier's host_verify, every row;
    then its times at K=10,000."""
    import types

    import torch

    from nomad_tpu_torch.ops import kernels as k
    from nomad_tpu_torch.server.plan_apply import host_verify

    cases = plan_verify_cases(m, recorder)
    if len(cases) < 2:
        raise AssertionError("no node-exporter plan check was recorded")
    on = {}
    for label, cols, rows, deltas, er, _ in cases:
        arrays = types.SimpleNamespace(**{
            f: torch.from_numpy(v).to("cuda") for f, v in cols.items()})
        on[label] = (arrays, torch.from_numpy(rows).to("cuda"),
                     torch.from_numpy(deltas).to("cuda"),
                     torch.from_numpy(er).to("cuda"))
    k.reset_counts()
    got = {label: k.verify_plan_fit(*on[label]) for label, *_ in cases}
    torch.cuda.synchronize()
    launches = k.verify_plan_fit.launches
    plain_calls = k.verify_plan_fit_plain.calls
    if launches != len(cases) or plain_calls:
        raise AssertionError(f"verify_plan_fit launched {launches} times for "
                             f"{len(cases)} plans, plain {plain_calls}")
    err = 0.0
    for label, cols, rows, deltas, er, applier in cases:
        g = got[label]
        raw = g.view(torch.uint8).cpu()
        g = g.cpu().numpy()
        plain = k.verify_plan_fit_plain(*on[label]).cpu().numpy()
        hv = host_verify(cols, rows, list(deltas), er)
        diff = int((g != plain).sum()) + int((g != hv).sum())
        if applier is not None:
            diff += int((g != applier).sum())
        err = max(err, float(np.abs(g.astype(np.int32)
                                    - plain.astype(np.int32)).max()))
        log(f"verify[{label}] verify_plan_fit vs plain vs host_verify"
            f"{' vs the applier' if applier is not None else ''}: {diff} rows "
            f"differ of {len(rows)}; {int((rows < 0).sum())} padding, "
            f"{int((~g).sum())} refused")
        if int(raw.max()) > 1:
            raise AssertionError(f"verify {label}: an output byte is not 0/1")
        if diff:
            raise AssertionError(f"verify_plan_fit disagrees on {label}")
        if label == "seeded" and (g.all() or not g.any()):
            raise AssertionError("the seeded plan refused nothing or all")

    label, cols, rows, *_ = cases[0]
    args = on[label]
    ms = time_cuda(lambda: k.verify_plan_fit(*args), runs=20)
    dev_us = device_us_per_launch(lambda: k.verify_plan_fit(*args),
                                  "verify_plan_fit_kernel")
    plain_ms = time_cuda(lambda: k.verify_plan_fit_plain(*args), runs=20)
    work = verify_plan_fit_work(cols, rows)
    b_ms, by = bound(*work)
    results["verify_plan_fit"] = {
        "launches": launches, "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": by,
        "library_ms": None, "device_us": dev_us, "matches_plain": True,
    }
    log(f"timing verify_plan_fit K={len(rows)}: {ms:.4f} ms by CUDA events, "
        f"{fmt_us(dev_us)} a launch on the device (profiler); plain version "
        f"{plain_ms:.3f} ms; bound {b_ms:.6f} ms by {by}; {work[0]} bytes, "
        f"{work[1]} ops (card: {card})")


# ---------------------------------------------------------------------------
# Phase 9: restart (the write-ahead log, snapshots, restore, snapshot install)
# ---------------------------------------------------------------------------

RESTART_BIG_CPU = 64_000  # the node that unblocks the restored blocked eval


def crash_stop(srv) -> None:
    """Stop a server's threads without the clean-shutdown snapshot: what
    is on disk is what a crash leaves (each append is flushed before its
    mutation applies)."""
    wal = srv.store.wal
    srv.store.wal = None
    srv.shutdown()
    wal.close()


def restart_config(data_dir: str):
    cfg = server_config()
    cfg.data_dir = data_dir
    return cfg


def restart_job(label: str, i: int):
    job = service_job(i)
    job.id = job.name = f"restart-{label}-{i:02d}"
    return job


def huge_job():
    """A job no server node has room for: its eval blocks, and places on
    the big node that registers after the restart."""
    job = restart_job("huge", 0)
    job.task_groups[0].count = 1
    job.task_groups[0].tasks[0].resources.cpu = RESTART_BIG_CPU // 2
    return job


def big_node():
    node = server_node(0)
    node.id = node.name = "restart-big"
    node.resources.cpu = RESTART_BIG_CPU
    node.resources.memory_mb = 1 << 20
    return node


def host_equal(ma, mb, label: str) -> None:
    """Every field of two matrices' host arrays equal row for row (NaN
    columns included), and the same node on every row."""
    ha, hb = ma.snapshot_host(), mb.snapshot_host()
    for f in ha:
        if not np.array_equal(ha[f], hb[f],
                              equal_nan=ha[f].dtype.kind == "f"):
            raise AssertionError(f"{label}: matrix field {f} differs")
    if ma.row_of != mb.row_of:
        raise AssertionError(f"{label}: matrix rows hold other nodes")


def tensors_equal(a, b) -> bool:
    """Bitwise equality (NaN columns compare equal to themselves)."""
    import torch

    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype.is_floating_point:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def new_allocs(srv, before: set, prefix: str) -> list:
    return [a for a in srv.store.allocs.values()
            if a.id not in before and not a.terminal_status()
            and a.job_id.startswith(prefix)]


def check_new_burst(srv, before: set, prefix: str, label: str) -> int:
    """Each job of a restart burst holds exactly SERVER_COUNT live allocs,
    on nodes the store holds, and no node is over capacity."""
    allocs = new_allocs(srv, before, prefix)
    per_job = {}
    for a in allocs:
        if srv.store.node_by_id(a.node_id) is None:
            raise AssertionError(f"{label}: alloc on unknown node {a.node_id}")
        per_job[a.job_id] = per_job.get(a.job_id, 0) + 1
    if (len(allocs) != SERVER_JOBS * SERVER_COUNT
            or set(per_job.values()) != {SERVER_COUNT}):
        raise AssertionError(f"{label}: {len(allocs)} allocs over "
                             f"{len(per_job)} jobs, expected "
                             f"{SERVER_JOBS} x {SERVER_COUNT}")
    check_capacity(srv, label)
    return len(allocs)


def system_targets(srv, job, match) -> set:
    """The nodes ``job`` must land on: those ``match(node)`` takes with
    room for its ask."""
    r = job.task_groups[0].combined_resources()
    ask = np.array([r.cpu, r.memory_mb, r.disk_mb], np.float32)
    with srv.matrix._host_lock:
        host = srv.matrix.snapshot_host()
        room = np.all(host["used"] + ask <= host["totals"], axis=1)
    return {nid for nid, node in list(srv.store.nodes.items())
            if match(node) and room[srv.matrix.row_of[nid]]}


def run_system_job(srv, job, want: set, label: str) -> float:
    t0 = time.perf_counter()
    ev = srv.submit_job(job)
    while not srv.store.eval_by_id(ev.id).terminal_status():
        if time.perf_counter() - t0 > LIFECYCLE_TIMEOUT_S:
            raise AssertionError(f"{label}: {job.id} eval not terminal")
        time.sleep(0.005)
    secs = time.perf_counter() - t0
    if srv.store.eval_by_id(ev.id).status != "complete":
        raise AssertionError(f"{label}: {job.id} eval "
                             f"{srv.store.eval_by_id(ev.id).status}")
    expect_system(srv, job, want, label)
    return secs


def path_launches(k) -> dict:
    return {
        "fused_place": k.fused_place.launches,
        "allocs_fit_verify": k.allocs_fit_verify.launches,
        "system_feasible": k.system_feasible.launches,
        "place_batch": k.place_batch.launches,
        "plain": (k.place_lanes.calls + k.verify_lanes.calls
                  + k.system_feasible_plain.calls),
    }


def check_path_launches(launches: dict, label: str) -> None:
    """The restored and the installed server place through the three
    kernels of the fused and system paths, never a plain version."""
    if (launches["fused_place"] <= 0 or launches["allocs_fit_verify"] <= 0
            or launches["system_feasible"] <= 0):
        raise AssertionError(f"{label}: a kernel never launched: {launches}")
    if launches["plain"] or launches["place_batch"]:
        raise AssertionError(f"{label}: a plain version or the staged "
                             f"kernel ran: {launches}")


def phase_restart(card: str, results: dict) -> None:
    """A server that journals to a data directory takes the server phase's
    work, is crash-stopped, and a second server restores it from the
    write-ahead log; its tables, matrix host arrays and (after one full
    upload) device tensors equal the first's, and it places a burst, a
    system job and its restored blocked eval through the kernels.  Its
    clean shutdown writes a snapshot a third server restores alone; that
    image is then installed into a running server whose matrix is already
    on the card, which places a system job and a burst on it."""
    import collections

    import torch

    from nomad_tpu_torch.ops import kernels as k
    from nomad_tpu_torch.server.server import Server
    from nomad_tpu_torch.state.wal import WriteAheadLog

    exporter, shipper = system_jobs()
    tmp = tempfile.mkdtemp(prefix="nomad-restart-")
    data = str(Path(tmp) / "data")
    servers = []
    out = results.setdefault("restart", {})
    try:
        # 0. The journaled run's baseline: the same cluster and burst on a
        # server without a data directory.
        base = Server(server_config(), device="cuda")
        servers.append(base)
        base.start()
        t0 = time.perf_counter()
        register_cluster(base, "restart (no WAL)", preload=False)
        out["register_s"] = time.perf_counter() - t0
        evals, elapsed = burst(base, [restart_job("a", i)
                                      for i in range(SERVER_JOBS)])
        check_new_burst(base, set(), "restart-a-", "restart burst (no WAL)")
        out["burst_evals_per_s"] = SERVER_JOBS / elapsed
        out["burst_retried"] = retried_evals(base, evals)
        base.shutdown()

        # 1. The first server journals the work: 10,000 nodes, a 64-job
        # burst, node-exporter, and a job whose eval blocks.
        srv = Server(restart_config(data), device="cuda")
        servers.append(srv)
        srv.start()
        t0 = time.perf_counter()
        register_cluster(srv, "restart", preload=False)
        out["wal_register_s"] = time.perf_counter() - t0
        evals, elapsed = burst(srv, [restart_job("a", i)
                                     for i in range(SERVER_JOBS)])
        check_new_burst(srv, set(), "restart-a-", "restart burst (WAL)")
        out["wal_burst_evals_per_s"] = SERVER_JOBS / elapsed
        out["wal_burst_retried"] = retried_evals(srv, evals)
        run_system_job(srv, exporter, system_targets(
            srv, exporter, lambda n: True), "restart")
        srv.submit_job(huge_job())
        wait_quiet(srv, "restart: first server")
        if not any(e.status == "blocked" and e.job_id == "restart-huge-00"
                   for e in srv.store.evals.values()):
            raise AssertionError("restart: the huge job's eval did not block")
        n_entries = srv.store.wal.seq
        log(f"restart: WAL burst {SERVER_JOBS} jobs x {SERVER_COUNT} in "
            f"{elapsed:.3f} s = {out['wal_burst_evals_per_s']:.1f} evals/s "
            f"({out['wal_burst_retried']} retried), the same cluster's "
            f"burst without the WAL {out['burst_evals_per_s']:.1f} evals/s "
            f"({out['burst_retried']} retried); {N_NODES} registrations "
            f"{out['wal_register_s']:.3f} s with it, "
            f"{out['register_s']:.3f} s without; {n_entries} log entries, "
            f"{os.path.getsize(Path(data) / 'wal.jsonl')} bytes "
            f"(card: {card})")

        # 2. Crash-stop; bring the first server's device copy up to date.
        crash_stop(srv)
        src_arrays = srv.matrix.sync()
        image = srv.store.to_snapshot_wire()

        # 3. The second server restores from the log alone.
        t0 = time.perf_counter()
        srv2 = Server(restart_config(data), device="cuda")
        out["restore_wal_s"] = time.perf_counter() - t0
        servers.append(srv2)
        if srv2.store.to_snapshot_wire() != image:
            raise AssertionError("restart: restored tables differ")
        if srv2.store.latest_index != srv.store.latest_index:
            raise AssertionError("restart: restored latest index differs")
        host_equal(srv.matrix, srv2.matrix, "restart (WAL)")
        if srv2.matrix.full_uploads:
            raise AssertionError("restart: uploaded before the first sync")
        t0 = time.perf_counter()
        arrays2 = srv2.matrix.sync()
        torch.cuda.synchronize()
        out["full_upload_ms"] = (time.perf_counter() - t0) * 1e3
        if srv2.matrix.full_uploads != 1 or srv2.matrix.scatter_syncs:
            raise AssertionError("restart: the first sync was not one full "
                                 "upload")
        out["full_upload_bytes"] = srv2.matrix.upload_bytes_total
        for f, a in arrays2._asdict().items():
            if not tensors_equal(a, getattr(src_arrays, f)):
                raise AssertionError(f"restart: device column {f} differs "
                                     "from the first server's")
        log(f"restart: {len(srv2.store.nodes)} nodes, "
            f"{len(srv2.store.allocs)} allocs, {len(srv2.store.evals)} evals "
            f"restored from {n_entries} log entries in "
            f"{out['restore_wal_s']:.3f} s; first sync one full upload of "
            f"{out['full_upload_bytes']} bytes in {out['full_upload_ms']:.3f} "
            f"ms, every column equal to the first server's (card: {card})")

        # 4. The restored server places, counts zeroed just before.
        sub = srv2.store.events.subscribe()
        srv2.start()
        k.reset_counts()
        before = set(srv2.store.allocs)
        evals, elapsed = burst(srv2, [restart_job("b", i)
                                      for i in range(SERVER_JOBS)])
        check_new_burst(srv2, before, "restart-b-", "restored burst")
        out["restored_burst_evals_per_s"] = SERVER_JOBS / elapsed
        sys_s = run_system_job(
            srv2, shipper, system_targets(
                srv2, shipper,
                lambda n: n.datacenter == "dc1" and n.node_class != "class-3"),
            "restored")
        srv2.register_node(big_node())
        t0 = time.perf_counter()
        while [a.node_id for a in live_allocs(srv2, "restart-huge-00")] != [
                "restart-big"]:
            if time.perf_counter() - t0 > LIFECYCLE_TIMEOUT_S:
                raise AssertionError("restart: the restored blocked eval "
                                     "did not place on the big node")
            time.sleep(0.01)
        wait_quiet(srv2, "restored server")
        launches = path_launches(k)
        check_path_launches(launches, "restored server")
        out["restored_launches"] = launches
        mx = srv2.matrix
        out["scatters"] = {
            "syncs": mx.scatter_syncs, "rows": mx.rows_scattered_total,
            "bytes": mx.upload_bytes_total - out["full_upload_bytes"],
        }
        log(f"restart: restored server placed {SERVER_JOBS} jobs x "
            f"{SERVER_COUNT} at {out['restored_burst_evals_per_s']:.1f} "
            f"evals/s, log-shipper on its nodes in {sys_s:.3f} s, the "
            f"restored blocked eval on the big node; launches {launches}; "
            f"after the one full upload {mx.full_uploads - 1} more, "
            f"{mx.scatter_syncs} dirty-row scatters of "
            f"{mx.rows_scattered_total / max(1, mx.scatter_syncs):.1f} rows, "
            f"{out['scatters']['bytes']} bytes in all (card: {card})")

        # 5. Clean shutdown: a snapshot and an empty log; a third server
        # restores from the snapshot alone.
        srv2.shutdown()
        image2 = srv2.store.to_snapshot_wire()
        snap, entries = WriteAheadLog(data).load()
        if snap is None or entries:
            raise AssertionError(f"restart: shutdown left snapshot "
                                 f"{snap is not None}, {len(entries)} log "
                                 "entries")
        events = []
        while True:
            batch = sub.next(timeout=0.2)
            if not batch:
                break
            events.extend(batch)
        out["events_per_topic"] = dict(collections.Counter(
            e.topic for e in events))
        out["health"] = srv2.observatory.health_report()["status"]
        out["slo"] = {r["name"]: r["status"]
                      for r in srv2.observatory.slo_report()["slos"]}
        out["controller"] = srv2.overload_controller.report()["state"]
        t0 = time.perf_counter()
        srv3 = Server(restart_config(data), device="cuda")
        out["restore_snapshot_s"] = time.perf_counter() - t0
        servers.append(srv3)
        if srv3.store.to_snapshot_wire() != image2:
            raise AssertionError("restart: snapshot-restored tables differ")
        if {k_: v for k_, v in snap.items() if k_ != "wal_seq"} != image2:
            raise AssertionError("restart: the snapshot is not the image")
        host_equal(srv2.matrix, srv3.matrix, "restart (snapshot)")
        log(f"restart: snapshot of {os.path.getsize(Path(data) / 'snapshot.json')}"
            f" bytes restored in {out['restore_snapshot_s']:.3f} s; events "
            f"{out['events_per_topic']}; health {out['health']}, SLOs "
            f"{out['slo']}, controller {out['controller']} (card: {card})")

        # 6. Install the image into a running server whose matrix is on
        # the card; it places a system job and a burst on the new state.
        srv4 = Server(server_config(), device="cuda")
        servers.append(srv4)
        srv4.start()
        for i in range(512):
            node = server_node(i)
            node.id = node.name = f"other-{i:03d}"
            srv4.register_node(node)
        burst(srv4, [restart_job("c", i) for i in range(8)])
        old = srv4.matrix._device
        uploads = srv4.matrix.full_uploads
        t0 = time.perf_counter()
        srv4.install_snapshot(snap, seq=snap["wal_seq"])
        out["install_s"] = time.perf_counter() - t0
        if srv4.store.to_snapshot_wire() != image2:
            raise AssertionError("restart: installed tables differ")
        host_equal(srv2.matrix, srv4.matrix, "restart (install)")
        k.reset_counts()
        before = set(srv4.store.allocs)
        again = system_jobs()[0]
        again.id = again.name = "restart-exporter"
        again.task_groups[0].tasks[0].resources.networks[0].reserved_ports = [
            SYSTEM_PORT + 1]
        sys_s = run_system_job(srv4, again, system_targets(
            srv4, again, lambda n: True), "installed")
        evals, elapsed = burst(srv4, [restart_job("d", i)
                                      for i in range(SERVER_JOBS)])
        check_new_burst(srv4, before, "restart-d-", "installed burst")
        launches = path_launches(k)
        check_path_launches(launches, "installed server")
        if srv4.matrix.full_uploads != uploads + 1:
            raise AssertionError(
                f"restart: {srv4.matrix.full_uploads - uploads} full uploads "
                "after the install, expected one")
        cols = srv4.matrix._device
        if any(a is b for a, b in zip(cols, old)):
            raise AssertionError("restart: the install kept a device column")
        if not all(r() is t for r, t in zip(k._checked_matrix[0], cols)):
            raise AssertionError("restart: the kernels' memoised columns are "
                                 "not the installed matrix's")
        out["installed_launches"] = launches
        out["installed_burst_evals_per_s"] = SERVER_JOBS / elapsed
        log(f"restart: installed {len(srv4.store.nodes)} nodes into a running "
            f"server in {out['install_s']:.3f} s; one full upload after it; "
            f"restart-exporter on every node in {sys_s:.3f} s, a burst at "
            f"{out['installed_burst_evals_per_s']:.1f} evals/s; launches "
            f"{launches} (card: {card})")
    finally:
        for s_ in servers:
            s_.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# Phase 10: guarded and traced
# ---------------------------------------------------------------------------

# The service burst's jobs as an operator writes them (``service_job``'s
# shape), and node-exporter (``system_jobs``'s first).
SERVICE_HCL = """
job "{id}" {{
  name        = "my-job"
  type        = "service"
  priority    = 50
  datacenters = ["dc1", "dc2", "dc3", "dc4"]
  group "web" {{
    count = {count}
    task "web" {{
      driver = "mock"
      resources {{
        cpu    = {cpu}
        memory = {memory}
      }}
    }}
  }}
}}
"""
EXPORTER_HCL = """
# One metrics exporter on every node, on a static port.
job "node-exporter" {
  name        = "node-exporter"
  type        = "system"
  priority    = 100
  datacenters = ["dc1", "dc2", "dc3", "dc4"]
  group "system" {
    count = 0
    task "sys" {
      driver = "mock"
      resources {
        cpu    = 100
        memory = 64
        network {
          port "metrics" { static = 9100 }
        }
      }
    }
  }
}
"""
SUBMIT_POLICY = 'namespace "default" { capabilities = ["submit-job"] }'
# Every eval of the burst carries these spans in its own trace;
# coalescer.launch is recorded once per dispatch on the dispatch thread.
EVAL_SPANS = ("broker.queue_wait", "eval.process", "worker.invoke_scheduler",
              "coalescer.queue_wait", "coalescer.device", "plan.submit",
              "plan.queue_wait", "plan.apply")
PHASE_TIMERS = ("broker.queue_wait", "coalescer.device", "coalescer.launch",
                "coalescer.queue_wait", "eval.process", "plan.apply",
                "plan.queue_wait", "plan.submit", "sched.dispatch",
                "sched.encode", "sched.feasibility", "worker.invoke_scheduler",
                "worker.wait_for_index")
# The wedge drill's breaker (NOMAD_TPU_DEVICE_* knobs) and reaper delay.
# No cooldown: with one, a canary whose verdict lands sooner than the
# cooldown after the half-open flip leaves the breaker half-open (and a
# drill whose jobs all place through such canaries ends there).
DRILL_KNOBS = {"NOMAD_TPU_DEVICE_DEADLINE_MS": "200",
               "NOMAD_TPU_DEVICE_WEDGE_FACTOR": "1.5",
               "NOMAD_TPU_DEVICE_PROBATION": "1",
               "NOMAD_TPU_DEVICE_COOLDOWN": "0"}
DRILL_UNBLOCK_DELAY_S = 3.0
DRILL_JOBS = 16
RETRY_INTERVAL_S = 2.0  # blocked retries after placement conflicts
# Bursts per comparison, in the order A, B, B, A, A, B, B, A.
PAIRED_ORDER = (0, 1, 1, 0, 0, 1, 1, 0)


def submit_as(srv, secret: str, job):
    """What the API's register route does: the caller's token must hold
    ``submit-job`` in the job's namespace."""
    if not srv.check_acl_capability(secret, "namespace", "submit-job",
                                    job.namespace):
        raise PermissionError(f"token may not submit {job.id}")
    return srv.submit_job(job)


def check_acls(srv) -> str:
    """Bootstrap once, a policy granting submit-job in default and a token
    holding it; returns the token's secret."""
    from nomad_tpu_torch.structs.types import ACLPolicy, ACLToken

    boot = srv.bootstrap_acl()
    try:
        srv.bootstrap_acl()
    except PermissionError:
        pass
    else:
        raise AssertionError("acl: a second bootstrap succeeded")
    srv.store.upsert_acl_policy(srv.next_index(), ACLPolicy(
        name="deployer", rules=SUBMIT_POLICY))
    token = ACLToken(name="deployer", type="client", policies=["deployer"])
    srv.store.upsert_acl_tokens(srv.next_index(), [token])
    verdicts = {
        "token in default": srv.check_acl_capability(
            token.secret_id, "namespace", "submit-job", "default"),
        "token in other": srv.check_acl_capability(
            token.secret_id, "namespace", "submit-job", "other"),
        "empty token": srv.check_acl_capability(
            "", "namespace", "submit-job", "default"),
        "unknown secret": srv.check_acl_capability(
            "not-a-secret", "namespace", "submit-job", "default"),
        "management in other": srv.check_acl_capability(
            boot.secret_id, "namespace", "submit-job", "other"),
    }
    want = {"token in default": True, "token in other": False,
            "empty token": False, "unknown secret": False,
            "management in other": True}
    if verdicts != want or srv.resolve_token("not-a-secret") is not None:
        raise AssertionError(f"acl: decisions {verdicts}")
    log(f"acl: bootstrapped once; decisions {verdicts}")
    return token.secret_id


def hcl_service_job(i: int, prefix: str):
    """The i-th burst job parsed from HCL; its API form must equal that of
    ``service_job(i)`` with the same id."""
    from nomad_tpu_torch.jobspec import job_to_api, parse_job

    want = service_job(i)
    want.id = f"{prefix}-{i:02d}"
    r = want.task_groups[0].tasks[0].resources
    job = parse_job(SERVICE_HCL.format(id=want.id, count=SERVER_COUNT,
                                       cpu=r.cpu, memory=r.memory_mb))
    if job_to_api(job) != job_to_api(want):
        raise AssertionError(f"hcl: {want.id} parses to another job")
    return job


def first_pass(srv, secret: str, jobs, timeout_s: float = 300.0):
    """Submit ``jobs`` with the token and time until each eval has run once
    (terminal, or failed into a blocked retry after placement conflicts);
    then wait for the retries.  Returns (evals, first-pass seconds)."""
    t0 = time.perf_counter()
    evals = [submit_as(srv, secret, job) for job in jobs]
    pending = {e.id for e in evals}
    while pending:
        if time.perf_counter() - t0 > timeout_s:
            raise AssertionError(f"{len(pending)} evals still open")
        pending = {eid for eid in pending
                   if not srv.store.eval_by_id(eid).terminal_status()}
        if pending:
            time.sleep(0.002)
    elapsed = time.perf_counter() - t0
    for job in jobs:
        while len(live_allocs(srv, job.id)) != job.task_groups[0].count:
            if time.perf_counter() - t0 > timeout_s:
                raise AssertionError(f"{job.id} not placed in full")
            time.sleep(0.01)
    return evals, elapsed


def check_spans(srv, evals, card: str, tmp: str) -> None:
    """Every eval's trace holds the service path's spans; each lane's
    device window holds a launch span; the registry has the phase timers;
    the health signals the plan-queue wait; the Perfetto export covers the
    burst; ``top`` renders the breaker's row."""
    import bisect

    from nomad_tpu_torch import trace
    from nomad_tpu_torch.obs import top
    from nomad_tpu_torch.obs.health import collect_signals

    recs = trace.dump()
    by = trace.traces_by_id(recs)
    launches = sorted((r["ts"], r["ts"] + r["dur"]) for r in recs
                      if r["name"] == "coalescer.launch")
    starts = [a for a, _ in launches]
    for ev in evals:
        mine = by.get(ev.id, [])
        missing = set(EVAL_SPANS) - {r["name"] for r in mine}
        if missing:
            raise AssertionError(f"trace: eval {ev.id} lacks {missing}")
        for r in mine:
            if r["name"] != "coalescer.device":
                continue
            i = bisect.bisect_left(starts, r["ts"])
            if i == len(launches) or launches[i][1] > r["ts"] + r["dur"]:
                raise AssertionError(f"trace: no launch inside eval "
                                     f"{ev.id}'s device window")
    snap = srv.metrics.snapshot()
    timers = {k[len("nomad.phase."):] for k in snap
              if k.startswith("nomad.phase.")}
    if set(PHASE_TIMERS) - timers:
        raise AssertionError(f"trace: phase timers lack "
                             f"{set(PHASE_TIMERS) - timers}")
    signals = collect_signals(srv)
    if "plan_queue_wait_p99_ms" not in signals:
        raise AssertionError(f"health: signals {sorted(signals)}")
    path = trace.dump_flight_record(path=str(Path(tmp) / "burst.json"),
                                    reason="chip-smoke")
    doc = json.loads(Path(path).read_text())
    covered = {e["args"]["trace"] for e in doc["traceEvents"]
               if e.get("ph") == "X"}
    if not {ev.id for ev in evals} <= covered:
        raise AssertionError("trace: the export misses evals of the burst")
    srv.observatory.tick()
    screen = top.render(snap, srv.observatory.slo_report(),
                        srv.observatory.health_report(),
                        overload=srv.overload_controller.report())
    rows = [ln for ln in screen.splitlines() if ln.startswith("device  :")]
    if not rows or "closed" not in rows[0]:
        raise AssertionError(f"top: no closed breaker row in\n{screen}")
    p = {k: snap["nomad.phase." + k]["p50_ms"] for k in
         ("coalescer.queue_wait", "coalescer.launch", "coalescer.device",
          "plan.queue_wait", "plan.apply", "eval.process")}
    log(f"trace: {len(recs)} records, {len(by)} traces, {len(launches)} "
        f"launch spans; every eval of the burst has {len(EVAL_SPANS)} "
        f"spans in its trace; {len(timers)} phase timers, p50 ms "
        f"{ {k: round(v, 3) for k, v in p.items()} }; export "
        f"{len(doc['traceEvents'])} events, {os.path.getsize(path)} bytes "
        f"(card: {card})")
    log("top: " + rows[0])


def thread_wait_fetch(ticket, deadline: float, factor: float):
    """The reference's way to wait for a ticket under the watchdog: on
    ``watchdog_fetch``'s sacrificial thread, which synchronises on the
    ticket's event (no thread when the event is already complete); a
    stand-in for ``DeviceCoalescer._wait_fetch``, which polls the event,
    for the comparison bursts."""
    from nomad_tpu_torch.obs.breaker import STALL_OK, watchdog_fetch

    event = ticket.done_event
    if event is None or event.query():
        return STALL_OK, ticket.host.numpy(), 0.0

    def fetch():
        event.synchronize()
        return ticket.host.numpy()

    return watchdog_fetch(fetch, deadline, factor)


def paired_bursts(srv, secret: str, label: str, a, b, prefix: str) -> dict:
    """Bursts of SERVER_JOBS jobs under setting ``a`` and ``b`` in the
    order of PAIRED_ORDER (``a``/``b`` are (name, apply) pairs);
    first-pass evals/s of each, and the retries they left."""
    got = {a[0]: [], b[0]: []}
    for n, (name, apply) in enumerate((a, b)[i] for i in PAIRED_ORDER):
        apply()
        jobs = [hcl_service_job(i, f"{prefix}{n}") for i in range(SERVER_JOBS)]
        evals, elapsed = first_pass(srv, secret, jobs)
        got[name].append((SERVER_JOBS / elapsed, retried_evals(srv, evals)))
    log(f"{label}: first-pass evals/s (retried) "
        + "; ".join(f"{k} {[(round(e, 1), r) for e, r in v]}"
                    for k, v in got.items()))
    return {k: [e for e, _ in v] for k, v in got.items()}


class NackCounter:
    """Counts the worker's "scheduler failed" log records by exception
    type (each is a nack) while installed, and keeps them off stderr."""

    def __init__(self):
        import logging

        self.counts: dict = {}
        self.logger = logging.getLogger("nomad_tpu_torch.server.worker")
        self.handler = logging.Handler()
        self.handler.emit = self._emit
        self.logger.addHandler(self.handler)
        self.propagate = self.logger.propagate
        self.logger.propagate = False

    def _emit(self, record) -> None:
        name = record.exc_info[1].__class__.__name__ if record.exc_info \
            else "none"
        self.counts[name] = self.counts.get(name, 0) + 1

    def close(self) -> None:
        self.logger.removeHandler(self.handler)
        self.logger.propagate = self.propagate


def spin_cycles_per_ms() -> float:
    """``torch.cuda._sleep`` cycles per millisecond, from CUDA events."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    rates = []
    for _ in range(3):
        start.record()
        torch.cuda._sleep(50_000_000)
        end.record()
        end.synchronize()
        rates.append(50_000_000 / start.elapsed_time(end))
    return statistics.median(rates)


def upload_while_spinning(rate: float, card: str) -> dict:
    """How long an upload of the (lanes, N) tg counts takes to return
    while the stream runs a 300 ms spin: from pageable memory, and through
    a page-locked copy as the coalescer does."""
    import torch

    host = np.zeros((LANES, CAPACITY), np.int32)
    out = {}
    for name, make in (("pageable", lambda: torch.from_numpy(host)),
                       ("page-locked",
                        lambda: torch.from_numpy(host).pin_memory())):
        torch.cuda.synchronize()
        torch.cuda._sleep(int(rate * 300))
        t0 = time.perf_counter()
        make().to("cuda", non_blocking=True)
        out[name] = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
    log(f"drill: a {host.nbytes}-byte upload behind a 300 ms spin returns "
        f"after {out['pageable']:.3f} ms from pageable memory, "
        f"{out['page-locked']:.3f} ms through a page-locked copy "
        f"(card: {card})")
    return out


def wedge_drill(card: str, out: dict) -> None:
    """A server whose breaker has a 200 ms deadline: a spin on the card's
    stream ahead of a dispatch in the slow band gives a slow verdict whose
    placements are used; a longer one wedges a dispatch, trips the
    breaker, which refuses dispatches while open (their evals are nacked),
    and closes through its canary; every job is placed in full after."""
    import torch

    from nomad_tpu_torch.obs.breaker import BREAKER_CLOSED
    from nomad_tpu_torch.ops import kernels as k
    from nomad_tpu_torch.server.server import Server

    cfg = server_config()
    cfg.failed_eval_unblock_delay = DRILL_UNBLOCK_DELAY_S
    cfg.failed_eval_unblock_interval = RETRY_INTERVAL_S
    saved = {name: os.environ.get(name) for name in DRILL_KNOBS}
    os.environ.update(DRILL_KNOBS)
    try:
        srv = Server(cfg, device="cuda")
    finally:
        for name, value in saved.items():
            if value is None:
                os.environ.pop(name, None)
            else:
                os.environ[name] = value
    coal = srv.coalescer
    brk = coal.breaker
    deadline_ms = brk.cfg.deadline_ms
    bound_ms = deadline_ms * brk.cfg.wedge_factor
    # The breaker's verdict on each dispatch, and the launches: every
    # launch must follow an admitting verdict.
    verdicts, launched = [], []
    allow, dispatch = brk.allow_device_dispatch, coal._dispatch

    def watched_allow(*a, **kw):
        verdicts.append(allow(*a, **kw))
        return verdicts[-1]

    def watched_dispatch(batch):
        launched.append(len(batch))
        return dispatch(batch)

    brk.allow_device_dispatch = watched_allow
    coal._dispatch = watched_dispatch
    srv.start()
    nacks = NackCounter()
    try:
        register_cluster(srv, "drill", preload=False)
        secret = ""  # ACLs are off on this server
        first_pass(srv, secret, [hcl_service_job(i, "drill-w")
                                 for i in range(DRILL_JOBS)])
        rate = spin_cycles_per_ms()
        out["upload_ms"] = upload_while_spinning(rate, card)
        k.reset_counts()

        # Slow: a spin that ends inside (deadline, deadline x factor] of
        # the dispatch's wait (the wait starts a few ms after the spin).
        slows = brk.slows_total
        spin_ms = (deadline_ms + bound_ms) / 2 + 10.0
        coal.run_device_op(lambda: torch.cuda._sleep(int(rate * spin_ms)))
        job = hcl_service_job(0, "drill-slow")
        first_pass(srv, secret, [job])
        if brk.slows_total != slows + 1 or brk.state != BREAKER_CLOSED:
            raise AssertionError(f"drill: a {spin_ms:.0f} ms spin gave "
                                 f"{brk.report()['outcomes']}")
        log(f"drill: a {spin_ms:.0f} ms spin ahead of a dispatch gave a slow "
            f"verdict; its {SERVER_COUNT} placements were used")

        # Wedge: the spin outlasts the wedge bound twice over.
        spin_ms = 2 * bound_ms
        t_spin = time.time()
        coal.run_device_op(lambda: torch.cuda._sleep(int(rate * spin_ms)))
        jobs = [hcl_service_job(i, "drill") for i in range(DRILL_JOBS)]
        for j in jobs:
            srv.submit_job(j)
        t0 = time.perf_counter()
        while any(len(live_allocs(srv, j.id)) != SERVER_COUNT for j in jobs):
            if time.perf_counter() - t0 > LIFECYCLE_TIMEOUT_S:
                raise AssertionError("drill: jobs not placed after the wedge")
            time.sleep(0.005)
        t_last = time.time()
        wait_quiet(srv, "drill")
        report = brk.report()
        path = [(d["from"], d["to"], d["at"]) for d in report["decisions"]]
        trip = next((at for f, t, at in path if t == "open"), None)
        close = next((at for f, t, at in path
                      if f == "half_open" and t == "closed"), None)
        health = srv.observatory.tick()["device"]
        launches = path_launches(k)
        gauge = srv.metrics.snapshot()["nomad.coalescer.wedged_dispatches"]
        if (trip is None or close is None or close < trip
                or report["state"] != BREAKER_CLOSED):
            raise AssertionError(f"drill: breaker path {path}")
        if coal.wedged_dispatches < 1 or gauge < 1 or health["trips"] < 1:
            raise AssertionError(f"drill: wedged {coal.wedged_dispatches}, "
                                 f"gauge {gauge}, health {health}")
        if nacks.counts.get("DeviceWedgedError", 0) < 1:
            raise AssertionError(f"drill: nacks {nacks.counts}")
        admitted = sum(1 for ok, _ in verdicts if ok)
        refused = len(verdicts) - admitted
        if len(launched) != admitted or refused != report[
                "degraded_dispatches"] or refused < 1:
            raise AssertionError(f"drill: {len(launched)} launches, "
                                 f"{admitted} admitted, {refused} refused")
        if launches["plain"] or launches["fused_place"] <= 0:
            raise AssertionError(f"drill: launches {launches}")
        failed = sum(1 for e in srv.store.evals.values()
                     if e.status == "failed" and e.job_id.startswith("drill-"))
        out.update({
            "spin_to_trip_s": trip - t_spin, "trip_to_close_s": close - trip,
            "spin_to_last_placement_s": t_last - t_spin,
            "wedged_dispatches": coal.wedged_dispatches,
            "refused_dispatches": report["degraded_dispatches"],
            "nacks": dict(nacks.counts), "failed_evals": failed,
            "path": [(f, t) for f, t, _ in path], "launches": launches,
        })
        log(f"drill: a {spin_ms:.0f} ms spin; trip {trip - t_spin:.3f} s "
            f"after it, closed {close - trip:.3f} s after the trip, the last "
            f"of {DRILL_JOBS} jobs placed {t_last - t_spin:.3f} s after the "
            f"spin; breaker {out['path']}; {coal.wedged_dispatches} wedged "
            f"dispatches, {report['degraded_dispatches']} refused, nacks "
            f"{nacks.counts}, {failed} evals failed into reaper follow-ups; "
            f"health device {health}; launches {launches} (card: {card})")
    finally:
        nacks.close()
        srv.shutdown()


def phase_guarded(card: str, results: dict) -> None:
    """ACLs, HCL jobs, spans and their exports on a server of the server
    phase's shape; the burst with tracing on and off, and with the
    resolver polling and waiting on a sacrificial thread; then the wedge
    drill."""
    from nomad_tpu_torch import trace
    from nomad_tpu_torch.jobspec import job_to_api, parse_job
    from nomad_tpu_torch.ops import kernels as k
    from nomad_tpu_torch.server.server import Server

    out = results.setdefault("guarded", {})
    tmp = tempfile.mkdtemp(prefix="nomad-trace-")
    srv = None
    try:
        cfg = server_config()
        cfg.acl_enabled = True
        cfg.failed_eval_unblock_interval = RETRY_INTERVAL_S
        srv = Server(cfg, device="cuda")
        srv.start()
        secret = check_acls(srv)
        register_cluster(srv, "guarded")

        # The HCL burst and node-exporter, submitted with the token.
        exporter = parse_job(EXPORTER_HCL)
        if job_to_api(exporter) != job_to_api(system_jobs()[0]):
            raise AssertionError("hcl: node-exporter parses to another job")
        jobs = [hcl_service_job(i, "hcl") for i in range(SERVER_JOBS)]
        try:
            submit_as(srv, "", jobs[0])
        except PermissionError:
            pass
        else:
            raise AssertionError("acl: an empty token submitted a job")
        trace.configure(enabled=True)
        trace.clear()
        k.reset_counts()
        evals, elapsed = first_pass(srv, secret, jobs)
        counts = check_burst(srv, evals, "guarded burst")
        check_spans(srv, evals, card, tmp)
        # The nodes with room for it, counted before it places.
        want = system_targets(srv, exporter, lambda n: True)
        ev = submit_as(srv, secret, exporter)
        t0 = time.perf_counter()
        while not srv.store.eval_by_id(ev.id).terminal_status():
            if time.perf_counter() - t0 > LIFECYCLE_TIMEOUT_S:
                raise AssertionError("hcl: node-exporter eval not terminal")
            time.sleep(0.005)
        expect_system(srv, exporter, want, "guarded")
        launches = path_launches(k)
        check_path_launches(launches, "guarded")
        out.update({"hcl_evals_per_s": SERVER_JOBS / elapsed,
                    "retried": counts["retried"], "launches": launches})
        log(f"guarded: {SERVER_JOBS} HCL jobs submitted with the token, "
            f"{counts['allocs']} allocations ({counts['retried']} retried), "
            f"first pass {SERVER_JOBS / elapsed:.1f} evals/s; node-exporter "
            f"on its {len(live_allocs(srv, exporter.id))} nodes; launches "
            f"{launches} (card: {card})")

        out["tracing"] = paired_bursts(
            srv, secret, "tracing", ("on", lambda: trace.configure(
                enabled=True)), ("off", lambda: trace.configure(
                    enabled=False)), "tr")
        trace.configure(enabled=True)
        coal = srv.coalescer
        poll_wait = coal._wait_fetch
        out["wait"] = paired_bursts(
            srv, secret, "resolver wait",
            ("poll", lambda: setattr(coal, "_wait_fetch", poll_wait)),
            ("thread", lambda: setattr(coal, "_wait_fetch",
                                       thread_wait_fetch)),
            "wt")
        coal._wait_fetch = poll_wait
        srv.shutdown()
        srv = None
        wedge_drill(card, out)
    finally:
        trace.configure(enabled=True)
        if srv is not None:
            srv.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    try:
        import nomad_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here ({e})",
              file=sys.stderr)
        return 2

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # The observatory's breach dumps go to a temporary directory, removed
    # at the end.
    traces = tempfile.mkdtemp(prefix="nomad-smoke-traces-")
    os.environ["NOMAD_TPU_TRACE_DIR"] = traces
    try:
        return run_phases()
    finally:
        shutil.rmtree(traces, ignore_errors=True)


def run_phases() -> int:
    """Every phase, then the kernel table and the result line."""
    import torch

    card = card_line()
    log(f"card: {card}")
    t_start = time.perf_counter()
    results: dict = {}
    seconds: dict = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        log(f"phase {name}: {seconds[name]:.1f} s")
        return out

    timed("build", phase_build, card)
    t0 = time.perf_counter()
    m = build_cluster(N_NODES, CAPACITY, "cuda")
    batches = make_batches(m, "cuda")
    log(f"cluster: {N_NODES} nodes (capacity {CAPACITY}), batches of "
        f"{LANES} lanes x {SCAN} placements in "
        f"{time.perf_counter() - t0:.2f} s; features "
        f"{tuple(batches[0].features)} / {tuple(batches[1].features)}")
    timed("kernels", phase_kernels, batches, results)
    timed("solo", phase_solo, batches[1], results)
    timed("place_batch", phase_place_batch, batches, card, results)
    timed("edge shapes", phase_edge_shapes, results)
    timed("system kernel", phase_system_kernel, m, results)
    recorder = HostVerifyRecorder()
    try:
        timed("server", phase_server, card, results, recorder)
    finally:
        recorder.close()
    timed("staged server", phase_staged_server, card, results)
    timed("timing", phase_timing, batches[0], card, results)
    timed("system timing", phase_system_timing, m, card, results)
    # A fresh bench-shaped cluster: phase 2 left three rows nearly full.
    timed("batched scoring", phase_batched_scoring,
          build_cluster(N_NODES, CAPACITY, "cuda"), card, results)
    timed("plan verify", phase_plan_verify, card, m, recorder, results)
    timed("restart", phase_restart, card, results)
    timed("guarded", phase_guarded, card, results)
    fused, staged = results["server"], results["staged_server"]
    log(f"bursts: fused {fused['evals_per_s']:.1f} evals/s, "
        f"{fused['refused']} refusals, {fused['retried']} retried; staged "
        f"{staged['evals_per_s']:.1f} evals/s, {staged['refused']} "
        f"refusals, {staged['retried']} retried (card: {card})")
    restart = results["restart"]
    log(f"restart: WAL burst {restart['wal_burst_evals_per_s']:.1f} evals/s "
        f"(the same cluster's burst without it "
        f"{restart['burst_evals_per_s']:.1f}); "
        f"restore {restart['restore_wal_s']:.3f} s from the log, "
        f"{restart['restore_snapshot_s']:.3f} s from the snapshot; "
        f"install {restart['install_s']:.3f} s; first sync "
        f"{restart['full_upload_bytes']} bytes in "
        f"{restart['full_upload_ms']:.3f} ms (card: {card})")

    sources = {
        "fused_place": ("nomad_tpu_torch/ops/csrc/fused_place.cu",
                        "nomad_tpu/ops/kernels.py:968"),
        "place_batch": ("nomad_tpu_torch/ops/csrc/fused_place.cu",
                        "nomad_tpu/ops/kernels.py:817"),
        "allocs_fit_verify": ("nomad_tpu_torch/ops/csrc/allocs_fit_verify.cu",
                              "nomad_tpu/ops/kernels.py:1026"),
        "system_feasible": ("nomad_tpu_torch/ops/csrc/system_feasible.cu",
                            "nomad_tpu/ops/kernels.py:289"),
        "score_batch": ("nomad_tpu_torch/ops/csrc/score_batch.cu",
                        "nomad_tpu/ops/kernels.py:627"),
        "verify_plan_fit": ("nomad_tpu_torch/ops/csrc/verify_plan_fit.cu",
                            "nomad_tpu/ops/kernels.py:1077"),
    }
    table = []
    for name, (src, replaces) in sources.items():
        r = results.get(name, {})
        table.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": r.get("launches"),
            "max_abs_err": r.get("max_abs_err"), "ms": r.get("ms"),
            "plain_ms": r.get("plain_ms"), "bound_ms": r.get("bound_ms"),
            "bound_by": r.get("bound_by"), "library_ms": r.get("library_ms"),
            "solo_run": r.get("solo_run"), "device_us": r.get("device_us"),
            "launch": r.get("launch"), "host_us": r.get("host_us"),
            "host_split_us": r.get("host_split_us"),
            "cases": r.get("cases"),
            "matches_plain": r.get("matches_plain", False),
        })
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    log(card)
    log(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
