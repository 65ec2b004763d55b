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
4. server — a ``Server(device="cuda")`` with 32 workers and 64 lanes:
   register 10,000 nodes, pre-load usage, submit 64 service jobs of count
   2, wait until every eval is terminal, and check the 128 placements.
   Every launch count is zeroed just before the jobs go in and read just
   after: both kernels must have launched, the plain version never.  Then,
   with the counts zeroed again, one distinct_hosts group of 56 whose plan
   outgrows 32 deltas: it must take the solo path, launch fused_place and
   never the plain version.  A last burst of 64 jobs runs under the CUDA
   profiler and prints the card's busy and idle share and its device time
   by activity.
5. timing — each kernel and its plain version at the phase-2 shape, timed
   with CUDA events (median of 20 launches after warm-up; the plain
   version's median of 3 runs), beside its bound: the larger of the bytes
   it must move over the card's memory rate and the float32 operations
   this batch needs over the card's float32 rate.

Prints the kernel table as one JSON line before the last, and ends with
``{"ok": true, "device": {...}}``.  Exits non-zero, printing no result,
when there is no CUDA device or when any phase fails.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

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
    from nomad_tpu_torch.ops.encode import MAX_SPREAD_VALUES
    from nomad_tpu_torch.state.matrix import PRIORITY_BUCKETS

    arrays, f, reqs = batch.arrays, batch.features, batch.np["reqs"]
    n = int(arrays.used.shape[0])
    live = np.asarray(batch.np["lane_mask"], bool)
    out = np.asarray(packed.cpu())
    rows = out[..., k.PACKED_ROW]
    evaluated = out[..., k.PACKED_EVALUATED].astype(np.int64)

    slots, num_slots, ver_slots, words = set(), set(), set(), set()
    ops = 0
    for lane in np.flatnonzero(live):
        c_slot, c_op = reqs.c_slot[lane], reqs.c_op[lane]
        a_slot, a_op = reqs.a_slot[lane], reqs.a_op[lane]
        s_slot = reqs.s_slot[lane]
        if int(reqs.dc_hash[lane][0]) != -1:
            slots.add(0)
        for slot, op in list(zip(c_slot, c_op))[:f.c_width] + list(
                zip(a_slot, a_op))[:f.a_width]:
            if slot < 0:
                continue
            slots.add(int(slot))
            if 2 <= op <= 5:
                num_slots.add(int(slot))
            elif op >= 8:
                ver_slots.add(int(slot))
        live_s = [int(s) for s in s_slot[:f.s_width] if s >= 0]
        slots.update(live_s)
        if f.ports:
            words.update(int(p) >> 5 for p in reqs.p_static[lane] if p >= 0)
        kb = int(np.clip(reqs.preempt_bucket[lane], 0, PRIORITY_BUCKETS))
        pre = f.preempt and int(reqs.preempt_bucket[lane]) >= 0

        c_num = sum(_is_numeric(int(o)) for s, o in zip(
            c_slot[:f.c_width], c_op[:f.c_width]) if s >= 0)
        a_live = [(s, o) for s, o in zip(a_slot[:f.a_width], a_op[:f.a_width])
                  if s >= 0]
        winner = (FIT_OPS + ANTI_AFFINITY_OPS + COMBINE_OPS
                  + (PREEMPT_TAIL_OPS if pre else 0))
        scored = (winner + (PREEMPT_BUCKET_OPS * kb if pre else 0)
                  + sum(AFFINITY_SLOT_OPS
                        + NUMERIC_PREDICATE_OPS * _is_numeric(int(o))
                        for _, o in a_live)
                  + (AFFINITY_TAIL_OPS if a_live else 0)
                  + SPREAD_VALUE_OPS * MAX_SPREAD_VALUES * len(live_s))
        step = 1 + (SPREAD_STEP_OPS * len(live_s) + 3 if live_s else 0)
        failed = np.flatnonzero(rows[lane, :n_placements] < 0)
        steps = int(failed[0]) + 1 if len(failed) else n_placements
        deltas = int((batch.np["delta_rows"][lane] >= 0).sum())
        ops += (n * NUMERIC_PREDICATE_OPS * c_num
                + int(evaluated[lane, 0]) * scored
                + int(evaluated[lane, :steps].sum()) * step
                + steps * winner + 3 * deltas)

    b_live = int(live.sum())
    matrix_bytes = n * (
        12 + 12 + 1 + 4  # totals, used, eligible, class_id
        + 4 * len(slots) + 4 * len(num_slots) + 4 * len(ver_slots)
        + (64 if np.any(np.asarray(reqs.dev_ask)[live] > 0) else 0)
        + (4 + 4 * len(words) if f.ports else 0)  # dyn_used, port words
        + (PRIORITY_BUCKETS * 12 if f.preempt else 0)  # prio_used
    )
    lane_bytes = b_live * sum(
        v[0].nbytes for name, v in batch.np.items()
        if name not in ("reqs", "lane_mask"))
    lane_bytes += live.nbytes + b_live * (
        batch.t["req_i"][0].numel() + batch.t["req_f"][0].numel()) * 4
    out_bytes = live.shape[0] * n_placements * k.PACKED_WIDTH * 4
    return matrix_bytes + lane_bytes + out_bytes, ops


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


def phase_server(card: str, results: dict) -> None:
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.ops import kernels as k
    from nomad_tpu_torch.server.server import Server, ServerConfig

    rng = np.random.default_rng(7)
    cfg = ServerConfig(num_workers=SERVER_WORKERS, coalescer_lanes=LANES,
                       node_capacity=CAPACITY)
    srv = Server(cfg, device="cuda")
    srv.start()
    try:
        t0 = time.perf_counter()
        for i in range(N_NODES):
            node = mock.node()
            node.node_class = f"class-{i % 6}"
            node.attributes = dict(node.attributes)
            node.attributes["rack"] = f"r{i % 32}"
            srv.register_node(node)
        with srv.matrix._host_lock:
            host = srv.matrix.snapshot_host()
            usage = np.round(rng.uniform(0.1, 0.6, (N_NODES, 3))
                             * host["totals"][:N_NODES])
            host["used"][:N_NODES] = usage
            srv.matrix._dirty.update(range(N_NODES))
            srv.matrix.version += 1
        log(f"server: {N_NODES} nodes registered in "
            f"{time.perf_counter() - t0:.2f} s")

        def make_job(i: int):
            job = mock.job()
            tg = job.task_groups[0]
            tg.count = SERVER_COUNT
            tg.tasks[0].resources.cpu = 50 + 25 * (i % 4)
            tg.tasks[0].resources.memory_mb = 64 + 32 * (i % 3)
            return job

        k.reset_counts()
        evals, elapsed = burst(srv, [make_job(i) for i in range(SERVER_JOBS)])
        launches = {
            "fused_place": k.fused_place.launches,
            "allocs_fit_verify": k.allocs_fit_verify.launches,
            "plain": k.place_lanes.calls + k.verify_lanes.calls,
        }
        statuses = {srv.store.eval_by_id(e.id).status for e in evals}
        allocs = [a for a in srv.store.allocs.values()
                  if not a.terminal_status()]
        log(f"server: {SERVER_JOBS} jobs x {SERVER_COUNT} in {elapsed:.3f} s = "
            f"{SERVER_JOBS / elapsed:.1f} evals/s, {len(allocs)} allocations, "
            f"eval statuses {sorted(statuses)}, "
            f"{srv.coalescer.dispatches} dispatches / "
            f"{srv.coalescer.fused_lanes} lanes (card: {card})")
        log(f"server: launches during the run {launches}")
        want = SERVER_JOBS * SERVER_COUNT
        if len(allocs) != want:
            raise AssertionError(f"{len(allocs)} allocations, expected {want}")
        # Placements are real: every alloc sits on a registered node whose
        # usage (pre-load plus its allocs) fits its capacity.
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
            raise AssertionError(f"allocs per job {sorted(set(per_job.values()))}")
        if launches["fused_place"] <= 0 or launches["allocs_fit_verify"] <= 0:
            raise AssertionError(f"a kernel never launched: {launches}")
        if launches["plain"] != 0:
            raise AssertionError(f"plain version ran on the card: {launches}")
        results["fused_place"]["launches"] = launches["fused_place"]
        results["allocs_fit_verify"]["launches"] = launches["allocs_fit_verify"]
        results["server"] = {
            "evals_per_s": SERVER_JOBS / elapsed, "seconds": elapsed,
            "dispatches": srv.coalescer.dispatches,
            "lanes": srv.coalescer.fused_lanes,
        }
        solo_run(srv, make_job, results)
        trace_burst(srv, [make_job(i) for i in range(SERVER_JOBS)], card)
    finally:
        srv.shutdown()


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


def burst(srv, jobs, timeout_s: float = 300.0):
    """Submit ``jobs`` and wait until every eval is terminal; returns
    (evals, seconds)."""
    t0 = time.perf_counter()
    evals = [srv.submit_job(job) for job in jobs]
    deadline = time.time() + timeout_s
    pending = {e.id for e in evals}
    while pending and time.time() < deadline:
        pending = {
            eid for eid in pending
            if not (srv.store.eval_by_id(eid) is not None
                    and srv.store.eval_by_id(eid).terminal_status())
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
    overlap twice, so the busy share is an upper bound."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, wall = burst(srv, jobs)
        torch.cuda.synchronize()
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
    log(f"server trace: {len(jobs)} jobs in {wall:.3f} s under the profiler; "
        f"device busy {busy_s * 1e3:.3f} ms = {100.0 * busy_s / wall:.2f}% "
        f"of the burst, idle {100.0 - 100.0 * busy_s / wall:.2f}% "
        f"(card: {card})")
    for us, count, key in sorted(rows, reverse=True)[:6]:
        log(f"  device {us / 1e3:9.3f} ms  x{count:<5d} {key[:70]}")


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
        plain_ms = time_cuda(plain, runs=3, warmup=1)
        b_ms, by = bound(*work)
        r = results[name]
        r.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
                 library_ms=None)
        log(f"timing {name}: {ms:.4f} ms (plain version {plain_ms:.3f} ms, "
            f"bound {b_ms:.5f} ms by {by}; {work[0]} bytes, {work[1]:.4g} ops; "
            f"card: {card})")


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
    card = card_line()
    log(f"card: {card}")
    t_start = time.perf_counter()
    results: dict = {}
    phase_build(card)
    t0 = time.perf_counter()
    m = build_cluster(N_NODES, CAPACITY, "cuda")
    batches = make_batches(m, "cuda")
    log(f"cluster: {N_NODES} nodes (capacity {CAPACITY}), batches of "
        f"{LANES} lanes x {SCAN} placements in "
        f"{time.perf_counter() - t0:.2f} s; features "
        f"{tuple(batches[0].features)} / {tuple(batches[1].features)}")
    phase_kernels(batches, results)
    phase_solo(batches[1], results)
    phase_server(card, results)
    phase_timing(batches[0], card, results)

    sources = {
        "fused_place": ("nomad_tpu_torch/ops/csrc/fused_place.cu",
                        "nomad_tpu/ops/kernels.py:968"),
        "allocs_fit_verify": ("nomad_tpu_torch/ops/csrc/allocs_fit_verify.cu",
                              "nomad_tpu/ops/kernels.py:1026"),
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
            "solo_run": r.get("solo_run"),
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
