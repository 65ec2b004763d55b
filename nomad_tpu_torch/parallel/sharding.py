"""The node-sharded dispatch (K9) over an ordered list of devices.

The port's counterpart of the JAX package's ``nomad_tpu/parallel/
sharding.py``.  There a ``jax.sharding.Mesh`` with axes ``('batch',
'node')`` splits the cluster matrix's node axis over the devices of one
process, every shard scores its own rows, and only the per-placement
argmax crosses shards (``pmax``/``pmin``/``psum``/``all_gather``).  Here
the mesh is an ordered list of ``torch.device``s shaped the same way
(:func:`make_mesh`), and:

* each node shard's slice of the matrix lives on its device
  (:func:`shard_matrix_arrays`), kept resident by ``NodeMatrix.
  sync_sharded`` with one ``index_copy_`` per field into the owning
  shard's tensors (:func:`make_sharded_row_scatter`);
* the three programs (:func:`sharded_schedule_step`,
  :func:`sharded_place_batch`, :func:`sharded_fused_place_batch`) run
  the ``sharded_place`` kernel (``ops/kernels.py``
  :func:`~nomad_tpu_torch.ops.kernels.sharded_place`), one launch a card
  a step over every shard there, the shards of a card sharing one offer
  table and offers copied only between cards, and the fused one
  re-verifies the winners with the row-windowed ``allocs_fit_verify``
  on every node shard, the verdicts combined by the lead shard's launch.

Batch shards are data parallel: lanes ``[i·B/b, (i+1)·B/b)`` run on the
node shards of batch row ``i``, whose devices each hold a copy of their
node slice.  A device may appear more than once in a mesh: virtual
shards, the counterpart of the reference's virtual CPU devices, with a
table and tensors of their own each.

Tie-breaks: every program picks the highest score, then the lowest
global row, as the unsharded kernels do.  The reference's
``_step_local`` gives ties to the highest row instead (ROADMAP R8); the
port does not copy that.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device, upload
from ..ops import kernels
from ..ops.encode import SchedRequest, pow2_bucket
from ..ops.kernels import (
    FULL_FEATURES,
    Features,
    ShardLanes,
    pack_requests,
)
from ..state.matrix import DeviceArrays, host_to_tensor

# Hierarchical top-k width: each node shard offers its k best rows.  k = 1
# keeps exact argmax parity (the global winner is some shard's maximum,
# and each shard's offer is its lowest row among its maxima).
TOPK_K = 1


def _stack(reqs: Sequence[SchedRequest]) -> SchedRequest:
    return SchedRequest(*[np.stack(f) for f in zip(*reqs)])


def stack_requests(reqs: Sequence[SchedRequest]) -> SchedRequest:
    """Stack B per-eval requests into one batched request (leading B axis).

    Trailing padding in the per-predicate dimensions (constraints,
    affinities, static ports, datacenters) is narrowed to the batch's
    actual maximum, pow2-bucketed, as the reference does for its gathers.
    The kernels take the full-width packed form instead
    (:func:`build_batch_inputs`); narrowing changes no result, since the
    dropped slots are all inactive."""
    stacked = _stack(reqs)

    def width(active: np.ndarray, cap: int) -> int:
        count = int(active.sum(axis=1).max()) if len(active) else 0
        return min(cap, pow2_bucket(max(1, count)))

    cw = width(stacked.c_slot >= 0, stacked.c_slot.shape[1])
    aw = width(stacked.a_slot >= 0, stacked.a_slot.shape[1])
    pw = width(stacked.p_static >= 0, stacked.p_static.shape[1])
    dw = width(stacked.dc_hash != 0, stacked.dc_hash.shape[1])
    return stacked._replace(
        c_slot=stacked.c_slot[:, :cw],
        c_op=stacked.c_op[:, :cw],
        c_hash=stacked.c_hash[:, :cw],
        c_num=stacked.c_num[:, :cw],
        a_slot=stacked.a_slot[:, :aw],
        a_op=stacked.a_op[:, :aw],
        a_hash=stacked.a_hash[:, :aw],
        a_num=stacked.a_num[:, :aw],
        a_weight=stacked.a_weight[:, :aw],
        p_static=stacked.p_static[:, :pw],
        dc_hash=stacked.dc_hash[:, :dw],
    )


def build_batch_inputs(matrix, requests: Sequence[SchedRequest],
                       device="cuda") -> dict:
    """The batched operands ``score_batch`` takes, for B evals with no
    in-flight plan state, as tensors on ``device``: zero TG counts and
    spread counts, no penalties, all classes eligible, no host mask, and
    the requests packed (``req_i``/``req_f``, :func:`pack_requests`).
    ``reqs`` is the stacked numpy request of :func:`stack_requests`.  The
    class-eligibility width is ``pow2_bucket`` of the matrix's class
    count, as in the reference."""
    dev = resolve_device(device)
    b = len(requests)
    n = matrix.capacity
    pad = pow2_bucket(max(1, len(matrix.class_ids)))
    ri, rf = pack_requests(_stack(requests))
    return dict(
        reqs=stack_requests(requests),
        req_i=torch.from_numpy(ri).to(dev),
        req_f=torch.from_numpy(rf).to(dev),
        tg_counts=torch.zeros((b, n), dtype=torch.int32, device=dev),
        spread_counts=torch.zeros(
            (b,) + np.asarray(requests[0].s_value_hash).shape,
            dtype=torch.float32, device=dev),
        penalties=torch.zeros((b, n), dtype=torch.bool, device=dev),
        class_eligs=torch.ones((b, pad), dtype=torch.bool, device=dev),
        host_masks=torch.ones((b, n), dtype=torch.bool, device=dev),
    )


# ---------------------------------------------------------------------------
# The mesh
# ---------------------------------------------------------------------------


class Mesh:
    """An ordered grid of devices with axes ``('batch', 'node')``:
    ``devices[i][j]`` holds node shard ``j`` for the lanes of batch row
    ``i``.  A device may appear more than once (virtual shards)."""

    axis_names = ("batch", "node")

    def __init__(self, devices: Sequence[Sequence[torch.device]]):
        rows = tuple(tuple(r) for r in devices)
        if not rows or not rows[0] or len({len(r) for r in rows}) != 1:
            raise ValueError("a mesh is a non-empty rectangle of devices")
        types = {d.type for r in rows for d in r}
        if len(types) != 1:
            raise ValueError(f"a mesh holds one device type, got {types}")
        self.devices = rows

    @property
    def shape(self) -> Tuple[int, int]:
        return len(self.devices), len(self.devices[0])

    @property
    def lead(self) -> torch.device:
        """Where a dispatch's result is gathered: the first device."""
        return self.devices[0][0]

    def flat(self) -> List[torch.device]:
        return [d for r in self.devices for d in r]

    def __repr__(self) -> str:
        b, n = self.shape
        return f"Mesh(batch={b}, node={n}, devices={[str(d) for d in self.flat()]})"


def visible_devices() -> List[torch.device]:
    """Every visible card; raises when there is none."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass devices= "
                           "(for example ['cpu'] * 8) to shard on the CPU")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(n_devices: Optional[int] = None, batch: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """A ``('batch', 'node')`` mesh over the first ``n_devices`` of
    ``devices`` (default: every visible card).

    ``batch`` defaults to 2 when the count is even (so both axes get
    exercised), else 1, as in the reference.  ``devices`` may name one
    device more than once: ``['cuda:0'] * 4`` is four virtual shards of
    one card, ``['cpu'] * 8`` eight of the CPU.  A CUDA device without a
    card raises."""
    devs = (visible_devices() if devices is None
            else [resolve_device(d) for d in devices])
    n = n_devices if n_devices is not None else len(devs)
    if n < 1 or len(devs) < n:
        raise ValueError(f"requested {n} devices but only {len(devs)} given")
    if batch is None:
        batch = 2 if n % 2 == 0 and n >= 2 else 1
    if n % batch:
        raise ValueError(f"{n} devices not divisible by batch={batch}")
    per = n // batch
    return Mesh([devs[i * per:(i + 1) * per] for i in range(batch)])


def node_shard_count(mesh: Mesh) -> int:
    """Width of the mesh's node axis — the number of home shards the
    matrix partitions rows across when this mesh is live (the number an
    evacuation shrinks, ``NodeMatrix.relayout_shards``)."""
    return mesh.shape[1]


def device_list(device) -> Optional[List[torch.device]]:
    """``device`` as a list of devices when it names several (a list or
    tuple), else None (one device)."""
    if isinstance(device, (list, tuple)):
        return [resolve_device(d) for d in device]
    return None


# ---------------------------------------------------------------------------
# The sharded matrix
# ---------------------------------------------------------------------------


class ShardedArrays(NamedTuple):
    """The matrix laid out over a mesh: ``shards[i][j]`` is node shard
    ``j``'s rows ``[j·n_local, (j+1)·n_local)`` on device ``(i, j)``."""

    mesh: Mesh
    shards: Tuple[Tuple[DeviceArrays, ...], ...]
    n: int
    n_local: int

    @property
    def used(self):
        """Each shard's ``used`` rows, nested like ``shards``."""
        return tuple(tuple(a.used for a in row) for row in self.shards)

    def row_offset(self, shard: int) -> int:
        return shard * self.n_local


def _rows_to(field: str, x, lo: int, hi: int, dev: torch.device):
    """Rows ``[lo, hi)`` of a field (numpy host array or tensor) as a new
    contiguous tensor on ``dev``."""
    if isinstance(x, np.ndarray):
        return host_to_tensor(field, np.array(x[lo:hi], copy=True), dev)
    return x[lo:hi].to(dev, copy=True).contiguous()


def shard_matrix_arrays(mesh: Mesh, arrays) -> ShardedArrays:
    """Lay the matrix out across the mesh's node axis: per node shard its
    rows of every column, copied to each of that shard's devices.
    ``arrays`` is a :class:`DeviceArrays` of tensors, or of the host's
    numpy arrays (``port_words`` as ``uint32``).  The row count must
    divide by the node-shard count."""
    n = int(arrays.totals.shape[0])
    n_batch, n_node = mesh.shape
    if n % n_node:
        raise ValueError(f"{n} rows do not divide over {n_node} node shards")
    n_local = n // n_node
    shards = []
    for i in range(n_batch):
        row = []
        for j in range(n_node):
            lo, hi = j * n_local, (j + 1) * n_local
            dev = mesh.devices[i][j]
            row.append(DeviceArrays(*(
                _rows_to(f, x, lo, hi, dev)
                for f, x in zip(DeviceArrays._fields, arrays))))
        shards.append(tuple(row))
    return ShardedArrays(mesh, tuple(shards), n, n_local)


def make_sharded_row_scatter(mesh: Mesh):
    """The dirty-row scatter into a mesh-resident matrix (K7 across
    shards).  ``scatter(sharded, rows, row_data)`` writes ``row_data[f]``
    (the host's rows ``rows`` of field ``f``, numpy) into the shard that
    owns each row, on every device that holds that shard: one
    ``index_copy_`` per field, in place on the device's current stream,
    so a launch queued before it still reads the rows it was launched
    against.  Returns ``sharded``."""

    def scatter(sharded: ShardedArrays, rows: np.ndarray, row_data: dict):
        if sharded.mesh is not mesh:
            raise ValueError("sharded matrix of another mesh")
        rows = np.asarray(rows, np.int64)
        for j in range(mesh.shape[1]):
            lo = sharded.row_offset(j)
            sel = np.nonzero((rows >= lo) & (rows < lo + sharded.n_local))[0]
            if not len(sel):
                continue
            local = rows[sel] - lo
            part = {f: row_data[f][sel] for f in DeviceArrays._fields}
            for i in range(mesh.shape[0]):
                dev = mesh.devices[i][j]
                dst = sharded.shards[i][j]
                idx = torch.from_numpy(local).to(dev, non_blocking=True)
                for f in DeviceArrays._fields:
                    getattr(dst, f).index_copy_(
                        0, idx, host_to_tensor(f, part[f], dev))
        return sharded

    return scatter


# ---------------------------------------------------------------------------
# The programs
# ---------------------------------------------------------------------------


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _lane_groups(sharded: ShardedArrays, delta_rows, delta_vals, tg_counts,
                 spread_counts, penalties, req_i, req_f, class_eligs,
                 host_masks, lane_mask) -> List[List[ShardLanes]]:
    """Each batch row's lanes cut for each of its node shards, on the
    shard's device: the lanes ``[i·B/b, (i+1)·B/b)``, the node-axis
    inputs cut to the shard's rows."""
    mesh = sharded.mesh
    n_batch, n_node = mesh.shape
    b = int(req_i.shape[0])
    if b % n_batch:
        raise ValueError(f"{b} lanes do not divide over {n_batch} batch rows")
    per = b // n_batch
    ops = [_host(x) for x in (delta_rows, delta_vals, tg_counts,
                              spread_counts, penalties, req_i, req_f,
                              class_eligs, host_masks, lane_mask)]
    dr, dv, tg, sc, pen, ri, rf, ce, hm, lm = ops
    groups = []
    for i in range(n_batch):
        ln = slice(i * per, (i + 1) * per)
        # The lane-wide operands once a device: virtual shards of one
        # card read the same copy.
        lanes = {}
        row = []
        for j in range(n_node):
            dev = mesh.devices[i][j]
            lo = sharded.row_offset(j)
            cols = slice(lo, lo + sharded.n_local)
            if dev not in lanes:
                lanes[dev] = [upload(x[ln], dev)
                              for x in (dr, dv, sc, ri, rf, ce, lm)]
            ldr, ldv, lsc, lri, lrf, lce, llm = lanes[dev]
            row.append(ShardLanes(
                arrays=sharded.shards[i][j],
                row_offset=lo,
                delta_rows=ldr,
                delta_vals=ldv,
                tg_counts=upload(tg[ln, cols], dev),
                spread_counts=lsc,
                penalties=upload(pen[ln, cols], dev),
                req_i=lri,
                req_f=lrf,
                class_eligs=lce,
                host_masks=upload(hm[ln, cols], dev),
                lane_mask=llm,
            ))
        groups.append(row)
    return groups


def _on_devices(devs, *arrays) -> dict:
    """Arrays on the first of ``devs`` (uploaded once, unless a tensor
    already lies there) and copied from there to each other distinct
    device: ``{device: [tensors]}``."""
    first = devs[0]
    out = {first: [a if isinstance(a, torch.Tensor) and a.device == first
                   else upload(_host(a), first) for a in arrays]}
    for dev in devs[1:]:
        if dev not in out:
            out[dev] = [t.to(dev) for t in out[first]]
    return out


def _gather(mesh: Mesh, outs: List[torch.Tensor]) -> torch.Tensor:
    """The batch rows' results, in lane order, on the lead device."""
    if len(outs) == 1:
        return outs[0]
    return torch.cat([o.to(mesh.lead) for o in outs], dim=0)


def _place(sharded, delta_rows, delta_vals, tg_counts, spread_counts,
           penalties, req_i, req_f, class_eligs, host_masks, lane_mask,
           n_placements: int, features: Features) -> torch.Tensor:
    groups = _lane_groups(sharded, delta_rows, delta_vals, tg_counts,
                          spread_counts, penalties, req_i, req_f,
                          class_eligs, host_masks, lane_mask)
    outs = kernels.sharded_place(groups, n_placements, features)
    return _gather(sharded.mesh, outs)


def _all_live(req_i) -> np.ndarray:
    return np.ones((int(req_i.shape[0]),), bool)


def sharded_schedule_step(mesh: Mesh):
    """The sharded scheduling step (the reference's ``_step_local``): B
    independent evaluations against the shared ``used``, one pick each,
    every lane's node axis split over the mesh.

    Returns ``step(sharded, tg_counts, spread_counts, penalties, req_i,
    req_f, class_eligs, host_masks) -> (BatchScoreResult, used_after)``:
    the result on the lead device (``score_batch``'s fields), and each
    shard's usage with every pick's ask added, nested like
    ``sharded.shards`` (the picks summed in lane order per batch row, the
    rows' sums then added, as the reference's scatter and ``psum``: the
    ``sharded_usage`` kernel on each shard's device)."""

    def step(sharded: ShardedArrays, tg_counts, spread_counts, penalties,
             req_i, req_f, class_eligs, host_masks):
        if sharded.mesh is not mesh:
            raise ValueError("sharded matrix of another mesh")
        b = int(req_i.shape[0])
        packed = _place(
            sharded, np.full((b, 0), -1, np.int32),
            np.zeros((b, 0, 3), np.float32), tg_counts, spread_counts,
            penalties, req_i, req_f, class_eligs, host_masks, _all_live(req_i),
            1, FULL_FEATURES)
        res = kernels._batch_result(packed[:, 0])
        # Every pick's ask into the usage of the shard that owns its row,
        # on each shard's device: the packed picks and the asks go from
        # the lead to each other card once.
        n_batch, n_node = mesh.shape
        on = _on_devices([mesh.lead] + mesh.flat(), packed, req_f)
        used_after = tuple(
            tuple(
                kernels.sharded_usage(
                    sharded.shards[i][j].used, *on[mesh.devices[i][j]],
                    n_batch, sharded.row_offset(j))
                for j in range(n_node))
            for i in range(n_batch))
        return res, used_after

    return step


def sharded_place_batch(mesh: Mesh, n_placements: int):
    """The sharded twin of ``kernels.place_batch`` (the staged dispatch):
    ``fn(sharded, delta_rows, delta_vals, tg_counts, spread_counts,
    penalties, req_i, req_f, class_eligs, host_masks)`` with the lanes'
    operands as host arrays ((B, N) for the node-axis ones, delta rows
    global) returns the packed (B, P, PACKED_WIDTH) result on the lead
    device, every lane live, at full features.  Placements equal the
    unsharded kernel's exactly, tie-breaks included."""

    def fn(sharded: ShardedArrays, delta_rows, delta_vals, tg_counts,
           spread_counts, penalties, req_i, req_f, class_eligs, host_masks):
        if sharded.mesh is not mesh:
            raise ValueError("sharded matrix of another mesh")
        return _place(sharded, delta_rows, delta_vals, tg_counts,
                      spread_counts, penalties, req_i, req_f, class_eligs,
                      host_masks, _all_live(req_i), n_placements,
                      FULL_FEATURES)

    return fn


def sharded_fused_place_batch(mesh: Mesh, n_placements: int):
    """The sharded twin of ``kernels.fused_place_batch``: the ranking scan
    (hierarchical top-k with ``TOPK_K = 1``) and then the cross-lane
    AllocsFit re-verify, sharded.  ``fn(sharded, delta_rows, delta_vals,
    tg_counts, spread_counts, penalties, req_i, req_f, class_eligs,
    host_masks, lane_mask, features=FULL_FEATURES)`` returns the packed
    (B, P, FUSED_PACKED_WIDTH) result on the lead device.

    The verify replays all B lanes on every node shard (on its batch row
    0 device) against that shard's rows with ``allocs_fit_verify``'s row
    window: a pick on another shard's row fits vacuously.  The other
    shards' verdict columns are copied to the lead device, and the lead
    shard's launch folds them in last (their least verdict), so each
    row's owner alone decides."""

    def fn(sharded: ShardedArrays, delta_rows, delta_vals, tg_counts,
           spread_counts, penalties, req_i, req_f, class_eligs, host_masks,
           lane_mask, features: Features = FULL_FEATURES):
        if sharded.mesh is not mesh:
            raise ValueError("sharded matrix of another mesh")
        packed = _place(sharded, delta_rows, delta_vals, tg_counts,
                        spread_counts, penalties, req_i, req_f, class_eligs,
                        host_masks, lane_mask, n_placements, features)
        return sharded_verify(sharded, packed, req_f, delta_rows, delta_vals,
                              lane_mask)

    return fn


def sharded_verify(sharded: ShardedArrays, packed, req_f, delta_rows,
                   delta_vals, lane_mask) -> torch.Tensor:
    """The node-sharded AllocsFit verify of a packed (B, P, 7) result on
    the lead device: the windowed ``allocs_fit_verify`` on node shards
    1.. (each on its batch row 0 device), their verdict columns copied to
    the lead, and the lead shard's windowed launch with those columns.
    Returns (B, P, FUSED_PACKED_WIDTH) on the lead device."""
    mesh = sharded.mesh
    lead = mesh.lead
    n_node = mesh.shape[1]
    b, p = int(packed.shape[0]), int(packed.shape[1])
    on = _on_devices([lead] + [mesh.devices[0][j] for j in range(n_node)],
                     req_f, delta_rows, delta_vals, lane_mask)
    cols = None
    if n_node > 1:
        cols = torch.empty((n_node - 1, b, p), dtype=torch.float32,
                           device=lead)
        for j in range(1, n_node):
            dev = mesh.devices[0][j]
            arr = sharded.shards[0][j]
            rf, dr, dv, lm = on[dev]
            got = kernels.allocs_fit_verify(
                arr.totals, arr.used, packed.to(dev), rf, dr, dv, lm,
                row_offset=sharded.row_offset(j))
            cols[j - 1].copy_(got[:, :, kernels.FUSED_PACKED_VERIFIED],
                              non_blocking=True)
            if dev.type == "cuda" and dev != lead:
                ev = torch.cuda.Event()
                with torch.cuda.device(dev):
                    ev.record(torch.cuda.current_stream(dev))
                torch.cuda.current_stream(lead).wait_event(ev)
    arr = sharded.shards[0][0]
    rf, dr, dv, lm = on[lead]
    return kernels.allocs_fit_verify(
        arr.totals, arr.used, packed, rf, dr, dv, lm, row_offset=0,
        and_with=cols)
