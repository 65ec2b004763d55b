"""Card-resident cluster matrix — the node encoding every kernel reads.

The reference walks Go node objects per evaluation (BinPackIterator,
scheduler/rank.go:149-531) and bounds work via node sampling
(scheduler/stack.go:78-91) and a computed-class feasibility cache
(scheduler/feasible.go:1029). This framework inverts that design: the whole
cluster is encoded once into dense tensors resident in the card's memory,
and every
evaluation scores *all* nodes in one vectorized pass.

Encoding:
  totals    (N, 3) f32  — comparable resources (total − reserved): cpu/mem/disk
  used      (N, 3) f32  — sum over non-terminal allocs per node
  eligible  (N,)   bool — ready & eligible & not draining
  attr_hash (N, A) i32  — stable nonzero hash per registered attribute slot
                           (0 = attribute unset)
  attr_num  (N, A) f32  — numeric value of the attribute (NaN if non-numeric)
  attr_ver  (N, A) f32  — version packing major*1e6+minor*1e3+patch (NaN none)
  class_id  (N,)   i32  — computed-class id (reference: node_class.go:28-37);
                           host-side fallback constraint checks are evaluated
                           once per class and gathered per node
  dev_total (N, D) i32  — device instances per registered device-type slot
  dev_used  (N, D) i32
  prio_used (N, P, 3) f32 — per-priority-bucket resource usage, enabling the
                           vectorized preemption search (a prefix-sum over the
                           priority axis replaces the reference's greedy
                           candidate walk, scheduler/preemption.go:198-557)
  tg_count  (N,)   i32  — allocs of the *current* job+TG per node (scattered
                           before each eval batch; drives JobAntiAffinity)

Host-side, a mirror lives in numpy; mutations mark dirty rows and
``sync(device)`` writes only those rows into the resident torch tensors
(one ``index_copy_`` per field), so steady-state transfer is O(dirty rows).
A second resident copy may be laid out over a mesh of devices
(``sync_sharded``, the node-sharded dispatch of ``parallel/``): the rows
split into ``shard_count`` equal home-shard blocks, claims balance across
them, growth keeps each row's shard, and an evacuation re-lays every row
over the surviving shards.  ``save_encoded``/``load_encoded`` write and
read the encoded host matrix as an ``.npz`` file in the reference's
format, so a cluster encoded once (by either package) loads without
re-walking its nodes.
``port_words`` is ``uint32`` on the host and travels as an ``int32`` view
of the same bits: PyTorch's CPU kernels have no ``>>`` on ``uint32``, and
``(w >> b) & 1`` reads the same bit of either type for every b ≤ 31.
"""

from __future__ import annotations

import json
import math
import os
import threading
import zipfile
import zlib
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..lint import tsan
from ..structs.types import Allocation, Node

# All device interactions funnel through this lock. There is one card per
# scheduler process, so serializing kernel dispatch costs nothing, and the
# resident tensors are updated in place by sync(): one thread at a time.
# Reentrant so sync() nests inside a locked select().
DEVICE_LOCK = threading.RLock()

# Fixed encoding widths. Attribute slots beyond ATTR_SLOTS fall back to
# host-side per-class evaluation (the reference's own escape hatch).
ATTR_SLOTS = 32
DEVICE_SLOTS = 8
PRIORITY_BUCKETS = 16  # job priorities 1..100 bucketed by 100/PRIORITY_BUCKETS
RESOURCE_DIMS = 3  # cpu, mem, disk

# Port occupancy encoding (NetworkIndex equivalent, structs/network.go:35):
# one bit per port in [0, PORT_BITS) as uint32 words — matrix columns the
# kernel reads to mask static-port collisions; ports beyond PORT_BITS are
# host-checked only (rare). Dynamic allocation draws from
# [MIN_DYNAMIC_PORT, MAX_DYNAMIC_PORT] (structs/network.go port range).
PORT_WORDS = 1024
PORT_BITS = PORT_WORDS * 32  # 32768
MIN_DYNAMIC_PORT = 20000
MAX_DYNAMIC_PORT = 32000
DYN_PORT_CAPACITY = MAX_DYNAMIC_PORT - MIN_DYNAMIC_PORT + 1


def stable_hash(value: str) -> int:
    """Stable nonzero 31-bit hash of a string attribute value."""
    h = zlib.crc32(value.encode("utf-8")) & 0x7FFFFFFF
    return h if h != 0 else 1


def numeric_value(value: str) -> float:
    """Plain numeric interpretation of an attribute value, NaN otherwise.
    Used for ordered comparisons (``<``, ``>=``, …)."""
    try:
        return float(value)
    except (TypeError, ValueError):
        return math.nan


def version_value(value: str) -> float:
    """Version interpretation: 1-3 dot-separated integer components packed as
    major*1e6 + minor*1e3 + patch (missing components are 0); NaN otherwise.

    Kept separate from :func:`numeric_value` because strings like ``"2.0"``
    are both a valid decimal and a valid version — ``version``-operand
    comparisons read this column, ordered numeric comparisons read the plain
    one, and both sides of a comparison always use the same encoding.
    """
    if not isinstance(value, str):
        return math.nan
    v = value.strip()
    if v.startswith("v"):
        v = v[1:]
    parts = v.split(".")
    if not 1 <= len(parts) <= 3:
        return math.nan
    try:
        nums = [int(p) for p in parts]
    except ValueError:
        return math.nan
    while len(nums) < 3:
        nums.append(0)
    major, minor, patch = nums
    if minor >= 1000 or patch >= 1000 or major < 0 or minor < 0 or patch < 0:
        return math.nan
    return major * 1e6 + minor * 1e3 + patch


def priority_bucket(priority: int) -> int:
    """Map a job priority (1..100) to a preemption bucket."""
    p = min(max(int(priority), 0), 100)
    return min(p * PRIORITY_BUCKETS // 101, PRIORITY_BUCKETS - 1)


# Attributes excluded from the computed class because they are node-unique
# (reference: nomad/structs/node_class.go EscapedConstraints / unique prefix).
UNIQUE_PREFIX = "unique."


class AttributeRegistry:
    """Maps attribute names to matrix column slots.

    Well-known scheduling attributes are pre-registered so every cluster gets
    identical encodings; fingerprinted attributes claim remaining slots on
    first sight. Constraints on unregistered attributes escape to the
    host-side per-class path.
    """

    WELL_KNOWN = [
        "node.datacenter",
        "node.class",
        "node.unique.name",
        "node.unique.id",
        "kernel.name",
        "cpu.arch",
        "cpu.numcores",
        "os.name",
        "os.version",
        "driver.mock",
        "driver.exec",
        "driver.raw_exec",
        "driver.docker",
        "driver.java",
        "driver.qemu",
        "platform.tpu.type",
    ]

    def __init__(self, slots: int = ATTR_SLOTS):
        self.slots = slots
        self.slot_of: Dict[str, int] = {}
        for name in self.WELL_KNOWN:
            if len(self.slot_of) < slots:
                self.slot_of[name] = len(self.slot_of)

    def lookup(self, name: str) -> Optional[int]:
        return self.slot_of.get(name)

    def register(self, name: str) -> Optional[int]:
        slot = self.slot_of.get(name)
        if slot is not None:
            return slot
        if len(self.slot_of) >= self.slots:
            return None  # escaped — host fallback
        slot = len(self.slot_of)
        self.slot_of[name] = slot
        return slot


class DeviceRegistry:
    """Maps device-type names (e.g. ``nvidia/gpu`` or ``gpu``) to slots."""

    def __init__(self, slots: int = DEVICE_SLOTS):
        self.slots = slots
        self.slot_of: Dict[str, int] = {}

    def lookup(self, name: str) -> Optional[int]:
        return self.slot_of.get(name)

    def register(self, name: str) -> Optional[int]:
        slot = self.slot_of.get(name)
        if slot is not None:
            return slot
        if len(self.slot_of) >= self.slots:
            return None
        slot = len(self.slot_of)
        self.slot_of[name] = slot
        return slot


def node_attributes(node: Node) -> Dict[str, str]:
    """Flatten a node into the attribute namespace used by constraints
    (reference: scheduler/feasible.go resolveTarget :748-790)."""
    attrs: Dict[str, str] = {}
    attrs["node.datacenter"] = node.datacenter
    attrs["node.class"] = node.node_class
    attrs["node.unique.name"] = node.name
    attrs["node.unique.id"] = node.id
    for k, v in node.attributes.items():
        attrs[k] = v
    for k, v in node.meta.items():
        attrs[f"meta.{k}"] = v
        attrs[f"node.meta.{k}"] = v
    for name, info in node.drivers.items():
        attrs[f"driver.{name}"] = "1" if (info.detected and info.healthy) else ""
    return attrs


def computed_class_key(attrs: Dict[str, str], node: Node) -> str:
    """Class key over non-unique attributes (reference: node_class.go:28-37)."""
    items = sorted(
        (k, v)
        for k, v in attrs.items()
        if UNIQUE_PREFIX not in k and not k.startswith("node.unique")
    )
    items.append(("node.class", node.node_class))
    return str(zlib.crc32(repr(items).encode()))


class DeviceArrays(NamedTuple):
    """The resident snapshot consumed by kernels (all torch tensors on one
    device, contiguous)."""

    totals: torch.Tensor  # (N, 3) f32
    used: torch.Tensor  # (N, 3) f32
    eligible: torch.Tensor  # (N,) bool
    attr_hash: torch.Tensor  # (N, A) i32
    attr_num: torch.Tensor  # (N, A) f32
    attr_ver: torch.Tensor  # (N, A) f32 — version packing (see version_value)
    class_id: torch.Tensor  # (N,) i32
    dev_total: torch.Tensor  # (N, D) i32
    dev_used: torch.Tensor  # (N, D) i32
    prio_used: torch.Tensor  # (N, P, 3) f32
    port_words: torch.Tensor  # (N, PORT_WORDS) i32 view of the u32 bitmap
    dyn_used: torch.Tensor  # (N,) i32 — ports consumed in the dynamic range


def host_to_tensor(field: str, arr: np.ndarray,
                   device: torch.device) -> torch.Tensor:
    """One host field (or rows of it) as a tensor on ``device``; the u32
    port bitmap travels as its i32 bit view.  ``arr`` must be a private
    copy: on the CPU the tensor shares its memory."""
    if field == "port_words":
        arr = arr.view(np.int32)
    # From pageable memory a non-blocking copy is staged before the call
    # returns, so it never outlives ``arr``; up to a few hundred KiB it
    # also returns without waiting for the stream (larger ones may wait
    # for work queued before them: measured on an H100, PERF.md §6).
    return torch.from_numpy(np.ascontiguousarray(arr)).to(
        device, non_blocking=True
    )



class NodeMatrix:
    """Host mirror + device copy of the cluster matrix.

    Row lifecycle: nodes claim rows on upsert; removed nodes free their row
    (marked ineligible until reused). Capacity grows by doubling; growth
    invalidates the device copy entirely (rare).
    """

    def __init__(self, capacity: int = 1024, device="cuda"):
        self.capacity = max(16, capacity)
        # Device the resident copy lives on; resolved (and checked) at the
        # first sync, so a matrix used host-side only never needs a card.
        self.device = device
        self.attrs = AttributeRegistry()
        self.devices = DeviceRegistry()
        self.row_of: Dict[str, int] = {}  # node_id -> row
        self.node_of: Dict[int, str] = {}  # row -> node_id
        self._free: List[int] = []
        self._next_row = 0
        # class bookkeeping
        self.class_ids: Dict[str, int] = {}  # class key -> id
        self.class_repr: Dict[int, str] = {}  # class id -> representative node
        self._alloc = self._allocate_arrays(self.capacity)
        self._dirty: set = set()
        self._device: Optional[DeviceArrays] = None
        self._device_valid = False
        # Device that holds the resident copy (a sync for another device
        # re-uploads in full).
        self._device_on: Optional[torch.device] = None
        # Monotonic mutation counter, bumped on every host-side row change.
        # Pipelined dispatches record it at launch; a mismatch at resolve
        # time means the dispatch scored a stale snapshot (counted by the
        # coalescer — the applier's re-verify is the correctness backstop).
        self.version = 0
        # Transfer telemetry (exported via /v1/metrics): proves steady-state
        # syncs move O(dirty rows), not the whole matrix.
        self.full_uploads = 0
        self.scatter_syncs = 0
        self.rows_scattered_total = 0
        self.upload_bytes_total = 0
        # Guards _alloc row writes + _dirty against the sync drain: store
        # mutators run under the store lock, sync under DEVICE_LOCK — with
        # no common lock, a row marked dirty while sync snapshots the set
        # was cleared WITHOUT ever reaching the device, leaving (e.g.) a
        # freshly registered node invisible to every subsequent dispatch.
        self._host_lock = threading.Lock()
        self._encoder = None
        self._shared_masks: Optional[Tuple[np.ndarray, np.ndarray]] = None
        self._shared_zero_i32: Optional[np.ndarray] = None
        # Sharded residency (the node-sharded dispatch): a second resident
        # copy laid out over a mesh, with its own dirty set so the
        # one-device and sharded copies sync independently.
        self._sharded_device = None
        self._sharded_valid = False
        self._sharded_dirty: set = set()
        self._sharded_mesh = None
        self._sharded_scatter = None
        # Node-axis sharding: the capacity splits into shard_count equal
        # row blocks, one per mesh node shard.  Row claims balance across
        # blocks and _grow relocates rows so a node's (home shard, local
        # offset) pair survives growth.  shard_count == 1 is the dense
        # policy.
        self.shard_count = 1
        self._shard_next: List[int] = [0]
        self._shard_claimed: List[int] = [0]
        # Row-relocation history: (version after the remap, mapping)
        # pairs, so in-flight dispatches that recorded global rows against
        # an older version can translate them (translate_rows).  Bounded;
        # anything older resolves to -1 (a failed placement, retried).
        self._remaps: List[Tuple[int, np.ndarray]] = []
        self._remap_floor = 0
        # TSan-lite (lint/tsan.py): lockset checking on _alloc row writes
        # and the dirty sets when a test enabled the sanitizer.
        if tsan.enabled():
            tsan.instrument("matrix", self)

    def shared_encoder(self):
        """The matrix-wide RequestEncoder.  Scheduling stacks are built per
        eval; a per-stack encoder made the compile cache die with each eval,
        so steady-state evals recompiled every constraint set.  The shared
        instance is safe: per-job broker serialization means no two live
        evals compile/mutate the same (job, tg) entry concurrently."""
        enc = self._encoder
        if enc is None:
            from ..ops.encode import RequestEncoder

            enc = self._encoder = RequestEncoder(self)
        return enc

    def shared_masks(self) -> Tuple[np.ndarray, np.ndarray]:
        """(all-False, all-True) read-only (capacity,) bool masks — select
        assembly reuses them instead of allocating fresh vectors per eval.
        Rebuilt when capacity grows; marked non-writeable so an accidental
        in-place mutation raises instead of corrupting a neighbor select."""
        n = self.capacity
        m = self._shared_masks
        if m is None or m[0].shape[0] != n:
            zeros = np.zeros((n,), bool)
            ones = np.ones((n,), bool)
            zeros.setflags(write=False)
            ones.setflags(write=False)
            m = self._shared_masks = (zeros, ones)
        return m

    def shared_zero_i32(self) -> np.ndarray:
        """Read-only all-zero (capacity,) int32 — the tg_count vector for
        evals whose job has no proposed allocs yet (the common first pass)."""
        n = self.capacity
        z = self._shared_zero_i32
        if z is None or z.shape[0] != n:
            z = np.zeros((n,), np.int32)
            z.setflags(write=False)
            self._shared_zero_i32 = z
        return z

    # -- host arrays --------------------------------------------------------

    def _allocate_arrays(self, cap: int) -> Dict[str, np.ndarray]:
        return {
            "totals": np.zeros((cap, RESOURCE_DIMS), np.float32),
            "used": np.zeros((cap, RESOURCE_DIMS), np.float32),
            "eligible": np.zeros((cap,), bool),
            "attr_hash": np.zeros((cap, self.attrs.slots), np.int32),
            "attr_num": np.full((cap, self.attrs.slots), np.nan, np.float32),
            "attr_ver": np.full((cap, self.attrs.slots), np.nan, np.float32),
            "class_id": np.full((cap,), -1, np.int32),
            "dev_total": np.zeros((cap, self.devices.slots), np.int32),
            "dev_used": np.zeros((cap, self.devices.slots), np.int32),
            "prio_used": np.zeros(
                (cap, PRIORITY_BUCKETS, RESOURCE_DIMS), np.float32
            ),
            "port_words": np.zeros((cap, PORT_WORDS), np.uint32),
            "dyn_used": np.zeros((cap,), np.int32),
        }

    # How many row-relocation mappings translate_rows keeps.  A dispatch
    # outlives at most a handful of relocations; anything older maps to -1
    # (a failed placement, retried) rather than a wrong row.
    _REMAP_KEEP = 16

    def _record_remap_locked(self, mapping: np.ndarray) -> None:
        self.version += 1
        self._remaps.append((self.version, mapping))
        if len(self._remaps) > self._REMAP_KEEP:
            dropped = self._remaps[: -self._REMAP_KEEP]
            self._remap_floor = dropped[-1][0]
            del self._remaps[: -self._REMAP_KEEP]

    def _grow(self, min_cap: int) -> None:
        new_cap = self.capacity
        while new_cap < min_cap:
            new_cap *= 2
        new = self._allocate_arrays(new_cap)
        if self.shard_count > 1:
            # Shard-preserving relocation: row r of shard s sits at offset
            # (r - s·old_blk) of its block and moves to the same offset of
            # the same shard's doubled block, so a node never migrates
            # between shards.  The mapping is recorded so in-flight
            # dispatches can translate rows they scored before growth.
            old_blk = self.capacity // self.shard_count
            new_blk = new_cap // self.shard_count
            rows = np.arange(self.capacity, dtype=np.int64)
            mapping = ((rows // old_blk) * new_blk + rows % old_blk).astype(
                np.int32)
            for k, arr in self._alloc.items():
                new[k][mapping] = arr
            self.row_of = {
                nid: int(mapping[r]) for nid, r in self.row_of.items()}
            self.node_of = {r: nid for nid, r in self.row_of.items()}
            self._free = [int(mapping[r]) for r in self._free]
            self._dirty = {int(mapping[r]) for r in self._dirty}
            self._sharded_dirty = {
                int(mapping[r]) for r in self._sharded_dirty}
            self._shard_next = [
                s * new_blk + (nxt - s * old_blk)
                for s, nxt in enumerate(self._shard_next)]
            self._next_row = max((r + 1 for r in self.node_of), default=0)
            self._record_remap_locked(mapping)
        else:
            for k, arr in self._alloc.items():
                new[k][: self.capacity] = arr
        self._alloc = new
        self.capacity = new_cap
        self._device_valid = False
        self._sharded_valid = False

    @property
    def n_rows(self) -> int:
        return self._next_row

    def set_shard_count(self, n: int) -> None:
        """Partition the row space into ``n`` equal home-shard blocks
        (block b = rows [b·capacity/n, (b+1)·capacity/n)), the mesh's
        node-axis width.  Later claims balance across blocks and growth
        keeps each row's home shard.  ``n`` must divide the capacity;
        ``n == 1`` is the dense policy."""
        n = max(1, int(n))
        with self._host_lock:
            if n == self.shard_count:
                return
            if self.capacity % n:
                raise ValueError(
                    f"shard_count {n} does not divide capacity "
                    f"{self.capacity}")
            self.shard_count = n
            blk = self.capacity // n
            self._shard_next = [s * blk for s in range(n)]
            self._shard_claimed = [0] * n
            for r in self.node_of:
                self._shard_claimed[r // blk] += 1

    def home_shard(self, row: int) -> int:
        """The node shard that owns ``row`` under the current partition."""
        return row // (self.capacity // self.shard_count)

    def shard_row_counts(self) -> List[int]:
        """Claimed rows per home shard (the shard-balance gauge)."""
        with self._host_lock:
            if self.shard_count == 1:
                return [len(self.node_of)]
            return list(self._shard_claimed)

    def shard_nodes(self, shard: int) -> List[str]:
        """Node ids homed on ``shard``."""
        with self._host_lock:
            blk = self.capacity // self.shard_count
            return [nid for r, nid in self.node_of.items()
                    if r // blk == shard]

    def translate_rows(self, rows: np.ndarray,
                       from_version: int) -> np.ndarray:
        """Map global rows recorded at matrix ``from_version`` through
        every relocation since (growth of a sharded matrix, a re-layout).
        Rows older than the kept window become -1 (the caller treats that
        as a failed placement and retries); negative rows pass as they
        are."""
        if not self._remaps:
            # Nothing ever relocated (every unsharded matrix): no lock.
            return rows
        with self._host_lock:
            remaps = [(v, mp) for v, mp in self._remaps if v > from_version]
            floor = self._remap_floor
        if not remaps:
            return rows
        out = np.array(rows, np.int64, copy=True)
        pos = out >= 0
        if from_version < floor:
            out[pos] = -1
            return out.astype(rows.dtype, copy=False)
        for _ver, mapping in remaps:
            ok = pos & (out >= 0) & (out < len(mapping))
            out = np.where(
                ok, mapping[np.clip(out, 0, len(mapping) - 1)],
                np.where(pos, -1, out))
        return out.astype(rows.dtype, copy=False)

    def relayout_shards(self, n: int) -> np.ndarray:
        """Re-home every claimed row under a fresh ``n``-shard partition
        by replaying the claim policy (least-claimed shard, lowest index
        on ties, a cursor per shard) over the nodes in ascending old-row
        order: the result equals inserting the same nodes in that order
        into an empty ``n``-shard matrix.  Capacity rounds up to a
        multiple of ``n``.  The old→new mapping (-1 for unclaimed rows) is
        recorded for :meth:`translate_rows`; both resident copies
        invalidate, so the next sync lays out in full.  Returns the
        mapping."""
        n = max(1, int(n))
        with self._host_lock:
            old_cap = self.capacity
            new_cap = old_cap if old_cap % n == 0 else (
                (old_cap + n - 1) // n) * n
            blk = new_cap // n
            mapping = np.full((old_cap,), -1, np.int32)
            claimed = [0] * n
            cursor = [s * blk for s in range(n)]
            new_row_of: Dict[str, int] = {}
            for old_row in sorted(self.node_of):
                s = min(range(n), key=lambda i: (claimed[i], i))
                r = cursor[s]
                cursor[s] = r + 1
                claimed[s] += 1
                mapping[old_row] = r
                new_row_of[self.node_of[old_row]] = r
            new = self._allocate_arrays(new_cap)
            src = mapping >= 0
            if src.any():
                dst = mapping[src]
                for k, arr in self._alloc.items():
                    new[k][dst] = arr[src]
            self._alloc = new
            self.capacity = new_cap
            self.shard_count = n
            self.row_of = new_row_of
            self.node_of = {r: nid for nid, r in new_row_of.items()}
            self._free = []
            self._shard_next = cursor
            self._shard_claimed = claimed
            self._next_row = max((r + 1 for r in self.node_of), default=0)
            self._dirty.clear()
            self._sharded_dirty.clear()
            self._record_remap_locked(mapping)
            self._device_valid = False
            self._sharded_valid = False
            self._shared_masks = None
            self._shared_zero_i32 = None
            return mapping

    def evacuate_shard(self, shard: int) -> np.ndarray:
        """Evacuate a lost home shard: re-lay every node over the
        surviving ``shard_count - 1`` shards (the host mirror is whole:
        only the shard's resident copy was lost, so every node re-homes).
        Returns the old→new mapping of :meth:`relayout_shards`."""
        if self.shard_count <= 1:
            raise ValueError("evacuate_shard requires shard_count > 1")
        if not 0 <= shard < self.shard_count:
            raise ValueError(
                f"shard {shard} out of range 0..{self.shard_count - 1}")
        return self.relayout_shards(self.shard_count - 1)

    def _claim_row(self, node_id: str) -> int:
        row = self.row_of.get(node_id)
        if row is not None:
            return row
        if self.shard_count > 1:
            row = self._claim_sharded_row_locked()
        elif self._free:
            row = self._free.pop()
        else:
            if self._next_row >= self.capacity:
                self._grow(self._next_row + 1)
            row = self._next_row
            self._next_row += 1
        self.row_of[node_id] = row
        self.node_of[row] = node_id
        return row

    def _claim_sharded_row_locked(self) -> int:
        """A row on the least-occupied home shard: a freed row of that
        shard's block if any, else the block's claim cursor.  Falls
        through fuller shards before growing (doubling every block)."""
        blk = self.capacity // self.shard_count
        order = sorted(range(self.shard_count),
                       key=lambda s: (self._shard_claimed[s], s))
        for s in order:
            lo, hi = s * blk, (s + 1) * blk
            for i in range(len(self._free) - 1, -1, -1):
                r = self._free[i]
                if lo <= r < hi:
                    del self._free[i]
                    self._shard_claimed[s] += 1
                    self._next_row = max(self._next_row, r + 1)
                    return r
            nxt = max(self._shard_next[s], lo)
            while nxt < hi and nxt in self.node_of:
                nxt += 1
            if nxt < hi:
                self._shard_next[s] = nxt + 1
                self._shard_claimed[s] += 1
                self._next_row = max(self._next_row, nxt + 1)
                return nxt
        self._grow(self.capacity + 1)
        return self._claim_sharded_row_locked()

    # -- mutations ----------------------------------------------------------

    def _mark_dirty_locked(self, row: int) -> None:
        """Record a row mutation (caller holds _host_lock): the resident
        copy resyncs it, and the version bump lets in-flight pipelined
        dispatches detect they scored a stale snapshot."""
        self._dirty.add(row)
        self._sharded_dirty.add(row)
        self.version += 1

    def clear(self) -> None:
        """Drop every row (snapshot install replaces all state). Registries
        persist — attribute slots are append-only by design."""
        with self._host_lock:
            self.row_of.clear()
            self.node_of.clear()
            self._free.clear()
            self._next_row = 0
            self.class_ids.clear()
            self.class_repr.clear()
            self._alloc = self._allocate_arrays(self.capacity)
            self._dirty.clear()
            self._device_valid = False
            self._sharded_dirty.clear()
            self._sharded_valid = False
            blk = self.capacity // self.shard_count
            self._shard_next = [s * blk for s in range(self.shard_count)]
            self._shard_claimed = [0] * self.shard_count
            self.version += 1

    def upsert_node(self, node: Node) -> int:
        """Insert or refresh a node's static columns (totals, attrs, class).

        Usage columns are owned by the alloc-delta path.
        """
        with self._host_lock:
            return self._upsert_node_locked(node)

    def _upsert_node_locked(self, node: Node) -> int:
        row = self._claim_row(node.id)
        a = self._alloc
        avail = node.comparable_resources()
        a["totals"][row] = (avail.cpu, avail.memory_mb, avail.disk_mb)
        a["eligible"][row] = node.ready()

        attrs = node_attributes(node)
        hash_row = np.zeros((self.attrs.slots,), np.int32)
        num_row = np.full((self.attrs.slots,), np.nan, np.float32)
        ver_row = np.full((self.attrs.slots,), np.nan, np.float32)
        for name, value in attrs.items():
            if value is None or value == "":
                continue
            slot = self.attrs.register(name)
            if slot is None:
                continue
            hash_row[slot] = stable_hash(str(value))
            num_row[slot] = numeric_value(str(value))
            ver_row[slot] = version_value(str(value))
        a["attr_hash"][row] = hash_row
        a["attr_num"][row] = num_row
        a["attr_ver"][row] = ver_row

        key = computed_class_key(attrs, node)
        cid = self.class_ids.get(key)
        if cid is None:
            cid = len(self.class_ids)
            self.class_ids[key] = cid
            self.class_repr[cid] = node.id
        a["class_id"][row] = cid

        dev_row = np.zeros((self.devices.slots,), np.int32)
        for name, instances in node.resources.devices.items():
            slot = self.devices.register(name)
            if slot is not None:
                dev_row[slot] = len(instances)
        a["dev_total"][row] = dev_row

        # Node-reserved ports claim their bits up-front (bits are otherwise
        # owned by the alloc-delta path, so set-only here).
        for p in node.reserved.reserved_ports:
            if 0 <= p < PORT_BITS:
                a["port_words"][row, p >> 5] |= np.uint32(1 << (p & 31))

        self._mark_dirty_locked(row)
        return row

    def set_eligibility(self, node_id: str, eligible: bool) -> None:
        with self._host_lock:
            row = self.row_of.get(node_id)
            if row is None:
                return
            self._alloc["eligible"][row] = eligible
            self._mark_dirty_locked(row)

    def remove_node(self, node_id: str) -> None:
        with self._host_lock:
            self._remove_node_locked(node_id)

    def _remove_node_locked(self, node_id: str) -> None:
        row = self.row_of.pop(node_id, None)
        if row is None:
            return
        del self.node_of[row]
        # Re-seat the computed-class representative if this node held it:
        # escaped-constraint checks are evaluated against the representative
        # (stack._class_eligibility), so a stale id would skip them.
        cid = int(self._alloc["class_id"][row])
        if cid >= 0 and self.class_repr.get(cid) == node_id:
            replacement = None
            for other_row, other_id in self.node_of.items():
                if int(self._alloc["class_id"][other_row]) == cid:
                    replacement = other_id
                    break
            if replacement is None:
                self.class_repr.pop(cid, None)
            else:
                self.class_repr[cid] = replacement
        for k in ("totals", "used", "dev_total", "dev_used", "port_words",
                  "dyn_used"):
            self._alloc[k][row] = 0
        self._alloc["eligible"][row] = False
        self._alloc["class_id"][row] = -1
        self._alloc["prio_used"][row] = 0
        self._free.append(row)
        if self.shard_count > 1:
            self._shard_claimed[self.home_shard(row)] -= 1
        self._mark_dirty_locked(row)

    def _usage_of(self, alloc: Allocation) -> np.ndarray:
        r = alloc.resources
        return np.array([r.cpu, r.memory_mb, r.disk_mb], np.float32)

    @staticmethod
    def ports_of(alloc: Allocation) -> set:
        """Every port an allocation occupies on its node: assigned (static +
        dynamic) plus statically reserved in its network asks."""
        ports = set()
        for nets in alloc.assigned_ports.values():
            ports.update(nets.values())
        for net in alloc.resources.networks:
            ports.update(net.reserved_ports)
        return ports

    def _port_delta(self, row: int, alloc: Allocation, claim: bool) -> None:
        ports = self.ports_of(alloc)
        if not ports:
            return
        words = self._alloc["port_words"]
        dyn = 0
        for p in ports:
            if MIN_DYNAMIC_PORT <= p <= MAX_DYNAMIC_PORT:
                dyn += 1
            if not 0 <= p < PORT_BITS:
                continue  # beyond the bitmap — host-checked only
            w, b = p >> 5, np.uint32(1 << (p & 31))
            if claim:
                words[row, w] |= b
            else:
                words[row, w] &= ~b
        if dyn:
            cur = int(self._alloc["dyn_used"][row])
            self._alloc["dyn_used"][row] = max(0, cur + (dyn if claim else -dyn))

    def add_alloc(self, alloc: Allocation) -> None:
        """Account a (non-terminal) allocation's usage on its node."""
        with self._host_lock:
            self._add_alloc_locked(alloc)

    def remove_alloc(self, alloc: Allocation) -> None:
        with self._host_lock:
            self._remove_alloc_locked(alloc)

    def _add_alloc_locked(self, alloc: Allocation) -> None:
        row = self.row_of.get(alloc.node_id)
        if row is None:
            return
        usage = self._usage_of(alloc)
        self._alloc["used"][row] += usage
        self._alloc["prio_used"][row, priority_bucket(alloc.job_priority())] += usage
        for dev in alloc.resources.devices:
            slot = self.devices.register(dev.name)
            if slot is not None:
                self._alloc["dev_used"][row, slot] += dev.count
        self._port_delta(row, alloc, claim=True)
        self._mark_dirty_locked(row)

    def _remove_alloc_locked(self, alloc: Allocation) -> None:
        row = self.row_of.get(alloc.node_id)
        if row is None:
            return
        usage = self._usage_of(alloc)
        self._alloc["used"][row] = np.maximum(self._alloc["used"][row] - usage, 0)
        bucket = priority_bucket(alloc.job_priority())
        self._alloc["prio_used"][row, bucket] = np.maximum(
            self._alloc["prio_used"][row, bucket] - usage, 0
        )
        for dev in alloc.resources.devices:
            slot = self.devices.lookup(dev.name)
            if slot is not None:
                self._alloc["dev_used"][row, slot] = max(
                    0, self._alloc["dev_used"][row, slot] - dev.count
                )
        self._port_delta(row, alloc, claim=False)
        self._mark_dirty_locked(row)

    # -- device sync --------------------------------------------------------

    def run_on_device(self, fn):
        """Execute a device-touching closure on THE device thread: with a
        coalescer attached (the live server) the closure runs on its
        dispatch thread; otherwise inline under DEVICE_LOCK."""
        coal = getattr(self, "coalescer", None)
        if coal is not None:
            return coal.run_device_op(fn)
        with DEVICE_LOCK:
            return fn()

    def snapshot_host(self) -> Dict[str, np.ndarray]:
        """Host-side view (no copy) of the active arrays."""
        return self._alloc

    # -- encoded-matrix persistence (warm start) -----------------------------

    # Bump when the encoded layout changes (array fields, registry
    # semantics, hashing): stale caches must miss, not deserialize wrong.
    # The reference's number: a file either package writes loads in the
    # other.
    ENCODED_FORMAT = 2

    def save_encoded(self, path) -> None:
        """Serialize the encoded host matrix — arrays, row maps and
        registries — to ``path`` (.npz): every host array under its field
        name (``port_words`` as ``uint32``) and a ``__meta__`` JSON of the
        rest, written through a temporary file and renamed."""
        with self._host_lock:
            meta = {
                "format": self.ENCODED_FORMAT,
                "capacity": self.capacity,
                "next_row": self._next_row,
                "shard_count": self.shard_count,
                "free": list(self._free),
                "row_of": self.row_of,
                "class_ids": self.class_ids,
                "class_repr": self.class_repr,
                "attr_slots": self.attrs.slots,
                "attr_slot_of": self.attrs.slot_of,
                "dev_slots": self.devices.slots,
                "dev_slot_of": self.devices.slot_of,
            }
            payload = dict(self._alloc)
            payload["__meta__"] = np.frombuffer(
                json.dumps(meta).encode(), np.uint8
            )
            tmp = str(path) + ".tmp"
            with open(tmp, "wb") as fh:
                np.savez(fh, **payload)
            os.replace(tmp, str(path))

    def load_encoded(self, path) -> bool:
        """Restore a matrix serialized by :meth:`save_encoded` (of either
        package).  Returns False, leaving the matrix untouched, on an
        unreadable file, another format, a missing field or array, or an
        array whose shape or type does not match the meta.  After a load
        the next ``sync``/``sync_sharded`` is one full upload into new
        tensors, as after a restore; ``shard_count`` keeps the home
        shards."""
        try:
            with np.load(str(path)) as data:
                meta = json.loads(bytes(data["__meta__"]).decode())
                if meta.get("format") != self.ENCODED_FORMAT:
                    return False
                arrays = {
                    k: np.array(data[k]) for k in self._alloc
                    if k in data.files
                }
            state = self._decode_meta(meta)
        except (OSError, ValueError, KeyError, TypeError, AttributeError,
                EOFError, zipfile.BadZipFile):
            return False
        if set(arrays) != set(self._alloc):
            return False
        cap = state["capacity"]
        widths = {"attr_hash": state["attr_slots"],
                  "attr_num": state["attr_slots"],
                  "attr_ver": state["attr_slots"],
                  "dev_total": state["dev_slots"],
                  "dev_used": state["dev_slots"]}
        for k, a in arrays.items():
            tmpl = self._alloc[k]
            want = (cap,) + ((widths[k],) if k in widths else tmpl.shape[1:])
            if a.dtype != tmpl.dtype or a.shape != want:
                return False
        shards = state["shard_count"]
        if cap % shards or any(
                not 0 <= r < cap for r in state["row_of"].values()):
            return False
        with self._host_lock:
            self.capacity = cap
            self._next_row = state["next_row"]
            self._free = state["free"]
            self.row_of = state["row_of"]
            self.node_of = {v: k for k, v in self.row_of.items()}
            self.class_ids = state["class_ids"]
            self.class_repr = state["class_repr"]
            self.attrs.slots = state["attr_slots"]
            self.attrs.slot_of = state["attr_slot_of"]
            self.devices.slots = state["dev_slots"]
            self.devices.slot_of = state["dev_slot_of"]
            self._alloc = arrays
            self._dirty.clear()
            self._sharded_dirty.clear()
            self._device_valid = False
            self._sharded_valid = False
            self._shared_masks = None
            self._shared_zero_i32 = None
            self.shard_count = shards
            blk = cap // shards
            self._shard_next = [s * blk for s in range(shards)]
            self._shard_claimed = [0] * shards
            for r in self.node_of:
                self._shard_claimed[r // blk] += 1
            self.version += 1
        return True

    @staticmethod
    def _decode_meta(meta) -> Dict:
        """The typed state of a ``__meta__`` record; raises KeyError,
        ValueError or TypeError on a missing or malformed field."""
        return {
            "capacity": int(meta["capacity"]),
            "next_row": int(meta["next_row"]),
            "shard_count": max(1, int(meta.get("shard_count", 1))),
            "free": [int(r) for r in meta["free"]],
            "row_of": {str(k): int(v) for k, v in meta["row_of"].items()},
            "class_ids": {
                str(k): int(v) for k, v in meta["class_ids"].items()},
            "class_repr": {
                int(k): v for k, v in meta["class_repr"].items()},
            "attr_slots": int(meta["attr_slots"]),
            "attr_slot_of": {
                str(k): int(v) for k, v in meta["attr_slot_of"].items()},
            "dev_slots": int(meta["dev_slots"]),
            "dev_slot_of": {
                str(k): int(v) for k, v in meta["dev_slot_of"].items()},
        }

    def sync(self, device=None) -> DeviceArrays:
        """Return the resident snapshot on ``device`` (default: the
        matrix's own ``device``, itself ``"cuda"`` unless the caller chose
        otherwise), writing dirty rows if needed.

        Full upload on first use, on growth, on invalidate and on a change
        of device; otherwise one ``index_copy_`` per field of just the
        dirty rows, so steady-state transfer is O(dirty rows).  The
        tensors are updated in place on the current stream, so a kernel
        launched earlier on that stream still reads the rows it was
        launched against.
        """
        dev = resolve_device(self.device if device is None else device)
        with DEVICE_LOCK:
            return self._sync_locked(dev)

    def _sync_locked(self, dev: torch.device) -> DeviceArrays:
        if self._device_on != dev:
            self._device_valid = False

        # Snapshot the dirty rows' data under the host lock (mutators may
        # run concurrently from the store); the transfer itself happens
        # outside it.  `_alloc[f][rows]` fancy-indexing copies.
        if self._device is None or not self._device_valid:
            with self._host_lock:
                host_copy = {
                    f: self._alloc[f].copy() for f in DeviceArrays._fields
                }
                self._dirty.clear()
                # Claim validity for THIS copy while still under the lock:
                # a concurrent _grow after this point flips it back to
                # False and the next sync re-uploads — setting it after
                # the transfer would clobber that invalidation and leave
                # post-growth rows silently out of device bounds.
                self._device_valid = True
            self.full_uploads += 1
            self.upload_bytes_total += sum(
                a.nbytes for a in host_copy.values()
            )
            try:
                self._device = DeviceArrays(**{
                    f: host_to_tensor(f, host_copy[f], dev)
                    for f in DeviceArrays._fields
                })
            except BaseException:
                # Failed transfer must not strand the cleared dirty set —
                # invalidate so the next sync re-uploads everything.
                self._device_valid = False
                raise
            self._device_on = dev
            return self._device

        with self._host_lock:
            if not self._dirty:
                return self._device
            rows = np.fromiter(self._dirty, np.int64)
            self._dirty.clear()
            row_data = {f: self._alloc[f][rows] for f in DeviceArrays._fields}
        try:
            # Non-blocking, so a steady-state sync only enqueues: a
            # blocking copy would wait for every launch queued before it,
            # and a stuck stream would stall the dispatch thread outside
            # the resolver's watchdog.
            idx = torch.from_numpy(rows).to(dev, non_blocking=True)
            for f in DeviceArrays._fields:
                getattr(self._device, f).index_copy_(
                    0, idx, host_to_tensor(f, row_data[f], dev)
                )
        except BaseException:
            # Put the drained rows back so a later sync retries them.
            with self._host_lock:
                self._dirty.update(int(r) for r in rows)
            raise
        self.scatter_syncs += 1
        self.rows_scattered_total += len(rows)
        self.upload_bytes_total += sum(a.nbytes for a in row_data.values())
        return self._device

    def invalidate(self) -> None:
        self._device_valid = False
        self._sharded_valid = False

    # -- sharded device sync ------------------------------------------------

    def sync_sharded(self, mesh):
        """The mesh-resident copy for the node-sharded dispatch
        (``parallel.ShardedArrays``), writing only dirty rows into the
        shards that own them.

        A full lay-out into new tensors on first use, on growth, on a
        re-layout, after ``clear`` (a snapshot install) and on a change of
        mesh; otherwise one ``index_copy_`` per field and shard of the
        dirty rows (``parallel.make_sharded_row_scatter``), in place on
        each device's current stream."""
        with DEVICE_LOCK:
            return self._sync_sharded_locked(mesh)

    def _sync_sharded_locked(self, mesh):
        from ..parallel.sharding import (
            make_sharded_row_scatter,
            shard_matrix_arrays,
        )

        if self._sharded_mesh is not mesh:
            self._sharded_mesh = mesh
            self._sharded_scatter = make_sharded_row_scatter(mesh)
            self._sharded_valid = False

        if self._sharded_device is None or not self._sharded_valid:
            with self._host_lock:
                host_copy = DeviceArrays(**{
                    f: self._alloc[f].copy() for f in DeviceArrays._fields})
                self._sharded_dirty.clear()
                # Claim validity under the lock, as _sync_locked does: a
                # concurrent _grow's invalidation then wins.
                self._sharded_valid = True
            try:
                self._sharded_device = shard_matrix_arrays(mesh, host_copy)
            except BaseException:
                self._sharded_valid = False
                raise
            self.full_uploads += 1
            self.upload_bytes_total += sum(a.nbytes for a in host_copy)
            return self._sharded_device

        with self._host_lock:
            if not self._sharded_dirty:
                return self._sharded_device
            rows = np.fromiter(self._sharded_dirty, np.int64)
            self._sharded_dirty.clear()
            # Ascending rows group each shard's updates into one run.
            rows.sort()
            row_data = {f: self._alloc[f][rows] for f in DeviceArrays._fields}
        try:
            self._sharded_scatter(self._sharded_device, rows, row_data)
        except BaseException:
            with self._host_lock:
                self._sharded_dirty.update(int(r) for r in rows)
            raise
        self.scatter_syncs += 1
        self.rows_scattered_total += len(rows)
        self.upload_bytes_total += sum(a.nbytes for a in row_data.values())
        return self._sharded_device
