"""Carry state into the port from plain numpy and dicts.

The JAX package's ``NodeMatrix.snapshot_host()`` returns the host mirror
as a dict of numpy arrays; together with its registries that is the whole
matrix.  :func:`matrix_from_host` rebuilds the port's ``NodeMatrix`` from
those plain values (the port never imports the JAX package's types), and
:func:`request_from_numpy` does the same for one encoded request.  The
parity tests use both to feed the two packages identical state.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np

from ..ops.encode import SchedRequest
from .matrix import DeviceArrays, NodeMatrix


def matrix_from_host(
    host: Mapping[str, np.ndarray],
    attr_slots: Mapping[str, int],
    class_ids: Mapping[str, int],
    row_of: Mapping[str, int],
    device="cuda",
    *,
    class_repr: Optional[Mapping[int, str]] = None,
    dev_slots: Optional[Mapping[str, int]] = None,
) -> NodeMatrix:
    """A port ``NodeMatrix`` holding copies of ``host`` (every field of
    :class:`DeviceArrays`, ``port_words`` as ``uint32``), the attribute
    and device-slot registries, the computed-class ids and the node→row
    map, synced to ``device``."""
    missing = set(DeviceArrays._fields) - set(host)
    if missing:
        raise ValueError(f"host arrays missing fields: {sorted(missing)}")
    cap = int(np.asarray(host["used"]).shape[0])
    m = NodeMatrix(capacity=cap, device=device)
    if m.capacity != cap:
        raise ValueError(f"capacity {cap} is below the matrix minimum")
    alloc: Dict[str, np.ndarray] = {}
    for f in DeviceArrays._fields:
        want = m._alloc[f]
        arr = np.array(host[f], dtype=want.dtype, copy=True)
        if arr.shape != want.shape:
            raise ValueError(f"{f}: shape {arr.shape}, expected {want.shape}")
        alloc[f] = arr
    m._alloc = alloc
    m.attrs.slot_of = dict(attr_slots)
    if dev_slots is not None:
        m.devices.slot_of = dict(dev_slots)
    m.class_ids = dict(class_ids)
    if class_repr is not None:
        m.class_repr = dict(class_repr)
    m.row_of = dict(row_of)
    m.node_of = {r: nid for nid, r in m.row_of.items()}
    m._next_row = max((r + 1 for r in m.node_of), default=0)
    m._free = [r for r in range(m._next_row) if r not in m.node_of]
    m.version += 1
    m.sync()
    return m


def request_from_numpy(fields: Mapping[str, np.ndarray]) -> SchedRequest:
    """A :class:`SchedRequest` from a mapping of its fields (for example a
    request's ``_asdict()``), as numpy arrays."""
    missing = set(SchedRequest._fields) - set(fields)
    if missing:
        raise ValueError(f"request missing fields: {sorted(missing)}")
    return SchedRequest(**{f: np.asarray(fields[f]) for f in SchedRequest._fields})
