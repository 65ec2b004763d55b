"""WAL crash-surface tools: truncate-at-every-offset restore sweeps.

A crash can stop a WAL file at *any* byte offset — not just at line
boundaries.  The durability contract (state/wal.py) is: a truncated
**final** record is discarded (torn final append), every complete prefix
restores, and corruption anywhere earlier raises instead of silently
skipping committed writes.  These helpers materialize every truncation
point of a real data dir so tests (and ``scenarios.wal_truncation_sweep``)
can drive a restore through each one.
"""

from __future__ import annotations

import os
import shutil
from typing import Iterator, List, Tuple

from ..state.wal import LOG_NAME, SNAPSHOT_NAME


def wal_size(data_dir: str) -> int:
    path = os.path.join(data_dir, LOG_NAME)
    return os.path.getsize(path) if os.path.exists(path) else 0


def truncation_offsets(data_dir: str, stride: int = 1) -> List[int]:
    """Every offset the log can be cut at (0..size), optionally strided
    for cheap tier-1 sweeps; line boundaries are always included so the
    complete-prefix cases are never skipped."""
    size = wal_size(data_dir)
    offsets = set(range(0, size + 1, max(1, stride)))
    offsets.add(size)
    path = os.path.join(data_dir, LOG_NAME)
    if os.path.exists(path):
        pos = 0
        with open(path, "rb") as fh:
            for line in fh:
                pos += len(line)
                offsets.add(pos)
    return sorted(offsets)


def truncated_copy(data_dir: str, dest_dir: str, offset: int) -> str:
    """Copy ``data_dir`` to ``dest_dir`` with the log cut at ``offset``
    bytes — the disk image a crash at that point would leave behind."""
    os.makedirs(dest_dir, exist_ok=True)
    snap = os.path.join(data_dir, SNAPSHOT_NAME)
    if os.path.exists(snap):
        shutil.copy2(snap, os.path.join(dest_dir, SNAPSHOT_NAME))
    log_src = os.path.join(data_dir, LOG_NAME)
    log_dst = os.path.join(dest_dir, LOG_NAME)
    if os.path.exists(log_src):
        with open(log_src, "rb") as src, open(log_dst, "wb") as dst:
            dst.write(src.read(offset))
    return dest_dir


def complete_entries_at(data_dir: str, offset: int) -> int:
    """How many intact journal lines survive a cut at ``offset`` (the
    oracle a sweep compares restored state against)."""
    path = os.path.join(data_dir, LOG_NAME)
    if not os.path.exists(path):
        return 0
    with open(path, "rb") as fh:
        data = fh.read(offset)
    return data.count(b"\n")


def sweep(
    data_dir: str, scratch_dir: str, stride: int = 1
) -> Iterator[Tuple[int, str]]:
    """Yield ``(offset, truncated_data_dir)`` for every truncation point;
    each yielded dir is a fresh copy the caller may restore from and
    mutate freely."""
    for i, offset in enumerate(truncation_offsets(data_dir, stride=stride)):
        dest = os.path.join(scratch_dir, f"cut-{i:06d}-{offset}")
        yield offset, truncated_copy(data_dir, dest, offset)
