"""Write-ahead log + snapshots — the durability half of the Raft seam.

The reference persists every state mutation twice over: the Raft log
(BoltDB, ``raft-boltdb``) and periodic FSM snapshots
(``nomad/fsm.go:1367`` Persist / ``:1381`` Restore, 2 retained,
``nomad/server.go:64``).  A server restart replays snapshot + log tail and
the leader rebuilds in-memory services (broker, periodic) from state
(``nomad/leader.go:493``).

This build is a single-voter deployment of the same discipline:

- Every **top-level** store mutation is appended to ``wal.jsonl`` as
  ``{"i": index, "s": seq, "op": method, "a": wire-args}`` *before* it is
  applied (write-ahead).  ``s`` is a per-entry monotonic sequence number —
  raft indices are per-*batch* (several entries may share one index), so
  replay cut-points key on the sequence, never the index.  Nested mutations
  (e.g. ``upsert_plan_results`` calling ``upsert_allocs``) are not
  journaled — replaying the outer op re-executes them deterministically.
- ``write_snapshot`` atomically persists the full store image
  (tmp + rename) stamped with the last applied sequence (``wal_seq``),
  then rotates the log.  Entries with ``seq <=`` the snapshot's are
  skipped at load, so a crash between snapshot and rotation cannot
  double-apply — and same-index entries appended *after* a mid-batch
  snapshot are still replayed (they have a later sequence).
- The device ``NodeMatrix`` is NOT persisted: restore replays mutations
  through the store, whose mutators feed the matrix incrementally — the
  HBM image is rebuilt as a side effect (SURVEY.md §7 hard-part a).

The multi-voter upgrade path keeps this file: a replicated log would agree
on the entry sequence first, then feed the same ``(index, op, args)``
records to the same apply path.

A copy of the reference package's log without its chaos seam (injected
torn writes and fsync failures, and the poisoned-log state they leave).
The on-disk format is the same byte for byte, so either package restores
what the other wrote.
"""

from __future__ import annotations

import json
import os
from typing import Any, Iterator, List, Optional, Tuple

from .. import trace

LOG_NAME = "wal.jsonl"
SNAPSHOT_NAME = "snapshot.json"


class WALWriteError(OSError):
    """An append did not durably complete — the mutation MUST NOT apply
    (write-ahead contract)."""


class WriteAheadLog:
    """Append-only JSONL log + atomic snapshot files in ``data_dir``.

    ``fsync`` controls whether every append reaches the platter before the
    mutation applies (durable but slow); with ``fsync=False`` appends are
    flushed to the OS (surviving process crash, not host crash).
    """

    def __init__(self, data_dir: str, fsync: bool = False):
        self.data_dir = data_dir
        self.fsync = fsync
        os.makedirs(data_dir, exist_ok=True)
        self.log_path = os.path.join(data_dir, LOG_NAME)
        self.snapshot_path = os.path.join(data_dir, SNAPSHOT_NAME)
        self._fh = None
        self.appends_since_snapshot = 0
        # Per-entry sequence: strictly monotonic across the WAL's lifetime,
        # resumed from the on-disk tail by load().
        self.seq = 0

    # ------------------------------------------------------------------
    # Load (restore path)
    # ------------------------------------------------------------------

    def load(self) -> Tuple[Optional[dict], List[dict]]:
        """Return (snapshot wire dict or None, log entries past it).

        Corrupt trailing lines (torn final write from a crash) are
        discarded; corruption in the middle raises.
        """
        snapshot = None
        snap_index = -1
        snap_seq = None
        if os.path.exists(self.snapshot_path):
            with open(self.snapshot_path, "r", encoding="utf-8") as fh:
                snapshot = json.load(fh)
            snap_index = snapshot.get("latest_index", -1)
            snap_seq = snapshot.get("wal_seq")
            if snap_seq is not None:
                self.seq = max(self.seq, snap_seq)

        entries: List[dict] = []
        if os.path.exists(self.log_path):
            with open(self.log_path, "r", encoding="utf-8") as fh:
                lines = fh.readlines()
            for pos, line in enumerate(lines):
                line = line.strip()
                if not line:
                    continue
                try:
                    entry = json.loads(line)
                except json.JSONDecodeError:
                    if pos == len(lines) - 1:
                        break  # torn final append from a crash — drop it
                    raise
                seq = entry.get("s")
                if seq is not None:
                    self.seq = max(self.seq, seq)
                if seq is not None and snap_seq is not None:
                    if seq <= snap_seq:
                        continue  # already folded into the snapshot
                elif entry["i"] <= snap_index:
                    # Legacy entry (or pre-seq snapshot): index cut-point.
                    continue
                entries.append(entry)
        return snapshot, entries

    # ------------------------------------------------------------------
    # Append (write-ahead path)
    # ------------------------------------------------------------------

    def _open(self):
        if self._fh is None:
            self._fh = open(self.log_path, "a", encoding="utf-8")
        return self._fh

    def append(self, index: int, op: str, args_wire: Any) -> dict:
        self.seq += 1
        entry = {"i": index, "s": self.seq, "op": op, "a": args_wire}
        self._write(entry)
        return entry

    def append_entry(self, entry: dict) -> None:
        """Append a replicated entry verbatim (follower path): the leader
        assigned its sequence; ours must mirror it."""
        self._write(entry)
        self.seq = entry["s"]

    def _write(self, entry: dict) -> None:
        line = json.dumps(entry) + "\n"
        fh = self._open()
        trace.event("seam.wal.write", op=entry.get("op", ""))
        fh.write(line)
        fh.flush()
        if self.fsync:
            try:
                os.fsync(fh.fileno())
            except OSError as exc:
                raise WALWriteError(f"fsync failed: {exc}") from exc
        self.appends_since_snapshot += 1

    # ------------------------------------------------------------------
    # Snapshot + log rotation
    # ------------------------------------------------------------------

    def write_snapshot(self, snapshot_wire: dict) -> None:
        # Stamp the cut-point: entries with seq <= wal_seq are folded in.
        snapshot_wire["wal_seq"] = self.seq
        tmp = self.snapshot_path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump(snapshot_wire, fh)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, self.snapshot_path)
        # Rotate the log: everything <= the snapshot index is now redundant
        # (and skipped at load even if this truncation never happens).
        if self._fh is not None:
            self._fh.close()
            self._fh = None
        with open(self.log_path, "w", encoding="utf-8"):
            pass
        self.appends_since_snapshot = 0

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None
