"""Exporters for the flight recorder.

``chrome_trace`` renders records in the Chrome trace-event JSON format
(``ph: "X"`` complete events, microsecond timestamps) — load the file at
https://ui.perfetto.dev or chrome://tracing. ``dump_flight_record``
writes one with the dump's reason and the active chaos seed; the SLO
observatory calls it on a breach, the chaos invariant checker on a
violation.  A copy of the reference package's ``trace/export.py``.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional

from . import core

# Auto-dumps are capped per process so a cascade of failures does not
# carpet the temp directory with traces.
_MAX_AUTO_DUMPS = 8
_auto_dumps = 0
_auto_lock = threading.Lock()


def trace_dir() -> str:
    return os.environ.get(
        "NOMAD_TPU_TRACE_DIR",
        os.path.join(tempfile.gettempdir(), "nomad_tpu_trace"),
    )


def chrome_trace(
    records: Optional[List[Dict[str, Any]]] = None,
    metadata: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """Records → Chrome trace-event JSON object (Perfetto-loadable)."""
    if records is None:
        records = core.dump()
    events: List[Dict[str, Any]] = []
    seen_tids: Dict[int, str] = {}
    for r in records:
        tid = int(r.get("tid", 0))
        if tid not in seen_tids:
            seen_tids[tid] = str(r.get("thread", "?"))
    for tid, name in sorted(seen_tids.items()):
        events.append(
            {
                "name": "thread_name",
                "ph": "M",
                "pid": 1,
                "tid": tid,
                "args": {"name": name},
            }
        )
    for r in records:
        args = dict(r.get("args") or {})
        args["trace"] = r.get("trace", "")
        args["span"] = r.get("span", 0)
        args["parent"] = r.get("parent", 0)
        ev: Dict[str, Any] = {
            "name": r["name"],
            "cat": "nomad",
            "pid": 1,
            "tid": int(r.get("tid", 0)),
            "ts": int(r["ts"] * 1e6),
            "args": args,
        }
        if r.get("ph") == "i":
            ev["ph"] = "i"
            ev["s"] = "t"  # thread-scoped instant
        else:
            ev["ph"] = "X"
            ev["dur"] = max(0, int(r.get("dur", 0.0) * 1e6))
        events.append(ev)
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "metadata": metadata or {},
    }


def _chaos_seed() -> Optional[int]:
    try:
        from ..chaos.injector import active

        inj = active()
        return getattr(inj, "seed", None) if inj is not None else None
    except Exception:
        return None


def dump_flight_record(
    path: Optional[str] = None,
    reason: str = "manual",
    extra: Optional[Dict[str, Any]] = None,
) -> str:
    """Write the flight recorder to a Chrome-trace JSON file and return
    its path (under :func:`trace_dir` unless ``path`` is given).  Metadata
    carries the dump reason, the time, the pid, the active chaos seed (so
    a postmortem can be replayed from it) and ``extra``."""
    meta: Dict[str, Any] = {
        "reason": reason,
        "dumped_at": time.time(),
        "pid": os.getpid(),
    }
    seed = _chaos_seed()
    if seed is not None:
        meta["chaos_seed"] = seed
    if extra:
        meta.update(extra)
    doc = chrome_trace(metadata=meta)
    if path is None:
        d = trace_dir()
        os.makedirs(d, exist_ok=True)
        safe = "".join(c if c.isalnum() or c in "-_." else "_" for c in reason)
        path = os.path.join(
            d, "flight-%s-%d-%d.json" % (safe[:48], os.getpid(), int(time.time() * 1000))
        )
    else:
        parent = os.path.dirname(os.path.abspath(path))
        if parent:
            os.makedirs(parent, exist_ok=True)
    with open(path, "w") as f:
        json.dump(doc, f)
    return path


def auto_dump(reason: str, extra: Optional[Dict[str, Any]] = None) -> Optional[str]:
    """Capped variant for automatic hooks. Returns the written path, or
    None once the per-process cap is exhausted or the recorder is
    empty."""
    global _auto_dumps
    if core.recorder().span_count() == 0:
        return None
    with _auto_lock:
        if _auto_dumps >= _MAX_AUTO_DUMPS:
            return None
        _auto_dumps += 1
    try:
        return dump_flight_record(reason=reason, extra=extra)
    except Exception:
        return None
