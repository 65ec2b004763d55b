"""Wire encoding of the struct dataclasses, for API-shaped results.

A copy of ``to_wire`` from the reference package's codec: dataclasses
become JSON objects tagged with ``__t`` (the class name), enums collapse
to their values, sets are tagged, and scalars pass through.  The decoder
(``from_wire``) and its type registry serve the WAL and replication,
which this package does not have yet.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Dict


def to_wire(obj: Any) -> Any:
    """Recursively convert an object graph to JSON-compatible data."""
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, enum.Enum):
        return obj.value
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        out: Dict[str, Any] = {"__t": type(obj).__name__}
        for f in dataclasses.fields(obj):
            out[f.name] = to_wire(getattr(obj, f.name))
        return out
    if isinstance(obj, dict):
        return {str(k): to_wire(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [to_wire(v) for v in obj]
    if isinstance(obj, (set, frozenset)):
        return {"__set": [to_wire(v) for v in obj]}
    raise TypeError(f"not wire-serializable: {type(obj).__name__}")
