"""Generic wire (de)serialization for the shared struct dataclasses.

A copy of the reference package's codec: dataclasses become JSON objects
tagged with ``__t`` (the class name, resolved against a registry of all
dataclasses in :mod:`nomad_tpu_torch.structs.types`), enums collapse to
their values, sets are tagged, and scalars pass through.  Tags are class
and field names, so a WAL or snapshot written by either package decodes
in the other.

``from_wire`` tolerates schema drift: unknown fields in the payload are
dropped and missing fields take their dataclass defaults, so an old WAL
or snapshot still loads after a struct gains/loses a field.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Dict

from . import types as _types

# Every dataclass defined in structs.types, by class name.
_REGISTRY: Dict[str, type] = {
    name: obj
    for name, obj in vars(_types).items()
    if isinstance(obj, type) and dataclasses.is_dataclass(obj)
}

_FIELD_CACHE: Dict[type, frozenset] = {}


def register(cls: type) -> type:
    """Register an extra dataclass (outside structs.types) for the codec.
    Usable as a decorator."""
    _REGISTRY[cls.__name__] = cls
    return cls


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


def from_wire(data: Any) -> Any:
    """Inverse of :func:`to_wire`."""
    if isinstance(data, dict):
        tag = data.get("__t")
        if tag is not None:
            cls = _REGISTRY.get(tag)
            if cls is None:
                raise TypeError(f"unknown wire type tag: {tag!r}")
            names = _FIELD_CACHE.get(cls)
            if names is None:
                names = frozenset(f.name for f in dataclasses.fields(cls))
                _FIELD_CACHE[cls] = names
            kwargs = {
                k: from_wire(v)
                for k, v in data.items()
                if k != "__t" and k in names
            }
            return cls(**kwargs)
        if "__set" in data and len(data) == 1:
            return set(from_wire(v) for v in data["__set"])
        return {k: from_wire(v) for k, v in data.items()}
    if isinstance(data, list):
        return [from_wire(v) for v in data]
    return data
