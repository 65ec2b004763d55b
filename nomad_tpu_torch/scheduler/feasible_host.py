"""Host-side constraint evaluation for non-vectorizable operators.

The kernels evaluate hash-equality, numeric and version predicates for every
node in one pass (ops/kernels.py). Operators that cannot vectorize — regexp,
set_contains, lexical ordering, multi-clause version ranges — escape here and
are evaluated **once per computed class** (the reference's own optimization:
ComputedClass feasibility cache, scheduler/feasible.go:1029,
nomad/structs/node_class.go:28-37), or per node for unique attributes.

Reference semantics: checkConstraint (feasible.go:793-858) and the operator
implementations at feasible.go:860-1020.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

from ..state.matrix import node_attributes, version_value
from ..structs.types import Constraint, Node, Op

_regex_cache: Dict[str, Optional[re.Pattern]] = {}
_version_clause_re = re.compile(r"^\s*(>=|<=|>|<|=|!=|~>)?\s*v?([\d.]+)\s*$")


def _lookup_attr(node: Node, target: str) -> Optional[str]:
    """Resolve ``${attr.x}`` / ``${meta.y}`` / ``${node.class}`` to a value
    (reference: resolveTarget, feasible.go:748-790)."""
    name = target
    if name.startswith("${") and name.endswith("}"):
        name = name[2:-1]
    if name.startswith("attr."):
        name = name[len("attr.") :]
    attrs = node_attributes(node)
    return attrs.get(name) or None


def _check_regexp(value: str, pattern: str) -> bool:
    compiled = _regex_cache.get(pattern)
    if pattern not in _regex_cache:
        try:
            compiled = re.compile(pattern)
        except re.error:
            compiled = None
        _regex_cache[pattern] = compiled
    return compiled is not None and compiled.search(value) is not None


def _check_version(value: str, spec: str) -> bool:
    """Constraint-style version check supporting comma-separated clauses
    (e.g. ``>= 1.0, < 2.0``). ``~>`` is pessimistic (same major, >= given)."""
    packed = version_value(value)
    if packed != packed:  # NaN
        return False
    for clause in spec.split(","):
        m = _version_clause_re.match(clause)
        if not m:
            return False
        op = m.group(1) or "="
        want = version_value(m.group(2))
        if want != want:
            return False
        if op == "~>":
            parts = m.group(2).split(".")
            major = float(int(parts[0]))
            if not (packed >= want and (packed // 1e6) == major):
                return False
        elif op == ">=" and not packed >= want:
            return False
        elif op == "<=" and not packed <= want:
            return False
        elif op == ">" and not packed > want:
            return False
        elif op == "<" and not packed < want:
            return False
        elif op == "=" and not packed == want:
            return False
        elif op == "!=" and not packed != want:
            return False
    return True


def check_constraint_host(con: Constraint, node: Node) -> bool:
    """Evaluate one escaped constraint against one node."""
    operand = con.operand
    if operand == Op.IS_SET.value:
        return _lookup_attr(node, con.l_target) is not None
    if operand == Op.IS_NOT_SET.value:
        return _lookup_attr(node, con.l_target) is None

    value = _lookup_attr(node, con.l_target)
    if operand in (Op.NEQ.value, "not"):
        return value is None or value != con.r_target
    if value is None:
        return False

    if operand in (Op.EQ.value, "==", "is"):
        return value == con.r_target
    if operand == Op.REGEXP.value:
        return _check_regexp(value, con.r_target)
    if operand in (Op.VERSION.value, Op.SEMVER.value):
        return _check_version(value, con.r_target)
    if operand == Op.SET_CONTAINS.value:
        have = {p.strip() for p in value.split(",")}
        want = [p.strip() for p in con.r_target.split(",")]
        return all(w in have for w in want)
    if operand == Op.SET_CONTAINS_ANY.value:
        have = {p.strip() for p in value.split(",")}
        return any(p.strip() in have for p in con.r_target.split(","))
    # Lexical ordering fallback for non-numeric <, >, ... (feasible.go:918).
    if operand == Op.LT.value:
        return value < con.r_target
    if operand == Op.LTE.value:
        return value <= con.r_target
    if operand == Op.GT.value:
        return value > con.r_target
    if operand == Op.GTE.value:
        return value >= con.r_target
    return False


def check_host_volumes(node: Node, volumes: List[str]) -> bool:
    """HostVolumeChecker (feasible.go:132)."""
    return all(v in node.host_volumes for v in volumes)
