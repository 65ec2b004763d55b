"""Observability pass (rules O001–O004).

The flight recorder is only as good as its coverage: a chaos seam that
fires without leaving a trace event is invisible in the post-mortem
dump, so a fault-triggered failure can't be lined up against the spans
it perturbed.  The contract is simple — **every injector call site must
emit a trace event on the same path** — and this pass enforces it:

* **O001 seam without trace emission** — an ``inject(...)``/``_chaos(...)``
  call site with a literal seam string whose enclosing function never
  calls ``trace.event``/``trace.span``/``trace.record_span``, and whose
  injector function is not a module-local wrapper that emits the event
  itself (driver.py's ``_chaos`` pattern).

* **O002 SLO objective is not a registered metric** — an
  ``SLOSpec(...)`` call site whose literal ``objective=`` string does
  not resolve to any metric name the codebase registers.  A renamed
  timer would otherwise silently turn the SLO into a constant (never
  sampled, never breached, forever ``pending``).  "Registered" means
  any of: a literal first argument to ``timer(...)``/``incr(...)``/
  ``gauge_fn(...)``/``set_gauge(...)``; ``nomad.phase.<name>`` for a
  literal ``span(...)``/``record_span(...)`` name (trace spans feed
  phase timers); or a literal ``nomad.*`` string used as a dict-store
  key (the agent/observatory hand-rolled snapshot pattern).  The name
  set is collected from the whole tree, so the check is a ``run``-level
  pass; :func:`collect_metric_names` + :func:`analyze_slo_objectives`
  expose the two halves for fixtures.

* **O003 silent actuator decision** — a call site of an overload
  actuator (``set_gate_level(...)`` / ``set_shedding(...)``) whose
  enclosing function does not BOTH emit a trace event and increment a
  literal ``nomad.*`` counter (``.incr("nomad....")``).  The control
  loop's whole defense against oscillation arguments is an audit trail:
  a gate level or shed toggle that moves without a trace event and a
  counter can't be correlated with the 429s/deferrals it caused, and
  "why did throughput halve at 14:03" becomes unanswerable.
  :func:`analyze_actuators` is the per-module fixture API.

* **O004 silent breaker transition** — a call site of the device
  breaker's state mutator (``_apply_transition(...)``,
  ``obs/breaker.py``) whose enclosing function does not BOTH emit a
  trace event and increment a literal ``nomad.*`` counter.  Same
  argument as O003 for the device fault domain: a breaker that flips
  between the device path and the degraded host path without a trace
  event and a counter makes "why did placement latency triple at
  14:03" unanswerable.  :func:`analyze_breaker_transitions` is the
  per-module fixture API.

Shares the seam-site discovery with :mod:`.chaospass` (same
``INJECT_FUNC_NAMES``, same tree walk) so the two passes can't drift
apart on what counts as a seam.
"""

from __future__ import annotations

import ast
import functools
import os
from typing import List, Optional, Set, Tuple

from . import PKG, Finding
from .chaospass import INJECT_FUNC_NAMES

# The trace-emission surface: any of these reached from a seam's
# enclosing function satisfies O001.
TRACE_EMIT_NAMES = frozenset({"event", "span", "record_span"})

_SKIP_FILES = ("chaos/injector.py", "chaos/scenarios.py")


@functools.lru_cache(maxsize=512)
def _parse(src: str) -> ast.Module:
    """One parse a source for the four rules (the trees are only read)."""
    return ast.parse(src)


def _call_name(node: ast.Call) -> Optional[str]:
    if isinstance(node.func, ast.Name):
        return node.func.id
    if isinstance(node.func, ast.Attribute):
        return node.func.attr
    return None


def _emits_trace(node: ast.AST) -> bool:
    """Does this subtree contain a trace-emission call?  Nested function
    definitions are NOT descended into — a trace call in an inner
    closure is its own path, not this one's."""
    for child in ast.iter_child_nodes(node):
        if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if isinstance(child, ast.Call) and _call_name(child) in TRACE_EMIT_NAMES:
            return True
        if _emits_trace(child):
            return True
    return False


def _literal_seam_calls(
    body: ast.AST,
) -> List[Tuple[str, str, int]]:
    """(injector func name, seam string, line) for literal calls directly
    inside ``body`` (not inside nested defs)."""
    out: List[Tuple[str, str, int]] = []
    for child in ast.iter_child_nodes(body):
        if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if isinstance(child, ast.Call):
            fname = _call_name(child)
            if fname in INJECT_FUNC_NAMES and child.args:
                first = child.args[0]
                if isinstance(first, ast.Constant) and isinstance(
                    first.value, str
                ):
                    out.append((fname, first.value, child.lineno))
        out.extend(_literal_seam_calls(child))
    return out


def analyze_module(rel: str, src: str) -> List[Finding]:
    """Pure per-module check — the test fixture API."""
    try:
        tree = _parse(src)
    except SyntaxError:
        return []

    # Module-local injector wrappers that emit the event themselves
    # (driver.py's ``def _chaos(point, ...): ... trace.event(...)``):
    # calls THROUGH them are covered regardless of the caller's body.
    covered_wrappers: Set[str] = set()
    funcs: List[Tuple[str, ast.AST]] = []

    def visit(node: ast.AST, prefix: str) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = f"{prefix}.{child.name}" if prefix else child.name
                funcs.append((qual, child))
                if child.name in INJECT_FUNC_NAMES and _emits_trace(child):
                    covered_wrappers.add(child.name)
                visit(child, qual)
            elif isinstance(child, ast.ClassDef):
                visit(child, f"{prefix}.{child.name}" if prefix else child.name)
            else:
                visit(child, prefix)

    visit(tree, "")

    findings: List[Finding] = []
    scopes: List[Tuple[str, ast.AST]] = [("<module>", tree)] + funcs
    for qual, scope in scopes:
        seam_calls = _literal_seam_calls(scope)
        if not seam_calls:
            continue
        emits = _emits_trace(scope)
        for fname, seam, line in seam_calls:
            if fname in covered_wrappers:
                continue  # the wrapper emits the event for every caller
            if emits:
                continue
            findings.append(Finding(
                "O001", rel, line, qual,
                f"chaos seam `{seam}` fires here but `{qual}` never emits "
                f"a trace event (trace.event/span/record_span) — the fault "
                f"is invisible in flight-recorder dumps",
            ))
    return findings


# -- O002: SLO objectives must resolve to registered metrics -----------

# Calls whose literal first string argument registers a metric name.
METRIC_REG_NAMES = frozenset({"timer", "incr", "gauge_fn", "set_gauge"})
# Calls whose literal first string argument names a trace span — spans
# feed `nomad.phase.<name>` timers via trace.record_span.
SPAN_REG_NAMES = frozenset({"span", "record_span"})


def _first_str_arg(call: ast.Call) -> Optional[str]:
    if call.args and isinstance(call.args[0], ast.Constant) and isinstance(
        call.args[0].value, str
    ):
        return call.args[0].value
    return None


def collect_metric_names(src: str) -> Set[str]:
    """Every metric name this module registers (see O002 docstring)."""
    try:
        tree = _parse(src)
    except SyntaxError:
        return set()
    names: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            fname = _call_name(node)
            first = _first_str_arg(node)
            if first is None:
                continue
            if fname in METRIC_REG_NAMES:
                names.add(first)
            elif fname in SPAN_REG_NAMES:
                names.add("nomad.phase." + first)
        elif isinstance(node, ast.Assign):
            # snap["nomad.broker.total_ready"] = ... — the hand-rolled
            # snapshot keys in api/agent.py and obs/evaluator.py.
            for tgt in node.targets:
                if (
                    isinstance(tgt, ast.Subscript)
                    and isinstance(tgt.slice, ast.Constant)
                    and isinstance(tgt.slice.value, str)
                    and tgt.slice.value.startswith("nomad.")
                ):
                    names.add(tgt.slice.value)
    return names


def _slo_objectives(src: str) -> List[Tuple[str, str, int]]:
    """(slo name, literal objective, line) for every SLOSpec(...) call
    whose objective is a string literal (keyword or 2nd positional)."""
    try:
        tree = _parse(src)
    except SyntaxError:
        return []
    out: List[Tuple[str, str, int]] = []
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call) and _call_name(node) == "SLOSpec"):
            continue
        objective = None
        slo_name = "?"
        for kw in node.keywords:
            if kw.arg == "objective" and isinstance(
                kw.value, ast.Constant
            ) and isinstance(kw.value.value, str):
                objective = kw.value.value
            if kw.arg == "name" and isinstance(
                kw.value, ast.Constant
            ) and isinstance(kw.value.value, str):
                slo_name = kw.value.value
        if objective is None and len(node.args) >= 2:
            a = node.args[1]
            if isinstance(a, ast.Constant) and isinstance(a.value, str):
                objective = a.value
            a0 = node.args[0]
            if isinstance(a0, ast.Constant) and isinstance(a0.value, str):
                slo_name = a0.value
        if objective is not None:
            out.append((slo_name, objective, node.lineno))
    return out


def analyze_slo_objectives(
    rel: str, src: str, registered: Set[str]
) -> List[Finding]:
    """Pure O002 check of one module against a known name set."""
    findings: List[Finding] = []
    for slo_name, objective, line in _slo_objectives(src):
        if objective in registered:
            continue
        findings.append(Finding(
            "O002", rel, line, slo_name,
            f"SLO `{slo_name}` objective `{objective}` does not resolve "
            f"to any registered metric (timer/incr/gauge_fn/set_gauge, "
            f"trace span, or snapshot key) — the SLO would never sample",
        ))
    return findings


# -- O003: actuator decisions must trace + count ------------------------

# The overload actuator surface: any attribute/name call of these is a
# control decision taking effect (obs/controller.py's _actuate_* sites).
ACTUATOR_CALL_NAMES = frozenset({"set_gate_level", "set_shedding"})


def _actuator_calls(body: ast.AST) -> List[Tuple[str, int]]:
    """(actuator name, line) for calls directly inside ``body`` (nested
    defs excluded — same scoping discipline as the seam walk)."""
    out: List[Tuple[str, int]] = []
    for child in ast.iter_child_nodes(body):
        if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if isinstance(child, ast.Call):
            fname = _call_name(child)
            if fname in ACTUATOR_CALL_NAMES:
                out.append((fname, child.lineno))
        out.extend(_actuator_calls(child))
    return out


def _incrs_registered_counter(node: ast.AST) -> bool:
    """Does this subtree call ``.incr`` with a literal ``nomad.*`` name?
    Nested defs are not descended into."""
    for child in ast.iter_child_nodes(node):
        if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if (
            isinstance(child, ast.Call)
            and _call_name(child) == "incr"
            and (first := _first_str_arg(child)) is not None
            and first.startswith("nomad.")
        ):
            return True
        if _incrs_registered_counter(child):
            return True
    return False


def analyze_actuators(rel: str, src: str) -> List[Finding]:
    """Pure per-module O003 check — the test fixture API."""
    try:
        tree = _parse(src)
    except SyntaxError:
        return []

    funcs: List[Tuple[str, ast.AST]] = []

    def visit(node: ast.AST, prefix: str) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = f"{prefix}.{child.name}" if prefix else child.name
                funcs.append((qual, child))
                visit(child, qual)
            elif isinstance(child, ast.ClassDef):
                visit(child, f"{prefix}.{child.name}" if prefix else child.name)
            else:
                visit(child, prefix)

    visit(tree, "")

    findings: List[Finding] = []
    for qual, scope in [("<module>", tree)] + funcs:
        calls = _actuator_calls(scope)
        if not calls:
            continue
        missing = []
        if not _emits_trace(scope):
            missing.append("a trace event")
        if not _incrs_registered_counter(scope):
            missing.append('a literal `nomad.*` counter incr')
        if not missing:
            continue
        for fname, line in calls:
            findings.append(Finding(
                "O003", rel, line, qual,
                f"overload actuator `{fname}` moves here but `{qual}` "
                f"never emits {' or '.join(missing)} — the control "
                f"decision is unauditable (no way to line the flip up "
                f"with the 429s/sheds it caused)",
            ))
    return findings


# -- O004: breaker state transitions must trace + count -----------------

# The device-breaker mutation surface: _apply_transition is the only
# place the breaker's state actually moves (obs/breaker.py); every scope
# calling it owns the trace event + counter emission.
BREAKER_CALL_NAMES = frozenset({"_apply_transition"})


def _breaker_calls(body: ast.AST) -> List[Tuple[str, int]]:
    """(mutator name, line) for calls directly inside ``body`` (nested
    defs excluded — same scoping discipline as the actuator walk)."""
    out: List[Tuple[str, int]] = []
    for child in ast.iter_child_nodes(body):
        if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if isinstance(child, ast.Call):
            fname = _call_name(child)
            if fname in BREAKER_CALL_NAMES:
                out.append((fname, child.lineno))
        out.extend(_breaker_calls(child))
    return out


def analyze_breaker_transitions(rel: str, src: str) -> List[Finding]:
    """Pure per-module O004 check — the test fixture API."""
    try:
        tree = _parse(src)
    except SyntaxError:
        return []

    funcs: List[Tuple[str, ast.AST]] = []

    def visit(node: ast.AST, prefix: str) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = f"{prefix}.{child.name}" if prefix else child.name
                funcs.append((qual, child))
                visit(child, qual)
            elif isinstance(child, ast.ClassDef):
                visit(child, f"{prefix}.{child.name}" if prefix else child.name)
            else:
                visit(child, prefix)

    visit(tree, "")

    findings: List[Finding] = []
    for qual, scope in [("<module>", tree)] + funcs:
        calls = _breaker_calls(scope)
        if not calls:
            continue
        # The mutator's own definition is not a call site of itself.
        if qual.endswith("_apply_transition"):
            continue
        missing = []
        if not _emits_trace(scope):
            missing.append("a trace event")
        if not _incrs_registered_counter(scope):
            missing.append('a literal `nomad.*` counter incr')
        if not missing:
            continue
        for fname, line in calls:
            findings.append(Finding(
                "O004", rel, line, qual,
                f"breaker transition `{fname}` moves here but `{qual}` "
                f"never emits {' or '.join(missing)} — the device path "
                f"flipped (device ↔ refusing while open) with no way to "
                f"line it up with the latency it caused",
            ))
    return findings


def _walk_sources(root: str):
    pkg = os.path.join(root, PKG)
    for dirpath, dirnames, filenames in os.walk(pkg):
        dirnames[:] = [d for d in dirnames if d not in ("__pycache__", "lint")]
        for fn in sorted(filenames):
            if not fn.endswith(".py"):
                continue
            p = os.path.join(dirpath, fn)
            rel = os.path.relpath(p, root).replace(os.sep, "/")
            with open(p) as fh:
                src = fh.read()
            yield rel, src


def run(root: str) -> List[Finding]:
    findings: List[Finding] = []
    # Phase 1: collect the registered-metric universe (all modules,
    # including the O001-skipped ones — they still register metrics).
    registered: Set[str] = set()
    sources = list(_walk_sources(root))
    for _rel, src in sources:
        registered |= collect_metric_names(src)
    # Phase 2: per-module rules.
    for rel, src in sources:
        if not rel.endswith(_SKIP_FILES):
            findings.extend(analyze_module(rel, src))
            findings.extend(analyze_actuators(rel, src))
            findings.extend(analyze_breaker_transitions(rel, src))
        findings.extend(analyze_slo_objectives(rel, src, registered))
    return findings
