"""Lock-discipline pass (rules L001–L004).

Builds a per-function summary of lock activity from the AST — which
canonical locks each ``with`` block acquires, what the function calls
while holding them, where it waits and where it blocks — then checks the
graph against the declared hierarchy in :mod:`.lock_order`:

* **L001 lock-order inversion** — acquiring a ranked lock while holding
  a ranked lock of higher (inner) rank, directly or through a resolvable
  call (one-level interprocedural: ``self.method()`` and
  ``self.<attr>.method()`` via ``lock_order.ATTR_TYPES``, closed under a
  fixpoint so chains resolve).
* **L002 wait holding a foreign lock** — ``Condition.wait``/``wait_for``
  releases only its own lock; waiting while holding a *different* ranked
  lock parks that lock for the whole wait (the deadlock shape).
* **L003 blocking call in a critical section** — ``time.sleep``, RPC
  verbs (``_call``/``_post``/``replicate``), subprocess/urlopen, file
  I/O through the WAL, ``Event.wait``, and device→host waits
  (``.cpu()``/``.item()``/``.tolist()``/``synchronize``) while holding
  a lock.  Holding only ``device`` exempts the matrix's copies to the
  device (``sync``/``sync_sharded``) — serializing those is that lock's
  job.
* **L004 literal-bounded condvar wait** — ``cond.wait(timeout=<literal>)``
  on the condvar's *own* lock: a numeric-literal timeout papers over a
  lost notify with polling.  Timeouts that flow from parameters or
  computed deadlines (real timers) are not flagged.

The pass is lexical about lock identity (attribute aliases declared in
``lock_order.ALIASES``) — it never imports the code under analysis.
"""

from __future__ import annotations

import ast
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

from . import PKG, Finding
from . import lock_order as lo

# Directories (repo-relative, under nomad_tpu_torch/) the pass covers.
SCAN_DIRS = ("server", "scheduler", "state", "client", "stream")
SCAN_FILES = ("metrics.py", os.path.join("chaos", "injector.py"))

FuncKey = Tuple[str, Optional[str], str]  # (modpath, class, func)


@dataclass
class _Event:
    kind: str  # acquire | call | block | wait
    line: int
    held: Tuple[str, ...]  # canonical/unknown lock names held at the event
    lock: Optional[str] = None  # acquire: the lock; wait: the receiver
    callee: Optional[FuncKey] = None
    desc: str = ""
    timed_literal: bool = False  # wait: a numeric-literal timeout flowed in


@dataclass
class _FuncSummary:
    key: FuncKey
    symbol: str
    events: List[_Event] = field(default_factory=list)
    direct_acquires: Set[str] = field(default_factory=set)
    direct_blocking: List[Tuple[int, str]] = field(default_factory=list)


def _modkey(root: str, path: str) -> str:
    return os.path.relpath(path, root).replace(os.sep, "/")


def _is_self(node: ast.AST) -> bool:
    return isinstance(node, ast.Name) and node.id == "self"


def _dotted(node: ast.AST) -> Optional[str]:
    """`a.b.c` -> "a.b.c" for pure Name/Attribute chains."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


class _FuncVisitor(ast.NodeVisitor):
    """Walks ONE function body, tracking the with-held lock stack."""

    def __init__(self, modpath: str, cls: Optional[str], summary: _FuncSummary):
        self.modpath = modpath
        self.cls = cls
        self.s = summary
        self.held: List[str] = []
        # name -> "self.<attr>" aliases (replicator = self.replicator)
        self.aliases: Dict[str, str] = {}

    # -- lock identity -------------------------------------------------

    def _lock_name(self, node: ast.AST) -> Optional[str]:
        """Canonical (or synthetic-unknown) lock name of an expression
        used as a lock, or None if it doesn't look like one."""
        if isinstance(node, ast.Name):
            if node.id in lo.GLOBAL_NAME_ALIASES:
                return lo.GLOBAL_NAME_ALIASES[node.id]
            target = self.aliases.get(node.id)
            if target:
                return self._attr_lock(target.split(".", 1)[1])
            return None
        if isinstance(node, ast.Attribute) and _is_self(node.value):
            return self._attr_lock(node.attr)
        return None

    def _attr_lock(self, attr: str) -> Optional[str]:
        canon = lo.resolve(self.modpath, self.cls, attr)
        if canon:
            return canon
        if attr.rstrip("_").endswith(("lock", "cond")) or attr in ("_cv",):
            return f"{self.modpath}:{self.cls or '<module>'}.{attr}"
        return None

    # -- traversal -----------------------------------------------------

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        pass  # nested defs get their own summary

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node: ast.Lambda) -> None:
        pass

    def visit_Assign(self, node: ast.Assign) -> None:
        if (
            len(node.targets) == 1
            and isinstance(node.targets[0], ast.Name)
            and isinstance(node.value, ast.Attribute)
            and _is_self(node.value.value)
        ):
            self.aliases[node.targets[0].id] = f"self.{node.value.attr}"
        self.generic_visit(node)

    def visit_With(self, node: ast.With) -> None:
        acquired: List[str] = []
        for item in node.items:
            name = self._lock_name(item.context_expr)
            if name is not None:
                self.s.events.append(_Event(
                    "acquire", item.context_expr.lineno,
                    tuple(self.held), lock=name,
                ))
                self.s.direct_acquires.add(name)
                self.held.append(name)
                acquired.append(name)
            else:
                self.generic_visit(item.context_expr)
        for stmt in node.body:
            self.visit(stmt)
        for _ in acquired:
            self.held.pop()

    def visit_Call(self, node: ast.Call) -> None:
        self._classify_call(node)
        self.generic_visit(node)

    # -- call classification -------------------------------------------

    def _timeout_is_literal(self, node: ast.Call) -> bool:
        """True when a numeric literal flows into the wait's timeout
        (positionally or by keyword, directly or through an IfExp arm)."""
        args: List[ast.AST] = []
        # wait(timeout) / wait_for(pred, timeout)
        fname = node.func.attr if isinstance(node.func, ast.Attribute) else ""
        pos = 0 if fname == "wait" else 1
        if len(node.args) > pos:
            args.append(node.args[pos])
        for kw in node.keywords:
            if kw.arg == "timeout":
                args.append(kw.value)

        def literal(e: ast.AST) -> bool:
            if isinstance(e, ast.Constant):
                return isinstance(e.value, (int, float)) and not isinstance(
                    e.value, bool
                )
            if isinstance(e, ast.IfExp):
                return literal(e.body) or literal(e.orelse)
            if isinstance(e, ast.Name):
                tl = self._literal_names.get(e.id)
                return bool(tl)
            return False

        return any(literal(a) for a in args)

    _literal_names: Dict[str, bool] = {}

    def _classify_call(self, node: ast.Call) -> None:
        held = tuple(self.held)
        func = node.func
        dotted = _dotted(func)

        # Condition/Event waits.
        if isinstance(func, ast.Attribute) and func.attr in ("wait", "wait_for"):
            recv_lock = self._lock_name(func.value)
            if recv_lock is not None:
                self.s.events.append(_Event(
                    "wait", node.lineno, held, lock=recv_lock,
                    timed_literal=self._timeout_is_literal(node),
                ))
                return
            if held and func.attr == "wait":
                # Event.wait (or an un-aliased latch) inside a section.
                self.s.events.append(_Event(
                    "block", node.lineno, held,
                    desc=f"{_dotted(func) or func.attr}() wait",
                ))
                return

        desc: Optional[str] = None
        if dotted in lo.BLOCKING_DOTTED:
            desc = f"{dotted}()"
        elif dotted in lo.DEVICE_FETCH_DOTTED:
            desc = f"{dotted}() device fetch"
        elif isinstance(func, ast.Name) and func.id == "open":
            desc = "open() file I/O"
        elif isinstance(func, ast.Attribute):
            if func.attr in lo.BLOCKING_ATTR_NAMES:
                desc = f".{func.attr}() network call"
            elif func.attr in lo.DEVICE_FETCH_ATTR_NAMES:
                desc = f".{func.attr}() device fetch"
            else:
                recv = func.value
                recv_attr = None
                if isinstance(recv, ast.Attribute) and _is_self(recv.value):
                    recv_attr = recv.attr
                elif isinstance(recv, ast.Name):
                    tgt = self.aliases.get(recv.id)
                    if tgt:
                        recv_attr = tgt.split(".", 1)[1]
                if recv_attr in lo.BLOCKING_RECEIVER_ATTRS:
                    desc = f"self.{recv_attr}.{func.attr}() file I/O"
                elif (
                    held == ("device",)
                    and func.attr in lo.DEVICE_OP_ATTR_NAMES
                ):
                    desc = None  # launching under the device lock is its job
        if desc is not None:
            self.s.direct_blocking.append((node.lineno, desc))
            if held:
                self.s.events.append(_Event("block", node.lineno, held, desc=desc))
            return

        # Resolvable calls for the interprocedural walk.
        callee = self._callee_key(func)
        if callee is not None:
            self.s.events.append(_Event(
                "call", node.lineno, held, callee=callee,
            ))

    def _callee_key(self, func: ast.AST) -> Optional[FuncKey]:
        if isinstance(func, ast.Name):
            return (self.modpath, None, func.id)
        if isinstance(func, ast.Attribute):
            recv = func.value
            if _is_self(recv):
                return (self.modpath, self.cls, func.attr)
            if isinstance(recv, ast.Attribute) and _is_self(recv.value):
                typed = lo.ATTR_TYPES.get(recv.attr)
                if typed:
                    return (typed[0], typed[1], func.attr)
        return None


def _collect_literal_timeout_names(fn: ast.AST) -> Dict[str, bool]:
    """Names in this function assigned a numeric literal (or an IfExp of
    literals) — feeds the L004 'literal-bounded wait' detection through
    one assignment hop (``timeout = 0.2 if busy else None``)."""
    out: Dict[str, bool] = {}

    def literal(e: ast.AST) -> bool:
        if isinstance(e, ast.Constant):
            return isinstance(e.value, (int, float)) and not isinstance(e.value, bool)
        if isinstance(e, ast.IfExp):
            return literal(e.body) or literal(e.orelse)
        return False

    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            t = node.targets[0]
            if isinstance(t, ast.Name):
                out[t.id] = literal(node.value)
    return out


# ----------------------------------------------------------------------
# Module walk
# ----------------------------------------------------------------------


def summarize_module(modpath: str, tree: ast.Module) -> List[_FuncSummary]:
    out: List[_FuncSummary] = []

    def walk_body(body: Sequence[ast.stmt], cls: Optional[str], prefix: str) -> None:
        for node in body:
            if isinstance(node, ast.ClassDef):
                walk_body(node.body, node.name, f"{node.name}.")
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                key: FuncKey = (modpath, cls, node.name)
                s = _FuncSummary(key=key, symbol=f"{prefix}{node.name}")
                v = _FuncVisitor(modpath, cls, s)
                v._literal_names = _collect_literal_timeout_names(node)
                for stmt in node.body:
                    v.visit(stmt)
                out.append(s)
                # Nested defs (decorator wrappers like @journaled's
                # `wrapper`) are real lock scopes — summarize them too.
                for stmt in node.body:
                    for sub in ast.walk(stmt):
                        if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                            k2: FuncKey = (modpath, cls, sub.name)
                            s2 = _FuncSummary(
                                key=k2, symbol=f"{prefix}{node.name}.{sub.name}"
                            )
                            v2 = _FuncVisitor(modpath, cls, s2)
                            v2._literal_names = _collect_literal_timeout_names(sub)
                            for st in sub.body:
                                v2.visit(st)
                            out.append(s2)

    walk_body(tree.body, None, "")
    return out


# ----------------------------------------------------------------------
# Checking
# ----------------------------------------------------------------------


def _transitive_acquires(
    summaries: Dict[FuncKey, _FuncSummary]
) -> Dict[FuncKey, Set[str]]:
    acq = {k: set(s.direct_acquires) for k, s in summaries.items()}
    changed = True
    while changed:
        changed = False
        for k, s in summaries.items():
            for ev in s.events:
                if ev.kind == "call" and ev.callee in acq:
                    before = len(acq[k])
                    acq[k] |= acq[ev.callee]
                    if len(acq[k]) != before:
                        changed = True
    return acq


def check_summaries(summaries: List[_FuncSummary]) -> List[Finding]:
    by_key = {s.key: s for s in summaries}
    trans = _transitive_acquires(by_key)
    findings: List[Finding] = []

    def inversion(held: Tuple[str, ...], lock: str) -> Optional[str]:
        r = lo.rank(lock)
        if r is None:
            return None
        if lock in held:
            # Re-entrant re-acquisition (the store's RLocks; e.g.
            # install_snapshot -> restore -> @journaled taking
            # _write_lock again) adds no ordering edge.
            return None
        for h in held:
            hr = lo.rank(h)
            if hr is not None and h != lock and r < hr:
                return h
        return None

    for s in summaries:
        path = s.key[0]
        for ev in s.events:
            if ev.kind == "acquire":
                outer = inversion(ev.held, ev.lock or "")
                if outer:
                    findings.append(Finding(
                        "L001", path, ev.line, s.symbol,
                        f"lock-order inversion: acquires '{ev.lock}' while "
                        f"holding '{outer}' (declared order: "
                        f"{' -> '.join(lo.ORDER)})",
                    ))
            elif ev.kind == "call" and ev.callee in trans:
                for lock in sorted(trans[ev.callee]):
                    outer = inversion(ev.held, lock)
                    if outer:
                        callee = ev.callee[2]
                        findings.append(Finding(
                            "L001", path, ev.line, s.symbol,
                            f"lock-order inversion via call: {callee}() "
                            f"acquires '{lock}' while '{outer}' is held",
                        ))
                # One-level blocking propagation: a callee that blocks
                # directly blocks this critical section too.
                if ev.held:
                    callee_s = by_key.get(ev.callee)
                    if callee_s is not None and callee_s.direct_blocking:
                        _, desc = callee_s.direct_blocking[0]
                        findings.append(Finding(
                            "L003", path, ev.line, s.symbol,
                            f"blocking call in critical section (holding "
                            f"{list(ev.held)}): {ev.callee[2]}() -> {desc}",
                        ))
            elif ev.kind == "block":
                findings.append(Finding(
                    "L003", path, ev.line, s.symbol,
                    f"blocking call in critical section (holding "
                    f"{list(ev.held)}): {ev.desc}",
                ))
            elif ev.kind == "wait":
                foreign = [
                    h for h in ev.held
                    if h != ev.lock and lo.rank(h) is not None
                ]
                if foreign:
                    findings.append(Finding(
                        "L002", path, ev.line, s.symbol,
                        f"Condition.wait on '{ev.lock}' while holding "
                        f"foreign lock(s) {foreign} — the wait parks them "
                        f"for its whole duration",
                    ))
                elif ev.timed_literal:
                    findings.append(Finding(
                        "L004", path, ev.line, s.symbol,
                        f"literal-bounded wait on '{ev.lock}': a hardcoded "
                        f"timeout polls around a lost notify instead of "
                        f"fixing the notify discipline",
                    ))
    return findings


# ----------------------------------------------------------------------
# Entry points
# ----------------------------------------------------------------------


def analyze_sources(sources: Dict[str, str]) -> List[Finding]:
    """Analyze {repo-relative path: source text} — the test fixture API."""
    summaries: List[_FuncSummary] = []
    for path, src in sources.items():
        summaries += summarize_module(path, ast.parse(src))
    return check_summaries(summaries)


def run(root: str) -> List[Finding]:
    pkg = os.path.join(root, PKG)
    paths: List[str] = []
    for d in SCAN_DIRS:
        base = os.path.join(pkg, d)
        for dirpath, _dirnames, filenames in os.walk(base):
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    paths.append(os.path.join(dirpath, fn))
    for f in SCAN_FILES:
        p = os.path.join(pkg, f)
        if os.path.exists(p):
            paths.append(p)

    summaries: List[_FuncSummary] = []
    for p in sorted(paths):
        with open(p) as fh:
            src = fh.read()
        summaries += summarize_module(_modkey(root, p), ast.parse(src))
    return check_summaries(summaries)
