"""Dispatch hot-path pass (rules H001–H003), the port's counterpart of
the reference's JAX pass (``nomad_tpu/lint/jaxpass.py``, J001–J005).

The card-side dispatch stays fast only while the host never waits for
the card except at the one place built for it: each ticket's result is
copied into a page-locked tensor behind its own kernels, and the
resolver polls that copy's event (``scheduler/coalescer.py``).  A
``.cpu()``/``.item()`` on a device tensor anywhere else waits for every
launch queued before it on the stream and collapses the pipeline.  The
pass checks, lexically, the port's dispatch modules — ``ops/``,
``parallel/``, ``scheduler/coalescer.py`` and ``state/matrix.py``:

* **H001 host sync on a device value** — a name bound from a
  device-producing call (a kernel wrapper such as ``fused_place`` or
  ``kernels.*``, an ``upload(...)``, the sharded entries or the
  coalescer's bound ``fused_fn``/``staged_fn``) later hits ``.item()``,
  ``.cpu()``, ``.tolist()``, ``.numpy()``, ``np.asarray``/``np.array``
  or ``bool()``/``int()``/``float()`` — directly, through a subscript,
  attribute or method call of it, or fed the call itself; and any
  ``synchronize()``, which waits for the whole card.  The ticket's copy
  (``host.copy_(packed, non_blocking=True)`` and ``ticket.host.numpy()``
  after its event) reads a host tensor and is not flagged; any other
  designated fetch is a baseline exemption, not a rule carve-out, so
  moving it shows up in review.
* **H002 node-axis fetch on a fused or sharded dispatch** — a function
  that drives the fused or node-sharded dispatch entry points
  (``fused_place_batch``, ``sharded_fused_place_batch``,
  ``sharded_place_batch``, ``sharded_verify`` or the coalescer's bound
  programs) applies one of those sinks to a node-axis-shaped value: a
  ``DeviceArrays`` leaf (``.used``, ``.totals``, ``.attr_hash``, …) or
  a name bound from one.  Only the packed (B, P, 8) winner block may
  cross to the host; an (…, N) fetch is O(nodes) host traffic a
  dispatch.
* **H003 module-level mutable tensor captured by a launch** — a
  function that launches a kernel (calls ``_entry(...)`` or a
  ``_launch*`` helper) reads a module-level name bound to a tensor
  constructor (``torch.zeros``/``empty``/``tensor``/…): the launch then
  hands the kernel a buffer every caller and every thread shares, and
  one launch's writes race the next one's reads.

Tracing, donation and compile-cache cardinality (the reference's
``jaxprpass.py``, J100–J105) have no counterpart here: the port traces
nothing and compiles its kernels once per source.  The runtime shape
and host-byte checks of the reference's contract rows live in
:mod:`.contracts`.
"""

from __future__ import annotations

import ast
import os
from typing import Dict, List, Optional, Set

from . import PKG, Finding

SCAN_DIRS = ("ops", "parallel")
SCAN_FILES = (
    os.path.join("scheduler", "coalescer.py"),
    os.path.join("state", "matrix.py"),
)

# Calls whose results live on the card: the kernel wrappers, the
# uploads, the sharded entries and the coalescer's bound programs.
DEVICE_PRODUCER_PREFIXES = ("kernels.",)
DEVICE_PRODUCER_NAMES = frozenset({
    "upload", "fused_place", "fused_place_batch", "place_batch",
    "allocs_fit_verify", "system_feasible", "score_batch",
    "verify_plan_fit", "sharded_place", "sharded_usage", "sharded_verify",
    "sharded_fused_place_batch", "sharded_place_batch",
    "fused_fn", "staged_fn", "_sharded_fused_fn", "_sharded_fn",
    "_launch_fused_place",
})

# Sinks that wait for the card.
SYNC_CALL_NAMES = frozenset({"float", "int", "bool"})
SYNC_DOTTED = frozenset({
    "np.asarray", "numpy.asarray", "np.array", "numpy.array",
})
SYNC_METHODS = frozenset({"item", "tolist", "cpu", "numpy"})
# Waits for the whole card whatever they are given.
SYNC_ALWAYS = frozenset({"torch.cuda.synchronize", "synchronize"})

# H002: the fused and node-sharded dispatch entry points; a function
# calling one of them is on the fused/sharded path.
FUSED_ENTRY_NAMES = frozenset({
    "fused_place_batch", "sharded_fused_place_batch", "sharded_place_batch",
    "sharded_verify", "fused_fn", "staged_fn", "_sharded_fused_fn",
    "_sharded_fn",
})
# Node-axis-shaped leaves: every DeviceArrays field (state/matrix.py).
NODE_AXIS_ATTRS = frozenset({
    "totals", "used", "eligible", "attr_hash", "attr_num", "attr_ver",
    "class_id", "dev_total", "dev_used", "prio_used", "port_words",
    "dyn_used", "used_after",
})

# H003: tensor constructors at module scope, and the launch calls.
TENSOR_CONSTRUCTORS = frozenset({
    "zeros", "ones", "empty", "full", "tensor", "as_tensor", "arange",
    "from_numpy", "zeros_like", "ones_like", "empty_like", "full_like",
    "rand", "randn", "randint",
})
LAUNCH_CALL_NAMES = frozenset({"_entry"})
LAUNCH_CALL_PREFIX = "_launch"


def _dotted(node: ast.AST) -> Optional[str]:
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _short(node: ast.AST) -> Optional[str]:
    d = _dotted(node)
    return d.rsplit(".", 1)[-1] if d else None


def _is_device_call(node: ast.AST) -> bool:
    if not isinstance(node, ast.Call):
        return False
    d = _dotted(node.func)
    if d is None:
        return False
    if d.rsplit(".", 1)[-1] in DEVICE_PRODUCER_NAMES:
        return True
    return any(d.startswith(p) for p in DEVICE_PRODUCER_PREFIXES)


def _root(node: ast.AST) -> ast.AST:
    """The root of a chain of subscripts, attributes and method calls
    (``packed[0].sum()`` → ``packed``); a plain call is a root."""
    while True:
        if isinstance(node, (ast.Subscript, ast.Attribute)):
            node = node.value
        elif isinstance(node, ast.Call) and isinstance(
                node.func, ast.Attribute) and not _is_device_call(node):
            node = node.func.value
        else:
            return node


def _base_name(node: ast.AST) -> Optional[str]:
    """The Name at the root of a chain (``packed[0]``, ``out.used[:, 0]``,
    ``t.sum()`` → ``packed``, ``out``, ``t``)."""
    root = _root(node)
    return root.id if isinstance(root, ast.Name) else None


def _has_sink(node: ast.AST) -> bool:
    return any(isinstance(n, ast.Call) and _sink(n) is not None
               for n in ast.walk(node))


def _is_tensor_constructor(node: ast.AST) -> bool:
    return (isinstance(node, ast.Call)
            and (_dotted(node.func) or "").startswith("torch.")
            and _short(node.func) in TENSOR_CONSTRUCTORS)


class _ModuleInfo:
    def __init__(self, path: str, tree: ast.Module):
        self.path = path
        self.tree = tree
        # module-level names bound to tensors
        self.tensor_globals: Dict[str, int] = {}
        for node in tree.body:
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                t = node.targets[0]
                if isinstance(t, ast.Name) and _is_tensor_constructor(
                        node.value):
                    self.tensor_globals[t.id] = node.lineno


def _sink(node: ast.Call) -> Optional[str]:
    """The sink's name when ``node`` waits for the card, else None."""
    d = _dotted(node.func)
    if d in SYNC_DOTTED or d in SYNC_ALWAYS:
        return d
    if isinstance(node.func, ast.Attribute) and (
            node.func.attr in SYNC_ALWAYS):
        return f".{node.func.attr}()"
    if isinstance(node.func, ast.Name) and node.func.id in SYNC_CALL_NAMES:
        return node.func.id
    if isinstance(node.func, ast.Attribute) and (
            node.func.attr in SYNC_METHODS):
        return f".{node.func.attr}()"
    return None


def _sink_operands(node: ast.Call) -> List[ast.AST]:
    """What a sink reads: a method's receiver, a function's arguments."""
    if isinstance(node.func, ast.Attribute) and (
            node.func.attr in SYNC_METHODS):
        return [node.func.value]
    return list(node.args)


def _check_function(info: _ModuleInfo, fn: ast.AST, symbol: str,
                    findings: List[Finding]) -> None:
    device_vars: Set[str] = set()
    node_axis_vars: Set[str] = set()
    calls = [n for n in ast.walk(fn) if isinstance(n, ast.Call)]
    fused_caller = any(_short(c.func) in FUSED_ENTRY_NAMES for c in calls)
    launches = any(
        _short(c.func) in LAUNCH_CALL_NAMES
        or (_short(c.func) or "").startswith(LAUNCH_CALL_PREFIX)
        or (isinstance(c.func, ast.Call)
            and _short(c.func.func) in LAUNCH_CALL_NAMES)
        for c in calls)

    # Bindings first (a lexical, flow-insensitive pass, as the
    # reference's): device values and node-axis values by name.
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            t = node.targets[0]
            if not isinstance(t, ast.Name):
                continue
            v = node.value
            if _is_device_call(v):
                device_vars.add(t.id)
            elif isinstance(v, (ast.Name, ast.Subscript, ast.Attribute)) and (
                    _base_name(v) in device_vars):
                device_vars.add(t.id)
            if isinstance(v, ast.Attribute) and v.attr in NODE_AXIS_ATTRS:
                node_axis_vars.add(t.id)

    def device_operand(a: ast.AST) -> Optional[str]:
        if _has_sink(a):
            return None  # the inner sink is the one reported
        root = _root(a)
        if _is_device_call(root):
            return _dotted(root.func) or "<device call>"
        if isinstance(root, ast.Name) and root.id in device_vars:
            return root.id
        return None

    def node_axis_operand(a: ast.AST) -> Optional[str]:
        if isinstance(a, ast.Attribute) and a.attr in NODE_AXIS_ATTRS:
            return _dotted(a) or f".{a.attr}"
        if isinstance(a, ast.Name) and a.id in node_axis_vars:
            return a.id
        return None

    for node in calls:
        sink = _sink(node)
        if sink is None:
            continue
        operands = _sink_operands(node)
        if sink.rsplit(".", 1)[-1].strip("()") in SYNC_ALWAYS:
            findings.append(Finding(
                "H001", info.path, node.lineno, symbol,
                f"host sync: {sink} waits for every launch on the card — "
                f"read results through the ticket's one page-locked copy",
            ))
            continue
        if fused_caller:
            tgt = next((x for x in map(node_axis_operand, operands) if x),
                       None)
            if tgt is not None:
                findings.append(Finding(
                    "H002", info.path, node.lineno, symbol,
                    f"node-axis-shaped value '{tgt}' fetched to the host "
                    f"({sink}) on a fused/sharded dispatch — only the "
                    f"packed (B, P, 8) winner block may cross to the "
                    f"host; an (..., N) fetch is O(nodes) host traffic "
                    f"a dispatch",
                ))
                continue
        hit = next((x for x in map(device_operand, operands) if x), None)
        if hit is not None:
            findings.append(Finding(
                "H001", info.path, node.lineno, symbol,
                f"host sync: {sink} on device value '{hit}' waits for "
                f"every launch queued before it — read results through "
                f"the ticket's one page-locked copy",
            ))

    if launches and info.tensor_globals:
        params = {a.arg for a in fn.args.args}
        assigned = {t.id for n in ast.walk(fn) if isinstance(n, ast.Assign)
                    for t in n.targets if isinstance(t, ast.Name)}
        for node in ast.walk(fn):
            if (isinstance(node, ast.Name)
                    and isinstance(node.ctx, ast.Load)
                    and node.id in info.tensor_globals
                    and node.id not in params
                    and node.id not in assigned):
                findings.append(Finding(
                    "H003", info.path, node.lineno, symbol,
                    f"kernel launch captures module-level tensor "
                    f"'{node.id}' — every caller and thread shares its "
                    f"buffer; allocate it per launch or pass it in",
                ))
                break


def _walk(info: _ModuleInfo, findings: List[Finding]) -> None:
    def walk_body(body, prefix: str) -> None:
        for node in body:
            if isinstance(node, ast.ClassDef):
                walk_body(node.body, f"{prefix}{node.name}.")
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                _check_function(info, node, f"{prefix}{node.name}", findings)
                # Nested defs (the sharded builders' returned ``fn``) are
                # dispatch functions of their own.
                for sub in ast.walk(node):
                    if sub is not node and isinstance(
                            sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                        _check_function(
                            info, sub, f"{prefix}{node.name}.{sub.name}",
                            findings)

    walk_body(info.tree.body, "")


def analyze_sources(sources: Dict[str, str]) -> List[Finding]:
    """Analyze {repo-relative path: source text} — the test fixture API."""
    findings: List[Finding] = []
    for path, src in sources.items():
        _walk(_ModuleInfo(path, ast.parse(src)), findings)
    return findings


def run(root: str) -> List[Finding]:
    pkg = os.path.join(root, PKG)
    paths: List[str] = []
    for d in SCAN_DIRS:
        base = os.path.join(pkg, d)
        if not os.path.isdir(base):
            continue
        for dirpath, _dirnames, filenames in os.walk(base):
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    paths.append(os.path.join(dirpath, fn))
    for f in SCAN_FILES:
        p = os.path.join(pkg, f)
        if os.path.exists(p):
            paths.append(p)
    findings: List[Finding] = []
    for p in sorted(paths):
        with open(p) as fh:
            src = fh.read()
        rel = os.path.relpath(p, root).replace(os.sep, "/")
        _walk(_ModuleInfo(rel, ast.parse(src)), findings)
    return findings
