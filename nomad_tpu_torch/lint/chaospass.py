"""Chaos-seam pass (rules C001–C004).

The port's seam catalog, ``nomad_tpu_torch/chaos/CATALOG.md`` (in the
table format of the reference's ``CHAOS.md``, which stays the
reference's), is the contract for the fault-injection surface: the seam
catalog says where faults can land, and the retry-surface section says
which modules recover through ``nomad_tpu_torch/retry.py``.  Both rot
silently — a refactor renames a seam string, a doc row outlives its
call site, a module quietly regrows a hand-rolled sleep loop — and a
stale catalog means chaos runs exercise less than everyone believes.
This pass cross-checks the document against the tree:

* **C001 documented seam missing from code** — a catalog row's seam
  string has no ``inject(...)``/``_chaos(...)`` call site anywhere in
  ``nomad_tpu_torch/``.
* **C002 undocumented code seam** — an injector call site uses a seam
  string with no catalog row.
* **C003 seam not exercised** — a documented seam never appears in
  ``tests/`` or ``chaos/scenarios.py`` (no schedule can have covered
  it).
* **C004 retry-surface drift** — a module the retry-surface section
  names no longer references the shared retry helpers (or no longer
  exists).
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, List, Optional, Set, Tuple

from . import PKG, Finding

# The catalog, repo-relative (findings name it as their path).
DOC_NAME = f"{PKG}/chaos/CATALOG.md"

# Functions whose first string argument names a seam.  `inject` is the
# production entry point; `_chaos` is driver.py's local guard wrapper.
INJECT_FUNC_NAMES = frozenset({"inject", "_chaos"})

_RETRY_REF = re.compile(
    r"retry_call|RetryPolicy|Backoff|RetryBudgetExceeded"
    r"|from\s+(?:nomad_tpu_torch|\.\.?)\s*(?:\.\s*)?(?:import\s+retry|retry\s+import)"
)
_DOC_PATH = re.compile(r"`([\w./]+\.py)`")
_SEAM_ROW = re.compile(r"^\|\s*`([\w.]+)`\s*\|")


def parse_doc(doc: str) -> Tuple[Dict[str, int], Dict[str, int]]:
    """Extract (seam -> doc line) from the seam catalog and
    (module path -> doc line) from the retry-surface section."""
    seams: Dict[str, int] = {}
    retry_mods: Dict[str, int] = {}
    section = None
    for i, raw in enumerate(doc.splitlines(), start=1):
        line = raw.strip()
        if line.startswith("## "):
            title = line[3:].lower()
            if title.startswith("seam catalog"):
                section = "seams"
            elif title.startswith("retry policy surface"):
                section = "retry"
            else:
                section = None
            continue
        if section == "seams":
            m = _SEAM_ROW.match(line)
            if m and m.group(1).lower() not in ("seam",):
                seams.setdefault(m.group(1), i)
        elif section == "retry":
            for m in _DOC_PATH.finditer(line):
                p = m.group(1)
                if p.endswith("retry.py"):
                    continue  # the helper itself, not a consumer
                retry_mods.setdefault(p, i)
    return seams, retry_mods


def collect_code_seams(root: str) -> Dict[str, List[Tuple[str, int]]]:
    """seam string -> [(repo-relative path, line)] for every
    inject()/_chaos() call with a literal first argument."""
    sites: Dict[str, List[Tuple[str, int]]] = {}
    pkg = os.path.join(root, PKG)
    for dirpath, dirnames, filenames in os.walk(pkg):
        dirnames[:] = [d for d in dirnames if d not in ("__pycache__", "lint")]
        for fn in sorted(filenames):
            if not fn.endswith(".py"):
                continue
            p = os.path.join(dirpath, fn)
            rel = os.path.relpath(p, root).replace(os.sep, "/")
            # injector.py defines inject(); scenarios/tests only build
            # schedules (FaultSpec strings are coverage, not seams).
            if rel.endswith("chaos/injector.py") or rel.endswith("chaos/scenarios.py"):
                continue
            with open(p) as fh:
                src = fh.read()
            for name, line in _literal_inject_calls(src):
                sites.setdefault(name, []).append((rel, line))
    return sites


def _literal_inject_calls(src: str) -> List[Tuple[str, int]]:
    out: List[Tuple[str, int]] = []
    for node in ast.walk(ast.parse(src)):
        if not isinstance(node, ast.Call) or not node.args:
            continue
        fname: Optional[str] = None
        if isinstance(node.func, ast.Name):
            fname = node.func.id
        elif isinstance(node.func, ast.Attribute):
            fname = node.func.attr
        if fname not in INJECT_FUNC_NAMES:
            continue
        first = node.args[0]
        if isinstance(first, ast.Constant) and isinstance(first.value, str):
            out.append((first.value, node.lineno))
    return out


def collect_exercised_strings(root: str) -> Set[str]:
    """Every string literal in tests/ and chaos/scenarios.py — a seam
    is 'exercised' when some schedule or assertion names it."""
    strings: Set[str] = set()
    targets: List[str] = []
    tests = os.path.join(root, "tests")
    if os.path.isdir(tests):
        for fn in sorted(os.listdir(tests)):
            if fn.endswith(".py"):
                targets.append(os.path.join(tests, fn))
    scen = os.path.join(root, PKG, "chaos", "scenarios.py")
    if os.path.exists(scen):
        targets.append(scen)
    for p in targets:
        with open(p) as fh:
            src = fh.read()
        try:
            tree = ast.parse(src)
        except SyntaxError:
            continue
        for node in ast.walk(tree):
            if isinstance(node, ast.Constant) and isinstance(node.value, str):
                strings.add(node.value)
    return strings


def analyze(
    doc: str,
    code_seams: Dict[str, List[Tuple[str, int]]],
    exercised: Set[str],
    retry_sources: Dict[str, Optional[str]],
) -> List[Finding]:
    """Pure cross-check — the test fixture API.  ``retry_sources`` maps
    each doc-named retry-surface path to its source text (None when the
    file is gone)."""
    doc_seams, retry_mods = parse_doc(doc)
    findings: List[Finding] = []

    for seam, doc_line in sorted(doc_seams.items()):
        if seam not in code_seams:
            findings.append(Finding(
                "C001", DOC_NAME, doc_line, seam,
                f"seam `{seam}` is documented in the catalog but has no "
                f"inject() call site in {PKG}/ — the row is stale or "
                f"the seam was renamed",
            ))
        elif seam not in exercised:
            findings.append(Finding(
                "C003", DOC_NAME, doc_line, seam,
                f"seam `{seam}` has a code site but never appears in "
                f"tests/ or chaos/scenarios.py — no schedule exercises it",
            ))

    for seam, sites in sorted(code_seams.items()):
        if seam not in doc_seams:
            path, line = sites[0]
            findings.append(Finding(
                "C002", path, line, seam,
                f"inject() seam `{seam}` is not documented in "
                f"{DOC_NAME}'s seam catalog",
            ))

    for mod, doc_line in sorted(retry_mods.items()):
        src = retry_sources.get(mod)
        if src is None:
            findings.append(Finding(
                "C004", DOC_NAME, doc_line, mod,
                f"retry-surface module `{mod}` named in {DOC_NAME} does "
                f"not exist",
            ))
        elif not _RETRY_REF.search(src):
            findings.append(Finding(
                "C004", DOC_NAME, doc_line, mod,
                f"retry-surface module `{mod}` no longer references the "
                f"shared retry helpers (retry_call/RetryPolicy/Backoff)",
            ))
    return findings


def run(root: str) -> List[Finding]:
    doc_path = os.path.join(root, *DOC_NAME.split("/"))
    if not os.path.exists(doc_path):
        return [Finding("C001", DOC_NAME, 1, "<doc>",
                        f"{DOC_NAME} is missing")]
    with open(doc_path) as fh:
        doc = fh.read()

    _seams, retry_mods = parse_doc(doc)
    retry_sources: Dict[str, Optional[str]] = {}
    for mod in retry_mods:
        p = os.path.join(root, PKG, mod)
        if not os.path.exists(p):
            p = os.path.join(root, mod)
        if os.path.exists(p):
            with open(p) as fh:
                retry_sources[mod] = fh.read()
        else:
            retry_sources[mod] = None

    return analyze(
        doc,
        collect_code_seams(root),
        collect_exercised_strings(root),
        retry_sources,
    )
