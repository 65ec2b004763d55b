"""``nomad lint`` — static analysis for the concurrency and dispatch hot
paths of ``nomad_tpu_torch/``.

Four AST passes over the port's tree, one runtime sanitizer and one
runtime contract check on the CPU:

* **lock discipline** (:mod:`.lockpass`, rules ``L001``–``L004``) —
  per-function lock-acquisition graphs across ``server/``,
  ``scheduler/``, ``state/``, ``client/``, ``stream/``, checked against
  the port's declared hierarchy in :mod:`.lock_order`.
* **dispatch hot path** (:mod:`.hotpass`, rules ``H001``–``H003``) —
  host syncs outside the ticket's one result copy, node-axis-shaped
  tensors fetched to the host on a fused or sharded dispatch, and
  module-level mutable tensors captured by a launch, in ``ops/``,
  ``parallel/``, ``scheduler/coalescer.py`` and ``state/matrix.py``.
* **chaos seams** (:mod:`.chaospass`, rules ``C001``–``C004``) — the
  port's seam catalog (``nomad_tpu_torch/chaos/CATALOG.md``) and retry
  surface cross-checked against the injector call sites and the tests
  that exercise them.
* **observability** (:mod:`.obspass`, rules ``O001``–``O004``) — every
  injector call site emits a trace event on the same path; every
  ``SLOSpec``'s literal objective resolves to a metric the code
  registers; every overload-actuator decision site and every
  device-breaker transition site emits a trace event AND increments a
  ``nomad.*`` counter.
* **TSan-lite** (:mod:`.tsan`) — the runtime half: lockset-checked
  shared-state wrappers enabled under the seeded chaos scenarios.
* **dispatch contracts** (:mod:`.contracts`, rules ``D001``–``D002``) —
  each listed dispatch entry point run on CPU tensors at two node
  counts: its result's shape and host bytes must not depend on N and
  must stay within the row's budget.  The reference's traced-program
  checks (``jaxprpass.py``) have no counterpart; :mod:`.contracts` says
  why.

Findings carry ``rule``, ``path:line`` and the enclosing ``symbol``;
``baseline.json`` allowlists deliberate exemptions by
``(rule, path, symbol)`` so the gate starts green and ratchets.  The
loader enforces baseline hygiene: duplicate keys and unsorted entries
are load errors, so the committed file stays canonical and ``git diff``
stays reviewable.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = [
    "PKG",
    "Finding",
    "repo_root",
    "run_all",
    "load_baseline",
    "split_baselined",
]


# The package the passes analyze, under the repository root.
PKG = "nomad_tpu_torch"


@dataclass(frozen=True)
class Finding:
    """One analyzer hit.  ``symbol`` is the enclosing function/method
    qualname (``Class.method`` or ``<module>``) — baseline matching keys
    on it instead of the line number so ordinary edits don't churn the
    allowlist."""

    rule: str
    path: str  # repo-relative, forward slashes
    line: int
    symbol: str
    message: str

    def key(self) -> Tuple[str, str, str]:
        return (self.rule, self.path, self.symbol)

    def render(self) -> str:
        return f"{self.path}:{self.line}: {self.rule} [{self.symbol}] {self.message}"


def repo_root(start: Optional[str] = None) -> str:
    """The repository root: the nearest ancestor of this package that
    contains the ``nomad_tpu_torch`` directory itself."""
    here = start or os.path.dirname(os.path.abspath(__file__))
    d = here
    while True:
        if os.path.isdir(os.path.join(d, PKG)):
            return d
        parent = os.path.dirname(d)
        if parent == d:  # filesystem root — fall back to cwd
            return os.getcwd()
        d = parent


def run_all(root: Optional[str] = None) -> List[Finding]:
    """Run every pass over the port's tree (the dispatch contracts on the
    CPU); returns findings sorted by path/line."""
    from . import chaospass, contracts, hotpass, lockpass, obspass

    root = root or repo_root()
    findings: List[Finding] = []
    findings += lockpass.run(root)
    findings += hotpass.run(root)
    findings += chaospass.run(root)
    findings += obspass.run(root)
    findings += contracts.run(root)
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings


# ----------------------------------------------------------------------
# Baseline (the ratchet)
# ----------------------------------------------------------------------

BASELINE_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "baseline.json")


@dataclass
class Baseline:
    """The committed allowlist: entries are ``{rule, path, symbol, why}``.
    ``used`` tracks which entries matched this run so ``--prune`` can
    report stale ones."""

    entries: List[Dict[str, str]] = field(default_factory=list)

    def match(self, f: Finding) -> Optional[Dict[str, str]]:
        for e in self.entries:
            if (
                e.get("rule") == f.rule
                and e.get("path") == f.path
                and e.get("symbol") == f.symbol
            ):
                return e
        return None


def load_baseline(path: Optional[str] = None) -> Baseline:
    """Load and validate the allowlist.

    Two hygiene invariants are enforced at load time (both are
    :class:`ValueError`):

    * no duplicate ``(rule, path, symbol)`` keys — ``match()`` returns
      the first hit, so a duplicate silently decides which ``why``
      applies;
    * entries sorted by ``(rule, path, symbol)`` — the committed file
      has exactly one canonical form, so baseline diffs are
      append/delete only.
    """
    p = path or BASELINE_PATH
    if not os.path.exists(p):
        return Baseline()
    with open(p) as fh:
        data = json.load(fh)
    entries = list(data.get("exemptions", []))
    keys = [
        (e.get("rule", ""), e.get("path", ""), e.get("symbol", ""))
        for e in entries
    ]
    dups = sorted({k for k in keys if keys.count(k) > 1})
    if dups:
        raise ValueError(
            f"baseline {p}: duplicate (rule, path, symbol) entries {dups} — "
            "the first match wins silently, so one 'why' is dead text; "
            "delete the duplicates"
        )
    if keys != sorted(keys):
        raise ValueError(
            f"baseline {p}: entries must be sorted by (rule, path, symbol) "
            "so the committed file has one canonical form; re-sort it"
        )
    return Baseline(entries=entries)


def split_baselined(
    findings: Sequence[Finding], baseline: Baseline
) -> Tuple[List[Finding], List[Finding], List[Dict[str, str]]]:
    """Partition findings into (new, suppressed) and report baseline
    entries that matched nothing (stale — candidates for deletion)."""
    new: List[Finding] = []
    suppressed: List[Finding] = []
    matched: List[Dict[str, str]] = []
    for f in findings:
        e = baseline.match(f)
        if e is None:
            new.append(f)
        else:
            suppressed.append(f)
            if e not in matched:
                matched.append(e)
    stale = [e for e in baseline.entries if e not in matched]
    return new, suppressed, stale
