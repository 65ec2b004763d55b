"""ACL policy engine — policy documents → capability checks.

Reference: ``acl/policy.go`` (HCL policy grammar: namespace rules with
``policy`` shorthands or explicit ``capabilities``, plus node/agent/
operator blocks) and ``acl/acl.go`` (the compiled ACL object answering
capability checks); token → ACL resolution lives in ``nomad/acl.go`` and
here in ``server.resolve_token``.

Policy documents reuse the jobspec HCL dialect:

    namespace "default" {
      policy = "write"
    }
    namespace "ops-*" {
      capabilities = ["read-job", "list-jobs"]
    }
    node    { policy = "read" }
    agent   { policy = "read" }
    operator { policy = "write" }
"""

from __future__ import annotations

import fnmatch
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set

from ..jobspec.hcl import parse_hcl

# Namespace capabilities (acl/policy.go:17-48).
CAP_DENY = "deny"
CAP_LIST_JOBS = "list-jobs"
CAP_READ_JOB = "read-job"
CAP_SUBMIT_JOB = "submit-job"
CAP_DISPATCH_JOB = "dispatch-job"
CAP_READ_LOGS = "read-logs"
CAP_READ_FS = "read-fs"
CAP_ALLOC_EXEC = "alloc-exec"
CAP_ALLOC_LIFECYCLE = "alloc-lifecycle"
CAP_SCALE_JOB = "scale-job"

# Policy shorthand expansion (acl/policy.go expandNamespacePolicy).
_NS_READ = [CAP_LIST_JOBS, CAP_READ_JOB]
_NS_WRITE = _NS_READ + [
    CAP_SUBMIT_JOB, CAP_DISPATCH_JOB, CAP_READ_LOGS, CAP_READ_FS,
    CAP_ALLOC_EXEC, CAP_ALLOC_LIFECYCLE, CAP_SCALE_JOB,
]

_COARSE = ("deny", "read", "write")


class ACLParseError(Exception):
    pass


@dataclass
class Policy:
    """One parsed policy document."""

    namespaces: Dict[str, Set[str]] = field(default_factory=dict)
    node: str = ""  # "", "deny", "read", "write"
    agent: str = ""
    operator: str = ""


def parse_policy(rules: str) -> Policy:
    """Parse a policy document (acl/policy.go Parse)."""
    try:
        doc = parse_hcl(rules) if rules.strip() else {}
    except Exception as exc:  # noqa: BLE001
        raise ACLParseError(f"invalid policy document: {exc}") from exc
    pol = Policy()
    for block in _blocks(doc, "namespace"):
        name, body = block
        caps: Set[str] = set()
        shorthand = body.get("policy")
        if shorthand is not None:
            if shorthand not in _COARSE:
                raise ACLParseError(f"bad namespace policy {shorthand!r}")
            if shorthand == "read":
                caps.update(_NS_READ)
            elif shorthand == "write":
                caps.update(_NS_WRITE)
            else:
                caps.add(CAP_DENY)
        for cap in body.get("capabilities", []) or []:
            caps.add(cap)
        pol.namespaces[name] = caps
    for kind in ("node", "agent", "operator"):
        for name, body in _blocks(doc, kind):
            shorthand = body.get("policy", "")
            if shorthand and shorthand not in _COARSE:
                raise ACLParseError(f"bad {kind} policy {shorthand!r}")
            setattr(pol, kind, shorthand)
    return pol


def _blocks(doc: dict, kind: str):
    """Yield (label, body) for each block of ``kind`` in the parsed HCL.
    Unlabeled blocks get label ''."""
    v = doc.get(kind)
    if v is None:
        return []
    out = []
    if isinstance(v, dict):
        # Either {label: body} or a direct body for unlabeled blocks.
        if v and all(isinstance(x, dict) for x in v.values()):
            out.extend(v.items())
        else:
            out.append(("", v))
    elif isinstance(v, list):
        for item in v:
            out.append(("", item))
    return out


class ACL:
    """Compiled capability checker over a set of policies (acl/acl.go)."""

    def __init__(self, policies: List[Policy], management: bool = False):
        self.management = management
        self._namespaces: Dict[str, Set[str]] = {}
        self._node = ""
        self._agent = ""
        self._operator = ""
        order = {"": 0, "deny": 3, "read": 1, "write": 2}
        for pol in policies:
            for ns, caps in pol.namespaces.items():
                self._namespaces.setdefault(ns, set()).update(caps)
            # deny dominates; otherwise the widest grant wins.
            for kind in ("node", "agent", "operator"):
                cur = getattr(self, f"_{kind}")
                new = getattr(pol, kind)
                if order.get(new, 0) > order.get(cur, 0) or new == "deny":
                    setattr(self, f"_{kind}", new)

    # -- namespace ------------------------------------------------------

    def _ns_caps(self, namespace: str) -> Set[str]:
        exact = self._namespaces.get(namespace)
        if exact is not None:
            return exact
        # Longest-glob match (acl.go findClosestMatchingGlob).
        best: Optional[Set[str]] = None
        best_len = -1
        for pattern, caps in self._namespaces.items():
            if "*" in pattern and fnmatch.fnmatchcase(namespace, pattern):
                if len(pattern) > best_len:
                    best, best_len = caps, len(pattern)
        return best or set()

    def allow_namespace(self, namespace: str, capability: str) -> bool:
        if self.management:
            return True
        caps = self._ns_caps(namespace)
        if CAP_DENY in caps:
            return False
        return capability in caps

    # -- coarse domains -------------------------------------------------

    def _allow(self, granted: str, want: str) -> bool:
        if self.management:
            return True
        if granted == "deny":
            return False
        if want == "read":
            return granted in ("read", "write")
        return granted == "write"

    def allow_node(self, want: str) -> bool:
        return self._allow(self._node, want)

    def allow_agent(self, want: str) -> bool:
        return self._allow(self._agent, want)

    def allow_operator(self, want: str) -> bool:
        return self._allow(self._operator, want)


MANAGEMENT_ACL = ACL([], management=True)
DENY_ALL_ACL = ACL([])
