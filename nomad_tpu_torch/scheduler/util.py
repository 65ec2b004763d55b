"""Scheduler utilities (reference: scheduler/util.go).

``tainted_nodes`` mirrors util.go taintedNodes: the set of nodes whose allocs
must migrate (drain) or are lost (down/gone).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional

from ..structs.types import Allocation, Node, NodeStatus


def tainted_nodes(snapshot, allocs: Iterable[Allocation]) -> Dict[str, Optional[Node]]:
    """node_id -> Node (or None if the node no longer exists) for every node
    that is down, draining, or ineligible-due-to-drain, referenced by allocs."""
    out: Dict[str, Optional[Node]] = {}
    for alloc in allocs:
        if alloc.node_id in out:
            continue
        node = snapshot.node_by_id(alloc.node_id)
        if node is None:
            out[alloc.node_id] = None
            continue
        if node.status == NodeStatus.DOWN.value or node.drain:
            out[alloc.node_id] = node
    return out
