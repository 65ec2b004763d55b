"""The port's declared lock hierarchy — the contract the lock-discipline
pass enforces.

Locks are named canonically; :data:`ORDER` lists them outermost-first.
While holding a lock of rank *r*, only locks of rank > *r* may be
acquired.  Locks not named here are *unranked*: each is an island the
orderer cannot compare, so L001 never fires on them (L002/L003/L004
still apply).  Rank a lock by adding it to :data:`ORDER` and mapping its
attribute in :data:`ALIASES` — the analyzer picks it up with no other
change.

The port nests its locks in its own order (the reference's is
``nomad_tpu/lint/lock_order.py``):

* ``replication.stream`` — ``Replicator._stream_lock``: serializes a
  follower's application of the leader's stream; held across
  ``StateStore.apply_remote``, so it is outermost.
* ``store.write``   — ``StateStore._write_lock``: the journaled-writer
  gate; held across the replicate→apply sequence (reads proceed).
  ``StateStore.apply_remote`` takes it before ``store.state``, where the
  reference's takes ``store.state`` alone first (ROADMAP "Drops",
  ``state/store.py``).
* ``replication``   — ``Replicator._lock``: role, term and sequence
  fields; taken under the writer gate while an entry streams to peers,
  never held while a store lock is taken.
* ``store.state``   — ``StateStore._lock``/``_cond``: the read lock;
  held only for in-memory applies and snapshots.
* ``device``        — ``state.matrix.DEVICE_LOCK``: serializes the
  matrix's device copies and the solo launches.
* ``matrix.host``   — ``NodeMatrix._host_lock``: guards the host mirror
  rows + dirty sets against the sync drain.
* ``broker``        — ``EventBroker._lock``: ring buffer + subscriber
  list; publish snapshots subscribers under it, then offers outside.
* ``subscription``  — per-``Subscription`` condvar (leaf of the event
  fan-out).
* ``store.watch``   — ``StateStore._watch_cond``: the dedicated
  index-watcher leaf; ``_bump`` notifies it while holding the state
  lock, so it must stay strictly innermost of the store family.
* ``metrics`` / ``injector`` — leaf bookkeeping locks; anything may
  record a metric or consult the fault injector while holding anything.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

ORDER: Tuple[str, ...] = (
    "replication.stream",
    "store.write",
    "replication",
    "store.state",
    "device",
    "matrix.host",
    "broker",
    "subscription",
    "store.watch",
    "metrics",
    "injector",
)

RANK: Dict[str, int] = {name: i for i, name in enumerate(ORDER)}

# (module-path suffix, class name or "*", attribute) -> canonical name.
# A condition variable built on a lock maps to the SAME canonical name as
# the lock (waiting on it releases that lock, not a new one).
ALIASES: Dict[Tuple[str, str, str], str] = {
    ("state/store.py", "StateStore", "_write_lock"): "store.write",
    ("state/store.py", "StateStore", "_lock"): "store.state",
    ("state/store.py", "StateStore", "_cond"): "store.state",
    ("state/store.py", "StateStore", "_watch_cond"): "store.watch",
    ("server/replication.py", "*", "_stream_lock"): "replication.stream",
    ("server/replication.py", "*", "_lock"): "replication",
    ("state/matrix.py", "*", "DEVICE_LOCK"): "device",
    ("state/matrix.py", "NodeMatrix", "_host_lock"): "matrix.host",
    ("stream/broker.py", "EventBroker", "_lock"): "broker",
    ("stream/broker.py", "Subscription", "_cond"): "subscription",
    ("metrics.py", "*", "_lock"): "metrics",
    ("chaos/injector.py", "*", "_lock"): "injector",
}

# Canonical names that are condition variables (their .wait releases the
# underlying lock — waiting on one while holding a DIFFERENT ranked lock
# is the L002 deadlock shape).
CONDVARS = frozenset({"store.state", "store.watch", "subscription"})

# Bare names that always mean the device lock, wherever imported.
GLOBAL_NAME_ALIASES: Dict[str, str] = {"DEVICE_LOCK": "device"}

# `self.<attr>` -> the (module suffix, class) its methods resolve against,
# for the one-level interprocedural walk (self.matrix.upsert_node ->
# NodeMatrix.upsert_node's lock summary).
ATTR_TYPES: Dict[str, Tuple[str, str]] = {
    "store": ("state/store.py", "StateStore"),
    "matrix": ("state/matrix.py", "NodeMatrix"),
    "events": ("stream/broker.py", "EventBroker"),
    "broker": ("stream/broker.py", "EventBroker"),
    "replicator": ("server/replication.py", "Replicator"),
    "metrics": ("metrics.py", "MetricsRegistry"),
}

# Dotted-call names that block (L003) when made inside a critical section.
BLOCKING_DOTTED = frozenset({
    "time.sleep",
    "subprocess.run",
    "subprocess.Popen",
    "subprocess.call",
    "subprocess.check_call",
    "subprocess.check_output",
    "urllib.request.urlopen",
    "socket.create_connection",
})

# Method names that block regardless of receiver: RPC sends and the
# replication fan-out ( `_post`/`_call`/`replicate` are this codebase's
# network verbs).
BLOCKING_ATTR_NAMES = frozenset({"_post", "_call", "replicate", "urlopen"})

# `self.<attr>.<anything>()` receivers that mean file I/O.
BLOCKING_RECEIVER_ATTRS = frozenset({"wal"})

# Device→host waits: a copy to the host or a synchronize waits for every
# launch queued before it on the stream.
DEVICE_FETCH_DOTTED = frozenset({"torch.cuda.synchronize"})
DEVICE_FETCH_ATTR_NAMES = frozenset({"synchronize", "cpu", "item", "tolist"})

# Calls that are DEVICE_LOCK's purpose — copying the matrix to the device
# under the device lock is why it exists, so these are exempt from L003
# while it (alone among ranked locks) is held.
DEVICE_OP_ATTR_NAMES = frozenset({"sync", "sync_sharded"})


def resolve(modpath: str, cls: Optional[str], attr: str) -> Optional[str]:
    """Canonical lock name for attribute ``attr`` of class ``cls`` in
    ``modpath`` (repo-relative, forward slashes); None if unranked.

    Falls back to a module+attr match when the class doesn't line up —
    decorator-produced wrappers (``@journaled``'s ``wrapper``) live at
    module scope but close over the same ``self``."""
    fallback: Optional[str] = None
    for (suffix, alias_cls, alias_attr), name in ALIASES.items():
        if attr != alias_attr:
            continue
        if not modpath.endswith(suffix):
            continue
        if alias_cls == "*" or cls == alias_cls:
            return name
        if fallback is None:
            fallback = name
    return fallback


def rank(name: str) -> Optional[int]:
    return RANK.get(name)
