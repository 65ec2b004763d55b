"""TSan-lite: a lockset-based runtime race sanitizer for the declared
shared state (the dynamic half of ``nomad lint``).

The static passes prove the *lexical* discipline; this module checks the
*runtime* one: every access to a declared shared object must happen with
that object's guard lock in the accessing thread's lockset.  It is the
eraser-style lockset algorithm stripped to what this codebase needs:

* ``TrackedLock`` wraps a real ``Lock``/``RLock`` and maintains a
  thread-local multiset of held guards.  It implements the full
  ``Condition`` protocol (``_release_save``/``_acquire_restore``/
  ``_is_owned``) so wrapped condvars keep working —
  ``threading.Condition`` binds those *at construction*, so
  :func:`wrap_condition` rebinds them on the instance.
* Monitored containers (dict/list/set/deque and an ``ndarray`` view
  subclass) call :meth:`_ObjInfo.check` on every mutation (and read,
  unless the object is registered ``writes_only``).
* Per-object EXCLUSIVE→SHARED state machine: an object owned by the
  thread that has touched it so far is never checked (single-threaded
  setup is free); the moment a second thread touches it, every further
  unguarded access reports.
* Reports carry (label, op, thread, held locksets, stack).  Stacks are
  captured only when a violation fires — the hot path is a set lookup.

Zero overhead when disabled: the product constructors (the port's
``StateStore``, ``NodeMatrix``, ``DeviceCoalescer``, ``EventBroker`` and
``Subscription``) test :func:`enabled` once and call :func:`instrument`
only when a test called :func:`enable` first.  Enable BEFORE
constructing the objects under test::

    from nomad_tpu_torch.lint import tsan
    tsan.enable()
    try:
        ... run the chaos scenario ...
        assert tsan.reports() == []
    finally:
        tsan.disable()

Caveats (the reference's, ``STATIC_ANALYSIS.md``): rebinding a monitored
attribute (e.g. matrix capacity growth swaps ``_alloc``) sheds the
monitor for the new object — the seeded scenarios don't grow capacity;
reads of ``writes_only`` tables are deliberately unchecked because the
store's read contract is immutable-replace under the GIL.
"""

from __future__ import annotations

import threading
import traceback
from collections import deque
from contextlib import contextmanager
from typing import Any, Dict, FrozenSet, List, Optional, Tuple

import numpy as np

_enabled = False
_report_lock = threading.Lock()
_reports: List[Dict[str, Any]] = []
_MAX_REPORTS = 100
_tls = threading.local()


def enabled() -> bool:
    return _enabled


def enable() -> None:
    global _enabled
    with _report_lock:
        _reports.clear()
    _enabled = True


def disable() -> None:
    """Stop checking and drop accumulated reports — read
    :func:`reports` BEFORE disabling."""
    global _enabled
    _enabled = False
    with _report_lock:
        _reports.clear()


def reports() -> List[Dict[str, Any]]:
    with _report_lock:
        return list(_reports)


@contextmanager
def sanitized():
    """Enable for the block, disable on exit.  Construct the objects
    under test INSIDE the block — instrumentation happens at their
    constructors."""
    enable()
    try:
        yield
    finally:
        disable()


def _held() -> Dict[int, List]:
    h = getattr(_tls, "held", None)
    if h is None:
        h = _tls.held = {}
    return h


def held_names() -> FrozenSet[str]:
    """The calling thread's current lockset (canonical guard names)."""
    return frozenset(name for name, c in _held().values() if c > 0)


# ----------------------------------------------------------------------
# TrackedLock
# ----------------------------------------------------------------------


class TrackedLock:
    """Wraps a ``Lock``/``RLock``; each acquire/release updates the
    calling thread's lockset.  Identity (``id(self)``) is the guard key,
    the ``name`` only labels reports."""

    def __init__(self, inner, name: str):
        self._inner = inner
        self._name = name

    # -- lockset bookkeeping ------------------------------------------

    def _count(self) -> int:
        e = _held().get(id(self))
        return e[1] if e is not None else 0

    def _add(self, n: int) -> None:
        h = _held()
        e = h.get(id(self))
        if e is None:
            h[id(self)] = [self._name, n]
        else:
            e[1] += n
            if e[1] <= 0:
                del h[id(self)]

    # -- Lock protocol -------------------------------------------------

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._inner.acquire(blocking, timeout)
        if got:
            self._add(1)
        return got

    def release(self) -> None:
        self._inner.release()
        self._add(-1)

    def __enter__(self) -> "TrackedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        return self._inner.locked() if hasattr(self._inner, "locked") else False

    # -- Condition protocol (bound onto wrapped Condition instances) ---

    def _is_owned(self) -> bool:
        return self._count() > 0

    def _release_save(self):
        count = self._count()
        if hasattr(self._inner, "_release_save"):
            state = self._inner._release_save()
        else:
            self._inner.release()
            state = None
        self._add(-count)
        return (state, count)

    def _acquire_restore(self, saved) -> None:
        state, count = saved
        if state is not None and hasattr(self._inner, "_acquire_restore"):
            self._inner._acquire_restore(state)
        else:
            self._inner.acquire()
        self._add(count)

    def __repr__(self) -> str:
        return f"<TrackedLock {self._name}>"


def wrap_condition(cond: threading.Condition, name: str) -> TrackedLock:
    """Route an existing ``Condition`` through a ``TrackedLock``.

    ``Condition.__init__`` snapshots ``acquire``/``release`` and (for
    RLocks) ``_release_save``/``_acquire_restore``/``_is_owned`` from the
    lock it was built on, so swapping ``_lock`` alone is not enough —
    every snapshotted method must be rebound on the instance."""
    tl = TrackedLock(cond._lock, name)
    _rebind_condition(cond, tl)
    return tl


def _rebind_condition(cond: threading.Condition, tl: TrackedLock) -> None:
    cond._lock = tl
    cond.acquire = tl.acquire
    cond.release = tl.release
    cond._is_owned = tl._is_owned
    cond._release_save = tl._release_save
    cond._acquire_restore = tl._acquire_restore


# ----------------------------------------------------------------------
# Object state + monitored containers
# ----------------------------------------------------------------------


class _ObjInfo:
    """Lockset state for one monitored object."""

    __slots__ = ("label", "guards", "writes_only", "owner", "shared")

    def __init__(self, label: str, guards: Tuple[TrackedLock, ...],
                 writes_only: bool = False):
        self.label = label
        self.guards = guards
        self.writes_only = writes_only
        self.owner: Optional[int] = None  # exclusive-owner thread id
        self.shared = False

    def check(self, op: str) -> None:
        if not _enabled:
            return
        tid = threading.get_ident()
        if not self.shared:
            if self.owner is None:
                self.owner = tid
                return
            if self.owner == tid:
                return
            self.shared = True  # second thread arrived — checks begin
        if self.writes_only and op == "read":
            return
        h = _held()
        for g in self.guards:
            e = h.get(id(g))
            if e is not None and e[1] > 0:
                return
        self._report(op)

    def _report(self, op: str) -> None:
        rec = {
            "label": self.label,
            "op": op,
            "thread": threading.current_thread().name,
            "held": sorted(held_names()),
            "required": sorted(g._name for g in self.guards),
            "stack": "".join(traceback.format_stack(limit=12)),
        }
        with _report_lock:
            if len(_reports) < _MAX_REPORTS:
                _reports.append(rec)


class MonitoredDict(dict):
    _tsan_info: _ObjInfo

    def __setitem__(self, k, v):
        self._tsan_info.check("write")
        super().__setitem__(k, v)

    def __delitem__(self, k):
        self._tsan_info.check("write")
        super().__delitem__(k)

    def pop(self, *a):
        self._tsan_info.check("write")
        return super().pop(*a)

    def popitem(self):
        self._tsan_info.check("write")
        return super().popitem()

    def clear(self):
        self._tsan_info.check("write")
        super().clear()

    def update(self, *a, **k):
        self._tsan_info.check("write")
        super().update(*a, **k)

    def setdefault(self, *a):
        self._tsan_info.check("write")
        return super().setdefault(*a)

    def __getitem__(self, k):
        self._tsan_info.check("read")
        return super().__getitem__(k)

    def get(self, *a):
        self._tsan_info.check("read")
        return super().get(*a)


class MonitoredList(list):
    _tsan_info: _ObjInfo

    def append(self, x):
        self._tsan_info.check("write")
        super().append(x)

    def extend(self, it):
        self._tsan_info.check("write")
        super().extend(it)

    def insert(self, i, x):
        self._tsan_info.check("write")
        super().insert(i, x)

    def pop(self, *a):
        self._tsan_info.check("write")
        return super().pop(*a)

    def remove(self, x):
        self._tsan_info.check("write")
        super().remove(x)

    def clear(self):
        self._tsan_info.check("write")
        super().clear()

    def __setitem__(self, i, v):
        self._tsan_info.check("write")
        super().__setitem__(i, v)

    def __delitem__(self, i):
        self._tsan_info.check("write")
        super().__delitem__(i)

    def __iadd__(self, other):
        self._tsan_info.check("write")
        return super().__iadd__(other)

    def __getitem__(self, i):
        self._tsan_info.check("read")
        return super().__getitem__(i)


class MonitoredSet(set):
    _tsan_info: _ObjInfo

    def add(self, x):
        self._tsan_info.check("write")
        super().add(x)

    def discard(self, x):
        self._tsan_info.check("write")
        super().discard(x)

    def remove(self, x):
        self._tsan_info.check("write")
        super().remove(x)

    def pop(self):
        self._tsan_info.check("write")
        return super().pop()

    def clear(self):
        self._tsan_info.check("write")
        super().clear()

    def update(self, *a):
        self._tsan_info.check("write")
        super().update(*a)

    def difference_update(self, *a):
        self._tsan_info.check("write")
        super().difference_update(*a)

    def __contains__(self, x):
        self._tsan_info.check("read")
        return super().__contains__(x)


class MonitoredDeque(deque):
    _tsan_info: _ObjInfo

    def append(self, x):
        self._tsan_info.check("write")
        super().append(x)

    def appendleft(self, x):
        self._tsan_info.check("write")
        super().appendleft(x)

    def extend(self, it):
        self._tsan_info.check("write")
        super().extend(it)

    def pop(self):
        self._tsan_info.check("write")
        return super().pop()

    def popleft(self):
        self._tsan_info.check("write")
        return super().popleft()

    def clear(self):
        self._tsan_info.check("write")
        super().clear()

    def __getitem__(self, i):
        self._tsan_info.check("read")
        return super().__getitem__(i)


class MonitoredArray(np.ndarray):
    """ndarray view that checks writes.  ``__array_finalize__`` carries
    the info onto every derived view, so ``alloc["used"][row] = x`` —
    which desugars through a view's ``__setitem__`` — is caught."""

    def __array_finalize__(self, obj):
        if obj is None:
            return
        info = getattr(obj, "_tsan_info", None)
        # Follow VIEWS only (slices, reshapes): ufunc results and copies
        # computed FROM the shared array are fresh private buffers, not
        # shared state — carrying the info onto them flags every scratch
        # write as a race.  may_share_memory is the cheap bounds check.
        if info is not None and np.may_share_memory(self, obj):
            self._tsan_info = info
        else:
            self._tsan_info = None

    def __setitem__(self, k, v):
        info = getattr(self, "_tsan_info", None)
        if info is not None:
            info.check("write")
        super().__setitem__(k, v)


_CONTAINER_TYPES = {
    dict: MonitoredDict,
    list: MonitoredList,
    set: MonitoredSet,
    deque: MonitoredDeque,
}


def _wrap_container(value, info: _ObjInfo):
    if isinstance(value, np.ndarray):
        view = value.view(MonitoredArray)
        view._tsan_info = info
        return view
    for base, mon in _CONTAINER_TYPES.items():
        if type(value) is base:
            if base is deque:
                out = mon(value, value.maxlen)
            else:
                out = mon(value)
            out._tsan_info = info
            return out
    raise TypeError(f"cannot monitor {type(value).__name__}")


def _monitor_attr(obj, attr: str, label: str,
                  guards: Tuple[TrackedLock, ...],
                  writes_only: bool = False) -> None:
    info = _ObjInfo(label, guards, writes_only)
    setattr(obj, attr, _wrap_container(getattr(obj, attr), info))


# ----------------------------------------------------------------------
# Registration (called from product constructors; no-ops when disabled)
# ----------------------------------------------------------------------

STORE_TABLES = ("nodes", "jobs", "evals", "allocs", "deployments")


def _register_store(store) -> None:
    # _lock and _cond share one underlying RLock — one TrackedLock for
    # both keeps the guard identity consistent.
    state_tl = TrackedLock(store._lock, "store.state")
    store._lock = state_tl
    _rebind_condition(store._cond, state_tl)
    store._write_lock = TrackedLock(store._write_lock, "store.write")
    wrap_condition(store._watch_cond, "store.watch")
    for t in STORE_TABLES:
        # writes_only: the read contract is immutable-replace under the
        # GIL (readers see either the old or the new object, never a
        # torn one) — only unlocked *writes* are races.
        _monitor_attr(store, t, f"store.{t}", (state_tl,), writes_only=True)


def _register_matrix(matrix) -> None:
    host_tl = TrackedLock(matrix._host_lock, "matrix.host")
    matrix._host_lock = host_tl
    _monitor_attr(matrix, "_dirty", "matrix._dirty", (host_tl,))
    _monitor_attr(matrix, "_sharded_dirty", "matrix._sharded_dirty", (host_tl,))
    # _alloc is a dict of named row arrays; writes land on the arrays
    # (alloc["used"][row] = x), so each value gets a monitored view.
    # The dict itself is never mutated in place (growth rebinds it).
    info = _ObjInfo("matrix._alloc", (host_tl,), writes_only=True)
    matrix._alloc = {
        k: _wrap_container(v, info) for k, v in matrix._alloc.items()
    }


def _register_broker(broker) -> None:
    tl = TrackedLock(broker._lock, "broker")
    broker._lock = tl
    _monitor_attr(broker, "_buffer", "broker._buffer", (tl,))
    _monitor_attr(broker, "_subs", "broker._subs", (tl,))


def _register_subscription(sub) -> None:
    tl = wrap_condition(sub._cond, "subscription")
    _monitor_attr(sub, "_queue", "subscription._queue", (tl,))


def _register_coalescer(co) -> None:
    tl = wrap_condition(co._cond, "coalescer")
    _monitor_attr(co, "_queue", "coalescer._queue", (tl,))
    _monitor_attr(co, "_ops", "coalescer._ops", (tl,))


_REGISTRARS = {
    "store": _register_store,
    "matrix": _register_matrix,
    "broker": _register_broker,
    "subscription": _register_subscription,
    "coalescer": _register_coalescer,
}


def instrument(kind: str, obj) -> None:
    """Product-side hook: wraps ``obj``'s declared shared state.  The
    constructors call it only while :func:`enabled` is true."""
    _REGISTRARS[kind](obj)
