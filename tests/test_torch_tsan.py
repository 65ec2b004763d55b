"""TSan-lite in the port (``nomad_tpu_torch/lint/tsan.py``) and its hooks.

The sanitizer is the reference's (``tests/test_lint.py``'s ``TestTsan``
cases hold here too). Its hooks sit in the port's ``StateStore``,
``NodeMatrix``, ``DeviceCoalescer``, ``EventBroker`` and
``Subscription`` constructors, where the reference has them: with the
sanitizer off each is one ``enabled()`` check and every lock stays a
plain ``threading`` primitive; on, the declared shared state is
lockset-checked. A CPU server under the sanitizer places a burst with no
report and shuts down in time (the coalescer's wrapped condition gives
way to ``stop()``), and an unguarded write from a second thread reports
with both locksets.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest
import torch

from nomad_tpu_torch.lint import tsan

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _sanitizer_off():
    yield
    tsan.disable()


def _locked_pair():
    tl = tsan.TrackedLock(threading.Lock(), "g")
    return tl, tsan._ObjInfo("obj", (tl,))


def test_unguarded_second_thread_reports():
    _tl, info = _locked_pair()
    d = tsan._wrap_container({}, info)
    tsan.enable()
    d["a"] = 1  # exclusive owner
    t = threading.Thread(target=lambda: d.update(b=2), name="rogue")
    t.start()
    t.join()
    reports = tsan.reports()
    assert len(reports) == 1
    assert reports[0]["label"] == "obj" and reports[0]["thread"] == "rogue"


def test_guarded_access_is_clean():
    tl, info = _locked_pair()
    d = tsan._wrap_container({}, info)
    tsan.enable()
    d["a"] = 1

    def guarded():
        with tl:
            d["b"] = 2

    t = threading.Thread(target=guarded)
    t.start()
    t.join()
    with tl:
        d["c"] = 3
    assert tsan.reports() == []


def test_single_thread_never_checked():
    _tl, info = _locked_pair()
    d = tsan._wrap_container({}, info)
    tsan.enable()
    for i in range(10):
        d[i] = i
    assert tsan.reports() == []


def test_wrapped_condition_round_trips():
    lock = threading.RLock()
    cond = threading.Condition(lock)
    tl = tsan.TrackedLock(lock, "c")
    tsan._rebind_condition(cond, tl)
    box = []

    def waiter():
        with cond:
            cond.wait_for(lambda: box, timeout=2)
            box.append("woke")

    t = threading.Thread(target=waiter)
    t.start()
    time.sleep(0.05)
    with cond:
        box.append(1)
        cond.notify_all()
    t.join()
    assert box == [1, "woke"]
    assert tsan.held_names() == frozenset()


def test_array_view_writes_checked_but_derived_copies_free():
    tl = tsan.TrackedLock(threading.Lock(), "g")
    info = tsan._ObjInfo("arr", (tl,), writes_only=True)
    a = tsan._wrap_container(np.zeros((4, 3)), info)
    tsan.enable()
    a[0] = 1.0
    view = a[1:]
    derived = a * 2

    def rogue():
        view[0] = 2.0
        derived[0] = 9.0

    t = threading.Thread(target=rogue)
    t.start()
    t.join()
    reports = tsan.reports()
    assert len(reports) == 1 and reports[0]["label"] == "arr", reports


def test_disabled_is_noop():
    assert not tsan.enabled()
    _tl, info = _locked_pair()
    d = tsan._wrap_container({}, info)
    d["a"] = 1
    t = threading.Thread(target=lambda: d.update(b=2))
    t.start()
    t.join()
    assert tsan.reports() == []


# ----------------------------------------------------------------------
# The hooks
# ----------------------------------------------------------------------

def _objects():
    from nomad_tpu_torch.scheduler.coalescer import DeviceCoalescer
    from nomad_tpu_torch.state.matrix import NodeMatrix
    from nomad_tpu_torch.state.store import StateStore
    from nomad_tpu_torch.stream.broker import EventBroker, Subscription

    m = NodeMatrix(capacity=16, device="cpu")
    store = StateStore(matrix=m)
    coal = DeviceCoalescer(m, max_lanes=2, device="cpu")
    broker = EventBroker()
    sub = Subscription(broker, {"*": ["*"]})
    return store, m, coal, broker, sub


def _guards(objs):
    store, m, coal, broker, sub = objs
    return [store._lock, store._write_lock, store._watch_cond._lock,
            m._host_lock, coal._cond._lock, broker._lock, sub._cond._lock]


def test_hooks_off_leave_plain_locks():
    objs = _objects()
    assert not any(isinstance(g, tsan.TrackedLock) for g in _guards(objs))
    store, m, coal, broker, sub = objs
    assert type(store.nodes) is dict and type(m._dirty) is set
    assert type(coal._queue) is list and type(sub._queue).__name__ == "deque"


def test_hooks_on_wrap_the_declared_state():
    with tsan.sanitized():
        objs = _objects()
        assert all(isinstance(g, tsan.TrackedLock) for g in _guards(objs))
        store, m, coal, broker, sub = objs
        assert isinstance(store.nodes, tsan.MonitoredDict)
        assert isinstance(m._dirty, tsan.MonitoredSet)
        assert isinstance(m._alloc["used"], tsan.MonitoredArray)
        assert isinstance(coal._queue, tsan.MonitoredList)
        assert isinstance(broker._buffer, tsan.MonitoredDeque)
        assert isinstance(sub._queue, tsan.MonitoredDeque)


def test_unlocked_store_write_from_a_second_thread_reports():
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.state.matrix import NodeMatrix
    from nomad_tpu_torch.state.store import StateStore

    with tsan.sanitized():
        store = StateStore(matrix=NodeMatrix(capacity=16, device="cpu"))
        store.upsert_node(1, mock.node())

        def rogue():
            n = mock.node()
            store.nodes[n.id] = n  # no store._lock

        t = threading.Thread(target=rogue, name="rogue")
        t.start()
        t.join()
        reports = tsan.reports()
    assert reports, "an unguarded write went unseen"
    r = reports[0]
    assert r["label"] == "store.nodes" and r["op"] == "write"
    assert r["required"] == ["store.state"] and r["thread"] == "rogue"
    assert r["stack"]


def test_server_burst_under_the_sanitizer_is_clean_and_stops():
    """A CPU server built inside the sanitized block places a burst of
    count-2 jobs over its coalescer (the wrapped condition carries the
    dispatch and the resolver) with no report, and its shutdown — the
    permit wait and the condition wait giving way to ``stop()`` — ends
    well inside the coalescer's join window."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.server import Server, ServerConfig

    with tsan.sanitized():
        srv = Server(ServerConfig(num_workers=4, node_capacity=64,
                                  heartbeat_min_ttl=3600.0,
                                  heartbeat_max_ttl=7200.0,
                                  slo_enabled=False,
                                  overload_enabled=False), device="cpu")
        assert isinstance(srv.coalescer._cond._lock, tsan.TrackedLock)
        srv.start()
        try:
            for _ in range(16):
                srv.register_node(mock.node())
            evs = []
            for _ in range(12):
                job = mock.job()
                job.task_groups[0].count = 2
                evs.append(srv.submit_job(job))
            statuses = [srv.wait_for_eval(e.id, 60).status for e in evs]
        finally:
            t0 = time.monotonic()
            srv.shutdown()
            stopped_in = time.monotonic() - t0
        reports = tsan.reports()
    assert statuses == ["complete"] * 12
    placed = [a for a in srv.store.allocs.values() if not a.terminal_status()]
    assert len(placed) == 24
    assert srv.coalescer.fused_dispatches > 0
    assert reports == [], "\n".join(
        f"{r['label']} {r['op']} in {r['thread']} held={r['held']}"
        for r in reports)
    assert stopped_in < 8.0
    assert not srv.coalescer._thread.is_alive()
