"""The port's change-event stream on the CPU, against the JAX package's.

* The same RPC sequence on a JAX server and on a port server
  (``device="cpu"``) publishes the same events: topic, type, raft index
  and key, with the random ids (evals, allocs) named by their job,
  trigger, alloc name and node.
* The broker cases of ``tests/test_stream.py`` (topic and key filters,
  replay from an index, close, the gap marker on a resume past eviction,
  a clean resume, a stale subscriber during eviction), each run against
  both packages' ``EventBroker``.
* A restore publishes no history and marks it truncated: a subscriber
  resuming from before the restart gets the gap marker first.

Every wait is on a predicate with its own deadline.
"""

import threading
import time

import numpy as np
import pytest
import torch

from nomad_tpu import mock as jmock
from nomad_tpu import stream as jstream
from nomad_tpu.server.server import Server as JServer
from nomad_tpu.server.server import ServerConfig as JServerConfig
from nomad_tpu_torch import mock as tmock
from nomad_tpu_torch import stream as tstream
from nomad_tpu_torch.server.server import Server, ServerConfig

torch.set_num_threads(1)

WAIT = 45.0
JAX, PORT = "jax", "port"
MOCK = {JAX: jmock, PORT: tmock}
BROKERS = pytest.mark.parametrize("st", [jstream, tstream],
                                  ids=["jax", "port"])


def make_server(pkg, **kw):
    kw.setdefault("num_workers", 1)
    kw.setdefault("node_capacity", 32)
    kw.setdefault("heartbeat_min_ttl", 3600.0)
    kw.setdefault("heartbeat_max_ttl", 7200.0)
    if pkg == JAX:
        return JServer(JServerConfig(slo_enabled=False,
                                     overload_enabled=False, **kw))
    return Server(ServerConfig(slo_enabled=False, overload_enabled=False,
                               **kw), device="cpu")


def settle(srv, timeout=WAIT):
    broker = srv.eval_broker
    deadline = time.time() + timeout
    quiet = 0
    while quiet < 3:
        if time.time() > deadline:
            raise AssertionError(f"server did not settle in {timeout} s")
        busy = (broker.ready_count() + broker.unacked_count()
                + broker.pending_count() + broker.delayed_count())
        open_evals = [e for e in list(srv.store.evals.values())
                      if not e.terminal_status() and e.status != "blocked"]
        quiet = quiet + 1 if not busy and not open_evals else 0
        time.sleep(0.03)


def drain(sub):
    out = []
    while True:
        batch = sub.next(timeout=0.2)
        if not batch:
            return out
        out.extend(batch)


def rpc_sequence(srv, pkg):
    """Node registrations, a service job, the client's running reports,
    a system job, a node going down (its allocs are lost and replaced),
    a node made ineligible, a job stopped and one purged."""
    mock = MOCK[pkg]
    rng = np.random.default_rng(13)
    for i in range(6):
        node = mock.node()
        node.id = node.name = f"node-{i}"
        node.resources.cpu = int(rng.integers(2000, 8000))
        node.resources.memory_mb = int(rng.integers(4096, 16384))
        srv.register_node(node)
    settle(srv)
    web = mock.job()
    web.id = web.name = "web"
    web.task_groups[0].count = 3
    srv.submit_job(web)
    settle(srv)
    updates = []
    for a in list(srv.store.allocs.values()):
        upd = a.copy()
        upd.client_status = "running"
        updates.append(upd)
    srv.update_allocs_from_client(updates)
    settle(srv)
    sysjob = mock.system_job()
    sysjob.id = sysjob.name = "sys"
    srv.submit_job(sysjob)
    settle(srv)
    busiest = max(srv.store.nodes, key=lambda n: len([
        a for a in srv.store.allocs_by_node(n) if a.job_id == "web"]))
    srv.update_node_status(busiest, "down")
    settle(srv)
    srv.update_node_eligibility("node-5", "ineligible")
    settle(srv)
    srv.deregister_job("default", "sys")
    settle(srv)
    srv.deregister_job("default", "web", purge=True)
    settle(srv)


def event_sequence(pkg):
    srv = make_server(pkg)
    srv.start()
    try:
        sub = srv.store.events.subscribe()
        rpc_sequence(srv, pkg)
        events = drain(sub)
    finally:
        srv.shutdown()
    # Eval and alloc ids are random: name each by what it is, the first
    # time it appears.  Events of one index come from one store call,
    # whose order over a set of ids is arbitrary: compare them as a
    # sorted group.
    names = {}
    groups = []
    for e in events:
        key = e.key
        if e.topic == "Evaluation":
            p = e.payload
            key = names.setdefault(key, f"eval:{p.job_id}:{p.triggered_by}:"
                                        f"{p.node_id}")
        elif e.topic == "Allocation":
            p = e.payload
            key = names.setdefault(key, f"alloc:{p.name}:{p.node_id}")
        if not groups or groups[-1][0] != e.index:
            groups.append((e.index, []))
        groups[-1][1].append((e.topic, e.type, key, e.namespace))
    return [(index, sorted(group)) for index, group in groups]


def test_same_rpcs_publish_the_same_events():
    jax_events = event_sequence(JAX)
    port_events = event_sequence(PORT)
    flat = [ev for _, group in port_events for ev in group]
    assert {"Node", "Job", "Evaluation", "Allocation"} <= {
        topic for topic, *_ in flat}
    assert len(flat) > 40
    assert port_events == jax_events


@pytest.mark.parametrize("pkg", [JAX, PORT])
def test_restore_marks_history_truncated(tmp_path, pkg):
    data = tmp_path / "data"
    srv = make_server(pkg, data_dir=str(data))
    srv.start()
    mock = MOCK[pkg]
    for _ in range(3):
        srv.register_node(mock.node())
    settle(srv)
    latest = srv.store.latest_index
    srv.shutdown()

    back = make_server(pkg, data_dir=str(data))
    try:
        assert back.store.events.latest_index == 0  # nothing re-published
        sub = back.store.events.subscribe(from_index=1)
        evs = sub.next(timeout=2)
        assert (evs[0].topic, evs[0].type) == ("Framework", "EventStreamGap")
        assert evs[0].payload == {"requested_index": 1,
                                  "dropped_through": latest}
        assert evs[1:] == []
        sub.close()
        # A new write after the restore streams at the next index.
        live = back.store.events.subscribe({"Node": ["*"]})
        back.register_node(mock.node())
        evs = live.next(timeout=2)
        assert [(e.type, e.index) for e in evs] == [
            ("NodeRegistration", latest + 1)]
    finally:
        back.shutdown()


# ---------------------------------------------------------------------------
# The broker cases of tests/test_stream.py, against both packages
# ---------------------------------------------------------------------------


@BROKERS
def test_publish_subscribe_topic_filter(st):
    b = st.EventBroker()
    all_sub = b.subscribe()
    job_sub = b.subscribe({"Job": ["*"]})
    keyed = b.subscribe({"Job": ["job-1"]})
    b.publish([
        st.Event(topic="Job", type="JobRegistered", key="job-1", index=1),
        st.Event(topic="Node", type="NodeRegistration", key="n1", index=2),
    ])
    assert {e.key for e in all_sub.next(timeout=2)} == {"job-1", "n1"}
    assert [e.key for e in job_sub.next(timeout=2)] == ["job-1"]
    assert [e.key for e in keyed.next(timeout=2)] == ["job-1"]
    b.publish([st.Event(topic="Job", type="JobRegistered", key="other",
                        index=3)])
    assert keyed.next(timeout=0.2) == []


@BROKERS
def test_from_index_replays_buffer(st):
    b = st.EventBroker()
    b.publish([st.Event(topic="Job", type="T", key=f"k{i}", index=i)
               for i in range(1, 6)])
    sub = b.subscribe(from_index=3)
    assert [e.index for e in sub.next(timeout=2)] == [4, 5]


@BROKERS
def test_close_unsubscribes(st):
    b = st.EventBroker()
    sub = b.subscribe()
    assert b.subscriber_count() == 1
    sub.close()
    assert b.subscriber_count() == 0
    assert sub.next(timeout=0.1) == []


@BROKERS
def test_gap_event_when_resuming_past_eviction(st):
    b = st.EventBroker(buffer_size=8)
    b.publish([st.Event(topic="Job", type="T", key=f"k{i}", index=i)
               for i in range(1, 21)])
    sub = b.subscribe({"Job": ["*"]}, from_index=2)
    evs = drain(sub)
    gap = evs[0]
    assert (gap.topic, gap.type) == ("Framework", "EventStreamGap")
    assert gap.payload == {"requested_index": 2, "dropped_through": 12}
    assert [e.index for e in evs[1:]] == list(range(13, 21))


@BROKERS
def test_clean_resume_within_buffer(st):
    b = st.EventBroker(buffer_size=64)
    b.publish([st.Event(topic="Job", type="T", key=f"k{i}", index=i)
               for i in range(1, 11)])
    evs = b.subscribe({"Job": ["*"]}, from_index=4).next(timeout=2)
    assert all(e.type != "EventStreamGap" for e in evs)
    assert [e.index for e in evs] == [5, 6, 7, 8, 9, 10]


@BROKERS
def test_concurrent_publish_during_eviction(st):
    b = st.EventBroker(buffer_size=16)
    done = threading.Event()

    def writer():
        for i in range(1, 1001):
            b.publish([st.Event(topic="Job", type="T", key=f"k{i}",
                                index=i)])
        done.set()

    t = threading.Thread(target=writer, daemon=True)
    t.start()
    rounds = 0
    while not done.is_set() and rounds < 50:
        sub = b.subscribe({"Job": ["*"]}, from_index=1)
        evs = sub.next(timeout=0.2)
        sub.close()
        rounds += 1
        if not evs:
            continue
        job_idxs = [e.index for e in evs if e.topic == "Job"]
        assert job_idxs == sorted(job_idxs), job_idxs
        if evs[0].type == "EventStreamGap":
            dropped = evs[0].payload["dropped_through"]
            assert all(i > dropped for i in job_idxs)
    t.join(timeout=30)
    sub = b.subscribe({"Job": ["*"]}, from_index=1)
    evs = sub.next(timeout=2)
    sub.close()
    assert evs[0].type == "EventStreamGap"
    assert evs[0].payload["dropped_through"] == 1000 - 16


def test_event_wire_forms_match():
    """``Event.to_wire`` of the same event, payload included, is the same
    in both packages."""
    from nomad_tpu.structs import serde as jserde
    from nomad_tpu_torch.structs import serde as tserde

    jnode = jmock.node()
    tnode = tserde.from_wire(jserde.to_wire(jnode))
    jw = jstream.Event(topic="Node", type="NodeRegistration", key=jnode.id,
                       index=4, payload=jnode).to_wire()
    tw = tstream.Event(topic="Node", type="NodeRegistration", key=tnode.id,
                       index=4, payload=tnode).to_wire()
    assert jw == tw
    assert tw["Payload"]["__t"] == "Node"
