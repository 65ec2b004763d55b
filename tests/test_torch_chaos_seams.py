"""The port's host seams against the JAX package's, on the CPU: one
schedule drives the reference module and the port's copy, and both show
the same effect (the same error and message, the same log bytes, the
same armed deadline, the same swallowed stop...): ``rpc.call``,
``raft.send``, ``wal.write``, ``heartbeat.ttl``, ``driver.start``,
``driver.wait``, ``driver.stop``, ``client.heartbeat``; and the dump's
chaos seed.  Every seam also emits its ``seam.*`` trace event in the
port.
"""

import http.server
import json
import random
import threading
import time

import pytest
import torch

from nomad_tpu import trace as jtrace
from nomad_tpu_torch import trace as ttrace
from torch_chaos_parity import (  # noqa: F401 — seam_events is a fixture
    JAX,
    PKGS,
    PORT,
    chaos,
    rows,
    seam_events,
)
from torch_parity import wait_until

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# The seams
# ---------------------------------------------------------------------------


class _Counter(http.server.BaseHTTPRequestHandler):
    hits = []

    def do_POST(self):  # noqa: N802 — the handler's protocol
        n = int(self.headers.get("Content-Length") or 0)
        self.hits.append((self.path, self.rfile.read(n)))
        body = b"{}"
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *a):
        pass


@pytest.fixture
def counter():
    """A loopback HTTP server that answers ``{}`` and records each POST."""
    _Counter.hits = []
    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _Counter)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}", _Counter.hits
    srv.shutdown()
    srv.server_close()


def rpc_mod(pkg):
    if pkg == JAX:
        from nomad_tpu.api import rpc
    else:
        from nomad_tpu_torch.api import rpc
    return rpc


def test_rpc_call_drop_error_dup(counter, seam_events):
    addr, hits = counter
    out = {}
    for pkg in PKGS:
        c, rpc = chaos(pkg), rpc_mod(pkg)
        client = rpc.HTTPServerRPC(addr, timeout=5.0)
        errors = []
        del hits[:]
        with c.injected(0, [
            c.FaultSpec("rpc.call", "drop", at_step=1),
            c.FaultSpec("rpc.call", "error", at_step=2),
            c.FaultSpec("rpc.call", "dup", at_step=3),
        ]) as inj:
            for _ in range(2):
                with pytest.raises(rpc.RPCError) as ei:
                    client._call("/v1/internal/ping", {"a": 1})
                errors.append(str(ei.value))
            assert client._call("/v1/internal/ping", {"a": 2}) == {}
        out[pkg] = (errors, list(hits), rows(inj.log))
    assert out[PORT] == out[JAX]
    errors, posted, _ = out[PORT]
    assert "injected connection drop" in errors[0]
    assert "500 injected server error" in errors[1]
    assert posted == [("/v1/internal/ping", b'{"a": 2}')] * 2  # the dup
    assert "seam.rpc.call" in seam_events[PORT]


def replicator(pkg, sid):
    if pkg == JAX:
        from nomad_tpu.server.replication import Replicator
    else:
        from nomad_tpu_torch.server.replication import Replicator
    r = Replicator.__new__(Replicator)
    r.id, r.cluster_secret, r.rpc_timeout = sid, "", 5.0
    return r


def test_raft_send_cuts_one_link_and_dups(counter, seam_events):
    """``match={"dst": ...}`` cuts exactly one link; ``dup`` posts twice;
    the seam fires once per message to one peer."""
    import urllib.error

    addr, hits = counter
    other = addr + "/"  # another peer address, the same listener
    out = {}
    for pkg in PKGS:
        c = chaos(pkg)
        rep = replicator(pkg, "server-0")
        del hits[:]
        dropped = []
        with c.injected(0, [
            c.FaultSpec("raft.send", "drop", match={"dst": addr}, count=2),
            c.FaultSpec("raft.send", "dup", match={"dst": other},
                        at_step=4),
        ]) as inj:
            for dst in (addr, other, addr, other, addr):
                try:
                    rep._post(dst, "/v1/internal/raft/append", {"t": 1})
                    dropped.append(False)
                except urllib.error.URLError as e:
                    dropped.append(str(e.reason))
            hit_count = inj.hits("raft.send")
        out[pkg] = (dropped, len(hits), rows(inj.log), hit_count)
    assert out[PORT] == out[JAX]
    dropped, posted, _, hit_count = out[PORT]
    assert dropped == ["injected partition", False, "injected partition",
                       False, False]
    assert posted == 4 and hit_count == 5
    assert "seam.raft.send" in seam_events[PORT]


def wal_mod(pkg):
    if pkg == JAX:
        from nomad_tpu.state import wal
    else:
        from nomad_tpu_torch.state import wal
    return wal


def test_wal_torn_write_poisons_then_reload_drops_tail(tmp_path,
                                                       seam_events):
    out = {}
    for pkg in PKGS:
        c, wal = chaos(pkg), wal_mod(pkg)
        d = tmp_path / pkg
        log = wal.WriteAheadLog(str(d))
        log.append(1, "upsert_job", {"ok": 1})
        msgs = []
        with c.injected(0, [c.FaultSpec("wal.write", "torn", at_step=1)]):
            for i in (2, 3):
                with pytest.raises(wal.WALWriteError) as ei:
                    log.append(i, "upsert_job", {"ok": i})
                msgs.append(str(ei.value))
        log.close()
        torn = (d / wal.LOG_NAME).read_bytes()
        _snap, entries = wal.WriteAheadLog(str(d)).load()
        out[pkg] = (msgs, torn, [e["i"] for e in entries])
    assert out[PORT] == out[JAX]
    msgs, torn, kept = out[PORT]
    assert "injected torn write" in msgs[0] and "poisoned" in msgs[1]
    assert not torn.endswith(b"\n") and kept == [1]
    assert "seam.wal.write" in seam_events[PORT]


def test_wal_fsync_error_persists_and_reports(tmp_path):
    out = {}
    for pkg in PKGS:
        c, wal = chaos(pkg), wal_mod(pkg)
        d = tmp_path / pkg
        log = wal.WriteAheadLog(str(d))
        with c.injected(0, [c.FaultSpec("wal.write", "fsync_error",
                                        count=1)]):
            with pytest.raises(wal.WALWriteError, match="fsync"):
                log.append(1, "upsert_job", {})
            log.append(2, "upsert_job", {})  # not poisoned
        log.close()
        out[pkg] = (d / wal.LOG_NAME).read_bytes()
    assert out[PORT] == out[JAX]
    assert out[PORT].count(b"\n") == 2


def heartbeats(pkg, on_expire):
    if pkg == JAX:
        from nomad_tpu.server.heartbeat import HeartbeatManager
        return HeartbeatManager(on_expire=on_expire, min_ttl=2.0,
                                max_ttl=2.0)
    from nomad_tpu_torch.server.heartbeat import HeartbeatManager
    return HeartbeatManager(on_expire=on_expire, rng=random.Random(0),
                            min_ttl=2.0, max_ttl=2.0)


def test_heartbeat_skew_arms_shorter_deadline(seam_events):
    """skew 0.05: the server arms a 0.1 s deadline while granting 2 s."""
    for pkg in PKGS:
        c = chaos(pkg)
        expired = threading.Event()
        hb = heartbeats(pkg, lambda _nid, e=expired: e.set())
        hb.set_enabled(True)
        try:
            with c.injected(0, [c.FaultSpec("heartbeat.ttl", "skew",
                                            duration=0.05)]):
                t0 = time.monotonic()
                granted = hb.reset_heartbeat("node-1")
                armed = hb._deadlines["node-1"] - t0
            assert granted == 2.0, pkg
            assert 0.09 <= armed <= 0.2, (pkg, armed)
            assert expired.wait(timeout=1.0), pkg
        finally:
            hb.set_enabled(False)
    assert "seam.heartbeat.ttl" in seam_events[PORT]


def drivers(pkg):
    if pkg == JAX:
        from nomad_tpu.client import driver
        from nomad_tpu.structs import Task
    else:
        from nomad_tpu_torch.client import driver
        from nomad_tpu_torch.structs import Task
    return driver, Task


def test_driver_start_exit127(tmp_path, seam_events):
    """An injected exit127: the start succeeds and the task exits 127,
    for the mock driver and for raw_exec."""
    out = {}
    for pkg in PKGS:
        c, (driver, Task) = chaos(pkg), drivers(pkg)
        codes = []
        for drv, cfg in ((driver.MockDriver(), {}),
                         (driver.RawExecDriver(),
                          {"command": "/bin/sh", "args": ["-c", "exit 0"]})):
            handle = driver.TaskHandle(id=f"{pkg}-{drv.name}",
                                       driver=drv.name, task_name="t",
                                       alloc_id="a")
            task_dir = tmp_path / handle.id
            task_dir.mkdir()
            with c.injected(0, [c.FaultSpec("driver.start", "exit127",
                                            at_step=1)]):
                drv.start_task(handle, Task(name="t", config=cfg),
                               task_dir=str(task_dir))
            res = drv.wait_task(handle, timeout=5.0)
            codes.append(res.exit_code)
        out[pkg] = codes
    assert out[PORT] == out[JAX] == [127, 127]
    assert "seam.driver.start" in seam_events[PORT]


def test_driver_wait_wedge_stop_skip_hang_error(seam_events):
    """``wedge`` at wait reports still running; ``skip`` at stop swallows
    the stop; ``hang`` sleeps and proceeds; ``error`` raises."""
    out = {}
    for pkg in PKGS:
        c, (driver, Task) = chaos(pkg), drivers(pkg)
        drv = driver.MockDriver()
        handle = driver.TaskHandle(id="h", driver="mock", task_name="t",
                                   alloc_id="a")
        drv.start_task(handle, Task(name="t", config={}), task_dir="/tmp")
        got = []
        with c.injected(0, [
            c.FaultSpec("driver.wait", "wedge", at_step=1),
            c.FaultSpec("driver.stop", "skip", at_step=1),
            c.FaultSpec("driver.stop", "hang", at_step=2, duration=0.05),
            c.FaultSpec("driver.wait", "error", at_step=3),
        ]) as inj:
            got.append(drv.wait_task(handle, timeout=0.01))  # wedged
            drv.stop_task(handle, kill_timeout=0.1)  # swallowed
            got.append(drv.wait_task(handle, timeout=0.2))  # still running
            t0 = time.monotonic()
            drv.stop_task(handle, kill_timeout=0.1)  # hangs, then stops
            got.append(time.monotonic() - t0 >= 0.04)
            with pytest.raises(driver.DriverError, match="injected"):
                drv.wait_task(handle, timeout=1.0)
        res = drv.wait_task(handle, timeout=2.0)
        out[pkg] = (got, res.signal, rows(inj.log))
    assert out[PORT] == out[JAX]
    assert out[PORT][0] == [None, None, True] and out[PORT][1] == 9
    for seam in ("seam.driver.wait", "seam.driver.stop"):
        assert seam in seam_events[PORT]


@pytest.mark.parametrize("kind", ["skip", "error"])
def test_client_lost_heartbeats_expire_then_reconnect(tmp_path, seam_events,
                                                      kind):
    """A budget of skipped (or failing) beats expires the node; once it
    is spent the next real beat brings it back (DOWN -> INIT -> READY),
    in both packages."""
    from nomad_tpu.client import Client as JClient
    from nomad_tpu.client import ClientConfig as JClientConfig
    from nomad_tpu.server import Server as JServer
    from nomad_tpu.server import ServerConfig as JServerConfig
    from nomad_tpu_torch.client import Client as TClient
    from nomad_tpu_torch.client import ClientConfig as TClientConfig
    from nomad_tpu_torch.server import Server as TServer
    from nomad_tpu_torch.server import ServerConfig as TServerConfig

    out = {}
    for pkg in PKGS:
        c = chaos(pkg)
        kw = dict(num_workers=1, heartbeat_min_ttl=0.5, heartbeat_max_ttl=0.6)
        if pkg == JAX:
            srv = JServer(JServerConfig(**kw))
            client = JClient(srv, JClientConfig(data_dir=str(tmp_path / pkg)))
        else:
            srv = TServer(TServerConfig(**kw, slo_enabled=False,
                                        overload_enabled=False),
                          device="cpu")
            client = TClient(srv, TClientConfig(data_dir=str(tmp_path / pkg)))
        srv.start()
        statuses = []
        try:
            client.start()
            nid = client.node.id

            def status():
                n = srv.store.node_by_id(nid)
                return n.status if n else None

            wait_until(lambda: status() == "ready", f"{pkg} ready")
            with c.injected(0, [
                c.FaultSpec("client.heartbeat", kind, count=8),
            ]) as inj:
                wait_until(lambda: status() == "down", f"{pkg} expired",
                           timeout=20)
                statuses.append(status())
            wait_until(lambda: status() == "ready", f"{pkg} back",
                       timeout=20)
            statuses.append(status())
            out[pkg] = (statuses, {(s, k) for s, k, _ in rows(inj.log)})
        finally:
            client.shutdown()
            srv.shutdown()
    assert out[PORT] == out[JAX]
    assert out[PORT] == (["down", "ready"], {("client.heartbeat", kind)})
    assert "seam.client.heartbeat" in seam_events[PORT]


# -- the overload actuators --------------------------------------------------




def test_dump_carries_chaos_seed(tmp_path, monkeypatch):
    monkeypatch.setenv("NOMAD_TPU_TRACE_DIR", str(tmp_path))
    out = {}
    for pkg, tr in ((JAX, jtrace), (PORT, ttrace)):
        c = chaos(pkg)
        path = str(tmp_path / f"{pkg}.json")
        with c.injected(seed=123, schedule=[]):
            seeded = tr.dump_flight_record(path=path, reason="unit")
        unseeded = tr.dump_flight_record(path=path + ".2", reason="unit")
        meta = json.load(open(seeded))["metadata"]
        out[pkg] = (meta["reason"], meta.get("chaos_seed"),
                    json.load(open(unseeded))["metadata"].get("chaos_seed"))
    assert out[PORT] == out[JAX] == ("unit", 123, None)


# -- the device seams --------------------------------------------------------
