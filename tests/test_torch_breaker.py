"""The port's device fault domain on the CPU, against the JAX package's.

* ``classify_stall`` and ``watchdog_fetch`` verdicts agree;
* ``DeviceBreaker``: state, counters, ``brief()`` and ``report()`` agree
  after every step of the same synthetic-clock verdict sequences (trip,
  probation, canary close and re-open, slow ratio, flip freeze, reset,
  and seeded random sequences), and ``BreakerConfig.from_env`` reads the
  same knobs;
* the coalescer's pipeline under a wedged wait (its ``_wait_fetch``
  replaced by a wait on an event the test holds; the seeded
  ``device.wedge`` seam is in ``test_torch_chaos_dispatch.py``): the
  wedged ticket's lane fails with ``DeviceWedgedError``, the others
  resolve; an open breaker
  refuses dispatches with ``DeviceBreakerOpenError`` and launches
  nothing; shutdown completes every future, also with a wait that never
  ends;
* on a server: the evals of a refused dispatch are nacked, and every job
  is placed in full once the breaker closes; the health report's
  ``device`` block and the ``top`` device row.
"""

import dataclasses
import io
import random
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

from nomad_tpu.obs import breaker as jbreaker
from nomad_tpu.obs import top as jtop
from nomad_tpu_torch import mock as tmock
from nomad_tpu_torch.obs import breaker as tbreaker
from nomad_tpu_torch.obs import top as ttop
from nomad_tpu_torch.obs.breaker import (
    BREAKER_CLOSED,
    BREAKER_HALF_OPEN,
    BREAKER_OPEN,
    STALL_OK,
    STALL_WEDGED,
    BreakerConfig,
    DeviceBreakerOpenError,
    DeviceWedgedError,
    watchdog_fetch,
)
from nomad_tpu_torch.ops.encode import RequestEncoder
from nomad_tpu_torch.scheduler import coalescer as tcoalescer
from nomad_tpu_torch.scheduler.coalescer import MAX_DELTA_ROWS, DeviceCoalescer
from nomad_tpu_torch.server.server import Server, ServerConfig
from nomad_tpu_torch.state.matrix import NodeMatrix

PKGS = {"jax": jbreaker, "port": tbreaker}


def both(fn, *args, **kw):
    """``fn(breaker_module, *args, **kw)`` in each package; asserts the
    results equal and returns the port's."""
    want = fn(jbreaker, *args, **kw)
    got = fn(tbreaker, *args, **kw)
    assert got == want
    return got


# ---------------------------------------------------------------------------
# Watchdog verdicts
# ---------------------------------------------------------------------------


def test_classify_stall_matches():
    grid = [(e, d, f) for e in (0.0, 0.05, 0.1, 0.12, 0.15, 0.2, 3600.0)
            for d in (-1.0, 0.0, 0.1) for f in (1.0, 1.5, 4.0)]
    verdicts = both(lambda b: [b.classify_stall(*g) for g in grid])
    assert set(verdicts) == {"ok", "slow", "wedged"}


def watchdog_verdicts(b):
    release = threading.Event()
    out = [b.watchdog_fetch(lambda: 42, 5.0)[:2],
           b.watchdog_fetch(lambda: "x", 0.0)[:2],
           b.watchdog_fetch(lambda: (time.sleep(0.35), "late")[1], 0.2,
                            wedge_factor=3.0)[:2]]
    try:
        verdict, value, elapsed = b.watchdog_fetch(
            lambda: release.wait(10), 0.05, wedge_factor=1.5)
    finally:
        release.set()  # unstick the sacrificial thread
    out.append((verdict, value, elapsed >= 0.075))

    def boom():
        raise ValueError("fetch exploded")

    try:
        b.watchdog_fetch(boom, 5.0)
    except ValueError as e:
        out.append(str(e))
    return out


def test_watchdog_fetch_matches():
    got = both(watchdog_verdicts)
    assert got == [("ok", 42), ("ok", "x"), ("slow", "late"),
                   ("wedged", None, True), "fetch exploded"]


def after(seconds):
    """A ``done()`` that turns true ``seconds`` from now."""
    at = time.monotonic() + seconds
    return lambda: time.monotonic() >= at


def test_poll_until_verdicts():
    """The resolver's polling wait gives ``classify_stall``'s verdicts
    and ``watchdog_fetch``'s wedge bound, and returns at the bound."""
    verdict, elapsed = tcoalescer.poll_until(lambda: True, 0.2, 3.0)
    assert verdict == STALL_OK and elapsed < 0.05
    assert tcoalescer.poll_until(after(0.05), 0.2, 3.0)[0] == STALL_OK
    assert tcoalescer.poll_until(after(0.35), 0.2, 3.0)[0] == "slow"
    verdict, elapsed = tcoalescer.poll_until(lambda: False, 0.05, 1.5)
    assert verdict == STALL_WEDGED and 0.075 < elapsed < 1.0
    # No deadline: no bound, the wait ends when done() does.
    assert tcoalescer.poll_until(after(0.1), 0.0, 1.5)[0] == STALL_OK


def test_wedged_error_carries_the_measurements():
    e = DeviceWedgedError("stuck", elapsed_s=0.4, deadline_s=0.2)
    assert isinstance(e, RuntimeError)
    assert (e.elapsed_s, e.deadline_s, str(e)) == (0.4, 0.2, "stuck")
    r = DeviceBreakerOpenError(BREAKER_OPEN)
    assert isinstance(r, RuntimeError) and r.state == BREAKER_OPEN


# ---------------------------------------------------------------------------
# The breaker on synthetic clocks
# ---------------------------------------------------------------------------

BASE_CFG = dict(
    deadline_ms=100.0, cold_scale=2.0, wedge_factor=1.5,
    trip_wedges=1, slow_ratio=0.5, min_samples=4, window_s=30.0,
    probation_s=5.0, cooldown_s=0.0, max_flips=10, flip_window_s=60.0,
)


def breaker(b, **over):
    return b.DeviceBreaker(config=b.BreakerConfig(**dict(BASE_CFG, **over)))


def snap(brk, now):
    return (brk.state, brk.deadline_s(), brk.brief(), brk.report(now=now))


def run_steps(b, steps, **over):
    """Apply ``steps`` (method name, kwargs) to a fresh breaker; the
    returned value and a snapshot after each."""
    brk = breaker(b, **over)
    out = []
    for name, kw in steps:
        ret = getattr(brk, name)(**kw)
        out.append((name, ret, snap(brk, kw.get("now", 0.0))))
    return out


T = 1000.0
SEQUENCES = {
    "cold_deadline": ([("record_ok", dict(elapsed_s=0.05, now=T))], {}),
    "trip_probation_canary_close": ([
        ("record_wedge", dict(elapsed_s=0.5, now=T)),
        ("allow_device_dispatch", dict(now=T + 1.0)),
        ("allow_device_dispatch", dict(now=T + 6.0)),
        ("allow_device_dispatch", dict(now=T + 6.1)),
        ("note_degraded", {}),
        ("record_ok", dict(elapsed_s=0.05, canary=True, now=T + 7.0)),
        ("allow_device_dispatch", dict(now=T + 7.1)),
    ], {}),
    "canary_reopens": ([
        ("record_wedge", dict(elapsed_s=0.5, now=T)),
        ("allow_device_dispatch", dict(now=T + 6.0)),
        ("record_wedge", dict(elapsed_s=0.5, canary=True, now=T + 7.0)),
        ("allow_device_dispatch", dict(now=T + 8.0)),
        ("allow_device_dispatch", dict(now=T + 12.5)),
        ("record_slow", dict(elapsed_s=0.12, canary=True, now=T + 13.0)),
    ], {}),
    "cancel_canary": ([
        ("record_wedge", dict(elapsed_s=0.5, now=T)),
        ("allow_device_dispatch", dict(now=T + 6.0)),
        ("cancel_canary", {}),
        ("allow_device_dispatch", dict(now=T + 6.1)),
    ], {}),
    "slow_ratio": ([
        ("record_ok", dict(elapsed_s=0.01, now=T)),
        ("record_ok", dict(elapsed_s=0.01, now=T + 1)),
        ("record_slow", dict(elapsed_s=0.12, now=T + 2)),
        ("record_slow", dict(elapsed_s=0.12, now=T + 3)),
        ("record_ok", dict(elapsed_s=0.01, now=T + 40)),
    ], dict(trip_wedges=99)),
    "flip_freeze": ([
        ("record_wedge", dict(elapsed_s=0.5, now=T)),
        ("allow_device_dispatch", dict(now=T + 6.0)),
        ("record_ok", dict(elapsed_s=0.05, canary=True, now=T + 7.0)),
        ("allow_device_dispatch", dict(now=T + 8.0)),
        ("record_wedge", dict(elapsed_s=0.5, now=T + 9.0)),
    ], dict(max_flips=2)),
    "cooldown": ([
        ("record_wedge", dict(elapsed_s=0.5, now=T)),
        ("allow_device_dispatch", dict(now=T + 0.5)),
        ("allow_device_dispatch", dict(now=T + 2.0)),
        ("record_ok", dict(elapsed_s=0.01, canary=True, now=T + 2.5)),
        ("allow_device_dispatch", dict(now=T + 2.6)),
        ("record_ok", dict(elapsed_s=0.01, canary=True, now=T + 3.5)),
    ], dict(probation_s=0.2, cooldown_s=1.0)),
    "reset": ([
        ("record_wedge", dict(elapsed_s=0.5, now=T)),
        ("reset", {}),
        ("allow_device_dispatch", dict(now=T + 5.0)),
        ("record_wedge", dict(elapsed_s=0.5, now=T + 10.0)),
        ("record_wedge", dict(elapsed_s=0.5, now=T + 100.0)),
    ], dict(max_flips=1)),
}


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_breaker_sequences_match(name):
    steps, over = SEQUENCES[name]
    got = both(run_steps, steps, **over)
    states = [s[2][0] for s in got]
    if name == "trip_probation_canary_close":
        assert states == [BREAKER_OPEN, BREAKER_OPEN, BREAKER_HALF_OPEN,
                          BREAKER_HALF_OPEN, BREAKER_HALF_OPEN,
                          BREAKER_CLOSED, BREAKER_CLOSED]
        assert [s[1] for s in got if s[0] == "allow_device_dispatch"] == [
            (False, False), (True, True), (False, False), (True, False)]
    if name == "flip_freeze":
        assert got[2][2][2]["breaker"] == BREAKER_HALF_OPEN
        assert got[-1][2][3]["flips"]["suppressed"] >= 1
    if name == "reset":
        # The forced close spends no flip; the budget then holds the
        # breaker closed inside the flip window, and not after it.
        assert states == [BREAKER_OPEN, BREAKER_CLOSED, BREAKER_CLOSED,
                          BREAKER_CLOSED, BREAKER_OPEN]
        assert got[3][2][3]["flips"]["suppressed"] == 1


def random_steps(seed):
    rng = random.Random(seed)
    now, steps = T, []
    for _ in range(300):
        now += rng.choice([0.0, 0.05, 0.5, rng.uniform(0.0, 8.0)])
        kind = rng.random()
        canary = rng.random() < 0.3
        if kind < 0.3:
            steps.append(("allow_device_dispatch", dict(now=now)))
        elif kind < 0.55:
            steps.append(("record_ok", dict(
                elapsed_s=rng.uniform(0, 0.1), canary=canary, now=now)))
        elif kind < 0.75:
            steps.append(("record_slow", dict(
                elapsed_s=rng.uniform(0.1, 0.15), canary=canary, now=now)))
        elif kind < 0.88:
            steps.append(("record_wedge", dict(
                elapsed_s=rng.uniform(0.15, 1.0), canary=canary, now=now)))
        elif kind < 0.95:
            steps.append(("cancel_canary", {}))
        elif kind < 0.99:
            steps.append(("note_degraded", {}))
        else:
            steps.append(("reset", {}))
    return steps


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_random_verdict_sequences_match(seed):
    got = both(run_steps, random_steps(seed), cooldown_s=0.3, max_flips=6,
               probation_s=2.0, window_s=10.0)
    assert {s[2][0] for s in got} == {
        BREAKER_CLOSED, BREAKER_OPEN, BREAKER_HALF_OPEN}


KNOBS = {
    "NOMAD_TPU_DEVICE_DEADLINE_MS": "250", "NOMAD_TPU_DEVICE_COLD_SCALE": "3",
    "NOMAD_TPU_DEVICE_WEDGE_FACTOR": "2.5", "NOMAD_TPU_DEVICE_TRIP_WEDGES": "2",
    "NOMAD_TPU_DEVICE_SLOW_RATIO": "0.25", "NOMAD_TPU_DEVICE_MIN_SAMPLES": "9",
    "NOMAD_TPU_DEVICE_WINDOW": "12", "NOMAD_TPU_DEVICE_PROBATION": "0.5",
    "NOMAD_TPU_DEVICE_COOLDOWN": "0.1", "NOMAD_TPU_DEVICE_MAX_FLIPS": "bad",
    "NOMAD_TPU_DEVICE_FLIP_WINDOW": "",
}


def test_from_env_matches(monkeypatch):
    assert dataclasses.asdict(tbreaker.BreakerConfig.from_env()) == \
        dataclasses.asdict(jbreaker.BreakerConfig.from_env())
    for k, v in KNOBS.items():
        monkeypatch.setenv(k, v)
    got = dataclasses.asdict(tbreaker.BreakerConfig.from_env())
    assert got == dataclasses.asdict(jbreaker.BreakerConfig.from_env())
    assert got["deadline_ms"] == 250.0 and got["max_flips"] == 6


# ---------------------------------------------------------------------------
# The coalescer's pipeline under a wedged wait
# ---------------------------------------------------------------------------


def matrix(n=8):
    m = NodeMatrix(capacity=16, device="cpu")
    for _ in range(n):
        m.upsert_node(tmock.node())
    return m


def inputs(m, job):
    compiled = RequestEncoder(m).compile(job, job.task_groups[0])
    n = m.capacity
    return dict(
        request=compiled.request,
        delta_rows=np.full((MAX_DELTA_ROWS,), -1, np.int32),
        delta_vals=np.zeros((MAX_DELTA_ROWS, 3), np.float32),
        tg_count=np.zeros((n,), np.int32),
        spread_counts=np.zeros_like(compiled.request.s_desired),
        penalty=np.zeros((n,), bool),
        class_elig=np.ones((2,), bool),
        host_mask=np.ones((n,), bool),
    )


def coalescer(m, cfg, **kw):
    coal = DeviceCoalescer(m, linger_s=0.0, device="cpu", **kw)
    coal.breaker = tbreaker.DeviceBreaker(config=cfg)
    return coal


def wedge_waits(coal, which, release):
    """Replace the coalescer's wait: the tickets numbered in ``which`` wait
    on ``release`` under the real watchdog; the others wait as usual.
    Returns the list of ticket numbers waited on."""
    real = coal._wait_fetch
    seen = []

    def wait(ticket, deadline, factor):
        seen.append(len(seen))
        if seen[-1] in which:
            return watchdog_fetch(lambda: release.wait(30), deadline, factor)
        return real(ticket, deadline, factor)

    coal._wait_fetch = wait
    return seen


def call(coal, args, out, i):
    try:
        out[i] = coal.place(**args, timeout=30.0)
    except BaseException as e:  # noqa: BLE001 — the outcome under test
        out[i] = e


def test_wedged_ticket_fails_its_lane_and_the_rest_resolve():
    m = matrix()
    cfg = BreakerConfig(deadline_ms=1000.0, cold_scale=1.0, probation_s=1.0,
                        cooldown_s=0.0)
    coal = coalescer(m, cfg, max_lanes=1, pipeline_depth=4)
    release = threading.Event()
    seen = wedge_waits(coal, {0}, release)
    coal.start()
    try:
        out = [None] * 4
        # A wedges; B is launched while A's wait is still inside its
        # bound, so it resolves after A is abandoned.
        ta = threading.Thread(target=call, args=(coal, inputs(m, tmock.job()),
                                                 out, 0))
        ta.start()
        while not seen:
            time.sleep(0.005)
        call(coal, inputs(m, tmock.job()), out, 1)
        ta.join(30)
        assert isinstance(out[0], DeviceWedgedError), out[0]
        assert out[0].elapsed_s > out[0].deadline_s > 0
        assert out[1].rows[0] >= 0
        assert coal.wedged_dispatches == 1
        assert coal.breaker.state == BREAKER_OPEN
        # Open: C is refused and launches nothing.
        dispatches = coal.dispatches
        call(coal, inputs(m, tmock.job()), out, 2)
        assert isinstance(out[2], DeviceBreakerOpenError), out[2]
        assert coal.dispatches == dispatches
        assert coal.breaker.brief()["degraded_dispatches"] == 1
        # After probation D is the canary; its ok verdict closes.
        time.sleep(1.05)
        call(coal, inputs(m, tmock.job()), out, 3)
        assert out[3].rows[0] >= 0
        assert coal.breaker.state == BREAKER_CLOSED
        report = coal.breaker.report()
        assert [(d["from"], d["to"]) for d in report["decisions"]] == [
            ("closed", "open"), ("open", "half_open"),
            ("half_open", "closed")]
        assert coal.inflight_depth() == 0
    finally:
        release.set()
        coal.stop()


def test_depth_eight_wedge_fails_one_ticket():
    """Ten single-lane dispatches, eight callers, one wedged ticket: one
    ``DeviceWedgedError``; every other caller gets placements or, once
    the breaker opened, a refusal that launched nothing."""
    m = matrix()
    cfg = BreakerConfig(deadline_ms=120.0, cold_scale=1.0, probation_s=600.0)
    coal = coalescer(m, cfg, max_lanes=1, pipeline_depth=8)
    release = threading.Event()
    wedge_waits(coal, {2}, release)
    coal.start()
    out = [None] * 10
    todo = list(range(10))
    lock = threading.Lock()
    args = [inputs(m, tmock.job()) for _ in range(10)]

    def worker():
        while True:
            with lock:
                if not todo:
                    return
                i = todo.pop(0)
            call(coal, args[i], out, i)

    threads = [threading.Thread(target=worker) for _ in range(8)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads), "caller hung"
    finally:
        release.set()
        coal.stop()
    wedged = [r for r in out if isinstance(r, DeviceWedgedError)]
    refused = [r for r in out if isinstance(r, DeviceBreakerOpenError)]
    placed = [r for r in out if not isinstance(r, BaseException)]
    assert len(wedged) == 1
    assert len(wedged) + len(refused) + len(placed) == 10
    assert all(o.rows[0] >= 0 for o in placed)
    assert coal.wedged_dispatches == 1
    brief = coal.breaker.brief()
    assert brief["trips"] == 1 and brief["breaker"] == BREAKER_OPEN
    assert brief["degraded_dispatches"] == len(refused)
    assert coal.dispatches == 1 + len(placed)
    assert coal.inflight_depth() == 0


def test_shutdown_completes_every_future_with_a_wait_that_never_ends(
        monkeypatch):
    """The resolver stuck on a wait that never returns (no watchdog),
    every permit held, a batch waiting for one and a request queued:
    stop() fails them all, the stuck ticket's lane included."""
    monkeypatch.setattr(tcoalescer, "_JOIN_WINDOW_S", 0.3)
    m = matrix()
    coal = coalescer(m, BreakerConfig(deadline_ms=0.0), max_lanes=1,
                     pipeline_depth=2)
    release = threading.Event()
    entered = threading.Event()

    def never(ticket, deadline, factor):
        entered.set()
        release.wait()
        return STALL_WEDGED, None, 0.0

    coal._wait_fetch = never
    coal.start()
    out = [None] * 4
    threads = []
    try:
        for i in range(4):
            t = threading.Thread(target=call, args=(
                coal, inputs(m, tmock.job()), out, i))
            t.start()
            threads.append(t)
            if i == 0:
                assert entered.wait(10)
        time.sleep(0.3)  # the pipeline fills: one stuck, one queued
        t0 = time.monotonic()
        coal.stop()
        for t in threads:
            t.join(10)
        assert not any(t.is_alive() for t in threads), (
            "a caller blocked past shutdown")
        assert time.monotonic() - t0 < 5.0
        assert all(isinstance(r, RuntimeError) for r in out), out
        assert all("stopped" in str(r) for r in out), out
    finally:
        release.set()
        coal._tickets.put(None)  # let the unstuck resolver exit


def test_place_after_stop_raises_immediately():
    m = matrix(4)
    coal = coalescer(m, BreakerConfig(), max_lanes=1, pipeline_depth=1)
    coal.start()
    coal.stop()
    with pytest.raises(RuntimeError, match="stopped"):
        coal.place(**inputs(m, tmock.job()), timeout=5.0)


# ---------------------------------------------------------------------------
# A server whose breaker trips
# ---------------------------------------------------------------------------


def drill_server(monkeypatch, **kw):
    monkeypatch.setenv("NOMAD_TPU_DEVICE_DEADLINE_MS", "100")
    monkeypatch.setenv("NOMAD_TPU_DEVICE_COLD_SCALE", "1")
    monkeypatch.setenv("NOMAD_TPU_DEVICE_PROBATION", "0.5")
    monkeypatch.setenv("NOMAD_TPU_DEVICE_COOLDOWN", "0")
    cfg = dict(num_workers=2, node_capacity=16, heartbeat_min_ttl=3600.0,
               heartbeat_max_ttl=7200.0, slo_enabled=False,
               overload_enabled=False, failed_eval_unblock_delay=0.5)
    cfg.update(kw)
    return Server(ServerConfig(**cfg), device="cpu")


def live(srv, job_id):
    return [a for a in srv.store.allocs.values()
            if a.job_id == job_id and not a.terminal_status()]


def test_open_breaker_nacks_and_jobs_place_after_it_closes(monkeypatch):
    srv = drill_server(monkeypatch)
    coal = srv.coalescer
    release = threading.Event()
    wedge_waits(coal, {0}, release)
    # The breaker's verdict on each dispatch, and the launches.
    verdicts, launched = [], []
    allow, real_dispatch = coal.breaker.allow_device_dispatch, coal._dispatch

    def watched_allow(*a, **kw):
        verdicts.append(allow(*a, **kw))
        return verdicts[-1]

    def dispatch(batch):
        launched.append(len(batch))
        return real_dispatch(batch)

    coal.breaker.allow_device_dispatch = watched_allow
    coal._dispatch = dispatch
    srv.start()
    try:
        for _ in range(8):
            srv.register_node(tmock.node())
        jobs = []
        for _ in range(6):
            job = tmock.job()
            job.task_groups[0].count = 2
            jobs.append(job)
            srv.submit_job(job)
        deadline = time.time() + 60
        while time.time() < deadline and not all(
                len(live(srv, j.id)) == 2 for j in jobs):
            time.sleep(0.05)
        assert [len(live(srv, j.id)) for j in jobs] == [2] * 6
        brk = coal.breaker.report()
        assert brk["state"] == BREAKER_CLOSED
        assert brk["trips"] == 1
        path = [(d["from"], d["to"]) for d in brk["decisions"]]
        assert path[:3] == [("closed", "open"), ("open", "half_open"),
                            ("half_open", "closed")]
        # Only admitted dispatches launched; the refused dispatches' evals
        # were nacked past their delivery limit and the reaper's
        # follow-ups placed them.
        admitted = [v for v in verdicts if v[0]]
        assert len(launched) == len(admitted) == coal.dispatches
        assert len(verdicts) - len(admitted) == brk["degraded_dispatches"]
        assert brk["degraded_dispatches"] >= 1
        assert sum(1 for v in admitted if v[1]) >= 1  # the canary
        assert coal.wedged_dispatches == 1
        assert srv.metrics.snapshot()[
            "nomad.coalescer.wedged_dispatches"] == 1
        failed = [e for e in srv.store.evals.values()
                  if e.status == "failed"]
        followups = [e for e in srv.store.evals.values()
                     if e.triggered_by == "failed-follow-up"]
        assert failed and len(followups) >= len(failed)
        # The health report's device block and the top device row.
        report = srv.observatory.tick()
        assert report["device"] == coal.breaker.brief()
        assert report["device"]["trips"] == 1
        screen = ttop.render(
            srv.metrics.snapshot(), srv.observatory.slo_report(),
            srv.observatory.health_report(),
            overload=srv.overload_controller.report())
        assert "device  : closed    trips 1  wedged 1" in screen
    finally:
        release.set()
        srv.shutdown()


def test_server_shutdown_returns_with_a_wait_that_never_ends(monkeypatch):
    monkeypatch.setattr(tcoalescer, "_JOIN_WINDOW_S", 0.3)
    srv = drill_server(monkeypatch, num_workers=1,
                       eval_nack_timeout=3600.0)
    monkeypatch.setenv("NOMAD_TPU_DEVICE_DEADLINE_MS", "0")
    srv.coalescer.breaker = tbreaker.DeviceBreaker(
        config=BreakerConfig(deadline_ms=0.0))
    release = threading.Event()
    entered = threading.Event()

    def never(ticket, deadline, factor):
        entered.set()
        release.wait()
        return STALL_WEDGED, None, 0.0

    srv.coalescer._wait_fetch = never
    srv.start()
    try:
        for _ in range(4):
            srv.register_node(tmock.node())
        srv.submit_job(tmock.job())
        assert entered.wait(30)
        done = threading.Event()
        t = threading.Thread(target=lambda: (srv.shutdown(), done.set()))
        t.start()
        t.join(30)
        assert done.is_set(), "Server.shutdown did not return"
    finally:
        release.set()
        srv.coalescer._tickets.put(None)


# ---------------------------------------------------------------------------
# The top device row
# ---------------------------------------------------------------------------


def frame_inputs():
    metrics = {
        "uptime_s": 42.0,
        "nomad.worker.evals_processed": 300,
        "nomad.plan.applied": 280,
        "nomad.broker.total_ready": 3, "nomad.broker.total_unacked": 2,
        "nomad.broker.total_pending": 1,
        "nomad.blocked_evals.total_blocked": 4,
        "nomad.plan.queue_depth": 1,
        "nomad.coalescer.inflight_depth": 2,
        "nomad.coalescer.pipeline_depth": 8,
        "nomad.coalescer.lane_fill_ratio": 0.5,
        "nomad.coalescer.stale_dispatches": 7,
        "nomad.phase.coalescer.device": {"count": 10, "p50_ms": 0.2,
                                         "p99_ms": 0.9},
        "nomad.phase.plan.queue_wait": {"count": 12, "p50_ms": 1.0,
                                        "p99_ms": 3.0},
    }
    prev = dict(metrics, **{"nomad.worker.evals_processed": 100,
                            "nomad.plan.applied": 80})
    slo = {"slos": [{"name": "placement_latency_p99_ms", "value": 3.9,
                     "op": "<", "target": 5, "burn_rate_fast": 0.4,
                     "burn_rate_slow": 0.2, "status": "ok"}]}
    health = {"status": "degraded", "score": 61.5, "device": {
        "breaker": "half_open", "trips": 2, "wedged": 3, "slow": 1,
        "degraded_dispatches": 9, "evacuations": 0}}
    overload = {"state": "gating", "pressure": {"fast": 0.5, "slow": 0.25},
                "actuators": {"admission": {"factor": 0.5, "rejected": 3},
                              "shed": {"total_shed": 1}},
                "flips": {"total": 2, "suppressed": 0}}
    return metrics, slo, health, prev, overload


def test_top_render_matches():
    metrics, slo, health, prev, overload = frame_inputs()
    frames = [
        top.render(metrics, slo, health, prev_metrics=prev, interval=2.0,
                   address="http://127.0.0.1:4646",
                   events=["12:00:00 SLO SLOBreached x"], overload=overload)
        for top in (ttop, jtop)
    ]
    assert frames[0] == frames[1]
    assert ("device  : half_open trips 2  wedged 3  slow 1  degraded 9  "
            "evac 0") in frames[0]
    assert "evals/s :    100.0" in frames[0]
    assert ttop.render({}, None, None) == jtop.render({}, None, None)


def test_run_top_with_a_stub_client():
    metrics, slo, health, _, overload = frame_inputs()
    calls = []
    client = SimpleNamespace(
        # Nothing listens on this local port: the event tail's connection
        # is refused and retried until the loop stops.
        address="http://127.0.0.1:9",
        metrics=lambda: (calls.append(1), metrics)[1],
        slo=lambda: slo, health=lambda: health,
        overload=lambda: (_ for _ in ()).throw(RuntimeError("501")),
    )
    out = io.StringIO()
    assert ttop.run_top(client, interval=0.01, count=3, clear=False,
                        out=out) == 0
    text = out.getvalue()
    assert len(calls) == 3
    assert text.count("nomad top — http://127.0.0.1:9") == 3
    assert ttop.CLEAR not in text and "actuator" not in text
    assert "device  : half_open" in text
