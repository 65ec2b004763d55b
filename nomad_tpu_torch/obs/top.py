"""``nomad top`` — live terminal dashboard over the observability API.

A refresh loop over a client's ``metrics()`` + ``slo()`` + ``health()``
+ ``overload()`` (the reference's ``/v1/metrics``, ``/v1/slo``,
``/v1/health`` and ``/v1/overload``), with a background tail of the
``SLO``/``Health`` topics on ``<address>/v1/event/stream`` so
breach/recovery transitions show up between refreshes.  Rendering is a
pure function of two successive metric snapshots (rates are deltas /
interval), so the screen layout is testable without a server: pass it
``MetricsRegistry.snapshot()``, ``SLOObservatory.slo_report()``,
``health_report()`` and ``OverloadController.report()``.  A copy of the
reference package's ``obs/top.py``: ``run_top`` takes an
``api.client.APIClient`` (``nomad-tpu top``), or any object with
``address`` and those four methods.

Layout:

    nomad top — http://…       health: ok (score 97.3)   uptime 142s
    evals/s     : 512.4        broker ready/unacked/pending: 0/3/1
    blocked     : 0            plan queue: 0   applied/s: 511.9
    pipeline    : 3/8 in flight   lane fill: 0.82   stale: 0
    actuator: steady    pressure 0.02/0.01  gate 1.00  429s 0 …
    device  : closed    trips 0  wedged 0  slow 0  degraded 0  evac 0
    phase                     count      p50 ms      p99 ms
      broker.queue_wait       51234       0.210       1.820
      …
    slo                        value   target   burn(f/s)   status
      placement_latency_p99_ms 3.91    <5       0.4/0.2     ok
    events:
      12:02:11 SLO SLOBreached placement_latency_p99_ms
"""

from __future__ import annotations

import json
import threading
import time
import urllib.request
from collections import deque
from typing import Any, Dict, List, Optional

CLEAR = "\x1b[2J\x1b[H"

# Counters whose per-interval delta is a headline rate.
_RATE_KEYS = {
    "evals/s": "nomad.worker.evals_processed",
    "applied/s": "nomad.plan.applied",
}


def _num(snap: Dict[str, Any], key: str, default: float = 0.0) -> float:
    v = snap.get(key, default)
    return float(v) if isinstance(v, (int, float)) else default


def _rates(
    prev: Optional[Dict[str, Any]], cur: Dict[str, Any], interval: float
) -> Dict[str, float]:
    out = {}
    for label, key in _RATE_KEYS.items():
        if prev is None or interval <= 0:
            out[label] = 0.0
        else:
            out[label] = max(0.0, (_num(cur, key) - _num(prev, key)) / interval)
    return out


def _phase_rows(snap: Dict[str, Any], limit: int = 12) -> List[tuple]:
    rows = []
    for key, v in snap.items():
        if key.startswith("nomad.phase.") and isinstance(v, dict):
            rows.append((
                key[len("nomad.phase."):],
                int(v.get("count", 0)),
                float(v.get("p50_ms", 0.0)),
                float(v.get("p99_ms", 0.0)),
            ))
    rows.sort(key=lambda r: -(r[1] * r[3]))  # count×p99 ≈ where time goes
    return rows[:limit]


def render(
    metrics: Dict[str, Any],
    slo: Optional[Dict[str, Any]],
    health: Optional[Dict[str, Any]],
    prev_metrics: Optional[Dict[str, Any]] = None,
    interval: float = 2.0,
    address: str = "",
    events: Optional[List[str]] = None,
    overload: Optional[Dict[str, Any]] = None,
) -> str:
    lines: List[str] = []
    h = health or {}
    status = h.get("status", "?")
    lines.append(
        f"nomad top — {address}   health: {status} "
        f"(score {h.get('score', '?')})   "
        f"uptime {int(_num(metrics, 'uptime_s'))}s"
    )
    r = _rates(prev_metrics, metrics, interval)
    lines.append(
        f"evals/s : {r['evals/s']:>8.1f}    broker r/u/p: "
        f"{int(_num(metrics, 'nomad.broker.total_ready'))}/"
        f"{int(_num(metrics, 'nomad.broker.total_unacked'))}/"
        f"{int(_num(metrics, 'nomad.broker.total_pending'))}"
        f"    blocked: {int(_num(metrics, 'nomad.blocked_evals.total_blocked'))}"
    )
    lines.append(
        f"plans   : depth {int(_num(metrics, 'nomad.plan.queue_depth'))}"
        f"  applied/s {r['applied/s']:.1f}"
        f"    pipeline: "
        f"{int(_num(metrics, 'nomad.coalescer.inflight_depth'))}/"
        f"{int(_num(metrics, 'nomad.coalescer.pipeline_depth'))} in flight"
        f"  lane fill {_num(metrics, 'nomad.coalescer.lane_fill_ratio'):.2f}"
        f"  stale {int(_num(metrics, 'nomad.coalescer.stale_dispatches'))}"
    )
    shard_rows = []
    for key, v in metrics.items():
        if key.startswith("nomad.matrix.shard_rows{") and isinstance(
            v, (int, float)
        ):
            try:
                shard_rows.append(
                    (int(key.rsplit("=", 1)[1].rstrip("}")), int(v))
                )
            except ValueError:
                continue
    shard_rows.sort()
    if len(shard_rows) > 1:
        # Shard balance: claimed rows per home shard plus the max/mean
        # skew — a hot shard ranks/scores more rows per dispatch than the
        # rest of the mesh, so skew IS the sharded-path straggler gauge.
        counts = [c for _, c in shard_rows]
        mean = sum(counts) / len(counts)
        skew = (max(counts) / mean) if mean else 1.0
        lines.append(
            f"shards  : rows {'/'.join(str(c) for c in counts)}"
            f"  skew {skew:.2f}"
            f"  topk host bytes "
            f"{int(_num(metrics, 'nomad.topk.host_bytes_total'))}"
        )
    if overload:
        p = overload.get("pressure", {})
        act = overload.get("actuators", {})
        adm = act.get("admission", {})
        shed = act.get("shed", {})
        flips = overload.get("flips", {})
        lines.append(
            f"actuator: {overload.get('state', '?'):<9}"
            f" pressure {p.get('fast', 0):.2f}/{p.get('slow', 0):.2f}"
            f"  gate {adm.get('factor', 1.0):.2f}"
            f"  429s {int(adm.get('rejected', 0))}"
            f"  shed {int(shed.get('total_shed', 0))}"
            f"  flips {int(flips.get('total', 0))}"
            f" (supp {int(flips.get('suppressed', 0))})"
        )
    dev = h.get("device")
    if isinstance(dev, dict):
        lines.append(
            f"device  : {dev.get('breaker', '?'):<9}"
            f" trips {int(dev.get('trips', 0))}"
            f"  wedged {int(dev.get('wedged', 0))}"
            f"  slow {int(dev.get('slow', 0))}"
            f"  degraded {int(dev.get('degraded_dispatches', 0))}"
            f"  evac {int(dev.get('evacuations', 0))}"
        )
    phases = _phase_rows(metrics)
    if phases:
        lines.append(f"{'phase':<30}{'count':>9}{'p50 ms':>10}{'p99 ms':>10}")
        for name, count, p50, p99 in phases:
            lines.append(f"  {name:<28}{count:>9}{p50:>10.3f}{p99:>10.3f}")
    slos = (slo or {}).get("slos", [])
    if slos:
        lines.append(
            f"{'slo':<28}{'value':>10}{'target':>10}{'burn f/s':>12}"
            f"{'status':>10}"
        )
        for s in slos:
            burn = f"{s['burn_rate_fast']:.1f}/{s['burn_rate_slow']:.1f}"
            lines.append(
                f"  {s['name']:<26}{s['value']:>10.3g}"
                f"{s['op'] + str(s['target']):>10}"
                f"{burn:>12}{s['status']:>10}"
            )
    if events:
        lines.append("events:")
        for e in events:
            lines.append(f"  {e}")
    return "\n".join(lines)


class _EventTail:
    """Background NDJSON tail of the SLO/Health topics; keeps the last
    few transitions for the dashboard footer."""

    def __init__(self, address: str, token: str = "", keep: int = 6):
        self.lines: deque = deque(maxlen=keep)
        self._address = address.rstrip("/")
        self._token = token
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="top-event-tail", daemon=True
        )

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()

    def _run(self) -> None:
        url = (
            f"{self._address}/v1/event/stream?topic=SLO:*&topic=Health:*"
        )
        if self._token:
            url += f"&token={self._token}"
        while not self._stop.is_set():
            try:
                with urllib.request.urlopen(url, timeout=30) as resp:
                    for raw in resp:
                        if self._stop.is_set():
                            return
                        try:
                            obj = json.loads(raw)
                        except ValueError:
                            continue
                        if not obj:
                            continue  # keepalive frame
                        stamp = time.strftime("%H:%M:%S")
                        self.lines.append(
                            f"{stamp} {obj.get('Topic')} {obj.get('Type')} "
                            f"{obj.get('Key')}"
                        )
            except Exception:
                if self._stop.wait(1.0):
                    return


def run_top(
    client,
    interval: float = 2.0,
    count: int = 0,
    clear: bool = True,
    out=None,
) -> int:
    """The refresh loop.  ``count`` > 0 renders that many frames then
    exits (scriptable/testable); 0 runs until interrupted."""
    import sys

    out = out or sys.stdout
    tail = _EventTail(client.address, token=getattr(client, "token", ""))
    tail.start()
    prev = None
    frames = 0
    try:
        while count <= 0 or frames < count:
            metrics = client.metrics()
            try:
                slo = client.slo()
            except Exception:
                slo = None
            try:
                health = client.health()
            except Exception:
                health = None
            try:
                overload = client.overload()
            except Exception:
                overload = None
            frame = render(
                metrics, slo, health,
                prev_metrics=prev, interval=interval,
                address=client.address, events=list(tail.lines),
                overload=overload,
            )
            if clear:
                out.write(CLEAR)
            out.write(frame + "\n")
            out.flush()
            prev = metrics
            frames += 1
            if count > 0 and frames >= count:
                break
            time.sleep(interval)
    except KeyboardInterrupt:
        pass
    finally:
        tail.stop()
    return 0
