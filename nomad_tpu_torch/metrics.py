"""Latency timers + counters (reference: armon/go-metrics usage —
``nomad.worker.invoke_scheduler`` worker.go:245, ``nomad.plan.evaluate`` /
``nomad.plan.apply`` plan_apply.go:185,370, surfaced at ``/v1/metrics``).

A ``Timer`` keeps cheap streaming aggregates (count/sum/min/max) plus a
bounded reservoir for percentiles — enough for the p99-latency SLO the
BASELINE tracks, without a dependency.

Counters take optional labels (``incr("nomad.kernel.launches",
path="solo")``), stored flat under ``name{k=v,...}`` keys so snapshots
stay JSON-plain. ``gauge_fn`` registers a callable polled at snapshot
time — how scattered object counters (matrix uploads, coalescer
dispatches) unify into the registry without double bookkeeping.
``to_prometheus`` renders any snapshot in the Prometheus text
exposition format for ``/v1/metrics?format=prometheus``.

``RollingWindow`` is the sliding-window primitive the SLO engine
(``nomad_tpu/obs/``) evaluates burn rates over: timestamped samples in a
bounded deque, with count/rate/percentile readable over any trailing
window.  ``Timer`` feeds one alongside its reservoir so windowed
percentiles (``windowed(60)["p99_ms"]``) are available without a second
observation on the hot path.
"""

from __future__ import annotations

import math
import re
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Callable, Dict, List, Optional, Tuple


class RollingWindow:
    """Timestamped samples in a bounded deque, aggregated over any
    trailing window.  The write path is one deque append under a lock;
    reads walk backwards from the newest sample and stop at the window
    edge, so cost scales with the window's population, not the buffer.

    Two uses: value samples (``observe`` latencies → ``percentile``)
    and level samples of a monotonic counter (``observe`` the counter →
    ``rate_of_change`` = Δvalue/Δt over the window, the Prometheus
    ``rate()`` shape the SLO evaluator applies to throughput counters).
    """

    def __init__(self, maxlen: int = 4096):
        self._lock = threading.Lock()
        self._samples: deque = deque(maxlen=maxlen)  # (ts, value)

    def observe(self, value: float, ts: Optional[float] = None) -> None:
        with self._lock:
            self._samples.append((ts if ts is not None else time.time(), value))

    def _window(
        self, window_s: float, now: Optional[float] = None
    ) -> List[Tuple[float, float]]:
        cutoff = (now if now is not None else time.time()) - window_s
        with self._lock:
            out = []
            for ts, v in reversed(self._samples):
                if ts < cutoff:
                    break
                out.append((ts, v))
        out.reverse()
        return out

    def count(self, window_s: float, now: Optional[float] = None) -> int:
        return len(self._window(window_s, now))

    def rate(self, window_s: float, now: Optional[float] = None) -> float:
        """Samples per second over the trailing window."""
        if window_s <= 0:
            return 0.0
        return len(self._window(window_s, now)) / window_s

    def rate_of_change(
        self, window_s: float, now: Optional[float] = None
    ) -> float:
        """Δvalue/Δt across the window — ``rate()`` over level samples
        of a monotonic counter.  0.0 until two samples span the window."""
        win = self._window(window_s, now)
        if len(win) < 2:
            return 0.0
        (t0, v0), (t1, v1) = win[0], win[-1]
        if t1 <= t0:
            return 0.0
        return (v1 - v0) / (t1 - t0)

    def percentile(
        self, window_s: float, q: float, now: Optional[float] = None
    ) -> float:
        vals = sorted(v for _, v in self._window(window_s, now))
        if not vals:
            return 0.0
        rank = math.ceil(q * len(vals))
        return vals[min(len(vals) - 1, max(0, rank - 1))]

    def values(
        self, window_s: float, now: Optional[float] = None
    ) -> List[float]:
        return [v for _, v in self._window(window_s, now)]


class Timer:
    def __init__(self, reservoir: int = 1024):
        self._lock = threading.Lock()
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = 0.0
        self._samples: deque = deque(maxlen=reservoir)
        # Timestamped twin of the reservoir: windowed percentiles for
        # the SLO engine without a second observe on the hot path.
        self.window = RollingWindow(maxlen=reservoir)

    def observe(self, seconds: float) -> None:
        now = time.time()
        with self._lock:
            self.count += 1
            self.sum += seconds
            if seconds < self.min:
                self.min = seconds
            if seconds > self.max:
                self.max = seconds
            self._samples.append(seconds)
        self.window.observe(seconds, ts=now)

    @contextmanager
    def time(self):
        t0 = time.time()
        try:
            yield
        finally:
            self.observe(time.time() - t0)

    def _percentile(self, sorted_samples: List[float], q: float) -> float:
        # Ceil-rank (nearest-rank) definition: the smallest sample with
        # at least q of the distribution at or below it. The old
        # ``int(q * n)`` floor under-reported p99 for small reservoirs
        # (p99 of 100 samples indexed [99] only by the clamp; p99 of 10
        # picked the 10th-largest's neighbor at n=1000 boundaries).
        if not sorted_samples:
            return 0.0
        rank = math.ceil(q * len(sorted_samples))
        idx = min(len(sorted_samples) - 1, max(0, rank - 1))
        return sorted_samples[idx]

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            samples = sorted(self._samples)
            count, total = self.count, self.sum
            mn = self.min if self.count else 0.0
            mx = self.max
        return {
            "count": count,
            "mean_ms": round(total / count * 1000.0, 3) if count else 0.0,
            "min_ms": round(mn * 1000.0, 3),
            "max_ms": round(mx * 1000.0, 3),
            "p50_ms": round(self._percentile(samples, 0.50) * 1000.0, 3),
            "p95_ms": round(self._percentile(samples, 0.95) * 1000.0, 3),
            "p99_ms": round(self._percentile(samples, 0.99) * 1000.0, 3),
        }

    def windowed(self, window_s: float) -> Dict[str, float]:
        """Percentiles over the trailing ``window_s`` seconds only —
        the sliding-window view the SLO burn-rate math evaluates (the
        plain reservoir never forgets a quiet period's samples)."""
        vals = sorted(self.window.values(window_s))
        n = len(vals)

        def pct(q: float) -> float:
            if not vals:
                return 0.0
            rank = math.ceil(q * n)
            return vals[min(n - 1, max(0, rank - 1))]

        return {
            "count": n,
            "mean_ms": round(sum(vals) / n * 1000.0, 3) if n else 0.0,
            "p50_ms": round(pct(0.50) * 1000.0, 3),
            "p95_ms": round(pct(0.95) * 1000.0, 3),
            "p99_ms": round(pct(0.99) * 1000.0, 3),
        }


def labeled(name: str, **labels) -> str:
    """Flatten ``name`` + labels into the canonical ``name{k=v,...}``
    snapshot key (labels sorted, so the key is stable)."""
    if not labels:
        return name
    inner = ",".join("%s=%s" % (k, labels[k]) for k in sorted(labels))
    return "%s{%s}" % (name, inner)


class MetricsRegistry:
    def __init__(self):
        self._lock = threading.Lock()
        self._timers: Dict[str, Timer] = {}
        self._counters: Dict[str, int] = {}
        self._gauges: Dict[str, Callable[[], float]] = {}

    def timer(self, name: str) -> Timer:
        with self._lock:
            t = self._timers.get(name)
            if t is None:
                t = Timer()
                self._timers[name] = t
            return t

    def incr(self, name: str, by: int = 1, **labels) -> None:
        key = labeled(name, **labels)
        with self._lock:
            self._counters[key] = self._counters.get(key, 0) + by

    def gauge_fn(self, name: str, fn: Callable[[], float], **labels) -> None:
        """Register a pull gauge: ``fn`` is polled at snapshot time.
        Lets object-owned counters (matrix.scatter_syncs, coalescer
        dispatch tallies) surface in the registry without a second
        write on every hot-path increment."""
        with self._lock:
            self._gauges[labeled(name, **labels)] = fn

    def snapshot(self) -> Dict:
        with self._lock:
            timers = dict(self._timers)
            counters = dict(self._counters)
            gauges = dict(self._gauges)
        out: Dict = {}
        for name, value in counters.items():
            out[name] = value
        for name, fn in gauges.items():
            try:
                out[name] = fn()
            except Exception:
                # A gauge over a torn-down object must not break /v1/metrics.
                out[name] = 0
        for name, t in timers.items():
            out[name] = t.snapshot()
        return out


# ----------------------------------------------------------------------
# Prometheus text exposition (https://prometheus.io/docs/instrumenting/exposition_formats/)

_PROM_BAD = re.compile(r"[^a-zA-Z0-9_:]")
# DOTALL: label values may legally contain newlines — the exposition
# layer escapes them, but the key regex must not refuse to parse them.
_LABELED = re.compile(r"^(?P<name>[^{]+)\{(?P<labels>.*)\}$", re.DOTALL)


def _prom_name(name: str) -> str:
    name = _PROM_BAD.sub("_", name)
    if name and name[0].isdigit():
        name = "_" + name
    return name


def _split_key(key: str) -> "tuple[str, Dict[str, str]]":
    """``name{k=v,...}`` snapshot key → (base name, label dict)."""
    m = _LABELED.match(key)
    if not m:
        return key, {}
    labels: Dict[str, str] = {}
    for part in m.group("labels").split(","):
        if "=" in part:
            k, v = part.split("=", 1)
            labels[k.strip()] = v.strip()
    return m.group("name"), labels


def _escape_label_value(value: str) -> str:
    """Escape a label value per the exposition-format spec: backslash,
    double-quote, and line-feed must be escaped inside the quotes
    (backslash first, or the other escapes get double-escaped)."""
    return (
        value.replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _prom_series(base: str, labels: Dict[str, str]) -> str:
    name = _prom_name(base)
    if not labels:
        return name
    inner = ",".join(
        '%s="%s"' % (_prom_name(k), _escape_label_value(str(labels[k])))
        for k in sorted(labels)
    )
    return "%s{%s}" % (name, inner)


def _help_text(base: str, kind: str) -> str:
    """One-line HELP: the registry's dotted metric name is the most
    useful thing to echo — it is the key to grep for in the code."""
    if kind == "summary":
        return "latency summary of registry timer %s (milliseconds)" % base
    return "registry metric %s" % base


def to_prometheus(snapshot: Dict) -> str:
    """Render a flat snapshot (counters/gauges as numbers, timers as
    their summary dicts) in the Prometheus text exposition format.
    Timer summaries become ``<name>_ms{quantile=..}`` series plus
    ``<name>_count`` / ``<name>_sum_ms``.  Every metric family gets
    ``# HELP`` and ``# TYPE`` header lines, emitted once per family
    (labeled series of the same base share one header block)."""
    lines: List[str] = []
    headered: set = set()

    def _header(stem: str, base: str, kind: str) -> None:
        if stem in headered:
            return
        headered.add(stem)
        lines.append("# HELP %s %s" % (stem, _help_text(base, kind)))
        lines.append("# TYPE %s %s" % (stem, kind))

    for key in sorted(snapshot):
        value = snapshot[key]
        base, labels = _split_key(key)
        if isinstance(value, dict):
            stem = _prom_name(base) + "_ms"
            _header(stem, base, "summary")
            for q, field in (("0.5", "p50_ms"), ("0.95", "p95_ms"), ("0.99", "p99_ms")):
                ql = dict(labels)
                ql["quantile"] = q
                lines.append(
                    "%s %s" % (_prom_series(base + "_ms", ql), value.get(field, 0.0))
                )
            lines.append(
                "%s %s" % (_prom_series(base + "_count", labels), value.get("count", 0))
            )
            lines.append(
                "%s %s" % (
                    _prom_series(base + "_sum_ms", labels),
                    round(value.get("mean_ms", 0.0) * value.get("count", 0), 3),
                )
            )
        elif isinstance(value, bool):
            _header(_prom_name(base), base, "gauge")
            lines.append("%s %d" % (_prom_series(base, labels), int(value)))
        elif isinstance(value, (int, float)):
            _header(_prom_name(base), base, "gauge")
            lines.append("%s %s" % (_prom_series(base, labels), value))
        # non-numeric snapshot entries (strings) are skipped
    return "\n".join(lines) + "\n"

