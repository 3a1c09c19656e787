"""Metrics registries, the serving errors and reason-coded decisions.

Port of ``geomesa_tpu/utils/audit.py`` trimmed to what the serving path
uses: ``QueryTimeout`` and ``ShedLoad``, ``MetricsRegistry`` (counters,
gauges, timers, ``snapshot``, ``report``), ``histogram_summary``, the
process-wide ``robustness_metrics()`` and ``decision``. The audit events
and writers, the reporters, timer exemplars and the plan-telemetry half
of ``decision`` are not in the port.
"""

from __future__ import annotations

import logging
import threading
from typing import Any, Dict, List, Optional


class QueryTimeout(RuntimeError):
    """A query exceeded its budget (``utils/deadline.py``) or was
    cancelled. A timed-out query fails crisply: it never returns a
    truncated result set."""


class ShedLoad(RuntimeError):
    """Admission control refused a query outright: every in-flight slot
    is taken and the bounded wait queue is full (``utils/admission.py``).
    ``retry_after_s`` is a caller's backoff hint (None: the default)."""

    retry_after_s: Optional[float] = None


def histogram_summary(vals: List[float], total_count: Optional[int] = None) -> Dict[str, Any]:
    """Nearest-rank percentile summary of timer samples (seconds) -> ms
    leaves; ``total_count`` is the cumulative update count when ``vals`` is
    a sliding reservoir."""
    arr = sorted(vals)
    n = len(arr)

    def q(p: float) -> float:
        return arr[min(n - 1, int(p * n))]

    return {
        "count": n if total_count is None else total_count,
        "mean_ms": 1000 * sum(arr) / n,
        "p50_ms": 1000 * q(0.50),
        "p90_ms": 1000 * q(0.90),
        "p95_ms": 1000 * q(0.95),
        "p99_ms": 1000 * q(0.99),
        "max_ms": 1000 * arr[-1],
    }


class MetricsRegistry:
    """Counters, gauges (set values or zero-argument callables sampled at
    snapshot time) and timers (a bounded reservoir plus cumulative totals),
    every update under one lock."""

    _RESERVOIR = 4096

    def __init__(self):
        self._counters: Dict[str, int] = {}
        self._timers: Dict[str, List[float]] = {}
        self._timer_totals: Dict[str, List[float]] = {}
        self._gauges: Dict[str, float] = {}
        self._gauge_fns: Dict[str, Any] = {}
        self._lock = threading.Lock()

    def inc(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def set_gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = value

    def gauge_fn(self, name: str, fn) -> None:
        with self._lock:
            self._gauge_fns[name] = fn

    def counter(self, name: str, default: int = 0) -> int:
        with self._lock:
            return int(self._counters.get(name, default))

    def gauge(self, name: str, default: float = 0.0) -> float:
        """One SET gauge's value (callables are sampled by ``snapshot``)."""
        with self._lock:
            return float(self._gauges.get(name, default))

    def update_timer(self, name: str, seconds: float) -> None:
        with self._lock:
            vals = self._timers.setdefault(name, [])
            vals.append(seconds)
            if len(vals) > self._RESERVOIR:
                del vals[: len(vals) - self._RESERVOIR]
            tot = self._timer_totals.setdefault(name, [0, 0.0])
            tot[0] += 1
            tot[1] += seconds

    def snapshot(self):
        """(counters, gauges, {timer: samples}, {timer: (count, sum_s)}),
        copied under the lock; gauge callables are sampled outside it and a
        failing one is skipped."""
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            gauge_fns = list(self._gauge_fns.items())
            timers = {name: list(vals) for name, vals in self._timers.items()}
            totals = {name: (int(c), float(s)) for name, (c, s) in self._timer_totals.items()}
        for name, fn in gauge_fns:
            try:
                gauges[name] = float(fn())
            except Exception:  # noqa: BLE001 - telemetry must not raise
                logging.getLogger("geomesa_tpu_torch.audit").exception("gauge %r failed", name)
        return counters, gauges, timers, totals

    def report(self) -> Dict[str, Any]:
        counters, gauges, timers, totals = self.snapshot()
        out: Dict[str, Any] = counters
        out.update(gauges)
        for name, vals in timers.items():
            if vals:
                out[name] = histogram_summary(vals, total_count=totals.get(name, (None,))[0])
        return out


_ROBUSTNESS: Optional[MetricsRegistry] = None
_ROBUSTNESS_LOCK = threading.Lock()


def robustness_metrics() -> MetricsRegistry:
    """Process-wide counters of the fault and degrade layer:

        fault.<point>.<kind>       injected faults fired (utils/faults.py)
        deadline.exceeded          query budgets exhausted (utils/deadline.py)
        deadline.cancelled         checks that met a cancelled budget
        shed.overflow              queries refused outright (queue full)
        shed.queue_timeout         queries whose budget died in the queue
        shed.priority.<class>      sheds by priority class
        degrade.coalesce_to_solo   coalesced groups run solo after a seam fault
        degrade.device_to_host     device calls that failed and degraded to
                                   the host table scan (``executor.degrade``)
        degrade.mirror_rebuilds    device mirrors evicted by those degrades
        degrade.agg_to_scan        pyramid builds degraded to the uncached scan
        breaker.<name>.*           circuit transitions and short circuits
                                   (``utils/breaker.py``)
        decision.<point>.<reason>  reason-coded declines (``decision``)
    """
    global _ROBUSTNESS
    with _ROBUSTNESS_LOCK:
        if _ROBUSTNESS is None:
            _ROBUSTNESS = MetricsRegistry()
        return _ROBUSTNESS


def decision(point: str, reason: str, **attrs: Any) -> None:
    """One reason-coded decline or degrade: a ``decision.<point>`` event
    (``reason`` and ``attrs``) on the current span and a
    ``decision.<point>.<reason>`` counter in ``robustness_metrics()``.
    ``reason`` is a stable code (``lone_member``), never a message."""
    robustness_metrics().inc(f"decision.{point}.{reason}")
    from geomesa_tpu_torch.utils import trace

    trace.event(f"decision.{point}", reason=reason, **attrs)
