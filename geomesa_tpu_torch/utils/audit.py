"""Query audit events, metrics registries, reporters and reason-coded
decisions.

Port of ``geomesa_tpu/utils/audit.py``: ``QueryEvent`` and its writers
(``InMemoryAuditWriter``, ``LoggingAuditWriter``), ``MetricsRegistry``
(counters, gauges, timers with trace-linked exemplars), the scheduled
reporters (console, logging, delimited file, a Prometheus text file),
``prometheus_text``, the process-wide ``robustness_metrics()``,
``decision`` (a span event, a counter and a tally on the query's plan
fingerprint), the slow-query tail and the serving errors. The Graphite and
Ganglia reporters (they take the reference's retry policy) and the
fleet's exemplar text are not in the port.
"""

from __future__ import annotations

import logging
import math
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple


@dataclass
class QueryEvent:
    """One audited query: who, what, how long, how many hits, which route
    answered (``scan_path``), the trace it produced (``trace_id``, "" when
    untraced), its device receipt and how it ended (``outcome``: "ok",
    "timeout" or "shed")."""

    store: str
    type_name: str
    user: str
    filter: str
    hints: Dict[str, Any]
    date_ms: int
    planning_ms: float
    scanning_ms: float
    hits: int
    scan_path: str = ""
    trace_id: str = ""
    recompiles: int = 0
    h2d_bytes: int = 0
    d2h_bytes: int = 0
    pad_ratio: float = 0.0
    outcome: str = "ok"


class AuditWriter:
    def write_event(self, event: QueryEvent) -> None:
        raise NotImplementedError


class InMemoryAuditWriter(AuditWriter):
    """A bounded ring of recent events."""

    def __init__(self, capacity: int = 10_000):
        self.capacity = capacity
        self.events: List[QueryEvent] = []
        self._lock = threading.Lock()

    def write_event(self, event: QueryEvent) -> None:
        with self._lock:
            self.events.append(event)
            if len(self.events) > self.capacity:
                del self.events[: len(self.events) - self.capacity]


class LoggingAuditWriter(AuditWriter):
    def __init__(self, logger: Optional[logging.Logger] = None):
        self.logger = logger or logging.getLogger("geomesa_tpu_torch.audit")

    def write_event(self, event: QueryEvent) -> None:
        self.logger.info("query type=%s user=%s filter=%r plan=%.1fms scan=%.1fms hits=%d",
                         event.type_name, event.user, event.filter, event.planning_ms,
                         event.scanning_ms, event.hits)


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


# -- timer exemplars ----------------------------------------------------------
#
# While a timeline sampler runs (utils/timeline.py), timers also keep
# exemplars: (seconds, trace_id, wall_ms) a power-of-two latency bucket and
# a short recent ring, so a p99 links to a retained trace. Off, the hook in
# ``update_timer`` is one module-global read.

_EXEMPLARS = False
_EXEMPLAR_RECENT = 32  # the recent ring of a timer
# bucket i covers [2^i, 2^(i+1)) milliseconds, clamped to this range
_EXEMPLAR_BUCKET_MIN = -4  # 62.5 us
_EXEMPLAR_BUCKET_MAX = 17  # ~131 s


def set_exemplars(on: bool) -> None:
    """Flip the process-wide exemplar hook (the timeline's samplers manage
    it; tests flip it directly)."""
    global _EXEMPLARS
    _EXEMPLARS = bool(on)


def exemplars_enabled() -> bool:
    return _EXEMPLARS


def exemplar_bucket(seconds: float) -> int:
    """floor(log2(milliseconds)), clamped: the one latency-bucket rule of
    the exemplars and the timeline's per-tick histograms."""
    ms = seconds * 1000.0
    if ms <= 0.0:
        return _EXEMPLAR_BUCKET_MIN
    b = math.frexp(ms)[1] - 1  # 2**b <= ms < 2**(b+1)
    return max(_EXEMPLAR_BUCKET_MIN, min(_EXEMPLAR_BUCKET_MAX, b))


class MetricsRegistry:
    """Counters, gauges (set values or zero-argument callables sampled at
    snapshot time) and timers (a bounded reservoir, cumulative totals and,
    while the exemplar hook is up, exemplars), every update under one
    lock."""

    _RESERVOIR = 4096

    def __init__(self):
        self._counters: Dict[str, int] = {}
        self._timers: Dict[str, List[float]] = {}
        self._timer_totals: Dict[str, List[float]] = {}
        self._gauges: Dict[str, float] = {}
        self._gauge_fns: Dict[str, Any] = {}
        self._exemplars: Dict[str, Dict[str, Any]] = {}
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
        ex: Optional[Tuple[float, str, float]] = None
        if _EXEMPLARS:
            from geomesa_tpu_torch.utils import trace

            ex = (float(seconds), trace.current_trace_id() or "", time.time() * 1000.0)
        with self._lock:
            vals = self._timers.setdefault(name, [])
            vals.append(seconds)
            if len(vals) > self._RESERVOIR:
                del vals[: len(vals) - self._RESERVOIR]
            tot = self._timer_totals.setdefault(name, [0, 0.0])
            tot[0] += 1
            tot[1] += seconds
            if ex is not None:
                slot = self._exemplars.get(name)
                if slot is None:
                    slot = self._exemplars[name] = {
                        "buckets": {}, "recent": deque(maxlen=_EXEMPLAR_RECENT)}
                slot["buckets"][exemplar_bucket(seconds)] = ex
                slot["recent"].append(ex)

    def exemplars(self, name: Optional[str] = None) -> Dict[str, Any]:
        """A copy of the exemplars: ``{timer: {"buckets": {bucket: (seconds,
        trace_id, wall_ms)}, "recent": [...]}}``, or one timer's slot (``{}``
        when it has none)."""
        with self._lock:
            items = ([(name, self._exemplars.get(name))] if name is not None
                     else list(self._exemplars.items()))
            out = {n: {"buckets": dict(slot["buckets"]), "recent": list(slot["recent"])}
                   for n, slot in items if slot is not None}
        return out.get(name, {}) if name is not None else out

    def drop_timer(self, name: str) -> None:
        """Remove one timer's reservoir, totals and exemplars (how the plan
        and tenant registries keep their timers bounded by their LRU)."""
        with self._lock:
            self._timers.pop(name, None)
            self._timer_totals.pop(name, None)
            self._exemplars.pop(name, None)

    def timer(self, name: str):
        """A context manager that times its body into ``name``."""
        registry = self

        class _Ctx:
            def __enter__(self):
                self.t0 = time.perf_counter()
                return self

            def __exit__(self, *exc):
                registry.update_timer(name, time.perf_counter() - self.t0)

        return _Ctx()

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
        shed.brownout              queries the brownout ladder refused
        shed.priority.<class>      sheds by priority class
        brownout.level.<n>         brownout transitions into level n
        slowlog.dropped            slow-query renders the storm guard shed
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
    (``reason`` and ``attrs``) on the current span, a
    ``decision.<point>.<reason>`` counter in ``robustness_metrics()`` and a
    tally on the current query's plan fingerprint (``utils/plans.py``; one
    context-variable read when plan telemetry is off). ``reason`` is a
    stable code (``lone_member``), never a message."""
    robustness_metrics().inc(f"decision.{point}.{reason}")
    from geomesa_tpu_torch.utils import plans, trace

    trace.event(f"decision.{point}", reason=reason, **attrs)
    plans.note(point, reason)


# -- reporters ----------------------------------------------------------------


def _flatten(snapshot):
    """[(dotted name, value)]: timer dicts become 'name.leaf' rows, sorted."""
    out = []
    for name, val in sorted(snapshot.items()):
        if isinstance(val, dict):
            out.extend((f"{name}.{k}", v) for k, v in sorted(val.items()))
        else:
            out.append((name, val))
    return out


class Reporter:
    """Scheduled metrics publication: ``start()`` emits a registry report
    every ``interval_s`` on a daemon timer, ``report_now()`` at once. An
    emit that raises is logged and the schedule goes on."""

    def __init__(self, registry: MetricsRegistry, interval_s: float = 60.0):
        self.registry = registry
        self.interval_s = interval_s
        self._timer: Any = None
        self._stopped = False

    def emit(self, snapshot: Dict[str, Any]) -> None:
        raise NotImplementedError

    def report_now(self) -> None:
        self.emit(self.registry.report())

    def start(self) -> "Reporter":
        self._stopped = False

        def tick():
            if self._stopped:
                return
            try:
                self.report_now()
            except Exception:  # noqa: BLE001 - one bad emit must not end the loop
                logging.getLogger("geomesa_tpu_torch.audit").exception(
                    "%s emit failed; reporting continues", type(self).__name__)
            schedule()

        def schedule():
            if self._stopped:
                return
            t = threading.Timer(self.interval_s, tick)
            t.daemon = True
            t.start()
            self._timer = t

        schedule()
        return self

    def stop(self) -> None:
        self._stopped = True
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None


class ConsoleReporter(Reporter):
    """The report as indented JSON to a stream (stderr by default)."""

    def __init__(self, registry, interval_s: float = 60.0, stream=None):
        super().__init__(registry, interval_s)
        import sys

        self.stream = stream or sys.stderr

    def emit(self, snapshot):
        import json

        self.stream.write(f"-- metrics {time.strftime('%Y-%m-%dT%H:%M:%SZ', time.gmtime())} --\n")
        self.stream.write(json.dumps(snapshot, indent=1, default=str) + "\n")
        self.stream.flush()


class LoggingReporter(Reporter):
    """The report through the logging module."""

    def __init__(self, registry, interval_s: float = 60.0, logger_name: str = "geomesa.metrics"):
        super().__init__(registry, interval_s)
        self.logger = logging.getLogger(logger_name)

    def emit(self, snapshot):
        self.logger.info("metrics %s", snapshot)


class DelimitedFileReporter(Reporter):
    """Appends one tab-separated ``<epoch ms> <name> <value>`` row a metric."""

    def __init__(self, registry, path: str, interval_s: float = 60.0):
        super().__init__(registry, interval_s)
        self.path = path

    def emit(self, snapshot):
        now = int(time.time() * 1000)
        with open(self.path, "a") as fh:
            for name, v in _flatten(snapshot):
                fh.write(f"{now}\t{name}\t{v}\n")


def _prom_name(name: str, prefix: str = "geomesa") -> str:
    """A metric name as a Prometheus name: anything outside [a-zA-Z0-9_:]
    becomes ``_``."""
    import re

    base = re.sub(r"[^a-zA-Z0-9_:]", "_", name)
    return f"{prefix}_{base}" if prefix else base


def prometheus_text(registries, prefix: str = "geomesa") -> str:
    """The text exposition (version 0.0.4) of one or more registries:
    counters, gauges, and timers as summaries (quantiles in seconds from
    the reservoir, ``_sum`` / ``_count`` from the cumulative totals, a
    ``_max`` gauge, and the worst exemplar as a ``# exemplar:`` comment).
    A later registry wins a name collision."""
    if isinstance(registries, MetricsRegistry):
        registries = [registries]
    counters: Dict[str, float] = {}
    gauges: Dict[str, float] = {}
    timers: Dict[str, List[float]] = {}
    totals: Dict[str, tuple] = {}
    exemplars: Dict[str, Dict[str, Any]] = {}
    for reg in registries:
        c, g, t, tt = reg.snapshot()
        counters.update(c)
        gauges.update(g)
        timers.update({k: v for k, v in t.items() if v})
        totals.update(tt)
        exemplars.update(reg.exemplars())
    lines: List[str] = []
    for name, v in sorted(counters.items()):
        p = _prom_name(name, prefix)
        lines.append(f"# TYPE {p} counter")
        lines.append(f"{p} {float(v):g}")
    for name, v in sorted(gauges.items()):
        p = _prom_name(name, prefix)
        lines.append(f"# TYPE {p} gauge")
        lines.append(f"{p} {float(v):g}")
    for name, vals in sorted(timers.items()):
        p = _prom_name(name, prefix)
        h = histogram_summary(vals)
        cum_count, cum_sum = totals.get(name, (h["count"], sum(vals)))
        lines.append(f"# TYPE {p} summary")
        slot = exemplars.get(name)
        if slot and slot["buckets"]:
            s, tid, ts = slot["buckets"][max(slot["buckets"])]
            if tid:
                lines.append(f'# exemplar: {p}{{quantile="0.99"}} '
                             f'trace_id="{tid}" value={s:g} ts={ts / 1000.0:.3f}')
        for label, key in (("0.5", "p50_ms"), ("0.9", "p90_ms"), ("0.95", "p95_ms"),
                           ("0.99", "p99_ms")):
            lines.append(f'{p}{{quantile="{label}"}} {h[key] / 1000:g}')
        lines.append(f"{p}_sum {cum_sum:g}")
        lines.append(f"{p}_count {cum_count}")
        lines.append(f"# TYPE {p}_max gauge")
        lines.append(f"{p}_max {h['max_ms'] / 1000:g}")
    return "\n".join(lines) + "\n"


class PrometheusReporter(Reporter):
    """Writes the text exposition to ``path`` (atomically) every interval;
    ``extra_registries`` (``robustness_metrics()`` by default) merge into
    it."""

    def __init__(self, registry, path: str, interval_s: float = 60.0, prefix: str = "geomesa",
                 extra_registries=None):
        super().__init__(registry, interval_s)
        self.path = path
        self.prefix = prefix
        self.extra_registries = (list(extra_registries) if extra_registries is not None
                                 else [robustness_metrics()])

    def render(self) -> str:
        return prometheus_text([self.registry] + self.extra_registries, prefix=self.prefix)

    def report_now(self) -> None:
        self.emit(None)  # render() snapshots the registries itself

    def emit(self, snapshot):
        import os

        text = self.render()
        tmp = self.path + ".tmp"
        with open(tmp, "w") as fh:
            fh.write(text)
        os.replace(tmp, self.path)


# -- the slow-query log's tail and storm guard ---------------------------------
#
# Every slow query files a summary in a bounded tail; the full render (span
# tree and plan) is limited to ``geomesa.query.slow.max.per.min`` a minute,
# the rest counted under ``slowlog.dropped``.

_SLOWLOG_TAIL = 256
_SLOWLOG: deque = deque(maxlen=_SLOWLOG_TAIL)
_SLOWLOG_EMITS: deque = deque()  # monotonic stamps of full renders
_SLOWLOG_LOCK = threading.Lock()


def slow_query_note(entry: Dict[str, Any]) -> bool:
    """File one slow query in the tail; True when the caller may render it
    in full (inside this minute's budget), False when the storm guard shed
    the render (the summary kept, flagged ``dropped``)."""
    from geomesa_tpu_torch.utils.config import SLOW_QUERY_MAX_PER_MIN

    limit = SLOW_QUERY_MAX_PER_MIN.to_int()
    limit = 60 if limit is None else limit
    now = time.monotonic()
    entry = dict(entry)
    entry.setdefault("date_ms", int(time.time() * 1000))
    with _SLOWLOG_LOCK:
        cutoff = now - 60.0
        while _SLOWLOG_EMITS and _SLOWLOG_EMITS[0] < cutoff:
            _SLOWLOG_EMITS.popleft()
        allowed = len(_SLOWLOG_EMITS) < limit
        if allowed:
            _SLOWLOG_EMITS.append(now)
        else:
            entry["dropped"] = True
        _SLOWLOG.append(entry)
    if not allowed:
        robustness_metrics().inc("slowlog.dropped")
    return allowed


def slow_query_tail(n: int = 50) -> List[Dict[str, Any]]:
    """The last ``n`` slow-query summaries, oldest first."""
    if n <= 0:
        return []
    with _SLOWLOG_LOCK:
        return list(_SLOWLOG)[-n:]


class QueryTimeout(RuntimeError):
    """A query exceeded its budget (``utils/deadline.py``) or was
    cancelled. A timed-out query fails crisply: it never returns a
    truncated result set."""


class ShedLoad(RuntimeError):
    """Admission control refused a query outright: every in-flight slot
    is taken and the bounded wait queue is full (``utils/admission.py``),
    or the brownout ladder sheds the query's class (``utils/brownout.py``).
    ``retry_after_s`` is a caller's backoff hint (None: the default)."""

    retry_after_s: Optional[float] = None
