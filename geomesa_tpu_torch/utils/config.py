"""Tiered configuration knobs.

Port of ``geomesa_tpu/utils/config.py`` limited to the knobs the port
reads. A knob resolves on every read from, in order: a programmatic
override (``set_property`` or the scoped ``properties(**kw)``), its
environment variable (the property name upper-cased with dots as
underscores, e.g. ``geomesa.batch.enabled`` -> ``GEOMESA_BATCH_ENABLED``),
then its default.
"""

from __future__ import annotations

import os
import re
import threading
from contextlib import contextmanager
from typing import Dict, Optional

_overrides: Dict[str, str] = {}
_lock = threading.Lock()


def set_property(name: str, value: Optional[str]) -> None:
    """Set (or clear, with None) a programmatic override, the top tier."""
    with _lock:
        if value is None:
            _overrides.pop(name, None)
        else:
            _overrides[name] = str(value)


@contextmanager
def properties(**kwargs):
    """Scoped overrides: ``properties(geomesa_batch_window_ms="100")``;
    underscores in keyword names map to dots. The earlier values come back
    on exit."""
    names = {k.replace("_", "."): v for k, v in kwargs.items()}
    with _lock:
        before = {n: _overrides.get(n) for n in names}
    for n, v in names.items():
        set_property(n, v)
    try:
        yield
    finally:
        for n, v in before.items():
            set_property(n, v)


_DURATION_RE = re.compile(r"^\s*(\d+(?:\.\d+)?)\s*([a-zA-Z]+)\s*$")
_DURATION_MS = {
    "ms": 1, "millis": 1, "millisecond": 1, "milliseconds": 1,
    "s": 1000, "second": 1000, "seconds": 1000,
    "m": 60_000, "min": 60_000, "minute": 60_000, "minutes": 60_000,
    "h": 3_600_000, "hour": 3_600_000, "hours": 3_600_000,
    "d": 86_400_000, "day": 86_400_000, "days": 86_400_000,
}
_BYTES = {"b": 1, "k": 1024, "kb": 1024, "m": 1024**2, "mb": 1024**2,
          "g": 1024**3, "gb": 1024**3, "t": 1024**4, "tb": 1024**4}


class SystemProperty:
    """One named knob (the reference's system-property analog)."""

    def __init__(self, name: str, default: Optional[str] = None):
        self.name = name
        self.default = default

    def get(self) -> Optional[str]:
        with _lock:
            if self.name in _overrides:
                return _overrides[self.name]
        env = os.environ.get(self.name.replace(".", "_").upper())
        return self.default if env is None else env

    def to_int(self) -> Optional[int]:
        v = self.get()
        try:
            return None if v is None else int(v)
        except ValueError:
            return None if self.default is None else int(self.default)

    def to_float(self) -> Optional[float]:
        v = self.get()
        try:
            return None if v is None else float(v)
        except ValueError:
            return None if self.default is None else float(self.default)

    def to_bool(self) -> Optional[bool]:
        v = self.get()
        return None if v is None else v.strip().lower() in ("true", "1", "yes")

    def to_duration_ms(self) -> Optional[int]:
        """'10 seconds' / '5m' / '100 ms' -> milliseconds; a bare number is
        ms. An unparsable value falls back to the default."""
        for v in (self.get(), self.default):
            if v is None:
                continue
            m = _DURATION_RE.match(str(v))
            if m and m.group(2).lower() in _DURATION_MS:
                return int(float(m.group(1)) * _DURATION_MS[m.group(2).lower()])
            try:
                return int(v)
            except ValueError:
                continue
        return None

    def to_duration_s(self, default_s: Optional[float] = None) -> Optional[float]:
        """``to_duration_ms`` in seconds; ``default_s`` when it is None."""
        ms = self.to_duration_ms()
        return default_s if ms is None else ms / 1000.0

    def to_bytes(self) -> Optional[int]:
        """'64MB' / '600KB' / '1024' -> bytes (binary units; a bare number
        is bytes). An unparsable value falls back to the default."""
        for v in (self.get(), self.default):
            if v is None:
                continue
            m = re.match(r"^\s*(\d+(?:\.\d+)?)\s*([a-zA-Z]*)\s*$", str(v))
            if m and (m.group(2) or "b").lower() in _BYTES:
                return int(float(m.group(1)) * _BYTES[(m.group(2) or "b").lower()])
        return None


# the scan-range budget (QueryProperties.scala:18 'geomesa.scan.ranges.target';
# the reference package defaults it to 512)
SCAN_RANGES_TARGET = SystemProperty("geomesa.scan.ranges.target", "512")
# the per-query budget, from admission to the last row (None: unbounded)
QUERY_TIMEOUT = SystemProperty("geomesa.query.timeout", None)
# admission control (utils/admission.py): at most max.inflight queries run
# at once per store, queue.depth more may wait (the wait charged against
# each query's own budget); beyond that a query sheds with ShedLoad
QUERY_MAX_INFLIGHT = SystemProperty("geomesa.query.max.inflight", "64")
QUERY_QUEUE_DEPTH = SystemProperty("geomesa.query.queue.depth", "256")
# in-flight slots held back from every class but critical (0 disables)
ADMISSION_CRITICAL_RESERVE = SystemProperty("geomesa.admission.critical.reserve", "1")
# the class of a query whose hints name none
PRIORITY_DEFAULT = SystemProperty("geomesa.priority.default", "interactive")
# the cross-query coalescer (parallel/batch.py): queries of one feature
# type in flight together gather for window.ms (at most max.queries) and
# ride one stacked sweep per segment; enabled=false is the escape hatch
BATCH_ENABLED = SystemProperty("geomesa.batch.enabled", "true")
BATCH_WINDOW_MS = SystemProperty("geomesa.batch.window.ms", "2")
BATCH_MAX_QUERIES = SystemProperty("geomesa.batch.max.queries", "32")
# the aggregate pyramid cache (ops/pyramid.py): counts and per-column
# sum/min/max/count answered from interior partial sums plus the exact
# boundary ring, and a density-grid memo. `cell.bits` sets the finest
# level (2^bits x 2^bits cells over the world), `levels` the coarser
# halvings above it the polygon descent walks; entries expire `cache.ttl`
# after their last use and the cache holds at most `cache.bytes` (LRU
# past it); enabled=false is the escape hatch
AGG_ENABLED = SystemProperty("geomesa.agg.enabled", "true")
AGG_LEVELS = SystemProperty("geomesa.agg.levels", "3")
AGG_CELL_BITS = SystemProperty("geomesa.agg.cell.bits", "8")
AGG_CACHE_TTL = SystemProperty("geomesa.agg.cache.ttl", "10 minutes")
AGG_CACHE_BYTES = SystemProperty("geomesa.agg.cache.bytes", "64MB")
# the device circuit breaker (utils/breaker.py): trip open after `failures`
# device failures inside `window`, short-circuit to the host for
# `cooldown`, then let one probe query through; read when a breaker is made
BREAKER_FAILURES = SystemProperty("geomesa.breaker.failures", "5")
BREAKER_WINDOW = SystemProperty("geomesa.breaker.window", "30 seconds")
BREAKER_COOLDOWN = SystemProperty("geomesa.breaker.cooldown", "5 seconds")
# the store-wide retention window of dated types (age-off: rows whose date
# is older than now minus this are masked at scan, and ``age_off()``
# tombstones them); a type's own `geomesa.feature.expiry` user data wins
FEATURE_EXPIRY = SystemProperty("geomesa.feature.expiry", None)
# the slow-query log: a query slower than `threshold` (a duration; unset:
# no log) logs its span tree and its plan, at most `max.per.min` full
# renders a minute (the rest file a summary in the tail only)
SLOW_QUERY_THRESHOLD = SystemProperty("geomesa.query.slow.threshold", None)
SLOW_QUERY_MAX_PER_MIN = SystemProperty("geomesa.query.slow.max.per.min", "60")
# the flight-recorder timeline (utils/timeline.py): one tick of counter,
# gauge and timer deltas a `interval` into a ring covering `window`;
# enabled=false starts no sampler
TIMELINE_ENABLED = SystemProperty("geomesa.timeline.enabled", "true")
TIMELINE_INTERVAL = SystemProperty("geomesa.timeline.interval", "1 second")
TIMELINE_WINDOW = SystemProperty("geomesa.timeline.window", "1 hour")
# per-tenant metering (utils/tenants.py): the `tenant` query hint (absent:
# "anon") folds every query into a top-`max` LRU of per-tenant aggregates;
# `priority` maps tenants to default priority classes,
# "tenantA=critical,tenantB=background"
TENANTS_ENABLED = SystemProperty("geomesa.tenants.enabled", "true")
TENANTS_MAX = SystemProperty("geomesa.tenants.max", "64")
TENANTS_PRIORITY = SystemProperty("geomesa.tenants.priority", None)
# the SLO engine (utils/slo.py): availability and latency objectives per
# query class, burned over a fast and a slow window of the timeline; a
# class violates when both windows burn past their thresholds and the fast
# one saw at least `min.events`; `exemplars` keeps (value, trace id) pairs
# per latency bucket while a sampler runs
SLO_ENABLED = SystemProperty("geomesa.slo.enabled", "true")
SLO_EXEMPLARS = SystemProperty("geomesa.slo.exemplars", "true")
SLO_WINDOW_FAST = SystemProperty("geomesa.slo.window.fast", "5 minutes")
SLO_WINDOW_SLOW = SystemProperty("geomesa.slo.window.slow", "1 hour")
SLO_BURN_FAST = SystemProperty("geomesa.slo.burn.fast", "14.4")
SLO_BURN_SLOW = SystemProperty("geomesa.slo.burn.slow", "1.0")
SLO_MIN_EVENTS = SystemProperty("geomesa.slo.min.events", "100")
SLO_AVAILABILITY = SystemProperty("geomesa.slo.availability", "0.999")
SLO_LATENCY_OBJECTIVE = SystemProperty("geomesa.slo.latency.objective", "0.99")
SLO_QUERY_LATENCY_MS = SystemProperty("geomesa.slo.query.latency.ms", "250")
SLO_JOIN_LATENCY_MS = SystemProperty("geomesa.slo.join.latency.ms", "1000")
SLO_AGGREGATE_LATENCY_MS = SystemProperty("geomesa.slo.aggregate.latency.ms", "250")
SLO_STREAM_FIRST_LATENCY_MS = SystemProperty("geomesa.slo.stream.first.latency.ms", "250")
# plan telemetry (utils/plans.py): per-fingerprint aggregates of every
# query, a top-`max` LRU; enabled=false leaves one flag read a query
PLANS_ENABLED = SystemProperty("geomesa.plans.enabled", "true")
PLANS_MAX = SystemProperty("geomesa.plans.max", "256")
# the brownout ladder (utils/brownout.py): each timeline tick folds SLO
# burn, the admission queue's fill (`queue.ratio.1`-`.3` enter levels 1-3)
# and open breakers into a level, stepping one rung after `enter.ticks`
# ticks over it or `exit.ticks` ticks under it; level 1 sheds background,
# 2 batch and cold pyramid builds, 3 lets only critical queue;
# `retry.after.s` floors a shed's Retry-After
BROWNOUT_ENABLED = SystemProperty("geomesa.brownout.enabled", "true")
BROWNOUT_ENTER_TICKS = SystemProperty("geomesa.brownout.enter.ticks", "2")
BROWNOUT_EXIT_TICKS = SystemProperty("geomesa.brownout.exit.ticks", "3")
BROWNOUT_QUEUE_RATIO_1 = SystemProperty("geomesa.brownout.queue.ratio.1", "0.5")
BROWNOUT_QUEUE_RATIO_2 = SystemProperty("geomesa.brownout.queue.ratio.2", "0.75")
BROWNOUT_QUEUE_RATIO_3 = SystemProperty("geomesa.brownout.queue.ratio.3", "0.95")
BROWNOUT_RETRY_AFTER_S = SystemProperty("geomesa.brownout.retry.after.s", "1")
