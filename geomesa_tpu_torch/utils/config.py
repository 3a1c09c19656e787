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
