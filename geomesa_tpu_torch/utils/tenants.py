"""Per-tenant cost metering.

Port of ``geomesa_tpu/utils/tenants.py``. A tenant label travels with the
query (the ``tenant`` hint; absent: ``"anon"``) and every served query,
``query_many`` member and aggregate folds into a fixed-memory top-K LRU of
per-tenant aggregates, the ``utils/plans.py`` registry applied to the who
axis: calls and outcomes (and the ``bad`` total a per-tenant SLO burn
folds), a latency timer, rows returned, receipt sums and per-class splits.
``geomesa.tenants.priority`` maps tenants to a default priority class
(``utils/admission.py`` ``classify``).

``geomesa.tenants.enabled=false`` leaves one cached flag read on the query
path. ``max`` bounds the tenants a registry keeps; past it the coldest is
evicted (counted, its timer dropped). The durable spool's
``history_rows`` is not in the port.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

from geomesa_tpu_torch.utils.audit import MetricsRegistry, histogram_summary

# the default label: queries that carry no tenant hint/header still
# meter (conservation — per-tenant sums must equal store-level counts)
ANON = "anon"
# labels are operator-facing identifiers, not payloads: bound them so a
# hostile header cannot bloat registries, metric names, or SLO verdicts
MAX_LABEL = 64

# -- the flag -----------------------------------------------------------------

_ENABLED: Optional[bool] = None


def enabled() -> bool:
    """The hot-path gate: one module-global read once resolved."""
    e = _ENABLED
    if e is None:
        return _resolve()
    return e


def _resolve() -> bool:
    global _ENABLED
    from geomesa_tpu_torch.utils.config import TENANTS_ENABLED

    _ENABLED = bool(TENANTS_ENABLED.to_bool())
    return _ENABLED


def set_enabled(on: Optional[bool]) -> None:
    """Flip the cached flag (``None`` re-resolves on the next read)."""
    global _ENABLED
    _ENABLED = None if on is None else bool(on)


def tenants_knobs() -> Tuple[bool, int]:
    """(enabled, max_tenants) from the geomesa.tenants.* tier."""
    from geomesa_tpu_torch.utils.config import TENANTS_MAX

    cap = TENANTS_MAX.to_int()
    return enabled(), 64 if cap is None or cap <= 0 else cap


def tenant_of(query: Any) -> str:
    """The query's tenant label: the ``tenant`` hint, cleaned and
    bounded, else ``"anon"``. Accepts any duck-typed query (or None)."""
    hints = getattr(query, "hints", None)
    label = hints.get("tenant") if isinstance(hints, dict) else None
    return clean_label(label)


def clean_label(label: Any) -> str:
    """Normalize one externally-supplied label: non-string / blank /
    whitespace-only fall to ``"anon"``; the rest strip + truncate."""
    if not isinstance(label, str):
        return ANON
    label = label.strip()
    if not label:
        return ANON
    return label[:MAX_LABEL]


# -- per-tenant default priority ----------------------------------------------
#
# The middle rung of the priority ladder (utils/admission.py classify):
# an explicit `geomesa.query.priority` hint wins, then the query's
# tenant looks up here, then `geomesa.priority.default`. The map knob is
# "tenantA=critical,tenantB=background" — parsed once and cached (the
# flag posture above), so the per-admit lookup is one dict get.

_PRIORITY_MAP: Optional[Dict[str, str]] = None


def default_priority(tenant: str) -> Optional[str]:
    """The tenant's configured default priority class, or None when the
    map has no entry (the caller falls through to the global default)."""
    m = _PRIORITY_MAP
    if m is None:
        m = _resolve_priority_map()
    return m.get(tenant)


def _resolve_priority_map() -> Dict[str, str]:
    global _PRIORITY_MAP
    from geomesa_tpu_torch.utils.config import TENANTS_PRIORITY

    raw = TENANTS_PRIORITY.get()
    out: Dict[str, str] = {}
    if raw:
        from geomesa_tpu_torch.utils.admission import PRIORITIES

        for pair in str(raw).split(","):
            label, _, cls = pair.partition("=")
            label = clean_label(label)
            cls = cls.strip().lower()
            if label != ANON and cls in PRIORITIES:
                out[label] = cls
    _PRIORITY_MAP = out
    return out


def reset_priority_map() -> None:
    """Drop the cached map (re-parsed on the next lookup) — for tests
    and config reloads that flip ``geomesa.tenants.priority``."""
    global _PRIORITY_MAP
    _PRIORITY_MAP = None


# -- the registry -------------------------------------------------------------


class TenantEntry:
    """One tenant's aggregates (mutated under the registry lock)."""

    __slots__ = (
        "label", "calls", "outcomes", "bad", "rows", "total_s", "last_ms",
        "recompiles", "h2d_bytes", "d2h_bytes", "pad_ratio_sum",
        "pad_calls", "classes",
    )

    def __init__(self, label: str):
        self.label = label
        self.calls = 0
        self.outcomes: Dict[str, int] = {}
        self.bad = 0  # non-ok outcomes: the SLO availability numerator
        self.rows = 0
        self.total_s = 0.0
        self.last_ms = 0.0
        self.recompiles = 0
        self.h2d_bytes = 0
        self.d2h_bytes = 0
        self.pad_ratio_sum = 0.0
        self.pad_calls = 0
        self.classes: Dict[str, Dict[str, Any]] = {}

    def row(self) -> Dict[str, Any]:
        return {
            "tenant": self.label,
            "calls": self.calls,
            "outcomes": dict(self.outcomes),
            "bad": self.bad,
            "rows": self.rows,
            "total_ms": round(self.total_s * 1000.0, 3),
            "last_ms": round(self.last_ms, 3),
            "receipt": {
                "recompiles": self.recompiles,
                "h2d_bytes": self.h2d_bytes,
                "d2h_bytes": self.d2h_bytes,
                "pad_ratio_mean": round(
                    self.pad_ratio_sum / max(self.pad_calls, 1), 4
                ),
                "pad_calls": self.pad_calls,
            },
            "classes": {
                k: {"calls": v["calls"],
                    "ms": round(v["s"] * 1000.0, 3),
                    "bad": v["bad"]}
                for k, v in sorted(self.classes.items())
            },
        }


_SORTS = {
    "time": lambda r: r["total_ms"],
    "calls": lambda r: r["calls"],
    "rows": lambda r: r["rows"],
    "bad": lambda r: r["bad"],
}
# the public sort keys of ``rows``
SORTS = tuple(_SORTS)


class TenantRegistry:
    """Fixed-memory top-K LRU of per-tenant aggregates (one per store,
    ``TorchDataStore._tenants_obj``). Latency rides
    ``self.metrics`` timers named ``tenant.<label>`` — the shared
    MetricsRegistry reservoir/exemplar machinery, dropped with the
    entry on LRU eviction so memory stays bounded by the cap alone."""

    def __init__(self, cap: Optional[int] = None):
        self.cap = tenants_knobs()[1] if cap is None else int(cap)
        self.metrics = MetricsRegistry()
        self._entries: "OrderedDict[str, TenantEntry]" = OrderedDict()
        self._lock = threading.Lock()
        self.evicted = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def observe(
        self,
        label: str,
        cls: str,
        *,
        outcome: str = "ok",
        duration_s: float = 0.0,
        rows: int = 0,
        receipt: Optional[Dict[str, Any]] = None,
    ) -> None:
        """Fold one finished request into its tenant (LRU-bumped;
        evicts the coldest entry past the cap)."""
        label = clean_label(label)
        dropped = None
        with self._lock:
            e = self._entries.get(label)
            if e is None:
                e = TenantEntry(label)
                self._entries[label] = e
                if len(self._entries) > self.cap:
                    _k, dropped = self._entries.popitem(last=False)
                    self.evicted += 1
            else:
                self._entries.move_to_end(label)
            e.calls += 1
            e.outcomes[outcome] = e.outcomes.get(outcome, 0) + 1
            if outcome != "ok":
                e.bad += 1
            e.rows += int(rows)
            e.total_s += float(duration_s)
            e.last_ms = float(duration_s) * 1000.0
            if receipt:
                e.recompiles += int(receipt.get("recompiles", 0))
                e.h2d_bytes += int(receipt.get("h2d_bytes", 0))
                e.d2h_bytes += int(receipt.get("d2h_bytes", 0))
                pr = float(receipt.get("pad_ratio", 0.0))
                if pr > 0.0:
                    e.pad_ratio_sum += pr
                    e.pad_calls += 1
            c = e.classes.get(cls)
            if c is None:
                c = e.classes[cls] = {"calls": 0, "s": 0.0, "bad": 0}
            c["calls"] += 1
            c["s"] += float(duration_s)
            if outcome != "ok":
                # per-class bad split: the per-tenant SLO burn folds a
                # spec's OWN class, not the tenant's mixed traffic
                c["bad"] += 1
        if dropped is not None:
            self.metrics.drop_timer(f"tenant.{dropped.label}")
        # the timer update sits OUTSIDE the registry lock (the
        # PlanRegistry ordering rule: registry lock, then metrics lock)
        self.metrics.update_timer(f"tenant.{label}", float(duration_s))

    # -- reads ---------------------------------------------------------------

    def rows(self, sort: str = "time", n: int = 20) -> List[Dict[str, Any]]:
        """Top ``n`` tenant rows by ``sort`` (time | calls | rows |
        bad), latency summaries and trace-linked exemplars attached."""
        if sort not in _SORTS:
            raise ValueError(
                f"unknown sort {sort!r} (one of {sorted(_SORTS)})"
            )
        with self._lock:
            rows = [e.row() for e in self._entries.values()]
        rows.sort(key=_SORTS[sort], reverse=True)
        rows = rows[: max(0, int(n))]
        _c, _g, timers, totals = self.metrics.snapshot()
        for r in rows:
            vals = timers.get(f"tenant.{r['tenant']}")
            if vals:
                r["latency"] = histogram_summary(
                    vals,
                    total_count=totals.get(
                        f"tenant.{r['tenant']}", (None,)
                    )[0],
                )
            ex = self.metrics.exemplars(f"tenant.{r['tenant']}")
            if ex and ex.get("buckets"):
                b = max(ex["buckets"])
                s, tid, wall = ex["buckets"][b]
                if tid:
                    r["worst_exemplar"] = {
                        "ms": round(s * 1000.0, 3),
                        "trace_id": tid,
                        "date_ms": int(wall),
                    }
        return rows

    def top(self, n: int = 5) -> List[Dict[str, Any]]:
        """Compact per-shard/timeline summary: the ``n`` hottest
        tenants by total time."""
        with self._lock:
            es = sorted(
                self._entries.values(), key=lambda e: e.total_s,
                reverse=True,
            )[: max(0, int(n))]
            return [
                {
                    "tenant": e.label,
                    "calls": e.calls,
                    "bad": e.bad,
                    "rows": e.rows,
                    "total_ms": round(e.total_s * 1000.0, 3),
                }
                for e in es
            ]

    def totals(self) -> Dict[str, tuple]:
        """{label: (calls, total_s, bad, {cls: (calls, bad)})} — the
        timeline sampler diffs consecutive reads into per-tick tenant
        deltas (which the per-tenant SLO burn folds, per class)."""
        with self._lock:
            return {
                e.label: (
                    e.calls, e.total_s, e.bad,
                    {k: (v["calls"], v["bad"])
                     for k, v in e.classes.items()},
                )
                for e in self._entries.values()
            }

    def payload(self, sort: str = "time", n: int = 20) -> Dict[str, Any]:
        """The registry as one payload: the flag, the sort, the counts and
        the top rows."""
        return {
            "enabled": enabled(),
            "sort": sort,
            "count": len(self),
            "evicted": self.evicted,
            "tenants": self.rows(sort=sort, n=n),
        }


def timeline_deltas(
    registry: Optional[TenantRegistry],
    prev: Dict[str, tuple],
    n: int = 5,
) -> Tuple[Dict[str, tuple], List[Dict[str, Any]]]:
    """One timeline tick's tenant deltas: (new_prev, rows) — "who was
    hot THIS second", with per-class call/bad splits so the per-tenant
    SLO availability burn folds a spec's OWN class. Pure reads; an
    absent registry returns no rows."""
    if registry is None:
        return prev, []
    now = registry.totals()
    rows = []
    for label, (calls, total_s, bad, classes) in now.items():
        pc, ps, pb, pcls = prev.get(label, (0, 0.0, 0, {}))
        dc = calls - pc
        if dc <= 0:
            continue
        dcls = {}
        for k, (cc, cb) in classes.items():
            oc, ob = pcls.get(k, (0, 0))
            if cc - oc > 0:
                dcls[k] = {"calls": cc - oc, "bad": cb - ob}
        rows.append({
            "tenant": label,
            "calls": dc,
            "ms": round((total_s - ps) * 1000.0, 3),
            "bad": bad - pb,
            "classes": dcls,
        })
    rows.sort(key=lambda r: r["ms"], reverse=True)
    return now, rows[: max(0, int(n))]


def merge_rows(row_lists: List[List[Dict[str, Any]]]) -> List[Dict[str, Any]]:
    """Merge tenant rows from several registries (the fleet rollup):
    numeric aggregates sum by label and the pad-ratio mean is
    recomputed as an EXACT weighted mean from ``mean * count`` — the
    utils/plans.merge_rows contract. Latency summaries and exemplars
    are per-source and dropped (percentile reservoirs do not merge)."""
    out: "OrderedDict[str, Dict[str, Any]]" = OrderedDict()
    for rows in row_lists:
        for r in rows:
            label = r["tenant"]
            m = out.get(label)
            if m is None:
                m = {k: v for k, v in r.items()
                     if k not in ("latency", "worst_exemplar")}
                m["outcomes"] = dict(r.get("outcomes", {}))
                m["receipt"] = dict(r["receipt"])
                m["classes"] = {
                    k: dict(v) for k, v in r.get("classes", {}).items()
                }
                out[label] = m
                continue
            for k in ("calls", "bad", "rows"):
                m[k] += r.get(k, 0)
            m["total_ms"] = round(m["total_ms"] + r["total_ms"], 3)
            for k, v in r.get("outcomes", {}).items():
                m["outcomes"][k] = m["outcomes"].get(k, 0) + v
            for k, v in r.get("classes", {}).items():
                c = m["classes"].get(k)
                if c is None:
                    m["classes"][k] = dict(v)
                else:
                    c["calls"] += v.get("calls", 0)
                    c["ms"] = round(c.get("ms", 0.0) + v.get("ms", 0.0), 3)
                    c["bad"] = c.get("bad", 0) + v.get("bad", 0)
            mr, rr = m["receipt"], r["receipt"]
            pad_sum = (
                mr["pad_ratio_mean"] * mr.get("pad_calls", 0)
                + rr["pad_ratio_mean"] * rr.get("pad_calls", 0)
            )
            mr["pad_calls"] = mr.get("pad_calls", 0) + rr.get("pad_calls", 0)
            mr["pad_ratio_mean"] = round(
                pad_sum / max(mr["pad_calls"], 1), 4
            )
            for k in ("recompiles", "h2d_bytes", "d2h_bytes"):
                mr[k] += rr.get(k, 0)
    merged = list(out.values())
    merged.sort(key=lambda r: r["total_ms"], reverse=True)
    return merged
