"""Plan telemetry: query fingerprints and per-fingerprint statistics.

Port of ``geomesa_tpu/utils/plans.py``. Every query, ``query_many`` member
and aggregate is fingerprinted by its normalized plan shape (feature type,
chosen index, union arity, filter shape with the literals erased, hint
class and the route that answered) and folded into a fixed-memory top-K
LRU of per-fingerprint aggregates: calls and outcomes, hits, a latency
timer (``audit.MetricsRegistry``), rows scanned and returned and blocks
touched (fed per block by the store's scan loop), receipt sums, the
planner's estimate against the rows actually scanned (a log2 histogram)
and the reason-coded decisions (``utils.audit.decision``) its queries took.

``geomesa.plans.enabled=false`` leaves one cached flag read (``begin``) or
one context-variable read (``note``, ``note_scan``) on the query path. The
flag resolves from the knob once; ``set_enabled(None)`` resolves it again.
``store.explain_analyze()`` joins one execution's span tree to its
fingerprint. The durable spool's ``history_rows`` is not in the port.
"""

from __future__ import annotations

import contextvars
import hashlib
import math
import threading
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

from geomesa_tpu_torch.utils.audit import MetricsRegistry, histogram_summary

# -- the flag -----------------------------------------------------------------

_ENABLED: Optional[bool] = None  # None = resolve from the knob on next read


def enabled() -> bool:
    """The hot-path gate: one module-global read once resolved."""
    e = _ENABLED
    if e is None:
        return _resolve()
    return e


def _resolve() -> bool:
    global _ENABLED
    from geomesa_tpu_torch.utils.config import PLANS_ENABLED

    _ENABLED = bool(PLANS_ENABLED.to_bool())
    return _ENABLED


def set_enabled(on: Optional[bool]) -> None:
    """Flip the cached flag (``None`` re-resolves ``geomesa.plans.enabled``
    on the next read — how tests and config flips take effect)."""
    global _ENABLED
    _ENABLED = None if on is None else bool(on)


def plans_knobs() -> Tuple[bool, int]:
    """(enabled, max_fingerprints) from the geomesa.plans.* tier."""
    from geomesa_tpu_torch.utils.config import PLANS_MAX

    cap = PLANS_MAX.to_int()
    return enabled(), 256 if cap is None or cap <= 0 else cap


# -- per-query pending context ------------------------------------------------
#
# Decisions and per-block row counts happen DURING execution, before the
# fingerprint is known (the scan path is part of the key and only final
# at consume time). They collect into a small per-query context object
# installed by ``begin()`` and drained by ``PlanRegistry.observe`` at
# audit time. With the flag down, ``begin`` returns None and every
# ``note*`` is one contextvar read of the None default.

_PENDING_CAP = 64  # bound per-query decision tallies (fixed memory)


class _Pending:
    __slots__ = ("decisions", "rows_in", "rows_out", "blocks")

    def __init__(self):
        self.decisions: List[Tuple[str, str]] = []
        self.rows_in = 0
        self.rows_out = 0
        self.blocks = 0

    def reset(self) -> None:
        self.decisions = []
        self.rows_in = self.rows_out = self.blocks = 0


_PENDING: contextvars.ContextVar[Optional[_Pending]] = contextvars.ContextVar(
    "geomesa_tpu_torch_plan_pending", default=None
)


def begin():
    """Open one query's pending-collection scope (None when disabled —
    the single flag read the off path pays). Pair with ``end``."""
    if not enabled():
        return None
    return _PENDING.set(_Pending())


def end(token) -> None:
    if token is not None:
        _PENDING.reset(token)


def pending() -> Optional["_Pending"]:
    """A detached pending collector for GENERATOR query bodies (None
    when disabled — the same single flag read as ``begin``). A
    contextvar must never stay set across a yield, so streaming paths
    hold the object and re-enter it with ``attach`` around each step,
    the ``deadline.attach`` posture."""
    return _Pending() if enabled() else None


class attach:
    """Re-enter a ``pending()`` scope around one step of a generator
    body; no-op (and allocation-free on __exit__) when ``p`` is None."""

    __slots__ = ("_p", "_tok")

    def __init__(self, p: Optional["_Pending"]):
        self._p = p
        self._tok = None

    def __enter__(self):
        if self._p is not None:
            self._tok = _PENDING.set(self._p)
        return self._p

    def __exit__(self, *exc) -> bool:
        if self._tok is not None:
            _PENDING.reset(self._tok)
            self._tok = None
        return False


def note(point: str, reason: str) -> None:
    """Tally one reason-coded event on the current query's fingerprint
    (cache engagement, adaptive declines — ``utils.audit.decision``
    routes here). No-op outside a ``begin`` scope."""
    p = _PENDING.get()
    if p is not None and len(p.decisions) < _PENDING_CAP:
        p.decisions.append((point, reason))


def note_scan(rows_in: int, rows_out: int) -> None:
    """Fold one scanned block's candidate/result row counts into the
    current query's actuals (the estimate-vs-actual denominator)."""
    p = _PENDING.get()
    if p is not None:
        p.rows_in += int(rows_in)
        p.rows_out += int(rows_out)
        p.blocks += 1


# -- fingerprints -------------------------------------------------------------


def filter_shape(f) -> str:
    """Normalized filter shape: node kinds and property names with every
    literal erased, AND/OR children sorted — two bboxes over the same
    column are ONE shape (the pg_stat_statements normalization rule)."""
    from geomesa_tpu_torch.filter import ast

    if f is None or isinstance(f, ast.Include):
        return "INCLUDE"
    if isinstance(f, ast.Exclude):
        return "EXCLUDE"
    if isinstance(f, (ast.And, ast.Or)):
        kids = sorted(filter_shape(c) for c in f.children())
        return f"{type(f).__name__.upper()}({','.join(kids)})"
    if isinstance(f, ast.Not):
        return f"NOT({filter_shape(f.child)})"
    if isinstance(f, ast.Cmp):
        return f"{f.prop}{f.op}?"
    if isinstance(f, ast.IdFilter):
        return "ID(?)"
    name = type(f).__name__.upper()
    prop = getattr(f, "prop", None)
    return f"{name}({prop})" if prop is not None else f"{name}(?)"


def fingerprint_key(
    kind: str,
    type_name: str,
    plan=None,
    query=None,
    scan_path: str = "",
    shape: Optional[str] = None,
) -> tuple:
    """The normalized plan-shape key: NO literal values, so every bbox
    over the same column/index/path folds into one fingerprint."""
    index = ""
    union_arity = 0
    if plan is not None:
        index = getattr(getattr(plan, "index", None), "name", "") or ""
        union = getattr(plan, "union", None)
        union_arity = len(union) if union else 0
    if shape is None:
        shape = filter_shape(getattr(query, "filter", None))
    hints = getattr(query, "hints", None) or {}
    hint_class = "+".join(sorted(hints))
    return (kind, type_name, index, union_arity, shape, hint_class, scan_path)


def _fid(key: tuple) -> str:
    return hashlib.sha1("|".join(map(str, key)).encode()).hexdigest()[:12]


def fingerprint_id(key: tuple) -> str:
    """The stable short id of one fingerprint key — what the registry's
    rows and ``explain_analyze`` join on."""
    return _fid(key)


def _mis_bucket(actual: float, estimate: float) -> int:
    """Signed log2 misestimate bucket: 0 = spot-on, +k = the plan
    under-estimated by ~2^k, -k = over-estimated. +1 smoothing keeps
    empty results and zero-cost plans finite."""
    return int(round(math.log2((actual + 1.0) / (max(estimate, 0.0) + 1.0))))


class PlanEntry:
    """One fingerprint's aggregates (mutated under the registry lock)."""

    __slots__ = (
        "fid", "kind", "type_name", "index", "union_arity", "shape",
        "hint_class", "scan_path", "calls", "outcomes", "hits",
        "rows_scanned", "rows_returned", "blocks", "total_s", "last_ms",
        "est_cost_sum", "est_ranges_sum", "est_calls", "mis_hist",
        "recompiles", "h2d_bytes", "d2h_bytes", "pad_ratio_sum",
        "pad_calls", "decisions",
    )

    def __init__(self, fid: str, key: tuple):
        (self.kind, self.type_name, self.index, self.union_arity,
         self.shape, self.hint_class, self.scan_path) = key
        self.fid = fid
        self.calls = 0
        self.outcomes: Dict[str, int] = {}
        self.hits = 0
        self.rows_scanned = 0
        self.rows_returned = 0
        self.blocks = 0
        self.total_s = 0.0
        self.last_ms = 0.0
        self.est_cost_sum = 0.0
        self.est_ranges_sum = 0
        self.est_calls = 0
        self.mis_hist: Dict[int, int] = {}
        self.recompiles = 0
        self.h2d_bytes = 0
        self.d2h_bytes = 0
        self.pad_ratio_sum = 0.0
        self.pad_calls = 0
        self.decisions: Dict[str, int] = {}

    def mean_log2_mis(self) -> Optional[float]:
        n = sum(self.mis_hist.values())
        if not n:
            return None
        return sum(b * c for b, c in self.mis_hist.items()) / n

    def row(self) -> Dict[str, Any]:
        est_n = max(self.est_calls, 1)
        mis = self.mean_log2_mis()
        return {
            "fingerprint": self.fid,
            "kind": self.kind,
            "type": self.type_name,
            "index": self.index,
            "union_arity": self.union_arity,
            "shape": self.shape,
            "hints": self.hint_class,
            "scan_path": self.scan_path,
            "calls": self.calls,
            "outcomes": dict(self.outcomes),
            "hits": self.hits,
            "rows_scanned": self.rows_scanned,
            "rows_returned": self.rows_returned,
            "blocks": self.blocks,
            "total_ms": round(self.total_s * 1000.0, 3),
            "last_ms": round(self.last_ms, 3),
            "estimate": {
                "cost_mean": round(self.est_cost_sum / est_n, 2),
                "ranges_mean": round(self.est_ranges_sum / est_n, 2),
                # the weighting count: merge_rows recomputes exact
                # weighted means across shards from mean * calls
                "calls": self.est_calls,
            },
            "actual": {
                "rows_mean": round(self.rows_scanned / max(self.calls, 1), 2),
            },
            "misestimate": {
                "hist": {str(b): c for b, c in sorted(self.mis_hist.items())},
                "mean_log2": None if mis is None else round(mis, 3),
            },
            "receipt": {
                "recompiles": self.recompiles,
                "h2d_bytes": self.h2d_bytes,
                "d2h_bytes": self.d2h_bytes,
                "pad_ratio_mean": round(
                    self.pad_ratio_sum / max(self.pad_calls, 1), 4
                ),
                "pad_calls": self.pad_calls,
            },
            "decisions": dict(self.decisions),
        }


_SORTS = {
    "time": lambda r: r["total_ms"],
    "calls": lambda r: r["calls"],
    "hits": lambda r: r["hits"],
    "misestimate": lambda r: abs(r["misestimate"]["mean_log2"] or 0.0),
}
# the public sort keys of ``rows``
SORTS = tuple(_SORTS)


class PlanRegistry:
    """Fixed-memory top-K LRU of per-fingerprint aggregates.

    One registry per store (``TorchDataStore._plans_obj``). Latency rides ``self.metrics`` timers named
    ``plan.<fid>`` — the shared MetricsRegistry reservoir/exemplar
    machinery, dropped with the entry on LRU eviction so memory stays
    bounded by the cap alone."""

    def __init__(self, cap: Optional[int] = None):
        self.cap = plans_knobs()[1] if cap is None else int(cap)
        self.metrics = MetricsRegistry()
        self._entries: "OrderedDict[tuple, PlanEntry]" = OrderedDict()
        self._lock = threading.Lock()
        self.evicted = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def observe(
        self,
        kind: str,
        type_name: str,
        *,
        plan=None,
        query=None,
        scan_path: str = "",
        shape: Optional[str] = None,
        outcome: str = "ok",
        hits: int = 0,
        duration_s: float = 0.0,
        receipt: Optional[Dict[str, Any]] = None,
        est_cost: Optional[float] = None,
        est_ranges: Optional[int] = None,
    ) -> str:
        """Fold one finished query into its fingerprint (LRU-bumped;
        evicts the coldest entry past the cap). Drains the pending
        context (decisions + per-block row actuals) and resets it, so a
        nested consumer (an aggregate's exact-fallback inner query) can
        never double-report. Returns the fingerprint id."""
        key = fingerprint_key(
            kind, type_name, plan=plan, query=query, scan_path=scan_path,
            shape=shape,
        )
        pend = _PENDING.get()
        dropped = None
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                e = PlanEntry(_fid(key), key)
                self._entries[key] = e
                if len(self._entries) > self.cap:
                    _k, dropped = self._entries.popitem(last=False)
                    self.evicted += 1
            else:
                self._entries.move_to_end(key)
            e.calls += 1
            e.outcomes[outcome] = e.outcomes.get(outcome, 0) + 1
            e.hits += int(hits)
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
            if pend is not None:
                e.rows_scanned += pend.rows_in
                e.rows_returned += pend.rows_out
                e.blocks += pend.blocks
                for point, reason in pend.decisions:
                    k = f"{point}.{reason}"
                    e.decisions[k] = e.decisions.get(k, 0) + 1
            if est_cost is not None:
                e.est_cost_sum += float(est_cost)
                e.est_ranges_sum += int(est_ranges or 0)
                e.est_calls += 1
                # the misestimate bucket needs REAL actuals: a coalesced
                # follower's scan ran in the leader's context, so its own
                # pending saw zero blocks — bucketing 0 against a true
                # cost would read as a huge over-estimate and poison the
                # signal the adaptive knobs consume. No blocks observed
                # -> no verdict (hits stand in only when no pending
                # scope existed at all).
                if pend is None:
                    b = _mis_bucket(int(hits), float(est_cost))
                    e.mis_hist[b] = e.mis_hist.get(b, 0) + 1
                elif pend.blocks > 0:
                    b = _mis_bucket(pend.rows_in, float(est_cost))
                    e.mis_hist[b] = e.mis_hist.get(b, 0) + 1
            fid = e.fid
        if pend is not None:
            pend.reset()
        if dropped is not None:
            self.metrics.drop_timer(f"plan.{dropped.fid}")
        # the timer update sits OUTSIDE the registry lock: reservoir,
        # cumulative totals, and (flag-up) exemplars ride the shared
        # MetricsRegistry machinery — per-tick histograms come free
        self.metrics.update_timer(f"plan.{fid}", float(duration_s))
        return fid

    # -- reads ---------------------------------------------------------------

    def rows(self, sort: str = "time", n: int = 20) -> List[Dict[str, Any]]:
        """Top ``n`` fingerprint rows by ``sort`` (time | calls | hits |
        misestimate), latency summaries and trace-linked exemplars
        attached. Entries are copied under the lock; timer reads happen
        after (the registry-lock-then-metrics-lock order is the only one
        used anywhere, so no inversion)."""
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
            vals = timers.get(f"plan.{r['fingerprint']}")
            if vals:
                r["latency"] = histogram_summary(
                    vals,
                    total_count=totals.get(
                        f"plan.{r['fingerprint']}", (None,)
                    )[0],
                )
            ex = self.metrics.exemplars(f"plan.{r['fingerprint']}")
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
        fingerprints by total time."""
        with self._lock:
            es = sorted(
                self._entries.values(), key=lambda e: e.total_s, reverse=True
            )[: max(0, int(n))]
            return [
                {
                    "fingerprint": e.fid,
                    "type": e.type_name,
                    "index": e.index,
                    "scan_path": e.scan_path,
                    "calls": e.calls,
                    "total_ms": round(e.total_s * 1000.0, 3),
                }
                for e in es
            ]

    def totals(self) -> Dict[str, Tuple[int, float, str]]:
        """{fid: (calls, total_s, type)} — the timeline sampler diffs
        consecutive reads into per-tick top-fingerprint deltas."""
        with self._lock:
            return {
                e.fid: (e.calls, e.total_s, e.type_name)
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
            "fingerprints": self.rows(sort=sort, n=n),
        }


def timeline_deltas(
    registry: Optional[PlanRegistry],
    prev: Dict[str, Tuple[int, float, str]],
    n: int = 5,
) -> Tuple[Dict[str, Tuple[int, float, str]], List[Dict[str, Any]]]:
    """One timeline tick's top-fingerprint deltas: (new_prev, rows) —
    the per-tick "which plan shapes were hot THIS second" block. Pure
    reads; an absent/empty registry returns no rows."""
    if registry is None:
        return prev, []
    now = registry.totals()
    rows = []
    for fid, (calls, total_s, tname) in now.items():
        pc, ps, _t = prev.get(fid, (0, 0.0, tname))
        dc = calls - pc
        if dc <= 0:
            continue
        rows.append({
            "fingerprint": fid,
            "type": tname,
            "calls": dc,
            "ms": round((total_s - ps) * 1000.0, 3),
        })
    rows.sort(key=lambda r: r["ms"], reverse=True)
    return now, rows[: max(0, int(n))]


def merge_rows(row_lists: List[List[Dict[str, Any]]]) -> List[Dict[str, Any]]:
    """Merge fingerprint rows from several registries (the sharded
    rollup): numeric aggregates sum by fingerprint id and every mean
    (estimate cost/ranges, actual rows, pad ratio) is recomputed as an
    EXACT weighted mean from ``mean * count`` — a merged row must never
    report one shard's mean beside a fleet-wide call count. Latency
    summaries and exemplars are per-source and dropped from merged rows
    (percentile reservoirs do not merge — the per-shard blocks keep
    them)."""
    out: "OrderedDict[str, Dict[str, Any]]" = OrderedDict()
    for rows in row_lists:
        for r in rows:
            fid = r["fingerprint"]
            m = out.get(fid)
            if m is None:
                m = {k: v for k, v in r.items()
                     if k not in ("latency", "worst_exemplar")}
                m["outcomes"] = dict(r.get("outcomes", {}))
                m["decisions"] = dict(r.get("decisions", {}))
                m["misestimate"] = {
                    "hist": dict(r["misestimate"]["hist"]),
                    "mean_log2": r["misestimate"]["mean_log2"],
                }
                m["estimate"] = dict(r["estimate"])
                m["actual"] = dict(r["actual"])
                m["receipt"] = dict(r["receipt"])
                out[fid] = m
                continue
            for k in ("calls", "hits", "rows_scanned", "rows_returned",
                      "blocks"):
                m[k] += r.get(k, 0)
            m["total_ms"] = round(m["total_ms"] + r["total_ms"], 3)
            for k, v in r.get("outcomes", {}).items():
                m["outcomes"][k] = m["outcomes"].get(k, 0) + v
            for k, v in r.get("decisions", {}).items():
                m["decisions"][k] = m["decisions"].get(k, 0) + v
            for k, v in r["misestimate"]["hist"].items():
                m["misestimate"]["hist"][k] = (
                    m["misestimate"]["hist"].get(k, 0) + v
                )
            # weighted-mean folds: mean * count sums exactly
            me, re_ = m["estimate"], r["estimate"]
            for k in ("cost_mean", "ranges_mean"):
                me[k] = me[k] * me["calls"] + re_[k] * re_["calls"]
            me["calls"] += re_["calls"]
            for k in ("cost_mean", "ranges_mean"):
                me[k] = round(me[k] / max(me["calls"], 1), 2)
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
    for m in merged:
        hist = m["misestimate"]["hist"]
        total = sum(hist.values())
        m["misestimate"]["mean_log2"] = (
            round(sum(int(b) * c for b, c in hist.items()) / total, 3)
            if total else None
        )
        m["actual"]["rows_mean"] = round(
            m["rows_scanned"] / max(m["calls"], 1), 2
        )
    merged.sort(key=lambda r: r["total_ms"], reverse=True)
    return merged
