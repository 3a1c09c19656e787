"""The SLO engine: per-query-class objectives with multi-window burn rates
over the telemetry timeline.

Port of ``geomesa_tpu/utils/slo.py``. Objectives are evaluated per query
class, from the counters and timers the store's audit step writes:

    query               queries / queries.{timeout,shed} / query.scan
    join                queries.join / queries.join.{timeout,shed} / query.join
    aggregate           queries.aggregate / ... / query.aggregate
    stream_first_batch  queries.stream / query.stream.first

(``query_many`` members audit into ``query``.) Two kinds of objective a
class: availability (bad = timeout and shed outcomes) and latency (bad =
timer samples in a latency bucket above the class's threshold,
``geomesa.slo.<class>.latency.ms``, folded from the timeline's per-tick
bucket histograms; a sample in the threshold's own bucket counts good).

Burn rate = (bad / events) / (1 - objective). A class violates when both
the fast window (5 minutes) and the slow one (1 hour) burn past their
thresholds (14.4 and 1.0) and the fast window saw at least
``geomesa.slo.min.events`` events. The same gate runs per tenant over the
timeline's tenant deltas (``<slo>@tenant:<label>``) and, on a store whose
ticks carry a fleet rollup, per worker. The port has no fleet yet, so
that fold is empty.
"""

from __future__ import annotations

import threading
import weakref
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

from geomesa_tpu_torch.utils import audit

# query class -> (events counter, bad-outcome counters, latency timer).
# Derived from what store/datastore.py already writes per class — the
# engine adds no hot-path instrumentation of its own.
CLASSES: Dict[str, Dict[str, Any]] = {
    "query": {
        "counter": "queries",
        "bad": ("queries.timeout", "queries.shed"),
        "timer": "query.scan",
    },
    "join": {
        "counter": "queries.join",
        "bad": ("queries.join.timeout", "queries.join.shed"),
        "timer": "query.join",
    },
    "aggregate": {
        "counter": "queries.aggregate",
        "bad": ("queries.aggregate.timeout", "queries.aggregate.shed"),
        "timer": "query.aggregate",
    },
    "stream_first_batch": {
        "counter": "queries.stream",
        "bad": (),
        "timer": "query.stream.first",
    },
}


@dataclass
class SloSpec:
    """One objective: ``kind`` is ``availability`` (good = outcome ok)
    or ``latency`` (good = under ``latency_ms``); ``objective`` is the
    good-fraction target (0.999 = three nines)."""

    name: str
    cls: str
    kind: str
    objective: float
    latency_ms: Optional[float] = None

    def __post_init__(self):
        if self.cls not in CLASSES:
            raise ValueError(
                f"unknown query class {self.cls!r} (classes: {sorted(CLASSES)})"
            )
        if self.kind not in ("availability", "latency"):
            raise ValueError(f"unknown SLO kind {self.kind!r}")
        if not 0.0 < self.objective < 1.0:
            raise ValueError("objective must be in (0, 1)")
        if self.kind == "latency" and not self.latency_ms:
            raise ValueError("latency SLOs need latency_ms")


def default_slos() -> List[SloSpec]:
    """The knob-driven default objective set: availability + latency per
    class (availability skipped for the stream class — a stream that
    fails pre-first-byte already audits as a ``query`` outcome)."""
    from geomesa_tpu_torch.utils import config as cfg

    avail = cfg.SLO_AVAILABILITY.to_float() or 0.999
    lat_obj = cfg.SLO_LATENCY_OBJECTIVE.to_float() or 0.99
    lat_ms = {
        "query": cfg.SLO_QUERY_LATENCY_MS.to_float(),
        "join": cfg.SLO_JOIN_LATENCY_MS.to_float(),
        "aggregate": cfg.SLO_AGGREGATE_LATENCY_MS.to_float(),
        "stream_first_batch": cfg.SLO_STREAM_FIRST_LATENCY_MS.to_float(),
    }
    out: List[SloSpec] = []
    for cls in CLASSES:
        if CLASSES[cls]["bad"]:
            out.append(SloSpec(f"{cls}-availability", cls, "availability", avail))
        if lat_ms.get(cls):
            out.append(
                SloSpec(
                    f"{cls}-latency", cls, "latency", lat_obj,
                    latency_ms=float(lat_ms[cls]),
                )
            )
    return out


def slo_knobs() -> tuple:
    """(enabled, fast_s, slow_s, fast_burn, slow_burn, min_events)."""
    from geomesa_tpu_torch.utils import config as cfg

    enabled = bool(cfg.SLO_ENABLED.to_bool())
    fast_s = cfg.SLO_WINDOW_FAST.to_duration_s(300.0)
    slow_s = cfg.SLO_WINDOW_SLOW.to_duration_s(3600.0)
    fast_burn = cfg.SLO_BURN_FAST.to_float() or 14.4
    slow_burn = cfg.SLO_BURN_SLOW.to_float() or 1.0
    me = cfg.SLO_MIN_EVENTS.to_int()
    min_events = 100 if me is None else me
    return enabled, fast_s, slow_s, fast_burn, slow_burn, min_events


class SloEngine:
    """Evaluates a spec set over a ``TimelineSampler``'s ring.

    Pure reads: window sums over recorded snapshots plus exemplar
    lookups — the engine adds nothing to the query path and is safe to
    call from /healthz on every probe."""

    def __init__(self, sampler, specs: Optional[List[SloSpec]] = None):
        self.sampler = sampler
        self.specs = list(specs) if specs is not None else default_slos()

    # -- window folding ------------------------------------------------------

    @staticmethod
    def _fold(snaps: List[Dict[str, Any]], spec: SloSpec) -> Tuple[int, int]:
        """(events, bad) for one spec over one window's snapshots."""
        meta = CLASSES[spec.cls]
        events = 0
        bad = 0
        if spec.kind == "availability":
            for s in snaps:
                deltas = s.get("counters", {})
                events += deltas.get(meta["counter"], 0)
                bad += sum(deltas.get(b, 0) for b in meta["bad"])
            return events, bad
        # latency: fold the per-tick bucket histograms. A sample in the
        # threshold's own bucket reads as good (bucket-edge resolution);
        # buckets strictly above the threshold's are violations.
        thr_bucket = audit.exemplar_bucket(spec.latency_ms / 1000.0)
        for s in snaps:
            t = s.get("timers", {}).get(meta["timer"])
            if not t:
                continue
            events += t.get("count", 0)
            for b, n in t.get("hist", {}).items():
                if int(b) > thr_bucket:
                    bad += n
        return events, bad

    @staticmethod
    def _fold_workers(
        snaps: List[Dict[str, Any]], spec: SloSpec
    ) -> Dict[str, Tuple[int, int]]:
        """Per-worker ``{wid: (events, bad)}`` over one window, folded
        from the fleet rollup's UNMERGED ``per_worker`` series
        (``timeline.merge_worker_ticks``). Empty on non-fleet stores —
        the engine then behaves exactly as before."""
        meta = CLASSES[spec.cls]
        thr_bucket = (
            audit.exemplar_bucket(spec.latency_ms / 1000.0)
            if spec.kind == "latency"
            else None
        )
        acc: Dict[str, List[int]] = {}
        for s in snaps:
            per = ((s.get("fleet") or {}).get("rollup") or {}).get(
                "per_worker"
            ) or {}
            for wid, series in per.items():
                row = acc.setdefault(str(wid), [0, 0])
                if spec.kind == "availability":
                    deltas = series.get("counters") or {}
                    row[0] += int(deltas.get(meta["counter"], 0))
                    row[1] += sum(int(deltas.get(b, 0)) for b in meta["bad"])
                    continue
                t = (series.get("timers") or {}).get(meta["timer"])
                if not t:
                    continue
                row[0] += int(t.get("count", 0))
                for b, n in (t.get("hist") or {}).items():
                    if int(b) > thr_bucket:
                        row[1] += int(n)
        return {w: (e, b) for w, (e, b) in acc.items()}

    @staticmethod
    def _fold_tenants(
        snaps: List[Dict[str, Any]], spec: SloSpec
    ) -> Dict[str, Tuple[int, int]]:
        """Per-tenant ``{label: (events, bad)}`` over one window, folded
        from the sampler's per-tick tenant deltas (utils/tenants.py
        ``timeline_deltas`` — per-class call/bad splits, so a spec folds
        its OWN class). Availability specs only: the tenant rows carry
        no latency histograms, so latency objectives stay store-wide.
        Empty when the tenant meter is off — the engine then behaves
        exactly as before."""
        if spec.kind != "availability":
            return {}
        acc: Dict[str, List[int]] = {}
        for s in snaps:
            for r in s.get("tenants") or []:
                c = (r.get("classes") or {}).get(spec.cls)
                if not c:
                    continue
                row = acc.setdefault(str(r.get("tenant", "")), [0, 0])
                row[0] += int(c.get("calls", 0))
                row[1] += int(c.get("bad", 0))
        return {t: (e, b) for t, (e, b) in acc.items()}

    def _window_eval(
        self, spec: SloSpec, window_s: float, snaps: List[Dict[str, Any]]
    ) -> Dict[str, Any]:
        events, bad = self._fold(snaps, spec)
        budget = 1.0 - spec.objective
        frac = (bad / events) if events else 0.0
        return {
            "window_s": window_s,
            "coverage_s": round(len(snaps) * self.sampler.interval_s, 3),
            "events": events,
            "bad": bad,
            "bad_fraction": round(frac, 6),
            "burn_rate": round(frac / budget, 3) if budget > 0 else 0.0,
        }

    # -- evaluation ----------------------------------------------------------

    def evaluate(self, exemplars: bool = True) -> Dict[str, Any]:
        """The GET /debug/slo body: every spec's fast/slow windows, burn
        rates, violation verdicts, and (unless ``exemplars=False``)
        worst exemplars, trace-linked. The ring is copied ONCE per
        window, not per spec — /healthz probes this on every poll, and
        the evaluation must never contend with the sampler's tick
        beyond two bounded copies."""
        enabled, fast_s, slow_s, fast_burn, slow_burn, min_events = slo_knobs()
        slow_snaps = self.sampler.window(slow_s)
        n_fast = max(1, int(round(fast_s / self.sampler.interval_s)))
        fast_snaps = slow_snaps[-n_fast:] if slow_s >= fast_s else (
            self.sampler.window(fast_s)
        )
        rows = []
        violating = []
        for spec in self.specs:
            fast = self._window_eval(spec, fast_s, fast_snaps)
            slow = self._window_eval(spec, slow_s, slow_snaps)
            violated = (
                enabled
                and fast["events"] >= min_events
                and fast["burn_rate"] >= fast_burn
                and slow["burn_rate"] >= slow_burn
            )
            # per-worker burn (fleet stores only): a single sick worker
            # violates its class objective even when the fleet-merged
            # histogram dilutes it under threshold — skew a sum hides
            workers = self._workers_eval(
                spec,
                fast_snaps,
                slow_snaps,
                (enabled, fast_burn, slow_burn, min_events),
            )
            sick = sorted(w for w, r in workers.items() if r["violating"])
            # per-tenant burn (tenant meter on): one tenant's failing
            # traffic violates ITS objective even while the store-wide
            # series — diluted by every other tenant's successes —
            # stays green (the per-worker skew rule, per label)
            tenants = self._tenants_eval(
                spec,
                fast_snaps,
                slow_snaps,
                (enabled, fast_burn, slow_burn, min_events),
            )
            sick_t = sorted(t for t, r in tenants.items() if r["violating"])
            if violated:
                violating.append(spec.name)
            for w in sick:
                violating.append(f"{spec.name}@worker{w}")
            for t in sick_t:
                violating.append(f"{spec.name}@tenant:{t}")
            rows.append({
                "name": spec.name,
                "class": spec.cls,
                "kind": spec.kind,
                "objective": spec.objective,
                "latency_ms": spec.latency_ms,
                "fast": fast,
                "slow": slow,
                "violating": violated or bool(sick) or bool(sick_t),
                "violating_workers": sick,
                "workers": workers,
                "violating_tenants": sick_t,
                "tenants": tenants,
                "exemplars": (
                    self.worst_exemplars(spec.cls) if exemplars else []
                ),
            })
        return {
            "enabled": enabled,
            "thresholds": {
                "fast_burn": fast_burn,
                "slow_burn": slow_burn,
                "min_events": min_events,
            },
            "slos": rows,
            "violating": violating,
        }

    def _workers_eval(
        self,
        spec: SloSpec,
        fast_snaps: List[Dict[str, Any]],
        slow_snaps: List[Dict[str, Any]],
        knobs: Tuple[bool, float, float, int],
    ) -> Dict[str, Any]:
        """Per-worker burn rows for one spec: ``{wid: {fast, slow,
        violating}}``, workers with zero events omitted. The violation
        rule is the SAME multi-window/min-events gate as the merged
        series, applied to one worker's own events — so the verdict
        names the sick worker instead of waiting for the fleet average
        to cross."""
        enabled, fast_burn, slow_burn, min_events = knobs
        fast_w = self._fold_workers(fast_snaps, spec)
        if not fast_w:
            return {}
        slow_w = self._fold_workers(slow_snaps, spec)
        budget = 1.0 - spec.objective
        out: Dict[str, Any] = {}
        for wid in sorted(set(fast_w) | set(slow_w)):
            fe, fb = fast_w.get(wid, (0, 0))
            se, sb = slow_w.get(wid, (0, 0))
            if not fe and not se:
                continue
            f_rate = (
                round(((fb / fe) if fe else 0.0) / budget, 3)
                if budget > 0
                else 0.0
            )
            s_rate = (
                round(((sb / se) if se else 0.0) / budget, 3)
                if budget > 0
                else 0.0
            )
            out[wid] = {
                "fast": {"events": fe, "bad": fb, "burn_rate": f_rate},
                "slow": {"events": se, "bad": sb, "burn_rate": s_rate},
                "violating": (
                    enabled
                    and fe >= min_events
                    and f_rate >= fast_burn
                    and s_rate >= slow_burn
                ),
            }
        return out

    def _tenants_eval(
        self,
        spec: SloSpec,
        fast_snaps: List[Dict[str, Any]],
        slow_snaps: List[Dict[str, Any]],
        knobs: Tuple[bool, float, float, int],
    ) -> Dict[str, Any]:
        """Per-tenant burn rows for one spec: ``{label: {fast, slow,
        violating}}``, tenants with zero events omitted — the
        ``_workers_eval`` gate (same multi-window/min-events rule)
        applied to one tenant's own events."""
        enabled, fast_burn, slow_burn, min_events = knobs
        fast_t = self._fold_tenants(fast_snaps, spec)
        if not fast_t:
            return {}
        slow_t = self._fold_tenants(slow_snaps, spec)
        budget = 1.0 - spec.objective
        out: Dict[str, Any] = {}
        for label in sorted(set(fast_t) | set(slow_t)):
            fe, fb = fast_t.get(label, (0, 0))
            se, sb = slow_t.get(label, (0, 0))
            if not fe and not se:
                continue
            f_rate = (
                round(((fb / fe) if fe else 0.0) / budget, 3)
                if budget > 0
                else 0.0
            )
            s_rate = (
                round(((sb / se) if se else 0.0) / budget, 3)
                if budget > 0
                else 0.0
            )
            out[label] = {
                "fast": {"events": fe, "bad": fb, "burn_rate": f_rate},
                "slow": {"events": se, "bad": sb, "burn_rate": s_rate},
                "violating": (
                    enabled
                    and fe >= min_events
                    and f_rate >= fast_burn
                    and s_rate >= slow_burn
                ),
            }
        return out

    def violating(self) -> List[str]:
        """Just the violating SLO names — the /healthz degradation
        input: one evaluation with exemplar gathering skipped (nobody
        reads them on a health probe)."""
        return self.evaluate(exemplars=False)["violating"]

    # -- exemplars -----------------------------------------------------------

    def worst_exemplars(self, cls: str, n: int = 3) -> List[Dict[str, Any]]:
        """The class timer's worst retained exemplars (highest occupied
        latency buckets first): ``[{ms, trace_id, date_ms}]`` with ids
        resolvable in /debug/traces while the debug ring retains them.

        On a fleet coordinator, worker-minted exemplars (shipped by the
        ``timeline`` RPC, parallel/fleet.py) merge in with a ``shard``
        annotation: their trace ids are the envelope ids, so with trace
        stitching on they resolve to the SAME stitched trees — and with
        stitching off the shard number still says where the latency was
        paid instead of the sample silently vanishing. A local exemplar
        wins a bucket collision (it resolves without any wire help)."""
        timer = CLASSES[cls]["timer"]
        best: Dict[int, tuple] = {}
        # worker-minted first, so local registries override per bucket
        store = self.sampler._store()
        fleet_fn = getattr(store, "_fleet_exemplars", None)
        if callable(fleet_fn):
            for b, ex in (fleet_fn().get(timer) or {}).items():
                best[int(b)] = ex  # (s, tid, wall_ms, shard)
        for reg in self.sampler.registries:
            slot = reg.exemplars(timer)
            if slot:
                for b, ex in slot["buckets"].items():
                    best[b] = ex  # (s, tid, wall_ms)
        out = []
        for b in sorted(best, reverse=True)[:n]:
            ex = best[b]
            s, tid, wall = ex[0], ex[1], ex[2]
            row = {
                "ms": round(s * 1000.0, 3),
                "trace_id": tid,
                "date_ms": int(wall),
            }
            if len(ex) > 3:
                row["shard"] = int(ex[3])
            out.append(row)
        return out


# -- per-store engines --------------------------------------------------------

_ENGINES: "weakref.WeakKeyDictionary[Any, SloEngine]" = (
    weakref.WeakKeyDictionary()
)
_ENGINES_LOCK = threading.Lock()


def violation_record(engine: SloEngine) -> Optional[Dict[str, Any]]:
    """The durable-spool edition of one SLO evaluation (utils/
    history.py): ``{"violating": [...], "exemplars": {slo: [trace
    ids]}}`` while any class is violating, None while healthy — a
    healthy tick must spool nothing. The exemplar TRACE IDS persist
    (the trees themselves live in the bounded debug ring / black box):
    a postmortem joins them back against whatever ring or blackbox dump
    survived the crash."""
    ev = engine.evaluate(exemplars=True)
    violating = ev.get("violating") or []
    if not violating:
        return None
    exemplars: Dict[str, List[str]] = {}
    for row in ev.get("slos", ()):
        if not row.get("violating"):
            continue
        ids = [
            ex.get("trace_id")
            for ex in row.get("exemplars", ())
            if ex.get("trace_id")
        ]
        if ids:
            exemplars[row["name"]] = ids
    return {"violating": violating, "exemplars": exemplars}


def engine_for(store, create: bool = True) -> Optional[SloEngine]:
    """The store's SLO engine over its timeline sampler (None when the
    engine or the timeline is disabled — /healthz then skips the slo
    block entirely). ``create=False`` builds the (cheap) engine only
    over an ALREADY-RUNNING sampler: a /healthz probe must never be the
    thing that spawns a recorder thread."""
    from geomesa_tpu_torch.utils import timeline

    enabled = slo_knobs()[0]
    if not enabled:
        return None
    with _ENGINES_LOCK:
        got = _ENGINES.get(store)
    if got is not None:
        return got
    sampler = timeline.sampler_for(store, create=create)
    if sampler is None:
        return None
    eng = SloEngine(sampler)
    with _ENGINES_LOCK:
        return _ENGINES.setdefault(store, eng)
