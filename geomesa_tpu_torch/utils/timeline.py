"""The flight-recorder timeline: a fixed-memory ring of per-tick deltas over
every registry.

Port of ``geomesa_tpu/utils/timeline.py``. A ``TimelineSampler`` thread
takes one snapshot a ``geomesa.timeline.interval`` of

* the counter deltas of the store's ``MetricsRegistry``,
  ``robustness_metrics()`` and ``devstats_metrics()`` (only those that
  moved), the gauges, and each timer's count and sum deltas with a
  power-of-two latency-bucket histogram of the tick's samples (the
  ``audit.exemplar_bucket`` rule the SLO engine folds);
* the breaker states (``breaker.peek_states``, passive) and the
  admission depth (``AdmissionController.peek``, lock-free);
* cache hit rates, and the per-tick plan-fingerprint and tenant deltas;
* the brownout block: the ladder's one evaluation point is this tick.

The ring covers ``geomesa.timeline.window``. ``geomesa.timeline.enabled=
false`` starts no sampler; the one hook on the query path, the exemplar
record in ``MetricsRegistry.update_timer``, is a module-flag read while no
sampler runs. The sampler only reads the layers it observes. Until the
port has the durable telemetry spool and workload capture, a tick feeds
neither (the reference's behaviour with both off).
"""

from __future__ import annotations

import logging
import threading
import time
import weakref
from collections import deque
from typing import Any, Dict, List, Optional

from geomesa_tpu_torch.utils import audit
from geomesa_tpu_torch.utils.audit import MetricsRegistry

_log = logging.getLogger("geomesa_tpu_torch.timeline")

# cache-layer counter pairs surfaced as per-tick hit rates: the bimodal
# latency story (pyramid hit vs exact scan, coalesced vs solo) is
# unreadable from aggregate percentiles alone
_CACHE_RATES = (
    ("agg", "agg.cache.hits", "agg.cache.misses"),
    ("join_build", "join.build.hits", "join.build.misses"),
)


def timeline_knobs() -> tuple:
    """(enabled, interval_s, window_s) from the geomesa.timeline.* tier."""
    from geomesa_tpu_torch.utils.config import (
        TIMELINE_ENABLED,
        TIMELINE_INTERVAL,
        TIMELINE_WINDOW,
    )

    enabled = bool(TIMELINE_ENABLED.to_bool())
    interval_s = TIMELINE_INTERVAL.to_duration_s(1.0)
    window_s = TIMELINE_WINDOW.to_duration_s(3600.0)
    return enabled, max(0.01, interval_s), max(interval_s, window_s)


class TimelineSampler:
    """One store's flight recorder: a daemon thread appending per-tick
    delta snapshots to a bounded ring.

    ``tick()`` is callable directly (tests drive it deterministically);
    ``start()`` runs it on the interval. The sampler holds the store
    WEAKLY — telemetry must never pin a store's tables and mirrors —
    and the thread exits once the store is collected."""

    def __init__(
        self,
        store: Any = None,
        registries: Optional[List[MetricsRegistry]] = None,
        interval_s: Optional[float] = None,
        window_s: Optional[float] = None,
    ):
        _enabled, k_interval, k_window = timeline_knobs()
        self.interval_s = k_interval if interval_s is None else float(interval_s)
        self.window_s = k_window if window_s is None else float(window_s)
        self._store = (lambda: None) if store is None else weakref.ref(store)
        if registries is None:
            from geomesa_tpu_torch.utils.audit import robustness_metrics
            from geomesa_tpu_torch.utils.devstats import devstats_metrics

            registries = [robustness_metrics(), devstats_metrics()]
            m = getattr(store, "metrics", None)
            if isinstance(m, MetricsRegistry):
                # the store registry FIRST: its query.* names must win a
                # (never expected) collision with the process registries
                registries.insert(0, m)
        self.registries = list(registries)
        capacity = max(2, int(round(self.window_s / self.interval_s)))
        self._ring: deque = deque(maxlen=capacity)
        self._prev_counters: Dict[str, int] = {}
        self._prev_totals: Dict[str, tuple] = {}
        self._prev_plans: Dict[str, tuple] = {}
        self._prev_tenants: Dict[str, tuple] = {}
        self._primed = False
        self.ticks = 0  # cumulative, survives ring rotation
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- sampling ------------------------------------------------------------

    def _merged_snapshot(self):
        counters: Dict[str, int] = {}
        gauges: Dict[str, float] = {}
        timers: Dict[str, List[float]] = {}
        totals: Dict[str, tuple] = {}
        # later registries must NOT overwrite the store's own names, so
        # iterate in reverse priority (store registry listed first wins)
        for reg in reversed(self.registries):
            c, g, t, tt = reg.snapshot()
            counters.update(c)
            gauges.update(g)
            timers.update(t)
            totals.update(tt)
        return counters, gauges, timers, totals

    def tick(self) -> Optional[Dict[str, Any]]:
        """Take one snapshot (append to the ring, return it). Never
        raises — a telemetry failure must not kill the recorder loop —
        and only ever READS the layers it observes."""
        try:
            return self._tick()
        except Exception:  # noqa: BLE001 - recorder must outlive bad gauges
            _log.exception("timeline tick failed; recording continues")
            return None

    def _tick(self) -> Dict[str, Any]:
        from geomesa_tpu_torch.utils.breaker import peek_states

        counters, gauges, timers, totals = self._merged_snapshot()
        # the brownout control loop RUNS on this tick (the one
        # deliberate exception to the watches-never-drives rule: the
        # ladder needs exactly one periodic evaluation point, and the
        # sampler is it). OUTSIDE the ring lock — the controller reads
        # the SLO engine, whose window() copy takes this same lock.
        # Returns None for a quiet healthy store, keeping the tick
        # byte-identical; geomesa.brownout.enabled=0 never evaluates
        bblock = None
        _store0 = self._store()
        if _store0 is not None:
            bo = getattr(_store0, "_brownout", None)
            if bo is not None:
                from geomesa_tpu_torch.utils import brownout as _brownout

                if _brownout.enabled():
                    bblock = bo.on_tick(_store0)
        with self._lock:
            snap: Dict[str, Any] = {
                "t": time.time(),
                "dt_s": round(self.interval_s, 3),
            }
            if self._primed:
                deltas = {
                    k: v - self._prev_counters.get(k, 0)
                    for k, v in counters.items()
                    if v != self._prev_counters.get(k, 0)
                }
            else:
                # first tick: establish the baseline, report no deltas
                # (a process's whole history is not "the last second")
                deltas = {}
            snap["counters"] = deltas
            snap["gauges"] = {k: v for k, v in gauges.items()}
            tblock: Dict[str, Any] = {}
            for name, (count, total_s) in totals.items():
                pc, ps = self._prev_totals.get(name, (0, 0.0))
                k = count - pc
                if k <= 0 or not self._primed:
                    continue
                hist: Dict[int, int] = {}
                # the interval's new samples are the reservoir tail —
                # exact while fewer than RESERVOIR samples land per tick
                # (4096/s; far past any load this process serves)
                for s in timers.get(name, [])[-k:]:
                    b = audit.exemplar_bucket(s)
                    hist[b] = hist.get(b, 0) + 1
                tblock[name] = {
                    "count": k,
                    "sum_ms": round((total_s - ps) * 1000.0, 3),
                    "hist": hist,
                }
            snap["timers"] = tblock
            snap["caches"] = self._cache_rates(deltas)
            self._prev_counters = counters
            self._prev_totals = totals
            was_primed = self._primed
            self._primed = True
            # passive observations: peek_states runs no transitions,
            # peek() takes no locks — the recorder watches, never drives
            snap["breakers"] = peek_states()
            store = self._store()
            if store is not None:
                adm = getattr(store, "admission", None)
                if adm is not None:
                    snap["admission"] = adm.peek()
                # per-tick top plan-fingerprint deltas (utils/plans.py):
                # "which plan shapes were hot THIS second". Reads the
                # registry only if the store already HAS one — a sampler
                # tick must never be what creates telemetry state
                preg = getattr(store, "_plans", None)
                if preg is not None:
                    from geomesa_tpu_torch.utils import plans as _plans

                    self._prev_plans, prows = _plans.timeline_deltas(
                        preg, self._prev_plans
                    )
                    # first tick primes the baseline, reports nothing
                    # (the counter-delta rule above)
                    if prows and was_primed:
                        snap["plans"] = prows
                # per-tick per-tenant deltas (utils/tenants.py): "whose
                # traffic was THIS second" — same never-creates posture
                treg = getattr(store, "_tenants", None)
                if treg is not None:
                    from geomesa_tpu_torch.utils import tenants as _tenants

                    self._prev_tenants, trows = _tenants.timeline_deltas(
                        treg, self._prev_tenants
                    )
                    if trows and was_primed:
                        snap["tenants"] = trows
                extra = getattr(store, "_timeline_extra", None)
                if extra is not None:
                    snap.update(extra())
                if bblock is not None:
                    snap["brownout"] = bblock
            self._ring.append(snap)
            self.ticks += 1
            return snap

    @staticmethod
    def _cache_rates(deltas: Dict[str, int]) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for label, hits_c, miss_c in _CACHE_RATES:
            hits = deltas.get(hits_c, 0)
            misses = deltas.get(miss_c, 0)
            if hits or misses:
                out[label] = {
                    "hits": hits,
                    "misses": misses,
                    "rate": round(hits / (hits + misses), 3),
                }
        groups = deltas.get("batch.coalesce.groups", 0)
        members = deltas.get("batch.coalesce.members", 0)
        if groups:
            out["coalesce"] = {
                "groups": groups,
                "members": members,
                "mean_group": round(members / groups, 2),
            }
        return out

    # -- ring access ---------------------------------------------------------

    def window(self, s: Optional[float] = None) -> List[Dict[str, Any]]:
        """The last ``s`` seconds of snapshots (oldest first; the whole
        ring when ``s`` is None). Copies under the lock — a concurrent
        tick can never mutate what a reader is serializing."""
        with self._lock:
            snaps = list(self._ring)
        if s is None:
            return snaps
        n = max(1, int(round(float(s) / self.interval_s)))
        return snaps[-n:]

    def payload(self, s: Optional[float] = 60.0) -> Dict[str, Any]:
        """The ring's last ``s`` seconds as one payload."""
        snaps = self.window(s)
        return {
            "enabled": True,
            "interval_s": self.interval_s,
            "window_s": self.window_s,
            "ticks": self.ticks,
            "returned": len(snaps),
            "snapshots": snaps,
        }

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "TimelineSampler":
        if self._thread is not None:
            return self
        self._stop.clear()
        ref = weakref.ref(self)

        def loop():
            # tick-cost compensation: waiting the FULL interval after
            # tick work makes every cycle last interval + tick_cost, so
            # timestamps drift and an hour's ring covers less than an
            # hour. Subtract the previous tick's cost from the wait
            # (floored at 0: a tick slower than the interval ticks
            # again immediately, it cannot wait a negative time).
            elapsed = 0.0
            while True:
                me = ref()
                if me is None:
                    return
                stop, interval = me._stop, me.interval_s
                store_dead = (
                    isinstance(me._store, weakref.ref)
                    and me._store() is None
                )
                del me  # the loop must not pin the sampler between ticks
                if store_dead:
                    return  # telemetry dies with (never outlives) its store
                if stop.wait(max(0.0, interval - elapsed)):
                    return
                me = ref()
                if me is None:
                    return
                t0 = time.monotonic()
                me.tick()
                elapsed = time.monotonic() - t0
                del me

        t = threading.Thread(
            target=loop, name="geomesa-timeline", daemon=True
        )
        self._thread = t
        t.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=2.0)


def merge_worker_ticks(workers: Dict[str, Dict[str, Any]]) -> Dict[str, Any]:
    """Fold per-worker flight-recorder ticks (the fleet ``timeline`` RPC
    replies, parallel/fleet.py) into one fleet-rollup block:

    * **counters** — per-tick deltas SUM across workers (additive by
      construction);
    * **timers** — count/sum_ms sum, latency-bucket histograms merged
      bucket-wise (so the SLO bucket rule applies to the rollup too);
    * **breakers** — only each worker's NON-closed breakers, keyed by
      worker (a silently degrading worker — device breaker open, host
      scans — becomes visible from the coordinator);
    * **unreachable** — workers whose tick did not answer under the
      passive budget;
    * **per_worker** — each reachable worker's UNMERGED counter/timer
      series, keyed by worker. The SLO engine burns these individually:
      a single sick worker must violate its class objective even when
      the fleet-summed histogram dilutes it below threshold (the skew a
      sum can never show).

    Gauges are deliberately NOT rolled up: summing HBM residency or pad
    ratios across processes is a lie; the per-worker blocks keep them."""
    rollup: Dict[str, Any] = {
        "workers": 0,
        "counters": {},
        "timers": {},
        "breakers": {},
        "unreachable": [],
        "per_worker": {},
    }
    counters = rollup["counters"]
    timers = rollup["timers"]
    for wid in sorted(workers):
        row = workers[wid]
        if not isinstance(row, dict) or row.get("unreachable"):
            rollup["unreachable"].append(wid)
            continue
        rollup["workers"] += 1
        tick = row.get("tick") or {}
        w_counters: Dict[str, int] = {}
        w_timers: Dict[str, Any] = {}
        for k, v in (tick.get("counters") or {}).items():
            counters[k] = counters.get(k, 0) + int(v)
            w_counters[k] = int(v)
        for name, t in (tick.get("timers") or {}).items():
            acc = timers.setdefault(
                name, {"count": 0, "sum_ms": 0.0, "hist": {}}
            )
            acc["count"] += int(t.get("count", 0))
            acc["sum_ms"] = round(
                acc["sum_ms"] + float(t.get("sum_ms", 0.0)), 3
            )
            hist = {str(b): int(n) for b, n in (t.get("hist") or {}).items()}
            for b, n in hist.items():
                acc["hist"][b] = acc["hist"].get(b, 0) + n
            w_timers[name] = {
                "count": int(t.get("count", 0)),
                "sum_ms": round(float(t.get("sum_ms", 0.0)), 3),
                "hist": hist,
            }
        if w_counters or w_timers:
            rollup["per_worker"][wid] = {
                "counters": w_counters,
                "timers": w_timers,
            }
        open_b = sorted(
            name
            for name, state in (tick.get("breakers") or {}).items()
            if state != "closed"
        )
        if open_b:
            rollup["breakers"][wid] = open_b
    return rollup


# -- per-store samplers -------------------------------------------------------
#
# One sampler per store, refcounted like trace.ensure_ring: each server
# (web.GeoMesaServer) holds one reference, the last release stops the
# thread and — when no sampler remains anywhere — drops the process-wide
# exemplar flag back to the free-when-off state.

_SAMPLERS: "weakref.WeakKeyDictionary[Any, TimelineSampler]" = (
    weakref.WeakKeyDictionary()
)
_REFS: "weakref.WeakKeyDictionary[Any, int]" = weakref.WeakKeyDictionary()
_SAMPLERS_LOCK = threading.Lock()


def _exemplars_wanted() -> bool:
    from geomesa_tpu_torch.utils.config import SLO_EXEMPLARS

    return bool(SLO_EXEMPLARS.to_bool())


def sampler_for(store, create: bool = True) -> Optional[TimelineSampler]:
    """The store's running sampler; started on first request when
    ``geomesa.timeline.enabled`` (None otherwise, and None with
    ``create=False`` when none exists yet). Starting the first sampler
    also raises the timer-exemplar flag (``geomesa.slo.exemplars``) so
    /debug/slo has traces to link; stopping the last drops it."""
    with _SAMPLERS_LOCK:
        got = _SAMPLERS.get(store)
        if got is not None or not create:
            return got
        enabled, _i, _w = timeline_knobs()
        if not enabled:
            return None
        sampler = TimelineSampler(store)
        _SAMPLERS[store] = sampler
        _REFS[store] = 0
        if _exemplars_wanted():
            audit.set_exemplars(True)
    sampler.start()
    return sampler


def acquire(store) -> Optional[TimelineSampler]:
    """sampler_for + one refcount (a server's hold on the recorder)."""
    got = sampler_for(store)
    if got is not None:
        with _SAMPLERS_LOCK:
            _REFS[store] = _REFS.get(store, 0) + 1
    return got


def release(store) -> None:
    """Drop one server's hold; the last release stops the store's
    sampler and, when no sampler remains for ANY store, restores the
    exemplar hook to its free no-op path."""
    stop_me = None
    with _SAMPLERS_LOCK:
        if store not in _SAMPLERS:
            return
        refs = _REFS.get(store, 0) - 1
        if refs > 0:
            _REFS[store] = refs
            return
        stop_me = _SAMPLERS.pop(store, None)
        _REFS.pop(store, None)
        if not _SAMPLERS:
            audit.set_exemplars(False)
    if stop_me is not None:
        stop_me.stop()
