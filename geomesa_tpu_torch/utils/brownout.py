"""The brownout ladder: deterministic, priority-aware shedding under
sustained overload.

Port of ``geomesa_tpu/utils/brownout.py``. Each timeline tick
(``utils/timeline.py``) folds the SLO verdicts (``utils/slo.py``), the
admission queue's fill and the open breakers into a target level, and the
ladder steps one rung toward it:

* **0** normal, the controller a no-op;
* **1** sheds ``background`` queries;
* **2** sheds ``batch`` too, and turns off speculative work: hedged
  requests and cold pyramid builds (the exact paths answer, identically);
* **3** fail-fast: classes below ``critical`` shed instead of queueing;
  ``critical`` still queues and is never shed.

Levels enter after ``geomesa.brownout.enter.ticks`` ticks over target and
exit after ``exit.ticks`` ticks under it. Every transition is a
reason-coded ``decision("brownout", ...)``; a shed query raises
``ShedLoad`` with a burn-derived ``retry_after_s``. No level changes an
answer. ``geomesa.brownout.enabled=false`` leaves one cached flag read on
each hook. Until the port has the durable telemetry spool, a transition
is recorded in the controller's own history only.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Any, Dict, List, Optional

from geomesa_tpu_torch.utils.audit import decision, robustness_metrics

# priority class -> the lowest brownout level that sheds it. critical
# and interactive are absent: interactive is never SHED outright (level
# 3 only stops it queueing), critical is never touched at any level.
_SHED_AT = {"background": 1, "batch": 2}
# the level that turns off hedging and cold speculative builds
_SPECULATION_OFF_LEVEL = 2
# the level that stops non-critical classes from queueing (fail-fast)
_FAIL_FAST_LEVEL = 3
_MAX_LEVEL = 3
# Retry-After ceiling: past a minute the client should re-resolve, not
# nap — and an absurd burn rate must not produce an absurd header
_RETRY_AFTER_CAP_S = 60.0

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
    from geomesa_tpu_torch.utils.config import BROWNOUT_ENABLED

    _ENABLED = bool(BROWNOUT_ENABLED.to_bool())
    return _ENABLED


def set_enabled(on: Optional[bool]) -> None:
    """Flip the cached flag (``None`` re-resolves on the next read)."""
    global _ENABLED
    _ENABLED = None if on is None else bool(on)


def brownout_knobs() -> tuple:
    """(enter_ticks, exit_ticks, r1, r2, r3, retry_after_floor_s) from
    the geomesa.brownout.* tier. Explicit 0 enter/exit means "act on the
    first tick" — never ``or``-defaulted."""
    from geomesa_tpu_torch.utils.config import (
        BROWNOUT_ENTER_TICKS,
        BROWNOUT_EXIT_TICKS,
        BROWNOUT_QUEUE_RATIO_1,
        BROWNOUT_QUEUE_RATIO_2,
        BROWNOUT_QUEUE_RATIO_3,
        BROWNOUT_RETRY_AFTER_S,
    )

    et = BROWNOUT_ENTER_TICKS.to_int()
    xt = BROWNOUT_EXIT_TICKS.to_int()
    r1 = BROWNOUT_QUEUE_RATIO_1.to_float()
    r2 = BROWNOUT_QUEUE_RATIO_2.to_float()
    r3 = BROWNOUT_QUEUE_RATIO_3.to_float()
    ra = BROWNOUT_RETRY_AFTER_S.to_float()
    return (
        2 if et is None else max(1, et),
        3 if xt is None else max(1, xt),
        0.5 if r1 is None else r1,
        0.75 if r2 is None else r2,
        0.95 if r3 is None else r3,
        1.0 if ra is None else max(0.0, ra),
    )


class BrownoutController:
    """One store's ladder state. ``on_tick`` is the only writer (driven
    by the store's timeline sampler, one thread); the query-path readers
    (``should_shed`` / ``queue_allowed`` / ``hedging_allowed`` /
    ``speculation_allowed``) are plain attribute reads — the gate costs
    nothing while the level sits at 0."""

    def __init__(self) -> None:
        self.level = 0
        self.since: Optional[float] = None  # wall time of the last raise
        self._enter_streak = 0
        self._exit_streak = 0
        self._retry_after_s: Optional[float] = None
        self._last_signals: Dict[str, Any] = {}
        self._lock = threading.Lock()
        self._history: List[Dict[str, Any]] = []  # recent transitions

    # -- query-path reads (hot; no locks) ------------------------------------

    def should_shed(self, priority: str) -> bool:
        """True when the active level sheds this priority class."""
        return self.level >= _SHED_AT.get(priority, _MAX_LEVEL + 1)

    def queue_allowed(self, priority: str) -> bool:
        """False at the fail-fast level for non-critical classes: shed
        now rather than queue behind a burn that isn't draining."""
        return priority == "critical" or self.level < _FAIL_FAST_LEVEL

    def hedging_allowed(self) -> bool:
        """Hedged shard requests re-issue work — exactly the amplifier
        to turn off while overloaded."""
        return self.level < _SPECULATION_OFF_LEVEL

    def speculation_allowed(self) -> bool:
        """Cold pyramid builds and device join-build uploads are
        throughput optimizations with exact fallbacks — deferred, not
        lost, while the ladder is at the speculation-off level."""
        return self.level < _SPECULATION_OFF_LEVEL

    def shedding_classes(self) -> List[str]:
        """The classes the active level refuses outright — the health
        naming (fail-fast interactive refusals surface separately, as
        level 3 itself)."""
        lvl = self.level
        return [p for p in ("batch", "background") if lvl >= _SHED_AT[p]]

    def retry_after_s(self) -> float:
        """The burn-derived backoff shed responses carry: the worst
        violating fast-window burn rate, in whole seconds (a client of a
        14x burn waits ~14s; a queue-only brownout waits the floor)."""
        ra = self._retry_after_s
        if ra is not None:
            return ra
        return brownout_knobs()[5] or 1.0

    # -- the tick (single writer) --------------------------------------------

    def on_tick(self, store: Any) -> Optional[Dict[str, Any]]:
        """Fold this second's overload signals into the ladder. Called
        from the timeline sampler's tick with the flag already checked;
        returns the tick's brownout block (embedded in the snapshot) or
        None when the controller has nothing to report AND is at level 0.
        Never raises — the sampler's passive contract."""
        try:
            return self._tick_locked(store)
        except Exception:  # noqa: BLE001 - the recorder outlives bad signals
            return None

    def _tick_locked(self, store: Any) -> Optional[Dict[str, Any]]:
        from geomesa_tpu_torch.utils import slo as slo_mod
        from geomesa_tpu_torch.utils.breaker import peek_states

        enter_ticks, exit_ticks, r1, r2, r3, ra_floor = brownout_knobs()
        # signal 1: admission queue depth (lock-free peek)
        ratio = 0.0
        adm = getattr(store, "admission", None)
        if adm is not None and adm.max_queue > 0:
            ratio = adm.peek().get("queued", 0) / float(adm.max_queue)
        # signal 2: SLO burn (create=False — a tick must never be what
        # spawns telemetry state; without an engine the signal is quiet)
        violating: List[str] = []
        max_burn = 0.0
        eng = slo_mod.engine_for(store, create=False)
        if eng is not None:
            ev = eng.evaluate(exemplars=False)
            violating = ev.get("violating", [])
            for row in ev.get("slos", ()):
                if row.get("violating"):
                    max_burn = max(
                        max_burn, row.get("fast", {}).get("burn_rate", 0.0)
                    )
        # signal 3: open breakers (passive peek — no transitions)
        open_breakers = sorted(
            n for n, st in peek_states().items() if st == "open"
        )
        # deterministic target: queue depth sets the base rung, a
        # burning SLO escalates one rung past it (latency is hurting
        # even where the queue isn't deep yet), open breakers under
        # pressure force at least the speculation-off rung (stop
        # re-issuing work against a fabric that is already failing)
        target = 0
        if ratio >= r1:
            target = 1
        if ratio >= r2:
            target = 2
        if ratio >= r3:
            target = 3
        if violating:
            target = min(_MAX_LEVEL, target + 1) if target else 1
        if open_breakers and target:
            target = max(target, _SPECULATION_OFF_LEVEL)
        with self._lock:
            self._retry_after_s = (
                max(ra_floor, min(_RETRY_AFTER_CAP_S, math.ceil(max_burn)))
                if max_burn > 0.0
                else max(1.0, ra_floor)
            )
            self._last_signals = {
                "queue_ratio": round(ratio, 3),
                "slo_violating": violating,
                "open_breakers": open_breakers,
                "target": target,
            }
            if target > self.level:
                self._enter_streak += 1
                self._exit_streak = 0
                if self._enter_streak >= enter_ticks:
                    self._transition(store, self.level + 1, target)
                    self._enter_streak = 0
            elif target < self.level:
                self._exit_streak += 1
                self._enter_streak = 0
                if self._exit_streak >= exit_ticks:
                    self._transition(store, self.level - 1, target)
                    self._exit_streak = 0
            else:
                self._enter_streak = 0
                self._exit_streak = 0
            if self.level == 0 and target == 0 and not self._history:
                return None  # quiet store: the tick stays byte-identical
            return self._block_locked()

    def _transition(self, store: Any, new_level: int, target: int) -> None:
        """One rung up or down: reason-coded decision, history record,
        counters. Runs under the controller lock on the sampler
        thread."""
        old = self.level
        self.level = new_level
        self.since = time.time() if new_level > 0 else None
        reason = "raise" if new_level > old else "lower"
        sig = self._last_signals
        decision(
            "brownout",
            reason,
            level=new_level,
            target=target,
            queue_ratio=sig.get("queue_ratio"),
            slo=",".join(sig.get("slo_violating", ())[:4]),
            breakers=len(sig.get("open_breakers", ())),
        )
        robustness_metrics().inc(f"brownout.level.{new_level}")
        rec = {
            "kind": "brownout",
            "t": time.time(),
            "level": new_level,
            "from": old,
            "target": target,
            **{k: v for k, v in sig.items() if k != "target"},
        }
        self._history.append(rec)
        del self._history[:-16]

    # -- observability -------------------------------------------------------

    def _block_locked(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "level": self.level,
            **self._last_signals,
        }
        if self.since is not None:
            out["since"] = round(self.since, 3)
        out["retry_after_s"] = self._retry_after_s
        return out

    def snapshot(self) -> Dict[str, Any]:
        """The ladder as one payload: the live state, the signals
        the last tick saw, the sheds-by-class counters, and the recent
        transition history."""
        counters, _g, _t, _tt = robustness_metrics().snapshot()
        with self._lock:
            return {
                "enabled": enabled(),
                "level": self.level,
                "since": self.since,
                "signals": dict(self._last_signals),
                "retry_after_s": self._retry_after_s,
                "enter_streak": self._enter_streak,
                "exit_streak": self._exit_streak,
                "transitions": list(self._history),
                "counters": {
                    k: v
                    for k, v in sorted(counters.items())
                    if k.startswith(("brownout.", "shed.priority."))
                },
            }


def controller_for(store: Any) -> Optional[BrownoutController]:
    """The store's controller, or None — the duck-typed accessor the
    web/timeline surfaces share (workers' partition sub-stores have no
    controller of their own; the coordinator's decides)."""
    return getattr(store, "_brownout", None)
