"""Admission control: bounded in-flight queries and a bounded wait queue.

Port of ``geomesa_tpu/utils/admission.py``. At most ``max_inflight``
queries run at once; at most ``max_queue`` more wait for a slot, their
wait charged against their own deadline (``utils/deadline.py``: a query
whose budget dies in the queue raises ``QueryTimeout`` without running);
anything beyond sheds at once with ``ShedLoad``. ``critical_reserve``
slots are held back from every class but ``critical``. A deadline's
cancellation wakes its queued waiter at once.

A query's class (``classify``) is its ``geomesa.query.priority`` hint,
else its tenant's default (``geomesa.tenants.priority``,
``utils/tenants.py``), else ``geomesa.priority.default``. The store
attaches its brownout ladder (``utils/brownout.py``) as ``brownout``: a
class the active level sheds is refused before any slot bookkeeping, and
at the fail-fast level a class below ``critical`` that would queue sheds
instead.

``TorchDataStore.query`` admits each query (``query_many`` a batch as one
unit). Sheds count under ``shed.overflow`` / ``shed.queue_timeout`` /
``shed.brownout`` and ``shed.priority.<class>`` in
``utils.audit.robustness_metrics()``; queue waits open an ``admit.wait``
span; ``peek`` is the timeline's lock-free read and ``snapshot`` the
per-class wait summaries.
"""

from __future__ import annotations

import contextvars
import threading
import time
from collections import deque
from typing import Any, Dict, Optional

from geomesa_tpu_torch.utils import deadline as deadline_mod
from geomesa_tpu_torch.utils import trace
from geomesa_tpu_torch.utils.audit import (
    QueryTimeout,
    ShedLoad,
    decision,
    histogram_summary,
    robustness_metrics,
)

# /healthz reports "degraded" while a shed happened within this window
_RECENT_SHED_S = 30.0

# sliding reservoir of recent admission waits (seconds; 0.0 = fast
# path). Sized so the /debug/overload p50/p99 reflect the last few
# thousand admissions — enough to explain a shed burst post-hoc without
# unbounded memory
_WAIT_RESERVOIR = 2048
# the per-priority reservoirs are smaller: four of them, and each only
# has to explain ONE class's starvation, not the whole gate's history
_PRI_WAIT_RESERVOIR = 512

# -- priority classes ---------------------------------------------------------
#
# Every query / join / aggregate / stream carries one of four priority
# classes, ordered most- to least-protected. Classification (classify)
# is: explicit `geomesa.query.priority` hint (web.py maps the
# X-Geomesa-Priority header into it) > the tenant's configured default
# (geomesa.tenants.priority, utils/tenants.py) > geomesa.priority.default.
# The class decides who the critical-reserve floor protects, which rung
# of the brownout ladder (utils/brownout.py) sheds the query, and which
# per-class wait histogram its queue time lands in.

PRIORITIES = ("critical", "interactive", "batch", "background")
PRIORITY_HINT = "geomesa.query.priority"

_DEFAULT_PRIORITY: Optional[str] = None


def default_priority() -> str:
    """The class for unhinted, unmapped traffic — cached (the module
    flag posture: one global read on the per-query path)."""
    p = _DEFAULT_PRIORITY
    if p is None:
        return _resolve_default_priority()
    return p


def _resolve_default_priority() -> str:
    global _DEFAULT_PRIORITY
    from geomesa_tpu_torch.utils.config import PRIORITY_DEFAULT

    raw = PRIORITY_DEFAULT.get()
    raw = raw.strip().lower() if isinstance(raw, str) else ""
    _DEFAULT_PRIORITY = raw if raw in PRIORITIES else "interactive"
    return _DEFAULT_PRIORITY


def reset_default_priority() -> None:
    """Drop the cached default (re-resolved on the next classify) — for
    tests and config reloads that flip ``geomesa.priority.default``."""
    global _DEFAULT_PRIORITY
    _DEFAULT_PRIORITY = None


def classify(hints: Any) -> str:
    """One query's priority class from its hints dict (or None). An
    unknown/garbage hint value falls through — an external caller must
    never mint a fifth class or escalate by typo."""
    if isinstance(hints, dict):
        p = hints.get(PRIORITY_HINT)
        if isinstance(p, str):
            p = p.strip().lower()
            if p in PRIORITIES:
                return p
        t = hints.get("tenant")
        if t is not None:
            from geomesa_tpu_torch.utils import tenants as tenants_mod

            tp = tenants_mod.default_priority(tenants_mod.clean_label(t))
            if tp is not None:
                return tp
    return default_priority()


class AdmissionController:
    """Counting semaphore + bounded FIFO-ish wait queue over one lock.

    ``with controller.admit(): ...`` around each query. Waiters are
    charged against their ambient deadline; overflow sheds instantly."""

    def __init__(
        self,
        max_inflight: int,
        max_queue: int,
        name: str = "query",
        critical_reserve: Optional[int] = None,
    ):
        if max_inflight < 1:
            raise ValueError("max_inflight must be >= 1")
        if max_queue < 0:
            raise ValueError("max_queue must be >= 0")
        self.max_inflight = int(max_inflight)
        self.max_queue = int(max_queue)
        self.name = name
        if critical_reserve is None:
            from geomesa_tpu_torch.utils.config import ADMISSION_CRITICAL_RESERVE

            cr = ADMISSION_CRITICAL_RESERVE.to_int()
            critical_reserve = 1 if cr is None else cr
        # the critical floor: this many in-flight slots are held back
        # from NON-critical classes, so a background flood can never
        # starve critical traffic even while healthy. A gate too small
        # to spare a slot (max_inflight <= reserve) keeps no floor — the
        # only slot cannot be reserved away from ALL regular traffic.
        self.critical_reserve = max(0, int(critical_reserve))
        # the brownout ladder (utils/brownout.py), attached by the
        # owning store; None (workers' partition sub-stores, bare
        # controllers) means no brownout gate on this controller
        self.brownout = None
        self._cond = threading.Condition()
        self.inflight = 0
        self.queued = 0
        self.sheds = 0
        self.admitted = 0  # cumulative successful admissions
        self._waits: deque = deque(maxlen=_WAIT_RESERVOIR)  # seconds
        self._last_shed: Optional[float] = None
        # per-priority accounting (the starvation-visibility satellite):
        # in-flight splits, cumulative admits/sheds, and per-class wait
        # reservoirs — all mutated under the condition lock
        self.pri_inflight: Dict[str, int] = {p: 0 for p in PRIORITIES}
        self.pri_admitted: Dict[str, int] = {p: 0 for p in PRIORITIES}
        self.pri_sheds: Dict[str, int] = {p: 0 for p in PRIORITIES}
        self._pri_waits: Dict[str, deque] = {
            p: deque(maxlen=_PRI_WAIT_RESERVOIR) for p in PRIORITIES
        }
        # critical waiters currently queued: _release must notify_all
        # while one waits (a single notify could land on a non-critical
        # waiter whose reserve-shrunk limit keeps it asleep, losing the
        # wakeup the critical waiter needed)
        self._queued_critical = 0
        # context-local reentrancy: a caller that already holds a slot
        # from THIS controller (query_join admits once around the whole
        # join) must not queue for a second one — at max_inflight=1 that
        # would deadlock the join against itself. Inner admits ride the
        # outer slot; distinct controllers (per-shard workers) still
        # admit independently.
        self._ctx_held: contextvars.ContextVar[bool] = contextvars.ContextVar(
            "admission_held_" + name, default=False
        )

    def admit(
        self,
        budget_s: Optional[float] = None,
        priority: Optional[str] = None,
    ) -> "_Admit":
        """Context manager around one query (or one batch). ``budget_s``
        bounds the QUEUE WAIT for callers that haven't installed an
        ambient deadline yet (query_many admits before its per-query
        budgets exist); with an ambient deadline active it is ignored —
        the query's own budget already charges the wait. ``priority`` is
        one of ``PRIORITIES`` (callers classify() from the query hints);
        None means the configured default class."""
        if priority is None or priority not in PRIORITIES:
            priority = default_priority()
        return _Admit(self, budget_s, priority)

    # -- internals -----------------------------------------------------------

    def _limit_for(self, priority: str) -> int:
        """The in-flight ceiling this class may fill: critical uses
        every slot; the rest stop ``critical_reserve`` short of it
        (when the gate is large enough to spare any)."""
        if priority == "critical" or self.critical_reserve <= 0:
            return self.max_inflight
        if self.max_inflight > self.critical_reserve:
            return self.max_inflight - self.critical_reserve
        return self.max_inflight

    def _shed_locked(self, priority: str) -> None:
        self.sheds += 1
        self.pri_sheds[priority] += 1
        self._last_shed = time.monotonic()
        m = robustness_metrics()
        m.inc("shed.overflow")
        m.inc(f"shed.priority.{priority}")
        trace.event(
            "shed.overflow",
            inflight=self.inflight,
            queued=self.queued,
            max_queue=self.max_queue,
            priority=priority,
        )
        raise ShedLoad(
            f"admission refused: {self.inflight} queries in flight "
            f"(max {self.max_inflight}) and the wait queue is full "
            f"({self.queued}/{self.max_queue}) — retry after backoff"
        )

    def _brownout_shed(self, priority: str, level: int,
                       retry_after_s: float, fail_fast: bool) -> None:
        """One brownout-ladder shed (utils/brownout.py): reason-coded,
        counted per class, and carrying the burn-derived Retry-After.
        ``fail_fast`` marks the level-3 refuse-to-queue form (the class
        is still nominally served — a free slot would have admitted
        it)."""
        with self._cond:
            self.sheds += 1
            self.pri_sheds[priority] += 1
            self._last_shed = time.monotonic()
        m = robustness_metrics()
        m.inc("shed.brownout")
        m.inc(f"shed.priority.{priority}")
        reason = "fail_fast" if fail_fast else "shed"
        decision("brownout", reason, priority=priority, level=level)
        trace.event(
            "shed.brownout", priority=priority, level=level,
            fail_fast=fail_fast,
        )
        err = ShedLoad(
            f"brownout level {level} "
            + ("refuses to queue" if fail_fast else "sheds")
            + f" {priority}-class queries — retry after backoff"
        )
        err.retry_after_s = retry_after_s
        raise err

    def _overflow_locked(self, priority: str) -> bool:
        """The queue-full predicate, priority-aware: lower-class waiters
        may not crowd critical out of the queue — a critical admit sheds
        only when the queue is full OF critical waiters (so the total
        queue stays bounded at 2x max_queue in the worst case, and a
        background flood can never cost critical-class availability)."""
        if priority == "critical":
            return self._queued_critical >= self.max_queue
        return self.queued >= self.max_queue

    def _acquire(self, priority: str = "interactive") -> None:
        limit = self._limit_for(priority)
        with self._cond:
            # fast path: a free slot and nobody ahead of us in the queue
            if self.queued == 0 and self.inflight < limit:
                self.inflight += 1
                self.admitted += 1
                self.pri_inflight[priority] += 1
                self.pri_admitted[priority] += 1
                self._waits.append(0.0)
                self._pri_waits[priority].append(0.0)
                return
            if self._overflow_locked(priority):
                self._shed_locked(priority)
        # fail-fast rung of the brownout ladder: a non-critical query
        # that would QUEUE sheds instead — at level 3 the queue is pure
        # added latency for traffic the burn isn't draining (the gate
        # sits outside the lock: level is a plain read, and the shed
        # path takes the lock itself)
        bo = self.brownout
        if bo is not None and bo.level > 0 and not bo.queue_allowed(priority):
            from geomesa_tpu_torch.utils import brownout as brownout_mod

            if brownout_mod.enabled():
                self._brownout_shed(
                    priority, bo.level, bo.retry_after_s(), fail_fast=True
                )
        # contended: wait with the queue, the wait charged against THIS
        # query's deadline (queue time is query time)
        dl = deadline_mod.ambient()
        t0 = time.perf_counter()
        with trace.span("admit.wait") as sp:
            # cancellation wakes the wait via the deadline's on_cancel
            # hook (a hedge loser must stop holding a queue slot the
            # moment the winner answers — the former 100 ms poll tick
            # was a per-queued-member p99 tax under coalescing)
            unregister = (
                dl.on_cancel(self._wake_waiters) if dl is not None else None
            )
            try:
                with self._cond:
                    if self._overflow_locked(priority):
                        self._shed_locked(priority)
                    self.queued += 1
                    if priority == "critical":
                        self._queued_critical += 1
                    try:
                        while self.inflight >= limit:
                            if dl is not None and dl.is_cancelled:
                                dl.check("admit.wait")
                            left = None if dl is None else dl.remaining()
                            if left is not None and left <= 0.0:
                                self._last_shed = time.monotonic()
                                robustness_metrics().inc("shed.queue_timeout")
                                trace.event(
                                    "deadline.exceeded", point="admit.wait",
                                )
                                raise QueryTimeout(
                                    "query budget exhausted after "
                                    f"{time.perf_counter() - t0:.3f}s in the "
                                    "admission queue (never executed)"
                                )
                            self._cond.wait(timeout=left)
                        self.inflight += 1
                        self.admitted += 1
                        self.pri_inflight[priority] += 1
                        self.pri_admitted[priority] += 1
                        self._waits.append(time.perf_counter() - t0)
                        self._pri_waits[priority].append(
                            time.perf_counter() - t0
                        )
                    except BaseException:
                        # pass the baton: _release notifies ONE waiter,
                        # and that notify may have been meant for us — a
                        # waiter leaving on timeout/cancellation must
                        # hand the freed slot to the next in line (the
                        # old poll tick masked this lost-wakeup; the
                        # wakeup-driven wait cannot)
                        self._cond.notify()
                        raise
                    finally:
                        self.queued -= 1
                        if priority == "critical":
                            self._queued_critical -= 1
            finally:
                if unregister is not None:
                    unregister()
            if sp.recording:
                sp.set_attr(
                    "waited_ms", (time.perf_counter() - t0) * 1000.0
                )

    def _release(self, priority: str = "interactive") -> None:
        with self._cond:
            self.inflight -= 1
            self.pri_inflight[priority] -= 1
            if self._queued_critical > 0:
                # a single notify could land on a non-critical waiter
                # whose reserve-shrunk limit keeps it asleep — and a
                # sleeping waiter re-notifies nobody, losing the wakeup
                # the critical waiter needed. Wake everyone: the
                # ineligible re-check and re-sleep; bounded by the queue
                self._cond.notify_all()
            else:
                self._cond.notify()

    def _wake_waiters(self) -> None:
        """Deadline-cancellation wakeup: notify EVERY waiter (the
        cancelled one re-checks is_cancelled and leaves; the rest go
        straight back to sleep with their remaining-budget timeouts)."""
        with self._cond:
            self._cond.notify_all()

    # -- observability -------------------------------------------------------

    def peek(self) -> Dict[str, int]:
        """LOCK-FREE point read of the admission depth for the telemetry
        timeline sampler (utils/timeline.py): plain attribute reads, so
        the sampler can never contend with — let alone hold — the
        admission queue's condition lock. The ints may tear across each
        other under concurrency (a snapshot one query out of date), which
        is fine for a per-second flight recorder."""
        peek: Dict[str, Any] = {
            "inflight": self.inflight,
            "queued": self.queued,
            "sheds": self.sheds,
            "admitted": self.admitted,
            # capacity rides along so a COORDINATOR reading a worker's
            # peek over the wire can judge saturation (inflight at the
            # ceiling with queries queuing) without a second RPC —
            # parallel/shards.py routes around such workers pre-dispatch
            "max_inflight": self.max_inflight,
            "max_queue": self.max_queue,
        }
        pri = {p: n for p, n in self.pri_inflight.items() if n}
        if pri:
            peek["priority"] = pri
        return peek

    def recently_shedding(self, window_s: float = _RECENT_SHED_S) -> bool:
        last = self._last_shed
        return last is not None and time.monotonic() - last < window_s

    def snapshot(self) -> Dict[str, Any]:
        with self._cond:
            # wait-time summary over the recent reservoir (fast-path
            # admissions count as 0.0 waits): p50/p99 beside the shed
            # counters make a shed burst explainable post-hoc — were
            # queries queuing long before we refused, or did traffic
            # spike straight past the queue?
            waits = (
                histogram_summary(list(self._waits), total_count=self.admitted)
                if self._waits else None
            )
            # per-class wait summaries answer the starvation question
            # directly: a background flood shows up as background p99
            # exploding while critical p99 stays flat (the reserve
            # holding) — one blended histogram can't distinguish the two
            priority: Dict[str, Any] = {}
            for p in PRIORITIES:
                if not (
                    self.pri_admitted[p]
                    or self.pri_inflight[p]
                    or self.pri_sheds[p]
                ):
                    continue
                pw = self._pri_waits[p]
                priority[p] = {
                    "inflight": self.pri_inflight[p],
                    "admitted": self.pri_admitted[p],
                    "sheds": self.pri_sheds[p],
                    "wait_ms": (
                        histogram_summary(
                            list(pw), total_count=self.pri_admitted[p]
                        )
                        if pw else None
                    ),
                }
            return {
                "inflight": self.inflight,
                "queued": self.queued,
                "max_inflight": self.max_inflight,
                "max_queue": self.max_queue,
                "critical_reserve": self.critical_reserve,
                "sheds": self.sheds,
                "admitted": self.admitted,
                "wait_ms": waits,
                "recently_shedding": self.recently_shedding(),
                "priority": priority,
            }


class _Admit:
    """The admit() context manager (split out so admit() itself stays
    cheap to call and re-enterable per query)."""

    __slots__ = ("_ctl", "_held", "_budget_s", "_token", "_priority")

    def __init__(
        self,
        ctl: AdmissionController,
        budget_s: Optional[float] = None,
        priority: str = "interactive",
    ):
        self._ctl = ctl
        self._held = False
        self._budget_s = budget_s
        self._priority = priority
        self._token: Optional[contextvars.Token] = None

    def __enter__(self) -> "_Admit":
        ctl = self._ctl
        if ctl._ctx_held.get():
            # this context already holds a slot on this controller:
            # ride it (no second slot, no self-deadlock)
            return self
        # brownout gate BEFORE any slot/queue bookkeeping: a shed class
        # is refused in O(1) with a burn-derived Retry-After (the whole
        # point — overload degrades to fast honest 503s, not queueing).
        # One plain attribute read when no controller is wired, so the
        # brownout-disabled path stays byte-identical to today
        bo = ctl.brownout
        if bo is not None and bo.level > 0 and bo.should_shed(self._priority):
            from geomesa_tpu_torch.utils import brownout as brownout_mod

            if brownout_mod.enabled():
                ctl._brownout_shed(
                    self._priority, bo.level, bo.retry_after_s(),
                    fail_fast=False,
                )
        if self._budget_s is not None and deadline_mod.ambient() is None:
            # bound the wait itself; the budget deliberately does NOT
            # extend over the admitted work (query_many installs its own
            # per-phase budgets after admission)
            with deadline_mod.budget(self._budget_s):
                ctl._acquire(self._priority)
        else:
            ctl._acquire(self._priority)
        self._held = True
        self._token = ctl._ctx_held.set(True)
        return self

    def __exit__(self, *exc) -> bool:
        if self._token is not None:
            self._ctl._ctx_held.reset(self._token)
            self._token = None
        if self._held:
            self._held = False
            self._ctl._release(self._priority)
        return False
