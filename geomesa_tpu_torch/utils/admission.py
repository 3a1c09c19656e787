"""Admission control: bounded in-flight queries and a bounded wait queue.

Port of ``geomesa_tpu/utils/admission.py`` without the tenant default
priority and the brownout ladder. At most ``max_inflight`` queries run at
once; at most ``max_queue`` more wait for a slot, their wait charged
against their own deadline (``utils/deadline.py``: a query whose budget
dies in the queue raises ``QueryTimeout`` without running); anything
beyond sheds at once with ``ShedLoad``. ``critical_reserve`` slots are
held back from every class but ``critical``. A deadline's cancellation
wakes its queued waiter at once.

``TorchDataStore.query`` admits each query (``query_many`` a batch as one
unit). Sheds count under ``shed.overflow`` / ``shed.queue_timeout`` and
``shed.priority.<class>`` in ``utils.audit.robustness_metrics()``; queue
waits open an ``admit.wait`` span.
"""

from __future__ import annotations

import contextvars
import threading
import time
from typing import Any, Optional

from geomesa_tpu_torch.utils import deadline as deadline_mod
from geomesa_tpu_torch.utils import trace
from geomesa_tpu_torch.utils.audit import QueryTimeout, ShedLoad, robustness_metrics

# priority classes, most- to least-protected
PRIORITIES = ("critical", "interactive", "batch", "background")
PRIORITY_HINT = "geomesa.query.priority"


def default_priority() -> str:
    """The class of a query whose hints name none
    (``geomesa.priority.default``)."""
    from geomesa_tpu_torch.utils.config import PRIORITY_DEFAULT

    raw = PRIORITY_DEFAULT.get()
    raw = raw.strip().lower() if isinstance(raw, str) else ""
    return raw if raw in PRIORITIES else "interactive"


def classify(hints: Any) -> str:
    """A query's priority class from its hints: the ``PRIORITY_HINT``
    value when it names a class, else the default class (an unknown value
    never mints a class)."""
    if isinstance(hints, dict):
        p = hints.get(PRIORITY_HINT)
        if isinstance(p, str):
            p = p.strip().lower()
            if p in PRIORITIES:
                return p
    return default_priority()


class AdmissionController:
    """A counting semaphore and a bounded wait queue over one condition.

    ``with controller.admit(): ...`` around each query."""

    def __init__(self, max_inflight: int, max_queue: int, name: str = "query",
                 critical_reserve: Optional[int] = None):
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
        self.critical_reserve = max(0, int(critical_reserve))
        self._cond = threading.Condition()
        self.inflight = 0
        self.queued = 0
        self.sheds = 0
        # critical waiters queued: a release then wakes every waiter (one
        # notify could land on a waiter whose class limit keeps it asleep)
        self._queued_critical = 0
        # a context that holds a slot of this controller rides it on a
        # nested admit instead of queueing for a second one
        self._ctx_held: contextvars.ContextVar[bool] = contextvars.ContextVar(
            "admission_held_" + name, default=False)

    def admit(self, budget_s: Optional[float] = None, priority: Optional[str] = None) -> "_Admit":
        """Context manager around one query (or one batch). ``budget_s``
        bounds the queue wait of a caller with no ambient deadline;
        ``priority`` is one of ``PRIORITIES`` (None: the default class)."""
        if priority is None or priority not in PRIORITIES:
            priority = default_priority()
        return _Admit(self, budget_s, priority)

    def _limit_for(self, priority: str) -> int:
        """The in-flight ceiling of a class: critical fills every slot,
        the rest stop ``critical_reserve`` short when the gate can spare
        them."""
        if priority == "critical" or self.critical_reserve <= 0:
            return self.max_inflight
        if self.max_inflight > self.critical_reserve:
            return self.max_inflight - self.critical_reserve
        return self.max_inflight

    def _shed_locked(self, priority: str) -> None:
        self.sheds += 1
        m = robustness_metrics()
        m.inc("shed.overflow")
        m.inc(f"shed.priority.{priority}")
        trace.event("shed.overflow", inflight=self.inflight, queued=self.queued,
                    max_queue=self.max_queue, priority=priority)
        raise ShedLoad(
            f"admission refused: {self.inflight} queries in flight (max {self.max_inflight}) "
            f"and the wait queue is full ({self.queued}/{self.max_queue}): retry after backoff")

    def _overflow_locked(self, priority: str) -> bool:
        """Queue full: a critical admit sheds only when the queue is full
        of critical waiters."""
        if priority == "critical":
            return self._queued_critical >= self.max_queue
        return self.queued >= self.max_queue

    def _acquire(self, priority: str = "interactive") -> None:
        limit = self._limit_for(priority)
        with self._cond:
            # fast path: a free slot and nobody queued ahead
            if self.queued == 0 and self.inflight < limit:
                self.inflight += 1
                return
            if self._overflow_locked(priority):
                self._shed_locked(priority)
        # contended: wait in the queue, charged against this query's budget
        dl = deadline_mod.ambient()
        t0 = time.perf_counter()
        with trace.span("admit.wait") as sp:
            unregister = dl.on_cancel(self._wake_waiters) if dl is not None else None
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
                                robustness_metrics().inc("shed.queue_timeout")
                                trace.event("deadline.exceeded", point="admit.wait")
                                raise QueryTimeout(
                                    "query budget exhausted after "
                                    f"{time.perf_counter() - t0:.3f}s in the admission queue "
                                    "(never executed)")
                            self._cond.wait(timeout=left)
                        self.inflight += 1
                    except BaseException:
                        # pass the baton: a release's one notify may have
                        # been meant for this waiter, which leaves
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
                sp.set_attr("waited_ms", (time.perf_counter() - t0) * 1000.0)

    def _release(self) -> None:
        with self._cond:
            self.inflight -= 1
            if self._queued_critical > 0:
                self._cond.notify_all()
            else:
                self._cond.notify()

    def _wake_waiters(self) -> None:
        """A deadline's cancellation: every waiter re-checks its own."""
        with self._cond:
            self._cond.notify_all()


class _Admit:
    """The ``admit()`` context manager."""

    __slots__ = ("_ctl", "_held", "_budget_s", "_token", "_priority")

    def __init__(self, ctl: AdmissionController, budget_s: Optional[float] = None,
                 priority: str = "interactive"):
        self._ctl = ctl
        self._held = False
        self._budget_s = budget_s
        self._priority = priority
        self._token: Optional[contextvars.Token] = None

    def __enter__(self) -> "_Admit":
        ctl = self._ctl
        if ctl._ctx_held.get():
            return self  # this context holds a slot already: ride it
        if self._budget_s is not None and deadline_mod.ambient() is None:
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
            self._ctl._release()
        return False
