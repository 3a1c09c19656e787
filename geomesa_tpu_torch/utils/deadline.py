"""Per-query deadlines: a budget that travels with the query.

Port of ``geomesa_tpu/utils/deadline.py``. The budget rides in a
``contextvars`` value (``budget`` opens one, ``attach`` installs an
existing one in another thread) and every boundary that can stall checks
it cooperatively: ``check(point)`` raises ``QueryTimeout`` once the budget
is gone or the deadline was cancelled, so a timed-out query fails crisply
and never returns a truncated result. With no deadline installed every
helper is one ContextVar read. Exceeded budgets count under
``deadline.exceeded`` (cancellations under ``deadline.cancelled``) in
``utils.audit.robustness_metrics()`` and land on the query's span as an
event.
"""

from __future__ import annotations

import contextvars
import threading
import time
from contextlib import contextmanager
from typing import Optional

from geomesa_tpu_torch.utils import trace
from geomesa_tpu_torch.utils.audit import QueryTimeout, robustness_metrics

_CURRENT: contextvars.ContextVar[Optional["Deadline"]] = contextvars.ContextVar(
    "geomesa_tpu_torch_deadline", default=None)

# guards every Deadline's cancel-callback list (cancel() fires the
# callbacks outside it)
_CANCEL_LOCK = threading.Lock()


class Deadline:
    """One query's budget: an absolute monotonic expiry and the budget it
    came from. Also a cancellation handle: ``cancel()`` makes every later
    ``check()`` raise, of this deadline and of any nested inside it, and
    wakes the blocked waits that registered ``on_cancel``."""

    __slots__ = ("budget_s", "t_end", "cancelled", "_outer", "_on_cancel")

    def __init__(self, budget_s: float, t_end: Optional[float] = None,
                 outer: Optional["Deadline"] = None):
        self.budget_s = float(budget_s)
        self.t_end = time.monotonic() + self.budget_s if t_end is None else float(t_end)
        self.cancelled = False
        self._outer = outer
        self._on_cancel: Optional[list] = None

    def remaining(self) -> float:
        """Seconds of budget left (negative once expired)."""
        return self.t_end - time.monotonic()

    def cancel(self) -> None:
        """Mark the work unwanted and fire the registered wakeups."""
        self.cancelled = True
        with _CANCEL_LOCK:
            fns = list(self._on_cancel or ())
        for fn in fns:
            fn()

    def on_cancel(self, fn):
        """Register a wakeup for the cancellation of this deadline or of
        any enclosing one (it fires at once when one is already cancelled).
        Keep ``fn`` tiny and non-blocking. Returns the unregister callable,
        which a blocked wait calls in a ``finally``."""
        chain = []
        fire_now = False
        with _CANCEL_LOCK:
            d = self
            while d is not None:
                if d.cancelled:
                    fire_now = True
                    break
                if d._on_cancel is None:
                    d._on_cancel = []
                d._on_cancel.append(fn)
                chain.append(d)
                d = d._outer
        if fire_now:
            fn()

        def unregister() -> None:
            with _CANCEL_LOCK:
                for d in chain:
                    try:
                        d._on_cancel.remove(fn)
                    except (AttributeError, ValueError):
                        pass

        return unregister

    @property
    def is_cancelled(self) -> bool:
        """Cancelled directly or through an enclosing deadline."""
        d = self
        while d is not None:
            if d.cancelled:
                return True
            d = d._outer
        return False

    def check(self, point: str = "") -> None:
        """Raise ``QueryTimeout`` when cancelled or out of budget; ``point``
        names the boundary that noticed."""
        where = f" at {point}" if point else ""
        if self.is_cancelled:
            robustness_metrics().inc("deadline.cancelled")
            trace.event("deadline.cancelled", point=point)
            raise QueryTimeout(f"scan cancelled{where}")
        if self.t_end - time.monotonic() > 0.0:
            return
        robustness_metrics().inc("deadline.exceeded")
        trace.event("deadline.exceeded", point=point, budget_s=self.budget_s)
        raise QueryTimeout(
            f"query exceeded its {self.budget_s:g}s budget{where} (geomesa.query.timeout)")


@contextmanager
def budget(budget_s: Optional[float]):
    """Install a deadline of ``budget_s`` seconds for the calling scope
    (``None``: a pass-through yielding the ambient deadline). A nested
    budget only tightens: it never outlives the enclosing one."""
    if budget_s is None:
        yield _CURRENT.get()
        return
    outer = _CURRENT.get()
    d = Deadline(budget_s, outer=outer)
    if outer is not None and outer.t_end < d.t_end:
        d = Deadline(budget_s, t_end=outer.t_end, outer=outer)
    token = _CURRENT.set(d)
    try:
        yield d
    finally:
        _CURRENT.reset(token)


@contextmanager
def attach(d: Optional[Deadline]):
    """Install an existing deadline for the calling scope: the hand-off
    to another thread (the coalescer's leader resolves each member under
    the member's own). ``None`` passes through."""
    if d is None:
        yield _CURRENT.get()
        return
    token = _CURRENT.set(d)
    try:
        yield d
    finally:
        _CURRENT.reset(token)


def ambient() -> Optional[Deadline]:
    """The calling context's deadline, or None when unbounded."""
    return _CURRENT.get()


def check(point: str = "") -> None:
    """``QueryTimeout`` when the ambient budget is gone; free otherwise."""
    d = _CURRENT.get()
    if d is not None:
        d.check(point)


def remaining() -> Optional[float]:
    """The ambient budget left in seconds, or None when unbounded."""
    d = _CURRENT.get()
    return None if d is None else d.remaining()
