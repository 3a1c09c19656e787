"""Cross-query coalescing at the admission point.

Port of ``geomesa_tpu/parallel/batch.py``. ``query_many`` pipelines one
caller's batch; serving traffic is many callers with one query each.
Queries of one feature type admitted at the same time are in flight
together, so a ``QueryCoalescer`` gathers them for a short window
(``geomesa.batch.window.ms``, at most ``geomesa.batch.max.queries``),
stacks their predicates into one full-table mask sweep per segment
(``TorchScanExecutor.dispatch_coalesced``: the ``exact_mask_batch`` and
``dual_mask_batch`` kernels) and hands each query its own rows.

The contract:

* **Strictly after admit.** Every member holds its own admission slot
  before it reaches the coalescer; the window opens only when another
  query is in flight or a group is gathering, so a query alone on the
  store never waits on it.
* **Per-member deadlines.** A member keeps its own ``Deadline``; one whose
  budget dies in the window leaves with ``QueryTimeout`` and never stalls
  the group, and the leader resolves each member under ``attach`` of the
  member's own deadline.
* **Member isolation.** A member's failure lands on that member. A
  failure of the shared phase (the ``batch.coalesce`` fault point around
  planning and the stacked dispatch) degrades the whole group to solo
  execution with identical answers (``degrade.coalesce_to_solo``); a
  device failure of the stacked sweep also degrades the executor
  (``degrade.device_to_host``: the mirrors go, the breaker takes a strike).
* **Receipts split.** The shared sweep's costs, its buffer fetch
  included (the leader prefetches inside the shared phase), collect in
  the leader's context (``devstats.collecting``) and are apportioned so
  that the members' receipts sum to them exactly; each member's own
  resolve costs collect per member.

``geomesa.batch.enabled=false`` is the escape hatch: every query takes the
solo path, with identical answers.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

from geomesa_tpu_torch.ops.kernels import KernelError
from geomesa_tpu_torch.utils import audit, deadline, devstats, faults, trace
from geomesa_tpu_torch.utils.audit import QueryTimeout, robustness_metrics

# outcome: "run this query yourself on the solo path" (the shared phase
# degraded, or the leader stopped before reaching this member)
SOLO = object()

# outcome: the member left the group (its own budget died in the window)
_ABANDONED = object()


def batch_knobs() -> tuple:
    """(enabled, window_s, max_queries) from the geomesa.batch.* knobs."""
    from geomesa_tpu_torch.utils.config import (
        BATCH_ENABLED,
        BATCH_MAX_QUERIES,
        BATCH_WINDOW_MS,
    )

    enabled = BATCH_ENABLED.to_bool()
    window_ms = BATCH_WINDOW_MS.to_float()
    max_q = BATCH_MAX_QUERIES.to_int() or 32
    return (bool(enabled) and (window_ms or 0) > 0 and max_q > 1,
            (window_ms or 0) / 1000.0, max_q)


class MemberOutcome:
    """One coalesced member's finished execution, handed back to its
    thread: the result, its plan, its receipt, its planning seconds and
    the group's size."""

    __slots__ = ("result", "plan", "receipt", "plan_s", "group_n")

    def __init__(self, result, plan, receipt, plan_s: float, group_n: int):
        self.result = result
        self.plan = plan
        self.receipt = receipt
        self.plan_s = plan_s
        self.group_n = group_n


class _Member:
    __slots__ = ("query", "dl", "event", "outcome", "plan_s", "_lock", "done")

    def __init__(self, query, dl):
        self.query = query
        self.dl = dl  # the member's own ambient deadline (may be None)
        self.event = threading.Event()
        self.outcome: Any = None
        self.plan_s = 0.0
        self._lock = threading.Lock()
        self.done = False

    def finish(self, outcome) -> bool:
        """Claim this member with ``outcome``; False when the other side
        (the leader or the leaving member) claimed it first."""
        with self._lock:
            if self.done:
                return False
            self.done = True
            self.outcome = outcome
        self.event.set()
        return True


class _Group:
    __slots__ = ("members", "closed")

    def __init__(self, leader: _Member):
        self.members = [leader]
        self.closed = False


class QueryCoalescer:
    """A store's coalescing point (``TorchDataStore._coalescer_obj``)."""

    def __init__(self, store):
        self.store = store
        self._cond = threading.Condition()
        self._open: Dict[str, _Group] = {}

    def gathering(self, name: str) -> bool:
        """True while a group of ``name`` collects members (a lock-free
        read: the store's concurrency gate)."""
        g = self._open.get(name)
        return g is not None and not g.closed

    def submit(self, name: str, ft, query) -> Optional[MemberOutcome]:
        """Coalesce one admitted query: its outcome, or None when the
        caller should run the solo path. Raises the member's own failure
        (``QueryTimeout`` when it leaves the window)."""
        _enabled, window_s, max_q = batch_knobs()
        m = _Member(query, deadline.ambient())
        with self._cond:
            g = self._open.get(name)
            if g is not None and not g.closed:
                g.members.append(m)
                if len(g.members) >= max_q:
                    g.closed = True
                    if self._open.get(name) is g:
                        del self._open[name]
                    self._cond.notify_all()  # wake the leader early
                leader = False
            else:
                g = _Group(m)
                self._open[name] = g
                leader = True
        if leader:
            self._lead(name, ft, g, window_s)
        else:
            self._wait(m)
        out = m.outcome
        if out is SOLO:
            return None
        if isinstance(out, BaseException):
            raise out
        return out

    def _wait(self, m: _Member) -> None:
        """Member side: wait for the leader's hand-off, bounded by the
        member's own deadline; its cancellation wakes the wait at once."""
        dl = m.dl
        unregister = dl.on_cancel(m.event.set) if dl is not None else None
        try:
            while not m.done:
                if dl is not None and (dl.is_cancelled or dl.remaining() <= 0.0):
                    if m.finish(_ABANDONED):
                        dl.check("batch.coalesce.wait")
                    break  # the leader won the race: the outcome is set
                m.event.wait(None if dl is None else dl.remaining())
                m.event.clear()
        finally:
            if unregister is not None:
                unregister()

    def _lead(self, name: str, ft, g: _Group, window_s: float) -> None:
        """Leader side: gather for the window, then execute the group. The
        leader is itself ``members[0]``."""
        end = time.monotonic() + window_s
        with self._cond:
            while not g.closed:
                left = end - time.monotonic()
                if left <= 0.0:
                    break
                self._cond.wait(left)
            g.closed = True
            if self._open.get(name) is g:
                del self._open[name]
            members = list(g.members)
        try:
            self._execute_group(name, ft, members)
        finally:
            # every way out of the leader releases the unfinished members
            # to the solo path: no member waits on a leader that stopped
            for m in members:
                m.finish(SOLO)

    def _execute_group(self, name: str, ft, members: List[_Member]) -> None:
        store = self.store
        reg = devstats.devstats_metrics()
        reg.inc("batch.coalesce.groups")
        reg.inc("batch.coalesce.members", len(members))
        bucket = 1
        while bucket < len(members):
            bucket *= 2
        reg.inc(f"batch.coalesce.group.pow2.{bucket}")
        shared: Dict[str, int] = {}
        try:
            with trace.span("batch.coalesce", n=len(members)):
                deadline.check("batch.coalesce")
                faults.fault_point("batch.coalesce")
                with devstats.collecting(shared):
                    live = self._shared_phase(name, members)
        except Exception as e:
            if isinstance(e, QueryTimeout):
                # the leader's own budget died: its outcome; no verdict on
                # the seam, the siblings run solo
                members[0].finish(e)
                return
            if isinstance(e, KernelError):
                # a fault of the program: every member raises it, none is
                # answered by another route
                for m in members:
                    m.finish(e)
                return
            robustness_metrics().inc("degrade.coalesce_to_solo")
            trace.event("degrade.coalesce_to_solo", reason=f"{type(e).__name__}: {e}",
                        n=len(members))
            audit.decision("coalesce", "seam_degraded", error=type(e).__name__, n=len(members))
            return  # _lead's finally hands every member to the solo path
        if not live:
            return
        shares = _apportion(shared, len(live))
        # a member that leaves or fails mid-resolve reports no receipt: its
        # share carries to the next member that succeeds, so the surviving
        # receipts still sum to the sweep's cost
        carry: Dict[str, int] = {}
        for i, (m, plan, pending) in enumerate(live):
            _fold(carry, shares[i])
            if m.done:
                continue  # left while the shared phase ran
            own: Dict[str, int] = {}
            try:
                with deadline.attach(m.dl):
                    with devstats.collecting(own):
                        with trace.span("query.member", i=i):
                            result = store._execute(name, ft, m.query, plan, pending)
            except Exception as e:
                m.finish(e)  # member isolation: this member fails alone
                continue
            _fold(own, carry)
            carry = {}
            m.finish(MemberOutcome(result, plan, devstats.receipt_of(own), m.plan_s,
                                   len(members)))

    def _shared_phase(self, name: str, members: List[_Member]):
        """Plan every live member and dispatch the stacked sweeps; returns
        [(member, plan, pending)]. A failure here degrades the whole group
        to solo (``_execute_group``); a member whose own planning fails
        (its budget died, a bad filter) fails alone."""
        store = self.store
        live = []
        for m in members:
            if m.done:
                continue
            if m.dl is not None and (m.dl.is_cancelled or m.dl.remaining() <= 0.0):
                continue  # the member claims itself in _wait
            t0 = time.perf_counter()
            try:
                with deadline.attach(m.dl):
                    store._prepare_query(name, m.query)
                    plan = store._plan_cached(name, m.query)
            except Exception as e:
                m.finish(e)
                continue
            m.plan_s = time.perf_counter() - t0
            live.append((m, plan))
        if not live:
            return []
        items = []
        seen = set()
        for m, plan in live:
            if store._pushes_down(m.query):
                continue  # a density or stats query launches its own kernels
            for arm in plan.union if plan.union is not None else [plan]:
                if arm.is_empty or id(arm) in seen:
                    continue
                seen.add(id(arm))
                items.append((store._tables[name][arm.index.name], arm))
        pending: Dict[int, object] = {}
        if items:
            try:
                pending = store.executor.dispatch_coalesced(items)
                # fetch the shared buffers now, inside the shared collector:
                # the sweep's bytes apportion across the members instead of
                # landing on the first one to resolve
                for scan in {id(s): s for s in pending.values()}.values():
                    for _seg, ph in getattr(scan, "pending", ()):
                        fn = getattr(ph, "prefetch", None)
                        if fn is not None:
                            fn()
            except (QueryTimeout, KernelError):
                raise
            except Exception as e:
                # a device failure of the stacked sweep: the mirrors go and
                # the breaker takes its strike, then the group runs solo
                store.executor.degrade(None, e)
                raise
        return [(m, plan, pending) for m, plan in live]


def _fold(acc: Dict[str, int], extra: Dict[str, int]) -> None:
    for k, v in extra.items():
        acc[k] = acc.get(k, 0) + v


def _apportion(shared: Dict[str, int], n: int) -> List[Dict[str, int]]:
    """Split the shared costs across ``n`` members so that the shares sum
    to the total exactly (the quotient to each, the remainder over the
    first members)."""
    out: List[Dict[str, int]] = [dict() for _ in range(n)]
    for key, total in shared.items():
        base, rem = divmod(int(total), n)
        for i in range(n):
            out[i][key] = base + (1 if i < rem else 0)
    return out
