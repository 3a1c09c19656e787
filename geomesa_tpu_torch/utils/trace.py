"""Per-query span trees.

Port of ``geomesa_tpu/utils/trace.py`` trimmed to what the serving path
calls: ``span(name, force=, **attrs)``, ``event``, ``NOOP``,
``current_span`` and a span's ``set_attr`` / ``recording``. There is no
exporter: a span records when a trace is already open in the calling
context or the caller forces a root (``force=True``); otherwise ``span``
hands out the shared no-op ``NOOP``.

A span also opens a ``torch.profiler.record_function`` of its own name, so
a profiler trace shows ``batch.coalesce`` and ``query.member`` beside the
store's ``geomesa.*`` ranges; with no span recording, the range opens only
while the profiler runs.
"""

from __future__ import annotations

import contextvars
import time
import uuid
from typing import Any, Dict, List, Optional

import torch
from torch.profiler import record_function


def _new_id() -> str:
    return uuid.uuid4().hex[:16]


class Span:
    """One timed operation: name, duration, attributes, point-in-time
    events and child spans."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "duration_ms", "attributes",
                 "events", "children", "_t0")

    recording = True

    def __init__(self, name: str, trace_id: str, parent_id: Optional[str]):
        self.name = name
        self.trace_id = trace_id
        self.span_id = _new_id()
        self.parent_id = parent_id
        self.duration_ms = 0.0
        self.attributes: Dict[str, Any] = {}
        self.events: List[Dict[str, Any]] = []
        self.children: List["Span"] = []
        self._t0 = time.perf_counter()

    def set_attr(self, key: str, value: Any) -> "Span":
        self.attributes[key] = value
        return self

    def add_event(self, name: str, **attrs: Any) -> "Span":
        self.events.append({"name": name, "t_ms": (time.perf_counter() - self._t0) * 1e3,
                            **attrs})
        return self


class _NoopSpan:
    """The shared do-nothing span and context manager."""

    __slots__ = ()
    recording = False
    attributes: Dict[str, Any] = {}
    events: List[Dict[str, Any]] = []
    children: List[Span] = []

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set_attr(self, key, value) -> "_NoopSpan":
        return self

    def add_event(self, name, **attrs) -> "_NoopSpan":
        return self


NOOP = _NoopSpan()

_CURRENT: contextvars.ContextVar[Optional[Span]] = contextvars.ContextVar(
    "geomesa_tpu_torch_span", default=None)


class _SpanContext:
    """A recording span: current in the calling context until it exits."""

    __slots__ = ("span", "_token", "_range")

    def __init__(self, name: str, parent: Optional[Span], attrs: Dict[str, Any]):
        sp = Span(name, parent.trace_id if parent else _new_id(),
                  parent.span_id if parent else None)
        sp.attributes.update(attrs)
        if parent is not None:
            parent.children.append(sp)
        self.span = sp
        self._token = None
        self._range = record_function(name)

    def __enter__(self) -> Span:
        self._range.__enter__()
        self._token = _CURRENT.set(self.span)
        return self.span

    def __exit__(self, exc_type, exc, tb) -> bool:
        sp = self.span
        sp.duration_ms = (time.perf_counter() - sp._t0) * 1e3
        if exc is not None:
            sp.add_event("error", type=type(exc).__name__, message=str(exc))
        _CURRENT.reset(self._token)
        self._range.__exit__(exc_type, exc, tb)
        return False


class _ProfiledNoop:
    """No span records, but the profiler runs: the range alone."""

    __slots__ = ("_range",)

    def __init__(self, name: str):
        self._range = record_function(name)

    def __enter__(self) -> _NoopSpan:
        self._range.__enter__()
        return NOOP

    def __exit__(self, *exc) -> bool:
        self._range.__exit__(*exc)
        return False


def span(name: str, force: bool = False, **attrs: Any):
    """Context manager of one span: it records under an open span (nesting)
    or with ``force=True`` (a new root); otherwise ``NOOP``, or the bare
    profiler range while ``torch.profiler`` runs."""
    parent = _CURRENT.get()
    if parent is None and not force:
        return _ProfiledNoop(name) if torch._C._autograd._profiler_enabled() else NOOP
    return _SpanContext(name, parent, attrs)


def current_span() -> Optional[Span]:
    return _CURRENT.get()


def event(name: str, **attrs: Any) -> None:
    """Attach a point-in-time event to the current span (no-op outside a
    trace): how a fired fault or a degrade lands on the query it hit."""
    sp = _CURRENT.get()
    if sp is not None:
        sp.add_event(name, **attrs)
