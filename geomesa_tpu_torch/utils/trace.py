"""Per-query span trees and their exporters.

Port of ``geomesa_tpu/utils/trace.py``: one tree of timed spans a query,
from plan through the block scans and device dispatch and fetch (or the
degrade event) to the post-filter and assembly.

* **Free when off.** With no exporter installed and no trace open,
  ``span()`` hands out the shared no-op ``NOOP``: a span records when a
  trace is already open in the calling context, an exporter is installed
  or the caller forces a root (``force=True``).
* **Context propagation.** The current span lives in a ``contextvars``
  variable, so nesting needs no plumbing and ``wrap()`` carries a trace
  onto another thread.
* **Whole trees.** Exporters receive the root once it closes, children
  attached.

A span also opens a ``torch.profiler.record_function`` of its own name, so
a profiler trace shows ``scan.block`` or ``batch.coalesce`` beside the
store's ``geomesa.*`` ranges; with no span recording, the range opens only
while the profiler runs.

Usage::

    from geomesa_tpu_torch.utils import trace

    with trace.exporting(trace.InMemoryTraceExporter()) as ring:
        store.query("gdelt", cql)
    print(ring.traces[-1].render())
"""

from __future__ import annotations

import contextvars
import json
import logging
import threading
import time
import uuid
from typing import Any, Callable, Dict, List, Optional

import torch
from torch.profiler import record_function


def _new_id() -> str:
    return uuid.uuid4().hex[:16]


class Span:
    """One timed operation: name, duration, attributes, point-in-time
    events and child spans. ``start_ms`` is the epoch wall clock, for log
    correlation; durations come from ``perf_counter``."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "start_ms", "duration_ms",
                 "attributes", "events", "children", "_t0")

    # real spans record; the no-op span says False, so callers can skip
    # computing attribute values
    recording = True

    def __init__(self, name: str, trace_id: str, parent_id: Optional[str]):
        self.name = name
        self.trace_id = trace_id
        self.span_id = _new_id()
        self.parent_id = parent_id
        self.start_ms = time.time() * 1000.0
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

    def finish(self) -> None:
        self.duration_ms = (time.perf_counter() - self._t0) * 1e3

    @property
    def self_time_ms(self) -> float:
        """The duration less the direct children's durations."""
        return max(0.0, self.duration_ms - sum(c.duration_ms for c in self.children))

    def walk(self):
        """This span and every descendant, depth first."""
        yield self
        for c in self.children:
            yield from c.walk()

    def find(self, name: str) -> List["Span"]:
        return [s for s in self.walk() if s.name == name]

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "name": self.name,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "start_ms": self.start_ms,
            "duration_ms": self.duration_ms,
        }
        if self.parent_id:
            out["parent_id"] = self.parent_id
        if self.attributes:
            out["attributes"] = dict(self.attributes)
        if self.events:
            out["events"] = list(self.events)
        if self.children:
            out["children"] = [c.to_dict() for c in self.children]
        return out

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Span":
        """The inverse of ``to_dict``: ids and timings kept; a caller that
        grafts the tree re-anchors its wall times (``graft``)."""
        sp = cls.__new__(cls)
        sp.name = str(d.get("name", ""))
        sp.trace_id = str(d.get("trace_id", ""))
        sp.span_id = str(d.get("span_id") or _new_id())
        sp.parent_id = d.get("parent_id")
        sp.start_ms = float(d.get("start_ms", 0.0))
        sp.duration_ms = float(d.get("duration_ms", 0.0))
        sp.attributes = dict(d.get("attributes") or {})
        sp.events = list(d.get("events") or [])
        sp.children = [cls.from_dict(c) for c in d.get("children") or ()]
        sp._t0 = 0.0  # a rebuilt span is closed
        return sp

    def render(self, indent: int = 0) -> str:
        """The tree as indented text: name, duration, short attributes,
        events."""
        pad = "  " * indent
        attrs = ""
        if self.attributes:
            short = {k: v for k, v in self.attributes.items()
                     if not isinstance(v, str) or len(v) <= 64}
            if short:
                attrs = " " + json.dumps(short, default=str, sort_keys=True)
        lines = [f"{pad}{self.name} {self.duration_ms:.2f}ms{attrs}"]
        for ev in self.events:
            extra = {k: v for k, v in ev.items() if k not in ("name", "t_ms")}
            tail = f" {json.dumps(extra, default=str)}" if extra else ""
            lines.append(f"{pad}  ! {ev['name']} @{ev['t_ms']:.2f}ms{tail}")
        for c in self.children:
            lines.append(c.render(indent + 1))
        return "\n".join(lines)


class _NoopSpan:
    """The shared do-nothing span and context manager."""

    __slots__ = ()
    recording = False
    name = ""
    trace_id = ""
    span_id = ""
    duration_ms = 0.0
    self_time_ms = 0.0
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

    def walk(self):
        return iter(())

    def find(self, name):
        return []

    def render(self, indent: int = 0) -> str:
        return ""

    def to_dict(self):
        return {}


NOOP = _NoopSpan()

_CURRENT: contextvars.ContextVar[Optional[Span]] = contextvars.ContextVar(
    "geomesa_tpu_torch_span", default=None)
_EXPORTERS: List["TraceExporter"] = []
_EXPORTERS_LOCK = threading.Lock()
_log = logging.getLogger("geomesa_tpu_torch.trace")


class _SpanContext:
    """A recording span: current in the calling context until it exits; a
    root exports its tree on exit."""

    __slots__ = ("span", "_token", "_range")

    def __init__(self, name: str, parent: Optional[Span], trace_id: Optional[str],
                 attrs: Dict[str, Any]):
        t0 = time.perf_counter()
        if parent is not None:
            sp = Span(name, parent.trace_id, parent.span_id)
            parent.children.append(sp)
        else:
            sp = Span(name, trace_id or _new_id(), None)
        if attrs:
            sp.attributes.update(attrs)
        # the span's own cost (its ids, its profiler range) is in its
        # duration, not in its parent's self time
        sp._t0 = t0
        self.span = sp
        self._token = None
        self._range = record_function(name)

    def __enter__(self) -> Span:
        self._range.__enter__()
        self._token = _CURRENT.set(self.span)
        return self.span

    def __exit__(self, exc_type, exc, tb) -> bool:
        sp = self.span
        if exc is not None:
            sp.add_event("error", type=type(exc).__name__, message=str(exc))
        _CURRENT.reset(self._token)
        self._range.__exit__(exc_type, exc, tb)
        sp.finish()
        if sp.parent_id is None and _CURRENT.get() is None:
            _export(sp)
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


def span(name: str, trace_id: Optional[str] = None, force: bool = False, **attrs: Any):
    """Context manager of one span: it records under an open span
    (nesting), while an exporter is installed, or with ``force=True`` (a
    new root even with no exporter: the slow-query log and EXPLAIN ANALYZE
    need the tree); otherwise ``NOOP``, or the bare profiler range while
    ``torch.profiler`` runs. ``trace_id`` names a root's trace."""
    parent = _CURRENT.get()
    if parent is None and not (_EXPORTERS or force):
        return _ProfiledNoop(name) if torch._C._autograd._profiler_enabled() else NOOP
    return _SpanContext(name, parent, trace_id, attrs)


def current_span() -> Optional[Span]:
    return _CURRENT.get()


def current_trace_id() -> Optional[str]:
    sp = _CURRENT.get()
    return sp.trace_id if sp is not None else None


def event(name: str, **attrs: Any) -> None:
    """Attach a point-in-time event to the current span (no-op outside a
    trace): how a fired fault or a degrade lands on the query it hit."""
    sp = _CURRENT.get()
    if sp is not None:
        sp.add_event(name, **attrs)


def set_attr(key: str, value: Any) -> None:
    sp = _CURRENT.get()
    if sp is not None:
        sp.set_attr(key, value)


def graft(parent: Span, sub: Span, offset_ms: float = 0.0) -> Span:
    """Attach a rebuilt subtree under ``parent``: every span joins the
    parent's trace and its ``start_ms`` moves by ``offset_ms`` (the
    caller's own clock decides the offset)."""
    sub.parent_id = parent.span_id
    for s in sub.walk():
        s.trace_id = parent.trace_id
        s.start_ms += offset_ms
    parent.children.append(sub)
    return sub


def active() -> bool:
    """Whether spans would record (an exporter installed or a trace open)."""
    return bool(_EXPORTERS) or _CURRENT.get() is not None


def wrap(fn: Callable) -> Callable:
    """Bind ``fn`` to the caller's context, so the open span survives a hop
    onto another thread."""
    ctx = contextvars.copy_context()
    return lambda *a, **k: ctx.run(fn, *a, **k)


# -- exporters ----------------------------------------------------------------


class TraceExporter:
    """Receives each completed root span (children attached)."""

    def export(self, root: Span) -> None:
        raise NotImplementedError


class InMemoryTraceExporter(TraceExporter):
    """A bounded ring of recent trees. ``root_names`` keeps only trees whose
    root has one of those names."""

    def __init__(self, capacity: int = 256, root_names=None):
        self.capacity = capacity
        self.root_names = frozenset(root_names) if root_names else None
        self.traces: List[Span] = []
        self._lock = threading.Lock()

    def export(self, root: Span) -> None:
        if self.root_names is not None and root.name not in self.root_names:
            return
        with self._lock:
            self.traces.append(root)
            if len(self.traces) > self.capacity:
                del self.traces[: len(self.traces) - self.capacity]

    def recent(self, n: int = 20) -> List[Span]:
        if n <= 0:  # traces[-0:] would be the whole ring
            return []
        with self._lock:
            return list(self.traces[-n:])


class JsonLinesTraceExporter(TraceExporter):
    """One JSON object a tree, appended to a file."""

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()

    def export(self, root: Span) -> None:
        line = json.dumps(root.to_dict(), default=str)
        with self._lock:
            with open(self.path, "a") as fh:
                fh.write(line + "\n")


class LoggingTraceExporter(TraceExporter):
    """Rendered trees through the logging module."""

    def __init__(self, logger: Optional[logging.Logger] = None):
        self.logger = logger or logging.getLogger("geomesa_tpu_torch.trace")

    def export(self, root: Span) -> None:
        self.logger.info("trace %s\n%s", root.trace_id, root.render())


def install(exporter: TraceExporter) -> TraceExporter:
    with _EXPORTERS_LOCK:
        if exporter not in _EXPORTERS:
            _EXPORTERS.append(exporter)
    return exporter


def uninstall(exporter: TraceExporter) -> None:
    with _EXPORTERS_LOCK:
        try:
            _EXPORTERS.remove(exporter)
        except ValueError:
            pass


class exporting:
    """A scoped install: ``with trace.exporting(ring): ...``."""

    def __init__(self, exporter: TraceExporter):
        self.exporter = exporter

    def __enter__(self) -> TraceExporter:
        return install(self.exporter)

    def __exit__(self, *exc) -> None:
        uninstall(self.exporter)


def _export(root: Span) -> None:
    # an exporter's failure must not fail the traced query
    with _EXPORTERS_LOCK:
        sinks = list(_EXPORTERS)
    for e in sinks:
        try:
            e.export(root)
        except Exception:  # noqa: BLE001 - exporter failure is not query failure
            _log.exception("trace exporter %r failed", type(e).__name__)


_DEBUG_RING: Optional[InMemoryTraceExporter] = None
_DEBUG_RING_REFS = 0
_DEBUG_RING_LOCK = threading.Lock()


def ensure_ring(capacity: int = 256) -> InMemoryTraceExporter:
    """Install (once) the process's debug ring of query trees; refcounted
    against ``release_ring()``."""
    global _DEBUG_RING, _DEBUG_RING_REFS
    with _DEBUG_RING_LOCK:
        if _DEBUG_RING is None:
            _DEBUG_RING = install(InMemoryTraceExporter(
                capacity,
                # every query-class root (utils/slo.py CLASSES)
                root_names=("query", "query.batch", "query.join", "query.aggregate",
                            "query.stream")))
        _DEBUG_RING_REFS += 1
        return _DEBUG_RING


def release_ring() -> None:
    """Drop one ``ensure_ring`` reference; the last one uninstalls the ring
    (and the tracer is free again)."""
    global _DEBUG_RING, _DEBUG_RING_REFS
    with _DEBUG_RING_LOCK:
        if _DEBUG_RING is None:
            return
        _DEBUG_RING_REFS -= 1
        if _DEBUG_RING_REFS > 0:
            return
        ring, _DEBUG_RING, _DEBUG_RING_REFS = _DEBUG_RING, None, 0
    uninstall(ring)


def find_trace(trace_id: str) -> Optional[Span]:
    """One retained tree by id (the debug ring, or a test's in-memory
    exporter); None once the ring has rotated past it."""
    if not trace_id:
        return None
    for root in recent_traces(10**9):
        if root.trace_id == trace_id:
            return root
    return None


def blackbox_traces(n: int = 20) -> List[Span]:
    """The last ``n`` retained trees for a crash dump ([] with no ring): a
    pure read."""
    return recent_traces(n)


def recent_traces(n: int = 20) -> List[Span]:
    """The last ``n`` trees: the debug ring when one is installed, else the
    first in-memory exporter; [] when there is none."""
    with _DEBUG_RING_LOCK:
        ring = _DEBUG_RING
    if ring is not None:
        return ring.recent(n)
    with _EXPORTERS_LOCK:
        sinks = list(_EXPORTERS)
    for e in sinks:
        if isinstance(e, InMemoryTraceExporter):
            return e.recent(n)
    return []
