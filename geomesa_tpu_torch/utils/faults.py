"""Deterministic fault injection at named boundaries.

Port of ``geomesa_tpu/utils/faults.py``: the rules, their seeded draws,
``fault_point`` and ``maybe_tear``. The port places twelve points:

    device.dispatch    every host -> device copy (``parallel/mesh.py``
                       ``upload``: mirror builds and query descriptors): a
                       fault there degrades the query to the host table
                       scan with identical answers (``degrade.device_to_host``)
    device.fetch       every device -> host copy (``mesh.fetch``): the same
                       degrade, from wherever the scan was resolving
    batch.coalesce     the cross-query coalescer's shared phase
                       (parallel/batch.py): a fault there degrades the
                       whole group to solo execution with identical answers
    agg.build          the aggregate pyramid's build and its column grids
                       (ops/pyramid.py): a fault there degrades the
                       aggregation to the uncached exact scan
    join.build         a spatial join's build side: bucketing and its
                       upload (ops/join.py)
    join.probe         each probe chunk of a spatial join (ops/join.py):
                       a fault at either join point degrades the whole
                       join to the host reference join with identical
                       pairs (``degrade.join_to_host``)
    fs.block_read      a file store block's read (store/fs.py): retried
    fs.block_write     a file store block's write (store/fs.py): retried;
                       ``torn`` truncates the written block before it is
                       published, which the CRC footer catches on read
    fs.block_delete    a journaled file delete (store/journal.py)
    metadata.save      the schema registry's flush (store/metadata.py);
                       ``torn`` as at ``fs.block_write``
    journal.intent     an intent record's publish (store/journal.py)
    journal.commit     an intent record's commit (store/journal.py)

Kinds: ``error`` raises ``InjectedFault`` (an
OSError), ``drop`` raises ``InjectedDrop`` (a ConnectionError),
``latency`` sleeps a few ms (never past the ambient budget), ``crash``
raises ``SimulatedCrash`` (a BaseException no ``except Exception``
absorbs: the process is gone, only the disk survives) and ``torn``
truncates a written file (``maybe_tear``, the write sites only).

Activation is scoped::

    with faults.inject("batch.coalesce:error=0.5", seed=7): ...

or process-wide from ``GEOMESA_FAULTS`` (+ ``GEOMESA_FAULTS_SEED``). A spec
is ``point:kind[@skip[xfires]][=prob],...``: ``@skip`` fires from the
(skip+1)-th hit on, ``xfires`` caps the fires. Draws come from a
``random.Random`` seeded per activation, in the reference's order, so one
spec and seed give the reference's firing sequence. Every fired fault
counts under ``fault.<point>.<kind>`` in
``utils.audit.robustness_metrics()``.
"""

from __future__ import annotations

import os
import random
import threading
import time
from dataclasses import dataclass
from typing import List, Optional, Tuple

from geomesa_tpu_torch.utils import trace
from geomesa_tpu_torch.utils.audit import robustness_metrics

KINDS = ("error", "drop", "latency", "torn", "crash")


class InjectedFault(OSError):
    """An ``error`` rule fired."""


class InjectedDrop(ConnectionError):
    """A ``drop`` rule fired: the peer hung up mid-exchange."""


class SimulatedCrash(BaseException):
    """A ``crash`` rule fired: the process "dies" here."""


@dataclass
class FaultRule:
    """One rule: ``point`` exact, or a prefix ending in ``*``; it fires with
    probability ``prob``, after ``skip`` would-be fires, at most
    ``max_fires`` times."""

    point: str
    kind: str
    prob: float = 1.0
    latency_s: float = 0.002
    max_fires: Optional[int] = None
    skip: int = 0
    fired: int = 0
    seen: int = 0

    def matches(self, point: str) -> bool:
        if self.point.endswith("*"):
            return point.startswith(self.point[:-1])
        return self.point == point


class FaultSet:
    """One activation of rules with its own seeded RNG; a context manager
    for scoped injection."""

    def __init__(self, rules, seed: Optional[int] = None):
        for r in rules:
            if r.kind not in KINDS:
                raise ValueError(f"unknown fault kind {r.kind!r} (kinds: {KINDS})")
        self.rules: List[FaultRule] = list(rules)
        self._rng = random.Random(seed)
        self._lock = threading.Lock()

    def draw(self, point: str, kinds) -> Optional[FaultRule]:
        """The first matching rule that fires for ``point``, or None."""
        with self._lock:
            for rule in self.rules:
                if rule.kind not in kinds or not rule.matches(point):
                    continue
                if rule.max_fires is not None and rule.fired >= rule.max_fires:
                    continue
                if rule.prob < 1.0 and self._rng.random() >= rule.prob:
                    continue
                rule.seen += 1
                if rule.seen <= rule.skip:
                    continue
                rule.fired += 1
                return rule
        return None

    def __enter__(self) -> "FaultSet":
        with _STACK_LOCK:
            _STACK.append(self)
        return self

    def __exit__(self, *exc) -> None:
        with _STACK_LOCK:
            try:
                _STACK.remove(self)
            except ValueError:
                pass


def parse(spec: str, seed: Optional[int] = None) -> FaultSet:
    """``"<point>:<kind>[@skip[xfires]][=<prob>],..."`` -> FaultSet."""
    rules = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        pk, _, prob = part.partition("=")
        point, sep, kind = pk.partition(":")
        if not sep:
            raise ValueError(f"bad fault spec {part!r} (want point:kind[@skip[xfires]][=prob])")
        kind, _, pos = kind.partition("@")
        skip, max_fires = 0, None
        if pos:
            skip_s, _, fires_s = pos.partition("x")
            try:
                skip = int(skip_s)
                if fires_s:
                    max_fires = int(fires_s)
            except ValueError:
                raise ValueError(
                    f"bad fault position {pos!r} in {part!r} (want @skip[xfires])") from None
        rules.append(FaultRule(point.strip(), kind.strip(), float(prob) if prob else 1.0,
                               max_fires=max_fires, skip=skip))
    return FaultSet(rules, seed=seed)


def inject(spec: Optional[str] = None, *, rules=None, seed: Optional[int] = None) -> FaultSet:
    """Scoped activation from a spec string or a list of rules."""
    if (spec is None) == (rules is None):
        raise ValueError("pass exactly one of spec= or rules=")
    return parse(spec, seed=seed) if spec is not None else FaultSet(rules, seed=seed)


_STACK: List[FaultSet] = []
_STACK_LOCK = threading.Lock()
# (GEOMESA_FAULTS, its parsed set): re-parsed only when the variable changes
_ENV_CACHE: Tuple[Optional[str], Optional[FaultSet]] = (None, None)


def _env_set() -> Optional[FaultSet]:
    global _ENV_CACHE
    spec = os.environ.get("GEOMESA_FAULTS")
    cached_spec, cached = _ENV_CACHE
    if spec != cached_spec:
        seed_s = os.environ.get("GEOMESA_FAULTS_SEED")
        cached = parse(spec, seed=None if seed_s is None else int(seed_s)) if spec else None
        _ENV_CACHE = (spec, cached)
    return cached


def _active_sets() -> List[FaultSet]:
    env = _env_set()
    if not _STACK:
        return [env] if env is not None else []
    with _STACK_LOCK:
        stack = list(_STACK)
    return ([env] if env is not None else []) + stack


def fault_point(point: str) -> None:
    """The hook at a named boundary: ``error`` / ``drop`` / ``crash`` rules
    raise, ``latency`` sleeps (at most the ambient budget left)."""
    for fs in _active_sets():
        rule = fs.draw(point, ("error", "drop", "latency", "crash"))
        if rule is None:
            continue
        robustness_metrics().inc(f"fault.{point}.{rule.kind}")
        trace.event(f"fault.{point}.{rule.kind}")
        if rule.kind == "latency":
            from geomesa_tpu_torch.utils import deadline

            left = deadline.remaining()
            time.sleep(rule.latency_s if left is None else max(0.0, min(rule.latency_s, left)))
        elif rule.kind == "drop":
            raise InjectedDrop(f"injected connection drop at {point}")
        elif rule.kind == "crash":
            raise SimulatedCrash(f"simulated crash at {point}")
        else:
            raise InjectedFault(f"injected error at {point}")


def maybe_tear(point: str, path: str) -> bool:
    """Apply a fired ``torn`` rule to a just-written, not yet published
    file: truncate it to half and return True. The caller publishes the
    torn file anyway, which stands for a crash inside the write-then-rename
    window, so that the corruption-detection and quarantine path stays
    provable though the fsyncs close that window for real crashes."""
    for fs in _active_sets():
        rule = fs.draw(point, ("torn",))
        if rule is None:
            continue
        robustness_metrics().inc(f"fault.{point}.torn")
        trace.event(f"fault.{point}.torn", path=path)
        size = os.path.getsize(path)
        with open(path, "rb+") as fh:
            fh.truncate(max(0, size // 2))
        return True
    return False
