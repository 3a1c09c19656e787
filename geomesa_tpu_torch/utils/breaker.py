"""Circuit breakers for a repeatedly failing device boundary.

Port of ``geomesa_tpu/utils/breaker.py``, whole. The degrade layer makes a
single device failure cheap (the query answers from the host table scan);
this module makes a PERSISTENT failure cheap. Without it, a failing device
pays the full dispatch cost on every query, each one rediscovering the same
outage. A ``CircuitBreaker`` remembers:

    closed     normal operation; failures accumulate in a rolling window
    open       the window filled (``failures`` within ``window_s``):
               calls short-circuit at once for ``cooldown_s``, and guarded
               queries take their host path with no device cost
    half-open  the cooldown elapsed: exactly ONE probe call is let through;
               success closes the circuit (for the device breaker, the
               probe query rebuilds the evicted mirror), failure re-opens
               it for another cooldown

The port guards one boundary: ``device.dispatch`` / ``device.fetch`` of
``TorchScanExecutor`` (open: queries go straight to the host scan). State
is observable as ``breaker.<name>.*`` counters and a ``breaker.<name>.state``
gauge in ``utils.audit.robustness_metrics()``, transitions as trace events
on the query that caused them, and the process-wide ``breaker_states()``
snapshot.

Defaults come from the knobs ``geomesa.breaker.failures`` /
``geomesa.breaker.window`` / ``geomesa.breaker.cooldown``
(``utils/config.py``), read when a breaker is made; ``clock`` is injectable
for deterministic tests.
"""

from __future__ import annotations

import threading
import time
import weakref
from typing import Callable, Dict, Optional

from geomesa_tpu_torch.utils import trace
from geomesa_tpu_torch.utils.audit import robustness_metrics

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half-open"

# severity order for merging several same-named breakers into one report
_SEVERITY = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}
_STATE_GAUGE = {CLOSED: 0.0, HALF_OPEN: 0.5, OPEN: 1.0}

# every live breaker, for breaker_states() (weak: a breaker
# dies with its executor and must not be pinned by telemetry)
_REGISTRY: "weakref.WeakSet[CircuitBreaker]" = weakref.WeakSet()
_REGISTRY_LOCK = threading.Lock()


class CircuitOpen(ConnectionError):
    """Fast-fail raised at a breaker-guarded boundary while the circuit
    is open. A ConnectionError (and so an OSError): callers that already
    classify transport failures as transient treat a refused call
    exactly like the outage it stands in for — minus the latency."""


class CircuitBreaker:
    """One guarded boundary's closed/open/half-open state machine.

    ``record_failure()`` after each boundary failure, ``record_success()``
    after each success, ``allow()`` (or ``check()``, which raises
    ``CircuitOpen``) before each call. Thread-safe; all transitions and
    refusals are counted under ``breaker.<name>.*``."""

    def __init__(
        self,
        name: str,
        failures: Optional[int] = None,
        window_s: Optional[float] = None,
        cooldown_s: Optional[float] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        from geomesa_tpu_torch.utils.config import (
            BREAKER_COOLDOWN,
            BREAKER_FAILURES,
            BREAKER_WINDOW,
        )

        self.name = name
        if failures is None:
            failures = BREAKER_FAILURES.to_int() or 5
        if window_s is None:
            window_s = BREAKER_WINDOW.to_duration_s(30.0)
        if cooldown_s is None:
            cooldown_s = BREAKER_COOLDOWN.to_duration_s(5.0)
        if failures < 1:
            raise ValueError("failures must be >= 1")
        self.failures = int(failures)
        self.window_s = float(window_s)
        self.cooldown_s = float(cooldown_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED
        self._window: list = []  # monotonic stamps of recent failures
        self._opened_at = 0.0
        self._probing = False  # a half-open probe is in flight
        with _REGISTRY_LOCK:
            _REGISTRY.add(self)
        # live state gauge (same-named breakers overwrite each other;
        # breaker_states() merges them by worst state instead). Reads
        # peek_state: a metrics snapshot — the Prometheus scrape, a
        # Reporter tick, the timeline sampler — must OBSERVE the
        # breaker, never run its open->half-open transition (the next
        # real caller's allow() ticks it identically)
        ref = weakref.ref(self)
        robustness_metrics().gauge_fn(
            f"breaker.{name}.state",
            lambda: _STATE_GAUGE[ref().peek_state] if ref() is not None else 0.0,
        )

    # -- state ---------------------------------------------------------------

    def _tick_locked(self) -> None:
        """Open -> half-open once the cooldown has elapsed."""
        if (
            self._state == OPEN
            and self._clock() - self._opened_at >= self.cooldown_s
        ):
            self._state = HALF_OPEN
            self._probing = False

    @property
    def state(self) -> str:
        with self._lock:
            self._tick_locked()
            return self._state

    @property
    def peek_state(self) -> str:
        """PASSIVE state read for the telemetry sampler
        (utils/timeline.py): computes the effective state (an elapsed
        cooldown reads as half-open) WITHOUT taking the lock or running
        the open->half-open transition — a sampler tick must never
        mutate breaker state, contend with the query path, or release a
        probe slot. May lag a concurrent transition by one tick."""
        s = self._state
        if s == OPEN and self._clock() - self._opened_at >= self.cooldown_s:
            return HALF_OPEN
        return s

    def allow(self) -> bool:
        """May a call proceed? Closed: always. Open: never (counted under
        ``breaker.<name>.short_circuit``). Half-open: exactly one probe
        at a time — concurrent callers short-circuit until the probe
        reports back."""
        with self._lock:
            self._tick_locked()
            if self._state == CLOSED:
                return True
            if self._state == OPEN or self._probing:
                robustness_metrics().inc(f"breaker.{self.name}.short_circuit")
                return False
            self._probing = True
            robustness_metrics().inc(f"breaker.{self.name}.probes")
            return True

    def check(self) -> None:
        """``allow()`` that raises ``CircuitOpen`` on refusal — for
        boundaries whose contract is exception-based."""
        if not self.allow():
            raise CircuitOpen(
                f"{self.name} circuit open "
                f"({self.failures} failures in {self.window_s:g}s; "
                f"retrying after {self.cooldown_s:g}s cooldown)"
            )

    def cancel_probe(self) -> None:
        """The call ``allow()`` admitted never actually exercised the
        guarded boundary (e.g. the device dispatcher chose a host-only
        path): release the half-open probe slot without judging the
        circuit either way. No-op in closed/open."""
        with self._lock:
            if self._state == HALF_OPEN:
                self._probing = False

    def record_success(self) -> None:
        """A guarded call succeeded. In half-open this is the probe
        reporting back: the circuit closes and the failure window
        clears. While OPEN, a straggler success (a call that dispatched
        before the trip and only finished now) is IGNORED — the cooldown
        stands; only a post-cooldown probe may close the circuit."""
        with self._lock:
            self._tick_locked()
            if self._state != HALF_OPEN:
                return
            self._state = CLOSED
            self._probing = False
            self._window.clear()
            robustness_metrics().inc(f"breaker.{self.name}.closes")
            trace.event("breaker.close", breaker=self.name)

    def reset(self) -> None:
        """Administrative close: the OPERATOR (or a supervisor that
        verified the dependency recovered out-of-band — the fleet
        restarts a worker, pings it, and re-syncs through it before
        calling this) declares the circuit healthy. Unlike
        ``record_success``, this closes from ANY state without waiting
        out the cooldown: positive external evidence outranks the
        timer. No-op when already closed with an empty window."""
        with self._lock:
            if self._state == CLOSED and not self._window:
                return
            self._state = CLOSED
            self._probing = False
            self._window.clear()
            robustness_metrics().inc(f"breaker.{self.name}.resets")
            trace.event("breaker.reset", breaker=self.name)

    def record_failure(self) -> None:
        """A guarded call failed. Half-open: the probe failed — re-open
        for another cooldown. Closed: roll the window; trip open when it
        fills."""
        with self._lock:
            self._tick_locked()
            now = self._clock()
            if self._state == HALF_OPEN:
                self._state = OPEN
                self._opened_at = now
                self._probing = False
                robustness_metrics().inc(f"breaker.{self.name}.reopens")
                trace.event("breaker.reopen", breaker=self.name)
                return
            if self._state == OPEN:
                return  # already open; nothing new to learn
            self._window.append(now)
            cutoff = now - self.window_s
            while self._window and self._window[0] < cutoff:
                self._window.pop(0)
            if len(self._window) >= self.failures:
                self._state = OPEN
                self._opened_at = now
                self._window.clear()
                robustness_metrics().inc(f"breaker.{self.name}.opens")
                trace.event(
                    "breaker.open", breaker=self.name,
                    cooldown_s=self.cooldown_s,
                )


def breaker_states() -> Dict[str, str]:
    """Every live breaker's state, worst-per-name (several executors may
    each carry a "device" breaker). A process is degraded while any circuit is open."""
    out: Dict[str, str] = {}
    with _REGISTRY_LOCK:
        live = list(_REGISTRY)
    for b in live:
        s = b.state
        if _SEVERITY[s] >= _SEVERITY.get(out.get(b.name, CLOSED), 0):
            out[b.name] = s
    return out


def peek_states() -> Dict[str, str]:
    """breaker_states() for the telemetry sampler: every live breaker's
    ``peek_state`` (passive — no transitions run, no locks taken),
    worst-per-name. The timeline must observe breakers, never drive
    them."""
    out: Dict[str, str] = {}
    with _REGISTRY_LOCK:
        live = list(_REGISTRY)
    for b in live:
        s = b.peek_state
        if _SEVERITY[s] >= _SEVERITY.get(out.get(b.name, CLOSED), 0):
            out[b.name] = s
    return out


def open_breakers() -> Dict[str, str]:
    """Just the OPEN circuits. Half-open is routine recovery probing —
    reporting it as unhealthy would keep /healthz degraded through every
    probe cycle and prolong the drain after a transient outage."""
    return {n: s for n, s in breaker_states().items() if s == OPEN}
