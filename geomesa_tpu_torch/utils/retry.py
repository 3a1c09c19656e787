"""Unified retry policy: bounded attempts, decorrelated-jitter backoff.

Port of ``geomesa_tpu/utils/retry.py``. One implementation of backoff,
jitter, deadlines and retryable-exception classification for every
transient-failure site of the port: the file store's block reads and
writes, the metadata registry flush, the journal's intent records and its
deletes. Retries and give-ups are counted in
``utils.audit.robustness_metrics()`` under ``retry.<name>.*`` so chaos
soaks can assert the layer actually absorbed the injected faults.

Backoff is exponential with decorrelated jitter (the AWS architecture
blog's variant): ``sleep_i = min(cap, uniform(base, 3 * sleep_{i-1}))``.
Decorrelation keeps a thundering herd of retriers from re-colliding on
the same schedule; the cap bounds tail latency.

Layered over the per-call ladder is a per-BOUNDARY retry budget (one
token bucket per policy ``name``, shared by every policy instance with
that name): each initial call deposits ``geomesa.retry.budget.ratio``
tokens, the bucket refills at least ``geomesa.retry.budget.min`` tokens
per second, and each retry spends one. The ratio deposit is the classic
~10%-of-traffic rule — under a true outage, retries cannot amplify the
boundary's traffic by more than ~ratio, so a retry storm can't finish
off a struggling dependency. The time-based floor is the Finagle
RetryBudget refinement: low-traffic boundaries (and fault-injection
soaks, whose failure rates dwarf any traffic ratio) still recover the
ability to retry. Exhaustion gives up crisply — the ORIGINAL exception,
plus ``retry.<name>.budget_exhausted`` and a reason-coded decision — so
the failure reads as "budget spent", never as a silent hang.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Callable, Dict, Optional, Tuple, Type, Union

from geomesa_tpu_torch.utils.audit import decision, robustness_metrics

Retryable = Union[Tuple[Type[BaseException], ...], Callable[[BaseException], bool]]

# -- per-boundary retry budgets ----------------------------------------------

# (enabled, deposit ratio, per-second refill floor, bucket cap) — cached
# after first read, the usual free-when-off shape; reset_budgets() for
# tests and config reloads
_CFG: Optional[Tuple[bool, float, float, float]] = None
_BUDGETS: Dict[str, "_TokenBudget"] = {}
_BUDGETS_LOCK = threading.Lock()


def _cfg() -> Tuple[bool, float, float, float]:
    global _CFG
    cfg = _CFG
    if cfg is None:
        from geomesa_tpu_torch.utils.config import (
            RETRY_BUDGET_CAP,
            RETRY_BUDGET_ENABLED,
            RETRY_BUDGET_MIN,
            RETRY_BUDGET_RATIO,
        )

        enabled = RETRY_BUDGET_ENABLED.to_bool()
        ratio = RETRY_BUDGET_RATIO.to_float()
        floor = RETRY_BUDGET_MIN.to_float()
        cap = RETRY_BUDGET_CAP.to_float()
        cfg = (
            True if enabled is None else bool(enabled),
            0.1 if ratio is None else max(0.0, ratio),
            10.0 if floor is None else max(0.0, floor),
            100.0 if cap is None else max(1.0, cap),
        )
        _CFG = cfg
    return cfg


class _TokenBudget:
    """One boundary's bucket. Starts full (a fresh process may retry its
    first failures — cold starts are exactly when dependencies flap)."""

    __slots__ = ("tokens", "cap", "_last", "_lock")

    def __init__(self, cap: float):
        self.cap = cap
        self.tokens = cap
        self._last = time.monotonic()
        self._lock = threading.Lock()

    def _refill_locked(self, floor_per_s: float) -> None:
        now = time.monotonic()
        dt = now - self._last
        self._last = now
        if dt > 0 and floor_per_s > 0:
            self.tokens = min(self.cap, self.tokens + dt * floor_per_s)

    def deposit(self, ratio: float, floor_per_s: float) -> None:
        with self._lock:
            self._refill_locked(floor_per_s)
            self.tokens = min(self.cap, self.tokens + ratio)

    def try_spend(self, floor_per_s: float) -> bool:
        with self._lock:
            self._refill_locked(floor_per_s)
            if self.tokens >= 1.0:
                self.tokens -= 1.0
                return True
            return False


def _budget_for(name: str) -> "_TokenBudget":
    b = _BUDGETS.get(name)
    if b is None:
        with _BUDGETS_LOCK:
            b = _BUDGETS.get(name)
            if b is None:
                b = _TokenBudget(_cfg()[3])
                _BUDGETS[name] = b
    return b


def reset_budgets() -> None:
    """Drop every bucket and the cached knobs (tests, config reloads)."""
    global _CFG
    with _BUDGETS_LOCK:
        _CFG = None
        _BUDGETS.clear()


def budgets_snapshot() -> Dict[str, Dict[str, float]]:
    """Point-in-time token levels per boundary."""
    with _BUDGETS_LOCK:
        items = list(_BUDGETS.items())
    return {
        name: {"tokens": round(b.tokens, 2), "cap": b.cap}
        for name, b in items
    }


class RetryPolicy:
    """Retry a callable on transient failures.

    ``retryable`` is an exception-type tuple (default ``(OSError,)`` —
    I/O and connection failures, including injected ones) or a predicate
    ``exc -> bool``. Anything else raises through on the first attempt:
    application errors and deterministic corruption must never be
    hammered. ``deadline_s`` bounds total elapsed time across attempts;
    when it would be exceeded the last error is raised even if attempts
    remain. ``rng``/``sleep`` are injectable for deterministic tests.
    """

    def __init__(
        self,
        name: str = "io",
        max_attempts: int = 4,
        base_s: float = 0.02,
        cap_s: float = 1.0,
        deadline_s: Optional[float] = None,
        retryable: Retryable = (OSError,),
        rng: Optional[random.Random] = None,
        sleep: Callable[[float], None] = time.sleep,
    ):
        if max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        self.name = name
        self.max_attempts = int(max_attempts)
        self.base_s = float(base_s)
        self.cap_s = float(cap_s)
        self.deadline_s = deadline_s
        self.retryable = retryable
        self._rng = rng if rng is not None else random.Random()
        self._sleep = sleep

    def is_retryable(self, exc: BaseException) -> bool:
        if isinstance(self.retryable, tuple):
            return isinstance(exc, self.retryable)
        return bool(self.retryable(exc))

    def call(self, fn: Callable, *args, **kwargs):
        """``fn(*args, **kwargs)``, retried on retryable failures. The
        final failure re-raises the ORIGINAL exception — callers keep
        their exception contract.

        Two budgets bound the loop: the policy's own ``deadline_s`` and
        the AMBIENT query deadline (``utils.deadline``) — backoff sleeps
        are clamped to whichever remainder is smaller, so a retry ladder
        can never outlive the query that started it. A sleep that would
        consume the entire remaining budget is skipped: the retry after
        it could only start AT the deadline, so the loop gives up
        immediately instead of burning the budget asleep."""
        from geomesa_tpu_torch.utils import deadline as _deadline

        enabled, ratio, floor, _cap = _cfg()
        budget = _budget_for(self.name) if enabled else None
        if budget is not None:
            # the DEPOSIT happens per initial call, not per retry: the
            # bucket tracks the boundary's real traffic, so sustained
            # retries are bounded at ~ratio of it
            budget.deposit(ratio, floor)
        t0 = time.monotonic()
        ambient = _deadline.ambient()
        prev = self.base_s
        attempt = 1
        while True:
            try:
                return fn(*args, **kwargs)
            except Exception as e:
                if not self.is_retryable(e):
                    raise
                left = (
                    None
                    if self.deadline_s is None
                    else self.deadline_s - (time.monotonic() - t0)
                )
                if ambient is not None:
                    amb_left = ambient.remaining()
                    left = amb_left if left is None else min(left, amb_left)
                if attempt >= self.max_attempts or (left is not None and left <= 0):
                    robustness_metrics().inc(f"retry.{self.name}.giveup")
                    raise
                prev = min(self.cap_s, self._rng.uniform(self.base_s, prev * 3))
                if left is not None and prev >= left:
                    # the backoff would sleep through the rest of the
                    # budget — the final sleep is pointless; give up NOW
                    # with the budget intact for the caller's cleanup
                    robustness_metrics().inc(f"retry.{self.name}.giveup")
                    raise
                if budget is not None and not budget.try_spend(floor):
                    # the boundary-wide budget is spent: more retries
                    # here would amplify whatever is melting the
                    # dependency. Fail crisply with the ORIGINAL error
                    robustness_metrics().inc(
                        f"retry.{self.name}.budget_exhausted"
                    )
                    decision(
                        "retry", "budget_exhausted",
                        policy=self.name, attempt=attempt,
                    )
                    raise
                robustness_metrics().inc(f"retry.{self.name}.retries")
                self._sleep(prev)
                attempt += 1

    def wrap(self, fn: Callable) -> Callable:
        """Decorator form of ``call``."""
        import functools

        @functools.wraps(fn)
        def inner(*args, **kwargs):
            return self.call(fn, *args, **kwargs)

        return inner
