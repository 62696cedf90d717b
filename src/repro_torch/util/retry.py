"""Bounded retry with exponential backoff, full jitter, and an optional
wall-clock deadline (the reference's ``util/retry.py``, operation for
operation, so a seeded policy gives the reference's delay sequence).

One small primitive shared by the port's retry paths (the schedule
executor's fault recovery and the decode engine's segment retries):
retry a callable a bounded number of times, sleeping
``U(0, min(cap, base * 2**attempt))`` between attempts, AWS-style *full
jitter*, which decorrelates retry storms while keeping the expected
backoff exponential. The jitter stream comes from a caller-owned
``random.Random``, so a seeded RNG makes the whole retry schedule
deterministic (the executor tests replay failures bit-exactly).

A :class:`RetryPolicy` may additionally carry a ``deadline``, an overall
wall-clock budget in seconds. A retry whose backoff sleep would land past
the deadline is not attempted; :class:`RetryBudgetExceeded` is raised
instead (chained to the last underlying failure).
"""
from __future__ import annotations

import random
import time
from dataclasses import dataclass
from typing import Callable, Optional, Tuple, Type


class RetryBudgetExceeded(RuntimeError):
    """The overall wall-clock ``deadline`` of a :class:`RetryPolicy` ran
    out before the attempts did. Carries how far the retry loop got; the
    underlying failure is chained as ``__cause__``."""

    def __init__(self, attempts: int, elapsed: float,
                 deadline: float) -> None:
        self.attempts = attempts
        self.elapsed = elapsed
        self.deadline = deadline
        super().__init__(
            f"retry budget exceeded after {attempts} attempt(s): "
            f"{elapsed:.3f}s elapsed of a {deadline:.3f}s deadline")


@dataclass(frozen=True)
class RetryPolicy:
    """Backoff shape: ``attempts`` total tries, delay before retry *k*
    (0-indexed) drawn from ``U(0, min(cap, base * 2**k))``; ``jitter=
    False`` uses the deterministic upper bound instead. ``deadline``
    (seconds, ``None`` = unbounded) caps the whole loop's wall clock: a
    retry is only attempted if its backoff sleep still fits inside the
    budget."""

    attempts: int = 3
    base: float = 0.05
    cap: float = 2.0
    jitter: bool = True
    deadline: Optional[float] = None

    def __post_init__(self) -> None:
        if self.attempts < 1:
            raise ValueError(f"attempts must be >= 1, got {self.attempts}")
        if self.base < 0 or self.cap < 0:
            raise ValueError("base/cap must be >= 0")
        if self.deadline is not None and self.deadline < 0:
            raise ValueError(f"deadline must be >= 0, got {self.deadline}")

    def delay(self, attempt: int, rng: random.Random) -> float:
        bound = min(self.cap, self.base * (2.0 ** attempt))
        return rng.uniform(0.0, bound) if self.jitter else bound


def retry_call(fn: Callable, *,
               policy: Optional[RetryPolicy] = None,
               retry_on: Tuple[Type[BaseException], ...] = (Exception,),
               rng: Optional[random.Random] = None,
               seed: int = 0,
               sleep: Callable[[float], None] = time.sleep,
               clock: Callable[[], float] = time.monotonic,
               on_retry: Optional[Callable] = None):
    """Call ``fn()`` up to ``policy.attempts`` times.

    Exceptions matching ``retry_on`` trigger a backoff sleep and a
    retry; the last attempt's exception propagates unchanged (callers
    escalate — e.g. the executor turns an exhausted transient fault into
    a fatal member drop). When the policy carries a ``deadline``, a
    retry whose sleep would overrun it raises
    :class:`RetryBudgetExceeded` from the triggering exception instead
    of sleeping. ``on_retry(attempt, exc, delay)`` observes every retry
    (stats counters); ``sleep`` and ``clock`` are injectable so tests
    run without wall-clock delays.
    """
    policy = policy or RetryPolicy()
    rng = rng if rng is not None else random.Random(seed)
    start = clock()
    for attempt in range(policy.attempts):
        try:
            return fn()
        except retry_on as exc:
            if attempt == policy.attempts - 1:
                raise
            delay = policy.delay(attempt, rng)
            if policy.deadline is not None:
                elapsed = clock() - start
                if elapsed + delay > policy.deadline:
                    raise RetryBudgetExceeded(
                        attempt + 1, elapsed, policy.deadline) from exc
            if on_retry is not None:
                on_retry(attempt, exc, delay)
            sleep(delay)
    raise AssertionError("unreachable")   # pragma: no cover
