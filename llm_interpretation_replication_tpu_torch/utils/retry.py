"""Retry with exponential backoff (a copy of ``utils/retry.py``'s
``RetryPolicy`` and ``retry_with_exponential_backoff``).

Up to 10 retries, initial delay 60 s doubling to a 300 s cap,
multiplicative jitter in [0.8, 1.2], retry on the policy's error classes,
re-raise after exhaustion; sleep and rng are injectable so tests run
instantly.
"""

from __future__ import annotations

import functools
import random
import time
from dataclasses import dataclass, field
from typing import Callable, Optional, Tuple, Type


@dataclass
class RetryPolicy:
    max_retries: int = 10
    initial_delay: float = 60.0
    max_delay: float = 300.0
    exponential_base: float = 2.0
    jitter: Tuple[float, float] = (0.8, 1.2)
    retry_on: Tuple[Type[BaseException], ...] = (Exception,)
    # consulted after the class check: an error retries only when
    # isinstance(err, retry_on) and retry_predicate(err)
    retry_predicate: Optional[Callable[[BaseException], bool]] = None
    sleep: Callable[[float], None] = field(default=time.sleep)
    rng: random.Random = field(default_factory=random.Random)
    # full jitter: the delay is uniform in [0, clamped base] instead of
    # base * uniform(jitter)
    full_jitter: bool = False

    def delay_for_attempt(self, attempt: int) -> float:
        base = min(self.initial_delay * self.exponential_base**attempt, self.max_delay)
        if self.full_jitter:
            return self.rng.uniform(0.0, base)
        lo, hi = self.jitter
        # clamped after the jitter, so hi > 1 never exceeds max_delay
        return min(base * self.rng.uniform(lo, hi), self.max_delay)


def retry_with_exponential_backoff(policy: RetryPolicy | None = None, **overrides):
    """Decorator: retry the wrapped callable per ``policy`` (the reference
    defaults when called with no arguments; keyword overrides build a fresh
    policy)."""
    if callable(policy) and not isinstance(policy, RetryPolicy):
        fn, policy = policy, RetryPolicy()
        return retry_with_exponential_backoff(policy)(fn)
    if policy is None:
        policy = RetryPolicy(**overrides)
    elif overrides:
        raise ValueError("pass either a policy or overrides, not both")

    def decorator(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            last_err = None
            for attempt in range(policy.max_retries + 1):
                try:
                    return fn(*args, **kwargs)
                except policy.retry_on as err:  # noqa: PERF203
                    last_err = err
                    if attempt == policy.max_retries:
                        break
                    # consulted only when a retry would happen, so a
                    # recording predicate never logs a retry for the final,
                    # propagating failure
                    if (policy.retry_predicate is not None
                            and not policy.retry_predicate(err)):
                        raise
                    policy.sleep(policy.delay_for_attempt(attempt))
            raise last_err

        return wrapper

    return decorator
