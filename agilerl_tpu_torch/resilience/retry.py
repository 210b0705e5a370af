"""Retry/backoff policies for flaky HOST-LOCAL edges: the port of
``agilerl_tpu/resilience/retry.py`` (whole; pure Python).

The device-side math is deterministic; what flakes in production are host
boundaries — env ``reset``/``step`` over subprocess pipes or network sims,
dataset fetches, metadata servers. These helpers wrap exactly those edges
with bounded exponential backoff and warn-once telemetry
(``resilience/retries_total``), so transient faults cost a retry instead of
a dead multi-day run — and persistent faults still raise.

Multihost COLLECTIVES are deliberately out of scope: a per-host retry of a
collective desynchronizes the pod (the retrying host re-sends an op its
peers already completed and pairs with the wrong collective, deadlocking
until the runtime timeout). Collectives fail fast; snapshot-resume
(:mod:`agilerl_tpu_torch.resilience.snapshot`) is their recovery path.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Tuple


@dataclass(frozen=True)
class RetryPolicy:
    """Bounded exponential backoff. ``retry_on`` lists the exception types
    considered transient — anything else propagates immediately."""

    max_attempts: int = 3
    backoff_s: float = 0.05
    backoff_mult: float = 2.0
    max_backoff_s: float = 2.0
    retry_on: Tuple[type, ...] = field(
        default=(ConnectionError, TimeoutError, OSError, BrokenPipeError)
    )

    def delay(self, attempt: int) -> float:
        """Backoff before retry number ``attempt`` (1-based)."""
        return min(
            self.backoff_s * (self.backoff_mult ** (attempt - 1)),
            self.max_backoff_s,
        )


#: conservative default for env edges: three tries, sub-second total backoff
DEFAULT_ENV_POLICY = RetryPolicy()


def call_with_retries(
    fn: Callable,
    *args,
    policy: Optional[RetryPolicy] = None,
    name: str = "op",
    registry=None,
    sleep: Callable[[float], None] = time.sleep,
    **kwargs,
) -> Any:
    """Run ``fn(*args, **kwargs)`` under ``policy``. Each retry increments
    ``resilience/retries_total`` and warn-onces per call-site name; the final
    failure re-raises the last exception untouched."""
    policy = policy or DEFAULT_ENV_POLICY
    if registry is None:
        from agilerl_tpu_torch.observability import get_registry

        registry = get_registry()
    last_exc: Optional[BaseException] = None
    for attempt in range(1, policy.max_attempts + 1):
        try:
            return fn(*args, **kwargs)
        except policy.retry_on as e:
            last_exc = e
            if attempt >= policy.max_attempts:
                raise
            registry.counter("resilience/retries_total").inc()
            registry.counter(f"resilience/retries_total:{name}").inc()
            registry.warn_once(
                f"resilience:retry:{name}",
                f"transient failure in {name} ({type(e).__name__}: {e}); "
                f"retrying up to {policy.max_attempts - attempt} more time(s)",
            )
            sleep(policy.delay(attempt))
    raise last_exc  # pragma: no cover - loop always returns or raises


def with_retries(
    policy: Optional[RetryPolicy] = None,
    name: Optional[str] = None,
    registry=None,
) -> Callable[[Callable], Callable]:
    """Decorator form of :func:`call_with_retries`."""

    def deco(fn: Callable) -> Callable:
        import functools

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            return call_with_retries(
                fn, *args, policy=policy, name=name or fn.__name__,
                registry=registry, **kwargs,
            )

        return wrapped

    return deco


class RetryingEnv:
    """Env proxy whose ``reset``/``step`` run under a :class:`RetryPolicy`.

    On a retried ``step`` the wrapped env may be mid-episode in an undefined
    state, so subclass-specific recovery (e.g. a forced reset) can be wired
    via ``on_step_retry``; the default simply retries the call, which is the
    right behaviour for connection-level flakes where the remote state
    machine is intact.
    """

    def __init__(
        self,
        env,
        policy: Optional[RetryPolicy] = None,
        registry=None,
        sleep: Callable[[float], None] = time.sleep,
        on_step_retry: Optional[Callable[["RetryingEnv"], None]] = None,
    ):
        self.env = env
        self.policy = policy or DEFAULT_ENV_POLICY
        self._registry = registry
        self._sleep = sleep
        self._on_step_retry = on_step_retry

    def reset(self, *args, **kwargs):
        return call_with_retries(
            self.env.reset, *args, policy=self.policy, name="env.reset",
            registry=self._registry, sleep=self._sleep, **kwargs,
        )

    def step(self, *args, **kwargs):
        attempt = 0

        def run():
            nonlocal attempt
            attempt += 1
            if attempt > 1 and self._on_step_retry is not None:
                self._on_step_retry(self)
            return self.env.step(*args, **kwargs)

        return call_with_retries(
            run, policy=self.policy, name="env.step",
            registry=self._registry, sleep=self._sleep,
        )

    def __getattr__(self, item):
        return getattr(self.env, item)
