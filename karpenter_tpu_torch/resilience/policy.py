"""Round time budgets and backoff.

A :class:`Budget` is a wall-clock allowance for one reconcile round. While
one is active (``with budget.activate(): ...``), the sidecar client sends
its remaining seconds with every Pack, refuses to dispatch once it expired,
and the sidecar sheds the work before it reaches the device.

Backoff is *decorrelated jitter*: each sleep is drawn uniformly from
``[base, 3 * previous_sleep]`` and capped, which spreads a herd of retries
over the window instead of synchronizing it.
"""

from __future__ import annotations

import contextvars
import random
import time
from typing import Callable, Iterator, Optional

# The reconcile round currently executing, when the caller activated one.
current_budget: contextvars.ContextVar[Optional["Budget"]] = contextvars.ContextVar(
    "resilience_budget", default=None
)


class Budget:
    """A wall-clock allowance for one reconcile round, shared by everything
    the round does: ``remaining()`` is global to the round."""

    def __init__(self, seconds: float, clock: Callable[[], float] = time.monotonic):
        self.seconds = float(seconds)
        self._clock = clock
        self._deadline = clock() + self.seconds

    def remaining(self) -> float:
        return max(self._deadline - self._clock(), 0.0)

    @property
    def expired(self) -> bool:
        return self.remaining() <= 0.0

    def activate(self) -> "_BudgetContext":
        """Install this budget as the calling thread's ambient budget
        (``with budget.activate(): ...``)."""
        return _BudgetContext(self)


class _BudgetContext:
    def __init__(self, budget: Budget):
        self._budget = budget
        self._token: Optional[contextvars.Token] = None

    def __enter__(self) -> Budget:
        self._token = current_budget.set(self._budget)
        return self._budget

    def __exit__(self, *exc) -> None:
        if self._token is not None:
            current_budget.reset(self._token)


def decorrelated_jitter(
    base: float,
    cap: float,
    rng: Optional[random.Random] = None,
) -> Iterator[float]:
    """Endless sleep sequence: ``sleep = min(cap, uniform(base, 3 * prev))``."""
    rng = rng or random
    sleep = base
    while True:
        sleep = min(cap, rng.uniform(base, sleep * 3))
        yield sleep
