"""Retry policy, round time budgets and backoff.

A :class:`Budget` is a wall-clock allowance for one reconcile round. While
one is active (``with budget.activate(): ...``), the sidecar client sends
its remaining seconds with every Pack, refuses to dispatch once it expired,
and the sidecar sheds the work before it reaches the device; a
:class:`RetryPolicy` caps its per-operation deadline by what remains of it,
so retries never outlive the round that issued them.

Backoff is *decorrelated jitter*: each sleep is drawn uniformly from
``[base, 3 * previous_sleep]`` and capped, which spreads a herd of retries
over the window instead of synchronizing it.
"""

from __future__ import annotations

import contextvars
import random
import time
from typing import Callable, Iterator, Optional

from karpenter_tpu_torch import metrics

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


# Exceptions that retrying cannot fix: capacity signals (the ICE caches own
# those), positive not-found answers, validation/programming errors.
# Everything else — throttles, injected control-plane failures, connection
# resets — is presumed transient. Vendor errors are matched by name so this
# module needs no dependency on any provider.
_NON_RETRYABLE_NAMES = frozenset(
    {
        "InsufficientCapacityError",
        "GkeStockoutError",
        "GkeApiError",
        "InstanceNotFoundError",
        # overload-control verdicts (resilience/overload.py): a shed must
        # never become a retry storm, and an expired deadline cannot be
        # retried into existence
        "OverloadedError",
        "DeadlineExceededError",
    }
)


def default_retryable(exc: BaseException) -> bool:
    if isinstance(exc, (ValueError, TypeError, KeyError)):
        return False
    for cls in type(exc).__mro__:
        if cls.__name__ in _NON_RETRYABLE_NAMES:
            return False
    return True


class RetryPolicy:
    """Bounded retries with decorrelated jitter and a hard deadline.

    ``call(fn)`` runs ``fn`` up to ``max_attempts`` times. A retry happens
    only when ``retryable(exc)`` says so AND the next backoff sleep still
    fits inside the per-operation deadline (further capped by the active
    round :class:`Budget`); otherwise the last exception propagates. The
    ``dependency`` label feeds the ``retries_total`` /
    ``deadline_exceeded_total`` counters. A labelled policy also spends
    one token of its dependency's :class:`RetryBudget` per retry.
    """

    def __init__(
        self,
        max_attempts: int = 3,
        base: float = 0.05,
        cap: float = 2.0,
        deadline: float = 15.0,
        retryable: Callable[[BaseException], bool] = default_retryable,
        dependency: str = "",
        rng: Optional[random.Random] = None,
        clock: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] = time.sleep,
        retry_budget=None,
    ):
        self.max_attempts = max(int(max_attempts), 1)
        self.base = base
        self.cap = cap
        self.deadline = deadline
        self.retryable = retryable
        self.dependency = dependency
        self._rng = rng
        self._clock = clock
        self._sleep = sleep
        # None + a dependency label = the process-shared default budget;
        # an unlabelled policy keeps no budget (nothing to draw down)
        self._retry_budget = retry_budget

    def effective_deadline(self) -> float:
        """Seconds this operation may spend: the policy deadline, capped by
        the active round budget (if any). The first attempt always runs —
        an exhausted budget degrades to retry-free, not to no work."""
        budget = current_budget.get()
        if budget is None:
            return self.deadline
        return min(self.deadline, max(budget.remaining(), 0.0))

    def _budget(self):
        if self._retry_budget is not None:
            return self._retry_budget
        if not self.dependency:
            return None
        from karpenter_tpu_torch.resilience.overload import default_retry_budget

        return default_retry_budget()

    def call(self, fn: Callable, *args, **kwargs):
        start = self._clock()
        allowance = self.effective_deadline()
        backoffs = decorrelated_jitter(self.base, self.cap, self._rng)
        budget = self._budget()
        last: Optional[BaseException] = None
        for attempt in range(self.max_attempts):
            try:
                out = fn(*args, **kwargs)
            except Exception as e:  # noqa: BLE001 — classification decides
                last = e
                if attempt + 1 >= self.max_attempts or not self.retryable(e):
                    raise
                pause = next(backoffs)
                if self._clock() - start + pause > allowance:
                    metrics.RESILIENCE_DEADLINE_EXCEEDED.labels(
                        dependency=self.dependency or "unknown"
                    ).inc()
                    raise
                # a dry bucket propagates the failure instead of
                # multiplying the load on the dependency
                if budget is not None and not budget.try_spend(self.dependency):
                    metrics.RESILIENCE_RETRIES.labels(
                        dependency=self.dependency or "unknown",
                        outcome="budget_exhausted",
                    ).inc()
                    raise
                metrics.RESILIENCE_RETRIES.labels(
                    dependency=self.dependency or "unknown", outcome="retried"
                ).inc()
                self._sleep(pause)
            else:
                # successes refill the bucket
                if budget is not None:
                    budget.record_success(self.dependency)
                return out
        raise last if last is not None else AssertionError("unreachable")
