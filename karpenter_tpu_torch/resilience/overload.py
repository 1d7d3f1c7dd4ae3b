"""The overload verdicts of the solver wire.

Two failure classes that are not failures in the breaker sense:

- :class:`OverloadedError`: the sidecar is alive but refusing work (its
  bounded admission queue is full, or its device headroom is under the
  floor). It carries the sidecar's retry-after hint. Tripping a circuit
  breaker on it would turn a brownout into an outage, so the caller serves
  the batch in process instead.
- :class:`DeadlineExceededError`: the work's own deadline (the propagated
  round :class:`~karpenter_tpu_torch.resilience.policy.Budget`) expired.
  Retrying is useless by definition.

:class:`RetryBudget` is the third leg: even for retryable failures, a
dependency that keeps failing earns fewer retries. Tokens are spent per
retry and refilled by successes, so a healthy dependency retries freely
while a drowning one degrades to fail-fast.

Standard library only: the sidecar's codec and client import it.
"""

from __future__ import annotations

import threading
from typing import Dict

# ~10 retries of burst headroom per dependency, earned back at one token
# per 10 successes: a dependency failing more than ~10% of the time
# exhausts the budget and fails fast.
RETRY_BUDGET_CAPACITY = 10.0
RETRY_BUDGET_REFILL_PER_SUCCESS = 0.1


class OverloadedError(RuntimeError):
    """The sidecar shed this request under load: it is alive and will
    recover, so retry after the hint or serve elsewhere. ``kind`` names the
    bound that fired (``"admission"``: the sidecar's bounded queue or its
    device-headroom floor; ``"credits"``: the stream's credit window, empty
    at the sender)."""

    def __init__(
        self, message: str, retry_after: float = 1.0, kind: str = "admission"
    ):
        super().__init__(message)
        self.retry_after = max(float(retry_after), 0.0)
        self.kind = kind


class DeadlineExceededError(RuntimeError):
    """The operation's propagated deadline expired before (or while) the
    work ran: not retryable."""


class RetryBudget:
    """Per-dependency retry token bucket, refilled by successes.

    ``try_spend`` consumes one token per retry attempt; ``record_success``
    refills ``refill_per_success`` tokens (capped). A fresh dependency
    starts with a full bucket, so a transient blip retries normally; a
    sustained failure rate drains it and the retries stop multiplying the
    load on an overloaded dependency.
    """

    def __init__(
        self,
        capacity: float = RETRY_BUDGET_CAPACITY,
        refill_per_success: float = RETRY_BUDGET_REFILL_PER_SUCCESS,
    ):
        self.capacity = float(capacity)
        self.refill_per_success = float(refill_per_success)
        self._tokens: Dict[str, float] = {}  # guarded-by: self._lock
        self._lock = threading.Lock()

    def try_spend(self, dependency: str) -> bool:
        """Spend one retry token; False means the budget is exhausted and
        the caller must propagate the failure instead of retrying."""
        with self._lock:
            tokens = self._tokens.get(dependency, self.capacity)
            if tokens < 1.0:
                return False
            self._tokens[dependency] = tokens - 1.0
            return True

    def record_success(self, dependency: str) -> None:
        with self._lock:
            tokens = self._tokens.get(dependency, self.capacity)
            self._tokens[dependency] = min(
                self.capacity, tokens + self.refill_per_success
            )

    def remaining(self, dependency: str) -> float:
        with self._lock:
            return self._tokens.get(dependency, self.capacity)

    def snapshot(self) -> Dict[str, float]:
        """{dependency: tokens} for the dependencies that have drawn down."""
        with self._lock:
            return {k: round(v, 3) for k, v in sorted(self._tokens.items())}


# Process-shared default: every RetryPolicy with a dependency label draws
# from one bucket per dependency, so concurrent callers (launch threads,
# pollers) share one self-limit.
_default_lock = threading.Lock()
_default: RetryBudget = RetryBudget()


def default_retry_budget() -> RetryBudget:
    with _default_lock:
        return _default


def reset_default_retry_budget() -> None:
    """Tests isolate budget drawdown with this."""
    global _default
    with _default_lock:
        _default = RetryBudget()
