"""Failure handling around the accelerated solve: the per-dependency
:class:`CircuitBreaker` (closed/open/half-open on a windowed failure rate,
``trip()`` for correctness failures), the :class:`BreakerBoard` the
scheduler keeps its per-shape-class pack breakers on and the metered cloud
provider its per-method breakers, the
:class:`BreakerOpen` a caller raises when a breaker refuses a call, the
solver wire's typed verdicts (:class:`IntegrityError`,
:class:`OverloadedError`, :class:`DeadlineExceededError`), the round
:class:`Budget` with :func:`decorrelated_jitter` backoff, the
:class:`RetryPolicy` the metered cloud provider and the HTTP cloud wire
retry through with the per-dependency :class:`RetryBudget` it spends, the
``@idempotent`` marker that opts a callable into its retries, and the
:class:`MissTracker` that debounces a cloud's describe misses before a
node counts as gone."""

from karpenter_tpu_torch.resilience.breaker import (  # noqa: F401
    BreakerBoard,
    BreakerOpen,
    CircuitBreaker,
)
from karpenter_tpu_torch.resilience.integrity import IntegrityError  # noqa: F401
from karpenter_tpu_torch.resilience.liveness import MissTracker  # noqa: F401
from karpenter_tpu_torch.resilience.markers import idempotent, is_idempotent  # noqa: F401
from karpenter_tpu_torch.resilience.overload import (  # noqa: F401
    DeadlineExceededError,
    OverloadedError,
    RetryBudget,
    default_retry_budget,
    reset_default_retry_budget,
)
from karpenter_tpu_torch.resilience.policy import (  # noqa: F401
    Budget,
    RetryPolicy,
    current_budget,
    decorrelated_jitter,
    default_retryable,
)
