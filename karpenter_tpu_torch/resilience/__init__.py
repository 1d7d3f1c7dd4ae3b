"""Failure handling around the accelerated solve: the per-dependency
:class:`CircuitBreaker` (closed/open/half-open on a windowed failure rate,
``trip()`` for correctness failures), the :class:`BreakerBoard` the
scheduler keeps its per-shape-class pack breakers on, the
:class:`BreakerOpen` a caller raises when a breaker refuses a call, the
solver wire's typed verdicts (:class:`IntegrityError`,
:class:`OverloadedError`, :class:`DeadlineExceededError`), and the round
:class:`Budget` with :func:`decorrelated_jitter` backoff."""

from karpenter_tpu_torch.resilience.breaker import (  # noqa: F401
    BreakerBoard,
    BreakerOpen,
    CircuitBreaker,
)
from karpenter_tpu_torch.resilience.integrity import IntegrityError  # noqa: F401
from karpenter_tpu_torch.resilience.overload import (  # noqa: F401
    DeadlineExceededError,
    OverloadedError,
)
from karpenter_tpu_torch.resilience.policy import (  # noqa: F401
    Budget,
    current_budget,
    decorrelated_jitter,
)
