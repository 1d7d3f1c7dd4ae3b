"""Failure handling around the accelerated solve: the per-dependency
:class:`CircuitBreaker` (closed/open/half-open on a windowed failure rate,
``trip()`` for correctness failures), the :class:`BreakerBoard` the
scheduler keeps its per-shape-class pack breakers on, and the
:class:`BreakerOpen` a caller raises when a breaker refuses a call."""

from karpenter_tpu_torch.resilience.breaker import (  # noqa: F401
    BreakerBoard,
    BreakerOpen,
    CircuitBreaker,
)
