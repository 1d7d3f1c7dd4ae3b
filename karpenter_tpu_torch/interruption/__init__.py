"""The disruption event model (``types.py``): the notices a cloud provider
announces and the poll protocol it serves them through. The orchestrator
that responds to them is not ported yet."""

from karpenter_tpu_torch.interruption.types import (  # noqa: F401
    CAPACITY_RECLAIM,
    DEFAULT_GRACE_PERIOD_SECONDS,
    KINDS,
    MAINTENANCE,
    PREEMPTION,
    DisruptionNotice,
    DisruptionSource,
    NoticeQueue,
)
