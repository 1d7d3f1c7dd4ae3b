"""Interruption subsystem: preemption-aware node lifecycle.

Watches a cloud disruption-event stream (``DisruptionSource``) and
orchestrates the response — taint + cordon, Kubernetes event, proactive
replacement through the provisioning batcher, then finalizer-driven
termination under a grace-period deadline.
"""

from karpenter_tpu_torch.interruption.orchestrator import Orchestrator, Response
from karpenter_tpu_torch.interruption.types import (
    CAPACITY_RECLAIM,
    DEFAULT_GRACE_PERIOD_SECONDS,
    KINDS,
    MAINTENANCE,
    PREEMPTION,
    DisruptionNotice,
    DisruptionSource,
    NoticeQueue,
)

__all__ = [
    "CAPACITY_RECLAIM",
    "DEFAULT_GRACE_PERIOD_SECONDS",
    "DisruptionNotice",
    "DisruptionSource",
    "KINDS",
    "MAINTENANCE",
    "NoticeQueue",
    "Orchestrator",
    "PREEMPTION",
    "Response",
]
