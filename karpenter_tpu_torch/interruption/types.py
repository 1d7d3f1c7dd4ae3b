"""Disruption event model: cloud-initiated node loss, typed.

The reference snapshot (v0.8.0) has no interruption handling — nodes retire
only when empty or expired; the project's own next major feature was a
native interruption controller that drains ahead of the termination notice
(the SQS/EventBridge consumer that later shipped as
``pkg/controllers/interruption``). This module is the vendor-neutral core
of that subsystem: a ``DisruptionNotice`` describes one cloud-initiated
disruption (spot preemption, maintenance window, capacity reclaim) with the
grace period the cloud promises before the capacity disappears, and
``DisruptionSource`` is the poll protocol every cloud provider implements
(``FakeCloudProvider`` here).

Poll semantics are drain-the-queue: each ``poll_disruptions()`` call
returns every notice that arrived since the previous call and removes them
from the source — the controller is the only consumer, so at-most-once
delivery per process is the contract (a dropped notice re-manifests as the
node vanishing, which the node lifecycle already survives).
"""

from __future__ import annotations

import abc
import threading
from dataclasses import dataclass
from typing import Any, Dict, List

# Notice kinds — the vocabulary every provider maps its own event bus into
# (EC2 spot interruption / GCE preemption → PREEMPTION, scheduled
# maintenance → MAINTENANCE, capacity-pool reclaim → CAPACITY_RECLAIM).
PREEMPTION = "preemption"
MAINTENANCE = "maintenance"
CAPACITY_RECLAIM = "capacity-reclaim"

KINDS = (PREEMPTION, MAINTENANCE, CAPACITY_RECLAIM)

# Vendor default when a notice carries no grace period: the 2-minute spot
# interruption warning both EC2 and GCE give.
DEFAULT_GRACE_PERIOD_SECONDS = 120.0


@dataclass(frozen=True)
class DisruptionNotice:
    """One cloud-initiated disruption of one node.

    ``node_name`` is the CLUSTER node name (``metadata.name``) — every
    vendor here names its Node objects after the instance, so the provider
    can emit cluster-addressable notices without a reverse lookup.
    ``grace_period_seconds`` is the cloud's promise: after that long the
    instance is gone whether or not the drain finished."""

    kind: str
    node_name: str
    grace_period_seconds: float = DEFAULT_GRACE_PERIOD_SECONDS
    issued_at: float = 0.0
    reason: str = ""

    def to_wire(self) -> Dict[str, Any]:
        """JSON shape served by the httpapi ``/events`` routes."""
        return {
            "kind": self.kind,
            "nodeName": self.node_name,
            "gracePeriodSeconds": self.grace_period_seconds,
            "issuedAt": self.issued_at,
            "reason": self.reason,
        }

    @staticmethod
    def from_wire(doc: Dict[str, Any]) -> "DisruptionNotice":
        return DisruptionNotice(
            kind=str(doc.get("kind", PREEMPTION)),
            node_name=str(doc.get("nodeName", "")),
            grace_period_seconds=float(
                doc.get("gracePeriodSeconds", DEFAULT_GRACE_PERIOD_SECONDS)
            ),
            issued_at=float(doc.get("issuedAt", 0.0)),
            reason=str(doc.get("reason", "")),
        )


class DisruptionSource(abc.ABC):
    """The provider-side half of the subsystem: something that can be
    polled for pending disruption notices. ``CloudProvider`` carries a
    default no-op implementation, so the controller can poll any provider;
    vendors opt in by returning real notices."""

    @abc.abstractmethod
    def poll_disruptions(self) -> List[DisruptionNotice]:
        """Return-and-clear every notice that arrived since the last poll."""


class NoticeQueue:
    """Thread-safe pending-notice buffer the provider doubles share: test
    harnesses and fault injectors ``push`` from any thread; the controller's
    poll ``drain``s. Deduplicates by (kind, node): a cloud that re-announces
    the same preemption every poll interval (as EC2's instance-action
    metadata does) must not restart the response each time."""

    def __init__(self) -> None:
        self._mu = threading.Lock()
        self._pending: List[DisruptionNotice] = []
        self._keys: set = set()

    def push(self, notice: DisruptionNotice) -> bool:
        """Queue a notice; returns False when an identical (kind, node)
        notice is already pending (the re-announcement case)."""
        key = (notice.kind, notice.node_name)
        with self._mu:
            if key in self._keys:
                return False
            self._keys.add(key)
            self._pending.append(notice)
            return True

    def drain(self) -> List[DisruptionNotice]:
        with self._mu:
            out, self._pending = self._pending, []
            self._keys.clear()
            return out

    def __len__(self) -> int:
        with self._mu:
            return len(self._pending)
