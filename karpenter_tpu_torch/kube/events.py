"""Operator-visible Events for controller actions.

``EventRecorder`` mirrors client-go's recorder shape: fire-and-forget (an
event that fails to write must never fail the action that caused it),
deduplicating repeats of the same (object, reason, message) into a count
bump within an aggregation window, like the apiserver's event series
handling. Events land in the cluster's ``events`` store
(``cluster.list("events")``).
"""

from __future__ import annotations

import copy
import logging
import threading
from collections import OrderedDict
from typing import Optional, Tuple

from karpenter_tpu_torch.api.objects import Event, ObjectMeta
from karpenter_tpu_torch.kube.client import Cluster

logger = logging.getLogger("karpenter.events")

AGGREGATION_WINDOW = 600.0  # repeats inside this window bump count

# annotation linking an emitted Event to the trace of the action that
# emitted it: an event's trace id greps into /debug/traces (and the flight
# dir)
TRACE_ID_ANNOTATION = "karpenter.sh/trace-id"

# annotation linking an emitted Event to the decision that caused it: the
# id greps into /debug/decisions (and the decision ring, where
# obs/replay.py re-solves it)
DECISION_ID_ANNOTATION = "karpenter.sh/decision-id"


class EventRecorder:
    def __init__(self, cluster: Cluster, component: str = "karpenter-tpu"):
        self.cluster = cluster
        self.component = component
        self._lock = threading.Lock()
        # insertion/update-ordered so overflow evicts the least recently
        # UPDATED key in O(1) — an age-only prune cannot shrink the table
        # during a distinct-event storm inside the aggregation window
        self._seen: "OrderedDict[Tuple, Tuple[float, Event]]" = OrderedDict()  # guarded-by: self._lock
        self._counter = 0  # guarded-by: self._lock

    def _bump(self, key, now, exclude=None):
        """Under the lock: if ``key`` holds a live aggregation entry (other
        than ``exclude``, the object whose server copy is known pruned),
        bump its count and return ``(event, wire_snapshot)``. The snapshot
        is taken under the lock: the store write happens outside it and
        races with other threads' bumps, and a half-mutated event must
        never be written. Returns ``(None, None)`` on miss."""
        with self._lock:
            hit = self._seen.get(key)
            if (
                hit is None
                or hit[1] is exclude
                or now - hit[0] >= AGGREGATION_WINDOW
            ):
                return None, None
            ev = hit[1]
            ev.count += 1
            ev.last_timestamp = now
            self._seen[key] = (now, ev)
            self._seen.move_to_end(key)
            return ev, copy.copy(ev)

    def event(
        self,
        involved_kind: str,
        involved_name: str,
        reason: str,
        message: str,
        type: str = "Normal",
        namespace: str = "",
        decision_id: str = "",
    ) -> Optional[Event]:
        """Record an event; returns the stored object (or None on failure —
        recording is never allowed to break the calling controller)."""
        try:
            now = self.cluster.clock()
            key = (involved_kind, involved_name, namespace, reason, message)
            # the lock guards only _seen/_counter bookkeeping; store writes
            # happen outside it so a slow store cannot serialize every
            # controller's event emission behind this recorder
            ev, snapshot = self._bump(key, now)
            stale = None
            if ev is not None:
                try:
                    self.cluster.update("events", snapshot)
                except Exception:
                    stale = ev  # pruned server-side: re-create below
                else:
                    return ev
            # re-check: another thread may have created this key while we
            # were outside the lock. Bump that fresh event instead of
            # creating a near-simultaneous duplicate — unless the entry is
            # the very object whose update just failed, which must be
            # replaced, not bumped forever.
            ev, snapshot = self._bump(key, now, exclude=stale)
            if ev is not None:
                try:
                    self.cluster.update("events", snapshot)
                except Exception:
                    pass  # fire-and-forget; aggregation already recorded
                return ev
            with self._lock:
                self._counter += 1
                name = f"{involved_name}.{self._counter:x}.{int(now)}"
            meta = ObjectMeta(name=name, namespace=namespace or "default")
            # annotate with the active trace id, inside the same guarded
            # region as the write: tracing trouble must never fail the
            # traced action
            from karpenter_tpu_torch import obs

            span = obs.tracer().current()
            if span is not None:
                meta.annotations[TRACE_ID_ANNOTATION] = span.trace_id
            # the decision-id annotation (empty = the emitter predates any
            # decision)
            if decision_id:
                meta.annotations[DECISION_ID_ANNOTATION] = decision_id
            ev = Event(
                metadata=meta,
                involved_kind=involved_kind,
                involved_name=involved_name,
                involved_namespace=namespace,
                reason=reason,
                message=message,
                type=type,
                source_component=self.component,
                first_timestamp=now,
                last_timestamp=now,
            )
            self.cluster.create("events", ev)
            with self._lock:
                self._seen[key] = (now, ev)
                self._seen.move_to_end(key)
                # hard cap: evict least-recently-updated (an evicted key
                # merely loses aggregation — its next emit re-creates)
                while len(self._seen) > 4096:
                    self._seen.popitem(last=False)
            return ev
        except Exception:
            logger.debug("event emit failed", exc_info=True)
            return None


def recorder_for(cluster: Cluster) -> EventRecorder:
    """One recorder per cluster object (controllers share it)."""
    rec = getattr(cluster, "_event_recorder", None)
    if rec is None:
        rec = EventRecorder(cluster)
        try:
            cluster._event_recorder = rec
        except AttributeError:
            pass
    return rec
