"""Interruption: poll the cloud's disruption stream, drive the response.

The port's copy of ``karpenter_tpu/controllers/interruption.py``: the
subsystem built on the framework's own event source — every cloud provider
implements ``poll_disruptions()`` (``karpenter_tpu_torch/interruption``).
A notice's replacement round is solved by the provisioning worker that
admits the released pods, on that worker's ``device``.

Two key spaces share one workqueue:

- ``POLL_KEY`` — the standing poll: drain the provider's notice queue,
  dispatch each notice to the orchestrator, requeue after
  ``poll_interval`` (the self-rescheduling-reconcile idiom the catalog
  refresh also uses).
- a node name — that node's grace-period deadline: requeue until the node
  is gone (drain completed) or the deadline passes (force-terminate).

Replacement lead time is observed from the pod watch: the orchestrator
records when each pod was injected for replacement; the watch sees the
re-bind (nodeName set again) and the difference is the histogram sample —
how long the workload waited for replacement capacity.
"""

from __future__ import annotations

import logging
import threading
from collections import deque
from typing import Dict, Optional

from karpenter_tpu_torch import metrics
from karpenter_tpu_torch.interruption.orchestrator import Orchestrator
from karpenter_tpu_torch.interruption.types import DisruptionNotice
from karpenter_tpu_torch.kube.client import Cluster

logger = logging.getLogger("karpenter.interruption")

# Notice latency budget: EC2/GCE give 30-120s warnings, so a 2s poll keeps
# the response well inside the grace period without hammering the API.
POLL_INTERVAL = 2.0

# Deadline watch granularity: how often a tracked node is re-checked while
# its grace period runs down (the drain usually finishes long before).
DEADLINE_REQUEUE = 1.0

POLL_KEY = "__poll__"  # never a valid node name (not DNS-1123)


class InterruptionController:
    def __init__(
        self,
        cluster: Cluster,
        cloud_provider,
        provisioning=None,
        termination=None,
        poll_interval: float = POLL_INTERVAL,
        ownership=None,
    ):
        self.cluster = cluster
        self.cloud_provider = cloud_provider
        self.poll_interval = poll_interval
        # fleet.ShardManager (or None = this replica handles everything):
        # a notice for a node whose provisioner shard another replica owns
        # is requeued to the provider stream — two replicas must never
        # orchestrate (taint/drain/force-terminate) the same node
        self.ownership = ownership
        self.foreign_notices = 0  # requeued to the owner; test observability
        self.orchestrator = Orchestrator(
            cluster, cloud_provider, provisioning, termination
        )
        self._mu = threading.Lock()
        # node name -> grace deadline (cluster-clock seconds)
        self._deadlines: Dict[str, float] = {}
        # pod key -> notice time, awaiting the replacement re-bind
        self._awaiting: Dict[str, float] = {}
        self._manager = None
        # bench/test observability (the prometheus histogram is the
        # production scrape); bounded so a long-lived process on a
        # spot-heavy fleet doesn't grow it without limit
        self.lead_times: "deque[float]" = deque(maxlen=10000)
        # watches attach at construction, not register(): inline test
        # harnesses drive reconcile() without a manager and still need the
        # re-bind observation to fire
        self.cluster.watch("pods", self._on_pod)
        self.cluster.watch("nodes", self._on_node)

    # -- observability -----------------------------------------------------
    @property
    def evicted_unready(self) -> int:
        return self.orchestrator.evicted_unready

    @property
    def notices_handled(self) -> int:
        return self.orchestrator.notices_handled

    # -- reconcile ---------------------------------------------------------
    def reconcile(self, key: str) -> Optional[float]:
        if key == POLL_KEY:
            return self._poll()
        return self._enforce_deadline(key)

    def _poll(self) -> float:
        # budget the poll round so the wire client's retries cannot stall
        # the notice stream past its own cadence (resilience/policy.py);
        # an open poll breaker yields an empty drain, not an exception
        from karpenter_tpu_torch.resilience import Budget

        with Budget(max(self.poll_interval * 2.0, 1.0)).activate():
            for notice in self.cloud_provider.poll_disruptions():
                try:
                    self.handle_notice(notice)
                except Exception:
                    # one malformed/raced notice must not stall the stream
                    logger.exception("handling disruption notice %r", notice)
        return self.poll_interval

    def _shard_for(self, node_name: str) -> str:
        """The shard key that owns this node's lifecycle: its provisioner
        label, or the fleet's default shard for unattributed nodes. A label
        naming a DELETED provisioner also maps to the default shard — that
        key leaves every replica's shard universe, so routing to it would
        requeue the notice forever with no owner ever appearing."""
        from karpenter_tpu_torch.api import labels as lbl
        from karpenter_tpu_torch.fleet import DEFAULT_SHARD

        node = self.cluster.try_get("nodes", node_name, namespace="")
        if node is None:
            return DEFAULT_SHARD
        shard = node.metadata.labels.get(lbl.PROVISIONER_NAME_LABEL)
        if not shard:
            return DEFAULT_SHARD
        if self.cluster.try_get("provisioners", shard, namespace="") is None:
            return DEFAULT_SHARD
        return shard

    def _routed_away(self, notice: DisruptionNotice) -> bool:
        """True when another replica owns this notice's shard AND the
        provider accepted the requeue — the owner's next poll picks it up.
        A provider with no requeue surface answers False and the notice is handled
        locally: availability beats strict sharding, and the orchestrator's
        node-scoped actions stay exactly-once because only THIS replica
        drained the notice."""
        if self.ownership is None:
            return False
        if self.ownership.owns(self._shard_for(notice.node_name)):
            return False
        if not self.cloud_provider.requeue_disruption(notice):
            return False
        self.foreign_notices += 1
        metrics.FLEET_FOREIGN_NOTICES.inc()
        return True

    def handle_notice(self, notice: DisruptionNotice) -> None:
        if self._routed_away(notice):
            return
        metrics.INTERRUPTION_NOTICES.labels(
            kind=notice.kind, provider=self.cloud_provider.name()
        ).inc()
        # feed the consolidation risk model: every notice raises the EWMA
        # for this node's (capacity_type, zone), so the re-pack's
        # disruption-cost dimension retires reclaim-prone capacity first
        node = self.cluster.try_get("nodes", notice.node_name, namespace="")
        if node is not None:
            from karpenter_tpu_torch.api import labels as lbl
            from karpenter_tpu_torch.controllers.disruption import risk_tracker

            risk_tracker().observe(
                node.metadata.labels.get(lbl.CAPACITY_TYPE, ""),
                node.metadata.labels.get(lbl.TOPOLOGY_ZONE, ""),
            )
        notice_time = self.cluster.clock()

        def on_release(pod) -> None:
            # registered BEFORE the pod enters the batcher: a re-bind can
            # land microseconds after submit, and the lead-time observation
            # must already be armed
            with self._mu:
                self._awaiting[pod.key] = notice_time

        response = self.orchestrator.handle(notice, on_release=on_release)
        if response is None:
            return
        with self._mu:
            self._deadlines[response.node_name] = response.deadline
        if self._manager is not None:
            self._manager.enqueue("interruption", response.node_name)

    def _enforce_deadline(self, name: str) -> Optional[float]:
        with self._mu:
            deadline = self._deadlines.get(name)
        if deadline is None:
            return None
        node = self.cluster.try_get("nodes", name, namespace="")
        if node is None:
            # drained and terminated inside the grace period — the clean exit
            with self._mu:
                self._deadlines.pop(name, None)
            metrics.INTERRUPTION_DRAINS_COMPLETED.inc()
            return None
        now = self.cluster.clock()
        if now < deadline:
            return min(DEADLINE_REQUEUE, deadline - now)
        self.orchestrator.force_terminate(node)
        with self._mu:
            self._deadlines.pop(name, None)
        metrics.INTERRUPTION_DRAINS_COMPLETED.inc()
        return None

    # -- watches -----------------------------------------------------------
    def _on_pod(self, event: str, pod) -> None:
        # dirty-read fast path: this fires on EVERY pod event in the
        # cluster, and outside an active interruption the awaiting table is
        # empty — skip the lock then (pods being registered have their
        # nodeName cleared first, so nothing observable is missed)
        if not self._awaiting:
            return
        if event == "DELETED":
            with self._mu:
                self._awaiting.pop(pod.key, None)
            return
        if not pod.spec.node_name:
            return
        with self._mu:
            t0 = self._awaiting.pop(pod.key, None)
        if t0 is None:
            return
        lead = max(self.cluster.clock() - t0, 0.0)
        metrics.INTERRUPTION_REPLACEMENT_LEAD_TIME.observe(lead)
        self.lead_times.append(lead)

    def _on_node(self, event: str, node) -> None:
        if event != "DELETED" or self._manager is None:
            return
        with self._mu:
            tracked = node.metadata.name in self._deadlines
        if tracked:
            # close out the deadline record promptly instead of waiting for
            # the next DEADLINE_REQUEUE tick
            self._manager.enqueue("interruption", node.metadata.name)

    def register(self, manager) -> None:
        self._manager = manager
        manager.enqueue("interruption", POLL_KEY)
