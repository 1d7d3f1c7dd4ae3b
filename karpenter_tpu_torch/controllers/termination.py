"""Termination: finalizer-driven node teardown.

Mirrors ``pkg/controllers/termination``: a deleted Node bearing the
``karpenter.sh/termination`` finalizer is cordoned, drained (respecting
do-not-evict, static pods, stuck-terminating pods, and PDBs via the eviction
queue's 429-retry), then the cloud instance is deleted and the finalizer
removed (terminate.go:43-141, eviction.go:33-107, controller.go:63-95).
"""

from __future__ import annotations

import logging
import threading
from typing import List, Optional, Tuple

from karpenter_tpu_torch.api import labels as lbl
from karpenter_tpu_torch.api.objects import Node, Pod, Taint
from karpenter_tpu_torch.cloudprovider.types import CloudProvider
from karpenter_tpu_torch.kube.client import Cluster
from karpenter_tpu_torch.utils import pod as podutil
from karpenter_tpu_torch.utils.workqueue import ExponentialBackoff, RateLimitingQueue, ShutDown

logger = logging.getLogger("karpenter.termination")

# reference: eviction.go:34-36
EVICTION_QUEUE_BASE_DELAY = 0.1
EVICTION_QUEUE_MAX_DELAY = 10.0

CRITICAL_PRIORITY_CLASSES = ("system-cluster-critical", "system-node-critical")

UNSCHEDULABLE_TAINT = Taint(key="node.kubernetes.io/unschedulable", effect="NoSchedule")


class EvictionQueue:
    """Async rate-limited evictor: PDB-blocked evictions (the 429 analog)
    retry with exponential backoff (reference: eviction.go:33-107)."""

    def __init__(self, cluster: Cluster, start: bool = True):
        self.cluster = cluster
        self.queue = RateLimitingQueue(
            ExponentialBackoff(base=EVICTION_QUEUE_BASE_DELAY, cap=EVICTION_QUEUE_MAX_DELAY)
        )
        # membership set spanning queued + delayed-for-retry keys: repeated
        # drain rounds must not bypass a parked key's backoff
        # (reference: eviction.go:56-63 pairs the workqueue with a set.Set)
        self._in_flight: set = set()
        self._in_flight_mu = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        if start:
            self._thread = threading.Thread(target=self.run, daemon=True, name="eviction")
            self._thread.start()

    def add(self, pods: List[Pod]) -> None:
        for pod in pods:
            key = (pod.metadata.namespace, pod.metadata.name)
            with self._in_flight_mu:
                if key in self._in_flight:
                    continue
                self._in_flight.add(key)
            self.queue.add(key)

    def run(self) -> None:
        while True:
            try:
                key = self.queue.get()
            except ShutDown:
                return
            self.process_one(key)

    def process_one(self, key: Tuple[str, str]) -> bool:
        """Evict + queue bookkeeping for one dequeued key; returns whether
        the eviction succeeded. A blocked eviction requeues on the SERVER's
        ``Retry-After`` hint when the apiserver sent one (the PDB knows when
        it might admit the eviction better than a blind backoff does), and
        on the exponential backoff otherwise."""
        ok, hint = self.evict_once(key)
        if ok:
            self.queue.forget(key)
            with self._in_flight_mu:
                self._in_flight.discard(key)
            self.queue.done(key)
            return True
        self.queue.done(key)
        if hint is not None and hint > 0:
            self.queue.add_after(key, hint)
        else:
            self.queue.add_rate_limited(key)
        return False

    def evict_once(self, key: Tuple[str, str]) -> Tuple[bool, Optional[float]]:
        namespace, name = key
        pod = self.cluster.try_get("pods", name, namespace)
        if pod is None:  # 404 → nothing to evict
            return True, None
        ok, hint = self.cluster.evict_with_hint(pod)
        if not ok:
            logger.debug(
                "eviction of %s/%s blocked by PDB (429%s)", namespace, name,
                f", Retry-After {hint:.2f}s" if hint is not None else "",
            )
        return ok, hint

    def stop(self) -> None:
        self.queue.shut_down()
        if self._thread:
            self._thread.join(timeout=2)


def is_stuck_terminating(pod: Pod, now: float) -> bool:
    """Kubelet-partition guard: the pod is past its graceful-deletion window
    (reference: terminate.go:144-149)."""
    if pod.metadata.deletion_timestamp is None:
        return False
    return now > pod.metadata.deletion_timestamp + pod.spec.termination_grace_period_seconds


class Terminator:
    """reference: terminate.go:35-141."""

    def __init__(self, cluster: Cluster, cloud_provider: CloudProvider, eviction_queue: EvictionQueue):
        self.cluster = cluster
        self.cloud_provider = cloud_provider
        self.eviction_queue = eviction_queue

    def cordon(self, node: Node) -> None:
        if node.spec.unschedulable:
            return
        # precise merge-patch (the reference's single-patch idiom): a
        # full-object PUT from the informer cache races other writers'
        # resourceVersions, and mutating the cached object BEFORE a write
        # that might fail would make the early-return above lie forever
        self.cluster.merge_patch(
            "nodes", node.metadata.name, {"spec": {"unschedulable": True}},
            namespace=node.metadata.namespace,
        )
        logger.info("Cordoned node %s", node.metadata.name)

    def drain(self, node: Node, force: bool = False) -> bool:
        """Evict pods; True when the node is fully drained. ``force`` is
        the interruption subsystem's deadline hook: once the cloud's grace
        period is spent the capacity disappears regardless, so do-not-evict
        stops blocking and every pod is enqueued for eviction."""
        pods = self.get_pods(node)
        if not force:
            for pod in pods:
                if pod.metadata.annotations.get(lbl.DO_NOT_EVICT_ANNOTATION) == "true":
                    logger.debug(
                        "Unable to drain node %s: pod %s has do-not-evict",
                        node.metadata.name, pod.key,
                    )
                    return False
        self.evict(pods)
        return len(pods) == 0

    def terminate(self, node: Node) -> None:
        self.cloud_provider.delete(node)
        self.cluster.remove_finalizer("nodes", node, lbl.TERMINATION_FINALIZER)
        from karpenter_tpu_torch.kube.events import recorder_for

        recorder_for(self.cluster).event(
            "Node", node.metadata.name, "Terminated",
            "cordoned, drained and deleted the backing instance",
        )
        logger.info("Deleted node %s", node.metadata.name)

    def get_pods(self, node: Node) -> List[Pod]:
        """Evictable pods: exclude pods tolerating the unschedulable taint
        (they would reschedule right back), stuck-terminating pods, and
        static pods (reference: terminate.go:98-120)."""
        now = self.cluster.clock()
        out = []
        for p in self.cluster.pods_on_node(node.metadata.name):
            if any(t.tolerates(UNSCHEDULABLE_TAINT) for t in p.spec.tolerations):
                continue
            if is_stuck_terminating(p, now):
                continue
            if podutil.is_owned_by_node(p):
                continue
            out.append(p)
        return out

    def evict(self, pods: List[Pod]) -> None:
        """Critical pods evict only after all non-critical are gone
        (reference: terminate.go:122-141)."""
        critical, non_critical = [], []
        for pod in pods:
            if pod.metadata.deletion_timestamp is not None:
                continue
            if pod.spec.priority_class_name in CRITICAL_PRIORITY_CLASSES:
                critical.append(pod)
            else:
                non_critical.append(pod)
        self.eviction_queue.add(non_critical if non_critical else critical)


class TerminationController:
    """reference: termination/controller.go:50-113."""

    DRAIN_REQUEUE = 1.0

    def __init__(
        self,
        cluster: Cluster,
        cloud_provider: CloudProvider,
        start_queue: bool = True,
        fenced=None,
    ):
        self.cluster = cluster
        self.eviction_queue = EvictionQueue(cluster, start=start_queue)
        self.terminator = Terminator(cluster, cloud_provider, self.eviction_queue)
        # partition-tolerance fence (docs/partition.md): finalizer-driven
        # teardown acts on the INFORMER view, which is stale while the
        # apiserver is unreachable past lease expiry — defer the cloud
        # delete until the control plane answers. (Cloud-NOTIFIED
        # terminations — interruption's force path — are deliberately not
        # gated: the cloud itself declared that capacity dying.)
        self.fenced = fenced or (lambda: False)

    def reconcile(self, name: str) -> Optional[float]:
        node = self.cluster.try_get("nodes", name, namespace="")
        if node is None:
            return None
        if node.metadata.deletion_timestamp is None:
            return None
        if lbl.TERMINATION_FINALIZER not in node.metadata.finalizers:
            return None
        self.terminator.cordon(node)
        if not self.terminator.drain(node):
            return self.DRAIN_REQUEUE
        if self.fenced():
            from karpenter_tpu_torch import metrics

            metrics.FLEET_DUPLICATE_LAUNCH_GUARD.labels(reason="fenced").inc()
            logger.warning(
                "deferring cloud delete of %s: replica fenced (apiserver "
                "unreachable past lease expiry)", name,
            )
            return self.DRAIN_REQUEUE
        self.terminator.terminate(node)
        return None

    def register(self, manager) -> None:
        def on_node(event: str, node) -> None:
            manager.enqueue("termination", node.metadata.name)

        def on_pod(event: str, pod) -> None:
            # pod deletions progress drains; re-kick the hosting node
            if pod.spec.node_name:
                manager.enqueue("termination", pod.spec.node_name)

        self.cluster.watch("nodes", on_node)
        self.cluster.watch("pods", on_pod)

    def stop(self) -> None:
        self.eviction_queue.stop()
