"""Node lifecycle: initialization, expiration, emptiness, finalizer.

Mirrors ``pkg/controllers/node``: watches karpenter-labeled nodes (plus mapped
events from provisioner changes and pod assignments), runs four
sub-reconcilers, persists a single update, and requeues at the soonest of the
sub-reconcilers' requested times (controller.go:42-116, ``result.Min``).
"""

from __future__ import annotations

import copy
import logging
from datetime import datetime, timezone
from typing import List, Optional

from karpenter_tpu_torch.api import labels as lbl
from karpenter_tpu_torch.api.objects import Node, Taint
from karpenter_tpu_torch.api.provisioner import Provisioner
from karpenter_tpu_torch.kube.client import Cluster
from karpenter_tpu_torch.utils import node as nodeutil
from karpenter_tpu_torch.utils import pod as podutil

logger = logging.getLogger("karpenter.node")

INITIALIZATION_TIMEOUT = 15 * 60.0  # reference: initialization.go:32


def _rfc3339(ts: float) -> str:
    return datetime.fromtimestamp(ts, timezone.utc).isoformat()


def _parse_rfc3339(s: str) -> float:
    return datetime.fromisoformat(s).timestamp()


def result_min(*results: Optional[float]) -> Optional[float]:
    """Merge reconcile results, taking the soonest requeue
    (reference: utils/result/result.go)."""
    times = [r for r in results if r is not None]
    return min(times) if times else None


class Initialization:
    """Remove the not-ready startup taint when the node goes Ready; delete
    nodes that never initialize within the timeout
    (reference: initialization.go:32-66)."""

    def __init__(self, cluster: Cluster):
        self.cluster = cluster

    def reconcile(self, provisioner: Provisioner, node: Node) -> Optional[float]:
        if not any(t.key == lbl.NOT_READY_TAINT_KEY for t in node.spec.taints):
            return None
        if not nodeutil.is_ready(node):
            age = self.cluster.clock() - node.metadata.creation_timestamp
            if age < INITIALIZATION_TIMEOUT:
                return INITIALIZATION_TIMEOUT - age
            logger.info("Triggering termination for node %s that failed to become ready",
                        node.metadata.name)
            self.cluster.delete("nodes", node.metadata.name, namespace="")
            return None
        node.spec.taints = [t for t in node.spec.taints if t.key != lbl.NOT_READY_TAINT_KEY]
        # node-ready closes the provisioning lifecycle: a zero-work span,
        # parented (via the annotation provisioning stamped at launch) into
        # the launch trace — time-from-creation is the attribute that
        # matters, the ready transition itself is instantaneous
        from karpenter_tpu_torch import obs

        ctx = obs.from_traceparent(
            node.metadata.annotations.get(obs.TRACE_ANNOTATION)
        )
        if ctx is not None:
            with obs.tracer().span(
                "node.ready",
                parent=ctx,
                attrs={
                    "node": node.metadata.name,
                    "since_creation_s": round(
                        self.cluster.clock() - node.metadata.creation_timestamp, 3
                    ),
                },
            ):
                pass
        return None


class Expiration:
    """Delete nodes older than ``ttl_seconds_until_expired``
    (reference: expiration.go:33-54)."""

    def __init__(self, cluster: Cluster):
        self.cluster = cluster

    def reconcile(self, provisioner: Provisioner, node: Node) -> Optional[float]:
        ttl = provisioner.spec.ttl_seconds_until_expired
        if ttl is None:
            return None
        expiration_time = node.metadata.creation_timestamp + ttl
        now = self.cluster.clock()
        if now > expiration_time:
            logger.info("Triggering termination for expired node %s after %ss",
                        node.metadata.name, ttl)
            self.cluster.delete("nodes", node.metadata.name, namespace="")
            return None
        return expiration_time - now


class Emptiness:
    """Annotate empty nodes with an emptiness timestamp; delete them once the
    TTL elapses; clear the annotation if pods land again
    (reference: emptiness.go:36-100). Empty = every pod is terminal or
    daemonset/static."""

    def __init__(self, cluster: Cluster):
        self.cluster = cluster

    def reconcile(self, provisioner: Provisioner, node: Node) -> Optional[float]:
        ttl = provisioner.spec.ttl_seconds_after_empty
        if ttl is None:
            return None
        if not nodeutil.is_ready(node):
            return None
        empty = self.is_empty(node)
        stamp = node.metadata.annotations.get(lbl.EMPTINESS_TIMESTAMP_ANNOTATION)
        if not empty:
            if stamp is not None:
                del node.metadata.annotations[lbl.EMPTINESS_TIMESTAMP_ANNOTATION]
                logger.info("Removed emptiness TTL from node %s", node.metadata.name)
            return None
        now = self.cluster.clock()
        if stamp is None:
            node.metadata.annotations[lbl.EMPTINESS_TIMESTAMP_ANNOTATION] = _rfc3339(now)
            logger.info("Added TTL to empty node %s", node.metadata.name)
            return float(ttl)
        emptiness_time = _parse_rfc3339(stamp)
        if now > emptiness_time + ttl:
            logger.info("Triggering termination after %ss for empty node %s",
                        ttl, node.metadata.name)
            self.cluster.delete("nodes", node.metadata.name, namespace="")
            return None
        return emptiness_time + ttl - now

    def is_empty(self, node: Node) -> bool:
        for p in self.cluster.pods_on_node(node.metadata.name):
            if podutil.is_terminal(p):
                continue
            if not podutil.is_owned_by_daemonset(p) and not podutil.is_owned_by_node(p):
                return False
        return True


class Finalizer:
    """Ensure self-registered nodes carry the termination finalizer — covers
    instances that launch when the node-object create failed
    (reference: finalizer.go:31-42)."""

    def reconcile(self, provisioner: Provisioner, node: Node) -> Optional[float]:
        if node.metadata.deletion_timestamp is not None:
            return None
        if lbl.TERMINATION_FINALIZER not in node.metadata.finalizers:
            node.metadata.finalizers.append(lbl.TERMINATION_FINALIZER)
        return None


class CloudLiveness:
    """Detect instances terminated out from under their Node objects.

    Asks the provider's ``instance_gone`` probe — which debounces describe
    flakes behind an N-consecutive-miss tracker (resilience.MissTracker),
    so one chaotic describe response can never orphan a healthy node —
    and hands a confirmed-gone node to the termination path. Providers
    without a describe surface answer ``NotImplemented`` and opt the whole
    sub-reconciler out (no requeue pressure); a probe that merely failed
    this time answers None and keeps its cadence."""

    PROBE_INTERVAL = 30.0

    def __init__(self, cluster: Cluster, cloud_provider):
        self.cluster = cluster
        self.cloud_provider = cloud_provider
        self._last_probe: dict = {}
        self._last_sweep: Optional[float] = None

    def _sweep(self, now: float) -> None:
        """Nodes terminated by OTHER controllers (consolidation, expiration,
        interruption) never hit this sub-reconciler's own cleanup paths;
        sweep their probe stamps so a churning spot fleet can't grow the
        table for the process lifetime. Time-gated: on fleets larger than
        the threshold the table legitimately stays big, and a full scan per
        reconcile would be O(N²) per round."""
        if len(self._last_probe) <= 256:
            return
        if self._last_sweep is not None and now - self._last_sweep < self.PROBE_INTERVAL:
            return
        self._last_sweep = now
        live = {n.metadata.name for n in self.cluster.nodes()}
        for name in list(self._last_probe):
            if name not in live:
                del self._last_probe[name]

    def reconcile(self, provisioner: Provisioner, node: Node) -> Optional[float]:
        if self.cloud_provider is None or node.metadata.deletion_timestamp is not None:
            return None
        now = self.cluster.clock()
        self._sweep(now)
        last = self._last_probe.get(node.metadata.name)
        if last is not None and now - last < self.PROBE_INTERVAL:
            return self.PROBE_INTERVAL - (now - last)
        self._last_probe[node.metadata.name] = now
        try:
            gone = self.cloud_provider.instance_gone(node)
        except Exception:
            logger.debug("liveness probe failed for %s", node.metadata.name, exc_info=True)
            return self.PROBE_INTERVAL
        if gone is NotImplemented:  # vendor has no liveness surface at all
            self._last_probe.pop(node.metadata.name, None)
            return None
        if gone is None:
            # the probe itself failed this time — KEEP the cadence: one
            # flaky describe must not permanently halt liveness monitoring
            return self.PROBE_INTERVAL
        if gone:
            logger.info(
                "Triggering termination for node %s: backing instance confirmed gone",
                node.metadata.name,
            )
            self._last_probe.pop(node.metadata.name, None)
            self.cluster.delete("nodes", node.metadata.name, namespace="")
            return None
        return self.PROBE_INTERVAL


class NodeController:
    """reference: node/controller.go:42-150."""

    def __init__(self, cluster: Cluster, cloud_provider=None):
        self.cluster = cluster
        self.initialization = Initialization(cluster)
        self.expiration = Expiration(cluster)
        self.emptiness = Emptiness(cluster)
        self.finalizer = Finalizer()
        self.liveness = CloudLiveness(cluster, cloud_provider)

    def reconcile(self, name: str) -> Optional[float]:
        live = self.cluster.try_get("nodes", name, namespace="")
        if live is None or live.metadata.deletion_timestamp is not None:
            return None
        provisioner_name = live.metadata.labels.get(lbl.PROVISIONER_NAME_LABEL)
        if provisioner_name is None:
            return None
        provisioner = self.cluster.try_get("provisioners", provisioner_name, namespace="")
        if provisioner is None:
            return None
        # sub-reconcilers run over a DEEP COPY (reference:
        # node/controller.go:62-116): mutating the shared informer-cache
        # object before a write that can fail would leave the cache
        # diverged from the server with nothing re-driving the patch
        node = copy.deepcopy(live)
        before = _snapshot(live)
        results: List[Optional[float]] = []
        for sub in (self.initialization, self.expiration, self.emptiness,
                    self.finalizer, self.liveness):
            results.append(sub.reconcile(provisioner, node))
            # a sub-reconciler may delete the node (finalizer-bearing nodes
            # stay in the store but start terminating); stop touching it then
            if (
                node.metadata.deletion_timestamp is not None
                or self.cluster.try_get("nodes", name, namespace="") is None
            ):
                return None
        after = _snapshot(node)
        if after != before:
            # ONE merge patch with exactly the changed fields (reference:
            # node/controller.go:106-115) — a full-object PUT from the
            # informer cache races other writers' resourceVersions
            from karpenter_tpu_torch.kube.serde import taint_to_wire

            patch: dict = {}
            if after[0] != before[0]:
                # arrays replace wholesale under RFC 7386
                patch.setdefault("spec", {})["taints"] = [
                    taint_to_wire(t) for t in node.spec.taints
                ]
            if after[1] != before[1]:
                # maps merge per key: send only added/changed keys, plus
                # nulls for removals — re-asserting unchanged keys would
                # clobber concurrent writers with cached values
                old = dict(before[1])
                annotations = {
                    k: v for k, v in node.metadata.annotations.items()
                    if old.get(k) != v
                }
                for key in old:
                    if key not in node.metadata.annotations:
                        annotations[key] = None  # merge-patch delete
                patch.setdefault("metadata", {})["annotations"] = annotations
            if after[2] != before[2]:
                patch.setdefault("metadata", {})["finalizers"] = list(
                    node.metadata.finalizers
                )
            self.cluster.merge_patch("nodes", name, patch, namespace="")
        return result_min(*results)

    def register(self, manager) -> None:
        """Watch nodes directly, provisioners mapped to their nodes, and pods
        mapped to their node (reference: controller.go:118-150)."""

        def on_node(event: str, node) -> None:
            if node.metadata.labels.get(lbl.PROVISIONER_NAME_LABEL):
                manager.enqueue("node", node.metadata.name)

        def on_provisioner(event: str, provisioner) -> None:
            for node in self.cluster.nodes():
                if node.metadata.labels.get(lbl.PROVISIONER_NAME_LABEL) == provisioner.metadata.name:
                    manager.enqueue("node", node.metadata.name)

        def on_pod(event: str, pod) -> None:
            if pod.spec.node_name:
                manager.enqueue("node", pod.spec.node_name)

        self.cluster.watch("nodes", on_node)
        self.cluster.watch("provisioners", on_provisioner)
        self.cluster.watch("pods", on_pod)


def _snapshot(node: Node):
    return (
        tuple((t.key, t.value, t.effect) for t in node.spec.taints),
        tuple(sorted(node.metadata.annotations.items())),
        tuple(node.metadata.finalizers),
    )
