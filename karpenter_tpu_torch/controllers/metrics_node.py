"""Node metrics: re-publish per-node Prometheus gauges on every
node/pod/provisioner event.

Mirrors ``pkg/controllers/metrics/node``: six gauge families
(allocatable, total pod requests/limits, total daemon requests/limits,
system overhead) labeled by {resource type, node, provisioner, zone, arch,
capacity type, instance type, phase}; label sets are tracked so gauges for
deleted nodes are removed (controller.go:53-196).
"""

from __future__ import annotations

import threading
from typing import Dict, Set, Tuple

from karpenter_tpu_torch import metrics
from karpenter_tpu_torch.api import labels as lbl
from karpenter_tpu_torch.api.objects import Node
from karpenter_tpu_torch.kube.client import Cluster
from karpenter_tpu_torch.utils import pod as podutil
from karpenter_tpu_torch.utils import resources as res

NODE_GAUGES = (
    metrics.NODES_ALLOCATABLE,
    metrics.NODES_TOTAL_POD_REQUESTS,
    metrics.NODES_TOTAL_POD_LIMITS,
    metrics.NODES_TOTAL_DAEMON_REQUESTS,
    metrics.NODES_TOTAL_DAEMON_LIMITS,
    metrics.NODES_SYSTEM_OVERHEAD,
)


class NodeMetricsController:
    def __init__(self, cluster: Cluster):
        self.cluster = cluster
        self._lock = threading.Lock()
        # node name -> {(gauge index, ordered label values)} published
        self._published: Dict[str, Set[Tuple[int, Tuple[str, ...]]]] = {}

    def reconcile(self, name: str) -> None:
        node = self.cluster.try_get("nodes", name, namespace="")
        if node is None:
            self._forget(name)
            return
        self._publish(node)

    def _base_labels(self, node: Node) -> Dict[str, str]:
        labels = node.metadata.labels
        return {
            "node_name": node.metadata.name,
            "provisioner": labels.get(lbl.PROVISIONER_NAME_LABEL, ""),
            "zone": labels.get(lbl.TOPOLOGY_ZONE, ""),
            "arch": labels.get(lbl.ARCH, ""),
            "capacity_type": labels.get(lbl.CAPACITY_TYPE, ""),
            "instance_type": labels.get(lbl.INSTANCE_TYPE, ""),
            "phase": node.status.phase or ("Ready" if _ready(node) else "NotReady"),
        }

    def _publish(self, node: Node) -> None:
        base = self._base_labels(node)
        pod_requests: Dict[str, float] = {}
        pod_limits: Dict[str, float] = {}
        daemon_requests: Dict[str, float] = {}
        daemon_limits: Dict[str, float] = {}
        for p in self.cluster.pods_on_node(node.metadata.name):
            if podutil.is_terminal(p):
                continue
            if podutil.is_owned_by_daemonset(p):
                daemon_requests = res.merge(daemon_requests, p.resource_requests())
                daemon_limits = res.merge(daemon_limits, p.resource_limits())
            else:
                pod_requests = res.merge(pod_requests, p.resource_requests())
                pod_limits = res.merge(pod_limits, p.resource_limits())
        overhead = {
            k: node.status.capacity.get(k, 0.0) - node.status.allocatable.get(k, 0.0)
            for k in node.status.capacity
        }
        self._forget(node.metadata.name)
        published: Set[Tuple[int, Tuple[str, ...]]] = set()
        families = (
            node.status.allocatable, pod_requests, pod_limits,
            daemon_requests, daemon_limits, overhead,
        )
        for idx, values in enumerate(families):
            for resource_type, value in values.items():
                label_values = {**base, "resource_type": resource_type}
                ordered = tuple(label_values[k] for k in metrics.NODE_GAUGE_LABELS)
                NODE_GAUGES[idx].labels(*ordered).set(value)
                published.add((idx, ordered))
        with self._lock:
            self._published[node.metadata.name] = published

    def _forget(self, name: str) -> None:
        with self._lock:
            published = self._published.pop(name, None)
        if not published:
            return
        for idx, ordered in published:
            try:
                NODE_GAUGES[idx].remove(*ordered)
            except KeyError:
                pass

    def register(self, manager) -> None:
        def on_node(event: str, node) -> None:
            manager.enqueue("metrics_node", node.metadata.name)

        def on_pod(event: str, pod) -> None:
            if pod.spec.node_name:
                manager.enqueue("metrics_node", pod.spec.node_name)

        self.cluster.watch("nodes", on_node)
        self.cluster.watch("pods", on_pod)


def _ready(node: Node) -> bool:
    return any(c.type == "Ready" and c.status == "True" for c in node.status.conditions)
