"""Pod state metrics: one ``karpenter_pods_state`` gauge per pod labeled by
{name, namespace, owner, node, provisioner, zone, arch, capacity type,
instance type, phase} (reference: pkg/controllers/metrics/pod
controller.go:54-118)."""

from __future__ import annotations

import threading
from typing import Dict, Tuple

from karpenter_tpu_torch import metrics
from karpenter_tpu_torch.api import labels as lbl
from karpenter_tpu_torch.api.objects import Pod
from karpenter_tpu_torch.kube.client import Cluster

POD_GAUGE_LABELS = [
    "name", "namespace", "owner", "node", "provisioner", "zone", "arch",
    "capacity_type", "instance_type", "phase",
]


class PodMetricsController:
    def __init__(self, cluster: Cluster):
        self.cluster = cluster
        self._lock = threading.Lock()
        self._published: Dict[Tuple[str, str], Tuple[str, ...]] = {}

    def reconcile(self, name: str, namespace: str = "default") -> None:
        pod = self.cluster.try_get("pods", name, namespace)
        key = (namespace, name)
        if pod is None:
            self._forget(key)
            return
        self._record(key, pod)

    def _labels_for(self, pod: Pod) -> Dict[str, str]:
        node_labels: Dict[str, str] = {}
        if pod.spec.node_name:
            node = self.cluster.try_get("nodes", pod.spec.node_name, namespace="")
            if node is not None:
                node_labels = node.metadata.labels
        owner = ""
        if pod.metadata.owner_references:
            ref = pod.metadata.owner_references[0]
            owner = f"{ref.kind}/{ref.name}" if ref.kind else ref.name
        return {
            "name": pod.metadata.name,
            "namespace": pod.metadata.namespace,
            "owner": owner,
            "node": pod.spec.node_name,
            "provisioner": node_labels.get(lbl.PROVISIONER_NAME_LABEL, ""),
            "zone": node_labels.get(lbl.TOPOLOGY_ZONE, ""),
            "arch": node_labels.get(lbl.ARCH, ""),
            "capacity_type": node_labels.get(lbl.CAPACITY_TYPE, ""),
            "instance_type": node_labels.get(lbl.INSTANCE_TYPE, ""),
            "phase": pod.status.phase,
        }

    def _record(self, key: Tuple[str, str], pod: Pod) -> None:
        labels = self._labels_for(pod)
        ordered = tuple(labels[k] for k in POD_GAUGE_LABELS)
        self._forget(key)
        metrics.PODS_STATE_GAUGE.labels(*ordered).set(1)
        with self._lock:
            self._published[key] = ordered

    def _forget(self, key: Tuple[str, str]) -> None:
        with self._lock:
            ordered = self._published.pop(key, None)
        if ordered is None:
            return
        try:
            metrics.PODS_STATE_GAUGE.remove(*ordered)
        except KeyError:
            pass

    def register(self, manager) -> None:
        def on_pod(event: str, pod) -> None:
            manager.enqueue("metrics_pod", (pod.metadata.name, pod.metadata.namespace))

        self.cluster.watch("pods", on_pod)
