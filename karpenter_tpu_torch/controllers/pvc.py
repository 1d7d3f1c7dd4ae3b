"""PVC selected-node annotation.

Mirrors ``pkg/controllers/persistentvolumeclaim``: once a pod is scheduled,
write the ``volume.kubernetes.io/selected-node`` annotation onto its PVCs so
the volume provisioner creates the volume in the right zone before kubelet
asks for it (controller.go:37-122).
"""

from __future__ import annotations

from typing import List

from karpenter_tpu_torch.api.objects import PersistentVolumeClaim, Pod
from karpenter_tpu_torch.kube.client import Cluster

SELECTED_NODE_ANNOTATION = "volume.kubernetes.io/selected-node"


class PVCController:
    def __init__(self, cluster: Cluster):
        self.cluster = cluster

    def reconcile(self, name: str, namespace: str = "default") -> None:
        pod = self.cluster.try_get("pods", name, namespace)
        if pod is None or not pod.spec.node_name:
            return
        for pvc in self.pvcs_for_pod(pod):
            if pvc.metadata.annotations.get(SELECTED_NODE_ANNOTATION) == pod.spec.node_name:
                continue
            pvc.metadata.annotations[SELECTED_NODE_ANNOTATION] = pod.spec.node_name
            self.cluster.update("pvcs", pvc)

    def pvcs_for_pod(self, pod: Pod) -> List[PersistentVolumeClaim]:
        """reference: controller.go:111-122."""
        out: List[PersistentVolumeClaim] = []
        for volume in pod.spec.volumes:
            if not volume.persistent_volume_claim:
                continue
            pvc = self.cluster.try_get(
                "pvcs", volume.persistent_volume_claim, pod.metadata.namespace
            )
            if pvc is not None:
                out.append(pvc)
        return out

    def register(self, manager) -> None:
        def on_pod(event: str, pod) -> None:
            manager.enqueue("pvc", (pod.metadata.name, pod.metadata.namespace))

        self.cluster.watch("pods", on_pod)
