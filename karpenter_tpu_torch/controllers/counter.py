"""Counter: provisioner resource accounting.

Mirrors ``pkg/controllers/counter``: maintains
``provisioner.status.resources`` — the summed capacity of the provisioner's
nodes — which is the input to ``Limits.exceeded_by`` checked before every
launch (controller.go:51-87).
"""

from __future__ import annotations

from typing import Dict

from karpenter_tpu_torch.api import labels as lbl
from karpenter_tpu_torch.kube.client import Cluster
from karpenter_tpu_torch.utils import resources as res


class CounterController:
    def __init__(self, cluster: Cluster):
        self.cluster = cluster

    def reconcile(self, name: str) -> None:
        provisioner = self.cluster.try_get("provisioners", name, namespace="")
        if provisioner is None:
            return
        counts = self.resource_counts_for(name)
        if counts != provisioner.status.resources:
            from karpenter_tpu_torch.kube import serde

            # status subresource write (deploy/crd.yaml subresources.status).
            # RFC 7386 merges key-wise, so a key that vanished from the
            # counts (its last node deleted) must be cleared with an
            # explicit null or it would linger and feed Limits forever
            patch = {k: None for k in provisioner.status.resources if k not in counts}
            patch.update(serde.quantities(counts))
            self.cluster.patch_status(
                "provisioners", name, {"resources": patch}, namespace=""
            )

    def resource_counts_for(self, provisioner_name: str) -> Dict[str, float]:
        """Sum node capacity over this provisioner's nodes
        (reference: controller.go:72-87)."""
        total: Dict[str, float] = {}
        for node in self.cluster.nodes():
            if node.metadata.labels.get(lbl.PROVISIONER_NAME_LABEL) != provisioner_name:
                continue
            total = res.merge(total, node.status.capacity)
        return total

    def register(self, manager) -> None:
        """Watch nodes, mapping each to its owning provisioner
        (reference: controller.go:90-112)."""

        def on_node(event: str, node) -> None:
            name = node.metadata.labels.get(lbl.PROVISIONER_NAME_LABEL)
            if name:
                manager.enqueue("counter", name)

        def on_provisioner(event: str, provisioner) -> None:
            manager.enqueue("counter", provisioner.metadata.name)

        self.cluster.watch("nodes", on_node)
        self.cluster.watch("provisioners", on_provisioner)
