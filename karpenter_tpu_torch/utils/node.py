"""Node predicates (reference: pkg/utils/node/predicates.go)."""

from __future__ import annotations

from karpenter_tpu_torch.api.objects import Node


def is_ready(node: Node) -> bool:
    return any(c.type == "Ready" and c.status == "True" for c in node.status.conditions)
