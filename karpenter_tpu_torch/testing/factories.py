"""Object factories for tests — the analog of ``pkg/test``'s option-struct
factories (pods.go, nodes.go, daemonsets.go, storage.go)."""

from __future__ import annotations

import itertools
from typing import Dict, List, Optional

from karpenter_tpu_torch.api import labels as lbl
from karpenter_tpu_torch.api.objects import (
    Affinity,
    Container,
    DaemonSet,
    LabelSelector,
    NodeAffinity,
    NodeSelectorRequirement,
    NodeSelectorTerm,
    ObjectMeta,
    OwnerReference,
    Pod,
    PodAffinity,
    PodAffinityTerm,
    PodAntiAffinity,
    PodCondition,
    PodSpec,
    PodStatus,
    PreferredSchedulingTerm,
    Toleration,
    TopologySpreadConstraint,
)
from karpenter_tpu_torch.api.provisioner import Constraints, Limits, Provisioner, ProvisionerSpec
from karpenter_tpu_torch.api.requirements import Requirements
from karpenter_tpu_torch.utils import resources as res

_counter = itertools.count(1)


def make_pod(
    name: Optional[str] = None,
    namespace: str = "default",
    labels: Optional[Dict[str, str]] = None,
    requests: Optional[Dict[str, object]] = None,
    limits: Optional[Dict[str, object]] = None,
    node_selector: Optional[Dict[str, str]] = None,
    node_requirements: Optional[List[NodeSelectorRequirement]] = None,
    node_preferences: Optional[List[PreferredSchedulingTerm]] = None,
    pod_requirements: Optional[List[PodAffinityTerm]] = None,
    pod_anti_requirements: Optional[List[PodAffinityTerm]] = None,
    tolerations: Optional[List[Toleration]] = None,
    topology: Optional[List[TopologySpreadConstraint]] = None,
    node_name: str = "",
    unschedulable: bool = True,
    owner: Optional[OwnerReference] = None,
    priority_class_name: str = "",
) -> Pod:
    affinity = None
    if node_requirements or node_preferences or pod_requirements or pod_anti_requirements:
        affinity = Affinity()
        if node_requirements or node_preferences:
            affinity.node_affinity = NodeAffinity(
                required=[NodeSelectorTerm(match_expressions=list(node_requirements or []))]
                if node_requirements
                else [],
                preferred=list(node_preferences or []),
            )
        if pod_requirements:
            affinity.pod_affinity = PodAffinity(required=list(pod_requirements))
        if pod_anti_requirements:
            affinity.pod_anti_affinity = PodAntiAffinity(required=list(pod_anti_requirements))
    status = PodStatus()
    if unschedulable and not node_name:
        status.conditions.append(
            PodCondition(type="PodScheduled", status="False", reason="Unschedulable")
        )
    return Pod(
        metadata=ObjectMeta(
            name=name or f"pod-{next(_counter)}", namespace=namespace,
            labels=dict(labels or {}),
            owner_references=[owner] if owner is not None else [],
        ),
        spec=PodSpec(
            node_name=node_name,
            node_selector=dict(node_selector or {}),
            affinity=affinity,
            tolerations=list(tolerations or []),
            containers=[
                Container(
                    requests=res.parse_resource_list(requests),
                    limits=res.parse_resource_list(limits),
                )
            ],
            topology_spread_constraints=list(topology or []),
            priority_class_name=priority_class_name,
        ),
        status=status,
    )


def make_provisioner(
    name: str = "default",
    labels: Optional[Dict[str, str]] = None,
    taints=None,
    requirements: Optional[List[NodeSelectorRequirement]] = None,
    limits: Optional[Dict[str, object]] = None,
    solver: str = "ffd",
    ttl_after_empty: Optional[int] = None,
    ttl_until_expired: Optional[int] = None,
    provider: Optional[Dict] = None,
) -> Provisioner:
    return Provisioner(
        metadata=ObjectMeta(name=name, namespace=""),
        spec=ProvisionerSpec(
            constraints=Constraints(
                labels=dict(labels or {}),
                taints=list(taints or []),
                requirements=Requirements.new(*(requirements or [])),
                provider=provider,
            ),
            limits=Limits(resources=res.parse_resource_list(limits)) if limits else None,
            solver=solver,
            ttl_seconds_after_empty=ttl_after_empty,
            ttl_seconds_until_expired=ttl_until_expired,
        ),
    )


def make_daemonset(
    name: Optional[str] = None,
    requests: Optional[Dict[str, object]] = None,
    node_selector: Optional[Dict[str, str]] = None,
    tolerations: Optional[List[Toleration]] = None,
) -> DaemonSet:
    return DaemonSet(
        metadata=ObjectMeta(name=name or f"ds-{next(_counter)}", namespace="kube-system"),
        pod_template=PodSpec(
            node_selector=dict(node_selector or {}),
            tolerations=list(tolerations or []),
            containers=[Container(requests=res.parse_resource_list(requests))],
        ),
    )


def make_node(
    name: Optional[str] = None,
    labels: Optional[Dict[str, str]] = None,
    capacity: Optional[Dict[str, object]] = None,
    allocatable: Optional[Dict[str, object]] = None,
    taints=None,
    ready: bool = True,
    provisioner_name: Optional[str] = None,
    finalizers: Optional[List[str]] = None,
):
    """reference: pkg/test/nodes.go."""
    from karpenter_tpu_torch.api.objects import Node, NodeSpec, NodeStatus

    node_labels = dict(labels or {})
    if provisioner_name is not None:
        node_labels[lbl.PROVISIONER_NAME_LABEL] = provisioner_name
    cap = res.parse_resource_list(capacity)
    return Node(
        metadata=ObjectMeta(
            name=name or f"node-{next(_counter)}",
            namespace="",
            labels=node_labels,
            finalizers=list(finalizers or []),
        ),
        spec=NodeSpec(taints=list(taints or [])),
        status=NodeStatus(
            capacity=cap,
            allocatable=res.parse_resource_list(allocatable) or dict(cap),
            conditions=[
                PodCondition(type="Ready", status="True" if ready else "False")
            ],
        ),
    )


def make_pvc(
    name: Optional[str] = None,
    namespace: str = "default",
    storage_class: str = "",
    volume_name: str = "",
):
    from karpenter_tpu_torch.api.objects import PersistentVolumeClaim

    return PersistentVolumeClaim(
        metadata=ObjectMeta(name=name or f"pvc-{next(_counter)}", namespace=namespace),
        storage_class_name=storage_class,
        volume_name=volume_name,
    )


def make_pv(name: Optional[str] = None, zones: Optional[List[str]] = None):
    from karpenter_tpu_torch.api.objects import PersistentVolume

    terms = []
    if zones:
        terms = [
            NodeSelectorTerm(
                match_expressions=[
                    NodeSelectorRequirement(key=lbl.TOPOLOGY_ZONE, operator="In", values=list(zones))
                ]
            )
        ]
    return PersistentVolume(
        metadata=ObjectMeta(name=name or f"pv-{next(_counter)}", namespace=""),
        node_affinity_required=terms,
    )


def make_storage_class(name: Optional[str] = None, zones: Optional[List[str]] = None):
    from karpenter_tpu_torch.api.objects import StorageClass

    terms = []
    if zones:
        terms = [
            NodeSelectorTerm(
                match_expressions=[
                    NodeSelectorRequirement(key=lbl.TOPOLOGY_ZONE, operator="In", values=list(zones))
                ]
            )
        ]
    return StorageClass(
        metadata=ObjectMeta(name=name or f"sc-{next(_counter)}", namespace=""),
        allowed_topologies=terms,
    )


def make_pdb(
    name: Optional[str] = None,
    namespace: str = "default",
    labels: Optional[Dict[str, str]] = None,
    min_available: Optional[int] = None,
    max_unavailable: Optional[int] = None,
):
    from karpenter_tpu_torch.api.objects import PodDisruptionBudget

    return PodDisruptionBudget(
        metadata=ObjectMeta(name=name or f"pdb-{next(_counter)}", namespace=namespace),
        selector=LabelSelector(match_labels=dict(labels or {})),
        min_available=min_available,
        max_unavailable=max_unavailable,
    )


def zone_spread(max_skew: int = 1, labels: Optional[Dict[str, str]] = None) -> TopologySpreadConstraint:
    return TopologySpreadConstraint(
        max_skew=max_skew,
        topology_key=lbl.TOPOLOGY_ZONE,
        when_unsatisfiable="DoNotSchedule",
        label_selector=LabelSelector(match_labels=dict(labels or {})),
    )


def hostname_spread(max_skew: int = 1, labels: Optional[Dict[str, str]] = None) -> TopologySpreadConstraint:
    return TopologySpreadConstraint(
        max_skew=max_skew,
        topology_key=lbl.HOSTNAME,
        when_unsatisfiable="DoNotSchedule",
        label_selector=LabelSelector(match_labels=dict(labels or {})),
    )
