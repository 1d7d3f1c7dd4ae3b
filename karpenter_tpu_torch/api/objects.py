"""Lightweight Kubernetes-shaped object model.

The reference operates on ``k8s.io/api/core/v1`` types; this framework is not
a kubelet client, so it carries only the fields the provisioning logic reads.
Field names are pythonic but map 1:1 onto their Kubernetes counterparts.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from karpenter_tpu_torch.utils import resources as res

_uid_counter = itertools.count(1)


def _next_uid() -> str:
    return f"uid-{next(_uid_counter)}"


@dataclass
class OwnerReference:
    api_version: str = ""
    kind: str = ""
    name: str = ""


@dataclass
class ObjectMeta:
    name: str = ""
    namespace: str = "default"
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)
    finalizers: List[str] = field(default_factory=list)
    owner_references: List[OwnerReference] = field(default_factory=list)
    uid: str = field(default_factory=_next_uid)
    creation_timestamp: float = 0.0
    deletion_timestamp: Optional[float] = None
    resource_version: int = 0


@dataclass
class Taint:
    key: str = ""
    value: str = ""
    effect: str = "NoSchedule"  # NoSchedule | PreferNoSchedule | NoExecute


@dataclass
class Toleration:
    key: str = ""
    operator: str = "Equal"  # Equal | Exists
    value: str = ""
    effect: str = ""  # empty matches all effects
    toleration_seconds: Optional[int] = None

    def tolerates(self, taint: Taint) -> bool:
        """Kubernetes Toleration.ToleratesTaint semantics."""
        if self.effect and self.effect != taint.effect:
            return False
        if self.key and self.key != taint.key:
            return False
        if not self.key and self.operator != "Exists":
            return False
        if self.operator == "Exists":
            return True
        return self.value == taint.value


@dataclass
class NodeSelectorRequirement:
    key: str
    operator: str  # In | NotIn | Exists | DoesNotExist | Gt | Lt
    values: List[str] = field(default_factory=list)


@dataclass
class NodeSelectorTerm:
    match_expressions: List[NodeSelectorRequirement] = field(default_factory=list)


@dataclass
class PreferredSchedulingTerm:
    weight: int = 1
    preference: NodeSelectorTerm = field(default_factory=NodeSelectorTerm)


@dataclass
class LabelSelector:
    match_labels: Dict[str, str] = field(default_factory=dict)
    match_expressions: List[NodeSelectorRequirement] = field(default_factory=list)

    def matches(self, labels: Dict[str, str]) -> bool:
        for k, v in self.match_labels.items():
            if labels.get(k) != v:
                return False
        for expr in self.match_expressions:
            val = labels.get(expr.key)
            if expr.operator == "In":
                if val not in expr.values:
                    return False
            elif expr.operator == "NotIn":
                if val in expr.values:
                    return False
            elif expr.operator == "Exists":
                if expr.key not in labels:
                    return False
            elif expr.operator == "DoesNotExist":
                if expr.key in labels:
                    return False
            else:
                return False
        return True


@dataclass
class PodAffinityTerm:
    label_selector: Optional[LabelSelector] = None
    topology_key: str = ""
    namespaces: List[str] = field(default_factory=list)


@dataclass
class WeightedPodAffinityTerm:
    weight: int = 1
    pod_affinity_term: PodAffinityTerm = field(default_factory=PodAffinityTerm)


@dataclass
class NodeAffinity:
    required: List[NodeSelectorTerm] = field(default_factory=list)  # OR of terms
    preferred: List[PreferredSchedulingTerm] = field(default_factory=list)


@dataclass
class PodAffinity:
    required: List[PodAffinityTerm] = field(default_factory=list)
    preferred: List[WeightedPodAffinityTerm] = field(default_factory=list)


@dataclass
class PodAntiAffinity:
    required: List[PodAffinityTerm] = field(default_factory=list)
    preferred: List[WeightedPodAffinityTerm] = field(default_factory=list)


@dataclass
class Affinity:
    node_affinity: Optional[NodeAffinity] = None
    pod_affinity: Optional[PodAffinity] = None
    pod_anti_affinity: Optional[PodAntiAffinity] = None


@dataclass
class TopologySpreadConstraint:
    max_skew: int = 1
    topology_key: str = ""
    when_unsatisfiable: str = "DoNotSchedule"  # or ScheduleAnyway
    label_selector: Optional[LabelSelector] = None


@dataclass
class ContainerPort:
    host_port: int = 0
    host_ip: str = ""
    protocol: str = "TCP"


@dataclass
class Container:
    name: str = "app"
    requests: Dict[str, float] = field(default_factory=dict)
    limits: Dict[str, float] = field(default_factory=dict)
    ports: List[ContainerPort] = field(default_factory=list)


@dataclass
class PodCondition:
    type: str = ""
    status: str = ""
    reason: str = ""


@dataclass
class PodStatus:
    phase: str = "Pending"
    conditions: List[PodCondition] = field(default_factory=list)
    nominated_node_name: str = ""


@dataclass
class PodSpec:
    node_name: str = ""
    node_selector: Dict[str, str] = field(default_factory=dict)
    affinity: Optional[Affinity] = None
    tolerations: List[Toleration] = field(default_factory=list)
    containers: List[Container] = field(default_factory=list)
    topology_spread_constraints: List[TopologySpreadConstraint] = field(default_factory=list)
    priority_class_name: str = ""
    volumes: List["Volume"] = field(default_factory=list)
    termination_grace_period_seconds: int = 30


@dataclass
class Volume:
    name: str = ""
    persistent_volume_claim: str = ""  # claim name, "" if not a PVC volume


@dataclass
class Pod:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PodSpec = field(default_factory=PodSpec)
    status: PodStatus = field(default_factory=PodStatus)

    def resource_requests(self) -> Dict[str, float]:
        return res.merge(*(c.requests for c in self.spec.containers))

    def resource_limits(self) -> Dict[str, float]:
        return res.merge(*(c.limits for c in self.spec.containers))

    @property
    def key(self) -> str:
        return f"{self.metadata.namespace}/{self.metadata.name}"


@dataclass
class NodeStatus:
    capacity: Dict[str, float] = field(default_factory=dict)
    allocatable: Dict[str, float] = field(default_factory=dict)
    conditions: List[PodCondition] = field(default_factory=list)
    phase: str = ""


@dataclass
class NodeSpec:
    taints: List[Taint] = field(default_factory=list)
    unschedulable: bool = False
    provider_id: str = ""


@dataclass
class Node:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: NodeSpec = field(default_factory=NodeSpec)
    status: NodeStatus = field(default_factory=NodeStatus)


@dataclass
class DaemonSet:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    pod_template: PodSpec = field(default_factory=PodSpec)


@dataclass
class PersistentVolumeClaim:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    storage_class_name: str = ""
    volume_name: str = ""  # bound PV name


@dataclass
class PersistentVolume:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    # required node-affinity terms of the PV (zone constraints etc.)
    node_affinity_required: List[NodeSelectorTerm] = field(default_factory=list)


@dataclass
class StorageClass:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    # allowed topologies: list of terms; each term is a list of requirements
    allowed_topologies: List[NodeSelectorTerm] = field(default_factory=list)


@dataclass
class PodDisruptionBudget:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    selector: Optional[LabelSelector] = None
    min_available: Optional[int] = None
    max_unavailable: Optional[int] = None


@dataclass
class Lease:
    """coordination.k8s.io/v1 Lease — cluster-scoped leader election
    (reference: cmd/controller/main.go:84-85 LeaderElection id
    ``karpenter-leader-election``)."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    holder_identity: str = ""
    lease_duration_seconds: int = 15
    acquire_time: Optional[float] = None
    renew_time: Optional[float] = None
    lease_transitions: int = 0


@dataclass
class ValidatingWebhookConfiguration:
    """admissionregistration.k8s.io/v1 — the apiserver-side registration of
    the admission webhook (reference: knative certificates.NewController
    keeps clientConfig.caBundle current, cmd/webhook/main.go:46-63).

    ``webhooks`` entries are kept as RAW wire dicts: the caBundle
    reconciler only rewrites ``clientConfig.caBundle`` and must round-trip
    every other field (rules, sideEffects, admissionReviewVersions, ...)
    byte-for-byte."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    webhooks: List[Dict[str, object]] = field(default_factory=list)


@dataclass
class Event:
    """core/v1 Event — operator-visible record of a controller action
    (launch/terminate/consolidate). The reference snapshot emits none
    (SURVEY §5.5), so this is additive capability: kubectl describe on a
    node or provisioner shows what the controllers did to it."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    involved_kind: str = ""
    involved_name: str = ""
    involved_namespace: str = ""
    reason: str = ""
    message: str = ""
    type: str = "Normal"  # Normal | Warning
    count: int = 1
    source_component: str = "karpenter-tpu"
    first_timestamp: float = 0.0
    last_timestamp: float = 0.0
