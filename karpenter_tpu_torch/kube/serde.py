"""Kubernetes wire-format serialization.

Maps the framework's lightweight object model (``api/objects.py``,
``api/provisioner.py``) to and from real Kubernetes JSON — camelCase field
names, resource quantities as strings, RFC3339 timestamps. The in-memory
``Cluster`` applies every merge patch through it (``to_wire`` →
``json_merge`` → ``from_wire``), so controllers write patches in the shape
an apiserver takes. The reference gets this from ``k8s.io/api`` codegen;
here the mapping is explicit per kind.

``to_wire(kind, obj)`` / ``from_wire(kind, doc)`` cover every kind the
controllers reconcile plus coordination Leases for leader election.
"""

from __future__ import annotations

import datetime
from typing import Any, Dict, List, Optional

from karpenter_tpu_torch.api.objects import (
    Affinity,
    Container,
    ContainerPort,
    DaemonSet,
    LabelSelector,
    Lease,
    Node,
    NodeAffinity,
    NodeSelectorRequirement,
    NodeSelectorTerm,
    NodeSpec,
    NodeStatus,
    ObjectMeta,
    OwnerReference,
    PersistentVolume,
    PersistentVolumeClaim,
    Pod,
    PodAffinity,
    PodAffinityTerm,
    PodAntiAffinity,
    PodCondition,
    PodDisruptionBudget,
    PodSpec,
    PodStatus,
    PreferredSchedulingTerm,
    StorageClass,
    Taint,
    Toleration,
    TopologySpreadConstraint,
    Volume,
    WeightedPodAffinityTerm,
)
from karpenter_tpu_torch.api.provisioner import (
    Condition,
    Constraints,
    KubeletConfiguration,
    Limits,
    Provisioner,
    ProvisionerSpec,
    ProvisionerStatus,
)
from karpenter_tpu_torch.api.requirements import Requirements
from karpenter_tpu_torch.utils import resources as res

# kind -> (apiVersion, Kind, namespaced)
KIND_INFO: Dict[str, Any] = {
    "pods": ("v1", "Pod", True),
    "nodes": ("v1", "Node", False),
    "daemonsets": ("apps/v1", "DaemonSet", True),
    "provisioners": ("karpenter.sh/v1alpha5", "Provisioner", False),
    "pvcs": ("v1", "PersistentVolumeClaim", True),
    "pvs": ("v1", "PersistentVolume", False),
    "storageclasses": ("storage.k8s.io/v1", "StorageClass", False),
    "pdbs": ("policy/v1", "PodDisruptionBudget", True),
    "leases": ("coordination.k8s.io/v1", "Lease", True),
    "validatingwebhookconfigurations": (
        "admissionregistration.k8s.io/v1", "ValidatingWebhookConfiguration", False,
    ),
    "mutatingwebhookconfigurations": (
        "admissionregistration.k8s.io/v1", "MutatingWebhookConfiguration", False,
    ),
    "events": ("v1", "Event", True),
}


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------


def _ts(value: Optional[float]) -> Optional[str]:
    if value is None or not value:
        return None
    return (
        datetime.datetime.fromtimestamp(value, tz=datetime.timezone.utc)
        .strftime("%Y-%m-%dT%H:%M:%SZ")
    )


# public name for controllers composing status patches in wire shape
wire_ts = _ts


def _ts_micro(value: Optional[float]) -> Optional[str]:
    """MicroTime — Lease acquire/renew times carry sub-second precision
    (k8s.io/apimachinery MicroTime); plain RFC3339 seconds would break
    short leases."""
    if value is None or not value:
        return None
    return (
        datetime.datetime.fromtimestamp(value, tz=datetime.timezone.utc)
        .strftime("%Y-%m-%dT%H:%M:%S.%fZ")
    )


def parse_ts(value) -> Optional[float]:
    if value is None or value == "":
        return None
    if isinstance(value, (int, float)):
        return float(value)
    s = str(value).replace("Z", "+00:00")
    return datetime.datetime.fromisoformat(s).timestamp()


def _quantity(value: float) -> str:
    if value == int(value):
        return str(int(value))
    return f"{value:g}"


def quantities(rl: Dict[str, float]) -> Dict[str, str]:
    return {k: _quantity(v) for k, v in rl.items()}


def parse_quantities(raw: Optional[Dict[str, Any]]) -> Dict[str, float]:
    return {k: res.parse_quantity(v) for k, v in (raw or {}).items()}


def _drop_none(d: Dict[str, Any]) -> Dict[str, Any]:
    return {k: v for k, v in d.items() if v is not None and v != {} and v != []}


# ---------------------------------------------------------------------------
# metadata
# ---------------------------------------------------------------------------


def meta_to_wire(m: ObjectMeta, namespaced: bool = True) -> Dict[str, Any]:
    out: Dict[str, Any] = {"name": m.name}
    if namespaced and m.namespace:
        out["namespace"] = m.namespace
    if m.labels:
        out["labels"] = dict(m.labels)
    if m.annotations:
        out["annotations"] = dict(m.annotations)
    if m.finalizers:
        out["finalizers"] = list(m.finalizers)
    if m.owner_references:
        out["ownerReferences"] = [
            {"apiVersion": o.api_version, "kind": o.kind, "name": o.name, "uid": ""}
            for o in m.owner_references
        ]
    if m.uid:
        out["uid"] = m.uid
    if m.creation_timestamp:
        out["creationTimestamp"] = _ts(m.creation_timestamp)
    if m.deletion_timestamp is not None:
        out["deletionTimestamp"] = _ts(m.deletion_timestamp)
    if m.resource_version:
        out["resourceVersion"] = str(m.resource_version)
    return out


def meta_from_wire(doc: Dict[str, Any]) -> ObjectMeta:
    # k8s documents resourceVersions as opaque strings; etcd's happen to be
    # numeric. A non-numeric RV (proxy, alternative storage) degrades to 0
    # ("unknown") rather than raising.
    rv = doc.get("resourceVersion") or 0
    try:
        rv = int(rv)
    except (TypeError, ValueError):
        rv = 0
    return ObjectMeta(
        name=doc.get("name", ""),
        namespace=doc.get("namespace", "default"),
        labels=dict(doc.get("labels") or {}),
        annotations=dict(doc.get("annotations") or {}),
        finalizers=list(doc.get("finalizers") or []),
        owner_references=[
            OwnerReference(
                api_version=o.get("apiVersion", ""),
                kind=o.get("kind", ""),
                name=o.get("name", ""),
            )
            for o in doc.get("ownerReferences") or []
        ],
        uid=doc.get("uid", "") or "",
        creation_timestamp=parse_ts(doc.get("creationTimestamp")) or 0.0,
        deletion_timestamp=parse_ts(doc.get("deletionTimestamp")),
        resource_version=rv,
    )


# ---------------------------------------------------------------------------
# shared sub-objects
# ---------------------------------------------------------------------------


def _req_to_wire(r: NodeSelectorRequirement) -> Dict[str, Any]:
    out = {"key": r.key, "operator": r.operator}
    if r.values:
        out["values"] = list(r.values)
    return out


def _req_from_wire(d: Dict[str, Any]) -> NodeSelectorRequirement:
    return NodeSelectorRequirement(
        key=d.get("key", ""), operator=d.get("operator", ""), values=list(d.get("values") or [])
    )


def _term_to_wire(t: NodeSelectorTerm) -> Dict[str, Any]:
    return {"matchExpressions": [_req_to_wire(r) for r in t.match_expressions]}


def _term_from_wire(d: Dict[str, Any]) -> NodeSelectorTerm:
    return NodeSelectorTerm(
        match_expressions=[_req_from_wire(r) for r in d.get("matchExpressions") or []]
    )


def _selector_to_wire(s: Optional[LabelSelector]) -> Optional[Dict[str, Any]]:
    if s is None:
        return None
    return _drop_none(
        {
            "matchLabels": dict(s.match_labels) or None,
            "matchExpressions": [_req_to_wire(r) for r in s.match_expressions] or None,
        }
    )


def _selector_from_wire(d: Optional[Dict[str, Any]]) -> Optional[LabelSelector]:
    if d is None:
        return None
    return LabelSelector(
        match_labels=dict(d.get("matchLabels") or {}),
        match_expressions=[_req_from_wire(r) for r in d.get("matchExpressions") or []],
    )


def taint_to_wire(t: Taint) -> Dict[str, Any]:
    return _drop_none({"key": t.key, "value": t.value or None, "effect": t.effect})


_taint_to_wire = taint_to_wire  # internal alias


def _taint_from_wire(d: Dict[str, Any]) -> Taint:
    return Taint(key=d.get("key", ""), value=d.get("value", "") or "", effect=d.get("effect", "NoSchedule"))


def _pod_affinity_term_to_wire(t: PodAffinityTerm) -> Dict[str, Any]:
    return _drop_none(
        {
            "labelSelector": _selector_to_wire(t.label_selector),
            "topologyKey": t.topology_key,
            "namespaces": list(t.namespaces) or None,
        }
    )


def _pod_affinity_term_from_wire(d: Dict[str, Any]) -> PodAffinityTerm:
    return PodAffinityTerm(
        label_selector=_selector_from_wire(d.get("labelSelector")),
        topology_key=d.get("topologyKey", ""),
        namespaces=list(d.get("namespaces") or []),
    )


def _affinity_to_wire(a: Optional[Affinity]) -> Optional[Dict[str, Any]]:
    if a is None:
        return None
    out: Dict[str, Any] = {}
    if a.node_affinity is not None:
        na: Dict[str, Any] = {}
        if a.node_affinity.required:
            na["requiredDuringSchedulingIgnoredDuringExecution"] = {
                "nodeSelectorTerms": [_term_to_wire(t) for t in a.node_affinity.required]
            }
        if a.node_affinity.preferred:
            na["preferredDuringSchedulingIgnoredDuringExecution"] = [
                {"weight": p.weight, "preference": _term_to_wire(p.preference)}
                for p in a.node_affinity.preferred
            ]
        out["nodeAffinity"] = na
    for attr, key in (("pod_affinity", "podAffinity"), ("pod_anti_affinity", "podAntiAffinity")):
        pa = getattr(a, attr)
        if pa is None:
            continue
        block: Dict[str, Any] = {}
        if pa.required:
            block["requiredDuringSchedulingIgnoredDuringExecution"] = [
                _pod_affinity_term_to_wire(t) for t in pa.required
            ]
        if pa.preferred:
            block["preferredDuringSchedulingIgnoredDuringExecution"] = [
                {"weight": w.weight, "podAffinityTerm": _pod_affinity_term_to_wire(w.pod_affinity_term)}
                for w in pa.preferred
            ]
        out[key] = block
    return out or None


def _affinity_from_wire(d: Optional[Dict[str, Any]]) -> Optional[Affinity]:
    if not d:
        return None
    out = Affinity()
    na = d.get("nodeAffinity")
    if na:
        req = na.get("requiredDuringSchedulingIgnoredDuringExecution") or {}
        out.node_affinity = NodeAffinity(
            required=[_term_from_wire(t) for t in req.get("nodeSelectorTerms") or []],
            preferred=[
                PreferredSchedulingTerm(
                    weight=p.get("weight", 1), preference=_term_from_wire(p.get("preference") or {})
                )
                for p in na.get("preferredDuringSchedulingIgnoredDuringExecution") or []
            ],
        )
    for key, cls, attr in (
        ("podAffinity", PodAffinity, "pod_affinity"),
        ("podAntiAffinity", PodAntiAffinity, "pod_anti_affinity"),
    ):
        pa = d.get(key)
        if not pa:
            continue
        setattr(
            out,
            attr,
            cls(
                required=[
                    _pod_affinity_term_from_wire(t)
                    for t in pa.get("requiredDuringSchedulingIgnoredDuringExecution") or []
                ],
                preferred=[
                    WeightedPodAffinityTerm(
                        weight=w.get("weight", 1),
                        pod_affinity_term=_pod_affinity_term_from_wire(w.get("podAffinityTerm") or {}),
                    )
                    for w in pa.get("preferredDuringSchedulingIgnoredDuringExecution") or []
                ],
            ),
        )
    if out.node_affinity is None and out.pod_affinity is None and out.pod_anti_affinity is None:
        return None
    return out


def _pod_spec_to_wire(s: PodSpec) -> Dict[str, Any]:
    return _drop_none(
        {
            "nodeName": s.node_name or None,
            "nodeSelector": dict(s.node_selector) or None,
            "affinity": _affinity_to_wire(s.affinity),
            "tolerations": [
                _drop_none(
                    {
                        "key": t.key or None,
                        "operator": t.operator,
                        "value": t.value or None,
                        "effect": t.effect or None,
                        "tolerationSeconds": t.toleration_seconds,
                    }
                )
                for t in s.tolerations
            ]
            or None,
            "containers": [
                _drop_none(
                    {
                        "name": c.name,
                        "resources": _drop_none(
                            {
                                "requests": quantities(c.requests) or None,
                                "limits": quantities(c.limits) or None,
                            }
                        )
                        or None,
                        "ports": [
                            _drop_none(
                                {
                                    "hostPort": p.host_port or None,
                                    "hostIP": p.host_ip or None,
                                    "protocol": p.protocol,
                                }
                            )
                            for p in c.ports
                        ]
                        or None,
                    }
                )
                for c in s.containers
            ]
            or None,
            "topologySpreadConstraints": [
                _drop_none(
                    {
                        "maxSkew": t.max_skew,
                        "topologyKey": t.topology_key,
                        "whenUnsatisfiable": t.when_unsatisfiable,
                        "labelSelector": _selector_to_wire(t.label_selector),
                    }
                )
                for t in s.topology_spread_constraints
            ]
            or None,
            "priorityClassName": s.priority_class_name or None,
            "volumes": [
                _drop_none(
                    {
                        "name": v.name,
                        "persistentVolumeClaim": (
                            {"claimName": v.persistent_volume_claim}
                            if v.persistent_volume_claim
                            else None
                        ),
                    }
                )
                for v in s.volumes
            ]
            or None,
            "terminationGracePeriodSeconds": s.termination_grace_period_seconds,
        }
    )


def _pod_spec_from_wire(d: Dict[str, Any]) -> PodSpec:
    return PodSpec(
        node_name=d.get("nodeName", "") or "",
        node_selector=dict(d.get("nodeSelector") or {}),
        affinity=_affinity_from_wire(d.get("affinity")),
        tolerations=[
            Toleration(
                key=t.get("key", "") or "",
                operator=t.get("operator", "Equal"),
                value=t.get("value", "") or "",
                effect=t.get("effect", "") or "",
                toleration_seconds=t.get("tolerationSeconds"),
            )
            for t in d.get("tolerations") or []
        ],
        containers=[
            Container(
                name=c.get("name", "app"),
                requests=parse_quantities((c.get("resources") or {}).get("requests")),
                limits=parse_quantities((c.get("resources") or {}).get("limits")),
                ports=[
                    ContainerPort(
                        host_port=p.get("hostPort", 0) or 0,
                        host_ip=p.get("hostIP", "") or "",
                        protocol=p.get("protocol", "TCP"),
                    )
                    for p in c.get("ports") or []
                ],
            )
            for c in d.get("containers") or []
        ],
        topology_spread_constraints=[
            TopologySpreadConstraint(
                max_skew=t.get("maxSkew", 1),
                topology_key=t.get("topologyKey", ""),
                when_unsatisfiable=t.get("whenUnsatisfiable", "DoNotSchedule"),
                label_selector=_selector_from_wire(t.get("labelSelector")),
            )
            for t in d.get("topologySpreadConstraints") or []
        ],
        priority_class_name=d.get("priorityClassName", "") or "",
        volumes=[
            Volume(
                name=v.get("name", ""),
                persistent_volume_claim=(v.get("persistentVolumeClaim") or {}).get("claimName", ""),
            )
            for v in d.get("volumes") or []
        ],
        termination_grace_period_seconds=d.get("terminationGracePeriodSeconds", 30) or 30,
    )


def _conditions_to_wire(conds: List[PodCondition]) -> List[Dict[str, Any]]:
    return [
        _drop_none({"type": c.type, "status": c.status, "reason": c.reason or None})
        for c in conds
    ]


def _conditions_from_wire(raw) -> List[PodCondition]:
    return [
        PodCondition(type=c.get("type", ""), status=c.get("status", ""), reason=c.get("reason", "") or "")
        for c in raw or []
    ]


# ---------------------------------------------------------------------------
# per-kind
# ---------------------------------------------------------------------------


def _pod_to_wire(p: Pod) -> Dict[str, Any]:
    return {
        "spec": _pod_spec_to_wire(p.spec),
        "status": _drop_none(
            {
                "phase": p.status.phase or None,
                "conditions": _conditions_to_wire(p.status.conditions) or None,
                "nominatedNodeName": p.status.nominated_node_name or None,
            }
        ),
    }


def _pod_from_wire(doc: Dict[str, Any]) -> Pod:
    status = doc.get("status") or {}
    return Pod(
        metadata=meta_from_wire(doc.get("metadata") or {}),
        spec=_pod_spec_from_wire(doc.get("spec") or {}),
        status=PodStatus(
            phase=status.get("phase", "Pending") or "Pending",
            conditions=_conditions_from_wire(status.get("conditions")),
            nominated_node_name=status.get("nominatedNodeName", "") or "",
        ),
    )


def _node_to_wire(n: Node) -> Dict[str, Any]:
    return {
        "spec": _drop_none(
            {
                "taints": [_taint_to_wire(t) for t in n.spec.taints] or None,
                "unschedulable": n.spec.unschedulable or None,
                "providerID": n.spec.provider_id or None,
            }
        ),
        "status": _drop_none(
            {
                "capacity": quantities(n.status.capacity) or None,
                "allocatable": quantities(n.status.allocatable) or None,
                "conditions": _conditions_to_wire(n.status.conditions) or None,
                "phase": n.status.phase or None,
            }
        ),
    }


def _node_from_wire(doc: Dict[str, Any]) -> Node:
    spec = doc.get("spec") or {}
    status = doc.get("status") or {}
    return Node(
        metadata=meta_from_wire(doc.get("metadata") or {}),
        spec=NodeSpec(
            taints=[_taint_from_wire(t) for t in spec.get("taints") or []],
            unschedulable=bool(spec.get("unschedulable", False)),
            provider_id=spec.get("providerID", "") or "",
        ),
        status=NodeStatus(
            capacity=parse_quantities(status.get("capacity")),
            allocatable=parse_quantities(status.get("allocatable")),
            conditions=_conditions_from_wire(status.get("conditions")),
            phase=status.get("phase", "") or "",
        ),
    )


def _daemonset_to_wire(d: DaemonSet) -> Dict[str, Any]:
    return {"spec": {"template": {"spec": _pod_spec_to_wire(d.pod_template)}}}


def _daemonset_from_wire(doc: Dict[str, Any]) -> DaemonSet:
    template = ((doc.get("spec") or {}).get("template") or {}).get("spec") or {}
    return DaemonSet(
        metadata=meta_from_wire(doc.get("metadata") or {}),
        pod_template=_pod_spec_from_wire(template),
    )


def _prov_conditions_to_wire(conds: List[Condition]) -> List[Dict[str, Any]]:
    # knative apis.Condition wire shape (reference: provisioner_status.go:28-33)
    return [
        _drop_none(
            {
                "type": c.type,
                "status": c.status,
                "severity": c.severity or None,
                "reason": c.reason or None,
                "message": c.message or None,
                "lastTransitionTime": _ts(c.last_transition_time),
            }
        )
        for c in conds
    ]


def prov_condition_to_wire(c: Condition) -> Dict[str, Any]:
    """Wire shape of one provisioner condition — controllers build status
    patches from this so the patch and the serializer can never drift."""
    return _prov_conditions_to_wire([c])[0]


def _prov_conditions_from_wire(raw) -> List[Condition]:
    return [
        Condition(
            type=c.get("type", ""),
            status=c.get("status", "Unknown") or "Unknown",
            severity=c.get("severity", "") or "",
            reason=c.get("reason", "") or "",
            message=c.get("message", "") or "",
            last_transition_time=parse_ts(c.get("lastTransitionTime")),
        )
        for c in raw or []
    ]


def _provisioner_to_wire(p: Provisioner) -> Dict[str, Any]:
    c = p.spec.constraints
    spec = _drop_none(
        {
            "labels": dict(c.labels) or None,
            "taints": [_taint_to_wire(t) for t in c.taints] or None,
            "requirements": [_req_to_wire(r) for r in c.requirements.requirements] or None,
            "kubeletConfiguration": (
                {"clusterDNS": list(c.kubelet_configuration.cluster_dns)}
                if c.kubelet_configuration is not None
                else None
            ),
            "provider": c.provider,
            "ttlSecondsAfterEmpty": p.spec.ttl_seconds_after_empty,
            "ttlSecondsUntilExpired": p.spec.ttl_seconds_until_expired,
            "limits": (
                {"resources": quantities(p.spec.limits.resources)}
                if p.spec.limits is not None
                else None
            ),
            "solver": p.spec.solver or None,
            "disruptionBudget": p.spec.disruption_budget,
        }
    )
    return {
        "spec": spec,
        "status": _drop_none(
            {
                "lastScaleTime": _ts(p.status.last_scale_time),
                "resources": quantities(p.status.resources) or None,
                "conditions": _prov_conditions_to_wire(p.status.conditions) or None,
            }
        ),
    }


def _provisioner_from_wire(doc: Dict[str, Any]) -> Provisioner:
    spec = doc.get("spec") or {}
    status = doc.get("status") or {}
    kc = spec.get("kubeletConfiguration")
    limits = spec.get("limits")
    meta = meta_from_wire(doc.get("metadata") or {})
    return Provisioner(
        metadata=meta,
        spec=ProvisionerSpec(
            constraints=Constraints(
                labels=dict(spec.get("labels") or {}),
                taints=[_taint_from_wire(t) for t in spec.get("taints") or []],
                requirements=Requirements.new(
                    *(_req_from_wire(r) for r in spec.get("requirements") or [])
                ),
                kubelet_configuration=(
                    KubeletConfiguration(cluster_dns=list(kc.get("clusterDNS") or []))
                    if kc is not None
                    else None
                ),
                provider=spec.get("provider"),
            ),
            ttl_seconds_after_empty=spec.get("ttlSecondsAfterEmpty"),
            ttl_seconds_until_expired=spec.get("ttlSecondsUntilExpired"),
            limits=(
                Limits(resources=parse_quantities(limits.get("resources")))
                if limits is not None
                else None
            ),
            solver=spec.get("solver", "") or "",
            disruption_budget=(
                str(spec["disruptionBudget"])
                if spec.get("disruptionBudget") is not None
                else None
            ),
        ),
        status=ProvisionerStatus(
            last_scale_time=parse_ts(status.get("lastScaleTime")),
            resources=parse_quantities(status.get("resources")),
            conditions=_prov_conditions_from_wire(status.get("conditions")),
        ),
    )


def _pvc_to_wire(p: PersistentVolumeClaim) -> Dict[str, Any]:
    return {
        "spec": _drop_none(
            {
                "storageClassName": p.storage_class_name or None,
                "volumeName": p.volume_name or None,
            }
        )
    }


def _pvc_from_wire(doc: Dict[str, Any]) -> PersistentVolumeClaim:
    spec = doc.get("spec") or {}
    return PersistentVolumeClaim(
        metadata=meta_from_wire(doc.get("metadata") or {}),
        storage_class_name=spec.get("storageClassName", "") or "",
        volume_name=spec.get("volumeName", "") or "",
    )


def _pv_to_wire(p: PersistentVolume) -> Dict[str, Any]:
    spec: Dict[str, Any] = {}
    if p.node_affinity_required:
        spec["nodeAffinity"] = {
            "required": {"nodeSelectorTerms": [_term_to_wire(t) for t in p.node_affinity_required]}
        }
    return {"spec": spec}


def _pv_from_wire(doc: Dict[str, Any]) -> PersistentVolume:
    req = (((doc.get("spec") or {}).get("nodeAffinity") or {}).get("required") or {})
    return PersistentVolume(
        metadata=meta_from_wire(doc.get("metadata") or {}),
        node_affinity_required=[_term_from_wire(t) for t in req.get("nodeSelectorTerms") or []],
    )


def _storageclass_to_wire(s: StorageClass) -> Dict[str, Any]:
    # TopologySelectorTerm: matchLabelExpressions [{key, values}]
    return _drop_none(
        {
            "provisioner": "karpenter.test/provisioner",
            "allowedTopologies": [
                {
                    "matchLabelExpressions": [
                        {"key": r.key, "values": list(r.values)} for r in t.match_expressions
                    ]
                }
                for t in s.allowed_topologies
            ]
            or None,
        }
    )


def _storageclass_from_wire(doc: Dict[str, Any]) -> StorageClass:
    return StorageClass(
        metadata=meta_from_wire(doc.get("metadata") or {}),
        allowed_topologies=[
            NodeSelectorTerm(
                match_expressions=[
                    NodeSelectorRequirement(
                        key=e.get("key", ""), operator="In", values=list(e.get("values") or [])
                    )
                    for e in t.get("matchLabelExpressions") or []
                ]
            )
            for t in doc.get("allowedTopologies") or []
        ],
    )


def _pdb_to_wire(p: PodDisruptionBudget) -> Dict[str, Any]:
    return {
        "spec": _drop_none(
            {
                "selector": _selector_to_wire(p.selector),
                "minAvailable": p.min_available,
                "maxUnavailable": p.max_unavailable,
            }
        )
    }


def _pdb_from_wire(doc: Dict[str, Any]) -> PodDisruptionBudget:
    spec = doc.get("spec") or {}
    return PodDisruptionBudget(
        metadata=meta_from_wire(doc.get("metadata") or {}),
        selector=_selector_from_wire(spec.get("selector")),
        min_available=spec.get("minAvailable"),
        max_unavailable=spec.get("maxUnavailable"),
    )


def _lease_to_wire(l: Lease) -> Dict[str, Any]:
    return {
        "spec": _drop_none(
            {
                "holderIdentity": l.holder_identity or None,
                "leaseDurationSeconds": l.lease_duration_seconds,
                "acquireTime": _ts_micro(l.acquire_time),
                "renewTime": _ts_micro(l.renew_time),
                "leaseTransitions": l.lease_transitions or None,
            }
        )
    }


def _lease_from_wire(doc: Dict[str, Any]) -> Lease:
    spec = doc.get("spec") or {}
    return Lease(
        metadata=meta_from_wire(doc.get("metadata") or {}),
        holder_identity=spec.get("holderIdentity", "") or "",
        lease_duration_seconds=spec.get("leaseDurationSeconds", 15) or 15,
        acquire_time=parse_ts(spec.get("acquireTime")),
        renew_time=parse_ts(spec.get("renewTime")),
        lease_transitions=spec.get("leaseTransitions", 0) or 0,
    )


def _vwc_to_wire(obj) -> Dict[str, Any]:
    # webhooks entries are raw wire dicts (see api.objects) — passthrough
    return {"webhooks": [dict(w) for w in obj.webhooks]}


def _vwc_from_wire(doc: Dict[str, Any]):
    from karpenter_tpu_torch.api.objects import ValidatingWebhookConfiguration

    return ValidatingWebhookConfiguration(
        metadata=meta_from_wire(doc.get("metadata") or {}),
        webhooks=[dict(w) for w in doc.get("webhooks") or []],
    )


def _event_to_wire(e) -> Dict[str, Any]:
    return _drop_none(
        {
            "involvedObject": _drop_none(
                {
                    "kind": e.involved_kind,
                    "name": e.involved_name,
                    "namespace": e.involved_namespace or None,
                }
            ),
            "reason": e.reason,
            "message": e.message,
            "type": e.type,
            "count": e.count,
            "source": {"component": e.source_component},
            "firstTimestamp": _ts(e.first_timestamp),
            "lastTimestamp": _ts(e.last_timestamp),
        }
    )


def _event_from_wire(doc: Dict[str, Any]):
    from karpenter_tpu_torch.api.objects import Event

    inv = doc.get("involvedObject") or {}
    return Event(
        metadata=meta_from_wire(doc.get("metadata") or {}),
        involved_kind=inv.get("kind", ""),
        involved_name=inv.get("name", ""),
        involved_namespace=inv.get("namespace", ""),
        reason=doc.get("reason", ""),
        message=doc.get("message", ""),
        type=doc.get("type", "Normal"),
        count=int(doc.get("count") or 1),
        source_component=(doc.get("source") or {}).get("component", ""),
        first_timestamp=parse_ts(doc.get("firstTimestamp")) or 0.0,
        last_timestamp=parse_ts(doc.get("lastTimestamp")) or 0.0,
    )


_TO = {
    "pods": _pod_to_wire,
    "nodes": _node_to_wire,
    "daemonsets": _daemonset_to_wire,
    "provisioners": _provisioner_to_wire,
    "pvcs": _pvc_to_wire,
    "pvs": _pv_to_wire,
    "storageclasses": _storageclass_to_wire,
    "pdbs": _pdb_to_wire,
    "leases": _lease_to_wire,
    "validatingwebhookconfigurations": _vwc_to_wire,
    "mutatingwebhookconfigurations": _vwc_to_wire,
    "events": _event_to_wire,
}

_FROM = {
    "pods": _pod_from_wire,
    "nodes": _node_from_wire,
    "daemonsets": _daemonset_from_wire,
    "provisioners": _provisioner_from_wire,
    "pvcs": _pvc_from_wire,
    "pvs": _pv_from_wire,
    "storageclasses": _storageclass_from_wire,
    "pdbs": _pdb_from_wire,
    "leases": _lease_from_wire,
    "validatingwebhookconfigurations": _vwc_from_wire,
    "mutatingwebhookconfigurations": _vwc_from_wire,
    "events": _event_from_wire,
}


def json_merge(target, patch):
    """RFC 7386 JSON merge patch."""
    if not isinstance(patch, dict):
        return patch
    if not isinstance(target, dict):
        target = {}
    out = dict(target)
    for k, v in patch.items():
        if v is None:
            out.pop(k, None)
        else:
            out[k] = json_merge(out.get(k), v)
    return out


def to_wire(kind: str, obj) -> Dict[str, Any]:
    api_version, k8s_kind, namespaced = KIND_INFO[kind]
    doc = {"apiVersion": api_version, "kind": k8s_kind}
    doc.update(_TO[kind](obj))
    doc["metadata"] = meta_to_wire(obj.metadata, namespaced)
    return doc


def from_wire(kind: str, doc: Dict[str, Any]):
    obj = _FROM[kind](doc)
    if not KIND_INFO[kind][2]:
        # cluster-scoped: the framework's store convention is namespace ""
        obj.metadata.namespace = ""
    return obj
