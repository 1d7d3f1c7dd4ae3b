"""Provisioner CRD-equivalent types.

Mirrors ``pkg/apis/provisioning/v1alpha5``: ``Constraints`` (labels + taints +
requirements + kubelet config + vendor provider block), ``Limits``,
``ProvisionerSpec`` (constraints + TTLs + limits), and ``Provisioner`` with a
status carrying provisioned resources.

New in this framework: ``ProvisionerSpec.solver`` selects the scheduling
backend per provisioner — ``"ffd"`` (in-process first-fit-decreasing, the
reference algorithm) or ``"tpu"`` (the batched tensor solver) — per the
north-star design in BASELINE.json.
"""

from __future__ import annotations

import random
import string
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from karpenter_tpu_torch.api import labels as lbl
from karpenter_tpu_torch.api.objects import Node, NodeSpec, ObjectMeta, Pod, Taint
from karpenter_tpu_torch.api.requirements import Requirements, SUPPORTED_PROVISIONER_OPS
from karpenter_tpu_torch.utils import resources as res

SOLVER_FFD = "ffd"
SOLVER_TPU = "tpu"


def tolerates_all(taints: List[Taint], pod: Pod) -> List[str]:
    """Errors for every taint the pod does not tolerate
    (reference: taints.go:49-60)."""
    errs = []
    for taint in taints:
        if not any(t.tolerates(taint) for t in pod.spec.tolerations):
            errs.append(f"did not tolerate {taint.key}={taint.value}:{taint.effect}")
    return errs


@dataclass
class KubeletConfiguration:
    cluster_dns: List[str] = field(default_factory=list)


@dataclass
class Constraints:
    """Applied to every node the provisioner launches
    (reference: constraints.go:28-49)."""

    labels: Dict[str, str] = field(default_factory=dict)
    taints: List[Taint] = field(default_factory=list)
    requirements: Requirements = field(default_factory=Requirements)
    kubelet_configuration: Optional[KubeletConfiguration] = None
    provider: Optional[Dict[str, Any]] = None  # vendor-specific block

    def clone(self) -> "Constraints":
        """Cheap copy: Requirements is immutable-by-convention (mutators
        return new objects), so sharing it is safe; labels/taints are copied
        one level deep. deepcopy here was the decode hot spot — the
        requirements tuples embed the whole catalog vocabulary."""
        return Constraints(
            labels=dict(self.labels),
            taints=list(self.taints),
            requirements=self.requirements,
            kubelet_configuration=self.kubelet_configuration,
            provider=self.provider,
        )

    def validate_pod(self, pod: Pod) -> List[str]:
        """Taint toleration + requirement validity + compatibility
        (reference: constraints.go:52-67). Empty list means the pod fits."""
        errs = tolerates_all(self.taints, pod)
        if errs:
            return errs
        pod_reqs = Requirements.from_pod(pod)
        verrs = pod_reqs.validate()
        if verrs:
            return [f"invalid requirements, {e}" for e in verrs]
        cerrs = self.requirements.compatible(pod_reqs)
        if cerrs:
            return [f"incompatible requirements, {e}" for e in cerrs]
        return []

    def to_node(self) -> Node:
        """Materialize a v1.Node with the termination finalizer and the
        ``karpenter.sh/not-ready:NoSchedule`` startup taint that prevents the
        kube-scheduler from double-booking capacity before our own binds land
        (reference: constraints.go:69-105)."""
        node_labels = dict(self.labels)
        for key, vs in self.requirements._sets:
            if lbl.is_restricted_node_label(key):
                continue
            op = vs.op_type()
            if op == "In":
                node_labels[key] = sorted(vs.finite_values())[0]
            elif op == "Exists":
                node_labels[key] = "".join(random.choices(string.ascii_lowercase + string.digits, k=10))
        return Node(
            metadata=ObjectMeta(labels=node_labels, finalizers=[lbl.TERMINATION_FINALIZER]),
            spec=NodeSpec(
                taints=list(self.taints)
                + [Taint(key=lbl.NOT_READY_TAINT_KEY, effect="NoSchedule")]
            ),
        )


@dataclass
class Limits:
    """Resource ceiling checked before every launch
    (reference: limits.go:24-40)."""

    resources: Dict[str, float] = field(default_factory=dict)

    def exceeded_by(self, usage: Dict[str, float]) -> Optional[str]:
        for name, used in usage.items():
            if name in self.resources and used >= self.resources[name]:
                return f"{name} resource usage of {used:g} exceeds limit of {self.resources[name]:g}"
        return None


@dataclass
class ProvisionerSpec:
    constraints: Constraints = field(default_factory=Constraints)
    ttl_seconds_after_empty: Optional[int] = None
    ttl_seconds_until_expired: Optional[int] = None
    limits: Optional[Limits] = None
    # Scheduling backend: "ffd" (in-process) or "tpu" (batched tensor solve);
    # "" = unset, resolved to the process default at admission/apply.
    solver: str = ""
    # Disruption budget for voluntary consolidation (docs/consolidation.md):
    # a maxUnavailable-style count ("3") or percent ("20%") of this
    # provisioner's nodes that may be disrupted concurrently, across every
    # settling wave. "0" disables voluntary disruption entirely; None
    # defers to the controller-level --consolidation-budget default.
    disruption_budget: Optional[str] = None


def default_provisioner(provisioner: Provisioner, default_solver: str = SOLVER_FFD) -> None:
    """Framework defaulting pass (reference: provisioner_defaults.go:154-161);
    the vendor hook runs separately. The process-level ``--default-solver``
    option lands here for provisioners that leave ``spec.solver`` unset."""
    if not provisioner.spec.solver:
        provisioner.spec.solver = default_solver


# The one condition every Provisioner maintains: it is validated, its
# catalog is reachable, and its worker is running (reference:
# register.go:51-54, provisioner_status.go:38-41 — the knative
# LivingConditionSet over ``Active``).
ACTIVE = "Active"


@dataclass
class Condition:
    """knative-style status condition (reference: provisioner_status.go:28-33
    — ``apis.Conditions``): ``status`` is "True"/"False"/"Unknown", and
    ``last_transition_time`` moves only when ``status`` flips."""

    type: str = ACTIVE
    status: str = "Unknown"
    severity: str = ""
    reason: str = ""
    message: str = ""
    last_transition_time: Optional[float] = None


@dataclass
class ProvisionerStatus:
    last_scale_time: Optional[float] = None
    resources: Dict[str, float] = field(default_factory=dict)
    conditions: List[Condition] = field(default_factory=list)

    def condition(self, type: str = ACTIVE) -> Optional[Condition]:
        for c in self.conditions:
            if c.type == type:
                return c
        return None

    def set_condition(
        self,
        type: str = ACTIVE,
        status: str = "True",
        reason: str = "",
        message: str = "",
        now: Optional[float] = None,
    ) -> bool:
        """Set/refresh a condition with knative ConditionManager semantics:
        ``lastTransitionTime`` bumps only when the status value flips.
        Returns True when anything observable changed, so callers can skip
        the status write on steady-state reconciles."""
        cond = self.condition(type)
        if cond is None:
            self.conditions.append(
                Condition(
                    type=type, status=status, reason=reason, message=message,
                    last_transition_time=now,
                )
            )
            return True
        changed = (
            cond.status != status
            or cond.reason != reason
            or cond.message != message
        )
        if cond.status != status:
            cond.last_transition_time = now
        cond.status = status
        cond.reason = reason
        cond.message = message
        return changed

    def mark_active(self, now: Optional[float] = None) -> bool:
        return self.set_condition(ACTIVE, "True", now=now)

    def mark_not_active(
        self, reason: str, message: str, now: Optional[float] = None
    ) -> bool:
        return self.set_condition(ACTIVE, "False", reason, message, now=now)


@dataclass
class Provisioner:
    metadata: ObjectMeta = field(default_factory=lambda: ObjectMeta(name="default", namespace=""))
    spec: ProvisionerSpec = field(default_factory=ProvisionerSpec)
    status: ProvisionerStatus = field(default_factory=ProvisionerStatus)

    @property
    def name(self) -> str:
        return self.metadata.name


def validate_provisioner(provisioner: Provisioner) -> List[str]:
    """Spec validation (reference: provisioner_validation.go:34-132)."""
    errs: List[str] = []
    spec = provisioner.spec
    if spec.ttl_seconds_after_empty is not None and spec.ttl_seconds_after_empty < 0:
        errs.append("ttlSecondsAfterEmpty must be non-negative")
    if spec.ttl_seconds_until_expired is not None and spec.ttl_seconds_until_expired < 0:
        errs.append("ttlSecondsUntilExpired must be non-negative")
    if spec.solver not in (SOLVER_FFD, SOLVER_TPU):
        errs.append(f"solver must be one of [{SOLVER_FFD}, {SOLVER_TPU}], got {spec.solver}")
    if spec.disruption_budget is not None:
        from karpenter_tpu_torch.controllers.disruption import parse_budget

        try:
            parse_budget(spec.disruption_budget)
        except ValueError as e:
            errs.append(f"disruptionBudget: {e}")
    c = spec.constraints
    for key, value in c.labels.items():
        errs.extend(lbl.check_qualified_name(key))
        err = lbl.check_restricted_label(key)
        if err:
            errs.append(err)
        if not value:
            errs.append(f"label {key} has empty value")
        else:
            errs.extend(lbl.check_label_value(value))
    for taint in c.taints:
        if not taint.key:
            errs.append("taint key must not be empty")
        else:
            errs.extend(lbl.check_qualified_name(taint.key))
        errs.extend(lbl.check_label_value(taint.value))
        if taint.effect not in ("NoSchedule", "PreferNoSchedule", "NoExecute"):
            errs.append(f"invalid taint effect {taint.effect}")
    for req in c.requirements.requirements:
        if req.operator not in SUPPORTED_PROVISIONER_OPS:
            errs.append(
                f"operator {req.operator} not in {sorted(SUPPORTED_PROVISIONER_OPS)} for key {req.key}"
            )
        # key syntax is covered by c.requirements.validate() below
        err = lbl.check_restricted_label(req.key)
        if err:
            errs.append(err)
    errs.extend(c.requirements.validate())
    return errs
