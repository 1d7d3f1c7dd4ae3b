"""Requirements: the central constraint representation.

A ``Requirements`` wraps a list of node-selector requirements plus a per-key
``ValueSet`` (possibly a complement set) that is the running intersection of
every requirement seen for that key. Semantics mirror
``pkg/apis/provisioning/v1alpha5/requirements.go:34-191``:

- ``add`` normalizes aliased label keys, drops ignored keys, and intersects
  per-key sets;
- ``compatible`` checks pairwise per-key non-empty intersection, with the
  NotIn/DoesNotExist escape hatch;
- ``from_pod`` folds nodeSelector + the heaviest preferred node-affinity term
  + the first required node-affinity term.

The class is immutable-by-convention: mutating operations return new objects,
like the reference's value-receiver methods.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Set, Tuple

from karpenter_tpu_torch.api import labels as lbl
from karpenter_tpu_torch.api.objects import NodeSelectorRequirement, Pod
from karpenter_tpu_torch.utils.sets import (
    OP_DOES_NOT_EXIST,
    OP_EXISTS,
    OP_IN,
    OP_NOT_IN,
    ValueSet,
    set_for_operator,
)

# Requirement operators a Provisioner may use vs. what pods may add
# (reference: provisioner_validation.go:30-31).
SUPPORTED_PROVISIONER_OPS = {OP_IN, OP_NOT_IN, OP_EXISTS}
SUPPORTED_NODE_SELECTOR_OPS = {OP_IN, OP_NOT_IN, OP_EXISTS, OP_DOES_NOT_EXIST}


@dataclass(frozen=True)
class Requirements:
    requirements: Tuple[NodeSelectorRequirement, ...] = ()
    _sets: Tuple[Tuple[str, ValueSet], ...] = field(default_factory=tuple)

    # -- constructors ------------------------------------------------------
    @staticmethod
    def new(*reqs: NodeSelectorRequirement) -> "Requirements":
        return Requirements().add(*reqs)

    @staticmethod
    def from_labels(labels: Dict[str, str]) -> "Requirements":
        return Requirements.new(
            *(
                NodeSelectorRequirement(key=k, operator=OP_IN, values=[v])
                for k, v in labels.items()
            )
        )

    @staticmethod
    def from_pod(pod: Pod) -> "Requirements":
        """NodeSelector + heaviest preferred node-affinity term + first
        required node-affinity OR-term (reference: requirements.go:55-75)."""
        reqs: List[NodeSelectorRequirement] = [
            NodeSelectorRequirement(key=k, operator=OP_IN, values=[v])
            for k, v in pod.spec.node_selector.items()
        ]
        aff = pod.spec.affinity
        if aff is None or aff.node_affinity is None:
            return Requirements.new(*reqs)
        na = aff.node_affinity
        if na.preferred:
            heaviest = max(na.preferred, key=lambda t: t.weight)
            reqs.extend(heaviest.preference.match_expressions)
        if na.required:
            reqs.extend(na.required[0].match_expressions)
        return Requirements.new(*reqs)

    # -- internal ----------------------------------------------------------
    def _set_map(self) -> Dict[str, ValueSet]:
        return dict(self._sets)

    # -- mutation (returns new object) ------------------------------------
    def add(self, *new_reqs: NodeSelectorRequirement) -> "Requirements":
        """Insert requirements, intersecting per-key sets
        (reference: requirements.go:78-110)."""
        reqs = list(self.requirements)
        sets = self._set_map()
        for req in new_reqs:
            key = lbl.NORMALIZED_LABELS.get(req.key, req.key)
            if key in lbl.IGNORED_LABELS:
                continue
            req = NodeSelectorRequirement(key=key, operator=req.operator, values=list(req.values))
            reqs.append(req)
            try:
                values = set_for_operator(req.operator, req.values)
            except ValueError:
                # Unknown operators behave as the zero-value (empty) set, like
                # the reference's uncovered switch; validation reports them.
                values = ValueSet.empty()
            if key in sets:
                values = values.intersection(sets[key])
            sets[key] = values
        return Requirements(tuple(reqs), tuple(sorted(sets.items())))

    def merge(self, other: "Requirements") -> "Requirements":
        return self.add(*other.requirements)

    # -- queries -----------------------------------------------------------
    def keys(self) -> Set[str]:
        return {r.key for r in self.requirements}

    def has(self, key: str) -> bool:
        return any(k == key for k, _ in self._sets)

    def get(self, key: str) -> ValueSet:
        """The running intersection for a key; missing keys behave as the
        empty finite set, matching the reference's zero-value Set."""
        for k, vs in self._sets:
            if k == key:
                return vs
        return ValueSet.empty()

    def zones(self) -> Set[str]:
        return set(self.get(lbl.TOPOLOGY_ZONE).finite_values())

    def instance_types(self) -> Set[str]:
        return set(self.get(lbl.INSTANCE_TYPE).finite_values())

    def architectures(self) -> Set[str]:
        return set(self.get(lbl.ARCH).finite_values())

    def operating_systems(self) -> Set[str]:
        return set(self.get(lbl.OS).finite_values())

    def capacity_types(self) -> Set[str]:
        return set(self.get(lbl.CAPACITY_TYPE).finite_values())

    # -- validation / compatibility ---------------------------------------
    def validate(self) -> List[str]:
        """Feasibility of the requirements themselves
        (reference: requirements.go:153-172)."""
        errs: List[str] = []
        for req in self.requirements:
            if not _is_qualified_name(req.key):
                errs.append(f"key {req.key} is not a qualified name")
            for value in req.values:
                if not _is_valid_label_value(value):
                    errs.append(f"invalid value {value} for key {req.key}")
            if req.operator not in SUPPORTED_NODE_SELECTOR_OPS:
                errs.append(
                    f"operator {req.operator} not in {sorted(SUPPORTED_NODE_SELECTOR_OPS)} for key {req.key}"
                )
            if self.get(req.key).cardinality == 0 and req.operator != OP_DOES_NOT_EXIST:
                errs.append(f"no feasible value for key {req.key}")
        return errs

    def compatible(self, other: "Requirements") -> List[str]:
        """Can ``other``'s requirements be met alongside ours
        (reference: requirements.go:175-191)? Returns error strings, empty if
        compatible."""
        errs: List[str] = []
        for key, requirement in other._sets:
            mine = self.get(key)
            intersection = requirement.intersection(mine)
            if intersection.cardinality == 0:
                if requirement.op_type() in (OP_NOT_IN, OP_DOES_NOT_EXIST) and mine.op_type() in (
                    OP_NOT_IN,
                    OP_DOES_NOT_EXIST,
                ):
                    continue
                errs.append(f"{requirement} not in {mine}, key {key}")
        return errs

    def __str__(self) -> str:
        parts = []
        for key, vs in self._sets:
            parts.append(f"{key} {vs.op_type()} {vs}")
        return ", ".join(parts)


def _is_qualified_name(key: str) -> bool:
    return not lbl.check_qualified_name(key)


def _is_valid_label_value(value: str) -> bool:
    return not lbl.check_label_value(value)
