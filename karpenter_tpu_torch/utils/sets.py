"""Complement-set algebra over string values.

A ``ValueSet`` is either a finite set of strings or the complement of one,
which gives a finite representation of the infinite sets produced by the
``NotIn`` / ``Exists`` node-selector operators.

Semantics follow the reference implementation
(``pkg/utils/sets/sets.go:31-157``): intersection covers all four polarity
cases, ``len()`` of a complement set counts down from a large sentinel, and
``op_type()`` maps a set back to the node-selector operator that would have
produced it.

The tensor encoding of these sets (bitmasks over an interned vocabulary with
an explicit "other" bucket standing in for the unenumerated universe) lives in
``karpenter_tpu_torch.solver.encode``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import FrozenSet, Iterable

# Operators (mirror v1.NodeSelectorOperator).
OP_IN = "In"
OP_NOT_IN = "NotIn"
OP_EXISTS = "Exists"
OP_DOES_NOT_EXIST = "DoesNotExist"
OP_GT = "Gt"
OP_LT = "Lt"

# Stand-in for the cardinality of the (infinite) universe; complement sets
# report len = INFINITE - n so that "empty" checks stay uniform
# (reference: sets.go:152-157 uses math.MaxInt64).
INFINITE = 1 << 62


@dataclass(frozen=True)
class ValueSet:
    """A finite string set or the complement of one."""

    values: FrozenSet[str] = field(default_factory=frozenset)
    complement: bool = False

    # -- constructors ------------------------------------------------------
    @staticmethod
    def of(*values: str) -> "ValueSet":
        return ValueSet(frozenset(values), False)

    @staticmethod
    def complement_of(*values: str) -> "ValueSet":
        return ValueSet(frozenset(values), True)

    @staticmethod
    def universe() -> "ValueSet":
        return ValueSet(frozenset(), True)

    @staticmethod
    def empty() -> "ValueSet":
        return ValueSet(frozenset(), False)

    # -- queries -----------------------------------------------------------
    def is_complement(self) -> bool:
        return self.complement

    def __len__(self) -> int:
        # NB: python's __len__ rejects values > sys.maxsize on some paths;
        # use .cardinality for arithmetic.
        return self.cardinality

    @property
    def cardinality(self) -> int:
        if self.complement:
            return INFINITE - len(self.values)
        return len(self.values)

    @property
    def is_empty(self) -> bool:
        return not self.complement and not self.values

    def op_type(self) -> str:
        """Map the set back to the node-selector operator that produces it
        (reference: sets.go:81-96)."""
        if self.complement:
            return OP_EXISTS if not self.values else OP_NOT_IN
        return OP_IN if self.values else OP_DOES_NOT_EXIST

    def has(self, value: str) -> bool:
        if self.complement:
            return value not in self.values
        return value in self.values

    def has_any(self, values: Iterable[str]) -> bool:
        """True if any of the supplied values are in the *underlying* finite
        set (reference HasAny ignores polarity — sets.go:120-123)."""
        return any(v in self.values for v in values)

    def contains_any(self, values: Iterable[str]) -> bool:
        """True if any supplied value is a member, honoring polarity."""
        return any(self.has(v) for v in values)

    # -- algebra -----------------------------------------------------------
    def intersection(self, other: "ValueSet") -> "ValueSet":
        """All four polarity cases (reference: sets.go:133-151)."""
        if self.complement:
            if other.complement:
                return ValueSet(self.values | other.values, True)
            return ValueSet(other.values - self.values, False)
        if other.complement:
            return ValueSet(self.values - other.values, False)
        return ValueSet(self.values & other.values, False)

    def finite_values(self) -> FrozenSet[str]:
        if self.complement:
            raise ValueError("infinite set")
        return self.values

    def complement_values(self) -> FrozenSet[str]:
        if not self.complement:
            raise ValueError("not a complement set")
        return self.values

    def __str__(self) -> str:
        vals = sorted(self.values)
        return f"{vals}'" if self.complement else f"{vals}"


def set_for_operator(operator: str, values: Iterable[str] = ()) -> ValueSet:
    """Build the ValueSet for a node-selector requirement
    (reference: requirements.go:96-105)."""
    values = tuple(values)
    if operator == OP_IN:
        return ValueSet.of(*values)
    if operator == OP_NOT_IN:
        return ValueSet.complement_of(*values)
    if operator == OP_EXISTS:
        return ValueSet.universe()
    if operator == OP_DOES_NOT_EXIST:
        return ValueSet.empty()
    raise ValueError(f"unsupported operator {operator}")
