"""Synthetic instance-type catalogs (reference: pkg/cloudprovider/fake).

Only the catalog constructors live here (the linear benchmark catalog and
the anti-correlated tradeoff catalog); the fake provider's create/delete
surface is not on the solve path.
"""

from __future__ import annotations

from typing import Dict, FrozenSet, List, Optional

from karpenter_tpu_torch.cloudprovider.types import InstanceType, Offering
from karpenter_tpu_torch.utils import resources as res

DEFAULT_OFFERINGS = [
    Offering("spot", "test-zone-1"),
    Offering("spot", "test-zone-2"),
    Offering("on-demand", "test-zone-1"),
    Offering("on-demand", "test-zone-2"),
    Offering("on-demand", "test-zone-3"),
]


def new_instance_type(
    name: str,
    offerings: Optional[List[Offering]] = None,
    architecture: str = "amd64",
    operating_systems: FrozenSet[str] = frozenset({"linux", "windows", "darwin"}),
    resources: Optional[Dict[str, float]] = None,
    overhead: Optional[Dict[str, float]] = None,
    price: Optional[float] = None,
) -> InstanceType:
    """Parameterizable fake type with the reference's defaults
    (reference: fake/instancetype.go:32-76): 4 cpu / 4Gi / 5 pods,
    100m+10Mi overhead, 5 offerings over 3 zones."""
    resources = dict(resources or {})
    resources.setdefault(res.CPU, 4.0)
    resources.setdefault(res.MEMORY, res.parse_quantity("4Gi"))
    resources.setdefault(res.PODS, 5.0)
    return InstanceType(
        name=name,
        offerings=list(offerings) if offerings else list(DEFAULT_OFFERINGS),
        architecture=architecture,
        operating_systems=operating_systems,
        resources=resources,
        overhead=dict(overhead) if overhead is not None else {res.CPU: 0.1, res.MEMORY: res.parse_quantity("10Mi")},
        price=price,
    )


def instance_types(total: int) -> List[InstanceType]:
    """n types with linearly scaling cpu/mem/pods — the benchmark catalog
    (reference: fake/instancetype.go:117-130)."""
    return [
        new_instance_type(
            f"fake-it-{i}",
            resources={
                res.CPU: float(i + 1),
                res.MEMORY: res.parse_quantity(f"{(i + 1) * 2}Gi"),
                res.PODS: float((i + 1) * 10),
            },
        )
        for i in range(total)
    ]


def instance_types_tradeoff(total: int) -> List[InstanceType]:
    """n types with ANTI-correlated cpu/mem (cpu-heavy ↔ mem-heavy ends of
    the range): every type is Pareto-optimal, so the encoded capacity
    frontier is ``total`` wide. The linear/assorted catalogs are
    Pareto-degenerate (F=1 — each type dominates the previous), which never
    exercises the solver's multi-frontier (v2) region."""
    return [
        new_instance_type(
            f"trade-it-{i}",
            resources={
                res.CPU: float(2 + i),
                res.MEMORY: res.parse_quantity(f"{2 * (total - i)}Gi"),
                res.PODS: 110.0,
            },
        )
        for i in range(total)
    ]
