"""Fake cloud provider + synthetic catalogs — a first-class test deliverable
(reference: pkg/cloudprovider/fake).

``FakeCloudProvider.create`` records every NodeRequest and fabricates a ready
node from the *first* (cheapest, since the solver sorted) instance-type
option, choosing the first offering compatible with the request's
zone/capacity-type requirements (reference: fake/cloudprovider.go:52-90).
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Any, Dict, FrozenSet, List, Optional

from karpenter_tpu_torch.api import labels as lbl
from karpenter_tpu_torch.api.objects import Node, NodeSpec, NodeStatus, ObjectMeta
from karpenter_tpu_torch.cloudprovider.types import (
    CloudProvider,
    InstanceType,
    LiveInstance,
    NodeRequest,
    Offering,
)
from karpenter_tpu_torch.interruption.types import PREEMPTION, DisruptionNotice, NoticeQueue
from karpenter_tpu_torch.resilience.markers import idempotent
from karpenter_tpu_torch.utils import resources as res

_name_counter = itertools.count(1)

DEFAULT_ZONES = ["test-zone-1", "test-zone-2", "test-zone-3"]

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


def instance_types_assorted() -> List[InstanceType]:
    """Full cross product 7cpu×8mem×3zones×2ct×2os×2arch = 1,344 unique types
    — drives price-optimality tests (reference: fake/instancetype.go:79-110)."""
    out: List[InstanceType] = []
    for cpu in [1, 2, 4, 8, 16, 32, 64]:
        for mem in [1, 2, 4, 8, 16, 32, 64, 128]:
            for zone in DEFAULT_ZONES:
                for ct in [lbl.CAPACITY_TYPE_SPOT, lbl.CAPACITY_TYPE_ON_DEMAND]:
                    for os_ in ["linux", "windows"]:
                        for arch in [lbl.ARCH_AMD64, lbl.ARCH_ARM64]:
                            out.append(
                                new_instance_type(
                                    f"{cpu}-cpu-{mem}-mem-{arch}-{os_}-{zone}-{ct}",
                                    architecture=arch,
                                    operating_systems=frozenset({os_}),
                                    resources={
                                        res.CPU: float(cpu),
                                        res.MEMORY: res.parse_quantity(f"{mem}Gi"),
                                    },
                                    offerings=[Offering(ct, zone)],
                                )
                            )
    return out


def default_catalog() -> List[InstanceType]:
    """The fake provider's built-in catalog
    (reference: fake/cloudprovider.go:92-140)."""
    return [
        new_instance_type("default-instance-type"),
        new_instance_type("pod-eni-instance-type", resources={res.AWS_POD_ENI: 1.0}),
        new_instance_type(
            "small-instance-type",
            resources={res.CPU: 2.0, res.MEMORY: res.parse_quantity("2Gi")},
        ),
        new_instance_type("nvidia-gpu-instance-type", resources={res.NVIDIA_GPU: 2.0}),
        new_instance_type("amd-gpu-instance-type", resources={res.AMD_GPU: 2.0}),
        new_instance_type("aws-neuron-instance-type", resources={res.AWS_NEURON: 2.0}),
        new_instance_type(
            "arm-instance-type",
            architecture="arm64",
            operating_systems=frozenset({"ios", "linux", "windows", "darwin"}),
            resources={res.CPU: 16.0, res.MEMORY: res.parse_quantity("128Gi")},
        ),
    ]


class FakeCloudProvider(CloudProvider):
    def __init__(self, instance_types: Optional[List[InstanceType]] = None):
        self.instance_types: Optional[List[InstanceType]] = instance_types
        self.create_calls: List[NodeRequest] = []
        self.delete_calls: List[str] = []
        self.disruptions = NoticeQueue()
        self._mu = threading.Lock()
        # launch-token ledger: token -> the node that create returned, and
        # the live-instance inventory list_instances serves. Same token →
        # same node, never a second launch (the idempotent-create contract).
        self._token_nodes: Dict[str, Node] = {}  # guarded-by: self._mu
        self._instances: Dict[str, LiveInstance] = {}  # guarded-by: self._mu

    @idempotent
    def create(self, request: NodeRequest) -> Node:
        token = request.launch_token
        with self._mu:
            self.create_calls.append(request)
            if token and token in self._token_nodes:
                return self._token_nodes[token]
        name = f"fake-node-{next(_name_counter)}"
        instance = request.instance_type_options[0]
        zone = capacity_type = ""
        reqs = request.template.requirements
        for o in instance.offerings:
            if reqs.capacity_types() and o.capacity_type in reqs.capacity_types() and o.zone in reqs.zones():
                zone, capacity_type = o.zone, o.capacity_type
                break
        node = Node(
            metadata=ObjectMeta(
                name=name,
                namespace="",
                labels={
                    lbl.TOPOLOGY_ZONE: zone,
                    lbl.INSTANCE_TYPE: instance.name,
                    lbl.CAPACITY_TYPE: capacity_type,
                },
                annotations=(
                    {lbl.LAUNCH_TOKEN_ANNOTATION: token} if token else {}
                ),
            ),
            spec=NodeSpec(provider_id=f"fake:///{name}/{zone}"),
            status=NodeStatus(
                allocatable={
                    res.PODS: instance.resources.get(res.PODS, 0.0),
                    res.CPU: instance.resources.get(res.CPU, 0.0),
                    res.MEMORY: instance.resources.get(res.MEMORY, 0.0),
                },
                capacity=dict(instance.resources),
            ),
        )
        with self._mu:
            if token:
                # a racer with the same token committed first: ITS node is
                # the one the token names (this fabricated double is dropped)
                racer = self._token_nodes.get(token)
                if racer is not None:
                    return racer
                self._token_nodes[token] = node
            self._instances[name] = LiveInstance(
                id=name,
                launch_token=token,
                instance_type=instance.name,
                zone=zone,
                capacity_type=capacity_type,
                created_at=time.time(),
                provider_id=node.spec.provider_id,
            )
        return node

    @idempotent
    def delete(self, node: Node) -> None:
        with self._mu:
            self.delete_calls.append(node.metadata.name)
            live = self._instances.pop(node.metadata.name, None)
            if live is not None and live.launch_token:
                self._token_nodes.pop(live.launch_token, None)

    def list_instances(self) -> List[LiveInstance]:
        with self._mu:
            return list(self._instances.values())

    @idempotent
    def get_instance_types(self, provider: Optional[Dict[str, Any]] = None) -> List[InstanceType]:
        if self.instance_types is not None:
            return self.instance_types
        return default_catalog()

    # -- DisruptionSource ---------------------------------------------------
    def preempt(
        self,
        node_name: str,
        grace_period_seconds: float = 120.0,
        kind: str = PREEMPTION,
        reason: str = "",
    ) -> DisruptionNotice:
        """Test/bench fault injector: announce that this node's capacity
        will be reclaimed in ``grace_period_seconds``."""
        notice = DisruptionNotice(
            kind=kind,
            node_name=node_name,
            grace_period_seconds=grace_period_seconds,
            reason=reason,
        )
        self.disruptions.push(notice)
        return notice

    @idempotent
    def poll_disruptions(self) -> List[DisruptionNotice]:
        return self.disruptions.drain()

    def requeue_disruption(self, notice: DisruptionNotice) -> bool:
        self.disruptions.push(notice)
        return True

    def name(self) -> str:
        return "fake"
