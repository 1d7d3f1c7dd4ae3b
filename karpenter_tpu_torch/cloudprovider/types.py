"""Cloud-provider abstraction.

Mirrors ``pkg/cloudprovider/types.go``: ``CloudProvider`` {create, delete,
get_instance_types, default, validate, name}, the ``InstanceType`` catalog
record {name, offerings, architecture, operating_systems, resources, overhead,
price}, and ``NodeRequest`` {template (constraints), instance-type options}.
"""

from __future__ import annotations

import abc
from dataclasses import dataclass, field
from typing import Any, Dict, FrozenSet, List, Optional, Sequence

from karpenter_tpu_torch.api.objects import Node
from karpenter_tpu_torch.api.provisioner import Constraints
from karpenter_tpu_torch.utils import resources as res


@dataclass(frozen=True)
class Offering:
    """A purchasable (capacity type, zone) combination
    (reference: types.go:76-81)."""

    capacity_type: str
    zone: str


@dataclass
class InstanceType:
    """One catalog entry (reference: types.go:60-74). ``resources`` is the
    node's allocatable; ``overhead`` the kubelet/system reserve subtracted
    from it before pods fit; ``price`` the optimization weight."""

    name: str
    offerings: List[Offering] = field(default_factory=list)
    architecture: str = "amd64"
    operating_systems: FrozenSet[str] = frozenset({"linux"})
    resources: Dict[str, float] = field(default_factory=dict)
    overhead: Dict[str, float] = field(default_factory=dict)
    price: Optional[float] = None
    # vendor-declared node labels that participate in requirement
    # compatibility (e.g. GKE's cloud.google.com/gke-tpu-topology): a
    # requirement on a declared key must accept the type's value
    labels: Dict[str, str] = field(default_factory=dict)

    def effective_price(self) -> float:
        """Explicit price, else the cpu+mem+gpu formula the fake catalog uses
        (reference: fake/instancetype.go:146-163)."""
        if self.price is not None and self.price != 0:
            return self.price
        price = 0.0
        price += 0.1 * self.resources.get(res.CPU, 0.0)
        price += 0.1 * self.resources.get(res.MEMORY, 0.0) / 1e9
        if self.resources.get(res.NVIDIA_GPU, 0.0) or self.resources.get(res.AMD_GPU, 0.0):
            price += 1.0
        return price

    def zones(self) -> FrozenSet[str]:
        return frozenset(o.zone for o in self.offerings)

    def capacity_types(self) -> FrozenSet[str]:
        return frozenset(o.capacity_type for o in self.offerings)


@dataclass
class NodeRequest:
    """What the provisioner asks the cloud for (reference: types.go:53-56).

    ``launch_token`` is the client-side idempotency token (the CreateFleet
    ClientToken contract, aws/instance.go:120): the provider stamps it on
    the launched instance as a label/tag, and a second ``create`` carrying
    the SAME token returns the SAME instance instead of launching twice —
    which is what lets the retry policy cover ``create`` and lets crash
    recovery (launch/journal.py) re-find an instance whose launching
    process died before the Node object was written."""

    template: Constraints
    instance_type_options: Sequence[InstanceType] = ()
    launch_token: str = ""


@dataclass
class LiveInstance:
    """One live machine as the cloud control plane reports it — the
    ``list_instances`` record the launch journal's recovery and the
    garbage-collection controller cross-check against Node objects.
    ``launch_token`` is the client token the launching ``create`` stamped
    (empty for instances launched out-of-band or by pre-token builds);
    ``created_at`` is provider-clock seconds (``time.time`` domain) so the
    GC grace period can spare instances still mid-registration."""

    id: str
    launch_token: str = ""
    instance_type: str = ""
    zone: str = ""
    capacity_type: str = ""
    created_at: float = 0.0
    provider_id: str = ""
    labels: Dict[str, str] = field(default_factory=dict)


class CloudProvider(abc.ABC):
    """Vendor interface (reference: types.go:34-51)."""

    @abc.abstractmethod
    def create(self, request: NodeRequest) -> Node:
        """Launch a node satisfying the request; returns the created node
        (with instance-type/zone/capacity-type labels and allocatable set)."""

    @abc.abstractmethod
    def delete(self, node: Node) -> None:
        """Terminate the backing instance."""

    @abc.abstractmethod
    def get_instance_types(self, provider: Optional[Dict[str, Any]] = None) -> List[InstanceType]:
        """The current catalog for a vendor provider config."""

    def default(self, constraints: Constraints) -> None:
        """Vendor defaulting hook (webhook DefaultHook)."""

    def validate(self, constraints: Constraints) -> List[str]:
        """Vendor validation hook (webhook ValidateHook)."""
        return []

    def poll_disruptions(self) -> List:
        """The ``DisruptionSource`` protocol (karpenter_tpu/interruption):
        return-and-clear the notices that arrived since the last poll.
        Default: this vendor has no disruption stream."""
        return []

    def requeue_disruption(self, notice) -> bool:
        """Hand a drained disruption notice BACK to the stream — the fleet
        routing hook: a sharded controller replica that polls a notice for
        a node whose shard it does not own re-offers it so the owner's poll
        picks it up (real queues get this via visibility timeouts; doubles
        push back onto their in-memory queue). Returns False when this
        vendor cannot requeue — the caller then handles the notice locally
        (availability over strict sharding)."""
        return False

    def list_instances(self):
        """Inventory for the crash-consistency cross-check: every live
        instance this vendor is running, as :class:`LiveInstance` records
        carrying the launch token stamped at create. The launch journal's
        recovery re-describes unresolved tokens against this list, and the
        garbage-collection controller compares it against Node objects to
        adopt journaled orphans and terminate unjournaled leaks. Returns
        ``NotImplemented`` when this vendor has no list surface (the GC
        controller then opts the provider out of orphan sweeps)."""
        return NotImplemented

    def instance_gone(self, node: Node):
        """Liveness probe for the instance backing ``node``: True when the
        cloud has confirmed it is gone (terminated state, a typed NotFound,
        or enough consecutive describe misses to rule out a flaky
        response), False when it is alive, None when the probe itself
        failed this time (unknown — the consumer keeps its cadence), and
        ``NotImplemented`` when this vendor has no describe surface at all
        (the consumer opts the node out of liveness probing). One missing
        id in one flaky describe must NOT answer True — see
        resilience.MissTracker."""
        return NotImplemented

    def name(self) -> str:
        return type(self).__name__.lower()
