"""Simulated GKE provider: TPU podslice node pools.

A second vendor implementation beside the AWS-architecture simulated
provider (``simulated.py``), built to the same standard: a programmable
in-process cloud API double (``SimGkeAPI`` — node-pool create/delete with
stockout injection and error classification), an insufficient-capacity
cache that removes stocked-out offerings from the catalog for 45s
(reference: aws/instancetypes.go:41,185-198 and the create-path stockout
classification aws/instance.go:300-309), and **multi-host TPU podslices**:
one podslice = N nodes sharing ``cloud.google.com/gke-tpu-topology`` and a
node-pool name, launched atomically — the actual hard TPU provisioning
problem on GKE.

Scheduling integration: pods requesting ``google.com/tpu`` with a
``gke-tpu-topology`` nodeSelector are routed to slice shapes through the
vendor-declared type labels (``InstanceType.labels`` participates in
requirement compatibility), flowing the extended resource and the topology
constraint through the whole solve stack (encode extra axes, signature
frontiers, kernels, oracle).

GKE naming sources are the public machine families (e2/n2/c3) and TPU
podslice machine types (ct5lp-hightpu-{1,4,8}t); multi-host slice shapes
are distinct catalog entries named ``<machine>-<topology>`` whose resources
are PER-HOST (each host contributes its chips), since the framework's
catalog is keyed by instance-type name.
"""

from __future__ import annotations

import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from karpenter_tpu_torch.api import labels as lbl
from karpenter_tpu_torch.api.objects import Node, NodeSpec, NodeStatus, ObjectMeta, PodCondition
from karpenter_tpu_torch.api.provisioner import Constraints
from karpenter_tpu_torch.cloudprovider.types import (
    CloudProvider,
    InstanceType,
    LiveInstance,
    NodeRequest,
    Offering,
)
from karpenter_tpu_torch.interruption.types import DisruptionNotice, NoticeQueue
from karpenter_tpu_torch.resilience.markers import idempotent
from karpenter_tpu_torch.utils import resources as res
from karpenter_tpu_torch.utils.ttlcache import TTLCache

TPU_RESOURCE = "google.com/tpu"
GKE_TPU_ACCELERATOR_LABEL = "cloud.google.com/gke-tpu-accelerator"
GKE_TPU_TOPOLOGY_LABEL = "cloud.google.com/gke-tpu-topology"
GKE_NODEPOOL_LABEL = "cloud.google.com/gke-nodepool"

ZONES = ("us-central2-a", "us-central2-b", "us-central2-c")
CAPACITY_TYPES = ("on-demand", "spot")

# stocked-out (type, zone, capacity-type) offerings sit out of the catalog
# for this long (reference: aws/instancetypes.go:41 — the ICE cache TTL)
UNAVAILABLE_OFFERINGS_TTL = 45.0

_GIB = 1024 ** 3


# v5e podslice topology by chips-per-host — single-host shapes
TPU_TOPOLOGY_BY_CHIPS = {1: "1x1", 4: "2x2", 8: "2x4"}

# multi-host podslice shapes: topology -> (hosts, chips per host). One
# podslice of topology "4x4" is 4 ct5lp-hightpu-4t hosts with 4 chips each.
MULTI_HOST_TOPOLOGIES = {
    "4x4": (4, 4),
    "4x8": (8, 4),
    "8x8": (16, 4),
}


class GkeStockoutError(Exception):
    """ZONAL_RESOURCE_POOL_EXHAUSTED / GCE_STOCKOUT — the offering has no
    capacity right now (classified like the reference classifies EC2's
    InsufficientInstanceCapacity, aws/instance.go:300-309)."""


class GkeApiError(Exception):
    """Any other node-pool API failure (quota, permission, malformed)."""


@dataclass
class GkeInstance:
    name: str
    machine_type: str
    zone: str
    spot: bool
    node_pool: str
    # the launch token of the create() call this host was handed to (the
    # GCE label analog): pool creation stamps the first host; pending
    # multi-host siblings are stamped as later creates claim them
    launch_token: str = ""
    created_at: float = 0.0


@dataclass
class GkeNodePool:
    name: str
    machine_type: str
    zone: str
    spot: bool
    count: int
    tpu_topology: str = ""
    instances: List[GkeInstance] = field(default_factory=list)


class SimGkeAPI:
    """Programmable in-process double of the GKE node-pool surface —
    ``SimCloudAPI``'s sibling. Tests inject stockouts per (machine type,
    zone[, capacity type]) and inspect recorded calls."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counter = itertools.count(1)
        self.node_pools: Dict[str, GkeNodePool] = {}
        self.create_calls: List[GkeNodePool] = []
        self.delete_calls: List[str] = []
        self._stockouts: set = set()
        # launch-token ledger: token -> pool name. A retried
        # create_node_pool with a committed token replays the recorded pool
        # instead of launching a second (possibly multi-host TPU) one.
        self._token_pools: Dict[str, str] = {}  # guarded-by: self._lock
        # the disruption-event bus: GCE preemption / maintenance notices
        # tests inject and the interruption controller polls
        self.disruptions = NoticeQueue()

    # -- fault injection ---------------------------------------------------
    def set_stockout(self, machine_type: str, zone: str, capacity_type: Optional[str] = None):
        """Future creates of this offering raise GkeStockoutError; a None
        capacity type stocks out both."""
        with self._lock:
            for ct in (capacity_type,) if capacity_type else CAPACITY_TYPES:
                self._stockouts.add((machine_type, zone, ct))

    def clear_stockout(self, machine_type: str, zone: str, capacity_type: Optional[str] = None):
        with self._lock:
            for ct in (capacity_type,) if capacity_type else CAPACITY_TYPES:
                self._stockouts.discard((machine_type, zone, ct))

    # -- API surface -------------------------------------------------------
    def create_node_pool(
        self,
        machine_type: str,
        zone: str,
        spot: bool,
        count: int,
        tpu_topology: str = "",
        launch_token: str = "",
    ) -> GkeNodePool:
        """Create a node pool of ``count`` instances ATOMICALLY: a stockout
        yields zero instances, never a partial podslice (a partial slice is
        useless to a multi-host workload). A ``launch_token`` the control
        plane already committed replays the recorded pool — a transport
        retry after a lost response cannot launch a second slice."""
        if count < 1:
            raise GkeApiError(f"node pool count must be >= 1, got {count}")
        ct = "spot" if spot else "on-demand"
        with self._lock:
            if launch_token:
                committed = self._token_pools.get(launch_token)
                if committed is not None and committed in self.node_pools:
                    return self.node_pools[committed]
            if (machine_type, zone, ct) in self._stockouts:
                raise GkeStockoutError(
                    f"ZONAL_RESOURCE_POOL_EXHAUSTED: {machine_type} in {zone} ({ct})"
                )
            n = next(self._counter)
            now = time.time()
            pool = GkeNodePool(
                name=f"np-{machine_type}-{n}",
                machine_type=machine_type,
                zone=zone,
                spot=spot,
                count=count,
                tpu_topology=tpu_topology,
            )
            pool.instances = [
                GkeInstance(
                    name=f"gke-{pool.name}-{i}",
                    machine_type=machine_type,
                    zone=zone,
                    spot=spot,
                    node_pool=pool.name,
                    # the creating call is handed host 0; pending siblings
                    # stay token-less until claim_instance stamps them
                    launch_token=launch_token if i == 0 else "",
                    created_at=now,
                )
                for i in range(count)
            ]
            self.node_pools[pool.name] = pool
            self.create_calls.append(pool)
            if launch_token:
                self._token_pools[launch_token] = pool.name
            return pool

    def claim_instance(self, name: str, launch_token: str) -> None:
        """Stamp the claiming create's token onto a pending multi-host
        sibling — each host of a slice carries the token of the create()
        that returned it, so crash recovery can re-find ANY host by its
        journal entry's token."""
        with self._lock:
            for pool in self.node_pools.values():
                for inst in pool.instances:
                    if inst.name == name:
                        inst.launch_token = launch_token
                        return

    def list_instances(self) -> List[GkeInstance]:
        """Full inventory across pools — the GC/recovery sweep surface."""
        with self._lock:
            return [
                inst
                for pool in self.node_pools.values()
                for inst in pool.instances
            ]

    def delete_node_pool(self, name: str) -> None:
        with self._lock:
            self.delete_calls.append(name)
            self.node_pools.pop(name, None)

    def delete_instance(self, name: str) -> None:
        """Remove one instance; an emptied pool is reaped."""
        with self._lock:
            self.delete_calls.append(name)
            for pool_name, pool in list(self.node_pools.items()):
                pool.instances = [i for i in pool.instances if i.name != name]
                if not pool.instances:
                    self.node_pools.pop(pool_name, None)

    def send_disruption_notice(self, notice: DisruptionNotice) -> None:
        """Fault injector: announce a preemption/maintenance event for one
        instance (node names equal instance names here)."""
        self.disruptions.push(notice)

    def poll_disruptions(self) -> List[DisruptionNotice]:
        return self.disruptions.drain()


def _machine(name: str, cpu: float, mem_gib: float, price: float,
             tpu_chips: int = 0, tpu_topology: str = "") -> InstanceType:
    resources: Dict[str, float] = {
        res.CPU: cpu,
        res.MEMORY: mem_gib * _GIB,
        res.PODS: 110.0,
    }
    labels: Dict[str, str] = {}
    if tpu_chips:
        resources[TPU_RESOURCE] = float(tpu_chips)
        labels[GKE_TPU_ACCELERATOR_LABEL] = "tpu-v5-lite-podslice"
        labels[GKE_TPU_TOPOLOGY_LABEL] = (
            tpu_topology or TPU_TOPOLOGY_BY_CHIPS.get(tpu_chips, f"1x{tpu_chips}")
        )
    return InstanceType(
        name=name,
        offerings=[
            Offering(capacity_type=ct, zone=z)
            for ct, z in itertools.product(CAPACITY_TYPES, ZONES)
        ],
        architecture="amd64",
        operating_systems=frozenset({"linux"}),
        resources=resources,
        # GKE-style system reserve: flat kubelet/OS slice of the machine
        overhead={res.CPU: min(0.25, cpu * 0.06), res.MEMORY: 0.5 * _GIB},
        price=price,
        labels=labels,
    )


def gke_catalog() -> List[InstanceType]:
    """General-purpose machine families, single-host TPU v5e podslice
    shapes, and multi-host podslice shapes (per-host resources; the
    provider launches ``hosts`` nodes atomically)."""
    catalog: List[InstanceType] = []
    for family, per_cpu_mem, base in (("e2", 4, 0.031), ("n2", 4, 0.048), ("c3", 4, 0.056)):
        for cpus in (2, 4, 8, 16, 32, 48):
            catalog.append(
                _machine(
                    f"{family}-standard-{cpus}", cpus, cpus * per_cpu_mem,
                    price=round(base * cpus, 4),
                )
            )
    # TPU v5e podslice host shapes (topology derives from chip count)
    for name, cpus, mem, chips, price in (
        ("ct5lp-hightpu-1t", 24, 48, 1, 1.2),
        ("ct5lp-hightpu-4t", 112, 192, 4, 4.8),
        ("ct5lp-hightpu-8t", 224, 384, 8, 9.6),
    ):
        catalog.append(_machine(name, cpus, mem, price, tpu_chips=chips))
    # multi-host podslices: one catalog entry per slice topology; the price
    # is per HOST (the whole slice costs hosts x price)
    for topology, (hosts, chips) in MULTI_HOST_TOPOLOGIES.items():
        catalog.append(
            _machine(
                f"ct5lp-hightpu-4t-{topology}", 112, 192, 4.8,
                tpu_chips=chips, tpu_topology=topology,
            )
        )
    return catalog


def slice_hosts(instance_type_name: str) -> int:
    """How many hosts one podslice of this type spans (1 = single-host)."""
    for topology, (hosts, _) in MULTI_HOST_TOPOLOGIES.items():
        if instance_type_name.endswith(f"-{topology}"):
            return hosts
    return 1


class GkeCloudProvider(CloudProvider):
    """GKE vendor layer against ``SimGkeAPI``: offering selection with ICE
    fallback, atomic multi-host slice launches, node materialization with
    the GKE TPU labels, and the webhook defaulting/validation hooks."""

    def __init__(
        self,
        catalog: Optional[List[InstanceType]] = None,
        api: Optional[SimGkeAPI] = None,
        clock=None,
    ):
        self._catalog = catalog or gke_catalog()
        self.api = api or SimGkeAPI()
        self._lock = threading.Lock()
        self.create_calls: List[NodeRequest] = []
        self.delete_calls: List[str] = []
        # stocked-out offerings sit out of the catalog for 45s
        self._unavailable = TTLCache(UNAVAILABLE_OFFERINGS_TTL, clock=clock)
        # multi-host slices already launched whose remaining hosts are
        # waiting to be claimed by subsequent create() calls
        self._pending_hosts: Dict[Tuple[str, str, str], List[Node]] = {}
        # launch-token replay: token -> the node this provider's create
        # already returned for it. Covers the pending-host claim path the
        # API-level pool ledger cannot see (a claim consumes no API call).
        self._token_nodes: Dict[str, Node] = {}  # guarded-by: self._lock

    # -- catalog -----------------------------------------------------------
    @idempotent
    def get_instance_types(self, provider: Optional[Dict[str, Any]] = None) -> List[InstanceType]:
        """The catalog minus offerings in the unavailable (ICE) cache —
        reference: aws/instancetypes.go:185-198."""
        out: List[InstanceType] = []
        for it in self._catalog:
            offerings = [
                o for o in it.offerings
                if self._unavailable.get((it.name, o.zone, o.capacity_type)) is None
            ]
            if not offerings:
                continue
            if len(offerings) == len(it.offerings):
                out.append(it)
            else:
                out.append(
                    InstanceType(
                        name=it.name,
                        offerings=offerings,
                        architecture=it.architecture,
                        operating_systems=it.operating_systems,
                        resources=dict(it.resources),
                        overhead=dict(it.overhead),
                        price=it.price,
                        labels=dict(it.labels),
                    )
                )
        return out

    # -- launch ------------------------------------------------------------
    @idempotent
    def create(self, request: NodeRequest) -> Node:
        # idempotent BY TOKEN: a token this provider (or the node-pool API)
        # already committed returns the SAME node — a retried create after
        # a timed-out first attempt yields exactly one host, never two
        token = request.launch_token
        with self._lock:
            self.create_calls.append(request)
            if token and token in self._token_nodes:
                return self._token_nodes[token]
        if not request.instance_type_options:
            raise ValueError("no instance type options")
        reqs = request.template.requirements
        last_err: Optional[Exception] = None
        ice_skipped = False
        # options are price-sorted by the solver; within a type, try each
        # allowed offering, falling through stockouts to the next zone and
        # then to the next (pricier) type — the reference's ICE fallback
        for it in request.instance_type_options:
            hosts = slice_hosts(it.name)
            for o in it.offerings:
                if reqs.has(lbl.TOPOLOGY_ZONE) and not reqs.get(lbl.TOPOLOGY_ZONE).has(o.zone):
                    continue
                if reqs.has(lbl.CAPACITY_TYPE) and not reqs.get(lbl.CAPACITY_TYPE).has(o.capacity_type):
                    continue
                key = (it.name, o.zone, o.capacity_type)
                if self._unavailable.get(key) is not None:
                    ice_skipped = True
                    continue
                # one critical section from pending-check through pool
                # creation to the pending store: provision_once launches
                # vnodes from a thread pool, and two concurrent creates of
                # the same slice key must not both create a pool (duplicate
                # pools + the second store would orphan the first's
                # unclaimed hosts, breaking the atomic-slice invariant)
                with self._lock:
                    pending = self._pending_hosts.get(key)
                    if pending:
                        node = pending.pop(0)
                        if not pending:
                            del self._pending_hosts[key]
                        self._stamp_token_locked(node, token)
                        return node
                    try:
                        pool = self.api.create_node_pool(
                            machine_type=it.name,
                            zone=o.zone,
                            spot=o.capacity_type == "spot",
                            count=hosts,
                            tpu_topology=it.labels.get(GKE_TPU_TOPOLOGY_LABEL, ""),
                            launch_token=token,
                        )
                    except GkeStockoutError as e:
                        # classified capacity error: cache the offering out
                        # for the ICE TTL, fall through to the next offering
                        self._unavailable.set(key, True)
                        last_err = e
                        continue
                    nodes = [self._node(it, o, inst) for inst in pool.instances]
                    first = nodes.pop(0)
                    if nodes:
                        self._pending_hosts[key] = nodes
                    self._stamp_token_locked(first, token, claim=False)
                    return first
        if last_err is not None:
            raise last_err
        if ice_skipped:
            # every candidate offering is sitting out its ICE TTL — this is
            # a (transient) capacity condition, not a requirements bug
            raise GkeStockoutError(
                "all candidate offerings are capacity-constrained (ICE-cached)"
            )
        raise ValueError(
            "no offering satisfies the request's zone/capacity-type requirements"
        )

    def _stamp_token_locked(self, node: Node, token: str, claim: bool = True) -> None:
        """Pair ``node`` with the claiming create's token: annotation on the
        Node, entry in the replay cache, and (for a pending-host claim) the
        tag on the cloud instance itself so ``list_instances`` reports it.
        Caller holds ``self._lock``."""
        if not token:
            return
        node.metadata.annotations[lbl.LAUNCH_TOKEN_ANNOTATION] = token
        self._token_nodes[token] = node
        while len(self._token_nodes) > 4096:  # bound the long-lived ledger
            self._token_nodes.pop(next(iter(self._token_nodes)))
        if claim:
            claimer = getattr(self.api, "claim_instance", None)
            if claimer is not None:
                claimer(node.metadata.name, token)

    def list_instances(self) -> List[LiveInstance]:
        """Live inventory for the GC/adoption cross-check. Hosts still
        PENDING (launched as part of a slice, not yet claimed by a create)
        carry no token — the GC grace period is what protects them while
        their siblings' creates are in flight."""
        lister = getattr(self.api, "list_instances", None)
        if lister is None:
            return NotImplemented
        out: List[LiveInstance] = []
        for inst in lister():
            out.append(
                LiveInstance(
                    id=inst.name,
                    launch_token=inst.launch_token,
                    instance_type=inst.machine_type,
                    zone=inst.zone,
                    capacity_type="spot" if inst.spot else "on-demand",
                    created_at=inst.created_at,
                    provider_id=f"gce://sim-project/{inst.zone}/{inst.name}",
                    labels={GKE_NODEPOOL_LABEL: inst.node_pool},
                )
            )
        return out

    def _node(self, it: InstanceType, offering: Offering, inst: GkeInstance) -> Node:
        labels = {
            lbl.INSTANCE_TYPE: it.name,
            lbl.TOPOLOGY_ZONE: offering.zone,
            lbl.CAPACITY_TYPE: offering.capacity_type,
            lbl.ARCH: it.architecture,
            lbl.OS: "linux",
            GKE_NODEPOOL_LABEL: inst.node_pool,
        }
        labels.update(it.labels)  # accelerator + topology for TPU shapes
        # derived at label time so ANY catalog (custom, serde round-tripped,
        # labels-free) still yields correctly-labeled TPU nodes
        chips = int(it.resources.get(TPU_RESOURCE, 0))
        if chips:
            labels.setdefault(GKE_TPU_ACCELERATOR_LABEL, "tpu-v5-lite-podslice")
            labels.setdefault(
                GKE_TPU_TOPOLOGY_LABEL,
                TPU_TOPOLOGY_BY_CHIPS.get(chips, f"1x{chips}"),
            )
        allocatable = {k: v - it.overhead.get(k, 0.0) for k, v in it.resources.items()}
        return Node(
            metadata=ObjectMeta(name=inst.name, namespace="", labels=labels),
            spec=NodeSpec(
                provider_id=f"gce://sim-project/{offering.zone}/{inst.name}"
            ),
            status=NodeStatus(
                capacity=dict(it.resources),
                allocatable=allocatable,
                conditions=[PodCondition(type="Ready", status="True")],
            ),
        )

    @idempotent
    def delete(self, node: Node) -> None:
        pool = node.metadata.labels.get(GKE_NODEPOOL_LABEL)
        purged: List[Node] = []
        with self._lock:
            self.delete_calls.append(node.metadata.name)
            # a deleted node's token must not replay a dead instance
            token = node.metadata.annotations.get(lbl.LAUNCH_TOKEN_ANNOTATION)
            if token:
                self._token_nodes.pop(token, None)
            if pool:
                # a multi-host slice is dying: its unclaimed pending hosts
                # must die with it — handing a stale sibling out later would
                # pair a "fresh" node with hosts scaled down long ago
                for key, nodes in list(self._pending_hosts.items()):
                    keep = [
                        n for n in nodes
                        if n.metadata.labels.get(GKE_NODEPOOL_LABEL) != pool
                    ]
                    if len(keep) != len(nodes):
                        purged += [n for n in nodes if n not in keep]
                        if keep:
                            self._pending_hosts[key] = keep
                        else:
                            del self._pending_hosts[key]
        self.api.delete_instance(node.metadata.name)
        for n in purged:
            self.api.delete_instance(n.metadata.name)

    # -- webhook hooks -----------------------------------------------------
    def default(self, constraints: Constraints) -> None:
        """Default capacity type to on-demand (GKE: no spot unless asked),
        like the reference's vendor defaulting (provider_defaults.go:26-56)."""
        from karpenter_tpu_torch.api.objects import NodeSelectorRequirement

        if not constraints.requirements.has(lbl.CAPACITY_TYPE):
            constraints.requirements = constraints.requirements.add(
                NodeSelectorRequirement(
                    key=lbl.CAPACITY_TYPE, operator="In", values=["on-demand"]
                )
            )

    def validate(self, constraints: Constraints) -> List[str]:
        errs: List[str] = []
        provider = constraints.provider or {}
        for key in provider:
            if key not in ("project", "network", "subnetwork", "serviceAccount", "tags"):
                errs.append(f"unknown GKE provider field {key!r}")
        return errs

    @idempotent
    def poll_disruptions(self) -> List[DisruptionNotice]:
        """DisruptionSource: drain the node-pool API's event bus (the same
        call works over the wire via ``HttpGkeAPI``)."""
        return self.api.poll_disruptions()

    def requeue_disruption(self, notice: DisruptionNotice) -> bool:
        """Fleet routing: re-offer a wrong-replica notice to the event bus
        (in-process via the double's injector, over the wire via POST
        /gke/v1/events/requeue)."""
        sender = getattr(self.api, "send_disruption_notice", None)
        if sender is None:
            return False
        sender(notice)
        return True

    def name(self) -> str:
        return "gke"
