"""Simulated vendor cloud provider — the deep vendor layer.

The port's copy of ``karpenter_tpu/cloudprovider/simulated.py``: the same
catalog, overhead model, launch templates (names and user data byte-equal,
since they hash the same JSON), capacity pools, client-token ledger and
disruption bus, so a launch through either package's double gives the same
Node. It rebuilds the reference's AWS provider (``pkg/cloudprovider/aws``)
against ``SimCloudAPI``: a programmable cloud control-plane double with
capacity pools and error injection (the analog of ``aws/fake/ec2api.go``).
The warm-pool tests and the forecast storm run on it, because its
``create_fleet`` can pay a launch latency (``launch_latency_s``).

Component map (reference file → here):
- aws/cloudprovider.go:53-188   → SimulatedCloudProvider
- aws/instance.go:72-368        → InstanceProvider
- aws/instancetypes.go:40-198   → InstanceTypeProvider + UnavailableOfferings
- aws/instancetype.go:119-238   → SimInstanceType (resources + overhead model)
- aws/launchtemplate.go:74-274  → LaunchTemplateProvider
- aws/subnets.go, securitygroups.go → SubnetProvider / SecurityGroupProvider
- aws/apis/v1alpha1/provider*.go → SimProviderConfig (+defaults/validation)
- aws/fake/ec2api.go            → SimCloudAPI

Callers hold the ``SimCloudAPI`` in process, or reach it over HTTP through
``cloudprovider/httpapi.py`` (``HttpCloudAPI`` is a drop-in ``api``).
"""

from __future__ import annotations

import hashlib
import itertools
import json
import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

from karpenter_tpu_torch.api import labels as lbl
from karpenter_tpu_torch.api.objects import (
    Node,
    NodeSelectorRequirement,
    NodeSpec,
    NodeStatus,
    ObjectMeta,
)
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
from karpenter_tpu_torch.utils.workqueue import TokenBucket

logger = logging.getLogger("karpenter.simulated")

# reference: aws/cloudprovider.go:47-57
CACHE_TTL = 60.0
INSTANCE_TYPES_TTL = 300.0
UNAVAILABLE_OFFERINGS_TTL = 45.0  # reference: aws/instancetypes.go:41
MAX_INSTANCE_TYPES = 20  # reference: aws/cloudprovider.go:57

# fleet-call budget (reference: aws/instance.go:43-49)
CREATE_FLEET_QPS = 2.0
CREATE_FLEET_BURST = 100

# DescribeInstances is eventually consistent after a fleet launch
# (reference: aws/instance.go:84-91 retries 6x)
DESCRIBE_RETRIES = 6

# Consecutive describe responses an instance id must be missing from before
# the node-liveness consumer may declare it gone — describe_instances drops
# unknown ids silently, so one chaotic response must not orphan a node
LIVENESS_MISS_THRESHOLD = 3

DEFAULT_IMAGE_FAMILY = "standard"
DEFAULT_SELECTOR = {"purpose": "nodes"}
IMAGE_FAMILIES = ("standard", "minimal", "gpu")


class InsufficientCapacityError(Exception):
    """The fleet request could not be satisfied for any override.

    ``overrides`` carries the (capacity_type, instance_type, zone) triples
    that errored, so the caller's ICE cache can mark exactly the exhausted
    pools — an all-ICE fleet answer is a typed capacity condition, not an
    empty result indistinguishable from an empty-override bug."""

    def __init__(self, message: str, overrides: Sequence[Tuple[str, str, str]] = ()):
        super().__init__(message)
        self.overrides = list(overrides)


class CloudAPIError(Exception):
    """Injected control-plane failure."""


class InstanceNotFoundError(CloudAPIError):
    """Typed NotFound: the control plane positively confirmed it has no
    record of the instance (as opposed to dropping the id from one flaky
    describe response)."""


# ---------------------------------------------------------------------------
# The programmable control-plane double (reference: aws/fake/ec2api.go)
# ---------------------------------------------------------------------------


@dataclass
class SimInstanceTypeInfo:
    """Raw catalog record as the cloud API reports it
    (the ec2.InstanceTypeInfo analog)."""

    name: str
    vcpus: float
    memory_gib: float
    architecture: str = lbl.ARCH_AMD64
    gpus: float = 0.0
    gpu_vendor: str = ""  # "" | "nvidia" | "amd"
    max_network_interfaces: int = 4
    ips_per_interface: int = 15
    zones: Tuple[str, ...] = ("sim-zone-1a", "sim-zone-1b", "sim-zone-1c")
    capacity_types: Tuple[str, ...] = (lbl.CAPACITY_TYPE_SPOT, lbl.CAPACITY_TYPE_ON_DEMAND)
    bare_metal: bool = False
    price_per_hour: Optional[float] = None


@dataclass
class SimSubnet:
    id: str
    zone: str
    tags: Dict[str, str] = field(default_factory=dict)


@dataclass
class SimSecurityGroup:
    id: str
    tags: Dict[str, str] = field(default_factory=dict)


@dataclass
class SimInstance:
    id: str
    instance_type: str
    zone: str
    capacity_type: str
    launch_template: str
    state: str = "running"
    # the client launch token stamped at create_fleet (the EC2 tag analog):
    # what makes a retried fleet call replay instead of double-launching,
    # and what crash recovery re-describes unresolved journal entries by
    launch_token: str = ""
    created_at: float = 0.0


def default_sim_catalog() -> List[SimInstanceTypeInfo]:
    """A realistic small catalog: general-purpose ladder + GPU + ARM + metal."""
    out: List[SimInstanceTypeInfo] = []
    for i, (vcpus, mem) in enumerate([(1, 2), (2, 4), (4, 8), (8, 16), (16, 32), (32, 64), (64, 128)]):
        out.append(SimInstanceTypeInfo(name=f"sim.gp-{vcpus}x", vcpus=vcpus, memory_gib=mem))
    out.append(SimInstanceTypeInfo(name="sim.gpu-8x", vcpus=8, memory_gib=64, gpus=1, gpu_vendor="nvidia"))
    out.append(SimInstanceTypeInfo(name="sim.gpu-32x", vcpus=32, memory_gib=256, gpus=4, gpu_vendor="nvidia"))
    out.append(SimInstanceTypeInfo(name="sim.arm-16x", vcpus=16, memory_gib=32, architecture=lbl.ARCH_ARM64))
    out.append(SimInstanceTypeInfo(name="sim.metal-96x", vcpus=96, memory_gib=384, bare_metal=True))
    return out


class SimCloudAPI:
    """Behavior-programmable cloud control plane: capacity pools simulate
    insufficient capacity per (capacityType, instanceType, zone); methods can
    be made to fail via ``inject_error`` (reference: aws/fake/ec2api.go:35-137)."""

    def __init__(
        self,
        catalog: Optional[List[SimInstanceTypeInfo]] = None,
        subnets: Optional[List[SimSubnet]] = None,
        security_groups: Optional[List[SimSecurityGroup]] = None,
    ):
        self.catalog = catalog if catalog is not None else default_sim_catalog()
        self.subnets = subnets if subnets is not None else [
            SimSubnet("subnet-1", "sim-zone-1a", {"purpose": "nodes", "Name": "private-a"}),
            SimSubnet("subnet-2", "sim-zone-1b", {"purpose": "nodes", "Name": "private-b"}),
            SimSubnet("subnet-3", "sim-zone-1c", {"purpose": "nodes", "Name": "private-c"}),
        ]
        self.security_groups = security_groups if security_groups is not None else [
            SimSecurityGroup("sg-nodes", {"purpose": "nodes"}),
            SimSecurityGroup("sg-extra", {"purpose": "extra"}),
        ]
        # pools with no capacity: set of (capacity_type, instance_type, zone)
        self.insufficient_capacity_pools: Set[Tuple[str, str, str]] = set()
        self.launch_templates: Dict[str, Dict[str, Any]] = {}
        self.instances: Dict[str, SimInstance] = {}
        self.calls: Dict[str, int] = {}
        # the disruption-event bus (the EventBridge/SQS analog): tests push
        # notices via send_disruption_notice; the interruption controller
        # drains them through the provider's poll_disruptions
        self.disruptions = NoticeQueue()
        self._errors: Dict[str, List[Exception]] = {}
        self._counter = itertools.count(1)
        self._mu = threading.Lock()
        # client-token ledger: token -> instance id. A retried create_fleet
        # with a token the control plane has already committed replays the
        # recorded instance instead of launching a second one — the
        # CreateFleet ClientToken contract, honored by the double itself,
        # so every caller gets idempotent creates.
        self._fleet_tokens: Dict[str, str] = {}  # guarded-by: self._mu
        # simulated provisioning latency: create_fleet sleeps this long
        # OUTSIDE the mutex (parallel launches overlap, like the real
        # control plane) — what makes a cold launch measurably slower than
        # a warm-pool claim in the bench storm legs
        self.launch_latency_s: float = 0.0

    # -- error injection ----------------------------------------------------
    def inject_error(self, method: str, error: Exception) -> None:
        self._errors.setdefault(method, []).append(error)

    def _enter(self, method: str) -> None:
        with self._mu:
            self.calls[method] = self.calls.get(method, 0) + 1
            pending = self._errors.get(method)
            if pending:
                raise pending.pop(0)

    # -- control-plane methods ----------------------------------------------
    def describe_instance_types(self) -> List[SimInstanceTypeInfo]:
        self._enter("describe_instance_types")
        return list(self.catalog)

    def describe_subnets(self, selector: Dict[str, str]) -> List[SimSubnet]:
        self._enter("describe_subnets")
        return [s for s in self.subnets if _tags_match(s.tags, selector)]

    def describe_security_groups(self, selector: Dict[str, str]) -> List[SimSecurityGroup]:
        self._enter("describe_security_groups")
        return [g for g in self.security_groups if _tags_match(g.tags, selector)]

    def ensure_launch_template(self, name: str, data: Dict[str, Any]) -> str:
        self._enter("ensure_launch_template")
        with self._mu:
            self.launch_templates.setdefault(name, data)
        return name

    def delete_launch_template(self, name: str) -> None:
        self._enter("delete_launch_template")
        with self._mu:
            self.launch_templates.pop(name, None)

    def create_fleet(
        self,
        capacity_type: str,
        overrides: Sequence[Tuple[str, str, str]],  # (launch_template, instance_type, zone)
        client_token: str = "",
    ) -> Tuple[List[SimInstance], List[Tuple[str, str, str]]]:
        """Launch ONE instance from the first override whose capacity pool is
        healthy; returns (instances, ICE-errored overrides) — the
        CreateFleet(type=instant, TotalTargetCapacity=1) analog
        (reference: aws/instance.go:120-156, fake/ec2api.go:78-137).
        A ``client_token`` the control plane has already committed replays
        the recorded instance: same token, same instance, never a second
        launch."""
        self._enter("create_fleet")
        if self.launch_latency_s > 0:
            time.sleep(self.launch_latency_s)
        errors: List[Tuple[str, str, str]] = []
        with self._mu:
            if client_token:
                committed = self._fleet_tokens.get(client_token)
                if (
                    committed is not None
                    and committed in self.instances
                    and self.instances[committed].state != "terminated"
                ):
                    return [self.instances[committed]], errors
            for lt, itype, zone in overrides:
                if (capacity_type, itype, zone) in self.insufficient_capacity_pools:
                    errors.append((capacity_type, itype, zone))
                    continue
                inst = SimInstance(
                    id=f"i-{next(self._counter):08x}",
                    instance_type=itype,
                    zone=zone,
                    capacity_type=capacity_type,
                    launch_template=lt,
                    launch_token=client_token,
                    created_at=time.time(),
                )
                self.instances[inst.id] = inst
                if client_token:
                    self._fleet_tokens[client_token] = inst.id
                return [inst], errors
        if errors:
            # EVERY override hit an exhausted pool: surface it typed (with
            # the pools) instead of an empty result a caller could mistake
            # for an empty-override bug
            raise InsufficientCapacityError(
                f"all {len(errors)} overrides insufficient", overrides=errors
            )
        return [], errors

    def describe_instances(self, ids: List[str]) -> List[SimInstance]:
        self._enter("describe_instances")
        with self._mu:
            return [self.instances[i] for i in ids if i in self.instances]

    def list_instances(self) -> List[SimInstance]:
        """Full inventory (the DescribeInstances-no-filter analog) — what
        the launch journal's recovery and the GC controller sweep."""
        self._enter("list_instances")
        with self._mu:
            return list(self.instances.values())

    def terminate_instances(self, ids: List[str]) -> None:
        self._enter("terminate_instances")
        with self._mu:
            for i in ids:
                inst = self.instances.get(i)
                if inst:
                    inst.state = "terminated"
                    # release the token ledger entry (Fake/GKE pop theirs
                    # on delete): a token replay must never resurrect a
                    # terminated instance as a live create result
                    if inst.launch_token:
                        self._fleet_tokens.pop(inst.launch_token, None)

    def send_disruption_notice(self, notice: DisruptionNotice) -> None:
        """Fault injector: put a disruption notice on the event bus. Node
        names are instance ids here (``_to_node`` names Node objects after
        the instance), so callers pass the instance id."""
        self.disruptions.push(notice)

    def poll_disruptions(self) -> List[DisruptionNotice]:
        self._enter("poll_disruptions")
        return self.disruptions.drain()


def _tags_match(tags: Dict[str, str], selector: Dict[str, str]) -> bool:
    """Tag selector semantics: ``""`` value = wildcard (key exists)
    (reference: aws/subnets.go:46-87)."""
    for k, v in selector.items():
        if v == "" or v == "*":
            if k not in tags:
                return False
        elif tags.get(k) != v:
            return False
    return True


# ---------------------------------------------------------------------------
# Vendor provider config (reference: aws/apis/v1alpha1/provider*.go)
# ---------------------------------------------------------------------------


@dataclass
class BlockDeviceMapping:
    """reference: aws/apis/v1alpha1/provider.go BlockDeviceMappings."""

    device_name: str = "/dev/xvda"
    volume_size_gib: int = 20
    volume_type: str = "gp3"
    encrypted: bool = True
    delete_on_termination: bool = True

    def validate(self) -> List[str]:
        errs = []
        if not self.device_name:
            errs.append("blockDeviceMapping deviceName must not be empty")
        if self.volume_size_gib <= 0:
            errs.append(f"blockDeviceMapping volumeSize {self.volume_size_gib} must be positive")
        if self.volume_type not in ("gp2", "gp3", "io1", "io2", "st1", "sc1", "standard"):
            errs.append(f"blockDeviceMapping volumeType {self.volume_type} not recognized")
        return errs


@dataclass
class MetadataOptions:
    """Instance metadata service settings
    (reference: aws/apis/v1alpha1/provider.go MetadataOptions)."""

    http_endpoint: str = "enabled"
    http_tokens: str = "required"  # IMDSv2 by default
    http_put_response_hop_limit: int = 2

    def validate(self) -> List[str]:
        errs = []
        if self.http_endpoint not in ("enabled", "disabled"):
            errs.append(f"metadataOptions httpEndpoint {self.http_endpoint} invalid")
        if self.http_tokens not in ("required", "optional"):
            errs.append(f"metadataOptions httpTokens {self.http_tokens} invalid")
        if not 1 <= self.http_put_response_hop_limit <= 64:
            errs.append(
                f"metadataOptions hopLimit {self.http_put_response_hop_limit} not in 1..64"
            )
        return errs


@dataclass
class SimProviderConfig:
    """The vendor block embedded in ``provisioner.spec.provider``."""

    instance_profile: str = ""
    subnet_selector: Dict[str, str] = field(default_factory=lambda: dict(DEFAULT_SELECTOR))
    security_group_selector: Dict[str, str] = field(default_factory=lambda: dict(DEFAULT_SELECTOR))
    image_family: str = DEFAULT_IMAGE_FAMILY
    tags: Dict[str, str] = field(default_factory=dict)
    launch_template: str = ""  # bring-your-own template name
    block_device_mappings: List[BlockDeviceMapping] = field(default_factory=list)
    metadata_options: MetadataOptions = field(default_factory=MetadataOptions)
    # presence flags: explicitly-specified fields conflict with launchTemplate
    # even when they equal the defaults
    security_group_selector_specified: bool = False
    metadata_options_specified: bool = False
    # malformed input collected at deserialize time so validate() can report
    # field errors instead of the parse crashing reconcile/webhook paths
    parse_errors: List[str] = field(default_factory=list)

    @staticmethod
    def deserialize(provider: Optional[Dict[str, Any]]) -> "SimProviderConfig":
        """reference: aws/apis/v1alpha1/provider.go:195-210. Lenient: bad
        field types become ``parse_errors`` surfaced by ``validate()``."""
        if not provider:
            return SimProviderConfig()
        errors: List[str] = []

        def build(cls, raw, key_map: Dict[str, str], label: str):
            """Dataclass from present keys only — the dataclass defaults stay
            the single source of truth for absent fields."""
            kwargs = {}
            if raw is None:
                raw = {}
            if not isinstance(raw, dict):
                errors.append(f"{label} must be an object, got {type(raw).__name__}")
                raw = {}
            for doc_key, field_name in key_map.items():
                if doc_key not in raw:
                    continue
                value = raw[doc_key]
                target = cls.__dataclass_fields__[field_name].type
                try:
                    if target == "int":
                        value = int(value)
                    elif target == "bool":
                        if isinstance(value, str):
                            value = value.lower() == "true"
                        else:
                            value = bool(value)
                    else:
                        value = str(value)
                except (TypeError, ValueError):
                    errors.append(f"{label}.{doc_key}: invalid value {value!r}")
                    continue
                kwargs[field_name] = value
            return cls(**kwargs)

        bdms_raw = provider.get("blockDeviceMappings") or []
        if not isinstance(bdms_raw, list):
            errors.append("blockDeviceMappings must be a list")
            bdms_raw = []
        bdms = [
            build(
                BlockDeviceMapping,
                b,
                {
                    "deviceName": "device_name",
                    "volumeSize": "volume_size_gib",
                    "volumeType": "volume_type",
                    "encrypted": "encrypted",
                    "deleteOnTermination": "delete_on_termination",
                },
                f"blockDeviceMappings[{i}]",
            )
            for i, b in enumerate(bdms_raw)
        ]
        metadata = build(
            MetadataOptions,
            provider.get("metadataOptions"),
            {
                "httpEndpoint": "http_endpoint",
                "httpTokens": "http_tokens",
                "httpPutResponseHopLimit": "http_put_response_hop_limit",
            },
            "metadataOptions",
        )
        return SimProviderConfig(
            instance_profile=str(provider.get("instanceProfile", "")),
            # absent → default; explicitly empty/null → {} so validate rejects
            subnet_selector=dict(provider.get("subnetSelector", DEFAULT_SELECTOR) or {}),
            security_group_selector=dict(
                provider.get("securityGroupSelector", DEFAULT_SELECTOR) or {}
            ),
            image_family=str(provider.get("imageFamily", DEFAULT_IMAGE_FAMILY)),
            tags=dict(provider.get("tags") or {}),
            launch_template=str(provider.get("launchTemplate", "")),
            block_device_mappings=bdms,
            metadata_options=metadata,
            security_group_selector_specified="securityGroupSelector" in provider,
            metadata_options_specified="metadataOptions" in provider,
            parse_errors=errors,
        )

    def validate(self) -> List[str]:
        """reference: aws/apis/v1alpha1/provider_validation.go:41-226."""
        errs = list(self.parse_errors)
        if self.image_family not in IMAGE_FAMILIES:
            errs.append(f"imageFamily {self.image_family} not in {IMAGE_FAMILIES}")
        if self.launch_template and (
            self.security_group_selector_specified
            or self.security_group_selector != DEFAULT_SELECTOR
        ):
            # a custom launch template brings its own security groups
            errs.append("may not specify both launchTemplate and securityGroupSelector")
        if self.launch_template and self.block_device_mappings:
            errs.append("may not specify both launchTemplate and blockDeviceMappings")
        if self.launch_template and self.metadata_options_specified:
            # BYO templates carry their own IMDS settings; silently dropping
            # the user's would be worse than rejecting
            errs.append("may not specify both launchTemplate and metadataOptions")
        for selector, name in ((self.subnet_selector, "subnetSelector"),
                               (self.security_group_selector, "securityGroupSelector")):
            if not selector:
                errs.append(f"{name} must not be empty")
        for k in self.tags:
            if k.startswith(lbl.GROUP):
                errs.append(f"tag {k} uses the restricted {lbl.GROUP} prefix")
        for bdm in self.block_device_mappings:
            errs.extend(bdm.validate())
        errs.extend(self.metadata_options.validate())
        return errs


# ---------------------------------------------------------------------------
# Instance types + overhead model (reference: aws/instancetype.go)
# ---------------------------------------------------------------------------


def network_limited_pods(info: SimInstanceTypeInfo) -> float:
    """max interfaces × (ips per interface − 1) + 2
    (reference: aws/instancetype.go:236-241)."""
    return float(info.max_network_interfaces * (info.ips_per_interface - 1) + 2)


def compute_overhead(info: SimInstanceTypeInfo) -> Dict[str, float]:
    """Kubelet/system reserve: 100m system CPU + a kube-reserved CPU
    percentage ladder, memory ``11·pods + 255 + 100 + 100`` MiB
    (reference: aws/instancetype.go:190-234)."""
    cpu_milli = info.vcpus * 1000.0
    cpu_overhead = 100.0  # system-reserved
    for start, end, pct in ((0, 1000, 0.06), (1000, 2000, 0.01),
                            (2000, 4000, 0.005), (4000, 1 << 31, 0.0025)):
        if cpu_milli >= start:
            span = min(cpu_milli, end) - start
            cpu_overhead += span * pct
    mem_mib = 11 * network_limited_pods(info) + 255 + 100 + 100
    return {
        res.CPU: cpu_overhead / 1000.0,
        res.MEMORY: mem_mib * 1024**2,
    }


def to_instance_type(
    info: SimInstanceTypeInfo,
    zones: Set[str],
    unavailable: "UnavailableOfferings",
) -> InstanceType:
    """Catalog record → scheduler-facing InstanceType: offerings are the
    (viable zones ∩ subnet zones) × capacity-type cross product minus
    ICE-cached pools (reference: aws/instancetypes.go:66-114)."""
    offerings = [
        Offering(ct, z)
        for ct in info.capacity_types
        for z in sorted(zones & set(info.zones))
        if not unavailable.is_unavailable(ct, info.name, z)
    ]
    resources = {
        res.CPU: info.vcpus,
        res.MEMORY: info.memory_gib * 1024**3,
        res.PODS: network_limited_pods(info),
        res.EPHEMERAL_STORAGE: 20 * 1024**3,
    }
    if info.gpus:
        resources[res.NVIDIA_GPU if info.gpu_vendor == "nvidia" else res.AMD_GPU] = info.gpus
    price = info.price_per_hour
    if price is None:
        price = 0.04 * info.vcpus + 0.005 * info.memory_gib + 0.9 * info.gpus
    return InstanceType(
        name=info.name,
        offerings=offerings,
        architecture=info.architecture,
        operating_systems=frozenset({lbl.OS_LINUX}),
        resources=resources,
        overhead=compute_overhead(info),
        price=price,
    )


class UnavailableOfferings:
    """ICE cache: offerings that returned insufficient capacity are skipped
    for 45s (reference: aws/instancetypes.go:185-198)."""

    def __init__(self, clock=None):
        self.cache = TTLCache(UNAVAILABLE_OFFERINGS_TTL, clock=clock)

    def mark_unavailable(self, capacity_type: str, instance_type: str, zone: str) -> None:
        logger.info("offering %s:%s:%s unavailable for %ss",
                    capacity_type, instance_type, zone, UNAVAILABLE_OFFERINGS_TTL)
        self.cache.set(f"{capacity_type}:{instance_type}:{zone}", True)

    def is_unavailable(self, capacity_type: str, instance_type: str, zone: str) -> bool:
        return self.cache.get(f"{capacity_type}:{instance_type}:{zone}") is not None


class InstanceTypeProvider:
    """Catalog discovery with a 5-minute TTL cache
    (reference: aws/instancetypes.go:40-114)."""

    def __init__(self, api: SimCloudAPI, subnet_provider: "SubnetProvider", clock=None):
        self.api = api
        self.subnet_provider = subnet_provider
        self.unavailable = UnavailableOfferings(clock=clock)
        self._cache = TTLCache(INSTANCE_TYPES_TTL, clock=clock)

    def get(self, config: SimProviderConfig) -> List[InstanceType]:
        zones = {s.zone for s in self.subnet_provider.get(config)}
        # the raw catalog is selector-independent; the zone intersection is
        # applied per call below, so one cache entry serves every selector
        infos = self._cache.get_or_compute("types", self.api.describe_instance_types)
        out = []
        for info in infos:
            if info.bare_metal:  # opinionated filter (reference: instancetypes.go:167)
                continue
            it = to_instance_type(info, zones, self.unavailable)
            if it.offerings:
                out.append(it)
        return out

    def invalidate(self) -> None:
        self._cache.clear()


class SubnetProvider:
    """Tag-selector subnet discovery, cached (reference: aws/subnets.go:46-87)."""

    def __init__(self, api: SimCloudAPI, clock=None):
        self.api = api
        self._cache = TTLCache(CACHE_TTL, clock=clock)

    def get(self, config: SimProviderConfig) -> List[SimSubnet]:
        key = tuple(sorted(config.subnet_selector.items()))
        subnets = self._cache.get_or_compute(
            key, lambda: self.api.describe_subnets(config.subnet_selector)
        )
        if not subnets:
            raise CloudAPIError(f"no subnets matched selector {config.subnet_selector}")
        return subnets


class SecurityGroupProvider:
    """reference: aws/securitygroups.go:45-99."""

    def __init__(self, api: SimCloudAPI, clock=None):
        self.api = api
        self._cache = TTLCache(CACHE_TTL, clock=clock)

    def get(self, config: SimProviderConfig) -> List[SimSecurityGroup]:
        key = tuple(sorted(config.security_group_selector.items()))
        groups = self._cache.get_or_compute(
            key, lambda: self.api.describe_security_groups(config.security_group_selector)
        )
        if not groups:
            raise CloudAPIError(
                f"no security groups matched selector {config.security_group_selector}"
            )
        return groups


class LaunchTemplateProvider:
    """Resolve (image family × constraints) to an ensured launch template;
    the template name is a stable hash of its parameters so identical
    configurations share one template (reference: aws/launchtemplate.go:74-186
    and the amifamily strategy pattern, amifamily/resolver.go:69-110)."""

    def __init__(self, api: SimCloudAPI, security_groups: SecurityGroupProvider):
        self.api = api
        self.security_groups = security_groups
        self._cache: Dict[str, str] = {}
        self._mu = threading.Lock()

    def get(self, config: SimProviderConfig, constraints: Constraints, needs_gpu: bool) -> str:
        if config.launch_template:
            return config.launch_template  # bring-your-own
        image = self._resolve_image(config.image_family, needs_gpu)
        groups = [g.id for g in self.security_groups.get(config)]
        bdms = config.block_device_mappings or [BlockDeviceMapping()]
        data = {
            "image": image,
            "instance_profile": config.instance_profile,
            "security_groups": sorted(groups),
            "tags": dict(sorted(config.tags.items())),
            "labels": dict(_sorted_labels(constraints)),
            "taints": _rendered_taints(constraints),
            "block_device_mappings": [
                {
                    "device_name": b.device_name,
                    "volume_size_gib": b.volume_size_gib,
                    "volume_type": b.volume_type,
                    "encrypted": b.encrypted,
                    "delete_on_termination": b.delete_on_termination,
                }
                for b in bdms
            ],
            "metadata_options": {
                "http_endpoint": config.metadata_options.http_endpoint,
                "http_tokens": config.metadata_options.http_tokens,
                "http_put_response_hop_limit": config.metadata_options.http_put_response_hop_limit,
            },
            "user_data": bootstrap_user_data(config.image_family, constraints),
        }
        name = "karpenter-lt-" + hashlib.sha256(
            json.dumps(data, sort_keys=True).encode()
        ).hexdigest()[:16]
        with self._mu:
            if name not in self._cache:
                self.api.ensure_launch_template(name, data)
                self._cache[name] = name
        return name

    @staticmethod
    def _resolve_image(family: str, needs_gpu: bool) -> str:
        """The AMI-family strategy: GPU nodes get the accelerated image
        variant (reference: amifamily/al2.go:31-60 picks GPU AMIs)."""
        if needs_gpu:
            return f"img-{family}-gpu-v1"
        return f"img-{family}-v1"


def _sorted_labels(constraints: Constraints):
    return sorted(constraints.labels.items())


def _rendered_taints(constraints: Constraints) -> List[str]:
    """One rendering shared by the template hash and the bootstrap payload —
    they must never disagree."""
    return sorted(f"{t.key}={t.value}:{t.effect}" for t in constraints.taints)


def bootstrap_user_data(image_family: str, constraints: Constraints) -> str:
    """Node bootstrap payload: kubelet register-time labels/taints and
    cluster DNS, per image family — the reference's bootstrap-script
    generator shapes the same arguments (amifamily/bootstrap/
    eksbootstrap.go:32; Bottlerocket uses TOML instead of shell).
    ``standard``/``gpu`` render a shell bootstrap; ``minimal`` renders a
    TOML settings file (the Bottlerocket analog)."""
    labels = ",".join(f"{k}={v}" for k, v in _sorted_labels(constraints))
    taints = ",".join(_rendered_taints(constraints))
    dns = ""
    if constraints.kubelet_configuration and constraints.kubelet_configuration.cluster_dns:
        dns = constraints.kubelet_configuration.cluster_dns[0]
    if image_family == "minimal":
        lines = ["[settings.kubernetes]"]
        if labels:
            lines.append(f'node-labels = "{labels}"')
        if taints:
            lines.append(f'node-taints = "{taints}"')
        if dns:
            lines.append(f'cluster-dns-ip = "{dns}"')
        return "\n".join(lines)
    args = ["/etc/bootstrap.sh"]
    if labels:
        args.append(f"--node-labels={labels}")
    if taints:
        args.append(f"--register-with-taints={taints}")
    if dns:
        args.append(f"--cluster-dns={dns}")
    return " ".join(args)


class InstanceProvider:
    """The launch path (reference: aws/instance.go:72-368)."""

    def __init__(
        self,
        api: SimCloudAPI,
        instance_types: InstanceTypeProvider,
        subnets: SubnetProvider,
        launch_templates: LaunchTemplateProvider,
    ):
        self.api = api
        self.instance_types = instance_types
        self.subnets = subnets
        self.launch_templates = launch_templates
        # client-side flow control on the fleet call
        # (reference: aws/instance.go:43-49, 2 QPS / 100 burst)
        self.fleet_limiter = TokenBucket(CREATE_FLEET_QPS, CREATE_FLEET_BURST)

    def create(self, config: SimProviderConfig, request: NodeRequest,
               token: str = "") -> Node:
        # GPU filter BEFORE the 20-type cap: a GPU-heavy prefix must not
        # starve out the generic types (reference: aws/instance.go:73-75)
        options = self._prefer_generic(list(request.instance_type_options))
        options = options[:MAX_INSTANCE_TYPES]
        if not options:
            raise InsufficientCapacityError("no instance type options")
        capacity_type = self._get_capacity_type(request.template, options)
        needs_gpu = any(
            it.resources.get(res.NVIDIA_GPU, 0) or it.resources.get(res.AMD_GPU, 0)
            for it in options
        )
        lt = self.launch_templates.get(config, request.template, needs_gpu)
        zones = request.template.requirements.zones()
        subnet_zones = {s.zone for s in self.subnets.get(config)}
        overrides = [
            (lt, it.name, o.zone)
            for it in options
            for o in it.offerings
            if o.capacity_type == capacity_type
            and o.zone in subnet_zones
            and (not zones or o.zone in zones)
        ]
        if not overrides:
            raise InsufficientCapacityError(
                f"no launchable offering for capacity type {capacity_type}"
            )
        if not self.fleet_limiter.take(timeout=60):
            raise CloudAPIError("fleet request rate budget exhausted (2 QPS/100 burst)")
        try:
            # the launch token rides the fleet call: a committed token
            # replays the same instance from the double's ledger, so a
            # retried create cannot double-launch
            instances, errors = self.api.create_fleet(
                capacity_type, overrides, client_token=token
            )
        except InsufficientCapacityError as e:
            # the typed all-ICE answer: cache out exactly the pools the
            # control plane reported exhausted, then let the capacity error
            # propagate
            for ct, itype, zone in e.overrides:
                self.instance_types.unavailable.mark_unavailable(ct, itype, zone)
            raise
        for ct, itype, zone in errors:
            self.instance_types.unavailable.mark_unavailable(ct, itype, zone)
        if not instances:
            raise InsufficientCapacityError(
                f"fleet returned no instances ({len(errors)} unavailable pools)",
                overrides=errors,
            )
        instance = self._describe_with_retry(instances[0].id)
        return self._to_node(instance, options)

    def _describe_with_retry(self, instance_id: str) -> SimInstance:
        """DescribeInstances right after a launch is eventually consistent
        (reference: aws/instance.go:84-91, 6 retries)."""
        last_err: Optional[Exception] = None
        for attempt in range(DESCRIBE_RETRIES):
            try:
                found = self.api.describe_instances([instance_id])
                if found:
                    return found[0]
            except CloudAPIError as e:
                last_err = e
            if attempt < DESCRIBE_RETRIES - 1:  # no dead sleep before raising
                time.sleep(min(0.05 * (2**attempt), 1.0))
        raise CloudAPIError(
            f"instance {instance_id} not visible after {DESCRIBE_RETRIES} retries"
        ) from last_err

    def delete(self, node: Node) -> None:
        instance_id = node.spec.provider_id.rsplit("/", 1)[-1]
        self.api.terminate_instances([instance_id])

    @staticmethod
    def _get_capacity_type(template: Constraints, options: Sequence[InstanceType]) -> str:
        """Spot iff requested AND offered; default on-demand
        (reference: aws/instance.go:311-323)."""
        if lbl.CAPACITY_TYPE_SPOT in template.requirements.capacity_types():
            zones = template.requirements.zones()
            for it in options:
                for o in it.offerings:
                    if o.capacity_type == lbl.CAPACITY_TYPE_SPOT and (not zones or o.zone in zones):
                        return lbl.CAPACITY_TYPE_SPOT
        return lbl.CAPACITY_TYPE_ON_DEMAND

    @staticmethod
    def _prefer_generic(options: List[InstanceType]) -> List[InstanceType]:
        """Drop GPU types when a generic type suffices
        (reference: aws/instance.go:327-345)."""
        generic = [
            it
            for it in options
            if not it.resources.get(res.NVIDIA_GPU, 0) and not it.resources.get(res.AMD_GPU, 0)
        ]
        return generic if generic else options

    @staticmethod
    def _to_node(instance: SimInstance, options: Sequence[InstanceType]) -> Node:
        it = next(o for o in options if o.name == instance.instance_type)
        allocatable = {
            k: max(v - it.overhead.get(k, 0.0), 0.0) for k, v in it.resources.items()
        }
        return Node(
            metadata=ObjectMeta(
                name=instance.id,
                namespace="",
                labels={
                    lbl.INSTANCE_TYPE: instance.instance_type,
                    lbl.TOPOLOGY_ZONE: instance.zone,
                    lbl.CAPACITY_TYPE: instance.capacity_type,
                    lbl.ARCH: it.architecture,
                    lbl.OS: lbl.OS_LINUX,
                },
                annotations=(
                    {lbl.LAUNCH_TOKEN_ANNOTATION: instance.launch_token}
                    if instance.launch_token else {}
                ),
            ),
            spec=NodeSpec(provider_id=f"sim:///{instance.zone}/{instance.id}"),
            status=NodeStatus(capacity=dict(it.resources), allocatable=allocatable),
        )


class SimulatedCloudProvider(CloudProvider):
    """reference: aws/cloudprovider.go:53-188."""

    def __init__(self, api: Optional[SimCloudAPI] = None, clock=None):
        self.api = api or SimCloudAPI()
        self.subnet_provider = SubnetProvider(self.api, clock=clock)
        self.security_group_provider = SecurityGroupProvider(self.api, clock=clock)
        self.instance_type_provider = InstanceTypeProvider(
            self.api, self.subnet_provider, clock=clock
        )
        self.launch_template_provider = LaunchTemplateProvider(
            self.api, self.security_group_provider
        )
        self.instance_provider = InstanceProvider(
            self.api,
            self.instance_type_provider,
            self.subnet_provider,
            self.launch_template_provider,
        )
        from karpenter_tpu_torch.resilience import MissTracker

        self._liveness = MissTracker(threshold=LIVENESS_MISS_THRESHOLD)

    @idempotent
    def create(self, request: NodeRequest) -> Node:
        # idempotent BY TOKEN: the launch token rides down to the fleet
        # call, where a committed token replays the recorded instance
        config = SimProviderConfig.deserialize(request.template.provider)
        return self.instance_provider.create(
            config, request, token=request.launch_token
        )

    @idempotent
    def delete(self, node: Node) -> None:
        self.instance_provider.delete(node)

    def list_instances(self) -> List[LiveInstance]:
        """Live inventory for the GC/adoption cross-check: every
        non-terminated instance with the launch token its create stamped."""
        return [
            LiveInstance(
                id=inst.id,
                launch_token=inst.launch_token,
                instance_type=inst.instance_type,
                zone=inst.zone,
                capacity_type=inst.capacity_type,
                created_at=inst.created_at,
                provider_id=f"sim:///{inst.zone}/{inst.id}",
            )
            for inst in self.api.list_instances()
            if inst.state != "terminated"
        ]

    @idempotent
    def get_instance_types(self, provider: Optional[Dict[str, Any]] = None) -> List[InstanceType]:
        return self.instance_type_provider.get(SimProviderConfig.deserialize(provider))

    def default(self, constraints: Constraints) -> None:
        """Vendor defaulting: capacity-type on-demand, arch amd64
        (reference: aws/apis/v1alpha1/provider_defaults.go:26-56)."""
        if not constraints.requirements.capacity_types():
            constraints.requirements = constraints.requirements.add(
                NodeSelectorRequirement(
                    key=lbl.CAPACITY_TYPE, operator="In", values=[lbl.CAPACITY_TYPE_ON_DEMAND]
                )
            )
        if not constraints.requirements.architectures():
            constraints.requirements = constraints.requirements.add(
                NodeSelectorRequirement(key=lbl.ARCH, operator="In", values=[lbl.ARCH_AMD64])
            )

    def validate(self, constraints: Constraints) -> List[str]:
        return SimProviderConfig.deserialize(constraints.provider).validate()

    @idempotent
    def poll_disruptions(self) -> List[DisruptionNotice]:
        """DisruptionSource: drain the control plane's event bus."""
        return self.api.poll_disruptions()

    def requeue_disruption(self, notice: DisruptionNotice) -> bool:
        """Fleet routing: push a notice drained by the wrong replica back
        onto the event bus for the shard owner's next poll, through the
        double's ``send_disruption_notice``."""
        sender = getattr(self.api, "send_disruption_notice", None)
        if sender is None:
            return False
        sender(notice)
        return True

    def instance_gone(self, node: Node) -> Optional[bool]:
        """Node liveness with flake debouncing. ``describe_instances``
        silently drops unknown ids, so a single missing id is ambiguous:
        flaky response or terminated instance? A ``terminated`` state (or a
        typed NotFound) answers True immediately; a bare miss answers True
        only after LIVENESS_MISS_THRESHOLD consecutive misses; an errored
        describe answers None (unknown) without advancing the count."""
        instance_id = node.spec.provider_id.rsplit("/", 1)[-1]
        try:
            found = self.api.describe_instances([instance_id])
        except InstanceNotFoundError:
            self._liveness.forget(instance_id)
            return True
        except Exception:
            return None  # the probe failed; that is not a miss
        if found:
            if found[0].state == "terminated":
                self._liveness.forget(instance_id)
                return True
            self._liveness.observe(instance_id, present=True)
            return False
        gone = self._liveness.observe(instance_id, present=False)
        if gone:
            self._liveness.forget(instance_id)
        return gone

    def name(self) -> str:
        return "simulated"
