"""Catalog↔requirements glue (reference: pkg/cloudprovider/requirements.go)."""

from __future__ import annotations

from typing import Dict, List, Mapping, Sequence

from karpenter_tpu_torch.api import labels as lbl
from karpenter_tpu_torch.api.objects import NodeSelectorRequirement
from karpenter_tpu_torch.api.requirements import Requirements
from karpenter_tpu_torch.cloudprovider.types import InstanceType
from karpenter_tpu_torch.utils import resources as res


# memo keyed by the catalog's object identities (the value holds the tuple
# so the ids stay valid): the union walks 400 types and runs on EVERY solve
# via the scheduler facade's idempotent re-layering. Identities are stable
# between catalog refreshes — providers TTL-cache the constructed
# InstanceType list (e.g. InstanceTypeProvider.get, 5 min). Concurrent
# per-provisioner workers share this, hence the lock.
import threading as _threading

_catreq_cache: Dict[tuple, tuple] = {}  # guarded-by: _catreq_lock
_catreq_lock = _threading.Lock()
_CATREQ_CACHE_MAX = 8


def catalog_requirements(instance_types: Sequence[InstanceType]) -> Requirements:
    """Union of supported {instance-type, zone, arch, os, capacity-type}
    values, layered into every provisioner at apply
    (reference: requirements.go:25-47). Requirements are immutable, so the
    identity-keyed memo hands out one shared object."""
    id_key = tuple(map(id, instance_types))
    with _catreq_lock:
        hit = _catreq_cache.get(id_key)
    if hit is not None:
        return hit[1]
    out = _catalog_requirements(instance_types)
    with _catreq_lock:
        while len(_catreq_cache) >= _CATREQ_CACHE_MAX:
            _catreq_cache.pop(next(iter(_catreq_cache)), None)
        _catreq_cache[id_key] = (tuple(instance_types), out)
    return out


def _catalog_requirements(instance_types: Sequence[InstanceType]) -> Requirements:
    supported: Dict[str, set] = {
        lbl.INSTANCE_TYPE: set(),
        lbl.TOPOLOGY_ZONE: set(),
        lbl.ARCH: set(),
        lbl.OS: set(),
        lbl.CAPACITY_TYPE: set(),
    }
    for it in instance_types:
        for offering in it.offerings:
            supported[lbl.TOPOLOGY_ZONE].add(offering.zone)
            supported[lbl.CAPACITY_TYPE].add(offering.capacity_type)
        supported[lbl.INSTANCE_TYPE].add(it.name)
        supported[lbl.ARCH].add(it.architecture)
        supported[lbl.OS].update(it.operating_systems)
    reqs = Requirements()
    for key, values in supported.items():
        reqs = reqs.add(NodeSelectorRequirement(key=key, operator="In", values=sorted(values)))
    return reqs


def compatible(it: InstanceType, requirements: Requirements) -> bool:
    """Per-key membership + at least one offering whose zone AND capacity
    type are both allowed (reference: requirements.go:49-66). Vendor-declared
    type labels (e.g. the GKE TPU topology) are checked like node labels: a
    requirement on a declared key must accept the type's value; requirements
    on keys the type does not declare stay non-excluding (they resolve at
    node level, like generated hostnames)."""
    if not requirements.get(lbl.INSTANCE_TYPE).has(it.name):
        return False
    if not requirements.get(lbl.ARCH).has(it.architecture):
        return False
    if not requirements.get(lbl.OS).has_any(it.operating_systems):
        return False
    for key, value in it.labels.items():
        if requirements.has(key) and not requirements.get(key).has(value):
            return False
    zone_set = requirements.get(lbl.TOPOLOGY_ZONE)
    ct_set = requirements.get(lbl.CAPACITY_TYPE)
    return any(zone_set.has(o.zone) and ct_set.has(o.capacity_type) for o in it.offerings)


def filter_instance_types(
    instance_types: Sequence[InstanceType],
    requirements: Requirements,
    requests: Mapping[str, float],
) -> List[InstanceType]:
    """Requirement-compatible types whose allocatable fits requests+overhead
    (reference: requirements.go:68-80)."""
    out: List[InstanceType] = []
    for it in instance_types:
        if not compatible(it, requirements):
            continue
        if not res.fits(res.merge(requests, it.overhead), it.resources):
            continue
        out.append(it)
    return out
