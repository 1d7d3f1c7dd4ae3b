"""First-fit-decreasing reference scheduler (the CPU path).

A faithful re-implementation of the reference's scheduling core
(``pkg/controllers/provisioning/scheduling/scheduler.go:64-137``,
``node.go:30-81``, ``nodeset.go:30-78``): sort pods by CPU-then-memory
descending, instance types by price ascending, inject topology decisions as
just-in-time NodeSelectors, then first-fit each pod into existing virtual
nodes — incrementally narrowing each node's surviving instance-type set — or
open a new one.

This backend is the in-process fallback and the parity oracle for the TPU
batch solver (``karpenter_tpu_torch.solver``).
"""

from __future__ import annotations

import copy
import logging
import random
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from karpenter_tpu_torch.api.objects import Pod
from karpenter_tpu_torch.api.provisioner import Constraints
from karpenter_tpu_torch.api.requirements import Requirements
from karpenter_tpu_torch.cloudprovider.requirements import filter_instance_types
from karpenter_tpu_torch.cloudprovider.types import InstanceType
from karpenter_tpu_torch.kube.client import Cluster
from karpenter_tpu_torch.scheduling.topology import (
    Topology,
    restore_selectors,
    snapshot_selectors,
)
from karpenter_tpu_torch.utils import pod as podutil
from karpenter_tpu_torch.utils import resources as res

logger = logging.getLogger("karpenter.scheduling")


@dataclass
class VirtualNode:
    """A set of constraints + compatible pods + surviving instance types;
    becomes a real node after launch (reference: node.go:30-44)."""

    constraints: Constraints
    instance_type_options: List[InstanceType]
    pods: List[Pod] = field(default_factory=list)
    requests: Dict[str, float] = field(default_factory=dict)
    used_host_ports: set = field(default_factory=set)

    def add(self, pod: Pod) -> Optional[str]:
        """Try to place the pod; returns an error string or None on success
        (reference: node.go:46-66, plus host-port conflict enforcement the
        reference deferred — suite_test.go:1758)."""
        ports = podutil.host_ports(pod)
        if podutil.host_ports_conflict(ports, self.used_host_ports):
            return f"host port(s) already claimed on node: {sorted(ports)}"
        pod_reqs = Requirements.from_pod(pod)
        if self.pods:
            errs = self.constraints.requirements.compatible(pod_reqs)
            if errs:
                return "; ".join(errs)
        requirements = self.constraints.requirements.add(*pod_reqs.requirements)
        requests = res.merge(self.requests, res.requests_for_pods(pod))
        instance_types = filter_instance_types(self.instance_type_options, requirements, requests)
        if not instance_types:
            return (
                f"no instance type satisfied resources {res.to_string(res.requests_for_pods(pod))} "
                f"and requirements {requirements}"
            )
        self.pods.append(pod)
        self.instance_type_options = instance_types
        self.requests = requests
        self.constraints.requirements = requirements
        self.used_host_ports |= ports
        return None


def daemon_overhead(cluster: Cluster, constraints: Constraints) -> Dict[str, float]:
    """Resources of daemonsets that will land on these nodes
    (reference: nodeset.go:36-74)."""
    total: Dict[str, float] = {}
    for ds in cluster.daemonsets():
        pod = Pod(spec=copy.deepcopy(ds.pod_template))
        # validate_pod covers both the taint toleration and the requirement
        # compatibility filters the reference applies.
        if constraints.validate_pod(pod):
            continue
        total = res.merge(total, res.requests_for_pods(pod))
    return total


def sort_pods_ffd_with_statics(pods: Sequence[Pod]):
    """FFD sort returning (sorted pods, their statics in the same order) so
    callers share one statics pass across sort -> inject -> encode."""
    import numpy as np

    from karpenter_tpu_torch.scheduling.statics import statics

    import operator

    n = len(pods)
    sts = [statics(p) for p in pods]
    if n < 256:
        order = sorted(range(n), key=lambda i: (-sts[i].cpu, -sts[i].mem))
    else:
        cpu = np.fromiter(map(operator.attrgetter("cpu"), sts), dtype=np.float64, count=n)
        mem = np.fromiter(map(operator.attrgetter("mem"), sts), dtype=np.float64, count=n)
        # primary key last; lexsort is stable. tolist() first: indexing
        # Python lists with np.int64 scalars pays a boxing cost per element
        order = np.lexsort((-mem, -cpu)).tolist()
        getter = operator.itemgetter(*order)
        return list(getter(pods)), list(getter(sts))
    return [pods[i] for i in order], [sts[i] for i in order]


def sort_pods_ffd(pods: Sequence[Pod]) -> List[Pod]:
    """CPU-then-memory descending (reference: scheduler.go:116-137). Stable,
    like Go's sort.Slice on equal keys is not — but FFD only cares about the
    ordering of the keys."""
    return sort_pods_ffd_with_statics(pods)[0]


class FFDScheduler:
    """``solve`` returns virtual nodes for a batch of pending pods
    (reference: scheduler.go:64-108)."""

    def __init__(self, cluster: Cluster, rng: Optional[random.Random] = None):
        self.cluster = cluster
        self.topology = Topology(cluster, rng=rng)

    def solve(
        self,
        constraints: Constraints,
        instance_types: Sequence[InstanceType],
        pods: Sequence[Pod],
    ) -> List[VirtualNode]:
        constraints = constraints.clone()
        pods = sort_pods_ffd(pods)
        instance_types = sorted(instance_types, key=lambda it: it.effective_price())

        saved = snapshot_selectors(pods)
        try:
            self.topology.inject(constraints, list(pods))
            daemons = daemon_overhead(self.cluster, constraints)
            return self.solve_injected(constraints, instance_types, pods, daemons)
        finally:
            restore_selectors(pods, saved)

    def solve_injected(
        self,
        constraints: Constraints,
        instance_types: Sequence[InstanceType],
        pods: Sequence[Pod],
        daemons: Dict[str, float],
    ) -> List[VirtualNode]:
        """The packing loop alone — pods already FFD-sorted, topology already
        injected, types already price-sorted (shared entry for the TPU
        backend's fallback path)."""
        nodes: List[VirtualNode] = []
        unschedulable = 0
        for pod in pods:
            placed = False
            for node in nodes:
                if node.add(pod) is None:
                    placed = True
                    break
            if not placed:
                node = VirtualNode(
                    constraints=constraints.clone(),
                    instance_type_options=list(instance_types),
                    requests=dict(daemons),
                )
                err = node.add(pod)
                if err is None:
                    nodes.append(node)
                else:
                    unschedulable += 1
                    logger.error("Scheduling pod %s, %s", pod.key, err)
        if unschedulable:
            logger.error("Failed to schedule %d pods", unschedulable)
        return nodes
