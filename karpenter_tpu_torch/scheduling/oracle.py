"""Unschedulability oracle: prove every dropped pod is genuinely
unsatisfiable, not an artifact of the greedy topology pre-assignment.

The reference logs-and-drops unschedulable pods (scheduler.go:95-99) without
explanation. Here, the oracle independently re-derives — from the original
pod specs, the cluster state, and the provisioner constraints alone — the
exact set of pods NO schedule could place under the framework's declared
affinity semantics (see scheduling/topology.py module docstring), with a
reason per pod. The benchmark asserts the solver's actual drops equal the
oracle's expectation (``unexplained == 0``); tests pin the classification.

Reasons:

- ``anti-affinity-zone-exhausted``: required zonal anti-affinity where the
  selector-matching members outnumber the zones they may claim. With Z clean
  zones (no existing cluster match) the group can place at most Z matching
  members — or Z-1 when non-matching members also exist, since those need one
  zone kept free of matchers. Any schedule violating that drops MORE pods.
- ``anti-affinity-no-clean-zone``: every viable zone already holds a
  cluster pod matching the anti-affinity selector, so no member can land.
- ``affinity-no-provider``: required pod affinity whose selector matches no
  batch pod and no scheduled cluster pod — nothing to co-locate with.
- ``no-instance-type-fits``: the pod's resource requests exceed every
  instance type's usable (allocatable minus overhead) capacity.
- ``pod-zone-pin-unsatisfiable``: an anti-affinity member whose own
  nodeSelector/affinity narrows the zone to something no viable zone offers.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from karpenter_tpu_torch.api import labels as lbl
from karpenter_tpu_torch.api.objects import Pod
from karpenter_tpu_torch.api.provisioner import Constraints
from karpenter_tpu_torch.cloudprovider.types import InstanceType
from karpenter_tpu_torch.kube.client import Cluster
from karpenter_tpu_torch.scheduling.topology import DomainPlan, Topology, ignored_for_topology
from karpenter_tpu_torch.utils import resources as res

ANTI_ZONE_EXHAUSTED = "anti-affinity-zone-exhausted"
ANTI_NO_CLEAN_ZONE = "anti-affinity-no-clean-zone"
AFFINITY_NO_PROVIDER = "affinity-no-provider"
NO_CAPACITY = "no-instance-type-fits"
PIN_NO_VIABLE_ZONE = "pod-zone-pin-unsatisfiable"


def expected_unschedulable(
    cluster: Cluster,
    constraints: Constraints,
    instance_types: Sequence[InstanceType],
    pods: Sequence[Pod],
):
    """The drops any schedule must incur.

    Returns ``(exact, budgets)``: ``exact`` maps pod.key → reason for pods
    that are individually impossible; each budget is
    ``{"reason", "candidates" (keys), "count"}`` for constraint classes
    where exactly ``count`` pods out of ``candidates`` must drop but WHICH
    ones is the scheduler's free choice (e.g. which excess anti-affinity
    matchers — the solver drops the smallest after its FFD sort)."""
    exact: Dict[str, str] = {}
    budgets: List[Dict[str, object]] = []
    topo = Topology(cluster)
    batch = list(pods)
    # the oracle reasons about PRE-injection state: an empty plan
    plan = DomainPlan(batch)
    viable = constraints.requirements.zones()

    for group in topo._affinity_groups(batch):
        if group.key == lbl.TOPOLOGY_ZONE and group.anti:
            topo._count_cluster_matches(group)
            clean = [d for d in viable if group.match_counts.get(d, 0) == 0]
            # a member whose own narrowing excludes every viable zone is
            # individually impossible and doesn't consume group capacity
            members = []
            for p in group.pods:
                if topo._allowed_domains(p, group.key, viable, plan):
                    members.append(p)
                else:
                    exact[p.key] = PIN_NO_VIABLE_ZONE
            matching = [p for p in members if group.selector_matches(p)]
            nonmatching = [p for p in members if not group.selector_matches(p)]
            if not clean:
                for p in members:
                    exact[p.key] = ANTI_NO_CLEAN_ZONE
                continue
            # capacity for matchers: one per clean zone, minus the zone
            # reserved for non-matching members (who need zero matchers) —
            # reserved only when some non-matcher can actually use a clean
            # zone, mirroring the injection (topology.py)
            reserve = bool(matching) and any(
                topo._allowed_domains(p, group.key, set(clean), plan)
                for p in nonmatching
            )
            capacity = len(clean) - (1 if reserve else 0)
            excess = len(matching) - max(capacity, 0)
            if excess > 0:
                budgets.append(
                    {
                        "reason": ANTI_ZONE_EXHAUSTED,
                        "candidates": {p.key for p in matching},
                        "count": excess,
                    }
                )
        elif not group.anti:
            # a provider can come from the batch, or — for zonal affinity
            # only — from scheduled cluster pods (hostname affinity targets
            # a fresh node, so only batch pods can provide the match:
            # topology.py _assign_hostname_affinity)
            provider, _ = Topology._batch_provider(group, batch, plan)
            if provider is not None:
                continue
            if group.key == lbl.TOPOLOGY_ZONE and _cluster_has_match(cluster, group):
                continue
            for p in group.pods:
                exact[p.key] = AFFINITY_NO_PROVIDER

    # resource feasibility: request vector must fit SOME instance type's
    # usable capacity (allocatable minus overhead) — same axis discovery and
    # capacity math as the encoder (solver/encode.py)
    from karpenter_tpu_torch.solver.encode import usable_capacity

    axes = res.collect_extra_axes(
        [it.resources for it in instance_types]
        + [it.overhead for it in instance_types]
        + [res.requests_for_pods(p) for p in batch]
    )
    usable = usable_capacity(instance_types, axes)
    for p in batch:
        if p.key in exact:
            continue
        req = res.to_scaled_vector(res.requests_for_pods(p), axes)
        if not bool((usable >= req).all(axis=1).any()):
            exact[p.key] = NO_CAPACITY
    return exact, budgets


def _cluster_has_match(cluster: Cluster, group) -> bool:
    for namespace in group.namespaces():
        for p in cluster.list_pods_matching(namespace, group.term.label_selector):
            if not ignored_for_topology(p):
                return True
    return False


def classify_drops(
    cluster: Cluster,
    constraints: Constraints,
    instance_types: Sequence[InstanceType],
    pods: Sequence[Pod],
    scheduled: Sequence[Pod],
) -> Dict[str, object]:
    """Compare a solve's actual drops against the oracle's expectation.

    Returns ``{"dropped": N, "expected": {reason: count}, "unexplained": [...],
    "missed": [...]}`` where ``unexplained`` lists dropped pods the oracle
    cannot justify (scheduler artifact) and ``missed`` lists pods the oracle
    deems impossible yet the solver placed (oracle/model divergence)."""
    placed = {id(p) for p in scheduled}
    dropped = [p for p in pods if id(p) not in placed]
    exact, budgets = expected_unschedulable(cluster, constraints, instance_types, pods)
    dropped_keys = {p.key for p in dropped}
    counts: Dict[str, int] = {}
    explained: set = set()
    missed: List[str] = []
    for key in dropped_keys:
        reason = exact.get(key)
        if reason is not None:
            counts[reason] = counts.get(reason, 0) + 1
            explained.add(key)
    missed += [k for k in exact if k not in dropped_keys]
    for budget in budgets:
        hit = sorted(dropped_keys & budget["candidates"])  # type: ignore[operator]
        reason, count = str(budget["reason"]), int(budget["count"])  # type: ignore[arg-type]
        if hit:
            counts[reason] = counts.get(reason, 0) + min(len(hit), count)
        explained.update(hit[:count])
        if len(hit) < count:
            # the solver placed more than the proven capacity — the model
            # (or the solver) is wrong; surface it
            missed.append(f"{reason}: {count - len(hit)} under budget")
    return {
        "dropped": len(dropped),
        "expected": counts,
        "unexplained": sorted(k for k in dropped_keys if k not in explained),
        "missed": missed,
    }
