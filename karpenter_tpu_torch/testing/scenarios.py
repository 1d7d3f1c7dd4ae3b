"""Benchmark scenario generators.

``diverse_pods`` mirrors the reference benchmark's pod mix
(``scheduling_benchmark_test.go:159-216``): 1/7 each of generic,
zone-topology-spread, hostname-topology-spread, pod-affinity (hostname),
pod-affinity (zone), pod-anti-affinity (hostname), pod-anti-affinity (zone),
with the same randomized label/cpu/memory pools.
"""

from __future__ import annotations

import random
from typing import List, Optional

from karpenter_tpu_torch.api import labels as lbl
from karpenter_tpu_torch.api.objects import LabelSelector, Pod, PodAffinityTerm
from karpenter_tpu_torch.testing.factories import hostname_spread, make_pod, zone_spread

_LABEL_VALUES = ["a", "b", "c", "d", "e", "f", "g"]
_MEM_MI = [100, 256, 512, 1024, 2048, 4096]
_CPU_M = [100, 250, 500, 1000, 1500]


def _random_labels(rng: random.Random) -> dict:
    return {"my-label": rng.choice(_LABEL_VALUES)}


def _requests(rng: random.Random) -> dict:
    return {
        "cpu": f"{rng.choice(_CPU_M)}m",
        "memory": f"{rng.choice(_MEM_MI)}Mi",
    }


def diverse_pods(count: int, rng: Optional[random.Random] = None) -> List[Pod]:
    rng = rng or random.Random(42)
    pods: List[Pod] = []
    seventh = count // 7

    for _ in range(seventh):  # generic
        pods.append(make_pod(labels=_random_labels(rng), requests=_requests(rng)))
    for key, spread in ((lbl.TOPOLOGY_ZONE, zone_spread), (lbl.HOSTNAME, hostname_spread)):
        for _ in range(seventh):  # topology spread
            sel = _random_labels(rng)
            pods.append(
                make_pod(
                    labels=sel,
                    requests=_requests(rng),
                    topology=[spread(max_skew=1, labels=sel)],
                )
            )
    for key in (lbl.HOSTNAME, lbl.TOPOLOGY_ZONE):  # pod affinity
        for _ in range(seventh):
            pods.append(
                make_pod(
                    labels=_random_labels(rng),
                    requests=_requests(rng),
                    pod_requirements=[
                        PodAffinityTerm(
                            label_selector=LabelSelector(match_labels=_random_labels(rng)),
                            topology_key=key,
                        )
                    ],
                )
            )
    for key in (lbl.HOSTNAME, lbl.TOPOLOGY_ZONE):  # pod anti-affinity
        for _ in range(seventh):
            pods.append(
                make_pod(
                    labels=_random_labels(rng),
                    requests=_requests(rng),
                    pod_anti_requirements=[
                        PodAffinityTerm(
                            label_selector=LabelSelector(match_labels=_random_labels(rng)),
                            topology_key=key,
                        )
                    ],
                )
            )
    while len(pods) < count:  # fill remainder with generic pods
        pods.append(make_pod(labels=_random_labels(rng), requests=_requests(rng)))
    return pods


def affinity_dense_pods(
    count: int,
    rng: Optional[random.Random] = None,
    frac: float = 0.5,
    group_size: int = 20,
) -> List[Pod]:
    """The affinity-dense regime (VERDICT r5 #1b): ``frac`` of the batch
    carries REQUIRED pod-(anti-)affinity across ``count*frac/group_size``
    distinct groups — the shape that maximizes the topology pre-assignment
    pass relative to the pack itself. Every 4th group is hostname
    anti-affinity (one pod per node, the most constrained rule); the rest
    are zone affinity (co-locate the group)."""
    rng = rng or random.Random(42)
    n_aff = int(count * frac)
    pods: List[Pod] = []
    g = 0
    while len(pods) < n_aff:
        sel = {"aff-group": f"g{g}"}
        if g % 4 == 3:
            term = dict(
                pod_anti_requirements=[
                    PodAffinityTerm(
                        label_selector=LabelSelector(match_labels=sel),
                        topology_key=lbl.HOSTNAME,
                    )
                ]
            )
        else:
            term = dict(
                pod_requirements=[
                    PodAffinityTerm(
                        label_selector=LabelSelector(match_labels=sel),
                        topology_key=lbl.TOPOLOGY_ZONE,
                    )
                ]
            )
        for _ in range(min(group_size, n_aff - len(pods))):
            pods.append(make_pod(labels=sel, requests=_requests(rng), **term))
        g += 1
    while len(pods) < count:
        pods.append(make_pod(labels=_random_labels(rng), requests=_requests(rng)))
    rng.shuffle(pods)
    return pods
