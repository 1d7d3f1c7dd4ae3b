"""Minimal-move matching + disruption cost for whole-cluster re-pack.

The consolidation controller already solves the *entire* candidate set
through the normal solver routes (native/device/pool/streamed — the
proposal inherits bit-exact route parity from the scheduler, so no route
logic lives here). What the raw proposal lacks is the robustness
objective: the solver prices CAPACITY, not CHURN. A proposed packing that
reshuffles every pod to save one node is a worse wave than one that
leaves most nodes untouched — every move is an eviction, a recreation,
and a window where the workload runs below replicas.

This module turns a priced proposal into a minimal-move wave:

- :func:`minimal_move_match` pairs proposed virtual nodes with existing
  candidate nodes that already hold exactly that packing. A matched node
  is KEPT (zero moves — it is its own replacement); only the unmatched
  remainder is retired and launched. The match key is (chosen instance
  type, resident pod set), so correctness does not depend on solver
  ordering.

- :func:`disruption_cost` scores each retired node so waves drain the
  cheapest disruption first: scale by the node's hourly price, discount
  capacity the cloud is likely to reclaim anyway (the
  ``poll_disruptions``-fed interruption risk — a spot node under active
  reclaim pressure is nearly free to retire voluntarily), and charge per
  resident pod for the moves themselves.

Everything here is deterministic host-side arithmetic over the solver's
output — it runs identically whichever route produced the proposal.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

from karpenter_tpu_torch.api import labels as lbl
from karpenter_tpu_torch.api.objects import Node, Pod
from karpenter_tpu_torch.scheduling.ffd import VirtualNode

# Each pod move costs this many $/hr-equivalents in the disruption score:
# enough that a node with many pods outranks a slightly pricier empty one,
# small enough that price still dominates across instance-type tiers.
MOVE_COST = 0.01


@dataclass
class RepackMatch:
    """The minimal-move view of one proposal: ``keep`` nodes already hold
    their proposed packing verbatim; ``retire`` nodes drain (their pods
    are the ``moves``); ``launch`` virtual nodes are the capacity that
    must actually be built."""

    keep: List[Node] = field(default_factory=list)
    retire: List[Node] = field(default_factory=list)
    launch: List[VirtualNode] = field(default_factory=list)
    moves: List[Pod] = field(default_factory=list)


def _pod_key(p: Pod) -> Tuple[str, str]:
    return (p.metadata.namespace, p.metadata.name)


def _vnode_signature(v: VirtualNode) -> Tuple[str, frozenset]:
    itype = v.instance_type_options[0].name if v.instance_type_options else ""
    return (itype, frozenset(_pod_key(p) for p in v.pods))


def minimal_move_match(
    nodes: List[Node],
    node_pods: Dict[str, List[Pod]],
    proposed: List[VirtualNode],
) -> RepackMatch:
    """Pair proposed virtual nodes with existing candidates that already
    hold exactly that packing (same chosen instance type, same resident
    pod set). ``node_pods`` maps node name -> that node's reschedulable
    pods (the same set the plan fed the solver). Matching is greedy over
    a signature index — O(nodes + proposed) — and deterministic: ties
    between identical nodes break by node name."""
    match = RepackMatch()
    # signature -> existing nodes holding it, name-ordered for determinism
    by_sig: Dict[Tuple[str, frozenset], List[Node]] = {}
    for n in sorted(nodes, key=lambda n: n.metadata.name):
        sig = (
            n.metadata.labels.get(lbl.INSTANCE_TYPE, ""),
            frozenset(_pod_key(p) for p in node_pods.get(n.metadata.name, [])),
        )
        by_sig.setdefault(sig, []).append(n)
    for v in proposed:
        pool = by_sig.get(_vnode_signature(v))
        if pool:
            match.keep.append(pool.pop(0))
        else:
            match.launch.append(v)
    kept = {n.metadata.name for n in match.keep}
    for n in nodes:
        if n.metadata.name not in kept:
            match.retire.append(n)
            match.moves.extend(node_pods.get(n.metadata.name, []))
    return match


def disruption_cost(
    node: Node, node_pods: List[Pod], price: float, risk: float
) -> float:
    """The per-node disruption-cost dimension: what retiring this node
    costs in availability terms. Lower = retire first. ``risk`` is the
    interruption-risk score in [0, 1] for the node's (capacity_type,
    zone) — high-risk capacity is discounted because the cloud was going
    to take it anyway, so the voluntary wave should spend its budget
    there."""
    risk = min(max(risk, 0.0), 1.0)
    return max(price, 0.0) * (1.0 - risk) + MOVE_COST * len(node_pods)


def order_retirement(
    retire: List[Node],
    node_pods: Dict[str, List[Pod]],
    price_by_type: Dict[str, float],
    risk_fn,
) -> List[Node]:
    """Retired nodes ordered cheapest-disruption-first (ties by name for
    determinism). ``risk_fn(capacity_type, zone) -> float`` is normally
    ``InterruptionRiskTracker.risk``."""

    def cost(n: Node) -> Tuple[float, str]:
        labels = n.metadata.labels
        price = price_by_type.get(labels.get(lbl.INSTANCE_TYPE, ""), 0.0)
        risk = risk_fn(
            labels.get(lbl.CAPACITY_TYPE, ""), labels.get(lbl.TOPOLOGY_ZONE, "")
        )
        return (
            disruption_cost(n, node_pods.get(n.metadata.name, []), price, risk),
            n.metadata.name,
        )

    return sorted(retire, key=cost)
