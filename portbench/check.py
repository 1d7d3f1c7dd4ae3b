"""The comparison that decides ``correct``: a round's plan against the
reference's plan for the same pods.

The number compared is ``plan_mismatches``: the pods whose node differs
between the two plans, a node being (its pods in the order they joined,
its instance-type options in price order, its requests in millicores,
bytes and pods) and an unschedulable pod having none. The comparison is
exact, so its limit is 0.
"""

from __future__ import annotations

from typing import Dict, List, Optional

LIMIT = 0


def node_of(plan: Dict, n_pods: int) -> List[Optional[tuple]]:
    out: List[Optional[tuple]] = [None] * n_pods
    for ids, types, requests in plan["nodes"]:
        node = (tuple(ids), tuple(types), tuple(requests))
        for i in ids:
            if 0 <= i < n_pods:
                out[i] = node
    return out


def mismatches(got: Dict, want: Dict, n_pods: int) -> int:
    """Pods placed differently by the two plans. A pod that ``got`` places
    twice, or places though the round did not hand it over (a position
    outside ``range(n_pods)``), counts once more."""
    placed = [i for ids, _, _ in got["nodes"] for i in ids]
    inside = [i for i in placed if 0 <= i < n_pods]
    extra = len(placed) - len(set(inside))
    a, b = node_of(got, n_pods), node_of(want, n_pods)
    return extra + sum(1 for x, y in zip(a, b) if x != y)
