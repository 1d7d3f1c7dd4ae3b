"""The plain reference: the plan of one ``Scheduler.solve`` worked out again
from the generated pod and catalog records (``generate.py``), in plain
Python.

It imports nothing of the program and takes nothing the program made. It
follows the upstream scheduling core (``scheduler.go:64-137``: pods by cpu
then memory, descending; types by price, ascending; topology decisions as
just-in-time node selectors; first fit into the open nodes in the order
they opened, each node narrowing its instance types) and the topology rules
the program documents for spread and pod (anti-)affinity:

- affinity groups first, anti-affinity before affinity, each group in the
  order its first member appears in the sorted batch; then spread groups
  the same way;
- zone anti-affinity: each selector-matching member claims a free zone in
  name order, one free zone kept for the non-matching members when both
  kinds exist; the rest of the matchers are unplaceable; the non-matchers
  share the first zone no matcher holds;
- zone affinity: the most populated zone, else a zone seeded by a batch pod
  that matches the selector (a member first, then any pod of the batch);
- hostname anti-affinity: a fresh hostname per matching member, one shared
  fresh hostname for the rest; hostname affinity: one hostname for the group;
- zone spread: each pod to the zone with the fewest members so far, ties to
  the zone registered later; hostname spread: ``ceil(n / maxSkew)``
  hostnames from a pool the spread groups share, dealt round-robin when no
  member is pinned to a hostname, else by fewest members.

A pod's own node requirements (a record's ``node_selector`` and
``node_affinity``, on the five keys ``base_requirements`` layers from the
catalog) narrow it as requirements.go:78-110 layers them: for each key, the
catalog's values, ∩ each ``In`` set, − each ``NotIn`` set. The pod must keep
a value of each such set on an open node it joins (requirements.go:175-191),
and a node it opens starts from them; a pod whose set is empty, or that no
type admits, is unschedulable. A batch that holds pods with node
requirements beside pods of a topology kind raises ``ValueError``: the
program narrows spread domains by a pod's own requirements
(``scheduling/topology.py:969``) and reads a batch pod's own zone when it
seeds zone affinity, which the reference does not model; no public mix asks
for the combination yet.

The upstream iterates a map of zones, so spread ties depend on that order.
The program registers the zones from a Python set of the sorted zone names;
the reference iterates a set built the same way in the same process, which
gives the same order. Hostnames are compared only as which pods share one,
so the reference names them by a counter.

Quantities are exact: millicores, bytes and pod counts as Python integers,
as Kubernetes' quantities are. ``precision="bfloat16"`` is the control: the
same plan with every request, total and capacity held in bfloat16 (in
millicores, MiB and pods), which has to come out different.
"""

from __future__ import annotations

import math
import struct
from typing import Dict, List, Optional, Sequence, Tuple

ZONE = "topology.kubernetes.io/zone"
HOSTNAME = "kubernetes.io/hostname"
INSTANCE_TYPE = "node.kubernetes.io/instance-type"
ARCH = "kubernetes.io/arch"
OS = "kubernetes.io/os"
CAPACITY_TYPE = "karpenter.sh/capacity-type"
UNSATISFIABLE = "unsatisfiable.karpenter.sh"

MI = 2 ** 20


# -- the catalog ---------------------------------------------------------------


def base_requirements(types: Sequence[Dict]) -> Dict[str, frozenset]:
    """The catalog's values layered into the provisioner (requirements.go:25-47):
    each key an ``In`` set."""
    return {
        INSTANCE_TYPE: frozenset(t["name"] for t in types),
        ZONE: frozenset(z for t in types for _, z in t["offerings"]),
        CAPACITY_TYPE: frozenset(c for t in types for c, _ in t["offerings"]),
        ARCH: frozenset(t["arch"] for t in types),
        OS: frozenset(o for t in types for o in t["os"]),
    }


# the keys a pod's node requirements may name: those base_requirements layers
NODE_KEYS = (ZONE, CAPACITY_TYPE, ARCH, OS, INSTANCE_TYPE)


# -- pods ----------------------------------------------------------------------

# (anti, topology key) of each term kind
_TERMS = {
    "aff_host": (False, HOSTNAME), "aff_zone": (False, ZONE),
    "anti_host": (True, HOSTNAME), "anti_zone": (True, ZONE),
}
_SPREADS = {"zone_spread": ZONE, "host_spread": HOSTNAME}


def requests(rec: Dict) -> Tuple[int, int, int]:
    return (rec["cpu_m"], rec["mem_mi"] * MI, 1)


def selector_matches(sel: str, rec: Dict) -> bool:
    return rec["labels"].get("my-label") == sel


def has_node_requirements(rec: Dict) -> bool:
    return bool(rec.get("node_selector") or rec.get("node_affinity"))


def node_requirements(rec: Dict, base: Dict[str, frozenset]) -> Dict[str, frozenset]:
    """The pod's allowed set for each key its node requirements name: the
    catalog's values (``base``), ∩ each ``In`` set (a selector's value is
    one), − each ``NotIn`` set."""
    terms = [(k, "In", [v]) for k, v in (rec.get("node_selector") or {}).items()]
    terms += [tuple(t) for t in rec.get("node_affinity") or ()]
    own: Dict[str, frozenset] = {}
    for key, op, values in terms:
        if key not in NODE_KEYS:
            raise ValueError(f"a node requirement on {key!r}: the reference takes only "
                             f"{', '.join(NODE_KEYS)}")
        allowed = own.get(key, base[key])
        if op == "In":
            allowed = allowed & frozenset(values)
        elif op == "NotIn":
            allowed = allowed - frozenset(values)
        else:
            raise ValueError(f"a node requirement with the operator {op!r}: the reference "
                             "takes only In and NotIn")
        own[key] = allowed
    return own


def ffd_order(recs: Sequence[Dict]) -> List[int]:
    """Positions by cpu, then memory, descending; equal keys keep their order."""
    return sorted(range(len(recs)), key=lambda i: (-recs[i]["cpu_m"], -recs[i]["mem_mi"]))


# -- topology ------------------------------------------------------------------


class _Plan:
    """Per-pod decisions (position in the sorted batch -> {key: domain})
    and the hostnames drawn, in order."""

    def __init__(self):
        self.dec: Dict[int, Dict[str, str]] = {}
        self.hostnames: List[str] = []

    def get(self, p: int, key: str) -> Optional[str]:
        return self.dec.get(p, {}).get(key)

    def set(self, p: int, key: str, domain: str) -> None:
        self.dec.setdefault(p, {})[key] = domain

    def fresh(self, n: int) -> List[str]:
        names = [f"host-{len(self.hostnames) + k}" for k in range(n)]
        self.hostnames.extend(names)
        return names


def _provider(members, sel, batch, plan, key):
    """A batch pod the term's selector matches: a member first, then the
    first unpinned pod of the batch, then the first pinned one (returned
    with its domain, which the group adopts)."""
    for p in members:
        if selector_matches(sel, batch[p]):
            return p, plan.get(p, key)
    pinned = None
    for p in range(len(batch)):
        if not selector_matches(sel, batch[p]):
            continue
        if plan.get(p, key) is None:
            return p, None
        if pinned is None:
            pinned = p
    if pinned is not None:
        return pinned, plan.get(pinned, key)
    return None, None


def _zone_anti(members, sel, batch, plan, zones):
    counts: Dict[str, int] = {}
    matching = [p for p in members if selector_matches(sel, batch[p])]
    others = [p for p in members if not selector_matches(sel, batch[p])]

    def allowed(p, among):
        pin = plan.get(p, ZONE)
        return set(among) if pin is None else {d for d in among if d == pin}

    reserved = None
    if matching and others:
        best = None
        for d in sorted(z for z in zones if counts.get(z, 0) == 0):
            n_ok = sum(1 for p in others if allowed(p, {d}) == {d})
            # only a matcher pinned to ``d`` alone needs it
            m_only = sum(1 for p in matching if plan.get(p, ZONE) is not None
                         and allowed(p, zones) == {d})
            if n_ok and (best is None or (n_ok, -m_only) > (best[0], -best[1])):
                best = (n_ok, m_only, d)
        if best is not None:
            reserved = best[2]
    for p in matching:
        free = sorted(d for d in allowed(p, zones) if counts.get(d, 0) == 0 and d != reserved)
        d = free[0] if free else UNSATISFIABLE
        plan.set(p, ZONE, d)
        if d != UNSATISFIABLE:
            counts[d] = counts.get(d, 0) + 1
    for p in others:
        free = sorted(d for d in allowed(p, zones) if counts.get(d, 0) == 0)
        plan.set(p, ZONE, free[0] if free else UNSATISFIABLE)


def _zone_affinity(members, sel, batch, plan, zones):
    counts: Dict[str, int] = {}

    def most_populated(among):
        pop = sorted((d for d in among if counts.get(d, 0) > 0), key=lambda d: (-counts[d], d))
        return pop[0] if pop else None

    for p in members:
        pin = plan.get(p, ZONE)
        allowed = set(zones) if pin is None else {d for d in zones if d == pin}
        d = most_populated(allowed)
        if d is None:
            provider, pinned = _provider(members, sel, batch, plan, ZONE)
            if provider is None or not allowed:
                d = UNSATISFIABLE
            elif pinned is not None:
                d = pinned if pinned in allowed and pinned in zones else UNSATISFIABLE
            else:
                ppin = plan.get(provider, ZONE)
                joint = sorted(d for d in allowed if ppin is None or d == ppin)
                d = joint[0] if joint else UNSATISFIABLE
            if d != UNSATISFIABLE and provider != p:
                plan.set(provider, ZONE, d)
                counts[d] = counts.get(d, 0) + 1  # the provider matches the selector
        plan.set(p, ZONE, d)
        if d != UNSATISFIABLE and selector_matches(sel, batch[p]):
            counts[d] = counts.get(d, 0) + 1


def _host_anti(members, sel, batch, plan):
    matching = [selector_matches(sel, batch[p]) for p in members]
    n_match = sum(matching)
    names = plan.fresh(n_match + (1 if n_match < len(members) else 0))
    shared = names[n_match] if n_match < len(members) else None
    it = iter(names)
    for p, m in zip(members, matching):
        plan.set(p, HOSTNAME, next(it) if m else shared)


def _host_affinity(members, sel, batch, plan):
    provider, pinned = _provider(members, sel, batch, plan, HOSTNAME)
    if provider is None:
        for p in members:
            plan.set(p, ZONE, UNSATISFIABLE)
        return
    shared = pinned if pinned is not None else plan.fresh(1)[0]
    plan.set(provider, HOSTNAME, shared)
    for p in members:
        plan.set(p, HOSTNAME, shared)


def _fewest(spread: Dict[str, int], allowed: Optional[set]) -> str:
    """The domain with the fewest members, ties to the later one; ``None``
    allows every registered domain."""
    best, best_n = "", None
    for d, n in spread.items():
        if allowed is not None and d not in allowed:
            continue
        if best_n is None or n <= best_n:
            best, best_n = d, n
    spread[best] = spread.get(best, 0) + 1
    return best


def _spread(key, members, plan, zone_order, pool, max_skew=1):
    spread: Dict[str, int] = {}
    if key == HOSTNAME:
        n = math.ceil(len(members) / max(max_skew, 1))
        if len(pool) < n:
            pool.extend(plan.fresh(n - len(pool)))
        pinned = [plan.get(p, HOSTNAME) for p in members]
        for h in pinned:
            if h is not None:
                spread[h] = 0
        for h in pool[:n]:
            spread[h] = 0
        if all(h is None for h in pinned):
            domains = list(spread)
            for j, p in enumerate(members):
                plan.set(p, HOSTNAME, domains[j % len(domains)])
            return
    else:
        for z in zone_order:
            spread[z] = 0
    for p in members:
        pin = plan.get(p, key)
        allowed = None if pin is None else {d for d in spread if d == pin}
        plan.set(p, key, _fewest(spread, allowed))


def topology(batch: Sequence[Dict], zones: frozenset) -> _Plan:
    """Decisions for the sorted batch ``batch``."""
    plan = _Plan()
    aff: Dict[Tuple, List[int]] = {}
    spreads: Dict[Tuple, List[int]] = {}
    for p, rec in enumerate(batch):
        kind = rec["kind"]
        if kind in _TERMS:
            aff.setdefault((*_TERMS[kind], rec["sel"]), []).append(p)
        elif kind in _SPREADS:
            spreads.setdefault((_SPREADS[kind], rec["sel"]), []).append(p)
    # anti-affinity first; otherwise the order of first appearance
    for (anti, key, sel), members in sorted(aff.items(), key=lambda kv: not kv[0][0]):
        if key == ZONE:
            (_zone_anti if anti else _zone_affinity)(members, sel, batch, plan, zones)
        else:
            if anti:
                _host_anti(members, sel, batch, plan)
            else:
                _host_affinity(members, sel, batch, plan)
    zone_order = list(set(frozenset(sorted(zones))))
    pool: List[str] = []
    for (key, _sel), members in spreads.items():
        _spread(key, members, plan, zone_order, pool)
    return plan


# -- packing -------------------------------------------------------------------


def bfloat16(x: float) -> float:
    """``x`` rounded to the nearest bfloat16 (ties to even)."""
    (bits,) = struct.unpack("<I", struct.pack("<f", x))
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    return struct.unpack("<f", struct.pack("<I", bits))[0]


_SCALE = (1, MI, 1)  # millicores, MiB, pods: the units the control rounds in


class _Node:
    __slots__ = ("reqs", "total", "types", "pods", "room")

    def __init__(self, reqs, total, types):
        self.reqs = reqs
        self.total = total
        self.types = types
        self.pods: List[int] = []
        self.room = None


def _type_ok(t: Dict, reqs: Dict[str, frozenset]) -> bool:
    """The type's name, architecture and systems are allowed, and one of its
    offerings has an allowed zone and capacity type (requirements.go:49-66)."""
    if t["name"] not in reqs.get(INSTANCE_TYPE, ()):
        return False
    if t["arch"] not in reqs.get(ARCH, ()):
        return False
    if not (t["os"] & reqs.get(OS, frozenset())):
        return False
    zones, cts = reqs.get(ZONE, frozenset()), reqs.get(CAPACITY_TYPE, frozenset())
    return any(z in zones and c in cts for c, z in t["offerings"])


def solve(records: Sequence[Dict], catalog: Sequence[Dict], precision: str = "exact") -> Dict:
    """The plan for the round whose pods are ``records``, in the order the
    round handed them over. Returns ``{"nodes": [(positions, type names,
    (cpu_m, mem_bytes, pods)), ...], "unschedulable": sorted positions}``,
    positions indexing ``records``, nodes in the order they opened, pods in
    the order they joined."""
    types = sorted(catalog, key=lambda t: t["price"])
    base = base_requirements(types)
    order = ffd_order(records)
    batch = [records[i] for i in order]
    own_reqs = [node_requirements(rec, base) for rec in batch]
    topo = sorted({rec["kind"] for rec in batch if rec["kind"] in _TERMS or rec["kind"] in _SPREADS})
    pinned = [rec for rec in batch if has_node_requirements(rec)]
    for rec in pinned:
        if rec["kind"] in topo:
            raise ValueError(f"a pod with node requirements and the topology kind "
                             f"{rec['kind']!r}: the reference leaves the combination out")
    if pinned and topo:
        raise ValueError(f"a batch with pods that have node requirements beside pods of the "
                         f"topology kinds {', '.join(topo)}: the reference leaves the "
                         "combination out")
    plan = topology(batch, base[ZONE])
    if plan.hostnames:
        base = dict(base, **{HOSTNAME: frozenset(plan.hostnames)})

    exact = precision == "exact"
    if not exact and precision != "bfloat16":
        raise ValueError(f"unknown precision {precision!r}")

    def held(v: Tuple[int, int, int]):
        return v if exact else tuple(bfloat16(x / s) for x, s in zip(v, _SCALE))

    def add(a, b):
        return tuple(x + y for x, y in zip(a, b)) if exact else tuple(
            bfloat16(x + y) for x, y in zip(a, b))

    usable = [held(tuple(r - o for r, o in zip(t["res"], t["overhead"]))) for t in types]
    type_ok_memo: Dict[Tuple, frozenset] = {}

    def compatible_types(reqs) -> frozenset:
        # only these keys decide which types a node may take
        key = tuple(reqs.get(k) for k in (INSTANCE_TYPE, ARCH, OS, ZONE, CAPACITY_TYPE))
        hit = type_ok_memo.get(key)
        if hit is None:
            hit = type_ok_memo[key] = frozenset(
                j for j, t in enumerate(types) if _type_ok(t, reqs))
        return hit

    def fitting(candidates, total):
        return [j for j in candidates if all(a <= u for a, u in zip(total, usable[j]))]

    def room(type_ids):
        return tuple(max(usable[j][k] for j in type_ids) for k in range(3))

    nodes: List[_Node] = []
    unschedulable: List[int] = []
    zero = held((0, 0, 0))
    for p, rec in enumerate(batch):
        own = dict(own_reqs[p])
        for key, d in plan.dec.get(p, {}).items():
            own[key] = frozenset({d})
        req = held(requests(rec))
        placed = False
        for node in nodes:
            # requirement compatibility (requirements.go:175-191): a key the
            # pod names must keep a value on the node
            if any(not (v & node.reqs.get(k, frozenset())) for k, v in own.items()):
                continue
            total = add(node.total, req)
            if any(a > r for a, r in zip(total, node.room)):
                continue
            reqs = dict(node.reqs)
            for k, v in own.items():
                reqs[k] = reqs[k] & v
            ok = compatible_types(reqs)
            survivors = fitting([j for j in node.types if j in ok], total)
            if not survivors:
                continue
            node.reqs, node.total, node.types = reqs, total, survivors
            node.room = room(survivors)
            node.pods.append(p)
            placed = True
            break
        if placed:
            continue
        reqs = dict(base)
        for k, v in own.items():
            reqs[k] = reqs[k] & v if k in reqs else v
        total = add(zero, req)
        survivors = fitting(sorted(compatible_types(reqs)), total)
        if not survivors:
            unschedulable.append(order[p])
            continue
        node = _Node(reqs, total, survivors)
        node.room = room(survivors)
        node.pods.append(p)
        nodes.append(node)

    out_nodes = []
    for node in nodes:
        ids = [order[p] for p in node.pods]
        exact_total = [0, 0, 0]
        for i in ids:
            for k, v in enumerate(requests(records[i])):
                exact_total[k] += v
        out_nodes.append((ids, tuple(types[j]["name"] for j in node.types), tuple(exact_total)))
    return {"nodes": out_nodes, "unschedulable": sorted(unschedulable)}
