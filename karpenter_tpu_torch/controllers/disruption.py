"""The disruption-budget layer under voluntary consolidation (docs/consolidation.md).

Consolidation is the one controller that *chooses* to take capacity away,
so its blast radius needs an availability contract the involuntary paths
(interruption, expiry) never did: a provisioner-level
``maxUnavailable``-style budget — a count (``"3"``) or a percent
(``"20%"``) of the provisioner's nodes — enforced per wave AND across
concurrently-settling waves. Three pieces live here:

- :func:`parse_budget` / :func:`resolve_budget` — the budget grammar and
  its arithmetic. Percent budgets resolve with roundUp semantics against
  the CURRENT node count (the same ``intstr`` rule as PDB
  ``maxUnavailable`` — ``kube.client.resolve_pdb_threshold``), so a 10%
  budget on a 5-node cluster still allows one node. ``"0"`` (or ``"0%"``)
  is the explicit off switch: voluntary disruption disabled entirely.

- :class:`BudgetLedger` — the cross-wave account. A wave RESERVES its
  victims before touching them and RELEASES them only when the wave
  settles; two waves of the same provisioner in flight at once (shards
  rebalancing mid-wave, concurrent reconciles) draw from ONE account, so
  their union can never exceed the budget. The ledger is deliberately
  shareable: replicas in one process (tests, the bench storm) inject a
  common instance.

- :class:`InterruptionRiskTracker` — the ``poll_disruptions`` feedback
  loop. Every disruption notice bumps an EWMA per (capacity_type, zone);
  consolidation folds the risk into each node's disruption cost so the
  re-pack retires the capacity the cloud was going to take anyway first.

Plus :func:`pdb_frozen_pod_keys`, the plan-time victim screen: a pod whose
PDB currently allows ZERO disruptions freezes its node out of candidacy
*before* a wave starts — discovering the freeze at drain time strands a
cordoned node mid-wave with its replacement already paid for.
"""

from __future__ import annotations

import threading
from typing import Dict, Iterable, List, Optional, Set, Tuple

from karpenter_tpu_torch.kube.client import resolve_pdb_threshold

# Baseline interruption risk by capacity type, used before (and under) any
# live poll_disruptions signal: spot capacity is reclaimable by contract.
DEFAULT_RISK = {"spot": 0.15, "preemptible": 0.15, "on-demand": 0.02}
RISK_FALLBACK = 0.05
# EWMA smoothing for observed notices; one notice moves the needle, a
# quiet week decays it back toward the capacity-type baseline.
RISK_ALPHA = 0.3


def parse_budget(spec: Optional[str]) -> Optional[str]:
    """Validate and normalize one budget spec. Returns the normalized
    string (``"3"`` / ``"20%"``) or None for unset. Raises ValueError on
    anything else — a typo'd budget must fail admission, not silently
    disable the safety layer."""
    if spec is None:
        return None
    s = str(spec).strip()
    if not s:
        return None
    body = s[:-1] if s.endswith("%") else s
    try:
        value = int(body)
    except ValueError:
        raise ValueError(
            f"disruption budget must be a count or percent (got {spec!r})"
        )
    if value < 0:
        raise ValueError(f"disruption budget must be non-negative (got {spec!r})")
    if s.endswith("%") and value > 100:
        raise ValueError(f"disruption budget percent over 100 (got {spec!r})")
    return f"{value}%" if s.endswith("%") else str(value)


def resolve_budget(spec: Optional[str], total_nodes: int) -> Optional[int]:
    """How many of ``total_nodes`` may be disrupted concurrently. None =
    no budget configured (the caller falls back to its wave size). ``"0"``
    resolves to 0 — disruption disabled. Percent budgets use the PDB
    roundUp rule, with one exception: a NON-ZERO percent on a non-empty
    cluster never rounds below 1 (a budget meant to pace disruption must
    not quietly become the off switch on small clusters)."""
    if spec is None:
        return None
    allowed = resolve_pdb_threshold(spec, total_nodes)
    if allowed is None:
        return None
    if str(spec).strip().endswith("%"):
        pct = int(str(spec).strip()[:-1])
        if pct > 0 and total_nodes > 0:
            allowed = max(allowed, 1)
    return max(int(allowed), 0)


class BudgetLedger:
    """In-flight disrupted nodes per provisioner, across waves.

    ``reserve`` admits the longest prefix of ``names`` that keeps the
    provisioner's total in-flight count within ``allowed`` (prefix, not
    subset: callers pass victims cheapest-disruption-first, and the
    admitted set must honor that order). ``release`` returns capacity to
    the account when a wave settles — including partially, for victims
    that settle out-of-band."""

    def __init__(self):
        self._mu = threading.Lock()
        self._in_flight: Dict[str, Set[str]] = {}  # guarded-by: self._mu

    def reserve(
        self, provisioner: str, names: List[str], allowed: int
    ) -> List[str]:
        with self._mu:
            held = self._in_flight.setdefault(provisioner, set())
            room = max(allowed - len(held), 0)
            admitted = [n for n in names if n not in held][:room]
            held.update(admitted)
            return admitted

    def release(self, provisioner: str, names: Iterable[str]) -> None:
        with self._mu:
            held = self._in_flight.get(provisioner)
            if held is None:
                return
            held.difference_update(names)
            if not held:
                self._in_flight.pop(provisioner, None)

    def in_flight(self, provisioner: str) -> int:
        with self._mu:
            return len(self._in_flight.get(provisioner, ()))


class InterruptionRiskTracker:
    """EWMA of interruption pressure per (capacity_type, zone), fed by the
    interruption controller's notice stream. ``risk`` answers in [0, 1]:
    the probability-flavored score consolidation folds into disruption
    cost — capacity the cloud keeps reclaiming is cheap to retire
    voluntarily (it was leaving anyway)."""

    def __init__(self, alpha: float = RISK_ALPHA):
        self.alpha = alpha
        self._mu = threading.Lock()
        self._ewma: Dict[Tuple[str, str], float] = {}  # guarded-by: self._mu

    def observe(self, capacity_type: str, zone: str, signal: float = 1.0) -> None:
        key = (capacity_type or "", zone or "")
        with self._mu:
            cur = self._ewma.get(key, 0.0)
            self._ewma[key] = cur + self.alpha * (min(max(signal, 0.0), 1.0) - cur)

    def decay(self) -> None:
        """One quiet interval: every series relaxes toward 0."""
        with self._mu:
            for key in list(self._ewma):
                self._ewma[key] *= 1.0 - self.alpha
                if self._ewma[key] < 1e-4:
                    del self._ewma[key]

    def risk(self, capacity_type: str, zone: str) -> float:
        base = DEFAULT_RISK.get(capacity_type or "", RISK_FALLBACK)
        key = (capacity_type or "", zone or "")
        with self._mu:
            observed = self._ewma.get(key, 0.0)
        return min(max(base, observed), 1.0)


_default_risk_lock = threading.Lock()
_default_risk: Optional[InterruptionRiskTracker] = None


def risk_tracker() -> InterruptionRiskTracker:
    """The process-default tracker: the interruption controller feeds it,
    consolidation reads it — no wiring needed between the two."""
    global _default_risk
    with _default_risk_lock:
        if _default_risk is None:
            _default_risk = InterruptionRiskTracker()
        return _default_risk


def pdb_frozen_pod_keys(cluster) -> Set[str]:
    """Pod keys whose PodDisruptionBudget currently allows ZERO voluntary
    disruptions — the plan-time victim screen. Mirrors the apiserver's
    Evict math (``kube.client.Cluster.evict``): a pod is frozen when any
    matching PDB would refuse one more eviction right now. One pass over
    the PDBs, not per-candidate-node evict probes."""
    frozen: Set[str] = set()
    try:
        pdbs = cluster.list("pdbs")
    except Exception:
        return frozen
    if not pdbs:
        return frozen
    pods_by_ns: Dict[str, list] = {}
    for p in cluster.pods():
        pods_by_ns.setdefault(p.metadata.namespace, []).append(p)
    for pdb in pdbs:
        if pdb.selector is None:
            continue
        matching = [
            p
            for p in pods_by_ns.get(pdb.metadata.namespace, [])
            if pdb.selector.matches(p.metadata.labels)
        ]
        if not matching:
            continue
        healthy = [
            p for p in matching if p.metadata.deletion_timestamp is None
        ]
        min_avail = resolve_pdb_threshold(pdb.min_available, len(matching))
        max_unavail = resolve_pdb_threshold(pdb.max_unavailable, len(matching))
        allows_one = True
        if min_avail is not None and len(healthy) - 1 < min_avail:
            allows_one = False
        if max_unavail is not None and (
            len(matching) - (len(healthy) - 1)
        ) > max_unavail:
            allows_one = False
        if not allows_one:
            frozen.update(p.key for p in matching)
    return frozen
