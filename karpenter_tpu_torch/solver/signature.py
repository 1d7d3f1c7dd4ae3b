"""Constraint signatures: the host-side half of the TPU solver.

A *core* is the canonical form of one pod's own scheduling requirements
(nodeSelector + folded node affinity), excluding the hostname key (hostname
has unbounded vocabulary and single-value join semantics, so the kernel
carries it as an int field instead).

A *signature* is the constraint state of a virtual node: the provisioner's
base constraints joined with the cores of every pod placed on it. Signatures
form a closure under join; the closure, the join table, each signature's
surviving instance types, and each signature's Pareto capacity frontier are
computed here with the exact ``Requirements`` algebra, so the device kernel
never needs to understand label semantics.

Mirrors the accept test of ``scheduling/node.go:46-66``:
  accept = (node has pods → Requirements.Compatible(node, pod))
           ∧ (∃ surviving instance type fitting requests)
Compatibility lives in the join table; type survival + fit live in the
frontier.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from collections import OrderedDict

import numpy as np

from karpenter_tpu_torch.api import labels as lbl
from karpenter_tpu_torch.api.objects import NodeSelectorRequirement, Pod
from karpenter_tpu_torch.api.provisioner import Constraints
from karpenter_tpu_torch.api.requirements import Requirements
from karpenter_tpu_torch.cloudprovider.requirements import compatible as type_compatible
from karpenter_tpu_torch.cloudprovider.types import InstanceType
from karpenter_tpu_torch.utils import resources as res

# A core: tuple of (key, operator, sorted values) triples, sorted by key then
# position — canonical and hashable.
Core = Tuple[Tuple[str, str, Tuple[str, ...]], ...]

MAX_SIGNATURES = 512  # closure cap; beyond this the backend falls back to FFD


def pod_core_and_hostname(pod: Pod) -> Tuple[Core, Optional[str]]:
    """Canonicalize a pod's own requirements, split into (core, hostname).

    Must fold exactly like ``Requirements.from_pod`` (nodeSelector + heaviest
    preferred term + first required term), but without building Requirements
    objects per pod — this runs for every pod in a 10k batch.
    """
    reqs: List[Tuple[str, str, Tuple[str, ...]]] = []
    hostname: Optional[str] = None
    for key, value in pod.spec.node_selector.items():
        key = lbl.NORMALIZED_LABELS.get(key, key)
        if key in lbl.IGNORED_LABELS:
            continue
        if key == lbl.HOSTNAME:
            hostname = value
            continue
        reqs.append((key, "In", (value,)))
    aff = pod.spec.affinity
    if aff is not None and aff.node_affinity is not None:
        na = aff.node_affinity
        terms: List[NodeSelectorRequirement] = []
        if na.preferred:
            heaviest = max(na.preferred, key=lambda t: t.weight)
            terms.extend(heaviest.preference.match_expressions)
        if na.required:
            terms.extend(na.required[0].match_expressions)
        for t in terms:
            key = lbl.NORMALIZED_LABELS.get(t.key, t.key)
            if key in lbl.IGNORED_LABELS:
                continue
            if key == lbl.HOSTNAME and t.operator == "In" and len(t.values) == 1:
                hostname = t.values[0]
                continue
            reqs.append((key, t.operator, tuple(t.values)))
    return tuple(sorted(reqs)), hostname


def core_to_requirements(core: Core) -> Requirements:
    return Requirements.new(
        *(NodeSelectorRequirement(key=k, operator=op, values=list(vals)) for k, op, vals in core)
    )


@dataclass
class Signature:
    """One node-constraint state in the closure."""

    sig_id: int
    requirements: Requirements  # base ⊕ joined cores (hostname-free)
    type_mask: np.ndarray  # [T] bool — types surviving requirement compat
    frontier: np.ndarray  # [F, R] f32 — Pareto-max usable capacities
    has_fit: bool  # any type survives at all


def _pareto_max(points: np.ndarray) -> np.ndarray:
    """Pareto-maximal rows of [n, R] (rows not dominated elementwise-≤ by
    another row), deduplicated. Broadcasted O(n²·R) numpy — this runs once
    per signature, inside the solve latency budget."""
    if len(points) == 0:
        return points
    points = np.unique(points, axis=0)  # dedupe (and sorts rows)
    ge = np.all(points[:, None, :] >= points[None, :, :], axis=-1)  # ge[j,i]: j ≥ i everywhere
    gt = np.any(points[:, None, :] > points[None, :, :], axis=-1)  # gt[j,i]: j > i somewhere
    dominated = np.any(ge & gt, axis=0)  # i dominated by some j
    return points[~dominated]


class SignatureTable:
    """Closure of node-constraint signatures under pod-core joins.

    Lazily materialized: signatures and join entries are computed on demand
    and memoized, so a solve only pays for the combinations its pods produce.
    """

    def __init__(
        self,
        base: Constraints,
        instance_types: Sequence[InstanceType],
        usable_capacity: np.ndarray,  # [T, R] capacity - overhead, f32
        resource_axes: Sequence[str],
    ):
        self.base = base
        self.instance_types = list(instance_types)
        self.usable = usable_capacity
        self.axes = list(resource_axes)
        self.signatures: List[Signature] = []
        self._sig_by_req_str: Dict[str, int] = {}
        self._open_cache: Dict[Core, int] = {}  # core -> sig id of base⊕core
        self._join_cache: Dict[Tuple[int, Core], int] = {}
        self._core_reqs: Dict[Core, Requirements] = {}
        self._mask_matrix: Optional[np.ndarray] = None
        # per-cores-vocabulary closure results (dense local reindex, join
        # table, frontiers, open sigs) — filled by encode; valid for the
        # table's lifetime because joins/signatures are append-only and
        # base-invariant (set_base only refreshes hostname state, which is
        # deliberately outside signatures)
        self._closure_memo: "OrderedDict[Tuple, Tuple]" = OrderedDict()
        # per-(closure, daemon, active-axes) TRIMMED catalog-side arrays —
        # filled by encode so steady-state solves return identity-stable
        # frontiers/daemon objects (a caller that fingerprints the catalog
        # side by id would otherwise re-hash the full tensors every batch)
        self._trim_memo: "OrderedDict[Tuple, Tuple]" = OrderedDict()
        # signature 0 is the base itself
        self._base_hostnames = base.requirements.get(lbl.HOSTNAME)
        self._intern(self._strip_hostname(base.requirements))

    def set_base(self, base: Constraints) -> None:
        """Refresh the per-solve hostname state on a table reused across
        solves (topology injection registers fresh generated hostnames into
        the constraints every batch; signatures themselves are
        hostname-free, so they stay valid)."""
        self.base = base
        self._base_hostnames = base.requirements.get(lbl.HOSTNAME)

    def type_mask_matrix(self) -> np.ndarray:
        """[S, T] stacked signature→type compatibility, cached until the
        closure grows — re-stacking per decode was a hot spot."""
        if self._mask_matrix is None or self._mask_matrix.shape[0] != len(self.signatures):
            self._mask_matrix = np.stack([s.type_mask for s in self.signatures])
        return self._mask_matrix

    # hostname is carried separately by the kernel; keep it out of signatures
    def _strip_hostname(self, reqs: Requirements) -> Requirements:
        return Requirements.new(
            *(r for r in reqs.requirements if r.key != lbl.HOSTNAME)
        )

    def hostname_in_base(self, hostname: str) -> bool:
        return self._base_hostnames.has(hostname)

    def _core_requirements(self, core: Core) -> Requirements:
        r = self._core_reqs.get(core)
        if r is None:
            r = core_to_requirements(core)
            self._core_reqs[core] = r
        return r

    def _intern(self, requirements: Requirements) -> int:
        key = str(requirements)
        sid = self._sig_by_req_str.get(key)
        if sid is not None:
            return sid
        if len(self.signatures) >= MAX_SIGNATURES:
            raise SignatureOverflow(f"signature closure exceeded {MAX_SIGNATURES}")
        type_mask = np.array(
            [type_compatible(it, requirements) for it in self.instance_types], dtype=bool
        )
        usable = self.usable[type_mask]
        frontier = _pareto_max(usable)
        sid = len(self.signatures)
        self.signatures.append(
            Signature(
                sig_id=sid,
                requirements=requirements,
                type_mask=type_mask,
                frontier=frontier,
                has_fit=bool(type_mask.any()),
            )
        )
        self._sig_by_req_str[key] = sid
        return sid

    def open_signature(self, core: Core) -> int:
        """Signature of a fresh node opened for a pod with this core: the
        base constraints merged with the pod's requirements. No compatibility
        check — the reference skips Compatible for a node's first pod
        (node.go:52-57); only type survival gates it (checked by the caller
        via the frontier)."""
        sid = self._open_cache.get(core)
        if sid is None:
            merged = self.signatures[0].requirements.add(
                *self._core_requirements(core).requirements
            )
            sid = self._intern(merged)
            self._open_cache[core] = sid
        return sid

    def join(self, sig_id: int, core: Core) -> int:
        """Join a pod core onto a node signature. Returns the joined
        signature id, or -1 if Requirements.Compatible rejects the pod
        (node.go:52-57 → requirements.go:175-191)."""
        key = (sig_id, core)
        out = self._join_cache.get(key)
        if out is None:
            node_reqs = self.signatures[sig_id].requirements
            pod_reqs = self._core_requirements(core)
            if node_reqs.compatible(pod_reqs):
                out = -1
            else:
                out = self._intern(node_reqs.add(*pod_reqs.requirements))
            self._join_cache[key] = out
        return out


class SignatureOverflow(Exception):
    """Raised when the constraint diversity of a batch exceeds the closure
    cap; the backend falls back to the host FFD path."""
