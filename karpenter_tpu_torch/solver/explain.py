"""Constraint-elimination attribution: WHY a (pod, instance-type) pair died.

The packing kernel returns an assignment, never a reason — which makes the
single most-asked operational question ("why is my pod still pending?" /
"why THIS instance type?") unanswerable from the solver alone. This module
answers it from the tensors :mod:`solver.encode` already built, with cheap
mask reductions OFF the hot path:

- a pod's fresh-node signature (``pod_open_sig``) carries the exact
  requirement algebra the kernel solved with — its ``type_mask`` says which
  catalog types survive requirement compatibility, and replaying the
  per-key checks of ``cloudprovider.requirements.compatible`` against the
  signature's ``Requirements`` names the dimension that killed each
  excluded type (label requirement vs zone/capacity-type offering);
- the trimmed ``usable`` capacity matrix + ``pod_req`` + ``daemon`` split
  the resource story three ways: the type can't fit the pod at all
  (``resource_fit``), it fits the pod alone but not plus the daemon
  overhead (``daemon_overhead``), or — pod-level — no requirement-
  compatible type fits, i.e. the signature's Pareto capacity frontier
  admits nothing (``capacity_frontier``, the kernel's native formulation);
- ``pod_open_host == -2`` is the poisoned-hostname state (the pod pins a
  hostname the base domains exclude): ``hostname``.

Because everything here is a pure function of the ENCODED batch (host
context) plus the assignment — and every accelerated route (native,
device, pool, streamed, coalesced) is assignment-bit-exact by the parity
contract — the verdicts are identical regardless of which backend served
the solve. tests/test_explain.py pins the attribution against brute-force
single-constraint ablation re-solves on the native packer, and
tests/test_solver_stream.py pins streamed/coalesced parity.

The ``taint`` dimension never reaches the solver (selection's
``validate_pod`` gates intolerant pods before a batch forms); the decision
plane maps selection-level rejections onto it (obs/decisions.py).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from karpenter_tpu_torch.api import labels as lbl

# The elimination dimensions (one vocabulary: per-candidate reasons, pod
# top reasons, the karpenter_pods_unschedulable{reason} label, and the
# PodUnschedulable event message all use these tokens).
REASON_RESOURCE = "resource_fit"
REASON_REQUIREMENT = "requirement"
REASON_ZONE = "zone_topology"
REASON_DAEMON = "daemon_overhead"
REASON_FRONTIER = "capacity_frontier"
# hostname appears as a verdict ANNOTATION (a poisoned pin never
# eliminates a fresh-node placement — the reference skips compatibility
# for a node's first pod), kept in the vocabulary for the gauge label
REASON_HOSTNAME = "hostname"
REASON_TAINT = "taint"  # selection/admission layer (decisions.py maps it)

ALL_REASONS = (
    REASON_RESOURCE, REASON_REQUIREMENT, REASON_ZONE, REASON_DAEMON,
    REASON_FRONTIER, REASON_HOSTNAME, REASON_TAINT,
)

# per-pod candidate list cap: the COUNTS are always complete; the listed
# examples are bounded so a 400-type catalog never inflates a record
DEFAULT_MAX_CANDIDATES = 20


def _requirement_dimension(it, requirements, sets=None) -> Tuple[str, str]:
    """Which check of ``cloudprovider.requirements.compatible`` excluded
    this type from the signature — the same checks in the same order, so
    the attributed dimension is the one the encoder actually applied.
    Returns ``(reason, detail key)``. ``sets`` hoists the five ValueSet
    lookups out of a per-type loop."""
    if sets is None:
        sets = _req_sets(requirements)
    it_set, arch_set, os_set, zone_set, ct_set = sets
    if not it_set.has(it.name):
        return REASON_REQUIREMENT, lbl.INSTANCE_TYPE
    if not arch_set.has(it.architecture):
        return REASON_REQUIREMENT, lbl.ARCH
    if not os_set.has_any(it.operating_systems):
        return REASON_REQUIREMENT, lbl.OS
    for key, value in it.labels.items():
        if requirements.has(key) and not requirements.get(key).has(value):
            return REASON_REQUIREMENT, key
    if not any(
        zone_set.has(o.zone) and ct_set.has(o.capacity_type)
        for o in it.offerings
    ):
        return REASON_ZONE, lbl.TOPOLOGY_ZONE
    # compatible() said no but every individual check passes — cannot
    # happen while the two walks agree; report honestly rather than lie
    return REASON_REQUIREMENT, "unknown"


def _req_sets(requirements):
    return (
        requirements.get(lbl.INSTANCE_TYPE),
        requirements.get(lbl.ARCH),
        requirements.get(lbl.OS),
        requirements.get(lbl.TOPOLOGY_ZONE),
        requirements.get(lbl.CAPACITY_TYPE),
    )


def _sig_requirement_verdicts(sig, types) -> List[Optional[Tuple[str, str]]]:
    """Per-type requirement-family verdicts for one signature — ``None``
    for requirement-compatible types. MEMOIZED ON the Signature object:
    the verdicts are a pure function of (signature requirements, catalog),
    both fixed for the signature's lifetime (the SignatureTable pins its
    catalog), so steady-state rounds re-explaining the same signature pay
    one dict probe, not a 400-type replay — the explain hot-path budget
    (<1% of solve) depends on this."""
    cached = getattr(sig, "_explain_req_verdicts", None)
    if cached is not None and len(cached) == len(types):
        return cached
    sets = _req_sets(sig.requirements)
    mask = np.asarray(sig.type_mask, bool)
    verdicts: List[Optional[Tuple[str, str]]] = [
        None if mask[t]
        else _requirement_dimension(types[t], sig.requirements, sets)
        for t in range(len(types))
    ]
    try:
        sig._explain_req_verdicts = verdicts
    except AttributeError:
        pass  # a frozen/foreign signature object: just don't memoize
    return verdicts


def _binding_axes(usable_row, need, axis_names) -> List[str]:
    """The resource axes where the request exceeds this type's usable
    capacity — the concrete numbers behind a resource_fit verdict."""
    over = np.flatnonzero(np.asarray(need) > np.asarray(usable_row))
    return [axis_names[int(i)] for i in over]


# cross-round verdict memo capacity, kept on each SignatureTable (the
# table outlives batches via the EncodeCache, so steady-state rounds
# re-explaining the same (signature, request) pay one dict probe)
_VERDICT_MEMO_MAX = 64


def _verdict_core(batch, sig_id: int, need_alone, need_with, max_candidates):
    """The (pod-independent) elimination aggregation for one (signature,
    request vector): complete per-dimension counts + detail keys, the
    capped example-candidate list, viable-type count, and the frontier
    verdict. Memoized on the batch's SignatureTable keyed by (signature,
    request bytes) — the table pins catalog + usable + daemon context."""
    table = batch.table
    memo = getattr(table, "_explain_memo", None)
    if memo is None:
        from collections import OrderedDict as _OD

        memo = table._explain_memo = _OD()
    sig = batch.signatures[sig_id]
    # keyed by the SIGNATURE OBJECT, never the batch-local sig id: encode
    # re-indexes ids densely per core vocabulary, so the same local id
    # names different signatures across batches while this memo outlives
    # them on the shared table. The axis tuple pins the trimmed-axis
    # identity (same-length request bytes over different active axes must
    # not collide). Signature objects are table-held and append-only, so
    # their ids are stable for the memo's lifetime.
    key = (
        id(sig),
        need_alone.tobytes(),
        np.asarray(batch.daemon).tobytes(),
        tuple(batch.axis_names),
    )
    hit = memo.get(key)
    if hit is not None:
        memo.move_to_end(key)
        return hit
    types = table.instance_types
    usable = np.asarray(batch.usable)
    mask = np.asarray(sig.type_mask, bool)
    fit_alone = (usable >= need_alone).all(axis=1)
    fit_with = (usable >= need_with).all(axis=1)
    # the kernel's own gate: does ANY Pareto frontier row of this
    # signature admit the pod (request + daemon)?
    fr = np.asarray(batch.frontiers[sig_id])
    frontier_admits = bool((fr >= need_with).all(axis=-1).any())

    counts: Dict[str, int] = {}
    details: Dict[str, set] = {}
    candidates: List[Dict] = []

    def add(type_name: str, reason: str, detail: str) -> None:
        counts[reason] = counts.get(reason, 0) + 1
        if detail:
            details.setdefault(reason, set()).add(detail)
        if len(candidates) < max_candidates:
            candidates.append(
                {"type": type_name, "reason": reason, "detail": detail}
            )

    req_verdicts = _sig_requirement_verdicts(sig, types)
    for t in np.flatnonzero(~mask):
        reason, detail = req_verdicts[int(t)]
        add(types[int(t)].name, reason, detail)
    for t in np.flatnonzero(mask & ~fit_alone):
        axes = _binding_axes(usable[int(t)], need_alone, batch.axis_names)
        add(types[int(t)].name, REASON_RESOURCE, ",".join(axes))
    for t in np.flatnonzero(mask & fit_alone & ~fit_with):
        axes = _binding_axes(usable[int(t)], need_with, batch.axis_names)
        add(types[int(t)].name, REASON_DAEMON, ",".join(axes))
    viable = int((mask & fit_with).sum())

    top = top_reason(counts, viable=viable, frontier_admits=frontier_admits)
    sig_str = getattr(sig, "_explain_str", None)
    if sig_str is None:
        sig_str = str(sig.requirements)
        try:
            sig._explain_str = sig_str
        except AttributeError:
            pass
    # everything pod-independent lives in the memo — a steady-state round
    # re-explaining the same (signature, request) shape merges one dict
    out = {
        "signature": sig_str,
        "types_total": len(types),
        "viable_types": viable,
        "frontier_admits": frontier_admits,
        "reasons": counts,
        "reason_details": {k: sorted(v) for k, v in details.items()},
        "candidates": candidates,
        "top_reason": top,
        "message": reason_message(counts, top, viable=viable),
    }
    memo[key] = out
    while len(memo) > _VERDICT_MEMO_MAX:
        memo.popitem(last=False)
    return out


def explain_pod(
    batch,
    idx: int,
    max_candidates: int = DEFAULT_MAX_CANDIDATES,
) -> Dict:
    """Per-candidate elimination breakdown for one pod of the batch
    (``idx`` is the batch-local index, i.e. FFD solve order).

    Pure host numpy + the signature's Requirements object — no device, no
    wire, no route dependence. Candidate counts are complete; the listed
    example candidates are capped at ``max_candidates``. The per-
    (signature, request) aggregation is memoized on the batch's
    SignatureTable, so template-collapsed pods — and steady-state rounds
    re-explaining the same shapes — pay one dict probe."""
    table = batch.table
    types = table.instance_types
    pod = batch.pods[idx]
    sig_id = int(np.asarray(batch.pod_open_sig)[idx])

    need_alone = np.asarray(batch.pod_req)[idx]
    need_with = need_alone + np.asarray(batch.daemon)
    core = _verdict_core(batch, sig_id, need_alone, need_with, max_candidates)
    out = {"pod": pod.key, **core}
    if int(np.asarray(batch.pod_open_host)[idx]) == -2:
        # poisoned hostname pin (the pod's hostname is outside the base
        # domains): per the reference semantics a node's FIRST pod skips
        # the compatibility check (node.go:52-57), so the pin never
        # eliminates placement by itself — it only poisons the opened
        # node for later hostname-constrained peers. Annotation, not an
        # eliminator.
        hid = int(np.asarray(batch.pod_host)[idx])
        out["hostname_poisoned"] = (
            batch.hostnames[hid] if hid >= 0 else "?"
        )
    return out


def top_reason(
    counts: Dict[str, int], viable: int = 0, frontier_admits: bool = True
) -> str:
    """The single dominant dimension (the metrics label / event headline).

    ``capacity_frontier`` is the pod-level rollup for "requirement-
    compatible types exist, but none fits the request + daemon" — unless
    every compatible type fails even WITHOUT the daemon overhead
    (``resource_fit``) or every one fits alone and only the overhead kills
    it (``daemon_overhead``), which are the sharper verdicts."""
    if viable > 0:
        return ""  # a viable fresh-node type exists: not eliminated here
    if REASON_HOSTNAME in counts:
        return REASON_HOSTNAME
    req_family = {
        k: v for k, v in counts.items()
        if k in (REASON_REQUIREMENT, REASON_ZONE, REASON_TAINT)
    }
    res_family = {
        k: v for k, v in counts.items()
        if k in (REASON_RESOURCE, REASON_DAEMON)
    }
    if res_family and not frontier_admits:
        if REASON_RESOURCE not in counts:
            return REASON_DAEMON
        if REASON_DAEMON not in counts:
            return REASON_RESOURCE
        return REASON_FRONTIER
    if res_family:
        return REASON_FRONTIER
    if req_family:
        return max(req_family, key=req_family.get)
    return REASON_FRONTIER if not frontier_admits else ""


def reason_message(
    counts: Dict[str, int], top: str, viable: int = 0
) -> str:
    """Human headline, e.g. ``no type satisfies requirement ∧
    zone_topology`` — every dimension that eliminated at least one type,
    dominant first."""
    if viable > 0 or not counts:
        return "schedulable on a fresh node"
    parts = sorted(counts, key=counts.get, reverse=True)
    joined = " ∧ ".join(parts)
    if top and top not in parts:
        joined = f"{top} ({joined})"
    return f"no type satisfies {joined}"


def explain_batch(
    batch,
    assignment: Optional[np.ndarray] = None,
    only_unschedulable: bool = True,
    max_candidates: int = DEFAULT_MAX_CANDIDATES,
) -> List[Dict]:
    """Verdicts for a batch: by default only the pods the assignment left
    unplaced (``assignment < 0``; ``assignment=None`` = every pod, the
    pre-solve view)."""
    n = batch.n_pods
    if assignment is not None:
        a = np.asarray(assignment).reshape(-1)[:n]
        indices = (
            np.flatnonzero(a < 0).tolist() if only_unschedulable
            else list(range(n))
        )
    else:
        indices = list(range(n))
    out = []
    for i in indices:
        verdict = explain_pod(batch, int(i), max_candidates=max_candidates)
        if assignment is not None:
            placed = bool(np.asarray(assignment).reshape(-1)[i] >= 0)
            verdict["placed"] = placed
        out.append(verdict)
    return out
