"""Pack-integrity bookkeeping: the screen, the canary's comparator, and the
quarantine audit.

The two host-side detection layers over every accelerated pack result, and
the shared accounting they report into:

- :func:`screen_result` — a cheap NaN/bounds screen over every result the
  card (or its plain version) served, before decode: a kernel can produce
  plausible-shaped garbage that only content checks catch.
- :func:`compare_results` — the canary cross-check's comparator. The native
  C++ packer is bit-identical to both kernels by contract, so a canary
  re-solve that disagrees with the served pack is evidence of corruption,
  not of tie-breaking drift.
- :func:`record_checksum_failure` / :func:`record_session_mismatch` — the
  sidecar wire's own detections (a frame whose checksum failed, a Pack that
  echoed the wrong catalog session), attributed to the sidecar's address.
- :func:`snapshot` / :func:`totals` — the counters, read without a scrape.

Counters are process-global (one scheduler per worker, many workers per
process), kept in memory and mirrored on the ``karpenter_solver_integrity_*``
metric families.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

import numpy as np

_mu = threading.Lock()
_counts: Dict[str, Dict[str, int]] = {
    "checksum_failures": {},
    "session_mismatches": {},
    "canary_solves": {},
    "canary_mismatches": {},
    "screen_failures": {},
    "quarantines": {},
}  # guarded-by: _mu
_quarantine_log: List[dict] = []  # guarded-by: _mu (last N quarantine events)
_QUARANTINE_LOG_MAX = 32


def _bump(kind: str, address: str) -> None:
    key = address or "local"
    with _mu:
        table = _counts[kind]
        table[key] = table.get(key, 0) + 1


def _metric(name: str, address: str) -> None:
    """The Prometheus mirror of one counter bump (``karpenter_solver_integrity_*``)."""
    from karpenter_tpu_torch import metrics

    getattr(metrics, name).labels(address=address or "local").inc()


def record_checksum_failure(address: str) -> None:
    _bump("checksum_failures", address)
    _metric("SOLVER_INTEGRITY_CHECKSUM_FAILURES", address)


def record_session_mismatch(address: str) -> None:
    _bump("session_mismatches", address)
    _metric("SOLVER_INTEGRITY_SESSION_MISMATCHES", address)


def record_canary(address: str, mismatch: bool) -> None:
    _bump("canary_solves", address)
    _metric("SOLVER_INTEGRITY_CANARY_SOLVES", address)
    if mismatch:
        _bump("canary_mismatches", address)
        _metric("SOLVER_INTEGRITY_CANARY_MISMATCHES", address)


def record_screen_failure(address: str) -> None:
    _bump("screen_failures", address)
    _metric("SOLVER_INTEGRITY_SCREEN_FAILURES", address)


def record_quarantine(address: str, reason: str, detail: str = "") -> None:
    _bump("quarantines", address)
    _metric("SOLVER_INTEGRITY_QUARANTINES", address)
    with _mu:
        _quarantine_log.append({
            "address": address or "local",
            "reason": reason,
            "detail": detail[:200],
            "t": time.time(),
        })
        del _quarantine_log[:-_QUARANTINE_LOG_MAX]


def snapshot() -> dict:
    """Every counter by address, and the last quarantines."""
    with _mu:
        return {
            **{k: dict(v) for k, v in _counts.items()},
            "recent_quarantines": list(_quarantine_log[-8:]),
        }


def totals() -> Dict[str, int]:
    """Per-kind totals summed over addresses."""
    with _mu:
        return {k: sum(v.values()) for k, v in _counts.items()}


def reset() -> None:
    """Test isolation: zero the in-memory counters and the quarantine log."""
    with _mu:
        for table in _counts.values():
            table.clear()
        del _quarantine_log[:]


# ---------------------------------------------------------------------------
# host-side content checks
# ---------------------------------------------------------------------------


def screen_result(result, n_pods: int) -> Optional[str]:
    """NaN/bounds screen over a host-side PackResult. Returns a description
    of the first violation, or None.

    Deliberately about REPRESENTATION, not semantics: semantics (capacity,
    double placement) is ``_validate_pack``'s decoded-plan job. This catches
    what decode would silently launder into the plan — non-finite node
    requests, assignments pointing outside the node table, an impossible
    node count."""
    assignment, node_sig, node_host, node_req, n_nodes_arr = result
    n_max = int(np.asarray(node_sig).shape[0])
    n_nodes = np.asarray(n_nodes_arr).reshape(-1)[0]
    if not np.isfinite(float(n_nodes)):
        return "n_nodes is not finite"
    n_nodes = int(n_nodes)
    if not 0 <= n_nodes <= n_max:
        return f"n_nodes {n_nodes} outside [0, {n_max}]"
    a = np.asarray(assignment)[:n_pods]
    if a.size and (int(a.max(initial=-1)) >= n_nodes or int(a.min(initial=0)) < -1):
        return (
            f"assignment outside [-1, {n_nodes}) "
            f"(min {int(a.min())}, max {int(a.max())})"
        )
    req = np.asarray(node_req)[:max(n_nodes, 0)]
    if req.size and not np.isfinite(req).all():
        return "node_req contains non-finite values"
    if req.size and float(req.min(initial=0.0)) < 0:
        return "node_req contains negative totals"
    host = np.asarray(node_host)[:max(n_nodes, 0)]
    if host.size and not np.isfinite(host.astype(np.float64)).all():
        return "node_host contains non-finite values"
    return None


def compare_results(served, reference, n_pods: int) -> Optional[str]:
    """Canary comparator: the served pack vs the native re-solve of the
    SAME encoded batch at the SAME node-table size. Native/kernel parity is
    bit-identical by contract, so any divergence is a finding. Returns the
    first difference, or None."""
    s_assign, s_sig, s_host, s_req, s_n = served
    r_assign, r_sig, r_host, r_req, r_n = reference
    sn, rn = (
        int(np.asarray(s_n).reshape(-1)[0]),
        int(np.asarray(r_n).reshape(-1)[0]),
    )
    if sn != rn:
        return f"n_nodes differs (served {sn}, native {rn})"
    if not np.array_equal(
        np.asarray(s_assign)[:n_pods], np.asarray(r_assign)[:n_pods]
    ):
        return "assignment differs"
    if not np.array_equal(np.asarray(s_sig)[:sn], np.asarray(r_sig)[:sn]):
        return "node signatures differ"
    if not np.array_equal(np.asarray(s_host)[:sn], np.asarray(r_host)[:sn]):
        return "node hostnames differ"
    if not np.allclose(
        np.asarray(s_req)[:sn], np.asarray(r_req)[:sn],
        rtol=1e-5, atol=1e-5, equal_nan=False,
    ):
        return "node request totals differ"
    return None
