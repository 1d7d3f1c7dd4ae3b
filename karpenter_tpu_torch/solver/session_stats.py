"""Process-wide catalog-residency accounting for the solver transport.

The sidecar's session store (``service.SolverService``) and the in-process
invariants cache (``fused.DeviceInvariants``) keep the catalog-side tensors
(join table, frontiers, daemon vector) resident on the card. Both report
their hit, miss, upload and eviction events here, so one snapshot answers
whether a steady-state solve ships catalog bytes or only the pod side:

- a **hit** = a solve served against already-resident catalog tensors;
- a **miss** = the solve found its catalog not resident (an unknown key,
  an evicted entry, a restarted sidecar) and an upload had to happen;
- ``hit_rate`` = hits / (hits + misses) since process start or the last
  ``reset()``.

Hits and misses are process-global counters. Uploads (catalog tensors that
crossed to the card) and evictions (resident entries dropped under LRU
pressure or TTL expiry) are counted only by their metric families
(``karpenter_solver_session_catalog_uploads_total``,
``karpenter_solver_session_evictions_total``); the hit rate is a gauge too,
and a hit or miss feeds the SLO engine's ``session.catalog_hit_rate``
objective.
"""

from __future__ import annotations

import threading
from typing import Dict

_lock = threading.Lock()
_hits = 0  # guarded-by: _lock
_misses = 0  # guarded-by: _lock


def record(hit: bool) -> None:
    """One solve consulted the resident catalog: hit (tensors already on
    the card) or miss (an upload had to happen first)."""
    from karpenter_tpu_torch import metrics, obs

    global _hits, _misses
    with _lock:
        if hit:
            _hits += 1
        else:
            _misses += 1
        # set under the lock so two racing records cannot publish their
        # snapshots out of order and leave a stale value
        metrics.SOLVER_SESSION_HIT_RATE.set(_hits / (_hits + _misses))
    # the SLO engine judges `session.catalog_hit_rate` from the same event
    # stream (outside the lock: the engine has its own)
    eng = obs.slo_engine()
    if eng is not None:
        eng.record_ratio("session.catalog_hit_rate", hit)


def record_upload() -> None:
    """Catalog-side tensors crossed to the card (an OpenSession upload or a
    DeviceInvariants upload)."""
    from karpenter_tpu_torch import metrics

    metrics.SOLVER_SESSION_UPLOADS.inc()


def record_eviction(n: int = 1) -> None:
    """Resident catalog entries dropped (LRU pressure or TTL expiry)."""
    from karpenter_tpu_torch import metrics

    metrics.SOLVER_SESSION_EVICTIONS.inc(n)


def snapshot() -> Dict[str, float]:
    """The counters and the derived hit rate (None before any solve)."""
    with _lock:
        hits, misses = _hits, _misses
    total = hits + misses
    return {
        "hits": hits,
        "misses": misses,
        "hit_rate": (hits / total) if total else None,
    }


def reset() -> None:
    """Restart the window (after a warm-up, so the rate read is the steady
    state's)."""
    global _hits, _misses
    with _lock:
        _hits = _misses = 0
