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
  ``reset()``;
- ``uploads`` and ``evictions`` count catalog tensors that crossed to the
  card and resident entries dropped (LRU pressure or TTL expiry).

Counters are process-global and kept in memory.
"""

from __future__ import annotations

import threading
from typing import Dict

_lock = threading.Lock()
_hits = 0  # guarded-by: _lock
_misses = 0  # guarded-by: _lock
_uploads = 0  # guarded-by: _lock
_evictions = 0  # guarded-by: _lock


def record(hit: bool) -> None:
    """One solve consulted the resident catalog: hit (tensors already on
    the card) or miss (an upload had to happen first)."""
    global _hits, _misses
    with _lock:
        if hit:
            _hits += 1
        else:
            _misses += 1


def record_upload() -> None:
    """Catalog-side tensors crossed to the card (an OpenSession upload or a
    DeviceInvariants upload)."""
    global _uploads
    with _lock:
        _uploads += 1


def record_eviction(n: int = 1) -> None:
    """Resident catalog entries dropped (LRU pressure or TTL expiry)."""
    global _evictions
    with _lock:
        _evictions += n


def snapshot() -> Dict[str, float]:
    """The counters and the derived hit rate (None before any solve)."""
    with _lock:
        hits, misses, uploads, evictions = _hits, _misses, _uploads, _evictions
    total = hits + misses
    return {
        "hits": hits,
        "misses": misses,
        "hit_rate": (hits / total) if total else None,
        "uploads": uploads,
        "evictions": evictions,
    }


def reset() -> None:
    """Restart the window (after a warm-up, so the rate read is the steady
    state's)."""
    global _hits, _misses, _uploads, _evictions
    with _lock:
        _hits = _misses = _uploads = _evictions = 0
