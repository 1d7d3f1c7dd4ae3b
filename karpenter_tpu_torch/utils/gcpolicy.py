"""Controller-process GC policy (the port's copy of
``karpenter_tpu/utils/gcpolicy.py``).

A 10k-pod solve allocates hundreds of thousands of short-lived objects, all
freed by refcounting (the solve structures are acyclic) — yet every
allocation burst trips the cyclic collector, whose gen-2 passes scan the
whole warm heap (torch, the catalog, the signature tables, a large
cluster's objects). Those pauses land in the solve-latency tail.

``freeze_after_warmup`` is the Instagram/CPython-documented recipe: collect
once, ``gc.freeze()`` the warm heap into the permanent generation so later
collections never scan it, and raise the gen-0 threshold so collections are
rare. Cycles created afterwards are still collected — just less often and
against a small young heap.

Call it once, AFTER the warm heap actually exists — i.e. after the first
solve has run (a benchmark freezes after its warm-up solve; a controller
process freezes when the first provisioning worker reports warmed).
``restore`` undoes the policy (tests and scripts that freeze in-process
must not leak a frozen heap into the rest of the session).
"""

from __future__ import annotations

import gc
import threading

_lock = threading.Lock()
_frozen = False  # guarded-by: _lock
_saved_thresholds = None  # guarded-by: _lock


def freeze_after_warmup(gen0_threshold: int = 50000, unless=None) -> None:
    """``unless`` is an optional threading.Event checked INSIDE the lock:
    a canceller that sets the event and then calls ``restore`` can never
    lose to a freeze landing between its two steps (the check-then-freeze
    race the runtime's stop path must not have)."""
    global _frozen, _saved_thresholds
    with _lock:
        if _frozen or (unless is not None and unless.is_set()):
            return
        _saved_thresholds = gc.get_threshold()
        gc.collect()
        gc.freeze()
        gc.set_threshold(gen0_threshold, 20, 20)
        _frozen = True


def restore() -> None:
    """Unfreeze the permanent generation and restore the default
    thresholds (idempotent)."""
    global _frozen, _saved_thresholds
    with _lock:
        if not _frozen:
            return
        gc.unfreeze()
        if _saved_thresholds is not None:
            gc.set_threshold(*_saved_thresholds)
        _frozen = False
