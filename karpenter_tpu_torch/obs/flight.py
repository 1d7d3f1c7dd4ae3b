"""The slow-solve flight recorder.

When a watched span (default: ``solver.solve``, the end-to-end accelerated
solve) exceeds its latency budget (default: the 100ms BASELINE p99), the
COMPLETED span tree plus a snapshot of the routing/breaker/session state
that shaped the solve is written to a capped on-disk ring under
``--flight-dir``. The point is post-hoc forensics: by the time a p99 alert
fires, the interesting solve is long gone from the in-memory trace ring —
the flight dir holds exactly the slow ones, each with the context a human
would have asked for ("what did the router believe? was a breaker open?
was the session cache thrashing?").

State providers are registered module-globally (``register_state``):
the scheduler registers its router/breaker/session views at construction,
and the recorder snapshots whatever is registered AT RECORD TIME — a
provider that raises contributes its error string instead of aborting the
record (a flight record with one missing panel beats no record).

``GET /debug/flight`` on the sidecar's health server lists :meth:`recent`.
The JAX package's wire-dominance watch rule and incident pins are not
ported yet.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from karpenter_tpu_torch.obs.trace import Span

logger = logging.getLogger("karpenter.obs")

DEFAULT_BUDGET_S = 0.100  # the BASELINE <100ms p99 target
DEFAULT_CAP = 64
DEFAULT_WATCH = ("solver.solve",)

# name -> zero-arg callable returning a JSON-serializable snapshot
_state_lock = threading.Lock()
_state_providers: Dict[str, Callable[[], Any]] = {}  # guarded-by: _state_lock


def register_state(name: str, provider: Callable[[], Any]) -> None:
    """Expose one panel of process state to future flight records (router
    EMAs, breaker states, session-cache disposition...). Re-registering a
    name replaces the provider — schedulers hot-swap."""
    with _state_lock:
        _state_providers[name] = provider


def unregister_state(name: str) -> None:
    """Drop one panel (tests, and engine teardown in reset_for_tests)."""
    with _state_lock:
        _state_providers.pop(name, None)


def state_snapshot(only=None) -> Dict[str, Any]:
    """Best-effort snapshot of every registered panel: a raising provider
    contributes its error string (and counts on
    ``karpenter_flight_panel_errors_total``) instead of aborting the
    record — the span tree a flight record exists for must never be lost
    to one broken panel callback. ``only`` restricts to a subset of panel
    names (the decision audit log snapshots just the brownout panel, not
    the full router/breaker/session spread a flight record wants)."""
    with _state_lock:
        providers = dict(_state_providers)
    if only is not None:
        providers = {k: v for k, v in providers.items() if k in only}
    out: Dict[str, Any] = {}
    for name, fn in providers.items():
        try:
            out[name] = fn()
        except Exception as e:
            out[name] = f"<state provider failed: {e}>"
            try:
                from karpenter_tpu_torch import metrics

                metrics.FLIGHT_PANEL_ERRORS.labels(panel=name).inc()
            except Exception:
                pass  # trimmed registries
    return out


class FlightRecorder:
    """Span-completion hook (``tracer.add_hook``) + the on-disk ring."""

    def __init__(
        self,
        directory: str,
        budget_s: float = DEFAULT_BUDGET_S,
        cap: int = DEFAULT_CAP,
        watch=DEFAULT_WATCH,
    ):
        self.directory = directory
        self.budget_s = budget_s
        self.cap = cap
        self.watch = frozenset(watch)
        self.records_written = 0
        self._lock = threading.Lock()
        os.makedirs(directory, exist_ok=True)

    # -- the hook -----------------------------------------------------------
    def __call__(self, span: Span) -> None:
        if span.name in self.watch and span.duration_s > self.budget_s:
            self.record(span)

    def record(self, span: Span) -> Optional[str]:
        """Write one incident; returns the file path (None on failure —
        recording must never fail the traced action)."""
        try:
            payload = {
                "name": span.name,
                "trace_id": span.trace_id,
                "duration_s": round(span.duration_s, 6),
                "budget_s": self.budget_s,
                "recorded_at": time.time(),
                "trace": span.to_dict(),
                "state": state_snapshot(),
            }
            with self._lock:
                # millisecond wall stamp + write sequence in the name:
                # lexicographic order IS recency order (prune and recent()
                # rely on it), and the sequence breaks same-millisecond
                # ties deterministically — two back-to-back records used
                # to tie-break on the random trace-id suffix
                fname = (
                    f"flight-{int(time.time() * 1e3):013d}"
                    f"-{self.records_written % 1_000_000:06d}"
                    f"-{span.trace_id[:8]}.json"
                )
                path = os.path.join(self.directory, fname)
                with open(path, "w", encoding="utf-8") as f:
                    json.dump(payload, f)
                self.records_written += 1
                self._prune_locked()
            try:
                from karpenter_tpu_torch import metrics

                metrics.FLIGHT_RECORDS.inc()
            except Exception:
                pass
            logger.info(
                "flight record: %s took %.1fms (budget %.1fms) -> %s",
                span.name, span.duration_s * 1e3, self.budget_s * 1e3, path,
            )
            return path
        except Exception:
            logger.debug("flight record write failed", exc_info=True)
            return None

    def _prune_locked(self) -> None:
        names = sorted(
            n for n in os.listdir(self.directory)
            if n.startswith("flight-") and n.endswith(".json")
        )
        excess = max(len(names) - self.cap, 0)
        for victim in names[:excess]:
            try:
                os.remove(os.path.join(self.directory, victim))
            except OSError:
                pass

    # -- the /debug/flight surface ------------------------------------------
    def recent(self, limit: int = 20) -> List[Dict[str, Any]]:
        try:
            names = sorted(
                (
                    n for n in os.listdir(self.directory)
                    if n.startswith("flight-") and n.endswith(".json")
                ),
                reverse=True,
            )[:limit]
        except OSError:
            return []
        out = []
        for n in names:
            try:
                with open(os.path.join(self.directory, n), encoding="utf-8") as f:
                    out.append(json.load(f))
            except Exception:
                continue  # a half-written or pruned-under-us file
        return out
