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

# wire-dominance watch rule: a solve whose TRANSPORT
# self-time exceeds its device/solve share is a transport regression the
# latency budget alone can hide (a fast solve over a slow wire can still
# land under 100ms) — it self-reports as a flight record tagged
# ``wire_dominated=true`` even when under budget. The floor keeps
# microsecond-scale loopback noise from spamming the ring, and the
# cooldown keeps a STEADY wire-dominated regime (every solve matching)
# from turning the hot solve path into per-solve disk writes — one
# record per window names the regression; the rest add nothing.
MIN_WIRE_DOMINANCE_S = 0.005
WIRE_DOMINANCE_COOLDOWN_S = 30.0
# the transport leg and the sidecar stages it grafts/stitches beneath it
WIRE_SPAN = "solver.wire"
SOLVE_SHARE_SPANS = frozenset({"sidecar.solve", "sidecar.fetch"})


def _walk(span: Span):
    yield span
    for child in span.children:
        yield from _walk(child)


def wire_dominance(span: Span) -> Optional[Dict[str, float]]:
    """For a ``solver.solve`` tree: the wire's SELF time (the
    ``solver.wire`` spans minus their grafted/stitched sidecar children)
    vs the device/solve share (``sidecar.solve`` + ``sidecar.fetch``).
    None when the solve never crossed a wire (in-process backends)."""
    wire_self = 0.0
    solve_share = 0.0
    crossed = False
    for s in _walk(span):
        if s.name == WIRE_SPAN:
            crossed = True
            wire_self += max(
                s.duration_s - sum(c.duration_s for c in s.children), 0.0
            )
        elif s.name in SOLVE_SHARE_SPANS:
            solve_share += s.duration_s
    if not crossed:
        return None
    return {
        "wire_self_s": round(wire_self, 6),
        "solve_share_s": round(solve_share, 6),
    }

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
        self._last_rule_record = 0.0  # guarded-by: self._lock
        # filename -> incident id: records pinned against pruning because
        # an incident record references them (obs/incidents.py); bounded —
        # the oldest pins release once PIN_CAP incidents have come and gone
        self._pinned: Dict[str, str] = {}  # guarded-by: self._lock
        os.makedirs(directory, exist_ok=True)

    def _rule_cooled_down(self) -> bool:
        now = time.monotonic()
        with self._lock:
            if now - self._last_rule_record < WIRE_DOMINANCE_COOLDOWN_S:
                return False
            self._last_rule_record = now
            return True

    # -- the hook -----------------------------------------------------------
    def __call__(self, span: Span) -> None:
        if span.name not in self.watch:
            return
        extra = None
        if span.name == "solver.solve":
            shares = wire_dominance(span)
            if shares is not None and shares["wire_self_s"] > max(
                shares["solve_share_s"], MIN_WIRE_DOMINANCE_S
            ):
                extra = {"wire_dominated": True, **shares}
        over_budget = span.duration_s > self.budget_s
        if not over_budget and extra is not None and not self._rule_cooled_down():
            return  # steady wire-dominance: one record per cooldown window
        if over_budget or extra is not None:
            self.record(span, extra=extra)

    def record(self, span: Span, extra: Optional[Dict[str, Any]] = None) -> Optional[str]:
        """Write one incident; returns the file path (None on failure —
        recording must never fail the traced action). ``extra`` merges
        watch-rule verdicts (e.g. ``wire_dominated``) into the payload."""
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
            if extra:
                payload.update(extra)
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
        removed = 0
        for victim in names:
            if removed >= excess:
                break
            if victim in self._pinned:
                continue  # incident evidence outlives the ring's age-out
            try:
                os.remove(os.path.join(self.directory, victim))
            except OSError:
                pass
            removed += 1

    # -- the incident plane's evidence hook ----------------------------------
    PIN_CAP = 16

    def pin_for_incident(
        self, incident_id: str, limit: int = 3
    ) -> List[Dict[str, Any]]:
        """Pin the newest ``limit`` records against pruning and return
        their payloads tagged with ``incident_id`` — the incident record
        (obs/incidents.py) references these files, and an unreferenced
        prune would sever the evidence an operator follows from
        ``/debug/incidents`` into ``/debug/flight``. Pins are bounded:
        past ``PIN_CAP`` the oldest-pinned files release back to the
        normal ring age-out."""
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
        out: List[Dict[str, Any]] = []
        with self._lock:
            for n in names:
                self._pinned[n] = incident_id
            while len(self._pinned) > self.PIN_CAP:
                self._pinned.pop(next(iter(self._pinned)))
        for n in names:
            try:
                with open(os.path.join(self.directory, n), encoding="utf-8") as f:
                    payload = json.load(f)
            except Exception:
                continue  # half-written or pruned-under-us
            out.append({
                "file": n,
                "incident_id": incident_id,
                "name": payload.get("name"),
                "trace_id": payload.get("trace_id"),
                "duration_s": payload.get("duration_s"),
                "recorded_at": payload.get("recorded_at"),
            })
        return out

    def pinned(self) -> Dict[str, str]:
        with self._lock:
            return dict(self._pinned)

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
