"""The correlated incident plane: one id over all the evidence.

When the sentinel (obs/sentinel.py) sees a sustained latency step it does
NOT page with a bare number — it mints a bounded **Incident record** that
correlates everything the process already knows under one incident id:

- the triggering span tree (who was slow, with its children),
- in-window flight records (flight.py's pin-by-incident hook keeps them
  from being pruned out from under the incident, and the triggering span
  is force-recorded so an incident always carries at least one),
- the decision ids whose provisioning rounds fell inside the window
  (the decision audit ring — ``obs/replay.py`` re-solves them),
- the profiler's in-window top folds,
- the full state-panel snapshot (brownout rung, fence, breaker/pool
  disposition, delta-encoder full-re-encode reasons, stream credit
  stalls — whatever panels are registered at mint time).

A regression that keeps deviating ATTACHES to the open incident (one
incident per regime change, not one per window); a later deviation in a
different stage inside the correlation window attaches as an additional
stage — a slow sidecar shows up once, as wire+device, not as a siren of
near-duplicate incidents.

``GET /debug/incidents`` (the sidecar's health server, via
``obs.debug_incidents_payload``) lists summaries; ``?id=`` returns the
full record. Bounded summaries ride the member telemetry payload so
``/debug/fleet`` carries a fleet-merged incident index.
"""

from __future__ import annotations

import logging
import threading
import time
import uuid
from collections import deque
from typing import Any, Dict, List, Optional

from karpenter_tpu_torch.obs.trace import Span

logger = logging.getLogger("karpenter.obs")

DEFAULT_CAP = 32          # incident records retained (memory ring)
CORRELATE_WINDOW_S = 30.0  # deviations inside this window share one id
DECISION_WINDOW_S = 120.0  # decisions this recent count as in-window
MAX_STAGES = 8             # stages attached to one incident
MAX_DECISIONS = 8
MAX_FLIGHTS = 3
MAX_PROFILE_FOLDS = 10


def _new_id() -> str:
    return "i-" + uuid.uuid4().hex[:16]


class IncidentLog:
    """Bounded incident ring + the evidence-correlation assembly.

    ``recorder`` (a ``kube.events.EventRecorder``) is optional: when set,
    every minted incident also lands as an ``IncidentDetected`` Warning
    event carrying the newest in-window decision id — the operator's path
    from ``kubectl describe`` into ``/debug/incidents``."""

    def __init__(self, cap: int = DEFAULT_CAP, recorder=None, clock=time.time):
        self.cap = cap
        self.recorder = recorder
        self.clock = clock
        self._lock = threading.Lock()
        self._records: deque = deque(maxlen=cap)  # guarded-by: self._lock
        self._opened = 0  # guarded-by: self._lock

    # -- the sentinel's escalation entrypoint --------------------------------
    def deviation(
        self,
        stage: str,
        route: str,
        shape: str,
        span: Span,
        baseline: Dict[str, Any],
    ) -> Optional[Dict[str, Any]]:
        """A sustained deviation: attach to the open incident when one is
        inside the correlation window, mint a new record otherwise.
        Never raises — evidence assembly is best-effort by contract."""
        try:
            return self._deviation(stage, route, shape, span, baseline)
        except Exception:
            logger.debug("incident assembly failed", exc_info=True)
            return None

    def _deviation(self, stage, route, shape, span, baseline):
        now = self.clock()
        stage_row = {
            "stage": stage,
            "route": route,
            "shape": shape,
            "trace_id": span.trace_id,
            "at": now,
            **baseline,
        }
        with self._lock:
            open_rec = self._open_locked(now)
            if open_rec is not None:
                if len(open_rec["stages"]) < MAX_STAGES:
                    open_rec["stages"].append(stage_row)
                open_rec["last_deviation_at"] = now
                return open_rec
        return self._mint(stage, span, stage_row, now)

    def _open_locked(self, now: float) -> Optional[Dict[str, Any]]:
        if not self._records:
            return None
        rec = self._records[-1]
        if now - rec.get("last_deviation_at", 0.0) <= CORRELATE_WINDOW_S:
            return rec
        return None

    def _mint(self, stage, span, stage_row, now) -> Dict[str, Any]:
        from karpenter_tpu_torch import obs
        from karpenter_tpu_torch.obs.flight import state_snapshot

        incident_id = _new_id()
        # decision ids whose rounds fell in the window: the replay path
        decisions: List[Dict[str, Any]] = []
        try:
            for s in obs.decision_log().summaries(limit=MAX_DECISIONS):
                if now - s.get("recorded_at", 0.0) <= DECISION_WINDOW_S:
                    decisions.append({
                        "id": s["id"],
                        "recorded_at": s["recorded_at"],
                        "provisioner": s.get("provisioner"),
                        "trace_id": s.get("trace_id"),
                    })
        except Exception:
            pass
        # flight evidence: pin what's already on disk against pruning,
        # and force-record the triggering span so the incident always
        # carries the tree that tripped it even when it was under the
        # flight budget (a 2x step on a 10ms stage is)
        flights: List[Dict[str, Any]] = []
        rec = obs.flight_recorder()
        if rec is not None:
            try:
                path = rec.record(span, extra={"incident_id": incident_id})
                flights = rec.pin_for_incident(incident_id, limit=MAX_FLIGHTS)
                if path and not flights:
                    flights = [{"file": path, "trace_id": span.trace_id}]
            except Exception:
                pass
        profile_top: List[Dict[str, Any]] = []
        prof = obs.profiler()
        if prof is not None:
            try:
                profile_top = prof.flight_panel().get(
                    "top_folds", []
                )[:MAX_PROFILE_FOLDS]
            except Exception:
                pass
        record = {
            "id": incident_id,
            "opened_at": now,
            "last_deviation_at": now,
            "stage": stage,
            "stages": [stage_row],
            "trace_id": span.trace_id,
            "trace": span.to_dict(),
            "decisions": decisions,
            "flights": flights,
            "profile_top": profile_top,
            # the full panel spread: brownout rung, fence, breakers/pool,
            # delta re-encode reasons, stream credit stalls, slo burn...
            "state": state_snapshot(),
        }
        with self._lock:
            self._records.append(record)
            self._opened += 1
        try:
            from karpenter_tpu_torch import metrics

            metrics.SENTINEL_INCIDENTS.labels(stage=stage).inc()
        except Exception:
            pass
        self._emit_event(record)
        logger.warning(
            "sentinel incident %s: %s regressed to %.1fms (baseline %.1fms)",
            incident_id, stage,
            stage_row.get("observed_s", 0.0) * 1e3,
            stage_row.get("baseline_s", 0.0) * 1e3,
        )
        return record

    def _emit_event(self, record: Dict[str, Any]) -> None:
        if self.recorder is None:
            return
        decision_id = (
            record["decisions"][0]["id"] if record["decisions"] else ""
        )
        stage_row = record["stages"][0]
        try:
            self.recorder.event(
                "Provisioner",
                str(stage_row.get("route") or "default"),
                reason="IncidentDetected",
                message=(
                    f"performance incident {record['id']}: stage "
                    f"{record['stage']} regressed to "
                    f"{stage_row.get('observed_s', 0.0) * 1e3:.1f}ms "
                    f"(baseline {stage_row.get('baseline_s', 0.0) * 1e3:.1f}ms)"
                    " — see GET /debug/incidents"
                ),
                type="Warning",
                decision_id=decision_id,
            )
        except Exception:
            logger.debug("incident event emit failed", exc_info=True)

    # -- readouts ------------------------------------------------------------
    def count(self) -> int:
        with self._lock:
            return self._opened

    def open_summary(self) -> Optional[Dict[str, Any]]:
        """Id + stage of the incident still inside its correlation window
        (None when quiet) — the ``sentinel`` state panel's headline."""
        with self._lock:
            rec = self._open_locked(self.clock())
            if rec is None:
                return None
            return {"id": rec["id"], "stage": rec["stage"]}

    def get(self, incident_id: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            for rec in self._records:
                if rec["id"] == incident_id:
                    return dict(rec)
        return None

    def recent(self, limit: int = 20) -> List[Dict[str, Any]]:
        """Newest-first full records (the ``?id=`` detail is one of
        these; the default listing serves :meth:`summaries`)."""
        with self._lock:
            records = list(self._records)
        records.reverse()
        return [dict(r) for r in records[:limit]]

    def summaries(self, limit: int = 8) -> List[Dict[str, Any]]:
        """The bounded per-member index the telemetry plane flushes —
        ``/debug/fleet`` merges these across members, and a dead
        replica's incidents survive through them."""
        out = []
        for r in self.recent(limit=limit):
            out.append({
                "id": r["id"],
                "opened_at": r["opened_at"],
                "stage": r["stage"],
                "stages": [
                    {k: s.get(k) for k in (
                        "stage", "route", "shape", "observed_s", "baseline_s"
                    )}
                    for s in r["stages"]
                ],
                "trace_id": r["trace_id"],
                "decision_ids": [d["id"] for d in r["decisions"]],
                "flight_count": len(r["flights"]),
            })
        return out

    def clear(self) -> None:
        with self._lock:
            self._records.clear()
