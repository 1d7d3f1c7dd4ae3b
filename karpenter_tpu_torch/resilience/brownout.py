"""The SLO-driven brownout ladder.

The SLO engine (``obs/slo.py``) *observes* burn; this controller *acts* on it. When
an objective is burning (both multi-window burn rates >= 1.0 — the page
condition), the controller walks an ordered degradation ladder, one rung
per sustained evaluation, and walks back down one rung at a time once the
burn clears. Every transition is a span + a cluster event + the
``karpenter_brownout_level`` gauge, so each degradation is auditable and
its reversal provable.

The ladder, in order (cheapest capability first):

1. **Pause exploration and voluntary disruption.** Router shadow probes
   re-measure LOSING backends — pure exploration — consolidation
   waves evict pods into the very pending-pod queue an overloaded
   provisioner is drowning in, and warm-pool speculation buys capacity
   for *predicted* demand while real demand burns. None of these costs
   any user anything to stop.
2. **Shrink the batcher admission window.** Small frequent rounds over
   giant stale ones: queued work stops aging a full ``max_duration``
   before its first solve (the queue IS the latency).
3. **Bias the CostRouter toward native/FFD.** Marginal device-vs-native
   races route to the host path; the device/wire budget goes to the
   shapes that need it. EMAs are untouched, so recovery is instant.
4. **Shed queued low-priority work.** Oldest-first, below-default
   priority classes only (``utils/pod.priority_of`` < 0): the one rung
   that drops work outright, and the last before the queues would decide
   for themselves.

Each tick RE-APPLIES the current level: batchers created after an
escalation (worker hot-swap) converge within one tick, and a knob some
other actor reset is re-asserted — the level gauge is always the truth.

The controller is deliberately dumb about *why* an objective burns: the
ladder order is the policy, the SLO engine is the sensor, and every rung
is independently reversible. ``escalate_after`` consecutive burning
evaluations move up one rung; ``recover_after`` consecutive clean ones
move down one — asymmetric on purpose (fast in, cautious out), the same
shape as a circuit breaker's half-open probing.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Optional

logger = logging.getLogger("karpenter.brownout")

# ladder geometry
MAX_LEVEL = 4
LEVEL_NAMES = {
    0: "normal",
    1: "pause_probes_and_consolidation",
    2: "shrink_admission_window",
    3: "bias_router_native",
    4: "shed_low_priority_queue",
}
# admission-window pressure by level (utils/batcher.py set_pressure)
PRESSURE_BY_LEVEL = {0: 1.0, 1: 1.0, 2: 0.5, 3: 0.25, 4: 0.25}
# non-native EMA inflation while rung 3+ is engaged (solver/router.py)
ROUTER_BIAS = 8.0
# priority floor for the shed rung: strictly below the default class
# (utils/pod.priority_of maps "low-"/"best-effort-" names to -10)
SHED_PRIORITY_FLOOR = 0

DEFAULT_TICK_INTERVAL = 5.0
ESCALATE_AFTER = 2  # consecutive burning ticks per rung up
RECOVER_AFTER = 3  # consecutive clean ticks per rung down


def _default_burning() -> bool:
    """Any SLO objective currently burning (the multiwindow page
    condition), read from the process-default engine; False when no
    engine is configured."""
    from karpenter_tpu_torch import obs

    engine = obs.slo_engine()
    if engine is None:
        return False
    return any(o.get("burning") for o in engine.burning_panel().values())


class BrownoutController:
    """Walks the degradation ladder off SLO burn state.

    ``burning_fn`` answers "is any objective burning right now";
    ``provisioning`` / ``consolidation`` / ``router`` are the actuation
    surfaces (any may be None — the rung that needs it becomes a no-op,
    the ladder keeps its shape). ``cluster`` receives the audit events.
    """

    def __init__(
        self,
        burning_fn: Optional[Callable[[], bool]] = None,
        provisioning=None,
        consolidation=None,
        router=None,
        warmpool=None,
        cluster=None,
        interval: float = DEFAULT_TICK_INTERVAL,
        escalate_after: int = ESCALATE_AFTER,
        recover_after: int = RECOVER_AFTER,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.burning_fn = burning_fn or _default_burning
        self.provisioning = provisioning
        self.consolidation = consolidation
        self.router = router
        # WarmPoolController: speculation is pure exploration spend, so it
        # pauses at rung 1 with the probes and consolidation waves
        self.warmpool = warmpool
        self.cluster = cluster
        self.interval = float(interval)
        self.escalate_after = max(int(escalate_after), 1)
        self.recover_after = max(int(recover_after), 1)
        self._clock = clock
        self._level = 0  # guarded-by: self._lock
        self._burning_streak = 0  # guarded-by: self._lock
        self._clean_streak = 0  # guarded-by: self._lock
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.transitions: list = []  # guarded-by: self._lock (audit trail)

    # -- state --------------------------------------------------------------

    def level(self) -> int:
        with self._lock:
            return self._level

    def report(self) -> dict:
        """Flight-recorder / debug panel view."""
        with self._lock:
            return {
                "level": self._level,
                "step": LEVEL_NAMES[self._level],
                "burning_streak": self._burning_streak,
                "clean_streak": self._clean_streak,
                "transitions": list(self.transitions[-8:]),
            }

    # -- the tick ------------------------------------------------------------

    def tick(self) -> int:
        """One evaluation: read burn state, maybe move one rung, re-apply
        the current level. Returns the level after the tick."""
        try:
            burning = bool(self.burning_fn())
        except Exception:
            # a broken sensor must not wedge the ladder at its current
            # rung forever — treat as clean so the system recovers
            logger.exception("brownout burn probe failed; treating as clean")
            burning = False
        with self._lock:
            if burning:
                self._burning_streak += 1
                self._clean_streak = 0
            else:
                self._clean_streak += 1
                self._burning_streak = 0
            new_level = self._level
            if burning and self._burning_streak >= self.escalate_after:
                new_level = min(self._level + 1, MAX_LEVEL)
                if new_level != self._level:
                    self._burning_streak = 0
            elif not burning and self._clean_streak >= self.recover_after:
                new_level = max(self._level - 1, 0)
                if new_level != self._level:
                    self._clean_streak = 0
            old_level, self._level = self._level, new_level
        if new_level != old_level:
            self._announce(old_level, new_level)
        self._apply(new_level)
        return new_level

    def _announce(self, old: int, new: int) -> None:
        """The audit trail: span + event + metrics for every transition."""
        direction = "escalate" if new > old else "recover"
        step = LEVEL_NAMES[new if new > old else old]
        from karpenter_tpu_torch import metrics, obs

        with obs.tracer().span(
            "brownout.transition",
            attrs={
                "direction": direction, "from": old, "to": new, "step": step,
            },
        ):
            with self._lock:
                self.transitions.append(
                    {"direction": direction, "from": old, "to": new, "step": step}
                )
            try:
                metrics.BROWNOUT_TRANSITIONS.labels(direction=direction).inc()
            except Exception:
                pass  # trimmed registries
            logger.warning(
                "brownout %s: level %d -> %d (%s)", direction, old, new, step
            )
            if self.cluster is not None:
                from karpenter_tpu_torch.kube.events import recorder_for

                try:
                    recorder_for(self.cluster).event(
                        "Brownout", "controller",
                        "BrownoutEscalated" if direction == "escalate"
                        else "BrownoutRecovered",
                        f"brownout level {old} -> {new} ({step}); "
                        "docs/overload.md has the ladder",
                        type="Warning" if direction == "escalate" else "Normal",
                    )
                except Exception:
                    logger.debug("brownout event write failed", exc_info=True)

    # -- actuation -----------------------------------------------------------

    def _apply(self, level: int) -> None:
        """Re-assert every knob for ``level`` (idempotent; runs each tick
        so late-created batchers and externally-reset knobs converge)."""
        from karpenter_tpu_torch import metrics

        try:
            metrics.BROWNOUT_LEVEL.set(level)
        except Exception:
            pass  # trimmed registries
        if self.router is not None:
            self.router.set_probes_paused(level >= 1)
            self.router.set_brownout_bias(ROUTER_BIAS if level >= 3 else 1.0)
        if self.consolidation is not None:
            self.consolidation.set_paused(level >= 1)
        if self.warmpool is not None:
            self.warmpool.set_paused(level >= 1)
        pressure = PRESSURE_BY_LEVEL.get(level, PRESSURE_BY_LEVEL[MAX_LEVEL])
        for batcher in self._batchers():
            batcher.set_pressure(pressure)
            if level >= 4:
                shed = batcher.shed_low_priority(SHED_PRIORITY_FLOOR)
                if shed:
                    logger.warning(
                        "brownout shed %d queued low-priority pod(s)", shed
                    )

    def _batchers(self):
        if self.provisioning is None:
            return []
        try:
            return [w.batcher for w in self.provisioning.list_workers()]
        except Exception:
            return []

    # -- lifecycle ------------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="karpenter-brownout", daemon=True
        )
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self.tick()
            except Exception:
                logger.exception("brownout tick failed")
            self._stop.wait(self.interval)

    def stop(self) -> None:
        """Stop the loop and FULLY REVERSE: whatever rung the ladder was
        on, a stopped controller leaves no degradation behind."""
        self._stop.set()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=5)
        with self._lock:
            old, self._level = self._level, 0
            self._burning_streak = self._clean_streak = 0
        if old:
            self._announce(old, 0)
        self._apply(0)
