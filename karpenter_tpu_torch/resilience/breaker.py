"""Circuit breaker: per-dependency closed/open/half-open state machine.

Trips on a *windowed failure rate* (last ``window`` outcomes, at least
``min_volume`` of them, failure fraction ≥ ``failure_rate``) rather than a
consecutive-failure count, so an intermittently flaky dependency keeps
flowing while a dead one opens within a handful of calls. While open,
``allow()`` answers False: the caller fails fast (raising
:class:`BreakerOpen`) or degrades instead of paying the failure latency per
call. After ``open_seconds`` the breaker
admits up to ``half_open_max`` probe calls; a probe success closes the
breaker (window cleared), a probe failure re-opens it for another
``open_seconds``. ``trip()`` opens it at once, for correctness failures.

State is exported on the scrape as ``karpenter_resilience_breaker_state``
(0 closed / 1 open / 2 half-open) per dependency. The clock is injectable
(``clock=``), so tests drive the cool-off without sleeping.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Dict

from karpenter_tpu_torch import metrics

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half-open"

_STATE_CODE = {CLOSED: 0, OPEN: 1, HALF_OPEN: 2}


class BreakerOpen(Exception):
    """The dependency's circuit is open; the call was not attempted."""

    def __init__(self, dependency: str, retry_in: float):
        super().__init__(
            f"circuit breaker for {dependency} is open (retry in {retry_in:.1f}s)"
        )
        self.dependency = dependency
        self.retry_in = retry_in


class CircuitBreaker:
    def __init__(
        self,
        dependency: str = "",
        window: int = 20,
        min_volume: int = 5,
        failure_rate: float = 0.5,
        open_seconds: float = 10.0,
        half_open_max: int = 1,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.dependency = dependency
        self.window = int(window)
        self.min_volume = int(min_volume)
        self.failure_rate = float(failure_rate)
        self.open_seconds = float(open_seconds)
        self.half_open_max = int(half_open_max)
        self._clock = clock
        self._mu = threading.Lock()
        self._outcomes: deque = deque(maxlen=self.window)  # True = failure; guarded-by: self._mu
        self._state = CLOSED  # guarded-by: self._mu
        self._opened_at = 0.0  # guarded-by: self._mu
        self._probes_in_flight = 0  # guarded-by: self._mu
        self.trips = 0  # times the breaker transitioned to OPEN; guarded-by: self._mu
        self._publish()

    # -- state -------------------------------------------------------------
    @property
    def state(self) -> str:
        with self._mu:
            return self._state

    def _publish(self) -> None:
        if self.dependency:
            metrics.RESILIENCE_BREAKER_STATE.labels(
                dependency=self.dependency
            ).set(_STATE_CODE[self._state])

    def _retry_in(self) -> float:
        return max(self._opened_at + self.open_seconds - self._clock(), 0.0)

    def available(self) -> bool:
        """Non-consuming peek: would a call be admitted right now? (Open
        breakers whose cool-off elapsed answer True — the next ``allow()``
        turns that into a half-open probe.)"""
        with self._mu:
            if self._state == CLOSED:
                return True
            if self._state == OPEN:
                return self._retry_in() <= 0.0
            return self._probes_in_flight < self.half_open_max

    def allow(self) -> bool:
        """Admit one call. In half-open, reserves a probe slot — the caller
        MUST follow up with record_success/record_failure."""
        with self._mu:
            if self._state == OPEN and self._retry_in() <= 0.0:
                self._state = HALF_OPEN
                self._probes_in_flight = 0
                self._publish()
            if self._state == CLOSED:
                return True
            if self._state == HALF_OPEN and self._probes_in_flight < self.half_open_max:
                self._probes_in_flight += 1
                return True
            return False

    # -- outcomes ----------------------------------------------------------
    def record_success(self) -> None:
        with self._mu:
            if self._state == HALF_OPEN:
                # the probe worked: close and forget the failure history
                self._outcomes.clear()
                self._probes_in_flight = 0
                self._state = CLOSED
                self._publish()
                return
            self._outcomes.append(False)

    def record_failure(self) -> bool:
        """Record one failure; returns True when this failure OPENED the
        breaker (callers count trips on that edge)."""
        with self._mu:
            if self._state == HALF_OPEN:
                self._probes_in_flight = 0
                self._state = OPEN
                self._opened_at = self._clock()
                self.trips += 1
                self._publish()
                return True
            self._outcomes.append(True)
            if self._state != CLOSED:
                return False
            volume = len(self._outcomes)
            if volume < self.min_volume:
                return False
            if sum(self._outcomes) / volume < self.failure_rate:
                return False
            self._state = OPEN
            self._opened_at = self._clock()
            self.trips += 1
            self._publish()
            return True

    def trip(self) -> None:
        """Force the breaker OPEN immediately — the quarantine edge for
        CORRECTNESS violations (a pack result that failed the screen, the
        canary or host-side validation), which must not wait out the
        windowed failure rate the availability path uses."""
        with self._mu:
            if self._state != OPEN:
                self.trips += 1
            self._probes_in_flight = 0
            self._state = OPEN
            self._opened_at = self._clock()
            self._publish()

    def retry_in(self) -> float:
        """Seconds left of an open breaker's cool-off (0 once it elapsed,
        or when closed); what :class:`BreakerOpen` reports."""
        with self._mu:
            return self._retry_in() if self._state == OPEN else 0.0

    # -- convenience -------------------------------------------------------
    def call(self, fn: Callable, *args, **kwargs):
        """``allow → fn → record``; raises :class:`BreakerOpen` without
        calling ``fn`` when the circuit is open."""
        if not self.allow():
            with self._mu:
                retry_in = self._retry_in()
            raise BreakerOpen(self.dependency or "dependency", retry_in)
        try:
            result = fn(*args, **kwargs)
        except Exception:
            self.record_failure()
            raise
        self.record_success()
        return result


class BreakerBoard:
    """Lazily-created breakers keyed by dependency name, sharing one
    configuration — the per-shape-class pack breakers hang off one of
    these."""

    def __init__(self, clock: Callable[[], float] = time.monotonic, **breaker_kwargs):
        self._clock = clock
        self._kwargs = breaker_kwargs
        self._breakers: Dict[str, CircuitBreaker] = {}  # guarded-by: self._mu
        self._mu = threading.Lock()

    def get(self, dependency: str) -> CircuitBreaker:
        with self._mu:
            breaker = self._breakers.get(dependency)
            if breaker is None:
                breaker = self._breakers[dependency] = CircuitBreaker(
                    dependency=dependency, clock=self._clock, **self._kwargs
                )
            return breaker

    def open_dependencies(self) -> list:
        """Dependencies whose breaker is currently REFUSING calls (open and
        still inside its cool-off). An open breaker whose cool-off elapsed
        is probe-ready, not stuck: the next call re-admits it."""
        with self._mu:
            items = list(self._breakers.items())
        return [
            name for name, b in items if b.state == OPEN and not b.available()
        ]
