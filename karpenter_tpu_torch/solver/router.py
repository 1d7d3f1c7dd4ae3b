"""Measured-cost backend routing for the packing solve.

``solver: tpu`` must never be slower than its own CPU path. Routing by
platform (the card whenever one is attached) would send every solve down
the device path even at shapes where the in-process native packer is
faster, so backend choice is empirical: an EMA of the measured end-to-end
pack time per (backend, shape-class), with the native C++ packer a
first-class contender rather than a no-card fallback.

In this package the router weighs backends for a scheduler on
``device="cpu"`` only, where both contenders run on the host. A scheduler
on the card keeps its pack on the card: under ``auto`` it takes the device
path and never consults the router, and the native packer serves there
only when ``KARPENTER_PACKER=native`` asks for it
(``backend.TorchScheduler._pack``).

Semantics:

- **Cold start**: every candidate is tried once (in the caller's preference
  order) before any exploitation, so each backend owns a measurement. The
  device path is listed first so its one-time kernel build and first
  launch land in the first solve of a shape class.
- **Exploit**: every solve routes to the backend with the lowest EMA for
  the shape class — ``choose`` never sacrifices a production solve to
  exploration, so the winner's latency distribution (and the p99 the bench
  publishes) is unpolluted by probe iterations.
- **Shadow re-probe**: ``should_probe`` fires every ``probe_every``-th
  solve of a shape class (64 by default: drift — host load, a card shared
  with other work — moves on a minutes timescale, while a device probe
  on a core-starved host can shadow a measured solve, so probes are kept
  rare), rising to every 8th while the class's EMAs are NEAR-TIED (within
  1.25×: a stale runner-up in a close race can silently drift into a real
  loss, and refreshing it costs nothing on the critical path). The caller
  re-measures the LOSER(s) on a daemon thread (a device probe's fetch
  wait releases the GIL; a losing native probe is slow precisely when it
  lost, so it never runs inline) so a drifting environment can re-win the
  route. EMA alpha 0.4 forgets a compile-poisoned first sample within a
  few probes.

The default router is PROCESS-SHARED (``default_router``): schedulers come
and go, but the cost landscape is a property of the machine, so a fresh
scheduler must not re-pay cold start on shapes the process already
measured. That sharing means ``choose``/``record`` are called from several
schedulers' solve threads and from shadow-probe threads concurrently; a
small internal lock keeps the counters and EMAs consistent (the operations
are dict reads/writes — the lock is uncontended and nanoseconds-cheap next
to any pack). ``reset_default`` drops it (tests isolate router learning
with it).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

EMA_ALPHA = 0.4
PROBE_EVERY = 64
# recorded instead of elapsed time when a backend RAISES: a fast-failing
# backend must lose the route, not win it with a microsecond "cost".
# Probes rehabilitate a fixed backend (alpha pulls the EMA back down).
FAILURE_PENALTY_S = 60.0


class CostRouter:
    def __init__(self, probe_every: int = PROBE_EVERY, alpha: float = EMA_ALPHA):
        self.probe_every = probe_every
        self.alpha = alpha
        self._ema: Dict[Tuple[str, tuple], float] = {}  # guarded-by: self._lock
        self._solves: Dict[tuple, int] = {}  # guarded-by: self._lock
        self._lock = threading.Lock()
        # brownout knobs (resilience/brownout.py): paused probes keep
        # exploration off an overloaded machine, and a bias > 1 inflates
        # every NON-native EMA at choose time so the native packer wins
        # marginal races while the ladder is engaged — the EMAs themselves
        # stay unpolluted for recovery
        self._probes_paused = False  # guarded-by: self._lock
        self._brownout_bias = 1.0  # guarded-by: self._lock

    # EMAs within this factor are a NEAR-TIE: the run-to-run noise exceeds
    # the gap, so the nominal winner is a coin flip whose runner-up EMA
    # must not go stale (drift silently turns the tie into a real loss).
    # Ties raise the SHADOW-PROBE cadence — never the production route:
    # exploration stays off the critical path even when the race is close.
    NEAR_TIE = 1.25

    def choose(self, key: tuple, candidates: List[str]) -> str:
        """Pick the backend for this solve: first unmeasured candidate (in
        preference order) during cold start, then always the cheapest."""
        if len(candidates) == 1:
            return candidates[0]
        with self._lock:
            self._solves[key] = self._solves.get(key, 0) + 1
            for c in candidates:
                if (c, key) not in self._ema:
                    return c
            bias = self._brownout_bias
            return min(
                candidates,
                key=lambda c: self._ema[(c, key)] * (1.0 if c == "native" else bias),
            )

    def should_probe(self, key: tuple) -> bool:
        """True every ``probe_every``-th solve of this shape class — every
        ``probe_every // 8``-th while the key's EMAs are near-tied — so the
        caller re-measures the losing backend(s) off the critical path."""
        with self._lock:
            if self._probes_paused:
                return False
        n = self._solves.get(key, 0)
        if not self.probe_every or n == 0:
            return False
        cadence = self.probe_every
        with self._lock:
            emas = sorted(v for (b, k), v in self._ema.items() if k == key)
        if len(emas) > 1 and emas[1] <= self.NEAR_TIE * emas[0]:
            cadence = max(4, self.probe_every // 8)
        return n % cadence == 0

    def record(self, key: tuple, backend: str, seconds: float) -> None:
        k = (backend, key)
        with self._lock:
            prev = self._ema.get(k)
            self._ema[k] = (
                seconds if prev is None else prev + self.alpha * (seconds - prev)
            )

    def record_failure(self, key: tuple, backend: str) -> None:
        """A backend RAISED for this shape class: record the failure
        penalty, not the (tiny) elapsed time — a fast-failing backend must
        lose the route, not win it with a microsecond "cost". Shadow probes
        (and the caller's circuit breakers' half-open probes) rehabilitate
        a fixed backend: alpha pulls the EMA back down."""
        self.record(key, backend, FAILURE_PENALTY_S)

    # -- brownout knobs (resilience/brownout.py) ----------------------------

    def set_probes_paused(self, paused: bool) -> None:
        """Brownout rung 1: shadow probes re-measure LOSING backends — pure
        exploration, the first work an overloaded machine sheds."""
        with self._lock:
            self._probes_paused = bool(paused)

    def probes_paused(self) -> bool:
        with self._lock:
            return self._probes_paused

    def set_brownout_bias(self, factor: float) -> None:
        """Brownout rung 3: inflate non-native EMAs by ``factor`` at choose
        time (1.0 = no bias) so marginal device-vs-native races route to
        the host path while the ladder is engaged. The stored EMAs are
        untouched: recovery is instant when the bias clears."""
        with self._lock:
            self._brownout_bias = max(float(factor), 1.0)

    def brownout_bias(self) -> float:
        with self._lock:
            return self._brownout_bias

    def ema(self, key: tuple, backend: str) -> Optional[float]:
        with self._lock:
            return self._ema.get((backend, key))

    def report(self) -> Dict[str, float]:
        """Flat {backend@key: ema_seconds} snapshot (bench/metrics surface)."""
        with self._lock:
            items = list(self._ema.items())
        return {
            f"{backend}@{'x'.join(map(str, key))}": round(v, 6)
            for (backend, key), v in sorted(items)
        }


# Process-shared default: schedulers come and go but the cost landscape is
# a property of the machine — a fresh scheduler must not re-pay cold start
# on shapes the process has already measured. Schedulers may be built on
# several threads at once, so the lazy init is locked — two racing
# initializations would hand them different routers and split the cost
# landscape they exist to share.
_default_lock = threading.Lock()
_default: Optional[CostRouter] = None  # guarded-by: _default_lock


def default_router() -> CostRouter:
    global _default
    with _default_lock:
        if _default is None:
            _default = CostRouter()
        return _default


def reset_default() -> None:
    """Tests isolate router learning with this."""
    global _default
    with _default_lock:
        _default = None
