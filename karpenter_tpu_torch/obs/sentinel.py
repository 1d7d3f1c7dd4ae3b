"""The regression sentinel: online performance baselines + change-point
detection over the tracer finish-hook stream.

The north star is a 10k-pod solve under 100ms p99, but a regression
measured offline is seen only when a human compares two runs. Production
already emits everything needed to notice sooner — spans, SLO
verdicts, profiles, flight records, decision records — it just lacks the
layer that cross-examines them.
This module is that layer's sensor half:

- **Online baselines.** For every (watched span stage, route/transport,
  shape-class) key the engine learns an EW mean/variance of the span's
  duration (the ``forecast/model.py`` Ewma discipline: residual against
  the pre-update level) plus a short window of recent durations.
- **Change-point detection.** Each finished span's window median is
  compared against the learned level; a median past
  ``level + max(sigma·std, rel_floor·level, abs_floor)`` is a deviation.
  Medians over a small window make the detector a *step* detector — one
  slow outlier cannot trip it, a sustained shift must.
- **Sustained deviation → incident.** ``sustain`` consecutive deviating
  windows hand the triggering span to :class:`~karpenter_tpu_torch.obs.
  incidents.IncidentLog`, which correlates the evidence already lying
  around (flight records, decision ids, profiler folds, state panels)
  under one incident id. After minting, the key re-baselines to the new
  regime and cools down — a persisting regression is ONE incident, not a
  siren.
- **Persistence.** Baselines survive restarts (``--sentinel-dir``,
  flock'd + tmp/rename in the launch-journal discipline) so a restarted
  replica resumes with its learned normals instead of re-learning — and
  never mints a warm-up false incident. A corrupt or unwritable baseline
  file degrades to memory-only with a counted reason
  (``karpenter_sentinel_baselines_total{event=...}``), the decision-ring
  containment contract: observability failures never fail the observed.

Hot path: one frozenset probe + one dict get + one deque append per
finished span, under a short lock; the detector arithmetic runs only on
watched spans. All sentinel work is self-accounted (``overhead_ratio``,
the profiler's discipline) and held under 1% of wall.
"""

from __future__ import annotations

import json
import logging
import math
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from karpenter_tpu_torch.obs.trace import Span

logger = logging.getLogger("karpenter.obs")

# the stages whose latency regressions this plane exists to catch: the
# round, the end-to-end solve, the transport leg, and the sidecar's
# device half — enough to tell encode-bound from wire-bound from
# device-bound without hooking every span in the process
DEFAULT_WATCH = (
    "provision.round",
    "solver.solve",
    "solver.wire",
    "sidecar.pack",
    "solve.encode",
    "solve.pack_fetch",
)

# baseline learning / detection knobs (struct-of-defaults so drivers and
# tests can tighten them on a live engine without a config plumbing tax)
DEFAULT_ALPHA = 0.3          # EW level/variance smoothing (forecaster's)
DEFAULT_WINDOW = 8           # change-point median window (deque maxlen)
DEFAULT_MIN_EVENTS = 24      # warm-up: no verdicts before this many events
DEFAULT_SIGMA = 4.0          # deviation needs median > level + sigma*std...
DEFAULT_REL_FLOOR = 0.5      # ...and > level * (1 + rel_floor)...
DEFAULT_ABS_FLOOR_S = 0.002  # ...and > level + 2ms (loopback noise floor)
DEFAULT_SUSTAIN = 3          # consecutive deviating windows -> incident
DEFAULT_COOLDOWN_S = 60.0    # per-key quiet period after an incident
DEFAULT_SAVE_INTERVAL_S = 30.0
DEFAULT_KEY_CAP = 256        # baseline table bound (route/shape churn)

BASELINE_FILE = "baselines.json"
BASELINE_VERSION = 1


def _count(event: str) -> None:
    try:
        from karpenter_tpu_torch import metrics

        metrics.SENTINEL_BASELINES.labels(event=event).inc()
    except Exception:
        pass  # trimmed registries


def shape_class(value: Any) -> str:
    """Power-of-two bucket of a batch size: 4000 pods and 4100 pods are
    the same workload shape, 400 and 4000 are not. Non-numeric -> "-"."""
    try:
        n = int(value)
    except (TypeError, ValueError):
        return "-"
    if n <= 0:
        return "0"
    return str(1 << (n - 1).bit_length())


def route_of(span: Span) -> str:
    """The span's route/transport identity: the wire leg keys on its
    transport (stream_shm/stream/unary), the solve on its backend, the
    sidecar on its session — a unary fallback must not pollute the
    streamed path's baseline."""
    attrs = span.attrs
    for k in ("transport", "solver", "backend", "route"):
        v = attrs.get(k)
        if v:
            return str(v)
    if attrs.get("address"):
        return "remote"
    return "-"


class _Baseline:
    """One (stage, route, shape) key's learned normal + recent window."""

    __slots__ = (
        "level", "variance", "observations", "window",
        "deviating", "cooldown_until", "restored",
    )

    def __init__(self, window: int):
        self.level: Optional[float] = None
        self.variance = 0.0
        self.observations = 0
        self.window: deque = deque(maxlen=window)
        self.deviating = 0           # consecutive deviating window checks
        self.cooldown_until = 0.0    # monotonic: no incidents before this
        self.restored = False        # loaded from disk (skips warm-up)

    def update(self, value: float, alpha: float) -> None:
        # the forecaster's Ewma: residual against the PRE-update level so
        # the variance tracks prediction error, not post-hoc fit
        if self.level is None:
            self.level = value
        else:
            residual = value - self.level
            self.variance = (1 - alpha) * self.variance + alpha * residual * residual
            self.level += alpha * residual
        self.observations += 1

    def std(self) -> float:
        return math.sqrt(max(self.variance, 0.0))


class SentinelEngine:
    """Tracer finish-hook (``tracer.add_hook``) + the baseline store.

    ``incidents`` is the :class:`IncidentLog` deviations escalate into;
    ``directory`` ('' = memory-only) persists baselines across restarts.
    """

    def __init__(
        self,
        incidents=None,
        directory: str = "",
        watch=DEFAULT_WATCH,
        alpha: float = DEFAULT_ALPHA,
        window: int = DEFAULT_WINDOW,
        min_events: int = DEFAULT_MIN_EVENTS,
        sigma: float = DEFAULT_SIGMA,
        rel_floor: float = DEFAULT_REL_FLOOR,
        abs_floor_s: float = DEFAULT_ABS_FLOOR_S,
        sustain: int = DEFAULT_SUSTAIN,
        cooldown_s: float = DEFAULT_COOLDOWN_S,
        save_interval_s: float = DEFAULT_SAVE_INTERVAL_S,
        key_cap: int = DEFAULT_KEY_CAP,
    ):
        from karpenter_tpu_torch.obs.incidents import IncidentLog

        self.incidents = incidents if incidents is not None else IncidentLog()
        self.directory = directory
        self.watch = frozenset(watch)
        self.alpha = alpha
        self.window = window
        self.min_events = min_events
        self.sigma = sigma
        self.rel_floor = rel_floor
        self.abs_floor_s = abs_floor_s
        self.sustain = sustain
        self.cooldown_s = cooldown_s
        self.save_interval_s = save_interval_s
        self.key_cap = key_cap
        self._lock = threading.Lock()
        # key -> _Baseline; insertion-ordered, oldest key evicted past cap
        self._baselines: Dict[Tuple[str, str, str], _Baseline] = {}
        self._busy_s = 0.0           # guarded-by: self._lock
        self._started_at = time.monotonic()
        self._last_save = time.monotonic()  # guarded-by: self._lock
        # pre-warm the lazy metrics import OUTSIDE the hook: the first
        # span must not get charged ~100ms of prometheus import time in
        # the self-accounted busy window (the <1% gate reads it)
        try:
            from karpenter_tpu_torch import metrics  # noqa: F401
        except Exception:
            pass
        if directory:
            self._load()

    # -- the hook (every finished span lands here) ---------------------------
    def __call__(self, span: Span) -> None:
        if span.name not in self.watch:
            return
        t0 = time.perf_counter()
        try:
            self._observe(span)
        except Exception:
            # the containment contract: the sentinel must never fail the
            # span's owner (trace.py already swallows, but stay honest)
            logger.debug("sentinel observe failed", exc_info=True)
        finally:
            save_due = False
            dt = time.perf_counter() - t0
            with self._lock:
                self._busy_s += dt
                if self.directory and (
                    time.monotonic() - self._last_save >= self.save_interval_s
                ):
                    self._last_save = time.monotonic()
                    save_due = True
            if save_due:
                t1 = time.perf_counter()
                self.save()
                with self._lock:
                    self._busy_s += time.perf_counter() - t1

    def _observe(self, span: Span) -> None:
        key = (span.name, route_of(span), shape_class(
            span.attrs.get("pods", span.attrs.get("batch"))
        ))
        duration = span.duration_s
        trip = None
        with self._lock:
            b = self._baselines.get(key)
            if b is None:
                if len(self._baselines) >= self.key_cap:
                    # churn bound: evict the oldest-inserted key; a live
                    # key re-learns in min_events, a dead one stays gone
                    self._baselines.pop(next(iter(self._baselines)))
                b = self._baselines[key] = _Baseline(self.window)
                _count("learned")
            b.window.append(duration)
            warm = b.observations >= self.min_events
            if not warm:
                b.update(duration, self.alpha)
                return
            level = b.level or 0.0
            threshold = level + max(
                self.sigma * b.std(),
                self.rel_floor * level,
                self.abs_floor_s,
            )
            # gated update: a value past the threshold never feeds the
            # baseline — an un-gated EW level CHASES a step fast enough
            # (alpha 0.3) that the median can never clear the moving
            # threshold and the regression self-absorbs undetected
            if duration <= threshold:
                b.update(duration, self.alpha)
            full = len(b.window) == b.window.maxlen
            med = sorted(b.window)[len(b.window) // 2] if full else 0.0
            if full and med > threshold:
                b.deviating += 1
                now = time.monotonic()
                if b.deviating >= self.sustain and now >= b.cooldown_until:
                    b.cooldown_until = now + self.cooldown_s
                    b.deviating = 0
                    trip = {
                        "observed_s": round(med, 6),
                        "baseline_s": round(level, 6),
                        "baseline_std_s": round(b.std(), 6),
                        "threshold_s": round(threshold, 6),
                        "observations": b.observations,
                    }
                    # re-baseline to the new regime: the incident NAMES
                    # the step; tracking it afterwards is the new normal
                    # (a fix shows up as a fast step back under threshold)
                    b.level = med
                    b.variance = 0.0
                    b.window.clear()
            else:
                b.deviating = 0
        if trip is None:
            return
        stage, route, shape = key
        try:
            from karpenter_tpu_torch import metrics

            metrics.SENTINEL_DEVIATIONS.labels(stage=stage).inc()
        except Exception:
            pass
        self.incidents.deviation(
            stage=stage, route=route, shape=shape, span=span, baseline=trip,
        )

    # -- persistence (launch-journal discipline) -----------------------------
    def _baseline_path(self) -> str:
        return os.path.join(self.directory, BASELINE_FILE)

    def _load(self) -> None:
        path = self._baseline_path()
        try:
            os.makedirs(self.directory, exist_ok=True)
        except OSError as e:
            logger.warning(
                "sentinel dir %s uncreatable (%s); baselines memory-only",
                self.directory, e,
            )
            self.directory = ""
            _count("persist_failed")
            return
        if not os.path.exists(path):
            return
        try:
            with open(path, encoding="utf-8") as f:
                payload = json.load(f)
            if payload.get("version") != BASELINE_VERSION:
                raise ValueError(f"baseline version {payload.get('version')}")
            loaded = 0
            with self._lock:
                for row in payload.get("baselines", [])[: self.key_cap]:
                    key = tuple(row["key"])
                    if len(key) != 3:
                        continue
                    b = _Baseline(self.window)
                    b.level = float(row["level"])
                    b.variance = max(float(row.get("variance", 0.0)), 0.0)
                    b.observations = int(row.get("observations", 0))
                    b.restored = True
                    self._baselines[key] = b
                    loaded += 1
            if loaded:
                _count("loaded")
            logger.info(
                "sentinel restored %d baselines from %s", loaded, path
            )
        except Exception as e:
            # corrupt file: keep running memory-only on a FRESH table —
            # half-loaded baselines would be worse than none — and leave
            # the file for forensics (the next save overwrites it)
            logger.warning(
                "sentinel baseline file %s unreadable (%s); re-learning",
                path, e,
            )
            with self._lock:
                self._baselines.clear()
            _count("corrupt")

    def save(self) -> bool:
        """Persist current baselines (flock + tmp/rename — a concurrent
        replica or a crash mid-write can never leave a torn file). Returns
        False (and degrades to memory-only, counted) on failure."""
        if not self.directory:
            return False
        with self._lock:
            rows = [
                {
                    "key": list(key),
                    "level": b.level,
                    "variance": b.variance,
                    "observations": b.observations,
                }
                for key, b in self._baselines.items()
                if b.level is not None
            ]
        payload = {
            "version": BASELINE_VERSION,
            "saved_at": time.time(),
            "baselines": rows,
        }
        path = self._baseline_path()
        # pid-unique tmp + atomic rename is the torn-file contract; the
        # dir-level flock (telemetry-backend discipline) serializes
        # concurrent savers — replicas sharing the dir AND this process's
        # own hook-vs-shutdown race — with NO threading lock held across
        # the file-lock wait
        tmp = f"{path}.{os.getpid()}.tmp"
        lock_fd = -1
        try:
            try:
                import fcntl

                lock_fd = os.open(
                    os.path.join(self.directory, ".sentinel.flock"),
                    os.O_CREAT | os.O_RDWR,
                )
                fcntl.flock(lock_fd, fcntl.LOCK_EX)
            except (ImportError, OSError):
                pass  # flock is advisory belt, not the contract
            try:
                with open(tmp, "w", encoding="utf-8") as f:
                    json.dump(payload, f)
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(tmp, path)
            finally:
                if lock_fd >= 0:
                    try:
                        import fcntl

                        fcntl.flock(lock_fd, fcntl.LOCK_UN)
                    finally:
                        os.close(lock_fd)
            _count("persisted")
            return True
        except OSError as e:
            # ENOSPC / read-only volume: degrade to memory-only with a
            # counted reason; detection keeps running on what it has
            logger.warning(
                "sentinel baseline write to %s failed (%s); memory-only",
                path, e,
            )
            self.directory = ""
            _count("persist_failed")
            try:
                os.remove(tmp)
            except OSError:
                pass
            return False

    def close(self) -> None:
        """Final persist (runtime stop / sidecar shutdown)."""
        self.save()

    # -- readouts ------------------------------------------------------------
    def overhead_ratio(self) -> float:
        """Self-accounted busy/wall since start (the profiler's measure;
        the ``--sentinel-overhead-check`` <1% gate reads this)."""
        elapsed = time.monotonic() - self._started_at
        if elapsed <= 0:
            return 0.0
        with self._lock:
            return self._busy_s / elapsed

    def baseline_count(self) -> int:
        with self._lock:
            return len(self._baselines)

    def snapshot(self, limit: int = 64) -> Dict[str, Any]:
        """The baseline table (bounded) + engine disposition — the
        ``/debug/incidents`` payload's ``sentinel`` half."""
        with self._lock:
            rows: List[Dict[str, Any]] = []
            for key, b in list(self._baselines.items())[:limit]:
                rows.append({
                    "stage": key[0],
                    "route": key[1],
                    "shape": key[2],
                    "level_s": round(b.level, 6) if b.level is not None else None,
                    "std_s": round(b.std(), 6),
                    "observations": b.observations,
                    "deviating": b.deviating,
                    "restored": b.restored,
                })
        return {
            "baselines": rows,
            "baseline_count": self.baseline_count(),
            "persist_dir": self.directory,
            "overhead_ratio": round(self.overhead_ratio(), 6),
            "watch": sorted(self.watch),
        }

    def panel(self) -> Dict[str, Any]:
        """The ``sentinel`` flight-recorder/state panel: small enough to
        ride every flight record, rich enough to say what the sentinel
        believed when some OTHER plane's incident landed."""
        open_inc = self.incidents.open_summary()
        return {
            "baselines": self.baseline_count(),
            "incidents": self.incidents.count(),
            "open_incident": open_inc,
            "overhead_ratio": round(self.overhead_ratio(), 6),
        }
