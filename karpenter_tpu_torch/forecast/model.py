"""Arrival-rate forecasting: the sensor behind predictive provisioning.

The port's copy of ``karpenter_tpu/forecast/model.py``: the same models,
buckets and readout in the same float arithmetic, so the same span stream
on the same clock predicts the same numbers. Everything upstream of this
module *reacts* — the batcher admits pending pods, the solver packs them,
the cloud launches. This module closes the loop by predicting the NEXT
window's demand from the span stream the system already emits:

- **Feed.** The :class:`ArrivalForecaster` is a tracer finish-hook (the
  ``SloEngine`` discipline: O(1) per span, never raises). Every
  ``provision.round`` span carries the round's admission count in its
  ``batch`` attribute — that count, bucketed into fixed-width intervals,
  is the per-provisioner arrival series. No new instrumentation, no
  second pipeline: the SLO stream IS the sensor.
- **Model.** Per-provisioner-shard :class:`Ewma` over the bucketed rate
  (level + EWMA of squared residuals for the upper band), with a
  :class:`HoltWinters` additive-seasonal option for workloads with a
  diurnal shape — both stdlib arithmetic, fake-clock testable, no
  fitting step (online updates only).
- **Horizon.** A prediction is only actionable over the time it takes a
  launch to become schedulable capacity. The forecaster measures that
  itself: ``node.ready`` spans carry ``since_creation_s`` (the launch
  trace's closing bookend), and the horizon is their p99 off the same
  log-linear sketch the SLO engine uses — so "how far ahead to predict"
  tracks the fleet's OBSERVED launch-to-ready tail, not a config guess.
- **Output.** ``predict(provisioner)`` returns a point and upper-band
  arrival rate plus the pod count expected within one horizon — what the
  warm-pool controller (controllers/warmpool.py) converts into
  speculative launches.

Never import this module from the solver's kernel path: it is host-side
span machinery like the rest of ``obs``.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from karpenter_tpu_torch.obs.slo import Histogram
from karpenter_tpu_torch.obs.trace import Span

# Arrival series geometry: one bucket per this many seconds. Small enough
# that a flash crowd registers within a couple of updates, large enough
# that a single batcher window never splits one burst across many buckets.
DEFAULT_BUCKET_S = 10.0

# Upper-band width in standard deviations. 2 sigma over an EWMA variance
# tracks ~p97 of a roughly-normal arrival process — speculation should
# lean high (a warm node that idles is TTL-reclaimed; a cold spike pays
# full launch latency).
DEFAULT_BAND_SIGMA = 2.0

# Horizon clamps: below the floor speculation can't beat the batcher's
# own admission window; above the ceiling a forecast this stale is noise.
MIN_HORIZON_S = 5.0
MAX_HORIZON_S = 900.0
# Horizon before any node.ready observation lands (cold process): one
# typical cloud launch-to-schedulable envelope.
DEFAULT_HORIZON_S = 60.0

MODEL_EWMA = "ewma"
MODEL_HOLT_WINTERS = "holt-winters"


class Ewma:
    """Exponentially weighted level + variance over a series.

    ``alpha`` weights the newest observation; the variance EWMA (same
    alpha) tracks squared residuals against the pre-update level, so the
    band widens exactly when the series starts surprising the model."""

    def __init__(self, alpha: float = 0.3):
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        self.alpha = float(alpha)
        self.level: Optional[float] = None
        self.variance = 0.0
        self.observations = 0

    def update(self, value: float) -> None:
        v = float(value)
        if self.level is None:
            self.level = v
        else:
            residual = v - self.level
            self.variance = (
                (1.0 - self.alpha) * self.variance
                + self.alpha * residual * residual
            )
            self.level = self.level + self.alpha * residual
        self.observations += 1

    def predict(self, steps_ahead: int = 1) -> float:
        """EWMA is level-only: the forecast is flat at the current level."""
        return self.level or 0.0

    def std(self) -> float:
        return math.sqrt(max(self.variance, 0.0))


class HoltWinters:
    """Additive Holt-Winters: level + trend + seasonal components.

    The seasonal option for arrival series with a repeating shape (the
    diurnal curve the bench generator emits). ``season_len`` is in
    BUCKETS, not seconds; seasonal indices initialize to zero and learn
    online — the first season behaves like plain double-exponential
    smoothing, which is the right cold-start (no fabricated seasonality).
    Variance rides the same residual EWMA as :class:`Ewma` so the upper
    band is model-agnostic."""

    def __init__(
        self,
        alpha: float = 0.3,
        beta: float = 0.05,
        gamma: float = 0.1,
        season_len: int = 24,
    ):
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        if not 0.0 <= beta <= 1.0:
            raise ValueError(f"beta must be in [0, 1], got {beta}")
        if not 0.0 <= gamma <= 1.0:
            raise ValueError(f"gamma must be in [0, 1], got {gamma}")
        if season_len < 2:
            raise ValueError(f"season_len must be >= 2, got {season_len}")
        self.alpha = float(alpha)
        self.beta = float(beta)
        self.gamma = float(gamma)
        self.season_len = int(season_len)
        self.level: Optional[float] = None
        self.trend = 0.0
        self.seasonal: List[float] = [0.0] * self.season_len
        self.variance = 0.0
        self.observations = 0
        self._phase = 0  # index into the seasonal cycle of the NEXT update

    def update(self, value: float) -> None:
        v = float(value)
        i = self._phase % self.season_len
        if self.level is None:
            self.level = v
        else:
            predicted = self.level + self.trend + self.seasonal[i]
            residual = v - predicted
            self.variance = (
                (1.0 - self.alpha) * self.variance
                + self.alpha * residual * residual
            )
            last_level = self.level
            self.level = (
                self.alpha * (v - self.seasonal[i])
                + (1.0 - self.alpha) * (self.level + self.trend)
            )
            self.trend = (
                self.beta * (self.level - last_level)
                + (1.0 - self.beta) * self.trend
            )
            self.seasonal[i] = (
                self.gamma * (v - self.level)
                + (1.0 - self.gamma) * self.seasonal[i]
            )
        self._phase += 1
        self.observations += 1

    def predict(self, steps_ahead: int = 1) -> float:
        if self.level is None:
            return 0.0
        i = (self._phase + max(steps_ahead, 1) - 1) % self.season_len
        return max(self.level + self.trend * max(steps_ahead, 1) + self.seasonal[i], 0.0)

    def std(self) -> float:
        return math.sqrt(max(self.variance, 0.0))


def build_model(
    model: str = MODEL_EWMA,
    alpha: float = 0.3,
    season_len: int = 24,
):
    """The ``--forecast-model`` grammar: ``ewma`` or ``holt-winters``."""
    if model == MODEL_EWMA:
        return Ewma(alpha=alpha)
    if model == MODEL_HOLT_WINTERS:
        return HoltWinters(alpha=alpha, season_len=season_len)
    raise ValueError(
        f"unknown forecast model {model!r} "
        f"(known: {MODEL_EWMA}, {MODEL_HOLT_WINTERS})"
    )


class ShardForecast:
    """One provisioner shard's arrival stream.

    Admission counts accumulate into the CURRENT fixed-width bucket;
    when the clock crosses a bucket boundary every closed bucket —
    including empty ones a quiet period skipped — feeds the model, so
    silence decays the predicted rate instead of freezing it."""

    # a gap longer than this many buckets resets instead of replaying
    # zeros one by one (an overnight idle must not spin the loop)
    MAX_GAP_BUCKETS = 720

    def __init__(
        self,
        bucket_s: float = DEFAULT_BUCKET_S,
        model: str = MODEL_EWMA,
        alpha: float = 0.3,
        season_len: int = 24,
    ):
        self.bucket_s = float(bucket_s)
        self._model_kwargs = dict(
            model=model, alpha=alpha, season_len=season_len
        )
        self.model = build_model(**self._model_kwargs)
        self._bucket_index: Optional[int] = None
        self._bucket_count = 0.0
        self.total_arrivals = 0

    def _roll(self, now: float) -> None:
        idx = int(now / self.bucket_s)
        if self._bucket_index is None:
            self._bucket_index = idx
            return
        if idx == self._bucket_index:
            return
        gap = idx - self._bucket_index
        self.model.update(self._bucket_count / self.bucket_s)
        if gap > self.MAX_GAP_BUCKETS:
            # long silence: the pre-gap level is noise now, and replaying
            # thousands of zero buckets one by one would spin the loop —
            # cold-start the model instead (predicts zero until new data)
            self.model = build_model(**self._model_kwargs)
        else:
            for _ in range(gap - 1):
                self.model.update(0.0)
        self._bucket_index = idx
        self._bucket_count = 0.0

    def observe(self, count: float, now: float) -> None:
        self._roll(now)
        self._bucket_count += max(float(count), 0.0)
        self.total_arrivals += int(max(count, 0))

    def rate(self, now: float, band_sigma: float = DEFAULT_BAND_SIGMA):
        """``(point, upper)`` pods/second as of ``now`` (rolls buckets
        first, so a silent stretch is priced in)."""
        self._roll(now)
        point = max(float(self.model.predict(1)), 0.0)
        upper = max(point + band_sigma * self.model.std(), point)
        return point, upper


class ArrivalForecaster:
    """The tracer finish-hook: per-provisioner arrival models plus the
    launch-to-ready sketch that sets the prediction horizon.

    Install with ``obs.configure_forecast`` (hook + flight-recorder
    ``forecast`` state panel). The hook contract is the SLO engine's:
    dispatch on span name first, O(1) work under a short lock, never
    raise."""

    WATCHED = ("provision.round", "node.ready")

    def __init__(
        self,
        bucket_s: float = DEFAULT_BUCKET_S,
        model: str = MODEL_EWMA,
        alpha: float = 0.3,
        season_len: int = 24,
        band_sigma: float = DEFAULT_BAND_SIGMA,
        default_horizon_s: float = DEFAULT_HORIZON_S,
        clock: Callable[[], float] = time.monotonic,
    ):
        build_model(model, alpha=alpha, season_len=season_len)  # validate eagerly
        self.bucket_s = float(bucket_s)
        self.model_name = model
        self.alpha = float(alpha)
        self.season_len = int(season_len)
        self.band_sigma = float(band_sigma)
        self.default_horizon_s = float(default_horizon_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._shards: Dict[str, ShardForecast] = {}  # guarded-by: self._lock
        # launch-to-ready sketch: node.ready's since_creation_s in the
        # shared log-linear geometry (obs/slo.py) — mergeable, ~2.5% error
        self._ready = Histogram()  # guarded-by: self._lock
        # pods-per-node EWMA off the same round spans: the unit conversion
        # between a pod-count prediction and a node-count speculation
        self._pods_per_node = Ewma(alpha=0.2)  # guarded-by: self._lock

    # -- intake --------------------------------------------------------------

    def __call__(self, span: Span) -> None:
        """Tracer finish-hook. Must stay fast and never raise (the tracer
        contains hook exceptions, but a slow hook taxes every span)."""
        if span.name == "provision.round":
            self._observe_round(span)
        elif span.name == "node.ready":
            self._observe_ready(span)

    def _observe_round(self, span: Span) -> None:
        provisioner = str(span.attrs.get("provisioner") or "")
        if not provisioner:
            return
        try:
            count = float(span.attrs.get("batch") or 0.0)
        except (TypeError, ValueError):
            return
        now = self._clock()
        with self._lock:
            shard = self._shards.get(provisioner)
            if shard is None:
                shard = self._shards[provisioner] = ShardForecast(
                    bucket_s=self.bucket_s, model=self.model_name,
                    alpha=self.alpha, season_len=self.season_len,
                )
            shard.observe(count, now)
            try:
                nodes = float(span.attrs.get("nodes") or 0.0)
            except (TypeError, ValueError):
                nodes = 0.0
            if nodes > 0 and count > 0:
                self._pods_per_node.update(count / nodes)
        try:
            from karpenter_tpu_torch import metrics

            metrics.FORECAST_ARRIVALS.labels(provisioner=provisioner).inc(
                max(count, 0.0)
            )
        except Exception:
            pass  # trimmed registries

    def _observe_ready(self, span: Span) -> None:
        try:
            seconds = float(span.attrs.get("since_creation_s") or 0.0)
        except (TypeError, ValueError):
            return
        if seconds <= 0:
            return
        with self._lock:
            self._ready.observe(seconds)

    # -- readout -------------------------------------------------------------

    def horizon_s(self) -> float:
        """Measured launch-to-ready p99 clamped to sane bounds; the
        configured default until the first ready transition lands."""
        with self._lock:
            p99 = self._ready.quantile(0.99)
        if p99 is None:
            return self.default_horizon_s
        return min(max(p99, MIN_HORIZON_S), MAX_HORIZON_S)

    def pods_per_node(self) -> float:
        with self._lock:
            ppn = self._pods_per_node.level
        return max(ppn or 1.0, 1.0)

    def predict(self, provisioner: str) -> Dict[str, Any]:
        """Point + upper-band arrival rate and the pod count expected
        within one launch-to-ready horizon. All-zero until the shard has
        seen a round — the warm pool never speculates on no data."""
        now = self._clock()
        horizon = self.horizon_s()
        with self._lock:
            shard = self._shards.get(provisioner)
            if shard is None:
                point = upper = 0.0
                observations = 0
            else:
                # roll FIRST: a closed-but-unrolled first bucket is data,
                # not the no-data case the zero guard below protects
                point, upper = shard.rate(now, band_sigma=self.band_sigma)
                observations = shard.model.observations
                if observations == 0:
                    point = upper = 0.0
        out = {
            "provisioner": provisioner,
            "rate_point_per_s": point,
            "rate_upper_per_s": upper,
            "horizon_s": horizon,
            "predicted_pods": point * horizon,
            "predicted_pods_upper": upper * horizon,
            "observations": observations,
        }
        try:
            from karpenter_tpu_torch import metrics

            metrics.FORECAST_RATE.labels(
                provisioner=provisioner, band="point"
            ).set(point)
            metrics.FORECAST_RATE.labels(
                provisioner=provisioner, band="upper"
            ).set(upper)
            metrics.FORECAST_HORIZON.set(horizon)
        except Exception:
            pass  # trimmed registries
        return out

    def provisioners(self) -> List[str]:
        with self._lock:
            return sorted(self._shards)

    def snapshot(self) -> Dict[str, Any]:
        """The ``/debug/forecast`` payload."""
        with self._lock:
            ready_events = self._ready.total()
        return {
            "model": self.model_name,
            "bucket_s": self.bucket_s,
            "band_sigma": self.band_sigma,
            "horizon_s": self.horizon_s(),
            "ready_observations": ready_events,
            "pods_per_node": self.pods_per_node(),
            "shards": {
                name: self.predict(name) for name in self.provisioners()
            },
        }

    def panel(self) -> Dict[str, Any]:
        """Flight-recorder state panel: compact per-shard predictions so a
        slow-solve record shows what the forecaster believed at the time."""
        return {
            "horizon_s": round(self.horizon_s(), 3),
            "shards": {
                name: round(self.predict(name)["rate_upper_per_s"], 4)
                for name in self.provisioners()
            },
        }
