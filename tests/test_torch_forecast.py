"""The port's arrival forecaster (``forecast/``), its ``obs`` wiring and
``testing.chaos.ArrivalPattern`` against the JAX package's.

Mirrors ``tests/test_forecast.py`` (``TestEwma``, ``TestHoltWinters``,
``TestBuildModel``, ``TestShardForecast``, ``TestArrivalForecaster``,
``TestObsWiring``): each case feeds the same seeded series or span stream,
on a fake clock, to both packages and compares every reading exactly. Both
sides run the same Python float arithmetic in the same order, so no
tolerance is used.
"""

import importlib
import random
from types import SimpleNamespace

import pytest

from torch_parity import PACKAGES, FakeClock


def fc(pkg: str) -> SimpleNamespace:
    def m(name):
        return importlib.import_module(f"{pkg}.{name}")

    return SimpleNamespace(pkg=pkg, model=m("forecast.model"), forecast=m("forecast"),
                           obs=m("obs"), Span=m("obs.trace").Span, metrics=m("metrics"),
                           chaos=m("testing.chaos"))


def both(fn):
    """``fn`` on each package's modules; the port's result, once it equals
    the reference's."""
    out = [fn(fc(pkg)) for pkg in PACKAGES]
    assert out[1] == out[0]
    return out[1]


def span(F, name, **attrs):
    return F.Span(name=name, trace_id="t" * 32, span_id="s" * 16, parent_id=None,
                  parent=None, attrs=attrs)


def series(seed: int, n: int = 60) -> list:
    """A seeded arrival-rate series with a square-wave season, noise and a
    spike."""
    rng = random.Random(seed)
    return [(10.0 if (i // 3) % 2 else 1.0) + rng.random() * 2.0 + (40.0 if i == n // 2 else 0.0)
            for i in range(n)]


def readings(m) -> tuple:
    return (m.level, m.variance, m.observations, m.predict(1), m.predict(7), m.std(),
            getattr(m, "trend", None), list(getattr(m, "seasonal", [])))


# -- TestEwma, TestHoltWinters, TestBuildModel --------------------------------


@pytest.mark.parametrize("model", ["ewma", "holt-winters"])
@pytest.mark.parametrize("seed", [1, 2])
def test_model_readings_over_a_series(model, seed):
    def run(F):
        kw = {"alpha": 0.3} if model == "ewma" else {
            "alpha": 0.3, "beta": 0.1, "gamma": 0.5, "season_len": 6}
        m = F.model.Ewma(**kw) if model == "ewma" else F.model.HoltWinters(**kw)
        out = [readings(m)]
        for v in series(seed):
            m.update(v)
            out.append(readings(m))
        return out

    out = both(run)
    assert out[0][3] == 0.0 and out[-1][2] == 60


@pytest.mark.parametrize("kwargs", [
    ("ewma", {"alpha": 0.0}), ("ewma", {"alpha": -0.1}), ("ewma", {"alpha": 1.5}),
    ("hw", {"alpha": 0.0}), ("hw", {"beta": -0.1}), ("hw", {"gamma": 2.0}),
    ("hw", {"season_len": 1}), ("build", {"model": "arima"})])
def test_model_validation(kwargs):
    which, kw = kwargs

    def run(F):
        make = {"ewma": F.model.Ewma, "hw": F.model.HoltWinters,
                "build": F.model.build_model}[which]
        with pytest.raises(ValueError) as err:
            make(**kw)
        return str(err.value)

    both(run)


def test_build_model_grammar_and_constants():
    def run(F):
        f = F.forecast
        return (type(f.build_model(f.MODEL_EWMA)).__name__,
                type(f.build_model(f.MODEL_HOLT_WINTERS, season_len=6)).__name__,
                f.build_model(f.MODEL_HOLT_WINTERS, season_len=6).season_len,
                f.DEFAULT_BUCKET_S, f.DEFAULT_BAND_SIGMA, f.MIN_HORIZON_S, f.MAX_HORIZON_S,
                f.DEFAULT_HORIZON_S, f.MODEL_EWMA, f.MODEL_HOLT_WINTERS)

    assert both(run)[:3] == ("Ewma", "HoltWinters", 6)


# -- TestShardForecast ---------------------------------------------------------


@pytest.mark.parametrize("model", ["ewma", "holt-winters"])
def test_shard_forecast_buckets_gaps_and_resets(model):
    """Observations inside a bucket, closed buckets, a silent stretch
    replayed as zeros, a negative count, and a gap past MAX_GAP_BUCKETS
    that cold-starts the model: each reading after each step."""
    def run(F):
        s = F.model.ShardForecast(bucket_s=10.0, model=model, alpha=0.5, season_len=4)
        rng = random.Random(5)
        out, now = [], 0.0
        for _ in range(40):
            now += rng.choice([0.5, 3.0, 10.0, 27.0])
            s.observe(rng.choice([-5, 0, 3, 12, 40]), now=now)
            out.append((s.rate(now), s.rate(now + 5.0, band_sigma=1.0), s.total_arrivals,
                        s.model.observations))
        out.append((s.rate(now + 7 * 24 * 3600.0), s.model.observations))
        return out

    out = both(run)
    assert out[-1][0][0] == 0.0


# -- TestArrivalForecaster -----------------------------------------------------


def stream(F, eng, clock, seed: int) -> list:
    """A seeded span stream on the fake clock: rounds of three
    provisioners (some with node counts), ready transitions, malformed and
    foreign spans; every reading after each step."""
    rng = random.Random(seed)
    out = []
    for i in range(80):
        clock.t += rng.choice([0.25, 1.0, 4.0, 11.0])
        kind = rng.random()
        if kind < 0.6:
            eng(span(F, "provision.round", provisioner=rng.choice(["a", "b", "c"]),
                     batch=rng.choice([0, 1, 5, 30]), nodes=rng.choice([0, 1, 3])))
        elif kind < 0.8:
            eng(span(F, "node.ready", since_creation_s=rng.choice([0.01, 3.0, 45.0, 120.0])))
        else:
            eng(span(F, rng.choice(["provision.round", "node.ready", "other"]),
                     batch="not-a-number", since_creation_s="nan?"))
        out.append((eng.horizon_s(), eng.pods_per_node(), eng.provisioners(),
                    [eng.predict(p) for p in ("a", "b", "nobody")]))
    out.append((eng.snapshot(), eng.panel()))
    return out


@pytest.mark.parametrize("model", ["ewma", "holt-winters"])
@pytest.mark.parametrize("seed", [3, 4])
def test_forecaster_span_stream(model, seed):
    def run(F):
        clock = FakeClock()
        eng = F.model.ArrivalForecaster(bucket_s=10.0, model=model, alpha=0.35,
                                        season_len=4, default_horizon_s=45.0, clock=clock)
        return stream(F, eng, clock, seed)

    out = both(run)
    snap, panel = out[-1]
    assert set(snap["shards"]) == {"a", "b", "c"} and set(panel) == {"horizon_s", "shards"}


def test_forecaster_zero_until_first_round_and_horizon_clamps():
    def run(F):
        eng = F.model.ArrivalForecaster(bucket_s=10.0, clock=FakeClock())
        cold = eng.predict("nobody")
        for _ in range(20):
            eng(span(F, "node.ready", since_creation_s=0.01))
        low = eng.horizon_s()
        for _ in range(400):
            eng(span(F, "node.ready", since_creation_s=86400.0))
        return cold, low, eng.horizon_s()

    cold, low, high = both(run)
    assert cold["observations"] == 0 and cold["predicted_pods_upper"] == 0.0
    assert (low, high) == (5.0, 900.0)


# -- TestObsWiring -------------------------------------------------------------


def test_obs_wiring_hook_payload_and_ownership():
    """configure installs the tracer hook and the ``forecast`` state
    panel; the payload before and after; a stale owner's shutdown leaves
    the current engine; a bad model is refused before anything installs."""
    def run(F):
        obs = F.obs
        obs.shutdown_forecast()
        flight = importlib.import_module(f"{F.pkg}.obs.flight")
        empty = obs.debug_forecast_payload()
        with pytest.raises(ValueError):
            obs.configure_forecast(model="prophet")
        refused = obs.forecaster() is None
        clock = FakeClock()
        eng1 = obs.configure_forecast(bucket_s=10.0, clock=clock)
        eng2 = obs.configure_forecast(bucket_s=10.0, alpha=1.0, clock=clock)
        try:
            with obs.tracer().span("provision.round",
                                   attrs={"provisioner": "wired", "batch": 4, "nodes": 2}):
                pass
            clock.t = 10.0
            obs.shutdown_forecast(eng1)  # stale owner
            current = obs.forecaster() is eng2
            payload = obs.debug_forecast_payload()
            panel = flight.state_snapshot().get("forecast")
        finally:
            obs.shutdown_forecast(eng2)
        return (empty, refused, current, eng1.provisioners(), payload, panel,
                obs.forecaster() is None, obs.debug_forecast_payload(),
                "forecast" in flight.state_snapshot())

    out = both(run)
    assert out[:4] == ({"forecast": {}}, True, True, [])
    assert out[4]["forecast"]["shards"]["wired"]["rate_point_per_s"] == 0.4
    assert out[6:] == (True, {"forecast": {}}, False)


def test_metric_families_move_by_the_same_amounts():
    def run(F):
        M = F.metrics
        eng = F.model.ArrivalForecaster(bucket_s=10.0, clock=FakeClock(20.0))
        before = M.FORECAST_ARRIVALS.labels(provisioner="metered")._value.get()
        eng(span(F, "provision.round", provisioner="metered", batch=6))
        eng.predict("metered")
        return (M.FORECAST_ARRIVALS.labels(provisioner="metered")._value.get() - before,
                M.FORECAST_RATE.labels(provisioner="metered", band="upper")._value.get(),
                M.FORECAST_HORIZON._value.get())

    assert both(run) == (6.0, 0.0, 60.0)


# -- ArrivalPattern --------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 7, 20260807])
def test_arrival_pattern_schedule(seed):
    """The forecast storm's pattern (30 s, period 15, flashes at 16.5 and
    24) and the class defaults: the schedule, the total, the flash windows
    and the noiseless baseline."""
    def run(F):
        A = F.chaos.ArrivalPattern
        storm = A(base_pods_per_tick=3.0, amplitude=0.7, period_s=15.0, tick_s=1.0,
                  flash_at=(16.5, 24.0), flash_pods=24, flash_len_s=3.0, seed=seed)
        default = A(seed=seed, flash_at=(100.0,), amplitude=2.0)
        return (storm.schedule(30.0), storm.total_pods(30.0),
                [storm.in_flash(t / 2) for t in range(60)], [storm.rate_at(t) for t in range(30)],
                default.schedule(300.0), default.amplitude)

    out = both(run)
    assert out[5] == 1.0 and any(out[2])
