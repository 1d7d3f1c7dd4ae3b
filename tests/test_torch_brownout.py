"""The port's brownout ladder against the JAX package's.

The same burning/clean sequence ticks both packages'
``BrownoutController`` (each with its own package's ``CostRouter`` and
``Cluster``; the surfaces the port lacks — provisioning, consolidation,
the warm pool — are ``None`` on both sides): the levels, the transitions,
their spans, events and metrics, and the router's knobs after every tick
equal the reference's. The router's bias and probe pause, and the
canary's pause while probes are paused, follow on both packages.
"""

from __future__ import annotations

import importlib
import random

import pytest

import karpenter_tpu.obs as J_OBS
import karpenter_tpu_torch.obs as T_OBS
from karpenter_tpu import metrics as J_METRICS
from karpenter_tpu_torch import metrics as T_METRICS
from torch_parity import fresh_router, mods, pinned, scenario  # noqa: F401

JAX, PORT = "karpenter_tpu", "karpenter_tpu_torch"
BOTH = (JAX, PORT)
OBS = {JAX: J_OBS, PORT: T_OBS}
METRICS = {JAX: J_METRICS, PORT: T_METRICS}


@pytest.fixture(autouse=True)
def _fresh_obs():
    for o in OBS.values():
        o.reset_for_tests()
    yield
    for o in OBS.values():
        o.reset_for_tests()


def mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def brownout(pkg):
    return mod(pkg, "resilience.brownout")


def each(fn):
    return {pkg: fn(pkg) for pkg in BOTH}


def same(fn):
    out = each(fn)
    assert out[PORT] == out[JAX], out
    return out[PORT]


def test_ladder_geometry_matches():
    same(lambda pkg: (lambda b: (b.MAX_LEVEL, b.LEVEL_NAMES, b.PRESSURE_BY_LEVEL,
                                 b.ROUTER_BIAS, b.ESCALATE_AFTER, b.RECOVER_AFTER,
                                 b.DEFAULT_TICK_INTERVAL))(brownout(pkg)))


def _sequence(seed: int, n: int = 40):
    """Runs of burning and clean evaluations, seeded."""
    rng = random.Random(seed)
    out = []
    while len(out) < n:
        out += [rng.random() < 0.55] * rng.randint(1, 6)
    return out[:n]


def _ladder(pkg, sequence, escalate_after, recover_after):
    b = brownout(pkg)
    router = mod(pkg, "solver.router").CostRouter()
    cluster = mods(pkg).Cluster()
    state = {"burning": False}
    ctl = b.BrownoutController(
        burning_fn=lambda: state["burning"], router=router, cluster=cluster,
        escalate_after=escalate_after, recover_after=recover_after,
    )
    m = METRICS[pkg]
    before = {d: m.BROWNOUT_TRANSITIONS.labels(direction=d)._value.get()
              for d in ("escalate", "recover")}
    ticks = []
    for burning in sequence:
        state["burning"] = burning
        level = ctl.tick()
        ticks.append((level, router.probes_paused(), router.brownout_bias(),
                      m.BROWNOUT_LEVEL._value.get()))
    ctl.stop()
    spans = [
        s["attrs"]
        for tree in OBS[pkg].exporter().trees()
        for s in OBS[pkg].spans_named(tree, "brownout.transition")
    ]
    events = [(e.type, e.reason, e.message, e.involved_kind, e.involved_name, e.count)
              for e in cluster.list("events")]
    moved = {d: m.BROWNOUT_TRANSITIONS.labels(direction=d)._value.get() - v
             for d, v in before.items()}
    return ticks, ctl.report(), list(ctl.transitions), spans, events, moved, ctl.level()


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("escalate_after,recover_after", [(1, 1), (2, 3)])
def test_transitions_equal_the_reference(seed, escalate_after, recover_after):
    out = same(lambda pkg: _ladder(pkg, _sequence(seed), escalate_after, recover_after))
    ticks, _, transitions, spans, events, moved, final = out
    assert spans == transitions  # every transition is a span
    assert len(events) >= 1 or not transitions
    assert final == 0  # stop() reverses whatever rung was engaged
    assert moved["escalate"] == sum(t["direction"] == "escalate" for t in transitions)


def test_ladder_climbs_to_the_top_and_recovers():
    seq = [True] * 6 + [False] * 5
    ticks, report, transitions, *_ = same(lambda pkg: _ladder(pkg, seq, 1, 1))
    levels = [t[0] for t in ticks]
    assert levels == [1, 2, 3, 4, 4, 4, 3, 2, 1, 0, 0]
    # rung 1 pauses the probes, rung 3 biases the router; both clear
    assert ticks[0][1] is True and ticks[2][2] == brownout(PORT).ROUTER_BIAS
    assert ticks[-1][1:] == (False, 1.0, 0.0)


def test_broken_sensor_counts_as_clean():
    def run(pkg):
        ctl = brownout(pkg).BrownoutController(burning_fn=lambda: 1 / 0,
                                               escalate_after=1, recover_after=1)
        ctl._level = 2
        return ctl.tick()

    assert same(run) == 1


def test_default_sensor_reads_the_slo_engine():
    def run(pkg):
        o = OBS[pkg]
        ctl = brownout(pkg).BrownoutController(escalate_after=1)
        quiet = ctl.tick()
        eng = o.configure_slo(objectives=["solve.p99 < 100ms"], window_s=60)
        clean = ctl.tick()
        for _ in range(12):
            with o.tracer().span("solver.solve") as sp:
                sp.start -= 0.2  # a 200 ms solve, without sleeping
        burning = eng.burning_panel()["solve_p99"]["burning"]
        return quiet, clean, burning, ctl.tick()

    assert same(run) == (0, 0, True, 1)


def test_router_probes_pause_and_resume():
    def run(pkg):
        r = mod(pkg, "solver.router").CostRouter(probe_every=1)
        key = (1, 2, 3, 0)
        r.record(key, "device", 0.1)
        r.record(key, "native", 0.2)
        r.choose(key, ["device", "native"])
        seen = [r.should_probe(key)]
        r.set_probes_paused(True)
        seen += [r.should_probe(key), r.probes_paused()]
        r.set_probes_paused(False)
        seen.append(r.should_probe(key))
        return seen

    assert same(run) == [True, False, True, True]


def test_router_bias_routes_marginal_races_to_native_and_reverses():
    def run(pkg):
        r = mod(pkg, "solver.router").CostRouter()
        key = (1, 2, 3, 0)
        r.record(key, "device", 0.010)
        r.record(key, "native", 0.012)
        seen = [r.choose(key, ["device", "native"])]
        r.set_brownout_bias(8.0)
        seen.append(r.choose(key, ["device", "native"]))
        r.set_brownout_bias(0.5)  # clamped to no bias
        seen += [r.brownout_bias(), r.choose(key, ["device", "native"]), r.ema(key, "device")]
        return seen

    assert same(run) == ["device", "native", 1.0, "device", 0.010]


def _canary_solves(pkg, paused: bool) -> int:
    """One canaried solve (rate 1.0) with the process router's probes
    paused or not; the canary re-solves that ran."""
    native = mod(pkg, "solver.native")
    if not native.native_available(wait=240.0):
        pytest.skip("native packer unavailable")
    integrity = mod(pkg, "solver.integrity")
    router = mod(pkg, "solver.router").default_router()
    prov, catalog, pods = scenario(pkg, "diverse", 96, 42, 12)
    sched_mod = mod(pkg, "scheduling.scheduler")
    extra = {"device": "cpu"} if pkg == PORT else {}
    sched = sched_mod.Scheduler(mods(pkg).Cluster(), rng=random.Random(1),
                                canary_rate=1.0, **extra)
    backend = sched.torch if pkg == PORT else sched._tpu_scheduler()
    before = integrity.totals()["canary_solves"]
    router.set_probes_paused(paused)
    try:
        with pinned(pkg):
            sched.solve(prov, catalog, pods)
        if backend._canary_thread is not None:
            backend._canary_thread.join(timeout=120)
            assert not backend._canary_thread.is_alive()
    finally:
        router.set_probes_paused(False)
    return integrity.totals()["canary_solves"] - before


@pytest.mark.parametrize("paused", [True, False])
def test_canary_pauses_while_probes_are_paused(paused):
    assert same(lambda pkg: _canary_solves(pkg, paused)) == (0 if paused else 1)
