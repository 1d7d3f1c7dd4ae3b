"""The port's observability plane against the JAX package's.

Every test runs the same inputs through ``karpenter_tpu.obs`` and
``karpenter_tpu_torch.obs`` (and their schedulers, sidecars and metric
registries) and holds the port's result to the reference's: the span core
and its wire form, the trace ring and its analysis helpers, the flight
recorder, the SLO grammar and engine, the solve's span tree, the traced
v3 frames across the packages' clients and sidecars, the sidecar's debug
surface, the metric families the same events move, the flight
recorder's wire-dominance rule, and trace-stamped logging
(``logging_config``). Both packages' obs state is reset around every test
(``obs.reset_for_tests()`` on each side), and each package's events are
read from its own registry only. Counters and state panels are
process-global (other test modules count into them and register panels),
so a test reads counters as deltas and compares only its own panels.
"""

from __future__ import annotations

import importlib
import json
import random
import socket
import threading
import time
import urllib.request

import numpy as np
import pytest

import karpenter_tpu.obs as J_OBS
import karpenter_tpu_torch.obs as T_OBS
from karpenter_tpu import metrics as J_METRICS
from karpenter_tpu_torch import metrics as T_METRICS
from torch_parity import (  # noqa: F401
    PORT_ONLY_SPANS, STAGES, fresh_router, mods, packer, pinned, port_spans_sit, scenario,
    strip_port_only,
)

JAX, PORT = "karpenter_tpu", "karpenter_tpu_torch"
OBS = {JAX: J_OBS, PORT: T_OBS}
METRICS = {JAX: J_METRICS, PORT: T_METRICS}
BOTH = (JAX, PORT)


@pytest.fixture(autouse=True)
def _fresh_obs():
    for o in OBS.values():
        o.reset_for_tests()
    yield
    for o in OBS.values():
        o.reset_for_tests()


def mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def shape(tree: dict, values: bool = False) -> tuple:
    """A span tree without its times and ids: names, attribute keys (and
    values when asked), error, and the children in order."""
    attrs = tree["attrs"]
    return (
        tree["name"],
        tuple(sorted(attrs.items())) if values else tuple(sorted(attrs)),
        tree["error"],
        tuple(shape(c, values) for c in tree["children"]),
    )


def each(fn):
    """``fn(pkg)`` for both packages → ``{pkg: result}``."""
    return {pkg: fn(pkg) for pkg in BOTH}


def same(fn):
    out = each(fn)
    assert out[PORT] == out[JAX], out
    return out[PORT]


def free_address() -> str:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return f"127.0.0.1:{port}"


# ---------------------------------------------------------------------------
# span core
# ---------------------------------------------------------------------------


def test_nesting_follows_contextvar():
    def run(pkg):
        tr = OBS[pkg].tracer()
        with tr.span("a", attrs={"k": 1}):
            with tr.span("b"):
                with tr.span("c") as c:
                    c.set_attribute("x", "y")
            with tr.span("d"):
                pass
        trees = OBS[pkg].exporter().trees()
        assert len(trees) == 1
        t = trees[0]
        assert all(ch["parent_id"] == t["span_id"] for ch in t["children"])
        assert all(ch["trace_id"] == t["trace_id"] for ch in t["children"])
        return shape(t, values=True)

    assert same(run)[0] == "a"


def test_error_recorded_and_reraised():
    def run(pkg):
        with pytest.raises(ValueError):
            with OBS[pkg].tracer().span("boom"):
                raise ValueError("bad")
        return shape(OBS[pkg].exporter().trees()[0])

    assert same(run)[2] == "ValueError: bad"


def test_explicit_parent_across_threads():
    def run(pkg):
        tr = OBS[pkg].tracer()
        with tr.span("root") as root:
            def work():
                # contextvars do not cross threads: parent= does
                with tr.span("in-thread", parent=root):
                    pass
                with tr.span("orphan"):
                    pass

            t = threading.Thread(target=work)
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()
        trees = OBS[pkg].exporter().trees()
        return sorted(shape(t) for t in trees)

    names = [t[0] for t in same(run)]
    assert names == ["orphan", "root"]


def test_remote_parent_makes_local_root():
    def run(pkg):
        o = OBS[pkg]
        ctx = o.SpanContext("ab" * 16, "12" * 8)
        with o.tracer().span("server", parent=ctx):
            pass
        t = o.exporter().trees()[0]
        return t["trace_id"], t["parent_id"], shape(t)

    assert same(run)[:2] == ("ab" * 16, "12" * 8)


def test_child_record_attaches_completed_span():
    def run(pkg):
        with OBS[pkg].tracer().span("wire") as sp:
            child = sp.add_child_record("sidecar.solve", 0.25, attrs={"n": 3})
            assert abs(child.duration_s - 0.25) < 1e-9
        t = OBS[pkg].exporter().trees()[0]
        assert abs(t["children"][0]["duration_ms"] - 250.0) < 1e-6
        return shape(t, values=True)

    same(run)


def test_disabled_tracer_is_noop():
    def run(pkg):
        o = OBS[pkg]
        o.set_enabled(False)
        # the exporter's counters are the process's (earlier tests' spans
        # stay counted): what the disabled span moved is the difference
        before = o.exporter().stats()
        with o.tracer().span("x") as sp:
            sp.set_attribute("a", 1)
            sp.add_child_record("y", 0.1)
            assert o.tracer().current() is None
        after = o.exporter().stats()
        return {k: after[k] - before[k] for k in after}

    moved = same(run)
    assert set(moved.values()) == {0}, moved


def test_ring_eviction_counts_drops():
    def run(pkg):
        o = OBS[pkg]
        ring = o.RingExporter(capacity=2)
        tr = o.Tracer(exporter=ring)
        for i in range(5):
            with tr.span(f"t{i}"):
                with tr.span("child"):
                    pass
        return ring.stats(), [t["name"] for t in ring.trees()]

    stats, names = same(run)
    assert stats["dropped_spans"] == 6 and names == ["t3", "t4"]


def test_dump_jsonl(tmp_path):
    def run(pkg):
        o = OBS[pkg]
        for i in range(3):
            with o.tracer().span(f"s{i}"):
                pass
        path = tmp_path / f"{pkg}.jsonl"
        n = o.exporter().dump_jsonl(str(path))
        return n, [json.loads(line)["name"] for line in path.read_text().splitlines()]

    assert same(run) == (3, ["s0", "s1", "s2"])


def test_ring_gauges_track_residency():
    def run(pkg):
        o, m = OBS[pkg], METRICS[pkg]
        for _ in range(3):
            with o.tracer().span("x"):
                with o.tracer().span("y"):
                    pass
        held = (m.TRACE_RING_TREES._value.get(), m.TRACE_RING_SPANS._value.get())
        o.exporter().clear()
        return held, (m.TRACE_RING_TREES._value.get(), m.TRACE_RING_SPANS._value.get())

    assert same(run) == ((3.0, 6.0), (0.0, 0.0))


# ---------------------------------------------------------------------------
# traceparent, analysis
# ---------------------------------------------------------------------------


def test_traceparent_round_trip():
    def run(pkg):
        o = OBS[pkg]
        ctx = o.SpanContext("cd" * 16, "34" * 8)
        header = o.to_traceparent(ctx)
        back = o.from_traceparent(header.upper())
        with o.tracer().span("s") as sp:
            live = o.to_traceparent(sp)
        return header, tuple(back), live.count("-")

    assert same(run)[0] == "00-" + "cd" * 16 + "-" + "34" * 8 + "-01"


@pytest.mark.parametrize("bad", [
    None, "", "garbage", "00-abc-def-01", "00-" + "g" * 32 + "-" + "1" * 16 + "-01",
    "00-" + "a" * 31 + "-" + "1" * 16 + "-01", "00-" + "a" * 32 + "-" + "1" * 15 + "-01",
])
def test_traceparent_malformed_degrades_to_none(bad):
    assert same(lambda pkg: OBS[pkg].from_traceparent(bad)) is None


def _tree(trace_id, spans):
    """A dict tree: ``spans`` = (name, t0, t1, children)."""
    def node(name, t0, t1, children=()):
        return {
            "name": name, "trace_id": trace_id, "t0": t0, "t1": t1,
            "duration_ms": (t1 - t0) * 1e3,
            "children": [node(*c) for c in children],
        }
    return node(*spans)


def test_critical_path_self_times():
    tree = _tree("t1", ("root", 0.0, 0.100, [
        ("encode", 0.0, 0.020, []),
        ("pack", 0.020, 0.090, [("fetch", 0.030, 0.080, [])]),
    ]))
    out = same(lambda pkg: OBS[pkg].critical_path(tree))
    assert [s["name"] for s in out] == ["root", "pack", "fetch"]


def test_overlapping_pairs_and_spans_named():
    trees = [
        _tree("a", ("solver.solve", 0.0, 1.0, [
            ("solve.encode", 0.0, 0.3, []), ("solve.pack_fetch", 0.3, 0.9, [])])),
        _tree("b", ("solver.solve", 0.5, 1.5, [
            ("solve.encode", 0.5, 0.7, []), ("solve.pack_fetch", 0.7, 1.4, [])])),
    ]
    assert same(lambda pkg: OBS[pkg].overlapping_pairs(trees)) == 1
    names = same(lambda pkg: sorted(s["trace_id"] for t in trees
                                    for s in OBS[pkg].spans_named(t, "solve.encode")))
    assert names == ["a", "b"]


# ---------------------------------------------------------------------------
# flight recorder
# ---------------------------------------------------------------------------


def test_flight_records_only_over_budget_and_caps_the_ring(tmp_path):
    def run(pkg):
        o = OBS[pkg]
        rec = o.configure_flight(str(tmp_path / pkg), budget_s=0.05, cap=3)
        o.register_state("router_ema", lambda: {"device@x": 0.01})

        def boom():
            raise RuntimeError("panel down")

        o.register_state("broken", boom)
        try:
            for slow in [True, False, True, True, True, True]:
                with o.tracer().span("solver.solve") as sp:
                    if slow:
                        # backdate the start: the duration is what counts
                        sp.start -= 0.2
            with o.tracer().span("other") as sp:
                sp.start -= 1.0
        finally:
            o.unregister_state("router_ema")
            o.unregister_state("broken")
        recent = rec.recent()
        # only this test's panels: the process may hold panels that other
        # modules registered before it (and never unregister)
        mine = ("broken", "router_ema")
        payloads = [
            (r["name"], r["budget_s"], sorted(k for k in r["state"] if k in mine),
             r["state"]["broken"], r["state"]["router_ema"], sorted(r))
            for r in recent
        ]
        return rec.records_written, len(list((tmp_path / pkg).iterdir())), payloads

    written, on_disk, payloads = same(run)
    assert (written, on_disk, len(payloads)) == (5, 3, 3)
    assert payloads[0][3] == "<state provider failed: panel down>"


def test_flight_panel_error_counted():
    def run(pkg):
        o, m = OBS[pkg], METRICS[pkg]
        o.register_state("bad", lambda: 1 / 0)
        try:
            before = m.FLIGHT_PANEL_ERRORS.labels(panel="bad")._value.get()
            snap = o.state_snapshot(only=("bad",))
            return snap, m.FLIGHT_PANEL_ERRORS.labels(panel="bad")._value.get() - before
        finally:
            o.unregister_state("bad")

    assert same(run)[1] == 1.0


# ---------------------------------------------------------------------------
# SLO grammar and engine
# ---------------------------------------------------------------------------


def slo(pkg: str):
    return mod(pkg, "obs.slo")


def test_slo_defaults_and_sidecar_sets_parse():
    def run(pkg):
        s = slo(pkg)
        out = []
        for exprs in (s.DEFAULT_OBJECTIVES, s.SIDECAR_OBJECTIVES):
            out.append([
                (o.name, o.kind, o.span_name, o.quantile, o.op_name, o.threshold, o.budget)
                for o in s.parse_objectives(exprs)
            ])
        return out

    defaults, sidecar = same(run)
    assert ("solve_p99", "latency", "solver.solve", 0.99, "<", 0.1, pytest.approx(0.01)) == defaults[0]
    assert sidecar[0][0] == "sidecar_pack_p99"


@pytest.mark.parametrize("expr", [
    "solve.p99 100ms", "nope.p99 < 1s", "solve.p999 < 1s", "solve.median < 1s",
    "solve.p99 < fast", "session.catalog_hit_rate",
])
def test_slo_bad_expression_raises(expr):
    def run(pkg):
        with pytest.raises(ValueError):
            slo(pkg).Objective(expr)
        return True

    same(run)


@pytest.mark.parametrize("expr", [
    "solve.p50 < 250us", "solve.p99 <= 1.5s", "kube.p90 < 2m",
    "provision.success_rate >= 0.999", "session.catalog_hit_rate >= 0.9",
    "time_to_bind.mean < 5s", "sidecar.pack.p99 < 100ms",
])
def test_slo_units_thresholds_and_budgets(expr):
    same(lambda pkg: (lambda o: (o.name, o.kind, o.threshold, o.budget, o.quantile))(
        slo(pkg).Objective(expr)))


def test_slo_name_collision_and_config_file(tmp_path):
    def run(pkg):
        s = slo(pkg)
        with pytest.raises(ValueError):
            s.parse_objectives(["solve.p99 < 1s", "solve.p99 < 2s"])
        path = tmp_path / f"{pkg}.slo"
        path.write_text("# objectives\nsolve.p99 < 100ms  # the north star\n\nkube.p99 < 1s\n")
        good = s.load_objectives(str(path))
        bad = tmp_path / f"{pkg}.bad"
        bad.write_text("solve.p99 < soon\n")
        with pytest.raises(ValueError):
            s.load_objectives(str(bad))
        return good

    assert same(run) == ["solve.p99 < 100ms", "kube.p99 < 1s"]


class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


class _FakeSpan:
    """A finished span as the engine's hook sees it."""

    def __init__(self, name, duration_s, trace_id="", error=None, attrs=None):
        self.name = name
        self.duration_s = duration_s
        self.trace_id = trace_id
        self.error = error
        self.attrs = attrs or {}


def _drive_engine(pkg, events, window_s=60.0, objectives=None):
    """The same stream of (dt, span name, duration, error, ratio) events
    through one package's engine; the verdicts after each event."""
    clock = _Clock()
    eng = slo(pkg).SloEngine(objectives=objectives, window_s=window_s, clock=clock)
    verdicts = []
    for i, (dt, name, dur, err, ratio) in enumerate(events):
        clock.t += dt
        if ratio is not None:
            eng.record_ratio("session.catalog_hit_rate", ratio, trace_id=f"r{i}")
        else:
            eng(_FakeSpan(name, dur, trace_id=f"{i:032x}", error=err))
        snap = eng.snapshot()["objectives"]
        verdicts.append({
            k: (v["value"], v["ok"], v["burn_rate"], v["burning"], v["events"], v["exemplars"])
            for k, v in snap.items()
        })
    return eng, verdicts


def _event_stream(seed=5, n=650):
    rng = np.random.default_rng(seed)
    events = []
    for i in range(n):
        dt = float(rng.uniform(0.05, 0.6))
        phase_bad = 150 <= i < 300
        if i % 5 == 4:
            events.append((dt, None, None, None, bool(rng.random() < (0.6 if phase_bad else 0.97))))
        elif i % 7 == 3:
            err = "boom" if (phase_bad and rng.random() < 0.3) else None
            events.append((dt, "provision.round", float(rng.uniform(0.01, 0.5)), err, None))
        else:
            base = 0.14 if phase_bad else 0.03
            events.append((dt, "solver.solve", float(rng.lognormal(np.log(base), 0.3)), None, None))
    return events


def test_slo_engine_same_stream_same_verdicts_and_transitions():
    events = _event_stream()
    out = each(lambda pkg: _drive_engine(pkg, events)[1])
    assert out[PORT] == out[JAX]
    burning = [v["solve_p99"][3] for v in out[PORT]]
    # the regression phase burns, and the recovery clears it
    assert any(burning) and not burning[0] and not burning[-1]
    hit = [v["session_catalog_hit_rate"][3] for v in out[PORT]]
    assert any(hit)


def test_slo_online_quantile_tracks_offline_within_5pct():
    rng = np.random.default_rng(11)
    values = rng.lognormal(np.log(0.05), 0.5, 3000)

    def run(pkg):
        clock = _Clock()
        eng = slo(pkg).SloEngine(objectives=["solve.p99 < 1s"], window_s=600.0, clock=clock)
        for v in values:
            eng(_FakeSpan("solver.solve", float(v)))
        return eng.snapshot()["objectives"]["solve_p99"]["value"]

    online = same(run)
    offline = float(np.sort(values)[int(np.ceil(0.99 * len(values))) - 1])
    assert abs(online - offline) / offline < 0.05


def test_slo_gauges_and_counters_published():
    events = _event_stream(seed=8, n=200)

    def run(pkg):
        m = METRICS[pkg]
        names = ("solve_p99", "provision_success_rate", "session_catalog_hit_rate")

        def counts():
            # the counters are process-global: earlier tests of either
            # package may have counted into them, so compare deltas
            return {n: tuple(m.SLO_EVENTS.labels(objective=n, verdict=v)._value.get()
                             for v in ("good", "bad")) for n in names}

        before = counts()
        _drive_engine(pkg, events)
        after = counts()
        return {
            n: (
                m.SLO_BURNING.labels(objective=n)._value.get(),
                m.SLO_BURN_RATE.labels(objective=n, window="fast")._value.get(),
                m.SLO_BURN_RATE.labels(objective=n, window="slow")._value.get(),
                m.SLO_OBJECTIVE_OK.labels(objective=n)._value.get(),
                after[n][0] - before[n][0],
                after[n][1] - before[n][1],
            )
            for n in names
        }

    same(run)


def test_slo_engine_on_the_tracer_feeds_and_detaches():
    def run(pkg):
        o = OBS[pkg]
        eng = o.configure_slo(objectives=["solve.p99 < 100ms"], window_s=60.0)
        for _ in range(3):
            with o.tracer().span("solver.solve"):
                pass
        events = eng.snapshot()["objectives"]["solve_p99"]["events"]["fast"]
        panel = sorted(o.state_snapshot(only=("slo",))["slo"])
        o.shutdown_slo(object())  # not the owner: a no-op
        assert o.slo_engine() is eng
        o.shutdown_slo(eng)
        return events, panel, o.slo_engine(), o.slo_snapshot()

    assert same(run) == (3, ["solve_p99"], None, {})


# ---------------------------------------------------------------------------
# the solve's span tree
# ---------------------------------------------------------------------------


def _scheduler(pkg, **kw):
    M = mods(pkg)
    sched_mod = mod(pkg, "scheduling.scheduler")
    extra = {"device": "cpu"} if pkg == PORT else {}
    return sched_mod.Scheduler(M.Cluster(), rng=random.Random(1), **extra, **kw)


def _traced_rounds(pkg, name="diverse", n_pods=160, n_types=16, rounds=2, route=None, **kw):
    """A warm-up and ``rounds`` traced solves; each package on its pinned
    packer unless ``route`` names one for both."""
    prov, catalog, pods = scenario(pkg, name, n_pods, 42, n_types)
    sched = _scheduler(pkg, **kw)
    with (packer(route) if route else pinned(pkg)):
        sched.solve(prov, catalog, pods)  # warm-up
        OBS[pkg].exporter().clear()
        for _ in range(rounds):
            sched.solve(prov, catalog, pods)
    return sched, OBS[pkg].exporter().trees()


@pytest.mark.parametrize("name", ["diverse", "teams"])
def test_solve_span_trees_match_the_reference(name):
    """The port's trees without ``PORT_ONLY_SPANS`` are the reference's;
    the port's own spans sit where ``port_spans_sit`` says."""
    port_trees = []

    def run(pkg):
        _, trees = _traced_rounds(pkg, name, n_pods=160, n_types=16)
        if pkg == PORT:
            port_trees.extend(trees)
        out = []
        for t in trees:
            s = shape(strip_port_only(t))
            root_values = {k: v for k, v in t["attrs"].items()}
            out.append((s, root_values))
        return out

    trees = same(run)
    assert len(trees) == 2
    (root, _, _, children), values = trees[0]
    assert root == "solver.solve" and tuple(c[0] for c in children) == STAGES
    assert values["solver"] == "tpu" and values["pods"] == 160
    for t in port_trees:
        port_spans_sit(t)


def test_resident_span_trees_match_the_reference():
    port_trees = []

    def run(pkg):
        trees = _traced_rounds(pkg, solver_delta=True, rounds=3)[1]
        if pkg == PORT:
            port_trees.extend(trees)
        return [shape(strip_port_only(t)) for t in trees]

    same(run)
    for t in port_trees:
        port_spans_sit(t)
    # the resident rounds reuse the sort, the pod table and the verdict
    sort, begin, validate = (port_trees[-1]["children"][i] for i in (0, 3, 6))
    assert sort["children"] == [] and validate["attrs"] == {"memo_hit": True, "native": False}
    assert [c["name"] for c in begin["children"]] == [
        "pack.pod_table", "pack.invariants", "pack.launch"]


def test_stage_spans_agree_with_profile_within_1ms():
    sched, trees = _traced_rounds(PORT, rounds=1)
    prof = sched.last_stage_profile()
    stages = {c["name"]: c["duration_ms"] for c in trees[0]["children"]}
    stages["solve.statics"] = trees[0]["children"][0]["children"][0]["duration_ms"]
    for span_name, key in [("solve.sort", "sort_s"), ("solve.inject", "inject_s"),
                           ("solve.encode", "encode_s"), ("solve.decode", "decode_s"),
                           ("solve.statics", "statics_s"), ("solve.validate", "validate_s"),
                           ("solve.pack_begin", "pack_begin_s")]:
        assert abs(stages[span_name] - prof[key] * 1e3) < 1.0, (span_name, stages, prof)
    packed = stages["solve.pack_begin"] + stages["solve.pack_fetch"]
    assert abs(packed - prof["pack_fetch_s"] * 1e3) < 1.0
    assert trees[0]["children"][4]["attrs"]["backend"] == prof["packer_backend"]


def test_stage_spans_agree_under_the_two_thread_pipeline():
    """Two threads share one scheduler: the fetch, decode and validate of
    one round run off the solve lock while the other encodes. Each tree
    stays whole (six stage children under its own root without
    ``PORT_ONLY_SPANS``, no orphan roots, the port's own spans in place)."""
    prov, catalog, pods = scenario(PORT, "diverse", 160, 42, 16)
    sched = _scheduler(PORT)
    with pinned(PORT):
        sched.solve(prov, catalog, pods)
        T_OBS.exporter().clear()
        profs = {}

        def worker(i):
            for _ in range(3):
                sched.solve(prov, catalog, pods)
            profs[i] = sched.last_stage_profile()

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
    trees = T_OBS.exporter().trees()
    assert len(trees) == 6
    for t in trees:
        assert t["name"] == "solver.solve"
        assert tuple(c["name"] for c in strip_port_only(t)["children"]) == STAGES
        port_spans_sit(t)


def _statics_spans(trees) -> list:
    return [c for t in trees for c in t["children"][0]["children"]]


def test_statics_built_counts_new_pod_objects_once():
    """``solve.statics.built`` (and ``statics_built``) is the number of pods
    whose statics the pass built: every pod of a list of new objects, none
    when the same objects are solved again, and none after another thread
    built them first (the selection controller's prewarm). ``native`` (and
    ``statics_native``) counts those the native pass built: all of them
    once the extension is loaded, none without it."""
    from karpenter_tpu_torch.scheduling.statics import NATIVE, statics

    loaded = NATIVE.get(wait=300) is not None
    prov, catalog, pods = scenario(PORT, "diverse", 160, 42, 16)
    prewarmed = scenario(PORT, "diverse", 160, 43, 16)[2]
    sched = _scheduler(PORT)
    built, native = [], []
    with pinned(PORT):
        for batch in (pods, pods, prewarmed):
            if batch is prewarmed:
                warm = threading.Thread(target=lambda: [statics(p) for p in prewarmed])
                warm.start()
                warm.join()
            sched.solve(prov, catalog, batch)
            built.append(sched.last_stage_profile()["statics_built"])
            native.append(sched.last_stage_profile()["statics_native"])
    assert built == [160, 0, 0]
    assert native == [160 * loaded, 0, 0]
    spans = _statics_spans(T_OBS.exporter().trees())
    assert [(s["attrs"]["pods"], s["attrs"]["built"], s["attrs"]["native"])
            for s in spans] == [(160, 160, 160 * loaded), (160, 0, 0), (160, 0, 0)]


def test_statics_built_is_per_thread_under_many_workers():
    """More workers than cores share one scheduler, each solving lists of
    new pod objects at once with a short switch interval: each round's
    ``built`` is its own pods alone."""
    import sys

    from karpenter_tpu_torch.scheduling.statics import NATIVE

    loaded = NATIVE.get(wait=300) is not None
    n_workers, N = 9, 300
    prov, catalog, _ = scenario(PORT, "diverse", N, 42, 16)
    batches = {i: [scenario(PORT, "diverse", N + i, 50 + 11 * r + i, 16)[2]
                   for r in range(2)] for i in range(n_workers)}
    sched = _scheduler(PORT)
    start = threading.Barrier(n_workers)
    built = {i: [] for i in range(n_workers)}

    def worker(i):
        start.wait()
        for pods in batches[i]:
            sched.solve(prov, catalog, pods)
            built[i].append(sched.last_stage_profile()["statics_built"])

    interval = sys.getswitchinterval()
    with pinned(PORT):
        sched.solve(prov, catalog, scenario(PORT, "diverse", N, 41, 16)[2])
        T_OBS.exporter().clear()
        sys.setswitchinterval(1e-5)
        try:
            threads = [threading.Thread(target=worker, args=(i,)) for i in range(n_workers)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
                assert not t.is_alive()
        finally:
            sys.setswitchinterval(interval)
    assert built == {i: [N + i] * 2 for i in range(n_workers)}
    assert sorted((s["attrs"]["pods"], s["attrs"]["built"], s["attrs"]["native"])
                  for s in _statics_spans(T_OBS.exporter().trees())) == sorted(
        (N + i, N + i, (N + i) * loaded) for i in range(n_workers) for _ in range(2))


@pytest.mark.parametrize("solver_delta", [False, True])
def test_new_stage_keys_lie_inside_their_stages(solver_delta):
    """``statics_s`` is part of ``sort_s`` and ``pack_begin_s`` part of
    ``pack_fetch_s`` (the begin and the wait), in every round, full or
    resident; a resident sort hit runs no statics pass."""
    prov, catalog, pods = scenario(PORT, "diverse", 160, 42, 16)
    sched = _scheduler(PORT, solver_delta=solver_delta)
    profs = []
    with pinned(PORT):
        for r in range(4):
            batch = pods if r % 2 else scenario(PORT, "diverse", 160, 60 + r, 16)[2]
            sched.solve(prov, catalog, batch)
            profs.append(sched.last_stage_profile())
    for prof in profs:
        assert prof["pack_begin_s"] <= prof["pack_fetch_s"], prof
        if "sort_s" in prof:
            assert prof["statics_s"] <= prof["sort_s"], prof
        else:
            assert solver_delta and "statics_s" not in prof, prof


def test_a_saturation_redispatch_opens_the_wrapper_spans_again(monkeypatch):
    """A first table too small for the batch: the full-table re-dispatch
    runs under ``solve.pack_fetch``'s ``pack.redispatch``, its
    ``pack.launch`` at ``n_max`` = P."""
    from karpenter_tpu_torch.solver import backend

    monkeypatch.setattr(backend, "N_MAX_FIRST", 8)
    sched, trees = _traced_rounds(PORT, rounds=1)
    (tree,) = trees
    port_spans_sit(tree)
    redispatch = tree["children"][4]["children"][2]
    assert redispatch["name"] == "pack.redispatch"
    launches = [c["attrs"]["n_max"]
                for c in tree["children"][3]["children"] + redispatch["children"]
                if c["name"] == "pack.launch"]
    assert launches == [8, 256]  # the full table: P, 160 pods padded to 256
    assert sched.last_stage_profile()["pack_dispatches"] == 2


def _span_parents(tree, parent=None, out=None) -> list:
    out = [] if out is None else out
    out.append((tree["name"], parent))
    for c in tree["children"]:
        _span_parents(c, tree["name"], out)
    return out


def test_spans_mirror_into_the_profilers_trace():
    """Under ``torch.profiler`` (CPU activity) every span of a solve is one
    CPU event of its name, nested as the span tree is; with no profiler
    recording no ``record_function`` range is entered."""
    from torch.profiler import ProfilerActivity, profile

    from karpenter_tpu_torch.obs import trace

    prov, catalog, pods = scenario(PORT, "diverse", 160, 42, 16)
    sched = _scheduler(PORT)
    entered = []
    real = trace.record_function

    def counted(name):
        entered.append(name)
        return real(name)

    with pinned(PORT):
        sched.solve(prov, catalog, pods)
        T_OBS.exporter().clear()
        trace.record_function = counted
        try:
            sched.solve(prov, catalog, pods)
            assert entered == []
            T_OBS.exporter().clear()
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                sched.solve(prov, catalog, pods)
        finally:
            trace.record_function = real
    (tree,) = T_OBS.exporter().trees()
    want = _span_parents(tree)
    names = {name for name, _ in want}
    assert sorted(entered) == sorted(name for name, _ in want)
    events = [e for e in prof.events() if e.name in names]

    def span_parent(e):
        p = e.cpu_parent
        while p is not None and p.name not in names:
            p = p.cpu_parent
        return p.name if p is not None else None

    assert sorted((e.name, span_parent(e)) for e in events) == sorted(want)
    assert names >= PORT_ONLY_SPANS - {"pack.redispatch"}  # the table did not saturate


def test_router_attributes_on_the_dispatch_span():
    """On a cpu scheduler under ``auto`` the router's choice and its EMAs
    land on ``solve.pack_begin``, as the reference's do."""
    from karpenter_tpu_torch.solver import native

    if not native.native_available(wait=240):
        pytest.skip("native packer unavailable")
    prov, catalog, pods = scenario(PORT, "diverse", 160, 42, 16)
    sched = _scheduler(PORT)
    with packer(None):
        for _ in range(3):
            sched.solve(prov, catalog, pods)
    attrs = [t["children"][3]["attrs"] for t in T_OBS.exporter().trees()]
    assert [a["router_backend"] for a in attrs[:2]] == ["device", "native"]
    assert "router_ema_device_ms" in attrs[2] and "router_ema_native_ms" in attrs[2]
    assert attrs[2]["router_key"] == "x".join(
        map(str, sched.torch._route_key(sched.last_decision_context()["batch"])))


# ---------------------------------------------------------------------------
# metric families: the same events, the same deltas
# ---------------------------------------------------------------------------


def _samples(registry) -> dict:
    """Every sample of the registry that does not measure time: counters,
    gauges and histogram counts, by (name, labels)."""
    out = {}
    for fam in registry.collect():
        for s in fam.samples:
            if s.name.endswith("_created") or s.name.endswith("_sum"):
                continue
            if s.name.endswith("_bucket"):
                continue
            if "duration" in s.name or "seconds" in s.name:
                continue
            out[(s.name, tuple(sorted(s.labels.items())))] = s.value
    return out


@pytest.mark.parametrize("solver_delta", [False, True])
def test_same_rounds_move_every_family_alike(solver_delta):
    """Both packages on the same rung (``scan``: the unfused plain pack;
    the JAX package has no fused route on a CPU host), the same rounds:
    every counter, gauge and histogram count moves by the same amount, the
    port's span counts less its ``PORT_ONLY_SPANS``."""
    def port_only(tree) -> int:
        return (tree["name"] in PORT_ONLY_SPANS) + sum(map(port_only, tree["children"]))

    def run(pkg):
        finished = []

        def hook(sp):
            if sp.name in PORT_ONLY_SPANS:
                finished.append(sp.name)

        OBS[pkg].tracer().add_hook(hook)
        try:
            before = _samples(METRICS[pkg].REGISTRY)
            _, trees = _traced_rounds(pkg, rounds=3, solver_delta=solver_delta, route="scan")
            after = _samples(METRICS[pkg].REGISTRY)
        finally:
            OBS[pkg].tracer().remove_hook(hook)
        deltas = {
            k: after[k] - before.get(k, 0.0)
            for k in after
            if after[k] != before.get(k, 0.0)
        }
        deltas[("karpenter_trace_spans_total", ())] -= len(finished)
        deltas[("karpenter_trace_ring_spans", ())] -= sum(map(port_only, trees))
        return deltas

    deltas = same(run)
    if solver_delta:
        assert deltas[("karpenter_solver_delta_applied_total", (("path", "host"),))] >= 2
    else:
        assert deltas[("karpenter_solver_encode_cache_hits_total", ())] >= 3


def test_breaker_state_gauge_matches_the_reference():
    def run(pkg):
        b = mod(pkg, "resilience.breaker")
        clock = _Clock()
        br = b.CircuitBreaker(dependency=f"dep-{pkg}", window=2, min_volume=2,
                              open_seconds=5.0, clock=clock)
        g = METRICS[pkg].RESILIENCE_BREAKER_STATE.labels(dependency=f"dep-{pkg}")
        seen = [g._value.get()]
        br.record_failure()
        br.record_failure()
        seen.append(g._value.get())
        clock.t += 6.0
        assert br.allow()
        seen.append(g._value.get())
        br.record_success()
        seen.append(g._value.get())
        br.trip()
        seen.append(g._value.get())
        return seen

    assert same(run) == [0.0, 1.0, 2.0, 0.0, 1.0]


def test_event_carries_trace_and_decision_ids():
    def run(pkg):
        M = mods(pkg)
        events = mod(pkg, "kube.events")
        cluster = M.Cluster()
        rec = events.recorder_for(cluster)
        rec.event("Pod", "p0", "Untraced", "m")
        with OBS[pkg].tracer().span("round") as sp:
            rec.event("Pod", "p1", "PodUnschedulable", "m", type="Warning",
                      namespace="default", decision_id="d-1")
            trace_id = sp.trace_id
        out = {}
        for e in cluster.list("events"):
            ann = dict(e.metadata.annotations)
            if events.TRACE_ID_ANNOTATION in ann:
                assert ann[events.TRACE_ID_ANNOTATION] == trace_id
                ann[events.TRACE_ID_ANNOTATION] = "<trace>"
            out[e.reason] = ann
        return out

    out = same(run)
    assert out["Untraced"] == {}
    assert out["PodUnschedulable"] == {
        "karpenter.sh/trace-id": "<trace>", "karpenter.sh/decision-id": "d-1"}


# ---------------------------------------------------------------------------
# the v3 wire: traced frames and the sidecar's spans
# ---------------------------------------------------------------------------


def _svc(pkg):
    return mod(pkg, "solver.service")


def _encoded_args(pkg, n_pods=12, n_types=8):
    from torch_parity import encode_scenario

    prov, catalog, pods = scenario(pkg, "diverse", n_pods, 3, n_types)
    batch = encode_scenario(pkg, prov, catalog, pods)
    return [np.asarray(a) for a in batch.pack_args()]


def test_trace_ctx_array_is_the_same_on_both_sides():
    def run(pkg):
        s = _svc(pkg)
        arr = s._trace_ctx_array(OBS[pkg].SpanContext("ab" * 16, "12" * 8))
        back = s._ctx_from_array(arr)
        return arr.tobytes(), str(arr.dtype), tuple(back), s._ctx_from_array(np.zeros(5, np.int32))

    same(run)


def _session(svc_mod, service, args, ctx=None):
    n = svc_mod.N_POD_ARRAYS
    key = svc_mod.catalog_session_key(*args[n:])
    tail = [np.asarray([1], np.int32), svc_mod._trace_ctx_array(ctx)] if ctx else []
    service.open_session_bytes(svc_mod.pack_arrays([svc_mod._key_array(key)] + args[n:] + tail))
    return key


def _port_service():
    return mod(PORT, "solver.service").SolverService(device="cpu")


def test_untraced_frame_unchanged_and_no_trailer():
    s = _svc(PORT)
    args = _encoded_args(PORT)
    service = _port_service()
    key = _session(s, service, args)
    with pinned(PORT):
        response = service.solve_bytes(s.pack_arrays(
            [s._key_array(key), np.asarray([8], np.int32)] + args[:s.N_POD_ARRAYS]))
    arrays = s.unpack_arrays(response)
    assert int(arrays[0].reshape(-1)[0]) == s.STATUS_OK
    assert len(arrays) == 2
    assert T_OBS.exporter().trees() == []


def test_traced_solve_returns_stage_trailer_and_sidecar_spans():
    s = _svc(PORT)
    args = _encoded_args(PORT)
    service = _port_service()
    ctx = T_OBS.SpanContext("cd" * 16, "34" * 8)
    key = _session(s, service, args, ctx)
    with pinned(PORT):
        response = service.solve_bytes(s.pack_arrays(
            [s._key_array(key), np.asarray([8], np.int32)] + args[:s.N_POD_ARRAYS]
            + [s._trace_ctx_array(ctx)]))
    arrays = s.unpack_arrays(response)
    assert int(arrays[0].reshape(-1)[0]) == s.STATUS_OK
    trailer = arrays[-1]
    assert trailer.dtype == np.float32 and trailer.size == 3 and (trailer >= 0).all()
    names = {t["name"]: t for t in T_OBS.exporter().snapshot(limit=None)}
    pack = names["sidecar.pack"]
    assert (pack["trace_id"], pack["parent_id"]) == (ctx.trace_id, ctx.span_id)
    assert [c["name"] for c in pack["children"]] == [
        "sidecar.solve", "sidecar.fetch", "sidecar.serialize"]
    assert sorted(pack["attrs"]) == ["admission_wait_s", "pods", "session"]
    assert names["sidecar.device_put"]["trace_id"] == ctx.trace_id


class _Capture:
    """Records each Pack and OpenSession request frame a sidecar receives."""

    def __init__(self, service):
        self.service = service
        self.frames = []

    def wrap(self):
        svc, frames = self.service, self.frames
        inner_solve, inner_open = svc.solve_bytes, svc.open_session_bytes

        def solve_bytes(request):
            frames.append(("pack", request))
            return inner_solve(request)

        def open_session_bytes(request):
            frames.append(("open", request))
            return inner_open(request)

        svc.solve_bytes = solve_bytes
        svc.open_session_bytes = open_session_bytes
        return svc


FIXED_SPAN_ID = "5a" * 8
FIXED_TRACE = "c0ffee" + "0" * 26


def _traced_pack(client_pkg, address, args, monkeypatch):
    """One traced Pack from ``client_pkg``'s client with fixed ids."""
    monkeypatch.setattr(mod(client_pkg, "obs.trace"), "_new_span_id", lambda: FIXED_SPAN_ID)
    o = OBS[client_pkg]
    client = _svc(client_pkg).RemoteSolver(address, timeout=30, cold_timeout=60)
    try:
        with o.tracer().span("test.root", parent=o.SpanContext(FIXED_TRACE, "11" * 8)):
            result = client.pack(*args, n_max=8)
        return result, {t["name"]: t for t in o.exporter().snapshot(limit=None)}
    finally:
        client.close()


@pytest.mark.parametrize("server_pkg", [JAX, PORT])
def test_traced_frames_are_byte_equal_across_clients(server_pkg, monkeypatch):
    """The port's and the reference's clients, given the same trace and
    span ids, send byte-identical traced Pack and OpenSession frames to
    either package's sidecar; the sidecar parents its ``sidecar.pack`` on
    the ids either client sent, and each client grafts the stage trailer
    under its ``solver.wire`` span."""
    pytest.importorskip("grpc")
    args = _encoded_args(JAX)
    port_args = _encoded_args(PORT)
    for a, b in zip(args, port_args):
        assert a.tobytes() == b.tobytes()
    service = (mod(JAX, "solver.service").SolverService() if server_pkg == JAX
               else _port_service())
    cap = _Capture(service)
    address = free_address()
    server = _svc(server_pkg).serve(address, service=cap.wrap())
    try:
        results, grafts, frames = {}, {}, {}
        for client_pkg in BOTH:
            start = len(cap.frames)
            with packer("scan"):
                result, trees = _traced_pack(client_pkg, address, args, monkeypatch)
            results[client_pkg] = [np.asarray(a).tobytes() for a in result]
            wire = [c for c in trees["test.root"]["children"] if c["name"] == "solver.wire"]
            assert wire, trees["test.root"]
            grafts[client_pkg] = [c["name"] for c in wire[0]["children"]]
            frames[client_pkg] = cap.frames[start:]
        jax_frames, port_frames = frames[JAX], frames[PORT]
        assert results[PORT] == results[JAX]
        assert grafts[PORT] == grafts[JAX] == [
            "sidecar.solve", "sidecar.fetch", "sidecar.serialize"]
        # the first client opened the session; the second found it resident
        assert [k for k, _ in jax_frames] == ["open", "pack"]
        assert [k for k, _ in port_frames] == ["open", "pack"]
        assert port_frames[0][1] == jax_frames[0][1]
        assert port_frames[1][1] == jax_frames[1][1]
        ctx = _svc(server_pkg)._ctx_from_array(
            _svc(server_pkg).unpack_arrays(port_frames[1][1])[-1])
        assert (ctx.trace_id, ctx.span_id) == (FIXED_TRACE, FIXED_SPAN_ID)
        packs = [t for t in OBS[server_pkg].exporter().snapshot(limit=None)
                 if t["name"] == "sidecar.pack"]
        assert len(packs) == 2
        assert {(t["trace_id"], t["parent_id"]) for t in packs} == {(FIXED_TRACE, FIXED_SPAN_ID)}
    finally:
        server.stop(grace=None)


def test_untraced_client_frames_carry_no_trailer(monkeypatch):
    """Without an active span both clients send the same untraced frame,
    and the port's is the reference's byte for byte."""
    pytest.importorskip("grpc")
    args = _encoded_args(JAX)
    cap = _Capture(_port_service())
    address = free_address()
    server = _svc(PORT).serve(address, service=cap.wrap())
    try:
        frames = {}
        for pkg in BOTH:
            start = len(cap.frames)
            client = _svc(pkg).RemoteSolver(address, timeout=30, cold_timeout=60)
            with packer("scan"):
                client.pack(*args, n_max=8)
            client.close()
            frames[pkg] = [f for k, f in cap.frames[start:] if k == "pack"]
        assert frames[PORT] == frames[JAX]
        n = _svc(PORT).N_POD_ARRAYS
        assert len(_svc(PORT).unpack_arrays(frames[PORT][0])) == 2 + n
        # the client's wire spans are roots of their own; the sidecar
        # records nothing for an untraced solve
        names = each(lambda pkg: sorted(t["name"] for t in OBS[pkg].exporter().trees()))
        assert names[PORT] == names[JAX] == ["solver.wire", "solver.wire_open"]
    finally:
        server.stop(grace=None)


def test_sidecar_health_serves_metrics_and_debug(tmp_path):
    pytest.importorskip("grpc")
    s = _svc(PORT)
    T_OBS.configure_flight(str(tmp_path / "flight"), budget_s=0.0, watch=("sidecar.pack",))
    T_OBS.configure_slo(objectives=T_OBS.SIDECAR_OBJECTIVES, window_s=60.0)
    address = free_address()
    health_port = int(free_address().rsplit(":", 1)[1])
    server = s.serve(address, health_port=health_port, service=_port_service())
    try:
        args = _encoded_args(PORT)
        client = s.RemoteSolver(address, timeout=30, cold_timeout=60)
        with pinned(PORT), T_OBS.tracer().span("controller.round") as root:
            client.pack(*args, n_max=8)
        client.close()

        def get(path):
            with urllib.request.urlopen(f"http://127.0.0.1:{health_port}{path}", timeout=10) as r:
                return r.status, r.headers["Content-Type"], r.read()

        status, ctype, body = get("/metrics")
        text = body.decode()
        assert status == 200 and "karpenter_solver_session_hbm_bytes{" in text
        assert "\nkarpenter_solver_session_catalog_uploads_total " in text
        _, ctype, body = get(f"/debug/traces?trace_id={root.trace_id}")
        traces = json.loads(body)["traces"]
        assert ctype == "application/json"
        assert {t["name"] for t in traces} >= {"sidecar.pack", "controller.round"}
        assert all(t["trace_id"] == root.trace_id for t in traces)
        slo_body = json.loads(get("/debug/slo")[2])
        assert slo_body["slo"]["objectives"]["sidecar_pack_p99"]["events"]["fast"] == 1
        flight = json.loads(get("/debug/flight")[2])["records"]
        assert [r["name"] for r in flight] == ["sidecar.pack"]
        assert json.loads(get("/debug/decisions")[2]) == {"decisions": []}
        assert json.loads(get("/debug/explain?pod=x")[2]) == {"pod": "x", "explain": None}
        # the telemetry endpoints: no profiler, plane or sentinel here
        _, ctype, body = get("/debug/profile")
        assert (ctype, json.loads(body)) == ("application/json", {"profile": {"enabled": False}})
        assert json.loads(get("/debug/fleet")[2]) == {"fleet": {}}
        assert json.loads(get("/debug/incidents")[2]) == {"incidents": [], "sentinel": {}}
        with pytest.raises(urllib.error.HTTPError):
            get("/debug/nothing")
    finally:
        server.health_server.shutdown()
        server.stop(grace=None)


def test_debug_payloads_match_the_reference():
    def run(pkg):
        o = OBS[pkg]
        for name in ("a", "b", "a"):
            with o.tracer().span(name):
                with o.tracer().span("leaf"):
                    pass
        out = {}
        for q in ("", "limit=1", "name=a", "name=leaf&limit=5", "limit=x"):
            body = o.debug_traces_payload(q)
            # exported_spans counts since the process started
            stats = {k: v for k, v in body["stats"].items() if k != "exported_spans"}
            out[q] = ([t["name"] for t in body["traces"]], stats)
        out["slo"] = o.debug_slo_payload("")
        out["flight"] = o.debug_flight_payload("")
        out["decisions"] = o.debug_decisions_payload("limit=3")
        out["explain"] = o.debug_explain_payload("pod=nobody")
        return out

    same(run)


def test_session_hbm_label_follows_the_store():
    s = _svc(PORT)
    service = mod(PORT, "solver.service").SolverService(device="cpu", session_max=1)
    keys = []
    for seed in (3, 4):
        prov, catalog, pods = scenario(PORT, "diverse", 12, seed, 8 + seed)
        from torch_parity import encode_scenario

        args = [np.asarray(a) for a in encode_scenario(PORT, prov, catalog, pods).pack_args()]
        keys.append(_session(s, service, args))
    gauge = T_METRICS.SOLVER_SESSION_HBM
    labels = {dict(smp.labels)["session"] for fam in gauge.collect() for smp in fam.samples}
    assert keys[1].hex()[:12] in labels
    assert keys[0].hex()[:12] not in labels  # the evicted session's label is gone


def test_admission_depth_and_shed_metrics():
    s = _svc(PORT)
    gate = s.AdmissionGate(max_inflight=1, queue_depth=0)
    assert gate.enter() == "admitted"
    assert T_METRICS.SOLVER_ADMISSION_DEPTH._value.get() == 1.0
    assert gate.enter() == "overloaded"
    gate.leave()
    assert T_METRICS.SOLVER_ADMISSION_DEPTH._value.get() == 0.0
    service = _port_service()
    before = T_METRICS.SOLVER_ADMISSION_SHED.labels(reason="queue_full")._value.get()
    service._count_shed("queue_full")
    assert T_METRICS.SOLVER_ADMISSION_SHED.labels(reason="queue_full")._value.get() == before + 1


# ---------------------------------------------------------------------------
# the stream, the coalescer and the pool
# ---------------------------------------------------------------------------


def _wait_until(predicate, timeout=10.0) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(0.02)
    return predicate()


def _family(pkg, name, address=None) -> dict:
    """One metric family's samples, the address label dropped (each
    package's sidecar listens on its own port)."""
    out = {}
    for fam in getattr(METRICS[pkg], name).collect():
        for s in fam.samples:
            if s.name.endswith("_created"):
                continue
            labels = dict(s.labels)
            if address is not None:
                if labels.pop("address", address) != address:
                    continue
            out[(s.name, tuple(sorted(labels.items())))] = s.value
    return out


def _service(pkg):
    return mod(pkg, "solver.service").SolverService(**({"device": "cpu"} if pkg == PORT else {}))


def test_stream_metrics_match_the_reference():
    """Each package's streaming client against its own sidecar: the
    established state, the solves by transport, and a break."""
    pytest.importorskip("grpc")
    args = _encoded_args(JAX)
    families = ("SOLVER_STREAM_STATE", "SOLVER_STREAM_SOLVES", "SOLVER_STREAM_BREAKS",
                "SOLVER_STREAM_FALLBACKS", "SOLVER_STREAM_CREDIT_STALLS")

    def run(pkg):
        s = _svc(pkg)
        address = free_address()
        server = s.serve(address, service=_service(pkg))
        client = s.RemoteSolver(address, timeout=10, cold_timeout=60, stream=True)
        try:
            with packer("scan"):
                client.pack(*args, n_max=8)  # opens the session and the stream
                assert _wait_until(lambda: client._stream is not None and client._stream.up)
                for _ in range(2):
                    client.pack(*args, n_max=8)
            up = {f: _family(pkg, f, address) for f in families}
            server.stop(grace=0)
            assert _wait_until(lambda: client._stream.breaks >= 1)
            down = {f: _family(pkg, f, address) for f in families}
            return up, down
        finally:
            client.close()
            server.stop(grace=0)

    up, down = same(run)
    assert up["SOLVER_STREAM_STATE"] == {("karpenter_solver_stream_established", ()): 1.0}
    assert down["SOLVER_STREAM_STATE"] == {("karpenter_solver_stream_established", ()): 0.0}
    assert down["SOLVER_STREAM_BREAKS"] == {("karpenter_solver_stream_breaks_total", ()): 1.0}


def test_coalesced_group_counts_once_like_the_reference():
    from torch_parity import encode_scenario

    prov, catalog, pods = scenario(JAX, "diverse", 64, 42, 16)
    args = [np.asarray(a) for a in encode_scenario(JAX, prov, catalog, pods).pack_args()]

    def run(pkg):
        s = _svc(pkg)
        n = s.N_POD_ARRAYS
        svc = _service(pkg)
        key = s.catalog_session_key(*args[n:])
        svc.open_session_bytes(s.pack_arrays([s._key_array(key)] + args[n:]))
        m = METRICS[pkg]
        before = (m.SOLVER_STREAM_COALESCED_DISPATCHES._value.get(),
                  m.SOLVER_STREAM_COALESCED_SOLVES._value.get())
        responses = []
        frames = []
        for i in range(3):
            podside = [a.copy() for a in args[:n]]
            podside[0][i] = False
            frames.append(s.pack_arrays([s._key_array(key), np.asarray([32, 1], np.int32)]
                                        + podside))
        with packer("scan"):
            entries = [svc.stream_parse_solve(f, respond=responses.append) for f in frames]
            svc.solve_stream_group(entries)
        after = (m.SOLVER_STREAM_COALESCED_DISPATCHES._value.get(),
                 m.SOLVER_STREAM_COALESCED_SOLVES._value.get())
        return after[0] - before[0], after[1] - before[1], len(responses)

    assert same(run) == (1.0, 3.0, 3)


def test_pool_failover_span_and_metrics_match_the_reference():
    """A pool whose primary member died after the first solve: the second
    solve's fetch fails over under a ``solver.pool.failover`` span, and
    the failover, breaker and member families move alike."""
    pytest.importorskip("grpc")
    args = _encoded_args(JAX)

    def run(pkg):
        s = _svc(pkg)
        pool_mod = mod(pkg, "solver.pool")
        addrs = [free_address(), free_address()]
        servers = {a: s.serve(a, service=_service(pkg)) for a in addrs}
        pool = pool_mod.SolverPool(addrs, timeout=5)
        try:
            with packer("scan"):
                pool.pack(*args, n_max=8)
                primary = pool.ring.route(pool._catalog_key(args[s.N_POD_ARRAYS:]))
                survivor = next(a for a in addrs if a != primary)
                # a process-global counter: read as a delta
                failovers = METRICS[pkg].SOLVER_POOL_FAILOVERS.labels(
                    address=primary)._value.get()
                servers[primary].stop(grace=0)
                with OBS[pkg].tracer().span("test.root"):
                    pool.pack(*args, n_max=8)
            root = next(t for t in OBS[pkg].exporter().trees() if t["name"] == "test.root")
            failover = [t for t in OBS[pkg].spans_named(root, "solver.pool.failover")]
            attrs = [(f["attrs"]["from"] == primary, f["attrs"]["to"] == survivor)
                     for f in failover]
            m = METRICS[pkg]
            return (
                attrs,
                m.SOLVER_POOL_FAILOVERS.labels(address=primary)._value.get() - failovers,
                m.SOLVER_BREAKER_OPEN.labels(address=primary)._value.get(),
                m.SOLVER_BREAKER_OPEN.labels(address=survivor)._value.get(),
                m.SOLVER_POOL_MEMBERS._value.get(),
                pool.failovers,
            )
        finally:
            pool.close()
            for srv in servers.values():
                srv.stop(grace=0)

    assert same(run) == ([(True, True)], 1.0, 1.0, 0.0, 1.0, 1)


# ---------------------------------------------------------------------------
# the flight recorder's wire-dominance rule
# ---------------------------------------------------------------------------


def _wire_tree(o, wire_s, sidecar_s):
    """A finished solver.solve tree over a solver.wire of ``wire_s``
    (backdated, no sleep) holding the sidecar's grafted stage records;
    ``wire_s`` None: an in-process solve with no wire."""
    with o.tracer().span("solver.solve") as root:
        if wire_s is None:
            with o.tracer().span("solve.pack_fetch") as sp:
                sp.start -= 0.01
        else:
            with o.tracer().span("solver.wire") as w:
                w.start -= wire_s
                w.add_child_record("sidecar.solve", sidecar_s)
                w.add_child_record("sidecar.fetch", sidecar_s / 2)
    return root


# (wire seconds, sidecar seconds) per solve, and the records expected
WIRE_CASES = {
    "wire-dominated": ([(0.03, 0.001)], 1),
    "solve-dominated": ([(0.006, 0.2)], 0),
    "in-process": ([(None, 0.0)], 0),
    "steady wire-dominance cools down": ([(0.03, 0.001)] * 3, 1),
}


@pytest.mark.parametrize("case", list(WIRE_CASES))
def test_wire_dominance_rule_matches_the_reference(tmp_path, case):
    solves, expected = WIRE_CASES[case]

    def run(pkg):
        o = OBS[pkg]
        flight = mod(pkg, "obs.flight")
        rec = flight.FlightRecorder(str(tmp_path / pkg), budget_s=10.0)  # never on budget
        shares = []
        for wire_s, sidecar_s in solves:
            root = _wire_tree(o, wire_s, sidecar_s)
            shares.append(flight.wire_dominance(root) is not None)
            rec(root)
        records = rec.recent()
        for r in records:
            assert r["wire_dominated"] is True and r["wire_self_s"] > r["solve_share_s"]
            assert r["wire_self_s"] >= flight.MIN_WIRE_DOMINANCE_S
        return shares, [sorted(r) for r in records], len(records)

    assert same(run)[2] == expected


# ---------------------------------------------------------------------------
# logging_config: trace-stamped records and the live level
# ---------------------------------------------------------------------------


def _stamped_lines(pkg):
    import io
    import logging

    lc = mod(pkg, "logging_config")
    stream = io.StringIO()
    handler = logging.StreamHandler(stream)
    handler.setFormatter(logging.Formatter("%(levelname)s %(name)s [%(trace_id)s/%(span_id)s] "
                                           "%(message)s"))
    handler.addFilter(lc.TraceContextFilter())
    log = logging.getLogger("karpenter.test-stamp")
    log.addHandler(handler)
    log.setLevel(logging.INFO)
    try:
        log.info("outside")
        with OBS[pkg].tracer().span("solver.solve") as sp:
            log.info("inside")
            ids = (sp.trace_id, sp.span_id)
    finally:
        log.removeHandler(handler)
    return stream.getvalue().splitlines(), ids, lc.LOG_FORMAT


def test_log_records_carry_the_span_ids():
    out = {pkg: _stamped_lines(pkg) for pkg in BOTH}
    (lines, (trace_id, span_id), fmt) = out[PORT]
    assert fmt == out[JAX][2]
    assert lines == [
        "INFO karpenter.test-stamp [-/-] outside",
        f"INFO karpenter.test-stamp [{trace_id}/{span_id}] inside",
    ]
    # the reference's lines differ only in their ids
    jl, (jt, js), _ = out[JAX]
    assert [line.replace(jt, "T").replace(js, "S") for line in jl] == [
        line.replace(trace_id, "T").replace(span_id, "S") for line in lines]


def test_trace_filter_installs_once():
    import logging

    lc = mod(PORT, "logging_config")
    handler = logging.NullHandler()
    root = logging.getLogger()
    root.addHandler(handler)
    try:
        lc.install_trace_filter()
        lc.install_trace_filter()
        assert [type(f) for f in handler.filters] == [lc.TraceContextFilter]
    finally:
        root.removeHandler(handler)
        for h in root.handlers:  # the handlers the test runner put there
            h.removeFilter(lc._trace_filter)


def test_log_level_watcher_reapplies_a_changed_level(tmp_path):
    import logging

    level_file = tmp_path / "loglevel"
    root = logging.getLogger("karpenter")
    was = root.level

    def run(pkg):
        lc = mod(pkg, "logging_config")
        watcher = lc.LogLevelWatcher(str(level_file), interval=3600.0)
        seen = []
        for text in ("debug", "warning", "loud", "error"):
            level_file.write_text(text)
            watcher._apply_once()
            seen.append(root.level)
        return seen, [lc.validate_log_config(v) for v in ("Info", "loud")], lc.apply_log_level("x")

    try:
        assert same(run) == ([logging.DEBUG, logging.WARNING, logging.WARNING, logging.ERROR],
                             [None, "log level 'loud' not in ['debug', 'error', 'info', 'warning']"],
                             False)
        lc = mod(PORT, "logging_config")
        level_file.write_text("info")
        watcher = lc.LogLevelWatcher(str(level_file), interval=0.05)
        watcher.start()
        try:
            level_file.write_text("debug")
            deadline = time.monotonic() + 5.0
            while root.level != logging.DEBUG and time.monotonic() < deadline:
                time.sleep(0.02)
            assert root.level == logging.DEBUG  # the thread re-applied it live
        finally:
            watcher.stop()
    finally:
        root.setLevel(was)
