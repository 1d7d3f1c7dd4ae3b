"""The port's telemetry plane against the JAX package's.

The collector (histogram merge, stitcher, fleet SLO aggregation, the file
and HTTP backends, the collector and its ``/debug/fleet`` body) and the
sampling profiler of ``karpenter_tpu_torch.obs`` take the same inputs as
``karpenter_tpu.obs`` and must give the same outputs; member payloads
cross between the packages in both directions. Counters are read as
deltas and only a test's own state panels are compared: the registries
and panels are process-global, and other test modules count into them.
"""

from __future__ import annotations

import importlib
import json
import os
import random
import socket
import subprocess
import sys
import threading
import time
import urllib.request

import pytest

import karpenter_tpu.obs as J_OBS
import karpenter_tpu_torch.obs as T_OBS
from karpenter_tpu import metrics as J_METRICS
from karpenter_tpu_torch import metrics as T_METRICS
from torch_parity import fresh_router, packer, scenario  # noqa: F401

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


def mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def tc(pkg: str):
    return mod(pkg, "obs.collector")


def same(fn):
    out = {pkg: fn(pkg) for pkg in BOTH}
    assert out[PORT] == out[JAX], out
    return out[PORT]


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def span_dict(name, trace_id, span_id, parent_id=None, t0=0.0, dur_ms=10.0,
              wall=1754300000.0, attrs=None, children=None):
    return {
        "name": name, "trace_id": trace_id, "span_id": span_id, "parent_id": parent_id,
        "t0": t0, "t1": t0 + dur_ms / 1e3, "duration_ms": dur_ms, "wall_start": wall,
        "attrs": attrs or {}, "error": None, "children": children or [],
    }


def controller_tree(trace_id="ab" * 16, wall=1754300000.0):
    graft = [
        span_dict("sidecar.solve", trace_id, "g1" + "0" * 14, "wire" + "0" * 12,
                  t0=100.05, dur_ms=50.0, wall=wall + 0.05),
        span_dict("sidecar.fetch", trace_id, "g2" + "0" * 14, "wire" + "0" * 12,
                  t0=100.10, dur_ms=20.0, wall=wall + 0.10),
    ]
    return span_dict("solver.solve", trace_id, "root" + "0" * 12, None, t0=100.0,
                     dur_ms=200.0, wall=wall, children=[
                         span_dict("solve.pack_begin", trace_id, "pb" + "0" * 14,
                                   "root" + "0" * 12, t0=100.0, dur_ms=10.0, wall=wall),
                         span_dict("solver.wire", trace_id, "wire" + "0" * 12,
                                   "root" + "0" * 12, t0=100.01, dur_ms=180.0,
                                   wall=wall + 0.01, children=graft),
                     ])


def sidecar_tree(trace_id="ab" * 16, wall=1754300000.0, base=5000.0):
    # another perf_counter base: clocks never agree across processes
    return span_dict(
        "sidecar.pack", trace_id, "sc" + "0" * 14, "pb" + "0" * 14, t0=base, dur_ms=100.0,
        wall=wall + 0.04, attrs={"session": "abc", "admission_wait_s": 0.012},
        children=[
            span_dict("sidecar.solve", trace_id, "ss" + "0" * 14, "sc" + "0" * 14, t0=base,
                      dur_ms=50.0, wall=wall + 0.04),
            span_dict("sidecar.fetch", trace_id, "sf" + "0" * 14, "sc" + "0" * 14,
                      t0=base + 0.05, dur_ms=20.0, wall=wall + 0.09),
        ])


def member(pkg, identity, role="controller", flushed_at=None, trees=(), slo=None):
    return {
        "version": tc(pkg).PAYLOAD_VERSION, "identity": identity, "role": role,
        "flushed_at": time.time() if flushed_at is None else flushed_at,
        "traces": list(trees), "slo": slo or {}, "profile": {},
    }


def feed(engine, name, values):
    """Finished spans of the given durations into an SLO engine."""
    Span = type(engine).__module__.replace("obs.slo", "obs.trace")
    Span = importlib.import_module(Span).Span
    for i, v in enumerate(values):
        sp = Span(name, "ab" * 16, f"{i:016d}", None, None)
        sp.start, sp.end = 0.0, v
        engine(sp)


def exact_p99(values):
    exact = sorted(values)
    return exact[min(int(0.99 * len(exact)), len(exact) - 1)]


# ---------------------------------------------------------------------------
# histogram merge
# ---------------------------------------------------------------------------


def test_histogram_merge_equals_the_combined_stream():
    rng = random.Random(7)
    a_vals = [rng.lognormvariate(-3.0, 1.0) for _ in range(2000)]
    b_vals = [rng.lognormvariate(-2.0, 0.7) for _ in range(3000)]

    def run(pkg):
        H = mod(pkg, "obs.slo").Histogram
        ha, hb, hc = H(), H(), H()
        for v in a_vals:
            ha.observe(v)
            hc.observe(v)
        for v in b_vals:
            hb.observe(v)
            hc.observe(v)
        # the JSON form (string bucket keys) is what a member file carries
        merged = H().merge(json.loads(json.dumps(ha.snapshot()))).merge(hb.snapshot())
        assert merged.counts == hc.counts
        return ([merged.quantile(q) for q in (0.5, 0.9, 0.99)], merged.mean(),
                merged.total(), sorted(merged.counts.items()))

    quantiles, _, total, _ = same(run)
    assert total == 5000
    truth = sorted(a_vals + b_vals)
    assert abs(quantiles[2] - exact_p99(truth)) / exact_p99(truth) < 0.05


def test_window_expiry_reaches_the_merge():
    def run(pkg):
        slo = mod(pkg, "obs.slo")
        clock = {"now": 0.0}
        sw = slo.SlidingWindow(slice_s=1.0, fast_slices=slo.FAST_SLICES, total_slices=60,
                               clock=lambda: clock["now"])
        for _ in range(50):
            sw.record(10.0, None, bad=True)
        clock["now"] = 30.0
        for _ in range(20):
            sw.record(0.01, None, bad=False)
        fast = slo.Histogram.from_window(sw.merged(fast=True))
        slow = slo.Histogram.from_window(sw.merged(fast=False))
        merged = slo.Histogram().merge(fast.snapshot())
        return fast.events(), fast.bad, merged.quantile(0.99) < 0.05, slow.events()

    assert same(run) == (20, 0, True, 70)


# ---------------------------------------------------------------------------
# the stitcher
# ---------------------------------------------------------------------------

STITCH_CASES = {
    "overlapping wire": lambda: [controller_tree(), sidecar_tree()],
    "missing anchor": lambda: [controller_tree(), sidecar_tree(trace_id="cd" * 16)],
    "anchor fallback": lambda: [controller_tree(), sidecar_tree(wall=1754303600.0)],
    "two traces": lambda: [controller_tree(), sidecar_tree(), controller_tree("ef" * 16),
                           sidecar_tree("ef" * 16, base=9.0)],
}


@pytest.mark.parametrize("case", list(STITCH_CASES))
def test_stitch_and_wire_attribution_match_the_reference(case):
    trees = STITCH_CASES[case]()
    before = json.dumps(trees, sort_keys=True)

    def run(pkg):
        roots, joins = tc(pkg).stitch(trees)
        return json.dumps(roots, sort_keys=True), joins, [
            tc(pkg).wire_attribution(r) for r in roots]

    roots, joins, attribution = same(run)
    assert json.dumps(trees, sort_keys=True) == before  # inputs never mutated
    roots = json.loads(roots)
    if case == "missing anchor":
        assert joins == 0 and sorted(r["name"] for r in roots) == ["sidecar.pack", "solver.solve"]
        return
    assert joins == len(trees) // 2 and len(roots) == joins
    if case == "anchor fallback":
        # an hour away from any wire span: attached at the anchor
        assert [c["name"] for c in roots[0]["children"][0]["children"]] == ["sidecar.pack"]
        return
    wire = roots[0]["children"][1]
    pack = wire["children"][0]
    # the grafted records are replaced by the real subtree, rebased inside
    assert [c["name"] for c in wire["children"]] == ["sidecar.pack"] and pack["stitched"]
    for s in [pack, *pack["children"]]:
        assert wire["t0"] <= s["t0"] <= s["t1"] <= wire["t1"]
    assert pack["duration_ms"] == 100.0
    attr = attribution[0]
    assert attr["stitched"] and attr["device_ms"] == pytest.approx(70.0)
    assert attr["sidecar_queue_ms"] == pytest.approx(12.0)
    assert 0 < attr["wire_share_pct"] < 100
    assert tc(PORT).wire_attribution(span_dict("solver.solve", "ef" * 16, "r" * 16)) is None


# ---------------------------------------------------------------------------
# fleet SLO aggregation
# ---------------------------------------------------------------------------


def _slo_members(pkg, case):
    Engine = mod(pkg, "obs.slo").SloEngine
    rng = random.Random(3)
    if case == "two replicas":
        a = Engine(objectives=("solve.p99 < 100ms",), window_s=300)
        b = Engine(objectives=("solve.p99 < 100ms",), window_s=300)
        feed(a, "solver.solve", [abs(rng.gauss(0.03, 0.01)) + 1e-4 for _ in range(600)])
        feed(b, "solver.solve", [abs(rng.gauss(0.06, 0.02)) + 1e-4 for _ in range(400)])
        return {"replica-a": a.histogram_snapshot(), "replica-b": b.histogram_snapshot()}
    if case == "disjoint objectives":
        c = Engine(objectives=("solve.p99 < 100ms",), window_s=300)
        s = Engine(objectives=("sidecar.pack.p99 < 100ms",), window_s=300)
        feed(c, "solver.solve", [0.01] * 20)
        feed(s, "sidecar.pack", [0.02] * 20)
        return {"c": c.histogram_snapshot(), "s": s.histogram_snapshot()}
    e = Engine(objectives=("solve.p99 < 100ms",), window_s=300)
    feed(e, "solver.solve", [0.01] * 25 + [0.5] * 25)
    return {"m": e.histogram_snapshot()}


@pytest.mark.parametrize("case", ["two replicas", "disjoint objectives", "burning"])
def test_fleet_slo_merge_matches_the_reference(case):
    merged = same(lambda pkg: tc(pkg).merge_objective_snapshots(_slo_members(pkg, case)))
    if case == "two replicas":
        rng = random.Random(3)
        vals = ([abs(rng.gauss(0.03, 0.01)) + 1e-4 for _ in range(600)]
                + [abs(rng.gauss(0.06, 0.02)) + 1e-4 for _ in range(400)])
        got = merged["solve_p99"]["value"]
        assert abs(got - exact_p99(vals)) / exact_p99(vals) < 0.05
        assert merged["solve_p99"]["members"] == ["replica-a", "replica-b"]
    elif case == "disjoint objectives":
        assert merged["solve_p99"]["members"] == ["c"]
        assert merged["sidecar_pack_p99"]["members"] == ["s"]
    else:
        assert merged["solve_p99"]["burn_rate"]["fast"] > 1.0 and not merged["solve_p99"]["ok"]


# ---------------------------------------------------------------------------
# backends + collector
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("writer,reader", [(JAX, PORT), (PORT, JAX), (PORT, PORT)],
                         ids=["jax-writes", "port-writes", "port-only"])
def test_member_files_cross_packages(tmp_path, writer, reader):
    """A member payload written by one package's file backend is read by
    the other's collector: a mixed fleet reads both."""
    a = tc(writer).FileTelemetryBackend(str(tmp_path), identity="a")
    a.publish(member(writer, "a", trees=[controller_tree()]))
    tc(reader).FileTelemetryBackend(str(tmp_path), identity="b").publish(
        member(reader, "b", role="sidecar", trees=[sidecar_tree()]))
    (tmp_path / "member-zzz.json").write_text("{torn")
    docs = {d["identity"]: d for d in tc(reader).FileTelemetryBackend(str(tmp_path)).poll()}
    assert set(docs) == {"a", "b"} and docs["b"]["role"] == "sidecar"
    a.publish(member(writer, "a", trees=[]))  # a republish replaces the file whole
    assert len(list(tmp_path.glob("member-*.json"))) == 3
    a.publish(member(writer, "a", trees=[controller_tree()]))
    coll = tc(reader).TelemetryCollector([tc(reader).FileTelemetryBackend(str(tmp_path))])
    coll.refresh()
    fleet = coll.fleet_payload()
    assert fleet["traces"]["stitched"] == 1
    assert fleet["traces"]["index"][0]["members"] == ["a", "b"]


def test_collector_inventory_and_fleet_payload_match(tmp_path):
    def run(pkg):
        d = tmp_path / pkg
        backend = tc(pkg).FileTelemetryBackend(str(d), identity="x")
        backend.publish(member(pkg, "fresh", flushed_at=995.0, trees=[controller_tree()]))
        backend.publish(member(pkg, "quiet", role="sidecar", flushed_at=900.0,
                               trees=[sidecar_tree()]))
        coll = tc(pkg).TelemetryCollector([backend], flush_interval=10.0, clock=lambda: 1000.0)
        coll.refresh()
        stitched = METRICS[pkg].TELEMETRY_STITCHED
        before = stitched._value.get()
        first = coll.fleet_payload()
        coll.refresh()
        coll._stitch_roots = None  # past the cache window: stitch again
        second = coll.fleet_payload()
        return (coll.members(), json.dumps(first, sort_keys=True),
                second["traces"], stitched._value.get() - before)

    members, fleet, again, new_joins = same(run)
    assert {m["identity"]: m["stale"] for m in members} == {"fresh": False, "quiet": True}
    fleet = json.loads(fleet)
    # one new stitch, and the same flushed tree re-polled is not a new one
    assert new_joins == 1 and again == fleet["traces"]
    assert fleet["traces"]["index"][0]["members"] == ["fresh", "quiet"]
    assert "sidecar.pack" in [leg["name"] for leg in fleet["worst_stitched"]["critical_path"]]
    assert fleet["worst_stitched"]["wire"]["stitched"] is True


def test_flush_ships_the_newest_ring_trees():
    def run(pkg):
        o = OBS[pkg]
        ids = []
        for _ in range(tc(pkg).FLUSH_TREE_LIMIT + 10):
            with o.tracer().span("solver.solve") as sp:
                ids.append(sp.trace_id)
        payload = tc(pkg).member_payload("me", "controller")
        shipped = {t["trace_id"] for t in payload["traces"]}
        return (sorted(payload), len(shipped), ids[-1] in shipped, ids[0] in shipped)

    assert same(run)[1:] == (64, True, False)


@pytest.mark.parametrize("server_pkg,client_pkg", [(PORT, JAX), (JAX, PORT)],
                         ids=["jax-scrapes-port", "port-scrapes-jax"])
def test_http_pull_scrapes_the_other_package(server_pkg, client_pkg):
    """The pull backend of one package assembles a member payload from the
    other package's sidecar health server."""
    pytest.importorskip("grpc")
    o = OBS[server_pkg]
    o.configure_slo(objectives=("solve.p99 < 100ms",))
    o.configure_profiler(hz=50)
    with o.tracer().span("solver.solve"):
        pass
    svc = mod(server_pkg, "solver.service")
    port = free_port()
    httpd = svc._serve_health(
        svc.SolverService(**({"device": "cpu"} if server_pkg == PORT else {})), port)
    try:
        docs = tc(client_pkg).HttpTelemetryBackend([f"peer-1=http://127.0.0.1:{port}"]).poll()
        assert [d["identity"] for d in docs] == ["peer-1"]
        assert any(t["name"] == "solver.solve" for t in docs[0]["traces"])
        assert "objectives" in docs[0]["slo"] and docs[0]["profile"]["enabled"]
        dead = tc(client_pkg).HttpTelemetryBackend([f"http://127.0.0.1:{free_port()}"],
                                                   timeout=0.2)
        assert dead.poll() == []
    finally:
        httpd.shutdown()


# ---------------------------------------------------------------------------
# the sampling profiler
# ---------------------------------------------------------------------------


def prof_mod(pkg):
    return mod(pkg, "obs.profiler")


def test_fold_stack_and_labels_match_the_reference():
    def outer_for_profiler():
        return middle_for_profiler()

    def middle_for_profiler():
        frame = sys._getframe()
        return {pkg: (prof_mod(pkg).fold_stack(frame), prof_mod(pkg).fold_stack(frame, 2),
                      prof_mod(pkg)._frame_label(frame)) for pkg in BOTH}

    out = outer_for_profiler()
    assert out[PORT] == out[JAX]
    full, short, label = out[PORT]
    assert full.endswith("outer_for_profiler;" + label)
    assert short.count(";") == 1 and label.startswith("tests/test_torch_telemetry.py:")


def test_fold_storage_overflows_into_other():
    def run(pkg):
        prof = prof_mod(pkg).SamplingProfiler(hz=50, max_folds=2)
        for key in "abcd":
            prof._bump_locked(prof._folds, key)
        return prof._folds

    assert same(run) == {"a": 1, "b": 1, "<other>": 2}


def test_samples_attributed_to_the_active_span_on_another_thread():
    def run(pkg):
        o = OBS[pkg]
        prof = o.SamplingProfiler(hz=50, tracer=o.tracer())
        entered, release = threading.Event(), threading.Event()

        def parked_in_span():
            with o.tracer().span("prof.target"):
                entered.set()
                release.wait(5.0)

        t = threading.Thread(target=parked_in_span, daemon=True)
        t.start()
        entered.wait(5.0)
        try:
            prof.sample_once()
            prof.sample_once()
            snap = prof.snapshot(top_n=50)
        finally:
            release.set()
            t.join()
        folds = prof.collapsed()
        assert "parked_in_span" in folds
        assert any("wait" in row["frame"] for row in snap["top"])
        return sorted(snap), snap["span_samples"].get("prof.target"), snap["ticks"]

    assert same(run)[1:] == (2, 2)


def test_flight_record_and_debug_payload_carry_the_profile(tmp_path):
    def run(pkg):
        o = OBS[pkg]
        ctype, body = o.debug_profile_payload("")
        off = (ctype, json.loads(body))
        rec = o.configure_flight(str(tmp_path / pkg), budget_s=0.0)
        prof = o.configure_profiler(hz=50)
        prof.stop()  # drive it by hand: the daemon's tick count is timing
        release = threading.Event()
        t = threading.Thread(target=release.wait, args=(5.0,), daemon=True)
        t.start()
        try:
            prof.sample_once()
        finally:
            release.set()
            t.join()
        with o.tracer().span("solver.solve"):
            pass
        panel = rec.recent()[0]["state"]["profile"]
        ctype, body = o.debug_profile_payload("")
        doc = json.loads(body)["profile"]
        collapsed = o.debug_profile_payload("format=collapsed")
        return (off, sorted(panel), panel["window_samples"] >= 1, ctype, sorted(doc),
                doc["samples"] >= 1, collapsed[0], b"Event.wait" in collapsed[1])

    out = same(run)
    assert out[0] == ("application/json", {"profile": {"enabled": False}})
    assert out[2] and out[5] and out[6] == "text/plain" and out[7]


def test_daemon_overhead_self_accounted():
    prof = T_OBS.configure_profiler(hz=97)
    time.sleep(0.3)
    snap = prof.snapshot()
    assert snap["samples"] > 0 and snap["overhead_ratio"] < 0.10
    assert T_METRICS.TELEMETRY_PROFILE_OVERHEAD._value.get() == pytest.approx(
        prof.overhead_ratio(), abs=0.05)
    T_OBS.shutdown_profiler(object())  # not the owner: a no-op
    assert T_OBS.profiler() is prof
    sampler = prof._thread
    T_OBS.reset_for_tests()  # a sampler left running would tax later tests
    assert T_OBS.profiler() is None and not sampler.is_alive()


# ---------------------------------------------------------------------------
# satellites: flight panel containment, ?trace_id= lookup over the sidecar
# ---------------------------------------------------------------------------


def test_raising_panel_counts_and_keeps_the_tree(tmp_path):
    def run(pkg):
        o, m = OBS[pkg], METRICS[pkg]
        rec = o.configure_flight(str(tmp_path / pkg), budget_s=0.0)
        o.register_state("broken-t", lambda: 1 / 0)
        o.register_state("fine-t", lambda: {"ok": 1})
        before = m.FLIGHT_PANEL_ERRORS.labels(panel="broken-t")._value.get()
        try:
            with o.tracer().span("solver.solve"):
                pass
        finally:
            o.unregister_state("broken-t")
            o.unregister_state("fine-t")
        record = rec.recent()[0]
        return (record["trace"]["name"], record["state"]["fine-t"], record["state"]["broken-t"],
                m.FLIGHT_PANEL_ERRORS.labels(panel="broken-t")._value.get() - before)

    assert same(run) == ("solver.solve", {"ok": 1},
                         "<state provider failed: division by zero>", 1)


def test_sidecar_health_serves_the_telemetry_endpoints():
    """Exact ?trace_id= lookup, /debug/fleet, and the dual-typed
    /debug/profile over the port's sidecar health server, whose bodies
    equal the reference's payload functions' on the same state."""
    pytest.importorskip("grpc")
    from karpenter_tpu_torch.solver.service import SolverService, _serve_health

    with T_OBS.tracer().span("sidecar.pack") as sp:
        wanted = sp.trace_id
    with T_OBS.tracer().span("sidecar.pack"):
        pass
    port = free_port()
    httpd = _serve_health(SolverService(device="cpu"), port)

    def get(path):
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=5) as r:
            return r.headers.get("Content-Type"), r.read()

    try:
        ctype, body = get(f"/debug/traces?trace_id={wanted}")
        assert ctype == "application/json"
        assert [t["trace_id"] for t in json.loads(body)["traces"]] == [wanted]
        assert json.loads(get("/debug/fleet")[1]) == J_OBS.debug_fleet_payload() == {"fleet": {}}
        ctype, body = get("/debug/profile")
        assert (ctype, json.loads(body)) == ("application/json", {"profile": {"enabled": False}})
        assert get("/debug/profile?format=collapsed")[0] == "text/plain"
        assert json.loads(get("/debug/incidents")[1]) == J_OBS.debug_incidents_payload()
    finally:
        httpd.shutdown()


# ---------------------------------------------------------------------------
# the acceptance path: live solves → stitched tree → /debug/fleet
# ---------------------------------------------------------------------------


def encoded_args(pkg):
    from torch_parity import encode_scenario

    import numpy as np

    prov, catalog, pods = scenario(pkg, "diverse", 6, 3, 8)
    return [np.asarray(a) for a in encode_scenario(pkg, prov, catalog, pods).pack_args()]


def check_stitched(solve, tc_mod):
    """The sidecar's real sidecar.pack under the solver.wire it rode,
    rebased inside it, with admission_wait_s and real children."""
    wire = next(s for s in tc_mod._walk(solve) if s["name"] == "solver.wire")
    packs = [c for c in wire["children"] if c["name"] == "sidecar.pack"]
    assert packs, [c["name"] for c in wire["children"]]
    pack = packs[0]
    assert pack["stitched"] is True and pack["trace_id"] == solve["trace_id"]
    assert wire["t0"] <= pack["t0"] <= pack["t1"] <= wire["t1"]
    assert "admission_wait_s" in pack["attrs"]
    assert {"sidecar.solve", "sidecar.fetch"} <= {c["name"] for c in pack["children"]}
    attr = tc_mod.wire_attribution(solve)
    assert attr["stitched"] is True and attr["wire_share_pct"] is not None


def test_live_solve_stitches_the_pack_under_its_wire():
    pytest.importorskip("grpc")
    from karpenter_tpu_torch.solver.service import RemoteSolver, SolverService, serve

    address = f"127.0.0.1:{free_port()}"
    server = serve(address, service=SolverService(device="cpu"))
    try:
        client = RemoteSolver(address, timeout=30)
        with packer("fused"), T_OBS.tracer().span("solver.solve") as root:
            result = client.pack(*encoded_args(PORT), n_max=8)
        client.close()
        assert int(result.n_nodes) >= 1
        roots, joins = T_OBS.stitch(T_OBS.exporter().trees())
        assert joins >= 1
        solve = next(r for r in roots if r["name"] == "solver.solve")
        assert solve["trace_id"] == root.trace_id
        check_stitched(solve, tc(PORT))
    finally:
        server.stop(grace=0)


def test_fleet_endpoint_merges_members_p99_within_5pct(tmp_path):
    """This process's engine flushes through the plane, a JAX-package
    member publishes its own snapshot into the same directory, and the
    merged solve.p99 tracks the exact quantile of the combined stream."""
    rng = random.Random(9)
    mine = [abs(rng.gauss(0.02, 0.008)) + 1e-4 for _ in range(500)]
    theirs = [abs(rng.gauss(0.05, 0.02)) + 1e-4 for _ in range(500)]
    flushes = T_METRICS.TELEMETRY_FLUSHES._value.get()
    feed(T_OBS.configure_slo(objectives=("solve.p99 < 100ms",)), "solver.solve", mine)
    plane = T_OBS.configure_telemetry(identity="replica-self", directory=str(tmp_path),
                                      flush_interval=60.0)
    plane.flush()
    other = J_OBS.SloEngine(objectives=("solve.p99 < 100ms",))
    feed(other, "solver.solve", theirs)
    tc(JAX).FileTelemetryBackend(str(tmp_path), identity="replica-b").publish(
        member(JAX, "replica-b", slo=other.histogram_snapshot()))
    payload = T_OBS.debug_fleet_payload()["fleet"]
    assert {"replica-self", "replica-b"} <= {m["identity"] for m in payload["members"]}
    got, truth = payload["slo"]["solve_p99"]["value"], exact_p99(mine + theirs)
    assert abs(got - truth) / truth < 0.05
    assert T_METRICS.TELEMETRY_FLUSHES._value.get() - flushes >= 1
    T_OBS.shutdown_telemetry(plane)
    assert T_OBS.telemetry() is None


def test_two_process_stitch_over_the_file_backend(tmp_path):
    """The port's sidecar entry point in a second process (``--device
    cpu``) flushes its ring; the collector stitches its sidecar.pack, on
    a foreign perf_counter base, into this process's solver.wire."""
    grpc = pytest.importorskip("grpc")
    from karpenter_tpu_torch.solver.service import RemoteSolver

    address = f"127.0.0.1:{free_port()}"
    proc = subprocess.Popen(
        [sys.executable, "-m", "karpenter_tpu_torch.solver.service", "--address", address,
         "--health-port", "0", "--telemetry-dir", str(tmp_path),
         "--telemetry-flush-interval", "1", "--profile-hz", "7", "--device", "cpu"],
        env={**os.environ, "KARPENTER_PACKER": "fused"},
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
    )
    try:
        grpc.channel_ready_future(grpc.insecure_channel(address)).result(timeout=120)
        client = RemoteSolver(address, timeout=180, cold_timeout=300)
        with T_OBS.tracer().span("solver.solve"):
            assert int(client.pack(*encoded_args(PORT), n_max=8).n_nodes) >= 1
        client.close()
        coll = tc(PORT).TelemetryCollector(
            [tc(PORT).FileTelemetryBackend(str(tmp_path), identity="ctrl")], flush_interval=1.0,
            extra_trees=lambda: T_OBS.exporter().snapshot(limit=None, newest_first=False))
        solve = None
        deadline = time.time() + 30
        while time.time() < deadline and solve is None:
            coll.refresh()
            roots, _ = coll.stitched()
            solve = next((r for r in roots if r["name"] == "solver.solve" and any(
                s.get("stitched") for s in tc(PORT)._walk(r))), None)
            time.sleep(0.5)
        assert solve is not None, "the sidecar's flush never stitched"
        check_stitched(solve, tc(PORT))
        members = {m["identity"]: m for m in coll.members()}
        assert members[f"sidecar-{address}"]["role"] == "sidecar"
    finally:
        proc.terminate()
        proc.wait(timeout=20)
