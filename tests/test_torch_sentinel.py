"""The port's regression sentinel and incident plane against the JAX
package's: keying, detection, incident correlation and evidence,
baseline persistence across the two packages, the obs wiring and the
``/debug/incidents`` surface. The same fake-span streams go through both
packages' engines; records are compared without their ids and wall times.
"""

from __future__ import annotations

import importlib
import json
import os
import socket
import threading
import urllib.request

import pytest

import karpenter_tpu.obs as J_OBS
import karpenter_tpu_torch.obs as T_OBS
from torch_parity import fresh_router  # noqa: F401

JAX, PORT = "karpenter_tpu", "karpenter_tpu_torch"
BOTH = (JAX, PORT)
OBS = {JAX: J_OBS, PORT: T_OBS}


@pytest.fixture(autouse=True)
def _fresh_obs():
    for o in OBS.values():
        o.reset_for_tests()
    yield
    for o in OBS.values():
        o.reset_for_tests()


def sentinel(pkg):
    return importlib.import_module(f"{pkg}.obs.sentinel")


def incidents(pkg):
    return importlib.import_module(f"{pkg}.obs.incidents")


def same(fn):
    out = {pkg: fn(pkg) for pkg in BOTH}
    assert out[PORT] == out[JAX], out
    return out[PORT]


class FakeSpan:
    """What the engine reads (name, duration, attrs) and what the
    incident plane serializes (``to_dict``)."""

    def __init__(self, name, duration_s, attrs=None, trace_id="t" * 32):
        self.name = name
        self.duration_s = duration_s
        self.attrs = attrs or {}
        self.error = None
        self.trace_id = trace_id

    def to_dict(self):
        return {"name": self.name, "trace_id": self.trace_id, "duration_s": self.duration_s,
                "attrs": dict(self.attrs), "children": []}


def tight_engine(pkg, **kw):
    """Warm in 8 events, 4-wide windows, trip on 2 sustained windows."""
    defaults = dict(min_events=8, window=4, sustain=2, abs_floor_s=0.0005)
    defaults.update(kw)
    return sentinel(pkg).SentinelEngine(**defaults)


def feed(eng, n, duration, name="solver.solve", attrs=None):
    for _ in range(n):
        eng(FakeSpan(name, duration, attrs=attrs))


VOLATILE = {"id", "opened_at", "last_deviation_at", "at", "state", "decisions", "flights",
            "profile_top"}


def stable(record):
    """An incident record without ids, wall times and the process-wide
    evidence (panels, decisions, flights, folds), which tests compare on
    their own."""
    if isinstance(record, dict):
        return {k: stable(v) for k, v in record.items() if k not in VOLATILE}
    if isinstance(record, list):
        return [stable(v) for v in record]
    return record


# ---------------------------------------------------------------------------
# keying
# ---------------------------------------------------------------------------


def test_shape_class_and_route_match_the_reference():
    shapes = [4000, 3900, 400, 1, 0, -3, None, "nope", "17", 2.5]
    attrs = [{"transport": "stream_shm"}, {"backend": "cpsat"}, {"solver": "tpu"},
             {"route": "v2"}, {"address": "h:50051"}, {}, {"transport": "", "backend": "x"},
             {"backend": "pack_first_fit"}]

    def run(pkg):
        m = sentinel(pkg)
        return ([m.shape_class(v) for v in shapes],
                [m.route_of(FakeSpan("w", 0.0, a)) for a in attrs])

    got = same(run)
    assert got[0][:8] == ["4096", "4096", "512", "1", "0", "0", "-", "-"]
    assert got[1][4:6] == ["remote", "-"]


# ---------------------------------------------------------------------------
# detection: one stream through both engines
# ---------------------------------------------------------------------------

STREAMS = {
    "sustained step": [(12, 0.001), (12, 0.003)],
    "single outlier": [(12, 0.001), (1, 0.050), (12, 0.001)],
    "warm-up is quiet": [(20, 0.001), (20, 0.100)],
    "recovery after re-baseline": [(12, 0.001), (12, 0.003), (20, 0.003), (20, 0.001)],
    "persisting regression": [(12, 0.001), (60, 0.004)],
    "routes and shapes": [(4, 0.001, "solver.solve", {"transport": "stream", "pods": 100}),
                          (4, 0.010, "solver.solve", {"transport": "unary", "pods": 100}),
                          (4, 0.050, "solver.solve", {"transport": "stream", "pods": 4000})],
    "unwatched": [(10, 0.001, "not.watched")],
    "key cap": [(2, 0.001, "solver.solve", {"transport": f"r{i}"}) for i in range(8)],
}
EXPECTED_INCIDENTS = {"sustained step": 1, "recovery after re-baseline": 1,
                      "persisting regression": 1}


@pytest.mark.parametrize("case", list(STREAMS))
def test_same_stream_same_baselines_and_incidents(case):
    def run(pkg):
        kw = {"min_events": 100} if case == "warm-up is quiet" else {}
        if case == "key cap":
            kw["key_cap"] = 4
        eng = tight_engine(pkg, **kw)
        for step in STREAMS[case]:
            feed(eng, *step)
        snap = eng.snapshot()
        snap.pop("overhead_ratio")
        return snap, eng.incidents.count(), stable(eng.incidents.recent())

    snap, count, records = same(run)
    assert count == EXPECTED_INCIDENTS.get(case, 0)
    if case == "sustained step":
        row = records[0]["stages"][0]
        assert records[0]["stage"] == "solver.solve"
        assert row["observed_s"] == pytest.approx(0.003, rel=0.01)
        assert row["baseline_s"] == pytest.approx(0.001, rel=0.05)
    if case == "single outlier":
        # the gated update kept the outlier out of the baseline
        assert snap["baselines"][0]["level_s"] == pytest.approx(0.001, rel=0.05)
    if case == "routes and shapes":
        assert snap["baseline_count"] == 3
    if case == "unwatched":
        assert snap["baseline_count"] == 0
    if case == "key cap":
        assert {b["route"] for b in snap["baselines"]} == {"r4", "r5", "r6", "r7"}


def test_hostile_span_is_contained():
    class Hostile:
        name = "solver.solve"
        duration_s = 0.001
        trace_id = "t" * 32

        @property
        def attrs(self):
            raise RuntimeError("hostile span")

    def run(pkg):
        eng = tight_engine(pkg)
        eng(Hostile())  # must not raise
        return eng.baseline_count()

    assert same(run) == 0


# ---------------------------------------------------------------------------
# incident correlation (injected clock)
# ---------------------------------------------------------------------------


def trip(log, stage="solver.wire", route="stream", observed=0.004, baseline=0.001):
    return log.deviation(
        stage=stage, route=route, shape="4096",
        span=FakeSpan(stage, observed, {"transport": route}),
        baseline={"observed_s": observed, "baseline_s": baseline, "baseline_std_s": 0.0001,
                  "threshold_s": baseline * 2, "observations": 50})


# (seconds before each trip, stage) per case, and the ring's cap
TRIPS = {
    "attach in window": ([(0, "solver.wire"), (10, "sidecar.pack")], 32),
    "past the window": ([(0, "solver.wire"), (31, "solver.wire")], 32),
    "stages bounded": ([(1, f"stage.{i}") for i in range(20)], 32),
    "ring bounded": ([(31, "solver.wire")] * 5, 3),
}


@pytest.mark.parametrize("case", list(TRIPS))
def test_incident_correlation_matches_the_reference(case):
    steps, cap = TRIPS[case]

    def run(pkg):
        t = [1000.0]
        log = incidents(pkg).IncidentLog(cap=cap, clock=lambda: t[0])
        ids, opens = [], []
        for dt, stage in steps:
            t[0] += dt
            ids.append(trip(log, stage=stage)["id"])
            opens.append(log.open_summary() is not None)
        t[0] += 31.0
        opens.append(log.open_summary())
        summaries = log.summaries(limit=10)
        return (log.count(), stable(log.recent(limit=10)), opens,
                [sorted(s) for s in summaries], [r["last_deviation_at"] for r in log.recent()],
                log.get(ids[0]) is None, log.get(ids[-1])["id"] == ids[-1])

    count, records, _, keys, _, first_gone, _ = same(run)
    assert count == {"attach in window": 1, "past the window": 2, "stages bounded": 1,
                     "ring bounded": 5}[case]
    if case == "attach in window":
        assert [s["stage"] for s in records[0]["stages"]] == ["solver.wire", "sidecar.pack"]
    if case == "stages bounded":
        assert len(records[0]["stages"]) == 8
    if case == "ring bounded":
        assert len(records) == 3 and first_gone
    assert all(k == ["decision_ids", "flight_count", "id", "opened_at", "stage", "stages",
                     "trace_id"] for k in keys)


def test_incident_correlates_flight_decisions_profile_and_state(tmp_path):
    """The evidence: the triggering tree force-recorded and pinned, the
    in-window decision id, the profiler's folds and the state panels."""
    def run(pkg):
        o = OBS[pkg]
        o.configure_flight(str(tmp_path / pkg), budget_s=10.0)
        prof = o.configure_profiler(hz=50.0)
        prof.stop()  # sampled by hand: a parked thread gives it a stack
        release = threading.Event()
        parked = threading.Thread(target=release.wait, args=(5.0,), daemon=True)
        parked.start()
        prof.sample_once()
        release.set()
        parked.join()
        round_rec = o.decision_log().record_round("default", [], [], context={})
        events = []

        class Recorder:
            def event(self, kind, name, **kw):
                events.append((kind, name, kw["reason"], kw["type"], kw["decision_id"]))

        log = incidents(pkg).IncidentLog(recorder=Recorder())
        rec = trip(log, route="stream_shm")
        flight = rec["flights"][0]
        summary = log.summaries()[0]
        assert events == [("Provisioner", "stream_shm", "IncidentDetected", "Warning",
                           round_rec["id"])]
        assert rec["decisions"][0]["id"] == round_rec["id"] == summary["decision_ids"][0]
        assert flight["incident_id"] == rec["id"]
        assert flight["file"] in o.flight_recorder().pinned()
        assert rec["profile_top"] and rec["profile_top"][0]["samples"] >= 1
        assert {"profile"} <= set(rec["state"])
        return (rec["trace"], sorted(flight), summary["flight_count"], sorted(rec),
                len(rec["decisions"]))

    assert same(run)[2] == 1


def test_evidence_failures_are_contained():
    class NoDict:  # lacks to_dict()
        name = "solver.wire"
        duration_s = 0.004
        attrs = {}
        trace_id = "t" * 32

    def run(pkg):
        events = []

        class Recorder:
            def event(self, kind, name, **kw):
                events.append(kw["decision_id"])

        quiet = incidents(pkg).IncidentLog(recorder=Recorder())
        trip(quiet)
        broken = incidents(pkg).IncidentLog().deviation(
            stage="solver.wire", route="-", shape="-", span=NoDict(), baseline={})
        return events, broken

    assert same(run) == ([""], None)


def test_pinned_flight_evidence_survives_the_ring():
    def run(pkg, tmp):
        rec = importlib.import_module(f"{pkg}.obs.flight").FlightRecorder(
            str(tmp), budget_s=0.0, cap=2)
        for i in range(3):
            rec.record(FakeSpan("solver.solve", 0.5, trace_id=f"{i:032d}"))
        pins = rec.pin_for_incident("i-deadbeef", limit=2)
        for _ in range(6):
            rec.record(FakeSpan("solver.solve", 0.5))
        on_disk = set(os.listdir(str(tmp)))
        return ([(p["trace_id"], p["incident_id"], p["file"] in on_disk) for p in pins],
                sorted(rec.pinned().values()), len(on_disk))

    import tempfile

    out = {}
    for pkg in BOTH:
        with tempfile.TemporaryDirectory() as tmp:
            out[pkg] = run(pkg, tmp)
    assert out[PORT] == out[JAX]
    assert out[PORT][0] == [(f"{2:032d}", "i-deadbeef", True), (f"{1:032d}", "i-deadbeef", True)]


# ---------------------------------------------------------------------------
# persistence
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("writer,reader", [(JAX, PORT), (PORT, JAX), (PORT, PORT)],
                         ids=["jax-writes", "port-writes", "port-only"])
def test_baseline_file_restores_across_packages(tmp_path, writer, reader):
    d = str(tmp_path / "sentinel")
    eng = tight_engine(writer, directory=d)
    feed(eng, 16, 0.001)
    eng.close()
    assert os.path.exists(os.path.join(d, sentinel(writer).BASELINE_FILE))
    restored = tight_engine(reader, directory=d)
    row = restored.snapshot()["baselines"][0]
    assert restored.baseline_count() == 1 and row["restored"] is True
    assert row["level_s"] == pytest.approx(0.001, rel=0.05)
    # restarted mid-stream: steady traffic is quiet, a real step trips at once
    feed(restored, 30, 0.001)
    assert restored.incidents.count() == 0
    feed(restored, 12, 0.005)
    assert restored.incidents.count() == 1


PERSIST_CASES = ["corrupt", "wrong version", "uncreatable", "save fails"]


@pytest.mark.parametrize("case", PERSIST_CASES)
def test_persistence_failures_degrade_alike(tmp_path, case):
    def run(pkg):
        base = tmp_path / pkg
        d = base / "sentinel"
        os.makedirs(d)
        blocker = base / "file"
        blocker.write_text("x")
        if case == "corrupt":
            (d / sentinel(pkg).BASELINE_FILE).write_text("{not json")
        if case == "wrong version":
            (d / sentinel(pkg).BASELINE_FILE).write_text(json.dumps(
                {"version": 99, "baselines": [{"key": ["a", "b", "c"], "level": 1.0}]}))
        eng = tight_engine(pkg, directory=str(blocker / "sub") if case == "uncreatable"
                           else str(d))
        loaded = eng.baseline_count()
        feed(eng, 12, 0.001)
        if case == "save fails":
            eng.directory = str(blocker / "sub")
        saved = eng.save()
        return loaded, saved, eng.directory.replace(str(base), ""), eng.baseline_count()

    expected = {"corrupt": (0, True, "/sentinel", 1), "wrong version": (0, True, "/sentinel", 1),
                "uncreatable": (0, False, "", 1), "save fails": (0, False, "", 1)}
    assert same(run) == expected[case]


# ---------------------------------------------------------------------------
# the obs facade + /debug/incidents
# ---------------------------------------------------------------------------


def test_configure_sentinel_wiring_matches_the_reference(tmp_path):
    def run(pkg):
        o = OBS[pkg]
        flight = importlib.import_module(f"{pkg}.obs.flight")
        eng = o.configure_sentinel(min_events=3, window=2, sustain=1, incident_cap=5)
        with o.tracer().span("solver.solve"):
            pass
        with o.tracer().span("not.watched"):
            pass
        panel = sorted(flight.state_snapshot(only=("sentinel",))["sentinel"])
        eng2 = o.configure_sentinel(directory=str(tmp_path / pkg), min_events=4)
        feed(eng2, 8, 0.001)
        o.shutdown_sentinel(engine=eng)  # a stale owner: not ours to kill
        kept = o.sentinel() is eng2
        o.shutdown_sentinel(engine=eng2)
        persisted = os.path.exists(tmp_path / pkg / sentinel(pkg).BASELINE_FILE)
        o.configure_sentinel()
        o.reset_for_tests()
        return ((eng.min_events, eng.window, eng.sustain, eng.incidents.cap),
                eng.snapshot()["baselines"][0]["stage"], eng.baseline_count(), panel, kept,
                o.sentinel(), "sentinel" in flight.state_snapshot(), persisted)

    assert same(run) == ((3, 2, 1, 5), "solver.solve", 1,
                         ["baselines", "incidents", "open_incident", "overhead_ratio"],
                         True, None, False, True)


def test_incidents_payload_and_member_summaries_match_the_reference():
    def run(pkg):
        o = OBS[pkg]
        empty = o.debug_incidents_payload("")
        eng = o.configure_sentinel(min_events=8, window=4, sustain=2, abs_floor_s=0.0005)
        feed(eng, 12, 0.001)
        feed(eng, 12, 0.003)
        body = o.debug_incidents_payload("")
        iid = body["incidents"][0]["id"]
        detail = o.debug_incidents_payload(f"id={iid}")["incident"]
        payload = importlib.import_module(f"{pkg}.obs.collector").member_payload("ctl-0", "x")
        body["sentinel"].pop("overhead_ratio")
        return (empty, stable(body), detail["id"] == iid, detail["trace"]["name"],
                o.debug_incidents_payload("id=i-nope")["incident"],
                o.debug_incidents_payload("limit=0")["incidents"],
                stable(payload["incidents"]), sorted(payload))

    out = same(run)
    assert out[0] == {"incidents": [], "sentinel": {}}
    assert out[2:6] == (True, "solver.solve", None, [])
    assert out[6][0]["stages"][0]["stage"] == "solver.solve"


def test_fleet_incidents_merge_and_dedupe():
    inc_a = {"id": "i-aaa", "opened_at": 100.0, "stage": "solver.wire"}
    inc_b = {"id": "i-bbb", "opened_at": 200.0, "stage": "sidecar.pack"}

    class Backend:
        def poll(self):
            return [{"identity": "ctl-0", "traces": [], "incidents": [inc_a, inc_b]},
                    {"identity": "side-0", "traces": [], "incidents": [inc_b]}]

    def run(pkg):
        coll = importlib.import_module(f"{pkg}.obs.collector").TelemetryCollector([Backend()])
        coll.refresh()
        return coll.fleet_incidents(), coll.fleet_payload()["incidents"]

    fleet, payload = same(run)
    assert [i["id"] for i in fleet] == [i["id"] for i in payload] == ["i-bbb", "i-aaa"]
    assert fleet[0]["member"] == "ctl-0"


def test_sidecar_health_serves_incidents():
    from karpenter_tpu_torch.solver.service import SolverService, _serve_health

    eng = T_OBS.configure_sentinel(min_events=8, window=4, sustain=2, abs_floor_s=0.0005,
                                   watch=("sidecar.pack",))
    feed(eng, 12, 0.001, name="sidecar.pack")
    feed(eng, 12, 0.004, name="sidecar.pack")
    service = SolverService(device="cpu")
    service.ready.set()
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    httpd = _serve_health(service, port)

    def get(path):
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=5) as r:
            return json.loads(r.read())

    try:
        body = get("/debug/incidents")
        assert [i["stages"][0]["stage"] for i in body["incidents"]] == ["sidecar.pack"]
        iid = body["incidents"][0]["id"]
        assert get(f"/debug/incidents?id={iid}")["incident"]["id"] == iid
    finally:
        httpd.shutdown()


@pytest.mark.parametrize("n", [6, 12, 24, 64])
def test_slo_small_samples_are_exact(n):
    """While the window's raw samples are complete, the online p99 is the
    exact nearest-rank p99 (the engine's small-sample path), in both."""
    import math

    durations = [0.001 + 0.0017 * ((i * 7) % n) for i in range(n)]

    def run(pkg):
        eng = OBS[pkg].configure_slo()
        for d in durations:
            eng(FakeSpan("solver.solve", d))
        return eng.snapshot()["objectives"]["solve_p99"]["value"]

    vs = sorted(durations)
    assert same(run) == pytest.approx(vs[min(len(vs) - 1, max(math.ceil(0.99 * n) - 1, 0))],
                                      abs=1e-12)
