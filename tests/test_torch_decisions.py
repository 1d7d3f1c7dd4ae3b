"""The port's decision audit log against the JAX package's.

The same rounds go through both packages' schedulers (each on its unfused
plain rung, ``KARPENTER_PACKER=scan``) and both packages' ``DecisionLog``:
the records equal modulo their id, time, trace id and the explain cost,
with pods compared by their index in the input list (the two packages'
factories name pods from separate counters). The ring's cap,
its drop counters and its write thinning; streaks, explain, summaries and
the Kubernetes loop; and the replay blob across packages, both ways, bit
exact.
"""

from __future__ import annotations

import importlib
import os
import random
import re

import numpy as np
import pytest

import karpenter_tpu.obs as J_OBS
import karpenter_tpu_torch.obs as T_OBS
from karpenter_tpu import metrics as J_METRICS
from karpenter_tpu_torch import metrics as T_METRICS
from torch_parity import fresh_router, mods, packer  # noqa: F401

JAX, PORT = "karpenter_tpu", "karpenter_tpu_torch"
BOTH = (JAX, PORT)
OBS = {JAX: J_OBS, PORT: T_OBS}
METRICS = {JAX: J_METRICS, PORT: T_METRICS}


@pytest.fixture(autouse=True)
def _fresh_obs():
    for pkg in BOTH:
        OBS[pkg].reset_for_tests()
        dec(pkg).set_enabled(True)
    yield
    for o in OBS.values():
        o.reset_for_tests()


def mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def dec(pkg):
    return mod(pkg, "obs.decisions")


def native_ready(pkg) -> bool:
    return mod(pkg, "solver.native").native_available(wait=240.0)


def stuck_pods(pkg, n_ok=3, n_stuck=1):
    f = mods(pkg).factories
    pods = [f.make_pod(requests={"cpu": "0.5"}) for _ in range(n_ok)]
    pods += [f.make_pod(name=f"stuck-{i}", requests={"cpu": "100000"}) for i in range(n_stuck)]
    return pods


def solved_context(pkg, pods, n_types=10):
    """One accelerated solve through the package's facade → (nodes, the
    consumed decision context). Both packages on the unfused plain rung
    (``scan``): the same node-table size, so the same replay blob."""
    M = mods(pkg)
    catalog = M.fake.instance_types(n_types)
    prov = M.factories.make_provisioner(solver="tpu")
    sched_mod = mod(pkg, "scheduling.scheduler")
    extra = {"device": "cpu"} if pkg == PORT else {}
    sched = sched_mod.Scheduler(M.Cluster(), rng=random.Random(1), **extra)
    with packer("scan"):
        nodes = sched.solve(prov, catalog, pods)
    return nodes, sched.last_decision_context()


def keymap(pods) -> dict:
    return {p.key: f"pod#{i}" for i, p in enumerate(pods)}


def norm(obj, keys: dict):
    """``obj`` with every pod key (and bare pod name) replaced by the pod's
    index in the input list."""
    names = {k.rpartition("/")[2]: v for k, v in keys.items()}
    if isinstance(obj, dict):
        return {k: norm(v, keys) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(norm(v, keys) for v in obj)
    if isinstance(obj, str):
        if obj in keys:
            return keys[obj]
        if obj in names:
            return names[obj]
        return re.sub(r"[\w.-]+/pod-\d+", lambda m: keys.get(m.group(0), m.group(0)), obj)
    return obj


# what differs between any two records by construction
VOLATILE = ("id", "recorded_at", "trace_id", "explain_s", "path", "replay_file")


def record_view(rec: dict, keys: dict) -> dict:
    out = {k: v for k, v in rec.items() if k not in VOLATILE}
    return norm(out, keys)


def each(fn):
    return {pkg: fn(pkg) for pkg in BOTH}


def counter(pkg, name, **labels):
    metric = getattr(METRICS[pkg], name)
    child = metric.labels(**labels) if labels else metric
    return child._value.get()


# ---------------------------------------------------------------------------
# records
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_stuck", [1, 3])
def test_round_records_equal_the_reference(n_stuck):
    def run(pkg):
        pods = stuck_pods(pkg, n_stuck=n_stuck)
        nodes, ctx = solved_context(pkg, pods)
        assert sorted(ctx) == ["address", "assignment", "batch", "n_max", "route",
                               "session_key", "transport"]
        log = dec(pkg).DecisionLog()
        rec = log.record_round("default", pods, nodes, context=ctx, trace_id="t-1",
                               state={"fenced": False})
        assert rec["trace_id"] == "t-1"
        view = record_view(log.recent(limit=1)[0], keymap(pods))
        route = view.pop("route")
        return view, route, ctx["n_max"], ctx["assignment"].tolist()

    out = each(run)
    assert out[PORT][0] == out[JAX][0]
    assert out[PORT][2:] == out[JAX][2:]
    view = out[PORT][0]
    assert view["unschedulable_count"] == n_stuck
    assert [v["top_reason"] for v in view["unschedulable"]] == ["resource_fit"] * n_stuck
    assert view["packing"] and view["pod_keys"]
    # what served, by each package's vocabulary: the reference's "device",
    # the port's plain version on the CPU
    assert (out[JAX][1], out[PORT][1]) == ("device", "pack_reference")


def test_explain_lookup_unplaced_and_placed():
    def run(pkg):
        pods = stuck_pods(pkg)
        nodes, ctx = solved_context(pkg, pods)
        log = dec(pkg).DecisionLog()
        log.record_round("default", pods, nodes, context=ctx)
        keys = keymap(pods)
        drop = ("decision_id", "recorded_at", "trace_id", "route")
        bad = {k: v for k, v in log.explain("stuck-0").items() if k not in drop}
        good = {k: v for k, v in log.explain(pods[0].metadata.name).items() if k not in drop}
        return norm(bad, keys), norm(good, keys), log.explain("no-such-pod")

    out = each(run)
    assert out[PORT] == out[JAX]
    bad, good, none = out[PORT]
    assert bad["placed"] is False and bad["top_reason"] == "resource_fit"
    assert bad["consecutive_failures"] == 1 and bad["candidates"]
    assert good["placed"] is True and good["instance_type"] and none is None


def test_disabled_plane_records_nothing():
    def run(pkg):
        dec(pkg).set_enabled(False)
        pods = stuck_pods(pkg)
        nodes, ctx = solved_context(pkg, pods)
        log = dec(pkg).DecisionLog()
        return ctx, log.record_round("default", pods, nodes, context=ctx), log.recent()

    out = each(run)
    assert out[PORT] == out[JAX] == ({}, None, [])


def test_ffd_context_falls_back_to_key_difference():
    def run(pkg):
        pods = stuck_pods(pkg)
        nodes, _ = solved_context(pkg, pods)
        rec = dec(pkg).DecisionLog().record_round("default", pods, nodes, context={})
        return rec["unschedulable_count"], rec["unschedulable"], rec["route"]

    out = each(run)
    assert out[PORT] == out[JAX] == (1, [], None)


def test_streaks_reuse_and_reset_on_placement():
    def run(pkg):
        f = mods(pkg).factories
        pods = stuck_pods(pkg)
        nodes, ctx = solved_context(pkg, pods)
        log = dec(pkg).DecisionLog()
        r1 = log.record_round("default", pods, nodes, context=ctx)
        r2 = log.record_round("default", pods, nodes, context=ctx)
        assert r2["unschedulable"][0] is r1["unschedulable"][0]
        stuck_key = next(p.key for p in pods if p.metadata.name == "stuck-0")
        streak = log.failure_streak(stuck_key)
        ok = [p for p in pods if p.metadata.name != "stuck-0"]
        ok.append(f.make_pod(name="stuck-0", requests={"cpu": "0.5"}))
        nodes2, ctx2 = solved_context(pkg, ok)
        log.record_round("default", ok, nodes2, context=ctx2)
        return streak, log.failure_streak(stuck_key), log.last_decision_id("default") != ""

    out = each(run)
    assert out[PORT] == out[JAX] == (2, 0, True)


def test_summaries_equal_the_reference():
    def run(pkg):
        log = dec(pkg).DecisionLog()
        for n_stuck in (1, 2):
            pods = stuck_pods(pkg, n_stuck=n_stuck)
            nodes, ctx = solved_context(pkg, pods)
            log.record_round("default", pods, nodes, context=ctx)
        return [
            {k: v for k, v in s.items() if k not in ("id", "recorded_at", "trace_id", "route")}
            for s in log.summaries()
        ]

    out = each(run)
    assert out[PORT] == out[JAX]
    assert [s["unschedulable_count"] for s in out[PORT]] == [2, 1]


def test_recorded_counter_and_unschedulable_gauge():
    def run(pkg):
        before = counter(pkg, "DECISIONS_RECORDED")
        pods = stuck_pods(pkg, n_stuck=2)
        nodes, ctx = solved_context(pkg, pods)
        dec(pkg).DecisionLog().record_round("default", pods, nodes, context=ctx)
        return (counter(pkg, "DECISIONS_RECORDED") - before,
                counter(pkg, "PODS_UNSCHEDULABLE", reason="resource_fit"))

    out = each(run)
    assert out[PORT] == out[JAX] == (1.0, 2.0)


# ---------------------------------------------------------------------------
# the ring
# ---------------------------------------------------------------------------


def test_ring_cap_evicts_and_counts(tmp_path):
    def run(pkg):
        before = counter(pkg, "DECISIONS_DROPPED", reason="evicted")
        d = tmp_path / pkg
        log = dec(pkg).DecisionLog(directory=str(d), cap=3, write_interval=0.0)
        pods = stuck_pods(pkg)
        nodes, ctx = solved_context(pkg, pods)
        for _ in range(6):
            log.record_round("default", pods, nodes, context=ctx)
            assert log.flush(10.0)
        names = sorted(os.listdir(d))
        stems = {n[:-len(".json")] for n in names if n.endswith(".json")}
        assert all(n[:-len(".npz")] in stems for n in names if n.endswith(".npz"))
        log.close()
        return (len(stems), sum(n.endswith(".npz") for n in names),
                counter(pkg, "DECISIONS_DROPPED", reason="evicted") - before)

    out = each(run)
    assert out[PORT] == out[JAX] == (3, 3, 3.0)


def test_full_disk_never_fails_the_round(tmp_path, monkeypatch):
    def run(pkg):
        d = dec(pkg)
        log = d.DecisionLog(directory=str(tmp_path / pkg), write_interval=0.0)
        pods = stuck_pods(pkg)
        nodes, ctx = solved_context(pkg, pods)

        def enospc(*a, **k):
            raise OSError(28, "No space left on device")

        monkeypatch.setattr(d.np, "savez", enospc)
        before = counter(pkg, "DECISIONS_DROPPED", reason="write_failed")
        rec = log.record_round("default", pods, nodes, context=ctx)
        assert log.flush(10.0)
        monkeypatch.undo()
        log.close()
        return (rec is not None,
                counter(pkg, "DECISIONS_DROPPED", reason="write_failed") - before,
                len(log.recent(limit=1)))

    out = each(run)
    assert out[PORT] == out[JAX] == (True, 1.0, 1)


def test_write_interval_thins_disk_not_memory(tmp_path):
    def run(pkg):
        d = tmp_path / pkg
        log = dec(pkg).DecisionLog(directory=str(d), write_interval=3600.0)
        pods = stuck_pods(pkg)
        nodes, ctx = solved_context(pkg, pods)
        for _ in range(5):
            log.record_round("default", pods, nodes, context=ctx)
        assert log.flush(10.0)
        log.close()
        return sum(n.endswith(".json") for n in os.listdir(d)), len(log.recent(limit=10))

    out = each(run)
    assert out[PORT] == out[JAX] == (1, 5)


def test_full_write_queue_drops_and_counts(tmp_path, monkeypatch):
    def run(pkg):
        d = dec(pkg)
        monkeypatch.setattr(d, "MAX_WRITE_QUEUE", 0)
        log = d.DecisionLog(directory=str(tmp_path / pkg), write_interval=0.0)
        before = counter(pkg, "DECISIONS_DROPPED", reason="queue_full")
        pods = stuck_pods(pkg)
        nodes, ctx = solved_context(pkg, pods)
        log.record_round("default", pods, nodes, context=ctx)
        monkeypatch.undo()
        log.close()
        return counter(pkg, "DECISIONS_DROPPED", reason="queue_full") - before

    out = each(run)
    assert out[PORT] == out[JAX] == 1.0


def test_replaced_log_writer_thread_exits(tmp_path):
    def run(pkg):
        o = OBS[pkg]
        first = o.configure_decisions(directory=str(tmp_path / pkg / "a"), write_interval=0.0)
        pods = stuck_pods(pkg)
        nodes, ctx = solved_context(pkg, pods)
        first.record_round("default", pods, nodes, context=ctx)
        assert first.flush(10.0)
        writer = first._writer
        o.configure_decisions(directory=str(tmp_path / pkg / "b"))
        writer.join(timeout=10)
        return writer.is_alive(), o.decision_log() is not first

    out = each(run)
    assert out[PORT] == out[JAX] == (False, True)


# ---------------------------------------------------------------------------
# replay across packages
# ---------------------------------------------------------------------------


def _replay_tool(pkg):
    return mod("tools", "replay_decision") if pkg == JAX else mod(PORT, "obs.replay")


def _persist(pkg, directory, corrupt=False):
    pods = stuck_pods(pkg)
    nodes, ctx = solved_context(pkg, pods)
    if corrupt:
        ctx["assignment"] = ctx["assignment"].copy()
        ctx["assignment"][0] = 7
    log = dec(pkg).DecisionLog(directory=str(directory), write_interval=0.0)
    rec = log.record_round("default", pods, nodes, context=ctx)
    assert log.flush(10.0)
    log.close()
    return rec


@pytest.mark.parametrize("writer,reader", [(JAX, PORT), (PORT, JAX), (PORT, PORT)])
def test_replay_blob_replays_across_packages_bit_exact(tmp_path, writer, reader):
    if not (native_ready(JAX) and native_ready(PORT)):
        pytest.skip("native packer unavailable")
    rec = _persist(writer, tmp_path)
    rd = _replay_tool(reader)
    path = rd.find_record(str(tmp_path))
    assert path is not None
    verdict = rd.replay(rd.load_record(path), record_path=path)
    assert verdict["ok"] is True and verdict["diff"] is None
    assert verdict["decision_id"] == rec["id"]
    assert verdict["replay_unschedulable"] == 1
    assert rd.main(["--decision-dir", str(tmp_path)]) == 0


def test_replay_blobs_are_the_same_arrays(tmp_path):
    """A port-written and a reference-written blob of the same round hold
    the same arrays, name for name and byte for byte."""
    blobs = {}
    for pkg in BOTH:
        _persist(pkg, tmp_path / pkg)
        npz = next(n for n in os.listdir(tmp_path / pkg) if n.endswith(".npz"))
        with np.load(tmp_path / pkg / npz, allow_pickle=False) as z:
            blobs[pkg] = {k: (z[k].dtype.str, z[k].shape, z[k].tobytes()) for k in z.files}
    assert blobs[PORT] == blobs[JAX]
    assert set(blobs[PORT]) >= set(dec(PORT).PACK_ARG_NAMES) - {"pod_req"}


@pytest.mark.parametrize("writer,reader", [(JAX, PORT), (PORT, JAX)])
def test_replay_detects_a_divergent_assignment(tmp_path, writer, reader):
    if not (native_ready(JAX) and native_ready(PORT)):
        pytest.skip("native packer unavailable")
    _persist(writer, tmp_path, corrupt=True)
    rd = _replay_tool(reader)
    path = rd.find_record(str(tmp_path))
    verdict = rd.replay(rd.load_record(path), record_path=path)
    assert verdict["ok"] is False and "differs" in verdict["diff"]
    assert rd.main(["--decision-dir", str(tmp_path)]) == 1


def test_memory_only_record_is_not_replayable():
    for pkg in BOTH:
        with pytest.raises(ValueError):
            _replay_tool(pkg).replay({"id": "d-x"}, record_path="")
    assert _replay_tool(PORT).main(["--decision-dir", "/nonexistent-ring"]) == 2


# ---------------------------------------------------------------------------
# the Kubernetes loop
# ---------------------------------------------------------------------------


def _stuck_cluster(pkg, rounds, threshold):
    M = mods(pkg)
    cluster = M.Cluster()
    pods = stuck_pods(pkg)
    for p in pods:
        cluster.create("pods", p)
    log = dec(pkg).DecisionLog()
    for _ in range(rounds):
        nodes, ctx = solved_context(pkg, pods)
        log.record_round("default", pods, nodes, context=ctx)
        log.emit_unschedulable_events(cluster, threshold=threshold)
    return cluster, log, pods


def _events(cluster, keys):
    events = mod(type(cluster).__module__.split(".")[0], "kube.events")
    return sorted(
        (e.type, e.reason, e.involved_name, e.involved_namespace, e.count,
         norm(e.message, keys),
         e.metadata.annotations.get(events.DECISION_ID_ANNOTATION, "")[:2])
        for e in cluster.list("events")
    )


@pytest.mark.parametrize("rounds,threshold", [(2, 3), (3, 3), (5, 3)])
def test_pod_unschedulable_events_equal_the_reference(rounds, threshold):
    def run(pkg):
        cluster, log, pods = _stuck_cluster(pkg, rounds, threshold)
        return _events(cluster, keymap(pods))

    out = each(run)
    assert out[PORT] == out[JAX]
    events = out[PORT]
    if rounds < threshold:
        assert events == []
    else:
        (ev,) = events
        assert ev[:3] == ("Warning", "PodUnschedulable", "stuck-0")
        assert ev[4] == rounds - threshold + 1 and ev[6] == "d-"


def test_deleted_pod_stops_eventing_and_drops_from_tracker():
    def run(pkg):
        cluster, log, pods = _stuck_cluster(pkg, 3, 3)
        stuck = next(p for p in pods if p.metadata.name == "stuck-0")
        cluster.delete("pods", stuck.metadata.name, stuck.metadata.namespace)
        emitted = log.emit_unschedulable_events(cluster, threshold=3)
        return emitted, log.failure_streak(stuck.key)

    out = each(run)
    assert out[PORT] == out[JAX] == (0, 0)


def test_admission_failure_classified_and_emitted_at_threshold():
    def run(pkg):
        M = mods(pkg)
        cluster = M.Cluster()
        pod = M.factories.make_pod(name="intolerant", requests={"cpu": "1"})
        cluster.create("pods", pod)
        log = dec(pkg).DecisionLog()
        verdicts = [
            log.note_admission_failure(pod, ["did not tolerate taint dedicated=team"],
                                       provisioner="default")
            for _ in range(3)
        ]
        other = log.note_admission_failure(
            M.factories.make_pod(name="picky"), ["incompatible requirements"])
        emitted = log.emit_unschedulable_events(cluster, threshold=3)
        return verdicts[-1], other["top_reason"], emitted, _events(cluster, {})

    out = each(run)
    assert out[PORT] == out[JAX]
    verdict, other, emitted, events = out[PORT]
    assert verdict["top_reason"] == "taint" and other == "requirement"
    assert emitted == 1 and events[0][2] == "intolerant"
