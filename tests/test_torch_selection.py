"""The port's selection controller against the JAX package's: pod →
provisioner routing, ``Preferences.relax`` sequences, ``VolumeTopology``
injection, the ``validate`` gate, and ``NoProvisionerMatched`` with the
decision log's admission-failure record and ``maybe_emit_for``.

The reference's ``tests/test_selection.py`` cases run on both packages
(the port's controllers on ``device="cpu"``); relaxation sequences and
admission records are compared between the two directly.
"""

import copy
import importlib
from types import SimpleNamespace

import pytest

from torch_parity import PACKAGES, fresh_router  # noqa: F401

PORT = "karpenter_tpu_torch"


def mods(pkg):
    def m(name):
        return importlib.import_module(f"{pkg}.{name}")

    return SimpleNamespace(
        pkg=pkg, Cluster=m("kube.client").Cluster, fake=m("cloudprovider.fake"),
        prov=m("controllers.provisioning"), sel=m("controllers.selection"),
        f=m("testing.factories"), O=m("api.objects"), lbl=m("api.labels"),
        obs=m("obs"), dec=m("obs.decisions"),
    )


@pytest.fixture(autouse=True)
def fresh_obs():
    for pkg in PACKAGES:
        M = mods(pkg)
        M.obs.reset_for_tests()
        M.dec.set_enabled(True)
    yield
    for pkg in PACKAGES:
        mods(pkg).obs.reset_for_tests()


@pytest.fixture(params=PACKAGES)
def M(request):
    return mods(request.param)


def make_env(M):
    cluster = M.Cluster()
    kw = {"device": "cpu"} if M.pkg == PORT else {}
    provisioning = M.prov.ProvisioningController(
        cluster, M.fake.FakeCloudProvider(M.fake.instance_types(10)), start_workers=False, **kw)
    selection = M.sel.SelectionController(cluster, provisioning, wait=False)
    return cluster, provisioning, selection


@pytest.fixture()
def env(M):
    cluster, provisioning, selection = make_env(M)
    yield M, cluster, provisioning, selection
    provisioning.stop()


def drive(cluster, provisioning, selection, pod):
    """Reconcile the pod through selection, then run the chosen worker's
    provision loop synchronously (the ExpectProvisioned analog)."""
    cluster.create("pods", pod)
    result = selection.reconcile(pod.metadata.name, pod.metadata.namespace)
    for worker in provisioning.list_workers():
        worker.batcher.idle_duration = 0.01
        if worker.batcher.depth():
            worker.provision_once()
    return result


def zone_req(M, zone, op="In"):
    return M.O.NodeSelectorRequirement(key=M.lbl.TOPOLOGY_ZONE, operator=op, values=[zone])


def preferred(M, zone, weight):
    return M.O.PreferredSchedulingTerm(
        weight=weight, preference=M.O.NodeSelectorTerm(match_expressions=[zone_req(M, zone)]))


# -- routing ------------------------------------------------------------------


def test_routes_to_matching_provisioner(env):
    M, cluster, provisioning, selection = env
    provisioning.apply(M.f.make_provisioner(name="default"))
    pod = M.f.make_pod(requests={"cpu": "1"})
    assert drive(cluster, provisioning, selection, pod) == M.sel.REQUEUE_AFTER == 5.0
    assert pod.spec.node_name != ""


def test_provisioners_tried_in_name_order(env):
    M, cluster, provisioning, selection = env
    provisioning.apply(M.f.make_provisioner(name="a", taints=[M.O.Taint(key="dedicated", value="x")]))
    provisioning.apply(M.f.make_provisioner(name="b"))
    pod = M.f.make_pod(requests={"cpu": "1"})
    drive(cluster, provisioning, selection, pod)
    node = cluster.get("nodes", pod.spec.node_name, namespace="")
    assert node.metadata.labels[M.lbl.PROVISIONER_NAME_LABEL] == "b"


def test_no_workers_is_a_noop(env):
    M, cluster, _, selection = env
    pod = M.f.make_pod(requests={"cpu": "1"})
    cluster.create("pods", pod)
    assert selection.reconcile(pod.metadata.name) == 5.0
    assert pod.spec.node_name == ""


def test_scheduled_and_missing_pods_ignored(env):
    M, cluster, provisioning, selection = env
    provisioning.apply(M.f.make_provisioner())
    pod = M.f.make_pod(node_name="n1", unschedulable=False)
    assert drive(cluster, provisioning, selection, pod) is None
    assert selection.reconcile("nope") is None


def test_pending_pod_is_not_relaxed_or_enqueued_twice(env):
    M, cluster, provisioning, selection = env
    provisioning.apply(M.f.make_provisioner())
    pod = M.f.make_pod(requests={"cpu": "1"}, node_preferences=[preferred(M, "test-zone-1", 1)])
    cluster.create("pods", pod)
    for _ in range(3):
        assert selection.reconcile(pod.metadata.name) == 5.0
    worker = provisioning.workers["default"]
    assert worker.batcher.depth() == 1 and worker.is_pending(pod.key)
    assert pod.spec.affinity.node_affinity.preferred  # never relaxed while pending


def test_unsupported_pods_are_ignored(env):
    M, cluster, provisioning, selection = env
    provisioning.apply(M.f.make_provisioner())
    pod = M.f.make_pod(topology=[M.O.TopologySpreadConstraint(topology_key="rack", max_skew=1)])
    cluster.create("pods", pod)
    assert selection.reconcile(pod.metadata.name) is None
    assert provisioning.workers["default"].batcher.depth() == 0


def test_alphabetical_priority_and_prefer_no_schedule(M):
    cluster, provisioning, selection = make_env(M)
    for name, taints in (("zeta", None), ("alpha", None),
                         ("aaa-soft", [M.O.Taint(key="soft", value="x", effect="PreferNoSchedule")])):
        prov = M.f.make_provisioner(name=name, taints=taints)
        cluster.create("provisioners", prov)
        provisioning.reconcile(name)
    pod = M.f.make_pod(requests={"cpu": "0.5"})
    cluster.create("pods", pod)
    assert selection.select_provisioner(pod) is True
    pending = sorted(n for n, w in provisioning.workers.items() if w.is_pending(pod.key))
    provisioning.stop()
    assert pending == ["alpha"]


# -- the supportability gate -------------------------------------------------


def validate_cases(M):
    O = M.O
    return [
        M.f.make_pod(topology=[O.TopologySpreadConstraint(topology_key="custom/key", max_skew=1)]),
        M.f.make_pod(pod_requirements=[O.PodAffinityTerm(topology_key=M.lbl.TOPOLOGY_ZONE)]),
        M.f.make_pod(pod_anti_requirements=[O.PodAffinityTerm(topology_key=M.lbl.HOSTNAME)]),
        M.f.make_pod(pod_requirements=[O.PodAffinityTerm(topology_key="rack")]),
        M.f.make_pod(node_requirements=[zone_req(M, "1", op="Gt")]),
        M.f.make_pod(node_preferences=[M.O.PreferredSchedulingTerm(
            weight=1, preference=O.NodeSelectorTerm(match_expressions=[zone_req(M, "1", op="Lt")]))]),
        M.f.make_pod(topology=[M.f.zone_spread()], node_requirements=[zone_req(M, "test-zone-1")]),
    ]


def test_validate_equals_the_reference():
    results = []
    for pkg in PACKAGES:
        M = mods(pkg)
        results.append([(M.sel.validate(p), M.sel.validate(p, allow_pod_affinity=True))
                        for p in validate_cases(M)])
    assert results[0] == results[1]
    out = results[1]
    assert out[0][0] and out[0][1]          # unsupported spread key
    assert out[1][0] and not out[1][1]      # required affinity needs the flag
    assert out[2][0] and not out[2][1]
    assert out[3][1]                        # a bad affinity key fails even with it
    assert out[4][0] and out[5][0]          # Gt / Lt operators
    assert out[6] == ([], [])


# -- preference relaxation ----------------------------------------------------


def relax_trace(pkg):
    """Every rung of the ladder, in order, on one pod: the state after each
    relax call."""
    M = mods(pkg)
    O = M.O
    now = [0.0]
    prefs = M.sel.Preferences(clock=lambda: now[0])
    sel = O.LabelSelector(match_labels={"app": "x"})
    pod = M.f.make_pod(
        node_preferences=[preferred(M, "zone-1", 1), preferred(M, "zone-2", 10)],
        node_requirements=[zone_req(M, "zone-1")],
    )
    pod.spec.affinity.node_affinity.required.append(
        O.NodeSelectorTerm(match_expressions=[zone_req(M, "zone-2")]))
    pod.spec.affinity.pod_affinity = O.PodAffinity(preferred=[
        O.WeightedPodAffinityTerm(weight=w, pod_affinity_term=O.PodAffinityTerm(
            label_selector=sel, topology_key=M.lbl.TOPOLOGY_ZONE)) for w in (1, 5)])
    pod.spec.affinity.pod_anti_affinity = O.PodAntiAffinity(preferred=[
        O.WeightedPodAffinityTerm(weight=3, pod_affinity_term=O.PodAffinityTerm(
            label_selector=sel, topology_key=M.lbl.HOSTNAME))])

    def state():
        a = pod.spec.affinity
        return (
            [t.weight for t in a.pod_affinity.preferred],
            [t.weight for t in a.pod_anti_affinity.preferred],
            [t.weight for t in a.node_affinity.preferred],
            [[r.values for r in t.match_expressions] for t in a.node_affinity.required],
            [(t.operator, t.effect) for t in pod.spec.tolerations],
        )

    out = []
    for _ in range(9):
        prefs.relax(pod)
        out.append(state())
    now[0] = 301.0  # the cache expired: the next sighting is a first one
    prefs.relax(pod)
    out.append(state())
    return out


def test_relax_sequence_equals_the_reference():
    ref, port = (relax_trace(pkg) for pkg in PACKAGES)
    assert port == ref
    first = port[0]
    assert first == ([1, 5], [3], [1, 10], [[["zone-1"]], [["zone-2"]]], [])
    assert port[1][0] == [1]          # the heaviest preferred pod affinity term goes first
    assert port[2][0] == [] and port[2][1] == [3]
    assert port[3][1] == []
    assert port[4][2] == [1]          # then the heaviest preferred node term
    assert port[5][2] == []
    assert port[6][3] == [[["zone-2"]]]  # one required OR-term, never the last
    assert port[7][4] == [("Exists", "PreferNoSchedule")]
    assert port[8] == port[7]         # nothing left to relax
    assert port[9] == port[8]


def test_preferences_enable_scheduling_end_to_end(env):
    M, cluster, provisioning, selection = env
    provisioning.apply(M.f.make_provisioner(requirements=[zone_req(M, "test-zone-1")]))
    pod = M.f.make_pod(requests={"cpu": "1"}, node_preferences=[preferred(M, "no-such-zone", 1)])
    cluster.create("pods", pod)
    with pytest.raises(M.sel.NoProvisionerMatched):
        selection.reconcile(pod.metadata.name)
    assert pod.spec.node_name == ""
    selection.reconcile(pod.metadata.name)  # the retry relaxes and routes
    for worker in provisioning.list_workers():
        worker.batcher.idle_duration = 0.01
        worker.provision_once()
    assert pod.spec.node_name != ""


# -- volume topology -----------------------------------------------------------


def test_repeated_rounds_do_not_accumulate_injected_requirements(env):
    M, cluster, provisioning, selection = env
    cluster.create("pvs", M.f.make_pv(name="pv-x", zones=["test-zone-1"]))
    cluster.create("pvcs", M.f.make_pvc(name="claim-x", volume_name="pv-x"))
    pod = M.f.make_pod(requests={"cpu": "1"}, node_requirements=[zone_req(M, "test-zone-1")])
    pod.spec.volumes = [M.O.Volume(name="v", persistent_volume_claim="claim-x")]
    cluster.create("pods", pod)
    for _ in range(4):
        selection.preferences.relax(pod)
        selection.volume_topology.inject(pod)
    assert max(len(t.match_expressions) for t in pod.spec.affinity.node_affinity.required) <= 2


@pytest.mark.parametrize("source", ["pv", "storageclass", "missing"])
def test_volume_topology_injects_like_the_reference(source):
    outs = []
    for pkg in PACKAGES:
        M = mods(pkg)
        cluster, provisioning, selection = make_env(M)
        provisioning.apply(M.f.make_provisioner())
        if source == "pv":
            cluster.create("pvs", M.f.make_pv(name="pv-a", zones=["test-zone-2"]))
            cluster.create("pvcs", M.f.make_pvc(name="claim", volume_name="pv-a"))
        elif source == "storageclass":
            cluster.create("storageclasses", M.f.make_storage_class(name="fast", zones=["test-zone-3"]))
            cluster.create("pvcs", M.f.make_pvc(name="claim", storage_class="fast"))
        pod = M.f.make_pod(requests={"cpu": "1"})
        pod.spec.volumes = [M.O.Volume(name="data", persistent_volume_claim="claim")]
        drive(cluster, provisioning, selection, pod)
        node = cluster.get("nodes", pod.spec.node_name, namespace="")
        aff = pod.spec.affinity
        outs.append((node.metadata.labels[M.lbl.TOPOLOGY_ZONE] if source != "missing" else None,
                     None if aff is None else [[(r.key, r.operator, r.values) for r in t.match_expressions]
                                               for t in aff.node_affinity.required]))
        provisioning.stop()
    assert outs[0] == outs[1]
    assert outs[1][0] == {"pv": "test-zone-2", "storageclass": "test-zone-3", "missing": None}[source]


# -- no provisioner admits the pod: the decision plane's feed -------------------


def admission_trace(pkg):
    M = mods(pkg)
    cluster, provisioning, selection = make_env(M)
    provisioning.unschedulable_event_rounds = 2
    for name in ("a", "b"):
        provisioning.apply(M.f.make_provisioner(
            name=name, taints=[M.O.Taint(key="dedicated", value=name)]))
    pod = M.f.make_pod(name="stuck", requests={"cpu": "1"})
    cluster.create("pods", pod)
    log = M.obs.decision_log()
    out = []
    for _ in range(3):
        with pytest.raises(M.sel.NoProvisionerMatched) as err:
            selection.reconcile("stuck")
        events = [(e.reason, e.type, e.count, e.involved_name, e.message)
                  for e in cluster.list("events")]
        out.append((str(err.value), log.failure_streak(pod.key), events))
    # the per-pod emitter: due only at the streak threshold
    out.append((log.maybe_emit_for(cluster, pod.key, threshold=10),
                log.maybe_emit_for(cluster, pod.key, threshold=3),
                log.maybe_emit_for(cluster, "default/nobody", threshold=1)))
    out.append(sorted((e.reason, e.count) for e in cluster.list("events")))
    provisioning.stop()
    return out


def test_no_provisioner_matched_records_and_emits_like_the_reference():
    ref, port = (admission_trace(pkg) for pkg in PACKAGES)
    assert port == ref
    msg, streak, events = port[0]
    assert "matched 0/2 provisioners" in msg and "tried provisioner/a" in msg
    assert streak == 1 and events == []
    assert port[1][1] == 2 and [e[0] for e in port[1][2]] == ["PodUnschedulable"]
    assert port[2][1] == 3 and port[2][2][0][2] == 2  # the same event, bumped
    assert port[3] == (False, True, False)
    # the threshold is in the message: the threshold-3 emission is its own event
    assert port[4] == [("PodUnschedulable", 1), ("PodUnschedulable", 2)]


def test_admission_failure_with_decisions_disabled_records_nothing(M):
    M.dec.set_enabled(False)
    cluster, provisioning, selection = make_env(M)
    provisioning.apply(M.f.make_provisioner(taints=[M.O.Taint(key="dedicated", value="x")]))
    pod = M.f.make_pod(requests={"cpu": "1"})
    cluster.create("pods", pod)
    with pytest.raises(M.sel.NoProvisionerMatched):
        selection.reconcile(pod.metadata.name)
    assert M.obs.decision_log().failure_streak(pod.key) == 0
    provisioning.stop()


def test_relax_hands_out_copies(M):
    """The cached originals are never aliased to the pod: injection into
    the pod's affinity must not reach the cache."""
    prefs = M.sel.Preferences()
    pod = M.f.make_pod(node_requirements=[zone_req(M, "zone-1")])
    prefs.relax(pod)
    cached_before = copy.deepcopy(prefs.cache.get(pod.metadata.uid))
    pod.spec.affinity.node_affinity.required[0].match_expressions.append(zone_req(M, "zone-9"))
    assert prefs.cache.get(pod.metadata.uid) == cached_before
    prefs.relax(pod)
    assert len(pod.spec.affinity.node_affinity.required[0].match_expressions) == 1
