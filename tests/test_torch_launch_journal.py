"""The port's launch journal, recovery ladder, garbage collector and crash
chaos against the JAX package's.

The reference's ``tests/test_launch_journal.py`` classes
``TestJournalBackends``, ``TestIdempotentCreateFake``,
``TestIdempotentCreateSimulated``, ``TestIdempotentCreateMetered``,
``TestRecoveryLadder``, ``TestGarbageCollectionController`` (without its
``ownership`` case: the port has no shard manager yet) and
``TestLaunchCrashChaos`` run on both packages, the ladder, collector and
crash cases over ``FakeCloudProvider`` and again over
``SimulatedCloudProvider`` (the reference's HTTP wire to the simulated
cloud is not ported), each result compared exactly under
``torch_parity.canon``: journal documents,
every ladder outcome (``SPECULATION_EXPIRED`` included;
``CONSOLIDATION_REPLAYED`` in ``tests/test_torch_consolidation.py``) with
what it left in the cluster, the journal and the cloud, the adopted Node's
wire form, and the collector's counters (a replayed wave too). A
``FileLaunchJournal`` file written by either package reads back
identically through the other, and ``KubeLaunchJournal``'s Lease objects
are the same wire documents in both. The crash scenarios run threaded
under a Manager in both packages.
"""

import tempfile
import threading
import time

import pytest

from torch_parity import (  # noqa: F401
    PACKAGES, both_canon, deprov, fresh_router, stop, wire_all, wire_doc,
)
from torch_parity import journal_docs as docs


def journal_of(M, kind, tmp_path, clock=lambda: 0.0):
    J = M.launch
    if kind == "memory":
        return J.MemoryLaunchJournal(clock=clock)
    if kind == "file":
        return J.FileLaunchJournal(str(tmp_path / f"{M.pkg}.json"), clock=clock)
    return J.KubeLaunchJournal(M.Cluster(clock=clock), namespace="kube-system")


# -- TestJournalBackends -----------------------------------------------------


@pytest.mark.parametrize("kind", ["memory", "file", "kube"])
def test_intent_created_resolve_lifecycle(kind, tmp_path):
    def run(M):
        j = journal_of(M, kind, tmp_path)
        j.record_intent("tok-1", "prov-a", trace="00-aa-bb-01")
        intent = j.get("tok-1").to_doc()
        j.mark_created("tok-1", "node-1")
        created = j.get("tok-1").to_doc()
        j.resolve("tok-1")
        return intent, created, j.get("tok-1"), docs(j)

    intent, created, gone, left = both_canon(run)
    assert (intent["state"], intent["provisioner"], intent["trace"]) == ("intent", "prov-a",
                                                                         "00-aa-bb-01")
    assert (created["state"], created["node_name"]) == ("created", "node-1")
    assert gone is None and left == []


@pytest.mark.parametrize("kind", ["memory", "file", "kube"])
def test_resolve_unknown_and_unresolved(kind, tmp_path):
    def run(M):
        j = journal_of(M, kind, tmp_path)
        j.resolve("never-recorded")
        j.mark_created("never-recorded", "node-x")
        missing = j.get("never-recorded")
        j.record_intent("a", "p1")
        j.record_intent("b", "p2", speculative=True)
        j.record_intent("c", "p3", marker="consolidation", victims=["v1", "v2"], decision_id="d")
        j.mark_created("b", "node-b")
        return missing, docs(j)

    missing, left = both_canon(run)
    assert missing is None and [d["token"] for d in left] == ["a", "b", "c"]


def test_file_journal_survives_process_death(tmp_path):
    def run(M):
        path = str(tmp_path / f"{M.pkg}.json")
        dying = M.launch.FileLaunchJournal(path, clock=lambda: 5.0)
        dying.record_intent("orphan-tok", "prov-a", trace="t")
        dying.mark_created("orphan-tok", "node-1")
        del dying
        return docs(M.launch.FileLaunchJournal(path))

    (entry,) = both_canon(run)
    assert (entry["token"], entry["state"]) == ("orphan-tok", "created")


def test_file_journal_concurrent_writers_do_not_lose_entries(tmp_path):
    def run(M):
        path = str(tmp_path / f"{M.pkg}.json")

        def write(start):
            j = M.launch.FileLaunchJournal(path, clock=lambda: 0.0)
            for i in range(start, start + 20):
                j.record_intent(f"tok-{i:02d}", "p")

        threads = [threading.Thread(target=write, args=(s,)) for s in (0, 20, 40)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return docs(M.launch.FileLaunchJournal(path))

    assert len(both_canon(run)) == 60


@pytest.mark.parametrize("writer", PACKAGES)
def test_file_journal_reads_back_through_the_other_package(writer, tmp_path):
    """A file one package writes is the same bytes the other writes for
    the same calls, and reads back identically through either."""
    path = {pkg: str(tmp_path / f"{pkg}.json") for pkg in PACKAGES}
    for pkg in PACKAGES:
        j = deprov(pkg).launch.FileLaunchJournal(path[pkg], clock=lambda: 7.5)
        j.record_intent("t1", "prov-a", trace="00-aa-bb-01")
        j.record_intent("t2", "prov-b", speculative=True)
        j.record_intent("t3", "prov-a", marker="consolidation", victims=["n1"], decision_id="d1")
        j.mark_created("t1", "node-1")
    raw = {pkg: open(path[pkg]).read() for pkg in PACKAGES}
    assert raw[PACKAGES[0]] == raw[PACKAGES[1]]
    read = [docs(deprov(pkg).launch.FileLaunchJournal(path[writer])) for pkg in PACKAGES]
    assert read[0] == read[1] and len(read[0]) == 3


def test_kube_journal_peer_visibility_and_lease_cleanup():
    def run(M):
        cluster = M.Cluster(clock=lambda: 3.0)
        writer = M.launch.KubeLaunchJournal(cluster)
        reader = M.launch.KubeLaunchJournal(cluster)
        writer.record_intent("tok-1", "prov-a", trace="00-aa-bb-01")
        writer.mark_created("tok-1", "node-1")
        leases = [wire_doc(M, "leases", lease) for lease in cluster.list("leases")]
        seen = [e.token for e in reader.unresolved()]
        reader.resolve("tok-1")
        return leases, seen, docs(writer), cluster.list("leases", namespace="kube-system")

    leases, seen, left, remaining = both_canon(run)
    assert seen == ["tok-1"] and left == [] and remaining == []
    assert leases[0]["metadata"]["name"] == "karpenter-launch-tok-1"


def test_build_journal_spec_grammar(tmp_path):
    def run(M):
        J = M.launch
        kj = J.build_journal("kube:karpenter/launch", cluster=M.Cluster())
        return (J.build_journal("") is None,
                type(J.build_journal("memory:")).__name__,
                type(J.build_journal(str(tmp_path / "j.json"))).__name__,
                type(kj).__name__, kj.namespace, kj.prefix,
                type(J.build_journal("kube:other", cluster=M.Cluster())).__name__)

    assert both_canon(run) == (True, "MemoryLaunchJournal", "FileLaunchJournal",
                               "KubeLaunchJournal", "karpenter", "launch", "KubeLaunchJournal")


# -- TestIdempotentCreateFake ------------------------------------------------


def cloud(M, kind: str):
    """``fake``: FakeCloudProvider(instance_types(5)); ``sim``: the
    simulated cloud over a fresh SimCloudAPI (instance ids from its own
    counter, so they compare as they are)."""
    if kind == "fake":
        return M.fake.FakeCloudProvider(M.fake.instance_types(5))
    return M.sim.SimulatedCloudProvider(M.sim.SimCloudAPI())


def deleted(provider) -> list:
    """The fake cloud's delete calls, or the simulated cloud's terminated
    instances."""
    if hasattr(provider, "delete_calls"):
        return list(provider.delete_calls)
    return sorted(i.id for i in provider.api.instances.values() if i.state == "terminated")


def launch(M, provider, token=""):
    """One create through ``provider`` with the catalog's constraints."""
    c = M.f.make_provisioner(name="prov-a").spec.constraints
    catalog = provider.get_instance_types()
    c.requirements = c.requirements.merge(M.catreq.catalog_requirements(catalog))
    return provider.create(M.ctypes.NodeRequest(template=c, instance_type_options=catalog,
                                                launch_token=token))


def instances(provider) -> list:
    return sorted((i.id, i.launch_token, i.instance_type, i.zone, i.capacity_type, i.provider_id)
                  for i in provider.list_instances())


@pytest.mark.parametrize("case", ["same token", "tokenless", "delete releases token"])
def test_idempotent_create_fake(case):
    def run(M):
        p = M.fake.FakeCloudProvider()
        token = "" if case == "tokenless" else "tok-x"
        n1 = launch(M, p, token)
        if case == "delete releases token":
            p.delete(n1)
            gone = instances(p)
            return gone, n1.metadata.name == launch(M, p, token).metadata.name, instances(p)
        n2 = launch(M, p, token)
        return wire_doc(M, "nodes", n1), n1.metadata.name == n2.metadata.name, instances(p)

    first, same, live = both_canon(run)
    assert same == (case == "same token")
    assert len(live) == (2 if case == "tokenless" else 1)
    if case == "delete releases token":
        assert first == []


@pytest.mark.parametrize("case", ["same token", "tokens listed", "terminate releases token"])
def test_idempotent_create_simulated(case):
    """The simulated cloud's client-token ledger: a retried create replays
    the committed instance, the live inventory carries each token, a
    terminated instance's token launches fresh."""
    def run(M):
        p = cloud(M, "sim")
        if case == "tokens listed":
            launch(M, p, "tok-a")
            launch(M, p, "tok-b")
            return instances(p), all(i.created_at > 0 for i in p.list_instances())
        n1 = launch(M, p, "tok-sim")
        if case == "terminate releases token":
            p.api.terminate_instances([n1.metadata.name])
        n2 = launch(M, p, "tok-sim")
        return (wire_doc(M, "nodes", n1), n1.metadata.name == n2.metadata.name, instances(p),
                n1.metadata.annotations[M.lbl.LAUNCH_TOKEN_ANNOTATION])

    out = both_canon(run)
    if case == "tokens listed":
        assert [i[1] for i in out[0]] == ["tok-a", "tok-b"] and out[1]
    else:
        assert out[1] == (case == "same token") and out[3] == "tok-sim"
        assert len(out[2]) == 1  # a terminated instance leaves the inventory


@pytest.mark.parametrize("case", ["retry after committed failure", "stamps token",
                                  "list passes through"])
def test_idempotent_create_metered(case):
    """The metered provider over the simulated cloud: its retry of a
    create whose answer was lost after the commit replays the token (one
    instance); a direct caller's request gets a token stamped; the
    inventory passes through."""
    def run(M):
        inner = cloud(M, "sim")
        metered = M.cpm.decorate(inner)
        if case == "retry after committed failure":
            real, armed = inner.create, [True]

            def commit_then_die(request):
                node = real(request)
                if armed and armed.pop():
                    raise ConnectionError("response lost after commit")
                return node

            inner.create = commit_then_die
        token = "" if case == "stamps token" else "tok-retry"
        c = M.f.make_provisioner(name="prov-a").spec.constraints
        catalog = inner.get_instance_types()
        c.requirements = c.requirements.merge(M.catreq.catalog_requirements(catalog))
        node = metered.create(M.ctypes.NodeRequest(template=c, instance_type_options=catalog,
                                                   launch_token=token))
        return (bool(node.metadata.annotations.get(M.lbl.LAUNCH_TOKEN_ANNOTATION)),
                [(i.id, bool(i.launch_token)) for i in metered.list_instances()],
                [(i.id, i.launch_token) for i in inner.list_instances()] if token else None)

    stamped, listed, tokens = both_canon(run)
    assert stamped and len(listed) == 1 and listed[0][1]


# -- TestRecoveryLadder --------------------------------------------------------

LADDER = {  # case: (speculative, instance, node, now, expected outcome)
    "never_launched": (False, False, False, 1000.0, "never_launched"),
    "young_pending": (False, True, False, 10.0, "pending"),
    "orphan_adopted": (False, True, False, 1000.0, "adopted"),
    "orphan_of_deleted_provisioner": (False, True, False, 1000.0, "adopted"),
    "node_exists": (False, True, True, 1000.0, "node_exists"),
    "speculative_claimed": (True, True, "claimed", 1000.0, "node_exists"),
    "speculative_standing": (True, True, "warm", 100.0, "pending"),
    "speculative_expired": (True, True, "warm", 1000.0, "speculation_expired"),
    "speculative_untracked_expired": (True, True, False, 1000.0, "speculation_expired"),
    "speculative_adopted_back": (True, True, False, 100.0, "adopted"),
}


@pytest.mark.parametrize("case", list(LADDER))
def test_recovery_ladder(case):
    """One entry through both packages' ``replay_entry`` with the same live
    instance: the outcome, the journal left, the cluster's Nodes (wire
    forms, the adopted one included) and the cloud's instances."""
    ladder_case(case, "fake")


@pytest.mark.parametrize("case", list(LADDER))
def test_recovery_ladder_simulated(case):
    """``test_recovery_ladder`` over the simulated cloud."""
    ladder_case(case, "sim")


def ladder_case(case, kind):
    speculative, has_instance, node_state, now, want = LADDER[case]

    def run(M):
        cluster = M.Cluster(clock=lambda: 1000.0)
        cluster.create("provisioners", M.f.make_provisioner(name="prov-a"))
        provider = cloud(M, kind)
        journal = M.launch.MemoryLaunchJournal(clock=lambda: 0.0)
        prov = "gone" if case == "orphan_of_deleted_provisioner" else "prov-a"
        journal.record_intent("tok", prov, trace="00-aa-bb-01", speculative=speculative)
        if has_instance:
            node = launch(M, provider, "tok")
            node.metadata.labels[M.lbl.PROVISIONER_NAME_LABEL] = "prov-a"
            node.metadata.finalizers = [M.lbl.TERMINATION_FINALIZER]
            if node_state == "warm":
                node.metadata.annotations[M.lbl.WARM_POOL_ANNOTATION] = "true"
            if node_state:
                cluster.create("nodes", node)
                journal.mark_created("tok", node.metadata.name)
        by_token = {i.launch_token: i for i in provider.list_instances() if i.launch_token}
        outcome = M.recovery.replay_entry(journal, cluster, provider, journal.get("tok"),
                                          by_token, now=now, replay_after=60.0)
        return (outcome, docs(journal), [wire_doc(M, "nodes", n) for n in cluster.nodes()],
                instances(provider), deleted(provider))

    outcome, left, nodes, live, deletes = both_canon(run)
    assert outcome == want
    if outcome == "adopted":
        (node,) = nodes
        assert node["metadata"]["annotations"]["karpenter.sh/adopted"] == "true"
        assert "karpenter.sh/termination" in node["metadata"]["finalizers"]
        assert node["status"]["capacity"]
        assert (left != []) == speculative  # a warm orphan's entry stays open
    if outcome == "speculation_expired":
        assert live == [] and nodes == [] and left == [] and deletes
    if outcome == "pending":
        assert len(left) == 1


def test_adopted_node_equals_the_reference_node_for_instance():
    """``node_for_instance`` over the same live instance and provisioner:
    the same Node wire form, speculative or not, with and without a
    provisioner."""
    def run(M):
        cluster = M.Cluster()
        cluster.create("provisioners", M.f.make_provisioner(
            name="prov-a", taints=[M.O.Taint(key="dedicated", value="x", effect="NoSchedule")]))
        provider = M.fake.FakeCloudProvider(M.fake.instance_types(5))
        launch(M, provider, "tok")
        (live,) = provider.list_instances()
        return [wire_doc(M, "nodes", M.recovery.node_for_instance(
            cluster, provider, live, provisioner_name=name, trace="00-aa-bb-01", speculative=spec))
            for name in ("prov-a", "") for spec in (False, True)]

    nodes = both_canon(run)
    assert nodes[0]["metadata"]["labels"]["karpenter.sh/provisioner-name"] == "prov-a"
    assert "karpenter.sh/warm-pool" in nodes[1]["metadata"]["annotations"]


# -- TestGarbageCollectionController -------------------------------------------


def gc_env(M, journal=None, grace=60.0, replay_after=0.0, kind="fake"):
    # the cluster's clock is far past every instance's creation: a fixed
    # clock keeps the wire timestamps equal between the packages
    cluster = M.Cluster(clock=lambda: 1e10)
    provider = cloud(M, kind)
    termination = M.term.TerminationController(cluster, provider, start_queue=False)
    gc = M.gc.GarbageCollectionController(
        cluster, provider, journal=journal, termination=termination, gc_interval=5.0,
        grace_period=grace, replay_after=replay_after)
    cluster.create("provisioners", M.f.make_provisioner(name="prov-a"))
    return cluster, provider, gc


def gc_view(M, cluster, provider, gc, journal=None):
    return {"adopted": gc.adopted, "leaks": gc.leaks_terminated, "replays": gc.replays,
            "sweeps": gc.sweeps, "journal": docs(journal) if journal is not None else None,
            "nodes": [wire_doc(M, "nodes", n) for n in cluster.nodes()],
            "instances": instances(provider), "deletes": deleted(provider),
            "events": sorted(e.reason for e in cluster.list("events"))}


GC_CASES = ["adopts journaled orphan", "reaps leak past grace", "young spared",
            "tracked untouched", "journaled not reaped while pending", "counters by outcome",
            "speculation reclaimed", "wave replayed"]


@pytest.mark.parametrize("case", GC_CASES)
def test_garbage_collection_sweep(case):
    """One or two sweeps of both packages' collector: what it adopted,
    reaped, replayed and left (counters, journal, Nodes, instances, cloud
    deletes, events), and the outcome counter's deltas."""
    gc_case(case, "fake")


@pytest.mark.parametrize("case", GC_CASES)
def test_garbage_collection_sweep_simulated(case):
    """``test_garbage_collection_sweep`` over the simulated cloud."""
    gc_case(case, "sim")


def gc_case(case, kind):
    def run(M):
        # a journal clock far ahead of the cluster's keeps an entry young
        young = case == "journaled not reaped while pending"
        journal = M.launch.MemoryLaunchJournal(clock=lambda: 1e12 if young else 0.0)
        grace = 0.0 if case in ("reaps leak past grace", "tracked untouched",
                                "journaled not reaped while pending") else 60.0
        replay_after = 3600.0 if young else 0.0
        cluster, provider, gc = gc_env(M, journal=journal, grace=grace, replay_after=replay_after,
                                       kind=kind)
        gc.warm_pool_ttl = 0.0
        key = M.gc.GC_POLL_KEY
        if case == "adopts journaled orphan":
            journal.record_intent("tok-1", "prov-a")
            launch(M, provider, "tok-1")
        elif case in ("reaps leak past grace", "young spared"):
            if case == "young spared":
                gc.grace_period = 1e11
            launch(M, provider)
        elif case == "tracked untouched":
            cluster.create("nodes", launch(M, provider, "tok-live"))
        elif case == "journaled not reaped while pending":
            journal.record_intent("tok-wait", "prov-a")
            launch(M, provider, "tok-wait")
        elif case == "counters by outcome":
            journal.record_intent("ghost", "prov-a")
            journal.record_intent("tok-live", "prov-a")
            cluster.create("nodes", launch(M, provider, "tok-live"))
        elif case == "speculation reclaimed":
            journal.record_intent("tok-warm", "prov-a", speculative=True)
            node = launch(M, provider, "tok-warm")
            node.metadata.annotations[M.lbl.WARM_POOL_ANNOTATION] = "true"
            cluster.create("nodes", node)
        else:
            cluster.create("nodes", M.f.make_node(name="victim-0", provisioner_name="prov-a"))
            cluster.get("nodes", "victim-0", namespace="").spec.unschedulable = True
            journal.record_intent("consolidation-1", "prov-a", marker="consolidation",
                                  victims=["victim-0"], decision_id="d-1")
        replays = M.metrics.LAUNCH_JOURNAL_REPLAYS
        outcomes = ("adopted", "node_exists", "never_launched", "speculation_expired",
                    "consolidation_replayed")
        before = [replays.labels(outcome=o)._value.get() for o in outcomes]
        requeue = gc.reconcile(key)
        gc.reconcile(key)
        after = [replays.labels(outcome=o)._value.get() for o in outcomes]
        return (requeue, gc_view(M, cluster, provider, gc, journal),
                [a - b for a, b in zip(after, before)], gc.consolidation_waves_replayed,
                gc.speculation_reclaimed)

    requeue, view, deltas, waves, reclaimed = both_canon(run)
    assert requeue == 5.0 and view["sweeps"] == 2
    want = {"adopts journaled orphan": (1, 0, 1), "reaps leak past grace": (0, 1, 0),
            "young spared": (0, 0, 0), "tracked untouched": (0, 0, 0),
            "journaled not reaped while pending": (0, 0, 0), "counters by outcome": (0, 0, 2),
            "speculation reclaimed": (0, 0, 1), "wave replayed": (0, 0, 1)}[case]
    assert (view["adopted"], view["leaks"], view["replays"]) == want
    assert sum(deltas) == want[2] and (waves, reclaimed) == (
        int(case == "wave replayed"), int(case == "speculation reclaimed"))
    if case in ("reaps leak past grace", "speculation reclaimed"):
        assert view["instances"] == []
    if case in ("young spared", "journaled not reaped while pending"):
        assert len(view["instances"]) == 1


def test_provider_without_list_surface_opts_out():
    def run(M):
        class NoList:
            def list_instances(self):
                return NotImplemented

            def name(self):
                return "nolist"

        gc = M.gc.GarbageCollectionController(M.Cluster(), NoList())
        return gc.reconcile(M.gc.GC_POLL_KEY), gc.gc_interval, gc.sweeps, gc.replay_after

    requeue, interval, sweeps, replay_after = both_canon(run)
    assert (requeue, sweeps, replay_after) == (interval, 1, 120.0)


# -- TestLaunchCrashChaos ------------------------------------------------------


def test_crash_proxy_is_one_shot_and_observable():
    def run(M):
        cluster = M.Cluster()
        proxy = M.chaos.LaunchCrashCluster(cluster)
        with pytest.raises(ValueError):
            proxy.arm("mid_nowhere")
        proxy.arm("before_node_write")
        with pytest.raises(M.chaos.LaunchCrash):
            proxy.create("nodes", M.f.make_node(name="n-1"))
        fired = (proxy.crashed.is_set(), dict(proxy.crashes), dict(proxy.crash_nodes),
                 cluster.try_get("nodes", "n-1", namespace="") is None)
        proxy.create("nodes", M.f.make_node(name="n-2"))
        proxy.arm("after_node_write")
        with pytest.raises(M.chaos.LaunchCrash):
            proxy.create("nodes", M.f.make_node(name="n-3"))
        return fired, sorted(n.metadata.name for n in cluster.nodes()), dict(proxy.crashes)

    fired, nodes, crashes = both_canon(run)
    assert fired == (True, {"before_node_write": 1}, {"before_node_write": "n-1"}, True)
    assert nodes == ["n-2", "n-3"]
    assert crashes == {"before_node_write": 1, "after_node_write": 1}


def crash_runtime(M, cluster, provider, journal_path, replay_after):
    w = wire_all(M, cluster, provider, journal=M.launch.FileLaunchJournal(journal_path),
                 gc={"gc_interval": 0.2, "grace_period": 3600.0, "replay_after": replay_after})
    return w


def wait(predicate, timeout):
    deadline = time.time() + timeout
    while time.time() < deadline and not predicate():
        time.sleep(0.02)
    return predicate()


@pytest.mark.parametrize("point", ["before_node_write", "after_node_write"])
def test_launch_crash_recovered_by_a_successor(point):
    """Replica 1 dies at ``point`` of its launch (its own collector never
    replays); replica 2 over the same cluster, journal file and cloud
    adopts the orphan (before the Node write) or resolves the entry (after
    it) within its sweep cadence, with no token launched twice; after the
    orphan's adoption the pod still gets capacity."""
    crash_case(point, "fake")


@pytest.mark.parametrize("point", ["before_node_write", "after_node_write"])
def test_launch_crash_recovered_by_a_successor_simulated(point):
    """``test_launch_crash_recovered_by_a_successor`` over the simulated
    cloud, as the reference's crash chaos runs it."""
    crash_case(point, "sim")


def crash_case(point, kind):
    def run(M):
        cluster = M.Cluster()
        provider = cloud(M, kind)
        path = tempfile.mktemp(prefix="karpenter-journal-")
        proxy = M.chaos.LaunchCrashCluster(cluster)
        rt1 = crash_runtime(M, proxy, provider, path, replay_after=3600.0)
        rt1.manager.start()
        try:
            cluster.create("provisioners", M.f.make_provisioner(name="prov-a"))
            assert wait(lambda: "prov-a" in rt1.provisioning.workers, 10)
            rt1.provisioning.workers["prov-a"].batcher.idle_duration = 0.05
            proxy.arm(point)
            cluster.create("pods", M.f.make_pod(name="victim", requests={"cpu": "0.5"}))
            assert proxy.crashed.wait(timeout=30), "crash never fired"
        finally:
            stop(rt1)
        wreck = (len(provider.list_instances()), len(cluster.nodes()),
                 [d["state"] for d in docs(M.launch.FileLaunchJournal(path))])
        rt2 = crash_runtime(M, cluster, provider, path, replay_after=0.2)
        rt2.manager.start()
        try:
            # the provisioner and the pod predate rt2's watches (an
            # informer's relist would deliver them): nudge both
            rt2.manager.enqueue("provisioning", "prov-a")
            rt2.manager.enqueue("selection", ("victim", "default"))
            gc = rt2.garbage_collection
            assert wait(lambda: not M.launch.FileLaunchJournal(path).unresolved()
                        and (gc.adopted >= 1 or point == "after_node_write"), 30)
            crash_node = proxy.crash_nodes[point]
            adopted = cluster.try_get("nodes", crash_node, namespace="")
            # a launch binds its pods before it resolves its journal entry
            # (mark_created, bind, resolve): when the victim got a fresh
            # launch rather than the adopted node, the journal is read once
            # that launch has resolved too, never between its bind and
            # its resolve
            assert wait(lambda: cluster.get("pods", "victim").spec.node_name
                        and not M.launch.FileLaunchJournal(path).unresolved(), 30)
            tokens = [i.launch_token for i in provider.list_instances() if i.launch_token]
            return (wreck, gc.adopted, gc.leaks_terminated,
                    adopted.metadata.annotations.get("karpenter.sh/adopted"),
                    len(tokens) == len(set(tokens)), docs(M.launch.FileLaunchJournal(path)))
        finally:
            stop(rt2)

    wreck, adopted, leaks, mark, unique, left = both_canon(run)
    before = point == "before_node_write"
    assert wreck == (1, 0 if before else 1, ["intent"])
    assert (adopted, leaks, mark, unique, left) == (
        int(before), 0, "true" if before else None, True, [])
