"""The port's API server client (``kube/apiserver.py``) and in-repo API
server (``kube/testserver.py``) against the JAX package's: the wire form,
the REST surface (create, update with optimistic concurrency, delete with
finalizers, the binding and eviction subresources, PDB percentages, the
flow limiter), the informers (watch across clients, resume from the last
resourceVersion, the default kinds, a stopped client), the status
subresource, and the store version the resident plan reuse keys on.

Mirrors ``tests/test_apiserver.py`` (``TestSerde``, ``TestRestSurface``,
``TestReviewRegressions``, ``TestStatusSubresource``). Each case runs the
same scenario through both packages, each package's client against its own
server, and compares exactly: the answers, the exceptions and the server's
store as wire documents.
"""

import time

from torch_parity import (PACKAGES, both_at_once, both_canon, fresh_router, kube,  # noqa: F401
                          kube_env, pinned, wire_doc)

PORT = "karpenter_tpu_torch"


def both(fn):
    return both_canon(fn, ns=kube)


def outcome(fn):
    try:
        fn()
        return None
    except Exception as e:  # noqa: BLE001
        return type(e).__name__


def wait(predicate, timeout=15.0):
    deadline = time.time() + timeout
    while time.time() < deadline and not predicate():
        time.sleep(0.02)
    return predicate()


def doc(M, kind, obj) -> dict:
    """``wire_doc`` with the wall-clock creation and deletion stamps
    replaced by their presence."""
    out = wire_doc(M, kind, obj)
    for key in ("creationTimestamp", "deletionTimestamp"):
        if key in out["metadata"]:
            out["metadata"][key] = "<set>"
    return out


def store(M, cluster, kind):
    """``kind``'s objects on ``cluster`` as wire documents (``doc``), by
    name."""
    return sorted((doc(M, kind, o) for o in cluster.list(kind)),
                  key=lambda d: d["metadata"]["name"])


# -- TestSerde -----------------------------------------------------------------------


def test_wire_is_kubernetes_shaped():
    def run(M):
        doc = M.serde.to_wire("pods", M.f.make_pod(name="p", requests={"cpu": "0.5",
                                                                   "memory": "512Mi"}))
        doc["metadata"].pop("uid", None)
        return doc

    doc = both(run)
    assert doc["apiVersion"] == "v1" and doc["kind"] == "Pod"
    requests = doc["spec"]["containers"][0]["resources"]["requests"]
    assert requests == {"cpu": "0.5", "memory": str(512 * 1024 * 1024)}


def test_provisioner_round_trip():
    import json

    def run(M):
        prov = M.f.make_provisioner(solver="tpu", limits={"cpu": "100"})
        doc = json.loads(json.dumps(M.serde.to_wire("provisioners", prov)))
        back = M.serde.from_wire("provisioners", doc)
        doc["metadata"].pop("uid", None)  # a per-package counter
        return (doc, back.spec.solver, back.spec.limits.resources["cpu"],
                back.metadata.namespace)

    doc, solver, cpu, namespace = both(run)
    assert doc["apiVersion"] == "karpenter.sh/v1alpha5"
    assert (solver, cpu, namespace) == ("tpu", 100.0, "")


def test_merge_patch_semantics():
    def run(M):
        return M.ts.merge_patch({"a": {"b": 1, "c": 2}, "keep": True},
                                {"a": {"b": 3, "c": None}, "new": "x"})

    assert both(run) == {"a": {"b": 3}, "keep": True, "new": "x"}


# -- TestRestSurface -----------------------------------------------------------------


def test_crud_and_conflict():
    def run(M):
        with kube_env(M) as env:
            c = env.connect()
            c.create("nodes", M.f.make_node(name="n1", capacity={"cpu": "4"}))
            dup = outcome(lambda: c.create("nodes", M.f.make_node(name="n1")))
            got = c.get("nodes", "n1", namespace="")
            got.metadata.labels["x"] = "y"
            c.update("nodes", got)
            after_update = store(M, env.cluster, "nodes")
            stale = M.serde.from_wire("nodes", M.serde.to_wire("nodes", got))
            stale.metadata.resource_version = 1
            conflict = outcome(lambda: c.update("nodes", stale))
            c.delete("nodes", "n1", namespace="")
            gone = outcome(lambda: env.cluster.get("nodes", "n1", namespace=""))
            return dup, after_update, conflict, gone, c.try_get("nodes", "n1", namespace="")

    dup, nodes, conflict, gone, cached = both(run)
    assert (dup, conflict, gone, cached) == ("Conflict", "Conflict", "NotFound", None)
    assert nodes[0]["metadata"]["labels"]["x"] == "y"


def test_watch_propagates_between_clients():
    def run(M):
        with kube_env(M) as env:
            a, b = env.connect(), env.connect()
            seen = []
            b.watch("pods", lambda e, o: seen.append((e, o.metadata.name)))
            a.create("pods", M.f.make_pod(name="w1", requests={"cpu": "1"}))
            arrived = wait(lambda: ("ADDED", "w1") in seen)
            return arrived, doc(M, "pods", b.get("pods", "w1"))

    arrived, pod = both(run)
    assert arrived and pod["metadata"]["name"] == "w1"


def test_bind_subresource():
    def run(M):
        with kube_env(M) as env:
            c = env.connect()
            pod = M.f.make_pod(name="p1", requests={"cpu": "1"})
            c.create("pods", pod)
            c.bind(pod, "some-node")
            return (env.cluster.get("pods", "p1").spec.node_name,
                    c.get("pods", "p1").spec.node_name, store(M, env.cluster, "pods"))

    server, cached, _ = both(run)
    assert server == cached == "some-node"


def test_evict_respects_pdb_with_429():
    def run(M):
        with kube_env(M) as env:
            c = env.connect()
            env.cluster.create("pdbs", M.O.PodDisruptionBudget(
                metadata=M.O.ObjectMeta(name="pdb"),
                selector=M.O.LabelSelector(match_labels={"app": "a"}), min_available=1))
            pod = M.f.make_pod(name="only", labels={"app": "a"}, requests={"cpu": "1"})
            c.create("pods", pod)
            first = c.evict(pod)
            env.cluster.create("pods", M.f.make_pod(name="second", labels={"app": "a"}))
            return first, c.evict(pod), [p["metadata"]["name"] for p in store(M, env.cluster, "pods")]

    assert both(run) == (False, True, ["second"])


def test_finalizer_aware_delete_and_patch():
    def run(M):
        with kube_env(M) as env:
            c = env.connect()
            node = M.f.make_node(name="fin")
            node.metadata.finalizers = [M.lbl.TERMINATION_FINALIZER]
            c.create("nodes", node)
            c.delete("nodes", "fin", namespace="")
            terminating = env.cluster.get("nodes", "fin", namespace="").metadata.deletion_timestamp
            obj = c.get("nodes", "fin", namespace="")
            c.remove_finalizer("nodes", obj, M.lbl.TERMINATION_FINALIZER)
            return (terminating is not None, env.cluster.try_get("nodes", "fin", namespace=""),
                    c.try_get("nodes", "fin", namespace=""))

    assert both(run) == (True, None, None)


def test_flow_control_throttles():
    def run(M):
        with kube_env(M) as env:
            c = env.connect(qps=20, burst=1)
            t0 = time.perf_counter()
            for i in range(5):
                c.create("pods", M.f.make_pod(name=f"q{i}", requests={"cpu": "1"}))
            return time.perf_counter() - t0 >= 4 / 20, len(env.cluster.pods())

    assert both_at_once(run) == (True, 5)


# -- TestReviewRegressions -----------------------------------------------------------


def test_pdb_percentage_thresholds():
    def run(M):
        with kube_env(M) as env:
            c = env.connect()
            env.cluster.create("pdbs", M.O.PodDisruptionBudget(
                metadata=M.O.ObjectMeta(name="pct"),
                selector=M.O.LabelSelector(match_labels={"app": "p"}), min_available="50%"))
            pods = [M.f.make_pod(name=f"pp{i}", labels={"app": "p"}) for i in range(4)]
            for p in pods:
                c.create("pods", p)
            return [c.evict(p) for p in pods]

    assert both(run) == [True, True, True, False]


def test_maxunavailable_percentage_rounds_up():
    def run(M):
        with kube_env(M) as env:
            c = env.connect()
            env.cluster.create("pdbs", M.O.PodDisruptionBudget(
                metadata=M.O.ObjectMeta(name="mu"),
                selector=M.O.LabelSelector(match_labels={"app": "m"}), max_unavailable="50%"))
            pods = [M.f.make_pod(name=f"mu{i}", labels={"app": "m"}) for i in range(3)]
            for p in pods:
                p.metadata.finalizers = ["test/hold"]
                c.create("pods", p)
            return [c.evict(p) for p in pods]

    assert both(run) == [True, True, False]


def test_watch_resumes_from_rv_without_relist(monkeypatch):
    """An idle stream's end (the server's timeoutSeconds) resumes from the
    last resourceVersion; later events still arrive and nothing re-lists."""
    def run(M):
        monkeypatch.setattr(M.api, "WATCH_TIMEOUT_SECONDS", 1)
        with kube_env(M) as env:
            c = env.connect()
            baseline = dict(c.relist_attempts)
            time.sleep(2.5)  # outlive at least two server-side stream timeouts
            env.cluster.create("pods", M.f.make_pod(name="after-resume"))
            arrived = wait(lambda: c.try_get("pods", "after-resume") is not None, 5.0)
            return arrived, dict(c.relist_attempts) == baseline, sorted(baseline)

    arrived, no_relist, kinds = both_at_once(run)
    assert arrived and no_relist and "pods" in kinds


def test_default_watch_kinds_exclude_leases():
    def run(M):
        with kube_env(M) as env:
            c = env.connect()
            return c._watch_kinds, list(M.client.Cluster.KINDS)

    watched, kinds = both(run)
    assert "leases" not in watched and set(watched) < set(kinds)


def test_kube_lease_requires_apiserver_cluster():
    def run(M):
        try:
            M.main.run_controller_process(M.options.Options(
                **({"device": "cpu"} if M.pkg == PORT else {}),
                leader_election_lease="kube:karpenter-leader-election"), serve=False)
        except ValueError as e:
            return str(e)
        finally:
            M.obs.reset_for_tests()

    assert "kube: leader election requires" in both(run)


def test_stopped_cluster_drops_late_events():
    def run(M):
        with kube_env(M) as env:
            c = env.connect()
            seen = []
            c.watch("pods", lambda e, o: seen.append(o.metadata.name))
            c.stop()
            env.cluster.create("pods", M.f.make_pod(name="late", requests={"cpu": "1"}))
            time.sleep(0.5)
            return "late" in seen

    assert both_at_once(run) is False


# -- TestStatusSubresource -----------------------------------------------------------


def test_main_resource_put_drops_status():
    def run(M):
        with kube_env(M) as env:
            c = env.connect()
            c.create("provisioners", M.f.make_provisioner())
            c.patch_status("provisioners", "default", {"resources": {"cpu": "4"}}, namespace="")
            live = c.get_live("provisioners", "default", namespace="")
            patched = dict(live.status.resources)
            live.status.resources = {}
            live.spec.solver = "tpu"
            c.update("provisioners", live)
            after = c.get_live("provisioners", "default", namespace="")
            return patched, after.spec.solver, after.status.resources, store(M, env.cluster,
                                                                          "provisioners")

    patched, solver, status, _ = both(run)
    assert patched == status == {"cpu": 4.0} and solver == "tpu"


def test_main_resource_patch_drops_status():
    def run(M):
        with kube_env(M) as env:
            c = env.connect()
            c.create("provisioners", M.f.make_provisioner())
            c.merge_patch("provisioners", "default",
                          {"spec": {"solver": "tpu"}, "status": {"resources": {"cpu": "9"}}},
                          namespace="")
            after = c.get_live("provisioners", "default", namespace="")
            return after.spec.solver, after.status.resources

    assert both(run) == ("tpu", {})


def test_active_condition_lands_over_the_wire():
    def run(M):
        with kube_env(M) as env:
            c = env.connect()
            c.create("provisioners", M.f.make_provisioner())
            kw = {"device": "cpu"} if M.pkg == PORT else {}
            controller = M.prov.ProvisioningController(
                c, M.fake.FakeCloudProvider(M.fake.instance_types(5)), start_workers=False, **kw)
            try:
                controller.reconcile("default")
            finally:
                controller.stop()
            cond = c.get_live("provisioners", "default", namespace="").status.condition()
            return cond.type, cond.status, cond.last_transition_time is not None

    assert both(run) == ("Active", "True", True)


# -- the store version (a deliberate difference) --------------------------------------


def test_store_version_moves_with_every_cached_change():
    """The port's ``ApiCluster`` bumps ``version()`` on every informer event
    it applies and every write it caches, as the in-memory ``Cluster`` does
    on every mutation. The reference's never moves over an ``ApiCluster``
    (its cache writes bypass the version), which this records."""
    def run(M):
        with kube_env(M) as env:
            c = env.connect()
            versions = [c.version()]
            pod = M.f.make_pod(name="v1")
            c.create("pods", pod)  # a write it caches
            versions.append(c.version())
            env.cluster.create("nodes", M.f.make_node(name="from-watch"))  # an informer event
            assert wait(lambda: c.try_get("nodes", "from-watch", namespace="") is not None)
            versions.append(c.version())
            c.bind(pod, "from-watch")
            versions.append(c.version())
            c.delete("pods", "v1")
            versions.append(c.version())
            return versions

    ref, port = (run(kube(pkg)) for pkg in PACKAGES)
    assert len(set(ref)) == 1
    assert all(b > a for a, b in zip(port, port[1:]))


def test_watch_event_invalidates_the_resident_plan():
    """After a watch event adds a node, the next topology round of a
    resident scheduler over the ``ApiCluster`` re-injects instead of
    reusing the plan."""
    import random

    M = kube(PORT)
    catalog = M.fake.instance_types(8)
    provisioner = M.f.make_provisioner(solver="tpu")
    pods = M.scenarios.diverse_pods(70, random.Random(5))
    with kube_env(M) as env, pinned(PORT):
        c = env.connect()
        sched = M.Scheduler(c, rng=random.Random(1), solver_delta=True, device="cpu")
        sched.solve(provisioner, catalog, pods)
        sched.solve(provisioner, catalog, pods)
        assert "inject_delta_s" in sched.last_stage_profile()
        v0 = c.version()
        env.cluster.create("nodes", M.f.make_node(name="joined", capacity={"cpu": "4"}))
        assert wait(lambda: c.try_get("nodes", "joined", namespace="") is not None)
        assert c.version() > v0
        sched.solve(provisioner, catalog, pods)
        assert "inject_s" in sched.last_stage_profile()
        sched.solve(provisioner, catalog, pods)
        assert "inject_delta_s" in sched.last_stage_profile()

