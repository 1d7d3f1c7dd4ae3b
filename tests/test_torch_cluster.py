"""The port's in-memory ``Cluster`` against the JAX package's.

One sequence of mutations — create, watch, update, merge_patch,
patch_status, bind, delete with and without finalizers, remove_finalizer,
evict and evict_with_hint under PDBs (counts and percentages), seed —
runs against both packages with a fixed clock. The watch events, every
return value and raise, ``pods_on_node`` and the final stores (in wire
form) must be equal. Resource versions are left out of the comparison:
the port bumps the store version on a removal as well (its documented
difference), so the versions after the first removal are ahead of the
reference's. The test checks that difference on its own.
"""

import importlib

import pytest

from torch_parity import PACKAGES, fresh_router  # noqa: F401

NOW = 1_700_000_000.0


def mods(pkg):
    def m(name):
        return importlib.import_module(f"{pkg}.{name}")

    return m("kube.client"), m("kube.serde"), m("testing.factories"), m("api.objects")


def strip(doc):
    doc = dict(doc)
    doc["metadata"] = {k: v for k, v in doc["metadata"].items() if k != "resourceVersion"}
    return doc


def run(pkg):
    client, serde, f, O = mods(pkg)
    cluster = client.Cluster(clock=lambda: NOW)
    events = []
    for kind in ("pods", "nodes", "provisioners", "pdbs"):
        cluster.watch(kind, lambda e, o, kind=kind: events.append(
            (kind, e, o.metadata.namespace, o.metadata.name,
             getattr(getattr(o, "spec", None), "node_name", None),
             o.metadata.deletion_timestamp, tuple(o.metadata.finalizers))))
    out = []

    def attempt(fn, *a, **kw):
        try:
            return ("ok", fn(*a, **kw))
        except (client.Conflict, client.NotFound) as e:
            return (type(e).__name__, str(e))

    def pod(name, labels=None, finalizers=()):
        p = f.make_pod(name=name, labels=labels or {"app": "web"}, requests={"cpu": "1"})
        p.metadata.uid = f"uid-{name}"
        p.metadata.finalizers = list(finalizers)
        return p

    for i in range(2):
        node = f.make_node(name=f"n{i}", capacity={"cpu": "4"}, provisioner_name="default")
        node.metadata.uid = f"uid-n{i}"
        cluster.create("nodes", node)
    prov = f.make_provisioner()
    prov.metadata.uid = "uid-prov"
    cluster.create("provisioners", prov)
    pods = [pod(f"p{i}", finalizers=("keep",) if i == 3 else ()) for i in range(6)]
    for p in pods:
        cluster.create("pods", p)
    out.append(attempt(cluster.create, "pods", pod("p0")))  # Conflict
    out.append(attempt(cluster.get, "pods", "nope"))  # NotFound
    out.append(cluster.try_get("pods", "nope"))
    for i, p in enumerate(pods[:4]):
        cluster.bind(p, f"n{i % 2}")
    out.append({n: sorted(x.metadata.name for x in cluster.pods_on_node(n)) for n in ("n0", "n1")})
    # merge_patch: labels added and removed, annotation set; identity kept
    got = cluster.merge_patch("pods", "p4", {"metadata": {"labels": {"tier": "gold", "app": None},
                                                          "annotations": {"a": "b"}}})
    out.append((got is pods[4], dict(pods[4].metadata.labels), dict(pods[4].metadata.annotations)))
    out.append(attempt(cluster.merge_patch, "pods", "nope", {}))
    cluster.patch_status("provisioners", "default",
                         {"resources": {"cpu": "8"}, "lastScaleTime": serde.wire_ts(NOW)},
                         namespace="")
    live = cluster.get("provisioners", "default", namespace="")
    out.append((dict(live.status.resources), live.status.last_scale_time))
    cluster.patch_status("provisioners", "default", {"resources": {"cpu": None, "pods": "3"}},
                         namespace="")
    out.append(dict(cluster.get("provisioners", "default", namespace="").status.resources))
    # update of a node moves it in place
    node = cluster.get("nodes", "n1", namespace="")
    node.metadata.labels["x"] = "y"
    cluster.update("nodes", node)
    out.append(attempt(cluster.update, "nodes", f.make_node(name="ghost")))
    # PDBs: min_available 3 of the web pods; evictions stop there
    pdb = f.make_pdb(name="web", labels={"app": "web"}, min_available=3)
    pdb.metadata.uid = "uid-pdb"
    cluster.create("pdbs", pdb)
    out.append([cluster.evict(p) for p in (pods[0], pods[1], pods[2], pods[5])])
    out.append(cluster.evict_with_hint(pods[5]))
    cluster.delete("pdbs", "web")
    pct = f.make_pdb(name="pct", labels={"app": "web"}, max_unavailable="50%")
    pct.metadata.uid = "uid-pct"
    cluster.create("pdbs", pct)
    out.append([cluster.evict(p) for p in (pods[2], pods[5])])
    # finalizers: delete marks, a repeat delete is a no-op, the last
    # finalizer out removes the object; an evicted finalizer pod terminates
    out.append(cluster.evict(pods[3]))
    out.append(cluster.evict(pods[3]))  # already terminating: no PDB check
    cluster.remove_finalizer("pods", pods[3], "keep")
    node0 = cluster.get("nodes", "n0", namespace="")
    node0.metadata.finalizers = ["karpenter.sh/termination"]
    cluster.update("nodes", node0)
    cluster.delete("nodes", "n0", namespace="")
    cluster.delete("nodes", "n0", namespace="")
    out.append(cluster.get("nodes", "n0", namespace="").metadata.deletion_timestamp)
    cluster.remove_finalizer("nodes", node0, "karpenter.sh/termination")
    out.append(attempt(cluster.delete, "nodes", "n0", namespace=""))
    cluster.delete("pods", "p4")
    out.append(attempt(cluster.delete, "pods", "p4"))
    # seed: no events, indexed
    shadow = pod("shadow")
    shadow.spec.node_name = "n1"
    cluster.seed("pods", shadow)
    out.append({n: sorted(x.metadata.name for x in cluster.pods_on_node(n)) for n in ("n0", "n1")})
    out.append(sorted(p.metadata.name for p in cluster.list_pods_matching("default", None)))
    out.append([p.metadata.name for p in cluster.provisioners()])
    stores = {kind: sorted((o.metadata.namespace, o.metadata.name, strip(serde.to_wire(kind, o)))
                           for o in cluster.list(kind)) for kind in ("pods", "nodes", "provisioners", "pdbs")}
    return events, out, stores, cluster.version()


def test_mutation_sequence_equals_the_reference():
    (ref_events, ref_out, ref_stores, ref_version), (events, out, stores, version) = (
        run(pkg) for pkg in PACKAGES)
    assert out == ref_out
    assert events == ref_events
    assert stores == ref_stores
    # evictions: p0 and p1 go (5 healthy web pods > 3), then the budget holds
    assert out[9] == [True, True, False, False] and out[10] == (False, None)
    # the removals (the finalizer-free evictions and delete, and the two
    # last-finalizer removals) bumped only the port's version
    assert version > ref_version


@pytest.mark.parametrize("pkg", PACKAGES)
def test_watches_run_outside_the_lock_and_see_the_store(pkg):
    """A watch callback may read and write the cluster (controllers
    enqueue and the counter patches from inside one)."""
    client, serde, f, O = mods(pkg)
    cluster = client.Cluster()
    seen = []

    def on_pod(event, pod):
        seen.append((event, cluster.try_get("pods", pod.metadata.name) is not None))
        if event == "ADDED":
            cluster.create("nodes", f.make_node(name=f"for-{pod.metadata.name}"))

    cluster.watch("pods", on_pod)
    p = f.make_pod(name="w")
    cluster.create("pods", p)
    cluster.bind(p, "for-w")
    cluster.delete("pods", "w")
    assert seen == [("ADDED", True), ("MODIFIED", True), ("DELETED", False)]
    assert [n.metadata.name for n in cluster.nodes()] == ["for-w"]
    assert cluster.pods_on_node("for-w") == []


@pytest.mark.parametrize("value,total,want", [
    (None, 5, None), (2, 5, 2), ("3", 5, 3), ("50%", 3, 2), ("10%", 5, 1), ("0%", 5, 0)])
def test_pdb_threshold_equals_the_reference(value, total, want):
    got = [mods(pkg)[0].resolve_pdb_threshold(value, total) for pkg in PACKAGES]
    assert got == [want, want]


def test_every_mutation_bumps_the_version_in_the_port():
    client, serde, f, O = mods("karpenter_tpu_torch")
    cluster = client.Cluster()
    versions = [cluster.version()]

    def bumped():
        versions.append(cluster.version())
        return versions[-1] > versions[-2]

    p = f.make_pod(name="v")
    cluster.create("pods", p)
    assert bumped()
    cluster.merge_patch("pods", "v", {"metadata": {"labels": {"a": "b"}}})
    assert bumped()
    cluster.bind(p, "n")
    assert bumped()
    assert cluster.evict(p)  # finalizer-free: removed
    assert bumped()
    q = f.make_pod(name="q")
    q.metadata.finalizers = ["f"]
    cluster.create("pods", q)
    assert bumped()
    cluster.delete("pods", "q")
    assert bumped()
    cluster.remove_finalizer("pods", q, "f")  # the last finalizer out: removed
    assert bumped()
    assert cluster.try_get("pods", "q") is None
