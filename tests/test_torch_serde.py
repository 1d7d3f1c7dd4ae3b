"""The port's Kubernetes wire format against the JAX package's.

For every kind the in-memory ``Cluster`` stores (and leases), seeded
objects built the same way in both packages must give equal ``to_wire``
dicts; ``from_wire`` of that wire must round-trip to the same wire in both;
``json_merge`` of a patch must give equal documents; and the helpers the
controllers write status with (``wire_ts``, ``quantities``,
``prov_condition_to_wire``) must agree. Objects get explicit names and
uids: the two packages' factories keep separate counters.
"""

import importlib

import hypothesis.strategies as st
import pytest
from hypothesis import HealthCheck, given, settings

from torch_parity import PACKAGES, fresh_router  # noqa: F401

KINDS = ("pods", "nodes", "daemonsets", "provisioners", "pvcs", "pvs",
         "storageclasses", "pdbs", "events", "leases")


def mods(pkg):
    def m(name):
        return importlib.import_module(f"{pkg}.{name}")

    return m("kube.serde"), m("api.objects"), m("api.provisioner"), m("testing.factories"), m("api.labels")


def build(pkg, kind, p):
    """One object of ``kind`` from the parameter dict ``p``."""
    serde, O, prov_mod, f, lbl = mods(pkg)
    name = f"{kind}-{p['i']}"
    reqs = [O.NodeSelectorRequirement(key=lbl.TOPOLOGY_ZONE, operator="In", values=p["zones"])]
    if kind == "pods":
        obj = f.make_pod(
            name=name, labels=p["labels"], requests={"cpu": p["cpu"], "memory": p["mem"]},
            node_selector=p["selector"], node_requirements=reqs if p["flag"] else None,
            tolerations=[O.Toleration(key=k, value=v) for k, v in p["taints"]],
            topology=[f.zone_spread(max_skew=p["skew"], labels=p["labels"])] if p["flag"] else None,
            node_name=p["node"], unschedulable=not p["node"],
            priority_class_name=p["pclass"],
        )
    elif kind == "nodes":
        obj = f.make_node(
            name=name, labels=p["labels"], capacity={"cpu": p["cpu"], "memory": p["mem"]},
            taints=[O.Taint(key=k, value=v) for k, v in p["taints"]], ready=p["flag"],
            provisioner_name="default", finalizers=["karpenter.sh/termination"] if p["flag"] else None,
        )
    elif kind == "daemonsets":
        obj = f.make_daemonset(name=name, requests={"cpu": p["cpu"]}, node_selector=p["selector"])
    elif kind == "provisioners":
        obj = f.make_provisioner(
            name=name, labels=p["labels"], requirements=reqs,
            taints=[O.Taint(key=k, value=v) for k, v in p["taints"]],
            limits={"cpu": p["cpu"]} if p["flag"] else None,
            solver="tpu" if p["flag"] else "ffd", ttl_after_empty=p["skew"],
        )
        obj.status.resources = {"cpu": float(p["skew"]), "memory": 2.0 ** 30}
        obj.status.last_scale_time = 1_700_000_000.0 + p["skew"]
        obj.status.conditions.append(prov_mod.Condition(
            type="Active", status="True" if p["flag"] else "False", reason=p["pclass"],
            message=p["node"], last_transition_time=1_700_000_100.0))
    elif kind == "pvcs":
        obj = f.make_pvc(name=name, storage_class=p["pclass"], volume_name=p["node"])
    elif kind == "pvs":
        obj = f.make_pv(name=name, zones=p["zones"])
    elif kind == "storageclasses":
        obj = f.make_storage_class(name=name, zones=p["zones"])
    elif kind == "pdbs":
        obj = f.make_pdb(name=name, labels=p["labels"], min_available=p["skew"] if p["flag"] else None,
                         max_unavailable=None if p["flag"] else p["skew"])
    elif kind == "events":
        obj = O.Event(
            metadata=O.ObjectMeta(name=name, annotations=dict(p["labels"])),
            involved_kind="Pod", involved_name=p["node"] or "x", reason="PodShed",
            message=p["pclass"], type="Warning" if p["flag"] else "Normal", count=p["skew"],
            first_timestamp=1_700_000_000.0, last_timestamp=1_700_000_050.0,
        )
    else:
        obj = O.Lease(metadata=O.ObjectMeta(name=name), holder_identity=p["node"],
                      lease_duration_seconds=p["skew"], acquire_time=1_700_000_000.0,
                      renew_time=1_700_000_001.0 if p["flag"] else None, lease_transitions=p["skew"])
    obj.metadata.uid = f"uid-{kind}-{p['i']}"
    obj.metadata.creation_timestamp = 1_700_000_000.0
    obj.metadata.resource_version = p["i"] + 1
    return obj


label_text = st.text(alphabet="abcdefghij-", min_size=1, max_size=6).filter(
    lambda s: s[0] != "-" and s[-1] != "-")
params = st.fixed_dictionaries({
    "i": st.integers(0, 10_000),
    "labels": st.dictionaries(label_text, label_text, max_size=3),
    "selector": st.dictionaries(label_text, label_text, max_size=2),
    "zones": st.lists(st.sampled_from(["test-zone-1", "test-zone-2", "test-zone-3"]),
                      min_size=1, max_size=3, unique=True),
    "cpu": st.sampled_from(["100m", "0.25", "1", "2500m", "16"]),
    "mem": st.sampled_from(["64Mi", "1Gi", "1.5Gi", "128974848"]),
    "taints": st.lists(st.tuples(label_text, label_text), max_size=2),
    "flag": st.booleans(),
    "skew": st.integers(1, 5),
    "node": st.sampled_from(["", "node-a", "node-b"]),
    "pclass": st.sampled_from(["", "high", "low-batch"]),
})


def wires(kind, p):
    out = []
    for pkg in PACKAGES:
        serde = mods(pkg)[0]
        w = serde.to_wire(kind, build(pkg, kind, p))
        back = serde.to_wire(kind, serde.from_wire(kind, w))
        out.append((w, back))
    return out


@pytest.mark.parametrize("kind", KINDS)
@settings(max_examples=10, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(p=params)
def test_to_wire_and_round_trip_equal_the_reference(kind, p):
    (ref, ref_back), (port, port_back) = wires(kind, p)
    assert port == ref
    assert port_back == ref_back
    assert port_back == port


@settings(max_examples=20, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(kind=st.sampled_from(KINDS), p=params, q=params)
def test_json_merge_equals_the_reference(kind, p, q):
    """Merging one seeded object's wire into another's (with a deletion
    and a nested null) gives the same document, and that document reads
    back the same, in both packages."""
    docs = []
    for pkg in PACKAGES:
        serde = mods(pkg)[0]
        base = serde.to_wire(kind, build(pkg, kind, p))
        patch = serde.to_wire(kind, build(pkg, kind, q))
        patch["metadata"]["labels"] = {k: None for k in base["metadata"].get("labels", {})}
        patch["metadata"]["annotations"] = None
        merged = serde.json_merge(base, patch)
        docs.append((merged, serde.to_wire(kind, serde.from_wire(kind, merged))))
    assert docs[0] == docs[1]


def test_every_cluster_kind_is_mapped():
    for pkg in PACKAGES:
        serde = mods(pkg)[0]
        cluster = importlib.import_module(f"{pkg}.kube.client").Cluster
        for kind in cluster.KINDS:
            assert kind in serde.KIND_INFO and kind in serde._TO and kind in serde._FROM
    ref, port = (mods(pkg)[0] for pkg in PACKAGES)
    assert port.KIND_INFO == ref.KIND_INFO


def test_status_helpers_equal_the_reference():
    outs = []
    for pkg in PACKAGES:
        serde, O, prov_mod, f, lbl = mods(pkg)
        cond = prov_mod.Condition(type="Active", status="False", reason="ValidationFailed",
                                  message="bad", last_transition_time=1_700_000_123.9)
        outs.append((
            serde.wire_ts(1_700_000_123.9), serde.wire_ts(0.0), serde.wire_ts(None),
            serde.quantities({"cpu": 2.5, "memory": 3 * 2.0 ** 30, "pods": 110.0}),
            serde.parse_quantities({"cpu": "250m", "memory": "1Gi"}),
            serde.prov_condition_to_wire(cond),
            serde.json_merge({"a": {"b": 1, "c": [1, 2]}, "d": 1}, {"a": {"b": None, "c": [3]}, "e": 2}),
        ))
    assert outs[0] == outs[1]
    assert outs[1][6] == {"a": {"c": [3]}, "d": 1, "e": 2}
