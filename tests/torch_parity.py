"""Shared scenarios and encoders for the PyTorch port's parity tests.

The same scenario is built and encoded through ``karpenter_tpu`` (JAX) and
``karpenter_tpu_torch`` from the same seeds. The two packages' factories
keep separate global name counters, so pods are compared by their index in
the input list, never by name.
"""

from __future__ import annotations

import contextlib
import importlib
import os
import random
from types import SimpleNamespace

import numpy as np
import pytest

PACKAGES = ("karpenter_tpu", "karpenter_tpu_torch")

# the packer each package's side of a parity test pins: the JAX package its
# lax.scan kernel, the port its device path routed by shape (no router)
PINNED_PACKER = {"karpenter_tpu": "scan", "karpenter_tpu_torch": "fused"}


@contextlib.contextmanager
def packer(value):
    """``KARPENTER_PACKER`` set to ``value`` (unset for None) inside the
    block, restored after it."""
    before = os.environ.get("KARPENTER_PACKER")
    if value is None:
        os.environ.pop("KARPENTER_PACKER", None)
    else:
        os.environ["KARPENTER_PACKER"] = value
    try:
        yield
    finally:
        if before is None:
            os.environ.pop("KARPENTER_PACKER", None)
        else:
            os.environ["KARPENTER_PACKER"] = before


def pinned(pkg: str):
    """``packer`` pinned for one package's side of a parity test."""
    return packer(PINNED_PACKER[pkg])


@pytest.fixture
def interpret(monkeypatch):
    """Run the JAX package's v2 Pallas kernel in interpret mode for one
    test: ``pl.pallas_call`` patched, the jitted callers' caches cleared
    before and after, so no traced program outlives the patch. Nothing in
    ``karpenter_tpu`` changes. JAX is imported here, never at module level
    (the card-only tests import this module without JAX)."""
    import functools

    from jax.experimental import pallas as pl

    from karpenter_tpu.solver import fused as jax_fused
    from karpenter_tpu.solver import pallas_kernel_v2 as jax_v2

    def clear():
        jax_v2._pack_v2_call.clear_cache()
        jax_fused.fused_solve_v2.clear_cache()

    clear()
    monkeypatch.setattr(jax_v2.pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    yield
    clear()


def _reset_integrity():
    """Both packages' integrity counters zeroed. The JAX package's module
    is reset only when a test already imported it: the card-only tests
    import this module where JAX is absent."""
    import sys

    from karpenter_tpu_torch.solver import integrity

    integrity.reset()
    ref = sys.modules.get("karpenter_tpu.solver.integrity")
    if ref is not None:
        ref.reset()


@pytest.fixture(autouse=True)
def fresh_router():
    """The port's process-shared cost router reset before and after each
    test, the port's two failed-shape memos restored after it, and both
    packages' integrity counters zeroed before and after it, so test order
    never changes routing or the counters a test reads. Autouse in every
    module that imports it."""
    from karpenter_tpu_torch.solver import backend, pack_kernel, router

    memos = (
        (pack_kernel._failed_shapes_lock, pack_kernel._failed_shapes),
        (backend._fused_failed_lock, backend._fused_failed_shapes),
    )
    saved = []
    for lock, memo in memos:
        with lock:
            saved.append(set(memo))
    router.reset_default()
    _reset_integrity()
    yield
    router.reset_default()
    _reset_integrity()
    for (lock, memo), was in zip(memos, saved):
        with lock:
            memo.clear()
            memo.update(was)


def mods(pkg: str) -> SimpleNamespace:
    """The modules a scenario needs, from one package."""
    def m(name):
        return importlib.import_module(f"{pkg}.{name}")

    return SimpleNamespace(
        lbl=m("api.labels"),
        objects=m("api.objects"),
        fake=m("cloudprovider.fake"),
        catreq=m("cloudprovider.requirements"),
        Cluster=m("kube.client").Cluster,
        ffd=m("scheduling.ffd"),
        topology=m("scheduling.topology"),
        encode=m("solver.encode"),
        factories=m("testing.factories"),
        scenarios=m("testing.scenarios"),
    )


def scenario(pkg: str, name: str, n_pods: int = 0, seed: int = 42, n_types: int = 50):
    """(provisioner, catalog, pods) for one named scenario."""
    M = mods(pkg)
    f = M.factories
    catalog = M.fake.instance_types(n_types)
    if name == "diverse":
        return f.make_provisioner(solver="tpu"), catalog, M.scenarios.diverse_pods(
            n_pods, random.Random(seed)
        )
    if name == "config2":  # nodeSelector + taint/toleration filter
        O = M.objects
        prov = f.make_provisioner(
            solver="tpu", taints=[O.Taint(key="dedicated", value="team", effect="NoSchedule")]
        )
        rng = random.Random(2)
        pods = [
            f.make_pod(
                requests={"cpu": f"{rng.choice([0.25, 0.5, 1])}"},
                node_selector={M.lbl.TOPOLOGY_ZONE: rng.choice(
                    ["test-zone-1", "test-zone-2", "test-zone-3"])},
                tolerations=[O.Toleration(key="dedicated", value="team")],
            )
            for _ in range(n_pods)
        ]
        return prov, catalog, pods
    if name == "config3":  # pod (anti-)affinity + zone spread
        O = M.objects
        pods = []
        for i in range(n_pods // 3):
            sel = {"app": f"g{i % 5}"}
            pods.append(f.make_pod(labels=sel, requests={"cpu": "0.5"},
                                   pod_requirements=[O.PodAffinityTerm(
                                       label_selector=O.LabelSelector(match_labels=sel),
                                       topology_key=M.lbl.TOPOLOGY_ZONE)]))
            pods.append(f.make_pod(labels=sel, requests={"cpu": "0.5"},
                                   pod_anti_requirements=[O.PodAffinityTerm(
                                       label_selector=O.LabelSelector(
                                           match_labels={"app": f"solo{i}"}),
                                       topology_key=M.lbl.TOPOLOGY_ZONE)]))
            pods.append(f.make_pod(labels=sel, requests={"cpu": "0.5"},
                                   topology=[f.zone_spread(max_skew=1, labels=sel)]))
        return f.make_provisioner(solver="tpu"), catalog, pods
    if name == "teams":  # constraint-diverse: tradeoff catalog x 64 team selectors
        return team_mix(pkg, n_pods, seed, n_types)
    if name == "one_per_node":  # required hostname anti-affinity on a shared label
        O = M.objects
        sel = {"app": "solo"}
        term = O.PodAffinityTerm(
            label_selector=O.LabelSelector(match_labels=sel),
            topology_key=M.lbl.HOSTNAME,
        )
        pods = [
            f.make_pod(labels=sel, requests={"cpu": "0.25"}, pod_anti_requirements=[term])
            for _ in range(n_pods)
        ]
        return f.make_provisioner(solver="tpu"), catalog, pods
    raise ValueError(name)


def team_mix(pkg: str, n_pods: int, seed: int = 9, n_types: int = 16, k_teams: int = 64):
    """The constraint-diverse batch of ``bench.py:171-199`` and
    ``__graft_entry__._example_batch``: the anti-correlated tradeoff catalog
    (capacity frontier ``n_types`` wide) and pods with ``k_teams`` distinct
    ``nodeSelector {"team": ...}`` values, so S·F passes the v1 budget."""
    M = mods(pkg)
    f = M.factories
    rng = random.Random(seed)
    pods = [
        f.make_pod(
            requests={"cpu": f"{rng.choice([0.25, 0.5, 1])}"},
            node_selector={"team": f"t{i % k_teams}"},
        )
        for i in range(n_pods)
    ]
    return f.make_provisioner(solver="tpu"), M.fake.instance_types_tradeoff(n_types), pods


def populated_cluster(pkg: str):
    """A cluster with a daemonset and pods already bound to nodes in each
    zone, so daemon overhead and topology domain counts are not empty."""
    M = mods(pkg)
    f = M.factories
    cluster = M.Cluster()
    cluster.create("daemonsets", f.make_daemonset(requests={"cpu": "100m", "memory": "64Mi"}))
    for i, zone in enumerate(["test-zone-1", "test-zone-2", "test-zone-3", "test-zone-1"]):
        node = f.make_node(
            name=f"node-{i}", labels={M.lbl.TOPOLOGY_ZONE: zone, M.lbl.HOSTNAME: f"node-{i}"}
        )
        cluster.create("nodes", node)
        for j in range(i + 1):
            cluster.create("pods", f.make_pod(
                name=f"bound-{i}-{j}", labels={"my-label": "abc"[j % 3]},
                requests={"cpu": "100m"}, node_name=node.metadata.name,
            ))
    return cluster


def encode_scenario(pkg: str, prov, catalog, pods, cluster=None):
    """The solve's host stages up to the kernel: catalog requirements,
    FFD sort, topology injection (``random.Random(1)``), daemon overhead,
    encode. Returns the EncodedBatch."""
    M = mods(pkg)
    c = prov.spec.constraints.clone()
    c.requirements = c.requirements.merge(M.catreq.catalog_requirements(catalog))
    catalog = sorted(catalog, key=lambda it: it.effective_price())
    pods, sts = M.ffd.sort_pods_ffd_with_statics(pods)
    cluster = cluster if cluster is not None else M.Cluster()
    plan = M.topology.Topology(cluster, rng=random.Random(1)).inject_plan(c, pods, sts=sts)
    daemon = M.ffd.daemon_overhead(cluster, c)
    return M.encode.encode(c, catalog, pods, daemon, plan=plan)


def with_v2_tables(f: dict, pkg: str) -> dict:
    """``f`` plus the v2 kernel's per-core tables (``front_j``, ``compat_j``,
    ``jvals``), computed by ``pkg``'s own ``_precompute``."""
    module = "pallas_kernel_v2" if pkg == "karpenter_tpu" else "pack_kernel_v2"
    precompute = importlib.import_module(f"{pkg}.solver.{module}")._precompute
    front_j, compat_j, jvals, _ = precompute(
        np.asarray(f["join_table"]), np.asarray(f["frontiers"], np.float32)
    )
    f.update(front_j=front_j, compat_j=compat_j, jvals=jvals)
    return f


def fields(batch) -> dict:
    """An EncodedBatch as the plain dict ``carry.tensors_from_reference``
    takes; the v2 tables come from the package that encoded the batch."""
    out = dict(zip(
        ("pod_valid", "pod_open_sig", "pod_core", "pod_host", "pod_host_in_base",
         "pod_open_host", "pod_req", "join_table", "frontiers", "daemon"),
        (np.asarray(a) for a in batch.pack_args()),
    ))
    out.update(
        usable=np.asarray(batch.usable),
        type_mask=np.asarray(batch.type_mask_matrix()),
        pod_req_id=np.asarray(batch.pod_req_id),
        uniq_req=np.asarray(batch.uniq_req),
        open_sig_by_core=np.asarray(batch.open_sig_by_core),
        base_has_hostname=bool(batch.base_has_hostname),
    )
    return with_v2_tables(out, type(batch).__module__.split(".")[0])


def synth_fields(P, S, F, R, C, n_hosts, seed=0, pkg="karpenter_tpu_torch") -> dict:
    """A seeded synthetic batch with controlled table sizes: node hostname
    states take -1 (unset), h >= 0 (joinable) and -2 (poisoned). The v2
    tables come from ``pkg``'s ``_precompute``."""
    rng = np.random.default_rng(seed)
    host = np.where(rng.random(P) < 0.5, rng.integers(0, n_hosts, P), -1).astype(np.int32)
    hib = rng.random(P) < 0.7
    open_host = np.where(host >= 0, np.where(hib, host, -2), -1).astype(np.int32)
    # two frontier rows per signature plus PAD rows, small requests: many
    # pods share nodes and some signatures can never open one
    frontiers = rng.uniform(2.0, 8.0, (S, F, R)).astype(np.float32)
    frontiers[:, F // 2 :, :] = -1.0
    frontiers[rng.random(S) < 0.1] = -1.0
    join = rng.integers(-1, S, (S, C)).astype(np.int32)
    uniq_req = rng.uniform(0.1, 1.5, (24, R)).astype(np.float32)
    req_id = rng.integers(0, 24, P).astype(np.int32)
    open_sig_by_core = rng.integers(0, S, C).astype(np.int32)
    core = rng.integers(0, C, P).astype(np.int32)
    valid = rng.random(P) < 0.95
    return with_v2_tables(dict(
        pod_valid=valid,
        pod_open_sig=open_sig_by_core[core],
        pod_core=core,
        pod_host=host,
        pod_host_in_base=hib,
        pod_open_host=open_host,
        pod_req=uniq_req[req_id],
        join_table=join,
        frontiers=frontiers,
        daemon=rng.uniform(0.0, 0.5, R).astype(np.float32),
        usable=rng.uniform(1.0, 9.0, (40, R)).astype(np.float32),
        type_mask=rng.random((S, 40)) < 0.6,
        pod_req_id=req_id,
        uniq_req=uniq_req,
        open_sig_by_core=open_sig_by_core,
        base_has_hostname=True,
    ), pkg)


# -- the deprovisioning plane (consolidation, budget, node lifecycle) -------


def deprov(pkg: str) -> SimpleNamespace:
    """The deprovisioning plane's modules, from one package."""
    def m(name):
        return importlib.import_module(f"{pkg}.{name}")

    return SimpleNamespace(
        pkg=pkg, lbl=m("api.labels"), O=m("api.objects"), fake=m("cloudprovider.fake"),
        catreq=m("cloudprovider.requirements"), Cluster=m("kube.client").Cluster,
        f=m("testing.factories"), res=m("utils.resources"), metrics=m("metrics"),
        cons=m("controllers.consolidation"), dis=m("controllers.disruption"),
        repack=m("solver.repack"), term=m("controllers.termination"),
        node=m("controllers.node"), mnode=m("controllers.metrics_node"),
        mpod=m("controllers.metrics_pod"), manager=m("controllers.manager"),
        prov=m("controllers.provisioning"), sel=m("controllers.selection"),
        counter=m("controllers.counter"), pvc=m("controllers.pvc"),
        ffd=m("scheduling.ffd"), gcpolicy=m("utils.gcpolicy"),
        liveness=m("resilience.liveness"), brownout=m("resilience.brownout"),
        intr=m("controllers.interruption"), orch=m("interruption.orchestrator"),
        itypes=m("interruption.types"), gc=m("controllers.garbage_collection"),
        launch=m("launch"), recovery=m("launch.recovery"), chaos=m("testing.chaos"),
        serde=m("kube.serde"), ctypes=m("cloudprovider.types"), utilpod=m("utils.pod"),
        sim=m("cloudprovider.simulated"), cpm=m("cloudprovider.metrics"),
    )


def proc(pkg: str) -> SimpleNamespace:
    """``deprov(pkg)`` plus the process-assembly modules: options, main,
    the webhook, the cloud registry, the GKE provider, the HTTP wire, the
    oracle, the leases, the retry vocabulary and the scheduler facade."""
    def m(name):
        return importlib.import_module(f"{pkg}.{name}")

    return SimpleNamespace(
        **vars(deprov(pkg)), options=m("options"), main=m("main"), webhook=m("webhook"),
        registry=m("cloudprovider.registry"), gke=m("cloudprovider.gke"),
        http=m("cloudprovider.httpapi"), oracle=m("scheduling.oracle"), lease=m("utils.lease"),
        overload=m("resilience.overload"), policy=m("resilience.policy"), resilience=m("resilience"),
        Scheduler=m("scheduling.scheduler").Scheduler, prov_api=m("api.provisioner"),
        Requirements=m("api.requirements").Requirements,
    )


def on_cpu(M, kw: dict) -> dict:
    """``kw`` with ``device="cpu"`` for the port's controllers."""
    if M.pkg == "karpenter_tpu_torch":
        kw.setdefault("device", "cpu")
    return kw


def fleet(M, n_nodes, solver="ffd", catalog=None, clock=None, owned=False,
          finalizers=False, pods_per_node=1, itype="fake-it-19", budget=None, **kw):
    """The reference consolidation tests' cluster: ``n_nodes`` big nodes
    (20 cpu), each nearly empty (``pods_per_node`` pods of cpu 0.5 named
    ``pod-{i}-{j}``), a provisioner with the catalog's requirements, and a
    ConsolidationController (``kw``). ``owned`` gives the pods a ReplicaSet
    owner (evict mode needs one), ``finalizers`` the nodes the termination
    finalizer. Returns (cluster, provider, provisioner, controller)."""
    lbl = M.lbl
    cluster = M.Cluster(clock=clock) if clock else M.Cluster()
    provider = M.fake.FakeCloudProvider(catalog if catalog is not None else M.fake.instance_types(20))
    provisioner = M.f.make_provisioner(solver=solver)
    provisioner.spec.disruption_budget = budget
    c = provisioner.spec.constraints
    c.requirements = c.requirements.merge(M.catreq.catalog_requirements(provider.get_instance_types()))
    cluster.create("provisioners", provisioner)
    controller = M.cons.ConsolidationController(cluster, provider, **on_cpu(M, kw))
    owner = M.O.OwnerReference(api_version="apps/v1", kind="ReplicaSet", name="rs") if owned else None
    for i in range(n_nodes):
        node = M.f.make_node(
            name=f"big-{i}", capacity={"cpu": "20", "memory": "40Gi", "pods": "200"},
            provisioner_name="default",
            labels={lbl.INSTANCE_TYPE: itype, lbl.TOPOLOGY_ZONE: "test-zone-1",
                    lbl.CAPACITY_TYPE: "on-demand"},
            finalizers=[lbl.TERMINATION_FINALIZER] if finalizers else None,
        )
        cluster.create("nodes", node)
        for j in range(pods_per_node):
            cluster.create("pods", M.f.make_pod(
                name=f"pod-{i}-{j}", requests={"cpu": "0.5"}, node_name=node.metadata.name,
                unschedulable=False, owner=owner))
    return cluster, provider, provisioner, controller


def live_fleet(M, teams=False, n_nodes=1000, owned=False, finalizers=False, solver="tpu", **kw):
    """The reference's consolidation benchmark cluster (``bench.py:1255-1303``,
    BASELINE config 5): ``instance_types(400)``, ``Random(7)``, nodes
    ``live-{i}`` of a random ``fake-it-300..399`` type with 16 cpu / 32Gi /
    100 pods in test-zone-1 on-demand, each holding 1-3 bound pods of cpu
    0.5/1/2. ``teams``: the same layout on the team mix
    (``instance_types_tradeoff(400)``, ``Random(9)``, types
    ``trade-it-300..399``, node i labelled ``team: t{i % 64}``, its pods cpu
    0.25/0.5/1 with that ``nodeSelector``). Returns (cluster, provider,
    provisioner, controller)."""
    lbl = M.lbl
    rng = random.Random(9 if teams else 7)
    catalog = M.fake.instance_types_tradeoff(400) if teams else M.fake.instance_types(400)
    prefix, sizes = ("trade-it", (0.25, 0.5, 1)) if teams else ("fake-it", (0.5, 1, 2))
    cluster = M.Cluster()
    provider = M.fake.FakeCloudProvider(catalog)
    provisioner = M.f.make_provisioner(solver=solver)
    c = provisioner.spec.constraints
    c.requirements = c.requirements.merge(M.catreq.catalog_requirements(catalog))
    cluster.create("provisioners", provisioner)
    owner = M.O.OwnerReference(api_version="apps/v1", kind="ReplicaSet", name="rs") if owned else None
    for i in range(n_nodes):
        labels = {lbl.INSTANCE_TYPE: f"{prefix}-{rng.randrange(300, 400)}",
                  lbl.TOPOLOGY_ZONE: "test-zone-1", lbl.CAPACITY_TYPE: "on-demand"}
        selector = {"team": f"t{i % 64}"} if teams else None
        if teams:
            labels.update(selector)
        node = M.f.make_node(
            name=f"live-{i}", capacity={"cpu": "16", "memory": "32Gi", "pods": "100"},
            provisioner_name="default", labels=labels,
            finalizers=[lbl.TERMINATION_FINALIZER] if finalizers else None)
        cluster.create("nodes", node)
        for j in range(rng.randrange(1, 4)):
            cluster.create("pods", M.f.make_pod(
                name=f"p-{i}-{j}", requests={"cpu": f"{rng.choice(sizes)}"},
                node_selector=selector, node_name=node.metadata.name, unschedulable=False,
                owner=owner))
    controller = M.cons.ConsolidationController(cluster, provider, **on_cpu(M, kw))
    return cluster, provider, provisioner, controller


def plan_view(plan) -> dict:
    """A consolidation plan by names: the candidates and their pods, each
    proposed node's instance types and pods in order, keep / retire (in
    retirement order) / launch, the moves, both prices and worthwhile."""
    def names(objs):
        return [o.metadata.name for o in objs]

    def vnodes(vs):
        return [([it.name for it in v.instance_type_options], names(v.pods)) for v in vs]

    return {
        "nodes": names(plan.nodes), "pods": names(plan.pods), "proposed": vnodes(plan.proposed),
        "keep": names(plan.keep), "retire": names(plan.retire), "launch": vnodes(plan.launch),
        "moves": names(plan.moves), "current_price": plan.current_price,
        "proposed_price": plan.proposed_price, "worthwhile": plan.worthwhile,
    }


def wire_all(M, cluster, provider, consolidation=None, start_workers=True, interruption=False,
             journal=None, gc=None, **kw):
    """The reference ``main.py:354-466`` wiring of every ported controller
    on one Manager: the names, the concurrency and the watches.
    ``interruption`` adds the interruption controller; ``journal`` is the
    provisioning controller's launch journal; ``gc`` (a dict of keyword
    arguments) adds the garbage collector over that journal. Returns a
    namespace holding the Manager and each controller; ``stop(ns)`` stops
    them."""
    kw = on_cpu(M, kw)
    manager = M.manager.Manager(cluster)
    provisioning = M.prov.ProvisioningController(cluster, provider, start_workers=start_workers,
                                                 journal=journal, **kw)
    termination = M.term.TerminationController(cluster, provider, start_queue=start_workers)
    out = SimpleNamespace(
        manager=manager, provisioning=provisioning,
        selection=M.sel.SelectionController(cluster, provisioning, wait=False),
        termination=termination,
        interruption=M.intr.InterruptionController(
            cluster, provider, provisioning=provisioning, termination=termination)
        if interruption else None,
        node=M.node.NodeController(cluster, cloud_provider=provider),
        consolidation=consolidation,
        garbage_collection=M.gc.GarbageCollectionController(
            cluster, provider, journal=journal, termination=termination, **gc)
        if gc is not None else None,
        counter=M.counter.CounterController(cluster),
        pvc=M.pvc.PVCController(cluster), metrics_node=M.mnode.NodeMetricsController(cluster),
        metrics_pod=M.mpod.PodMetricsController(cluster),
    )
    for name, concurrency in (("provisioning", 10), ("selection", 32), ("termination", 10),
                              ("interruption", 2), ("node", 10), ("consolidation", 2),
                              ("garbage_collection", 1), ("counter", 2), ("pvc", 2),
                              ("metrics_node", 2), ("metrics_pod", 2)):
        controller = getattr(out, name)
        if controller is not None:
            manager.register(name, controller.reconcile, concurrency=concurrency)
    cluster.watch("provisioners", lambda e, o: manager.enqueue("provisioning", o.metadata.name))
    cluster.watch("pods", lambda e, o: manager.enqueue(
        "selection", (o.metadata.name, o.metadata.namespace)))
    for name in ("node", "interruption", "garbage_collection", "consolidation", "counter", "pvc",
                 "termination", "metrics_node", "metrics_pod"):
        controller = getattr(out, name)
        if controller is not None:
            controller.register(manager)
    return out


def stop(wired) -> None:
    wired.manager.stop()
    wired.provisioning.stop()
    wired.termination.stop()


# -- predictive provisioning ---------------------------------------------------


class FakeClock:
    """A settable clock for the forecaster's and the controllers' ``clock=``."""

    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


# -- interruption and the launch journal --------------------------------------

# annotations whose values are random by design (launch tokens, trace and
# decision ids): compared by presence
RANDOM_ANNOTATIONS = ("karpenter.sh/launch-token", "karpenter.sh/trace-context",
                      "karpenter.sh/trace-id", "karpenter.sh/decision-id")


def wire_doc(M, kind, obj) -> dict:
    """``obj``'s wire form without the store's uid and resourceVersion, the
    random annotations' values replaced by ``<set>``."""
    doc = M.serde.to_wire(kind, obj)
    meta = doc["metadata"]
    meta.pop("uid", None)
    meta.pop("resourceVersion", None)
    ann = meta.get("annotations") or {}
    for key in RANDOM_ANNOTATIONS:
        if key in ann:
            ann[key] = "<set>"
    return doc


def events(M, cluster) -> list:
    """Every event's wire form (``wire_doc``), in creation order."""
    return [wire_doc(M, "events", e) for e in cluster.list("events")]


def journal_docs(journal) -> list:
    """A launch journal's open entries as documents, by token."""
    return sorted((e.to_doc() for e in journal.unresolved()), key=lambda d: d["token"])


def canon(value) -> str:
    """``value`` as sorted JSON with the fake cloud's node names
    (``fake-node-<n>``, a per-package counter) renamed ``node#<k>`` by
    their order of creation, so the two packages' results compare."""
    import json
    import re

    text = json.dumps(value, sort_keys=True, default=repr)
    seen = sorted({int(n) for n in re.findall(r"fake-node-(\d+)", text)})
    rank = {n: k for k, n in enumerate(seen)}
    return re.sub(r"fake-node-(\d+)", lambda m: f"node#{rank[int(m.group(1))]}", text)


def both_canon(fn, ns=None):
    """``fn(M)`` on each package under its pinned packer (``M`` is
    ``ns(pkg)``, ``deprov`` by default); the port's result, once it equals
    the reference's under ``canon``."""
    ns = ns or deprov
    out = []
    for pkg in PACKAGES:
        with pinned(pkg):
            out.append(fn(ns(pkg)))
    assert canon(out[1]) == canon(out[0])
    return out[1]


# -- the API server path -------------------------------------------------------


def kube(pkg: str) -> SimpleNamespace:
    """``proc(pkg)`` plus the API server path: the transport, ``ApiCluster``,
    the test API server, the leases, the webhook's caBundle reconciler and
    the event recorder."""
    def m(name):
        return importlib.import_module(f"{pkg}.{name}")

    return SimpleNamespace(
        **vars(proc(pkg)), transport=m("kube.transport"), api=m("kube.apiserver"),
        ts=m("kube.testserver"), leader=m("kube.leader"), cabundle=m("kube.cabundle"),
        kevents=m("kube.events"), client=m("kube.client"), obs=m("obs"),
        scenarios=m("testing.scenarios"))


def stop_client(client) -> None:
    """Stop an ``ApiCluster`` without waiting out its watch reads: each
    watch socket is shut down, so a thread blocked in a read returns at
    once instead of at the server's next heartbeat (a second)."""
    import socket

    client._stop.set()
    for conn in list(client._watch_conns.values()):
        sock = getattr(conn, "sock", None)
        if sock is not None:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
    client.stop()


class KubeEnv:
    """One package's ``TestApiServer``, started, over ``cluster`` (a fresh
    in-memory store by default), and the ``ApiCluster`` clients
    ``connect`` hands out; ``stop`` stops them all (``stop_client``)."""

    def __init__(self, M, cluster=None, chaos=None):
        self.M = M
        self.server = M.ts.TestApiServer(cluster=cluster, chaos=chaos)
        self.server.start()
        self.url = self.server.url
        self.cluster = self.server.cluster
        self.clients = []

    @property
    def chaos(self):
        return self.server.chaos

    @chaos.setter
    def chaos(self, value):
        self.server.chaos = value

    def connect(self, M=None, start=True, fast_retries=False, **kw):
        """An ``ApiCluster`` of package ``M`` (the server's by default);
        ``start`` runs its informers and waits for the first sync;
        ``fast_retries`` shrinks the transport's backoff to 10-50 ms."""
        M = M or self.M
        client = M.api.ApiCluster(self.url, **kw)
        if fast_retries:
            client.transport._backoff_base = 0.01
            client.transport._backoff_cap = 0.05
        self.clients.append(client)
        if start:
            client.start()
            assert client.wait_for_sync(10)
        return client

    def stop(self) -> None:
        for client in self.clients:
            stop_client(client)
        self.server.stop()


@contextlib.contextmanager
def kube_env(M, **kw):
    """``KubeEnv(M, **kw)`` around the block."""
    env = KubeEnv(M, **kw)
    try:
        yield env
    finally:
        env.stop()


def sample(M, name, labels=None) -> float:
    """One sample of package ``M``'s metrics registry (0 when absent)."""
    return M.metrics.REGISTRY.get_sample_value(name, labels or {}) or 0.0


def both_at_once(fn, ns=kube):
    """``fn(M)`` for the two packages on two threads at once (for cases
    that wait out server-side timeouts or latency); the port's result, once
    it equals the reference's under ``canon``."""
    import threading

    out, errors = {}, []

    def run(pkg):
        try:
            out[pkg] = fn(ns(pkg))
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(pkg,)) for pkg in PACKAGES]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    if errors:
        raise errors[0]
    assert set(out) == set(PACKAGES)
    assert canon(out[PACKAGES[1]]) == canon(out[PACKAGES[0]])
    return out[PACKAGES[1]]
