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
