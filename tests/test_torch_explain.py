"""The port's elimination attribution against the JAX package's.

Each planted-dimension scenario of ``tests/test_explain.py`` (resource fit,
daemon overhead, requirement, zone topology, capacity frontier) is built
in both packages from the same seed. The reference encodes and solves it
on its native packer; the port solves it through its ``Scheduler`` on
three routes — the native packer, the fused plain version and the unfused
plain version (``KARPENTER_PACKER`` = ``native``, ``fused``, ``scan``) —
and explains the decision context the scheduler published. Every verdict
equals the reference's, field for field. The rollup, hostname, schedulable,
filter, memo and candidate-cap cases follow, each on both packages.
"""

from __future__ import annotations

import importlib
import random

import numpy as np
import pytest

from torch_parity import fresh_router, mods, packer  # noqa: F401

JAX, PORT = "karpenter_tpu", "karpenter_tpu_torch"
BOTH = (JAX, PORT)
TARGET = "target-pod"
ROUTES = ("native", "fused", "scan")


def mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


@pytest.fixture(scope="module", autouse=True)
def _native():
    for pkg in BOTH:
        if not mod(pkg, "solver.native").native_available(wait=240.0):
            pytest.skip("native packer unavailable")


class Kit:
    """One package's constructors, so a scenario builds the same objects
    in either package."""

    def __init__(self, pkg):
        M = mods(pkg)
        self.pkg = pkg
        self.lbl = M.lbl
        self.make_pod = M.factories.make_pod
        self.make_provisioner = M.factories.make_provisioner
        self.new_instance_type = M.fake.new_instance_type
        self.Offering = mod(pkg, "cloudprovider.types").Offering
        self.Req = M.objects.NodeSelectorRequirement
        self.expl = mod(pkg, "solver.explain")
        self.M = M

    def uniform_catalog(self, n, cpu=4.0, zones=None):
        offerings = [self.Offering("on-demand", z) for z in zones] if zones else None
        return [
            self.new_instance_type(f"it-{i}", resources={"cpu": float(cpu), "pods": 100.0},
                                   offerings=offerings)
            for i in range(n)
        ]


# -- the planted-dimension scenarios of tests/test_explain.py ------------------


def resource(k, rng):
    cpu = rng.uniform(2.0, 6.0)
    catalog = k.uniform_catalog(rng.randint(3, 8), cpu=cpu)
    pods = [k.make_pod(requests={"cpu": "0.2"}) for _ in range(rng.randint(1, 4))]
    pods.append(k.make_pod(name=TARGET, requests={"cpu": str(cpu + rng.uniform(1.0, 50.0))}))
    return catalog, pods, {}, []


def daemon(k, rng):
    catalog = k.uniform_catalog(rng.randint(2, 6), cpu=4.0)
    d = {"cpu": rng.uniform(0.5, 1.0)}
    pods = [k.make_pod(requests={"cpu": "0.2"}),
            k.make_pod(name=TARGET, requests={"cpu": str(4.0 - 0.1 - rng.uniform(0.05, 0.3))})]
    return catalog, pods, d, []


def requirement(k, rng):
    catalog = k.uniform_catalog(rng.randint(3, 8))
    pods = [k.make_pod(requests={"cpu": "0.2"}),
            k.make_pod(name=TARGET, requests={"cpu": "0.5"},
                       node_selector={k.lbl.INSTANCE_TYPE: "no-such-type"})]
    return catalog, pods, {}, []


def zone(k, rng):
    catalog = k.uniform_catalog(rng.randint(3, 8), zones=["zone-a", "zone-b"])
    pods = [k.make_pod(requests={"cpu": "0.2"}),
            k.make_pod(name=TARGET, requests={"cpu": "0.5"},
                       node_selector={k.lbl.TOPOLOGY_ZONE: "zone-missing"})]
    return catalog, pods, {}, []


def frontier(k, rng):
    small = rng.uniform(1.0, 2.0)
    catalog = [k.new_instance_type("small", resources={"cpu": small, "pods": 100.0}),
               k.new_instance_type("big", resources={"cpu": 4.0, "pods": 100.0})]
    d = {"cpu": rng.uniform(0.6, 1.0)}
    pods = [k.make_pod(name=TARGET, requests={"cpu": str(4.0 - 0.1 - rng.uniform(0.05, 0.4))})]
    return catalog, pods, d, []


SCENARIOS = {
    "resource_fit": resource, "daemon_overhead": daemon, "requirement": requirement,
    "zone_topology": zone, "capacity_frontier": frontier,
}
SEEDS = (0, 1, 2, 3)


# -- solving -------------------------------------------------------------------


def ref_verdicts(k: Kit, catalog, pods, d, requirements):
    """The reference's path of tests/test_explain.py: encode like the
    facade, solve on the native packer → (target verdict, all unplaced)."""
    constraints = k.make_provisioner(requirements=requirements).spec.constraints.clone()
    constraints.requirements = constraints.requirements.merge(
        k.M.catreq.catalog_requirements(catalog))
    catalog = sorted(catalog, key=lambda it: it.effective_price())
    batch = k.M.encode.encode(constraints, catalog, k.M.ffd.sort_pods_ffd(pods), d or {})
    result = mod(JAX, "solver.native").pack_native(*batch.pack_args(), n_max=len(batch.pod_valid))
    return explained(k, batch, np.asarray(result.assignment)[: batch.n_pods])


def explained(k: Kit, batch, assignment):
    target = next(i for i, p in enumerate(batch.pods[: batch.n_pods])
                  if p.metadata.name == TARGET)
    verdict = k.expl.explain_pod(batch, target)
    verdict["placed"] = bool(assignment[target] >= 0)
    others = [
        {kk: v for kk, v in x.items() if kk != "pod"}
        for x in k.expl.explain_batch(batch, assignment)
    ]
    return verdict, others


def port_verdicts(k: Kit, catalog, pods, d, requirements, route, monkeypatch):
    """The port's path: its ``Scheduler`` on ``route``, the daemon overhead
    the scenario plants, the decision context the solve published."""
    backend = mod(PORT, "solver.backend")
    monkeypatch.setattr(backend, "daemon_overhead", lambda cluster, c: dict(d))
    sched = mod(PORT, "scheduling.scheduler").Scheduler(
        k.M.Cluster(), rng=random.Random(1), device="cpu")
    with packer(route):
        sched.solve(k.make_provisioner(solver="tpu", requirements=requirements), catalog, pods)
    ctx = sched.last_decision_context()
    monkeypatch.undo()
    expected = {"native": "native", "fused": "pack_reference", "scan": "pack_reference"}[route]
    assert ctx["route"] == expected
    return explained(k, ctx["batch"], ctx["assignment"])


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", list(SCENARIOS))
def test_verdicts_equal_the_reference_on_every_route(name, seed, monkeypatch):
    build = SCENARIOS[name]
    ref = ref_verdicts(Kit(JAX), *build(Kit(JAX), random.Random(seed)))
    assert ref[0]["top_reason"] == name and ref[0]["placed"] is False
    for route in ROUTES:
        k = Kit(PORT)
        out = port_verdicts(k, *build(k, random.Random(seed)), route, monkeypatch)
        assert out == ref, route


def both(fn):
    out = {pkg: fn(Kit(pkg)) for pkg in BOTH}
    assert out[PORT] == out[JAX], out
    return out[PORT]


def solve(k: Kit, catalog, pods, d=None, requirements=None):
    if k.pkg == JAX:
        return ref_verdicts(k, catalog, pods, d or {}, requirements or [])
    constraints = k.make_provisioner(requirements=requirements or []).spec.constraints.clone()
    constraints.requirements = constraints.requirements.merge(
        k.M.catreq.catalog_requirements(catalog))
    catalog = sorted(catalog, key=lambda it: it.effective_price())
    batch = k.M.encode.encode(constraints, catalog, k.M.ffd.sort_pods_ffd(pods), d or {})
    result = mod(PORT, "solver.native").pack_native(*batch.pack_args(), n_max=len(batch.pod_valid))
    return explained(k, batch, np.asarray(result.assignment)[: batch.n_pods])


def test_compound_rollup_message_joins_dimensions():
    def run(k):
        catalog = (
            [k.new_instance_type(f"zoned-{i}", resources={"cpu": 4.0, "pods": 100.0},
                                 offerings=[k.Offering("on-demand", "zone-b")]) for i in range(2)]
            + [k.new_instance_type(f"arch-{i}", architecture="arm64",
                                   resources={"cpu": 4.0, "pods": 100.0},
                                   offerings=[k.Offering("on-demand", "zone-a")]) for i in range(3)]
        )
        pods = [k.make_pod(name=TARGET, requests={"cpu": "0.5"},
                           node_selector={k.lbl.TOPOLOGY_ZONE: "zone-a", k.lbl.ARCH: "amd64"})]
        return solve(k, catalog, pods)[0]

    verdict = both(run)
    assert verdict["top_reason"] == "requirement" and "∧" in verdict["message"]


def test_frontier_rollup_for_mixed_resource_elimination():
    def run(k):
        catalog = [k.new_instance_type("small", resources={"cpu": 2.0, "pods": 100.0}),
                   k.new_instance_type("big", resources={"cpu": 4.0, "pods": 100.0})]
        pods = [k.make_pod(name=TARGET, requests={"cpu": "3.5"})]
        return solve(k, catalog, pods, d={"cpu": 0.9})[0]

    verdict = both(run)
    assert verdict["reasons"] == {"resource_fit": 1, "daemon_overhead": 1}


def test_hostname_poison_is_annotation_not_eliminator():
    def run(k):
        pods = [k.make_pod(name=TARGET, requests={"cpu": "0.5"},
                           node_selector={k.lbl.HOSTNAME: "pinned-host"})]
        reqs = [k.Req(key=k.lbl.HOSTNAME, operator="In", values=["other-host"])]
        return solve(k, k.uniform_catalog(3), pods, requirements=reqs)[0]

    verdict = both(run)
    assert verdict["placed"] and verdict["hostname_poisoned"] == "pinned-host"


def test_schedulable_pod_reports_viable_types():
    verdict = both(lambda k: solve(k, k.uniform_catalog(3),
                                   [k.make_pod(name=TARGET, requests={"cpu": "0.5"})])[0])
    assert verdict["viable_types"] == 3 and verdict["message"] == "schedulable on a fresh node"


def test_explain_batch_filters_to_unschedulable():
    def run(k):
        pods = [k.make_pod(requests={"cpu": "0.5"}),
                k.make_pod(name=TARGET, requests={"cpu": "100"})]
        target, unplaced = solve(k, k.uniform_catalog(3), pods)
        return target, unplaced

    target, unplaced = both(run)
    assert len(unplaced) == 1 and unplaced[0]["placed"] is False


def test_verdict_memo_never_collides_across_batches_on_a_shared_table():
    def run(k):
        catalog = k.uniform_catalog(4, zones=["zone-a"])
        constraints = k.make_provisioner().spec.constraints.clone()
        constraints.requirements = constraints.requirements.merge(
            k.M.catreq.catalog_requirements(catalog))
        cat = sorted(catalog, key=lambda it: it.effective_price())
        cache = k.M.encode.EncodeCache()
        out = []
        for selector in ({k.lbl.INSTANCE_TYPE: "no-such-type"},
                         {k.lbl.TOPOLOGY_ZONE: "zone-missing"}):
            pods = k.M.ffd.sort_pods_ffd([k.make_pod(name=TARGET, requests={"cpu": "0.5"},
                                                     node_selector=selector)])
            batch = k.M.encode.encode(constraints, cat, pods, {}, cache=cache)
            out.append(k.expl.explain_pod(batch, 0)["top_reason"])
        return out

    assert both(run) == ["requirement", "zone_topology"]


def test_candidate_listing_capped_counts_complete():
    def run(k):
        verdict = solve(k, k.uniform_catalog(30, cpu=2.0),
                        [k.make_pod(name=TARGET, requests={"cpu": "50"})])[0]
        return verdict["reasons"], len(verdict["candidates"])

    assert both(run) == ({"resource_fit": 30}, 20)


def test_reason_vocabulary_and_messages_match():
    def run(k):
        e = k.expl
        cases = [
            ({}, 0, True), ({"resource_fit": 3}, 0, False), ({"daemon_overhead": 2}, 0, False),
            ({"resource_fit": 1, "daemon_overhead": 1}, 0, False),
            ({"requirement": 3, "zone_topology": 2}, 0, True), ({"hostname": 1}, 0, True),
            ({"resource_fit": 2}, 1, True), ({"taint": 1}, 0, True),
        ]
        out = []
        for counts, viable, admits in cases:
            top = e.top_reason(counts, viable=viable, frontier_admits=admits)
            out.append((top, e.reason_message(counts, top, viable=viable)))
        return e.ALL_REASONS, e.DEFAULT_MAX_CANDIDATES, out

    both(run)


def headline_verdicts(k: Kit):
    """The headline batch (``instance_types(400)`` ×
    ``diverse_pods(10000, Random(42))``) with 1% of its pods, a
    ``Random(5)`` choice, made unschedulable (``cpu: 100000``), as
    ``chip_smoke.py`` phase 14 (e) builds it, through one package's
    ``Scheduler`` on the native packer → (pods, stuck indices, every unplaced
    pod's verdict keyed by its input index)."""
    f = k.M.factories
    pods = k.M.scenarios.diverse_pods(10000, random.Random(42))
    stuck = sorted(random.Random(5).sample(range(len(pods)), len(pods) // 100))
    for i in stuck:
        pods[i] = f.make_pod(name=f"stuck-{i}", requests={"cpu": "100000"})
    extra = {"device": "cpu"} if k.pkg == PORT else {}
    sched = mod(k.pkg, "scheduling.scheduler").Scheduler(
        k.M.Cluster(), rng=random.Random(1), **extra)
    with packer("native"):
        sched.solve(f.make_provisioner(solver="tpu"), k.M.fake.instance_types(400), pods)
    ctx = sched.last_decision_context()
    index = {p.key: i for i, p in enumerate(pods)}
    verdicts = {index[v["pod"]]: {kk: x for kk, x in v.items() if kk != "pod"}
                for v in k.expl.explain_batch(ctx["batch"], ctx["assignment"])}
    return pods, stuck, verdicts


def test_headline_unplaced_pods_and_verdicts_equal_the_reference():
    """Besides its stuck pods, the headline batch leaves zone
    anti-affinity pods unplaced: a required anti-affinity term over the
    zone admits one pod of a selector group per zone, and the fake catalog
    offers three zones. Both packages leave the same pods unplaced with the
    same verdicts: the stuck ones ``resource_fit``, the others
    ``zone_topology``."""
    out = {pkg: headline_verdicts(Kit(pkg)) for pkg in BOTH}
    pods, stuck, verdicts = out[PORT]
    assert verdicts == out[JAX][2]
    assert all(verdicts[i]["top_reason"] == "resource_fit" for i in stuck)
    others = sorted(set(verdicts) - set(stuck))
    assert others
    lbl = Kit(PORT).lbl
    for i in others:
        anti = pods[i].spec.affinity.pod_anti_affinity
        assert verdicts[i]["top_reason"] == "zone_topology"
        assert [t.topology_key for t in anti.required] == [lbl.TOPOLOGY_ZONE]
