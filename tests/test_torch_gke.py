"""The port's GKE TPU-podslice provider (``cloudprovider/gke.py``) and
unschedulability oracle (``scheduling/oracle.py``) against the JAX
package's.

Mirrors every class of ``tests/test_gke_provider.py`` (``TestGkeCatalog``,
``TestTpuScheduling``, ``TestGkeLaunch``, ``TestGkeStockoutAndMultiHost``)
with ``solver`` ``ffd`` and ``tpu`` wherever the reference parametrizes it,
and ``TestIdempotentCreateGke`` of ``tests/test_launch_journal.py`` in
process and over ``GkeAPIServer``. ``google.com/tpu`` is an extended
resource: it adds an axis to the encoded batch, so the ``tpu`` cases run
the port's plain versions of both kernels on a four-axis problem. Each case
runs on both packages (the port's schedulers on ``device="cpu"``, each side
pinned by ``torch_parity.pinned``) and compares exactly: the plan by pod
index with every instance-type option in order, the launched Nodes' wire
forms, the node pools, the oracle's verdict.
"""

import contextlib
import random

import pytest

from torch_parity import (  # noqa: F401
    PACKAGES, both_canon, fresh_router, on_cpu, proc, wire_doc)


def both(fn):
    return both_canon(fn, ns=proc)


def constraints(M, solver="ffd"):
    catalog = M.gke.gke_catalog()
    provisioner = M.f.make_provisioner(solver=solver)
    c = provisioner.spec.constraints
    M.gke.GkeCloudProvider().default(c)
    c.requirements = c.requirements.merge(M.catreq.catalog_requirements(catalog))
    return provisioner, catalog


def plan(vnodes, pods) -> list:
    """Each virtual node's instance-type options in order and its pods by
    index in ``pods``."""
    index = {id(p): i for i, p in enumerate(pods)}
    return [([it.name for it in v.instance_type_options], sorted(index[id(p)] for p in v.pods))
            for v in vnodes]


def solve(M, pods, solver, cluster=None):
    provisioner, catalog = constraints(M, solver)
    sched = M.Scheduler(cluster or M.Cluster(), **on_cpu(M, {"rng": random.Random(0)}))
    return sched.solve(provisioner, catalog, pods), sched


# -- TestGkeCatalog ---------------------------------------------------------------


def test_registry_builds_gke():
    def run(M):
        provider = M.registry.new_cloud_provider("gke")
        return provider.name(), sorted(it.name for it in provider.get_instance_types())

    name, names = both(run)
    assert name == "gke" and "ct5lp-hightpu-4t" in names and "e2-standard-2" in names


def test_catalog_forms():
    """Every catalog entry (resources, overhead, price, labels, offerings)
    and the slice host counts."""
    def run(M):
        return [(it.name, sorted(it.resources.items()), sorted(it.overhead.items()), it.price,
                 sorted(it.labels.items()), [(o.capacity_type, o.zone) for o in it.offerings],
                 M.gke.slice_hosts(it.name)) for it in M.gke.gke_catalog()]

    forms = both(run)
    by_name = {f[0]: dict(f[1]) for f in forms}
    assert by_name["ct5lp-hightpu-1t"]["google.com/tpu"] == 1.0
    assert by_name["ct5lp-hightpu-8t"]["google.com/tpu"] == 8.0
    assert "google.com/tpu" not in by_name["n2-standard-8"]
    assert {f[0]: f[6] for f in forms}["ct5lp-hightpu-4t-8x8"] == 16


# -- TestTpuScheduling -----------------------------------------------------------


def tpu_pods(M, case):
    TPU, lbl = M.gke.TPU_RESOURCE, M.lbl
    mk = M.f.make_pod
    if case == "cheapest slice":
        return [mk(name="solo", requests={"cpu": "8", TPU: "4"})]
    if case == "cpu only":
        return [mk(name=f"web-{i}", requests={"cpu": "2"}) for i in range(6)]
    if case == "first fit packs chips":
        return [mk(name=f"train-{i}", requests={"cpu": "8", TPU: "4"}) for i in range(2)]
    if case == "chips pack and split":
        return [mk(name=f"t-{i}", requests={"cpu": "4", TPU: "4"},
                   node_selector={lbl.INSTANCE_TYPE: "ct5lp-hightpu-8t"}) for i in range(3)]
    if case == "topology selector":
        return [mk(requests={"cpu": "8", TPU: "4"},
                   node_selector={M.gke.GKE_TPU_TOPOLOGY_LABEL: "4x4"})]
    raise ValueError(case)


SCHEDULING = ["cheapest slice", "cpu only", "first fit packs chips", "chips pack and split",
              "topology selector"]


@pytest.mark.parametrize("solver", ["ffd", "tpu"])
@pytest.mark.parametrize("case", SCHEDULING)
def test_tpu_scheduling(case, solver):
    def run(M):
        pods = tpu_pods(M, case)
        vnodes, sched = solve(M, pods, solver)
        return plan(vnodes, pods)

    out = both(run)
    firsts = [opts[0] for opts, _ in out]
    if case == "cheapest slice":
        assert firsts == ["ct5lp-hightpu-4t"]
    elif case == "cpu only":
        assert sum(len(p) for _, p in out) == 6 and all(f.startswith("e2-") for f in firsts)
    elif case == "first fit packs chips":
        assert firsts == ["ct5lp-hightpu-8t"] and out[0][1] == [0, 1]
    elif case == "chips pack and split":
        assert sorted(len(p) for _, p in out) == [1, 2]
    else:
        assert [opts for opts, _ in out] == [["ct5lp-hightpu-4t-4x4"]]


def test_tpu_axis_reaches_the_encoded_batch():
    """A batch that asks for chips encodes ``google.com/tpu`` as a resource
    axis of its own, in both packages (the encoder keeps the axes the
    batch requests: cpu, memory, pods and chips here, R = 4), and the
    ``tpu`` solve of it is served by a packer."""
    from torch_parity import encode_scenario

    def run(M):
        pods = [M.f.make_pod(name=f"m-{i}", requests={"cpu": "8", "memory": "16Gi",
                                                       M.gke.TPU_RESOURCE: "4"})
                for i in range(3)] + [M.f.make_pod(name="web", requests={"cpu": "1"})]
        provisioner, catalog = constraints(M, "tpu")
        batch = encode_scenario(M.pkg, provisioner, catalog, pods)
        vnodes, sched = solve(M, pods, "tpu")
        return (list(batch.axis_names), list(batch.pod_req.shape), list(batch.frontiers.shape),
                plan(vnodes, pods), sched.last_stage_profile().get("packer_backend") is not None)

    names, req, front, _, served = both(run)
    assert "google.com/tpu" in names and len(names) == 4 and req[1] == front[2] == 4 and served


@pytest.mark.parametrize("R", [3, 4])
def test_launch_plan_keeps_the_node_state_in_shared_memory_with_the_tpu_axis(R):
    """With the chip axis (R = 3 without memory requests, 4 with) the
    kernels' launch plan still holds the node table in shared memory at the
    first solve's n_max and at the mixed batch's P."""
    from karpenter_tpu_torch.solver.backend import N_MAX_FIRST
    from karpenter_tpu_torch.solver.pack_kernel import launch_plan

    for n_cap in (N_MAX_FIRST, 2048):
        plan = launch_plan(1, R, n_cap)
        assert plan.node_state_in_smem and plan.smem_bytes >= n_cap * (2 + R) * 4


@pytest.mark.parametrize("solver", ["ffd", "tpu"])
def test_cpu_only_batch_at_scale_buys_tpu_hosts_like_the_reference(solver):
    """Past 24 CPU-only pods of cpu 2, first fit keeps filling a node while
    any type still fits its total, so the nodes outgrow the largest CPU
    machine (48 cpu) and buy the 224-cpu ct5lp-hightpu-8t (110 pods a node),
    in both packages: the reference's "never buys TPU hosts" holds at its
    6 pods, not at this size (chip_smoke.py phase 20 (b): 15 such nodes for
    1,600 pods)."""
    def run(M):
        pods = [M.f.make_pod(name=f"web-{i}", requests={"cpu": "2"}) for i in range(220)]
        vnodes, _ = solve(M, pods, solver)
        return plan(vnodes, pods)

    out = both(run)
    assert [opts[0] for opts, _ in out] == ["ct5lp-hightpu-8t"] * 2
    assert sum(len(p) for _, p in out) == 220


@pytest.mark.parametrize("solver", ["ffd", "tpu"])
def test_oversized_tpu_request_certified_unschedulable(solver):
    def run(M):
        cluster = M.Cluster()
        pods = [M.f.make_pod(name="huge", requests={M.gke.TPU_RESOURCE: "16"})]
        provisioner, catalog = constraints(M, solver)
        vnodes, _ = solve(M, pods, solver, cluster)
        verdict = M.oracle.classify_drops(cluster, provisioner.spec.constraints, catalog, pods,
                                          [p for v in vnodes for p in v.pods])
        return plan(vnodes, pods), verdict

    vnodes, verdict = both(run)
    assert vnodes == [] and verdict["expected"] == {"no-instance-type-fits": 1}
    assert verdict["unexplained"] == [] and verdict["missed"] == []


# -- TestGkeLaunch ----------------------------------------------------------------


def test_launched_tpu_node_carries_gke_labels():
    def run(M):
        provider = M.gke.GkeCloudProvider()
        catalog = sorted(provider.get_instance_types(), key=lambda it: it.effective_price())
        tpu_types = [it for it in catalog if it.resources.get(M.gke.TPU_RESOURCE)]
        prov = M.f.make_provisioner()
        provider.default(prov.spec.constraints)
        c = prov.spec.constraints
        c.requirements = c.requirements.merge(M.catreq.catalog_requirements(catalog))
        node = provider.create(M.ctypes.NodeRequest(template=c, instance_type_options=tpu_types))
        return wire_doc(M, "nodes", node)

    node = both(run)
    labels = node["metadata"]["labels"]
    assert labels["cloud.google.com/gke-tpu-accelerator"] == "tpu-v5-lite-podslice"
    assert labels["cloud.google.com/gke-tpu-topology"] in ("1x1", "2x2", "2x4")
    assert node["spec"]["providerID"].startswith("gce://")


def test_defaulting_and_validation_hooks():
    def run(M):
        provider = M.gke.GkeCloudProvider()
        prov = M.f.make_provisioner()
        provider.default(prov.spec.constraints)
        od = prov.spec.constraints.requirements.get(M.lbl.CAPACITY_TYPE).has("on-demand")
        prov.spec.constraints.provider = {"project": "p", "bogus": 1}
        return od, provider.validate(prov.spec.constraints)

    od, errs = both(run)
    assert od and errs and "bogus" in errs[0]


@pytest.mark.parametrize("solver", ["ffd", "tpu"])
def test_end_to_end_tpu_provisioning(solver):
    """Pending TPU pods, the worker, the GKE provider, bound on a podslice."""
    def run(M):
        cluster = M.Cluster(clock=lambda: 1000.0)
        provider = M.gke.GkeCloudProvider()
        controller = M.prov.ProvisioningController(cluster, provider, start_workers=False,
                                                   **on_cpu(M, {}))
        cluster.create("provisioners", M.f.make_provisioner(solver=solver))
        controller.apply(cluster.get("provisioners", "default", namespace=""))
        worker = controller.workers["default"]
        pods = [M.f.make_pod(name=f"tpu-{i}", requests={"cpu": "4", M.gke.TPU_RESOURCE: "4"})
                for i in range(2)]
        for p in pods:
            cluster.create("pods", p)
            worker.batcher.add(p)
        worker.batcher.idle_duration = 0.05
        vnodes = worker.provision_once()
        controller.stop()
        return (plan(vnodes, pods), [p.spec.node_name for p in pods],
                [wire_doc(M, "nodes", n) for n in cluster.nodes()])

    vnodes, bound, nodes = both(run)
    assert sum(len(p) for _, p in vnodes) == 2 and all(b.startswith("gke-np-") for b in bound)
    assert all("cloud.google.com/gke-tpu-accelerator" in n["metadata"]["labels"] for n in nodes)


def test_unsatisfiable_offering_raises():
    def run(M):
        provider = M.gke.GkeCloudProvider()
        c = M.f.make_provisioner().spec.constraints
        c.requirements = c.requirements.add(M.O.NodeSelectorRequirement(
            key=M.lbl.TOPOLOGY_ZONE, operator="In", values=["us-central2-z"]))
        try:
            provider.create(M.ctypes.NodeRequest(template=c,
                                                 instance_type_options=provider.get_instance_types()))
        except ValueError as e:
            return str(e)

    assert "no offering" in both(run)


# -- TestGkeStockoutAndMultiHost -------------------------------------------------


def request(M, it, zones=None, capacity=("on-demand",), token=""):
    reqs = [M.O.NodeSelectorRequirement(key=M.lbl.CAPACITY_TYPE, operator="In",
                                        values=list(capacity))]
    if zones:
        reqs.append(M.O.NodeSelectorRequirement(key=M.lbl.TOPOLOGY_ZONE, operator="In",
                                                values=list(zones)))
    return M.ctypes.NodeRequest(template=M.prov_api.Constraints(
        requirements=M.Requirements.new(*reqs)), instance_type_options=[it], launch_token=token)


def itype(provider, name):
    return next(t for t in provider.get_instance_types() if t.name == name)


def pools(api) -> list:
    """The double's node-pool creates; a worker's launch tokens are random,
    so each host shows only whether one was stamped."""
    return [(p.name, p.machine_type, p.zone, p.spot, p.count, p.tpu_topology,
             [(i.name, i.node_pool, bool(i.launch_token)) for i in p.instances])
            for p in api.create_calls]


def test_stockout_falls_through_to_next_zone_and_ice_caches():
    def run(M):
        now = [0.0]
        api = M.gke.SimGkeAPI()
        provider = M.gke.GkeCloudProvider(api=api, clock=lambda: now[0])
        api.set_stockout("ct5lp-hightpu-4t", M.gke.ZONES[0])
        node = provider.create(request(M, itype(provider, "ct5lp-hightpu-4t")))

        def od_zones():
            return sorted({o.zone for t in provider.get_instance_types()
                           if t.name == "ct5lp-hightpu-4t"
                           for o in t.offerings if o.capacity_type == "on-demand"})

        cached = od_zones()
        now[0] += 46.0
        return wire_doc(M, "nodes", node), cached, od_zones(), pools(api)

    node, cached, later, _ = both(run)
    assert node["metadata"]["labels"]["topology.kubernetes.io/zone"] == "us-central2-b"
    assert "us-central2-a" not in cached and "us-central2-a" in later


def test_total_stockout_raises_classified_error():
    def run(M):
        api = M.gke.SimGkeAPI()
        provider = M.gke.GkeCloudProvider(api=api)
        for z in M.gke.ZONES:
            api.set_stockout("ct5lp-hightpu-1t", z)
        try:
            provider.create(request(M, itype(provider, "ct5lp-hightpu-1t")))
        except M.gke.GkeStockoutError as e:
            return type(e).__name__, len(api.create_calls)

    assert both(run) == ("GkeStockoutError", 0)


def test_stockout_is_never_retried_by_the_metered_provider():
    """``GkeStockoutError`` is non-retryable by name in both packages'
    ``default_retryable``: the metered create gives up on the first
    stockout, counts no retry, and the port draws no retry-budget token."""
    def run(M):
        api = M.gke.SimGkeAPI()
        inner = M.gke.GkeCloudProvider(api=api)
        for z in M.gke.ZONES:
            api.set_stockout("ct5lp-hightpu-1t", z)
        calls = []
        real = inner.create

        def counted(req):
            calls.append(req.launch_token)
            return real(req)

        inner.create = M.resilience.idempotent(counted)
        metered = M.cpm.decorate(inner)
        labels = {"dependency": "gke:create", "outcome": "retried"}
        before = M.metrics.REGISTRY.get_sample_value("karpenter_resilience_retries_total",
                                                     labels) or 0.0
        try:
            metered.create(request(M, itype(inner, "ct5lp-hightpu-1t")))
        except M.gke.GkeStockoutError:
            pass
        after = M.metrics.REGISTRY.get_sample_value("karpenter_resilience_retries_total",
                                                    labels) or 0.0
        return (len(calls), after - before, M.policy.default_retryable(M.gke.GkeStockoutError()),
                M.policy.default_retryable(M.gke.GkeApiError()),
                M.overload.default_retry_budget().remaining("gke:create"))

    assert both(run) == (1, 0.0, False, False, 10.0)


def test_multi_host_slice_is_one_atomic_pool():
    def run(M):
        api = M.gke.SimGkeAPI()
        provider = M.gke.GkeCloudProvider(api=api)
        req = request(M, itype(provider, "ct5lp-hightpu-4t-4x4"))
        nodes = [provider.create(req) for _ in range(4)]
        first = pools(api)
        provider.create(req)
        return [wire_doc(M, "nodes", n) for n in nodes], first, len(api.create_calls)

    nodes, first, after = both(run)
    assert len(first) == 1 and first[0][4] == 4 and first[0][5] == "4x4" and after == 2
    assert len({n["metadata"]["labels"]["cloud.google.com/gke-nodepool"] for n in nodes}) == 1
    assert len({n["metadata"]["name"] for n in nodes}) == 4


@pytest.mark.parametrize("solver", ["ffd", "tpu"])
def test_multi_host_workload_lands_as_n_bound_nodes(solver):
    """Four workers, one per host of a 4x4 podslice (``gke-tpu-topology``
    selector plus hostname anti-affinity): four nodes of one pool."""
    def run(M):
        api = M.gke.SimGkeAPI()
        provider = M.gke.GkeCloudProvider(api=api)
        cluster = M.Cluster(clock=lambda: 1000.0)
        controller = M.prov.ProvisioningController(cluster, provider, start_workers=False,
                                                   **on_cpu(M, {}))
        cluster.create("provisioners", M.f.make_provisioner(solver=solver))
        controller.reconcile("default")
        worker = controller.workers["default"]
        sel = {"job": "trainer"}
        pods = []
        for i in range(4):
            p = M.f.make_pod(
                name=f"worker-{i}", labels=sel, requests={"cpu": "8", M.gke.TPU_RESOURCE: "4"},
                node_selector={M.gke.GKE_TPU_TOPOLOGY_LABEL: "4x4"},
                pod_anti_requirements=[M.O.PodAffinityTerm(
                    label_selector=M.O.LabelSelector(match_labels=sel),
                    topology_key=M.lbl.HOSTNAME)])
            cluster.create("pods", p)
            pods.append(p)
            worker.add(p)
        worker.batcher.idle_duration = 0.05
        vnodes = worker.provision_once()
        controller.stop()
        return (plan(vnodes, pods), pools(api),
                sorted((n.metadata.labels[M.gke.GKE_NODEPOOL_LABEL],
                        n.metadata.labels[M.gke.GKE_TPU_TOPOLOGY_LABEL],
                        n.metadata.labels[M.lbl.INSTANCE_TYPE]) for n in cluster.nodes()),
                len({p.spec.node_name for p in pods if p.spec.node_name}))

    vnodes, made, nodes, bound = both(run)
    assert sum(len(p) for _, p in vnodes) == 4 and bound == 4
    assert len(made) == 1 and made[0][4] == 4
    assert nodes == [(made[0][0], "4x4", "ct5lp-hightpu-4t-4x4")] * 4


def test_concurrent_slice_launches_share_one_pool():
    import threading

    def run(M):
        api = M.gke.SimGkeAPI()
        provider = M.gke.GkeCloudProvider(api=api)
        req = request(M, itype(provider, "ct5lp-hightpu-4t-4x4"))
        nodes, lock, barrier = [], threading.Lock(), threading.Barrier(4)

        def launch():
            barrier.wait()
            n = provider.create(req)
            with lock:
                nodes.append(n.metadata.name)

        threads = [threading.Thread(target=launch) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return len(api.create_calls), sorted(nodes)

    calls, nodes = both(run)
    assert calls == 1 and len(set(nodes)) == 4


def test_delete_purges_pending_slice_siblings():
    def run(M):
        api = M.gke.SimGkeAPI()
        provider = M.gke.GkeCloudProvider(api=api)
        req = request(M, itype(provider, "ct5lp-hightpu-4t-4x4"))
        first = provider.create(req)
        pending = len(provider._pending_hosts)
        provider.delete(first)
        left = (dict(provider._pending_hosts), dict(api.node_pools))
        provider.create(req)
        return pending, left, len(api.create_calls)

    assert both(run) == (1, ({}, {}), 2)


# -- TestIdempotentCreateGke, in process and over the wire ----------------------


@contextlib.contextmanager
def gke_env(M, transport):
    api = M.gke.SimGkeAPI()
    if transport == "http":
        server = M.http.GkeAPIServer(api).start()
        try:
            yield api, M.gke.GkeCloudProvider(api=M.http.HttpGkeAPI(server.url, backoff_base=0.01))
        finally:
            server.stop()
    else:
        yield api, M.gke.GkeCloudProvider(api=api)


def catalog_constraints(M, provider):
    c = M.prov_api.Constraints(requirements=M.Requirements.new())
    provider.default(c)
    catalog = provider.get_instance_types()
    c.requirements = c.requirements.merge(M.catreq.catalog_requirements(catalog))
    return c, catalog


@pytest.mark.parametrize("transport", ["inproc", "http"])
def test_same_token_same_host_no_second_pool(transport):
    def run(M):
        with gke_env(M, transport) as (api, provider):
            c, catalog = catalog_constraints(M, provider)
            req = M.ctypes.NodeRequest(template=c, instance_type_options=catalog,
                                       launch_token="tok-gke")
            n1, n2 = provider.create(req), provider.create(req)
            return (n1.metadata.name == n2.metadata.name, len(api.node_pools),
                    n1.metadata.annotations[M.lbl.LAUNCH_TOKEN_ANNOTATION])

    assert both(run) == (True, 1, "tok-gke")


@pytest.mark.parametrize("transport", ["inproc", "http"])
def test_multi_host_sibling_claims_stamp_their_own_tokens(transport):
    def run(M):
        with gke_env(M, transport) as (api, provider):
            c, catalog = catalog_constraints(M, provider)
            multi = [it for it in catalog if M.gke.slice_hosts(it.name) > 1]
            it = min(multi, key=lambda t: M.gke.slice_hosts(t.name))
            nodes = [provider.create(M.ctypes.NodeRequest(
                template=c, instance_type_options=[it], launch_token=f"tok-h{i}"))
                for i in range(M.gke.slice_hosts(it.name))]
            live = {i.id: i.launch_token for i in provider.list_instances()}
            return len(api.node_pools), [live[n.metadata.name] for n in nodes]

    assert both(run) == (1, ["tok-h0", "tok-h1", "tok-h2", "tok-h3"])


def test_wire_create_is_idempotent_only_when_tokened():
    def run(M):
        with gke_env(M, "http") as (api, provider):
            pool1 = provider.api.create_node_pool("n2-standard-8", "us-central1-a", False, 1,
                                                  launch_token="t-1")
            pool2 = provider.api.create_node_pool("n2-standard-8", "us-central1-a", False, 1,
                                                  launch_token="t-1")
            loose = provider.api.create_node_pool("n2-standard-8", "us-central1-a", False, 1)
            return pool1.name == pool2.name, pool1.name == loose.name, len(api.node_pools)

    assert both(run) == (True, False, 2)
