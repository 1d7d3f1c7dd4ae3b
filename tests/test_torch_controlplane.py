"""The port's control plane as a whole, against the JAX package's.

- The five ported controllers (provisioning, selection with
  ``wait=False``, counter, pvc, under a ``Manager``) wired as the
  reference's ``main.py`` wires them, driven by a seeded 300-pod storm of
  watch events in both packages: every pod bound once, no node over its
  allocatable, nodes equal to launched virtual nodes, the counter's
  ``status.resources`` equal to the nodes' summed capacity, PVCs
  annotated. The same pods inline give the same bound state in both.
- ``MeteredCloudProvider``: retries and the per-method breaker under a
  seeded failing delegate, with the ``RESILIENCE_RETRIES`` and
  short-circuit deltas equal to the reference's.
- The card rule: a ``solver: ffd`` controller is built and provisions with
  no card; a ``solver: tpu`` solve on ``cuda`` without one raises, and
  nothing launches.
- Selection's statics prewarm from many threads gives the statics a
  serial build gives.
"""

import importlib
import random
import sys
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from torch_parity import PACKAGES, fresh_router, pinned  # noqa: F401

PORT = "karpenter_tpu_torch"


def mods(pkg):
    def m(name):
        return importlib.import_module(f"{pkg}.{name}")

    return SimpleNamespace(
        pkg=pkg, Cluster=m("kube.client").Cluster, fake=m("cloudprovider.fake"),
        cpmetrics=m("cloudprovider.metrics"), types=m("cloudprovider.types"),
        manager=m("controllers.manager"), prov=m("controllers.provisioning"),
        sel=m("controllers.selection"), counter=m("controllers.counter"), pvc=m("controllers.pvc"),
        f=m("testing.factories"), O=m("api.objects"), lbl=m("api.labels"), res=m("utils.resources"),
        metrics=m("metrics"), resilience=m("resilience"), statics=m("scheduling.statics"),
    )


def wire(M, cluster, provider, start_workers=True, **kw):
    """The reference main.py's wiring of the five controllers."""
    if M.pkg == PORT:
        kw.setdefault("device", "cpu")
    manager = M.manager.Manager(cluster)
    provisioning = M.prov.ProvisioningController(
        cluster, M.cpmetrics.decorate(provider), start_workers=start_workers, **kw)
    selection = M.sel.SelectionController(cluster, provisioning, wait=False)
    counter = M.counter.CounterController(cluster)
    pvc = M.pvc.PVCController(cluster)
    manager.register("provisioning", provisioning.reconcile, concurrency=10)
    manager.register("selection", selection.reconcile, concurrency=32)
    manager.register("counter", counter.reconcile, concurrency=2)
    manager.register("pvc", pvc.reconcile, concurrency=2)
    cluster.watch("provisioners", lambda e, o: manager.enqueue("provisioning", o.metadata.name))
    cluster.watch("pods", lambda e, o: manager.enqueue(
        "selection", (o.metadata.name, o.metadata.namespace)))
    counter.register(manager)
    pvc.register(manager)
    return manager, provisioning


def storm_pods(M, n, seed):
    rng = random.Random(seed)
    return [M.f.make_pod(name=f"storm-{i}", requests={"cpu": f"{rng.choice([0.25, 0.5, 1])}"})
            for i in range(n)]


def milli(rl):
    return {k: round(v * 1000) for k, v in rl.items()}


def storm(pkg, solver, n=300):
    M = mods(pkg)
    cluster = M.Cluster()
    provider = M.fake.FakeCloudProvider(M.fake.instance_types(20))
    cluster.create("pvcs", M.f.make_pvc(name="data"))
    binds = {}
    real_bind = cluster.bind

    def counting_bind(pod, node):
        binds[pod.key] = binds.get(pod.key, 0) + 1
        real_bind(pod, node)

    cluster.bind = counting_bind
    manager, provisioning = wire(M, cluster, provider)
    with pinned(pkg):
        manager.start()
        try:
            cluster.create("provisioners", M.f.make_provisioner(solver=solver))
            deadline = time.time() + 30
            while time.time() < deadline and not provisioning.workers:
                time.sleep(0.01)
            worker = provisioning.workers["default"]
            worker.batcher.idle_duration = 0.05
            worker.batcher.max_items = 120
            if solver == "tpu":
                assert worker.warmed.wait(timeout=120)
            pods = storm_pods(M, n, 5)
            pods[0].spec.volumes = [M.O.Volume(name="v", persistent_volume_claim="data")]
            for p in pods:
                cluster.create("pods", p)
            deadline = time.time() + 120
            while time.time() < deadline and not all(p.spec.node_name for p in pods):
                time.sleep(0.02)
            nodes = cluster.nodes()
            capacity = {}
            for node in nodes:
                capacity = M.res.merge(capacity, node.status.capacity)
            deadline = time.time() + 30
            while time.time() < deadline and milli(
                    cluster.get("provisioners", "default", namespace="").status.resources) != milli(capacity):
                time.sleep(0.02)
            deadline = time.time() + 30
            pvc = cluster.get("pvcs", "data")
            while time.time() < deadline and pvc.metadata.annotations.get(
                    M.pvc.SELECTED_NODE_ANNOTATION) != pods[0].spec.node_name:
                time.sleep(0.02)
        finally:
            manager.stop()
            provisioning.stop()
    fits = all(
        M.res.fits(M.res.requests_for_pods(*cluster.pods_on_node(n.metadata.name)), n.status.allocatable)
        for n in nodes)
    return SimpleNamespace(
        bound=sum(1 for p in pods if p.spec.node_name), twice=[k for k, c in binds.items() if c > 1],
        fits=fits, nodes=len(nodes), creates=len(provider.create_calls),
        counted=milli(cluster.get("provisioners", "default", namespace="").status.resources),
        capacity=milli(capacity),
        pvc=cluster.get("pvcs", "data").metadata.annotations.get(M.pvc.SELECTED_NODE_ANNOTATION)
        == pods[0].spec.node_name,
        healthy=manager.healthz(),
    )


@pytest.mark.parametrize("solver", ["tpu", "ffd"])
def test_manager_storm_holds_the_invariants_in_both_packages(solver):
    for pkg in PACKAGES:
        out = storm(pkg, solver)
        assert out.bound == 300 and out.twice == [], pkg
        assert out.fits and out.nodes == out.creates >= 1, pkg
        assert out.counted == out.capacity and out.counted, pkg
        assert out.pvc, pkg
        assert not out.healthy  # stopped


def inline_storm(pkg, solver, n=300, batch=120):
    """The storm's pods through one worker inline, in batches."""
    M = mods(pkg)
    cluster = M.Cluster()
    manager, provisioning = wire(M, cluster, M.fake.FakeCloudProvider(M.fake.instance_types(20)),
                                 start_workers=False)
    prov = M.f.make_provisioner(solver=solver)
    cluster.create("provisioners", prov)
    manager.reconcile_now("provisioning", "default")
    worker = provisioning.workers["default"]
    worker.batcher.idle_duration = 0.01
    worker.batcher.max_items = batch
    pods = storm_pods(M, n, 5)
    with pinned(pkg):
        for p in pods:
            cluster.create("pods", p)
            manager.reconcile_now("selection", (p.metadata.name, p.metadata.namespace))
        while worker.batcher.depth():
            worker.provision_once()
    manager.reconcile_now("counter", "default")
    provisioning.stop()
    groups = {}
    for i, p in enumerate(pods):
        groups.setdefault(p.spec.node_name, []).append(i)
    nodes = {}
    for name, idxs in groups.items():
        node = cluster.get("nodes", name, namespace="")
        nodes[tuple(idxs)] = (node.metadata.labels, [(t.key, t.effect) for t in node.spec.taints],
                              node.metadata.finalizers)
    status = cluster.get("provisioners", "default", namespace="").status
    return nodes, milli(status.resources), status.condition().status


@pytest.mark.parametrize("solver", ["tpu", "ffd"])
def test_inline_storm_equals_the_reference(solver):
    ref, port = (inline_storm(pkg, solver) for pkg in PACKAGES)
    assert port == ref
    assert "" not in {n for n in port[0]} and port[1] and port[2] == "True"


def test_manager_requeues_and_backs_off_like_the_reference():
    traces = []
    for pkg in PACKAGES:
        M = mods(pkg)
        manager = M.manager.Manager(M.Cluster())
        calls = []
        done = threading.Event()

        def reconcile(key, calls=calls, done=done, M=M):
            calls.append(key)
            if key == "boom" and calls.count("boom") < 3:
                raise RuntimeError("retry me")
            if key == "again" and calls.count("again") < 2:
                return 0.05
            if key == "conflict" and calls.count("conflict") < 2:
                raise importlib.import_module(f"{M.pkg}.kube.client").Conflict("stale")
            if {"boom", "again", "conflict"} <= set(calls) and calls.count("boom") >= 3 \
                    and calls.count("again") >= 2 and calls.count("conflict") >= 2:
                done.set()
            return None

        manager.register("c", reconcile, concurrency=1)
        with pytest.raises(ValueError):
            manager.register("c", reconcile)
        manager.start()
        for key in ("boom", "again", "conflict"):
            manager.enqueue("c", key)
        manager.enqueue("missing", "ignored")
        assert done.wait(timeout=10)
        assert manager.healthz() and manager.readyz()
        manager.stop()
        assert not manager.healthz()
        assert manager.reconcile_now("c", "inline") is None
        traces.append(sorted((k, calls.count(k)) for k in set(calls)))
    assert traces[0] == traces[1]


def test_reconciling_controller_is_set_around_each_reconcile():
    """Run in a fresh context: a controller reconciled inline by an earlier
    test in this process (the warm pool's and the GC's reconcile set the
    variable and leave it, as the reference's do) must not leak in."""
    import contextvars

    def body():
        M = mods(PORT)
        manager = M.manager.Manager(M.Cluster())
        seen = []
        manager.register("named", lambda key: seen.append(M.cpmetrics.reconciling_controller.get()))
        manager.reconcile_now("named", "k")
        assert seen == ["named"] and M.cpmetrics.reconciling_controller.get() == ""

    contextvars.Context().run(body)


# -- MeteredCloudProvider -------------------------------------------------------


def sample(M, name, labels):
    return M.metrics.REGISTRY.get_sample_value(name, labels) or 0.0


def metered_trace(pkg, pattern, methods, token_aware=True):
    """Calls through a decorated provider whose delegate fails per
    ``pattern`` (one bool per delegate call: True fails); returns each
    logical call's outcome, the delegate's call counts and the metric
    deltas."""
    M = mods(pkg)
    M.resilience.reset_default_retry_budget()
    fails = list(pattern)
    calls = {"create": 0, "delete": 0, "get_instance_types": 0}

    def maybe_fail(method):
        calls[method] += 1
        if fails and fails.pop(0):
            raise RuntimeError(f"injected {method} failure")

    class Flaky(M.fake.FakeCloudProvider):
        def create(self, request):
            maybe_fail("create")
            return super().create(request)

        def delete(self, node):
            maybe_fail("delete")
            return super().delete(node)

        def get_instance_types(self, provider=None):
            maybe_fail("get_instance_types")
            return super().get_instance_types(provider)

        def name(self):
            return "flaky"

    if token_aware:
        Flaky.create = M.resilience.idempotent(Flaky.create)
    provider = M.cpmetrics.decorate(Flaky(M.fake.instance_types(3)))
    for policy in provider._policies.values():
        policy._sleep = lambda s: None
    assert M.cpmetrics.decorate(provider) is provider
    labels = {m: {"dependency": f"flaky:{m}", "outcome": "retried"} for m in calls}
    before = {m: sample(M, "karpenter_resilience_retries_total", labels[m]) for m in calls}
    sc_before = {m: sample(M, "karpenter_cloudprovider_breaker_shortcircuit_total",
                           {"provider": "flaky", "method": m}) for m in calls}
    prov = M.f.make_provisioner()
    catalog = M.fake.instance_types(3)
    outcomes = []
    for method in methods:
        try:
            if method == "create":
                req = M.types.NodeRequest(template=prov.spec.constraints,
                                          instance_type_options=catalog[:1])
                node = provider.create(req)
                outcomes.append(("ok", bool(node.metadata.annotations.get(M.lbl.LAUNCH_TOKEN_ANNOTATION))))
            elif method == "delete":
                provider.delete(M.f.make_node(name="gone"))
                outcomes.append(("ok", None))
            else:
                outcomes.append(("ok", len(provider.get_instance_types())))
        except Exception as e:  # noqa: BLE001 — the outcome is the class
            outcomes.append((type(e).__name__, None))
    return (outcomes, calls,
            {m: sample(M, "karpenter_resilience_retries_total", labels[m]) - before[m] for m in calls},
            {m: sample(M, "karpenter_cloudprovider_breaker_shortcircuit_total",
                       {"provider": "flaky", "method": m}) - sc_before[m] for m in calls},
            sorted(provider.breakers.open_dependencies()))


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_metered_retries_equal_the_reference(seed):
    rng = random.Random(seed)
    pattern = [rng.random() < 0.4 for _ in range(60)]
    methods = [rng.choice(["create", "delete", "get_instance_types"]) for _ in range(24)]
    ref, port = (metered_trace(pkg, pattern, methods) for pkg in PACKAGES)
    assert port == ref
    assert sum(port[2].values()) > 0


def test_dead_delegate_opens_the_breaker_like_the_reference():
    methods = ["get_instance_types"] * 8
    ref, port = (metered_trace(pkg, [True] * 100, methods) for pkg in PACKAGES)
    assert port == ref
    outcomes, calls, retries, short, open_deps = port
    # 5 logical failures (3 attempts each) trip it; the rest fail fast
    assert [o[0] for o in outcomes] == ["RuntimeError"] * 5 + ["BreakerOpen"] * 3
    assert calls["get_instance_types"] == 15 and retries["get_instance_types"] == 10
    assert short["get_instance_types"] == 3 and open_deps == ["flaky:get_instance_types"]


def test_token_unaware_create_is_never_retried_like_the_reference():
    ref, port = (metered_trace(pkg, [True, False], ["create", "create"], token_aware=False)
                 for pkg in PACKAGES)
    assert port == ref
    assert port[0] == [("RuntimeError", None), ("ok", True)] and port[2]["create"] == 0


def test_non_retryable_errors_pass_through_and_keep_the_breaker_closed():
    for pkg in PACKAGES:
        M = mods(pkg)

        class InsufficientCapacityError(Exception):
            pass

        class Stockout(M.fake.FakeCloudProvider):
            n = 0

            def get_instance_types(self, provider=None):
                self.n += 1
                raise InsufficientCapacityError("ice")

        delegate = Stockout()
        provider = M.cpmetrics.decorate(delegate)
        for _ in range(8):
            with pytest.raises(InsufficientCapacityError):
                provider.get_instance_types()
        assert delegate.n == 8 and provider.breakers.open_dependencies() == []


def test_budget_caps_the_retry_deadline_like_the_reference():
    """An expired round budget leaves one attempt, and counts the deadline."""
    for pkg in PACKAGES:
        M = mods(pkg)
        labels = {"dependency": "dep"}
        before = sample(M, "karpenter_resilience_deadline_exceeded_total", labels)
        policy = M.resilience.RetryPolicy(max_attempts=3, deadline=15.0, dependency="dep",
                                          sleep=lambda s: None)
        calls = []

        def fail():
            calls.append(1)
            raise RuntimeError("x")

        with M.resilience.Budget(0.0).activate():
            with pytest.raises(RuntimeError):
                policy.call(fail)
        assert len(calls) == 1
        assert sample(M, "karpenter_resilience_deadline_exceeded_total", labels) - before == 1.0


# -- the card rule ----------------------------------------------------------------


def test_ffd_controller_needs_no_card():
    M = mods(PORT)
    cluster = M.Cluster()
    # the default device: cuda, which this check must never need
    ctl = M.prov.ProvisioningController(cluster, M.fake.FakeCloudProvider(M.fake.instance_types(10)),
                                        start_workers=False)
    cluster.create("provisioners", M.f.make_provisioner(solver="ffd"))
    assert ctl.reconcile("default") == 300.0
    worker = ctl.workers["default"]
    worker.batcher.idle_duration = 0.01
    pods = [M.f.make_pod(requests={"cpu": "1"}) for _ in range(5)]
    for p in pods:
        cluster.create("pods", p)
        worker.add(p)
    assert worker.provision_once()
    ctl.stop()
    assert all(p.spec.node_name for p in pods)
    assert worker.scheduler.device.type == "cuda" and worker.scheduler._torch is None


def test_tpu_solve_on_cuda_needs_a_card():
    M = mods(PORT)
    cluster = M.Cluster()
    ctl = M.prov.ProvisioningController(cluster, M.fake.FakeCloudProvider(M.fake.instance_types(10)),
                                        start_workers=False, device="cuda")
    cluster.create("provisioners", M.f.make_provisioner(solver="tpu"))
    ctl.reconcile("default")
    worker = ctl.workers["default"]
    worker.batcher.idle_duration = 0.01
    pods = [M.f.make_pod(requests={"cpu": "1"}) for _ in range(5)]
    for p in pods:
        cluster.create("pods", p)
        worker.add(p)
    try:
        if torch.cuda.is_available():
            assert worker.provision_once()
            assert worker.scheduler.last_stage_profile()["packer_backend"] == "pack_first_fit"
        else:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                worker.provision_once()
            assert cluster.nodes() == [] and not any(p.spec.node_name for p in pods)
            assert not worker.is_pending(pods[0].key)  # the round's pending state cleared
    finally:
        ctl.stop()


# -- statics prewarmed from the selection pool -------------------------------------


def test_concurrent_statics_prewarm_equals_a_serial_build():
    """32 threads build the statics of template-sharing pods at once (as
    selection's reconcile pool does); the encoded batch equals the one
    built from a serial prewarm."""
    from torch_parity import encode_scenario, fields

    M = mods(PORT)
    scenarios = importlib.import_module(f"{PORT}.testing.scenarios")
    catalog = M.fake.instance_types(30)
    prov = M.f.make_provisioner(solver="tpu")
    serial = scenarios.diverse_pods(600, random.Random(8))
    for p in serial:
        M.statics.statics(p)
    shared = scenarios.diverse_pods(600, random.Random(8))
    barrier = threading.Barrier(32)
    errors = []

    def prewarm(chunk):
        try:
            barrier.wait(timeout=30)
            for p in chunk:
                M.statics.statics(p)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=prewarm, args=(shared[i::32],)) for i in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not errors and not any(t.is_alive() for t in threads)
    np.testing.assert_equal(fields(encode_scenario(PORT, prov, catalog, shared)),
                            fields(encode_scenario(PORT, prov, catalog, serial)))


# -- the brownout ladder's provisioning surface ---------------------------------


def brownout_trace(pkg):
    """A real controller's worker batcher under the brownout ladder: the
    window pressure per rung, the shed of queued low-priority pods at the
    top rung (each a PodShed event), and the full reversal."""
    M = mods(pkg)
    brownout = importlib.import_module(f"{pkg}.resilience.brownout")
    M.obs = importlib.import_module(f"{pkg}.obs")
    M.obs.reset_for_tests()
    cluster = M.Cluster()
    kw = {"device": "cpu"} if pkg == PORT else {}
    ctl = M.prov.ProvisioningController(
        cluster, M.fake.FakeCloudProvider(M.fake.instance_types(5)), start_workers=False, **kw)
    cluster.create("provisioners", M.f.make_provisioner())
    ctl.reconcile("default")
    worker = ctl.workers["default"]
    for name, pclass in (("low", "best-effort"), ("mid", ""), ("high", "high")):
        worker.add(M.f.make_pod(name=name, requests={"cpu": "1"}, priority_class_name=pclass))
    burning = [True]
    ladder = brownout.BrownoutController(
        burning_fn=lambda: burning[0], provisioning=ctl, cluster=cluster,
        escalate_after=1, recover_after=1)
    out = []
    for _ in range(brownout.MAX_LEVEL):
        out.append((ladder.tick(), worker.batcher.pressure(), worker.batcher.depth()))
    burning[0] = False
    for _ in range(brownout.MAX_LEVEL):
        out.append((ladder.tick(), worker.batcher.pressure(), worker.batcher.depth()))
    out.append((sorted(e.reason for e in cluster.list("events")),
                worker.is_pending("default/low"), worker.is_pending("default/high")))
    ctl.stop()
    M.obs.reset_for_tests()
    return out


def test_brownout_drives_the_workers_batchers_like_the_reference():
    ref, port = (brownout_trace(pkg) for pkg in PACKAGES)
    assert port == ref
    assert port[3][2] == 2  # the top rung shed the best-effort pod
    assert port[7][:2] == (0, 1.0)
    reasons, low_pending, high_pending = port[-1]
    assert "PodShed" in reasons and not low_pending and high_pending
