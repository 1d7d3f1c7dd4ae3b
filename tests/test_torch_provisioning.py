"""The port's provisioning slice against the JAX package's: pending pods →
batcher → worker → ``Scheduler.solve`` → the fake cloud provider → Node
create + pod bind, then the counter.

The reference's ``tests/test_provisioning.py`` cases run on both packages
(the port's controller on ``device="cpu"``). Inline rounds of the same
seeded pods must give the same bound state in both packages, for
``solver: tpu`` and ``solver: ffd``: the partition of pods into nodes by
pod index, each node's labels (save the values ``Constraints.to_node``
draws at random for an ``Exists`` requirement), taints and finalizers, the
unplaced pods, the provisioner's ``status.resources`` and its Active
condition in wire form. The JAX side packs with its lax.scan kernel, the
port with its plain PyTorch version (``torch_parity.pinned``).
"""

import importlib
import random
import time
from types import SimpleNamespace

import pytest

from torch_parity import PACKAGES, fresh_router, packer, pinned  # noqa: F401

PORT = "karpenter_tpu_torch"


def mods(pkg):
    def m(name):
        return importlib.import_module(f"{pkg}.{name}")

    fake = m("cloudprovider.fake")
    return SimpleNamespace(
        pkg=pkg, Cluster=m("kube.client").Cluster, fake=fake, FakeCloudProvider=fake.FakeCloudProvider,
        prov=m("controllers.provisioning"), counter=m("controllers.counter"),
        cpmetrics=m("cloudprovider.metrics"), res=m("utils.resources"), lbl=m("api.labels"),
        f=m("testing.factories"), scenarios=m("testing.scenarios"), serde=m("kube.serde"),
        metrics=m("metrics"), api=m("api.provisioner"), objects=m("api.objects"),
        batcher=m("utils.batcher"),
    )


def controller(M, cluster, provider, **kw):
    """A ProvisioningController of package ``M`` (the port's on the CPU)."""
    if M.pkg == PORT:
        kw.setdefault("device", "cpu")
    return M.prov.ProvisioningController(cluster, provider, **kw)


def provision(M, pods, provisioner=None, catalog=None, cluster=None, provider=None):
    """One synchronous provision cycle (the reference's ExpectProvisioned)."""
    cluster = cluster or M.Cluster()
    provider = provider or M.FakeCloudProvider(catalog or M.fake.instance_types(20))
    ctl = controller(M, cluster, provider, start_workers=False)
    provisioner = provisioner or M.f.make_provisioner()
    cluster.create("provisioners", provisioner)
    for p in pods:
        cluster.create("pods", p)
    ctl.apply(provisioner)
    worker = ctl.workers[provisioner.name]
    for p in pods:
        worker.batcher.add(p)
    worker.batcher.idle_duration = 0.01
    with pinned(M.pkg):
        nodes = worker.provision_once()
    ctl.stop()
    return cluster, provider, nodes


@pytest.fixture(params=PACKAGES)
def M(request):
    return mods(request.param)


# -- the reference's cases, on both packages ---------------------------------


def test_pods_bound_and_nodes_created(M):
    pods = [M.f.make_pod(requests={"cpu": "1"}) for _ in range(4)]
    cluster, provider, vnodes = provision(M, pods)
    assert len(provider.create_calls) == len(vnodes) >= 1
    assert len(cluster.nodes()) == len(vnodes)
    assert all(p.spec.node_name for p in cluster.pods())


def test_node_has_startup_taint_finalizer_and_label(M):
    cluster, provider, _ = provision(M, [M.f.make_pod(requests={"cpu": "1"})])
    node = cluster.nodes()[0]
    assert any(t.key == M.lbl.NOT_READY_TAINT_KEY for t in node.spec.taints)
    assert M.lbl.TERMINATION_FINALIZER in node.metadata.finalizers
    assert node.metadata.labels[M.lbl.PROVISIONER_NAME_LABEL] == "default"
    assert M.lbl.INSTANCE_TYPE in node.metadata.labels
    token = node.metadata.annotations[M.lbl.LAUNCH_TOKEN_ANNOTATION]
    assert provider.create_calls[0].launch_token == token


def test_already_scheduled_pods_skipped(M):
    pod = M.f.make_pod(requests={"cpu": "1"}, node_name="existing", unschedulable=False)
    assert not M.prov.is_provisionable(pod)
    cluster, provider, vnodes = provision(M, [pod])
    assert vnodes == [] and provider.create_calls == []


def test_limits_block_launch(M):
    provisioner = M.f.make_provisioner(limits={"cpu": "4"})
    provisioner.status.resources = {M.res.CPU: 4.0}  # already at the limit
    cluster, provider, vnodes = provision(M, [M.f.make_pod(requests={"cpu": "1"})],
                                          provisioner=provisioner)
    assert len(vnodes) == 1  # the solve ran; the launch was gated
    assert provider.create_calls == [] and cluster.nodes() == []
    assert cluster.get("provisioners", "default", namespace="").status.last_scale_time is None


def test_tpu_solver_end_to_end(M):
    pods = [M.f.make_pod(requests={"cpu": "1"}) for _ in range(4)]
    cluster, provider, vnodes = provision(M, pods, provisioner=M.f.make_provisioner(solver="tpu"))
    assert len(cluster.nodes()) == len(vnodes) >= 1
    assert all(p.spec.node_name for p in cluster.pods())


def test_worker_hot_swap_on_spec_change(M):
    cluster = M.Cluster()
    ctl = controller(M, cluster, M.FakeCloudProvider(M.fake.instance_types(5)), start_workers=False)
    prov = M.f.make_provisioner()
    cluster.create("provisioners", prov)
    ctl.apply(prov)
    w1 = ctl.workers["default"]
    ctl.apply(prov)  # unchanged spec → same worker, refreshed provisioner
    assert ctl.workers["default"] is w1
    ctl.apply(M.f.make_provisioner(labels={"team": "a"}))
    w2 = ctl.workers["default"]
    assert w2 is not w1 and w1.batcher._stopped and not w2.batcher._stopped
    assert w2.scheduler is not w1.scheduler
    ctl.stop()
    assert w2.batcher._stopped and ctl.workers == {}


def test_reconcile_teardown_on_delete(M):
    cluster = M.Cluster()
    ctl = controller(M, cluster, M.FakeCloudProvider(M.fake.instance_types(5)), start_workers=False)
    cluster.create("provisioners", M.f.make_provisioner())
    assert ctl.reconcile("default") == M.prov.REQUEUE_INTERVAL == 300.0
    assert "default" in ctl.workers
    cluster.delete("provisioners", "default", namespace="")
    assert ctl.reconcile("default") is None
    assert "default" not in ctl.workers
    ctl.stop()


def test_spec_hash_equals_the_reference():
    hashes = []
    for pkg in PACKAGES:
        M = mods(pkg)
        O = M.objects
        variants = [
            M.f.make_provisioner(),
            M.f.make_provisioner(labels={"team": "a"}),
            M.f.make_provisioner(taints=[O.Taint(key="k", value="v")]),
            M.f.make_provisioner(limits={"cpu": "10"}),
            M.f.make_provisioner(solver="tpu"),
            M.f.make_provisioner(ttl_after_empty=30),
            M.f.make_provisioner(requirements=[O.NodeSelectorRequirement(
                key=M.lbl.TOPOLOGY_ZONE, operator="In", values=["test-zone-1"])]),
        ]
        hs = [M.prov.spec_hash(p) for p in variants]
        assert len(set(hs)) == len(hs)
        assert M.prov.spec_hash(M.f.make_provisioner()) == hs[0]
        hashes.append(hs)
    assert hashes[0] == hashes[1]


# -- inline rounds: the bound state equals the reference's -------------------


def bound_state(M, cluster, pods, prov_name):
    groups = {}
    for i, p in enumerate(pods):
        groups.setdefault(p.spec.node_name, []).append(i)
    unbound = groups.pop("", [])
    random_keys = {k for k, vs in cluster.get("provisioners", prov_name, namespace="")
                   .spec.constraints.requirements._sets if vs.op_type() == "Exists"}
    nodes = {}
    for name, idxs in groups.items():
        n = cluster.get("nodes", name, namespace="")
        labels = {k: ("<random>" if k in random_keys else v) for k, v in n.metadata.labels.items()}
        nodes[tuple(idxs)] = (labels, sorted((t.key, t.value, t.effect) for t in n.spec.taints),
                              sorted(n.metadata.finalizers), dict(n.status.capacity))
    prov = cluster.get("provisioners", prov_name, namespace="")
    wire = M.serde.to_wire("provisioners", prov)["status"]
    conditions = [{k: v for k, v in c.items() if k != "lastTransitionTime"}
                  for c in wire.get("conditions", [])]
    return nodes, unbound, dict(prov.status.resources), conditions, prov.status.last_scale_time is not None


def inline(pkg, solver, name, n_pods, seed, batch, requirements=None):
    """Seeded pods through one controller's worker in rounds of ``batch``,
    then the counter; returns the bound state and the rounds' kernels."""
    M = mods(pkg)
    O = M.objects
    if name == "teams":
        catalog = M.fake.instance_types_tradeoff(64)
        rng = random.Random(seed)
        pods = [M.f.make_pod(requests={"cpu": f"{rng.choice([0.25, 0.5, 1])}"},
                             node_selector={"team": f"t{i % 24}"}) for i in range(n_pods)]
    else:
        catalog = M.fake.instance_types(40)
        pods = M.scenarios.diverse_pods(n_pods, random.Random(seed))
    if requirements == "team-exists":
        requirements = [O.NodeSelectorRequirement(key="team", operator="Exists")]
    prov = M.f.make_provisioner(solver=solver, requirements=requirements)
    cluster = M.Cluster()
    provider = M.cpmetrics.decorate(M.FakeCloudProvider(catalog))
    ctl = controller(M, cluster, provider, start_workers=False)
    cluster.create("provisioners", prov)
    ctl.reconcile(prov.name)
    worker = ctl.workers[prov.name]
    worker.batcher.idle_duration = 0.01
    worker.batcher.max_items = batch
    sched = worker.scheduler
    sched.ffd.topology.rng = random.Random(1)
    if solver == "tpu":
        backend = sched.torch if pkg == PORT else sched._tpu_scheduler()
        backend.topology.rng = random.Random(1)
    for p in pods:
        cluster.create("pods", p)
        worker.add(p)
    kernels = []
    with pinned(pkg):
        while worker.batcher.depth():
            worker.provision_once()
            kernels.append(sched.last_stage_profile().get("packer_backend"))
    M.counter.CounterController(cluster).reconcile(prov.name)
    ctl.stop()
    return bound_state(M, cluster, pods, prov.name), kernels


@pytest.mark.parametrize("solver", ["tpu", "ffd"])
@pytest.mark.parametrize("name,n_pods,batch,requirements", [
    ("diverse", 500, 200, None),
    ("teams", 300, 120, None),
    ("teams", 240, 240, "team-exists"),
])
def test_inline_rounds_equal_the_reference(solver, name, n_pods, batch, requirements):
    (ref, ref_kernels), (out, kernels) = (
        inline(pkg, solver, name, n_pods, 42, batch, requirements) for pkg in PACKAGES)
    nodes, unbound, resources, conditions, scaled = out
    assert nodes == ref[0]
    assert unbound == ref[1]
    assert resources == ref[2] and resources
    assert conditions == ref[3] == [{"type": "Active", "status": "True"}]
    assert scaled and ref[4]
    assert len(kernels) == len(ref_kernels) == -(-n_pods // batch)
    if solver == "tpu":
        want = "pack_v2_reference" if name == "teams" else "pack_reference"
        assert set(kernels) == {want}
    else:
        assert set(kernels) == {None} == set(ref_kernels)


def test_full_width_headline_in_batches_equals_the_reference():
    """The card smoke's inline headline (10,000 diverse pods x 400 types in
    batches of 2,000) through both packages' controllers on their native
    packers: the same nodes and the same 1,428 pods left unplaced (zone
    anti-affinity and affinity terms that earlier batches' nodes settle)."""
    states = []
    for pkg in PACKAGES:
        M = mods(pkg)
        pods = M.scenarios.diverse_pods(10000, random.Random(42))
        cluster = M.Cluster()
        ctl = controller(M, cluster, M.cpmetrics.decorate(M.FakeCloudProvider(M.fake.instance_types(400))),
                         start_workers=False)
        cluster.create("provisioners", M.f.make_provisioner(solver="tpu"))
        ctl.reconcile("default")
        worker = ctl.workers["default"]
        worker.batcher.idle_duration = 0.01
        sched = worker.scheduler
        (sched.torch if pkg == PORT else sched._tpu_scheduler()).topology.rng = random.Random(1)
        for p in pods:
            cluster.create("pods", p)
            worker.add(p)
        rounds = 0
        with packer("native"):
            while worker.batcher.depth():
                worker.provision_once()
                rounds += 1
        M.counter.CounterController(cluster).reconcile("default")
        ctl.stop()
        states.append((rounds, bound_state(M, cluster, pods, "default")))
    assert states[0] == states[1]
    rounds, (nodes, unbound, resources, _, _) = states[1]
    assert (rounds, len(nodes), len(unbound)) == (5, 444, 1428)


def test_decorated_provider_rounds_equal_the_bare_provider():
    """cpmetrics.decorate changes nothing a round decides."""
    states = []
    for decorate in (True, False):
        M = mods(PORT)
        pods = M.scenarios.diverse_pods(200, random.Random(3))
        cluster = M.Cluster()
        provider = M.FakeCloudProvider(M.fake.instance_types(30))
        if decorate:
            provider = M.cpmetrics.decorate(provider)
        ctl = controller(M, cluster, provider, start_workers=False)
        prov = M.f.make_provisioner(solver="tpu")
        cluster.create("provisioners", prov)
        ctl.reconcile("default")
        worker = ctl.workers["default"]
        worker.batcher.idle_duration = 0.01
        worker.scheduler.torch.topology.rng = random.Random(1)
        for p in pods:
            cluster.create("pods", p)
            worker.add(p)
        with pinned(PORT):
            worker.provision_once()
        ctl.stop()
        states.append(bound_state(M, cluster, pods, "default")[:2])
    assert states[0] == states[1]


@pytest.mark.parametrize("pkg", PACKAGES)
def test_duplicate_and_replaced_pods_are_solved_once(pkg):
    """Watch storms and verify requeues can enqueue a pod twice: the round
    keeps the latest object per key at the first position."""
    M = mods(pkg)
    cluster = M.Cluster()
    ctl = controller(M, cluster, M.FakeCloudProvider(M.fake.instance_types(10)), start_workers=False)
    cluster.create("provisioners", M.f.make_provisioner())
    ctl.reconcile("default")
    worker = ctl.workers["default"]
    worker.batcher.idle_duration = 0.01
    a = M.f.make_pod(name="dup", requests={"cpu": "1"})
    cluster.create("pods", a)
    b = M.f.make_pod(name="dup", requests={"cpu": "3"})  # the replaced object
    for p in (a, a, b):
        worker.add(p)
    nodes = worker.provision_once()
    ctl.stop()
    assert [[p is b for p in n.pods] for n in nodes] == [[True]]
    assert not worker.is_pending(a.key)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_failed_launch_requeues_the_pods_for_the_next_round(pkg):
    M = mods(pkg)

    class Flaky(M.FakeCloudProvider):
        fail = 1

        def create(self, request):
            if self.fail:
                self.fail -= 1
                raise RuntimeError("injected create failure")
            return super().create(request)

    cluster = M.Cluster()
    provider = Flaky(M.fake.instance_types(10))
    ctl = controller(M, cluster, provider, start_workers=False)
    cluster.create("provisioners", M.f.make_provisioner())
    ctl.reconcile("default")
    worker = ctl.workers["default"]
    worker.batcher.idle_duration = 0.01
    pod = M.f.make_pod(requests={"cpu": "1"})
    cluster.create("pods", pod)
    worker.add(pod)
    worker.provision_once()
    assert pod.spec.node_name == "" and worker.is_pending(pod.key) and worker.batcher.depth() == 1
    reasons = [e.reason for e in cluster.list("events")]
    assert "LaunchFailed" in reasons
    worker.provision_once()
    ctl.stop()
    assert pod.spec.node_name and not worker.is_pending(pod.key)
    assert "Launched" in [e.reason for e in cluster.list("events")]


@pytest.mark.parametrize("pkg", PACKAGES)
def test_already_bound_pod_is_not_bound_again(pkg):
    """The bind re-checks the live pod: a pod another writer bound between
    the solve and the bind keeps its node and counts on the guard."""
    M = mods(pkg)
    guard = {"reason": "already_bound"}
    before = M.metrics.REGISTRY.get_sample_value(
        "karpenter_fleet_duplicate_launch_guard_total", guard) or 0.0
    cluster = M.Cluster()
    ctl = controller(M, cluster, M.FakeCloudProvider(M.fake.instance_types(10)), start_workers=False)
    cluster.create("provisioners", M.f.make_provisioner())
    ctl.reconcile("default")
    worker = ctl.workers["default"]
    worker.batcher.idle_duration = 0.01
    pods = [M.f.make_pod(requests={"cpu": "1"}) for _ in range(2)]
    for p in pods:
        cluster.create("pods", p)
        worker.add(p)
    solve = worker.scheduler.solve

    def solve_then_race(*a):
        nodes = solve(*a)
        cluster.bind(pods[0], "someone-else")
        return nodes

    worker.scheduler.solve = solve_then_race
    worker.provision_once()
    ctl.stop()
    assert pods[0].spec.node_name == "someone-else" and pods[1].spec.node_name != "someone-else"
    after = M.metrics.REGISTRY.get_sample_value(
        "karpenter_fleet_duplicate_launch_guard_total", guard) or 0.0
    assert after - before == 1.0


@pytest.mark.parametrize("pkg", PACKAGES)
def test_queue_full_shed_clears_pending_and_events(pkg):
    M = mods(pkg)
    cluster = M.Cluster()
    ctl = controller(M, cluster, M.FakeCloudProvider(M.fake.instance_types(5)), start_workers=False)
    cluster.create("provisioners", M.f.make_provisioner())
    ctl.reconcile("default")
    worker = ctl.workers["default"]
    worker.batcher.max_depth = 1
    low = M.f.make_pod(name="low", requests={"cpu": "1"}, priority_class_name="low-batch")
    high = M.f.make_pod(name="high", requests={"cpu": "1"}, priority_class_name="high")
    worker.add(low)
    worker.add(high)
    ctl.stop()
    assert not worker.is_pending(low.key) and worker.is_pending(high.key)
    shed = [e for e in cluster.list("events") if e.reason == "PodShed"]
    assert len(shed) == 1 and "default/low" in shed[0].message and shed[0].type == "Warning"


# -- the threaded worker and its warm-up --------------------------------------


@pytest.mark.parametrize("solver", ["ffd", "tpu"])
def test_start_workers_end_to_end(M, solver):
    cluster = M.Cluster()
    ctl = controller(M, cluster, M.FakeCloudProvider(M.fake.instance_types(10)), start_workers=True)
    prov = M.f.make_provisioner(solver=solver)
    cluster.create("provisioners", prov)
    try:
        with pinned(M.pkg):
            ctl.apply(prov)
            worker = ctl.workers[prov.name]
            worker.batcher.idle_duration = 0.05
            assert worker._thread is not None and worker._thread.is_alive()
            pods = [M.f.make_pod(requests={"cpu": "1"}) for _ in range(3)]
            gates = []
            for p in pods:
                cluster.create("pods", p)
                gates.append(worker.add(p))
            for g in gates:
                assert g.wait(timeout=60), "batch gate never flushed"
            deadline = time.time() + 60
            while time.time() < deadline:
                if all(p.spec.node_name for p in cluster.pods()):
                    break
                time.sleep(0.02)
        assert all(p.spec.node_name for p in cluster.pods())
        assert len(cluster.nodes()) >= 1
    finally:
        ctl.stop()
    assert not worker._thread.is_alive()


def test_tpu_worker_warmup_solves_a_small_bucket_on_the_cpu(M):
    cluster = M.Cluster()
    ctl = controller(M, cluster, M.FakeCloudProvider(M.fake.instance_types(10)), start_workers=True)
    prov = M.f.make_provisioner(solver="tpu")
    cluster.create("provisioners", prov)
    try:
        with pinned(M.pkg):
            ctl.apply(prov)
            worker = ctl.workers[prov.name]
            assert worker.warmed.wait(timeout=120), "warm-up never completed"
        if M.pkg == PORT:
            # the 4-pod bucket on the CPU, through the plain version
            prof = worker.scheduler.last_stage_profile()
            assert prof["packer_backend"] == "pack_reference"
            assert worker.scheduler.device.type == "cpu"
    finally:
        ctl.stop()


def test_warmup_overlapping_the_first_round_binds_every_pod(M):
    """Pods queued while the warm-up is still solving: both solve on the
    worker's one scheduler and every pod binds."""
    cluster = M.Cluster()
    ctl = controller(M, cluster, M.FakeCloudProvider(M.fake.instance_types(10)), start_workers=True)
    prov = M.f.make_provisioner(solver="tpu")
    cluster.create("provisioners", prov)
    pods = [M.f.make_pod(requests={"cpu": "1"}) for _ in range(20)]
    try:
        with pinned(M.pkg):
            ctl.apply(prov)
            worker = ctl.workers[prov.name]
            worker.batcher.idle_duration = 0.01
            for p in pods:
                cluster.create("pods", p)
                worker.add(p)
            assert worker.warmed.wait(timeout=120)
            deadline = time.time() + 60
            while time.time() < deadline and not all(p.spec.node_name for p in pods):
                time.sleep(0.02)
        assert all(p.spec.node_name for p in pods)
    finally:
        ctl.stop()


def test_port_ffd_worker_never_starts_a_warmup():
    M = mods(PORT)
    cluster = M.Cluster()
    ctl = controller(M, cluster, M.FakeCloudProvider(M.fake.instance_types(10)), start_workers=True)
    prov = M.f.make_provisioner(solver="ffd")
    cluster.create("provisioners", prov)
    try:
        ctl.apply(prov)
        worker = ctl.workers[prov.name]
        assert not worker.warmed.wait(timeout=0.3)
        assert worker.scheduler._torch is None
    finally:
        ctl.stop()


# -- the Active condition -----------------------------------------------------


def _controller(M, clock=None):
    cluster = M.Cluster(clock=clock)
    return cluster, controller(M, cluster, M.FakeCloudProvider(M.fake.instance_types(5)),
                               start_workers=False)


def test_apply_success_marks_active(M):
    cluster, ctl = _controller(M)
    cluster.create("provisioners", M.f.make_provisioner())
    ctl.reconcile("default")
    cond = cluster.get("provisioners", "default", namespace="").status.condition()
    assert (cond.type, cond.status) == ("Active", "True")
    assert cond.last_transition_time is not None
    ctl.stop()


def test_apply_failure_marks_not_active_with_reason(M):
    cluster, ctl = _controller(M)
    cluster.create("provisioners", M.f.make_provisioner(solver="nope"))
    with pytest.raises(ValueError):
        ctl.reconcile("default")
    cond = cluster.get("provisioners", "default", namespace="").status.condition()
    assert (cond.status, cond.reason) == ("False", "ValidationFailed")
    assert "solver" in cond.message
    ctl.stop()


def test_invalid_disruption_budget_fails_validation(M):
    cluster, ctl = _controller(M)
    prov = M.f.make_provisioner()
    prov.spec.disruption_budget = "12x"
    cluster.create("provisioners", prov)
    with pytest.raises(ValueError, match="disruptionBudget"):
        ctl.reconcile("default")
    cond = cluster.get("provisioners", "default", namespace="").status.condition()
    assert (cond.status, cond.reason) == ("False", "ValidationFailed")
    ctl.stop()


@pytest.mark.parametrize("spec,want", [
    (None, None), ("", None), (" 3 ", "3"), ("20%", "20%"), ("0", "0"), ("0%", "0%"),
    ("-1", ValueError), ("101%", ValueError), ("abc", ValueError), ("1.5", ValueError)])
def test_parse_budget_equals_the_reference(spec, want):
    for pkg in PACKAGES:
        parse = importlib.import_module(f"{pkg}.controllers.disruption").parse_budget
        if want is ValueError:
            with pytest.raises(ValueError):
                parse(spec)
        else:
            assert parse(spec) == want


def test_transition_bumps_time_steady_state_does_not(M):
    now = [100.0]
    cluster, ctl = _controller(M, clock=lambda: now[0])
    cluster.create("provisioners", M.f.make_provisioner(solver="nope"))
    with pytest.raises(ValueError):
        ctl.reconcile("default")
    assert cluster.get("provisioners", "default", namespace="").status.condition().last_transition_time == 100.0
    now[0] = 200.0
    fixed = cluster.get("provisioners", "default", namespace="")
    fixed.spec.solver = "ffd"
    cluster.update("provisioners", fixed)
    ctl.reconcile("default")
    cond = cluster.get("provisioners", "default", namespace="").status.condition()
    assert (cond.status, cond.last_transition_time, cond.reason, cond.message) == ("True", 200.0, "", "")
    now[0] = 300.0
    ctl.reconcile("default")
    cond = cluster.get("provisioners", "default", namespace="").status.condition()
    assert (cond.status, cond.last_transition_time) == ("True", 200.0)
    ctl.stop()


def test_condition_transitions_and_wire_equal_the_reference():
    """The same reconcile sequence (fail, fix, steady, break again) leaves
    the same provisioner wire in both packages, condition list included."""
    wires = []
    for pkg in PACKAGES:
        M = mods(pkg)
        now = [100.0]
        cluster, ctl = _controller(M, clock=lambda: now[0])
        prov = M.f.make_provisioner(solver="nope")
        prov.metadata.uid = "uid"
        prov.status.conditions.append(M.api.Condition(type="CatalogReady", status="True",
                                                      reason="Discovered"))
        cluster.create("provisioners", prov)
        trail = []
        for step, solver in enumerate(("nope", "ffd", "ffd", "bad")):
            now[0] = 100.0 * (step + 1)
            live = cluster.get("provisioners", "default", namespace="")
            live.spec.solver = solver
            cluster.update("provisioners", live)
            try:
                trail.append(ctl.reconcile("default"))
            except ValueError as e:
                trail.append(type(e).__name__)
            wire = M.serde.to_wire("provisioners", cluster.get("provisioners", "default", namespace=""))
            wire["metadata"].pop("resourceVersion", None)
            trail.append(wire)
        ctl.stop()
        wires.append(trail)
    assert wires[0] == wires[1]
    conds = {c["type"]: c for c in wires[1][-1]["status"]["conditions"]}
    assert conds["Active"]["status"] == "False" and conds["CatalogReady"]["reason"] == "Discovered"


def test_condition_round_trips_over_the_wire(M):
    cluster, ctl = _controller(M)
    cluster.create("provisioners", M.f.make_provisioner())
    ctl.reconcile("default")
    prov = cluster.get("provisioners", "default", namespace="")
    wire = M.serde.to_wire("provisioners", prov)
    wc = wire["status"]["conditions"][0]
    assert wc["type"] == "Active" and wc["status"] == "True" and "lastTransitionTime" in wc
    back = M.serde.from_wire("provisioners", wire)
    assert (back.status.condition().type, back.status.condition().status) == ("Active", "True")
    assert M.serde.to_wire("provisioners", back) == wire
    ctl.stop()


def test_failed_condition_write_retried_next_reconcile(M):
    cluster, ctl = _controller(M)
    cluster.create("provisioners", M.f.make_provisioner())
    real = cluster.patch_status
    calls = {"n": 0}

    def flaky(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("transient apiserver error")
        return real(*a, **kw)

    cluster.patch_status = flaky
    ctl.reconcile("default")
    assert cluster.get("provisioners", "default", namespace="").status.condition() is None
    ctl.reconcile("default")
    assert cluster.get("provisioners", "default", namespace="").status.condition().status == "True"
    assert calls["n"] == 2
    ctl.stop()


def test_active_gauge_tracks_condition(M):
    def gauge():
        return M.metrics.REGISTRY.get_sample_value("karpenter_provisioner_active",
                                                   {"provisioner": "default"})

    cluster, ctl = _controller(M)
    cluster.create("provisioners", M.f.make_provisioner(solver="nope"))
    with pytest.raises(ValueError):
        ctl.reconcile("default")
    assert gauge() == 0.0
    fixed = cluster.get("provisioners", "default", namespace="")
    fixed.spec.solver = "ffd"
    cluster.update("provisioners", fixed)
    ctl.reconcile("default")
    assert gauge() == 1.0
    cluster.delete("provisioners", "default", namespace="")
    ctl.reconcile("default")
    assert gauge() is None
    ctl.stop()


def test_condition_write_preserves_foreign_conditions(M):
    cluster, ctl = _controller(M)
    prov = M.f.make_provisioner()
    prov.status.conditions.append(M.api.Condition(type="CatalogReady", status="True",
                                                  reason="Discovered"))
    cluster.create("provisioners", prov)
    ctl.reconcile("default")
    conds = {c.type: c for c in cluster.get("provisioners", "default", namespace="").status.conditions}
    assert conds["Active"].status == "True"
    assert (conds["CatalogReady"].status, conds["CatalogReady"].reason) == ("True", "Discovered")
    ctl.stop()


def test_reconcile_of_unknown_name_never_raises(M):
    cluster, ctl = _controller(M)
    assert ctl.reconcile("ghost") is None
    ctl.stop()


def test_stop_clears_gauge_for_never_started_provisioner(M):
    cluster, ctl = _controller(M)
    cluster.create("provisioners", M.f.make_provisioner(name="broken", solver="nope"))
    with pytest.raises(ValueError):
        ctl.reconcile("broken")
    labels = {"provisioner": "broken"}
    assert M.metrics.REGISTRY.get_sample_value("karpenter_provisioner_active", labels) == 0.0
    ctl.stop()
    assert M.metrics.REGISTRY.get_sample_value("karpenter_provisioner_active", labels) is None


def test_catalog_requirements_layered_in_at_apply(M):
    cluster, ctl = _controller(M)
    prov = M.f.make_provisioner()
    cluster.create("provisioners", prov)
    ctl.reconcile("default")
    worker = ctl.workers["default"]
    reqs = worker.provisioner.spec.constraints.requirements
    assert reqs.has(M.lbl.INSTANCE_TYPE)
    assert not prov.spec.constraints.requirements.has(M.lbl.INSTANCE_TYPE)  # the live object untouched
    ctl.stop()
