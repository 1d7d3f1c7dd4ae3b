"""The port's interruption subsystem against the JAX package's.

The reference's ``tests/test_interruption.py`` classes ``TestNoticeResponse``,
``TestProactiveReplacement``, ``TestDeadlineEnforcement``,
``TestReplacementUnavailable`` and ``TestMultiNoticeBurst`` run on both
packages with a ``solver: tpu`` provisioner: the JAX package's scheduler on
its lax.scan packer, the port's controllers on ``device="cpu"`` (each side
pinned by ``torch_parity.pinned``). Each case asserts the reference's
behaviour on both and compares, exactly and under ``torch_parity.canon``
(node names renamed by creation order, random annotations by presence):
every node's wire form after the merge patches, the workload pods' wire
forms (released, then re-bound), the events, the replacement round's plan
by pod index, and the orchestrator's ``evicted_unready``, notices and
``lead_times`` counts. A Manager-wired twin of ``TestFullRuntime`` preempts
a node under a running Manager in both packages, over ``FakeCloudProvider``
and again over ``SimulatedCloudProvider`` (the notice on the simulated
cloud's event bus). ``TestDisruptionSources``' in-process cases drain both
clouds' buses and the metered provider's pass-through (the reference's
HTTP routes to the clouds are not ported).
"""

import time
from types import SimpleNamespace

import pytest

from torch_parity import both_canon, events, fresh_router, on_cpu, stop, wire_all, wire_doc  # noqa: F401


def env(M, n_types=5):
    now = [1000.0]
    cluster = M.Cluster(clock=lambda: now[0])
    provider = M.fake.FakeCloudProvider(M.fake.instance_types(n_types))
    provisioning = M.prov.ProvisioningController(cluster, provider, start_workers=False,
                                                 **on_cpu(M, {}))
    termination = M.term.TerminationController(cluster, provider, start_queue=False)
    ic = M.intr.InterruptionController(cluster, provider, provisioning=provisioning,
                                       termination=termination)
    return SimpleNamespace(M=M, cluster=cluster, provider=provider, provisioning=provisioning,
                           termination=termination, ic=ic, now=now, pods=[])


def start_worker(e):
    e.cluster.create("provisioners", e.M.f.make_provisioner(solver="tpu"))
    e.provisioning.reconcile("default")
    worker = e.provisioning.list_workers()[0]
    worker.batcher.idle_duration = 0.01
    return worker


def launch_workload(e, worker, tag, n_pods=4):
    """``n_pods`` pending pods of cpu 0.5 named ``{tag}-{i}`` and one solve;
    returns (node name, pods)."""
    pods = [e.M.f.make_pod(name=f"{tag}-{i}", requests={"cpu": "0.5"}) for i in range(n_pods)]
    for p in pods:
        e.cluster.create("pods", p)
        worker.add(p)
    worker.provision_once()
    names = {p.spec.node_name for p in pods}
    assert len(names) == 1 and "" not in names, f"workload not co-located: {names}"
    e.pods.extend(pods)
    return names.pop(), pods


def view(e, worker=None):
    """What the case left: every node's and workload pod's wire form, the
    events, the plan by pod index (node name and instance type), the
    orchestrator's counts, the cloud's creates and deletes, and what served
    the worker's last round."""
    M, cluster = e.M, e.cluster
    nodes = {n.metadata.name: n for n in cluster.nodes()}
    plan = [(p.spec.node_name, nodes[p.spec.node_name].metadata.labels.get(M.lbl.INSTANCE_TYPE)
             if p.spec.node_name in nodes else None) for p in e.pods]
    served = None
    if worker is not None:
        served = worker.scheduler.last_stage_profile().get("packer_backend") is not None
    return {
        # by creation order (fake-node-<n> by n): a plain name sort puts
        # fake-node-10 before fake-node-9, so it would depend on how many
        # nodes the process's fake cloud made before the case
        "nodes": [wire_doc(M, "nodes", n) for n in sorted(
            nodes.values(), key=lambda n: (len(n.metadata.name), n.metadata.name))],
        "pods": [wire_doc(M, "pods", p) for p in e.pods], "events": events(M, cluster), "plan": plan,
        "evicted_unready": e.ic.evicted_unready, "notices": e.ic.notices_handled,
        "lead_times": len(e.ic.lead_times), "creates": len(e.provider.create_calls),
        "deletes": list(e.provider.delete_calls), "served": served,
    }


# -- TestNoticeResponse --------------------------------------------------------


def test_taint_cordon_and_event():
    def run(M):
        e = env(M)
        worker = start_worker(e)
        node_name, _ = launch_workload(e, worker, "w")
        e.provider.preempt(node_name, grace_period_seconds=120.0)
        assert e.ic.reconcile(M.intr.POLL_KEY) == e.ic.poll_interval
        node = e.cluster.try_get("nodes", node_name, namespace="")
        assert node.spec.unschedulable and node.metadata.deletion_timestamp is not None
        taints = {t.key: t.value for t in node.spec.taints}
        assert taints.get(M.lbl.INTERRUPTION_TAINT_KEY) == M.itypes.PREEMPTION
        assert "InterruptionNotice" in {ev.reason for ev in e.cluster.list("events")}
        return view(e, worker)

    both_canon(run)


def test_unknown_node_ignored():
    def run(M):
        e = env(M)
        e.provider.preempt("no-such-node")
        assert e.ic.reconcile(M.intr.POLL_KEY) == e.ic.poll_interval
        return view(e)

    out = both_canon(run)
    assert (out["notices"], out["evicted_unready"]) == (0, 0)


def test_reannounced_notice_deduped():
    def run(M):
        e = env(M)
        worker = start_worker(e)
        node_name, _ = launch_workload(e, worker, "w")
        assert e.provider.preempt(node_name) is not None
        assert not e.provider.disruptions.push(
            M.itypes.DisruptionNotice(kind=M.itypes.PREEMPTION, node_name=node_name))
        e.ic.reconcile(M.intr.POLL_KEY)
        first = e.ic.notices_handled
        e.provider.preempt(node_name)
        e.ic.reconcile(M.intr.POLL_KEY)
        return first, view(e, worker)

    first, out = both_canon(run)
    assert first == out["notices"] == 1


# -- TestProactiveReplacement ------------------------------------------------


def test_replacement_launches_before_any_eviction():
    def run(M):
        e = env(M)
        worker = start_worker(e)
        node_name, pods = launch_workload(e, worker, "w")
        e.provider.preempt(node_name, grace_period_seconds=120.0)
        e.ic.reconcile(M.intr.POLL_KEY)
        assert all(p.spec.node_name == "" for p in pods) and e.provider.delete_calls == []
        released = view(e)
        assert e.cluster.try_get("nodes", node_name, namespace="") is not None
        worker.provision_once()
        assert len(e.provider.create_calls) == 2 and e.provider.delete_calls == []
        replacement = {p.spec.node_name for p in pods}
        assert len(replacement) == 1 and node_name not in replacement and "" not in replacement
        replaced = view(e, worker)
        assert e.termination.reconcile(node_name) is None
        assert e.cluster.try_get("nodes", node_name, namespace="") is None
        assert e.provider.delete_calls == [node_name]
        assert not any(M.utilpod.is_provisionable(p) for p in e.cluster.pods())
        assert e.ic.reconcile(node_name) is None
        assert len(e.ic.lead_times) == len(pods) and e.ic.evicted_unready == 0
        return released, replaced, view(e, worker)

    both_canon(run)


def test_replacement_respects_volume_topology():
    def run(M):
        e = env(M)
        worker = start_worker(e)
        e.cluster.create("pvs", M.f.make_pv(name="pv-a", zones=["test-zone-2"]))
        e.cluster.create("pvcs", M.f.make_pvc(name="claim-a", volume_name="pv-a"))
        pod = M.f.make_pod(name="stateful", requests={"cpu": "0.5"})
        pod.spec.volumes.append(M.O.Volume(name="data", persistent_volume_claim="claim-a"))
        e.cluster.create("pods", pod)
        e.pods.append(pod)
        worker.add(pod)
        worker.provision_once()
        node_name = pod.spec.node_name
        e.provider.preempt(node_name)
        e.ic.reconcile(M.intr.POLL_KEY)
        worker.provision_once()
        replacement = e.cluster.try_get("nodes", pod.spec.node_name, namespace="")
        assert replacement is not None and replacement.metadata.name != node_name
        assert replacement.metadata.labels[M.lbl.TOPOLOGY_ZONE] == "test-zone-2"
        return view(e, worker)

    both_canon(run)


def test_daemonset_and_static_pods_stay():
    def run(M):
        e = env(M)
        worker = start_worker(e)
        node_name, pods = launch_workload(e, worker, "w", n_pods=2)
        O = M.O
        ds_pod = M.f.make_pod(name="ds", node_name=node_name, unschedulable=False,
                              owner=O.OwnerReference(api_version="apps/v1", kind="DaemonSet",
                                                     name="ds"))
        static_pod = M.f.make_pod(name="static", node_name=node_name, unschedulable=False,
                                  owner=O.OwnerReference(api_version="v1", kind="Node",
                                                         name=node_name))
        for p in (ds_pod, static_pod):
            e.cluster.create("pods", p)
            e.pods.append(p)
        e.provider.preempt(node_name)
        e.ic.reconcile(M.intr.POLL_KEY)
        assert ds_pod.spec.node_name == node_name == static_pod.spec.node_name
        assert all(p.spec.node_name == "" for p in pods)
        return view(e)

    both_canon(run)


# -- TestDeadlineEnforcement -------------------------------------------------


def test_do_not_evict_holdout_forced_at_deadline():
    def run(M):
        e = env(M)
        worker = start_worker(e)
        node_name, _ = launch_workload(e, worker, "w", n_pods=2)
        holdout = M.f.make_pod(name="holdout", node_name=node_name, unschedulable=False)
        holdout.metadata.annotations[M.lbl.DO_NOT_EVICT_ANNOTATION] = "true"
        e.cluster.create("pods", holdout)
        e.pods.append(holdout)
        e.provider.preempt(node_name, grace_period_seconds=60.0)
        e.ic.reconcile(M.intr.POLL_KEY)
        assert holdout.spec.node_name == node_name
        assert e.termination.reconcile(node_name) == e.termination.DRAIN_REQUEUE
        requeue = e.ic.reconcile(node_name)
        assert requeue is not None and requeue <= 1.0
        held = view(e)
        e.now[0] += 61.0
        assert e.ic.reconcile(node_name) is None
        assert e.cluster.try_get("nodes", node_name, namespace="") is None
        assert node_name in e.provider.delete_calls and e.ic.evicted_unready == 1
        assert "InterruptionDeadlineReached" in {ev.reason for ev in e.cluster.list("events")}
        return requeue, held, view(e)

    both_canon(run)


def test_grace_deadline_tracks_notice():
    def run(M):
        e = env(M)
        worker = start_worker(e)
        node_name, _ = launch_workload(e, worker, "w", n_pods=1)
        e.provider.preempt(node_name, grace_period_seconds=300.0, kind=M.itypes.MAINTENANCE)
        e.ic.reconcile(M.intr.POLL_KEY)
        e.now[0] += 299.0
        inside = e.ic.reconcile(node_name)
        e.now[0] += 2.0
        return inside, e.ic.reconcile(node_name), view(e)

    inside, enforced, _ = both_canon(run)
    assert (inside, enforced) == (1.0, None)


# -- TestReplacementUnavailable ----------------------------------------------


def test_no_admitting_provisioner_leaves_pods_pending():
    def run(M):
        e = env(M)
        node = M.f.make_node(name="lone", provisioner_name="default",
                             finalizers=[M.lbl.TERMINATION_FINALIZER])
        e.cluster.create("nodes", node)
        pod = M.f.make_pod(name="p", node_name="lone", unschedulable=False)
        e.cluster.create("pods", pod)
        e.pods.append(pod)
        e.provider.preempt("lone")
        e.ic.reconcile(M.intr.POLL_KEY)
        assert pod.spec.node_name == "" and M.utilpod.is_provisionable(pod)
        assert e.termination.reconcile("lone") is None
        assert e.cluster.try_get("pods", "p") is not None
        return view(e)

    both_canon(run)


def test_launch_failure_does_not_lose_pods():
    def run(M):
        e = env(M)
        fail = [1]
        original_create = e.provider.create

        def flaky_create(request):
            if fail[0]:
                fail[0] -= 1
                raise RuntimeError("insufficient capacity")
            return original_create(request)

        worker = start_worker(e)
        node_name, pods = launch_workload(e, worker, "w", n_pods=2)
        e.provider.create = flaky_create
        e.provider.preempt(node_name)
        e.ic.reconcile(M.intr.POLL_KEY)
        worker.provision_once()
        assert all(M.utilpod.is_provisionable(p) for p in pods)
        failed = view(e)
        for p in pods:
            assert e.provisioning.submit(p) is not None
        worker.provision_once()
        assert all(p.spec.node_name not in ("", node_name) for p in pods)
        assert e.ic.evicted_unready == 0
        return failed, view(e, worker)

    both_canon(run)


# -- TestMultiNoticeBurst -------------------------------------------------------


def test_burst_replaces_every_node():
    def run(M):
        e = env(M)
        worker = start_worker(e)
        victims = [launch_workload(e, worker, f"w{k}", n_pods=2)[0] for k in range(3)]
        for name in victims:
            e.provider.preempt(name, grace_period_seconds=120.0)
        e.ic.reconcile(M.intr.POLL_KEY)
        assert e.ic.notices_handled == 3
        worker.provision_once()
        assert all(p.spec.node_name and p.spec.node_name not in victims for p in e.pods)
        for name in victims:
            assert e.termination.reconcile(name) is None
        assert sorted(e.provider.delete_calls) == sorted(victims)
        assert e.ic.evicted_unready == 0 and len(e.ic.lead_times) == len(e.pods)
        return view(e, worker)

    both_canon(run)


# -- TestFullRuntime, wired by hand ------------------------------------------


def test_preemption_through_running_manager():
    """The subsystem under a running Manager in both packages (wired as
    the reference's main.py wires it): watch-driven selection, the
    interruption controller polling every 0.1 s, threaded workers, a
    ``solver: tpu`` provisioner. Compared: the workload's placement before
    and after, the victim's taint and deletion, the counts."""
    runtime_preemption("fake")


def test_preemption_through_running_manager_simulated():
    """``test_preemption_through_running_manager`` over the simulated
    cloud: the notice arrives on its event bus, the victim's instance is
    terminated."""
    runtime_preemption("sim")


def runtime_preemption(kind):
    def run(M):
        cluster = M.Cluster()
        provider = M.fake.FakeCloudProvider(M.fake.instance_types(10)) if kind == "fake" \
            else M.sim.SimulatedCloudProvider(M.sim.SimCloudAPI())
        w = wire_all(M, cluster, provider, interruption=True)
        w.interruption.poll_interval = 0.1
        w.manager.start()
        try:
            cluster.create("provisioners", M.f.make_provisioner(solver="tpu"))
            deadline = time.time() + 30
            while time.time() < deadline and not w.provisioning.workers:
                time.sleep(0.02)
            worker = w.provisioning.workers["default"]
            worker.batcher.idle_duration = 0.05
            assert worker.warmed.wait(timeout=120)
            pods = [M.f.make_pod(name=f"rt-{i}", requests={"cpu": "0.25"}) for i in range(8)]
            for p in pods:
                cluster.create("pods", p)
            deadline = time.time() + 60
            while time.time() < deadline and not all(p.spec.node_name for p in pods):
                time.sleep(0.05)
            assert all(p.spec.node_name for p in pods), "initial workload never bound"
            victim = pods[0].spec.node_name
            before = [p.spec.node_name == victim for p in pods]
            if kind == "fake":
                provider.preempt(victim, grace_period_seconds=120.0)
            else:
                provider.api.send_disruption_notice(M.itypes.DisruptionNotice(
                    kind=M.itypes.PREEMPTION, node_name=victim, grace_period_seconds=120.0))
            deadline = time.time() + 60
            while time.time() < deadline and not (
                    cluster.try_get("nodes", victim, namespace="") is None
                    and all(p.spec.node_name not in ("", victim) for p in pods)):
                time.sleep(0.05)
            assert cluster.try_get("nodes", victim, namespace="") is None
            assert all(p.spec.node_name not in ("", victim) for p in pods)
            deadline = time.time() + 10
            while time.time() < deadline and len(w.interruption.lead_times) < sum(before):
                time.sleep(0.02)
            noticed = {ev.reason for ev in cluster.list("events")
                       if ev.involved_name == victim} >= {"InterruptionNotice"}
            # how the storm batched is timing (the placement may differ);
            # what the notice did is not
            gone = provider.delete_calls if kind == "fake" else [
                i.id for i in provider.api.instances.values() if i.state == "terminated"]
            return (noticed, w.interruption.evicted_unready, w.interruption.notices_handled,
                    len(w.interruption.lead_times) == sum(before), gone == [victim])
        finally:
            stop(w)

    assert both_canon(run) == (True, 0, 1, True, True)


# -- TestDisruptionSources, in process -------------------------------------------


@pytest.mark.parametrize("source", ["fake", "simulated", "metered"])
def test_disruption_sources(source):
    """A notice put on the fake cloud's or the simulated cloud's bus (or
    the fake's behind the metered provider) drains once through
    ``poll_disruptions``, with its kind, node and grace."""
    def run(M):
        I = M.itypes
        if source == "simulated":
            provider = M.sim.SimulatedCloudProvider(M.sim.SimCloudAPI())
            provider.api.send_disruption_notice(I.DisruptionNotice(
                kind=I.PREEMPTION, node_name="i-0001", grace_period_seconds=90.0))
            poller = provider
        else:
            provider = M.fake.FakeCloudProvider()
            provider.preempt("n1", grace_period_seconds=30.0)
            poller = M.cpm.decorate(provider) if source == "metered" else provider
        first = [(n.kind, n.node_name, n.grace_period_seconds) for n in poller.poll_disruptions()]
        return first, poller.poll_disruptions()

    first, again = both_canon(run)
    assert again == [] and first == ([("preemption", "i-0001", 90.0)] if source == "simulated"
                                     else [("preemption", "n1", 30.0)])
