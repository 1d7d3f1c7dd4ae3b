"""The port's controllers over its API server client against the JAX
package's: the whole runtime (provision, bind, terminate) across the HTTP
boundary, consolidation over an ``ApiCluster`` (``evict`` picked, ``bind``
refused, a drain through the eviction subresource with a workload stand-in
recreating the pods, an ownerless pod pinning its node) and the node
controller's single merge patch.

Mirrors ``tests/test_apiserver.py`` (``TestFullRuntime``,
``TestConsolidationOverApiserver``, ``TestNodeLifecycleOverApiserver``).
Each case runs through both packages, each package's runtime over its own
``ApiCluster`` against its own ``TestApiServer`` (the port's controllers on
``device="cpu"``), and compares exactly: the plans, the answers and the
server's store as wire documents.
"""

import threading
import time

from torch_parity import (PACKAGES, both_canon, fresh_router, kube, kube_env, on_cpu,  # noqa: F401
                          plan_view, wire_doc)


def both(fn):
    return both_canon(fn, ns=kube)


def wait(predicate, timeout=30.0):
    deadline = time.time() + timeout
    while time.time() < deadline and not predicate():
        time.sleep(0.05)
    return predicate()


def runtime(M, cluster, provider):
    rt = M.main.build_runtime(M.options.Options(**on_cpu(M, {})), cluster=cluster,
                              cloud_provider=provider, start_workers=True)
    rt.manager.start()
    return rt


def test_provision_bind_terminate_over_apiserver():
    """A 'kubectl' client creates a provisioner and pending pods; the
    runtime, over its own ``ApiCluster``, provisions and binds; a node
    delete drains and the cloud instance is released."""
    def run(M):
        with kube_env(M) as env:
            kubectl, controller = env.connect(), env.connect()
            provider = M.fake.FakeCloudProvider(M.fake.instance_types(10))
            rt = runtime(M, controller, provider)
            try:
                kubectl.create("provisioners", M.f.make_provisioner())
                assert wait(lambda: "default" in rt.provisioning.workers)
                rt.provisioning.workers["default"].batcher.idle_duration = 0.1
                for i in range(3):
                    kubectl.create("pods", M.f.make_pod(name=f"app-{i}", requests={"cpu": "1"}))
                bound = wait(lambda: sum(bool(p.spec.node_name) for p in env.cluster.pods()) == 3)
                nodes = env.cluster.nodes()
                view = (bound, [(n.metadata.labels.get(M.lbl.INSTANCE_TYPE),
                                 M.lbl.TERMINATION_FINALIZER in n.metadata.finalizers)
                                for n in nodes],
                        sorted({p.spec.node_name for p in env.cluster.pods()}))
                name = nodes[0].metadata.name
                kubectl.delete("nodes", name, namespace="")
                gone = wait(lambda: env.cluster.try_get("nodes", name, namespace="") is None)
                return view, gone, provider.delete_calls == [name]
            finally:
                rt.stop()

    (bound, nodes, hosts), gone, deleted = both(run)
    assert bound and len(nodes) == 1 and nodes[0][1] and len(hosts) == 1
    assert gone and deleted


def test_rebind_rejected_by_apiserver():
    def run(M):
        with kube_env(M) as env:
            c = env.connect()
            pod = M.f.make_pod(name="bound", requests={"cpu": "1"})
            c.create("pods", pod)
            c.bind(pod, "node-a")
            c.bind(pod, "node-a")  # a lost response replayed: no error
            try:
                c.bind(pod, "node-b")
            except M.client.Conflict:
                return "Conflict", env.cluster.get("pods", "bound").spec.node_name

    assert both(run) == ("Conflict", "node-a")


def test_evict_mode_consolidates_via_drain_and_recreate():
    """Evict mode over the API server: the old nodes drain through the
    eviction subresource, a workload stand-in recreates the pods, the
    recreated pending pods drive the provisioner, and the new capacity
    realizes the plan's savings. Nothing is pre-launched."""
    def run(M):
        lbl = M.lbl
        with kube_env(M) as env:
            kubectl, controller = env.connect(), env.connect()
            provider = M.fake.FakeCloudProvider(M.fake.instance_types(30))
            rt = runtime(M, controller, provider)
            recreated, lock = [], threading.Lock()

            def recreate(event, pod):
                if event != "DELETED" or not pod.metadata.labels.get("workload"):
                    return
                with lock:
                    if pod.metadata.name in recreated:
                        return
                    recreated.append(pod.metadata.name)
                try:
                    kubectl.create("pods", M.f.make_pod(
                        name=f"{pod.metadata.name}-r", labels=dict(pod.metadata.labels),
                        requests={"cpu": "1"}))
                except M.client.Conflict:
                    pass

            kubectl.watch("pods", recreate)
            try:
                kubectl.create("provisioners", M.f.make_provisioner())
                assert wait(lambda: "default" in rt.provisioning.workers)
                for i in range(2):
                    node = M.f.make_node(
                        name=f"old-{i}", capacity={"cpu": "64", "memory": "256Gi", "pods": "100"},
                        provisioner_name="default",
                        labels={lbl.INSTANCE_TYPE: "fake-it-29", lbl.TOPOLOGY_ZONE: "test-zone-1",
                                lbl.CAPACITY_TYPE: "on-demand"})
                    node.status.conditions = [M.O.PodCondition(type="Ready", status="True")]
                    node.metadata.finalizers = [lbl.TERMINATION_FINALIZER]
                    kubectl.create("nodes", node)
                    kubectl.create("pods", M.f.make_pod(
                        name=f"w-{i}", labels={"workload": "a"}, requests={"cpu": "1"},
                        node_name=f"old-{i}", unschedulable=False,
                        owner=M.O.OwnerReference(api_version="apps/v1", kind="ReplicaSet",
                                                 name="w")))
                assert wait(lambda: sum(n.metadata.name.startswith("old-")
                                        for n in controller.nodes()) == 2
                            and sum(p.metadata.name.startswith("w-")
                                    for p in controller.pods()) == 2, 15)
                consolidation = M.cons.ConsolidationController(controller, provider,
                                                               **on_cpu(M, {"enabled": True}))
                plan = consolidation.plan(controller.get("provisioners", "default", namespace=""))
                rt.provisioning.workers["default"].batcher.idle_duration = 0.1
                launched = consolidation.execute(plan)

                def settled():
                    return (not [n for n in env.cluster.nodes() if n.metadata.name.startswith("old-")]
                            and sum(bool(p.spec.node_name) for p in env.cluster.pods()
                                    if p.metadata.name.endswith("-r")) == 2)

                done = wait(settled, 60)
                landed = [p.spec.node_name for p in env.cluster.pods()
                          if p.metadata.name.endswith("-r")]
                prices = {it.name: it.effective_price() for it in provider.get_instance_types()}
                new_price = sum(prices.get(n.metadata.labels.get(lbl.INSTANCE_TYPE, ""), 0.0)
                                for n in env.cluster.nodes())
                return (consolidation.migration, plan_view(plan), launched, done,
                        len(landed) == 2 and all(landed)
                        and not any(n.startswith("old-") for n in landed),
                        new_price < plan.current_price * 0.5)
            finally:
                rt.stop()

    migration, plan, launched, done, landed, cheaper = both(run)
    assert migration == "evict" and plan["worthwhile"] and launched == []
    assert done and landed and cheaper


def test_bind_migration_rejected_on_apiserver():
    def run(M):
        with kube_env(M) as env:
            c = env.connect(start=False)
            try:
                M.cons.ConsolidationController(c, M.fake.FakeCloudProvider(M.fake.instance_types(5)),
                                               **on_cpu(M, {"migration": "bind"}))
            except ValueError as e:
                return str(e)

    assert "bind migration cannot work" in both(run)


def test_ownerless_pods_block_evict_candidacy():
    def run(M):
        lbl = M.lbl
        with kube_env(M) as env:
            c = env.connect()
            provider = M.fake.FakeCloudProvider(M.fake.instance_types(30))
            c.create("provisioners", M.f.make_provisioner())
            node = M.f.make_node(
                name="bare-host", capacity={"cpu": "64", "memory": "256Gi", "pods": "100"},
                provisioner_name="default",
                labels={lbl.INSTANCE_TYPE: "fake-it-29", lbl.TOPOLOGY_ZONE: "test-zone-1",
                        lbl.CAPACITY_TYPE: "on-demand"})
            node.status.conditions = [M.O.PodCondition(type="Ready", status="True")]
            c.create("nodes", node)
            c.create("pods", M.f.make_pod(name="bare", requests={"cpu": "1"},
                                          node_name="bare-host", unschedulable=False))
            consolidation = M.cons.ConsolidationController(c, provider,
                                                           **on_cpu(M, {"enabled": True}))
            plan = consolidation.plan(c.get("provisioners", "default", namespace=""))
            return consolidation.migration, plan_view(plan)

    migration, plan = both(run)
    assert migration == "evict" and plan["nodes"] == []


def test_ready_node_loses_startup_taint_via_merge_patch():
    def run(M):
        lbl = M.lbl
        with kube_env(M) as env:
            c = env.connect()
            c.create("provisioners", M.f.make_provisioner(ttl_after_empty=600))
            node = M.f.make_node(name="young", provisioner_name="default", capacity={"cpu": "4"})
            node.spec.taints = [M.O.Taint(key=lbl.NOT_READY_TAINT_KEY, effect="NoSchedule")]
            node.status.conditions = [M.O.PodCondition(type="Ready", status="True")]
            c.create("nodes", node)
            M.node.NodeController(c).reconcile("young")
            server = env.cluster.get("nodes", "young", namespace="")
            return (wire_doc(M, "nodes", server)["spec"],
                    lbl.EMPTINESS_TIMESTAMP_ANNOTATION in server.metadata.annotations,
                    server.metadata.finalizers)

    spec, annotated, finalizers = both(run)
    assert all(t["key"] != "karpenter.sh/not-ready" for t in spec.get("taints") or [])
    assert annotated and "karpenter.sh/termination" in finalizers


def test_emptiness_annotation_removed_when_pod_lands():
    def run(M):
        lbl = M.lbl
        with kube_env(M) as env:
            c = env.connect()
            c.create("provisioners", M.f.make_provisioner(ttl_after_empty=600))
            node = M.f.make_node(name="busy", provisioner_name="default", capacity={"cpu": "4"})
            node.status.conditions = [M.O.PodCondition(type="Ready", status="True")]
            c.create("nodes", node)
            controller = M.node.NodeController(c)
            controller.reconcile("busy")

            def annotated():
                return (lbl.EMPTINESS_TIMESTAMP_ANNOTATION
                        in env.cluster.get("nodes", "busy", namespace="").metadata.annotations)

            before = annotated()
            c.create("pods", M.f.make_pod(name="tenant", requests={"cpu": "1"},
                                          node_name="busy", unschedulable=False))
            controller.reconcile("busy")
            return before, annotated()

    assert both(run) == (True, False)
