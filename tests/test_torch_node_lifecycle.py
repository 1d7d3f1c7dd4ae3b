"""The port's node lifecycle after launch against the JAX package's.

The cases of the reference's ``tests/test_node_lifecycle.py`` and
``tests/test_termination.py`` run on both packages with the same
injectable clock, and each result is compared between them: the node
controller's sub-reconcilers (initialization, expiration, emptiness,
finalizer) and their requeues, its single merge patch, termination's
cordon → drain → cloud delete → finalizer removal with do-not-evict,
critical-last, static, tolerating and PDB-blocked pods. Then
``MissTracker`` and ``CloudLiveness`` over a scripted ``instance_gone``,
both metrics controllers (the gauge samples each publishes and removes),
and ``freeze_after_warmup`` / ``restore``. The ``_freeze_gc_when_warm``
cases of ``tests/test_gcpolicy.py`` wait for the port's ``main.py``.
"""

import gc
import threading

import pytest

from torch_parity import PACKAGES, deprov, fresh_router  # noqa: F401


def both(fn):
    """``fn(M)`` on each package; the port's result, once it equals the
    reference's."""
    ref, out = (fn(deprov(pkg)) for pkg in PACKAGES)
    assert out == ref
    return out


def node_state(node):
    if node is None:
        return None
    return (node.metadata.deletion_timestamp is not None, node.spec.unschedulable,
            [t.key for t in node.spec.taints], sorted(node.metadata.annotations),
            list(node.metadata.finalizers))


# -- the node controller -----------------------------------------------------

# case -> (provisioner kwargs, node kwargs, [seconds to advance before each
# reconcile], pods to bind before the second reconcile)
NODE_CASES = {
    "ready removes the startup taint": ({}, {"ready": True, "not_ready_taint": True}, [0], 0),
    "taint kept while not ready": ({}, {"ready": False, "not_ready_taint": True}, [0], 0),
    "unready deleted after the init timeout": ({}, {"ready": False, "not_ready_taint": True},
                                               [15 * 60 + 1], 0),
    "other taints untouched": ({}, {"ready": True, "not_ready_taint": True, "dedicated": True},
                               [0], 0),
    "expires after its ttl": ({"ttl_until_expired": 60}, {}, [0, 61], 0),
    "no ttl no expiry": ({}, {}, [10_000_000], 0),
    "empty annotated then deleted": ({"ttl_after_empty": 30}, {"ready": True}, [0, 31], 0),
    "annotation removed when a pod lands": ({"ttl_after_empty": 30}, {"ready": True},
                                            [0, 0, 1000], 1),
    "daemonset pods do not count": ({"ttl_after_empty": 30}, {"ready": True}, [0], "ds"),
    "not ready skipped by emptiness": ({"ttl_after_empty": 30}, {"ready": False}, [0], 0),
    "finalizer added to a self-registered node": ({}, {"finalizers": []}, [0], 0),
    "double delete keeps the finalizer": ({"ttl_until_expired": 60},
                                          {"ready": False, "not_ready_taint": True},
                                          [15 * 60 + 1], 0),
    "requeue is the soonest": ({"ttl_after_empty": 30, "ttl_until_expired": 600},
                               {"ready": True}, [0], 0),
}


@pytest.mark.parametrize("case", sorted(NODE_CASES))
def test_node_controller(case):
    prov_kw, node_kw, steps, pods = NODE_CASES[case]

    def run(M):
        lbl, O = M.lbl, M.O
        now = [1000.0]
        cluster = M.Cluster(clock=lambda: now[0])
        controller = M.node.NodeController(cluster)
        cluster.create("provisioners", M.f.make_provisioner(**prov_kw))
        taints = []
        if node_kw.get("not_ready_taint"):
            taints.append(O.Taint(key=lbl.NOT_READY_TAINT_KEY, effect="NoSchedule"))
        if node_kw.get("dedicated"):
            taints.append(O.Taint(key="dedicated", value="team", effect="NoSchedule"))
        finalizers = node_kw.get("finalizers", [lbl.TERMINATION_FINALIZER])
        cluster.create("nodes", M.f.make_node(
            name="n", provisioner_name="default", ready=node_kw.get("ready", True), taints=taints,
            finalizers=finalizers))
        out = []
        for i, dt in enumerate(steps):
            now[0] += dt
            if i == 1 and pods:
                pod = M.f.make_pod(name="landed", node_name="n", unschedulable=False)
                cluster.create("pods", pod)
            if pods == "ds" and i == 0:
                pod = M.f.make_pod(name="ds-pod", node_name="n", unschedulable=False)
                pod.metadata.owner_references.append(
                    O.OwnerReference(api_version="apps/v1", kind="DaemonSet", name="ds"))
                cluster.create("pods", pod)
            out.append((controller.reconcile("n"),
                        node_state(cluster.try_get("nodes", "n", namespace=""))))
        return out

    got = both(run)
    last = got[-1][1]
    if "deleted" in case or "expires" in case or "double delete" in case:
        assert last[0] and last[4] == ["karpenter.sh/termination"]
    if case == "requeue is the soonest":
        assert got[0][0] == pytest.approx(30.0)


def test_non_karpenter_node_ignored_and_result_min():
    def run(M):
        cluster = M.Cluster()
        cluster.create("nodes", M.f.make_node(name="plain"))
        return (M.node.NodeController(cluster).reconcile("plain"),
                M.node.result_min(None, 5.0, 2.0, None), M.node.result_min(None, None))

    assert both(run) == (None, 2.0, None)


@pytest.mark.parametrize("case", ["failed patch", "annotations only"])
def test_merge_patch_discipline(case):
    """Sub-reconcilers run on a copy and the node goes out as ONE merge
    patch of exactly the changed fields; a failed patch leaves the cached
    node untouched and the retry converges."""
    def run(M):
        lbl, O = M.lbl, M.O
        cluster = M.Cluster(clock=lambda: 1000.0)
        cluster.create("provisioners", M.f.make_provisioner(
            ttl_after_empty=600 if case == "annotations only" else None))
        node = M.f.make_node(name="n", provisioner_name="default", capacity={"cpu": "4"},
                             finalizers=[lbl.TERMINATION_FINALIZER])
        if case == "failed patch":
            node.spec.taints = [O.Taint(key=lbl.NOT_READY_TAINT_KEY, effect="NoSchedule")]
        node.metadata.annotations["unrelated.io/key"] = "theirs"
        cluster.create("nodes", node)
        patches, real = [], cluster.merge_patch
        fail = [case == "failed patch"]

        def spy(kind, name, patch, namespace="default"):
            patches.append(patch)
            if fail and fail.pop():
                raise RuntimeError("transient apiserver error")
            return real(kind, name, patch, namespace=namespace)

        cluster.merge_patch = spy
        out = []
        for _ in range(2 if case == "failed patch" else 1):
            try:
                out.append(M.node.NodeController(cluster).reconcile("n"))
            except RuntimeError as e:
                out.append(str(e))
            out.append(node_state(cluster.get("nodes", "n", namespace="")))
        return out, patches

    out, patches = both(run)
    if case == "failed patch":
        assert out[0] == "transient apiserver error" and "karpenter.sh/not-ready" in out[1][2]
        assert out[3][2] == [] and patches == [{"spec": {"taints": []}}] * 2
    else:
        (patch,) = patches
        assert list(patch["metadata"]["annotations"]) == [lbl_emptiness()]


def lbl_emptiness():
    return deprov("karpenter_tpu_torch").lbl.EMPTINESS_TIMESTAMP_ANNOTATION


# -- termination -------------------------------------------------------------

TERMINATION_CASES = ["empty", "cordoned before drain", "drain evicts then terminates",
                     "do-not-evict blocks", "critical last", "static ignored",
                     "tolerating ignored", "pdb blocks with 429", "no finalizer", "live node"]


@pytest.mark.parametrize("case", TERMINATION_CASES)
def test_termination(case):
    def run(M):
        lbl, O, f = M.lbl, M.O, M.f
        now = [1000.0]
        cluster = M.Cluster(clock=lambda: now[0])
        provider = M.fake.FakeCloudProvider(M.fake.instance_types(5))
        controller = M.term.TerminationController(cluster, provider, start_queue=False)
        cluster.create("nodes", f.make_node(
            name="n", provisioner_name="default",
            finalizers=[] if case == "no finalizer" else [lbl.TERMINATION_FINALIZER]))
        if case != "live node":
            cluster.delete("nodes", "n", namespace="")
        pods = []
        if case not in ("empty", "no finalizer", "live node"):
            pods.append(f.make_pod(name="a", node_name="n", unschedulable=False,
                                   labels={"app": "db"}))
        if case == "do-not-evict blocks":
            pods[0].metadata.annotations[lbl.DO_NOT_EVICT_ANNOTATION] = "true"
        if case == "critical last":
            pods.append(f.make_pod(name="crit", node_name="n", unschedulable=False))
            pods[1].spec.priority_class_name = "system-node-critical"
        if case == "static ignored":
            pods[0].metadata.owner_references.append(
                O.OwnerReference(api_version="v1", kind="Node", name="n"))
        if case == "tolerating ignored":
            pods[0].spec.tolerations = [O.Toleration(operator="Exists")]
        if case == "pdb blocks with 429":
            cluster.create("pdbs", f.make_pdb(labels={"app": "db"}, min_available=1))
        for p in pods:
            cluster.create("pods", p)
        q = controller.eviction_queue
        out = []
        for _ in range(3):
            out.append(controller.reconcile("n"))
            drained = []
            while len(q.queue):
                key = q.queue.get(timeout=0.1)
                if key is None:
                    break
                drained.append(q.process_one(key))
            out.append((drained, sorted(p.metadata.name for p in cluster.pods()),
                        node_state(cluster.try_get("nodes", "n", namespace=""))))
        return out, provider.delete_calls

    out, deleted = both(run)
    terminated = case not in ("do-not-evict blocks", "pdb blocks with 429", "no finalizer",
                              "live node")
    assert deleted == (["n"] if terminated else [])
    assert (out[-1][2] is None) == (terminated or case == "no finalizer")
    if case == "critical last":
        assert out[1][1] == ["crit"]  # the non-critical pod went first


def test_is_stuck_terminating():
    def run(M):
        pod = M.f.make_pod(unschedulable=False)
        out = [M.term.is_stuck_terminating(pod, 1000.0)]
        pod.metadata.deletion_timestamp = 900.0
        return out + [M.term.is_stuck_terminating(pod, t) for t in (920.0, 931.0)]

    assert both(run) == [False, False, True]


def test_eviction_queue_thread_drains_and_stops():
    def run(M):
        cluster = M.Cluster()
        pods = [M.f.make_pod(name=f"e{i}", node_name="n", unschedulable=False) for i in range(20)]
        for p in pods:
            cluster.create("pods", p)
        queue = M.term.EvictionQueue(cluster)
        try:
            queue.add(pods + pods)  # in-flight keys are not queued twice
            done = threading.Event()
            cluster.watch("pods", lambda e, o: not cluster.pods() and done.set())
            done.wait(timeout=10)
        finally:
            queue.stop()
        return len(cluster.pods()), queue._thread.is_alive()

    assert both(run) == (0, False)


# -- liveness ----------------------------------------------------------------


def test_miss_tracker():
    def run(M):
        t = M.liveness.MissTracker(threshold=3)
        out = [t.observe("i-1", present=False) for _ in range(3)]
        t.observe("i-2", present=False)
        t.observe("i-2", present=False)
        t.observe("i-2", present=True)
        out += [t.observe("i-2", present=False), t.misses("i-2"), t.misses("i-9")]
        t.forget("i-1")
        small = M.liveness.MissTracker(threshold=0)
        small.MAX_SUBJECTS = 4
        for i in range(10):
            small.observe(f"s{i}", present=False)
        return out + [t.misses("i-1"), sorted(small._misses)]

    assert both(run) == [False, False, True, False, 1, 0, 0, ["s6", "s7", "s8", "s9"]]


def test_cloud_liveness():
    """A scripted ``instance_gone``: probes rate-limited per node, a failed
    or unknown probe keeps the cadence, NotImplemented opts out, a
    confirmed-gone node goes to termination."""
    def run(M):
        now = [0.0]
        cluster = M.Cluster(clock=lambda: now[0])
        cluster.create("nodes", M.f.make_node(name="n", provisioner_name="default",
                                              finalizers=[M.lbl.TERMINATION_FINALIZER]))
        answers = [False, None, RuntimeError("describe failed"), NotImplemented, True]
        calls = []

        class Provider:
            def instance_gone(self, node):
                calls.append(node.metadata.name)
                answer = answers.pop(0)
                if isinstance(answer, Exception):
                    raise answer
                return answer

        liveness = M.node.CloudLiveness(cluster, Provider())
        out = []
        for dt in (0, 10, 21, 31, 31, 0, 0):
            now[0] += dt
            node = cluster.get("nodes", "n", namespace="")
            out.append((liveness.reconcile(None, node), len(calls),
                        node.metadata.deletion_timestamp is not None))
        return out

    got = both(run)
    assert got[1] == (20.0, 1, False)  # rate-limited inside the probe window
    assert got[-1][2]  # the confirmed-gone node is terminating


# -- metrics controllers -----------------------------------------------------


def samples(M, family, key):
    out = []
    for metric in M.metrics.REGISTRY.collect():
        if metric.name == family:
            out += [s.labels for s in metric.samples if s.labels.get(key, "").startswith("lc-")]
    return sorted(tuple(sorted(s.items())) for s in out)


def test_node_metrics_publish_and_remove():
    def run(M):
        lbl, O = M.lbl, M.O
        cluster = M.Cluster()
        controller = M.mnode.NodeMetricsController(cluster)
        cluster.create("nodes", M.f.make_node(
            name="lc-node", capacity={"cpu": "4", "memory": "8Gi"},
            allocatable={"cpu": "3.8", "memory": "7Gi"}, provisioner_name="default",
            labels={lbl.TOPOLOGY_ZONE: "z1", lbl.INSTANCE_TYPE: "t3", lbl.ARCH: "amd64",
                    lbl.CAPACITY_TYPE: "on-demand"}))
        cluster.create("pods", M.f.make_pod(name="lc-a", node_name="lc-node",
                                            unschedulable=False, requests={"cpu": "1"}))
        ds = M.f.make_pod(name="lc-ds", node_name="lc-node", unschedulable=False,
                          requests={"cpu": "0.2"})
        ds.metadata.owner_references.append(
            O.OwnerReference(api_version="apps/v1", kind="DaemonSet", name="ds"))
        cluster.create("pods", ds)
        controller.reconcile("lc-node")
        families = ("karpenter_nodes_allocatable", "karpenter_nodes_total_pod_requests",
                    "karpenter_nodes_total_daemon_requests", "karpenter_nodes_system_overhead")
        published = {fam: samples(M, fam, "node_name") for fam in families}
        cluster.delete("nodes", "lc-node", namespace="")
        controller.reconcile("lc-node")
        return published, [samples(M, fam, "node_name") for fam in families]

    published, after = both(run)
    assert all(published.values()) and after == [[]] * 4


def test_pod_metrics_state_gauge_lifecycle():
    def run(M):
        cluster = M.Cluster()
        controller = M.mpod.PodMetricsController(cluster)
        cluster.create("nodes", M.f.make_node(name="pm-node", provisioner_name="default",
                                              labels={M.lbl.TOPOLOGY_ZONE: "z9"}))
        pod = M.f.make_pod(name="lc-pod", node_name="pm-node", unschedulable=False,
                           owner=M.O.OwnerReference(api_version="apps/v1", kind="ReplicaSet",
                                                    name="rs"))
        cluster.create("pods", pod)
        controller.reconcile("lc-pod")
        published = samples(M, "karpenter_pods_state", "name")
        cluster.delete("pods", "lc-pod")
        controller.reconcile("lc-pod")
        return published, samples(M, "karpenter_pods_state", "name")

    published, after = both(run)
    assert len(published) == 1 and ("owner", "ReplicaSet/rs") in published[0] and after == []


# -- the GC policy -----------------------------------------------------------


def test_freeze_after_warmup_and_restore():
    def run(M):
        before = gc.get_threshold()
        cancel = threading.Event()
        cancel.set()
        try:
            M.gcpolicy.freeze_after_warmup(unless=cancel)
            out = [gc.get_threshold() == before]
            M.gcpolicy.freeze_after_warmup(gen0_threshold=12345)
            M.gcpolicy.freeze_after_warmup(gen0_threshold=99999)  # idempotent
            out += [gc.get_threshold()[0], gc.get_freeze_count() > 0]
        finally:
            M.gcpolicy.restore()
        M.gcpolicy.restore()  # idempotent
        return out + [gc.get_threshold() == before, gc.get_freeze_count()]

    assert both(run) == [True, 12345, True, True, 0]
