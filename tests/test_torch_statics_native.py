"""The native statics pass (``scheduling/csrc/statics_native.cpp``) against
the Python ``statics._build``, field for field: the type, the value and the
element order of every ``PodStatics`` slot, and the pod memos both leave
(``_solve_statics``, ``_requests_memo``, ``_host_ports_memo``). Each side
gets its own copy of a pod (a new pod, metadata and spec sharing the
template's deeper objects, as the benchmark's fresh rounds do), so neither
sees the other's memos.

The extension is built (or loaded) at the start of the module; the module
skips only where no C++ compiler is found."""

import random
import shutil
import sys
import threading

import pytest

from karpenter_tpu_torch.api import labels as lbl
from karpenter_tpu_torch.api.objects import (
    Affinity,
    Container,
    ContainerPort,
    LabelSelector,
    NodeAffinity,
    NodeSelectorRequirement,
    NodeSelectorTerm,
    ObjectMeta,
    Pod,
    PodAffinity,
    PodAffinityTerm,
    PodAntiAffinity,
    PodSpec,
    PreferredSchedulingTerm,
    TopologySpreadConstraint,
)
from karpenter_tpu_torch.kube.client import Cluster
from karpenter_tpu_torch.scheduling import statics as S
from karpenter_tpu_torch.scheduling.scheduler import Scheduler
from karpenter_tpu_torch.testing.factories import make_pod
from karpenter_tpu_torch.testing.scenarios import diverse_pods
from torch_parity import fresh_router, mix7, pinned, portbench  # noqa: F401

PORT = "karpenter_tpu_torch"
MEMOS = ("_requests_memo", "_host_ports_memo")


@pytest.fixture(scope="module")
def native():
    mod = S.NATIVE.get(wait=300)
    if mod is None:
        if shutil.which("g++") is None:
            pytest.skip("no C++ compiler to build the native statics pass")
        pytest.fail("the native statics pass did not build")
    return mod


@pytest.fixture
def python_only(native, monkeypatch):
    """The loaded extension hidden for one test: the Python pass serves."""
    def hide():
        monkeypatch.setattr(S.NATIVE, "value", None)

    return hide


def copies(pods, tag):
    return portbench("adapter").fresh(pods, tag)


def same(a, b, where):
    """``a`` and ``b`` equal in type, value and element order, containers
    compared element by element; any other object by identity."""
    assert type(a) is type(b), (where, a, b)
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b), (where, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{where}[{i}]")
    elif isinstance(a, dict):
        assert list(a) == list(b), (where, a, b)
        for k in a:
            same(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, frozenset):
        assert a == b and list(a) == list(b), (where, a, b)
    elif isinstance(a, (str, int, float, bool)) or a is None:
        assert a == b, (where, a, b)
    else:
        assert a is b, (where, a, b)


def assert_same_statics(py_pod, nat_pod):
    """Both pods' statics and memos, slot by slot."""
    a, b = py_pod._solve_statics, nat_pod._solve_statics
    for slot in S.PodStatics.__slots__:
        same(getattr(a, slot), getattr(b, slot), slot)
    assert b.sel_ref is nat_pod.spec.node_selector and b.aff_ref is nat_pod.spec.affinity
    assert b.req is not b.req_tid and b.req_tid is a.req_tid and b.merge_tid is a.merge_tid
    for memo in MEMOS:
        x, y = getattr(py_pod, memo), getattr(nat_pod, memo)
        assert x[0] is py_pod.spec.containers and y[0] is nat_pod.spec.containers, memo
        same(x[1], y[1], memo)
    assert nat_pod._requests_memo[1] is not b.req


def both_passes(pods, python_only, tag=0):
    """The Python pass over one copy of ``pods`` and the native pass over
    another: (python copies, native copies, python profile, native profile)."""
    py_pods, nat_pods = copies(pods, 2 * tag), copies(pods, 2 * tag + 1)
    nat_prof = {}
    S.statics_pass(nat_pods, nat_prof)
    python_only()
    py_prof = {}
    S.statics_pass(py_pods, py_prof)
    return py_pods, nat_pods, py_prof, nat_prof


def req(key, op, *values):
    return NodeSelectorRequirement(key=key, operator=op, values=list(values))


def pod_of(containers=None, labels=None, node_selector=None, affinity=None, spreads=(),
           namespace="default"):
    return Pod(
        metadata=ObjectMeta(name="p", namespace=namespace, labels=dict(labels or {})),
        spec=PodSpec(node_selector=dict(node_selector or {}), affinity=affinity,
                     containers=list(containers if containers is not None else [Container()]),
                     topology_spread_constraints=list(spreads)),
    )


def hand_built():
    """Pods of every shape ``_build`` handles beyond the benchmark's mix."""
    zone_alias = "failure-domain.beta.kubernetes.io/zone"
    selectors = pod_of(
        labels={"b": "2", "a": "1", "c": "3"},
        node_selector={"team": "x", zone_alias: "z1", lbl.TOPOLOGY_REGION: "r1",
                       lbl.HOSTNAME: "h-sel"},
    )
    node_affinity = pod_of(
        node_selector={"team": "x"},
        affinity=Affinity(node_affinity=NodeAffinity(
            required=[
                NodeSelectorTerm([req(lbl.TOPOLOGY_ZONE, "In", "z2", "z1"), req("team", "NotIn", "y"),
                                  req("gpu", "Exists"), req(lbl.TOPOLOGY_REGION, "In", "r")]),
                NodeSelectorTerm([req("rack", "DoesNotExist"), req(lbl.HOSTNAME, "In", "h-pinned")]),
            ],
            preferred=[
                PreferredSchedulingTerm(1, NodeSelectorTerm([req("light", "In", "a")])),
                PreferredSchedulingTerm(5, NodeSelectorTerm([req(zone_alias, "NotIn", "z3"),
                                                             req(lbl.HOSTNAME, "In", "h-pref")])),
                PreferredSchedulingTerm(5, NodeSelectorTerm([req("tie", "Exists")])),
            ],
        )),
    )
    host_in_first = pod_of(affinity=Affinity(node_affinity=NodeAffinity(required=[
        NodeSelectorTerm([req(lbl.HOSTNAME, "In", "h1", "h2"), req(lbl.HOSTNAME, "NotIn", "h3")]),
    ])))
    ports = pod_of(containers=[
        Container(name="a", ports=[ContainerPort(host_port=80), ContainerPort(host_port=0),
                                   ContainerPort(host_port=53, protocol="")]),
        Container(name="b", ports=[ContainerPort(host_port=80, host_ip="10.0.0.1", protocol="UDP"),
                                   ContainerPort(host_port=8080, host_ip="0.0.0.0")]),
    ])
    split_requests = pod_of(containers=[
        Container(name="a", requests={"cpu": 0.5, "memory": 2.0 ** 30}),
        Container(name="b", requests={"example.com/foo": 2.0, "cpu": 0.25, "nvidia.com/gpu": 1}),
        Container(name="c"),
    ])
    selector = LabelSelector(match_labels={"app": "web", "tier": "a"}, match_expressions=[
        req("env", "In", "prod", "dev"), req("canary", "DoesNotExist")])
    terms = pod_of(
        namespace="ns-own",
        affinity=Affinity(
            pod_affinity=PodAffinity(required=[
                PodAffinityTerm(label_selector=selector, topology_key=lbl.TOPOLOGY_ZONE,
                                namespaces=["ns-b", "ns-a"]),
                PodAffinityTerm(label_selector=selector, topology_key="example.com/rack"),
            ]),
            pod_anti_affinity=PodAntiAffinity(required=[
                PodAffinityTerm(label_selector=None, topology_key=lbl.HOSTNAME),
            ]),
        ),
        spreads=[
            TopologySpreadConstraint(max_skew=2, topology_key=lbl.TOPOLOGY_ZONE,
                                     when_unsatisfiable="ScheduleAnyway", label_selector=selector),
            TopologySpreadConstraint(topology_key=lbl.HOSTNAME, label_selector=None),
        ],
    )
    no_containers = pod_of(containers=[])
    plain = make_pod(labels={"my-label": "a"}, requests={"cpu": "100m"})
    return [selectors, node_affinity, host_in_first, ports, split_requests, terms,
            no_containers, plain]


def test_mix7_pods_equal_the_python_build(native, python_only):
    """All seven kinds of the benchmark's pod mix, 2,100 pods."""
    _, _, pods = mix7(2100, 4_422_000_004)
    py_pods, nat_pods, py_prof, nat_prof = both_passes(pods, python_only)
    for a, b in zip(py_pods, nat_pods):
        assert_same_statics(a, b)
    assert nat_prof["statics_built"] == nat_prof["statics_native"] == len(pods)
    assert py_prof["statics_built"] == len(pods) and py_prof["statics_native"] == 0
    assert len({p._solve_statics.topo_code for p in nat_pods}) > 1


@pytest.mark.parametrize("index", range(8))
def test_hand_built_pods_equal_the_python_build(native, python_only, index):
    pod = hand_built()[index]
    (a,), (b,), _, nat_prof = both_passes([pod], python_only)
    assert nat_prof["statics_native"] == 1
    assert_same_statics(a, b)


def test_hand_built_folds_as_written(native):
    """Spot checks of what the hand-built pods exercise, on the native side."""
    pods = copies(hand_built(), 7)
    S.statics_pass(pods)
    sel, na, host_first, ports, split, terms, empty, _ = [p._solve_statics for p in pods]
    assert sel.hostname0 == "h-sel" and lbl.TOPOLOGY_REGION not in sel.constrains
    assert (lbl.TOPOLOGY_ZONE, "In", ("z1",)) in sel.core0
    assert na.pinned_aff_hostname == "h-pinned" and na.aff_hostname == "h-pref"
    assert na.hostname0 == "h-pref" and {"tie", "light", "rack", "gpu"} <= na.constrains
    assert host_first.pinned_aff_hostname is None and host_first.hostname0 is None
    assert ports.host_ports == {("0.0.0.0", 80, "TCP"), ("0.0.0.0", 53, "TCP"),
                                ("10.0.0.1", 80, "UDP"), ("0.0.0.0", 8080, "TCP")}
    assert split.req == {"cpu": 0.75, "memory": 2.0 ** 30, "example.com/foo": 2.0,
                         "nvidia.com/gpu": 1.0, "pods": 1.0}
    assert split.extra_res == {"example.com/foo"} and type(split.req["nvidia.com/gpu"]) is float
    assert [t[0][1] for t in terms.aff_terms] == [("ns-a", "ns-b"), ("ns-own",)]
    assert len(terms.spreads) == 2 and terms.topo_any and terms.topo_code > 0
    assert empty.req == {"pods": 1.0} and not empty.topo_any and empty.topo_code == 0


def test_diverse_pods_equal_the_python_build(native, python_only):
    pods = diverse_pods(700, random.Random(3))
    py_pods, nat_pods, _, nat_prof = both_passes(pods, python_only)
    for a, b in zip(py_pods, nat_pods):
        assert_same_statics(a, b)
    assert nat_prof["statics_native"] == len(pods)


def test_memos_left_by_the_python_path_are_read(native):
    """A pod that already holds the requests and host-port memos the
    Python path leaves (as after ``Preferences.relax`` replaced its
    affinity) is built natively from those memos."""
    pods = copies(hand_built(), 11)
    for p in pods:
        p._solve_statics = S._build(p)
    twins = copies(pods, 12)
    for p, t in zip(pods, twins):
        for memo in MEMOS:
            setattr(t, memo, getattr(p, memo))
        t._solve_statics = native.build(t, S.NATIVE_CTX)
        assert t._solve_statics is not None
    for p, t in zip(pods, twins):
        assert_same_statics(p, t)


def test_replacing_selector_or_affinity_rebuilds(native):
    pods = copies(hand_built()[:2], 13)
    prof = {}
    sts = S.statics_pass(pods, prof)
    assert prof["statics_native"] == 2
    again = {}
    assert S.statics_pass(pods, again) == sts and again["statics_built"] == 0
    pods[0].spec.node_selector = dict(pods[0].spec.node_selector)  # equal items: kept
    pods[1].spec.affinity = Affinity()  # relaxed away: rebuilt
    third = {}
    out = S.statics_pass(pods, third)
    assert out[0] is sts[0] and out[0].sel_ref is pods[0].spec.node_selector
    assert out[1] is not sts[1] and third["statics_built"] == third["statics_native"] == 1
    assert out[1].pinned_aff_hostname is None and out[1].core0 == (("team", "In", ("x",)),)
    pods[0].spec.node_selector = {**pods[0].spec.node_selector, "team": "y"}
    fourth = {}
    out = S.statics_pass(pods, fourth)
    assert fourth["statics_built"] == 1 and ("team", "In", ("y",)) in out[0].core0


def test_statics_native_counts_native_builds_only(native):
    """A pod of a shape the native pass does not cover (a node selector
    that is no dict) falls back to the Python build: ``statics_built``
    counts it, ``statics_native`` does not, and the two agree on it."""
    class Selector(dict):
        pass

    pods = copies(hand_built(), 15)
    odd = copies(hand_built(), 16)[0]
    odd.spec.node_selector = Selector(odd.spec.node_selector)
    prewarmed = pods[:3]
    S.statics_pass(prewarmed)
    prof = {}
    S.statics_pass(pods + [odd], prof)
    assert prof["statics_built"] == len(pods) - 3 + 1
    assert prof["statics_native"] == len(pods) - 3
    twin = copies(hand_built(), 17)[0]
    twin.spec.node_selector = odd.spec.node_selector
    twin._solve_statics = S._build(twin)
    assert_same_statics(twin, odd)


def test_without_the_extension_plans_are_identical(native, python_only):
    """A 2,000-pod mix7 solve on a cpu scheduler, with the native pass and
    without it: the same plan; ``statics_native`` is 0 without it."""
    prov, catalog, pods = mix7(2000, 9_000_000_001, n_types=400)
    adapter = portbench("adapter")
    plans, profs = [], []
    for side in ("native", "python"):
        if side == "python":
            python_only()
        round_pods = copies(pods, 20 + len(plans))
        sched = Scheduler(Cluster(), rng=random.Random(1), device="cpu")
        with pinned(PORT):
            nodes = sched.solve(prov, catalog, round_pods)
        plans.append(adapter.plan(nodes, round_pods))
        profs.append(sched.last_stage_profile())
    assert plans[0] == plans[1]
    assert [p["statics_native"] for p in profs] == [2000, 0]
    assert [p["statics_built"] for p in profs] == [2000, 2000]


def test_two_threads_assign_one_code_per_new_topology_class(native):
    """Two threads build the statics of overlapping pods whose topology
    classes are new (a label no earlier pod selected), with a short switch
    interval: every class gets one code, and distinct classes distinct
    codes."""
    tag = f"t{random.Random().getrandbits(48)}"
    templates = []
    for i in range(24):
        spread = TopologySpreadConstraint(topology_key=lbl.TOPOLOGY_ZONE,
                                          label_selector=LabelSelector({"cls": f"{tag}-{i % 8}"}))
        templates.append(make_pod(labels={"cls": f"{tag}-{i % 8}"}, requests={"cpu": "1"},
                                  topology=[spread]))
    shared = copies(templates, 31)
    lists = [shared[:16] + copies(templates[16:], 32), copies(templates[:8], 33) + shared[8:]]
    start = threading.Barrier(2)
    out, errors = [None, None], []

    def work(i):
        try:
            start.wait(timeout=30)
            out[i] = S.statics_pass(lists[i])
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not errors and not any(t.is_alive() for t in threads)
    codes = {}
    for sts in out:
        for st in sts:
            codes.setdefault(st.spreads[0][0], set()).add(st.topo_code)
    assert len(codes) == 8 and all(len(c) == 1 for c in codes.values())
    assert len({c for cs in codes.values() for c in cs}) == 8
