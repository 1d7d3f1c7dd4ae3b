"""The native validate pass (``solver/csrc/validate_native.cpp``) against
``TorchScheduler._validate_pack``'s Python loop: on every planted plan the
same result and the same message, the pass's own verdict (-1 passes, a
node's index, -2 undecided) as planted, and a node it names the first that
the loop finds at fault. Random plans hold the same, and a CPU solve of new
pods takes the native verdict (``native`` on ``solve.validate``,
``validate_native`` in the stage profile).

The extension is built (or loaded) at the start of the module; the module
skips only where no C++ compiler is found."""

import random
import shutil

import numpy as np
import pytest

import karpenter_tpu_torch.obs as T_OBS
from karpenter_tpu_torch.api.objects import Container, ObjectMeta, Pod, PodSpec
from karpenter_tpu_torch.cloudprovider.types import InstanceType
from karpenter_tpu_torch.kube.client import Cluster
from karpenter_tpu_torch.scheduling import statics as S
from karpenter_tpu_torch.scheduling.ffd import VirtualNode
from karpenter_tpu_torch.scheduling.scheduler import Scheduler
from karpenter_tpu_torch.solver import validate as val
from karpenter_tpu_torch.solver.backend import InvalidPackError, TorchScheduler
from karpenter_tpu_torch.utils import resources as res
from torch_parity import fresh_router, mix7, pinned, portbench  # noqa: F401

PORT = "karpenter_tpu_torch"
PASSED, UNDECIDED = -1, -2
GI = 2.0**30
validate_pack = TorchScheduler._validate_pack


@pytest.fixture(scope="module")
def native():
    mod = val.NATIVE.get(wait=300)
    if mod is None:
        if shutil.which("g++") is None:
            pytest.skip("no C++ compiler to build the native validate pass")
        pytest.fail("the native validate pass did not build")
    return mod


def pod(name, ns="default", *containers):
    """A pod of one container per requests dict (one cpu, 1 Gi by default)."""
    return pods_of(name, ns, containers or ({"cpu": 1.0, "memory": GI},))


def pods_of(name, ns, containers):
    return Pod(metadata=ObjectMeta(name=name, namespace=ns),
               spec=PodSpec(containers=[Container(requests=dict(r)) for r in containers]))


def itype(name, **resources):
    return InstanceType(name=name, resources={"pods": 8.0, **resources})


SMALL = itype("small", cpu=2.0, memory=4 * GI)
LARGE = itype("large", cpu=8.0, memory=32 * GI)
GPU = InstanceType("gpu", resources={"pods": 8.0, "cpu": 8.0, "memory": 32 * GI,
                                     res.NVIDIA_GPU: 1.0})


def node(options, *pods):
    return VirtualNode(constraints=None, instance_type_options=list(options), pods=list(pods))


def batch(*names, ns="default"):
    return {n: pod(n, ns) for n in names}


# -- the planted cases: (nodes, batch pods, daemon) and the pass's verdict ------


def clean():
    p = batch("a", "b", "c", "d")
    return [node([SMALL], p["a"]), node([LARGE], p["b"], p["c"], p["d"])], list(p.values()), {}


def placed_twice():
    p = batch("a", "b", "c")
    return [node([LARGE], p["a"], p["b"]), node([LARGE], p["c"], p["a"])], list(p.values()), {}


def stranger_key_in_batch():
    p = batch("a", "b")
    return [node([LARGE], p["a"], pod("b"))], list(p.values()), {}


def stranger_key_not_in_batch():
    p = batch("a", "b")
    return [node([LARGE], p["a"], pod("z"))], list(p.values()), {}


def one_key_two_objects():
    p = batch("a", "b")
    twin = pod("a")
    return [node([LARGE], p["a"]), node([LARGE], p["b"], twin)], [*p.values(), twin], {}


def one_key_two_objects_one_placed():
    p = batch("a", "b")
    twin = pod("a")
    return [node([LARGE], p["a"], p["b"])], [*p.values(), twin], {}


def repeated_batch_object():
    p = batch("a", "b")
    return [node([LARGE], *p.values())], [p["a"], p["a"], p["b"]], {}


def slash_namespace_collides():
    first, second = pod("c", "team/x"), pod("x/c", "team")  # both "team/x/c"
    return [node([LARGE], first), node([LARGE], second)], [first, second], {}


def slash_namespace_clean():
    p = batch("a", "b", ns="team/x")
    return [node([LARGE], *p.values())], list(p.values()), {}


def no_options():
    p = batch("a", "b")
    return [node([LARGE], p["a"]), node([], p["b"])], list(p.values()), {}


def overfull():
    p = batch("a", "b", "c", "d")
    return [node([LARGE], p["a"]), node([SMALL], p["b"], p["c"], p["d"])], list(p.values()), {}


def later_option():
    p = batch("a", "b", "c")
    return [node([SMALL, LARGE], *p.values())], list(p.values()), {}


def daemon_tips():
    p = {n: pod(n, "default", {"cpu": 0.8}) for n in "ab"}
    return [node([SMALL], *p.values())], list(p.values()), {"cpu": 0.5}


def daemon_fits():
    p = {n: pod(n, "default", {"cpu": 0.8}) for n in "ab"}
    return [node([SMALL], *p.values())], list(p.values()), {"cpu": 0.4}


def sub_milli_fits():
    # 0.1 + 0.2 is 0.30000000000000004 in binary: round(300.00000000000006) fits 0.3
    a, b = pod("a", "default", {"cpu": 0.1}), pod("b", "default", {"cpu": 0.2})
    return [node([itype("milli", cpu=0.3)], a, b)], [a, b], {}


def sub_milli_against_0_35():
    a, b = pod("a", "default", {"cpu": 0.1}), pod("b", "default", {"cpu": 0.25})
    return [node([itype("milli", cpu=0.35)], a, b)], [a, b], {}


def sub_milli_overflows():
    a, b = pod("a", "default", {"cpu": 0.1}), pod("b", "default", {"cpu": 0.25})
    return [node([itype("milli", cpu=0.349)], a, b)], [a, b], {}


def half_to_even():
    # round(2.5) is 2 (round(3.5) is 4): 2.5 milli fits 2 milli, 3.5 does not fit 3
    a = pod("a", "default", {"cpu": 0.0025})
    b = pod("b", "default", {"cpu": 0.0035})
    return ([node([itype("two", cpu=0.002)], a), node([itype("three", cpu=0.003)], b)],
            [a, b], {})


def extended_missing_then_present():
    a = pod("a", "default", {"cpu": 1.0, "nvidia.com/gpu": 1.0})
    return [node([LARGE, GPU], a)], [a], {}


def extended_missing():
    a = pod("a", "default", {"cpu": 1.0, "nvidia.com/gpu": 1.0})
    return [node([SMALL, LARGE], a)], [a], {}


def two_containers_no_memo():
    a = pod("a", "default", {"cpu": 0.75, "memory": GI}, {"cpu": 0.75, "ephemeral-storage": GI})
    b = pod("b", "default", {"cpu": 0.5})
    return [node([SMALL], a, b)], [a, b], {"memory": 0.5 * GI}


def with_requests_memo():
    nodes, pods, daemon = two_containers_no_memo()
    for p in pods:
        res.requests_for_pods(p)
    return nodes, pods, daemon


def with_statics():
    nodes, pods, daemon = two_containers_no_memo()
    for p in pods:
        S.statics(p)
    return nodes, pods, daemon


def stale_memo():
    """A memo whose containers token is an older list: both sides re-sum
    the pod's containers, which overflow the node the memo would fit."""
    a = pod("a", "default", {"cpu": 0.5})
    res.requests_for_pods(a)
    a.spec.containers = [Container(requests={"cpu": 3.0})]
    return [node([SMALL], a)], [a], {}


def int_quantities():
    a = pod("a", "default", {"cpu": 1, "memory": 2**30})
    b = pod("b", "default", {"cpu": 1})
    return [node([itype("ints", cpu=2, memory=4 * 2**30)], a, b)], [a, b], {"memory": 1}


def numpy_quantity():
    a = pod("a", "default", {"cpu": np.float64(1.5)})
    return [node([SMALL], a)], [a], {}


def tuple_of_pods():
    nodes, pods, daemon = clean()
    return nodes, tuple(pods), daemon


def empty_plan():
    return [], list(batch("a").values()), {"cpu": 1.0}


CASES = {
    # name: (its plan, the pass's verdict, the loop's message or None)
    "clean": (clean, PASSED, None),
    "placed_twice": (placed_twice, 1, "pod default/a assigned to more than one node"),
    "stranger_key_in_batch": (stranger_key_in_batch, UNDECIDED, None),
    "stranger_key_not_in_batch": (stranger_key_not_in_batch, UNDECIDED,
                                  "pod default/z not part of this batch"),
    "one_key_two_objects": (one_key_two_objects, 1, "pod default/a assigned to more than one node"),
    "one_key_two_objects_one_placed": (one_key_two_objects_one_placed, PASSED, None),
    "repeated_batch_object": (repeated_batch_object, UNDECIDED, None),
    "slash_namespace_collides": (slash_namespace_collides, UNDECIDED,
                                 "pod team/x/c assigned to more than one node"),
    "slash_namespace_clean": (slash_namespace_clean, UNDECIDED, None),
    "no_options": (no_options, 1, "node 1 has no surviving instance type"),
    "overfull": (overfull, 1, "node 1 capacity exceeded: {cpu: 3, memory: 3.22123e+09, pods: 3} "
                 "fits none of its surviving instance types"),
    "later_option": (later_option, PASSED, None),
    "daemon_tips": (daemon_tips, 0, "node 0 capacity exceeded: {cpu: 2.1, pods: 2}"),
    "daemon_fits": (daemon_fits, PASSED, None),
    "sub_milli_fits": (sub_milli_fits, PASSED, None),
    "sub_milli_against_0_35": (sub_milli_against_0_35, PASSED, None),
    "sub_milli_overflows": (sub_milli_overflows, 0,
                            "node 0 capacity exceeded: {cpu: 0.35, pods: 2}"),
    "half_to_even": (half_to_even, 1, "node 1 capacity exceeded: {cpu: 0.0035, pods: 1}"),
    "extended_missing_then_present": (extended_missing_then_present, PASSED, None),
    "extended_missing": (extended_missing, 0,
                         "node 0 capacity exceeded: {cpu: 1, nvidia.com/gpu: 1"),
    "two_containers_no_memo": (two_containers_no_memo, 0, "node 0 capacity exceeded: {cpu: 2"),
    "with_requests_memo": (with_requests_memo, 0, "node 0 capacity exceeded: {cpu: 2"),
    "with_statics": (with_statics, 0, "node 0 capacity exceeded: {cpu: 2"),
    "stale_memo": (stale_memo, 0, "node 0 capacity exceeded: {cpu: 3, pods: 1}"),
    "int_quantities": (int_quantities, PASSED, None),
    "numpy_quantity": (numpy_quantity, UNDECIDED, None),
    "tuple_of_pods": (tuple_of_pods, PASSED, None),
    "empty_plan": (empty_plan, PASSED, None),
}


def loop_alone(nodes, pods, daemon):
    """``_validate_pack`` with the extension not loaded: the Python loop."""
    val.NATIVE.get = lambda wait=None: None
    try:
        out = validate_pack(nodes, pods, daemon)
        assert val.last.native is False
        return out
    finally:
        del val.NATIVE.get  # the loader's own method again


def first_node_at_fault(nodes, pods, daemon) -> None:
    """Nothing before the node a verdict names is at fault in the loop,
    and the loop finds a fault once that node is in."""
    i = native_verdict(nodes, pods, daemon)
    assert loop_alone(nodes[:i], pods, daemon) is None, i
    assert loop_alone(nodes[:i + 1], pods, daemon) is not None, i


def native_verdict(nodes, pods, daemon) -> int:
    return val.NATIVE.get().validate(nodes, pods, daemon, val.CTX)


@pytest.mark.parametrize("name", CASES)
def test_the_pass_and_the_loop_agree(native, name):
    build, verdict, message = CASES[name]
    nodes, pods, daemon = build()
    memos = [hasattr(p, "_requests_memo") for p in pods]
    assert native.validate(nodes, pods, daemon, val.CTX) == verdict
    assert [hasattr(p, "_requests_memo") for p in pods] == memos  # the pass writes no memo
    got = validate_pack(nodes, pods, daemon)
    assert val.last.native is (verdict == PASSED)
    want = loop_alone(nodes, pods, daemon)
    assert got == want
    if message is None:
        assert want is None
    else:
        assert want.startswith(message), want
    if verdict >= 0:
        first_node_at_fault(nodes, pods, daemon)


def test_without_the_extension_the_loop_serves(native, monkeypatch):
    """The loader returning None: the loop gives every verdict, the same."""
    monkeypatch.setattr(val.NATIVE, "get", lambda wait=None: None)
    for name, (build, _, message) in CASES.items():
        out = validate_pack(*build())
        assert val.last.native is False
        assert (out is None) if message is None else out.startswith(message), name


def test_a_quantity_python_cannot_round_raises_in_both(native):
    """A NaN request: the loop's ``round`` raises; the pass leaves it to it."""
    a = pod("a", "default", {"cpu": float("nan")})
    nodes, pods = [node([SMALL], a)], [a]
    assert native.validate(nodes, pods, {}, val.CTX) == UNDECIDED
    for check in (lambda: validate_pack(nodes, pods, {}), lambda: loop_alone(nodes, pods, {})):
        with pytest.raises(ValueError):
            check()


def random_plan(rng: random.Random):
    """A plan of random pods, keys, quantities and memos over random
    options, with now and then a stranger, a repeat or an empty node."""
    quantities = [0.1, 0.2, 0.25, 0.35, 0.0005, 0.0025, 0.5, 1.0, 1.5, 2.0, 3]
    names = ["cpu", "memory", "pods", "nvidia.com/gpu"]
    namespaces = ["default", "team-a", "team-a/b"] if rng.random() < 0.2 else ["default", "team-a"]

    def requests():
        chosen = rng.sample(["cpu", "memory", "nvidia.com/gpu"], rng.randint(0, 2))
        return {n: rng.choice(quantities) for n in chosen}

    pods = []
    for i in range(rng.randint(1, 40)):
        key = rng.randrange(60) if rng.random() < 0.1 else i
        containers = [requests() for _ in range(rng.randint(0, 2))]
        p = pods_of(f"p{key}", rng.choice(namespaces), containers)
        memo = rng.random()
        if memo < 0.3:
            res.requests_for_pods(p)
        elif memo < 0.4:
            S.statics(p)
        pods.append(p)
    catalog = [InstanceType(f"t{j}", resources={n: rng.choice(quantities) * rng.choice([1, 2, 4])
                                                for n in rng.sample(names, rng.randint(1, 4))})
               for j in range(6)]
    order = list(pods)
    rng.shuffle(order)
    nodes = []
    while order:
        take = [order.pop() for _ in range(min(len(order), rng.randint(1, 4)))]
        if rng.random() < 0.05:
            take.append(rng.choice(pods))  # placed again
        if rng.random() < 0.03:
            take.append(pod(f"p{rng.randrange(60)}"))  # a stranger
        options = rng.sample(catalog, rng.randint(0 if rng.random() < 0.05 else 1, 3))
        nodes.append(node(options, *take))
    daemon = {} if rng.random() < 0.5 else {"cpu": rng.choice(quantities)}
    return nodes, pods, daemon


@pytest.mark.parametrize("seed", range(6))
def test_random_plans_agree(native, seed):
    rng = random.Random(4_027_000_000 + seed)
    verdicts = {PASSED: 0, UNDECIDED: 0, "fault": 0}
    for _ in range(150):
        nodes, pods, daemon = random_plan(rng)
        verdict = native.validate(nodes, pods, daemon, val.CTX)
        want = loop_alone(nodes, pods, daemon)
        assert validate_pack(nodes, pods, daemon) == want
        if verdict == PASSED:
            assert want is None
        elif verdict >= 0:
            assert want is not None
            first_node_at_fault(nodes, pods, daemon)
        verdicts[verdict if verdict < 0 else "fault"] += 1
    assert verdicts[PASSED] and verdicts["fault"], verdicts


# -- the pass on the solve's path -----------------------------------------------


def _validate_spans():
    return [c for t in T_OBS.exporter().trees() for c in t["children"]
            if c["name"] == "solve.validate"]


def test_a_fresh_solve_takes_the_native_verdict(native):
    """Two rounds of new pod objects of the benchmark's mix on a CPU
    scheduler: the native pass gives each verdict, the plan stands."""
    prov, catalog, pods = mix7(700, 4_027_000_101, n_types=50)
    adapter = portbench("adapter")
    sched = Scheduler(Cluster(), rng=random.Random(1), device="cpu")
    T_OBS.exporter().clear()
    with pinned(PORT):
        for rnd in range(2):
            nodes = sched.solve(prov, catalog, adapter.fresh(pods, rnd))
            assert nodes
            assert sched.last_stage_profile()["validate_native"] == 1
    assert [s["attrs"] for s in _validate_spans()] == [{"memo_hit": False, "native": True}] * 2


def test_a_plan_the_pass_flags_is_worded_by_the_loop(native):
    """A decoded node stripped of its options: the pass names it, the loop
    words it, and the solve fails with that message, ``native`` false."""
    prov, catalog, pods = mix7(300, 4_027_000_202, n_types=50)
    sched = Scheduler(Cluster(), rng=random.Random(1), device="cpu")
    backend = sched.torch
    backend._floor_serves = False
    backend._quarantine_source = lambda reason, detail, batch, address="": None
    decode = backend._decode
    seen = []

    def stripped(*args, **kwargs):
        nodes = decode(*args, **kwargs)
        nodes[0].instance_type_options = []
        seen.append(native.validate(nodes, args[0].pods, {}, val.CTX))
        return nodes

    backend._decode = stripped
    T_OBS.exporter().clear()
    with pinned(PORT), pytest.raises(InvalidPackError, match="node 0 has no surviving"):
        sched.solve(prov, catalog, pods)
    assert seen == [0]
    assert sched.last_stage_profile()["validate_native"] == 0
    assert [s["attrs"]["native"] for s in _validate_spans()] == [False]
