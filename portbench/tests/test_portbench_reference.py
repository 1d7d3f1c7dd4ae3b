"""The reference against the program's own plan on the CPU (a test may
import both; the reference does not), the control that has to fail, and
the harness's check seeing faults planted under the timed path."""

import copy
import json
import random
from pathlib import Path

import pytest

import adapter
import check
import generate
import harness
from reference import scheduler as reference

CELLS = [w["name"] for w in
         json.loads((Path(__file__).resolve().parents[2] / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture
def fused(monkeypatch):
    # a device="cpu" scheduler holds its plain path only when pinned to it
    monkeypatch.setenv("KARPENTER_PACKER", "fused")


def small(name, count=700):
    """The cell's files at the CPU tests' size: ``count`` pods a round and
    the catalog module's ``small`` spec."""
    cell = copy.deepcopy(harness.load_cell(name))
    cell["config"]["pods"]["count"] = count
    spec = cell["config"]["catalog"]
    cell["config"]["catalog"] = generate.module("catalogs", spec["kind"]).small(spec)
    return cell


def program_plan(records, catalog, seed):
    from karpenter_tpu_torch.kube.client import Cluster
    from karpenter_tpu_torch.scheduling.scheduler import Scheduler

    pods = adapter.pods(records)
    sched = Scheduler(Cluster(), rng=random.Random(seed), device="cpu")
    nodes = sched.solve(adapter.provisioner(), adapter.instance_types(catalog), pods)
    return adapter.plan(nodes, pods), sched.last_stage_profile()["packer_backend"]


@pytest.mark.parametrize("seed", [1, 2**40 + 3])
def test_reference_equals_the_programs_cpu_plan(fused, seed):
    config = {"pods": {"mix": "mix7", "count": 700}}
    records = generate.pods(config, 700, generate.stream(seed, "ref"))
    catalog = generate.catalog({"kind": "linear", "types": 50})
    got, served = program_plan(records, catalog, seed)
    want = reference.solve(records, catalog)
    assert served == "pack_reference"
    assert got["nodes"], "the plan opened no node"
    assert check.mismatches(got, want, len(records)) == 0
    assert got == want


def test_the_bfloat16_control_comes_out_not_correct():
    config = {"pods": {"mix": "mix7", "count": 2000}}
    catalog = generate.catalog({"kind": "linear", "types": 400})
    for seed in (1, 2, 3):
        records = generate.pods(config, 2000, generate.stream(seed, "control"))
        exact = reference.solve(records, catalog)
        control = reference.solve(records, catalog, precision="bfloat16")
        assert check.mismatches(control, exact, len(records)) > check.LIMIT


def test_mismatches_counts_pods_placed_differently():
    plan = {"nodes": [([0, 1], ("a",), (1, 2, 2)), ([2], ("a", "b"), (1, 1, 1))],
            "unschedulable": [3]}
    assert check.mismatches(plan, plan, 4) == 0
    moved = {"nodes": [([0], ("a",), (1, 2, 2)), ([2, 1], ("a", "b"), (1, 1, 1))],
             "unschedulable": [3]}
    assert check.mismatches(moved, plan, 4) == 3  # pod 1 moved; both nodes changed
    twice = {"nodes": plan["nodes"] + [([3, 0], ("b",), (1, 1, 1))], "unschedulable": []}
    assert check.mismatches(twice, plan, 4) >= 2


def run_small(name, **kw):
    return harness.run(name, 2**35 + 17, 1.5, False, 0.0, device="cpu",
                       cell_def=small(name), **kw)


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(fused, name):
    result = run_small(name)
    assert result["correct"] and result["failed"] == 0
    assert result["checks"]["plan_mismatches"]["value"] == 0
    assert list(result)[-2:] == ["checks", "check_lines"]
    info = result["info"]
    assert info["pods_done"] == 700 * result["attempted"]
    assert info["pods_per_s"] == pytest.approx(info["pods_done"] / info["window_s"])


def test_every_round_hands_over_pods_the_program_has_not_seen(fused, monkeypatch):
    from karpenter_tpu_torch.scheduling.scheduler import Scheduler

    solve, seen, lists = Scheduler.solve, set(), set()

    def watched(self, provisioner, instance_types, pods):
        assert id(pods) not in lists and not {id(p) for p in pods} & seen
        assert not any(hasattr(p, "_solve_statics") for p in pods)
        lists.add(id(pods))
        seen.update(id(p) for p in pods)
        keep.append(pods)  # keeps the ids from being reused
        return solve(self, provisioner, instance_types, pods)

    keep = []
    monkeypatch.setattr(Scheduler, "solve", watched)
    result = run_small("mix7-10k-fresh")
    assert result["correct"] and result["attempted"] >= 2


def test_a_round_the_kernel_did_not_serve_counts_nothing(fused, monkeypatch):
    from karpenter_tpu_torch.scheduling.scheduler import Scheduler

    profile, calls = Scheduler.last_stage_profile, [0]

    def floor_on_odd_rounds(self):
        calls[0] += 1
        out = dict(profile(self))
        if calls[0] % 2:
            out["packer_backend"] = "ffd"  # as if the FFD floor had served it
        return out

    monkeypatch.setattr(Scheduler, "last_stage_profile", floor_on_odd_rounds)
    result = run_small("mix7-10k-fresh")
    info = result["info"]
    assert result["failed"] >= 1 and result["attempted"] > result["failed"]
    assert info["pods_done"] == 700 * (result["attempted"] - result["failed"])
    assert info["pods_per_s"] == pytest.approx(info["pods_done"] / info["window_s"])


def _break(monkeypatch, fault):
    from karpenter_tpu_torch.scheduling.scheduler import Scheduler

    solve = Scheduler.solve
    last = {}

    def broken(self, provisioner, instance_types, pods):
        if fault == "half_batch":
            return solve(self, provisioner, instance_types, list(pods)[: len(pods) // 2])
        nodes = solve(self, provisioner, instance_types, pods)
        if fault == "state_unchanged":
            # every round answers with the round before's plan
            previous, last["nodes"] = last.get("nodes", nodes), nodes
            return previous
        if fault == "answer_altered":
            moved = nodes[0].pods.pop()
            nodes[-1].pods.append(moved)
        return nodes

    monkeypatch.setattr(Scheduler, "solve", broken)


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "answer_altered"])
def test_a_fault_under_the_timed_path_comes_out_not_correct(fused, monkeypatch, name, fault):
    # one card, so no exchange between chips to leave out
    _break(monkeypatch, fault)
    result = run_small(name)
    assert not result["correct"]
    assert result["checks"]["plan_mismatches"]["value"] > check.LIMIT


# -- node requirements, and a configuration of new files alone: its catalog
# and its mix exist only in a temporary directory, found on generate.SEARCH --

ASSORTED = '''"""An assorted-shaped catalog (fake/instancetype.go:79-110's shape): the
cross product of the spec's cpus and memory sizes with 3 zones, 2 capacity
types, 2 systems and 2 architectures, each type one offering."""

GI = 2 ** 30
MI = 2 ** 20


def records(spec):
    out = []
    for cpu in spec["cpus"]:
        for mem in spec["mem_gi"]:
            for zone in ("test-zone-1", "test-zone-2", "test-zone-3"):
                for ct in ("spot", "on-demand"):
                    for os_ in ("linux", "windows"):
                        for arch in ("amd64", "arm64"):
                            out.append({
                                "name": f"{cpu}-cpu-{mem}-mem-{arch}-{os_}-{zone}-{ct}",
                                "res": (cpu * 1000, mem * GI, 5),
                                "price": 0.1 * float(cpu) + 0.1 * float(mem * GI) / 1e9,
                                "overhead": (100, 10 * MI, 0),
                                "offerings": ((ct, zone),),
                                "arch": arch,
                                "os": frozenset({os_}),
                            })
    return out


def small(spec):
    return spec
'''

SELECT = '''"""Generic pods, each pinned to one node label: a third by a node
selector, a third by one required node-affinity term (an In or a NotIn
expression, at times both on the key, at times with an instance type left
out), a third free. One zone in twenty is one no type has. The
requirements' closure under joining is 432 signatures, inside the
program's 512 (solver/signature.py)."""

ZONE = "topology.kubernetes.io/zone"
VALUES = {
    ZONE: ["test-zone-1", "test-zone-2", "test-zone-3"],
    "karpenter.sh/capacity-type": ["on-demand", "spot"],
    "kubernetes.io/arch": ["amd64", "arm64"],
    "kubernetes.io/os": ["linux", "windows"],
}
KEYS = sorted(VALUES)
LEFT_OUT = ["node.kubernetes.io/instance-type", "NotIn", ["2-cpu-2-mem-amd64-linux-test-zone-1-spot"]]
CPU_M = [100, 250, 500, 1000, 1500]
MEM_MI = [100, 256, 512, 1024]


def records(count, rng):
    def value(key):
        if key == ZONE and rng.random() < 0.05:
            return "test-zone-4"
        return rng.choice(VALUES[key])

    out = []
    for i in range(count):
        rec = {"kind": "generic", "labels": {"my-label": rng.choice("abc")},
               "cpu_m": rng.choice(CPU_M), "mem_mi": rng.choice(MEM_MI), "sel": None}
        key = rng.choice(KEYS)
        if i % 3 == 0:
            rec["node_selector"] = {key: value(key)}
        elif i % 3 == 1:
            draw = rng.random()
            if draw < 0.4:
                term = [[key, "In", sorted({value(key), value(key)})]]
            elif draw < 0.8:
                term = [[key, "NotIn", [value(key)]]]
            else:
                term = [[key, "In", sorted(VALUES[key])], [key, "NotIn", [value(key)]]]
            if rng.random() < 0.1:
                term.append(LEFT_OUT)
            rec["node_affinity"] = term
        out.append(rec)
    return out
'''

SELECT_CELL = {
    "workload": {"config": "assorted96-select3", "traffic": "fresh", "chips": 1},
    "config": {
        "name": "assorted96-select3",
        "catalog": {"kind": "assorted", "cpus": [1, 2], "mem_gi": [1, 2]},
        "pods": {"mix": "select3", "count": 600},
        "kernel": "pack_first_fit",
    },
    "traffic": {"kind": "fresh"},
}


@pytest.fixture
def files(tmp_path, monkeypatch):
    for kind, name, source in (("catalogs", "assorted", ASSORTED), ("mixes", "select3", SELECT)):
        (tmp_path / kind).mkdir()
        (tmp_path / kind / f"{name}.py").write_text(source)
    monkeypatch.setattr(generate, "SEARCH", [tmp_path, *generate.SEARCH])
    return copy.deepcopy(SELECT_CELL)


def select_round(cell, seed):
    config = cell["config"]
    records = generate.pods(config, config["pods"]["count"], generate.stream(seed, "ref"))
    return records, generate.catalog(config["catalog"])


@pytest.mark.parametrize("seed", [3, 2**36 + 9, 2**41 + 1])
def test_the_reference_honours_node_requirements_as_the_programs_cpu_plan(fused, files, seed):
    records, catalog = select_round(files, seed)
    assert len(catalog) == 96
    assert sum("node_selector" in r for r in records) == 200
    assert sum("node_affinity" in r for r in records) == 200
    got, served = program_plan(records, catalog, seed)
    want = reference.solve(records, catalog)
    assert served == "pack_reference"
    assert want["unschedulable"], "no pod asked for a value no type has"
    assert check.mismatches(got, want, len(records)) == 0
    assert got == want


def test_a_cell_of_new_files_alone_runs_correct_on_the_cpu(fused, files):
    result = harness.run("assorted96-select3-fresh", 2**37 + 5, 1.5, False, 0.0,
                         device="cpu", cell_def=files)
    assert result["correct"] and result["failed"] == 0
    assert result["checks"]["plan_mismatches"]["value"] == 0
    assert result["info"]["pods_done"] == 600 * result["attempted"]


def test_an_adapter_that_drops_node_requirements_comes_out_not_correct(fused, files, monkeypatch):
    pod = adapter.pod

    def dropped(rec):
        return pod({k: v for k, v in rec.items() if not k.startswith("node_")})

    monkeypatch.setattr(adapter, "pod", dropped)
    result = harness.run("assorted96-select3-fresh", 2**37 + 5, 1.5, False, 0.0,
                         device="cpu", cell_def=files)
    assert not result["correct"]
    assert result["checks"]["plan_mismatches"]["value"] > check.LIMIT


def test_a_record_without_node_requirements_builds_the_same_pod(monkeypatch):
    calls = []
    monkeypatch.setattr(adapter, "make_pod", lambda **kw: calls.append(kw))
    records = generate.mix7(70, generate.stream(1, "kw"))
    adapter.pods(records)
    assert {k for kw in calls for k in kw} == {
        "labels", "requests", "topology", "pod_requirements", "pod_anti_requirements"}


def _generic(**extra):
    return dict({"kind": "generic", "labels": {"my-label": "a"}, "cpu_m": 100, "mem_mi": 100,
                 "sel": None}, **extra)


@pytest.mark.parametrize("records,match", [
    ([_generic(kind="zone_spread", sel="a",
               node_selector={reference.ZONE: "test-zone-1"})], "topology kind 'zone_spread'"),
    ([_generic(kind="anti_host", sel="b",
               node_affinity=[[reference.ARCH, "In", ["amd64"]]])], "topology kind 'anti_host'"),
    ([_generic(node_selector={reference.ZONE: "test-zone-1"}),
      _generic(kind="aff_zone", sel="a")], "beside pods of the topology kinds aff_zone"),
    ([_generic(node_selector={reference.HOSTNAME: "h"})], "node requirement on"),
    ([_generic(node_affinity=[[reference.OS, "Exists", []]])], "operator 'Exists'"),
], ids=["selector_and_spread", "affinity_and_anti", "beside_in_a_batch", "hostname_key",
        "exists_operator"])
def test_what_the_reference_leaves_out_raises(records, match):
    catalog = generate.catalog({"kind": "linear", "types": 5})
    with pytest.raises(ValueError, match=match):
        reference.solve(records, catalog)
