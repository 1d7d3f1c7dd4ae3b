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


def small(name, count=700, types=50):
    cell = copy.deepcopy(harness.load_cell(name))
    cell["config"]["pods"]["count"] = count
    cell["config"]["catalog"]["types"] = types
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
