"""The configuration ``assorted1344-select`` (``catalogs/assorted.py``,
``mixes/selection.py``) on the CPU: the catalog as the program's own fake,
the mix's forms and draws, the closure of its cores, the reference against
the program's plan, the cell through the harness with its table saturated,
and a planted fault."""

import copy
import hashlib
import json
import random
from collections import Counter

import pytest

import adapter
import check
import generate
import harness
from reference import scheduler as reference

CELL = "select-5k-fresh"
SEED = 2**38 + 11


@pytest.fixture
def fused(monkeypatch):
    # a device="cpu" scheduler holds its plain path only when pinned to it
    monkeypatch.setenv("KARPENTER_PACKER", "fused")


def mix():
    return generate.module("mixes", "selection")


def small(count=700):
    cell = copy.deepcopy(harness.load_cell(CELL))
    cell["config"]["pods"]["count"] = count
    spec = cell["config"]["catalog"]
    cell["config"]["catalog"] = generate.module("catalogs", spec["kind"]).small(spec)
    return cell


def test_the_catalog_is_the_programs_assorted_fake_type_for_type():
    from karpenter_tpu_torch.cloudprovider.fake import instance_types_assorted
    from karpenter_tpu_torch.utils import resources as res

    records = generate.catalog(harness.load_cell(CELL)["config"]["catalog"])
    program = instance_types_assorted()
    assert len(records) == len(program) == 1344
    for rec, it in zip(records, program):
        assert rec["name"] == it.name
        assert rec["res"] == (round(it.resources[res.CPU] * 1000), it.resources[res.MEMORY],
                              it.resources[res.PODS])
        assert rec["overhead"] == (round(it.overhead[res.CPU] * 1000),
                                   it.overhead[res.MEMORY], 0)
        assert [tuple(o) for o in rec["offerings"]] == [
            (o.capacity_type, o.zone) for o in it.offerings]
        assert (rec["arch"], rec["os"]) == (it.architecture, it.operating_systems)
        assert rec["price"] == it.effective_price()
    assert len({r["name"] for r in records}) == 1344


def test_the_mix_draws_its_forms_in_equal_shares():
    m = mix()
    records = m.records(18000, generate.stream(3, "shares"))
    forms = Counter()
    split = Counter()
    for rec in records:
        assert rec["kind"] == "generic" and rec["sel"] is None
        assert rec["cpu_m"] in m.CPU_M and rec["mem_mi"] in m.MEM_MI
        assert rec["labels"]["my-label"] in m.LABEL_VALUES
        sel, aff = rec.get("node_selector"), rec.get("node_affinity")
        assert not (sel and aff)
        if aff:
            assert all(op == "In" and len(values) == 1 for _, op, values in aff)
            form = {key: values[0] for key, _, values in aff}
        else:
            form = sel or {}
        forms[json.dumps(form, sort_keys=True)] += 1
        if form:
            split["selector" if sel else "affinity"] += 1
    assert sorted(forms) == sorted(json.dumps(f, sort_keys=True) for f in m.FORMS)
    assert all(abs(n - 2000) < 200 for n in forms.values()), forms
    assert abs(split["selector"] - split["affinity"]) < 400, split
    # the pools are the upstream benchmark's, as mix7 has them
    mix7 = generate.module("mixes", "mix7")
    assert (m.CPU_M, m.MEM_MI, m.LABEL_VALUES) == (mix7.CPU_M, mix7.MEM_MI, mix7.LABEL_VALUES)


def digest(obj) -> str:
    return hashlib.sha256(json.dumps(obj, sort_keys=True, default=sorted).encode()).hexdigest()


# sha256 of the cell's fresh records at full size (4 batches of 5,000)
FRESH_DIGESTS = {
    1: "8cd8e7ec90502a0639e88057f9857304bd50e3f55c8eafa8a3a46c4853d41a07",
    2**40 + 3: "bcd06405fffa084f853b7eeee44d2b6ab9f1f4e280101e7166dce3ab803b74c2",
}


@pytest.mark.parametrize("seed", sorted(FRESH_DIGESTS))
def test_the_fresh_records_at_full_size_are_pinned(seed):
    cell = harness.load_cell(CELL)
    t = generate.traffic(cell["config"], cell["traffic"], seed)
    assert len(t.records) == 20000
    assert digest(t.records) == FRESH_DIGESTS[seed]


def test_the_closure_of_the_mix_stays_inside_54_signatures(fused):
    """Every form, as a selector and as an affinity term, in one batch over
    the 1,344 types: one core a form, at most 54 signatures."""
    from karpenter_tpu_torch.kube.client import Cluster
    from karpenter_tpu_torch.scheduling.scheduler import Scheduler

    records = []
    for form in mix().FORMS:
        base = {"kind": "generic", "labels": {"my-label": "a"}, "cpu_m": 250, "mem_mi": 256,
                "sel": None}
        records.append(dict(base, node_selector=dict(form)) if form else base)
        records.append(dict(base, node_affinity=[[k, "In", [v]] for k, v in form.items()]))
    catalog = generate.catalog(harness.load_cell(CELL)["config"]["catalog"])
    sched = Scheduler(Cluster(), rng=random.Random(1), device="cpu")
    sched.solve(adapter.provisioner(), adapter.instance_types(catalog), adapter.pods(records))
    prof = sched.last_stage_profile()
    assert prof["closure_cores"] == len(mix().FORMS)
    assert prof["closure_signatures"] <= 54


def program_plan(records, catalog, seed):
    from karpenter_tpu_torch.kube.client import Cluster
    from karpenter_tpu_torch.scheduling.scheduler import Scheduler

    pods = adapter.pods(records)
    sched = Scheduler(Cluster(), rng=random.Random(seed), device="cpu")
    nodes = sched.solve(adapter.provisioner(), adapter.instance_types(catalog), pods)
    return adapter.plan(nodes, pods), sched.last_stage_profile()["packer_backend"]


@pytest.mark.parametrize("seed", [4, 2**36 + 7, 2**41 + 13])
def test_the_reference_equals_the_programs_cpu_plan(fused, seed):
    config = small()["config"]
    records = generate.pods(config, 700, generate.stream(seed, "ref"))
    catalog = generate.catalog(config["catalog"])
    assert len(catalog) == 288
    got, served = program_plan(records, catalog, seed)
    want = reference.solve(records, catalog)
    assert served == "pack_reference"
    assert got["nodes"] and not want["unschedulable"]
    assert check.mismatches(got, want, len(records)) == 0
    assert got == want


def test_the_cell_runs_correct_with_its_first_table_saturated(fused, monkeypatch):
    """The cell at the CPU tests' size with the first table cut below the
    nodes a round opens, as 512 slots are below the cell's ~1,000 nodes on
    the card: every round re-dispatches, and the traced run reads the new
    clocks."""
    from karpenter_tpu_torch.solver import backend

    monkeypatch.setattr(backend, "N_MAX_FIRST", 64)
    result = harness.run(CELL, SEED, 1.5, True, 0.0, device="cpu", cell_def=small())
    assert result["correct"] and result["failed"] == 0
    assert result["checks"]["plan_mismatches"]["value"] == 0
    metrics = result["metrics"]
    assert set(metrics) == {"pack_redispatch_ms", "decode_options_ms"}
    assert metrics["pack_redispatch_ms"]["value"] > 0
    assert metrics["decode_options_ms"]["value"] > 0


def test_an_adapter_that_drops_node_requirements_comes_out_not_correct(fused, monkeypatch):
    pod = adapter.pod

    def dropped(rec):
        return pod({k: v for k, v in rec.items() if not k.startswith("node_")})

    monkeypatch.setattr(adapter, "pod", dropped)
    result = harness.run(CELL, SEED, 1.5, False, 0.0, device="cpu", cell_def=small())
    assert not result["correct"]
    assert result["checks"]["plan_mismatches"]["value"] > check.LIMIT
