"""The readers of the solve's sub-stage clocks (``statics_ms``,
``pack_begin_ms``) on a CPU run at a small size, traced, and against a
program whose profile lacks their keys."""

import copy

import pytest

import harness


@pytest.fixture
def fused(monkeypatch):
    # a device="cpu" scheduler holds its plain path only when pinned to it
    monkeypatch.setenv("KARPENTER_PACKER", "fused")


def small(name, count=200, types=50):
    cell = copy.deepcopy(harness.load_cell(name))
    cell["config"]["pods"]["count"] = count
    cell["config"]["catalog"]["types"] = types
    return cell


def test_a_traced_cpu_run_reads_the_sub_stage_clocks(fused):
    result = harness.run("mix7-10k-fresh", 2**36 + 5, 1.0, True, 0.0, device="cpu",
                         cell_def=small("mix7-10k-fresh"))
    assert result["correct"] and result["failed"] == 0
    metrics = result["metrics"]
    statics, begin = metrics["statics_ms"]["value"], metrics["pack_begin_ms"]["value"]
    assert metrics["statics_ms"]["unit"] == metrics["pack_begin_ms"]["unit"] == "ms"
    assert 0 < statics < metrics["host_stage_ms"]["value"]
    assert 0 < begin <= metrics["pack_fetch_ms"]["value"]
    # no device: the whole stretch is idle, charged to the innermost spans
    gaps = dict(result["breakdown"]["idle_gaps"])
    assert result["breakdown"]["device_ops"] == []
    assert {"solve.statics", "solve.validate", "pack.launch"} <= set(gaps)


@pytest.mark.parametrize("name,key", [("statics_ms", "statics_s"),
                                      ("pack_begin_ms", "pack_begin_s")])
def test_a_reader_finds_nothing_without_its_key(name, key):
    reader = harness.load_reader(name)
    ctx = harness.Context("cpu")
    ctx.rounds = [{"ok": True, "profile": {"sort_s": 0.2, "pack_fetch_s": 0.01}}] * 3
    assert reader.read(ctx) is None
    ctx.rounds = ctx.rounds + [{"ok": True, "profile": {key: 0.004}},
                               {"ok": False, "profile": {key: 9.0}}]
    assert reader.read(ctx) == pytest.approx(1e3 * 0.004 / 4)
