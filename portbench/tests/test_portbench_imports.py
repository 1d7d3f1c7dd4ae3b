"""What the harness loads: no JAX, no JAX package, and a reference that
loads nothing of the program. Names are compared by their top-level part,
whole: ``karpenter_tpu_torch`` is not ``karpenter_tpu``."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
PORTBENCH = HERE.parent
ROOT = PORTBENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "karpenter_tpu"}
NOT_READ = {"bench", "chip_smoke"}

LOADED = """
import json, os, sys
sys.path[:0] = [{portbench!r}, {root!r}]
os.environ["KARPENTER_PACKER"] = "fused"
{body}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

RUN_SMALL = """
import copy, generate, harness
cell = copy.deepcopy(harness.load_cell("mix7-10k-fresh"))
cell["config"]["pods"]["count"] = 300
spec = cell["config"]["catalog"]
cell["config"]["catalog"] = generate.module("catalogs", spec["kind"]).small(spec)
result = harness.run("mix7-10k-fresh", 5, 0.5, False, 0.0, device="cpu", cell_def=cell)
assert result["correct"], result
"""


def loaded(body: str):
    code = LOADED.format(portbench=str(PORTBENCH), root=str(ROOT), body=body)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax_and_no_jax_package():
    top = loaded(RUN_SMALL)
    assert "karpenter_tpu_torch" in top  # the program ran
    assert not top & FORBIDDEN


GENERATE = """
from reference import scheduler
import check, generate
records = generate.pods({"pods": {"mix": "mix7"}}, 70, generate.stream(1, "x"))
scheduler.solve(records, generate.catalog({"kind": "linear", "types": 20}))
"""


def test_the_reference_loads_nothing_of_the_program():
    # nor do the catalog and the mix it reads
    top = loaded(GENERATE)
    assert not top & (FORBIDDEN | {"karpenter_tpu_torch", "torch"})


def sources():
    return sorted(PORTBENCH.rglob("*.py"))


@pytest.mark.parametrize("path", sources(), ids=lambda p: str(p.relative_to(PORTBENCH)))
def test_no_source_imports_jax_the_jax_package_or_the_old_benches(path):
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split(".")[0])
    assert not names & (FORBIDDEN | NOT_READ)
    if path.parent.name == "reference":
        assert names <= {"__future__", "math", "struct", "typing"}
    if path.parent.name in ("catalogs", "mixes"):
        # loaded by path, also where portbench/ is not on sys.path
        assert names <= set(sys.stdlib_module_names)


def test_without_a_card_a_run_fails_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "mix7-10k-fresh",
         "--seed", str(2**34), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 2
    assert out.stdout == ""
    assert "CUDA device" in out.stderr


def test_without_the_program_a_run_fails_and_prints_no_result(tmp_path):
    (tmp_path / "BENCHMARK.json").write_text((ROOT / "BENCHMARK.json").read_text())
    subprocess.run(["cp", "-r", str(PORTBENCH), str(tmp_path / "portbench")], check=True)
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "mix7-10k-fresh",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout == ""
