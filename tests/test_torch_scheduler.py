"""The whole slice: the port's ``Scheduler.solve`` against the JAX
package's, and the port's import boundary.

Both schedulers solve the same seeded batch (``solver: tpu``, topology
rng ``random.Random(1)``); the JAX side runs its lax.scan packer
(``KARPENTER_PACKER=scan`` around its solve), the port its fused route's
plain PyTorch path (``device="cpu"``, ``KARPENTER_PACKER=fused`` around its
solve). The decoded nodes must be equal node by node: the pods
(by their index in the input list), the surviving instance types, the
requests and the node requirements.
"""

import os
import random
import re
import subprocess
import sys
from pathlib import Path

import jax  # noqa: F401  (kept on the CPU by conftest)
import pytest
import torch

from torch_parity import PACKAGES, fresh_router, pinned, scenario  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "karpenter_tpu_torch"


def solve(pkg, name, n_pods, seed, n_types):
    prov, catalog, pods = scenario(pkg, name, n_pods, seed, n_types)
    if pkg == "karpenter_tpu":
        from karpenter_tpu.kube.client import Cluster
        from karpenter_tpu.scheduling.scheduler import Scheduler

        sched = Scheduler(Cluster(), rng=random.Random(1))
    else:
        from karpenter_tpu_torch.kube.client import Cluster
        from karpenter_tpu_torch.scheduling.scheduler import Scheduler

        sched = Scheduler(Cluster(), rng=random.Random(1), device="cpu")
    with pinned(pkg):
        nodes = sched.solve(prov, catalog, pods)
    index = {id(p): i for i, p in enumerate(pods)}
    plan = [
        (
            [index[id(p)] for p in n.pods],
            [it.name for it in n.instance_type_options],
            dict(n.requests),
            [(r.key, r.operator, tuple(r.values)) for r in n.constraints.requirements.requirements],
            [(k, vs.complement, sorted(vs.values)) for k, vs in n.constraints.requirements._sets],
        )
        for n in nodes
    ]
    return plan, sched.last_stage_profile()


@pytest.mark.parametrize(
    "name,n_pods,dispatches",
    [("diverse", 700, 1), ("one_per_node", 600, 2)],
)
def test_plan_identical_to_jax_scheduler(name, n_pods, dispatches):
    (ref, ref_prof), (out, prof) = (solve(pkg, name, n_pods, 42, 50) for pkg in PACKAGES)
    assert len(out) == len(ref) > 0
    for i, (a, b) in enumerate(zip(ref, out)):
        assert a == b, f"node {i} differs"
    assert sum(len(n[0]) for n in out) == sum(len(n[0]) for n in ref)
    assert prof["pack_dispatches"] == ref_prof["pack_dispatches"] == dispatches
    assert prof["packer_backend"] == "pack_reference" and prof["pack_route"] == "fused"
    for key in ("sort_s", "inject_s", "encode_s", "pack_fetch_s", "decode_s"):
        assert prof[key] >= 0.0
    if name == "one_per_node":
        assert len(out) == n_pods > 512  # the first 512-slot table saturated


def test_facade_routes_other_solvers_to_ffd():
    from karpenter_tpu_torch.cloudprovider.fake import instance_types
    from karpenter_tpu_torch.kube.client import Cluster
    from karpenter_tpu_torch.scheduling.scheduler import Scheduler
    from karpenter_tpu_torch.testing import diverse_pods, make_provisioner

    sched = Scheduler(Cluster(), rng=random.Random(1), device="cpu")
    nodes = sched.solve(make_provisioner(solver="ffd"), instance_types(20), diverse_pods(70))
    assert nodes and sched.last_stage_profile() == {}


def test_default_device_is_cuda_and_needs_a_card():
    """The default device is the card. The accelerated backend is built on
    the first ``solver: tpu`` solve, which raises without a card; a
    ``solver: ffd`` solve never needs one."""
    from karpenter_tpu_torch.cloudprovider.fake import instance_types
    from karpenter_tpu_torch.kube.client import Cluster
    from karpenter_tpu_torch.scheduling.scheduler import Scheduler
    from karpenter_tpu_torch.testing import diverse_pods, make_provisioner

    sched = Scheduler(Cluster(), rng=random.Random(1))
    assert sched.device.type == "cuda"
    assert sched.solve(make_provisioner(solver="ffd"), instance_types(20), diverse_pods(30))
    assert sched._torch is None and sched.last_stage_profile() == {}
    if torch.cuda.is_available():
        assert sched.torch.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            sched.solve(make_provisioner(solver="tpu"), instance_types(20), diverse_pods(30))
        assert sched._torch is None


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import karpenter_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'karpenter_tpu' or m.startswith('karpenter_tpu.'))\n"
        "n = sum(1 for m in sys.modules if m.startswith('karpenter_tpu_torch.'))\n"
        "new = all(f'karpenter_tpu_torch.{m}' in sys.modules for m in (\n"
        "    'solver.router', 'solver.native', 'solver.integrity', 'resilience.breaker',\n"
        "    'kube.events', 'solver.stream', 'solver.pool', 'testing.chaos',\n"
        "    'controllers.provisioning', 'controllers.selection', 'controllers.manager',\n"
        "    'utils.batcher', 'kube.serde', 'cloudprovider.metrics', 'interruption.types',\n"
        "    'controllers.consolidation', 'controllers.termination', 'controllers.node',\n"
        "    'controllers.metrics_node', 'controllers.metrics_pod', 'solver.repack',\n"
        "    'resilience.liveness', 'utils.gcpolicy', 'utils.node', 'interruption.orchestrator',\n"
        "    'controllers.interruption', 'controllers.garbage_collection', 'launch.journal',\n"
        "    'launch.recovery', 'utils.lease', 'fleet', 'forecast.model',\n"
        "    'cloudprovider.simulated', 'controllers.warmpool', 'options', 'main', 'webhook',\n"
        "    'cloudprovider.registry', 'cloudprovider.gke', 'cloudprovider.httpapi',\n"
        "    'scheduling.oracle', 'kube.transport', 'kube.apiserver', 'kube.testserver',\n"
        "    'kube.leader', 'kube.cabundle'))\n"
        "from karpenter_tpu_torch.options import parse_args\n"
        "new = new and parse_args([]).device == 'cuda'\n"
        "bad += ['grpc'] if 'grpc' in sys.modules else []\n"
        "print(n, new, bad)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    count, new, bad = out.stdout.split(" ", 2)
    assert int(count) >= 25 and new == "True" and bad.strip() == "[]"


def test_no_source_names_the_jax_package():
    sources = sorted(PORT.rglob("*.py")) + sorted(PORT.rglob("*.cu"))
    assert len(sources) >= 25
    for path in sources:
        text = path.read_text()
        assert not re.search(r"\bkarpenter_tpu\.", text), path
        assert not re.search(r"^\s*(import|from)\s+jax\b", text, re.M), path
