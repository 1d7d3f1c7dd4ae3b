"""Card-only tests of the PyTorch port: the CUDA kernel against its plain
version, and the port's cuda path against its cpu path.

Marked ``cuda``; each skips without a CUDA device (decided in a fixture,
never at import). This file imports neither JAX nor the JAX package, so it
runs on a machine with PyTorch alone:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import random

import numpy as np
import pytest
import torch

from karpenter_tpu_torch.solver import carry, fused, pack_kernel
from karpenter_tpu_torch.solver.kernel import PackResult, pack_reference
from torch_parity import encode_scenario, fields, scenario, synth_fields

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def assert_same(ref: PackResult, out: PackResult):
    for name, a, b in zip(PackResult._fields, ref, out):
        np.testing.assert_array_equal(a.cpu().numpy(), b.cpu().numpy(), err_msg=name)


@pytest.mark.parametrize("n_max", [64, 512, 2048])
def test_kernel_matches_reference_synthetic(cuda, n_max):
    f = synth_fields(P=2048, S=40, F=8, R=4, C=16, n_hosts=30, seed=11)
    cpu = carry.tensors_from_reference(f, "cpu")["pack_args"]
    gpu = carry.tensors_from_reference(f, cuda)["pack_args"]
    before = pack_kernel.launches
    out = pack_kernel.pack_first_fit(*gpu, n_max=n_max)
    torch.cuda.synchronize()
    assert pack_kernel.launches == before + 1
    assert_same(pack_reference(*cpu, n_max=n_max), out)


def test_kernel_matches_reference_encoded(cuda):
    pkg = "karpenter_tpu_torch"
    f = fields(encode_scenario(pkg, *scenario(pkg, "diverse", 1500, 42)))
    cpu = carry.tensors_from_reference(f, "cpu")["pack_args"]
    gpu = carry.tensors_from_reference(f, cuda)["pack_args"]
    for n_max in (16, 512):
        assert_same(
            pack_reference(*cpu, n_max=n_max), pack_kernel.pack_first_fit(*gpu, n_max=n_max)
        )


def test_fused_buffer_matches_cpu(cuda):
    f = synth_fields(P=1024, S=20, F=4, R=3, C=8, n_hosts=12, seed=4)
    ref = fused.fused_solve(*carry.tensors_from_reference(f, "cpu")["fused"], n_max=256)
    out = fused.fused_solve(*carry.tensors_from_reference(f, cuda)["fused"], n_max=256)
    np.testing.assert_array_equal(ref.numpy(), out.cpu().numpy())


def test_wrapper_rejects_bad_dtype_on_card(cuda):
    f = synth_fields(P=64, S=4, F=2, R=3, C=3, n_hosts=2)
    args = carry.tensors_from_reference(f, cuda)["pack_args"]
    with pytest.raises(TypeError):
        pack_kernel.pack_first_fit(args[0].to(torch.int32), *args[1:], n_max=8)


@pytest.mark.parametrize("name,n_pods,dispatches", [("diverse", 700, 1), ("one_per_node", 600, 2)])
def test_scheduler_cuda_plan_matches_cpu(cuda, name, n_pods, dispatches):
    from karpenter_tpu_torch.kube.client import Cluster
    from karpenter_tpu_torch.scheduling.scheduler import Scheduler

    prov, catalog, pods = scenario("karpenter_tpu_torch", name, n_pods, 42)
    plans = []
    for device in ("cpu", "cuda"):
        sched = Scheduler(Cluster(), rng=random.Random(1), device=device)
        before = pack_kernel.launches
        nodes = sched.solve(prov, catalog, pods)
        prof = sched.last_stage_profile()
        assert prof["pack_dispatches"] == dispatches
        launched = pack_kernel.launches - before
        assert launched == (dispatches if device == "cuda" else 0)
        index = {id(p): i for i, p in enumerate(pods)}
        plans.append([
            ([index[id(p)] for p in n.pods], [it.name for it in n.instance_type_options],
             n.requests, n.constraints.requirements.requirements)
            for n in nodes
        ])
    assert plans[0] == plans[1]
