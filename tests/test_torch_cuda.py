"""Card-only tests of the PyTorch port: the CUDA kernels against their plain
versions, and the port's cuda paths (single solve on both routes,
multi-solve) against its cpu paths. Every comparison is exact.

Marked ``cuda``; each skips without a CUDA device (decided in a fixture,
never at import). This file imports neither JAX nor the JAX package, so it
runs on a machine with PyTorch alone:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import random

import numpy as np
import pytest
import torch

from karpenter_tpu_torch.solver import carry, fused, pack_kernel, pack_kernel_v2
from karpenter_tpu_torch.solver.backend import kernel_name
from karpenter_tpu_torch.solver.kernel import PackResult, pack_reference, pack_v2_reference
from torch_parity import encode_scenario, fields, scenario, synth_fields, team_mix

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


@pytest.mark.parametrize(
    "name,n_pods,n_types,dispatches,kernel",
    [
        ("diverse", 700, 50, 1, "pack_first_fit"),
        ("one_per_node", 600, 50, 2, "pack_first_fit"),
        ("teams", 2000, 64, 1, "pack_first_fit_v2"),
    ],
)
def test_scheduler_cuda_plan_matches_cpu(cuda, name, n_pods, n_types, dispatches, kernel):
    from karpenter_tpu_torch.kube.client import Cluster
    from karpenter_tpu_torch.scheduling.scheduler import Scheduler

    prov, catalog, pods = scenario("karpenter_tpu_torch", name, n_pods, 42, n_types)
    module = pack_kernel_v2 if kernel == "pack_first_fit_v2" else pack_kernel
    plans = []
    for device in ("cpu", "cuda"):
        sched = Scheduler(Cluster(), rng=random.Random(1), device=device)
        before = module.launches
        nodes = sched.solve(prov, catalog, pods)
        prof = sched.last_stage_profile()
        assert prof["pack_dispatches"] == dispatches
        assert prof["packer_backend"] == kernel_name(
            "v2" if module is pack_kernel_v2 else "v1", torch.device(device)
        )
        launched = module.launches - before
        assert launched == (dispatches if device == "cuda" else 0)
        index = {id(p): i for i, p in enumerate(pods)}
        plans.append([
            ([index[id(p)] for p in n.pods], [it.name for it in n.instance_type_options],
             n.requests, n.constraints.requirements.requirements)
            for n in nodes
        ])
    assert plans[0] == plans[1]


def v2_args(f, device):
    return carry.tensors_from_reference(f, device)["pack_v2_args"]


@pytest.mark.parametrize("n_max", [8, 128, 512])
def test_v2_kernel_matches_reference_synthetic(cuda, n_max):
    # hostname-pinned pods (-2, -1, h), incompatible joins, PAD rows
    f = synth_fields(P=512, S=12, F=3, R=4, C=6, n_hosts=9, seed=5)
    before = pack_kernel_v2.launches
    out = pack_kernel_v2.pack_first_fit_v2(*v2_args(f, cuda), n_max=n_max, F=3, R=4)
    torch.cuda.synchronize()
    assert pack_kernel_v2.launches == before + 1
    assert_same(pack_v2_reference(*v2_args(f, "cpu"), n_max=n_max, F=3, R=4), out)


def test_v2_kernel_matches_reference_encoded(cuda):
    pkg = "karpenter_tpu_torch"
    f = fields(encode_scenario(pkg, *team_mix(pkg, 2000, 9, 64)))
    F, R = f["frontiers"].shape[1:]
    assert f["join_table"].shape[0] * F > pack_kernel_v2.PALLAS_UNROLL_BUDGET
    for n_max in (16, 512, len(f["pod_valid"])):
        assert_same(
            pack_v2_reference(*v2_args(f, "cpu"), n_max=n_max, F=F, R=R),
            pack_kernel_v2.pack_first_fit_v2(*v2_args(f, cuda), n_max=n_max, F=F, R=R),
        )


def test_v2_kernel_batch_axis(cuda):
    fs = [synth_fields(P=256, S=20, F=4, R=2, C=5, n_hosts=7, seed=s) for s in (1, 2, 3)]
    stacked = tuple(torch.stack(c) for c in zip(*(v2_args(f, cuda) for f in fs)))
    out = pack_kernel_v2.pack_first_fit_v2(*stacked, n_max=64, F=4, R=2)
    for b, f in enumerate(fs):
        ref = pack_v2_reference(*v2_args(f, "cpu"), n_max=64, F=4, R=2)
        assert_same(ref, PackResult(*(x[b] for x in out)))


def test_v2_wrapper_rejects_bad_dtype_on_card(cuda):
    f = synth_fields(P=64, S=4, F=2, R=3, C=3, n_hosts=2)
    args = v2_args(f, cuda)
    with pytest.raises(TypeError):
        pack_kernel_v2.pack_first_fit_v2(
            args[0], args[1].to(torch.float64), *args[2:], n_max=8, F=2, R=3
        )


def test_fused_v2_buffer_matches_cpu(cuda):
    pkg = "karpenter_tpu_torch"
    f = fields(encode_scenario(pkg, *team_mix(pkg, 512, 9, 16)))
    F, R = f["frontiers"].shape[1:]
    ref = fused.fused_solve_v2(*carry.tensors_from_reference(f, "cpu")["fused_v2"], n_max=512, F=F, R=R)
    out = fused.fused_solve_v2(*carry.tensors_from_reference(f, cuda)["fused_v2"], n_max=512, F=F, R=R)
    np.testing.assert_array_equal(ref.numpy(), out.cpu().numpy())


@pytest.mark.parametrize("tradeoff,kernel", [(False, "pack_first_fit"), (True, "pack_first_fit_v2")])
def test_multi_solve_cuda_matches_cpu(cuda, tradeoff, kernel):
    from karpenter_tpu_torch.cloudprovider.fake import instance_types
    from karpenter_tpu_torch.parallel import sharding

    pkg = "karpenter_tpu_torch"
    batches = []
    for seed in (100, 101, 102, 103):
        prov, catalog, pods = team_mix(pkg, 300, seed, 80, k_teams=16)
        if not tradeoff:
            catalog = instance_types(80)
        batches.append(encode_scenario(pkg, prov, catalog, pods))
    arrays = tuple(np.stack([np.asarray(b.pack_args()[i]) for b in batches]) for i in range(10))
    mask = np.stack([b.type_mask_matrix() for b in batches])
    prices = np.array(sorted(it.effective_price() for it in catalog), np.float32)
    usable = batches[0].usable
    ref, ref_cheapest, ref_route = sharding.sharded_multi_solve("cpu", arrays, mask, usable, prices, 64)
    module = pack_kernel_v2 if tradeoff else pack_kernel
    before = module.launches
    out, cheapest, route = sharding.sharded_multi_solve(cuda, arrays, mask, usable, prices, 64)
    torch.cuda.synchronize()
    assert module.launches == before + 1 and route["route"] == kernel
    assert_same(ref, out)
    np.testing.assert_array_equal(ref_cheapest.numpy(), cheapest.cpu().numpy())
