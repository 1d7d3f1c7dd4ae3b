"""The port's packing recurrence against the JAX package's.

``karpenter_tpu_torch.solver.kernel.pack_reference`` (the plain PyTorch
version of the CUDA kernel, and what ``pack_first_fit`` runs for CPU
tensors) must give a PackResult bit-identical to ``karpenter_tpu``'s
``kernel.pack`` (the lax.scan kernel the Pallas kernel is parity-tested
against) on identical inputs: JAX-encoded batches carried across as numpy
arrays, and seeded synthetic tables.
"""

import jax
import numpy as np
import pytest
import torch

from karpenter_tpu.solver import kernel as jax_kernel
from karpenter_tpu_torch.solver import carry, pack_kernel
from karpenter_tpu_torch.solver.kernel import PackResult, fuse_result, pack_reference, split_result
from torch_parity import encode_scenario, fields, scenario, synth_fields


def jax_pack(f, n_max):
    args = tuple(f[k] for k, _ in carry.PACK_ARG_DTYPES)
    return [np.asarray(a) for a in jax.device_get(tuple(jax_kernel.pack(*args, n_max=n_max)))]


def assert_same(ref, out):
    for name, a, b in zip(PackResult._fields, ref, out):
        b = b.cpu().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
        np.testing.assert_array_equal(np.asarray(a).reshape(b.shape), b, err_msg=name)
        assert np.asarray(a).dtype == b.dtype, name


def jax_fields(n_pods, seed=42):
    return fields(encode_scenario("karpenter_tpu", *scenario("karpenter_tpu", "diverse", n_pods, seed)))


@pytest.mark.parametrize("n_pods,n_max", [(100, 128), (500, 256), (1500, 512)])
def test_reference_matches_lax_kernel(n_pods, n_max):
    f = jax_fields(n_pods)
    args = carry.tensors_from_reference(f, "cpu")["pack_args"]
    assert_same(jax_pack(f, n_max), pack_reference(*args, n_max=n_max))


def test_reference_matches_lax_kernel_when_saturated():
    f = jax_fields(400, seed=7)
    ref = jax_pack(f, 16)
    assert int(ref[4]) == 16 and (ref[0][: 400] < 0).any()  # table full, pods left
    args = carry.tensors_from_reference(f, "cpu")["pack_args"]
    assert_same(ref, pack_reference(*args, n_max=16))


def test_reference_matches_lax_kernel_p64_bucket():
    f = jax_fields(40, seed=3)
    assert f["pod_req"].shape[0] == 64
    args = carry.tensors_from_reference(f, "cpu")["pack_args"]
    assert_same(jax_pack(f, 64), pack_reference(*args, n_max=64))


def test_reference_matches_lax_kernel_synthetic_tables():
    f = synth_fields(P=512, S=12, F=3, R=4, C=6, n_hosts=9, seed=5)
    ref = jax_pack(f, 256)
    hosts = set(ref[2][: int(ref[4])].tolist())
    assert {-2, -1} <= hosts and max(hosts) >= 0  # every hostname state occurs
    args = carry.tensors_from_reference(f, "cpu")["pack_args"]
    assert_same(ref, pack_reference(*args, n_max=256))


def test_fuse_and_split_result_match_jax():
    f = jax_fields(300, seed=4)
    args = tuple(f[k] for k, _ in carry.PACK_ARG_DTYPES)
    ref = np.asarray(jax.device_get(jax_kernel.fuse_result(jax_kernel.pack(*args, n_max=128))))
    out = fuse_result(pack_reference(*carry.tensors_from_reference(f, "cpu")["pack_args"], n_max=128))
    np.testing.assert_array_equal(ref, out.numpy())
    P, R = f["pod_req"].shape
    assert_same(jax_kernel.split_result(ref, P, 128, R), split_result(out.numpy(), P, 128, R))


def test_wrapper_runs_plain_version_on_cpu_without_counting():
    f = jax_fields(100)
    args = carry.tensors_from_reference(f, "cpu")["pack_args"]
    before = pack_kernel.launches
    assert_same(jax_pack(f, 128), pack_kernel.pack_first_fit(*args, n_max=128))
    assert pack_kernel.launches == before


@pytest.mark.parametrize(
    "mutate,err",
    [
        (lambda a: (a[0].to(torch.int32),) + a[1:], TypeError),  # dtype
        (lambda a: a[:6] + (a[6][:, :1].expand(-1, 3),) + a[7:], ValueError),  # layout
        (lambda a: a[:6] + (a[6][:-1],) + a[7:], ValueError),  # shape
        (lambda a: a[:9] + (a[9][:1],), ValueError),  # daemon axes
        (lambda a: a[:9], TypeError),  # arity
    ],
)
def test_wrapper_rejects_bad_inputs(mutate, err):
    f = synth_fields(P=64, S=4, F=2, R=3, C=3, n_hosts=2)
    args = carry.tensors_from_reference(f, "cpu")["pack_args"]
    with pytest.raises(err):
        pack_kernel.pack_first_fit(*mutate(args), n_max=8)
