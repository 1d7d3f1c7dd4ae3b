"""The port's native packer (``solver/native.py`` over
``solver/csrc/ffd_pack.cpp``) against the JAX package's native packer and
its lax.scan kernel, bit for bit, on real encoded batches; where the port
builds its library; and its error contract.

The shapes are those of the reference's own native tests: 60, 300 and
1,200 diverse pods at n_max 64, 128 and 512, and a saturating 8-slot table.
"""

import random
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from karpenter_tpu.solver import kernel as jax_kernel
from karpenter_tpu.solver import native as jax_native
from karpenter_tpu_torch.solver import native
from karpenter_tpu_torch.solver.kernel import PackResult, pack_reference
from torch_parity import fresh_router  # noqa: F401

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def built():
    for mod in (native, jax_native):
        if not mod.native_available(wait=180):
            pytest.fail(f"{mod.__name__}: the native packer did not build")


def encoded_args(n_pods, seed=42, n_types=50):
    """The reference's encoded diverse batch, in pack_args() order (numpy)."""
    from karpenter_tpu.cloudprovider.fake import instance_types
    from karpenter_tpu.cloudprovider.requirements import catalog_requirements
    from karpenter_tpu.kube.client import Cluster
    from karpenter_tpu.scheduling.ffd import daemon_overhead, sort_pods_ffd
    from karpenter_tpu.scheduling.topology import Topology
    from karpenter_tpu.solver import encode as enc
    from karpenter_tpu.testing import diverse_pods, make_provisioner

    catalog = sorted(instance_types(n_types), key=lambda it: it.effective_price())
    c = make_provisioner(solver="tpu").spec.constraints
    c.requirements = c.requirements.merge(catalog_requirements(catalog))
    pods = sort_pods_ffd(diverse_pods(n_pods, random.Random(seed)))
    cc = c.clone()
    Topology(Cluster(), rng=random.Random(1)).inject(cc, pods)
    batch = enc.encode(cc, catalog, pods, daemon_overhead(Cluster(), cc))
    return tuple(np.asarray(a) for a in batch.pack_args())


def assert_same(ref, out):
    for name, a, b in zip(PackResult._fields, ref, out):
        a, b = np.asarray(a), np.asarray(b)
        np.testing.assert_array_equal(a, b, err_msg=name)
        assert a.dtype == b.dtype, name


@pytest.mark.parametrize(
    "n_pods,n_max,seed", [(60, 64, 1), (300, 128, 2), (1200, 512, 3), (200, 8, 4)],
    ids=["60", "300", "1200", "saturated"],
)
def test_native_matches_reference_native_and_lax_scan(n_pods, n_max, seed):
    args = encoded_args(n_pods, seed=seed)
    before = native.calls
    out = native.pack_native(*args, n_max=n_max)
    assert native.calls == before + 1
    assert_same(jax_native.pack_native(*args, n_max=n_max), out)
    assert_same(jax.device_get(tuple(jax_kernel.pack(*args, n_max=n_max))), out)
    # and the port's own plain version, on CPU tensors (the same arrays)
    tensors = tuple(torch.from_numpy(np.array(a)) for a in args)
    assert_same(tuple(t.numpy() for t in pack_reference(*tensors, n_max=n_max)), out)
    # tensors in, the same host arrays out
    assert_same(out, native.pack_native(*tensors, n_max=n_max))
    if n_max == 8:
        assert int(out.n_nodes) == 8 and (out.assignment < 0).any()


def test_library_lands_under_build_never_native():
    path = native.lib_path()
    assert path.exists()
    rel = path.relative_to(REPO)
    assert rel.parts[:2] == ("build", "karpenter_tpu_torch")
    assert rel.parts[2].startswith("native-") and rel.name == "libffd_pack.so"
    assert native.SRC.relative_to(REPO).as_posix() == "karpenter_tpu_torch/solver/csrc/ffd_pack.cpp"
    # the build is keyed on the source and the flags
    assert path.parent.name != native.BUILD_ROOT.name and "march" not in " ".join(native.GXX_FLAGS)


def test_more_than_64_axes_errors_as_the_reference_does():
    P, R, S, C, F = 8, 65, 2, 1, 1
    args = (
        np.ones(P, bool), np.zeros(P, np.int32), np.zeros(P, np.int32),
        np.full(P, -1, np.int32), np.ones(P, bool), np.full(P, -1, np.int32),
        np.full((P, R), 0.1, np.float32), np.zeros((S, C), np.int32),
        np.ones((S, F, R), np.float32), np.zeros(R, np.float32),
    )
    for mod in (jax_native, native):
        with pytest.raises(RuntimeError, match="native packer error -1"):
            mod.pack_native(*args, n_max=4)
