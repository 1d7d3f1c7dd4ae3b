"""The port's fused solve against the JAX package's.

``karpenter_tpu_torch.solver.fused.fused_solve`` on the CPU (unpack →
``pack_first_fit``'s plain version → typemask and flatten, as torch ops)
must return the int32 buffer ``karpenter_tpu``'s
``fused.fused_solve(..., kernel="scan")`` returns, exactly, on inputs
carried across from the JAX encode.
"""

import jax
import numpy as np
import pytest
import torch

from karpenter_tpu.solver import fused as jax_fused
from karpenter_tpu_torch.solver import carry
from karpenter_tpu_torch.solver import fused
from torch_parity import encode_scenario, fields, scenario, synth_fields


def jax_buffer(f, n_max):
    tab, obc, bhh = jax_fused.pack_pod_table(_View(f))
    uniq = jax_fused.pad_uniq_req(f["uniq_req"])
    out = jax_fused.fused_solve(
        tab, obc, bhh, uniq, f["join_table"], f["frontiers"], f["daemon"],
        f["type_mask"], f["usable"], n_max=n_max, kernel="scan",
    )
    return np.asarray(jax.device_get(out))


class _View:
    def __init__(self, f):
        self.__dict__.update(f)


def port_buffer(f, n_max):
    args = carry.tensors_from_reference(f, "cpu")["fused"]
    return fused.fused_solve(*args, n_max=n_max).numpy()


def check(f, n_max):
    ref, out = jax_buffer(f, n_max), port_buffer(f, n_max)
    assert out.dtype == np.int32 and ref.dtype == np.int32
    np.testing.assert_array_equal(ref, out)
    return out


@pytest.mark.parametrize("n_types,n_pods,n_max", [(50, 300, 128), (400, 300, 256)])
def test_fused_buffer_identical(n_types, n_pods, n_max):
    batch = encode_scenario(
        "karpenter_tpu", *scenario("karpenter_tpu", "diverse", n_pods, 5, n_types)
    )
    f = fields(batch)
    buf = check(f, n_max)
    P, R, T = len(f["pod_valid"]), f["usable"].shape[1], n_types
    res, mask = fused.split_fused(buf, P, n_max, R, T)
    jres, jmask = jax_fused.split_fused(jax_buffer(f, n_max), P, n_max, R, T)
    for name, a, b in zip(res._fields, jres, res):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=name)
    np.testing.assert_array_equal(jmask, mask)
    assert mask[: int(res.n_nodes)].any(axis=1).all()  # every open node keeps a type


def test_fused_buffer_identical_with_type_at_bit_31():
    # 64 price-sorted types: the largest (type 63, bit 31 of word 1) fits
    # every node, so the packed word's sign bit is set
    batch = encode_scenario(
        "karpenter_tpu", *scenario("karpenter_tpu", "diverse", 200, 6, 64)
    )
    f = fields(batch)
    n_max = 128
    buf = check(f, n_max)
    res, mask = fused.split_fused(buf, len(f["pod_valid"]), n_max, f["usable"].shape[1], 64)
    n = int(res.n_nodes)
    assert mask[:n, 63].all()
    P, R = len(f["pod_valid"]), f["usable"].shape[1]
    words = buf[P + 2 * n_max + n_max * R :][: n_max * 2].reshape(n_max, 2)
    assert (words[:n, 1] < 0).all()


def test_fused_buffer_identical_synthetic():
    f = synth_fields(P=256, S=12, F=3, R=4, C=6, n_hosts=9, seed=2)
    check(f, 64)


def test_pack_typebits_sign_bit():
    ok = torch.zeros(2, 64, dtype=torch.bool)
    ok[0, 31] = True
    ok[1, [0, 31, 63]] = True
    words = fused._pack_typebits(ok)
    assert words.dtype == torch.int32
    assert words.tolist() == [[-(2**31), 0], [1 - 2**31, -(2**31)]]
