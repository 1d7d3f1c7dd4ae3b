"""The port's host stages against the JAX package's: the same scenario,
built from the same seeds in each package, goes through topology
injection (``random.Random(1)``), daemon overhead and encode. Every array
of the EncodedBatch, and its hostname, axis and open-signature context,
must be identical."""

import jax  # noqa: F401  (kept on the CPU by conftest)
import numpy as np
import pytest
import torch  # noqa: F401

from torch_parity import PACKAGES, encode_scenario, populated_cluster, scenario

ARRAYS = (
    "pod_valid", "pod_open_sig", "pod_core", "pod_host", "pod_host_in_base",
    "pod_open_host", "pod_req", "join_table", "frontiers", "daemon", "usable",
    "pod_req_id", "uniq_req", "open_sig_by_core",
)


@pytest.mark.parametrize(
    "name,n_pods,seed,populated",
    [
        ("diverse", 700, 42, False),
        ("diverse", 700, 9, False),
        ("config2", 300, 0, False),
        ("config3", 99, 0, False),
        ("diverse", 300, 3, True),
    ],
)
def test_encoded_batch_identical(name, n_pods, seed, populated):
    ref, out = (
        encode_scenario(
            pkg, *scenario(pkg, name, n_pods, seed),
            cluster=populated_cluster(pkg) if populated else None,
        )
        for pkg in PACKAGES
    )
    for field in ARRAYS:
        a, b = np.asarray(getattr(ref, field)), np.asarray(getattr(out, field))
        assert a.dtype == b.dtype and a.shape == b.shape, field
        np.testing.assert_array_equal(a, b, err_msg=field)
    np.testing.assert_array_equal(ref.type_mask_matrix(), out.type_mask_matrix())
    assert ref.n_pods == out.n_pods == n_pods
    assert ref.hostnames == out.hostnames
    assert ref.axis_names == out.axis_names
    assert ref.base_has_hostname == out.base_has_hostname
    assert len(ref.signatures) == len(out.signatures)
    if name == "config3":
        assert len(ref.hostnames) == 0 and len(ref.cores) > 1
    if name == "diverse":
        assert len(ref.hostnames) > 0  # hostname spread and affinity reached encode
    assert bool(np.asarray(ref.daemon).any()) == populated  # the daemonset counted
