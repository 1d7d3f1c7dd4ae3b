"""The port's multi-solve against the JAX package's.

``karpenter_tpu_torch.parallel.sharding.sharded_multi_solve`` on the CPU
(the plain versions, problem by problem) must return the PackResult and the
per-node cheapest types that ``karpenter_tpu``'s ``sharded_multi_solve``
returns on a one-device CPU mesh (its vmapped lax.scan), exactly
(tolerance 0), for a stack that routes v1 and one that routes v2. Stacks are
batches of one scenario under different pod seeds, which encode to the same
shapes.
"""

import importlib

import jax
import numpy as np
import pytest
import torch

from karpenter_tpu.parallel import sharding as jax_sharding
from karpenter_tpu_torch.parallel import sharding
from karpenter_tpu_torch.solver import carry
from karpenter_tpu_torch.solver.kernel import PackResult
from torch_parity import encode_scenario, team_mix


def stack(pkg, n_pods, n_types, seeds, tradeoff):
    """Encoded batches of the team mix (tradeoff or linear catalog), one per
    pod seed, stacked: (arrays, type masks, usable, prices)."""
    batches, catalog = [], None
    for seed in seeds:
        prov, catalog, pods = team_mix(pkg, n_pods, seed, n_types, k_teams=16)
        if not tradeoff:
            catalog = importlib.import_module(f"{pkg}.cloudprovider.fake").instance_types(n_types)
        batches.append(encode_scenario(pkg, prov, catalog, pods))
    shapes = {tuple(np.asarray(a).shape for a in b.pack_args()) for b in batches}
    assert len(shapes) == 1, shapes  # only batches of one encoded shape stack
    arrays = tuple(
        np.stack([np.asarray(b.pack_args()[i]) for b in batches])
        for i in range(len(carry.PACK_ARG_DTYPES))
    )
    mask = np.stack([np.asarray(b.type_mask_matrix()) for b in batches])
    prices = np.array(
        [it.effective_price() for it in sorted(catalog, key=lambda it: it.effective_price())],
        np.float32,
    )
    return arrays, mask, np.asarray(batches[0].usable, np.float32), prices


@pytest.mark.parametrize(
    "n_types,tradeoff,route",
    [(24, False, "pack_reference"), (80, True, "pack_v2_reference")],
    ids=["v1", "v2"],
)
def test_multi_solve_matches_jax(n_types, tradeoff, route):
    arrays, mask, usable, prices = stack("karpenter_tpu", 300, n_types, (100, 101, 102), tradeoff)
    n_max = 64
    ref, ref_cheapest, ref_route = jax_sharding.sharded_multi_solve(
        jax_sharding.make_solver_mesh(1), arrays, mask, usable, prices, n_max=n_max
    )
    out, cheapest, report = sharding.sharded_multi_solve(
        "cpu", arrays, mask, usable, prices, n_max=n_max
    )
    for name, a, b in zip(PackResult._fields, jax.device_get(tuple(ref)), out):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=name)
    np.testing.assert_array_equal(np.asarray(ref_cheapest), cheapest.numpy())
    n = out.n_nodes.tolist()
    assert all(k > 0 for k in n) and (cheapest[0, : n[0]] >= 0).all()
    assert report["route"] == route
    assert {k: report[k] for k in ("S", "F", "B", "P")} == {
        k: ref_route[k] for k in ("S", "F", "B", "P")
    }
    assert report["v1_shape_eligible"] == (route == "pack_reference")
    assert report["v2_shape_eligible"]


@pytest.mark.parametrize("n_pods,P", [(50, 64), (1250, 2048)])
def test_route_report_v1_gate_matches_jax(n_pods, P):
    """``v1_shape_eligible`` by the reference's rule (P a multiple of 128,
    S·F within the unroll budget, B divisible by the data axis) on a stack
    at the smallest pod bucket and on one at the multi-solve's bench size.
    ``v2_shape_eligible`` keeps the card's table gate (a deliberate
    difference), so it is not compared."""
    arrays, mask, usable, prices = stack("karpenter_tpu", n_pods, 24, (100, 101), False)
    assert arrays[6].shape[1] == P
    _, _, ref_route = jax_sharding.sharded_multi_solve(
        jax_sharding.make_solver_mesh(1), arrays, mask, usable, prices, n_max=64
    )
    _, _, report = sharding.sharded_multi_solve("cpu", arrays, mask, usable, prices, n_max=64)
    assert report["v1_shape_eligible"] == ref_route["v1_shape_eligible"] == (P % 128 == 0)
    assert report["S"] * report["F"] <= 1024


def test_multi_solve_stacks_port_encoded_batches_like_jax():
    # the port's own encode gives the arrays the JAX stack is built from
    ref = stack("karpenter_tpu", 200, 40, (7, 8), True)
    out = stack("karpenter_tpu_torch", 200, 40, (7, 8), True)
    for a, b in zip(ref[0] + ref[1:], out[0] + out[1:]):
        np.testing.assert_array_equal(a, b)


def test_cheapest_multi_matches_jax_with_ties():
    rng = np.random.default_rng(3)
    B, N, S, T, R = 3, 20, 6, 12, 2
    node_req = rng.uniform(0, 4, (B, N, R)).astype(np.float32)
    node_sig = rng.integers(-1, S, (B, N)).astype(np.int32)
    mask = rng.random((B, S, T)) < 0.6
    usable = rng.uniform(0, 5, (T, R)).astype(np.float32)
    prices = rng.choice([1.0, 2.0, 3.0], T).astype(np.float32)  # ties on price
    ref = np.asarray(jax_sharding._cheapest_multi(node_req, node_sig, mask, usable, prices))
    out = sharding._cheapest_multi(*(torch.tensor(a) for a in (node_req, node_sig, mask, usable, prices)))
    assert (ref == -1).any() and (ref >= 0).any()
    np.testing.assert_array_equal(ref, out.numpy())
