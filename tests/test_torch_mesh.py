"""The port's solver mesh against the JAX package's.

``karpenter_tpu_torch.parallel.sharding.sharded_multi_solve`` over a
``SolverMesh`` of CPU devices (the plain versions, shard by shard) must
return the PackResult and the per-node cheapest types that
``karpenter_tpu``'s returns over the same (data, model) mesh of the 8
virtual CPU devices ``tests/conftest.py`` provides, exactly (tolerance 0),
and raise ``ValueError`` where it raises. The stacks come from the port's
``graft_entry._example_batch``, whose ``pod_req`` is a transposed view, so
the stacked array is not C-contiguous.
"""

import numpy as np
import pytest
import torch

import __graft_entry__ as jax_entry
from karpenter_tpu.parallel import sharding as jax_sharding
from karpenter_tpu_torch import graft_entry
from karpenter_tpu_torch.parallel import make_solver_mesh, sharded_multi_solve
from karpenter_tpu_torch.parallel import sharding
from karpenter_tpu_torch.solver.kernel import PackResult

MESHES = [(1, 1), (2, 1), (2, 2), (4, 2), (8, 1), (4, 4)]


def example_stack(B, **kw):
    """B batches of ``_example_batch(**kw)`` under seeds 0..B-1 (offset by
    ``seed``), stacked: (arrays, type masks, usable, prices)."""
    seed = kw.pop("seed", 0)
    batches = [graft_entry._example_batch(seed=seed + b, **kw) for b in range(B)]
    return graft_entry.stack_batches([b for b, _ in batches], batches[0][1])


@pytest.fixture(scope="module")
def stacks():
    return {
        # P = 128, S = 9, F = 1, T = 24: v1
        "v1": example_stack(8, n_pods=128, n_types=24, k_labels=8),
        # P = 128, S = 65, F = 16, T = 16: S·F past the v1 budget, v2
        "v2": example_stack(8, n_pods=128, n_types=16, k_labels=64, seed=100, tradeoff=True),
    }


def solve_both(mesh_shape, stack, n_max=64):
    n, m = mesh_shape
    ref = jax_sharding.sharded_multi_solve(
        jax_sharding.make_solver_mesh(n, model_parallel=m), *stack, n_max=n_max)
    out = sharded_multi_solve(make_solver_mesh(n, m, devices=["cpu"] * n), *stack, n_max=n_max)
    return ref, out


def assert_equal(ref, out):
    (ref_result, ref_cheapest, _), (result, cheapest, _) = ref, out
    for name, a, b in zip(PackResult._fields, ref_result, result):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=name)
    np.testing.assert_array_equal(np.asarray(ref_cheapest), cheapest.numpy(), err_msg="cheapest")


@pytest.mark.parametrize("kind,route", [("v1", "pack_reference"), ("v2", "pack_v2_reference")])
@pytest.mark.parametrize("mesh_shape", MESHES, ids=[f"{n}x{m}" for n, m in MESHES])
def test_mesh_matches_jax(stacks, mesh_shape, kind, route):
    ref, out = solve_both(mesh_shape, stacks[kind])
    assert_equal(ref, out)
    report, ref_report = out[2], ref[2]
    assert set(report) == set(ref_report)
    assert report["route"] == route
    assert {k: report[k] for k in ("v1_shape_eligible", "S", "F", "B", "P")} == {
        k: ref_report[k] for k in ("v1_shape_eligible", "S", "F", "B", "P")}
    assert out[0].n_nodes.min() > 0


def test_mesh_shape_reads_like_the_reference():
    for n, m in MESHES:
        ours = make_solver_mesh(n, m, devices=["cpu"] * 8)
        assert ours.shape == dict(jax_sharding.make_solver_mesh(n, model_parallel=m).shape)
    # more devices asked for than named: every named device, as the reference
    assert make_solver_mesh(12, devices=["cpu"] * 8).shape == dict(
        jax_sharding.make_solver_mesh(12).shape)


def test_mesh_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_solver_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.dryrun_multichip(8)


@pytest.mark.parametrize("n,m", [(8, 3), (6, 4), (2, 4)])
def test_mesh_that_does_not_reshape_raises_in_both(n, m):
    with pytest.raises(ValueError):
        jax_sharding.make_solver_mesh(n, model_parallel=m)
    with pytest.raises(ValueError):
        make_solver_mesh(n, m, devices=["cpu"] * 8)


def cut(stack, B, T):
    """The first B batches and the first T types of a stack."""
    arrays, mask, usable, prices = stack
    return tuple(a[:B] for a in arrays), mask[:B, :, :T], usable[:T], prices[:T]


@pytest.mark.parametrize(
    "mesh_shape,B,T,raises",
    [((4, 2), 6, 24, True), ((1, 4), 8, 22, True), ((3, 2), 6, 22, False)],
    ids=["batch-not-divisible-by-data", "types-not-divisible-by-model", "divisible"],
)
def test_placement_gates_match_jax(stacks, mesh_shape, B, T, raises):
    n, m = mesh_shape
    stack = cut(stacks["v1"], B, T)
    if not raises:
        assert_equal(*solve_both((n * m, m), stack))
        return
    with pytest.raises(ValueError):
        jax_sharding.sharded_multi_solve(
            jax_sharding.make_solver_mesh(n * m, model_parallel=m), *stack, n_max=64)
    with pytest.raises(ValueError):
        sharded_multi_solve(make_solver_mesh(n * m, m, devices=["cpu"] * 8), *stack, n_max=64)


@pytest.mark.parametrize("mesh_shape", [(2, 2), (4, 2), (4, 4)], ids=["2x2", "4x2", "4x4"])
def test_ties_across_model_shards_and_nodes_nothing_fits(stacks, mesh_shape):
    arrays, mask, usable, _ = stacks["v1"]
    # types 11 and 12 (cpu 11,900 and 12,900 millicores) tie as the cheapest,
    # on both sides of a shard boundary at model 2 and at model 4
    prices = np.full(usable.shape[0], 2.0, np.float32)
    prices[[11, 12]] = 1.0
    # no type holds more than 12,000 cpu millicores: the fullest node fits none
    usable = usable.copy()
    usable[:, 0] = np.minimum(usable[:, 0], 12000.0)
    ref, out = solve_both(mesh_shape, (arrays, mask, usable, prices))
    assert_equal(ref, out)
    result, cheapest = out[0], out[1]
    opened = cheapest[torch.arange(cheapest.shape[1])[None, :] < result.n_nodes[:, None]]
    assert (opened == 11).any() and (opened == -1).any()


@pytest.mark.parametrize("m", [2, 3, 4])
def test_reduced_parts_match_one_argmin(m):
    rng = np.random.default_rng(5)
    B, N, S, T, R = 3, 30, 6, 12, 2
    node_req = rng.uniform(0, 4, (B, N, R)).astype(np.float32)
    node_sig = rng.integers(-1, S, (B, N)).astype(np.int32)
    mask = rng.random((B, S, T)) < 0.6
    usable = rng.uniform(0, 5, (T, R)).astype(np.float32)
    prices = rng.choice([1.0, 2.0], T).astype(np.float32)
    ref = np.asarray(jax_sharding._cheapest_multi(node_req, node_sig, mask, usable, prices))
    w = T // m
    parts = [
        sharding._cheapest_part(
            *(torch.tensor(a) for a in (node_req, node_sig, mask[:, :, j * w:(j + 1) * w],
                                        usable[j * w:(j + 1) * w], prices[j * w:(j + 1) * w])),
            offset=j * w)
        for j in range(m)
    ]
    assert (ref == -1).any() and (ref >= 0).any()
    np.testing.assert_array_equal(ref, sharding._reduce_parts(parts).numpy())


# -- the repaired upload and the entry points --------------------------------


@pytest.mark.parametrize("B", [2, 8])
def test_example_batch_stack_with_transposed_pod_req_solves(B):
    stack = example_stack(B, n_pods=256, n_types=32, k_labels=16)
    assert not stack[0][6].flags.c_contiguous
    ref = jax_sharding.sharded_multi_solve(jax_sharding.make_solver_mesh(1), *stack, n_max=128)
    out = sharded_multi_solve("cpu", *stack, n_max=128)
    assert_equal(ref, out)


@pytest.mark.parametrize(
    "kw",
    [{}, dict(n_pods=2048, n_types=32, k_labels=128, seed=3),
     dict(n_pods=512, n_types=16, k_labels=64, seed=101, tradeoff=True)],
    ids=["entry", "dryrun-v1", "dryrun-v2"],
)
def test_example_batch_pack_args_match_jax(kw):
    ref, ref_catalog = jax_entry._example_batch(**kw)
    out, catalog = graft_entry._example_batch(**kw)
    for i, (a, b) in enumerate(zip(ref.pack_args(), out.pack_args())):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=str(i))
    np.testing.assert_array_equal(ref.type_mask_matrix(), out.type_mask_matrix())
    np.testing.assert_array_equal(ref.usable, out.usable)
    assert [it.name for it in ref_catalog] == [it.name for it in catalog]


def test_entry_matches_jax():
    ref_fn, ref_args = jax_entry.entry()
    fn, args = graft_entry.entry("cpu")
    assert all(t.is_contiguous() and t.device.type == "cpu" for t in args)
    for name, a, b in zip(PackResult._fields, ref_fn(*ref_args), fn(*args)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=name)


def test_dryrun_matches_jax(capsys):
    import json

    jax_entry.dryrun_multichip(8)
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("dryrun_multichip ok: ")][-1]
    ref = json.loads(line[len("dryrun_multichip ok: "):])
    out = graft_entry.dryrun_multichip(8, devices=["cpu"] * 8)
    ours = out["summary"]
    assert capsys.readouterr().out.startswith("dryrun_multichip ok: ")
    assert set(ours) == set(ref) and set(ours["f_gt1"]) == set(ref["f_gt1"])
    for key in ("mesh", "B", "pods_per_batch", "P", "S", "F", "n_max", "nodes_per_batch",
                "scheduled", "parity_checked_batches"):
        assert ours[key] == ref[key], key
    for key in ("S", "F", "scheduled", "parity_checked_batches"):
        assert ours["f_gt1"][key] == ref["f_gt1"][key], key
    for leg, ref_route in (("route", ref["route"]), ("f_gt1", ref["f_gt1"]["route"])):
        route = ours[leg] if leg == "route" else ours[leg]["route"]
        assert set(route) == set(ref_route)
        for key in ("v1_shape_eligible", "v2_shape_eligible", "S", "F", "B", "P"):
            assert route[key] == ref_route[key], (leg, key)
    assert out["legs"]["v1"]["route"]["route"] == "pack_reference"
    assert out["legs"]["v2"]["route"]["route"] == "pack_v2_reference"
    # the plain versions launch nothing
    assert all(n == 0 for leg in out["legs"].values() for n in leg["launches"].values())
