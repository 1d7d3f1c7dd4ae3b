"""The port's v2 route against the JAX package's: constraint-diverse
batches (S·F past the v1 budget) through ``pack_first_fit_v2``'s plain
version, ``fused_solve_v2`` and ``Scheduler.solve``.

The JAX v2 kernel (``pallas_kernel_v2._pack_v2_call``) runs here in Pallas
interpret mode: the ``interpret`` fixture (``torch_parity``) patches
``pl.pallas_call`` for one test and clears the jitted callers' caches
before and after, so no traced program outlives the patch. Nothing in
``karpenter_tpu`` changes.
Every comparison is exact (tolerance 0): integer outputs equal, f32 totals
and tables equal bit for bit.
"""

import random

import jax
import numpy as np
import pytest
import torch

from karpenter_tpu.solver import fused as jax_fused
from karpenter_tpu.solver import kernel as jax_kernel
from karpenter_tpu.solver import pallas_kernel_v2 as jax_v2
from karpenter_tpu_torch.solver import carry, fused, pack_kernel_v2
from karpenter_tpu_torch.solver.kernel import PackResult, pack_v2_reference
from torch_parity import (  # noqa: F401
    encode_scenario, fields, fresh_router, interpret, pinned, scenario, synth_fields, team_mix,
)


def team_fields(n_pods, n_types, seed=9, pkg="karpenter_tpu"):
    return fields(encode_scenario(pkg, *team_mix(pkg, n_pods, seed, n_types)))


def pinned_fields(pkg="karpenter_tpu"):
    """Synthetic tables with hostname-pinned pods (-2, -1 and h states),
    incompatible joins and FRONTIER_PAD rows; P a multiple of 128 for the
    TPU kernel."""
    return synth_fields(P=512, S=12, F=3, R=4, C=6, n_hosts=9, seed=5, pkg=pkg)


def kernel_args(f):
    return tuple(f[k] for k, _ in carry.PACK_ARG_DTYPES)


def v2_reference(f, n_max):
    args = carry.tensors_from_reference(f, "cpu")["pack_v2_args"]
    F, R = f["frontiers"].shape[1:]
    return pack_v2_reference(*args, n_max=n_max, F=F, R=R)


def assert_same(ref, out):
    for name, a, b in zip(PackResult._fields, ref, out):
        b = b.cpu().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
        a = np.asarray(a)
        np.testing.assert_array_equal(a.reshape(b.shape), b, err_msg=name)
        assert a.dtype == b.dtype, name


# -- _precompute -----------------------------------------------------------


@pytest.mark.parametrize(
    "make",
    [
        lambda: team_fields(512, 16),
        lambda: team_fields(2000, 64),
        # S not a multiple of 128, incompatible joins, PAD rows
        lambda: synth_fields(P=64, S=200, F=5, R=3, C=7, n_hosts=4, seed=1),
        # one core
        lambda: synth_fields(P=64, S=9, F=3, R=2, C=1, n_hosts=4, seed=2),
    ],
    ids=["tradeoff16", "tradeoff64", "synthetic_S200", "synthetic_C1"],
)
def test_precompute_byte_identical(make):
    f = make()
    join, front = np.asarray(f["join_table"]), np.asarray(f["frontiers"], np.float32)
    ref = jax_v2._precompute(join, front)
    out = pack_kernel_v2._precompute(join, front)
    assert ref[3] == out[3]
    for name, a, b in zip(("front_j", "compat_j", "jvals"), ref[:3], out[:3]):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert a.tobytes() == b.tobytes(), name


def test_precompute_keeps_pad_and_incompatible_limits():
    f = synth_fields(P=64, S=200, F=5, R=3, C=7, n_hosts=4, seed=1)
    front_j, compat_j, jvals, S_pad = pack_kernel_v2._precompute(
        f["join_table"], f["frontiers"]
    )
    assert S_pad == 256 and front_j.shape == (7, 16, 256)
    assert (front_j[:, 15, :] == pack_kernel_v2.NEG).all()  # rows past F·R
    c, s = np.argwhere(f["join_table"].T < 0)[0]
    assert compat_j[c, 0, s] == 0.0 and (front_j[c, :15, s] == pack_kernel_v2.NEG).all()
    assert (front_j[:, :15, :200] == -1.0).any()  # FRONTIER_PAD rows carried through


# -- the plain version against the JAX v2 kernel and lax.scan -------------


@pytest.mark.parametrize(
    "case,n_max",
    [("teams", 256), ("teams", 16), ("teams", 512), ("pinned", 128), ("pinned", 8), ("pinned", 512)],
    ids=["teams-256", "teams-saturated", "teams-P", "pinned-128", "pinned-saturated", "pinned-P"],
)
def test_v2_reference_matches_jax_v2_and_lax_scan(interpret, case, n_max):
    f = team_fields(512, 16) if case == "teams" else pinned_fields()
    assert len(f["pod_valid"]) == 512
    ref_v2 = jax.device_get(tuple(jax_v2.pack_pallas_v2(*kernel_args(f), n_max=n_max)))
    ref_scan = jax.device_get(tuple(jax_kernel.pack(*kernel_args(f), n_max=n_max)))
    out = v2_reference(f, n_max)
    assert_same(ref_v2, out)
    assert_same(ref_scan, out)
    n = int(out.n_nodes)
    if n_max in (8, 16):  # the table filled with pods left over
        assert n == n_max and (out.assignment[: len(f["pod_valid"])] < 0).any()
    if case == "pinned" and n_max == 128:
        hosts = set(out.node_host[:n].tolist())
        assert {-2, -1} <= hosts and max(hosts) >= 0  # every hostname state occurs


def test_v2_reference_reads_only_its_tables():
    # a wrong joined id in jvals must change the plan: the plain version
    # takes the id from the tables, never from the join table
    f = team_fields(512, 16, pkg="karpenter_tpu_torch")
    good = v2_reference(f, 256)
    core = int(f["pod_core"][0])
    sig = int(good.node_sig[0])
    f["jvals"] = f["jvals"].copy()
    f["jvals"][core, 0, :] = float(f["frontiers"].shape[0] - 1)
    bad = v2_reference(f, 256)
    assert not torch.equal(good.node_sig, bad.node_sig), sig


def test_wrapper_runs_plain_version_on_cpu_without_counting():
    f = pinned_fields(pkg="karpenter_tpu_torch")
    args = carry.tensors_from_reference(f, "cpu")["pack_v2_args"]
    F, R = f["frontiers"].shape[1:]
    before = pack_kernel_v2.launches
    out = pack_kernel_v2.pack_first_fit_v2(*args, n_max=64, F=F, R=R)
    assert pack_kernel_v2.launches == before
    assert_same(pack_v2_reference(*args, n_max=64, F=F, R=R), out)


def test_wrapper_batch_axis_solves_each_problem():
    fs = [synth_fields(P=128, S=12, F=3, R=2, C=4, n_hosts=5, seed=s) for s in (3, 4)]
    per = [carry.tensors_from_reference(f, "cpu")["pack_v2_args"] for f in fs]
    stacked = tuple(torch.stack(col) for col in zip(*per))
    out = pack_kernel_v2.pack_first_fit_v2(*stacked, n_max=32, F=3, R=2)
    assert out.assignment.shape == (2, 128) and out.node_req.shape == (2, 32, 2)
    for b, args in enumerate(per):
        assert_same(pack_v2_reference(*args, n_max=32, F=3, R=2), PackResult(*(x[b] for x in out)))


def _with(t, idx, value):
    t = t.clone()
    t[idx] = value
    return t


@pytest.mark.parametrize(
    "mutate,kw,err",
    [
        (lambda a: (a[0].to(torch.int64),) + a[1:], {}, TypeError),  # dtype
        (lambda a: a[:1] + (a[1].t().contiguous().t(),) + a[2:], {}, ValueError),  # layout
        (lambda a: a[:5] + (a[5][:, :-1],) + a[6:], {}, ValueError),  # open_fits shape
        (lambda a: a[:6] + (a[6][:1],), {}, ValueError),  # daemon axes
        (lambda a: a[:6], {}, TypeError),  # arity
        (lambda a: a[:3] + (a[3][:, :, :-1],) + a[4:], {}, ValueError),  # compat_j S_pad
        (lambda a: a, {"F": 9}, ValueError),  # F·R beyond front_j's rows
        (lambda a: a, {"R": 2}, ValueError),  # R disagrees with pod_req
        (lambda a: (a[0][None],) + a[1:], {}, ValueError),  # batch axis on one input only
        # ids the kernel would index the tables with, unchecked: S_pad = 128, C = 3
        (lambda a: (_with(a[0], (1, 0), 128),) + a[1:], {}, ValueError),  # open signature
        (lambda a: a[:4] + (_with(a[4], (0, 0, 0), 127.5),) + a[5:], {}, ValueError),  # rounds to 128
        (lambda a: (_with(a[0], (2, 0), 3),) + a[1:], {}, ValueError),  # core past C
        (lambda a: (_with(a[0], (2, 0), -1),) + a[1:], {}, ValueError),  # negative core
    ],
    ids=["dtype", "layout", "open_fits", "daemon", "arity", "compat_j", "F", "R", "batch",
         "open_sig", "joined_id", "core_hi", "core_lo"],
)
def test_wrapper_rejects_bad_inputs(mutate, kw, err):
    f = synth_fields(P=64, S=4, F=2, R=3, C=3, n_hosts=2)
    args = carry.tensors_from_reference(f, "cpu")["pack_v2_args"]
    with pytest.raises(err):
        pack_kernel_v2.pack_first_fit_v2(*mutate(args), n_max=8, **{"F": 2, "R": 3, **kw})


# -- the fused solve --------------------------------------------------------


class _View:
    def __init__(self, f):
        self.__dict__.update(f)


def jax_buffer_v2(f, n_max):
    tab, obc, bhh = jax_fused.pack_pod_table(_View(f))
    uniq = jax_fused.pad_uniq_req(f["uniq_req"])
    F, R = f["frontiers"].shape[1:]
    out = jax_fused.fused_solve_v2(
        tab, obc, bhh, uniq, f["front_j"], f["compat_j"], f["jvals"],
        np.asarray(f["frontiers"], np.float32), np.asarray(f["daemon"], np.float32),
        f["type_mask"], np.asarray(f["usable"], np.float32), n_max=n_max, F=F, R=R,
    )
    return np.asarray(jax.device_get(out))


@pytest.mark.parametrize("n_pods,n_types", [(512, 16), (2000, 64)])
def test_fused_v2_buffer_identical(interpret, n_pods, n_types):
    f = team_fields(n_pods, n_types)
    P, R = len(f["pod_valid"]), f["frontiers"].shape[2]
    n_max = min(P, 512)
    ref = jax_buffer_v2(f, n_max)
    F = f["frontiers"].shape[1]
    out = fused.fused_solve_v2(
        *carry.tensors_from_reference(f, "cpu")["fused_v2"], n_max=n_max, F=F, R=R
    ).numpy()
    assert ref.dtype == out.dtype == np.int32
    np.testing.assert_array_equal(ref, out)
    res, mask = fused.split_fused(out, P, n_max, R, n_types)
    assert int(res.n_nodes) == 64  # one node per team: 64 teams, under 110 pods each
    assert mask[: int(res.n_nodes)].any(axis=1).all()  # every open node keeps a type


def test_device_invariants_share_one_lru():
    inv = fused.DeviceInvariants("cpu")
    batches = [
        encode_scenario("karpenter_tpu_torch", *team_mix("karpenter_tpu_torch", 64, s, 16, k))
        for s, k in ((1, 8), (2, 9), (3, 10), (4, 11), (5, 12))
    ]
    first = inv.get_v2(batches[0])
    assert len(first) == 8 and first[0].shape[1] == 32  # pad8(F·R) rows
    assert torch.equal(first[7], pack_kernel_v2.signature_major(first[0]))  # front_s beside them
    assert inv.get_v2(batches[0]) is first  # resident
    inv.get(batches[0])
    for b in batches[1:]:
        inv.get(b)
    # four newer digests pushed batches[0] out of both caches at once
    assert not inv._cache_v2 and len(inv._cache) == inv.MAX_ENTRIES


# -- the route gate ---------------------------------------------------------


@pytest.mark.parametrize(
    "shape,route,table_bytes",
    [
        ((5, 1, 3, 5), "v1", None),  # headline: instance_types(400) x diverse_pods(10k)
        ((65, 16, 2, 64), "v2", None),  # 512 pods x tradeoff(16) x 64 teams
        ((65, 64, 2, 64), "v2", None),  # 10k pods x tradeoff(64)
        ((65, 400, 2, 64), "v2", 26_738_688),  # 10k pods x tradeoff(400): full width
        ((257, 400, 2, 256), "v1", 320_864_256),  # 256 teams: tables past the budget
        ((64, 16, 2, 64), "v1", None),  # S·F = 1024 stays within the v1 budget
    ],
)
def test_route_gate_on_shapes(shape, route, table_bytes):
    assert pack_kernel_v2.fused_route(*shape) == route
    if table_bytes is not None:
        assert pack_kernel_v2.v2_table_bytes(*shape) == table_bytes


def test_scheduler_route_follows_encoded_shapes():
    from karpenter_tpu_torch.solver.backend import TorchScheduler

    pkg = "karpenter_tpu_torch"
    teams = encode_scenario(pkg, *team_mix(pkg, 512, 9, 16))
    diverse = encode_scenario(pkg, *scenario(pkg, "diverse", 300, 5, 400))
    assert TorchScheduler._fused_route(teams) == "v2"
    assert TorchScheduler._fused_route(diverse) == "v1"


# -- the whole slice --------------------------------------------------------


def plan_of(nodes, pods):
    index = {id(p): i for i, p in enumerate(pods)}
    return [
        (
            [index[id(p)] for p in n.pods],
            [it.name for it in n.instance_type_options],
            dict(n.requests),
            [(r.key, r.operator, tuple(r.values)) for r in n.constraints.requirements.requirements],
            [(k, vs.complement, sorted(vs.values)) for k, vs in n.constraints.requirements._sets],
        )
        for n in nodes
    ]


def solve(pkg, n_pods, n_types):
    prov, catalog, pods = team_mix(pkg, n_pods, 9, n_types)
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
    return plan_of(nodes, pods), sched.last_stage_profile()


@pytest.mark.parametrize("n_pods,n_types,n_max_first", [(512, 16, 512), (2000, 64, 512), (512, 16, 32)])
def test_team_mix_plan_identical_to_jax_scheduler(monkeypatch, n_pods, n_types, n_max_first):
    from karpenter_tpu_torch.solver import backend

    monkeypatch.setattr(backend, "N_MAX_FIRST", n_max_first)
    ref, _ = solve("karpenter_tpu", n_pods, n_types)
    out, prof = solve("karpenter_tpu_torch", n_pods, n_types)
    assert len(out) == len(ref) > 0
    for i, (a, b) in enumerate(zip(ref, out)):
        assert a == b, f"node {i} differs"
    assert prof["packer_backend"] == "pack_v2_reference" and prof["pack_route"] == "fused"
    # a 32-slot first table saturates and the retry at P re-derives v2
    assert prof["pack_dispatches"] == (2 if n_max_first < len(out) else 1)
