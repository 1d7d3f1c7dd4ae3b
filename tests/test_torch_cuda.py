"""Card-only tests of the PyTorch port: the CUDA kernels against their plain
versions, and the port's cuda paths (single solve on both routes,
multi-solve) against its cpu paths, and the degrade ladder on the card,
which raises where a cpu scheduler serves its FFD floor (both kernels
failing, the canary over a full-width kernel result, a NaN in the fetched
buffer); the sidecar on the card, its coalesced stream groups (one launch
each, byte-equal to ``solve_bytes`` and to the plain version, the next
kernel when the first raises) and arena solves, and two threads on one
card scheduler; and the observability plane on the card (a traced round's
one launch and its stage spans, the session HBM gauges, the sidecar's
spans, the decision replay blob through the kernel ladder). Every
comparison is exact.

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
from torch_parity import (  # noqa: F401
    encode_scenario, fields, fresh_router, scenario, synth_fields, team_mix, with_v2_tables,
)

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
def test_scheduler_cuda_plan_matches_cpu(cuda, monkeypatch, name, n_pods, n_types, dispatches, kernel):
    from karpenter_tpu_torch.kube.client import Cluster
    from karpenter_tpu_torch.scheduling.scheduler import Scheduler

    # the default packer: the cpu solve is its router's cold start (the
    # device path), and on the card auto is the device path
    monkeypatch.delenv("KARPENTER_PACKER", raising=False)

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


# -- the redesigned kernels' edges: lanes per slot, one barrier per pod -----


def walk_fields(P, S, F, R, C, seed, n_hosts=0):
    """A synthetic problem whose nodes walk long frontiers: every row of a
    signature is small except one large row at a random index (the last
    row for a third of the signatures, the first for a sixth), so a node
    past its first few pods fits only that row; a tenth of the signatures
    have only PAD rows."""
    f = synth_fields(P=P, S=S, F=F, R=R, C=C, n_hosts=max(n_hosts, 1), seed=seed)
    rng = np.random.default_rng(seed + 1000)
    frontiers = rng.uniform(0.5, 1.5, (S, F, R)).astype(np.float32)
    big = rng.integers(0, F, S)
    big[: S // 3] = F - 1
    big[S // 3 : S // 2] = 0
    frontiers[np.arange(S), big] = rng.uniform(6.0, 9.0, (S, R))
    frontiers[rng.random(S) < 0.1] = -1.0
    f["frontiers"] = frontiers
    if not n_hosts:
        f["pod_host"] = np.full(P, -1, np.int32)
        f["pod_open_host"] = np.full(P, -1, np.int32)
    return with_v2_tables(f, "karpenter_tpu_torch")


def both_kernels(f, dev, n_max, plan=None):
    """(plain, kernel) results of v1 and v2 on one problem: [(ref, out), ...]."""
    F, R = f["frontiers"].shape[1:]
    v1 = pack_kernel.pack_first_fit(
        *carry.tensors_from_reference(f, dev)["pack_args"], n_max=n_max, plan=plan)
    v2 = pack_kernel_v2.pack_first_fit_v2(*v2_args(f, dev), n_max=n_max, F=F, R=R, plan=plan)
    torch.cuda.synchronize()
    ref1 = pack_reference(*carry.tensors_from_reference(f, "cpu")["pack_args"], n_max=n_max)
    ref2 = pack_v2_reference(*v2_args(f, "cpu"), n_max=n_max, F=F, R=R)
    return [(ref1, v1), (ref2, v2)]


@pytest.mark.parametrize("F", [1, 31, 32, 33, 400])
def test_split_walk_matches_reference(cuda, F):
    # a stride partial (31), exactly full (32), one past full (33), 13 strides (400)
    f = walk_fields(P=1024, S=24, F=F, R=2, C=6, seed=F, n_hosts=7)
    assert pack_kernel.launch_plan(F, 2, 256).G == min(32, 1 << (F - 1).bit_length())
    for ref, out in both_kernels(f, cuda, 256):
        assert_same(ref, out)
        assert int(out.n_nodes) > 8


def _fields(valid, core, req, join, frontiers, host=None, hib=None):
    """A problem in carry's field form from its arrays (no daemon)."""
    P, R = req.shape
    host = np.full(P, -1, np.int32) if host is None else host.astype(np.int32)
    hib = np.ones(P, bool) if hib is None else hib
    uniq, req_id = np.unique(req, axis=0, return_inverse=True)
    open_sig_by_core = np.zeros(join.shape[1], np.int32)
    return with_v2_tables(dict(
        pod_valid=valid, pod_open_sig=open_sig_by_core[core], pod_core=core.astype(np.int32),
        pod_host=host, pod_host_in_base=hib,
        pod_open_host=np.where(host >= 0, np.where(hib, host, -2), -1).astype(np.int32),
        pod_req=req.astype(np.float32), join_table=join.astype(np.int32),
        frontiers=frontiers.astype(np.float32), daemon=np.zeros(R, np.float32),
        usable=np.full((8, R), 100.0, np.float32), type_mask=np.ones((join.shape[0], 8), bool),
        pod_req_id=req_id.reshape(-1).astype(np.int32), uniq_req=uniq.astype(np.float32),
        open_sig_by_core=open_sig_by_core, base_has_hostname=False,
    ), "karpenter_tpu_torch")


@pytest.mark.parametrize("F", [1, 33])
def test_tie_between_groups_goes_to_the_lowest_slot(cuda, F):
    # 40 large pods open 40 nodes; then every node fits the next small pod
    # at the same step (at F = 33 only in its last row), so every group
    # finds its first slot at once and the lowest slot must win
    frontiers = np.full((1, F, 1), 0.1)
    frontiers[0, F - 1, 0] = 10.0
    req = np.concatenate([np.full(40, 6.0), np.full(200, 0.5)])[:, None]
    f = _fields(np.ones(240, bool), np.zeros(240, np.int32), req, np.zeros((1, 1)), frontiers)
    for plan in (None, pack_kernel.launch_plan(F, 1, 64, threads=256)):
        for ref, out in both_kernels(f, cuda, 64, plan):
            assert_same(ref, out)
            a = out.assignment.cpu().numpy()
            assert (a[:40] == np.arange(40)).all() and a[40] == 0
            assert (a[40:48] == 0).all() and a[48] == 1  # node 0 fills at 6 + 8 x 0.5


def test_invalid_pods_between_valid_ones(cuda):
    f = walk_fields(P=768, S=16, F=33, R=3, C=5, seed=3, n_hosts=5)
    f["pod_valid"] = (np.arange(768) % 3 != 1) & (np.arange(768) % 7 != 0)
    for ref, out in both_kernels(f, cuda, 512):
        assert_same(ref, out)
        assert (out.assignment.cpu().numpy()[1::3] == -1).all()


@pytest.mark.parametrize("F,threads", [(33, 64), (1, 32), (8, 32)])
def test_count_crosses_group_multiples(cuda, F, threads):
    # few groups (2, 32 and 4), many nodes: the open count passes every
    # multiple of the group count and each group owns many slots
    f = walk_fields(P=2048, S=30, F=F, R=2, C=12, seed=21, n_hosts=40)
    plan = pack_kernel.launch_plan(F, 2, 512, threads=threads)
    for ref, out in both_kernels(f, cuda, 512, plan):
        assert_same(ref, out)
        assert int(out.n_nodes) > 4 * (threads // plan.G)


@pytest.mark.parametrize("F", [1, 33])
def test_node_state_in_device_memory(cuda, F):
    f = walk_fields(P=2048, S=20, F=F, R=4, C=8, seed=5, n_hosts=200)
    P = len(f["pod_valid"])
    smem = pack_kernel.launch_plan(F, 4, P)
    assert smem.node_state_in_smem  # 2048 slots fit beside the staging
    stage = smem.smem_bytes - P * (2 + 4) * 4
    forced = smem._replace(node_state_in_smem=False, smem_bytes=stage)
    results = [both_kernels(f, cuda, P, plan) for plan in (smem, forced)]
    for (ref, a), (_, b) in zip(*results):
        assert_same(ref, a)
        assert_same(ref, b)


def test_node_state_in_device_memory_at_full_size(cuda):
    # n_max = P = 10,240 at R = 4: the node table cannot take shared memory
    f = walk_fields(P=10_240, S=12, F=1, R=4, C=4, seed=9, n_hosts=3000)
    plan = pack_kernel.launch_plan(1, 4, 10_240)
    assert not plan.node_state_in_smem
    ref = pack_reference(*carry.tensors_from_reference(f, "cpu")["pack_args"], n_max=10_240)
    out = pack_kernel.pack_first_fit(*carry.tensors_from_reference(f, cuda)["pack_args"], n_max=10_240)
    assert_same(ref, out)
    assert int(out.n_nodes) > 1000


@pytest.mark.parametrize("F", [1, 33])
def test_three_problems_in_one_launch(cuda, F):
    fs = [walk_fields(P=512, S=16, F=F, R=2, C=4, seed=s, n_hosts=9) for s in (1, 2, 3)]
    v1 = tuple(torch.stack(c) for c in zip(
        *(carry.tensors_from_reference(f, cuda)["pack_args"] for f in fs)))
    v2 = tuple(torch.stack(c) for c in zip(*(v2_args(f, cuda) for f in fs)))
    before = pack_kernel.launches, pack_kernel_v2.launches
    out1 = pack_kernel.pack_first_fit(*v1, n_max=128)
    out2 = pack_kernel_v2.pack_first_fit_v2(*v2, n_max=128, F=F, R=2)
    torch.cuda.synchronize()
    assert (pack_kernel.launches, pack_kernel_v2.launches) == (before[0] + 1, before[1] + 1)
    for b, f in enumerate(fs):
        ref1 = pack_reference(*carry.tensors_from_reference(f, "cpu")["pack_args"], n_max=128)
        ref2 = pack_v2_reference(*v2_args(f, "cpu"), n_max=128, F=F, R=2)
        assert_same(ref1, PackResult(*(x[b] for x in out1)))
        assert_same(ref2, PackResult(*(x[b] for x in out2)))


def residency_batches(n_pods=300, seed=11):
    """Two encoded team-mix batches: the second swaps the input's last pod
    for one with its cpu request and another team, which keeps its sorted
    position and changes one column of the pod table."""
    from karpenter_tpu_torch.testing import make_pod

    pkg = "karpenter_tpu_torch"
    prov, catalog, pods = team_mix(pkg, n_pods, seed, 16)
    last = pods[-1]
    team = last.spec.node_selector["team"]
    other = next(p.spec.node_selector["team"] for p in pods if p.spec.node_selector["team"] != team)
    swap = make_pod(requests={"cpu": str(last.spec.containers[0].requests["cpu"])},
                    node_selector={"team": other})
    return (encode_scenario(pkg, prov, catalog, pods),
            encode_scenario(pkg, prov, catalog, pods[:-1] + [swap]))


def test_pod_residency_patches_in_place_on_card(cuda):
    b1, b2 = residency_batches()
    t1, t2 = fused.pack_pod_table(b1)[0], fused.pack_pod_table(b2)[0]
    assert t1.shape == t2.shape and int((t1 != t2).any(axis=0).sum()) == 1
    res = fused.PodResidency(cuda)
    devs1 = res.get(b1)
    ptr = devs1[0].data_ptr()
    uploads = []
    real = res._upload
    res._upload = lambda a: uploads.append(a.shape) or real(a)
    assert res.get(b1) is devs1 and uploads == []  # reuse: no host-to-device copy
    devs2 = res.get(b2)
    torch.cuda.synchronize()
    assert res.stats == {"reused": 1, "patched": 1, "uploaded": 1}
    assert devs2[0] is devs1[0] and devs2[0].data_ptr() == ptr  # patched in place
    assert len(uploads) == 2  # the column index and the one changed column
    fresh = fused.PodResidency(cuda).get(b2)
    for got, want in zip(devs2, fresh):
        assert got.device.type == "cuda"
        assert torch.equal(got, want)


@pytest.mark.parametrize("name,n_pods,n_types", [("diverse", 700, 50), ("teams", 2000, 64)])
def test_resident_steady_state_on_card_matches_cpu(cuda, monkeypatch, name, n_pods, n_types):
    from karpenter_tpu_torch.kube.client import Cluster
    from karpenter_tpu_torch.scheduling.scheduler import Scheduler

    prov, catalog, pods = scenario("karpenter_tpu_torch", name, n_pods, 42, n_types)
    index = {id(p): i for i, p in enumerate(pods)}
    plans, keys = {}, {}
    for device in ("cpu", "cuda"):
        # three rounds: the cpu twin pins the device path (its router would
        # send round 2 to native); the card runs the default
        if device == "cpu":
            monkeypatch.setenv("KARPENTER_PACKER", "fused")
        else:
            monkeypatch.delenv("KARPENTER_PACKER", raising=False)
        sched = Scheduler(Cluster(), rng=random.Random(1), device=device, solver_delta=True)
        plans[device], keys[device] = [], []
        for _ in range(3):
            nodes = sched.solve(prov, catalog, pods)
            plans[device].append([
                ([index[id(p)] for p in n.pods], [it.name for it in n.instance_type_options],
                 n.requests, n.constraints.requirements.requirements)
                for n in nodes
            ])
            keys[device].append(sorted(k for k in sched.last_stage_profile() if k.endswith("_s")))
        if device == "cuda":
            assert sched.torch._pod_residency.stats == {"reused": 2, "patched": 0, "uploaded": 1}
    assert plans["cpu"] == plans["cuda"]
    assert keys["cpu"] == keys["cuda"]
    assert "encode_delta_s" in keys["cuda"][2] and "sort_delta_s" in keys["cuda"][2]


# -- the unfused ladder (pack_kernel.pack_best) on the card -----------------


def _high_hosts(f, base=32_768):
    """``f`` with every pinned hostname id moved past int16."""
    f = dict(f)
    for k in ("pod_host", "pod_open_host"):
        f[k] = np.where(f[k] >= 0, f[k] + base, f[k]).astype(np.int32)
    return f


LADDER_CASES = {
    # P % 128 == 0 and S·F <= 1024: the v1 rung
    "v1": (lambda: synth_fields(P=1024, S=12, F=3, R=4, C=6, n_hosts=9, seed=5), "pack_first_fit"),
    # S·F past the v1 budget, tables within the card's: the v2 rung
    "v2": (lambda: synth_fields(P=1024, S=300, F=8, R=3, C=16, n_hosts=40, seed=6),
           "pack_first_fit_v2"),
    "v1_hosts_past_int16": (
        lambda: _high_hosts(synth_fields(P=2048, S=12, F=3, R=4, C=6, n_hosts=900, seed=7)),
        "pack_first_fit"),
    "v2_hosts_past_int16": (
        lambda: _high_hosts(synth_fields(P=2048, S=300, F=8, R=3, C=16, n_hosts=900, seed=8)),
        "pack_first_fit_v2"),
}


@pytest.mark.parametrize("case", sorted(LADDER_CASES))
def test_pack_best_on_card_matches_plain(cuda, case):
    make, want = LADDER_CASES[case]
    f = make()
    module = pack_kernel_v2 if want == "pack_first_fit_v2" else pack_kernel
    before = module.launches
    served, out = pack_kernel.pack_best(*carry.tensors_from_reference(f, cuda)["pack_args"], n_max=256)
    torch.cuda.synchronize()
    assert served == want and module.launches == before + 1
    assert_same(pack_reference(*carry.tensors_from_reference(f, "cpu")["pack_args"], n_max=256), out)


def test_v1_failure_takes_v2_and_is_memoized(cuda, monkeypatch):
    f = synth_fields(P=1024, S=12, F=3, R=4, C=6, n_hosts=9, seed=5)
    args = carry.tensors_from_reference(f, cuda)["pack_args"]
    calls = []

    def broken(*a, **kw):
        calls.append(1)
        raise RuntimeError("v1 launch failed (test)")

    monkeypatch.setattr(pack_kernel, "pack_first_fit", broken)
    for _ in range(2):
        served, out = pack_kernel.pack_best(*args, n_max=128)
        assert served == "pack_first_fit_v2"
        assert_same(pack_reference(*carry.tensors_from_reference(f, "cpu")["pack_args"], n_max=128), out)
    assert len(calls) == 1  # the memo skips v1 for this shape from then on
    assert (1024, 128) in pack_kernel._failed_shapes


def test_both_kernels_failing_raises(cuda, monkeypatch):
    from karpenter_tpu_torch.solver import native

    def broken(*a, **kw):
        raise RuntimeError("launch failed (test)")

    def never(*a, **kw):
        raise AssertionError("the ladder fell back off the card")

    monkeypatch.setattr(pack_kernel, "pack_first_fit", broken)
    monkeypatch.setattr(pack_kernel_v2, "pack_first_fit_v2", broken)
    monkeypatch.setattr(pack_kernel, "pack_reference", never)
    monkeypatch.setattr(native, "pack_native", never)
    f = synth_fields(P=1024, S=12, F=3, R=4, C=6, n_hosts=9, seed=5)
    with pytest.raises(RuntimeError, match="no kernel served"):
        pack_kernel.pack_best(*carry.tensors_from_reference(f, cuda)["pack_args"], n_max=128)
    assert {(1024, 128), ("v2", 1024, 128)} <= pack_kernel._failed_shapes


def test_pallas_round_equals_fused_round(cuda, monkeypatch):
    from karpenter_tpu_torch.kube.client import Cluster
    from karpenter_tpu_torch.scheduling.scheduler import Scheduler

    prov, catalog, pods = scenario("karpenter_tpu_torch", "diverse", 700, 42, 50)
    index = {id(p): i for i, p in enumerate(pods)}
    plans = {}
    for value in ("fused", "pallas"):
        monkeypatch.setenv("KARPENTER_PACKER", value)
        sched = Scheduler(Cluster(), rng=random.Random(1))
        before = pack_kernel.launches
        nodes = sched.solve(prov, catalog, pods)
        prof = sched.last_stage_profile()
        assert pack_kernel.launches == before + 1
        assert prof["packer_backend"] == "pack_first_fit"
        assert prof["pack_route"] == ("unfused" if value == "pallas" else "fused")
        plans[value] = [
            ([index[id(p)] for p in n.pods], [it.name for it in n.instance_type_options],
             n.requests, n.constraints.requirements.requirements)
            for n in nodes
        ]
    assert plans["fused"] == plans["pallas"]


def test_auto_on_card_never_consults_the_router(cuda, monkeypatch):
    from karpenter_tpu_torch.kube.client import Cluster
    from karpenter_tpu_torch.scheduling.scheduler import Scheduler
    from karpenter_tpu_torch.solver import native

    monkeypatch.delenv("KARPENTER_PACKER", raising=False)
    native.native_available(wait=180)  # built: native would be a candidate
    prov, catalog, pods = scenario("karpenter_tpu_torch", "diverse", 700, 42, 50)
    sched = Scheduler(Cluster(), rng=random.Random(1))
    calls = native.calls
    for r in range(3):
        before = pack_kernel.launches
        sched.solve(prov, catalog, pods)
        prof = sched.last_stage_profile()
        assert pack_kernel.launches == before + 1, r
        assert (prof["packer_backend"], prof["pack_route"]) == ("pack_first_fit", "fused"), r
    assert sched.torch.router.report() == {} and native.calls == calls
    assert sched.torch._probe_thread is None


# -- the degrade ladder on the card ---------------------------------------------


def _break_both_kernels(monkeypatch):
    """Both kernels raise wherever the card's paths call them (the fused
    route imports pack_first_fit by name); returns the list of calls."""
    calls = []

    def broken(*a, **kw):
        calls.append(1)
        raise RuntimeError("kernel launch failed (test)")

    monkeypatch.setattr(fused, "pack_first_fit", broken)
    monkeypatch.setattr(pack_kernel, "pack_first_fit", broken)
    monkeypatch.setattr(pack_kernel_v2, "pack_first_fit_v2", broken)
    return calls


def test_both_kernels_failing_raise_then_the_breaker_opens(cuda, monkeypatch):
    from karpenter_tpu_torch.kube.client import Cluster
    from karpenter_tpu_torch.resilience import BreakerOpen
    from karpenter_tpu_torch.scheduling.scheduler import Scheduler
    from karpenter_tpu_torch.solver import integrity

    monkeypatch.delenv("KARPENTER_PACKER", raising=False)
    prov, catalog, pods = scenario("karpenter_tpu_torch", "diverse", 700, 42, 50)
    calls = _break_both_kernels(monkeypatch)
    sched = Scheduler(Cluster(), rng=random.Random(1))
    launches = (pack_kernel.launches, pack_kernel_v2.launches)
    seen = []
    for r in range(2):
        with pytest.raises(RuntimeError, match="no kernel served"):
            sched.solve(prov, catalog, pods)
        seen.append(len(calls))
    with pytest.raises(BreakerOpen, match="pack:"):
        sched.solve(prov, catalog, pods)
    seen.append(len(calls))
    # round 1: the fused v1 dispatch at n_max 512, then the ladder's v1 and
    # v2 at the same 512 slots; round 2: the failed-fused memo sends the
    # shape to the ladder at once, which starts at max(256, P // 4) = 256
    # slots, a table its own memo has not seen, so v1 and v2 are tried
    # again; round 3: the breaker is open and nothing is called
    assert seen == [3, 5, 5]
    assert (pack_kernel.launches, pack_kernel_v2.launches) == launches
    (key,) = sched.torch._pack_breakers.open_dependencies()
    assert key.startswith("pack:")
    assert integrity.totals()["quarantines"] == 0


@pytest.mark.parametrize("name", ["headline", "team mix"])
def test_canary_holds_a_full_width_kernel_result(cuda, monkeypatch, name):
    from karpenter_tpu_torch.cloudprovider.fake import instance_types, instance_types_tradeoff
    from karpenter_tpu_torch.kube.client import Cluster
    from karpenter_tpu_torch.scheduling.scheduler import Scheduler
    from karpenter_tpu_torch.solver import integrity, native
    from karpenter_tpu_torch.testing import diverse_pods, make_pod, make_provisioner

    monkeypatch.delenv("KARPENTER_PACKER", raising=False)
    assert native.native_available(wait=180)
    if name == "headline":
        catalog, pods = instance_types(400), diverse_pods(10000, random.Random(42))
    else:
        rng = random.Random(9)
        catalog = instance_types_tradeoff(400)
        pods = [make_pod(requests={"cpu": f"{rng.choice([0.25, 0.5, 1])}"},
                         node_selector={"team": f"t{i % 64}"}) for i in range(10000)]
    sched = Scheduler(Cluster(), rng=random.Random(1), canary_rate=0.0)
    served = []
    real = sched.torch._pack

    def keep(batch, prof):
        finish = real(batch, prof)

        def done():
            out = finish()
            served.append((batch, out[0]))
            return out
        return done

    sched.torch._pack = keep
    sched.solve(make_provisioner(solver="tpu"), catalog, pods)
    kernel = "pack_first_fit" if name == "headline" else "pack_first_fit_v2"
    assert sched.last_stage_profile()["packer_backend"] == kernel
    (batch, result), = served
    sched.torch._canary_check(batch, result)
    totals = integrity.totals()
    assert totals["canary_solves"] == 1 and totals["canary_mismatches"] == 0
    assert totals["quarantines"] == 0 and not sched.torch._pack_breakers.open_dependencies()


def test_nan_in_the_fetched_buffer_is_screened_and_quarantined(cuda, monkeypatch):
    from karpenter_tpu_torch.kube.client import Cluster
    from karpenter_tpu_torch.resilience import BreakerOpen
    from karpenter_tpu_torch.scheduling.scheduler import Scheduler
    from karpenter_tpu_torch.solver import integrity
    from karpenter_tpu_torch.solver.backend import InvalidPackError

    monkeypatch.delenv("KARPENTER_PACKER", raising=False)
    prov, catalog, pods = scenario("karpenter_tpu_torch", "diverse", 700, 42, 50)
    real = fused.split_fused

    def nan_in_buffer(*a, **kw):
        result, typemask = real(*a, **kw)
        result.node_req[0, 0] = np.nan  # a view into the fetched host buffer
        return result, typemask

    monkeypatch.setattr(fused, "split_fused", nan_in_buffer)
    cluster = Cluster()
    sched = Scheduler(cluster, rng=random.Random(1))
    before = pack_kernel.launches
    with pytest.raises(InvalidPackError, match="failed the integrity screen"):
        sched.solve(prov, catalog, pods)
    assert pack_kernel.launches == before + 1  # the kernel ran; its result was refused
    assert sched.last_stage_profile()["packer_backend"] == "pack_first_fit"
    totals = integrity.totals()
    assert totals["screen_failures"] == 1 and totals["quarantines"] == 1
    assert len(sched.torch._pack_breakers.open_dependencies()) == 1
    (event,) = cluster.list("events")
    assert (event.type, event.reason) == ("Warning", "IntegrityQuarantine")
    assert "node_req contains non-finite values" in event.message
    # the quarantined shape's next round meets the open breaker: no launch
    with pytest.raises(BreakerOpen):
        sched.solve(prov, catalog, pods)
    assert pack_kernel.launches == before + 1


# -- the solver sidecar on the card ------------------------------------------


def sidecar_frames(name, n_pods, n_types):
    """(open frame, pack frame, key, pack_args) of a port-encoded batch, at
    the node table the backend sends a sidecar."""
    from karpenter_tpu_torch.solver import service as S

    pkg = "karpenter_tpu_torch"
    batch = encode_scenario(pkg, *scenario(pkg, name, n_pods, 42, n_types))
    args = [np.ascontiguousarray(a) for a in batch.pack_args()]
    key = S.catalog_session_key(*args[7:])
    n_max = max(256, len(args[0]) // 4)
    key_arr = np.frombuffer(key, np.int32)
    return (S.pack_arrays([key_arr] + args[7:]),
            S.pack_arrays([key_arr, np.asarray([n_max, 1], np.int32)] + args[:7]),
            key, args, n_max)


def test_sidecar_pins_session_tensors_on_card(cuda):
    from karpenter_tpu_torch.solver import service as S

    open_frame, _, key, args, _ = sidecar_frames("diverse", 700, 50)
    svc = S.SolverService()
    assert int(S.unpack_arrays(svc.open_session_bytes(open_frame))[0][0]) == S.STATUS_OK
    tensors = svc.session_tensors(key)
    assert all(t.device.type == "cuda" for t in tensors)
    assert svc.resident_bytes() == sum(a.nbytes for a in args[7:])


@pytest.mark.parametrize("name,n_pods,n_types,want", [
    ("diverse", 700, 50, "pack_first_fit"), ("teams", 2000, 64, "pack_first_fit_v2")])
def test_sidecar_serves_through_a_kernel(cuda, name, n_pods, n_types, want):
    from karpenter_tpu_torch.solver import backend, kernel
    from karpenter_tpu_torch.solver import service as S

    open_frame, frame, _, args, n_max = sidecar_frames(name, n_pods, n_types)
    on_card, on_cpu = S.SolverService(), S.SolverService(device="cpu")
    responses = []
    for svc in (on_card, on_cpu):
        svc.open_session_bytes(open_frame)
        responses.append(svc.solve_bytes(frame))
    assert on_card.served == {want: 1}
    gpu = [torch.tensor(a, dtype=dt, device=cuda) for a, (_, dt) in
           zip(args, carry.PACK_ARG_DTYPES)]
    served, result = backend.pack_unfused(*gpu, n_max=n_max)
    assert served == want
    buf = S.unpack_arrays(responses[0])[1]
    assert buf.tobytes() == kernel.fuse_result(result).cpu().numpy().tobytes()
    assert responses[0] == responses[1]


def test_two_concurrent_sidecar_packs_equal_sequential(cuda):
    from concurrent.futures import ThreadPoolExecutor

    from karpenter_tpu_torch.solver import service as S

    cases = [sidecar_frames("diverse", 700, 50), sidecar_frames("teams", 2000, 64)]
    svc = S.SolverService()
    for open_frame, *_ in cases:
        svc.open_session_bytes(open_frame)
    sequential = [svc.solve_bytes(frame) for _, frame, *_ in cases]
    with ThreadPoolExecutor(max_workers=2) as pool:
        for _ in range(3):
            futures = [pool.submit(svc.solve_bytes, frame) for _, frame, *_ in cases]
            assert [f.result(timeout=120) for f in futures] == sequential
    assert svc.served == {"pack_first_fit": 4, "pack_first_fit_v2": 4}


def test_sidecar_warmup_ready_only_after_a_kernel_served(cuda, monkeypatch):
    from karpenter_tpu_torch.solver import service as S

    svc = S.SolverService()
    svc.warmup()
    assert svc.ready.is_set() and set(svc.served) <= {"pack_first_fit", "pack_first_fit_v2"}
    monkeypatch.setenv("KARPENTER_PACKER", "native")
    native_only = S.SolverService()
    native_only.warmup()
    assert native_only.served == {"native": 1} and not native_only.ready.is_set()
    assert native_only.health_bytes(b"") == S.NOT_SERVING


def test_publish_device_headroom_is_an_int(cuda):
    from karpenter_tpu_torch.solver import service as S

    headroom = S.publish_device_headroom(cuda)
    assert isinstance(headroom, int) and 0 < headroom <= torch.cuda.mem_get_info(cuda)[1]


# -- the persistent stream on the card ---------------------------------------


def distinct_frames(frame_args, key, n_max, n, seed=5):
    """``n`` Pack frames over one session whose pod arrays have equal shapes
    and different content: each clears ``pod_valid`` for a different seeded
    1% of its rows."""
    from karpenter_tpu_torch.solver import service as S

    rng = np.random.default_rng(seed)
    frames = []
    for _ in range(n):
        pods = [a.copy() for a in frame_args[:7]]
        pods[0][rng.choice(len(pods[0]), max(1, len(pods[0]) // 100), replace=False)] = False
        frames.append(S.pack_arrays(
            [np.frombuffer(key, np.int32), np.asarray([n_max, 1], np.int32)] + pods))
    return frames


@pytest.mark.parametrize("n", [2, 3, 8])
@pytest.mark.parametrize("name,n_pods,n_types,want", [
    ("diverse", 700, 50, "pack_first_fit"), ("teams", 2000, 64, "pack_first_fit_v2")])
def test_coalesced_group_is_one_launch(cuda, name, n_pods, n_types, want, n):
    from karpenter_tpu_torch.solver import kernel
    from karpenter_tpu_torch.solver import service as S

    open_frame, _, key, args, n_max = sidecar_frames(name, n_pods, n_types)
    svc = S.SolverService()
    svc.open_session_bytes(open_frame)
    frames = distinct_frames(args, key, n_max, n)
    unary = [svc.solve_bytes(f) for f in frames]
    assert len(set(unary)) > 1
    modules = {"pack_first_fit": pack_kernel, "pack_first_fit_v2": pack_kernel_v2}
    responses = {}
    entries = [svc.stream_parse_solve(f, respond=lambda b, i=i: responses.__setitem__(i, b))
               for i, f in enumerate(frames)]
    before = {k: m.launches for k, m in modules.items()}
    served = dict(svc.served)
    svc.solve_stream_group(entries)
    torch.cuda.synchronize()
    assert {k: m.launches - before[k] for k, m in modules.items()} == {
        k: int(k == want) for k in modules}
    assert svc.served[want] == served[want] + 1
    assert svc.stream_stats["coalesced_dispatches"] == 1
    assert svc.stream_stats["coalesced_solves"] == n
    assert [responses[i] for i in range(n)] == unary
    # each demultiplexed answer against the plain version on its own frame
    for i, f in enumerate(frames):
        pods = S.unpack_arrays(f)[2:9]
        host = [torch.tensor(a, dtype=dt) for a, (_, dt) in
                zip([*pods, *args[7:]], carry.PACK_ARG_DTYPES)]
        plain = kernel.fuse_result(pack_reference(*host, n_max=n_max)).numpy()
        assert S.unpack_arrays(responses[i])[1].tobytes() == plain.tobytes(), i


def test_coalesced_group_falls_to_the_next_kernel(cuda, monkeypatch):
    """A group whose first rung raises at its shape is served by the
    other kernel in one launch, the shape memoized as on a single solve."""
    from karpenter_tpu_torch.solver import service as S

    open_frame, _, key, args, n_max = sidecar_frames("diverse", 700, 50)
    svc = S.SolverService()
    svc.open_session_bytes(open_frame)
    frames = distinct_frames(args, key, n_max, 3)
    unary = [svc.solve_bytes(f) for f in frames]
    assert svc.served == {"pack_first_fit": 3}

    def broken(*a, **kw):
        raise RuntimeError("pack_first_fit launch failed (test)")

    monkeypatch.setattr(pack_kernel, "pack_first_fit", broken)
    responses = {}
    entries = [svc.stream_parse_solve(f, respond=lambda b, i=i: responses.__setitem__(i, b))
               for i, f in enumerate(frames)]
    before = pack_kernel_v2.launches
    svc.solve_stream_group(entries)
    assert pack_kernel_v2.launches == before + 1
    assert svc.served == {"pack_first_fit": 3, "pack_first_fit_v2": 1}
    P = len(args[0])
    assert (P, n_max) in pack_kernel._failed_shapes
    assert [responses[i] for i in range(3)] == unary


def test_arena_descriptor_solve_on_card(cuda, tmp_path):
    from karpenter_tpu_torch.solver import service as S
    from karpenter_tpu_torch.solver import stream as TS

    open_frame, frame, key, args, n_max = sidecar_frames("diverse", 700, 50)
    svc = S.SolverService()
    svc.open_session_bytes(open_frame)
    arena = TS.ShmArena(str(tmp_path), size=1 << 24)
    reader = TS.ShmArenaReader(arena.path)
    try:
        token, desc = arena.write(args[:7])
        shm_frame = S.pack_arrays(
            [np.frombuffer(key, np.int32), np.asarray([n_max, 1], np.int32), desc])
        got = []
        entry = svc.stream_parse_solve(shm_frame, respond=got.append, arena=reader)
        assert entry.shm
        svc.solve_stream_group([entry])
        assert got == [svc.solve_bytes(frame)]
        assert svc.served == {"pack_first_fit": 2}
        arena.free(token)
    finally:
        reader.close()
        arena.close()


def test_two_threads_on_one_card_scheduler_get_their_plans(cuda):
    """The solve lock on the card: two threads sharing one scheduler each
    get the plan they get alone."""
    import threading

    from karpenter_tpu_torch.kube.client import Cluster
    from karpenter_tpu_torch.scheduling.scheduler import Scheduler

    pkg = "karpenter_tpu_torch"
    cases = {"teams": scenario(pkg, "teams", 2000, 9, 64),
             "config2": scenario(pkg, "config2", 700, 42, 50)}
    sched = Scheduler(Cluster(), rng=random.Random(1))

    def plan(name):
        prov, catalog, pods = cases[name]
        nodes = sched.solve(prov, catalog, pods)
        return sorted(sorted(pods.index(p) for p in n.pods) for n in nodes)

    alone = {name: plan(name) for name in cases}
    for _ in range(3):
        got, errs = {}, []

        def run(name):
            try:
                got[name] = plan(name)
            except Exception as e:  # pragma: no cover - diagnostic
                errs.append(e)

        threads = [threading.Thread(target=run, args=(n,), daemon=True) for n in cases]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not errs and got == alone


# -- the observability plane on the card --------------------------------------


@pytest.fixture
def fresh_obs():
    from karpenter_tpu_torch import obs

    obs.reset_for_tests()
    yield obs
    obs.reset_for_tests()


@pytest.mark.parametrize("name,n_pods,n_types,kernel", [
    ("diverse", 700, 50, "pack_first_fit"), ("teams", 2000, 64, "pack_first_fit_v2")])
def test_traced_round_on_card_launches_once_and_agrees_with_the_profile(
        cuda, fresh_obs, name, n_pods, n_types, kernel):
    from karpenter_tpu_torch.kube.client import Cluster
    from karpenter_tpu_torch.scheduling.scheduler import Scheduler

    module = {"pack_first_fit": pack_kernel, "pack_first_fit_v2": pack_kernel_v2}[kernel]
    prov, catalog, pods = scenario("karpenter_tpu_torch", name, n_pods, 42, n_types)
    sched = Scheduler(Cluster(), rng=random.Random(1))
    sched.solve(prov, catalog, pods)
    fresh_obs.exporter().clear()
    before = module.launches
    sched.torch.topology.rng = random.Random(1)
    sched.solve(prov, catalog, pods)
    assert module.launches == before + 1
    prof = sched.last_stage_profile()
    assert prof["packer_backend"] == kernel
    (tree,) = fresh_obs.exporter().trees()
    stages = {c["name"]: c["duration_ms"] for c in tree["children"]}
    assert list(stages) == ["solve.sort", "solve.inject", "solve.encode", "solve.pack_begin",
                            "solve.pack_fetch", "solve.decode"]
    for span, key in [("solve.sort", "sort_s"), ("solve.inject", "inject_s"),
                      ("solve.encode", "encode_s"), ("solve.decode", "decode_s")]:
        assert abs(stages[span] - prof[key] * 1e3) < 1.0
    assert abs(stages["solve.pack_begin"] + stages["solve.pack_fetch"]
               - prof["pack_fetch_s"] * 1e3) < 1.0
    ctx = sched.last_decision_context()
    assert ctx["route"] == kernel and isinstance(ctx["assignment"], np.ndarray)


def test_session_open_on_card_sets_the_hbm_gauges(cuda):
    from karpenter_tpu_torch import metrics
    from karpenter_tpu_torch.solver import service as S

    open_frame, _, key, args, _ = sidecar_frames("diverse", 700, 50)
    svc = S.SolverService()
    svc.open_session_bytes(open_frame)
    free = torch.cuda.mem_get_info(cuda)[0]
    index = str(torch.cuda.current_device())
    headroom = metrics.REGISTRY.get_sample_value(
        "karpenter_solver_device_hbm_headroom_bytes", {"device": index})
    assert abs(headroom - free) <= 64 * 2**20
    assert metrics.REGISTRY.get_sample_value(
        "karpenter_solver_session_hbm_bytes", {"session": key.hex()[:12]}) == svc.resident_bytes()


def test_traced_sidecar_solve_on_card_records_its_spans(cuda, fresh_obs):
    from karpenter_tpu_torch.solver import service as S

    open_frame, frame, _, _, _ = sidecar_frames("diverse", 700, 50)
    svc = S.SolverService()
    svc.open_session_bytes(open_frame)
    ctx = fresh_obs.SpanContext("ab" * 16, "cd" * 8)
    before = pack_kernel.launches
    traced = S.unpack_arrays(frame)
    response = svc.solve_bytes(S.pack_arrays(traced + [S._trace_ctx_array(ctx)]))
    assert pack_kernel.launches == before + 1
    assert S.unpack_arrays(response)[1].tobytes() == S.unpack_arrays(svc.solve_bytes(frame))[1].tobytes()
    (pack,) = [t for t in fresh_obs.exporter().trees() if t["name"] == "sidecar.pack"]
    assert (pack["trace_id"], pack["parent_id"]) == (ctx.trace_id, ctx.span_id)
    assert [c["name"] for c in pack["children"]] == [
        "sidecar.solve", "sidecar.fetch", "sidecar.serialize"]


def test_replay_blob_through_pack_best_on_card_is_bit_exact(cuda, fresh_obs, tmp_path):
    from karpenter_tpu_torch.kube.client import Cluster
    from karpenter_tpu_torch.obs import replay
    from karpenter_tpu_torch.scheduling.scheduler import Scheduler
    from karpenter_tpu_torch.testing import make_pod

    prov, catalog, pods = scenario("karpenter_tpu_torch", "diverse", 700, 42, 50)
    pods = pods + [make_pod(name=f"stuck-{i}", requests={"cpu": "100000"}) for i in range(3)]
    sched = Scheduler(Cluster(), rng=random.Random(1))
    nodes = sched.solve(prov, catalog, pods)
    log = fresh_obs.configure_decisions(directory=str(tmp_path), write_interval=0.0)
    rec = log.record_round(prov.name, pods, nodes, context=sched.last_decision_context())
    assert log.flush(30.0)
    stuck = [v for v in rec["unschedulable"] if v["pod"].rpartition("/")[2].startswith("stuck-")]
    assert len(stuck) == 3 and {v["top_reason"] for v in stuck} == {"resource_fit"}
    path = replay.find_record(str(tmp_path))
    record = replay.load_record(path)
    with np.load(tmp_path / record["replay_file"], allow_pickle=False) as z:
        blob = {k: z[k] for k in z.files}
    blob["pod_req"] = blob["uniq_req"][blob["pod_req_id"]]
    args = [torch.tensor(blob[n], dtype=dt, device=cuda) for n, dt in carry.PACK_ARG_DTYPES]
    before = pack_kernel.launches
    served, result = pack_kernel.pack_best(*args, n_max=int(blob["n_max"]))
    assert served == "pack_first_fit" and pack_kernel.launches == before + 1
    n = int(blob["n_pods"])
    np.testing.assert_array_equal(result.assignment.cpu().numpy()[:n], blob["assignment"][:n])
    assert replay.replay(record, record_path=path)["ok"] is True
