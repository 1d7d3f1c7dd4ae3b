"""The host side of the first-fit kernels' launch, which the CPU reaches:
the launch plan both wrappers share, the build directory's key, and the
signature-major copy of ``front_j`` that ``pack_first_fit_v2`` walks."""

import shutil

import numpy as np
import pytest
import torch

from karpenter_tpu_torch.solver import carry, fused, pack_kernel, pack_kernel_v2
from torch_parity import encode_scenario, fields, synth_fields, team_mix

# -- launch_plan -------------------------------------------------------------


@pytest.mark.parametrize(
    "F,G", [(1, 1), (2, 2), (3, 4), (8, 8), (31, 32), (32, 32), (33, 32), (400, 32)]
)
def test_lanes_per_slot_follow_F(F, G):
    plan = pack_kernel.launch_plan(F, 2, 512)
    assert plan.G == G
    assert plan.G & (plan.G - 1) == 0 and 1 <= plan.G <= 32
    assert plan.threads % plan.G == 0 and plan.threads % 32 == 0


@pytest.mark.parametrize("R", [1, 2, 3, 4, 8, 16, 64])
def test_plan_fits_shared_memory(R):
    for F in (1, 5, 33, 400):
        for n_cap in (1, 64, 512, 2048, 10_240, 40_000):
            plan = pack_kernel.launch_plan(F, R, n_cap)
            assert plan.threads & (plan.threads - 1) == 0
            assert 32 <= plan.threads <= (1024 if plan.G > 1 else 512)
            assert plan.G <= 32 and plan.G & (plan.G - 1) == 0
            assert plan.smem_bytes + pack_kernel.STATIC_SMEM <= 232_448
            stage = (5 + 2 * R) * plan.threads * 4
            nodes = n_cap * (2 + R) * 4
            assert plan.smem_bytes == stage + (nodes if plan.node_state_in_smem else 0)
            # device memory only where shared memory cannot hold the table
            assert plan.node_state_in_smem == (stage + nodes + pack_kernel.STATIC_SMEM <= 232_448)


def test_node_state_placement_on_the_main_path_shapes():
    headline = pack_kernel.launch_plan(1, 3, 512)  # F=1, R=3, n_max 512
    assert headline.G == 1 and headline.node_state_in_smem
    diverse = pack_kernel.launch_plan(400, 2, 512)  # the team mix at tradeoff(400)
    assert diverse.G == 32 and diverse.node_state_in_smem
    retry = pack_kernel.launch_plan(1, 4, 10_240)  # n_max = P at R = 4
    assert not retry.node_state_in_smem
    assert retry.smem_bytes == (5 + 2 * 4) * retry.threads * 4


@pytest.mark.parametrize("F,threads", [(4, 0), (4, 16), (4, 96), (4, 2048), (1, 1024)])
def test_plan_rejects_bad_thread_counts(F, threads):
    # G = 1 (F = 1) takes at most 512 threads, G > 1 at most 1024
    with pytest.raises(ValueError):
        pack_kernel.launch_plan(F, 2, 64, threads=threads)


def test_plan_rejects_staging_past_shared_memory():
    with pytest.raises(ValueError):
        pack_kernel.launch_plan(4, 64, 64, threads=1024)


# -- the build's key -----------------------------------------------------------


def test_build_dir_keys_on_every_source_and_header(tmp_path):
    csrc = tmp_path / "csrc"
    shutil.copytree(pack_kernel.CSRC, csrc)
    assert {p.name for p in csrc.glob("*.cuh")} and {p.name for p in csrc.glob("*.cu")}
    assert pack_kernel.build_dir(csrc) == pack_kernel.build_dir()
    header = csrc / "first_fit.cuh"
    original = header.read_bytes()
    header.write_bytes(original + b"\n// an edit\n")
    edited = pack_kernel.build_dir(csrc)
    assert edited != pack_kernel.build_dir()
    assert edited.parent == pack_kernel.BUILD_ROOT
    header.write_bytes(original)
    assert pack_kernel.build_dir(csrc) == pack_kernel.build_dir()
    source = csrc / "pack_first_fit.cu"
    source.write_bytes(source.read_bytes().replace(b"namespace {", b"namespace  {", 1))
    assert pack_kernel.build_dir(csrc) != pack_kernel.build_dir()


def test_build_dir_ignores_other_files(tmp_path):
    csrc = tmp_path / "csrc"
    shutil.copytree(pack_kernel.CSRC, csrc)
    (csrc / "notes.txt").write_text("not compiled")
    assert pack_kernel.build_dir(csrc) == pack_kernel.build_dir()


# -- the signature-major copy ------------------------------------------------


def test_signature_major_copy_of_the_team_mix():
    pkg = "karpenter_tpu_torch"
    f = fields(encode_scenario(pkg, *team_mix(pkg, 512, 9, 64)))
    front_j = torch.tensor(f["front_j"])
    C, FRp, S_pad = front_j.shape
    R = f["frontiers"].shape[2]
    F = f["frontiers"].shape[1]
    front_s = pack_kernel_v2.signature_major(front_j)
    assert front_s.shape == (C, S_pad, FRp) and front_s.is_contiguous()
    rng = np.random.default_rng(0)
    for c, s, f_, r in zip(rng.integers(0, C, 200), rng.integers(0, S_pad, 200),
                           rng.integers(0, F, 200), rng.integers(0, R, 200)):
        assert front_s[c, s, f_ * R + r] == front_j[c, f_ * R + r, s]
    np.testing.assert_array_equal(front_s.numpy(), np.asarray(f["front_j"]).transpose(0, 2, 1))
    # a leading batch axis stays in front
    stacked = torch.stack([front_j, front_j])
    assert torch.equal(pack_kernel_v2.signature_major(stacked)[1], front_s)


def test_v2_wrapper_checks_front_s_shape():
    f = synth_fields(P=64, S=4, F=2, R=3, C=3, n_hosts=2)
    args = carry.tensors_from_reference(f, "cpu")["pack_v2_args"]
    front_s = pack_kernel_v2.signature_major(args[2])
    ok = pack_kernel_v2.pack_first_fit_v2(*args, n_max=8, F=2, R=3, front_s=front_s)
    assert int(ok.n_nodes) >= 1
    with pytest.raises(ValueError):
        pack_kernel_v2.pack_first_fit_v2(*args, n_max=8, F=2, R=3, front_s=args[2])
    with pytest.raises(TypeError):
        pack_kernel_v2.pack_first_fit_v2(*args, n_max=8, F=2, R=3, front_s=front_s.double())


def test_fused_v2_takes_the_cached_copy():
    pkg = "karpenter_tpu_torch"
    batch = encode_scenario(pkg, *team_mix(pkg, 256, 3, 16))
    inv = fused.DeviceInvariants("cpu")
    tables = inv.get_v2(batch)
    tab, obc, bhh = fused.pack_pod_table(batch)
    pod_side = [torch.tensor(np.ascontiguousarray(a)) for a in
                (tab, obc, bhh, fused.pad_uniq_req(batch.uniq_req))]
    F, R = batch.frontiers.shape[1:]
    with_copy = fused.fused_solve_v2(*pod_side, *tables, n_max=256, F=F, R=R)
    without = fused.fused_solve_v2(*pod_side, *tables[:7], n_max=256, F=F, R=R)
    assert torch.equal(with_copy, without)
