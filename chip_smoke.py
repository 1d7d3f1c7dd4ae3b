"""Drive the PyTorch port on one CUDA card, end to end, and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is swallowed):

1. build   — compile every kernel of the port from the checkout's sources
             (nvcc, sm_90a) and print what ptxas reports, and the card's
             name and power limit;
2. parity  — on the headline batch (instance_types(400) x
             diverse_pods(10000, Random(42)), encoded by the port), run
             pack_first_fit on the card and its plain version on CPU copies
             of the same inputs; all five outputs must be bit-exact at
             n_max 512, n_max P and a saturating n_max 64, and on a seeded
             synthetic problem with large tables; time the kernel (CUDA
             events) and the plain version;
3. main    — Scheduler.solve(solver: tpu) on cuda: one warm-up round whose
             plan must equal the device="cpu" plan of the same solve and
             open the reference's 431 nodes, then
             5 rounds with the launch counts set to 0 just before them;
             every round must pass validation and launch the kernel; then
             one more round under torch.profiler for the device's busy time
             by kernel and its idle share;
4. retry   — a batch that opens more than 512 nodes through
             Scheduler.solve: pack_dispatches == 2 and cuda == cpu;
5. kernels — one JSON line listing every kernel of the port.

The last line of standard output is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import json
import random
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and non-tensor f32 rate
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

KERNEL_SOURCE = "karpenter_tpu_torch/solver/csrc/pack_first_fit.cu"
REPLACES = "karpenter_tpu/solver/pallas_kernel.py:51"  # _pack_kernel (pallas_call at :197)
# nodes the JAX package's lax.scan kernel opens on the headline batch
HEADLINE_NODES = 431


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def headline_batch(n_pods: int, n_types: int, seed: int):
    """The main path's host stages up to the kernel, with the port alone:
    catalog requirements, FFD sort, topology injection (Random(1)), daemon
    overhead, encode."""
    from karpenter_tpu_torch.cloudprovider.fake import instance_types
    from karpenter_tpu_torch.cloudprovider.requirements import catalog_requirements
    from karpenter_tpu_torch.kube.client import Cluster
    from karpenter_tpu_torch.scheduling.ffd import daemon_overhead, sort_pods_ffd_with_statics
    from karpenter_tpu_torch.scheduling.topology import Topology
    from karpenter_tpu_torch.solver import encode as enc
    from karpenter_tpu_torch.testing import diverse_pods, make_provisioner

    catalog = sorted(instance_types(n_types), key=lambda it: it.effective_price())
    c = make_provisioner(solver="tpu").spec.constraints.clone()
    c.requirements = c.requirements.merge(catalog_requirements(catalog))
    pods, sts = sort_pods_ffd_with_statics(diverse_pods(n_pods, random.Random(seed)))
    cluster = Cluster()
    plan = Topology(cluster, rng=random.Random(1)).inject_plan(c, pods, sts=sts)
    return enc.encode(c, catalog, pods, daemon_overhead(cluster, c), plan=plan)


def kernel_inputs(batch, device):
    """pack_first_fit's inputs exactly as the main path builds them: the
    compact pod table unpacked on the device, the invariants uploaded."""
    import numpy as np
    import torch

    from karpenter_tpu_torch.solver import fused

    tab, open_by_core, bhh = fused.pack_pod_table(batch)
    uniq = fused.pad_uniq_req(batch.uniq_req)
    pod_side = [torch.tensor(np.ascontiguousarray(a), device=device)
                for a in (tab, open_by_core, bhh, uniq)]
    join, front, daemon, _, _ = fused.DeviceInvariants(device).get(batch)
    return fused._unpack_pods(*pod_side) + (join, front, daemon)


def compare(ref, out) -> float:
    """Max |difference| over the five outputs; raises unless bit-exact."""
    import torch

    worst = 0.0
    for name, a, b in zip(ref._fields, ref, out):
        a, b = a.cpu(), b.cpu()
        if a.dtype != b.dtype or a.shape != b.shape:
            raise AssertionError(f"{name}: {a.dtype}{tuple(a.shape)} vs {b.dtype}{tuple(b.shape)}")
        diff = (a.double() - b.double()).abs().max().item() if a.numel() else 0.0
        worst = max(worst, diff)
        if not torch.equal(a, b):
            bad = (a != b).nonzero()[:5].tolist()
            raise AssertionError(f"{name} differs (max |diff| {diff}) at {bad}")
    return worst


def kernel_ms(args, n_max: int, iters: int) -> float:
    import torch

    from karpenter_tpu_torch.solver.pack_kernel import pack_first_fit

    for _ in range(3):
        pack_first_fit(*args, n_max=n_max)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        pack_first_fit(*args, n_max=n_max)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(args, result, n_max: int):
    """(bound_ms, bound_by, bytes, ops): each input read once and each output
    written once over HBM bandwidth, against the f32 adds and compares this
    run's data needs (every valid pod against the nodes open at its turn)
    over the f32 rate."""
    n_bytes = sum(a.numel() * a.element_size() for a in args)
    n_bytes += sum(a.numel() * a.element_size() for a in result)
    R, F = args[6].shape[1], args[8].shape[1]
    count, scanned = 0, 0
    valid = args[0].cpu().tolist()
    for v, a in zip(valid, result.assignment.cpu().tolist()):
        if not v:
            continue
        scanned += count
        if a == count:
            count += 1
    ops = scanned * (R + F * R) + sum(valid) * (R + F * R)
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), n_bytes, ops


def profile_round(run, card: str) -> None:
    """One more main-path round under torch.profiler: device busy time by
    kernel, and the device's idle share of the round's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for row in prof.key_averages():
        us = row.self_device_time_total
        if us > 0:
            rows.append((us / 1e3, row.count, row.key))
    busy_ms = sum(ms for ms, _, _ in rows)
    if not rows:
        log(f"[profile] round {wall_ms:.3f} ms; device time not measured "
            "(the profiler recorded no device activity)")
        return
    log(f"[profile] round {wall_ms:.3f} ms (profiled), device busy {busy_ms:.3f} ms, "
        f"idle share {1 - busy_ms / wall_ms:.4f}; card {card}")
    for ms, count, key in sorted(rows, reverse=True)[:8]:
        log(f"[profile]   {ms:9.4f} ms  x{count:<3d} {key[:90]}")


def plan_of(nodes, pods):
    index = {id(p): i for i, p in enumerate(pods)}
    return [
        ([index[id(p)] for p in n.pods], [it.name for it in n.instance_type_options],
         n.requests, n.constraints.requirements.requirements)
        for n in nodes
    ]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2

    from karpenter_tpu_torch.kube.client import Cluster
    from karpenter_tpu_torch.cloudprovider.fake import instance_types
    from karpenter_tpu_torch.scheduling.scheduler import Scheduler
    from karpenter_tpu_torch.solver import pack_kernel
    from karpenter_tpu_torch.solver.kernel import pack_reference
    from karpenter_tpu_torch.testing import diverse_pods, make_provisioner
    from karpenter_tpu_torch.testing.factories import make_pod
    from karpenter_tpu_torch.api.objects import LabelSelector, PodAffinityTerm
    from karpenter_tpu_torch.api import labels as lbl

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    # -- 1. build ---------------------------------------------------------
    t0 = time.perf_counter()
    pack_kernel.build()
    log(f"[build] pack_first_fit built in {time.perf_counter() - t0:.2f}s")
    for line in pack_kernel.build_log().splitlines():
        if "ptxas info" in line or "spill" in line:
            log(f"[build] {line.strip()}")

    # -- 2. kernel against its plain version ------------------------------
    t0 = time.perf_counter()
    batch = headline_batch(10000, 400, 42)
    P = len(batch.pod_valid)
    S, C = batch.join_table.shape
    F, R = batch.frontiers.shape[1], batch.frontiers.shape[2]
    log(f"[parity] headline batch P={P} S={S} F={F} R={R} C={C} "
        f"T={batch.usable.shape[0]} U={batch.uniq_req.shape[0]} "
        f"hostnames={len(batch.hostnames)} (encoded in {time.perf_counter() - t0:.2f}s)")
    gpu = kernel_inputs(batch, dev)
    cpu = tuple(a.cpu() for a in gpu)
    worst = 0.0
    results = {}
    for n_max in (512, P, 64):
        out = pack_kernel.pack_first_fit(*gpu, n_max=n_max)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = pack_reference(*cpu, n_max=n_max)
        cpu_s = time.perf_counter() - t0
        worst = max(worst, compare(ref, out))
        results[n_max] = out
        log(f"[parity] headline n_max={n_max}: bit-exact, nodes={int(out.n_nodes)} "
            f"unscheduled={int((out.assignment[: batch.n_pods] < 0).sum())} "
            f"(plain version on CPU {cpu_s:.2f}s)")
    if int(results[64].n_nodes) != 64:
        raise AssertionError("n_max=64 did not saturate the node table")

    import numpy as np

    rng = np.random.default_rng(7)
    Ps, Ss, Fs, Rs, Cs, H = 4096, 200, 8, 4, 16, 120
    host = np.where(rng.random(Ps) < 0.5, rng.integers(0, H, Ps), -1)
    hib = rng.random(Ps) < 0.7
    frontiers = rng.uniform(2.0, 8.0, (Ss, Fs, Rs))
    frontiers[:, Fs // 2:, :] = -1.0
    open_sig_by_core = rng.integers(0, Ss, Cs)
    core = rng.integers(0, Cs, Ps)
    synth = (
        torch.tensor(rng.random(Ps) < 0.95),
        torch.tensor(open_sig_by_core[core], dtype=torch.int32),
        torch.tensor(core, dtype=torch.int32),
        torch.tensor(host, dtype=torch.int32),
        torch.tensor(hib),
        torch.tensor(np.where(host >= 0, np.where(hib, host, -2), -1), dtype=torch.int32),
        torch.tensor(rng.uniform(0.1, 1.5, (Ps, Rs)), dtype=torch.float32),
        torch.tensor(rng.integers(-1, Ss, (Ss, Cs)), dtype=torch.int32),
        torch.tensor(frontiers, dtype=torch.float32),
        torch.tensor(rng.uniform(0.0, 0.5, Rs), dtype=torch.float32),
    )
    for n_max in (1024, Ps):
        out = pack_kernel.pack_first_fit(*(a.to(dev) for a in synth), n_max=n_max)
        torch.cuda.synchronize()
        worst = max(worst, compare(pack_reference(*synth, n_max=n_max), out))
        hosts = set(out.node_host[: int(out.n_nodes)].tolist())
        log(f"[parity] synthetic P={Ps} S={Ss} F={Fs} R={Rs} C={Cs} n_max={n_max}: "
            f"bit-exact, nodes={int(out.n_nodes)} host states -2:{-2 in hosts} "
            f"-1:{-1 in hosts} h:{max(hosts) >= 0}")

    ms_512 = kernel_ms(gpu, 512, 20)
    ms_p = kernel_ms(gpu, P, 20)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = pack_reference(*gpu, n_max=512)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    worst = max(worst, compare(plain, results[512]))
    bound_ms, bound_by, n_bytes, n_ops = bound(gpu, results[512], 512)
    bound_p, _, _, _ = bound(gpu, results[P], P)
    log(f"[parity] kernel {ms_512:.4f} ms at n_max=512, {ms_p:.4f} ms at n_max={P} "
        f"(CUDA events, mean of 20); plain version on the card {plain_ms:.1f} ms; "
        f"bound {bound_ms:.6f} ms by {bound_by} ({n_bytes} bytes, {n_ops} ops), "
        f"{bound_p:.6f} ms at n_max={P}; card {card}")

    # -- 3. main path -----------------------------------------------------
    catalog = instance_types(400)
    pods = diverse_pods(10000)
    prov = make_provisioner(solver="tpu")
    sched = Scheduler(Cluster(), rng=random.Random(1))
    t0 = time.perf_counter()
    warm = sched.solve(prov, catalog, pods)
    torch.cuda.synchronize()
    log(f"[main] warm-up round {time.perf_counter() - t0:.3f}s, nodes={len(warm)}")
    cpu_nodes = Scheduler(Cluster(), rng=random.Random(1), device="cpu").solve(prov, catalog, pods)
    if plan_of(warm, pods) != plan_of(cpu_nodes, pods):
        raise AssertionError("cuda plan differs from the device='cpu' plan")
    if len(warm) != HEADLINE_NODES:
        raise AssertionError(f"main path opened {len(warm)} nodes, expected {HEADLINE_NODES}")
    log(f"[main] cuda plan == cpu plan ({len(cpu_nodes)} nodes, "
        f"{sum(len(n.pods) for n in cpu_nodes)} pods placed)")

    pack_kernel.launches = 0
    rounds = []
    for r in range(5):
        before = pack_kernel.launches
        t0 = time.perf_counter()
        nodes = sched.solve(prov, catalog, pods)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        prof = sched.last_stage_profile()
        if pack_kernel.launches <= before:
            raise AssertionError(f"round {r} did not launch pack_first_fit")
        if prof["packer_backend"] != "pack_first_fit":
            raise AssertionError(f"round {r} packed with {prof['packer_backend']}")
        rounds.append(wall)
        stages = " ".join(
            f"{k}={prof[k] * 1e3:.3f}ms"
            for k in ("sort_s", "inject_s", "encode_s", "pack_fetch_s", "decode_s", "validate_s")
        )
        log(f"[main] round {r}: {wall * 1e3:.3f} ms, nodes={len(nodes)}, "
            f"pods/s={len(pods) / wall:.1f}, dispatches={prof['pack_dispatches']}, "
            f"{stages}")
    main_launches = pack_kernel.launches
    mean = sum(rounds) / len(rounds)
    log(f"[main] 5 rounds: mean {mean * 1e3:.3f} ms, {len(pods) / mean:.1f} pods/s, "
        f"kernel launches {main_launches}; kernel alone {ms_512:.4f} ms (CUDA events); "
        f"card {card}")
    profile_round(lambda: sched.solve(prov, catalog, pods), card)

    # -- 4. retry path ----------------------------------------------------
    sel = {"app": "solo"}
    term = PodAffinityTerm(label_selector=LabelSelector(match_labels=sel),
                           topology_key=lbl.HOSTNAME)
    solo = [make_pod(labels=sel, requests={"cpu": "0.25"}, pod_anti_requirements=[term])
            for _ in range(600)]
    small = instance_types(50)
    before = pack_kernel.launches
    retry_sched = Scheduler(Cluster(), rng=random.Random(1))
    retry_nodes = retry_sched.solve(prov, small, solo)
    torch.cuda.synchronize()
    prof = retry_sched.last_stage_profile()
    if prof["pack_dispatches"] != 2 or pack_kernel.launches - before != 2:
        raise AssertionError(f"retry path: {prof['pack_dispatches']} dispatches, "
                             f"{pack_kernel.launches - before} launches")
    retry_cpu = Scheduler(Cluster(), rng=random.Random(1), device="cpu").solve(prov, small, solo)
    if plan_of(retry_nodes, solo) != plan_of(retry_cpu, solo):
        raise AssertionError("retry path: cuda plan differs from the cpu plan")
    log(f"[retry] 600 one-per-node pods: {len(retry_nodes)} nodes, dispatches=2, "
        f"cuda == cpu")

    # -- 5. kernels -------------------------------------------------------
    kernels = [{
        "name": "pack_first_fit",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": REPLACES,
        "launches": main_launches,
        "max_abs_err": worst,
        "ms": ms_512,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "parity": "bit-exact",
    }]
    if main_launches < 5:
        raise AssertionError(f"main path launched pack_first_fit {main_launches} times")
    log(f"total {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
