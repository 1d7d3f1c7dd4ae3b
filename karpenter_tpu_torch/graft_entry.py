"""Entry points of the port: one solve, and the multi-chip dry run.

- ``entry(device)`` → ``(fn, args)``: ``pack_first_fit`` at ``n_max = P``
  on an encoded example batch, its inputs on ``device`` (the card by
  default).
- ``dryrun_multichip(n)`` runs the multi-provisioner solve step (pack and
  cheapest-type pick) over an n-device ``data × model`` mesh at the
  production shapes: 8 batches of 2,048 pods with a signature closure of
  129 (the v1 kernel), then 8 constraint-diverse batches of 512 pods over a
  16-type tradeoff catalog (F = 16, the v2 kernel). With fewer cards than
  ``n`` the mesh repeats the cards present, as the JAX package's dry run
  builds its mesh from virtual devices on one host. It never runs on the
  CPU unless ``devices`` names it.

    python3 -m karpenter_tpu_torch.graft_entry [--dryrun N]
"""

from __future__ import annotations

import json
import random
import sys
import time
from functools import partial

import numpy as np
import torch

from karpenter_tpu_torch.solver.carry import PACK_ARG_DTYPES


def _example_batch(
    n_pods: int = 64, n_types: int = 32, k_labels: int = 0, seed: int = 0,
    tradeoff: bool = False,
):
    """One encoded solve batch and its catalog. ``k_labels`` > 0 switches
    the pod mix to k distinct nodeSelector values (a signature closure of
    k + 1); ``tradeoff`` takes the anti-correlated cpu/mem catalog, whose
    capacity frontier is ``n_types`` wide (F > 1, the v2 kernel's shapes)."""
    from karpenter_tpu_torch.cloudprovider.fake import instance_types, instance_types_tradeoff
    from karpenter_tpu_torch.cloudprovider.requirements import catalog_requirements
    from karpenter_tpu_torch.kube.client import Cluster
    from karpenter_tpu_torch.scheduling.ffd import daemon_overhead, sort_pods_ffd
    from karpenter_tpu_torch.scheduling.topology import Topology
    from karpenter_tpu_torch.solver import encode as enc
    from karpenter_tpu_torch.testing import diverse_pods, make_pod, make_provisioner

    gen = instance_types_tradeoff if tradeoff else instance_types
    catalog = sorted(gen(n_types), key=lambda it: it.effective_price())
    constraints = make_provisioner(solver="tpu").spec.constraints
    constraints.requirements = constraints.requirements.merge(catalog_requirements(catalog))
    rng = random.Random(seed)
    if k_labels:
        pods = [
            make_pod(requests={"cpu": f"{rng.choice([0.25, 0.5, 1])}"},
                     node_selector={"team": f"t{i % k_labels}"})
            for i in range(n_pods)
        ]
    else:
        pods = diverse_pods(n_pods, rng)
    pods = sort_pods_ffd(pods)
    cluster = Cluster()
    plan = Topology(cluster, rng=random.Random(1)).inject_plan(constraints, pods)
    daemon = daemon_overhead(cluster, constraints)
    return enc.encode(constraints, catalog, pods, daemon, plan=plan), catalog


def pack_tensors(batch, device) -> tuple:
    """``batch.pack_args()`` as contiguous tensors on ``device``."""
    return tuple(
        torch.tensor(np.ascontiguousarray(a), dtype=dtype, device=device)
        for a, (_, dtype) in zip(batch.pack_args(), PACK_ARG_DTYPES)
    )


def entry(device="cuda"):
    """``(fn, args)``: one solve step, ``pack_first_fit`` at n_max = P on
    the example batch (the kernel on the card, its plain version on the
    CPU)."""
    from karpenter_tpu_torch.solver.pack_kernel import pack_first_fit
    from karpenter_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    batch, _ = _example_batch()
    return partial(pack_first_fit, n_max=len(batch.pod_valid)), pack_tensors(batch, dev)


def stack_batches(batches, catalog) -> tuple:
    """Stacked ``sharded_multi_solve`` inputs of batches that share their
    encoded shapes: (arrays, type masks, usable, prices)."""
    args = [b.pack_args() for b in batches]
    arrays = tuple(np.stack([np.asarray(a[i]) for a in args]) for i in range(len(PACK_ARG_DTYPES)))
    mask = np.stack([b.type_mask_matrix() for b in batches])
    prices = np.array([it.effective_price() for it in catalog], np.float32)
    return arrays, mask, batches[0].usable, prices


def _leg(mesh, stack: tuple, n_max: int) -> dict:
    """One sharded solve of a stack, with the kernels' launches read
    around it."""
    from karpenter_tpu_torch.parallel.sharding import sharded_multi_solve
    from karpenter_tpu_torch.solver import pack_kernel, pack_kernel_v2

    before = (pack_kernel.launches, pack_kernel_v2.launches)
    result, cheapest, route = sharded_multi_solve(mesh, *stack, n_max=n_max)
    if result.n_nodes.is_cuda:
        torch.cuda.synchronize()
    return {
        "stack": stack, "n_max": n_max, "result": result, "cheapest": cheapest,
        "route": route,
        "launches": {"pack_first_fit": pack_kernel.launches - before[0],
                     "pack_first_fit_v2": pack_kernel_v2.launches - before[1]},
    }


def _check_parity(leg: dict, batches, n_max: int, what: str) -> int:
    """Each of the first two batches' sharded assignment against an
    unsharded solve of it (the plain version on the CPU). Returns how many
    were checked."""
    from karpenter_tpu_torch.solver.kernel import pack_reference

    assignment = leg["result"].assignment.cpu()
    checked = min(len(batches), 2)
    for b in range(checked):
        ref = pack_reference(*pack_tensors(batches[b], "cpu"), n_max=n_max)
        if not torch.equal(ref.assignment, assignment[b]):
            raise AssertionError(f"{what} sharded vs single-device assignment mismatch, batch {b}")
    return checked


def dryrun_multichip(n_devices: int, devices=None) -> dict:
    """Run the multi-provisioner solve step over an ``n_devices`` mesh
    (batch axis over ``data``, instance-type axis over ``model``, which is
    2 when ``n_devices`` is even) and check it. ``devices`` names the
    mesh's devices (``["cpu"] * 8`` runs the plain versions); by default
    the cards present, repeated when there are fewer than ``n_devices``.
    Prints the ``dryrun_multichip ok: {...}`` line and returns
    ``{"summary": <that line's object>, "legs": {"v1": ..., "v2": ...}}``,
    each leg holding its stack, ``n_max``, result, cheapest types, route
    report and the kernels' launches read around its solve."""
    from karpenter_tpu_torch.parallel.sharding import make_solver_mesh
    from karpenter_tpu_torch.utils.device import resolve_device

    if devices is None:
        # the cards present, repeated in turn when there are fewer than asked
        resolve_device("cuda")
        count = torch.cuda.device_count()
        devices = [f"cuda:{i % count}" for i in range(n_devices)]
        print(f"dryrun_multichip: {count} physical CUDA device(s) for a mesh of {n_devices}",
              flush=True)
    model_parallel = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    mesh = make_solver_mesh(n_devices, model_parallel=model_parallel, devices=devices)
    B = max(mesh.shape["data"], 8 if n_devices >= 8 else mesh.shape["data"])

    t0 = time.perf_counter()
    batches, catalog = [], None
    for b in range(B):
        batch, catalog = _example_batch(n_pods=2048, n_types=32, k_labels=128, seed=b)
        batches.append(batch)
    encode_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    stack = stack_batches(batches, catalog)
    stack_s = time.perf_counter() - t0
    n_max = 512

    t0 = time.perf_counter()
    v1 = _leg(mesh, stack, n_max)
    solve_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    assignment = v1["result"].assignment.cpu()
    n_nodes = v1["result"].n_nodes.cpu().reshape(-1)
    cheapest = v1["cheapest"].cpu()
    fetch_s = time.perf_counter() - t0
    if int(n_nodes.min()) <= 0:
        raise AssertionError("dryrun solved zero nodes on some shard")
    for b in range(B):
        if int(cheapest[b, : int(n_nodes[b])].min()) < 0:
            raise AssertionError(f"batch {b}: node without launchable type")
    t0 = time.perf_counter()
    parity = _check_parity(v1, batches, n_max, "v1")
    parity_s = time.perf_counter() - t0

    # the constraint-diverse stack: S·F past the v1 unroll budget, the v2 gate
    t0 = time.perf_counter()
    f_batches, f_catalog = [], None
    for b in range(B):
        fb, f_catalog = _example_batch(
            n_pods=512, n_types=16, k_labels=64, seed=100 + b, tradeoff=True)
        f_batches.append(fb)
    v2 = _leg(mesh, stack_batches(f_batches, f_catalog), 512)
    v2_route = v2["route"]
    if not v2_route["v2_shape_eligible"]:
        raise AssertionError(f"F>1 stack must traverse the v2 shape gate eligible: {v2_route}")
    if v2_route["v1_shape_eligible"] and v2_route["S"] * v2_route["F"] > 1024:
        raise AssertionError(f"F>1 stack past the v1 budget reported v1-eligible: {v2_route}")
    f_parity = _check_parity(v2, f_batches, 512, "F>1")
    f_solve_s = time.perf_counter() - t0
    f_assignment = v2["result"].assignment.cpu()

    S, F = batches[0].frontiers.shape[0], batches[0].frontiers.shape[1]
    summary = {
        "mesh": dict(mesh.shape),
        "B": B,
        "pods_per_batch": batches[0].n_pods,
        "P": int(len(batches[0].pod_valid)),
        "S": int(S),
        "F": int(F),
        "n_max": n_max,
        "nodes_per_batch": [int(x) for x in n_nodes],
        "scheduled": int((assignment[:, : batches[0].n_pods] >= 0).sum()),
        "parity_checked_batches": parity,
        "route": v1["route"],
        "f_gt1": {
            "S": int(f_batches[0].frontiers.shape[0]),
            "F": int(f_batches[0].frontiers.shape[1]),
            "route": v2_route,
            "scheduled": int((f_assignment[:, : f_batches[0].n_pods] >= 0).sum()),
            "parity_checked_batches": f_parity,
            "solve_s": round(f_solve_s, 3),
        },
        "timing_s": {
            "encode": round(encode_s, 3),
            "stack": round(stack_s, 3),
            "compile_and_solve": round(solve_s, 3),
            "fetch": round(fetch_s, 3),
            "parity_check": round(parity_s, 3),
        },
    }
    print("dryrun_multichip ok: " + json.dumps(summary), flush=True)
    return {"summary": summary, "legs": {"v1": v1, "v2": v2}}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) >= 2 and argv[0] == "--dryrun":
        dryrun_multichip(int(argv[1]))
        return 0
    fn, args = entry()
    out = fn(*args)
    torch.cuda.synchronize()
    print("entry ok:", int(out.n_nodes), "nodes", flush=True)
    dryrun_multichip(8)
    return 0


if __name__ == "__main__":
    sys.exit(main())
