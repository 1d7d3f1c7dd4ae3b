"""Multi-solve on one card: B independent packing problems in one launch.

The reference (``karpenter_tpu/parallel/sharding.py::sharded_multi_solve``)
shards a stack of provisioner batches over a device mesh: the batch axis
over ``data`` (the DP analog) and the instance-type axis of the
cheapest-type pick over ``model``. On one card the ``data`` axis becomes the
kernel's grid — one thread block per problem, B blocks in one launch — and
the type axis has a single shard, so ``sharded_multi_solve`` takes a
``device`` in place of a mesh.

The stack is routed by the same shape gates as the single solve
(``pack_kernel_v2.fused_route``): ``pack_first_fit`` over the stacked
kernel inputs, or, for constraint-diverse stacks whose per-problem tables
fit the card's budget (each block reads only its own), ``pack_first_fit_v2``
over tables precomputed per problem on the host. On the CPU the plain
versions run problem by problem.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from karpenter_tpu_torch.solver import pack_kernel_v2
from karpenter_tpu_torch.solver.backend import kernel_name
from karpenter_tpu_torch.solver.carry import PACK_ARG_DTYPES
from karpenter_tpu_torch.solver.pack_kernel import BLOCK, pack_first_fit
from karpenter_tpu_torch.utils.device import resolve_device


def _cheapest_multi(node_req, node_sig, sig_type_mask, usable, prices) -> torch.Tensor:
    """Batched cheapest-fitting type: [B, N, R] × [B, S, T] × [T, R] × [T]
    → [B, N] i32, the lowest-index type among the cheapest on ties, and -1
    where no type is launchable (unopened node, or nothing fits)."""
    B, N = node_sig.shape
    T = usable.shape[0]
    rows = torch.arange(B, device=node_sig.device)[:, None]
    mask = sig_type_mask[rows, node_sig.clamp(min=0).long()]  # [B, N, T]
    fits = (node_req[:, :, None, :] <= usable[None, None, :, :]).all(-1)  # [B, N, T]
    ok = mask & fits & (node_sig >= 0)[:, :, None]
    cost = torch.where(ok, prices, torch.full_like(prices, float("inf")))
    lowest = cost.min(dim=-1, keepdim=True).values
    idx = torch.arange(T, device=node_sig.device).expand(B, N, T)
    first = torch.where(ok & (cost == lowest), idx, T).min(dim=-1).values
    return torch.where(ok.any(-1), first, -1).to(torch.int32)


def sharded_multi_solve(
    device,
    batch_arrays: Tuple,  # stacked [B, ...] host arrays, in pack_args() order
    sig_type_mask,  # [B, S, T] bool
    usable,  # [T, R] f32
    prices,  # [T] f32
    n_max: int,
):
    """Pack B independent problems on ``device`` and pick each node's
    cheapest launchable type. The problems must share their encoded shapes
    (they are stacked). Returns ``(PackResult, cheapest, route)``: the
    PackResult fields and ``cheapest`` [B, n_max] carry the batch axis, and
    ``route`` reports the reference's keys — the kernel that ran and the
    shape gates it passed (``v1_shape_eligible`` by the reference's rule,
    ``v2_shape_eligible`` by the card's table budget)."""
    dev = resolve_device(device)
    arrays = tuple(np.asarray(a) for a in batch_arrays)
    B, P, R = arrays[6].shape
    S, F = arrays[8].shape[1], arrays[8].shape[2]
    C = arrays[7].shape[2]
    route = pack_kernel_v2.fused_route(S, F, R, C)
    report = {
        "route": kernel_name(route, dev),
        # the reference's v1 gate: P a multiple of its lane block and S·F
        # within the unroll budget (its third term, B divisible by the mesh's
        # data axis, holds for every B on one card)
        "v1_shape_eligible": bool(
            P % BLOCK == 0 and S * F <= pack_kernel_v2.PALLAS_UNROLL_BUDGET
        ),
        # deliberately the card's gate, not the reference's VMEM gate: the
        # per-core tables against the L2 budget, whatever n_max is
        "v2_shape_eligible": pack_kernel_v2.v2_tables_fit(S, F, R, C),
        "S": int(S), "F": int(F), "B": int(B), "P": int(P),
    }
    args = tuple(
        torch.tensor(a, dtype=dtype, device=dev)
        for a, (_, dtype) in zip(arrays, PACK_ARG_DTYPES)
    )
    if route == "v2":
        result = pack_kernel_v2.pack_first_fit_v2(
            *pack_kernel_v2.v2_args(*args), n_max=n_max, F=F, R=R)
    else:
        result = pack_first_fit(*args, n_max=n_max)
    cheapest = _cheapest_multi(
        result.node_req,
        result.node_sig,
        torch.tensor(np.asarray(sig_type_mask, bool), device=dev),
        torch.tensor(np.asarray(usable, np.float32), device=dev),
        torch.tensor(np.asarray(prices, np.float32), device=dev),
    )
    return result, cheapest, report
