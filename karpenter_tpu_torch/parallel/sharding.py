"""The multi-solve over a ``data × model`` mesh of devices.

The reference (``karpenter_tpu/parallel/sharding.py``) shards a stack of
provisioner batches over a ``jax.sharding.Mesh``: the batch axis over
``data`` (the DP analog; each shard packs its batches in its kernel) and
the instance-type axis of the cheapest-type pick over ``model`` (the TP
analog; XLA inserts the cross-shard argmin). Its controller is one process
that places arrays on every device of the mesh, and solves many
provisioners' batches.

The port keeps that shape: one process drives a ``SolverMesh``, a grid of
``torch.device`` s. Each data shard uploads its contiguous rows of the
stack to its row's first device and launches ``pack_first_fit`` (or
``pack_first_fit_v2``) once over them; with more than one data shard each
launches on a CUDA stream of its own, so shards that share a card overlap,
and a single shard launches on the current stream. Each model shard picks, per node, the
cheapest of its slice of the types, and the row's first device reduces the
shards' picks; peer copies (``Tensor.to``) stand where XLA puts
collectives. There are no ``torch.distributed`` ranks: a rank per card
would need a controller per card. A device may repeat in the grid: the
JAX package's dry run builds its mesh from virtual devices on one host,
and the port's builds it from the cards present (``["cuda:0"] * 8`` on one
card, ``["cpu"] * 8`` in the tests).

The stack is routed by the single solve's shape rule
(``pack_kernel_v2.fused_route``), decided once per stack. On CPU devices
the plain versions run, problem by problem.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from karpenter_tpu_torch.solver import pack_kernel_v2
from karpenter_tpu_torch.solver.backend import kernel_name
from karpenter_tpu_torch.solver.carry import PACK_ARG_DTYPES
from karpenter_tpu_torch.solver.kernel import PackResult
from karpenter_tpu_torch.solver.pack_kernel import BLOCK, pack_first_fit
from karpenter_tpu_torch.utils.device import resolve_device


class SolverMesh:
    """A ``data × model`` grid of devices, all CUDA or all CPU; a device
    may appear more than once. ``shape`` reads as the reference's
    ``Mesh.shape``."""

    def __init__(self, grid: Sequence[Sequence]):
        self.devices = tuple(tuple(resolve_device(d) for d in row) for row in grid)
        if not self.devices or not self.devices[0]:
            raise ValueError("a solver mesh needs at least one device")
        if len({len(row) for row in self.devices}) != 1:
            raise ValueError("every row of a solver mesh has the same number of devices")
        kinds = {d.type for row in self.devices for d in row}
        if len(kinds) != 1:
            raise ValueError(f"a solver mesh is all cuda or all cpu, got {sorted(kinds)}")

    @property
    def shape(self) -> dict:
        return {"data": len(self.devices), "model": len(self.devices[0])}

    @property
    def first(self) -> torch.device:
        return self.devices[0][0]


def make_solver_mesh(
    n_devices: Optional[int] = None, model_parallel: int = 1, devices=None
) -> SolverMesh:
    """2D mesh over (data, model). ``model_parallel`` shards the
    instance-type axis; the rest of the devices shard independent solve
    batches. ``devices`` names the devices in order (a device may repeat);
    by default every visible card, and without a card this raises. At most
    ``n_devices`` are taken."""
    if devices is None:
        resolve_device("cuda")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devices = list(devices)[: n_devices or len(devices)]
    if model_parallel < 1 or len(devices) % model_parallel:
        raise ValueError(f"cannot reshape {len(devices)} devices into a "
                         f"(data, model={model_parallel}) mesh")
    data = len(devices) // model_parallel
    return SolverMesh([devices[i * model_parallel:(i + 1) * model_parallel]
                       for i in range(data)])


def _upload(a: np.ndarray, dtype, device) -> torch.Tensor:
    # a stacked array keeps its batches' layout (the encoder's pod_req is a
    # transposed view); the kernels take contiguous tensors
    return torch.tensor(np.ascontiguousarray(a), dtype=dtype, device=device)


def _cheapest_part(node_req, node_sig, sig_type_mask, usable, prices, offset: int = 0):
    """One slice of the types: [B, N, R] × [B, S, T] × [T, R] × [T] → per
    node (least cost, the lowest index reaching it plus ``offset``, whether
    any type is launchable); the cost is inf where none is."""
    B, N = node_sig.shape
    T = usable.shape[0]
    rows = torch.arange(B, device=node_sig.device)[:, None]
    mask = sig_type_mask[rows, node_sig.clamp(min=0).long()]  # [B, N, T]
    fits = (node_req[:, :, None, :] <= usable[None, None, :, :]).all(-1)  # [B, N, T]
    ok = mask & fits & (node_sig >= 0)[:, :, None]
    cost = torch.where(ok, prices, torch.full_like(prices, float("inf")))
    least = cost.min(dim=-1).values
    idx = torch.arange(T, device=node_sig.device).expand(B, N, T)
    first = torch.where(ok & (cost == least[..., None]), idx, T).min(dim=-1).values
    return least, first + offset, ok.any(-1)


def _reduce_parts(parts) -> torch.Tensor:
    """The cheapest type over every slice, from ``_cheapest_part``'s triples
    in the order of their slices (all on one device): the least cost, ties
    to the lowest global index, -1 where no slice has a launchable type."""
    if len(parts) == 1:
        _, first, has = parts[0]
        return torch.where(has, first, -1).to(torch.int32)
    least = torch.stack([p[0] for p in parts])  # [m, B, N]
    first = torch.stack([p[1] for p in parts])
    has = torch.stack([p[2] for p in parts])
    pick = has & (least == least.min(dim=0).values)
    lowest = torch.where(pick, first, torch.iinfo(first.dtype).max).min(dim=0).values
    return torch.where(pick.any(0), lowest, -1).to(torch.int32)


def _cheapest_multi(node_req, node_sig, sig_type_mask, usable, prices) -> torch.Tensor:
    """Batched cheapest-fitting type: [B, N, R] × [B, S, T] × [T, R] × [T]
    → [B, N] i32, the lowest-index type among the cheapest on ties, and -1
    where no type is launchable (unopened node, or nothing fits)."""
    return _reduce_parts([_cheapest_part(node_req, node_sig, sig_type_mask, usable, prices)])


def _check_gates(mesh: SolverMesh, B: int, mask, usable, prices) -> None:
    """Raise where the reference's ``device_put`` onto the mesh raises:
    the batch axis must divide by ``data``, the type axis of the mask,
    ``usable`` and ``prices`` by ``model``."""
    data, model = mesh.shape["data"], mesh.shape["model"]
    if B % data:
        raise ValueError(f"the batch axis ({B}) does not divide by the mesh's data axis ({data})")
    for name, T in (("sig_type_mask", mask.shape[2]), ("usable", usable.shape[0]),
                    ("prices", prices.shape[0])):
        if T % model:
            raise ValueError(f"{name}'s type axis ({T}) does not divide by the mesh's "
                             f"model axis ({model})")


def _pack_shard(args: tuple, route: str, n_max: int, F: int, R: int) -> PackResult:
    if route == "v2":
        return pack_kernel_v2.pack_first_fit_v2(*pack_kernel_v2.v2_args(*args), n_max=n_max,
                                                F=F, R=R)
    return pack_first_fit(*args, n_max=n_max)


def sharded_multi_solve(
    mesh,
    batch_arrays: Tuple,  # stacked [B, ...] host arrays, in pack_args() order
    sig_type_mask,  # [B, S, T] bool
    usable,  # [T, R] f32
    prices,  # [T] f32
    n_max: int,
):
    """Run B independent packing problems across ``mesh`` and pick each
    node's cheapest launchable type, the batch axis sharded over ``data``
    and the type axis over ``model``. ``mesh`` is a ``SolverMesh``, or a
    device, taken as a 1 × 1 mesh. The problems share their encoded shapes
    (they are stacked). Raises ``ValueError`` before any upload where the
    reference's placement raises.

    Each data shard makes one launch on its row's first device, on a stream
    of its own when there are several; a launch that fails raises. Returns ``(PackResult,
    cheapest, route)`` on the mesh's first device: the PackResult fields
    and ``cheapest`` [B, n_max] carry the batch axis in order, and
    ``route`` reports the reference's keys — the kernel that ran and the
    shape gates it passed (``v1_shape_eligible`` by the reference's rule,
    ``v2_shape_eligible`` by the card's table budget)."""
    if not isinstance(mesh, SolverMesh):
        mesh = SolverMesh([[mesh]])
    arrays = tuple(np.asarray(a) for a in batch_arrays)
    sig_type_mask = np.asarray(sig_type_mask, bool)
    usable = np.asarray(usable, np.float32)
    prices = np.asarray(prices, np.float32)
    B, P, R = arrays[6].shape
    S, F = arrays[8].shape[1], arrays[8].shape[2]
    C = arrays[7].shape[2]
    _check_gates(mesh, B, sig_type_mask, usable, prices)
    route = pack_kernel_v2.fused_route(S, F, R, C)
    data, model = mesh.shape["data"], mesh.shape["model"]
    report = {
        "route": kernel_name(route, mesh.first),
        # the reference's v1 gate: P a multiple of its lane block, S·F within
        # the unroll budget, B divisible by the mesh's data axis
        "v1_shape_eligible": bool(
            P % BLOCK == 0 and S * F <= pack_kernel_v2.PALLAS_UNROLL_BUDGET and B % data == 0
        ),
        # deliberately the card's gate, not the reference's VMEM gate: the
        # per-core tables against the L2 budget, whatever n_max is
        "v2_shape_eligible": pack_kernel_v2.v2_tables_fit(S, F, R, C),
        "S": int(S), "F": int(F), "B": int(B), "P": int(P),
    }
    per = B // data
    side_streams = mesh.first.type == "cuda" and data > 1

    # -- data shards: one launch each, on its own stream -------------------
    def pack(rows: slice, dev) -> PackResult:
        args = tuple(_upload(a[rows], dtype, dev) for a, (_, dtype) in zip(arrays, PACK_ARG_DTYPES))
        return _pack_shard(args, route, n_max, F, R)

    shards = []  # (row's first device, PackResult, event or None)
    for i, row in enumerate(mesh.devices):
        dev, rows = row[0], slice(i * per, (i + 1) * per)
        if not side_streams:
            shards.append((dev, pack(rows, dev), None))
            continue
        stream = torch.cuda.Stream(dev)
        # the shard's inputs are made and freed on its stream, so the
        # caching allocator orders their reuse behind its kernel
        with torch.cuda.device(dev), torch.cuda.stream(stream):
            result = pack(rows, dev)
            done = torch.cuda.Event()
            done.record(stream)
        shards.append((dev, result, done))
    if side_streams:
        # everything after this reads the shards' results on each device's
        # current stream: wait for the shard, and tell the allocator so it
        # does not hand the results' memory back to the shard's stream early
        for dev, result, done in shards:
            current = torch.cuda.current_stream(dev)
            current.wait_event(done)
            for t in result:
                t.record_stream(current)

    # -- model shards: the cheapest type of each slice, reduced per row ----
    T = usable.shape[0]
    width = T // model
    picks = []
    for i, ((dev0, result, _), row) in enumerate(zip(shards, mesh.devices)):
        rows = slice(i * per, (i + 1) * per)
        parts = []
        for j, dev in enumerate(row):
            types = slice(j * width, (j + 1) * width)
            part = _cheapest_part(
                result.node_req.to(dev), result.node_sig.to(dev),
                _upload(sig_type_mask[rows, :, types], torch.bool, dev),
                _upload(usable[types], torch.float32, dev),
                _upload(prices[types], torch.float32, dev),
                offset=j * width,
            )
            parts.append(tuple(t.to(dev0) for t in part))
        picks.append(_reduce_parts(parts))

    if data == 1:
        return shards[0][1], picks[0], report
    first = mesh.first
    out = PackResult(*(torch.cat([r[k].to(first) for _, r, _ in shards])
                       for k in range(len(PackResult._fields))))
    cheapest = torch.cat([p.to(first) for p in picks])
    return out, cheapest, report
