"""``pack_first_fit_v2``: the first-fit recurrence over per-core join tables,
on the card, and the host side it needs.

Constraint-diverse batches (many signatures S times a wide capacity
frontier F) take this kernel. The host folds the join table and the
frontiers into three per-core tables once per closure (``_precompute``,
byte for byte the reference package's): the joined-frontier limits
``front_j[c, f·R + r, s]``, the joinability ``compat_j[c, 0, s]`` and the
joined id ``jvals[c, 0, s]``. The kernel walks a signature-major copy of
the limits, ``front_s = signature_major(front_j)`` (``[C, S_pad, FRp]``, the
rows of one column contiguous), which ``fused.DeviceInvariants`` keeps
beside the tables. The CUDA source ``csrc/pack_first_fit_v2.cu`` replaces
``karpenter_tpu/solver/pallas_kernel_v2.py::_pack_kernel_v2`` and carries
the note on what bounds it; ``pack_kernel.build()`` builds it with the
port's other kernel.

``pack_first_fit_v2`` takes the TPU kernel's inputs, each optionally with
a shared leading batch axis B (one thread block per problem). For CUDA
tensors it launches the kernel or raises; for CPU tensors it runs the plain
version ``kernel.pack_v2_reference`` (per problem). It counts its launches
in ``launches``.

``fused_route`` is the card's routing gate between the two kernels, a pure
function of the tables' shapes.

``pack_unfused_v2`` is the unfused caller (the reference's
``pack_pallas_v2``): from ``pack_args()`` tensors, one problem or a stack
of them, it builds the tables on the host per call and the kernel's inputs
(``v2_args``, which the multi-solve shares) and launches
``pack_first_fit_v2`` once; ``pack_kernel.pack_best`` takes it for batches
the fused route does not.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from karpenter_tpu_torch import obs
from karpenter_tpu_torch.solver import pack_kernel
from karpenter_tpu_torch.solver.kernel import PackResult, pack_v2_reference

NEG = -1e30  # "incompatible" frontier limit: nothing fits

# S·F past which the reference leaves its v1 (unrolled) TPU kernel for v2;
# kept so both packages send the same batches down the same route
PALLAS_UNROLL_BUDGET = 1024

# Bytes of one problem's three v2 tables that the v2 route takes. The kernel
# reads front_s[core, node_sig, :] (front_j's signature-major copy, as large)
# from device memory on every fit test, so
# the tables should stay resident in the H100's 50 MB L2; 32 MiB of it leaves
# room for the node table, the pod side and the surrounding torch ops. The
# 400-type team mix (S=65, C=64, F·R=800) needs 26.7 MB and fits; 256 teams
# (S=257, C=256) need 321 MB and take v1, which reads the compact [S, F, R]
# frontiers instead.
V2_TABLE_BUDGET = 32 << 20

# kernel launches made by pack_first_fit_v2 (CPU calls do not count)
launches = 0  # guarded-by: pack_kernel.launch_count_lock


def _pad_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _precompute(join_table: np.ndarray, frontiers: np.ndarray):
    """Host-side per-core tables. join_table [S, C] i32; frontiers [S, F, R]."""
    S, C = join_table.shape
    F, R = frontiers.shape[1], frontiers.shape[2]
    FR = F * R
    S_pad = _pad_to(max(S, 8), 128)  # lane axis of the per-core tables
    C_pad = max(C, 1)

    flat = frontiers.reshape(S, FR).astype(np.float32)

    front_j = np.full((C_pad, _pad_to(FR, 8), S_pad), NEG, np.float32)
    compat_j = np.zeros((C_pad, 8, S_pad), np.float32)
    jvals = np.zeros((C_pad, 8, S_pad), np.float32)
    for c in range(C):
        j = join_table[:, c]  # [S]
        ok = j >= 0
        compat_j[c, 0, :S] = ok.astype(np.float32)
        jvals[c, 0, :S] = np.where(ok, j, 0).astype(np.float32)
        gathered = np.where(ok[:, None], flat[np.clip(j, 0, S - 1)], NEG)  # [S, FR]
        front_j[c, :FR, :S] = gathered.T
    return front_j, compat_j, jvals, S_pad


def signature_major(front_j: torch.Tensor) -> torch.Tensor:
    """``front_j [..., C, FRp, S_pad]`` as ``front_s [..., C, S_pad, FRp]``:
    ``front_s[c, s, f·R + r] == front_j[c, f·R + r, s]``, so the frontier
    rows of one (core, signature) column are contiguous. A copy on
    ``front_j``'s device."""
    return front_j.transpose(-1, -2).contiguous()


def v2_table_bytes(S: int, F: int, R: int, C: int) -> int:
    """Bytes of ``_precompute``'s three tables for one problem."""
    S_pad = _pad_to(max(S, 8), 128)
    return max(C, 1) * (_pad_to(F * R, 8) + 16) * S_pad * 4


def v2_tables_fit(S: int, F: int, R: int, C: int) -> bool:
    return v2_table_bytes(S, F, R, C) <= V2_TABLE_BUDGET


def fused_route(S: int, F: int, R: int, C: int) -> str:
    """``"v2"`` for a batch past the v1 budget whose tables fit the card's
    budget, else ``"v1"``. ``pack_first_fit`` has no unroll budget, so this
    is routing by shape, never a fallback on failure."""
    if S * F > PALLAS_UNROLL_BUDGET and v2_tables_fit(S, F, R, C):
        return "v2"
    return "v1"


def kernel_inputs(
    pod_valid, pod_open_sig, pod_core, pod_host, pod_host_in_base, pod_open_host,
    pod_req, frontiers, daemon, front_j, compat_j, jvals,
) -> tuple:
    """``pack_first_fit_v2``'s seven inputs for one problem: the per-pod
    arrays of ``pack_args()`` as the [6, P] scalar table and the [R, P]
    requests, the tables, and each pod's fresh-node fit — does ``daemon +
    req`` (f32 sum) fit ANY frontier row of its open signature? That is
    independent of node state, so it is computed once per batch before the
    kernel (the reference's ``_open_fits_host``)."""
    need = pod_req + daemon[None, :]  # [P, R]
    limits = frontiers[pod_open_sig.long()]  # [P, F, R]
    open_fits = (need[:, None, :] <= limits).all(-1).any(-1)
    pod_scal = torch.stack([
        pod_valid.to(torch.int32), pod_open_sig.to(torch.int32), pod_core.to(torch.int32),
        pod_host.to(torch.int32), pod_host_in_base.to(torch.int32),
        pod_open_host.to(torch.int32),
    ])
    return (
        pod_scal,
        pod_req.t().contiguous(),
        front_j,
        compat_j,
        jvals,
        open_fits.to(torch.int32).reshape(1, -1),
        daemon.reshape(-1, 1),
    )


def v2_args(
    pod_valid, pod_open_sig, pod_core, pod_host, pod_host_in_base, pod_open_host,
    pod_req, join_table, frontiers, daemon,
) -> tuple:
    """``pack_first_fit_v2``'s seven inputs from ``pack_args()`` tensors,
    each optionally with a shared leading batch axis: the per-core tables
    from ``_precompute`` on the host (per call, nothing cached; once per
    distinct catalog of a batch), the rest by ``kernel_inputs`` on the
    tensors' device, stacked per problem."""
    args = (pod_valid, pod_open_sig, pod_core, pod_host, pod_host_in_base, pod_open_host,
            pod_req, join_table, frontiers, daemon)
    dev = pod_req.device
    joins, fronts = join_table.cpu().numpy(), frontiers.cpu().numpy()
    if pod_req.dim() == 2:
        tables = _precompute(joins, fronts)[:3]
        return kernel_inputs(*args[:7], frontiers, daemon,
                             *(torch.from_numpy(t).to(dev) for t in tables))
    built = []  # (join_table, frontiers, tables on dev) per distinct catalog
    per_problem = []
    for b in range(pod_req.shape[0]):
        tables = next((t for j, f, t in built
                       if np.array_equal(j, joins[b]) and np.array_equal(f, fronts[b])), None)
        if tables is None:
            tables = [torch.from_numpy(t).to(dev) for t in _precompute(joins[b], fronts[b])[:3]]
            built.append((joins[b], fronts[b], tables))
        per_problem.append(kernel_inputs(*(a[b] for a in args[:7]), frontiers[b], daemon[b],
                                         *tables))
    return tuple(torch.stack(col) for col in zip(*per_problem))


def pack_unfused_v2(*args, n_max: int) -> PackResult:
    """The unfused caller (the reference's ``pack_pallas_v2``):
    ``kernel.pack_reference``'s contract over ``pack_args()`` tensors,
    each optionally with a shared leading batch axis. Builds the v2 inputs
    (``v2_args``) and runs ``pack_first_fit_v2`` once, which on the card
    walks a signature-major copy of the limits made for this call."""
    F, R = args[8].shape[-2], args[8].shape[-1]
    return pack_first_fit_v2(*v2_args(*args), n_max=n_max, F=F, R=R)


_SPEC = (
    # name, dtype, rank
    ("pod_scal", torch.int32, 2),
    ("pod_req", torch.float32, 2),
    ("front_j", torch.float32, 3),
    ("compat_j", torch.float32, 3),
    ("jvals", torch.float32, 3),
    ("open_fits", torch.int32, 2),
    ("daemon", torch.float32, 2),
)


def _check(args, n_max: int, F: int, R: int):
    dev, batch = pack_kernel.check_tensors("pack_first_fit_v2", _SPEC, args)
    shapes = [tuple(a.shape[1:] if batch is not None else a.shape) for a in args]
    (six, P), (r_req, p_req), (C, FRp, S_pad) = shapes[0], shapes[1], shapes[2]
    if not all(isinstance(v, int) and v >= 1 for v in (n_max, F, R)):
        raise ValueError(f"n_max, F and R must be positive ints, got {n_max!r}, {F!r}, {R!r}")
    if six != 6 or P < 1:
        raise ValueError(f"pod_scal must be [6, P] with P >= 1, got {shapes[0]}")
    if (r_req, p_req) != (R, P):
        raise ValueError(f"pod_req {shapes[1]} does not match R={R}, P={P}")
    if C < 1 or S_pad < 1 or _pad_to(F * R, 8) > FRp:
        raise ValueError(f"front_j {shapes[2]} does not hold F·R={F * R} rows")
    for name, shape in (("compat_j", shapes[3]), ("jvals", shapes[4])):
        if shape[0] != C or shape[1] < 1 or shape[2] != S_pad:
            raise ValueError(f"{name} {shape} does not match front_j's C={C}, S_pad={S_pad}")
    if shapes[5] != (1, P):
        raise ValueError(f"open_fits {shapes[5]} is not [1, {P}]")
    if shapes[6] != (R, 1):
        raise ValueError(f"daemon {shapes[6]} is not [{R}, 1]")
    # The kernel indexes the tables with the pods' cores, their open
    # signatures and the joined ids unchecked; one host sync holds them to
    # the tables' C and S_pad (a joined id is rounded, so it must stay below
    # S_pad - 0.5). Negative signatures mark unopened nodes and are safe.
    scal = args[0]
    open_hi, core_lo, core_hi, joined_hi = torch.stack([
        scal[..., 1, :].max().to(torch.float32),
        scal[..., 2, :].min().to(torch.float32),
        scal[..., 2, :].max().to(torch.float32),
        args[4][..., 0, :].max(),
    ]).tolist()
    if not (open_hi < S_pad and joined_hi < S_pad - 0.5):
        raise ValueError(f"signature ids reach {max(open_hi, joined_hi)}, past S_pad={S_pad}")
    if not (0 <= core_lo and core_hi < C):
        raise ValueError(f"pod cores span [{core_lo}, {core_hi}], outside [0, {C})")
    return dev, batch


def _check_front_s(front_j: torch.Tensor, front_s: torch.Tensor) -> None:
    want = front_j.shape[:-2] + (front_j.shape[-1], front_j.shape[-2])
    if not isinstance(front_s, torch.Tensor) or front_s.dtype != torch.float32:
        raise TypeError("front_s must be a float32 torch.Tensor")
    if front_s.shape != want or not front_s.is_contiguous() or front_s.device != front_j.device:
        raise ValueError(
            f"front_s must be a contiguous {tuple(want)} tensor on {front_j.device} "
            f"(signature_major(front_j)), got {tuple(front_s.shape)} on {front_s.device}"
        )


def pack_first_fit_v2(
    *args, n_max: int, F: int, R: int,
    front_s: Optional[torch.Tensor] = None, plan: Optional[pack_kernel.LaunchPlan] = None,
) -> PackResult:
    """The first-fit recurrence over the v2 tables: ``args`` are
    ``(pod_scal [6, P] i32, pod_req [R, P] f32, front_j [C, FRp, S_pad] f32,
    compat_j [C, 8, S_pad] f32, jvals [C, 8, S_pad] f32, open_fits [1, P]
    i32, daemon [R, 1] f32)``, each optionally with a shared leading batch
    axis. Signature ids in ``pod_scal`` and ``jvals`` must be below S_pad
    and cores below C (checked under the ``pack.check`` span, which reads
    their range back from the card before the launch). On the card the kernel walks ``front_s``,
    which must be ``signature_major(front_j)`` (its shape is checked, not
    its content); without it the call makes that copy. ``plan`` overrides
    ``pack_kernel.launch_plan(F, R, n_max)``. Returns ``kernel.pack``'s
    PackResult with ``n_max`` node slots."""
    global launches
    with obs.tracer().child_span("pack.check"):
        dev, batch = _check(args, n_max, F, R)
    if front_s is not None:
        _check_front_s(args[2], front_s)
    if dev.type == "cpu":
        return pack_kernel.per_problem(pack_v2_reference, args, batch, n_max=n_max, F=F, R=R)
    if R > pack_kernel.MAX_R:
        raise ValueError(f"pack_first_fit_v2 takes at most {pack_kernel.MAX_R} resource axes, got {R}")
    P = args[0].shape[-1]
    C, FRp, S_pad = args[2].shape[-3:]
    rows = args[3].shape[-2]
    if rows != 8 or args[4].shape[-2] != 8:
        raise ValueError(f"the kernel reads compat_j and jvals as [C, 8, S_pad], got {rows} rows")
    if front_s is None:
        front_s = signature_major(args[2])
    plan = plan or pack_kernel.launch_plan(F, R, n_max)
    lib = pack_kernel.build()["pack_first_fit_v2"]
    out = pack_kernel.new_result(batch, P, n_max, R, dev)
    ptrs = [a.data_ptr() for a in args]
    ptrs[2] = front_s.data_ptr()  # the walk reads the copy, never front_j
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.pack_first_fit_v2_launch(
            *ptrs, *(o.data_ptr() for o in out),
            batch or 1, P, C, FRp, S_pad, F, R, n_max,
            plan.threads, plan.G, int(plan.node_state_in_smem), plan.smem_bytes, stream,
        )
    pack_kernel.check_launch("pack_first_fit_v2", err)
    with pack_kernel.launch_count_lock:
        launches += 1
    return out
