"""``pack_first_fit``: the first-fit packing recurrence on the card, and the
build and launch plan of every CUDA kernel of the port.

The CUDA sources live in ``csrc/``: ``pack_first_fit.cu`` replaces
``karpenter_tpu/solver/pallas_kernel.py::_pack_kernel`` and
``pack_first_fit_v2.cu`` (wrapped by ``pack_kernel_v2``) replaces
``pallas_kernel_v2.py::_pack_kernel_v2``. Both include the shared skeleton
``first_fit.cuh``; each carries the note on what bounds it and how its
design answers that. ``build()`` compiles them at first use, one ``nvcc``
per kernel source, all started together, into shared libraries with a plain
C interface, and loads them with ``ctypes``. Kernels launch on PyTorch's
current stream.

The build lands in ``build/karpenter_tpu_torch/<hash>/`` at the root of the
checkout (listed in ``.gitignore``), keyed on the content of every file
under ``csrc/`` (sources and headers) and the flags, so a fresh checkout
builds everything it runs and an edited source or header never loads a
stale library.

``launch_plan`` is the host's choice of block size, lanes per node slot and
where the node table lives, shared by both wrappers; the kernels check it
against their own layout.

``pack_first_fit`` has ``kernel.pack``'s contract. Its inputs may carry
one shared leading batch axis B: the kernel then solves B independent
problems, one thread block each, in one launch. For CUDA tensors it
launches the kernel or raises; for CPU tensors it runs the plain version
``kernel.pack_reference`` (per problem). It counts its launches in
``launches``.

``pack_best`` is the card's unfused kernel ladder over ``pack_args()``
tensors (one problem, or a stack of them in one launch): ``pack_first_fit``
or the unfused v2 caller by shape, the other kernel when a launch raises
(its shape memoized in ``_failed_shapes``). Which rung a solve asks for
(``KARPENTER_PACKER``) and the host packers are the backend's
(``backend.pack_unfused``).
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from karpenter_tpu_torch.solver.kernel import PackResult, pack_reference

logger = logging.getLogger("karpenter.solver")

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = {
    "pack_first_fit": CSRC / "pack_first_fit.cu",
    "pack_first_fit_v2": CSRC / "pack_first_fit_v2.cu",
}
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "karpenter_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
MAX_R = 64  # resource axes the kernels' shared-memory staging takes

# Shared memory one block may use on sm_90 (227 KB), and the kernels'
# static part of it: the per-warp minima, double-buffered, for 32 warps.
SMEM_LIMIT = 232_448
STATIC_SMEM = 2 * 32 * 4
MAX_THREADS = 1024
MAX_THREADS_PER_SLOT = 512  # G = 1: the kernel's launch bound leaves more registers
MIN_THREADS = 128

_vp, _ci = ctypes.c_void_p, ctypes.c_int
# argtypes of each library's `<name>_launch` (pointers, ints, the stream);
# it returns cudaGetLastError() as an int
_LAUNCH_ARGTYPES = {
    "pack_first_fit": [_vp] * 15 + [_ci] * 11 + [_vp],
    "pack_first_fit_v2": [_vp] * 12 + [_ci] * 12 + [_vp],
}

# kernel launches made by pack_first_fit (CPU calls do not count); the
# sidecar launches from several threads, so both wrappers count under the lock
launches = 0  # guarded-by: launch_count_lock
launch_count_lock = threading.Lock()

_libs: Dict[str, ctypes.CDLL] = {}  # guarded-by: _build_lock
_build_logs: Dict[str, str] = {}  # guarded-by: _build_lock
_build_lock = threading.Lock()


class LaunchPlan(NamedTuple):
    threads: int  # threads per block, a power of two
    G: int  # lanes per node slot, a power of two, 1..32
    node_state_in_smem: bool  # node table in shared memory (else device memory)
    smem_bytes: int  # dynamic shared memory per block


def _pow2_at_least(x: int) -> int:
    return 1 << max(0, x - 1).bit_length()


def _stage_bytes(threads: int, R: int) -> int:
    # five i32 rows and two [threads, R] f32 tables of staged pods
    return (5 + 2 * R) * threads * 4


def max_threads(G: int) -> int:
    """The largest block the kernel variant for G lanes per slot takes."""
    return MAX_THREADS if G > 1 else MAX_THREADS_PER_SLOT


def launch_plan(F: int, R: int, n_cap: int, threads: Optional[int] = None) -> LaunchPlan:
    """The launch of either first-fit kernel for F frontier rows, R axes and
    ``n_cap`` node slots. G, the lanes that walk one slot's frontier rows
    together, is the least power of two at least F, at most 32 (G = 1 at
    F = 1 is thread-per-slot). Unless ``threads`` is given, the block holds
    one group per slot up to ``max_threads(G)`` (at least ``MIN_THREADS``),
    halved while the staged pods do not fit. The node table takes shared
    memory when ``n_cap · (2 + R) · 4`` bytes fit beside the staging."""
    if not all(isinstance(v, int) and v >= 1 for v in (F, R, n_cap)):
        raise ValueError(f"F, R and n_cap must be positive ints, got {F!r}, {R!r}, {n_cap!r}")
    G = min(32, _pow2_at_least(F))
    cap = max_threads(G)
    if threads is None:
        threads = min(cap, max(MIN_THREADS, G * _pow2_at_least(n_cap)))
        while threads > 32 and STATIC_SMEM + _stage_bytes(threads, R) > SMEM_LIMIT:
            threads //= 2
    if threads != _pow2_at_least(threads) or not 32 <= threads <= cap:
        raise ValueError(f"threads must be a power of two in [32, {cap}] at G={G}, got {threads}")
    stage = _stage_bytes(threads, R)
    if STATIC_SMEM + stage > SMEM_LIMIT:
        raise ValueError(f"{threads} threads stage {stage} bytes of pods at R={R}: too many")
    nodes = n_cap * (2 + R) * 4
    in_smem = STATIC_SMEM + stage + nodes <= SMEM_LIMIT
    return LaunchPlan(threads, G, in_smem, stage + (nodes if in_smem else 0))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the port's kernels")


def build_dir(csrc: Path = CSRC) -> Path:
    """Where the libraries built from ``csrc`` live: a hash of the flags and
    of every ``.cu`` and ``.cuh`` file there, by name and content."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(p for p in Path(csrc).iterdir() if p.suffix in (".cu", ".cuh")):
        data = path.read_bytes()
        digest.update(f"{path.name}\0{len(data)}\0".encode() + data)
    return BUILD_ROOT / digest.hexdigest()[:16]


def build() -> Dict[str, ctypes.CDLL]:
    """Compile (once per content of the sources) and load every kernel
    library; returns them by kernel name. A failed build raises."""
    with _build_lock:
        if _libs:
            return _libs
        out_dir = build_dir()
        missing = [n for n in SOURCES if not (out_dir / f"lib{n}.so").exists()]
        if missing:
            out_dir.mkdir(parents=True, exist_ok=True)
            nvcc = _nvcc()
            procs = {}
            for name in missing:
                tmp = out_dir / f"lib{name}.{os.getpid()}.tmp.so"
                procs[name] = (tmp, subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])],
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                ))
            failures = []
            for name, (tmp, proc) in procs.items():
                out, err = proc.communicate()
                if proc.returncode != 0:
                    failures.append(f"nvcc failed for {SOURCES[name].name}:\n{out}{err}")
                    continue
                (out_dir / f"{name}.build.log").write_text(out + err)
                os.replace(tmp, out_dir / f"lib{name}.so")
            if failures:
                raise RuntimeError("\n".join(failures))
        for name in SOURCES:
            lib = ctypes.CDLL(str(out_dir / f"lib{name}.so"))
            launch = getattr(lib, f"{name}_launch")
            launch.argtypes = _LAUNCH_ARGTYPES[name]
            launch.restype = _ci
            log = out_dir / f"{name}.build.log"
            _build_logs[name] = log.read_text() if log.exists() else ""
            _libs[name] = lib
        return _libs


def build_log(name: str) -> str:
    """What ``nvcc -Xptxas -v`` reported for one loaded kernel library
    (registers, shared memory, spills)."""
    return _build_logs.get(name, "")


def check_tensors(kernel: str, spec, args) -> Tuple[torch.device, Optional[int]]:
    """Validate ``args`` against ``spec`` — ``(name, dtype, rank)`` per
    input: dtype, rank (or rank + 1 when every input carries the same
    leading batch axis), contiguous strided layout, one device (cuda or
    cpu). Returns ``(device, B)``, ``B`` None for an unbatched call."""
    if len(args) != len(spec):
        raise TypeError(f"{kernel} takes {len(spec)} tensors, got {len(args)}")
    dev, batch = None, ()
    for (name, dtype, rank), a in zip(spec, args):
        if not isinstance(a, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(a).__name__}")
        if a.dtype != dtype or a.dim() not in (rank, rank + 1):
            raise TypeError(
                f"{name} must be a rank-{rank} {dtype} tensor (rank {rank + 1} with a "
                f"batch axis), got rank-{a.dim()} {a.dtype}"
            )
        b = a.shape[0] if a.dim() == rank + 1 else None
        if batch == ():
            batch = b
        elif b != batch:
            raise ValueError(f"{name} has batch axis {b}, the first input {batch}")
        if a.layout != torch.strided or not a.is_contiguous():
            raise ValueError(f"{name} must be a contiguous strided tensor")
        if dev is None:
            dev = a.device
        elif a.device != dev:
            raise ValueError(f"{name} is on {a.device}, the other inputs on {dev}")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if batch is not None and batch < 1:
        raise ValueError(f"empty batch axis: B={batch}")
    return dev, batch


def per_problem(fn, args, batch: Optional[int], **kw) -> PackResult:
    """``fn`` on one problem, or on each of ``batch`` problems with the
    results stacked on a leading axis (the plain versions' batch axis)."""
    if batch is None:
        return fn(*args, **kw)
    outs = [fn(*(a[b] for a in args), **kw) for b in range(batch)]
    return PackResult(*(torch.stack(field) for field in zip(*outs)))


def new_result(batch: Optional[int], P: int, n_max: int, R: int, dev) -> PackResult:
    """Uninitialised output tensors for a kernel launch (the kernel writes
    every element)."""
    lead = () if batch is None else (batch,)

    def empty(*shape, dtype=torch.int32):
        return torch.empty(lead + shape, dtype=dtype, device=dev)

    return PackResult(
        empty(P), empty(n_max), empty(n_max), empty(n_max, R, dtype=torch.float32), empty()
    )


def check_launch(kernel: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: CUDA error {err}")


_SPEC = (
    # name, dtype, rank
    ("pod_valid", torch.bool, 1),
    ("pod_open_sig", torch.int32, 1),
    ("pod_core", torch.int32, 1),
    ("pod_host", torch.int32, 1),
    ("pod_host_in_base", torch.bool, 1),
    ("pod_open_host", torch.int32, 1),
    ("pod_req", torch.float32, 2),
    ("join_table", torch.int32, 2),
    ("frontiers", torch.float32, 3),
    ("daemon", torch.float32, 1),
)


def _check(args, n_max: int) -> Tuple[torch.device, Optional[int]]:
    dev, batch = check_tensors("pack_first_fit", _SPEC, args)
    shapes = [tuple(a.shape[1:] if batch is not None else a.shape) for a in args]
    P, R = shapes[6]
    S, C = shapes[7]
    if P < 1 or R < 1 or S < 1 or C < 1:
        raise ValueError(f"empty problem: P={P} R={R} S={S} C={C}")
    for (name, _, _), shape in zip(_SPEC[:6], shapes[:6]):
        if shape[0] != P:
            raise ValueError(f"{name} has {shape[0]} pods, pod_req has {P}")
    if shapes[8][0] != S or shapes[8][2] != R or shapes[8][1] < 1:
        raise ValueError(f"frontiers {shapes[8]} do not match S={S}, R={R}")
    if shapes[9][0] != R:
        raise ValueError(f"daemon has {shapes[9][0]} axes, pod_req has {R}")
    if not isinstance(n_max, int) or n_max < 1:
        raise ValueError(f"n_max must be a positive int, got {n_max!r}")
    # The kernel indexes frontiers with every pod's open signature and the
    # join table with the pods' cores and the joined ids, unchecked; one host
    # sync holds them to S and C. Negative join entries mean "does not join".
    open_sig, core, join = args[1], args[2], args[7]
    open_lo, open_hi, core_lo, core_hi, joined_hi = torch.stack([
        open_sig.min(), open_sig.max(), core.min(), core.max(), join.max(),
    ]).tolist()
    if not (0 <= open_lo and open_hi < S):
        raise ValueError(f"open signatures span [{open_lo}, {open_hi}], outside [0, {S})")
    if not (0 <= core_lo and core_hi < C):
        raise ValueError(f"pod cores span [{core_lo}, {core_hi}], outside [0, {C})")
    if not joined_hi < S:
        raise ValueError(f"join_table holds signature id {joined_hi}, past S={S}")
    return dev, batch


def pack_first_fit(*args, n_max: int, plan: Optional[LaunchPlan] = None) -> PackResult:
    """``kernel.pack``'s contract over torch tensors: ``args`` in
    ``EncodedBatch.pack_args()`` order, each optionally with a shared
    leading batch axis, and ``n_max`` node slots per problem. Open
    signatures and joined ids must be below S and cores below C (checked).
    ``plan`` overrides ``launch_plan(F, R, n_max)`` on the card."""
    global launches
    dev, batch = _check(args, n_max)
    if dev.type == "cpu":
        return per_problem(pack_reference, args, batch, n_max=n_max)
    P, R = args[6].shape[-2:]
    S, C = args[7].shape[-2:]
    F = args[8].shape[-2]
    if R > MAX_R:
        raise ValueError(f"pack_first_fit takes at most {MAX_R} resource axes, got {R}")
    plan = plan or launch_plan(F, R, n_max)
    lib = build()["pack_first_fit"]
    out = new_result(batch, P, n_max, R, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.pack_first_fit_launch(
            *(a.data_ptr() for a in args), *(o.data_ptr() for o in out),
            batch or 1, P, S, C, F, R, n_max,
            plan.threads, plan.G, int(plan.node_state_in_smem), plan.smem_bytes, stream,
        )
    check_launch("pack_first_fit", err)
    with launch_count_lock:
        launches += 1
    return out


BLOCK = 128  # the reference's lane block: its v1 rung takes P % BLOCK == 0

# Shapes whose kernel launch raised: (P, n_max) for pack_first_fit and
# ("v2", P, n_max) for pack_first_fit_v2. Only those shapes skip the
# rung, so one pathological batch does not move any other shape off its
# kernel. Solve threads and the router's shadow-probe thread write it
# while other solves read it: read and write under the lock.
_failed_shapes_lock = threading.Lock()
_failed_shapes: set = set()  # guarded-by: _failed_shapes_lock


def pack_best(*args, n_max: int) -> Tuple[str, PackResult]:
    """The card's kernel ladder: ``kernel.pack_reference``'s contract over
    ``pack_args()`` tensors, each optionally with a shared leading batch
    axis → ``(kernel that served, PackResult)``, one launch for the whole
    batch. On CUDA tensors: ``pack_first_fit`` when P % 128 == 0 and
    S·F ≤ 1024, else the unfused v2 caller when the v2 tables fit the
    card's budget, else ``pack_first_fit`` (where the reference falls to
    lax.scan). A kernel whose launch raises puts its shape in the failed
    memo and the ladder moves to the other kernel; it never ends in the
    plain version, and raises when no kernel served. On CPU tensors, the
    plain version (``pack_reference``, per problem)."""
    if args[6].device.type != "cuda":
        batch = args[6].shape[0] if args[6].dim() == 3 else None
        return "pack_reference", per_problem(pack_reference, args, batch, n_max=n_max)
    return _kernel_ladder(*args, n_max=n_max)


def _kernel_ladder(*args, n_max: int) -> Tuple[str, PackResult]:
    """``pack_best``'s rungs for CUDA tensors: the two kernels in the
    shape's order (read from the trailing axes, so a stacked batch is one
    launch of one rung), each skipped once its shape failed; raises when
    neither served."""
    from karpenter_tpu_torch.solver import pack_kernel_v2

    P, R = args[6].shape[-2:]
    S, F = args[8].shape[-3], args[8].shape[-2]
    C = args[7].shape[-1]
    v2_fits = pack_kernel_v2.v2_tables_fit(S, F, R, C)
    if P % BLOCK == 0 and S * F <= pack_kernel_v2.PALLAS_UNROLL_BUDGET:
        order = ("v1", "v2") if v2_fits else ("v1",)
    elif v2_fits:
        order = ("v2", "v1")
    else:
        order = ("v1",)
    rungs = {
        "v1": ((P, n_max), "pack_first_fit", lambda: pack_first_fit(*args, n_max=n_max)),
        "v2": (("v2", P, n_max), "pack_first_fit_v2",
               lambda: pack_kernel_v2.pack_unfused_v2(*args, n_max=n_max)),
    }
    for rung in order:
        shape, name, run = rungs[rung]
        with _failed_shapes_lock:
            if shape in _failed_shapes:
                continue
        try:
            return name, run()
        except Exception:
            logger.exception("%s failed for shape %s; next kernel", name, shape)
            with _failed_shapes_lock:
                _failed_shapes.add(shape)
    raise RuntimeError(
        f"no kernel served P={P} S={S} F={F} n_max={n_max}: "
        f"{' and '.join(rungs[r][1] for r in order)} failed for this shape"
    )
