"""``pack_first_fit``: the first-fit packing recurrence on the card, and the
build of every CUDA kernel of the port.

The CUDA sources live in ``csrc/``: ``pack_first_fit.cu`` replaces
``karpenter_tpu/solver/pallas_kernel.py::_pack_kernel`` and
``pack_first_fit_v2.cu`` (wrapped by ``pack_kernel_v2``) replaces
``pallas_kernel_v2.py::_pack_kernel_v2``; each carries the note on what
bounds it and how its design answers that. ``build()`` compiles them at
first use, one ``nvcc`` per source, all started together, into shared
libraries with a plain C interface, and loads them with ``ctypes``. Kernels
launch on PyTorch's current stream.

The build lands in ``build/karpenter_tpu_torch/<sources hash>/`` at the
root of the checkout (listed in ``.gitignore``), keyed on the content of
every source and the flags, so a fresh checkout builds everything it runs
and an edited source never loads a stale library.

``pack_first_fit`` has ``kernel.pack``'s contract. Its inputs may carry
one shared leading batch axis B: the kernel then solves B independent
problems, one thread block each, in one launch. For CUDA tensors it
launches the kernel or raises; for CPU tensors it runs the plain version
``kernel.pack_reference`` (per problem). It counts its launches in
``launches``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

from karpenter_tpu_torch.solver.kernel import PackResult, pack_reference

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

_vp, _ci = ctypes.c_void_p, ctypes.c_int
# argtypes of each library's `<name>_launch` (pointers, ints, the stream);
# it returns cudaGetLastError() as an int
_LAUNCH_ARGTYPES = {
    "pack_first_fit": [_vp] * 15 + [_ci] * 7 + [_vp],
    "pack_first_fit_v2": [_vp] * 12 + [_ci] * 8 + [_vp],
}

# kernel launches made by pack_first_fit (CPU calls do not count)
launches = 0

_libs: Dict[str, ctypes.CDLL] = {}  # guarded-by: _build_lock
_build_logs: Dict[str, str] = {}  # guarded-by: _build_lock
_build_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the port's kernels")


def build() -> Dict[str, ctypes.CDLL]:
    """Compile (once per content of the sources) and load every kernel
    library; returns them by kernel name. A failed build raises."""
    with _build_lock:
        if _libs:
            return _libs
        digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for name, src in sorted(SOURCES.items()):
            digest.update(name.encode() + b"\0" + src.read_bytes())
        out_dir = BUILD_ROOT / digest.hexdigest()[:16]
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
    return dev, batch


def pack_first_fit(*args, n_max: int) -> PackResult:
    """``kernel.pack``'s contract over torch tensors: ``args`` in
    ``EncodedBatch.pack_args()`` order, each optionally with a shared
    leading batch axis, and ``n_max`` node slots per problem."""
    global launches
    dev, batch = _check(args, n_max)
    if dev.type == "cpu":
        return per_problem(pack_reference, args, batch, n_max=n_max)
    P, R = args[6].shape[-2:]
    S, C = args[7].shape[-2:]
    F = args[8].shape[-2]
    if R > MAX_R:
        raise ValueError(f"pack_first_fit takes at most {MAX_R} resource axes, got {R}")
    lib = build()["pack_first_fit"]
    out = new_result(batch, P, n_max, R, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.pack_first_fit_launch(
            *(a.data_ptr() for a in args), *(o.data_ptr() for o in out),
            batch or 1, P, S, C, F, R, n_max, stream,
        )
    check_launch("pack_first_fit", err)
    launches += 1
    return out
