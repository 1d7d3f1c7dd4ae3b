"""``pack_first_fit``: the first-fit packing recurrence on the card.

The CUDA source is ``csrc/pack_first_fit.cu``: it replaces
``karpenter_tpu/solver/pallas_kernel.py::_pack_kernel`` and carries the note
on what bounds it and how its design answers that. This module builds it
at first use with ``nvcc`` into a shared library with a plain C interface,
loads it with ``ctypes``, and launches it on PyTorch's current stream.

The build lands in ``build/karpenter_tpu_torch/<source hash>/`` at the root
of the checkout (listed in ``.gitignore``), keyed on the source's content,
so a fresh checkout builds everything it runs and an edited source never
loads a stale library.

``pack_first_fit`` has ``kernel.pack``'s contract. For CUDA tensors it
launches the kernel or raises; for CPU tensors it runs the plain version
``kernel.pack_reference``. It counts its launches in ``launches``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

from karpenter_tpu_torch.solver.kernel import PackResult, pack_reference

SOURCE = Path(__file__).resolve().parent / "csrc" / "pack_first_fit.cu"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "karpenter_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
MAX_R = 64  # resource axes the kernel's shared-memory staging takes

# kernel launches made by pack_first_fit (CPU calls do not count)
launches = 0

_lib = None
_build_log = ""
_build_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build pack_first_fit")


def build() -> ctypes.CDLL:
    """Compile (once per source content) and load the kernel library."""
    global _lib, _build_log
    with _build_lock:
        if _lib is not None:
            return _lib
        src = SOURCE.read_bytes()
        digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        out_dir = BUILD_ROOT / digest
        so = out_dir / "libpack_first_fit.so"
        log = out_dir / "build.log"
        if not so.exists():
            out_dir.mkdir(parents=True, exist_ok=True)
            tmp = out_dir / f"libpack_first_fit.{os.getpid()}.tmp.so"
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                capture_output=True, text=True,
            )
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed for {SOURCE.name}:\n{proc.stdout}{proc.stderr}"
                )
            log.write_text(proc.stdout + proc.stderr)
            os.replace(tmp, so)
        _build_log = log.read_text() if log.exists() else ""
        lib = ctypes.CDLL(str(so))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.pack_first_fit_launch.argtypes = [vp] * 15 + [ci] * 7 + [vp]
        lib.pack_first_fit_launch.restype = ci
        lib.pack_first_fit_smem_bytes.argtypes = [ci]
        lib.pack_first_fit_smem_bytes.restype = ci
        _lib = lib
        return lib


def build_log() -> str:
    """What ``nvcc -Xptxas -v`` reported for the loaded build (registers,
    shared memory, spills)."""
    return _build_log


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


def _check(args, n_max: int) -> torch.device:
    if len(args) != len(_SPEC):
        raise TypeError(f"pack_first_fit takes {len(_SPEC)} tensors, got {len(args)}")
    dev = None
    for (name, dtype, rank), a in zip(_SPEC, args):
        if not isinstance(a, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(a).__name__}")
        if a.dtype != dtype or a.dim() != rank:
            raise TypeError(
                f"{name} must be a rank-{rank} {dtype} tensor, got rank-{a.dim()} {a.dtype}"
            )
        if a.layout != torch.strided or not a.is_contiguous():
            raise ValueError(f"{name} must be a contiguous strided tensor")
        if dev is None:
            dev = a.device
        elif a.device != dev:
            raise ValueError(f"{name} is on {a.device}, the other inputs on {dev}")
    P, R = args[6].shape
    S, C = args[7].shape
    if P < 1 or R < 1 or S < 1 or C < 1:
        raise ValueError(f"empty problem: P={P} R={R} S={S} C={C}")
    for name, a in zip((s[0] for s in _SPEC[:6]), args[:6]):
        if a.shape[0] != P:
            raise ValueError(f"{name} has {a.shape[0]} pods, pod_req has {P}")
    if args[8].shape[0] != S or args[8].shape[2] != R or args[8].shape[1] < 1:
        raise ValueError(f"frontiers {tuple(args[8].shape)} do not match S={S}, R={R}")
    if args[9].shape[0] != R:
        raise ValueError(f"daemon has {args[9].shape[0]} axes, pod_req has {R}")
    if not isinstance(n_max, int) or n_max < 1:
        raise ValueError(f"n_max must be a positive int, got {n_max!r}")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def pack_first_fit(*args, n_max: int) -> PackResult:
    """``kernel.pack``'s contract over torch tensors: ``args`` in
    ``EncodedBatch.pack_args()`` order, ``n_max`` node slots."""
    global launches
    dev = _check(args, n_max)
    if dev.type == "cpu":
        return pack_reference(*args, n_max=n_max)
    P, R = args[6].shape
    S, C = args[7].shape
    F = args[8].shape[1]
    if R > MAX_R:
        raise ValueError(f"pack_first_fit takes at most {MAX_R} resource axes, got {R}")
    lib = build()
    assignment = torch.empty((P,), dtype=torch.int32, device=dev)
    node_sig = torch.empty((n_max,), dtype=torch.int32, device=dev)
    node_host = torch.empty((n_max,), dtype=torch.int32, device=dev)
    node_req = torch.empty((n_max, R), dtype=torch.float32, device=dev)
    n_nodes = torch.empty((), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.pack_first_fit_launch(
            *(a.data_ptr() for a in args),
            assignment.data_ptr(), node_sig.data_ptr(), node_host.data_ptr(),
            node_req.data_ptr(), n_nodes.data_ptr(),
            1, P, S, C, F, R, n_max, stream,
        )
    if err != 0:
        raise RuntimeError(f"pack_first_fit launch failed: CUDA error {err}")
    launches += 1
    return PackResult(assignment, node_sig, node_host, node_req, n_nodes)
