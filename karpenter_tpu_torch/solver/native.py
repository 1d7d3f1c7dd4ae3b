"""ctypes binding for the native (C++) first-fit packer.

The shared library is compiled from ``csrc/ffd_pack.cpp`` at first use,
with the host's ``g++`` (``-O3 -shared -fPIC``: no ``-march=native`` and no
fast math, so the f32 totals and ``<=`` compares are the kernels'), on a
background thread that the first ``native_available()`` starts: a first
solve never waits out the compile. ``utils.native_build`` builds it into
``build/karpenter_tpu_torch/native-<hash of the source and flags>/`` at the
root of the checkout.

``pack_native`` has ``kernel.pack_reference``'s contract and returns its
``PackResult`` over host numpy arrays. A ``device="cpu"`` scheduler's cost
router weighs it against the plain versions (``backend.TorchScheduler
._pack``); ``backend.pack_unfused`` serves with it when
``KARPENTER_PACKER=native`` forces it (on either device), and on CPU
tensors when it is built. On the card it serves only when forced. It is
host code: it counts no kernel launch.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from karpenter_tpu_torch.solver.kernel import PackResult
from karpenter_tpu_torch.utils import native_build

SRC = Path(__file__).resolve().parent / "csrc" / "ffd_pack.cpp"
GXX_FLAGS = ("-O3", "-shared", "-fPIC")
LIB = native_build.Artifact(
    "native", "g++", GXX_FLAGS, SRC.parent, {"libffd_pack.so": SRC.name}, timeout=120)

# pack_native calls that reached the library (host code: no kernel launch)
calls = 0


def lib_path() -> Path:
    """Where the library built from ``SRC`` with ``GXX_FLAGS`` lives."""
    return LIB.directory / "libffd_pack.so"


def _load() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(LIB.build() / "libffd_pack.so"))
    i32p = ctypes.POINTER(ctypes.c_int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.ffd_pack.restype = ctypes.c_int32
    lib.ffd_pack.argtypes = [
        u8p, i32p, i32p, i32p, u8p, i32p, f32p, i32p, f32p, f32p,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32,
        i32p, i32p, i32p, f32p,
    ]
    return lib


_loader = native_build.Loader("native packer", _load, daemon=True)


def native_available(wait: Optional[float] = None) -> bool:
    """Non-blocking by default: starts the background build and reports
    whether the library is loaded NOW. Pass ``wait`` seconds to block for
    the build."""
    return _loader.get(wait) is not None


def _host(a, dtype) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.ascontiguousarray(np.asarray(a), dtype=dtype)


def pack_native(
    pod_valid,
    pod_open_sig,
    pod_core,
    pod_host,
    pod_host_in_base,
    pod_open_host,
    pod_req,
    join_table,
    frontiers,
    daemon,
    n_max: int,
) -> PackResult:
    """``kernel.pack_reference``'s contract on the host in native code:
    ``pack_args()`` order, numpy arrays or tensors (copied to the host),
    ``n_max`` node slots. Returns the PackResult over numpy arrays. Raises
    when the library is not loaded (yet) or the packer rejects the problem
    (more than 64 resource axes)."""
    global calls
    lib = _loader.get()
    if lib is None:
        raise RuntimeError("native packer unavailable")

    valid = _host(pod_valid, np.uint8)
    open_sig = _host(pod_open_sig, np.int32)
    core = _host(pod_core, np.int32)
    host = _host(pod_host, np.int32)
    host_in_base = _host(pod_host_in_base, np.uint8)
    open_host = _host(pod_open_host, np.int32)
    req = _host(pod_req, np.float32)
    join = _host(join_table, np.int32)
    fr = _host(frontiers, np.float32)
    dm = _host(daemon, np.float32)

    P, R = req.shape
    S, F, _ = fr.shape
    C = join.shape[1]
    assignment = np.empty(P, np.int32)
    node_sig = np.empty(n_max, np.int32)
    node_host = np.empty(n_max, np.int32)
    node_req = np.empty((n_max, R), np.float32)

    def ptr(a, ct):
        return a.ctypes.data_as(ctypes.POINTER(ct))

    count = lib.ffd_pack(
        ptr(valid, ctypes.c_uint8), ptr(open_sig, ctypes.c_int32),
        ptr(core, ctypes.c_int32), ptr(host, ctypes.c_int32),
        ptr(host_in_base, ctypes.c_uint8), ptr(open_host, ctypes.c_int32),
        ptr(req, ctypes.c_float), ptr(join, ctypes.c_int32),
        ptr(fr, ctypes.c_float), ptr(dm, ctypes.c_float),
        P, R, S, C, F, n_max,
        ptr(assignment, ctypes.c_int32), ptr(node_sig, ctypes.c_int32),
        ptr(node_host, ctypes.c_int32), ptr(node_req, ctypes.c_float),
    )
    calls += 1
    if count < 0:
        raise RuntimeError(f"native packer error {count}")
    return PackResult(
        assignment=assignment,
        node_sig=node_sig,
        node_host=node_host,
        node_req=node_req,
        n_nodes=np.int32(count),
    )
