"""ctypes binding for the native (C++) first-fit packer.

The shared library is compiled from ``csrc/ffd_pack.cpp`` at first use,
with the host's ``g++`` (``-O3 -shared -fPIC``: no ``-march=native`` and no
fast math, so the f32 totals and ``<=`` compares are the kernels'), on a
background thread (``_kick_build``): a first solve never waits out the
compile. The library lands in
``build/karpenter_tpu_torch/native-<hash of the source and flags>/`` at the
root of the checkout (listed in ``.gitignore``); it is compiled to a
temporary name and renamed into place, so processes sharing the checkout
never load a half-written file.

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
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from karpenter_tpu_torch.solver.kernel import PackResult
from karpenter_tpu_torch.solver.pack_kernel import BUILD_ROOT

logger = logging.getLogger("karpenter.solver.native")

SRC = Path(__file__).resolve().parent / "csrc" / "ffd_pack.cpp"
GXX_FLAGS = ("-O3", "-shared", "-fPIC")

# pack_native calls that reached the library (host code: no kernel launch)
calls = 0

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None  # guarded-by: _lock
_load_failed = False  # guarded-by: _lock
_build_thread: Optional[threading.Thread] = None  # guarded-by: _lock


def lib_path() -> Path:
    """Where the library built from ``SRC`` with ``GXX_FLAGS`` lives."""
    digest = hashlib.sha256(" ".join(GXX_FLAGS).encode() + b"\0" + SRC.read_bytes())
    return BUILD_ROOT / f"native-{digest.hexdigest()[:16]}" / "libffd_pack.so"


def _build_and_load() -> None:
    global _lib, _load_failed
    try:
        lib_file = lib_path()
        if not lib_file.exists():
            lib_file.parent.mkdir(parents=True, exist_ok=True)
            tmp = lib_file.with_name(f"libffd_pack.{os.getpid()}.tmp.so")
            subprocess.run(
                ["g++", *GXX_FLAGS, "-o", str(tmp), str(SRC)],
                check=True,
                capture_output=True,
                timeout=120,
            )
            os.replace(tmp, lib_file)
        lib = ctypes.CDLL(str(lib_file))
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
        with _lock:
            _lib = lib
    except Exception:
        logger.exception("native packer unavailable")
        with _lock:
            _load_failed = True


def _kick_build() -> None:
    """Start the (one-time) background build; never blocks the caller —
    a first solve must not wait out a g++ compile."""
    global _build_thread
    with _lock:
        if _lib is not None or _load_failed or (
            _build_thread is not None and _build_thread.is_alive()
        ):
            return
        _build_thread = threading.Thread(
            target=_build_and_load, daemon=True, name="ffd-pack-build"
        )
        _build_thread.start()


def native_available(wait: Optional[float] = None) -> bool:
    """Non-blocking by default: kicks the background build and reports
    whether the library is loaded NOW. Pass ``wait`` seconds to block for
    the build."""
    _kick_build()
    if wait is not None:
        with _lock:
            thread = _build_thread
        if thread is not None:
            thread.join(timeout=wait)
    with _lock:
        return _lib is not None


def _ensure_lib() -> Optional[ctypes.CDLL]:
    _kick_build()
    with _lock:
        return _lib


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
    lib = _ensure_lib()
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
