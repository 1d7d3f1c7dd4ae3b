"""Build and load the native statics pass (``csrc/statics_native.cpp``).

The extension is a CPython module written by hand in C++: ``statics_pass``
builds the ``PodStatics`` of a list of pods in one call, the same objects
``statics._build`` gives (``scheduling/statics.py`` passes it the tables
and constants it reads). It is compiled with the host's ``g++`` against the
running interpreter's headers (``sysconfig``), at ``-O2`` with no fast
math, on a background thread that ``start()`` begins when
``scheduling.statics`` is imported, so the compile overlaps the rest of a
process's imports and a first solve never waits for it. The module lands in
``build/karpenter_tpu_torch/statics-<hash of the source, the flags and the
interpreter>/`` at the root of the checkout (listed in ``.gitignore``),
compiled to a temporary name and renamed into place, so processes sharing
the checkout never load a half-written file. Until it is loaded, or where
it cannot be built (no compiler, no headers), the Python ``_build`` serves
with the same results.
"""

from __future__ import annotations

import hashlib
import importlib.util
import logging
import os
import shutil
import subprocess
import sys
import sysconfig
import threading
from pathlib import Path
from types import ModuleType
from typing import Optional

logger = logging.getLogger("karpenter.scheduling.statics_native")

NAME = "_statics_native"
SRC = Path(__file__).resolve().parent / "csrc" / "statics_native.cpp"
CXX_FLAGS = ("-O2", "-shared", "-fPIC")
# the root ``solver/pack_kernel.py`` builds the card kernels under
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "karpenter_tpu_torch"

_module: Optional[ModuleType] = None  # set once, by the build thread
_lock = threading.Lock()
_thread: Optional[threading.Thread] = None  # guarded-by: _lock


def module_path() -> Path:
    """Where the module built from ``SRC`` for this interpreter lives."""
    include = sysconfig.get_paths()["include"]
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    digest = hashlib.sha256("\0".join(
        (" ".join(CXX_FLAGS), include, suffix, sys.version)).encode() + b"\0" + SRC.read_bytes())
    return BUILD_ROOT / f"statics-{digest.hexdigest()[:16]}" / f"{NAME}{suffix}"


def _compile(path: Path) -> None:
    include = sysconfig.get_paths()["include"]
    if not (Path(include) / "Python.h").exists():
        raise FileNotFoundError(f"no Python.h under {include}")
    cxx = shutil.which("g++")
    if cxx is None:
        raise FileNotFoundError("no g++ on PATH")
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{NAME}.{os.getpid()}.{threading.get_ident()}.tmp")
    subprocess.run(
        [cxx, *CXX_FLAGS, f"-I{include}", "-o", str(tmp), str(SRC)],
        check=True, capture_output=True, timeout=120,
    )
    os.replace(tmp, path)


def _build_and_load() -> None:
    global _module
    try:
        path = module_path()
        if not path.exists():
            _compile(path)
        spec = importlib.util.spec_from_file_location(NAME, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _module = mod
    except (OSError, subprocess.SubprocessError, ImportError) as e:
        detail = getattr(e, "stderr", b"") or b""
        logger.warning("native statics pass unavailable, the Python pass serves: %s %s",
                       e, detail.decode(errors="replace")[-2000:])


def start() -> None:
    """Begin the one background build (and load) if none has begun."""
    global _thread
    with _lock:
        if _thread is None:
            _thread = threading.Thread(target=_build_and_load, name="statics-native-build")
            _thread.start()


def module(wait: Optional[float] = None) -> Optional[ModuleType]:
    """The loaded extension, or None while it builds or where it cannot be
    built. ``wait`` seconds blocks for the build first."""
    if wait is not None:
        start()
        with _lock:
            thread = _thread
        thread.join(timeout=wait)
    return _module
