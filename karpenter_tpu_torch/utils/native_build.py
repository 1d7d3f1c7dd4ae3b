"""Build and load the port's compiled code: the card kernels (``nvcc``), the
native packer, and the CPython extensions of the native statics pass and
the native validate pass (``g++``).

An ``Artifact``'s outputs live in ``BUILD_ROOT/<prefix>-<hash>/`` (git-ignored),
the hash over its flags, extra key parts and each keyed file's name, length
and bytes. ``build()`` compiles the missing outputs together under a thread
lock and a file lock on the directory (processes sharing a checkout compile
once), each to a name unique to its process and thread, renamed into place;
``<source stem>.build.log`` keeps the compiler's output. A ``Loader`` runs a
build-and-load once, on a background thread.
"""

from __future__ import annotations

import dataclasses
import fcntl
import functools
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
from typing import Callable, Dict, Optional, Tuple

logger = logging.getLogger("karpenter.native_build")

BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "karpenter_tpu_torch"
PY_INCLUDE = sysconfig.get_paths()["include"]
EXT_SUFFIX = sysconfig.get_config_var("EXT_SUFFIX") or ".so"


def find_compiler(name: str) -> str:
    """``name`` on ``PATH``, else in ``$CUDA_HOME/bin`` (``/usr/local/cuda``)."""
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / name
    found = shutil.which(name) or (str(cand) if cand.exists() else None)
    if found is None:
        raise FileNotFoundError(f"{name} not found on PATH or under CUDA_HOME")
    return found


@dataclasses.dataclass(frozen=True)
class Artifact:
    """One compiler and its flags over the sources in ``csrc``, one output each."""

    prefix: str
    compiler: str
    flags: Tuple[str, ...]
    csrc: Path
    outputs: Dict[str, str]  # output file name -> its source's file name in csrc
    keyed: Tuple[str, ...] = ()  # globs in csrc the key covers; () is the sources
    key_parts: Tuple[str, ...] = ()
    timeout: Optional[float] = None  # seconds one compile may take
    _lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, init=False, repr=False, compare=False)

    @functools.cached_property
    def directory(self) -> Path:
        digest = hashlib.sha256(repr((self.flags, self.key_parts)).encode())
        globs = self.keyed or tuple(self.outputs.values())
        for path in sorted({p for g in globs for p in self.csrc.glob(g)}):
            data = path.read_bytes()
            digest.update(f"{path.name}\0{len(data)}\0".encode() + data)
        return BUILD_ROOT / f"{self.prefix}-{digest.hexdigest()[:16]}"

    def build(self) -> Path:
        """Compile the outputs not built yet and return the directory. Raises
        naming each source that failed, with its compiler's output."""
        out_dir = self.directory
        with self._lock:
            out_dir.mkdir(parents=True, exist_ok=True)
            fd = os.open(out_dir / ".build.lock", os.O_CREAT | os.O_RDWR)
            try:
                fcntl.flock(fd, fcntl.LOCK_EX)
                missing = [o for o in self.outputs if not (out_dir / o).exists()]
                if missing:
                    self._compile(out_dir, missing)
            finally:
                os.close(fd)  # closing the descriptor releases the lock
        return out_dir

    def _compile(self, out_dir: Path, missing) -> None:
        cc, tag = find_compiler(self.compiler), f"{os.getpid()}.{threading.get_ident()}"
        runs = {out: (out_dir / f".{tag}.{out}", self.outputs[out]) for out in missing}
        procs = [subprocess.Popen(
            [cc, *self.flags, "-o", str(tmp), str(self.csrc / src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ) for tmp, src in runs.values()]
        failures = []
        for (out, (tmp, src)), proc in zip(runs.items(), procs):
            try:
                log = proc.communicate(timeout=self.timeout)[0]
            except subprocess.TimeoutExpired:
                proc.kill()
                log = proc.communicate()[0] + f"\ntimed out after {self.timeout} s"
            (out_dir / f"{Path(src).stem}.build.log").write_text(log)
            if proc.returncode == 0:
                os.replace(tmp, out_dir / out)
            else:
                tmp.unlink(missing_ok=True)
                failures.append(f"{self.compiler} failed for {src}:\n{log}")
        if failures:
            raise RuntimeError("\n".join(failures))


def extension(prefix: str, csrc: Path, source: str, module: str) -> Artifact:
    """The CPython extension ``module``, g++-built from ``csrc/source`` for
    this interpreter (its headers, its suffix and its version in the key)."""
    return Artifact(
        prefix, "g++", ("-O2", "-shared", "-fPIC", f"-I{PY_INCLUDE}"), csrc,
        {module + EXT_SUFFIX: source}, key_parts=(EXT_SUFFIX, sys.version), timeout=120)


def load_extension(art: Artifact) -> ModuleType:
    """Build ``art``, one ``extension``, and import its module."""
    if not (Path(PY_INCLUDE) / "Python.h").exists():
        raise FileNotFoundError(f"no Python.h under {PY_INCLUDE}")
    (out,) = art.outputs
    name = out[: -len(EXT_SUFFIX)]
    spec = importlib.util.spec_from_file_location(name, art.build() / out)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Loader:
    """``load`` (which builds what it loads) run once, on a background thread
    that the first ``get`` starts; a failure is logged once, never retried."""

    def __init__(self, what: str, load: Callable[[], object], daemon: bool):
        self.what, self._load, self._daemon = what, load, daemon
        self.value = None  # the loaded object, set once by the thread
        self._thread: Optional[threading.Thread] = None  # set once, under _lock
        self._lock = threading.Lock()

    def _run(self) -> None:
        try:
            self.value = self._load()
        except Exception as e:
            logger.warning("%s unavailable: %s", self.what, e)

    def get(self, wait: Optional[float] = None):
        """The loaded object, or None while it builds or where it failed.
        ``wait`` seconds blocks for the build."""
        if self.value is None:
            if self._thread is None:
                with self._lock:
                    if self._thread is None:
                        self._thread = threading.Thread(
                            target=self._run, name=f"build {self.what}", daemon=self._daemon)
                        self._thread.start()
            if wait is not None:
                self._thread.join(wait)
        return self.value
