"""The port's one build-and-load path (``utils/native_build.py``): where each
of its four artifacts (the card kernels, the native packer, the native
statics pass, the native validate pass) is built and what its key covers,
and, with a stub compiler on the CPU, the compile step's locking, failures
and timeout and the background loader's contract."""

import dataclasses
import logging
import os
import shutil
import sys
import threading
import time
from pathlib import Path

import pytest

from karpenter_tpu_torch.scheduling import statics as S
from karpenter_tpu_torch.solver import native, pack_kernel
from karpenter_tpu_torch.solver import validate as V
from karpenter_tpu_torch.utils import native_build

REPO = Path(__file__).resolve().parents[1]

ARTIFACTS = {
    "kernels": pack_kernel.LIBS,
    "native": native.LIB,
    "statics": S.NATIVE_EXT,
    "validate": V.NATIVE_EXT,
}
# the files each artifact's key covers: every source and header it compiles
KEYED = {
    "kernels": {"first_fit.cuh", "pack_first_fit.cu", "pack_first_fit_v2.cu"},
    "native": {"ffd_pack.cpp"},
    "statics": {"statics_native.cpp"},
    "validate": {"validate_native.cpp"},
}


def moved(art, csrc):
    """``art`` over a copy of its sources (a new instance: its own key)."""
    return dataclasses.replace(art, csrc=csrc)


@pytest.fixture
def copied(tmp_path):
    def copy(art):
        csrc = tmp_path / "csrc"
        shutil.copytree(art.csrc, csrc)
        return csrc

    return copy


# -- the key and the place ------------------------------------------------------


@pytest.mark.parametrize("name", ARTIFACTS)
def test_key_covers_each_source_header_and_flag(name, copied):
    art = ARTIFACTS[name]
    csrc = copied(art)
    assert moved(art, csrc).directory == art.directory
    assert {p.name for p in csrc.iterdir()} >= KEYED[name]
    for file in sorted(KEYED[name]):
        path = csrc / file
        original = path.read_bytes()
        path.write_bytes(original + b"\n// an edit\n")
        edited = moved(art, csrc).directory
        assert edited != art.directory, file
        assert edited.parent == native_build.BUILD_ROOT
        path.write_bytes(original)
        assert moved(art, csrc).directory == art.directory, file
    assert dataclasses.replace(art, flags=art.flags + ("-g",)).directory != art.directory
    assert dataclasses.replace(art, key_parts=art.key_parts + ("x",)).directory != art.directory


@pytest.mark.parametrize("name", ARTIFACTS)
def test_key_ignores_other_files(name, copied):
    art = ARTIFACTS[name]
    csrc = copied(art)
    (csrc / "notes.txt").write_text("not compiled")
    for path in csrc.iterdir():
        if path.name not in KEYED[name]:
            path.write_bytes(path.read_bytes() + b"\n// not this artifact's\n")
    assert moved(art, csrc).directory == art.directory


@pytest.mark.parametrize("name", ARTIFACTS)
def test_lands_under_build_never_native(name):
    art = ARTIFACTS[name]
    rel = art.directory.relative_to(REPO)
    assert rel.parts[:2] == ("build", "karpenter_tpu_torch") and len(rel.parts) == 3
    assert rel.parts[2].startswith(f"{art.prefix}-") and art.prefix == name
    for src in art.outputs.values():
        assert (art.csrc / src).relative_to(REPO).parts[0] == "karpenter_tpu_torch"
        assert (art.csrc / src).parent.name == "csrc"
    # no -march=native, no fast math: the host's build gives the kernels' numbers
    assert "march" not in " ".join(art.flags) and "fast-math" not in " ".join(art.flags)


def test_the_g_plus_plus_artifacts_build_where_they_are_keyed():
    if shutil.which("g++") is None:
        pytest.skip("no C++ compiler")
    assert native.native_available(wait=180)
    assert native.lib_path() == native.LIB.directory / "libffd_pack.so"
    assert native.lib_path().exists()
    assert S.NATIVE.get(wait=300) is not None
    assert [p for p in S.NATIVE_EXT.directory.iterdir() if p.name.startswith("_statics_native")]
    assert V.NATIVE.get(wait=300) is not None
    assert [p for p in V.NATIVE_EXT.directory.iterdir() if p.name.startswith("_validate_native")]


# -- the compile step, with a stub compiler -------------------------------------

STUB = """#!{python}
import pathlib, sys, time
args = sys.argv[1:]
out, src = pathlib.Path(args[args.index("-o") + 1]), pathlib.Path(args[-1])
with open(args[args.index("--count") + 1], "a") as f:
    f.write(src.name + "\\n")
time.sleep(float(args[args.index("--sleep") + 1]))
text = src.read_text()
if "FAIL" in text:
    print("stub: error in " + src.name, file=sys.stderr)
    sys.exit(1)
print("stub: built " + src.name)
out.write_text("built from " + text)
"""


@pytest.fixture
def stub(tmp_path, monkeypatch):
    """A stub compiler ``stubcc`` on PATH and a build root under tmp_path;
    returns a maker of artifacts over sources written to tmp_path."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    cc = bin_dir / "stubcc"
    cc.write_text(STUB.format(python=sys.executable))
    cc.chmod(0o755)
    monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}{os.environ.get('PATH', '')}")
    monkeypatch.setattr(native_build, "BUILD_ROOT", tmp_path / "build")
    csrc = tmp_path / "src"
    csrc.mkdir()
    count = tmp_path / "count"

    def make(sources, sleep=0.3, timeout=None):
        for name, text in sources.items():
            (csrc / name).write_text(text)
        return native_build.Artifact(
            "stub", "stubcc", ("--count", str(count), "--sleep", str(sleep)), csrc,
            {f"{Path(n).stem}.out": n for n in sources}, timeout=timeout)

    make.compiled = lambda: count.read_text().split() if count.exists() else []
    return make


@pytest.mark.parametrize("twins", [False, True], ids=["one-object", "two-objects"])
def test_two_threads_compile_once_and_both_load(stub, twins):
    """Two threads build one artifact at once: each source compiles once and
    both read the outputs. With ``twins`` the threads hold two equal
    artifacts (as two processes sharing a checkout do), so only the file
    lock on the directory keeps them apart."""
    art = stub({"a.c": "alpha", "b.c": "beta"})
    arts = [art, dataclasses.replace(art) if twins else art]
    start = threading.Barrier(2)
    got = [None, None]

    def run(i):
        start.wait()
        out_dir = arts[i].build()
        got[i] = [(out_dir / o).read_text() for o in ("a.out", "b.out")]

    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
        assert not t.is_alive()
    assert got == [["built from alpha", "built from beta"]] * 2
    assert sorted(stub.compiled()) == ["a.c", "b.c"]
    names = {p.name for p in art.directory.iterdir()}
    assert names == {"a.out", "b.out", "a.build.log", "b.build.log", ".build.lock"}
    assert (art.directory / "a.build.log").read_text() == "stub: built a.c\n"
    art.build()  # built: nothing compiles again
    assert len(stub.compiled()) == 2


def test_failing_compile_raises_with_its_output_and_lands_nothing(stub):
    art = stub({"good.c": "fine", "bad.c": "FAIL here"}, sleep=0)
    with pytest.raises(RuntimeError) as err:
        art.build()
    msg = str(err.value)
    assert "stubcc failed for bad.c" in msg and "stub: error in bad.c" in msg
    assert "good.c" not in msg
    names = {p.name for p in art.directory.iterdir()}
    # the good output landed, the bad one left neither its name nor a temporary
    assert names == {"good.out", "good.build.log", "bad.build.log", ".build.lock"}
    # a second build compiles only what is still missing, and fails the same way
    with pytest.raises(RuntimeError, match="stub: error in bad.c"):
        art.build()
    assert sorted(stub.compiled()) == ["bad.c", "bad.c", "good.c"]


def test_a_compile_past_its_timeout_fails(stub):
    art = stub({"slow.c": "slow"}, sleep=30, timeout=0.5)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="timed out after 0.5 s"):
        art.build()
    assert time.monotonic() - t0 < 20
    assert not (art.directory / "slow.out").exists()


def test_find_compiler_looks_on_path_then_under_cuda_home(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    with pytest.raises(FileNotFoundError, match="nvcc not found"):
        native_build.find_compiler("nvcc")
    (tmp_path / "cuda" / "bin").mkdir(parents=True)
    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.write_text("#!/bin/sh\n")
    nvcc.chmod(0o755)
    assert native_build.find_compiler("nvcc") == str(nvcc)
    on_path = tmp_path / "path"
    on_path.mkdir()
    shutil.copy(nvcc, on_path / "nvcc")
    monkeypatch.setenv("PATH", str(on_path))
    assert native_build.find_compiler("nvcc") == str(on_path / "nvcc")


# -- the background loader ----------------------------------------------------------


def test_loader_returns_none_until_its_build_ends():
    release, calls = threading.Event(), []

    def load():
        calls.append(1)
        release.wait(30)
        return "loaded"

    loader = native_build.Loader("stub", load, daemon=True)
    assert loader.get() is None  # starts the build, never blocks on it
    assert loader.get(wait=0.05) is None
    release.set()
    assert loader.get(wait=30) == "loaded"
    assert loader.get() == "loaded" and loader.value == "loaded"
    assert calls == [1]


def test_loader_failure_is_logged_once_and_sticky(caplog):
    calls = []

    def load():
        calls.append(1)
        raise RuntimeError("stubcc failed for x.c")

    loader = native_build.Loader("stub artifact", load, daemon=False)
    with caplog.at_level(logging.WARNING, logger="karpenter.native_build"):
        assert loader.get(wait=30) is None
        assert loader.get(wait=30) is None
        assert loader.get() is None
    assert calls == [1]
    warnings = [r.getMessage() for r in caplog.records if r.name == "karpenter.native_build"]
    assert warnings == ["stub artifact unavailable: stubcc failed for x.c"]
