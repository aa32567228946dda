"""Port: the build cache (ops/kernels/build.py, native/, utils/build_cache.py),
the counterpart of the JAX package's utils/xla_cache.py. A build's key
holds its flags and the compiler's --version output as well as its
sources, and one environment variable moves the build directory. No nvcc
is needed: the nvcc builder is driven with a stand-in compiler run, the
native builder with the host c++."""

import shutil
import subprocess
import types
from pathlib import Path

import pytest

from nerf_for_angiography_tpu_torch import native
from nerf_for_angiography_tpu_torch.ops.kernels import build
from nerf_for_angiography_tpu_torch.utils.build_cache import enable_persistent_cache

FIRST_K = build.CSRC_DIR / "first_k.cu"


def test_the_tag_holds_flags_and_compiler_version():
    base = build.build_tag(FIRST_K, build.NVCC_FLAGS, "nvcc 12.8")
    assert base == build.build_tag(FIRST_K, tuple(build.NVCC_FLAGS), "nvcc 12.8")
    assert base != build.build_tag(FIRST_K, build.NVCC_FLAGS, "nvcc 12.9")
    assert base != build.build_tag(FIRST_K, (*build.NVCC_FLAGS, "-lineinfo"), "nvcc 12.8")
    assert base != build.build_tag(FIRST_K, [f.replace("-O3", "-O2") for f in build.NVCC_FLAGS],
                                   "nvcc 12.8")
    assert base != build.build_tag(build.CSRC_DIR / "fused_step.cu", build.NVCC_FLAGS,
                                   "nvcc 12.8")


@pytest.fixture
def stand_in_nvcc(tmp_path, monkeypatch):
    """nvcc replaced by a run that copies an already built shared library
    to the output path; every command line is recorded."""
    so = Path(native.get_lib("jsonexport")._name)
    cmds = []

    def run(cmd, capture_output=True, text=True):
        cmds.append(cmd)
        shutil.copy(so, cmd[cmd.index("-o") + 1])
        return types.SimpleNamespace(returncode=0, stdout="", stderr="")

    monkeypatch.setattr(build, "nvcc", lambda: "/stand-in/nvcc")
    monkeypatch.setattr(build.subprocess, "run", run)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    return cmds


def test_nvcc_builds_rebuild_for_another_flag_or_compiler(stand_in_nvcc, monkeypatch):
    monkeypatch.setattr(build, "compiler_version", lambda c: "release 12.8")
    build.load_library("first_k")
    build.load_library("first_k")  # the same key: loaded, not built again
    assert len(stand_in_nvcc) == 1
    assert stand_in_nvcc[0][1:1 + len(build.NVCC_FLAGS)] == list(build.NVCC_FLAGS)
    monkeypatch.setattr(build, "compiler_version", lambda c: "release 12.9")
    build.load_library("first_k")
    monkeypatch.setattr(build, "NVCC_FLAGS", (*build.NVCC_FLAGS, "-lineinfo"))
    build.load_library("first_k")
    assert len(stand_in_nvcc) == 3
    assert "-lineinfo" in stand_in_nvcc[-1]
    assert len(list((build.BUILD_DIR).glob("libfirst_k_*.so"))) == 3


def test_compiler_version_is_read_once_a_process(monkeypatch):
    calls = []

    def run(cmd, capture_output=True, text=True):
        calls.append(cmd)
        return subprocess.CompletedProcess(cmd, 0, "c++ (stand-in) 1.0\n", "")

    monkeypatch.setattr(build.subprocess, "run", run)
    build.compiler_version.cache_clear()
    try:
        assert build.compiler_version("/stand-in/c++") == "c++ (stand-in) 1.0\n"
        assert build.compiler_version("/stand-in/c++") == "c++ (stand-in) 1.0\n"
        assert calls == [["/stand-in/c++", "--version"]]
    finally:
        build.compiler_version.cache_clear()


def test_native_builds_rebuild_for_another_flag_or_compiler(tmp_path, monkeypatch):
    """The host c++ builds json_export.cpp into the build directory under a
    key that moves with its flags and its --version output."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_libs", {})
    native.get_lib("jsonexport")
    first = {p.name for p in tmp_path.glob("libjsonexport_*.so")}
    monkeypatch.setattr(native, "_libs", {})
    monkeypatch.setattr(native, "CXX_FLAGS", (*native.CXX_FLAGS, "-DNDEBUG"))
    native.get_lib("jsonexport")
    second = {p.name for p in tmp_path.glob("libjsonexport_*.so")}
    monkeypatch.setattr(native, "_libs", {})
    monkeypatch.setattr(native, "compiler_version", lambda c: "another c++")
    native.get_lib("jsonexport")
    third = {p.name for p in tmp_path.glob("libjsonexport_*.so")}
    assert len(first) == 1 and len(second) == 2 and len(third) == 3


def test_the_environment_variable_moves_the_build_directory(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "BUILD_DIR", build.BUILD_DIR)
    monkeypatch.setattr(native, "BUILD_DIR", native.BUILD_DIR)
    monkeypatch.delenv(build.BUILD_DIR_ENV, raising=False)
    assert build.default_build_dir() == Path(build.__file__).resolve().parents[2] / "build"
    moved = tmp_path / "cache"
    monkeypatch.setenv(build.BUILD_DIR_ENV, str(moved))
    assert build.default_build_dir() == moved
    assert enable_persistent_cache() == str(moved) and moved.is_dir()
    assert build.BUILD_DIR == native.BUILD_DIR == moved
    monkeypatch.setattr(native, "_libs", {})
    native.get_lib("jsonexport")
    assert list(moved.glob("libjsonexport_*.so"))
    other = tmp_path / "explicit"
    assert enable_persistent_cache(str(other)) == str(other)
    assert build.BUILD_DIR == native.BUILD_DIR == other
