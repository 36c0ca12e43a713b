"""Packaging of iivision_tpu_torch: its native sources travel through
MANIFEST.in, its console scripts resolve, and its builds move to the
user's cache directory when the package directory cannot be written."""

import glob
import importlib
import os
import re

import pytest

from iivision_tpu_torch import _build
from iivision_tpu_torch.sim import _build as sim_build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def manifest_patterns():
    """[(directory, [pattern, ...])] of MANIFEST.in's recursive-include
    lines; any other directive fails the parse."""
    out = []
    with open(os.path.join(REPO, "MANIFEST.in")) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            words = line.split()
            assert words[0] == "recursive-include" and len(words) >= 3, line
            out.append((words[1], words[2:]))
    return out


def test_manifest_patterns_hit_files():
    hit = set()
    for directory, patterns in manifest_patterns():
        for pattern in patterns:
            found = glob.glob(os.path.join(REPO, directory, "**", pattern),
                              recursive=True)
            assert found, "%s %s matches nothing" % (directory, pattern)
            hit.update(os.path.relpath(p, REPO) for p in found)
    # every native source the port builds from is shipped
    want = [os.path.relpath(p, REPO) for p in
            _build.sources() + _build.headers()
            + glob.glob(os.path.join(sim_build.CSRC_DIR, "*.cpp"))]
    assert len(want) >= 11 and set(want) <= hit, sorted(set(want) - hit)
    assert "iivision_tpu_torch/sim/csrc/apple2_vm.cpp" in hit


def test_pyproject_includes_package_data_and_finds_the_port():
    with open(os.path.join(REPO, "pyproject.toml")) as f:
        text = f.read()
    assert re.search(r"^include-package-data = true$", text, re.M)
    assert '"iivision_tpu_torch*"' in text


SCRIPTS = ["transcode", "make-tables", "serve", "verify-stream",
           "render-stream", "make-disk", "retarget", "seek"]


@pytest.mark.parametrize("script", SCRIPTS)
def test_console_script_resolves(script):
    with open(os.path.join(REPO, "pyproject.toml")) as f:
        text = f.read()
    m = re.search(r'^iivision-torch-%s = "([\w.]+):(\w+)"$' % script, text,
                  re.M)
    assert m, script
    module, attr = m.groups()
    assert module.startswith("iivision_tpu_torch")
    assert callable(getattr(importlib.import_module(module), attr))


def test_every_torch_script_is_listed():
    with open(os.path.join(REPO, "pyproject.toml")) as f:
        text = f.read()
    assert sorted(re.findall(r"^iivision-torch-([\w-]+) =", text, re.M)) == \
        sorted(SCRIPTS)


def test_unwritable_package_dir_builds_under_the_user_cache(tmp_path,
                                                            monkeypatch):
    """With `_build/` impossible to create (its parent is a file here,
    which stops root too), a g++ build lands under XDG_CACHE_HOME, under
    the same hashed name, loads, and is reused by the next call."""
    blocker = tmp_path / "not_a_directory"
    blocker.write_text("")
    cache = tmp_path / "cache"
    monkeypatch.setattr(sim_build, "BUILD_DIR", str(blocker / "_build"))
    monkeypatch.setenv("XDG_CACHE_HOME", str(cache))
    native = str(cache / "iivision_tpu_torch" / "native")
    assert sim_build.cache_dir() == native
    path = sim_build.build_so("player_vm")
    assert os.path.dirname(path) == native and os.path.getsize(path) > 0
    import ctypes
    assert ctypes.CDLL(path).a2m_decode
    before = os.path.getmtime(path)
    assert sim_build.build_so("player_vm") == path
    assert os.path.getmtime(path) == before
    # the CUDA library's path follows the same rule
    monkeypatch.setattr(_build, "BUILD_DIR", str(blocker / "_build"))
    assert os.path.dirname(_build.library_path()) == native


def test_writable_package_dir_is_preferred(tmp_path, monkeypatch):
    monkeypatch.setattr(sim_build, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    path = sim_build.build_so("player_vm")
    assert os.path.dirname(path) == str(tmp_path / "_build")
    assert not (tmp_path / "cache").exists()
    # a library already in the package directory is used where it lies,
    # even when nothing more can be written there
    monkeypatch.setattr(sim_build, "writable_build_dir",
                        lambda preferred: str(tmp_path / "elsewhere"))
    assert sim_build.build_so("player_vm") == path


def test_a_failed_build_raises_in_the_cache_too(tmp_path, monkeypatch):
    """The cache is a second place to build in, not a way to carry on: a
    compiler that fails there raises."""
    import subprocess

    blocker = tmp_path / "not_a_directory"
    blocker.write_text("")
    monkeypatch.setattr(sim_build, "BUILD_DIR", str(blocker / "_build"))
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    monkeypatch.setattr(sim_build, "_BASE_FLAGS", ["-O3", "--no-such-flag"])
    with pytest.raises(subprocess.CalledProcessError):
        sim_build.build_so("player_vm")
