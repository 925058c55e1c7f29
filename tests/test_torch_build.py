"""The staleness rule of the kernel build (icicle_tpu_torch/kernels/build.py):
a library is rebuilt when its .so is older than any source it compiles or
any header in kernels/csrc/, which its sources include. Checked on a temp
copy of csrc/ with a stand-in .so; no nvcc is needed."""

import os
import shutil

import pytest

from icicle_tpu_torch.kernels import build


@pytest.fixture
def tree(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", str(csrc))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "build"))
    os.makedirs(tmp_path / "build")
    return csrc


def _stamp(path, t):
    os.utime(path, (t, t))


@pytest.mark.parametrize("name", sorted(build.LIBRARIES))
def test_missing_library_is_stale(tree, name):
    assert build._stale(name)


@pytest.mark.parametrize("name", sorted(build.LIBRARIES))
def test_header_newer_than_library_makes_it_stale(tree, name):
    lib = build.lib_path(name)
    open(lib, "w").close()
    for f in os.listdir(tree):
        _stamp(tree / f, 1_000)
    _stamp(lib, 2_000)
    assert not build._stale(name)
    _stamp(tree / "ec_field.cuh", 3_000)       # only the shared header changed
    assert build._stale(name)


@pytest.mark.parametrize("name", sorted(build.LIBRARIES))
def test_source_newer_than_library_makes_it_stale(tree, name):
    lib = build.lib_path(name)
    open(lib, "w").close()
    for f in os.listdir(tree):
        _stamp(tree / f, 1_000)
    _stamp(lib, 2_000)
    _stamp(tree / build.LIBRARIES[name][-1], 3_000)
    assert build._stale(name)
    other = [n for n in build.LIBRARIES if n != name]
    for n in other:                           # another library's sources do not count
        for s in build.LIBRARIES[n]:
            if s not in build.LIBRARIES[name]:
                _stamp(tree / s, 1_000)
    _stamp(tree / build.LIBRARIES[name][-1], 1_000)
    assert not build._stale(name)


def test_every_library_source_and_header_exists():
    for name, sources in build.LIBRARIES.items():
        for f in build._inputs(name):
            assert os.path.exists(f), f
    for name in ("msm_scan", "ec_reduce"):
        assert "ec_field.cuh" in {os.path.basename(f) for f in build._inputs(name)}
