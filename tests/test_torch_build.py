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


def test_the_hash_libraries_are_listed():
    """The Poseidon, Blake2s and Blake3 kernels: one library a source, their
    sources and the headers they include present."""
    want = {"poseidon": ["poseidon.cu"], "poseidon_limbs": ["poseidon_limbs.cu"],
            "blake2s": ["blake2s.cu"], "blake3": ["blake3.cu"]}
    for name, sources in want.items():
        assert build.LIBRARIES[name] == sources
        inputs = {os.path.basename(f) for f in build._inputs(name)}
        assert {"poseidon.cuh", "poseidon2.cuh", "mont32.cuh", "blake.cuh"} <= inputs
        assert all(os.path.exists(os.path.join(build.CSRC, s)) for s in sources)


@pytest.mark.parametrize("kernel,source", [("msm_scan_r12", "msm_scan_r12.cu"),
                                           ("msm_fold2", "msm_fold2.cu"),
                                           ("bucket_accum", "bucket_accum.cu")])
def test_b5_b6_b7_have_a_library_a_limb_count(kernel, source):
    """B5, B6 and B7 at 12 and 24 limbs: their sources compiled again with
    ICICLE_EC_LIMBS, each its own nvcc; B5's over the schedules' header."""
    assert build.LIBRARIES[kernel] == [source] and kernel not in build.DEFINES
    for nl in (12, 24):
        name = f"{kernel}_l{nl}"
        assert build.LIBRARIES[name] == [source]
        assert build.DEFINES[name] == [f"-DICICLE_EC_LIMBS={nl}"]
        inputs = {os.path.basename(f) for f in build._inputs(name)}
        assert {source, "r12_schedules.cuh", "radix12.cuh", "ec_field.cuh"} <= inputs


def test_build_all_runs_nvcc_per_library_and_reports_its_time(tree, tmp_path, monkeypatch):
    """build_all starts one compiler process per stale library, moves each
    output into place, and ends each report with the process's wall time;
    a stand-in nvcc writes the -o file."""
    fake = tmp_path / "nvcc"
    fake.write_text('#!/bin/sh\nprev=""\nfor a in "$@"; do\n'
                    '  if [ "$prev" = "-o" ]; then : > "$a"; fi\n  prev="$a"\ndone\n'
                    'echo "ptxas info    : Used 32 registers"\n')
    fake.chmod(0o755)
    monkeypatch.setattr(build, "nvcc", lambda: str(fake))
    names = ["poseidon2", "poseidon2_limbs"]
    reports = build.build_all(names)
    assert sorted(reports) == names
    for name in names:
        lines = reports[name].splitlines()
        assert lines[0].startswith("ptxas info") and lines[-1].startswith("nvcc: ")
        assert float(lines[-1].split()[1]) >= 0
        assert os.path.exists(build.lib_path(name)) and not build._stale(name)
    assert build.build_all(names) == {}                  # nothing stale: nothing built


def test_a_compile_in_flight_is_waited_for_not_started_again(tree, tmp_path, monkeypatch):
    """A background build_all (as chip_smoke.py starts) and a load-time
    build_all of the same library: one nvcc runs, the second call waits
    for it and compiles nothing; a failed compile raises in both."""
    import threading
    log = tmp_path / "calls"
    fake = tmp_path / "nvcc"
    fake.write_text('#!/bin/sh\necho x >> "%s"\nsleep 1\nprev=""\nfor a in "$@"; do\n'
                    '  if [ "$prev" = "-o" ]; then : > "$a"; fi\n  prev="$a"\ndone\n'
                    'case "$*" in *fail*) exit 1;; esac\n' % log)
    fake.chmod(0o755)
    monkeypatch.setattr(build, "nvcc", lambda: str(fake))
    out = {}
    first = threading.Thread(target=lambda: out.update(first=build.build_all(["keccak"])))
    first.start()
    while "keccak" not in build._compiling:                # the first call's nvcc is running
        pass
    assert build.build_all(["keccak"]) == {}                # waited for, compiled nothing
    first.join()
    assert list(out["first"]) == ["keccak"] and not build._stale("keccak")
    assert log.read_text().count("x") == 1
    assert build.compile_reports()["keccak"] == out["first"]["keccak"]
    monkeypatch.setitem(build.LIBRARIES, "fail_lib", ["fail.cu"])
    (tree / "fail.cu").write_text("")
    errors = []

    def run():
        try:
            build.build_all(["fail_lib"])
        except build.IcicleException as e:
            errors.append(str(e))

    second = threading.Thread(target=run)
    second.start()
    while "fail_lib" not in build._compiling:
        pass
    run()
    second.join()
    assert len(errors) == 2 and all("libfail_lib.so" in e for e in errors)
    assert not build._compiling
