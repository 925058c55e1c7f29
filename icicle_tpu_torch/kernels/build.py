"""Build and load the port's CUDA kernels.

Each library is one `nvcc` call over its sources in kernels/csrc/, for
Hopper (sm_90a), into icicle_tpu_torch/build/lib<name>.so, with a plain C
interface that kernels/*.py load with ctypes. A library is rebuilt when it
is missing or older than one of its sources or than any header (`*.cuh`)
in csrc/. `build_all` starts one nvcc process per stale library, all at
once, and waits for every one.

nvcc is taken from $CUDA_HOME/bin (default /usr/local/cuda), else from PATH.
Nothing is built when a module is imported: `load` builds at first use.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time

from icicle_tpu_torch.runtime.errors import IcicleError, IcicleException

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "kernels", "csrc")
BUILD_DIR = os.path.join(_PKG, "build")

# library name -> its sources in CSRC (headers: every *.cuh in CSRC); one
# source per library, so that every source compiles in its own nvcc
LIBRARIES = {"ntt": ["ntt_dif.cu"], "ntt_wide": ["ntt_wide.cu"], "msm_scan": ["msm_scan.cu"],
             "ec_reduce": ["ec_reduce.cu"], "msm_scan_r12": ["msm_scan_r12.cu"],
             "msm_fold2": ["msm_fold2.cu"], "bucket_accum": ["bucket_accum.cu"],
             "poseidon2": ["poseidon2.cu"], "poseidon2_limbs": ["poseidon2_limbs.cu"],
             "poseidon2_gl64": ["poseidon2_gl64.cu"],
             "poseidon": ["poseidon.cu"], "poseidon_limbs": ["poseidon_limbs.cu"],
             "blake2s": ["blake2s.cu"], "blake3": ["blake3.cu"],
             "keccak": ["keccak.cu"], "fri_fold": ["fri_fold.cu"], "sumcheck": ["sumcheck.cu"],
             "program": ["program.cu"]}

# -Xptxas -v: the compiler reports registers, shared memory and spills
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc() -> str:
    path = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise IcicleException(IcicleError.BACKEND_LOAD_FAILED,
                              "nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def _inputs(name: str) -> list[str]:
    """The files a library is compiled from: its sources and every header."""
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    return [os.path.join(CSRC, f) for f in LIBRARIES[name] + headers]


def _stale(name: str) -> bool:
    out = lib_path(name)
    if not os.path.exists(out):
        return True
    built = os.path.getmtime(out)
    return any(os.path.getmtime(f) > built for f in _inputs(name))


def build_all(names=None) -> dict[str, str]:
    """Compile every stale library among `names` (default: all), in
    parallel. Returns each compiled library's compiler output, ending in a
    line "nvcc: <seconds> s" (its wall time from the start of the build);
    raises with that output when a compile fails."""
    names = list(LIBRARIES if names is None else names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    jobs = {}
    for name in names:
        if not _stale(name):
            continue
        tmp = f"{lib_path(name)}.{os.getpid()}.tmp"
        cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp,
               *(os.path.join(CSRC, s) for s in LIBRARIES[name])]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True), tmp)
    start = time.perf_counter()
    reports = {}

    def wait(name: str, proc: subprocess.Popen) -> None:
        out = proc.communicate()[0]
        reports[name] = f"{out}nvcc: {time.perf_counter() - start:.1f} s\n"

    waiters = [threading.Thread(target=wait, args=(name, proc)) for name, (proc, _) in jobs.items()]
    for w in waiters:
        w.start()
    for w in waiters:
        w.join()
    failed = [name for name, (proc, _) in jobs.items() if proc.returncode != 0]
    if failed:
        raise IcicleException(
            IcicleError.BACKEND_LOAD_FAILED,
            "nvcc failed:\n" + "\n".join(f"lib{n}.so:\n{reports[n]}" for n in failed))
    for name, (_, tmp) in jobs.items():
        os.replace(tmp, lib_path(name))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library `name`, built first if stale."""
    with _lock:
        if name not in _loaded:
            build_all([name])
            _loaded[name] = ctypes.CDLL(lib_path(name))
        return _loaded[name]
