"""Build and load the port's CUDA kernels.

Each library is one `nvcc` call over its sources in kernels/csrc/, for
Hopper (sm_90a), into icicle_tpu_torch/build/lib<name>.so, with a plain C
interface that kernels/*.py load with ctypes. A library is rebuilt when it
is missing or older than one of its sources or than any header (`*.cuh`)
in csrc/. `build_all` starts one nvcc process per stale library, all at
once, and waits for every one; a library whose compile another call (or
thread) started is waited for, not started again, so a caller may build
everything in a background thread while `load` takes each library as it
is ready.

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
# source per library, so that every source compiles in its own nvcc. The
# 12- and 24-limb instances of B3 and B4, and their G2 instances over Fp2
# (8 and 12 limbs) and precompute_bases' over Fp2, are their sources
# compiled again with another ICICLE_EC_LIMBS / ICICLE_EC_DEGREE (DEFINES),
# each in its own nvcc; so are the 12- and 24-limb instances of B5, B6 and
# B7 and the ECNTT kernel's (ecntt.cu at 8, 12 and 24 limbs).
LIBRARIES = {"ntt": ["ntt_dif.cu"], "ntt_wide": ["ntt_wide.cu"], "msm_scan": ["msm_scan.cu"],
             "msm_scan_l12": ["msm_scan.cu"], "msm_scan_l24": ["msm_scan.cu"],
             "ec_reduce": ["ec_reduce.cu"], "ec_reduce_l12": ["ec_reduce.cu"],
             "ec_reduce_l24": ["ec_reduce.cu"], "msm_scan_fp2": ["msm_scan.cu"],
             "msm_scan_fp2_l12": ["msm_scan.cu"], "ec_reduce_fp2": ["ec_reduce.cu"],
             "ec_reduce_fp2_l12": ["ec_reduce.cu"], "precompute_bases": ["precompute_bases.cu"],
             "precompute_bases_fp2": ["precompute_bases.cu"],
             "msm_scan_r12": ["msm_scan_r12.cu"], "msm_scan_r12_l12": ["msm_scan_r12.cu"],
             "msm_scan_r12_l24": ["msm_scan_r12.cu"],
             "msm_fold2": ["msm_fold2.cu"], "msm_fold2_l12": ["msm_fold2.cu"],
             "msm_fold2_l24": ["msm_fold2.cu"], "bucket_accum": ["bucket_accum.cu"],
             "bucket_accum_l12": ["bucket_accum.cu"], "bucket_accum_l24": ["bucket_accum.cu"],
             "poseidon2": ["poseidon2.cu"], "poseidon2_limbs": ["poseidon2_limbs.cu"],
             "poseidon2_gl64": ["poseidon2_gl64.cu"],
             "poseidon": ["poseidon.cu"], "poseidon_limbs": ["poseidon_limbs.cu"],
             "blake2s": ["blake2s.cu"], "blake3": ["blake3.cu"],
             "keccak": ["keccak.cu"], "fri_fold": ["fri_fold.cu"], "sumcheck": ["sumcheck.cu"],
             "program": ["program.cu"], "ecntt": ["ecntt.cu"], "ecntt_l12": ["ecntt.cu"],
             "ecntt_l24": ["ecntt.cu"], "rq_ntt": ["rq_ntt.cu"], "mlkem": ["mlkem.cu"]}

# library name -> its extra nvcc flags: the limb count and, for the G2
# instances over Fp2, the degree (ec_field.cuh)
DEFINES = {**{f"{kernel}_l{nl}": [f"-DICICLE_EC_LIMBS={nl}"]
              for kernel in ("msm_scan", "ec_reduce", "msm_scan_r12", "msm_fold2",
                             "bucket_accum") for nl in (12, 24)},
           **{f"{kernel}_fp2{sfx}": [f"-DICICLE_EC_LIMBS={nl}", "-DICICLE_EC_DEGREE=2"]
              for kernel in ("msm_scan", "ec_reduce") for nl, sfx in ((8, ""), (12, "_l12"))},
           "precompute_bases_fp2": ["-DICICLE_EC_DEGREE=2"],
           **{f"ecntt_l{nl}": [f"-DICICLE_EC_LIMBS={nl}"] for nl in (12, 24)}}

# -Xptxas -v: the compiler reports registers, shared memory and spills
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


class _Compile:
    """A library's nvcc in flight: set when it ends, with its report and
    whether it failed."""

    def __init__(self):
        self.done = threading.Event()
        self.report = ""
        self.failed = False


_compiling: dict[str, _Compile] = {}
_compiling_lock = threading.Lock()
_reports: dict[str, str] = {}   # every compile this process ran: its report


def compile_reports() -> dict[str, str]:
    """The report of every compile this process ran, by library, whichever
    call started it."""
    with _compiling_lock:
        return dict(_reports)


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
    parallel, each moved into place as its compile ends. Returns each
    library this call compiled with its compiler output, ending in a line
    "nvcc: <seconds> s" (its wall time from the start of the build); waits
    for the ones another call is compiling; raises with the output of every
    failed compile."""
    names = list(LIBRARIES if names is None else names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    jobs, waited = {}, {}
    with _compiling_lock:
        for name in names:
            if name in _compiling:
                waited[name] = _compiling[name]
                continue
            if not _stale(name):
                continue
            tmp = f"{lib_path(name)}.{os.getpid()}.tmp"
            cmd = [nvcc(), *NVCC_FLAGS, *DEFINES.get(name, []), "-o", tmp,
                   *(os.path.join(CSRC, s) for s in LIBRARIES[name])]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                    text=True)
            jobs[name] = (proc, tmp, _Compile())
            _compiling[name] = jobs[name][2]
    start = time.perf_counter()

    def wait(name: str, proc: subprocess.Popen, tmp: str, job: _Compile) -> None:
        out = proc.communicate()[0]
        job.report = f"{out}nvcc: {time.perf_counter() - start:.1f} s\n"
        job.failed = proc.returncode != 0
        if not job.failed:
            os.replace(tmp, lib_path(name))
        with _compiling_lock:
            del _compiling[name]
            _reports[name] = job.report
        job.done.set()

    waiters = [threading.Thread(target=wait, args=(name, *job)) for name, job in jobs.items()]
    for w in waiters:
        w.start()
    for w in waiters:
        w.join()
    for job in waited.values():
        job.done.wait()
    failed = {name: job for name, (_, _, job) in jobs.items() if job.failed}
    failed.update((name, job) for name, job in waited.items() if job.failed)
    if failed:
        raise IcicleException(
            IcicleError.BACKEND_LOAD_FAILED,
            "nvcc failed:\n" + "\n".join(f"lib{n}.so:\n{job.report}" for n, job in failed.items()))
    return {name: job.report for name, (_, _, job) in jobs.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library `name`, built first if stale."""
    with _lock:
        if name not in _loaded:
            build_all([name])
            _loaded[name] = ctypes.CDLL(lib_path(name))
        return _loaded[name]
