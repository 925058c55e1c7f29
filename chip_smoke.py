"""Smoke test of the PyTorch/CUDA port (icicle_tpu_torch) on one NVIDIA GPU.

Run from the repository root on a machine with a Hopper card (sm_90a), the
CUDA toolkit and PyTorch built for CUDA:

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0, no result line):
  1. card    -- nvidia-smi name and power limit, torch's device name;
  2. build   -- every kernel library from icicle_tpu_torch/kernels/csrc, one
               nvcc per library in parallel, with the compiler's report;
  3. kernels -- each kernel against its plain torch version on the card,
               bit-exact, at the shapes the main path gives it; median ms
               from CUDA events beside the plain version's ms and the bound;
  4. main    -- the NTT main path through icicle_tpu_torch.ntt on CUDA
               tensors: babybear 2^26, koalabear 2^24, babybear 2^16,
               forward and inverse. Forward must equal the kernel-free
               `_ntt_torch` on the card, inverse must give the input back,
               and each NTT must launch the DIF kernel twice; then a
               torch.profiler breakdown of device time by kernel for one
               forward and one inverse babybear NTT at 2^26 and 2^16;
  5. the kernels JSON line; 6. the result JSON line, last.

Bounds: the least time for the same work is the larger of the bytes the
call must move (each input read once, each output written once) over
3.35 TB/s, and its 32-bit integer multiplies over 16.7 T/s (H100 SXM:
132 SMs x 64 INT32 lanes x 1.98 GHz; half the FP32 lanes that give the
data sheet's 67 TFLOP/s). A Montgomery multiply counts as three integer
multiplies (a*b wide, m = lo*inv32, m*p wide).
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import torch

HBM_BYTES_PER_S = 3.35e12
INT_MULS_PER_S = 132 * 64 * 1.98e9
MULS_PER_MONT = 3
REPS = 10


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int = REPS) -> float:
    """Median ms of fn() over `reps` runs after one warm-up, CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_ms(fn, reps: int = 5) -> float:
    """Median ms of fn() + synchronize() on the host clock, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def dif_rows_bound(rows: int, log_n: int, factor: bool) -> tuple[float, str]:
    n = 1 << log_n
    # x and out (+ factor), plus the (log_n, N) stage-twiddle table
    nbytes = rows * n * 4 * (3 if factor else 2) + log_n * n * 4
    monts = rows * (log_n * n // 2 + (n if factor else 0))
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    op_ms = monts * MULS_PER_MONT / INT_MULS_PER_S * 1e3
    return (byte_ms, "bytes") if byte_ms >= op_ms else (op_ms, "operations")


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; this needs a CUDA card")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from icicle_tpu_torch import NTTConfig, NTTDir, get_field, ntt
    from icicle_tpu_torch.kernels import build
    from icicle_tpu_torch.kernels import ntt_kernel as K
    from icicle_tpu_torch.ops import ntt as N

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    gen = torch.Generator(device=dev).manual_seed(20260816)

    def rand(f, shape):
        return torch.randint(0, f.modulus, shape, generator=gen, device=dev,
                             dtype=torch.int32)

    # -- 1. card -------------------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    log("== card")
    log(smi)
    name = torch.cuda.get_device_name(0)
    log(f"torch: {name}, {torch.cuda.device_count()} device(s), torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")

    # -- 2. build ------------------------------------------------------------
    log("== build")
    t0 = time.perf_counter()
    reports = build.build_all()
    log(f"built {sorted(reports) or 'nothing (up to date)'} in "
        f"{time.perf_counter() - t0:.2f} s")
    for lib, text in reports.items():
        for line in text.splitlines():
            if "ptxas info" in line and ("registers" in line or "Compiling" in line):
                log(f"  lib{lib}: {line.strip()}")

    # -- 3. kernel versus plain ----------------------------------------------
    log("== kernels: dif_rows against dif_rows_ref on the card")
    shapes = [  # (field, rows, log_n, forward, factor, role on the main path)
        ("babybear", 8192, 13, True, False, "2^26 fwd pass A"),
        ("babybear", 8192, 13, True, True, "2^26 fwd pass B"),
        ("babybear", 8192, 13, False, False, "2^26 inv pass A"),
        ("babybear", 8192, 13, False, True, "2^26 inv pass B"),
        ("koalabear", 4096, 12, True, False, "2^24 fwd pass A"),
        ("koalabear", 4096, 12, True, True, "2^24 fwd pass B"),
        ("babybear", 256, 8, True, False, "2^16 fwd pass A"),
        ("babybear", 256, 8, True, True, "2^16 fwd pass B"),
        ("babybear", 8192, 14, True, True, "2^27 fwd pass B (logN 14, 64 KB rows)"),
    ]
    shape_rows = []
    for fname, rows, log_n, forward, with_factor, role in shapes:
        f = get_field(fname)
        x = rand(f, (rows, 1 << log_n))
        factor = rand(f, (rows, 1 << log_n)) if with_factor else None
        tw = K._stage_twiddles(f, log_n, forward, dev)
        got = K.dif_rows(f, x, tw, factor)
        torch.cuda.synchronize()
        want = K.dif_rows_ref(f, x, tw, factor)
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        if err != 0 or not torch.equal(got, want):
            raise AssertionError(f"dif_rows != dif_rows_ref at {role}: max abs err {err}")
        kernel_ms = cuda_ms(lambda: K.dif_rows(f, x, tw, factor))
        plain_ms = cuda_ms(lambda: K.dif_rows_ref(f, x, tw, factor))
        bound_ms, bound_by = dif_rows_bound(rows, log_n, with_factor)
        shape_rows.append({"role": role, "field": fname, "rows": rows, "N": 1 << log_n,
                           "factor": with_factor, "max_abs_diff": err, "kernel_ms": kernel_ms,
                           "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by})
        log(f"  {role:38s} {fname:9s} ({rows}, {1 << log_n}) exact; kernel {kernel_ms:.4f} ms, "
            f"plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by})")
        del x, factor, got, want
    torch.cuda.empty_cache()

    # -- 4. main path ---------------------------------------------------------
    log("== main path: icicle_tpu_torch.ntt on CUDA tensors")
    K.dif_rows.launches = 0
    paths = []
    for fname, logn in (("babybear", 26), ("koalabear", 24), ("babybear", 16)):
        f = get_field(fname)
        x = rand(f, (1 << logn,))
        before = K.dif_rows.launches
        y = ntt(f, x, NTTDir.FORWARD)
        z = ntt(f, y, NTTDir.INVERSE)
        torch.cuda.synchronize()
        if K.dif_rows.launches != before + 4:
            raise AssertionError(f"{fname} 2^{logn}: {K.dif_rows.launches - before} "
                                 "dif_rows launches for two NTTs, expected 4")
        ref = N._ntt_torch(f, x, NTTDir.FORWARD, NTTConfig())
        if y.shape != x.shape or y.dtype != torch.int32 or not torch.equal(y, ref):
            raise AssertionError(f"{fname} 2^{logn}: forward NTT != _ntt_torch")
        if not torch.equal(z, x):
            raise AssertionError(f"{fname} 2^{logn}: inverse(forward(x)) != x")
        if int(y.min()) < 0 or int(y.max()) >= f.modulus:
            raise AssertionError(f"{fname} 2^{logn}: output not canonical")
        del ref, z
        fwd_ms = host_ms(lambda: ntt(f, x, NTTDir.FORWARD))
        inv_ms = host_ms(lambda: ntt(f, y, NTTDir.INVERSE))
        bfly = logn * (1 << (logn - 1))
        paths.append({"field": fname, "logn": logn, "forward_ms": fwd_ms,
                      "inverse_ms": inv_ms, "butterflies_per_s": bfly / (fwd_ms * 1e-3)})
        log(f"  {fname} NTT 2^{logn}: fwd == _ntt_torch, inv round trip exact, 2 launches per "
            f"NTT; forward {fwd_ms:.3f} ms ({bfly / (fwd_ms * 1e-3):.4g} butterflies/s), "
            f"inverse {inv_ms:.3f} ms [{smi}]")
        del x, y
    launches = K.dif_rows.launches
    if launches == 0:
        raise AssertionError("the main path launched no dif_rows kernel")

    # -- where the time goes: device time by kernel -------------------------
    log("== profile: device time by kernel, one forward and one inverse babybear NTT")
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    f = get_field("babybear")
    for logn in (26, 16):
        x = rand(f, (1 << logn,))
        y = ntt(f, x, NTTDir.FORWARD)
        torch.cuda.synchronize()
        for direction, v in ((NTTDir.FORWARD, x), (NTTDir.INVERSE, y)):
            with torch.profiler.profile(activities=activities) as prof:
                t0 = time.perf_counter()
                ntt(f, v, direction)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
            kernels = [e for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA]
            busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
            log(f"  2^{logn} {direction.value}: wall {wall_ms:.3f} ms (profiled), device busy "
                f"{busy_ms:.3f} ms, idle share {1 - busy_ms / wall_ms:.3f}")
            for e in sorted(kernels, key=lambda e: -e.self_device_time_total):
                log(f"    {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:<3d} {e.key[:90]}")
        del x, y
    torch.cuda.synchronize()

    # -- 5. kernels line ------------------------------------------------------
    main_pair = [r for r in shape_rows if r["role"].startswith("2^26 fwd")]
    entry = {
        "name": "dif_rows",
        "route": "cuda",
        "source": "icicle_tpu_torch/kernels/csrc/ntt_dif.cu",
        "replaces": "icicle_tpu/pallas/ntt_kernel.py:53 (make_dif_kernel), "
                    "icicle_tpu/pallas/ntt_kernel.py:172 (make_dif_kernel_mxu)",
        "launches": launches,
        "max_abs_err": max(r["max_abs_diff"] for r in shape_rows),
        # ms, plain_ms, bound_ms: the two launches of one babybear 2^26 forward NTT
        "ms": sum(r["kernel_ms"] for r in main_pair),
        "plain_ms": sum(r["plain_ms"] for r in main_pair),
        "bound_ms": sum(r["bound_ms"] for r in main_pair),
        "bound_by": main_pair[1]["bound_by"],
        "library_ms": None,  # no PyTorch call computes a prime-field NTT
        "shapes": shape_rows,
        "main_path": paths,
        "card": smi,
    }
    print(json.dumps({"kernels": [entry]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
