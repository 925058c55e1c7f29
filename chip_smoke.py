"""Smoke test of the PyTorch/CUDA port (icicle_tpu_torch) on one NVIDIA GPU.

Run from the repository root on a machine with a Hopper card (sm_90a), the
CUDA toolkit and PyTorch built for CUDA:

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0, no result line):
  1. card    -- nvidia-smi name and power limit, torch's device name;
  2. build   -- every kernel library from icicle_tpu_torch/kernels/csrc, one
               nvcc per source, all in parallel, with the compiler's report
               (registers, stack, spills);
  3. kernels -- each kernel against its plain torch version on the card,
               bit-exact, at the shapes the main paths give it: dif_rows
               (NTT), prefix_scan (MSM B3, C = 4096 lanes) and ec_reduce
               (MSM B4, 2048 and 3072 and 24 lanes). The MSM kernels' serial
               depth is cut for the comparison (K = 64, R = 64), since their
               plain versions are Python loops over it; then each is timed
               alone at full depth. Median ms from CUDA events beside the
               plain version's ms and the bound;
  4. NTT     -- the NTT main path through icicle_tpu_torch.ntt on CUDA
               tensors: babybear 2^26, koalabear 2^24, babybear 2^16,
               forward and inverse. Forward must equal the kernel-free
               `_ntt_torch` on the card, inverse must give the input back,
               and each NTT must launch the DIF kernel twice; then a
               torch.profiler breakdown of device time by kernel for one
               forward and one inverse babybear NTT at 2^26 and 2^16;
  5. MSM     -- the MSM main path through icicle_tpu_torch.msm_affine on
               CUDA tensors: bn254 2^24 with bench.py's inputs (one repeated
               point, so the answer is (sum of scalars) * P), which must
               launch B3 12 times and B4 14 times; points/s of msm_tpu3 over
               prepared bases (host clock to synchronize, median of 3 after
               a warm-up); the distinct-point check at 2^16 (P_i = (i+1) P
               against (sum (i+1) s_i) P); a torch.profiler breakdown of one
               2^24 MSM;
  6. the main paths' JSON line (per-path launches, times, profiles);
  7. the kernels JSON line; 8. the result JSON line, last.

Launch counts: every kernel's count is set to 0 just before each checked
main-path call (one NTT forward + inverse, one MSM) and read just after it;
timing and profiling calls are not counted.

Bounds: the least time for the same work is the larger of the bytes the
call must move (each input read once, each output written once) over
3.35 TB/s, and its 32-bit integer multiplies over 16.7 T/s (H100 SXM:
132 SMs x 64 INT32 lanes x 1.98 GHz; half the FP32 lanes that give the
data sheet's 67 TFLOP/s). A one-word Montgomery multiply counts as three
integer multiplies (a*b wide, m = lo*inv32, m*p wide); an L-limb one as
4 L^2 + L (a*b and m*p, low and high words, and the L words of m): 264 at
L = 8. A mixed add (B3's slot) is 11 such multiplies and a projective add
(B4's row) 12, plus two multiplies by b3 = 3b each: add chains with no
integer multiply where b3 is a small integer (bn254: 9, grumpkin: -51), as
in the kernels and the Pallas bodies, else two more Montgomery multiplies.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12
INT_MULS_PER_S = 132 * 64 * 1.98e9
MULS_PER_MONT = 3
REPS = 10
MADD_MONTS = 11   # RCB15 Alg 8, not counting its two multiplies by b3
PADD_MONTS = 12   # RCB15 Alg 7, likewise


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


def host_ms(fn, reps: int = 5):
    """(median ms of fn() + synchronize() on the host clock after a warm-up,
    the last call's result)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), out


def dif_rows_bound(rows: int, log_n: int, factor: bool) -> tuple[float, str]:
    n = 1 << log_n
    # x and out (+ factor), plus the (log_n, N) stage-twiddle table
    nbytes = rows * n * 4 * (3 if factor else 2) + log_n * n * 4
    monts = rows * (log_n * n // 2 + (n if factor else 0))
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    op_ms = monts * MULS_PER_MONT / INT_MULS_PER_S * 1e3
    return (byte_ms, "bytes") if byte_ms >= op_ms else (op_ms, "operations")


def bound(nbytes: float, muls: float) -> tuple[float, str]:
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    op_ms = muls / INT_MULS_PER_S * 1e3
    return (byte_ms, "bytes") if byte_ms >= op_ms else (op_ms, "operations")


def big_mont_muls(nl: int) -> int:
    return 4 * nl * nl + nl


def add_muls(curve, monts: int) -> int:
    """Integer multiplies of one curve add of `monts` Montgomery multiplies
    plus two by b3 (none when b3 is a small integer: an add chain)."""
    from icicle_tpu_torch.kernels.msm_lib import b3_small
    b3_monts = 0 if b3_small(curve) is not None else 2
    return (monts + b3_monts) * big_mont_muls(curve.fq.nlimbs)


def prefix_scan_bound(K: int, C: int, curve) -> tuple[float, str]:
    return bound(K * C * 5 * curve.fq.nlimbs * 4, K * C * add_muls(curve, MADD_MONTS))


def ec_reduce_bound(R: int, C: int, curve) -> tuple[float, str]:
    return bound((R + 1) * C * 3 * curve.fq.nlimbs * 4, R * C * add_muls(curve, PADD_MONTS))


def kernel_counters() -> dict:
    """Each kernel's wrapper; its `launches` attribute counts its launches."""
    from icicle_tpu_torch.kernels import ec_reduce as TR
    from icicle_tpu_torch.kernels import msm_scan as TS
    from icicle_tpu_torch.kernels import ntt_kernel as K
    return {"dif_rows": K.dif_rows, "prefix_scan": TS.prefix_scan, "ec_reduce": TR.ec_reduce}


def counted(path: str, fn, launches: dict):
    """fn() with every kernel's count set to 0 just before it and read just
    after it, synchronised: launches[path] = {kernel: count}."""
    wrappers = kernel_counters()
    for w in wrappers.values():
        w.launches = 0
    out = fn()
    torch.cuda.synchronize()
    launches[path] = {name: w.launches for name, w in wrappers.items()}
    return out


MSM_24 = "msm bn254 2^24 (repeated point)"
MSM_16 = "msm bn254 2^16 (distinct points)"
NTT_MAIN = "ntt babybear 2^26 fwd+inv"


def bench_scalars(rng, n: int) -> np.ndarray:
    """bench.py's scalars (bench.py:53-59): (n, 8) uint32 limbs, 62 random
    bits in limbs 0-1 and random words above (not reduced mod r)."""
    scal_ints = rng.integers(0, 1 << 62, size=n, dtype=np.uint64)
    scal = np.zeros((n, 8), dtype=np.uint32)
    scal[:, 0] = scal_ints & 0xFFFFFFFF
    scal[:, 1] = scal_ints >> 32
    scal[:, 2:] = rng.integers(0, 2**32, size=(n, 6), dtype=np.uint32)
    return scal


def check_msm_kernels(dev, gen, smi: str) -> dict:
    """B3 and B4 against their plain versions on the card at the MSM's lane
    widths (serial depth cut for the plain side), then timed alone at full
    depth. Inputs: random canonical bn254 base-field limbs."""
    from icicle_tpu_torch.curves.params import get_curve
    from icicle_tpu_torch.kernels import ec_reduce as TR
    from icicle_tpu_torch.kernels import msm_scan as TS

    curve = get_curve("bn254")
    nl = curve.fq.nlimbs
    top = curve.fq.modulus >> (32 * (nl - 1))

    def points(depth: int, coords: int, lanes: int) -> torch.Tensor:
        a = torch.randint(0, 1 << 32, (depth, coords, lanes, nl), generator=gen,
                          device=dev, dtype=torch.int64)
        a[..., nl - 1] = torch.randint(0, top, (depth, coords, lanes), generator=gen,
                                       device=dev, dtype=torch.int64)
        return a.to(torch.int32).permute(0, 1, 3, 2).reshape(
            depth, coords * nl, lanes).contiguous()

    kernels = {"prefix_scan": (TS.prefix_scan, TS.prefix_scan_ref, 2, prefix_scan_bound),
               "ec_reduce": (TR.ec_reduce, TR.ec_reduce_ref, 3, ec_reduce_bound)}
    checks = [  # (kernel, depth, lanes, role); the plain side runs every one
        ("prefix_scan", 64, 4096, "B3, one 2^24 window group, K cut from 8192"),
        ("ec_reduce", 64, 2048, "B4, 2^24 cross-tile fold, R cut from 2048"),
        ("ec_reduce", 8, 3072, "B4, 2^24 bucket pass 1"),
        ("ec_reduce", 128, 24, "B4, 2^24 bucket pass 2"),
    ]
    full = [("prefix_scan", 8192, 4096, "B3 at full depth (12 per 2^24 MSM)"),
            ("ec_reduce", 2048, 2048, "B4 cross-tile at full depth (12 per 2^24 MSM)")]
    rows = {name: [] for name in kernels}
    for name, depth, lanes, role in checks:
        fn, ref, coords, bnd = kernels[name]
        x = points(depth, coords, lanes)
        got = fn(curve, x)
        torch.cuda.synchronize()
        want = ref(curve, x)
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        if err != 0 or not torch.equal(got, want):
            raise AssertionError(f"{name} != its plain version at {role}: max abs err {err}")
        kernel_ms = cuda_ms(lambda: fn(curve, x))
        plain_ms = cuda_ms(lambda: ref(curve, x), reps=1)
        bound_ms, bound_by = bnd(depth, lanes, curve)
        rows[name].append({"role": role, "depth": depth, "lanes": lanes, "checked": True,
                           "max_abs_diff": err, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
                           "bound_ms": bound_ms, "bound_by": bound_by})
        log(f"  {name:11s} ({depth}, {coords * nl}, {lanes}) exact; kernel {kernel_ms:.4f} ms, "
            f"plain {plain_ms:.1f} ms, bound {bound_ms:.4f} ms ({bound_by})  [{role}]")
        del x, got, want
    for name, depth, lanes, role in full:
        fn, _, coords, bnd = kernels[name]
        x = points(depth, coords, lanes)
        kernel_ms = cuda_ms(lambda: fn(curve, x), reps=3)
        bound_ms, bound_by = bnd(depth, lanes, curve)
        rows[name].append({"role": role, "depth": depth, "lanes": lanes, "checked": False,
                           "kernel_ms": kernel_ms, "bound_ms": bound_ms, "bound_by": bound_by})
        log(f"  {name:11s} ({depth}, {coords * nl}, {lanes}) kernel {kernel_ms:.3f} ms, bound "
            f"{bound_ms:.3f} ms ({bound_by}), {kernel_ms / bound_ms:.1f}x  [{role}] [{smi}]")
        del x
    torch.cuda.empty_cache()
    return rows


def msm_main_path(dev, smi: str, launches: dict) -> dict:
    """The MSM main path on CUDA tensors; records each checked MSM's kernel
    launches in `launches` and returns its measurements."""
    from icicle_tpu_torch import get_curve, msm_affine
    from icicle_tpu_torch.curves.host_ec import ec_add, ec_mul
    from icicle_tpu_torch.ops.msm_tpu3 import _resolve_plan, msm_tpu3, msm_tpu3_prepare

    curve = get_curve("bn254")
    fr, fq = curve.fr, curve.fq
    mod = fq.modulus
    gen_pt = (curve.gen_x, curve.gen_y)

    def expected_launches(n: int) -> tuple[int, int]:
        plan = _resolve_plan("bn254", n, None, None, None, None, 1)
        groups = -(-plan["n_windows"] // plan["wg"])
        return groups, groups + (2 if plan["M"] > 128 else 1)

    def run_checked(label, n, scal, px, py, want):
        s_dev = torch.from_numpy(scal.view(np.int32)).to(dev)
        got = counted(label, lambda: msm_affine("bn254", s_dev, px, py), launches)
        launched = (launches[label]["prefix_scan"], launches[label]["ec_reduce"])
        if launched != expected_launches(n) or launches[label]["dif_rows"] != 0:
            raise AssertionError(f"{label}: launched {launches[label]}, expected (B3, B4) = "
                                 f"{expected_launches(n)} and no dif_rows")
        want = want if want is not None else (0, 0)
        if got != want:
            raise AssertionError(f"{label}: MSM result {got} != oracle {want}")
        prepared = msm_tpu3_prepare("bn254", px, py)
        torch.cuda.synchronize()
        ms, last = host_ms(lambda: msm_tpu3("bn254", s_dev, prepared=prepared), reps=3)
        if last != want:
            raise AssertionError(f"{label}: timed msm_tpu3 result {last} != oracle {want}")
        log(f"  {label}: == oracle, {launched[0]} B3 + {launched[1]} B4 launches; timed "
            f"over prepared bases == oracle, {ms:.1f} ms, {n / (ms * 1e-3):.4g} points/s [{smi}]")
        return s_dev, prepared, want, {"n": n, "launches_b3": launched[0],
                                       "launches_b4": launched[1], "ms": ms,
                                       "points_per_s": n / (ms * 1e-3)}

    # bench.py's 2^24 inputs (bench.py:48-59): one repeated point
    n = 1 << 24
    rng = np.random.default_rng(0)
    P = ec_mul(gen_pt, 0xDEADBEEF, mod)
    scal = bench_scalars(rng, n)
    total = sum(int(np.sum(scal[:, limb], dtype=np.uint64)) << (32 * limb)
                for limb in range(8)) % fr.modulus
    px = fq.from_ints([P[0]], dev).expand(n, fq.nlimbs)
    py = fq.from_ints([P[1]], dev).expand(n, fq.nlimbs)
    s24, prep24, want24, big = run_checked(MSM_24, n, scal, px, py, ec_mul(P, total, mod))
    del px, py

    # bench.py's distinct-point check (bench.py:158-223) at 2^16
    n2 = 1 << 16
    rng = np.random.default_rng(1)
    P = ec_mul(gen_pt, 0xC0FFEE, mod)
    pts, cur = [], P
    for _ in range(n2):
        pts.append(cur)
        cur = ec_add(cur, P, mod)
    scal = bench_scalars(rng, n2)
    total = sum((i + 1) * int.from_bytes(scal[i].astype("<u4").tobytes(), "little")
                for i in range(n2)) % fr.modulus
    px = fq.from_ints([p[0] for p in pts], dev)
    py = fq.from_ints([p[1] for p in pts], dev)
    _, _, _, small = run_checked(MSM_16, n2, scal, px, py, ec_mul(P, total, mod))
    del px, py

    # where the time goes: one 2^24 MSM over prepared bases
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        got = msm_tpu3("bn254", s24, prepared=prep24)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    if got != want24:
        raise AssertionError(f"profiled 2^24 MSM: {got} != oracle {want24}")
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    log(f"  profile, one 2^24 MSM: wall {wall_ms:.1f} ms (profiled), device busy "
        f"{busy_ms:.1f} ms, idle share {1 - busy_ms / wall_ms:.3f} [{smi}]")
    top = []
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:16]:
        log(f"    {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<4d} {e.key[:90]}")
        top.append({"kernel": e.key[:120], "ms": e.self_device_time_total / 1e3,
                    "count": e.count})
    del s24, prep24
    torch.cuda.empty_cache()
    return {"2^24": big, "2^16_distinct": small,
            "profile": {"wall_ms": wall_ms, "busy_ms": busy_ms, "top": top}}


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
            if ("ptxas info" in line and ("registers" in line or "Compiling" in line)) \
                    or "spill" in line:
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
    log("== kernels: prefix_scan and ec_reduce against their plain versions on the card")
    msm_rows = check_msm_kernels(dev, gen, smi)

    # -- 4. NTT main path -----------------------------------------------------
    log("== main path: icicle_tpu_torch.ntt on CUDA tensors")
    launches = {}  # main path -> {kernel: launches in that path's checked run}
    paths = []
    for fname, logn in (("babybear", 26), ("koalabear", 24), ("babybear", 16)):
        f = get_field(fname)
        x = rand(f, (1 << logn,))
        label = f"ntt {fname} 2^{logn} fwd+inv"

        def fwd_inv():
            fwd = ntt(f, x, NTTDir.FORWARD)
            return fwd, ntt(f, fwd, NTTDir.INVERSE)

        y, z = counted(label, fwd_inv, launches)
        if launches[label] != {"dif_rows": 4, "prefix_scan": 0, "ec_reduce": 0}:
            raise AssertionError(f"{label}: launched {launches[label]}, expected 4 dif_rows "
                                 "for two NTTs and nothing else")
        ref = N._ntt_torch(f, x, NTTDir.FORWARD, NTTConfig())
        if y.shape != x.shape or y.dtype != torch.int32 or not torch.equal(y, ref):
            raise AssertionError(f"{fname} 2^{logn}: forward NTT != _ntt_torch")
        if not torch.equal(z, x):
            raise AssertionError(f"{fname} 2^{logn}: inverse(forward(x)) != x")
        if int(y.min()) < 0 or int(y.max()) >= f.modulus:
            raise AssertionError(f"{fname} 2^{logn}: output not canonical")
        del ref, z
        fwd_ms, _ = host_ms(lambda: ntt(f, x, NTTDir.FORWARD))
        inv_ms, _ = host_ms(lambda: ntt(f, y, NTTDir.INVERSE))
        bfly = logn * (1 << (logn - 1))
        paths.append({"field": fname, "logn": logn, "forward_ms": fwd_ms,
                      "inverse_ms": inv_ms, "butterflies_per_s": bfly / (fwd_ms * 1e-3)})
        log(f"  {fname} NTT 2^{logn}: fwd == _ntt_torch, inv round trip exact, 2 launches per "
            f"NTT; forward {fwd_ms:.3f} ms ({bfly / (fwd_ms * 1e-3):.4g} butterflies/s), "
            f"inverse {inv_ms:.3f} ms [{smi}]")
        del x, y

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
    torch.cuda.empty_cache()

    # -- 5. MSM main path -----------------------------------------------------
    log("== main path: icicle_tpu_torch.msm_affine on CUDA tensors")
    msm = msm_main_path(dev, smi, launches)

    # -- 6. main paths line ---------------------------------------------------
    print(json.dumps({"main_paths": {"ntt": paths, "msm": msm, "launches": launches,
                                     "card": smi}}))

    # -- 7. kernels line ------------------------------------------------------
    # launches: the kernel's count in the checked run of its headline main
    # path (one babybear 2^26 NTT forward + inverse; one bn254 2^24 MSM);
    # launches_per_path: its count in every main path's checked run
    def per_path(kname: str) -> dict:
        return {path: counts[kname] for path, counts in launches.items()}

    main_pair = [r for r in shape_rows if r["role"].startswith("2^26 fwd")]
    entry = {
        "name": "dif_rows",
        "route": "cuda",
        "source": "icicle_tpu_torch/kernels/csrc/ntt_dif.cu",
        "replaces": "icicle_tpu/pallas/ntt_kernel.py:53 (make_dif_kernel), "
                    "icicle_tpu/pallas/ntt_kernel.py:172 (make_dif_kernel_mxu)",
        "launches": launches[NTT_MAIN]["dif_rows"],
        "launches_per_path": per_path("dif_rows"),
        "max_abs_err": max(r["max_abs_diff"] for r in shape_rows),
        # ms, plain_ms, bound_ms: the two launches of one babybear 2^26 forward NTT
        "ms": sum(r["kernel_ms"] for r in main_pair),
        "plain_ms": sum(r["plain_ms"] for r in main_pair),
        "bound_ms": sum(r["bound_ms"] for r in main_pair),
        "bound_by": main_pair[1]["bound_by"],
        "library_ms": None,  # no PyTorch call computes a prime-field NTT
        "shapes": shape_rows,
        "card": smi,
    }

    def msm_entry(kname: str, source: str, replaces: str, main_role: str) -> dict:
        # ms and bound_ms: one launch at the main path's widest full-depth
        # shape; plain_ms: the plain version at the cut depth of the first
        # checked shape, beside the kernel's ms there ("checked_ms")
        rows = msm_rows[kname]
        main = next(r for r in rows if r["role"] == main_role)
        checked = rows[0]
        return {
            "name": kname, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[MSM_24][kname],
            "launches_per_path": per_path(kname),
            "max_abs_err": max(r["max_abs_diff"] for r in rows if r["checked"]),
            "ms": main["kernel_ms"], "plain_ms": checked["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": None,  # no PyTorch call computes an elliptic-curve add
            "shape": [main["depth"], main["lanes"]],
            "plain_shape": [checked["depth"], checked["lanes"]],
            "checked_ms": checked["kernel_ms"],
            "shapes": rows, "card": smi,
        }

    entries = [
        entry,
        msm_entry("prefix_scan", "icicle_tpu_torch/kernels/csrc/msm_scan.cu",
                  "icicle_tpu/pallas/msm_scan.py:45 (make_prefix_scan)",
                  "B3 at full depth (12 per 2^24 MSM)"),
        msm_entry("ec_reduce", "icicle_tpu_torch/kernels/csrc/ec_reduce.cu",
                  "icicle_tpu/pallas/ec_reduce.py:63 (make_ec_reduce)",
                  "B4 cross-tile at full depth (12 per 2^24 MSM)"),
    ]
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
