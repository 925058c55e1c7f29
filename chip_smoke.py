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
               bit-exact, at the lane widths the main paths give it: dif_rows
               (NTT; every pass of the 2^26, 2^25, 2^24 and 2^16 NTTs and a
               log N 14 pass, each in all four layouts: rows or columns in,
               rows or columns out; then its tile heights TR timed at
               (8192, 2^13), and pass A's column reads against the
               transpose they replace), prefix_scan (MSM B3, C = 4096 lanes), ec_reduce (B4,
               2048, 3072 and 24 lanes; v2's 3712 and 29), prefix_scan_r12 (B5, 4096 lanes),
               suffix_fold (B6, 8192 lanes, dummy slots and run ends inside
               K) and bucket_accum (B7, 12 windows x 1024 lanes). The MSM
               kernels' serial depth is cut for the comparison (K = 64,
               R = 64), since their plain versions are Python loops over it;
               B3 and B4, which split that axis into segments, are also
               compared at full depth, at a ragged depth (61), and against
               their serial plain version (segments=1) as projective
               points where the depth is at most 128; then each kernel is
               timed alone at full depth, B3 and B4 also at other segment
               counts. Median ms from CUDA events beside the plain
               version's ms and the bound;
  4. NTT     -- the NTT main path through icicle_tpu_torch.ntt on CUDA
               tensors: babybear 2^26, koalabear 2^24, babybear 2^16,
               forward and inverse. Forward must equal the kernel-free
               `_ntt_torch` on the card, inverse must give the input back,
               and each NTT must launch the DIF kernel twice; then a
               torch.profiler breakdown of device time by kernel for one
               forward and one inverse babybear NTT at 2^26 and 2^16, each
               of which must run two dif_rows launches and no other kernel;
  5. MSM     -- four routes of the bn254 G1 MSM on CUDA tensors, each through
               its entry point: the v3 pipeline (msm_affine; engine "u32",
               B3 + B4), v3 with engine "r12" (msm_affine under
               ICICLE_TPU_MSM_ENGINE=r12; B5 + B4), the v2 pipeline
               (msm_affine under ICICLE_TPU_MSM_PIPELINE=v2; B6 + B4) at
               2^24 with bench.py's inputs (one repeated point, so the
               answer is (sum of scalars) * P), and the v1 pipeline
               (msm_tpu, 1024 lanes; B7) at 2^20 with the same kind of
               inputs. Each must launch exactly the kernels its plan gives
               (counted) and equal the oracle; then points/s (host clock to
               synchronize, median of 3 after a warm-up: v3 over prepared
               bases, v2 and v1 over device-resident points, as bench.py
               times them); then each route on 2^16 distinct points
               (P_i = (i+1) P against (sum (i+1) s_i) P); torch.profiler
               breakdowns of one 2^24 MSM of the u32, r12 and v2 routes
               and one 2^20 MSM of the v1 route;
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
L = 8. A mixed add (B3's slot, B7's slot) is 11 such multiplies and a
projective add (B4's row) 12, plus two multiplies by b3 = 3b each: add
chains with no integer multiply where b3 is a small integer (bn254: 9,
grumpkin: -51), as in the kernels and the Pallas bodies, else two more
Montgomery multiplies. B6's slot is one of each, as its Pallas body
computes. B5 computes B3's function, so its bound is B3's; its own radix-12
multiply count (11 multiplies of 2 nw^2 + nw = 990 at nw = 22, plus 2 nw for
the two by b3) is printed beside it.
"""

from __future__ import annotations

import contextlib
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


def suffix_fold_bound(K: int, C: int, curve) -> tuple[float, str]:
    nl = curve.fq.nlimbs
    return bound((K * (2 * nl + 1) + 3 * nl) * C * 4,
                 K * C * (add_muls(curve, MADD_MONTS) + add_muls(curve, PADD_MONTS)))


def bucket_accum_bound(W: int, K: int, C: int, curve) -> tuple[float, str]:
    return bound(W * K * C * (1 + 5 * curve.fq.nlimbs) * 4,
                 W * K * C * add_muls(curve, MADD_MONTS))


def r12_madd_muls(nw: int) -> int:
    """32-bit multiplies of one radix-12 mixed add: 11 Montgomery multiplies
    of 2 nw^2 + nw and two wordwise multiplies by b3."""
    return MADD_MONTS * (2 * nw * nw + nw) + 2 * nw


def kernel_counters() -> dict:
    """Each kernel's wrapper; its `launches` attribute counts its launches."""
    from icicle_tpu_torch.kernels import ec_reduce as TR
    from icicle_tpu_torch.kernels import msm_fold2 as TF
    from icicle_tpu_torch.kernels import msm_kernel as TK
    from icicle_tpu_torch.kernels import msm_scan as TS
    from icicle_tpu_torch.kernels import msm_scan_r12 as TS12
    from icicle_tpu_torch.kernels import ntt_kernel as K
    return {"dif_rows": K.dif_rows, "prefix_scan": TS.prefix_scan, "ec_reduce": TR.ec_reduce,
            "prefix_scan_r12": TS12.prefix_scan_r12, "suffix_fold": TF.suffix_fold,
            "bucket_accum": TK.bucket_accum}


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
R12_24 = "msm r12 bn254 2^24 (repeated point)"
R12_16 = "msm r12 bn254 2^16 (distinct points)"
V2_24 = "msm v2 bn254 2^24 (repeated point)"
V2_16 = "msm v2 bn254 2^16 (distinct points)"
V1_20 = "msm v1 bn254 2^20 (repeated point)"
V1_16 = "msm v1 bn254 2^16 (distinct points)"
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


# (kernel, depth, lanes, role); the plain side runs every one, once (its
# time from CUDA events around that call); B3's and B4's serial plain
# version, a Python loop over the whole depth, runs where the depth is at
# most SERIAL_DEPTH
SERIAL_DEPTH = 128
MSM_CHECKS = [
    ("prefix_scan", 64, 4096, "B3, one 2^24 window group, K cut from 8192"),
    ("prefix_scan", 61, 4096, "B3, K 61: ragged last segment"),
    ("prefix_scan", 8192, 64, "B3, one 2^16 window group at full depth"),
    ("prefix_scan", 8192, 4096, "B3, one 2^24 window group at full depth"),
    ("ec_reduce", 64, 2048, "B4, 2^24 cross-tile fold, R cut from 2048"),
    ("ec_reduce", 61, 2048, "B4, R 61: ragged and empty segments"),
    ("ec_reduce", 8, 3072, "B4, 2^24 bucket pass 1"),
    ("ec_reduce", 128, 24, "B4, 2^24 bucket pass 2"),
    ("ec_reduce", 64, 3712, "B4, v2 2^24 cross-tile pass 1"),
    ("ec_reduce", 128, 29, "B4, v2 2^24 cross-tile pass 2"),
    ("ec_reduce", 2048, 2048, "B4, 2^24 cross-tile fold at full depth"),
    ("prefix_scan_r12", 64, 4096, "B5, one r12 2^24 window group, K cut from 8192"),
    ("suffix_fold", 64, 8192, "B6, one v2 2^24 window, K cut from 2304"),
    ("bucket_accum", 64, 1024, "B7, one v1 2^20 chunk of 12 windows, K cut from 1024"),
]
# (kernel, depth, lanes, role, keyword arguments): timed only; `_segments`
# times B3 and B4 at another split than their plan's
MSM_FULL = [
    ("prefix_scan", 8192, 4096, "B3 at full depth (12 per 2^24 MSM)", {}),
    ("prefix_scan", 8192, 4096, "B3 variant", {"_segments": 8}),
    ("prefix_scan", 8192, 4096, "B3 variant", {"_segments": 32}),
    ("ec_reduce", 2048, 2048, "B4 cross-tile at full depth (12 per 2^24 MSM)", {}),
    ("ec_reduce", 2048, 2048, "B4 variant", {"_segments": 8}),
    ("ec_reduce", 2048, 2048, "B4 variant", {"_segments": 16}),
    ("prefix_scan_r12", 8192, 4096, "B5 at full depth (12 per r12 2^24 MSM)", {}),
    ("suffix_fold", 2304, 8192, "B6 at full depth (29 per v2 2^24 MSM)", {}),
    ("bucket_accum", 1024, 1024, "B7 at full depth (2 per v1 2^20 MSM)", {}),
]


def same_points(curve, a: torch.Tensor, b: torch.Tensor) -> bool:
    """a, b (..., 3L, C) projective Montgomery limbs on the card: equal as
    projective points (X1 Z2 = X2 Z1, Y1 Z2 = Y2 Z1, X1 Y2 = X2 Y1 by the
    port's BigField) and neither (0, 0, 0)."""
    from icicle_tpu_torch.curves.group import get_group
    from icicle_tpu_torch.kernels.msm_lib import split_point
    m = get_group(curve.name).f.mul_mont
    nl = curve.fq.nlimbs
    (x1, y1, z1), (x2, y2, z2) = (split_point(t.transpose(-1, -2), nl) for t in (a, b))
    zero = any(bool(((x == 0) & (y == 0) & (z == 0)).all(-1).any())
               for x, y, z in ((x1, y1, z1), (x2, y2, z2)))
    return (not zero and torch.equal(m(x1, z2), m(x2, z1)) and torch.equal(m(y1, z2), m(y2, z1))
            and torch.equal(m(x1, y2), m(x2, y1)))


def check_msm_kernels(dev, gen, smi: str) -> dict:
    """B3-B7 against their plain versions on the card at the MSM routes'
    lane widths (serial depth cut for the plain side), then timed alone at
    full depth. B3 and B4 take curve points (a pool of 64 multiples of the
    generator and their negatives; B4's projective, sums of two, with one
    row of identities) and are held bit-exact against their plain versions
    at the plan's segment count, and against the serial plain version
    (segments=1) as projective points; at full depth the split's variants
    are timed beside the plan's. B5-B7 take random canonical bn254
    base-field limbs (any such value is a valid Montgomery form, in R or
    R'), sorted random keys (B7), random flags with dummy slots and run ends
    (B6)."""
    from icicle_tpu_torch.curves.group import Affine, Projective, get_group
    from icicle_tpu_torch.curves.host_ec import ec_mul
    from icicle_tpu_torch.curves.params import get_curve
    from icicle_tpu_torch.kernels import ec_reduce as TR
    from icicle_tpu_torch.kernels import msm_fold2 as TF
    from icicle_tpu_torch.kernels import msm_kernel as TK
    from icicle_tpu_torch.kernels import msm_scan as TS
    from icicle_tpu_torch.kernels import msm_scan_r12 as TS12

    curve = get_curve("bn254")
    fq = curve.fq
    g = get_group("bn254")
    nl = fq.nlimbs
    top = fq.modulus >> (32 * (nl - 1))
    W1 = 12   # windows per B7 launch at the v1 2^20 shape

    def points(*lead, coords: int, lanes: int) -> torch.Tensor:
        """(*lead, coords * L, lanes) int32 canonical limbs, lane-minor."""
        a = torch.randint(0, 1 << 32, (*lead, coords, lanes, nl), generator=gen,
                          device=dev, dtype=torch.int64)
        a[..., nl - 1] = torch.randint(0, top, (*lead, coords, lanes), generator=gen,
                                       device=dev, dtype=torch.int64)
        a = a.to(torch.int32).transpose(-1, -2)          # (*lead, coords, L, lanes)
        return a.reshape(*lead, coords * nl, lanes).contiguous()

    pool = [ec_mul((curve.gen_x, curve.gen_y), 0x5EED + 977 * i, fq.modulus) for i in range(64)]
    pool_x = fq.to_mont(fq.from_ints([p[0] for p in pool] * 2, dev))
    pool_y = fq.to_mont(fq.from_ints([p[1] for p in pool], dev))
    pool_y = torch.cat([pool_y, fq.neg(pool_y)])                  # P and -P
    pair = torch.randint(0, 128, (2, 128), generator=gen, device=dev)
    one = g.one_mont(dev).expand(128, nl)
    pool_proj = torch.cat(list(g.madd(Projective(pool_x[pair[0]], pool_y[pair[0]], one),
                                      Affine(pool_x[pair[1]], pool_y[pair[1]]))), -1)

    def lane_major(t: torch.Tensor) -> torch.Tensor:
        """(D, C, rows) -> (D, rows, C) contiguous."""
        return t.transpose(1, 2).contiguous()

    def curve_affine(depth: int, lanes: int) -> torch.Tensor:
        """(depth, 2L, lanes) Montgomery x || y of pool points."""
        i = torch.randint(0, 128, (depth, lanes), generator=gen, device=dev)
        return lane_major(torch.cat([pool_x[i], pool_y[i]], -1))

    def curve_proj(depth: int, lanes: int) -> torch.Tensor:
        """(depth, 3L, lanes) projective pool points, Z != 1, row 2 the
        identity where depth > 2."""
        pts = pool_proj[torch.randint(0, 128, (depth, lanes), generator=gen, device=dev)]
        if depth > 2:
            pts[2] = torch.cat(list(g.identity((lanes,), dev)), -1)
        return lane_major(pts)

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    def fold_flags(depth: int, lanes: int) -> torch.Tensor:
        real = rand(depth, lanes) < 0.9                  # ~10% dummy slots
        dacc = rand(depth, lanes) < 0.12                 # ~1 run end in 8
        dacc[-1] = True
        return (real.to(torch.int32) * TF.IS_REAL) | (dacc.to(torch.int32) * TF.IS_DACC)

    def sorted_keys(depth: int, lanes: int) -> torch.Tensor:
        k = torch.randint(0, 24, (W1, depth, lanes), generator=gen, device=dev)
        return k.sort(dim=1).values.to(torch.int32).contiguous()

    # name -> (kernel, plain version, inputs(depth, lanes), bound(depth, lanes),
    # segment plan or None)
    kernels = {
        "prefix_scan": (TS.prefix_scan, TS.prefix_scan_ref,
                        lambda d, c: (curve_affine(d, c),),
                        lambda d, c: prefix_scan_bound(d, c, curve), TS.scan_segments),
        "ec_reduce": (TR.ec_reduce, TR.ec_reduce_ref,
                      lambda d, c: (curve_proj(d, c),),
                      lambda d, c: ec_reduce_bound(d, c, curve), TR.reduce_segments),
        "prefix_scan_r12": (TS12.prefix_scan_r12, TS12.prefix_scan_r12_ref,
                            lambda d, c: (points(d, coords=2, lanes=c),),
                            lambda d, c: prefix_scan_bound(d, c, curve), None),
        "suffix_fold": (TF.suffix_fold, TF.suffix_fold_ref,
                        lambda d, c: (points(d, coords=2, lanes=c), fold_flags(d, c)),
                        lambda d, c: suffix_fold_bound(d, c, curve), None),
        "bucket_accum": (TK.bucket_accum, TK.bucket_accum_ref,
                         lambda d, c: (sorted_keys(d, c), points(W1, d, coords=2, lanes=c)),
                         lambda d, c: bucket_accum_bound(W1, d, c, curve), None),
    }
    r12_nw = TS12.r12_engine("bn254").nw
    rows = {name: [] for name in kernels}
    for name, depth, lanes, role in MSM_CHECKS:
        fn, ref, make, bnd, plan = kernels[name]
        args = make(depth, lanes)
        got = fn(curve, *args)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        want = ref(curve, *args)
        end.record()
        end.synchronize()
        plain_ms = start.elapsed_time(end)
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        if err != 0 or not torch.equal(got, want):
            raise AssertionError(f"{name} != its plain version at {role}: max abs err {err}")
        row = {"role": role, "depth": depth, "lanes": lanes, "checked": True,
               "max_abs_diff": err}
        extra = ""
        if plan is not None:
            row["segments"] = plan(depth, lanes)
            extra = f", S {row['segments']}"
            if depth <= SERIAL_DEPTH:
                # the kernel's association against the serial fold, as points
                if not same_points(curve, got, ref(curve, *args, segments=1)):
                    raise AssertionError(f"{name} != its serial plain version (segments=1) "
                                         f"as projective points at {role}")
                row["serial_equal_as_points"] = True
                extra += ", == serial as points"
        kernel_ms = cuda_ms(lambda: fn(curve, *args))
        bound_ms, bound_by = bnd(depth, lanes)
        row.update(kernel_ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
        rows[name].append(row)
        log(f"  {name:15s} {tuple(args[-1].shape)} exact{extra}; kernel {kernel_ms:.4f} ms, "
            f"plain {plain_ms:.1f} ms, bound {bound_ms:.4f} ms ({bound_by})  [{role}]")
        del args, got, want
    for name, depth, lanes, role, kw in MSM_FULL:
        fn, _, make, bnd, plan = kernels[name]
        args = make(depth, lanes)
        kernel_ms = cuda_ms(lambda: fn(curve, *args, **kw), reps=3)
        bound_ms, bound_by = bnd(depth, lanes)
        row = {"role": role, "depth": depth, "lanes": lanes, "checked": False,
               "kernel_ms": kernel_ms, "bound_ms": bound_ms, "bound_by": bound_by}
        extra = ""
        if plan is not None:
            row["segments"] = kw.get("_segments", plan(depth, lanes))
            extra = f", S {row['segments']}"
        if name == "prefix_scan_r12":
            # its own arithmetic: radix-12 multiplies at the integer rate
            row["r12_muls"] = depth * lanes * r12_madd_muls(r12_nw)
            row["r12_muls_ms"] = row["r12_muls"] / INT_MULS_PER_S * 1e3
            extra = f", its radix-12 multiplies alone {row['r12_muls_ms']:.3f} ms"
        rows[name].append(row)
        log(f"  {name:15s} {tuple(args[-1].shape)} kernel {kernel_ms:.3f} ms, bound "
            f"{bound_ms:.3f} ms ({bound_by}), {kernel_ms / bound_ms:.1f}x{extra}  [{role}] [{smi}]")
        del args
    torch.cuda.empty_cache()
    return rows


@contextlib.contextmanager
def env(name: str, value: str):
    """os.environ[name] = value inside the block, restored after it."""
    old = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if old is None:
            del os.environ[name]
        else:
            os.environ[name] = old


def expected_launches(route: str, n: int) -> dict:
    """Each kernel's launches in one MSM of `route` at n points, from the
    ported plan functions."""
    from icicle_tpu_torch.ops import msm_tpu as V1
    from icicle_tpu_torch.ops import msm_tpu2 as V2
    from icicle_tpu_torch.ops import msm_tpu3 as V3

    counts = dict.fromkeys(kernel_counters(), 0)
    nbits = 254
    if route in ("u32", "r12"):
        plan = V3._resolve_plan("bn254", n, None, None, None, route, 1)
        groups = -(-plan["n_windows"] // plan["wg"])
        counts["prefix_scan" if route == "u32" else "prefix_scan_r12"] = groups
        counts["ec_reduce"] = groups + (2 if plan["M"] > 128 else 1)
    elif route == "v2":
        _, _, _, tiles, n_windows, wg = V2._plan2(n, None, nbits, None)
        counts["suffix_fold"] = -(-n_windows // wg)
        counts["ec_reduce"] = 2 if tiles > 128 else 1
    else:
        _, n_windows, _, _ = V1._plan(n, None, nbits, 1024)
        per_chunk = V1._auto_wchunk(n, n_windows, 8) or n_windows
        counts["bucket_accum"] = -(-n_windows // per_chunk)
    return counts


def msm_main_paths(dev, smi: str, launches: dict) -> dict:
    """The MSM routes on CUDA tensors; records each checked MSM's kernel
    launches in `launches` and returns the measurements."""
    from icicle_tpu_torch import get_curve, msm_affine
    from icicle_tpu_torch.curves.host_ec import ec_add, ec_mul
    from icicle_tpu_torch.ops.msm_tpu import msm_tpu
    from icicle_tpu_torch.ops.msm_tpu2 import msm_tpu2
    from icicle_tpu_torch.ops.msm_tpu3 import msm_tpu3, msm_tpu3_prepare

    curve = get_curve("bn254")
    fr, fq = curve.fr, curve.fq
    mod = fq.modulus
    gen_pt = (curve.gen_x, curve.gen_y)

    def entry(route: str):
        """The route's entry point a user calls: (s, px, py) -> affine."""
        if route == "u32":
            return lambda s, x, y: msm_affine("bn254", s, x, y)
        if route == "r12":
            def run(s, x, y):
                with env("ICICLE_TPU_MSM_ENGINE", "r12"):
                    return msm_affine("bn254", s, x, y)
            return run
        if route == "v2":
            def run(s, x, y):
                with env("ICICLE_TPU_MSM_PIPELINE", "v2"):
                    return msm_affine("bn254", s, x, y)
            return run
        return lambda s, x, y: msm_tpu("bn254", s, x, y)

    def timed_call(route: str, s, x, y):
        """The call points/s is measured over: v3 over prepared bases (set-up
        outside the timed region, as bench.py), v2 and v1 over device points."""
        if route in ("u32", "r12"):
            prepared = msm_tpu3_prepare("bn254", x, y, engine=route)
            torch.cuda.synchronize()
            return lambda: msm_tpu3("bn254", s, prepared=prepared)
        if route == "v2":
            return lambda: msm_tpu2("bn254", s, x, y)
        return lambda: msm_tpu("bn254", s, x, y)

    def run_checked(route, label, n, scal, px, py, want, timed=True):
        s_dev = torch.from_numpy(scal.view(np.int32)).to(dev)
        got = counted(label, lambda: entry(route)(s_dev, px, py), launches)
        if launches[label] != expected_launches(route, n):
            raise AssertionError(f"{label}: launched {launches[label]}, expected "
                                 f"{expected_launches(route, n)}")
        want = want if want is not None else (0, 0)
        if got != want:
            raise AssertionError(f"{label}: MSM result {got} != oracle {want}")
        launched = {k: v for k, v in launches[label].items() if v}
        out = {"n": n, "route": route, "launches": launched}
        if timed:
            call = timed_call(route, s_dev, px, py)
            ms, last = host_ms(call, reps=3)
            if last != want:
                raise AssertionError(f"{label}: timed result {last} != oracle {want}")
            out.update(ms=ms, points_per_s=n / (ms * 1e-3))
            log(f"  {label}: == oracle, launches {launched}; timed == oracle, {ms:.1f} ms, "
                f"{n / (ms * 1e-3):.4g} points/s [{smi}]")
        else:
            log(f"  {label}: == oracle, launches {launched} [{smi}]")
        return s_dev, out

    def bench_inputs(n: int, seed: int):
        """bench.py's inputs (bench.py:48-59): one repeated point."""
        rng = np.random.default_rng(seed)
        P = ec_mul(gen_pt, 0xDEADBEEF, mod)
        scal = bench_scalars(rng, n)
        total = sum(int(np.sum(scal[:, limb], dtype=np.uint64)) << (32 * limb)
                    for limb in range(8)) % fr.modulus
        px = fq.from_ints([P[0]], dev).expand(n, fq.nlimbs)
        py = fq.from_ints([P[1]], dev).expand(n, fq.nlimbs)
        return scal, px, py, ec_mul(P, total, mod)

    def profile(label: str, call, want) -> dict:
        activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=activities) as prof:
            t0 = time.perf_counter()
            got = call()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        if got != want:
            raise AssertionError(f"profiled {label}: {got} != oracle {want}")
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
        log(f"  profile, one {label}: wall {wall_ms:.1f} ms (profiled), device busy "
            f"{busy_ms:.1f} ms, idle share {1 - busy_ms / wall_ms:.3f} [{smi}]")
        top = []
        for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:16]:
            log(f"    {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<4d} {e.key[:90]}")
            top.append({"kernel": e.key[:120], "ms": e.self_device_time_total / 1e3,
                        "count": e.count})
        return {"wall_ms": wall_ms, "busy_ms": busy_ms, "top": top}

    out = {}
    # 2^24 with bench.py's inputs: v3 "u32", v3 "r12", v2
    n = 1 << 24
    scal, px, py, want24 = bench_inputs(n, 0)
    profiles = {}
    for route, label in (("u32", MSM_24), ("r12", R12_24), ("v2", V2_24)):
        s24, out[label] = run_checked(route, label, n, scal, px, py, want24)
        profiles[label] = profile(label, timed_call(route, s24, px, py), want24)
        del s24
        torch.cuda.empty_cache()
    del px, py

    # v1 at 2^20 with the same kind of inputs
    n = 1 << 20
    scal, px, py, want20 = bench_inputs(n, 2)
    s20, out[V1_20] = run_checked("v1", V1_20, n, scal, px, py, want20)
    profiles[V1_20] = profile(V1_20, timed_call("v1", s20, px, py), want20)
    del s20, px, py

    # bench.py's distinct-point check (bench.py:158-223) at 2^16, every route
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
    want16 = ec_mul(P, total, mod)
    for route, label in (("u32", MSM_16), ("r12", R12_16), ("v2", V2_16), ("v1", V1_16)):
        _, out[label] = run_checked(route, label, n2, scal, px, py, want16,
                                    timed=route == "u32")
    del px, py
    torch.cuda.empty_cache()
    out["profiles"] = profiles
    return out


LAYOUTS = [(False, False), (False, True), (True, False), (True, True)]


def layout_name(tin: bool, tout: bool) -> str:
    return {(False, False): "rows", (False, True): "rows>cols", (True, False): "cols>rows",
            (True, True): "cols"}[(tin, tout)]


def time_dif_variants(f, dev, rand, K, smi: str) -> dict:
    """dif_rows at the 2^26 NTT's (8192, 2^13) with each tile height TR that
    fits (the plan's pick marked), in the two passes' layouts and the
    default one; and pass A's column reads against the transpose they
    replace (x.T.contiguous() and then a pass that reads rows)."""
    rows, log_n = 8192, 13
    tw = K._stage_twiddles(f, log_n, True, dev)
    out = {"shape": [rows, 1 << log_n], "card": smi, "tr": {}}
    for tin, tout, with_factor in ((True, True, False), (False, True, True),
                                   (False, False, False), (False, False, True)):
        shape = (1 << log_n, rows) if tin else (rows, 1 << log_n)
        x = rand(f, shape)
        factor = rand(f, shape) if with_factor else None
        plan_tr = K.dif_plan(rows, log_n, tin, tout)[0]
        times = {}
        for tr in (1, 2, 4, 8):
            if K.dif_smem_bytes(log_n, tr) <= K.SMEM_LIMIT:
                times[tr] = cuda_ms(lambda: K.dif_rows(f, x, tw, factor, transpose_in=tin,
                                                       transpose_out=tout, _tr=tr))
        key = layout_name(tin, tout) + (" factor" if with_factor else "")
        out["tr"][key] = {"plan_tr": plan_tr, "ms": times,
                          "bound_ms": dif_rows_bound(rows, log_n, with_factor)[0]}
        log(f"  TR variants, {key:15s}: " + ", ".join(
            f"TR {tr}{'*' if tr == plan_tr else ''} {ms:.4f} ms" for tr, ms in times.items())
            + f" (bound {out['tr'][key]['bound_ms']:.4f} ms) [{smi}]")
        del x, factor
    x = rand(f, (1 << log_n, rows))
    t_ms = cuda_ms(lambda: x.T.contiguous())
    via_t = cuda_ms(lambda: K.dif_rows(f, x.T.contiguous(), tw, transpose_out=True))
    cols = cuda_ms(lambda: K.dif_rows(f, x, tw, transpose_in=True, transpose_out=True))
    out["transpose_in"] = {"transpose_ms": t_ms, "transpose_then_rows_ms": via_t,
                           "cols_ms": cols}
    log(f"  pass A with column reads {cols:.4f} ms against x.T.contiguous() {t_ms:.4f} ms "
        f"then a row pass: {via_t:.4f} ms together")
    del x
    torch.cuda.empty_cache()
    return out


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
    log("== kernels: dif_rows against dif_rows_ref on the card, every layout")
    # (field, rows, log_n, forward, factor, role on the main path); each pass
    # is checked in all four layouts, timed in each, and its plain version
    # timed in the layout the four-step gives it (pass A: columns in and
    # out, pass B: rows in, columns out)
    shapes = [
        ("babybear", 8192, 13, True, False, "2^26 fwd pass A"),
        ("babybear", 8192, 13, True, True, "2^26 fwd pass B"),
        ("babybear", 8192, 13, False, False, "2^26 inv pass A"),
        ("babybear", 8192, 13, False, True, "2^26 inv pass B"),
        ("koalabear", 4096, 12, True, False, "2^24 fwd pass A"),
        ("koalabear", 4096, 12, True, True, "2^24 fwd pass B"),
        ("babybear", 8192, 12, True, False, "2^25 fwd pass A (rows != N)"),
        ("babybear", 4096, 13, True, True, "2^25 fwd pass B (rows != N)"),
        ("babybear", 256, 8, True, False, "2^16 fwd pass A"),
        ("babybear", 256, 8, True, True, "2^16 fwd pass B"),
        ("babybear", 8192, 14, True, True, "2^27 fwd pass B (logN 14, 64 KB rows)"),
    ]
    shape_rows = []
    for fname, rows, log_n, forward, with_factor, role in shapes:
        f = get_field(fname)
        tw = K._stage_twiddles(f, log_n, forward, dev)
        main_layout = (False, True) if with_factor else (True, True)
        for tin, tout in LAYOUTS:
            shape = (1 << log_n, rows) if tin else (rows, 1 << log_n)
            x = rand(f, shape)
            factor = rand(f, shape) if with_factor else None

            def call(fn=K.dif_rows, x=x, factor=factor, tin=tin, tout=tout):
                return fn(f, x, tw, factor, transpose_in=tin, transpose_out=tout)

            got = call()
            torch.cuda.synchronize()
            want = call(K.dif_rows_ref)
            err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
            layout = layout_name(tin, tout)
            if err != 0 or not torch.equal(got, want):
                raise AssertionError(f"dif_rows != dif_rows_ref at {role}, {layout}: "
                                     f"max abs err {err}")
            kernel_ms = cuda_ms(call)
            plain_ms = cuda_ms(lambda: call(K.dif_rows_ref), reps=3) \
                if (tin, tout) == main_layout else None
            bound_ms, bound_by = dif_rows_bound(rows, log_n, with_factor)
            shape_rows.append({"role": role, "field": fname, "rows": rows, "N": 1 << log_n,
                               "factor": with_factor, "layout": layout,
                               "main_path": (tin, tout) == main_layout,
                               "plan": K.dif_plan(rows, log_n, tin, tout),
                               "max_abs_diff": err, "kernel_ms": kernel_ms,
                               "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by})
            plain = "" if plain_ms is None else f", plain {plain_ms:.3f} ms"
            log(f"  {role:38s} {layout:9s} {fname:9s} ({rows}, {1 << log_n}) exact; kernel "
                f"{kernel_ms:.4f} ms{plain}, bound {bound_ms:.4f} ms ({bound_by})")
            del x, factor, got, want
    torch.cuda.empty_cache()
    dif_variants = time_dif_variants(f=get_field("babybear"), dev=dev, rand=rand, K=K, smi=smi)
    log("== kernels: the MSM kernels B3-B7 against their plain versions on the card")
    log("== kernels: the MSM kernels B3-B7 against their plain versions on the card")
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
        if launches[label] != dict(dict.fromkeys(kernel_counters(), 0), dif_rows=4):
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
            # the four-step is two dif_rows launches and no other kernel
            if (any("dif_rows" not in e.key for e in kernels)
                    or sum(e.count for e in kernels) != 2):
                raise AssertionError(f"2^{logn} {direction.value} NTT ran device kernels "
                                     f"other than two dif_rows launches: "
                                     f"{[(e.key, e.count) for e in kernels]}")
        del x, y
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # -- 5. MSM main paths ----------------------------------------------------
    log("== main paths: the MSM routes (msm_affine, its r12 engine and v2 pipeline, msm_tpu) "
        "on CUDA tensors")
    msm = msm_main_paths(dev, smi, launches)

    # -- 6. main paths line ---------------------------------------------------
    print(json.dumps({"main_paths": {"ntt": paths, "msm": msm, "launches": launches,
                                     "card": smi}}))

    # -- 7. kernels line ------------------------------------------------------
    # launches: the kernel's count in the checked run of its headline main
    # path (one babybear 2^26 NTT forward + inverse; one bn254 2^24 MSM of
    # its route, 2^20 for v1); launches_per_path: its count in every main
    # path's checked run
    def per_path(kname: str) -> dict:
        return {path: counts[kname] for path, counts in launches.items()}

    main_pair = [r for r in shape_rows if r["role"].startswith("2^26 fwd") and r["main_path"]]
    entry = {
        "name": "dif_rows",
        "route": "cuda",
        "source": "icicle_tpu_torch/kernels/csrc/ntt_dif.cu",
        "replaces": "icicle_tpu/pallas/ntt_kernel.py:53 (make_dif_kernel), "
                    "icicle_tpu/pallas/ntt_kernel.py:172 (make_dif_kernel_mxu)",
        "launches": launches[NTT_MAIN]["dif_rows"],
        "launches_per_path": per_path("dif_rows"),
        "max_abs_err": max(r["max_abs_diff"] for r in shape_rows),
        # ms, plain_ms, bound_ms: the two launches of one babybear 2^26 forward
        # NTT, each in its layout there (pass A columns, pass B rows>cols)
        "ms": sum(r["kernel_ms"] for r in main_pair),
        "plain_ms": sum(r["plain_ms"] for r in main_pair),
        "bound_ms": sum(r["bound_ms"] for r in main_pair),
        "bound_by": main_pair[1]["bound_by"],
        "library_ms": None,  # no PyTorch call computes a prime-field NTT
        "shapes": shape_rows,
        "variants": dif_variants,
        "card": smi,
    }

    def msm_entry(kname: str, source: str, replaces: str, main_role: str,
                  headline: str) -> dict:
        # ms and bound_ms: one launch at the main path's widest full-depth
        # shape; plain_ms: the plain version at the cut depth of the first
        # checked shape, beside the kernel's ms there ("checked_ms")
        rows = msm_rows[kname]
        main = next(r for r in rows if r["role"] == main_role)
        checked = rows[0]
        return {
            "name": kname, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[headline][kname], "headline_path": headline,
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
                  "B3 at full depth (12 per 2^24 MSM)", MSM_24),
        msm_entry("ec_reduce", "icicle_tpu_torch/kernels/csrc/ec_reduce.cu",
                  "icicle_tpu/pallas/ec_reduce.py:63 (make_ec_reduce)",
                  "B4 cross-tile at full depth (12 per 2^24 MSM)", MSM_24),
        msm_entry("prefix_scan_r12", "icicle_tpu_torch/kernels/csrc/msm_scan_r12.cu",
                  "icicle_tpu/pallas/msm_scan_r12.py:135 (make_prefix_scan_r12)",
                  "B5 at full depth (12 per r12 2^24 MSM)", R12_24),
        msm_entry("suffix_fold", "icicle_tpu_torch/kernels/csrc/msm_fold2.cu",
                  "icicle_tpu/pallas/msm_fold2.py:75 (make_suffix_fold)",
                  "B6 at full depth (29 per v2 2^24 MSM)", V2_24),
        msm_entry("bucket_accum", "icicle_tpu_torch/kernels/csrc/bucket_accum.cu",
                  "icicle_tpu/pallas/msm_kernel.py:125 (make_bucket_accum)",
                  "B7 at full depth (2 per v1 2^20 MSM)", V1_20),
    ]
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
