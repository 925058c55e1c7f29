"""The MSM's CUDA libraries (`msm_scan` from kernels/csrc/msm_scan.cu,
`ec_reduce` from ec_reduce.cu, `precompute_bases` from precompute_bases.cu,
`msm_fold2` from msm_fold2.cu and `bucket_accum` from bucket_accum.cu, all
over ec_field.cuh, B3's and B4's instances of 12 or more words a
coordinate and every precompute_bases instance over ec_wide.cuh too; `msm_scan_r12` from
msm_scan_r12.cu over radix12.cuh):
loading with ctypes, the curve constants their kernels take, and the checks
the wrappers share.

An instance is keyed on (limbs, degree): the base field's limb count and
the coordinate field's degree over it, 1 for G1 (and for bw6_761's G2,
which lies over Fq), 2 for G2 over Fp2. B3 (`prefix_scan`), B4
(`ec_reduce`) and `precompute_bases` are built for (8, 1) (bn254,
grumpkin), (12, 1) (bls12_377, bls12_381), (24, 1) (bw6_761), and over
Fp2 for (8, 2) (bn254's G2) and (12, 2) (bls12_377's and bls12_381's G2):
B3 and B4 as one library an instance (`msm_scan_l12`, `msm_scan_fp2`,
...), the precompute kernel as one library a degree. B5
(`prefix_scan_r12`), B6 (`suffix_fold`) and B7 (`bucket_accum`) are built
over Fp only, for (8, 1), (12, 1) and (24, 1), one library an instance
(`msm_scan_r12_l12`, `msm_fold2_l24`, ...); B5's libraries hold the
radix-12 schedules of their limb count's curves. Over Fp every kernel
multiplies by b3 = 3b as a small integer, and a curve without an instance
raises before a launch; over Fp2 b3 is a constant of the consts array. Every C entry point takes its
tensors' device pointers, its int dimensions, L (and D for the kernels
with Fp2 instances), a host array of curve constants and the stream, and
returns the launch's cudaError_t. The wrappers take a curve name, a
`Curve` (its G1) or a `Group` (`as_group`).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from icicle_tpu_torch.curves.group import Group, Projective, get_group
from icicle_tpu_torch.curves.params import Curve, get_curve
from icicle_tpu_torch.kernels import build
from icicle_tpu_torch.math.params import limbs_of
from icicle_tpu_torch.runtime.errors import IcicleError, IcicleException

# kernel -> ({limb count: library in build.LIBRARIES} over Fp, its C entry
# point, number of tensor arguments, number of int dimensions before L)
KERNELS = {"prefix_scan": ({8: "msm_scan", 12: "msm_scan_l12", 24: "msm_scan_l24"},
                           "icicle_msm_prefix_scan", 3, 3),
           "ec_reduce": ({8: "ec_reduce", 12: "ec_reduce_l12", 24: "ec_reduce_l24"},
                         "icicle_msm_ec_reduce", 2, 3),
           "precompute_bases": (dict.fromkeys((8, 12, 24), "precompute_bases"),
                                "icicle_msm_precompute_bases", 5, 3),
           "prefix_scan_r12": ({8: "msm_scan_r12", 12: "msm_scan_r12_l12",
                                24: "msm_scan_r12_l24"}, "icicle_msm_prefix_scan_r12", 3, 3),
           "suffix_fold": ({8: "msm_fold2", 12: "msm_fold2_l12", 24: "msm_fold2_l24"},
                           "icicle_msm_suffix_fold", 5, 4),
           "bucket_accum": ({8: "bucket_accum", 12: "bucket_accum_l12", 24: "bucket_accum_l24"},
                            "icicle_msm_bucket_accum", 6, 4)}
# kernel -> {base limb count: library} over Fp2; these kernels' C entry
# points take the degree D after L (every instance of them)
FP2_KERNELS = {"prefix_scan": {8: "msm_scan_fp2", 12: "msm_scan_fp2_l12"},
               "ec_reduce": {8: "ec_reduce_fp2", 12: "ec_reduce_fp2_l12"},
               "precompute_bases": dict.fromkeys((8, 12), "precompute_bases_fp2")}
# the limb counts with a built instance of some MSM kernel over Fp
KERNEL_LIMBS = frozenset(nl for libraries, *_ in KERNELS.values() for nl in libraries)


def libraries(kernel: str, degree: int) -> dict:
    """{base limb count: library} of `kernel`'s instances of `degree`."""
    return KERNELS[kernel][0] if degree == 1 else FP2_KERNELS.get(kernel, {})


# threads the split of B3's and B4's serial axis aims to run: about two
# waves of one resident 256-thread block on each of the H100's 132 SMs
TARGET_THREADS = 1 << 16
# B5's and B6's: one such wave (128 of the 132 SMs); on the card the scan
# and fold ran no faster at twice these threads and half as fast at half.
# B4's wide instances' (ec_reduce.plan_threads): one wave of their two
# 128-thread blocks an SM
ONE_WAVE_THREADS = 1 << 15


def as_curve(curve) -> Curve:
    return get_curve(curve) if isinstance(curve, str) else curve


def as_group(curve) -> Group:
    """A curve name or a `Curve` -> its G1 group; a `Group` as it is."""
    if isinstance(curve, Group):
        return curve
    return get_group(as_curve(curve).name)


def instance(group: Group) -> tuple[int, int]:
    """The (limbs, degree) key of the group's kernel instances: the base
    field's limb count and the coordinate field's degree over it."""
    return group.base_limbs, group.degree


def invalid(kernel: str, msg: str) -> IcicleException:
    return IcicleException(IcicleError.INVALID_ARGUMENT, f"{kernel}: {msg}")


def _check_int32(kernel: str, t: torch.Tensor) -> None:
    if t.device.type not in ("cpu", "cuda"):
        raise invalid(kernel, f"expected a CPU or CUDA tensor, got {t.device}")
    if t.dtype != torch.int32:
        raise invalid(kernel, f"expected int32, got {t.dtype}")
    if not t.is_contiguous():
        raise invalid(kernel, "input must be contiguous")


def check_points(kernel: str, t: torch.Tensor, rows: int, ndim: int = 3) -> None:
    """t must be a contiguous int32 (..., rows, C) tensor of `ndim` nonzero
    dimensions on the CPU or CUDA."""
    _check_int32(kernel, t)
    if t.dim() != ndim or t.shape[-2] != rows or min(t.shape) < 1:
        lead = ", ".join("D" * (ndim - 2))
        raise invalid(kernel, f"expected ({lead}, {rows}, C), got {tuple(t.shape)}")


def check_aux(kernel: str, t: torch.Tensor, shape, like: torch.Tensor) -> None:
    """t (flags, keys) must be a contiguous int32 tensor of `shape` on
    `like`'s device."""
    _check_int32(kernel, t)
    if tuple(t.shape) != tuple(shape):
        raise invalid(kernel, f"expected {tuple(shape)}, got {tuple(t.shape)}")
    if t.device != like.device:
        raise invalid(kernel, f"inputs on {t.device} and {like.device}")


def segment_rows(t: torch.Tensor, S: int) -> torch.Tensor:
    """(D, rows, C) -> (ceil(D/S), S, C, rows) for the plain versions of the
    split kernels: step j of segment s is row s * ceil(D/S) + j; rows past D
    are zeros, which `step_mask` masks."""
    D, rows, C = t.shape
    n = -(-D // S)
    pad = t.new_zeros((S * n - D, rows, C))
    return torch.cat([t, pad]).view(S, n, rows, C).permute(1, 0, 3, 2)


def step_mask(j: int, n: int, D: int, S: int, device) -> torch.Tensor | None:
    """None if step j of every segment of length n lies inside D, else the
    (S, 1) mask of the segments whose step j does."""
    if (S - 1) * n + j < D:
        return None
    return (torch.arange(S, device=device) * n + j < D).view(S, 1)


def cat_point(p: Projective) -> torch.Tensor:
    """(..., L) x, y, z -> (..., 3L)."""
    return torch.cat(tuple(p), dim=-1)


def split_point(t: torch.Tensor, nl: int) -> Projective:
    """(..., 3L) -> (..., L) x, y, z views."""
    return Projective(t[..., :nl], t[..., nl:2 * nl], t[..., 2 * nl:])


def b3_small(group) -> int | None:
    """b3 = 3b mod p, centred, if it is a small integer (|b3| <= 2^20), else
    None: the rule of the Pallas bodies (pallas/msm_kernel.py `_b3_small`).
    Over Fp2, k where b3 = k + k u with k small (ec_field.cuh f_mul_b3's
    add chains), else None. Takes a Group or a curve (its G1)."""
    group = as_group(group)
    p = group.curve.fq.modulus
    b3 = group.b3
    if group.degree == 2:
        if b3[0] != b3[1]:
            return None
        b3 = b3[0]
    b = b3 if b3 < p // 2 else b3 - p
    return int(b) if abs(b) <= 1 << 20 else None


@functools.lru_cache(maxsize=None)
def _entry(kernel: str, key: tuple):
    _, entry, n_tensors, n_dims = KERNELS[kernel]
    lib = build.load(libraries(kernel, key[1])[key[0]])
    fn = getattr(lib, entry)
    fn.argtypes = ([ctypes.c_void_p] * n_tensors
                   + [ctypes.c_int] * (n_dims + 1 + (kernel in FP2_KERNELS))
                   + [ctypes.c_void_p, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.icicle_msm_error_string.argtypes = [ctypes.c_int]
    lib.icicle_msm_error_string.restype = ctypes.c_char_p
    return fn, lib.icicle_msm_error_string


def consts_values(group: Group) -> list:
    """The kernels' constants as uint32 words: {p[L], one[L], inv32, b3}
    over Fp (ec_field.cuh CurveConsts; b3 a small signed integer's
    two's-complement bits); over Fp2 {p[L], one[L], inv32, k, nr,
    b3.c0[L], b3.c1[L]} (fp2_consts_from: b3 in Montgomery form, k its
    small part where b3 = k + k u, else 0)."""
    fp = group.curve.fq.params
    nl = fp.nlimbs
    b3 = b3_small(group)
    values = limbs_of(fp.modulus, nl) + limbs_of(fp.to_mont_int(1), nl) + [fp.inv32]
    if group.degree == 1:
        return values + [b3 & 0xFFFFFFFF]
    nr = group.coord_field.engine.w
    return (values + [(b3 or 0) & 0xFFFFFFFF, nr & 0xFFFFFFFF]
            + limbs_of(group.b3_int[0], nl) + limbs_of(group.b3_int[1], nl))


@functools.lru_cache(maxsize=None)
def _consts(group: Group):
    values = consts_values(group)
    return (ctypes.c_uint32 * len(values))(*values)


def not_built(kernel: str, curve, why: str) -> IcicleException:
    group = as_group(curve)
    which = f"{group.curve.name} G2" if group.g2 else group.curve.name
    return IcicleException(IcicleError.API_NOT_IMPLEMENTED,
                           f"{kernel}: {why}; no CUDA kernel for {which}")


def built_limbs(kernel: str, degree: int = 1) -> tuple:
    """The base limb counts `kernel` has an instance of `degree` for."""
    return tuple(sorted(libraries(kernel, degree)))


def require_instance(kernel: str, group) -> None:
    """Raises API_NOT_IMPLEMENTED unless `kernel` has an instance for the
    group's (limbs, degree) and, over Fp, the group's b3 is a small
    integer; callable on the CPU. Takes a Group or a curve (its G1)."""
    group = as_group(group)
    nl, degree = instance(group)
    built = built_limbs(kernel, degree)
    counts = ", ".join(map(str, built)) or "no"
    if degree == 2:
        if nl not in built:
            raise not_built(kernel, group, f"the CUDA kernel is built over Fp2 for {counts}-limb "
                            f"base fields, and {group.curve.name}'s G2 has {nl} limbs")
        return
    if nl not in built or b3_small(group) is None:
        has = f"{nl} limbs" if nl not in built else "a b3 that is not a small integer"
        raise not_built(kernel, group, f"the CUDA kernel is built for {counts}-limb fields "
                        f"with a small b3, and {group.curve.name} has {has}")


def launch(kernel: str, group, tensors, dims, consts=None) -> None:
    """Launch `kernel` over `tensors` (inputs, then the output) with its int
    dimensions `dims` on the current stream; `consts` defaults to the
    ec_field.cuh constants of the group (a Group, or a curve's G1). Raises
    if the group has no instance or the launch is refused."""
    group = as_group(group)
    require_instance(kernel, group)
    key = instance(group)
    fn, error_string = _entry(kernel, key)
    consts = consts if consts is not None else _consts(group)
    degree = (key[1],) if kernel in FP2_KERNELS else ()
    with torch.cuda.device(tensors[0].device):
        err = fn(*(t.data_ptr() for t in tensors), *dims, key[0], *degree,
                 ctypes.addressof(consts), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise IcicleException(IcicleError.UNKNOWN_ERROR,
                              f"{kernel} launch failed: {error_string(err).decode()}")
