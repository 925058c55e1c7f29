"""The MSM's CUDA libraries (`msm_scan` from kernels/csrc/msm_scan.cu,
`ec_reduce` from ec_reduce.cu, `msm_fold2` from msm_fold2.cu and
`bucket_accum` from bucket_accum.cu, all over ec_field.cuh; `msm_scan_r12`
from msm_scan_r12.cu over radix12.cuh): loading with ctypes, the curve
constants their kernels take, and the checks the wrappers share.

The kernels are instantiated for L = 8 limbs (bn254, grumpkin) and multiply
by b3 = 3b as a small integer; other curves raise before a launch. Every C
entry point takes its tensors' device pointers, its int dimensions, L, a
host array of curve constants and the stream, and returns the launch's
cudaError_t.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from icicle_tpu_torch.curves.group import Projective, get_group
from icicle_tpu_torch.curves.params import Curve, get_curve
from icicle_tpu_torch.kernels import build
from icicle_tpu_torch.math.params import limbs_of
from icicle_tpu_torch.runtime.errors import IcicleError, IcicleException

KERNEL_LIMBS = 8

# kernel -> (library in build.LIBRARIES, its C entry point, number of tensor
# arguments, number of int dimensions before L)
KERNELS = {"prefix_scan": ("msm_scan", "icicle_msm_prefix_scan", 3, 3),
           "ec_reduce": ("ec_reduce", "icicle_msm_ec_reduce", 2, 3),
           "prefix_scan_r12": ("msm_scan_r12", "icicle_msm_prefix_scan_r12", 3, 3),
           "suffix_fold": ("msm_fold2", "icicle_msm_suffix_fold", 5, 4),
           "bucket_accum": ("bucket_accum", "icicle_msm_bucket_accum", 6, 4)}


# threads the split of B3's and B4's serial axis aims to run: about two
# waves of one resident 256-thread block on each of the H100's 132 SMs
TARGET_THREADS = 1 << 16
# B5's and B6's: one such wave (128 of the 132 SMs); on the card the scan
# and fold ran no faster at twice these threads and half as fast at half
ONE_WAVE_THREADS = 1 << 15


def as_curve(curve) -> Curve:
    return get_curve(curve) if isinstance(curve, str) else curve


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


def b3_small(curve: Curve) -> int | None:
    """b3 = 3b mod p, centred, if it is a small integer (|b3| <= 2^20), else
    None: the rule of the Pallas bodies (pallas/msm_kernel.py `_b3_small`)."""
    p = curve.fq.modulus
    b = curve.b3 if curve.b3 < p // 2 else curve.b3 - p
    return int(b) if abs(b) <= 1 << 20 else None


@functools.lru_cache(maxsize=None)
def _entry(kernel: str):
    library, entry, n_tensors, n_dims = KERNELS[kernel]
    lib = build.load(library)
    fn = getattr(lib, entry)
    fn.argtypes = ([ctypes.c_void_p] * n_tensors + [ctypes.c_int] * (n_dims + 1)
                   + [ctypes.c_void_p, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.icicle_msm_error_string.argtypes = [ctypes.c_int]
    lib.icicle_msm_error_string.restype = ctypes.c_char_p
    return fn, lib.icicle_msm_error_string


@functools.lru_cache(maxsize=None)
def _consts(curve_name: str):
    """{p[L], one[L], inv32, b3} as a host uint32 array (ec_field.cuh
    CurveConsts): one in Montgomery form, b3 as a small signed integer's
    two's-complement bits."""
    g = get_group(curve_name)
    fp = g.coord_field.params
    values = (limbs_of(fp.modulus, fp.nlimbs) + limbs_of(g.one_int, fp.nlimbs)
              + [fp.inv32, b3_small(g.curve) & 0xFFFFFFFF])
    return (ctypes.c_uint32 * len(values))(*values)


def not_built(kernel: str, curve: Curve, why: str) -> IcicleException:
    return IcicleException(IcicleError.API_NOT_IMPLEMENTED,
                           f"{kernel}: {why}; no CUDA kernel for {curve.name}")


def launch(kernel: str, curve: Curve, tensors, dims, consts=None) -> None:
    """Launch `kernel` over `tensors` (inputs, then the output) with its int
    dimensions `dims` on the current stream; `consts` defaults to the
    ec_field.cuh constants. Raises if the curve has no instantiation or the
    launch is refused."""
    nl = curve.fq.nlimbs
    if nl != KERNEL_LIMBS or b3_small(curve) is None:
        has = f"{nl} limbs" if nl != KERNEL_LIMBS else "a b3 that is not a small integer"
        raise not_built(kernel, curve, f"the CUDA kernel is built for {KERNEL_LIMBS}-limb "
                        f"fields with a small b3 (bn254, grumpkin), and {curve.name} has {has}")
    fn, error_string = _entry(kernel)
    consts = consts if consts is not None else _consts(curve.name)
    with torch.cuda.device(tensors[0].device):
        err = fn(*(t.data_ptr() for t in tensors), *dims, nl, ctypes.addressof(consts),
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise IcicleException(IcicleError.UNKNOWN_ERROR,
                              f"{kernel} launch failed: {error_string(err).decode()}")
