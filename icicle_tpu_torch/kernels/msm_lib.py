"""The MSM's CUDA libraries (`msm_scan` from kernels/csrc/msm_scan.cu,
`ec_reduce` from ec_reduce.cu, both over ec_field.cuh): loading with ctypes,
the curve constants their kernels take, and the checks both wrappers share.

The kernels are instantiated for L = 8 limbs (bn254, grumpkin) and multiply
by b3 = 3b as a small integer; other curves raise before a launch.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from icicle_tpu_torch.curves.group import get_group
from icicle_tpu_torch.curves.params import Curve, get_curve
from icicle_tpu_torch.kernels import build
from icicle_tpu_torch.math.params import limbs_of
from icicle_tpu_torch.runtime.errors import IcicleError, IcicleException

KERNEL_LIMBS = 8

# kernel -> (library in build.LIBRARIES, its C entry point)
KERNELS = {"prefix_scan": ("msm_scan", "icicle_msm_prefix_scan"),
           "ec_reduce": ("ec_reduce", "icicle_msm_ec_reduce")}


def as_curve(curve) -> Curve:
    return get_curve(curve) if isinstance(curve, str) else curve


def invalid(kernel: str, msg: str) -> IcicleException:
    return IcicleException(IcicleError.INVALID_ARGUMENT, f"{kernel}: {msg}")


def check_points(kernel: str, t: torch.Tensor, rows: int) -> None:
    """t must be a contiguous int32 (D, rows, C) tensor on the CPU or CUDA."""
    if t.device.type not in ("cpu", "cuda"):
        raise invalid(kernel, f"expected a CPU or CUDA tensor, got {t.device}")
    if t.dtype != torch.int32:
        raise invalid(kernel, f"expected int32 limbs, got {t.dtype}")
    if t.dim() != 3 or t.shape[1] != rows or t.shape[0] < 1 or t.shape[2] < 1:
        raise invalid(kernel, f"expected (D, {rows}, C), got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise invalid(kernel, "input must be contiguous")


def b3_small(curve: Curve) -> int | None:
    """b3 = 3b mod p, centred, if it is a small integer (|b3| <= 2^20), else
    None: the rule of the Pallas bodies (pallas/msm_kernel.py `_b3_small`)."""
    p = curve.fq.modulus
    b = curve.b3 if curve.b3 < p // 2 else curve.b3 - p
    return int(b) if abs(b) <= 1 << 20 else None


@functools.lru_cache(maxsize=None)
def _entry(kernel: str):
    library, entry = KERNELS[kernel]
    lib = build.load(library)
    fn = getattr(lib, entry)
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
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


def launch(kernel: str, curve: Curve, src: torch.Tensor, out: torch.Tensor) -> None:
    """Launch `kernel` over src (D, rows, C) into out on the current stream;
    raises if the curve has no instantiation or the launch is refused."""
    nl = curve.fq.nlimbs
    if nl != KERNEL_LIMBS or b3_small(curve) is None:
        has = f"{nl} limbs" if nl != KERNEL_LIMBS else "a b3 that is not a small integer"
        raise IcicleException(
            IcicleError.API_NOT_IMPLEMENTED,
            f"{kernel}: the CUDA kernel is built for {KERNEL_LIMBS}-limb fields with a "
            f"small b3 (bn254, grumpkin); {curve.name} has {has}")
    fn, error_string = _entry(kernel)
    consts = _consts(curve.name)
    depth, _, lanes = src.shape
    with torch.cuda.device(src.device):
        err = fn(src.data_ptr(), out.data_ptr(), depth, lanes, nl,
                 ctypes.addressof(consts), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise IcicleException(IcicleError.UNKNOWN_ERROR,
                              f"{kernel} launch failed: {error_string(err).decode()}")
