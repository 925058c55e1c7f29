"""Carrying the JAX package's state across to the port.

The JAX package (icicle_tpu) keeps field elements as uint32 arrays; the port
keeps them as int32 tensors holding the same bits: a single-limb element's
canonical value (< 2^31, never negative), a multi-limb element's (..., L)
little-endian uint32 limbs, where a limb >= 2^31 reads as negative in int32.
`.view(np.int32)` and back is exact both ways. These functions take and give
numpy arrays only: the port imports nothing of JAX, and a caller that holds
a jax.Array passes `np.asarray(array)`.
"""

from __future__ import annotations

import numpy as np
import torch

from icicle_tpu_torch.fields.field import Field
from icicle_tpu_torch.ops.msm_tpu3 import prepared_bases
from icicle_tpu_torch.ops.ntt import NttDomain
from icicle_tpu_torch.runtime.device import resolve
from icicle_tpu_torch.runtime.errors import IcicleError, IcicleException


def _below_modulus(f: Field, a: np.ndarray) -> bool:
    """Every element of a uint32 array (multi-limb: (..., L)) is < p, compared
    as integers: limb by limb from the top, the first limb that differs from
    p's decides."""
    if f.limb_shape == ():
        return not a.size or int(a.max()) < f.modulus
    less = np.zeros(a.shape[:-1], dtype=bool)
    equal = np.ones(a.shape[:-1], dtype=bool)
    for limb, p_limb in reversed(list(zip(np.moveaxis(a, -1, 0), f.params.p_limbs32()))):
        less |= equal & (limb < p_limb)
        equal &= limb == p_limb
    return bool(less.all())


def elements_from_numpy(f: Field, arr_u32, device=None) -> torch.Tensor:
    """uint32 element array (canonical, < p; multi-limb fields (..., L)
    limbs) -> int32 element tensor with the same bits."""
    a = np.asarray(arr_u32)
    if a.dtype != np.uint32:
        raise IcicleException(IcicleError.INVALID_ARGUMENT,
                              f"expected a uint32 element array, got {a.dtype}")
    if f.limb_shape and (a.ndim == 0 or a.shape[-1] != f.nlimbs):
        raise IcicleException(IcicleError.INVALID_ARGUMENT,
                              f"{f.name}: expected (..., {f.nlimbs}) limbs, got {a.shape}")
    if not _below_modulus(f, a):
        raise IcicleException(IcicleError.INVALID_ARGUMENT,
                              f"element >= {f.name} modulus: not canonical")
    return torch.from_numpy(a.astype(np.uint32).view(np.int32)).to(resolve(device))


def elements_to_numpy(f: Field, t: torch.Tensor) -> np.ndarray:
    """int32 element tensor -> uint32 element array with the same bits."""
    return t.cpu().numpy().view(np.uint32)


def prepared_from_numpy(curve_name: str, prepared: dict, device=None) -> dict:
    """The JAX package's `msm_tpu3_prepare` result -> the port's prepared
    bases on `device`, for `msm_tpu3(prepared=...)`.

    `prepared` holds the plan (c, T, tiles, wg, ...) and `pts_u8`, the
    (tiles, T, 8L) int8 Montgomery byte planes of x || y (little-endian
    bytes of each uint32 limb, icicle_tpu/ops/msm_tpu3.py:446-457); pass
    `np.asarray(prepared["pts_u8"])` or the jax.Array itself. Only bases
    prepared with engine "u32" (R = 2^(32 L)) carry over."""
    if prepared["engine"] != "u32":
        raise NotImplementedError(
            f'prepared_from_numpy: engine {prepared["engine"]!r} bases need kernel '
            "B5's radix-12 domain, which is not ported yet (ROADMAP.md, next slice)")
    if prepared["nu"] != 1 or prepared.get("glv", False):
        raise NotImplementedError(
            "prepared_from_numpy: precomputed or GLV bases are not ported yet "
            "(ROADMAP.md queue A item 8)")
    planes = np.ascontiguousarray(np.asarray(prepared["pts_u8"])).view(np.uint8)
    tiles, T, nbytes = planes.shape
    limbs = planes.reshape(tiles * T, nbytes).view("<u4").astype(np.uint32)
    plan = {k: prepared[k] for k in ("engine", "nbits", "c", "M", "T", "tiles",
                                     "n_windows", "wg", "n_pad", "nu")}
    xy = torch.from_numpy(limbs.view(np.int32)).to(resolve(device))
    return prepared_bases(curve_name, plan, xy, prepared["n"])


def domain_from_numpy(f: Field, logn: int, twiddles_u32, twiddles_inv_u32,
                      device=None) -> NttDomain:
    """The JAX package's NttDomain tables (w^0..w^(n/2-1) in Montgomery form,
    forward and inverse) -> the port's NttDomain on `device`."""
    w = f.omega(logn)
    return NttDomain(f, logn, w, pow(w, -1, f.modulus),
                     elements_from_numpy(f, twiddles_u32, device),
                     elements_from_numpy(f, twiddles_inv_u32, device))
