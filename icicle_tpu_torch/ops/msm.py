"""Multi-scalar multiplication: configuration, signed digits and the
dispatched entry point (counterpart of icicle_tpu/ops/msm.py, partial).

Reference surface: include/icicle/msm.h (msm, MSMConfig). `msm_affine`
dispatches on the scalars' device: "cuda" runs the v3 prefix-scan pipeline
(ops/msm_tpu3.py) with the hand-written kernels, "torch" the same pipeline
with their plain versions (the counterpart of the JAX package's
`msm_tpu3(backend="xla")`), "auto" picks "cuda" for a CUDA tensor.

Only the single G1 MSM over canonical inputs is ported. G2, a batch axis
(or unshared points), Montgomery-form inputs, `precompute_factor > 1` and a
`bitsize` other than the scalar field's width take the JAX package's
generic Pippenger `msm()`, which waits for ROADMAP.md queue A item 8; here
they raise NotImplementedError and never take another route.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from icicle_tpu_torch.curves.params import get_curve
from icicle_tpu_torch.math.bigint import widen
from icicle_tpu_torch.runtime import dispatcher as _dispatcher
from icicle_tpu_torch.runtime.device import resolve
from icicle_tpu_torch.runtime.errors import IcicleError, IcicleException


@dataclasses.dataclass
class MSMConfig:
    """Mirror of the reference MSMConfig (msm.h:19-97)."""
    c: int = 0                     # window bits; 0 = auto
    bitsize: int = 0               # scalar bits; 0 = field default
    backend: str | None = None     # None/"auto" | "torch" | "cuda"
    precompute_factor: int = 1
    batch_size: int = 1
    are_points_shared_in_batch: bool = True
    are_scalars_montgomery_form: bool = False
    are_points_montgomery_form: bool = False
    g2: bool = False               # operate on the G2 group


def signed_window_count(nbits: int, c: int) -> int:
    """Exact signed-digit window count for scalars < 2^nbits: W = nbits//c+1.

    The conversion keeps v <= 2^(c-1) and emits v - 2^c with carry 1
    otherwise, so window w holds at most (raw bits of k) + 1. With
    W = floor(nbits/c) + 1 the top window covers bits c*(W-1)..nbits-1,
    i.e. raw < 2^(nbits mod c) <= 2^(c-1) even after +1 carry whenever
    nbits mod c != 0; when c | nbits the +1 IS the carry window."""
    return nbits // c + 1


def _window_digits(limb, n_limbs: int, c: int, nbits: int) -> torch.Tensor:
    """Signed digits from `limb(i)` -> int64 limb values (..., ) in [0, 2^32)."""
    n_windows = signed_window_count(nbits, c)
    half, full = 1 << (c - 1), 1 << c
    digits = []
    carry = None
    for w in range(n_windows):
        li, off = (w * c) >> 5, (w * c) & 31
        if li >= n_limbs:
            raw = torch.zeros_like(limb(0))
        else:
            raw = limb(li) >> off
            if off + c > 32 and li + 1 < n_limbs:
                raw = raw | (limb(li + 1) << (32 - off))
        v = raw & (full - 1)
        if carry is not None:
            v = v + carry
        is_high = v > half
        digits.append(torch.where(is_high, v - full, v))
        carry = is_high.to(v.dtype)
    return torch.stack(digits, dim=0).to(torch.int32)


def _signed_digits(scalar_limbs: torch.Tensor, c: int, nbits: int) -> torch.Tensor:
    """(N, Ls) int32 canonical scalar limbs -> (W, N) int32 signed digits.

    Digits lie in [-2^(c-1), 2^(c-1)]; sum_w d_w * 2^(c*w) == scalar."""
    s = widen(scalar_limbs)
    return _window_digits(lambda i: s[..., i], s.shape[-1], c, nbits)


def _signed_digits_t(scalars_t: torch.Tensor, c: int, nbits: int) -> torch.Tensor:
    """(Ls, N) int32 limb-major scalars -> (W, N) int32 signed digits (the
    JAX package keeps this one in ops/msm_tpu2.py:79)."""
    s = widen(scalars_t)
    return _window_digits(lambda i: s[i], s.shape[0], c, nbits)


def precompute_shift(nbits: int, c: int, precompute_factor: int) -> int:
    """Doubling count between precomputed copies (cpu_msm.hpp:468-469):
    shift = c * ceil(ceil(bitsize/c) / precompute_factor)."""
    num_bms = (nbits - 1) // c + 1
    return c * ((num_bms - 1) // precompute_factor + 1)


def _limb_tensor(a, device) -> torch.Tensor:
    """A torch tensor as it is; a uint32 limb array -> int32 tensor on
    `device` (None: the default device, which raises without CUDA)."""
    if isinstance(a, torch.Tensor):
        return a
    arr = np.asarray(a)
    if arr.dtype != np.uint32:
        raise IcicleException(IcicleError.INVALID_ARGUMENT,
                              f"expected uint32 limb arrays, got {arr.dtype}")
    return torch.from_numpy(arr.astype(np.uint32).view(np.int32)).to(resolve(device))


def _unported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"msm: {what} takes the generic Pippenger msm(), which is not ported "
        "yet (ROADMAP.md queue A item 8)")


def _check_v3(curve_name: str, scalars: torch.Tensor, cfg: MSMConfig) -> None:
    if cfg.g2:
        raise _unported("G2")
    if scalars.dim() == 3 or cfg.batch_size != 1 or not cfg.are_points_shared_in_batch:
        raise _unported("a batch axis")
    nbits = get_curve(curve_name).fr.modulus.bit_length()
    if cfg.bitsize not in (0, nbits):
        raise _unported(f"bitsize {cfg.bitsize} (the scalar field has {nbits} bits)")
    if cfg.are_scalars_montgomery_form or cfg.are_points_montgomery_form:
        raise _unported("Montgomery-form inputs")
    if cfg.precompute_factor > 1:
        raise _unported("precompute_factor > 1")


def _msm_affine_v3(backend: str):
    def run(curve_name, scalars, points_x, points_y, cfg):
        from icicle_tpu_torch.ops.msm_tpu3 import msm_tpu3
        _check_v3(curve_name, scalars, cfg)
        return msm_tpu3(curve_name, scalars, points_x, points_y,
                        c=cfg.c or None, backend=backend)
    return run


_dispatcher.register_impl("msm", _dispatcher.TORCH, _msm_affine_v3("torch"))
_dispatcher.register_impl("msm", _dispatcher.CUDA, _msm_affine_v3("cuda"))


def msm_affine(curve_name: str, scalars, points_x, points_y,
               cfg: MSMConfig | None = None):
    """Dispatched MSM returning the canonical affine result as python ints
    ((0, 0) = identity).

    scalars: (N, Ls) canonical limbs; points_x, points_y: (N, L) canonical
    affine coordinates. Torch tensors (int32 holding the uint32 limb bits)
    are used where they lie; numpy uint32 arrays go to the default device,
    CUDA unless `set_device("cpu")` was called. Backend: cfg.backend, else
    "auto" (the scalars' device)."""
    cfg = cfg or MSMConfig()
    scalars = _limb_tensor(scalars, None)
    points_x = _limb_tensor(points_x, scalars.device)
    points_y = _limb_tensor(points_y, scalars.device)
    return _dispatcher.dispatch("msm", cfg.backend, scalars)(
        curve_name, scalars, points_x, points_y, cfg)
