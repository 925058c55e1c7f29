"""Multi-scalar multiplication: configuration, signed digits and the
dispatched entry point (counterpart of icicle_tpu/ops/msm.py, partial).

Reference surface: include/icicle/msm.h (msm, MSMConfig). `msm_affine`
dispatches on the scalars' device: "cuda" runs the v3 prefix-scan pipeline
(ops/msm_tpu3.py) with the hand-written kernels, "torch" the same pipeline
with their plain versions (the counterpart of the JAX package's
`msm_tpu3(backend="xla")`), "auto" picks "cuda" for a CUDA tensor. Under
ICICLE_TPU_MSM_PIPELINE=v2 it runs the v2 suffix-fold pipeline
(ops/msm_tpu2.py) instead, as the JAX package does (ops/msm.py:462-466).
The v1 pipeline (ops/msm_tpu.py `msm_tpu`) is called directly, as there.

`_auto_c`, `_segmented_scan_add` and `_prefix_scan_add` serve the v1
pipeline; `_auto_c` is the JAX function's closed form only (its tuning
table, measured on the TPU, is not carried over). The three pipelines
share the rest of this module: the signed digits, the +-P point table
(`point_table`, `signed_table`), `resolve_backend`, the B4 fold
`fold_rows` and `horner`.

Only the single G1 MSM over canonical inputs is ported. G2, a batch axis
(or unshared points), Montgomery-form inputs, `precompute_factor > 1` and a
`bitsize` other than the scalar field's width take the JAX package's
generic Pippenger `msm()`, which waits for ROADMAP.md queue A item 6; here
they raise NotImplementedError and never take another route.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from icicle_tpu_torch.curves.group import Group, Projective, pselect
from icicle_tpu_torch.curves.host_ec import INF, ec_add, ec_dbl
from icicle_tpu_torch.curves.params import get_curve
from icicle_tpu_torch.kernels.msm_scan_r12 import r12_engine
from icicle_tpu_torch.math.bigint import widen
from icicle_tpu_torch.runtime import dispatcher as _dispatcher
from icicle_tpu_torch.runtime.device import resolve
from icicle_tpu_torch.runtime.errors import IcicleError, IcicleException

# rows per chunk of the point-table conversion: the multiply's
# (rows, 2, 16, 32) int64 column buffer stays near 1 GiB
_PREP_ROWS = 1 << 17


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


def _auto_c(n: int) -> int:
    """Window bits minimising W (n + 4 2^(c-1)) over c in 2..16."""
    best_c, best_cost = 1, float("inf")
    for c in range(2, 17):
        w = (255 + c) // c + 1
        cost = w * (n + 4 * (1 << (c - 1)))
        if cost < best_cost:
            best_c, best_cost = c, cost
    return best_c


def _row_index(n: int, like: torch.Tensor) -> torch.Tensor:
    """arange(n) shaped to broadcast against `like` (n, ...) along dim 0."""
    return torch.arange(n, device=like.device).view((n,) + (1,) * (like.dim() - 1))


def _rolled(p: Projective, d: int) -> Projective:
    return Projective(*(torch.roll(a, d, 0) for a in p))


def _segmented_scan_add(group: Group, points: Projective, flags: torch.Tensor) -> Projective:
    """Inclusive segmented prefix sum of points under EC add along dim 0;
    flags[i] marks the first element of a segment. Hillis-Steele over
    log2(n) roll steps (n log n adds, all batched); further dims batch."""
    n = points.x.shape[0]
    idx = _row_index(n, flags)
    f, p = flags, points
    for k in range(max(1, (n - 1).bit_length())):
        d = 1 << k
        combined = group.add(_rolled(p, d), p)
        # keep its own value where the lane starts a segment or the source
        # lane is out of range (i < d)
        p = pselect(f | (idx < d), p, combined)
        f = f | (torch.roll(f, d, 0) & (idx >= d))
    return p


def _prefix_scan_add(group: Group, pts: Projective) -> Projective:
    """Inclusive prefix sum of points along dim 0 (the same roll steps, no
    flags); further dims batch."""
    n = pts.x.shape[0]
    idx = _row_index(n, pts.x[..., 0])
    for k in range(max(1, (n - 1).bit_length())):
        d = 1 << k
        pts = pselect(idx < d, pts, group.add(_rolled(pts, d), pts))
    return pts


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


def _mont_factor(curve_name: str, engine: str) -> int:
    """The constant whose Montgomery multiply takes a canonical coordinate
    into the engine's domain: R^2 (R = 2^(32 L)) for "u32", R 2^(12 nw) for
    "r12" (msm_tpu3.py `_prep_fn3`'s r2 * shift / R)."""
    fq = get_curve(curve_name).fq
    r = fq.params.r
    lift = r if engine == "u32" else r12_engine(curve_name).R
    return r * lift % fq.modulus


def _mul_const_chunked(fq, a: torch.Tensor, value: int) -> torch.Tensor:
    """fq.mul_mont(a, value) over (..., L) limbs, in chunks of 2^18
    elements (the multiply's int64 column buffers stay near 1 GiB)."""
    flat = a.reshape(-1, fq.nlimbs)
    cst = fq.engine.const(value, device=a.device)
    out = torch.empty_like(flat)
    for s in range(0, flat.shape[0], 2 * _PREP_ROWS):
        out[s:s + 2 * _PREP_ROWS] = fq.mul_mont(flat[s:s + 2 * _PREP_ROWS], cst)
    return out.view(a.shape)


def signed_table(fq, xy_mont: torch.Tensor) -> torch.Tensor:
    """The point table the MSM pipelines gather from: xy_mont (n_pad, 2L)
    int32 Montgomery limbs (x || y) -> (2 n_pad, 2L), rows n_pad.. holding
    (x, -y), so a negative digit costs nothing per MSM."""
    nl = fq.nlimbs
    neg = xy_mont.clone()
    for s in range(0, neg.shape[0], _PREP_ROWS):
        neg[s:s + _PREP_ROWS, nl:] = fq.neg(neg[s:s + _PREP_ROWS, nl:])
    return torch.cat([xy_mont, neg])


def point_table(curve_name: str, px: torch.Tensor, py: torch.Tensor, n_pad: int,
                engine: str = "u32") -> torch.Tensor:
    """Canonical affine (n, L) coordinates -> `signed_table` of the points
    in the engine's Montgomery domain, zero rows padding them to n_pad."""
    fq = get_curve(curve_name).fq
    nl = fq.nlimbs
    n = px.shape[0]
    xy = torch.zeros((n_pad, 2, nl), dtype=torch.int32, device=px.device)
    xy[:n, 0] = px
    xy[:n, 1] = py
    xy[:n] = _mul_const_chunked(fq, xy[:n], _mont_factor(curve_name, engine))
    return signed_table(fq, xy.view(-1, 2 * nl))


def resolve_backend(backend: str | None, scalars: torch.Tensor, who: str) -> bool:
    """True for the kernels ("cuda"), False for their plain versions
    ("torch"); None / "auto" follows the scalars' device."""
    if backend in (None, "auto"):
        return scalars.is_cuda
    if backend == "cuda":
        if not scalars.is_cuda:
            raise IcicleException(IcicleError.INVALID_ARGUMENT,
                                  f'{who}: backend "cuda" needs CUDA tensors')
        return True
    if backend == "torch":
        return False
    raise IcicleException(IcicleError.INVALID_ARGUMENT, f"{who}: unknown backend {backend!r}")


def fold_rows(reduce, curve, pts: torch.Tensor) -> torch.Tensor:
    """The per-lane sum of (R, 3L, lanes) projective points by B4: one pass
    where R <= 128, else two, R / 128 rows over lanes * 128, then 128 rows
    (R must then be a multiple of 128)."""
    R, rows, lanes = pts.shape
    r2 = min(R, 128)
    r1 = R // r2
    if r1 > 1:
        b2 = pts.view(r1, r2, rows, lanes).permute(0, 2, 3, 1).reshape(r1, rows, lanes * r2)
        pts = reduce(curve, b2.contiguous()).view(rows, lanes, r2).permute(2, 0, 1)
    return reduce(curve, pts.contiguous())


def horner(fq, wsums: torch.Tensor, c: int):
    """(W, 3, L) Montgomery projective window sums -> canonical affine
    sum_w 2^(c w) W_w as Python ints, (0, 0) for the identity."""
    p = fq.modulus
    rinv = pow(1 << (32 * fq.nlimbs), -1, p)
    ints = fq.to_ints(wsums)                                    # (W, 3)
    pts = []
    for x, y, z in ints:
        z = z * rinv % p
        if z == 0:
            pts.append(INF)
            continue
        zi = pow(z, -1, p)
        pts.append((x * rinv % p * zi % p, y * rinv % p * zi % p))
    acc = pts[-1]
    for w in range(len(pts) - 2, -1, -1):
        for _ in range(c):
            acc = ec_dbl(acc, p)
        acc = ec_add(acc, pts[w], p)
    return acc if acc is not INF else (0, 0)


def _unported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"msm: {what} takes the generic Pippenger msm(), which is not ported "
        "yet (ROADMAP.md queue A item 6)")


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


def _msm_affine_pipeline(backend: str):
    def run(curve_name, scalars, points_x, points_y, cfg):
        _check_v3(curve_name, scalars, cfg)
        if os.environ.get("ICICLE_TPU_MSM_PIPELINE", "v3") == "v2":
            from icicle_tpu_torch.ops.msm_tpu2 import msm_tpu2
            return msm_tpu2(curve_name, scalars, points_x, points_y,
                            c=cfg.c or None, backend=backend)
        from icicle_tpu_torch.ops.msm_tpu3 import msm_tpu3
        return msm_tpu3(curve_name, scalars, points_x, points_y,
                        c=cfg.c or None, backend=backend)
    return run


_dispatcher.register_impl("msm", _dispatcher.TORCH, _msm_affine_pipeline("torch"))
_dispatcher.register_impl("msm", _dispatcher.CUDA, _msm_affine_pipeline("cuda"))


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
