"""Multi-scalar multiplication: configuration, signed digits, precomputed
bases, the generic `msm()` and the dispatched entry point (counterpart of
icicle_tpu/ops/msm.py).

Reference surface: include/icicle/msm.h (msm, msm_precompute_bases,
MSMConfig). `msm_affine` dispatches on the scalars' device: "cuda" runs
the hand-written kernels, "torch" their plain versions, "auto" picks
"cuda" for a CUDA tensor. Routing follows the JAX package's
`_msm_affine_pallas` (ops/msm.py:452-469): a single G1 MSM over canonical
inputs, with precompute_factor 1 or a power of two with an explicit c,
takes the v3 prefix-scan pipeline (ops/msm_tpu3.py; under
ICICLE_TPU_MSM_PIPELINE=v2 and factor 1 the v2 suffix-fold pipeline,
ops/msm_tpu2.py); G2 (`MSMConfig(g2=True)`), batches, Montgomery-form
inputs and other factors take the generic `msm()`. The v1 pipeline
(ops/msm_tpu.py `msm_tpu`) is called directly, as there.

G2 points have coordinates over Fp2 (fields/extension.py: (N, 2L) words,
c0's limbs then c1's) for bn254, bls12_377 and bls12_381, and over Fq for
bw6_761; they run through the same stages over the group's engine, and B3,
B4 and `precompute_bases` have Fp2 instances (kernels/msm_lib.py). A G2
`msm_affine` returns ((x0, x1), (y0, y1)); the JAX package's returns the
c0 parts alone (int(...[0]) of each coordinate), a difference by design.

The generic `msm()` runs v3's stages (ops/msm_tpu3.py `msm_stages`: B3
and B4 on a CUDA tensor) per batch element over one prepared table
(shared points) or one per element (unshared), and lifts the affine sum
back to Montgomery projective (x, y, 1). Where the JAX package's
Pippenger `msm()` computes its projective coordinates by another order
of adds, the affine point is the same. Three behaviours of the JAX
package are not copied (ROADMAP.md §C): unshared points take element i's
own rows iN..(i+1)N, a batched `msm_affine` returns every element's
point, and `bitsize` holds on every route.

`_auto_c`, `_segmented_scan_add` and `_prefix_scan_add` serve the v1
pipeline and the generic `msm()`'s window size (`default_c`); `_auto_c`
is the JAX function's closed form only (its tuning table, measured on the
TPU, is not carried over). The pipelines share the rest of this module: the
signed digits, the +-P point table (`point_table`, `signed_table`),
`resolve_backend`, the B4 fold `fold_rows` and `horner`.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from icicle_tpu_torch.curves.group import Group, Projective, get_group, pselect
from icicle_tpu_torch.curves.host_ec import INF, fp2_inv, fp2_mul, host_ops
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


G2_MAX_C = 11


def default_c(n: int, g2: bool = False) -> int:
    """The generic msm()'s window bits where cfg.c is 0, for n scalars:
    `_auto_c(n)`, and at most G2_MAX_C for G2. The closed form counts a
    window's bucket work as 4 2^(c-1) adds; the generic plan folds tiles x
    2^(c-1) buckets a window across tiles, each of G2's rows twice as wide
    as G1's, so above c 11 that fold costs more than the windows saved (a
    bn254 G2 MSM of 2^22 points on an H100 at c 16, the closed form's
    choice, takes 1.6 times as long as at c 11: PERF.md)."""
    c = _auto_c(n)
    return min(c, G2_MAX_C) if g2 else c


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
    """The point table the MSM pipelines gather from: xy_mont (n_pad, 2W)
    int32 Montgomery words (x || y, W words a coordinate of the field fq)
    -> (2 n_pad, 2W), rows n_pad.. holding (x, -y), so a negative digit
    costs nothing per MSM (over Fp2 both parts of y negate; 0 stays 0)."""
    nl = fq.nlimbs
    neg = xy_mont.clone()
    for s in range(0, neg.shape[0], _PREP_ROWS):
        neg[s:s + _PREP_ROWS, nl:] = fq.neg(neg[s:s + _PREP_ROWS, nl:])
    return torch.cat([xy_mont, neg])


def point_table(curve_name: str, px: torch.Tensor, py: torch.Tensor, n_pad: int,
                engine: str = "u32", g2: bool = False) -> torch.Tensor:
    """Canonical affine (n, W) coordinates -> `signed_table` of the points
    in the engine's Montgomery domain, zero rows padding them to n_pad; G2's
    Fp2 coordinates part by part."""
    group = get_group(curve_name, g2)
    nl = group.nlimbs
    n = px.shape[0]
    xy = torch.zeros((n_pad, 2, nl), dtype=torch.int32, device=px.device)
    xy[:n, 0] = px
    xy[:n, 1] = py
    xy[:n] = _mul_const_chunked(group.curve.fq, xy[:n], _mont_factor(curve_name, engine))
    return signed_table(group.coord_field, xy.view(-1, 2 * nl))


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


def horner(group, wsums: torch.Tensor, c: int):
    """(W, 3, W_words) Montgomery projective window sums of `group`'s points
    -> canonical affine sum_w 2^(c w) W_w as Python ints: (x, y) over Fp,
    ((x0, x1), (y0, y1)) over Fp2; the identity (0, 0) or ((0, 0), (0, 0))."""
    p = group.curve.fq.modulus
    rinv = pow(1 << (32 * group.base_limbs), -1, p)
    add, dbl, _, ident = host_ops(group)
    ints = group.coord_field.to_ints(wsums)                     # (W, 3[, 2])
    pts = []
    for x, y, z in ints:
        if group.degree == 1:
            z = z * rinv % p
            if z == 0:
                pts.append(INF)
                continue
            zi = pow(z, -1, p)
            pts.append((x * rinv % p * zi % p, y * rinv % p * zi % p))
            continue
        x, y, z = (tuple(int(v) * rinv % p for v in t) for t in (x, y, z))
        if z == (0, 0):
            pts.append(INF)
            continue
        nr = group.coord_field.engine.w
        zi = fp2_inv(z, p, nr)
        pts.append((fp2_mul(x, zi, p, nr), fp2_mul(y, zi, p, nr)))
    acc = pts[-1]
    for w in range(len(pts) - 2, -1, -1):
        for _ in range(c):
            acc = dbl(acc)
        acc = add(acc, pts[w])
    return acc if acc is not INF else ident


def _precompute_digit_remap(digits: torch.Tensor, nu: int, n: int, G0: int):
    """(W, ..., N) digits -> (G, ..., nu N) merged-window digits for
    precomputed bases with stride G0 = shift / c (cpu_msm.hpp:469): window
    w = j G0 + m of point i becomes merged window m of copy nu i + j.
    Windows beyond nu G0 (the signed-digit carry window) ride the LAST copy
    at m >= G0, so G = W - (nu - 1) G0 (at least G0). One gather: merged
    window m of copy j reads window j G0 + m, or a zero row where the JAX
    function pads its blocks."""
    W = digits.shape[0]
    G = max(G0, W - (nu - 1) * G0)
    src = [[j * G0 + m if (m < G0 or j == nu - 1) and j * G0 + m < W else W
            for j in range(nu)] for m in range(G)]
    padded = torch.cat([digits, digits.new_zeros((1,) + digits.shape[1:])])
    dp = padded[torch.tensor(src, device=digits.device)]       # (G, nu, ..., N)
    return dp.movedim(1, -1).reshape(G, *digits.shape[1:-1], nu * n), G


def msm_precompute_bases(curve_name: str, points_x, points_y, cfg: MSMConfig | None = None):
    """Reference msm_precompute_bases (msm.h:107; cpu_msm.hpp:455-481):
    (N, W) canonical affine coordinates -> interleaved (nu N, W) canonical
    affine coordinates with row nu i + j = 2^(j shift) P_i,
    shift = precompute_shift(bitsize, c, nu); G2 points with cfg.g2 (W =
    2L over Fp2, as JAX builds its copies over `group.coord_field`). On a
    CUDA tensor the `precompute_bases` kernel computes the copies, on the
    CPU its plain version (cfg.backend may say "torch" or "cuda").

    The window size must match the later msm() call: pass an explicit cfg.c
    (0 takes `default_c(N, cfg.g2)`, msm()'s own default; the JAX
    package's may differ). Torch tensors are used where they lie; numpy uint32 arrays go
    to the default device. nu = 1 returns the points as they are."""
    from icicle_tpu_torch.kernels.precompute_kernel import (precompute_bases,
                                                            precompute_bases_ref)
    cfg = cfg or MSMConfig()
    px = _limb_tensor(points_x, None).contiguous()
    py = _limb_tensor(points_y, px.device).contiguous()
    nu = cfg.precompute_factor
    if nu == 1:
        return px, py
    curve = get_curve(curve_name)
    nbits = cfg.bitsize or curve.fr.modulus.bit_length()
    shift = precompute_shift(nbits, cfg.c or default_c(px.shape[0], cfg.g2), nu)
    fn = precompute_bases if resolve_backend(cfg.backend, px, "msm_precompute_bases") \
        else precompute_bases_ref
    return fn(get_group(curve_name, cfg.g2), px, py, nu, shift)


GENERIC_TILES = 128


def generic_tile(rows: int) -> int:
    """The generic msm()'s tile T over `rows` bases: rows / GENERIC_TILES
    rounded up to a power of two, 16 to 8192. The MSMs it serves are small
    (batch elements, 2^10-2^16 points), where v3's plan (T >= 256, up to
    8192) leaves a few lanes to scan thousands of serial slots; 128 tiles
    give B3 more lanes and shorter chains."""
    return min(8192, 1 << max(4, (-(-rows // GENERIC_TILES) - 1).bit_length()))


def generic_plan(curve_name: str, rows: int, c: int, nu: int = 1, nbits: int = 0,
                 g2: bool = False) -> dict:
    """The generic msm()'s plan over `rows` bases (nu N rows of copies for
    nu > 1): v3's at tile generic_tile(rows), its wg picked on the windows
    left after the copies merge them, where v3 (and the JAX package) pick
    it before, so no group scans windows of zero digits (at 2^10 x 23, c 8:
    2 windows, not 8). nbits: the scalars' bits, 0 for the scalar field's.
    g2: G2's bases, whose rows are wider (pick_wg's row_words)."""
    from icicle_tpu_torch.ops.msm_tpu3 import _resolve_plan, pick_wg
    T = generic_tile(rows)
    plan = _resolve_plan(curve_name, rows, c, T, None, "u32", nu, False, nbits, g2)
    return dict(plan, wg=pick_wg(plan["n_windows"], plan["tiles"], T,
                                 get_group(curve_name, g2).nlimbs))


def _generic_points(curve_name: str, scalars, points_x, points_y, cfg: MSMConfig):
    """The generic MSM's canonical affine results as Python ints, one a
    batch element, and whether the call was a batch.

    scalars (N, Ls), (B, N, Ls), or (B N, Ls) with cfg.batch_size = B > 1;
    points (nu N, L) shared by the batch, or (B nu N, L) with
    are_points_shared_in_batch=False, element i taking rows
    [i nu N, (i + 1) nu N) (reference msm.h); nu N rows are the output of
    msm_precompute_bases where nu = cfg.precompute_factor > 1."""
    from icicle_tpu_torch.ops.msm_tpu3 import msm_stages, msm_tpu3_prepare, plan_digits
    fr = get_curve(curve_name).fr
    fq = get_group(curve_name, cfg.g2).coord_field
    scalars = _limb_tensor(scalars, None)
    px = _limb_tensor(points_x, scalars.device)
    py = _limb_tensor(points_y, scalars.device)
    batched = scalars.dim() == 3 or cfg.batch_size > 1
    if scalars.dim() == 2:
        B = cfg.batch_size if cfg.batch_size > 1 else 1
        if scalars.shape[0] % B:
            raise IcicleException(IcicleError.INVALID_ARGUMENT,
                                  f"msm: {scalars.shape[0]} scalars for batch_size {B}")
        scalars = scalars.view(B, -1, scalars.shape[-1])
    if scalars.dim() != 3 or scalars.dtype != torch.int32:
        raise IcicleException(IcicleError.INVALID_ARGUMENT,
                              f"msm: scalars must be (N, Ls) or (B, N, Ls) int32, got "
                              f"{tuple(scalars.shape)} {scalars.dtype}")
    B, N = scalars.shape[:2]
    nu = cfg.precompute_factor
    rows = nu * N
    shared = cfg.are_points_shared_in_batch or B == 1
    if px.shape != (rows if shared else B * rows, fq.nlimbs) or py.shape != px.shape:
        raise IcicleException(IcicleError.INVALID_ARGUMENT,
                              f"msm: {B} x {N} scalars at precompute_factor {nu} need "
                              f"({rows if shared else B * rows}, {fq.nlimbs}) coordinates, "
                              f"got {tuple(px.shape)} and {tuple(py.shape)}")
    if cfg.are_scalars_montgomery_form:
        scalars = fr.from_mont(scalars)
    if cfg.are_points_montgomery_form:
        px, py = fq.from_mont(px), fq.from_mont(py)
    nbits = cfg.bitsize or fr.modulus.bit_length()
    plan = generic_plan(curve_name, rows, cfg.c or default_c(N, cfg.g2), nu, nbits, cfg.g2)

    def prepare(x, y):
        return msm_tpu3_prepare(curve_name, x.contiguous(), y.contiguous(), c=plan["c"],
                                T=plan["T"], engine="u32", precompute_factor=nu,
                                wg=plan["wg"], bitsize=nbits, g2=cfg.g2)

    table = prepare(px, py) if shared else None
    # every element's digits at once: (W, B, N), or (G, B, nu N) merged
    digits = plan_digits(curve_name, scalars, plan)
    out = []
    for i in range(B):
        prepared = table or prepare(px[i * rows:(i + 1) * rows], py[i * rows:(i + 1) * rows])
        out.append(msm_stages(curve_name, digits[:, i], prepared, cfg.backend))
    return out, batched


def msm(curve_name: str, scalars, points_x, points_y, cfg: MSMConfig | None = None) -> Projective:
    """MSM over canonical-form inputs (or Montgomery-form ones, as cfg
    says). Returns a Montgomery-form projective point on the scalars'
    device, (x R, y R, R) or the identity (0, R, 0), its coordinates of the
    group's field (G2 with cfg.g2: (2L,) words over Fp2); (B, W)
    coordinates for a batch (use Group.to_affine_canonical to read out).

    scalars: (N, Ls) limbs, (B, N, Ls), or (B N, Ls) with cfg.batch_size =
    B; points (N, W) each, (B N, W) with are_points_shared_in_batch=False
    (element i takes rows iN..(i+1)N). With cfg.precompute_factor = nu > 1
    the points are the interleaved (nu N, W) output of msm_precompute_bases
    with the same cfg.c (per element when unshared). Torch tensors are used
    where they lie; numpy uint32 arrays go to the default device. Backend:
    cfg.backend, else the scalars' device."""
    cfg = cfg or MSMConfig()
    pts, batched = _generic_points(curve_name, scalars, points_x, points_y, cfg)
    group = get_group(curve_name, cfg.g2)
    to_mont = group.curve.fq.params.to_mont_int
    _, _, _, ident = host_ops(group)
    zero = (0, 0) if group.degree == 2 else 0

    def mont(v):
        return tuple(to_mont(c) for c in v) if group.degree == 2 else to_mont(v)

    coords = [(zero, group.one_int, zero) if p == ident else (mont(p[0]), mont(p[1]), group.one_int)
              for p in pts]
    dev = _limb_tensor(scalars, None).device
    xyz = group.coord_field.from_ints(coords, dev)              # (B, 3, W)
    if not batched:
        xyz = xyz[0]
    return Projective(*xyz.unbind(-2))


def _msm_affine_pipeline(backend: str):
    def run(curve_name, scalars, points_x, points_y, cfg):
        cfg = dataclasses.replace(cfg, backend=backend)
        nu = cfg.precompute_factor
        v3_pre = nu > 1 and cfg.c and nu & (nu - 1) == 0
        if (cfg.g2 or scalars.dim() == 3 or cfg.batch_size > 1 or (nu > 1 and not v3_pre)
                or cfg.are_scalars_montgomery_form or cfg.are_points_montgomery_form):
            pts, batched = _generic_points(curve_name, scalars, points_x, points_y, cfg)
            return pts if batched else pts[0]
        if os.environ.get("ICICLE_TPU_MSM_PIPELINE", "v3") == "v2" and nu == 1:
            from icicle_tpu_torch.ops.msm_tpu2 import msm_tpu2
            return msm_tpu2(curve_name, scalars, points_x, points_y,
                            c=cfg.c or None, backend=backend, bitsize=cfg.bitsize)
        from icicle_tpu_torch.ops.msm_tpu3 import msm_tpu3
        return msm_tpu3(curve_name, scalars, points_x, points_y, c=cfg.c or None,
                        backend=backend, precompute_factor=nu, bitsize=cfg.bitsize)
    return run


_dispatcher.register_impl("msm", _dispatcher.TORCH, _msm_affine_pipeline("torch"))
_dispatcher.register_impl("msm", _dispatcher.CUDA, _msm_affine_pipeline("cuda"))


def msm_affine(curve_name: str, scalars, points_x, points_y,
               cfg: MSMConfig | None = None):
    """Dispatched MSM returning the canonical affine result as python ints
    ((0, 0) = identity; G2 over Fp2: ((x0, x1), (y0, y1)), ((0, 0), (0, 0)));
    for a batch, the list of every element's result.

    scalars: (N, Ls) canonical limbs, (B, N, Ls), or (B N, Ls) with
    cfg.batch_size = B; points_x, points_y: (N, L) canonical affine
    coordinates (see `msm` for unshared batches, precomputed bases and
    Montgomery-form inputs). Torch tensors (int32 holding the uint32 limb
    bits) are used where they lie; numpy uint32 arrays go to the default
    device, CUDA unless `set_device("cpu")` was called. Backend:
    cfg.backend, else "auto" (the scalars' device)."""
    cfg = cfg or MSMConfig()
    scalars = _limb_tensor(scalars, None)
    points_x = _limb_tensor(points_x, scalars.device)
    points_y = _limb_tensor(points_y, scalars.device)
    return _dispatcher.dispatch("msm", cfg.backend, scalars)(
        curve_name, scalars, points_x, points_y, cfg)
