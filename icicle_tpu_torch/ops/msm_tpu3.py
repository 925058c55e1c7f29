"""Prefix-scan MSM pipeline (v3) on PyTorch and CUDA (counterpart of
icicle_tpu/ops/msm_tpu3.py, engines "u32" and "r12"), over every G1 curve.

Reference surface: include/icicle/msm.h (msm, MSMConfig.c,
precompute_factor); CPU algorithm backend/cpu/src/curve/cpu_msm.hpp phases
1-3. Per window group of `wg` windows, on the scalars' device:

  1. signed digits, all windows at once (`plan_digits`: ops/msm.py
     `_signed_digits_t`; with precomputed bases, nu > 1, the copies'
     merged windows, ops/msm.py `_precompute_digit_remap`; with glv, the
     split halves' digits over [P, phi(P)], ops/msm_glv.py);
  2. per (window, tile of T points): one int32 sort of the packed key
     ((M - |digit|) << 14 | neg << 13 | index): |digit| descending, unique;
  3. the permute: one gather from the prepared table of 2 n_pad points
     (row i: P_i; row n_pad + i: -P_i), so the sign costs nothing per MSM
     -> (K, 2L, C) with lane = tile * wg + window;
  4. B3 `prefix_scan` (B5 `prefix_scan_r12` for "r12"): E += P per slot
     -> the E-stream (K, 3L, C);
  5. run-end extraction and fill-forward in one gather: the bucket prefix
     S_j of a tile (the sum of its points with |digit| >= j) is E at slot
     count(|digit| >= j) - 1, which `searchsorted` on the sorted keys
     gives; a key absent from the tile takes the nearest higher key's
     prefix, and the identity where no slot has |digit| >= j;
  6. B4 `ec_reduce` over the tiles (cross-tile fold) -> S_j per window;
  7. the window sums sum_j S_j = sum_k k B_k: two B4 passes over the
     bucket axis, windows riding the lanes;
  8. Horner over the windows and the affine conversion on the host, in
     Python ints: only the (W, 3, L) window sums leave the device.

Steps 2-8 are `msm_stages`, which takes any (W, columns) digit matrix over
a prepared table: `msm_tpu3` and the generic `msm()` (ops/msm.py: batches,
Montgomery-form inputs, any precompute factor) both end in it.

backend "cuda" runs steps 4, 6 and 7 in the hand-written kernels, "torch"
in their plain versions (the JAX package's backend="xla"). The JAX package
permutes and extracts with one-hot matmuls on the TPU's matrix unit; here a
gather does each. The plan is the closed form `_plan3`: the JAX package's
TPU-measured tuning table is not carried over (ROADMAP.md).

Engines (step 4's field arithmetic): "u32" runs B3 (kernels/msm_scan.py,
R = 2^(32 L)); "r12" runs B5 (kernels/msm_scan_r12.py, signed radix-2^12
words, R' = 2^(12 nw)). For "r12" the prepared points are lifted into R'
by one Montgomery multiply by R 2^(12 nw) (the JAX `_prep_fn3`'s folded
constant), and step 5's extracted rows, values in [0, 4p) in R', come
back into R, canonical, before the identity rows of absent keys go in.
The JAX package does that with one Montgomery multiply by
2^(64 L - 12 nw); here `BigField.div_pow2` computes the same canonical
value, a division by 2^(12 nw - 32 L) mod p (2^8 on bn254), for a
fraction of a multiply's torch ops (the multiply took 366 ms per window
group at 2^24 on an NVIDIA H100 80GB HBM3 at 700 W). The engine is `engine=`, else
ICICLE_TPU_MSM_ENGINE, else "u32"; a field too large for radix-12 columns
takes "u32", as in the JAX package.
"""

from __future__ import annotations

import os

import torch

from icicle_tpu_torch.curves.group import get_group
from icicle_tpu_torch.curves.params import get_curve
from icicle_tpu_torch.kernels.ec_reduce import ec_reduce, ec_reduce_ref
from icicle_tpu_torch.kernels.msm_scan import prefix_scan, prefix_scan_ref
from icicle_tpu_torch.kernels.msm_scan_r12 import prefix_scan_r12, prefix_scan_r12_ref, r12_engine
from icicle_tpu_torch.ops.msm import (_limb_tensor, _precompute_digit_remap, _signed_digits_t,
                                      fold_rows, horner, point_table, precompute_shift,
                                      resolve_backend, signed_window_count)
from icicle_tpu_torch.ops.msm_glv import glv_digits_t, glv_split_bound
from icicle_tpu_torch.runtime.errors import IcicleError, IcicleException

_IDX_BITS = 13
_NEG_BIT = 13
_KEY_SHIFT = 14

ENGINES = ("u32", "r12")


def pick_wg(n_windows: int, tiles: int, T: int, row_words: int = 8) -> int:
    """Windows per group: powers of two up to 8 whose in-flight permuted
    points and E-stream (5 coordinates of `row_words` words a slot: 160 B
    at the JAX plan's 8, G2's rows twice their base's) stay within 6 GiB;
    the one that fills the most of 1024 lanes (wg * tiles), then pads the
    fewest windows, then makes the fewest groups."""
    byte_budget = 6 << 30
    per_window = tiles * T * 20 * row_words
    wg_cap = max(1, min(n_windows, byte_budget // max(per_window, 1), 8))
    best = None
    for cand in (8, 4, 2, 1):
        if cand > wg_cap:
            continue
        padded = -(-n_windows // cand) * cand
        occupancy_deficit = 1024 - min(cand * tiles, 1024)
        key = (occupancy_deficit, padded, -cand)
        if best is None or key < best[0]:
            best = (key, cand)
    return best[1]


def _plan3(n: int, c: int | None, nbits: int, T: int | None,
           wg: int | None = None, row_words: int = 8):
    T = T or min(8192, max(256, n))
    T = min(T, 1 << _IDX_BITS)
    if c is None:
        best = None
        for cc in range(4, 17):
            w = (nbits + cc) // cc + 1
            cost = w * (1.0 + (1 << (cc - 1)) / T)
            if best is None or cost < best[1]:
                best = (cc, cost)
        c = best[0]
    M = 1 << (c - 1)
    assert M < (1 << (31 - _KEY_SHIFT))
    n_windows = signed_window_count(nbits, c)
    tiles = -(-n // T)
    tiles = 1 << max(0, (tiles - 1).bit_length())
    return c, M, T, tiles, n_windows, wg or pick_wg(n_windows, tiles, T, row_words)


def _check_engine(engine) -> None:
    if engine not in (None, *ENGINES):
        raise IcicleException(IcicleError.INVALID_ARGUMENT,
                              f"msm_tpu3: unknown engine {engine!r}")


def _resolve_engine(curve_name: str, engine: str | None) -> str:
    """engine=, else ICICLE_TPU_MSM_ENGINE, else "u32"; "r12" on a field
    whose radix-12 columns could overflow int32 takes "u32"."""
    engine = engine or os.environ.get("ICICLE_TPU_MSM_ENGINE") or "u32"
    _check_engine(engine)
    if engine == "r12":
        try:
            r12_engine(curve_name)
        except OverflowError:
            engine = "u32"
    return engine


def _resolve_plan(curve_name, n, c, T, wg, engine, nu, glv=False, bitsize=0, g2=False):
    """The plan of n bases (for nu > 1, n rows of precomputed copies): the
    JAX `_resolve_plan` without its TPU tuning table. glv doubles the point
    set and takes the split halves' width; nu > 1 needs the bases' c and
    merges the windows into max(G0, W - (nu - 1) G0). g2: G2's bases, on
    the "u32" engine (B5 has no Fp2 arithmetic), wg sized by their rows."""
    if g2:
        _check_engine(engine)
        if engine == "r12" or glv:
            raise IcicleException(IcicleError.INVALID_ARGUMENT,
                                  "msm_tpu3: G2 takes the u32 engine and no glv")
        engine = "u32"
    engine = _resolve_engine(curve_name, engine)
    if glv and nu > 1:
        raise IcicleException(IcicleError.INVALID_ARGUMENT,
                              "msm_tpu3: glv and precompute_factor > 1 are not combined "
                              "(as in the JAX package)")
    if glv:
        nbits = glv_split_bound(curve_name)
        n = 2 * n
    else:
        nbits = bitsize or get_curve(curve_name).fr.modulus.bit_length()
    if nu > 1 and not c:
        raise IcicleException(IcicleError.INVALID_ARGUMENT,
                              "msm_tpu3: precomputed bases need the explicit c they were "
                              "made with")
    rows = (get_group(curve_name, g2).nlimbs,) if g2 else ()   # G2's wider rows
    c, M, T, tiles, n_windows, wg = _plan3(n, c, nbits, T, wg, *rows)
    if nu > 1:
        G0 = precompute_shift(nbits, c, nu) // c
        n_windows = max(G0, n_windows - (nu - 1) * G0)
    return dict(engine=engine, nbits=nbits, c=c, M=M, T=T, tiles=tiles,
                n_windows=n_windows, wg=wg, n_pad=tiles * T, nu=nu, glv=glv, g2=g2)


def msm_tpu3_prepare(curve_name: str, points_x, points_y,
                     c: int | None = None, T: int | None = None,
                     engine: str | None = None, precompute_factor: int = 1,
                     wg: int | None = None, glv: bool = False, bitsize: int = 0,
                     g2: bool = False) -> dict:
    """One-time base preparation: pad, convert into the engine's Montgomery
    domain and keep the u32 limbs on the points' device. The result feeds
    msm_tpu3(prepared=...), so repeated MSMs over the same bases skip this
    work (reference: are_points_on_device=true, msm.h:40-49); it carries its
    engine and plan.

    points_x, points_y: (n, L) canonical limbs, int32 tensors or uint32
    numpy arrays (those go to the default device); with
    precompute_factor = nu > 1, the interleaved (nu N, L) output of
    msm_precompute_bases made with the same c. glv=True interleaves
    [P_i, phi(P_i)], phi = (beta x, y), one canonical multiply a point.
    bitsize: the scalars' bits, 0 for the scalar field's. g2: G2 points,
    (n, W) words of its coordinate field (2L over Fp2)."""
    px = _limb_tensor(points_x, None)
    py = _limb_tensor(points_y, px.device)
    n = px.shape[0]
    plan = _resolve_plan(curve_name, n, c, T, wg, engine, precompute_factor, glv, bitsize, g2)
    if glv:
        g = get_group(curve_name)
        phi_x = g.f.mul_mont(px, g.glv_beta_mont(px.device))        # beta x, canonical
        px = torch.stack([px, phi_x], 1).view(2 * n, -1)
        py = torch.stack([py, py], 1).view(2 * n, -1)
    return dict(plan, pts=point_table(curve_name, px, py, plan["n_pad"], plan["engine"], g2),
                n=n)


def _kernels(backend: str, scalars: torch.Tensor, engine: str):
    cuda = resolve_backend(backend, scalars, "msm_tpu3")
    if engine == "r12":
        return (prefix_scan_r12 if cuda else prefix_scan_r12_ref), (ec_reduce if cuda else ec_reduce_ref)
    return (prefix_scan if cuda else prefix_scan_ref), (ec_reduce if cuda else ec_reduce_ref)


def plan_digits(curve_name: str, scalars: torch.Tensor, plan: dict) -> torch.Tensor:
    """(..., N, Ls) int32 scalars -> the (W, ..., columns) signed digits of
    the plan's bases (plan: c, nbits, nu, glv): (W, ..., N) digits; for glv
    (two-dimensional scalars) the split's (Wg, 2N), columns [k1, k2] a
    scalar; for nu > 1 the (G, ..., nu N) merged windows of the copies
    (`_precompute_digit_remap`)."""
    if plan["glv"]:
        return glv_digits_t(curve_name, scalars.T, plan["c"])
    lead, N = scalars.shape[:-2], scalars.shape[-2]
    digits = _signed_digits_t(scalars.reshape(-1, scalars.shape[-1]).T, plan["c"],
                              plan["nbits"]).view(-1, *lead, N)
    nu = plan["nu"]
    if nu > 1:
        G0 = precompute_shift(plan["nbits"], plan["c"], nu) // plan["c"]
        digits, _ = _precompute_digit_remap(digits, nu, N, G0)
    return digits


def msm_stages(curve_name: str, digits: torch.Tensor, prepared: dict,
               backend: str | None = None):
    """Everything v3 does after the digits: (W, columns <= n_pad) int32
    signed digits over `prepared`'s table (column i of the digits scales
    base row i) -> the canonical affine sum as Python ints ((0, 0) = the
    identity). backend: None / "auto" (the digits' device), "cuda" (B3 or
    B5 and B4) or "torch" (their plain versions)."""
    plan = prepared
    scan, reduce = _kernels(backend, digits, plan["engine"])
    table = plan["pts"]
    if table.device != digits.device:
        raise IcicleException(IcicleError.INVALID_ARGUMENT,
                              f"msm_tpu3: scalars on {digits.device}, bases on {table.device}")
    curve = get_curve(curve_name)
    group = get_group(curve_name, plan.get("g2", False))
    nl = group.nlimbs
    dev = digits.device
    c, M, T, tiles, wg = plan["c"], plan["M"], plan["T"], plan["tiles"], plan["wg"]
    n_windows, n_pad = plan["n_windows"], plan["n_pad"]
    if digits.shape[0] != n_windows or digits.shape[1] > n_pad:
        raise IcicleException(IcicleError.INVALID_ARGUMENT,
                              f"msm_tpu3: digits {tuple(digits.shape)} for a plan of "
                              f"{n_windows} windows over {n_pad} bases")
    K, C = T, wg * tiles
    n_groups = -(-n_windows // wg)
    w_pad = n_groups * wg
    # r12: E-stream values are X 2^(12 nw) in [0, 4p); X 2^(32 L), canonical,
    # is their Montgomery multiply by 2^(64 L - 12 nw), computed as the
    # equal division by 2^(12 nw - 32 L) mod p (BigField.div_pow2)
    shift = r12_engine(curve_name).rbits - 32 * nl if plan["engine"] == "r12" else None

    ident_row = torch.cat([torch.zeros(nl, dtype=torch.int32, device=dev),
                           group.one_mont(dev),
                           torch.zeros(nl, dtype=torch.int32, device=dev)])
    iota_t = torch.arange(T, dtype=torch.int32, device=dev)
    tile_base = torch.arange(tiles, dtype=torch.int64, device=dev).view(1, tiles, 1) * T
    # lane = tile * wg + w, per (w, tile, bucket)
    lanes = (torch.arange(tiles, device=dev).view(1, tiles, 1) * wg
             + torch.arange(wg, device=dev).view(wg, 1, 1)).expand(wg, tiles, M)
    # count(|digit| >= M - q) = count(pack < (q + 1) << KEY_SHIFT), q = 0..M-1
    bounds = ((torch.arange(M, dtype=torch.int32, device=dev) + 1) << _KEY_SHIFT
              ).expand(wg, tiles, M).contiguous()

    def group_fn(dg: torch.Tensor) -> torch.Tensor:
        """dg (wg, tiles, T) int32 digits -> cross-tile sums (3L, wg*M)."""
        key = dg.abs()
        neg = (dg < 0).to(torch.int32)
        pack = ((M - key) << _KEY_SHIFT) | (neg << _NEG_BIT) | iota_t
        spack = torch.sort(pack, dim=-1).values                 # (wg, tiles, K)
        sneg = ((spack >> _NEG_BIT) & 1).to(torch.int64)
        sidx = (spack & ((1 << _IDX_BITS) - 1)).to(torch.int64)
        src = sidx + tile_base + sneg * n_pad                   # rows of `table`
        src = src.permute(2, 1, 0).reshape(K * C)               # slot-major lanes
        perm = table.index_select(0, src).view(K, C, 2 * nl).transpose(1, 2).contiguous()
        estream = scan(group if shift is None else curve, perm)  # (K, 3L, C)

        end = torch.searchsorted(spack, bounds) - 1             # (wg, tiles, M)
        rows = estream[end.clamp(min=0), :, lanes]              # (wg, tiles, M, 3L)
        if shift is not None:
            rows = curve.fq.engine.div_pow2(rows.reshape(wg, tiles, M, 3, nl), shift).view(
                wg, tiles, M, 3 * nl)
        rows = torch.where((end >= 0).unsqueeze(-1), rows, ident_row)
        buckets = rows.permute(1, 3, 0, 2).reshape(tiles, 3 * nl, wg * M)
        return reduce(group, buckets.contiguous())              # lane = w*M + q

    full = digits.new_zeros((w_pad, n_pad))
    full[:n_windows, :digits.shape[1]] = digits
    full = full.view(n_groups, wg, tiles, T)
    sums = torch.stack([group_fn(full[g]) for g in range(n_groups)])

    # window sum = sum over all M filled prefixes: B4 over the bucket axis,
    # lane = g*wg + w
    bk = sums.view(n_groups, 3 * nl, wg, M).permute(3, 1, 0, 2).reshape(M, 3 * nl, w_pad)
    total = fold_rows(reduce, group, bk)                        # (3L, w_pad)
    wsums = total[:, :n_windows].T.reshape(n_windows, 3, nl).cpu()
    return horner(group, wsums, c)


def msm_tpu3(curve_name: str, scalars: torch.Tensor, points_x=None, points_y=None,
             c: int | None = None, T: int | None = None,
             backend: str | None = None, engine: str | None = None,
             precompute_factor: int = 1, wg: int | None = None,
             prepared: dict | None = None, glv: bool = False, bitsize: int = 0):
    """Prefix-scan MSM. scalars (N, Ls) int32 limbs on the device to compute
    on, canonical (wider values are taken as integers while the top signed
    window cannot overflow, as with bench.py's scalars at c = 11); points
    canonical affine (N, L) on the same device, or `prepared` from
    msm_tpu3_prepare over them. Returns the canonical affine (x, y) as
    Python ints ((0, 0) = the identity).

    backend: None / "auto" (the scalars' device), "cuda" (the kernels) or
    "torch" (their plain versions). engine: "u32" (B3) or "r12" (B5), else
    ICICLE_TPU_MSM_ENGINE, else "u32"; `prepared` carries its own, and an
    `engine=` that differs from it raises.
    precompute_factor: nu > 1, a power of two, means the points are the
    interleaved (nu N, L) output of msm_precompute_bases with the same c,
    which is then required. glv: split each scalar k = k1 + lambda k2 on
    the device (ops/msm_glv.py) over the [P, phi(P)] bases; not with
    nu > 1. bitsize: the scalars' bits, 0 for the scalar field's (ignored
    with glv, whose digits take the split's width). `prepared` must have
    been made with the same nu, glv and bitsize; bases prepared with g2 give
    G2's ((x0, x1), (y0, y1)) over Fp2."""
    _check_engine(engine)
    nu = precompute_factor
    if nu < 1 or nu & (nu - 1):
        raise IcicleException(IcicleError.INVALID_ARGUMENT,
                              f"msm_tpu3: precompute_factor must be a power of two, got {nu}")
    if prepared is None:
        if points_x is None or points_y is None:
            raise IcicleException(IcicleError.INVALID_ARGUMENT,
                                  "msm_tpu3: give points_x and points_y, or prepared")
        prepared = msm_tpu3_prepare(curve_name, points_x, points_y, c=c, T=T,
                                    engine=engine, precompute_factor=nu, wg=wg, glv=glv,
                                    bitsize=bitsize)
    elif engine is not None and _resolve_engine(curve_name, engine) != prepared["engine"]:
        raise IcicleException(IcicleError.INVALID_ARGUMENT,
                              f"msm_tpu3: engine {engine!r}, but the bases were prepared "
                              f"for {prepared['engine']!r}")
    plan = prepared
    if (plan["nu"], plan["glv"]) != (nu, glv) or (
            bitsize and not glv and bitsize != plan["nbits"]):
        raise IcicleException(IcicleError.INVALID_ARGUMENT,
                              f"msm_tpu3: precompute_factor {nu}, glv {glv}, bitsize {bitsize}, "
                              f"but the bases were prepared with {plan['nu']}, {plan['glv']}, "
                              f"{plan['nbits']} bits")
    if scalars.dim() != 2 or scalars.dtype != torch.int32 or nu * scalars.shape[0] > plan["n"]:
        raise IcicleException(IcicleError.INVALID_ARGUMENT,
                              f"msm_tpu3: scalars must be (n <= {plan['n'] // nu}, Ls) int32, "
                              f"got {tuple(scalars.shape)} {scalars.dtype}")
    return msm_stages(curve_name, plan_digits(curve_name, scalars, plan), plan, backend)
