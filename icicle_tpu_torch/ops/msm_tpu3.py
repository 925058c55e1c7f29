"""Prefix-scan MSM pipeline (v3) on PyTorch and CUDA (counterpart of
icicle_tpu/ops/msm_tpu3.py, engines "u32" and "r12").

Reference surface: include/icicle/msm.h (msm, MSMConfig.c); CPU algorithm
backend/cpu/src/curve/cpu_msm.hpp phases 1-3. Per window group of `wg`
windows, on the scalars' device:

  1. signed digits (ops/msm.py `_signed_digits_t`), all windows at once;
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
from icicle_tpu_torch.ops.msm import (_limb_tensor, _signed_digits_t, fold_rows, horner,
                                      point_table, resolve_backend, signed_window_count)
from icicle_tpu_torch.runtime.errors import IcicleError, IcicleException

_IDX_BITS = 13
_NEG_BIT = 13
_KEY_SHIFT = 14

ENGINES = ("u32", "r12")


def _plan3(n: int, c: int | None, nbits: int, T: int | None,
           wg: int | None = None):
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
    # windows per group: bound in-flight permuted+E-stream bytes (~160B/slot)
    if wg is None:
        byte_budget = 6 << 30
        per_window = tiles * T * 160
        wg_cap = max(1, min(n_windows, byte_budget // max(per_window, 1), 8))
        # powers of two only; maximise lane occupancy (min(wg*tiles, 1024)),
        # then minimise padded windows, then the fewest groups
        best = None
        for cand in (8, 4, 2, 1):
            if cand > wg_cap:
                continue
            padded = -(-n_windows // cand) * cand
            occupancy_deficit = 1024 - min(cand * tiles, 1024)
            key = (occupancy_deficit, padded, -cand)
            if best is None or key < best[0]:
                best = (key, cand)
        wg = best[1]
    return c, M, T, tiles, n_windows, wg


def _check_ported(engine, nu) -> None:
    if engine not in (None, *ENGINES):
        raise IcicleException(IcicleError.INVALID_ARGUMENT,
                              f"msm_tpu3: unknown engine {engine!r}")
    if nu != 1:
        raise NotImplementedError(
            "msm_tpu3: precompute_factor > 1 is not ported yet "
            "(ROADMAP.md queue A item 6)")


def _resolve_engine(curve_name: str, engine: str | None, nu: int = 1) -> str:
    """engine=, else ICICLE_TPU_MSM_ENGINE, else "u32"; "r12" on a field
    whose radix-12 columns could overflow int32 takes "u32"."""
    engine = engine or os.environ.get("ICICLE_TPU_MSM_ENGINE") or "u32"
    _check_ported(engine, nu)
    if engine == "r12":
        try:
            r12_engine(curve_name)
        except OverflowError:
            engine = "u32"
    return engine


def _resolve_plan(curve_name, n, c, T, wg, engine, nu):
    engine = _resolve_engine(curve_name, engine, nu)
    nbits = get_curve(curve_name).fr.modulus.bit_length()
    c, M, T, tiles, n_windows, wg = _plan3(n, c, nbits, T, wg)
    return dict(engine=engine, nbits=nbits, c=c, M=M, T=T, tiles=tiles,
                n_windows=n_windows, wg=wg, n_pad=tiles * T, nu=nu)


def msm_tpu3_prepare(curve_name: str, points_x, points_y,
                     c: int | None = None, T: int | None = None,
                     engine: str | None = None, precompute_factor: int = 1,
                     wg: int | None = None) -> dict:
    """One-time base preparation: pad, convert into the engine's Montgomery
    domain and keep the u32 limbs on the points' device. The result feeds
    msm_tpu3(prepared=...), so repeated MSMs over the same bases skip this
    work (reference: are_points_on_device=true, msm.h:40-49); it carries its
    engine.

    points_x, points_y: (n, L) canonical limbs, int32 tensors or uint32
    numpy arrays (those go to the default device)."""
    px = _limb_tensor(points_x, None)
    py = _limb_tensor(points_y, px.device)
    n = px.shape[0]
    plan = _resolve_plan(curve_name, n, c, T, wg, engine, precompute_factor)
    return dict(plan, pts=point_table(curve_name, px, py, plan["n_pad"], plan["engine"]), n=n)


def _kernels(backend: str, scalars: torch.Tensor, engine: str):
    cuda = resolve_backend(backend, scalars, "msm_tpu3")
    if engine == "r12":
        return (prefix_scan_r12 if cuda else prefix_scan_r12_ref), (ec_reduce if cuda else ec_reduce_ref)
    return (prefix_scan if cuda else prefix_scan_ref), (ec_reduce if cuda else ec_reduce_ref)


def msm_tpu3(curve_name: str, scalars: torch.Tensor, points_x=None, points_y=None,
             c: int | None = None, T: int | None = None,
             backend: str | None = None, engine: str | None = None,
             precompute_factor: int = 1, wg: int | None = None,
             prepared: dict | None = None):
    """Prefix-scan MSM. scalars (N, Ls) int32 limbs on the device to compute
    on, canonical (wider values are taken as integers while the top signed
    window cannot overflow, as with bench.py's scalars at c = 11); points
    canonical affine (N, L) on the same device, or `prepared` from
    msm_tpu3_prepare over them. Returns the canonical affine (x, y) as
    Python ints ((0, 0) = the identity).

    backend: None / "auto" (the scalars' device), "cuda" (the kernels) or
    "torch" (their plain versions). engine: "u32" (B3) or "r12" (B5), else
    ICICLE_TPU_MSM_ENGINE, else "u32"; `prepared` carries its own, and an
    `engine=` that differs from it raises."""
    _check_ported(engine, precompute_factor)
    if prepared is None:
        if points_x is None or points_y is None:
            raise IcicleException(IcicleError.INVALID_ARGUMENT,
                                  "msm_tpu3: give points_x and points_y, or prepared")
        prepared = msm_tpu3_prepare(curve_name, points_x, points_y, c=c, T=T,
                                    engine=engine, wg=wg)
    elif engine is not None and _resolve_engine(curve_name, engine) != prepared["engine"]:
        raise IcicleException(IcicleError.INVALID_ARGUMENT,
                              f"msm_tpu3: engine {engine!r}, but the bases were prepared "
                              f"for {prepared['engine']!r}")
    plan = prepared
    scan, reduce = _kernels(backend, scalars, plan["engine"])
    table = plan["pts"]
    if table.device != scalars.device:
        raise IcicleException(IcicleError.INVALID_ARGUMENT,
                              f"msm_tpu3: scalars on {scalars.device}, bases on {table.device}")
    if scalars.dim() != 2 or scalars.dtype != torch.int32 or scalars.shape[0] > plan["n"]:
        raise IcicleException(IcicleError.INVALID_ARGUMENT,
                              f"msm_tpu3: scalars must be (n <= {plan['n']}, Ls) int32, "
                              f"got {tuple(scalars.shape)} {scalars.dtype}")

    curve = get_curve(curve_name)
    fq = curve.fq
    nl = fq.nlimbs
    dev = scalars.device
    c, M, T, tiles, wg = plan["c"], plan["M"], plan["T"], plan["tiles"], plan["wg"]
    n_windows, n_pad = plan["n_windows"], plan["n_pad"]
    K, C = T, wg * tiles
    n_groups = -(-n_windows // wg)
    w_pad = n_groups * wg
    # r12: E-stream values are X 2^(12 nw) in [0, 4p); X 2^(32 L), canonical,
    # is their Montgomery multiply by 2^(64 L - 12 nw), computed as the
    # equal division by 2^(12 nw - 32 L) mod p (BigField.div_pow2)
    shift = r12_engine(curve_name).rbits - 32 * nl if plan["engine"] == "r12" else None

    ident_row = torch.cat([torch.zeros(nl, dtype=torch.int32, device=dev),
                           get_group(curve_name).one_mont(dev),
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
        estream = scan(curve, perm)                             # (K, 3L, C)

        end = torch.searchsorted(spack, bounds) - 1             # (wg, tiles, M)
        rows = estream[end.clamp(min=0), :, lanes]              # (wg, tiles, M, 3L)
        if shift is not None:
            rows = fq.engine.div_pow2(rows.reshape(wg, tiles, M, 3, nl), shift).view(
                wg, tiles, M, 3 * nl)
        rows = torch.where((end >= 0).unsqueeze(-1), rows, ident_row)
        buckets = rows.permute(1, 3, 0, 2).reshape(tiles, 3 * nl, wg * M)
        return reduce(curve, buckets.contiguous())              # lane = w*M + q

    s_t = torch.zeros((scalars.shape[1], n_pad), dtype=torch.int32, device=dev)
    s_t[:, :scalars.shape[0]] = scalars.T
    digits = _signed_digits_t(s_t, c, plan["nbits"])            # (W, n_pad)
    if w_pad != n_windows:
        digits = torch.cat([digits, digits.new_zeros((w_pad - n_windows, n_pad))])
    digits = digits.view(n_groups, wg, tiles, T)
    sums = torch.stack([group_fn(digits[g]) for g in range(n_groups)])

    # window sum = sum over all M filled prefixes: B4 over the bucket axis,
    # lane = g*wg + w
    bk = sums.view(n_groups, 3 * nl, wg, M).permute(3, 1, 0, 2).reshape(M, 3 * nl, w_pad)
    total = fold_rows(reduce, curve, bk)                        # (3L, w_pad)
    wsums = total[:, :n_windows].T.reshape(n_windows, 3, nl).cpu()
    return horner(fq, wsums, c)

