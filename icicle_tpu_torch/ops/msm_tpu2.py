"""Suffix-fold MSM pipeline (v2) on PyTorch and CUDA (counterpart of
icicle_tpu/ops/msm_tpu2.py).

Reference surface: include/icicle/msm.h (msm, MSMConfig.c); CPU algorithm
backend/cpu/src/curve/cpu_msm.hpp. Per group of wg windows, on the
scalars' device:

  1. signed digits (ops/msm.py `_signed_digits_t`), all windows at once;
  2. per (window, tile of T points): one int32 sort of the packed key
     ((M - |digit|) << 14 | neg << 13 | index), with M dummy slots (keys
     1..M, index `_IDX_MASK`) appended, so that every key occurs in every
     tile: K = T + M slots;
  3. flags per slot: bit 0 is_real (not a dummy), bit 1 is_dacc (the last
     slot of a key's run, key >= 1);
  4. the permute: one gather from the prepared +-P table (ops/msm.py
     `point_table`); a dummy gathers its tile's last row, which its
     is_real = 0 leaves unused -> (K, 2L, C), lane = tile * wg + window;
  5. B6 `suffix_fold`: E += P, D += E at run ends -> each tile's weighted
     window sum (3L, C); every lane ends exactly M runs (one dummy a key),
     which the call passes as `runs`;
  6. the cross-tile sum per window by B4 `ec_reduce`, windows riding the
     lanes: two passes at 8192 tiles (`fold_rows`, as v3's bucket passes).
     The JAX package sums the tiles with a log-depth roll-scan of adds
     (`_reduce_tiles_all`); the sum is the same point, in other projective
     coordinates;
  7. Horner over the windows on the host (ops/msm.py `horner`).

backend "cuda" runs steps 5 and 6 in the hand-written kernels, "torch" in
their plain versions (the JAX package's backend="xla"). The JAX package
permutes with a one-hot bf16 matmul on the TPU's matrix unit and hands B6
coordinate bytes with the flags and a negate bit; here a gather over the
+-P table does it and B6 takes int32 limbs. `msm_affine` takes this
pipeline under ICICLE_TPU_MSM_PIPELINE=v2 (ops/msm.py).
"""

from __future__ import annotations

import torch

from icicle_tpu_torch.curves.group import get_group
from icicle_tpu_torch.curves.params import get_curve
from icicle_tpu_torch.runtime.errors import IcicleError, IcicleException
from icicle_tpu_torch.kernels.ec_reduce import ec_reduce, ec_reduce_ref
from icicle_tpu_torch.kernels.msm_fold2 import IS_DACC, IS_REAL, suffix_fold, suffix_fold_ref
from icicle_tpu_torch.ops.msm import (_limb_tensor, _signed_digits_t, fold_rows, horner,
                                      point_table, resolve_backend, signed_window_count)

_IDX_BITS = 13
_IDX_MASK = (1 << _IDX_BITS) - 1     # 8191; dummy slots use idx == mask
_KEY_SHIFT = _IDX_BITS + 1


def _plan2(n: int, c: int | None, nbits: int, T: int | None):
    # T = 2048 balanced the TPU's one-hot permute (MACs ~ n T) against the
    # dummy slots (M / T); kept so that the plan equals the JAX package's
    T = T or min(2048, n)
    T = min(T, n)
    if c is None:
        # minimise W(c) (T + M(c)): fold slots across all windows
        best = None
        for cc in range(4, 13):
            w = (nbits + cc) // cc + 1
            cost = w * (T + (1 << (cc - 1)))
            if best is None or cost < best[1]:
                best = (cc, cost)
        c = best[0]
    M = 1 << (c - 1)
    assert T + 1 < _IDX_MASK, "tile too large for the packed-sort layout"
    assert M <= ((1 << 31) >> _KEY_SHIFT), "window too large for packed sort"
    n_windows = signed_window_count(nbits, c)
    tiles = -(-n // T)
    tiles = 1 << max(0, (tiles - 1).bit_length())
    # windows per fold pass: at most 16384 lanes and ~4 GB of permuted data
    # (~256 B per slot), balanced across groups
    byte_budget = 4 << 30
    per_window = tiles * (T + M) * 256
    wg = max(1, min(n_windows, 16384 // tiles, byte_budget // per_window))
    n_groups = -(-n_windows // wg)
    wg = -(-n_windows // n_groups)
    return c, M, T, tiles, n_windows, wg


def msm_tpu2(curve_name: str, scalars, points_x, points_y,
             c: int | None = None, T: int | None = None, backend: str | None = None,
             bitsize: int = 0):
    """Suffix-fold MSM. scalars (N, Ls) int32 limbs on the device to compute
    on (numpy uint32 arrays go to the default device), canonical; points
    canonical affine (N, L) on the same device. Returns the canonical affine
    (x, y) as Python ints ((0, 0) = the identity).

    backend: None / "auto" (the scalars' device), "cuda" (the kernels) or
    "torch" (their plain versions). bitsize: the scalars' bits, 0 for the
    scalar field's (MSMConfig.bitsize)."""
    scalars = _limb_tensor(scalars, None)
    px = _limb_tensor(points_x, scalars.device)
    py = _limb_tensor(points_y, scalars.device)
    if px.shape[0] != scalars.shape[0] or py.shape[0] != scalars.shape[0]:
        # the JAX package fails there too (a broadcast of its padded copy)
        raise IcicleException(IcicleError.INVALID_ARGUMENT,
                              f"msm_tpu2: {scalars.shape[0]} scalars but {px.shape[0]} x "
                              f"and {py.shape[0]} y coordinates")
    cuda = resolve_backend(backend, scalars, "msm_tpu2")
    fold, reduce = (suffix_fold, ec_reduce) if cuda else (suffix_fold_ref, ec_reduce_ref)
    curve = get_curve(curve_name)
    fq = curve.fq
    nl = fq.nlimbs
    dev = scalars.device
    n = scalars.shape[0]
    nbits = bitsize or curve.fr.modulus.bit_length()
    c, M, T, tiles, n_windows, wg = _plan2(n, c, nbits, T)
    n_pad = tiles * T
    K, C = T + M, wg * tiles
    n_groups = -(-n_windows // wg)
    w_pad = n_groups * wg
    table = point_table(curve_name, px, py, n_pad)

    iota_t = torch.arange(T, dtype=torch.int32, device=dev)
    # dummy slots: keys 1..M, index the sentinel, never negated
    dummy = ((M - torch.arange(1, M + 1, dtype=torch.int32, device=dev)) << _KEY_SHIFT
             ) | _IDX_MASK
    tile_base = torch.arange(tiles, dtype=torch.int64, device=dev).view(1, tiles, 1) * T

    def group_fn(dg: torch.Tensor) -> torch.Tensor:
        """dg (wg, tiles, T) int32 digits -> per-tile window sums (3L, C)."""
        pack = ((M - dg.abs()) << _KEY_SHIFT) | ((dg < 0).to(torch.int32) << _IDX_BITS) | iota_t
        pack = torch.cat([pack, dummy.expand(wg, tiles, M)], dim=2)
        spack = torch.sort(pack, dim=-1).values                 # (wg, tiles, K)
        skey = M - (spack >> _KEY_SHIFT)
        sneg = ((spack >> _IDX_BITS) & 1).to(torch.int64)
        sidx = spack & _IDX_MASK
        is_real = sidx != _IDX_MASK
        nxt = torch.cat([skey[..., 1:], skey.new_full((wg, tiles, 1), -1)], dim=2)
        is_dacc = (skey != nxt) & (skey >= 1)
        flags = (is_real.to(torch.int32) * IS_REAL) | (is_dacc.to(torch.int32) * IS_DACC)
        flags = flags.permute(2, 1, 0).reshape(K, C).contiguous()  # lane = tile*wg + w
        src = sidx.clamp(max=T - 1).to(torch.int64) + tile_base + sneg * n_pad
        src = src.permute(2, 1, 0).reshape(K * C)               # slot-major lanes
        perm = table.index_select(0, src).view(K, C, 2 * nl).transpose(1, 2).contiguous()
        return fold(curve, perm, flags, runs=M)             # M run ends a lane

    s_t = torch.zeros((scalars.shape[1], n_pad), dtype=torch.int32, device=dev)
    s_t[:, :n] = scalars.T
    digits = _signed_digits_t(s_t, c, nbits)                    # (W, n_pad)
    if w_pad != n_windows:
        digits = torch.cat([digits, digits.new_zeros((w_pad - n_windows, n_pad))])
    digits = digits.view(n_groups, wg, tiles, T)
    folds = torch.stack([group_fn(digits[g]) for g in range(n_groups)])  # (ng, 3L, C)

    # cross-tile sum: rows = tiles, lane = g*wg + w
    pts = folds.view(n_groups, 3 * nl, tiles, wg).permute(2, 1, 0, 3).reshape(
        tiles, 3 * nl, w_pad)
    total = fold_rows(reduce, curve, pts)                       # (3L, w_pad)
    wsums = total[:, :n_windows].T.reshape(n_windows, 3, nl).cpu()
    return horner(get_group(curve_name), wsums, c)
