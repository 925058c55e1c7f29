"""Bucket-accumulation MSM pipeline (v1) on PyTorch and CUDA (counterpart
of icicle_tpu/ops/msm_tpu.py).

Per chunk of windows (all W at once, or `wchunk` at a time), on the
scalars' device:

  1. signed digits (ops/msm.py `_signed_digits`);
  2. per window, a stable sort of the points by |digit| and one gather from
     the prepared +-P table (ops/msm.py `point_table`), which applies
     the digit's sign; lane c owns sorted positions c K .. c K + K - 1;
  3. B7 `bucket_accum`: per (window, lane) the inclusive segmented fold
     over its K slots, a fresh sum at every new key;
  4. `_bucket_phase`: each key's run-end value gathered into its bucket;
     a run that crosses lanes leaves its earlier part in the lanes' last
     slots, which a segmented scan over the lanes stitches and adds in;
  5. the weighted bucket sum sum_k k B_k by two inclusive prefix scans over
     the buckets from M down to 1;
  6. Horner over the windows on the host (ops/msm.py `horner`).

backend "cuda" runs step 3 in the hand-written kernel, "torch" in its
plain version (the JAX package's backend="xla"); steps 4 and 5 are torch
ops on either (XLA ops in the JAX package). The JAX scatters send dropped
rows to index M + 1 with mode="drop"; torch raises on an index out of
range, so they go into an (M + 2)-row buffer whose last row is cut off.
`msm_affine` does not route here (as in the JAX package): call `msm_tpu`.
"""

from __future__ import annotations

import torch

from icicle_tpu_torch.curves.group import Projective, get_group
from icicle_tpu_torch.curves.params import get_curve
from icicle_tpu_torch.kernels.msm_kernel import bucket_accum, bucket_accum_ref
from icicle_tpu_torch.ops.msm import (_auto_c, _limb_tensor, _prefix_scan_add,
                                      _segmented_scan_add, _signed_digits, horner,
                                      point_table, resolve_backend, signed_window_count)
from icicle_tpu_torch.runtime.errors import IcicleError, IcicleException


def _plan(n: int, c: int | None, nbits: int, lanes: int):
    # auto c is capped at 12, as in the JAX package (whose reason, the TPU's
    # bucket-reduction scans, was measured there)
    c = c or min(_auto_c(n), 12)
    n_windows = signed_window_count(nbits, c)
    lanes = min(lanes, n)
    k_steps = n // lanes
    if lanes * k_steps != n:
        raise IcicleException(IcicleError.INVALID_ARGUMENT,
                              f"msm_tpu: n = {n} must be a multiple of the lane count {lanes}")
    return c, n_windows, k_steps, lanes


def _auto_wchunk(n: int, n_windows: int, limb_words: int) -> int | None:
    """Windows per pass under a ~4 GB working set (sorted copies, fold
    outputs and transposes, ~10 coordinate arrays per window); None = all."""
    per_window = n * limb_words * 4 * 10
    g = max(1, (4 << 30) // per_window)
    return None if g >= n_windows else int(g)


def _scatter_rows(group, idx: torch.Tensor, vals: torch.Tensor, M: int) -> torch.Tensor:
    """Rows vals (W, n, 3L) into an identity-filled (W, M + 1, 3L) at idx
    (W, n); idx M + 1 drops the row."""
    W, _, width = vals.shape
    ident = torch.cat(list(group.identity((W, M + 2), vals.device)), dim=-1)
    return ident.scatter(1, idx.unsqueeze(-1).expand(-1, -1, width), vals)[:, :M + 1]


def _run_end_rows(group, out: torch.Tensor, k_sorted: torch.Tensor, M: int) -> torch.Tensor:
    """Each key 1..M's value at its last sorted position (the global run
    end; position = lane * K + slot), gathered from B7's output (W, K, 3L,
    C), with the identity for key 0 and for keys absent: (W, M + 1, 3L)."""
    W, K, width, _ = out.shape
    dev = out.device
    keys = torch.arange(1, M + 1, dtype=k_sorted.dtype, device=dev).expand(W, M).contiguous()
    last = (torch.searchsorted(k_sorted, keys, right=True) - 1).clamp(min=0)    # (W, M)
    present = k_sorted.gather(1, last) == keys
    w = torch.arange(W, device=dev).view(W, 1)
    rows = out[w, last % K, :, last // K]                                      # (W, M, 3L)
    ident = torch.cat(list(group.identity((W, M + 1), dev)), dim=-1)
    return torch.cat([ident[:, :1], torch.where(present.unsqueeze(-1), rows, ident[:, 1:])], 1)


def _split(rows: torch.Tensor, nl: int) -> Projective:
    return Projective(rows[..., :nl], rows[..., nl:2 * nl], rows[..., 2 * nl:])


def _bucket_phase(group, out: torch.Tensor, k_sorted: torch.Tensor,
                  lane_keys: torch.Tensor, M: int) -> torch.Tensor:
    """B7's output (W, K, 3L, C), the sorted keys (W, n) and the lane keys
    (W, K, C) -> the window sums sum_k k B_k as (W, 3L). Reads B7's output
    only at its contract's rows (msm_kernel.contract_rows): the global run
    ends, which are lane run ends or lane ends, and each lane's last slot."""
    W, K, width, C = out.shape
    nl = width // 3
    ones = torch.ones((W, 1), dtype=torch.bool, device=out.device)

    # global run ends -> buckets0
    buckets0 = _split(_run_end_rows(group, out, k_sorted, M), nl)

    # cross-lane tail stitching
    final_keys = lane_keys[:, -1, :]                            # (W, C)
    first_keys = lane_keys[:, 0, :]
    finals = out[:, -1].transpose(1, 2)                         # (W, C, 3L)
    cont = torch.cat([first_keys[:, 1:] == final_keys[:, :-1], ~ones], dim=1)
    ident = torch.cat(list(group.identity((W, C), out.device)), dim=-1)
    tails = torch.where((cont & (final_keys > 0)).unsqueeze(-1), finals, ident)
    first_lane = torch.cat([ones, final_keys[:, 1:] != final_keys[:, :-1]], dim=1)
    scanned = _segmented_scan_add(group, _split(tails.transpose(0, 1), nl), first_lane.T)
    run_end = torch.cat([final_keys[:, 1:] != final_keys[:, :-1], ones], dim=1)
    tidx = torch.where(run_end & (final_keys > 0), final_keys, M + 1).to(torch.int64)
    scanned_rows = torch.cat(list(scanned), dim=-1).transpose(0, 1)  # (W, C, 3L)
    buckets1 = _split(_scatter_rows(group, tidx, scanned_rows, M), nl)

    buckets = group.add(buckets0, buckets1)                     # (W, M + 1)

    # weighted reduction: two prefix scans over buckets M..1
    rev = Projective(*(a[:, 1:].flip(1).transpose(0, 1) for a in buckets))  # (M, W, L)
    r2 = _prefix_scan_add(group, _prefix_scan_add(group, rev))
    return torch.cat([a[-1] for a in r2], dim=-1)               # (W, 3L)


def msm_tpu(curve_name: str, scalars, points_x, points_y, c: int | None = None,
            lanes: int = 1024, backend: str | None = None,
            wchunk: int | str | None = "auto"):
    """Full MSM. scalars (N, Ls) int32 limbs on the device to compute on
    (numpy uint32 arrays go to the default device), canonical; points
    canonical affine (N, L) on the same device. N must be a multiple of
    `lanes` (or below it). Returns the canonical affine (x, y) as Python
    ints ((0, 0) = the identity).

    backend: None / "auto" (the scalars' device), "cuda" (the kernel) or
    "torch" (its plain version). wchunk: windows per pass ("auto" sizes it
    to a ~4 GB working set, None = all)."""
    scalars = _limb_tensor(scalars, None)
    px = _limb_tensor(points_x, scalars.device)
    py = _limb_tensor(points_y, scalars.device)
    accum = bucket_accum if resolve_backend(backend, scalars, "msm_tpu") else bucket_accum_ref
    curve = get_curve(curve_name)
    group = get_group(curve_name)
    fq = curve.fq
    nl = fq.nlimbs
    n = scalars.shape[0]
    nbits = curve.fr.modulus.bit_length()
    c, total_windows, K, C = _plan(n, c, nbits, lanes)
    if wchunk == "auto":
        wchunk = _auto_wchunk(n, total_windows, nl)
    g = wchunk or total_windows
    M = 1 << (c - 1)
    table = point_table(curve_name, px, py, n)                  # (2n, 2L)

    def run_chunk(digits: torch.Tensor) -> torch.Tensor:
        """digits (g, n) -> window sums (g, 3L)."""
        keys = digits.abs()
        order = torch.sort(keys, dim=1, stable=True).indices
        k_sorted = keys.gather(1, order)
        src = order + n * (digits.gather(1, order) < 0)
        pts = table.index_select(0, src.reshape(-1)).view(g, C, K, 2 * nl)
        plimbs = pts.permute(0, 2, 3, 1).contiguous()           # (g, K, 2L, C)
        lane_keys = k_sorted.view(g, C, K).transpose(1, 2).contiguous()
        out = accum(curve, lane_keys, plimbs)                   # (g, K, 3L, C)
        return _bucket_phase(group, out, k_sorted, lane_keys, M)

    digits = _signed_digits(scalars, c, nbits)                  # (W, n)
    n_chunks = -(-total_windows // g)
    if n_chunks * g != total_windows:
        digits = torch.cat([digits, digits.new_zeros((n_chunks * g - total_windows, n))])
    wsums = torch.cat([run_chunk(digits[i * g:(i + 1) * g]) for i in range(n_chunks)])
    return horner(group, wsums[:total_windows].view(total_windows, 3, nl).cpu(), c)
