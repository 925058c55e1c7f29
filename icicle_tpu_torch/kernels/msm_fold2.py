"""MSM v2 suffix fold over a hand-written CUDA kernel (counterpart of
icicle_tpu/pallas/msm_fold2.py).

`suffix_fold` runs kernel B6 (kernels/csrc/msm_fold2.cu), which replaces
`make_suffix_fold`. Per lane (one tile of one window, its slots sorted by
|digit| descending with one dummy slot for every key), two accumulators
from the identity: E += P where the slot is real (flag bit 0), then
D += E where it ends a key's run (bit 1). On such a stream the run-end
values of E are the bucket prefixes S_j, so D ends as sum_j S_j =
sum_k k B_k, the tile's weighted window sum. `suffix_fold_ref` is the same
function in plain torch over curves/group.py.

D is the sum of E at the run ends, so the kernel computes it as a scan
that stores E at each run end, then B4 (`ec_reduce`) over those rows:
  1. each lane's K slots are split into S segments (`fold_segments`) of
     ceil(K/S) slots; each segment folds its slots from the identity
     (madd where bit 0) and stores E at its run ends to `ends` (R, 3L, C);
  2. carry scan: carry_0 = identity, carry_{s+1} = padd(carry_s, total_s);
  3. fixup: each row stored by a segment s >= 1 becomes padd(carry_s, row);
  4. D = ec_reduce(ends), B4 with its own plan.
A lane's run ends fill the last rows of `ends` in slot order (`run_starts`)
and the rows before them hold the identity, so at segments=1 with a serial
B4 (reduce_segments=1) the adds are those of the serial fold of the JAX
XLA twin `make_suffix_fold_xla`, in its order and from the identity, and
the two agree bit for bit. The plain version repeats the kernel's
association at any S, so kernel and plain agree bit for bit at the same
S; other S give other projective coordinates of the same point.

B6 is built for every G1 curve: 8, 12 and 24 limbs, one library each.

Layout: plimbs (K, 2L, C) int32 Montgomery x || y, flags (K, C) int32;
out (3L, C), x / y / z rows. The Pallas kernel takes the points as bf16
bytes (its matrix-unit permute's output) with the flags in an extra row
and negates y where flag bit 2 is set; here the limbs come from a gather
over the prepared +-P table, which applies the sign, so the flag word
carries bits 0 and 1 only.
"""

from __future__ import annotations

import torch

from icicle_tpu_torch.curves.group import Affine, Projective, get_group, pselect
from icicle_tpu_torch.kernels import msm_lib
from icicle_tpu_torch.kernels.ec_reduce import ec_reduce, ec_reduce_ref
from icicle_tpu_torch.kernels.msm_scan import check_segments, scan_segments

IS_REAL = 1
IS_DACC = 2


def fold_segments(K: int, C: int) -> int:
    """Segments per lane for a (K, ., C) fold: B3's rule (`scan_segments`)
    for one wave of blocks (msm_lib.ONE_WAVE_THREADS)."""
    return scan_segments(K, C, msm_lib.ONE_WAVE_THREADS)


def run_starts(flags: torch.Tensor, S: int, runs: int | None) -> tuple[torch.Tensor, int]:
    """(starts (S, C) int32, R): R rows of run ends (`runs`, else the most
    run ends of any lane, at least 1), and per lane the row of segment s's
    first run end, R - (run ends in the lane) + (run ends before segment s),
    so that a lane's run ends fill its last rows in slot order. Finding R
    without `runs` reads a count back to the host."""
    K, C = flags.shape
    if runs is not None and (not isinstance(runs, int) or runs < 1):
        raise msm_lib.invalid("suffix_fold", f"runs must be an int >= 1, got {runs!r}")
    n = -(-K // S)
    ends = (flags >> 1) & 1                                            # (K, C)
    if S * n != K:
        ends = torch.cat([ends, ends.new_zeros((S * n - K, C))])
    counts = ends.view(S, n, C).sum(1, dtype=torch.int32)             # (S, C)
    before = torch.cumsum(counts, 0, dtype=torch.int32) - counts
    total = before[-1] + counts[-1]
    R = runs if runs is not None else max(1, int(total.max()))
    return (before + (R - total)).contiguous(), R


def suffix_fold(curve, plimbs: torch.Tensor, flags: torch.Tensor, *, runs: int | None = None,
                _segments: int | None = None) -> torch.Tensor:
    """(K, 2L, C) int32 points and (K, C) int32 flags -> (3L, C) D per lane.

    runs: the number of run ends (bit 1) of every lane, where the caller
    knows it (v2's stream has exactly M); a lane with fewer is padded with
    the identity, and one with more gives a wrong sum (its first run ends
    are dropped, no store leaves the buffer). Without it the wrapper counts
    them, reading the largest count back to the host. `_segments`
    overrides the plan's split, to time others.

    On CUDA tensors this launches the kernel's passes and then `ec_reduce`
    on the current stream (no synchronisation), counts one launch in
    `suffix_fold.launches` per call (B4's in `ec_reduce.launches`) and
    raises if a launch is refused or the curve has no instantiation. On CPU
    tensors it computes `suffix_fold_ref`."""
    curve = msm_lib.as_curve(curve)
    nl = curve.fq.nlimbs
    msm_lib.check_points("suffix_fold", plimbs, 2 * nl)
    K, _, C = plimbs.shape
    msm_lib.check_aux("suffix_fold", flags, (K, C), plimbs)
    S = check_segments("suffix_fold", _segments, fold_segments(K, C))
    if not plimbs.is_cuda:
        return suffix_fold_ref(curve, plimbs, flags, S, runs=runs)
    starts, R = run_starts(flags, S, runs)
    ends = torch.empty((R, 3 * nl, C), dtype=torch.int32, device=plimbs.device)
    carries = torch.empty((S - 1, 3 * nl, C), dtype=torch.int32, device=plimbs.device)
    msm_lib.launch("suffix_fold", curve, [plimbs, flags, starts, ends, carries], [K, C, S, R])
    suffix_fold.launches += 1
    return ec_reduce(curve, ends)


suffix_fold.launches = 0


def suffix_fold_ref(curve, plimbs: torch.Tensor, flags: torch.Tensor,
                    segments: int | None = None, *, runs: int | None = None,
                    reduce_segments: int | None = None) -> torch.Tensor:
    """`suffix_fold` in plain torch, with the kernel's association of adds
    at S = `segments` (None: the plan's): a Python loop over ceil(K/S)
    steps of all S * C (segment, lane) pairs, the S - 1 carry adds, the
    fixup, then `ec_reduce_ref` over the run ends at `reduce_segments`
    (None: B4's plan, as the kernel). segments=1 with reduce_segments=1 is
    the serial fold."""
    curve = msm_lib.as_curve(curve)
    g = get_group(curve.name)
    nl = curve.fq.nlimbs
    K, _, C = plimbs.shape
    S = check_segments("suffix_fold", segments, fold_segments(K, C))
    dev = plimbs.device
    starts, R = run_starts(flags, S, runs)
    n = -(-K // S)
    steps = msm_lib.segment_rows(plimbs, S)                          # (n, S, C, 2L)
    fsteps = msm_lib.segment_rows(flags.view(K, 1, C), S)[..., 0]     # (n, S, C); pads 0
    lane = torch.arange(C, device=dev).expand(S, C)
    ends = msm_lib.cat_point(g.identity((R, C), dev))                # (R, C, 3L)

    # pass 1: fold every segment from the identity, storing E at its run ends
    e = g.identity((S, C), dev)
    rank = starts.clone()
    for j in range(n):
        fl = fsteps[j]
        e = pselect((fl & IS_REAL) != 0,
                    g.madd(e, Affine(steps[j, ..., :nl], steps[j, ..., nl:])), e)
        end = (fl & IS_DACC) != 0
        put = end & (rank >= 0)
        ends[rank[put], lane[put]] = msm_lib.cat_point(e)[put]
        rank = rank + end.to(torch.int32)
    if S > 1:
        # pass 2: the carries; pass 3: row r of segment s >= 1 += carry_s
        carries = [g.identity((C,), dev)]
        for s in range(S - 1):
            carries.append(g.add(carries[-1], Projective(*(t[s] for t in e))))
        carry = Projective(*(torch.stack(t) for t in zip(*carries)))      # (S, C, L) each
        r = torch.arange(R, device=dev).view(R, 1, 1)
        owner = (starts[1:].unsqueeze(0) <= r).sum(1)                     # (R, C)
        fixed = g.add(Projective(*(t[owner, lane[:1].expand(R, C)] for t in carry)),
                      msm_lib.split_point(ends, nl))
        ends = torch.where((owner >= 1).unsqueeze(-1), msm_lib.cat_point(fixed), ends)
    return ec_reduce_ref(curve, ends.transpose(1, 2).contiguous(), reduce_segments)
