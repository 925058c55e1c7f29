"""Lane-parallel EC point sums over a hand-written CUDA kernel (counterpart
of icicle_tpu/pallas/ec_reduce.py).

`ec_reduce` runs kernel B4 (kernels/csrc/ec_reduce.cu), which replaces
`make_ec_reduce`: per lane, the sum of the R rows by the complete projective
add (RCB15 Alg 7), starting from the identity as the Pallas kernel does.
`ec_reduce_ref` is the same function in plain torch over curves/group.py.

The kernel splits each lane's R rows into S segments (`reduce_segments`, a
power of two, aiming at `plan_threads(group)` threads): segment s folds
rows [s * ceil(R/S), min(R, (s + 1) * ceil(R/S))) from the identity (an
empty segment gives the identity), then the S partials combine in a fixed
pairwise tree: while S > 1, partial[s] = padd(partial[s], partial[s +
S/2]) for s < S/2, and S halves. The plain version computes the same
association, so the two agree bit for bit at a given S; segments=1 is the
serial fold. Other S give other projective coordinates of the same point,
as does the JAX XLA twin `make_ec_reduce_xla`, which starts from row 0.
The 8-limb G1 instance computes over ec_field.cuh in blocks of 256
threads; the instances of 12 or more words a coordinate
(build.WIDE_REDUCES: 12 and 24 limbs, Fp2<8>, Fp2<12>) over ec_wide.cuh in
blocks of 128, lazy in [0, 2p) up to a canonical store.

Layout: in (R, 3W, C) int32 projective Montgomery words (x / y / z rows; W
words a coordinate, L over Fp, 2L over Fp2 for G2), out (3W, C). Neither
lanes nor rows are padded. `curve` is a curve name, a `Curve` (its G1) or a
`Group` (G2: `get_group(name, g2=True)`).
"""

from __future__ import annotations

import torch

from icicle_tpu_torch.curves.group import Projective, pselect
from icicle_tpu_torch.kernels import build, msm_lib

# a block is T = 256 threads (128 in the wide instances), T / S lanes by S
# segments; at S <= 32 a warp of the 8-limb instance reads whole 32-byte
# sectors of each limb row (a wide one's, at S 32, half sectors)
MAX_SEGMENTS = 32


def reduce_segments(R: int, C: int, threads: int = msm_lib.TARGET_THREADS) -> int:
    """Segments per lane for an (R, ., C) sum: the smallest power of two S
    with S * C >= threads, at most R and MAX_SEGMENTS."""
    S = 1
    while S * C < threads and 2 * S <= min(R, MAX_SEGMENTS):
        S *= 2
    return S


def plan_threads(group) -> int:
    """The threads reduce_segments aims at for the group: TARGET_THREADS
    (2^16, two waves of the 8-limb instance's one 256-thread block an SM),
    or ONE_WAVE_THREADS (2^15) where the group's library is one of
    build.WIDE_REDUCES, whose two 128-thread blocks an SM hold 2^15 threads
    in one wave: a second wave would repeat the tree's log2 S adds after
    the rows (PERF.md: 4-13% faster on every wide cross-tile shape)."""
    g = msm_lib.as_group(group)
    wide = msm_lib.libraries("ec_reduce", g.degree).get(g.base_limbs) in build.WIDE_REDUCES
    return msm_lib.ONE_WAVE_THREADS if wide else msm_lib.TARGET_THREADS


def _check_segments(group, R: int, C: int, segments) -> int:
    S = reduce_segments(R, C, plan_threads(group)) if segments is None else segments
    if not isinstance(S, int) or S < 1 or S > MAX_SEGMENTS or S & (S - 1):
        raise msm_lib.invalid("ec_reduce", f"segments must be a power of two <= "
                              f"{MAX_SEGMENTS}, got {segments!r}")
    return S


def ec_reduce(curve, pts: torch.Tensor, *, _segments: int | None = None) -> torch.Tensor:
    """(R, 3W, C) int32 projective points -> (3W, C) per-lane sums, split
    into `reduce_segments(R, C, plan_threads(curve))` segments a lane
    (`_segments` overrides the plan, to time other splits).

    On a CUDA tensor this launches the kernel on the current stream (no
    synchronisation), counts the launch in `ec_reduce.launches` and raises
    if the launch is refused or the group has no instance. On a CPU
    tensor it computes `ec_reduce_ref`."""
    group = msm_lib.as_group(curve)
    nl = group.nlimbs
    msm_lib.check_points("ec_reduce", pts, 3 * nl)
    R, _, C = pts.shape
    S = _check_segments(group, R, C, _segments)
    if not pts.is_cuda:
        return ec_reduce_ref(group, pts, S)
    out = torch.empty((3 * nl, C), dtype=torch.int32, device=pts.device)
    msm_lib.launch("ec_reduce", group, [pts, out], [R, C, S])
    ec_reduce.launches += 1
    return out


ec_reduce.launches = 0


def ec_reduce_ref(curve, pts: torch.Tensor, segments: int | None = None) -> torch.Tensor:
    """`ec_reduce` in plain torch, with the kernel's association of adds at
    S = `segments` (None: the plan's): a Python loop over ceil(R/S) rows of
    all S * C (segment, lane) pairs, then the log2(S) levels of the tree."""
    g = msm_lib.as_group(curve)
    nl = g.nlimbs
    R, _, C = pts.shape
    S = _check_segments(g, R, C, segments)
    n = -(-R // S)
    steps = msm_lib.segment_rows(pts, S)               # (n, S, C, 3L)
    acc = g.identity((S, C), pts.device)
    for j in range(n):
        new = g.add(acc, msm_lib.split_point(steps[j], nl))
        mask = msm_lib.step_mask(j, n, R, S, pts.device)
        acc = new if mask is None else pselect(mask, new, acc)
    while S > 1:
        S //= 2
        acc = g.add(Projective(*(t[:S] for t in acc)), Projective(*(t[S:] for t in acc)))
    return torch.cat(tuple(acc), dim=-1)[0].T.contiguous()
