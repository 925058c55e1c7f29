"""MSM v3 prefix scan over a hand-written CUDA kernel (counterpart of
icicle_tpu/pallas/msm_scan.py).

`prefix_scan` runs kernel B3 (kernels/csrc/msm_scan.cu), which replaces
`make_prefix_scan`: per lane, the running sum E_k = E_{k-1} + P_k of the
lane's slots by the complete mixed add (RCB15 Alg 8), from the identity,
with every E_k written out. `prefix_scan_ref` is the same function in plain
torch over curves/group.py.

The kernel splits each lane's K slots into S segments (`scan_segments`):
segment s covers slots [s * ceil(K/S), min(K, (s + 1) * ceil(K/S))).
  1. reduce: each segment folds its slots from the identity (madd);
  2. carry scan: carry_0 = identity, carry_{s+1} = padd(carry_s, total_s);
  3. rescan: each segment s >= 1 re-runs its madds from carry_s and writes
     every E_k (segment 0's pass-1 values are already final).
The plain version computes the same association of adds, so the two agree
bit for bit at a given S. The split changes which projective
representative of each E_k comes out, not the point: at segments=1 both
are the serial fold, and segment 0's rows are always the serial ones.

Layout: in (K, 2L, C) int32 Montgomery limbs, x rows then (sign-applied) y
rows; out (K, 3L, C), x / y / z rows. This is the Pallas kernel's
(n_groups, K, 2L, G) with its lane groups folded into C.
"""

from __future__ import annotations

import torch

from icicle_tpu_torch.curves.group import Affine, Projective, get_group, pselect
from icicle_tpu_torch.kernels import msm_lib

MAX_SEGMENTS = 65535   # the CUDA grid's y extent: one block row per segment


def scan_segments(K: int, C: int, target: int = msm_lib.TARGET_THREADS) -> int:
    """Segments per lane for a (K, ., C) scan: the smallest power of two S
    with S * C >= `target` threads, but no more than S * S <= K, so that
    the carry scan's S - 1 serial adds stay below a segment's K / S."""
    S = 1
    while S * C < target and 4 * S * S <= K:
        S *= 2
    return S


def check_segments(kernel: str, segments, planned: int) -> int:
    """`segments`, or the plan's `planned` where it is None, as an int in
    [1, MAX_SEGMENTS] (the split scans B3, B5 and B6); raises otherwise."""
    S = planned if segments is None else segments
    if not isinstance(S, int) or not 1 <= S <= MAX_SEGMENTS:
        raise msm_lib.invalid(kernel, f"segments must be an int in [1, "
                              f"{MAX_SEGMENTS}], got {segments!r}")
    return S


def prefix_scan(curve, plimbs: torch.Tensor, *, _segments: int | None = None) -> torch.Tensor:
    """(K, 2L, C) int32 permuted Montgomery points -> (K, 3L, C) E-stream,
    split into `scan_segments(K, C)` segments a lane (`_segments` overrides
    the plan, to time other splits).

    On a CUDA tensor this launches the kernel's passes on the current stream
    (no synchronisation), counts one launch in `prefix_scan.launches` per
    call and raises if a launch is refused or the curve has no
    instantiation. On a CPU tensor it computes `prefix_scan_ref`."""
    curve = msm_lib.as_curve(curve)
    nl = curve.fq.nlimbs
    msm_lib.check_points("prefix_scan", plimbs, 2 * nl)
    K, _, C = plimbs.shape
    S = check_segments("prefix_scan", _segments, scan_segments(K, C))
    if not plimbs.is_cuda:
        return prefix_scan_ref(curve, plimbs, S)
    out = torch.empty((K, 3 * nl, C), dtype=torch.int32, device=plimbs.device)
    carries = torch.empty((S - 1, 3 * nl, C), dtype=torch.int32, device=plimbs.device)
    msm_lib.launch("prefix_scan", curve, [plimbs, out, carries], [K, C, S])
    prefix_scan.launches += 1
    return out


prefix_scan.launches = 0


def prefix_scan_ref(curve, plimbs: torch.Tensor, segments: int | None = None) -> torch.Tensor:
    """`prefix_scan` in plain torch, with the kernel's association of adds
    at S = `segments` (None: the plan's): a Python loop over ceil(K/S) steps
    of all S * C (segment, lane) pairs, the S - 1 carry adds, then the
    rescan. segments=1 is the serial fold."""
    curve = msm_lib.as_curve(curve)
    g = get_group(curve.name)
    nl = curve.fq.nlimbs
    K, _, C = plimbs.shape
    S = check_segments("prefix_scan", segments, scan_segments(K, C))
    dev = plimbs.device
    n = -(-K // S)
    steps = msm_lib.segment_rows(plimbs, S)            # (n, S, C, 2L)

    def scan(e: Projective, out: torch.Tensor | None) -> Projective:
        for j in range(n):
            new = g.madd(e, Affine(steps[j, ..., :nl], steps[j, ..., nl:]))
            mask = msm_lib.step_mask(j, n, K, S, dev)
            e = new if mask is None else pselect(mask, new, e)
            if out is not None:
                out[j] = msm_lib.cat_point(e)
        return e

    carry = g.identity((S, C), dev)
    if S > 1:
        totals = scan(carry, None)
        carries = [g.identity((C,), dev)]
        for s in range(S - 1):
            carries.append(g.add(carries[-1], Projective(*(t[s] for t in totals))))
        carry = Projective(*(torch.stack(t) for t in zip(*carries)))   # (S, C, L) each
    local = torch.empty((n, S, C, 3 * nl), dtype=torch.int32, device=dev)
    scan(carry, local)
    # (n, S, C, 3L) -> (S * n, 3L, C), cut to K
    return local.permute(1, 0, 3, 2).reshape(S * n, 3 * nl, C)[:K].contiguous()
