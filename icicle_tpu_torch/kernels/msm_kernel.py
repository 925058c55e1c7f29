"""MSM v1 bucket accumulation over a hand-written CUDA kernel (counterpart
of icicle_tpu/pallas/msm_kernel.py).

`bucket_accum` runs kernel B7 (kernels/csrc/bucket_accum.cu), which
replaces `make_bucket_accum`: per (window, lane), the inclusive segmented
fold of the lane's K slots of the window's |digit|-sorted points. Slot 0
is (x, y, 1); after that a slot restarts at (x, y, 1) where its key differs
from the previous slot's and is acc + (x, y) by the complete mixed add
(RCB15 Alg 8) where it does not. Both the kernel and its plain version
`bucket_accum_ref` promise the value only at the rows v1's bucket phase
reads (`contract_rows`): each run end (a slot whose key differs from the
next slot's) and each lane's last slot. The kernel does not write the
others; the plain version leaves them zero.

The kernel splits each lane's K slots into S segments (`accum_segments`):
  1. each segment runs the fold over its slots, restarting at its first
     slot as at every key change, and stores its run ends;
  2. carry scan: carry_{s+1} = total_s where segment s holds a reset (a
     slot whose key differs from the one before), else
     padd(carry_s, total_s);
  3. fixup: the first row a segment s >= 1 stored, where that row's run
     began in an earlier segment, becomes padd(carry_s, row).
`bucket_accum_ref` repeats this association, so the two agree bit for bit
at the same S; other S give other projective coordinates of the same
points. At segments=1 both are the serial fold of the XLA twin
`make_bucket_accum_xla` (which computes the add every slot and selects),
bit for bit at the contract's rows.

Layout: keys (W, K, C) int32, plimbs (W, K, 2L, C) int32 Montgomery
x || y (y negated where the digit is); out (W, K, 3L, C), x / y / z rows,
lane-minor. The JAX twin takes px, py (W, K, C, L) and returns vx, vy, vz
in that layout.
"""

from __future__ import annotations

import torch

from icicle_tpu_torch.curves.group import Affine, Projective, get_group, pselect
from icicle_tpu_torch.kernels import msm_lib
from icicle_tpu_torch.kernels.msm_scan import check_segments, scan_segments


def accum_segments(K: int, pairs: int) -> int:
    """Segments per lane for K slots on `pairs` = W * C (window, lane)
    pairs: B3's rule (`scan_segments`, about two waves of blocks); 8 at the
    v1 2^20 shape (K 1024, 12 x 1024), where S 8 ran 5.8 ms and one wave
    (S 4) 7.4 ms on the H100 (PERF.md)."""
    return scan_segments(K, pairs)


def contract_rows(keys: torch.Tensor) -> torch.Tensor:
    """(W, K, C) keys -> (W, K, C) bool: the rows B7 writes, each run end
    and each lane's last slot."""
    ends = torch.ones_like(keys, dtype=torch.bool)
    ends[:, :-1] = keys[:, 1:] != keys[:, :-1]
    return ends


def bucket_accum(curve, keys: torch.Tensor, plimbs: torch.Tensor, *,
                 _segments: int | None = None) -> torch.Tensor:
    """keys (W, K, C) int32 and (W, K, 2L, C) int32 points -> (W, K, 3L, C),
    defined at `contract_rows(keys)`. `_segments` overrides the plan's
    split, to time others.

    On CUDA tensors this launches the kernel's passes on the current stream
    (no synchronisation), counts one launch in `bucket_accum.launches` per
    call and raises if a launch is refused or the curve has no
    instantiation. On CPU tensors it computes `bucket_accum_ref`."""
    curve = msm_lib.as_curve(curve)
    nl = curve.fq.nlimbs
    msm_lib.check_points("bucket_accum", plimbs, 2 * nl, ndim=4)
    W, K, _, C = plimbs.shape
    msm_lib.check_aux("bucket_accum", keys, (W, K, C), plimbs)
    S = check_segments("bucket_accum", _segments, accum_segments(K, W * C))
    if not plimbs.is_cuda:
        return bucket_accum_ref(curve, keys, plimbs, S)
    dev = plimbs.device
    out = torch.empty((W, K, 3 * nl, C), dtype=torch.int32, device=dev)
    carries = torch.empty((S - 1, 3 * nl, W * C), dtype=torch.int32, device=dev)
    resets = torch.empty((S, W * C), dtype=torch.int32, device=dev)
    fix = torch.empty((S, W * C), dtype=torch.int32, device=dev)
    msm_lib.launch("bucket_accum", curve, [keys, plimbs, out, carries, resets, fix],
                   [W, K, C, S])
    bucket_accum.launches += 1
    return out


bucket_accum.launches = 0


def bucket_accum_ref(curve, keys: torch.Tensor, plimbs: torch.Tensor,
                     segments: int | None = None) -> torch.Tensor:
    """`bucket_accum` in plain torch, with the kernel's association of adds
    at S = `segments` (None: the plan's): a Python loop over ceil(K/S)
    steps of all (window, segment, lane) triples, the S - 1 carry steps,
    then the fixup. Rows outside `contract_rows(keys)` are zero; at
    segments=1 the others are the serial fold's."""
    curve = msm_lib.as_curve(curve)
    g = get_group(curve.name)
    nl = curve.fq.nlimbs
    W, K, _, C = plimbs.shape
    S = check_segments("bucket_accum", segments, accum_segments(K, W * C))
    dev = plimbs.device
    n = -(-K // S)
    pad = S * n - K

    def by_segment(t: torch.Tensor, fill) -> torch.Tensor:
        """(W, K, C, ...) -> (W, S, n, C, ...), slots past K filled."""
        t = torch.cat([t, t.new_full((W, pad) + t.shape[2:], fill)], 1)
        return t.view((W, S, n) + t.shape[2:])

    ends = contract_rows(keys)
    starts = torch.ones_like(ends)                                   # a slot that starts a run
    starts[:, 1:] = keys[:, 1:] != keys[:, :-1]
    pts = by_segment(plimbs.transpose(2, 3), 0)                      # (W, S, n, C, 2L)
    end_s, start_s = by_segment(ends, False), by_segment(starts, False)
    valid = (torch.arange(S * n, device=dev) < K).view(S, n)
    one = g.one_mont(dev).expand(W, S, C, nl)

    # pass 1: each segment's fold, restarting at its first slot
    e = g.identity((W, S, C), dev)
    out = torch.zeros((W, S, n, C, 3 * nl), dtype=torch.int32, device=dev)
    for j in range(n):
        x, y = pts[:, :, j, :, :nl], pts[:, :, j, :, nl:]
        fresh = Projective(x, y, one)
        new = fresh if j == 0 else pselect(start_s[:, :, j], fresh, g.madd(e, Affine(x, y)))
        e = pselect(valid[:, j].view(1, S, 1), new, e)
        out[:, :, j] = torch.where(end_s[:, :, j].unsqueeze(-1), msm_lib.cat_point(e), 0)
    if S > 1:
        # pass 2: the carries, restarting where a segment holds a reset
        resets = start_s.any(2)                                      # (W, S, C)
        carry = g.identity((W, C), dev)
        carries = []
        for s in range(S - 1):
            total = Projective(*(t[:, s] for t in e))
            carry = pselect(resets[:, s], total, g.add(carry, total))
            carries.append(carry)
        # pass 3: segment s's first stored row += carry_s where its run began before s
        for s in range(1, S):
            if s * n >= K:
                break
            first = end_s[:, s].to(torch.int8).argmax(1)            # (W, C)
            take = ~starts[:, s * n] & end_s[:, s].any(1)
            idx = first.view(W, 1, C, 1).expand(W, 1, C, 3 * nl)
            rows = out[:, s].gather(1, idx)                          # (W, 1, C, 3L)
            fixed = msm_lib.cat_point(g.add(carries[s - 1],
                                             msm_lib.split_point(rows[:, 0], nl)))
            out[:, s].scatter_(1, idx, torch.where(take.unsqueeze(-1), fixed,
                                                   rows[:, 0]).unsqueeze(1))
    out = out.view(W, S * n, C, 3 * nl)[:, :K]
    return out.transpose(2, 3).contiguous()
