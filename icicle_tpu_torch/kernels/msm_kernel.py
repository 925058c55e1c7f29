"""MSM v1 bucket accumulation over a hand-written CUDA kernel (counterpart
of icicle_tpu/pallas/msm_kernel.py).

`bucket_accum` runs kernel B7 (kernels/csrc/bucket_accum.cu), which
replaces `make_bucket_accum`: per (window, lane), the inclusive segmented
fold of the lane's K slots of the window's |digit|-sorted points. Slot 0
is (x, y, 1); after that a slot restarts at (x, y, 1) where its key differs
from the previous slot's and is acc + (x, y) by the complete mixed add
(RCB15 Alg 8) where it does not; every slot's value is written.
`bucket_accum_ref` is the same function in plain torch over
curves/group.py, computing the add every slot and selecting, as the XLA
twin `make_bucket_accum_xla` does; the kernel branches per lane instead,
and keeps the same limbs.

Layout: keys (W, K, C) int32, plimbs (W, K, 2L, C) int32 Montgomery
x || y (y negated where the digit is); out (W, K, 3L, C), x / y / z rows,
lane-minor. The JAX twin takes px, py (W, K, C, L) and returns vx, vy, vz
in that layout.
"""

from __future__ import annotations

import torch

from icicle_tpu_torch.curves.group import Affine, Projective, get_group, pselect
from icicle_tpu_torch.kernels import msm_lib


def bucket_accum(curve, keys: torch.Tensor, plimbs: torch.Tensor) -> torch.Tensor:
    """keys (W, K, C) int32 and (W, K, 2L, C) int32 points -> (W, K, 3L, C).

    On CUDA tensors this launches the kernel on the current stream (no
    synchronisation), counts the launch in `bucket_accum.launches` and
    raises if the launch is refused or the curve has no instantiation. On
    CPU tensors it computes `bucket_accum_ref`."""
    curve = msm_lib.as_curve(curve)
    nl = curve.fq.nlimbs
    msm_lib.check_points("bucket_accum", plimbs, 2 * nl, ndim=4)
    W, K, _, C = plimbs.shape
    msm_lib.check_aux("bucket_accum", keys, (W, K, C), plimbs)
    if not plimbs.is_cuda:
        return bucket_accum_ref(curve, keys, plimbs)
    out = torch.empty((W, K, 3 * nl, C), dtype=torch.int32, device=plimbs.device)
    msm_lib.launch("bucket_accum", curve, [keys, plimbs, out], [W, K, C])
    bucket_accum.launches += 1
    return out


bucket_accum.launches = 0


def bucket_accum_ref(curve, keys: torch.Tensor, plimbs: torch.Tensor) -> torch.Tensor:
    """`bucket_accum` in plain torch: a Python loop over the K slots, the W
    windows and C lanes batched."""
    curve = msm_lib.as_curve(curve)
    g = get_group(curve.name)
    nl = curve.fq.nlimbs
    W, K, _, C = plimbs.shape
    rows = plimbs.transpose(2, 3)                       # (W, K, C, 2L) view
    one = g.one_mont(plimbs.device).expand(W, C, nl)
    out = torch.empty((W, K, 3 * nl, C), dtype=torch.int32, device=plimbs.device)
    acc = None
    for k in range(K):
        pt = Projective(rows[:, k, :, :nl], rows[:, k, :, nl:], one)
        if k > 0:
            comb = g.madd(acc, Affine(pt.x, pt.y))
            pt = pselect(keys[:, k] != keys[:, k - 1], pt, comb)
        acc = pt
        out[:, k] = torch.cat(acc, dim=-1).transpose(1, 2)
    return out
