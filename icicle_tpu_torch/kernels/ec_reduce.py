"""Lane-parallel EC point sums over a hand-written CUDA kernel (counterpart
of icicle_tpu/pallas/ec_reduce.py).

`ec_reduce` runs kernel B4 (kernels/csrc/ec_reduce.cu), which replaces
`make_ec_reduce`: per lane, the sum of the R rows by the complete projective
add (RCB15 Alg 7), starting from the identity as the Pallas kernel does.
`ec_reduce_ref` is the same function in plain torch over curves/group.py.
The JAX XLA twin `make_ec_reduce_xla` starts from row 0 instead; the two
agree as affine points, not limb for limb.

Layout: in (R, 3L, C) int32 projective Montgomery limbs (x / y / z rows),
out (3L, C). Neither lanes nor rows are padded.
"""

from __future__ import annotations

import torch

from icicle_tpu_torch.curves.group import Projective, get_group
from icicle_tpu_torch.kernels import msm_lib


def ec_reduce(curve, pts: torch.Tensor) -> torch.Tensor:
    """(R, 3L, C) int32 projective points -> (3L, C) per-lane sums.

    On a CUDA tensor this launches the kernel on the current stream (no
    synchronisation), counts the launch in `ec_reduce.launches` and raises
    if the launch is refused or the curve has no instantiation. On a CPU
    tensor it computes `ec_reduce_ref`."""
    curve = msm_lib.as_curve(curve)
    nl = curve.fq.nlimbs
    msm_lib.check_points("ec_reduce", pts, 3 * nl)
    if not pts.is_cuda:
        return ec_reduce_ref(curve, pts)
    out = torch.empty((3 * nl, pts.shape[2]), dtype=torch.int32, device=pts.device)
    msm_lib.launch("ec_reduce", curve, pts, out)
    ec_reduce.launches += 1
    return out


ec_reduce.launches = 0


def ec_reduce_ref(curve, pts: torch.Tensor) -> torch.Tensor:
    """`ec_reduce` in plain torch: a Python loop over the R rows."""
    curve = msm_lib.as_curve(curve)
    g = get_group(curve.name)
    nl = curve.fq.nlimbs
    acc = g.identity((pts.shape[2],), pts.device)
    for r in range(pts.shape[0]):
        row = pts[r].T                                  # (C, 3L) view
        acc = g.add(acc, Projective(row[:, :nl], row[:, nl:2 * nl], row[:, 2 * nl:]))
    return torch.cat(acc, dim=-1).T.contiguous()
