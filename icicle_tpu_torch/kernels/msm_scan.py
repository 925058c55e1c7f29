"""MSM v3 prefix scan over a hand-written CUDA kernel (counterpart of
icicle_tpu/pallas/msm_scan.py).

`prefix_scan` runs kernel B3 (kernels/csrc/msm_scan.cu), which replaces
`make_prefix_scan`: per lane, the running sum E_k = E_{k-1} + P_k of the
lane's slots by the complete mixed add (RCB15 Alg 8), from the identity,
with every E_k written out. `prefix_scan_ref` is the same function in plain
torch over curves/group.py.

Layout: in (K, 2L, C) int32 Montgomery limbs, x rows then (sign-applied) y
rows; out (K, 3L, C), x / y / z rows. This is the Pallas kernel's
(n_groups, K, 2L, G) with its lane groups folded into C.
"""

from __future__ import annotations

import torch

from icicle_tpu_torch.curves.group import Affine, get_group
from icicle_tpu_torch.kernels import msm_lib


def prefix_scan(curve, plimbs: torch.Tensor) -> torch.Tensor:
    """(K, 2L, C) int32 permuted Montgomery points -> (K, 3L, C) E-stream.

    On a CUDA tensor this launches the kernel on the current stream (no
    synchronisation), counts the launch in `prefix_scan.launches` and raises
    if the launch is refused or the curve has no instantiation. On a CPU
    tensor it computes `prefix_scan_ref`."""
    curve = msm_lib.as_curve(curve)
    nl = curve.fq.nlimbs
    msm_lib.check_points("prefix_scan", plimbs, 2 * nl)
    if not plimbs.is_cuda:
        return prefix_scan_ref(curve, plimbs)
    K, _, C = plimbs.shape
    out = torch.empty((K, 3 * nl, C), dtype=torch.int32, device=plimbs.device)
    msm_lib.launch("prefix_scan", curve, [plimbs, out], [K, C])
    prefix_scan.launches += 1
    return out


prefix_scan.launches = 0


def prefix_scan_ref(curve, plimbs: torch.Tensor) -> torch.Tensor:
    """`prefix_scan` in plain torch: a Python loop over the K slots."""
    curve = msm_lib.as_curve(curve)
    g = get_group(curve.name)
    nl = curve.fq.nlimbs
    K, _, C = plimbs.shape
    rows = plimbs.transpose(1, 2)                       # (K, C, 2L) view
    e = g.identity((C,), plimbs.device)
    out = torch.empty((K, 3 * nl, C), dtype=torch.int32, device=plimbs.device)
    for k in range(K):
        e = g.madd(e, Affine(rows[k, :, :nl], rows[k, :, nl:]))
        out[k] = torch.cat(e, dim=-1).T
    return out
