"""MSM v2 suffix fold over a hand-written CUDA kernel (counterpart of
icicle_tpu/pallas/msm_fold2.py).

`suffix_fold` runs kernel B6 (kernels/csrc/msm_fold2.cu), which replaces
`make_suffix_fold`. Per lane (one tile of one window, its slots sorted by
|digit| descending with one dummy slot for every key), two accumulators
from the identity: E += P where the slot is real (flag bit 0), then
D += E where it ends a key's run (bit 1). On such a stream the run-end
values of E are the bucket prefixes S_j, so D ends as sum_j S_j =
sum_k k B_k, the tile's weighted window sum. `suffix_fold_ref` is the same
function in plain torch over curves/group.py, computing both adds every
slot and selecting, as the Pallas body and its XLA twin do; the kernel
branches per lane instead, and keeps the same limbs.

Layout: plimbs (K, 2L, C) int32 Montgomery x || y, flags (K, C) int32;
out (3L, C), x / y / z rows. The Pallas kernel takes the points as bf16
bytes (its matrix-unit permute's output) with the flags in an extra row
and negates y where flag bit 2 is set; here the limbs come from a gather
over the prepared +-P table, which applies the sign, so the flag word
carries bits 0 and 1 only.
"""

from __future__ import annotations

import torch

from icicle_tpu_torch.curves.group import Affine, get_group, pselect
from icicle_tpu_torch.kernels import msm_lib

IS_REAL = 1
IS_DACC = 2


def suffix_fold(curve, plimbs: torch.Tensor, flags: torch.Tensor) -> torch.Tensor:
    """(K, 2L, C) int32 points and (K, C) int32 flags -> (3L, C) D per lane.

    On CUDA tensors this launches the kernel on the current stream (no
    synchronisation), counts the launch in `suffix_fold.launches` and raises
    if the launch is refused or the curve has no instantiation. On CPU
    tensors it computes `suffix_fold_ref`."""
    curve = msm_lib.as_curve(curve)
    nl = curve.fq.nlimbs
    msm_lib.check_points("suffix_fold", plimbs, 2 * nl)
    K, _, C = plimbs.shape
    msm_lib.check_aux("suffix_fold", flags, (K, C), plimbs)
    if not plimbs.is_cuda:
        return suffix_fold_ref(curve, plimbs, flags)
    out = torch.empty((3 * nl, C), dtype=torch.int32, device=plimbs.device)
    msm_lib.launch("suffix_fold", curve, [plimbs, flags, out], [K, C])
    suffix_fold.launches += 1
    return out


suffix_fold.launches = 0


def suffix_fold_ref(curve, plimbs: torch.Tensor, flags: torch.Tensor) -> torch.Tensor:
    """`suffix_fold` in plain torch: a Python loop over the K slots."""
    curve = msm_lib.as_curve(curve)
    g = get_group(curve.name)
    nl = curve.fq.nlimbs
    K, _, C = plimbs.shape
    rows = plimbs.transpose(1, 2)                       # (K, C, 2L) view
    e = g.identity((C,), plimbs.device)
    d = g.identity((C,), plimbs.device)
    for k in range(K):
        e = pselect((flags[k] & IS_REAL) != 0, g.madd(e, Affine(rows[k, :, :nl], rows[k, :, nl:])), e)
        d = pselect((flags[k] & IS_DACC) != 0, g.add(d, e), d)
    return torch.cat(d, dim=-1).T.contiguous()
