"""Matrix ops over fields (counterpart of icicle_tpu/ops/mat_ops.py;
reference F2: include/icicle/mat_ops.h, backend/cpu/src/field/
cpu_matrix_ops.cpp).

Surface: `matmul` of field-element matrices with the reference's three
transpose flags, and `matrix_transpose`. A matmul is the JAX package's
batched outer product: (n, m) x (m, k) broadcast to (n, m, k), one field
multiply over all of it, then a tree of field adds over the shared axis
(`_tree_sum`, the JAX order), in plain torch on the inputs' device. The
JAX package's `rq_matmul` over R_q polynomial entries waits for the rings
(ROADMAP.md queue A item 8).
"""

from __future__ import annotations

import dataclasses

import torch

from icicle_tpu_torch.fields.field import Field


@dataclasses.dataclass
class MatMulConfig:
    """Mirror of reference MatMulConfig (mat_ops.h:20-56)."""
    a_transposed: bool = False
    b_transposed: bool = False
    result_transposed: bool = False


def _tree_sum(f: Field, x: torch.Tensor, axis: int) -> torch.Tensor:
    """Field sum along `axis` by halving; an odd leftover joins the next
    level (the JAX package's order)."""
    x = x.movedim(axis, 0)
    while x.shape[0] > 1:
        half = x.shape[0] // 2
        rest = x[2 * half:]
        x = f.add(x[:half], x[half:2 * half])
        if rest.shape[0]:
            x = torch.cat([x, rest])
    return x[0]


def matmul(f: Field, a: torch.Tensor, b: torch.Tensor,
           cfg: MatMulConfig | None = None) -> torch.Tensor:
    """(n, m)+lim x (m, k)+lim -> (n, k)+lim canonical field matmul; with the
    config's flags, a or b is given transposed, or the result is returned
    transposed."""
    cfg = cfg or MatMulConfig()
    lim = f.limb_shape
    if cfg.a_transposed:
        a = a.transpose(0, 1)
    if cfg.b_transposed:
        b = b.transpose(0, 1)
    n, m = a.shape[:2]
    k = b.shape[1]
    prod = f.mul(a.unsqueeze(2).expand((n, m, k) + lim), b.unsqueeze(0).expand((n, m, k) + lim))
    out = _tree_sum(f, prod, axis=1)
    if cfg.result_transposed:
        out = out.transpose(0, 1)
    return out.contiguous()


def matrix_transpose(f: Field, a: torch.Tensor, batch_size: int = 1) -> torch.Tensor:
    """(batch?, n, m)+lim -> (batch?, m, n)+lim (reference matrix_transpose)."""
    nl = len(f.limb_shape)
    return a.transpose(-2 - nl, -1 - nl).contiguous()
