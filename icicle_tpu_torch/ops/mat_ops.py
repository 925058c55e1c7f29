"""Matrix ops over fields (counterpart of icicle_tpu/ops/mat_ops.py;
reference F2: include/icicle/mat_ops.h, backend/cpu/src/field/
cpu_matrix_ops.cpp).

Surface: `matmul` of field-element matrices with the reference's three
transpose flags, and `matrix_transpose`. A matmul is the JAX package's
batched outer product: (n, m) x (m, k) broadcast to (n, m, k), one field
multiply over all of it, then a tree of field adds over the shared axis
(`_tree_sum`, the JAX order), in plain torch on the inputs' device.
`rq_matmul` multiplies matrices of R_q polynomials (rings/rq.py) in the
negacyclic NTT's evaluation domain.
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


# -- R_q (polynomial ring) matmul (reference: matmul for PolyRing entries) ----------

# rows of `a` a pointwise product covers at a time, so that the (rows, m, k,
# 64, 2) product and the engine's column buffers stay within a few GiB
_RQ_PRODUCT_ELEMENTS = 1 << 23


def rq_matmul(a: torch.Tensor, b: torch.Tensor, cfg=None) -> torch.Tensor:
    """(n, m, 64, 2) x (m, k, 64, 2) R_q matrices -> (n, k, 64, 2).

    In the evaluation domain, as the JAX package's: the negacyclic NTT of
    both operands once (`rings/rq.py:negacyclic_ntt`, its kernel on a CUDA
    tensor; `cfg` a NegacyclicNTTConfig), a pointwise multiply of every
    (i, j, l) triple summed over j in `_tree_sum`'s order (plain torch Z_q
    ops, a block of rows of `a` at a time), and the inverse NTT."""
    from icicle_tpu_torch.rings.babykoala import get_zq
    from icicle_tpu_torch.rings.rq import negacyclic_ntt
    from icicle_tpu_torch.runtime.config import NTTDir
    zq = get_zq()
    ea = negacyclic_ntt(a, NTTDir.FORWARD, cfg)      # (n, m, 64, 2)
    eb = negacyclic_ntt(b, NTTDir.FORWARD, cfg)      # (m, k, 64, 2)
    n, m = ea.shape[:2]
    k = eb.shape[1]
    tail = ea.shape[2:]
    rows = max(1, _RQ_PRODUCT_ELEMENTS // max(1, m * k * tail.numel()))
    out = []
    for i in range(0, n, rows):
        blk = ea[i:i + rows]
        prod = zq.mul(blk.unsqueeze(2).expand((blk.shape[0], m, k) + tail),
                      eb.unsqueeze(0).expand((blk.shape[0], m, k) + tail))
        out.append(_tree_sum(zq, prod, axis=1))
    return negacyclic_ntt(torch.cat(out).contiguous(), NTTDir.INVERSE, cfg)
