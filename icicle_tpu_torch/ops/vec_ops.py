"""Vector ops over field-element tensors (counterpart of
icicle_tpu/ops/vec_ops.py; reference F1: include/icicle/vec_ops.h).

An element tensor has shape ``batch_dims + (size,) + limb_shape``
(``limb_shape`` is ``()`` for single-word fields, ``(L,)`` otherwise); use
:func:`from_flat` / :func:`to_flat` at the reference's flat-buffer
boundary. The elementwise, scalar and reduction ops are the port's torch
field ops on their inputs' device (the JAX package leaves them to XLA's
fusion, with no Pallas kernel); `execute_program` goes through the
dispatcher's api "execute_program": backend "cuda" is kernel K4
(kernels/program_kernel.py), "torch" its plain version.
"""

from __future__ import annotations

import numpy as np
import torch

from icicle_tpu_torch.fields.field import Field
from icicle_tpu_torch.kernels import program_kernel
from icicle_tpu_torch.runtime import dispatcher
from icicle_tpu_torch.runtime.config import VecOpsConfig

_DEFAULT = VecOpsConfig()
PROGRAM_API = "execute_program"


def _vec_axis(f: Field) -> int:
    return -1 - len(f.limb_shape)


# -- elementwise --------------------------------------------------------------

def vector_add(f: Field, a, b, cfg: VecOpsConfig = _DEFAULT):
    return f.add(a, b)


def vector_sub(f: Field, a, b, cfg: VecOpsConfig = _DEFAULT):
    return f.sub(a, b)


def vector_mul(f: Field, a, b, cfg: VecOpsConfig = _DEFAULT):
    return f.mul(a, b)


def vector_div(f: Field, a, b, cfg: VecOpsConfig = _DEFAULT):
    return f.mul(a, f.inv(b))


def vector_inv(f: Field, a, cfg: VecOpsConfig = _DEFAULT):
    return f.inv(a)


def vector_accumulate(f: Field, a, b, cfg: VecOpsConfig = _DEFAULT):
    """a + b, functional (reference vector_accumulate)."""
    return f.add(a, b)


# -- scalar (x) vector ---------------------------------------------------------

def _bcast_scalar(f: Field, scalar: torch.Tensor, vec: torch.Tensor) -> torch.Tensor:
    """One element (or a (batch,)+limb batch of them) given a vector axis of
    size 1 before the limbs, to broadcast against vec."""
    s = scalar
    while s.dim() < vec.dim():
        s = s.unsqueeze(s.dim() - len(f.limb_shape))
    return s


def scalar_add_vec(f: Field, scalar, vec, cfg: VecOpsConfig = _DEFAULT):
    return f.add(_bcast_scalar(f, scalar, vec), vec)


def scalar_sub_vec(f: Field, scalar, vec, cfg: VecOpsConfig = _DEFAULT):
    """scalar - vec elementwise (reference scalar_sub_vec)."""
    return f.sub(_bcast_scalar(f, scalar, vec), vec)


def scalar_mul_vec(f: Field, scalar, vec, cfg: VecOpsConfig = _DEFAULT):
    return f.mul(_bcast_scalar(f, scalar, vec), vec)


# -- reductions ----------------------------------------------------------------

def _pow2_halving(f: Field, a: torch.Tensor, fill, op) -> torch.Tensor:
    """Reduce the vector axis by a tree of `op`, padded with `fill` up to a
    power of two (the JAX package's order)."""
    x = a.movedim(a.dim() + _vec_axis(f), 0)
    n = x.shape[0]
    size = 1 << max(n - 1, 0).bit_length()
    if size != n:
        x = torch.cat([x, fill((size - n,) + tuple(x.shape[1:]), x)])
    while x.shape[0] > 1:
        half = x.shape[0] // 2
        x = op(x[:half], x[half:])
    return x[0]


def vector_sum(f: Field, a, cfg: VecOpsConfig = _DEFAULT):
    """Field sum along the vector axis (reference vector_sum)."""
    return _pow2_halving(f, a, lambda shape, x: x.new_zeros(shape), f.add)


def vector_product(f: Field, a, cfg: VecOpsConfig = _DEFAULT):
    """Field product along the vector axis (reference vector_product)."""
    def ones(shape, x):
        return f.const(1, shape[:len(shape) - len(f.limb_shape)], device=x.device).clone()
    return _pow2_halving(f, a, ones, f.mul)


# -- structural ops --------------------------------------------------------------

def bit_reverse_indices(n: int) -> np.ndarray:
    logn = n.bit_length() - 1
    assert 1 << logn == n, "bit_reverse requires a power-of-two size"
    idx = np.arange(n, dtype=np.uint32)
    rev = np.zeros(n, dtype=np.uint32)
    for b in range(logn):
        rev |= ((idx >> b) & 1) << (logn - 1 - b)
    return rev


def bit_reverse(f: Field, a: torch.Tensor, cfg: VecOpsConfig = _DEFAULT) -> torch.Tensor:
    """Bit-reversal permutation along the vector axis (reference
    bit_reverse)."""
    axis = a.dim() + _vec_axis(f)
    perm = torch.from_numpy(bit_reverse_indices(a.shape[axis]).astype(np.int64))
    return a.index_select(axis, perm.to(a.device))


def slice_vec(f: Field, a, offset: int, stride: int, size_out: int,
              cfg: VecOpsConfig = _DEFAULT):
    """out[i] = in[offset + i * stride] (reference slice)."""
    axis = a.dim() + _vec_axis(f)
    idx = offset + stride * torch.arange(size_out, device=a.device)
    return a.index_select(axis, idx)


def highest_non_zero_idx(f: Field, a, cfg: VecOpsConfig = _DEFAULT):
    """Index of the highest non-zero element along the vector axis, -1 if
    all are zero (reference highest_non_zero_idx); an int32 tensor."""
    axis = a.dim() + _vec_axis(f)
    nz = ~f.is_zero(a)
    n = a.shape[axis]
    shape = [1] * nz.dim()
    shape[axis] = n
    pos = torch.arange(n, dtype=torch.int32, device=a.device).view(shape)
    return torch.where(nz, pos, torch.full_like(pos, -1)).amax(dim=axis)


# -- polynomial helpers ------------------------------------------------------

def polynomial_eval(f: Field, coeffs, domain, cfg: VecOpsConfig = _DEFAULT):
    """Evaluate coefficient vector(s) on a domain (reference polynomial_eval)
    by Horner's rule over the coefficient axis; the result is batch... x
    domain."""
    lim = f.limb_shape
    cs = coeffs.movedim(coeffs.dim() + _vec_axis(f), 0)   # (ncoeff, batch..., limbs)
    dn = domain.shape[domain.dim() + _vec_axis(f)]
    batch_shape = tuple(cs.shape[1:cs.dim() - len(lim)])
    acc = f.zeros(batch_shape + (dn,), device=coeffs.device)
    for c in cs.flip(0):
        acc = f.add(f.mul(acc, domain), c.unsqueeze(len(batch_shape)))
    return acc


def polynomial_division(f: Field, numerator, denominator):
    """Dense long division: (quotient, remainder) (reference
    polynomial_division, cpu_vec_ops.cpp). Degrees come from the sizes;
    the denominator's last element must be its leading coefficient."""
    ax_n = numerator.dim() + _vec_axis(f)
    n = numerator.shape[ax_n]
    d = denominator.shape[denominator.dim() + _vec_axis(f)]
    if d > n:
        return f.zeros((1,), device=numerator.device), numerator
    qlen = n - d + 1
    dlead_inv = f.inv(denominator.select(denominator.dim() + _vec_axis(f), d - 1))
    rem = numerator.clone()
    quot = f.zeros(tuple(numerator.shape[:ax_n]) + (qlen,), device=numerator.device)
    for i in range(qlen):
        k = qlen - 1 - i  # the quotient power
        q = f.mul(rem.select(ax_n, k + d - 1), dlead_inv)
        quot.select(ax_n, k).copy_(q)
        seg = rem.narrow(ax_n, k, d)
        seg.copy_(f.sub(seg, f.mul(q.unsqueeze(q.dim() - len(f.limb_shape)), denominator)))
    return quot, rem.narrow(ax_n, 0, max(d - 1, 1))


# -- the reference's flat layout ------------------------------------------------

def from_flat(f: Field, flat, size: int, batch_size: int = 1, columns_batch: bool = False):
    """Flat buffer -> (batch, size) element tensor; columns_batch: element i
    of vector j sits at flat[i * batch + j] (vec_ops.h:33-35)."""
    if columns_batch:
        return flat.reshape((size, batch_size) + f.limb_shape).movedim(1, 0)
    return flat.reshape((batch_size, size) + f.limb_shape)


def to_flat(f: Field, arr, columns_batch: bool = False):
    if columns_batch:
        arr = arr.movedim(0, 1)
    return arr.reshape((-1,) + f.limb_shape)


# -- program execution (reference execute_program, cpu_vec_ops.cpp:678) -----------

def execute_program(f: Field, program, data: list, cfg: VecOpsConfig = _DEFAULT):
    """Run a Program over `program.nof_parameters` equal-size vectors.
    Returns the list with the outputs in place of the LAST len(outputs)
    parameters, whatever slots the lambda assigned: the JAX package's
    mapping (icicle_tpu/ops/vec_ops.py:266-271), kept so that both packages
    compute the same function (ROADMAP.md §C).

    On CUDA vectors of a single-word field this is kernel K4; on CPU
    vectors its plain version."""
    data = list(data)
    outputs = dispatcher.dispatch(PROGRAM_API, cfg.backend, data[0])(f, program, data)
    out = data[:]
    n_out = len(outputs)
    for i, val in enumerate(outputs):
        out[program.nof_parameters - n_out + i] = val
    return out


dispatcher.register_impl(PROGRAM_API, dispatcher.TORCH, program_kernel.execute_program_ref)
dispatcher.register_impl(PROGRAM_API, dispatcher.CUDA, program_kernel.execute_program_kernel)
