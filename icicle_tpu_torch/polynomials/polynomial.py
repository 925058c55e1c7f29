"""Dense univariate polynomials over the NTT and the vector ops (counterpart
of icicle_tpu/polynomials/polynomial.py).

Reference surface: include/icicle/polynomials/polynomials.h
(Polynomial<C,D,I>) with the device-agnostic algorithms of
include/icicle/polynomials/default_backend/default_poly_backend.h
(multiply via rou-evaluation domains :136-250, divide_by_vanishing
:301-470, add/sub, slicing, evaluation). The JAX package's coefficient and
rou-evaluation state machine, functional: every op returns a new
Polynomial.

Coefficients are canonical element tensors ``(n,) + limb_shape`` on one
device, padded to a power of two where an op needs it; ``size`` is the
logical length. Products and rou evaluations go through `ntt_jit`, so on
the card a transform of 2^16 or more runs the NTT kernels
(ops/ntt.py `_ntt_cuda`).
"""

from __future__ import annotations

import numpy as np
import torch

from icicle_tpu_torch.fields.field import Field
from icicle_tpu_torch.ops import ntt as N
from icicle_tpu_torch.ops import vec_ops as V
from icicle_tpu_torch.runtime.config import NTTConfig, NTTDir


def _zeros(f: Field, n: int, like: torch.Tensor) -> torch.Tensor:
    return f.zeros((n,), device=like.device)


def _pad_to(f: Field, c: torch.Tensor, n: int) -> torch.Tensor:
    """c with zero coefficients appended up to length n (unchanged if longer)."""
    return torch.cat([c, _zeros(f, n - c.shape[0], c)]) if c.shape[0] < n else c


def _pad_pow2(f: Field, coeffs: torch.Tensor, size: int | None = None) -> torch.Tensor:
    n = coeffs.shape[0] if size is None else size
    target = 1 << max(1, (n - 1)).bit_length() if n > 1 else 1
    return _pad_to(f, coeffs, target)


def _element(f: Field, value, like: torch.Tensor) -> torch.Tensor:
    """A field element tensor, or a Python int as one on `like`'s device."""
    if isinstance(value, torch.Tensor):
        return value
    return f.from_ints([int(value)], like.device)[0]


class Polynomial:
    """Immutable dense polynomial; create via from_coeffs / from_rou_evals."""

    def __init__(self, f: Field, coeffs: torch.Tensor, size: int | None = None):
        self.f = f
        self.coeffs = coeffs            # (cap,) + limb_shape, canonical form
        self.size = size if size is not None else coeffs.shape[0]

    # -- constructors (reference polynomials.h:35-44) ---------------------------
    @classmethod
    def from_coeffs(cls, f: Field, coeffs: torch.Tensor, size: int | None = None) -> "Polynomial":
        if size is not None:
            coeffs = _pad_to(f, coeffs, size)
        return cls(f, coeffs, size if size is not None else coeffs.shape[0])

    @classmethod
    def from_rou_evals(cls, f: Field, evals: torch.Tensor, size: int | None = None) -> "Polynomial":
        """Interpolate from evaluations on the 2^k roots-of-unity domain."""
        n = evals.shape[0]
        if n & (n - 1):
            raise ValueError("rou evals length must be a power of two")
        N.ntt_init_domain(f, n.bit_length() - 1, evals.device)
        coeffs = N.ntt_jit(f, evals, NTTDir.INVERSE, NTTConfig())
        return cls(f, coeffs, size if size is not None else n)

    def clone(self) -> "Polynomial":
        return Polynomial(self.f, self.coeffs, self.size)

    # -- arithmetic ---------------------------------------------------------------
    def _binary(self, other: "Polynomial", op) -> "Polynomial":
        f = self.f
        n = max(self.size, other.size)
        a = _pad_pow2(f, self.coeffs, n)
        b = _pad_pow2(f, other.coeffs, n)
        cap = max(a.shape[0], b.shape[0])
        return Polynomial(f, op(_pad_to(f, a, cap), _pad_to(f, b, cap)), n)

    def __add__(self, other: "Polynomial") -> "Polynomial":
        return self._binary(other, self.f.add)

    def __sub__(self, other: "Polynomial") -> "Polynomial":
        return self._binary(other, self.f.sub)

    def __neg__(self) -> "Polynomial":
        return Polynomial(self.f, self.f.neg(self.coeffs), self.size)

    def __mul__(self, other) -> "Polynomial":
        if isinstance(other, Polynomial):
            return self._mul_poly(other)
        return self.mul_scalar(other)

    __rmul__ = __mul__

    def mul_scalar(self, scalar) -> "Polynomial":
        f = self.f
        s = _element(f, scalar, self.coeffs)
        return Polynomial(f, V.scalar_mul_vec(f, s, self.coeffs), self.size)

    def _mul_poly(self, other: "Polynomial") -> "Polynomial":
        """Multiply via a rou-evaluation domain of size >= deg(a)+deg(b)+1
        (default_poly_backend.h multiply:136-250): two forward NTTs, a
        pointwise product, one inverse NTT."""
        f = self.f
        out_size = self.size + other.size - 1
        logn = max(1, (out_size - 1).bit_length())
        n = 1 << logn
        N.ntt_init_domain(f, logn, self.coeffs.device)
        a = _pad_to(f, self.coeffs[:self.size], n)
        b = _pad_to(f, other.coeffs[:other.size], n)
        ea = N.ntt_jit(f, a, NTTDir.FORWARD, NTTConfig())
        eb = N.ntt_jit(f, b, NTTDir.FORWARD, NTTConfig())
        coeffs = N.ntt_jit(f, f.mul(ea, eb), NTTDir.INVERSE, NTTConfig())
        return Polynomial(f, coeffs, out_size)

    def divide(self, divisor: "Polynomial") -> tuple["Polynomial", "Polynomial"]:
        """Long division: returns (quotient, remainder)."""
        f = self.f
        q, r = V.polynomial_division(f, self.coeffs[:self.size], divisor.coeffs[:divisor.size])
        return Polynomial(f, q), Polynomial(f, r)

    def __floordiv__(self, other: "Polynomial") -> "Polynomial":
        return self.divide(other)[0]

    def __mod__(self, other: "Polynomial") -> "Polynomial":
        return self.divide(other)[1]

    def divide_by_vanishing(self, degree: int) -> "Polynomial":
        """Divide by V(x) = x^degree - 1, assuming divisibility
        (default_poly_backend.h:301-470 fast path).

        Because q[i] = p[i+N] + q[i+N], quotient block j (of N coefficients)
        is the sum of the numerator's blocks above it: a suffix sum of field
        adds over the blocks, from the top (the JAX package's `lax.scan`)."""
        f = self.f
        nn = degree
        size = self.size
        if size <= nn:
            return Polynomial(f, _zeros(f, 1, self.coeffs), 1)
        nblocks = -(-size // nn)
        blocks = _pad_to(f, self.coeffs[:size], nblocks * nn).reshape(
            (nblocks, nn) + f.limb_shape)
        acc = blocks[nblocks - 1]
        q_blocks = [acc]  # q block nblocks - 2, then downwards
        for j in range(nblocks - 2, 0, -1):
            acc = f.add(blocks[j], acc)
            q_blocks.append(acc)
        q = torch.cat(q_blocks[::-1])
        out_size = max(size - nn, 1)
        return Polynomial(f, q[:out_size], out_size)

    def add_monomial_inplace(self, monomial_coeff, exponent: int) -> "Polynomial":
        """p + c*x^e (reference add_monomial_inplace); a new Polynomial."""
        f = self.f
        n = max(self.size, exponent + 1)
        c = _pad_to(f, self.coeffs, n).clone()
        c[exponent] = f.add(c[exponent], _element(f, monomial_coeff, c))
        return Polynomial(f, c, n)

    def sub_monomial_inplace(self, monomial_coeff, exponent: int) -> "Polynomial":
        f = self.f
        return self.add_monomial_inplace(f.neg(_element(f, monomial_coeff, self.coeffs)),
                                         exponent)

    # -- views (reference slice/even/odd) ----------------------------------------
    def slice(self, offset: int, stride: int, size: int | None = None) -> "Polynomial":
        c = self.coeffs[:self.size][offset::stride]
        if size is not None:
            c = c[:size]
        return Polynomial(self.f, c)

    def even(self) -> "Polynomial":
        return self.slice(0, 2)

    def odd(self) -> "Polynomial":
        return self.slice(1, 2)

    # -- evaluation -----------------------------------------------------------------
    def eval(self, x):
        """Evaluate at one or more points (Horner)."""
        f = self.f
        xs = x if isinstance(x, torch.Tensor) else f.from_ints([int(x)], self.coeffs.device)
        squeeze = tuple(xs.shape) == f.limb_shape
        if squeeze:
            xs = xs.unsqueeze(0)
        out = V.polynomial_eval(f, self.coeffs[:self.size], xs)
        return out[0] if squeeze else out

    def eval_on_domain(self, domain: torch.Tensor) -> torch.Tensor:
        return V.polynomial_eval(self.f, self.coeffs[:self.size], domain)

    def eval_on_rou_domain(self, domain_log_size: int) -> torch.Tensor:
        """Evaluate on the 2^k rou domain via forward NTT; coefficients past
        2^k fold onto the domain (x^(i+n) = x^i there)."""
        f = self.f
        n = 1 << domain_log_size
        N.ntt_init_domain(f, domain_log_size, self.coeffs.device)
        c = self.coeffs[:self.size]
        if c.shape[0] <= n:
            c = _pad_to(f, c, n)
        else:
            nb = -(-c.shape[0] // n)
            blocks = _pad_to(f, c, nb * n).reshape((nb, n) + f.limb_shape)
            c = blocks[0]
            for blk in blocks[1:]:
                c = f.add(c, blk)
        return N.ntt_jit(f, c, NTTDir.FORWARD, NTTConfig())

    # -- introspection -----------------------------------------------------------
    def degree(self) -> int:
        return int(V.highest_non_zero_idx(self.f, self.coeffs[:self.size]))

    def get_coeff(self, idx: int) -> torch.Tensor:
        return self.coeffs[idx]

    def copy_coeffs(self, start: int = 0, end: int | None = None) -> torch.Tensor:
        end = self.size if end is None else end
        return self.coeffs[start:end]

    def to_ints(self) -> np.ndarray:
        return self.f.to_ints(self.coeffs[:self.size])
