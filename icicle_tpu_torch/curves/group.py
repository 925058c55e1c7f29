"""Elliptic-curve group ops on limb tensors (counterpart of
icicle_tpu/curves/group.py).

Points are tuples of `(..., W)` int32 coordinate tensors in **Montgomery
form**, and all formulas are the *complete* homogeneous-projective formulas
for `a = 0` short-Weierstrass curves (Renes-Costello-Batina 2015, Algs 7-9).
Complete formulas handle identity, doubling and negation uniformly: no
data-dependent branches. G1 takes the base field (W = L limbs); G2 takes its
quadratic extension (fields/extension.py, W = 2L: c0's limbs, then c1's), or
the base field itself for bw6_761, whose G2 is a curve over Fq.

The formulas compute the JAX package's values, each op canonical, so the
projective coordinates of every result equal the JAX package's bit for bit.
Their multiplies are batched: the independent ones of a formula go to the
field engine as one multiply over stacked operands (RCB15 Alg 8: 13
multiplies in 3 calls; Alg 7: 14 in 3; Alg 9: 9 in 3), and so are its
independent adds. The engines are eager torch ops, dozens a multiply (a
BigField multiply is about 200), so the plain versions of the MSM kernels,
which loop over these formulas, issue a few times fewer torch calls.

The identity is `(0, 1, 0)`.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from icicle_tpu_torch.curves.params import Curve, get_curve
from icicle_tpu_torch.runtime.device import resolve


class Projective(NamedTuple):
    """Homogeneous projective point; coords in Montgomery form."""
    x: Any
    y: Any
    z: Any


class Affine(NamedTuple):
    """Affine point; coordinate form depends on context (see callers)."""
    x: Any
    y: Any


def _stacked(op, pairs):
    """op over the (a, b) pairs as one call on stacked, broadcast operands;
    the results in order."""
    if len(pairs) == 1:
        return (op(*pairs[0]),)
    shape = torch.broadcast_shapes(*(t.shape for pair in pairs for t in pair))
    a = torch.stack([p[0].expand(shape) for p in pairs])
    b = torch.stack([p[1].expand(shape) for p in pairs])
    return op(a, b).unbind(0)


def padd(f, p: Projective, q: Projective, b3_mont) -> Projective:
    """Complete projective add (RCB15 Alg 7, a=0): 12 mul + 2 b3-mults."""
    m, add, sub = f.mul_mont, f.add, f.sub
    x1, y1, z1 = p
    x2, y2, z2 = q
    s = _stacked(add, [(x1, y1), (x2, y2), (y1, z1), (y2, z2), (x1, z1), (x2, z2)])
    t0, t1, t2, u3, u4, uy = _stacked(m, [(x1, x2), (y1, y2), (z1, z2), (s[0], s[1]),
                                          (s[2], s[3]), (s[4], s[5])])
    a01, a12, a02, tt = _stacked(add, [(t0, t1), (t1, t2), (t0, t2), (t0, t0)])
    t3, t4, y3 = _stacked(sub, [(u3, a01), (u4, a12), (uy, a02)])  # x1y2 + x2y1, ...
    t0 = add(tt, t0)                                              # 3 x1x2
    t2, y3 = _stacked(m, [(b3_mont, t2), (b3_mont, y3)])          # 3b z1z2, 3b (x1z2 + x2z1)
    return _finish(f, t0, t1, t2, t3, t4, y3)


def _finish(f, t0, t1, t2, t3, t4, y3) -> Projective:
    """RCB15 Algs 7 and 8 from z3 = t1 + t2, t1 = t1 - t2 on."""
    z3 = f.add(t1, t2)
    t1 = f.sub(t1, t2)
    m1, m2, m3, m4, m5, m6 = _stacked(f.mul_mont, [(t3, t1), (t4, y3), (t1, z3), (y3, t0),
                                                   (z3, t4), (t0, t3)])
    x3 = f.sub(m1, m2)
    y3, z3 = _stacked(f.add, [(m3, m4), (m5, m6)])
    return Projective(x3, y3, z3)


def pmadd(f, p: Projective, q: Affine, b3_mont) -> Projective:
    """Complete mixed add (RCB15 Alg 8, a=0), q affine with Z=1 implicit.

    q must be a genuine curve point (affine cannot encode the identity)."""
    m, add, sub = f.mul_mont, f.add, f.sub
    x1, y1, z1 = p
    x2, y2 = q
    s1, s2 = _stacked(add, [(x1, y1), (x2, y2)])
    t0, t1, u3, yz, xz, t2 = _stacked(m, [(x1, x2), (y1, y2), (s1, s2), (y2, z1), (x2, z1),
                                          (b3_mont, z1)])          # t2 = 3b z1
    a01, t4, y3, tt = _stacked(add, [(t0, t1), (yz, y1), (xz, x1), (t0, t0)])
    t3 = sub(u3, a01)                                             # x1y2 + x2y1
    t0 = add(tt, t0)                                              # 3 x1x2
    y3 = m(b3_mont, y3)
    return _finish(f, t0, t1, t2, t3, t4, y3)


def pdbl(f, p: Projective, b3_mont) -> Projective:
    """Complete doubling (RCB15 Alg 9, a=0): 6 mul + 2 sqr class."""
    m, add, sub = f.mul_mont, f.add, f.sub
    x, y, z = p
    t0, t1, zz, xy = _stacked(m, [(y, y), (y, z), (z, z), (x, y)])
    z3 = add(t0, t0)
    z3 = add(z3, z3)
    z3 = add(z3, z3)                # 8 y^2
    t2 = m(b3_mont, zz)             # 3b z^2
    y3, t1b = _stacked(add, [(t0, t2), (t2, t2)])
    t2b = add(t1b, t2)              # 9b z^2
    t0 = sub(t0, t2b)               # y^2 - 9b z^2
    x3, z3, ty, x3b = _stacked(m, [(t2, z3), (t1, z3), (t0, y3), (t0, xy)])
    y3, x3 = _stacked(add, [(ty, x3), (x3b, x3b)])
    return Projective(x3, y3, z3)


def pneg(f, p: Projective) -> Projective:
    return Projective(p.x, f.neg(p.y), p.z)


def pselect(cond, p: Projective, q: Projective) -> Projective:
    """Lane select: cond ? p : q. cond broadcastable against batch shape."""
    c = cond.unsqueeze(-1)
    return Projective(*(torch.where(c, a, b) for a, b in zip(p, q)))


class Group:
    """Point ops bound to a curve's coordinate field: the base field for G1;
    for G2 (g2=True) its quadratic extension, or the base field itself for
    bw6_761, whose G2 is defined over Fq (curves/params/bw6_761.h). Point
    tensors hold Montgomery-form coordinates; `from_affine_canonical` /
    `to_affine_canonical` convert at the API boundary.

    Constants are kept as Montgomery-form Python ints: an int for a prime
    coordinate field, a (c0, c1) pair for Fp2 (`b3_int`, `one_int`,
    `gen_int`)."""

    def __init__(self, curve: Curve, g2: bool = False):
        self.curve = curve
        self.g2 = g2
        fq = curve.fq
        to_mont = fq.params.to_mont_int
        p = curve.params
        self.degree = 1
        if not g2:
            self.coord_field = fq
            gen, b3 = (curve.gen_x, curve.gen_y), curve.b3
        elif p.g2_b is None:
            raise ValueError(f"curve {curve.name} has no G2")
        elif p.g2_field == "fq":
            self.coord_field = fq
            gen, b3 = (p.g2_gen_x[0], p.g2_gen_y[0]), (3 * p.g2_b[0]) % fq.modulus
        else:
            from icicle_tpu_torch.fields.extension import get_ext_field
            self.coord_field = get_ext_field(p.base_field)
            self.degree = 2
            gen = (p.g2_gen_x, p.g2_gen_y)
            b3 = tuple((3 * v) % fq.modulus for v in p.g2_b)

        def mont(v):
            return tuple(to_mont(c) for c in v) if self.degree == 2 else to_mont(v)

        self.f = self.coord_field.engine
        self.nlimbs = self.coord_field.nlimbs       # words of a coordinate
        self.base_limbs = fq.nlimbs
        self.b3 = b3                                # canonical: an int, or (c0, c1)
        self.b3_int = mont(b3)
        self.one_int = mont((1, 0) if self.degree == 2 else 1)
        self.gen_int = (mont(gen[0]), mont(gen[1]))
        self._consts: dict = {}

    def _const(self, value_mont, device) -> torch.Tensor:
        """A Montgomery-form constant (an int, or a (c0, c1) pair over Fp2)
        as (W,) int32 words on `device`."""
        key = (value_mont, device)
        if key not in self._consts:
            base = self.curve.fq.engine
            parts = value_mont if self.degree == 2 else (value_mont,)
            self._consts[key] = torch.cat([base.const(v, device=device) for v in parts])
        return self._consts[key]

    def b3_mont(self, device) -> torch.Tensor:
        return self._const(self.b3_int, device)

    def one_mont(self, device) -> torch.Tensor:
        return self._const(self.one_int, device)

    # -- constructors ---------------------------------------------------------
    def identity(self, batch_shape=(), device=None) -> Projective:
        dev = resolve(device)
        shape = tuple(batch_shape) + (self.nlimbs,)
        z = torch.zeros(shape, dtype=torch.int32, device=dev)
        return Projective(z, self.one_mont(dev).expand(shape).clone(), z.clone())

    def generator(self, batch_shape=(), device=None) -> Projective:
        dev = resolve(device)
        shape = tuple(batch_shape) + (self.nlimbs,)
        x, y = (self._const(v, dev).expand(shape).clone() for v in self.gen_int)
        return Projective(x, y, self.one_mont(dev).expand(shape).clone())

    # -- core ops (Montgomery form) -------------------------------------------
    def add(self, p: Projective, q: Projective) -> Projective:
        return padd(self.f, p, q, self.b3_mont(p.x.device))

    def madd(self, p: Projective, q: Affine) -> Projective:
        return pmadd(self.f, p, q, self.b3_mont(p.x.device))

    def dbl(self, p: Projective) -> Projective:
        return pdbl(self.f, p, self.b3_mont(p.x.device))

    def neg(self, p: Projective) -> Projective:
        return pneg(self.f, p)

    def glv_beta_mont(self, device) -> torch.Tensor:
        """Montgomery-form beta of the GLV endomorphism (x, y) -> (beta x, y)
        (curves/glv.py; G1 only) as (L,) limbs on `device`."""
        if self.g2:
            raise ValueError("GLV beta is defined for G1 groups only")
        from icicle_tpu_torch.curves.glv import glv_constants
        beta, _ = glv_constants(self.curve.name)
        return self._const(self.coord_field.params.to_mont_int(beta), device)

    def is_identity(self, p: Projective):
        return self.f.is_zero(p.z)

    # -- boundary conversions ---------------------------------------------------
    def from_affine_canonical(self, x, y) -> Projective:
        """Canonical-form affine coordinate tensors -> Montgomery projective;
        (0, 0) is the identity (the reference's Affine zero convention)."""
        fq = self.coord_field
        xm, ym = fq.to_mont(x), fq.to_mont(y)
        is_inf = self.f.is_zero(x) & self.f.is_zero(y)
        ident = self.identity(x.shape[:-1], x.device)
        pt = Projective(xm, ym, self.one_mont(x.device).expand(x.shape))
        return pselect(is_inf, ident, pt)

    def to_affine_canonical(self, p: Projective):
        """Montgomery projective -> canonical affine (x, y); identity -> (0, 0).
        One inversion per point (Fermat; over Fp2 through the norm)."""
        fq = self.coord_field
        zinv_m = fq.to_mont(fq.inv(fq.from_mont(p.z)))  # 0 -> 0
        x, y = _stacked(self.f.mul_mont, [(p.x, zinv_m), (p.y, zinv_m)])
        return fq.from_mont(x), fq.from_mont(y)


_GROUPS: dict[tuple[str, bool], Group] = {}


def get_group(curve_name: str, g2: bool = False) -> Group:
    """The group of `curve_name`, G2 where g2 (cached by (name, g2))."""
    key = (curve_name, bool(g2))
    if key not in _GROUPS:
        _GROUPS[key] = Group(get_curve(curve_name), g2=bool(g2))
    return _GROUPS[key]
