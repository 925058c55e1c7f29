"""Elliptic-curve group ops on limb tensors (counterpart of
icicle_tpu/curves/group.py).

Points are tuples of `(..., L)` int32 limb tensors in **Montgomery form**, and
all formulas are the *complete* homogeneous-projective formulas for `a = 0`
short-Weierstrass curves (Renes-Costello-Batina 2015, Algs 7-9), written
line for line as the JAX package writes them, so the projective limbs of
every result equal the JAX package's bit for bit. Complete formulas handle
identity, doubling and negation uniformly: no data-dependent branches.

The identity is `(0, 1, 0)`. G1 only: G2 waits for the extension towers
(ROADMAP.md queue A item 7).
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


def padd(f, p: Projective, q: Projective, b3_mont) -> Projective:
    """Complete projective add (RCB15 Alg 7, a=0): 12 mul + 2 b3-mults."""
    m, add, sub = f.mul_mont, f.add, f.sub
    x1, y1, z1 = p
    x2, y2, z2 = q
    t0 = m(x1, x2)
    t1 = m(y1, y2)
    t2 = m(z1, z2)
    t3 = sub(m(add(x1, y1), add(x2, y2)), add(t0, t1))   # x1y2 + x2y1
    t4 = sub(m(add(y1, z1), add(y2, z2)), add(t1, t2))   # y1z2 + y2z1
    y3 = sub(m(add(x1, z1), add(x2, z2)), add(t0, t2))   # x1z2 + x2z1
    t0 = add(add(t0, t0), t0)                            # 3 x1x2
    t2 = m(b3_mont, t2)                                  # 3b z1z2
    z3 = add(t1, t2)
    t1 = sub(t1, t2)
    y3 = m(b3_mont, y3)                                  # 3b (x1z2 + x2z1)
    x3 = sub(m(t3, t1), m(t4, y3))
    y3 = add(m(t1, z3), m(y3, t0))
    z3 = add(m(z3, t4), m(t0, t3))
    return Projective(x3, y3, z3)


def pmadd(f, p: Projective, q: Affine, b3_mont) -> Projective:
    """Complete mixed add (RCB15 Alg 8, a=0), q affine with Z=1 implicit.

    q must be a genuine curve point (affine cannot encode the identity)."""
    m, add, sub = f.mul_mont, f.add, f.sub
    x1, y1, z1 = p
    x2, y2 = q
    t0 = m(x1, x2)
    t1 = m(y1, y2)
    t3 = sub(m(add(x1, y1), add(x2, y2)), add(t0, t1))   # x1y2 + x2y1
    t4 = add(m(y2, z1), y1)                              # y1 + y2z1
    y3 = add(m(x2, z1), x1)                              # x1 + x2z1
    t0 = add(add(t0, t0), t0)                            # 3 x1x2
    t2 = m(b3_mont, z1)                                  # 3b z1
    z3 = add(t1, t2)
    t1 = sub(t1, t2)
    y3 = m(b3_mont, y3)
    x3 = sub(m(t3, t1), m(t4, y3))
    y3 = add(m(t1, z3), m(y3, t0))
    z3 = add(m(z3, t4), m(t0, t3))
    return Projective(x3, y3, z3)


def pdbl(f, p: Projective, b3_mont) -> Projective:
    """Complete doubling (RCB15 Alg 9, a=0): 6 mul + 2 sqr class."""
    m, add, sub = f.mul_mont, f.add, f.sub
    x, y, z = p
    t0 = m(y, y)
    z3 = add(t0, t0)
    z3 = add(z3, z3)
    z3 = add(z3, z3)                # 8 y^2
    t1 = m(y, z)
    t2 = m(b3_mont, m(z, z))        # 3b z^2
    x3 = m(t2, z3)
    y3 = add(t0, t2)
    z3 = m(t1, z3)
    t1 = add(t2, t2)
    t2 = add(t1, t2)                # 9b z^2
    t0 = sub(t0, t2)                # y^2 - 9b z^2
    y3 = add(m(t0, y3), x3)
    x3 = m(t0, m(x, y))
    x3 = add(x3, x3)
    return Projective(x3, y3, z3)


def pneg(f, p: Projective) -> Projective:
    return Projective(p.x, f.neg(p.y), p.z)


def pselect(cond, p: Projective, q: Projective) -> Projective:
    """Lane select: cond ? p : q. cond broadcastable against batch shape."""
    c = cond.unsqueeze(-1)
    return Projective(*(torch.where(c, a, b) for a, b in zip(p, q)))


class Group:
    """G1 point ops bound to a curve's base-field engine. Point tensors hold
    Montgomery-form coordinates; `from_affine_canonical` /
    `to_affine_canonical` convert at the API boundary."""

    def __init__(self, curve: Curve):
        self.curve = curve
        self.coord_field = curve.fq
        self.f = curve.fq.engine
        self.nlimbs = curve.fq.nlimbs
        fp = curve.fq.params
        self.b3_int = fp.to_mont_int(curve.b3)
        self.one_int = fp.to_mont_int(1)
        self.gen_int = (fp.to_mont_int(curve.gen_x), fp.to_mont_int(curve.gen_y))
        self._consts: dict = {}

    def _const(self, value_mont: int, device) -> torch.Tensor:
        """A Montgomery-form constant as (L,) int32 limbs on `device`."""
        key = (value_mont, device)
        if key not in self._consts:
            self._consts[key] = self.f.const(value_mont, device=device)
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
        (curves/glv.py) as (L,) limbs on `device`."""
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
        One Fermat inversion per point."""
        fq = self.coord_field
        zinv_m = fq.to_mont(fq.inv(fq.from_mont(p.z)))  # 0 -> 0
        x = fq.from_mont(self.f.mul_mont(p.x, zinv_m))
        y = fq.from_mont(self.f.mul_mont(p.y, zinv_m))
        return x, y


_GROUPS: dict[str, Group] = {}


def get_group(curve_name: str, g2: bool = False) -> Group:
    if g2:
        raise NotImplementedError(
            "G2 is not ported yet: it needs the extension-field towers "
            "(ROADMAP.md queue A item 7)")
    if curve_name not in _GROUPS:
        _GROUPS[curve_name] = Group(get_curve(curve_name))
    return _GROUPS[curve_name]
