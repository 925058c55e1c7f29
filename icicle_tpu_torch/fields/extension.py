"""Extension fields K[X]/(X^D - w) over the port's fields (counterpart of
icicle_tpu/fields/extension.py).

An extension element is a flat `(..., D * B)` int32 tensor: D components
of base width B laid out one after the other (B = 1 for the single-word
fields, whose components sit on the last axis; 2 for goldilocks; L limbs
for the multi-limb fields; a tower's base width for Fq6 and Fq12). So the
curve formulas, the MSM's tables and the kernels' layouts treat an Fp2
coordinate as a wider field element, as the JAX package does.

Degrees and nonresidues (the reference's configs, `_EXT_CONFIGS`):
  babybear  D=4 w=11      koalabear D=4 w=3      m31 D=4 w=-1
  goldilocks D=2 w=7      bn254_base D=2 w=-1    bls12_377_base D=2 w=-5
  bls12_381_base D=2 w=-1
and the pairing towers Fq2 -> Fq6 = Fq2[v]/(v^3 - xi) -> Fq12 = Fq6[t]/(t^2 - v)
(`_TOWER_XI`, `get_tower_field`).

The engine is eager torch. Every op returns canonical components, so its
results equal the JAX engine's bit for bit whatever the order of its base
operations; and it batches them: a product is the schoolbook one with the
X^D = w fold, as in the JAX `_mul_core`, but its D^2 base products are one
base multiply over stacked operands, the products that fold are multiplied
by w in one more step, and the D terms of each output are summed in D - 1
adds over all D outputs at once. Add, sub and neg are one base op over the
(..., D, B) view. So an Fp2 multiply costs about one base multiply's torch
calls, not four.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from icicle_tpu_torch.fields.field import get_field
from icicle_tpu_torch.runtime.device import resolve


class ExtEngine:
    """The engine of K[X]/(X^D - w) over a base field K: a `Field` or
    another `ExtField` (towers). `nonresidue` is a small int (an add chain)
    or a canonical element of K (an int32 tensor of K's width)."""

    def __init__(self, base, degree: int, nonresidue):
        self.base = base
        self.bf = base.engine
        self.degree = degree
        self.base_width = int(np.prod(base.limb_shape)) if base.limb_shape else 1
        self.base_flat = base.limb_shape == ()
        self.width = degree * self.base_width
        self.p_int = base.modulus
        if isinstance(nonresidue, (int, np.integer)):
            self.w = int(nonresidue)
            self._w_el = None
        else:
            self.w = None
            self._w_el = nonresidue.cpu()
        self._consts: dict = {}
        # the schoolbook's terms: output k sums a_t b_((k - t) mod D) over t,
        # and a term with t + ((k - t) mod D) >= D is multiplied by w
        d = degree
        self._term_j = [[(k - t) % d for t in range(d)] for k in range(d)]
        self._term_hi = [[t + (k - t) % d >= d for t in range(d)] for k in range(d)]

    # -- component plumbing ----------------------------------------------------
    def view(self, x: torch.Tensor) -> torch.Tensor:
        """(..., D*B) -> (..., D) for a single-word base, else (..., D, B):
        the components as a batch of base elements."""
        if self.base_flat:
            return x
        return x.reshape(x.shape[:-1] + (self.degree, self.base_width))

    def unview(self, v: torch.Tensor) -> torch.Tensor:
        if self.base_flat:
            return v
        return v.reshape(v.shape[:-2] + (self.width,))

    def comps(self, x: torch.Tensor) -> list:
        """(..., D*B) -> list of D base elements ((..., B) or (...,))."""
        v = self.view(x)
        axis = -1 if self.base_flat else -2
        return list(v.unbind(axis))

    def restack(self, comps) -> torch.Tensor:
        if self.base_flat:
            return torch.stack(comps, dim=-1)
        return torch.cat(comps, dim=-1)

    def _device_const(self, key, make, device) -> torch.Tensor:
        k = (key, device)
        if k not in self._consts:
            self._consts[k] = make().to(device)
        return self._consts[k]

    # -- small-constant multiply via add chain ----------------------------------
    def _mul_small(self, x, k: int):
        if k == 0:
            return torch.zeros_like(x)
        if k < 0:
            return self.bf.neg(self._mul_small(x, -k))
        acc = None
        for bit in bin(k)[2:]:
            if acc is not None:
                acc = self.bf.add(acc, acc)
            if bit == "1":
                acc = x if acc is None else self.bf.add(acc, x)
        return acc

    def _mul_w(self, x, mont: bool = False):
        """x * nonresidue. Int nonresidues are add chains (domain-agnostic);
        element nonresidues need the matching-domain base multiply."""
        if self._w_el is None:
            return self._mul_small(x, self.w)
        if mont:
            w = self._device_const("w_mont", lambda: self.bf.to_mont(self._w_el), x.device)
            return self.bf.mul_mont(x, w)
        return self.bf.mul(x, self._device_const("w", lambda: self._w_el, x.device))

    # -- ring ops ----------------------------------------------------------------
    def add(self, a, b):
        return self.unview(self.bf.add(self.view(a), self.view(b)))

    def sub(self, a, b):
        return self.unview(self.bf.sub(self.view(a), self.view(b)))

    def neg(self, a):
        return self.unview(self.bf.neg(self.view(a)))

    def _mul_core(self, a, b, mul, mont: bool = False):
        """Schoolbook product with X^D = w folding; `mul` is the base
        multiply, called once on all D^2 products."""
        d = self.degree
        av, bv = self.view(a), self.view(b)
        ax = -1 if self.base_flat else -2            # the component axis
        dev = a.device
        # P[..., i, j] = a_i b_j
        prods = mul(av.unsqueeze(ax), bv.unsqueeze(ax - 1))
        # terms[..., k, t] = P[..., t, (k - t) mod D]
        i_idx = self._device_const("i", lambda: torch.arange(d).expand(d, d), dev)
        j_idx = self._device_const("j", lambda: torch.tensor(self._term_j), dev)
        terms = prods[..., i_idx, j_idx] if self.base_flat else prods[..., i_idx, j_idx, :]
        hi = self._device_const("hi", lambda: torch.tensor(self._term_hi).view(
            (d, d) if self.base_flat else (d, d, 1)), dev)
        terms = torch.where(hi, self._mul_w(terms, mont=mont), terms)
        out = terms.select(ax, 0)
        for t in range(1, d):
            out = self.bf.add(out, terms.select(ax, t))
        return self.unview(out)

    def mul_mont(self, a, b):
        return self._mul_core(a, b, self.bf.mul_mont, mont=True)

    def mul(self, a, b):
        return self._mul_core(a, b, self.bf.mul)

    def sqr(self, a):
        return self.mul(a, a)

    def to_mont(self, a):
        return self.unview(self.bf.to_mont(self.view(a)))

    def from_mont(self, a):
        return self.unview(self.bf.from_mont(self.view(a)))

    def mul_base(self, a, s):
        """Multiply an extension element by a base-field scalar (canonical
        both)."""
        ax = -1 if self.base_flat else -2
        return self.unview(self.bf.mul(self.view(a), s.unsqueeze(ax)))

    # -- predicates ----------------------------------------------------------------
    def is_zero(self, a):
        return (a == 0).all(-1)

    def eq(self, a, b):
        return (a == b).all(-1)

    # -- inversion (canonical in and out; reference quartic_extension.h:248-283,
    #    complex_extension.h norm trick) -----------------------------------------
    def inv(self, a):
        bf = self.bf
        mw = self._mul_w
        c = self.comps(a)
        if self.degree == 2:
            # norm = c0^2 - w c1^2; inv = (c0 - c1 X) / norm
            n = bf.sub(bf.mul(c[0], c[0]), mw(bf.mul(c[1], c[1])))
            ninv = bf.inv(n)
            return self.restack([bf.mul(c[0], ninv), bf.neg(bf.mul(c[1], ninv))])
        if self.degree == 4:
            c0, c1, c2, c3 = c
            two_c1c3 = bf.mul(c1, bf.add(c3, c3))
            x0 = bf.sub(bf.mul(c0, c0), mw(bf.sub(two_c1c3, bf.mul(c2, c2))))
            x2 = bf.sub(bf.sub(bf.mul(c0, bf.add(c2, c2)), bf.mul(c1, c1)), mw(bf.mul(c3, c3)))
            norm = bf.sub(bf.mul(x0, x0), mw(bf.mul(x2, x2)))
            ninv = bf.inv(norm)
            x0 = bf.mul(x0, ninv)
            x2 = bf.mul(x2, ninv)
            return self.restack([
                bf.sub(bf.mul(c0, x0), mw(bf.mul(c2, x2))),
                bf.sub(mw(bf.mul(c3, x2)), bf.mul(c1, x0)),
                bf.sub(bf.mul(c2, x0), bf.mul(c0, x2)),
                bf.sub(bf.mul(c1, x2), bf.mul(c3, x0)),
            ])
        if self.degree == 3:
            # adjugate inverse over X^3 = w (reference cubic_extension.h)
            c0, c1, c2 = c
            t0 = bf.sub(bf.mul(c0, c0), mw(bf.mul(c1, c2)))
            t1 = bf.sub(mw(bf.mul(c2, c2)), bf.mul(c0, c1))
            t2 = bf.sub(bf.mul(c1, c1), bf.mul(c0, c2))
            norm = bf.add(bf.mul(c0, t0), mw(bf.add(bf.mul(c2, t1), bf.mul(c1, t2))))
            ninv = bf.inv(norm)
            return self.restack([bf.mul(t0, ninv), bf.mul(t1, ninv), bf.mul(t2, ninv)])
        raise NotImplementedError(f"inv for degree {self.degree}")

    def _one_like(self, a):
        comps = self.comps(a)
        one = self.base.const(1, comps[0].shape[:len(comps[0].shape) - len(self.base.limb_shape)],
                              a.device)
        return self.restack([one] + [torch.zeros_like(x) for x in comps[1:]])

    def pow_const(self, a, e: int):
        """a^e by right-to-left square and multiply (the JAX engine's order;
        canonical either way); a^0 = 1."""
        if e == 0:
            return self._one_like(a)
        result = None
        acc = a
        bits = []
        while e:
            bits.append(e & 1)
            e >>= 1
        for i, bit in enumerate(bits):
            if bit:
                result = acc if result is None else self.mul(result, acc)
            if i + 1 < len(bits):
                acc = self.mul(acc, acc)
        return result


class ExtField:
    """Field-like wrapper over ExtEngine (the surface of fields.field.Field).
    `base` is a registered prime-field name or a Field / ExtField object
    (towers)."""

    def __init__(self, base, degree: int, nonresidue):
        self.base = get_field(base) if isinstance(base, str) else base
        self.engine = ExtEngine(self.base, degree, nonresidue)
        self.name = f"{self.base.name}_ext{degree}"
        self.degree = degree
        self.modulus = self.base.modulus  # the base characteristic
        self.limb_shape = (self.engine.width,)
        self.nlimbs = self.engine.width

    def add(self, a, b): return self.engine.add(a, b)
    def sub(self, a, b): return self.engine.sub(a, b)
    def neg(self, a): return self.engine.neg(a)
    def mul(self, a, b): return self.engine.mul(a, b)
    def sqr(self, a): return self.engine.mul(a, a)
    def inv(self, a): return self.engine.inv(a)
    def mul_mont(self, a, b): return self.engine.mul_mont(a, b)
    def to_mont(self, a): return self.engine.to_mont(a)
    def from_mont(self, a): return self.engine.from_mont(a)
    def eq(self, a, b): return self.engine.eq(a, b)
    def is_zero(self, a): return self.engine.is_zero(a)
    def pow_const(self, a, e): return self.engine.pow_const(a, e)

    def const(self, value: int, batch_shape=(), device=None) -> torch.Tensor:
        comps = [self.base.const(value if i == 0 else 0, batch_shape, device)
                 for i in range(self.degree)]
        return self.engine.restack(comps)

    # -- int conversion (components little-endian: value = sum c_i X^i) ---------
    def from_ints(self, values, device=None) -> torch.Tensor:
        """Nested int sequence; for towers, the trailing axes are the nested
        component axes outermost-first (e.g. Fq12 input shape (..., 2, 3, 2))."""
        arr = np.asarray(values, dtype=object)
        if isinstance(self.base, ExtField):
            axis = arr.ndim - 1 - self._tower_depth(self.base)
            if arr.shape[axis] != self.degree:
                raise ValueError(f"axis {axis} must be degree {self.degree}")
            comps = [self.base.from_ints(arr.take(i, axis=axis), device)
                     for i in range(self.degree)]
        else:
            if arr.shape[-1] != self.degree:
                raise ValueError(f"trailing axis must be degree {self.degree}")
            comps = [self.base.from_ints(arr[..., i], device) for i in range(self.degree)]
        return self.engine.restack(comps)

    @staticmethod
    def _tower_depth(f) -> int:
        return 1 + ExtField._tower_depth(f.base) if isinstance(f, ExtField) else 0

    def to_ints(self, arr: torch.Tensor) -> np.ndarray:
        outs = [self.base.to_ints(c) for c in self.engine.comps(arr)]
        return np.stack(outs, axis=-1 - self._tower_depth(self.base))

    def rand(self, rng: np.random.Generator, batch_shape=(), device=None) -> torch.Tensor:
        """Uniform random elements; the same draws from `rng` as the JAX
        package's ExtField.rand, so one seed gives both the same elements."""
        if isinstance(self.base, ExtField):
            return self.engine.restack([self.base.rand(rng, batch_shape, device)
                                        for _ in range(self.degree)])
        vals = np.empty(tuple(batch_shape) + (self.degree,), dtype=object)
        flat = vals.reshape(-1, self.degree)
        for i in range(flat.shape[0]):
            for j in range(self.degree):
                flat[i, j] = int.from_bytes(rng.bytes(40), "little") % self.modulus
        return self.from_ints(vals, device)

    def element_shape(self, batch_shape=()) -> tuple:
        return tuple(batch_shape) + (self.engine.width,)

    def zeros(self, batch_shape=(), device=None) -> torch.Tensor:
        return torch.zeros(self.element_shape(batch_shape), dtype=torch.int32,
                           device=resolve(device))


# reference extension configs: base field -> (degree, nonresidue)
_EXT_CONFIGS: dict[str, tuple[int, int]] = {
    "babybear": (4, 11),
    "koalabear": (4, 3),
    "m31": (4, -1),
    "goldilocks": (2, 7),
    "bn254_base": (2, -1),
    "bls12_377_base": (2, -5),
    "bls12_381_base": (2, -1),
}


@functools.lru_cache(maxsize=None)
def get_ext_field(base_name: str, degree: int | None = None) -> ExtField:
    if base_name not in _EXT_CONFIGS:
        raise KeyError(f"no extension config for {base_name!r}")
    d, w = _EXT_CONFIGS[base_name]
    if degree is not None and degree != d:
        raise ValueError(f"{base_name} extension degree is {d}, not {degree}")
    return ExtField(base_name, d, w)


# pairing tower nonresidues (reference snark_fields/{bn254,bls12_*}_tower.h):
# Fq2 = Fq[u]/(u^2 - nr), Fq6 = Fq2[v]/(v^3 - xi), Fq12 = Fq6[t]/(t^2 - v)
_TOWER_XI: dict[str, tuple[int, tuple[int, int]]] = {
    "bn254": (-1, (9, 1)),
    "bls12_381": (-1, (1, 1)),
    "bls12_377": (-5, (0, 1)),
}


@functools.lru_cache(maxsize=None)
def get_tower_field(curve_name: str, ext_degree: int) -> ExtField:
    """The pairing tower fields Fq2 / Fq6 / Fq12 of bn254 and bls12-{381,377}
    (reference cubic_extension.h + *_tower.h), flat (..., D*B) int32 rows;
    curves/ate.py's Fp12Tower is the host-int twin."""
    if curve_name not in _TOWER_XI:
        raise KeyError(f"no pairing tower for {curve_name!r}")
    nr, xi = _TOWER_XI[curve_name]
    if ext_degree == 2:
        return ExtField(f"{curve_name}_base", 2, nr)
    if ext_degree == 6:
        fq2 = get_tower_field(curve_name, 2)
        return ExtField(fq2, 3, fq2.from_ints([list(xi)], "cpu")[0])
    if ext_degree == 12:
        fq6 = get_tower_field(curve_name, 6)
        return ExtField(fq6, 2, fq6.from_ints([[[0, 0], [1, 0], [0, 0]]], "cpu")[0])
    raise ValueError(f"tower degree must be 2, 6 or 12, got {ext_degree}")
