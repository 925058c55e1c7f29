"""Derivation of per-field arithmetic constants from the modulus
(counterpart of icicle_tpu/math/params.py).

The reference generates Montgomery constants at C++ compile time
(include/icicle/fields/params_gen.h); here they are Python big ints. The port
keeps its own copy so that it imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

WORD = 32
HALF = 16


def limbs_of(value: int, n: int, bits: int = WORD) -> list[int]:
    """Little-endian fixed-width limb decomposition of a non-negative int."""
    mask = (1 << bits) - 1
    return [(value >> (bits * i)) & mask for i in range(n)]


def int_of(limbs, bits: int = WORD) -> int:
    out = 0
    for i, limb in enumerate(limbs):
        out |= int(limb) << (bits * i)
    return out


@functools.lru_cache(maxsize=None)
def _derived(modulus: int, nlimbs: int):
    r = 1 << (WORD * nlimbs)
    r2 = (r * r) % modulus
    # n' = -p^{-1} mod 2^w, for Montgomery word-by-word reduction.
    inv32 = (-pow(modulus, -1, 1 << WORD)) % (1 << WORD)
    inv16 = (-pow(modulus, -1, 1 << HALF)) % (1 << HALF)
    return r % modulus, r2, inv32, inv16


@dataclasses.dataclass(frozen=True)
class FieldParams:
    """Arithmetic constants for one prime field."""

    name: str
    modulus: int
    # Optional NTT data: `rou` generates the full 2^two_adicity subgroup.
    rou: int | None = None
    nonresidue: int | None = None  # extension-field nonresidue (signed)
    generator: int | None = None   # multiplicative generator, if known
    # the order 2^k of `rou` where it is not the full 2-power of p - 1 (the
    # babykoala ring Z_q and its RNS planes, whose rou is the ring's)
    two_adicity_override: int | None = None

    @property
    def bits(self) -> int:
        return self.modulus.bit_length()

    @property
    def nlimbs(self) -> int:
        return (self.bits + WORD - 1) // WORD

    @property
    def nhalf(self) -> int:
        return 2 * self.nlimbs

    @property
    def r(self) -> int:  # R mod p (the Montgomery unit), R = 2^(32*nlimbs)
        return _derived(self.modulus, self.nlimbs)[0]

    @property
    def r2(self) -> int:
        return _derived(self.modulus, self.nlimbs)[1]

    @property
    def inv32(self) -> int:
        return _derived(self.modulus, self.nlimbs)[2]

    @property
    def inv16(self) -> int:
        return _derived(self.modulus, self.nlimbs)[3]

    @property
    def two_adicity(self) -> int:
        if self.two_adicity_override is not None:
            return self.two_adicity_override
        s, m = 0, self.modulus - 1
        while m % 2 == 0:
            m //= 2
            s += 1
        return s

    # -- numpy constant views -------------------------------------------------
    def p_limbs32(self) -> np.ndarray:
        return np.array(limbs_of(self.modulus, self.nlimbs), dtype=np.uint32)

    def p_limbs16(self) -> np.ndarray:
        return np.array(limbs_of(self.modulus, self.nhalf, HALF), dtype=np.uint32)

    def const_limbs32(self, value: int) -> np.ndarray:
        return np.array(limbs_of(value % self.modulus, self.nlimbs), dtype=np.uint32)

    def to_mont_int(self, value: int) -> int:
        return (value * (1 << (WORD * self.nlimbs))) % self.modulus

    def from_mont_int(self, value: int) -> int:
        rinv = pow(1 << (WORD * self.nlimbs), -1, self.modulus)
        return (value * rinv) % self.modulus

    def omega(self, logn: int) -> int:
        """Primitive 2^logn-th root of unity, by repeated squaring of `rou`
        (reference get_root_of_unity, include/icicle/fields/params_gen.h)."""
        if self.rou is None:
            raise ValueError(f"field {self.name} has no root of unity configured")
        if logn > self.two_adicity:
            raise ValueError(f"requested 2^{logn} domain > two-adicity {self.two_adicity}")
        w = self.rou
        for _ in range(self.two_adicity - logn):
            w = (w * w) % self.modulus
        return w
