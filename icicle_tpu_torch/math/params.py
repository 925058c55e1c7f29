"""Derivation of per-field arithmetic constants from the modulus
(counterpart of icicle_tpu/math/params.py).

The reference generates Montgomery constants at C++ compile time
(include/icicle/fields/params_gen.h); here they are Python big ints. The port
keeps its own copy so that it imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import functools

WORD = 32


@functools.lru_cache(maxsize=None)
def _derived(modulus: int, nlimbs: int):
    r = 1 << (WORD * nlimbs)
    r2 = (r * r) % modulus
    # n' = -p^{-1} mod 2^32, for Montgomery word-by-word reduction.
    inv32 = (-pow(modulus, -1, 1 << WORD)) % (1 << WORD)
    return r % modulus, r2, inv32


@dataclasses.dataclass(frozen=True)
class FieldParams:
    """Arithmetic constants for one prime field."""

    name: str
    modulus: int
    # Optional NTT data: `rou` generates the full 2^two_adicity subgroup.
    rou: int | None = None
    nonresidue: int | None = None  # extension-field nonresidue (signed)
    generator: int | None = None   # multiplicative generator, if known

    @property
    def bits(self) -> int:
        return self.modulus.bit_length()

    @property
    def nlimbs(self) -> int:
        return (self.bits + WORD - 1) // WORD

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
    def two_adicity(self) -> int:
        s, m = 0, self.modulus - 1
        while m % 2 == 0:
            m //= 2
            s += 1
        return s

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
