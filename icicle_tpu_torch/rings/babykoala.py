"""The babykoala integer ring Z_q (q = P_babybear * P_koalabear) and its RNS
form (counterpart of icicle_tpu/rings/babykoala.py; reference
include/icicle/rings/params/babykoala.h).

Layouts, as the JAX package's:
  * Zq direct: (..., 2) int32 limbs [lo, hi] holding the uint32 bit
    patterns of the canonical value; the port's `BigField` engine at two
    limbs serves any odd modulus, so `ZqField` is a `Field` whose `inv`
    raises (only units are invertible).
  * Zq RNS: (..., 2) int32 = (x mod P_bb, x mod P_kb), canonical residues,
    one Mont32 lane a component.
  * R_q: a trailing (64,) coefficient axis before the limb axis
    (rings/rq.py).
"""

from __future__ import annotations

import functools

import torch

from icicle_tpu_torch.fields.field import Field, get_field
from icicle_tpu_torch.math.params import FieldParams

P_BB = 0x78000001
P_KB = 0x7F000001
Q = P_BB * P_KB                      # 0x3B880000F7000001
ROU = 0x0309B1118BE440ED             # order 2^24 (babykoala.h zq_config)
OMEGAS_COUNT = 24
RQ_DEGREE = 64                       # R_q = Z_q[X]/(X^64+1), babykoala.h:77

# CRT weights (babykoala.h zq_rns_config::crt_weights): x = w_bb*x_bb + w_kb*x_kb mod q
CRT_W_BB = 0x2204924130924914
CRT_W_KB = 0x19836DBFC66DB6EE


class ZqField(Field):
    """Field-like wrapper for the composite ring Z_q (no Fermat inversion)."""

    def inv(self, a):
        raise NotImplementedError(
            "Z_q is a composite ring: elementwise Fermat inversion is invalid; "
            "invert units host-side with pow(x, -1, Q)")

    def unit_inv_int(self, x: int) -> int:
        return pow(x, -1, self.modulus)


@functools.lru_cache(maxsize=None)
def get_zq() -> ZqField:
    return ZqField(FieldParams(name="babykoala_zq", modulus=Q, rou=ROU,
                               two_adicity_override=OMEGAS_COUNT))


class ZqRns:
    """RNS representation ops: (..., 2) = (babybear, koalabear) residues."""

    def __init__(self):
        self.f_bb = get_field("babybear")
        self.f_kb = get_field("koalabear")

    def comps(self, x):
        return x[..., 0], x[..., 1]

    def stack(self, bb, kb):
        return torch.stack([bb, kb], dim=-1)

    def _map(self, op, *args):
        return self.stack(*(getattr(f.engine, op)(*(a[..., i] for a in args))
                            for i, f in enumerate((self.f_bb, self.f_kb))))

    def add(self, a, b):
        return self._map("add", a, b)

    def sub(self, a, b):
        return self._map("sub", a, b)

    def mul(self, a, b):
        return self._map("mul", a, b)

    def neg(self, a):
        return self._map("neg", a)


@functools.lru_cache(maxsize=None)
def get_rns() -> ZqRns:
    return ZqRns()


# -- direct <-> RNS conversion (reference convert_to_rns / convert_from_rns,
#    registered in cpu_vec_ops.cpp) ----------------------------------------------

def zq_to_rns(x: torch.Tensor) -> torch.Tensor:
    """(..., 2) Zq limbs -> (..., 2) RNS residues: x = lo + hi 2^32, residue
    (lo mod p + (hi mod p) (2^32 mod p)) mod p, in int64 (each product is
    below 2^62), on x's device."""
    w = x.to(torch.int64) & 0xFFFFFFFF
    lo, hi = w[..., 0], w[..., 1]
    return torch.stack([(lo % p + (hi % p) * ((1 << 32) % p)) % p for p in (P_BB, P_KB)],
                       dim=-1).to(torch.int32)


def rns_to_zq(x: torch.Tensor) -> torch.Tensor:
    """(..., 2) RNS residues -> (..., 2) Zq limbs: w_bb bb + w_kb kb mod q
    (the CRT weights), through the Z_q engine as the JAX package computes
    it."""
    e = get_zq().engine
    zeros = torch.zeros_like(x[..., 0])
    bb = torch.stack([x[..., 0], zeros], dim=-1)
    kb = torch.stack([x[..., 1], zeros], dim=-1)
    return e.add(e.mul(bb, e.const(CRT_W_BB, like=bb)), e.mul(kb, e.const(CRT_W_KB, like=kb)))


def verify_constants():
    """Sanity: CRT weights reconstruct; rou has order 2^24."""
    assert Q == 0x3B880000F7000001
    assert CRT_W_BB % P_BB == 1 and CRT_W_BB % P_KB == 0
    assert CRT_W_KB % P_KB == 1 and CRT_W_KB % P_BB == 0
    assert pow(ROU, 1 << OMEGAS_COUNT, Q) == 1
    assert pow(ROU, 1 << (OMEGAS_COUNT - 1), Q) != 1
