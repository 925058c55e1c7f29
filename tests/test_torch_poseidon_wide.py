"""The 8-limb Poseidon kernel (icicle_tpu_torch/kernels/csrc/
poseidon_limbs.cu over ec_wide.cuh), modelled on the CPU.

The CUDA source cannot run here. Its steps are modelled with Python ints
over the constant table the kernel is given (`Poseidon.constants().table`,
Montgomery form, poseidon.cuh's Layout): one loop over the rounds after
rc_pre, full rounds a column at a time, partial rounds through the sparse
matrix, the last round's lane 1 alone. The model runs over two fields of
ops: Montgomery products of Python ints (every field and width, with and
without a domain tag), and the word model of
tests/test_torch_msm_wide_arith.py (ec_wide.cuh's multiply and add with
PTX's carry flag), lazy in [0, 2p) or canonical after every step as the
kernel picks by the modulus's top two bits. Both are held to
`poseidon_model`, which tests/test_torch_poseidon.py holds to the JAX
package, and to `hash_fields_ref` at P1's instance.
"""

from __future__ import annotations

import os

import numpy as np
import pytest

from icicle_tpu_torch import Poseidon, get_field
from icicle_tpu_torch.kernels import build
from icicle_tpu_torch.kernels import poseidon_kernel as PK
from icicle_tpu_torch.kernels.poseidon2_kernel import field_consts
from tests.test_torch_msm_wide_arith import Flag, add, canonical, mul, value, words
from tests.test_torch_poseidon import poseidon_model

# which 8-limb fields keep their values lazy in [0, 2p) (4p < 2^256) and
# which end every product and sum in `canonical`
LAZY = {"bn254_scalar": True, "grumpkin_scalar": True, "bls12_377_scalar": True,
        "bls12_381_scalar": False, "stark252": True}
TAG = 0


class Modulus:
    """An 8-limb field's constants as the word model takes them (ec_wide.cuh
    BaseConsts): p, 2p, inv32."""

    def __init__(self, fname: str):
        self.L = 8
        self.p = get_field(fname).modulus
        self.R = 1 << 256
        self.inv32 = (-pow(self.p, -1, 1 << 32)) % (1 << 32)
        self.pw = words(self.p, 8)
        self.p2w = words(2 * self.p, 8)


class IntOps:
    """Montgomery products of Python ints, canonical."""

    def __init__(self, fname: str):
        self.p = get_field(fname).modulus
        self.rinv = pow(1 << 256, -1, self.p)
        self.R = (1 << 256) % self.p

    def mul(self, a, b):
        return a * b * self.rinv % self.p

    def add(self, a, b):
        return (a + b) % self.p

    def elem(self, mont: int):
        return mont

    def to_mont(self, x: int):
        return x * self.R % self.p

    def digest(self, a):
        return a * self.rinv % self.p


class WordOps:
    """poseidon_limbs.cu's Wide8<LAZY[field]> in the word model."""

    def __init__(self, fname: str):
        self.f = Modulus(fname)
        self.lazy = LAZY[fname]
        self.F = Flag()
        p = self.f.p
        self.r2 = words((1 << 512) % p, 8)

    def _end(self, r):
        assert value(r) < 2 * self.f.p
        return r if self.lazy else canonical(self.F, r, self.f)

    def mul(self, a, b):
        return self._end(mul(self.F, a, b, self.f))

    def add(self, a, b):
        return self._end(add(self.F, a, b, self.f))

    def elem(self, mont: int):
        return words(mont, 8)

    def to_mont(self, x: int):
        return self.mul(words(x, 8), self.r2)

    def digest(self, a):
        r = canonical(self.F, mul(self.F, a, words(1, 8), self.f), self.f)
        return value(r)


def table_ints(h) -> list:
    t = h.constants("cpu").table.reshape(-1, 8).numpy().view(np.uint32)
    return [sum(int(w) << (32 * j) for j, w in enumerate(row)) for row in t]


def kernel_model(h, inputs: list, ops) -> int:
    """wide_poseidon_kernel's steps for one row of canonical ints."""
    T, HALF, PARTIAL = h.t, h.half, h.partial
    tab = [ops.elem(v) for v in table_ints(h)]
    rc_full_top, rc_partial = T, (HALF + 1) * T
    rc_full_bot = (HALF + 1) * T + PARTIAL
    mds = 2 * HALF * T + PARTIAL
    pre = mds + T * T
    sparse = pre + T * T

    def sbox(x):
        x2 = ops.mul(x, x)
        return ops.mul(ops.mul(x2, x2), x)

    s = []
    if h.domain_tag is not None:
        tag = h.tag_mont("cpu").reshape(-1).numpy().view(np.uint32)
        s.append(ops.elem(sum(int(w) << (32 * j) for j, w in enumerate(tag))))
    s += [ops.to_mont(x) for x in inputs]
    s = [ops.add(v, tab[j]) for j, v in enumerate(s)]
    rounds = 2 * HALF + PARTIAL
    for r in range(rounds):
        if HALF <= r < HALF + PARTIAL:
            sp = sparse + (r - HALF) * (2 * T - 1)
            s[0] = ops.add(sbox(s[0]), tab[rc_partial + r - HALF])
            out0 = ops.mul(s[0], tab[sp])
            for j in range(1, T):
                out0 = ops.add(out0, ops.mul(s[j], tab[sp + j]))
            for j in range(1, T):
                s[j] = ops.add(ops.mul(s[0], tab[sp + T + j - 1]), s[j])
            s[0] = out0
            continue
        last = r == rounds - 1
        rc = rc_full_top + r * T if r < HALF else rc_full_bot + (r - HALF - PARTIAL) * T
        mat = pre if r == HALF - 1 else mds
        for j in range(T):
            s[j] = sbox(s[j])
            if not last:
                s[j] = ops.add(s[j], tab[rc + j])
        o = list(s)
        for col in range(1, 2) if last else range(T):
            acc = ops.mul(s[0], tab[mat + col])
            for k in range(1, T):
                acc = ops.add(acc, ops.mul(s[k], tab[mat + k * T + col]))
            o[col] = acc
        s = o
    return ops.digest(s[1])


def rows(fname: str, n: int, count: int, seed: int) -> list:
    p = get_field(fname).modulus
    rng = np.random.default_rng(seed)
    out = [[int.from_bytes(rng.bytes(40), "little") % p for _ in range(n)] for _ in range(count)]
    out[0] = [p - 1] * n
    return out


def test_lazy_table():
    """LAZY is the modulus's top two bits clear (4p < 2^256), the rule the C
    entry applies to the host consts; bls12_381_scalar is not lazy."""
    assert set(LAZY) == set(PK.LIMB_FIELDS)
    assert LAZY["bls12_381_scalar"] is False
    text = open(os.path.join(build.CSRC, "poseidon_limbs.cu")).read()
    assert "const bool lazy = (consts[7] >> 30) == 0;" in text
    for fname, lazy in LAZY.items():
        p = get_field(fname).modulus
        assert (4 * p < 1 << 256) == lazy == (field_consts(fname)[7] >> 30 == 0), fname
        assert p < 1 << 255


def test_canonical_ending_multiply_is_exact_on_bls12_381_scalar():
    """With inputs below p < 2^255 the multiply's steps drop no carry (the
    word model checks each site), its result is below 2p and `canonical`
    makes it a b R^-1 mod p; the add of two canonical values too. A lazy
    sum of two values near 2p would carry out of 256 bits."""
    f = Modulus("bls12_381_scalar")
    F = Flag()
    rinv = pow(f.R, -1, f.p)
    rng = np.random.default_rng(381)
    vals = [0, 1, f.p - 1, f.p - 2, f.R % f.p] + \
        [int.from_bytes(rng.bytes(32), "little") % f.p for _ in range(12)]
    for a in vals:
        for b in vals[:6] + [a]:
            r = mul(F, words(a, 8), words(b, 8), f)
            assert value(r) < 2 * f.p
            assert value(canonical(F, r, f)) == a * b * rinv % f.p
            s = canonical(F, add(F, words(a, 8), words(b, 8), f), f)
            assert value(s) == (a + b) % f.p
    with pytest.raises(AssertionError, match="add: the sum"):
        add(F, words(2 * f.p - 1, 8), words(2 * f.p - 1, 8), f)


@pytest.mark.parametrize("fname", [f for f, lazy in LAZY.items() if lazy])
def test_lazy_fields_stay_below_2p(fname):
    f = Modulus(fname)
    F = Flag()
    rinv = pow(f.R, -1, f.p)
    rng = np.random.default_rng(len(fname))
    vals = [0, f.p - 1, f.p, 2 * f.p - 1] + \
        [int.from_bytes(rng.bytes(32), "little") % (2 * f.p) for _ in range(8)]
    for a in vals:
        for b in vals:
            r = mul(F, words(a, 8), words(b, 8), f)
            s = add(F, words(a, 8), words(b, 8), f)
            assert value(r) < 2 * f.p and value(r) % f.p == a * b * rinv % f.p
            assert value(s) < 2 * f.p and value(s) % f.p == (a + b) % f.p


@pytest.mark.parametrize("tag", [None, TAG])
@pytest.mark.parametrize("t", PK.KERNEL_WIDTHS)
@pytest.mark.parametrize("fname", PK.LIMB_FIELDS)
def test_kernel_rounds_over_ints(fname, t, tag):
    """The kernel's round loop (offsets from the round index, columns one
    at a time, the last round's lane 1) equals poseidon_model."""
    h = Poseidon(fname, t, domain_tag=tag)
    ops = IntOps(fname)
    for row in rows(fname, h.arity, 2, seed=t):
        assert kernel_model(h, row, ops) == poseidon_model(fname, t, row, tag)


@pytest.mark.parametrize("t", [3, 5])
@pytest.mark.parametrize("fname", PK.LIMB_FIELDS)
def test_kernel_rounds_over_words(fname, t):
    """The same loop over ec_wide.cuh's word model, lazy or canonical as
    LAZY says: the digest equals poseidon_model, and no step drops a
    carry."""
    h = Poseidon(fname, t, domain_tag=TAG)
    row = rows(fname, h.arity, 1, seed=t + 1)[0]
    assert kernel_model(h, row, WordOps(fname)) == poseidon_model(fname, t, row, TAG)


def test_p1_instance_equals_hash_fields_ref():
    """P1's instance (bls12_381_scalar, t = 9, a tag) through the model
    equals the plain version."""
    f = get_field("bls12_381_scalar")
    h = Poseidon(f, 9, domain_tag=TAG)
    batch = rows("bls12_381_scalar", h.arity, 2, seed=9)
    x = f.from_ints([v for r in batch for v in r], "cpu").reshape(2, h.arity, 8)
    want = f.to_ints(h.hash_fields_ref(x))
    assert [kernel_model(h, r, IntOps(f.name)) for r in batch] == [int(v) for v in want]
