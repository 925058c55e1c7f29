"""The lazy goldilocks arithmetic of the goldilocks Poseidon2 and the NTT
row kernel (icicle_tpu_torch/kernels/csrc/gl64.cuh: lazy_add, lazy_mul,
lazy_sub, canonical), modelled word by word on the CPU.

The CUDA source cannot run here, so this file keeps a Python model of the
four functions that follows the source step for step: the two 32-bit
halves of a 64-bit word, the four 32x32 products of the multiply, and
PTX's carry flag as one bit that each `.cc` step writes and each `c` step
reads. Every place where the source ends a chain without taking its carry
out (an instruction without `.cc`, marked "carry out: none" there) is a
named site here, and the model asserts there that the carry it drops is
0. Each function is held to Python-int arithmetic mod p on edge words (0,
1, p - 1, p, p + 1, eps, 2^64 - 1, 2^64 - eps, ...) and numpy-seeded
64-bit words, which a lazy value may be; and a permutation run in the
model (lazy state, canonical digest) is held to the port's plain version.
"""

from __future__ import annotations

import os
import re

import numpy as np
import pytest
import torch

from icicle_tpu_torch import Poseidon2, get_field
from icicle_tpu_torch.kernels import build
from icicle_tpu_torch.kernels.poseidon2_kernel import ext_chain, int_chain

MASK = 0xFFFFFFFF
P = (1 << 64) - (1 << 32) + 1
EPS = (1 << 32) - 1          # 2^64 mod p
SOURCE = os.path.join(build.CSRC, "gl64.cuh")
# the sites where gl64.cuh's lazy functions drop a chain's carry out
DROP_SITES = ("lazy_add: the second fold", "lazy_mul: the product's top word",
              "lazy_mul: the borrow's fold", "lazy_mul: the carry's fold",
              "lazy_sub: the second fold")
# the data-dependent paths: a fold that adds eps (or takes it back)
PATHS = ("lazy_add: first carry", "lazy_add: second carry", "lazy_mul: borrow",
         "lazy_mul: carry", "lazy_sub: first borrow", "lazy_sub: second borrow",
         "canonical: subtract")
EDGES = [0, 1, P - 1, P, P + 1, EPS, (1 << 64) - 1, (1 << 64) - EPS, 1 << 63, 1 << 32,
         (1 << 32) + 1, P - 2, 2 * P - (1 << 64)]


class Flag:
    """PTX's carry flag and carry_chain.cuh's primitives; the forms without
    .cc that end a chain name their site, where the carry out must be 0."""

    def __init__(self):
        self.cf = 0
        self.hits = set()
        self.paths = set()

    @staticmethod
    def _words(*xs):
        assert all(0 <= x <= MASK for x in xs), xs

    def _drop(self, t: int, site: str) -> int:
        assert site in DROP_SITES, site
        assert t >> 32 == 0, f"{site}: carry out {t >> 32}, the source drops none"
        self.hits.add(site)
        return t & MASK

    def _set(self, t: int) -> int:
        self.cf = int(t >> 32 != 0) if t >= 0 else 1
        return t & MASK

    def add_cc(self, a, b):
        self._words(a, b)
        return self._set(a + b)

    def addc_cc(self, a, b):
        self._words(a, b)
        return self._set(a + b + self.cf)

    def addc(self, a, b, site):
        self._words(a, b)
        return self._drop(a + b + self.cf, site)

    def flag(self):                # addc(0, 0): reads the flag, cannot carry
        return self.cf

    def sub_cc(self, a, b):
        self._words(a, b)
        return self._set(a - b)

    def subc_cc(self, a, b):
        self._words(a, b)
        return self._set(a - b - self.cf)

    def subc(self, a, b, site=None):
        self._words(a, b)
        t = a - b - self.cf
        if site is not None:
            assert site in DROP_SITES and t >= 0, f"{site}: a borrow out, the source drops none"
            self.hits.add(site)
        return t & MASK

    def mad_lo_cc(self, a, b, c):
        self._words(a, b, c)
        return self._set((a * b & MASK) + c)

    def madc_hi_cc(self, a, b, c):
        self._words(a, b, c)
        return self._set((a * b >> 32) + c + self.cf)

    def madc_hi(self, a, b, c, site):
        self._words(a, b, c)
        return self._drop((a * b >> 32) + c + self.cf, site)


def lo(a: int) -> int:
    return a & MASK


def hi(a: int) -> int:
    return a >> 32


def join(l: int, h: int) -> int:
    return (h << 32) | l


# -- the model: gl64.cuh's lazy functions, line for line ------------------------

def lazy_add(F: Flag, a: int, b: int) -> int:
    s0 = F.add_cc(lo(a), lo(b))
    s1 = F.addc_cc(hi(a), hi(b))
    c = F.flag()
    if c:
        F.paths.add("lazy_add: first carry")
    s0 = F.mad_lo_cc(c, EPS, s0)
    s1 = F.madc_hi_cc(c, EPS, s1)
    c = F.flag()
    if c:
        F.paths.add("lazy_add: second carry")
    s0 = F.mad_lo_cc(c, EPS, s0)
    s1 = F.madc_hi(c, EPS, s1, "lazy_add: the second fold")
    return join(s0, s1)


def lazy_mul(F: Flag, a: int, b: int) -> int:
    a0, a1, b0, b1 = lo(a), hi(a), lo(b), hi(b)
    r0 = a0 * b0 & MASK
    r1 = a0 * b0 >> 32
    r1 = F.mad_lo_cc(a0, b1, r1)
    r2 = F.madc_hi_cc(a0, b1, 0)
    assert F.cf == 0, "hi(a0 b1) + 1 < 2^32: the chain carries nothing into r3 here"
    r1 = F.mad_lo_cc(a1, b0, r1)
    r2 = F.madc_hi_cc(a1, b0, r2)
    r3 = F.flag()
    r2 = F.mad_lo_cc(a1, b1, r2)
    r3 = F.madc_hi(a1, b1, r3, "lazy_mul: the product's top word")
    assert join(r0, r1) + (join(r2, r3) << 64) == a * b
    t0 = F.sub_cc(r0, r3)
    t1 = F.subc_cc(r1, 0)
    borrow = F.subc(0, 0)
    if borrow:
        F.paths.add("lazy_mul: borrow")
    t0 = F.sub_cc(t0, borrow)
    t1 = F.subc(t1, 0, "lazy_mul: the borrow's fold")
    t0 = F.mad_lo_cc(r2, EPS, t0)
    t1 = F.madc_hi_cc(r2, EPS, t1)
    c = F.flag()
    if c:
        F.paths.add("lazy_mul: carry")
    t0 = F.mad_lo_cc(c, EPS, t0)
    t1 = F.madc_hi(c, EPS, t1, "lazy_mul: the carry's fold")
    return join(t0, t1)


def lazy_sub(F: Flag, a: int, b: int) -> int:
    d0 = F.sub_cc(lo(a), lo(b))
    d1 = F.subc_cc(hi(a), hi(b))
    borrow = F.subc(0, 0)
    if borrow:
        F.paths.add("lazy_sub: first borrow")
    d0 = F.sub_cc(d0, borrow)
    d1 = F.subc_cc(d1, 0)
    borrow = F.subc(0, 0)
    if borrow:
        F.paths.add("lazy_sub: second borrow")
    d0 = F.sub_cc(d0, borrow)
    d1 = F.subc(d1, 0, "lazy_sub: the second fold")
    return join(d0, d1)


def canonical(F: Flag, a: int) -> int:
    d0 = F.sub_cc(lo(a), lo(P))
    d1 = F.subc_cc(hi(a), hi(P))
    keep = F.subc(0, 0)
    if not keep:
        F.paths.add("canonical: subtract")
    return join((lo(a) & keep) | (d0 & ~keep & MASK), (hi(a) & keep) | (d1 & ~keep & MASK))


# -- the tests -------------------------------------------------------------------

def words64(count: int, seed: int) -> list:
    """The edge words, then `count` numpy-seeded 64-bit words (any word is a
    lazy value)."""
    rng = np.random.default_rng(seed)
    return EDGES + [int(v) for v in rng.integers(0, 1 << 64, count, dtype=np.uint64)]


def test_lazy_mul_is_the_product_mod_p():
    F = Flag()
    vals = words64(40, seed=1)
    for a in vals:
        for b in vals:
            r = lazy_mul(F, a, b)
            assert 0 <= r < 1 << 64 and r % P == a * b % P, (a, b)
    assert {s for s in DROP_SITES if s.startswith("lazy_mul")} <= F.hits
    assert {"lazy_mul: borrow", "lazy_mul: carry"} <= F.paths


def test_lazy_add_is_the_sum_mod_p():
    F = Flag()
    vals = words64(40, seed=2)
    for a in vals:
        for b in vals:
            r = lazy_add(F, a, b)
            assert 0 <= r < 1 << 64 and r % P == (a + b) % P, (a, b)
    assert "lazy_add: the second fold" in F.hits
    assert {"lazy_add: first carry", "lazy_add: second carry"} <= F.paths


def test_second_carry_of_an_add():
    """a + b >= 2^64 + p carries twice: (2^64 - 1) + (2^64 - 1) and
    (p + 1) + (2^64 - 1) do; p + (2^64 - 1) and (p - 1) + (2^64 - 1) (a
    canonical operand) do not."""
    for a, b, twice in (((1 << 64) - 1, (1 << 64) - 1, True), (P + 1, (1 << 64) - 1, True),
                        (P, (1 << 64) - 1, False), (P - 1, (1 << 64) - 1, False)):
        F = Flag()
        assert lazy_add(F, a, b) % P == (a + b) % P
        assert ("lazy_add: second carry" in F.paths) == twice


def test_lazy_sub_is_the_difference_mod_p():
    F = Flag()
    vals = words64(40, seed=4)
    for a in vals:
        for b in vals:
            r = lazy_sub(F, a, b)
            assert 0 <= r < 1 << 64 and r % P == (a - b) % P, (a, b)
    assert "lazy_sub: the second fold" in F.hits
    assert {"lazy_sub: first borrow", "lazy_sub: second borrow"} <= F.paths


def test_second_borrow_of_a_sub():
    """a - b borrows twice exactly where b - a > p: 0 - (p + 1) and
    0 - (2^64 - 1) do; 0 - p (d = eps after the first borrow) and
    (p - 1) - (2^64 - 1) do not."""
    for a, b, twice in ((0, P + 1, True), (0, (1 << 64) - 1, True), (0, P, False),
                        (P - 1, (1 << 64) - 1, False), (5, 7, False)):
        F = Flag()
        assert lazy_sub(F, a, b) % P == (a - b) % P
        assert ("lazy_sub: second borrow" in F.paths) == twice, (a, b)


def test_canonical():
    F = Flag()
    for a in words64(200, seed=3):
        assert canonical(F, a) == a % P
    assert "canonical: subtract" in F.paths


def test_model_names_every_site_the_source_drops_a_carry():
    """gl64.cuh marks each chain end without a carry out "carry out: none";
    the model has one named site for each, function by function, and the
    edge words reach every one and every data-dependent path."""
    text = open(SOURCE).read()
    lazy = text[text.index("-- lazy representatives"):]
    assert lazy.count("// carry out: none") == len(DROP_SITES)
    assert text.count("// carry out: none") == len(DROP_SITES)   # no site outside them
    for fn in ("lazy_add", "lazy_mul", "lazy_sub", "canonical"):
        body = re.search(rf"\b{fn}\(uint64_t a.*?\n\}}\n", lazy, re.S).group(0)
        assert body.count("// carry out: none") == sum(s.startswith(f"{fn}:") for s in DROP_SITES)
    F = Flag()
    for a in EDGES:
        for b in EDGES:
            canonical(F, lazy_sub(F, lazy_add(F, lazy_mul(F, a, b), b), a))
            lazy_sub(F, a, b)
    assert F.hits == set(DROP_SITES)
    assert F.paths == set(PATHS)


def _words_to_ints(t: torch.Tensor) -> list:
    w = t.reshape(-1, 2).to(torch.int64) & MASK
    return [int(a) | (int(b) << 32) for a, b in w.tolist()]


def permute_model(F: Flag, h: Poseidon2, s: list) -> list:
    """poseidon2.cuh `permute` over the lazy model: M_ext, half_full full
    rounds, the partial rounds (M_int by the kernel's chain), half_full
    full rounds; x^7 as x^4 x^2 x."""
    c = h.constants("cpu")
    rc, diag = _words_to_ints(c.rc), _words_to_ints(c.diag_m1)
    t, half = h.t, h.half_full
    add = lambda a, b: lazy_add(F, a, b)  # noqa: E731

    def sbox(x):
        x2 = lazy_mul(F, x, x)
        x4 = lazy_mul(F, x2, x2)
        return lazy_mul(F, lazy_mul(F, x4, x2), x)

    def full(s, off):
        return ext_chain([sbox(add(v, rc[off + j])) for j, v in enumerate(s)], add)

    s = ext_chain(s, add)
    for r in range(half):
        s = full(s, r * t)
    for r in range(h.partial_rounds):
        s = [sbox(add(s[0], rc[half * t + r]))] + s[1:]
        s = int_chain(s, add, lambda i, v: lazy_mul(F, diag[i], v))
    for r in range(half):
        s = full(s, half * t + h.partial_rounds + r * t)
    return s


@pytest.mark.parametrize("t", [2, 8])
def test_permutation_in_the_model_is_the_plain_version(t):
    """One permutation a row (n = t, no tag) in the model, the state lazy
    and the digest made canonical at the end, equals the port's
    `hash_fields_ref` on numpy-seeded rows and rows of 0 and p - 1."""
    f = get_field("goldilocks")
    h = Poseidon2(f, t)
    rng = np.random.default_rng(100 + t)
    rows = [[0] * t, [P - 1] * t] + [[int(v) % P for v in rng.integers(0, 1 << 64, t,
                                                                       dtype=np.uint64)]
                                     for _ in range(4)]
    want = f.to_ints(h.hash_fields_ref(f.from_ints(rows, "cpu")))
    F = Flag()
    got = [canonical(F, permute_model(F, h, list(row))[1]) for row in rows]
    assert got == [int(v) for v in want]
    # the permutation adds and multiplies: every site but lazy_sub's
    assert F.hits == {s for s in DROP_SITES if not s.startswith("lazy_sub")}
