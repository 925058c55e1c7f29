"""The arithmetic of B3's and B4's wide instances (icicle_tpu_torch/kernels/
csrc/ec_wide.cuh, also under precompute_bases, the 8-limb Poseidon and the
ECNTT kernel), modelled word by word on the CPU.

The CUDA source cannot run here, so this file keeps a Python model of its
multiply, add, subtract and canonical form that follows the source step
for step: the same limb order, the two accumulators of the multiply (even
limbs at word offset 0, odd limbs at offset 1) with their roles swapped a
word at a time, and PTX's carry flag as one bit that each `.cc` step writes
and each `c` step reads. Every place where the source ends a chain without
taking its carry out (an instruction without `.cc`, marked "carry out:
none" there) is a named site here, and the model asserts there that the
carry it drops is what the source says it is. Each function is held to
Python-int arithmetic mod p (a b R^-1 for the multiply) on the base fields
of every wide instance: bls12_377, bls12_381 and bw6_761 Fq, and bn254 Fq
(the base field of Fp2<8>), with edge values and numpy-seeded values in
[0, 2p), the lazy range. The ECNTT's projective doubling (ec_wide.cuh
pdbl, RCB15 Alg 9) runs over the model and is held to the port's plain
group doubling; B4's projective add (ec_wide.cuh padd_row, RCB15 Alg 7
ordered for registers) runs over the model and is held to the port's
plain group add.
"""

from __future__ import annotations

import os
import re
import shutil

import numpy as np
import pytest
import torch

from icicle_tpu_torch.curves.group import get_group
from icicle_tpu_torch.curves.params import get_curve
from icicle_tpu_torch.kernels import build, msm_lib

MASK = 0xFFFFFFFF
CSRC = build.CSRC
WIDE_HEADER = os.path.join(CSRC, "ec_wide.cuh")
WIDE_SCANS = ("msm_scan_l12", "msm_scan_l24", "msm_scan_fp2", "msm_scan_fp2_l12")
WIDE_REDUCES = ("ec_reduce_l12", "ec_reduce_l24", "ec_reduce_fp2", "ec_reduce_fp2_l12")
# every library whose source includes ec_wide.cuh: B3's and B4's wide
# instances, precompute_bases (both), the 8-limb Poseidon, the ECNTT
# (every limb count) and the NTT row kernel (both libraries)
WIDE_LIBRARIES = WIDE_SCANS + WIDE_REDUCES + ("precompute_bases", "precompute_bases_fp2",
                                              "poseidon_limbs", "ecntt", "ecntt_l12", "ecntt_l24",
                                              "ntt_wide", "ntt_wide_l12")
WIDE_SOURCES = {"msm_scan.cu", "ec_reduce.cu", "precompute_bases.cu", "poseidon_limbs.cu",
                "ecntt.cu", "ntt_wide.cu"}
# the sources that include ec_wide.cuh only at 12 or more words a
# coordinate, and their 8-limb G1 libraries, which do not
GATED = {"msm_scan.cu": ("msm_scan", WIDE_SCANS), "ec_reduce.cu": ("ec_reduce", WIDE_REDUCES)}
# (curve, limbs) of each wide instance's base field
FIELDS = (("bls12_377", 12), ("bls12_381", 12), ("bw6_761", 24), ("bn254", 8))
# the sites where ec_wide.cuh drops a chain's carry out, and the carry it drops
DROP_SITES = ("add: the sum", "sub: the borrow", "mul_step: odd's product row",
              "mul_step: acc's product carry", "mul_step: odd's reduction row",
              "mul_step: acc's reduction carry", "mul: the merge")


class Flag:
    """PTX's carry flag and the primitives of ec_wide.cuh that use it; the
    forms without .cc that end a chain name their site and the carry out
    they drop (0, unless the source says otherwise)."""

    def __init__(self):
        self.cf = 0
        self.hits = set()

    @staticmethod
    def _words(*xs):
        assert all(0 <= x <= MASK for x in xs), xs

    def _drop(self, t: int, site: str, dropped: int = 0) -> int:
        assert site in DROP_SITES, site
        assert t >> 32 == dropped, f"{site}: carry out {t >> 32}, the source drops {dropped}"
        self.hits.add(site)
        return t & MASK

    def add_cc(self, a, b):
        self._words(a, b)
        t = a + b
        self.cf = t >> 32
        return t & MASK

    def addc_cc(self, a, b):
        self._words(a, b)
        t = a + b + self.cf
        self.cf = t >> 32
        return t & MASK

    def addc(self, a, b, site, dropped=0):
        self._words(a, b)
        return self._drop(a + b + self.cf, site, dropped)

    def sub_cc(self, a, b):
        self._words(a, b)
        t = a - b
        self.cf = int(t < 0)
        return t & MASK

    def subc_cc(self, a, b):
        self._words(a, b)
        t = a - b - self.cf
        self.cf = int(t < 0)
        return t & MASK

    def subc(self, a, b):          # reads the flag only: subc(0, 0) is -borrow
        self._words(a, b)
        return (a - b - self.cf) & MASK

    def mad_lo_cc(self, a, b, c):
        self._words(a, b, c)
        t = (a * b & MASK) + c
        self.cf = t >> 32
        return t & MASK

    def madc_lo_cc(self, a, b, c):
        self._words(a, b, c)
        t = (a * b & MASK) + c + self.cf
        self.cf = t >> 32
        return t & MASK

    def madc_hi_cc(self, a, b, c):
        self._words(a, b, c)
        t = (a * b >> 32) + c + self.cf
        self.cf = t >> 32
        return t & MASK

    def madc_hi(self, a, b, c, site):
        self._words(a, b, c)
        return self._drop((a * b >> 32) + c + self.cf, site)


class Base:
    """A base field's BaseConsts (ec_wide.cuh): p, 2p, R mod p, inv32."""

    def __init__(self, curve: str, L: int):
        fq = get_curve(curve).fq
        self.L = L
        self.p = fq.modulus
        self.R = 1 << (32 * L)
        self.inv32 = (-pow(self.p, -1, 1 << 32)) % (1 << 32)
        self.pw = words(self.p, L)
        self.p2w = words(2 * self.p, L)


def words(x: int, L: int) -> list:
    assert 0 <= x < 1 << (32 * L)
    return [(x >> (32 * j)) & MASK for j in range(L)]


def value(w: list) -> int:
    return sum(x << (32 * j) for j, x in enumerate(w))


# -- the model: ec_wide.cuh's functions, line for line ------------------------

def add(F: Flag, a, b, f: Base):
    L = f.L
    s = [F.add_cc(a[0], b[0])]
    s += [F.addc_cc(a[j], b[j]) for j in range(1, L - 1)]
    s.append(F.addc(a[L - 1], b[L - 1], "add: the sum"))
    d = [F.sub_cc(s[0], f.p2w[0])]
    d += [F.subc_cc(s[j], f.p2w[j]) for j in range(1, L)]
    keep = F.subc(0, 0)
    return [(s[j] & keep) | (d[j] & ~keep & MASK) for j in range(L)]


def sub(F: Flag, a, b, f: Base):
    L = f.L
    d = [F.sub_cc(a[0], b[0])]
    d += [F.subc_cc(a[j], b[j]) for j in range(1, L)]
    back = F.subc(0, 0)
    borrow = back & 1
    r = [F.add_cc(d[0], f.p2w[0] & back)]
    r += [F.addc_cc(d[j], f.p2w[j] & back) for j in range(1, L - 1)]
    r.append(F.addc(d[L - 1], f.p2w[L - 1] & back, "sub: the borrow", dropped=borrow))
    return r


def canonical(F: Flag, a, f: Base):
    L = f.L
    d = [F.sub_cc(a[0], f.pw[0])]
    d += [F.subc_cc(a[j], f.pw[j]) for j in range(1, L)]
    keep = F.subc(0, 0)
    return [(a[j] & keep) | (d[j] & ~keep & MASK) for j in range(L)]


def mul_step(F: Flag, acc: list, odd: list, a, bi: int, f: Base, first: bool) -> None:
    L = f.L
    if first:
        for j in range(0, L, 2):
            acc[j], acc[j + 1] = a[j] * bi & MASK, a[j] * bi >> 32
            odd[j], odd[j + 1] = a[j + 1] * bi & MASK, a[j + 1] * bi >> 32
    else:
        acc[0] = F.add_cc(acc[0], odd[1])
        for j in range(0, L - 2, 2):
            odd[j] = F.madc_lo_cc(a[j + 1], bi, odd[j + 2])
            odd[j + 1] = F.madc_hi_cc(a[j + 1], bi, odd[j + 3])
        odd[L - 2] = F.madc_lo_cc(a[L - 1], bi, 0)
        odd[L - 1] = F.madc_hi(a[L - 1], bi, 0, "mul_step: odd's product row")
        acc[0] = F.mad_lo_cc(a[0], bi, acc[0])
        acc[1] = F.madc_hi_cc(a[0], bi, acc[1])
        for j in range(2, L, 2):
            acc[j] = F.madc_lo_cc(a[j], bi, acc[j])
            acc[j + 1] = F.madc_hi_cc(a[j], bi, acc[j + 1])
        odd[L - 1] = F.addc(odd[L - 1], 0, "mul_step: acc's product carry")
    mi = acc[0] * f.inv32 & MASK
    p = f.pw
    odd[0] = F.mad_lo_cc(p[1], mi, odd[0])
    odd[1] = F.madc_hi_cc(p[1], mi, odd[1])
    for j in range(2, L - 2, 2):
        odd[j] = F.madc_lo_cc(p[j + 1], mi, odd[j])
        odd[j + 1] = F.madc_hi_cc(p[j + 1], mi, odd[j + 1])
    odd[L - 2] = F.madc_lo_cc(p[L - 1], mi, odd[L - 2])
    odd[L - 1] = F.madc_hi(p[L - 1], mi, odd[L - 1], "mul_step: odd's reduction row")
    acc[0] = F.mad_lo_cc(p[0], mi, acc[0])
    acc[1] = F.madc_hi_cc(p[0], mi, acc[1])
    for j in range(2, L, 2):
        acc[j] = F.madc_lo_cc(p[j], mi, acc[j])
        acc[j + 1] = F.madc_hi_cc(p[j], mi, acc[j + 1])
    odd[L - 1] = F.addc(odd[L - 1], 0, "mul_step: acc's reduction carry")
    assert acc[0] == 0   # the reduction zeroes acc's word 0


def mul(F: Flag, a, b, f: Base):
    L = f.L
    assert L % 2 == 0
    e, o = [0] * L, [0] * L
    mul_step(F, e, o, a, b[0], f, True)
    mul_step(F, o, e, a, b[1], f, False)
    for i in range(2, L, 2):
        mul_step(F, e, o, a, b[i], f, False)
        mul_step(F, o, e, a, b[i + 1], f, False)
    r = [F.add_cc(e[0], o[1])]
    r += [F.addc_cc(e[j], o[j + 1]) for j in range(1, L - 1)]
    r.append(F.addc(e[L - 1], 0, "mul: the merge"))
    return r


def mul_small(F: Flag, x, s: int, f: Base):
    a = -s if s < 0 else s
    acc = x
    for bit in range(a.bit_length() - 2, -1, -1):
        acc = add(F, acc, acc, f)
        if (a >> bit) & 1:
            acc = add(F, acc, x, f)
    if s < 0:
        acc = sub(F, [0] * f.L, acc, f)
    return acc


def fp2_mul(F: Flag, a, b, f: Base, nr: int):
    """ec_wide.cuh fmul over Fp2<L> (Karatsuba, the sums' product first)."""
    (a0, a1), (b0, b1) = a, b
    t = mul(F, add(F, a0, a1, f), add(F, b0, b1, f), f)
    v0 = mul(F, a0, b0, f)
    v1 = mul(F, a1, b1, f)
    return (sub(F, v0, mul_small(F, v1, -nr, f), f), sub(F, t, add(F, v0, v1, f), f))


# -- the tests -----------------------------------------------------------------

def lazy_values(f: Base, count: int, seed: int) -> list:
    """Edge values of [0, 2p) and numpy-seeded ones: 0, 1, p - 1, R mod p,
    2p - 1, p, p + 1, then `count` uniform in [0, 2p)."""
    rng = np.random.default_rng(seed)
    edges = [0, 1, f.p - 1, f.R % f.p, 2 * f.p - 1, f.p, f.p + 1]
    rand = [int.from_bytes(rng.bytes(4 * f.L), "little") % (2 * f.p) for _ in range(count)]
    return edges + rand


@pytest.fixture(params=FIELDS, ids=[c for c, _ in FIELDS])
def field(request):
    return Base(*request.param)


def test_four_p_below_r_wherever_lazy(field):
    """Lazy reduction needs 4p < R = 2^(32 L): the launch checks the
    modulus's top two bits (lazy_ok), which says the same."""
    assert 4 * field.p < field.R
    assert (field.pw[-1] >> 30 == 0) == (4 * field.p < field.R)


def test_mul_is_montgomery_product(field):
    F = Flag()
    rinv = pow(field.R, -1, field.p)
    vals = lazy_values(field, 24, seed=field.L + field.p % 1000)
    for a in vals:
        for b in vals[:9] + [a]:
            r = mul(F, words(a, field.L), words(b, field.L), field)
            want = a * b * rinv % field.p
            assert value(r) < 2 * field.p and value(r) % field.p == want
            assert value(canonical(F, r, field)) == want
    assert {s for s in DROP_SITES if s.startswith("mul")} <= F.hits


def test_add_sub_stay_below_2p(field):
    F = Flag()
    vals = lazy_values(field, 40, seed=field.L * 7 + 1)
    for a, b in zip(vals, vals[::-1] + vals[:1]):
        s = add(F, words(a, field.L), words(b, field.L), field)
        d = sub(F, words(a, field.L), words(b, field.L), field)
        assert value(s) < 2 * field.p and value(s) % field.p == (a + b) % field.p
        assert value(d) < 2 * field.p and value(d) % field.p == (a - b) % field.p
        c = canonical(F, words(a, field.L), field)
        assert value(c) == a % field.p
    assert {"add: the sum", "sub: the borrow"} <= F.hits


@pytest.mark.parametrize("s", [12, -3, 3, 9, -51, 1, 5])
def test_mul_small(field, s):
    F = Flag()
    for x in lazy_values(field, 6, seed=abs(s)):
        r = mul_small(F, words(x, field.L), s, field)
        assert value(r) < 2 * field.p and value(r) % field.p == s * x % field.p


@pytest.mark.parametrize("curve", ["bn254", "bls12_381", "bls12_377"])
def test_fp2_mul(curve):
    """Fp2<L>'s Karatsuba over the lazy base multiply, against (a0 + a1 u)
    (b0 + b1 u) with u^2 = nr, each part times R^-1."""
    g = get_group(curve, g2=True)
    nr = g.coord_field.engine.w
    f = Base(curve, g.base_limbs)
    F = Flag()
    rinv = pow(f.R, -1, f.p)
    vals = lazy_values(f, 8, seed=3)
    for a0, a1, b0, b1 in zip(vals, vals[1:], vals[2:], vals[3:]):
        c0, c1 = fp2_mul(F, (words(a0, f.L), words(a1, f.L)), (words(b0, f.L), words(b1, f.L)),
                         f, nr)
        assert value(c0) < 2 * f.p and value(c0) % f.p == (a0 * b0 + nr * a1 * b1) * rinv % f.p
        assert value(c1) < 2 * f.p and value(c1) % f.p == (a0 * b1 + a1 * b0) * rinv % f.p


def pdbl(F: Flag, p, f: Base, b3: int):
    """ec_wide.cuh pdbl (RCB15 Alg 9, a = 0) over the model, line for line:
    p = (x, y, z) word lists, values in [0, 2p); b3 a small integer."""
    x, y, z = p
    t0 = mul(F, y, y, f)
    z3 = add(F, t0, t0, f)
    z3 = add(F, z3, z3, f)
    z3 = add(F, z3, z3, f)
    t1 = mul(F, y, z, f)
    t2 = mul_small(F, mul(F, z, z, f), b3, f)
    x3 = mul(F, t2, z3, f)
    y3 = add(F, t0, t2, f)
    z3 = mul(F, t1, z3, f)
    t1 = add(F, t2, t2, f)
    t2 = add(F, t1, t2, f)
    t0 = sub(F, t0, t2, f)
    y3 = add(F, mul(F, t0, y3, f), x3, f)
    x3 = mul(F, t0, mul(F, x, y, f), f)
    return add(F, x3, x3, f), y3, z3


@pytest.mark.parametrize("curve", ["bn254", "bls12_381", "bw6_761"])
def test_pdbl_is_the_plain_doubling(curve):
    """The ECNTT's doubling over the lazy model, its coordinates made
    canonical, equals the port's plain group doubling (Group.dbl, the same
    formula over canonical values) bit for bit on G1: the identity, a point
    with y = 0 (off the curve: the formula's values, not the group law, are
    compared), the generator and multiples of it in projective form with
    z != 1; each input both canonical and as its lazy representative plus
    p where that is below 2p (the values ecntt.cu's ladders hand it)."""
    from icicle_tpu_torch.curves.group import Projective
    g = get_group(curve)
    f = Base(curve, g.nlimbs)
    L = f.L
    b3 = msm_lib.b3_small(g)
    F = Flag()
    R = f.R % f.p
    rng = np.random.default_rng(f.L)
    gx, gy = (int(v) for v in g.gen_int)               # Montgomery form
    pts = [(0, R, 0), (gx, 0, R), (gx, gy, R)]
    for _ in range(3):                                  # (lambda x, lambda y, lambda)
        lam = int.from_bytes(rng.bytes(4 * L), "little") % f.p
        pts.append((gx * lam % f.p, gy * lam % f.p, lam))

    def tensor(vals):
        w = np.array([words(v, L) for v in vals], dtype=np.uint32).view(np.int32)
        return torch.from_numpy(w.copy())

    want = g.dbl(Projective(*(tensor([p[i] for p in pts]) for i in range(3))))
    want = [[value([int(w) & MASK for w in row]) for row in c.tolist()] for c in want]
    for lift in (0, 1):
        for i, p in enumerate(pts):
            lazy = [v + f.p if lift and v + f.p < 2 * f.p else v for v in p]
            out = pdbl(F, [words(v, L) for v in lazy], f, b3)
            got = [value(canonical(F, c, f)) for c in out]
            assert got == [want[c][i] for c in range(3)], (curve, i, lift)


def padd_row(F: Flag, p, q, f: Base, b3: int):
    """ec_wide.cuh padd_row (RCB15 Alg 7, a = 0) over the model, line for
    line in the source's order: p the accumulator, q the row, each a list
    of (x, y, z) word lists with values in [0, 2p)."""
    x1, y1, z1 = p
    x2, y2, z2 = q
    t0 = mul(F, x1, x2, f)
    sxy = add(F, x1, y1, f)
    sxz = add(F, x1, z1, f)
    t1 = mul(F, y1, y2, f)
    syz = add(F, y1, z1, f)
    t3 = sub(F, mul(F, sxy, add(F, x2, y2, f), f), add(F, t0, t1, f), f)
    t2 = mul(F, z1, z2, f)
    t4 = sub(F, mul(F, syz, add(F, y2, z2, f), f), add(F, t1, t2, f), f)
    y3 = sub(F, mul(F, sxz, add(F, x2, z2, f), f), add(F, t0, t2, f), f)
    t0 = add(F, add(F, t0, t0, f), t0, f)
    t2 = mul_small(F, t2, b3, f)
    z3 = add(F, t1, t2, f)
    t1 = sub(F, t1, t2, f)
    y3 = mul_small(F, y3, b3, f)
    return (sub(F, mul(F, t3, t1, f), mul(F, t4, y3, f), f),
            add(F, mul(F, t1, z3, f), mul(F, y3, t0, f), f),
            add(F, mul(F, z3, t4, f), mul(F, t0, t3, f), f))


@pytest.mark.parametrize("curve", ["bls12_381", "bls12_377", "bw6_761"])
def test_padd_row_is_the_plain_add(curve):
    """B4's add over the lazy model, its coordinates made canonical, equals
    the port's plain group add (Group.add, RCB15 Alg 7 in its own order
    over canonical values) bit for bit on the wide G1 curves: sums with the
    identity on either side, a point with itself, a point with its
    negative and multiples of the generator in projective form with z != 1;
    each input both canonical and as its lazy representative plus p where
    that is below 2p (the values ec_reduce.cu's accumulators and partials
    hold)."""
    from icicle_tpu_torch.curves.group import Projective
    g = get_group(curve)
    f = Base(curve, g.nlimbs)
    L = f.L
    b3 = msm_lib.b3_small(g)
    F = Flag()
    R = f.R % f.p
    rng = np.random.default_rng(f.L + 5)
    gx, gy = (int(v) for v in g.gen_int)               # Montgomery form
    ident = (0, R, 0)

    def scaled(x, y, z):
        lam = int.from_bytes(rng.bytes(4 * L), "little") % f.p
        return (x * lam % f.p, y * lam % f.p, z * lam % f.p)

    gen = scaled(gx, gy, R)
    two = tuple(value(canonical(F, c, f)) for c in pdbl(F, [words(v, L) for v in gen], f, b3))
    pairs = [(ident, ident), (ident, gen), (gen, ident), (gen, scaled(*gen)),
             (gen, scaled(gx, f.p - gy, R)), (two, gen), (scaled(*two), scaled(*gen))]

    def tensor(vals):
        w = np.array([words(v, L) for v in vals], dtype=np.uint32).view(np.int32)
        return torch.from_numpy(w.copy())

    want = g.add(*(Projective(*(tensor([pq[s][i] for pq in pairs]) for i in range(3)))
                   for s in (0, 1)))
    want = [[value([int(w) & MASK for w in row]) for row in c.tolist()] for c in want]
    for lift in (0, 1):
        for i, (p, q) in enumerate(pairs):
            lazy = [[words(v + f.p if lift and v + f.p < 2 * f.p else v, L) for v in pt]
                    for pt in (p, q)]
            out = padd_row(F, *lazy, f, b3)
            got = [value(canonical(F, c, f)) for c in out]
            assert got == [want[c][i] for c in range(3)], (curve, i, lift)


def test_model_names_every_site_the_source_drops_a_carry():
    """ec_wide.cuh marks each chain end without a carry out "carry out:
    none"; the model has one named site for each, and every one is reached
    (and its dropped carry checked) by the tests above on bls12_381."""
    text = open(WIDE_HEADER).read()
    assert text.count("// carry out: none") == len(DROP_SITES)
    for fn in ("add", "sub", "mul_step", "mul"):
        body = re.search(rf"\b{fn}\(.*?\n\}}\n", text[text.index("-- Fp<L>"):], re.S).group(0)
        assert body.count("// carry out: none") == sum(s.startswith(f"{fn}:") for s in DROP_SITES)
    F = Flag()
    f = Base("bls12_381", 12)
    a, b = words(2 * f.p - 1, 12), words(f.p + 1, 12)
    mul(F, a, b, f)
    add(F, a, b, f)
    sub(F, b, a, f)
    assert F.hits == set(DROP_SITES)


def test_build_gives_the_wide_header_to_the_four_wide_libraries():
    """ec_wide.cuh is a dependency of exactly the libraries that include
    it: B3's and B4's four wide instances each, both precompute_bases
    libraries, the 8-limb Poseidon and the three ECNTT libraries; bn254's
    libmsm_scan and libec_reduce neither depend on it nor compile it (their
    limb count times degree is below 12, the condition of msm_scan.cu and
    ec_reduce.cu). build.WIDE_SCANS are B3's four, build.WIDE_REDUCES
    B4's."""
    with_header = {name for name in build.LIBRARIES
                   if any(p.endswith("ec_wide.cuh") for p in build._inputs(name))}
    assert with_header == set(WIDE_LIBRARIES)
    assert set(build.WIDE_SCANS) == set(WIDE_SCANS)
    assert set(build.WIDE_REDUCES) == set(WIDE_REDUCES)
    assert os.path.exists(WIDE_HEADER)

    def words_a_coordinate(name):
        flags = dict(re.match(r"-D(\w+)=(\d+)", d).groups() for d in build.DEFINES.get(name, []))
        return int(flags.get("ICICLE_EC_LIMBS", 8)) * int(flags.get("ICICLE_EC_DEGREE", 1))

    guard = "#if ICICLE_EC_LIMBS * ICICLE_EC_DEGREE >= 12"
    for source, (narrow, wide) in GATED.items():
        assert all(words_a_coordinate(n) >= 12 for n in wide)
        assert words_a_coordinate(narrow) == 8
        src = open(os.path.join(CSRC, source)).read()
        at = src.index(guard)
        assert at < src.index('#include "ec_wide.cuh"') < src.index("#else", at), source
    kernel = {"msm_scan.cu": "prefix_scan", "ec_reduce.cu": "ec_reduce"}
    for source, (narrow, wide) in GATED.items():
        libs = {*msm_lib.KERNELS[kernel[source]][0].values(),
                *msm_lib.FP2_KERNELS[kernel[source]].values()}
        assert libs == {narrow, *wide}
        assert all(build.LIBRARIES[n] == [source] for n in libs)
    assert {build.LIBRARIES[n][0] for n in WIDE_LIBRARIES} == WIDE_SOURCES


@pytest.mark.parametrize("name", sorted(build.LIBRARIES))
def test_a_newer_wide_header_rebuilds_only_its_libraries(tmp_path, monkeypatch, name):
    """A change to ec_wide.cuh makes the libraries that include it stale
    (B3's and B4's four wide instances each, precompute_bases,
    precompute_bases_fp2, poseidon_limbs, ecntt, ecntt_l12, ecntt_l24,
    ntt_wide, ntt_wide_l12), and no other (build.py's staleness rule over a temp copy of csrc/)."""
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", str(csrc))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "build"))
    os.makedirs(tmp_path / "build")
    lib = build.lib_path(name)
    open(lib, "w").close()
    for f in os.listdir(csrc):
        os.utime(csrc / f, (1_000, 1_000))
    os.utime(lib, (2_000, 2_000))
    assert not build._stale(name)
    os.utime(csrc / "ec_wide.cuh", (3_000, 3_000))
    assert build._stale(name) == (name in WIDE_LIBRARIES)


def test_only_msm_scan_includes_the_wide_header():
    """Only the sources that build.HEADERS gives ec_wide.cuh to include it:
    msm_scan.cu, ec_reduce.cu, precompute_bases.cu, poseidon_limbs.cu,
    ecntt.cu and ntt_wide.cu (build.WIDE_SOURCES and build.GATED_SOURCES), so no other
    source misses a rebuild when the header changes. (The name predates
    ec_reduce.cu's wide instances.)"""
    including = {f for f in os.listdir(CSRC) if f.endswith((".cu", ".cuh"))
                 and '#include "ec_wide.cuh"' in open(os.path.join(CSRC, f)).read()}
    assert including == WIDE_SOURCES
    assert including == set(build.WIDE_SOURCES) | set(build.GATED_SOURCES)


def test_ec_reduce_source_takes_the_wide_formulas():
    """ec_reduce.cu's wide kernel, under the 12-word gate, adds with
    ec_wide.cuh's padd_row (rows and the tree's partials), stores through
    store_canonical and is launched after lazy_ok; its 8-limb kernel keeps
    ec_field.cuh's padd over load_pt and its plain store, launched in its
    blocks of kSplitThreads, outside the gate."""
    src = open(os.path.join(CSRC, "ec_reduce.cu")).read()
    code = "\n".join(line.split("//")[0] for line in src.splitlines())
    start = code.index("template <class C>\n__global__")
    narrow = code[start:code.index("\n}\n", start)]
    assert "padd(acc, load_pt<F>(in +" in narrow and "padd(acc, load_pt<F>(part +" in narrow
    assert "store_pt<F>(out + lane, row, acc)" in narrow and "wide::" not in narrow
    gates = [m.start() for m in re.finditer(r"#if ICICLE_EC_WIDE\n", code)]
    assert len(gates) == 2
    wide_kernel = code[gates[0]:code.index("#endif", gates[0])]
    assert "wide_ec_reduce_kernel" in wide_kernel
    assert wide_kernel.count("wide::padd_row(acc,") == 2
    assert "wide::store_canonical(out + lane, row, acc, q)" in wide_kernel
    assert "padd(acc, load_pt" not in wide_kernel
    launch = code[gates[1]:code.index("#endif", gates[1])]
    wide_launch, narrow_launch = launch.split("#else")
    assert "wide::lazy_ok" in wide_launch and "wide_ec_reduce_kernel<Q>" in wide_launch
    assert "wide::kWideSplitThreads" in wide_launch
    assert "ec_reduce_kernel<Consts>, kSplitThreads" in narrow_launch


@pytest.mark.parametrize("curve, g2", [("bls12_377", False), ("bls12_381", False),
                                       ("bw6_761", False), ("bw6_761", True), ("bn254", True),
                                       ("bls12_377", True), ("bls12_381", True)])
def test_every_wide_reduce_group_has_two_spare_bits(curve, g2):
    """ec_reduce.cu's wide kernel computes over lazy values and its launch
    refuses a modulus without two spare bits (lazy_ok): the base field of
    every group that reaches a wide library (bls12_377 and bls12_381 G1
    and G2, bw6_761 G1 and G2, bn254 G2) has them."""
    g = get_group(curve, g2=g2)
    msm_lib.require_instance("ec_reduce", g)
    nl, degree = msm_lib.instance(g)
    assert msm_lib.libraries("ec_reduce", degree)[nl] in WIDE_REDUCES
    f = Base(curve, g.base_limbs)
    assert 4 * f.p < f.R and f.pw[-1] >> 30 == 0


@pytest.mark.parametrize("name, limbs, degree", [("msm_scan", 8, 1), ("msm_scan_l24", 24, 1),
                                                 ("msm_scan_fp2_l12", 12, 2)])
def test_define_reads_a_library_s_flags(name, limbs, degree):
    assert build.define(name, "ICICLE_EC_LIMBS", 8) == limbs
    assert build.define(name, "ICICLE_EC_DEGREE", 1) == degree


PTXAS = """\
ptxas info    : Compiling entry function '_ZN4wide23wide_scan_reduce_kernelEv' for 'sm_90a'
ptxas info    : Function properties for _ZN4wide23wide_scan_reduce_kernelEv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 188 registers, used 0 barriers, 420 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN4wide18wide_rescan_kernelEv' for 'sm_90a'
ptxas info    : Function properties for _ZN4wide18wide_rescan_kernelEv
    216 bytes stack frame, 212 bytes spill stores, 180 bytes spill loads
ptxas info    : Used 255 registers, used 0 barriers, 216 bytes cumulative stack size
"""


def test_ptxas_kernels_reads_each_pass():
    """build.ptxas_kernels: ptxas -v's registers, spills and stack under
    the passes' short names; a pass the report lacks is left out."""
    got = build.ptxas_kernels(PTXAS, ("scan_reduce", "carry_scan", "rescan"))
    assert got == {"scan_reduce": {"registers": 188, "spill_stores": 0, "spill_loads": 0,
                                   "stack": 0},
                   "rescan": {"registers": 255, "spill_stores": 212, "spill_loads": 180,
                              "stack": 216}}


@pytest.mark.parametrize("trips", [1, 11])
def test_outer_loop_counts_one_slot(trips):
    """sass.outer_loop: one trip of the outermost loop, each block once
    but a nested loop that multiplies at `trips`; blocks before the loop
    are not counted."""
    from icicle_tpu_torch.kernels import sass

    blks = [{"start": 0, "counts": {"MOV": 5}, "branch_to": None},
            {"start": 16, "counts": {"IADD3": 2}, "branch_to": None},
            {"start": 32, "counts": {"IMAD.WIDE": 4, "IADD3": 1}, "branch_to": None},
            {"start": 48, "counts": {"BRA": 1}, "branch_to": 32},
            {"start": 64, "counts": {"STG": 3, "BRA": 1}, "branch_to": 16},
            {"start": 80, "counts": {"EXIT": 1}, "branch_to": None}]
    assert sass.outer_loop(blks, trips) == {"BRA": trips + 1, "IADD3": 2 + trips,
                                            "IMAD.WIDE": 4 * trips, "STG": 3}


@pytest.mark.parametrize("curve", ["bn254", "grumpkin", "bls12_377", "bls12_381", "bw6_761"])
def test_every_ecntt_curve_has_two_spare_bits(curve):
    """ecntt.cu computes over ec_wide.cuh's lazy values and its launch
    refuses a modulus without two spare bits (lazy_ok): every G1 curve the
    wrapper sends to a library has them, at that library's limb count."""
    from icicle_tpu_torch.kernels import ecntt_kernel as EK
    g = get_group(curve)
    EK.require_instance(g)
    f = Base(curve, g.nlimbs)
    assert f.L in EK.LIBRARIES and 4 * f.p < f.R and f.pw[-1] >> 30 == 0


def test_ecntt_source_takes_the_wide_formulas():
    """ecntt.cu's add and doubling are ec_wide.cuh's padd and pdbl, its
    beta product the wide multiply, every store canonical: no
    ec_field.cuh field operation is left in it."""
    src = open(os.path.join(CSRC, "ecntt.cu")).read()
    code = "\n".join(line.split("//")[0] for line in src.splitlines())
    for call in ("wide::padd<K>", "wide::pdbl<K>", "wide::mul<L>", "wide::canonical<L>",
                 "wide::lazy_ok"):
        assert call in code, call
    for old in ("mont_mul", "add_mod", "sub_mod", "dbl<C>", "padd<C>"):
        assert old not in code, old


@pytest.mark.parametrize("curve, g2, R, C, S", [
    ("bls12_381", False, 2048, 2048, 16),   # M1's cross-tile sum (S 32 at TARGET_THREADS)
    ("bn254", True, 512, 4096, 8),          # E1's (16)
    ("bw6_761", False, 128, 8192, 4),       # M2's (8)
    ("bls12_381", True, 128, 8192, 4),      # E2's and E3's (8)
    ("bw6_761", True, 128, 8192, 4),
    ("bls12_381", False, 8, 3072, 8),       # bucket pass 1: capped at R
    ("bls12_381", False, 128, 24, 32),      # bucket pass 2: capped at 32
    ("bn254", False, 2048, 2048, 32),       # the 8-limb instance keeps its plan
])
def test_wide_reduce_plan_is_one_wave(curve, g2, R, C, S):
    """ec_reduce's segment plan: a group over a wide library aims at
    ONE_WAVE_THREADS (one wave of two 128-thread blocks an SM), the 8-limb
    G1 instance at TARGET_THREADS; the wrapper on a CPU tensor computes the
    plain version at that plan."""
    from icicle_tpu_torch.kernels import ec_reduce as TR
    g = get_group(curve, g2=g2)
    assert TR.reduce_segments(R, C, TR.plan_threads(g)) == S
    assert TR.plan_threads(g) == (msm_lib.ONE_WAVE_THREADS if g.nlimbs >= 12
                                  else msm_lib.TARGET_THREADS)
