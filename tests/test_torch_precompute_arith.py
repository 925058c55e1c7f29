"""The arithmetic and the batch inversion of the precompute_bases kernel
(icicle_tpu_torch/kernels/csrc/precompute_bases.cu over ec_wide.cuh),
modelled on the CPU.

The CUDA source cannot run here. Two models stand in for it:
- word by word: ec_wide.cuh's Jacobian doubling `jdbl` and the Fp2
  complex squaring `fsqr`, over the multiply, add and subtract of
  tests/test_torch_msm_wide_arith.py (PTX's carry flag as one bit, values
  lazy in [0, 2p)), held to the host's affine doubling (`host_ops`) on
  every group the kernel is built for, the identity included;
- element by element: the kernel's steps as it arranges them (a thread a
  point, blocks of kThreads, the copies' Z multiplied forward, the
  block's product tree with one Fermat power at its root, the walk back,
  the products to affine that leave Montgomery form), over Montgomery
  products of Python ints, held to `precompute_bases_ref` bit for bit on a
  block with identity lanes and a tail past n, at nu = 2 and 23.
"""

from __future__ import annotations

import re

import numpy as np
import pytest

from icicle_tpu_torch.curves.group import get_group
from icicle_tpu_torch.curves.host_ec import host_ops, scalar_mul
from icicle_tpu_torch.kernels import build
from icicle_tpu_torch.kernels import precompute_kernel as PB
from tests.test_torch_msm_wide_arith import Base, Flag, add, mul, mul_small, sub, value, words

# (curve, g2) of every group precompute_bases is built for: G1 at 8, 12 and
# 24 limbs, G2 over Fp2<8> and Fp2<12>, and bw6_761's G2 over Fq
GROUPS = (("bn254", False), ("bls12_377", False), ("bls12_381", False), ("bw6_761", False),
          ("bn254", True), ("bls12_381", True), ("bls12_377", True), ("bw6_761", True))
IDS = [f"{c}{'_g2' if g2 else ''}" for c, g2 in GROUPS]


def kernel_threads() -> int:
    text = open(f"{build.CSRC}/precompute_bases.cu").read()
    return int(re.search(r"constexpr int kThreads = (\d+);", text).group(1))


def generator(g):
    p = g.curve.params
    if not g.g2:
        return g.curve.gen_x, g.curve.gen_y
    return (p.g2_gen_x, p.g2_gen_y) if g.degree == 2 else (p.g2_gen_x[0], p.g2_gen_y[0])


def points(g, count: int, seed: int) -> list:
    """`count` affine points k G of group g, numpy-seeded k."""
    rng = np.random.default_rng(seed)
    G = generator(g)
    return [scalar_mul(g, G, int(k)) for k in rng.integers(2, 1 << 40, count)]


# -- word by word: ec_wide.cuh's jdbl and fsqr ---------------------------------

class Words:
    """ec_wide.cuh's coordinate field for group g in the word model: Fp<L>
    as a list of L words, Fp2<L> as a (c0, c1) pair of them."""

    def __init__(self, g):
        self.f = Base(g.curve.name, g.base_limbs)
        self.degree = g.degree
        self.nr = g.coord_field.engine.w if g.degree == 2 else None
        self.F = Flag()

    def _map(self, fn, *xs):
        if self.degree == 1:
            return fn(*xs)
        return tuple(fn(*parts) for parts in zip(*xs))

    def add(self, a, b):
        return self._map(lambda x, y: add(self.F, x, y, self.f), a, b)

    def sub(self, a, b):
        return self._map(lambda x, y: sub(self.F, x, y, self.f), a, b)

    def mul(self, a, b):
        F, f = self.F, self.f
        if self.degree == 1:
            return mul(F, a, b, f)
        (a0, a1), (b0, b1) = a, b          # ec_wide.cuh fmul: Karatsuba
        t = mul(F, add(F, a0, a1, f), add(F, b0, b1, f), f)
        v0, v1 = mul(F, a0, b0, f), mul(F, a1, b1, f)
        return (sub(F, v0, mul_small(F, v1, -self.nr, f), f), sub(F, t, add(F, v0, v1, f), f))

    def sqr(self, a):
        """ec_wide.cuh fsqr: the multiply over Fp; over Fp2 v = a0 a1, c0 =
        (a0 + a1)(a0 + nr a1) - (1 + nr) v, c1 = 2 v."""
        F, f, nr = self.F, self.f, self.nr
        if self.degree == 1:
            return mul(F, a, a, f)
        a0, a1 = a
        v = mul(F, a0, a1, f)
        t = mul(F, add(F, a0, a1, f), sub(F, a0, mul_small(F, a1, -nr, f), f), f)
        c0 = t if nr == -1 else sub(F, t, mul_small(F, v, 1 + nr, f), f)
        return (c0, add(F, v, v, f))

    def jdbl(self, P):
        """ec_wide.cuh jdbl, line for line."""
        X, Y, Z = P
        z3 = self.mul(Y, Z)
        z3 = self.add(z3, z3)
        a = self.sqr(X)
        b = self.sqr(Y)
        d = self.sqr(self.add(X, b))
        c = self.sqr(b)
        d = self.sub(self.sub(d, a), c)
        d = self.add(d, d)
        e = self.add(self.add(a, a), a)
        x3 = self.sub(self.sqr(e), self.add(d, d))
        c8 = self.add(c, c)
        c8 = self.add(c8, c8)
        c8 = self.add(c8, c8)
        return x3, self.sub(self.mul(e, self.sub(d, x3)), c8), z3

    # Python ints <-> the model's words, Montgomery form
    def mont(self, v, lift: bool = False):
        f = self.f

        def one(x):
            m = x * f.R % f.p
            return words(m + f.p if lift and m + f.p < 2 * f.p else m, f.L)
        return one(v) if self.degree == 1 else tuple(one(x) for x in v)

    def plain(self, w):
        f = self.f
        rinv = pow(f.R, -1, f.p)

        def one(x):
            assert value(x) < 2 * f.p           # lazy: [0, 2p)
            return value(x) * rinv % f.p
        return one(w) if self.degree == 1 else tuple(one(x) for x in w)


def jacobian_to_affine(g, X, Y, Z):
    p = g.curve.fq.modulus
    if g.degree == 1:
        if Z == 0:
            return (0, 0)
        zi = pow(Z, -1, p)
        return (X * zi * zi % p, Y * zi * zi * zi % p)
    nr = g.coord_field.engine.w

    def m(a, b):
        return ((a[0] * b[0] + nr * a[1] * b[1]) % p, (a[0] * b[1] + a[1] * b[0]) % p)
    if Z == (0, 0):
        return ((0, 0), (0, 0))
    norm = (Z[0] * Z[0] - nr * Z[1] * Z[1]) % p
    ni = pow(norm, -1, p)
    zi = (Z[0] * ni % p, -Z[1] * ni % p)
    zi2 = m(zi, zi)
    return (m(X, zi2), m(Y, m(zi2, zi)))


@pytest.mark.parametrize("curve, g2", GROUPS, ids=IDS)
def test_jacobian_doubling_equals_group_dbl(curve, g2):
    """Chains of jdbl over lazy values from (x, y, 1), and from a scaled
    Z (x l^2, y l^3, l), equal the host's affine doublings; every
    coordinate stays in [0, 2p) (Words.plain checks)."""
    g = get_group(curve, g2=g2)
    W = Words(g)
    dbl = host_ops(g)[1]
    p = g.curve.fq.modulus
    for k, P in enumerate(points(g, 2, seed=len(curve) + g2)):
        want = P
        if g.degree == 1:
            lam = 3 + k
            cur = (W.mont(P[0] * lam ** 2 % p, lift=True), W.mont(P[1] * lam ** 3 % p),
                   W.mont(lam, lift=True))
        else:
            cur = (W.mont(P[0], lift=True), W.mont(P[1]), W.mont((1, 0), lift=True))
        for _ in range(3):
            cur = W.jdbl(cur)
            want = dbl(want)
            assert jacobian_to_affine(g, *(W.plain(c) for c in cur)) == want


@pytest.mark.parametrize("curve, g2", GROUPS, ids=IDS)
def test_jacobian_doubling_keeps_the_identity(curve, g2):
    """Z = 0 in (as the kernel enters the identity: x = y = 0 in Montgomery
    form, Z = 0; and with any X, Y) stays Z = 0 out, over chains."""
    g = get_group(curve, g2=g2)
    W = Words(g)
    zero = 0 if g.degree == 1 else (0, 0)
    some = 5 if g.degree == 1 else (5, 7)
    for start in ((W.mont(zero), W.mont(zero), W.mont(zero)),
                  (W.mont(some), W.mont(some, lift=True), W.mont(zero, lift=True))):
        cur = start
        for _ in range(2):
            cur = W.jdbl(cur)
            assert W.plain(cur[2]) == zero


@pytest.mark.parametrize("curve", ["bn254", "bls12_381", "bls12_377"])
def test_fp2_complex_squaring(curve):
    """fsqr over Fp2 (2 base products) equals a^2 with u^2 = nr, times
    R^-1, and stays in [0, 2p)."""
    g = get_group(curve, g2=True)
    W = Words(g)
    p, nr = W.f.p, W.nr
    rng = np.random.default_rng(7)
    for _ in range(6):
        a = tuple(int.from_bytes(rng.bytes(4 * W.f.L), "little") % (2 * p) for _ in range(2))
        c0, c1 = W.sqr(tuple(words(x, W.f.L) for x in a))
        rinv = pow(W.f.R, -1, p)
        assert value(c0) < 2 * p and value(c1) < 2 * p
        assert value(c0) % p == (a[0] * a[0] + nr * a[1] * a[1]) * rinv % p
        assert value(c1) % p == 2 * a[0] * a[1] * rinv % p


# -- element by element: the kernel's arrangement ---------------------------------

class Elements:
    """The kernel's coordinate field for group g, as Montgomery-form
    Python ints (an int, or a (c0, c1) pair over Fp2): each product
    a b R^-1 mod p, the values the kernel's lazy words stand for."""

    def __init__(self, g):
        self.p = g.curve.fq.modulus
        self.R = 1 << (32 * g.base_limbs)
        self.rinv = pow(self.R, -1, self.p)
        self.degree = g.degree
        self.nr = g.coord_field.engine.w if g.degree == 2 else None
        self.one_b = self.R % self.p
        self.one = self.one_b if g.degree == 1 else (self.one_b, 0)
        self.zero = 0 if g.degree == 1 else (0, 0)

    def bmul(self, a, b):
        return a * b * self.rinv % self.p

    def mul(self, a, b):
        if self.degree == 1:
            return self.bmul(a, b)
        return ((self.bmul(a[0], b[0]) + self.nr * self.bmul(a[1], b[1])) % self.p,
                (self.bmul(a[0], b[1]) + self.bmul(a[1], b[0])) % self.p)

    def add(self, a, b):
        if self.degree == 1:
            return (a + b) % self.p
        return ((a[0] + b[0]) % self.p, (a[1] + b[1]) % self.p)

    def sub(self, a, b):
        if self.degree == 1:
            return (a - b) % self.p
        return ((a[0] - b[0]) % self.p, (a[1] - b[1]) % self.p)

    def jdbl(self, P):
        X, Y, Z = P
        a, b = self.mul(X, X), self.mul(Y, Y)
        c = self.mul(b, b)
        xb = self.add(X, b)
        d = self.sub(self.sub(self.mul(xb, xb), a), c)
        d = self.add(d, d)
        e = self.add(self.add(a, a), a)
        x3 = self.sub(self.mul(e, e), self.add(d, d))
        c8 = self.add(c, c)
        c8 = self.add(c8, c8)
        c8 = self.add(c8, c8)
        z3 = self.mul(Y, Z)
        return x3, self.sub(self.mul(e, self.sub(d, x3)), c8), self.add(z3, z3)

    def to_mont(self, v):
        return v * self.R % self.p if self.degree == 1 else tuple(x * self.R % self.p for x in v)

    def from_mont(self, v):          # the multiply by the plain 1
        return self.bmul(v, 1) if self.degree == 1 else tuple(self.bmul(x, 1) for x in v)

    # the block's tree is over Fp: an Fp2 product goes in as its norm
    def tree_leaf(self, c):
        if self.degree == 1:
            return c
        return (self.bmul(c[0], c[0]) - self.nr * self.bmul(c[1], c[1])) % self.p

    def from_leaf(self, c, li):
        if self.degree == 1:
            return li
        return (self.bmul(c[0], li), (-self.bmul(c[1], li)) % self.p)

    def fermat(self, z):
        """precompute_bases.cu fermat: z^(p-2), left to right from R."""
        e = self.p - 2
        zi = self.one_b
        for bit in range(e.bit_length() - 1, -1, -1):
            zi = self.bmul(zi, zi)
            if (e >> bit) & 1:
                zi = self.bmul(zi, z)
        return zi


def kernel_model(g, xs, ys, nu: int, shift: int, threads: int):
    """precompute_bases.cu's steps over Python ints: affine canonical
    inputs -> {row nu i + j: (x, y)} canonical. Copies 1 .. nu - 2 keep Z
    and the product before them in `scratch`, X and Y in their rows; the
    last copy stays in the thread's registers."""
    E = Elements(g)
    n = len(xs)
    out = {}
    for b0 in range(0, n, threads):
        regs = {}
        for t in range(threads):
            i = b0 + t
            c = cprev = E.one
            cur = (E.zero, E.one, E.zero)
            if i < n:
                out[nu * i] = (xs[i], ys[i])
                inf = xs[i] == E.zero and ys[i] == E.zero
                cur = (E.to_mont(xs[i]), E.to_mont(ys[i]), E.zero if inf else E.one)
                for copy in range(1, nu):
                    for _ in range(shift):
                        cur = E.jdbl(cur)
                    z1 = E.one if cur[2] == E.zero else cur[2]
                    cprev = c
                    c = z1 if copy == 1 else E.mul(c, z1)
                    if copy < nu - 1:
                        out[nu * i + copy] = ("kept", cur[0], cur[1], cur[2], cprev)
            regs[t] = (c, cprev, cur)
        if nu < 2:
            continue
        # the product tree: node[kThreads + t] the leaves, node[i] = node[2i] node[2i + 1]
        node = [None] * (2 * threads)
        for t in range(threads):
            node[threads + t] = E.tree_leaf(regs[t][0])
        half = threads // 2
        while half >= 1:
            for t in range(half):
                node[half + t] = E.bmul(node[2 * (half + t)], node[2 * (half + t) + 1])
            half //= 2
        node[1] = E.fermat(node[1])
        half = 1
        while half < threads:
            for t in range(half):
                i = half + t
                inv, a, b = node[i], node[2 * i], node[2 * i + 1]
                node[2 * i], node[2 * i + 1] = E.bmul(inv, b), E.bmul(inv, a)
            half *= 2
        for t in range(threads):
            i = b0 + t
            if i >= n:
                continue
            c, cprev, cur = regs[t]
            inv = E.from_leaf(c, node[threads + t])
            walk = [(nu - 1, cur[0], cur[1], cur[2], cprev)] + \
                [(copy, *out[nu * i + copy][1:]) for copy in range(nu - 2, 0, -1)]
            for copy, X, Y, Z, before in walk:
                zero = Z == E.zero
                zi = inv if copy == 1 else E.mul(inv, before)
                if copy > 1:
                    inv = E.mul(inv, E.one if zero else Z)
                zp = E.from_mont(zi)
                s2 = E.mul(zi, zp)
                s3 = E.mul(s2, zi)
                out[nu * i + copy] = (E.zero, E.zero) if zero else (E.mul(X, s2), E.mul(Y, s3))
    return out


@pytest.mark.parametrize("curve, g2, nu, shift", [
    ("bn254", False, 23, 1), ("bn254", False, 2, 3), ("bls12_377", False, 4, 2),
    ("bn254", True, 2, 2), ("bls12_377", True, 3, 1)],
    ids=lambda v: str(v))
def test_batch_inversion_as_the_kernel_arranges_it(curve, g2, nu, shift):
    """Two blocks of kThreads threads, the second mostly a tail past n,
    with identity lanes in both: the model's rows equal
    precompute_bases_ref's bit for bit."""
    g = get_group(curve, g2=g2)
    f = g.coord_field
    threads = kernel_threads()
    n = threads + 9
    pool = points(g, 5, seed=nu)
    rng = np.random.default_rng(shift)
    zero = 0 if g.degree == 1 else (0, 0)
    pts = [pool[k] for k in rng.integers(0, len(pool), n)]
    for i in (0, 3, threads - 1, threads + 4):      # identity lanes, (0, 0)
        pts[i] = (zero, zero)
    xs, ys = [P[0] for P in pts], [P[1] for P in pts]
    got = kernel_model(g, xs, ys, nu, shift, threads)
    ox, oy = PB.precompute_bases_ref(g, f.from_ints(xs, "cpu"), f.from_ints(ys, "cpu"), nu,
                                     shift)
    want_x, want_y = f.to_ints(ox), f.to_ints(oy)
    norm = (lambda v: v) if g.degree == 1 else (lambda v: tuple(int(c) for c in v))
    for row in range(nu * n):
        assert got[row] == (norm(want_x[row]), norm(want_y[row])), row


def test_scratch_words():
    """The wrapper's scratch: copies 1 .. nu - 2, Z and the running
    product, none at nu <= 2 (E4 keeps its one copy in registers)."""
    assert PB.scratch_words(1 << 22, 4, 8) == 2 * 2 * 8 * (1 << 22)
    assert PB.scratch_words(1 << 20, 2, 16) == 0
    assert PB.scratch_words(5, 1, 8) == 0
    assert PB.scratch_words(1024, 23, 12) == 21 * 2 * 12 * 1024


def test_kernel_source_keeps_the_model_s_constants():
    """The model reads kThreads from the source; the launch refuses a
    modulus without two spare bits, as msm_scan.cu's, and every group the
    kernel is built for has them."""
    text = open(f"{build.CSRC}/precompute_bases.cu").read()
    assert kernel_threads() & (kernel_threads() - 1) == 0
    assert kernel_threads() == PB.BLOCK_THREADS
    assert "if (!wide::lazy_ok(k.f)" in text
    for curve, g2 in GROUPS:
        p = get_group(curve, g2=g2).curve.fq.modulus
        assert 4 * p < 1 << (32 * get_group(curve, g2=g2).base_limbs)


@pytest.mark.parametrize("n, nu, nl, launches", [
    (1 << 22, 4, 8, 1),        # M4's bases: 2^27 scratch words, one launch
    (1 << 20, 2, 16, 1),       # E4's: no scratch
    (1 << 10, 23, 12, 1),      # M3's
    (1 << 22, 23, 24, 16),     # bw6_761 G1 at nu 23: 17 GB of scratch in one launch
    (4000, 23, 24, 1),
])
def test_chunks_bound_the_scratch_on_whole_blocks(n, nu, nl, launches):
    """The wrapper's launches cover the points in order, every launch but
    the last a whole number of blocks (each block inverts the points it
    would in one launch), each launch's scratch within SCRATCH_MAX_WORDS;
    the main paths' shapes take one launch, as chip_smoke.py counts."""
    parts = PB.chunks(n, nu, nl)
    assert len(parts) == launches
    assert parts[0][0] == 0 and parts[-1][1] == n
    assert all(b == a2 for (_, b), (a2, _) in zip(parts, parts[1:]))
    assert all((b - a) % PB.BLOCK_THREADS == 0 for a, b in parts[:-1])
    assert all(PB.scratch_words(b - a, nu, nl) <= PB.SCRATCH_MAX_WORDS for a, b in parts)


def test_chunks_under_a_small_cap(monkeypatch):
    """A cap below a launch's scratch splits on blocks (300 points' worth:
    two blocks a launch), and a cap below one block's still launches a
    block at a time."""
    monkeypatch.setattr(PB, "SCRATCH_MAX_WORDS", PB.scratch_words(300, 5, 8))
    assert PB.chunks(1000, 5, 8) == [(0, 256), (256, 512), (512, 768), (768, 1000)]
    monkeypatch.setattr(PB, "SCRATCH_MAX_WORDS", PB.scratch_words(3, 5, 8))
    assert PB.chunks(300, 5, 8) == [(0, 128), (128, 256), (256, 300)]
    assert PB.chunks(300, 2, 8) == [(0, 300)]
