"""The port's Polynomial (icicle_tpu_torch/polynomials/polynomial.py)
against the JAX package's on the CPU: every case of tests/test_polynomial.py
at its sizes, over babybear, goldilocks and bn254_scalar, each result's
coefficients (or evaluations) equal to the JAX package's bit for bit and
to Python-int arithmetic; and a JAX-built domain and polynomial carried
across by `interop`.

Inputs come from numpy seeds; tolerance: exact equality (integers mod p).
"""

import numpy as np
import pytest
import torch

from icicle_tpu.fields.field import get_field as jax_field
from icicle_tpu.ops import ntt as JN
from icicle_tpu.polynomials import Polynomial as JaxPolynomial
from icicle_tpu_torch import Polynomial, interop
from icicle_tpu_torch.fields.field import get_field as torch_field
from icicle_tpu_torch.ops import ntt as TN

torch.set_num_threads(1)

CPU = torch.device("cpu")
FIELDS = ["babybear", "goldilocks", "bn254_scalar"]


class Pair:
    """One polynomial in both packages, from the same coefficients."""

    def __init__(self, fname: str, coeffs: list):
        self.jf, self.tf = jax_field(fname), torch_field(fname)
        u32 = np.asarray(self.jf.from_ints(coeffs), dtype=np.uint32)
        self.j = JaxPolynomial.from_coeffs(self.jf, self.jf.from_ints(coeffs))
        self.t = Polynomial.from_coeffs(self.tf, interop.elements_from_numpy(self.tf, u32, CPU))


def rand_coeffs(f, rng, n):
    return [int.from_bytes(rng.bytes(40), "little") % f.modulus for _ in range(n)]


def same(jp: JaxPolynomial, tp: Polynomial) -> list:
    """Asserts equal sizes and coefficients; returns them as Python ints."""
    assert tp.size == jp.size
    want = np.asarray(jp.coeffs[:jp.size], dtype=np.uint32)
    assert np.array_equal(interop.elements_to_numpy(tp.f, tp.copy_coeffs()), want)
    return [int(v) for v in tp.to_ints()]


def ref_mul(a, b, p):
    out = [0] * (len(a) + len(b) - 1)
    for i, x in enumerate(a):
        for j, y in enumerate(b):
            out[i + j] = (out[i + j] + x * y) % p
    return out


def ref_eval(c, x, p):
    acc = 0
    for v in reversed(c):
        acc = (acc * x + v) % p
    return acc


@pytest.mark.parametrize("fname", FIELDS)
def test_add_sub_neg(fname):
    rng = np.random.default_rng(1)
    p = jax_field(fname).modulus
    a, b = rand_coeffs(jax_field(fname), rng, 10), rand_coeffs(jax_field(fname), rng, 17)
    pa, pb = Pair(fname, a), Pair(fname, b)
    a_pad = a + [0] * 7
    assert same(pa.j + pb.j, pa.t + pb.t)[:17] == [(x + y) % p for x, y in zip(a_pad, b)]
    assert same(pa.j - pb.j, pa.t - pb.t)[:17] == [(x - y) % p for x, y in zip(a_pad, b)]
    assert same(-pa.j, -pa.t) == [(-x) % p for x in a]


@pytest.mark.parametrize("fname", FIELDS)
def test_mul(fname):
    rng = np.random.default_rng(2)
    f = jax_field(fname)
    a, b = rand_coeffs(f, rng, 5), rand_coeffs(f, rng, 8)
    pa, pb = Pair(fname, a), Pair(fname, b)
    assert same(pa.j * pb.j, pa.t * pb.t) == ref_mul(a, b, f.modulus)


@pytest.mark.parametrize("fname", FIELDS)
def test_mul_scalar(fname):
    rng = np.random.default_rng(3)
    f = jax_field(fname)
    a = rand_coeffs(f, rng, 9)
    pa = Pair(fname, a)
    assert same(pa.j.mul_scalar(12345), pa.t.mul_scalar(12345)) == [x * 12345 % f.modulus
                                                                     for x in a]
    assert same(pa.j * 7, 7 * pa.t) == [x * 7 % f.modulus for x in a]


@pytest.mark.parametrize("fname", FIELDS)
def test_divide(fname):
    rng = np.random.default_rng(4)
    f = jax_field(fname)
    q_ref, d_ref, r_ref = rand_coeffs(f, rng, 5), rand_coeffs(f, rng, 4), rand_coeffs(f, rng, 3)
    d_ref[-1] = max(d_ref[-1], 1)
    a = ref_mul(q_ref, d_ref, f.modulus)
    for i, v in enumerate(r_ref):
        a[i] = (a[i] + v) % f.modulus
    pa, pd = Pair(fname, a), Pair(fname, d_ref)
    (jq, jr), (tq, tr) = pa.j.divide(pd.j), pa.t.divide(pd.t)
    assert same(jq, tq)[:5] == q_ref
    got_r = same(jr, tr)
    assert got_r[:3] == r_ref and not any(got_r[3:])
    assert same(jq, pa.t // pd.t) and same(jr, pa.t % pd.t)


@pytest.mark.parametrize("fname", FIELDS)
def test_divide_by_vanishing(fname):
    rng = np.random.default_rng(5)
    f = jax_field(fname)
    nn = 4
    q_ref = rand_coeffs(f, rng, 9)
    v = [f.modulus - 1] + [0] * (nn - 1) + [1]
    pp = Pair(fname, ref_mul(q_ref, v, f.modulus))
    assert same(pp.j.divide_by_vanishing(nn), pp.t.divide_by_vanishing(nn))[:9] == q_ref
    small = Pair(fname, q_ref[:3])
    assert same(small.j.divide_by_vanishing(nn), small.t.divide_by_vanishing(nn)) == [0]


@pytest.mark.parametrize("fname", FIELDS)
def test_eval_and_rou_domain(fname):
    rng = np.random.default_rng(6)
    f = jax_field(fname)
    p = f.modulus
    c = rand_coeffs(f, rng, 7)
    pp = Pair(fname, c)
    got = pp.t.eval(99999)
    assert np.array_equal(interop.elements_to_numpy(pp.tf, got), np.asarray(pp.j.eval(99999)))
    assert int(pp.tf.to_ints(got)[0]) == ref_eval(c, 99999, p)
    evals = pp.t.eval_on_rou_domain(3)
    assert np.array_equal(interop.elements_to_numpy(pp.tf, evals),
                          np.asarray(pp.j.eval_on_rou_domain(3)))
    w = TN.get_root_of_unity(pp.tf, 8)
    ints = pp.tf.to_ints(evals)
    for i in (0, 3, 7):
        assert ints[i] == ref_eval(c, pow(w, i, p), p)
    # 7 coefficients fold onto a domain of 4
    assert np.array_equal(interop.elements_to_numpy(pp.tf, pp.t.eval_on_rou_domain(2)),
                          np.asarray(pp.j.eval_on_rou_domain(2)))
    back = Polynomial.from_rou_evals(pp.tf, evals)
    assert same(JaxPolynomial.from_rou_evals(f, pp.j.eval_on_rou_domain(3)), back)[:7] == c
    dom = pp.tf.from_ints([3, 5, p - 1], CPU)
    assert [int(v) for v in pp.tf.to_ints(pp.t.eval_on_domain(dom))] == [
        ref_eval(c, x, p) for x in (3, 5, p - 1)]


@pytest.mark.parametrize("fname", FIELDS)
def test_slice_even_odd_degree_monomial(fname):
    rng = np.random.default_rng(7)
    f = jax_field(fname)
    c = rand_coeffs(f, rng, 10)
    pp = Pair(fname, c)
    assert same(pp.j.even(), pp.t.even()) == c[0::2]
    assert same(pp.j.odd(), pp.t.odd()) == c[1::2]
    assert same(pp.j.slice(1, 3, 2), pp.t.slice(1, 3, 2)) == c[1::3][:2]
    assert pp.t.degree() == pp.j.degree() == 9
    assert pp.t.degree() == 9
    got = same(pp.j.add_monomial_inplace(5, 12), pp.t.add_monomial_inplace(5, 12))
    assert got[12] == 5 and got[:10] == c
    got = same(pp.j.sub_monomial_inplace(5, 3), pp.t.sub_monomial_inplace(5, 3))
    assert got[3] == (c[3] - 5) % f.modulus
    assert int(pp.tf.to_ints(pp.t.get_coeff(4))) == c[4]
    assert pp.t.copy_coeffs(2, 5).shape == (3,) + pp.tf.limb_shape
    zero = Pair(fname, [0, 0, 0])
    assert zero.t.degree() == zero.j.degree() == -1


@pytest.mark.parametrize("fname", ["goldilocks", "bn254_scalar"])
def test_interop_domain_and_polynomial(fname):
    """A JAX-built domain's tables (goldilocks: plain, bn254_scalar:
    Montgomery form) and a JAX Polynomial's state carried across give the
    JAX results: the domain the port's own, the product and evaluations
    the JAX package's."""
    jf, tf = jax_field(fname), torch_field(fname)
    jd = JN.ntt_init_domain(jf, 4)
    td = interop.domain_from_numpy(tf, 4, np.asarray(jd.twiddles), np.asarray(jd.twiddles_inv),
                                   CPU)
    own = TN.ntt_init_domain(tf, 4, CPU)
    assert torch.equal(td.twiddles, own.twiddles) and torch.equal(td.twiddles_inv,
                                                                   own.twiddles_inv)
    assert torch.equal(td.n_inv_mont, own.n_inv_mont)
    rng = np.random.default_rng(8)
    a = Pair(fname, rand_coeffs(jf, rng, 6)).j
    b = Pair(fname, rand_coeffs(jf, rng, 5)).j
    jprod = a * b
    ta = interop.polynomial_from_numpy(tf, np.asarray(a.coeffs), a.size, CPU)
    tb = interop.polynomial_from_numpy(tf, np.asarray(b.coeffs), b.size, CPU)
    same(jprod, ta * tb)
    carried = interop.polynomial_from_numpy(tf, np.asarray(jprod.coeffs), jprod.size, CPU)
    assert np.array_equal(interop.elements_to_numpy(tf, carried.eval_on_rou_domain(4)),
                          np.asarray(jprod.eval_on_rou_domain(4)))
