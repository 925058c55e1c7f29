"""The port's multi-limb field engine (icicle_tpu_torch/math/bigint.py
`BigField`, served through fields/field.py) and params against the JAX
package's, on the same numpy inputs: bn254's two fields (L = 8) and
bls12_377's base field (L = 12) for limb-count generality.

Operands are full-width random elements plus 0, 1, p-2, p-1 and elements
whose limbs have the top bit set (negative as int32), so a sign bug in the
int32 storage shows. Tolerance: exact equality (integers mod p; canonical
results are unique).
"""

import numpy as np
import pytest
import torch

from icicle_tpu.fields import field as jfield
from icicle_tpu.math import params as jparams
from icicle_tpu_torch import interop
from icicle_tpu_torch.fields import field as tfield
from icicle_tpu_torch.math import params as tparams
from icicle_tpu_torch.math.bigint import BigField

# The tier-1 run puts six pytest workers on the same cores; torch's intra-op
# threads then oversubscribe them and these small-tensor ops run ~10x slower.
torch.set_num_threads(1)

FIELDS = ["bn254_base", "bn254_scalar", "bls12_377_base"]
BINARY_OPS = ["add", "sub", "mul_mont", "mul"]
UNARY_OPS = ["neg", "to_mont", "from_mont", "inv"]


def _edges(p: int, nl: int) -> list[int]:
    high = int("80000000" * (nl - 1), 16)         # every limb below the top >= 2^31
    ones = (1 << (32 * (nl - 1))) - 1             # every limb below the top all ones
    top = (p >> (32 * (nl - 1))) << (32 * (nl - 1))  # p's top limb, zeros below
    return [0, 1, 2, p - 2, p - 1, high, ones, top, top - 1, p >> 1]


def _operands(name: str, seed: int, n: int = 54) -> np.ndarray:
    """(n + 10, L) uint32 limbs: the edge values, then random elements."""
    jf = jfield.get_field(name)
    edges = np.asarray(jf.from_ints(_edges(jf.modulus, jf.nlimbs)))
    rand = np.asarray(jf.rand(np.random.default_rng(seed), (n,)))
    return np.concatenate([edges, rand])


def _t(name, arr):
    return interop.elements_from_numpy(tfield.get_field(name), arr, "cpu")


@pytest.mark.parametrize("op", BINARY_OPS)
@pytest.mark.parametrize("name", FIELDS)
def test_binary_op(name, op):
    a = _operands(name, 1)
    b = _operands(name, 2)[::-1].copy()
    want = np.asarray(getattr(jfield.get_field(name), op)(a, b))
    got = getattr(tfield.get_field(name), op)(_t(name, a), _t(name, b))
    assert got.dtype == torch.int32
    assert np.array_equal(interop.elements_to_numpy(tfield.get_field(name), got), want)


@pytest.mark.parametrize("op", UNARY_OPS)
@pytest.mark.parametrize("name", FIELDS)
def test_unary_op(name, op):
    a = _operands(name, 3)
    want = np.asarray(getattr(jfield.get_field(name), op)(a))
    got = getattr(tfield.get_field(name), op)(_t(name, a))
    assert np.array_equal(interop.elements_to_numpy(tfield.get_field(name), got), want)


@pytest.mark.parametrize("name", FIELDS + ["bw6_761_base"])
def test_ops_match_python_ints(name):
    """bw6_761 (L = 24) takes the column-by-column carry path: its products
    have more columns than carry-lookahead's 62-bit masks hold."""
    tf = tfield.get_field(name)
    p = tf.modulus
    a, b = _operands(name, 4, 14), _operands(name, 5, 14)[::-1].copy()
    ai, bi = jfield.get_field(name).to_ints(a), jfield.get_field(name).to_ints(b)
    checks = {"add": [(x + y) % p for x, y in zip(ai, bi)],
              "sub": [(x - y) % p for x, y in zip(ai, bi)],
              "mul": [x * y % p for x, y in zip(ai, bi)]}
    for op, want in checks.items():
        got = getattr(tf, op)(_t(name, a), _t(name, b))
        assert list(tf.to_ints(got)) == want, op
    assert list(tf.to_ints(tf.pow_const(_t(name, a), 5))) == [pow(x, 5, p) for x in ai]
    assert list(tf.to_ints(tf.pow_const(_t(name, a), 0))) == [1] * len(ai)


@pytest.mark.parametrize("name", FIELDS)
def test_eq_is_zero(name):
    tf = tfield.get_field(name)
    a = _t(name, _operands(name, 6))
    assert tf.is_zero(a).tolist() == [v == 0 for v in tf.to_ints(a)]
    assert bool(tf.eq(a, a.clone()).all())
    assert not bool(tf.eq(a, tf.add(a, tf.const(1, a.shape[:-1], "cpu"))).any())


@pytest.mark.parametrize("name", FIELDS + ["bls12_381_base", "bw6_761_base", "stark252"])
def test_from_ints_to_ints_rand_match_jax(name):
    jf, tf = jfield.get_field(name), tfield.get_field(name)
    assert tf.limb_shape == jf.limb_shape == (jf.nlimbs,)
    assert isinstance(tf.engine, BigField)
    values = _edges(jf.modulus, jf.nlimbs) + [jf.modulus + 5, -1]
    t = tf.from_ints(values, "cpu")
    assert np.array_equal(interop.elements_to_numpy(tf, t), np.asarray(jf.from_ints(values)))
    assert list(tf.to_ints(t)) == [v % jf.modulus for v in values]
    got = tf.rand(np.random.default_rng(7), (3, 5), "cpu")
    want = np.asarray(jf.rand(np.random.default_rng(7), (3, 5)))
    assert got.shape == (3, 5, jf.nlimbs)
    assert np.array_equal(interop.elements_to_numpy(tf, got), want)
    assert np.array_equal(interop.elements_to_numpy(tf, tf.const(7, (2,), "cpu")),
                          np.asarray(jf.const(7, (2,))))
    assert tf.zeros((4,), "cpu").shape == (4, jf.nlimbs)


@pytest.mark.parametrize("name", FIELDS)
def test_interop_round_trip_and_canonicity(name):
    tf = tfield.get_field(name)
    arr = _operands(name, 8)
    t = interop.elements_from_numpy(tf, arr, "cpu")
    assert t.dtype == torch.int32 and bool((t < 0).any())  # top-bit limbs are negative
    back = interop.elements_to_numpy(tf, t)
    assert back.dtype == np.uint32 and np.array_equal(back, arr)
    p = tf.modulus
    nl = tf.nlimbs
    # p itself, and a value above p whose top limb equals p's: not canonical
    for bad in (p, p + 1, p | ((1 << (32 * (nl - 1))) - 1)):
        bad_arr = np.asarray(tparams.limbs_of(bad, nl), dtype=np.uint32)[None]
        with pytest.raises(Exception, match="not canonical"):
            interop.elements_from_numpy(tf, bad_arr, "cpu")
    # a value below p whose top limb equals p's is canonical
    ok = np.asarray(tparams.limbs_of(p - 1, nl), dtype=np.uint32)[None]
    assert np.array_equal(interop.elements_to_numpy(tf, interop.elements_from_numpy(tf, ok, "cpu")), ok)


@pytest.mark.parametrize("name", FIELDS + ["bw6_761_base", "babybear"])
def test_params_helpers_match_jax(name):
    jp, tp = jfield.get_field(name).params, tfield.field_params(name)
    assert (tp.nhalf, tp.inv16) == (jp.nhalf, jp.inv16)
    for f in ("p_limbs32", "p_limbs16"):
        assert np.array_equal(getattr(tp, f)(), getattr(jp, f)())
    v = 0x1234_5678_9ABC_DEF0_1357_9BDF_2468_ACE0 % tp.modulus
    assert np.array_equal(tp.const_limbs32(v), jp.const_limbs32(v))
    assert tp.to_mont_int(v) == jp.to_mont_int(v)
    assert tp.from_mont_int(v) == jp.from_mont_int(v)
    for bits in (16, 32):
        limbs = tparams.limbs_of(v, 8, bits)
        assert limbs == jparams.limbs_of(v, 8, bits)
        assert tparams.int_of(limbs, bits) == jparams.int_of(limbs, bits) == v
