"""The port's field layer (icicle_tpu_torch: math/params.py, math/mont32.py,
fields/field.py) against the JAX package's, on the same numpy inputs.

Tolerance: exact equality -- every value is an integer mod p, and canonical
results are unique.
"""

import numpy as np
import pytest

from icicle_tpu.fields import field as jfield
from icicle_tpu_torch import interop
from icicle_tpu_torch.fields import field as tfield

MONT32_FIELDS = ["babybear", "koalabear", "m31"]
BINARY_OPS = ["add", "sub", "mul", "mul_mont"]
UNARY_OPS = ["neg", "to_mont", "from_mont", "inv", "sqr"]


def _operands(p: int, seed: int, n: int = 1000) -> np.ndarray:
    """Random canonical elements with the edge values 0, 1, p-2, p-1 first."""
    rng = np.random.default_rng(seed)
    edge = np.array([0, 1, p - 2, p - 1], dtype=np.uint32)
    return np.concatenate([edge, rng.integers(0, p, size=n, dtype=np.uint32)])


def _pair(name):
    return jfield.get_field(name), tfield.get_field(name)


@pytest.mark.parametrize("name", jfield.field_names())
def test_param_table(name):
    jp = jfield.get_field(name).params
    tp = tfield.field_params(name)
    assert (tp.modulus, tp.r, tp.r2, tp.inv32, tp.two_adicity) == \
        (jp.modulus, jp.r, jp.r2, jp.inv32, jp.two_adicity)
    assert (tp.rou, tp.nonresidue, tp.generator) == (jp.rou, jp.nonresidue, jp.generator)
    if jp.rou is None:
        for params in (jp, tp):
            with pytest.raises(ValueError):
                params.omega(1)
        return
    assert [tp.omega(k) for k in range(tp.two_adicity + 1)] == \
        [jp.omega(k) for k in range(jp.two_adicity + 1)]


def test_field_names_match():
    assert tfield.field_names() == jfield.field_names()


@pytest.mark.parametrize("op", BINARY_OPS)
@pytest.mark.parametrize("name", MONT32_FIELDS)
def test_binary_op(name, op):
    jf, tf = _pair(name)
    a = _operands(jf.modulus, 1)
    b = _operands(jf.modulus, 2)[::-1].copy()
    want = np.asarray(getattr(jf, op)(a, b))
    got = getattr(tf, op)(interop.elements_from_numpy(tf, a, "cpu"),
                          interop.elements_from_numpy(tf, b, "cpu"))
    assert np.array_equal(interop.elements_to_numpy(tf, got), want)


@pytest.mark.parametrize("op", UNARY_OPS)
@pytest.mark.parametrize("name", MONT32_FIELDS)
def test_unary_op(name, op):
    jf, tf = _pair(name)
    a = _operands(jf.modulus, 3, n=200 if op == "inv" else 1000)
    want = np.asarray(getattr(jf, op)(a))
    got = getattr(tf, op)(interop.elements_from_numpy(tf, a, "cpu"))
    assert np.array_equal(interop.elements_to_numpy(tf, got), want)
    if op == "inv":
        assert want[0] == 0 and int(got[0]) == 0  # inv(0) = 0


@pytest.mark.parametrize("e", [0, 1, 2, 5, 17, 65537, (1 << 31) - 3])
@pytest.mark.parametrize("name", MONT32_FIELDS)
def test_pow_const(name, e):
    jf, tf = _pair(name)
    a = _operands(jf.modulus, 4, n=100)
    want = np.asarray(jf.pow_const(a, e))
    got = tf.pow_const(interop.elements_from_numpy(tf, a, "cpu"), e)
    assert np.array_equal(interop.elements_to_numpy(tf, got), want)


@pytest.mark.parametrize("name", MONT32_FIELDS)
def test_ints_round_trip_and_rand(name):
    jf, tf = _pair(name)
    p = jf.modulus
    vals = [0, 1, p - 1, p, p + 5, 3 * p + 7, 2**40 + 11]
    t = tf.from_ints(vals, device="cpu")
    assert np.array_equal(interop.elements_to_numpy(tf, t), np.asarray(jf.from_ints(vals)))
    assert list(tf.to_ints(t)) == [v % p for v in vals]
    assert list(tf.to_ints(t)) == list(jf.to_ints(jf.from_ints(vals)))
    got = tf.rand(np.random.default_rng(9), (4, 5), device="cpu")
    want = np.asarray(jf.rand(np.random.default_rng(9), (4, 5)))
    assert np.array_equal(interop.elements_to_numpy(tf, got), want)
    assert np.array_equal(interop.elements_to_numpy(tf, tf.const(p + 3, (2, 3), "cpu")),
                          np.asarray(jf.const(p + 3, (2, 3))))
    assert np.array_equal(interop.elements_to_numpy(tf, tf.zeros((3,), "cpu")),
                          np.asarray(jf.zeros((3,))))


def test_elements_from_numpy_rejects_noncanonical():
    tf = tfield.get_field("babybear")
    with pytest.raises(Exception, match="not canonical"):
        interop.elements_from_numpy(tf, np.array([tf.modulus], dtype=np.uint32), "cpu")
    with pytest.raises(Exception, match="uint32"):
        interop.elements_from_numpy(tf, np.array([1], dtype=np.int64), "cpu")
