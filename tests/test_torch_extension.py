"""The port's extension fields (icicle_tpu_torch/fields/extension.py)
against the JAX package's (icicle_tpu/fields/extension.py): the single-word
quartics, goldilocks' quadratic and the pairing towers Fq6 and Fq12, element
for element (integers: the tolerance is 0), from numpy seeds. The Fp2 bases
of G2 (bn254, bls12_377, bls12_381) are in test_torch_extension_fp2.py."""

import numpy as np
import pytest
import torch

from icicle_tpu.fields import extension as JE
from icicle_tpu_torch.fields import extension as TE
from icicle_tpu_torch.runtime import device


@pytest.fixture(autouse=True)
def on_cpu(monkeypatch):
    monkeypatch.setattr(device, "_device", torch.device("cpu"))


def _pair(jf, tf, seed: int, shape=(5,)):
    """The same random elements in both packages (the same draws)."""
    a_j = jf.rand(np.random.default_rng(seed), shape)
    a_t = tf.rand(np.random.default_rng(seed), shape, "cpu")
    assert np.array_equal(np.asarray(a_j).view(np.int32), a_t.numpy())
    return a_j, a_t


def _same(j, t: torch.Tensor) -> None:
    assert np.array_equal(np.asarray(j).view(np.int32), t.numpy())


def check_field(jf, tf, shape=(5,), mul_mont: bool = True) -> None:
    """mul, add, inv and the Montgomery round trip, equal to JAX (and, with
    `mul_mont`, the Montgomery-domain product)."""
    a_j, a_t = _pair(jf, tf, 1, shape)
    b_j, b_t = _pair(jf, tf, 2, shape)
    _same(jf.mul(a_j, b_j), tf.mul(a_t, b_t))
    _same(jf.add(a_j, b_j), tf.add(a_t, b_t))
    inv_t = tf.inv(a_t)
    _same(jf.inv(a_j), inv_t)
    m_j, m_t = jf.to_mont(a_j), tf.to_mont(a_t)
    _same(m_j, m_t)
    if mul_mont:
        _same(jf.engine.mul_mont(m_j, jf.to_mont(b_j)), tf.mul_mont(m_t, tf.to_mont(b_t)))
    assert torch.equal(tf.from_mont(m_t), a_t)
    assert torch.equal(tf.mul(inv_t, a_t), tf.const(1, shape, "cpu"))


@pytest.mark.parametrize("base", ["babybear", "koalabear", "m31", "goldilocks"])
def test_ext_field_matches_jax(base):
    jf, tf = JE.get_ext_field(base), TE.get_ext_field(base)
    assert (tf.name, tf.degree, tf.limb_shape) == (jf.name, jf.degree, jf.limb_shape)
    check_field(jf, tf)


@pytest.mark.parametrize("curve", ["bn254", "bls12_381", "bls12_377"])
@pytest.mark.parametrize("degree", [6, 12])
def test_pairing_towers_match_jax(curve, degree):
    """Fq6 = Fq2[v]/(v^3 - xi) and Fq12 = Fq6[t]/(t^2 - v): the nonresidue
    is a tower element, multiplied in the matching domain."""
    jf, tf = JE.get_tower_field(curve, degree), TE.get_tower_field(curve, degree)
    assert tf.limb_shape == jf.limb_shape
    check_field(jf, tf, (1,), mul_mont=False)


def test_int_conversion_and_pow_match_jax():
    """from_ints / to_ints in the towers' nested component order, const and
    pow_const (square and multiply) as in JAX."""
    jf, tf = JE.get_tower_field("bn254", 12), TE.get_tower_field("bn254", 12)
    rng = np.random.default_rng(3)
    p = jf.modulus
    vals = [[[[int(rng.integers(0, 1 << 62)) * (i + 1) % p for i in range(2)]
              for _ in range(3)] for _ in range(2)] for _ in range(2)]
    a_t = tf.from_ints(vals, "cpu")
    _same(jf.from_ints(vals), a_t)
    assert tf.to_ints(a_t).tolist() == jf.to_ints(jf.from_ints(vals)).tolist() == vals
    f4 = TE.get_ext_field("babybear")
    j4 = JE.get_ext_field("babybear")
    b_j, b_t = _pair(j4, f4, 4, (3,))
    for e in (0, 1, 5, (1 << 31) - 3):
        _same(j4.pow_const(b_j, e), f4.pow_const(b_t, e))
    _same(j4.const(7, (2,)), f4.const(7, (2,), "cpu"))


def test_config_errors_match_jax():
    with pytest.raises(KeyError):
        TE.get_ext_field("bn254_scalar")
    with pytest.raises(ValueError):
        TE.get_ext_field("babybear", 2)
    with pytest.raises(ValueError):
        TE.get_tower_field("bn254", 4)
    assert TE._EXT_CONFIGS == JE._EXT_CONFIGS and TE._TOWER_XI == JE._TOWER_XI
