"""The port's Poseidon over bls12_377_scalar, bls12_381_scalar and stark252
against the JAX package's at t = 3 and 5, with and without a domain tag,
and the Python-int model against the same digests (the check of
tests/test_torch_poseidon_limbs.py, split for the pytest workers). Exact
equality."""

import pytest

from tests.test_torch_poseidon import TAG
from tests.test_torch_poseidon_limbs import check

FIELDS = ["bls12_377_scalar", "bls12_381_scalar", "stark252"]


@pytest.mark.parametrize("tag", [None, TAG])
@pytest.mark.parametrize("t", [3, 5])
@pytest.mark.parametrize("fname", FIELDS)
def test_limbs_equal_jax_and_the_model(fname, t, tag):
    check(fname, t, tag)
