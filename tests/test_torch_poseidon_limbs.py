"""The port's Poseidon over 8-limb fields against the JAX package's at t = 3
and 5, with and without a domain tag, and the Python-int model
(tests/test_torch_poseidon.py `poseidon_model`, which holds the port at t =
9 and 12) against the same digests. bn254_scalar and grumpkin_scalar here,
the other three fields in tests/test_torch_poseidon_limbs_bls.py: a JAX
8-limb hash compiles for 5-20 s on the CPU, and the two files run on two
workers. Exact equality."""

import pytest

from tests.test_torch_poseidon import TAG, as_ints, check_against_jax, poseidon_model

FIELDS = ["bn254_scalar", "grumpkin_scalar"]


def check(fname: str, t: int, tag) -> None:
    x, got = check_against_jax(fname, t, tag, seed=31 * t + (tag is not None), batch=3)
    assert as_ints(fname, got) == [poseidon_model(fname, t, as_ints(fname, row), tag)
                                   for row in x]


@pytest.mark.parametrize("tag", [None, TAG])
@pytest.mark.parametrize("t", [3, 5])
@pytest.mark.parametrize("fname", FIELDS)
def test_limbs_equal_jax_and_the_model(fname, t, tag):
    check(fname, t, tag)
