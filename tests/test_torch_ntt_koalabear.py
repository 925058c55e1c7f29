"""The port's NTT against the JAX package's `ntt(..., backend="xla")` for
koalabear (all orderings, both directions, logn 1..12) and its coset NTT;
see tests/test_torch_ntt.py for the babybear cases and the helpers.

Tolerance: exact equality (integers mod p).
"""

import pytest

from tests.test_torch_ntt import DIRS, ORDERINGS, _check_coset, _check_sizes


@pytest.mark.parametrize("direction", DIRS)
@pytest.mark.parametrize("ordering", ORDERINGS)
def test_koalabear_ntt_matches_jax(ordering, direction):
    _check_sizes("koalabear", ordering, direction)


@pytest.mark.parametrize("direction", DIRS)
@pytest.mark.parametrize("ordering", ORDERINGS)
def test_koalabear_coset_ntt_matches_jax(ordering, direction):
    _check_coset("koalabear", ordering, direction)
