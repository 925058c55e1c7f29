"""The port's NTT against the JAX package's `ntt(..., backend="xla")` with a
coset (babybear), batched (3 and 64 vectors: the classic and vector-major
branches) and through the torch four-step branch; see
tests/test_torch_ntt.py for the helpers.

Tolerance: exact equality (integers mod p).
"""

import numpy as np
import pytest

from icicle_tpu_torch.fields.field import get_field as torch_field
from icicle_tpu_torch.ops import ntt as TN
from tests.test_torch_ntt import DIRS, ORDERINGS, _check_coset, _jax, _port, _vec


@pytest.mark.parametrize("direction", DIRS)
@pytest.mark.parametrize("ordering", ORDERINGS)
def test_coset_ntt_matches_jax(ordering, direction):
    _check_coset("babybear", ordering, direction)


@pytest.mark.parametrize("batch", [3, 64])
@pytest.mark.parametrize("direction", DIRS)
@pytest.mark.parametrize("ordering", ORDERINGS)
def test_batched_ntt_matches_jax(batch, ordering, direction):
    """batch 64 takes the vector-major branch for natural-order input."""
    p = torch_field("babybear").modulus
    for logn, coset in ((3, None), (6, 7)):
        x = _vec(p, (batch, 1 << logn), 200 + logn)
        assert np.array_equal(_port("babybear", x, direction, ordering, coset),
                              _jax("babybear", x, direction, ordering, coset)), logn


def test_four_step_branch(monkeypatch):
    """The torch four-step branch, reached below 2^16 by lowering its
    threshold, against the JAX NTT (which takes its classic path there)."""
    monkeypatch.setattr(TN, "_FOUR_STEP_MIN_LOGN", 4)
    for name in ("babybear", "koalabear"):
        p = torch_field(name).modulus
        for logn in (4, 5, 8):
            x = _vec(p, (1 << logn,), 300 + logn)
            for d in DIRS:
                for coset in (None, 7):
                    assert np.array_equal(_port(name, x, d, coset_gen=coset),
                                          _jax(name, x, d, coset_gen=coset)), (name, logn, d)
