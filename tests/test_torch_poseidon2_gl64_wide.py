"""The port's goldilocks Poseidon2 at the widths its kernel gained last,
t = 16, 20 and 24 (kernels/csrc/poseidon2_gl64.cu), held to the JAX
package's `Poseidon2` on the CPU (the plain version; chip_smoke.py holds
the kernel to it on the card): the constants, one permutation a row, the
sponge, a domain tag, and rows of 0 and p - 1. Inputs come from numpy
seeds; elements are canonical, so the tolerance is exact equality."""

import numpy as np
import pytest

from icicle_tpu.fields.field import get_field as jax_field
from icicle_tpu_torch import Poseidon2, get_field
from icicle_tpu_torch.kernels import poseidon2_kernel as PK
from tests.test_torch_poseidon2 import _elements, _jax_hasher, _t, _u32

WIDE_WIDTHS = [16, 20, 24]


@pytest.mark.parametrize("t", WIDE_WIDTHS)
def test_goldilocks_wide_widths_match_jax(t):
    jh = _jax_hasher("goldilocks", t)
    h = Poseidon2("goldilocks", t)
    c = h.constants("cpu")
    for name in ("rc_full_top", "rc_partial", "rc_full_bot", "mds", "diag_m1"):
        assert np.array_equal(_u32(getattr(c, name)), np.asarray(getattr(jh, name))), name
    PK.check_linear_layers(t, *PK.field_linear_layers("goldilocks", t))
    assert PK.supported_on_cuda(h)
    x = np.array(_elements("goldilocks", (4, t), seed=840 + t))
    p = jax_field("goldilocks").modulus
    x[0] = 0
    x[1] = np.asarray(jax_field("goldilocks").from_ints([p - 1] * t), dtype=np.uint32)
    for n, rows in ((t, x), (2 * t + 1, _elements("goldilocks", (2, 2 * t + 1), seed=850 + t))):
        got = h.hash_fields(_t(rows))
        assert got.shape == (rows.shape[0], 2)
        assert np.array_equal(_u32(got), np.asarray(jh.hash_fields(rows))), n
    tagged = _elements("goldilocks", (2, t - 1), seed=860 + t)
    got = Poseidon2("goldilocks", t, domain_tag=5).hash_fields(_t(tagged))
    assert np.array_equal(_u32(got), np.asarray(_jax_hasher("goldilocks", t, 5).hash_fields(tagged)))
    assert get_field("goldilocks").modulus == p
