"""The port's NTT over a multi-limb field at 2^16, its four-step route
(icicle_tpu_torch/ops/ntt.py `_ntt_four_step`, the vector axis before the
limb axis), which the JAX side does not reach on the CPU in reasonable
time: held against the port's own `_ct_stages` route and against
Python-int evaluation at 16 sampled output indices, and the inverse
against the input. (The JAX comparisons at the JAX tests' sizes are in
tests/test_torch_ntt_limbs.py.)

Inputs come from numpy seeds; tolerance: exact equality (integers mod p).
"""

import numpy as np
import torch

from icicle_tpu_torch import interop
from icicle_tpu_torch.fields.field import get_field as torch_field
from icicle_tpu_torch.ops import ntt as TN
from icicle_tpu_torch.runtime.config import NTTDir
from tests.test_torch_ntt_limbs import CPU, limb_vec

torch.set_num_threads(1)


def _python_ntt_at(f, xs: list, k: int, logn: int) -> int:
    """X[k] = sum_j x_j w^(j k) by Horner in Python ints."""
    p = f.modulus
    wk = pow(f.omega(logn), k, p)
    acc = 0
    for v in reversed(xs):
        acc = (acc * wk + v) % p
    return acc


def test_bn254_four_step_2_16_against_ct_stages_and_python():
    logn = 16
    tf = torch_field("bn254_scalar")
    x = interop.elements_from_numpy(tf, limb_vec("bn254_scalar", (1 << logn,), seed=40), CPU)
    y = TN.ntt(tf, x)                                       # the four-step route
    dom = TN.get_domain(tf, logn, CPU)
    rev = TN._bit_reverse_index(1 << logn, CPU)
    assert torch.equal(y, TN._ct_stages(tf, x.index_select(0, rev), dom.twiddles, logn))
    xs = [int(v) for v in tf.to_ints(x)]
    ys = tf.to_ints(y)
    for k in np.random.default_rng(41).integers(0, 1 << logn, size=16):
        assert ys[k] == _python_ntt_at(tf, xs, int(k), logn), k
    assert torch.equal(TN.ntt(tf, y, NTTDir.INVERSE), x)
