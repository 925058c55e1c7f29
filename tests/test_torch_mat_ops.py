"""The port's field matmul (icicle_tpu_torch/ops/mat_ops.py) against the
JAX package's `mat_ops` on the CPU, at tests/test_rings.py:96's sizes
((3, 4) x (4, 5)) and an odd shared axis: `matmul` with every combination
of the three transpose flags and `matrix_transpose` (with a batch axis),
for babybear, goldilocks and bn254_scalar, each equal to the JAX result
bit for bit and to Python-int arithmetic.

Inputs come from numpy seeds; tolerance: exact equality (integers mod p).
"""

import itertools

import numpy as np
import pytest
import torch

from icicle_tpu.fields.field import get_field as jax_field
from icicle_tpu.ops import mat_ops as JM
from icicle_tpu_torch import MatMulConfig, interop, matmul
from icicle_tpu_torch.fields.field import get_field as torch_field
from icicle_tpu_torch.ops import mat_ops as TM

torch.set_num_threads(1)

CPU = torch.device("cpu")
FIELDS = ["babybear", "goldilocks", "bn254_scalar"]
FLAGS = list(itertools.product([False, True], repeat=3))


def _ints(f, rng, shape):
    vals = [int.from_bytes(rng.bytes(40), "little") % f.modulus for _ in range(int(np.prod(shape)))]
    vals[:2] = [0, f.modulus - 1]
    return np.array(vals, dtype=object).reshape(shape)


def _u32(jf, ints):
    return np.asarray(jf.from_ints(ints), dtype=np.uint32)


@pytest.mark.parametrize("fname", FIELDS)
@pytest.mark.parametrize("m", [4, 7])
def test_matmul_every_flag_matches_jax(fname, m):
    jf, tf = jax_field(fname), torch_field(fname)
    rng = np.random.default_rng(m)
    A, B = _ints(jf, rng, (3, m)), _ints(jf, rng, (m, 5))
    want_int = [[sum(int(A[i, k]) * int(B[k, j]) for k in range(m)) % jf.modulus
                 for j in range(5)] for i in range(3)]
    for a_t, b_t, r_t in FLAGS:
        a, b = _u32(jf, A.T if a_t else A), _u32(jf, B.T if b_t else B)
        jcfg = JM.MatMulConfig(a_transposed=a_t, b_transposed=b_t, result_transposed=r_t)
        tcfg = MatMulConfig(a_transposed=a_t, b_transposed=b_t, result_transposed=r_t)
        want = np.asarray(JM.matmul(jf, a, b, jcfg))
        got = matmul(tf, interop.elements_from_numpy(tf, a, CPU),
                     interop.elements_from_numpy(tf, b, CPU), tcfg)
        assert np.array_equal(interop.elements_to_numpy(tf, got), want), (a_t, b_t, r_t)
        ints = tf.to_ints(got)
        assert [[int(v) for v in row] for row in (ints.T if r_t else ints)] == want_int


@pytest.mark.parametrize("fname", FIELDS)
def test_matrix_transpose_matches_jax(fname):
    jf, tf = jax_field(fname), torch_field(fname)
    rng = np.random.default_rng(9)
    for shape in ((3, 4), (2, 3, 5)):
        a = _u32(jf, _ints(jf, rng, shape))
        got = TM.matrix_transpose(tf, interop.elements_from_numpy(tf, a, CPU))
        want = np.asarray(JM.matrix_transpose(jf, a))
        assert got.is_contiguous() and np.array_equal(interop.elements_to_numpy(tf, got), want)


def test_tree_sum_order():
    """An odd count joins its leftover at the next level, as the JAX
    package's `_tree_sum`: the sum is the field sum whatever the order."""
    tf = torch_field("goldilocks")
    ints = _ints(jax_field("goldilocks"), np.random.default_rng(10), (7, 2))
    x = tf.from_ints(ints, CPU)
    got = tf.to_ints(TM._tree_sum(tf, x, axis=0))
    assert [int(v) for v in got] == [sum(int(v) for v in ints[:, j]) % tf.modulus for j in range(2)]
