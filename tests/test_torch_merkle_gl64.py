"""A goldilocks Poseidon2 Merkle tree in the port (icicle_tpu_torch/ops/
merkle.py, word-level: a goldilocks leaf is 2 words) against the JAX
package's on the CPU: root, every stored layer, pruned and full proofs and
their bytes, tampered proofs; and the JAX-built tree carried across by
`interop.merkle_tree_from_numpy`. No merkle code changes for goldilocks:
the tree moves words and the hasher reads them as (.., 2) elements.

Leaves come from numpy seeds; tolerance: exact equality."""

import numpy as np
import pytest
import torch

from icicle_tpu_torch.interop import merkle_tree_from_numpy
from tests.test_torch_merkle import (_assert_layers_equal, _assert_proofs_equal, _hashers,
                                     _leaves, _t, _trees)

torch.set_num_threads(1)


@pytest.mark.parametrize("widths", [(2,) * 5, (4, 4, 2)], ids=["binary", "arity4"])
def test_goldilocks_tree_matches_jax(widths):
    jt, pt = _trees(widths, fname="goldilocks", leaf_words=2)
    assert pt.hashers[0].digest_words == 2
    leaves = _leaves(jt.expected_leaves(), seed=30, fname="goldilocks")
    assert leaves.shape == (jt.expected_leaves(), 2)
    assert np.array_equal(pt.build(_t(leaves)), jt.build(leaves))
    _assert_layers_equal(jt, pt)
    _assert_proofs_equal(jt, pt, leaves, 5, tamper=True)
    _assert_proofs_equal(jt, pt, leaves, jt.expected_leaves() - 1)


def test_goldilocks_tree_from_jax_layers():
    widths = (2,) * 4
    jt, _ = _trees(widths, fname="goldilocks", leaf_words=2)
    leaves = _leaves(16, seed=31, fname="goldilocks")
    jt.build(leaves)
    layers = [np.asarray(layer) for layer in jt.layers]
    pt = merkle_tree_from_numpy([_hashers("goldilocks", t)[1] for t in widths], 2, layers,
                                device="cpu")
    _assert_layers_equal(jt, pt)
    assert np.array_equal(pt.get_root(), jt.get_root())
    for idx in (0, 9):
        _assert_proofs_equal(jt, pt, leaves, idx)
