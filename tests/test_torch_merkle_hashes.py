"""Merkle trees over the port's Blake2s, Blake3 and Poseidon against the JAX
package's trees on the CPU: roots, every layer, pruned and full proofs
and their bytes (the helpers of tests/test_torch_merkle.py); and a
bls12_381_scalar Poseidon oct-tree (t = 9 with a domain tag: 8 children a
hash, Filecoin's tree shape) against the Python-int model of
tests/test_torch_poseidon.py, since JAX compiles that hash for minutes here.
Exact equality."""

import functools

import numpy as np
import pytest
import torch

from icicle_tpu.fields.field import get_field as jax_field
from icicle_tpu.ops.hash.blake2s import Blake2s as JBlake2s
from icicle_tpu.ops.hash.blake3 import Blake3 as JBlake3
from icicle_tpu.ops.hash.poseidon import Poseidon as JPoseidon
from icicle_tpu.ops.merkle import MerkleTree as JaxTree
from icicle_tpu_torch import Blake2s, Blake3, MerkleProof, MerkleTree, Poseidon
from tests.test_torch_merkle import _assert_layers_equal, _assert_proofs_equal, _t
from tests.test_torch_poseidon import as_ints, elements, poseidon_model

torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def hashers(name: str):
    """(JAX hasher, port hasher), built once: JAX compiles a layer shape once."""
    if name == "blake2s":
        return JBlake2s(), Blake2s()
    if name == "blake3":
        return JBlake3(), Blake3()
    fname, t = name.split(":")
    return (JPoseidon(jax_field(fname), int(t), domain_tag=0),
            Poseidon(fname, int(t), domain_tag=0))


def trees(name: str, depth: int, leaf_words: int):
    """A tree over 32-byte (Blake: 8-word) leaves, a layer hashing `arity`
    digests: 2 for the Blake hashes (64 bytes a compression), t - 1 for
    Poseidon with its tag."""
    jh, ph = hashers(name)
    if name.startswith("blake"):
        jl, pl = [jh.with_input_words(16)] * depth, [ph.with_input_words(16)] * depth
    else:
        jl, pl = [jh] * depth, [ph] * depth
    return JaxTree(jl, leaf_words), MerkleTree(pl, leaf_words)


@pytest.mark.parametrize("name,depth,leaf_words", [
    ("blake2s", 6, 8), ("blake2s", 10, 8), ("blake3", 6, 8), ("blake3", 10, 8),
    ("babybear:3", 8, 1), ("koalabear:5", 4, 1)])
def test_tree_matches_jax(name, depth, leaf_words):
    jt, pt = trees(name, depth, leaf_words)
    n = pt.expected_leaves()
    leaves = np.random.default_rng(depth).integers(0, 1 << 30, size=(n, leaf_words),
                                                   dtype=np.uint32)
    assert np.array_equal(pt.build(_t(leaves)), jt.build(leaves))
    _assert_layers_equal(jt, pt)
    _assert_proofs_equal(jt, pt, leaves, n - 1)
    _assert_proofs_equal(jt, pt, leaves, (5 * depth) % n, tamper=True)


def test_bls12_381_oct_tree_matches_the_model():
    f = "bls12_381_scalar"
    h = Poseidon(f, 9, domain_tag=0)
    tree = MerkleTree([h] * 3, leaf_words=8)
    assert tree.arities == [8, 8, 8]
    leaves = elements(f, (8 ** 3,), seed=9)                       # (512, 8) limbs
    root = tree.build(_t(leaves))
    layer = as_ints(f, leaves)
    for i in range(1, 4):
        layer = [poseidon_model(f, 9, layer[8 * j:8 * j + 8], 0) for j in range(len(layer) // 8)]
        assert as_ints(f, tree.layers[i].numpy().view(np.uint32)) == layer, f"layer {i}"
    assert as_ints(f, root.reshape(1, 8)) == layer
    for idx, pruned in ((300, True), (511, False)):
        proof = tree.get_merkle_proof(_t(leaves), idx, pruned=pruned)
        assert tree.verify(MerkleProof.deserialize(proof.serialize()))
        assert not tree.verify(MerkleProof(proof.leaf ^ 1, idx, proof.root, proof.path, pruned))
