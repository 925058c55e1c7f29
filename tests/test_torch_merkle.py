"""The port's Merkle tree (icicle_tpu_torch/ops/merkle.py) against the JAX
package's `MerkleTree` on the CPU: roots, every stored layer, proofs and
their serialized bytes, tampered proofs, and a JAX-built tree carried
across by `interop.merkle_tree_from_numpy`. Leaves come from numpy seeds;
tolerance: exact equality. The JAX hashers are shared across tests, so
that each layer shape compiles once."""

import functools

import numpy as np
import pytest
import torch

from icicle_tpu.fields.field import get_field as jax_field
from icicle_tpu.ops.hash.poseidon2 import Poseidon2 as JaxPoseidon2
from icicle_tpu.ops.merkle import MerkleProof as JaxProof
from icicle_tpu.ops.merkle import MerkleTree as JaxTree
from icicle_tpu.runtime.config import MerkleTreeConfig as JaxConfig
from icicle_tpu.runtime.errors import IcicleException as JaxIcicleException
from icicle_tpu_torch import MerkleProof, MerkleTree, MerkleTreeConfig, Poseidon2
from icicle_tpu_torch.interop import merkle_tree_from_numpy
from icicle_tpu_torch.runtime import device
from icicle_tpu_torch.runtime.errors import IcicleException

torch.set_num_threads(1)

MIXED = (4, 2, 4, 2)  # the widths of tests/test_merkle.py:132's mixed-arity tree


@functools.lru_cache(maxsize=None)
def _hashers(fname: str, t: int):
    """(JAX hasher, port hasher) of one width, built once."""
    return JaxPoseidon2(jax_field(fname), t), Poseidon2(fname, t)


def _trees(widths, fname="babybear", leaf_words=1, min_layer=0):
    pairs = [_hashers(fname, t) for t in widths]
    return (JaxTree([j for j, _ in pairs], leaf_words, min_layer),
            MerkleTree([p for _, p in pairs], leaf_words, min_layer))


def _leaves(n: int, seed: int, fname="babybear", leaf_words=1) -> np.ndarray:
    f = jax_field(fname)
    rng = np.random.default_rng(seed)
    if f.limb_shape == ():
        return rng.integers(0, f.modulus, size=(n, leaf_words), dtype=np.uint32)
    vals = [int.from_bytes(rng.bytes(40), "little") % f.modulus for _ in range(n)]
    return np.asarray(f.from_ints(vals), dtype=np.uint32).reshape(n, -1)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.uint32).view(np.int32))


def _assert_layers_equal(jt: JaxTree, pt: MerkleTree):
    assert len(jt.layers) == len(pt.layers)
    for i, (a, b) in enumerate(zip(jt.layers, pt.layers)):
        assert (a is None) == (b is None), f"layer {i}"
        if a is not None:
            assert np.array_equal(b.numpy().view(np.uint32), np.asarray(a)), f"layer {i}"


def _assert_proofs_equal(jt: JaxTree, pt: MerkleTree, leaves: np.ndarray, idx: int,
                         tamper: bool = False):
    """Pruned and full proofs of leaf idx equal JAX's, as objects and as
    bytes, and verify; with `tamper`, altered copies of the pruned one fail."""
    for pruned in (True, False):
        jp = jt.get_merkle_proof(leaves, idx, pruned=pruned)
        pp = pt.get_merkle_proof(_t(leaves), idx, pruned=pruned)
        assert pp.leaf_idx == jp.leaf_idx and pp.pruned == jp.pruned
        assert np.array_equal(pp.leaf, jp.leaf) and np.array_equal(pp.root, jp.root)
        assert len(pp.path) == len(jp.path)
        assert all(np.array_equal(a, b) for a, b in zip(pp.path, jp.path))
        data = pp.serialize()
        assert data == jp.serialize()
        assert pt.verify(pp) and pt.verify(MerkleProof.deserialize(data))
        assert jt.verify(JaxProof.deserialize(data))
        if tamper and pruned:
            _assert_tampered_fail(pt, pp)


def _assert_tampered_fail(pt: MerkleTree, proof: MerkleProof):
    flip_leaf = MerkleProof(proof.leaf ^ 1, proof.leaf_idx, proof.root, proof.path,
                            proof.pruned)
    path = [seg.copy() for seg in proof.path]
    path[-1][0] ^= 1
    flip_path = MerkleProof(proof.leaf, proof.leaf_idx, proof.root, path, proof.pruned)
    flip_root = MerkleProof(proof.leaf, proof.leaf_idx, proof.root ^ 1, proof.path,
                            proof.pruned)
    assert not any(pt.verify(p) for p in (flip_leaf, flip_path, flip_root))


@pytest.mark.parametrize("depth", range(4, 13))
def test_binary_tree_matches_jax(depth):
    jt, pt = _trees([2] * depth)
    leaves = _leaves(1 << depth, seed=depth)
    root = pt.build(_t(leaves))
    assert np.array_equal(root, jt.build(leaves))
    _assert_layers_equal(jt, pt)
    _assert_proofs_equal(jt, pt, leaves, (1 << depth) - 1)
    _assert_proofs_equal(jt, pt, leaves, (5 * depth) % (1 << depth), tamper=depth == 12)


@pytest.mark.parametrize("widths", [(4, 4, 4, 4), MIXED], ids=["arity4", "mixed"])
def test_arity_matches_jax(widths):
    jt, pt = _trees(widths)
    n = jt.expected_leaves()
    assert pt.arities == jt.arities and pt.expected_leaves() == n
    leaves = _leaves(n, seed=n)
    assert np.array_equal(pt.build(_t(leaves)), jt.build(leaves))
    _assert_layers_equal(jt, pt)
    for idx in (0, 17, n - 1):
        _assert_proofs_equal(jt, pt, leaves, idx, tamper=idx == 17)


@pytest.mark.parametrize("policy", ["zero", "last_value"])
def test_padding_matches_jax(policy):
    jt, pt = _trees([2] * 3)
    leaves = _leaves(5, seed=11)
    root = pt.build(_t(leaves), MerkleTreeConfig(padding_policy=policy))
    assert np.array_equal(root, jt.build(leaves, JaxConfig(padding_policy=policy)))
    _assert_layers_equal(jt, pt)
    _assert_proofs_equal(jt, pt, leaves, 2, tamper=True)


def test_no_padding_policy_and_too_many_leaves_raise():
    _, pt = _trees([2] * 3)
    with pytest.raises(IcicleException, match="no padding policy"):
        pt.build(_t(_leaves(5, seed=12)))
    with pytest.raises(IcicleException, match="too many leaves"):
        pt.build(_t(_leaves(9, seed=12)), MerkleTreeConfig(padding_policy="zero"))
    with pytest.raises(IcicleException, match="not a multiple"):
        MerkleTree([Poseidon2("babybear", 2)] * 3, leaf_words=2).build(
            _t(_leaves(15, seed=12)).reshape(-1))


@pytest.mark.parametrize("min_layer", [1, 3])
def test_output_store_min_layer_matches_jax(min_layer):
    jt, pt = _trees([2] * 6, min_layer=min_layer)
    leaves = _leaves(64, seed=13)
    assert np.array_equal(pt.build(_t(leaves)), jt.build(leaves))
    _assert_layers_equal(jt, pt)
    assert pt.layers[min_layer] is None and pt.layers[min_layer + 1] is not None
    with pytest.raises(IcicleException, match="not stored"):
        pt.get_merkle_proof(_t(leaves), 3)


def test_chunks_keep_every_layer():
    """chunks=8 on 2^10 leaves: the same layers as JAX's chunked build."""
    jt, pt = _trees([2] * 10)
    leaves = _leaves(1 << 10, seed=14)
    assert np.array_equal(pt.build(_t(leaves), chunks=8), jt.build(leaves, chunks=8))
    _assert_layers_equal(jt, pt)
    _assert_proofs_equal(jt, pt, leaves, 777, tamper=True)


def test_uneven_chunks_keep_every_layer(monkeypatch):
    """A layer of 3 outputs in chunks=2 (which JAX runs whole): the port runs
    2 + 1 rows, with the layers of the unchunked build."""
    jt, pt = _trees([2, 3])
    leaves = _leaves(6, seed=15)
    calls = []
    hash_words = Poseidon2.hash_words

    def counting(self, x, cfg=None):
        calls.append(x.shape[0])
        return hash_words(self, x, cfg)

    monkeypatch.setattr(Poseidon2, "hash_words", counting)
    assert np.array_equal(pt.build(_t(leaves), chunks=2), jt.build(leaves, chunks=2))
    assert calls == [2, 1, 1]
    _assert_layers_equal(jt, pt)
    with pytest.raises(IcicleException, match="chunks must divide"):
        pt.build(_t(leaves), chunks=4)


def test_bn254_scalar_tree_matches_jax():
    jt, pt = _trees([2] * 3, fname="bn254_scalar", leaf_words=8)
    leaves = _leaves(8, seed=16, fname="bn254_scalar")
    assert np.array_equal(pt.build(_t(leaves)), jt.build(leaves))
    _assert_layers_equal(jt, pt)
    _assert_proofs_equal(jt, pt, leaves, 3, tamper=True)


def test_numpy_leaves_go_to_the_default_device(monkeypatch):
    monkeypatch.setattr(device, "_device", torch.device("cpu"))
    jt, pt = _trees([2] * 4)
    leaves = _leaves(16, seed=17)
    assert np.array_equal(pt.build(leaves.reshape(-1)), jt.build(leaves))
    assert pt.layers[0].device == torch.device("cpu")
    assert pt.verify(pt.get_merkle_proof(leaves, 9))


@pytest.mark.parametrize("min_layer", [0, 2])
def test_interop_tree_from_jax_layers(min_layer):
    jt, _ = _trees(MIXED, min_layer=min_layer)
    leaves = _leaves(jt.expected_leaves(), seed=18)
    jt.build(leaves)
    layers = [np.asarray(layer) if layer is not None else None for layer in jt.layers]
    pt = merkle_tree_from_numpy([_hashers("babybear", t)[1] for t in MIXED], 1, layers,
                                output_store_min_layer=min_layer, device="cpu")
    _assert_layers_equal(jt, pt)
    assert np.array_equal(pt.get_root(), jt.get_root())
    if min_layer == 0:
        for idx in (0, 33, 63):
            _assert_proofs_equal(jt, pt, leaves, idx)
    else:  # a tree with dropped layers gives no proofs, in JAX as here
        with pytest.raises(JaxIcicleException, match="not stored"):
            jt.get_merkle_proof(leaves, 0)
        with pytest.raises(IcicleException, match="not stored"):
            pt.get_merkle_proof(_t(leaves), 0)


def test_interop_rejects_non_canonical_words():
    jt, _ = _trees([2] * 2)
    leaves = _leaves(4, seed=19)
    jt.build(leaves)
    layers = [np.asarray(layer) for layer in jt.layers]
    layers[1] = layers[1].copy()
    layers[1][0, 0] = jax_field("babybear").modulus
    with pytest.raises(IcicleException, match="not canonical"):
        merkle_tree_from_numpy([_hashers("babybear", 2)[1]] * 2, 1, layers, device="cpu")


def test_numpy_leaves_and_bytes_raise_without_cuda(monkeypatch):
    """With no CUDA device and no set_device("cpu"), the host boundaries
    raise instead of computing on the CPU."""
    monkeypatch.setattr(device, "_device", None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, pt = _trees([2] * 2)
    with pytest.raises(IcicleException, match="no CUDA device"):
        pt.build(_leaves(4, seed=20))
    with pytest.raises(IcicleException, match="no CUDA device"):
        Poseidon2("babybear", 2).hash_bytes(b"\x01\x00\x00\x00\x02\x00\x00\x00")
