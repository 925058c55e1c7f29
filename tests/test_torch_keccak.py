"""The port's Keccak / SHA-3 hashes (icicle_tpu_torch/ops/hash/keccak.py,
kernel K1's plain version `keccak_ref` on the CPU) against the JAX
package's (icicle_tpu/ops/hash/keccak.py), hashlib's SHA-3, the known
vectors of tests/test_byte_hashes.py:21-32 and the host library
(icicle_tpu_torch/utils/native.py); Keccak-256 Merkle trees against the
JAX package's `MerkleTree`, and a JAX-built one carried across by
`interop.merkle_tree_from_numpy`. Inputs come from numpy seeds; tolerance:
exact equality. The JAX hashers are shared, so that each shape compiles
once."""

import functools
import hashlib
import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from icicle_tpu.ops.hash import keccak as JK
from icicle_tpu.ops.merkle import MerkleTree as JaxTree
from icicle_tpu_torch import Keccak256, Keccak512, MerkleTree, Sha3_256, Sha3_512
from icicle_tpu_torch.interop import merkle_tree_from_numpy
from icicle_tpu_torch.kernels import keccak_kernel
from icicle_tpu_torch.runtime import device
from icicle_tpu_torch.runtime.errors import IcicleException
from icicle_tpu_torch.utils import native

torch.set_num_threads(1)

VARIANTS = {"keccak_256": (Keccak256, JK.Keccak256), "keccak_512": (Keccak512, JK.Keccak512),
            "sha3_256": (Sha3_256, JK.Sha3_256), "sha3_512": (Sha3_512, JK.Sha3_512)}


@pytest.fixture(autouse=True)
def on_cpu(monkeypatch):
    monkeypatch.setattr(device, "_device", torch.device("cpu"))


@functools.lru_cache(maxsize=None)
def _jax(name: str):
    return VARIANTS[name][1]()


def _words(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.uint32).view(np.int32))


@pytest.mark.parametrize("name", ["sha3_256", "sha3_512"])
@pytest.mark.parametrize("n", [0, 1, 31, 64, 71, 72, 73, 135, 136, 137, 300])
def test_sha3_hash_bytes_matches_hashlib(name, n):
    data = np.random.default_rng(n).bytes(n)
    assert VARIANTS[name][0]().hash_bytes(data) == hashlib.new(name, data).digest()


def test_known_vectors():
    assert Keccak256().hash_bytes(b"").hex() == \
        "c5d2460186f7233c927e7db2dcc703c0e500b653ca82273b7bfad8045d85a470"
    assert Keccak256().hash_bytes(b"abc").hex() == \
        "4e03657aea45a94fc7d47ba826c8d667c0d1e6e33a64a036ec44f58fa12d6c45"
    assert Keccak512().hash_bytes(b"abc").hex() == \
        "18587dc2ea106b9a1563e32b3312421ca164c7f1f07bc922a9c83d77cea3a1e5" \
        "d0c69910739025372dc14ac9642629379540c17e2a65b19d77aa511a9d00bb96"


@pytest.mark.parametrize("name", sorted(VARIANTS))
@pytest.mark.parametrize("n", [0, 137])
def test_hash_bytes_batch_matches_jax(name, n):
    data = np.random.default_rng(100 + n).bytes(3 * n)
    assert VARIANTS[name][0]().hash_bytes(data, batch=3) == _jax(name).hash_bytes(data, batch=3)


@pytest.mark.parametrize("name,in_words", [("keccak_256", w) for w in (1, 8, 16, 34, 35)]
                         + [("sha3_512", 17), ("sha3_512", 18), ("keccak_512", 16),
                            ("sha3_256", 33)])
def test_hash_words_matches_jax(name, in_words):
    """Word inputs padded in the kernel's way, at rate boundaries too (34
    words is one rate of Keccak-256 and takes two blocks)."""
    x = np.random.default_rng(in_words).integers(0, 1 << 32, size=(5, in_words), dtype=np.uint32)
    got = VARIANTS[name][0]().hash_words(_words(x))
    want = np.asarray(_jax(name).hash_words(jnp.asarray(x)))
    assert got.dtype == torch.int32 and got.numpy().view(np.uint32).tolist() == want.tolist()


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_native_library_and_ref_agree(name):
    """The host library's digests, hash_words over the same bytes and
    hashlib (SHA-3) agree for every length 0..300 in steps of 4 bytes."""
    rng = np.random.default_rng(7)
    h = VARIANTS[name][0]()
    for n in range(0, 301, 28):
        data = rng.bytes(n)
        digest = native.host_hash(name, data)
        words = _words(np.frombuffer(data, dtype="<u4").reshape(1, -1))
        assert h.hash_words(words).numpy().view(np.uint32).astype("<u4").tobytes() == digest
        if name.startswith("sha3"):
            assert digest == hashlib.new(name, data).digest()


def test_padded_rows_and_word_rows_are_one_function():
    """keccak(h, x, padded=True) over host-padded rows equals hash_words of
    the same words; a padded row that is not whole blocks raises."""
    h = Keccak256()
    x = np.random.default_rng(3).integers(0, 1 << 32, size=(4, 20), dtype=np.uint32)
    padded = keccak_kernel.words_of_bytes(x.view(np.uint8).reshape(4, 80), 136, 0x01)
    a = keccak_kernel.keccak(h, torch.from_numpy(padded), padded=True)
    assert torch.equal(a, h.hash_words(_words(x)))
    with pytest.raises(IcicleException, match="whole blocks"):
        keccak_kernel.keccak(h, torch.zeros((1, 35), dtype=torch.int32), padded=True)
    with pytest.raises(IcicleException, match="int32"):
        h.hash_words(torch.zeros((1, 3), dtype=torch.int64))


def test_native_build_is_race_free(tmp_path, monkeypatch):
    """Builders in parallel each compile to a name of their own and rename
    it into place: the library loads and hashes afterwards."""
    monkeypatch.setattr(native, "LIBRARY", str(tmp_path / "libicicle_host.so"))
    errors = []

    def run():
        try:
            native.build()
        except Exception as e:  # noqa: BLE001 -- collected for the assert
            errors.append(e)

    threads = [threading.Thread(target=run) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    assert [p.name for p in tmp_path.iterdir()] == ["libicicle_host.so"]
    import ctypes
    lib = ctypes.CDLL(str(tmp_path / "libicicle_host.so"))
    out = ctypes.create_string_buffer(32)
    assert lib.icicle_host_hash(0, b"abc", 3, out, 32) == 0
    assert out.raw == Keccak256().hash_bytes(b"abc")


def test_native_build_failure_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "LIBRARY", str(tmp_path / "lib.so"))
    monkeypatch.setattr(native, "SOURCE", str(tmp_path / "missing.cpp"))
    (tmp_path / "missing.cpp").write_text("this is not C++")
    with pytest.raises(IcicleException, match="BACKEND_LOAD_FAILED"):
        native.build()


@functools.lru_cache(maxsize=None)
def _trees(log_n: int, leaf_words: int = 1):
    """A JAX and a port Keccak-256 binary tree over the same 2^log_n leaves
    of `leaf_words` words, both built: with one-word leaves the FRI trees'
    shape (a leaf hash, then log_n compressions), with 8-word leaves
    compressions only."""
    leaves = np.random.default_rng(log_n).integers(0, 1 << 32, size=(1 << log_n, leaf_words),
                                                   dtype=np.uint32)
    jh, ph = _jax("keccak_256"), Keccak256()
    lead = [] if leaf_words == 8 else [1]
    jt = JaxTree([jh.with_input_words(w) for w in lead] + [jh.with_input_words(16)] * log_n,
                 leaf_words)
    pt = MerkleTree([ph.with_input_words(w) for w in lead] + [ph.with_input_words(16)] * log_n,
                    leaf_words)
    jt.build(jnp.asarray(leaves))
    pt.build(_words(leaves))
    return leaves, jt, pt


@pytest.mark.parametrize("leaf_words", [1, 8])
def test_keccak_merkle_tree_matches_jax(leaf_words):
    _, jt, pt = _trees(5, leaf_words)
    assert np.array_equal(pt.get_root(), np.asarray(jt.get_root()))
    for a, b in zip(jt.layers, pt.layers):
        assert np.array_equal(b.numpy().view(np.uint32), np.asarray(a))


@pytest.mark.parametrize("leaf_words,pruned", [(1, False), (8, False), (8, True)])
def test_keccak_merkle_proofs_match_jax(leaf_words, pruned):
    """Proofs serialize as the JAX tree's, verify, and fail with the leaf
    flipped (a one-word leaf layer has arity 1, which a pruned proof
    cannot express in either package)."""
    leaves, jt, pt = _trees(5, leaf_words)
    for idx in (0, 13, 31):
        jp = jt.get_merkle_proof(leaves, idx, pruned=pruned)
        pp = pt.get_merkle_proof(_words(leaves), idx, pruned=pruned)
        assert pp.serialize() == jp.serialize()
        assert pt.verify(pp) and jt.verify(jp)
        bad = type(pp)(pp.leaf ^ 1, idx, pp.root, pp.path, pruned)
        assert not pt.verify(bad)


def test_interop_keccak_tree():
    """A JAX-built Keccak tree carried across: the same root, proofs that
    the port verifies and that serialize as the JAX tree's do."""
    leaves, jt, _ = _trees(5)
    ph = Keccak256()
    tree = merkle_tree_from_numpy([ph.with_input_words(1)] + [ph.with_input_words(16)] * 5, 1,
                                  [np.asarray(layer) for layer in jt.layers], device="cpu")
    assert np.array_equal(tree.get_root(), np.asarray(jt.get_root()))
    proof = tree.get_merkle_proof(tree.layers[0], 21, pruned=False)
    assert tree.verify(proof)
    assert proof.serialize() == jt.get_merkle_proof(leaves, 21, pruned=False).serialize()
