"""The port's Blake2s and Blake3 (icicle_tpu_torch/ops/hash/blake2s.py,
blake3.py) against hashlib, the known BLAKE3 vectors, the reference C++
backend's golden vectors and the JAX package, on the CPU (the plain
versions; the CUDA kernels are held against them on the card by
chip_smoke.py). Digests are bytes: exact equality."""

import functools
import hashlib

import numpy as np
import pytest
import torch

from icicle_tpu.ops.hash.blake2s import Blake2s as JBlake2s
from icicle_tpu.ops.hash.blake3 import Blake3 as JBlake3
from icicle_tpu_torch import Blake2s, Blake3, HashConfig
from icicle_tpu_torch.kernels import blake2s_kernel as B2
from icicle_tpu_torch.kernels import blake3_kernel as B3
from icicle_tpu_torch.runtime.errors import IcicleException
from tests import ref_ffi

torch.set_num_threads(1)


@pytest.fixture
def on_cpu():
    """hash_bytes computes on the default device: the CPU here."""
    from icicle_tpu_torch.runtime import device
    saved = device._device
    device.set_device("cpu")
    yield
    device._device = saved


@functools.lru_cache(maxsize=None)
def jax_hasher(name: str):
    return {"blake2s": JBlake2s, "blake3": JBlake3}[name]()


def words(batch: int, in_words: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << 32, size=(batch, in_words), dtype=np.uint32)


def tensor(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32).view(np.int32))


# -- Blake2s ---------------------------------------------------------------------------

def test_blake2s_equals_hashlib_at_every_length_to_200(on_cpu):
    h = Blake2s()
    rng = np.random.default_rng(2)
    for n in range(201):
        data = rng.integers(0, 256, size=(2, n), dtype=np.uint8)
        want = b"".join(hashlib.blake2s(row.tobytes()).digest() for row in data)
        assert h.hash_bytes(data.tobytes(), batch=2) == want, n


@pytest.mark.parametrize("n", [0, 1, 63, 64, 65, 130])
def test_blake2s_hash_bytes_equals_jax(n, on_cpu):
    data = np.random.default_rng(n).integers(0, 256, size=(3, n), dtype=np.uint8).tobytes()
    assert Blake2s().hash_bytes(data, batch=3) == jax_hasher("blake2s").hash_bytes(data, 3)


@pytest.mark.parametrize("in_words", [0, 1, 8, 16, 17, 40])
def test_blake2s_hash_words_equals_jax_and_hashlib(in_words):
    x = words(3, in_words, seed=in_words)
    got = Blake2s().hash_words(tensor(x)).numpy().view(np.uint32)
    want = np.asarray(jax_hasher("blake2s").hash_words(x)).astype(np.uint32)
    assert np.array_equal(got, want)
    for row, digest in zip(x, got):
        assert hashlib.blake2s(row.astype("<u4").tobytes()).digest() == digest.astype(
            "<u4").tobytes()


# -- Blake3 ----------------------------------------------------------------------------

def test_blake3_known_vectors(on_cpu):
    """tests/test_blake3.py:11-20: the official vectors' input pattern."""
    h = Blake3()
    assert h.hash_bytes(b"").hex() == \
        "af1349b9f5f9a1a6a0404dea36dcc9499bcb25c9adc112b7cc9a93cae41f3262"
    assert h.hash_bytes(b"\x00").hex() == \
        "2d3adedff11b61f14c886e35afa036736dcd87a74d27b5c1510225d0f592e213"
    assert h.hash_bytes(bytes(i % 251 for i in range(3))).hex() == \
        "e1be4d7a8ab5560aa4199eea339849ba8e293d55ca0a81006726d184519e647f"


# tests/test_blake3.py:30-38's calls, replayed through tests/ref_ffi on the same
# inputs (default_rng(nbytes), batch 2).
@pytest.mark.parametrize("nbytes", [1, 65, 1023, 1024, 2048])
def test_blake3_golden(nbytes, on_cpu):
    rng = np.random.default_rng(nbytes)
    data = rng.integers(0, 256, size=(2, nbytes), dtype=np.uint8)
    want = ref_ffi.byte_hash("blake3", data, 32)
    got = np.frombuffer(Blake3().hash_bytes(data.tobytes(), batch=2),
                        dtype=np.uint8).reshape(2, 32)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("nbytes", [1025, 3072, 5120])
def test_blake3_hash_bytes_equals_jax(nbytes, on_cpu):
    """Past one chunk: 5120 bytes is five chunks, so an odd chaining value is
    carried up a level."""
    data = np.random.default_rng(nbytes).integers(0, 256, size=(2, nbytes),
                                                  dtype=np.uint8).tobytes()
    assert Blake3().hash_bytes(data, batch=2) == jax_hasher("blake3").hash_bytes(data, 2)


@pytest.mark.parametrize("in_words", [0, 1, 8, 16])
def test_blake3_hash_words_equals_jax(in_words):
    x = words(3, in_words, seed=50 + in_words)
    got = Blake3().hash_words(tensor(x)).numpy().view(np.uint32)
    want = np.asarray(jax_hasher("blake3").hash_words(x)).astype(np.uint32)
    assert np.array_equal(got, want)


def test_blake3_counts():
    assert B3.SCHEDULE[1] == B3.MSG_PERM
    assert [B3.nof_chunks(n) for n in (0, 1024, 1025, 5120)] == [1, 1, 2, 5]
    assert [B3.parent_levels(n) for n in (1024, 2048, 5120, 8192)] == [0, 1, 3, 3]
    assert [B3.compressions(n) for n in (0, 64, 65, 1024, 8192)] == [1, 1, 2, 16, 128 + 7]
    assert B3.COMPRESS_OPS == 680 and B2.COMPRESS_OPS == 970


# -- both: the API -----------------------------------------------------------------------

@pytest.mark.parametrize("cls,kernel", [(Blake2s, B2.blake2s), (Blake3, B3.blake3)])
@pytest.mark.parametrize("backend", [None, "torch", "cuda"])
def test_backends_on_a_cpu_tensor_compute_the_plain_version(cls, kernel, backend):
    x = tensor(words(2, 300, seed=3))
    launches = kernel.launches
    got = cls().hash_words(x, HashConfig(backend=backend))
    assert torch.equal(got, cls().hash_words(x, HashConfig(backend="torch")))
    assert kernel.launches == launches


@pytest.mark.parametrize("fn", [B2.blake2s, B3.blake3])
def test_wrapper_errors(fn):
    x = tensor(words(2, 4, seed=4))
    with pytest.raises(IcicleException):
        fn(x, 17)                              # 4 words do not hold 17 bytes
    with pytest.raises(IcicleException):
        fn(x.to(torch.int64), 16)
    with pytest.raises(IcicleException):
        fn(x.t(), 8)                           # not contiguous
    assert fn(x, 13).shape == (2, 8)           # 13 bytes in 4 words
