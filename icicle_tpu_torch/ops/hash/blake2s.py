"""BLAKE2s-256 (counterpart of icicle_tpu/ops/hash/blake2s.py; reference F7:
backend/cpu/src/hash/cpu_blake2s.cpp; RFC 7693).

`hash_words` hashes each row of 32-bit words as a message of 4 in_words
bytes; `hash_bytes` takes any byte length, its counter the exact length,
as the JAX package's. Both run through the dispatcher's api "blake2s" on
their input's device: backend "cuda" is the kernel
(kernels/blake2s_kernel.py `blake2s`, which computes the plain version for
a CPU tensor), backend "torch" the plain version `blake2s_ref`.
"""

from __future__ import annotations

import numpy as np
import torch

from icicle_tpu_torch.kernels import blake2s_kernel
from icicle_tpu_torch.kernels.blake2s_kernel import blake2s_ref  # noqa: F401
from icicle_tpu_torch.ops.hash.hash import Hash
from icicle_tpu_torch.runtime import dispatcher
from icicle_tpu_torch.runtime.config import HashConfig
from icicle_tpu_torch.runtime.device import resolve
from icicle_tpu_torch.runtime.errors import IcicleError, IcicleException

API = "blake2s"


def words_of_bytes(data: bytes, batch: int) -> tuple[np.ndarray, int]:
    """`batch` equal byte chunks -> ((batch, ceil(n / 4)) int32 words, zero
    past the message, and n, the chunks' length in bytes)."""
    if len(data) % batch:
        raise IcicleException(IcicleError.INVALID_ARGUMENT,
                              f"{len(data)} bytes do not split into {batch} chunks")
    n = len(data) // batch
    buf = np.zeros((batch, -(-n // 4) * 4), dtype=np.uint8)
    buf[:, :n] = np.frombuffer(data, dtype=np.uint8).reshape(batch, n)
    return buf.view("<u4").astype(np.uint32).view(np.int32), n


class _ByteHash(Hash):
    """A byte hash over an api whose implementations take (words, nbytes)."""

    api: str
    digest_words = 8

    def _run(self, x: torch.Tensor, nbytes: int, cfg: HashConfig | None) -> torch.Tensor:
        return dispatcher.dispatch(self.api, None if cfg is None else cfg.backend, x)(x, nbytes)

    def hash_words(self, x: torch.Tensor, cfg: HashConfig | None = None) -> torch.Tensor:
        """(batch, in_words) int32 words -> (batch, 8) int32 digests of the
        4 in_words-byte messages, on x's device."""
        if not isinstance(x, torch.Tensor) or x.dim() != 2 or x.dtype != torch.int32:
            raise IcicleException(IcicleError.INVALID_ARGUMENT,
                                  f"{self.api} hash_words takes a (batch, in_words) int32 "
                                  f"tensor, got {getattr(x, 'shape', type(x))}")
        return self._run(x, 4 * x.shape[1], cfg)

    def hash_bytes(self, data: bytes, batch: int = 1) -> bytes:
        """Digests of `batch` equal-size byte chunks of any length, on the
        default device."""
        words, n = words_of_bytes(data, batch)
        out = self._run(torch.from_numpy(words).to(resolve(None)), n, None)
        return out.cpu().numpy().view(np.uint32).astype("<u4").tobytes()


class Blake2s(_ByteHash):
    """BLAKE2s-256, 32-byte digests (reference create_blake2s_hash)."""

    api = API


dispatcher.register_impl(API, dispatcher.TORCH, blake2s_kernel.blake2s_ref)
dispatcher.register_impl(API, dispatcher.CUDA, blake2s_kernel.blake2s)
