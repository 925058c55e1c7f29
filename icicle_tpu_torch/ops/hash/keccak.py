"""Keccak / SHA-3 (counterpart of icicle_tpu/ops/hash/keccak.py; reference F7:
backend/cpu/src/hash/cpu_keccak.cpp).

Variants, as the reference's create_keccak_256_hash() family: Keccak256
and Keccak512 (domain byte 0x01, the pre-NIST padding Ethereum uses),
Sha3_256 and Sha3_512 (0x06). `hash_words` takes whole 32-bit words (the
Merkle tree's and the transcript's unit), word 2w being the low half of
lane w, and pads them as the JAX package does; `hash_bytes` takes any byte
length, padded on the host. Both run through the dispatcher's api "keccak"
on their input's device: backend "cuda" is kernel K1
(kernels/keccak_kernel.py `keccak`, which computes the plain version for a
CPU tensor), backend "torch" the plain version `keccak_ref`.
"""

from __future__ import annotations

import numpy as np
import torch

from icicle_tpu_torch.kernels import keccak_kernel
from icicle_tpu_torch.ops.hash.hash import Hash
from icicle_tpu_torch.runtime import dispatcher
from icicle_tpu_torch.runtime.config import HashConfig
from icicle_tpu_torch.runtime.device import resolve
from icicle_tpu_torch.runtime.errors import IcicleError, IcicleException

API = "keccak"


class _KeccakBase(Hash):
    rate_bytes: int
    pad_byte: int

    def _run(self, x: torch.Tensor, cfg: HashConfig | None, padded: bool) -> torch.Tensor:
        backend = None if cfg is None else cfg.backend
        return dispatcher.dispatch(API, backend, x)(self, x, padded)

    def hash_words(self, x: torch.Tensor, cfg: HashConfig | None = None) -> torch.Tensor:
        """(batch, in_words) int32 words -> (batch, digest_words) int32, on
        x's device."""
        if not isinstance(x, torch.Tensor) or x.dim() != 2 or x.dtype != torch.int32:
            raise IcicleException(IcicleError.INVALID_ARGUMENT,
                                  "keccak hash_words takes a (batch, in_words) int32 tensor, "
                                  f"got {getattr(x, 'shape', type(x))}")
        return self._run(x, cfg, padded=False)

    def hash_bytes(self, data: bytes, batch: int = 1) -> bytes:
        """Digests of `batch` equal-size byte chunks of any length: padded
        on the host (the JAX package's `_pad_host`), absorbed on the
        default device."""
        if len(data) % batch:
            raise IcicleException(IcicleError.INVALID_ARGUMENT,
                                  f"{len(data)} bytes do not split into {batch} chunks")
        raw = np.frombuffer(data, dtype=np.uint8).reshape(batch, -1)
        words = keccak_kernel.words_of_bytes(raw, self.rate_bytes, self.pad_byte)
        x = torch.from_numpy(words).to(resolve(None))
        out = self._run(x, None, padded=True)
        return out.cpu().numpy().view(np.uint32).astype("<u4").tobytes()


class Keccak256(_KeccakBase):
    rate_bytes = 136
    pad_byte = 0x01
    digest_words = 8


class Keccak512(_KeccakBase):
    rate_bytes = 72
    pad_byte = 0x01
    digest_words = 16


class Sha3_256(_KeccakBase):
    rate_bytes = 136
    pad_byte = 0x06
    digest_words = 8


class Sha3_512(_KeccakBase):
    rate_bytes = 72
    pad_byte = 0x06
    digest_words = 16


dispatcher.register_impl(API, dispatcher.TORCH, keccak_kernel.keccak_ref)
dispatcher.register_impl(API, dispatcher.CUDA, keccak_kernel.keccak)
