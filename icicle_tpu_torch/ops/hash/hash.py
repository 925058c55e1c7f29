"""Hash facade (counterpart of icicle_tpu/ops/hash/hash.py; reference F7:
include/icicle/hash/hash.h Hash over HashBackend).

Every hash exposes one vectorised word-level interface,
``hash_words((batch, in_words) int32) -> (batch, digest_words) int32``,
whose words are the JAX package's uint32 words held as int32 bit patterns
(field hashes: the element limbs). The Merkle tree composes hashes at this
level only; `hash_bytes` is the host byte boundary of the reference's byte
API.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from icicle_tpu_torch.runtime.config import HashConfig
from icicle_tpu_torch.runtime.device import resolve


class Hash:
    """Abstract vectorised hash."""

    #: digest size in 32-bit words
    digest_words: int = 0
    #: natural input block in 32-bit words (0 = any length)
    default_input_words: int = 0

    def hash_words(self, x: torch.Tensor, cfg: HashConfig | None = None) -> torch.Tensor:
        """(batch, in_words) int32 -> (batch, digest_words) int32, on x's
        device."""
        raise NotImplementedError

    @property
    def output_size(self) -> int:
        """Digest size in bytes (reference Hash::output_size())."""
        return self.digest_words * 4

    def with_input_words(self, words: int) -> "Hash":
        """A view of this hash pinned to a fixed input width, which a Merkle
        layer reads as its arity."""
        h = copy.copy(self)
        h.default_input_words = words
        return h

    # -- host byte boundary ----------------------------------------------------
    def hash_bytes(self, data: bytes, batch: int = 1) -> bytes:
        """Hash `batch` equal-size byte chunks (reference Hash::hash byte API)
        on the default device.

        Input bytes are read as little-endian 32-bit words; a chunk whose
        length is not a word multiple is zero-padded to the next word."""
        assert len(data) % batch == 0
        chunk = len(data) // batch
        padded = chunk + (-chunk) % 4
        buf = np.zeros((batch, padded), dtype=np.uint8)
        buf[:, :chunk] = np.frombuffer(data, dtype=np.uint8).reshape(batch, chunk)
        words = buf.view("<u4").astype(np.uint32).view(np.int32)
        x = torch.from_numpy(words.reshape(batch, padded // 4)).to(resolve(None))
        out = self.hash_words(x).cpu().numpy().view(np.uint32).astype("<u4")
        return out.tobytes()
