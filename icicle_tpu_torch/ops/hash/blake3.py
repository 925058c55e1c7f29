"""BLAKE3, default (unkeyed) mode with 32-byte digests (counterpart of
icicle_tpu/ops/hash/blake3.py; reference F7: backend/cpu/src/hash/
cpu_blake3.cpp).

`hash_words` hashes each row of 32-bit words as a message of 4 in_words
bytes; `hash_bytes` takes any byte length. Messages past one chunk (1024
bytes) are hashed chunk by chunk and merged a level at a time, as the JAX
package merges them. Both run through the dispatcher's api "blake3" on
their input's device: backend "cuda" is the kernel
(kernels/blake3_kernel.py `blake3`, which computes the plain version for a
CPU tensor), backend "torch" the plain version `blake3_ref`.
"""

from __future__ import annotations

from icicle_tpu_torch.kernels import blake3_kernel
from icicle_tpu_torch.kernels.blake3_kernel import blake3_ref  # noqa: F401
from icicle_tpu_torch.ops.hash.blake2s import _ByteHash
from icicle_tpu_torch.runtime import dispatcher

API = "blake3"


class Blake3(_ByteHash):
    """BLAKE3, 32-byte digests (reference create_blake3_hash)."""

    api = API
    default_input_words = 0


dispatcher.register_impl(API, dispatcher.TORCH, blake3_kernel.blake3_ref)
dispatcher.register_impl(API, dispatcher.CUDA, blake3_kernel.blake3)
