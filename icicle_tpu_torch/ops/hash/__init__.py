"""Hashes over the word-level interface (counterpart of icicle_tpu/ops/hash/).

The `Hash` facade (hash.py); the field hashes Poseidon2 (poseidon2.py) and
Poseidon (poseidon.py), their constants copied to data/poseidon2_*.npz and
data/poseidon_*.npz; and the byte hashes: the Keccak / SHA-3 family
(keccak.py), Blake2s (blake2s.py) and Blake3 (blake3.py). Every one has a
hand-written CUDA kernel (kernels/) and a plain torch version.
"""
