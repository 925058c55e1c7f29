"""Hashes over the word-level interface (counterpart of icicle_tpu/ops/hash/).

Ported so far: the `Hash` facade (hash.py), Poseidon2 (poseidon2.py,
with its constants copied to data/poseidon2_*.npz) and the Keccak / SHA-3
family (keccak.py). Poseidon, Blake2s and Blake3 wait for ROADMAP.md
queue A item 4.
"""
