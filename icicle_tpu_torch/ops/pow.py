"""Proof-of-work grind (counterpart of icicle_tpu/ops/pow.py; reference F8:
include/icicle/hash/pow.h, backend/cpu/src/hash/cpu_pow.cpp).

The input is challenge || u64(nonce) little-endian || padding_size zero
bytes; a nonce solves when the digest's first 8 bytes, read
little-endian, are below 2^(64 - solution_bits). The search returns the
smallest solving nonce, grinding grids of `grid_size` nonces, each grid one
`hash_bytes` call of the hasher (for the Keccak family one launch of
kernel K1 on the card), as the JAX package does.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from icicle_tpu_torch.ops.hash.hash import Hash


@dataclasses.dataclass
class PowConfig:
    """Mirror of the reference's PowConfig (pow.h:16-23)."""
    padding_size: int = 24
    grid_size: int = 1024


def _check_bits(solution_bits: int) -> None:
    if not 1 <= solution_bits <= 60:
        raise ValueError("solution_bits must be in [1, 60]")


def _grid(challenge: bytes, offset: int, grid: int, padding: int) -> bytes:
    """`grid` inputs of nonces offset.. as one byte string of equal rows."""
    buf = np.zeros((grid, len(challenge) + 8 + padding), dtype=np.uint8)
    buf[:, :len(challenge)] = np.frombuffer(challenge, dtype=np.uint8)
    nonces = np.arange(grid, dtype=np.uint64) + np.uint64(offset)
    buf[:, len(challenge):len(challenge) + 8] = nonces.astype("<u8")[:, None].view(np.uint8)
    return buf.tobytes()


def proof_of_work(hasher: Hash, challenge: bytes, solution_bits: int,
                  cfg: PowConfig | None = None) -> tuple[bool, int, int]:
    """(found, nonce, mined value): the reference's cpu_pow."""
    _check_bits(solution_bits)
    cfg = cfg or PowConfig()
    threshold = 1 << (64 - solution_bits)
    offset = 0
    for _ in range(1 << 22):  # a practical cap (the reference scans all of u64)
        digests = hasher.hash_bytes(_grid(challenge, offset, cfg.grid_size, cfg.padding_size),
                                    batch=cfg.grid_size)
        ds = np.frombuffer(digests, dtype=np.uint8).reshape(cfg.grid_size, -1)
        vals = ds[:, :8].copy().view("<u8").reshape(-1)
        hits = np.nonzero(vals < threshold)[0]
        if hits.size:
            i = int(hits[0])
            return True, offset + i, int(vals[i])
        offset += cfg.grid_size
    return False, 0, 0


def proof_of_work_verify(hasher: Hash, challenge: bytes, solution_bits: int, nonce: int,
                         cfg: PowConfig | None = None) -> tuple[bool, int]:
    """(is_correct, mined value)."""
    _check_bits(solution_bits)
    cfg = cfg or PowConfig()
    data = challenge + int(nonce).to_bytes(8, "little") + b"\x00" * cfg.padding_size
    val = int.from_bytes(hasher.hash_bytes(data, batch=1)[:8], "little")
    return val < (1 << (64 - solution_bits)), val
