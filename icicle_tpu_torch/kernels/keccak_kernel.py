"""Batched Keccak / SHA-3 over a hand-written CUDA kernel
(kernels/csrc/keccak.cu, kernel K1 of the port).

`keccak(h, x)` computes `h.hash_words(x)` for a Keccak-family hasher h
(ops/hash/keccak.py): one digest per row of 32-bit words, padded as the
JAX package's `hash_words` pads (icicle_tpu/ops/hash/keccak.py:148-160),
one thread a row, in one launch; `keccak(h, x, padded=True)` takes rows
that are whole blocks padded on the host (`hash_bytes`). No Pallas kernel
is replaced: the JAX package's sponge is XLA.

The plain version `keccak_ref` computes the sponge in torch on the
JAX package's (lo, hi) 32-bit halves, held in int64 tensors (CPU torch has
no `>>` or `<` on uint32, and `>>` of an int64 holding a full 64-bit lane
is arithmetic): the state is one (2, 5, 5, batch) tensor [half, y, x],
each round a few dozen whole-state operations, rho's 25 rotations one
vectorised step (`_rot64`'s cases as per-lane shift tensors).
`PERMUTATION_OPS` counts the 32-bit logic and shift instructions a
permutation needs, the kernel's bound.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from icicle_tpu_torch.kernels import protocol_lib as L

LIBRARY = "keccak"
MASK = 0xFFFFFFFF
_RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A, 0x8000000080008000,
    0x000000000000808B, 0x0000000080000001, 0x8000000080008081, 0x8000000000008009,
    0x000000000000008A, 0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089, 0x8000000000008003,
    0x8000000000008002, 0x8000000000000080, 0x000000000000800A, 0x800000008000000A,
    0x8000000080008081, 0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]
# rho's offset of lane x + 5 y (the Keccak reference's r[x][y])
_ROT = [0, 1, 62, 28, 27, 36, 44, 6, 55, 20, 3, 10, 43, 25, 39, 41, 45, 15, 21, 8, 18, 2, 61,
        56, 14]
# pi: lane x + 5 y goes to lane y + 5 ((2 x + 3 y) mod 5); _PI[dst] = src
_PI = [0] * 25
for _x in range(5):
    for _y in range(5):
        _PI[_y + 5 * ((2 * _x + 3 * _y) % 5)] = _x + 5 * _y

# 32-bit instructions of one permutation with three-input logic: a round's
# theta 20 (two 3-input XORs a column half) + 10 (C's rotation by 1) + 50
# (each lane half ^ C[x-1] ^ rot(C[x+1])), rho 48 (two funnel shifts for
# each of the 24 lanes that rotate), chi 50 (one LOP3 a lane half), and
# iota's XORs on the round constant's nonzero halves
PERMUTATION_OPS = 24 * (20 + 10 + 50 + 48 + 50) + sum(
    ((rc & MASK) != 0) + ((rc >> 32) != 0) for rc in _RC)


def nof_blocks(in_words: int, rate_words: int, padded: bool = False) -> int:
    """Sponge blocks of a row of in_words words (hash_words pads even a
    whole block with another)."""
    return in_words // rate_words if padded else in_words // rate_words + 1


def pad_words(x: torch.Tensor, rate_words: int, pad_byte: int) -> torch.Tensor:
    """(batch, in_words) int64 words -> (batch, blocks, rate_words): the
    JAX package's hash_words padding (the pad byte in the first pad word,
    0x80 in the top byte of the last)."""
    batch, in_words = x.shape
    total = nof_blocks(in_words, rate_words) * rate_words
    pad = x.new_zeros((batch, total - in_words))
    pad[:, 0] = pad_byte
    pad[:, -1] |= 0x80 << 24
    return torch.cat([x, pad], dim=1).view(batch, -1, rate_words)


def _tables(device):
    r = torch.tensor(_ROT, dtype=torch.int64, device=device).view(25, 1)
    return (r >= 32, r % 32, 32 - r % 32, torch.tensor(_PI, device=device),
            torch.tensor([[rc & MASK, rc >> 32] for rc in _RC], dtype=torch.int64,
                         device=device))


def keccak_f(s: torch.Tensor, tables) -> torch.Tensor:
    """The permutation of (2, 5, 5, batch) int64 states [half, y, x] of
    32-bit halves; returns a new state."""
    swap, rr, inv_rr, pi, rc = tables
    batch = s.shape[-1]
    for rnd in range(24):
        c = s[:, 0] ^ s[:, 1] ^ s[:, 2] ^ s[:, 3] ^ s[:, 4]          # (2, 5, B) [half, x]
        lo, hi = c[0], c[1]
        c_rot = torch.stack((((lo << 1) | (hi >> 31)) & MASK, ((hi << 1) | (lo >> 31)) & MASK))
        d = torch.roll(c, 1, dims=1) ^ torch.roll(c_rot, -1, dims=1)  # C[x-1] ^ rot(C[x+1])
        lanes = (s ^ d.unsqueeze(1)).view(2, 25, batch)
        lo = torch.where(swap, lanes[1], lanes[0])                     # rho, by _rot64's cases
        hi = torch.where(swap, lanes[0], lanes[1])
        rot = torch.stack((((lo << rr) | (hi >> inv_rr)) & MASK,
                           ((hi << rr) | (lo >> inv_rr)) & MASK))
        b = rot[:, pi].view(2, 5, 5, batch)                             # pi
        s = b ^ ((torch.roll(b, -1, dims=2) ^ MASK) & torch.roll(b, -2, dims=2))  # chi
        s[:, 0, 0] ^= rc[rnd].view(2, 1)                                # iota
    return s


def keccak_ref(h, x: torch.Tensor, padded: bool = False) -> torch.Tensor:
    """(batch, in_words) int32 words -> (batch, h.digest_words) int32
    digests of the Keccak-family hasher h (its rate_bytes, pad_byte and
    digest_words) in plain torch on x's device; `padded`: the rows are
    whole blocks that the host padded."""
    rate_words = h.rate_bytes // 4
    digest_words = h.digest_words
    batch = x.shape[0]
    words = x.to(torch.int64) & MASK
    blocks = (words.view(batch, -1, rate_words) if padded
              else pad_words(words, rate_words, h.pad_byte))
    tables = _tables(x.device)
    s = torch.zeros((2, 5, 5, batch), dtype=torch.int64, device=x.device)
    for k in range(blocks.shape[1]):
        blk = blocks[:, k].T                                            # (rate_words, B)
        flat = s.view(2, 25, batch)
        flat[0, :rate_words // 2] ^= blk[0::2]
        flat[1, :rate_words // 2] ^= blk[1::2]
        s = keccak_f(s, tables)
    flat = s.view(2, 25, batch)[:, :digest_words // 2]                  # (2, dw/2, B)
    return flat.permute(2, 1, 0).reshape(batch, digest_words).to(torch.int32)


_ARGTYPES = ((ctypes.c_void_p,) * 2 + (ctypes.c_longlong,) + (ctypes.c_int,) * 5
             + (ctypes.c_void_p,))


def keccak(h, x: torch.Tensor, padded: bool = False) -> torch.Tensor:
    """(batch, in_words) int32 words -> (batch, h.digest_words) int32
    digests of the Keccak-family hasher h.

    On a CUDA tensor this launches the kernel on the current stream (no
    synchronisation), counts the launch in `keccak.launches` and raises if
    the launch is refused. On a CPU tensor it computes `keccak_ref`."""
    L.check_words("keccak", x, 2)
    rate_words = h.rate_bytes // 4
    batch, in_words = x.shape
    if padded and (in_words == 0 or in_words % rate_words):
        raise L.invalid("keccak", f"padded rows must be whole blocks of {rate_words} words, "
                        f"got {in_words}")
    if not x.is_cuda:
        return keccak_ref(h, x, padded)
    out = torch.empty((batch, h.digest_words), dtype=torch.int32, device=x.device)
    if batch == 0:
        return out
    fn, error_string = L.entry(LIBRARY, "icicle_keccak", _ARGTYPES)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), out.data_ptr(), batch, in_words, h.rate_bytes, h.pad_byte,
                 h.digest_words, int(padded), L.stream())
    L.raise_on("keccak", err, error_string)
    keccak.launches += 1
    return out


keccak.launches = 0


def words_of_bytes(data: np.ndarray, rate_bytes: int, pad_byte: int) -> np.ndarray:
    """(batch, nbytes) uint8 -> (batch, blocks * rate_bytes / 4) int32 words:
    the host padding of `hash_bytes` (icicle_tpu/ops/hash/keccak.py:127-136
    `_pad_host`), for any byte length."""
    batch, n = data.shape
    blocks = n // rate_bytes + 1
    buf = np.zeros((batch, blocks * rate_bytes), dtype=np.uint8)
    buf[:, :n] = data
    buf[:, n] = pad_byte
    buf[:, blocks * rate_bytes - 1] ^= 0x80
    return buf.view("<u4").astype(np.uint32).view(np.int32).reshape(batch, -1)
