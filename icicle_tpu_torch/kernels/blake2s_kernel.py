"""Batched BLAKE2s-256 over a hand-written CUDA kernel
(kernels/csrc/blake2s.cu).

`blake2s(x, nbytes)` hashes each row of x, the little-endian words of a
message of nbytes bytes, one thread a row, in one launch. No Pallas kernel
is replaced: the JAX package's compression is XLA
(icicle_tpu/ops/hash/blake2s.py:47 _compress).

The plain version `blake2s_ref` computes the hash in torch on int64
tensors holding the 32-bit words (CPU torch has no add, `>>` or `<` on
uint32): the state is one (16, batch) tensor whose four rows of four words
(a, b, c, d) go through the four column G's as one step and, rolled along
the word axis, the four diagonal G's as another (`mix`, which the BLAKE3
plain version shares). `COMPRESS_OPS` counts the integer instructions of
one compression and `COMPRESS_ADDS` the adds among them, which may issue on
the FMA pipe (IMAD.IADD) beside the ALU pipe's logic, rotations and other
adds: the kernel's bound.
"""

from __future__ import annotations

import ctypes

import torch

from icicle_tpu_torch.kernels import protocol_lib as L

LIBRARY = "blake2s"
MASK = 0xFFFFFFFF
IV = (0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
      0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19)
PARAM = 0x01010020  # h0 ^= depth 1, fanout 1, a 32-byte digest, no key
SIGMA = (
    (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15),
    (14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3),
    (11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4),
    (7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8),
    (9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13),
    (2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9),
    (12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11),
    (13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10),
    (6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5),
    (10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0),
)
G_OPS = 12  # integer instructions of one G (kernels/csrc/blake.cuh)
G_ADDS = 4  # its adds: two three-input, two two-input
# 10 rounds of 8 G's, 8 three-input XORs for the output, 2 XORs for the
# counter and the final flag
COMPRESS_OPS = 10 * 8 * G_OPS + 8 + 2
COMPRESS_ADDS = 10 * 8 * G_ADDS


def _rotr(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x >> r) | (x << (32 - r))) & MASK


def _g(a, b, c, d, mx, my):
    a = (a + b + mx) & MASK
    d = _rotr(d ^ a, 16)
    c = (c + d) & MASK
    b = _rotr(b ^ c, 12)
    a = (a + b + my) & MASK
    d = _rotr(d ^ a, 8)
    c = (c + d) & MASK
    b = _rotr(b ^ c, 7)
    return a, b, c, d


def mix(v: torch.Tensor, m: torch.Tensor, schedule) -> torch.Tensor:
    """The rounds of BLAKE2s / BLAKE3 on (16, ...) int64 states v over
    (16, ...) message words m, a round for each row of `schedule` (the
    message words' order in that round)."""
    a, b, c, d = v[0:4], v[4:8], v[8:12], v[12:16]
    for order in schedule:
        mr = m[list(order)]
        a, b, c, d = _g(a, b, c, d, mr[0:8:2], mr[1:8:2])
        b, c, d = b.roll(-1, 0), c.roll(-2, 0), d.roll(1, 0)   # the diagonals as columns
        a, b, c, d = _g(a, b, c, d, mr[8:16:2], mr[9:16:2])
        b, c, d = b.roll(1, 0), c.roll(2, 0), d.roll(-1, 0)
    return torch.cat([a, b, c, d])


def nof_blocks(nbytes: int) -> int:
    return max(1, -(-nbytes // 64))


def _check_words(x: torch.Tensor, nbytes: int, kernel: str) -> None:
    L.check_words(kernel, x, 2)
    if -(-nbytes // 4) != x.shape[1] or nbytes < 0:
        raise L.invalid(kernel, f"{x.shape[1]} words a row do not hold {nbytes} bytes")


def blake2s_ref(x: torch.Tensor, nbytes: int) -> torch.Tensor:
    """(batch, ceil(nbytes / 4)) int32 words of nbytes-byte messages ->
    (batch, 8) int32 digests, in plain torch on x's device."""
    batch, in_words = x.shape
    blocks = nof_blocks(nbytes)
    words = x.to(torch.int64) & MASK
    words = torch.cat([words, words.new_zeros((batch, blocks * 16 - in_words))], 1)
    m_all = words.view(batch, blocks, 16).permute(1, 2, 0)               # (blocks, 16, B)
    iv = torch.tensor(IV, dtype=torch.int64, device=x.device).view(8, 1)
    h = iv.expand(8, batch).clone()
    h[0] ^= PARAM
    for i in range(blocks):
        last = i == blocks - 1
        t = nbytes if last else min(nbytes, 64 * (i + 1))
        v = torch.cat([h, iv.expand(8, batch)])
        v[12] ^= t & MASK
        v[13] ^= t >> 32
        if last:
            v[14] ^= MASK
        v = mix(v, m_all[i], SIGMA)
        h = h ^ v[:8] ^ v[8:]
    return h.T.contiguous().to(torch.int32)


_ARGTYPES = ((ctypes.c_void_p,) * 2 + (ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
                                       ctypes.c_int, ctypes.c_void_p))


def vector_rows(x: torch.Tensor) -> bool:
    """Whether the kernels may read x's rows as 16-byte vectors: x starts
    16-byte aligned and its rows are whole multiples of 4 words."""
    return x.data_ptr() % 16 == 0 and x.shape[1] % 4 == 0


def blake2s(x: torch.Tensor, nbytes: int) -> torch.Tensor:
    """(batch, ceil(nbytes / 4)) int32 words of nbytes-byte messages ->
    (batch, 8) int32 BLAKE2s-256 digests.

    On a CUDA tensor this launches the kernel on the current stream (no
    synchronisation), counts the launch in `blake2s.launches` and raises if
    the launch is refused. On a CPU tensor it computes `blake2s_ref`."""
    _check_words(x, nbytes, "blake2s")
    if not x.is_cuda:
        return blake2s_ref(x, nbytes)
    batch, in_words = x.shape
    out = torch.empty((batch, 8), dtype=torch.int32, device=x.device)
    if batch == 0:
        return out
    fn, error_string = L.entry(LIBRARY, "icicle_blake2s", _ARGTYPES)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), out.data_ptr(), batch, in_words, nbytes, int(vector_rows(x)),
                 L.stream())
    L.raise_on("blake2s", err, error_string)
    blake2s.launches += 1
    return out


blake2s.launches = 0
