"""Batched BLAKE3 (default mode, 32-byte digests) over a hand-written CUDA
kernel (kernels/csrc/blake3.cu).

`blake3(x, nbytes)` hashes each row of x, the little-endian words of a
message of nbytes bytes. A message of at most one chunk (1024 bytes) is one
launch, one thread a row; a longer one is a chunk pass (one thread a (row,
chunk)) and one launch a level of parent merges, as the JAX package merges
them (icicle_tpu/ops/hash/blake3.py:194-210: adjacent chaining values
paired left to right, an odd last one carried up). No Pallas kernel is
replaced: the JAX package's compression is XLA (blake3.py:64
_compress_dyn).

The plain version `blake3_ref` computes the hash in torch on int64 tensors
holding the 32-bit words, vectorised over the rows and the chunks as the
JAX package's `_run` is, over the BLAKE2s plain version's `mix`.
`COMPRESS_OPS` and `COMPRESS_ADDS` count one compression's integer
instructions and its adds (as the BLAKE2s ones), the kernel's bound.
"""

from __future__ import annotations

import ctypes

import torch

from icicle_tpu_torch.kernels import protocol_lib as L
from icicle_tpu_torch.kernels.blake2s_kernel import (G_ADDS, G_OPS, IV, MASK, _check_words,
                                                     mix, vector_rows)

LIBRARY = "blake3"
MSG_PERM = (2, 6, 3, 10, 7, 0, 4, 13, 1, 11, 12, 5, 9, 14, 15, 8)
CHUNK_START, CHUNK_END, PARENT, ROOT = 1, 2, 4, 8
BLOCK_BYTES = 64
CHUNK_BYTES = 1024
# 7 rounds of 8 G's and 8 XORs for the output
COMPRESS_OPS = 7 * 8 * G_OPS + 8
COMPRESS_ADDS = 7 * 8 * G_ADDS


def _schedule() -> tuple:
    """Round r reads message word SCHEDULE[r][j] in position j (the
    permutation applied r times)."""
    rows, perm = [], list(range(16))
    for _ in range(7):
        rows.append(tuple(perm))
        perm = [perm[p] for p in MSG_PERM]
    return tuple(rows)


SCHEDULE = _schedule()


def nof_chunks(nbytes: int) -> int:
    return max(1, -(-nbytes // CHUNK_BYTES))


def compressions(nbytes: int) -> int:
    """Compressions of one message: a block a chunk (at least one) and a
    parent merge for each chunk past the first."""
    return max(1, -(-nbytes // BLOCK_BYTES)) + nof_chunks(nbytes) - 1


def parent_levels(nbytes: int) -> int:
    """Parent-merge launches of a message: ceil(log2(chunks))."""
    return (nof_chunks(nbytes) - 1).bit_length()


def _compress(cv: torch.Tensor, m: torch.Tensor, counter, block_len, flags) -> torch.Tensor:
    """(8, ...) chaining values, (16, ...) message words and broadcastable
    counter / block length / flags -> (8, ...) chaining values."""
    iv = torch.tensor(IV[:4], dtype=torch.int64, device=cv.device)
    iv = iv.view((4,) + (1,) * (cv.dim() - 1)).expand((4,) + cv.shape[1:])
    tail = torch.broadcast_tensors(counter, torch.zeros_like(cv[0]), block_len, flags)
    v = mix(torch.cat([cv, iv, torch.stack(tail)]), m, SCHEDULE)
    return v[:8] ^ v[8:]


def blake3_ref(x: torch.Tensor, nbytes: int) -> torch.Tensor:
    """(batch, ceil(nbytes / 4)) int32 words of nbytes-byte messages ->
    (batch, 8) int32 digests, in plain torch on x's device."""
    batch, in_words = x.shape
    dev = x.device
    n_chunks = nof_chunks(nbytes)
    bpc = CHUNK_BYTES // BLOCK_BYTES
    words = x.to(torch.int64) & MASK
    words = torch.cat([words, words.new_zeros((batch, n_chunks * bpc * 16 - in_words))], 1)
    blocks = words.view(batch, n_chunks, bpc, 16).permute(2, 3, 0, 1)  # (bpc, 16, B, chunks)
    # each (chunk, block)'s length, flags and whether it exists
    meta = torch.zeros((3, bpc, n_chunks), dtype=torch.int64)
    max_blocks = 0
    for ci in range(n_chunks):
        cbytes = min(CHUNK_BYTES, nbytes - ci * CHUNK_BYTES)
        nb = max(1, -(-cbytes // BLOCK_BYTES))
        max_blocks = max(max_blocks, nb)
        for b in range(nb):
            flags = (CHUNK_START if b == 0 else 0) | (
                CHUNK_END | (ROOT if n_chunks == 1 else 0) if b == nb - 1 else 0)
            meta[:, b, ci] = torch.tensor([min(BLOCK_BYTES, max(cbytes - b * BLOCK_BYTES, 0)),
                                           flags, 1])
    meta = meta.to(dev)
    counters = torch.arange(n_chunks, dtype=torch.int64, device=dev)
    cv = torch.tensor(IV, dtype=torch.int64, device=dev).view(8, 1, 1).expand(
        8, batch, n_chunks)
    for b in range(max_blocks):
        new = _compress(cv, blocks[b], counters, meta[0, b], meta[1, b])
        cv = torch.where(meta[2, b].bool(), new, cv)
    num = n_chunks
    while num > 1:   # parent merges, a level at a time
        half = num // 2
        m = torch.cat([cv[:, :, 0:2 * half:2], cv[:, :, 1:2 * half:2]])
        flags = PARENT | (ROOT if num == 2 else 0)
        iv = torch.tensor(IV, dtype=torch.int64, device=dev).view(8, 1, 1).expand(8, batch, half)
        merged = _compress(iv, m, torch.zeros((), dtype=torch.int64, device=dev),
                           torch.full((), BLOCK_BYTES, dtype=torch.int64, device=dev),
                           torch.full((), flags, dtype=torch.int64, device=dev))
        cv = torch.cat([merged, cv[:, :, num - 1:]], 2) if num % 2 else merged
        num = half + num % 2
    return cv[:, :, 0].T.contiguous().to(torch.int32)


_CHUNK_ARGS = ((ctypes.c_void_p,) * 2 + (ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
                                         ctypes.c_int, ctypes.c_void_p))
_PARENT_ARGS = (ctypes.c_void_p,) * 2 + (ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p)


def blake3(x: torch.Tensor, nbytes: int) -> torch.Tensor:
    """(batch, ceil(nbytes / 4)) int32 words of nbytes-byte messages ->
    (batch, 8) int32 BLAKE3 digests.

    On a CUDA tensor this launches the chunk kernel and, past one chunk,
    the parent kernel once a level, on the current stream (no
    synchronisation); it counts every launch in `blake3.launches` and
    raises if one is refused. On a CPU tensor it computes `blake3_ref`."""
    _check_words(x, nbytes, "blake3")
    if not x.is_cuda:
        return blake3_ref(x, nbytes)
    batch, in_words = x.shape
    chunks = nof_chunks(nbytes)
    out = torch.empty((batch, chunks, 8), dtype=torch.int32, device=x.device)
    if batch == 0:
        return out[:, 0]
    fn, error_string = L.entry(LIBRARY, "icicle_blake3_chunks", _CHUNK_ARGS)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), out.data_ptr(), batch, in_words, nbytes, int(vector_rows(x)),
                 L.stream())
        L.raise_on("blake3", err, error_string)
        blake3.launches += 1
        num = chunks
        while num > 1:
            nxt = torch.empty((batch, (num + 1) // 2, 8), dtype=torch.int32, device=x.device)
            fn, error_string = L.entry(LIBRARY, "icicle_blake3_parents", _PARENT_ARGS)
            err = fn(out.data_ptr(), nxt.data_ptr(), batch, num, L.stream())
            L.raise_on("blake3", err, error_string)
            blake3.launches += 1
            out, num = nxt, (num + 1) // 2
    return out[:, 0]


blake3.launches = 0
