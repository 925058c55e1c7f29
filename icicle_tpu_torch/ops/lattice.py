"""Lattice ops over the babykoala ring Z_q (counterpart of
icicle_tpu/ops/lattice.py; reference F14-F19).

Reference sources, whose seeded outputs both packages reproduce byte for
byte:
  balanced decomposition  backend/cpu/src/ring/cpu_balanced_decomposition.cpp
  JL projection           backend/cpu/src/ring/cpu_jl_projection.cpp
  norm checks             backend/cpu/src/ring/cpu_norm.cpp
  random sampling         backend/cpu/src/ring/cpu_random_sampling.cpp
  operator norm           include/icicle/operator_norm.h (fixed-point FFT)

The Keccak-512 seed expansions run on the host through the host crypto
library (utils/native.py), as in the JAX package. The bulk math around them
(digits, projections, norms) is torch on the input's device, exact: an
element is an int64 below q < 2^62, and where a product or a sum could
pass 2^63 it is split into pieces whose sums fit, recombined with Python
ints on the host (a handful of values a call), or taken through the Z_q
engine. Functions that make tensors from a seed alone take `device=`.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from icicle_tpu_torch.rings.babykoala import Q, RQ_DEGREE, get_zq
from icicle_tpu_torch.runtime.device import resolve
from icicle_tpu_torch.utils import native

_SQRT_Q = math.isqrt(Q)
_PIECE_BITS = 21          # a JL sum of up to 2^42 pieces of 21 bits stays below 2^63


def _to_i64(x: torch.Tensor) -> torch.Tensor:
    """(..., 2) int32 Z_q limbs -> int64 values (q < 2^62: non-negative)."""
    w = x.to(torch.int64)
    return (w[..., 0] & 0xFFFFFFFF) | (w[..., 1] << 32)


def _from_i64(v: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, q) -> (..., 2) int32 limbs."""
    return torch.stack([(v & 0xFFFFFFFF).to(torch.int32), (v >> 32).to(torch.int32)], dim=-1)


def _from_u64_np(v: np.ndarray, device) -> torch.Tensor:
    return _from_i64(torch.from_numpy(v.astype(np.int64)).to(device))


# -- balanced decomposition (F14) ---------------------------------------------------

def compute_nof_digits(base: int) -> int:
    """Mirror of balanced_decomposition::compute_nof_digits (:34-47)."""
    digits = math.ceil(math.log2(Q) / math.log2(base))
    return digits + 1 if base > 2 else digits


def decompose_balanced(x: torch.Tensor, base: int, nof_digits: int | None = None) -> torch.Tensor:
    """(n, 2) Z_q -> (nof_digits * n, 2), digit-major (digit d of element i
    at [d * n + i]), as cpu_decompose_balanced_digits. int64 on x's device:
    `%` and `//` on torch tensors floor as Python's do."""
    if base < 2:
        raise ValueError(f"decompose_balanced: base must be at least 2, got {base}")
    nof_digits = nof_digits or compute_nof_digits(base)
    rem = _to_i64(x)
    if base > 2:
        rem = torch.where(rem > Q // 2, rem - Q, rem)
    out = []
    for _ in range(nof_digits):
        digit = rem % base
        rem = rem // base
        carry = digit > base // 2
        out.append(torch.where(carry, digit - base, digit))
        rem = rem + carry.to(torch.int64)
    res = torch.stack(out)
    return _from_i64(torch.where(res < 0, res + Q, res).reshape(-1))


def recompose_balanced(digits: torch.Tensor, base: int, out_size: int) -> torch.Tensor:
    """Inverse of decompose_balanced (cpu_recompose_from_balanced_digits):
    acc = acc * base + digit mod q from the top digit, in the Z_q engine."""
    e = get_zq().engine
    blocks = digits.reshape(-1, out_size, 2)
    acc = torch.zeros_like(blocks[0])
    base_c = e.const(base % Q, like=acc)
    for d in range(blocks.shape[0] - 1, -1, -1):
        acc = e.add(e.mul(acc, base_c), blocks[d])
    return acc


# -- JL projection (F15) ------------------------------------------------------------

_ENTRIES_PER_HASH = 64 * 4  # Keccak-512 output bits / 2


def _jl_entries(seed: bytes, start_row: int, num_rows: int, row_size: int) -> np.ndarray:
    """(num_rows, row_size) uint8 2-bit entries of the implicit JL rows
    (0 -> 0, 1 -> +1, 2 -> -1, 3 -> 0): row r's hash h is Keccak-512 of
    seed || u32 (r * hashes_per_row + h), its bytes read two bits at a time
    from the low ones (cpu_jl_projection.cpp)."""
    hashes = -(-row_size // _ENTRIES_PER_HASH)
    first = start_row * hashes
    raw = b"".join(native.keccak_512(seed + (c & 0xFFFFFFFF).to_bytes(4, "little"))
                   for c in range(first, first + num_rows * hashes))
    db = np.frombuffer(raw, dtype=np.uint8).reshape(num_rows, hashes * 64)
    two_bits = np.stack([(db >> s) & 3 for s in (0, 2, 4, 6)], axis=-1)
    return two_bits.reshape(num_rows, -1)[:, :row_size]


def _signed_sums(signs: torch.Tensor, v: torch.Tensor) -> list[int]:
    """sum_i signs[r, i] v[i] mod q for each row r of int8 signs in {-1, 0,
    1} and int64 v in [0, q): each row's sum of each 21-bit piece of v in
    int64 on the device, combined with Python ints."""
    pieces = [(v >> (_PIECE_BITS * k)) & ((1 << _PIECE_BITS) - 1)
              for k in range(-(-62 // _PIECE_BITS))]
    sums = torch.stack([(signs.to(torch.int64) * p).sum(-1) for p in pieces]).cpu().tolist()
    return [sum(int(s[r]) << (_PIECE_BITS * k) for k, s in enumerate(sums)) % Q
            for r in range(signs.shape[0])]


def jl_projection(x: torch.Tensor, seed: bytes, output_size: int) -> torch.Tensor:
    """Project an (n, 2) Z_q vector to (output_size, 2) through the seeded
    {0, +-1} matrix (cpu_jl_projection.cpp:22-107)."""
    v = _to_i64(x)
    e = torch.from_numpy(_jl_entries(seed, 0, output_size, v.shape[0])).to(x.device)
    signs = (e == 1).to(torch.int8) - (e == 2).to(torch.int8)
    rows = []
    chunk = max(1, (1 << 27) // max(1, v.shape[0]))   # int64 products of a block of rows
    for r in range(0, output_size, chunk):
        rows += _signed_sums(signs[r:r + chunk], v)
    return _from_i64(torch.tensor(rows, dtype=torch.int64, device=x.device))


def get_jl_matrix_rows(seed: bytes, row_size: int, start_row: int, num_rows: int,
                       negacyclic_conjugate: bool = False,
                       polyring_size: int = RQ_DEGREE, device=None) -> torch.Tensor:
    """Explicit JL rows as (num_rows, row_size, 2) Z_q elements
    (cpu_get_jl_matrix_rows:110-210); with `negacyclic_conjugate`, each
    polyring_size block's entries conjugated: the entry of column c moves to
    -c mod d, its sign flipped for c != 0."""
    e = _jl_entries(seed, start_row, num_rows, row_size)
    if negacyclic_conjugate:
        d = polyring_size
        col = np.arange(row_size)
        which, coeff = col // d, col % d
        conj_idx = which * d + np.where(coeff == 0, 0, d - coeff)
        flipped = np.where(coeff == 0, e, (e ^ 3) & 3)
        e = np.zeros_like(e)
        e[:, conj_idx] = flipped
    vals = np.where(e == 1, np.uint64(1), np.where(e == 2, np.uint64(Q - 1), np.uint64(0)))
    return _from_u64_np(vals, resolve(device))


# -- norms (F16) ---------------------------------------------------------------------

class NormType:
    L2 = "L2"
    LInfinity = "LInfinity"


def _abs_centered(v: torch.Tensor) -> torch.Tensor:
    return torch.where(v > Q // 2, Q - v, v)


def _sum_squares(v: torch.Tensor) -> int:
    """sum v^2, exact, for v below sqrt(q) < 2^31: 16-bit halves' products
    summed in int64 on the device, combined with Python ints."""
    hi, lo = v >> 16, v & 0xFFFF
    parts = torch.stack([(hi * hi).sum(), (hi * lo).sum(), (lo * lo).sum()]).cpu().tolist()
    return (int(parts[0]) << 32) + (int(parts[1]) << 17) + int(parts[2])


def _centered(x: torch.Tensor) -> torch.Tensor:
    v = _abs_centered(_to_i64(x))
    if bool((v >= _SQRT_Q).any()):
        raise ValueError("input value >= sqrt(q)")
    return v


def check_norm_bound(x: torch.Tensor, norm: str, bound: int) -> bool:
    """cpu_check_norm_bound: inputs must be < sqrt(q) in centered form; L2
    compares the (exact) sum of squares against bound^2."""
    v = _centered(x)
    if norm == NormType.L2:
        return _sum_squares(v) < bound * bound
    if norm == NormType.LInfinity:
        return int(v.max()) < bound
    raise ValueError(norm)


def check_norm_relative(a: torch.Tensor, b: torch.Tensor, norm: str, scale: int) -> bool:
    """cpu_norm.cpp check_norm_relative: norm(a) < scale * norm(b)."""
    va, vb = _centered(a), _centered(b)
    if norm == NormType.L2:
        return _sum_squares(va) < scale * scale * _sum_squares(vb)
    if norm == NormType.LInfinity:
        return int(va.max()) < scale * int(vb.max())
    raise ValueError(norm)


# -- random sampling (F17) -----------------------------------------------------------

RANDOM_SAMPLING_FAST_MODE_NUMBER_OF_TASKS = 256  # vec_ops_backend.h:507


def _reduce_from_bytes8(b: bytes) -> int:
    """ModArith::reduce_from_bytes (:499-506): repeated subtract while q < v.
    The reference loop leaves v == q unreduced; mirrored exactly."""
    v = int.from_bytes(b[:8], "little")
    while Q < v:
        v -= Q
    return v


def random_sampling(size: int, fast_mode: bool, seed: bytes, batch_size: int = 1,
                    device=None) -> torch.Tensor:
    """Seeded uniform Z_q sampling, byte-identical to cpu_random_sampling
    (host Python, as the reference's loops are serial)."""
    out = np.zeros((batch_size, size), dtype=np.uint64)
    if fast_mode:
        spt = -(-size // RANDOM_SAMPLING_FAST_MODE_NUMBER_OF_TASKS)
        total_tasks = -(-size // spt)
        for b in range(batch_size):
            for t in range(min(total_tasks, RANDOM_SAMPLING_FAST_MODE_NUMBER_OF_TASKS)):
                digest = native.keccak_512(seed + b.to_bytes(4, "little") + t.to_bytes(8, "little"))
                prev = _reduce_from_bytes8(digest)
                out[b, t * spt] = prev
                for idx in range(t * spt + 1, min((t + 1) * spt, size)):
                    prev = prev * prev % Q
                    out[b, idx] = prev
    else:
        elements_per_hash = 64 // 8  # Keccak-512 bytes / element bytes
        hashes_per_batch = max(-(-size // elements_per_hash), 1)
        for b in range(batch_size):
            for counter in range(hashes_per_batch):
                digest = native.keccak_512(
                    seed + b.to_bytes(4, "little") + counter.to_bytes(8, "little"))
                for i in range(elements_per_hash):
                    idx = counter * elements_per_hash + i
                    if idx >= size:
                        break
                    out[b, idx] = _reduce_from_bytes8(digest[i * 8:(i + 1) * 8])
    res = _from_u64_np(out, resolve(device))
    return res[0] if batch_size == 1 else res


# -- operator norm (F19) and challenge space sampling (F17b) ---------------------------

_FP_SCALE = 1000000


def _fp_reduce(num: int, denom: int) -> int:
    if num >= 0:
        return (num + denom // 2) // denom
    return -((-num + denom // 2) // denom)


def _fp_mul(a: int, b: int) -> int:
    return _fp_reduce(a * b, _FP_SCALE)


def _cmul(a, b):
    return (_fp_mul(a[0], b[0]) - _fp_mul(a[1], b[1]),
            _fp_mul(a[0], b[1]) + _fp_mul(a[1], b[0]))


_WLEN = [(-1000000, 0), (0, 1000000), (707106, 707106),
         (923879, 382683), (980785, 195090), (995184, 98017)]
_TWIST = [(int(math.cos(math.pi * i / 64) * _FP_SCALE), int(math.sin(math.pi * i / 64) * _FP_SCALE))
          for i in range(64)]


def operator_norm(poly_int64: list[int]) -> int:
    """Fixed-point FFT operator norm (operator_norm.h:160-178), bit-exact
    integer arithmetic mirroring the int32 FixedPoint ops."""
    a = [_cmul((int(c) * _FP_SCALE, 0), _TWIST[i]) for i, c in enumerate(poly_int64)]
    n = 64
    j = 0
    for i in range(1, n):  # bit-reverse permute
        bit = n >> 1
        while j & bit:
            j ^= bit
            bit >>= 1
        j ^= bit
        if i < j:
            a[i], a[j] = a[j], a[i]
    llen, stage = 2, 0
    while llen <= n:
        wlen = _WLEN[stage]
        for i in range(0, n, llen):
            w = (_FP_SCALE, 0)
            for jj in range(llen // 2):
                u = a[i + jj]
                v = _cmul(a[i + jj + llen // 2], w)
                a[i + jj] = (u[0] + v[0], u[1] + v[1])
                a[i + jj + llen // 2] = (u[0] - v[0], u[1] - v[1])
                w = _cmul(w, wlen)
        llen <<= 1
        stage += 1
    max_norm = 0.0
    for re, im in a:
        fre, fim = np.float32(re / _FP_SCALE), np.float32(im / _FP_SCALE)
        max_norm = max(max_norm, math.sqrt(float(np.float32(fre * fre + fim * fim))))
    return math.ceil(max_norm + 0.000001)


class _BitIter:
    """Mirror of RandomBitIterator (cpu_random_sampling.cpp:137-177)."""

    def __init__(self, digest: bytes):
        self.words = [int.from_bytes(digest[i * 8:(i + 1) * 8], "little") for i in range(8)]
        self.limb = 0
        self.bit = 0
        self.lfsr = self.words[7]

    def next_bit(self) -> int:
        if self.limb < 8:
            b = (self.words[self.limb] >> self.bit) & 1
        else:
            b = (self.lfsr >> self.bit) & 1
        self.bit += 1
        if self.bit == 64:
            self.bit = 0
            self.limb += 1
            if self.limb >= 8:
                lsb = self.lfsr & 1
                self.lfsr >>= 1
                if lsb:
                    self.lfsr ^= 0xD800000000000000
        return b


def _merge_shuffle(arr: list[int], size_a: int, size_b: int, index_bits: int, it: _BitIter):
    """arxiv 1508.03167 merge shuffle (cpu_random_sampling.cpp:181-210)."""
    i, j, n = 0, size_a, size_a + size_b
    while True:
        if not it.next_bit():
            if j == n:
                break
            arr[i], arr[j] = arr[j], arr[i]
            j += 1
        elif i == j:
            break
        i += 1
    while i < n:
        while True:
            m = 0
            for b in range(index_bits):
                m |= it.next_bit()
                if b < index_bits - 1:
                    m <<= 1
            if m <= i:
                break
        arr[i], arr[m] = arr[m], arr[i]
        i += 1


def challenge_space_polynomials(seed: bytes, size: int, ones: int, twos: int,
                                norm_bound: int = 0, device=None) -> torch.Tensor:
    """`size` R_q challenge polynomials with `ones` +-1 and `twos` +-2
    coefficients, with optional operator-norm rejection
    (cpu_random_sampling.cpp:212-304): a (size, 64, 2) tensor."""
    if ones < 0 or twos < 0 or ones + twos > RQ_DEGREE:
        raise ValueError(f"challenge_space_polynomials: {ones} ones and {twos} twos in a "
                         f"polynomial of {RQ_DEGREE} coefficients")
    out = np.zeros((size, RQ_DEGREE), dtype=np.uint64)
    for poly_idx in range(size):
        retry = 0
        while True:
            digest = native.keccak_512(
                seed + poly_idx.to_bytes(8, "little") + (retry & 0xFFFFFFFF).to_bytes(4, "little"))
            it = _BitIter(digest)
            vals = [0] * RQ_DEGREE
            for m in range(ones):
                vals[m] = 1 if it.next_bit() else Q - 1
            for m in range(ones, ones + twos):
                vals[m] = 2 if it.next_bit() else Q - 2
            _merge_shuffle(vals, ones, twos,
                           math.ceil(math.log2(ones + twos)) if ones + twos > 0 else 0, it)
            _merge_shuffle(vals, ones + twos, RQ_DEGREE - ones - twos,
                           math.ceil(math.log2(RQ_DEGREE)), it)
            if not norm_bound:
                break
            balanced = [v if v <= 2 else v - Q for v in vals]
            retry += 1
            if operator_norm(balanced) <= norm_bound:
                break
        out[poly_idx] = np.array(vals, dtype=np.uint64)
    return _from_u64_np(out, resolve(device))
