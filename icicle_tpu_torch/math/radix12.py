"""Signed radix-2^12 Montgomery arithmetic (counterpart of
icicle_tpu/math/radix12.py), the field engine of the MSM's "r12" scan
(kernels/msm_scan_r12.py, kernel B5).

An element is a list of nw word tensors (int32), little-endian, 12 bits a
word, signed: value = sum_k w_k 2^(12 k). Words need no carry between
operations: an add or sub is wordwise, and a multiply accumulates its
column sums raw. The Montgomery domain is R' = 2^(12 nw) (2^264 for bn254),
not the 2^(32 L) of math/bigint.py.

Bounds (the JAX package's contract): a "normalised" value has words in
[0, 2^12) except a small signed top word, value in (-2p, 2p); `mul_mont`
and `norm` give one. Lazy add/sub results have |w_k| <= 2^13; `mul_mont`
takes at most the pair of bounds `audit_mul` accepts, which simulates the
worst-case int32 columns exactly and raises OverflowError where one could
overflow. Its output is normalised, value in (-p, 2p).

Bit-exactness with the JAX engine, which computes in int32:
  - `from_u32` widens the int32 limb bit patterns to int64 (`& 0xFFFFFFFF`)
    before any `>>`, or a limb >= 2^31 would shift in sign bits;
  - `mul_mont` sums its columns in int64. No column can leave int32 (the
    audit), so the sums equal JAX's; m = (v * inv12) & MASK, whose product
    JAX lets wrap, keeps the same low 12 bits in int64;
  - `>>` on a negative word is the arithmetic shift (floor division), as
    in JAX; `&` with MASK then gives the non-negative remainder.
"""

from __future__ import annotations

import torch

from icicle_tpu_torch.math.bigint import I32, I64, MASK32, _antidiagonal_sums, narrow, widen

RADIX = 12
MASK = (1 << RADIX) - 1


def int_to_words(v: int, nw: int) -> list[int]:
    return [(v >> (RADIX * k)) & MASK for k in range(nw)]


class Radix12:
    """Field engine over lists of per-word int32 tensors (struct of words)."""

    def __init__(self, p: int):
        self.p = p
        self.nw = -(-(p.bit_length() + 2) // RADIX)  # headroom for 4p
        self.rbits = RADIX * self.nw
        self.R = 1 << self.rbits
        assert self.R > 4 * p, "need R' > 4p for the (-2p, 2p) window"
        self.inv12 = (-pow(p, -1, 1 << RADIX)) % (1 << RADIX)
        self.p12 = int_to_words(p, self.nw)
        # even normalised operands overflow int32 columns once
        # nw * 2^(2 RADIX + 1) reaches 2^31 (bw6_761)
        self.audit_mul(MASK, MASK)
        self.p2_12 = int_to_words(2 * p, self.nw)
        self.one_mont = int_to_words(self.R % p, self.nw)
        self._tables: dict = {}

    def _p12(self, device) -> torch.Tensor:
        t = self._tables.get(device)
        if t is None:
            t = self._tables[device] = torch.tensor(self.p12, dtype=I64, device=device)
        return t

    # -- conversions ----------------------------------------------------------
    def from_u32(self, limbs32):
        """List of L int32 tensors (uint32 limb bit patterns, little-endian)
        -> nw words in [0, 2^12). The value must be < 2^(12 nw)."""
        nl = len(limbs32)
        wide = [widen(x) for x in limbs32]
        out = []
        for k in range(self.nw):
            lo_bit = RADIX * k
            i, off = lo_bit // 32, lo_bit % 32
            if i >= nl:
                out.append(torch.zeros_like(limbs32[0]))
                continue
            w = wide[i] >> off
            if off > 32 - RADIX and i + 1 < nl:
                w = w | (wide[i + 1] << (32 - off))
            out.append((w & MASK).to(I32))
        return out

    def to_u32(self, words, nl: int):
        """Non-negative normalised words -> nl int32 limb bit patterns. A
        bit-field repacking (each bit belongs to one word); each word is read
        as uint32 and bits beyond limb nl - 1 drop, as in JAX."""
        limbs = []
        for i in range(nl):
            lo = 32 * i
            acc = torch.zeros_like(words[0], dtype=I64)
            for k in range(self.nw):
                wb = RADIX * k
                if wb + RADIX <= lo or wb >= lo + 32:
                    continue
                w = words[k].to(I64) & MASK32
                part = (w << (wb - lo)) if wb >= lo else (w >> (lo - wb))
                acc = acc | (part & MASK32)
            limbs.append(narrow(acc))
        return limbs

    # -- ring ops --------------------------------------------------------------
    def add(self, a, b):
        return [x + y for x, y in zip(a, b)]

    def sub(self, a, b):
        return [x - y for x, y in zip(a, b)]

    def norm(self, a):
        """Carry-normalise: words -> [0, 2^12), small signed top word."""
        out = []
        carry = torch.zeros_like(a[0])
        for k in range(self.nw - 1):
            v = a[k] + carry
            out.append(v & MASK)
            carry = v >> RADIX
        out.append(a[self.nw - 1] + carry)
        return out

    def canon_nonneg(self, a):
        """Normalised signed value in (-2p, 2p) -> non-negative words, value
        in [0, 4p): one masked add of 2p; words <= 2^13."""
        a = self.norm(a)
        negm = a[self.nw - 1] >> 31  # all ones where the value is negative
        return [x + (negm & t) for x, t in zip(a, self.p2_12)]

    def audit_mul(self, abound: int, bbound: int):
        """Worst-case exact-integer simulation of mul_mont's int32 columns for
        per-word absolute bounds (abound, bbound); raises OverflowError where
        a column could reach 2^31. Top-word bounds include the (-2p, 2p)
        window."""
        nw = self.nw
        top = max((2 * self.p) >> (RADIX * (nw - 1)), 1)
        amax = [abound] * (nw - 1) + [max(abound, 2 * top)]
        bmax = [bbound] * (nw - 1) + [max(bbound, 2 * top)]
        cols = [0] * (2 * nw - 1)
        for i in range(nw):
            for j in range(nw):
                cols[i + j] += amax[i] * bmax[j]
        carry = 0
        for i in range(nw):
            v = cols[i] + carry
            if v >= (1 << 31):
                raise OverflowError(
                    f"radix12 montmul col {i} can reach {v:.3e} >= 2^31 "
                    f"for bounds ({abound}, {bbound})")
            for j in range(1, nw):
                cols[i + j] += MASK * self.p12[j]
            carry = (v + MASK * self.p12[0]) >> RADIX
        for k in range(nw, 2 * nw - 1):
            v = cols[k] + carry
            if v >= (1 << 31):
                raise OverflowError(f"radix12 montmul tail col {k} can reach {v:.3e}")
            carry = v >> RADIX

    def mul_mont(self, a, b):
        """a * b * R'^-1 with the REDC fused into the product's columns
        (product scanning: step i resolves column i with m_i = -t_i / p mod
        2^12 and adds m_i p into the columns above). Operands within the
        audit's bounds; output normalised, value in (-p, 2p)."""
        nw = self.nw
        A, B = torch.broadcast_tensors(torch.stack(a, -1).to(I64), torch.stack(b, -1).to(I64))
        cols = _antidiagonal_sums(A.unsqueeze(-1) * B.unsqueeze(-2))  # (..., 2nw-1)
        p12 = self._p12(cols.device)
        carry = torch.zeros_like(cols[..., 0])
        for i in range(nw):
            v = cols[..., i] + carry
            m = (v * self.inv12) & MASK
            carry = (v + m * self.p12[0]) >> RADIX
            cols[..., i + 1:i + nw] += m.unsqueeze(-1) * p12[1:]
        out = []
        for k in range(nw, 2 * nw - 1):
            v = cols[..., k] + carry
            out.append((v & MASK).to(I32))
            carry = v >> RADIX
        out.append(carry.to(I32))
        return out

    def mul_small(self, x, k: int):
        """k x for a small Python int k, wordwise (|k w| < 2^31): words up to
        |k| 2^12, to be normalised before use as a multiply operand."""
        assert k != 0
        return [w * k for w in x]
