"""Sumcheck protocol, prover and verifier (counterpart of
icicle_tpu/ops/sumcheck.py; reference F11: include/icicle/sumcheck/* and
backend/cpu/include/cpu_sumcheck.h). Limits as sumcheck.h:11-14: combine
degree <= 6, <= 8 MLEs.

Each round is one call of kernel K3 (kernels/sumcheck_kernel.py
`sumcheck_round`: the fold by the previous round's challenge, then the
deg + 1 combine sums) on the MLEs' device; the host hashes the round
polynomial into the next challenge. Rounds go through the dispatcher's
api "sumcheck_round" with `SumcheckConfig.backend`: "cuda" is K3,
"torch" its plain version `sumcheck_round_ref` on any device.

Transcript bytes are the reference's (sumcheck_transcript.h):
  alpha_0 = H(domain_label || u32(nof_rounds) || u32(deg) || claimed_sum
              || seed || challenge_label || r_0 values || entry_0)
  alpha_i = H(entry_0 || alpha_{i-1} || challenge_label || round_label
              || u32(len) || u32(i) || r_i values)
where entry_0 = round_label || u32(len) || u32(0), without the round-0
values. Bytes to a field element: the little-endian integer mod p.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch

from icicle_tpu_torch.fields.field import Field
from icicle_tpu_torch.kernels import sumcheck_kernel
from icicle_tpu_torch.ops.program import ReturningValueProgram
from icicle_tpu_torch.runtime import dispatcher
from icicle_tpu_torch.runtime.config import SumcheckConfig
from icicle_tpu_torch.runtime.errors import IcicleError, IcicleException
from icicle_tpu_torch.utils import native as _native

MAX_COMBINE_POLY_DEG = 6   # sumcheck.h:12
MAX_NOF_POLYNOMIALS = 8    # sumcheck.h:14
ROUND_API = "sumcheck_round"

__all__ = ["MAX_COMBINE_POLY_DEG", "MAX_NOF_POLYNOMIALS", "SumcheckConfig",
           "SumcheckTranscriptConfig", "SumcheckProof", "SumcheckTranscript",
           "sumcheck_prove", "sumcheck_verify"]


@dataclasses.dataclass
class SumcheckTranscriptConfig:
    """Mirror of SumcheckTranscriptConfig: empty labels, keccak-256 on the
    host, little-endian (sumcheck_transcript_config.h:51)."""
    domain_separator_label: bytes = b""
    round_poly_label: bytes = b""
    round_challenge_label: bytes = b""
    seed: int = 0
    little_endian: bool = True
    hasher: Callable[[bytes], bytes] = _native.keccak_256


def _elem_bytes(f: Field) -> int:
    return max(f.nlimbs, 1) * 4


@dataclasses.dataclass
class SumcheckProof:
    """Round polynomials, each a list of deg + 1 field values (Python ints)."""
    round_polys: list[list[int]]

    def serialize(self, f: Field) -> bytes:
        """BinarySerializer<SumcheckProof> layout (serialization.h:40-112):
        u64 nof_round_polynomials, then per polynomial u64 len and the raw
        little-endian elements."""
        eb = _elem_bytes(f)
        out = bytearray(len(self.round_polys).to_bytes(8, "little"))
        for rp in self.round_polys:
            out += len(rp).to_bytes(8, "little")
            for v in rp:
                out += int(v).to_bytes(eb, "little")
        return bytes(out)

    @classmethod
    def deserialize(cls, f: Field, data: bytes) -> "SumcheckProof":
        eb = _elem_bytes(f)
        off = 8
        polys = []
        for _ in range(int.from_bytes(data[:8], "little")):
            ln = int.from_bytes(data[off:off + 8], "little")
            off += 8
            polys.append([int.from_bytes(data[off + i * eb:off + (i + 1) * eb], "little")
                          for i in range(ln)])
            off += ln * eb
        return cls(polys)


class SumcheckTranscript:
    """Byte-exact mirror of SumcheckTranscript (sumcheck_transcript.h)."""

    def __init__(self, f: Field, claimed_sum: int, nof_rounds: int, combine_degree: int,
                 cfg: SumcheckTranscriptConfig):
        self.f = f
        self.eb = _elem_bytes(f)
        self.claimed_sum = claimed_sum % f.modulus
        self.nof_rounds = nof_rounds
        self.combine_degree = combine_degree
        self.cfg = cfg
        self.round_idx = 0
        self.entry_0 = b""
        self.prev_alpha = 0

    def _field_bytes(self, v: int) -> bytes:
        return (v % self.f.modulus).to_bytes(self.eb, "little")

    def get_alpha(self, round_poly: Sequence[int]) -> int:
        cfg = self.cfg
        hi = bytearray()
        if self.round_idx == 0:
            hi += cfg.domain_separator_label
            hi += np.uint32(self.nof_rounds).tobytes()
            hi += np.uint32(self.combine_degree).tobytes()
            hi += self._field_bytes(self.claimed_sum)
            hi += self._field_bytes(cfg.seed)
            hi += cfg.round_challenge_label
            self.entry_0 = (cfg.round_poly_label + np.uint32(len(round_poly)).tobytes()
                            + np.uint32(self.round_idx).tobytes())
            for v in round_poly:
                hi += self._field_bytes(v)
            hi += self.entry_0
        else:
            hi += self.entry_0
            hi += self._field_bytes(self.prev_alpha)
            hi += cfg.round_challenge_label
            hi += cfg.round_poly_label
            hi += np.uint32(len(round_poly)).tobytes()
            hi += np.uint32(self.round_idx).tobytes()
            for v in round_poly:
                hi += self._field_bytes(v)
        digest = cfg.hasher(bytes(hi))
        self.round_idx += 1
        self.prev_alpha = int.from_bytes(digest, "little") % self.f.modulus
        return self.prev_alpha


def sumcheck_prove(f: Field, mle_polys: Sequence[torch.Tensor], claimed_sum: int,
                   combine: ReturningValueProgram,
                   transcript_cfg: SumcheckTranscriptConfig | None = None,
                   cfg: SumcheckConfig | None = None):
    """Prove that the sum over the boolean hypercube of combine(mles...) is
    claimed_sum. mle_polys: (n,)+lim canonical element tensors on one
    device, n a power of two. Returns (SumcheckProof, challenges)."""
    transcript_cfg = transcript_cfg or SumcheckTranscriptConfig()
    if cfg is not None and cfg.use_extension_field:
        # the reference rejects it (sumcheck.h:71-73, cpu_sumcheck.h:30-33)
        raise IcicleException(IcicleError.INVALID_ARGUMENT,
                              "SumcheckConfig::use_extension_field = true is currently "
                              "unsupported (matches reference)")
    n = mle_polys[0].shape[0]
    assert n & (n - 1) == 0 and n >= 2
    assert len(mle_polys) <= MAX_NOF_POLYNOMIALS
    deg = combine.poly_degree
    assert 0 < deg <= MAX_COMBINE_POLY_DEG
    nof_rounds = n.bit_length() - 1

    tr = SumcheckTranscript(f, claimed_sum, nof_rounds, deg, transcript_cfg)
    mles = torch.stack(list(mle_polys))
    round_fn = dispatcher.dispatch(ROUND_API, None if cfg is None else cfg.backend, mles)
    round_polys: list[list[int]] = []
    challenges: list[int] = [0]
    alpha = 0
    for r in range(nof_rounds):
        rp, mles = round_fn(f, combine, deg, mles, alpha, r > 0)
        rp_ints = [int(v) for v in np.atleast_1d(f.to_ints(rp))]
        round_polys.append(rp_ints)
        if r + 1 < nof_rounds:
            alpha = tr.get_alpha(rp_ints)
            challenges.append(alpha)
    return SumcheckProof(round_polys), challenges


def _lagrange_eval(p: int, ys: Sequence[int], x: int) -> int:
    """The degree-(len(ys) - 1) polynomial through (i, ys[i]) at x."""
    n = len(ys)
    total = 0
    for i in range(n):
        num, den = 1, 1
        for j in range(n):
            if i != j:
                num = num * ((x - j) % p) % p
                den = den * ((i - j) % p) % p
        total = (total + ys[i] * num * pow(den, -1, p)) % p
    return total


def sumcheck_verify(f: Field, proof: SumcheckProof, claimed_sum: int,
                    transcript_cfg: SumcheckTranscriptConfig | None = None) -> bool:
    """Mirror of the reference's Sumcheck::verify (sumcheck.h:123-162)."""
    transcript_cfg = transcript_cfg or SumcheckTranscriptConfig()
    p = f.modulus
    rps = proof.round_polys
    nof_rounds = len(rps)
    deg = len(rps[0]) - 1
    if (rps[0][0] + rps[0][1]) % p != claimed_sum % p:
        return False
    tr = SumcheckTranscript(f, claimed_sum, nof_rounds, deg, transcript_cfg)
    for r in range(nof_rounds - 1):
        alpha = tr.get_alpha(rps[r])
        if _lagrange_eval(p, rps[r], alpha) != (rps[r + 1][0] + rps[r + 1][1]) % p:
            return False
    return True


dispatcher.register_impl(ROUND_API, dispatcher.TORCH, sumcheck_kernel.sumcheck_round_ref)
dispatcher.register_impl(ROUND_API, dispatcher.CUDA, sumcheck_kernel.sumcheck_round)
