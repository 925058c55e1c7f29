"""The negacyclic NTT of R_q = Z_q[X]/(X^64 + 1) over a hand-written CUDA
kernel (kernels/csrc/rq_ntt.cu).

`rq_ntt(x, dir)` computes `rings/rq.py:negacyclic_ntt` for a batch of R_q
polynomials, (..., 64, 2) int32 Z_q limbs [lo, hi] (the uint32 bit
patterns of canonical values below q = P_bb P_kb < 2^62): forward, the
twist by psi^j (psi = omega(128)) and a natural-in, bit-reversed-out
transform (ordering NR); inverse, a bit-reversed-in, natural-out transform
(RN) and the fused n^-1 psi^-j untwist. No Pallas kernel is replaced: the
JAX package computes it as its generic NTT over the ring in XLA
(icicle_tpu/rings/rq.py:33 `negacyclic_ntt`).

The plain version `rq_ntt_ref` is that formulation in the port: `ntt` over
`get_zq()` with coset psi and ordering NR / RN, backend "torch". Every
operation of both is canonical modular arithmetic, so the two agree bit for
bit whatever the order of the butterflies.

`twiddle_table` holds what the kernel reads, as 64-bit Montgomery-form
words (R = 2^64): the forward twist psi^j (64), the forward stage twiddles
w^k (32, w = omega(64)), the inverse ones w^-k (32), the inverse untwist
n^-1 psi^-j (64).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from icicle_tpu_torch.kernels import protocol_lib as L
from icicle_tpu_torch.rings.babykoala import Q, RQ_DEGREE, get_zq
from icicle_tpu_torch.runtime.config import NTTConfig, NTTDir, Ordering

LIBRARY = "rq_ntt"
LOG_DEGREE = RQ_DEGREE.bit_length() - 1
R64 = 1 << 64
Q_INV = (-pow(Q, -1, R64)) % R64            # -q^-1 mod 2^64, the Montgomery constant
# 32-bit integer products of one 64-bit Montgomery multiply: a b (4), the low
# half of lo q' (3), the high half of m q (4)
MONT64_MULS = 11
# Montgomery multiplies of one polynomial, either direction: 64 for the twist
# and 32 a stage of the 6
POLY_MONTS = RQ_DEGREE + LOG_DEGREE * RQ_DEGREE // 2


def psi() -> int:
    """The twist: a primitive 128th root of unity of Z_q."""
    return get_zq().params.omega(LOG_DEGREE + 1)


def _mont(v: int) -> int:
    return v * R64 % Q


@functools.lru_cache(maxsize=None)
def twiddle_table(device) -> torch.Tensor:
    """(192,) int64 Montgomery-form words on `device`: twist[64],
    fwd[32], inv[32], untwist[64] (every word < q < 2^62)."""
    n = RQ_DEGREE
    p = psi()
    w = p * p % Q
    p_inv, w_inv, n_inv = pow(p, -1, Q), pow(w, -1, Q), pow(n, -1, Q)
    words = ([_mont(pow(p, j, Q)) for j in range(n)]
             + [_mont(pow(w, k, Q)) for k in range(n // 2)]
             + [_mont(pow(w_inv, k, Q)) for k in range(n // 2)]
             + [_mont(n_inv * pow(p_inv, j, Q) % Q) for j in range(n)])
    return torch.tensor(words, dtype=torch.int64, device=device)


def _check(x: torch.Tensor) -> None:
    L.check_words("rq_ntt", x, x.dim())
    if x.dim() < 2 or tuple(x.shape[-2:]) != (RQ_DEGREE, 2):
        raise L.invalid("rq_ntt", f"expected (..., {RQ_DEGREE}, 2) Z_q limbs, got "
                        f"{tuple(x.shape)}")


def rq_ntt_ref(x: torch.Tensor, dir: NTTDir = NTTDir.FORWARD) -> torch.Tensor:
    """`rq_ntt` in plain torch on x's device: the port's `ntt` over Z_q with
    coset psi, ordering NR forward and RN inverse (JAX rq.py:33)."""
    from icicle_tpu_torch.ops.ntt import ntt
    cfg = NTTConfig(coset_gen=psi(), backend="torch",
                    ordering=Ordering.NR if dir == NTTDir.FORWARD else Ordering.RN)
    return ntt(get_zq(), x, dir, cfg)


_ARGTYPES = (ctypes.c_void_p,) * 3 + (ctypes.c_longlong, ctypes.c_int, ctypes.c_ulonglong,
                                      ctypes.c_ulonglong, ctypes.c_void_p)


def rq_ntt(x: torch.Tensor, dir: NTTDir = NTTDir.FORWARD) -> torch.Tensor:
    """(..., 64, 2) int32 canonical Z_q limbs -> the negacyclic NTT (forward:
    evaluations in bit-reversed order; inverse: coefficients).

    On a CUDA tensor this launches the kernel on the current stream (no
    synchronisation), counts the launch in `rq_ntt.launches` and raises if
    the launch is refused. On a CPU tensor it computes `rq_ntt_ref`."""
    _check(x)
    if not x.is_cuda:
        return rq_ntt_ref(x, dir)
    out = torch.empty_like(x)
    rows = x.numel() // (2 * RQ_DEGREE)
    if rows == 0:
        return out
    fn, error_string = L.entry(LIBRARY, "icicle_rq_ntt", _ARGTYPES)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), out.data_ptr(), twiddle_table(x.device).data_ptr(), rows,
                 int(dir == NTTDir.INVERSE), Q, Q_INV, L.stream())
    L.raise_on("rq_ntt", err, error_string)
    rq_ntt.launches += 1
    return out


rq_ntt.launches = 0
