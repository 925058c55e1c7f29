"""R_q = Z_q[X]/(X^64 + 1): the negacyclic NTT and polynomial ring arithmetic
(counterpart of icicle_tpu/rings/rq.py; reference F18:
include/icicle/negacyclic_ntt.h, src/ntt.cpp:187-211).

A negacyclic NTT over R_q is a coset NTT in Z_q with coset generator
psi = omega(2d), ordering NR forward and RN inverse, batched over
polynomials. Backend "torch" computes it so, through the port's generic
`ntt` over `get_zq()` (the JAX formulation); "cuda" launches the
hand-written kernel (kernels/rq_ntt_kernel.py, kernels/csrc/rq_ntt.cu);
"auto" (None) the kernel for a CUDA tensor.

Layout: an R_q batch is (..., 64, 2) int32 (coefficient axis, then the
Z_q limb axis).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from icicle_tpu_torch.kernels.rq_ntt_kernel import rq_ntt, rq_ntt_ref
from icicle_tpu_torch.rings.babykoala import RQ_DEGREE, get_zq
from icicle_tpu_torch.runtime import dispatcher
from icicle_tpu_torch.runtime.config import NTTDir

__all__ = ["NegacyclicNTTConfig", "negacyclic_ntt", "rq_add", "rq_sub", "rq_mul", "rq_mul_eval",
           "rq_from_ints", "rq_to_ints", "RQ_DEGREE"]


@dataclasses.dataclass
class NegacyclicNTTConfig:
    """Mirror of reference NegacyclicNTTConfig (negacyclic_ntt.h:15-21), with
    the port's backend selector."""
    is_async: bool = False
    backend: Optional[str] = None


dispatcher.register_impl("negacyclic_ntt", dispatcher.TORCH, rq_ntt_ref)
dispatcher.register_impl("negacyclic_ntt", dispatcher.CUDA, rq_ntt)


def negacyclic_ntt(x: torch.Tensor, dir: NTTDir = NTTDir.FORWARD,
                   cfg: NegacyclicNTTConfig | None = None) -> torch.Tensor:
    """(batch..., 64, 2) R_q batch -> the same shape, evaluation domain
    (forward, bit-reversed order) or coefficient domain (inverse), on x's
    device."""
    cfg = cfg or NegacyclicNTTConfig()
    return dispatcher.dispatch("negacyclic_ntt", cfg.backend, x)(x, dir)


# -- R_q arithmetic ------------------------------------------------------------------

def rq_add(a, b):
    return get_zq().add(a, b)


def rq_sub(a, b):
    return get_zq().sub(a, b)


def rq_mul(a, b, cfg: NegacyclicNTTConfig | None = None):
    """Negacyclic polynomial product through the evaluation domain (a, b in
    the coefficient domain)."""
    ea = negacyclic_ntt(a, NTTDir.FORWARD, cfg)
    eb = negacyclic_ntt(b, NTTDir.FORWARD, cfg)
    return negacyclic_ntt(get_zq().mul(ea, eb), NTTDir.INVERSE, cfg)


def rq_mul_eval(a_eval, b_eval):
    """Pointwise product of inputs already in the evaluation domain."""
    return get_zq().mul(a_eval, b_eval)


# -- host conversion helpers -------------------------------------------------------

def rq_from_ints(coeffs, device=None) -> torch.Tensor:
    """Nested ints with a trailing axis of 64 -> (..., 64, 2) tensor."""
    return get_zq().from_ints(coeffs, device)


def rq_to_ints(x: torch.Tensor) -> np.ndarray:
    return get_zq().to_ints(x)
