"""The Z_3329 ring operations of ML-KEM over a hand-written CUDA kernel
(kernels/csrc/mlkem.cu).

`mlkem_ntt`, `mlkem_intt` and `mlkem_multiply_ntts` compute FIPS 203's
NTT (Alg 9: seven layers, the 128 zetas 17^bitrev7(i) in bit-reversed
order), its inverse (Alg 10, with the scale 3303 = 128^-1 mod q) and the
base-case products of two NTT-domain polynomials (Algs 11-12: degree-2
products with the gammas 17^(2 bitrev7(i) + 1)), batched over the leading
axes of (..., 256) int32 tensors of canonical coefficients in [0, 3329).
No Pallas kernel is replaced: the JAX package computes them in XLA
(icicle_tpu/ops/pqc/ml_kem_tpu.py:141 `ntt`, :153 `intt`, :165
`multiply_ntts`).

The plain versions (`ntt_ref`, `intt_ref`, `multiply_ntts_ref`) are those
JAX functions in torch, stage-vectorised with the same per-layer zeta
vectors. Every output is canonical, so kernel and plain version agree bit
for bit.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from icicle_tpu_torch.kernels import protocol_lib as L

LIBRARY = "mlkem"
Q = 3329
ZETA = 17
N = 256
INV128 = 3303  # 128^-1 mod q
OPS = {"ntt": 0, "intt": 1, "multiply_ntts": 2}


def bitrev7(i: int) -> int:
    return int(f"{i:07b}"[::-1], 2)


ZETAS = [pow(ZETA, bitrev7(i), Q) for i in range(128)]
GAMMAS = [pow(ZETA, 2 * bitrev7(i) + 1, Q) for i in range(128)]


def _stage_zetas():
    """Per-layer zeta vectors of the stage-vectorised NTT / inverse (the
    FIPS 203 Alg 9 / 10 index walk, as JAX `_stage_zetas`)."""
    fwd, i, length = [], 1, 128
    while length >= 2:
        nb = N // (2 * length)
        fwd.append((length, ZETAS[i:i + nb]))
        i += nb
        length //= 2
    inv, i, length = [], 127, 2
    while length <= 128:
        nb = N // (2 * length)
        inv.append((length, [ZETAS[i - b] for b in range(nb)]))
        i -= nb
        length *= 2
    return fwd, inv


FWD_STAGES, INV_STAGES = _stage_zetas()


@functools.lru_cache(maxsize=None)
def _vec(values: tuple, device) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.int32, device=device)


def ntt_ref(f: torch.Tensor) -> torch.Tensor:
    """(..., 256) int32 -> NTT (FIPS 203 Alg 9), a layer a step."""
    for length, zs in FWD_STAGES:
        nb = N // (2 * length)
        g = f.reshape(f.shape[:-1] + (nb, 2, length))
        lo, hi = g[..., 0, :], g[..., 1, :]
        t = _vec(tuple(zs), f.device)[:, None] * hi % Q
        f = torch.stack([(lo + t) % Q, (lo - t) % Q], dim=-2).reshape(f.shape)
    return f


def intt_ref(f: torch.Tensor) -> torch.Tensor:
    """Inverse NTT (FIPS 203 Alg 10), a layer a step, then the 128^-1 scale."""
    for length, zs in INV_STAGES:
        nb = N // (2 * length)
        g = f.reshape(f.shape[:-1] + (nb, 2, length))
        lo, hi = g[..., 0, :], g[..., 1, :]
        f = torch.stack([(lo + hi) % Q, _vec(tuple(zs), f.device)[:, None] * (hi - lo) % Q],
                        dim=-2).reshape(f.shape)
    return f * INV128 % Q


def multiply_ntts_ref(f: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Base-case pairwise products (FIPS 203 Algs 11-12)."""
    f0, f1 = f[..., 0::2], f[..., 1::2]
    g0, g1 = g[..., 0::2], g[..., 1::2]
    h0 = (f0 * g0 + f1 * g1 % Q * _vec(tuple(GAMMAS), f.device)) % Q
    h1 = (f0 * g1 + f1 * g0) % Q
    return torch.stack([h0, h1], dim=-1).reshape(torch.broadcast_shapes(f.shape, g.shape))


def _check(name: str, *ts: torch.Tensor) -> None:
    for t in ts:
        L.check_words(name, t, t.dim())
        if t.dim() < 1 or t.shape[-1] != N:
            raise L.invalid(name, f"expected (..., {N}) int32 coefficients, got {tuple(t.shape)}")
    if len(ts) == 2 and (ts[0].shape != ts[1].shape or ts[0].device != ts[1].device):
        raise L.invalid(name, f"operands {tuple(ts[0].shape)} on {ts[0].device} and "
                        f"{tuple(ts[1].shape)} on {ts[1].device}")


_ARGTYPES = (ctypes.c_int,) + (ctypes.c_void_p,) * 3 + (ctypes.c_longlong, ctypes.c_void_p)


def _launch(op: str, f: torch.Tensor, g: torch.Tensor | None) -> torch.Tensor:
    out = torch.empty_like(f)
    rows = f.numel() // N
    if rows == 0:
        return out
    fn, error_string = L.entry(LIBRARY, "icicle_mlkem", _ARGTYPES)
    with torch.cuda.device(f.device):
        err = fn(OPS[op], f.data_ptr(), 0 if g is None else g.data_ptr(), out.data_ptr(), rows,
                 L.stream())
    L.raise_on(f"mlkem {op}", err, error_string)
    WRAPPERS[op].launches += 1
    return out


def mlkem_ntt(f: torch.Tensor) -> torch.Tensor:
    """(..., 256) int32 canonical coefficients -> their NTT. On a CUDA
    tensor this launches the kernel on the current stream (no
    synchronisation), counts the launch in `mlkem_ntt.launches` and raises
    if the launch is refused; on a CPU tensor it computes `ntt_ref`."""
    _check("mlkem_ntt", f)
    return _launch("ntt", f, None) if f.is_cuda else ntt_ref(f)


def mlkem_intt(f: torch.Tensor) -> torch.Tensor:
    """The inverse of `mlkem_ntt`, as it (`intt_ref` on a CPU tensor)."""
    _check("mlkem_intt", f)
    return _launch("intt", f, None) if f.is_cuda else intt_ref(f)


def mlkem_multiply_ntts(f: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Base-case products of two NTT-domain (..., 256) tensors of one shape,
    as `mlkem_ntt` (`multiply_ntts_ref` on a CPU tensor)."""
    _check("mlkem_multiply_ntts", f, g)
    return _launch("multiply_ntts", f, g) if f.is_cuda else multiply_ntts_ref(f, g)


WRAPPERS = {"ntt": mlkem_ntt, "intt": mlkem_intt, "multiply_ntts": mlkem_multiply_ntts}
for _w in WRAPPERS.values():
    _w.launches = 0
