"""Device-resident ML-KEM (FIPS 203): batched keygen / encaps / decaps on
(B, ...) uint8 tensors (counterpart of icicle_tpu/ops/pqc/ml_kem_tpu.py,
whose name it keeps).

The JAX module compiles each operation into one XLA program; here each is a
sequence of torch ops over the whole batch on the input's device, with
three kinds of work in hand-written kernels (backend "cuda", or "auto" on a
CUDA tensor; `MlKemConfig.backend`):
  * the Keccak sponges SHA3-256/512 and SHAKE128/256 (keccak.cu's
    `icicle_keccak_sponge`, one thread a message; kernels/keccak_kernel.py);
  * the Z_3329 NTT, its inverse and the base-case products (mlkem.cu, one
    block a polynomial; kernels/mlkem_kernel.py).
Backend "torch" runs their plain versions on any device. The rest is torch
on the device in either case: the byte codecs, compression, the CBD
sampler and the rejection sampler, which, as JAX's, takes the first 256
accepted candidates of the SHAKE128 stream with a stable argsort on the
reject flag (no dynamic shapes). Implicit rejection in decaps is JAX's: a
select between K' and the SHAKE256 of z || c on a re-encryption mismatch.

The host oracle ops/pqc/ml_kem.py (hashlib, numpy) is what these outputs
are held to, byte for byte.
"""

from __future__ import annotations

import numpy as np
import torch

from icicle_tpu_torch.kernels import keccak_kernel as KK
from icicle_tpu_torch.kernels import mlkem_kernel as MK
from icicle_tpu_torch.ops.pqc.ml_kem import PARAMS, MlKemConfig, Params
from icicle_tpu_torch.runtime import dispatcher
from icicle_tpu_torch.runtime.device import resolve
from icicle_tpu_torch.runtime.errors import IcicleError, IcicleException

Q = MK.Q
I32 = torch.int32
U8 = torch.uint8
_GEN_MATRIX_BYTES = 504 * 3  # SHAKE128 bytes a matrix entry: 9 blocks, P(shortfall) < 2^-128


class _Ops:
    """The kernel-backed operations of one backend."""

    def __init__(self, sponge, ntt, intt, multiply_ntts):
        self.sponge, self.ntt, self.intt, self.multiply_ntts = sponge, ntt, intt, multiply_ntts

    def sha3_256(self, data):
        return self.sponge(data, 136, 0x06, 32)

    def sha3_512(self, data):
        return self.sponge(data, 72, 0x06, 64)

    def shake128(self, data, out_bytes: int):
        return self.sponge(data, 168, 0x1F, out_bytes)

    def shake256(self, data, out_bytes: int):
        return self.sponge(data, 136, 0x1F, out_bytes)


dispatcher.register_impl("ml_kem", dispatcher.TORCH,
                        _Ops(KK.keccak_sponge_ref, MK.ntt_ref, MK.intt_ref, MK.multiply_ntts_ref))
dispatcher.register_impl("ml_kem", dispatcher.CUDA,
                        _Ops(KK.keccak_sponge, MK.mlkem_ntt, MK.mlkem_intt, MK.mlkem_multiply_ntts))


def _ops(cfg: MlKemConfig | None, x: torch.Tensor) -> _Ops:
    return dispatcher.dispatch("ml_kem", cfg.backend if cfg is not None else None, x)


def _cat(*parts):
    return torch.cat([p.contiguous() for p in parts], dim=1)


def _byte_col(B: int, value: int, device) -> torch.Tensor:
    return torch.full((B, 1), value, dtype=U8, device=device)


# -- byte codecs and compression (FIPS 203 Algs 5-6, 4.7-4.8) -------------------------

def byte_encode(f: torch.Tensor, d: int) -> torch.Tensor:
    """(..., 256) ints < 2^d -> (..., 32 d) uint8, little-endian bits."""
    lead = f.shape[:-1]
    bits = torch.stack([((f >> j) & 1).to(U8) for j in range(d)], dim=-1)  # (..., 256, d)
    bits = bits.reshape(lead + (32 * d, 8))
    out = bits[..., 0].clone()
    for k in range(1, 8):
        out |= bits[..., k] << k
    return out


def byte_decode(b: torch.Tensor, d: int) -> torch.Tensor:
    """(..., 32 d) uint8 -> (..., 256) int32 (reduced mod q for d = 12)."""
    lead = b.shape[:-1]
    bits = torch.stack([(b >> k) & 1 for k in range(8)], dim=-1).reshape(lead + (256, d))
    vals = bits[..., 0].to(I32)
    for j in range(1, d):
        vals |= bits[..., j].to(I32) << j
    return vals % Q if d == 12 else vals


def compress(x: torch.Tensor, d: int) -> torch.Tensor:
    return (((x.to(I32) << d) * 2 + Q) // (2 * Q)) % (1 << d)


def decompress(y: torch.Tensor, d: int) -> torch.Tensor:
    return (y.to(I32) * Q + (1 << (d - 1))) >> d


# -- samplers --------------------------------------------------------------------------

def sample_ntt(seed_blocks: torch.Tensor) -> torch.Tensor:
    """(B, L) uint8 SHAKE128 stream -> (B, 256) int32 accepted coefficients
    (FIPS 203 Alg 7): the first 256 candidates below q in stream order,
    gathered through a stable argsort on the reject flag (static shapes)."""
    B, L = seed_blocks.shape
    trip = seed_blocks.reshape(B, L // 3, 3).to(I32)
    d1 = trip[..., 0] + 256 * (trip[..., 1] % 16)
    d2 = trip[..., 1] // 16 + 16 * trip[..., 2]
    cand = torch.stack([d1, d2], dim=-1).reshape(B, -1)
    order = torch.argsort((cand >= Q).to(U8), dim=-1, stable=True)
    return torch.gather(cand, 1, order[:, :256])


def sample_cbd(prf_bytes: torch.Tensor, eta: int) -> torch.Tensor:
    """(B, 64 eta) uint8 -> (B, 256) int32 CBD_eta samples (FIPS 203 Alg 8)."""
    B = prf_bytes.shape[0]
    bits = torch.stack([(prf_bytes >> k) & 1 for k in range(8)], dim=-1)
    bits = bits.reshape(B, 256, 2, eta).to(I32)
    return (bits[..., 0, :].sum(-1, dtype=I32) - bits[..., 1, :].sum(-1, dtype=I32)) % Q


# -- K-PKE -------------------------------------------------------------------------------

def _prf(ops: _Ops, eta: int, sigma: torch.Tensor, n_byte: int) -> torch.Tensor:
    return ops.shake256(_cat(sigma, _byte_col(sigma.shape[0], n_byte, sigma.device)), 64 * eta)


def _cbd_vector(ops: _Ops, eta: int, sigma: torch.Tensor, first: int, k: int) -> torch.Tensor:
    """(B, k, 256) CBD samples of PRF(sigma, first + i), i < k."""
    return torch.stack([sample_cbd(_prf(ops, eta, sigma, first + i), eta) for i in range(k)], 1)


def _gen_matrix(ops: _Ops, rho: torch.Tensor, k: int, transposed: bool) -> torch.Tensor:
    """(B, 32) rho -> (B, k, k, 256) A-hat (row i, column j): entry (i, j)
    from SHAKE128(rho || j || i), or rho || i || j transposed."""
    B = rho.shape[0]
    rows = []
    for i in range(k):
        cols = []
        for j in range(k):
            a, b = (j, i) if not transposed else (i, j)
            sfx = torch.tensor([[a, b]], dtype=U8, device=rho.device).expand(B, 2)
            cols.append(sample_ntt(ops.shake128(_cat(rho, sfx), _GEN_MATRIX_BYTES)))
        rows.append(torch.stack(cols, dim=1))
    return torch.stack(rows, dim=1)


def _mat_vec(ops: _Ops, A: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """sum_j A[:, i, j] o v[:, j] mod q for every i: (B, k, k, 256) and
    (B, k, 256) -> (B, k, 256), every base-case product in one call."""
    prod = ops.multiply_ntts(A.contiguous(), v.unsqueeze(1).expand_as(A).contiguous())
    return prod.sum(dim=2, dtype=I32) % Q


def _dot(ops: _Ops, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum_j a[:, j] o b[:, j] mod q: (B, k, 256) twice -> (B, 256)."""
    return ops.multiply_ntts(a.contiguous(), b.contiguous()).sum(dim=1, dtype=I32) % Q


def _kpke_keygen(ops: _Ops, d: torch.Tensor, k: int, eta1: int):
    B = d.shape[0]
    g = ops.sha3_512(_cat(d, _byte_col(B, k, d.device)))
    rho, sigma = g[:, :32], g[:, 32:]
    A = _gen_matrix(ops, rho, k, transposed=False)
    s_hat = ops.ntt(_cbd_vector(ops, eta1, sigma, 0, k))
    e_hat = ops.ntt(_cbd_vector(ops, eta1, sigma, k, k))
    t_hat = (e_hat + _mat_vec(ops, A, s_hat)) % Q
    ek = _cat(byte_encode(t_hat, 12).reshape(B, -1), rho)
    dk = byte_encode(s_hat, 12).reshape(B, -1)
    return ek, dk


def _kpke_encrypt(ops: _Ops, ek: torch.Tensor, m: torch.Tensor, r: torch.Tensor, p: Params):
    B, k = ek.shape[0], p.k
    t_hat = byte_decode(ek[:, :384 * k].reshape(B, k, 384), 12)
    rho = ek[:, 384 * k:]
    At = _gen_matrix(ops, rho, k, transposed=True)
    y = _cbd_vector(ops, p.eta1, r, 0, k)
    e1 = _cbd_vector(ops, p.eta2, r, k, k)
    e2 = sample_cbd(_prf(ops, p.eta2, r, 2 * k), p.eta2)
    y_hat = ops.ntt(y)
    u = (ops.intt(_mat_vec(ops, At, y_hat)) + e1) % Q
    mu = decompress(byte_decode(m, 1), 1)
    v = (ops.intt(_dot(ops, t_hat, y_hat)) + e2 + mu) % Q
    c1 = byte_encode(compress(u, p.du), p.du).reshape(B, -1)
    c2 = byte_encode(compress(v, p.dv), p.dv)
    return _cat(c1, c2)


def _kpke_decrypt(ops: _Ops, dk: torch.Tensor, c: torch.Tensor, p: Params):
    B, k = dk.shape[0], p.k
    c1 = c[:, :32 * p.du * k].reshape(B, k, 32 * p.du)
    c2 = c[:, 32 * p.du * k:]
    u = decompress(byte_decode(c1, p.du), p.du)
    v = decompress(byte_decode(c2, p.dv), p.dv)
    s_hat = byte_decode(dk.reshape(B, k, 384), 12)
    w = (v - ops.intt(_dot(ops, s_hat, ops.ntt(u)))) % Q
    return byte_encode(compress(w, 1), 1)


# -- public API (mirrors reference ml_kem.h; device-resident) ----------------------------

def _params_of(category) -> Params:
    return category if isinstance(category, Params) else PARAMS[category]


def _device(*xs, device=None) -> torch.device:
    """The device of the first tensor among xs, else `device` (default:
    default_device())."""
    for x in xs:
        if isinstance(x, torch.Tensor):
            return x.device
    return resolve(device)


def _bytes(x, width: int, device: torch.device) -> torch.Tensor:
    """A contiguous (batch, width) uint8 tensor on `device` from a uint8
    tensor there, or from a numpy array."""
    if isinstance(x, torch.Tensor):
        if x.dtype != U8 or x.device != device:
            raise IcicleException(IcicleError.INVALID_ARGUMENT,
                                  f"expected uint8 on {device}, got {x.dtype} on {x.device}")
        return x.reshape(-1, width).contiguous()
    return torch.from_numpy(np.asarray(x, dtype=np.uint8).reshape(-1, width).copy()).to(device)


def keygen(category, entropy, cfg: MlKemConfig | None = None, device=None):
    """entropy: (batch, 64) uint8 = d || z. Returns (ek, dk), uint8 tensors
    on entropy's device (a tensor's, else `device`)."""
    p = _params_of(category)
    entropy = _bytes(entropy, 64, _device(entropy, device=device))
    ops = _ops(cfg, entropy)
    ek, dk_pke = _kpke_keygen(ops, entropy[:, :32], p.k, p.eta1)
    return ek, _cat(dk_pke, ek, ops.sha3_256(ek), entropy[:, 32:])


def encaps(category, messages, public_keys, cfg: MlKemConfig | None = None, device=None):
    """messages: (batch, 32) uint8. Returns (ciphertexts, shared_secrets) on
    the inputs' device (the first tensor's, else `device`)."""
    p = _params_of(category)
    dev = _device(messages, public_keys, device=device)
    m = _bytes(messages, 32, dev)
    ek = _bytes(public_keys, p.ek_bytes, dev)
    ops = _ops(cfg, m)
    g = ops.sha3_512(_cat(m, ops.sha3_256(ek)))
    K, r = g[:, :32], g[:, 32:]
    return _kpke_encrypt(ops, ek, m, r, p), K.contiguous()


def decaps(category, ciphertexts, secret_keys, cfg: MlKemConfig | None = None, device=None):
    """Returns the shared secrets (batch, 32); implicit rejection per FIPS
    203: a ciphertext whose re-encryption differs gives SHAKE256(z || c)."""
    p = _params_of(category)
    k = p.k
    dev = _device(ciphertexts, secret_keys, device=device)
    c = _bytes(ciphertexts, p.ct_bytes, dev)
    dk = _bytes(secret_keys, p.dk_bytes, dev)
    ops = _ops(cfg, c)
    dk_pke = dk[:, :384 * k]
    ek = dk[:, 384 * k:768 * k + 32]
    h = dk[:, 768 * k + 32:768 * k + 64]
    z = dk[:, 768 * k + 64:]
    m_prime = _kpke_decrypt(ops, dk_pke, c, p)
    g = ops.sha3_512(_cat(m_prime, h))
    K_prime, r_prime = g[:, :32], g[:, 32:]
    K_bar = ops.shake256(_cat(z, c), 32)
    c_prime = _kpke_encrypt(ops, ek.contiguous(), m_prime, r_prime, p)
    reject = (c != c_prime).any(dim=1)
    return torch.where(reject[:, None], K_bar, K_prime)
