"""ML-KEM (FIPS 203 / Kyber): the host oracle, batched over numpy lanes
(counterpart of icicle_tpu/ops/pqc/ml_kem.py; reference F21:
include/icicle/pqc/ml_kem.h over the CUDA-PQC backend).

The port keeps its own copy of the JAX package's numpy module. Its hashes
are hashlib's SHA3-256/512 and SHAKE128/256, one call a row (the JAX module
takes the JAX package's keccak_np). The batched device pipeline is
ops/pqc/ml_kem_tpu.py; this module is the byte-exactness oracle it is held
to.

Entropy and message semantics mirror ml_kem.h: keygen consumes 64 bytes
per keypair (d || z), encaps a 32-byte message m per operation.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Optional

import numpy as np


def _rows(fn, data: np.ndarray, *out) -> np.ndarray:
    """A hashlib function applied to each row of (B, n) uint8 -> (B, m)."""
    data = np.ascontiguousarray(data, dtype=np.uint8)
    return np.stack([np.frombuffer(fn(row.tobytes()).digest(*out), dtype=np.uint8)
                     for row in data])


def sha3_256(data: np.ndarray) -> np.ndarray:
    return _rows(hashlib.sha3_256, data)


def sha3_512(data: np.ndarray) -> np.ndarray:
    return _rows(hashlib.sha3_512, data)


def shake128(data: np.ndarray, out_bytes: int) -> np.ndarray:
    return _rows(hashlib.shake_128, data, out_bytes)


def shake256(data: np.ndarray, out_bytes: int) -> np.ndarray:
    return _rows(hashlib.shake_256, data, out_bytes)


Q = 3329
N = 256
ZETA = 17


@dataclasses.dataclass(frozen=True)
class Params:
    k: int
    eta1: int
    eta2: int
    du: int
    dv: int

    @property
    def ek_bytes(self) -> int:
        return 384 * self.k + 32

    @property
    def dk_bytes(self) -> int:
        return 768 * self.k + 96

    @property
    def ct_bytes(self) -> int:
        return 32 * (self.du * self.k + self.dv)


KYBER_512 = Params(2, 3, 2, 10, 4)
KYBER_768 = Params(3, 2, 2, 10, 4)
KYBER_1024 = Params(4, 2, 2, 11, 5)
PARAMS = {"512": KYBER_512, "768": KYBER_768, "1024": KYBER_1024,
          0: KYBER_512, 1: KYBER_768, 2: KYBER_1024}


@dataclasses.dataclass
class MlKemConfig:
    """Mirror of reference MlKemConfig (ml_kem.h:60-75), with the port's
    backend selector for the device pipeline (ml_kem_tpu.py): "torch" the
    plain versions on any device, "cuda" the kernels (mlkem.cu, keccak.cu's
    sponge), "auto" (None) the kernels for a CUDA tensor."""
    batch_size: int = 1
    backend: Optional[str] = None


# -- number theory tables ------------------------------------------------------

def _bitrev7(i: int) -> int:
    return int("".join(reversed(f"{i:07b}")), 2)


_ZETAS = np.array([pow(ZETA, _bitrev7(i), Q) for i in range(128)], dtype=np.int64)
_GAMMAS = np.array([pow(ZETA, 2 * _bitrev7(i) + 1, Q) for i in range(128)],
                   dtype=np.int64)


def ntt(f: np.ndarray) -> np.ndarray:
    """(..., 256) int64 -> NTT (FIPS 203 Alg 9)."""
    f = f.copy()
    i = 1
    length = 128
    while length >= 2:
        for start in range(0, 256, 2 * length):
            z = _ZETAS[i]
            i += 1
            hi = f[..., start + length:start + 2 * length]
            lo = f[..., start:start + length]
            t = z * hi % Q
            f[..., start + length:start + 2 * length] = (lo - t) % Q
            f[..., start:start + length] = (lo + t) % Q
        length //= 2
    return f


def intt(f: np.ndarray) -> np.ndarray:
    """Inverse NTT (FIPS 203 Alg 10)."""
    f = f.copy()
    i = 127
    length = 2
    while length <= 128:
        for start in range(0, 256, 2 * length):
            z = _ZETAS[i]
            i -= 1
            lo = f[..., start:start + length].copy()
            hi = f[..., start + length:start + 2 * length]
            f[..., start:start + length] = (lo + hi) % Q
            f[..., start + length:start + 2 * length] = z * (hi - lo) % Q
        length *= 2
    return f * 3303 % Q  # 3303 = 128^-1 mod q


def multiply_ntts(f: np.ndarray, g: np.ndarray) -> np.ndarray:
    """Basecase pairwise products (FIPS 203 Alg 11-12)."""
    f0, f1 = f[..., 0::2], f[..., 1::2]
    g0, g1 = g[..., 0::2], g[..., 1::2]
    h0 = (f0 * g0 + f1 * g1 % Q * _GAMMAS) % Q
    h1 = (f0 * g1 + f1 * g0) % Q
    out = np.empty_like(f)
    out[..., 0::2] = h0
    out[..., 1::2] = h1
    return out


# -- byte codecs ----------------------------------------------------------------

def byte_encode(f: np.ndarray, d: int) -> np.ndarray:
    """(..., 256) ints < 2^d -> (..., 32*d) uint8 (FIPS 203 Alg 5)."""
    lead = f.shape[:-1]
    bits = ((f[..., :, None].astype(np.int64) >> np.arange(d)) & 1).astype(np.uint8)
    bits = bits.reshape(lead + (256 * d,))
    return np.packbits(bits.reshape(lead + (32 * d, 8)), axis=-1,
                       bitorder="little").reshape(lead + (32 * d,))


def byte_decode(b: np.ndarray, d: int) -> np.ndarray:
    """(..., 32*d) uint8 -> (..., 256) ints (FIPS 203 Alg 6)."""
    lead = b.shape[:-1]
    bits = np.unpackbits(b, axis=-1, bitorder="little").reshape(lead + (256, d))
    vals = (bits.astype(np.int64) << np.arange(d)).sum(axis=-1)
    if d == 12:
        vals %= Q
    return vals


def compress(x: np.ndarray, d: int) -> np.ndarray:
    return ((x.astype(np.int64) << d) * 2 + Q) // (2 * Q) % (1 << d)


def decompress(y: np.ndarray, d: int) -> np.ndarray:
    return (y.astype(np.int64) * Q + (1 << (d - 1))) >> d


# -- samplers ---------------------------------------------------------------------

def sample_ntt(seed_blocks: np.ndarray) -> np.ndarray:
    """Rejection-sample one NTT poly per row from SHAKE128 output bytes.

    seed_blocks: (B, L) uint8 with L a multiple of 3, enough for 256 accepts
    (FIPS 203 Alg 7; acceptance rate q/4096 = 0.81, L=504*3 gives P(fail)<2^-128).
    """
    B, L = seed_blocks.shape
    trip = seed_blocks.reshape(B, L // 3, 3).astype(np.int64)
    d1 = trip[..., 0] + 256 * (trip[..., 1] % 16)
    d2 = trip[..., 1] // 16 + 16 * trip[..., 2]
    cand = np.stack([d1, d2], axis=-1).reshape(B, -1)   # (B, 2L/3)
    ok = cand < Q
    out = np.zeros((B, 256), dtype=np.int64)
    for b in range(B):
        acc = cand[b][ok[b]]
        assert acc.size >= 256, "insufficient SHAKE blocks for SampleNTT"
        out[b] = acc[:256]
    return out


def sample_cbd(prf_bytes: np.ndarray, eta: int) -> np.ndarray:
    """(B, 64*eta) uint8 -> (B, 256) CBD_eta samples (FIPS 203 Alg 8)."""
    B = prf_bytes.shape[0]
    bits = np.unpackbits(prf_bytes, axis=-1, bitorder="little").reshape(
        B, 256, 2, eta).astype(np.int64)
    x = bits[..., 0, :].sum(-1)
    y = bits[..., 1, :].sum(-1)
    return (x - y) % Q


# -- K-PKE ---------------------------------------------------------------------------

def _prf(eta: int, sigma: np.ndarray, n_byte: int) -> np.ndarray:
    B = sigma.shape[0]
    inp = np.concatenate([sigma, np.full((B, 1), n_byte, np.uint8)], axis=1)
    return shake256(inp, 64 * eta)


def _gen_matrix(rho: np.ndarray, k: int, transposed: bool) -> np.ndarray:
    """(B, 32) rho -> (B, k, k, 256) A-hat (row i, col j)."""
    B = rho.shape[0]
    blocks = 504 * 3  # 12 SHAKE128 blocks worth of bytes, multiple of 3
    A = np.zeros((B, k, k, 256), dtype=np.int64)
    for i in range(k):
        for j in range(k):
            suffix = np.array([[j, i]] if not transposed else [[i, j]],
                              dtype=np.uint8)
            inp = np.concatenate([rho, np.repeat(suffix, B, 0)], axis=1)
            stream = shake128(inp, blocks)
            A[:, i, j] = sample_ntt(stream)
    return A


def _kpke_keygen(d: np.ndarray, k: int, eta1: int):
    B = d.shape[0]
    g_in = np.concatenate([d, np.full((B, 1), k, np.uint8)], axis=1)
    g = sha3_512(g_in)
    rho, sigma = g[:, :32], g[:, 32:]
    A = _gen_matrix(rho, k, transposed=False)
    s = np.stack([sample_cbd(_prf(eta1, sigma, i), eta1) for i in range(k)], 1)
    e = np.stack([sample_cbd(_prf(eta1, sigma, k + i), eta1) for i in range(k)], 1)
    s_hat = ntt(s)
    e_hat = ntt(e)
    # t = A o s + e
    t_hat = np.zeros_like(s_hat)
    for i in range(k):
        acc = e_hat[:, i]
        for j in range(k):
            acc = (acc + multiply_ntts(A[:, i, j], s_hat[:, j])) % Q
        t_hat[:, i] = acc
    ek = np.concatenate([byte_encode(t_hat, 12).reshape(B, -1), rho], axis=1)
    dk = byte_encode(s_hat, 12).reshape(B, -1)
    return ek.astype(np.uint8), dk.astype(np.uint8)


def _kpke_encrypt(ek: np.ndarray, m: np.ndarray, r: np.ndarray, p: Params):
    B = ek.shape[0]
    k = p.k
    t_hat = byte_decode(ek[:, :384 * k].reshape(B, k, 384), 12)
    rho = ek[:, 384 * k:]
    At = _gen_matrix(rho, k, transposed=True)   # A^T[i][j] = A[j][i]
    y = np.stack([sample_cbd(_prf(p.eta1, r, i), p.eta1) for i in range(k)], 1)
    e1 = np.stack([sample_cbd(_prf(p.eta2, r, k + i), p.eta2) for i in range(k)], 1)
    e2 = sample_cbd(_prf(p.eta2, r, 2 * k), p.eta2)
    y_hat = ntt(y)
    u = np.zeros_like(y)
    for i in range(k):
        acc = np.zeros((B, 256), dtype=np.int64)
        for j in range(k):
            acc = (acc + multiply_ntts(At[:, i, j], y_hat[:, j])) % Q
        u[:, i] = (intt(acc) + e1[:, i]) % Q
    mu = decompress(byte_decode(m, 1), 1)
    v_acc = np.zeros((B, 256), dtype=np.int64)
    for j in range(k):
        v_acc = (v_acc + multiply_ntts(t_hat[:, j], y_hat[:, j])) % Q
    v = (intt(v_acc) + e2 + mu) % Q
    c1 = byte_encode(compress(u, p.du), p.du).reshape(B, -1)
    c2 = byte_encode(compress(v, p.dv), p.dv)
    return np.concatenate([c1, c2], axis=1).astype(np.uint8)


def _kpke_decrypt(dk: np.ndarray, c: np.ndarray, p: Params):
    B = dk.shape[0]
    k = p.k
    c1 = c[:, :32 * p.du * k].reshape(B, k, 32 * p.du)
    c2 = c[:, 32 * p.du * k:]
    u = decompress(byte_decode(c1, p.du), p.du)
    v = decompress(byte_decode(c2, p.dv), p.dv)
    s_hat = byte_decode(dk.reshape(B, k, 384), 12)
    acc = np.zeros((B, 256), dtype=np.int64)
    for j in range(k):
        acc = (acc + multiply_ntts(s_hat[:, j], ntt(u[:, j]))) % Q
    w = (v - intt(acc)) % Q
    return byte_encode(compress(w, 1), 1).astype(np.uint8)


# -- ML-KEM public API (mirrors ml_kem.h) ----------------------------------------

def _params_of(category) -> Params:
    if isinstance(category, Params):
        return category
    return PARAMS[category]


def keygen(category, entropy: np.ndarray, cfg: MlKemConfig | None = None):
    """entropy: (batch, 64) uint8 = d || z. Returns (ek, dk) byte arrays."""
    p = _params_of(category)
    entropy = np.asarray(entropy, dtype=np.uint8).reshape(-1, 64)
    d, z = entropy[:, :32], entropy[:, 32:]
    ek, dk_pke = _kpke_keygen(d, p.k, p.eta1)
    h = sha3_256(ek)
    dk = np.concatenate([dk_pke, ek, h, z], axis=1)
    assert ek.shape[1] == p.ek_bytes and dk.shape[1] == p.dk_bytes
    return ek, dk


def encaps(category, messages: np.ndarray, public_keys: np.ndarray,
           cfg: MlKemConfig | None = None):
    """messages: (batch, 32) uint8 m. Returns (ciphertexts, shared_secrets)."""
    p = _params_of(category)
    m = np.asarray(messages, dtype=np.uint8).reshape(-1, 32)
    ek = np.asarray(public_keys, dtype=np.uint8).reshape(-1, p.ek_bytes)
    h = sha3_256(ek)
    g = sha3_512(np.concatenate([m, h], axis=1))
    K, r = g[:, :32], g[:, 32:]
    c = _kpke_encrypt(ek, m, r, p)
    assert c.shape[1] == p.ct_bytes
    return c, K


def decaps(category, ciphertexts: np.ndarray, secret_keys: np.ndarray,
           cfg: MlKemConfig | None = None):
    """Returns shared_secrets (batch, 32); implicit rejection per FIPS 203."""
    p = _params_of(category)
    k = p.k
    c = np.asarray(ciphertexts, dtype=np.uint8).reshape(-1, p.ct_bytes)
    dk = np.asarray(secret_keys, dtype=np.uint8).reshape(-1, p.dk_bytes)
    dk_pke = dk[:, :384 * k]
    ek = dk[:, 384 * k:768 * k + 32]
    h = dk[:, 768 * k + 32:768 * k + 64]
    z = dk[:, 768 * k + 64:]
    m_prime = _kpke_decrypt(dk_pke, c, p)
    g = sha3_512(np.concatenate([m_prime, h], axis=1))
    K_prime, r_prime = g[:, :32], g[:, 32:]
    K_bar = shake256(np.concatenate([z, c], axis=1), 32)
    c_prime = _kpke_encrypt(ek, m_prime, r_prime, p)
    reject = (c != c_prime).any(axis=1)
    out = K_prime.copy()
    out[reject] = K_bar[reject]
    return out
