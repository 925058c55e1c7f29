"""ML-KEM's matrix A-hat on the port (icicle_tpu_torch/ops/pqc/
ml_kem_tpu.py `_gen_matrix`: the B k^2 SHAKE128 messages rho || a || b as
one batch, one sponge call and one sample_ntt call) against the JAX
package's `_gen_matrix` (icicle_tpu/ops/pqc/ml_kem_tpu.py, a sponge an
entry), both transposed and not, at k = 2, 3 and 4 on numpy-seeded rho,
byte for byte (tolerance 0).

JAX's `_sponge` runs eagerly here at about 2.5 s a 1512-byte XOF, so the
k = 3 and 4 cases give JAX's `_gen_matrix` its SHAKE128 through hashlib
(`shake128_host`, held to JAX's own `_sponge` on one message below and by
tests/test_torch_ml_kem.py's sponge tests), and so does k = 2 transposed;
k = 2 not transposed runs JAX's whole function as it is."""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import icicle_tpu.ops.pqc.ml_kem_tpu as jdev
from icicle_tpu_torch.kernels import keccak_kernel as KK
from icicle_tpu_torch.kernels import mlkem_kernel as MK
from icicle_tpu_torch.ops.pqc import ml_kem_tpu as D
from icicle_tpu_torch.runtime import device

B = 2


@pytest.fixture(autouse=True)
def on_cpu(monkeypatch):
    monkeypatch.setattr(device, "_device", torch.device("cpu"))


def shake128_host(data, out_bytes: int):
    """JAX `shake128` on (B, n) uint8 rows, through hashlib."""
    rows = np.asarray(data)
    return jnp.asarray(np.stack([np.frombuffer(hashlib.shake_128(bytes(r)).digest(out_bytes),
                                               dtype=np.uint8) for r in rows]))


def counted_ops():
    """The port's plain-version ops, with each sponge call's batch kept."""
    calls = []

    def sponge(data, rate, pad, out_bytes):
        calls.append((data.shape[0], rate, pad, out_bytes))
        return KK.keccak_sponge_ref(data, rate, pad, out_bytes)

    return D._Ops(sponge, MK.ntt_ref, MK.intt_ref, MK.multiply_ntts_ref), calls


def test_host_shake128_is_jax_sponge():
    data = np.random.default_rng(7).integers(0, 256, size=(1, 34), dtype=np.uint8)
    assert np.array_equal(np.asarray(shake128_host(data, 504 * 3)),
                          np.asarray(jdev.shake128(jnp.asarray(data), 504 * 3)))


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("k", [2, 3, 4])
def test_gen_matrix_equals_jax(monkeypatch, k, transposed):
    """(B, k, k, 256) equal to JAX's, row i and column j in JAX's places,
    from a single SHAKE128 call over B k^2 messages of 34 bytes."""
    rho = np.random.default_rng(100 * k + transposed).integers(0, 256, size=(B, 32),
                                                              dtype=np.uint8)
    ops, calls = counted_ops()
    got = D._gen_matrix(ops, torch.from_numpy(rho), k, transposed)
    assert calls == [(B * k * k, 168, 0x1F, 504 * 3)]
    if k > 2 or transposed:
        monkeypatch.setattr(jdev, "shake128", shake128_host)
    want = np.asarray(jdev._gen_matrix(jnp.asarray(rho), k, transposed))
    assert got.shape == (B, k, k, 256) and got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
