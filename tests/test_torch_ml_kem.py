"""Batched ML-KEM on the port (icicle_tpu_torch/ops/pqc/) against the JAX
package's host oracle (icicle_tpu/ops/pqc/ml_kem.py, numpy) and its device
pipeline (ml_kem_tpu.py) on the same seeded entropy and messages, byte for
byte (tolerance 0): keygen, encaps, decaps and implicit rejection for
ML-KEM-512, -768 and -1024 at a batch of 3; the kernels' plain versions
(the Z_3329 NTT, its inverse, the base-case products, the Keccak sponge)
and the codecs and samplers against the JAX functions they replace. The
JAX device pipeline compiles for over a minute a parameter set on the CPU
(78 s for ML-KEM-512), so the whole-pipeline comparison with it is
slow-marked; the same outputs are held to the JAX host oracle at tier 1."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import icicle_tpu.ops.pqc.ml_kem as jhost
import icicle_tpu.ops.pqc.ml_kem_tpu as jdev
from icicle_tpu_torch.kernels import keccak_kernel as KK
from icicle_tpu_torch.kernels import mlkem_kernel as MK
from icicle_tpu_torch.ops.pqc import ml_kem as host
from icicle_tpu_torch.ops.pqc import ml_kem_tpu as D
from icicle_tpu_torch.runtime import device
from icicle_tpu_torch.runtime.errors import IcicleException

CATS = ["512", "768", "1024"]
B = 3


@pytest.fixture(autouse=True)
def on_cpu(monkeypatch):
    monkeypatch.setattr(device, "_device", torch.device("cpu"))


def inputs(cat: str):
    rng = np.random.default_rng(int(cat))
    return (rng.integers(0, 256, size=(B, 64), dtype=np.uint8),
            rng.integers(0, 256, size=(B, 32), dtype=np.uint8))


def np_(t: torch.Tensor) -> np.ndarray:
    return t.numpy()


@pytest.mark.parametrize("cat", CATS)
def test_pipeline_equals_jax_host_oracle(cat):
    """keygen, encaps, decaps and a tampered decaps, each byte for byte
    with the JAX host oracle; the port's own host copy equals it too."""
    entropy, msgs = inputs(cat)
    ek, dk = D.keygen(cat, entropy)
    jek, jdk = jhost.keygen(cat, entropy)
    assert np.array_equal(np_(ek), jek) and np.array_equal(np_(dk), jdk)
    c, K = D.encaps(cat, msgs, ek)
    jc, jK = jhost.encaps(cat, msgs, jek)
    assert np.array_equal(np_(c), jc) and np.array_equal(np_(K), jK)
    assert np.array_equal(np_(D.decaps(cat, c, dk)), jK)
    bad = c.clone()
    bad[:, 0] ^= 1
    jbad = jc.copy()
    jbad[:, 0] ^= 1
    rejected = np_(D.decaps(cat, bad, dk))
    assert np.array_equal(rejected, jhost.decaps(cat, jbad, jdk))
    assert not (rejected == jK).all(axis=1).any()             # the implicit-rejection secret
    hek, hdk = host.keygen(cat, entropy)
    assert np.array_equal(hek, jek) and np.array_equal(hdk, jdk)
    hc, hK = host.encaps(cat, msgs, hek)
    assert np.array_equal(hc, jc) and np.array_equal(hK, jK)
    assert np.array_equal(host.decaps(cat, jbad, hdk), rejected)


@pytest.mark.slow
@pytest.mark.parametrize("cat", CATS)
def test_pipeline_equals_jax_device(cat):
    """The same against JAX's jitted device pipeline (over a minute of
    compiles a parameter set on the CPU)."""
    entropy, msgs = inputs(cat)
    ek, dk = D.keygen(cat, entropy)
    jek, jdk = jdev.keygen(cat, entropy)
    assert np.array_equal(np_(ek), jek) and np.array_equal(np_(dk), jdk)
    c, K = D.encaps(cat, msgs, ek)
    jc, jK = jdev.encaps(cat, msgs, jek)
    assert np.array_equal(np_(c), jc) and np.array_equal(np_(K), jK)
    bad = c.clone()
    bad[:, 0] ^= 1
    assert np.array_equal(np_(D.decaps(cat, bad, dk)), jdev.decaps(cat, np_(bad), jdk))


def test_backends_and_devices():
    """"torch" and "auto" give the same bytes on the CPU; an unknown
    backend raises; a tensor input keeps its device, numpy goes to the
    default device."""
    entropy, msgs = inputs("512")
    ek, dk = D.keygen("512", entropy)
    ek2, dk2 = D.keygen("512", torch.from_numpy(entropy), host.MlKemConfig(backend="torch"))
    assert torch.equal(ek, ek2) and torch.equal(dk, dk2)
    with pytest.raises(IcicleException, match="no bogus backend"):
        D.keygen("512", entropy, host.MlKemConfig(backend="bogus"))
    with pytest.raises(IcicleException, match="uint8"):
        D.encaps("512", torch.from_numpy(msgs).to(torch.int32), ek)


def _ring_inputs():
    rng = np.random.default_rng(11)
    f = rng.integers(0, host.Q, size=(5, 256)).astype(np.int32)
    g = rng.integers(0, host.Q, size=(5, 256)).astype(np.int32)
    f[0], f[1], g[1] = 0, host.Q - 1, host.Q - 1
    return f, g


def test_ring_ops_equal_jax():
    """mlkem.cu's plain versions against JAX ml_kem_tpu.ntt, intt and
    multiply_ntts, with rows of 0 and 3328 among the inputs."""
    f, g = _ring_inputs()
    tf, tg = torch.from_numpy(f), torch.from_numpy(g)
    assert np.array_equal(MK.ntt_ref(tf).numpy(), np.asarray(jdev.ntt(jnp.asarray(f))))
    assert np.array_equal(MK.intt_ref(tf).numpy(), np.asarray(jdev.intt(jnp.asarray(f))))
    assert np.array_equal(MK.multiply_ntts_ref(tf, tg).numpy(),
                          np.asarray(jdev.multiply_ntts(jnp.asarray(f), jnp.asarray(g))))
    assert np.array_equal(MK.intt_ref(MK.ntt_ref(tf)).numpy(), f)
    for name in ("mlkem_ntt", "mlkem_intt"):                  # the wrappers, on a CPU tensor
        assert torch.equal(getattr(MK, name)(tf), getattr(MK, name.replace("mlkem_", "") + "_ref")(tf))
    assert torch.equal(MK.mlkem_multiply_ntts(tf, tg), MK.multiply_ntts_ref(tf, tg))
    assert MK.ZETAS == [int(v) for v in jdev._ZETAS_NP]
    assert MK.GAMMAS == [int(v) for v in jdev._GAMMAS_NP]


def _mlkem_kernel_model(op: int, f: list, g: list) -> list:
    """mlkem.cu's loops on one polynomial of Python ints (the CUDA kernel
    runs on the card only)."""
    q, s = host.Q, list(f)
    if op == 2:
        out = []
        for t in range(128):
            f0, f1, g0, g1 = f[2 * t], f[2 * t + 1], g[2 * t], g[2 * t + 1]
            out += [(f0 * g0 + (f1 * g1 % q) * MK.GAMMAS[t]) % q, (f0 * g1 + f1 * g0) % q]
        return out
    lens = [128 >> i for i in range(7)] if op == 0 else [2 << i for i in range(7)]
    for ln in lens:
        nb = 256 // (2 * ln)
        new = list(s)
        for t in range(128):
            grp, j = t // ln, t % ln
            i = grp * 2 * ln + j
            lo, hi = s[i], s[i + ln]
            if op == 0:
                tt = MK.ZETAS[nb + grp] * hi % q
                new[i], new[i + ln] = (lo + tt) % q, (lo - tt + q) % q
            else:
                new[i], new[i + ln] = (lo + hi) % q, MK.ZETAS[2 * nb - 1 - grp] * (hi - lo + q) % q
        s = new
    return s if op == 0 else [v * 3303 % q for v in s]


def test_mlkem_kernel_model_equals_plain():
    f, g = _ring_inputs()
    for op, ref in ((0, MK.ntt_ref), (1, MK.intt_ref)):
        want = ref(torch.from_numpy(f)).tolist()
        assert [_mlkem_kernel_model(op, list(r), None) for r in f.tolist()] == want
    want = MK.multiply_ntts_ref(torch.from_numpy(f), torch.from_numpy(g)).tolist()
    assert [_mlkem_kernel_model(2, a, b) for a, b in zip(f.tolist(), g.tolist())] == want


@pytest.mark.parametrize("nbytes, rate, pad, out_bytes", [
    (33, 72, 0x06, 64), (136, 136, 0x06, 32), (34, 168, 0x1F, 504 * 3), (33, 136, 0x1F, 192),
    (5, 136, 0x1F, 300)])
def test_sponge_equal_jax(nbytes, rate, pad, out_bytes):
    """keccak.cu's sponge entry's plain version against JAX `_sponge`, and
    row 0 against the port's host oracle's hashlib."""
    data = np.random.default_rng(nbytes).integers(0, 256, size=(2, nbytes), dtype=np.uint8)
    got = KK.keccak_sponge_ref(torch.from_numpy(data), rate, pad, out_bytes).numpy()
    want = np.asarray(jdev._sponge(jnp.asarray(data), rate, pad, out_bytes))
    assert np.array_equal(got, want)
    assert np.array_equal(KK.keccak_sponge(torch.from_numpy(data), rate, pad, out_bytes).numpy(),
                          got)
    with pytest.raises(IcicleException):
        KK.keccak_sponge(torch.from_numpy(data), 100, pad, out_bytes)


def test_codecs_and_samplers_equal_jax():
    rng = np.random.default_rng(12)
    for d in (1, 4, 5, 10, 11, 12):
        f = rng.integers(0, 1 << d, size=(2, 3, 256)).astype(np.int32)
        enc = D.byte_encode(torch.from_numpy(f), d)
        assert np.array_equal(enc.numpy(), np.asarray(jdev.byte_encode(jnp.asarray(f), d)))
        b = rng.integers(0, 256, size=(2, 32 * d), dtype=np.uint8)
        assert np.array_equal(D.byte_decode(torch.from_numpy(b), d).numpy(),
                              np.asarray(jdev.byte_decode(jnp.asarray(b), d)))
        x = rng.integers(0, host.Q, size=(2, 256)).astype(np.int32)
        assert np.array_equal(D.compress(torch.from_numpy(x), d).numpy(),
                              np.asarray(jdev.compress(jnp.asarray(x), d)))
        y = rng.integers(0, 1 << d, size=(2, 256)).astype(np.int32)
        assert np.array_equal(D.decompress(torch.from_numpy(y), d).numpy(),
                              np.asarray(jdev.decompress(jnp.asarray(y), d)))
    stream = rng.integers(0, 256, size=(3, 504 * 3), dtype=np.uint8)
    assert np.array_equal(D.sample_ntt(torch.from_numpy(stream)).numpy(),
                          np.asarray(jdev.sample_ntt(jnp.asarray(stream))))
    for eta in (2, 3):
        prf = rng.integers(0, 256, size=(3, 64 * eta), dtype=np.uint8)
        got = D.sample_cbd(torch.from_numpy(prf), eta)
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), np.asarray(jdev.sample_cbd(jnp.asarray(prf), eta)))
