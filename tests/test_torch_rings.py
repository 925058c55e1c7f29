"""The babykoala ring on the port (icicle_tpu_torch/rings/, ops/ntt.py
`ntt_rns`, ops/mat_ops.py `rq_matmul`, kernels/rq_ntt_kernel.py) against
the JAX package (icicle_tpu/rings/, ops/ntt.py, ops/mat_ops.py) on the same
seeded inputs. Everything is integer arithmetic: the tolerance is 0, limb
for limb, and Python-int schoolbook products are the second oracle.

`rq_ntt_model` is a Python-int model of the CUDA kernel's algorithm
(kernels/csrc/rq_ntt.cu: the twist and a decimation-in-frequency transform
forward, a decimation-in-time transform and the untwist inverse, over the
wrapper's Montgomery-form table with R = 2^64), held to the plain version:
the kernel itself runs only on the card (chip_smoke.py)."""

import numpy as np
import pytest
import torch

import icicle_tpu.ops.mat_ops as jmat
import icicle_tpu.ops.ntt as jntt
import icicle_tpu.rings.babykoala as jbk
import icicle_tpu.rings.rq as jrq
from icicle_tpu.runtime.config import NTTConfig as JNTTConfig
from icicle_tpu.runtime.config import NTTDir as JNTTDir
from icicle_tpu_torch import interop
from icicle_tpu_torch.kernels import rq_ntt_kernel as RK
from icicle_tpu_torch.ops.mat_ops import rq_matmul
from icicle_tpu_torch.ops.ntt import ntt_rns
from icicle_tpu_torch.rings import babykoala as bk
from icicle_tpu_torch.rings import rq
from icicle_tpu_torch.runtime import device
from icicle_tpu_torch.runtime.config import NTTConfig, NTTDir

Q = bk.Q


@pytest.fixture(autouse=True)
def on_cpu(monkeypatch):
    monkeypatch.setattr(device, "_device", torch.device("cpu"))


def rand_ints(rng, shape, edges=True) -> np.ndarray:
    """Random Z_q values as Python ints; the first row 0 and the second
    q - 1 where `edges`."""
    flat = [int.from_bytes(rng.bytes(8), "little") % Q for _ in range(int(np.prod(shape)))]
    a = np.array(flat, dtype=object).reshape(shape)
    if edges and shape[0] > 1:
        a[0], a[1] = 0, Q - 1
    return a


def limbs(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def jlimbs(a) -> np.ndarray:
    return np.asarray(a)


def test_constants_equal_jax():
    bk.verify_constants()
    for name in ("P_BB", "P_KB", "Q", "ROU", "OMEGAS_COUNT", "RQ_DEGREE", "CRT_W_BB", "CRT_W_KB"):
        assert getattr(bk, name) == getattr(jbk, name), name
    zq, jzq = bk.get_zq(), jbk.get_zq()
    assert zq.nlimbs == 2 and zq.limb_shape == jzq.limb_shape == (2,)
    for logn in (1, 6, 7, 24):
        assert zq.params.omega(logn) == jzq.params.omega(logn)
    with pytest.raises(NotImplementedError):
        zq.inv(zq.from_ints([3]))
    assert zq.unit_inv_int(3) == jbk.get_zq().unit_inv_int(3)


def test_zq_ops_equal_jax():
    rng = np.random.default_rng(1)
    a, b = rand_ints(rng, (34,)), rand_ints(rng, (34,))[::-1].copy()
    zq, jzq = bk.get_zq(), jbk.get_zq()
    ta, tb = zq.from_ints(a), zq.from_ints(b)
    ja, jb = jzq.from_ints(a), jzq.from_ints(b)
    for op in ("add", "sub", "mul", "mul_mont"):
        assert np.array_equal(limbs(getattr(zq, op)(ta, tb)), jlimbs(getattr(jzq, op)(ja, jb))), op
    assert np.array_equal(limbs(zq.neg(ta)), jlimbs(jzq.neg(ja)))
    assert list(zq.to_ints(zq.mul(ta, tb))) == [x * y % Q for x, y in zip(a, b)]


def test_rns_equal_jax():
    rng = np.random.default_rng(2)
    a, b = rand_ints(rng, (17,)), rand_ints(rng, (17,))
    zq, jzq = bk.get_zq(), jbk.get_zq()
    ar, br = bk.zq_to_rns(zq.from_ints(a)), bk.zq_to_rns(zq.from_ints(b))
    jar, jbr = jbk.zq_to_rns(jzq.from_ints(a)), jbk.zq_to_rns(jzq.from_ints(b))
    assert np.array_equal(limbs(ar), jlimbs(jar))
    assert torch.equal(interop.zq_from_numpy(np.asarray(jar), rns=True), ar)
    assert torch.equal(interop.zq_from_numpy(np.asarray(jzq.from_ints(a))), zq.from_ints(a))
    with pytest.raises(Exception, match="not canonical"):
        interop.zq_from_numpy(np.array([[bk.P_BB, 0]], dtype=np.uint32), rns=True)
    with pytest.raises(Exception, match="not canonical"):
        interop.zq_from_numpy(np.array([[1, 0xFFFFFFFF]], dtype=np.uint32))
    assert [list(r) for r in ar.tolist()] == [[x % bk.P_BB, x % bk.P_KB] for x in a]
    assert np.array_equal(limbs(bk.rns_to_zq(ar)), jlimbs(jbk.rns_to_zq(jar)))
    assert list(zq.to_ints(bk.rns_to_zq(ar))) == list(a)
    rns, jrns = bk.get_rns(), jbk.get_rns()
    for op in ("add", "sub", "mul"):
        assert np.array_equal(limbs(getattr(rns, op)(ar, br)), jlimbs(getattr(jrns, op)(jar, jbr)))
    assert np.array_equal(limbs(rns.neg(ar)), jlimbs(jrns.neg(jar)))


def _rns_input(rng, shape):
    return np.stack([rng.integers(0, p, size=shape, dtype=np.int64) for p in (bk.P_BB, bk.P_KB)],
                    -1).astype(np.int32)


@pytest.mark.parametrize("shape, coset", [((3, 32), None), ((64,), 7)])
def test_ntt_rns_equal_jax(shape, coset):
    """Batched and single vectors, forward and inverse, with and without a
    coset: both planes limb for limb."""
    x = _rns_input(np.random.default_rng(3), shape)
    cfg, jcfg = NTTConfig(coset_gen=coset), JNTTConfig(coset_gen=coset)
    y = ntt_rns(torch.from_numpy(x), NTTDir.FORWARD, cfg)
    jy = jntt.ntt_rns(x.view(np.uint32), JNTTDir.FORWARD, jcfg)
    assert np.array_equal(limbs(y), np.asarray(jy))
    back = ntt_rns(y, NTTDir.INVERSE, cfg)
    assert np.array_equal(back.numpy(), x)
    assert np.array_equal(limbs(back), np.asarray(jntt.ntt_rns(jy, JNTTDir.INVERSE, jcfg)))


def test_ntt_rns_four_step_route_equal_jax():
    """A single 2^16 vector through the route the card takes (backend
    "cuda": the four-step over `dif_rows`, whose plain version runs on a CPU
    tensor) against JAX's ntt_rns."""
    x = _rns_input(np.random.default_rng(4), (1 << 16,))
    y = ntt_rns(torch.from_numpy(x), NTTDir.FORWARD, NTTConfig(backend="cuda"))
    assert np.array_equal(limbs(y), np.asarray(jntt.ntt_rns(x.view(np.uint32))))


# one batch shape for every R_q input, so that JAX compiles each transform once
SHAPE = (2, 2, 64)


def _polys(seed):
    return rand_ints(np.random.default_rng(seed), SHAPE)


def test_negacyclic_ntt_equal_jax():
    a = _polys(5)
    t, ja = rq.rq_from_ints(a), jrq.rq_from_ints(a)
    assert torch.equal(interop.rq_from_numpy(np.asarray(ja)), t)
    e = rq.negacyclic_ntt(t, NTTDir.FORWARD)
    je = jrq.negacyclic_ntt(ja, JNTTDir.FORWARD)
    assert np.array_equal(limbs(e), jlimbs(je))
    assert torch.equal(interop.rq_from_numpy(np.asarray(je)), e)
    back = rq.negacyclic_ntt(e, NTTDir.INVERSE)
    assert np.array_equal(limbs(back), jlimbs(jrq.negacyclic_ntt(je, JNTTDir.INVERSE)))
    assert np.array_equal(rq.rq_to_ints(back), a)
    for backend in ("torch", "cuda"):       # "cuda" on a CPU tensor: the plain version
        cfg = rq.NegacyclicNTTConfig(backend=backend)
        assert torch.equal(rq.negacyclic_ntt(t, NTTDir.FORWARD, cfg), e)


def test_rq_mul_equal_jax_and_schoolbook():
    a, b = _polys(6), _polys(7)
    got = rq.rq_mul(rq.rq_from_ints(a), rq.rq_from_ints(b))
    assert np.array_equal(limbs(got), jlimbs(jrq.rq_mul(jrq.rq_from_ints(a), jrq.rq_from_ints(b))))
    d = bk.RQ_DEGREE
    got_ints = rq.rq_to_ints(got).reshape(-1, d)
    for p, (x, y) in enumerate(zip(a.reshape(-1, d), b.reshape(-1, d))):
        want = [0] * d
        for i in range(d):
            for j in range(d):
                k = i + j
                want[k % d] += x[i] * y[j] * (1 if k < d else -1)
        assert list(got_ints[p]) == [w % Q for w in want]
    ea, eb = rq.negacyclic_ntt(rq.rq_from_ints(a)), rq.negacyclic_ntt(rq.rq_from_ints(b))
    assert torch.equal(rq.rq_mul_eval(ea, eb), bk.get_zq().mul(ea, eb))
    assert torch.equal(rq.rq_add(ea, eb), bk.get_zq().add(ea, eb))
    assert torch.equal(rq.rq_sub(ea, eb), bk.get_zq().sub(ea, eb))


def test_rq_matmul_equal_jax():
    rng = np.random.default_rng(8)
    A = rand_ints(rng, SHAPE)
    B = rand_ints(rng, SHAPE)
    got = rq_matmul(rq.rq_from_ints(A), rq.rq_from_ints(B))
    want = jmat.rq_matmul(jrq.rq_from_ints(A), jrq.rq_from_ints(B))
    assert got.shape == (2, 2, bk.RQ_DEGREE, 2)
    assert np.array_equal(limbs(got), jlimbs(want))


def test_rq_matmul_blocks_of_rows(monkeypatch):
    """rq_matmul's row blocks (the bound on its product buffer) give the
    same matrix as one block."""
    import icicle_tpu_torch.ops.mat_ops as M
    rng = np.random.default_rng(9)
    A = rq.rq_from_ints(rand_ints(rng, (3, 2, bk.RQ_DEGREE)))
    B = rq.rq_from_ints(rand_ints(rng, (2, 2, bk.RQ_DEGREE)))
    whole = rq_matmul(A, B)
    monkeypatch.setattr(M, "_RQ_PRODUCT_ELEMENTS", 1)
    assert torch.equal(rq_matmul(A, B), whole)


def _mont(a: int, b: int) -> int:
    """64-bit Montgomery multiply as rq_ntt.cu computes it."""
    lo, hi = (a * b) & (2**64 - 1), (a * b) >> 64
    m = (lo * RK.Q_INV) & (2**64 - 1)
    r = hi + ((m * Q) >> 64) + (1 if lo else 0)
    assert r < 2 * Q
    return r - Q if r >= Q else r


def rq_ntt_model(coeffs: list, inverse: bool) -> list:
    """rq_ntt.cu's algorithm on one polynomial of Python ints."""
    tab = [int(v) for v in RK.twiddle_table("cpu").tolist()]
    twist, fwd, inv, untwist = tab[:64], tab[64:96], tab[96:128], tab[128:]
    s = list(coeffs)
    if not inverse:
        s = [_mont(v, w) for v, w in zip(s, twist)]
        for lg in range(5, -1, -1):
            ln = 1 << lg
            for t in range(32):
                j = t & (ln - 1)
                i = (t - j) * 2 + j
                u, v = s[i], s[i + ln]
                s[i], s[i + ln] = (u + v) % Q, _mont((u - v) % Q, fwd[j << (5 - lg)])
        return s
    for lg in range(6):
        ln = 1 << lg
        for t in range(32):
            j = t & (ln - 1)
            i = (t - j) * 2 + j
            u, v = s[i], _mont(s[i + ln], inv[j << (5 - lg)])
            s[i], s[i + ln] = (u + v) % Q, (u - v) % Q
    return [_mont(v, w) for v, w in zip(s, untwist)]


def test_rq_ntt_kernel_model_equals_plain():
    a = _polys(10).reshape(-1, bk.RQ_DEGREE)
    t = rq.rq_from_ints(a)
    for d in (NTTDir.FORWARD, NTTDir.INVERSE):
        want = rq.rq_to_ints(RK.rq_ntt_ref(t, d))
        for p in range(a.shape[0]):
            assert rq_ntt_model(list(a[p]), d == NTTDir.INVERSE) == list(want[p])


def test_rq_ntt_wrapper_checks():
    with pytest.raises(Exception, match="rq_ntt"):
        RK.rq_ntt(torch.zeros((3, 32, 2), dtype=torch.int32))
    with pytest.raises(Exception, match="rq_ntt"):
        RK.rq_ntt(torch.zeros((3, 64, 2), dtype=torch.int64))
    assert RK.POLY_MONTS == 64 + 6 * 32
