"""The port's v2 suffix-fold MSM on the CPU: kernel B6's plain version
`suffix_fold_ref` against the JAX package's XLA twin `make_suffix_fold_xla`
(fed the twin's bf16 byte-and-flag layout built from the same limbs), the
wrapper's checks, `_plan2` against JAX's, `msm_tpu2` on the cases of
tests/test_msm_tpu2.py against the python-int oracle tests/ec_ref.py, and
`msm_affine`'s route under ICICLE_TPU_MSM_PIPELINE=v2. Tolerance: exact
equality."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icicle_tpu.curves.params import get_curve as jcurve
from icicle_tpu.ops import msm_tpu2 as JM2
from icicle_tpu.pallas.msm_fold2 import make_suffix_fold_xla
from icicle_tpu_torch import MSMConfig, msm_affine
from icicle_tpu_torch.kernels import ec_reduce as TR
from icicle_tpu_torch.kernels import msm_fold2 as TF
from icicle_tpu_torch.kernels import msm_scan as TS
from icicle_tpu_torch.ops import msm_tpu2 as TM2
from icicle_tpu_torch.ops.msm import msm_precompute_bases
from icicle_tpu_torch.runtime.errors import IcicleException
from tests.ec_ref import INF, ec_add, ec_mul, msm_ref

# The tier-1 run puts six pytest workers on the same cores; torch's intra-op
# threads then oversubscribe them and these small-tensor ops run ~10x slower.
torch.set_num_threads(1)

CURVE = "bn254"
NL = 8
MOD = jcurve(CURVE).fq.modulus


def _i32(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.uint32).view(np.int32))


def _setup(n, seed, small=False):
    c = jcurve(CURVE)
    rng = np.random.default_rng(seed)
    pts = [ec_mul((c.gen_x, c.gen_y), int(k), MOD) for k in rng.integers(1, 1 << 28, size=n)]
    scalars = [int(s) for s in rng.integers(0, 1 << 16, size=n)] if small else \
        [int.from_bytes(rng.bytes(40), "little") % c.fr.modulus for _ in range(n)]
    return pts, scalars


def _tensors(scalars, pts):
    c = jcurve(CURVE)
    return (_i32(c.fr.from_ints(scalars)), _i32(c.fq.from_ints([p[0] for p in pts])),
            _i32(c.fq.from_ints([p[1] for p in pts])))


def _want(scalars, pts):
    w = msm_ref(scalars, pts, MOD)
    return w if w is not INF else (0, 0)


def _fold_case(curve):
    """Runs of keys with dummy slots (is_real = 0) and run ends (is_dacc)
    inside K, negated y, a doubling, over a few lanes: (affine points,
    Montgomery x, y (K, C, L), real, dacc, neg (K, C))."""
    K, C = 6, 8
    c = jcurve(curve)
    fq, NL = c.fq, c.fq.nlimbs
    rng = np.random.default_rng(1)
    pts = [ec_mul((c.gen_x, c.gen_y), int(k), fq.modulus)
           for k in rng.integers(1, 1 << 28, size=K * C)]
    pts[C] = pts[0]                                  # lane 0: P then P
    mont = lambda v: np.asarray(fq.to_mont(fq.from_ints(v)))
    x = mont([p[0] for p in pts]).reshape(K, C, NL)
    y = mont([p[1] for p in pts]).reshape(K, C, NL)
    rng = np.random.default_rng(2)
    real = rng.random((K, C)) < 0.8
    dacc = rng.random((K, C)) < 0.5
    dacc[-1] = True
    neg = (rng.random((K, C)) < 0.5) & real
    return pts, x, y, real, dacc, neg


def _port_fold_inputs(curve, x, y, real, dacc, neg):
    """The port's input: y already negated (the +-P table), bits 0 and 1."""
    yneg = np.asarray(jcurve(curve).fq.neg(jnp.asarray(y)))
    ys = np.where(neg[..., None], yneg, y)
    plimbs = np.ascontiguousarray(np.concatenate([x, ys], -1).transpose(0, 2, 1))
    return _i32(plimbs), torch.from_numpy((real * TF.IS_REAL + dacc * TF.IS_DACC).astype(np.int32))


@pytest.mark.parametrize("curve", [CURVE, "bls12_381",
                                   pytest.param("bw6_761", marks=pytest.mark.slow)])
def test_suffix_fold_ref_matches_xla_twin(curve):
    """_fold_case at 8, 12 and 24 limbs (the 24-limb twin compiles for
    minutes: slow; test_suffix_fold_ref_24_limbs_matches_oracle holds it in
    tier 1)."""
    pts, x, y, real, dacc, neg = _fold_case(curve)
    K, C, NL = x.shape
    # the twin's input: coordinate bytes, then the flag word, then padding
    limbs = np.concatenate([x, y], -1)               # (K, C, 2L)
    planes = np.stack([(limbs >> (8 * b)) & 0xFF for b in range(4)], -1).reshape(K, C, 8 * NL)
    flags = real + 2 * dacc + 4 * neg
    rows = np.concatenate([planes, flags[..., None], np.zeros((K, C, 7))], -1)
    pbytes = jnp.asarray(rows.transpose(0, 2, 1)[None].astype(np.float32)).astype(jnp.bfloat16)
    dx, dy, dz = make_suffix_fold_xla(curve, K, C)(pbytes)
    want = np.concatenate([np.asarray(dx), np.asarray(dy), np.asarray(dz)])   # (3L, C)
    plimbs, tflags = _port_fold_inputs(curve, x, y, real, dacc, neg)
    # the serial fold (no split of the slots, a serial B4 over the run ends)
    got = TF.suffix_fold_ref(curve, plimbs, tflags, segments=1, reduce_segments=1)
    assert got.shape == (3 * NL, C) and got.dtype == torch.int32
    assert np.array_equal(got.numpy().view(np.uint32), want)
    TF.suffix_fold.launches = 0
    assert torch.equal(TF.suffix_fold(curve, plimbs, tflags),
                       TF.suffix_fold_ref(curve, plimbs, tflags))
    assert TF.suffix_fold.launches == 0


def test_suffix_fold_ref_24_limbs_matches_oracle():
    """bw6_761's plain B6, serial and split, against Python ints: per lane
    D = the sum of E at its run ends, E the running sum of its real points
    (signed)."""
    curve = "bw6_761"
    pts, x, y, real, dacc, neg = _fold_case(curve)
    K, C, NL = x.shape
    mod = jcurve(curve).fq.modulus
    want = []
    for lane in range(C):
        e = d = INF
        for k in range(K):
            p = pts[k * C + lane]
            if real[k, lane]:
                e = ec_add(e, (p[0], (-p[1]) % mod) if neg[k, lane] else p, mod)
            if dacc[k, lane]:
                d = ec_add(d, e, mod)
        want.append(d)
    plimbs, tflags = _port_fold_inputs(curve, x, y, real, dacc, neg)
    fq = jcurve(curve).fq
    rinv = pow(1 << (32 * NL), -1, mod)
    for S in (1, 3):
        got = TF.suffix_fold_ref(curve, plimbs, tflags, S).numpy().view(np.uint32)   # (3L, C)
        for lane in range(C):
            X, Y, Z = (int(v) * rinv % mod for v in fq.to_ints(got[:, lane].reshape(3, NL)))
            assert (None if Z == 0 else (X * pow(Z, -1, mod) % mod, Y * pow(Z, -1, mod) % mod)) \
                == want[lane]


def test_suffix_fold_rejects_bad_inputs():
    pts = torch.zeros((3, 2 * NL, 4), dtype=torch.int32)
    flags = torch.zeros((3, 4), dtype=torch.int32)
    for bad_pts, bad_flags in ((pts[:, :-1], flags), (pts.to(torch.int64), flags),
                               (pts, flags[:, :-1]), (pts, flags.to(torch.int64)),
                               (pts, flags.T.contiguous().T), (pts, flags[None])):
        with pytest.raises(IcicleException):
            TF.suffix_fold(CURVE, bad_pts, bad_flags)


@pytest.mark.parametrize("n,c,T", [(1 << 24, None, None), (1 << 20, None, None),
                                   (1 << 16, None, None), (64, 6, 16), (96, 5, 32),
                                   (128, None, 128), (1000, 11, 64)])
def test_plan2_matches_jax(n, c, T):
    nbits = jcurve(CURVE).fr.modulus.bit_length()
    assert TM2._plan2(n, c, nbits, T) == JM2._plan2(n, c, nbits, T)
    if n == 1 << 24:                                 # the 2^24 shape on the card
        assert TM2._plan2(n, c, nbits, T) == (9, 256, 2048, 8192, 29, 1)


@pytest.mark.parametrize("n,T,c", [(64, 16, 6), (96, 32, 5)])
def test_msm_tpu2_vs_oracle(n, T, c):
    pts, scalars = _setup(n, n)
    assert TM2.msm_tpu2(CURVE, *_tensors(scalars, pts), c=c, T=T) == _want(scalars, pts)


def test_msm_tpu2_unaligned_and_zeros():
    pts, _ = _setup(56, 7)
    rng = np.random.default_rng(8)
    scalars = [0] * 28 + [int(s) for s in rng.integers(0, 1 << 16, size=28)]
    assert TM2.msm_tpu2(CURVE, *_tensors(scalars, pts), c=6, T=16) == _want(scalars, pts)


def test_msm_tpu2_skewed_same_digit():
    pts, _ = _setup(32, 9)
    scalars = [(13 << 12) | 5] * 32
    assert TM2.msm_tpu2(CURVE, *_tensors(scalars, pts), c=5, T=16) == _want(scalars, pts)


def test_msm_affine_routes_to_v2(monkeypatch):
    pts, scalars = _setup(40, 10, small=True)
    args = _tensors(scalars, pts)
    calls = []
    real = TM2.msm_tpu2
    monkeypatch.setattr(TM2, "msm_tpu2", lambda *a, **k: calls.append(k) or real(*a, T=16, **k))
    TF.suffix_fold.launches = TS.prefix_scan.launches = TR.ec_reduce.launches = 0
    monkeypatch.setenv("ICICLE_TPU_MSM_PIPELINE", "v2")
    assert msm_affine(CURVE, *args, MSMConfig(c=6)) == _want(scalars, pts)
    assert calls == [{"c": 6, "backend": "torch", "bitsize": 0}]
    assert TF.suffix_fold.launches == TS.prefix_scan.launches == TR.ec_reduce.launches == 0
    # precomputed bases take v3, as in the JAX package (ops/msm.py:462-466):
    # v2 is not called
    cfg = MSMConfig(c=6, precompute_factor=2)
    bx, by = msm_precompute_bases(CURVE, args[1], args[2], cfg)
    assert msm_affine(CURVE, args[0], bx, by, cfg) == _want(scalars, pts)
    assert len(calls) == 1
