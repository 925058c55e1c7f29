"""The split of B3's and B4's serial axis (icicle_tpu_torch/kernels/
msm_scan.py `scan_segments`, ec_reduce.py `reduce_segments`) in their plain
versions, on the CPU: the segmented association computes the same points as
the serial fold, and the MSM over it equals the python-int oracle.

The CUDA kernels repeat the plain versions' association and are held bit
for bit against them on the card by chip_smoke.py; here only the plain
versions run.

Tolerance: equality of points. A split changes which projective
representative comes out, so points are compared with the JAX XLA twins'
serial folds by cross products (X1 Z2 = X2 Z1, Y1 Z2 = Y2 Z1,
X1 Y2 = X2 Y1, neither (0, 0, 0)) in Python integers, or as affine points;
segment 0's rows are compared limb for limb.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icicle_tpu.curves.params import get_curve as jcurve
from icicle_tpu.pallas import ec_reduce as JR
from icicle_tpu.pallas import msm_scan as JS
from icicle_tpu_torch.kernels import ec_reduce as TR
from icicle_tpu_torch.kernels import msm_scan as TS
from icicle_tpu_torch.ops import msm_tpu3 as TM3
from icicle_tpu_torch.runtime.errors import IcicleException
from tests.ec_ref import INF, ec_mul, msm_ref
from tests.test_torch_msm_kernels import _affine_ints, _i32, _reduce_input, _scan_input, _u32

# The tier-1 run puts six pytest workers on the same cores; torch's intra-op
# threads then oversubscribe them and these small-tensor ops run ~10x slower.
torch.set_num_threads(1)

CURVE = "bn254"
NL = 8
MOD = jcurve(CURVE).fq.modulus
LANES = 5


def _coords(t: torch.Tensor):
    """(..., 3L, C) int32 limbs -> (x, y, z) lists of Python ints, one per
    (..., lane)."""
    a = _u32(t.transpose(-1, -2).contiguous()).astype(object)     # (..., C, 3L)
    words = [a[..., i * NL:(i + 1) * NL] for i in range(3)]
    shifts = np.array([1 << (32 * j) for j in range(NL)], dtype=object)
    return [list((w * shifts).sum(-1).reshape(-1)) for w in words]


def _same_points(a: torch.Tensor, b: torch.Tensor) -> bool:
    (x1, y1, z1), (x2, y2, z2) = _coords(a), _coords(b)
    for p1, p2 in zip(zip(x1, y1, z1), zip(x2, y2, z2)):
        if not any(p1) or not any(p2):
            return False
        (X1, Y1, Z1), (X2, Y2, Z2) = p1, p2
        if (X1 * Z2 - X2 * Z1) % MOD or (Y1 * Z2 - Y2 * Z1) % MOD or (X1 * Y2 - X2 * Y1) % MOD:
            return False
    return True


@functools.lru_cache(maxsize=None)
def _scan(K: int):
    x = _scan_input(K, LANES, seed=40 + K)
    assert (x >= 1 << 31).any()                    # limbs that are negative as int32
    return x


@functools.lru_cache(maxsize=None)
def _xla_scan(K: int):
    """JAX's serial fold (the XLA twin of make_prefix_scan)."""
    out = JS.make_prefix_scan_xla(CURVE, K, LANES)(jnp.asarray(_scan(K)[None]))[0]
    return _i32(np.asarray(out))


@pytest.mark.parametrize("K", [1, 5, 8, 13])
@pytest.mark.parametrize("S", [2, 3, 4, 8])
def test_prefix_scan_split_equals_serial_as_points(S, K):
    """Against JAX's serial fold, which segments=1 equals limb for limb:
    ragged last segments (13 = 4 + 4 + 4 + 1 at S 4), empty segments and
    K < S included; segment 0's rows are the serial ones, limb for limb."""
    got = TS.prefix_scan_ref(CURVE, _i32(_scan(K)), segments=S)
    want = _xla_scan(K)
    assert torch.equal(TS.prefix_scan_ref(CURVE, _i32(_scan(K)), segments=1), want)
    assert got.shape == want.shape == (K, 3 * NL, LANES) and got.dtype == torch.int32
    assert _same_points(got, want)
    n = -(-K // S)
    assert torch.equal(got[:n], want[:n])


def test_prefix_scan_split_changes_the_representative():
    """The split is not the serial fold limb for limb (so the kernel-versus-
    plain check must use the same segments), only point for point; lane 1
    alternates P, -P, so its odd slots stay the identity."""
    got = TS.prefix_scan_ref(CURVE, _i32(_scan(13)), segments=4)
    assert not torch.equal(got, TS.prefix_scan_ref(CURVE, _i32(_scan(13)), segments=1))
    assert not _u32(got)[1::2, 2 * NL:, 1].any()


def test_prefix_scan_default_plan_and_cpu_wrapper():
    x = _i32(_scan(13))
    S = TS.scan_segments(13, LANES)
    assert S == 2
    TS.prefix_scan.launches = 0
    got = TS.prefix_scan(CURVE, x)
    assert torch.equal(got, TS.prefix_scan_ref(CURVE, x))
    assert torch.equal(got, TS.prefix_scan_ref(CURVE, x, segments=S))
    assert torch.equal(TS.prefix_scan(CURVE, x, _segments=3),
                       TS.prefix_scan_ref(CURVE, x, segments=3))
    assert TS.prefix_scan.launches == 0


@functools.lru_cache(maxsize=None)
def _reduce(R: int):
    x = _reduce_input(R, LANES, seed=60 + R)
    assert (x >= 1 << 31).any()
    return x


@functools.lru_cache(maxsize=None)
def _xla_reduce(R: int):
    x = _reduce(R)
    return _affine_ints(np.asarray(JR.make_ec_reduce_xla(CURVE, R, LANES)(jnp.asarray(x))))


@pytest.mark.parametrize("S", [1, 2, 8, 32])
@pytest.mark.parametrize("R", [1, 3, 8, 13])
def test_ec_reduce_split_matches_xla_twin_as_affine(R, S):
    """Rows of identities (row 2), a P + (-P) lane, empty segments (S > R)."""
    got = TR.ec_reduce_ref(CURVE, _i32(_reduce(R)), segments=S)
    assert got.shape == (3 * NL, LANES) and got.dtype == torch.int32
    assert _affine_ints(_u32(got)) == _xla_reduce(R)
    serial = TR.ec_reduce_ref(CURVE, _i32(_reduce(R)), segments=1)
    assert _same_points(got, serial)


def test_ec_reduce_default_plan_and_cpu_wrapper():
    x = _i32(_reduce(13))
    S = TR.reduce_segments(13, LANES)
    assert S == 8
    TR.ec_reduce.launches = 0
    assert torch.equal(TR.ec_reduce(CURVE, x), TR.ec_reduce_ref(CURVE, x, segments=S))
    assert torch.equal(TR.ec_reduce(CURVE, x, _segments=2), TR.ec_reduce_ref(CURVE, x, segments=2))
    assert TR.ec_reduce.launches == 0


@pytest.mark.parametrize("K,C,S", [
    (8192, 4096, 16),     # v3 u32 2^24: one window group
    (8192, 64, 64),       # v3 2^16: S * S <= K caps it
    (64, 4096, 8),        # chip_smoke.py's cut depth
    (61, 4096, 4),
    (1, 4096, 1),
    (16, 100000, 1),      # enough lanes already
])
def test_scan_segments_pinned(K, C, S):
    assert TS.scan_segments(K, C) == S


@pytest.mark.parametrize("R,C,S", [
    (2048, 2048, 32),     # v3 2^24 cross-tile fold (12 per MSM)
    (8, 3072, 8),         # bucket pass 1: capped at R
    (128, 24, 32),        # bucket pass 2: capped at 32
    (64, 3712, 32),       # v2 2^24 cross-tile pass 1
    (128, 29, 32),        # v2 2^24 cross-tile pass 2
    (61, 2048, 32),
    (13, 5, 8),           # the largest power of two <= R
    (1, 24, 1),
])
def test_reduce_segments_pinned(R, C, S):
    assert TR.reduce_segments(R, C) == S


@pytest.mark.parametrize("fn,rows,S", [
    (TS.prefix_scan, 2 * NL, 0),
    (TS.prefix_scan, 2 * NL, 2.0),
    (TS.prefix_scan, 2 * NL, 1 << 16),
    (TS.prefix_scan_ref, 2 * NL, 0),
    (TR.ec_reduce, 3 * NL, 3),
    (TR.ec_reduce, 3 * NL, 64),
    (TR.ec_reduce, 3 * NL, 0),
])
def test_split_rejects_bad_segments(fn, rows, S):
    kw = {"segments": S} if fn is TS.prefix_scan_ref else {"_segments": S}
    with pytest.raises(IcicleException):
        fn(CURVE, torch.zeros((4, rows, 3), dtype=torch.int32), **kw)


def test_msm_tpu3_torch_backend_with_split_equals_oracle():
    """K = T = 64 slots over 1 tile x 8 windows a group: B3's plan gives
    S = 8 and the bucket fold (R = M = 32 rows over the padded windows)
    S = 32, so both splits run in the MSM."""
    c = jcurve(CURVE)
    rng = np.random.default_rng(70)
    pts = [ec_mul((c.gen_x, c.gen_y), int(k), MOD) for k in rng.integers(1, 1 << 28, size=64)]
    pts[5] = pts[4]                                       # a doubling in a bucket
    scalars = [int(s) for s in rng.integers(0, 1 << 62, size=64)]
    as_t = lambda a: torch.from_numpy(np.array(a, dtype=np.uint32).view(np.int32))
    s = as_t(c.fr.from_ints(scalars))
    x, y = (as_t(c.fq.from_ints([p[i] for p in pts])) for i in (0, 1))
    plan = TM3.msm_tpu3_prepare(CURVE, x, y, c=6, T=64)
    w_pad = -(-plan["n_windows"] // plan["wg"]) * plan["wg"]
    assert TS.scan_segments(plan["T"], plan["wg"] * plan["tiles"]) == 8
    assert TR.reduce_segments(plan["M"], w_pad) == 32
    want = msm_ref(scalars, pts, MOD)
    got = TM3.msm_tpu3(CURVE, s, prepared=plan, backend="torch")
    assert got == (want if want is not INF else (0, 0))
