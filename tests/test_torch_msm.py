"""The port's MSM planning and digit code (icicle_tpu_torch/ops/msm.py,
ops/msm_tpu3.py) against the JAX package's functions, and the port's v3
pipeline `msm_tpu3` on the CPU (the plain versions of B3 and B4) against the
python-int oracle tests/ec_ref.py on the cases of tests/test_msm_tpu3.py.

The pipeline is held against the oracle, not against JAX msm_tpu3: that
takes about a minute per call on the CPU here (see test_torch_msm_golden.py
for the one slow-marked comparison). Tolerance: exact equality.
"""

import numpy as np
import pytest
import torch

from icicle_tpu.curves.params import get_curve as jcurve
from icicle_tpu.ops import msm as JM
from icicle_tpu.ops import msm_tpu2 as JM2
from icicle_tpu.ops import msm_tpu3 as JM3
from icicle_tpu_torch.ops import msm as TM
from icicle_tpu_torch.ops import msm_tpu3 as TM3
from tests.ec_ref import INF, ec_mul, msm_ref

# The tier-1 run puts six pytest workers on the same cores; torch's intra-op
# threads then oversubscribe them and these small-tensor ops run ~10x slower.
torch.set_num_threads(1)


def _setup(n, seed):
    curve = jcurve("bn254")
    mod = curve.fq.modulus
    rng = np.random.default_rng(seed)
    gen = (curve.gen_x, curve.gen_y)
    pts = [ec_mul(gen, int(k), mod) for k in rng.integers(1, 1 << 28, size=n)]
    scalars = [int.from_bytes(rng.bytes(40), "little") % curve.fr.modulus for _ in range(n)]
    return pts, scalars


def _tensors(scalars, pts):
    """Python ints -> CPU int32 limb tensors (the uint32 bits), built through
    the JAX Field so both packages see the same arrays."""
    c = jcurve("bn254")
    as_t = lambda a: torch.from_numpy(np.array(a, dtype=np.uint32).view(np.int32))
    return (as_t(c.fr.from_ints(scalars)), as_t(c.fq.from_ints([p[0] for p in pts])),
            as_t(c.fq.from_ints([p[1] for p in pts])))


def _want(scalars, pts):
    w = msm_ref(scalars, pts, jcurve("bn254").fq.modulus)
    return w if w is not INF else (0, 0)


@pytest.mark.parametrize("n,c,T,wg", [(1 << 24, None, None, None), (1 << 16, None, None, None),
                                      (1 << 20, None, None, None), (64, 6, 16, None),
                                      (96, 5, 32, None), (128, None, 128, None),
                                      (1000, 9, None, 2), (3, None, None, None)])
def test_plan3_matches_jax(n, c, T, wg):
    assert TM3._plan3(n, c, 254, T, wg) == JM3._plan3(n, c, 254, T, wg)


def test_bench_plan():
    """bench.py's 2^24: 12 groups of 2 windows over 2048 tiles of 8192."""
    assert TM3._plan3(1 << 24, None, 254, None) == (11, 1024, 8192, 2048, 24, 2)


@pytest.mark.parametrize("nbits,c", [(254, 11), (254, 6), (253, 11), (256, 16), (64, 4)])
def test_signed_window_count(nbits, c):
    assert TM.signed_window_count(nbits, c) == JM.signed_window_count(nbits, c)


@pytest.mark.parametrize("c", [4, 5, 6, 11, 16])
def test_signed_digits_match_jax(c):
    rng = np.random.default_rng(c)
    fr = jcurve("bn254").fr
    s = np.array(fr.rand(rng, (37,)))
    s[0] = 0
    s[1] = np.asarray(fr.from_ints([fr.modulus - 1]))[0]
    s_t = torch.from_numpy(s.view(np.int32))
    want = np.asarray(JM._signed_digits(s, c, 254))
    got = TM._signed_digits(s_t, c, 254)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    want_t = np.asarray(JM2._signed_digits_t(np.ascontiguousarray(s.T), c, 254))
    got_t = TM._signed_digits_t(s_t.T.contiguous(), c, 254)
    assert np.array_equal(got_t.numpy(), want_t)
    # the digits recompose every scalar
    ints = fr.to_ints(s)
    for i in range(len(ints)):
        assert sum(int(d) << (c * w) for w, d in enumerate(want[:, i])) == ints[i]


def test_precompute_shift_matches_jax():
    for nbits, c, nu in [(254, 11, 2), (254, 6, 4), (253, 8, 3)]:
        assert TM.precompute_shift(nbits, c, nu) == JM.precompute_shift(nbits, c, nu)


@pytest.mark.parametrize("n,T,c", [(64, 16, 6), (96, 32, 5), (128, 128, 0)])
def test_msm_tpu3_vs_oracle(n, T, c):
    pts, scalars = _setup(n, n)
    got = TM3.msm_tpu3("bn254", *_tensors(scalars, pts), c=c or None, T=T)
    assert got == _want(scalars, pts)
