"""The port's MSM entry points on the CPU: `msm_tpu3` on the skewed and
degenerate cases of tests/test_msm_tpu3.py against the python-int oracle
tests/ec_ref.py, and `msm_affine`'s dispatch and refusals. Tolerance: exact
equality."""

import numpy as np
import pytest
import torch

from icicle_tpu.curves.params import get_curve as jcurve
from icicle_tpu_torch import MSMConfig, msm_affine
from icicle_tpu_torch.kernels import ec_reduce as TR
from icicle_tpu_torch.kernels import msm_scan as TS
from icicle_tpu_torch.ops import msm_tpu3 as TM3
from icicle_tpu_torch.runtime import dispatcher
from icicle_tpu_torch.runtime.errors import IcicleException
from tests.ec_ref import INF, ec_mul, msm_ref

# The tier-1 run puts six pytest workers on the same cores; torch's intra-op
# threads then oversubscribe them and these small-tensor ops run ~10x slower.
torch.set_num_threads(1)

MOD = jcurve("bn254").fq.modulus
R = jcurve("bn254").fr.modulus


def _points(n, seed):
    c = jcurve("bn254")
    rng = np.random.default_rng(seed)
    return [ec_mul((c.gen_x, c.gen_y), int(k), MOD) for k in rng.integers(1, 1 << 28, size=n)]


def _tensors(scalars, pts):
    c = jcurve("bn254")
    as_t = lambda a: torch.from_numpy(np.array(a, dtype=np.uint32).view(np.int32))
    return (as_t(c.fr.from_ints(scalars)), as_t(c.fq.from_ints([p[0] for p in pts])),
            as_t(c.fq.from_ints([p[1] for p in pts])))


def _want(scalars, pts):
    w = msm_ref(scalars, pts, MOD)
    return w if w is not INF else (0, 0)


def test_unaligned_and_zeros():
    # n not a multiple of the tile, half the scalars zero, tiny values
    pts = _points(56, 7)
    rng = np.random.default_rng(8)
    scalars = [0] * 28 + [int(s) for s in rng.integers(0, 1 << 16, size=28)]
    assert TM3.msm_tpu3("bn254", *_tensors(scalars, pts), c=6, T=16) == _want(scalars, pts)


def test_skewed_same_digit():
    # every scalar identical -> one bucket takes all points (worst skew)
    pts = _points(32, 9)
    scalars = [(13 << 12) | 5] * 32
    assert TM3.msm_tpu3("bn254", *_tensors(scalars, pts), c=5, T=16) == _want(scalars, pts)


def test_repeated_point_and_all_zero():
    # the bench shape: one point repeated (maximal bucket collisions)
    P = ec_mul((jcurve("bn254").gen_x, jcurve("bn254").gen_y), 0xDEADBEEF, MOD)
    rng = np.random.default_rng(11)
    scalars = [int(s) for s in rng.integers(0, 1 << 62, size=48)]
    s, x, y = _tensors(scalars, [P] * 48)
    prepared = TM3.msm_tpu3_prepare("bn254", x, y, c=6, T=16)
    assert TM3.msm_tpu3("bn254", s, prepared=prepared) == ec_mul(P, sum(scalars) % R, MOD)
    # all-zero scalars over the same prepared bases: the identity, (0, 0)
    assert TM3.msm_tpu3("bn254", torch.zeros_like(s), prepared=prepared) == (0, 0)


def test_msm_affine_dispatch_on_cpu():
    pts = _points(24, 13)
    scalars = [int(v) for v in np.random.default_rng(14).integers(0, 1 << 40, size=24)]
    args = _tensors(scalars, pts)
    TS.prefix_scan.launches = TR.ec_reduce.launches = 0
    assert msm_affine("bn254", *args, MSMConfig(c=11)) == _want(scalars, pts)
    assert TS.prefix_scan.launches == 0 and TR.ec_reduce.launches == 0
    # "auto" on a CPU tensor is the "torch" backend: the plain versions
    for backend in (None, "auto"):
        assert dispatcher.dispatch("msm", backend, args[0]) is \
            dispatcher.dispatch("msm", "torch", args[0])
    assert dispatcher.dispatch("msm", "cuda", args[0]) is not \
        dispatcher.dispatch("msm", "torch", args[0])


@pytest.mark.parametrize("cfg,match", [
    (MSMConfig(g2=True), "G2"),
    (MSMConfig(are_scalars_montgomery_form=True), "Montgomery"),
    (MSMConfig(are_points_montgomery_form=True), "Montgomery"),
    (MSMConfig(precompute_factor=2, c=6), "precompute_factor"),
    (MSMConfig(batch_size=2), "batch"),
    (MSMConfig(are_points_shared_in_batch=False), "batch"),
    (MSMConfig(bitsize=64), "bitsize 64"),
])
def test_msm_affine_unported_configurations_raise(cfg, match):
    args = _tensors([1, 2], _points(2, 15))
    with pytest.raises(NotImplementedError, match=f"(?s){match}.*queue A item 6"):
        msm_affine("bn254", *args, cfg)


def test_batch_axis_and_other_refusals():
    s, x, y = _tensors([1, 2], _points(2, 16))
    with pytest.raises(NotImplementedError, match="queue A item 6"):
        msm_affine("bn254", s[None], x, y)
    # the "r12" engine runs (tests/test_torch_msm_r12.py); one the port does
    # not have raises, and so does an engine other than the prepared one's
    with pytest.raises(IcicleException, match="unknown engine"):
        TM3.msm_tpu3("bn254", s, x, y, engine="r13")
    prepared = TM3.msm_tpu3_prepare("bn254", x, y, c=6, T=16)
    with pytest.raises(IcicleException, match="prepared for 'u32'"):
        TM3.msm_tpu3("bn254", s, prepared=prepared, engine="r12")
    with pytest.raises(NotImplementedError, match="queue A item 6"):
        TM3.msm_tpu3("bn254", s, prepared=prepared, precompute_factor=2)
    with pytest.raises(NotImplementedError, match="queue A item 6"):
        TM3.msm_tpu3_prepare("bn254", x, y, c=6, precompute_factor=2)
    with pytest.raises(IcicleException, match="CUDA tensors"):
        TM3.msm_tpu3("bn254", s, x, y, backend="cuda")
    with pytest.raises(IcicleException, match="no cuda backend|has no"):
        msm_affine("bn254", s, x, y, MSMConfig(backend="pallas"))
    with pytest.raises(IcicleException, match="uint32"):
        msm_affine("bn254", np.zeros((2, 8), np.int64), x, y)
