"""The port's MSM entry points on the CPU: `msm_tpu3` on the skewed and
degenerate cases of tests/test_msm_tpu3.py against the python-int oracle
tests/ec_ref.py, `msm_affine`'s dispatch, the configurations its generic
msm() serves (formerly refused) and its refusals. Tolerance: exact
equality."""

import numpy as np
import pytest
import torch

from icicle_tpu.curves.params import get_curve as jcurve
from icicle_tpu_torch import MSMConfig, msm_affine
from icicle_tpu_torch.curves import host_ec
from icicle_tpu_torch.curves.group import get_group
from icicle_tpu_torch.ops.msm import msm_precompute_bases
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
    (MSMConfig(are_scalars_montgomery_form=True, c=6), "Montgomery"),
    (MSMConfig(are_points_montgomery_form=True, c=6), "Montgomery"),
    (MSMConfig(precompute_factor=2, c=6), "precompute_factor"),
    (MSMConfig(batch_size=2, c=6), "batch"),
    (MSMConfig(are_points_shared_in_batch=False, c=6), "batch"),
    (MSMConfig(bitsize=64, c=6), "bitsize 64"),
])
def test_msm_affine_unported_configurations_raise(cfg, match):
    """The seven configurations the port refused before its generic msm()
    and its extension fields all run and equal the oracle: G2 over Fp2
    (8 multiples of bn254's G2 generator, the host's Fp2 oracle) and the
    six G1 ones. A batch (batch_size 2 over
    flat scalars; unshared points over a (2, N) batch) gives one point an
    element, unshared elements on their own rows."""
    c = jcurve("bn254")
    pts = _points(8, 15)
    rng = np.random.default_rng(16)
    bits = 64 if cfg.bitsize else 250
    scalars = [int(v) for v in rng.integers(0, 1 << 62, size=8)]
    scalars = [(v << (bits - 62)) + 3 for v in scalars]
    s, x, y = _tensors(scalars, pts)
    if cfg.g2:
        g = get_group("bn254", g2=True)
        gen = (c.params.g2_gen_x, c.params.g2_gen_y)
        qs = [host_ec.scalar_mul(g, gen, 3 + 2 * i) for i in range(8)]
        want = host_ec.INF
        for k, q in zip(scalars, qs):
            want = host_ec.ec2_add(want, host_ec.scalar_mul(g, q, k), c.fq.modulus, -1)
        x, y = (g.coord_field.from_ints([q[i] for q in qs], "cpu") for i in (0, 1))
        assert msm_affine("bn254", s, x, y, cfg) == want
        return
    want = _want(scalars, pts)
    if cfg.are_scalars_montgomery_form:
        s = torch.from_numpy(np.array(c.fr.to_mont(c.fr.from_ints(scalars)),
                                      dtype=np.uint32).view(np.int32))
    if cfg.are_points_montgomery_form:
        x, y = (torch.from_numpy(np.array(c.fq.to_mont(c.fq.from_ints([p[i] for p in pts])),
                                          dtype=np.uint32).view(np.int32)) for i in (0, 1))
    if cfg.precompute_factor > 1:
        x, y = msm_precompute_bases("bn254", x, y, cfg)
    if cfg.batch_size > 1:          # (2 N) flat scalars over N shared points
        x, y = x[:4], y[:4]
        want = [_want(scalars[:4], pts[:4]), _want(scalars[4:], pts[:4])]
    if not cfg.are_points_shared_in_batch:   # a (2, N) batch, element i on rows iN..(i+1)N
        s = s.view(2, 4, 8)
        want = [_want(scalars[:4], pts[:4]), _want(scalars[4:], pts[4:])]
    assert msm_affine("bn254", s, x, y, cfg) == want


def test_batch_axis_and_other_refusals():
    s, x, y = _tensors([1, 2], _points(2, 16))
    # a batch axis runs the generic msm(): one point an element
    assert msm_affine("bn254", s[None], x, y) == [_want([1, 2], _points(2, 16))]
    # the "r12" engine runs (tests/test_torch_msm_r12.py); one the port does
    # not have raises, and so does an engine other than the prepared one's
    with pytest.raises(IcicleException, match="unknown engine"):
        TM3.msm_tpu3("bn254", s, x, y, engine="r13")
    prepared = TM3.msm_tpu3_prepare("bn254", x, y, c=6, T=16)
    with pytest.raises(IcicleException, match="prepared for 'u32'"):
        TM3.msm_tpu3("bn254", s, prepared=prepared, engine="r12")
    # bases prepared without precompute_factor do not serve one, and
    # precomputed bases prepare with their factor
    with pytest.raises(IcicleException, match="prepared with"):
        TM3.msm_tpu3("bn254", s, prepared=prepared, precompute_factor=2)
    assert TM3.msm_tpu3_prepare("bn254", x, y, c=6, precompute_factor=2)["nu"] == 2
    with pytest.raises(IcicleException, match="CUDA tensors"):
        TM3.msm_tpu3("bn254", s, x, y, backend="cuda")
    with pytest.raises(IcicleException, match="no cuda backend|has no"):
        msm_affine("bn254", s, x, y, MSMConfig(backend="pallas"))
    with pytest.raises(IcicleException, match="uint32"):
        msm_affine("bn254", np.zeros((2, 8), np.int64), x, y)
