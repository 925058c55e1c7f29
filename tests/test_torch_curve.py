"""The port's curve layer (icicle_tpu_torch/curves: params, host_ec, group,
montgomery) against the JAX package's (icicle_tpu/curves) and the
python-int oracle tests/ec_ref.py, on the same inputs.

The group ops are the complete RCB15 formulas written line for line as the
JAX package's, so projective Montgomery limbs must be bit-equal, identity
operands, P + P and P + (-P) included. Tolerance: exact equality.
"""

import dataclasses

import numpy as np
import pytest
import torch

from icicle_tpu.curves import group as jgroup
from icicle_tpu.curves import montgomery as jmont
from icicle_tpu.curves import params as jparams
from icicle_tpu_torch.curves import group as tgroup
from icicle_tpu_torch.curves import host_ec
from icicle_tpu_torch.curves import montgomery as tmont
from icicle_tpu_torch.curves import params as tparams
from tests import ec_ref

# The tier-1 run puts six pytest workers on the same cores; torch's intra-op
# threads then oversubscribe them and these small-tensor ops run ~10x slower.
torch.set_num_threads(1)

CURVE = "bn254"
B = 16


def _np(t):
    return t.numpy().view(np.uint32)


def _t(arr):
    return torch.from_numpy(np.array(np.asarray(arr), dtype=np.uint32).view(np.int32))


def _points(seed: int, n: int):
    c = jparams.get_curve(CURVE)
    rng = np.random.default_rng(seed)
    gen = (c.gen_x, c.gen_y)
    return [ec_ref.ec_mul(gen, int(k), c.fq.modulus) for k in rng.integers(1, 1 << 40, size=n)]


def _affine_mont(pts):
    """Python-int affine points -> JAX Montgomery (x, y) uint32 arrays."""
    fq = jparams.get_curve(CURVE).fq
    x = fq.to_mont(fq.from_ints([p[0] for p in pts]))
    y = fq.to_mont(fq.from_ints([p[1] for p in pts]))
    return np.asarray(x), np.asarray(y)


def _projective_batch(seed: int):
    """(P, Q) JAX projective batches of B lanes with Z != 1 on most lanes and
    the special cases: identity + Q, P + identity, P + P, P + (-P),
    identity + identity."""
    jg = jgroup.get_group(CURVE)
    ax, ay = _affine_mont(_points(seed, B))
    bx, by = _affine_mont(_points(seed + 1, B))
    one = np.broadcast_to(np.asarray(jg.one_mont), ax.shape)
    P0 = jgroup.Projective(ax, ay, one)
    Q0 = jgroup.Projective(bx, by, one)
    P = [np.array(a) for a in jg.add(P0, Q0)]    # Z != 1
    Q = [np.array(a) for a in jg.dbl(Q0)]
    ident = [np.zeros_like(P[0][0]), np.asarray(jg.one_mont), np.zeros_like(P[0][0])]
    for i in range(3):
        P[i][10] = ident[i]                      # identity + Q
        Q[i][11] = ident[i]                      # P + identity
        Q[i][12] = P[i][12]                      # P + P
        Q[i][13] = P[i][13]                      # P + (-P)
        P[i][14] = Q[i][14] = ident[i]           # identity + identity
    Q[1][13] = np.asarray(jgroup.get_group(CURVE).f.neg(P[1][13]))
    return jgroup.Projective(*P), jgroup.Projective(*Q)


def _tproj(p):
    return tgroup.Projective(*(_t(a) for a in p))


def _assert_points_equal(got, want):
    for g, w in zip(got, want):
        assert np.array_equal(_np(g), np.asarray(w))


def test_padd_matches_jax():
    P, Q = _projective_batch(1)
    want = jgroup.get_group(CURVE).add(P, Q)
    _assert_points_equal(tgroup.get_group(CURVE).add(_tproj(P), _tproj(Q)), want)


def test_pmadd_matches_jax():
    jg = jgroup.get_group(CURVE)
    P, _ = _projective_batch(3)
    qx, qy = _affine_mont(_points(5, B))
    P = [np.array(a) for a in P]
    one = np.asarray(jg.one_mont)
    # lane 0: identity + q; lane 1: q + q; lane 2: (-q) + q
    P[0][0], P[1][0], P[2][0] = 0, one, 0
    P[0][1], P[1][1], P[2][1] = qx[1], qy[1], one
    P[0][2], P[1][2], P[2][2] = qx[2], np.asarray(jg.f.neg(qy[2])), one
    P = jgroup.Projective(*P)
    want = jg.madd(P, jgroup.Affine(qx, qy))
    got = tgroup.get_group(CURVE).madd(_tproj(P), tgroup.Affine(_t(qx), _t(qy)))
    _assert_points_equal(got, want)


def test_pdbl_and_neg_match_jax():
    jg = jgroup.get_group(CURVE)
    P, _ = _projective_batch(7)
    _assert_points_equal(tgroup.get_group(CURVE).dbl(_tproj(P)), jg.dbl(P))
    _assert_points_equal(tgroup.get_group(CURVE).neg(_tproj(P)), jg.neg(P))


def test_pselect_and_is_identity():
    P, Q = _projective_batch(9)
    tg = tgroup.get_group(CURVE)
    cond = torch.arange(B) % 2 == 0
    got = tgroup.pselect(cond, _tproj(P), _tproj(Q))
    want = jgroup.pselect(np.asarray(cond), P, Q)
    _assert_points_equal(got, want)
    assert tg.is_identity(_tproj(P)).tolist() == [i == 10 or i == 14 for i in range(B)]


def test_identity_and_generator_match_jax():
    jg, tg = jgroup.get_group(CURVE), tgroup.get_group(CURVE)
    _assert_points_equal(tg.identity((3,), "cpu"), jg.identity((3,)))
    _assert_points_equal(tg.generator((2,), "cpu"), jg.generator((2,)))


def test_affine_boundary_conversions():
    jg, tg = jgroup.get_group(CURVE), tgroup.get_group(CURVE)
    fq = jparams.get_curve(CURVE).fq
    pts = _points(11, 6)
    x = np.asarray(fq.from_ints([p[0] for p in pts] + [0]))
    y = np.asarray(fq.from_ints([p[1] for p in pts] + [0]))   # last lane: (0, 0)
    want = jg.from_affine_canonical(x, y)
    got = tg.from_affine_canonical(_t(x), _t(y))
    _assert_points_equal(got, want)
    P, _ = _projective_batch(13)
    wx, wy = jg.to_affine_canonical(P)
    gx, gy = tg.to_affine_canonical(_tproj(P))
    assert np.array_equal(_np(gx), np.asarray(wx)) and np.array_equal(_np(gy), np.asarray(wy))
    assert int(_np(gx)[14].any()) == 0 and int(_np(gy)[14].any()) == 0   # identity -> (0, 0)


def test_montgomery_converters_match_jax():
    fq = jparams.get_curve(CURVE).fq
    pts = _points(15, 4)
    x = np.asarray(fq.from_ints([p[0] for p in pts]))
    y = np.asarray(fq.from_ints([p[1] for p in pts]))
    for jfn, tfn in ((jmont.affine_to_montgomery, tmont.affine_to_montgomery),
                     (jmont.affine_from_montgomery, tmont.affine_from_montgomery)):
        for g, w in zip(tfn(CURVE, _t(x), _t(y)), jfn(CURVE, x, y)):
            assert np.array_equal(_np(g), np.asarray(w))
    P, _ = _projective_batch(17)
    for jfn, tfn in ((jmont.projective_to_montgomery, tmont.projective_to_montgomery),
                     (jmont.projective_from_montgomery, tmont.projective_from_montgomery)):
        _assert_points_equal(tfn(CURVE, _tproj(P)), jfn(CURVE, P))


def test_g2_raises_naming_roadmap():
    with pytest.raises(NotImplementedError, match="queue A item 7"):
        tgroup.get_group(CURVE, g2=True)
    with pytest.raises(NotImplementedError, match="queue A item 7"):
        tmont.affine_to_montgomery(CURVE, None, None, g2=True)


@pytest.mark.parametrize("name", jparams.curve_names())
def test_curve_table_matches_jax(name):
    jc, tc = jparams.get_curve(name), tparams.get_curve(name)
    assert dataclasses.asdict(tc.params) == dataclasses.asdict(jc.params)
    assert (tc.b, tc.b3, tc.gen_x, tc.gen_y, tc.scalar_bits) == \
        (jc.b, jc.b3, jc.gen_x, jc.gen_y, jc.scalar_bits)
    assert (tc.fq.name, tc.fr.name) == (jc.fq.name, jc.fr.name)
    mod = tc.fq.modulus
    assert (tc.gen_y ** 2 - tc.gen_x ** 3 - tc.b) % mod == 0
    assert tparams.curve_names() == jparams.curve_names()


def test_host_ec_matches_oracle():
    mod = jparams.get_curve(CURVE).fq.modulus
    P, Q = _points(19, 2)
    cases = [(P, Q), (P, P), (P, ec_ref.ec_neg(P, mod)), (None, Q), (P, None), (None, None)]
    for a, b in cases:
        assert host_ec.ec_add(a, b, mod) == ec_ref.ec_add(a, b, mod)
    assert host_ec.ec_dbl(P, mod) == ec_ref.ec_add(P, P, mod)
    assert host_ec.ec_neg(P, mod) == ec_ref.ec_neg(P, mod)
    assert host_ec.ec_neg(host_ec.INF, mod) is ec_ref.INF
    for k in (0, 1, 2, 12345, -7, (1 << 200) + 3):
        assert host_ec.ec_mul(P, k, mod) == ec_ref.ec_mul(P, k, mod)
