"""G2 over bls12_377, bls12_381 and bw6_761 against the JAX package's own
group formulas (icicle_tpu/curves/group.py `padd`, `pmadd`, `pdbl`), limb
for limb (integers: the tolerance is 0): the port's group ops, its plain
B3 / B4 / precompute_bases at 12 limbs over Fp2, and a G2 MSM whose oracle
is JAX's group law alone (no host_ec).

The JAX formulas run eagerly over the coordinate field's multiply, add and
subtract, each jitted on its own: a handful of small compiles a shape
(5-10 s a curve on the CPU), where a jitted G2 group op compiles for 13-18
s and longer at 12 limbs."""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icicle_tpu.curves import group as jgroup
from icicle_tpu_torch import MSMConfig, msm
from icicle_tpu_torch.curves.group import Affine, Projective, get_group
from icicle_tpu_torch.kernels import ec_reduce as TR
from icicle_tpu_torch.kernels import msm_scan as TS
from icicle_tpu_torch.kernels import precompute_kernel as PB
from icicle_tpu_torch.runtime import device
from tests.test_torch_g2 import pool, projective

LANES = 4          # the one batch shape of the JAX calls


@pytest.fixture(autouse=True)
def on_cpu(monkeypatch):
    monkeypatch.setattr(device, "_device", torch.device("cpu"))


@functools.lru_cache(maxsize=None)
def jax_ops(cname: str):
    """(JAX's G2 group, its field ops with multiply, add and subtract each
    jitted alone)."""
    jg = jgroup.get_group(cname, g2=True)
    f = jg.f
    return jg, types.SimpleNamespace(mul_mont=jax.jit(f.mul_mont), add=jax.jit(f.add),
                                     sub=jax.jit(f.sub))


def to_jax(t: torch.Tensor):
    return jnp.asarray(t.numpy().view(np.uint32))


def jproj(P: Projective):
    return jgroup.Projective(*map(to_jax, P))


def same(jp, tp) -> None:
    for a, b in zip(jp, tp):
        assert np.array_equal(np.asarray(a).view(np.int32), b.numpy())


def lanes(idx) -> list:
    return [i % 6 for i in idx]


@pytest.mark.parametrize("cname", ["bls12_377", "bls12_381", "bw6_761"])
def test_g2_ops_equal_jax_formulas(cname):
    """padd, pmadd and dbl as projective limbs equal JAX's, identities
    included; bls12_377's b3 is a general Fp2 constant (0, 3b)."""
    g = get_group(cname, g2=True)
    jg, f = jax_ops(cname)
    b3 = jg.b3_mont
    P = projective(g, cname, (lanes(range(LANES)), lanes(range(3, 3 + LANES))))
    Q = projective(g, cname, (lanes(range(5, 5 + LANES)), lanes(range(2, 2 + LANES))))
    Q = Projective(*(torch.cat([c[:1], o[1:2], c[2:]]) for c, o in
                     zip(Q, g.identity((LANES,), "cpu"))))          # lane 1: the identity
    xm, ym, _ = pool(cname)
    A = Affine(xm[[1, 3, 3, 0]], ym[[1, 3, 3, 0]])
    same(jgroup.padd(f, jproj(P), jproj(Q), b3), g.add(P, Q))
    same(jgroup.padd(f, jproj(P), jproj(P), b3), g.add(P, P))
    same(jgroup.pdbl(f, jproj(P), b3), g.dbl(P))
    same(jgroup.pdbl(f, jproj(Q), b3), g.dbl(Q))
    same(jgroup.pmadd(f, jproj(Q), jgroup.Affine(to_jax(A.x), to_jax(A.y)), b3), g.madd(Q, A))


def test_plain_b3_b4_precompute_over_12_limb_fp2_equal_jax():
    """bls12_377 G2 (12-limb Fp2, the general b3): prefix_scan_ref and
    ec_reduce_ref at segments=1 equal JAX pmadd / padd applied slot by slot
    from the identity, and precompute_bases_ref's copies equal JAX's
    doubling chain as points (x Z = X, y Z = Y over Fp2)."""
    cname = "bls12_377"
    g = get_group(cname, g2=True)
    jg, f = jax_ops(cname)
    b3 = jg.b3_mont
    xm, ym, pts = pool(cname)
    rng = np.random.default_rng(15)
    idx = torch.from_numpy(rng.integers(0, 6, size=(3, LANES)))
    plimbs = torch.cat([xm[idx], ym[idx]], -1).transpose(1, 2).contiguous()  # (K, 2W, C)
    out = TS.prefix_scan_ref(g, plimbs, segments=1)
    e = jproj(g.identity((LANES,), "cpu"))
    for k in range(3):
        e = jgroup.pmadd(f, e, jgroup.Affine(to_jax(xm[idx[k]]), to_jax(ym[idx[k]])), b3)
        same(e, torch.split(out[k].T, g.nlimbs, dim=-1))
    rows = [torch.cat(list(projective(g, cname, (lanes(r), lanes(r[::-1])))), -1)
            for r in rng.integers(0, 6, size=(3, LANES))]
    rows[1][2] = torch.cat(list(g.identity((), "cpu")))              # an identity slot
    red = TR.ec_reduce_ref(g, torch.stack(rows).transpose(1, 2).contiguous(), segments=1)
    acc = jproj(g.identity((LANES,), "cpu"))
    for r in rows:
        acc = jgroup.padd(f, acc, jproj(Projective(*torch.split(r, g.nlimbs, -1))), b3)
    same(acc, torch.split(red.T, g.nlimbs, dim=-1))

    fc = g.coord_field
    nu, shift = 3, 2
    px = fc.from_ints([pts[i][0] for i in range(LANES)], "cpu")
    py = fc.from_ints([pts[i][1] for i in range(LANES)], "cpu")
    ox, oy = PB.precompute_bases_ref(g, px, py, nu, shift)
    cur = jproj(Projective(fc.to_mont(px), fc.to_mont(py), g.one_mont("cpu").expand(LANES, -1)))
    for j in range(1, nu):
        for _ in range(shift):
            cur = jgroup.pdbl(f, cur, b3)
        X, Y, Z = (torch.from_numpy(np.array(c).view(np.int32)) for c in cur)
        ax, ay = fc.to_mont(ox[j::nu].contiguous()), fc.to_mont(oy[j::nu].contiguous())
        assert torch.equal(g.f.mul_mont(ax, Z), X) and torch.equal(g.f.mul_mont(ay, Z), Y)


def test_g2_msm_equals_jax_group_law_fold():
    """msm(g2=True) over 4 bls12_377 G2 points equals sum s_i P_i computed
    by JAX's formulas alone: double-and-add over the 4 lanes (pdbl, then
    pmadd where the scalar's bit is set), the lanes then folded by padd;
    compared as projective points over Fp2."""
    cname = "bls12_377"
    g = get_group(cname, g2=True)
    jg, f = jax_ops(cname)
    b3 = jg.b3_mont
    xm, ym, pts = pool(cname)
    fr = g.curve.fr
    rng = np.random.default_rng(16)
    scalars = [int.from_bytes(rng.bytes(40), "little") % fr.modulus for _ in range(LANES)]
    fc = g.coord_field
    px = fc.from_ints([pts[i][0] for i in range(LANES)], "cpu")
    py = fc.from_ints([pts[i][1] for i in range(LANES)], "cpu")
    got = msm(cname, fr.from_ints(scalars, "cpu"), px, py, MSMConfig(g2=True, c=8))

    A = jgroup.Affine(to_jax(xm[:LANES]), to_jax(ym[:LANES]))
    acc = jproj(g.identity((LANES,), "cpu"))
    for bit in reversed(range(fr.modulus.bit_length())):
        acc = jgroup.pdbl(f, acc, b3)
        added = jgroup.pmadd(f, acc, A, b3)
        take = jnp.asarray([[(s >> bit) & 1] for s in scalars], dtype=bool)
        acc = jgroup.Projective(*(jnp.where(take, a, c) for a, c in zip(added, acc)))
    for step in (2, 1):            # lane 0: (P0 + P2) + (P3 + P1), at the one batch shape
        acc = jgroup.padd(f, acc, jgroup.Projective(*(jnp.roll(c, step, 0) for c in acc)), b3)
    total = Projective(*(torch.from_numpy(np.array(c[0]).view(np.int32)) for c in acc))
    m = g.f.mul_mont
    assert not bool(total.z.eq(0).all())
    assert torch.equal(m(got.x, total.z), m(total.x, got.z))
    assert torch.equal(m(got.y, total.z), m(total.y, got.z))
