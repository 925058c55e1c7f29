"""G2 (icicle_tpu_torch/curves/group.py with g2=True) against the JAX
package: the group's constants, `padd`, `pmadd` and `dbl` as projective
limbs on all four curves, and the plain versions of the MSM kernels over
G2 (B3 `prefix_scan_ref`, B4 `ec_reduce_ref`, `precompute_bases_ref`)
against JAX G2 group ops applied in the same order, limb for limb
(integers: the tolerance is 0).

JAX compiles a G2 group op for 13-18 s on the CPU (12-limb Fp2 longer), so
the jitted JAX side runs at bn254, at one batch shape whose compiled ops
every test here shares; bls12_377, bls12_381 and bw6_761 are held to `RCB`,
a Python-int model of the JAX formulas in Montgomery form, which the bn254
tests hold to JAX itself, and to JAX's formulas run op by op in
tests/test_torch_g2_jax.py."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icicle_tpu.curves import group as jgroup
from icicle_tpu_torch.curves import host_ec
from icicle_tpu_torch.curves.group import Affine, Projective, get_group
from icicle_tpu_torch.kernels import ec_reduce as TR
from icicle_tpu_torch.kernels import msm_scan as TS
from icicle_tpu_torch.kernels import precompute_kernel as PB
from icicle_tpu_torch.runtime import device

CURVES = ["bn254", "bls12_377", "bls12_381", "bw6_761"]
BATCH = 2          # the one batch shape of the JAX calls


@pytest.fixture(autouse=True)
def on_cpu(monkeypatch):
    monkeypatch.setattr(device, "_device", torch.device("cpu"))


class RCB:
    """RCB15 Algs 7-9 (a = 0) on Montgomery-form Python ints over the
    group's coordinate field, as icicle_tpu/curves/group.py writes them:
    an element is an int, or (c0, c1) over Fp2."""

    def __init__(self, g):
        self.g, self.p = g, g.curve.fq.modulus
        self.rinv = pow(1 << (32 * g.base_limbs), -1, self.p)
        self.nr = g.coord_field.engine.w if g.degree == 2 else None
        self.b3 = g.b3_int

    def add(self, a, b):
        if self.nr is None:
            return (a + b) % self.p
        return tuple((x + y) % self.p for x, y in zip(a, b))

    def sub(self, a, b):
        if self.nr is None:
            return (a - b) % self.p
        return tuple((x - y) % self.p for x, y in zip(a, b))

    def m(self, a, b):
        p, r = self.p, self.rinv
        if self.nr is None:
            return a * b * r % p
        return ((a[0] * b[0] + self.nr * a[1] * b[1]) * r % p, (a[0] * b[1] + a[1] * b[0]) * r % p)

    def padd(self, P, Q):
        m, add, sub = self.m, self.add, self.sub
        (x1, y1, z1), (x2, y2, z2) = P, Q
        t0, t1, t2 = m(x1, x2), m(y1, y2), m(z1, z2)
        t3 = sub(m(add(x1, y1), add(x2, y2)), add(t0, t1))
        t4 = sub(m(add(y1, z1), add(y2, z2)), add(t1, t2))
        y3 = sub(m(add(x1, z1), add(x2, z2)), add(t0, t2))
        t0 = add(add(t0, t0), t0)
        t2 = m(self.b3, t2)
        return self._finish(t0, t1, t2, t3, t4, y3)

    def madd(self, P, A):
        m, add, sub = self.m, self.add, self.sub
        (x1, y1, z1), (x2, y2) = P, A
        t0, t1 = m(x1, x2), m(y1, y2)
        t3 = sub(m(add(x1, y1), add(x2, y2)), add(t0, t1))
        t4 = add(m(y2, z1), y1)
        y3 = add(m(x2, z1), x1)
        t0 = add(add(t0, t0), t0)
        t2 = m(self.b3, z1)
        return self._finish(t0, t1, t2, t3, t4, y3)

    def _finish(self, t0, t1, t2, t3, t4, y3):
        m, add, sub = self.m, self.add, self.sub
        z3 = add(t1, t2)
        t1 = sub(t1, t2)
        y3 = m(self.b3, y3)
        return (sub(m(t3, t1), m(t4, y3)), add(m(t1, z3), m(y3, t0)), add(m(z3, t4), m(t0, t3)))

    def dbl(self, P):
        m, add, sub = self.m, self.add, self.sub
        x, y, z = P
        t0 = m(y, y)
        z3 = add(t0, t0)
        z3 = add(z3, z3)
        z3 = add(z3, z3)
        t1 = m(y, z)
        t2 = m(self.b3, m(z, z))
        x3 = m(t2, z3)
        y3 = add(t0, t2)
        z3 = m(t1, z3)
        t1 = add(t2, t2)
        t2 = add(t1, t2)
        t0 = sub(t0, t2)
        y3 = add(m(t0, y3), x3)
        x3 = m(t0, m(x, y))
        return (add(x3, x3), y3, z3)


def ints(g, t: torch.Tensor) -> list:
    """(..., W) coordinate tensor -> flat list of ints / (c0, c1) pairs."""
    v = g.coord_field.to_ints(t)
    if g.degree == 2:
        return [tuple(int(c) for c in row) for row in v.reshape(-1, 2)]
    return [int(c) for c in v.reshape(-1)]


def points(g, P: Projective) -> list:
    return list(zip(*(ints(g, c) for c in P)))


@functools.lru_cache(maxsize=None)
def pool(cname: str, count: int = 6):
    """count points k_i Q (k_i = 3 + 5 i), Q the G2 generator: Montgomery
    affine tensors (x, y) of the port and the host's affine ints."""
    g = get_group(cname, g2=True)
    p = g.curve.params
    Q = (p.g2_gen_x, p.g2_gen_y) if g.degree == 2 else (p.g2_gen_x[0], p.g2_gen_y[0])
    pts = [host_ec.scalar_mul(g, Q, 3 + 5 * i) for i in range(count)]
    f = g.coord_field
    x, y = f.from_ints([q[0] for q in pts], "cpu"), f.from_ints([q[1] for q in pts], "cpu")
    return f.to_mont(x), f.to_mont(y), pts


def projective(g, cname: str, idx) -> Projective:
    """Projective points with Z != 1: pool points idx[0] + idx[1] by madd."""
    xm, ym, _ = pool(cname)
    one = g.one_mont("cpu").expand(len(idx[0]), g.nlimbs)
    return g.madd(Projective(xm[idx[0]], ym[idx[0]], one), Affine(xm[idx[1]], ym[idx[1]]))


def jax_group():
    return jgroup.get_group("bn254", g2=True)


def to_jax(t: torch.Tensor):
    return jnp.asarray(t.numpy().view(np.uint32))


def same(jp, tp) -> None:
    for a, b in zip(jp, tp):
        assert np.array_equal(np.asarray(a).view(np.int32), b.numpy())


@pytest.mark.parametrize("cname", CURVES)
def test_g2_constants_match_jax(cname):
    jg, tg = jgroup.get_group(cname, g2=True), get_group(cname, g2=True)
    assert (tg.nlimbs, tg.degree) == (jg.nlimbs, 2 if cname != "bw6_761" else 1)
    for j, t in ((jg.b3_mont, tg.b3_mont("cpu")), (jg.one_mont, tg.one_mont("cpu")),
                 (jg.gen_mont.x, tg.generator((), "cpu").x),
                 (jg.gen_mont.y, tg.generator((), "cpu").y)):
        assert np.array_equal(np.asarray(j).view(np.int32), t.numpy())
    assert get_group(cname, True) is tg and get_group(cname) is not tg


@pytest.mark.parametrize("cname", CURVES)
def test_g2_ops_match_the_jax_formulas(cname):
    """padd, pmadd and dbl as projective limbs equal RCB's, and the affine
    results the host's affine group law."""
    g = get_group(cname, g2=True)
    model = RCB(g)
    P = projective(g, cname, ([0, 1, 2], [3, 4, 5]))
    Q = projective(g, cname, ([5, 1, 0], [2, 2, 4]))
    xm, ym, pts = pool(cname)
    A = Affine(xm[[1, 3, 3]], ym[[1, 3, 3]])
    mp, mq = points(g, P), points(g, Q)
    assert points(g, g.add(P, Q)) == [model.padd(a, b) for a, b in zip(mp, mq)]
    assert points(g, g.add(P, P)) == [model.padd(a, a) for a in mp]
    assert points(g, g.dbl(P)) == [model.dbl(a) for a in mp]
    assert points(g, g.madd(P, A)) == [model.madd(a, b) for a, b in
                                       zip(mp, zip(ints(g, A.x), ints(g, A.y)))]
    # identity handling: P + O and O + A
    O = g.identity((3,), "cpu")
    assert points(g, g.add(P, O)) == [model.padd(a, o) for a, o in zip(mp, points(g, O))]
    # the affine value: 2 (k0 Q + k3 Q) = 2 (3 + 18) Q
    add, dbl, _, _ = host_ec.host_ops(g)
    x, y = g.to_affine_canonical(Projective(*(c[:1] for c in g.dbl(P))))
    want = dbl(add(pts[0], pts[3]))
    assert (ints(g, x)[0], ints(g, y)[0]) == want


def test_g2_ops_and_rcb_match_jax_bn254():
    """bn254's G2 padd, pmadd and dbl equal JAX's limb for limb (and so
    does RCB, which the other curves are held to)."""
    g = get_group("bn254", g2=True)
    jg = jax_group()
    model = RCB(g)
    P = projective(g, "bn254", ([0, 1], [2, 3]))
    Q = projective(g, "bn254", ([4, 5], [1, 0]))
    xm, ym, _ = pool("bn254")
    A = Affine(xm[[2, 5]], ym[[2, 5]])
    jP, jQ = (jgroup.Projective(*map(to_jax, t)) for t in (P, Q))
    same(jg.add(jP, jQ), g.add(P, Q))
    same(jg.dbl(jP), g.dbl(P))
    same(jg.madd(jP, jgroup.Affine(to_jax(A.x), to_jax(A.y))), g.madd(P, A))
    assert points(g, g.dbl(P)) == [model.dbl(a) for a in points(g, P)]


def test_plain_b3_b4_over_g2_match_jax_serial_order():
    """prefix_scan_ref and ec_reduce_ref over bn254 G2 at segments=1 equal
    JAX madd / add applied slot by slot from the identity; at the plan's
    segments the association differs and the points are the same."""
    g = get_group("bn254", g2=True)
    jg = jax_group()
    xm, ym, _ = pool("bn254")
    rng = np.random.default_rng(5)
    idx = torch.from_numpy(rng.integers(0, 6, size=(3, BATCH)))
    plimbs = torch.cat([xm[idx], ym[idx]], -1).transpose(1, 2).contiguous()  # (K, 2W, C)
    out = TS.prefix_scan_ref(g, plimbs, segments=1)
    e = jg.identity((BATCH,))
    for k in range(3):
        e = jg.madd(e, jgroup.Affine(to_jax(xm[idx[k]]), to_jax(ym[idx[k]])))
        same(e, torch.split(out[k].T, g.nlimbs, dim=-1))
    pts = torch.stack([torch.cat(list(projective(g, "bn254", (list(r), list(r[::-1])))), -1)
                       for r in rng.integers(0, 6, size=(3, BATCH))])      # (R, C, 3W)
    red = TR.ec_reduce_ref(g, pts.transpose(1, 2).contiguous(), segments=1)
    acc = jg.identity((BATCH,))
    for r in range(3):
        acc = jg.add(acc, jgroup.Projective(*map(to_jax, torch.split(pts[r], g.nlimbs, -1))))
    same(acc, torch.split(red.T, g.nlimbs, dim=-1))
    # the kernel's split association: other coordinates, the same points
    model = RCB(g)
    split = points(g, Projective(*torch.split(TR.ec_reduce_ref(
        g, pts.transpose(1, 2).contiguous(), segments=2).T, g.nlimbs, -1)))
    serial = points(g, Projective(*torch.split(red.T, g.nlimbs, -1)))
    for (x1, y1, z1), (x2, y2, z2) in zip(split, serial):
        assert model.m(x1, z2) == model.m(x2, z1) and model.m(y1, z2) == model.m(y2, z1)


def test_plain_precompute_over_g2_matches_jax():
    """precompute_bases_ref over bn254 G2 equals JAX's chain: from_affine,
    `shift` doublings a copy, to_affine_canonical; the identity stays (0, 0)."""
    g = get_group("bn254", g2=True)
    jg = jax_group()
    f = g.coord_field
    _, _, pts = pool("bn254")
    px = f.from_ints([pts[2][0], (0, 0)], "cpu")
    py = f.from_ints([pts[2][1], (0, 0)], "cpu")
    nu, shift = 3, 2
    ox, oy = PB.precompute_bases_ref(g, px, py, nu, shift)
    cur = jg.from_affine_canonical(to_jax(px), to_jax(py))
    for j in range(1, nu):
        for _ in range(shift):
            cur = jg.dbl(cur)
        jx, jy = jg.to_affine_canonical(cur)
        for i in range(BATCH):
            assert np.array_equal(np.asarray(jx[i]).view(np.int32), ox[nu * i + j].numpy())
            assert np.array_equal(np.asarray(jy[i]).view(np.int32), oy[nu * i + j].numpy())
    assert not bool(ox[nu:].any()) and not bool(oy[nu:].any())
