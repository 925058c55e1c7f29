"""G2 MSMs (`msm`, `msm_affine` and `msm_precompute_bases` with
MSMConfig(g2=True)) on the CPU: over Fp2 for bn254 and bls12_377 and over
Fq for bw6_761, equal to the host's Python-int oracle (the affine point the
JAX package's `msm(..., MSMConfig(g2=True))` returns; tests/test_g2.py
holds JAX to the same oracle), and, slow-marked, to JAX itself: JAX's G2
`msm()` compiles for minutes on the CPU (tests/test_g2.py's bn254 case
takes about 7)."""

import numpy as np
import pytest
import torch

from icicle_tpu_torch import MSMConfig, msm, msm_affine, msm_precompute_bases
from icicle_tpu_torch.curves import host_ec
from icicle_tpu_torch.curves.group import get_group
from icicle_tpu_torch.ops import msm as msm_mod
from icicle_tpu_torch.ops.msm import default_c, precompute_shift
from icicle_tpu_torch.runtime import device
from icicle_tpu_torch.runtime.errors import IcicleException

C = 8   # window bits: 33 windows, a few window groups at these sizes


@pytest.fixture(autouse=True)
def on_cpu(monkeypatch):
    monkeypatch.setattr(device, "_device", torch.device("cpu"))


def generator(g):
    p = g.curve.params
    return (p.g2_gen_x, p.g2_gen_y) if g.degree == 2 else (p.g2_gen_x[0], p.g2_gen_y[0])


def inputs(cname: str, n: int, seed: int):
    """n points k_i Q (k_i = 3 + 4 i) as canonical tensors, n scalars below
    r from the seed, and the host's answer sum_i s_i k_i Q."""
    g = get_group(cname, g2=True)
    f, fr = g.coord_field, g.curve.fr
    pts = [host_ec.scalar_mul(g, generator(g), 3 + 4 * i) for i in range(n)]
    rng = np.random.default_rng(seed)
    scalars = [int.from_bytes(rng.bytes(40), "little") % fr.modulus for _ in range(n)]
    total = sum(s * (3 + 4 * i) for i, s in enumerate(scalars)) % fr.modulus
    want = host_ec.scalar_mul(g, generator(g), total) or host_ec.host_ops(g)[3]
    x = f.from_ints([q[0] for q in pts], "cpu")
    y = f.from_ints([q[1] for q in pts], "cpu")
    return g, fr.from_ints(scalars, "cpu"), x, y, scalars, pts, want


def affine(g, P):
    x, y = g.to_affine_canonical(P)
    read = (lambda v: tuple(int(c) for c in v)) if g.degree == 2 else int
    return read(g.coord_field.to_ints(x)), read(g.coord_field.to_ints(y))


@pytest.mark.parametrize("cname", ["bn254", "bls12_377", "bw6_761"])
def test_g2_msm_affine_matches_the_oracle(cname):
    g, s, x, y, _, _, want = inputs(cname, 4, 7)
    assert msm_affine(cname, s, x, y, MSMConfig(g2=True, c=C)) == want


def test_g2_msm_returns_montgomery_projective():
    """msm() returns (x R, y R, R) over Fp2, which reads back as the oracle's
    point; Montgomery-form points give the same result."""
    g, s, x, y, _, _, want = inputs("bn254", 4, 8)
    P = msm("bn254", s, x, y, MSMConfig(g2=True, c=C))
    assert P.x.shape == (16,) and affine(g, P) == want
    assert torch.equal(P.z, g.one_mont("cpu"))
    f = g.coord_field
    got = msm_affine("bn254", s, f.to_mont(x), f.to_mont(y),
                     MSMConfig(g2=True, c=C, are_points_montgomery_form=True))
    assert got == want


def test_g2_shared_batch_matches_the_oracle():
    g, s, x, y, scalars, pts, _ = inputs("bn254", 4, 9)
    s2 = torch.stack([s, s.flip(0)])
    got = msm_affine("bn254", s2, x, y, MSMConfig(g2=True, c=C))
    fr = g.curve.fr.modulus
    for b, order in enumerate((scalars, scalars[::-1])):
        total = sum(v * (3 + 4 * i) for i, v in enumerate(order)) % fr
        assert got[b] == host_ec.scalar_mul(g, generator(g), total)


def test_g2_precompute_bases_and_their_msm():
    """msm_precompute_bases over G2: row nu i + j is 2^(j shift) P_i by the
    host's doublings, the identity stays ((0, 0), (0, 0)); the MSM over the
    copies with the same c equals the oracle."""
    g, s, x, y, _, pts, want = inputs("bn254", 4, 10)
    nu = 2
    cfg = MSMConfig(g2=True, c=C, precompute_factor=nu)
    bx, by = msm_precompute_bases("bn254", x, y, cfg)
    assert bx.shape == (nu * 4, 16)
    shift = precompute_shift(g.curve.fr.modulus.bit_length(), C, nu)
    _, dbl, _, _ = host_ec.host_ops(g)
    f = g.coord_field
    got = list(zip(map(tuple, f.to_ints(bx).tolist()), map(tuple, f.to_ints(by).tolist())))
    for i, P in enumerate(pts):
        assert got[nu * i] == P
        for _ in range(shift):
            P = dbl(P)
        assert got[nu * i + 1] == P
    assert msm_affine("bn254", s, bx, by, cfg) == want
    zx = torch.zeros((1, 16), dtype=torch.int32)
    ox, oy = msm_precompute_bases("bn254", zx, zx, cfg)
    assert not bool(ox.any()) and not bool(oy.any())


def test_g2_default_window_is_capped(monkeypatch):
    """With cfg.c = 0, G2 takes default_c: the closed form, at most
    G2_MAX_C (11 where the closed form says 16 at 2^22); G1 keeps the
    closed form. msm_precompute_bases and msm() take the same default, so
    bases made without c serve an MSM made without c."""
    assert default_c(1 << 22) == 16 and default_c(1 << 22, g2=True) == msm_mod.G2_MAX_C == 11
    assert default_c(1 << 12, g2=True) == default_c(1 << 12) == 8
    # the closed form's 16 capped at 6 (a cap the CPU runs quickly), at 4 points
    monkeypatch.setattr(msm_mod, "_auto_c", lambda n: 16)
    monkeypatch.setattr(msm_mod, "G2_MAX_C", 6)
    g, s, x, y, _, _, want = inputs("bn254", 4, 14)
    cfg = MSMConfig(g2=True, precompute_factor=2)
    bx, by = msm_precompute_bases("bn254", x, y, cfg)
    ex, ey = msm_precompute_bases("bn254", x, y, MSMConfig(g2=True, precompute_factor=2, c=6))
    assert torch.equal(bx, ex) and torch.equal(by, ey)
    seen = []
    plan = msm_mod.generic_plan
    monkeypatch.setattr(msm_mod, "generic_plan", lambda *a, **k: seen.append(a[2]) or plan(*a, **k))
    assert msm_affine("bn254", s, bx, by, cfg) == want and seen == [6]


def test_g2_refuses_what_it_cannot_take():
    _, _, x, y, _, _, _ = inputs("bn254", 2, 11)
    from icicle_tpu_torch.ops.msm_tpu3 import msm_tpu3_prepare
    for kw in ({"engine": "r12"}, {"glv": True}):
        with pytest.raises(IcicleException, match="u32 engine and no glv"):
            msm_tpu3_prepare("bn254", x, y, c=C, g2=True, **kw)
    with pytest.raises(ValueError, match="no G2"):
        get_group("grumpkin", g2=True)


@pytest.mark.slow
@pytest.mark.parametrize("cname", ["bn254", "bls12_377", "bw6_761"])
def test_g2_msm_matches_jax_msm(cname):
    """The port's msm(g2=True) and msm_affine against JAX msm(...,
    MSMConfig(g2=True)): the same affine point (JAX's msm_affine returns
    the c0 parts alone, its `int(...[0])`; the port's both)."""
    import jax.numpy as jnp

    from icicle_tpu.curves.group import get_group as jgroup
    from icicle_tpu.ops.msm import MSMConfig as JCfg
    from icicle_tpu.ops.msm import _msm_affine_xla, msm as jmsm
    g, s, x, y, _, _, want = inputs(cname, 4, 12)
    js, jx, jy = (jnp.asarray(t.numpy().view(np.uint32)) for t in (s, x, y))
    jg = jgroup(cname, g2=True)
    jres = jmsm(cname, js, jx, jy, JCfg(g2=True, c=C))
    ax, ay = jg.to_affine_canonical(jres)
    tx, ty = g.to_affine_canonical(msm(cname, s, x, y, MSMConfig(g2=True, c=C)))
    assert np.array_equal(np.asarray(ax).view(np.int32), tx.numpy())
    assert np.array_equal(np.asarray(ay).view(np.int32), ty.numpy())
    got = msm_affine(cname, s, x, y, MSMConfig(g2=True, c=C))
    c0 = (lambda v: v[0]) if g.degree == 2 else (lambda v: v)
    assert _msm_affine_xla(cname, js, jx, jy, JCfg(g2=True, c=C)) == (c0(got[0]), c0(got[1]))
    assert got == want


@pytest.mark.slow
def test_g2_precompute_bases_matches_jax():
    import jax.numpy as jnp

    from icicle_tpu.ops.msm import MSMConfig as JCfg
    from icicle_tpu.ops.msm import msm_precompute_bases as jpre
    _, _, x, y, _, _, _ = inputs("bn254", 3, 13)
    jx, jy = (jnp.asarray(t.numpy().view(np.uint32)) for t in (x, y))
    want = jpre("bn254", jx, jy, JCfg(g2=True, c=C, precompute_factor=2))
    got = msm_precompute_bases("bn254", x, y, MSMConfig(g2=True, c=C, precompute_factor=2))
    for a, b in zip(want, got):
        assert np.array_equal(np.asarray(a).view(np.int32), b.numpy())
