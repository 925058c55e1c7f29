"""The generic MSM (icicle_tpu_torch/ops/msm.py `msm`) and msm_affine's
routes, on the CPU, against the python-int oracle (tests/ec_ref.py):
batches with shared and unshared points, Montgomery-form inputs, bitsize,
a precompute factor that is not a power of two, and the routing rules of
the JAX package's `_msm_affine_pallas`. msm() runs v3's stages
(ops/msm_tpu3.py `msm_stages`), here with the kernels' plain versions.

Where the port departs from the JAX package on purpose (ROADMAP.md §C):
unshared points give element i its own rows iN..(i+1)N, and a batched
msm_affine returns every element's point. A slow-marked test holds that
against JAX `msm()` itself, which compiles for minutes on the CPU.
Tolerance: exact equality."""

import numpy as np
import pytest
import torch

from icicle_tpu.curves.params import get_curve as jcurve
from icicle_tpu_torch import MSMConfig, msm_affine
from icicle_tpu_torch.curves.group import get_group
from icicle_tpu_torch.ops import msm as TM
from icicle_tpu_torch.ops import msm_tpu2 as TM2
from icicle_tpu_torch.ops import msm_tpu3 as TM3
from icicle_tpu_torch.runtime.errors import IcicleException
from tests.ec_ref import INF, ec_mul, msm_ref

# The tier-1 run puts six pytest workers on the same cores; torch's intra-op
# threads then oversubscribe them and these small-tensor ops run ~10x slower.
torch.set_num_threads(1)

CURVE = "bn254"
C = jcurve(CURVE)
MOD, R = C.fq.modulus, C.fr.modulus


def _i32(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.uint32).view(np.int32))


def _points(n, seed):
    rng = np.random.default_rng(seed)
    return [ec_mul((C.gen_x, C.gen_y), int(k), MOD) for k in rng.integers(1, 1 << 28, size=n)]


def _scalars(n, seed, bits=256):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(40), "little") % min(R, 1 << bits) for _ in range(n)]


def _xy(pts):
    return _i32(C.fq.from_ints([p[0] for p in pts])), _i32(C.fq.from_ints([p[1] for p in pts]))


def _s(scalars):
    return _i32(C.fr.from_ints(scalars))


def _want(scalars, pts):
    w = msm_ref(scalars, pts, MOD)
    return w if w is not INF else (0, 0)


def _affine(proj):
    x, y = get_group(CURVE).to_affine_canonical(proj)
    xs, ys = np.atleast_1d(C.fq.to_ints(x.numpy().view(np.uint32))), \
        np.atleast_1d(C.fq.to_ints(y.numpy().view(np.uint32)))
    return [(int(a), int(b)) for a, b in zip(xs, ys)]


def test_msm_returns_montgomery_projective_on_the_scalars_device():
    pts, scalars = _points(12, 1), _scalars(12, 2)
    res = TM.msm(CURVE, _s(scalars), *_xy(pts), MSMConfig(c=6))
    assert res.x.shape == (8,) and res.x.device.type == "cpu"
    assert _affine(res) == [_want(scalars, pts)]
    # lifted back as (x R, y R, R)
    one = get_group(CURVE).one_mont("cpu")
    assert torch.equal(res.z, one)
    zero = TM.msm(CURVE, _s([0] * 12), *_xy(pts), MSMConfig(c=6))
    assert not zero.x.any() and torch.equal(zero.y, one) and not zero.z.any()


def test_batch_with_shared_points():
    pts = _points(10, 3)
    batches = [_scalars(10, 10 + b) for b in range(3)]
    s = torch.stack([_s(b) for b in batches])
    res = TM.msm(CURVE, s, *_xy(pts), MSMConfig(c=6))
    assert res.x.shape == (3, 8)
    assert _affine(res) == [_want(b, pts) for b in batches]
    # msm_affine returns every element's point (the JAX package: element 0's only)
    assert msm_affine(CURVE, s, *_xy(pts), MSMConfig(c=6)) == [_want(b, pts) for b in batches]


def test_batch_with_unshared_points_takes_each_elements_own_rows():
    """are_points_shared_in_batch=False: (B N, L) points, element i the rows
    iN..(i+1)N (reference msm.h; the JAX package gives every element the
    first N)."""
    B, N = 2, 8
    pts = _points(B * N, 4)
    batches = [_scalars(N, 20 + b) for b in range(B)]
    s = torch.stack([_s(b) for b in batches])
    cfg = MSMConfig(c=6, are_points_shared_in_batch=False)
    want = [_want(batches[b], pts[b * N:(b + 1) * N]) for b in range(B)]
    assert msm_affine(CURVE, s, *_xy(pts), cfg) == want
    assert want[1] != _want(batches[1], pts[:N])
    # the flat form: (B N, Ls) scalars with batch_size = B
    flat = MSMConfig(c=6, are_points_shared_in_batch=False, batch_size=B)
    assert _affine(TM.msm(CURVE, s.reshape(B * N, 8), *_xy(pts), flat)) == want


def test_montgomery_form_inputs():
    pts, scalars = _points(9, 5), _scalars(9, 6)
    want = _want(scalars, pts)
    s_m = _i32(C.fr.to_mont(C.fr.from_ints(scalars)))
    x_m, y_m = (_i32(C.fq.to_mont(C.fq.from_ints([p[i] for p in pts]))) for i in (0, 1))
    both = MSMConfig(c=6, are_scalars_montgomery_form=True, are_points_montgomery_form=True)
    assert msm_affine(CURVE, s_m, x_m, y_m, both) == want
    assert _affine(TM.msm(CURVE, s_m, x_m, y_m, both)) == [want]


def test_bitsize_is_honoured_on_every_route(monkeypatch):
    pts, scalars = _points(10, 7), _scalars(10, 8, bits=64)
    want = _want(scalars, pts)
    cfg = MSMConfig(c=6, bitsize=64)
    assert msm_affine(CURVE, _s(scalars), *_xy(pts), cfg) == want                   # v3
    prepared = TM3.msm_tpu3_prepare(CURVE, *_xy(pts), c=6, bitsize=64)
    assert prepared["nbits"] == 64 and prepared["n_windows"] == 64 // 6 + 1
    assert _affine(TM.msm(CURVE, _s(scalars), *_xy(pts), cfg)) == [want]           # msm()
    monkeypatch.setenv("ICICLE_TPU_MSM_PIPELINE", "v2")
    calls = []
    real = TM2.msm_tpu2
    monkeypatch.setattr(TM2, "msm_tpu2", lambda *a, **k: calls.append(k) or real(*a, T=16, **k))
    assert msm_affine(CURVE, _s(scalars), *_xy(pts), cfg) == want                   # v2
    assert calls == [{"c": 6, "backend": "torch", "bitsize": 64}]


def test_precompute_factor_not_a_power_of_two_takes_the_generic_msm(monkeypatch):
    pts, scalars = _points(6, 9), _scalars(6, 10)
    cfg = MSMConfig(c=8, precompute_factor=3)
    ox, oy = TM.msm_precompute_bases(CURVE, *_xy(pts), cfg)
    assert ox.shape == (18, 8)
    monkeypatch.setattr(TM3, "msm_tpu3", None)          # v3's entry is not taken
    assert msm_affine(CURVE, _s(scalars), ox, oy, cfg) == _want(scalars, pts)


def test_batch_over_precomputed_bases():
    """The reference's headline shape, cut down: a batch sharing bases
    precomputed at a factor that is not a power of two (M3: 1000 x 2^10
    at 23)."""
    pts = _points(5, 15)
    batches = [_scalars(5, 40 + b) for b in range(2)]
    cfg = MSMConfig(c=7, precompute_factor=5)
    ox, oy = TM.msm_precompute_bases(CURVE, *_xy(pts), cfg)
    s = torch.stack([_s(b) for b in batches])
    assert msm_affine(CURVE, s, ox, oy, cfg) == [_want(b, pts) for b in batches]


def test_generic_plan_is_the_plan_msm_runs(monkeypatch):
    """generic_plan: v3's plan at generic_tile(rows), wg picked on the
    merged windows (M3's shape: 2 windows after 23 copies at c 8, where v3
    picks on 33); msm() prepares and runs exactly that plan."""
    plan = TM.generic_plan("bls12_377", 23 << 10, 8, 23)
    v3 = TM3._resolve_plan("bls12_377", 23 << 10, 8, TM.generic_tile(23 << 10), None, "u32",
                           23)
    assert (plan["T"], plan["tiles"], plan["n_windows"], plan["wg"]) == (256, 128, 2, 2)
    assert v3["wg"] == 8 and {k: v for k, v in plan.items() if k != "wg"} == \
        {k: v for k, v in v3.items() if k != "wg"}
    pts, scalars = _points(6, 13), _scalars(6, 14, bits=200)
    cfg = MSMConfig(c=7, precompute_factor=3, bitsize=200)
    ox, oy = TM.msm_precompute_bases(CURVE, *_xy(pts), cfg)
    seen = []
    real = TM3.msm_stages
    monkeypatch.setattr(TM3, "msm_stages",
                        lambda c, d, p, b=None: seen.append(p) or real(c, d, p, b))
    assert _affine(TM.msm(CURVE, _s(scalars), ox, oy, cfg)) == [_want(scalars, pts)]
    want = TM.generic_plan(CURVE, 18, 7, 3, 200)
    assert [{k: p[k] for k in want} for p in seen] == [want]


def test_g2_and_bad_shapes_raise():
    pts, scalars = _points(4, 11), _scalars(4, 12)
    # G2 runs (queue A item 7 is done), and takes Fp2 coordinates: G1's
    # (N, 8) limbs are refused before any work
    with pytest.raises(IcicleException, match="coordinates"):
        TM.msm(CURVE, _s(scalars), *_xy(pts), MSMConfig(g2=True))
    with pytest.raises(IcicleException, match=r"expected \(4, 16\)"):
        TM.msm_precompute_bases(CURVE, *_xy(pts), MSMConfig(g2=True, precompute_factor=2))
    x, y = _xy(pts)
    with pytest.raises(IcicleException, match="coordinates"):
        TM.msm(CURVE, _s(scalars), x[:3], y[:3])
    with pytest.raises(IcicleException, match="coordinates"):     # unshared needs B N rows
        TM.msm(CURVE, torch.stack([_s(scalars)] * 2), x, y,
               MSMConfig(are_points_shared_in_batch=False))
    with pytest.raises(IcicleException, match="batch_size"):
        TM.msm(CURVE, _s(scalars[:3]), x[:3], y[:3], MSMConfig(batch_size=2))


@pytest.mark.slow
def test_generic_msm_against_jax_msm_per_element():
    """(a) and (b) against JAX msm() itself: each unshared element equals
    JAX msm() run on that element's own points, and a batched msm_affine's
    first entry equals JAX's batched answer (its element 0)."""
    import jax.numpy as jnp

    from icicle_tpu.curves.group import get_group as jgroup
    from icicle_tpu.ops.msm import MSMConfig as JCfg
    from icicle_tpu.ops.msm import _msm_affine_xla, msm as jmsm

    B, N = 2, 6
    pts = _points(B * N, 13)
    batches = [_scalars(N, 30 + b) for b in range(B)]
    s = np.stack([np.asarray(C.fr.from_ints(b)) for b in batches])
    px, py = (np.asarray(C.fq.from_ints([p[i] for p in pts])) for i in (0, 1))
    got = msm_affine(CURVE, _i32(s), _i32(px), _i32(py),
                     MSMConfig(c=8, are_points_shared_in_batch=False))
    g = jgroup(CURVE)
    for b in range(B):
        res = jmsm(CURVE, jnp.asarray(s[b]), jnp.asarray(px[b * N:(b + 1) * N]),
                   jnp.asarray(py[b * N:(b + 1) * N]), JCfg(c=8))
        x, y = g.to_affine_canonical(res)
        assert got[b] == (int(C.fq.to_ints(x)), int(C.fq.to_ints(y)))
    shared = msm_affine(CURVE, _i32(s), _i32(px[:N]), _i32(py[:N]), MSMConfig(c=8))
    assert shared[0] == _msm_affine_xla(CURVE, jnp.asarray(s), jnp.asarray(px[:N]),
                                        jnp.asarray(py[:N]), JCfg(c=8))
