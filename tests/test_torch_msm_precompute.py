"""Precomputed MSM bases on the CPU: `msm_precompute_bases` and the plain
version of the precompute_bases kernel (icicle_tpu_torch/kernels/
precompute_kernel.py) against the reference's golden
`bn254_msm_precompute_bases` vector (the inputs of tests/test_msm.py:124-146)
and Python-int doublings at 8, 12 and 24 limbs; `precompute_shift` and
`_precompute_digit_remap` against the JAX package's; and MSMs over
precomputed bases (v3 at a power of two with c, the generic msm() at other
factors) against the python-int oracle. A slow-marked test holds v3 over
precomputed bases against JAX `msm_tpu3(backend="xla")`.

The CUDA kernel is held bit for bit against the plain version on the card by
chip_smoke.py. Tolerance: exact equality."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icicle_tpu.curves.params import get_curve as jcurve
from icicle_tpu.ops import msm as JM
from icicle_tpu_torch import MSMConfig, msm_affine
from icicle_tpu_torch.kernels import precompute_kernel as PB
from icicle_tpu_torch.ops import msm as TM
from icicle_tpu_torch.ops import msm_tpu3 as TM3
from icicle_tpu_torch.runtime.errors import IcicleException
from tests import ref_ffi
from tests.ec_ref import INF, ec_mul, msm_ref

# The tier-1 run puts six pytest workers on the same cores; torch's intra-op
# threads then oversubscribe them and these small-tensor ops run ~10x slower.
torch.set_num_threads(1)


def _i32(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.uint32).view(np.int32))


def _points(curve_name, n, seed, bits=28):
    c = jcurve(curve_name)
    rng = np.random.default_rng(seed)
    return [ec_mul((c.gen_x, c.gen_y), int(k), c.fq.modulus)
            for k in rng.integers(1, 1 << bits, size=n)]


def _xy(curve_name, pts):
    fq = jcurve(curve_name).fq
    return (np.array(fq.from_ints([p[0] for p in pts])),
            np.array(fq.from_ints([p[1] for p in pts])))


@pytest.mark.parametrize("nbits,c,nu", [(254, 8, 2), (254, 8, 4), (253, 8, 23), (377, 11, 3),
                                        (255, 6, 5), (64, 6, 2)])
def test_precompute_shift_and_digit_remap_match_jax(nbits, c, nu):
    assert TM.precompute_shift(nbits, c, nu) == JM.precompute_shift(nbits, c, nu)
    G0 = TM.precompute_shift(nbits, c, nu) // c
    W, n = TM.signed_window_count(nbits, c), 5
    digits = np.random.default_rng(nbits + nu).integers(-(1 << (c - 1)), (1 << (c - 1)) + 1,
                                                        size=(W, n)).astype(np.int32)
    want, wG = JM._precompute_digit_remap(jnp.asarray(digits), nu, n, G0)
    got, G = TM._precompute_digit_remap(torch.from_numpy(digits), nu, n, G0)
    assert G == wG and np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("curve_name,c,nbits", [("bn254", 6, 64), ("bn254", 11, 254),
                                                ("bls12_381", 7, 100), ("bw6_761", 9, 377)])
def test_signed_digits_with_bitsize_match_jax(curve_name, c, nbits):
    """The digits an MSMConfig.bitsize asks for: JAX `_signed_digits` and
    the port's, on scalars below 2^nbits (and r)."""
    fr = jcurve(curve_name).fr
    rng = np.random.default_rng(c + nbits)
    ints = [int.from_bytes(rng.bytes(64), "little") % min(fr.modulus, 1 << nbits)
            for _ in range(9)] + [0, min(fr.modulus, 1 << nbits) - 1]
    s = np.asarray(fr.from_ints(ints))
    want = np.asarray(JM._signed_digits(jnp.asarray(s), c, nbits))
    got = TM._signed_digits(_i32(s), c, nbits)
    assert got.shape == (TM.signed_window_count(nbits, c), len(ints))
    assert np.array_equal(got.numpy(), want)


def test_precompute_bases_matches_the_golden_vector():
    """Byte for byte the reference's msm_precompute_bases on the inputs of
    tests/test_msm.py:124-146 (n 8, c 8, nu 4, seed 5)."""
    curve = jcurve("bn254")
    rng = np.random.default_rng(5)
    n = 8
    pts = [ec_mul((curve.gen_x, curve.gen_y), int(k), curve.fq.modulus)
           for k in rng.integers(1, 1 << 28, size=n)]
    px, py = _xy("bn254", pts)
    c, nu = 8, 4
    ref = ref_ffi.bn254_msm_precompute_bases(np.concatenate([px, py], axis=1), c, nu)
    PB.precompute_bases.launches = 0
    ox, oy = TM.msm_precompute_bases("bn254", _i32(px), _i32(py),
                                     MSMConfig(c=c, precompute_factor=nu))
    assert PB.precompute_bases.launches == 0                    # the plain version, here
    ours = np.concatenate([ox.numpy(), oy.numpy()], axis=1).view(np.uint32)
    assert ours.shape == (nu * n, 16) and np.array_equal(ours, ref)


@pytest.mark.parametrize("curve_name,nu,shift", [("bn254", 4, 9), ("grumpkin", 2, 5),
                                                 ("bls12_377", 23, 2), ("bls12_381", 3, 7),
                                                 ("bw6_761", 2, 3)])
def test_precompute_bases_ref_against_python_ints(curve_name, nu, shift):
    """Row nu i + j is 2^(j shift) P_i; the identity (0, 0) stays (0, 0)."""
    mod = jcurve(curve_name).fq.modulus
    pts = _points(curve_name, 3, 50 + nu)
    px, py = _xy(curve_name, pts)
    px[1] = 0
    py[1] = 0                                                     # the identity
    ox, oy = PB.precompute_bases(curve_name, _i32(px), _i32(py), nu, shift)
    fq = jcurve(curve_name).fq
    got = list(zip(fq.to_ints(ox.numpy().view(np.uint32)),
                   fq.to_ints(oy.numpy().view(np.uint32))))
    want = []
    for i, p in enumerate(pts):
        for j in range(nu):
            want.append((0, 0) if i == 1 else ec_mul(p, 1 << (j * shift), mod))
    assert [(int(x), int(y)) for x, y in got] == want


def test_precompute_wrapper_checks_its_inputs():
    x = torch.zeros((4, 8), dtype=torch.int32)
    for bad in ((x.to(torch.int64), x), (x, x[:3]), (x.T.contiguous().T, x)):
        with pytest.raises(IcicleException):
            PB.precompute_bases("bn254", *bad, 2, 1)
    with pytest.raises(IcicleException, match="nu >= 1"):
        PB.precompute_bases("bn254", x, x, 0, 1)
    # nu = 1 gives the points back
    px, py = TM.msm_precompute_bases("bn254", x, x, MSMConfig(c=8))
    assert px is x and py is x


@pytest.mark.parametrize("nu", [2, 4])
def test_v3_over_precomputed_bases(nu, monkeypatch):
    curve = jcurve("bn254")
    n = 12
    pts = _points("bn254", n, 60 + nu)
    rng = np.random.default_rng(61)
    scalars = [int.from_bytes(rng.bytes(40), "little") % curve.fr.modulus for _ in range(n)]
    want = msm_ref(scalars, pts, curve.fq.modulus)
    cfg = MSMConfig(c=6, precompute_factor=nu)
    ox, oy = TM.msm_precompute_bases("bn254", *(_i32(a) for a in _xy("bn254", pts)), cfg)
    calls = []
    real = TM3.msm_tpu3
    monkeypatch.setattr(TM3, "msm_tpu3", lambda *a, **k: calls.append(k) or real(*a, **k))
    s = _i32(curve.fr.from_ints(scalars))
    assert msm_affine("bn254", s, ox, oy, cfg) == (want if want is not INF else (0, 0))
    assert len(calls) == 1 and calls[0]["precompute_factor"] == nu       # the v3 route
    prepared = TM3.msm_tpu3_prepare("bn254", ox, oy, c=6, precompute_factor=nu)
    G0 = TM.precompute_shift(254, 6, nu) // 6
    assert prepared["n_windows"] == max(G0, TM.signed_window_count(254, 6) - (nu - 1) * G0)
    # msm_tpu3 wants a power of two and the bases' own factor and c
    with pytest.raises(IcicleException, match="power of two"):
        real("bn254", s, ox, oy, c=6, precompute_factor=3)
    with pytest.raises(IcicleException, match="prepared with"):
        real("bn254", s, prepared=prepared)
    with pytest.raises(IcicleException, match="explicit c"):
        TM3.msm_tpu3_prepare("bn254", ox, oy, precompute_factor=nu)


@pytest.mark.slow
def test_v3_precomputed_matches_jax_xla_pipeline():
    from icicle_tpu.ops.msm_tpu3 import msm_tpu3 as jax_msm_tpu3
    curve = jcurve("bn254")
    n, nu = 16, 2
    pts = _points("bn254", n, 70)
    rng = np.random.default_rng(71)
    s = np.asarray(curve.fr.from_ints([int.from_bytes(rng.bytes(40), "little") % curve.fr.modulus
                                       for _ in range(n)]))
    cfg = MSMConfig(c=6, precompute_factor=nu)
    ox, oy = TM.msm_precompute_bases("bn254", *(_i32(a) for a in _xy("bn254", pts)), cfg)
    ox_u, oy_u = ox.numpy().view(np.uint32), oy.numpy().view(np.uint32)
    want = jax_msm_tpu3("bn254", s, ox_u, oy_u, c=6, T=32, backend="xla", engine="u32",
                        precompute_factor=nu)
    assert TM3.msm_tpu3("bn254", _i32(s), ox, oy, c=6, T=32, precompute_factor=nu) == want
